"""Rehearse ``chip_smoke.py``'s 0.25° phases and its sCM slices on the CPU.

    python scripts/rehearse_smoke.py

The kernels run only on a GPU, so this drives the smoke's own phase
functions with every wrapper on its plain PyTorch version at a tiny width
(dim 32, 2 heads of 16, depth 2) and a tiny latitude-padded grid (30x64 at
0.25°, 16x32 at 1.4°): ``.cuda()`` and ``torch.cuda.*`` are stubbed, the
timer returns 1 ms, and the launch counts read back what each phase
expects. It finds wrong paths, shapes and control flow before a chip call.
The cuts compare the plain path in bf16 against fp32, so their errors are
the bf16 rounding of the plain path at width 32, not the kernels'; their
limits are opened to 0.5 here. No number it prints is a device number.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

TINY = {"dim": 32, "heads": 2, "head_dim": 16, "depth": 2, "window_size": [4, 8],
        "shift_size": [2, 4]}
OPEN = (0.5, 0.5, 0.5)


def stub_the_card() -> None:
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.nn.Module.cuda = lambda self, *a, **k: self
    to, module_to = torch.Tensor.to, torch.nn.Module.to

    def tensor_to(self, *a, **k):
        a = tuple(x for x in a if not (isinstance(x, str) and x.startswith("cuda")))
        if str(k.get("device", "")).startswith("cuda"):
            k.pop("device")
        return to(self, *a, **k)

    torch.Tensor.to = tensor_to
    torch.nn.Module.to = lambda self, *a, **k: self if a[:1] == ("cuda",) else module_to(
        self, *a, **k)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    randn = torch.randn
    torch.randn = lambda *a, device=None, **k: randn(*a, **k)
    cs.time_ms = lambda fn, reps=20: (fn(), 1.0)[1]
    cs.profile_step = lambda *a, **k: print("[rehearsal] profile step skipped")


def main() -> None:
    stub_the_card()
    cs.QUARTER_RES, cs.QUARTER_GRID = (30, 64), (16, 32)
    cs.QUARTER_MODEL = {**cs.QUARTER_MODEL, **TINY}
    cs.DIM, cs.HIDDEN = 32, 40
    compose = cs.train_config
    cs.train_config = lambda exp, *extra, cut=cs.TRAIN: compose(
        exp, *extra, *(f"model.{k}={v}".replace(" ", "") for k, v in TINY.items()), cut=cut)
    cs.bwd_recompute_scratch_bytes = lambda T, D, H: 0  # asks the built library
    cs.tiled_bwd_scratch_bytes = lambda *a: 0
    expected: dict = {}
    cs.read_launches = lambda: dict(expected)
    kernels = list(cs.KERNELS)

    cs.quarter_kernels(np.random.default_rng(0), {})

    expected.update({k: 0 for k in kernels})
    expected.update({k: 24 for k in ("linear", "tiled_block_attention",
                                     "matmul_modnorm_residual", "modnorm_residual",
                                     "swiglu_ffn")})  # 12 a forward, 2 forwards
    generator = torch.Generator
    torch.Generator = lambda device=None: generator()
    cs.phase_quarter_forecast("CPU rehearsal")
    torch.Generator = generator

    for sl in (
        dataclasses.replace(cs.QUARTER_SCM, model=cs.QUARTER_MODEL, res=cs.QUARTER_RES,
                            cut_tols=OPEN),
        dataclasses.replace(cs.SCM, model={**cs.MODEL, **TINY}, res=(16, 32), cut_tols=OPEN,
                            n_files=8, cut={"batch": 2, "steps": 2, "steps_per_tick": 1}),
    ):
        expected.update({k: sl.cut["steps"] * sl.per_step.get(k, 0) for k in kernels})
        _, cfg, trained = cs.phase_scm("CPU rehearsal", sl)
        print(cs.phase_scm_cut(cfg, trained, sl))


if __name__ == "__main__":
    try:
        main()
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
