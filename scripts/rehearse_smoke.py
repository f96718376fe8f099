"""Rehearse ``chip_smoke.py``'s 0.25° phases, its sCM slices and its int8
forecast and scoring phases on the CPU.

    python scripts/rehearse_smoke.py

The kernels run only on a GPU, so this drives the smoke's own phase
functions with every wrapper on its plain PyTorch version at a tiny width
(dim 32, 2 heads of 16, depth 2) and a tiny latitude-padded grid (30x64 at
0.25°, 16x32 at 1.4°): ``.cuda()`` and ``torch.cuda.*`` are stubbed, the
timer returns 1 ms, and the launch counts read back what each phase
expects. It finds wrong paths, shapes and control flow before a chip call.
The int8 phases (the flagship's bf16 forecast, its int8 forecast at two
head layouts, the scoring of both stores, the 0.25° int8 forward) read real
counts instead: every kernel wrapper the model calls adds one to its count
as it would on the card.
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


def count_calls() -> None:
    """Each kernel wrapper the model calls adds one to its launch count, as
    its kernel launch does on the card (on the CPU the wrappers count
    nothing)."""
    import swift_torch.models.swinv2 as sw

    for name in ("fused_block_attention", "fused_tiled_block_attention", "fused_linear",
                 "fused_matmul_modnorm_residual", "fused_matmul_modnorm_residual_int8",
                 "fused_modnorm_residual", "fused_swiglu_ffn", "fused_swiglu_ffn_int8"):
        fn = getattr(sw, name)

        def counted(*a, _fn=fn, **k):
            _fn.launches += 1
            return _fn(*a, **k)

        setattr(sw, name, counted)


def rehearse_int8(read_launches) -> None:
    """The flagship forecast, the int8 forecast at both head layouts, the
    scoring of the bf16 and int8 stores, and the 0.25° int8 forward, at
    width 32 with every block on its real route."""
    cs.read_launches = read_launches
    count_calls()
    cs.RESOLUTION = (16, 32)
    cs.MODEL = {**cs.MODEL, **TINY, "window_size": [4, 8], "shift_size": [2, 0]}  # whole-grid
    cs.HD128_MODEL = {**cs.MODEL, "heads": 4, "head_dim": 8}
    depth = TINY["depth"]
    cs.INT8_FORWARD = {k: depth for k in cs.INT8_FORWARD}
    # the tiny 0.25° grid takes the whole-grid route for the unshifted block
    cs.QUARTER_INT8_FORWARD = {**{k: depth for k in cs.QUARTER_INT8_FORWARD},
                               "tiled_block_attention": 1, "block_attention": 1}
    evaluate = cs.metrics.evaluate
    cs.metrics.evaluate = lambda truth, pred, device: evaluate(truth, pred, "cpu")
    generator = torch.Generator
    torch.Generator = lambda device=None: generator()
    try:
        cs.phase_slice("CPU rehearsal")
        _, store = cs.phase_int8("CPU rehearsal", cs.MODEL, "int8")
        cs.phase_int8("CPU rehearsal", cs.HD128_MODEL, "int8-hd128")
        cs.phase_scoring(os.path.join(cs.WORK, "out", os.path.basename(store)), store)
        cs.phase_quarter_int8("CPU rehearsal")
    finally:
        torch.Generator = generator


def main() -> None:
    read_launches = cs.read_launches
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

    rehearse_int8(read_launches)


if __name__ == "__main__":
    try:
        main()
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
