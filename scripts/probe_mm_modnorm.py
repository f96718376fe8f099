"""Time kernel 3, the wo projection with its post-norm and residual, against
variants of its cluster design, an earlier build and a composition of
library calls, on the card.

    python scripts/probe_mm_modnorm.py [--parent DIR] [--also NAME=DIR] [--variants A,B]
        [--out chiprun_out/mm_modnorm.json]

The committed ``swift_torch/csrc/gemm.cu`` is built alone into a library of
its own, and beside it variants, each the committed source with one change
made by text substitution in a temporary copy (no file of the repo
changes). Kernel 19 runs the same body on s8 operands, so a variant edits
it too; only kernel 3 is called here (``probe_mm_modnorm_int8.py`` times
19):

* ``multicast``: ranks 0 and 1 of a cluster each load one 64-row half of
  the 128 x 64 A box and multicast it to every block of the cluster (which
  all read the same rows), and every consumer warp of the cluster releases
  each stage in every block, where the committed kernel has each block
  load the whole A box itself;
* ``c8_bn136``, ``c8_multicast`` and ``c5_bn216``: D = 1056 split over
  clusters of 8 blocks of 136 columns (32 of them past D), without and with
  the multicast, or of 5 blocks of 216 (24 past D), where the committed
  kernel takes 6 of 176;
* ``release_early``: each stage released as soon as its own wgmmas are
  done, where the committed consumer keeps one wgmma group in flight and
  releases the stage before;
* ``three_stages``: a ring of three stages, where the committed one has
  four at 176 columns;
* ``no_exchange``, ``no_epilogue`` and ``products_only`` (wrong outputs,
  not checked): the statistics' arrivals and wait left out (the partial
  sums are still written to the peers), the epilogue's arithmetic and
  reads left out (the box is stored as loaded), or both -- what each costs
  on the critical path.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc`` (``git
archive <commit> swift_torch/csrc | tar -x -C DIR --strip-components 2``)
whose ``gemm.cu`` has kernel 3 in ``swift_mm_modnorm`` is built and timed
too. Shapes (M, K, D = 1056, tokens a sample): the flagship at B = 2 with
12x88 heads (K = 1056) and 8x128 heads (K = 1024), and the 0.25° grid at
B = 1 (264,960 tokens, K = 1024).

Every build but the last three is checked at every shape against the
plain version, within 2e-2 of max|plain|, and two of its calls against
each other bit for bit. Then, in turns (the builds in order, then in
reverse), each shape is timed as the median of 5 rounds of 20 calls queued
back to back between two CUDA events (the device's time), and once beside
them the composition
``chip_smoke.COMPOSITION`` (``F.linear``, fp32 ``F.layer_norm``, AdaLN, +
r). Prints each build's cluster plan (blocks a cluster, columns a block,
the clusters ``cudaOccupancyMaxActiveClusters`` allows), the times, and
writes them as JSON. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import COMPOSITION  # noqa: E402
from swift_torch.ops import modnorm  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

TOL = 2e-2
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
WIDTHS = "constexpr int kMnWidths[] = {32, 64, 128, 176, 216};"
EXCHANGE = ("      if (lane < C) mbar_arrive_cluster_release(&stat[par], lane);\n"
            "      mbar_wait_cluster(&stat[par], (it >> 1) & 1);\n", "")
EPILOGUE = ("        if (col < D) {  // D is even: col + 1 < D too", "        if (col < 0) {")
MULTICAST = [
    ("  ring_init<S>(full, empty, 1);", "  ring_init<S>(full, empty, C);"),
    ("          mbar_expect_tx(&full[pos.s], L::STAGE);\n"
     "          tma_load_2d(stage, &mA, &full[pos.s], kb * BK, m0);\n",
     "          const bool half1 = m0 + kMnRows / 2 < M;\n"
     "          mbar_expect_tx(&full[pos.s], L::STAGE - (half1 ? 0 : kMnABytes / 2));\n"
     "          for (int h = rank; h < 2; h += C)\n"
     "            if (h == 0 || half1)\n"
     "              tma_load_2d_multicast(stage + h * (kMnABytes / 2), &mA, &full[pos.s],\n"
     "                                    kb * BK, m0 + h * (kMnRows / 2), (1 << C) - 1);\n"),
    ("        if (lane == 0) mbar_arrive(&empty[stage]);",
     "        if (lane < C) mbar_arrive_cluster(&empty[stage], lane);"),
    ("tensor_map_bf16(&mA, a.x, a.M, a.K, kMnRows, kLinBK)",
     "tensor_map_bf16(&mA, a.x, a.M, a.K, kMnRows / 2, kLinBK)"),
]
C8 = (WIDTHS, WIDTHS.replace("176", "136"))
SOURCE = "gemm.cu"
KERNELS = ("mm_modnorm",)
VARIANTS = {
    "committed": [],
    "multicast": MULTICAST,
    "c8_bn136": [C8],
    "c8_multicast": [C8] + MULTICAST,
    "c5_bn216": [(WIDTHS, WIDTHS.replace("176", "216"))],
    "release_early": [
        ("        wgmma_wait<1>();  // the previous stage's products are done: release it\n"
         "        if (kb > 0) release(prev);\n        prev = pos.s;\n",
         "        wgmma_wait<0>();\n        release(pos.s);\n"),
        ("      wgmma_wait<0>();\n      fence_regs(acc);\n      release(prev);\n",
         "      fence_regs(acc);\n")],
    "three_stages": [("static constexpr int STAGES = (kMaxSmem - FIXED) / STAGE < 8 ? "
                      "(kMaxSmem - FIXED) / STAGE : 8;", "static constexpr int STAGES = 3;")],
    "no_exchange": [EXCHANGE],
    "no_epilogue": [EPILOGUE],
    "products_only": [EXCHANGE, EPILOGUE],
}
UNCHECKED = ("no_exchange", "no_epilogue", "products_only")
D = 1056
# name: (M, K, tokens a sample)
SHAPES = {
    "flagship B=2 12x88": (16384, 1056, 8192),
    "flagship B=2 8x128": (16384, 1024, 8192),
    "0.25° B=1 8x128": (264960, 1024, 264960),
}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_mm_modnorm.argtypes = [P] * 8 + [I, I, I, I, F, P]


def inputs(rng, M, K, tps):
    def t(shape, scale=1.0, dtype=torch.bfloat16):
        a = scale * rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to("cuda", dtype)

    B = M // tps
    return (t((B, tps, K)), t((D, K), K ** -0.5), t((B, tps, D)), 1.0 + t((D,), 0.1, torch.float32),
            t((D,), 0.1, torch.float32), t((B, D), 0.2), t((B, D), 0.2))


def plan(dll) -> dict | None:
    if not hasattr(dll, "swift_mm_modnorm_plan"):
        return None
    out = (ctypes.c_int * 4)()
    dll.swift_mm_modnorm_plan(D, out)
    return dict(zip(("cluster", "columns", "smem", "resident_clusters"), out))


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "mm_modnorm.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_mm_modnorm: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        times: dict = {}
        plans: dict = {}
        for key, (M, K, tps) in SHAPES.items():
            t = inputs(rng, M, K, tps)
            want = modnorm.reference_matmul_modnorm_residual(*t).float()
            ref = want.abs().max().item()
            calls = {}
            for name, dll in libs.items():
                out, again = torch.empty_like(t[2]), torch.empty_like(t[2])

                def call(o, dll=dll):
                    return dll.swift_mm_modnorm(*(a.data_ptr() for a in t), o.data_ptr(), M, K, D,
                                                tps, 1e-6, stream)

                if call(out) or call(again):
                    raise RuntimeError(f"{name} {key}: launch failed")
                torch.cuda.synchronize()
                plans[name] = plan(dll)
                calls[name] = lambda o=out, call=call: call(o)
                if name in UNCHECKED:
                    continue
                err = (out.float() - want).abs().max().item()
                same = torch.equal(out, again)
                print(f"{name} {key}: max err {err:.3e} of max|plain| {ref:.3e}; two calls equal "
                      f"bit for bit: {same}; plan {plans[name]}", flush=True)
                if not (torch.isfinite(out).all() and err <= TOL * ref and same):
                    raise AssertionError(f"{name} {key} is off its plain version or not "
                                         f"deterministic: {err}, {same}")
            del want
            for name in list(calls) + list(calls)[::-1]:
                times.setdefault(f"{name} {key}", []).append(queued_ms(calls[name]))
            times[f"composition {key}"] = [queued_ms(COMPOSITION["matmul_modnorm_residual"](*t))]
            print(f"{key} (ms, queued): " + "; ".join(
                f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()
                if key in k), flush=True)
            del t, calls
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "D": D, "shapes": SHAPES, "plans": plans,
                               "ms": times}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
