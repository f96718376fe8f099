"""Time kernels 4 and 12 (the post-FFN modnorm and its tangent,
``csrc/modnorm.cu``) at other launch plans and in variants of the source,
on the card.

    python scripts/probe_modnorm.py [--variants A,B] [--out FILE]

The committed ``swift_torch/csrc/modnorm.cu`` is built alone into a library
of its own, and beside it variants, each the committed source with one
change made by text substitution in a temporary copy (no file of the repo
changes):

* ``unroll2``: the epilogue's walk over a row's 16-byte chunks unrolled by
  two, so that a lane's loads of two chunks are in flight together;
* ``y_in_registers``: the epilogue reads y from the statistics' pass,
  kept in registers (at most 8 chunks a lane, D <= 2048), in place of a
  second read of the stage;
* ``contiguous``: block k walks the rows T·k/grid .. T·(k+1)/grid in groups
  of R (the last one short) in place of every grid-th group, so that the
  blocks' shares differ by at most one row, not one group.

Each build runs through its C entry at every plan of ``PLANS`` (rows a
stage, stages in the ring, the AdaLN rows in shared memory or read
through L1/L2) where it fits, at the flagship's B = 2 (16,384
tokens) and at 0.25° (264,960), D = 1056. Every call's output is held to
the committed wrapper's (``modnorm_plan``'s launch) bit for bit, since no
plan changes a row's arithmetic; then each is timed as the median of 5
rounds of 20 calls queued back to back between two CUDA events, beside the
bound (each input read once, the output written once, at 3.35 TB/s).
Prints the card, ptxas's report and the times, and writes them as JSON to
``--out`` where it is given.
Needs one card and nvcc.
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
from chip_smoke import PEAK_BYTES, _tensor  # noqa: E402
from swift_torch.ops import modnorm  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCE = "modnorm.cu"
KERNELS = ("modnorm_rows",)
D = 1056
SHAPES = {"B=2": (2, 8192), "0.25°": (1, 264960)}  # (samples, tokens a sample)
# (rows a stage, stages, AdaLN rows in shared memory)
PLANS = [(8, 6, 0), (8, 6, 1), (8, 4, 1), (8, 3, 1), (8, 2, 1), (4, 8, 1), (12, 4, 1), (12, 2, 1),
         (16, 3, 1), (16, 2, 1)]
_EPI4 = "    float y[8], r[8], g[8], b[8], sc[8], sh[8], v[8];\n    ld8(ys + 8 * c, y);\n"
_EPI12 = ("    float y[8], dy[8], dr[8], g[8], b[8], sc[8], dsc[8], dsh[8], v[8];\n"
          "    ld8(ys + 8 * c, y);\n")
VARIANTS = {
    "committed": [],
    "unroll2": [("  for (int c = lane; c < chunks; c += 32) {\n" + _EPI4,
                 "#pragma unroll 2\n  for (int c = lane; c < chunks; c += 32) {\n" + _EPI4),
                ("  for (int c = lane; c < chunks; c += 32) {\n" + _EPI12,
                 "#pragma unroll 2\n  for (int c = lane; c < chunks; c += 32) {\n" + _EPI12)],
    "y_in_registers": [
        ("  float s1 = 0.0f, s2 = 0.0f;\n  for (int c = lane; c < chunks; c += 32) {\n"
         "    float y[8];\n    ld8(ys + 8 * c, y);\n",
         "  float s1 = 0.0f, s2 = 0.0f;\n  float keep[8][8];\n#pragma unroll\n"
         "  for (int i = 0; i < 8; ++i) {\n    const int c = lane + 32 * i;\n"
         "    if (c >= chunks) break;\n    float* y = keep[i];\n    ld8(ys + 8 * c, y);\n"),
        ("  for (int c = lane; c < chunks; c += 32) {\n" + _EPI4,
         "#pragma unroll\n  for (int i = 0; i < 8; ++i) {\n    const int c = lane + 32 * i;\n"
         "    if (c >= chunks) break;\n    float r[8], g[8], b[8], sc[8], sh[8], v[8];\n"
         "    float* y = keep[i];\n")],
    "contiguous": [
        ("      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {\n"
         "        mbar_wait(&empty[pos.s], pos.phase ^ 1);\n"
         "        const int row0 = grp * a.rows;\n"
         "        const uint32_t bytes = (uint32_t)min(a.rows, a.T - row0) * a.D * 2;\n",
         "      const int first = (int)((long long)a.T * blockIdx.x / gridDim.x);\n"
         "      const int last = (int)((long long)a.T * (blockIdx.x + 1) / gridDim.x);\n"
         "      for (int row0 = first; row0 < last; row0 += a.rows) {\n"
         "        mbar_wait(&empty[pos.s], pos.phase ^ 1);\n"
         "        const uint32_t bytes = (uint32_t)min(a.rows, last - row0) * a.D * 2;\n"),
        ("  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {\n"
         "    const int row = grp * a.rows + warp;\n"
         "    mbar_wait(&full[pos.s], pos.phase);\n"
         "    if (row < a.T) {\n",
         "  const int first = (int)((long long)a.T * blockIdx.x / gridDim.x);\n"
         "  const int last = (int)((long long)a.T * (blockIdx.x + 1) / gridDim.x);\n"
         "  for (int row0 = first; row0 < last; row0 += a.rows) {\n"
         "    const int row = row0 + warp;\n"
         "    mbar_wait(&full[pos.s], pos.phase);\n"
         "    if (row < last) {\n")],
}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_modnorm_residual.argtypes = [P] * 7 + [I] * 6 + [F, P]
    dll.swift_modnorm_residual_tangent.argtypes = [P] * 9 + [I] * 6 + [F, P]


def smem(tangent: bool, samples: int, rows: int, stages: int, ada: int) -> int:
    n = 3 if tangent else 2
    return (16 * stages + 16 + 8 * D + (2 * n * samples * D if ada else 0)
            + stages * rows * n * 2 * D)


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--out", default=None, help="FILE: the times as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_modnorm: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out: dict = {"card": card, "D": D, "shapes": SHAPES, "ms": {}, "bound_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        t = _tensor(np.random.default_rng(0))
        for key, (B, tps) in SHAPES.items():
            T = B * tps
            y, r, dy, dr = (t((B, tps, D), s) for s in (3.0, 1.0, 3.0, 1.0))
            g, b = 1.0 + t((D,), 0.1, torch.float32), t((D,), 0.1, torch.float32)
            msc, msh, dmsc, dmsh = (t((B, D), 0.2) for _ in range(4))
            for tangent in (False, True):
                kernel = "12" if tangent else "4"
                ins = (y, dy, dr, g, b, msc, dmsc, dmsh) if tangent else (y, r, g, b, msc, msh)
                want = (modnorm.modnorm_residual_tangent if tangent else
                        modnorm.fused_modnorm_residual)(*ins)
                nbytes = sum(a.numel() * a.element_size() for a in ins) + want.numel() * 2
                out["bound_ms"][f"{kernel} {key}"] = bound = nbytes / PEAK_BYTES * 1e3
                got = torch.empty_like(want)
                ptrs = [a.data_ptr() for a in ins] + [got.data_ptr()]
                for name, dll in libs.items():
                    fn = (dll.swift_modnorm_residual_tangent if tangent else
                          dll.swift_modnorm_residual)
                    for plan in PLANS:
                        rows, stages, ada = plan
                        if smem(tangent, B, rows, stages, ada) > modnorm.MODNORM_SMEM:
                            continue

                        def call(fn=fn, plan=plan):
                            return fn(*ptrs, T, D, tps, *plan, 1e-6, stream)

                        got.zero_()
                        if call():
                            raise RuntimeError(f"{name} kernel {kernel} {key} {plan}: launch "
                                               "failed")
                        torch.cuda.synchronize()
                        same = torch.equal(got, want)
                        ms = queued_ms(call)
                        tag = f"{name} kernel {kernel} {key} rows={rows} stages={stages} " \
                              f"ada_smem={ada}"
                        out["ms"][tag] = {"ms": ms, "equal": same}
                        print(f"{tag}: {ms:.4f} ms queued, {100 * bound / ms:.1f}% of its "
                              f"{bound:.4f}-ms bound; equal to the wrapper's bit for bit: {same}",
                              flush=True)
                del want, got
            del y, r, dy, dr
            torch.cuda.empty_cache()
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
