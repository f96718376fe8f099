"""Time kernel 19, the int8 wo projection with its post-norm and residual,
against variants of its design, an earlier build, kernel 3 and a composition
of library calls, on the card.

    python scripts/probe_mm_modnorm_int8.py [--parent DIR] [--also NAME=DIR] [--variants A,B]
        [--out chiprun_out/mm_modnorm_int8.json]

The committed ``swift_torch/csrc/gemm.cu`` is built alone into a library of
its own, and beside it variants, each the committed source with one change
made by text substitution in a temporary copy (no file of the repo
changes). Kernel 19 is kernel 3's cluster body on s8 operands, so a
variant of the body edits both; only kernel 19 is timed here:

* ``c5_bn224``: D = 1056 split over clusters of 5 blocks of 224 columns
  (64 of them past D), where the committed plan takes 6 of 176: fewer
  blocks a cluster read each A box, more clusters fit the card;
* ``products_only`` (wrong output, not checked): the statistics' exchange
  and the epilogue's arithmetic left out (``probe_mm_modnorm``'s
  ``no_exchange`` and ``no_epilogue``) -- what they cost beside the
  products, the quantize pass and the stores.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc`` (``git
archive <commit> swift_torch/csrc | tar -x -C DIR --strip-components 2``)
is built and timed too: its ``swift_mm_modnorm_int8`` takes no scratch
(the one-launch WMMA kernel, which has ``swift_mm_modnorm_int8_smem``) or,
as committed, xq and sx. Shapes: ``probe_mm_modnorm.SHAPES`` (the flagship
at B = 2 with 12x88 and 8x128 heads, the 0.25° grid at B = 1), D = 1056.

Every checked build is held at each shape to the plain version on the same
quantized weights, within 2e-2 of max|plain|, and two of its calls to each
other bit for bit. Then, in turns (the builds in order, then in reverse),
each is timed on weights quantized once as the median of 5 rounds of 20
calls queued back to back between two CUDA events, and as the median of 20
single calls; beside them once kernel 3 (the committed build's
``swift_mm_modnorm`` on the bf16 weight) and the composition
``chip_smoke.COMPOSITION["matmul_modnorm_residual_int8"]`` (``torch._int_mm``
on the same quantized weight). Each build's launches are split by device
time under torch.profiler. Prints the card, each build's cluster plan and
ptxas report, the times, and writes them as JSON. Needs one card and nvcc.
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
from chip_smoke import COMPOSITION, time_ms  # noqa: E402
from swift_torch.ops import modnorm, quant  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_ffn_int8 import by_pass  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402
from scripts.probe_mm_modnorm import D, EPILOGUE, EXCHANGE, SHAPES, inputs  # noqa: E402

TOL = 2e-2
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
WIDTHS = "constexpr int kMnS8Widths[] = {32, 64, 128, 176, 224};"
SOURCE = "gemm.cu"
KERNELS = ("mm_modnorm", "quantize_")
VARIANTS = {
    "committed": [],
    "c5_bn224": [(WIDTHS, WIDTHS.replace("176", "224"))],
    "products_only": [EXCHANGE, EPILOGUE],
}
UNCHECKED = ("products_only",)


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    """The old entry (no scratch) where the build has
    ``swift_mm_modnorm_int8_smem``, else the committed one with xq and sx."""
    dll.old_entry = hasattr(dll, "swift_mm_modnorm_int8_smem")
    dll.swift_mm_modnorm_int8.argtypes = [P] * (9 if dll.old_entry else 11) + [I, I, I, I, F, P]
    dll.swift_mm_modnorm.argtypes = [P] * 8 + [I, I, I, I, F, P]


def plan(dll) -> dict | None:
    if not hasattr(dll, "swift_mm_modnorm_int8_plan"):
        return None
    out = (ctypes.c_int * 4)()
    dll.swift_mm_modnorm_int8_plan(D, out)
    return dict(zip(("cluster", "columns", "smem", "resident_clusters"), out))


def call_of(dll, x, wq, sw, epi, out, scratch, M, K, tps, stream):
    """One kernel 19 call of ``dll`` on the quantized weight (wq, sw)."""
    ptrs = [x.data_ptr(), wq.data_ptr(), sw.data_ptr(), *(t.data_ptr() for t in epi),
            out.data_ptr()]
    if not dll.old_entry:
        ptrs += [t.data_ptr() for t in scratch]
    return lambda: dll.swift_mm_modnorm_int8(*ptrs, M, K, D, tps, 1e-6, stream)


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "mm_modnorm_int8.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_mm_modnorm_int8: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out: dict = {"card": card, "D": D, "shapes": SHAPES, "plans": {}, "ms": {}, "by_pass": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        times = out["ms"]
        for key, (M, K, tps) in SHAPES.items():
            x, w, *epi = inputs(rng, M, K, tps)
            w = w.float()
            wq, sw = quant.quantize_colwise(w)
            scratch = (torch.empty(M, K, device="cuda", dtype=torch.int8),
                       torch.empty(M, device="cuda"))
            with torch.no_grad():
                want = modnorm.reference_matmul_modnorm_residual_int8(x, w, *epi).float()
            ref = want.abs().max().item()
            calls = {}
            for name, dll in libs.items():
                y, again = torch.empty_like(epi[0]), torch.empty_like(epi[0])
                if call_of(dll, x, wq, sw, epi, y, scratch, M, K, tps, stream)() or call_of(
                        dll, x, wq, sw, epi, again, scratch, M, K, tps, stream)():
                    raise RuntimeError(f"{name} {key}: launch failed")
                torch.cuda.synchronize()
                out["plans"][name] = plan(dll)
                calls[name] = call_of(dll, x, wq, sw, epi, y, scratch, M, K, tps, stream)
                if name in UNCHECKED:
                    continue
                err = (y.float() - want).abs().max().item()
                same = torch.equal(y, again)
                print(f"{name} {key}: max err {err:.3e} of max|plain| {ref:.3e}; two calls equal "
                      f"bit for bit: {same}; plan {out['plans'][name]}", flush=True)
                if not (torch.isfinite(y).all() and err <= TOL * ref and same):
                    raise AssertionError(f"{name} {key} is off its plain version or not "
                                         f"deterministic: {err}, {same}")
            del want
            for name in list(calls) + list(calls)[::-1]:
                times.setdefault(f"{name} {key}", []).append(queued_ms(calls[name]))
                times.setdefault(f"{name} {key} single", []).append(time_ms(calls[name]))
            for name in calls:
                out["by_pass"][f"{name} {key}"] = by_pass(calls[name])
            wb, y3 = w.to(torch.bfloat16), torch.empty_like(epi[0])
            kernel3 = libs["committed"] if "committed" in libs else next(iter(libs.values()))
            yards = {
                "kernel 3 bf16": lambda: kernel3.swift_mm_modnorm(
                    x.data_ptr(), wb.data_ptr(), *(t.data_ptr() for t in epi), y3.data_ptr(),
                    M, K, D, tps, 1e-6, stream),
                "composition int8": COMPOSITION["matmul_modnorm_residual_int8"](x, wq, sw, *epi),
            }
            for name, fn in yards.items():
                times[f"{name} {key}"] = [queued_ms(fn)]
                times[f"{name} {key} single"] = [time_ms(fn)]
            print(f"{key} (ms, queued unless single): " + "; ".join(
                f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()
                if key in k), flush=True)
            for name in calls:
                print(f"{name} {key} by kernel (device ms a call): " + json.dumps(
                    {k: round(v, 4) for k, v in out["by_pass"][f"{name} {key}"].items()}),
                    flush=True)
            del x, w, wb, epi, scratch, calls, yards
            torch.cuda.empty_cache()
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
