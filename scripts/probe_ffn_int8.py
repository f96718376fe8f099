"""Time kernel 18, the int8 SwiGLU FFN, by pass and whole, against variants
of its design, an earlier build, kernel 5 and a composition of library
calls, on the card.

    python scripts/probe_ffn_int8.py [--parent DIR] [--also NAME=DIR] [--variants A,B]
        [--out chiprun_out/ffn_int8.json]

The committed ``swift_torch/csrc/ffn_int8.cu`` is built alone into a library
of its own, and beside it variants, each the committed source with one
change made by text substitution in a temporary copy (no file of the repo
changes):

* ``four_stages``: the s8 ring with the four stages that fit beside the
  output boxes, where the committed one keeps three;
* ``no_h_store`` (wrong output, not checked): pass 1 forms h and its row
  maxima but stores no fp32 h box -- what h's round trip through device
  memory costs pass 1;
* ``fast_silu``: pass 1's epilogue with ``__expf`` and ``__frcp_rn`` in
  place of ``expf`` and an IEEE division (other last bits of h, within the
  2e-2 check) -- what the epilogue's arithmetic costs while neither
  consumer multiplies;
* ``four_boxes``: four fp32 output boxes a consumer, a whole tile's h in
  flight;
* ``no_silu`` and ``products_only`` (wrong outputs, not checked): pass 1's
  epilogue storing g + u in place of g·sigmoid(g)·u, or storing nothing
  (no box, no barrier) -- what the SwiGLU arithmetic and the whole
  epilogue cost pass 1.

A form with h's quantization fused into pass 2's loads is not built: the
quantize pass's own device time, printed by pass, is the most it could
save, and pass 2 would then read fp32 h (four times hq's bytes) through its
ring.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc`` (``git
archive <commit> swift_torch/csrc | tar -x -C DIR --strip-components 2``)
is built and timed too: its ``swift_ffn_int8`` takes the weights and x
alone (the one-launch WMMA kernel) or, as committed, the scratch as well.

Shapes: the flagship at B = 2 (T = 16,384, D = 1056, H = 2816) and MB = 4
(32,768 tokens). Every checked build is held at each shape to the plain
version (``reference_swiglu_ffn_int8`` on the same quantized weights),
within 2e-2 of max|plain|, and two of its calls to each other bit for bit.
Then, in turns (the builds in order, then in reverse), each is timed on
weights quantized once as the median of 5 rounds of 20 calls queued back to
back between two CUDA events, and as the median of 20 single calls; beside
them once kernel 5 (``fused_swiglu_ffn``, bf16, the repo's build) and the
compositions ``chip_smoke.COMPOSITION`` of ``swiglu_ffn_int8``
(``torch._int_mm`` on the same weights) and ``swiglu_ffn`` (``F.linear``).
Each build's four launches are split by device time under torch.profiler.
Prints the card, the times and writes them as JSON. Needs one card and nvcc.
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
from swift_torch.ops import ffn, quant  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int
SOURCE = "ffn_int8.cu"
KERNELS = ("s8_gemm", "quantize_", "ffn_i8")
FOUR = ("constexpr int kS8Stages = 3;",
        "constexpr int kS8Stages = (kMaxSmem - ring_smem(0, 2 * kS8Boxes, 0) - 256) / "
        "kLinStageBytes;")
VARIANTS = {
    "committed": [],
    "four_stages": [FOUR],
    "no_h_store": [
        ("store_box_f32<kS8Boxes>(next_box(), &mOut, n0 + 32 * q, m0, m0 < M, c, q,",
         "store_box_f32<kS8Boxes>(next_box(), &mOut, n0 + 32 * q, m0, false, c, q,")],
    "fast_silu": [("out[e] = g * (1.0f / (1.0f + expf(-g))) * u;",
                   "out[e] = g * __frcp_rn(1.0f + __expf(-g)) * u;")],
    "four_boxes": [("constexpr int kS8Boxes = 2;", "constexpr int kS8Boxes = 4;")],
    "no_silu": [("out[e] = g * (1.0f / (1.0f + expf(-g))) * u;", "out[e] = g + u;")],
    "products_only": [("for (int q = 0; q < kS8HidBN / 32; ++q) {",
                       "for (int q = 0; q < 0; ++q) {")],
}
UNCHECKED = ("no_h_store", "no_silu", "products_only")
D, H = 1056, 2816
SHAPES = {"flagship B=2": 16384, "flagship MB=4": 32768}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    """The old entry (x, weights, y, M, D, H) where the build has
    ``swift_ffn_int8_smem``, else the committed one with its scratch."""
    dll.old_entry = hasattr(dll, "swift_ffn_int8_smem")
    dll.swift_ffn_int8.argtypes = ([P] * 6 if dll.old_entry else [P] * 12) + [I, I, I, P]


def call_of(dll, x, q, y, scratch, stream):
    """One kernel 18 call of ``dll`` on quantized weights ``q`` = (w1q, s1,
    w2q, s2) over one chunk."""
    T = x.shape[0]
    ptrs = [x.data_ptr(), *(t.data_ptr() for t in q), y.data_ptr()]
    if not dll.old_entry:
        ptrs += [t.data_ptr() for t in scratch]
    return lambda: dll.swift_ffn_int8(*ptrs, T, D, H, stream)


def by_pass(fn) -> dict:
    """Device ms of each kernel name over 5 calls of ``fn``, a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 5e3 for e in prof.key_averages()
            if e.device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "ffn_int8.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_ffn_int8: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out: dict = {"card": card, "D": D, "H": H, "shapes": SHAPES, "ms": {}, "by_pass": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)

        def t(shape, scale=1.0, dtype=torch.bfloat16):
            a = scale * rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(a).to("cuda", dtype)

        w1, w2 = t((2 * H, D), D ** -0.5, torch.float32), t((D, H), H ** -0.5, torch.float32)
        q = (*quant.quantize_colwise(w1), *quant.quantize_colwise(w2))
        w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
        times = out["ms"]
        for key, T in SHAPES.items():
            x = t((T, D))
            scratch = [torch.empty(T, D, device="cuda", dtype=torch.int8),
                       torch.empty(T, device="cuda"), torch.empty(T, H, device="cuda"),
                       torch.empty(T, -(-H // 128), device="cuda"),
                       torch.empty(T, H, device="cuda", dtype=torch.int8),
                       torch.empty(T, device="cuda")]
            with torch.no_grad():
                want = ffn.reference_swiglu_ffn_int8(x, w1, w2).float()
            ref = want.abs().max().item()
            calls = {}
            for name, dll in libs.items():
                y, again = torch.empty_like(x), torch.empty_like(x)
                if call_of(dll, x, q, y, scratch, stream)() or call_of(
                        dll, x, q, again, scratch, stream)():
                    raise RuntimeError(f"{name} {key}: launch failed")
                torch.cuda.synchronize()
                calls[name] = call_of(dll, x, q, y, scratch, stream)
                if name in UNCHECKED:
                    continue
                err = (y.float() - want).abs().max().item()
                same = torch.equal(y, again)
                print(f"{name} {key}: max err {err:.3e} of max|plain| {ref:.3e}; two calls equal "
                      f"bit for bit: {same}", flush=True)
                if not (torch.isfinite(y).all() and err <= TOL * ref and same):
                    raise AssertionError(f"{name} {key} is off its plain version or not "
                                         f"deterministic: {err}, {same}")
            del want
            for name in list(calls) + list(calls)[::-1]:
                times.setdefault(f"{name} {key}", []).append(queued_ms(calls[name]))
                times.setdefault(f"{name} {key} single", []).append(time_ms(calls[name]))
            for name in calls:
                out["by_pass"][f"{name} {key}"] = by_pass(calls[name])
            yards = {"composition int8": COMPOSITION["swiglu_ffn_int8"](x, *q),
                     "kernel 5 bf16": lambda: ffn.fused_swiglu_ffn(x, w1b, w2b),
                     "composition bf16": COMPOSITION["swiglu_ffn"](x, w1b, w2b)}
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
            del x, scratch, calls, yards
            torch.cuda.empty_cache()
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
