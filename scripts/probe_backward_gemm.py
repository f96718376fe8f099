"""Time kernels 9 and 13, the backward GEMMs, against variants, an earlier
build and compositions of library calls, on the card.

    python scripts/probe_backward_gemm.py [--parent DIR] [--also NAME=DIR] [--variants A,B]
        [--out chiprun_out/backward_gemm.json]

The committed ``swift_torch/csrc/gemm_bwd.cu`` (with ``wgmma.cuh`` and
``tile_mma.cuh`` beside it) is built alone into a library of its own, and
beside it variants, each the committed source with one change made by text
substitution in a temporary copy (no file of the repo changes):

* ``one_split``: every weight gradient in one split straight to bf16,
  where the committed ``bwd_splits`` may cut the tokens into splits whose
  fp32 partials are summed afterwards;
* ``direct_saved_reads``: kernel 9's SwiGLU epilogue reads the saved g
  and u straight from device memory in the accumulator's layout (4 bytes
  a thread), where the committed one has them loaded one step ahead as
  64 x 64 boxes by TMA into shared memory (which costs the ring a stage).

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc`` (``git
archive <commit> swift_torch/csrc | tar -x -C DIR --strip-components 2``)
is built and timed too. Shapes: kernel 9 at the flagship's B = 2 and B = 4
(16,384 and 32,768 tokens, D 1056, H 2816); kernel 13 at the flagship's
qkv projection, B = 2 and 4 with 12x88 heads (N 3168) and B = 2 with 8x128
(N 3072), K 1056, and at 0.25° (264,960 tokens, N 3072).

Every build is checked at every shape against the
plain version, every output within 2e-2 of max|plain|, and two of its calls
against each other bit for bit. Then, in turns (the builds in order, then
in reverse), each shape is timed as the median of 5 rounds of 20 calls
queued back to back between two CUDA events (the device's time), and once
beside them ``chip_smoke.COMPOSITION``'s library composition; and one call
of the committed build is profiled (``torch.profiler``), which gives the
device time of each launch inside it (the products, the split sums). Prints
ptxas's registers and spills, the times, and writes them as JSON. Needs
one card and nvcc.
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
from swift_torch.ops import ffn, linear  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int
# the saved g and u read straight from device memory in the accumulator's
# layout, 4 bytes a thread, in place of the TMA boxes
DIRECT_SAVED_READS = [
    ("struct BwdArgs {\n  float* part;",
     "struct BwdArgs {\n  const bf16* g;\n  const bf16* u;\n  float* part;"),
    ("  const BwdArgs args{nullptr, M, N, K, ceil_div(K, kLinBK), 1};",
     "  const BwdArgs args{(const bf16*)g, (const bf16*)u, nullptr, M, N, K, ceil_div(K, kLinBK), 1};"),
    ("  const BwdArgs args{ws, M, N, K,", "  const BwdArgs args{nullptr, nullptr, ws, M, N, K,"),
    ("      if (row < M) {\n        unsigned char* pair", "      if (false) {\n        unsigned char* pair"),
    ("            if (m0 < M) {\n              mbar_wait", "            if (false) {\n              mbar_wait"),
    ("                const float2 g = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(gb + at));\n"
     "                const float2 u = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(ub + at));",
     "                const int gr = r + 8 * h, gc = col + 8 * j + 2 * (lane % 4);\n"
     "                const bool in = gr < M && gc < N;\n"
     "                const float2 g = in ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(\n"
     "                    args.g + (size_t)gr * N + gc))) : make_float2(0.f, 0.f);\n"
     "                const float2 u = in ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(\n"
     "                    args.u + (size_t)gr * N + gc))) : make_float2(0.f, 0.f);"),
]
SOURCE = "gemm_bwd.cu"
KERNELS = ()  # every kernel
VARIANTS = {
    "committed": [],
    "one_split": [("  for (int s = 2; s <= most; ++s) {", "  for (int s = 2; s <= 1; ++s) {")],
    "direct_saved_reads": DIRECT_SAVED_READS,
}
D, H = 1056, 2816
# name: (kernel, tokens, N of the qkv projection for kernel 13)
SHAPES = {
    "9 flagship B=2": ("swiglu_ffn_bwd_saved", 16384, None),
    "9 flagship B=4": ("swiglu_ffn_bwd_saved", 32768, None),
    "13 flagship B=2 12x88": ("linear_bwd", 16384, 3168),
    "13 flagship B=4 12x88": ("linear_bwd", 32768, 3168),
    "13 flagship B=2 8x128": ("linear_bwd", 16384, 3072),
    "13 0.25° B=1 8x128": ("linear_bwd", 264960, 3072),
}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_ffn_bwd_saved.argtypes = [P] * 13 + [I, I, I, P]
    dll.swift_linear_bwd.argtypes = [P] * 6 + [I, I, I, P]
    dll.swift_splitk_workspace.argtypes = [I, I, I]
    dll.swift_splitk_workspace.restype = ctypes.c_longlong


def inputs(rng, kernel: str, T: int, N: int | None) -> tuple:
    def t(shape, scale=1.0):
        a = scale * rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to("cuda", torch.bfloat16)

    if kernel == "linear_bwd":
        return t((T, N)), t((T, D)), t((N, D), D ** -0.5)
    return (t((T, D)), t((T, D)), t((T, H)), t((T, H)), t((2 * H, D), D ** -0.5),
            t((D, H), H ** -0.5))


def caller(dll, kernel: str, args: tuple):
    """(call, outputs): one launch of ``dll``'s entry point on ``args`` into
    outputs and scratch allocated as the wrapper allocates them (the call
    holds them, so that their memory stays theirs)."""
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "linear_bwd":
        dy, x, w = args
        T, N, K = x.shape[0], w.shape[0], w.shape[1]
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        ws = torch.empty(dll.swift_splitk_workspace(N, K, T), device="cuda", dtype=torch.float32)
        held = (dy, x, w, dx, dw, ws)
        ptrs = [a.data_ptr() for a in held]
        return (lambda held=held: dll.swift_linear_bwd(*ptrs, T, N, K, stream)), (dx, dw)
    x, dy, g, u, w1, w2 = args
    T = x.shape[0]
    dx, dw1, dw2 = torch.empty_like(x), torch.empty_like(w1), torch.empty_like(w2)
    dgu = torch.empty(T, 2 * H, device="cuda", dtype=x.dtype)
    h = torch.empty(T, H, device="cuda", dtype=x.dtype)
    ws1, ws2 = (torch.empty(dll.swift_splitk_workspace(m, n, T), device="cuda",
                            dtype=torch.float32) for m, n in ((2 * H, D), (D, H)))
    held = (x, dy, g, u, w1, w2, dx, dw1, dw2, dgu, h, ws1, ws2)
    ptrs = [a.data_ptr() for a in held]
    return (lambda held=held: dll.swift_ffn_bwd_saved(*ptrs, T, D, H, stream)), (dx, dw1, dw2)


def profile(call, reps: int = 3) -> dict:
    """Device milliseconds of each kernel a call launches, by name: the mean
    over ``reps`` calls (after a warm-up) from ``torch.profiler``, with the
    launches counted. A small PyTorch op opens the window (the trace may
    drop its first kernel)."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.zeros(8, device="cuda").add_(1)
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / reps, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and ("bwd" in e.key or "splitk" in e.key)}


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "backward_gemm.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_backward_gemm: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    plain = {"linear_bwd": linear.reference_linear_bwd,
             "swiglu_ffn_bwd_saved": ffn.reference_swiglu_ffn_bwd_saved}
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        rng = np.random.default_rng(0)
        times: dict = {}
        profiles: dict = {}
        for key, (kernel, T, N) in SHAPES.items():
            t = inputs(rng, kernel, T, N)
            wants = [w.float() for w in plain[kernel](*t)]
            refs = [w.abs().max().item() for w in wants]
            calls = {}
            for name, dll in libs.items():
                call, outs = caller(dll, kernel, t)
                if call():
                    raise RuntimeError(f"{name} {key}: launch failed")
                first = [o.clone() for o in outs]
                if call():
                    raise RuntimeError(f"{name} {key}: launch failed")
                torch.cuda.synchronize()
                calls[name] = call
                errs = [(o.float() - w).abs().max().item() for o, w in zip(outs, wants)]
                same = all(torch.equal(a, b) for a, b in zip(first, outs))
                print(f"{name} {key}: max err / max|plain| "
                      f"{' '.join(f'{e / r:.2e}' for e, r in zip(errs, refs))}; two calls equal "
                      f"bit for bit: {same}", flush=True)
                ok = all(bool(torch.isfinite(o).all()) for o in outs)
                if not (ok and all(e <= TOL * r for e, r in zip(errs, refs)) and same):
                    raise AssertionError(f"{name} {key} is off its plain version or not "
                                         f"deterministic: {errs} of {refs}, {same}")
            del wants, first
            for name in list(calls) + list(calls)[::-1]:
                times.setdefault(f"{name} {key}", []).append(queued_ms(calls[name]))
            times[f"composition {key}"] = [queued_ms(COMPOSITION[kernel](*t))]
            profiles[key] = profile(calls["committed"])
            print(f"{key} (ms, queued): " + "; ".join(
                f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()
                if k.endswith(key)), flush=True)
            print(f"{key} a committed call by kernel (ms, launches in 3 calls): " + "; ".join(
                f"{k.split('(')[0]} {v:.4f} ({n})" for k, (v, n) in profiles[key].items()),
                flush=True)
            del t, calls
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "shapes": SHAPES, "ms": times,
                               "profiles": profiles}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
