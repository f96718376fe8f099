"""Time kernels 7 and 17, the attention tangent, against an earlier build
and a composition of library calls, on the card.

    python scripts/probe_attention_tangent.py [--parent DIR] [--also NAME=DIR] [--variants A,B]
        [--out chiprun_out/attention_tangent.json]

The committed ``swift_torch/csrc/block_attention.cu`` is built alone into a
library of its own (ptxas's registers and spills of the tangent's kernels
printed), and beside it variants, each the committed source with one
change made by text substitution in a temporary copy (no file of the repo
changes):

* ``no_store`` (wrong outputs, not checked): the output's bulk copies left
  out -- what the stores cost on the critical path.
* ``no_q_normalise``, ``no_k_normalise`` (wrong outputs, not checked): the
  consumers' in-place normalise of q and dq, or the producer's of k and
  dk, left out.
* ``unroll_normalise``: the normalise's rows two at a time.
* ``fenced``: the cluster exchanges with a ``fence.acq_rel.cluster`` by
  each writer and one release arrival a warp, after ``__syncwarp``
  (the committed body has every thread arrive with release).
* ``early_release`` (wrong outputs, not checked): a consumer hands its
  stage back once its S and dS have retired, while the peer's partial
  output still lands there -- what the stage's refill costs.
* ``phases`` (not checked, not timed): clock64 timers at the phase
  boundaries of one consumer thread and one key-warp thread of block 0,
  printed for one call at each kernel 7 shape as cycles and shares.
* ``no_stat_wait``, ``no_out_wait`` (wrong outputs, not checked): a
  consumer no longer waits for the peer's statistics, or for its partial
  output (the stores and arrivals stay) -- what each cluster round trip
  costs.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc``
(``git archive <commit> swift_torch/csrc | tar -x -C DIR
--strip-components 2``) whose ``block_attention.cu`` has kernels 7 and 17
in ``swift_block_attention_tangent`` and ``swift_tiled_attention_tangent``
is built and timed too, and so is each ``--also NAME=DIR``. Shapes: the
flagship at B = 2 (64x128 tokens, 16x16 windows) with 12x88 heads at shift
(8, 8) and 8x128 heads at (8, 8),
kernel 17 there on qkv and dqkv rolled by (8, 8); and kernel 17 at 0.25°
(B = 1, 368x720 tokens, 8x128 heads).

Every checked build is checked at every shape against the plain version,
within 2e-2 of max|plain|, two calls against each other bit for bit, and
its kernel 17 on rolled inputs against its kernel 7 bit for bit. Then, in
turns (the builds in order, then in reverse), each shape is timed as the
median of 5 rounds of 20 calls queued back to back between two CUDA events
(the device's time), and once beside them the composition
``chip_smoke.COMPOSITION`` (roll, window partition, the fp32 normalise and
its tangent rounded to bf16, S and dS by batched ``torch.matmul``, softmax,
dp, [dp | p]·[v ; dv], the inverse). Prints the times and writes them as
JSON. Needs one card and nvcc.
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
from swift_torch.ops import block_attention  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int
SOURCE = "block_attention.cu"
VARIANTS = {
    "committed": [],
    "no_store": [("bulk_store(out + token(qb * kQB + tid) * ofeat + col, rows + tid * L::LDO, "
                  "ncols * 2);", "")],
    "no_q_normalise": [("tan_normalise<DP, kQB, 128>(Qc, dQc, L::Q_BOX, chunks, scale_h, tid);",
                        "")],
    "no_k_normalise": [("tan_normalise<DP, kTanKeys, 64>(Ks, dKs, L::KEY_BOX, chunks, 1.0f, tid);",
                        "")],
    "unroll_normalise": [("  for (int r = tid / 8; r < ROWS; r += THREADS / 8) {",
                          "#pragma unroll 2\n  for (int r = tid / 8; r < ROWS; r += THREADS / 8) {")],
    "early_release": [("  if (lane == 0) mbar_arrive(&bar[L::Q_EMPTY + c]);  // the stage may take the "
                       "next query block", ""),
                      ("        if (j == 1) release(L::KD_EMPTY);",
                       "        release(L::Q_EMPTY + c);\n        if (j == 1) release(L::KD_EMPTY);")],
    "fenced": [("        }\n        mbar_arrive_cluster_release(&bar[L::STAT + c], peer);",
                "          fence_cluster();\n        }\n        __syncwarp();\n"
                "        if (lane == 0) mbar_arrive_cluster_release(&bar[L::STAT + c], peer);"),
               ("  mbar_arrive_cluster_release(&bar[L::OUT + c], 1 - RANK);",
                "  fence_cluster();\n  __syncwarp();\n"
                "  if (lane == 0) mbar_arrive_cluster_release(&bar[L::OUT + c], 1 - RANK);"),
               ("{64, 8, 64, 8, 32, 32, 4, 4, 128, 128, 128, 128}",
                "{64, 8, 64, 8, 32, 32, 4, 4, 4, 4, 4, 4}")],
    "no_stat_wait": [("mbar_wait_cluster(&bar[L::STAT + c], j);", "")],
    "no_out_wait": [("mbar_wait_cluster(&bar[L::OUT + c], j);", "")],
}
# ``phases``: clock64 timers at the phase boundaries of consumer 0's thread 0 and of key
# warp 2's thread 0 in block 0, summed into a device array that
# swift_tan_prof_read copies out (and zeroes)
_PROF = ("#define PROF(i) if (prof_on) { const unsigned long long now_ = clock64(); "
         "swift_tan_prof[i] += now_ - last_; last_ = now_; }\n")
PHASES = ["rest of the window-head (consumer)", "q stage wait", "q/dq normalise", "k/dk wait",
          "S, dS products", "statistics", "statistics exchange wait", "p, dp",
          "v/dv wait", "o products", "output exchange and store",
          "k/dk empty wait (keys)", "k/dk load (keys)", "k/dk normalise (keys)",
          "v/dv empty wait (keys)", "v/dv load (keys)"]
VARIANTS["phases"] = [
    ("template <int DP, bool TILED>\n__global__ void __launch_bounds__(kFwdThreads, 1)\n"
     "    attn_tangent_kernel(",
     "__device__ unsigned long long swift_tan_prof[16];\n" + _PROF +
     "template <int DP, bool TILED>\n__global__ void __launch_bounds__(kFwdThreads, 1)\n"
     "    attn_tangent_kernel("),
    ("    setmaxnreg_dec<80>();\n    const int pw = threadIdx.x / 32;",
     "    setmaxnreg_dec<80>();\n    const int pw = threadIdx.x / 32;\n"
     "    unsigned long long last_ = clock64();\n"
     "    const bool prof_on = blockIdx.x == 0 && threadIdx.x == 64;"),
    ("    setmaxnreg_inc<208>();\n    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, "
     "lane = tid % 32;\n    unsigned char* Qc = smem + L::Q_OFF",
     "    setmaxnreg_inc<208>();\n    unsigned long long last_ = clock64();\n"
     "    const bool prof_on = blockIdx.x == 0 && threadIdx.x == 128;\n"
     "    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;\n"
     "    unsigned char* Qc = smem + L::Q_OFF"),
    ("        mbar_wait(&bar[L::Q_FULL + c], j);\n        tan_normalise",
     "        PROF(0) mbar_wait(&bar[L::Q_FULL + c], j); PROF(1)\n        tan_normalise"),
    ("tan_normalise<DP, kQB, 128>(Qc, dQc, L::Q_BOX, chunks, scale_h, tid);",
     "tan_normalise<DP, kQB, 128>(Qc, dQc, L::Q_BOX, chunks, scale_h, tid); PROF(2)"),
    ("        mbar_wait(&bar[L::KD_FULL], it & 1);", "        mbar_wait(&bar[L::KD_FULL], it & 1); PROF(3)"),
    ("        fence_regs(ds);", "        fence_regs(ds); PROF(4)"),
    ("        mbar_arrive_cluster_release(&bar[L::STAT + c], peer);",
     "        PROF(5) mbar_arrive_cluster_release(&bar[L::STAT + c], peer);"),
    ("        mbar_wait_cluster(&bar[L::STAT + c], j);",
     "        mbar_wait_cluster(&bar[L::STAT + c], j); PROF(6)"),
    ("        mbar_wait(&bar[L::VD_FULL], it & 1);",
     "        PROF(7) mbar_wait(&bar[L::VD_FULL], it & 1); PROF(8)"),
    ("        fence_regs(o);\n        if (j == 1) release(L::VD_EMPTY);",
     "        fence_regs(o); PROF(9)\n        if (j == 1) release(L::VD_EMPTY);"),
    ("ncols, c, j, tid);\n      }\n    }\n", "ncols, c, j, tid);\n        PROF(10)\n      }\n    }\n"),
    ("        mbar_wait(&bar[L::KD_EMPTY], (it & 1) ^ 1);",
     "        mbar_wait(&bar[L::KD_EMPTY], (it & 1) ^ 1); PROF(11)"),
    ("        cp_async_commit();\n        cp_async_wait<0>();\n        named_barrier_sync(3, 64);\n",
     "        cp_async_commit();\n        cp_async_wait<0>();\n        named_barrier_sync(3, 64);\n"
     "        PROF(12)\n"),
    ("tan_normalise<DP, kTanKeys, 64>(Ks, dKs, L::KEY_BOX, chunks, 1.0f, tid);",
     "tan_normalise<DP, kTanKeys, 64>(Ks, dKs, L::KEY_BOX, chunks, 1.0f, tid); PROF(13)"),
    ("        mbar_wait(&bar[L::VD_EMPTY], (it & 1) ^ 1);",
     "        mbar_wait(&bar[L::VD_EMPTY], (it & 1) ^ 1); PROF(14)"),
    ("        mbar_arrive(&bar[L::VD_FULL]);", "        mbar_arrive(&bar[L::VD_FULL]); PROF(15)"),
    ('extern "C" int swift_tiled_attention_tangent(',
     'extern "C" int swift_tan_prof_read(void* host) {\n'
     '  static unsigned long long zero[16] = {};\n'
     '  cudaError_t e = cudaMemcpyFromSymbol(host, swift::swift_tan_prof, sizeof(zero));\n'
     '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(swift::swift_tan_prof, zero, sizeof(zero));\n'
     '  return (int)e;\n}\n\nextern "C" int swift_tiled_attention_tangent('),
]
UNCHECKED = ("no_store", "no_q_normalise", "no_k_normalise", "early_release", "no_stat_wait",
             "no_out_wait", "phases")
# name: (B, (gh, gw), heads, d, shift); "k17" shapes run kernel 17 on inputs rolled by the shift
SHAPES = {
    "k7 12x88 shift (8, 8)": (2, (64, 128), 12, 88, (8, 8)),
    "k7 8x128 shift (8, 8)": (2, (64, 128), 8, 128, (8, 8)),
    "k17 12x88 rolled (8, 8)": (2, (64, 128), 12, 88, (8, 8)),
    "k17 0.25° 8x128": (1, (368, 720), 8, 128, (0, 0)),
}
WINDOW = (16, 16)
KERNELS = ("attn_tangent_kernel", "block_attn_tangent_kernel", "tiled_attn_tangent_kernel")


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_block_attention_tangent.argtypes = [P, P, P, P] + [I] * 9 + [P]
    dll.swift_tiled_attention_tangent.argtypes = [P] * 4 + [I] * 7 + [P]
    if name == "phases":
        dll.swift_tan_prof_read.argtypes = [P]


def phases(dll, key, t, out, stream) -> dict:
    """One call of ``key``'s kernel through the ``phases`` build: the clock64
    cycles of each phase, summed over block 0's window-heads (consumer 0's
    two query blocks each), as shares of consumer 0's and the key warps'
    totals."""
    buf = (ctypes.c_ulonglong * 16)()
    dll.swift_tan_prof_read(ctypes.addressof(buf))  # zero the timers
    calls(dll, key, t, out, stream)()
    torch.cuda.synchronize()
    if dll.swift_tan_prof_read(ctypes.addressof(buf)):
        raise RuntimeError("phases: the timers could not be read")
    cyc = list(buf)
    cons, keys = sum(cyc[:11]), sum(cyc[11:])
    rows = {PHASES[i]: [cyc[i], cyc[i] / (cons if i < 11 else keys)] for i in range(16)}
    print(f"phases {key}: consumer 0 of block 0 {cons} cycles, its key warps {keys}", flush=True)
    for name, (c, share) in rows.items():
        print(f"  {name:38s} {c:12d} cycles  {100 * share:5.1f}%", flush=True)
    return {"consumer_cycles": cons, "key_cycles": keys, "phases": rows}


def inputs(rng, B, grid, heads, d, shift):
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            "cuda", torch.bfloat16)

    qkv, dqkv = t((B, *grid, 3 * heads * d)), t((B, *grid, 3 * heads * d))
    scale = torch.exp(0.3 * torch.from_numpy(rng.standard_normal(heads, dtype=np.float32))
                      + np.log(10.0)).cuda()
    rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dqkv))
    return qkv, dqkv, rolled, drolled, scale


def calls(dll, key, t, out, stream, kernel=None):
    """The launch of ``key``'s kernel (or of ``kernel``, 7 or 17) through
    ``dll``, writing ``out``."""
    B, (gh, gw), heads, d, shift = SHAPES[key]
    qkv, dqkv, rolled, drolled, scale = t
    if (kernel or int(key.split()[0][1:])) == 7:
        return lambda: dll.swift_block_attention_tangent(
            qkv.data_ptr(), dqkv.data_ptr(), scale.data_ptr(), out.data_ptr(), B, gh, gw, heads,
            d, *WINDOW, *shift, stream)
    return lambda: dll.swift_tiled_attention_tangent(
        rolled.data_ptr(), drolled.data_ptr(), scale.data_ptr(), out.data_ptr(), B, gh, gw,
        heads, d, *WINDOW, stream)


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "attention_tangent.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention_tangent: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        times: dict = {}
        phase_cycles: dict = {}
        for key, (B, grid, heads, d, shift) in SHAPES.items():
            t = inputs(rng, B, grid, heads, d, shift)
            qkv, dqkv, rolled, drolled, scale = t
            k7 = key.startswith("k7")
            plain_args = ((qkv, dqkv, scale, heads, WINDOW, shift) if k7 else
                          (rolled, drolled, scale, heads, WINDOW))
            want = block_attention.reference_block_attention_tangent(*plain_args).float()
            ref = want.abs().max().item()
            outs = {}
            for name, dll in libs.items():
                out = torch.empty(B, *grid, heads * d, device="cuda", dtype=torch.bfloat16)
                fn = calls(dll, key, t, out, stream)
                code = fn()
                if code and name in UNCHECKED:
                    print(f"{name} {key}: launch failed ({code}), dropped", flush=True)
                    continue
                if code:
                    raise RuntimeError(f"{name} {key}: launch failed ({code})")
                torch.cuda.synchronize()
                outs[name] = (fn, out)
                if name in UNCHECKED:
                    continue
                first = out.clone()
                fn()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                same = torch.equal(out, first)
                print(f"{name} {key}: max err {err:.3e} of max|plain| {ref:.3e}; two calls "
                      f"equal bit for bit: {same}", flush=True)
                if not (torch.isfinite(out).all() and err <= TOL * ref and same):
                    raise AssertionError(f"{name} {key} is off its plain version ({err}) or "
                                         f"differs from call to call ({same})")
                if not k7 and any(shift):  # kernel 17 on rolled inputs against kernel 7
                    k7_out = torch.empty_like(out)
                    calls(dll, key, t, k7_out, stream, kernel=7)()
                    same = torch.equal(torch.roll(out, shift, (1, 2)), k7_out)
                    print(f"{name} {key}: equal to kernel 7 bit for bit: {same}", flush=True)
                    if not same:
                        raise AssertionError(f"{name}: kernel 17 differs from kernel 7")
            del want
            if "phases" in libs and k7:
                phase_cycles[key] = phases(libs["phases"], key, t, outs["phases"][1], stream)
            order = [n for n in outs if n != "phases"]
            order += order[::-1]
            for name in order:
                times.setdefault(f"{name} {key}", []).append(queued_ms(outs[name][0]))
            comp = COMPOSITION["block_attention_tangent" if k7 else
                               "tiled_block_attention_tangent"](*plain_args)
            times[f"composition {key}"] = [queued_ms(comp)]
            del comp
            print(f"{key} (ms, queued): " + "; ".join(
                f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()
                if key in k), flush=True)
            del t, qkv, dqkv, rolled, drolled, outs
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "window": WINDOW, "shapes": SHAPES, "ms": times,
                               "phase_cycles": phase_cycles},
                              indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
