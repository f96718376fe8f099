"""Time kernels 6 and 16, the attention backward, against an earlier build
and a composition of library calls, on the card.

    python scripts/probe_attention_bwd.py [--parent DIR] [--also NAME=DIR] [--variants A,B]
        [--out chiprun_out/attention_bwd.json]

The committed ``swift_torch/csrc/block_attention.cu`` is built alone into a
library of its own (ptxas's registers and spills of the backward's kernels
printed), and beside it variants, each the committed source with one
change made by text substitution in a temporary copy (no file of the repo
changes):

* ``q_only`` (wrong outputs, not checked): the key pass not launched --
  the query pass and the scale's sum alone.
* ``kv_only`` (wrong outputs, not checked): the query pass not launched --
  the key pass (on the statistics an earlier build left in the shared
  scratch) and the scale's sum.
* ``two_stages``: the key pass's ring of two stages instead of three.
* ``phases`` (not checked, not timed): clock64 timers at the phase
  boundaries of one consumer thread of the query pass's block 0 and of the
  key pass's block 0 (its dk̂ consumer and its producer), printed for one
  call at each kernel 6 shape as cycles and shares.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc``
(``git archive <commit> swift_torch/csrc | tar -x -C DIR
--strip-components 2``) is built and timed too, and so is each ``--also
NAME=DIR``; a build whose kernel 6 still takes fp32 partials of dk̂ and dv
(it exports ``swift_block_attention_bwd_qb``) is called with them, and is
not held to 16 = 6, which it did not promise. Shapes:
the flagship at B = 2 (64x128 tokens, 16x16 windows) with 12x88 heads and
8x128 heads at shift (8, 8), kernel 16 there on qkv and dout rolled by
(8, 8); and kernel 16 at 0.25° (B = 1, 368x720 tokens, 8x128 heads).

Every checked build is checked at every shape against the plain version
(dqkv and dscale each within 2e-2 of max|plain|), two calls against each
other bit for bit, and its kernel 16 on rolled inputs against its kernel 6
bit for bit. Then, in turns (the builds in order, then in reverse), each
shape is timed as the median of 5 rounds of 20 calls queued back to back
between two CUDA events (the device's time), and once beside them the
composition ``chip_smoke.COMPOSITION`` (``torch.autograd.grad`` through
the roll, window partition, fp32 normalise, SDPA and the inverse). Prints
the times and writes them as JSON. Needs one card and nvcc.
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
_LAUNCH_Q = "  int e = launch_persistent(attn_bwd_q_kernel<DP, TILED>,"
_LAUNCH_KV = "  e = launch_persistent(attn_bwd_kv_kernel<DP, TILED>,"
SOURCE = "block_attention.cu"
VARIANTS = {
    "committed": [],
    "q_only": [(_LAUNCH_KV, "  if (items < 0)" + _LAUNCH_KV[1:])],
    "kv_only": [(_LAUNCH_Q, "  int e = items < 0 ? 0 :" + _LAUNCH_Q[9:])],
    "two_stages": [("constexpr int kKvKeys = 64, kKvStages = 3;",
                    "constexpr int kKvKeys = 64, kKvStages = 2;")],
}
# ``phases``: clock64 timers, summed into a device array that swift_bwd_prof_read copies out
# (and zeroes): the query pass's consumer 0 (thread 128 of block 0), the key pass's dk̂
# consumer (thread 256 of block 0) and its producer (thread 0)
_PROF = ("__device__ unsigned long long swift_bwd_prof[20];\n"
         "#define PROF(i) if (prof_on) { const unsigned long long now_ = clock64(); "
         "swift_bwd_prof[i] += now_ - last_; last_ = now_; }\n")
_ON = "    unsigned long long last_ = clock64();\n    const bool prof_on = blockIdx.x == 0 && threadIdx.x == {};\n"
PHASES = ["query: rest of the window-head", "query: q stage wait", "query: q̂s store issued",
          "query: k̂/v wait", "query: S, dp products", "query: statistics and their exchange",
          "query: p, dS, Σ dS·S", "query: dq̂ product",
          "query: dq̂ exchange, normalise backward, store", "-",
          "key (dk̂ consumer): rest", "key (dk̂ consumer): k̂/v wait",
          "key (dk̂ consumer): stage waits", "key (dk̂ consumer): step products and p, dS",
          "key (dk̂ consumer): dk normalise backward and store",
          "key (producer): tables, issuing copies", "key (producer): k̂/v buffer wait",
          "key (producer): stage waits", "key (producer): copies landing",
          "key (producer): k normalise, hand-over"]
VARIANTS["phases"] = [
    ("template <int DP, bool TILED>\n__global__ void __launch_bounds__(kFwdThreads, 1)\n"
     "    attn_bwd_q_kernel(",
     _PROF + "template <int DP, bool TILED>\n__global__ void __launch_bounds__(kFwdThreads, 1)\n"
     "    attn_bwd_q_kernel("),
    ("    setmaxnreg_inc<208>();\n    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, "
     "lane = tid % 32;\n    unsigned char* Kc",
     "    setmaxnreg_inc<208>();\n" + _ON.format(128) +
     "    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;\n"
     "    unsigned char* Kc"),
    ("        mbar_wait(&bar[L::Q_FULL + slot], (n >> 1) & 1);",
     "        PROF(0) mbar_wait(&bar[L::Q_FULL + slot], (n >> 1) & 1); PROF(1)"),
    ("          tma_store_commit();\n        }\n        // S = q̂s·k̂ᵀ and dp = do·vᵀ over this consumer's keys",
     "          tma_store_commit();\n        }\n        PROF(2)\n"
     "        // S = q̂s·k̂ᵀ and dp = do·vᵀ over this consumer's keys"),
    ("        mbar_wait(&bar[L::K_FULL], it & 1);\n        mbar_wait(&bar[L::V_FULL], it & 1);\n",
     "        mbar_wait(&bar[L::K_FULL], it & 1);\n        mbar_wait(&bar[L::V_FULL], it & 1); "
     "PROF(3)\n"),
    ("        fence_regs(dp);\n        if (qb == kWinTokens / kQB - 1) release(L::V_EMPTY);",
     "        fence_regs(dp); PROF(4)\n        if (qb == kWinTokens / kQB - 1) release(L::V_EMPTY);"),
    ("        float f[2], D[2];  // p = e f, and Σ p·dp",
     "        PROF(5) float f[2], D[2];  // p = e f, and Σ p·dp"),
    ("        dsum = warp_sum(dsum);", "        PROF(6) dsum = warp_sum(dsum);"),
    ("        if (qb == kWinTokens / kQB - 1) release(L::K_EMPTY);\n        float* part",
     "        PROF(7) if (qb == kWinTokens / kQB - 1) release(L::K_EMPTY);\n        float* part"),
    ("                                     part, tid);\n      }\n    }\n",
     "                                     part, tid);\n        PROF(8)\n      }\n    }\n"),
    ("    setmaxnreg_dec<80>();\n    const int tid = threadIdx.x;\n    int s = 0;",
     "    setmaxnreg_dec<80>();\n" + _ON.format(0) + "    const int tid = threadIdx.x;\n    int s = 0;"),
    ("    setmaxnreg_inc<208>();\n    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, "
     "lane = tid % 32;\n    const int q4 = lane % 4, r0 = acc_row(tid);",
     "    setmaxnreg_inc<208>();\n" + _ON.format(256) +
     "    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;\n"
     "    const int q4 = lane % 4, r0 = acc_row(tid);"),
    ("      mbar_wait(&bar[L::KV_FULL + kb], (it >> 1) & 1);",
     "      PROF(10) mbar_wait(&bar[L::KV_FULL + kb], (it >> 1) & 1); PROF(11)"),
    ("        mbar_wait(&bar[L::FULL + s], ph);", "        mbar_wait(&bar[L::FULL + s], ph); PROF(12)"),
    ("        release(L::EMPTY + s);", "        PROF(13) release(L::EMPTY + s);"),
    ("      fwd_store<DP, TILED>(acc, rows, dqkv, token, g, feat, col, d, c, tid);",
     "      fwd_store<DP, TILED>(acc, rows, dqkv, token, g, feat, col, d, c, tid); PROF(14)"),
    ("      mbar_wait(&bar[L::KV_EMPTY + kb], ((it >> 1) & 1) ^ 1);",
     "      PROF(15) mbar_wait(&bar[L::KV_EMPTY + kb], ((it >> 1) & 1) ^ 1); PROF(16)"),
    ("        mbar_wait(&bar[L::EMPTY + s], ph ^ 1);\n        if (tid == 0) {",
     "        PROF(15) mbar_wait(&bar[L::EMPTY + s], ph ^ 1); PROF(17)\n        if (tid == 0) {"),
    ("      if (last)\n        cp_async_wait<0>();",
     "      PROF(15) if (last)\n        cp_async_wait<0>();"),
    ("      named_barrier_sync(3, 128);  // every producer thread's copies of it have landed",
     "      named_barrier_sync(3, 128);  // every producer thread's copies of it have landed\n"
     "      PROF(18)"),
    ("      mbar_arrive(&bar[pend_bar]);", "      mbar_arrive(&bar[pend_bar]); PROF(19)"),
    ('extern "C" int swift_tiled_attention_bwd(',
     'extern "C" int swift_bwd_prof_read(void* host) {\n'
     '  static unsigned long long zero[20] = {};\n'
     '  cudaError_t e = cudaMemcpyFromSymbol(host, swift::swift_bwd_prof, sizeof(zero));\n'
     '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(swift::swift_bwd_prof, zero, sizeof(zero));\n'
     '  return (int)e;\n}\n\nextern "C" int swift_tiled_attention_bwd('),
]
UNCHECKED = ("q_only", "kv_only", "phases")
# name: (B, (gh, gw), heads, d, shift); "k16" shapes run kernel 16 on inputs rolled by the shift
SHAPES = {
    "k6 12x88 shift (8, 8)": (2, (64, 128), 12, 88, (8, 8)),
    "k6 8x128 shift (8, 8)": (2, (64, 128), 8, 128, (8, 8)),
    "k16 12x88 rolled (8, 8)": (2, (64, 128), 12, 88, (8, 8)),
    "k16 0.25° 8x128": (1, (368, 720), 8, 128, (0, 0)),
}
WINDOW = (16, 16)
KERNELS = ("attn_bwd_q_kernel", "attn_bwd_kv_kernel", "block_attn_bwd_kernel",
           "block_attn_bwd_kv_kernel", "tiled_attn_bwd_kernel", "tiled_attn_bwd_kv_kernel")


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.partials = hasattr(dll, "swift_block_attention_bwd_qb")  # the fp32 dk̂/dv partials
    # q̂s handed from the query pass to the key pass
    dll.stages = "void* stages" in (src / SOURCE).read_text()
    dll.swift_block_attention_bwd.argtypes = [P] * (7 + dll.stages + dll.partials) + [I] * 9 + [P]
    dll.swift_tiled_attention_bwd.argtypes = [P] * (7 + dll.stages) + [I] * 7 + [P]
    if dll.partials:
        dll.swift_block_attention_bwd_qb.argtypes = [I]
    if name == "phases":
        dll.swift_bwd_prof_read.argtypes = [P]


def inputs(rng, B, grid, heads, d, shift):
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            "cuda", torch.bfloat16)

    qkv, dout = t((B, *grid, 3 * heads * d)), t((B, *grid, heads * d))
    scale = torch.exp(0.3 * torch.from_numpy(rng.standard_normal(heads, dtype=np.float32))
                      + np.log(10.0)).cuda()
    rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dout))
    return qkv, dout, rolled, drolled, scale


def scratch(key):
    """Scratch for any build at ``key``'s shape: the statistics and scale
    partials, and, where kernel 6 runs there (a kernel 6 shape, or a shifted
    kernel 16 one, checked against kernel 6), an earlier kernel 6's fp32
    dk̂/dv partials (dp 128, 8 query blocks: the most any build takes)."""
    B, (gh, gw), heads, d, shift = SHAPES[key]
    n = B * heads * (gh // WINDOW[0]) * (gw // WINDOW[1])
    parts = n * 8 * 256 * 128 if key.startswith("k6") or any(shift) else 0
    return (torch.zeros(n * 3 * 256, device="cuda"), torch.zeros(n * 8, device="cuda"),
            torch.zeros(n * 4 * 16384, device="cuda", dtype=torch.uint8),
            torch.empty(parts, device="cuda"), torch.empty(parts, device="cuda"))


def calls(dll, key, t, outs, work, stream, kernel=None):
    """The launch of ``key``'s kernel (or of ``kernel``, 6 or 16) through
    ``dll``, writing ``outs`` (dqkv, dscale)."""
    B, (gh, gw), heads, d, shift = SHAPES[key]
    qkv, dout, rolled, drolled, scale = t
    dqkv, dscale = outs
    stats, part_s, stages, part_k, part_v = work
    # the workspace: an earlier kernel 6's partials, or the statistics, the scale's partials
    # and (where the build takes them) q̂s's stages
    new = [stats.data_ptr(), part_s.data_ptr()] + ([stages.data_ptr()] if dll.stages else [])
    if (kernel or int(key.split()[0][1:])) == 6:
        ws = [part_k.data_ptr(), part_v.data_ptr(), part_s.data_ptr()] if dll.partials else new
        return lambda: dll.swift_block_attention_bwd(
            qkv.data_ptr(), scale.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            dscale.data_ptr(), *ws, B, gh, gw, heads, d, *WINDOW, *shift, stream)
    return lambda: dll.swift_tiled_attention_bwd(
        rolled.data_ptr(), scale.data_ptr(), drolled.data_ptr(), dqkv.data_ptr(),
        dscale.data_ptr(), *new, B, gh, gw, heads, d, *WINDOW, stream)


def phases(dll, key, t, outs, work, stream) -> dict:
    """One call of ``key``'s kernel through the ``phases`` build: the clock64
    cycles of each phase, summed over block 0's work, as shares of each
    timed thread's total."""
    buf = (ctypes.c_ulonglong * 20)()
    dll.swift_bwd_prof_read(ctypes.addressof(buf))  # zero the timers
    calls(dll, key, t, outs, work, stream)()
    torch.cuda.synchronize()
    if dll.swift_bwd_prof_read(ctypes.addressof(buf)):
        raise RuntimeError("phases: the timers could not be read")
    cyc = list(buf)
    spans = [(0, 10), (10, 15), (15, 20)]
    totals = [sum(cyc[a:b]) for a, b in spans]
    rows = {}
    for (a, b), tot in zip(spans, totals):
        for i in range(a, b):
            if PHASES[i] != "-":
                rows[PHASES[i]] = [cyc[i], cyc[i] / max(tot, 1)]
    print(f"phases {key}: query consumer {totals[0]}, key consumer {totals[1]}, key producer "
          f"{totals[2]} cycles", flush=True)
    for name, (c, share) in rows.items():
        print(f"  {name:45s} {c:12d} cycles  {100 * share:5.1f}%", flush=True)
    return {"totals": totals, "phases": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--shapes", default=";".join(SHAPES), help="the shapes, ';'-separated")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "attention_bwd.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention_bwd: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        times: dict = {}
        phase_cycles: dict = {}
        for key in args.shapes.split(";"):
            B, grid, heads, d, shift = SHAPES[key]
            t = inputs(rng, B, grid, heads, d, shift)
            qkv, dout, rolled, drolled, scale = t
            k6 = key.startswith("k6")
            plain_args = ((qkv, scale, dout, heads, WINDOW, shift) if k6 else
                          (rolled, scale, drolled, heads, WINDOW))
            want = [w.float() for w in block_attention.reference_block_attention_bwd(*plain_args)]
            refs = [w.abs().max().item() for w in want]
            work = scratch(key)
            fns = {}
            for name, dll in libs.items():
                outs = (torch.empty_like(qkv), torch.empty_like(scale))
                fn = calls(dll, key, t, outs, work, stream)
                code = fn()
                if code and name in UNCHECKED:
                    print(f"{name} {key}: launch failed ({code}), dropped", flush=True)
                    continue
                if code:
                    raise RuntimeError(f"{name} {key}: launch failed ({code})")
                torch.cuda.synchronize()
                fns[name] = (fn, outs)
                if name in UNCHECKED:
                    continue
                first = [o.clone() for o in outs]
                fn()
                torch.cuda.synchronize()
                errs = [(o.float() - w).abs().max().item() for o, w in zip(outs, want)]
                same = all(torch.equal(o, f) for o, f in zip(outs, first))
                print(f"{name} {key}: max err dqkv {errs[0]:.3e} of {refs[0]:.3e}, dscale "
                      f"{errs[1]:.3e} of {refs[1]:.3e}; two calls equal bit for bit: {same}",
                      flush=True)
                if not (all(torch.isfinite(o).all() for o in outs)
                        and all(e <= TOL * r for e, r in zip(errs, refs)) and same):
                    raise AssertionError(f"{name} {key} is off its plain version ({errs}) or "
                                         f"differs from call to call ({same})")
                if not k6 and any(shift) and not dll.partials:  # 16 on rolled inputs against 6
                    k6_outs = (torch.empty_like(qkv), torch.empty_like(scale))
                    calls(dll, key, t, k6_outs, scratch(key), stream, kernel=6)()
                    same = (torch.equal(torch.roll(outs[0], shift, (1, 2)), k6_outs[0])
                            and torch.equal(outs[1], k6_outs[1]))
                    print(f"{name} {key}: equal to kernel 6 bit for bit: {same}", flush=True)
                    if not same:
                        raise AssertionError(f"{name}: kernel 16 differs from kernel 6")
            del want
            if "phases" in fns and k6:
                phase_cycles[key] = phases(libs["phases"], key, t, fns["phases"][1], work, stream)
            order = [n for n in fns if n != "phases"]
            order += order[::-1]
            for name in order:
                times.setdefault(f"{name} {key}", []).append(queued_ms(fns[name][0]))
            comp = COMPOSITION["block_attention_bwd" if k6 else
                               "tiled_block_attention_bwd"](*plain_args)
            times[f"composition {key}"] = [queued_ms(comp)]
            del comp
            print(f"{key} (ms, queued): " + "; ".join(
                f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()
                if key in k), flush=True)
            del t, qkv, dout, rolled, drolled, fns, work
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "window": WINDOW, "shapes": SHAPES, "ms": times,
                               "phase_cycles": phase_cycles}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
