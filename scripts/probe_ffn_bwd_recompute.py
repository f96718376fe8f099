"""Time kernel 10, the recompute FFN backward, against a form of its design
that keeps dh in registers, an earlier build, the saved route's kernels 8
and 9, a composition of library calls and other token chunks, on the card.

    python scripts/probe_ffn_bwd_recompute.py [--parent DIR] [--also NAME=DIR]
        [--variants A,B] [--chunks 16384,45056] [--out chiprun_out/ffn_bwd_recompute.json]

The committed ``swift_torch/csrc/gemm_bwd.cu`` is built alone into a library
of its own, and beside it variants, each the committed source with one
change made by text substitution in a temporary copy (no file of the repo
changes):

* ``dh_in_registers``: walk 1's dh stays in registers beside walk 2's
  accumulator (192 accumulator floats; ptxas's spills are printed) instead
  of waiting in shared memory, and three boxes of their own (h, dg, du)
  take the park's place, the dg and du boxes reused once the last step's
  stores have read them;
* ``products_only`` (wrong output, not checked): the recompute pass with
  no epilogue (no SwiGLU backward, no box, no store) -- what the epilogue
  costs while neither consumer multiplies.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc`` (``git
archive <commit> swift_torch/csrc | tar -x -C DIR --strip-components 2``)
is built and timed too: where it has ``swift_ffn_bwd_chunk``, its
``swift_ffn_bwd_recompute`` takes all the tokens in one call (the WMMA
recompute kernel over its own 16,384-token chunks).

Shapes: the flagship at B = 2 (T = 16,384, D = 1056, H = 2816) and 0.25°
(T = 264,960). Every checked build is held at each shape to the plain
version (``reference_swiglu_ffn_bwd_recompute``), within 2e-2 of
max|plain| for each output, and two of its calls to each other bit for
bit. Then, in turns (the builds in order, then in reverse), each is timed
as 20 calls (5 at 0.25°) queued back to back between two CUDA events and
as the median of single calls; beside them the committed build at each
length of ``--chunks`` (``ffn.FFN_BWD_CHUNK_TOKENS``; the committed length
is timed as the build), the saved route's kernels 8 then 9 on the same
tokens (the repo's build) and ``chip_smoke.COMPOSITION``'s kernel 10
(``F.linear`` for g | u, then kernel 9's composition, over the same
chunks). Each build's launches are split by device time under
torch.profiler. Prints the card, the times and the share of the 16 T D H
FLOP bound, and writes them as JSON. Needs one card and nvcc.
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
from chip_smoke import COMPOSITION, PEAK_FLOPS, time_ms  # noqa: E402
from swift_torch.ops import ffn  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_ffn_int8 import by_pass  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int
SOURCE = "gemm_bwd.cu"
KERNELS = ("recompute", "bwd_wgmma")
# dh kept in registers: no park, dg and du in two boxes of their own
DH_IN_REGISTERS = [
    ("constexpr int kRecRegion = kDhBytes + kLinCBox;", "constexpr int kRecRegion = 3 * kLinCBox;"),
    ("      if (tid == 0) tma_store_wait_read<0>();  // the last tile's boxes in the park are read\n"
     "      named_barrier_sync(1 + c, 128);\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < kRecBN / 2; ++i) park[i * 128 + tid] = dh[i];\n", ""),
    ("unsigned char* gb = region + q * 2 * kLinCBox;", "unsigned char* gb = region;"),
    ("swiglu_grad(park[i * 128 + tid],", "swiglu_grad(dh[i],"),
    ("swiglu_grad(park[(i + 1) * 128 + tid],", "swiglu_grad(dh[i + 1],"),
    ("        named_barrier_sync(1 + c, 128);  // the h box is whole, this step's park is read",
     "        if (tid == 0) tma_store_wait_read<0>();  // the last dg, du stores have read theirs\n"
     "        named_barrier_sync(1 + c, 128);"),
]
VARIANTS = {
    "committed": [],
    "dh_in_registers": DH_IN_REGISTERS,
    "products_only": [("        if (col >= H) break;", "        if (col >= H || M > 0) break;")],
}
UNCHECKED = ("products_only",)
D, H = 1056, 2816
SHAPES = {"flagship B=2": 16384, "0.25°": 264960}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    """The old entry (all the tokens in one call) where the build has
    ``swift_ffn_bwd_chunk``, else the committed one a chunk."""
    dll.old_entry = hasattr(dll, "swift_ffn_bwd_chunk")
    dll.swift_ffn_bwd_recompute.argtypes = [P] * 13 + [I] * (3 if dll.old_entry else 6) + [P]
    if dll.old_entry:
        dll.swift_ffn_bwd_chunk.argtypes = []
        dll.swift_splitk_workspace.argtypes = [I, I, I]
        dll.swift_splitk_workspace.restype = ctypes.c_longlong


def call_of(dll, x, dy, w1, w2):
    """One kernel 10 call of ``dll``: the committed wrapper's chunk loop
    (``ffn._bwd_recompute``), or the old entry with its scratch allocated
    once here (the call holds it, so that its memory stays its own)."""
    if not dll.old_entry:
        return lambda: ffn._bwd_recompute(dll, x, dy, w1, w2)
    T, dev = x.shape[0], x.device
    c = min(T, dll.swift_ffn_bwd_chunk())
    out = (torch.empty_like(x), torch.empty_like(w1), torch.empty_like(w2))
    f32 = dict(device=dev, dtype=torch.float32)
    scratch = (torch.empty(c, 2 * H, device=dev, dtype=x.dtype),
               torch.empty(c, H, device=dev, dtype=x.dtype),
               torch.empty(dll.swift_splitk_workspace(2 * H, D, c), **f32),
               torch.empty(dll.swift_splitk_workspace(D, H, c), **f32),
               torch.empty(2 * H * D, **f32), torch.empty(D * H, **f32))
    ptrs = [t.data_ptr() for t in (x, dy, w1, w2, *out, *scratch)]
    stream = torch.cuda.current_stream().cuda_stream

    def run(held=scratch):
        code = dll.swift_ffn_bwd_recompute(*ptrs, T, D, H, stream)
        if code:
            raise RuntimeError(f"the parent's kernel 10 failed to launch ({code})")
        return out

    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--chunks", default="16384,45056",
                    help="other FFN_BWD_CHUNK_TOKENS to time the committed build at")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "ffn_bwd_recompute.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_ffn_bwd_recompute: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    chunk_tokens = ffn.FFN_BWD_CHUNK_TOKENS
    out: dict = {"card": card, "D": D, "H": H, "shapes": SHAPES, "chunk_tokens": chunk_tokens,
                 "ms": {}, "by_pass": {}, "bound_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        rng = np.random.default_rng(0)

        def t(shape, scale=1.0):
            a = scale * rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(a).to("cuda", torch.bfloat16)

        w1, w2 = t((2 * H, D), D ** -0.5), t((D, H), H ** -0.5)
        times = out["ms"]
        for key, T in SHAPES.items():
            x, dy = t((T, D)), t((T, D))
            reps = 20 if T < 65536 else 5
            bound = out["bound_ms"][key] = 16.0 * T * D * H / PEAK_FLOPS * 1e3
            want = [w.float() for w in ffn.reference_swiglu_ffn_bwd_recompute(x, dy, w1, w2)]
            refs = [w.abs().max().item() for w in want]
            calls = {}
            for name, dll in libs.items():
                call = call_of(dll, x, dy, w1, w2)
                got = [g.clone() for g in call()]
                again = call()
                torch.cuda.synchronize()
                calls[name] = call
                if name in UNCHECKED:
                    continue
                errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                print(f"{name} {key}: max err {errs} of max|plain| {refs}; two calls equal bit "
                      f"for bit: {same}", flush=True)
                if not (all(torch.isfinite(g).all() for g in got) and same and all(
                        e <= TOL * r for e, r in zip(errs, refs))):
                    raise AssertionError(f"{name} {key} is off its plain version or not "
                                         f"deterministic: {errs}, {same}")
                del got, again
            del want
            for name in list(calls) + list(calls)[::-1]:
                times.setdefault(f"{name} {key}", []).append(queued_ms(calls[name], reps))
                times.setdefault(f"{name} {key} single", []).append(time_ms(calls[name], reps))
            for name in calls:
                out["by_pass"][f"{name} {key}"] = by_pass(calls[name])
            committed = libs["committed"]
            for length in (int(n) for n in args.chunks.split(",") if n):
                ffn.FFN_BWD_CHUNK_TOKENS = length
                fn = call_of(committed, x, dy, w1, w2)
                times[f"committed chunks of {length} {key}"] = [queued_ms(fn, reps)]
                times[f"committed chunks of {length} {key} single"] = [time_ms(fn, reps)]
            ffn.FFN_BWD_CHUNK_TOKENS = chunk_tokens

            def pair():
                _, g, u = ffn.swiglu_ffn_fwd_save(x, w1, w2)
                return ffn.swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2)

            yards = {"kernels 8 + 9": pair,
                     "composition": COMPOSITION["swiglu_ffn_bwd_recompute"](x, dy, w1, w2)}
            for name, fn in yards.items():
                times[f"{name} {key}"] = [queued_ms(fn, reps)]
                times[f"{name} {key} single"] = [time_ms(fn, reps)]
            print(f"{key}, bound {bound:.4f} ms (ms, queued unless single; % of the bound): "
                  + "; ".join(f"{k} " + " ".join(f"{v:.4f} ({100 * bound / v:.1f}%)" for v in vs)
                              for k, vs in times.items() if k.endswith(key) or
                              k.endswith(f"{key} single")), flush=True)
            for name in calls:
                print(f"{name} {key} by kernel (device ms a call): " + json.dumps(
                    {k: round(v, 4) for k, v in out["by_pass"][f"{name} {key}"].items()}),
                    flush=True)
            del x, dy, calls, yards
            torch.cuda.empty_cache()
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
