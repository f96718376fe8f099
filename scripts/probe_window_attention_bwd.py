"""Time kernel 22b, the per-head attention backward, against an earlier build
and the backward of ``F.scaled_dot_product_attention`` on the card.

    python scripts/probe_window_attention_bwd.py [--parent DIR] [--also NAME=DIR]
        [--variants A,B] [--shapes S1;S2] [--out chiprun_out/window_attention_bwd.json]

The committed ``swift_torch/csrc/window_attention.cu`` is built alone into a
library of its own (ptxas's registers and spills of every kernel 22b
instantiation printed, of the wgmma forms and of the WMMA kernels they
replaced), and beside it variants, each the committed source with one
change made by text substitution in a temporary copy
(``scripts/probe_build.py``):

* ``packed_three_stages``: the packed form (n <= 64 at d <= 128) with a
  ring of three stages where six fit (DP <= 64; three at DP 96-128). Two
  would hang: a consumer hands a tile's stage back once it has started its
  next tile.
* ``query_keys_64``: the row form's query pass with key stages of 64 rows
  where DP <= 128 (128 committed): two walks from n 65, no spills.
* ``split_keys``: the key pass's consumers split dv and dk̂ over the same 64
  keys at every DP (committed: from DP 128; below it each consumer owns 64
  keys and both sums).
* ``q_only`` (wrong outputs, not checked): the row form without its key
  pass -- the query pass alone.
* ``kv_only`` (wrong outputs, not checked): the row form without its query
  pass -- the key pass alone, on the statistics the committed build left in
  the scratch.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc``
(``git archive <commit> swift_torch/csrc | tar -x -C DIR
--strip-components 2``) is built and timed too, and so is each ``--also
NAME=DIR``. Every build is called through its C entry
``swift_window_attention_bwd`` (scratch for the larger of the committed
rule and the earlier builds' 12 bytes a row) at each shape of ``SHAPES``
(path B's first), checked against ``reference_sdpa_bwd`` (dq, dk and dv
within 2e-2 of max|plain|) and two of its calls against each other bit for
bit. Then, in turns (the builds in order, then in reverse), each shape is
timed as the median of 5 rounds of 20 calls queued back to back between two
CUDA events (the device's time) and as single calls (``time_ms``: CUDA
events around each call, the host's cost of a ctypes call included), and
beside them the backward of SDPA at scale 1 (``torch.autograd.grad``
through one recorded forward) both ways, and the ``window_attention_bwd``
wrapper's single calls. Prints the times, each build's share of the bound
(``chip_smoke.kernel_bound``), and writes them as JSON. Needs one card and
nvcc.
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
from chip_smoke import kernel_bound, time_ms  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402
from swift_torch.ops import window_attention as wa  # noqa: E402

TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int
SOURCE = "window_attention.cu"
KERNELS = ("win_bwd", "win_attn_bwd")  # the wgmma forms, and the WMMA kernels they replaced
_LAUNCH_Q = "  int err = launch_persistent(win_bwd_q_kernel<DP>,"
_LAUNCH_KV = "  return launch_persistent(win_bwd_kv_kernel<DP>,"
VARIANTS = {
    "committed": [],
    "packed_three_stages": [("  static constexpr int STAGES = FIT < 6 ? FIT : 6;",
                             "  static constexpr int STAGES = FIT < 3 ? FIT : 3;")],
    "query_keys_64": [(
        "  static constexpr int NK = DP <= 128 ? 128 : (DP <= 192 ? 64 : 32);",
        "  static constexpr int NK = DP <= 192 ? 64 : 32;")],
    "split_keys": [("  static constexpr bool SPLIT = DP >= 128;",
                    "  static constexpr bool SPLIT = true;")],
    "q_only": [(_LAUNCH_KV, "  if (bh > 0) return 0;\n" + _LAUNCH_KV)],
    "kv_only": [(_LAUNCH_Q, _LAUNCH_Q.replace("= launch", "= bh > 0 ? 0 : launch"))],
}
UNCHECKED = ("q_only", "kv_only")  # wrong outputs by design: timed only
# name: (BW, heads, n, d)
SHAPES = {
    "path B": (256, 12, 64, 88),
    "n256 d160": (64, 8, 256, 160),
    "n1024 d88": (16, 12, 1024, 88),
    "path A": (32, 4, 4, 8),
}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_window_attention_bwd.argtypes = [P] * 8 + [I] * 3 + [P]


def inputs(rng, shape):
    """q̂ and k̂ L2-normalised (q̂ times 10, the logit scale's init), v and
    do, bf16, as the per-head route hands them to kernel 22b."""
    def t():
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()

    q, k = t(), t()
    qn = (q * torch.rsqrt((q * q).sum(-1, keepdim=True)) * 10.0).bfloat16()
    kn = (k * torch.rsqrt((k * k).sum(-1, keepdim=True))).bfloat16()
    return qn, kn, t().bfloat16(), t().bfloat16()


def sdpa_bwd(q, k, v, do):
    """The backward of SDPA at scale 1, the forward recorded once."""
    qkv = [a.detach().requires_grad_() for a in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*qkv, scale=1.0)
    return lambda: torch.autograd.grad(out, qkv, do, retain_graph=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--shapes", default=";".join(SHAPES), help="the shapes, ';'-separated")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "window_attention_bwd.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_window_attention_bwd: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        times: dict = {}
        shares: dict = {}
        for key in args.shapes.split(";"):
            shape = SHAPES[key]
            BW, h, n, d = shape
            bh = BW * h
            q, k, v, do = inputs(rng, shape)
            plain = wa.reference_sdpa_bwd(q, k, v, do)
            bound_ms, bound_by = kernel_bound("window_attention_bwd", (q, k, v, do), plain)
            want = [w.float() for w in plain]
            refs = [w.abs().max().item() for w in want]
            del plain
            floats = max(wa.bwd_scratch_floats(bh, n, d), bh * 3 * n)
            fns, scratches = {}, {}
            for name, dll in libs.items():
                # each build its own scratch; kv_only reads the committed build's statistics
                scratch = scratches.get("committed") if name == "kv_only" else None
                if scratch is None:
                    scratch = torch.empty(floats, device="cuda", dtype=torch.float32)
                scratches[name] = scratch
                outs = [torch.empty_like(q) for _ in range(3)]
                fn = (lambda dll=dll, outs=outs, scratch=scratch: dll.swift_window_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    *(o.data_ptr() for o in outs), scratch.data_ptr(), bh, n, d, stream))
                code = fn()
                if code:
                    raise RuntimeError(f"{name} {key}: launch failed ({code})")
                torch.cuda.synchronize()
                first = [o.clone() for o in outs]
                fn()
                torch.cuda.synchronize()
                errs = [(o.float() - w).abs().max().item() for o, w in zip(outs, want)]
                same = all(torch.equal(a, b) for a, b in zip(outs, first))
                print(f"{name} {key}: max err (dq, dk, dv) "
                      f"{', '.join(f'{e:.3e} of {r:.3e}' for e, r in zip(errs, refs))}; two "
                      f"calls equal bit for bit: {same}", flush=True)
                fns[name] = fn
                if name in UNCHECKED:
                    continue
                if not (all(torch.isfinite(o).all() for o in outs)
                        and all(e <= TOL * r for e, r in zip(errs, refs)) and same):
                    raise AssertionError(f"{name} {key} is off its plain version ({errs}) or "
                                         f"differs from call to call ({same})")
            del want
            order = list(fns) + list(fns)[::-1]
            for name in order:
                times.setdefault(f"{name} {key}", []).append(queued_ms(fns[name]))
                times.setdefault(f"{name} single {key}", []).append(time_ms(fns[name]))
            lib = sdpa_bwd(q, k, v, do)
            times[f"sdpa bwd {key}"] = [queued_ms(lib)]
            times[f"sdpa bwd single {key}"] = [time_ms(lib)]
            times[f"wrapper single {key}"] = [time_ms(lambda: wa.window_attention_bwd(q, k, v, do))]
            shares[key] = {"bound_ms": bound_ms, "bound_by": bound_by, **{
                name: bound_ms / float(np.median(times[f"{name} {key}"])) for name in fns}}
            print(f"{key} {shape} (ms; bound {bound_ms:.4f} ms, {bound_by}): " + "; ".join(
                f"{kk.rsplit(' ' + key, 1)[0]} {' '.join(f'{x:.4f}' for x in vs)}"
                for kk, vs in times.items() if kk.endswith(" " + key)), flush=True)
            print(f"{key} share of the bound, queued: " + ", ".join(
                f"{name} {100 * shares[key][name]:.1f}%" for name in fns), flush=True)
            del q, k, v, do, fns, lib, scratches
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "shapes": SHAPES, "ms": times, "shares": shares},
                              indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
