"""Time kernel 22t, the per-head attention tangent, against an earlier build
on the card.

    python scripts/probe_window_attention_tangent.py [--parent DIR] [--also NAME=DIR]
        [--variants A,B] [--shapes S1;S2] [--out chiprun_out/window_attention_tangent.json]

The committed ``swift_torch/csrc/window_attention.cu`` is built alone into a
library of its own (ptxas's registers and spills of every kernel 22t
instantiation printed, of the wgmma forms and of the WMMA kernel they
replaced), and beside it variants, each the committed source with one
change made by text substitution in a temporary copy
(``scripts/probe_build.py``):

* ``packed_two_stages``: the packed form (n <= 64 at d <= 128) with a ring
  of two stages where four fit (DP <= 64; two is all that fits at DP
  96-128, a stage of six 64-row tensors being 96 KB).
* ``rows_two_stages``, ``rows_four_stages``: the row form's ring of key
  halves ((k̂, dk̂) or (v, dv), NK rows each) two or four deep where the
  committed build takes up to six.
* ``rows_keys_32``: the row form with key tiles of 32 rows up to DP 192
  (committed: 64 up to DP 128).
* ``no_store`` (wrong outputs, not checked): the packed form without its
  output stores.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc``
(``git archive <commit> swift_torch/csrc | tar -x -C DIR
--strip-components 2``) is built and timed too, and so is each ``--also
NAME=DIR``. Every build is called through its C entry
``swift_window_attention_tangent`` at each shape of ``SHAPES`` (path B's
first), checked against ``reference_sdpa_tangent`` (within 2e-2 of
max|plain|) and two of its calls against each other bit for bit. Then, in
turns (the builds in order, then in reverse), each shape is timed as the
median of 5 rounds of 20 calls queued back to back between two CUDA events
(the device's time) and as single calls (``time_ms``: CUDA events around
each call, the host's cost of a ctypes call included), and the
``window_attention_tangent`` wrapper's single calls. Prints the times,
each build's share of the bound (``chip_smoke.kernel_bound``), and writes
them as JSON. Needs one card and nvcc.
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
KERNELS = ("win_tan", "win_attn_tangent")  # the wgmma forms, and the WMMA kernel they replaced
_ROW_STAGES = "  static constexpr int STAGES = FIT > 6 ? 6 : FIT;"
VARIANTS = {
    "committed": [],
    "packed_two_stages": [("      OWN_STG && 1024 + 2 * NC * STAGE",
                           "      false && 1024 + 2 * NC * STAGE")],
    "rows_two_stages": [(_ROW_STAGES, _ROW_STAGES.replace("6", "2"))],
    "rows_four_stages": [(_ROW_STAGES, _ROW_STAGES.replace("6", "4"))],
    "rows_keys_32": [("  static constexpr int NK = DP <= 128 ? 64 : DP <= 192 ? 32 : 16;",
                      "  static constexpr int NK = DP <= 192 ? 32 : 16;")],
    "no_store": [("    win_store<NO>(oc, own, tout, row0, live, d, tma, c, tid);",
                  "    if (row0 < 0) win_store<NO>(oc, own, tout, row0, live, d, tma, c, tid);")],
}
UNCHECKED = ("no_store",)  # wrong outputs by design: timed only
# name: (BW, heads, n, d)
SHAPES = {
    "path B": (256, 12, 64, 88),
    "n256 d160": (64, 8, 256, 160),
    "n1024 d88": (16, 12, 1024, 88),
    "path A": (32, 4, 4, 8),
    "n257 d88": (16, 12, 257, 88),
}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_window_attention_tangent.argtypes = [P] * 7 + [I] * 3 + [P]


def inputs(rng, shape):
    """q̂ and k̂ L2-normalised (q̂ times 10, the logit scale's init), v and the
    three tangents, bf16, as the per-head route hands them to kernel 22t."""
    def t():
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()

    q, k = t(), t()
    qn = (q * torch.rsqrt((q * q).sum(-1, keepdim=True)) * 10.0).bfloat16()
    kn = (k * torch.rsqrt((k * k).sum(-1, keepdim=True))).bfloat16()
    return (qn, kn) + tuple(t().bfloat16() for _ in range(4))


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--shapes", default=";".join(SHAPES), help="the shapes, ';'-separated")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "window_attention_tangent.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_window_attention_tangent: needs a CUDA device")
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
            ins = inputs(rng, shape)
            plain = wa.reference_sdpa_tangent(*ins)
            bound_ms, bound_by = kernel_bound("window_attention_tangent", ins, plain)
            want, ref = plain.float(), plain.float().abs().max().item()
            del plain
            fns = {}
            for name, dll in libs.items():
                out = torch.empty_like(ins[2])
                fn = (lambda dll=dll, out=out: dll.swift_window_attention_tangent(
                    *(t.data_ptr() for t in ins), out.data_ptr(), BW * h, n, d, stream))
                code = fn()
                if code:
                    raise RuntimeError(f"{name} {key}: launch failed ({code})")
                torch.cuda.synchronize()
                first = out.clone()
                fn()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                same = torch.equal(out, first)
                print(f"{name} {key}: max err {err:.3e} of {ref:.3e}; two calls equal bit for "
                      f"bit: {same}", flush=True)
                fns[name] = fn
                if name in UNCHECKED:
                    continue
                if not (torch.isfinite(out).all() and err <= TOL * ref and same):
                    raise AssertionError(f"{name} {key} is off its plain version ({err}) or "
                                         f"differs from call to call ({same})")
            del want
            order = list(fns) + list(fns)[::-1]
            for name in order:
                times.setdefault(f"{name} {key}", []).append(queued_ms(fns[name]))
                times.setdefault(f"{name} single {key}", []).append(time_ms(fns[name]))
            times[f"wrapper single {key}"] = [time_ms(lambda: wa.window_attention_tangent(*ins))]
            shares[key] = {"bound_ms": bound_ms, "bound_by": bound_by, **{
                name: bound_ms / float(np.median(times[f"{name} {key}"])) for name in fns}}
            print(f"{key} {shape} (ms; bound {bound_ms:.4f} ms, {bound_by}): " + "; ".join(
                f"{kk.rsplit(' ' + key, 1)[0]} {' '.join(f'{x:.4f}' for x in vs)}"
                for kk, vs in times.items() if kk.endswith(" " + key)), flush=True)
            print(f"{key} share of the bound, queued: " + ", ".join(
                f"{name} {100 * shares[key][name]:.1f}%" for name in fns), flush=True)
            del ins, fns
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "shapes": SHAPES, "ms": times, "shares": shares},
                              indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
