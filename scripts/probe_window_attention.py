"""Time kernel 21, the per-head attention forward, against an earlier build
and ``F.scaled_dot_product_attention`` on the card.

    python scripts/probe_window_attention.py [--parent DIR] [--also NAME=DIR]
        [--variants A,B] [--out chiprun_out/window_attention.json]

The committed ``swift_torch/csrc/window_attention.cu`` is built alone into a
library of its own (ptxas's registers and spills of kernel 21's
instantiations printed), and beside it variants, each the committed source
with one change made by text substitution in a temporary copy
(``scripts/probe_build.py``):

* ``two_stages``: the packed form (n <= 64) with a ring of two stages
  instead of four.
* ``online_64``: the row form with key tiles of 64 rows instead of 128
  where DP <= 128 (n 65-128 then takes the online softmax over two tiles).
* ``keys_256``: the row form with key tiles of 256 rows where DP <= 128,
  so that up to n 256 whole rows of S stay in registers (S alone takes
  128 a thread).
* ``three_consumers``: the packed form with three consumer warpgroups
  where DP <= 192 (512 threads, 40/152 registers, stages a multiple of
  three).
* ``no_store`` (wrong outputs, not checked): the packed form without its
  output stores.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc``
(``git archive <commit> swift_torch/csrc | tar -x -C DIR
--strip-components 2``) is built and timed too, and so is each ``--also
NAME=DIR``. Every build is called through its C entry
``swift_window_attention`` at each shape of ``SHAPES`` (path B's first),
checked against ``reference_sdpa`` (within 2e-2 of max|plain|) and two of
its calls against each other bit for bit. Then, in turns (the builds in
order, then in reverse), each shape is timed as the median of 5 rounds of
20 calls queued back to back between two CUDA events (the device's time),
and beside them SDPA at scale 1, queued and as single calls (``time_ms``,
the host's cost of a call included). The host's cost of a call: at path
A's shape (a few µs on the device), 500 calls of each build's C entry
through ctypes, and of the ``window_attention`` wrapper (committed build),
one after another on the host clock, synchronised once at the end; and
single calls of the wrapper (``time_ms``) at each shape. Prints the times
and writes them as JSON. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import time_ms  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402
from swift_torch.ops.window_attention import reference_sdpa, window_attention  # noqa: E402

TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int
SOURCE = "window_attention.cu"
KERNELS = ("win_fwd", "win_attn_fwd")  # the wgmma forms, and the WMMA kernel they replaced
VARIANTS = {
    "committed": [],
    "two_stages": [("      OWN_STG && 1024 + 2 * NC * STAGE",
                    "      false && 1024 + 2 * NC * STAGE")],
    "online_64": [("  static constexpr int NK = DP <= 128 ? 128 : DP <= 192 ? 64 : 32;",
                   "  static constexpr int NK = DP <= 192 ? 64 : 32;")],
    "keys_256": [("  static constexpr int NK = DP <= 128 ? 128 : DP <= 192 ? 64 : 32;",
                  "  static constexpr int NK = DP <= 128 ? 256 : DP <= 192 ? 64 : 32;")],
    # three q, k, v stages of DP > 192 do not fit beside each other; 512 threads at 40/152
    # registers
    "three_consumers": [
        ("  static constexpr int NC = 2;", "  static constexpr int NC = DP <= 192 ? 3 : 2;"),
        ("__launch_bounds__(kWinFwdThreads, 1)\n    win_fwd_packed_kernel(",
         "__launch_bounds__(128 * (WinPacked<DP>::NC + 1), 1)\n    win_fwd_packed_kernel("),
        ("    setmaxnreg_dec<80>();\n    const int tid = threadIdx.x;\n"
         "    if (tma && tid != 0) return;\n    if (tma) {\n      tma_prefetch(&mq);\n"
         "      tma_prefetch(&mk);\n      tma_prefetch(&mv);\n    }\n    for (int i = 0,",
         "    setmaxnreg_dec<L::NC == 2 ? 80 : 40>();\n    const int tid = threadIdx.x;\n"
         "    if (tma && tid != 0) return;\n    if (tma) {\n      tma_prefetch(&mq);\n"
         "      tma_prefetch(&mk);\n      tma_prefetch(&mv);\n    }\n    for (int i = 0,"),
        ("  setmaxnreg_inc<208>();  // the consumers\n  const int c = threadIdx.x / 128 - 1, "
         "tid = threadIdx.x % 128, q4 = tid % 4;\n  const int r = win_acc_row(tid);",
         "  setmaxnreg_inc<L::NC == 2 ? 208 : 152>();\n  const int c = threadIdx.x / 128 - 1, "
         "tid = threadIdx.x % 128, q4 = tid % 4;\n  const int r = win_acc_row(tid);"),
        ("launch_persistent(win_fwd_packed_kernel<DP>, win_fwd_sms[0][ID], kWinFwdThreads,",
         "launch_persistent(win_fwd_packed_kernel<DP>, win_fwd_sms[0][ID],\n"
         "                             128 * (WinPacked<DP>::NC + 1),"),
    ],
    "no_store": [("      win_store<NO>(oc, own, o, row0, live, d, tma, c, tid);",
                  "      if (row0 < 0) win_store<NO>(oc, own, o, row0, live, d, tma, c, tid);")],
}
UNCHECKED = ("no_store",)  # wrong outputs by design: timed only
# name: (BW, heads, n, d)
SHAPES = {
    "path B": (256, 12, 64, 88),
    "n256 d160": (64, 8, 256, 160),
    "n1024 d88": (16, 12, 1024, 88),
    "path A": (32, 4, 4, 8),
    "n36 d88": (256, 12, 36, 88),
    "n257 d88": (16, 12, 257, 88),
    "n256 d88": (64, 8, 256, 88),
}


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_window_attention.argtypes = [P] * 4 + [I] * 3 + [P]


def host_us(fn, calls: int = 500) -> float:
    """Microseconds a call over ``calls`` calls made one after another on the
    host clock, synchronised once at the end: the host's cost of a call
    where it exceeds the device's."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def inputs(rng, shape):
    """q̂ and k̂ L2-normalised (q̂ times 10, the logit scale's init) and v,
    bf16, as the per-head route hands them to kernel 21."""
    def t():
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()

    q, k = t(), t()
    qn = (q * torch.rsqrt((q * q).sum(-1, keepdim=True)) * 10.0).bfloat16()
    kn = (k * torch.rsqrt((k * k).sum(-1, keepdim=True))).bfloat16()
    return qn, kn, t().bfloat16()


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--shapes", default=";".join(SHAPES), help="the shapes, ';'-separated")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "window_attention.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_window_attention: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        times: dict = {}
        for key in args.shapes.split(";"):
            shape = SHAPES[key]
            BW, h, n, d = shape
            q, k, v = inputs(rng, shape)
            want = reference_sdpa(q, k, v).float()
            ref = want.abs().max().item()
            fns = {}
            for name, dll in libs.items():
                out = torch.empty_like(q)
                fn = (lambda dll=dll, out=out: dll.swift_window_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BW * h, n, d,
                    stream))
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
                if name in UNCHECKED:
                    fns[name] = fn
                    continue
                if not (torch.isfinite(out).all() and err <= TOL * ref and same):
                    raise AssertionError(f"{name} {key} is off its plain version ({err}) or "
                                         f"differs from call to call ({same})")
                fns[name] = fn
            del want
            order = list(fns) + list(fns)[::-1]
            for name in order:
                times.setdefault(f"{name} {key}", []).append(queued_ms(fns[name]))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
            times[f"sdpa {key}"] = [queued_ms(sdpa)]
            times[f"sdpa single {key}"] = [time_ms(sdpa)]
            times[f"wrapper single {key}"] = [time_ms(lambda: window_attention(q, k, v))]
            if key == "path A":
                for name, fn in list(fns.items()) + [("wrapper", lambda: window_attention(q, k, v)),
                                                    ("sdpa", sdpa)]:
                    times[f"{name} host us {key}"] = [host_us(fn)]
            print(f"{key} {shape} (ms, queued): " + "; ".join(
                f"{kk.rsplit(' ' + key, 1)[0]} {' '.join(f'{x:.4f}' for x in vs)}"
                for kk, vs in times.items() if kk.endswith(" " + key)), flush=True)
            del q, k, v, fns
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "shapes": SHAPES, "ms": times}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
