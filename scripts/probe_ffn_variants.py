"""Time kernels 5, 8 and 11, whole and by pass, against variants of their
design, an earlier build and a composition of library calls, on the card.

    python scripts/probe_ffn_variants.py [--parent DIR] [--out chiprun_out/ffn_variants.json]

Each variant is the committed ``swift_torch/csrc`` with one change made by
text substitution in a temporary copy (no file of the repo changes), its
``ffn.cu`` and ``gemm.cu`` built alone into their own library:

* ``committed``: as shipped;
* ``hidden_3_stages``: kernel 5's pass 1 with a ring of three stages, as
  kernel 11's pass 1 has it (its fp32 g/u handover takes the fourth
  stage's room): what that stage fewer costs;
* ``pair_no_tangent``: kernel 11's pass 1 with consumer 1 forming silu(g)·u
  from its own accumulator in place of dh from consumer 0's g and u (the
  handover is still written and the barriers kept; dh and dy are wrong and
  not checked): what the tangent epilogue costs;
* ``save_3_boxes``: kernel 8's pass 1 with three output boxes a consumer,
  one each for h, g and u, and so three stages in the ring; the committed
  one cycles h, g and u through two boxes a consumer and keeps four stages.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc`` (``git
archive <commit> swift_torch/csrc | tar -x -C DIR --strip-components 2``)
that has kernels 5 and 11 as the committed build calls them and kernel 8
in ``swift_ffn`` (one WMMA pass with the g and u outputs), its ``ffn.cu``
and ``gemm.cu`` are built and timed too.

Every build but ``pair_no_tangent`` is checked at the flagship (B = 2, T =
16,384, D = 1056, H = 2816) against the plain versions, every output
within 2e-2 of max|plain|, and each variant's kernel 11 y and kernel 8 y
against its kernel 5 bit for bit. Then, in turns (the builds in order,
then in reverse): kernels 5, 8 and 11 whole, and of each variant pass 1
and pass 2 alone, and pass 2 at N = 1024 (the first 1024 of D = 1056
output columns: four whole 256-wide column tiles without the fifth, 32
wide, that N = 1056 adds); the compositions of library calls
(``F.linear``, silu·mul, ``F.linear``; for 8 with g and u kept, for 11 on
the (2T, ·) stacks) once. Each time is the median of 5 rounds of 20 calls
queued back to back between two CUDA events (the device's time); kernels
5, 8 and 11 whole also as the median of 20 single calls, CUDA events
around each (the host's cost of a call included). Prints the times and
writes them as JSON. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import COMPOSITION, time_ms  # noqa: E402
from swift_torch.ops import _build, ffn  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

VARIANTS = {
    "committed": [],
    "hidden_3_stages": [
        ("  return (kMaxSmem - ring_smem(0, 2 * hidden_boxes(mode), hidden_extra(mode)) - 256) /\n"
         "         kLinStageBytes;",
         "  return mode == kHidPlain ? 3 : (kMaxSmem - ring_smem(0, 2 * hidden_boxes(mode),\n"
         "         hidden_extra(mode)) - 256) / kLinStageBytes;"),
        ("hidden_stages(kHidPlain) >= 4", "hidden_stages(kHidPlain) >= 3"),
    ],
    "pair_no_tangent": [
        ("""            return pack_bf16x2(
                swiglu_tangent(gu[i * 128], gu[(i + 64) * 128], acc[i], acc[i + 64]),
                swiglu_tangent(gu[(i + 1) * 128], gu[(i + 65) * 128], acc[i + 1], acc[i + 65]));""",
         """            return pack_bf16x2(swiglu(acc[i], acc[i + 64]), swiglu(acc[i + 1], acc[i + 65]));"""),
    ],
    "save_3_boxes": [("constexpr int kSaveBoxes = 2;", "constexpr int kSaveBoxes = 3;")],
}
UNCHECKED = ("pair_no_tangent",)
WHOLE = ("k5", "k8", "k11")
T, D, H = 16384, 1056, 2816
TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int


def build(name: str, src: Path, subs: list) -> ctypes.CDLL:
    """``ffn.cu`` and ``gemm.cu`` of ``src`` with ``subs`` made, built into
    one library."""
    for old, new in subs:
        hits = [f for f in src.iterdir() if f.suffix in (".cu", ".cuh") and old in f.read_text()]
        if not hits:
            raise RuntimeError(f"{name}: the substitution found nothing to change: {old}")
        for f in hits:
            f.write_text(f.read_text().replace(old, new))
    lib = src / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-shared",
           str(src / "ffn.cu"), str(src / "gemm.cu"), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def calls_of(dll, t: dict, stream: int, parent: bool) -> dict:
    """Kernels 5, 8 and 11 as the wrappers run them in one chunk, and each
    pass; the parent's kernel 8 is its one ``swift_ffn`` launch."""
    dll.swift_swiglu_hidden.argtypes = [P, P, P, I, I, I, P]
    dll.swift_swiglu_hidden_pt.argtypes = [P, P, P, P, P, I, I, I, P]
    dll.swift_linear.argtypes = [P, P, P, I, I, I, P]
    dll.swift_linear_pt.argtypes = [P, P, P, P, P, I, I, I, P]
    x, dx, w1, w2, h, dh, y, dy, g, u = (t[k].data_ptr() for k in
                                         ("x", "dx", "w1", "w2", "h", "dh", "y", "dy", "g", "u"))
    calls = {
        "k5 pass 1": lambda: dll.swift_swiglu_hidden(x, w1, h, T, D, H, stream),
        "k5 pass 2": lambda: dll.swift_linear(h, w2, y, T, D, H, stream),
        # the first 1024 output columns alone: four whole 256-wide column tiles, no ragged fifth
        "k5 pass 2 N=1024": lambda: dll.swift_linear(h, w2, y, T, 1024, H, stream),
        "k11 pass 1": lambda: dll.swift_swiglu_hidden_pt(x, dx, w1, h, dh, T, D, H, stream),
        "k11 pass 2": lambda: dll.swift_linear_pt(h, dh, w2, y, dy, T, D, H, stream),
    }
    calls["k5"] = lambda: calls["k5 pass 1"]() or calls["k5 pass 2"]()
    calls["k11"] = lambda: calls["k11 pass 1"]() or calls["k11 pass 2"]()
    if parent:
        dll.swift_ffn.argtypes = [P, P, P, P, P, P, I, I, I, P]
        calls["k8"] = lambda: dll.swift_ffn(x, w1, w2, y, g, u, T, D, H, stream)
    else:
        dll.swift_swiglu_hidden_save.argtypes = [P, P, P, P, P, I, I, I, P]
        calls["k8 pass 1"] = lambda: dll.swift_swiglu_hidden_save(x, w1, h, g, u, T, D, H, stream)
        calls["k8"] = lambda: calls["k8 pass 1"]() or calls["k5 pass 2"]()
    return calls


def check(name: str, calls: dict, t: dict, want: dict, invariant: bool) -> None:
    """Each whole kernel against its plain version; kernel 11's and kernel
    8's y against kernel 5's bit for bit (where ``invariant``)."""
    outs = {"k5": ("y",), "k8": ("y", "g", "u"), "k11": ("y", "dy")}
    y5 = None
    for key in ("k5", "k11", "k8"):
        if calls[key]():
            raise RuntimeError(f"{name} {key}: launch failed")
        torch.cuda.synchronize()
        err = max((t[o].float() - r.float()).abs().max().item() / r.float().abs().max().item()
                  for o, r in zip(outs[key], want[key]))
        print(f"{name} {key}: worst rel err {err:.3e}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"{name} {key} is off its plain version: {err}")
        if key == "k5":
            y5 = t["y"].clone()
        else:
            same = torch.equal(t["y"], y5)
            print(f"{name}: {key}'s y equal to kernel 5's bit for bit: {same}", flush=True)
            if invariant and not same:
                raise AssertionError(f"{name}: {key}'s y differs from kernel 5's")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "ffn_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_ffn_variants: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, subs in VARIANTS.items():
            src = Path(tmp) / name
            shutil.copytree(_build.CSRC, src, ignore=shutil.ignore_patterns("_build"))
            jobs[name] = (src, subs)
        if args.parent:
            src = Path(tmp) / "parent"
            shutil.copytree(args.parent, src, ignore=shutil.ignore_patterns("_build"))
            jobs["parent"] = (src, [])
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(zip(jobs, pool.map(lambda n: build(n, *jobs[n]), jobs)))
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)

        def bf16(shape, scale=1.0):
            a = scale * rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(a).to("cuda", torch.bfloat16)

        t = {"x": bf16((T, D)), "dx": bf16((T, D)), "w1": bf16((2 * H, D), D ** -0.5),
             "w2": bf16((D, H), H ** -0.5)}
        t.update({k: torch.empty(T, H, device="cuda", dtype=torch.bfloat16)
                  for k in ("h", "dh", "g", "u")})
        t.update({k: torch.empty(T, D, device="cuda", dtype=torch.bfloat16) for k in ("y", "dy")})
        args5 = (t["x"], t["w1"], t["w2"])
        args11 = (t["x"], t["dx"], t["w1"], t["w2"])
        want = {"k5": (ffn.reference_swiglu_ffn(*args5),),
                "k8": ffn.reference_swiglu_ffn_fwd_save(*args5),
                "k11": ffn.reference_swiglu_ffn_pt(*args11)}
        calls = {}
        for name, dll in libs.items():
            calls[name] = calls_of(dll, t, stream, parent=name == "parent")
            if name not in UNCHECKED:
                check(name, calls[name], t, want, invariant=name != "parent")
        del want
        times: dict = {}
        for name in list(calls) + list(calls)[::-1]:
            for key, fn in calls[name].items():
                times.setdefault(f"{name} {key}", []).append(queued_ms(fn))
                if key in WHOLE:
                    times.setdefault(f"{name} {key} single", []).append(time_ms(fn))
        for key, name, a in (("k5", "swiglu_ffn", args5), ("k8", "swiglu_ffn_fwd_save", args5),
                             ("k11", "swiglu_ffn_pt", args11)):
            run = COMPOSITION[name](*a)
            times[f"composition {key}"] = [queued_ms(run)]
            times[f"composition {key} single"] = [time_ms(run)]
        print(f"T={T} D={D} H={H} (ms, queued unless single; each build twice): " + "; ".join(
            f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "T": T, "D": D, "H": H, "ms": times}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
