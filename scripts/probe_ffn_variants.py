"""Time kernels 5 and 11, whole and by pass, against a variant of their
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
  not checked): what the tangent epilogue costs.

With ``--parent DIR``, a copy of an earlier ``swift_torch/csrc`` (``git
archive <commit> swift_torch/csrc | tar -x -C DIR --strip-components 2``)
whose ``ffn.cu`` has kernels 5 and 11 in ``swift_ffn`` and
``swift_ffn_pt``, those two are built and timed too.

Every build but ``pair_no_tangent`` is checked at the flagship (B = 2, T =
16,384, D = 1056, H = 2816) against the plain versions, every output
within 2e-2 of max|plain|, and each variant's kernel 11 y against its
kernel 5 bit for bit. Then, in
turns (the builds in order, then in reverse): kernels 5 and 11 whole, and
of each variant pass 1 and pass 2 alone, and pass 2 at N = 1024 (the first
1024 of D = 1056 output columns: four whole 256-wide column tiles without
the fifth, 32 wide, that N = 1056 adds); the composition of library calls
(``F.linear``, silu·mul, ``F.linear``; for 11 on the (2T, ·) stacks) once.
Each time is the median of 5 rounds of 20 calls queued back to back
between two CUDA events (the device's time). Prints the times and writes
them as JSON. Needs one card and nvcc.
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
from chip_smoke import COMPOSITION  # noqa: E402
from swift_torch.ops import _build, ffn  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

VARIANTS = {
    "committed": [],
    "hidden_3_stages": [
        ("constexpr int kHidStages = (kMaxSmem - ring_smem(0, 4, 0) - 256) / kLinStageBytes;",
         "constexpr int kHidStages = 3;"),
        ("kHidStages >= 4", "kHidStages >= 3"),
    ],
    "pair_no_tangent": [
        ("""            return pack_bf16x2(
                swiglu_tangent(gu[i * 128], gu[(i + 64) * 128], acc[i], acc[i + 64]),
                swiglu_tangent(gu[(i + 1) * 128], gu[(i + 65) * 128], acc[i + 1], acc[i + 65]));""",
         """            return pack_bf16x2(swiglu(acc[i], acc[i + 64]), swiglu(acc[i + 1], acc[i + 65]));"""),
    ],
}
UNCHECKED = ("pair_no_tangent",)
T, D, H = 16384, 1056, 2816
TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int


def build(name: str, src: Path, sources: tuple, subs: list) -> ctypes.CDLL:
    """``sources`` of ``src`` with ``subs`` made, built into one library."""
    for old, new in subs:
        hits = [f for f in src.iterdir() if f.suffix in (".cu", ".cuh") and old in f.read_text()]
        if not hits:
            raise RuntimeError(f"{name}: the substitution found nothing to change: {old}")
        for f in hits:
            f.write_text(f.read_text().replace(old, new))
    lib = src / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-shared",
           *(str(src / s) for s in sources), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def committed_calls(dll, t: dict, stream: int) -> dict:
    """Kernels 5 and 11 as the wrappers run them in one chunk, and each pass."""
    dll.swift_swiglu_hidden.argtypes = [P, P, P, I, I, I, P]
    dll.swift_swiglu_hidden_pt.argtypes = [P, P, P, P, P, I, I, I, P]
    dll.swift_linear.argtypes = [P, P, P, I, I, I, P]
    dll.swift_linear_pt.argtypes = [P, P, P, P, P, I, I, I, P]
    x, dx, w1, w2, h, dh, y, dy = (t[k].data_ptr() for k in
                                   ("x", "dx", "w1", "w2", "h", "dh", "y", "dy"))
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
    return calls


def parent_calls(dll, t: dict, stream: int) -> dict:
    dll.swift_ffn.argtypes = [P, P, P, P, P, P, I, I, I, P]
    dll.swift_ffn_pt.argtypes = [P, P, P, P, P, P, I, I, I, P]
    x, dx, w1, w2, y, dy = (t[k].data_ptr() for k in ("x", "dx", "w1", "w2", "y", "dy"))
    return {"k5": lambda: dll.swift_ffn(x, w1, w2, y, None, None, T, D, H, stream),
            "k11": lambda: dll.swift_ffn_pt(x, dx, w1, w2, y, dy, T, D, H, stream)}


def check(name: str, calls: dict, t: dict, want: tuple, invariant: bool) -> None:
    for key in ("k5", "k11"):
        if calls[key]():
            raise RuntimeError(f"{name} {key}: launch failed")
        torch.cuda.synchronize()
        got = (t["y"],) if key == "k5" else (t["y"], t["dy"])
        if key == "k5":
            y5 = t["y"].clone()
        refs = want[:1] if key == "k5" else want[1:]
        err = max((g.float() - r.float()).abs().max().item() / r.float().abs().max().item()
                  for g, r in zip(got, refs))
        print(f"{name} {key}: worst rel err {err:.3e}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"{name} {key} is off its plain version: {err}")
    same = torch.equal(t["y"], y5)
    print(f"{name}: kernel 11's y equal to kernel 5's bit for bit: {same}", flush=True)
    if invariant and not same:
        raise AssertionError(f"{name}: kernel 11's y differs from kernel 5's")


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
            jobs[name] = (src, ("ffn.cu", "gemm.cu"), subs)
        if args.parent:
            src = Path(tmp) / "parent"
            shutil.copytree(args.parent, src, ignore=shutil.ignore_patterns("_build"))
            jobs["parent"] = (src, ("ffn.cu",), [])
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(zip(jobs, pool.map(lambda n: build(n, *jobs[n]), jobs)))
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)

        def bf16(shape, scale=1.0):
            a = scale * rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(a).to("cuda", torch.bfloat16)

        t = {"x": bf16((T, D)), "dx": bf16((T, D)), "w1": bf16((2 * H, D), D ** -0.5),
             "w2": bf16((D, H), H ** -0.5)}
        t.update({k: torch.empty(T, H, device="cuda", dtype=torch.bfloat16) for k in ("h", "dh")})
        t.update({k: torch.empty(T, D, device="cuda", dtype=torch.bfloat16) for k in ("y", "dy")})
        want = (ffn.reference_swiglu_ffn(t["x"], t["w1"], t["w2"]),
                *ffn.reference_swiglu_ffn_pt(t["x"], t["dx"], t["w1"], t["w2"]))
        calls = {}
        for name, dll in libs.items():
            calls[name] = (parent_calls if name == "parent" else committed_calls)(dll, t, stream)
            if name not in UNCHECKED:
                check(name, calls[name], t, want, invariant=name != "parent")
        del want
        times: dict = {}
        for name in list(calls) + list(calls)[::-1]:
            for key, fn in calls[name].items():
                times.setdefault(f"{name} {key}", []).append(queued_ms(fn))
        for key, make in (("k5", lambda: COMPOSITION["swiglu_ffn"](t["x"], t["w1"], t["w2"])),
                          ("k11", lambda: COMPOSITION["swiglu_ffn_pt"](t["x"], t["dx"], t["w1"],
                                                                       t["w2"]))):
            times[f"composition {key}"] = [queued_ms(make())]
        print(f"T={T} D={D} H={H} (ms, queued; each build twice): " + "; ".join(
            f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "T": T, "D": D, "H": H, "ms": times}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
