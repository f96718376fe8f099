"""Time kernels 1 and 14 against variants of their design, on the card.

    python scripts/probe_linear_variants.py [--out chiprun_out/linear_variants.json]

Each variant is the committed ``swift_torch/csrc/gemm.cu`` and its headers
with one change made by text substitution in a temporary copy (no file of
the repo changes), built alone into its own library:

* ``committed``: as shipped, clusters of two blocks sharing each W box by
  TMA multicast;
* ``one_block``: clusters of one, each block loading its own whole W box
  (the design before the cluster: 48 KB a stage from L2 instead of 32);
* ``cluster_release``: the consumers' remote arrivals with release
  semantics at cluster scope (``mbarrier.arrive.release.cluster``) in place
  of the plain arrive;
* ``no_store``: the epilogue without its TMA stores (the output is not
  written, so it is not checked): what the rest of the kernel costs.

Every variant but ``no_store`` is checked against the plain version at the
flagship shapes (B = 2, T = 16,384, K = 1056, N = 3168 and 3072; within
2e-2 of max|plain|, kernel 14 equal to kernel 1 bit for bit). Then kernels 1
and 14 of each variant and ``F.linear`` (on x, and on the stack of x and dx)
are timed in turns, the variants in order and then in reverse, each as the
median of 5 rounds of 20 calls queued back to back between two CUDA events
(the device's time). Prints one line a shape and writes the times as JSON.
Needs one card and nvcc.
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
from swift_torch.ops import _build, linear  # noqa: E402

VARIANTS = {
    "committed": [],
    "one_block": [("kLinCluster = 2;", "kLinCluster = 1;")],
    "cluster_release": [("mbarrier.arrive.shared::cluster.b64",
                         "mbarrier.arrive.release.cluster.shared::cluster.b64")],
    "no_store": [("tma_store_2d(map, box, col, row);", "")],
}
SHAPES = ((16384, 3168, 1056), (16384, 3072, 1056))
TOL = 2e-2


def build(name: str, tmp: Path) -> ctypes.CDLL:
    src = tmp / name
    shutil.copytree(_build.CSRC, src, ignore=shutil.ignore_patterns("_build"))
    for path in (src / "gemm.cu", src / "wgmma.cuh"):
        text = path.read_text()
        for old, new in VARIANTS[name]:
            text = text.replace(old, new)
        path.write_text(text)
    changed = "".join((src / f).read_text() for f in ("gemm.cu", "wgmma.cuh"))
    original = "".join((_build.CSRC / f).read_text() for f in ("gemm.cu", "wgmma.cuh"))
    if (changed == original) != (not VARIANTS[name]):
        raise RuntimeError(f"{name}: the substitution found nothing to change")
    lib = src / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-shared", str(src / "gemm.cu"),
           "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.swift_linear.argtypes = [p, p, p, i, i, i, p]
    dll.swift_linear_pt.argtypes = [p, p, p, p, p, i, i, i, p]
    return dll


def queued_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the time a call over ``reps`` calls queued
    back to back between two CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "linear_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_linear_variants: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, Path(tmp)), VARIANTS)))
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        results = []
        for M, N, K in SHAPES:
            x, dx = (torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
                     .to("cuda", torch.bfloat16) for _ in range(2))
            w = torch.from_numpy(K ** -0.5 * rng.standard_normal((N, K), dtype=np.float32)).to(
                "cuda", torch.bfloat16)
            y, dy, y1, dy1 = (torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
                              for _ in range(4))
            stacked = torch.cat([x, dx])
            want, dwant = linear.reference_linear(x, w), linear.reference_linear(dx, w)
            calls = {}
            for name, dll in libs.items():
                k1 = (lambda d=dll: d.swift_linear(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                                    M, N, K, stream))
                k14 = (lambda d=dll: d.swift_linear_pt(x.data_ptr(), dx.data_ptr(), w.data_ptr(),
                                                       y.data_ptr(), dy.data_ptr(), M, N, K,
                                                       stream))
                calls[name] = (k1, k14)
                if name == "no_store":
                    continue
                codes = (dll.swift_linear(x.data_ptr(), w.data_ptr(), y1.data_ptr(), M, N, K,
                                          stream),
                         dll.swift_linear(dx.data_ptr(), w.data_ptr(), dy1.data_ptr(), M, N, K,
                                          stream),
                         k14())
                if any(codes):
                    raise RuntimeError(f"{name}: launch failed with {codes}")
                torch.cuda.synchronize()
                err = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                          for a, b in ((y, want), (dy, dwant)))
                same = torch.equal(y, y1) and torch.equal(dy, dy1)
                print(f"{name} N={N}: worst rel err {err:.3e}, kernel 14 equal to kernel 1: {same}",
                      flush=True)
                if not err <= TOL or not same:
                    raise AssertionError(f"{name} at N={N} is off its plain version or kernel 1")
            order = list(calls) + list(calls)[::-1]
            times: dict = {}
            for name in order:
                k1, k14 = calls[name]
                times.setdefault(f"{name} k1", []).append(queued_ms(k1))
                times.setdefault(f"{name} k14", []).append(queued_ms(k14))
            times["F.linear k1"] = [queued_ms(lambda: torch.nn.functional.linear(x, w))]
            times["F.linear k14"] = [queued_ms(lambda: torch.nn.functional.linear(stacked, w))]
            print(f"M={M} N={N} K={K} (ms, queued; each variant twice): " + "; ".join(
                f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()), flush=True)
            results.append({"M": M, "N": N, "K": K, "ms": times})
            del x, dx, w, y, dy, y1, dy1, stacked, want, dwant
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
