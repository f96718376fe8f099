"""The builds the kernel probes (``scripts/probe_*.py``) share: copies of
``swift_torch/csrc`` built side by side by nvcc into libraries of their own.

A probe names its variants, each the committed sources with text
substitutions ``(old, new)`` made in one file of a temporary copy (no file
of the repo changes; each ``old`` must match once). Its command line takes
``--variants A,B`` (default: all), ``--parent DIR``, a copy of an earlier
``swift_torch/csrc`` (``git archive <commit> swift_torch/csrc | tar -x -C
DIR --strip-components 2``), built as ``parent``, and ``--also NAME=DIR``
for more such copies. :func:`build_all` builds every one at once and
prints ptxas's registers and spills of the kernels the probe names.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

from swift_torch.ops import _build


def add_args(ap: argparse.ArgumentParser, variants: dict) -> None:
    """``--parent``, ``--also`` and ``--variants`` on ``ap``."""
    ap.add_argument("--parent", default=None, help="DIR: an earlier csrc to build and time")
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=DIR: another csrc copy to build, check and time")
    ap.add_argument("--variants", default=",".join(variants),
                    help="the variants to build, comma-separated")


def substitute(name: str, path: Path, subs: list) -> None:
    """Each ``(old, new)`` of ``subs`` made in ``path``; raises where
    ``old`` does not occur exactly once."""
    text = path.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the substitution does not match once: {old}")
        text = text.replace(old, new)
    path.write_text(text)


def copies(tmp: Path, args: argparse.Namespace, variants: dict, source: str) -> dict:
    """{name: directory}: under ``tmp``, the committed csrc for each variant
    of ``args.variants`` with its substitutions made in ``source``, then
    ``args.parent`` and each ``args.also``, as they are."""
    jobs = {name: (_build.CSRC, variants[name]) for name in args.variants.split(",") if name}
    if args.parent:
        jobs["parent"] = (Path(args.parent), [])
    for spec in args.also:
        name, src = spec.split("=", 1)
        jobs[name] = (Path(src), [])
    out = {}
    for name, (src, subs) in jobs.items():
        out[name] = dst = Path(tmp) / name
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("_build"))
        substitute(name, dst / source, subs)
    return out


def nvcc_library(name: str, src: Path, sources: tuple, kernels: tuple) -> ctypes.CDLL:
    """``sources`` of ``src`` built into one library with the port's nvcc
    flags; prints ptxas's registers and spills of each kernel whose name
    holds one of ``kernels`` (every kernel where ``kernels`` is empty)."""
    t0 = time.perf_counter()
    lib = src / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-shared",
           *(str(src / f) for f in sources), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    report = (res.stdout + res.stderr).splitlines()
    for i, line in enumerate(report):
        if "Compiling entry" in line and (not kernels or any(k in line for k in kernels)):
            props = " | ".join(x.split(":", 1)[-1].strip() for x in report[i + 1:i + 4]
                               if "spill" in x or "Used" in x)
            print(f"{name} {line.split(chr(39))[1]}: {props}", flush=True)
    print(f"{name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    return ctypes.CDLL(str(lib))


def build_all(tmp: Path, args: argparse.Namespace, variants: dict, source: str,
              kernels: tuple, bind: Callable[[str, ctypes.CDLL, Path], None]) -> dict:
    """{name: library}: :func:`copies`, each ``source`` built at once by
    :func:`nvcc_library` and given its argument types by ``bind(name, dll,
    directory)``."""
    srcs = copies(tmp, args, variants, source)

    def one(name):
        dll = nvcc_library(name, srcs[name], (source,), kernels)
        bind(name, dll, srcs[name])
        return dll

    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(zip(srcs, pool.map(one, srcs)))


def check_variants(variants: dict, source: str) -> None:
    """Every variant's substitutions made in a copy of the committed
    ``source``: raises, naming each, where they no longer match (no build,
    no card)."""
    errors = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / source
        for name, subs in variants.items():
            shutil.copy(_build.CSRC / source, path)
            try:
                substitute(name, path, subs)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
