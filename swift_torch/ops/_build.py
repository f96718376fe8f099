"""Build and load the port's CUDA kernels, and the checks every wrapper runs.

The CUDA C++ sources under ``swift_torch/csrc`` expose a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` (one object per
source, in parallel, then linked into one shared library) into
``swift_torch/csrc/_build/`` and loaded with ``ctypes``. The library's file
name carries a hash of the sources and flags, so an edited source is
rebuilt and a finished build is reused. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from swift_torch.ops import jvp_guard

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "swift_linear": [_P, _P, _P, _I, _I, _I, _P],
    "swift_linear_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "swift_linear_pt": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "swift_mm_modnorm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "swift_mm_modnorm_plan": [_I, _P],
    "swift_modnorm_residual": [_P] * 7 + [_I] * 6 + [_F, _P],
    "swift_modnorm_residual_tangent": [_P] * 9 + [_I] * 6 + [_F, _P],
    "swift_swiglu_hidden": [_P, _P, _P, _I, _I, _I, _P],
    "swift_swiglu_hidden_pt": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "swift_swiglu_hidden_save": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "swift_ffn_bwd_saved": [_P] * 13 + [_I, _I, _I, _P],
    "swift_splitk_workspace": [_I, _I, _I],
    "swift_block_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "swift_block_attention_bwd": [_P] * 8 + [_I] * 9 + [_P],
    "swift_block_attention_tangent": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "swift_tiled_attention": [_P, _P, _P] + [_I] * 7 + [_P],
    "swift_tiled_attention_bwd": [_P] * 8 + [_I] * 7 + [_P],
    "swift_tiled_attention_tangent": [_P] * 4 + [_I] * 7 + [_P],
    "swift_ffn_bwd_recompute": [_P] * 13 + [_I] * 6 + [_P],
    "swift_ffn_int8": [_P] * 12 + [_I, _I, _I, _P],
    "swift_mm_modnorm_int8": [_P] * 11 + [_I, _I, _I, _I, _F, _P],
    "swift_mm_modnorm_int8_plan": [_I, _P],
    "swift_window_attention": [_P] * 4 + [_I] * 3 + [_P],
    "swift_window_attention_bwd": [_P] * 8 + [_I] * 3 + [_P],
    "swift_window_attention_tangent": [_P] * 7 + [_I] * 3 + [_P],
    "swift_max_smem": [],
    "swift_error_string": [_I],
}
_RESTYPES = {"swift_error_string": ctypes.c_char_p, "swift_splitk_workspace": ctypes.c_longlong}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return path


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the CUDA sources if no current build exists.

    Returns (library path, seconds spent compiling, ptxas report). The
    report lists each kernel's registers, spills and shared memory; it is
    empty when a finished build was reused."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / f"libswift_torch_{_digest(sources + headers)}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = []
        failed = []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            report.append(out)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        part = Path(tmp) / lib.name
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(part), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(part, lib)
    return lib, time.perf_counter() - t0, "".join(report)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_launch(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (the launch never ran)."""
    if code != 0:
        msg = library().swift_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}): {msg}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the wrapper then runs its
    plain PyTorch version. Anything else goes to the kernel or raises."""
    return all(t.is_cpu for t in tensors)


def check_kernel_inputs(kernel: str, **tensors: torch.Tensor) -> None:
    """Checks shared by every CUDA wrapper: one CUDA device, contiguous and
    16-byte aligned."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: all inputs must be on one CUDA device, got {devices}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def recording(*tensors: torch.Tensor) -> bool:
    """True when autograd records and an input requires grad: the wrapper
    then takes its ``torch.autograd.Function``; otherwise it launches (or
    runs the plain version of) the forward alone."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_autograd(kernel: str, **tensors: torch.Tensor) -> None:
    """The int8 kernels are inference-only, as their Pallas counterparts have
    no vjp or jvp rule: raise on a dual tensor or while autograd records."""
    jvp_guard.refuse_tangents(kernel, **tensors)
    if recording(*tensors.values()):
        raise RuntimeError(f"{kernel} is inference-only (no backward): call it under "
                           "torch.no_grad() or with inputs that do not require grad")


def check_dtype(kernel: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
