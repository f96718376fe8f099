"""Native (C++) data-loader runtime of the port: ctypes bindings.

The port's own copy of the JAX package's ``swift_tpu/native``. ``loader.cpp``
is built with g++ at first use into ``swift_torch/native/_build/`` (git-
ignored) and reached through ctypes: a packed split (one mmap-able float32
(N, H, W, C) tensor behind a 4 KiB header, written by
``swift_torch.native.pack``) is gathered and turned into standardized
residual batches by a C++ thread pool. A failed build raises with g++'s
own error: the packed route has no second reader.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).parent
_LIB_PATH = _HERE / "_build" / "libswift_loader.so"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_THREADS = os.cpu_count() or 1  # the C++ pool's workers for one batch

HEADER_BYTES = 4096
MAGIC = b"SWIFTPK1"


def _build_lib() -> ctypes.CDLL:
    src = _HERE / "loader.cpp"
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= src.stat().st_mtime:
        return ctypes.CDLL(str(_LIB_PATH))
    _LIB_PATH.parent.mkdir(exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.so")  # concurrent builds never share a file
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(src),
           "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}:\n{res.stderr}")
    os.replace(tmp, _LIB_PATH)
    return ctypes.CDLL(str(_LIB_PATH))


def _get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = _build_lib()
            c_long_p = ctypes.POINTER(ctypes.c_long)
            c_float_p = ctypes.POINTER(ctypes.c_float)
            lib.stl_open.restype = ctypes.c_void_p
            lib.stl_open.argtypes = [ctypes.c_char_p, c_long_p]
            lib.stl_close.argtypes = [ctypes.c_void_p]
            lib.stl_batch.restype = ctypes.c_int
            lib.stl_batch.argtypes = [
                ctypes.c_void_p, c_long_p, c_long_p, c_long_p, ctypes.c_long,
                c_float_p, c_float_p, c_float_p, ctypes.c_long, ctypes.c_long,
                c_float_p, c_float_p, ctypes.c_long,
            ]
            _LIB = lib
    return _LIB


def _lp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class PackedDataset:
    """A packed split, mmap'ed by the native library."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lib = _get_lib()
        shape = (ctypes.c_long * 4)()
        h = self._lib.stl_open(self.path.encode(), shape)
        if not h:
            raise ValueError(f"cannot open {path} as a swift pack file")
        self._handle = ctypes.c_void_p(h)
        self.shape = tuple(int(s) for s in shape)

    def batch(self, idx: np.ndarray, tgt: np.ndarray, prev: np.ndarray, x_mean: np.ndarray,
              x_std: np.ndarray, t_std: np.ndarray, n_vars: int) -> tuple[np.ndarray, np.ndarray]:
        """(x, t): x = (pack[idx] − x_mean) / x_std over every channel, t =
        (pack[tgt] − pack[prev]) / t_std over the first ``n_vars``."""
        N, (H, W, C) = len(idx), self.shape[1:]
        idx, tgt, prev = (np.ascontiguousarray(a, np.int64) for a in (idx, tgt, prev))
        for a in (idx, tgt, prev):
            if a.size and (a.min() < 0 or a.max() >= self.shape[0]):
                raise IndexError(f"rows {a} outside the {self.shape[0]} of {self.path}")
        x_mean, x_std, t_std = (np.ascontiguousarray(a, np.float32).reshape(-1)
                                for a in (x_mean, x_std, t_std))
        x_out = np.empty((N, H, W, C), np.float32)
        t_out = np.empty((N, H, W, n_vars), np.float32)
        if self._lib.stl_batch(self._handle, _lp(idx), _lp(tgt), _lp(prev), N, _fp(x_mean),
                               _fp(x_std), _fp(t_std), n_vars, C, _fp(x_out), _fp(t_out),
                               _THREADS) != 0:
            raise RuntimeError(f"stl_batch failed ({C} channels in {self.path})")
        return x_out, t_out

    def close(self):
        if self._handle is not None:
            self._lib.stl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
