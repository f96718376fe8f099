"""The qkv projection ``y = x @ w.T`` (kernel 1 of the SwinV2 block).

CUDA kernel: ``csrc/gemm.cu::swift_linear``, which replaces
``swift_tpu/ops/pallas_linear.py::_lin_call``. ``w`` is in the torch
``nn.Linear`` layout ``(N, K)``; the kernel reads it as it is stored.
"""

from __future__ import annotations

import torch

from swift_torch.ops import _build


def reference_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: inputs as given, fp32 accumulation, output in x.dtype."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def fused_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K); w: (N, K). Returns (..., N) in x.dtype.

    CPU tensors take :func:`reference_linear`; CUDA tensors must be bf16,
    contiguous, with K and N multiples of 8, and go to the kernel."""
    if _build.on_cpu(x, w):
        return reference_linear(x, w)
    name = "fused_linear"
    _build.check_kernel_inputs(name, x=x, w=w)
    _build.check_dtype(name, torch.bfloat16, x=x, w=w)
    K = x.shape[-1]
    N = w.shape[0]
    if w.ndim != 2 or w.shape[1] != K:
        raise ValueError(f"{name}: w must be (N, {K}), got {tuple(w.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"{name}: K={K} and N={N} must be multiples of 8")
    M = x.numel() // K
    y = torch.empty(*x.shape[:-1], N, device=x.device, dtype=x.dtype)
    lib = _build.library()
    _build.check_launch(
        lib.swift_linear(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, _build.stream()),
        name,
    )
    fused_linear.launches += 1
    return y


fused_linear.launches = 0
