"""The qkv projection ``y = x @ w.T`` (kernel 1), its backward (kernel 13)
and its primal + tangent (kernel 14).

CUDA kernels: ``csrc/gemm.cu::swift_linear``, which replaces
``swift_tpu/ops/pallas_linear.py::_lin_call``,
``csrc/gemm_bwd.cu::swift_linear_bwd``, which replaces ``_lin_bwd_call``
(dx = dy·W, and dW = dyᵀ·x summed over every token in fp32 and rounded to
the weight's dtype), and ``csrc/gemm.cu::swift_linear_pt``, which replaces
``_lin_pt_call`` (x·Wᵀ and dx·Wᵀ against one staged W tile, for the sCM
jvp forward). ``w`` is in the torch ``nn.Linear`` layout ``(N, K)``; the
kernels read it as it is stored and return dW in that layout.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from swift_torch.ops import _build, jvp_guard


def reference_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: inputs as given, fp32 accumulation, output in x.dtype."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def reference_linear_bwd(dy, x, w):
    """Plain version of kernel 13. dy: (..., N); x: (..., K); w: (N, K).
    Returns (dx in x.dtype, dw in w.dtype), both from fp32 sums."""
    dy2 = dy.reshape(-1, dy.shape[-1]).float()
    x2 = x.reshape(-1, x.shape[-1]).float()
    dx = torch.matmul(dy2, w.float()).to(x.dtype).reshape(x.shape)
    dw = torch.matmul(dy2.t(), x2).to(w.dtype)
    return dx, dw


def reference_linear_pt(x, dx, w):
    """Plain version of kernel 14: (x·wᵀ, dx·wᵀ), each as :func:`reference_linear`."""
    return reference_linear(x, w), reference_linear(dx, w)


def _check_shapes(name, x, w):
    K = x.shape[-1]
    N = w.shape[0]
    if w.ndim != 2 or w.shape[1] != K:
        raise ValueError(f"{name}: w must be (N, {K}), got {tuple(w.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"{name}: K={K} and N={N} must be multiples of 8")
    return N, K


def _linear(x, w):
    """The forward alone: the plain version on the CPU, else kernel 1."""
    if _build.on_cpu(x, w):
        return reference_linear(x, w)
    name = "fused_linear"
    _build.check_kernel_inputs(name, x=x, w=w)
    _build.check_dtype(name, torch.bfloat16, x=x, w=w)
    N, K = _check_shapes(name, x, w)
    M = x.numel() // K
    y = torch.empty(*x.shape[:-1], N, device=x.device, dtype=x.dtype)
    lib = _build.library()
    _build.check_launch(
        lib.swift_linear(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, _build.stream()),
        name,
    )
    fused_linear.launches += 1
    return y


def fused_linear_bwd(dy, x, w):
    """(dx, dw) of ``y = x @ w.T``. CPU tensors take
    :func:`reference_linear_bwd`; CUDA tensors must be bf16 and contiguous,
    with K and N multiples of 8, and go to kernel 13."""
    jvp_guard.refuse_tangents("fused_linear_bwd", dy=dy, x=x, w=w)
    if _build.on_cpu(dy, x, w):
        return reference_linear_bwd(dy, x, w)
    name = "fused_linear_bwd"
    _build.check_kernel_inputs(name, dy=dy, x=x, w=w)
    _build.check_dtype(name, torch.bfloat16, dy=dy, x=x, w=w)
    N, K = _check_shapes(name, x, w)
    T = x.numel() // K
    if dy.shape[-1] != N or dy.numel() != T * N:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must hold ({T}, {N})")
    lib = _build.library()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    ws = torch.empty(lib.swift_splitk_workspace(N, K, T), device=x.device, dtype=torch.float32)
    _build.check_launch(
        lib.swift_linear_bwd(dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
                             dw.data_ptr(), ws.data_ptr(), T, N, K, _build.stream()),
        name,
    )
    fused_linear_bwd.launches += 1
    return dx, dw


def linear_pt(x, dx, w):
    """(x·wᵀ, dx·wᵀ): the primal and the tangent of the projection in one
    launch. CPU tensors take :func:`reference_linear_pt`; CUDA tensors must
    be bf16 and contiguous with x and dx of one shape, K and N multiples of
    8, and go to kernel 14."""
    if _build.on_cpu(x, dx, w):
        return reference_linear_pt(x, dx, w)
    name = "linear_pt"
    _build.check_kernel_inputs(name, x=x, dx=dx, w=w)
    _build.check_dtype(name, torch.bfloat16, x=x, dx=dx, w=w)
    N, K = _check_shapes(name, x, w)
    if dx.shape != x.shape:
        raise ValueError(f"{name}: dx {tuple(dx.shape)} must match x {tuple(x.shape)}")
    M = x.numel() // K
    y = torch.empty(*x.shape[:-1], N, device=x.device, dtype=x.dtype)
    dy = torch.empty_like(y)
    lib = _build.library()
    _build.check_launch(
        lib.swift_linear_pt(x.data_ptr(), dx.data_ptr(), w.data_ptr(), y.data_ptr(),
                            dy.data_ptr(), M, N, K, _build.stream()),
        name,
    )
    linear_pt.launches += 1
    return y, dy


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(x, w):
        return _linear(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return fused_linear_bwd(dy.to(x.dtype).contiguous(), x, w)


def fused_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K); w: (N, K). Returns (..., N) in x.dtype.

    CPU tensors take :func:`reference_linear`; CUDA tensors must be bf16,
    contiguous, with K and N multiples of 8, and go to the kernel. While
    autograd records, the backward is :func:`fused_linear_bwd`. When x
    carries a forward-mode tangent, the output is the dual of
    :func:`linear_pt`'s primal and tangent."""
    xp, dx = forward_ad.unpack_dual(x)
    if dx is not None or jvp_guard.any_tangent(w):
        jvp_guard.require_no_tangent("fused_linear", w=w)
        y, dy = linear_pt(xp, jvp_guard.materialize(dx, xp), w)
        return forward_ad.make_dual(y, dy)
    if _build.recording(x, w):
        return _Linear.apply(x, w)
    return _linear(x, w)


fused_linear.launches = 0
fused_linear_bwd.launches = 0
linear_pt.launches = 0
