"""SwiGLU feed-forward ``(silu(x·Wg) ⊙ x·Wu)·W2`` (kernel 5), the forward
that saves gate and up (kernel 8), the backward from them (kernel 9), the
backward that recomputes them (kernel 10) and the primal + tangent of the
sCM jvp forward (kernel 11).

CUDA kernels: ``csrc/ffn.cu::swift_ffn``, which replaces
``swift_tpu/ops/pallas_ffn.py::_ffn_call`` (the (tokens, 2·hidden) gate/up
intermediate never reaches device memory) and, with its gate and up outputs
given, ``_ffn_fwd_save_call``; ``csrc/gemm_bwd.cu::swift_ffn_bwd_saved``,
which replaces ``_ffn_bwd_saved_call``; ``csrc/gemm_bwd.cu::
swift_ffn_bwd_recompute``, which replaces ``_ffn_bwd_call`` (gate and up
recomputed from x, nothing (tokens, hidden)-shaped in device memory beyond
a chunk of tokens); ``csrc/ffn.cu::swift_ffn_pt``,
which replaces ``_ffn_pt_call`` (y and dy with gate and up computed once
and shared). Weights are in the torch
``nn.Linear`` layout: ``w1`` (2H, D) with the gate rows first and the up
rows second (the reference chunk order), ``w2`` (D, H).

While autograd records, the forward saves gate and up in x.dtype and the
backward reads them, as the JAX package does up to
``SWIFT_FFN_BWD_SAVE_MAX_TOKENS`` tokens (default 131072, the 1.4° train
batch). Above it (the 0.25° grid, 264,960 tokens a sample) the forward is
kernel 5 and saves only x, and the backward is kernel 10.
"""

from __future__ import annotations

import os

import torch
from torch.autograd import forward_ad
import torch.nn.functional as F

from swift_torch.ops import _build, jvp_guard


def reference_swiglu_ffn(x, w1, w2):
    """Plain version: gate and up accumulate in fp32, h = silu(g)·u is
    rounded to x.dtype before h·W2 (fp32 accumulation); output x.dtype."""
    H = w2.shape[1]
    gu = torch.matmul(x.float(), w1.float().t())
    h = (F.silu(gu[..., :H]) * gu[..., H:]).to(x.dtype)
    return torch.matmul(h.float(), w2.float().t()).to(x.dtype)


def reference_swiglu_ffn_fwd_save(x, w1, w2):
    """Plain version of kernel 8: (y, g, u), with g = x·Wgᵀ and u = x·Wuᵀ
    rounded to x.dtype; y as :func:`reference_swiglu_ffn` (h from the
    unrounded fp32 g and u)."""
    H = w2.shape[1]
    gu = torch.matmul(x.float(), w1.float().t())
    g, u = gu[..., :H], gu[..., H:]
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.matmul(h.float(), w2.float().t()).to(x.dtype)
    return y, g.to(x.dtype), u.to(x.dtype)


def reference_swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2):
    """Plain version of kernel 9: (dx, dw1, dw2) from the saved g and u.
    dh = dy·W2 in fp32; dg, du and h = silu(g)·u rounded to x.dtype before
    the products that consume them; weight gradients summed over every
    token in fp32 and returned in the weights' dtypes."""
    return _swiglu_bwd(x, dy, g.reshape(-1, g.shape[-1]).float(),
                       u.reshape(-1, u.shape[-1]).float(), w1, w2)


def reference_swiglu_ffn_bwd_recompute(x, dy, w1, w2):
    """Plain version of kernel 10: :func:`reference_swiglu_ffn_bwd_saved`'s
    outputs with g = x·Wgᵀ and u = x·Wuᵀ recomputed in fp32 (not rounded to
    x.dtype, as the TPU kernel keeps them in VMEM)."""
    H = w2.shape[1]
    gu = torch.matmul(x.reshape(-1, x.shape[-1]).float(), w1.float().t())
    return _swiglu_bwd(x, dy, gu[:, :H], gu[:, H:], w1, w2)


def _swiglu_bwd(x, dy, g, u, w1, w2):
    """(dx, dw1, dw2) of the FFN from fp32 (T, H) gate and up."""
    D = x.shape[-1]
    x2, dy2 = x.reshape(-1, D).float(), dy.reshape(-1, D).float()
    sig = torch.sigmoid(g)
    sg = g * sig
    h = (sg * u).to(x.dtype).float()
    dh = torch.matmul(dy2, w2.float())
    dg = (dh * u * (sig * (1 + g * (1 - sig)))).to(x.dtype).float()
    du = (dh * sg).to(x.dtype).float()
    dgu = torch.cat([dg, du], dim=-1)
    dx = torch.matmul(dgu, w1.float()).to(x.dtype).reshape(x.shape)
    dw1 = torch.matmul(dgu.t(), x2).to(w1.dtype)
    dw2 = torch.matmul(dy2.t(), h).to(w2.dtype)
    return dx, dw1, dw2


def reference_swiglu_ffn_pt(x, dx, w1, w2):
    """Plain version of kernel 11: (y, dy) of the FFN at x along dx. g, u,
    dg, du accumulate in fp32; h = silu(g)·u and
    dh = σ(g)(1 + g(1 − σ(g)))·dg·u + silu(g)·du are rounded to x.dtype before
    the W2 products (fp32 accumulation), as the TPU kernel casts them."""
    H = w2.shape[1]
    w1f, w2f = w1.float().t(), w2.float().t()
    gu = torch.matmul(x.float(), w1f)
    dgu = torch.matmul(dx.float(), w1f)
    g, u, dg, du = gu[..., :H], gu[..., H:], dgu[..., :H], dgu[..., H:]
    sig = torch.sigmoid(g)
    sg = g * sig
    h = (sg * u).to(x.dtype)
    dh = ((sig * (1 + g * (1 - sig))) * dg * u + sg * du).to(x.dtype)
    return (torch.matmul(h.float(), w2f).to(x.dtype),
            torch.matmul(dh.float(), w2f).to(x.dtype))


def _check(name, x, w1, w2):
    D = x.shape[-1]
    H = w2.shape[1]
    if w1.shape != (2 * H, D) or w2.shape != (D, H):
        raise ValueError(
            f"{name}: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not match D={D}"
        )
    if D % 16 or H % 8:
        raise ValueError(f"{name}: D={D} must be a multiple of 16 and H={H} of 8")
    return D, H


def _ffn(x, w1, w2, save: bool):
    """Kernel 5, or kernel 8 when ``save`` (then returns (y, g, u))."""
    jvp_guard.refuse_tangents("swiglu_ffn_fwd_save" if save else "fused_swiglu_ffn",
                              x=x, w1=w1, w2=w2)
    if _build.on_cpu(x, w1, w2):
        if save:
            return reference_swiglu_ffn_fwd_save(x, w1, w2)
        return reference_swiglu_ffn(x, w1, w2)
    name = "swiglu_ffn_fwd_save" if save else "fused_swiglu_ffn"
    _build.check_kernel_inputs(name, x=x, w1=w1, w2=w2)
    _build.check_dtype(name, torch.bfloat16, x=x, w1=w1, w2=w2)
    D, H = _check(name, x, w1, w2)
    lib = _build.library()
    if lib.swift_ffn_smem(D) > lib.swift_max_smem():
        raise ValueError(f"{name}: D={D} needs more shared memory than a block has")
    M = x.numel() // D
    y = torch.empty_like(x)
    g = u = None
    if save:
        g = torch.empty(*x.shape[:-1], H, device=x.device, dtype=x.dtype)
        u = torch.empty_like(g)
    _build.check_launch(
        lib.swift_ffn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
                      g.data_ptr() if save else None, u.data_ptr() if save else None,
                      M, D, H, _build.stream()),
        name,
    )
    if save:
        swiglu_ffn_fwd_save.launches += 1
        return y, g, u
    fused_swiglu_ffn.launches += 1
    return y


def swiglu_ffn_fwd_save(x, w1, w2):
    """(y, g, u): the forward that saves gate and up for
    :func:`swiglu_ffn_bwd_saved`. CPU tensors take
    :func:`reference_swiglu_ffn_fwd_save`; CUDA tensors go to kernel 8."""
    return _ffn(x, w1, w2, save=True)


def swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2):
    """(dx, dw1, dw2) from the saved gate and up. CPU tensors take
    :func:`reference_swiglu_ffn_bwd_saved`; CUDA tensors go to kernel 9,
    bf16 and contiguous, D and H multiples of 8.

    Kernel 9 writes [dg|du] and h, bf16, to (T, 3H) of scratch (0.74 GB
    each for dg, du and h at the T = 131072 train batch, 0.18 GB at B = 2),
    and split-K fp32 partials of the two weight gradients."""
    jvp_guard.refuse_tangents("swiglu_ffn_bwd_saved", x=x, dy=dy, g=g, u=u, w1=w1, w2=w2)
    if _build.on_cpu(x, dy, g, u, w1, w2):
        return reference_swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2)
    name = "swiglu_ffn_bwd_saved"
    _build.check_kernel_inputs(name, x=x, dy=dy, g=g, u=u, w1=w1, w2=w2)
    _build.check_dtype(name, torch.bfloat16, x=x, dy=dy, g=g, u=u, w1=w1, w2=w2)
    D, H = _check(name, x, w1, w2)
    T = x.numel() // D
    if dy.shape != x.shape or g.numel() != T * H or u.numel() != T * H:
        raise ValueError(f"{name}: dy, g, u must be ({T}, {D}), ({T}, {H}), ({T}, {H})")
    lib = _build.library()
    dev = x.device
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    dgu = torch.empty(T, 2 * H, device=dev, dtype=x.dtype)
    h = torch.empty(T, H, device=dev, dtype=x.dtype)
    ws1 = torch.empty(lib.swift_splitk_workspace(2 * H, D, T), device=dev, dtype=torch.float32)
    ws2 = torch.empty(lib.swift_splitk_workspace(D, H, T), device=dev, dtype=torch.float32)
    _build.check_launch(
        lib.swift_ffn_bwd_saved(
            x.data_ptr(), dy.data_ptr(), g.data_ptr(), u.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), dgu.data_ptr(),
            h.data_ptr(), ws1.data_ptr(), ws2.data_ptr(), T, D, H, _build.stream(),
        ),
        name,
    )
    swiglu_ffn_bwd_saved.launches += 1
    return dx, dw1, dw2


def bwd_recompute_scratch_bytes(T, D, H) -> int:
    """Device scratch of kernel 10 for T tokens: dg, du and h in bf16 for
    one chunk of tokens, the chunk's split-K fp32 partials of the two weight
    gradients and their fp32 running sums. 0.40 GB at H = 2816, D = 1056
    for any T above the 16,384-token chunk."""
    lib = _build.library()
    c = min(T, lib.swift_ffn_bwd_chunk())
    ws = lib.swift_splitk_workspace(2 * H, D, c) + lib.swift_splitk_workspace(D, H, c)
    return 2 * 3 * H * c + 4 * (ws + 3 * D * H)


def swiglu_ffn_bwd_recompute(x, dy, w1, w2):
    """(dx, dw1, dw2) with gate and up recomputed from x. CPU tensors take
    :func:`reference_swiglu_ffn_bwd_recompute`; CUDA tensors go to kernel
    10, bf16 and contiguous, D and H multiples of 8, with
    :func:`bwd_recompute_scratch_bytes` of scratch."""
    jvp_guard.refuse_tangents("swiglu_ffn_bwd_recompute", x=x, dy=dy, w1=w1, w2=w2)
    if _build.on_cpu(x, dy, w1, w2):
        return reference_swiglu_ffn_bwd_recompute(x, dy, w1, w2)
    name = "swiglu_ffn_bwd_recompute"
    _build.check_kernel_inputs(name, x=x, dy=dy, w1=w1, w2=w2)
    _build.check_dtype(name, torch.bfloat16, x=x, dy=dy, w1=w1, w2=w2)
    D, H = _check(name, x, w1, w2)
    T = x.numel() // D
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    lib = _build.library()
    c = min(T, lib.swift_ffn_bwd_chunk())
    dev = x.device
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    dgu = torch.empty(c, 2 * H, device=dev, dtype=x.dtype)
    h = torch.empty(c, H, device=dev, dtype=x.dtype)
    ws1 = torch.empty(lib.swift_splitk_workspace(2 * H, D, c), device=dev, dtype=torch.float32)
    ws2 = torch.empty(lib.swift_splitk_workspace(D, H, c), device=dev, dtype=torch.float32)
    acc1 = torch.empty(2 * H * D, device=dev, dtype=torch.float32)
    acc2 = torch.empty(D * H, device=dev, dtype=torch.float32)
    _build.check_launch(
        lib.swift_ffn_bwd_recompute(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), w2.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), dw2.data_ptr(), dgu.data_ptr(), h.data_ptr(), ws1.data_ptr(),
            ws2.data_ptr(), acc1.data_ptr(), acc2.data_ptr(), T, D, H, _build.stream(),
        ),
        name,
    )
    swiglu_ffn_bwd_recompute.launches += 1
    return dx, dw1, dw2


def swiglu_ffn_pt(x, dx, w1, w2):
    """(y, dy): the FFN and its tangent along dx in one launch, gate and up
    computed once. CPU tensors take :func:`reference_swiglu_ffn_pt`; CUDA
    tensors go to kernel 11 under kernel 5's shape rules, dx like x.

    Kernel 11 stacks 16 rows of x over the same 16 rows of dx into one
    32-row block, so its shared-memory row block is kernel 5's (135 KB at
    D = 1056): two 32-row fp32 accumulators would need 271 KB."""
    if _build.on_cpu(x, dx, w1, w2):
        return reference_swiglu_ffn_pt(x, dx, w1, w2)
    name = "swiglu_ffn_pt"
    _build.check_kernel_inputs(name, x=x, dx=dx, w1=w1, w2=w2)
    _build.check_dtype(name, torch.bfloat16, x=x, dx=dx, w1=w1, w2=w2)
    D, H = _check(name, x, w1, w2)
    if dx.shape != x.shape:
        raise ValueError(f"{name}: dx {tuple(dx.shape)} must match x {tuple(x.shape)}")
    lib = _build.library()
    if lib.swift_ffn_smem(D) > lib.swift_max_smem():
        raise ValueError(f"{name}: D={D} needs more shared memory than a block has")
    M = x.numel() // D
    y, dy = torch.empty_like(x), torch.empty_like(x)
    _build.check_launch(
        lib.swift_ffn_pt(x.data_ptr(), dx.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
                         dy.data_ptr(), M, D, H, _build.stream()),
        name,
    )
    swiglu_ffn_pt.launches += 1
    return y, dy


def save_max_tokens() -> int:
    """Token budget of the saved-activation backward (the JAX package's
    ``_bwd_save_acts`` routing)."""
    return int(os.environ.get("SWIFT_FFN_BWD_SAVE_MAX_TOKENS", "131072"))


class _SwiGLU(torch.autograd.Function):
    """Up to :func:`save_max_tokens`: kernel 8 saves gate and up, kernel 9
    reads them."""

    @staticmethod
    def forward(x, w1, w2):
        return swiglu_ffn_fwd_save(x, w1, w2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w1, w2 = inputs
        _, g, u = output
        ctx.mark_non_differentiable(g, u)
        ctx.save_for_backward(x, g, u, w1, w2)

    @staticmethod
    def backward(ctx, dy, _dg, _du):
        x, g, u, w1, w2 = ctx.saved_tensors
        return swiglu_ffn_bwd_saved(x, dy.to(x.dtype).contiguous(), g, u, w1, w2)


class _SwiGLURecompute(torch.autograd.Function):
    """Above :func:`save_max_tokens`: kernel 5 saves nothing but x, kernel 10
    recomputes gate and up."""

    @staticmethod
    def forward(x, w1, w2):
        return _ffn(x, w1, w2, save=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2 = ctx.saved_tensors
        return swiglu_ffn_bwd_recompute(x, dy.to(x.dtype).contiguous(), w1, w2)


def fused_swiglu_ffn(x, w1, w2):
    """x: (..., D); w1: (2H, D); w2: (D, H). Returns (..., D) in x.dtype.

    CPU tensors take :func:`reference_swiglu_ffn`; CUDA tensors must be bf16
    with D % 16 == 0 and H % 8 == 0. While autograd records, the forward is
    :func:`swiglu_ffn_fwd_save` and the backward
    :func:`swiglu_ffn_bwd_saved`, or, above :func:`save_max_tokens` tokens,
    kernel 5 and :func:`swiglu_ffn_bwd_recompute`. When x carries a
    forward-mode tangent, the output is the dual of :func:`swiglu_ffn_pt`'s
    y and dy."""
    xp, dx = forward_ad.unpack_dual(x)
    if dx is not None or jvp_guard.any_tangent(w1, w2):
        jvp_guard.require_no_tangent("fused_swiglu_ffn", w1=w1, w2=w2)
        y, dy = swiglu_ffn_pt(xp, jvp_guard.materialize(dx, xp), w1, w2)
        return forward_ad.make_dual(y, dy)
    if _build.recording(x, w1, w2):
        if x.numel() // x.shape[-1] > save_max_tokens():
            return _SwiGLURecompute.apply(x, w1, w2)
        return _SwiGLU.apply(x, w1, w2)[0]
    return _ffn(x, w1, w2, save=False)


fused_swiglu_ffn.launches = 0
swiglu_ffn_fwd_save.launches = 0
swiglu_ffn_bwd_saved.launches = 0
swiglu_ffn_bwd_recompute.launches = 0
swiglu_ffn_pt.launches = 0
