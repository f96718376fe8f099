"""SwiGLU feed-forward ``(silu(x·Wg) ⊙ x·Wu)·W2`` (kernel 5), the forward
that saves gate and up (kernel 8), the backward from them (kernel 9), the
backward that recomputes them (kernel 10), the primal + tangent of the
sCM jvp forward (kernel 11), the int8 FFN of the inference path
(kernel 18), and the FFN with its post-norm epilogue in one kernel
(kernel 20, :func:`fused_swiglu_ffn_modnorm`).

CUDA kernels: kernel 5, which replaces ``swift_tpu/ops/pallas_ffn.py::
_ffn_call``, runs two passes on ``csrc/wgmma.cuh``'s ring over chunks of
tokens (:func:`ffn_chunks`): ``csrc/ffn.cu::swift_swiglu_hidden`` writes h =
bf16(silu(x·Wgᵀ)·(x·Wuᵀ)), the TPU kernel's own rounding point, and
``csrc/gemm.cu::swift_linear`` (kernel 1's loop) multiplies it by W2ᵀ;
kernel 11, which replaces ``_ffn_pt_call``, runs
``csrc/ffn.cu::swift_swiglu_hidden_pt`` (h and dh with gate and up computed
once and shared) and ``swift_linear_pt`` (kernel 14's loop); kernel 8,
which replaces ``_ffn_fwd_save_call``, runs kernel 5's two passes with
``csrc/ffn.cu::swift_swiglu_hidden_save`` as pass 1, which also stores
gate and up, bf16(x·Wgᵀ) and bf16(x·Wuᵀ), beside h.
``csrc/gemm_bwd.cu::swift_ffn_bwd_saved`` replaces
``_ffn_bwd_saved_call``; kernel 10, which replaces ``_ffn_bwd_call``, runs
``csrc/gemm_bwd.cu::swift_ffn_bwd_recompute`` once for each chunk of
tokens that :func:`ffn_chunks` plans (:data:`FFN_BWD_CHUNK_TOKENS`): a
``wgmma`` + TMA pass that forms gate, up and dh = dy·W2 in fp32 for each
tile and stores only dg, du and h, in bf16 (nothing else (tokens,
hidden)-shaped reaches device memory), then kernel 9's three other
products, the weight gradients summed over the chunks in fp32
(:func:`bwd_recompute_scratch_bytes`);
``csrc/ffn_int8.cu::swift_ffn_int8`` ``fused_swiglu_ffn_int8`` (body
``_ffn_q_kernel``): over the same token chunks, x quantized per token, then
kernel 5's pass 1 on the s8 ``wgmma`` form of ``csrc/wgmma.cuh`` writing h
= g·sigmoid(g)·u in fp32 and each row's abs-max a 128-unit tile, h
quantized per token from that fp32 copy, and kernel 1's loop in s8 for
hq·W2qᵀ, rescaled to bf16 (:func:`ffn_int8_scratch_bytes`); kernel 20,
which replaces ``_ffn_mn_call``, runs kernel 5's pass 1 for h over the same
token chunks, then kernel 3 (``csrc/gemm.cu::swift_mm_modnorm``) on h and
W2 with the residual x, its y kept in fp32 inside the kernel for the
post-norm (:func:`ffn_modnorm_pieces`). Weights
are in the torch ``nn.Linear`` layout: ``w1`` (2H, D) with the gate rows
first and the up rows second (the reference chunk order), ``w2`` (D, H).

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

from swift_torch.ops import _build, jvp_guard, quant
from swift_torch.ops.linear import reference_linear, reference_linear_pt
from swift_torch.ops.modnorm import _vjp, matmul_modnorm_plan, reference_modnorm_residual

# Kernels 5, 8, 11 and 18 run their passes over chunks of at most this many
# tokens, so that a call's scratch (h, and dh for 11) stays under 1 GB at
# H = 2816: 0.74 GB for kernel 11 at the limit, 0.80 GB for 18 at 0.25°.
FFN_CHUNK_TOKENS = 65536
# Kernel 10's chunks: its scratch is 6H bytes a token (dg, du, h) beside the
# weight gradients' split partials, at most FFN_BWD_MAX_SPLITS of each, and
# their fp32 running sums (:func:`bwd_recompute_scratch_bytes`).
FFN_BWD_CHUNK_TOKENS = 32768
FFN_BWD_MAX_SPLITS = 4


def reference_swiglu_ffn(x, w1, w2):
    """Plain version of kernel 5, its two passes: h =
    :func:`reference_swiglu_hidden` (gate and up in fp32, h rounded to
    x.dtype), then h·W2ᵀ in fp32, output x.dtype."""
    return reference_linear(reference_swiglu_hidden(x, w1), w2)


def reference_swiglu_hidden(x, w1):
    """Plain version of kernel 5's first pass: h = silu(g)·u from gate and up
    accumulated in fp32, rounded to x.dtype (the TPU kernel's rounding
    point)."""
    H = w1.shape[0] // 2
    gu = torch.matmul(x.float(), w1.float().t())
    return (F.silu(gu[..., :H]) * gu[..., H:]).to(x.dtype)


def reference_swiglu_hidden_pt(x, dx, w1):
    """Plain version of kernel 11's first pass: (h, dh) with g, u, dg, du
    accumulated in fp32, h = silu(g)·u and dh = σ(g)(1 + g(1 − σ(g)))·dg·u +
    silu(g)·du rounded to x.dtype."""
    H = w1.shape[0] // 2
    w1f = w1.float().t()
    gu = torch.matmul(x.float(), w1f)
    dgu = torch.matmul(dx.float(), w1f)
    g, u, dg, du = gu[..., :H], gu[..., H:], dgu[..., :H], dgu[..., H:]
    sig = torch.sigmoid(g)
    sg = g * sig
    return (sg * u).to(x.dtype), ((sig * (1 + g * (1 - sig))) * dg * u + sg * du).to(x.dtype)


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
    """Plain version of kernel 11, its two passes: (h, dh) =
    :func:`reference_swiglu_hidden_pt`, then h·W2ᵀ and dh·W2ᵀ in fp32, as
    the TPU kernel casts h and dh before the W2 products."""
    return reference_linear_pt(*reference_swiglu_hidden_pt(x, dx, w1), w2)


def _check(name, x, w1, w2):
    """(D, H) of matching x, w1, w2 with D a multiple of 16; any H, which
    the bf16 kernels' wrappers pad (:func:`pad_hidden`)."""
    D = x.shape[-1]
    H = w2.shape[1]
    if w1.shape != (2 * H, D) or w2.shape != (D, H):
        raise ValueError(
            f"{name}: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not match D={D}"
        )
    if D % 16:
        raise ValueError(f"{name}: D={D} must be a multiple of 16")
    return D, H


def pad_hidden(w1, w2, multiple: int = 8):
    """(w1, w2) with the hidden width H zero-padded to the next multiple of
    ``multiple``: 8 is the bf16 kernels' 16-byte step along H, 16 the int8
    kernel 18's. Zero rows after the gate rows and after the up rows of w1
    (2H, D), zero columns of w2 (D, H). Exact: a padded unit has g = u = 0,
    so silu(0)·0 = 0 meets a zero column of w2. The SwiGLU width
    int(8/3·dim) is 85 at dim 32, which the JAX kernels take (their blocks
    span the whole H). Returns the weights as they are when H is a multiple
    already."""
    H = w2.shape[1]
    pad = -H % multiple
    if not pad:
        return w1, w2
    z = w1.new_zeros(pad, w1.shape[1])
    return (torch.cat([w1[:H], z, w1[H:], z]).contiguous(),
            F.pad(w2, (0, pad)).contiguous())


def _unpad_grads(dw1, dw2, H):
    """The weight gradients of :func:`pad_hidden`'s weights cut back to H."""
    Hp = dw2.shape[1]
    if Hp == H:
        return dw1, dw2
    return torch.cat([dw1[:H], dw1[Hp:Hp + H]]), dw2[:, :H].contiguous()


def ffn_chunks(T: int, limit: int | None = None) -> list[tuple[int, int]]:
    """The token ranges [start, stop) over which kernels 5, 8, 11 and 18
    (``limit`` :data:`FFN_CHUNK_TOKENS`) and 10 (:data:`FFN_BWD_CHUNK_TOKENS`)
    run their passes: [0, T) in as few pieces of at most ``limit`` as it
    takes, of one length rounded up to whole 128-token row tiles where that
    stays within the limit. One piece for the flagship (16,384 and 32,768
    tokens); at 0.25° (264,960 tokens) five of 52,992, and for kernel 10
    nine of 29,440."""
    limit = limit or FFN_CHUNK_TOKENS
    if T <= limit:
        return [(0, T)]
    pieces = -(-T // limit)  # ceil(T / limit)
    size = min(limit, -(-T // (128 * pieces)) * 128)  # ceil(T / pieces), whole tiles
    return [(s, min(s + size, T)) for s in range(0, T, size)]


def ffn_scratch_bytes(T, D, H, pair: bool) -> int:
    """Device scratch of kernel 5 or 8 (``pair`` False) or 11 for T tokens:
    h, and dh for 11, in bf16 for the longest chunk of :func:`ffn_chunks`,
    H padded as the wrappers pad it (:func:`pad_hidden`); D, the model
    width, does not enter. At 0.25° (T = 264,960, H = 2816): 0.30 GB and
    0.60 GB. Kernel 8's g and u are outputs, not scratch: its scratch is
    kernel 5's, 0.18 GB at the flagship sCM step's 32,768 tokens and 0.37
    GB at its token budget (:func:`save_max_tokens`, two chunks)."""
    rows = max(e - s for s, e in ffn_chunks(T))
    return (2 if pair else 1) * rows * (H + -H % 8) * 2


def _prepare(name, x, w1, w2, **more):
    """The CUDA wrappers' checks of bf16, contiguous, aligned inputs on one
    device and the weights' shapes; returns D and the weights with H padded
    (:func:`pad_hidden`)."""
    _build.check_kernel_inputs(name, x=x, w1=w1, w2=w2, **more)
    _build.check_dtype(name, torch.bfloat16, x=x, w1=w1, w2=w2, **more)
    D = _check(name, x, w1, w2)[0]
    return D, *pad_hidden(w1, w2)


def _two_pass(name, x, dx, w1, w2, save=False):
    """Kernel 5 (``dx`` None), 11, or with ``save`` 8, on checked CUDA
    inputs, H padded: for each chunk of :func:`ffn_chunks`, pass 1
    (``swift_swiglu_hidden``; ``swift_swiglu_hidden_pt`` for h and dh;
    ``swift_swiglu_hidden_save`` for h and the chunk's rows of g and u)
    writes h to scratch and pass 2, kernel 1's (14's) loop, multiplies it by
    W2ᵀ. Returns y, (y, dy) or (y, g, u)."""
    lib, stream = _build.library(), _build.stream()
    D, H = x.shape[-1], w2.shape[1]
    chunks = ffn_chunks(x.numel() // D)
    h = torch.empty(max(e - s for s, e in chunks), H, device=x.device, dtype=x.dtype)
    x2, y = x.view(-1, D), torch.empty_like(x)
    y2 = y.view(-1, D)
    if dx is None:
        if save:
            g, u = (torch.empty(*x.shape[:-1], H, device=x.device, dtype=x.dtype)
                    for _ in range(2))
            g2, u2 = g.view(-1, H), u.view(-1, H)
        for s, e in chunks:
            if save:
                _build.check_launch(lib.swift_swiglu_hidden_save(
                    x2[s:e].data_ptr(), w1.data_ptr(), h.data_ptr(), g2[s:e].data_ptr(),
                    u2[s:e].data_ptr(), e - s, D, H, stream), name)
            else:
                _build.check_launch(lib.swift_swiglu_hidden(
                    x2[s:e].data_ptr(), w1.data_ptr(), h.data_ptr(), e - s, D, H, stream), name)
            _build.check_launch(lib.swift_linear(
                h.data_ptr(), w2.data_ptr(), y2[s:e].data_ptr(), e - s, D, H, stream), name)
        return (y, g, u) if save else y
    dx2, dh, dy = dx.view(-1, D), torch.empty_like(h), torch.empty_like(x)
    dy2 = dy.view(-1, D)
    for s, e in chunks:
        _build.check_launch(lib.swift_swiglu_hidden_pt(
            x2[s:e].data_ptr(), dx2[s:e].data_ptr(), w1.data_ptr(), h.data_ptr(), dh.data_ptr(),
            e - s, D, H, stream), name)
        _build.check_launch(lib.swift_linear_pt(
            h.data_ptr(), dh.data_ptr(), w2.data_ptr(), y2[s:e].data_ptr(), dy2[s:e].data_ptr(),
            e - s, D, H, stream), name)
    return y, dy


def _ffn(x, w1, w2):
    """Kernel 5 alone: the plain version on the CPU."""
    jvp_guard.refuse_tangents("fused_swiglu_ffn", x=x, w1=w1, w2=w2)
    if _build.on_cpu(x, w1, w2):
        return reference_swiglu_ffn(x, w1, w2)
    _, w1, w2 = _prepare("fused_swiglu_ffn", x, w1, w2)
    y = _two_pass("fused_swiglu_ffn", x, None, w1, w2)
    fused_swiglu_ffn.launches += 1
    return y


def swiglu_ffn_fwd_save(x, w1, w2):
    """(y, g, u): the forward that saves gate and up for
    :func:`swiglu_ffn_bwd_saved`. CPU tensors take
    :func:`reference_swiglu_ffn_fwd_save`; CUDA tensors go to kernel 8
    under kernel 5's shape rules, with :func:`ffn_scratch_bytes` of scratch:
    y equals :func:`fused_swiglu_ffn`'s bit for bit, and g and u keep the
    kernels' width, H zero-padded to a multiple of 8 (:func:`pad_hidden`;
    the padded units are 0)."""
    name = "swiglu_ffn_fwd_save"
    jvp_guard.refuse_tangents(name, x=x, w1=w1, w2=w2)
    if _build.on_cpu(x, w1, w2):
        return reference_swiglu_ffn_fwd_save(x, w1, w2)
    _, w1, w2 = _prepare(name, x, w1, w2)
    out = _two_pass(name, x, None, w1, w2, save=True)
    swiglu_ffn_fwd_save.launches += 1
    return out


def swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2):
    """(dx, dw1, dw2) from the saved gate and up, as
    :func:`swiglu_ffn_fwd_save` gives them. CPU tensors take
    :func:`reference_swiglu_ffn_bwd_saved`; CUDA tensors go to kernel 9,
    bf16 and contiguous, D a multiple of 16, g and u at the kernels' width
    (H padded by :func:`pad_hidden`, the weight gradients cut back to H).

    Kernel 9 writes [dg|du] and h, bf16, to (T, 3H) of scratch (0.74 GB
    each for dg, du and h at the T = 131072 train batch, 0.18 GB at B = 2),
    and split-K fp32 partials of the two weight gradients."""
    jvp_guard.refuse_tangents("swiglu_ffn_bwd_saved", x=x, dy=dy, g=g, u=u, w1=w1, w2=w2)
    if _build.on_cpu(x, dy, g, u, w1, w2):
        return reference_swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2)
    name = "swiglu_ffn_bwd_saved"
    _build.check_kernel_inputs(name, x=x, dy=dy, g=g, u=u, w1=w1, w2=w2)
    _build.check_dtype(name, torch.bfloat16, x=x, dy=dy, g=g, u=u, w1=w1, w2=w2)
    D, H0 = _check(name, x, w1, w2)
    w1, w2 = pad_hidden(w1, w2)
    H = w2.shape[1]
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
    return (dx, *_unpad_grads(dw1, dw2, H0))


def bwd_recompute_scratch_bytes(T, D, H) -> int:
    """Device scratch of kernel 10 for T tokens, from the shapes alone, H
    padded as the wrapper pads it (:func:`pad_hidden`): dg, du and h in
    bf16 for the longest chunk of :func:`ffn_chunks` (6H bytes a token), the
    two weight gradients' fp32 split partials (:data:`FFN_BWD_MAX_SPLITS`
    of each) and, over more than one chunk, their fp32 running sums. 0.68 GB
    at 0.25° (T = 264,960, D = 1056, H = 2816), 0.42 GB at the flagship's
    B = 2 (16,384 tokens)."""
    chunks = ffn_chunks(T, FFN_BWD_CHUNK_TOKENS)
    rows = max(e - s for s, e in chunks)
    H += -H % 8
    sums = 3 * D * H * (FFN_BWD_MAX_SPLITS + (len(chunks) > 1))
    return 2 * 3 * H * rows + 4 * sums


def _bwd_recompute(lib, x, dy, w1, w2):
    """Kernel 10 on checked CUDA inputs, H padded, through ``lib``'s
    ``swift_ffn_bwd_recompute``: one call a chunk of :func:`ffn_chunks`,
    the first setting the weight gradients' running sums and the last
    rounding them. Returns (dx, dw1, dw2) at the padded width."""
    D, H = x.shape[-1], w2.shape[1]
    chunks = ffn_chunks(x.numel() // D, FFN_BWD_CHUNK_TOKENS)
    rows, dev, f32 = max(e - s for s, e in chunks), x.device, torch.float32
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    dgu = torch.empty(rows, 2 * H, device=dev, dtype=x.dtype)
    h = torch.empty(rows, H, device=dev, dtype=x.dtype)
    ws1 = torch.empty(FFN_BWD_MAX_SPLITS * 2 * H * D, device=dev, dtype=f32)
    ws2 = torch.empty(FFN_BWD_MAX_SPLITS * D * H, device=dev, dtype=f32)
    sums = len(chunks) > 1
    acc1 = torch.empty(2 * H * D if sums else 0, device=dev, dtype=f32)
    acc2 = torch.empty(D * H if sums else 0, device=dev, dtype=f32)
    x2, dy2, dx2 = x.view(-1, D), dy.view(-1, D), dx.view(-1, D)
    for k, (s, e) in enumerate(chunks):
        _build.check_launch(lib.swift_ffn_bwd_recompute(
            x2[s:e].data_ptr(), dy2[s:e].data_ptr(), w1.data_ptr(), w2.data_ptr(),
            dx2[s:e].data_ptr(), dw1.data_ptr(), dw2.data_ptr(), dgu.data_ptr(), h.data_ptr(),
            ws1.data_ptr(), ws2.data_ptr(), acc1.data_ptr(), acc2.data_ptr(), e - s, D, H,
            FFN_BWD_MAX_SPLITS, k == 0, k == len(chunks) - 1, _build.stream()),
            "swiglu_ffn_bwd_recompute")
    return dx, dw1, dw2


def swiglu_ffn_bwd_recompute(x, dy, w1, w2):
    """(dx, dw1, dw2) with gate and up recomputed from x. CPU tensors take
    :func:`reference_swiglu_ffn_bwd_recompute`; CUDA tensors go to kernel
    10, bf16 and contiguous, D a multiple of 16 (H padded, the weight
    gradients cut back to H), with :func:`bwd_recompute_scratch_bytes` of
    scratch."""
    jvp_guard.refuse_tangents("swiglu_ffn_bwd_recompute", x=x, dy=dy, w1=w1, w2=w2)
    if _build.on_cpu(x, dy, w1, w2):
        return reference_swiglu_ffn_bwd_recompute(x, dy, w1, w2)
    name = "swiglu_ffn_bwd_recompute"
    _build.check_kernel_inputs(name, x=x, dy=dy, w1=w1, w2=w2)
    _build.check_dtype(name, torch.bfloat16, x=x, dy=dy, w1=w1, w2=w2)
    H0 = _check(name, x, w1, w2)[1]
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    dx, dw1, dw2 = _bwd_recompute(_build.library(), x, dy, *pad_hidden(w1, w2))
    swiglu_ffn_bwd_recompute.launches += 1
    return (dx, *_unpad_grads(dw1, dw2, H0))


def swiglu_ffn_pt(x, dx, w1, w2):
    """(y, dy): the FFN and its tangent along dx, gate and up computed once.
    CPU tensors take :func:`reference_swiglu_ffn_pt`; CUDA tensors go to
    kernel 11 under kernel 5's shape rules, dx like x, with
    :func:`ffn_scratch_bytes` of scratch."""
    if _build.on_cpu(x, dx, w1, w2):
        return reference_swiglu_ffn_pt(x, dx, w1, w2)
    name = "swiglu_ffn_pt"
    _, w1, w2 = _prepare(name, x, w1, w2, dx=dx)
    if dx.shape != x.shape:
        raise ValueError(f"{name}: dx {tuple(dx.shape)} must match x {tuple(x.shape)}")
    y, dy = _two_pass(name, x, dx, w1, w2)
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
        return _ffn(x, w1, w2)

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
    with D % 16 == 0; any H is zero-padded to a multiple of 8 for the
    kernels (:func:`pad_hidden`). While autograd records, the forward is
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
    return _ffn(x, w1, w2)


def reference_swiglu_ffn_int8(x, w1, w2):
    """Plain version of kernel 18, the JAX package's mirror
    ``reference_swiglu_ffn_int8``: g, u = int8(x)·int8(Wg|Wu)ᵀ rescaled in
    fp32, h = g·sigmoid(g)·u in fp32 (``F.silu`` differs in the last bits),
    y = int8(h)·int8(W2)ᵀ rescaled, returned in x.dtype. The weights are
    quantized from what is passed (the model passes its fp32 parameters)."""
    H = w2.shape[1]
    g = quant.int8_matmul(x, w1[:H])
    u = quant.int8_matmul(x, w1[H:])
    h = g * torch.sigmoid(g) * u
    return quant.int8_matmul(h, w2).to(x.dtype)


def ffn_int8_scratch_bytes(T, D, H) -> int:
    """Device scratch of kernel 18 for T tokens, for the longest chunk of
    :func:`ffn_chunks`, H padded to 16 as the wrapper pads it: the fp32 h,
    hq and xq in int8, the scales sx and sh, and h's partial abs-maxima, one
    a row and 128-unit tile. 0.50 GB at the flagship's MB = 4 (32,768 tokens,
    D = 1056, H = 2816), 0.80 GB at 0.25° (52,992-token chunks)."""
    rows = max(e - s for s, e in ffn_chunks(T))
    H += -H % 16
    return rows * (4 * H + H + D + 4 + 4 + 4 * -(-H // 128))


def swiglu_ffn_int8_quantized(x, w1q, s1, w2q, s2):
    """Kernel 18 on weights quantized already, CUDA tensors only (the CPU
    route is :func:`fused_swiglu_ffn_int8`'s plain version): x (..., D) bf16; w1q
    (2H, D) and w2q (D, H) int8 with their per-row fp32 scales s1 (2H,) and
    s2 (D,), as :func:`quant.quantize_colwise` gives them, H a multiple of
    16, D of 16. For each chunk of :func:`ffn_chunks` one ``swift_ffn_int8``
    call (x quantized, pass 1, h quantized, pass 2) with
    :func:`ffn_int8_scratch_bytes` of scratch. Counts one launch of
    :func:`fused_swiglu_ffn_int8`."""
    name = "fused_swiglu_ffn_int8"
    _build.check_kernel_inputs(name, x=x, w1q=w1q, s1=s1, w2q=w2q, s2=s2)
    _build.check_dtype(name, torch.bfloat16, x=x)
    _build.check_dtype(name, torch.int8, w1q=w1q, w2q=w2q)
    _build.check_dtype(name, torch.float32, s1=s1, s2=s2)
    D, H = x.shape[-1], w2q.shape[1]
    if w1q.shape != (2 * H, D) or w2q.shape != (D, H) or s1.shape != (2 * H,) or (
            s2.shape != (D,)):
        raise ValueError(f"{name}: w1q {tuple(w1q.shape)}, w2q {tuple(w2q.shape)}, s1, s2 do "
                         f"not match D={D}, H={H}")
    if D % 16 or H % 16:
        raise ValueError(f"{name}: D={D} and H={H} must be multiples of 16")
    lib, stream = _build.library(), _build.stream()
    chunks = ffn_chunks(x.numel() // D)
    rows, dev = max(e - s for s, e in chunks), x.device
    xq = torch.empty(rows, D, device=dev, dtype=torch.int8)
    hq = torch.empty(rows, H, device=dev, dtype=torch.int8)
    h = torch.empty(rows, H, device=dev, dtype=torch.float32)
    sx, sh = (torch.empty(rows, device=dev, dtype=torch.float32) for _ in range(2))
    amax = torch.empty(rows, -(-H // 128), device=dev, dtype=torch.float32)
    x2, y = x.view(-1, D), torch.empty_like(x)
    y2 = y.view(-1, D)
    for s, e in chunks:
        _build.check_launch(lib.swift_ffn_int8(
            x2[s:e].data_ptr(), w1q.data_ptr(), s1.data_ptr(), w2q.data_ptr(), s2.data_ptr(),
            y2[s:e].data_ptr(), xq.data_ptr(), sx.data_ptr(), h.data_ptr(), amax.data_ptr(),
            hq.data_ptr(), sh.data_ptr(), e - s, D, H, stream), name)
    fused_swiglu_ffn_int8.launches += 1
    return y


def fused_swiglu_ffn_int8(x, w1, w2):
    """Dynamically quantized int8 SwiGLU FFN, inference only. x: (..., D);
    w1: (2H, D) gate rows then up rows; w2: (D, H), float (the model passes
    its fp32 parameters). Returns (..., D) in x.dtype.

    CPU tensors take :func:`reference_swiglu_ffn_int8`. CUDA tensors: H is
    zero-padded to a multiple of 16 (:func:`pad_hidden`; exact, as zero rows
    of w1 quantize to zero gate and up, and zero columns of w2 change neither
    h's per-token abs-max nor w2's per-output-feature scales), the weights
    are quantized here in PyTorch, one scale per output feature
    (:func:`quant.quantize_colwise`, as the JAX caller does outside its
    kernel), then kernel 18 (:func:`swiglu_ffn_int8_quantized`) quantizes x
    and h per token; x bf16, D a multiple of 16. Raises while autograd
    records and on dual tensors."""
    name = "fused_swiglu_ffn_int8"
    _build.refuse_autograd(name, x=x, w1=w1, w2=w2)
    if _build.on_cpu(x, w1, w2):
        return reference_swiglu_ffn_int8(x, w1, w2)
    _build.check_kernel_inputs(name, w1=w1, w2=w2)  # x: swiglu_ffn_int8_quantized's checks
    _check(name, x, w1, w2)
    w1, w2 = pad_hidden(w1, w2, 16)
    return swiglu_ffn_int8_quantized(x, *quant.quantize_colwise(w1), *quant.quantize_colwise(w2))


def reference_swiglu_ffn_modnorm(x, w1, w2, g, b, mod_scale, mod_shift, eps=1e-6):
    """Plain version of kernel 20: ``x + modnorm(SwiGLU(x))``, the TPU
    kernel's points: gate and up in fp32, h rounded to x.dtype, y = h·W2ᵀ
    kept in fp32 (never rounded), the AdaLN rows rounded to x.dtype, then
    the modnorm epilogue with var = E[y²] − E[y]² in fp32 and the residual
    x added in fp32; output x.dtype."""
    H = w2.shape[1]
    gu = torch.matmul(x.float(), w1.float().t())
    h = (F.silu(gu[..., :H]) * gu[..., H:]).to(x.dtype)
    y = torch.matmul(h.float(), w2.float().t())
    return reference_modnorm_residual(y, x, g, b, mod_scale.to(x.dtype), mod_shift.to(x.dtype),
                                      eps)


def ffn_modnorm_pieces(T: int, tps: int) -> list[tuple[tuple[int, int], list[tuple[int, int]]]]:
    """Kernel 20's launches over T tokens of samples of ``tps`` tokens: for
    each chunk [s, e) of :func:`ffn_chunks`, one launch of kernel 5's pass 1
    for its h, and one launch of kernel 3 for each piece [a, z) of it. Kernel
    3 takes the AdaLN row of token m from m // tps: a piece starts on a
    sample's first token, or lies within one sample, so that the rows from
    ``a // tps`` on serve it. One chunk and one piece at the flagship's B =
    2."""
    plan = []
    for s, e in ffn_chunks(T):
        cut = min(e, -(-s // tps) * tps)  # the first sample boundary at or after s
        pieces = [(s, cut)] if s < cut else []
        plan.append(((s, e), pieces + ([(cut, e)] if cut < e else [])))
    return plan


def _ffn_modnorm(x, w1, w2, g, b, mod_scale, mod_shift, eps):
    """The forward alone: the plain version on the CPU, else kernel 20: h =
    bf16(silu(x·Wgᵀ)·(x·Wuᵀ)) by kernel 5's pass 1 (``swift_swiglu_hidden``)
    into scratch of :func:`ffn_scratch_bytes`, then kernel 3
    (``swift_mm_modnorm``) on (h, W2) with K = H and the residual x, along
    :func:`ffn_modnorm_pieces`."""
    if _build.on_cpu(x, w1, w2, g, b, mod_scale, mod_shift):
        return reference_swiglu_ffn_modnorm(x, w1, w2, g, b, mod_scale, mod_shift, eps)
    name = "fused_swiglu_ffn_modnorm"
    mod_scale, mod_shift = mod_scale.to(x.dtype), mod_shift.to(x.dtype)
    _build.check_kernel_inputs(name, x=x, w1=w1, w2=w2, g=g, b=b, mod_scale=mod_scale,
                               mod_shift=mod_shift)
    _build.check_dtype(name, torch.bfloat16, x=x, w1=w1, w2=w2)
    _build.check_dtype(name, torch.float32, g=g, b=b)
    D = _check(name, x, w1, w2)[0]
    w1, w2 = pad_hidden(w1, w2)
    H = w2.shape[1]
    B = x.shape[0]
    if g.shape != (D,) or b.shape != (D,) or mod_scale.shape != (B, D) or (
            mod_shift.shape != (B, D)):
        raise ValueError(f"{name}: g, b must be ({D},) and mod_scale, mod_shift ({B}, {D})")
    matmul_modnorm_plan(D)  # raises past kernel 3's widest cluster plan
    lib, stream = _build.library(), _build.stream()
    M = x.numel() // D
    tps = M // B
    plan = ffn_modnorm_pieces(M, tps)
    h = torch.empty(max(e - s for (s, e), _ in plan), H, device=x.device, dtype=x.dtype)
    x2, out = x.view(-1, D), torch.empty_like(x)
    out2 = out.view(-1, D)
    for (s, e), pieces in plan:
        _build.check_launch(lib.swift_swiglu_hidden(
            x2[s:e].data_ptr(), w1.data_ptr(), h.data_ptr(), e - s, D, H, stream), name)
        for a, z in pieces:
            _build.check_launch(lib.swift_mm_modnorm(
                h[a - s].data_ptr(), w2.data_ptr(), x2[a].data_ptr(), g.data_ptr(), b.data_ptr(),
                mod_scale[a // tps].data_ptr(), mod_shift[a // tps].data_ptr(),
                out2[a].data_ptr(), z - a, H, D, tps, float(eps), stream), name)
    fused_swiglu_ffn_modnorm.launches += 1
    return out


class _SwiGLUModnorm(torch.autograd.Function):
    """Kernel 20 forward; the backward is the vjp of the plain version (the
    JAX package's ``_fused_swiglu_mn_bwd`` is a plain vjp too)."""

    @staticmethod
    def forward(x, w1, w2, g, b, mod_scale, mod_shift, eps):
        return _ffn_modnorm(x, w1, w2, g, b, mod_scale, mod_shift, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.eps = inputs[-1]
        ctx.save_for_backward(*inputs[:-1])

    @staticmethod
    def backward(ctx, dout):
        eps = ctx.eps
        fn = lambda *a: reference_swiglu_ffn_modnorm(*a, eps)  # noqa: E731
        return _vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:-1], dout) + (None,)


def fused_swiglu_ffn_modnorm(x, w1, w2, g, b, mod_scale, mod_shift, eps=1e-6):
    """``x + modnorm(SwiGLU(x))`` with the FFN output y = h·W2ᵀ never
    rounded: kernel 3 keeps it in fp32 registers and its post-norm epilogue
    reads it there. x: (B, ..., D); w1 (2H, D), w2 (D, H) as
    :func:`fused_swiglu_ffn`; g, b (D,) fp32; mod_scale, mod_shift (B, D),
    rounded to x.dtype. Returns x.dtype. No model path calls it (the JAX
    package's only caller is its test); the model runs kernels 5 and 4.

    CPU tensors take :func:`reference_swiglu_ffn_modnorm`; CUDA tensors go
    to kernel 20 (kernel 5's pass 1, then kernel 3) under kernel 5's shape
    rules (H padded by :func:`pad_hidden`) and D up to kernel 3's
    ``MATMUL_MODNORM_MAX_D`` (1728). While autograd records, the backward
    is the vjp of the plain version; a forward-mode tangent raises (the JAX
    entry has no jvp rule)."""
    args = (x, w1, w2, g, b, mod_scale, mod_shift)
    jvp_guard.refuse_tangents("fused_swiglu_ffn_modnorm", x=x, w1=w1, w2=w2, g=g, b=b,
                              mod_scale=mod_scale, mod_shift=mod_shift)
    if _build.recording(*args):
        return _SwiGLUModnorm.apply(*args, eps)
    return _ffn_modnorm(*args, eps)


fused_swiglu_ffn.launches = 0
fused_swiglu_ffn_int8.launches = 0
fused_swiglu_ffn_modnorm.launches = 0
swiglu_ffn_fwd_save.launches = 0
swiglu_ffn_bwd_saved.launches = 0
swiglu_ffn_bwd_recompute.launches = 0
swiglu_ffn_pt.launches = 0
