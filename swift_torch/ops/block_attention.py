"""Shifted-window cosine attention from the qkv layout (kernel 2), its
backward (kernel 6) and its forward-mode tangent (kernel 7); the
window-tiled variant for large grids (kernels 15, 16 and 17); the JAX
model's routing between them.

CUDA kernels: ``csrc/block_attention.cu::swift_block_attention``, which
replaces ``swift_tpu/ops/pallas_block_attention.py::_fwd_call``, and
``swift_block_attention_bwd``, which replaces ``_bwd_call`` (the softmax
recomputed, dqkv in the [q|k|v] interleave, and the gradient of the logit
scale), and ``swift_block_attention_tangent``, which replaces
``_tangent_call`` (the normalise, softmax and p·v tangents of the sCM jvp
forward; the logit scale carries none). Input is the qkv projection in its
natural ``(B, gh, gw, heads·3·d)`` layout with the per-head [q|k|v]
interleave; output is ``(B, gh, gw, heads·d)``.

``csrc/block_attention.cu::swift_tiled_attention``, ``_bwd`` and
``_tangent`` replace ``_tiled_fwd_call``, ``_tiled_bwd_call`` and
``_tiled_tangent_call``: the same functions on qkv rolled by the window
shift before the call (``fused_tiled_block_attention`` rolls with
``torch.roll``; the JAX package's DUS roll with a custom transpose is a TPU
memory workaround), so that no window wraps, for grids the whole-grid TPU
kernel cannot hold (0.25°: 368×720 tokens). The backward of both (kernels 6
and 16) is a query pass, which writes dq and each query row's softmax
statistics, and a key pass, which sums dk̂ and dv in registers from them.

:func:`per_head_window_attention` is the JAX model's per-head path: the
shift, window partition and head split in PyTorch around the
per-(window, head) kernels 21, 22b and 22t
(``swift_torch.ops.window_attention``), for the geometries neither gate
admits and for those the fixed-window kernels above cannot hold
(:func:`attention_route`).
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from swift_torch.ops import _build, jvp_guard
from swift_torch.ops.window_attention import fused_window_attention
from swift_torch.ops.windows import cyclic_shift, window_partition, window_reverse

_EPS = 1e-12


def _padded_dim(d: int) -> int:
    """The JAX kernels' head width, d padded to a multiple of 128."""
    return d if d % 128 == 0 else (d // 128 + 1) * 128


def block_attention_eligible(grid_size, window_size, shift, heads: int, dim_inner: int) -> bool:
    """The JAX package's gate of the whole-grid kernel
    (``pallas_block_attention.py::block_attention_eligible``): windows that
    tile the grid, 8-aligned window columns and width shift, at most 1024
    tokens a window, and a (gh, gw, padded d) fp32 tile within 24 MB."""
    gh, gw = grid_size
    wh, ww = window_size
    sh, sw = shift
    d, rem = divmod(dim_inner, heads)
    if rem or gh % wh or gw % ww:
        return False
    if gw // ww > 1 and ww % 8:
        return False
    if sw and sw % 8:
        return False
    return wh * ww <= 1024 and gh * gw * _padded_dim(d) * 4 <= 24 * 1024 * 1024


def tiled_block_attention_eligible(grid_size, window_size, heads: int, dim_inner: int) -> bool:
    """The JAX package's gate of the window-tiled kernel
    (``tiled_block_attention_eligible``): no shift rule (the roll takes
    any), one bf16 window row of q/k/v/out double-buffered within 48 MB."""
    gh, gw = grid_size
    wh, ww = window_size
    d, rem = divmod(dim_inner, heads)
    if rem or gh % wh or gw % ww:
        return False
    if gw // ww > 1 and ww % 8:
        return False
    return wh * ww <= 1024 and 8 * wh * gw * _padded_dim(d) * 2 <= 48 * 1024 * 1024


def fixed_window_kernels_accept(window_size, heads: int, dim_inner: int) -> bool:
    """Whether the port's fixed-window kernels (2, 6, 7 and 15, 16, 17) take
    this geometry: 256 tokens a window and a head width d that is a multiple
    of 8 no larger than 128. Their wrappers refuse anything else.

    This is where the port departs from the JAX route. The JAX gates admit
    windows of up to 1024 tokens and any head width, because the TPU
    kernels hold a whole window in VMEM at any such size; the Hopper kernels
    are built for the 256-token window (a 64×256 fp32 logit tile in shared
    memory) and at most 128 padded head lanes. :func:`attention_route`
    sends such geometries to the per-head kernels 21 and 22 instead, which
    compute the same function (the JAX model's per-head path), so parity
    with the JAX model holds on either route."""
    d, rem = divmod(dim_inner, heads)
    wh, ww = window_size
    return not rem and wh * ww == 256 and d % 8 == 0 and d <= 128


def attention_route(grid_size, window_size, shift, heads: int, dim_inner: int) -> str:
    """The JAX model's attention route (``swinv2.py:367-383``): "block" (the
    whole-grid kernels 2, 6, 7) when its gate passes, else "tiled" (15, 16,
    17), else "per_head" (the per-(window, head) kernels 21 and 22, see
    :func:`per_head_window_attention`); and "per_head" also where a gate
    passes but :func:`fixed_window_kernels_accept` does not. A static
    choice on shapes, made before any launch."""
    if not fixed_window_kernels_accept(window_size, heads, dim_inner):
        return "per_head"
    if block_attention_eligible(grid_size, window_size, shift, heads, dim_inner):
        return "block"
    if tiled_block_attention_eligible(grid_size, window_size, heads, dim_inner):
        return "tiled"
    return "per_head"


def _l2_normalize(a: torch.Tensor) -> torch.Tensor:
    return a * torch.rsqrt(torch.sum(a * a, -1, keepdim=True) + _EPS)


def _windows(t, heads, window_size, shift):
    """(B, gh, gw, heads·c) -> (B, nW, n, heads, c), rolled by -shift."""
    B = t.shape[0]
    x = window_partition(cyclic_shift(t, (-shift[0], -shift[1])), window_size)
    return x.reshape(B, x.shape[1], x.shape[2], heads, -1)


def _unwindows(t, window_size, grid, shift):
    """Inverse of :func:`_windows`."""
    B, nW, n = t.shape[:3]
    x = window_reverse(t.reshape(B, nW, n, -1), window_size, grid)
    return cyclic_shift(x, shift)


def reference_block_attention(qkv, scale, heads, window_size, shift=(0, 0)):
    """Plain version: explicit roll, window partition and head split.

    q, k are L2-normalised in fp32 and rounded to qkv.dtype (q after the
    logit scale), the logits and p·v accumulate in fp32, the softmax runs in
    fp32 and p is rounded to qkv.dtype before p·v."""
    B, gh, gw, feat = qkv.shape
    d = feat // (3 * heads)
    mm = qkv.dtype
    q, k, v = _windows(qkv, heads, window_size, shift).split(d, dim=-1)
    qn = _l2_normalize(q.float()) * scale.float()[:, None]
    kn = _l2_normalize(k.float())
    s = torch.einsum("bwnhd,bwmhd->bwhnm", qn.to(mm).float(), kn.to(mm).float())
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bwhnm,bwmhd->bwnhd", p.to(mm).float(), v.float())
    return _unwindows(o.to(mm), window_size, (gh, gw), shift)


def reference_block_attention_bwd(qkv, scale, dout, heads, window_size, shift=(0, 0)):
    """Plain version of kernel 6: (dqkv in qkv.dtype, dscale (heads,) in
    scale.dtype). The TPU kernel's formulas: q̂s, k̂, p and dS rounded to
    qkv.dtype before the products that consume them, everything else fp32."""
    B, gh, gw, feat = qkv.shape
    d = feat // (3 * heads)
    mm = qkv.dtype
    q, k, v = _windows(qkv, heads, window_size, shift).split(d, dim=-1)
    do = _windows(dout, heads, window_size, shift).float()
    s = scale.float()
    qf, kf = q.float(), k.float()
    rq = torch.rsqrt(torch.sum(qf * qf, -1, keepdim=True) + _EPS)
    rk = torch.rsqrt(torch.sum(kf * kf, -1, keepdim=True) + _EPS)
    qh, kh = qf * rq, kf * rk
    qn = qh * s[:, None]
    r = lambda a: a.to(mm).float()  # noqa: E731  (a rounding point)
    logits = torch.einsum("bwnhd,bwmhd->bwhnm", r(qn), r(kh))
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bwhnm,bwnhd->bwmhd", r(p), r(do))
    dp = torch.einsum("bwnhd,bwmhd->bwhnm", r(do), r(v.float()))
    dS = p * (dp - torch.sum(p * dp, -1, keepdim=True))
    dscale = torch.sum(dS * logits, dim=(0, 1, 3, 4)) / s
    dqn = torch.einsum("bwhnm,bwmhd->bwnhd", r(dS), r(kh))
    dkh = torch.einsum("bwhnm,bwnhd->bwmhd", r(dS), r(qn))
    dqh = dqn * s[:, None]
    dqf = (dqh - qh * torch.sum(dqh * qh, -1, keepdim=True)) * rq
    dkf = (dkh - kh * torch.sum(dkh * kh, -1, keepdim=True)) * rk
    tile = torch.cat([dqf.to(mm), dkf.to(mm), dv.to(mm)], dim=-1)
    return _unwindows(tile, window_size, (gh, gw), shift), dscale.to(scale.dtype)


def reference_block_attention_tangent(qkv, dqkv, scale, heads, window_size, shift=(0, 0)):
    """Plain version of kernel 7: the tangent of
    :func:`reference_block_attention` at qkv along dqkv (the scale fixed).
    The TPU kernel's formulas: dq̂ = (dq − q̂(q̂·dq))/|q| and dk̂ likewise,
    dS = s·dq̂·k̂ᵀ + s·q̂·dk̂ᵀ, dp = p(dS − Σ p dS), dout = dp·v + p·dv, with
    q̂s, dq̂s, k̂, dk̂, p and dp rounded to qkv.dtype before the products that
    consume them and everything else fp32."""
    B, gh, gw, feat = qkv.shape
    d = feat // (3 * heads)
    mm = qkv.dtype
    q, k, v = _windows(qkv, heads, window_size, shift).split(d, dim=-1)
    dq, dk, dv = _windows(dqkv, heads, window_size, shift).split(d, dim=-1)
    s = scale.float()[:, None]

    def normalised(a, da):
        af, daf = a.float(), da.float()
        ra = torch.rsqrt(torch.sum(af * af, -1, keepdim=True) + _EPS)
        ah = af * ra
        return ah, (daf - ah * torch.sum(ah * daf, -1, keepdim=True)) * ra

    qh, dqh = normalised(q, dq)
    kh, dkh = normalised(k, dk)
    r = lambda a: a.to(mm).float()  # noqa: E731  (a rounding point)
    qk = lambda a, b: torch.einsum("bwnhd,bwmhd->bwhnm", r(a), r(b))  # noqa: E731
    pv = lambda a, b: torch.einsum("bwhnm,bwmhd->bwnhd", r(a), r(b))  # noqa: E731
    p = torch.softmax(qk(qh * s, kh), dim=-1)
    dS = qk(dqh * s, kh) + qk(qh * s, dkh)
    dp = p * (dS - torch.sum(p * dS, -1, keepdim=True))
    o = pv(dp, v) + pv(p, dv)
    return _unwindows(o.to(mm), window_size, (gh, gw), shift)


def _check(name, qkv, scale, heads, window_size):
    _build.check_dtype(name, torch.bfloat16, qkv=qkv)
    _build.check_dtype(name, torch.float32, scale=scale)
    B, gh, gw, feat = qkv.shape
    wh, ww = window_size
    d = feat // (3 * heads)
    if feat % (3 * heads) or not fixed_window_kernels_accept(window_size, heads, feat // 3):
        raise ValueError(f"{name}: windows {window_size} must hold 256 tokens and the head dim "
                         f"{feat}/(3·{heads}) be a multiple of 8 ≤ 128")
    if gh % wh or gw % ww:
        raise ValueError(f"{name}: windows {window_size} must tile {(gh, gw)}")
    if scale.shape != (heads,):
        raise ValueError(f"{name}: scale must be ({heads},), got {tuple(scale.shape)}")
    return B, gh, gw, d


def _block_attention(qkv, scale, heads, window_size, shift):
    """The forward alone: the plain version on the CPU, else kernel 2."""
    if _build.on_cpu(qkv, scale):
        return reference_block_attention(qkv, scale, heads, window_size, shift)
    name = "fused_block_attention"
    _build.check_kernel_inputs(name, qkv=qkv, scale=scale)
    B, gh, gw, d = _check(name, qkv, scale, heads, window_size)
    wh, ww = window_size
    sh, sw = shift[0] % gh, shift[1] % gw
    out = torch.empty(B, gh, gw, heads * d, device=qkv.device, dtype=qkv.dtype)
    lib = _build.library()
    _build.check_launch(
        lib.swift_block_attention(
            qkv.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, gh, gw, heads, d, wh, ww, sh, sw, _build.stream(),
        ),
        name,
    )
    fused_block_attention.launches += 1
    return out


# The scale's partials the backward kernels write a window and head: one a
# 64-row query block and consumer of the query pass (``kAttnBwdPartials`` in
# ``csrc/block_attention.cu``).
_BWD_PARTIALS = 8


def _bwd_stage_bytes(d: int) -> int:
    """q̂s of one 64-row query block as the query pass's stage holds it and
    hands it to the key pass: 64-column boxes of 128-byte rows, d padded to
    32 (``AttnBwdQ<dp>::QS``)."""
    return (1 if d <= 64 else 2) * 64 * 128


def attention_bwd_scratch_bytes(B, gh, gw, heads, d, window_size) -> int:
    """Device scratch of kernels 6 and 16: each query block's q̂s as the
    query pass's stage holds it, which the key pass reads in place of
    gathering and normalising q, each query row's softmax statistics (max,
    1/sum and Σ p·dp: 3 fp32), and the fp32 partials of the logit scale's
    gradient: 268.125 bytes a query row and head at 64 < d ≤ 128 (140.125
    below), against the 6·d bytes of its qkv. 0.57 GB at 0.25° (B = 1,
    368×720, 8×128; 1.63 GB of qkv), 52.7 MB at the flagship B = 2 (12×88;
    104 MB of qkv)."""
    n = B * heads * (gh // window_size[0]) * (gw // window_size[1])
    return n * (4 * _bwd_stage_bytes(d) + 4 * (3 * 256 + _BWD_PARTIALS))


def _attention_bwd(entry, name, qkv, scale, dout, heads, window_size, *shift):
    """Checks, scratch and the launch of kernel 6 (``shift`` given) or 16
    through the library's ``entry``."""
    _build.check_kernel_inputs(name, qkv=qkv, scale=scale, dout=dout)
    B, gh, gw, d = _check(name, qkv, scale, heads, window_size)
    _build.check_dtype(name, torch.bfloat16, dout=dout)
    if dout.shape != (B, gh, gw, heads * d):
        raise ValueError(f"{name}: dout must be {(B, gh, gw, heads * d)}, got {tuple(dout.shape)}")
    wh, ww = window_size
    n = B * heads * (gh // wh) * (gw // ww)
    scratch = torch.empty(attention_bwd_scratch_bytes(B, gh, gw, heads, d, window_size),
                          device=qkv.device, dtype=torch.uint8)
    stats = 4 * _bwd_stage_bytes(d) * n  # byte offsets: the stages, the statistics, the partials
    partials = stats + 4 * 3 * 256 * n
    dqkv = torch.empty_like(qkv)
    dscale = torch.empty_like(scale)
    base = scratch.data_ptr()
    _build.check_launch(
        getattr(_build.library(), entry)(
            qkv.data_ptr(), scale.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            dscale.data_ptr(), base + stats, base + partials, base,
            B, gh, gw, heads, d, wh, ww, *shift, _build.stream()),
        name,
    )
    return dqkv, dscale


def block_attention_bwd(qkv, scale, dout, heads, window_size, shift=(0, 0)):
    """(dqkv, dscale) of :func:`fused_block_attention`. CPU tensors take
    :func:`reference_block_attention_bwd`; CUDA tensors go to kernel 6 under
    the forward's shape rules (dout bf16, contiguous, (B, gh, gw, heads·d)),
    with :func:`attention_bwd_scratch_bytes` of scratch."""
    jvp_guard.refuse_tangents("block_attention_bwd", qkv=qkv, scale=scale, dout=dout)
    if _build.on_cpu(qkv, scale, dout):
        return reference_block_attention_bwd(qkv, scale, dout, heads, window_size, shift)
    gh, gw = qkv.shape[1:3]
    out = _attention_bwd("swift_block_attention_bwd", "block_attention_bwd", qkv, scale, dout,
                         heads, window_size, shift[0] % gh, shift[1] % gw)
    block_attention_bwd.launches += 1
    return out


def block_attention_tangent(qkv, dqkv, scale, heads, window_size, shift=(0, 0)):
    """The tangent of :func:`fused_block_attention` at qkv along dqkv,
    (B, gh, gw, heads·d) in qkv.dtype. CPU tensors take
    :func:`reference_block_attention_tangent`; CUDA tensors go to kernel 7
    under the forward's shape rules, dqkv bf16 and shaped like qkv."""
    if _build.on_cpu(qkv, dqkv, scale):
        return reference_block_attention_tangent(qkv, dqkv, scale, heads, window_size, shift)
    name = "block_attention_tangent"
    _build.check_kernel_inputs(name, qkv=qkv, dqkv=dqkv, scale=scale)
    B, gh, gw, d = _check(name, qkv, scale, heads, window_size)
    _build.check_dtype(name, torch.bfloat16, dqkv=dqkv)
    if dqkv.shape != qkv.shape:
        raise ValueError(f"{name}: dqkv {tuple(dqkv.shape)} must match qkv {tuple(qkv.shape)}")
    wh, ww = window_size
    sh, sw = shift[0] % gh, shift[1] % gw
    out = torch.empty(B, gh, gw, heads * d, device=qkv.device, dtype=qkv.dtype)
    _build.check_launch(
        _build.library().swift_block_attention_tangent(
            qkv.data_ptr(), dqkv.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, gh, gw, heads, d, wh, ww, sh, sw, _build.stream(),
        ),
        name,
    )
    block_attention_tangent.launches += 1
    return out


class _BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(qkv, scale, heads, window_size, shift):
        return _block_attention(qkv, scale, heads, window_size, shift)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qkv, scale, ctx.heads, ctx.window_size, ctx.shift = inputs
        ctx.save_for_backward(qkv, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, scale = ctx.saved_tensors
        dqkv, dscale = block_attention_bwd(qkv, scale, dout.to(qkv.dtype).contiguous(),
                                           ctx.heads, ctx.window_size, ctx.shift)
        return dqkv, dscale, None, None, None


def fused_block_attention(qkv, scale, heads, window_size, shift=(0, 0)):
    """qkv: (B, gh, gw, heads·3·d); scale: (heads,) fp32, the exp'ed and
    clamped logit scale; window_size (wh, ww); shift (sh, sw) is a cyclic
    roll of (-sh, -sw) before windowing, undone on the output.

    CPU tensors take :func:`reference_block_attention`. CUDA tensors must be
    bf16 with wh·ww = 256 tokens a window, windows that tile the grid, and
    d a multiple of 8 no larger than 128. While autograd records, the
    backward is :func:`block_attention_bwd`. When qkv carries a
    forward-mode tangent, the output is the dual of kernel 2's primal and
    :func:`block_attention_tangent`."""
    window_size, shift = tuple(window_size), tuple(shift)
    qp, dqkv = forward_ad.unpack_dual(qkv)
    if dqkv is not None or jvp_guard.any_tangent(scale):
        jvp_guard.require_no_tangent("fused_block_attention", scale=scale)
        out = _block_attention(qp, scale, heads, window_size, shift)
        dout = block_attention_tangent(qp, jvp_guard.materialize(dqkv, qp), scale, heads,
                                       window_size, shift)
        return forward_ad.make_dual(out, dout)
    if _build.recording(qkv, scale):
        return _BlockAttention.apply(qkv, scale, heads, window_size, shift)
    return _block_attention(qkv, scale, heads, window_size, shift)


fused_block_attention.launches = 0
block_attention_bwd.launches = 0
block_attention_tangent.launches = 0


# -- the window-tiled variant (kernels 15, 16, 17) -------------------------------

def _tiled_block_attention(qkv, scale, heads, window_size):
    """The forward alone: the plain version on the CPU, else kernel 15."""
    if _build.on_cpu(qkv, scale):
        return reference_block_attention(qkv, scale, heads, window_size)
    name = "fused_tiled_block_attention"
    _build.check_kernel_inputs(name, qkv=qkv, scale=scale)
    B, gh, gw, d = _check(name, qkv, scale, heads, window_size)
    out = torch.empty(B, gh, gw, heads * d, device=qkv.device, dtype=qkv.dtype)
    _build.check_launch(
        _build.library().swift_tiled_attention(
            qkv.data_ptr(), scale.data_ptr(), out.data_ptr(), B, gh, gw, heads, d,
            window_size[0], window_size[1], _build.stream(),
        ),
        name,
    )
    fused_tiled_block_attention.launches += 1
    return out


def tiled_block_attention_bwd(qkv, scale, dout, heads, window_size):
    """(dqkv, dscale) of the tiled attention on pre-rolled qkv. CPU tensors
    take :func:`reference_block_attention_bwd` (no shift); CUDA tensors go to
    kernel 16 under the forward's shape rules (dout bf16, contiguous,
    (B, gh, gw, heads·d)), with :func:`attention_bwd_scratch_bytes` of
    scratch."""
    jvp_guard.refuse_tangents("tiled_block_attention_bwd", qkv=qkv, scale=scale, dout=dout)
    if _build.on_cpu(qkv, scale, dout):
        return reference_block_attention_bwd(qkv, scale, dout, heads, window_size)
    out = _attention_bwd("swift_tiled_attention_bwd", "tiled_block_attention_bwd", qkv, scale,
                         dout, heads, window_size)
    tiled_block_attention_bwd.launches += 1
    return out


def tiled_block_attention_tangent(qkv, dqkv, scale, heads, window_size):
    """The tangent of the tiled attention at pre-rolled qkv along dqkv. CPU
    tensors take :func:`reference_block_attention_tangent` (no shift); CUDA
    tensors go to kernel 17 under the forward's shape rules, dqkv bf16 and
    shaped like qkv."""
    if _build.on_cpu(qkv, dqkv, scale):
        return reference_block_attention_tangent(qkv, dqkv, scale, heads, window_size)
    name = "tiled_block_attention_tangent"
    _build.check_kernel_inputs(name, qkv=qkv, dqkv=dqkv, scale=scale)
    B, gh, gw, d = _check(name, qkv, scale, heads, window_size)
    _build.check_dtype(name, torch.bfloat16, dqkv=dqkv)
    if dqkv.shape != qkv.shape:
        raise ValueError(f"{name}: dqkv {tuple(dqkv.shape)} must match qkv {tuple(qkv.shape)}")
    out = torch.empty(B, gh, gw, heads * d, device=qkv.device, dtype=qkv.dtype)
    _build.check_launch(
        _build.library().swift_tiled_attention_tangent(
            qkv.data_ptr(), dqkv.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, gh, gw, heads, d, window_size[0], window_size[1], _build.stream(),
        ),
        name,
    )
    tiled_block_attention_tangent.launches += 1
    return out


class _TiledBlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(qkv, scale, heads, window_size):
        return _tiled_block_attention(qkv, scale, heads, window_size)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qkv, scale, ctx.heads, ctx.window_size = inputs
        ctx.save_for_backward(qkv, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, scale = ctx.saved_tensors
        dqkv, dscale = tiled_block_attention_bwd(qkv, scale, dout.to(qkv.dtype).contiguous(),
                                                 ctx.heads, ctx.window_size)
        return dqkv, dscale, None, None


def fused_tiled_block_attention(qkv, scale, heads, window_size, shift=(0, 0)):
    """The window-tiled attention (the contract of the JAX package's
    ``fused_tiled_block_attention``): :func:`fused_block_attention`'s
    function, with the shift taken as one ``torch.roll`` of qkv by
    (-sh, -sw) before kernel 15 and its inverse on the output. The model
    rolls the activation before the qkv projection and calls this with
    shift (0, 0).

    Its plain version is :func:`reference_block_attention`, which CPU
    tensors take (on the rolled qkv, so with no shift). CUDA tensors must be
    bf16 with wh·ww = 256 tokens a window, windows that tile the
    grid, and d a multiple of 8 no larger than 128. While autograd records,
    the backward is :func:`tiled_block_attention_bwd`. When qkv carries a
    forward-mode tangent, the output is the dual of kernel 15's primal and
    :func:`tiled_block_attention_tangent`."""
    window_size = tuple(window_size)
    gh, gw = qkv.shape[1:3]
    sh, sw = shift[0] % gh, shift[1] % gw
    if sh or sw:
        qkv = torch.roll(qkv, (-sh, -sw), (1, 2))
    qp, dqkv = forward_ad.unpack_dual(qkv)
    if dqkv is not None or jvp_guard.any_tangent(scale):
        jvp_guard.require_no_tangent("fused_tiled_block_attention", scale=scale)
        out = _tiled_block_attention(qp, scale, heads, window_size)
        dout = tiled_block_attention_tangent(qp, jvp_guard.materialize(dqkv, qp), scale,
                                             heads, window_size)
        out = forward_ad.make_dual(out, dout)
    elif _build.recording(qkv, scale):
        out = _TiledBlockAttention.apply(qkv, scale, heads, window_size)
    else:
        out = _tiled_block_attention(qkv, scale, heads, window_size)
    return torch.roll(out, (sh, sw), (1, 2)) if sh or sw else out


def per_head_window_attention(qkv, scale, heads, window_size, shift=(0, 0)):
    """The JAX model's per-(window, head) path (``SwinV2._per_head_path``):
    qkv (B, gh, gw, heads·3·d) rolled by (-sh, -sw), partitioned into
    windows and split by head into (B·nW, heads, n, d) q, k and v (the
    per-head [q|k|v] interleave), the cosine attention of
    :func:`swift_torch.ops.window_attention.fused_window_attention` (kernels
    21, 22b and 22t on CUDA tensors, their plain versions on CPU tensors),
    then the inverse layout and the un-roll: (B, gh, gw, heads·d)."""
    B, gh, gw, feat = qkv.shape
    d = feat // (3 * heads)
    shift = tuple(shift)
    x = _windows(qkv, heads, window_size, shift)  # (B, nW, n, heads, 3d)
    nW, n = x.shape[1], x.shape[2]

    def to_heads(a):
        return a.permute(0, 1, 3, 2, 4).reshape(B * nW, heads, n, d)

    q, k, v = (to_heads(a) for a in x.split(d, dim=-1))
    out = fused_window_attention(q, k, v, scale)
    out = out.reshape(B, nW, heads, n, d).permute(0, 1, 3, 2, 4)
    return _unwindows(out, window_size, (gh, gw), shift)


fused_tiled_block_attention.launches = 0
tiled_block_attention_bwd.launches = 0
tiled_block_attention_tangent.launches = 0
