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
kernel cannot hold (0.25°: 368×720 tokens). Kernel 16 sums dk̂ and dv in a
pass over key blocks instead of kernel 6's per-query-block partials, whose
workspace grows with the grid.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from swift_torch.ops import _build, jvp_guard
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


def attention_route(grid_size, window_size, shift, heads: int, dim_inner: int) -> str:
    """The JAX model's attention route (``swinv2.py:367-383``): "block" (the
    whole-grid kernels 2, 6, 7) when its gate passes, else "tiled" (15, 16,
    17), else "per_head" (the per-(window, head) kernels 21 and 22, see
    :func:`per_head_window_attention`)."""
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
    d, rem = divmod(feat, 3 * heads)
    if rem or d % 8 or d > 128:
        raise ValueError(f"{name}: head dim {feat}/(3·{heads}) must be a multiple of 8 ≤ 128")
    if wh * ww != 256 or gh % wh or gw % ww:
        raise ValueError(f"{name}: windows {window_size} must hold 256 tokens and tile {(gh, gw)}")
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


def block_attention_bwd(qkv, scale, dout, heads, window_size, shift=(0, 0)):
    """(dqkv, dscale) of :func:`fused_block_attention`. CPU tensors take
    :func:`reference_block_attention_bwd`; CUDA tensors go to kernel 6 under
    the forward's shape rules (dout bf16, contiguous, (B, gh, gw, heads·d)).

    Kernel 6 sums dk and dv over its query blocks through fp32 partials:
    2·B·heads·nW·256·dp fp32 of workspace (dp = d rounded up to 32),
    0.60 GB at B = 2 for 12×88 heads and 1.07 GB for 8×128."""
    jvp_guard.refuse_tangents("block_attention_bwd", qkv=qkv, scale=scale, dout=dout)
    if _build.on_cpu(qkv, scale, dout):
        return reference_block_attention_bwd(qkv, scale, dout, heads, window_size, shift)
    name = "block_attention_bwd"
    _build.check_kernel_inputs(name, qkv=qkv, scale=scale, dout=dout)
    B, gh, gw, d = _check(name, qkv, scale, heads, window_size)
    _build.check_dtype(name, torch.bfloat16, dout=dout)
    if dout.shape != (B, gh, gw, heads * d):
        raise ValueError(f"{name}: dout must be {(B, gh, gw, heads * d)}, got {tuple(dout.shape)}")
    wh, ww = window_size
    sh, sw = shift[0] % gh, shift[1] % gw
    lib = _build.library()
    dp = (d + 31) // 32 * 32
    nW = (gh // wh) * (gw // ww)
    n_qb = 256 // lib.swift_block_attention_bwd_qb(d)
    dev = qkv.device
    part_k = torch.empty(B * heads * nW * n_qb * 256 * dp, device=dev, dtype=torch.float32)
    part_v = torch.empty_like(part_k)
    part_s = torch.empty(B * heads * nW * n_qb, device=dev, dtype=torch.float32)
    dqkv = torch.empty_like(qkv)
    dscale = torch.empty_like(scale)
    _build.check_launch(
        lib.swift_block_attention_bwd(
            qkv.data_ptr(), scale.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            dscale.data_ptr(), part_k.data_ptr(), part_v.data_ptr(), part_s.data_ptr(),
            B, gh, gw, heads, d, wh, ww, sh, sw, _build.stream(),
        ),
        name,
    )
    block_attention_bwd.launches += 1
    return dqkv, dscale


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

def tiled_bwd_scratch_bytes(B, gh, gw, heads, d, window_size) -> int:
    """Device scratch of kernel 16: each query row's softmax statistics
    (3 fp32) and one fp32 scale partial per (sample, head, window, query
    block). 25.7 MB at 0.25° (B = 1, 368×720, 8×128), against kernel 6's
    17.4 GB of partials there."""
    n_w = (gh // window_size[0]) * (gw // window_size[1])
    n_qb = 256 // _build.library().swift_block_attention_bwd_qb(d)
    return 4 * B * heads * n_w * (3 * 256 + n_qb)


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
    (B, gh, gw, heads·d)), with :func:`tiled_bwd_scratch_bytes` of scratch."""
    jvp_guard.refuse_tangents("tiled_block_attention_bwd", qkv=qkv, scale=scale, dout=dout)
    if _build.on_cpu(qkv, scale, dout):
        return reference_block_attention_bwd(qkv, scale, dout, heads, window_size)
    name = "tiled_block_attention_bwd"
    _build.check_kernel_inputs(name, qkv=qkv, scale=scale, dout=dout)
    B, gh, gw, d = _check(name, qkv, scale, heads, window_size)
    _build.check_dtype(name, torch.bfloat16, dout=dout)
    if dout.shape != (B, gh, gw, heads * d):
        raise ValueError(f"{name}: dout must be {(B, gh, gw, heads * d)}, got {tuple(dout.shape)}")
    wh, ww = window_size
    nW = (gh // wh) * (gw // ww)
    scratch = torch.empty(tiled_bwd_scratch_bytes(B, gh, gw, heads, d, window_size) // 4,
                          device=qkv.device, dtype=torch.float32)
    stats = scratch[:B * heads * nW * 3 * 256]
    part_s = scratch[B * heads * nW * 3 * 256:]
    dqkv = torch.empty_like(qkv)
    dscale = torch.empty_like(scale)
    _build.check_launch(
        _build.library().swift_tiled_attention_bwd(
            qkv.data_ptr(), scale.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            dscale.data_ptr(), stats.data_ptr(), part_s.data_ptr(),
            B, gh, gw, heads, d, wh, ww, _build.stream(),
        ),
        name,
    )
    tiled_block_attention_bwd.launches += 1
    return dqkv, dscale


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
    """The JAX model's per-(window, head) path, taken where neither gate
    passes: ``pallas_attention.py::_sdpa_fwd`` and its backward and tangent
    (kernels 21 and 22), which are not ported. CPU tensors take the plain
    versions, whose function is :func:`fused_block_attention`'s (the
    per-head path computes the same attention); CUDA tensors raise."""
    if not _build.on_cpu(qkv, scale):
        raise NotImplementedError(
            f"attention at grid {tuple(qkv.shape[1:3])}, window {tuple(window_size)}, shift "
            f"{tuple(shift)}: the JAX model takes its per-head path here (kernels 21 and 22, "
            "pallas_attention.py::_sdpa_fwd), which is not ported")
    return fused_block_attention(qkv, scale, heads, window_size, shift)


fused_tiled_block_attention.launches = 0
tiled_block_attention_bwd.launches = 0
tiled_block_attention_tangent.launches = 0
