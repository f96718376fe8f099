"""Per-(window, head) cosine attention: the core softmax(q̂·k̂ᵀ)·v at scale
1 (kernel 21), its backward (kernel 22b) and its forward-mode tangent
(kernel 22t), on separate q, k, v of shape ``(BW, h, n, d)``.

Counterpart of ``swift_tpu/ops/pallas_attention.py``. CUDA kernels:
``csrc/window_attention.cu::swift_window_attention``, which replaces
``_sdpa_fwd``; ``swift_window_attention_bwd``, which replaces
``_sdpa_bwd_call``; ``swift_window_attention_tangent``, which replaces
``_sdpa_tangent_call``. They take any n ≥ 1 and 1 ≤ d ≤ 256, and stream
the window in tiles of at most 128 rows, so a window of up to 1024 tokens
(and more) fits a block's shared memory, where the TPU kernels hold the
whole n×n logit tile.

As in the JAX package, the cosine normalisation and the logit scale stay
outside the kernels: :func:`fused_window_attention` forms
q̂ = normalize(q)·scale and k̂ = normalize(k) in fp32 with plain PyTorch
ops, both rounded to ``v.dtype``, so autograd and ``forward_ad``
differentiate them, as XLA does around the Pallas call; the scale's
gradient comes through the kernel's bf16-product dq̂ = bf16(dS)·k̂, as in
the JAX package.

Under tensor parallelism a rank's ``h`` is its share of the heads, with
its slice of the scale (``models.swinv2.WindowAttention``): the JAX
package's ``fused_window_attention(..., mesh=...)``, whose programs are
independent per (window, head), so the kernels run as they are.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from swift_torch.ops import _build, jvp_guard

_EPS = 1e-12


def _normalize(a: torch.Tensor) -> torch.Tensor:
    return a * torch.rsqrt(torch.sum(a * a, -1, keepdim=True) + _EPS)


def reference_window_attention(q, k, v, scale):
    """Plain version of the whole cosine attention (the JAX package's
    ``reference_window_attention``): q, k normalised in fp32, q times the
    (h,) scale, both rounded to ``v.dtype``; logits and p·v accumulate in
    fp32 from ``v.dtype`` operands, the softmax runs in fp32."""
    mm = v.dtype
    qn = _normalize(q.float()) * scale.float()[None, :, None, None]
    kn = _normalize(k.float())
    s = torch.einsum("bhnd,bhmd->bhnm", qn.to(mm).float(), kn.to(mm).float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p.to(mm).float(), v.float()).to(mm)


def _rounder(mm):
    return lambda a: a.to(mm).float()


def reference_sdpa(q, k, v, mm=None):
    """Plain version of kernel 21: softmax(q·kᵀ)·v at scale 1, q and k
    already normalised. q, k and p are rounded to ``mm`` (default
    ``v.dtype``; the TPU kernel always rounds them to bf16) before the
    products, v is taken as it is, and both products accumulate in fp32;
    the softmax runs in fp32. Returns ``q.dtype``."""
    r = _rounder(mm or v.dtype)
    p = torch.softmax(r(q) @ r(k).transpose(-1, -2), dim=-1)
    return (r(p) @ v.float()).to(q.dtype)


def reference_sdpa_bwd(q, k, v, do, mm=None):
    """Plain version of kernel 22b: (dq, dk, dv) of :func:`reference_sdpa`
    along do, the TPU kernel's formulas: p recomputed, dv = pᵀ·do,
    dp = do·vᵀ, dS = p(dp − Σ p·dp), dq = dS·k, dk = dSᵀ·q, with p and dS
    rounded to ``mm`` before the products that take them."""
    r = _rounder(mm or v.dtype)
    kt = lambda a: a.transpose(-1, -2)  # noqa: E731
    p = torch.softmax(r(q) @ kt(r(k)), dim=-1)
    dv = kt(r(p)) @ r(do)
    dp = r(do) @ kt(r(v))
    ds = p * (dp - torch.sum(p * dp, -1, keepdim=True))
    dq = r(ds) @ r(k)
    dk = kt(r(ds)) @ r(q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_sdpa_tangent(q, k, v, dq, dk, dv, mm=None):
    """Plain version of kernel 22t: the tangent of :func:`reference_sdpa`
    at (q, k, v) along (dq, dk, dv), the TPU kernel's formulas:
    dS = dq·kᵀ + q·dkᵀ, dP = p(dS − Σ p·dS), do = dP·v + p·dv, with p and dP
    rounded to ``mm`` before the products that take them. Returns
    ``v.dtype``."""
    r = _rounder(mm or v.dtype)
    kt = lambda a: a.transpose(-1, -2)  # noqa: E731
    p = torch.softmax(r(q) @ kt(r(k)), dim=-1)
    ds = r(dq) @ kt(r(k)) + r(q) @ kt(r(dk))
    dp = p * (ds - torch.sum(p * ds, -1, keepdim=True))
    return (r(dp) @ r(v) + r(p) @ r(dv)).to(v.dtype)


def _check(name, **tensors):
    """The kernels' input rules: one CUDA device, bf16, contiguous and
    16-byte aligned, all (BW, h, n, d) of one shape, n ≥ 1, 1 ≤ d ≤ 256.
    Returns (BW·h, n, d)."""
    _build.check_kernel_inputs(name, **tensors)
    _build.check_dtype(name, torch.bfloat16, **tensors)
    first, *rest = tensors.values()
    shape = first.shape
    if len(shape) != 4 or any(t.shape != shape for t in rest):
        shapes = {tuple(t.shape) for t in tensors.values()}
        raise ValueError(f"{name}: inputs must share one (BW, h, n, d) shape, got {shapes}")
    BW, h, n, d = shape
    if n < 1 or not 1 <= d <= 256:
        raise ValueError(f"{name}: n={n} must be ≥ 1 and d={d} in 1..256")
    return BW * h, n, d


def window_attention(q, k, v):
    """The core alone, softmax(q·kᵀ)·v at scale 1 on (BW, h, n, d): CPU
    tensors take :func:`reference_sdpa`, CUDA tensors kernel 21."""
    if _build.on_cpu(q, k, v):
        return reference_sdpa(q, k, v)
    name = "window_attention"
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, n, d = _check(name, q=q, k=k, v=v)
    o = torch.empty_like(q)
    _build.check_launch(
        _build.library().swift_window_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                o.data_ptr(), bh, n, d, _build.stream()),
        name,
    )
    window_attention.launches += 1
    return o


def bwd_scratch_floats(bh: int, n: int, d: int) -> int:
    """fp32 elements of kernel 22b's scratch, the launcher's rule: none for
    its packed form (n ≤ 64 at d ≤ 128), else each 64-row query tile's max,
    1/sum and Σ p·dp (192 floats) for the key pass."""
    return 0 if n <= 64 and d <= 128 else bh * -(-n // 64) * 192


def window_attention_bwd(q, k, v, do):
    """(dq, dk, dv) of :func:`window_attention` along do. CPU tensors take
    :func:`reference_sdpa_bwd`; CUDA tensors go to kernel 22b: one pass
    where n ≤ 64 and d ≤ 128, else a query pass and a key pass with 12 bytes
    of fp32 scratch a query row (:func:`bwd_scratch_floats`)."""
    jvp_guard.refuse_tangents("window_attention_bwd", q=q, k=k, v=v, do=do)
    if _build.on_cpu(q, k, v, do):
        return reference_sdpa_bwd(q, k, v, do)
    name = "window_attention_bwd"
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    bh, n, d = _check(name, q=q, k=k, v=v, do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(bwd_scratch_floats(bh, n, d), device=q.device, dtype=torch.float32)
    _build.check_launch(
        _build.library().swift_window_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), bh, n, d, _build.stream()),
        name,
    )
    window_attention_bwd.launches += 1
    return dq, dk, dv


def window_attention_tangent(q, k, v, dq, dk, dv):
    """The tangent of :func:`window_attention` at (q, k, v) along
    (dq, dk, dv). CPU tensors take :func:`reference_sdpa_tangent`; CUDA
    tensors go to kernel 22t."""
    if _build.on_cpu(q, k, v, dq, dk, dv):
        return reference_sdpa_tangent(q, k, v, dq, dk, dv)
    name = "window_attention_tangent"
    args = tuple(t.contiguous() for t in (q, k, v, dq, dk, dv))
    bh, n, d = _check(name, **dict(zip(("q", "k", "v", "dq", "dk", "dv"), args)))
    out = torch.empty_like(args[2])
    _build.check_launch(
        _build.library().swift_window_attention_tangent(
            *(t.data_ptr() for t in args), out.data_ptr(), bh, n, d, _build.stream()),
        name,
    )
    window_attention_tangent.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """The core on the rounded q̂, k̂, v: kernel 21 forward, kernel 22b
    backward."""

    @staticmethod
    def forward(q, k, v):
        return window_attention(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return window_attention_bwd(q, k, v, do.to(v.dtype))


def _core(q, k, v):
    """The core with its derivatives: under ``forward_ad`` the dual of
    kernel 21's primal and kernel 22t's tangent (the tangent kernel's inputs
    detached, as the JAX rule stop-gradients them); while autograd records,
    the Function whose backward is kernel 22b; else kernel 21 alone."""
    (qp, dq), (kp, dk), (vp, dv) = (forward_ad.unpack_dual(t) for t in (q, k, v))
    if dq is not None or dk is not None or dv is not None:
        prim = tuple(t.detach() for t in (qp, kp, vp))
        tang = tuple(jvp_guard.materialize(t, p).detach() for t, p in zip((dq, dk, dv), prim))
        return forward_ad.make_dual(window_attention(*prim), window_attention_tangent(*prim, *tang))
    if _build.recording(q, k, v):
        return _WindowAttention.apply(q, k, v)
    return window_attention(q, k, v)


def fused_window_attention(q, k, v, scale):
    """Cosine window attention on (BW, h, n, d) q, k, v; scale (h,) fp32,
    the exp'ed and clamped logit scale. q̂ = normalize(q)·scale and
    k̂ = normalize(k) in fp32 by PyTorch ops, rounded to ``v.dtype``, then
    the core: on CPU tensors its plain versions, on CUDA tensors kernels 21,
    22b (backward) and 22t (tangent). A tangent on ``scale`` raises, as in
    every tangent route of the port."""
    jvp_guard.require_no_tangent("fused_window_attention", scale=scale)
    qn = (_normalize(q.float()) * scale.float()[None, :, None, None]).to(v.dtype)
    return _core(qn, _normalize(k.float()).to(v.dtype), v)


window_attention.launches = 0
window_attention_bwd.launches = 0
window_attention_tangent.launches = 0
