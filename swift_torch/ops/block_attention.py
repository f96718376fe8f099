"""Shifted-window cosine attention from the qkv layout (kernel 2).

CUDA kernel: ``csrc/block_attention.cu::swift_block_attention``, which
replaces ``swift_tpu/ops/pallas_block_attention.py::_fwd_call``. Input is
the qkv projection in its natural ``(B, gh, gw, heads·3·d)`` layout with the
per-head [q|k|v] interleave; output is ``(B, gh, gw, heads·d)``.
"""

from __future__ import annotations

import torch

from swift_torch.ops import _build
from swift_torch.ops.windows import cyclic_shift, window_partition, window_reverse

_EPS = 1e-12


def _l2_normalize(a: torch.Tensor) -> torch.Tensor:
    return a * torch.rsqrt(torch.sum(a * a, -1, keepdim=True) + _EPS)


def reference_block_attention(qkv, scale, heads, window_size, shift=(0, 0)):
    """Plain version: explicit roll, window partition and head split.

    q, k are L2-normalised in fp32 and rounded to qkv.dtype (q after the
    logit scale), the logits and p·v accumulate in fp32, the softmax runs in
    fp32 and p is rounded to qkv.dtype before p·v."""
    B, gh, gw, feat = qkv.shape
    d = feat // (3 * heads)
    wh, ww = window_size
    sh, sw = shift
    mm = qkv.dtype
    x = cyclic_shift(qkv, (-sh, -sw))
    x = window_partition(x, (wh, ww))  # (B, nW, n, feat)
    nW, n = x.shape[1], x.shape[2]
    q, k, v = x.reshape(B, nW, n, heads, 3 * d).split(d, dim=-1)
    qn = _l2_normalize(q.float()) * scale.float()[:, None]
    kn = _l2_normalize(k.float())
    s = torch.einsum("bwnhd,bwmhd->bwhnm", qn.to(mm).float(), kn.to(mm).float())
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bwhnm,bwmhd->bwnhd", p.to(mm).float(), v.float())
    o = o.reshape(B, nW, n, heads * d).to(mm)
    return cyclic_shift(window_reverse(o, (wh, ww), (gh, gw)), (sh, sw))


def fused_block_attention(qkv, scale, heads, window_size, shift=(0, 0)):
    """qkv: (B, gh, gw, heads·3·d); scale: (heads,) fp32, the exp'ed and
    clamped logit scale; window_size (wh, ww); shift (sh, sw) is a cyclic
    roll of (-sh, -sw) before windowing, undone on the output.

    CPU tensors take :func:`reference_block_attention`. CUDA tensors must be
    bf16 with wh·ww = 256 tokens a window, windows that tile the grid, and
    d a multiple of 8 no larger than 128."""
    if _build.on_cpu(qkv, scale):
        return reference_block_attention(qkv, scale, heads, window_size, shift)
    name = "fused_block_attention"
    _build.check_kernel_inputs(name, qkv=qkv, scale=scale)
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


fused_block_attention.launches = 0
