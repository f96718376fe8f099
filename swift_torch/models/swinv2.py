"""SwinV2 windowed-attention transformer.

Counterpart of ``swift_tpu/models/swinv2.py`` (the flagship backbone):
channels-last ``(B, gh, gw, D)`` activations, cosine attention over
shifted windows with a learned per-head logit scale clamped at log(100),
SwiGLU feed-forward with hidden = int(8/3·dim), post-norm residual blocks
with AdaLN modulation, and the sinusoidal timestep embedding with the EDM
flip. Parameter names are the reference torch model's (the names
``swift_tpu.models.convert.swinv2_params_to_state_dict`` writes), so
``load_state_dict`` takes converted JAX checkpoints as they are.

dtype points follow the JAX model: the latent MLP, ``auxiliary_embed`` and
``logvar_embed`` run in fp32; everything else in ``dtype`` (bf16 on the
card) over fp32 parameters; the output is fp32. Each block runs through
five kernels (``swift_torch.ops``); on CPU tensors they take their plain
PyTorch versions. Under autograd the kernels' Functions carry the backward
kernels, and ``remat_layers`` (the JAX model's default) recomputes each
(unshifted, shifted) block pair in the backward: the first forward runs the
pair without autograd, saving only the pair's input, and the backward runs
it again with autograd on before differentiating it.

``forward(..., jvp=True)`` is the sCM loss's forward-mode pass (the JAX
model's ``jvp`` flag): run under ``torch.autograd.forward_ad`` with dual
inputs, it takes no remat, the qkv projection and the attention give their
tangents through kernels 14 and 7 (17 on the tiled route), wo is a plain
product in ``dtype`` followed by the modnorm epilogue (kernel 3 has no
tangent route), and the FFN and both epilogues give theirs through kernels
11, 4 and 12, at every grid size.

The attention takes the JAX model's route: the whole-grid kernels where
their gate passes (the 1.4° grid), else the window-tiled kernels 15, 16
and 17 (the 0.25° grid, 368×720 tokens), for which the odd blocks' window
shift is one roll of the dim-wide activation before the qkv projection and
its inverse on the attention output, the residual keeping the unrolled
activation. A latitude that does not divide by patch × window (the 0.25°
WB2 grid's 721 rows) is edge-padded toward the pole inside the model and
the output cropped back; ``pos_embed_mode="factorized"`` replaces the
(gh·gw, dim) position table by a row and a column table summed in
``dtype``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from swift_torch.ops.block_attention import (
    attention_route,
    fused_block_attention,
    fused_tiled_block_attention,
    per_head_window_attention,
)
from swift_torch.ops.embeddings import timestep_embedding
from swift_torch.ops.ffn import fused_swiglu_ffn
from swift_torch.ops.linear import fused_linear
from swift_torch.ops.modnorm import fused_matmul_modnorm_residual, fused_modnorm_residual


def _as_2tuple(v) -> tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    v = tuple(int(i) for i in v)
    if len(v) != 2:
        raise ValueError(f"expected an int or a pair, got {v}")
    return v


class ModulatedNorm(nn.Module):
    """LayerNorm affine params (``norm``, only held: the kernels compute the
    statistics) and the AdaLN ``modulation`` Linear producing scale/shift."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.modulation = nn.Linear(dim, 2 * dim)

    def pieces(self, cond: torch.Tensor):
        """(g, b, scale, shift): fp32 LN affine and (B, D) AdaLN rows in
        cond.dtype."""
        mod = F.linear(cond, self.modulation.weight.to(cond.dtype),
                       self.modulation.bias.to(cond.dtype))
        scale, shift = mod.chunk(2, dim=-1)
        return self.norm.weight, self.norm.bias, scale.contiguous(), shift.contiguous()

    def epilogue(self, y, residual, cond):
        """``residual + modnorm(y)``: kernel 4 (with kernel 12 for the
        tangent of dual inputs)."""
        g, b, scale, shift = self.pieces(cond)
        return fused_modnorm_residual(y, residual, g, b, scale, shift, self.eps)


class WindowAttention(nn.Module):
    """qkv projection -> shifted-window cosine attention -> wo projection,
    post-norm and residual (kernels 1, 2 and 3; under a jvp kernels 14, 2
    with 7, a plain wo product, and the modnorm epilogue; kernels 15, 16
    and 17 in place of 2, 6 and 7 on the tiled route)."""

    def __init__(self, dim, heads, head_dim, window_size, shift=(0, 0)):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.window_size, self.shift = tuple(window_size), tuple(shift)
        inner = heads * head_dim
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.scale = nn.Parameter(torch.full((1, heads, 1, 1), math.log(10.0)))
        self.wo = nn.Linear(inner, dim, bias=False)
        self.norm = ModulatedNorm(dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, jvp: bool = False) -> torch.Tensor:
        dt = x.dtype
        w_qkv = self.to_qkv.weight.to(dt)
        s = torch.exp(torch.clamp(self.scale.reshape(-1), max=math.log(100.0)))
        route = attention_route(tuple(x.shape[1:3]), self.window_size, self.shift, self.heads,
                                self.heads * self.head_dim)
        if route == "tiled":
            # the JAX model's tiled route: a token permutation commutes with
            # the row-wise projection, so the dim-wide activation is rolled
            # instead of the 3·inner-wide qkv
            sh, sw = self.shift
            xr = torch.roll(x, (-sh, -sw), (1, 2)) if sh or sw else x
            out = fused_tiled_block_attention(fused_linear(xr, w_qkv), s, self.heads,
                                              self.window_size)
            if sh or sw:
                out = torch.roll(out, (sh, sw), (1, 2))
        else:
            attend = fused_block_attention if route == "block" else per_head_window_attention
            out = attend(fused_linear(x, w_qkv), s, self.heads, self.window_size, self.shift)
        if jvp:
            # the JAX model's jvp path: wo as a plain product rounded to dtype
            # (kernel 3 keeps it in fp32), then the post-norm epilogue
            y = F.linear(out, self.wo.weight.to(dt))
            return self.norm.epilogue(y, x, cond)
        g, b, scale, shift = self.norm.pieces(cond)
        return fused_matmul_modnorm_residual(
            out, self.wo.weight.to(dt), x, g, b, scale, shift, self.norm.eps
        )


class FeedForward(nn.Module):
    """SwiGLU feed-forward, post-norm and residual (kernels 5 and 4; for
    dual inputs kernels 11, 4 and 12)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.w1 = nn.Linear(dim, 2 * hidden_dim, bias=False)
        self.w2 = nn.Linear(hidden_dim, dim, bias=False)
        self.norm = ModulatedNorm(dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = fused_swiglu_ffn(x, self.w1.weight.to(dt), self.w2.weight.to(dt))
        return self.norm.epilogue(y, x, cond)


class _PatchEmbed(nn.Module):
    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.emb = nn.Linear(in_features, dim)


class _LatentEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.l1 = nn.Linear(dim, dim)
        self.l2 = nn.Linear(dim, dim)


class _Head(nn.Module):
    def __init__(self, dim: int, out_features: int):
        super().__init__()
        self.head = nn.Sequential(nn.Linear(dim, out_features, bias=False))


class _Transformer(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class SwinV2(nn.Module):
    """Flagship SwinV2 denoiser backbone.

    ``forward(x, t, auxiliary=None, return_logvar=False, jvp=False)``: x
    (B, H, W, in_channels) NHWC; t () / (1,) / (B,) timesteps; auxiliary (B,
    auxiliary_dim). Returns (B, H, W, out_channels) fp32, and the (B,)
    logvar head output when ``return_logvar``. ``jvp`` selects the
    forward-mode path (see the module docstring).
    """

    def __init__(
        self,
        img_resolution: Sequence[int],
        in_channels: int,
        out_channels: int,
        window_size: Sequence[int],
        shift_size: Sequence[int],
        patch_size: Sequence[int],
        depth: int = 6,
        dim: int = 512,
        heads: int = 12,
        head_dim: Optional[int] = None,
        auxiliary_dim: int = 0,
        logvar: bool = False,
        timestep_weight: float = 1.0,
        dtype: torch.dtype = torch.bfloat16,
        remat_layers: bool = True,
        pos_embed_mode: str = "learned",
    ):
        super().__init__()
        H, W = _as_2tuple(img_resolution)
        ph, pw = _as_2tuple(patch_size)
        wh, ww = _as_2tuple(window_size)
        if W % (pw * ww):
            raise ValueError(f"longitude {W} must divide by patch x window {pw * ww}")
        if pos_embed_mode not in ("learned", "factorized"):
            raise ValueError(f"pos_embed_mode {pos_embed_mode!r}: learned or factorized")
        self.img_resolution = (H, W)
        self.patch_size = (ph, pw)
        self.lat_pad = (-H) % (ph * wh)  # edge rows added toward the pole
        self.grid_size = ((H + self.lat_pad) // ph, W // pw)
        self.pos_embed_mode = pos_embed_mode
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dim, self.auxiliary_dim = dim, auxiliary_dim
        self.timestep_weight = timestep_weight
        self.dtype = dtype
        self.remat_layers = remat_layers
        head_dim = head_dim or dim // heads
        sh, sw = _as_2tuple(shift_size)
        gh, gw = self.grid_size

        self.patch_embed = _PatchEmbed(ph * pw * in_channels, dim)
        if pos_embed_mode == "factorized":
            self.pos_embed_row = nn.Parameter(0.02 * torch.randn(1, gh, 1, dim))
            self.pos_embed_col = nn.Parameter(0.02 * torch.randn(1, 1, gw, dim))
        else:
            self.pos_embed = nn.Parameter(0.02 * torch.randn(1, gh * gw, dim))
        self.latent_embed = _LatentEmbed(dim)
        self.auxiliary_embed = nn.Linear(auxiliary_dim, dim) if auxiliary_dim else None
        self.logvar_embed = nn.Linear(dim, 1) if logvar else None
        hidden = int(8 / 3.0 * dim)
        self.transformer = _Transformer(
            nn.ModuleList([
                WindowAttention(dim, heads, head_dim, (wh, ww),
                                (sh, sw) if (sh or sw) and i % 2 else (0, 0)),
                FeedForward(dim, hidden),
            ])
            for i in range(depth)
        )
        self.head = _Head(dim, out_channels * ph * pw)

    def _condition(self, t: torch.Tensor, auxiliary: Optional[torch.Tensor]) -> torch.Tensor:
        """fp32 conditioning vector silu(l2(silu(l1(emb + aux_embed))))."""
        emb = timestep_embedding(t * self.timestep_weight, self.dim)
        if self.auxiliary_embed is not None and auxiliary is not None:
            aux = auxiliary.float().reshape(t.shape[0], self.auxiliary_dim)
            emb = emb + self.auxiliary_embed(aux * math.sqrt(self.auxiliary_dim))
        e = self.latent_embed.l2(F.silu(self.latent_embed.l1(emb)))
        return F.silu(e)

    def _pair(self, h: torch.Tensor, cond: torch.Tensor, j: int) -> torch.Tensor:
        """Blocks j (unshifted) and j + 1 (shifted)."""
        for attn, ff in self.transformer.layers[j:j + 2]:
            h = ff(attn(h, cond), cond)
        return h

    def forward(self, x, t, auxiliary=None, return_logvar: bool = False, jvp: bool = False):
        B = x.shape[0]
        H, W = self.img_resolution
        ph, pw = self.patch_size
        gh, gw = self.grid_size
        if tuple(x.shape[1:3]) != (H, W):
            raise ValueError(f"expected NHWC input {(H, W)}, got {tuple(x.shape)}")
        dt = self.dtype
        if self.lat_pad:  # edge rows toward the pole, cropped from the output below
            x = torch.cat([x, x[:, -1:].expand(B, self.lat_pad, W, x.shape[-1])], dim=1)

        # patch embedding, (p1, p2, c) feature order as the reference
        xp = x.reshape(B, gh, ph, gw, pw, x.shape[-1]).permute(0, 1, 3, 2, 4, 5)
        xp = xp.reshape(B, gh, gw, ph * pw * x.shape[-1]).to(dt)
        emb = self.patch_embed.emb
        h = F.linear(xp, emb.weight.to(dt), emb.bias.to(dt))
        if self.pos_embed_mode == "factorized":
            h = h + (self.pos_embed_row.to(dt) + self.pos_embed_col.to(dt))
        else:
            h = h + self.pos_embed.to(dt).reshape(1, gh, gw, self.dim)

        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
        if t.shape[0] != B:
            t = t.expand(B)
        cond = self._condition(t, auxiliary)
        cond_c = cond.to(dt)
        layers = self.transformer.layers
        if self.remat_layers and not jvp and torch.is_grad_enabled() and len(layers) % 2 == 0:
            for j in range(0, len(layers), 2):
                # reentrant: the first forward runs under no_grad, so the
                # kernels' forward-only paths serve it, and the backward's
                # recompute takes the Functions (the JAX launch pattern)
                h = torch.utils.checkpoint.checkpoint(
                    self._pair, h, cond_c, j, use_reentrant=True, preserve_rng_state=False)
        else:
            for attn, ff in layers:
                h = ff(attn(h, cond_c, jvp), cond_c)

        # output head, (c, p1, p2) feature order as the reference
        o = F.linear(h, self.head.head[0].weight.to(dt))
        o = o.reshape(B, gh, gw, self.out_channels, ph, pw).permute(0, 1, 4, 2, 5, 3)
        o = o.reshape(B, gh * ph, W, self.out_channels)[:, :H].float()
        if return_logvar:
            if self.logvar_embed is None:
                raise ValueError("return_logvar needs a model built with logvar=True")
            return o, self.logvar_embed(cond).squeeze(-1)
        return o
