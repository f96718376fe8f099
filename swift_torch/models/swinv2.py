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
activation; else, and wherever those kernels cannot hold the window or
head width (anything but 256-token windows and d ≤ 128), the per-head
route through kernels 21, 22b and 22t (``ops.block_attention.
attention_route``). A latitude that does not divide by patch × window (the 0.25°
WB2 grid's 721 rows) is edge-padded toward the pole inside the model and
the output cropped back; ``pos_embed_mode="factorized"`` replaces the
(gh·gw, dim) position table by a row and a column table summed in
``dtype``.

Tensor parallelism (``model_size`` > 1, the ranks of ``model_group``; the
JAX model under a ``(data, model)`` mesh): each attention block holds its
rank's heads, the rows of ``to_qkv`` and the columns of ``wo`` that go with
them, where the heads divide over the ranks; each FFN its slice of the
hidden units, ``[g_r ; u_r]`` of ``w1`` and the columns of ``w2``, where
they divide (``swift_torch.parallel.sharding``). A block's input goes
through ``copy_to_model``, the qkv projection (kernel 1, 13 and 14 behind
it) and the attention (whichever route ``attention_route`` picks for the
local heads) or SwiGLU (kernel 5, 8-11) run on the local slice, and the
row-parallel product's partial sums (wo as a plain product, as the JAX
model runs it under a mesh, or kernel 5's second pass) meet in
``reduce_from_model`` before the post-norm epilogue (kernel 4, 12 under a
jvp) on the summed rows; kernel 3, which fuses wo with the post-norm,
needs the summed rows and stays on the one-process route. The modulation,
norms, embeddings and head are computed alike on every model rank. A block
whose heads or hidden width do not divide runs replicated, with one log
line.

Pipeline parallelism (``pipe_stages`` > 1; the JAX model's ``stage``
argument under ``parallel/pipeline.py``): ``forward(..., stage=...)`` runs
the embeddings (``"embed"``: h and the fp32 conditioning vector), the
model's blocks (``"pairs"``) or the output head (``"head"``), and a stage's
model holds only its own block pairs. The three in turn are the whole
forward, so the pipelined forward runs the same kernels at each
microbatch's shapes.

``quant="int8"`` is the JAX model's dynamically quantized inference path
(``generate --int8``): outside ``jvp`` the qkv projection is
:func:`swift_torch.ops.quant.int8_matmul` rounded to ``dtype`` (a library
int8 product, as the JAX package leaves it to XLA), wo with the post-norm
and residual is kernel 19, and the FFN kernel 18 followed by kernel 4; the
attention kernels are unchanged. Weights are quantized in every forward
from the fp32 parameters (never from their ``dtype`` copies). The int8
wrappers are inference-only and raise while autograd records.
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
from swift_torch.ops import quant as quantlib
from swift_torch.ops.embeddings import timestep_embedding
from swift_torch.ops.ffn import fused_swiglu_ffn, fused_swiglu_ffn_int8
from swift_torch.ops.linear import fused_linear
from swift_torch.ops.modnorm import (
    fused_matmul_modnorm_residual,
    fused_matmul_modnorm_residual_int8,
    fused_modnorm_residual,
)
from swift_torch.parallel.sharding import Shard, attention_splits, ffn_splits
from swift_torch.parallel.tensor import copy_to_model, reduce_from_model
from swift_torch.utils.log import get_logger

logger = get_logger(__name__)


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
    and 17 in place of 2, 6 and 7 on the tiled route, 21, 22b and 22t on
    the per-head route; with ``quant="int8"`` outside a jvp, the int8 qkv
    product and kernel 19 in place of 1 and 3, the attention in ``dtype``
    on every route). With the heads split over ``model_size`` ranks, the
    local heads' qkv and attention, a plain wo product on the local
    columns, the partial sums' all-reduce and kernel 4 (12 under a jvp)."""

    def __init__(self, dim, heads, head_dim, window_size, shift=(0, 0),
                 quant: Optional[str] = None, model_size: int = 1, model_rank: int = 0,
                 model_group=None):
        super().__init__()
        self.heads, self.head_dim, self.dim = heads, head_dim, dim
        self.window_size, self.shift = tuple(window_size), tuple(shift)
        self.quant = quant
        self.split = attention_splits(heads, model_size)
        self.model_size, self.model_rank, self.model_group = model_size, model_rank, model_group
        self.local_heads = heads // model_size if self.split else heads
        inner = self.local_heads * head_dim
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.scale = nn.Parameter(torch.full((1, heads, 1, 1), math.log(10.0)))
        self.wo = nn.Linear(inner, dim, bias=False)
        self.norm = ModulatedNorm(dim)

    def param_shards(self) -> dict:
        """{parameter: Shard} of the weights this rank holds a slice of."""
        if not self.split:
            return {}
        inner = self.heads * self.head_dim
        r, m = self.model_rank, self.model_size
        return {"to_qkv.weight": Shard((3 * inner, self.dim), 0, r, m),
                "wo.weight": Shard((self.dim, inner), 1, r, m)}

    def sliced_params(self) -> tuple:
        """The replicated parameters used on this rank's heads only."""
        return ("scale",) if self.split else ()

    def forward(self, x: torch.Tensor, cond: torch.Tensor, jvp: bool = False) -> torch.Tensor:
        dt = x.dtype
        int8 = self.quant == "int8" and not jvp
        heads = self.local_heads

        def project(a):
            if int8:  # from the fp32 parameter, rounded to dtype as the JAX model does
                return quantlib.int8_matmul(a, self.to_qkv.weight).to(dt)
            return fused_linear(a, self.to_qkv.weight.to(dt))

        s = self.scale.reshape(-1)
        xin = x
        if self.split:
            # this rank's heads: the JAX package's sharded_block_attention and
            # the per-head kernel's mesh form, the same kernels at heads / ranks
            s = s[self.model_rank * heads:(self.model_rank + 1) * heads]
            xin = copy_to_model(x, self.model_group)
        s = torch.exp(torch.clamp(s, max=math.log(100.0)))  # a new, aligned tensor
        route = attention_route(tuple(x.shape[1:3]), self.window_size, self.shift, heads,
                                heads * self.head_dim)
        if route == "tiled":
            # the JAX model's tiled route: a token permutation commutes with
            # the row-wise projection, so the dim-wide activation is rolled
            # instead of the 3·inner-wide qkv
            sh, sw = self.shift
            xr = torch.roll(xin, (-sh, -sw), (1, 2)) if sh or sw else xin
            out = fused_tiled_block_attention(project(xr), s, heads, self.window_size)
            if sh or sw:
                out = torch.roll(out, (sh, sw), (1, 2))
        else:
            attend = fused_block_attention if route == "block" else per_head_window_attention
            out = attend(project(xin), s, heads, self.window_size, self.shift)
        if jvp or self.split:
            # the JAX model's jvp and mesh paths: wo as a plain product rounded
            # to dtype (kernel 3 keeps it in fp32 and needs the summed rows),
            # the ranks' partial sums summed, then the post-norm epilogue
            y = F.linear(out, self.wo.weight.to(dt))
            if self.split:
                y = reduce_from_model(y, self.model_group)
            return self.norm.epilogue(y, x, cond)
        g, b, scale, shift = self.norm.pieces(cond)
        if int8:
            return fused_matmul_modnorm_residual_int8(
                out, self.wo.weight, x, g, b, scale, shift, self.norm.eps
            )
        return fused_matmul_modnorm_residual(
            out, self.wo.weight.to(dt), x, g, b, scale, shift, self.norm.eps
        )


class FeedForward(nn.Module):
    """SwiGLU feed-forward, post-norm and residual (kernels 5 and 4; for
    dual inputs kernels 11, 4 and 12; with ``quant="int8"`` outside a jvp,
    kernels 18 and 4). With the hidden units split over ``model_size``
    ranks, the same kernels on the local slice, then the partial sums'
    all-reduce before the epilogue."""

    def __init__(self, dim: int, hidden_dim: int, quant: Optional[str] = None,
                 model_size: int = 1, model_rank: int = 0, model_group=None):
        super().__init__()
        self.dim, self.hidden = dim, hidden_dim
        self.split = ffn_splits(hidden_dim, model_size)
        self.model_size, self.model_rank, self.model_group = model_size, model_rank, model_group
        local = hidden_dim // model_size if self.split else hidden_dim
        self.w1 = nn.Linear(dim, 2 * local, bias=False)
        self.w2 = nn.Linear(local, dim, bias=False)
        self.norm = ModulatedNorm(dim)
        self.quant = quant

    def param_shards(self) -> dict:
        """{parameter: Shard} of the weights this rank holds a slice of:
        ``[g_r ; u_r]`` rows of w1, the matching columns of w2."""
        if not self.split:
            return {}
        r, m = self.model_rank, self.model_size
        return {"w1.weight": Shard((2 * self.hidden, self.dim), 0, r, m, halves=True),
                "w2.weight": Shard((self.dim, self.hidden), 1, r, m)}

    def forward(self, x: torch.Tensor, cond: torch.Tensor, jvp: bool = False) -> torch.Tensor:
        if self.quant == "int8" and not jvp:
            y = fused_swiglu_ffn_int8(x, self.w1.weight, self.w2.weight)
        else:
            dt = x.dtype
            xin = copy_to_model(x, self.model_group) if self.split else x
            y = fused_swiglu_ffn(xin, self.w1.weight.to(dt), self.w2.weight.to(dt))
            if self.split:
                y = reduce_from_model(y, self.model_group)
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
    forward-mode path and ``quant="int8"`` the int8 inference path;
    ``model_size`` > 1 builds this rank's (``model_rank`` of the ranks of
    ``model_group``) part of a tensor-parallel replica (see the module
    docstring); ``pipe_stages`` > 1 builds pipeline stage ``pipe_stage``:
    the embeddings, the head and only the stage's pairs, blocks
    ``[s·depth/S, (s+1)·depth/S)`` (``transformer.layers`` counts from 0
    there; ``parallel.pipeline.stage_state_dict`` renames a whole state
    dict's). ``stage`` runs one piece of the forward (:meth:`forward`).
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
        quant: Optional[str] = None,
        model_size: int = 1,
        model_rank: int = 0,
        model_group=None,
        pipe_stages: int = 1,
        pipe_stage: int = 0,
    ):
        super().__init__()
        H, W = _as_2tuple(img_resolution)
        ph, pw = _as_2tuple(patch_size)
        wh, ww = _as_2tuple(window_size)
        if W % (pw * ww):
            raise ValueError(f"longitude {W} must divide by patch x window {pw * ww}")
        if pos_embed_mode not in ("learned", "factorized"):
            raise ValueError(f"pos_embed_mode {pos_embed_mode!r}: learned or factorized")
        if quant not in (None, "int8"):
            raise ValueError(f"quant {quant!r}: None or 'int8'")
        if quant and model_size > 1:
            raise ValueError("the int8 forecast runs one replica a process (model_size 1)")
        if pipe_stages > 1 and model_size > 1:
            raise NotImplementedError("a model axis and a pipe axis together are not ported")
        n_pairs = depth // 2
        if pipe_stages < 1 or (pipe_stages > 1 and (depth % 2 or n_pairs % pipe_stages)):
            raise ValueError(f"{n_pairs} block pairs do not split over {pipe_stages} stages")
        if not 0 <= pipe_stage < pipe_stages:
            raise ValueError(f"pipe stage {pipe_stage} of {pipe_stages}")
        self.quant = quant
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
        # the blocks this model holds: all of them, or one pipeline stage's pairs
        self.depth, self.pipe_stages, self.pipe_stage = depth, pipe_stages, pipe_stage
        per_stage = depth // pipe_stages
        self.first_layer = pipe_stage * per_stage
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
        tp = dict(model_size=model_size, model_rank=model_rank, model_group=model_group)
        self.transformer = _Transformer(
            nn.ModuleList([
                WindowAttention(dim, heads, head_dim, (wh, ww),
                                (sh, sw) if (sh or sw) and i % 2 else (0, 0), quant=quant, **tp),
                FeedForward(dim, hidden, quant=quant, **tp),
            ])
            for i in range(self.first_layer, self.first_layer + per_stage)
        )
        if model_size > 1 and model_rank == 0:
            whole = [f"{what} ({n})" for what, n, split in (
                ("the attention's heads", heads, attention_splits(heads, model_size)),
                ("the FFN's hidden width", hidden, ffn_splits(hidden, model_size))) if not split]
            if whole:
                logger.info(f"tensor parallelism over {model_size} ranks: replicated where the "
                            f"split does not divide: {' and '.join(whole)}")
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

    def _embed(self, x, t, auxiliary) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, in_channels), t, auxiliary -> (h (B, gh, gw, dim) in
        ``dtype``, the fp32 conditioning vector cond (B, dim))."""
        B = x.shape[0]
        H, W = self.img_resolution
        ph, pw = self.patch_size
        gh, gw = self.grid_size
        if tuple(x.shape[1:3]) != (H, W):
            raise ValueError(f"expected NHWC input {(H, W)}, got {tuple(x.shape)}")
        dt = self.dtype
        if self.lat_pad:  # edge rows toward the pole, cropped from the output by head
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
        return h, self._condition(t, auxiliary)

    def _pairs(self, h: torch.Tensor, cond: torch.Tensor, jvp: bool) -> torch.Tensor:
        """This model's blocks (every block, or a pipeline stage's pairs) on
        h under the fp32 cond."""
        cond_c = cond.to(self.dtype)
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
                h = ff(attn(h, cond_c, jvp), cond_c, jvp)
        return h

    def _head(self, h: torch.Tensor, cond: torch.Tensor, return_logvar: bool):
        """The output head on h, cropped to the latitude, in fp32 (and the
        logvar head on cond)."""
        B = h.shape[0]
        H, W = self.img_resolution
        ph, pw = self.patch_size
        gh, gw = self.grid_size
        # output head, (c, p1, p2) feature order as the reference
        o = F.linear(h, self.head.head[0].weight.to(self.dtype))
        o = o.reshape(B, gh, gw, self.out_channels, ph, pw).permute(0, 1, 4, 2, 5, 3)
        o = o.reshape(B, gh * ph, W, self.out_channels)[:, :H].float()
        if return_logvar:
            if self.logvar_embed is None:
                raise ValueError("return_logvar needs a model built with logvar=True")
            return o, self.logvar_embed(cond).squeeze(-1)
        return o

    def forward(self, x, t, auxiliary=None, return_logvar: bool = False, jvp: bool = False,
                stage: Optional[str] = None):
        """The whole forward (``stage`` None), or one of the three pieces
        the pipeline schedules (the JAX model's ``stage``): ``"embed"``
        returns (h, cond) of (x, t, auxiliary); ``"pairs"`` reads (x, t) as
        (h, cond) and returns h after this model's blocks; ``"head"`` reads
        them so and returns the output (and logvar). embed, pairs, head in
        turn are the whole forward, operation for operation."""
        if stage == "embed":
            return self._embed(x, t, auxiliary)
        if stage == "pairs":
            return self._pairs(x, t, jvp)
        if stage == "head":
            return self._head(x, t, return_logvar)
        if stage is not None:
            raise ValueError(f"stage {stage!r}: None, 'embed', 'pairs' or 'head'")
        h, cond = self._embed(x, t, auxiliary)
        return self._head(self._pairs(h, cond, jvp), cond, return_logvar)
