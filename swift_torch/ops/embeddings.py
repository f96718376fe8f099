"""Sinusoidal timestep embedding with the EDM sin/cos flip.

Counterpart of ``swift_tpu/ops/embeddings.py``; parity with released
checkpoints depends on the flip (sin first, then cos).
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10_000) -> torch.Tensor:
    """t: (B,) timesteps -> (B, dim) embedding in t.dtype."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    ).to(t.dtype)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
