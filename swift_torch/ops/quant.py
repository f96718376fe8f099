"""Dynamic int8 quantization for the inference matmuls (``SwinV2(quant="int8")``).

Counterpart of ``swift_tpu/ops/quant.py``: symmetric abs-max quantization,
scale = max(amax, 1e-30) / 127 and q = clip(round(v / scale), ±127) with
round half to even (``torch.round``, as ``jnp.round``); activations get one
scale per row (token), weights one per output feature; the product
accumulates in int32 and is rescaled as (acc·sx)·sw in fp32, in that order.
These formulas are the JAX package's mirror (``quantize_rowwise``,
``quantize_colwise``, ``int8_matmul``), and on the CPU they agree with it
bit for bit.

Weights are in the torch ``nn.Linear`` layout (out, in), so the JAX
package's per-column scales of a (K, N) Dense kernel are per-row scales of
the (N, K) weight here. The qkv projection's int8 product stays outside any
kernel (the JAX package leaves it to XLA): :func:`int8_matmul` quantizes in
PyTorch and multiplies with ``torch._int_mm`` on the card as on the CPU
(on the card that needs more than 16 rows and K, N multiples of 8).
Inference-only, as in the JAX package: nothing here is meant to be
differentiated.
"""

from __future__ import annotations

import torch

_EPS = 1e-30


def quantize_rowwise(x: torch.Tensor):
    """(..., K) float -> (int8 (..., K), fp32 scales (..., 1)): symmetric
    per-row abs-max."""
    x = x.float()
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax, _EPS) / 127.0
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_colwise(w: torch.Tensor):
    """(N, K) float weight -> (int8 (N, K), fp32 scales (N,)): one scale per
    output feature, the JAX package's per-column scales of its (K, N)
    kernel."""
    q, scale = quantize_rowwise(w)
    return q, scale.reshape(-1)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dynamically quantized ``x @ w.T`` -> fp32. x: (..., K); w: (N, K).
    Both are quantized here (per-row and per-output-feature scales)."""
    return int8_matmul_quantized(x, *quantize_colwise(w))


def int8_matmul_quantized(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """:func:`int8_matmul` on a weight quantized already: wq (N, K) int8 and
    its scales sw (N,), as :func:`quantize_colwise` gives them; x is
    quantized per row here. The product is rescaled as (acc·sx)·sw."""
    lead = x.shape[:-1]
    xq, sx = quantize_rowwise(x.reshape(-1, x.shape[-1]))
    acc = torch._int_mm(xq, wq.t())
    return (acc.float() * sx * sw).reshape(*lead, wq.shape[0])
