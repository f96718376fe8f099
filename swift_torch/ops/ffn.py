"""SwiGLU feed-forward ``(silu(x·Wg) ⊙ x·Wu)·W2`` (kernel 5).

CUDA kernel: ``csrc/ffn.cu::swift_ffn``, which replaces
``swift_tpu/ops/pallas_ffn.py::_ffn_call``; the (tokens, 2·hidden) gate/up
intermediate never reaches device memory. Weights are in the torch
``nn.Linear`` layout: ``w1`` (2H, D) with the gate rows first and the up
rows second (the reference chunk order), ``w2`` (D, H).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from swift_torch.ops import _build


def reference_swiglu_ffn(x, w1, w2):
    """Plain version: gate and up accumulate in fp32, h = silu(g)·u is
    rounded to x.dtype before h·W2 (fp32 accumulation); output x.dtype."""
    H = w2.shape[1]
    gu = torch.matmul(x.float(), w1.float().t())
    h = (F.silu(gu[..., :H]) * gu[..., H:]).to(x.dtype)
    return torch.matmul(h.float(), w2.float().t()).to(x.dtype)


def fused_swiglu_ffn(x, w1, w2):
    """x: (..., D); w1: (2H, D); w2: (D, H). Returns (..., D) in x.dtype.

    CPU tensors take :func:`reference_swiglu_ffn`; CUDA tensors must be bf16
    with D % 16 == 0 and H % 8 == 0."""
    if _build.on_cpu(x, w1, w2):
        return reference_swiglu_ffn(x, w1, w2)
    name = "fused_swiglu_ffn"
    _build.check_kernel_inputs(name, x=x, w1=w1, w2=w2)
    _build.check_dtype(name, torch.bfloat16, x=x, w1=w1, w2=w2)
    D = x.shape[-1]
    H = w2.shape[1]
    if w1.shape != (2 * H, D) or w2.shape != (D, H):
        raise ValueError(
            f"{name}: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not match D={D}"
        )
    if D % 16 or H % 8:
        raise ValueError(f"{name}: D={D} must be a multiple of 16 and H={H} of 8")
    lib = _build.library()
    if lib.swift_ffn_smem(D) > lib.swift_max_smem():
        raise ValueError(f"{name}: D={D} needs more shared memory than a block has")
    M = x.numel() // D
    y = torch.empty_like(x)
    _build.check_launch(
        lib.swift_ffn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(), M, D, H,
                      _build.stream()),
        name,
    )
    fused_swiglu_ffn.launches += 1
    return y


fused_swiglu_ffn.launches = 0
