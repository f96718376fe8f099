"""Forward-mode (jvp) tangents through the kernel wrappers.

The port's own copy of ``swift_tpu/ops/jvp_guard.py``, for PyTorch's
forward AD (``torch.autograd.forward_ad`` dual tensors). A wrapper whose
kernel has a tangent route (qkv projection, block attention, SwiGLU FFN,
modnorm epilogue) unpacks its inputs (``forward_ad.unpack_dual``), runs the
primal and tangent kernels on the primals and tangents, and returns the
dual of the two (``forward_ad.make_dual``). Tangents flow only through the
activation operands: the one consumer, the sCM loss, differentiates w.r.t.
(x, t) with the parameters constant, so a tangent on a weight, on the
LayerNorm affine or on the logit scale raises (:func:`require_no_tangent`). A wrapper with no tangent route refuses any
dual input (:func:`refuse_tangents`) instead of dropping the tangent.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd import forward_ad


def tangent_of(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The forward-mode tangent of ``t``; None when it carries none."""
    return forward_ad.unpack_dual(t).tangent


def any_tangent(*tensors: torch.Tensor) -> bool:
    return any(tangent_of(t) is not None for t in tensors)


def materialize(tangent: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """A missing tangent is zero: densify it in ``like``'s shape and dtype."""
    if tangent is None:
        return torch.zeros_like(like)
    return tangent.to(like.dtype).contiguous()


def require_no_tangent(entry: str, **tensors: torch.Tensor) -> None:
    """Raise unless none of the named (parameter) tensors carries a tangent."""
    bad = [n for n, t in tensors.items() if tangent_of(t) is not None]
    if bad:
        raise NotImplementedError(
            f"{entry}: forward-mode tangents w.r.t. {bad} are not "
            f"implemented — this jvp-capable entry propagates tangents only "
            f"through activation operands (the sCM-loss contract: params "
            f"are constants under the jvp). Use the plain reference path for "
            f"parameter-tangent forward-mode differentiation."
        )


def refuse_tangents(entry: str, **tensors: torch.Tensor) -> None:
    """Raise if any input carries a tangent: ``entry`` has no tangent route."""
    bad = [n for n, t in tensors.items() if tangent_of(t) is not None]
    if bad:
        raise NotImplementedError(
            f"{entry}: {bad} carry forward-mode tangents, but this kernel has no "
            f"tangent route (the JAX package never runs a jvp through it); the "
            f"tangent would be dropped"
        )
