"""The collectives of tensor parallelism that autograd sees (Megatron's pair).

Under a ``model`` axis each rank of a replica holds a slice of the
column-parallel weights (``to_qkv``, ``w1``: output rows) and of the
row-parallel ones (``wo``, ``w2``: input columns);
:mod:`swift_torch.parallel.sharding` has the rules. A block then runs

* :func:`copy_to_model` on its (replicated) input: the identity forward,
  the gradient summed over the model group backward, since each rank's
  column-parallel product gives only its slice's share of dx;
* the products on the local slices, with no communication between them;
* :func:`reduce_from_model` on the row-parallel product's output: each
  rank's partial sum summed over the model group forward, the identity
  backward.

Both are linear, so a forward-mode tangent (the sCM loss's jvp under
``torch.autograd.forward_ad``) takes the same collective as the primal
(``Function.jvp``). Sums run in fp32 and are cast back to the input's
dtype, as ``mesh.all_reduce_sum`` sums its buffers. The JAX package gets
the same psums from GSPMD (``swift_tpu/parallel/sharding.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from swift_torch.parallel.mesh import _comm_device


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group`` in fp32, in x's dtype and
    on x's device; ``x`` itself is not written."""
    flat = x.detach().to(torch.float32, copy=True).contiguous()
    flat = flat.to(_comm_device(flat))
    dist.all_reduce(flat, group=group)
    return flat.to(device=x.device, dtype=x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, dy):
        return sum_over(dy, ctx.group), None

    @staticmethod
    def jvp(ctx, dx, _):
        return dx.view_as(dx)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return sum_over(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, dy):
        return dy, None

    @staticmethod
    def jvp(ctx, dx, _):
        return sum_over(dx, ctx.group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` forward (and its tangent); its gradient summed over the model
    ``group`` backward. Goes on the input of a column-parallel product."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (and its tangent) summed over the model ``group``; the
    gradient passed through. Goes on the output of a row-parallel product."""
    return _ReduceFromModel.apply(x, group)
