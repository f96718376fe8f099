"""Tensor parallelism's parameter layout: which weights split over the
``model`` axis, how, and the way back to one process's layout.

Counterpart of ``swift_tpu/parallel/sharding.py:31-78`` (``_spec_for``
and ``swinv2_param_shardings``) on the port's torch names, where an
``nn.Linear`` weight is (out, in), the transpose of the Dense kernel:

* ``to_qkv`` and ``w1`` split by output rows (column-parallel);
* ``wo`` and ``w2`` split by input columns (row-parallel);
* everything else (embeddings, norms, modulation, the logit scales, the
  head) is replicated.

The qkv rows are heads-major ([q|k|v] of head 0, then head 1, ...), so a
contiguous row split is a split by heads; the port splits the attention
only where the heads divide over the axis (the JAX package's
``sharded_block_attention`` shards heads under that rule too), and the FFN
only where its hidden width does. Anything else stays replicated, as the
JAX rule replicates a tensor whose split dimension does not divide.

One departure in layout, not in function: the JAX package splits ``w1``'s
(in, 2·hidden) kernel contiguously, which puts the whole gate on the first
ranks and the whole up projection on the last, and leaves GSPMD to move
them. Here rank r holds rows ``[g_r ; u_r]``, the matching slices of gate
and up (:attr:`Shard.halves`), so that SwiGLU stays local.

:func:`module_shards` reads the rule off a network built with a model
axis (its blocks' ``param_shards``), the one place it is written;
:func:`shard_state_dict` slices one process's state dict by it, and its
inverse :func:`gather_state_dict` sums -0.0-padded shards over the model group (an
exact sum: ``mesh.all_reduce_sum``), so checkpoints keep one process's
layout and load on any layout.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from swift_torch.parallel import mesh

def attention_splits(heads: int, model_size: int) -> bool:
    """Whether an attention block's heads split over ``model_size`` ranks."""
    return model_size > 1 and heads % model_size == 0


def ffn_splits(hidden: int, model_size: int) -> bool:
    """Whether an FFN's hidden units split over ``model_size`` ranks."""
    return model_size > 1 and hidden % model_size == 0


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``size``'s slice of a weight of shape ``full``
    along ``dim`` (0: rows, 1: columns). ``halves``: the rows are two
    halves (w1's gate and up) and the slice is the rank's part of each."""
    full: tuple
    dim: int
    rank: int
    size: int
    halves: bool = False

    def _pieces(self) -> list[tuple[int, int]]:
        n = self.full[self.dim]
        if self.halves:
            h = n // 2
            part = h // self.size
            return [(i * h + self.rank * part, i * h + (self.rank + 1) * part) for i in (0, 1)]
        part = n // self.size
        return [(self.rank * part, (self.rank + 1) * part)]

    @property
    def shape(self) -> tuple:
        out = list(self.full)
        out[self.dim] //= self.size
        return tuple(out)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a tensor of shape ``full`` (a copy)."""
        return torch.cat([full.narrow(self.dim, a, b - a) for a, b in self._pieces()],
                         self.dim).contiguous()

    def place(self, part: torch.Tensor) -> torch.Tensor:
        """A tensor of shape ``full`` in fp32: ``part`` at this rank's slice,
        -0.0 elsewhere (summed over the ranks, the whole tensor exactly)."""
        out = torch.full(self.full, -0.0, dtype=torch.float32, device=part.device)
        offset = 0
        for a, b in self._pieces():
            out.narrow(self.dim, a, b - a).copy_(part.narrow(self.dim, offset, b - a))
            offset += b - a
        return out


def shard_state_dict(sd: Mapping[str, torch.Tensor],
                     shards: Mapping[str, Shard]) -> dict[str, torch.Tensor]:
    """One process's state dict -> this rank's: the tensors of ``shards``
    (a tensor-parallel network's :func:`module_shards`) sliced, the rest as
    they are."""
    return {n: shards[n].take(torch.as_tensor(v)) if n in shards else v for n, v in sd.items()}


def gather_state_dict(sd: Mapping[str, torch.Tensor], shards: Mapping[str, Shard],
                      group) -> dict[str, torch.Tensor]:
    """Inverse of :func:`shard_state_dict` on a model ``group``: one
    process's state dict, on every rank of the group. Each split tensor's
    slice is placed in -0.0 and summed exactly in fp32 over the group, then
    cast to its dtype; the rest pass as they are. A collective: every rank
    of the group passes the same names."""
    whole = {n: shards[n].place(t) for n, t in sd.items() if n in shards}
    mesh.all_reduce_sum(list(whole.values()), group)
    return {n: whole[n].to(t.dtype) if n in whole else t for n, t in sd.items()}


def module_shards(net: torch.nn.Module) -> dict[str, Shard]:
    """{parameter name: Shard} of a network built with a model axis: what
    each tensor-parallel block (``models.swinv2``'s ``WindowAttention``,
    ``FeedForward``) holds a slice of."""
    out = {}
    for prefix, module in net.named_modules():
        for name, shard in getattr(module, "param_shards", dict)().items():
            out[f"{prefix}.{name}" if prefix else name] = shard
    return out


def sliced_params(net: torch.nn.Module) -> list[str]:
    """Names of the replicated parameters that the split blocks use on
    their rank's slice only (each attention block's per-head logit scale):
    their gradients are summed over the model group."""
    out = []
    for prefix, module in net.named_modules():
        for name in getattr(module, "sliced_params", tuple)():
            out.append(f"{prefix}.{name}" if prefix else name)
    return out
