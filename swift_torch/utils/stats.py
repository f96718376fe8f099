"""Statistics summed across processes, and the replicas' agreement.

Counterpart of ``swift_tpu/utils/stats.py``: :func:`sum_over_ranks` sums a
packed host table (sums and counts) over the ranks by one ``all_reduce`` (the JAX
package's ``Collector`` gathers its moments with ``process_allgather``;
the port's trainer averages its one logged loss with
``parallel.all_reduce_mean`` and needs no collector).
:func:`check_replica_consistency` checks that tensors every rank should
hold alike (parameters, EMA, optimizer state) are bit for bit the same.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from swift_torch.parallel.mesh import group_size, rank


def sum_over_ranks(table: np.ndarray, group=None) -> np.ndarray:
    """``table`` summed over the ranks of ``group`` (every rank by default;
    each passes one of the same shape); the table itself for a group of
    one."""
    if group_size(group) == 1:
        return table
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.from_numpy(np.ascontiguousarray(table)).to(device)
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def _bits_sum(t: torch.Tensor) -> int:
    """The sum of ``t``'s bit patterns, as integers: a checksum that any
    changed bit moves (barring changes that cancel)."""
    t = t.detach().contiguous().reshape(-1)
    if t.is_floating_point():
        t = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])
    return int(t.to(torch.int64).sum())


def check_replica_consistency(tensors: Iterable[torch.Tensor], name: str = "params",
                              group=None) -> bool:
    """True when every rank of ``group`` (every rank by default) holds the
    same bits in ``tensors`` (the same tensors in the same order on each
    rank); raises AssertionError naming the first tensor that differs. Each
    rank writes its checksums into its row of a (group size, n) table that
    one ``all_reduce`` fills in on every rank. True at once for a group of
    one."""
    world = group_size(group)
    if world == 1:
        return True
    sums = [_bits_sum(t) for t in tensors]
    table = np.zeros((world, len(sums)), np.int64)
    table[rank() if group is None else dist.get_group_rank(group, rank())] = sums
    table = sum_over_ranks(table, group)
    differ = np.flatnonzero(~np.all(table == table[0], axis=0))
    if differ.size:
        raise AssertionError(f"replica mismatch in {name}: {differ.size} of {len(sums)} "
                             f"tensors differ across ranks (the first at index {differ[0]})")
    return True
