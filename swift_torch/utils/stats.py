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

from swift_torch.parallel.mesh import rank, world_size


def sum_over_ranks(table: np.ndarray) -> np.ndarray:
    """``table`` summed over the ranks (every rank passes one of the same
    shape); the table itself for a process alone."""
    if world_size() == 1:
        return table
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.from_numpy(np.ascontiguousarray(table)).to(device)
    dist.all_reduce(t)
    return t.cpu().numpy()


def _bits_sum(t: torch.Tensor) -> int:
    """The sum of ``t``'s bit patterns, as integers: a checksum that any
    changed bit moves (barring changes that cancel)."""
    t = t.detach().contiguous().reshape(-1)
    if t.is_floating_point():
        t = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])
    return int(t.to(torch.int64).sum())


def check_replica_consistency(tensors: Iterable[torch.Tensor], name: str = "params") -> bool:
    """True when every rank holds the same bits in ``tensors`` (the same
    tensors in the same order on each rank); raises AssertionError naming
    the first tensor that differs. Each rank writes its checksums into its
    row of a (world, n) table that one ``all_reduce`` fills in on every
    rank. True at once for a process alone."""
    world = world_size()
    if world == 1:
        return True
    sums = [_bits_sum(t) for t in tensors]
    table = np.zeros((world, len(sums)), np.int64)
    table[rank()] = sums
    table = sum_over_ranks(table)
    differ = np.flatnonzero(~np.all(table == table[0], axis=0))
    if differ.size:
        raise AssertionError(f"replica mismatch in {name}: {differ.size} of {len(sums)} "
                             f"tensors differ across ranks (the first at index {differ[0]})")
    return True
