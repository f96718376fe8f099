"""Parallelism of the port: data parallelism over processes (``mesh``).
Tensor and pipeline parallelism are not ported (``mesh.check_mesh``
refuses them)."""

from swift_torch.parallel.mesh import (
    all_reduce_mean,
    barrier,
    broadcast_from_rank0,
    build_kernels_first,
    check_mesh,
    local_rank,
    local_world_size,
    maybe_initialize_distributed,
    rank,
    rank_rows,
    world_size,
)

__all__ = [
    "all_reduce_mean",
    "barrier",
    "broadcast_from_rank0",
    "build_kernels_first",
    "check_mesh",
    "local_rank",
    "local_world_size",
    "maybe_initialize_distributed",
    "rank",
    "rank_rows",
    "world_size",
]
