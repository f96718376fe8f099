"""Parallelism of the port: data, tensor and pipeline parallelism over
processes (``mesh``: the process group, the data × model and data × pipe
layouts and the bucketed collectives; ``sharding``: which weights split
over the model axis; ``tensor``: the collectives autograd sees;
``pipeline``: pipeline-parallel prediction, the pair stack's stages on the
ranks of a data row, handing (h, cond) on by a ``broadcast`` over each
two-rank edge group). A model axis beside a pipe axis is not ported
(``mesh.check_mesh`` refuses it)."""

from swift_torch.parallel.mesh import (
    Layout,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_from_rank0,
    build_kernels_first,
    check_mesh,
    data_group,
    data_rank,
    data_size,
    init_layout,
    layout,
    local_rank,
    local_world_size,
    maybe_initialize_distributed,
    mesh_sizes,
    rank,
    rank_rows,
    world_size,
)

__all__ = [
    "Layout",
    "all_reduce_mean",
    "all_reduce_sum",
    "barrier",
    "broadcast_from_rank0",
    "build_kernels_first",
    "check_mesh",
    "data_group",
    "data_rank",
    "data_size",
    "init_layout",
    "layout",
    "local_rank",
    "local_world_size",
    "maybe_initialize_distributed",
    "mesh_sizes",
    "rank",
    "rank_rows",
    "world_size",
]
