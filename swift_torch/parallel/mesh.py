"""The port's multi-process runtime: data, tensor and pipeline parallelism
over processes.

Counterpart of ``swift_tpu/parallel/mesh.py``. The JAX package shards the
global batch over a ``data`` mesh axis and lets XLA insert the gradient
reduction; here each process (rank) holds a full replica of the network,
loads its own rows of the global batch and averages the gradients with an
explicit ``all_reduce``. The global batch is the ranks' local batches
concatenated in rank order, as JAX's global array is the processes' local
batches concatenated in process order (``shard_batch``).

Launch lines (the same env contracts as the JAX package's and torchrun's):

* ``torchrun --nproc_per_node N -m swift_torch.train ...``: ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``;
* ``SWIFT_COORDINATOR=host:port SWIFT_NUM_PROCESSES=N SWIFT_PROCESS_ID=i
  python -m swift_torch.train ...``, one process a rank on one host (a
  ``LOCAL_RANK`` beside them names the process's card on a host of many).

``SWIFT_NO_DIST_INIT`` keeps a process alone. The backend is ``nccl`` for
CUDA and ``gloo`` for the CPU unless ``SWIFT_DIST_BACKEND`` names one;
``SWIFT_SHARE_DEVICE=1`` lets more ranks than cards share them
(``utils.device.resolve_device``), which needs ``gloo``: NCCL refuses two
ranks on one device. Only ``all_reduce``, ``broadcast`` and ``barrier`` are
used, the collectives both backends run on CUDA tensors; the pipeline's
stage-to-stage transfers are broadcasts over two-rank groups.

Tensor parallelism (``system.mesh`` axes ``[data, model]``, the JAX
package's ``make_mesh`` order: ``model`` varies fastest, so rank = data
index × model size + model index) is a :class:`Layout` that
:func:`init_layout` sets: one process group a data row (the ranks that
split one replica's matrices, ``Layout.model_group``) and one a model
column (the ranks that hold the same shards of different batch rows,
:func:`data_group`). Without it every rank is a data rank. The batch goes
by the data index (:func:`data_rank`, :func:`rank_rows`); the model ranks
of a row load the same rows and draw the same noise.

Pipeline parallelism (axes ``[data, pipe]``, ``make_mesh(("data",
"pipe"), (-1, S))``'s order: rank = data index × S + stage) lays the ranks
out alike: a data row's S ranks are one replica's stages
(``Layout.pipe_group``; ``Layout.prev_group`` and ``next_group``, the
two-rank groups of the edges to the neighbouring stages, carry
``parallel.pipeline``'s transfers), a pipe column the data ranks of one
stage. A model axis and a pipe axis together are not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

# a flat buffer's elements: 64 Mi fp32 values (256 MiB), so the flagship's
# 226 M gradients go in four collectives
BUCKET_ELEMS = 1 << 26


def _launch() -> Optional[tuple[str, int, int]]:
    """(init method, world size, rank) that the launcher's environment
    names, or None for a process alone."""
    env = os.environ
    if env.get("SWIFT_NO_DIST_INIT"):
        return None
    if env.get("SWIFT_COORDINATOR") and env.get("SWIFT_NUM_PROCESSES"):
        return (f"tcp://{env['SWIFT_COORDINATOR']}", int(env["SWIFT_NUM_PROCESSES"]),
                int(env.get("SWIFT_PROCESS_ID", 0)))
    if env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        return "env://", int(env["WORLD_SIZE"]), int(env.get("RANK", 0))
    return None


def maybe_initialize_distributed(device: torch.device | str = "cuda") -> bool:
    """Start the default process group when the launcher asked for more than
    one process; True when one is up. A no-op for a process alone, and
    idempotent. ``device`` (the entry point's) picks the backend: ``nccl``
    for CUDA, ``gloo`` for the CPU, unless ``SWIFT_DIST_BACKEND`` names one."""
    if dist.is_initialized():
        return True
    launch = _launch()
    if launch is None or launch[1] <= 1:
        return False
    init_method, world, rank_ = launch
    backend = os.environ.get("SWIFT_DIST_BACKEND") or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK``, or
    its rank (one host)."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    launch = _launch()
    return launch[2] if launch is not None else rank()


def local_world_size() -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE``, or all of them (one
    host)."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    launch = _launch()
    return launch[1] if launch is not None else world_size()


@dataclasses.dataclass(frozen=True)
class Layout:
    """The data × model (or data × pipe) rank layout: this rank's indices on
    the axes and their process groups. ``data_group`` None is every rank
    (no model or pipe axis); ``model_group`` None means the model axis has
    size 1 and no collective runs over it. Under a pipe axis
    ``pipe_group`` holds the stages of this rank's replica, and
    ``prev_group``/``next_group`` this stage and the one before/after it
    (None at the first/last stage)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    pipe: int = 1
    pipe_rank: int = 0
    pipe_group: Optional[object] = None
    prev_group: Optional[object] = None
    next_group: Optional[object] = None


_LAYOUT: Optional[Layout] = None
# an inner axis's size -> (the data rows' groups, the columns'), and
# ("edges", S) -> each row's groups of stages (s, s + 1); made once
_GROUPS: dict = {}


def mesh_sizes(cfg: dict, world: int) -> tuple[int, int, int]:
    """(data, model, pipe) sizes of ``system.mesh`` over ``world`` ranks;
    -1 is the ranks that remain. Refuses a model axis beside a pipe axis
    (:func:`check_mesh`) and sizes that do not multiply to the world."""
    check_mesh(cfg)
    axes, sizes = _mesh(cfg)
    if any(a not in ("data", "model", "pipe") for a in axes) or len(sizes) != len(axes):
        raise ValueError(f"system.mesh: axes {axes}, sizes {sizes}; the port knows the data, "
                         "model and pipe axes")
    if sizes.count(-1) > 1:
        raise ValueError(f"system.mesh sizes {sizes}: at most one -1")
    fixed = 1
    for s in sizes:
        fixed *= 1 if s == -1 else s
    got = dict(zip(axes, (world // fixed if s == -1 else s for s in sizes)))
    data, model, pipe = got.get("data", 1), got.get("model", 1), got.get("pipe", 1)
    if min(data, model, pipe) < 1 or data * model * pipe != world:
        raise ValueError(f"system.mesh (axes {axes}, sizes {sizes}) does not fit {world} "
                         "rank(s)")
    return data, model, pipe


def _groups(inner: int):
    """Every data row's and every column's process group for an inner
    (model or pipe) axis of ``inner`` ranks, made by every rank in one
    order (``dist.new_group`` is collective)."""
    if inner not in _GROUPS:
        world = world_size()
        rows = [dist.new_group(list(range(d * inner, (d + 1) * inner)))
                for d in range(world // inner)]
        cols = [dist.new_group(list(range(m, world, inner))) for m in range(inner)]
        _GROUPS[inner] = rows, cols
    return _GROUPS[inner]


def _edges(stages: int):
    """Each data row's two-rank groups of stages (s, s + 1): the row's own
    group for two stages, else new groups, made by every rank in one
    order."""
    key = ("edges", stages)
    if key not in _GROUPS:
        rows, _ = _groups(stages)
        if stages == 2:
            _GROUPS[key] = [[row] for row in rows]
        else:
            _GROUPS[key] = [[dist.new_group([d * stages + s, d * stages + s + 1])
                             for s in range(stages - 1)] for d in range(len(rows))]
    return _GROUPS[key]


def init_layout(model: int = 1, pipe: int = 1) -> Layout:
    """Set this process's layout: ``model`` (or ``pipe``) consecutive ranks
    a replica, the world over that the data size. Both 1 is data
    parallelism over every rank and makes no group; any other size makes
    the groups of every row and column (a collective: every rank calls it
    with the same sizes). A model and a pipe axis together raise."""
    global _LAYOUT
    world, r = world_size(), rank()
    if model > 1 and pipe > 1:
        raise NotImplementedError("a model axis and a pipe axis together are not ported (the "
                                  f"mesh asks for model {model} x pipe {pipe})")
    for axis, n in (("model", model), ("pipe", pipe)):
        if n < 1 or world % n:
            raise ValueError(f"a {axis} axis of {n} does not divide {world} rank(s)")
    if model == 1 and pipe == 1:
        _LAYOUT = Layout(world, 1, r, 0)
    elif model > 1:
        rows, cols = _groups(model)
        data = world // model
        _LAYOUT = Layout(data, model, r // model, r % model, cols[r % model], rows[r // model])
    else:
        rows, cols = _groups(pipe)
        edges = _edges(pipe)[r // pipe]
        s = r % pipe
        _LAYOUT = Layout(world // pipe, 1, r // pipe, 0, cols[s], pipe=pipe, pipe_rank=s,
                         pipe_group=rows[r // pipe], prev_group=edges[s - 1] if s else None,
                         next_group=edges[s] if s < pipe - 1 else None)
    return _LAYOUT


def layout() -> Layout:
    """The layout :func:`init_layout` set, else data parallelism over every
    rank."""
    if _LAYOUT is None or _LAYOUT.data * _LAYOUT.model * _LAYOUT.pipe != world_size():
        return Layout(world_size(), 1, rank(), 0)
    return _LAYOUT


def data_rank() -> int:
    return layout().data_rank


def data_size() -> int:
    return layout().data


def data_group():
    """The ranks that hold this rank's shards or stage (None: every rank,
    when there is no model or pipe axis)."""
    return layout().data_group


def rank_rows(n_local: int) -> slice:
    """This rank's rows of a global batch of ``data_size() * n_local``
    rows: the global batch is the data ranks' local batches concatenated in
    data-rank order (the JAX package's ``shard_batch``); the model (or
    pipe) ranks of a row hold the same rows."""
    r = data_rank()
    return slice(r * n_local, (r + 1) * n_local)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def build_kernels_first(device: torch.device) -> None:
    """Under data parallelism on CUDA, rank 0 builds the kernel library
    (when no current build exists) while the other ranks wait at a barrier,
    so they load its build and compile nothing. A process alone builds at
    first use."""
    if world_size() == 1 or device.type != "cuda":
        return
    from swift_torch.ops import _build  # imported here: the kernels' modules import this one

    if rank() == 0:
        _build.build()
    barrier()


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a buffer of ``t`` goes through the collective: NCCL reduces on
    the card only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _buckets(tensors: list[torch.Tensor]):
    """Consecutive runs of ``tensors`` of at most ``BUCKET_ELEMS`` elements
    (a larger tensor alone), each of one device and one kind: floating
    tensors go through fp32 buffers (exact for bf16 and fp16), others
    through buffers of their own dtype."""
    bucket, size, key = [], 0, None
    for t in tensors:
        k = (t.device, torch.float32 if t.is_floating_point() else t.dtype)
        if bucket and (k != key or size + t.numel() > BUCKET_ELEMS):
            yield key[1], bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
        key = k
    if bucket:
        yield key[1], bucket


def _collective(tensors: Iterable[torch.Tensor], op) -> None:
    for dtype, bucket in _buckets([t for t in tensors if t.numel()]):
        flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in bucket])
        flat = flat.to(_comm_device(flat))
        op(flat)
        offset = 0
        for t in bucket:
            t.detach().copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def group_size(group=None) -> int:
    """The ranks of ``group`` (None: every rank; 1 for a process alone)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def all_reduce_sum(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Each tensor replaced, in place, by its sum over ``group`` (summed in
    fp32 for floating tensors); a no-op for a group of one. Every rank of
    the group ends with the same bits. Exact where at most one rank holds
    a value other than -0.0 in each element (x + -0.0 is x for every x):
    the gathers of :mod:`swift_torch.parallel.sharding` pad with -0.0."""
    if group_size(group) == 1:
        return
    _collective(tensors, lambda flat: dist.all_reduce(flat, group=group))


def all_reduce_mean(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Each tensor replaced, in place, by its mean over ``group`` (every
    rank by default; summed in fp32 for floating tensors, then divided by
    the group's size); a no-op for a group of one. Every rank of the group
    ends with the same bits."""
    n = group_size(group)
    if n == 1:
        return

    def reduce(flat):
        if not flat.is_floating_point():
            raise TypeError(f"all_reduce_mean of {flat.dtype} tensors")
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _collective(tensors, reduce)


def broadcast_from_rank0(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Each tensor overwritten, in place, by the first rank's of ``group``
    (rank 0 by default); a no-op for a group of one. Every rank of the
    group passes the same tensors in the same order."""
    if group_size(group) == 1:
        return
    src = 0 if group is None else dist.get_global_rank(group, 0)
    _collective(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


def _mesh(cfg: dict) -> tuple[list, list]:
    mesh = (cfg.get("system") or {}).get("mesh") or {}
    axes = list(mesh.get("axes") or ["data"])
    return axes, [int(s) for s in (mesh.get("sizes") or [-1] * len(axes))]


def check_mesh(cfg: dict) -> None:
    """Refuse a config whose ``system.mesh`` asks for a model axis and a
    pipe axis together (each of another size than 1; -1, the remaining
    devices, counts as more): tensor within pipeline parallelism is not
    ported. Data, model and pipe axes each pass."""
    axes, sizes = _mesh(cfg)
    big = {a for a, s in zip(axes, sizes) if s != 1}
    if {"model", "pipe"} <= big:
        raise NotImplementedError(
            f"system.mesh asks for a model axis and a pipe axis together (axes {axes}, sizes "
            f"{sizes}): not ported; the port runs data x model or data x pipe")
