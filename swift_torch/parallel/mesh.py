"""The port's multi-process runtime: data parallelism over processes.

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
used, the collectives both backends run on CUDA tensors.
"""

from __future__ import annotations

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


def rank_rows(n_local: int) -> slice:
    """This rank's rows of a global batch of ``world_size() * n_local``
    rows: the global batch is the local batches concatenated in rank order
    (the JAX package's ``shard_batch``)."""
    r = rank()
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


def all_reduce_mean(tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor replaced, in place, by its mean over the ranks (summed in
    fp32 for floating tensors, then divided by the world size); a no-op for
    a process alone. Every rank ends with the same bits."""
    if world_size() == 1:
        return
    world = world_size()

    def reduce(flat):
        if not flat.is_floating_point():
            raise TypeError(f"all_reduce_mean of {flat.dtype} tensors")
        dist.all_reduce(flat)
        flat.div_(world)

    _collective(tensors, reduce)


def broadcast_from_rank0(tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor overwritten, in place, by rank 0's; a no-op for a process
    alone. Every rank passes the same tensors in the same order."""
    if world_size() == 1:
        return
    _collective(tensors, lambda flat: dist.broadcast(flat, src=0))


def check_mesh(cfg: dict) -> None:
    """Refuse a config whose ``system.mesh`` asks for tensor or pipeline
    parallelism (a ``model`` or ``pipe`` axis of another size than 1; -1,
    the remaining devices, counts as more): only data parallelism is
    ported."""
    mesh = (cfg.get("system") or {}).get("mesh") or {}
    axes = list(mesh.get("axes") or ["data"])
    sizes = list(mesh.get("sizes") or [-1] * len(axes))
    wide = [a for a, s in zip(axes, sizes) if a in ("model", "pipe") and int(s) != 1]
    if wide:
        raise NotImplementedError(
            f"tensor/pipeline parallelism is not ported yet: system.mesh asks for a "
            f"{'/'.join(wide)} axis (axes {axes}, sizes {sizes}); the port runs data "
            "parallelism only (one replica a process)")
