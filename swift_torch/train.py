"""Training entry point of the port:
``python -m swift_torch.train experiment=... [k=v ...] [--device cuda|cpu]``.

Counterpart of ``swift_tpu/train.py`` (reference src/swift/train.py:135-346):
the same Hydra-style overrides over the same config tree, the same run-dir
layout (``results/<experiment>/<run-id>`` with the composed config in
``.hydra/config.yaml``) and the same resume flow. It runs on the GPU unless
``--device cpu`` asks for the CPU, and raises where CUDA is absent. With no
overrides it trains the default experiment, ``era5-swinv2-1.4-scm``
(SwinV2 + PassPrecond + SCMLoss + Muon with aux-Adam); EDMPrecond with
EDMLoss, TrigFlowLoss and Adam/AdamW are ported too, all on one device.
A config with ``trainer.val_ticks`` validates online on the data's val
split (``val_local_batch_size`` initial conditions a tick), or logs that it
has none and trains without.

``finetune=multistep resume=<run>`` fine-tunes a run (reference
train.py:74-96): the resumed config takes the fine-tune's loss (CRPSLoss),
optimizer (AdamW at 1e-5) and interval schedule, its ``total_kimg`` grows
by the intervals' kimg, the cosine anneal is off, checkpoints every 200
ticks and validation every 50; batches share one Δ
(``DeltaBatchSampler``) and carry the forcings of every unrolled step. A
fine-tune without ``resume`` returns 1. ``distill=<run>`` on an sCM
experiment distils that run's latest EMA, frozen, into the student
(reference train.py:102-132).

Data parallelism (the JAX package's multi-process runtime, its
``train.py:119-197``): launched as N processes, by ``torchrun
--nproc_per_node N -m swift_torch.train ...`` or by the JAX package's
``SWIFT_COORDINATOR``/``SWIFT_NUM_PROCESSES``/``SWIFT_PROCESS_ID`` env
(``swift_torch.parallel``), each rank loads every N-th item of the shared
sample stream, ``data.batch_size / N`` a step, and the ranks average their
gradients, so N processes do the work of one on the global batch. Rank 0's
parameters, EMA and optimizer state are broadcast once after the build or
resume, and checked to agree; rank 0 writes the run's files.

Tensor parallelism (``system=tpu-tp``: ``system.mesh`` axes ``[data,
model]``, sizes ``[-1, 2]``; the JAX package's ``train.py:216-226`` and
``:312-320``): the ranks form a data × model layout
(``parallel.mesh.init_layout``, ``model`` varying fastest); the model
ranks of a data row split one replica's attention heads and FFN hidden
units (``parallel.sharding``), load the same rows and draw the same
noise, and the data ranks average their gradients as above. The network is
built (and converted or loaded) in one process's layout and then sliced;
checkpoints are gathered back into that layout, so a run resumes and
forecasts (``generate``) on any layout. ``system=...`` given with
``resume=`` sets the resumed run's layout.

A pipe axis (``system=tpu-pp``: axes ``[data, pipe]``, sizes ``[-1, 2]``)
trains as the JAX package's ``train.py:157-183`` does: not pipelined. The
stage ranks of a data row hold the whole network, load the same rows and
take the same step, and the data ranks average their gradients; the saved
config keeps ``system.mesh``, from which ``generate`` takes the pipe axis.
A model axis beside a pipe axis raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
from datetime import datetime

import numpy as np
import torch

from swift_torch import config as cfglib
from swift_torch import factory
from swift_torch.data.pipeline import BatchLoader
from swift_torch.data.samplers import DeltaBatchSampler, InfiniteSampler
from swift_torch.parallel.mesh import (
    broadcast_from_rank0,
    build_kernels_first,
    data_rank,
    data_size,
    init_layout,
    maybe_initialize_distributed,
    mesh_sizes,
    world_size,
)
from swift_torch.training.trainer import Trainer, swin_flop_count
from swift_torch.utils.checkpoint import get_ckpt_num, latest_checkpoint, load_checkpoint
from swift_torch.utils.device import resolve_device
from swift_torch.utils.log import is_main_process, log0
from swift_torch.utils.stats import check_replica_consistency


def string_to_int(s: str) -> int:
    return int(hashlib.sha256(s.encode("utf-8")).hexdigest(), 16) % (1 << 31)


def split_device(argv: list[str]) -> tuple[str, list[str]]:
    """(device, the config overrides) from ``--device X`` / ``--device=X``."""
    device, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


class FinetuneWithoutResume(Exception):
    """A fine-tune was asked for without a run to resume."""


def resume_setup(cfg: dict, run_dir: str):
    """Reload a prior run's config and latest checkpoint (reference
    train.py:44-99); a fine-tune overlays its loss, optimizer and schedule
    and extends ``total_kimg`` (the JAX package's ``resume_setup``)."""
    if cfg.get("resume") is None:
        return cfg, None
    finetune = cfg.get("finetune")
    prev = cfg["resume"]
    if not os.path.isdir(prev):
        prev = os.path.join(os.path.dirname(run_dir), cfg["resume"])
    if not os.path.isdir(prev):
        raise FileNotFoundError(f"{prev} is not a directory")
    prev_cfg = cfglib.load_config(os.path.join(prev, ".hydra", "config.yaml"))
    ckpt = latest_checkpoint(os.path.join(prev, "checkpoints"))
    if not ckpt:
        raise FileNotFoundError(f"No checkpoints in {os.path.join(prev, 'checkpoints')}")
    if is_main_process():
        src, dst = os.path.join(prev, ".hydra"), os.path.join(run_dir, ".hydra")
        if os.path.isdir(src) and not os.path.samefile(os.path.dirname(src),
                                                       os.path.dirname(dst)):
            shutil.copytree(src, dst, dirs_exist_ok=True)
    # run-control flags always come from the current invocation
    for key in ("dry_run", "resume", "distill"):
        if key in cfg:
            prev_cfg[key] = cfg[key]
    if finetune is not None:
        for key in ("loss", "optimizer", "finetune"):
            if key in cfg:
                prev_cfg[key] = cfg[key]
        if finetune.get("name") == "multistep":
            tcfg = prev_cfg["trainer"]
            tcfg["total_kimg"] = get_ckpt_num(ckpt) + sum(
                iv["kimg"] for iv in finetune.get("intervals", []))
            tcfg["lr_cosine_anneal"] = False
            tcfg["checkpoint_ticks"] = 200
            tcfg["val_ticks"] = 50
        if is_main_process():
            cfglib.save_config(prev_cfg, os.path.join(run_dir, ".hydra", "config.yaml"))
    log0(f"Resuming from {ckpt}")
    return prev_cfg, ckpt


def distill_setup(cfg: dict, dataset, device=None):
    """The frozen teacher of ``distill=<run dir>`` (reference
    train.py:102-132): the run's own network config, its latest
    checkpoint's EMA weights, on ``device``, in eval mode and without
    gradients; None without ``distill``. An sCM loss in ``cfg`` is set to
    distil (``loss.distillation``)."""
    if cfg.get("distill") is None:
        return None
    if cfg["loss"]["_target_"].endswith("SCMLoss"):
        cfg["loss"]["distillation"] = True
    run_dir = cfg["distill"]
    tcfg = cfglib.load_config(os.path.join(run_dir, ".hydra", "config.yaml"))
    ckpt = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    if not ckpt:
        raise FileNotFoundError(f"No checkpoints in {os.path.join(run_dir, 'checkpoints')}")
    log0(f"Loading distillation model: {ckpt}")
    teacher = factory.build_precond(tcfg["precond"], tcfg["model"], dataset.img_resolution,
                                    dataset.n_target_channels, dataset.n_condition_channels)
    teacher.load_state_dict(load_checkpoint(ckpt))
    return teacher.to(device).eval().requires_grad_(False)


def launch_run_id() -> str:
    """``RUN_ID``, or rank 0's clock as ``%Y%m%d_%H%M%S`` (broadcast, so the
    ranks' run directories and seeds agree)."""
    if os.environ.get("RUN_ID"):
        return os.environ["RUN_ID"]
    stamp = torch.tensor([int(datetime.now().strftime("%Y%m%d%H%M%S"))])
    broadcast_from_rank0([stamp])
    return datetime.strptime(str(int(stamp)), "%Y%m%d%H%M%S").strftime("%Y%m%d_%H%M%S")


def replicated_state(trainer: Trainer) -> list[torch.Tensor]:
    """The tensors every rank holds alike: parameters, buffers, the EMA and
    the optimizer state, in one order on every rank."""
    state = list(trainer.net.state_dict().values())
    state += [trainer.ema[n] for n in trainer.params]
    for group in trainer.optimizer.param_groups:
        for p in group["params"]:
            st = trainer.optimizer.state.get(p, {})
            state += [torch.as_tensor(st[k]) for k in sorted(st)
                      if isinstance(st[k], torch.Tensor)]
    return state


def setup(argv, dataset=None) -> tuple[Trainer, BatchLoader, dict]:
    """Compose the config and build (trainer, loader, config) as ``main``
    runs them; a resume restores the trainer's state here. ``dataset``,
    when given, stands in for the training split the data config names (an
    in-memory ``SyntheticERA5`` where h5py is absent). Under data
    parallelism the process group starts here and the loader serves this
    rank's rows."""
    device_name, overrides = split_device(list(argv))
    maybe_initialize_distributed(device_name)
    device = resolve_device(device_name)
    cfg = cfglib.compose("train", overrides)
    mesh_sizes(cfg, world_size())  # model beside pipe, or sizes that do not fit, raise here
    build_kernels_first(device)

    run_id = launch_run_id()
    run_dir = os.path.join("results", cfg["experiment_name"], run_id)
    if is_main_process():
        os.makedirs(run_dir, exist_ok=True)
        cfglib.save_config(cfg, os.path.join(run_dir, ".hydra", "config.yaml"))
    log0(f"Results directory: {run_dir} (device {device})")

    system = cfg.get("system")
    cfg, ckpt = resume_setup(cfg, run_dir)
    if ckpt is not None and any(ov.startswith("system=") for ov in overrides):
        cfg["system"] = system  # this invocation's layout over the resumed run's
    _, model, pipe = mesh_sizes(cfg, world_size())
    lay = init_layout(model, pipe)
    world = lay.data
    if ckpt is not None:
        # explicit CLI value overrides still win on top of the resumed config
        for ov in overrides:
            key, _, raw = ov.partition("=")
            key = key.lstrip("+")
            if raw and "." in key or key in ("seed", "dry_run"):
                cfglib._set_path(cfg, key, cfglib._parse_value(raw))
    if cfg.get("finetune") is not None and ckpt is None:
        raise FinetuneWithoutResume("must have resume path to finetune")

    seed = int(cfg["seed"]) + string_to_int(run_id)
    # numpy's stream a data rank (the JAX package's), torch's shared: the
    # net's initial weights and the losses' draws are alike on every rank
    np.random.seed((seed * world + lay.data_rank) % (1 << 31))
    torch.manual_seed(seed)

    if dataset is None:
        log0("Loading dataset...")
        dataset = factory.build_dataset(cfg["data"])
    sampler = InfiniteSampler(dataset, rank=lay.data_rank, num_replicas=world, shuffle=True,
                              seed=seed)
    global_batch = int(cfg["data"]["batch_size"])
    if global_batch % world:
        raise ValueError(f"data.batch_size={global_batch} does not divide over {world} data "
                         "ranks")
    local_batch = global_batch // world
    finetune = cfg.get("finetune")
    batch_sampler, multistep_steps = None, 0
    if finetune is not None:
        # the shared seed: every rank draws the step's Δ and unroll alike
        batch_sampler = DeltaBatchSampler(sampler, local_batch, dataset.intervals, seed=seed)
        multistep_steps = max(iv["steps"] for iv in finetune.get("intervals", [{"steps": 1}]))
    loader = BatchLoader(dataset, sampler, local_batch,
                         num_workers=int(cfg["data"].get("data_workers", 4)),
                         multistep_forcings=multistep_steps, batch_sampler=batch_sampler)

    log0("Constructing network...")
    net = factory.build_precond(cfg["precond"], cfg["model"], dataset.img_resolution,
                                dataset.n_target_channels, dataset.n_condition_channels,
                                layout=lay)
    net = net.to(device).train()

    log0("Constructing loss function...")
    teacher = distill_setup(cfg, dataset, device)
    loss_fn = factory.build_loss(cfg["loss"], dataset)

    log0("Constructing optimizer...")
    tcfg = cfg["trainer"]
    resume_kimg = get_ckpt_num(ckpt) if ckpt else 0
    optimizer, lr_fn = factory.build_optimizer(cfg["optimizer"], tcfg, global_batch, net,
                                               resume_kimg=resume_kimg, layout=lay)
    flop_count = swin_flop_count(
        dataset.img_resolution, global_batch, int(cfg["model"]["depth"]),
        dataset.n_target_channels + dataset.n_condition_channels, int(cfg["model"]["dim"]),
        int(8 / 3.0 * int(cfg["model"]["dim"])), tuple(cfg["model"]["patch_size"]),
        tuple(cfg["model"]["window_size"]),
    )
    trainer = Trainer(
        net, optimizer, loss_fn,
        global_batch_size=global_batch,
        lr_fn=lr_fn,
        total_kimg=float(tcfg["total_kimg"]),
        ema_halflife_kimg=float(tcfg.get("ema_halflife_kimg", 500)),
        ema_rampup_ratio=tcfg.get("ema_rampup_ratio", 0.05),
        kimg_per_tick=float(tcfg.get("kimg_per_tick", 50)),
        checkpoint_ticks=tcfg.get("checkpoint_ticks"),
        val_ticks=tcfg.get("val_ticks"),
        val_target_interval=int(tcfg.get("val_target_interval", 56)),
        val_variables=tcfg.get("val_variables"),
        val_crps_members=int(tcfg.get("val_crps_members", 0) or 0),
        solver_kwargs=cfg.get("solver"),
        run_dir=run_dir,
        ckpt=ckpt,
        flop_count=flop_count,
        seed=seed,
        grad_accum=int(tcfg.get("grad_accum", 1) or 1),
        finetune_kwargs=finetune,
        teacher=teacher,
        profile=bool(tcfg.get("profile", False)),
    )
    if world > 1:
        state = replicated_state(trainer)
        broadcast_from_rank0(state, lay.data_group)
        check_replica_consistency(state, "parameters, EMA and optimizer state", lay.data_group)
        log0(f"Data parallel over {world} ranks: {local_batch} of the global batch of "
             f"{global_batch} a rank; the replicas agree")
    if lay.model > 1:
        shards = trainer.shards
        check_replica_consistency(
            [p for n, p in trainer.params.items() if n not in shards],
            "the replicated parameters", lay.model_group)
        log0(f"Tensor parallel over {lay.model} ranks a replica ({world} replicas): "
             f"{len(shards)} weights split, the other {len(trainer.params) - len(shards)} "
             "parameters replicated and alike")
    if lay.pipe > 1:  # the JAX package's train: the stage ranks repeat the step
        state = replicated_state(trainer)
        broadcast_from_rank0(state, lay.pipe_group)
        check_replica_consistency(state, "parameters, EMA and optimizer state", lay.pipe_group)
        log0(f"Pipe axis of {lay.pipe} ranks a replica ({world} replicas): training is not "
             "pipelined; the stage ranks of a replica take the same step")
    return trainer, loader, cfg


def rollout_batches(val_dataset, batch_size: int, seed: int):
    """``val_batches()``: an iterator of (X, TS, idx), ``batch_size``
    rollout items of ``val_dataset`` at a time from an ``InfiniteSampler``
    strided by data rank."""
    val_sampler = InfiniteSampler(val_dataset, rank=data_rank(), num_replicas=data_size(),
                                  seed=seed)

    def val_batches():
        it = iter(val_sampler)
        while True:
            idxs = [next(it) for _ in range(batch_size)]
            samples = [val_dataset[i] for i in idxs]
            yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]),
                   np.asarray(idxs))

    return val_batches


def validation(cfg: dict, seed: int):
    """(val_batches, val_dataset) of the data's val split for a config with
    ``trainer.val_ticks`` (``val_local_batch_size`` items a batch), else
    (None, None). Without a val split validation is disabled, with a log
    line."""
    tcfg = cfg["trainer"]
    if tcfg.get("val_ticks") is None:
        return None, None
    try:
        val_dataset = factory.build_rollout_dataset(
            cfg["data"], int(tcfg.get("val_target_interval", 56)), split="val")
        val_batches = rollout_batches(val_dataset, int(cfg["data"].get("val_local_batch_size", 4)),
                                      seed)
    except (AssertionError, FileNotFoundError, ValueError) as e:
        log0(f"No validation split available ({e}); disabling val.")
        return None, None
    return val_batches, val_dataset


def main(argv=None, dataset=None) -> int:
    try:
        trainer, loader, cfg = setup(argv if argv is not None else sys.argv[1:], dataset)
    except FinetuneWithoutResume as e:
        log0(f"ERROR: {e}")
        return 1
    if cfg.get("dry_run"):
        log0("Dry run requested; exiting before training.")
        return 0
    val_batches, val_dataset = validation(cfg, trainer.seed)
    log0("Training...")
    trainer.train(loader, val_batches, val_dataset)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
