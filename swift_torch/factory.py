"""Builders: config dict -> the port's network, loss and optimizer.

Counterpart of ``swift_tpu/factory.py`` for the ported pieces: the same
``_target_`` suffixes and config keys, so a run's saved config builds the
same network in either package. Ported: SwinV2 (learned or factorized
position embedding, ``quant="int8"`` for the int8 forecast) under
PassPrecond or EDMPrecond over the ERA5 dataset and its rollout form, the
EDM, TrigFlow, sCM, multistep MSE and CRPS losses, Adam/AdamW with the
reference's decay grouping, Muon with aux-Adam by the JAX package's labels
(its momentum in fp32 or stochastically rounded bf16) and MARS, each with
the reference lr schedule. Any other target raises.

Under tensor parallelism (a ``parallel.mesh.Layout`` with a model axis, as
``swift_tpu/factory.py:300-306`` and ``swift_tpu/train.py:216-226`` hand
the JAX package's builders the mesh) :func:`build_precond` builds one
process's network and keeps this rank's slices of it, and
:func:`build_optimizer` gives Muon the slices and splits its
Newton-Schulz work over the ranks, and gives MARS the slices, which it
gathers for its whole-matrix norms and Newton-Schulz; AdamW is elementwise
and runs on the slices as they are.

For pipeline-parallel prediction (``generate --pp``) ``pipe_stage=(S, s)``
builds stage s of S: the embeddings, the head and the stage's pairs only
(``SwinV2(pipe_stages=S, pipe_stage=s)``), whose weights the caller loads
(``parallel.pipeline.stage_state_dict``). Training under a pipe axis builds
the whole network on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from swift_torch.data.era5 import ERA5Dataset, ERA5RollOutDataset
from swift_torch.data.standardize import Standardizer
from swift_torch.models.precond import EDMPrecond, PassPrecond
from swift_torch.models.swinv2 import SwinV2
from swift_torch.parallel.mesh import Layout, rank, world_size
from swift_torch.parallel.sharding import module_shards, shard_state_dict
from swift_torch.training.loss import CRPSLoss, EDMLoss, MSELoss, SCMLoss, TrigFlowLoss
from swift_torch.training.optimizers.mars import MARS
from swift_torch.training.optimizers.muon import MuonWithAuxAdam
from swift_torch.training.trainer import adamw_decay_mask, lr_schedule, muon_param_labels


def _suffix(target: str) -> str:
    return target.rsplit(".", 1)[-1]


def _infinity(v) -> float:
    if v in ("inf", ".inf", "Infinity", None):
        return float("inf")
    return float(v)


def _dataset_kwargs(ds_cfg: dict, split: str) -> dict:
    return dict(
        root=ds_cfg["root"],
        variables=list(ds_cfg["variables"]),
        forcings=list(ds_cfg.get("forcings", []) or []),
        intervals=list(ds_cfg.get("intervals", [6, 12, 24])),
        split=split,
        residual=bool(ds_cfg.get("residual", False)),
    )


def build_dataset(data_cfg: dict, split: Optional[str] = None, **extra) -> ERA5Dataset:
    ds_cfg = dict(data_cfg["dataset"])
    target = _suffix(ds_cfg.pop("_target_", "ERA5Dataset"))
    kwargs = {**_dataset_kwargs(ds_cfg, split or ds_cfg.get("split", "train")), **extra}
    if target == "ERA5RollOutDataset":
        return ERA5RollOutDataset(**kwargs)
    if target == "ERA5Dataset":
        return ERA5Dataset(**kwargs)
    raise ValueError(f"unknown dataset target: {target}")


def build_rollout_dataset(data_cfg: dict, interval: int, split: str = "val") -> ERA5RollOutDataset:
    return ERA5RollOutDataset(interval=interval, **_dataset_kwargs(dict(data_cfg["dataset"]), split))


def build_model(model_cfg: dict, img_resolution, in_channels: int, out_channels: int,
                auxiliary_dim: int = 0, dtype: torch.dtype = torch.bfloat16,
                layout: Optional[Layout] = None,
                pipe_stage: Optional[tuple[int, int]] = None) -> SwinV2:
    """The SwinV2 of ``model_cfg``; with a ``layout`` of a model axis, this
    rank's part of it: one process's network is built (its initial weights
    drawn as one process draws them) and sliced
    (``parallel.sharding.shard_state_dict`` by its ``module_shards``), the
    global RNG left where one
    process's build leaves it. ``pipe_stage`` (S, s): pipeline stage s of S,
    its own initial weights (the caller loads the stage's)."""
    cfg = dict(model_cfg)
    target = _suffix(cfg.pop("_target_", "SwinV2"))
    if target != "SwinV2":
        raise ValueError(f"model target {target!r} is not ported (only SwinV2)")
    if pipe_stage is not None:
        return _swinv2(cfg, img_resolution, in_channels, out_channels, auxiliary_dim, dtype,
                       pipe_stages=pipe_stage[0], pipe_stage=pipe_stage[1])
    full = _swinv2(cfg, img_resolution, in_channels, out_channels, auxiliary_dim, dtype)
    if layout is None or layout.model == 1:
        return full
    with torch.random.fork_rng(devices=[]):
        net = _swinv2(cfg, img_resolution, in_channels, out_channels, auxiliary_dim, dtype,
                      model_size=layout.model, model_rank=layout.model_rank,
                      model_group=layout.model_group)
    net.load_state_dict(shard_state_dict(full.state_dict(), module_shards(net)))
    return net


def _swinv2(cfg: dict, img_resolution, in_channels, out_channels, auxiliary_dim, dtype,
            **tp) -> SwinV2:
    return SwinV2(
        img_resolution=tuple(img_resolution),
        in_channels=in_channels,
        out_channels=out_channels,
        window_size=tuple(cfg["window_size"]),
        shift_size=tuple(cfg["shift_size"]),
        patch_size=tuple(cfg["patch_size"]),
        depth=int(cfg.get("depth", 6)),
        dim=int(cfg.get("dim", 512)),
        heads=int(cfg.get("heads", 12)),
        head_dim=int(cfg["head_dim"]) if cfg.get("head_dim") else None,
        auxiliary_dim=auxiliary_dim,
        logvar=bool(cfg.get("logvar", False)),
        timestep_weight=float(cfg.get("timestep_weight", 1.0)),
        dtype=dtype,
        pos_embed_mode=str(cfg.get("pos_embed_mode", "learned")),
        quant=cfg.get("quant") or None,
        **tp,
    )


def build_precond(precond_cfg: dict, model_cfg: dict, img_resolution, img_channels: int,
                  condition_channels: int, dtype: torch.dtype = torch.bfloat16,
                  sigma_max_override: Optional[float] = None, layout: Optional[Layout] = None,
                  pipe_stage: Optional[tuple[int, int]] = None):
    cfg = dict(precond_cfg)
    target = _suffix(cfg.pop("_target_", "PassPrecond"))
    precond = {"PassPrecond": PassPrecond, "EDMPrecond": EDMPrecond}.get(target)
    if precond is None:
        raise ValueError(f"unknown precond target: {target}")
    auxiliary_dim = int(cfg.get("auxiliary_dim", 0))
    model = build_model(model_cfg, img_resolution, img_channels + condition_channels,
                        img_channels, auxiliary_dim=auxiliary_dim, dtype=dtype, layout=layout,
                        pipe_stage=pipe_stage)
    return precond(
        model=model,
        img_resolution=tuple(img_resolution),
        img_channels=img_channels,
        condition_channels=condition_channels,
        auxiliary_dim=auxiliary_dim,
        sigma_min=float(cfg.get("sigma_min", 0.0)),
        sigma_max=(sigma_max_override if sigma_max_override is not None
                   else _infinity(cfg.get("sigma_max", float("inf")))),
        sigma_data=float(cfg.get("sigma_data", 1.0)),
    )


def build_loss(loss_cfg: dict, dataset):
    """The loss of ``loss_cfg`` over ``dataset``'s grid and variables; the
    multistep losses also take its statistics (``Standardizer.
    loss_std_fns``) and its number of variables."""
    cfg = dict(loss_cfg)
    target = _suffix(cfg.pop("_target_", ""))
    common = dict(lat_dim=dataset.img_resolution[0], variables=list(dataset.variables),
                  noise=dict(cfg.get("noise") or {}))
    if target == "EDMLoss":
        return EDMLoss(**common, sigma_data=float(cfg.get("sigma_data", 0.5)))
    common["sigma_data"] = float(cfg.get("sigma_data", 1.0))
    if target == "TrigFlowLoss":
        return TrigFlowLoss(**common)
    if target == "SCMLoss":
        return SCMLoss(**common, tangent_warmup_kimg=int(cfg.get("tangent_warmup_kimg", 0)),
                       distillation=bool(cfg.get("distillation", False)))
    if target in ("MSELoss", "CRPSLoss"):
        common.update(std_fns=Standardizer.from_dataset(dataset).loss_std_fns(),
                      n_variables=len(dataset.variables))
        if target == "MSELoss":
            return MSELoss(**common)
        return CRPSLoss(**common, ensemble_size=int(cfg.get("ensemble_size", 2)),
                        alpha=float(cfg.get("alpha", 1.0)))
    raise ValueError(f"unknown loss target: {target}")


def build_optimizer(optimizer_cfg: dict, trainer_cfg: dict, global_batch_size: int,
                    net: torch.nn.Module, resume_kimg: int = 0,
                    layout: Optional[Layout] = None):
    """(optimizer, lr schedule ``lr_fn(count, base_lr)``). Adam/AdamW: two
    parameter groups, decayed and not, by :func:`adamw_decay_mask` (the
    reference grouping), both of base lr ``lr``. MuonWithAuxAdam: the
    "muon" and "adam" groups of :func:`muon_param_labels`, of base lr
    ``lr`` and ``adam_lr``. The trainer sets every group's lr from the
    schedule and the group's ``base_lr`` before each update, as the JAX
    package's optax transforms read theirs. MARS: one group over every
    parameter, the 1-D branch's updates scaled by ``lr_1d`` on top of the
    scheduled lr (the JAX package's ``lr_1d_factor`` under a schedule).
    Muon over several ranks splits its Newton-Schulz work over all of them,
    and under ``layout``'s model axis gathers the slices of ``net``'s split
    weights for it (``optimizers.muon``); MARS gathers them for its clip's
    norm and mars-shampoo's Newton-Schulz (``optimizers.mars``)."""
    cfg = dict(optimizer_cfg)
    target = _suffix(cfg.pop("_target_", "Adam"))
    if target not in ("Adam", "AdamW", "MuonWithAuxAdam", "MARS"):
        raise ValueError(f"unknown optimizer target: {target}")
    base_lr = float(cfg.get("lr", 0.02 if target == "MuonWithAuxAdam" else 1e-3))
    lr_fn = lr_schedule(
        global_batch_size,
        lr_rampup_kimg=float(trainer_cfg.get("lr_rampup_kimg", 10000)),
        total_kimg=float(trainer_cfg.get("total_kimg", 200000)),
        lr_min_factor=float(trainer_cfg.get("lr_min_factor", 0.01)),
        lr_cosine_anneal=bool(trainer_cfg.get("lr_cosine_anneal", True)),
        resume_kimg=resume_kimg,
    )
    named = list(net.named_parameters())
    shards = module_shards(net)
    model_group = layout.model_group if layout is not None else None
    if target == "MARS":
        opt = MARS([p for _, p in named], lr=base_lr,
                   mars_type=cfg.get("mars_type", "mars-adamw"),
                   weight_decay=float(cfg.get("weight_decay", 0.0)),
                   lr_1d=float(cfg.get("lr_1d", base_lr)),
                   shards=[shards.get(n) for n, _ in named], model_group=model_group)
        for group in opt.param_groups:
            group["lr"] = lr_fn(0, group["base_lr"])
        return opt, lr_fn
    if target == "MuonWithAuxAdam":
        labels = muon_param_labels(named)
        betas = cfg.get("adam_betas", (0.9, 0.95))
        opt = MuonWithAuxAdam(
            [p for n, p in named if labels[n] == "muon"],
            [p for n, p in named if labels[n] == "adam"],
            lr=base_lr,
            weight_decay=float(cfg.get("weight_decay", 0.01)),
            adam_lr=float(cfg.get("adam_lr", 3e-4)),
            adam_betas=(float(betas[0]), float(betas[1])),
            adam_weight_decay=float(cfg.get("adam_weight_decay", 0.01)),
            adam_eps=float(cfg.get("adam_eps", 1e-10)),
            momentum_dtype=cfg.get("momentum_dtype"),
            shards=[shards.get(n) for n, _ in named if labels[n] == "muon"],
            model_group=model_group,
            ns_split=(rank(), world_size()),
        )
        for group in opt.param_groups:
            group["lr"] = lr_fn(0, group["base_lr"])
        return opt, lr_fn
    wd = float(cfg.get("weight_decay", 0.0))
    betas = cfg.get("betas", (0.9, 0.999))
    mask = adamw_decay_mask([n for n, _ in named])
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": wd, "base_lr": base_lr},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0, "base_lr": base_lr},
    ]
    opt = torch.optim.AdamW(groups, lr=lr_fn(0, base_lr), betas=(float(betas[0]), float(betas[1])),
                            eps=float(cfg.get("eps", 1e-8)))
    return opt, lr_fn
