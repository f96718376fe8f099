"""Builders: config dict -> the port's network, loss and optimizer.

Counterpart of ``swift_tpu/factory.py`` for the ported pieces: the same
``_target_`` suffixes and config keys, so a run's saved config builds the
same network in either package. Ported: SwinV2 (learned or factorized
position embedding) under PassPrecond over the ERA5 dataset, the TrigFlow
and sCM losses, Adam/AdamW with the reference's decay grouping, and Muon
with aux-Adam by the JAX package's labels, each with the reference lr
schedule. Any other target raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from swift_torch.data.era5 import ERA5Dataset
from swift_torch.models.precond import PassPrecond
from swift_torch.models.swinv2 import SwinV2
from swift_torch.training.loss import SCMLoss, TrigFlowLoss
from swift_torch.training.optimizers.muon import MuonWithAuxAdam
from swift_torch.training.trainer import adamw_decay_mask, lr_schedule, muon_param_labels


def _suffix(target: str) -> str:
    return target.rsplit(".", 1)[-1]


def _infinity(v) -> float:
    if v in ("inf", ".inf", "Infinity", None):
        return float("inf")
    return float(v)


def build_dataset(data_cfg: dict, split: Optional[str] = None) -> ERA5Dataset:
    ds_cfg = dict(data_cfg["dataset"])
    target = _suffix(ds_cfg.pop("_target_", "ERA5Dataset"))
    if target != "ERA5Dataset":
        raise ValueError(f"dataset target {target!r} is not ported (only ERA5Dataset)")
    return ERA5Dataset(
        root=ds_cfg["root"],
        variables=list(ds_cfg["variables"]),
        forcings=list(ds_cfg.get("forcings", []) or []),
        intervals=list(ds_cfg.get("intervals", [6, 12, 24])),
        split=split or ds_cfg.get("split", "train"),
        residual=bool(ds_cfg.get("residual", False)),
    )


def build_model(model_cfg: dict, img_resolution, in_channels: int, out_channels: int,
                auxiliary_dim: int = 0, dtype: torch.dtype = torch.bfloat16) -> SwinV2:
    cfg = dict(model_cfg)
    target = _suffix(cfg.pop("_target_", "SwinV2"))
    if target != "SwinV2":
        raise ValueError(f"model target {target!r} is not ported (only SwinV2)")
    if cfg.get("quant"):
        raise ValueError("int8 inference is not ported")
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
    )


def build_precond(precond_cfg: dict, model_cfg: dict, img_resolution, img_channels: int,
                  condition_channels: int, dtype: torch.dtype = torch.bfloat16,
                  sigma_max_override: Optional[float] = None) -> PassPrecond:
    cfg = dict(precond_cfg)
    target = _suffix(cfg.pop("_target_", "PassPrecond"))
    if target != "PassPrecond":
        raise ValueError(f"precond target {target!r} is not ported (only PassPrecond)")
    auxiliary_dim = int(cfg.get("auxiliary_dim", 0))
    model = build_model(model_cfg, img_resolution, img_channels + condition_channels,
                        img_channels, auxiliary_dim=auxiliary_dim, dtype=dtype)
    return PassPrecond(
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
    cfg = dict(loss_cfg)
    target = _suffix(cfg.pop("_target_", ""))
    common = dict(lat_dim=dataset.img_resolution[0], variables=list(dataset.variables),
                  noise=dict(cfg["noise"]), sigma_data=float(cfg.get("sigma_data", 1.0)))
    if target == "TrigFlowLoss":
        return TrigFlowLoss(**common)
    if target == "SCMLoss":
        return SCMLoss(**common, tangent_warmup_kimg=int(cfg.get("tangent_warmup_kimg", 0)),
                       distillation=bool(cfg.get("distillation", False)))
    raise NotImplementedError(
        f"loss target {target!r} is not ported (only TrigFlowLoss and SCMLoss)")


def build_optimizer(optimizer_cfg: dict, trainer_cfg: dict, global_batch_size: int,
                    net: torch.nn.Module, resume_kimg: int = 0):
    """(optimizer, lr schedule ``lr_fn(count, base_lr)``). Adam/AdamW: two
    parameter groups, decayed and not, by :func:`adamw_decay_mask` (the
    reference grouping), both of base lr ``lr``. MuonWithAuxAdam: the
    "muon" and "adam" groups of :func:`muon_param_labels`, of base lr
    ``lr`` and ``adam_lr``. The trainer sets every group's lr from the
    schedule and the group's ``base_lr`` before each update, as the JAX
    package's optax transforms read theirs."""
    cfg = dict(optimizer_cfg)
    target = _suffix(cfg.pop("_target_", "Adam"))
    if target not in ("Adam", "AdamW", "MuonWithAuxAdam"):
        raise NotImplementedError(
            f"optimizer target {target!r} is not ported (only Adam/AdamW and MuonWithAuxAdam)")
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
