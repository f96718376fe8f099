"""Builders: config dict -> the port's network.

Counterpart of ``swift_tpu/factory.py`` for the ported models: the same
``_target_`` suffixes and config keys, so a run's saved config builds the
same network in either package. Only SwinV2 under PassPrecond, over the
ERA5 dataset, is ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from swift_torch.models.precond import PassPrecond
from swift_torch.models.swinv2 import SwinV2
from swift_tpu.data.era5 import ERA5Dataset


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
    if cfg.get("pos_embed_mode", "learned") != "learned":
        raise ValueError("only the learned pos_embed is ported")
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
