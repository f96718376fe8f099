"""Autoregressive forecast rollout on one device.

Counterpart of ``swift_tpu/sampling/rollout.py::forecast_rollout``: the
forcings of every step are staged on the device at once, the residual
update (unstandardise, add, restandardise) runs on the device, and the
trajectory stays there until the caller reads it once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from swift_torch.data.standardize import Standardizer


@torch.inference_mode()
def forecast_rollout(
    sampler: Callable,  # (cond, generator, auxiliary=None) -> Y
    std: Standardizer,
    X0: torch.Tensor,  # (B, H, W, C) standardized
    forcings_seq: Optional[torch.Tensor],  # (B, steps, H, W, F) standardized
    generator: Optional[torch.Generator],
    steps: int,
    delta: int = 6,
    residual: bool = True,
    auxiliary=None,
) -> torch.Tensor:
    """The physical-space trajectory (B, steps + 1, H, W, C) on X0's device.
    ``sampler`` comes from ``sampling.factory.sampler_factory``; every step
    draws from ``generator``."""
    X = X0.float()
    traj = torch.empty((X.shape[0], steps + 1, *X.shape[1:]), device=X.device)
    traj[:, 0] = std.unstd_x(X, delta)
    for s in range(steps):
        cond = X if forcings_seq is None else torch.cat([X, forcings_seq[:, s].float()], dim=-1)
        Y = sampler(cond, generator, auxiliary=auxiliary)
        if residual:
            X_phys = std.unstd_x(X, delta) + std.unstd_t(Y, delta)
            X = std.std_x(X_phys, delta)
        else:
            X_phys = std.unstd_x(Y, delta)
            X = Y
        traj[:, s + 1] = X_phys
    return traj
