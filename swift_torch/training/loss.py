"""Training losses of the port: the weighting, the noise samplers and
``TrigFlowLoss``.

Counterpart of ``swift_tpu/training/loss.py`` (reference
src/swift/training/loss.py:28-160): latitude and variable weights, the
lognormal / loguniform noise samplers, and the TrigFlow v-prediction loss
with adaptive logvar weighting. Data are NHWC, channel sums over the last
axis. The random draws (τ, z) are split from the loss body, as
``SCMLoss._draw`` splits them in the JAX package, and come from an explicit
``torch.Generator``: a test hands both packages the same numbers.
The other losses (EDM, sCM, MSE, CRPS) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from swift_torch.data.constants import DEFAULT_PRESSURE_LEVELS, PRESSURE_LEVEL_VARS


def latitude_weights(lat_dim: int) -> np.ndarray:
    """cos(lat) weights, mean-normalized, clamped >= 0.1; shape (1, H, 1, 1)
    for NHWC."""
    w = np.cos(np.deg2rad(np.linspace(-90, 90, lat_dim)))
    w = w / w.mean()
    w = np.clip(w, 0.1, None)
    return w.reshape(1, -1, 1, 1).astype(np.float32)


def variable_weights(variables: Sequence[str]) -> np.ndarray:
    """Per-variable weights, sum-normalized; shape (1, 1, 1, C) for NHWC."""
    single = {
        "2m_temperature": 1.0,
        "sea_surface_temperature": 0.1,
        "10m_u_component_of_wind": 0.1,
        "10m_v_component_of_wind": 0.1,
        "mean_sea_level_pressure": 0.1,
    }
    pw = [lev / sum(DEFAULT_PRESSURE_LEVELS) for lev in DEFAULT_PRESSURE_LEVELS]
    table = dict(single)
    for var in PRESSURE_LEVEL_VARS:
        for lev, w in zip(DEFAULT_PRESSURE_LEVELS, pw):
            table[f"{var}_{lev}"] = w
    w = np.array([table[v] for v in variables], np.float32)
    w = w / w.sum()
    return w.reshape(1, 1, 1, -1)


def lognormal(gen: torch.Generator, batch: int, P_mean: float, P_std: float,
              device=None) -> torch.Tensor:
    n = torch.randn(batch, 1, 1, 1, generator=gen, device=device)
    return torch.exp(n * P_std + P_mean)


def loguniform(gen: torch.Generator, batch: int, sigma_min: float, sigma_max: float,
               device=None) -> torch.Tensor:
    u = torch.rand(batch, 1, 1, 1, generator=gen, device=device)
    return torch.exp(math.log(sigma_min) + u * (math.log(sigma_max) - math.log(sigma_min)))


NOISE_SAMPLING_METHODS = {"lognormal": lognormal, "loguniform": loguniform}


class TrigFlowLoss:
    """TrigFlow v-prediction loss with adaptive logvar weighting.

    ``loss(net, x, condition, auxiliary, gen)`` draws (t, z) with
    :meth:`draw` and returns :meth:`value`; ``net`` is the precond module.
    """

    def __init__(self, lat_dim: int, variables: Sequence[str], noise: dict,
                 sigma_data: float = 1.0):
        self.noise = dict(noise)
        self.sigma_data = float(sigma_data)
        self.w_lat = torch.from_numpy(latitude_weights(lat_dim))
        self.w_var = torch.from_numpy(variable_weights(list(variables)))

    def draw(self, x: torch.Tensor, gen: torch.Generator):
        """(t (B, 1, 1, 1), z like x): t = arctan(τ/σ_d) with τ from the
        noise sampler, z standard normal times σ_d."""
        cfg = dict(self.noise)
        fn = NOISE_SAMPLING_METHODS[cfg.pop("dist")]
        tau = fn(gen, x.shape[0], device=x.device, **cfg)
        t = torch.atan(tau / self.sigma_data)
        z = torch.randn(x.shape, generator=gen, device=x.device) * self.sigma_data
        return t, z

    def value(self, net, x, t, z, condition=None, auxiliary=None) -> torch.Tensor:
        """The loss at fixed draws (t, z)."""
        cos_t, sin_t = torch.cos(t), torch.sin(t)
        x_t = cos_t * x + sin_t * z
        v_t = cos_t * z - sin_t * x
        use_logvar = getattr(net.model, "logvar_embed", None) is not None
        out = net(x_t / self.sigma_data, t.reshape(-1), condition, auxiliary,
                  return_logvar=use_logvar)
        if use_logvar:
            F_x, logvar = out
            logvar = logvar.reshape(-1, 1, 1, 1)
        else:
            F_x, logvar = out, torch.zeros(x.shape[0], 1, 1, 1, device=x.device)
        w = self.w_var.to(x.device) * self.w_lat.to(x.device)
        se = w * torch.square(self.sigma_data * F_x - v_t)
        return ((1.0 / torch.exp(logvar)) * se + logvar).sum(dim=-1).mean()

    def __call__(self, net, x, condition=None, auxiliary=None,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
        t, z = self.draw(x, gen)
        return self.value(net, x, t, z, condition, auxiliary)
