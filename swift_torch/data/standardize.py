"""Device-resident standardization over dataset statistics.

Counterpart of ``swift_tpu/data/standardize.py``: state (``x``) and
target (``t``) statistics with interval-keyed residual stats, channel
slicing by whether a tensor holds variables, forcings or both, and SST
zeroing except at Δ=24h. A tensor on another device than the statistics
takes copies of them made once for that device, so the multistep losses'
``loss_std_fns`` serve the card and the CPU from one object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Standardizer:
    x_mean: torch.Tensor  # (1, 1, C+F)
    x_std: torch.Tensor
    t_mean: dict  # delta -> (1, 1, C)
    t_std: dict
    n_variables: int
    n_forcings: int
    sst_index: Optional[int]  # None if SST is not a variable
    _copies: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_dataset(cls, ds, device=None) -> "Standardizer":
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        sst = (
            ds.variables.index("sea_surface_temperature")
            if "sea_surface_temperature" in ds.variables
            else None
        )
        return cls(
            x_mean=dev(ds.x_means),
            x_std=dev(ds.x_stds),
            t_mean={k: dev(v) for k, v in _as_dict(ds.t_means, ds.intervals).items()},
            t_std={k: dev(v) for k, v in _as_dict(ds.t_stds, ds.intervals).items()},
            n_variables=len(ds.variables),
            n_forcings=len(ds.forcings),
            sst_index=sst,
        )

    def _on(self, a: torch.Tensor, device) -> torch.Tensor:
        if a.device == device:
            return a
        key = (id(a), device)
        if key not in self._copies:
            self._copies[key] = a.to(device)
        return self._copies[key]

    def _slice(self, v, m, s):
        m, s = self._on(m, v.device), self._on(s, v.device)
        c = v.shape[-1]
        nv, nf = self.n_variables, self.n_forcings
        if c == nv:
            return m[..., :nv], s[..., :nv]
        if c == nf and nf > 0:
            return m[..., nv:], s[..., nv:]
        return m, s

    def _zero(self, v, delta: int):
        if delta == 24 or self.sst_index is None or v.shape[-1] == self.n_forcings:
            return v
        key = ("sst", v.device)
        if key not in self._copies:
            self._copies[key] = torch.tensor([self.sst_index], device=v.device)
        return v.index_fill(-1, self._copies[key], 0.0)

    def std_x(self, v, delta: int = 6):
        m, s = self._slice(v, self.x_mean, self.x_std)
        return self._zero((v - m) / s, delta)

    def unstd_x(self, v, delta: int = 6):
        m, s = self._slice(v, self.x_mean, self.x_std)
        return self._zero(v * s + m, delta)

    def std_t(self, v, delta: int = 6):
        m, s = self._slice(v, self.t_mean[delta], self.t_std[delta])
        return self._zero((v - m) / s, delta)

    def unstd_t(self, v, delta: int = 6):
        m, s = self._slice(v, self.t_mean[delta], self.t_std[delta])
        return self._zero(v * s + m, delta)

    def loss_std_fns(self):
        """The Δ-aware (unstd_t, unstd_x, std_x) the multistep losses take."""
        return (self.unstd_t, self.unstd_x, self.std_x)


def _as_dict(stats, intervals):
    if isinstance(stats, dict):
        return stats
    return {i: np.asarray(stats) for i in intervals}
