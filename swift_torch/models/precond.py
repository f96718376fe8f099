"""Preconditioning wrapper around the backbone: ``PassPrecond``.

Counterpart of ``swift_tpu/models/precond.py``: the identity
preconditioner of TrigFlow/sCM v-prediction models. It concatenates the
condition channels (channels-last) and broadcasts the auxiliary (interval)
conditioning. As an ``nn.Module`` it is also the ``net(x, t, condition,
auxiliary)`` callable the solvers take, with the metadata they read
(``sigma_data``, ``img_resolution``, ``img_channels``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def process_auxiliary(auxiliary, auxiliary_dim: int, batch_size: int,
                      device=None) -> Optional[torch.Tensor]:
    """Broadcast auxiliary conditioning to (B, auxiliary_dim) fp32: None with
    auxiliary_dim > 0 becomes zeros; a scalar broadcasts over the batch."""
    if auxiliary_dim == 0:
        return None
    if auxiliary is None:
        return torch.zeros(batch_size, auxiliary_dim, device=device)
    aux = torch.as_tensor(auxiliary, dtype=torch.float32, device=device)
    if aux.numel() == 1:
        aux = aux.reshape(()).expand(batch_size)
    return aux.reshape(batch_size, auxiliary_dim)


class PassPrecond(nn.Module):
    def __init__(
        self,
        model: nn.Module,
        img_resolution: tuple[int, int],
        img_channels: int,
        condition_channels: int = 0,
        auxiliary_dim: int = 0,
        sigma_min: float = 0.0,
        sigma_max: float = float("inf"),
        sigma_data: float = 1.0,
    ):
        super().__init__()
        self.model = model
        self.img_resolution = tuple(img_resolution)
        self.img_channels = img_channels
        self.condition_channels = condition_channels
        self.auxiliary_dim = auxiliary_dim
        self.sigma_min, self.sigma_max, self.sigma_data = sigma_min, sigma_max, sigma_data

    def forward(self, x, t, condition=None, auxiliary=None, **model_kwargs):
        if tuple(x.shape[1:3]) != self.img_resolution:
            raise ValueError(
                f"input spatial shape {tuple(x.shape[1:3])} does not match the network "
                f"img_resolution {self.img_resolution} (NHWC layout expected)"
            )
        aux = process_auxiliary(auxiliary, self.auxiliary_dim, x.shape[0], x.device)
        arg = x
        if condition is not None and self.condition_channels > 0:
            arg = torch.cat([x, condition.to(x.dtype)], dim=-1)
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
        return self.model(arg, t, aux, **model_kwargs)
