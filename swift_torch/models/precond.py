"""Preconditioning wrappers around the backbone: ``PassPrecond`` and
``EDMPrecond``.

Counterpart of ``swift_tpu/models/precond.py``: the identity
preconditioner of TrigFlow/sCM v-prediction models, and EDM's
c_skip/c_out/c_in/c_noise scaling, ``D(x) = c_skip·x + c_out·F(c_in·x,
log(σ)/4)``. Both concatenate the condition channels (channels-last) and
broadcast the auxiliary (interval) conditioning. As an ``nn.Module`` each
is also the ``net(x, t, condition, auxiliary)`` callable the solvers take,
with the metadata they read (``sigma_min``, ``sigma_max``, ``sigma_data``,
``img_resolution``, ``img_channels``) and ``round_sigma``.

A precond that carries a ``parallel.pipeline.PipelineSpec`` (``pipeline``,
set by ``pipelined_precond``; the JAX ``BasePrecond.pipeline``) runs its
model through ``pipelined_swinv2_forward``, so every solver engages
pipeline parallelism unchanged; it takes the plain prediction call only
(``jvp`` and ``return_logvar`` raise).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from swift_torch.parallel.pipeline import pipelined_swinv2_forward


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


class _Precond(nn.Module):
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
        self.pipeline = None  # a parallel.pipeline.PipelineSpec: the pipelined forward

    def _model(self, arg, t, aux, **kwargs):
        """The backbone on (arg, t, aux): its forward, or the pipelined one
        when this precond carries a spec."""
        if self.pipeline is None:
            return self.model(arg, t, aux, **kwargs)
        if kwargs:
            raise ValueError(
                "pipeline-parallel forward supports the plain prediction call only (got model "
                f"kwargs {sorted(kwargs)}); use a non-pipelined precond for training/logvar "
                "paths")
        p = self.pipeline
        return pipelined_swinv2_forward(self.model, arg, t, aux, mesh=p.mesh,
                                        pipe_axis=p.pipe_axis, n_micro=p.n_micro,
                                        data_axis=p.data_axis)

    def _check(self, x) -> None:
        if tuple(x.shape[1:3]) != self.img_resolution:
            raise ValueError(
                f"input spatial shape {tuple(x.shape[1:3])} does not match the network "
                f"img_resolution {self.img_resolution} (NHWC layout expected)"
            )

    def _condition(self, arg, condition):
        if condition is not None and self.condition_channels > 0:
            return torch.cat([arg, condition.to(arg.dtype)], dim=-1)
        return arg

    def round_sigma(self, sigma):
        return torch.as_tensor(sigma)


class PassPrecond(_Precond):
    """The identity preconditioner (v-prediction models)."""

    def forward(self, x, t, condition=None, auxiliary=None, **model_kwargs):
        self._check(x)
        aux = process_auxiliary(auxiliary, self.auxiliary_dim, x.shape[0], x.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
        return self._model(self._condition(x, condition), t, aux, **model_kwargs)


class EDMPrecond(_Precond):
    """The EDM preconditioner. σ is a scalar (a sampler's) or one per sample
    (the loss's), broadcast to (B, 1, 1, 1); the scalings are fp32, and
    ``c_skip·x + c_out·F`` is formed in fp32 from the backbone's output."""

    def __init__(self, *args, sigma_data: float = 0.5, **kwargs):
        super().__init__(*args, sigma_data=sigma_data, **kwargs)

    def forward(self, x, sigma, condition=None, auxiliary=None, **model_kwargs):
        self._check(x)
        B = x.shape[0]
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        sigma = sigma.reshape(-1, 1, 1, 1).expand(B, 1, 1, 1)
        aux = process_auxiliary(auxiliary, self.auxiliary_dim, B, x.device)
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data * torch.rsqrt(sigma ** 2 + sd2)
        c_in = torch.rsqrt(sd2 + sigma ** 2)
        c_noise = torch.log(sigma) / 4.0
        F_x = self._model(self._condition(c_in * x, condition), c_noise.reshape(-1), aux,
                          **model_kwargs)
        return c_skip * x + c_out * F_x
