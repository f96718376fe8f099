"""Training losses of the port: the weighting, the noise samplers,
``EDMLoss``, ``TrigFlowLoss``, ``SCMLoss`` and the multistep fine-tune
losses ``MSELoss`` and ``CRPSLoss``.

Counterpart of ``swift_tpu/training/loss.py`` (reference
src/swift/training/loss.py:28-260): latitude and variable weights, the
lognormal / loguniform noise samplers, the EDM denoising loss, the TrigFlow
v-prediction loss with adaptive logvar weighting, and the sCM consistency loss, whose tangent term
runs the network once in forward mode (``torch.autograd.forward_ad``) through
the kernels' tangent routes. Data are NHWC, channel sums over the last axis.
The random draws ((τ, z); EDM's (σ, n)) are split from the loss body, as
``SCMLoss._draw`` splits them in the JAX package, and come from an explicit
``torch.Generator``: a test hands both packages the same numbers. Under data
parallelism (``shard`` = (rank, world)) every draw is made for the global
batch from a generator seeded alike on every rank, and the rank keeps its
rows, so the ranks' numbers are the one-process run's. The
multistep losses predict at t = π/2 from pure noise and roll the prediction
forward autoregressively in physical space; ``CRPSLoss`` scores an ensemble
of such rollouts with the almost-fair kernel CRPS.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch.autograd import forward_ad

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


Shard = tuple[int, int]  # (rank, world size)


def _rows(draw, shape, gen: torch.Generator, device, shard: Shard) -> torch.Tensor:
    """``draw`` (``torch.randn`` or ``torch.rand``) of ``shape`` for this
    rank's rows of a batch spread over ranks: the whole batch's numbers
    (``shape[0]`` rows a rank, in rank order) are drawn from ``gen``,
    seeded alike on every rank, and the rank's rows kept, as one JAX key
    over the sharded global array draws them. One rank draws ``shape``."""
    rank, world = shard
    if world == 1:
        return draw(shape, generator=gen, device=device)
    full = draw((shape[0] * world, *shape[1:]), generator=gen, device=device)
    return full[rank * shape[0]:(rank + 1) * shape[0]].clone()


def lognormal(gen: torch.Generator, batch: int, P_mean: float, P_std: float,
              device=None, shard: Shard = (0, 1)) -> torch.Tensor:
    n = _rows(torch.randn, (batch, 1, 1, 1), gen, device, shard)
    return torch.exp(n * P_std + P_mean)


def loguniform(gen: torch.Generator, batch: int, sigma_min: float, sigma_max: float,
               device=None, shard: Shard = (0, 1)) -> torch.Tensor:
    u = _rows(torch.rand, (batch, 1, 1, 1), gen, device, shard)
    return torch.exp(math.log(sigma_min) + u * (math.log(sigma_max) - math.log(sigma_min)))


NOISE_SAMPLING_METHODS = {"lognormal": lognormal, "loguniform": loguniform}


class _WeightedLoss:
    """The latitude and variable weights and the (t, z) draws shared by the
    TrigFlow and sCM losses."""

    def __init__(self, lat_dim: int, variables: Sequence[str], noise: dict,
                 sigma_data: float = 1.0):
        self.noise = dict(noise)
        self.sigma_data = float(sigma_data)
        self.w_lat = torch.from_numpy(latitude_weights(lat_dim))
        self.w_var = torch.from_numpy(variable_weights(list(variables)))

    def _weighted(self, se: torch.Tensor) -> torch.Tensor:
        """w_var·w_lat·se summed over channels, meaned over (B, H, W)."""
        return (self.w_var.to(se.device) * self.w_lat.to(se.device) * se).sum(dim=-1).mean()

    def draw(self, x: torch.Tensor, gen: torch.Generator, shard: Shard = (0, 1)):
        """(t (B, 1, 1, 1), z like x): t = arctan(τ/σ_d) with τ from the
        noise sampler, z standard normal times σ_d; ``shard`` = (rank,
        world): x is that rank's rows of the global batch (:func:`_rows`)."""
        cfg = dict(self.noise)
        fn = NOISE_SAMPLING_METHODS[cfg.pop("dist")]
        tau = fn(gen, x.shape[0], device=x.device, shard=shard, **cfg)
        t = torch.atan(tau / self.sigma_data)
        z = _rows(torch.randn, x.shape, gen, x.device, shard) * self.sigma_data
        return t, z


class EDMLoss(_WeightedLoss):
    """EDM denoising score matching: σ from the noise sampler, n = σ·ε,
    weight (σ² + σ_d²)/(σ·σ_d)², the weighted squared error of D(x + n, σ)
    against x. ``net`` is an ``EDMPrecond``."""

    def __init__(self, lat_dim: int, variables: Sequence[str], noise: dict,
                 sigma_data: float = 0.5):
        super().__init__(lat_dim, variables, noise, sigma_data)

    def draw(self, x: torch.Tensor, gen: torch.Generator, shard: Shard = (0, 1)):
        """(σ (B, 1, 1, 1), n = σ·ε like x)."""
        cfg = dict(self.noise)
        fn = NOISE_SAMPLING_METHODS[cfg.pop("dist")]
        sigma = fn(gen, x.shape[0], device=x.device, shard=shard, **cfg)
        return sigma, _rows(torch.randn, x.shape, gen, x.device, shard) * sigma

    def value(self, net, x, sigma, n, condition=None, auxiliary=None) -> torch.Tensor:
        """The loss at fixed draws (σ, n)."""
        weight = (sigma ** 2 + self.sigma_data ** 2) / (sigma * self.sigma_data) ** 2
        D_yn = net(x + n, sigma, condition, auxiliary)
        w = self.w_var.to(x.device) * self.w_lat.to(x.device)
        return (weight * (w * (D_yn - x) ** 2)).sum(dim=-1).mean()

    def __call__(self, net, x, condition=None, auxiliary=None,
                 gen: Optional[torch.Generator] = None, shard: Shard = (0, 1)) -> torch.Tensor:
        sigma, n = self.draw(x, gen, shard)
        return self.value(net, x, sigma, n, condition, auxiliary)


class TrigFlowLoss(_WeightedLoss):
    """TrigFlow v-prediction loss with adaptive logvar weighting.

    ``loss(net, x, condition, auxiliary, gen)`` draws (t, z) with
    :meth:`draw` and returns :meth:`value`; ``net`` is the precond module.
    """

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
                 gen: Optional[torch.Generator] = None, shard: Shard = (0, 1)) -> torch.Tensor:
        t, z = self.draw(x, gen, shard)
        return self.value(net, x, t, z, condition, auxiliary)


class SCMLoss(_WeightedLoss):
    """Simplified/stabilized continuous-time consistency loss (reference
    loss.py:163-260, the JAX package's ``SCMLoss``).

    ``loss(net, x, condition, auxiliary, gen, step=nimg, teacher=None)``
    draws (t, z) with :meth:`draw` (TrigFlow's) and returns :meth:`value`.
    ``step`` is the images seen before this optimizer step (the trainer's
    ``nimg``); it sets the tangent warmup r = min(1, step / (warmup_kimg ·
    1000)). With ``distillation`` and a ``teacher`` net, dx_t/dt is the
    frozen teacher's v-prediction.
    """

    def __init__(self, lat_dim: int, variables: Sequence[str], noise: dict,
                 sigma_data: float = 1.0, tangent_warmup_kimg: float = 0,
                 distillation: bool = False):
        super().__init__(lat_dim, variables, noise, sigma_data)
        self.tangent_warmup_kimg = tangent_warmup_kimg
        self.distillation = bool(distillation)

    def interpolate(self, x, t, z, condition=None, auxiliary=None, teacher=None):
        """(x_t, dx_t/dt) at the draws (t, z); with ``distillation`` and a
        ``teacher``, dx_t/dt is the frozen teacher's v-prediction."""
        x_t = torch.cos(t) * x + torch.sin(t) * z
        if self.distillation and teacher is not None:
            with torch.no_grad():
                return x_t, self.sigma_data * teacher(x_t / self.sigma_data, t.reshape(-1),
                                                      condition, auxiliary)
        return x_t, torch.cos(t) * z - torch.sin(t) * x

    def jvp_term(self, net, t, x_t, dxt_dt, condition=None, auxiliary=None):
        """dF̂: the tangent of ``net`` at (x_t/σ_d, t) along (cos t · sin t ·
        dx_t/dt / σ_d, cos t · sin t), run once in forward mode under
        ``no_grad`` (the JAX package stop-gradients it; here no graph is
        recorded). The net's ``jvp`` path carries the tangent through the
        kernels."""
        cos_t, sin_t = torch.cos(t), torch.sin(t)
        with torch.no_grad(), forward_ad.dual_level():
            xi = forward_ad.make_dual(x_t / self.sigma_data,
                                      cos_t * sin_t * dxt_dt / self.sigma_data)
            ti = forward_ad.make_dual(t.reshape(-1), (cos_t * sin_t).reshape(-1))
            out = net(xi, ti, condition, auxiliary, jvp=True)
            dF_x = forward_ad.unpack_dual(out).tangent
        if dF_x is None:
            raise RuntimeError("the network's output carries no tangent")
        return dF_x

    def value(self, net, x, t, z, step=0.0, condition=None, auxiliary=None, teacher=None,
              dF_x=None) -> torch.Tensor:
        """The loss at fixed draws (t, z)."""
        cos_t, sin_t = torch.cos(t), torch.sin(t)
        x_t, dxt_dt = self.interpolate(x, t, z, condition, auxiliary, teacher)
        if dF_x is None:
            dF_x = self.jvp_term(net, t, x_t, dxt_dt, condition, auxiliary)
        use_logvar = getattr(net.model, "logvar_embed", None) is not None
        out = net(x_t / self.sigma_data, t.reshape(-1), condition, auxiliary,
                  return_logvar=use_logvar)
        if use_logvar:
            F_x, logvar = out
            logvar = logvar.reshape(-1, 1, 1, 1)
        else:
            F_x, logvar = out, torch.zeros(x.shape[0], 1, 1, 1, device=x.device)

        # tangent warmup ramp r = min(1, step / (warmup_kimg · 1000))
        if self.tangent_warmup_kimg > 0:
            r = min(1.0, float(step) / (self.tangent_warmup_kimg * 1000))
        else:
            r = 1.0
        F_det, dF_det = F_x.detach(), dF_x.detach()
        # the JVP rearrangement (the 1/(σ_d·tan t) factor folded into the
        # extra cos t, reference loss.py:238-241)
        g = -(cos_t ** 2) * (self.sigma_data * F_det - dxt_dt) - r * (
            (cos_t * sin_t) * x_t + self.sigma_data * dF_det)
        # tangent normalization, invariant to spatial size (reference :245-247)
        gn = torch.sqrt(torch.sum(g ** 2, dim=(1, 2, 3), keepdim=True))
        gn = gn * math.sqrt(1.0 / (g.shape[1] * g.shape[2] * g.shape[3]))
        g = g / (gn + 0.1)
        w = self.w_var.to(x.device) * self.w_lat.to(x.device)
        se = w * torch.square(F_x - F_det - g)
        return ((1.0 / torch.exp(logvar)) * se + logvar).sum(dim=-1).mean()

    def __call__(self, net, x, condition=None, auxiliary=None,
                 gen: Optional[torch.Generator] = None, step=0.0, teacher=None,
                 shard: Shard = (0, 1)) -> torch.Tensor:
        t, z = self.draw(x, gen, shard)
        return self.value(net, x, t, z, step, condition, auxiliary, teacher)


# ----------------------------------------------------------------------------
# Multistep losses (fine-tuning)


class _MultistepLoss(_WeightedLoss):
    """The one-shot prediction at t = π/2 from noise shared by the MSE and
    CRPS losses. ``std_fns`` = (unstd_t, unstd_x, std_x), Δ-aware, as
    ``Standardizer.loss_std_fns`` gives them; ``n_variables`` is the
    number of model variables leading the condition's channels."""

    def __init__(self, lat_dim: int, variables: Sequence[str],
                 std_fns: tuple[Callable, Callable, Callable], sigma_data: float = 1.0,
                 n_variables: int = 0, noise: Optional[dict] = None):
        super().__init__(lat_dim, variables, noise or {}, sigma_data)
        self.std_fns = std_fns
        self.n_variables = int(n_variables)

    def _predict(self, net, z, condition, auxiliary) -> torch.Tensor:
        """The net's output at x_t = σ_d·z (z standard normal) and t = π/2."""
        x_t = z * self.sigma_data
        t = torch.full((z.shape[0],), np.float32(np.pi / 2), device=z.device)
        return net(x_t / self.sigma_data, t, condition, auxiliary)


class MSELoss(_MultistepLoss):
    """Multistep MSE at the t = π/2 one-shot prediction (reference
    loss.py:266-303, the JAX package's ``MSELoss``): the prediction is
    +σ_d·out, and between steps the condition's variables advance in
    physical space at the default Δ, the forcings kept.

    ``loss(net, target, condition, auxiliary, gen, steps)`` draws one
    standard normal a step and returns :meth:`value`."""

    def value(self, net, target, condition, auxiliary, noise, steps: int = 1) -> torch.Tensor:
        """The loss at fixed draws ``noise`` (one tensor like ``target`` a
        step)."""
        unstd_t, unstd_x, std_x = self.std_fns
        nv = self.n_variables or target.shape[-1]
        cond, pred = condition, None
        for i in range(steps):
            pred = self.sigma_data * self._predict(net, noise[i], cond, auxiliary)
            if i < steps - 1:
                new_vars = std_x(unstd_x(cond[..., :nv]) + unstd_t(pred))
                cond = torch.cat([new_vars, cond[..., nv:]], dim=-1)
        return self._weighted((pred - target) ** 2)

    def __call__(self, net, target, condition=None, auxiliary=None,
                 gen: Optional[torch.Generator] = None, steps: int = 1, shard: Shard = (0, 1),
                 **kw) -> torch.Tensor:
        noise = [_rows(torch.randn, target.shape, gen, target.device, shard)
                 for _ in range(steps)]
        return self.value(net, target, condition, auxiliary, noise, steps)


def kernel_crps(preds: torch.Tensor, targets: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Almost-fair kernel CRPS (reference loss.py:343-371): ``preds`` (...,
    m) members on the last axis, ``targets`` (...); the member axis
    reduced."""
    m = preds.shape[-1]
    if m < 2:
        raise ValueError("the ensemble needs at least two members")
    epsilon = (1.0 - alpha) / m
    skill = (preds - targets[..., None]).abs().mean(dim=-1)
    diffs = (preds[..., None, :] - preds[..., :, None]).abs()
    spread = diffs.sum(dim=(-1, -2)) / (2 * m * (m - 1))
    return skill - (1 - epsilon) * spread


class CRPSLoss(_MultistepLoss):
    """Multistep almost-fair kernel CRPS (reference loss.py:306-445, the JAX
    package's ``CRPSLoss``). Each of ``ensemble_size`` members rolls
    ``steps`` one-shot predictions forward from the condition's variables:
    step i conditions on the rolled variables and the forcings
    ``forcings_seq[:, i]`` (B, steps, H, W, F, from the loader), predicts
    −σ_d·out (the v-prediction at t = π/2) and advances the variables in
    physical space at the batch's one Δ. The last step's predictions are
    scored against the target by :func:`kernel_crps`.

    With ``steps`` > 1 every step but the last runs under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` a
    scan step): only its input is kept, and the backward runs it again.
    The noise of every member and step is drawn before the checkpointed
    function and passed into it, so the recompute sees the same numbers.
    """

    def __init__(self, lat_dim: int, variables: Sequence[str],
                 std_fns: tuple[Callable, Callable, Callable], sigma_data: float = 1.0,
                 ensemble_size: int = 2, alpha: float = 1.0, n_variables: int = 0,
                 noise: Optional[dict] = None):
        super().__init__(lat_dim, variables, std_fns, sigma_data, n_variables, noise)
        self.ensemble_size = int(ensemble_size)
        self.alpha = float(alpha)

    def _one_step(self, net, z, cond_vars, forcing, auxiliary, delta: int):
        """(the next step's standardized variables, this step's prediction)."""
        unstd_t, unstd_x, std_x = self.std_fns
        cond = torch.cat([cond_vars, forcing], dim=-1)
        pred = -self.sigma_data * self._predict(net, z, cond, auxiliary)
        return std_x(unstd_x(cond_vars, delta) + unstd_t(pred, delta), delta), pred

    def value(self, net, target, condition, auxiliary, forcings_seq, noise, delta: int = 6,
              steps: int = 1) -> torch.Tensor:
        """The loss at fixed draws: ``noise[e][i]`` (like ``target``) is
        member e's standard normal at step i."""
        nv = self.n_variables or target.shape[-1]

        def advance(cond_vars, forcing, z):
            return self._one_step(net, z, cond_vars, forcing, auxiliary, delta)[0]

        preds = []
        for e in range(self.ensemble_size):
            cond_vars = condition[..., :nv]
            for i in range(steps - 1):
                cond_vars = torch.utils.checkpoint.checkpoint(
                    advance, cond_vars, forcings_seq[:, i], noise[e][i], use_reentrant=False,
                    preserve_rng_state=False)
            preds.append(self._one_step(net, noise[e][steps - 1], cond_vars,
                                        forcings_seq[:, steps - 1], auxiliary, delta)[1])
        crps = kernel_crps(torch.stack(preds, dim=-1), target, self.alpha)  # (B, H, W, C)
        return self._weighted(crps)

    def __call__(self, net, target, condition, auxiliary, gen: Optional[torch.Generator] = None,
                 forcings_seq=None, delta: int = 6, steps: int = 1, shard: Shard = (0, 1),
                 **kw) -> torch.Tensor:
        noise = [[_rows(torch.randn, target.shape, gen, target.device, shard)
                  for _ in range(steps)] for _ in range(self.ensemble_size)]
        return self.value(net, target, condition, auxiliary, forcings_seq, noise, delta, steps)
