"""Diffusion and consistency solvers of the port.

Counterpart of ``swift_tpu/sampling/solvers.py``:

  * ``edm_sampler``      — EDM Heun 2nd order with S_churn;
  * ``ablation_sampler`` — the VP/VE/iDDPM/EDM superset, Euler or Heun;
  * ``dpm_solver``       — DPM-Solver(++) 2M on TrigFlow time;
  * ``dpm_solver_2s``    — 2nd-order Heun on v-prediction;
  * ``scm_solver``       — multistep consistency sampler; 1 step = t=π/2,
                           the 2-step sampler's intermediate t₁ = 1.1;
  * ``scm_solve2``       — its variant that injects noise after each step.

As in the JAX package, every schedule quantity that depends only on the
solver's hyper-parameters (t-steps, churn γ, the 2M correction
coefficients) is computed on the host in float64 numpy, and each per-step
constant is rounded to fp32 before it meets a tensor (the JAX package's
``jnp.asarray(..., jnp.float32)`` scan inputs); products of such constants
are formed in fp32, in the JAX package's order. Where the JAX package runs
a ``lax.scan`` with ``lax.cond`` branches, these run a Python loop: Heun's
last step is Euler, ``ablation_sampler``'s Euler solver takes no second
evaluation, and ``dpm_solver``'s correction is 0 on its first and last
step. The noise levels a network sees lie on its device, made once a
call. Stochastic steps draw standard normals from ``generator``, or take
``noise[i]`` for step i when given, so tests can hand both packages the
same numbers.

``net`` is any callable ``net(x, t, condition, auxiliary)`` with the
metadata the solvers read (``sigma_data``, ``sigma_min``, ``sigma_max``):
a precond module of ``swift_torch.models.precond``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def _f32(*factors) -> float:
    """The product of ``factors`` formed in fp32, left to right, as a Python
    float (exact in fp32)."""
    out = np.float32(factors[0])
    for f in factors[1:]:
        out = np.float32(out * np.float32(f))
    return float(out)


def _levels(values, device) -> torch.Tensor:
    """Noise levels as one fp32 device tensor; the solver passes ``ts[i]``."""
    return torch.tensor(np.asarray(values, np.float32), device=device)


def _normal(noise, i: int, like: torch.Tensor, generator) -> torch.Tensor:
    if noise is not None:
        return noise[i].to(like.device, torch.float32)
    return torch.randn(like.shape, generator=generator, device=like.device)


def _edm_t_steps(num_steps: int, sigma_min: float, sigma_max: float, rho: float):
    i = np.arange(num_steps, dtype=np.float64)
    ts = (
        sigma_max ** (1 / rho)
        + i / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
    ) ** rho
    return np.concatenate([ts, [0.0]])


def _loguniform_t_steps(num_steps: int, sigma_min: float, sigma_max: float,
                        sigma_data: float) -> np.ndarray:
    u = np.linspace(1.0, 0.0, num_steps)
    tau = np.exp(np.log(sigma_min) + u * (np.log(sigma_max) - np.log(sigma_min)))
    return np.arctan(tau / sigma_data)


# ----------------------------------------------------------------------------
# EDM Heun sampler


def edm_sampler(
    net,
    latents: torch.Tensor,
    condition: Optional[torch.Tensor] = None,
    auxiliary=None,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 18,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    S_churn: float = 0.0,
    S_min: float = 0.0,
    S_max: float = float("inf"),
    S_noise: float = 1.0,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """EDM Heun with churn; σ_min and σ_max are clamped to the net's range.
    Step i's churn draws ``noise[i]`` when given."""
    sigma_min = max(sigma_min, net.sigma_min)
    sigma_max = min(sigma_max, net.sigma_max)
    t_steps = _edm_t_steps(num_steps, sigma_min, sigma_max, rho)
    gammas = np.array([
        min(S_churn / num_steps, np.sqrt(2) - 1) if (S_min <= t and t <= S_max) else 0.0
        for t in t_steps[:-1]
    ])
    t_hats = t_steps[:-1] + gammas * t_steps[:-1]
    churn_scale = np.sqrt(np.maximum(t_hats**2 - t_steps[:-1] ** 2, 0.0)) * S_noise

    x = latents.float() * _f32(t_steps[0])
    levels_hat = _levels(t_hats, x.device)
    levels_next = _levels(t_steps[1:], x.device)
    for i in range(num_steps):
        t_hat, t_next = np.float32(t_hats[i]), np.float32(t_steps[i + 1])
        h = float(np.float32(t_next - t_hat))
        churn = _f32(churn_scale[i])
        x_hat = x + churn * _normal(noise, i, x, generator) if churn else x
        denoised = net(x_hat, levels_hat[i], condition, auxiliary).float()
        d_cur = (x_hat - denoised) / float(t_hat)
        x = x_hat + h * d_cur
        if i < num_steps - 1:  # Heun's correction; the last step stays Euler
            denoised2 = net(x, levels_next[i], condition, auxiliary).float()
            d_prime = (x - denoised2) / float(t_next)
            x = x_hat + h * (0.5 * d_cur + 0.5 * d_prime)
    return x


# ----------------------------------------------------------------------------
# Ablation sampler (VP / VE / iDDPM / EDM superset)


def ablation_sampler(
    net,
    latents: torch.Tensor,
    condition: Optional[torch.Tensor] = None,
    auxiliary=None,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 18,
    sigma_min: Optional[float] = None,
    sigma_max: Optional[float] = None,
    rho: float = 7.0,
    solver: str = "heun",
    discretization: str = "edm",
    schedule: str = "linear",
    scaling: str = "none",
    epsilon_s: float = 1e-3,
    C_1: float = 0.001,
    C_2: float = 0.008,
    M: int = 1000,
    alpha: float = 1.0,
    S_churn: float = 0.0,
    S_min: float = 0.0,
    S_max: float = float("inf"),
    S_noise: float = 1.0,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """The generalized sampler, its schedules on the host. Step i's churn
    draws ``noise[i]`` when given."""
    assert solver in ("euler", "heun")
    assert discretization in ("vp", "ve", "iddpm", "edm")
    assert schedule in ("vp", "ve", "linear")
    assert scaling in ("vp", "none")

    vp_sigma = lambda bd, bm: lambda t: np.sqrt(np.e ** (0.5 * bd * t**2 + bm * t) - 1)  # noqa: E731
    vp_sigma_deriv = lambda bd, bm: lambda t: 0.5 * (bm + bd * t) * (  # noqa: E731
        sigma(t) + 1 / sigma(t))
    vp_sigma_inv = lambda bd, bm: lambda s: (  # noqa: E731
        np.sqrt(bm**2 + 2 * bd * np.log(s**2 + 1)) - bm) / bd
    ve_sigma = lambda t: np.sqrt(t)  # noqa: E731
    ve_sigma_deriv = lambda t: 0.5 / np.sqrt(t)  # noqa: E731
    ve_sigma_inv = lambda s: s**2  # noqa: E731

    if sigma_min is None:
        vp_def = vp_sigma(19.9, 0.1)(epsilon_s)
        sigma_min = {"vp": vp_def, "ve": 0.02, "iddpm": 0.002, "edm": 0.002}[discretization]
    if sigma_max is None:
        vp_def = vp_sigma(19.9, 0.1)(1.0)
        sigma_max = {"vp": vp_def, "ve": 100, "iddpm": 81, "edm": 80}[discretization]
    sigma_min = max(sigma_min, net.sigma_min)
    sigma_max = min(sigma_max, net.sigma_max)

    vp_beta_d = (2 * (np.log(sigma_min**2 + 1) / epsilon_s - np.log(sigma_max**2 + 1))
                 / (epsilon_s - 1))
    vp_beta_min = np.log(sigma_max**2 + 1) - 0.5 * vp_beta_d

    step_indices = np.arange(num_steps, dtype=np.float64)
    if discretization == "vp":
        orig_t = 1 + step_indices / (num_steps - 1) * (epsilon_s - 1)
        sigma_steps = vp_sigma(vp_beta_d, vp_beta_min)(orig_t)
    elif discretization == "ve":
        orig_t = (sigma_max**2) * ((sigma_min**2 / sigma_max**2) ** (step_indices / (num_steps - 1)))
        sigma_steps = ve_sigma(orig_t)
    elif discretization == "iddpm":
        u = np.zeros(M + 1)
        alpha_bar = lambda j: np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2  # noqa: E731
        for j in range(M, 0, -1):
            u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1)
        u_filtered = u[np.logical_and(u >= sigma_min, u <= sigma_max)]
        sel = np.round((len(u_filtered) - 1) / (num_steps - 1) * step_indices).astype(int)
        sigma_steps = u_filtered[sel]
    else:
        sigma_steps = (sigma_max ** (1 / rho) + step_indices / (num_steps - 1)
                       * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho

    if schedule == "vp":
        sigma = vp_sigma(vp_beta_d, vp_beta_min)
        sigma_deriv = vp_sigma_deriv(vp_beta_d, vp_beta_min)
        sigma_inv = vp_sigma_inv(vp_beta_d, vp_beta_min)
    elif schedule == "ve":
        sigma, sigma_deriv, sigma_inv = ve_sigma, ve_sigma_deriv, ve_sigma_inv
    else:
        sigma = lambda t: t  # noqa: E731
        sigma_deriv = lambda t: np.ones_like(np.asarray(t, dtype=np.float64))  # noqa: E731
        sigma_inv = lambda s: s  # noqa: E731

    if scaling == "vp":
        s_fn = lambda t: 1 / np.sqrt(1 + sigma(t) ** 2)  # noqa: E731
        s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * (s_fn(t) ** 3)  # noqa: E731
    else:
        s_fn = lambda t: np.ones_like(np.asarray(t, dtype=np.float64))  # noqa: E731
        s_deriv = lambda t: np.zeros_like(np.asarray(t, dtype=np.float64))  # noqa: E731

    t_steps = np.concatenate([sigma_inv(sigma_steps), [0.0]])
    t_cur, t_nxt = t_steps[:-1], t_steps[1:]
    gammas = np.array([
        min(S_churn / num_steps, np.sqrt(2) - 1) if (S_min <= sigma(t) <= S_max) else 0.0
        for t in t_cur
    ])
    t_hat = sigma_inv(sigma(t_cur) + gammas * sigma(t_cur))
    churn_gain = s_fn(t_hat) / s_fn(t_cur)
    churn_noise = (np.sqrt(np.maximum(sigma(t_hat) ** 2 - sigma(t_cur) ** 2, 0.0))
                   * s_fn(t_hat) * S_noise)
    h = t_nxt - t_hat
    t_prime = t_hat + alpha * h

    def _coef(t):
        # at the trailing t = 0 the coefficients feed the never-taken Heun
        # branch of the last step; sanitized, as the JAX package does
        t = np.asarray(t, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            cx = sigma_deriv(t) / sigma(t) + s_deriv(t) / s_fn(t)
            cd = sigma_deriv(t) * s_fn(t) / sigma(t)
        return (np.nan_to_num(cx, posinf=0.0, neginf=0.0),
                np.nan_to_num(cd, posinf=0.0, neginf=0.0))

    cx_hat, cd_hat = _coef(t_hat)
    cx_pr, cd_pr = _coef(t_prime)
    inv_s_hat, inv_s_pr = 1.0 / s_fn(t_hat), 1.0 / s_fn(t_prime)
    half = 1 / (2 * alpha)

    x = latents.float() * _f32(sigma(t_steps[0]) * s_fn(t_steps[0]))
    sig_hat = _levels(sigma(t_hat), x.device)
    sig_pr = _levels(sigma(t_prime), x.device)
    for i in range(num_steps):
        gain, churn = _f32(churn_gain[i]), _f32(churn_noise[i])
        x_hat = gain * x + churn * _normal(noise, i, x, generator) if churn else gain * x
        den = net(x_hat * _f32(inv_s_hat[i]), sig_hat[i], condition, auxiliary).float()
        d_cur = _f32(cx_hat[i]) * x_hat - _f32(cd_hat[i]) * den
        if solver == "heun" and i < num_steps - 1:
            x_prime = x_hat + _f32(alpha, h[i]) * d_cur
            den2 = net(x_prime * _f32(inv_s_pr[i]), sig_pr[i], condition, auxiliary).float()
            d_prime = _f32(cx_pr[i]) * x_prime - _f32(cd_pr[i]) * den2
            x = x_hat + _f32(h[i]) * (_f32(1 - half) * d_cur + _f32(half) * d_prime)
        else:
            x = x_hat + _f32(h[i]) * d_cur
    return x


# ----------------------------------------------------------------------------
# DPM-Solver(++) 2M on TrigFlow time


def dpm_solver(
    net,
    latents: torch.Tensor,
    condition: Optional[torch.Tensor] = None,
    auxiliary=None,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 20,
    use_pp: bool = True,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """2nd-order multistep DPM solver on t = atan(σ/σ_d). Deterministic:
    ``generator`` is not drawn from and ``noise`` is not read."""
    sigma_data = net.sigma_data
    ramp = np.linspace(0, 1, num_steps)
    sigmas = (sigma_max ** (1 / rho)
              + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    t_steps = np.concatenate([np.arctan(sigmas / sigma_data), [0.0]])

    s_arr, t_arr = t_steps[:-1], t_steps[1:]
    delta = s_arr - t_arr
    logtan = lambda u: np.log(np.tan(np.clip(u, 1e-4, 1.569)))  # noqa: E731
    denom = np.sin(s_arr) if use_pp else np.cos(s_arr)
    # the 2M correction coefficient; 0 on the first-order steps (k = 0, the last)
    coefs = np.zeros(num_steps)
    for k in range(1, num_steps - 1):
        r_s = (logtan(s_arr[k]) - logtan(s_arr[k - 1])) / (logtan(s_arr[k]) - logtan(t_arr[k]))
        c = np.sin(delta[k]) / (2 * r_s * max(denom[k], 1e-3))
        coefs[k] = c if use_pp else -c

    x = latents.float() * _f32(sigma_data)
    levels = _levels(s_arr, x.device)
    pred_prev = None
    for i in range(num_steps):
        cos_s, sin_s = np.cos(s_arr[i]), np.sin(s_arr[i])
        F_s = net(x / _f32(sigma_data), levels[i], condition, auxiliary).float()
        if use_pp:
            pred = _f32(cos_s) * x - _f32(sin_s, sigma_data) * F_s
        else:
            pred = _f32(sin_s) * x + _f32(cos_s, sigma_data) * F_s
        x_next = _f32(np.cos(delta[i])) * x - _f32(np.sin(delta[i]), sigma_data) * F_s
        coef = _f32(coefs[i])
        if coef:
            x_next = x_next + coef * (pred_prev - pred)
        x, pred_prev = x_next, pred
    return x


def dpm_solver_2s(
    net,
    latents: torch.Tensor,
    condition: Optional[torch.Tensor] = None,
    auxiliary=None,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 20,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    S_churn: float = 0.0,
    S_min: float = 0.0,
    S_max: float = 1.57,
    S_noise: float = 1.0,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """DPM-Solver++ 2S: a Heun step on v-prediction, the last step Euler.
    Deterministic (the churn arguments and ``noise`` are accepted and
    unused, as the churn arguments in the JAX package)."""
    sigma_data = net.sigma_data
    t_steps = np.concatenate(
        [_loguniform_t_steps(num_steps, sigma_min, sigma_max, sigma_data), [0.0]])
    x = latents.float() * _f32(sigma_data)
    levels = _levels(t_steps, x.device)
    for i in range(num_steps):
        delta = np.float32(np.float32(t_steps[i + 1]) - np.float32(t_steps[i]))
        F_s = net(x / _f32(sigma_data), levels[i], condition, auxiliary).float()
        x_euler = x + _f32(delta, sigma_data) * F_s
        if i < num_steps - 1:
            F_t = net(x_euler / _f32(sigma_data), levels[i + 1], condition, auxiliary).float()
            x = x + _f32(delta, sigma_data, 0.5) * (F_s + F_t)
        else:
            x = x_euler
    return x


# ----------------------------------------------------------------------------
# Consistency samplers


def _scm_t_steps(num_steps: int, sigma_min: float, sigma_max: float, sigma_data: float,
                 intermediates: Optional[Sequence[float]]) -> np.ndarray:
    if num_steps == 1:
        t_steps = np.array([np.pi / 2])
    else:
        t_steps = _loguniform_t_steps(num_steps, sigma_min, sigma_max, sigma_data)
    t_steps = np.concatenate([t_steps, [0.0]])
    if num_steps == 2 and intermediates is None:
        # the sCM paper's intermediate for the 2-step sampler
        t_steps = np.array([t_steps[0], 1.1, 0.0])
    elif intermediates:
        t_steps = np.concatenate([t_steps[:1], np.asarray(intermediates), t_steps[-1:]])
    return t_steps


def scm_solver(
    net,
    latents: torch.Tensor,
    condition: Optional[torch.Tensor] = None,
    auxiliary=None,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 2,
    intermediates: Optional[Sequence[float]] = None,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Multistep consistency sampler. ``net(x, t, condition, auxiliary)``.

    The re-noise of step i ≥ 1 draws standard normals from ``generator``,
    or takes ``noise[i - 1]`` when given (so tests can hand both frameworks
    the same numbers)."""
    sigma_data = net.sigma_data
    t_steps = _scm_t_steps(num_steps, sigma_min, sigma_max, sigma_data, intermediates)
    x_t = latents.float() * sigma_data
    for i, t in enumerate(float(s) for s in t_steps[:-1]):
        cos_t, sin_t = math.cos(t), math.sin(t)
        if i > 0:
            z = noise[i - 1] if noise is not None else torch.randn(
                x_t.shape, generator=generator, device=x_t.device)
            x_t = sin_t * (sigma_data * z.float()) + cos_t * x_t
        F_t = net(x_t / sigma_data, torch.tensor(t, dtype=torch.float32), condition,
                  auxiliary).float()
        x_t = cos_t * x_t - sin_t * sigma_data * F_t
    return x_t


def scm_solve2(
    net,
    latents: torch.Tensor,
    condition: Optional[torch.Tensor] = None,
    auxiliary=None,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 2,
    intermediates: Optional[Sequence[float]] = None,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Few-step TrigFlow sampler that injects noise after each step (with
    more than one step); step i draws ``noise[i]`` when given."""
    sigma_data = net.sigma_data
    t_steps = _loguniform_t_steps(num_steps, sigma_min, sigma_max, sigma_data)
    t_steps = np.concatenate([t_steps, [0.0]])
    if num_steps == 2:
        t_steps = np.array([t_steps[0], 1.1, 0.0])
    elif intermediates and num_steps > 2:
        t_steps = np.concatenate([t_steps[:1], np.asarray(intermediates), t_steps[-1:]])
    n = len(t_steps) - 1
    x = latents.float() * _f32(sigma_data)
    levels = _levels(t_steps, x.device)
    for i in range(n):
        s, t = t_steps[i], t_steps[i + 1]
        F_s = net(x / _f32(sigma_data), levels[i], condition, auxiliary).float()
        x = _f32(np.cos(s)) * x - _f32(np.sin(s), sigma_data) * F_s
        if n > 1:
            z = _f32(sigma_data) * _normal(noise, i, x, generator)
            x = _f32(np.cos(t)) * x + _f32(np.sin(t)) * z
    return x
