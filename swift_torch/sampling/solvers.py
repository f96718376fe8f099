"""Consistency (sCM / TrigFlow) sampler.

Counterpart of ``swift_tpu/sampling/solvers.py::scm_solver``. One step
evaluates the net once at t = π/2: x = cos(t)·x_t − sin(t)·σ_d·F(x_t/σ_d, t).
More steps re-noise at each intermediate t. The other solvers of the JAX
package (EDM Heun, DPM, the ablation sampler, scm_solve2) are not ported
yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def _loguniform_t_steps(num_steps: int, sigma_min: float, sigma_max: float,
                        sigma_data: float) -> np.ndarray:
    u = np.linspace(1.0, 0.0, num_steps)
    tau = np.exp(np.log(sigma_min) + u * (np.log(sigma_max) - np.log(sigma_min)))
    return np.arctan(tau / sigma_data)


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
