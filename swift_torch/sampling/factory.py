"""Sampler factory: ``sampler_factory(mode, net, **solver_kwargs)``.

Counterpart of ``swift_tpu/sampling/factory.py``. The returned
``sampler(X, generator, auxiliary=None, latents=None, noise=None)`` draws
fresh latents from the explicit ``torch.Generator`` (or takes ``latents``)
and runs the solver conditioned on ``X`` (NHWC); ``noise``, when given,
stands in for the solver's re-noise draws (``noise[i]`` its i-th; the
deterministic solvers draw none). ``_SOLVERS`` holds the JAX package's
keys; ``solvers.scm_solve2`` stays a function, as there.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from swift_torch.sampling import solvers

_SOLVERS = {
    "edm": solvers.edm_sampler,
    "scm": solvers.scm_solver,
    "2s": solvers.dpm_solver_2s,
    "dpm": solvers.dpm_solver,
    "ablation": solvers.ablation_sampler,
}


def sampler_factory(mode: str, net, **solver_kwargs) -> Callable[..., torch.Tensor]:
    if mode not in _SOLVERS:
        raise ValueError(f"Unknown solver mode: {mode} (available: {sorted(_SOLVERS)})")
    solver = _SOLVERS[mode]
    # auxiliary may come from config (interval Δ/10); a call-time value overrides
    cfg_aux = solver_kwargs.pop("auxiliary", None)

    def sampler(X: torch.Tensor, generator: Optional[torch.Generator] = None, auxiliary=None,
                latents: Optional[torch.Tensor] = None,
                noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        aux = auxiliary if auxiliary is not None else cfg_aux
        if aux is not None:  # on the device once a sample, not at every network evaluation
            aux = torch.as_tensor(aux, dtype=torch.float32, device=X.device)
        if latents is None:
            H, W = net.img_resolution
            latents = torch.randn((X.shape[0], H, W, net.img_channels), generator=generator,
                                  device=X.device)
        kwargs = dict(solver_kwargs, noise=noise) if noise is not None else solver_kwargs
        return solver(net, latents, condition=X, auxiliary=aux, generator=generator, **kwargs)

    return sampler
