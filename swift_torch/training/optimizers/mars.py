"""MARS — a variance-reduced optimizer (mars-adamw, mars-lion, mars-shampoo).

Counterpart of ``swift_tpu/training/optimizers/mars.py`` (reference
src/swift/training/optimizers/mars.py, itself from AGI-Arena/MARS, arXiv
2411.10438), in its approximate form: ``last_grad`` is the previous step's
gradient (reference :301-302).

  * the corrected gradient c_t = g + γ·β1/(1−β1)·(g − last_grad), scaled to
    unit norm where its norm exceeds 1 (:39-42);
  * mars-adamw: bias-corrected Adam moments of c_t (:44-65); mars-lion: the
    sign of the momentum (:66-67); mars-shampoo: Newton-Schulz (the port's
    ``muon.newton_schulz``, in bf16) of the bias-scaled momentum, with the
    aspect factor (:68-75); each with decoupled weight decay;
  * every other parameter takes plain AdamW with ``betas_1d`` and
    ``weight_decay_1d`` (:77-103; the JAX package's ``optimize_1d``, which
    no config sets, is not ported).

A 2-D torch weight (out, in) is the JAX package's Dense kernel (in, out)
transposed: Newton-Schulz and the aspect factor max(1, in/out)^0.5 are
taken on the JAX layout, as the port's Muon takes them. The branch is
chosen per torch tensor, which is the JAX package's choice on its unstacked
(``block{i}``) layout; on its stacked ``pairs`` layout a block's kernels
are 3-D and its vectors 2-D there (ROADMAP C).

The trainer sets ``lr`` from the schedule before each step. The 1-D
branch's update is scaled by ``lr_1d`` on top of that lr, not replaced by
it: the JAX package's ``lr_1d_factor`` is ``lr_1d / 1.0`` when the
learning rate is a schedule, as the factory's always is (ROADMAP C).
"""

from __future__ import annotations

from typing import Iterable

import torch

from swift_torch.training.optimizers.muon import newton_schulz

MARS_TYPES = ("mars-adamw", "mars-lion", "mars-shampoo")


class MARS(torch.optim.Optimizer):
    """One parameter group over ``params`` of base lr ``lr`` (``base_lr``
    kept beside the ``lr`` the trainer sets). State a parameter:
    ``exp_avg``, ``exp_avg_sq``, ``last_grad`` and the shared ``step``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 3e-3, betas=(0.95, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0, gamma: float = 0.025,
                 mars_type: str = "mars-adamw", lr_1d: float = 3e-3, betas_1d=(0.9, 0.95),
                 weight_decay_1d: float = 0.1):
        if mars_type not in MARS_TYPES:
            raise ValueError(f"mars_type {mars_type!r} not in {MARS_TYPES}")
        defaults = dict(lr=lr, base_lr=lr, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay, gamma=gamma, mars_type=mars_type,
                        lr_1d=lr_1d, betas_1d=tuple(betas_1d),
                        weight_decay_1d=weight_decay_1d)
        super().__init__(params, defaults)

    def state_keys(self, group) -> set:
        return {"step", "exp_avg", "exp_avg_sq", "last_grad"}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MARS takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(group, p)

    def _update(self, group, p):
        g = p.grad.float()
        st = self.state[p]
        if "step" not in st:
            st["step"] = torch.zeros((), dtype=torch.float32)
            for k in ("exp_avg", "exp_avg_sq", "last_grad"):
                st[k] = torch.zeros_like(p, dtype=torch.float32)
        st["step"] += 1
        step = float(st["step"])
        m, v, last = st["exp_avg"], st["exp_avg_sq"], st["last_grad"]
        eps = group["eps"]
        if p.ndim == 2:
            upd = self._mars(group, g, last, m, v, step)
            wd = group["weight_decay"]
        else:
            b1, b2 = group["betas_1d"]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            denom = (torch.sqrt(v) / (1 - b2 ** step) ** 0.5 + eps) * (1 - b1 ** step)
            upd = group["lr_1d"] * (m / denom)
            wd = group["weight_decay_1d"]
        last.copy_(g)
        p.add_((group["lr"] * -(upd + wd * p)).to(p.dtype))

    @staticmethod
    def _mars(group, g, last, m, v, step: float) -> torch.Tensor:
        """The MARS direction of a matrix; updates ``m`` (and ``v``) in
        place."""
        b1, b2 = group["betas"]
        kind = group["mars_type"]
        c = g + group["gamma"] * (b1 / (1 - b1)) * (g - last)
        norm = torch.sqrt(torch.sum(c ** 2))
        c = torch.where(norm > 1.0, c / norm, c)
        m.copy_(b1 * m + (1 - b1) * c)
        if kind == "mars-adamw":
            v.copy_(b2 * v + (1 - b2) * c * c)
            denom = (torch.sqrt(v) / (1 - b2 ** step) ** 0.5 + group["eps"]) * (1 - b1 ** step)
            return m / denom
        if kind == "mars-lion":
            return torch.sign(m)
        # mars-shampoo, on the JAX (in, out) layout
        j = (m * (1.0 / (1 - b1))).transpose(-1, -2)
        factor = max(1.0, j.shape[0] / j.shape[1]) ** 0.5
        return (newton_schulz(j).float() * factor).transpose(-1, -2)
