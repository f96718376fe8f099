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

Under tensor parallelism a rank holds slices of the split weights
(``shards``), and the matrix branch is not elementwise: the clip takes the
norm of the whole corrected gradient, and mars-shampoo's Newton-Schulz and
aspect factor the whole matrix, as the JAX package's global sums do. Each
step gathers the slices' c_t over ``model_group`` (-0.0-padded, summed
exactly in one all-reduce) for their norms, and mars-shampoo their momenta
for Newton-Schulz, keeping this rank's slice of the result; the moments
stay on the slices, and every other parameter is updated alone, as one
process updates each. A split step equals one process's bit for bit on the
same gradients.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from swift_torch.parallel import mesh
from swift_torch.training.optimizers.muon import newton_schulz

MARS_TYPES = ("mars-adamw", "mars-lion", "mars-shampoo")


class MARS(torch.optim.Optimizer):
    """One parameter group over ``params`` of base lr ``lr`` (``base_lr``
    kept beside the ``lr`` the trainer sets). State a parameter:
    ``exp_avg``, ``exp_avg_sq``, ``last_grad`` and the shared ``step``.
    ``shards`` (one entry a parameter, a ``Shard`` or None) and
    ``model_group`` name the slices a tensor-parallel rank holds (see the
    module docstring)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 3e-3, betas=(0.95, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0, gamma: float = 0.025,
                 mars_type: str = "mars-adamw", lr_1d: float = 3e-3, betas_1d=(0.9, 0.95),
                 weight_decay_1d: float = 0.1, shards: Optional[Sequence] = None,
                 model_group=None):
        if mars_type not in MARS_TYPES:
            raise ValueError(f"mars_type {mars_type!r} not in {MARS_TYPES}")
        defaults = dict(lr=lr, base_lr=lr, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay, gamma=gamma, mars_type=mars_type,
                        lr_1d=lr_1d, betas_1d=tuple(betas_1d),
                        weight_decay_1d=weight_decay_1d)
        params = list(params)
        super().__init__(params, defaults)
        self._shards = {id(p): sh for p, sh in zip(params, shards or ()) if sh is not None}
        self.model_group = model_group

    def state_keys(self, group) -> set:
        return {"step", "exp_avg", "exp_avg_sq", "last_grad"}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MARS takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            split = [p for p in params if id(p) in self._shards]
            for p in params:
                self._advance(p)
            # a split matrix's clip takes the whole matrix's norm: its slices gathered at once
            cs = self._whole(split, [self._corrected(group, p) for p in split])
            norms = {id(p): torch.sqrt(torch.sum(c ** 2)) for p, c in zip(split, cs)}
            del cs
            deferred = []  # split matrices of mars-shampoo, whose momentum is gathered
            for p in params:
                if p.ndim != 2:
                    self._apply(group, p, None)
                    continue
                c = self._corrected(group, p)
                norm = norms[id(p)] if id(p) in norms else torch.sqrt(torch.sum(c ** 2))
                self._moments(group, p, torch.where(norm > 1.0, c / norm, c))
                if group["mars_type"] == "mars-shampoo" and id(p) in norms:
                    deferred.append(p)
                else:
                    self._apply(group, p, self._direction(group, p))
            moms = self._whole(deferred, [self.state[p]["exp_avg"] for p in deferred])
            for p, m in zip(deferred, moms):
                self._apply(group, p, self._shampoo(group, p, m))

    def _advance(self, p):
        st = self.state[p]
        if "step" not in st:
            st["step"] = torch.zeros((), dtype=torch.float32)
            for k in ("exp_avg", "exp_avg_sq", "last_grad"):
                st[k] = torch.zeros_like(p, dtype=torch.float32)
        st["step"] += 1

    def _corrected(self, group, p) -> torch.Tensor:
        """A matrix's corrected gradient c_t (its slice under tensor
        parallelism)."""
        b1 = group["betas"][0]
        g = p.grad.float()
        return g + group["gamma"] * (b1 / (1 - b1)) * (g - self.state[p]["last_grad"])

    def _whole(self, mats, parts) -> list[torch.Tensor]:
        """Each of ``parts`` (one a matrix of ``mats``, fp32) as the whole
        matrix: a split weight's slice placed in -0.0 and summed exactly over
        the model group (the ranks' slices in one all-reduce), the rest as
        they are."""
        whole = {i: self._shards[id(p)].place(t)
                 for i, (p, t) in enumerate(zip(mats, parts)) if id(p) in self._shards}
        mesh.all_reduce_sum(list(whole.values()), self.model_group)
        return [whole.get(i, t) for i, t in enumerate(parts)]

    def _moments(self, group, p, c):
        """The moments of a matrix from its clipped ``c``, in place."""
        b1, b2 = group["betas"]
        st = self.state[p]
        st["exp_avg"].copy_(b1 * st["exp_avg"] + (1 - b1) * c)
        if group["mars_type"] == "mars-adamw":
            st["exp_avg_sq"].copy_(b2 * st["exp_avg_sq"] + (1 - b2) * c * c)

    def _direction(self, group, p) -> torch.Tensor:
        """The MARS direction of a whole matrix."""
        st = self.state[p]
        m, v, step = st["exp_avg"], st["exp_avg_sq"], float(st["step"])
        if group["mars_type"] == "mars-lion":
            return torch.sign(m)
        if group["mars_type"] == "mars-shampoo":
            return self._shampoo(group, p, m)
        b1, b2 = group["betas"]
        denom = (torch.sqrt(v) / (1 - b2 ** step) ** 0.5 + group["eps"]) * (1 - b1 ** step)
        return m / denom

    def _shampoo(self, group, p, m) -> torch.Tensor:
        """mars-shampoo's direction from the whole matrix's momentum ``m``:
        Newton-Schulz and the aspect factor on the JAX (in, out) layout, then
        this rank's slice of a split one."""
        j = (m * (1.0 / (1 - group["betas"][0]))).transpose(-1, -2)
        factor = max(1.0, j.shape[0] / j.shape[1]) ** 0.5
        o = (newton_schulz(j).float() * factor).transpose(-1, -2)
        shard = self._shards.get(id(p))
        return shard.take(o) if shard else o

    def _apply(self, group, p, upd):
        """The update of ``p`` from its matrix direction ``upd``, or the 1-D
        branch's AdamW where ``upd`` is None; then ``last_grad``."""
        st = self.state[p]
        g = p.grad.float()
        if upd is not None:
            wd = group["weight_decay"]
        else:
            b1, b2 = group["betas_1d"]
            m, v, step = st["exp_avg"], st["exp_avg_sq"], float(st["step"])
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            denom = (torch.sqrt(v) / (1 - b2 ** step) ** 0.5 + group["eps"]) * (1 - b1 ** step)
            upd = group["lr_1d"] * (m / denom)
            wd = group["weight_decay_1d"]
        st["last_grad"].copy_(g)
        p.add_((group["lr"] * -(upd + wd * p)).to(p.dtype))
