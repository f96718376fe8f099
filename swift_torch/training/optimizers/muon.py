"""Muon — MomentUm Orthogonalized by Newton-Schulz — with an auxiliary Adam.

Counterpart of ``swift_tpu/training/optimizers/muon.py`` (reference
src/swift/training/optimizers/muon.py): Nesterov momentum, a quintic
Newton-Schulz orthogonalization in bfloat16, the aspect-ratio scale
max(1, rows/cols)^0.5 and decoupled weight decay for the hidden matrices;
a hand-rolled bias-corrected Adam (eps after the bias correction) with
decoupled weight decay for everything else. Which parameter goes where is
``swift_torch.training.trainer.muon_param_labels``.

Layout: a torch ``nn.Linear`` weight is (out, in), the transpose of the JAX
package's Dense kernel (in, out). The update is orthogonalized on the JAX
layout — Newton-Schulz on the transposed view, and the aspect factor
max(1, in/out)^0.5 — so both packages take the same step. (The reference
torch code applies the factor to (out, in); the JAX package departs from it
there.)

As a ``torch.optim.Optimizer`` with a "muon" and an "adam" parameter group,
its state (``momentum_buffer``; ``step``, ``exp_avg``, ``exp_avg_sq``) goes
through the trainer's checkpoint helpers unchanged. Newton-Schulz runs on
``torch.matmul``, plain products outside any kernel, as the JAX package
leaves them to XLA. Not ported: the bf16 stochastically-rounded momentum
buffer (``momentum_dtype``) and the mesh-sharded Newton-Schulz.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


# (a, b, c) of the quintic iteration, rounded to bfloat16 (see newton_schulz)
_NS_COEFFS = tuple(torch.tensor(v, dtype=torch.bfloat16).item() for v in (3.4445, -4.7750, 2.0315))


def newton_schulz(G: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalization in bfloat16 of the trailing
    two dims, run on the short side (the JAX package's ``newton_schulz``).

    The coefficients are taken in bfloat16 (3.4375, -4.78125, 2.03125), as
    the JAX package's weakly typed Python constants become bf16 against its
    bf16 operands; PyTorch would keep them at full precision, and the five
    iterations amplify that difference to ~10% of an element."""
    if G.ndim < 2:
        raise ValueError(f"newton_schulz needs a matrix, got shape {tuple(G.shape)}")
    a, b, c = _NS_COEFFS
    X = G.to(torch.bfloat16)
    transposed = G.shape[-2] > G.shape[-1]
    if transposed:
        X = X.transpose(-1, -2)
    norm = torch.sqrt(torch.sum(X.float() ** 2, dim=(-2, -1), keepdim=True)).to(torch.bfloat16)
    X = X / (norm + 1e-7)
    for _ in range(steps):
        A = torch.matmul(X, X.transpose(-1, -2))
        B = b * A + c * torch.matmul(A, A)
        X = a * X + torch.matmul(B, X)
    if transposed:
        X = X.transpose(-1, -2)
    return X


def orthogonalized_update(u: torch.Tensor, ns_steps: int = 5) -> torch.Tensor:
    """The Muon direction of an (out, in) weight's momentum-blended update,
    fp32: orthogonalized and aspect-scaled on the (in, out) layout."""
    j = u.transpose(-1, -2)
    o = newton_schulz(j, ns_steps) * max(1.0, j.shape[-2] / j.shape[-1]) ** 0.5
    return o.transpose(-1, -2).float()


class MuonWithAuxAdam(torch.optim.Optimizer):
    """Muon for ``muon_params`` (2-D weights), the auxiliary Adam for
    ``adam_params``; weight decay applies to every parameter of each group
    (no mask), as ``optax.add_decayed_weights`` does in the JAX package.
    Each group keeps its ``base_lr`` beside the ``lr`` the trainer sets from
    the schedule before every step."""

    def __init__(self, muon_params: Iterable[torch.Tensor], adam_params: Iterable[torch.Tensor],
                 lr: float = 0.02, weight_decay: float = 0.01, momentum: float = 0.95,
                 ns_steps: int = 5, adam_lr: float = 3e-4, adam_betas=(0.9, 0.95),
                 adam_weight_decay: float = 0.01, adam_eps: float = 1e-10,
                 momentum_dtype: Optional[str] = None):
        if momentum_dtype is not None:
            raise NotImplementedError(
                "momentum_dtype (the bf16 stochastically-rounded Muon momentum) is not ported")
        groups = [
            dict(params=list(muon_params), kind="muon", lr=lr, base_lr=lr,
                 weight_decay=weight_decay, momentum=momentum, ns_steps=ns_steps),
            dict(params=list(adam_params), kind="adam", lr=adam_lr, base_lr=adam_lr,
                 betas=tuple(adam_betas), eps=adam_eps, weight_decay=adam_weight_decay),
        ]
        for g in groups:
            if g["kind"] == "muon" and any(p.ndim != 2 for p in g["params"]):
                raise ValueError("Muon takes 2-D weights only")
        super().__init__(groups, {})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MuonWithAuxAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            (self._muon if group["kind"] == "muon" else self._adam)(group, params)

    def _muon(self, group, params):
        mu, lr, wd = group["momentum"], group["lr"], group["weight_decay"]
        for p in params:
            g = p.grad.float()
            st = self.state[p]
            if "momentum_buffer" not in st:
                st["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
            m = st["momentum_buffer"]
            m.copy_(m + (1 - mu) * (g - m))
            o = orthogonalized_update(g + mu * (m - g), group["ns_steps"])
            p.add_(((o + wd * p) * -lr).to(p.dtype))

    def _adam(self, group, params):
        (b1, b2), eps, lr, wd = group["betas"], group["eps"], group["lr"], group["weight_decay"]
        for p in params:
            g = p.grad.float()
            st = self.state[p]
            if "step" not in st:
                st["step"] = torch.zeros((), dtype=torch.float32)
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            st["step"] += 1
            count = float(st["step"])
            m, v = st["exp_avg"], st["exp_avg_sq"]
            m.copy_(m + (1 - b1) * (g - m))
            v.copy_(v + (1 - b2) * (g * g - v))
            c1, c2 = 1 - b1 ** count, 1 - b2 ** count
            out = (m / c1) / (torch.sqrt(v / c2) + eps)
            p.add_(((out + wd * p) * -lr).to(p.dtype))
