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
leaves them to XLA.

Over several ranks (``ns_split`` = (rank, world)) the Newton-Schulz work is
split, as the JAX package's ``_sharded_orthogonalize`` splits the stack of
matrices over the devices: matrix i goes to rank i mod world, and the
results come back to every rank by one exact all-reduce of -0.0-padded
buffers (:func:`orthogonalize_split`). Under tensor parallelism a weight of
which this rank holds a slice (``shards``, a
``swift_torch.parallel.sharding.Shard`` per Muon parameter or None) first
has its blended update gathered over ``model_group`` to the whole matrix,
and keeps its slice of the result: ``_tp_sharded_orthogonalize``'s result,
gathered by an all-reduce in place of its ``all_to_all``. Newton-Schulz,
its aspect factor included, always sees the whole matrix, so an update
split over ranks equals one rank's bit for bit on the same device. The
momentum (and its stochastic rounding, whose bits are drawn for the whole
matrix and sliced) is elementwise and runs on the slice.

``momentum_dtype="bfloat16"`` keeps the Muon momentum in bf16 (half the
state): the blend is taken in fp32 and stochastically rounded into the
buffer (:func:`stochastic_round_bf16`), so an increment below half a bf16
ulp still moves it in expectation. The random bits come from the
optimizer's own ``torch.Generator``, seeded from the step count (the
Muon parameters' ``step`` state) at every step, so a resumed run draws what
an unbroken one would; the JAX package draws them from ``fold_in(PRNGKey(
0x5357), count)``, which torch cannot replay, so the tests hold the
rounding to JAX's on shared bits. A checkpoint stores the buffer's exact
fp32 value (numpy has no bf16); ``load_state_dict`` casts it back.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from swift_torch.parallel import mesh


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


_SR_SEED = 0x5357  # the JAX package's PRNGKey of the rounding bits


def stochastic_round_bf16(x32: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding: the low 16 bits of ``bits``
    (an integer tensor like ``x32``) are added to the 16 mantissa bits bf16
    drops, then truncated (the JAX package's ``_stochastic_round_bf16``;
    E[round(x)] = x)."""
    i = x32.float().contiguous().view(torch.int32)
    i = (i + (bits & 0xFFFF).to(torch.int32)) & -65536  # two's complement wrap = uint32's
    return i.view(torch.float32).to(torch.bfloat16)


def orthogonalized_update(u: torch.Tensor, ns_steps: int = 5) -> torch.Tensor:
    """The Muon direction of an (out, in) weight's momentum-blended update,
    fp32: orthogonalized and aspect-scaled on the (in, out) layout."""
    j = u.transpose(-1, -2)
    o = newton_schulz(j, ns_steps) * max(1.0, j.shape[-2] / j.shape[-1]) ** 0.5
    return o.transpose(-1, -2).float()


def orthogonalize_split(updates: Sequence[torch.Tensor], ns_steps: int = 5,
                        ns_split: tuple[int, int] = (0, 1)) -> list[torch.Tensor]:
    """:func:`orthogonalized_update` of each of ``updates`` (whole (out, in)
    matrices, alike on every rank), the work split over the ranks: rank r of
    ``ns_split`` = (r, world) computes matrices i ≡ r (mod world), and one
    all-reduce of the results, -0.0 where a rank did not compute a matrix,
    hands every rank all of them exactly (x + -0.0 = x)."""
    r, world = ns_split
    if world == 1:
        return [orthogonalized_update(u, ns_steps) for u in updates]
    out = [orthogonalized_update(u, ns_steps) if i % world == r
           else torch.full(u.shape, -0.0, dtype=torch.float32, device=u.device)
           for i, u in enumerate(updates)]
    mesh.all_reduce_sum(out)
    return out


class MuonWithAuxAdam(torch.optim.Optimizer):
    """Muon for ``muon_params`` (2-D weights), the auxiliary Adam for
    ``adam_params``; weight decay applies to every parameter of each group
    (no mask), as ``optax.add_decayed_weights`` does in the JAX package.
    Each group keeps its ``base_lr`` beside the ``lr`` the trainer sets from
    the schedule before every step. ``shards`` (one entry a Muon parameter,
    a ``Shard`` or None), ``model_group`` and ``ns_split`` lay the
    Newton-Schulz work over ranks (see the module docstring); by default
    each matrix is whole and orthogonalized here."""

    def __init__(self, muon_params: Iterable[torch.Tensor], adam_params: Iterable[torch.Tensor],
                 lr: float = 0.02, weight_decay: float = 0.01, momentum: float = 0.95,
                 ns_steps: int = 5, adam_lr: float = 3e-4, adam_betas=(0.9, 0.95),
                 adam_weight_decay: float = 0.01, adam_eps: float = 1e-10,
                 momentum_dtype: Optional[str] = None, shards: Optional[Sequence] = None,
                 model_group=None, ns_split: tuple[int, int] = (0, 1)):
        if momentum_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"momentum_dtype {momentum_dtype!r}: float32 or bfloat16")
        self.stochastic_rounding = momentum_dtype == "bfloat16"
        self._gens: dict = {}
        muon_params = list(muon_params)
        self._shards = {id(p): sh for p, sh in zip(muon_params, shards or ()) if sh is not None}
        self.model_group, self.ns_split = model_group, tuple(ns_split)
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

    def state_keys(self, group) -> set:
        """The state keys a parameter of ``group`` gets."""
        if group["kind"] == "adam":
            return {"step", "exp_avg", "exp_avg_sq"}
        return {"momentum_buffer", "step"} if self.stochastic_rounding else {"momentum_buffer"}

    def load_state_dict(self, state_dict):
        """The torch loader casts every floating state to its parameter's
        dtype; a bf16 momentum saved as its exact fp32 value goes back to
        bf16 here, bit for bit."""
        super().load_state_dict(state_dict)
        if self.stochastic_rounding:
            for st in self.state.values():
                if "momentum_buffer" in st:
                    st["momentum_buffer"] = st["momentum_buffer"].to(torch.bfloat16)

    def _bits(self, shape, device, count: int, index: int) -> torch.Tensor:
        """Rounding bits for the ``index``-th Muon parameter at step
        ``count``: a function of (count, index) alone."""
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        gen.manual_seed((_SR_SEED << 40) + (count << 20) + index)
        return torch.randint(0, 1 << 16, shape, generator=gen, device=device, dtype=torch.int32)

    def _blend(self, group, index: int, p: torch.Tensor) -> torch.Tensor:
        """The momentum step of the ``index``-th Muon parameter (its slice
        under tensor parallelism) and its Nesterov-blended update, fp32."""
        mu, sr = group["momentum"], self.stochastic_rounding
        g = p.grad.float()
        st = self.state[p]
        if "momentum_buffer" not in st:
            st["momentum_buffer"] = torch.zeros_like(
                p, dtype=torch.bfloat16 if sr else torch.float32)
            if sr:
                st["step"] = torch.zeros((), dtype=torch.float32)
        m = st["momentum_buffer"]
        blend = m.float() + (1 - mu) * (g - m.float())
        if sr:
            st["step"] += 1
            shard = self._shards.get(id(p))
            bits = self._bits(shard.full if shard else p.shape, p.device, int(st["step"]), index)
            m.copy_(stochastic_round_bf16(blend, shard.take(bits) if shard else bits))
        else:
            m.copy_(blend)
        return g + mu * (m.float() - g)

    def _muon(self, group, params):
        lr, wd, ns = group["lr"], group["weight_decay"], group["ns_steps"]

        def apply(p, o):
            p.add_(((o + wd * p) * -lr).to(p.dtype))

        if self.ns_split[1] == 1 and not self._shards:
            for index, p in enumerate(params):
                apply(p, orthogonalized_update(self._blend(group, index, p), ns))
            return
        shards = [self._shards.get(id(p)) for p in params]
        updates = [self._blend(group, index, p) for index, p in enumerate(params)]
        whole = {i: sh.place(u) for i, (u, sh) in enumerate(zip(updates, shards)) if sh}
        mesh.all_reduce_sum(list(whole.values()), self.model_group)
        outs = orthogonalize_split([whole.get(i, u) for i, u in enumerate(updates)], ns,
                                   self.ns_split)
        for p, o, sh in zip(params, outs, shards):
            apply(p, sh.take(o) if sh else o)

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
