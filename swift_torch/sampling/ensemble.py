"""Ensemble forecast engine, one device a process.

Counterpart of ``swift_tpu/sampling/ensemble.py::EnsembleRollout``:

  * all (member × IC) rollouts run as one batch: members are tiled
    member-major into the leading axis (row m·B + b);
  * the horizon runs in segments of ``segment`` steps, each filling an
    on-device trajectory buffer with the residual update applied;
  * a finished segment is copied to pinned host memory and written to the
    store while the next segment computes.

Under data parallelism (``swift_torch.parallel``) each rank rolls out a
contiguous block of whole members, ceil(M / world) of them: the member
count is padded to a multiple of the world size by repeating members (pad
member j is member j mod M, the JAX engine's ``arange(pad) % MB``) and the
pad is dropped at flush. A zarr chunk holds one member (``utils.io``), so
no chunk has two writers. Under a pipe axis the members go by the data
index: the stage ranks of a data row roll out the same members together
(``parallel.pipeline``) and only the first stage writes them. The JAX engine splits the (member × IC) rows over
devices instead, and falls back to latitude sharding; the port shards
members only.

Latents come from a ``torch.Generator`` seeded from (base_seed, ic_start,
step), so a forecast is reproducible; they are not jax.random's numbers.
Every rank draws the whole (M·B) batch's latents and re-noise, in the
solver's order, and hands the sampler its rows (``latents=``, ``noise=``),
so the store is the one-rank store whatever the rank count (on one rank the
rows are all of them, the draws those the sampler would make itself). The
engine runs on CUDA unless it is handed ``device="cpu"``, and raises where
CUDA is absent.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from swift_torch.data.standardize import Standardizer
from swift_torch.parallel.mesh import data_rank, data_size, layout
from swift_torch.utils.device import resolve_device


def member_block(members: int, rank: int, world: int) -> np.ndarray:
    """The members rank ``rank`` of ``world`` rolls out: a contiguous block
    of ceil(members / world) of the member list padded to a multiple of
    ``world``, pad members repeating members from the first; an entry ≥
    ``members`` is a pad member (member ``entry % members``)."""
    per = -(-members // world)
    return np.arange(rank * per, (rank + 1) * per)


class RowDraws:
    """Standard normals drawn for the whole batch of ``shape`` from
    ``generator``, one draw a read, of which ``rows`` are kept:
    ``noise[i]`` as the solvers read their i-th re-noise, each index once
    and in increasing order (a solver that skips a step draws nothing for
    it, here as in one process)."""

    def __init__(self, generator: torch.Generator, shape, rows: torch.Tensor):
        self.generator, self.shape, self.rows = generator, tuple(shape), rows
        self._last = -1

    def __getitem__(self, i: int) -> torch.Tensor:
        if i <= self._last:
            raise IndexError(f"draw {i} read after draw {self._last}")
        self._last = i
        full = torch.randn(self.shape, generator=self.generator, device=self.rows.device)
        return full.index_select(0, self.rows)


class EnsembleRollout:
    """``write_fn(ic_start, member, lead_start, chunk)`` receives physical-
    space numpy chunks of shape (B, seg_steps, H, W, C), for this rank's
    members only."""

    def __init__(
        self,
        sampler: Callable,  # (X, generator, auxiliary=None, latents=None, noise=None) -> Y
        dataset,
        members: int,
        steps: int,
        interval: int = 6,
        segment: int = 10,
        base_seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        self.sampler = sampler
        self.device = resolve_device(str(device))
        self.std = Standardizer.from_dataset(dataset, self.device)
        self.members = members
        self.steps = steps
        self.interval = interval
        self.segment = min(segment, steps)
        self.base_seed = base_seed
        self.residual = bool(getattr(dataset, "residual", False))
        self.block = member_block(members, data_rank(), data_size())
        self.writes = layout().pipe_rank == 0  # a data row's first stage writes its members

    def generator(self, ic_start: int, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.base_seed * 7919 + ic_start) * 1_000_003 + step)
        return g

    def _to_host(self, traj: torch.Tensor):
        if self.device.type != "cuda":
            return traj, None
        host = torch.empty(traj.shape, dtype=traj.dtype, pin_memory=True)
        host.copy_(traj, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @torch.no_grad()
    def run(self, X0: np.ndarray, forcings: Optional[np.ndarray], ic_start: int,
            write_fn: Callable) -> None:
        """X0: (B, H, W, C) standardized; forcings: (B, steps, H, W, F) std."""
        B = X0.shape[0]
        M, delta = self.members, self.interval
        # the members this rank writes
        own = [int(m) for m in self.block if m < M] if self.writes else []
        Ml = len(self.block)
        # this rank's rows of the whole (M·B) batch's draws, pad members on
        # their member's rows
        rows = torch.as_tensor((self.block % M)[:, None] * B + np.arange(B)[None],
                               device=self.device).reshape(-1)
        x0 = torch.as_tensor(np.asarray(X0, np.float32), device=self.device)
        x0_phys = self.std.unstd_x(x0, delta).cpu().numpy()
        for m in own:
            write_fn(ic_start, m, 0, x0_phys[:, None])
        state = x0.repeat(Ml, 1, 1, 1)

        def flush(pending):
            host, event, lead_start, S = pending
            if event is not None:
                event.synchronize()
            traj = host.numpy().reshape(Ml, B, S, *host.shape[2:])
            for i, m in enumerate(own):
                write_fn(ic_start, m, lead_start, traj[i])

        done, pending = 0, None
        while done < self.steps:
            S = min(self.segment, self.steps - done)
            forc = None
            if forcings is not None:
                seg = np.asarray(forcings[:, done:done + S], np.float32)
                forc = torch.as_tensor(seg, device=self.device).repeat(Ml, 1, 1, 1, 1)
            traj = torch.empty((Ml * B, S, *state.shape[1:]), device=self.device)
            for s in range(S):
                cond = state if forc is None else torch.cat([state, forc[:, s]], dim=-1)
                gen = self.generator(ic_start, done + s)
                shape = (M * B, *state.shape[1:])
                latents = torch.randn(shape, generator=gen, device=self.device)
                Y = self.sampler(cond, gen, auxiliary=delta / 10.0,
                                 latents=latents.index_select(0, rows),
                                 noise=RowDraws(gen, shape, rows))
                if self.residual:
                    X_phys = self.std.unstd_x(state, delta) + self.std.unstd_t(Y, delta)
                    state = self.std.std_x(X_phys, delta)
                else:
                    X_phys = self.std.unstd_x(Y, delta)
                    state = Y
                traj[:, s] = X_phys
            prev, pending = pending, (*self._to_host(traj), done + 1, S)
            if prev is not None:
                flush(prev)
            done += S
        if pending is not None:
            flush(pending)
