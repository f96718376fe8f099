"""Ensemble forecast engine on one device.

Counterpart of ``swift_tpu/sampling/ensemble.py::EnsembleRollout``:

  * all (member × IC) rollouts run as one batch: members are tiled
    member-major into the leading axis (row m·B + b);
  * the horizon runs in segments of ``segment`` steps, each filling an
    on-device trajectory buffer with the residual update applied;
  * a finished segment is copied to pinned host memory and written to the
    store while the next segment computes.

Latents come from a ``torch.Generator`` seeded from (base_seed, ic_start,
step), so a forecast is reproducible; they are not jax.random's numbers.
The engine runs on CUDA unless it is handed ``device="cpu"``, and raises
where CUDA is absent.
Mesh sharding and batch padding are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from swift_torch.data.standardize import Standardizer
from swift_torch.utils.device import resolve_device


class EnsembleRollout:
    """``write_fn(ic_start, member, lead_start, chunk)`` receives physical-
    space numpy chunks of shape (B, seg_steps, H, W, C)."""

    def __init__(
        self,
        sampler: Callable,  # (X, generator, auxiliary=None) -> Y
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
        M, MB, delta = self.members, self.members * X0.shape[0], self.interval
        x0 = torch.as_tensor(np.asarray(X0, np.float32), device=self.device)
        x0_phys = self.std.unstd_x(x0, delta).cpu().numpy()
        for m in range(M):
            write_fn(ic_start, m, 0, x0_phys[:, None])
        state = x0.repeat(M, 1, 1, 1)

        def flush(pending):
            host, event, lead_start, S = pending
            if event is not None:
                event.synchronize()
            traj = host.numpy().reshape(M, B, S, *host.shape[2:])
            for m in range(M):
                write_fn(ic_start, m, lead_start, traj[m])

        done, pending = 0, None
        while done < self.steps:
            S = min(self.segment, self.steps - done)
            forc = None
            if forcings is not None:
                seg = np.asarray(forcings[:, done:done + S], np.float32)
                forc = torch.as_tensor(seg, device=self.device).repeat(M, 1, 1, 1, 1)
            traj = torch.empty((MB, S, *state.shape[1:]), device=self.device)
            for s in range(S):
                cond = state if forc is None else torch.cat([state, forc[:, s]], dim=-1)
                Y = self.sampler(cond, self.generator(ic_start, done + s),
                                 auxiliary=delta / 10.0)
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
