"""Online and offline rollout validation: lat-weighted RMSE and fair-kernel
CRPS over a forecast.

Counterpart of ``swift_tpu/training/validate.py``: a 6-hourly
autoregressive rollout to ``target_interval`` steps, recording the aggregate
RMSE and each channel's lat-weighted RMSE at the 6 h lead and at each day's
end, averaged over batches; ``CRPS_rollout`` scores an ensemble the same
way. A batch's forcings are staged on the device at once, and the rollout
and its metrics run there under ``torch.inference_mode`` (the JAX package's
two ``lax.scan`` bodies become Python loops); the host reads two small
arrays a batch. Under data parallelism each rank scores its own items (the
offline ``main`` takes every world-th item from the rank's) and the scores
are means over every rank's batches.

``python -m swift_torch.training.validate --input <run_dir> [--batch N]
[--samples N] [--target_interval 56] [--solver dpm] [--checkpoint FILE]
[--device cuda|cpu]``
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from swift_torch.data.standardize import Standardizer
from swift_torch.parallel.mesh import data_group, data_rank, data_size
from swift_torch.utils.device import resolve_device
from swift_torch.utils.stats import sum_over_ranks

NUM_INTERVAL_PER_DAY = 4


def _recorded(step: int) -> Optional[int]:
    """The day slot a step's forecast is scored in (the 6 h lead is day 0),
    or None for a step that is not recorded."""
    if (step + 1) % NUM_INTERVAL_PER_DAY == 0 or step == 0:
        return (step + 1) // NUM_INTERVAL_PER_DAY
    return None


def _forecast(sampler, std, X, forcing, generator, residual, auxiliary):
    """(the physical-space forecast, the next standardized state)."""
    cond = X if forcing is None else torch.cat([X, forcing], dim=-1)
    Y = sampler(cond, generator, auxiliary=auxiliary)
    Y_un = std.unstd_t(Y)
    if residual:
        Y_un = std.unstd_x(cond)[..., : std.n_variables] + Y_un
    return Y_un, (std.std_x(Y_un) if residual else Y)


@torch.inference_mode()
def _rollout_rmse(sampler: Callable, std: Standardizer, X0: torch.Tensor,
                  forcings_seq: Optional[torch.Tensor], targets: torch.Tensor,
                  w_lat: torch.Tensor, generator, target_interval: int, residual: bool,
                  auxiliary=None):
    """(aggregate RMSE, (C, days + 1) lat-weighted RMSE) of one batch. X0 (B,
    H, W, C) standardized, forcings (B, steps, H, W, F) standardized, targets
    (B, days + 1, H, W, C) physical, all on the device."""
    n_days = target_interval // NUM_INTERVAL_PER_DAY + 1
    agg = torch.zeros((), device=X0.device)
    arr = torch.zeros((X0.shape[-1], n_days), device=X0.device)
    X = X0
    for s in range(target_interval):
        forcing = None if forcings_seq is None else forcings_seq[:, s]
        Y_un, X = _forecast(sampler, std, X, forcing, generator, residual, auxiliary)
        day = _recorded(s)
        if day is not None:
            err2 = (Y_un - targets[:, day]) ** 2
            agg += torch.sqrt(torch.mean(err2))
            arr[:, day] += torch.sqrt(torch.mean(w_lat * err2, dim=(0, 1, 2)))
    return agg, arr


@torch.inference_mode()
def _rollout_crps(sampler: Callable, std: Standardizer, X0m: torch.Tensor,
                  forcings_seq: Optional[torch.Tensor], targets: torch.Tensor,
                  w_lat: torch.Tensor, generator, target_interval: int, residual: bool,
                  members: int, auxiliary=None):
    """Ensemble rollout scored by the fair kernel CRPS a channel at each
    recorded step (``eval/metrics.py``'s ``lat_weighted_crps``). X0m is (M·B,
    H, W, C), members tiled member-major; members share the initial
    condition and differ in their latents."""
    M = members
    B = X0m.shape[0] // M
    n_days = target_interval // NUM_INTERVAL_PER_DAY + 1
    agg = torch.zeros((), device=X0m.device)
    arr = torch.zeros((X0m.shape[-1], n_days), device=X0m.device)
    w_vec = w_lat.reshape(1, 1, -1, 1, 1)  # over (M, B, H, W, C)
    X = X0m
    for s in range(target_interval):
        forcing = None if forcings_seq is None else forcings_seq[:, s].repeat(M, 1, 1, 1)
        Y_un, X = _forecast(sampler, std, X, forcing, generator, residual, auxiliary)
        day = _recorded(s)
        if day is None:
            continue
        pred = Y_un.reshape(M, B, *Y_un.shape[1:])
        err_c = ((pred - targets[:, day][None]).abs() * w_vec).mean(dim=(0, 1, 2, 3))
        spread = (pred[:, None] - pred[None, :]).abs() * w_vec[None]
        # mean over (H, W), summed over member pairs, / 2M(M-1), then over B
        spread_c = spread.mean(dim=(3, 4)).sum(dim=(0, 1)) / (2 * M * (M - 1))
        crps_c = err_c - spread_c.mean(dim=0)
        agg += crps_c.mean()
        arr[:, day] += crps_c
    return agg, arr


def lat_weights(dataset) -> np.ndarray:
    """cos(lat), mean-normalised, (1, H, 1, 1) fp32: the rollout scores' weights
    (not clipped, unlike the losses')."""
    lat, _ = dataset.get_lat_lon()
    w = np.cos(np.deg2rad(lat))
    return (w / w.mean()).reshape(1, -1, 1, 1).astype(np.float32)


def _staged_forcings(dataset, idx, target_interval: int) -> Optional[np.ndarray]:
    """(B, steps, H, W, F) standardized forcings of a batch's steps."""
    if not dataset.forcings:
        return None
    return np.stack([
        np.stack([np.asarray(dataset.standardize_x(dataset.get_forcings(int(j) + i)))
                  for i in range(target_interval)], 0)
        for j in np.atleast_1d(idx)
    ], 0).astype(np.float32)


def _score(rollout, batches, dataset, target_interval: int, device, num_batches, tile: int):
    """Averages ``rollout(X0, forcings, targets, w_lat)`` over the batches of
    (X, TS, idx), every rank's (a rank may have none); X is repeated
    ``tile`` times member-major."""
    dev = resolve_device(str(device))
    w_lat = torch.from_numpy(lat_weights(dataset)).to(dev)
    agg_total, count = 0.0, 0
    arr_total = np.zeros((len(dataset.variables), target_interval // NUM_INTERVAL_PER_DAY + 1),
                         np.float32)
    for X, TS, idx in batches:
        forc = _staged_forcings(dataset, idx, target_interval)
        X0 = torch.as_tensor(np.asarray(X, np.float32), device=dev).repeat(tile, 1, 1, 1)
        agg, arr = rollout(X0, None if forc is None else torch.from_numpy(forc).to(dev),
                           torch.as_tensor(np.asarray(TS, np.float32), device=dev), w_lat)
        agg_total += float(agg)
        arr_total = arr_total + arr.cpu().numpy()
        count += 1
        if num_batches is not None and count >= num_batches:
            break
    if data_size() > 1:  # the sums and counts of every data rank (model ranks score alike)
        packed = sum_over_ranks(np.concatenate([[agg_total, count], arr_total.reshape(-1)]),
                                data_group())
        agg_total, count = float(packed[0]), int(packed[1])
        arr_total = packed[2:].reshape(arr_total.shape).astype(np.float32)
    return agg_total / count, arr_total / count


def RMSE_rollout(sampler: Callable, batches, dataset, target_interval: int,
                 generator: Optional[torch.Generator] = None, num_batches: Optional[int] = None,
                 auxiliary=None, device="cuda"):
    """(aggregate RMSE, (C, days + 1) per-channel RMSE) averaged over
    ``batches`` of (X, TS, idx): X (B, H, W, C) standardized, TS (B, days
    + 1, H, W, C) physical (``ERA5RollOutDataset``'s items).
    ``sampler(cond, generator, auxiliary=None)`` comes from
    ``sampling.factory.sampler_factory`` over a network on ``device``."""
    std = Standardizer.from_dataset(dataset, resolve_device(str(device)))
    residual = bool(getattr(dataset, "residual", False))

    def rollout(X0, forc, targets, w_lat):
        return _rollout_rmse(sampler, std, X0, forc, targets, w_lat, generator,
                             target_interval, residual, auxiliary)

    return _score(rollout, batches, dataset, target_interval, device, num_batches, 1)


def CRPS_rollout(sampler: Callable, batches, dataset, target_interval: int,
                 generator: Optional[torch.Generator] = None, members: int = 4,
                 num_batches: Optional[int] = None, auxiliary=None, device="cuda"):
    """The fair-kernel CRPS analogue of :func:`RMSE_rollout`, ``members``
    latent draws an initial condition."""
    assert members >= 2, "kernel CRPS needs at least 2 members"
    std = Standardizer.from_dataset(dataset, resolve_device(str(device)))
    residual = bool(getattr(dataset, "residual", False))

    def rollout(X0m, forc, targets, w_lat):
        return _rollout_crps(sampler, std, X0m, forc, targets, w_lat, generator,
                             target_interval, residual, members, auxiliary)

    return _score(rollout, batches, dataset, target_interval, device, num_batches, members)


def main(argv=None, dataset=None):
    """Offline checkpoint evaluation: the RMSE of a test-split rollout from a
    run's EMA weights (the latest npz checkpoint, or ``--checkpoint``: an
    npz or a reference ``.pt``). ``dataset``, when given, stands in for the
    run's test split (an in-memory rollout dataset where h5py is absent)."""
    import argparse
    import os
    import random

    from swift_torch import config as cfglib
    from swift_torch import factory
    from swift_torch.data.samplers import AttributeSubset
    from swift_torch.generate import load_weights
    from swift_torch.sampling.factory import sampler_factory
    from swift_torch.parallel.mesh import init_layout, maybe_initialize_distributed
    from swift_torch.utils.checkpoint import latest_checkpoint
    from swift_torch.utils.log import log0

    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="Input run directory")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--samples", type=int, default=-1)
    p.add_argument("--target_interval", type=int, default=56,
                   help="number of 6-hour intervals to predict ahead")
    p.add_argument("--solver", type=str, default="dpm")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Checkpoint path: .npz or a reference .pt (default: the latest npz)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    maybe_initialize_distributed(args.device)
    init_layout(1)  # one replica a rank, whatever the run's mesh
    device = resolve_device(args.device)
    cfg = cfglib.resolve_interpolations(
        cfglib.load_config(os.path.join(args.input, ".hydra", "config.yaml")))
    if dataset is None:
        dataset = factory.build_rollout_dataset(cfg["data"], args.target_interval, split="test")
    n = len(dataset) if args.samples == -1 else args.samples
    strt = random.Random(args.seed).randint(0, max(len(dataset) - n, 0))
    # this rank's items: every world-th of the window
    subset = AttributeSubset(dataset, list(range(strt + data_rank(), strt + n, data_size())))

    net = factory.build_precond(cfg["precond"], cfg["model"], dataset.img_resolution,
                                dataset.n_target_channels, dataset.n_condition_channels,
                                sigma_max_override=float("inf"))
    ckpt = args.checkpoint or latest_checkpoint(os.path.join(args.input, "checkpoints"))
    assert ckpt, "no checkpoints found"
    net.load_state_dict(load_weights(ckpt), strict=True)
    net = net.to(device).eval()
    sampler = sampler_factory(args.solver, net, **(cfg.get("solver") or {}))

    def batches():
        for b0 in range(0, len(subset), args.batch):
            chunk = [subset[i] for i in range(b0, min(b0 + args.batch, len(subset)))]
            yield (np.stack([c[0] for c in chunk]), np.stack([c[1] for c in chunk]),
                   np.asarray([c[2] for c in chunk]))

    gen = torch.Generator(device=device).manual_seed(args.seed * data_size() + data_rank())
    agg, arr = RMSE_rollout(sampler, batches(), dataset, args.target_interval, gen,
                            device=device)
    log0(f"aggregate rmse: {agg}")
    for v, row in zip(dataset.variables, arr):
        log0(f"rmse[{v}]: {[round(float(x), 4) for x in row]}")
    return agg, arr


if __name__ == "__main__":
    main()
