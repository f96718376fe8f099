"""Sampler hyper-parameter sweep CLI of the port.

Counterpart of ``swift_tpu/eval/sampler.py``: a grid over ``num_steps ×
sigma_min × sigma_max``, the one-step lat-weighted RMSE of each variable
against the residual target, written to ``sampler_results.csv`` with the
JAX package's columns.

``python -m swift_torch.eval.sampler --input <run_dir> [--num-steps 32 16
...] [--solver scm] [--device cuda|cpu]``

Each configuration evaluates the batches on the network's device under
``torch.inference_mode``; batch b of configuration i draws its latents
from a generator seeded from (seed + i, b).
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

parser = argparse.ArgumentParser()
parser.add_argument("--input", type=str, required=True, help="Run directory")
parser.add_argument("--checkpoint", type=str, default=None,
                    help="Checkpoint name or path: .npz or a reference .pt (default: the latest)")
parser.add_argument("--samples", type=int, default=-1)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--batch", type=int, default=60, help="Global batch size")
parser.add_argument("--num-steps", type=int, nargs="+", default=[32, 16, 8, 4, 2, 1])
parser.add_argument("--sigma-min", type=float, nargs="+", default=[0.02])
parser.add_argument("--sigma-max", type=float, nargs="+", default=[200.0])
parser.add_argument("--solver", type=str, default="scm")
parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="Device of the network (the CPU only when asked for)")


@torch.inference_mode()
def sweep(net, dataset, batches, odir: str, args) -> list[dict]:
    """Runs the grid with ``net`` (a precond on its device) over
    ``batches()`` of (X, T) (standardized condition and residual target);
    returns the rows written to ``odir/sampler_results.csv``."""
    from swift_torch.data.standardize import Standardizer
    from swift_torch.sampling.factory import sampler_factory
    from swift_torch.training.validate import lat_weights
    from swift_torch.utils.log import log0

    device = next(net.parameters()).device
    std = Standardizer.from_dataset(dataset, device)
    grid = list(itertools.product(args.num_steps, args.sigma_min, args.sigma_max))
    log0(f"Running {len(grid)} parameter combinations")
    w_lat = torch.from_numpy(lat_weights(dataset)).to(device)
    nv = std.n_variables

    results = []
    for i, (num_steps, sigma_min, sigma_max) in enumerate(grid):
        log0(f"Testing: num_steps={num_steps}, sigma_min={sigma_min}, sigma_max={sigma_max}")
        solver_kwargs = {"num_steps": num_steps, "sigma_min": sigma_min, "sigma_max": sigma_max}
        sampler = sampler_factory(args.solver, net, **solver_kwargs)
        sse = np.zeros(len(dataset.variables), np.float64)
        total, hw = 0, None
        for b, (X, T) in enumerate(batches()):
            gen = torch.Generator(device=device).manual_seed((args.seed + i) * 1_000_003 + b)
            X = torch.as_tensor(np.asarray(X, np.float32), device=device)
            T = torch.as_tensor(np.asarray(T, np.float32), device=device)
            Y = sampler(X, gen)
            Xp = std.unstd_x(X[..., :nv])
            Yp, Tp = Xp + std.unstd_t(Y), Xp + std.unstd_t(T)
            sse += torch.sum(w_lat * (Yp - Tp) ** 2, dim=(0, 1, 2)).double().cpu().numpy()
            total += X.shape[0]
            hw = X.shape[1] * X.shape[2]
        errors = np.sqrt(sse / (total * hw))
        overall = float(errors.mean())
        for v, d in zip(dataset.variables, errors):
            log0(f"{v}: {d:.6f}")
            solver_kwargs[f"{v}_error"] = float(d)
        log0(f"Overall error: {overall}")
        solver_kwargs["overall_error"] = overall
        results.append(solver_kwargs)

    if results:
        path = os.path.join(odir, "sampler_results.csv")
        keys = list(results[0].keys())
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in results:
                f.write(",".join(str(row[k]) for k in keys) + "\n")
        log0(f"Results saved to: {path}")
    return results


def main(argv=None, dataset=None) -> list[dict]:
    """The sweep of a run directory's EMA weights over its test split;
    ``dataset``, when given, stands in for that split (an in-memory
    ``SyntheticERA5`` where h5py is absent)."""
    from swift_torch import config as cfglib
    from swift_torch import factory
    from swift_torch.generate import load_weights
    from swift_torch.utils.checkpoint import latest_checkpoint
    from swift_torch.utils.device import resolve_device

    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfglib.resolve_interpolations(
        cfglib.load_config(os.path.join(args.input, ".hydra", "config.yaml")))
    if dataset is None:
        dataset = factory.build_dataset(cfg["data"], split="test")
    net = factory.build_precond(cfg["precond"], cfg["model"], dataset.img_resolution,
                                dataset.n_target_channels, dataset.n_condition_channels,
                                sigma_max_override=float("inf"))
    if args.checkpoint:
        ckpt = (args.checkpoint if os.path.exists(args.checkpoint)
                else os.path.join(args.input, "checkpoints", args.checkpoint))
    else:
        ckpt = latest_checkpoint(os.path.join(args.input, "checkpoints"))
    assert ckpt, "no checkpoint found"
    net.load_state_dict(load_weights(ckpt), strict=True)
    net = net.to(device).eval()

    n = len(dataset) if args.samples == -1 else args.samples

    def batches():
        for b0 in range(0, n, args.batch):
            xs, ts = [], []
            for idx in range(b0, min(b0 + args.batch, n)):
                (x, t), _ = dataset[(idx, 1, 6)]
                xs.append(x)
                ts.append(t)
            yield np.stack(xs), np.stack(ts)

    odir = os.path.join(args.input, "output")
    os.makedirs(odir, exist_ok=True)
    return sweep(net, dataset, batches, odir, args)


if __name__ == "__main__":
    main()
