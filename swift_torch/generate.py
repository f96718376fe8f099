"""Ensemble forecast CLI of the port: ``python -m swift_torch.generate
--input <run_dir> --members 12 --steps 60 ...``.

Same flags and the same WB2-layout zarr (or numpy) store as
``swift_tpu.generate``. ``main`` reads the run's saved config and data and
the checkpoint's EMA weights: a JAX-layout npz, or a reference ``.pt``
(its ``"ema"`` state dict, ``model.``-prefixed names, loaded strictly), as
``swift_tpu.generate`` takes both; :func:`rollout_to_store`
takes an already built dataset and network and needs neither yaml nor h5py.
The network runs on the GPU (``--device cuda``, the default) and raises
where CUDA is absent; the CPU is used only when asked for (``--device
cpu``). ``--int8`` builds the network with ``quant="int8"`` (the int8 qkv
product and kernels 18 and 19). ``--solver`` takes the JAX package's
choices (``scm``, ``edm``, ``dpm``, ``2s``), each with the same kwargs
(``num_steps``, σ from 0.02 to 200, the interval's auxiliary). Launched as
several processes (``torchrun --nproc_per_node N -m swift_torch.generate
...`` or the ``SWIFT_*`` env, ``swift_torch.parallel``) each rank rolls out
a block of whole members: rank 0 creates the store before a barrier, every
rank writes its members (lead 0 included) and rank 0 consolidates the
metadata after another; the store is the one-process store. A run
trained with tensor parallelism (``system=tpu-tp``) forecasts the same
way, data-parallel over every rank with its ``model`` axis ignored, as the
JAX package's ``generate.py:223-233`` runs it: its checkpoint is in one
process's layout.

``--pp S`` (or a run whose saved config has a ``pipe`` axis in
``system.mesh``, -1 meaning the ranks that remain, with
``system.pipeline.n_micro``; ``--pp 1`` turns it off) forecasts
pipeline-parallel, as ``swift_tpu/generate.py:202-233`` does: the ranks
form data × pipe (``make_mesh(("data", "pipe"), (-1, S))``'s order), the S
consecutive ranks of a data row each hold one stage of the network (its
pairs, ``parallel.pipeline``) and roll out that row's members together,
``--pp-micro`` microbatches at a time; the first stage writes. Each stage
is a process with its card, so S must divide the world. It composes with
``--int8``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from swift_torch import factory
from swift_torch.data.constants import compress_variables
from swift_torch.data.samplers import AttributeSubset
from swift_torch.parallel.mesh import (
    barrier,
    build_kernels_first,
    check_mesh,
    init_layout,
    maybe_initialize_distributed,
    world_size,
)
from swift_torch.parallel.pipeline import pipelined_precond, stage_state_dict
from swift_torch.sampling.ensemble import EnsembleRollout
from swift_torch.sampling.factory import sampler_factory
from swift_torch.utils import zarr_lite
from swift_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from swift_torch.utils.device import resolve_device
from swift_torch.utils.io import create_empty_numpy, create_forecast_zarr
from swift_torch.utils.log import is_main_process, log0

parser = argparse.ArgumentParser()
parser.add_argument("--input", type=str, required=True, help="Input (run) directory")
parser.add_argument("--checkpoint", type=str, default=None,
                    help="Checkpoint name or path: .npz (JAX layout) or a reference .pt "
                    "(default: the latest npz)")
parser.add_argument("--members", type=int, default=1, help="Number of ensemble members")
parser.add_argument("--steps", type=int, default=8, help="Number of prediction steps")
parser.add_argument("--batch", type=int, default=32, help="IC batch size")
parser.add_argument("--samples", type=int, default=-1, help="Number of samples to use")
parser.add_argument("--interval", type=int, default=6, choices=[6, 12, 24],
                    help="Interval in hours")
parser.add_argument("--dump", type=str, default="zarr", choices=["zarr", "numpy"],
                    help="Output format")
parser.add_argument("--segment", type=int, default=10,
                    help="Rollout steps per segment (device buffer bound)")
parser.add_argument("--solver", type=str, default="scm", choices=["scm", "edm", "dpm", "2s"])
parser.add_argument("--num-solver-steps", type=int, default=1)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--int8", action="store_true",
                    help="Dynamically-quantized int8 qkv/FFN/wo matmuls for the "
                    "forecast. Accuracy-affecting: opt-in until a real-data "
                    "RMSE/CRPS A/B blesses it.")
parser.add_argument("--pp", type=int, default=0,
                    help="Pipeline-parallel stages for the solver net (0: the run's "
                    "system.mesh pipe axis, if it has one; 1: off). Ranks split as "
                    "(data=-1, pipe=PP), one card a stage; use when the model's layer stack "
                    "outgrows one card's memory, otherwise data parallelism over members is "
                    "faster.")
parser.add_argument("--pp-micro", type=int, default=None,
                    help="Microbatches per pipeline round-trip (default: the run's "
                    "system.pipeline.n_micro, else PP); more microbatches shrink the "
                    "(PP-1)/(M+PP-1) bubble; a data row's members*batch must divide by it")
parser.add_argument("--output", type=str, default=None,
                    help="Output directory (default: <input>/output/<checkpoint>/)")
parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="Device of the network (the CPU only when asked for)")


def build_store(args, dataset, indices, odir, filename):
    """(ofile, write_fn(ic_start, member, lead_start, chunk), finalize):
    rank 0 creates the store and every rank opens it after a barrier;
    ``finalize`` flushes, then rank 0 consolidates the metadata after
    another."""
    if args.dump == "numpy":
        ofile = os.path.join(odir, f"{filename}.npy")
        if is_main_process():
            create_empty_numpy(ofile, dataset, args.members, args.steps)
        barrier()
        store = np.lib.format.open_memmap(ofile, mode="r+")

        def write_fn(ic_start, m, lead_start, chunk):
            # chunk (B, S, H, W, C) -> store (n, M, steps+1, C, H, W)
            b, s = chunk.shape[0], chunk.shape[1]
            store[ic_start:ic_start + b, m, lead_start:lead_start + s] = (
                chunk.transpose(0, 1, 4, 2, 3))

        def finalize():
            store.flush()
            barrier()

        return ofile, write_fn, finalize

    ofile = os.path.join(odir, f"{filename}.zarr")
    if is_main_process():
        create_forecast_zarr(ofile, dataset, args.members, args.steps, interval=args.interval,
                             batch=args.batch, indices=indices)
    barrier()
    group = zarr_lite.open_group(ofile)
    var_slices = {}
    counter = 0
    for var, levels in compress_variables(dataset.variables).items():
        n = max(len(levels), 1)
        var_slices[var] = (counter, counter + n, bool(levels))
        counter += n

    def write_fn(ic_start, m, lead_start, chunk):
        b, s = chunk.shape[0], chunk.shape[1]
        for var, (lo, hi, has_levels) in var_slices.items():
            sel = (slice(ic_start, ic_start + b), m, slice(lead_start, lead_start + s))
            if has_levels:  # (B, S, H, W, L) -> (B, S, L, H, W)
                group[var][sel] = chunk[..., lo:hi].transpose(0, 1, 4, 2, 3)
            else:
                group[var][sel] = chunk[..., lo]

    def finalize():
        barrier()
        if is_main_process():
            group.consolidate_metadata()
        barrier()

    return ofile, write_fn, finalize


def read_store(ofile: str) -> dict[str, np.ndarray]:
    """The forecast fields of a zarr store that :func:`build_store` made, by
    variable: (ic, member, lead, [level], H, W); coordinates are left out."""
    group = zarr_lite.open_group(ofile, mode="r")
    return {name: np.asarray(group[name]) for name in group.array_names()
            if len(group[name].shape) >= 5}


def select_indices(n: int, samples: int, steps: int, interval: int) -> list[int]:
    """Evenly spaced initial conditions (all of them for samples == -1)."""
    if samples == -1:
        return list(range(n))
    return np.linspace(0, n - 1 - (steps * interval // 6), num=samples, dtype=int).tolist()


def rollout_to_store(args, dataset, net, odir: str, timings: dict | None = None):
    """Roll the ensemble out over the dataset's test ICs into a store.

    ``dataset`` has the ``ERA5Dataset`` interface; ``net`` is a built
    precond with weights, on its device. Returns (store path, rollout
    seconds, forecast steps of all ranks); ``timings``, when given,
    receives the host seconds of the rollout spent staging inputs
    ("staging") and writing the store ("store"), this rank's."""
    device = next(net.parameters()).device
    indices = select_indices(len(dataset), args.samples, args.steps, args.interval)
    subset = AttributeSubset(dataset, indices)
    filename = f"output-{len(subset)}i-{args.steps}s-{args.members}m-{args.interval}h"
    log0(f"{len(subset)} initials for {args.steps} steps over {args.members} members")
    ofile, write_fn, finalize = build_store(args, subset, indices, odir, filename)

    sampler = sampler_factory(args.solver, net, num_steps=args.num_solver_steps,
                              sigma_min=0.02, sigma_max=200.0, auxiliary=args.interval / 10.0)
    engine = EnsembleRollout(sampler, dataset, args.members, args.steps,
                             interval=args.interval, segment=args.segment,
                             base_seed=args.seed, device=device)

    def state(i):
        return dataset.standardize_x(dataset._load_file(dataset.files[i], dataset.variables),
                                     args.interval)

    def forcing(i, s):
        j = min(int(i) + int(s * args.interval // 6), len(dataset.files) - 1)
        return dataset.standardize_x(dataset.get_forcings(j), args.interval)

    # host seconds spent staging inputs and writing the store, of the wall
    host = timings if timings is not None else {}
    host.update(staging=0.0, store=0.0)

    def timed_write(*chunk_args):
        t0 = time.perf_counter()
        write_fn(*chunk_args)
        host["store"] += time.perf_counter() - t0

    log0("Rolling out samples...")
    start = time.perf_counter()
    for b0 in range(0, len(subset), args.batch):
        t0 = time.perf_counter()
        batch_idx = indices[b0:b0 + args.batch]
        X0 = np.stack([state(i) for i in batch_idx]).astype(np.float32)
        forcings = None
        if dataset.forcings:
            forcings = np.stack([
                np.stack([forcing(i, s) for s in range(args.steps)]) for i in batch_idx
            ]).astype(np.float32)
        host["staging"] += time.perf_counter() - t0
        engine.run(X0, forcings, b0, timed_write)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    barrier()
    wall = time.perf_counter() - start
    finalize()
    n_steps = len(subset) * args.members * args.steps
    world = world_size()
    log0(f"Done! Took {wall:.3f} seconds ({n_steps} forecast steps, "
         f"{n_steps / wall / world:.2f} steps/sec a card over {world} rank(s) on {device}; "
         f"input staging {host['staging']:.3f} s, store writes {host['store']:.3f} s on "
         "rank 0).")
    log0(f"Output saved to: {ofile}")
    return ofile, wall, n_steps


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """The EMA weights of a checkpoint as a ``model.``-prefixed state dict:
    a JAX-layout npz through :func:`load_checkpoint`, or a reference torch
    ``.pt`` (its ``"ema"`` entry when it has one, else the whole file)."""
    if path.endswith(".pt"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        return state["ema"] if "ema" in state else state
    return load_checkpoint(path)


def pipe_request(args, cfg: dict, world: int) -> tuple[int, int | None]:
    """(stages, microbatches) of the forecast: ``--pp``, else the run's
    ``system.mesh`` pipe axis (its size, -1 the ranks that remain, 2 when
    the mesh gives no sizes) and ``system.pipeline.n_micro``; 1 is no
    pipeline. Raises unless the stages divide the ``world``."""
    pp, n_micro = args.pp, args.pp_micro
    if not pp:
        system = cfg.get("system") or {}
        sys_mesh = system.get("mesh") or {}
        axes = list(sys_mesh.get("axes") or [])
        if "pipe" in axes:
            sizes = [int(v) for v in sys_mesh.get("sizes") or []]
            if sizes and len(sizes) != len(axes):
                raise ValueError(f"system.mesh sizes {sizes} does not match axes {axes}")
            pp = sizes[axes.index("pipe")] if sizes else 2
            if pp == -1:
                pp = world // int(np.prod([v for v in sizes if v != -1]))
            if n_micro is None:
                n_micro = (system.get("pipeline") or {}).get("n_micro")
    pp = max(int(pp), 1)
    if world % pp:
        raise ValueError(f"{pp} pipeline stages need a multiple of {pp} ranks (one process and "
                         f"card a stage); launched with {world}")
    return pp, n_micro


def main(args, dataset=None):
    """Forecast from a run directory. ``dataset``, when given, stands in for
    the test split the run's data config names (an in-memory
    ``SyntheticERA5`` where h5py is absent); the store's layout follows
    it."""
    from swift_torch import config as cfglib  # needs yaml

    maybe_initialize_distributed(args.device)
    device = resolve_device(args.device)
    cfg = cfglib.resolve_interpolations(
        cfglib.load_config(os.path.join(args.input, ".hydra", "config.yaml")))
    check_mesh(cfg)
    pp, n_micro = pipe_request(args, cfg, world_size())
    # one replica a rank, or a replica's stages: a run's model axis is not a forecast's
    lay = init_layout(pipe=pp)
    build_kernels_first(device)
    if dataset is None:
        log0("Loading dataset...")
        dataset = factory.build_dataset(cfg["data"], split="test")

    log0("Constructing network...")
    if args.int8:
        cfg.setdefault("model", {})["quant"] = "int8"
    stage = (pp, lay.pipe_rank) if pp > 1 else None
    net = factory.build_precond(
        cfg["precond"], cfg["model"], dataset.img_resolution, dataset.n_target_channels,
        dataset.n_condition_channels, sigma_max_override=float("inf"), pipe_stage=stage,
    )
    if args.checkpoint is not None:
        name = args.checkpoint
        if not name.endswith((".npz", ".pt")):
            name += ".npz"
        ckpt = name if os.path.exists(name) else os.path.join(args.input, "checkpoints", name)
        if not os.path.exists(ckpt):
            raise ValueError(f"Specified checkpoint {ckpt} does not exist")
        ckpt_basename = os.path.splitext(os.path.basename(ckpt))[0]
    else:
        ckpt = latest_checkpoint(os.path.join(args.input, "checkpoints"))
        if not ckpt:
            raise ValueError(f"No checkpoints in {os.path.join(args.input, 'checkpoints')}")
        ckpt_basename = "latest"
    log0(f"Loading checkpoint: {ckpt}")
    weights = load_weights(ckpt)
    if stage is not None:
        weights = stage_state_dict(weights, net.model.depth, *stage)
    net.load_state_dict(weights, strict=True)
    net = net.to(device).eval()
    if stage is not None:
        net = pipelined_precond(net, lay, n_micro=n_micro)
        log0(f"Pipeline parallel: {pp} stages a replica ({lay.data} replicas), "
             f"{net.model.depth // (2 * pp)} block pairs a stage, "
             f"{n_micro or pp} microbatches")

    odir = args.output or os.path.join(args.input, "output", ckpt_basename)
    os.makedirs(odir, exist_ok=True)
    ofile, _, _ = rollout_to_store(args, dataset, net, odir)
    return ofile


def cli(argv=None):
    return main(parser.parse_args(argv))


if __name__ == "__main__":
    cli()
