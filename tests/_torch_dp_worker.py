"""One rank of the port's data-parallel CPU tests (tests/test_torch_parallel.py).

``python tests/_torch_dp_worker.py <dir>``, launched as two processes with
``SWIFT_COORDINATOR``/``SWIFT_NUM_PROCESSES``/``SWIFT_PROCESS_ID`` (gloo),
reads ``<dir>/spec.json``, ``init.npz`` (the net's weights) and
``batch.npz`` (the global batch) that the test wrote, and for each case of
the spec takes one optimizer step through the port's ``Trainer`` on its
rows of the global batch; it writes ``<dir>/<case>.rank<r>.pt`` (its loss,
the loss averaged over the ranks, the gradient norm, the gradients after the
update's reduction, the parameters and EMA after the step). Then it checks
the collectives: bucketed ``all_reduce_mean`` and ``broadcast_from_rank0``
over fp32, bf16 and int64 tensors, and ``check_replica_consistency`` on
agreeing and on differing tensors (``<dir>/collectives.rank<r>.pt``).
Last it trains (``Trainer.train``, sCM + AdamW) until a stop signal that
reaches rank 1 alone, before its third step (``<dir>/stop.rank<r>.json``:
the steps taken, the ticks' step counts, the checkpoints under
``<dir>/stop``).

The test builds its one-process reference with the same functions
(:func:`build_trainer`, :func:`rows_of`), so this module imports only the
port and does nothing on import. It loads no JAX.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import signal
import sys

import numpy as np
import torch

from swift_torch import factory
from swift_torch.models.precond import PassPrecond
from swift_torch.models.swinv2 import SwinV2
from swift_torch.parallel import mesh
from swift_torch.training.loss import CRPSLoss, SCMLoss, TrigFlowLoss
from swift_torch.training.trainer import Trainer
from swift_torch.utils.stats import check_replica_consistency

OPTIMIZERS = {
    "adamw": {"_target_": "torch.optim.AdamW", "lr": 5e-4, "betas": [0.9, 0.95], "eps": 1e-6,
              "weight_decay": 0.1},
    "muon": {"_target_": "swift.training.optimizers.muon.MuonWithAuxAdam", "lr": 0.02,
             "weight_decay": 0.01, "adam_lr": 3e-4, "adam_betas": [0.9, 0.95],
             "adam_weight_decay": 0.01, "adam_eps": 1e-10},
}
TRAINER_CFG = {"lr_rampup_kimg": 0, "total_kimg": 10, "lr_min_factor": 0.01,
               "lr_cosine_anneal": True}
NIMG = 400.0  # the images seen before the step: the sCM tangent warmup's r = 0.4


def _affine(scale, shift):
    return lambda x, delta=6: x * scale + shift


def build_loss(name: str, spec: dict):
    res, variables, noise = spec["res"], spec["variables"], spec["noise"]
    if name == "scm":
        return SCMLoss(res[0], variables, dict(noise), sigma_data=1.0, tangent_warmup_kimg=1)
    if name == "trigflow":
        return TrigFlowLoss(res[0], variables, dict(noise), sigma_data=1.0)
    # unstd_t, unstd_x, std_x of a Standardizer, as affine maps
    std_fns = (_affine(0.5, 0.0), _affine(2.0, 1.0), _affine(0.5, -0.5))
    return CRPSLoss(res[0], variables, std_fns, sigma_data=1.0, ensemble_size=2,
                    n_variables=len(variables))


def build_trainer(case: dict, spec: dict, init: dict) -> Trainer:
    """The tiny SwinV2 + PassPrecond with the test's weights, the case's
    loss and optimizer, and a Trainer of the global batch, ``NIMG`` images
    in."""
    C, F = len(spec["variables"]), spec["forcings"]
    geometry = {k: tuple(v) if isinstance(v, list) else v for k, v in spec["model"].items()}
    model = SwinV2(img_resolution=tuple(spec["res"]), in_channels=2 * C + F, out_channels=C,
                   dtype=torch.float32, remat_layers=True, **geometry)
    net = PassPrecond(model, tuple(spec["res"]), C, condition_channels=C + F, auxiliary_dim=1)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    opt, lr_fn = factory.build_optimizer(OPTIMIZERS[case["opt"]], TRAINER_CFG,
                                         spec["global_batch"], net)
    trainer = Trainer(net, opt, build_loss(case["loss"], spec),
                      global_batch_size=spec["global_batch"], lr_fn=lr_fn,
                      ema_halflife_kimg=500, ema_rampup_ratio=0.05, run_dir=spec["dir"],
                      seed=spec["seed"], grad_accum=case.get("accum", 1))
    trainer.nimg = NIMG
    return trainer


def rows_of(batch: dict, rows) -> dict:
    return {k: v[rows] for k, v in batch.items()}


def step(trainer: Trainer, batch: dict, case: dict) -> dict:
    """One optimizer step; returns what the test compares."""
    loss = trainer.backward(batch, case.get("steps", 1))
    mean = loss.detach().clone()
    mesh.all_reduce_mean([mean])
    gnorm = trainer.update()
    return {
        "loss": float(loss), "mean_loss": float(mean), "grad_norm": float(gnorm),
        "grads": {n: p.grad.clone() for n, p in trainer.params.items()},
        "params": {n: p.detach().clone() for n, p in trainer.params.items()},
        "ema": {n: e.clone() for n, e in trainer.ema.items()},
    }


def collectives(rank: int) -> dict:
    """Bucketed all-reduce and broadcast over mixed dtypes, and the replica
    check on agreeing and differing tensors."""
    mesh.BUCKET_ELEMS = 7  # many buckets, a tensor larger than one alone
    g = torch.Generator().manual_seed(100 + rank)
    f32 = torch.randn(5, 3, generator=g)
    b16 = torch.randn(4, generator=g).to(torch.bfloat16)
    ints = torch.arange(6, dtype=torch.int64) * (rank + 1)
    out = {"inputs": [f32.clone(), b16.clone(), ints.clone()]}
    reduced = [f32.clone(), b16.clone()]
    mesh.all_reduce_mean(reduced)
    broadcast = [f32.clone(), b16.clone(), ints.clone()]
    mesh.broadcast_from_rank0(broadcast)
    out.update(reduced=reduced, broadcast=broadcast)
    out["agree"] = check_replica_consistency(broadcast, "broadcast")
    try:
        check_replica_consistency(out["inputs"], "inputs")
        out["differ"] = "no error"
    except AssertionError as e:
        out["differ"] = str(e)
    return out


def stop_run(spec: dict, init: dict, batch: dict, rank: int) -> dict:
    """Train on this rank's rows, a tick of a thousand images (the first
    tick ends at step 1) and no periodic checkpoint, until rank 1 sends
    itself SIGTERM as it fetches its third batch; rank 0 gets no signal."""
    trainer = build_trainer(spec["cases"]["scm-adamw"], spec, init)
    trainer.run_dir = os.path.join(spec["dir"], "stop")
    trainer.total_kimg, trainer.kimg_per_tick = 1.0, 1.0
    trainer.checkpoint_ticks = trainer.val_ticks = None
    local = rows_of(batch, mesh.rank_rows(spec["global_batch"] // 2))

    def batches():
        for i in itertools.count():
            if i == 2 and rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield local

    trainer.train(batches())
    return {"updates": trainer.updates, "iters": trainer.history["train/iter"],
            "checkpoints": sorted(os.path.basename(p) for p in glob.glob(
                os.path.join(trainer.run_dir, "checkpoints", "*.npz")))}


def main(workdir: str) -> None:
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    init = dict(np.load(os.path.join(workdir, "init.npz")))
    batches = {name: dict(np.load(os.path.join(workdir, f"batch-{name}.npz")))
               for name in ("single", "multistep")}
    assert mesh.maybe_initialize_distributed("cpu") and mesh.world_size() == 2
    r = mesh.rank()
    torch.manual_seed(0)
    for name, case in spec["cases"].items():
        batch = batches["multistep" if case["loss"] == "crps" else "single"]
        local = rows_of(batch, mesh.rank_rows(spec["global_batch"] // 2))
        out = step(build_trainer(case, spec, init), local, case)
        torch.save(out, os.path.join(workdir, f"{name}.rank{r}.pt"))
    torch.save(collectives(r), os.path.join(workdir, f"collectives.rank{r}.pt"))
    stop = stop_run(spec, init, batches["single"], r)
    with open(os.path.join(workdir, f"stop.rank{r}.json"), "w") as f:
        json.dump(stop, f)
    mesh.barrier()
    print(f"DP_WORKER_OK rank={r}")


if __name__ == "__main__":
    main(sys.argv[1])
