"""One rank of the port's tensor-parallel CPU tests (tests/test_torch_tp.py).

``python tests/_torch_tp_worker.py <dir>``, launched as 2 or 4 processes
with ``SWIFT_COORDINATOR``/``SWIFT_NUM_PROCESSES``/``SWIFT_PROCESS_ID``
(gloo), reads ``<dir>/spec.json`` (the geometries, the layout's model size,
the step's hyper-parameters), ``init-<geometry>.npz`` (one process's
weights) and ``batch.npz`` (the inputs, tangents, the training batch and
the sCM draws) that the test wrote, lays the ranks out data × model
(``parallel.mesh.init_layout``) and writes ``<dir>/<what>.rank<r>.pt``:

* ``forward``: for each geometry, the tensor-parallel net's output and its
  tangent under ``forward_ad`` (``jvp=True``);
* ``step``: one sCM step with AdamW through the port's ``Trainer`` on this
  data rank's rows, the draws handed over (the loss over the ranks, the
  gradient norm, the gradients, parameters and EMA gathered into one
  process's layout, this rank's own gradients of the replicated
  parameters, the per-head logit scales' gradients);
* ``muon``: two Muon steps with the Newton-Schulz work split over every
  rank, on this rank's slices and on whole matrices, each against one
  unsplit optimizer on whole matrices in this process (bit for bit), in
  fp32 and bf16 momentum;
* ``mars``: two MARS steps of each kind on this rank's slices against one
  optimizer on the whole network in this process (bit for bit).

The test builds its one-process references with :func:`build_net` and
:func:`build_trainer`; this module imports only the port and does nothing
on import. It loads no JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch.autograd import forward_ad

from swift_torch.models.precond import PassPrecond
from swift_torch.models.swinv2 import SwinV2
from swift_torch.parallel import mesh
from swift_torch.parallel.sharding import gather_state_dict, module_shards, shard_state_dict
from swift_torch.training.loss import SCMLoss
from swift_torch.training.optimizers.mars import MARS, MARS_TYPES
from swift_torch.training.optimizers.muon import MuonWithAuxAdam
from swift_torch.training.trainer import Trainer, muon_param_labels

NOISE = {"dist": "loguniform", "sigma_min": 0.02, "sigma_max": 200.0}


def build_net(spec: dict, geom: str, init: dict, lay: mesh.Layout | None = None) -> PassPrecond:
    """The geometry's PassPrecond (no auxiliary, logvar), fp32, with one
    process's weights ``init``; with ``lay``, this rank's part of it."""
    g = spec["geoms"][geom]
    res, C = tuple(g["res"]), spec["C"]
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in g["model"].items()}
    tp = {} if lay is None else dict(model_size=lay.model, model_rank=lay.model_rank,
                                     model_group=lay.model_group)
    model = SwinV2(img_resolution=res, in_channels=2 * C, out_channels=C, dtype=torch.float32,
                   **kw, **tp)
    net = PassPrecond(model, res, C, condition_channels=C, sigma_data=1.0)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in init.items()}
    net.load_state_dict(sd if lay is None else shard_state_dict(sd, module_shards(net)))
    return net


class FixedDraws(SCMLoss):
    """The sCM loss at given draws (t, z) of the global batch; a data rank
    takes its rows, as the loss's own draws do."""

    def __init__(self, spec: dict, t: np.ndarray, z: np.ndarray):
        g = spec["geoms"]["main"]
        super().__init__(g["res"][0], spec["variables"], dict(NOISE), sigma_data=1.0,
                         tangent_warmup_kimg=1)
        self.t, self.z = torch.from_numpy(t), torch.from_numpy(z)

    def draw(self, x, gen, shard=(0, 1)):
        r, n = shard
        rows = slice(r * x.shape[0], (r + 1) * x.shape[0]) if n > 1 else slice(None)
        return self.t[rows], self.z[rows]


def build_trainer(spec: dict, init: dict, batch: dict, lay: mesh.Layout | None = None):
    """The step's Trainer: optax.adamw's defaults on every parameter (lr
    ``spec["lr"]``, weight decay 1e-4), a constant lr, ``nimg`` 0."""
    net = build_net(spec, "main", init, lay)
    opt = torch.optim.AdamW([{"params": list(net.parameters()), "base_lr": spec["lr"]}],
                            lr=spec["lr"], betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    return Trainer(net, opt, FixedDraws(spec, batch["draw_t"], batch["draw_z"]),
                   global_batch_size=spec["global_batch"], lr_fn=lambda count, base: base,
                   run_dir=spec["dir"], seed=0)


def rows_of(batch: dict, rows) -> dict:
    return {k: batch[k][rows] for k in ("x", "t", "delta")}


def forward(spec: dict, batch: dict, lay: mesh.Layout) -> dict:
    out = {}
    for geom in spec["geoms"]:
        init = dict(np.load(os.path.join(spec["dir"], f"init-{geom}.npz")))
        net = build_net(spec, geom, init, lay)
        x, cond, t = (torch.from_numpy(batch[f"{geom}_{k}"]) for k in ("x", "cond", "t"))
        dx, dt = torch.from_numpy(batch[f"{geom}_dx"]), torch.from_numpy(batch[f"{geom}_dt"])
        with torch.no_grad():
            y = net(x, t, cond)
            with forward_ad.dual_level():
                o = net(forward_ad.make_dual(x, dx), forward_ad.make_dual(t, dt), cond, jvp=True)
                primal, tangent = (a.clone() for a in forward_ad.unpack_dual(o))
        out[geom] = {"y": y, "jvp_y": primal, "tangent": tangent}
    return out


def step(spec: dict, init: dict, batch: dict, lay: mesh.Layout) -> dict:
    trainer = build_trainer(spec, init, batch, lay)
    local = rows_of(batch, mesh.rank_rows(spec["global_batch"] // lay.data))
    loss = trainer.backward(local)
    mean = loss.detach().clone()
    mesh.all_reduce_mean([mean], lay.data_group)
    own = {n: p.grad.clone() for n, p in trainer.params.items() if n not in trainer.shards}
    gnorm = trainer.update()
    shards = trainer.shards
    grads = gather_state_dict({n: p.grad for n, p in trainer.params.items()}, shards,
                              lay.model_group)
    return {
        "loss": float(loss), "mean_loss": float(mean), "grad_norm": float(gnorm),
        "grads": grads, "own_replicated_grads": own, "sliced": trainer.sliced,
        "split": sorted(shards),
        "params": gather_state_dict({n: p.detach() for n, p in trainer.params.items()}, shards,
                                    lay.model_group),
        "ema": gather_state_dict(dict(trainer.ema), shards, lay.model_group),
    }


def muon(spec: dict, init: dict, lay: mesh.Layout) -> dict:
    """Two Muon steps split over every rank against one unsplit optimizer
    on whole matrices in this process, on the same gradients (drawn from a
    seed, alike on every rank): with this rank's slices (tensor
    parallelism, when the layout has a model axis) and with whole
    matrices, in fp32 and bf16 momentum. Returns each case's largest
    difference (0.0: bit for bit) and the number of elements compared."""
    out = {}
    world = (mesh.rank(), mesh.world_size())
    for dtype in ("float32", "bfloat16"):
        for sliced in ((True, False) if lay.model > 1 else (False,)):
            nets = [build_net(spec, "main", init), build_net(spec, "main", init,
                                                              lay if sliced else None)]
            shards = module_shards(nets[1])
            opts = []
            for net, split in zip(nets, (False, True)):
                named = list(net.named_parameters())
                labels = muon_param_labels(named)
                opts.append(MuonWithAuxAdam(
                    [p for n, p in named if labels[n] == "muon"],
                    [p for n, p in named if labels[n] == "adam"], momentum_dtype=dtype,
                    shards=[shards.get(n) for n, _ in named if labels[n] == "muon"]
                    if split else None,
                    model_group=lay.model_group if split and sliced else None,
                    ns_split=world if split else (0, 1)))
            gen = torch.Generator().manual_seed(7)
            for _ in range(2):
                grads = {n: torch.randn(p.shape, generator=gen)
                         for n, p in nets[0].named_parameters()}
                for net, opt, own in zip(nets, opts, ({}, shards)):
                    for n, p in net.named_parameters():
                        p.grad = own[n].take(grads[n]) if n in own else grads[n].clone()
                    opt.step()
            want = dict(nets[0].named_parameters())
            got = dict(nets[1].named_parameters())
            diff = max(float((shards[n].take(want[n]) if n in shards else want[n]).sub(p)
                             .abs().max()) for n, p in got.items())
            out[f"{dtype}-{'slices' if sliced else 'whole'}"] = {
                "max_diff": diff, "split": len(shards),
                "equal": all(torch.equal(shards[n].take(want[n]) if n in shards else want[n], p)
                             for n, p in got.items())}
    return out


def mars(spec: dict, init: dict, lay: mesh.Layout) -> dict:
    """Two MARS steps of each kind on this rank's slices (its clip's norm
    and mars-shampoo's Newton-Schulz on the matrices gathered over the
    model group) against one optimizer on the whole network in this
    process, on the same gradients: each kind's largest difference (0.0:
    bit for bit) and the number of split weights."""
    out = {}
    for kind in MARS_TYPES:
        nets = [build_net(spec, "main", init), build_net(spec, "main", init, lay)]
        shards = module_shards(nets[1])
        opts = [MARS(nets[0].parameters(), mars_type=kind, weight_decay=0.1),
                MARS(nets[1].parameters(), mars_type=kind, weight_decay=0.1,
                     shards=[shards.get(n) for n, _ in nets[1].named_parameters()],
                     model_group=lay.model_group)]
        gen = torch.Generator().manual_seed(11)
        for _ in range(2):
            grads = {n: torch.randn(p.shape, generator=gen) for n, p in nets[0].named_parameters()}
            for net, opt, own in zip(nets, opts, ({}, shards)):
                for n, p in net.named_parameters():
                    p.grad = own[n].take(grads[n]) if n in own else grads[n].clone()
                opt.step()
        want = dict(nets[0].named_parameters())
        sliced = {n: shards[n].take(want[n]) if n in shards else want[n] for n in want}
        got = dict(nets[1].named_parameters())
        out[kind] = {"max_diff": max(float((sliced[n] - p).abs().max()) for n, p in got.items()),
                     "equal": all(torch.equal(sliced[n], p) for n, p in got.items()),
                     "split": len(shards)}
    return out


def main(workdir: str) -> None:
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    assert mesh.maybe_initialize_distributed("cpu")
    lay = mesh.init_layout(spec["model_size"])
    r = mesh.rank()
    torch.manual_seed(0)
    init = dict(np.load(os.path.join(workdir, "init-main.npz")))
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    results = {"layout": [lay.data, lay.model, lay.data_rank, lay.model_rank],
               "step": step(spec, init, batch, lay), "muon": muon(spec, init, lay),
               "mars": mars(spec, init, lay)}
    if spec.get("forward"):
        results["forward"] = forward(spec, batch, lay)
    torch.save(results, os.path.join(workdir, f"rank{r}.pt"))
    mesh.barrier()
    print(f"TP_WORKER_OK rank={r}")


if __name__ == "__main__":
    main(sys.argv[1])
