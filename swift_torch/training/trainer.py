"""Trainer of the port: train step, EMA, kimg ticks, checkpoints.

Counterpart of ``swift_tpu/training/trainer.py`` (reference
src/swift/training/trainer.py:31-535). One optimizer step is loss → backward
(over ``grad_accum`` microbatches) → ``clamp_grads`` → the optimizer (AdamW,
or Muon with aux-Adam) with each group's lr set from :func:`lr_schedule` →
:func:`ema_update`. An sCM loss gets the images seen before the step as its
``step`` (the tangent warmup), as the JAX trainer passes ``state.nimg``. The
tick bookkeeping, the ``stats.jsonl`` keys, the checkpoint naming, the
SIGTERM checkpoint and the resume follow the JAX trainer, and so does the
online validation every ``val_ticks`` ticks (:meth:`Trainer._val_step`): a
rollout of one validation batch from the EMA weights, sampled by ``edm``
for an ``EDMLoss`` and ``dpm`` otherwise with the experiment's solver
kwargs, its RMSE (and, with ``val_crps_members`` ≥ 2, its CRPS) written to
``val_stats.jsonl`` under the JAX trainer's keys.

Fine-tuning (``finetune_kwargs`` of ``name: multistep``) follows the JAX
trainer's interval schedule: each interval's kimg is made cumulative from
the resumed kimg, the first interval's unroll is set on the loader
(``set_offset``) before the first batch, and once the images seen exceed
an interval's end the next one starts, with a fresh iterator over the
loader (the old one closed, its producer stopped). The multistep losses
get the unroll ``steps``; ``CRPSLoss`` also the batch's one Δ, read on
the host, and its ``forcings_seq``. A distilled sCM loss gets the frozen
``teacher``. ``profile=True`` traces the whole run with
``torch.profiler`` into ``<run_dir>/profile/trace.json``.

Under data parallelism (``swift_torch.parallel``; one replica a process,
each process given its own rows of the global batch) :meth:`Trainer.update`
first averages the gradients over the ranks, so every rank clamps and
applies the global batch's gradients, as the JAX trainer differentiates
the global mean before it clamps; the losses draw their noise for the
global batch and keep the rank's rows (``shard``); the loss written to
``stats.jsonl`` and the validation scores are means over the ranks, and
rank 0 alone writes files, a checkpoint behind a barrier. A stop signal
(SIGTERM, SIGINT) is decided together: each rank's request rides the
gradients' all-reduce, so every rank stops, and checkpoints, after the same
step whichever ranks the signal reached first.

Under tensor parallelism (a ``model`` axis, ``parallel.mesh.init_layout``;
the network built with it holds this rank's slices,
``parallel.sharding.module_shards``) each parameter's gradient is made
complete and counted once: the gradients are averaged over the **data**
group only; a replicated parameter that the split blocks use on their
rank's slice alone (the per-head logit scale, ``sliced_params``) has its
gradient summed over the **model** group first; a replicated parameter on
replicated work already has the same gradient on every model rank.
:func:`global_norm` sums the slices' squares over the model group and
counts the replicated ones once; ``clamp_grads``, AdamW and the EMA run on
the slices as they are, and Muon and MARS gather the slices where a whole
matrix is needed (``optimizers.muon``, ``optimizers.mars``). A checkpoint is gathered
over the model group into one process's layout (rank 0 writes it), and a
resume on any layout slices it.

Under a pipe axis (``system=tpu-pp``) training is not pipelined, as the JAX
package's ``train`` does not pipeline it: every stage rank of a data row
holds the whole network, loads the same rows and takes the same step, the
gradients averaged over the data group; a stop request is summed over the
pipe group too.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from swift_torch.parallel.mesh import all_reduce_mean, all_reduce_sum, barrier, layout
from swift_torch.parallel.sharding import (
    gather_state_dict,
    module_shards,
    shard_state_dict,
    sliced_params,
)
from swift_torch.training.loss import CRPSLoss, EDMLoss, MSELoss, SCMLoss
from swift_torch.utils.checkpoint import (
    get_ckpt_num,
    load_training_state,
    save_checkpoint,
)
from swift_torch.utils.log import get_logger, is_main_process

logger = get_logger(__name__)


# ----------------------------------------------------------------------------
# Schedules and param grouping (reference train.py:269-313, trainer.py:199-217)


def lr_schedule(
    global_batch_size: int,
    lr_rampup_kimg: float = 10000,
    total_kimg: float = 200000,
    lr_min_factor: float = 0.01,
    lr_cosine_anneal: bool = True,
    resume_kimg: int = 0,
) -> Callable[[int, float], float]:
    """Linear warmup + optional cosine anneal keyed on global nimg. Returns
    ``schedule(count, base)``: the lr after ``count`` optimizer updates of
    this run for a parameter group of base lr ``base`` (the JAX package's
    optax schedule of that base, the same numbers)."""
    warmup_nimg = lr_rampup_kimg * 1000
    total_nimg = total_kimg * 1000

    def schedule(count: int, base: float) -> float:
        min_lr = base * lr_min_factor
        nimg = resume_kimg * 1000 + count * global_batch_size
        if nimg < warmup_nimg:
            return min_lr + (base - min_lr) * (nimg / max(warmup_nimg, 1))
        if lr_cosine_anneal:
            progress = min(1.0, (nimg - warmup_nimg) / max(total_nimg - warmup_nimg, 1))
            return min_lr + 0.5 * (base - min_lr) * (1 + math.cos(math.pi * progress))
        if warmup_nimg > 0:
            # the lr holds at the value the last warmup step set
            last = (warmup_nimg - 1) // global_batch_size * global_batch_size
            return min_lr + (base - min_lr) * (last / warmup_nimg)
        return base

    return schedule


def adamw_decay_mask(names) -> dict[str, bool]:
    """True (decay) except pos_embed and norm scales/biases outside
    modulation (reference train.py:274-285); keyed on parameter names."""

    def label(name: str) -> bool:
        if "pos_embed" in name:
            return False
        if "norm" in name and "modulation" not in name:
            return False
        return True

    return {n: label(n) for n in names}


def muon_param_labels(named_params) -> dict[str, str]:
    """"muon" for the 2-D weights inside the transformer blocks (to_qkv, wo,
    w1, w2 and both AdaLN modulation weights), "adam" for everything else
    (the JAX package's labels: reference train.py:296-311 keys on ``ndim >=
    2 and "transformer" in name``). The per-head logit ``scale`` is
    (1, heads, 1, 1) here, as in the reference, but goes to Adam, as the
    JAX package assigns it (a documented divergence from the reference,
    ``swift_tpu/training/trainer.py::muon_param_labels``); hence the 2-D
    rule instead of ndim >= 2."""
    return {n: "muon" if ".transformer." in f".{n}" and p.ndim == 2 else "adam"
            for n, p in named_params}


def swin_flop_count(
    img_shape, batch_size, depth, num_channels, hidden_size,
    ffn_hidden_size, patch_size, window_size,
) -> int:
    """Analytic FLOP model (reference models/swin.py:27-54): 6·fwd_flop =
    3 (fwd+bwd) × 2 (MAC)."""
    img_h, img_w = img_shape
    p_dim = patch_size[0] * patch_size[1]
    seqlen = window_size[0] * window_size[1]
    nwindows = batch_size * img_h * img_w / seqlen / p_dim
    pre_post = 2 * nwindows * p_dim * num_channels * hidden_size
    qkvo = 4 * nwindows * seqlen * hidden_size**2
    fa = 2 * nwindows * seqlen**2 * hidden_size
    glu = 3 * nwindows * seqlen * ffn_hidden_size * hidden_size
    fwd = (qkvo + fa + glu) * depth + pre_post
    return int(6 * fwd)


@torch.no_grad()
def clamp_grads(params) -> None:
    """NaN/Inf gradient defense, in place: nan -> 0, ±inf -> ±1e5
    (reference trainer.py:223-231)."""
    for p in params:
        if p.grad is not None:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=1e5, neginf=-1e5)


@torch.no_grad()
def ema_update(ema: dict, params: dict, nimg: float, global_batch_size: float,
               ema_halflife_kimg: float, ema_rampup_ratio: Optional[float]) -> None:
    """EMA with half-life ramp-up, in place (reference trainer.py:237-245):
    halflife_nimg is capped at ``nimg * rampup`` (the images seen BEFORE
    this step), beta = 0.5^(batch/halflife), ema <- p + beta·(ema − p)."""
    halflife = ema_halflife_kimg * 1000
    if ema_rampup_ratio is not None:
        halflife = min(halflife, nimg * ema_rampup_ratio)
    beta = 0.5 ** (global_batch_size / max(halflife, 1e-8))
    for name, e in ema.items():
        p = params[name]
        e.copy_(p + beta * (e - p))


def global_norm(params, sharded=(), group=None) -> torch.Tensor:
    """L2 norm over every gradient, fp32. Under tensor parallelism
    ``sharded`` holds the parameters of which this rank has a slice: their
    squares are summed over the model ``group``, the others' counted once."""
    ids = {id(p) for p in sharded}
    sq = [p.grad.float().pow(2).sum() for p in params
          if p.grad is not None and id(p) not in ids]
    total = torch.stack(sq).sum()
    if ids:
        part = torch.stack([p.grad.float().pow(2).sum() for p in sharded]).sum().reshape(1)
        all_reduce_sum([part], group)
        total = total + part[0]
    return torch.sqrt(total)


# ----------------------------------------------------------------------------


class Trainer:
    """``net``: the precond module, already on its device; ``optimizer``: a
    ``torch.optim`` optimizer over ``net``'s parameters, each of whose
    groups holds a ``base_lr`` and gets the lr ``lr_fn(count, base_lr)``
    before every update; ``loss_fn(net, x, condition,
    auxiliary, gen)``: the loss (see ``swift_torch.training.loss``), and
    ``step=`` the images seen before the update and ``teacher=`` when it is
    an ``SCMLoss``, the unroll ``steps`` for the multistep losses, and Δ and
    ``forcings_seq`` for ``CRPSLoss``."""

    def __init__(
        self,
        net: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        loss_fn,
        *,
        global_batch_size: int,
        lr_fn: Callable[[int, float], float],
        total_kimg: float = 200000,
        ema_halflife_kimg: float = 500,
        ema_rampup_ratio: Optional[float] = 0.05,
        kimg_per_tick: float = 50,
        checkpoint_ticks: Optional[int] = 50,
        val_ticks: Optional[int] = 50,
        val_target_interval: int = 56,
        val_variables: Optional[list[str]] = None,
        val_crps_members: int = 0,
        solver_kwargs: Optional[dict] = None,
        run_dir: str = ".",
        ckpt: Optional[str] = None,
        flop_count: Optional[int] = None,
        seed: int = 0,
        grad_accum: int = 1,
        finetune_kwargs: Optional[dict] = None,
        teacher: Optional[torch.nn.Module] = None,
        profile: bool = False,
    ):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.net = net
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.global_batch_size = global_batch_size
        self.lr_fn = lr_fn
        self.total_kimg = total_kimg
        self.ema_halflife_kimg = ema_halflife_kimg
        self.ema_rampup_ratio = ema_rampup_ratio
        self.kimg_per_tick = kimg_per_tick
        self.checkpoint_ticks = checkpoint_ticks
        self.val_ticks = val_ticks
        self.val_target_interval = val_target_interval
        self.val_variables = val_variables
        # 0 = off; >= 2 adds an ensemble fair-kernel CRPS of that many members
        self.val_crps_members = int(val_crps_members)
        self.solver_kwargs = dict(solver_kwargs or {})
        self.solver_type = "edm" if isinstance(loss_fn, EDMLoss) else "dpm"
        self.run_dir = run_dir
        self.flop_count = flop_count
        self.seed = seed
        self.grad_accum = int(grad_accum)
        self.finetune_kwargs = dict(finetune_kwargs or {})
        self.teacher = teacher
        self.profile = bool(profile)
        self.device = next(net.parameters()).device
        self.layout = layout()
        # the batch and the noise go by the data index: a row's model ranks alike
        self.rank, self.world = self.layout.data_rank, self.layout.data
        self.stop_requested = False  # set by a stop signal on this rank
        self.stopping = False  # any rank's request, as of the last update
        self.depth = len(net.model.transformer.layers)
        self.params = dict(net.named_parameters())
        self.shards = module_shards(net)  # {name: Shard} of this rank's slices
        self.sliced = sliced_params(net)
        self.history: dict[str, list] = {}

        self.resume_kimg = 0
        if ckpt is not None:
            self._restore(ckpt)
            self.resume_kimg = get_ckpt_num(ckpt)
        else:
            self.ema = {n: p.detach().clone() for n, p in self.params.items()}
        self.nimg = float(self.resume_kimg * 1000)
        self.updates = 0  # optimizer updates in this run (the lr schedule's count)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.finetune_kwargs.get("name") == "multistep":
            cum, intervals = self.resume_kimg, []
            for iv in self.finetune_kwargs["intervals"]:
                cum += iv["kimg"]
                intervals.append({**iv, "kimg": cum})
            self.finetune_kwargs["intervals"] = intervals
            logger.info(f"finetune schedule: {self.finetune_kwargs}")

    def _opt_shards(self, arrays) -> dict:
        """{"<name>/<key>": Shard} of the optimizer state kept per element of
        a split parameter (shaped like it; not a scalar ``step``)."""
        out = {}
        for k, v in arrays.items():
            shard = self.shards.get(k.rsplit("/", 1)[0])
            if shard is not None and tuple(v.shape) in (shard.shape, shard.full):
                out[k] = shard
        return out

    def _restore(self, ckpt: str) -> None:
        params, ema, opt_state = load_training_state(ckpt)
        if self.shards:  # one process's layout -> this rank's slices
            params = shard_state_dict(params, self.shards)
            ema = shard_state_dict(ema, self.shards)
            specs = self._opt_shards(opt_state)
            opt_state = {k: specs[k].take(torch.from_numpy(np.array(v))).numpy()
                         if k in specs else v for k, v in opt_state.items()}
        self.net.load_state_dict(params)
        self.ema = {n: ema[n].to(self.device).clone() for n in self.params}
        if opt_state:
            try:
                self.optimizer.load_state_dict(optimizer_state_dict(self.optimizer,
                                                                    self.params, opt_state))
                return
            except (KeyError, ValueError) as e:
                logger.warning(f"Could not load the optimizer state ({e}); fresh optimizer.")
        else:
            logger.warning("Checkpoint holds no optimizer state; fresh optimizer.")

    # ------------------------------------------------------------------
    def _loss_kwargs(self, batch: dict, steps: int) -> dict:
        """The loss's arguments beyond (target, condition, auxiliary), as the
        JAX trainer's ``_loss_kwargs``, and this rank's ``shard`` of the
        global batch under data parallelism; tensors of the batch are sliced
        per microbatch by :meth:`backward`."""
        kwargs = {"shard": (self.rank, self.world)} if self.world > 1 else {}
        if isinstance(self.loss_fn, SCMLoss):
            kwargs.update(step=self.nimg, teacher=self.teacher)
        elif isinstance(self.loss_fn, MSELoss):
            kwargs.update(steps=steps)
        elif isinstance(self.loss_fn, CRPSLoss):
            delta = int(round(float(np.asarray(batch["delta"]).reshape(-1)[0]) * 10))
            kwargs.update(steps=steps, delta=delta, forcings_seq=batch["forcings_seq"])
        return kwargs

    def backward(self, batch: dict, steps: int = 1) -> torch.Tensor:
        """Loss and gradients of a host batch (this rank's rows of the
        global batch) at an unroll of ``steps`` (the multistep losses), over
        ``grad_accum`` microbatches (each loss a per-sample mean, the
        gradients averaged over the microbatches; under data parallelism
        the global microbatch is the ranks' microbatches side by side).
        Returns this rank's loss as a device scalar."""
        net, accum = self.net, self.grad_accum
        dev = self.device
        kwargs = self._loss_kwargs(batch, steps)
        tensors = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
                   for k in ("x", "t", "delta")}
        if "forcings_seq" in kwargs:
            kwargs["forcings_seq"] = torch.as_tensor(kwargs["forcings_seq"]).to(
                dev, non_blocking=True)
        B = tensors["t"].shape[0]
        if B % accum:
            raise ValueError(f"grad_accum={accum} must divide the batch of {B}")
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=dev)
        for mb in range(accum):
            sl = slice(mb * B // accum, (mb + 1) * B // accum)
            mb_kwargs = {k: v[sl] if isinstance(v, torch.Tensor) else v
                         for k, v in kwargs.items()}
            loss = self.loss_fn(net, tensors["t"][sl], tensors["x"][sl], tensors["delta"][sl],
                                gen=self.gen, **mb_kwargs)
            (loss / accum).backward()
            loss_sum += loss.detach()
        return loss_sum / accum

    def update(self) -> torch.Tensor:
        """The gradients averaged over the ranks → clamp_grads → the
        optimizer at the scheduled lr (each group's schedule from its own
        ``base_lr``) → EMA, a parameter without a gradient updated as from a
        zero one (weight decay, momentum), as the JAX trainer's optax update
        takes it; returns the global gradient norm (after the clamp) as a
        device scalar. Sets ``stopping`` when any rank has requested a stop:
        under data parallelism the request is one more element of the
        gradients' all-reduce, read on the host once the update is queued."""
        params = list(self.params.values())
        for p in params:
            if p.grad is None:  # not reached by the loss (a multistep loss's logvar head)
                p.grad = torch.zeros_like(p)
        lay = self.layout
        many = lay.data * lay.model * lay.pipe > 1
        stop = torch.full((1,), float(self.stop_requested), device=self.device)
        if lay.model > 1:  # the slices' shares of the per-head scales, and the stop request
            all_reduce_sum([self.params[n].grad for n in self.sliced] + [stop],
                           lay.model_group)
        if lay.pipe > 1:  # the stage ranks of a row take the same step: the stop request
            all_reduce_sum([stop], lay.pipe_group)
        all_reduce_mean([p.grad for p in params] + ([stop] if lay.data > 1 else []),
                        lay.data_group)
        clamp_grads(params)
        gnorm = global_norm(params, [self.params[n] for n in self.shards], lay.model_group)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(self.updates, group["base_lr"])
        self.optimizer.step()
        self.updates += 1
        ema_update(self.ema, self.params, self.nimg, float(self.global_batch_size),
                   self.ema_halflife_kimg, self.ema_rampup_ratio)
        self.nimg += self.global_batch_size
        self.stopping = bool(stop.item()) if many else self.stop_requested
        return gnorm

    def step(self, batch: dict, steps: int = 1) -> dict:
        """One optimizer step on a host batch (``steps``: the multistep
        losses' unroll); returns {"loss", "grad_norm"} as device scalars."""
        loss = self.backward(batch, steps)
        return {"loss": loss, "grad_norm": self.update()}

    def _next_interval(self, steps: Optional[int], global_nimg: float) -> tuple[int, bool]:
        """(the unroll for the next step, whether it switched the loader):
        the JAX trainer's rule, the first interval before the first step,
        the next one once ``global_nimg`` exceeds the current one's end."""
        if self.finetune_kwargs.get("name") != "multistep":
            return 1, False
        intervals = self.finetune_kwargs["intervals"]
        if steps is None:
            return intervals[0]["steps"], True
        if global_nimg > intervals[0]["kimg"] * 1000 and len(intervals) > 1:
            intervals.pop(0)
            logger.info(f"Switching to interval {intervals[0]}")
            return intervals[0]["steps"], True
        return steps, False

    # ------------------------------------------------------------------
    def _val_step(self, val_batches_fn, val_dataset, cur_tick: int, global_nimg: float,
                  val_jsonl) -> dict:
        """One validation batch rolled out from the EMA weights (the trained
        ones untouched, the net in eval mode meanwhile), its metrics logged,
        kept in the history and written to ``val_jsonl``; returns them."""
        from swift_torch.sampling.factory import sampler_factory
        from swift_torch.training.validate import CRPS_rollout, RMSE_rollout

        training = self.net.training
        self.net.eval()
        sampler = sampler_factory(self.solver_type, _WithWeights(self.net, self.ema),
                                  **self.solver_kwargs)

        def generator():  # a stream a rank, the one-process stream on rank 0 of 1
            return torch.Generator(device=self.device).manual_seed(
                (self.seed + cur_tick) * self.world + self.rank)

        try:
            agg, arr = RMSE_rollout(sampler, val_batches_fn(), val_dataset,
                                    self.val_target_interval, generator(), num_batches=1,
                                    device=self.device)
            if self.val_crps_members >= 2:
                cagg, carr = CRPS_rollout(sampler, val_batches_fn(), val_dataset,
                                          self.val_target_interval, generator(),
                                          members=self.val_crps_members, num_batches=1,
                                          device=self.device)
        finally:
            self.net.train(training)
        variables = val_dataset.variables
        selected = [v for v in (self.val_variables or variables) if v in variables] or variables
        scores = {"rmse": (agg, arr)}
        if self.val_crps_members >= 2:
            scores["crps"] = (cagg, carr)
        val_metrics = {"train/kimg": int(global_nimg / 1e3), "val/tick": cur_tick}
        for name, (total, a) in scores.items():
            rows = {v: [float(x) for x in a[variables.index(v)]] for v in selected}
            val_metrics.update({f"val/{name}/{v}": row for v, row in rows.items()})
            val_metrics[f"val/{name}"] = float(total)
            # per-variable per-day history, as the JAX trainer's wandb metrics
            for v, row in rows.items():
                for day, x in enumerate(row):
                    desc = "6h" if day == 0 else f"{day}day"
                    self.history.setdefault(f"val/{name}/{desc}/{v}", []).append(x)
        logger.info(val_metrics)
        if val_jsonl is not None:
            val_jsonl.write(json.dumps(val_metrics) + "\n")
            val_jsonl.flush()
        return val_metrics

    def train(self, train_batches, val_batches=None, val_dataset=None):
        """``train_batches``: an iterable of host batch dicts (see
        ``swift_torch.data.pipeline``); ``val_batches``: a callable that
        returns an iterator of (X, TS, idx) of ``val_dataset`` (an
        ``ERA5RollOutDataset``), or None for no validation."""
        logger.info(f"Training for {self.total_kimg} kimg...")
        stats_jsonl = val_jsonl = None
        if is_main_process():
            os.makedirs(self.run_dir, exist_ok=True)
            stats_jsonl = open(os.path.join(self.run_dir, "stats.jsonl"), "at")
            val_jsonl = open(os.path.join(self.run_dir, "val_stats.jsonl"), "at")

        cur_tick = 0
        global_nimg = self.resume_kimg * 1000
        tick_start_nimg = global_nimg
        start_time = tick_start_time = time.perf_counter()
        dt_misc = dt_data_tick = 0.0
        i = j = 0
        it = iter(train_batches)
        steps = None

        prev_handlers = {}

        def _request_stop(signum, frame):
            logger.warning(f"signal {signum}: checkpointing at next tick")
            self.stop_requested = True

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:
            prev_handlers = {}  # not on the main thread
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        prof = self._start_profile() if self.profile else None

        try:
            while True:
                t0_iter = time.perf_counter()
                steps, switched = self._next_interval(steps, global_nimg)
                if switched and hasattr(train_batches, "set_offset"):
                    if hasattr(it, "close"):
                        it.close()  # stops the old iterator's producer
                    train_batches.set_offset(steps)
                    it = iter(train_batches)
                t0 = time.perf_counter()
                batch = next(it)
                dt_data_tick += time.perf_counter() - t0

                t0 = time.perf_counter()
                metrics_dev = self.step(batch, steps)
                i += 1
                global_nimg += self.global_batch_size
                done = global_nimg >= self.total_kimg * 1000 or self.stopping
                if (not done and cur_tick != 0
                        and global_nimg < tick_start_nimg + self.kimg_per_tick * 1000):
                    j += 1
                    continue

                # block for real timing at tick boundaries only; the loss is
                # the mean over the ranks, the gradient norm already global
                loss = metrics_dev["loss"].detach().float().clone()
                all_reduce_mean([loss], self.layout.data_group)
                metrics_host = {"loss": float(loss), "grad_norm": float(metrics_dev["grad_norm"])}
                dt_step = time.perf_counter() - t0
                if (self.val_ticks is not None and val_batches is not None
                        and cur_tick % self.val_ticks == 0):
                    self._val_step(val_batches, val_dataset, cur_tick, global_nimg, val_jsonl)
                tick_end_time = time.perf_counter()
                dt_tick = tick_end_time - tick_start_time
                nimg_tick = global_nimg - tick_start_nimg
                iters_tick = nimg_tick // self.global_batch_size
                tflops = ((iters_tick * self.flop_count / dt_tick) / 1e12
                          if self.flop_count else 0.0)
                mem_gb = (torch.cuda.max_memory_allocated(self.device) / 2**30
                          if self.device.type == "cuda" else 0.0)
                metrics = {
                    "train/tick": cur_tick,
                    "train/iter": i,
                    "train/jter": j,
                    "train/loss": metrics_host["loss"],
                    "train/grad_norm": metrics_host["grad_norm"],
                    "train/kimg": int(global_nimg / 1e3),
                    "train/tflops": tflops,
                    "train/dt/dt": tick_end_time - start_time,
                    "train/dt/tick": dt_tick,
                    "train/dt/iter": tick_end_time - t0_iter,
                    "train/dt/data": dt_data_tick,
                    "train/dt/step": dt_step,
                    "train/dt/misc": dt_misc,
                    "train/dt/kimg": 1e3 * dt_tick / max(nimg_tick, 1),
                    "train/mem/device": mem_gb,
                    "train/mem/cpu": _rss_gb(),
                    "train/lr": float(self.lr_fn(self.updates,
                                                 self.optimizer.param_groups[0]["base_lr"])),
                }
                logger.info(" ".join(
                    f"{k.replace('train/', '').replace('dt/', '').replace('mem/', '')}="
                    + (f"{v:.4g}" if isinstance(v, float) else str(v))
                    for k, v in metrics.items()))
                for k, v in metrics.items():
                    self.history.setdefault(k, []).append(v)
                if stats_jsonl is not None:
                    # the JAX trainer's line: each tick's metrics as one-sample moments
                    stats_jsonl.write(json.dumps({k: {"num": 1, "mean": float(v), "std": 0.0}
                                                  for k, v in metrics.items()}) + "\n")
                    stats_jsonl.flush()

                # a signal-requested stop checkpoints even when periodic
                # checkpointing is disabled
                want_ckpt = self.stopping or (
                    self.checkpoint_ticks is not None
                    and (done or (cur_tick % self.checkpoint_ticks == 0 and cur_tick != 0))
                )
                if want_ckpt:
                    self.save_checkpoint(global_nimg)
                    barrier()

                cur_tick += 1
                tick_start_nimg = global_nimg
                dt_data_tick = 0.0
                tick_start_time = time.perf_counter()
                dt_misc = tick_start_time - tick_end_time
                if done:
                    if prof is not None:
                        self._stop_profile(prof)
                        prof = None
                    if self.stopping:
                        logger.warning("stopped by signal; checkpoint saved — resume with "
                                       "resume=<this run id>")
                    logger.info(f"Finished training in "
                                f"{(tick_end_time - start_time) / 3600:.2f} hours")
                    if is_main_process():
                        out = os.path.join(self.run_dir, "outputs")
                        os.makedirs(out, exist_ok=True)
                        with open(os.path.join(out, "train.json"), "w") as f:
                            json.dump(self.history, f)
                    return self
        finally:
            if prof is not None:
                prof.stop()
            if hasattr(it, "close"):
                it.close()
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            for f in (stats_jsonl, val_jsonl):
                if f is not None:
                    f.close()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> str:
        """Stop ``prof`` and write its trace (Chrome format) under the run."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        path = os.path.join(self.run_dir, "profile", "trace.json")
        if is_main_process():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
            logger.info(f"Profile written: {path}")
        return path

    def save_checkpoint(self, cur_nimg: int) -> str:
        """Rank 0 writes the checkpoint in one process's layout; under tensor
        parallelism the model ranks of its data row gather it first (every
        rank calls this)."""
        path = os.path.join(self.run_dir, "checkpoints",
                            f"checkpoint-{int(cur_nimg) // 1000:06d}.npz")
        if self.layout.data_rank != 0 or not (self.shards or is_main_process()):
            return path
        params, ema = self.net.state_dict(), self.ema
        opt = optimizer_state_arrays(self.optimizer, self.params)
        if self.shards:
            group = self.layout.model_group
            params = gather_state_dict(params, self.shards, group)
            ema = gather_state_dict(ema, self.shards, group)
            opt = {k: v.numpy() for k, v in gather_state_dict(
                {k: torch.from_numpy(v) for k, v in opt.items()}, self._opt_shards(opt),
                group).items()}
        if is_main_process():
            logger.info(f"Saving checkpoint: {path}")
            save_checkpoint(path, ema, self.depth, params=params, opt_state=opt)
        return path


class _WithWeights:
    """``net`` called on other weights (the EMA's, by parameter name) through
    ``torch.func.functional_call``, its own parameters untouched; the
    metadata the solvers read is ``net``'s."""

    def __init__(self, net: torch.nn.Module, weights: dict):
        self.net, self.weights = net, weights

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.net, self.weights, args, kwargs)

    def __getattr__(self, name):
        return getattr(self.net, name)


def _rss_gb() -> float:
    try:
        import psutil

        return psutil.Process(os.getpid()).memory_info().rss / 2**30
    except ImportError:
        return 0.0


# ----------------------------------------------------------------------------
# optimizer state <-> flat arrays named by parameter (the port's opt_state layout)


def optimizer_state_arrays(optimizer: torch.optim.Optimizer, params: dict) -> dict:
    """{"<param name>/<state key>": numpy array} for every parameter with
    optimizer state (AdamW and aux-Adam: step, exp_avg, exp_avg_sq; Muon:
    momentum_buffer)."""
    names = {id(p): n for n, p in params.items()}
    out = {}
    for p, st in optimizer.state.items():
        for k, v in st.items():
            out[f"{names[id(p)]}/{k}"] = np.asarray(torch.as_tensor(v).detach().float().cpu())
    return out


def _state_keys(optimizer: torch.optim.Optimizer, group: dict) -> set:
    """The state keys ``optimizer`` keeps for a parameter of ``group``."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return {"step", "exp_avg", "exp_avg_sq"}
    return optimizer.state_keys(group)


def optimizer_state_dict(optimizer: torch.optim.Optimizer, params: dict, arrays: dict) -> dict:
    """Inverse of :func:`optimizer_state_arrays`: a state dict for
    ``optimizer.load_state_dict`` (its param groups, the saved state).
    Raises ValueError when a parameter's saved state is another
    optimizer's (a fine-tune's AdamW over a Muon run's checkpoint), as the
    JAX package's load refuses a state of another tree."""
    by_name: dict[str, dict] = {}
    for k, v in arrays.items():
        name, key = k.rsplit("/", 1)
        by_name.setdefault(name, {})[key] = torch.from_numpy(np.array(v))
    names = {id(p): n for n, p in params.items()}
    for group in optimizer.param_groups:
        want = _state_keys(optimizer, group)
        for p in group["params"]:
            got = set(by_name.get(names[id(p)], want))
            if got != want:
                raise ValueError(f"{names[id(p)]}: saved state {sorted(got)}, "
                                 f"{type(optimizer).__name__} keeps {sorted(want)}")
    ordered = [p for group in optimizer.param_groups for p in group["params"]]
    state = {i: by_name[names[id(p)]] for i, p in enumerate(ordered) if names[id(p)] in by_name}
    for st in state.values():
        if "step" in st:
            st["step"] = st["step"].reshape(())
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
