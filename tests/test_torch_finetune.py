"""The port's fine-tune and distill flows against the JAX package, on the CPU.

* ``InfiniteSampler`` (rank 0 and 1 of 2, offset 1, 2, 3) and
  ``DeltaBatchSampler``: the JAX streams, exactly.
* ``BatchLoader`` with a ``DeltaBatchSampler`` and ``multistep_forcings``
  across a ``set_offset`` switch: the JAX loader's batches, ``forcings_seq``
  included, bit for bit; the old iterator's producer has stopped.
* ``Standardizer.loss_std_fns`` at Δ 6, 12 and 24: bit for bit.
* ``kernel_crps`` (m 2 and 3, α 1 and 0.95) at rtol 1e-6; ``CRPSLoss``
  (m 2, steps 1 and 2, Δ 6 and 24) and ``MSELoss`` (steps 1 and 2) through a
  tiny SwinV2 on JAX's replayed draws: the loss at rtol 1e-5, every gradient
  against ``jax.grad`` at rtol 1e-4 (fp32 through two blocks; XLA and
  PyTorch sum in different orders).
* ``swift_torch.train`` end to end: ``finetune=multistep resume=run1`` (the
  saved config, the interval switch at the step the JAX rule gives, a
  checkpoint the JAX loader reads), the same without ``resume`` returning
  1, a fine-tune of a Muon run (a fresh AdamW), ``distill=<run1>`` on the sCM experiment (the frozen teacher, a step's
  loss equal to ``SCMLoss.value`` with it), ``era5-swinv2-5.6-distill``
  built cut to a tiny model, and ``trainer.profile=true`` writing a trace.
"""

import contextlib
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swift_tpu.factory as jfactory
import swift_tpu.training.loss as jloss
from swift_torch import factory, train
from swift_torch.data.era5 import ERA5Dataset
from swift_torch.data.pipeline import BatchLoader
from swift_torch.data.samplers import DeltaBatchSampler, InfiniteSampler
from swift_torch.data.standardize import Standardizer
from swift_torch.data.synthetic import SyntheticERA5
from swift_torch.models import convert
from swift_torch.training import loss as tloss
from swift_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, load_training_state
from swift_tpu.data.era5 import ERA5Dataset as JaxERA5Dataset
from swift_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from swift_tpu.data.samplers import DeltaBatchSampler as JaxDeltaBatchSampler
from swift_tpu.data.samplers import InfiniteSampler as JaxInfiniteSampler
from swift_tpu.data.standardize import Standardizer as JaxStandardizer
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.utils.checkpoint import load_checkpoint as load_checkpoint_jax
from tests.test_torch_train import C, E2E_VARS, F_, RES, VARS, _assert_grads, _grads_by_name, _pair

FORCINGS = ["land_sea_mask"]


@pytest.fixture(scope="module")
def h5_data(tmp_path_factory):
    return make_synthetic_era5(str(tmp_path_factory.mktemp("ft") / "data"), E2E_VARS, FORCINGS,
                               n_train=16, n_val=1, n_test=1)


# -- samplers and the loader ----------------------------------------------------


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("rank", [0, 1])
def test_samplers_match_jax(h5_data, rank, offset):
    ds = ERA5Dataset(h5_data, E2E_VARS, FORCINGS, residual=True)
    jds = JaxERA5Dataset(h5_data, E2E_VARS, FORCINGS, residual=True)
    s = InfiniteSampler(ds, rank=rank, num_replicas=2, shuffle=True, seed=11)
    js = JaxInfiniteSampler(jds, rank=rank, num_replicas=2, shuffle=True, seed=11)
    s.set_offset(offset)
    js.set_offset(offset)
    it, jit_ = iter(s), iter(js)
    assert [next(it) for _ in range(60)] == [next(jit_) for _ in range(60)]
    b = iter(DeltaBatchSampler(s, 3, ds.intervals, seed=12))
    jb = iter(JaxDeltaBatchSampler(js, 3, jds.intervals, seed=12))
    assert [next(b) for _ in range(20)] == [next(jb) for _ in range(20)]
    unshuffled = InfiniteSampler(ds, rank=rank, num_replicas=2, shuffle=False)
    junshuffled = JaxInfiniteSampler(jds, rank=rank, num_replicas=2, shuffle=False)
    it, jit_ = iter(unshuffled), iter(junshuffled)
    assert [next(it) for _ in range(30)] == [next(jit_) for _ in range(30)]


def _producers() -> int:
    return sum(t.name.endswith("(producer)") and t.is_alive() for t in threading.enumerate())


def test_multistep_loader_matches_jax_across_a_switch(h5_data):
    """Two batches at offset 1, a switch to offset 2 (the trainer's
    ``set_offset`` and a fresh iterator), three more: the JAX loader's
    batches bit for bit. Before the switch both producers are let run until
    their queue is full, as they are when a training step is slower than a
    batch: each has then drawn the Δ of 2 + 2 queued + 1 built batches, and
    the draws after the switch match."""
    kw = dict(variables=E2E_VARS, forcings=FORCINGS, residual=True, seed=3)
    ds, jds = ERA5Dataset(h5_data, **kw), JaxERA5Dataset(h5_data, **kw)
    sampler = InfiniteSampler(ds, seed=5)
    jsampler = JaxInfiniteSampler(jds, seed=5)
    loader = BatchLoader(ds, sampler, 3, num_workers=2, multistep_forcings=2,
                         batch_sampler=DeltaBatchSampler(sampler, 3, ds.intervals, seed=7))
    jloader = JaxBatchLoader(jds, jsampler, 3, num_workers=2, multistep_forcings=2,
                             batch_sampler=JaxDeltaBatchSampler(jsampler, 3, jds.intervals,
                                                                seed=7), use_pack=False)
    got, want = [], []
    it, jit_ = iter(loader), iter(jloader)
    for _ in range(2):
        got.append(next(it))
        want.append(next(jit_))
    ahead = np.random.default_rng(7)
    for _ in range(2 + 2 + 1):
        ahead.choice(ds.intervals)
    deadline = time.monotonic() + 60
    while any(b.rng.bit_generator.state != ahead.bit_generator.state
              for b in (loader.batch_sampler, jloader.batch_sampler)):
        assert time.monotonic() < deadline, "the producers did not fill their queues"
        time.sleep(0.01)
    before = _producers()
    it.close()
    assert _producers() == before - 1  # the old producer stopped
    loader.set_offset(2)
    jsampler.set_offset(2)
    it, jit_ = iter(loader), iter(jloader)
    for _ in range(3):
        got.append(next(it))
        want.append(next(jit_))
    it.close()
    assert {tuple(b["forcings_seq"].shape) for b in got} == {(3, 2, *RES, len(FORCINGS))}
    assert len({float(b["delta"][0, 0]) for b in got}) > 1  # several Δ over the batches
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _stats(seed=20):
    """Dataset statistics with SST among the variables and stds far from 1."""
    rng = np.random.default_rng(seed)
    nv, nf = C, F_
    return type("Stats", (), dict(
        variables=list(VARS), forcings=["land_sea_mask"], intervals=[6, 12, 24],
        x_means=rng.standard_normal((1, 1, nv + nf)).astype(np.float32),
        x_stds=rng.uniform(0.5, 3.0, (1, 1, nv + nf)).astype(np.float32),
        t_means={i: np.zeros((1, 1, nv), np.float32) for i in (6, 12, 24)},
        t_stds={i: rng.uniform(0.5, 3.0, (1, 1, nv)).astype(np.float32) for i in (6, 12, 24)}))


@pytest.mark.parametrize("delta", [6, 12, 24])
def test_loss_std_fns_match_jax(delta):
    st = _stats()
    got = Standardizer.from_dataset(st).loss_std_fns()
    want = JaxStandardizer.from_dataset(st).loss_std_fns()
    rng = np.random.default_rng(21)
    # unstd_t takes the variables; unstd_x and std_x variables, forcings or both
    for g, w, widths in zip(got, want, ((C,), (C, C + F_, F_), (C, C + F_, F_))):
        for channels in widths:
            v = rng.standard_normal((2, *RES, channels)).astype(np.float32)
            np.testing.assert_array_equal(g(torch.from_numpy(v), delta).numpy(),
                                          np.asarray(w(jnp.asarray(v), delta)))


# -- the losses -------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [1.0, 0.95])
@pytest.mark.parametrize("m", [2, 3])
def test_kernel_crps_matches_jax(m, alpha):
    rng = np.random.default_rng(22)
    preds = rng.standard_normal((2, *RES, C, m)).astype(np.float32)
    target = rng.standard_normal((2, *RES, C)).astype(np.float32)
    got = tloss.kernel_crps(torch.from_numpy(preds), torch.from_numpy(target), alpha).numpy()
    want = np.asarray(jloss.kernel_crps(jnp.asarray(preds), jnp.asarray(target), alpha))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _crps_noise(key, m: int, steps: int, shape) -> list:
    """JAX's draws of ``CRPSLoss``: per member ``split → (k0, k_last)``, a
    ``split`` a checkpointed step, ``k_last`` for the last."""
    out = []
    for mk in jax.random.split(key, m):
        k, k_last = jax.random.split(mk)
        per = []
        for _ in range(steps - 1):
            k, sub = jax.random.split(k)
            per.append(jax.random.normal(sub, shape))
        per.append(jax.random.normal(k_last, shape))
        out.append([torch.from_numpy(np.array(a)) for a in per])
    return out


def _loss_inputs(seed: int, steps: int):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((2, *RES, C)).astype(np.float32)
    cond = rng.standard_normal((2, *RES, C + F_)).astype(np.float32)
    aux = rng.uniform(0.5, 2.5, (2, 1)).astype(np.float32)
    fseq = rng.standard_normal((2, steps, *RES, F_)).astype(np.float32)
    return target, cond, aux, fseq


def _assert_used_grads(tpre, jgrads):
    """``_assert_grads``, a parameter the loss never reaches (the logvar
    head: the multistep losses take no logvar) held to JAX's zeros."""
    want = _grads_by_name(jgrads)
    for n, p in tpre.named_parameters():
        if p.grad is None:
            assert not np.any(want[n]), n
            p.grad = torch.zeros_like(p)
    _assert_grads(tpre, want)


def _std_pair():
    st = _stats()
    return Standardizer.from_dataset(st).loss_std_fns(), JaxStandardizer.from_dataset(st)


@pytest.mark.parametrize("delta", [6, 24])
@pytest.mark.parametrize("steps", [1, 2])
def test_crps_loss_matches_jax(steps, delta):
    jpre, params, tpre = _pair("d16", seed=23)
    fns, jstd = _std_pair()
    target, cond, aux, fseq = _loss_inputs(24, steps)
    jl = jloss.CRPSLoss(precond=jpre, lat_dim=RES[0], variables=tuple(VARS), ensemble_size=2,
                        alpha=0.95, std_fns=jstd.loss_std_fns(), n_variables=C)
    key = jax.random.PRNGKey(25)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: jl(p, key, target, cond, aux, fseq, delta=delta, steps=steps)))(params)
    tl = tloss.CRPSLoss(RES[0], VARS, ensemble_size=2, alpha=0.95, std_fns=fns, n_variables=C)
    got = tl.value(tpre, torch.from_numpy(target), torch.from_numpy(cond), torch.from_numpy(aux),
                   torch.from_numpy(fseq), _crps_noise(key, 2, steps, target.shape), delta, steps)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    _assert_used_grads(tpre, jg)


@pytest.mark.parametrize("steps", [1, 2])
def test_mse_loss_matches_jax(steps):
    jpre, params, tpre = _pair("d16", seed=26)
    fns, jstd = _std_pair()
    target, cond, aux, _ = _loss_inputs(27, steps)
    jl = jloss.MSELoss(precond=jpre, lat_dim=RES[0], variables=tuple(VARS),
                       std_fns=jstd.loss_std_fns(), n_variables=C)
    key = jax.random.PRNGKey(28)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: jl(p, key, target, cond, aux, steps=steps)))(params)
    noise = [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i),
                                                           target.shape))) for i in range(steps)]
    tl = tloss.MSELoss(RES[0], VARS, std_fns=fns, n_variables=C)
    got = tl.value(tpre, torch.from_numpy(target), torch.from_numpy(cond), torch.from_numpy(aux),
                   noise, steps)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    _assert_used_grads(tpre, jg)


def test_crps_draws_are_passed_into_the_checkpointed_steps():
    """``__call__`` draws one tensor a member and step from the generator and
    hands them to ``value``: the same generator state gives the same loss
    and gradients with and without the per-step checkpoint's recompute."""
    _, _, tpre = _pair("d16", seed=29)
    fns, _ = _std_pair()
    target, cond, aux, fseq = (torch.from_numpy(a) for a in _loss_inputs(30, 2))
    tl = tloss.CRPSLoss(RES[0], VARS, std_fns=fns, n_variables=C)
    losses, grads = [], []
    for _ in range(2):
        tpre.zero_grad()
        loss = tl(tpre, target, cond, aux, torch.Generator().manual_seed(31), fseq, 12, 2)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in tpre.named_parameters()
                      if p.grad is not None})
    gen = torch.Generator().manual_seed(31)
    noise = [[torch.randn(target.shape, generator=gen) for _ in range(2)] for _ in range(2)]
    assert tl.value(tpre, target, cond, aux, fseq, noise, 12, 2).item() == losses[0] == losses[1]
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


# -- the CLI ----------------------------------------------------------------------


@contextlib.contextmanager
def _run_in(path, **env):
    """cwd ``path`` and the environment ``env`` for the block."""
    old_cwd, old_env = os.getcwd(), {k: os.environ.get(k) for k in env}
    os.chdir(path)
    os.environ.update(env)
    try:
        yield
    finally:
        os.chdir(old_cwd)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def run1(tmp_path_factory, h5_data):
    """A TrigFlow run of the tiny experiment (3 steps of 4 images): the run
    the fine-tune resumes and the distillation's teacher."""
    work = tmp_path_factory.mktemp("cli")
    with _run_in(work, SWIFT_SYNTH_ROOT=h5_data, RUN_ID="run1"):
        assert train.main(["experiment=synthetic-tiny-scm", "loss=trigflow", "--device", "cpu",
                           "trainer.total_kimg=0.012", "trainer.kimg_per_tick=0.004"]) == 0
    return work, work / "results" / "synthetic-tiny-scm" / "run1"


INTERVALS = "finetune.intervals=[{steps: 1, kimg: 0.008}, {steps: 2, kimg: 0.008}]"


def test_finetune_cli(run1, h5_data, monkeypatch):
    work, run = run1
    base = ["experiment=synthetic-tiny-scm", "finetune=multistep", "resume=run1",
            "--device", "cpu", INTERVALS]
    unrolls = []
    step = train.Trainer.step
    monkeypatch.setattr(train.Trainer, "step",
                        lambda self, batch, steps=1: unrolls.append(steps) or step(self, batch,
                                                                                   steps))
    with _run_in(work, SWIFT_SYNTH_ROOT=h5_data, RUN_ID="ft"):
        assert train.main(base) == 0
    out = work / "results" / "synthetic-tiny-scm" / "ft"
    cfg = train.cfglib.load_config(out / ".hydra" / "config.yaml")
    assert cfg["loss"]["_target_"].endswith("CRPSLoss") and cfg["loss"]["ensemble_size"] == 2
    assert cfg["optimizer"]["_target_"].endswith("AdamW") and cfg["optimizer"]["lr"] == 1e-5
    assert cfg["trainer"]["total_kimg"] == pytest.approx(0.016)  # kimg 0 + the intervals'
    assert cfg["trainer"]["lr_cosine_anneal"] is False
    assert (cfg["trainer"]["checkpoint_ticks"], cfg["trainer"]["val_ticks"]) == (200, 50)
    # the JAX rule (trainer.py:534-551): the intervals end at 8 and 16 images; the switch
    # comes before the first step that starts with more than 8 images seen, the fourth
    assert unrolls == [1, 1, 1, 2]
    ckpt = latest_checkpoint(str(out / "checkpoints"))
    params_sd, ema_sd, _ = load_training_state(ckpt)
    jpre = jfactory.build_precond(cfg["precond"], cfg["model"], RES, len(E2E_VARS),
                                  len(E2E_VARS) + 1)
    init = jpre.init(jax.random.PRNGKey(0))
    restored = load_checkpoint_jax(ckpt, {"params": init, "ema": init})
    back = convert.params_to_state_dict(jax.device_get(restored["params"]))
    for n in params_sd:
        np.testing.assert_array_equal(back[n], params_sd[n].numpy(), err_msg=n)
    with _run_in(work, SWIFT_SYNTH_ROOT=h5_data, RUN_ID="ft-no-resume"):
        assert train.main([a for a in base if not a.startswith("resume")]) == 1


def test_finetune_of_a_muon_run_starts_a_fresh_optimizer(run1, h5_data):
    """The paper's flow: an sCM run trained with Muon, fine-tuned with
    AdamW. The checkpoint's Muon state is not AdamW's, so the fine-tune
    takes the weights and a fresh optimizer, as the JAX trainer does when
    its template does not match, and trains."""
    work, _ = run1
    with _run_in(work, SWIFT_SYNTH_ROOT=h5_data, RUN_ID="muon"):
        assert train.main(["experiment=synthetic-tiny-scm", "optimizer=muon", "--device", "cpu",
                           "trainer.total_kimg=0.008", "trainer.kimg_per_tick=0.004"]) == 0
    ckpt = latest_checkpoint(str(work / "results" / "synthetic-tiny-scm" / "muon" / "checkpoints"))
    params_sd, _, opt = load_training_state(ckpt)
    assert any(k.endswith("/momentum_buffer") for k in opt)
    with _run_in(work, SWIFT_SYNTH_ROOT=h5_data, RUN_ID="ft-muon"):
        trainer, loader, _ = train.setup(["experiment=synthetic-tiny-scm", "finetune=multistep",
                                          "resume=muon", "--device", "cpu", INTERVALS])
        assert type(trainer.optimizer) is torch.optim.AdamW and not trainer.optimizer.state
        for n, p in trainer.net.named_parameters():
            assert torch.equal(p.detach(), params_sd[n]), n
        trainer.train(loader)
    assert trainer.updates == 4


def test_distill_cli(run1, h5_data):
    work, run = run1
    teacher_sd = load_checkpoint(latest_checkpoint(str(run / "checkpoints")))
    with _run_in(work, SWIFT_SYNTH_ROOT=h5_data, RUN_ID="distill"):
        trainer, loader, cfg = train.setup(["experiment=synthetic-tiny-scm", f"distill={run}",
                                            "loss.tangent_warmup_kimg=0", "--device", "cpu",
                                            "trainer.total_kimg=0.008"])
    assert cfg["loss"]["distillation"] is True and trainer.loss_fn.distillation
    teacher = trainer.teacher
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    for n, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_sd[n]), n
    batch = next(iter(loader))
    gen = torch.Generator().manual_seed(0)
    gen.set_state(trainer.gen.get_state())
    dev = {k: torch.from_numpy(batch[k]) for k in ("x", "t", "delta")}
    t, z = trainer.loss_fn.draw(dev["t"], gen)
    want = trainer.loss_fn.value(trainer.net, dev["t"], t, z, trainer.nimg, dev["x"],
                                 dev["delta"], teacher=teacher)
    without = trainer.loss_fn.value(trainer.net, dev["t"], t, z, trainer.nimg, dev["x"],
                                    dev["delta"])
    assert trainer.step(batch)["loss"].item() == want.item() != without.item()
    with _run_in(work):
        trainer.train(loader)
    for n, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_sd[n]), n
    assert all(p.grad is None for p in teacher.parameters())


def test_distill_experiment_builds_cut_to_a_tiny_model():
    cfg = train.cfglib.compose("train", [
        "experiment=era5-swinv2-5.6-distill", "model.depth=2", "model.dim=32", "model.heads=2",
        "model.window_size=[4,4]", "model.shift_size=[2,2]"])
    assert cfg["loss"]["distillation"] is True and cfg.get("distill") is None
    ds_cfg = cfg["data"]["dataset"]
    ds = SyntheticERA5(ds_cfg["variables"], ds_cfg["forcings"], n_files=4, shape=(8, 16))
    net = factory.build_precond(cfg["precond"], cfg["model"], ds.img_resolution,
                                ds.n_target_channels, ds.n_condition_channels, torch.float32)
    loss = factory.build_loss(cfg["loss"], ds)
    opt, _ = factory.build_optimizer(cfg["optimizer"], cfg["trainer"], 2, net)
    assert type(loss) is tloss.SCMLoss and loss.distillation
    assert type(opt) is torch.optim.AdamW
    assert net.model.logvar_embed is not None and tuple(net.model.patch_size) == (1, 1)


def test_profile_writes_a_trace(run1, h5_data):
    work, _ = run1
    with _run_in(work, SWIFT_SYNTH_ROOT=h5_data, RUN_ID="prof"):
        assert train.main(["experiment=synthetic-tiny-scm", "loss=trigflow", "--device", "cpu",
                           "trainer.total_kimg=0.004", "trainer.profile=true"]) == 0
    trace = work / "results" / "synthetic-tiny-scm" / "prof" / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
