"""The port's training path against the JAX package, on the CPU in fp32.

* SwinV2 + PassPrecond gradients of a scalar loss against ``jax.grad`` of
  the JAX model, compared by converted name (``models.convert`` maps the
  gradient tree as it maps the params), for both head layouts and with the
  per-pair remat on and off; remat changes no value beyond fp32 rounding.
* ``TrigFlowLoss`` value and gradients with JAX's (τ, z) draws fed in.
* ``lr_schedule``, ``clamp_grads``, ``ema_update``, the AdamW decay mask,
  and one full train step (grads → clamp → AdamW → EMA) from converted
  params against optax's ``adamw`` with the mask.
* ``swift_torch.train`` end to end on synthetic h5 data with ``--device
  cpu``: the JAX trainer's ``stats.jsonl`` keys, a checkpoint that the JAX
  loader reads, a resume that restores params, EMA and AdamW state, and a
  forecast from the checkpoint's EMA through ``swift_torch.generate``; the
  same with the experiment's own sCM loss and Muon with aux-Adam; and the
  default experiment (``era5-swinv2-1.4-scm``) composed with no overrides
  builds ``SCMLoss`` and ``MuonWithAuxAdam``.

Tolerances: rtol 1e-4 for gradients (fp32 through two blocks; XLA and
PyTorch sum in different orders), 1e-5 for loss values, 1e-6 for the
parameters and EMA after one step (an AdamW step moves a parameter by at
most lr = 5e-4).
"""

import inspect
import json
import math
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import swift_tpu.factory as jfactory
import swift_tpu.training.loss as jloss
import swift_tpu.training.trainer as jtrainer
from swift_torch import factory, generate, train
from swift_torch.models import convert
from swift_torch.models.precond import PassPrecond as TorchPassPrecond
from swift_torch.models.swinv2 import SwinV2 as TorchSwinV2
from swift_torch.training import loss as tloss
from swift_torch.training import trainer as ttrainer
from swift_torch.training.optimizers.muon import MuonWithAuxAdam
from swift_torch.utils.checkpoint import latest_checkpoint, load_training_state
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.models.precond import PassPrecond
from swift_tpu.models.swinv2 import SwinV2
from swift_tpu.utils.checkpoint import load_checkpoint as load_checkpoint_jax

RES, C, F_ = (8, 16), 3, 1
VARS = ["2m_temperature", "sea_surface_temperature", "geopotential_500"]
GEOMS = {
    "d16": dict(dim=32, heads=2),
    "d12": dict(dim=32, heads=2, head_dim=12),  # d not a power of two
}
COMMON = dict(window_size=(2, 4), shift_size=(1, 2), patch_size=(2, 2), depth=2,
              auxiliary_dim=1, logvar=True)
NOISE = {"dist": "loguniform", "sigma_min": 0.02, "sigma_max": 200.0}


def _pair(geom, seed=0, scan_layers=True, remat=True):
    """(JAX PassPrecond, params, torch PassPrecond with the same weights)."""
    kw = dict(img_resolution=RES, in_channels=2 * C + F_, out_channels=C, **COMMON,
              **GEOMS[geom])
    jpre = PassPrecond(model=SwinV2(**kw, dtype=jnp.float32, scan_layers=scan_layers),
                       img_resolution=RES, img_channels=C, condition_channels=C + F_,
                       auxiliary_dim=1)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32) + np.asarray(a),
        jpre.init(jax.random.PRNGKey(seed)))
    tpre = TorchPassPrecond(TorchSwinV2(**kw, dtype=torch.float32, remat_layers=remat), RES, C,
                            condition_channels=C + F_, auxiliary_dim=1)
    tpre.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.params_to_state_dict(params).items()})
    return jpre, params, tpre


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, *RES, C)).astype(np.float32)
    cond = rng.standard_normal((B, *RES, C + F_)).astype(np.float32)
    t = rng.uniform(0.1, 1.5, (B,)).astype(np.float32)
    aux = rng.uniform(0.5, 2.5, (B, 1)).astype(np.float32)
    return x, cond, t, aux


def _grads_by_name(jgrads):
    return convert.params_to_state_dict(jax.device_get(jgrads))


def _assert_grads(tpre, want, rtol=1e-4):
    got = {n: p.grad for n, p in tpre.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-3)
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=rtol, atol=rtol * scale,
                                   err_msg=n)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_model_grads_match_jax(geom, remat):
    jpre, params, tpre = _pair(geom, seed=1, remat=remat)
    x, cond, t, aux = _batch(2)
    rng = np.random.default_rng(3)
    w_out = rng.standard_normal((2, *RES, C)).astype(np.float32)
    w_lv = rng.standard_normal((2,)).astype(np.float32)

    def jloss_fn(p):
        out, lv = jpre.apply(p, x, t, condition=cond, auxiliary=aux, return_logvar=True)
        return jnp.sum(out * w_out) + jnp.sum(lv * w_lv)

    jl, jg = jax.value_and_grad(jloss_fn)(params)
    out, lv = tpre(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                   torch.from_numpy(aux), return_logvar=True)
    loss = (out * torch.from_numpy(w_out)).sum() + (lv * torch.from_numpy(w_lv)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_grads(tpre, _grads_by_name(jg))


def test_remat_changes_no_value():
    """Bit for bit except the conditioning path, whose gradient the
    recomputed pair returns as one sum: 1e-6 of max|grad| (fp32 rounding)."""
    grads = []
    for remat in (True, False):
        _, _, tpre = _pair("d12", seed=4, remat=remat)
        x, cond, t, aux = _batch(5)
        out, lv = tpre(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                       torch.from_numpy(aux), return_logvar=True)
        (out.square().sum() + lv.sum()).backward()
        grads.append({n: p.grad.clone() for n, p in tpre.named_parameters()})
    for n in grads[0]:
        scale = grads[1][n].abs().max().item()
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=0, atol=1e-6 * scale, msg=n)
        if "transformer" in n:
            assert torch.equal(grads[0][n], grads[1][n]), n


def _jax_draws(key, B):
    """The JAX TrigFlowLoss's (t, z) for ``key``."""
    k_tau, k_z = jax.random.split(key)
    tau = jloss.loguniform(k_tau, B, NOISE["sigma_min"], NOISE["sigma_max"])
    t = jnp.arctan(tau / 1.0)
    z = jax.random.normal(k_z, (B, *RES, C))
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))


def _losses(jpre):
    j = jloss.TrigFlowLoss(precond=jpre, lat_dim=RES[0], variables=tuple(VARS),
                           noise=dict(NOISE), sigma_data=1.0)
    ds = SimpleNamespace(img_resolution=RES, variables=VARS)
    t = factory.build_loss({"_target_": "swift.training.loss.TrigFlowLoss", "noise": NOISE,
                            "sigma_data": 1.0}, ds)
    return j, t


def test_trigflow_loss_matches_jax():
    jpre, params, tpre = _pair("d16", seed=6)
    x, cond, _, aux = _batch(7)
    key = jax.random.PRNGKey(8)
    jl, tl = _losses(jpre)
    jval, jg = jax.value_and_grad(
        lambda p: jl(p, key, jnp.asarray(x), condition=jnp.asarray(cond), auxiliary=aux))(params)
    t, z = _jax_draws(key, 2)
    val = tl.value(tpre, torch.from_numpy(x), t, z, torch.from_numpy(cond),
                   torch.from_numpy(aux))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    _assert_grads(tpre, _grads_by_name(jg))


def test_trigflow_draws_in_range():
    tl = _losses(_pair("d16")[0])[1]
    t, z = tl.draw(torch.zeros(64, *RES, C), torch.Generator().manual_seed(0))
    assert t.shape == (64, 1, 1, 1) and z.shape == (64, *RES, C)
    assert math.atan(0.02) <= t.min() and t.max() <= math.atan(200.0)


@pytest.mark.parametrize("cfg", [
    dict(lr_rampup_kimg=2, total_kimg=10, lr_min_factor=0.01, lr_cosine_anneal=True),
    dict(lr_rampup_kimg=2, total_kimg=10, lr_min_factor=0.1, lr_cosine_anneal=False),
    dict(lr_rampup_kimg=0, total_kimg=10, lr_min_factor=0.01, lr_cosine_anneal=False),
    dict(lr_rampup_kimg=2, total_kimg=10, lr_min_factor=0.01, lr_cosine_anneal=True,
         resume_kimg=1),
], ids=["cosine", "hold", "flat", "resume"])
def test_lr_schedule_matches_jax(cfg):
    want = jtrainer.lr_schedule(5e-4, 48, **cfg)
    got = ttrainer.lr_schedule(48, **cfg)
    for count in (0, 1, 7, 41, 42, 100, 180, 250, 1000):
        np.testing.assert_allclose(got(count, 5e-4), float(want(count)), rtol=1e-6,
                                   err_msg=count)


def test_clamp_grads_matches_jax():
    g = np.array([[1.0, np.nan, np.inf], [-np.inf, -2.5, 3e6]], np.float32)
    p = torch.zeros(2, 3, requires_grad=True)
    p.grad = torch.from_numpy(g.copy())
    ttrainer.clamp_grads([p])
    want = jtrainer.clamp_grads({"a": jnp.asarray(g)})["a"]
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("rampup", [0.05, None], ids=["rampup", "norampup"])
def test_ema_update_matches_jax(rampup):
    rng = np.random.default_rng(9)
    e, p = rng.standard_normal((4, 5)).astype(np.float32), rng.standard_normal((4, 5)).astype(
        np.float32)
    want = jtrainer.ema_update({"a": jnp.asarray(e)}, {"a": jnp.asarray(p)}, 1000.0, 16.0, 0.5,
                               rampup)["a"]
    ema = {"a": torch.from_numpy(e.copy())}
    ttrainer.ema_update(ema, {"a": torch.from_numpy(p)}, 1000.0, 16.0, 0.5, rampup)
    np.testing.assert_allclose(ema["a"].numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_decay_mask_matches_jax():
    """The reference grouping, on JAX paths and on the port's names, picks
    the same parameters (unrolled layout: one mask entry per tensor)."""
    jpre, params, tpre = _pair("d16", scan_layers=False)
    jmask = convert.params_to_state_dict(jtrainer.adamw_decay_mask(params))
    tmask = ttrainer.adamw_decay_mask([n for n, _ in tpre.named_parameters()])
    assert sorted(tmask) == sorted(jmask)
    assert {n: bool(v) for n, v in jmask.items()} == tmask
    assert not all(tmask.values()) and any(tmask.values())


def test_one_train_step_matches_optax(tmp_path):
    """grads → clamp → AdamW (decay by the mask) → EMA, from the same
    params, batch and draws, with the reference AdamW config and weight
    decay 0.1 so the mask shows. The step is checked in its two halves:
    the gradients at the gradient tolerance, then the update on JAX's
    gradients at 1e-6 for every parameter. (AdamW's update g/(|g| + eps)
    turns a gradient's fp32 rounding into up to lr/eps times as much
    parameter change where |g| ≈ eps = 1e-6, so sharing the gradients is
    what holds every element of the update to 1e-6.)"""
    jpre, params, tpre = _pair("d12", seed=10)
    x, cond, _, aux = _batch(11)
    key = jax.random.PRNGKey(12)
    opt_cfg = {"_target_": "torch.optim.AdamW", "lr": 5e-4, "betas": [0.9, 0.95],
               "eps": 1e-6, "weight_decay": 0.1}
    tcfg = {"lr_rampup_kimg": 0, "total_kimg": 10, "lr_min_factor": 0.01,
            "lr_cosine_anneal": True}
    jl, tl = _losses(jpre)

    # JAX: the body of the JAX trainer's step_fn, from nimg = 1000
    jopt, _ = jfactory.build_optimizer(opt_cfg, tcfg, 2, params)
    jval, jg = jax.value_and_grad(
        lambda p: jl(p, key, jnp.asarray(x), condition=jnp.asarray(cond), auxiliary=aux))(params)
    jg = jtrainer.clamp_grads(jg)
    updates, _ = jopt.update(jg, jopt.init(params), params)
    jparams = optax.apply_updates(params, updates)
    jema = jtrainer.ema_update(params, jparams, 1000.0, 2.0, 500, 0.05)

    # the port's Trainer with the same draws
    opt, lr_fn = factory.build_optimizer(opt_cfg, tcfg, 2, tpre)
    t, z = _jax_draws(key, 2)
    fixed = lambda net, xx, c, a, gen: tl.value(net, xx, t, z, c, a)  # noqa: E731
    trainer = ttrainer.Trainer(tpre, opt, fixed, global_batch_size=2, lr_fn=lr_fn,
                               ema_halflife_kimg=500, ema_rampup_ratio=0.05,
                               run_dir=str(tmp_path))
    trainer.nimg = 1000.0
    loss = trainer.backward({"x": cond, "t": x, "delta": aux})
    np.testing.assert_allclose(float(loss), float(jval), rtol=1e-5)
    want_g = _grads_by_name(jg)
    _assert_grads(tpre, want_g)
    for n, p in tpre.named_parameters():
        p.grad = torch.from_numpy(np.array(want_g[n]))
    gnorm = trainer.update()
    np.testing.assert_allclose(float(gnorm), float(optax.global_norm(jg)), rtol=1e-6)
    want_p = convert.params_to_state_dict(jax.device_get(jparams))
    want_e = convert.params_to_state_dict(jax.device_get(jema))
    for n, p in tpre.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n], rtol=0, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(trainer.ema[n].numpy(), want_e[n], rtol=0, atol=1e-6,
                                   err_msg=n)
    assert trainer.nimg == 1002.0 and trainer.updates == 1


# -- the data path and the CLI --------------------------------------------------

E2E_VARS = ["2m_temperature", "sea_surface_temperature", "geopotential_500", "temperature_850"]


def test_sampler_and_loader_match_jax(tmp_path):
    """The port's copies of ERA5Dataset, InfiniteSampler and BatchLoader give
    the JAX package's batches, bit for bit, from the same files and seeds."""
    from swift_torch.data.era5 import ERA5Dataset
    from swift_torch.data.pipeline import BatchLoader
    from swift_torch.data.samplers import InfiniteSampler
    from swift_tpu.data.era5 import ERA5Dataset as JaxERA5Dataset
    from swift_tpu.data.pipeline import BatchLoader as JaxBatchLoader
    from swift_tpu.data.samplers import InfiniteSampler as JaxInfiniteSampler

    data = make_synthetic_era5(str(tmp_path / "data"), E2E_VARS, ["land_sea_mask"], n_train=14,
                               n_val=1, n_test=1)
    kw = dict(variables=E2E_VARS, forcings=["land_sea_mask"], residual=True, seed=3)
    ds, jds = ERA5Dataset(data, **kw), JaxERA5Dataset(data, **kw)
    jsampler = JaxInfiniteSampler(jds, shuffle=True, seed=5)
    it, jit_ = iter(InfiniteSampler(ds, seed=5)), iter(jsampler)
    assert [next(it) for _ in range(40)] == [next(jit_) for _ in range(40)]
    got = iter(BatchLoader(ds, InfiniteSampler(ds, seed=5), 3, num_workers=2))
    want = iter(JaxBatchLoader(jds, JaxInfiniteSampler(jds, shuffle=True, seed=5), 3,
                               num_workers=2, use_pack=False))
    for _ in range(4):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _jax_stats_keys() -> set:
    """The metric names the JAX trainer writes to stats.jsonl."""
    return set(re.findall(r'"(train/[\w/]+)"', inspect.getsource(jtrainer.Trainer.train)))


def test_train_cli_end_to_end(tmp_path, monkeypatch):
    data = make_synthetic_era5(str(tmp_path / "data"), E2E_VARS, ["land_sea_mask"], n_train=12,
                               n_val=2, n_test=8)
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RUN_ID", "run1")
    base = ["experiment=synthetic-tiny-scm", "loss=trigflow", "--device", "cpu"]
    # 5 steps of 4 images, a tick every 2 steps
    assert train.main(base + ["trainer.total_kimg=0.02", "trainer.kimg_per_tick=0.008"]) == 0
    run = tmp_path / "results" / "synthetic-tiny-scm" / "run1"
    lines = [json.loads(line) for line in (run / "stats.jsonl").read_text().splitlines()]
    assert len(lines) == 3  # ticks after steps 1, 3 and 5
    assert set(lines[-1]) == _jax_stats_keys()
    assert lines[-1]["train/iter"]["mean"] == 5 and np.isfinite(lines[-1]["train/loss"]["mean"])

    # the checkpoint loads in the JAX loader, to the port's weights
    ckpt = latest_checkpoint(str(run / "checkpoints"))
    params_sd, ema_sd, opt = load_training_state(ckpt)
    cfg = train.cfglib.load_config(run / ".hydra" / "config.yaml")
    jpre = jfactory.build_precond(cfg["precond"], cfg["model"], RES, len(E2E_VARS),
                                  len(E2E_VARS) + 1)
    init = jpre.init(jax.random.PRNGKey(0))
    restored = load_checkpoint_jax(ckpt, {"params": init, "ema": init})
    for tree, sd in ((restored["params"], params_sd), (restored["ema"], ema_sd)):
        back = convert.params_to_state_dict(jax.device_get(tree))
        assert sorted(back) == sorted(sd)
        for n in sd:
            np.testing.assert_array_equal(back[n], sd[n].numpy(), err_msg=n)
    assert not all(torch.equal(params_sd[n], ema_sd[n]) for n in sd)

    # a resume restores params, EMA and the AdamW state, then trains on
    monkeypatch.setenv("RUN_ID", "run2")
    trainer, loader, _ = train.setup(base + ["resume=run1", "trainer.total_kimg=0.028"])
    for n, p in trainer.net.named_parameters():
        assert torch.equal(p.detach(), params_sd[n]), n
        assert torch.equal(trainer.ema[n], ema_sd[n]), n
        state = trainer.optimizer.state[p]
        assert float(state["step"]) == 5.0, n
        np.testing.assert_array_equal(state["exp_avg"].numpy(), opt[f"{n}/exp_avg"], err_msg=n)
    trainer.train(loader)
    assert trainer.updates == 7
    assert latest_checkpoint(str(tmp_path / "results" / "synthetic-tiny-scm" / "run2"
                                 / "checkpoints"))

    # the checkpoint's EMA forecasts through swift_torch.generate
    ofile = generate.cli(["--input", str(run), "--members", "1", "--steps", "2", "--batch", "1",
                          "--samples", "1", "--segment", "1", "--device", "cpu"])
    fields = generate.read_store(ofile)
    assert sorted(fields) and all(np.isfinite(a).all() for a in fields.values())


def test_train_cli_scm_muon_end_to_end(tmp_path, monkeypatch):
    """The experiment's sCM loss with ``optimizer=muon`` winning over the
    experiment's ``override /optimizer: adamw``: trains, checkpoints, and a
    resume restores the Muon momentum and the aux-Adam moments."""
    data = make_synthetic_era5(str(tmp_path / "data"), E2E_VARS, ["land_sea_mask"], n_train=12,
                               n_val=2, n_test=2)
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RUN_ID", "run1")
    base = ["experiment=synthetic-tiny-scm", "optimizer=muon", "--device", "cpu"]
    # 4 steps of 4 images, a tick every 2 steps
    assert train.main(base + ["trainer.total_kimg=0.016", "trainer.kimg_per_tick=0.008"]) == 0
    run = tmp_path / "results" / "synthetic-tiny-scm" / "run1"
    lines = [json.loads(line) for line in (run / "stats.jsonl").read_text().splitlines()]
    assert lines[-1]["train/iter"]["mean"] == 4 and np.isfinite(lines[-1]["train/loss"]["mean"])
    _, _, opt = load_training_state(latest_checkpoint(str(run / "checkpoints")))

    monkeypatch.setenv("RUN_ID", "run2")
    trainer, loader, cfg = train.setup(base + ["resume=run1", "trainer.total_kimg=0.024"])
    assert cfg["loss"]["_target_"].endswith("SCMLoss")
    assert cfg["optimizer"]["_target_"].endswith("MuonWithAuxAdam")
    assert type(trainer.loss_fn) is tloss.SCMLoss
    assert type(trainer.optimizer) is MuonWithAuxAdam
    labels = ttrainer.muon_param_labels(trainer.net.named_parameters())
    for n, p in trainer.net.named_parameters():
        state = trainer.optimizer.state[p]
        key = "momentum_buffer" if labels[n] == "muon" else "exp_avg"
        np.testing.assert_array_equal(state[key].numpy(), opt[f"{n}/{key}"], err_msg=n)
    trainer.train(loader)
    assert trainer.updates == 6  # the checkpoint names kimg 0: the resume counts from there
    lrs = {g["kind"]: g["lr"] for g in trainer.optimizer.param_groups}
    np.testing.assert_allclose(lrs["adam"] / lrs["muon"], 3e-4 / 0.02, rtol=1e-9)


def test_default_experiment_builds_scm_and_muon():
    """``train`` with no overrides composes ``era5-swinv2-1.4-scm``; the
    factory builds its loss and optimizer (the optimizer over a small net:
    the grouping does not depend on the width)."""
    cfg = train.cfglib.compose("train", [])
    assert cfg["experiment_name"] == "era5-swinv2-1.4-scm"
    ds = SimpleNamespace(img_resolution=(128, 256),
                         variables=list(cfg["data"]["dataset"]["variables"]))
    loss = factory.build_loss(cfg["loss"], ds)
    assert type(loss) is tloss.SCMLoss
    assert loss.tangent_warmup_kimg == 3000 and loss.noise["sigma_max"] == 200
    model = {**cfg["model"], "dim": 32, "heads": 2, "depth": 2, "window_size": [2, 4],
             "shift_size": [1, 2]}
    net = factory.build_precond(cfg["precond"], model, RES, C, C + F_)
    opt, lr_fn = factory.build_optimizer(cfg["optimizer"], cfg["trainer"], 4, net)
    assert type(opt) is MuonWithAuxAdam
    groups = {g["kind"]: g for g in opt.param_groups}
    assert (groups["muon"]["base_lr"], groups["adam"]["base_lr"]) == (0.02, 3e-4)
    assert groups["adam"]["eps"] == 1e-10 and groups["adam"]["betas"] == (0.9, 0.95)
    assert len(groups["muon"]["params"]) == 6 * 2
    assert lr_fn(0, 0.02) == groups["muon"]["lr"] and lr_fn(0, 3e-4) == groups["adam"]["lr"]


def test_train_cli_needs_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["experiment=synthetic-tiny-scm", "loss=trigflow"])
