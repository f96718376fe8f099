"""The port's rollout and validation against the JAX package, on the CPU.

* ``ERA5RollOutDataset`` items bit for bit against the JAX dataset's on
  ``make_synthetic_era5`` data with a val split, and the in-memory
  ``SyntheticERA5RollOut`` built from the same ``ERA5RollOutDataset``
  methods.
* ``forecast_rollout``, ``RMSE_rollout`` and ``CRPS_rollout`` through a
  tiny fp32 SwinV2 with the ``dpm`` solver against the JAX functions, the
  JAX latents handed to the port's sampler: rtol 1e-4.
* ``swift_torch.train`` for one tick with ``trainer.val_ticks=1`` and
  ``val_crps_members=2``: ``val_stats.jsonl`` carries the JAX trainer's key
  set (its ``_val_step`` run on the same config and data), finite; the
  trained weights are untouched by the validation, and the net is back in
  train mode. Without a val split, validation is disabled with a log line.
* ``python -m swift_torch.training.validate`` and ``python -m
  swift_torch.eval.sampler`` on that run; the sweep's
  ``sampler_results.csv`` has the JAX sweep's columns on the same run.
"""

import io
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import swift_tpu.eval.sampler as jsweep
import swift_tpu.factory as jfactory
from swift_torch import factory, train
from swift_torch.data.era5 import ERA5RollOutDataset
from swift_torch.data.standardize import Standardizer
from swift_torch.data.synthetic import SyntheticERA5RollOut
from swift_torch.eval import sampler as tsweep
from swift_torch.models import convert
from swift_torch.sampling.factory import sampler_factory
from swift_torch.sampling.rollout import forecast_rollout
from swift_torch.training import validate as tvalidate
from swift_torch.training.trainer import Trainer
from swift_tpu.data.era5 import ERA5RollOutDataset as JaxERA5RollOutDataset
from swift_tpu.data.standardize import Standardizer as JaxStandardizer
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.sampling.factory import param_sampler_factory
from swift_tpu.sampling.rollout import forecast_rollout as jax_forecast_rollout
from swift_tpu.training import validate as jvalidate
from swift_tpu.training.loss import TrigFlowLoss as JaxTrigFlowLoss
from swift_tpu.training.trainer import Trainer as JaxTrainer

VARS = ["2m_temperature", "sea_surface_temperature", "geopotential_500", "temperature_850"]
FORC = ["land_sea_mask"]
RES, C = (8, 16), len(VARS)
MODEL = {"_target_": "swift_tpu.models.swinv2.SwinV2", "window_size": [2, 2],
         "shift_size": [1, 1], "patch_size": [2, 2], "depth": 2, "dim": 32, "heads": 2}
PRECOND = {"_target_": "swift_tpu.models.precond.PassPrecond", "auxiliary_dim": 1,
           "sigma_data": 1.0}
SOLVER = dict(num_steps=3, sigma_min=0.02, sigma_max=200.0, use_pp=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synthetic_era5(str(tmp_path_factory.mktemp("validate") / "data"), VARS, FORC,
                               n_train=12, n_val=14, n_test=10, shape=RES, seed=0)


@pytest.fixture(scope="module")
def nets(data):
    """(JAX precond, params, the port's precond with the same weights)."""
    jpre = jfactory.build_precond(PRECOND, MODEL, RES, C, C + len(FORC), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        jpre.init(jax.random.PRNGKey(0)))
    tpre = factory.build_precond(PRECOND, MODEL, RES, C, C + len(FORC), dtype=torch.float32)
    tpre.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.params_to_state_dict(params).items()})
    return jpre, params, tpre.eval()


def _datasets(data, interval, split="val"):
    kw = dict(root=data, variables=VARS, forcings=FORC, residual=True, split=split)
    return JaxERA5RollOutDataset(interval, **kw), ERA5RollOutDataset(interval, **kw)


def test_rollout_dataset_items_match_jax(data):
    jds, ds = _datasets(data, 8)
    assert len(ds) == len(jds) == 14 - 8
    for i in range(len(ds)):
        (x, t, idx), (jx, jt, jidx) = ds[i], jds[i]
        assert idx == jidx
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(t, np.asarray(jt))
        assert t.shape == (8 // 4 + 1, *RES, C)
    built = factory.build_rollout_dataset(
        {"dataset": {"root": data, "variables": VARS, "forcings": FORC, "residual": True}}, 8)
    assert type(built) is ERA5RollOutDataset and built.interval == 8 and built.split == "val"
    syn = SyntheticERA5RollOut(4, VARS, FORC, n_files=9)
    x, t, idx = syn[2]
    assert len(syn) == 5 and idx == 2 and t.shape == (2, 8, 16, C)
    np.testing.assert_array_equal(t[1], syn._load_file(6, VARS))


def _latents(key, steps, shape):
    """The JAX rollouts' latents: step s samples from split(split(key,
    steps)[s])[0]."""
    return [torch.from_numpy(np.array(jax.random.normal(jax.random.split(k)[0], shape)))
            for k in jax.random.split(key, steps)]


def _replay(tpre, latents):
    """The port's dpm sampler, handed ``latents`` in turn (cycling)."""
    sampler = sampler_factory("dpm", tpre, auxiliary=0.6, **SOLVER)
    state = {"s": 0}

    def call(cond, generator, auxiliary=None):
        lat = latents[state["s"] % len(latents)]
        state["s"] += 1
        return sampler(cond, generator, auxiliary, latents=lat)

    return call


def _close(got, want):
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_forecast_rollout_matches_jax(data, nets):
    jpre, params, tpre = nets
    jds, ds = _datasets(data, 4, split="test")
    steps, key = 3, jax.random.PRNGKey(7)
    X0 = np.stack([ds[i][0] for i in (0, 2)])
    forc = np.random.default_rng(3).standard_normal((2, steps, *RES, 1)).astype(np.float32)
    jsampler = param_sampler_factory("dpm", jpre, auxiliary=0.6, **SOLVER)
    want = jax_forecast_rollout(jsampler, params, JaxStandardizer.from_dataset(jds),
                                jnp.asarray(X0), jnp.asarray(forc), key, steps)
    got = forecast_rollout(_replay(tpre, _latents(key, steps, (2, *RES, C))),
                           Standardizer.from_dataset(ds), torch.from_numpy(X0),
                           torch.from_numpy(forc), None, steps)
    assert got.shape == (2, steps + 1, *RES, C)
    _close(got, want)


def _batches(ds, B=2, n=2):
    out = []
    for b in range(n):
        items = [ds[b * B + i] for i in range(B)]
        out.append((np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
                    np.asarray([it[2] for it in items])))
    return out


@pytest.mark.parametrize("score", ["rmse", "crps"])
def test_rollout_scores_match_jax(data, nets, score):
    """Two batches of two initial conditions over 8 steps (two days); CRPS
    with 3 members."""
    jpre, params, tpre = nets
    jds, ds = _datasets(data, 8)
    key, M = jax.random.PRNGKey(9), 3
    jsampler = param_sampler_factory("dpm", jpre, auxiliary=0.6, **SOLVER)
    if score == "rmse":
        want = jvalidate.RMSE_rollout(jsampler, params, iter(_batches(jds)), jds, 8, key)
        got = tvalidate.RMSE_rollout(_replay(tpre, _latents(key, 8, (2, *RES, C))),
                                     iter(_batches(ds)), ds, 8, device="cpu")
    else:
        want = jvalidate.CRPS_rollout(jsampler, params, iter(_batches(jds)), jds, 8, key,
                                      members=M)
        got = tvalidate.CRPS_rollout(_replay(tpre, _latents(key, 8, (M * 2, *RES, C))),
                                     iter(_batches(ds)), ds, 8, members=M, device="cpu")
    assert got[1].shape == (C, 3)
    _close(got[0], want[0])
    _close(got[1], want[1])


def _jax_val_keys(data, val_variables):
    """The keys of the JAX trainer's val_stats.jsonl line for this data."""
    jpre = jfactory.build_precond(PRECOND, {**MODEL, "logvar": True}, RES, C, C + len(FORC),
                                  dtype=jnp.float32)
    loss = JaxTrigFlowLoss(precond=jpre, lat_dim=RES[0], variables=tuple(VARS),
                           noise={"dist": "loguniform", "sigma_min": 0.02, "sigma_max": 200.0})
    jtrainer = JaxTrainer(jpre, optax.adamw(1e-3), loss, global_batch_size=4, val_ticks=1,
                          val_target_interval=4, val_variables=val_variables,
                          val_crps_members=2,
                          solver_kwargs={"num_steps": 1, "sigma_min": 0.02, "sigma_max": 200.0,
                                         "auxiliary": 0.6},
                          run_dir=str(data) + "_jax_run")
    jds, _ = _datasets(data, 4)

    def val_batches():
        while True:
            yield _batches(jds, n=1)[0]

    out = io.StringIO()
    jtrainer._val_step(val_batches, jds, 0, 4, out)
    return set(json.loads(out.getvalue()))


def test_train_validates_online_with_jax_keys(data, tmp_path, monkeypatch):
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RUN_ID", "val")
    argv = ["experiment=synthetic-tiny-scm", "loss=trigflow", "trainer.total_kimg=0.008",
            "trainer.kimg_per_tick=0.004", "trainer.val_ticks=1", "trainer.val_target_interval=4",
            "trainer.val_crps_members=2", "--device", "cpu"]
    trainer, loader, cfg = train.setup(argv)
    assert trainer.solver_type == "dpm" and trainer.solver_kwargs["num_steps"] == 1
    val_batches, val_ds = train.validation(cfg, trainer.seed)
    assert isinstance(val_ds, ERA5RollOutDataset) and val_ds.interval == 4

    calls = []
    step = trainer._val_step

    def spy(*args):
        weights = {n: p.detach().clone() for n, p in trainer.net.named_parameters()}
        out = step(*args)
        assert trainer.net.training, "train mode restored"
        for n, p in trainer.net.named_parameters():
            assert torch.equal(p.detach(), weights[n]), n
        calls.append(out)
        return out

    trainer._val_step = spy
    trainer.train(loader, val_batches, val_ds)
    run = tmp_path / "results" / "synthetic-tiny-scm" / "val"
    lines = [json.loads(line) for line in (run / "val_stats.jsonl").read_text().splitlines()]
    assert len(lines) == len(calls) == 2  # ticks 0 and 1
    assert set(lines[0]) == _jax_val_keys(data, cfg["trainer"]["val_variables"])
    assert lines[1]["val/tick"] == 1 and lines[1]["train/kimg"] == 0
    for line in lines:
        for k, v in line.items():
            assert np.isfinite(v).all(), k
    assert len(lines[0]["val/crps/2m_temperature"]) == 2
    # EMA and trained weights differ, so validation ran on the EMA's
    assert any(not torch.equal(trainer.ema[n], p.detach())
               for n, p in trainer.net.named_parameters())

    # the offline CLIs on the run: the RMSE, and the sweep's columns against JAX's
    agg, arr = tvalidate.main(["--input", str(run), "--batch", "2", "--samples", "2",
                               "--target_interval", "4", "--device", "cpu"])
    assert np.isfinite(agg) and arr.shape == (C, 2)
    sweep_argv = ["--input", str(run), "--samples", "3", "--batch", "2", "--num-steps", "2", "1"]
    jsweep.main(sweep_argv)
    csv = run / "output" / "sampler_results.csv"
    jrows = csv.read_text().splitlines()
    rows = tsweep.main(sweep_argv + ["--device", "cpu"])
    got = csv.read_text().splitlines()
    assert got[0] == jrows[0] and len(got) == len(jrows) == 3
    assert [r["num_steps"] for r in rows] == [2, 1]
    assert all(np.isfinite(r["overall_error"]) for r in rows)


def test_validation_disabled_without_a_val_split(tmp_path, capsys):
    root = make_synthetic_era5(str(tmp_path / "data"), VARS, FORC, n_train=6, n_val=0,
                               n_test=0)
    cfg = {"trainer": {"val_ticks": 1, "val_target_interval": 4},
           "data": {"dataset": {"root": root, "variables": VARS, "forcings": FORC}}}
    assert train.validation(cfg, 0) == (None, None)
    assert train.validation({**cfg, "trainer": {"val_ticks": None}}, 0) == (None, None)


def test_trainer_validation_needs_no_cuda_on_cpu_nets():
    """``_val_step`` evaluates on the trainer's device: a CPU net stays on
    the CPU (the rollout's tensors follow it)."""
    net = factory.build_precond(PRECOND, {**MODEL, "logvar": True}, RES, C, C + len(FORC),
                                dtype=torch.float32)
    loss = factory.build_loss({"_target_": "TrigFlowLoss", "noise": {
        "dist": "loguniform", "sigma_min": 0.02, "sigma_max": 200.0}},
        SimpleNamespace(img_resolution=RES, variables=VARS))
    opt, lr_fn = factory.build_optimizer({"_target_": "AdamW"}, {}, 2, net)
    trainer = Trainer(net, opt, loss, global_batch_size=2, lr_fn=lr_fn, val_ticks=1,
                      val_target_interval=4, solver_kwargs={"num_steps": 2})
    syn = SyntheticERA5RollOut(4, VARS, FORC, n_files=8)

    def val_batches():
        while True:
            yield _batches(syn, n=1)[0]

    out = trainer._val_step(val_batches, syn, 3, 8000, None)
    assert out["val/tick"] == 3 and out["train/kimg"] == 8 and np.isfinite(out["val/rmse"])
    assert "val/crps" not in out and trainer.device.type == "cpu"


def test_new_modules_import_no_jax():
    """The solvers, rollout, validation, sweep and EDM modules, driven on the
    CPU (an EDM sample, a validation step), load no module of jax, flax,
    optax or swift_tpu."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import sys, torch
from swift_torch import factory, train
from swift_torch.eval import sampler
from swift_torch.sampling import rollout, solvers
from swift_torch.training import validate
from swift_torch.data.synthetic import SyntheticERA5RollOut
from swift_torch.sampling.factory import sampler_factory
ds = SyntheticERA5RollOut(4, %r, ["land_sea_mask"], n_files=8)
net = factory.build_precond({"_target_": "EDMPrecond", "auxiliary_dim": 1, "sigma_data": 0.5},
                            %r, ds.img_resolution, ds.n_target_channels,
                            ds.n_condition_channels, dtype=torch.float32).eval()
s = sampler_factory("edm", net, num_steps=3, S_churn=1.0)
agg, arr = validate.RMSE_rollout(s, train.rollout_batches(ds, 2, 0)(), ds, 4, num_batches=1,
                                 device="cpu")
assert arr.shape == (%d, 2)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "swift_tpu"))
assert not bad, bad
print("no-jax-ok")
""" % (VARS, MODEL, C)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0 and "no-jax-ok" in res.stdout, res.stdout + res.stderr
