"""The port's EDM family against the JAX package, on the CPU in fp32.

* ``EDMPrecond`` on a tiny SwinV2 (weights carried across by
  ``convert.params_to_state_dict``) at a scalar σ (a sampler's) and at one
  σ a sample (the loss's), from σ 0.002 to 80: rtol 1e-4.
* ``EDMLoss`` with the JAX loss's (σ, n) draws fed in: the value at rtol
  1e-5, every gradient at ``test_torch_train``'s rtol 1e-4; its draws are
  lognormal σ and n = σ·ε.
* ``factory.build_precond`` and ``build_loss`` build the shipped
  ``era5-swinv2-1.4-edm`` experiment (EDMPrecond, EDMLoss, the edm solver,
  AdamW), and one ``Trainer`` step of it runs.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swift_tpu.training.loss as jloss
from swift_torch import config as cfglib
from swift_torch import factory
from swift_torch.models import convert
from swift_torch.models.precond import EDMPrecond as TorchEDMPrecond
from swift_torch.models.swinv2 import SwinV2 as TorchSwinV2
from swift_torch.training import loss as tloss
from swift_torch.training.trainer import Trainer
from swift_tpu.models.precond import EDMPrecond
from swift_tpu.models.swinv2 import SwinV2

RES, C, F_ = (8, 16), 3, 1
VARS = ["2m_temperature", "sea_surface_temperature", "geopotential_500"]
MODEL = dict(window_size=(2, 4), shift_size=(1, 2), patch_size=(2, 2), depth=2, dim=32,
             heads=2, auxiliary_dim=1)
NOISE = {"dist": "lognormal", "P_mean": -1.2, "P_std": 1.2}


def _pair(seed=0):
    kw = dict(img_resolution=RES, in_channels=2 * C + F_, out_channels=C, **MODEL)
    jpre = EDMPrecond(model=SwinV2(**kw, dtype=jnp.float32), img_resolution=RES, img_channels=C,
                      condition_channels=C + F_, auxiliary_dim=1, sigma_data=0.5)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32) + np.asarray(a),
        jpre.init(jax.random.PRNGKey(seed)))
    tpre = TorchEDMPrecond(TorchSwinV2(**kw, dtype=torch.float32), RES, C,
                           condition_channels=C + F_, auxiliary_dim=1, sigma_data=0.5)
    tpre.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.params_to_state_dict(params).items()})
    return jpre, params, tpre


def _batch(seed, B=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, *RES, C)).astype(np.float32)
    cond = rng.standard_normal((B, *RES, C + F_)).astype(np.float32)
    aux = rng.uniform(0.5, 2.5, (B, 1)).astype(np.float32)
    return x, cond, aux


@pytest.mark.parametrize("sigma", [0.002, 0.5, 80.0, "per-sample"])
def test_edm_precond_matches_jax(sigma):
    jpre, params, tpre = _pair(1)
    x, cond, aux = _batch(2)
    if sigma == "per-sample":
        sigma = np.array([0.01, 1.3, 40.0], np.float32)
    want = np.asarray(jpre.apply(params, x, jnp.asarray(sigma, jnp.float32), condition=cond,
                                 auxiliary=aux))
    with torch.no_grad():
        got = tpre(torch.from_numpy(x), torch.as_tensor(sigma, dtype=torch.float32),
                   torch.from_numpy(cond), torch.from_numpy(aux)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert tpre.round_sigma(0.3).item() == pytest.approx(0.3)


def _losses(jpre):
    j = jloss.EDMLoss(precond=jpre, lat_dim=RES[0], variables=tuple(VARS), noise=dict(NOISE),
                      sigma_data=0.5)
    ds = SimpleNamespace(img_resolution=RES, variables=VARS)
    t = factory.build_loss({"_target_": "swift.training.loss.EDMLoss", "noise": NOISE,
                            "sigma_data": 0.5}, ds)
    return j, t


def test_edm_loss_matches_jax():
    jpre, params, tpre = _pair(3)
    x, cond, aux = _batch(4)
    key = jax.random.PRNGKey(5)
    jl, tl = _losses(jpre)
    assert type(tl) is tloss.EDMLoss
    jval, jg = jax.value_and_grad(
        lambda p: jl(p, key, jnp.asarray(x), condition=jnp.asarray(cond), auxiliary=aux))(params)
    k_sigma, k_noise = jax.random.split(key)
    sigma = jloss.lognormal(k_sigma, 3, NOISE["P_mean"], NOISE["P_std"])
    n = jax.random.normal(k_noise, x.shape) * sigma
    val = tl.value(tpre, torch.from_numpy(x), torch.from_numpy(np.array(sigma)),
                   torch.from_numpy(np.array(n)), torch.from_numpy(cond), torch.from_numpy(aux))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    want = convert.params_to_state_dict(jax.device_get(jg))
    got = {name: p.grad for name, p in tpre.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        scale = max(float(np.abs(want[name]).max()), 1e-3)
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_edm_loss_draws():
    tl = _losses(_pair()[0])[1]
    x = torch.zeros(4096, 1, 1, 1)
    sigma, n = tl.draw(x, torch.Generator().manual_seed(0))
    assert sigma.shape == (4096, 1, 1, 1) and n.shape == x.shape
    np.testing.assert_allclose(torch.log(sigma).mean().item(), NOISE["P_mean"], atol=0.06)
    np.testing.assert_allclose(torch.log(sigma).std().item(), NOISE["P_std"], atol=0.06)
    np.testing.assert_allclose((n / sigma).std().item(), 1.0, atol=0.05)


def test_edm_experiment_builds_and_trains(tmp_path):
    """The shipped experiment's precond, loss and solver, cut to a tiny
    width: one AdamW step through the Trainer moves every parameter."""
    cfg = cfglib.compose("train", ["experiment=era5-swinv2-1.4-edm"])
    assert cfg["solver"]["S_churn"] == 2.5 and cfg["loss"]["noise"]["dist"] == "lognormal"
    ds = SimpleNamespace(img_resolution=RES, variables=VARS)
    model = {**cfg["model"], "dim": 32, "heads": 2, "depth": 2, "window_size": [2, 4],
             "shift_size": [1, 2]}
    net = factory.build_precond(cfg["precond"], model, RES, C, C + F_, dtype=torch.float32)
    loss = factory.build_loss(cfg["loss"], ds)
    assert type(net) is TorchEDMPrecond and type(loss) is tloss.EDMLoss
    assert (net.sigma_data, net.sigma_min, net.sigma_max) == (0.5, 0.0, float("inf"))
    assert loss.sigma_data == 0.5
    opt, lr_fn = factory.build_optimizer(cfg["optimizer"], {**cfg["trainer"], "lr_rampup_kimg": 0},
                                         2, net)
    trainer = Trainer(net, opt, loss, global_batch_size=2, lr_fn=lr_fn, total_kimg=0.002,
                      kimg_per_tick=0.002, checkpoint_ticks=None, run_dir=str(tmp_path), seed=0)
    assert trainer.solver_type == "edm"
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    x, cond, aux = _batch(6, B=2)
    out = trainer.step({"x": cond, "t": x, "delta": aux})
    assert np.isfinite(float(out["loss"])) and np.isfinite(float(out["grad_norm"]))
    assert all(not torch.equal(p.detach(), before[k]) for k, p in net.named_parameters())
