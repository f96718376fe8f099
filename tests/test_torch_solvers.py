"""The port's solvers against the JAX package's, on the CPU in fp32.

* Each of the five solvers of ``_SOLVERS`` (and ``scm_solve2``) on an
  analytic net, with the same latents and, where a solver draws noise, the
  JAX package's draws (``jax.random.split(key, n)``, one normal a step)
  handed to the port as ``noise=``: ``ablation_sampler`` over every
  discretization × schedule × scaling, Euler and Heun (with churn where
  the schedule allows it); ``dpm_solver`` with and without ``use_pp``;
  ``dpm_solver_2s``; ``edm_sampler`` with edm.yaml's churn; ``scm_solver``
  and ``scm_solve2``.
* ``dpm_solver`` through a tiny SwinV2 under ``PassPrecond`` and
  ``edm_sampler`` through one under ``EDMPrecond``, their weights carried
  across by ``convert.params_to_state_dict``.
* ``sampler_factory``'s keys equal the JAX package's, and so do
  ``generate --solver``'s choices.

Tolerance: rtol 1e-4 (atol 1e-4 of the largest value), as the port's
rollout tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swift_tpu.generate as jgenerate
import swift_tpu.sampling.factory as jfactory
import swift_tpu.sampling.solvers as jsolvers
from swift_torch import generate
from swift_torch.models import convert
from swift_torch.models.precond import EDMPrecond as TorchEDMPrecond
from swift_torch.models.precond import PassPrecond as TorchPassPrecond
from swift_torch.models.swinv2 import SwinV2 as TorchSwinV2
from swift_torch.sampling import factory as tfactory
from swift_torch.sampling import solvers as tsolvers
from swift_tpu.models.precond import EDMPrecond, Network, PassPrecond
from swift_tpu.models.swinv2 import SwinV2

SHAPE = (2, 4, 8, 3)  # B, H, W, C
RTOL = 1e-4


@dataclasses.dataclass
class Toy:
    """An analytic net(x, t, condition, auxiliary) with the metadata the
    solvers read; ``lib`` is jnp or torch."""

    lib: object
    sigma_data: float = 1.0
    sigma_min: float = 0.0
    sigma_max: float = float("inf")
    img_channels: int = SHAPE[3]
    img_resolution: tuple = SHAPE[1:3]

    def __call__(self, x, t, condition=None, auxiliary=None):
        L = self.lib
        t = L.abs(t)
        out = L.tanh(0.7 * x) * (0.6 / (1.0 + t)) + 0.3 * L.sin(t) * x
        if condition is not None:
            out = out + 0.2 * L.cos(condition) / (1.0 + t)
        if auxiliary is not None:
            out = out + 0.05 * auxiliary
        return out


def _data(seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal(SHAPE).astype(np.float32)
    cond = rng.standard_normal(SHAPE).astype(np.float32)
    return lat, cond


def _jax_noise(key, n, shape=SHAPE):
    """The JAX solvers' draws: normal(split(key, n)[i], shape)."""
    return [torch.from_numpy(np.array(jax.random.normal(k, shape)))
            for k in jax.random.split(key, n)]


def _close(got, want):
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _run(name, n_noise=None, net_kw=None, **kw):
    """(port, JAX) outputs of solver ``name`` on the toy net."""
    lat, cond = _data()
    key = jax.random.PRNGKey(3)
    jnet, tnet = Toy(jnp, **(net_kw or {})), Toy(torch, **(net_kw or {}))
    want = getattr(jsolvers, name)(jnet, jnp.asarray(lat), jnp.asarray(cond), 0.6, key=key, **kw)
    extra = {"noise": _jax_noise(key, n_noise)} if n_noise else {}
    got = getattr(tsolvers, name)(tnet, torch.from_numpy(lat), torch.from_numpy(cond), 0.6,
                                  **extra, **kw)
    return got, want


ABLATION = [(d, s, sc) for d in ("vp", "ve", "iddpm", "edm") for s in ("vp", "ve", "linear")
            for sc in ("vp", "none")]


@pytest.mark.parametrize("solver", ["euler", "heun"])
@pytest.mark.parametrize("disc,schedule,scaling", ABLATION,
                         ids=["-".join(c) for c in ABLATION])
def test_ablation_sampler_matches_jax(disc, schedule, scaling, solver):
    churn = dict(S_churn=1.0, S_noise=1.02) if schedule == "linear" else {}
    got, want = _run("ablation_sampler", n_noise=6, num_steps=6, solver=solver,
                     discretization=disc, schedule=schedule, scaling=scaling, **churn)
    _close(got, want)


@pytest.mark.parametrize("use_pp", [True, False], ids=["pp", "plain"])
def test_dpm_solver_matches_jax(use_pp):
    got, want = _run("dpm_solver", num_steps=20, use_pp=use_pp, sigma_min=0.02,
                     sigma_max=200.0)
    _close(got, want)


def test_dpm_solver_2s_matches_jax():
    got, want = _run("dpm_solver_2s", num_steps=8, sigma_min=0.02, sigma_max=200.0)
    _close(got, want)


@pytest.mark.parametrize("churn", [0.0, 2.5], ids=["no-churn", "edm-yaml-churn"])
def test_edm_sampler_matches_jax(churn):
    """edm.yaml's settings (σ 0.03–80, S_churn 2.5 from σ 0.75 to 80,
    S_noise 1.05), the net's range narrower than the solver's."""
    got, want = _run("edm_sampler", n_noise=20, net_kw=dict(sigma_data=0.5, sigma_max=60.0),
                     num_steps=20, sigma_min=0.03, sigma_max=80.0, rho=7, S_churn=churn,
                     S_min=0.75, S_max=80, S_noise=1.05)
    _close(got, want)


@pytest.mark.parametrize("steps,intermediates", [(1, None), (2, None), (3, [1.2, 0.7])],
                         ids=["1", "2", "3-intermediates"])
def test_scm_solvers_match_jax(steps, intermediates):
    n = steps if intermediates is None else len(intermediates) + 1
    noise = _jax_noise(jax.random.PRNGKey(3), n)
    lat, cond = _data(1)
    jnet, tnet = Toy(jnp), Toy(torch)
    kw = dict(num_steps=steps, intermediates=intermediates, sigma_min=0.02, sigma_max=200.0)
    key = jax.random.PRNGKey(3)
    want = jsolvers.scm_solver(jnet, jnp.asarray(lat), jnp.asarray(cond), 0.6, key=key, **kw)
    got = tsolvers.scm_solver(tnet, torch.from_numpy(lat), torch.from_numpy(cond), 0.6,
                              noise=noise[1:], **kw)
    _close(got, want)
    want = jsolvers.scm_solve2(jnet, jnp.asarray(lat), jnp.asarray(cond), 0.6, key=key, **kw)
    got = tsolvers.scm_solve2(tnet, torch.from_numpy(lat), torch.from_numpy(cond), 0.6,
                              noise=noise, **kw)
    _close(got, want)


def test_solvers_draw_from_the_generator():
    """Without ``noise`` the stochastic solvers draw from the generator: the
    same seed gives the same sample, another seed another."""
    lat, cond = _data(2)
    net = Toy(torch)

    def run(seed):
        return tsolvers.edm_sampler(net, torch.from_numpy(lat), torch.from_numpy(cond),
                                    generator=torch.Generator().manual_seed(seed),
                                    num_steps=5, S_churn=2.0)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_solver_keys_and_generate_choices_match_jax():
    assert list(tfactory._SOLVERS) == list(jfactory._SOLVERS)
    choices = {a.dest: a.choices for a in generate.parser._actions}["solver"]
    jchoices = {a.dest: a.choices for a in jgenerate.parser._actions}["solver"]
    assert choices == jchoices
    with pytest.raises(ValueError, match="Unknown solver mode"):
        tfactory.sampler_factory("heun", Toy(torch))


# -- through a tiny SwinV2 ------------------------------------------------------

RES, C, F_ = (8, 16), 3, 1
MODEL = dict(window_size=(2, 4), shift_size=(1, 2), patch_size=(2, 2), depth=2, dim=32,
             heads=2, auxiliary_dim=1)


def _nets(precond: str, sigma_data: float):
    """(JAX Network, torch precond) over one tiny SwinV2's weights."""
    kw = dict(img_resolution=RES, in_channels=2 * C + F_, out_channels=C, **MODEL)
    jcls, tcls = {"pass": (PassPrecond, TorchPassPrecond),
                  "edm": (EDMPrecond, TorchEDMPrecond)}[precond]
    jpre = jcls(model=SwinV2(**kw, dtype=jnp.float32), img_resolution=RES, img_channels=C,
                condition_channels=C + F_, auxiliary_dim=1, sigma_data=sigma_data)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32) + np.asarray(a),
        jpre.init(jax.random.PRNGKey(0)))
    tpre = tcls(TorchSwinV2(**kw, dtype=torch.float32), RES, C, condition_channels=C + F_,
                auxiliary_dim=1, sigma_data=sigma_data)
    tpre.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.params_to_state_dict(params).items()})
    return Network(jpre, params), tpre.eval()


@pytest.mark.parametrize("mode", ["dpm", "edm"])
def test_solvers_through_swinv2_match_jax(mode):
    """The factory's samplers with the JAX latents: ``dpm`` (dpm.yaml, 8
    steps, use_pp) under PassPrecond, ``edm`` (edm.yaml's churn, 20 steps)
    under EDMPrecond with the JAX draws as noise."""
    jnet, tnet = _nets("pass" if mode == "dpm" else "edm", 1.0 if mode == "dpm" else 0.5)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((2, *RES, C + F_)).astype(np.float32)
    kw = (dict(num_steps=8, sigma_min=0.02, sigma_max=200.0, rho=7, use_pp=True)
          if mode == "dpm" else
          dict(num_steps=20, sigma_min=0.03, sigma_max=80.0, rho=7, S_churn=2.5, S_min=0.75,
               S_max=80, S_noise=1.05))
    key = jax.random.PRNGKey(5)
    jsampler = jfactory.sampler_factory(mode, jnet, auxiliary=0.6, **kw)
    want = jsampler(jnp.asarray(X), key)
    lat_key, solve_key = jax.random.split(key)
    latents = torch.from_numpy(np.array(jax.random.normal(lat_key, (2, *RES, C))))
    if mode == "edm":
        kw["noise"] = _jax_noise(solve_key, 20, (2, *RES, C))
    tsampler = tfactory.sampler_factory(mode, tnet, auxiliary=0.6, **kw)
    with torch.no_grad():
        got = tsampler(torch.from_numpy(X), latents=latents)
    _close(got, want)
