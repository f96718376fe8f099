"""swift_torch's SwinV2, PassPrecond, converter and sCM solver against the
JAX package, on the CPU in fp32 at a tiny size.

The same numpy weights (a JAX init made non-trivial with seeded normals)
and the same numpy inputs go through both; jax.random and torch.Generator
differ, so every random number a solver needs is handed to both sides.
Tolerances: 1e-5 for the converter (exact copies), rtol 1e-4 / atol 1e-5
for model outputs (fp32 through 2 blocks; XLA and PyTorch sum matmuls and
reductions in different orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift_torch.models import convert
from swift_torch.models.precond import PassPrecond as TorchPassPrecond
from swift_torch.models.swinv2 import SwinV2 as TorchSwinV2
from swift_torch.sampling.solvers import scm_solver as torch_scm_solver
from swift_tpu.models.convert import swinv2_params_to_state_dict
from swift_tpu.models.precond import Network, PassPrecond
from swift_tpu.models.swinv2 import SwinV2
from swift_tpu.sampling.solvers import scm_solver

RES, C, F_ = (8, 16), 3, 1
GEOMS = {
    "d16": dict(dim=32, heads=2),
    "d12": dict(dim=32, heads=2, head_dim=12),  # d not a power of two
}
COMMON = dict(window_size=(2, 4), shift_size=(1, 2), patch_size=(2, 2), depth=2,
              auxiliary_dim=1, logvar=True)
RTOL, ATOL = 1e-4, 1e-5


def _randomize(params, seed):
    """Seeded non-zero values for every leaf (modulation and head are
    zero-initialised, which would hide most of the block)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32) + np.asarray(a),
        params)


def _pair(geom, seed=0, scan_layers=True):
    """(JAX PassPrecond, params, torch PassPrecond with the same weights)."""
    kw = dict(img_resolution=RES, in_channels=2 * C + F_, out_channels=C, **COMMON,
              **GEOMS[geom])
    jmodel = SwinV2(**kw, dtype=jnp.float32, scan_layers=scan_layers)
    jpre = PassPrecond(model=jmodel, img_resolution=RES, img_channels=C,
                       condition_channels=C + F_, auxiliary_dim=1)
    params = _randomize(jpre.init(jax.random.PRNGKey(seed)), seed)
    tpre = TorchPassPrecond(TorchSwinV2(**kw, dtype=torch.float32), RES, C,
                            condition_channels=C + F_, auxiliary_dim=1)
    sd = convert.params_to_state_dict(params)
    tpre.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jpre, params, tpre.eval()


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, *RES, C)).astype(np.float32)
    cond = rng.standard_normal((B, *RES, C + F_)).astype(np.float32)
    t = rng.uniform(0.1, 1.5, (B,)).astype(np.float32)
    aux = rng.uniform(0.5, 2.5, (B, 1)).astype(np.float32)
    return x, cond, t, aux


@pytest.mark.parametrize("scan_layers", [True, False], ids=["pairs", "blocks"])
def test_converter_matches_jax(scan_layers):
    jpre, params, _ = _pair("d12", seed=1, scan_layers=scan_layers)
    want = swinv2_params_to_state_dict(params)
    got = convert.params_to_state_dict(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    # and back: the port's inverse restores the JAX tree in either layout
    back = convert.state_dict_to_params(got, depth=COMMON["depth"], scan_layers=scan_layers)
    flat_b, flat_p = convert.flatten(back), convert.flatten(jax.device_get(params))
    assert sorted(flat_b) == sorted(flat_p)
    for k in flat_p:
        np.testing.assert_allclose(flat_b[k], flat_p[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_swinv2_forward_matches_jax(geom):
    jpre, params, tpre = _pair(geom, seed=2)
    x, cond, t, aux = _inputs(3)
    arg = np.concatenate([x, cond], -1)
    jo, jlv = jpre.model.apply({"params": params}, arg, t, auxiliary=aux, return_logvar=True)
    with torch.no_grad():
        to, tlv = tpre.model(torch.from_numpy(arg), torch.from_numpy(t),
                             torch.from_numpy(aux), return_logvar=True)
    assert to.dtype == torch.float32 and to.shape == (2, *RES, C)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), rtol=RTOL, atol=ATOL)


def test_precond_forward_matches_jax():
    jpre, params, tpre = _pair("d16", seed=4)
    x, cond, t, _ = _inputs(5)
    want = jpre.apply(params, x, t, condition=cond, auxiliary=0.6)
    with torch.no_grad():
        got = tpre(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond), 0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_steps", [1, 2])
def test_scm_solver_matches_jax(num_steps):
    """1 step (the forecast path, t = π/2) and 2 steps with the re-noise:
    the JAX solver draws its step noise from split(key); the port is handed
    the same numbers."""
    jpre, params, tpre = _pair("d16", seed=6)
    _, cond, _, _ = _inputs(7)
    latents = np.random.default_rng(8).standard_normal((2, *RES, C)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(num_steps=num_steps, sigma_min=0.02, sigma_max=200.0)
    want = scm_solver(Network(jpre, params), jnp.asarray(latents), condition=jnp.asarray(cond),
                      auxiliary=0.6, key=key, **kw)
    noise = [torch.from_numpy(np.array(jax.random.normal(k, latents.shape)))
             for k in jax.random.split(key, num_steps)[1:]]
    with torch.no_grad():
        got = torch_scm_solver(tpre, torch.from_numpy(latents), torch.from_numpy(cond),
                               auxiliary=0.6, noise=noise, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if num_steps == 1:  # x = cos(π/2)·x − sin(π/2)·F: the forecast is −F
        with torch.no_grad():
            F_t = tpre(torch.from_numpy(latents), torch.tensor(math.pi / 2),
                       torch.from_numpy(cond), 0.6)
        np.testing.assert_allclose(got.numpy(), -F_t.numpy(), rtol=1e-6, atol=1e-6)
