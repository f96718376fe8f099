"""swift_torch's int8 forecast network (``SwinV2(quant="int8")``) against the
JAX package, on the CPU in fp32 at a tiny size.

* The tiny model of ``tests/test_quant.py`` with ``quant="int8"`` under
  PassPrecond, weights through ``convert``, against the JAX model with
  ``quant="int8"`` (its jnp path: ``int8_matmul`` for qkv and wo, the FFN
  mirror), at relative L2 1e-4, on the port's whole-grid route and with its
  tiled route forced (the activation rolled before the int8 projection).
* ``jvp=True`` leaves the int8 model on the fp path: the port of
  ``test_quant_never_touches_jvp_path``.
* The forecast gate of ``test_forecast_accuracy_gate``: one-step sCM
  forecasts from the same weights and latents, port int8 against port fp
  within 5% relative RMS, and port int8 against JAX int8 at 1e-4.
* Every weight the int8 path quantizes is an fp32 parameter (or a view of
  one), never its bf16 copy: the JAX model hands ``quantize_colwise`` its
  fp32 kernels.
* ``factory.build_model`` builds ``quant="int8"`` from the model config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import swift_torch.models.swinv2 as tswinv2
from swift_torch import factory
from swift_torch.models import convert
from swift_torch.models.precond import PassPrecond as TorchPassPrecond
from swift_torch.ops import quant
from swift_torch.sampling.solvers import scm_solver as torch_scm_solver
from swift_tpu.models.precond import Network, PassPrecond
from swift_tpu.models.swinv2 import SwinV2
from swift_tpu.sampling.solvers import scm_solver

H, W, C, F_ = 8, 16, 3, 1
TINY = dict(img_resolution=(H, W), in_channels=2 * C + F_, out_channels=C, window_size=(2, 2),
            shift_size=(1, 1), patch_size=(2, 2), depth=2, dim=32, heads=4, auxiliary_dim=1)
MODEL_TOL = 1e-4  # relative L2, fp32 through two int8 blocks
GATE = 0.05  # int8 vs fp forecast, relative RMS (tests/test_quant.py)


def _randomize_zero_leaves(params):
    """tests/test_quant.py's: seeded normals for the zero-initialised leaves."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [0.05 * jax.random.normal(jax.random.PRNGKey(500 + i), a.shape, a.dtype)
              if not np.any(np.asarray(a)) else a for i, a in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _jax_pre(quant_mode):
    model = SwinV2(**TINY, dtype=jnp.float32, use_pallas=False, quant=quant_mode)
    return PassPrecond(model=model, img_resolution=(H, W), img_channels=C,
                       condition_channels=C + F_, auxiliary_dim=1, sigma_data=1.0)


@pytest.fixture(scope="module")
def params():
    return _randomize_zero_leaves(_jax_pre(None).init(jax.random.PRNGKey(0)))


def _torch_pre(params, quant_mode):
    pre = TorchPassPrecond(tswinv2.SwinV2(**TINY, dtype=torch.float32, quant=quant_mode),
                           (H, W), C, condition_channels=C + F_, auxiliary_dim=1,
                           sigma_data=1.0)
    pre.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in convert.params_to_state_dict(params).items()})
    return pre.eval()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            rng.standard_normal((B, H, W, C + F_)).astype(np.float32),
            rng.uniform(0.1, 1.5, (B,)).astype(np.float32),
            rng.uniform(0.5, 2.5, (B, 1)).astype(np.float32))


@pytest.mark.parametrize("route", ["block", "tiled"])
def test_int8_swinv2_matches_jax(params, route, monkeypatch):
    calls = []
    if route == "tiled":
        def tiled(*args):
            calls.append(args)
            return "tiled"

        monkeypatch.setattr(tswinv2, "attention_route", tiled)
    x, cond, t, aux = _batch(1)
    want = _jax_pre("int8").apply(params, x, t, condition=cond, auxiliary=aux)
    tpre = _torch_pre(params, "int8")
    with torch.no_grad():
        got = tpre(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                   torch.from_numpy(aux))
    assert len(calls) == (2 if route == "tiled" else 0)
    rel = _rel(got.numpy(), want)
    assert rel < MODEL_TOL, rel
    # and it is the int8 path: the fp model differs by far more
    assert _rel(got.numpy(), _jax_pre(None).apply(params, x, t, condition=cond,
                                                  auxiliary=aux)) > 100 * MODEL_TOL


def test_int8_never_touches_jvp_path(params):
    """With jvp=True the int8 model is the fp model, primal and tangent."""
    rng = np.random.default_rng(5)
    x, cond = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, H, W, C), (1, H, W, C + F_)))
    dx = torch.from_numpy(rng.standard_normal((1, H, W, C)).astype(np.float32))
    t, aux = torch.full((1,), 0.7), torch.full((1, 1), 0.6)
    outs = []
    for mode in ("int8", None):
        pre = _torch_pre(params, mode)
        with torch.no_grad(), forward_ad.dual_level():
            y = pre(forward_ad.make_dual(x, dx), t, cond, aux, jvp=True)
            p, d = forward_ad.unpack_dual(y)
            outs.append((p.clone(), d.clone()))
    (yq, dyq), (yf, dyf) = outs
    np.testing.assert_allclose(yq.numpy(), yf.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dyq.numpy(), dyf.numpy(), rtol=1e-5, atol=1e-5)


def test_forecast_accuracy_gate(params):
    """One-step sCM forecasts from the same weights and latents: the port's
    int8 against its fp forecast within 5% relative RMS (the JAX package's
    gate, which catches wiring and scale faults that land orders of
    magnitude off), and against the JAX int8 forecast at 1e-4."""
    X = np.array(jax.random.normal(jax.random.PRNGKey(3), (2, H, W, C + F_)))
    latents = np.random.default_rng(4).standard_normal((2, H, W, C)).astype(np.float32)
    kw = dict(num_steps=1, sigma_min=0.02, sigma_max=200.0)
    want = np.asarray(scm_solver(Network(_jax_pre("int8"), params), jnp.asarray(latents),
                                 condition=jnp.asarray(X), auxiliary=0.6,
                                 key=jax.random.PRNGKey(9), **kw))
    got = {}
    for mode in ("int8", None):
        with torch.no_grad():
            got[mode] = torch_scm_solver(_torch_pre(params, mode), torch.from_numpy(latents),
                                         torch.from_numpy(X), auxiliary=0.6, **kw).numpy()
    assert np.isfinite(got["int8"]).all()
    gate = _rel(got["int8"], got[None])
    assert gate < GATE, f"int8 forecast deviates {gate:.4f} rel RMS from fp"
    assert _rel(got["int8"], want) < MODEL_TOL


def test_int8_quantizes_the_fp32_parameters(params, monkeypatch):
    """Every weight handed to ``quantize_colwise`` is an fp32 parameter or a
    view of one (the FFN's gate and up halves), in a bf16 model too."""
    seen = []
    orig = quant.quantize_colwise

    def spy(w):
        seen.append(w)
        return orig(w)

    monkeypatch.setattr(quant, "quantize_colwise", spy)
    pre = TorchPassPrecond(tswinv2.SwinV2(**TINY, dtype=torch.bfloat16, quant="int8"), (H, W),
                           C, condition_channels=C + F_, auxiliary_dim=1).eval()
    x, cond, t, aux = (torch.from_numpy(a) for a in _batch(6))
    with torch.no_grad():
        out = pre(x, t, cond, aux)
    assert torch.isfinite(out).all()
    storages = {p.untyped_storage().data_ptr(): n for n, p in pre.named_parameters()}
    names = [storages.get(w.untyped_storage().data_ptr()) for w in seen]
    assert all(w.dtype == torch.float32 for w in seen), [w.dtype for w in seen]
    # per block: qkv, wo, and the FFN's gate, up and w2 (the plain path's three products)
    assert len(seen) == 5 * TINY["depth"] and None not in names, names
    assert {n.rsplit(".", 2)[-2] for n in names} == {"to_qkv", "wo", "w1", "w2"}


def test_factory_builds_int8():
    model = {"_target_": "swift_tpu.models.swinv2.SwinV2", "window_size": [2, 2],
             "shift_size": [1, 1], "patch_size": [2, 2], "depth": 2, "dim": 32, "heads": 4}
    net = factory.build_model({**model, "quant": "int8"}, (H, W), 2 * C + F_, C)
    assert net.quant == "int8"
    assert {m.quant for m in net.modules() if hasattr(m, "quant")} == {"int8"}
    assert factory.build_model(model, (H, W), 2 * C + F_, C).quant is None
    with pytest.raises(ValueError, match="quant"):
        factory.build_model({**model, "quant": "int4"}, (H, W), 2 * C + F_, C)
