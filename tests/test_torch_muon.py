"""The port's Muon with aux-Adam against the JAX package's, on the CPU.

* ``newton_schulz`` against the JAX package's on square, wide and tall
  matrices. Both run in bf16 with the same rounding points and bf16
  coefficients; a bf16 tolerance (2e-2 of max|JAX|) leaves room for the
  products' fp32 sums, which XLA and PyTorch take in different orders.
* Three steps of ``MuonWithAuxAdam`` over a tiny SwinV2's converted params
  against ``muon_with_aux_adam(muon_param_labels, ...)`` in optax, from the
  same gradients. Every Muon weight is non-square (qkv 32→72, wo 24→32, w1
  32→170, w2 85→32, modulation 32→64), so the aspect factor max(1, in/out)
  ^0.5 on the JAX layout is held. Adam-group parameters agree to 1e-6; a
  Muon weight moves by lr·NS(u) a step with NS in bf16, whose large
  products sum in different orders, so it is held to 3 steps × lr × 2^-8
  (one bf16 ulp of a unit-size update a step; 1.2e-4 measured).
* The port's labels equal the JAX labels mapped through the converter, in
  both JAX layouts; the optimizer state survives the checkpoint round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import swift_tpu.training.trainer as jtrainer
from swift_torch.models import convert
from swift_torch.training import trainer as ttrainer
from swift_torch.training.optimizers import muon
from swift_tpu.training.optimizers.muon import muon_with_aux_adam, newton_schulz
from tests.test_torch_train import _pair

CFG = dict(lr=0.02, weight_decay=0.01, adam_lr=3e-4, adam_betas=(0.9, 0.95),
           adam_weight_decay=0.01, adam_eps=1e-10)


@pytest.mark.parametrize("shape", [(48, 48), (24, 72), (72, 24)], ids=["square", "wide", "tall"])
def test_newton_schulz_matches_jax(shape):
    G = np.random.default_rng(60).standard_normal(shape).astype(np.float32)
    want = np.asarray(newton_schulz(jnp.asarray(G)).astype(jnp.float32))
    got = muon.newton_schulz(torch.from_numpy(G)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    # and the direction is orthogonal-ish: singular values near 1
    s = np.linalg.svd(got, compute_uv=False)
    assert s.min() > 0.5 and s.max() < 1.5


def _labels_by_name(jlabels, params):
    """The JAX labels by the port's names (each label broadcast to its
    leaf's shape, so the converter can unstack the ``pairs`` layout)."""
    as_float = jax.tree_util.tree_map(lambda l, p: np.full(np.shape(p), l == "muon", np.float32),
                                      jlabels, params)
    return {n: "muon" if v.all() else "adam"
            for n, v in convert.params_to_state_dict(as_float).items()}


@pytest.mark.parametrize("scan_layers", [True, False], ids=["pairs", "blocks"])
def test_labels_match_jax(scan_layers):
    _, params, tpre = _pair("d12", scan_layers=scan_layers)
    want = _labels_by_name(jtrainer.muon_param_labels(params), params)
    got = ttrainer.muon_param_labels(tpre.named_parameters())
    assert got == want
    muon_names = sorted(n for n, v in got.items() if v == "muon")
    assert all(n.split(".")[-2] in ("to_qkv", "wo", "w1", "w2", "modulation")
               for n in muon_names)
    assert len(muon_names) == 6 * 2  # six weights a block, depth 2
    assert got["model.transformer.layers.0.0.scale"] == "adam"


def _grads(rng, params):
    return jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                  params)


def _port_optimizer(tpre):
    labels = ttrainer.muon_param_labels(tpre.named_parameters())
    named = list(tpre.named_parameters())
    return muon.MuonWithAuxAdam([p for n, p in named if labels[n] == "muon"],
                                [p for n, p in named if labels[n] == "adam"], **CFG)


def test_three_steps_match_optax():
    _, params, tpre = _pair("d12", seed=61)
    jopt = muon_with_aux_adam(jtrainer.muon_param_labels, **CFG)
    state = jopt.init(params)
    opt = _port_optimizer(tpre)
    labels = ttrainer.muon_param_labels(tpre.named_parameters())
    rng = np.random.default_rng(62)
    for _ in range(3):
        grads = _grads(rng, params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        by_name = convert.params_to_state_dict(grads)
        for n, p in tpre.named_parameters():
            p.grad = torch.from_numpy(by_name[n])
        opt.step()
    want = convert.params_to_state_dict(jax.device_get(params))
    for n, p in tpre.named_parameters():
        atol = 3 * CFG["lr"] * 2 ** -8 if labels[n] == "muon" else 1e-6
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=atol, err_msg=n)


def test_state_survives_a_checkpoint_round_trip():
    """Two steps, the state through ``optimizer_state_arrays`` and back into
    a fresh optimizer, then a third step on both: identical parameters."""
    _, _, a = _pair("d12", seed=63)
    _, _, b = _pair("d12", seed=63)
    rng = np.random.default_rng(64)
    grads = [{n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
              for n, p in a.named_parameters()} for _ in range(3)]
    opt_a = _port_optimizer(a)
    for g in grads[:2]:
        for n, p in a.named_parameters():
            p.grad = g[n].clone()
        opt_a.step()
    b.load_state_dict(a.state_dict())
    opt_b = _port_optimizer(b)
    params_a, params_b = dict(a.named_parameters()), dict(b.named_parameters())
    arrays = ttrainer.optimizer_state_arrays(opt_a, params_a)
    assert {k.rsplit("/", 1)[1] for k in arrays} == {"momentum_buffer", "step", "exp_avg",
                                                      "exp_avg_sq"}
    opt_b.load_state_dict(ttrainer.optimizer_state_dict(opt_b, params_b, arrays))
    for net, opt in ((a, opt_a), (b, opt_b)):
        for n, p in net.named_parameters():
            p.grad = grads[2][n].clone()
        opt.step()
    for n in params_a:
        assert torch.equal(params_a[n], params_b[n]), n
        for k, v in opt_a.state[params_a[n]].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(opt_b.state[params_b[n]][k]))
