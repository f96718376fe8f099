"""The port's Muon bf16 momentum and MARS against the JAX package, on the CPU.

* ``stochastic_round_bf16`` equals the JAX package's
  ``_stochastic_round_bf16`` bit for bit when both take the same random
  bits, and is unbiased: over 4096 draws the mean is within 5 standard
  errors (2.5 bf16 ulps / √4096) of the fp32 input.
* A Muon step with ``momentum_dtype="bfloat16"`` leaves every buffer at one
  of the two bf16 neighbours of the fp32 blend m + (1 − μ)(g − m), as the
  JAX package's ``scale_by_muon`` does from the same state (the two draw
  different bits, so only the pair is shared); the buffer survives the
  checkpoint helpers bit for bit, and a resumed optimizer then takes the
  unbroken one's step exactly (its bits depend on the step count only).
* MARS, each ``mars_type``, three steps over a tiny SwinV2's converted
  params against the JAX package's optax ``mars`` from the same gradients,
  on the JAX model's unstacked ``block{i}`` layout (a schedule as the
  learning rate, as the factory gives it): 1e-6, a mars-shampoo matrix at
  3 steps × lr × 2e-2. Its momentum agrees to the last fp32 bits and reaches
  Newton-Schulz as the same bf16 matrix, but the two packages' bf16
  Newton-Schulz products round differently (a single call on identical
  input differs by 4 bf16 ulps of a unit-size output on one matrix here),
  so each step is held to ``test_newton_schulz_matches_jax``'s 2e-2 of a
  unit-size update, not to Muon's one ulp a step (6.5 ulps measured).
* The factory builds MARS from ``optimizer=mars`` and Muon with a bf16
  momentum from ``optimizer.momentum_dtype=bfloat16``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swift_torch import factory, train
from swift_torch.models import convert
from swift_torch.training import trainer as ttrainer
from swift_torch.training.optimizers import muon
from swift_torch.training.optimizers.mars import MARS
from swift_tpu.training.optimizers.mars import mars as jax_mars
from swift_tpu.training.optimizers.muon import _stochastic_round_bf16, scale_by_muon
from tests.test_torch_muon import CFG, _grads
from swift_torch.models.precond import PassPrecond
from swift_torch.models.swinv2 import SwinV2
from tests.test_torch_train import COMMON, GEOMS, RES, C, F_, _pair


def _net(seed: int):
    """``_pair``'s tiny torch model (d12 heads) alone, random weights."""
    torch.manual_seed(seed)
    model = SwinV2(img_resolution=RES, in_channels=2 * C + F_, out_channels=C, **COMMON,
                   **GEOMS["d12"], dtype=torch.float32)
    net = PassPrecond(model, RES, C, condition_channels=C + F_, auxiliary_dim=1)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(0.2 * torch.randn(p.shape))
    return net


def _values(rng, n):
    """fp32 values over many binades, signs, and a few exact bf16 values."""
    x = rng.standard_normal(n).astype(np.float32) * np.float32(10.0) ** rng.integers(-6, 6, n)
    x[:4] = (0.0, -0.0, 1.0, -2.5)
    return x.astype(np.float32)


def test_stochastic_round_matches_jax_on_shared_bits():
    x = _values(np.random.default_rng(40), 4096).reshape(64, 64)
    key = jax.random.PRNGKey(41)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    want = np.asarray(_stochastic_round_bf16(jnp.asarray(x), key).astype(jnp.float32))
    got = muon.stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


def test_stochastic_round_is_unbiased():
    x = torch.from_numpy(_values(np.random.default_rng(42), 256))
    gen = torch.Generator().manual_seed(43)
    n = 4096
    draws = torch.stack([muon.stochastic_round_bf16(x, torch.randint(0, 1 << 16, x.shape,
                                                                     generator=gen))
                         for _ in range(n)]).double()
    lo = (x.view(torch.int32) & -65536).view(torch.float32).double()
    ulp = ((x.view(torch.int32) & -65536) + 65536).view(torch.float32).double() - lo
    assert torch.all((draws == lo) | (draws == lo + ulp))
    err = (draws.mean(0) - x.double()).abs()
    assert torch.all(err <= 2.5 * ulp.abs() / n ** 0.5), (err / ulp.abs()).max()


def _neighbours(blend: np.ndarray):
    b = blend.view(np.uint32) & np.uint32(0xFFFF0000)
    return b.view(np.float32), (b + np.uint32(0x10000)).view(np.float32)


def test_bf16_momentum_lands_next_to_the_jax_blend():
    tpre = _net(44)
    opt = _port_optimizer_bf16(tpre)
    rng = np.random.default_rng(45)
    muon_params = opt.param_groups[0]["params"]
    # no Newton-Schulz iterations: only the momentum, which they do not touch, is compared
    jtx = scale_by_muon(momentum=0.95, ns_steps=0, momentum_dtype=jnp.bfloat16)
    jax_update = jax.jit(jtx.update)
    for step in range(2):
        before = [opt.state[p]["momentum_buffer"].float().numpy().copy()
                  if p in opt.state else np.zeros(p.shape, np.float32) for p in muon_params]
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in tpre.parameters()]
        for p, g in zip(tpre.parameters(), grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        # the JAX package's step from the same state, on its (in, out) layout
        keys = [str(i) for i in range(len(muon_params))]
        state = jtx.init({k: jnp.zeros(p.shape[::-1]) for k, p in zip(keys, muon_params)})
        state = state._replace(momentum={k: jnp.asarray(m.T, jnp.bfloat16)
                                         for k, m in zip(keys, before)}, count=jnp.int32(step))
        _, state = jax_update({k: jnp.asarray(p.grad.numpy().T)
                               for k, p in zip(keys, muon_params)}, state)
        for k, p, m in zip(keys, muon_params, before):
            g = p.grad.numpy()
            blend = np.asarray(jnp.asarray(m) + (1 - 0.95) * (jnp.asarray(g) - jnp.asarray(m)))
            lo, hi = _neighbours(blend)
            got = opt.state[p]["momentum_buffer"]
            assert got.dtype == torch.bfloat16
            got = got.float().numpy()
            assert np.all((got == lo) | (got == hi)), step
            jm = np.asarray(state.momentum[k].astype(jnp.float32)).T
            assert np.all((jm == lo) | (jm == hi)), step
        assert any(np.any(opt.state[p]["momentum_buffer"].float().numpy() != 0)
                   for p in muon_params)


def _port_optimizer_bf16(tpre):
    labels = ttrainer.muon_param_labels(tpre.named_parameters())
    named = list(tpre.named_parameters())
    return muon.MuonWithAuxAdam([p for n, p in named if labels[n] == "muon"],
                                [p for n, p in named if labels[n] == "adam"],
                                momentum_dtype="bfloat16", **CFG)


def test_bf16_momentum_survives_a_checkpoint_round_trip():
    """Two steps, the state through the checkpoint's arrays into a fresh
    optimizer (the buffers back in bf16, bit for bit), then a third step on
    both: identical parameters and state."""
    a, b = _net(46), _net(46)
    rng = np.random.default_rng(47)
    grads = [{n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
              for n, p in a.named_parameters()} for _ in range(3)]
    opt_a = _port_optimizer_bf16(a)
    for g in grads[:2]:
        for n, p in a.named_parameters():
            p.grad = g[n].clone()
        opt_a.step()
    b.load_state_dict(a.state_dict())
    opt_b = _port_optimizer_bf16(b)
    params_a, params_b = dict(a.named_parameters()), dict(b.named_parameters())
    arrays = ttrainer.optimizer_state_arrays(opt_a, params_a)
    opt_b.load_state_dict(ttrainer.optimizer_state_dict(opt_b, params_b, arrays))
    for n in params_a:
        for k, v in opt_a.state[params_a[n]].items():
            w = opt_b.state[params_b[n]][k]
            assert w.dtype == v.dtype and torch.equal(w, v), (n, k)
    for net, opt in ((a, opt_a), (b, opt_b)):
        for n, p in net.named_parameters():
            p.grad = grads[2][n].clone()
        opt.step()
    for n in params_a:
        assert torch.equal(params_a[n], params_b[n]), n
        for k, v in opt_a.state[params_a[n]].items():
            assert torch.equal(v, opt_b.state[params_b[n]][k]), (n, k)


MARS_CFG = dict(weight_decay=0.1, lr_1d=3e-3)
LR = 1e-3


@pytest.mark.parametrize("mars_type", ["mars-adamw", "mars-lion", "mars-shampoo"])
def test_mars_three_steps_match_optax(mars_type):
    _, params, tpre = _pair("d12", seed=48, scan_layers=False)
    jopt = jax_mars(learning_rate=lambda count: LR, mars_type=mars_type, **MARS_CFG)
    state = jopt.init(params)
    update = jax.jit(jopt.update)
    opt = MARS(tpre.parameters(), lr=LR, mars_type=mars_type, **MARS_CFG)
    rng = np.random.default_rng(49)
    for _ in range(3):
        grads = _grads(rng, params)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        by_name = convert.params_to_state_dict(grads)
        for n, p in tpre.named_parameters():
            p.grad = torch.from_numpy(by_name[n])
        opt.step()
    want = convert.params_to_state_dict(jax.device_get(params))
    for n, p in tpre.named_parameters():
        atol = 3 * LR * 2e-2 if mars_type == "mars-shampoo" and p.ndim == 2 else 1e-6
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=atol, err_msg=n)


def test_factory_builds_mars_and_a_bf16_muon():
    tpre = _net(50)
    cfg = train.cfglib.compose("train", ["experiment=synthetic-tiny-scm", "optimizer=mars"])
    opt, lr_fn = factory.build_optimizer(cfg["optimizer"], cfg["trainer"], 4, tpre)
    assert type(opt) is MARS
    (group,) = opt.param_groups
    assert (group["mars_type"], group["lr_1d"], group["weight_decay"]) == ("mars-adamw", 1e-3, 0.1)
    assert group["lr"] == lr_fn(0, group["base_lr"])
    cfg = train.cfglib.compose("train", ["optimizer=muon", "optimizer.momentum_dtype=bfloat16"])
    opt, _ = factory.build_optimizer(cfg["optimizer"], cfg["trainer"], 4, tpre)
    for p in tpre.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    kinds = {g["kind"]: g["params"] for g in opt.param_groups}
    assert all(opt.state[p]["momentum_buffer"].dtype == torch.bfloat16 for p in kinds["muon"])
    assert all(opt.state[p]["exp_avg"].dtype == torch.float32 for p in kinds["adam"])
