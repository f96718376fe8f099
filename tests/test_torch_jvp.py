"""The port's forward-mode (jvp) path against the JAX package, on the CPU.

* The plain versions of kernels 14 (qkv projection primal + tangent), 11
  (FFN primal + tangent), 12 (modnorm tangent) and 7 (attention tangent)
  against the Pallas functions they replace, run in interpret mode as the
  JAX package's own kernel tests run them, and against ``torch.func.jvp`` of
  the plain forwards; each wrapper under ``torch.autograd.forward_ad``
  gives the plain tangent; a tangent on a weight, on g or b or on the logit
  scale raises, as ``jvp_guard`` makes the JAX rules raise; a wrapper with
  no tangent route refuses a dual input.
* ``SwinV2(jvp=True)``'s tangent against ``jax.jvp`` of the JAX model, both
  head layouts, with the JAX FFN and modnorm on their jnp ops and on their
  Pallas tangent kernels.
* ``SCMLoss`` value and every gradient against ``jax.value_and_grad`` of the
  JAX ``SCMLoss``, with JAX's (τ, z) draws fed in, at a tangent warmup
  r < 1, at r = 1, and distilled from a teacher.

fp32 from numpy seeds. Tolerances: 2e-5 for the kernels' plain versions
(fp32 sums over up to a few hundred terms in different orders, the bound
``test_torch_ops`` holds the forwards to); rtol 1e-4 for the model tangent
and the loss gradients (fp32 through two blocks, sums in different orders),
1e-5 for loss values. The four kernels themselves are held to their plain
versions on the card by the ``cuda``-marked tests of ``test_torch_ops.py``
(this file imports flax through the JAX model, which the card's machine
lacks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch.autograd import forward_ad

import swift_tpu.ops.pallas_block_attention as pba
import swift_tpu.ops.pallas_ffn as pffn
import swift_tpu.ops.pallas_linear as plin
import swift_tpu.ops.pallas_modnorm as pmn
import swift_tpu.training.loss as jloss
from swift_torch.ops import block_attention, ffn, linear, modnorm
from swift_torch.training import loss as tloss
from swift_tpu.models.precond import Network
from tests.test_torch_train import (
    NOISE,
    RES,
    VARS,
    _assert_grads,
    _batch,
    _grads_by_name,
    _jax_draws,
    _pair,
)

TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Force the Pallas interpreter off-TPU (as tests/test_pallas_*.py do)."""
    if jax.default_backend() != "tpu":
        orig = pl.pallas_call
        for mod in (pba, pffn, plin, pmn):
            monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, err_msg="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=err_msg)


def _dual_call(fn, args, tangents):
    """(primal, tangent) of ``fn(*args)`` with forward-mode tangents on the
    positions ``tangents`` names ({index: tangent})."""
    with torch.no_grad(), forward_ad.dual_level():
        duals = [forward_ad.make_dual(a, tangents[i]) if i in tangents else a
                 for i, a in enumerate(args)]
        p, d = forward_ad.unpack_dual(fn(*duals))
        return p.clone(), d.clone()


# -- inputs of the four kernels ------------------------------------------------

def _linear_inputs(seed):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (3, 128, 48)), _rand(rng, (3, 128, 48)),
            _rand(rng, (72, 48), 48 ** -0.5))  # x, dx, w (N, K)


def _ffn_inputs(seed, T=384, D=32, H=40):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (T, D)), _rand(rng, (T, D)), _rand(rng, (2 * H, D), D ** -0.5),
            _rand(rng, (D, H), H ** -0.5))  # x, dx, w1 (2H, D), w2 (D, H)


def _modnorm_inputs(seed, B=3, N=64, D=48):
    rng = np.random.default_rng(seed)
    y, r = _rand(rng, (B, N, D), 2.0), _rand(rng, (B, N, D))
    dy, dr = _rand(rng, (B, N, D)), _rand(rng, (B, N, D))
    g, b = 1.0 + _rand(rng, (D,), 0.1), _rand(rng, (D,), 0.1)
    msc, msh, dmsc, dmsh = (_rand(rng, (B, D), 0.2) for _ in range(4))
    return y, r, g, b, msc, msh, dy, dr, dmsc, dmsh


def _attention_inputs(seed, heads, d):
    rng = np.random.default_rng(seed)
    qkv = _rand(rng, (2, 8, 16, heads * 3 * d))
    dqkv = _rand(rng, (2, 8, 16, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.1) + 1.0)
    return qkv, dqkv, scale


# -- plain versions against the Pallas kernels, in interpret mode ----------------

def test_linear_pt_plain_matches_pallas():
    x, dx, w = _linear_inputs(30)
    jy, jdy = plin._lin_pt_call(jnp.asarray(x.reshape(-1, 48)), jnp.asarray(dx.reshape(-1, 48)),
                                jnp.asarray(w.T))
    y, dy = linear.reference_linear_pt(_t(x), _t(dx), _t(w))
    _close(y.reshape(-1, 72), jy, "y")
    _close(dy.reshape(-1, 72), jdy, "dy")


def test_ffn_pt_plain_matches_pallas():
    x, dx, w1, w2 = _ffn_inputs(31)
    H = w2.shape[1]
    w1j = jnp.asarray(w1.T)
    jy, jdy = pffn._ffn_pt_call(jnp.asarray(x), jnp.asarray(dx), w1j[:, :H], w1j[:, H:],
                                jnp.asarray(w2.T))
    y, dy = ffn.reference_swiglu_ffn_pt(_t(x), _t(dx), _t(w1), _t(w2))
    _close(y, jy, "y")
    _close(dy, jdy, "dy")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_hidden_pt_composes_to_the_plain_ffn_pt(dtype):
    """Kernel 11's two passes as plain versions: h·W2ᵀ and dh·W2ᵀ of
    ``reference_swiglu_hidden_pt`` are ``reference_swiglu_ffn_pt`` bit for
    bit."""
    x, dx, w1, w2 = (_t(a).to(dtype) for a in _ffn_inputs(32, T=128, H=85))
    got = linear.reference_linear_pt(*ffn.reference_swiglu_hidden_pt(x, dx, w1), w2)
    for g, w in zip(got, ffn.reference_swiglu_ffn_pt(x, dx, w1, w2)):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("H", [85, 128])
def test_swiglu_hidden_pt_plain_matches_pallas(H):
    """Kernel 11's plain passes against the interpreted ``_ffn_pt_call`` at
    the SwiGLU width 85 and at a multiple of 64."""
    x, dx, w1, w2 = _ffn_inputs(33, H=H)
    w1j = jnp.asarray(w1.T)
    jy, jdy = pffn._ffn_pt_call(jnp.asarray(x), jnp.asarray(dx), w1j[:, :H], w1j[:, H:],
                                jnp.asarray(w2.T))
    h, dh = ffn.reference_swiglu_hidden_pt(_t(x), _t(dx), _t(w1))
    y, dy = linear.reference_linear_pt(h, dh, _t(w2))
    _close(y, jy, "y")
    _close(dy, jdy, "dy")


def test_modnorm_tangent_plain_matches_pallas():
    y, r, g, b, msc, msh, dy, dr, dmsc, dmsh = _modnorm_inputs(32)
    B, N, D = y.shape
    flat = lambda a: jnp.asarray(a.reshape(-1, D))  # noqa: E731
    want = pmn._tangent_call(flat(y), flat(dy), flat(dr), jnp.asarray(g), jnp.asarray(b),
                             jnp.asarray(msc), jnp.asarray(dmsc), jnp.asarray(dmsh), 1e-6, N)
    got = modnorm.reference_modnorm_residual_tangent(*map(_t, (y, dy, dr, g, b, msc, dmsc,
                                                               dmsh)))
    _close(got.reshape(-1, D), want)


@pytest.mark.parametrize("heads,d", [(2, 88), (2, 128)], ids=["d88", "d128"])
@pytest.mark.parametrize("shift", [(0, 0), (3, 5)], ids=["noshift", "odd"])
def test_block_attention_tangent_plain_matches_pallas(heads, d, shift):
    """jax.jvp of the JAX wrapper reaches ``_tangent_call`` through its jvp
    rule; d = 88 is zero-padded to 128 lanes there. (3, 5) puts windows
    across the grid's wrap-around in both axes."""
    qkv, dqkv, scale = _attention_inputs(33, heads, d)
    fn = lambda a: pba.fused_block_attention(a, jnp.asarray(scale), heads, (4, 8), shift,  # noqa: E731
                                             jvp=True)
    _, want = jax.jvp(fn, (jnp.asarray(qkv),), (jnp.asarray(dqkv),))
    got = block_attention.reference_block_attention_tangent(_t(qkv), _t(dqkv), _t(scale), heads,
                                                            (4, 8), shift)
    _close(got, want)


@pytest.mark.parametrize("d", [88, 128], ids=["d88", "d128"])
def test_block_attention_tangent_plain_matches_pallas_at_kernel_windows(d):
    """The plain version of kernels 7 and 17 at the CUDA kernels' geometry:
    16x16 windows (256 keys, the softmax the kernels split across a
    cluster's two blocks), on a 16x32 grid of two windows with a shift of
    (8, 8) that wraps on both axes, against jax.jvp of the JAX wrapper, whose
    tangent kernel runs interpreted."""
    rng = np.random.default_rng(39 + d)
    heads = 2
    qkv = _rand(rng, (2, 16, 32, heads * 3 * d))
    dqkv = _rand(rng, (2, 16, 32, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.3) + np.log(10.0))  # around the logit scale's init
    fn = lambda a: pba.fused_block_attention(a, jnp.asarray(scale), heads, (16, 16), (8, 8),  # noqa: E731
                                             jvp=True)
    _, want = jax.jvp(fn, (jnp.asarray(qkv),), (jnp.asarray(dqkv),))
    got = block_attention.reference_block_attention_tangent(_t(qkv), _t(dqkv), _t(scale), heads,
                                                            (16, 16), (8, 8))
    _close(got, want)


# -- plain versions against torch.func.jvp of the plain forwards ---------------

def test_tangent_plain_versions_match_torch_func_jvp():
    x, dx, w = map(_t, _linear_inputs(34))
    want = torch.func.jvp(lambda a: linear.reference_linear(a, w), (x,), (dx,))
    for g, wnt, name in zip(linear.reference_linear_pt(x, dx, w), want, ("y", "dy")):
        _close(g, wnt, f"linear {name}")

    x, dx, w1, w2 = map(_t, _ffn_inputs(35, T=24))
    want = torch.func.jvp(lambda a: ffn.reference_swiglu_ffn(a, w1, w2), (x,), (dx,))
    for g, wnt, name in zip(ffn.reference_swiglu_ffn_pt(x, dx, w1, w2), want, ("y", "dy")):
        _close(g, wnt, f"ffn {name}")

    y, r, g_, b, msc, msh, dy, dr, dmsc, dmsh = map(_t, _modnorm_inputs(36))
    _, want = torch.func.jvp(
        lambda a, res, sc, sh: modnorm.reference_modnorm_residual(a, res, g_, b, sc, sh),
        (y, r, msc, msh), (dy, dr, dmsc, dmsh))
    got = modnorm.reference_modnorm_residual_tangent(y, dy, dr, g_, b, msc, dmsc, dmsh)
    _close(got, want, "modnorm")

    for shift in ((0, 0), (3, 5)):
        qkv, dqkv, scale = map(_t, _attention_inputs(37, 3, 8))
        _, want = torch.func.jvp(
            lambda a: block_attention.reference_block_attention(a, scale, 3, (4, 8), shift),
            (qkv,), (dqkv,))
        got = block_attention.reference_block_attention_tangent(qkv, dqkv, scale, 3, (4, 8),
                                                                shift)
        _close(got, want, f"attention {shift}")


# -- the wrappers under forward AD ---------------------------------------------

def test_wrappers_carry_the_plain_tangent():
    """On CPU tensors each wrapper's tangent route runs the plain versions
    (no launch): the dual output's primal is the plain forward, its tangent
    the plain tangent; a missing tangent on a modnorm input is zero."""
    fns = (linear.fused_linear, linear.linear_pt, ffn.fused_swiglu_ffn, ffn.swiglu_ffn_pt,
           modnorm.fused_modnorm_residual, modnorm.modnorm_residual_tangent,
           block_attention.fused_block_attention, block_attention.block_attention_tangent)
    before = [f.launches for f in fns]

    x, dx, w = map(_t, _linear_inputs(38))
    y, dy = _dual_call(linear.fused_linear, (x, w), {0: dx})
    for g, wnt in zip((y, dy), linear.reference_linear_pt(x, dx, w)):
        _close(g, wnt)

    x, dx, w1, w2 = map(_t, _ffn_inputs(39, T=24))
    y, dy = _dual_call(ffn.fused_swiglu_ffn, (x, w1, w2), {0: dx})
    for g, wnt in zip((y, dy), ffn.reference_swiglu_ffn_pt(x, dx, w1, w2)):
        _close(g, wnt)

    y, r, g_, b, msc, msh, dy, dr, dmsc, dmsh = map(_t, _modnorm_inputs(40))
    out, dout = _dual_call(modnorm.fused_modnorm_residual, (y, r, g_, b, msc, msh),
                           {0: dy, 1: dr, 4: dmsc, 5: dmsh})
    _close(out, modnorm.reference_modnorm_residual(y, r, g_, b, msc, msh))
    _close(dout, modnorm.reference_modnorm_residual_tangent(y, dy, dr, g_, b, msc, dmsc, dmsh))
    _, dout = _dual_call(modnorm.fused_modnorm_residual, (y, r, g_, b, msc, msh), {4: dmsc})
    zero = torch.zeros_like(y)
    _close(dout, modnorm.reference_modnorm_residual_tangent(y, zero, zero, g_, b, msc, dmsc,
                                                            torch.zeros_like(msh)))

    qkv, dqkv, scale = map(_t, _attention_inputs(41, 3, 8))
    out, dout = _dual_call(block_attention.fused_block_attention, (qkv, scale, 3, (4, 8), (3, 5)),
                           {0: dqkv})
    _close(out, block_attention.reference_block_attention(qkv, scale, 3, (4, 8), (3, 5)))
    _close(dout, block_attention.reference_block_attention_tangent(qkv, dqkv, scale, 3, (4, 8),
                                                                   (3, 5)))
    assert [f.launches for f in fns] == before


def test_parameter_tangents_raise():
    """A tangent on a weight, on g or b, or on the logit scale raises
    NotImplementedError, as the JAX rules' ``jvp_guard`` does."""
    x, dx, w = map(_t, _linear_inputs(42))
    with pytest.raises(NotImplementedError, match=r"fused_linear.*\['w'\]"):
        _dual_call(linear.fused_linear, (x, w), {0: dx, 1: torch.ones_like(w)})
    x, dx, w1, w2 = map(_t, _ffn_inputs(43, T=24))
    with pytest.raises(NotImplementedError, match=r"fused_swiglu_ffn.*\['w2'\]"):
        _dual_call(ffn.fused_swiglu_ffn, (x, w1, w2), {2: torch.ones_like(w2)})
    y, r, g_, b, msc, msh, dy, *_ = map(_t, _modnorm_inputs(44))
    for i, name in ((2, "g"), (3, "b")):
        with pytest.raises(NotImplementedError, match=rf"fused_modnorm_residual.*\['{name}'\]"):
            _dual_call(modnorm.fused_modnorm_residual, (y, r, g_, b, msc, msh),
                       {0: dy, i: torch.ones(y.shape[-1])})
    qkv, dqkv, scale = map(_t, _attention_inputs(45, 3, 8))
    with pytest.raises(NotImplementedError, match=r"fused_block_attention.*\['scale'\]"):
        _dual_call(block_attention.fused_block_attention, (qkv, scale, 3, (4, 8)),
                   {0: dqkv, 1: torch.ones(3)})


def test_wrappers_without_a_tangent_route_refuse_duals():
    """Kernel 3 (the JAX package runs wo as a plain product under the jvp),
    the FFN forward that saves gate/up and the backward kernels have no
    tangent route: a dual input raises instead of losing its tangent."""
    rng = np.random.default_rng(46)
    B, N, F, D = 2, 16, 24, 48
    x, w, r = _rand(rng, (B, N, F)), _rand(rng, (D, F)), _rand(rng, (B, N, D))
    ep = (1.0 + _rand(rng, (D,), 0.1), _rand(rng, (D,), 0.1), _rand(rng, (B, D)),
          _rand(rng, (B, D)))
    args = tuple(map(_t, (x, w, r) + ep))
    with pytest.raises(NotImplementedError, match="fused_matmul_modnorm_residual.*no tangent"):
        _dual_call(modnorm.fused_matmul_modnorm_residual, args, {0: torch.ones_like(args[0])})
    with pytest.raises(NotImplementedError, match="no tangent"):
        _dual_call(modnorm.fused_matmul_modnorm_residual, args, {5: torch.ones_like(args[5])})
    x, dx, w1, w2 = map(_t, _ffn_inputs(47, T=24))
    with pytest.raises(NotImplementedError, match="swiglu_ffn_fwd_save.*no tangent"):
        with torch.no_grad(), forward_ad.dual_level():
            ffn.swiglu_ffn_fwd_save(forward_ad.make_dual(x, dx), w1, w2)
    qkv, dqkv, scale = map(_t, _attention_inputs(48, 3, 8))
    dout = torch.ones(2, 8, 16, 24)
    with pytest.raises(NotImplementedError, match="block_attention_bwd.*no tangent"):
        with torch.no_grad(), forward_ad.dual_level():
            block_attention.block_attention_bwd(forward_ad.make_dual(qkv, dqkv), scale, dout, 3,
                                                (4, 8))
    with pytest.raises(NotImplementedError, match="fused_linear_bwd.*no tangent"):
        with torch.no_grad(), forward_ad.dual_level():
            linear.fused_linear_bwd(torch.ones(4, 72), forward_ad.make_dual(x[:4, :24].contiguous(),
                                    dx[:4, :24].contiguous()), torch.ones(72, 24))


# -- the model's tangent against jax.jvp ----------------------------------------

@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("geom", ["d16", "d12"])
def test_swinv2_tangent_matches_jax_jvp(geom, route, monkeypatch):
    """The port takes the tangent routes of kernels 14, 7, 11, 4 and 12
    (their plain versions here) at every grid. ``route`` picks the JAX
    reference's: at this small grid its FFN and epilogues are jnp ops under
    ``jax.jvp`` ("plain"), or, with its token gate at one token, its Pallas
    tangent kernels in interpret mode ("kernels")."""
    if route == "kernels":
        monkeypatch.setenv("SWIFT_JVP_FUSED_MIN_TOKENS", "1")
    jpre, params, tpre = _pair(geom, seed=50)
    x, cond, t, aux = _batch(51)
    rng = np.random.default_rng(52)
    vx, vt = _rand(rng, x.shape), _rand(rng, t.shape)

    def f(xi, ti):
        return jpre.apply(params, xi, ti, jnp.asarray(cond), jnp.asarray(aux), jvp=True)

    jout, jdout = jax.jvp(f, (jnp.asarray(x), jnp.asarray(t)), (jnp.asarray(vx), jnp.asarray(vt)))
    with torch.no_grad(), forward_ad.dual_level():
        out = tpre(forward_ad.make_dual(_t(x), _t(vx)), forward_ad.make_dual(_t(t), _t(vt)),
                   _t(cond), _t(aux), jvp=True)
        out, dout = forward_ad.unpack_dual(out)
        out, dout = out.clone(), dout.clone()
    for got, want, name in ((out, jout, "primal"), (dout, jdout, "tangent")):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


# -- SCMLoss against the JAX package -------------------------------------------

def _scm_losses(jpre, warmup_kimg, distillation=False):
    j = jloss.SCMLoss(precond=jpre, lat_dim=RES[0], variables=tuple(VARS), noise=dict(NOISE),
                      sigma_data=1.0, tangent_warmup_kimg=warmup_kimg,
                      distillation=distillation)
    t = tloss.SCMLoss(RES[0], VARS, dict(NOISE), sigma_data=1.0,
                      tangent_warmup_kimg=warmup_kimg, distillation=distillation)
    return j, t


@pytest.mark.parametrize("case", ["ramp", "r1", "teacher"])
def test_scm_loss_matches_jax(case):
    """r = min(1, step / (warmup_kimg·1000)): 0.4 at step 400 of a 1-kimg
    ramp, 1 without a ramp; the teacher case distils dx_t/dt from a second
    net with other weights (r = 1)."""
    jpre, params, tpre = _pair("d16", seed=53)
    x, cond, _, aux = _batch(54)
    key = jax.random.PRNGKey(55)
    step = 400.0
    jl, tl = _scm_losses(jpre, 1 if case == "ramp" else 0, distillation=case == "teacher")
    jteacher = tteacher = None
    if case == "teacher":
        tj, tparams, tteacher = _pair("d16", seed=56)
        jteacher = Network(tj, tparams)
    jval, jg = jax.value_and_grad(
        lambda p: jl(p, key, jnp.asarray(x), jnp.float32(step), condition=jnp.asarray(cond),
                     auxiliary=aux, teacher=jteacher))(params)
    t, z = _jax_draws(key, 2)
    val = tl.value(tpre, _t(x), t, z, step, _t(cond), _t(aux), teacher=tteacher)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    _assert_grads(tpre, _grads_by_name(jg))
    if tteacher is not None:
        assert all(p.grad is None for p in tteacher.parameters())


def test_scm_jvp_term_runs_no_graph():
    """The tangent term is computed without recording autograd (the JAX
    package stop-gradients it): it carries no graph and leaves no
    parameter gradient."""
    _, _, tpre = _pair("d12", seed=57)
    x, cond, _, aux = _batch(58)
    _, tl = _scm_losses(None, 0)
    t, z = tl.draw(_t(x), torch.Generator().manual_seed(0))
    dF = tl.jvp_term(tpre, t, *tl.interpolate(_t(x), t, z), _t(cond), _t(aux))
    assert dF.shape == x.shape and dF.grad_fn is None and torch.isfinite(dF).all()
    assert all(p.grad is None for p in tpre.parameters())
