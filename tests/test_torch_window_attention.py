"""The port's per-head window attention (kernels 21, 22b, 22t), the per-head
route of the model, the route change for geometries the fixed-window
kernels cannot hold, and kernel 20, against the JAX package on the CPU.

* The plain versions of the attention core: ``reference_window_attention``
  against the JAX package's; ``reference_sdpa`` (kernel 21),
  ``reference_sdpa_bwd`` (22b) and ``reference_sdpa_tangent`` (22t), with
  their products' operands rounded to bf16 as the TPU kernels round them,
  against ``_sdpa``, its vjp and ``_sdpa_tangent_call`` in interpret mode,
  at the JAX tests' shape (4, 2, 32, 16), path A's (8, 4, 4, 8),
  (2, 3, 64, 88) and the card's tile forms (n 36, 100, d 160, and kernel
  22b's one key tile at n 128); at n 257, (2, 2, 96, 160) and n 129 (22b's
  two walks), where XLA and PyTorch round a few ties of p and dS to other
  bf16 values, the ties counted and each framework's outputs held to the
  products of its own rounded p and dS.
* ``fused_window_attention`` under autograd and under ``forward_ad`` against
  ``torch.func.vjp`` / ``torch.func.jvp`` of the plain version, and
  ``per_head_window_attention`` against the JAX model's
  ``WindowAttention._per_head_path`` for the same qkv.
* A tiny ``SwinV2`` with the ``synthetic-tiny-scm`` geometry (dim 32, 4
  heads of 8, 2×2 windows, shift (1, 1), patch 2, 8×16 image): forward,
  every parameter gradient and the jvp tangent against the JAX model, and
  ``SCMLoss``; a tiny model on 8×8 windows, which the JAX model routes to
  its tiled kernels and the port to the per-head ones.
* The route change, the SwiGLU hidden padding (H = 85) and kernel 20's plain
  version against ``fused_swiglu_ffn_modnorm`` interpreted and against the
  composition of the JAX plain versions.

fp32 from numpy seeds. Tolerances: 2e-5 for the attention core and the
FFN epilogue (fp32 sums in other orders), 1e-4 for the core's gradients
and tangent with the TPU kernels' bf16 rounding points (a last-bit
difference of exp can move one rounding); 2e-4 for gradients of kernel 20
(the JAX test's); rtol 1e-4 for the model, its gradients and tangent (fp32
through two blocks), 1e-5 for the loss value; the padding is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch.autograd import forward_ad

import swift_tpu.ops.pallas_attention as pa
import swift_tpu.ops.pallas_block_attention as pba
import swift_tpu.ops.pallas_ffn as pffn
import swift_tpu.ops.pallas_modnorm as pmn
from swift_torch.models import convert
from swift_torch.models.precond import PassPrecond as TorchPassPrecond
from swift_torch.models.swinv2 import SwinV2 as TorchSwinV2
from swift_torch.ops import block_attention, ffn, modnorm, window_attention
from swift_tpu.models.precond import PassPrecond
from swift_tpu.models.swinv2 import SwinV2, WindowAttention
from tests.test_torch_jvp import _scm_losses
from tests.test_torch_train import (
    C,
    F_,
    RES,
    _assert_grads,
    _batch,
    _grads_by_name,
    _jax_draws,
)

TOL = 2e-5
BF16_STEP_TOL = 1e-4  # see test_sdpa_plain_versions_match_pallas
# the JAX tests' shape, path A's, path B's width at n 64; then shapes of kernel 21's tile forms
# on the card: n 36 (64 ∤ n: a 64-row box crosses window-heads), n 100 (query tiles that cross
# window-heads), d 160
SHAPES = [(4, 2, 32, 16), (8, 4, 4, 8), (2, 3, 64, 88), (4, 2, 36, 16), (2, 2, 100, 8),
          (2, 2, 64, 160)]
# n 257 (the online softmax on the card) in the fp32 comparisons; it and (2, 2, 96, 160) hold
# rounding ties of p and dS that XLA and PyTorch break differently, which
# test_sdpa_plain_versions_differ_from_pallas_only_at_ties shows
LONG_SHAPES = [(1, 2, 257, 8)]
# the boundaries of kernel 22b's forms on the card: n 128, one key tile of its query pass (at d
# 88 a dS that cancels in dp − Σ p·dp rounds to another bf16 value in XLA and PyTorch, 0.7-1.7%
# off a midpoint, which neither test below admits, so n 128 is held at d 64), and n 129, its
# statistics walk over two key tiles, where a few ties of p and dS break differently
BWD_ONE_TILE_SHAPES = [(2, 2, 128, 64)]
BWD_TWO_WALK_SHAPES = [(1, 2, 129, 88)]
TIE_SHAPES = [(1, 2, 257, 8), (2, 2, 96, 160)]
# kernel 22t's row form on the card: two walks over key tiles of 64 (d <= 128) or 32 (d 160);
# its plain version alone, as the forward and backward above miss there; at (1, 2, 96, 160) a
# few ties of p and dP break differently in XLA and PyTorch (the tie test)
TANGENT_TWO_WALK_SHAPES = [(1, 2, 129, 88), (1, 2, 257, 8), (1, 2, 129, 160)]
TANGENT_TIE_SHAPES = [(1, 2, 96, 160)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Force the Pallas interpreter off-TPU (as tests/test_pallas_*.py do)."""
    if jax.default_backend() != "tpu":
        orig = pl.pallas_call
        for mod in (pa, pffn):
            monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol=TOL, err_msg=""):
    got = got.detach() if hasattr(got, "detach") else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=err_msg)


def _normalized(rng, shape):
    """q̂ (normalised, times a scale near e) and k̂ (normalised) as the
    kernels receive them, and v."""
    q, k, v = (_rand(rng, shape) for _ in range(3))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True) * np.float32(2.7)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    return q, k, v


# -- the attention core: plain versions against the Pallas kernels ----------------

@pytest.mark.parametrize("shape", SHAPES + LONG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_window_attention_matches_jax(shape):
    rng = np.random.default_rng(80)
    q, k, v = (_rand(rng, shape) for _ in range(3))
    scale = np.exp(_rand(rng, (shape[1],), 0.1) + 1.0)
    want = pa.reference_window_attention(*map(jnp.asarray, (q, k, v, scale)))
    _close(window_attention.reference_window_attention(*map(_t, (q, k, v, scale))), want)


@pytest.mark.parametrize("shape", SHAPES + BWD_ONE_TILE_SHAPES + TANGENT_TWO_WALK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_sdpa_plain_versions_match_pallas(shape):
    """Kernels 21, 22b and 22t's plain versions with bf16 operand rounding
    (the TPU kernels round to bf16 whatever their input type) against the
    Pallas calls interpreted, fp32 in and out. The inputs are multiples of
    2^-6 (q̂, k̂) and 2^-4 (the others) of a few bits, so that every logit,
    dp and tangent logit is an exact fp32 sum in either framework: XLA and
    PyTorch sum the 88 terms of a d = 88 product in other orders, and a
    last-bit difference there can round p or dP to the neighbouring bf16
    value (a 2^-8 relative step) where the kernels round them. XLA's and
    PyTorch's exp still differ in the last bit now and then, which can move
    one bf16 rounding of dS or dP: the gradients and the tangent are held
    at 1e-4 (two such moves in 33,792 outputs read 2.4e-5 at d = 88), the
    forward at 2e-5. At ``TANGENT_TWO_WALK_SHAPES`` the tangent alone."""
    q, k, v, do, dq, dk, dv = _few_bit_inputs(shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    bf = torch.bfloat16

    if shape not in TANGENT_TWO_WALK_SHAPES:
        _close(window_attention.reference_sdpa(_t(q), _t(k), _t(v), mm=bf),
               pa._sdpa(jq, jk, jv), err_msg="forward")
        _, vjp = jax.vjp(pa._sdpa, jq, jk, jv)
        got = window_attention.reference_sdpa_bwd(_t(q), _t(k), _t(v), _t(do), mm=bf)
        for g, w, name in zip(got, vjp(jnp.asarray(do)), ("dq", "dk", "dv")):
            _close(g, w, BF16_STEP_TOL, err_msg=name)
    want = pa._sdpa_tangent_call(jq, jk, jv, *map(jnp.asarray, (dq, dk, dv)))
    _close(window_attention.reference_sdpa_tangent(*map(_t, (q, k, v, dq, dk, dv)), mm=bf), want,
           BF16_STEP_TOL, err_msg="tangent")


def _few_bit_inputs(shape):
    """q̂, k̂ (multiples of 2^-6) and v, do, dq, dk, dv (of 2^-4, |x| <= 4):
    every logit, dp and tangent logit an exact fp32 sum."""
    rng = np.random.default_rng(81)
    q, k = (np.round(a * 64) / 64 for a in _normalized(rng, shape)[:2])
    rest = (np.round(np.clip(_rand(rng, shape), -4, 4) * 16) / 16 for _ in range(5))
    return (q, k, *rest)


@pytest.mark.parametrize("shape", TIE_SHAPES + BWD_TWO_WALK_SHAPES + TANGENT_TIE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_sdpa_plain_versions_differ_from_pallas_only_at_ties(shape):
    """Where test_sdpa_plain_versions_match_pallas's limits do not hold:
    the forward at (1, 2, 257, 8) and dk at (2, 2, 96, 160). XLA's fp32 p,
    and so dS = p (dp − Σ p·dp), differ from PyTorch's by a few ulps (its
    exp is less exact), and a value of p or dS that lies on a bf16
    rounding tie to within that rounds to neighbouring bf16 values in the
    two frameworks. This holds the cause: p and dS by the Pallas kernels'
    formulas in jnp and by the plain versions' in torch, from the same
    exact logits and dp, round to bf16 alike but at a few ties (each within
    1e-4 of a midpoint, relative, in fp64); the Pallas outputs are the
    products of JAX's rounded p and dS, the plain outputs those of
    PyTorch's, both to 2e-5 (``-s`` prints the counts). At
    ``TANGENT_TIE_SHAPES`` the same for kernel 22t's tangent: dp is there
    the tangent logit dS = dq̂·k̂ᵀ + q̂·dk̂ᵀ, the rounded p·(dS − Σ p·dS) is dP,
    and the outputs are bf16(dP)·v + bf16(p)·dv."""
    q, k, v, do, dq, dk, dv = _few_bit_inputs(shape)
    tangent = shape in TANGENT_TIE_SHAPES
    kt = lambda a: np.swapaxes(a, -1, -2)  # noqa: E731
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16().float().numpy()  # noqa: E731
    s64 = q.astype(np.float64) @ kt(k).astype(np.float64)
    if tangent:
        dp = (dq.astype(np.float64) @ kt(k).astype(np.float64)
              + q.astype(np.float64) @ kt(dk).astype(np.float64)).astype(np.float32)
    else:
        dp = (do.astype(np.float64) @ kt(v).astype(np.float64)).astype(np.float32)
    s = s64.astype(np.float32)  # exact, as is dp
    pj, pt, dpt = pa._softmax_rows(jnp.asarray(s)), torch.softmax(torch.from_numpy(s), -1), _t(dp)
    ps = {"jax": np.asarray(pj), "torch": pt.numpy()}
    dss = {"jax": np.asarray(pj * (dp - jnp.sum(pj * dp, axis=-1, keepdims=True))),
           "torch": (pt * (dpt - torch.sum(pt * dpt, -1, keepdim=True))).numpy()}
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    p64 /= p64.sum(-1, keepdims=True)
    ds64 = p64 * (dp - np.sum(p64 * dp, -1, keepdims=True))
    ties = {}
    for name, (a, b, x64) in {"p": (ps["jax"], ps["torch"], p64),
                              "dS": (dss["jax"], dss["torch"], ds64)}.items():
        ra, rb = bf(a), bf(b)
        at = ra != rb
        mid = (ra[at] + rb[at]) / 2
        r64 = bf(x64)[at]
        ties[name] = (int(at.sum()), at.size,
                      float(np.max(np.abs(x64[at] - mid) / np.abs(x64[at]), initial=0.0)),
                      int(np.sum(r64 == ra[at])), int(np.sum(r64 == rb[at])))
        assert ties[name][0] <= 4 and ties[name][2] < 1e-4, (name, ties[name])
    print(f"{shape}: bf16 roundings that differ (count, of, max |x64 - midpoint| / |x64|, "
          f"fp64 rounds as JAX, as PyTorch): {ties}")

    def products(p, ds):
        if tangent:
            return (bf(ds) @ bf(v) + bf(p) @ bf(dv),)
        return (bf(p) @ v, bf(ds) @ bf(k), kt(bf(ds)) @ bf(q), kt(bf(p)) @ bf(do))

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    mm = torch.bfloat16
    if tangent:
        names = ("tangent",)
        pallas = [pa._sdpa_tangent_call(jq, jk, jv, *map(jnp.asarray, (dq, dk, dv)))]
        plain = [window_attention.reference_sdpa_tangent(*map(_t, (q, k, v, dq, dk, dv)), mm=mm)]
    else:
        names = ("o", "dq", "dk", "dv")
        _, vjp = jax.vjp(pa._sdpa, jq, jk, jv)
        pallas = [pa._sdpa(jq, jk, jv), *vjp(jnp.asarray(do))]
        plain = [window_attention.reference_sdpa(_t(q), _t(k), _t(v), mm=mm),
                 *window_attention.reference_sdpa_bwd(_t(q), _t(k), _t(v), _t(do), mm=mm)]
    for got, want, name in zip(products(ps["jax"], dss["jax"]), pallas, names):
        _close(got, want, err_msg=f"Pallas {name}")
    for got, want, name in zip(products(ps["torch"], dss["torch"]), plain, names):
        _close(got, want, err_msg=f"plain {name}")


def test_sdpa_plain_versions_are_the_derivatives():
    """In fp32 (no rounding) the plain backward is the vjp and the plain
    tangent the jvp of the plain forward."""
    rng = np.random.default_rng(82)
    q, k, v = map(_t, _normalized(rng, (2, 3, 24, 16)))
    do, dq, dk, dv = (_t(_rand(rng, (2, 3, 24, 16))) for _ in range(4))
    out, vjp = torch.func.vjp(window_attention.reference_sdpa, q, k, v)
    grads = window_attention.reference_sdpa_bwd(q, k, v, do)
    for g, w in zip(grads, vjp(do)):
        _close(g, w)
    _, tangent = torch.func.jvp(window_attention.reference_sdpa, (q, k, v), (dq, dk, dv))
    _close(window_attention.reference_sdpa_tangent(q, k, v, dq, dk, dv), tangent)


@pytest.mark.parametrize("shape", SHAPES + LONG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_window_attention_autograd_and_forward_ad(shape):
    """The wrapper on CPU tensors: its Function (backward = the plain 22b)
    against torch.func.vjp of the plain version, its forward_ad route (the
    plain 22t) against torch.func.jvp, and the JAX gradients of the same
    function. No launch is counted on the CPU."""
    rng = np.random.default_rng(83)
    q, k, v, do, tq, tk, tv = (_rand(rng, shape) for _ in range(7))
    scale = np.exp(_rand(rng, (shape[1],), 0.1) + 1.0)
    counts = (window_attention.window_attention.launches,
              window_attention.window_attention_bwd.launches,
              window_attention.window_attention_tangent.launches)
    ts = _t(scale)

    args = [_t(a, True) for a in (q, k, v, scale)]
    out = window_attention.fused_window_attention(*args)
    out.backward(_t(do))
    want, vjp = torch.func.vjp(window_attention.reference_window_attention,
                               *map(_t, (q, k, v, scale)))
    _close(out, want)
    for a, w in zip(args, vjp(_t(do))):
        _close(a.grad, w, 1e-4 if a is args[3] else TOL)
    _, jvjp = jax.vjp(pa.reference_window_attention, *map(jnp.asarray, (q, k, v, scale)))
    for a, w in zip(args, jvjp(jnp.asarray(do))):
        _close(a.grad, w, 2e-4)

    with torch.no_grad(), forward_ad.dual_level():
        duals = [forward_ad.make_dual(_t(a), _t(t)) for a, t in ((q, tq), (k, tk), (v, tv))]
        tangent = forward_ad.unpack_dual(
            window_attention.fused_window_attention(*duals, ts)).tangent.clone()
    _, want = torch.func.jvp(
        lambda a, b, c: window_attention.reference_window_attention(a, b, c, ts),
        tuple(map(_t, (q, k, v))), tuple(map(_t, (tq, tk, tv))))
    _close(tangent, want)
    assert counts == (window_attention.window_attention.launches,
                      window_attention.window_attention_bwd.launches,
                      window_attention.window_attention_tangent.launches)


def test_scale_tangent_raises():
    rng = np.random.default_rng(84)
    q, k, v = (_t(_rand(rng, (2, 2, 8, 8))) for _ in range(3))
    with torch.no_grad(), forward_ad.dual_level():
        scale = forward_ad.make_dual(torch.ones(2), torch.ones(2))
        with pytest.raises(NotImplementedError, match=r"fused_window_attention.*\['scale'\]"):
            window_attention.fused_window_attention(q, k, v, scale)


# -- the per-head route against SwinV2._per_head_path -------------------------------

@pytest.mark.parametrize("window,shift", [((2, 2), (1, 1)), ((4, 4), (2, 2))])
def test_per_head_route_matches_jax_per_head_path(window, shift):
    """qkv (2, 8, 16, heads·3·d) through the port's per-head route and the
    JAX model's ``_per_head_path`` with its jnp attention core: shift,
    partition, head split, attention, inverse layout, un-shift."""
    heads, d = 4, 8
    rng = np.random.default_rng(85)
    qkv = _rand(rng, (2, 8, 16, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.1) + 1.0)
    module = WindowAttention(heads * d, heads, d, window, shift, dtype=jnp.float32)

    def core(q, k, v, s, **kw):
        return pa.reference_window_attention(q, k, v, s)

    want = module.apply({}, jnp.asarray(qkv), jnp.asarray(scale), False, core,
                        method=WindowAttention._per_head_path)
    got = block_attention.per_head_window_attention(_t(qkv), _t(scale), heads, window, shift)
    _close(got, want)


# -- the model on the per-head route ---------------------------------------------------

TINY = dict(window_size=(2, 2), shift_size=(1, 1), patch_size=(2, 2), depth=2, dim=32,
            heads=4, auxiliary_dim=1, logvar=True)  # synthetic-tiny-scm's model
WIN8 = dict(TINY, window_size=(8, 8), shift_size=(4, 4))  # 8×8 windows on a 16×32 token grid
WIN8_RES = (32, 64)


def _pair(seed, model=TINY, res=RES):
    kw = dict(img_resolution=res, in_channels=2 * C + F_, out_channels=C, **model)
    jpre = PassPrecond(model=SwinV2(**kw, dtype=jnp.float32), img_resolution=res,
                       img_channels=C, condition_channels=C + F_, auxiliary_dim=1)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32) + np.asarray(a),
        jpre.init(jax.random.PRNGKey(seed)))
    tpre = TorchPassPrecond(TorchSwinV2(**kw, dtype=torch.float32), res, C,
                            condition_channels=C + F_, auxiliary_dim=1)
    tpre.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.params_to_state_dict(params).items()})
    return jpre, params, tpre


def _batch_at(seed, res, B=2):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (B, *res, C)), _rand(rng, (B, *res, C + F_)),
            rng.uniform(0.1, 1.5, (B,)).astype(np.float32),
            rng.uniform(0.5, 2.5, (B, 1)).astype(np.float32))


def _routes(tpre):
    m = tpre.model
    return [block_attention.attention_route(m.grid_size, a.window_size, a.shift, a.heads,
                                            a.heads * a.head_dim)
            for a, _ in m.transformer.layers]


@pytest.mark.parametrize("model,res", [(TINY, RES), (WIN8, WIN8_RES)], ids=["tiny", "win8"])
def test_per_head_swinv2_matches_jax(model, res):
    """Forward and every parameter gradient of a loss on the output and the
    logvar head, against jax.value_and_grad of the JAX model (its jnp path on
    the CPU). The tiny model takes the per-head route in both packages; the
    8×8-window model the per-head route in the port only (the JAX gates say
    block for the unshifted block and tiled for the shifted one)."""
    jpre, params, tpre = _pair(90, model, res)
    assert _routes(tpre) == ["per_head", "per_head"]
    x, cond, t, aux = _batch_at(91, res)
    rng = np.random.default_rng(92)
    w_out, w_lv = _rand(rng, (2, *res, C)), _rand(rng, (2,))

    def jloss_fn(p):
        out, lv = jpre.apply(p, x, t, condition=cond, auxiliary=aux, return_logvar=True)
        return jnp.sum(out * w_out) + jnp.sum(lv * w_lv)

    jl, jg = jax.value_and_grad(jloss_fn)(params)
    out, lv = tpre(_t(x), _t(t), _t(cond), _t(aux), return_logvar=True)
    loss = (out * _t(w_out)).sum() + (lv * _t(w_lv)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_grads(tpre, _grads_by_name(jg))


def test_per_head_swinv2_tangent_matches_jax_jvp():
    jpre, params, tpre = _pair(93)
    x, cond, t, aux = _batch(94)
    rng = np.random.default_rng(95)
    vx, vt = _rand(rng, x.shape), _rand(rng, t.shape)

    def f(xi, ti):
        return jpre.apply(params, xi, ti, jnp.asarray(cond), jnp.asarray(aux), jvp=True)

    jout, jdout = jax.jvp(f, (jnp.asarray(x), jnp.asarray(t)), (jnp.asarray(vx), jnp.asarray(vt)))
    with torch.no_grad(), forward_ad.dual_level():
        out = tpre(forward_ad.make_dual(_t(x), _t(vx)), forward_ad.make_dual(_t(t), _t(vt)),
                   _t(cond), _t(aux), jvp=True)
        out, dout = (a.clone() for a in forward_ad.unpack_dual(out)[:2])
    for got, want, name in ((out, jout, "primal"), (dout, jdout, "tangent")):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_per_head_scm_loss_matches_jax():
    """SCMLoss at r = 1 (no warmup) on the per-head model: value at 1e-5 and
    every gradient at rtol 1e-4 against the JAX loss with its draws."""
    jpre, params, tpre = _pair(96)
    x, cond, _, aux = _batch(97)
    key = jax.random.PRNGKey(98)
    jl, tl = _scm_losses(jpre, 0)
    jval, jg = jax.value_and_grad(
        lambda p: jl(p, key, jnp.asarray(x), jnp.float32(400.0), condition=jnp.asarray(cond),
                     auxiliary=aux))(params)
    t, z = _jax_draws(key, 2)
    val = tl.value(tpre, _t(x), t, z, 400.0, _t(cond), _t(aux))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    _assert_grads(tpre, _grads_by_name(jg))


# -- the route change: geometries the fixed-window kernels cannot hold ---------------

@pytest.mark.parametrize("grid,window,shift,heads,d,jax_route", [
    ((64, 128), (8, 8), (4, 4), 12, 88, "tiled"),    # the flagship width on 8×8 windows
    ((64, 128), (16, 16), (8, 8), 8, 160, "block"),  # d = 160
])
def test_route_departs_from_jax_where_kernels_refuse(grid, window, shift, heads, d, jax_route):
    inner = heads * d
    jblock = pba.block_attention_eligible(grid, window, shift, heads, inner)
    jtiled = pba.tiled_block_attention_eligible(grid, window, heads, inner)
    assert ("block" if jblock else "tiled" if jtiled else "per_head") == jax_route
    assert not block_attention.fixed_window_kernels_accept(window, heads, inner)
    assert block_attention.attention_route(grid, window, shift, heads, inner) == "per_head"


# -- the SwiGLU hidden padding and kernel 20 -------------------------------------------

def _ffn_inputs(seed, B=2, N=64, D=32, H=85):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (B, N, D)), _rand(rng, (2 * H, D), 0.1), _rand(rng, (D, H), 0.1),
            1.0 + _rand(rng, (D,), 0.1), _rand(rng, (D,), 0.1), _rand(rng, (B, D), 0.2),
            _rand(rng, (B, D), 0.2))


def test_hidden_padding_is_exact():
    """H = 85 (int(8/3·32)) padded to 88: the plain FFN, its saved and
    recompute backwards and the autograd gradient through the padding equal
    the unpadded ones bit for bit."""
    x, w1, w2 = map(_t, _ffn_inputs(100)[:3])
    w1p, w2p = ffn.pad_hidden(w1, w2)
    assert w1p.shape == (176, 32) and w2p.shape == (32, 88)
    assert ffn.pad_hidden(w1p, w2p)[0] is w1p
    assert torch.equal(ffn.reference_swiglu_ffn(x, w1p, w2p), ffn.reference_swiglu_ffn(x, w1, w2))
    dy = torch.ones_like(x) * 0.3 + x
    # the saved route as the card runs it: kernel 8's g and u at the padded width, zero in
    # the padded units, straight into kernel 9
    _, g, u = ffn.reference_swiglu_ffn_fwd_save(x, w1, w2)
    _, gp, up = ffn.reference_swiglu_ffn_fwd_save(x, w1p, w2p)
    assert torch.equal(gp[..., :85], g) and not gp[..., 85:].any() and not up[..., 85:].any()
    saved = (lambda x, dy, w1, w2: ffn.reference_swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2),
             lambda x, dy, w1, w2: ffn.reference_swiglu_ffn_bwd_saved(x, dy, gp, up, w1, w2))
    for unpadded, padded in (saved, (ffn.reference_swiglu_ffn_bwd_recompute,) * 2):
        want = unpadded(x, dy, w1, w2)
        got = padded(x, dy, w1p, w2p)
        got = (got[0], *ffn._unpad_grads(got[1], got[2], 85))
        for g_, w in zip(got, want):
            assert torch.equal(g_, w)
    grads = []
    for pad in (False, True):
        a, b = w1.clone().requires_grad_(), w2.clone().requires_grad_()
        xx = x.clone().requires_grad_()
        ww = ffn.pad_hidden(a, b) if pad else (a, b)
        (ffn.reference_swiglu_ffn(xx, *ww) * dy).sum().backward()
        grads.append((xx.grad, a.grad, b.grad))
    for g, w in zip(*grads):
        assert torch.equal(g, w)


def test_ffn_modnorm_plain_matches_jax():
    """Kernel 20's plain version against ``fused_swiglu_ffn_modnorm``
    interpreted and against ``reference_modnorm_residual ∘
    reference_swiglu_ffn``, and its gradient (the wrapper's Function on CPU
    tensors) against jax.vjp of the Pallas entry, at the JAX test's shape
    (B 2, N 64, D 32, H 85)."""
    x, w1, w2, g, b, msc, msh = _ffn_inputs(101)
    jargs = (jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(w2.T)) + tuple(
        map(jnp.asarray, (g, b, msc, msh)))
    targs = [_t(a, True) for a in (x, w1, w2, g, b, msc, msh)]
    got = ffn.fused_swiglu_ffn_modnorm(*targs)
    want = pffn.fused_swiglu_ffn_modnorm(*jargs)
    _close(got, want)
    comp = pmn.reference_modnorm_residual(
        pffn.reference_swiglu_ffn(jargs[0], jargs[1], jargs[2]), jargs[0], *jargs[3:])
    _close(got, comp)
    assert torch.equal(ffn.reference_swiglu_ffn_modnorm(*(a.detach() for a in targs)),
                       ffn.reference_swiglu_ffn_modnorm(
                           targs[0].detach(), *ffn.pad_hidden(targs[1].detach(),
                                                              targs[2].detach()),
                           *(a.detach() for a in targs[3:])))

    dout = _rand(np.random.default_rng(102), x.shape)
    got.backward(_t(dout))
    _, vjp = jax.vjp(pffn.fused_swiglu_ffn_modnorm, *jargs)
    jg = list(vjp(jnp.asarray(dout)))
    jg[1], jg[2] = jg[1].T, jg[2].T  # the JAX (D, 2H), (H, D) layout
    for a, w, name in zip(targs, jg, ("dx", "dw1", "dw2", "dg", "db", "dscale", "dshift")):
        _close(a.grad, w, 2e-4, name)
    assert ffn.fused_swiglu_ffn_modnorm.launches == 0


@pytest.mark.parametrize("chunk", [None, 48], ids=["one-chunk", "chunks-of-48"])
def test_ffn_modnorm_two_launch_form_matches_jax(chunk, monkeypatch):
    """Kernel 20 as the card runs it, in plain form: kernel 5's first pass
    (``reference_swiglu_hidden``) for each chunk's h, then kernel 3's
    (``reference_matmul_modnorm_residual`` with the residual x) on each
    piece of ``ffn_modnorm_pieces``, token m of a piece taking the AdaLN row
    of sample a // N + m // N as kernel 3 does, against ``reference_swiglu_ffn_modnorm`` at 1e-5 and
    ``fused_swiglu_ffn_modnorm`` interpreted at the JAX test's shape (B 2, N
    64, D 32, H 85) at 2e-5; with ``FFN_CHUNK_TOKENS`` lowered to 48 the
    middle chunk straddles the samples' boundary and takes two pieces."""
    x, w1, w2, g, b, msc, msh = _ffn_inputs(103)
    if chunk:
        monkeypatch.setattr(ffn, "FFN_CHUNK_TOKENS", chunk)
    B, N, D = x.shape
    plan = ffn.ffn_modnorm_pieces(B * N, N)
    assert [len(p) for _, p in plan] == ([1] if chunk is None else [1, 2, 1])
    tx = _t(x)
    x2, out = tx.view(-1, D), torch.empty_like(tx).view(-1, D)
    w1p, w2p = ffn.pad_hidden(_t(w1), _t(w2))
    for (s, e), pieces in plan:
        h = ffn.reference_swiglu_hidden(x2[s:e], w1p)
        for a, z in pieces:  # kernel 3 takes token a + m's AdaLN row from a // N + m // N
            idx = a // N + torch.arange(z - a) // N
            out[a:z] = modnorm.reference_matmul_modnorm_residual(
                h[a - s:z - s, None], w2p, x2[a:z, None], _t(g), _t(b), _t(msc)[idx],
                _t(msh)[idx])[:, 0]
    got = out.view(B, N, D)
    _close(got, ffn.reference_swiglu_ffn_modnorm(*map(_t, (x, w1, w2, g, b, msc, msh))), 1e-5)
    jargs = (jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(w2.T)) + tuple(
        map(jnp.asarray, (g, b, msc, msh)))
    _close(got, pffn.fused_swiglu_ffn_modnorm(*jargs))
