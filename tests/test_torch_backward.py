"""The port's backward kernels' plain versions against the JAX package.

For each of kernels 6 (block attention backward), 8 (FFN forward saving
gate/up), 9 (FFN backward from them) and 13 (linear backward), and the
wrapper's route to kernel 10 above the save budget: the plain
PyTorch version against JAX's vjp of the Pallas function, run in interpret
mode on the CPU as the JAX package's own kernel tests run it, and against
``torch.autograd`` of the plain forward; the modnorm epilogues' Functions
(whose backward is the plain vjp, as in JAX) against JAX's vjp too. fp32
from numpy seeds, at small shapes with several token tiles, both head
widths and an odd window shift. Tolerance 2e-5 (rtol and atol): fp32 sums
over a few hundred terms in different orders, the bound ``test_torch_ops``
holds the forwards to. The ``cuda``-marked tests hold the backward kernels
(with 10 and 16 of the 0.25° path) to their plain versions on the card and
skip elsewhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import swift_tpu.ops.pallas_block_attention as pba
import swift_tpu.ops.pallas_ffn as pffn
import swift_tpu.ops.pallas_linear as plin
import swift_tpu.ops.pallas_modnorm as pmn
from swift_torch.ops import block_attention, ffn, linear, modnorm

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


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=err_msg)


def _autograd(fn, inputs, dout):
    """Gradients of sum(fn(*inputs) * dout) for every tensor input."""
    args = [_t(a, True) for a in inputs]
    torch.autograd.backward(fn(*args), _t(dout))
    return [a.grad for a in args]


# -- kernel 13: linear backward ------------------------------------------------

def test_linear_bwd_plain_matches_pallas_vjp():
    """384 tokens: three 128-token tiles of the TPU kernel's sequential dW sum."""
    rng = np.random.default_rng(10)
    x, w = _rand(rng, (3, 128, 48)), _rand(rng, (72, 48), 48 ** -0.5)  # w: (N, K)
    dy = _rand(rng, (3, 128, 72))
    _, vjp = jax.vjp(plin.fused_linear, jnp.asarray(x), jnp.asarray(w.T))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = linear.reference_linear_bwd(_t(dy), _t(x), _t(w))
    _close(dx, jdx, "dx")
    _close(dw, np.asarray(jdw).T, "dw")


def test_linear_bwd_plain_matches_autograd():
    rng = np.random.default_rng(11)
    x, w, dy = _rand(rng, (5, 40)), _rand(rng, (24, 40)), _rand(rng, (5, 24))
    want = _autograd(linear.reference_linear, (x, w), dy)
    got = linear.reference_linear_bwd(_t(dy), _t(x), _t(w))
    for g, wnt, name in zip(got, want, ("dx", "dw")):
        _close(g, wnt, name)
    # and the wrapper's Function routes its backward to it
    for g, wnt in zip(_autograd(linear.fused_linear, (x, w), dy), want):
        _close(g, wnt)


@pytest.mark.parametrize("tokens", [136, 256])
def test_linear_bwd_plain_matches_jax_at_flagship_widths(tokens):
    """The plain version kernel 13 is held to on the card, at the flagship's
    qkv widths (N 3168, K 1056), against JAX's vjp: at 256 tokens of the
    Pallas kernel (interpret mode), at 136, which no Pallas block tiles, of
    the ``jnp.dot`` the JAX model falls back to there. fp32, tolerance 2e-5
    (sums over 3168 and 136 terms in different orders)."""
    rng = np.random.default_rng(22)
    N, K = 3168, 1056
    x, w, dy = _rand(rng, (tokens, K)), _rand(rng, (N, K), K ** -0.5), _rand(rng, (tokens, N))
    fn = plin.fused_linear if tokens % 128 == 0 else jnp.dot
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w.T))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = linear.reference_linear_bwd(_t(dy), _t(x), _t(w))
    _close(dx, jdx, "dx")
    _close(dw, np.asarray(jdw).T, "dw")


# -- kernel 6: block attention backward ----------------------------------------

@pytest.mark.parametrize("heads,d", [(3, 8), (2, 12)], ids=["d8", "d12"])
@pytest.mark.parametrize("shift", [(0, 0), (3, 5)], ids=["noshift", "odd"])
def test_block_attention_bwd_plain_matches_pallas_vjp(heads, d, shift):
    """(3, 5) puts windows across the grid's wrap-around in both axes."""
    rng = np.random.default_rng(12)
    qkv = _rand(rng, (2, 8, 16, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.1) + 1.0)
    dout = _rand(rng, (2, 8, 16, heads * d))
    fn = lambda a, s: pba.fused_block_attention(a, s, heads, (4, 8), shift)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(qkv), jnp.asarray(scale))
    jdqkv, jds = vjp(jnp.asarray(dout))
    dqkv, ds = block_attention.reference_block_attention_bwd(
        _t(qkv), _t(scale), _t(dout), heads, (4, 8), shift)
    _close(dqkv, jdqkv, "dqkv")
    _close(ds, jds, "dscale")


@pytest.mark.parametrize("shift", [(0, 0), (3, 5)], ids=["noshift", "odd"])
def test_block_attention_bwd_plain_matches_autograd(shift):
    rng = np.random.default_rng(13)
    heads, d = 2, 8
    qkv = _rand(rng, (2, 8, 16, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.1) + 1.0)
    dout = _rand(rng, (2, 8, 16, heads * d))

    def fwd(a, s):
        return block_attention.reference_block_attention(a, s, heads, (4, 8), shift)

    want = _autograd(fwd, (qkv, scale), dout)
    got = block_attention.reference_block_attention_bwd(_t(qkv), _t(scale), _t(dout), heads,
                                                        (4, 8), shift)
    for g, wnt, name in zip(got, want, ("dqkv", "dscale")):
        _close(g, wnt, name)

    def wrapped(a, s):
        return block_attention.fused_block_attention(a, s, heads, (4, 8), shift)

    for g, wnt in zip(_autograd(wrapped, (qkv, scale), dout), want):
        _close(g, wnt)


@pytest.mark.parametrize("d", [88, 128], ids=["d88", "d128"])
def test_block_attention_bwd_plain_matches_pallas_vjp_at_kernel_windows(d):
    """The plain version of kernels 6 and 16 at the CUDA kernels' geometry:
    16x16 windows (256 queries and keys: the softmax the query pass splits
    across a cluster's two blocks, the sums over 256 queries the key pass
    keeps), on a 16x32 grid of two windows, against jax.vjp of
    ``fused_block_attention`` at a shift of (8, 8) that wraps on both axes
    and, unshifted, of ``fused_tiled_block_attention``, whose backward
    kernels run interpreted (d = 88 zero-padded to 128 lanes there)."""
    rng = np.random.default_rng(16 + d)
    heads = 2
    qkv = _rand(rng, (2, 16, 32, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.3) + np.log(10.0))  # around the logit scale's init
    dout = _rand(rng, (2, 16, 32, heads * d))
    for jfn, shift in ((pba.fused_block_attention, (8, 8)),
                       (pba.fused_tiled_block_attention, (0, 0))):
        fn = lambda a, s: jfn(a, s, heads, (16, 16), shift)  # noqa: E731
        _, vjp = jax.vjp(fn, jnp.asarray(qkv), jnp.asarray(scale))
        jdqkv, jds = vjp(jnp.asarray(dout))
        dqkv, ds = block_attention.reference_block_attention_bwd(
            _t(qkv), _t(scale), _t(dout), heads, (16, 16), shift)
        _close(dqkv, jdqkv, f"{jfn.__name__} dqkv")
        _close(ds, jds, f"{jfn.__name__} dscale")


# -- kernels 8 and 9: FFN forward that saves gate/up, backward from them -------

def _ffn_inputs(seed, T=384, D=32, H=40):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (T, D)), _rand(rng, (2 * H, D), D ** -0.5),  # torch layout
            _rand(rng, (D, H), H ** -0.5), _rand(rng, (T, D)))


def test_ffn_fwd_save_plain_matches_pallas():
    x, w1, w2, _ = _ffn_inputs(14)
    H = w2.shape[1]
    w1j = jnp.asarray(w1.T)
    jy, jg, ju = pffn._ffn_fwd_save_call(jnp.asarray(x), w1j[:, :H], w1j[:, H:],
                                         jnp.asarray(w2.T))
    y, g, u = ffn.reference_swiglu_ffn_fwd_save(_t(x), _t(w1), _t(w2))
    for got, want, name in ((y, jy, "y"), (g, jg, "g"), (u, ju, "u")):
        _close(got, want, name)


def test_ffn_bwd_saved_plain_matches_pallas_vjp():
    """384 tokens: the saved-activation route (≤ SWIFT_FFN_BWD_SAVE_MAX_TOKENS)
    over three 128-token tiles."""
    x, w1, w2, dy = _ffn_inputs(15)
    assert pffn._bwd_save_acts(x.shape[0])
    _, vjp = jax.vjp(pffn.fused_swiglu_ffn, jnp.asarray(x), jnp.asarray(w1.T),
                     jnp.asarray(w2.T))
    jdx, jdw1, jdw2 = vjp(jnp.asarray(dy))
    _, g, u = ffn.reference_swiglu_ffn_fwd_save(_t(x), _t(w1), _t(w2))
    dx, dw1, dw2 = ffn.reference_swiglu_ffn_bwd_saved(_t(x), _t(dy), g, u, _t(w1), _t(w2))
    _close(dx, jdx, "dx")
    _close(dw1, np.asarray(jdw1).T, "dw1")
    _close(dw2, np.asarray(jdw2).T, "dw2")


def test_ffn_bwd_saved_plain_matches_autograd():
    x, w1, w2, dy = _ffn_inputs(16, T=24)
    want = _autograd(ffn.reference_swiglu_ffn, (x, w1, w2), dy)
    _, g, u = ffn.reference_swiglu_ffn_fwd_save(_t(x), _t(w1), _t(w2))
    got = ffn.reference_swiglu_ffn_bwd_saved(_t(x), _t(dy), g, u, _t(w1), _t(w2))
    for gg, wnt, name in zip(got, want, ("dx", "dw1", "dw2")):
        _close(gg, wnt, name)
    for gg, wnt in zip(_autograd(ffn.fused_swiglu_ffn, (x, w1, w2), dy), want):
        _close(gg, wnt)


@pytest.mark.parametrize("tokens", [136, 256])
def test_ffn_bwd_saved_plain_matches_jax_at_flagship_widths(tokens):
    """The plain version kernel 9 is held to on the card, at the flagship's
    widths (D 1056, H 2816), against the JAX package's vjp rule
    (``_fused_swiglu_bwd``, the Pallas saved-activation backward in
    interpret mode) given the same residuals: x and the g and u of the
    plain kernel 8. 136 tokens, which no Pallas block tiles, go to it padded
    with zero tokens to 256, which add exact zeros to every sum. fp32,
    tolerance 2e-5 (sums over up to 5632 terms in different orders)."""
    x, w1, w2, dy = _ffn_inputs(23, T=tokens, D=1056, H=2816)
    H = w2.shape[1]
    _, g, u = ffn.reference_swiglu_ffn_fwd_save(_t(x), _t(w1), _t(w2))
    dx, dw1, dw2 = ffn.reference_swiglu_ffn_bwd_saved(_t(x), _t(dy), g, u, _t(w1), _t(w2))

    def pad(a):
        return jnp.pad(jnp.asarray(np.asarray(a)), ((0, -tokens % 128), (0, 0)))

    w1j = jnp.asarray(w1.T)
    jdx, jdwg, jdwu, jdw2 = pffn._fused_swiglu_bwd(
        (pad(x), pad(g), pad(u), w1j[:, :H], w1j[:, H:], jnp.asarray(w2.T)), pad(dy))
    _close(dx, np.asarray(jdx)[:tokens], "dx")
    _close(dw1, np.concatenate([np.asarray(jdwg), np.asarray(jdwu)], axis=1).T, "dw1")
    _close(dw2, np.asarray(jdw2).T, "dw2")


def test_ffn_bwd_saved_padded_hidden_matches_jax():
    """Path A's SwiGLU width H = 85 as the card runs it: the weights padded
    to 88 (``pad_hidden``), g and u of the padded plain kernel 8 (their
    padded units 0), the plain kernel 9 at 88 and the weight gradients cut
    back to 85 (``_unpad_grads``), against JAX's vjp of the Pallas FFN at H
    = 85 (interpret mode). fp32, tolerance 2e-5."""
    x, w1, w2, dy = _ffn_inputs(24, T=128, D=32, H=85)
    _, vjp = jax.vjp(pffn.fused_swiglu_ffn, jnp.asarray(x), jnp.asarray(w1.T),
                     jnp.asarray(w2.T))
    jdx, jdw1, jdw2 = vjp(jnp.asarray(dy))
    w1p, w2p = ffn.pad_hidden(_t(w1), _t(w2))
    assert w2p.shape[1] == 88
    _, g, u = ffn.reference_swiglu_ffn_fwd_save(_t(x), w1p, w2p)
    assert not g[:, 85:].any() and not u[:, 85:].any()
    dx, dw1p, dw2p = ffn.reference_swiglu_ffn_bwd_saved(_t(x), _t(dy), g, u, w1p, w2p)
    dw1, dw2 = ffn._unpad_grads(dw1p, dw2p, 85)
    _close(dx, jdx, "dx")
    _close(dw1, np.asarray(jdw1).T, "dw1")
    _close(dw2, np.asarray(jdw2).T, "dw2")


def test_ffn_backward_above_the_save_budget_raises(monkeypatch):
    """Above the budget the JAX package takes the recompute kernel 10 (the
    0.25° grid): the forward keeps only x (no gate/up leaves it) and the
    backward recomputes them, giving autograd's gradients of the plain
    forward. What raises there is a forward-mode tangent handed to the
    recompute backward, which has no tangent route."""
    monkeypatch.setenv("SWIFT_FFN_BWD_SAVE_MAX_TOKENS", "16")
    x, w1, w2, dy = _ffn_inputs(17, T=24)
    y = ffn.fused_swiglu_ffn(_t(x, True), _t(w1, True), _t(w2, True))
    assert type(y.grad_fn).__name__.startswith("_SwiGLURecompute")
    want = _autograd(ffn.reference_swiglu_ffn, (x, w1, w2), dy)
    for g, wnt, name in zip(_autograd(ffn.fused_swiglu_ffn, (x, w1, w2), dy), want,
                            ("dx", "dw1", "dw2")):
        _close(g, wnt, name)
    with pytest.raises(NotImplementedError, match="swiglu_ffn_bwd_recompute"):
        with torch.no_grad(), torch.autograd.forward_ad.dual_level():
            ffn.swiglu_ffn_bwd_recompute(torch.autograd.forward_ad.make_dual(_t(x), _t(dy)),
                                         _t(dy), _t(w1), _t(w2))
    with torch.no_grad():  # the forward alone is unaffected
        ffn.fused_swiglu_ffn(_t(x), _t(w1), _t(w2))


# -- the modnorm epilogues: backward = the plain vjp, as in JAX ----------------

def _epilogue(rng, B, D):
    return (1.0 + _rand(rng, (D,), 0.1), _rand(rng, (D,), 0.1),
            _rand(rng, (B, D), 0.2), _rand(rng, (B, D), 0.2))


def test_matmul_modnorm_bwd_matches_pallas_vjp():
    rng = np.random.default_rng(18)
    B, N, F, D = 2, 64, 24, 48
    x, w, r = _rand(rng, (B, N, F)), _rand(rng, (D, F), F ** -0.5), _rand(rng, (B, N, D))
    ep, dout = _epilogue(rng, B, D), _rand(rng, (B, N, D))
    fn = lambda x, w, *rest: pmn.fused_matmul_modnorm_residual(x, w.T, *rest)  # noqa: E731
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, w, r) + ep))
    want = vjp(jnp.asarray(dout))
    got = _autograd(modnorm.fused_matmul_modnorm_residual, (x, w, r) + ep, dout)
    for g, wnt, name in zip(got, want, ("x", "w", "residual", "g", "b", "scale", "shift")):
        _close(g, wnt, name)


def test_modnorm_bwd_matches_pallas_vjp():
    rng = np.random.default_rng(19)
    B, N, D = 3, 64, 48
    y, r = _rand(rng, (B, N, D), 2.0), _rand(rng, (B, N, D))
    ep, dout = _epilogue(rng, B, D), _rand(rng, (B, N, D))
    _, vjp = jax.vjp(pmn.fused_modnorm_residual, *map(jnp.asarray, (y, r) + ep))
    want = vjp(jnp.asarray(dout))
    got = _autograd(modnorm.fused_modnorm_residual, (y, r) + ep, dout)
    for g, wnt, name in zip(got, want, ("y", "residual", "g", "b", "scale", "shift")):
        _close(g, wnt, name)


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """Kernels 6, 8, 9 and 13 at the flagship shapes (12×88 and 8×128 heads,
    both window shifts), bf16, every output within 2e-2 of max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke

    record = chip_smoke.phase_kernels()
    for name in ("block_attention_bwd", "swiglu_ffn_fwd_save", "swiglu_ffn_bwd_saved",
                 "linear_bwd"):
        assert record[name]["max_abs_err"] >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,d", [(1000, 40), (136, 24)])
def test_backward_kernels_match_plain_at_ragged_shapes(tokens, d):
    """Edges the flagship never reaches: token counts that are no multiple
    of a tile (the split-K token ranges end mid-tile), N and D that are no
    multiples of 128, head dims padded to 64 and 32 in shared memory (32
    query rows a block at 64), several windows with a wrap-around shift.
    bf16 on the card, every output within 2e-2 of max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(20)

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", dtype)

    D, H, heads = 208, 264, 3
    x, dy = t((2, tokens // 2, D)), t((2, tokens // 2, D))
    w1, w2 = t((2 * H, D), D ** -0.5), t((D, H), H ** -0.5)
    qkv = t((2, 32, 48, heads * 3 * d))
    cases = [
        (linear.fused_linear_bwd, linear.reference_linear_bwd,
         (t((2, tokens // 2, 120)), x, t((120, D), D ** -0.5))),
        (ffn.swiglu_ffn_fwd_save, ffn.reference_swiglu_ffn_fwd_save, (x, w1, w2)),
        (ffn.swiglu_ffn_bwd_saved, ffn.reference_swiglu_ffn_bwd_saved,
         (x, dy, t((2, tokens // 2, H)), t((2, tokens // 2, H)), w1, w2)),
        (block_attention.block_attention_bwd, block_attention.reference_block_attention_bwd,
         (qkv, torch.exp(t((heads,), 0.3, torch.float32) + 2.0), t((2, 32, 48, heads * d)),
          heads, (16, 16), (8, 40))),
    ]
    for fused, plain, args in cases:
        got, want = fused(*args), plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max().item()
            assert torch.isfinite(g).all() and err <= 2e-2 * w.float().abs().max().item(), (
                fused.__name__, err)


def _card_matches_plain(fused, plain, args):
    """Every output of ``fused`` within 2e-2 of max|plain| of ``plain`` on
    the same inputs, and two calls of ``fused`` equal bit for bit (no
    atomics: the splits are summed in a fixed order)."""
    got, want = fused(*args), plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= 2e-2 * w.float().abs().max().item(), (
            fused.__name__, err)
    again = fused(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), fused.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [136, 1000])
def test_backward_gemms_match_plain_at_flagship_widths(tokens):
    """Kernels 9 and 13 at the flagship's widths (D 1056, H 2816, so 2H
    5632; N 3168, K 1056) and few tokens: the MN-major tiles' leading
    offset between 64-wide boxes shows only past 64 columns, and at 1000
    tokens the weight gradients split the tokens, the last split ending
    inside a stage. bf16 on the card, every output within 2e-2 of
    max|plain|, two calls equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(25)

    def t(shape, scale=1.0):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", torch.bfloat16)

    D, H, N = 1056, 2816, 3168
    x, dy = t((tokens, D)), t((tokens, D))
    _card_matches_plain(linear.fused_linear_bwd, linear.reference_linear_bwd,
                        (t((tokens, N)), x, t((N, D), D ** -0.5)))
    _card_matches_plain(ffn.swiglu_ffn_bwd_saved, ffn.reference_swiglu_ffn_bwd_saved,
                        (x, dy, t((tokens, H)), t((tokens, H)), t((2 * H, D), D ** -0.5),
                         t((D, H), H ** -0.5)))


@pytest.mark.cuda
def test_ffn_bwd_saved_kernel_at_padded_hidden():
    """Kernel 9 at path A's SwiGLU width H = 85: the wrapper pads the
    weights to 88 and reads g and u at 88 wide, as kernel 8 gives them (the
    padded units 0), and cuts the weight gradients back to 85; against the
    plain version at 85. bf16 on the card, every output within 2e-2 of
    max|plain|, two calls equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(26)

    def t(shape, scale=1.0):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", torch.bfloat16)

    T, D, H = 128, 32, 85
    gate, up = (torch.nn.functional.pad(t((T, H)), (0, 3)) for _ in range(2))
    _card_matches_plain(
        ffn.swiglu_ffn_bwd_saved,
        lambda x, dy, g, u, w1, w2: ffn.reference_swiglu_ffn_bwd_saved(x, dy, g[:, :H], u[:, :H],
                                                                       w1, w2),
        (t((T, D)), t((T, D)), gate, up, t((2 * H, D), D ** -0.5), t((D, H), H ** -0.5)))


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,d", [(1000, 40), (40008, 24)])
def test_quarter_backward_kernels_match_plain_on_card(tokens, d):
    """Kernels 10 and 16 at edges the 0.25° grid never reaches: token counts
    that are no multiple of a tile and, at 40,008, two token chunks of
    kernel 10 (the last ending in a partial tile), D and H no multiples of 128, head
    dims padded in shared memory, several windows. bf16 on the card, every
    output within 2e-2 of max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(21)

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", dtype)

    D, H, heads = 208, 264, 3
    x, dy = t((2, tokens // 2, D)), t((2, tokens // 2, D))
    w1, w2 = t((2 * H, D), D ** -0.5), t((D, H), H ** -0.5)
    qkv = t((2, 32, 48, heads * 3 * d))
    cases = [
        (ffn.swiglu_ffn_bwd_recompute, ffn.reference_swiglu_ffn_bwd_recompute, (x, dy, w1, w2)),
        (block_attention.tiled_block_attention_bwd,
         block_attention.reference_block_attention_bwd,
         (qkv, torch.exp(t((heads,), 0.3, torch.float32) + 2.0), t((2, 32, 48, heads * d)),
          heads, (16, 16))),
    ]
    for fused, plain, args in cases:
        got, want = fused(*args), plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max().item()
            assert torch.isfinite(g).all() and err <= 2e-2 * w.float().abs().max().item(), (
                fused.__name__, err)
        again = fused(*args)  # deterministic: no atomics, sums in a fixed order
        assert all(torch.equal(a, b) for a, b in zip(got, again)), fused.__name__
