"""swift_torch.ops against the JAX package.

Windows and embeddings against their jnp counterparts; the plain PyTorch
version of each of the five kernels against its Pallas kernel, run in
interpret mode on the CPU as the JAX package's own kernel tests run it. All
in fp32 from numpy seeds. Tolerances: 1e-5 for elementwise and layout ops
(fp32, equal op order); 2e-5 for the kernels (fp32 sums over up to a few
hundred terms in different orders -- the bound the JAX package's kernel
tests hold their kernels to). On CPU tensors a wrapper takes its plain
version and counts no launch; anything else goes to the kernel or raises.
The ``cuda``-marked tests hold the kernels to their plain versions on the
card (the forward kernels and, for the sCM jvp, the tangent kernels 14, 11,
12 and 7) and skip elsewhere.
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
from swift_torch.ops import block_attention, embeddings, ffn, linear, modnorm, windows
from swift_tpu.ops import embeddings as jembeddings
from swift_tpu.ops import windows as jwindows

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


@pytest.mark.parametrize("shift", [(0, 0), (2, 3), (-1, 5)])
def test_windows_match_jax(shift):
    x = _rand(np.random.default_rng(0), (2, 8, 12, 5))
    for win in ((4, 4), (2, 6)):
        want = jwindows.window_partition(jwindows.cyclic_shift(jnp.asarray(x), shift), win)
        got = windows.window_partition(windows.cyclic_shift(_t(x), shift), win)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)
        back = windows.window_reverse(got, win, (8, 12))
        np.testing.assert_allclose(
            back.numpy(), np.asarray(jwindows.window_reverse(want, win, (8, 12))), atol=0)


@pytest.mark.parametrize("dim", [32, 33, 1056])
def test_timestep_embedding_matches_jax(dim):
    t = np.random.default_rng(1).uniform(0.0, 1.6, (5,)).astype(np.float32)
    want = jembeddings.timestep_embedding(jnp.asarray(t), dim)
    got = embeddings.timestep_embedding(_t(t), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_linear_plain_matches_pallas():
    rng = np.random.default_rng(2)
    x, w = _rand(rng, (2, 8, 16, 48)), _rand(rng, (72, 48), 48 ** -0.5)  # w: (N, K)
    want = plin.fused_linear(jnp.asarray(x), jnp.asarray(w.T))
    got = linear.fused_linear(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shift", [(0, 0), (2, 8), (6, 12)])
def test_block_attention_plain_matches_pallas(shift):
    """(2, 8) and (6, 12) put windows across the grid's wrap-around."""
    rng = np.random.default_rng(3)
    heads, d = 3, 8
    qkv = _rand(rng, (2, 8, 16, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.1) + 1.0)
    want = pba.fused_block_attention(jnp.asarray(qkv), jnp.asarray(scale), heads, (4, 8), shift)
    got = block_attention.fused_block_attention(_t(qkv), _t(scale), heads, (4, 8), shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _epilogue(rng, B, D):
    return (1.0 + _rand(rng, (D,), 0.1), _rand(rng, (D,), 0.1),
            _rand(rng, (B, D), 0.2), _rand(rng, (B, D), 0.2))


def test_matmul_modnorm_plain_matches_pallas():
    rng = np.random.default_rng(4)
    B, N, F, D = 2, 64, 24, 48
    x, w, r = _rand(rng, (B, N, F)), _rand(rng, (D, F), F ** -0.5), _rand(rng, (B, N, D))
    ep = _epilogue(rng, B, D)
    want = pmn.fused_matmul_modnorm_residual(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(r),
                                             *map(jnp.asarray, ep))
    got = modnorm.fused_matmul_modnorm_residual(_t(x), _t(w), _t(r), *map(_t, ep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_modnorm_plain_matches_pallas():
    rng = np.random.default_rng(5)
    B, N, D = 3, 64, 48
    y, r = _rand(rng, (B, N, D), 2.0), _rand(rng, (B, N, D))
    ep = _epilogue(rng, B, D)
    want = pmn.fused_modnorm_residual(jnp.asarray(y), jnp.asarray(r), *map(jnp.asarray, ep))
    got = modnorm.fused_modnorm_residual(_t(y), _t(r), *map(_t, ep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_swiglu_ffn_plain_matches_pallas():
    rng = np.random.default_rng(6)
    D, H = 32, 40
    x = _rand(rng, (256, D))
    w1, w2 = _rand(rng, (2 * H, D), D ** -0.5), _rand(rng, (D, H), H ** -0.5)  # torch layout
    want = pffn.fused_swiglu_ffn(jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(w2.T))
    got = ffn.fused_swiglu_ffn(_t(x), _t(w1), _t(w2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


WRAPPERS = {
    "linear": (linear.fused_linear, lambda d: (d(4, 16), d(8, 16))),
    "block_attention": (block_attention.fused_block_attention,
                        lambda d: (d(1, 16, 16, 3 * 16), d(1), 1, (16, 16))),
    "matmul_modnorm": (modnorm.fused_matmul_modnorm_residual,
                       lambda d: (d(1, 4, 16), d(16, 16), d(1, 4, 16), d(16), d(16),
                                  d(1, 16), d(1, 16))),
    "modnorm": (modnorm.fused_modnorm_residual,
                lambda d: (d(1, 4, 16), d(1, 4, 16), d(16), d(16), d(1, 16), d(1, 16))),
    "ffn": (ffn.fused_swiglu_ffn, lambda d: (d(4, 16), d(16, 16), d(16, 8))),
    "linear_bwd": (linear.fused_linear_bwd, lambda d: (d(4, 8), d(4, 16), d(8, 16))),
    "block_attention_bwd": (block_attention.block_attention_bwd,
                            lambda d: (d(1, 16, 16, 3 * 16), d(1), d(1, 16, 16, 16), 1,
                                       (16, 16))),
    "ffn_fwd_save": (ffn.swiglu_ffn_fwd_save, lambda d: (d(4, 16), d(16, 16), d(16, 8))),
    "ffn_bwd_saved": (ffn.swiglu_ffn_bwd_saved,
                      lambda d: (d(4, 16), d(4, 16), d(4, 8), d(4, 8), d(16, 16), d(16, 8))),
}
FORWARDS = ("linear", "block_attention", "matmul_modnorm", "modnorm", "ffn")


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_device_routing(name):
    """CPU tensors take the plain version and launch nothing; tensors on any
    other device never do: they go to the kernel or raise."""
    fn, args = WRAPPERS[name]
    before = fn.launches
    fn(*args(lambda *s: torch.randn(*s)))
    assert fn.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args(lambda *s: torch.randn(*s, device="meta")))


@pytest.mark.parametrize("name", FORWARDS)
def test_wrapper_grad_routing(name):
    """While autograd records, a wrapper takes its autograd Function: on
    CPU tensors its forward and backward are the plain versions (no launch),
    and a tensor on any other device still goes to the kernel or raises."""
    fn, args = WRAPPERS[name]
    before = fn.launches
    cpu = [a.requires_grad_() if isinstance(a, torch.Tensor) else a
           for a in args(lambda *s: torch.randn(*s))]
    out = fn(*cpu)
    assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__
    out.sum().backward()
    assert all(a.grad is not None for a in cpu if isinstance(a, torch.Tensor))
    assert fn.launches == before
    meta = [a.requires_grad_() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
            for a in args(lambda *s: torch.randn(*s, device="meta"))]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*meta)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The chip smoke's kernel phase: all seventeen kernels at the flagship's
    shapes (12x88 and 8x128 heads, both window shifts; the tiled kernels on
    pre-rolled input) and the 0.25° path's four at its own, bf16, every
    output within 2e-2 of max|plain| (bf16 rounding of the outputs, p and
    dS)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke

    record = chip_smoke.phase_kernels()
    assert sorted(record) == sorted(chip_smoke.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,d", [(1000, 40), (136, 24)])
def test_kernels_match_plain_at_ragged_shapes(tokens, d):
    """Edges the flagship never reaches: token counts that are not a
    multiple of any tile, N and D that are not multiples of 128, head dims
    padded to 64 and 32 in shared memory, a grid of several windows with a
    wrap-around shift. bf16 on the card, within 2e-2 of max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(7)

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", dtype)

    D, H, heads = 208, 264, 3
    x, r = t((2, tokens // 2, D)), t((2, tokens // 2, D))
    ep = (1.0 + t((D,), 0.1, torch.float32), t((D,), 0.1, torch.float32),
          t((2, D), 0.2), t((2, D), 0.2))
    qkv = t((2, 32, 48, heads * 3 * d))
    scale = torch.exp(t((heads,), 0.3, torch.float32) + 2.0)
    cases = [
        (linear.fused_linear, linear.reference_linear, (x, t((3 * 40, D), D ** -0.5))),
        (modnorm.fused_matmul_modnorm_residual, modnorm.reference_matmul_modnorm_residual,
         (t((2, tokens // 2, 40)), t((D, 40), 40 ** -0.5), r, *ep)),
        (modnorm.fused_modnorm_residual, modnorm.reference_modnorm_residual, (x, r, *ep)),
        (ffn.fused_swiglu_ffn, ffn.reference_swiglu_ffn,
         (x, t((2 * H, D), D ** -0.5), t((D, H), H ** -0.5))),
        (block_attention.fused_block_attention, block_attention.reference_block_attention,
         (qkv, scale, heads, (16, 16), (8, 40))),
    ]
    for fused, plain, args in cases:
        got, want = fused(*args), plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all() and err <= 2e-2 * want.float().abs().max().item(), (
            fused.__name__, err)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,d", [(1000, 40), (136, 24)])
def test_tangent_kernels_match_plain_on_card(tokens, d):
    """Kernels 14, 11, 12 and 7 against their plain versions in bf16 on the
    card, every output within 2e-2 of max|plain|, at token counts that are
    no multiple of a tile (the stacked x/dx row blocks end mid-tile), N and
    D that are no multiples of 128, head dims padded to 64 and 32 in shared
    memory, a wrap-around shift. (The flagship shapes are
    :func:`test_kernels_match_plain_on_card`'s.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(59)

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", dtype)

    D, H, heads = 208, 264, 3
    x, dx = t((2, tokens // 2, D)), t((2, tokens // 2, D))
    ep = (1.0 + t((D,), 0.1, torch.float32), t((D,), 0.1, torch.float32), t((2, D), 0.2))
    cases = [
        (linear.linear_pt, linear.reference_linear_pt, (x, dx, t((120, D), D ** -0.5))),
        (ffn.swiglu_ffn_pt, ffn.reference_swiglu_ffn_pt,
         (x, dx, t((2 * H, D), D ** -0.5), t((D, H), H ** -0.5))),
        (modnorm.modnorm_residual_tangent, modnorm.reference_modnorm_residual_tangent,
         (t((2, tokens // 2, D), 3.0), dx, t((2, tokens // 2, D)), *ep, t((2, D), 0.2),
          t((2, D), 0.2))),
        (block_attention.block_attention_tangent,
         block_attention.reference_block_attention_tangent,
         (t((2, 32, 48, heads * 3 * d)), t((2, 32, 48, heads * 3 * d)),
          torch.exp(t((heads,), 0.3, torch.float32) + 2.0), heads, (16, 16), (8, 40))),
    ]
    for fused, plain, args in cases:
        got, want = fused(*args), plain(*args)
        torch.cuda.synchronize()
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        for g, w in zip(gots, wants):
            err = (g.float() - w.float()).abs().max().item()
            assert torch.isfinite(g).all() and err <= 2e-2 * w.float().abs().max().item(), (
                fused.__name__, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 24, 128])
def test_tiled_kernels_match_plain_and_the_whole_grid_kernels(d):
    """Kernels 15 and 17 against their plain versions in bf16 on the card
    (within 2e-2 of max|plain|) on a grid of several windows, head dims
    padded in shared memory; and, on qkv rolled by a wrap-around shift, bit
    for bit kernels 2 and 7 at that shift: the same arithmetic, the wrap
    taken by the roll instead of the index math."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(64)

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", dtype)

    heads, win, shift = 3, (16, 16), (8, 40)
    qkv, dqkv = t((2, 32, 48, heads * 3 * d)), t((2, 32, 48, heads * 3 * d))
    scale = torch.exp(t((heads,), 0.3, torch.float32) + 2.0)
    rolled, drolled = (torch.roll(a, (-8, -40), (1, 2)) for a in (qkv, dqkv))
    cases = [
        (block_attention.fused_tiled_block_attention,
         block_attention.reference_block_attention, (rolled, scale, heads, win)),
        (block_attention.tiled_block_attention_tangent,
         block_attention.reference_block_attention_tangent,
         (rolled, drolled, scale, heads, win)),
    ]
    for fused, plain, args in cases:
        got, want = fused(*args), plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all() and err <= 2e-2 * want.float().abs().max().item(), (
            fused.__name__, err)
    unroll = lambda a: torch.roll(a, shift, (1, 2))  # noqa: E731
    assert torch.equal(
        unroll(block_attention.fused_tiled_block_attention(rolled, scale, heads, win)),
        block_attention.fused_block_attention(qkv, scale, heads, win, shift))
    assert torch.equal(
        unroll(block_attention.tiled_block_attention_tangent(rolled, drolled, scale, heads, win)),
        block_attention.block_attention_tangent(qkv, dqkv, scale, heads, win, shift))
