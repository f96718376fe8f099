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
12 and 7; kernels 5, 8 and 11 also at ragged shapes, over several token
chunks, and 11's and 8's y against 5's bit for bit; the attention forward 2 and 15
over head dims, window shapes, wrapping shifts, zero rows and the main
paths' shapes, 15 on rolled qkv against 2 bit for bit; kernel 3 at the
shipped shapes and ragged M, D and K, two calls bit for bit; kernels 4 and
12 at D 16 to 16,384 over ragged samples, two calls bit for bit) and skip
elsewhere. ``modnorm_plan`` is checked on the CPU.
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


# The fixed-window kernels' own geometry (256-token windows): the flagship's 16x16 windows
# with d = 88 and oblong 8x32 windows with the 0.25° configuration's d = 128, at shifts that
# wrap on both axes of a 32x64 grid, B = 2.
KERNEL_GEOMETRY = [((16, 16), 88, (8, 8)), ((8, 32), 128, (4, 16))]


def _kernel_geometry_inputs(d, seed):
    rng = np.random.default_rng(seed)
    heads = 2
    qkv = _rand(rng, (2, 32, 64, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.3) + np.log(10.0))  # around the logit scale's init
    return heads, qkv, scale


@pytest.mark.parametrize("tiled", [False, True], ids=["whole_grid", "tiled"])
@pytest.mark.parametrize("window,d,shift", KERNEL_GEOMETRY, ids=["16x16_d88", "8x32_d128"])
def test_block_attention_plain_matches_pallas_at_kernel_geometry(window, d, shift, tiled):
    """The plain versions of kernels 2 and 15 (the wrappers on CPU tensors)
    against ``pba.fused_block_attention`` and ``fused_tiled_block_attention``
    interpreted, at the geometry the CUDA kernels take, in fp32 at TOL."""
    heads, qkv, scale = _kernel_geometry_inputs(d, 65 + d)
    jfn, tfn = ((pba.fused_tiled_block_attention, block_attention.fused_tiled_block_attention)
                if tiled else (pba.fused_block_attention, block_attention.fused_block_attention))
    want = jfn(jnp.asarray(qkv), jnp.asarray(scale), heads, window, shift)
    got = tfn(_t(qkv), _t(scale), heads, window, shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_block_attention_plain_matches_pallas_in_bf16():
    """The same at 16x16 windows, d = 88, shift (8, 8) with bf16 qkv, the
    kernels' working type: both round q̂·s, k̂ and p to bf16 before the
    products and the output to bf16, but sum in other orders, so a value
    near a rounding tie may round the other way: held to one bf16 step at
    max|out| (2^-7 max|out|, absolute). On the CPU 0.25% of the outputs
    differ, by one step at |out| < 0.5."""
    window, d, shift = KERNEL_GEOMETRY[0]
    heads, qkv, scale = _kernel_geometry_inputs(d, 66)
    qkv16 = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(pba.fused_block_attention(qkv16, jnp.asarray(scale), heads, window, shift),
                      np.float32)
    got = block_attention.fused_block_attention(_t(qkv16.astype(jnp.float32)).bfloat16(),
                                                _t(scale), heads, window, shift)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def _epilogue(rng, B, D):
    return (1.0 + _rand(rng, (D,), 0.1), _rand(rng, (D,), 0.1),
            _rand(rng, (B, D), 0.2), _rand(rng, (B, D), 0.2))


@pytest.mark.parametrize("B,N,F,D,offset", [(2, 64, 24, 48, 0.0), (3, 96, 1056, 1056, 3.0),
                                            (3, 96, 1024, 1056, 3.0)],
                         ids=["small", "flagship_12x88", "flagship_8x128"])
def test_matmul_modnorm_plain_matches_pallas(B, N, F, D, offset):
    """Kernel 3's plain version against the interpreted ``_mm_mn_call``, at a
    small shape and at the kernel's own widths (K = 1056 and 1024, D =
    1056), there with one row of x offset by ``offset``, so that its y has a
    large mean beside its spread (var = E[y²] − μ² cancels). 96 tokens a
    sample is no multiple of 128: the Pallas block is 32 rows."""
    rng = np.random.default_rng(4)
    x, w, r = _rand(rng, (B, N, F)), _rand(rng, (D, F), F ** -0.5), _rand(rng, (B, N, D))
    x[1, 5] += offset
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


def _swiglu_weights(rng, D, H):
    return _rand(rng, (2 * H, D), D ** -0.5), _rand(rng, (D, H), H ** -0.5)  # torch layout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_hidden_composes_to_the_plain_ffn(dtype):
    """Kernel 5's two passes as plain versions: h·W2ᵀ of
    ``reference_swiglu_hidden`` is ``reference_swiglu_ffn`` bit for bit."""
    rng = np.random.default_rng(8)
    x = _t(_rand(rng, (3, 64, 32))).to(dtype)
    w1, w2 = (_t(w).to(dtype) for w in _swiglu_weights(rng, 32, 85))
    got = linear.reference_linear(ffn.reference_swiglu_hidden(x, w1), w2)
    assert got.dtype == dtype and torch.equal(got, ffn.reference_swiglu_ffn(x, w1, w2))


@pytest.mark.parametrize("H", [85, 128])
def test_swiglu_hidden_plain_matches_pallas(H):
    """Kernel 5's plain passes against the interpreted ``_ffn_call``, at the
    SwiGLU width 85 and at a multiple of 64, and on the weights padded to a
    multiple of 8 as the kernels take them (the padded units of h are 0)."""
    rng = np.random.default_rng(9)
    D = 32
    x = _rand(rng, (256, D))
    w1, w2 = _swiglu_weights(rng, D, H)
    want = pffn._ffn_call(jnp.asarray(x), jnp.asarray(w1[:H].T), jnp.asarray(w1[H:].T),
                          jnp.asarray(w2.T))
    h = ffn.reference_swiglu_hidden(_t(x), _t(w1))
    got = linear.reference_linear(h, _t(w2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    w1p, w2p = ffn.pad_hidden(_t(w1), _t(w2))
    hp = ffn.reference_swiglu_hidden(_t(x), w1p)
    assert hp.shape[1] == H + -H % 8 and torch.equal(hp[:, H:], torch.zeros_like(hp[:, H:]))
    np.testing.assert_allclose(linear.reference_linear(hp, w2p).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [1, 128, 16384, 32768, 65536, 65537, 264960, 10 ** 6])
def test_ffn_chunk_plan(T):
    """Kernels 5 and 11 run over token chunks that tile [0, T) exactly, none
    above the limit; the flagship (16,384 and 32,768 tokens) is one chunk."""
    chunks = ffn.ffn_chunks(T)
    assert chunks[0][0] == 0 and chunks[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < e - s <= ffn.FFN_CHUNK_TOKENS for s, e in chunks)
    assert len(chunks) == -(-T // ffn.FFN_CHUNK_TOKENS)
    if T <= 32768:
        assert chunks == [(0, T)]


@pytest.mark.parametrize("H", [85, 88])
def test_ffn_fwd_save_plain_on_padded_weights(H):
    """Kernel 8's plain version on the weights padded to a multiple of 8 as
    its wrapper pads them on the card: (y, g, u) against the interpreted
    ``_ffn_fwd_save_call`` on the unpadded ones, the padded units of g and
    u exactly 0; in bf16 its y equals kernel 5's plain y bit for bit (the
    kernels' invariant: one h expression, one product)."""
    rng = np.random.default_rng(10)
    D = 32
    x = _rand(rng, (256, D))
    w1, w2 = _swiglu_weights(rng, D, H)
    want = pffn._ffn_fwd_save_call(jnp.asarray(x), jnp.asarray(w1[:H].T),
                                   jnp.asarray(w1[H:].T), jnp.asarray(w2.T))
    w1p, w2p = ffn.pad_hidden(_t(w1), _t(w2))
    y, g, u = ffn.reference_swiglu_ffn_fwd_save(_t(x), w1p, w2p)
    assert g.shape == u.shape == (256, H + -H % 8)
    assert not g[:, H:].any() and not u[:, H:].any()
    for got, ref in ((y, want[0]), (g[:, :H], want[1]), (u[:, :H], want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    xb, w1b, w2b = (a.to(torch.bfloat16) for a in (_t(x), w1p, w2p))
    assert torch.equal(ffn.reference_swiglu_ffn_fwd_save(xb, w1b, w2b)[0],
                       ffn.reference_swiglu_ffn(xb, w1b, w2b))


@pytest.mark.parametrize("T,chunks", [(16384, 1), (32768, 1), (131072, 2)])
def test_ffn_fwd_save_plan(T, chunks):
    """What kernel 8's wrapper plans up to the saved-activation budget
    (131,072 tokens): the flagship's B = 2 and B = 4 in one chunk, the
    budget in two of 65,536; its scratch is kernel 5's h for the longest
    chunk (0.09, 0.18 and 0.37 GB at H = 2816), and each chunk's first row
    of g and u starts on a 16-byte boundary, as the tensor maps need."""
    D, H = 1056, 2816
    assert T <= ffn.save_max_tokens()
    plan = ffn.ffn_chunks(T)
    assert len(plan) == chunks and plan[-1][1] == T
    rows = max(e - s for s, e in plan)
    assert ffn.ffn_scratch_bytes(T, D, H, pair=False) == rows * H * 2 == T // chunks * H * 2
    assert ffn.ffn_scratch_bytes(T, D, 85, pair=False) == rows * 88 * 2
    assert all(s * (H + -H % 8) * 2 % 16 == 0 and s * 88 * 2 % 16 == 0 for s, _ in plan)


def test_ffn_scratch_bytes():
    """h (and dh for kernel 11) of the longest chunk, H padded to 8: at the
    0.25° grid (264,960 tokens, five chunks of 52,992) kernel 11's scratch
    is under 1 GB, kernel 5's half of it."""
    T, D, H = 264960, 1056, 2816
    assert ffn.ffn_chunks(T) == [(s, s + 52992) for s in range(0, T, 52992)]
    assert ffn.ffn_scratch_bytes(T, D, H, pair=True) == 2 * 52992 * H * 2 <= 1e9
    assert ffn.ffn_scratch_bytes(T, D, H, pair=False) == 52992 * H * 2
    assert ffn.ffn_scratch_bytes(128, 32, 85, pair=True) == 2 * 128 * 88 * 2


WRAPPERS = {
    "linear": (linear.fused_linear, lambda d: (d(4, 16), d(8, 16))),
    "block_attention": (block_attention.fused_block_attention,
                        lambda d: (d(1, 16, 16, 3 * 16), d(1), 1, (16, 16))),
    "matmul_modnorm": (modnorm.fused_matmul_modnorm_residual,
                       lambda d: (d(1, 4, 16), d(16, 16), d(1, 4, 16), d(16), d(16),
                                  d(1, 16), d(1, 16))),
    "modnorm": (modnorm.fused_modnorm_residual,
                lambda d: (d(1, 4, 16), d(1, 4, 16), d(16), d(16), d(1, 16), d(1, 16))),
    "modnorm_tangent": (modnorm.modnorm_residual_tangent,
                        lambda d: (d(1, 4, 16), d(1, 4, 16), d(1, 4, 16), d(16), d(16),
                                   d(1, 16), d(1, 16), d(1, 16))),
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


# (M, N, K) of kernels 1 and 14: ragged rows, columns and K tails (K = 32 is
# half a 64-deep TMA box, K = 8 an eighth), one row past a 64-row box, and
# the flagship's two head layouts, 12x88 and 8x128, at B = 2.
LINEAR_SHAPES = [(1000, 120, 208), (136, 96, 32), (128, 96, 32), (65, 8, 8),
                 (16384, 3168, 1056), (16384, 3072, 1056)]


def _linear_inputs(M, N, K):
    rng = np.random.default_rng(M + N + K)

    def t(shape, scale=1.0):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", torch.bfloat16)

    return t((M, K)), t((M, K)), t((N, K), K ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", LINEAR_SHAPES)
def test_linear_kernels_match_plain_on_card(M, N, K):
    """Kernels 1 and 14 (one wgmma + TMA main loop) against their plain
    versions in bf16 on the card, every output within 2e-2 of max|plain|;
    each wrapper counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, dx, w = _linear_inputs(M, N, K)
    before = (linear.fused_linear.launches, linear.linear_pt.launches)
    got = (linear.fused_linear(x, w), *linear.linear_pt(x, dx, w))
    want = (linear.reference_linear(x, w), *linear.reference_linear_pt(x, dx, w))
    torch.cuda.synchronize()
    assert (linear.fused_linear.launches, linear.linear_pt.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    for g, ref in zip(got, want):
        err = (g.float() - ref.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= 2e-2 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", LINEAR_SHAPES)
def test_linear_pt_equals_kernel_1_bit_for_bit(M, N, K):
    """Kernel 14's design invariant: ``linear_pt(x, dx, w)`` equals
    ``(fused_linear(x, w), fused_linear(dx, w))`` bit for bit. Both run the
    same wgmmas in one k order for a row, so a wrong row of x or dx, or a
    wrong W stage, shows at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, dx, w = _linear_inputs(M, N, K)
    y, dy = linear.linear_pt(x, dx, w)
    assert torch.equal(y, linear.fused_linear(x, w))
    assert torch.equal(dy, linear.fused_linear(dx, w))


# (M, K, D, tps) of kernel 3: the shipped shapes (the flagship's two head
# layouts at B = 2, path C's K = 1280 at B = 1, path A's 32 x 32), a ragged M
# whose samples change inside a 128-row tile, D that is no multiple of the
# columns a cluster block holds (48 and 400 on 32- and 64-column slices,
# 208 on 32), K tails shorter than a 64-deep box (40, 72), and more samples
# than a block keeps in shared memory (6 at D = 400, 20 at D = 1056: their
# AdaLN rows are read from device memory).
MM_MODNORM_SHAPES = [(16384, 1056, 1056, 8192), (16384, 1024, 1056, 8192),
                     (8192, 1280, 1056, 8192), (128, 32, 32, 32), (1000, 40, 48, 200),
                     (1000, 96, 208, 200), (264, 72, 400, 44), (2560, 64, 1056, 128)]


def _mm_modnorm_card_inputs(M, K, D, tps):
    """Kernel 3's inputs in bf16 on the card, with row 0 of x all zeros
    (var = 0: the eps path) and row 1 offset by +3 (a large mean beside the
    spread)."""
    rng = np.random.default_rng(M + K + D)
    B = M // tps
    x = _rand(rng, (B, tps, K))
    x[0, 0] = 0.0
    x[0, 1] += 3.0
    arrays = (x, _rand(rng, (D, K), K ** -0.5), _rand(rng, (B, tps, D)))
    bf = tuple(torch.from_numpy(a).to("cuda", torch.bfloat16) for a in arrays)
    g, b, msc, msh = _epilogue(rng, B, D)
    return bf + (torch.from_numpy(g).cuda(), torch.from_numpy(b).cuda(),
                 torch.from_numpy(msc).to("cuda", torch.bfloat16),
                 torch.from_numpy(msh).to("cuda", torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,D,tps", MM_MODNORM_SHAPES)
def test_matmul_modnorm_kernel_matches_plain_on_card(M, K, D, tps):
    """Kernel 3 (wgmma + TMA, rows split across a cluster, statistics
    through distributed shared memory) against its plain version in bf16 on
    the card, within 2e-2 of max|plain|, the zero row and the offset row
    included; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _mm_modnorm_card_inputs(M, K, D, tps)
    before = modnorm.fused_matmul_modnorm_residual.launches
    got = modnorm.fused_matmul_modnorm_residual(*args)
    want = modnorm.reference_matmul_modnorm_residual(*args).float()
    torch.cuda.synchronize()
    assert modnorm.fused_matmul_modnorm_residual.launches == before + 1
    ref = want.abs().max().item()
    for rows in (slice(None), slice(0, 1), slice(1, 2)):  # all, the zero row, the offset row
        err = (got[0, rows].float() - want[0, rows]).abs().max().item()
        assert torch.isfinite(got).all() and err <= 2e-2 * ref, (rows, err, ref)
    err = (got.float() - want).abs().max().item()
    assert err <= 2e-2 * ref, err


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,D,tps", MM_MODNORM_SHAPES[:2])
def test_matmul_modnorm_kernel_is_deterministic(M, K, D, tps):
    """Two calls of kernel 3 at the flagship shapes are equal bit for bit:
    every block of a cluster adds the rows' partial sums in rank order, so a
    slot read too early, or a block that sums in another order, shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _mm_modnorm_card_inputs(M, K, D, tps)
    first = modnorm.fused_matmul_modnorm_residual(*args)
    assert torch.equal(first, modnorm.fused_matmul_modnorm_residual(*args))


@pytest.mark.parametrize("tangent", [False, True], ids=["kernel4", "kernel12"])
@pytest.mark.parametrize("D", [16, 208, 1024, 1056, 4096, 16384])
def test_modnorm_plan(D, tangent):
    """Kernels 4 and 12's launch plan at the flagship's B = 4: the
    barriers, g and b, the AdaLN rows where they are kept and every stage
    fit the 227 KB a block may use, each stage holds at least one row of
    each streamed tensor (no cap at 2048), a block is the consumer warps
    and one producer warp, and up to D = 1280 (path C) a block keeps the
    AdaLN rows in shared memory and three stages of eight rows."""
    plan = modnorm.modnorm_plan(D, tangent, samples=4)
    rows, stages, tensors = plan["rows"], plan["stages"], 3 if tangent else 2
    assert 1 <= rows <= modnorm.MODNORM_MAX_ROWS and 1 <= stages <= modnorm.MODNORM_STAGES
    ada = tensors * 4 * 2 * D if plan["ada_smem"] else 0
    assert plan["smem"] == 16 * stages + 16 + 8 * D + ada + stages * rows * tensors * 2 * D
    assert plan["smem"] <= modnorm.MODNORM_SMEM == 232448
    assert plan["threads"] == 32 * (rows + 1)
    assert plan["ada_smem"] == (ada > 0) and ada <= modnorm.MODNORM_ADA_SMEM
    if D <= 1280:
        assert (rows, stages, plan["ada_smem"]) == (8, 3, 1)


@pytest.mark.parametrize("tangent", [False, True], ids=["kernel4", "kernel12"])
@pytest.mark.parametrize("D", [0, 8, 1000, 1064, 20000])
def test_modnorm_plan_refuses(D, tangent):
    """D that is not a positive multiple of 16, or a row wider than a block
    holds beside g and b, raises."""
    with pytest.raises(ValueError, match="modnorm_plan"):
        modnorm.modnorm_plan(D, tangent)


def _modnorm_card_inputs(B, tps, D, tangent):
    """Kernel 4's (or 12's) inputs in bf16 on the card, as
    :func:`_mm_modnorm_card_inputs` builds kernel 3's: row 0 of y all zeros
    (var = 0: the eps path; of dy too for 12) and row 1 offset by +3 (a
    large mean beside the spread)."""
    rng = np.random.default_rng(B * tps + D + tangent)
    y = _rand(rng, (B, tps, D), 3.0)
    y[0, 0] = 0.0
    y[0, 1] += 3.0
    bf = lambda a: torch.from_numpy(a).to("cuda", torch.bfloat16)  # noqa: E731
    g, b, msc, msh = _epilogue(rng, B, D)
    g, b = torch.from_numpy(g).cuda(), torch.from_numpy(b).cuda()
    if not tangent:
        return bf(y), bf(_rand(rng, (B, tps, D))), g, b, bf(msc), bf(msh)
    dy = _rand(rng, (B, tps, D), 3.0)
    dy[0, 0] = 0.0
    return (bf(y), bf(dy), bf(_rand(rng, (B, tps, D))), g, b, bf(msc), bf(msh),
            bf(_rand(rng, (B, D), 0.2)))


@pytest.mark.cuda
@pytest.mark.parametrize("tangent", [False, True], ids=["kernel4", "kernel12"])
@pytest.mark.parametrize("D", [16, 208, 1056, 4096, 16384])
def test_modnorm_kernels_match_plain_on_card(D, tangent):
    """Kernels 4 and 12 (``csrc/modnorm.cu``: rows streamed by
    ``cp.async.bulk`` through an mbarrier ring) against their plain versions
    in bf16 on the card, within 2e-2 of max|plain| over all rows, the zero
    row and the offset row each; B = 3 samples of 1001 tokens (no multiple
    of the rows a stage, so groups straddle two samples and the last group
    is ragged); D from 16 to 16,384 (one row, one stage; the Triton
    kernels stopped at 2048); one launch a call; two calls equal bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    fused, plain = ((modnorm.modnorm_residual_tangent, modnorm.reference_modnorm_residual_tangent)
                    if tangent else
                    (modnorm.fused_modnorm_residual, modnorm.reference_modnorm_residual))
    args = _modnorm_card_inputs(3, 1001, D, tangent)
    before = fused.launches
    got = fused(*args)
    want = plain(*args).float()
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    for rows in (slice(None), slice(0, 1), slice(1, 2)):  # all, the zero row, the offset row
        ref = want[0, rows].abs().max().item() if rows.start is not None else (
            want.abs().max().item())
        part = got if rows.start is None else got[0, rows]
        full = want if rows.start is None else want[0, rows]
        err = (part.float() - full).abs().max().item()
        assert err <= 2e-2 * ref, (rows, err, ref)
    assert torch.equal(got, fused(*args))


# (T, D, H) of kernels 5 and 11: one row past a 64-row box, 1000 tokens and
# the flagship's 16,384; K tails of pass 1 (D = 32 is half a 64-deep box,
# 96 one and a half, 1056 the flagship); H = 8, 85 (padded to 88), 88 (a
# hidden tile of 88 units and a ragged output box of pass 1, a K tail of
# pass 2) and the flagship's 2816 (22 tiles of 128).
FFN_SHAPES = [(T, D, H) for T in (65, 1000, 16384) for D in (32, 96, 1056)
              for H in (8, 85, 88, 2816)]


def _ffn_card_inputs(T, D, H):
    rng = np.random.default_rng(T + D + H)
    w1, w2 = _swiglu_weights(rng, D, H)
    return tuple(torch.from_numpy(a).to("cuda", torch.bfloat16)
                 for a in (_rand(rng, (T, D)), _rand(rng, (T, D)), w1, w2))


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H", FFN_SHAPES)
def test_ffn_kernels_match_plain_on_card(T, D, H):
    """Kernels 5 and 11 (two passes each on the wgmma + TMA ring) against
    their plain versions in bf16 on the card, every output within 2e-2 of
    max|plain|; each wrapper counts one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, dx, w1, w2 = _ffn_card_inputs(T, D, H)
    before = (ffn.fused_swiglu_ffn.launches, ffn.swiglu_ffn_pt.launches)
    got = (ffn.fused_swiglu_ffn(x, w1, w2), *ffn.swiglu_ffn_pt(x, dx, w1, w2))
    want = (ffn.reference_swiglu_ffn(x, w1, w2), *ffn.reference_swiglu_ffn_pt(x, dx, w1, w2))
    torch.cuda.synchronize()
    assert (ffn.fused_swiglu_ffn.launches, ffn.swiglu_ffn_pt.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    for g, ref in zip(got, want):
        err = (g.float() - ref.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= 2e-2 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H", FFN_SHAPES)
def test_ffn_pt_y_equals_kernel_5_bit_for_bit(T, D, H):
    """Kernel 11's design invariant: its y equals kernel 5's bit for bit.
    Both passes run the same wgmmas in one k order for a row and pass 1
    shares its h expression, so a wrong row, stage or handover shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, dx, w1, w2 = _ffn_card_inputs(T, D, H)
    y, _ = ffn.swiglu_ffn_pt(x, dx, w1, w2)
    assert torch.equal(y, ffn.fused_swiglu_ffn(x, w1, w2))


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H", FFN_SHAPES)
def test_ffn_fwd_save_kernel_matches_plain_on_card(T, D, H):
    """Kernel 8 (kernel 5's pass 1 also storing g and u, then pass 2)
    against its plain version in bf16 on the card: y, g and u within 2e-2
    of max|plain|, g and u at the kernels' width H padded to 8 with the
    padded units exactly 0; one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, _, w1, w2 = _ffn_card_inputs(T, D, H)
    before = ffn.swiglu_ffn_fwd_save.launches
    y, g, u = ffn.swiglu_ffn_fwd_save(x, w1, w2)
    want = ffn.reference_swiglu_ffn_fwd_save(x, w1, w2)
    torch.cuda.synchronize()
    assert ffn.swiglu_ffn_fwd_save.launches == before + 1
    assert g.shape == u.shape == (T, H + -H % 8)
    assert not g[:, H:].any() and not u[:, H:].any()
    for got, ref in zip((y, g[:, :H], u[:, :H]), want):
        err = (got.float() - ref.float()).abs().max().item()
        assert torch.isfinite(got).all() and err <= 2e-2 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H", FFN_SHAPES)
def test_ffn_fwd_save_y_equals_kernel_5_bit_for_bit(T, D, H):
    """Kernel 8's design invariant: its y equals kernel 5's bit for bit.
    Its pass 1 runs kernel 5's wgmmas in one k order for a row and forms h
    by the same expression, and pass 2 is the same loop, so a wrong row,
    box or store order shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, _, w1, w2 = _ffn_card_inputs(T, D, H)
    y, _, _ = ffn.swiglu_ffn_fwd_save(x, w1, w2)
    assert torch.equal(y, ffn.fused_swiglu_ffn(x, w1, w2))


@pytest.mark.cuda
def test_ffn_chunks_equal_one_chunk_bit_for_bit(monkeypatch):
    """One call of kernels 5, 11 and 8 over several token chunks (the limit
    lowered to 256 tokens: 1000 tokens in chunks of 256, 256, 256 and 232)
    equals the one-chunk call bit for bit, kernel 8's g and u too, and
    still counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, dx, w1, w2 = _ffn_card_inputs(1000, 96, 88)
    fns = (ffn.fused_swiglu_ffn, ffn.swiglu_ffn_pt, ffn.swiglu_ffn_fwd_save)

    def run():
        return (ffn.fused_swiglu_ffn(x, w1, w2), *ffn.swiglu_ffn_pt(x, dx, w1, w2),
                *ffn.swiglu_ffn_fwd_save(x, w1, w2))

    one = run()
    monkeypatch.setattr(ffn, "FFN_CHUNK_TOKENS", 256)
    assert len(ffn.ffn_chunks(1000)) == 4
    before = [fn.launches for fn in fns]
    many = run()
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    for a, b in zip(one, many):
        assert torch.equal(a, b)


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


# Kernels 2 and 15 across the geometry they accept: (window, grid, shift) with square and
# oblong 256-token windows, grids of several windows and of one, and shifts that wrap on both
# axes; at each head dim of the parametrisation (padded to 32, 64, 96, 128 lanes in shared
# memory, and 96 and 128 unpadded) and B of 1 and 3.
FORWARD_WINDOWS = [((16, 16), (32, 48), (8, 40)), ((8, 32), (24, 64), (5, 44)),
                   ((32, 8), (64, 16), (37, 3)), ((16, 16), (16, 16), (5, 11))]


def _card_tensor(rng):
    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", dtype)

    return t


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 40, 88, 96, 128])
def test_attention_forward_kernels_match_plain_on_card(d):
    """Kernel 2 at the shift and kernel 15 on the qkv rolled by it against
    the plain version in bf16 on the card, within 2e-2 of max|plain|, over
    ``FORWARD_WINDOWS`` at B = 1 and 3; each call twice, equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(70 + d))
    heads = 3
    for window, grid, shift in FORWARD_WINDOWS:
        for B in (1, 3):
            qkv = t((B, *grid, heads * 3 * d))
            scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
            rolled = torch.roll(qkv, (-shift[0], -shift[1]), (1, 2))
            cases = [
                (block_attention.fused_block_attention, (qkv, scale, heads, window, shift)),
                (block_attention.fused_tiled_block_attention, (rolled, scale, heads, window)),
            ]
            for fused, args in cases:
                got = fused(*args)
                want = block_attention.reference_block_attention(*args)
                again = fused(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tag = (fused.__name__, window, grid, shift, B, err)
                assert torch.isfinite(got).all(), tag
                assert err <= 2e-2 * want.float().abs().max().item(), tag
                assert torch.equal(got, again), tag


@pytest.mark.cuda
@pytest.mark.parametrize("d", [88, 128])
def test_attention_forward_kernels_take_zero_rows(d):
    """A q row and a k row of zeros normalise to zeros through the eps of
    the L2 norm (|x|² + 1e-12), in kernels 2 and 15 as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(80 + d))
    heads, window, shift = 2, (16, 16), (8, 8)
    qkv = t((2, 32, 64, heads * 3 * d))
    qkv[0, 3, 5, d * 3:d * 4] = 0  # head 1's q at one token
    qkv[1, 20, 60, d:2 * d] = 0  # head 0's k at another
    scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
    rolled = torch.roll(qkv, (-shift[0], -shift[1]), (1, 2))
    for fused, args in ((block_attention.fused_block_attention, (qkv, scale, heads, window, shift)),
                        (block_attention.fused_tiled_block_attention,
                         (rolled, scale, heads, window))):
        got, want = fused(*args), block_attention.reference_block_attention(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all() and err <= 2e-2 * want.float().abs().max().item(), (
            fused.__name__, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 40, 88, 96, 128])
def test_attention_tangent_kernels_match_plain_on_card(d):
    """Kernel 7 at the shift and kernel 17 on qkv and dqkv rolled by it
    against the plain version in bf16 on the card, within 2e-2 of
    max|plain|, over ``FORWARD_WINDOWS`` at B = 1 and 3 (a cluster's two
    blocks split each window's keys; at d ≤ 16 the second block finishes
    no column); each call twice, equal bit for bit, and 17's output rolled
    back equal to 7's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(170 + d))
    heads = 3
    for window, grid, shift in FORWARD_WINDOWS:
        for B in (1, 3):
            qkv, dqkv = t((B, *grid, heads * 3 * d)), t((B, *grid, heads * 3 * d))
            scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
            rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dqkv))
            cases = [
                (block_attention.block_attention_tangent, (qkv, dqkv, scale, heads, window, shift)),
                (block_attention.tiled_block_attention_tangent,
                 (rolled, drolled, scale, heads, window)),
            ]
            outs = []
            for fused, args in cases:
                got = fused(*args)
                want = block_attention.reference_block_attention_tangent(*args)
                again = fused(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tag = (fused.__name__, window, grid, shift, B, err)
                assert torch.isfinite(got).all(), tag
                assert err <= 2e-2 * want.float().abs().max().item(), tag
                assert torch.equal(got, again), tag
                outs.append(got)
            assert torch.equal(torch.roll(outs[1], shift, (1, 2)), outs[0]), (window, grid, B)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [88, 128])
def test_attention_tangent_kernels_take_zero_rows(d):
    """A q row and a k row of zeros, with zero tangents, normalise to zeros
    through the eps of the L2 norm (|x|² + 1e-12), and so do their tangents,
    in kernels 7 and 17 as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(180 + d))
    heads, window, shift = 2, (16, 16), (8, 8)
    qkv, dqkv = t((2, 32, 64, heads * 3 * d)), t((2, 32, 64, heads * 3 * d))
    for a in (qkv, dqkv):
        a[0, 3, 5, d * 3:d * 4] = 0  # head 1's q at one token
        a[1, 20, 60, d:2 * d] = 0  # head 0's k at another
    scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
    rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dqkv))
    for fused, args in ((block_attention.block_attention_tangent,
                         (qkv, dqkv, scale, heads, window, shift)),
                        (block_attention.tiled_block_attention_tangent,
                         (rolled, drolled, scale, heads, window))):
        got, want = fused(*args), block_attention.reference_block_attention_tangent(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all() and err <= 2e-2 * want.float().abs().max().item(), (
            fused.__name__, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,grid,heads,d,shift", [
    (2, (64, 128), 12, 88, (8, 8)), (2, (64, 128), 8, 128, (8, 8)),
    (1, (368, 720), 8, 128, (8, 8))], ids=["flagship_12x88", "flagship_8x128", "quarter"])
def test_attention_tangent_kernels_walk_many_window_heads(B, grid, heads, d, shift):
    """Kernels 7 and 17 at the main paths' shapes, where each cluster walks
    several window-heads (about 12 at the flagship, 125 at 0.25°), so that a
    buffer or an exchange slot reused too early shows: within 2e-2 of
    max|plain|, two calls equal bit for bit, and 17 on rolled inputs equal
    to 7 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(190 + d))
    win = (16, 16)
    qkv, dqkv = t((B, *grid, heads * 3 * d)), t((B, *grid, heads * 3 * d))
    scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
    rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dqkv))
    args = (rolled, drolled, scale, heads, win)
    want = block_attention.reference_block_attention_tangent(*args)
    got = block_attention.tiled_block_attention_tangent(*args)
    again = block_attention.tiled_block_attention_tangent(*args)
    whole = block_attention.block_attention_tangent(qkv, dqkv, scale, heads, win, shift)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all() and err <= 2e-2 * want.float().abs().max().item(), err
    assert torch.equal(got, again)
    assert torch.equal(torch.roll(got, shift, (1, 2)), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("B,grid,heads,d,shift", [
    (2, (64, 128), 12, 88, (8, 8)), (2, (64, 128), 8, 128, (8, 8)),
    (1, (368, 720), 8, 128, (8, 8))], ids=["flagship_12x88", "flagship_8x128", "quarter"])
def test_attention_forward_kernels_walk_many_window_heads(B, grid, heads, d, shift):
    """Kernels 2 and 15 at the main paths' shapes, where each block walks
    several window-heads (6 and 4 an SM at the flagship, 63 at 0.25°), so
    that a buffer reused too early across window-heads shows: within 2e-2
    of max|plain|, two calls equal bit for bit, and 15 on rolled qkv equal
    to 2 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(90 + d))
    win = (16, 16)
    qkv = t((B, *grid, heads * 3 * d))
    scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
    rolled = torch.roll(qkv, (-shift[0], -shift[1]), (1, 2))
    want = block_attention.reference_block_attention(rolled, scale, heads, win)
    got = block_attention.fused_tiled_block_attention(rolled, scale, heads, win)
    again = block_attention.fused_tiled_block_attention(rolled, scale, heads, win)
    whole = block_attention.fused_block_attention(qkv, scale, heads, win, shift)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all() and err <= 2e-2 * want.float().abs().max().item(), err
    assert torch.equal(got, again)
    assert torch.equal(torch.roll(got, shift, (1, 2)), whole)


def _bwd_on_card(args, tiled):
    """Kernel 16 (``tiled``) or 6 on ``args`` twice and the plain version:
    both outputs (dqkv, dscale) within 2e-2 of max|plain| and the two calls
    equal bit for bit. Returns the first call's outputs."""
    fused = (block_attention.tiled_block_attention_bwd if tiled
             else block_attention.block_attention_bwd)
    got = fused(*args)
    again = fused(*args)
    want = block_attention.reference_block_attention_bwd(*args)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("dqkv", "dscale"), got, again, want):
        err = (g.float() - w.float()).abs().max().item()
        tag = (fused.__name__, name, err)
        assert torch.isfinite(g).all(), tag
        assert err <= 2e-2 * w.float().abs().max().item(), tag
        assert torch.equal(g, a), tag
    return got


def _bwd_equal(tiled, whole, shift):
    """Kernel 16's outputs on inputs rolled by ``shift``, dqkv rolled back,
    equal to kernel 6's at that shift bit for bit."""
    return (torch.equal(torch.roll(tiled[0], shift, (1, 2)), whole[0])
            and torch.equal(tiled[1], whole[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 40, 88, 96, 128])
def test_attention_bwd_kernels_match_plain_on_card(d):
    """Kernel 6 at the shift and kernel 16 on qkv and dout rolled by it
    against the plain version in bf16 on the card, dqkv and dscale each
    within 2e-2 of max|plain|, over ``FORWARD_WINDOWS`` at B = 1 and 3 (the
    query pass's cluster splits each window's keys, at d ≤ 16 its second
    block stores no column of dq; the key pass walks 64 keys an item); each
    call twice, equal bit for bit, and 16's outputs, rolled back, equal to
    6's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(270 + d))
    heads = 3
    for window, grid, shift in FORWARD_WINDOWS:
        for B in (1, 3):
            qkv, dout = t((B, *grid, heads * 3 * d)), t((B, *grid, heads * d))
            scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
            rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dout))
            whole = _bwd_on_card((qkv, scale, dout, heads, window, shift), False)
            tiled = _bwd_on_card((rolled, scale, drolled, heads, window), True)
            assert _bwd_equal(tiled, whole, shift), (window, grid, B)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [88, 128])
def test_attention_bwd_kernels_take_zero_rows(d):
    """A q row and a k row of zeros normalise to zeros through the eps of
    the L2 norm (|x|² + 1e-12), and their gradients pass the normalise's
    backward at 1/|x| = 1e6, in kernels 6 and 16 as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(280 + d))
    heads, window, shift = 2, (16, 16), (8, 8)
    qkv, dout = t((2, 32, 64, heads * 3 * d)), t((2, 32, 64, heads * d))
    qkv[0, 3, 5, d * 3:d * 4] = 0  # head 1's q at one token
    qkv[1, 20, 60, d:2 * d] = 0  # head 0's k at another
    scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
    rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dout))
    _bwd_on_card((qkv, scale, dout, heads, window, shift), False)
    _bwd_on_card((rolled, scale, drolled, heads, window), True)


@pytest.mark.cuda
@pytest.mark.parametrize("B,grid,heads,d,shift", [
    (2, (64, 128), 12, 88, (8, 8)), (2, (64, 128), 8, 128, (8, 8)),
    (1, (368, 720), 8, 128, (8, 8))], ids=["flagship_12x88", "flagship_8x128", "quarter"])
def test_attention_bwd_kernels_walk_many_window_heads(B, grid, heads, d, shift):
    """Kernels 6 and 16 at the main paths' shapes, where each cluster of
    the query pass walks several window-heads (about 12 at the flagship,
    125 at 0.25°) and each block of the key pass several items, so that a
    buffer, a stage of the ring or an exchange slot reused too early shows:
    within 2e-2 of max|plain|, two calls equal bit for bit, and 16 on
    rolled inputs equal to 6 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    t = _card_tensor(np.random.default_rng(290 + d))
    win = (16, 16)
    qkv, dout = t((B, *grid, heads * 3 * d)), t((B, *grid, heads * d))
    scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
    rolled, drolled = (torch.roll(a, (-shift[0], -shift[1]), (1, 2)) for a in (qkv, dout))
    tiled = _bwd_on_card((rolled, scale, drolled, heads, win), True)
    whole = block_attention.block_attention_bwd(qkv, scale, dout, heads, win, shift)
    torch.cuda.synchronize()
    assert _bwd_equal(tiled, whole, shift)
