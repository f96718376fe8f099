"""swift_torch's int8 inference ops against the JAX package.

* ``ops.quant`` (``quantize_rowwise``, ``quantize_colwise``,
  ``int8_matmul``) against ``swift_tpu.ops.quant`` bit for bit in fp32:
  random inputs, values already on the quantization grid, an all-zero row
  (the 1e-30 floor of the scale) and an all-zero weight column (the JAX
  model's zero-padded qkv columns).
* The plain version of kernel 18 (``reference_swiglu_ffn_int8``) against
  the JAX mirror bit for bit at the flagship widths (within two ulp at a
  tiny width, where a last-bit difference of the two exps can move a row's
  h scale), and against the Pallas kernel run in
  interpret mode at the JAX package's own rtol/atol 1e-4
  (``tests/test_quant.py``): the kernel multiplies by 1/127 where the
  mirror divides by 127.
* The plain version of kernel 19: its int8 product bit for bit, the whole
  epilogue against the mirror at 2e-5 (fp32 LayerNorm sums in another
  order) and against the interpreted kernel at 1e-4; on weights quantized
  once (``matmul_modnorm_residual_int8_quantized``) equal to the wrapper's
  CPU path bit for bit at the widths the card runs (K = D = 1056, the 8x128
  heads' K = 1024, path C's 1280), and its scratch from the shapes (under
  0.3 GB at 0.25°).
* Kernel 18's token chunks: its scratch from the shapes (under 1 GB at
  0.25°), and the plain version run chunk by chunk over ``ffn_chunks``
  (the limit lowered) equal to the whole run bit for bit and to the JAX
  mirror: per-token scales make the chunks independent.
* Routing: CPU tensors take the plain versions and count no launch; the
  wrappers raise while autograd records and on dual tensors (the Pallas
  calls have no vjp or jvp rule), and on inputs that are not all on one
  CUDA device.
* The ``cuda``-marked tests hold kernels 18 and 19 to their plain versions
  on the card within 2e-2 of max|plain|, kernel 18 also across a chunk
  boundary, two calls of each bit for bit, kernel 19 on weights quantized
  once equal to its wrapper, and skip elsewhere. This file
  imports no JAX model (flax), so it collects on the card's machine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch.autograd import forward_ad

import swift_tpu.ops.pallas_ffn as pffn
import swift_tpu.ops.pallas_modnorm as pmn
from swift_torch.ops import ffn, modnorm, quant
from swift_tpu.ops import quant as jquant

KERNEL_TOL = 1e-4  # Pallas kernel (x / scale as x * (1/127)) vs the mirror, tests/test_quant.py
MODNORM_TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    if jax.default_backend() != "tpu":
        orig = pl.pallas_call
        for mod in (pffn, pmn):
            monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant_case(case):
    """(x (M, K), w (K, N) in the JAX layout) for each quantization edge."""
    rng = np.random.default_rng(10)
    x, w = _rand(rng, (40, 48)), _rand(rng, (48, 24), 0.05)
    if case == "exact_points":  # values on the grid come back exactly
        x = np.tile(np.array([127.0, -127.0, 0.0, 64.0, 1.0, -1.0, 32.0, -8.0], np.float32),
                    (40, 6))
        w = np.eye(48, 24, dtype=np.float32)
    elif case == "zero_row":
        x[3] = 0.0
    elif case == "zero_column":
        w[:, 5] = 0.0
    return x, w


@pytest.mark.parametrize("case", ["random", "exact_points", "zero_row", "zero_column"])
def test_quant_matches_jax_bit_for_bit(case):
    x, w = _quant_case(case)
    jq, js = jquant.quantize_rowwise(jnp.asarray(x))
    tq, ts = quant.quantize_rowwise(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (40, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the port's weight is the (N, K) nn.Linear layout of the JAX (K, N) kernel
    jq, js = jquant.quantize_colwise(jnp.asarray(w))
    tq, ts = quant.quantize_colwise(_t(w.T))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(-1))
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = quant.int8_matmul(_t(x), _t(w.T))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "exact_points":
        np.testing.assert_allclose(got.numpy(), x @ w, atol=1e-5)
    if case == "zero_row":
        assert not got[3].any()
    if case == "zero_column":
        assert not got[:, 5].any()


def _ffn_inputs(seed=1, T=256, D=64, H=160):
    rng = np.random.default_rng(seed)
    return _rand(rng, (T, D)), _rand(rng, (D, 2 * H), 0.05), _rand(rng, (H, D), 0.05)


def test_int8_ffn_plain_matches_jax_at_flagship_widths():
    """Bit for bit at the flagship's D = 1056, H = 2816 (512 tokens)."""
    x, w1, w2 = _ffn_inputs(0, T=512, D=1056, H=2816)
    got = ffn.reference_swiglu_ffn_int8(_t(x), _t(w1.T), _t(w2.T)).numpy()
    mirror = np.asarray(pffn.reference_swiglu_ffn_int8(jnp.asarray(x), jnp.asarray(w1),
                                                       jnp.asarray(w2)))
    np.testing.assert_array_equal(got, mirror)


def test_int8_ffn_plain_matches_jax():
    """At a tiny width, against the mirror within two ulp: XLA's CPU exp and
    torch's round sigmoid(g) differently in the last bit for a few tenths of
    a percent of g, which can move a row's h scale by one ulp, and so y =
    (acc·sh)·s2 by up to two (61 of 16384 outputs here); and against the
    interpreted kernel at 1e-4."""
    x, w1, w2 = _ffn_inputs()
    got = ffn.reference_swiglu_ffn_int8(_t(x), _t(w1.T), _t(w2.T)).numpy()
    mirror = np.asarray(pffn.reference_swiglu_ffn_int8(jnp.asarray(x), jnp.asarray(w1),
                                                       jnp.asarray(w2)))
    np.testing.assert_array_max_ulp(got, mirror, maxulp=2)
    kernel = np.asarray(pffn.fused_swiglu_ffn_int8(jnp.asarray(x), jnp.asarray(w1),
                                                   jnp.asarray(w2)))
    np.testing.assert_allclose(got, kernel, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    # through the wrapper, on CPU tensors: the plain version, no launch
    before = ffn.fused_swiglu_ffn_int8.launches
    with torch.no_grad():
        np.testing.assert_array_equal(ffn.fused_swiglu_ffn_int8(_t(x), _t(w1.T), _t(w2.T)), got)
    assert ffn.fused_swiglu_ffn_int8.launches == before


@pytest.mark.parametrize("H", [85, 100, 2816])
def test_int8_ffn_hidden_padding_is_exact(H):
    """The int8 wrapper zero-pads H to a multiple of 16 for kernel 18
    (``pad_hidden(w1, w2, 16)``) before the weights are quantized: zero rows
    of W1 quantize to zero gate and up, and zero columns of W2 change neither
    h's per-token abs-max nor W2's per-output-feature scales, so the plain
    version on the padded weights equals the unpadded one bit for bit."""
    x, w1, w2 = _ffn_inputs(5, T=64, D=48, H=H)
    w1t, w2t = _t(w1.T), _t(w2.T)
    w1p, w2p = ffn.pad_hidden(w1t, w2t, 16)
    assert w2p.shape == (48, H + -H % 16) and w1p.shape == (2 * w2p.shape[1], 48)
    assert (w1p is w1t) == (H % 16 == 0)
    np.testing.assert_array_equal(ffn.reference_swiglu_ffn_int8(_t(x), w1p, w2p).numpy(),
                                  ffn.reference_swiglu_ffn_int8(_t(x), w1t, w2t).numpy())


def test_int8_ffn_scratch_bytes():
    """Kernel 18's scratch for the longest token chunk, H padded to 16: fp32
    h, int8 hq and xq, the two scales and h's partial maxima a 128-unit
    tile. The flagship's MB = 4 forward (32,768 tokens) runs one chunk; the
    0.25° grid's 264,960 tokens five of 52,992, under 1 GB."""
    assert ffn.ffn_int8_scratch_bytes(32768, 1056, 2816) == 32768 * (5 * 2816 + 1056 + 8 + 88)
    quarter = ffn.ffn_int8_scratch_bytes(264960, 1056, 2816)
    assert quarter == 52992 * (5 * 2816 + 1056 + 8 + 88) < 1e9
    # H = 85 is padded to 96: one partial a row
    assert ffn.ffn_int8_scratch_bytes(128, 32, 85) == 128 * (5 * 96 + 32 + 8 + 4)


def test_int8_ffn_plain_chunks_equal_whole_run(monkeypatch):
    """Kernel 18 runs over the token chunks of ``ffn_chunks``; every scale
    is per token or per output feature, so the plain version run chunk by
    chunk (the limit lowered to 256 tokens: three chunks of 600 tokens, the
    last 88) at the flagship widths equals the whole run and the JAX mirror
    bit for bit."""
    monkeypatch.setattr(ffn, "FFN_CHUNK_TOKENS", 256)
    x, w1, w2 = _ffn_inputs(6, T=600, D=1056, H=2816)
    chunks = ffn.ffn_chunks(600)
    assert chunks == [(0, 256), (256, 512), (512, 600)]
    whole = ffn.reference_swiglu_ffn_int8(_t(x), _t(w1.T), _t(w2.T))
    pieces = torch.cat([ffn.reference_swiglu_ffn_int8(_t(x[s:e]), _t(w1.T), _t(w2.T))
                        for s, e in chunks])
    np.testing.assert_array_equal(pieces.numpy(), whole.numpy())
    mirror = np.asarray(pffn.reference_swiglu_ffn_int8(jnp.asarray(x), jnp.asarray(w1),
                                                       jnp.asarray(w2)))
    np.testing.assert_array_equal(pieces.numpy(), mirror)


def _modnorm_inputs(seed=2, B=2, n=128, F=96, D=48):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (B, n, F)), _rand(rng, (F, D), F ** -0.5), _rand(rng, (B, n, D)),
            1.0 + _rand(rng, (D,), 0.1), _rand(rng, (D,), 0.1), _rand(rng, (B, D), 0.2),
            _rand(rng, (B, D), 0.2))


def test_int8_modnorm_plain_matches_jax():
    x, w, r, g, b, sc, sh = _modnorm_inputs()
    np.testing.assert_array_equal(
        quant.int8_matmul(_t(x), _t(w.T)).numpy(),
        np.asarray(jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w))))
    args = [jnp.asarray(a) for a in (x, w, r, g, b, sc, sh)]
    got = modnorm.reference_matmul_modnorm_residual_int8(
        _t(x), _t(w.T), _t(r), _t(g), _t(b), _t(sc), _t(sh)).numpy()
    mirror = np.asarray(pmn.reference_matmul_modnorm_residual_int8(*args))
    np.testing.assert_allclose(got, mirror, rtol=MODNORM_TOL, atol=MODNORM_TOL)
    kernel = np.asarray(pmn.fused_matmul_modnorm_residual_int8(*args))
    np.testing.assert_allclose(got, kernel, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    before = modnorm.fused_matmul_modnorm_residual_int8.launches
    with torch.no_grad():
        out = modnorm.fused_matmul_modnorm_residual_int8(
            _t(x), _t(w.T), _t(r), _t(g), _t(b), _t(sc), _t(sh))
    np.testing.assert_array_equal(out.numpy(), got)
    assert modnorm.fused_matmul_modnorm_residual_int8.launches == before


@pytest.mark.parametrize("K,D", [(1056, 1056), (1024, 1056), (1280, 1280)],
                         ids=["flagship_12x88", "flagship_8x128", "path_c_8x160"])
def test_int8_modnorm_quantized_plain_matches_wrapper_and_jax(K, D):
    """Kernel 19's entry on weights quantized once, at the widths its s8
    cluster plans cover (6 x 176, 8 x 128 ... of D): its CPU path on
    ``quant.quantize_colwise(w)`` equals the wrapper's bit for bit (the same
    quantization and the same (acc·sx)·sw order), and the JAX mirror at
    ``MODNORM_TOL``."""
    x, w, r, g, b, sc, sh = _modnorm_inputs(5, n=8, F=K, D=D)
    cpu = [_t(a) for a in (x, w.T, r, g, b, sc, sh)]
    before = modnorm.fused_matmul_modnorm_residual_int8.launches
    with torch.no_grad():
        wrapper = modnorm.fused_matmul_modnorm_residual_int8(*cpu)
        got = modnorm.matmul_modnorm_residual_int8_quantized(
            cpu[0], *quant.quantize_colwise(cpu[1]), *cpu[2:])
    assert torch.equal(got, wrapper)
    assert modnorm.fused_matmul_modnorm_residual_int8.launches == before
    mirror = np.asarray(pmn.reference_matmul_modnorm_residual_int8(
        *[jnp.asarray(a) for a in (x, w, r, g, b, sc, sh)]))
    np.testing.assert_allclose(got.numpy(), mirror, rtol=MODNORM_TOL, atol=MODNORM_TOL)


def test_int8_modnorm_scratch_bytes():
    """Kernel 19's scratch from the shapes: xq and sx, T·(K + 4) bytes;
    0.27 GB at 0.25° (264,960 tokens of the 8x128 heads' K = 1024), under
    the 0.3 GB that ``chip_smoke.py`` holds it to."""
    assert modnorm.matmul_modnorm_int8_scratch_bytes(16384, 1056) == 16384 * 1060
    quarter = modnorm.matmul_modnorm_int8_scratch_bytes(368 * 720, 1024)
    assert quarter == 264960 * 1028 and quarter < 0.3e9


def _wrapper_cases():
    x, w1, w2 = _ffn_inputs(3, T=32, D=32, H=48)
    mx, mw, r, g, b, sc, sh = _modnorm_inputs(4, n=16, F=32, D=32)
    return [
        (ffn.fused_swiglu_ffn_int8, [x, w1.T, w2.T], 0),
        (modnorm.fused_matmul_modnorm_residual_int8, [mx, mw.T, r, g, b, sc, sh], 0),
    ]


@pytest.mark.parametrize("which", [0, 1], ids=["kernel18", "kernel19"])
def test_int8_wrappers_are_inference_only(which):
    fn, arrays, _ = _wrapper_cases()[which]
    before = fn.launches
    cpu = [_t(a) for a in arrays]
    # autograd recording (an input requires grad, grad mode on): raise
    with pytest.raises(RuntimeError, match="inference-only"):
        fn(*[a.clone().requires_grad_(i == 1) for i, a in enumerate(cpu)])
    with torch.no_grad():  # the same inputs without recording: the plain version
        fn(*[a.clone().requires_grad_(i == 1) for i, a in enumerate(cpu)])
    # a forward-mode tangent on the activation: raise rather than drop it
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(cpu[0], torch.ones_like(cpu[0]))
        with pytest.raises(NotImplementedError, match="tangent"):
            fn(dual, *cpu[1:])
    assert fn.launches == before
    # not all on the CPU and not on one CUDA device: raise, never the plain path
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*[torch.empty(a.shape, device="meta") for a in cpu])


# -- on the card -----------------------------------------------------------------

def _card_close(fused, plain, args):
    with torch.no_grad():
        got, want = fused(*args), plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    assert torch.isfinite(got).all() and err <= 2e-2 * ref, (fused.__name__, err, ref)
    return err / ref


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,D,H,F", [(1000, 208, 272, 96), (136, 1056, 2816, 1056),
                                          (4096, 1056, 2816, 1024), (128, 32, 85, 32),
                                          (ffn.FFN_CHUNK_TOKENS + 136, 1056, 2816, 1056),
                                          (1000, 32, 85, 32), (1000, 1024, 272, 1024),
                                          (1000, 1280, 272, 1280), (1000, 1728, 272, 96)])
def test_int8_kernels_match_plain_on_card(tokens, D, H, F):
    """Kernels 18 and 19 in bf16 on the card against their plain versions,
    within 2e-2 of max|plain|: a token count that tiles neither kernel's
    rows, D that is not a multiple of 128, the flagship widths (F the
    12x88 and 8x128 attention widths), synthetic-tiny-scm's SwiGLU width
    85, which the wrapper pads to 96, and more tokens than one of kernel
    18's chunks (two, the second not a whole number of 128-row tiles);
    kernel 19's s8 cluster plans at D 32 and 208 (1 x 32 and 7 x 32), 1024
    (8 x 128), 1056 (6 x 176), 1280 (8 x 176) and 1728 (8 x 224, its widest
    column slice), K from 32 to 1280 (stages 128 int8 deep, the last one
    partly past K). The
    plain version runs on the weights padded to a multiple of 16
    (``torch._int_mm`` on the card takes widths that are multiples of 8
    only), equal to it on the unpadded ones bit for bit
    (:func:`test_int8_ffn_hidden_padding_is_exact`). Two calls of each
    kernel agree bit for bit (no atomics; kernel 18's h scale a max over
    fixed partials, kernel 19's row sums added in rank order), and kernel 19
    on weights quantized once equals its wrapper. Each wrapper counts one
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(11)

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(_rand(rng, shape, scale)).to("cuda", dtype)

    x = t((2, tokens // 2, D))
    w1, w2 = t((2 * H, D), D ** -0.5, torch.float32), t((D, H), H ** -0.5, torch.float32)
    before = ffn.fused_swiglu_ffn_int8.launches
    _card_close(ffn.fused_swiglu_ffn_int8,
                lambda x, w1, w2: ffn.reference_swiglu_ffn_int8(x, *ffn.pad_hidden(w1, w2, 16)),
                (x, w1, w2))
    with torch.no_grad():
        first, second = ffn.fused_swiglu_ffn_int8(x, w1, w2), ffn.fused_swiglu_ffn_int8(x, w1, w2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert ffn.fused_swiglu_ffn_int8.launches == before + 3
    args = (t((2, tokens // 2, F)), t((D, F), F ** -0.5, torch.float32), x,
            1.0 + t((D,), 0.1, torch.float32), t((D,), 0.1, torch.float32), t((2, D), 0.2),
            t((2, D), 0.2))
    before = modnorm.fused_matmul_modnorm_residual_int8.launches
    _card_close(modnorm.fused_matmul_modnorm_residual_int8,
                modnorm.reference_matmul_modnorm_residual_int8, args)
    with torch.no_grad():
        first = modnorm.fused_matmul_modnorm_residual_int8(*args)
        second = modnorm.fused_matmul_modnorm_residual_int8(*args)
        alone = modnorm.matmul_modnorm_residual_int8_quantized(
            args[0], *quant.quantize_colwise(args[1]), *args[2:])
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(alone, first)
    assert modnorm.fused_matmul_modnorm_residual_int8.launches == before + 4


@pytest.mark.cuda
def test_int8_qkv_product_on_card():
    """The int8 qkv product (``torch._int_mm``) at the flagship's widths,
    1056 -> 3168 (12x88) and 1056 -> 3072 (8x128), against the same
    quantized operands multiplied in fp32 (exact below 2^24)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_rand(rng, (2 * 4096, 1056))).to("cuda", torch.bfloat16)
    for n in (3168, 3072):
        w = torch.from_numpy(_rand(rng, (n, 1056), 1056 ** -0.5)).cuda()
        got = quant.int8_matmul(x, w)
        xq, sx = quant.quantize_rowwise(x)
        wq, sw = quant.quantize_colwise(w)
        want = (xq.double() @ wq.double().t()).float() * sx * sw
        torch.cuda.synchronize()
        assert torch.equal(got, want), n
