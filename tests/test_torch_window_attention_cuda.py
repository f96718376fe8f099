"""Kernels 21, 22b, 22t and 20, and the SwiGLU hidden padding, on the card.

Each kernel against its plain PyTorch version on the same bf16 inputs made
from a numpy seed, within 2e-2 of max|plain| (bf16 rounding of the outputs
and of p, dS and dP, which the kernel and the plain version round at the
same points but after sums in other orders):

* 21, 22b and 22t at n ∈ {1, 4, 16, 36, 64, 65, 100, 128, 129, 256, 257,
  1024} tokens a window and d ∈ {4, 8, 88, 128, 160, 256}: every form of
  kernel 21 (tiles of several whole window-heads where n <= 64, n 36 with
  64 ∤ n; a window's keys in one tile up to n 128; the online softmax past
  it, or past d 128), of kernel 22b (packed up to n 64 at d <= 128; past
  it the query pass in one walk up to n 128, in two from n 129, and the key
  pass, whose consumers split dv and dk̂ from d 128) and of kernel 22t
  (packed up to n 64 at d <= 128; past it one walk while the keys fit one
  key tile of 64, 32 past d 128 or 16 past d 192, else two), their
  element-wise load path (d 4) and their TMA path;
* kernels 21, 22b and 22t twice on the same inputs, bit for bit, and with
  BW·h·n not a multiple of 64 into outputs with guard rows before and after
  them, which must stay as they were (a store past a tile's live rows would
  reach rows another block writes);
* the per-head route of the model launching them, and only them, from qkv;
* 20 at D 1056, H 2816 and at D 32, H 85, against its plain version and,
  bit for bit, against its two launches called through their C entries
  (kernel 5's pass 1, then kernel 3 on the same h); kernels 5, 8, 9, 10 and
  11 at H = 85, which their wrappers zero-pad to 88.

All are marked ``cuda`` and skip without a card. The file imports neither
JAX nor flax (the card's machine has no flax): ``python -m pytest
tests/test_torch_window_attention_cuda.py -m cuda -q`` on the card.
"""

import numpy as np
import pytest
import torch

from swift_torch.ops import block_attention, ffn, window_attention as wa

TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return np.random.default_rng(11)


def _t(rng, shape, scale=1.0, dtype=torch.bfloat16):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _agree(got, want, what):
    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.float() - w.float()).abs().max().item()
        ref = w.float().abs().max().item()
        assert torch.isfinite(g).all() and err <= TOL * ref, (what, i, err, ref)


def _normalized(rng, shape):
    q, k = (_t(rng, shape, dtype=torch.float32) for _ in range(2))
    qn = (q * torch.rsqrt((q * q).sum(-1, keepdim=True)) * 10.0).to(torch.bfloat16)
    kn = (k * torch.rsqrt((k * k).sum(-1, keepdim=True))).to(torch.bfloat16)
    return qn, kn


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 8, 88, 128, 160, 256])
@pytest.mark.parametrize("n", [1, 4, 16, 36, 64, 65, 100, 128, 129, 256, 257, 1024])
def test_window_attention_kernels_match_plain(card, n, d):
    rng = card
    shape = (max(2, 256 // n), 3, n, d)
    q, k = _normalized(rng, shape)
    v, do, tq, tk, tv = (_t(rng, shape) for _ in range(5))
    counts = [f.launches for f in (wa.window_attention, wa.window_attention_bwd,
                                   wa.window_attention_tangent)]
    _agree(wa.window_attention(q, k, v), wa.reference_sdpa(q, k, v), "21")
    _agree(wa.window_attention_bwd(q, k, v, do), wa.reference_sdpa_bwd(q, k, v, do), "22b")
    _agree(wa.window_attention_tangent(q, k, v, tq, tk, tv),
           wa.reference_sdpa_tangent(q, k, v, tq, tk, tv), "22t")
    assert [f.launches for f in (wa.window_attention, wa.window_attention_bwd,
                                 wa.window_attention_tangent)] == [c + 1 for c in counts]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["21", "22b", "22t"])
@pytest.mark.parametrize("n,d", [(4, 8), (36, 88), (64, 88), (257, 88), (256, 160), (1024, 88),
                                 (36, 4)])
def test_window_attention_is_deterministic(card, n, d, kernel):
    """Kernels 21, 22b and 22t twice on the same inputs: the same bits in
    every output (no atomics, one order of every sum; for 22b in both passes
    of its row form, for 22t in both walks of its)."""
    q, k = _normalized(card, (max(2, 256 // n), 3, n, d))
    v, do, tq, tk, tv = (_t(card, q.shape) for _ in range(5))
    call = {"21": lambda: (wa.window_attention(q, k, v),),
            "22b": lambda: wa.window_attention_bwd(q, k, v, do),
            "22t": lambda: (wa.window_attention_tangent(q, k, v, tq, tk, tv),)}[kernel]
    first = call()
    for a, b in zip(first, call()):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,d", [(7, 4, 8), (5, 36, 88), (3, 100, 88), (3, 257, 88),
                                    (3, 257, 160), (5, 36, 4), (3, 100, 20)])
def test_window_attention_leaves_guard_rows(card, bh, n, d):
    """BW·h·n rows, not a multiple of 64, written through the C entry into
    the middle of a buffer filled with a sentinel: the output agrees with
    the plain version and the 64 rows before and after it keep the
    sentinel, so no tile's store reaches past its live rows."""
    from swift_torch.ops import _build

    q, k = _normalized(card, (bh, 1, n, d))
    v = _t(card, q.shape)
    guard = 64 * d
    buf = torch.full((2 * guard + bh * n * d,), -7.0, device="cuda", dtype=torch.bfloat16)
    o = buf[guard:guard + bh * n * d]
    assert o.data_ptr() % 16 == 0
    _build.check_launch(_build.library().swift_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, n, d, _build.stream()),
        "window_attention")
    _agree(o.view(q.shape), wa.reference_sdpa(q, k, v), "21")
    assert (buf[:guard] == -7.0).all() and (buf[guard + bh * n * d:] == -7.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,d", [(7, 4, 8), (5, 36, 88), (3, 100, 88), (3, 257, 88),
                                    (3, 257, 160), (5, 36, 4), (3, 100, 20), (5, 36, 160)])
def test_window_attention_bwd_leaves_guard_rows(card, bh, n, d):
    """Kernel 22b through its C entry, BW·h·n rows not a multiple of 64:
    dq, dk and dv, each written into the middle of a buffer filled with a
    sentinel, agree with the plain version, and the 64 rows before and
    after each keep the sentinel (packed and row forms, TMA and
    element-wise paths)."""
    from swift_torch.ops import _build

    q, k = _normalized(card, (bh, 1, n, d))
    v, do = _t(card, q.shape), _t(card, q.shape)
    guard, size = 64 * d, bh * n * d
    bufs = [torch.full((2 * guard + size,), -7.0, device="cuda", dtype=torch.bfloat16)
            for _ in range(3)]
    outs = [b[guard:guard + size] for b in bufs]
    assert all(o.data_ptr() % 16 == 0 for o in outs)
    stats = torch.empty(wa.bwd_scratch_floats(bh, n, d), device="cuda", dtype=torch.float32)
    _build.check_launch(_build.library().swift_window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *(o.data_ptr() for o in outs),
        stats.data_ptr(), bh, n, d, _build.stream()), "window_attention_bwd")
    _agree(tuple(o.view(q.shape) for o in outs), wa.reference_sdpa_bwd(q, k, v, do), "22b")
    for b in bufs:
        assert (b[:guard] == -7.0).all() and (b[guard + size:] == -7.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,d", [(7, 4, 8), (5, 36, 88), (3, 100, 88), (3, 257, 88),
                                    (3, 257, 160), (5, 36, 4), (3, 100, 20), (5, 36, 160),
                                    (5, 20, 256)])
def test_window_attention_tangent_leaves_guard_rows(card, bh, n, d):
    """Kernel 22t through its C entry, BW·h·n rows not a multiple of 64: the
    tangent, written into the middle of a buffer filled with a sentinel,
    agrees with the plain version, and the 64 rows before and after it keep
    the sentinel (packed form, row form in one walk and in two, TMA and
    element-wise paths)."""
    from swift_torch.ops import _build

    q, k = _normalized(card, (bh, 1, n, d))
    v, tq, tk, tv = (_t(card, q.shape) for _ in range(4))
    guard, size = 64 * d, bh * n * d
    buf = torch.full((2 * guard + size,), -7.0, device="cuda", dtype=torch.bfloat16)
    out = buf[guard:guard + size]
    assert out.data_ptr() % 16 == 0
    _build.check_launch(_build.library().swift_window_attention_tangent(
        *(t.data_ptr() for t in (q, k, v, tq, tk, tv)), out.data_ptr(), bh, n, d,
        _build.stream()), "window_attention_tangent")
    _agree(out.view(q.shape), wa.reference_sdpa_tangent(q, k, v, tq, tk, tv), "22t")
    assert (buf[:guard] == -7.0).all() and (buf[guard + size:] == -7.0).all()


@pytest.mark.cuda
def test_window_attention_refuses_what_it_cannot_take(card):
    q = _t(card, (2, 2, 16, 264))
    with pytest.raises(ValueError, match="d=264"):
        wa.window_attention(q, q, q)
    with pytest.raises(ValueError, match="bfloat16"):
        wa.window_attention(q[..., :8].float(), q[..., :8].float(), q[..., :8].float())


@pytest.mark.cuda
@pytest.mark.parametrize("window,shift,heads,d", [((8, 8), (4, 4), 4, 88),
                                                  ((2, 2), (1, 1), 4, 8),
                                                  ((16, 16), (8, 8), 2, 160)])
def test_per_head_route_launches_only_its_kernels(card, window, shift, heads, d):
    """From qkv, the route (the roll, windows, head split, the normalisation
    in PyTorch, kernel 21 and the inverse layout) against the plain
    whole-grid attention, under autograd (22b: dqkv and the logit scale's
    gradient) and forward_ad (22t)."""
    from torch.autograd import forward_ad

    rng = card
    qkv = _t(rng, (2, 16, 32, heads * 3 * d)).requires_grad_()
    scale = torch.exp(_t(rng, (heads,), 0.3, torch.float32) + np.log(10.0)).requires_grad_()
    fixed = [block_attention.fused_block_attention, block_attention.block_attention_bwd,
             block_attention.block_attention_tangent, block_attention.fused_tiled_block_attention,
             block_attention.tiled_block_attention_bwd,
             block_attention.tiled_block_attention_tangent]
    before = [f.launches for f in fixed]
    per_head = [wa.window_attention, wa.window_attention_bwd, wa.window_attention_tangent]
    start = [f.launches for f in per_head]
    out = block_attention.per_head_window_attention(qkv, scale, heads, window, shift)
    dout = _t(rng, out.shape)
    g, gs = torch.autograd.grad(out, (qkv, scale), dout)
    scale = scale.detach()
    plain = block_attention.reference_block_attention(qkv.detach(), scale, heads, window, shift)
    _agree(out, plain, "forward")
    _agree((g, gs), block_attention.reference_block_attention_bwd(
        qkv.detach(), scale, dout, heads, window, shift), "dqkv, dscale")
    tq = _t(rng, qkv.shape)
    with torch.no_grad(), forward_ad.dual_level():
        tangent = forward_ad.unpack_dual(block_attention.per_head_window_attention(
            forward_ad.make_dual(qkv.detach(), tq), scale, heads, window, shift)).tangent
        _agree(tangent, block_attention.reference_block_attention_tangent(
            qkv.detach(), tq, scale, heads, window, shift), "tangent")
    assert [f.launches for f in per_head] == [s + n for s, n in zip(start, (2, 1, 1))]
    assert [f.launches for f in fixed] == before


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(1056, 2816), (32, 85)])
def test_ffn_modnorm_kernel_matches_plain(card, D, H):
    rng = card
    B, N = 2, 512
    args = (_t(rng, (B, N, D)), _t(rng, (2 * H, D), D ** -0.5), _t(rng, (D, H), H ** -0.5),
            1.0 + _t(rng, (D,), 0.1, torch.float32), _t(rng, (D,), 0.1, torch.float32),
            _t(rng, (B, D), 0.2), _t(rng, (B, D), 0.2))
    n0 = ffn.fused_swiglu_ffn_modnorm.launches
    _agree(ffn.fused_swiglu_ffn_modnorm(*args), ffn.reference_swiglu_ffn_modnorm(*args), "20")
    assert ffn.fused_swiglu_ffn_modnorm.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(1056, 2816), (32, 85)])
def test_ffn_modnorm_equals_hidden_then_kernel_3(card, D, H):
    """Kernel 20 is kernel 5's pass 1 (``swift_swiglu_hidden``) then kernel
    3 (``swift_mm_modnorm``) on the same h with the residual x: the wrapper's
    output equals those two C entries called in turn bit for bit (one chunk
    and one piece at these shapes, ``ffn_modnorm_pieces``)."""
    from swift_torch.ops import _build

    rng = card
    B, N = 2, 512
    x, w1, w2 = _t(rng, (B, N, D)), _t(rng, (2 * H, D), D ** -0.5), _t(rng, (D, H), H ** -0.5)
    ep = (1.0 + _t(rng, (D,), 0.1, torch.float32), _t(rng, (D,), 0.1, torch.float32),
          _t(rng, (B, D), 0.2), _t(rng, (B, D), 0.2))
    assert ffn.ffn_modnorm_pieces(B * N, N) == [((0, B * N), [(0, B * N)])]
    got = ffn.fused_swiglu_ffn_modnorm(x, w1, w2, *ep)
    w1p, w2p = ffn.pad_hidden(w1, w2)
    Hp = w2p.shape[1]
    lib, stream = _build.library(), _build.stream()
    h = torch.empty(B * N, Hp, device="cuda", dtype=torch.bfloat16)
    want = torch.empty_like(x)
    _build.check_launch(lib.swift_swiglu_hidden(x.data_ptr(), w1p.data_ptr(), h.data_ptr(),
                                                B * N, D, Hp, stream), "swiglu_hidden")
    _build.check_launch(lib.swift_mm_modnorm(
        h.data_ptr(), w2p.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in ep), want.data_ptr(),
        B * N, Hp, D, N, 1e-6, stream), "mm_modnorm")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ffn.fused_swiglu_ffn_modnorm(x, w1, w2, *ep), got)


@pytest.mark.cuda
def test_ffn_modnorm_chunks_equal_one_chunk(card, monkeypatch):
    """Kernel 20 over token chunks of 384 (``FFN_CHUNK_TOKENS`` lowered), the
    middle one straddling the samples' boundary so that kernel 3 runs on
    two pieces of it, equals the run in one chunk bit for bit: every row's
    sums run in the same order wherever its tile lies."""
    rng = card
    B, N, D, H = 2, 512, 1056, 2816
    args = (_t(rng, (B, N, D)), _t(rng, (2 * H, D), D ** -0.5), _t(rng, (D, H), H ** -0.5),
            1.0 + _t(rng, (D,), 0.1, torch.float32), _t(rng, (D,), 0.1, torch.float32),
            _t(rng, (B, D), 0.2), _t(rng, (B, D), 0.2))
    whole = ffn.fused_swiglu_ffn_modnorm(*args)
    monkeypatch.setattr(ffn, "FFN_CHUNK_TOKENS", 384)
    assert [len(pieces) for _, pieces in ffn.ffn_modnorm_pieces(B * N, N)] == [1, 2, 1]
    assert torch.equal(ffn.fused_swiglu_ffn_modnorm(*args), whole)


@pytest.mark.cuda
def test_ffn_kernels_take_hidden_85(card):
    """The tiny experiment's SwiGLU width: kernels 5, 8, 9, 10 and 11 with
    the weights zero-padded to H = 88 inside their wrappers; kernel 8's g
    and u stay at 88 for kernel 9."""
    rng = card
    T, D, H = 300, 32, 85
    x, dx, dy = _t(rng, (T, D)), _t(rng, (T, D)), _t(rng, (T, D))
    w1, w2 = _t(rng, (2 * H, D), D ** -0.5), _t(rng, (D, H), H ** -0.5)
    g, u = _t(rng, (T, H)), _t(rng, (T, H))
    _agree(ffn.fused_swiglu_ffn(x, w1, w2), ffn.reference_swiglu_ffn(x, w1, w2), "5")
    # kernel 8 keeps g and u at the kernels' width 88, zero in the padded units, and kernel 9
    # takes them so
    y, g8, u8 = ffn.swiglu_ffn_fwd_save(x, w1, w2)
    assert g8.shape == u8.shape == (T, 88) and not g8[:, H:].any() and not u8[:, H:].any()
    _agree((y, g8[:, :H], u8[:, :H]), ffn.reference_swiglu_ffn_fwd_save(x, w1, w2), "8")
    pad = lambda a: torch.nn.functional.pad(a, (0, 88 - H))  # noqa: E731
    _agree(ffn.swiglu_ffn_bwd_saved(x, dy, pad(g), pad(u), w1, w2),
           ffn.reference_swiglu_ffn_bwd_saved(x, dy, g, u, w1, w2), "9")
    _agree(ffn.swiglu_ffn_bwd_recompute(x, dy, w1, w2),
           ffn.reference_swiglu_ffn_bwd_recompute(x, dy, w1, w2), "10")
    _agree(ffn.swiglu_ffn_pt(x, dx, w1, w2), ffn.reference_swiglu_ffn_pt(x, dx, w1, w2), "11")
