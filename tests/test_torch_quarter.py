"""The port's 0.25° path against the JAX package, on the CPU.

* The plain versions of the window-tiled attention (kernels 15, 16, 17):
  forward, dqkv/dscale and the jvp tangent of
  ``fused_tiled_block_attention`` against the JAX package's, run in
  interpret mode as its own kernel tests run it, and against
  ``reference_block_attention``, at a shift the whole-grid kernel takes,
  one it cannot, and none.
* The plain version of the recompute FFN backward (kernel 10) against
  ``pallas_ffn._ffn_bwd_call`` interpreted, and the wrapper's route above
  ``SWIFT_FFN_BWD_SAVE_MAX_TOKENS``.
* The port's attention routing against the JAX gates.
* A tiny ``SwinV2`` with a latitude that needs edge-padding, the factorized
  position embedding and the tiled route: forward, every gradient and the
  jvp tangent against the JAX model's jnp path, and value and gradient
  against its tiled Pallas route interpreted.
* The converter and checkpoint round trip of the factorized tables, the
  0.25° latitude weights, FLOP count and optimizer labels, and
  ``swift_torch.train`` then ``generate`` on the CPU with
  ``era5-swinv2-0.25-scm`` cut to a tiny width and grid.

fp32 from numpy seeds. Tolerances: 2e-5 for values and 2e-4 for gradients
and tangents of the attention (the JAX package's own tiled test), 2e-5 for
the FFN backward (fp32 sums over a few hundred terms in different orders),
rtol 1e-4 for the model (fp32 through two blocks).
"""

import functools
import json

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
import swift_tpu.training.trainer as jtrainer
import swift_torch.models.swinv2 as tswinv2
from swift_torch import config as cfglib
from swift_torch import generate, train
from swift_torch.models import convert
from swift_torch.models.precond import PassPrecond as TorchPassPrecond
from swift_torch.ops import block_attention, ffn
from swift_torch.training import loss as tloss
from swift_torch.training import trainer as ttrainer
from swift_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.models.precond import PassPrecond
from swift_tpu.models.swinv2 import SwinV2
from swift_tpu.utils.checkpoint import load_checkpoint as load_checkpoint_jax

TOL, GTOL = 2e-5, 2e-4


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


def _close(got, want, tol, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(got, "detach") else got),
                               np.asarray(want), rtol=tol, atol=tol, err_msg=err_msg)


# -- kernels 15, 16, 17: the window-tiled attention -------------------------------

@pytest.mark.parametrize("shift", [(0, 0), (2, 8), (3, 4)])
def test_tiled_attention_plain_matches_pallas(shift):
    """The JAX package's tiled test geometry (8×32 grid, (4, 8) windows);
    (3, 4) is a width shift the whole-grid kernel cannot take. Loss
    sum(out²), as there."""
    heads, d, win = 3, 8, (4, 8)
    rng = np.random.default_rng(60)
    qkv = _rand(rng, (2, 8, 32, heads * 3 * d))
    scale = np.exp(_rand(rng, (heads,), 0.1) + 1.0)
    tqkv = _rand(rng, qkv.shape)
    jq, js = jnp.asarray(qkv), jnp.asarray(scale)

    def jfused(a, s):
        return pba.fused_tiled_block_attention(a, s, heads, win, shift)

    def jref(a, s):
        return pba.reference_block_attention(a, s, heads, win, shift)

    q, s = _t(qkv, True), _t(scale, True)
    out = block_attention.fused_tiled_block_attention(q, s, heads, win, shift)
    for want in (jfused(jq, js), jref(jq, js)):
        _close(out, want, TOL, "out")

    (out ** 2).sum().backward()
    for fn in (jfused, jref):
        jg = jax.grad(lambda a, b: jnp.sum(fn(a, b) ** 2), argnums=(0, 1))(jq, js)
        _close(q.grad, jg[0], GTOL, "dqkv")
        _close(s.grad, jg[1], GTOL, "dscale")

    with torch.no_grad(), forward_ad.dual_level():
        dual = forward_ad.make_dual(_t(qkv), _t(tqkv))
        tangent = forward_ad.unpack_dual(
            block_attention.fused_tiled_block_attention(dual, _t(scale), heads, win, shift)
        ).tangent.clone()
    _, jt = jax.jvp(lambda a: pba.fused_tiled_block_attention(a, js, heads, win, shift,
                                                              jvp=True),
                    (jq,), (jnp.asarray(tqkv),))
    _, rt = jax.jvp(lambda a: jref(a, js), (jq,), (jnp.asarray(tqkv),))
    for want in (jt, rt):
        _close(tangent, want, GTOL, "tangent")


def test_tiled_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the three wrappers take their plain versions (the
    whole-grid ones on pre-rolled qkv) and count no launch."""
    heads, win = 2, (4, 8)
    rng = np.random.default_rng(61)
    qkv, tqkv = _t(_rand(rng, (1, 8, 16, heads * 24))), _t(_rand(rng, (1, 8, 16, heads * 24)))
    scale, dout = _t(np.exp(_rand(rng, (heads,), 0.1))), _t(_rand(rng, (1, 8, 16, heads * 8)))
    before = (block_attention.fused_tiled_block_attention.launches,
              block_attention.tiled_block_attention_bwd.launches,
              block_attention.tiled_block_attention_tangent.launches)
    pairs = [
        (block_attention.fused_tiled_block_attention(qkv, scale, heads, win),
         block_attention.reference_block_attention(qkv, scale, heads, win)),
        (block_attention.tiled_block_attention_bwd(qkv, scale, dout, heads, win)[0],
         block_attention.reference_block_attention_bwd(qkv, scale, dout, heads, win)[0]),
        (block_attention.tiled_block_attention_tangent(qkv, tqkv, scale, heads, win),
         block_attention.reference_block_attention_tangent(qkv, tqkv, scale, heads, win)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert before == (block_attention.fused_tiled_block_attention.launches,
                      block_attention.tiled_block_attention_bwd.launches,
                      block_attention.tiled_block_attention_tangent.launches)


# -- kernel 10: the recompute FFN backward ------------------------------------------

def test_ffn_bwd_recompute_plain_matches_pallas(monkeypatch):
    """384 tokens in three 128-token tiles of the TPU kernel's sequential
    weight-gradient sum, the save budget lowered so that JAX's vjp takes
    ``_ffn_bwd_call``."""
    monkeypatch.setenv("SWIFT_FFN_BWD_SAVE_MAX_TOKENS", "64")
    rng = np.random.default_rng(62)
    T, D, H = 384, 32, 40
    x, dy = _rand(rng, (T, D)), _rand(rng, (T, D))
    w1, w2 = _rand(rng, (2 * H, D), D ** -0.5), _rand(rng, (D, H), H ** -0.5)  # torch layout
    w1j = jnp.asarray(w1.T)
    direct = pffn._ffn_bwd_call(jnp.asarray(x), jnp.asarray(dy), w1j[:, :H], w1j[:, H:],
                                jnp.asarray(w2.T))
    assert not pffn._bwd_save_acts(T)
    _, vjp = jax.vjp(pffn.fused_swiglu_ffn, jnp.asarray(x), w1j, jnp.asarray(w2.T))
    jdx, jdw1, jdw2 = vjp(jnp.asarray(dy))
    _close(np.concatenate([direct[1], direct[2]], axis=1), jdw1, TOL, "direct dw1")

    got = ffn.reference_swiglu_ffn_bwd_recompute(_t(x), _t(dy), _t(w1), _t(w2))
    for g, want, name in zip(got, (jdx, np.asarray(jdw1).T, np.asarray(jdw2).T),
                             ("dx", "dw1", "dw2")):
        _close(g, want, TOL, name)

    # the wrapper's route above the budget: kernel 5 saves x only, kernel
    # 10's plain version recomputes gate and up
    args = [_t(x, True), _t(w1, True), _t(w2, True)]
    torch.autograd.backward(ffn.fused_swiglu_ffn(*args), _t(dy))
    for a, want, name in zip(args, got, ("dx", "dw1", "dw2")):
        _close(a.grad, want, TOL, name)
    with pytest.raises(NotImplementedError, match="swiglu_ffn_bwd_recompute.*no tangent"):
        with torch.no_grad(), forward_ad.dual_level():
            ffn.swiglu_ffn_bwd_recompute(forward_ad.make_dual(_t(x), _t(dy)), _t(dy), _t(w1),
                                         _t(w2))


# -- the routing ----------------------------------------------------------------

ROUTES = [
    # (grid, window, shift, heads, head dim)
    ((64, 128), (16, 16), (8, 8), 12, 88),    # 1.4°, the checkpoint layout
    ((64, 128), (16, 16), (8, 8), 8, 128),    # 1.4°, hd128
    ((64, 128), (16, 16), (0, 0), 12, 88),
    ((368, 720), (16, 16), (8, 8), 8, 128),   # 0.25°, the configuration of record
    ((368, 720), (16, 16), (8, 8), 12, 88),
    ((368, 720), (16, 16), (0, 0), 8, 128),
    ((8, 16), (4, 8), (0, 0), 3, 8),          # the JAX kernel tests' shapes
    ((8, 16), (4, 8), (2, 8), 3, 8),
    ((8, 32), (4, 8), (3, 4), 3, 8),
    ((8, 16), (2, 4), (1, 2), 2, 16),         # the port's tiny model tests
    ((4, 8), (2, 2), (1, 1), 2, 16),
]


@pytest.mark.parametrize("grid,window,shift,heads,d", ROUTES)
def test_routing_matches_jax_gates(grid, window, shift, heads, d):
    inner = heads * d
    jblock = pba.block_attention_eligible(grid, window, shift, heads, inner)
    jtiled = pba.tiled_block_attention_eligible(grid, window, heads, inner)
    assert block_attention.block_attention_eligible(grid, window, shift, heads, inner) == jblock
    assert block_attention.tiled_block_attention_eligible(grid, window, heads, inner) == jtiled
    want = "block" if jblock else "tiled" if jtiled else "per_head"
    assert block_attention.attention_route(grid, window, shift, heads, inner) == want
    if grid == (368, 720):
        assert want == "tiled" if shift == (8, 8) else True
    if grid == (64, 128):
        assert want == "block"


def test_per_head_route_raises_on_the_card_only():
    rng = np.random.default_rng(63)
    qkv, scale = _t(_rand(rng, (1, 8, 16, 2 * 48))), _t(np.ones(2, np.float32))
    torch.testing.assert_close(
        block_attention.per_head_window_attention(qkv, scale, 2, (2, 4), (1, 2)),
        block_attention.reference_block_attention(qkv, scale, 2, (2, 4), (1, 2)))
    with pytest.raises(NotImplementedError, match="kernels 21 and 22"):
        block_attention.per_head_window_attention(qkv.to("meta"), scale.to("meta"), 2, (2, 4),
                                                  (1, 2))


# -- the model: latitude padding, factorized position embedding, tiled route -------

RES, C, F_ = (30, 64), 3, 1  # 30 rows: patch 2 × window 4 pads to 32 (grid 16×32)
QUARTER = dict(window_size=(4, 8), shift_size=(2, 4), patch_size=(2, 2), depth=2, dim=32,
               heads=2, head_dim=16, auxiliary_dim=1, logvar=True, pos_embed_mode="factorized")


def _quarter_pair(seed, **jax_kw):
    kw = dict(img_resolution=RES, in_channels=2 * C + F_, out_channels=C, **QUARTER)
    jpre = PassPrecond(model=SwinV2(**kw, dtype=jnp.float32, **jax_kw), img_resolution=RES,
                       img_channels=C, condition_channels=C + F_, auxiliary_dim=1)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32) + np.asarray(a),
        jpre.init(jax.random.PRNGKey(seed)))
    tpre = TorchPassPrecond(tswinv2.SwinV2(**kw, dtype=torch.float32), RES, C,
                            condition_channels=C + F_, auxiliary_dim=1)
    tpre.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.params_to_state_dict(params).items()})
    return jpre, params, tpre


def _quarter_batch(seed, B=2):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (B, *RES, C)), _rand(rng, (B, *RES, C + F_)),
            rng.uniform(0.1, 1.5, (B,)).astype(np.float32),
            rng.uniform(0.5, 2.5, (B, 1)).astype(np.float32), _rand(rng, (B, *RES, C)))


def _model_close(got, want, name, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-3), err_msg=name)


def _force_tiled(monkeypatch):
    calls = []

    def route(*args):
        calls.append(args)
        return "tiled"

    monkeypatch.setattr(tswinv2, "attention_route", route)
    return calls


@pytest.mark.parametrize("jax_route", ["jnp", "tiled"])
def test_quarter_swinv2_matches_jax(jax_route, monkeypatch):
    """Forward and every gradient of the port (the tiled route forced,
    plain versions on the CPU) against the JAX model on its jnp path
    (``use_pallas=False``) and on its tiled Pallas route, interpreted (the
    whole-grid gate closed so every block takes it)."""
    calls = _force_tiled(monkeypatch)
    jax_kw = {"use_pallas": False}
    if jax_route == "tiled":
        monkeypatch.setattr(pba, "block_attention_eligible", lambda *a: False)
        jax_kw = {"use_pallas": True}
    jpre, params, tpre = _quarter_pair(70, **jax_kw)
    x, cond, t, aux, dout = _quarter_batch(71)

    def f(p):
        return jpre.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(aux))

    jout, vjp = jax.vjp(f, params)
    (jg,) = vjp(jnp.asarray(dout))
    out = tpre(_t(x), _t(t), _t(cond), _t(aux))
    assert out.shape == (2, *RES, C) and len(calls) == 2
    _model_close(out, jout, "forward")
    torch.autograd.backward(out, _t(dout))
    want = convert.params_to_state_dict(jax.device_get(jg))
    got = {n: p.grad for n, p in tpre.named_parameters()}
    assert sorted(got) == sorted(want)
    assert "model.pos_embed_row" in got and "model.pos_embed" not in got
    for n in want:
        if got[n] is None:  # the logvar head, unused by this output
            assert not np.any(want[n]), n
            continue
        _model_close(got[n], want[n], n)


@pytest.mark.parametrize("jax_route", ["jnp", "tiled"])
def test_quarter_swinv2_tangent_matches_jax_jvp(jax_route, monkeypatch):
    """The port's jvp forward on the tiled route (kernels 14, 15 + 17, 11 by
    their plain versions) against ``jax.jvp`` of the JAX model on its jnp
    path and on its tiled route with the pre-roll (``cyclic_roll2``),
    interpreted: the route the JAX package's own tests leave without a
    model-level jvp test."""
    _force_tiled(monkeypatch)
    jax_kw = {"use_pallas": False}
    if jax_route == "tiled":
        monkeypatch.setattr(pba, "block_attention_eligible", lambda *a: False)
        jax_kw = {"use_pallas": True}
    jpre, params, tpre = _quarter_pair(72, **jax_kw)
    x, cond, t, aux, _ = _quarter_batch(73)
    rng = np.random.default_rng(74)
    vx, vt = _rand(rng, x.shape), _rand(rng, t.shape)

    def f(xi, ti):
        return jpre.apply(params, xi, ti, jnp.asarray(cond), jnp.asarray(aux), jvp=True)

    jout, jdout = jax.jvp(f, (jnp.asarray(x), jnp.asarray(t)), (jnp.asarray(vx), jnp.asarray(vt)))
    with torch.no_grad(), forward_ad.dual_level():
        out = tpre(forward_ad.make_dual(_t(x), _t(vx)), forward_ad.make_dual(_t(t), _t(vt)),
                   _t(cond), _t(aux), jvp=True)
        out, dout = forward_ad.unpack_dual(out)
        out, dout = out.clone(), dout.clone()
    _model_close(out, jout, "primal")
    _model_close(dout, jdout, "tangent")


def test_quarter_routes_without_forcing():
    """Unforced, the tiny model takes the JAX model's routes: the whole-grid
    kernels for the unshifted block, the tiled ones for the shifted block
    (its width shift 4 is not 8-aligned)."""
    _, _, tpre = _quarter_pair(75)
    blk = tpre.model.transformer.layers
    routes = [block_attention.attention_route(tpre.model.grid_size, a.window_size, a.shift,
                                              a.heads, a.heads * a.head_dim)
              for a, _ in blk]
    assert routes == ["block", "tiled"]


# -- converter, checkpoint, the 0.25° loss, FLOP count and labels ------------------

def test_factorized_tables_round_trip(tmp_path):
    jpre, params, tpre = _quarter_pair(76)
    sd = convert.params_to_state_dict(params)
    assert sd["model.pos_embed_row"].shape == (1, 16, 1, 32)
    assert sd["model.pos_embed_col"].shape == (1, 1, 32, 32)
    back = convert.state_dict_to_params(sd, depth=2)
    flat_j, flat_b = convert.flatten(jax.device_get(params)), convert.flatten(back)
    for k in ("pos_embed_row", "pos_embed_col"):
        np.testing.assert_array_equal(flat_b[k], np.asarray(flat_j[k]))
    # through the port's checkpoint file, into the JAX loader and back
    ckpt = str(tmp_path / "checkpoint-000000.npz")
    save_checkpoint(ckpt, tpre.state_dict(), depth=2)
    loaded = load_checkpoint(ckpt)
    for k, v in tpre.state_dict().items():
        assert torch.equal(loaded[k], v), k
    init = jpre.init(jax.random.PRNGKey(0))
    restored = load_checkpoint_jax(ckpt, {"ema": init})["ema"]
    again = convert.params_to_state_dict(jax.device_get(restored))
    for k, v in sd.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_quarter_latitude_weights_flops_and_labels():
    """721 rows: the poles' cos = 0 weights clamp to 0.1, as the JAX loss
    has them; ``swin_flop_count`` at the raw 721×1440 grid, as the JAX
    ``train.py`` calls it; the factorized tables are top-level, so Muon's
    labels give them to Adam and the AdamW mask does not decay them."""
    w = tloss.latitude_weights(721)
    np.testing.assert_allclose(w, np.asarray(jloss.latitude_weights(721)), rtol=1e-6)
    assert w.shape == (1, 721, 1, 1) and w[0, 0, 0, 0] == np.float32(0.1) == w[0, -1, 0, 0]
    args = ((721, 1440), 1, 12, 2 * 69 + 3, 1056, 2816, (2, 2), (16, 16))
    assert ttrainer.swin_flop_count(*args) == jtrainer.swin_flop_count(*args)
    jpre, params, tpre = _quarter_pair(77)
    named = list(tpre.named_parameters())
    labels = ttrainer.muon_param_labels(named)
    mask = ttrainer.adamw_decay_mask([n for n, _ in named])

    def by_name(tree):  # a per-leaf flag as arrays of the leaves' shapes, by torch name
        flags = jax.tree_util.tree_map(lambda p, f: np.full(np.shape(p), float(f)), params, tree)
        return {n: bool(v.flat[0]) for n, v in convert.params_to_state_dict(flags).items()}

    jmuon = by_name(jax.tree_util.tree_map(lambda lab: lab == "muon",
                                           jtrainer.muon_param_labels(params)))
    jmask = by_name(jtrainer.adamw_decay_mask(params))
    for n in ("model.pos_embed_row", "model.pos_embed_col"):
        assert labels[n] == "adam" and not mask[n]
    for n, _ in named:
        assert (labels[n] == "muon") == jmuon[n], n
        assert mask[n] == jmask[n], n


# -- the 0.25° experiment through train and generate ------------------------------

SURFACE = ["2m_temperature", "10m_u_component_of_wind", "10m_v_component_of_wind",
           "mean_sea_level_pressure"]
TINY = ["model.dim=32", "model.heads=2", "model.head_dim=16", "model.depth=2",
        "model.window_size=[4,8]", "model.shift_size=[2,4]"]


def test_quarter_experiment_trains_and_forecasts_on_cpu(tmp_path, monkeypatch):
    """``experiment=era5-swinv2-0.25-scm`` (sCM, Muon, factorized table,
    batch 1) cut to width 32 and depth 2 on a synthetic 30×64 grid with the
    experiment's 69 + 3 channels: two steps on the CPU, then a two-step
    forecast of the EMA through ``generate``, whose store keeps the raw
    30 rows."""
    cfg = cfglib.compose("train", ["experiment=era5-swinv2-0.25-scm"])
    ds_cfg = cfg["data"]["dataset"]
    variables, forcings = list(ds_cfg["variables"]), list(ds_cfg["forcings"])
    assert (len(variables), len(forcings)) == (69, 3)
    make_synthetic_era5(str(tmp_path / "wb2" / "0.25deg_1_step_6hr_h5df"), variables, forcings,
                        n_train=6, n_val=1, n_test=4, shape=RES)
    monkeypatch.setenv("SWIFT_DATA_ROOT", str(tmp_path / "wb2"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RUN_ID", "q1")
    argv = ["experiment=era5-swinv2-0.25-scm", *TINY, "trainer.total_kimg=0.002",
            "trainer.kimg_per_tick=0.001", "trainer.lr_rampup_kimg=0", "data.data_workers=1",
            "--device", "cpu"]
    trainer, loader, cfg = train.setup(argv)
    net = trainer.net.model
    assert (net.pos_embed_mode, net.lat_pad, net.grid_size) == ("factorized", 2, (16, 32))
    assert type(trainer.loss_fn) is tloss.SCMLoss and trainer.global_batch_size == 1
    before = {n: p.detach().clone() for n, p in trainer.net.named_parameters()}
    trainer.train(loader)
    assert trainer.updates == 2
    assert all(not torch.equal(p.detach(), before[n]) for n, p in trainer.net.named_parameters())
    run = tmp_path / "results" / "era5-swinv2-0.25-scm" / "q1"
    lines = [json.loads(line) for line in (run / "stats.jsonl").read_text().splitlines()]
    assert np.isfinite(lines[-1]["train/loss"]["mean"])

    ofile = generate.cli(["--input", str(run), "--members", "1", "--steps", "2", "--batch",
                          "1", "--samples", "1", "--segment", "1", "--device", "cpu"])
    store = generate.read_store(ofile)
    assert store["2m_temperature"].shape == (1, 1, 3, *RES)
    assert store["temperature"].shape == (1, 1, 3, 13, *RES)
    assert all(np.isfinite(a).all() for a in store.values())
    assert store["2m_temperature"][:, :, 1:].std() > 0
