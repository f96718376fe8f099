"""Tensor parallelism of the port on the CPU: gloo ranks against one process
and against the JAX package's TP on the host devices.

* The port's slices (``convert.params_to_state_dict`` of the JAX weights
  sliced by ``parallel.sharding.shard_state_dict`` along the ``Shard`` s a
  tensor-parallel network declares, ``module_shards``) equal the torch layout of the JAX
  package's ``shard_params`` device shards on a (1, 2) mesh, tensor by
  tensor, except ``w1``: the JAX rule splits its (in, 2·hidden) kernel
  contiguously (the whole gate on rank 0, the whole up projection on rank
  1) and the port holds ``[g_r ; u_r]``, rank r's slices of each, so that
  SwiGLU stays local. ``gather_state_dict``'s exact sum inverts the slicing.
* On two ranks (data 1 × model 2, ``tests/_torch_tp_worker.py``) the
  forward and its tangent under ``forward_ad`` equal the JAX model's
  replicated forward, ``jax.jvp`` and its TP forward on a (4, 2) mesh
  (``tests/test_tensor_parallel.py``'s ``make`` and ``make_tp``) in fp32 to
  1e-5 of max|y|, on the per-head route and on the whole-grid route.
* One sCM step with AdamW under data 1 × model 2 against the JAX package's
  ``test_tp_train_step_matches_replicated`` setup, its draws the port's:
  loss rtol 1e-5, parameters 2e-4 (its limits).
* The step on 2 ranks and on 4 (data 2 × model 2) against one process:
  loss and gradient norm rtol 1e-5, gradients 1e-5 of max|g|, the
  per-head logit scales' gradients (summed over the model group) among
  them, parameters and EMA 1e-6 beyond what each element's gradient
  difference moves AdamW's first update; each rank's gradients of the
  replicated parameters bit for bit alike across its model group.
* Muon's Newton-Schulz split over the ranks equals one unsplit optimizer
  bit for bit, on slices (TP) and on whole matrices, fp32 and bf16
  momentum; MARS of each kind on slices equals one process bit for bit.
* ``train ... system=tpu-tp`` on two ranks writes a checkpoint in one
  process's layout, resumes from it on two ranks and on one, and
  ``generate`` forecasts it on one process; without ``--device cpu`` and
  without CUDA it fails.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import swift_tpu.training.loss as jloss
from swift_torch import generate, train
from swift_torch.models import convert
from swift_torch.parallel import mesh
from swift_torch.parallel.sharding import Shard, module_shards, shard_state_dict
from swift_torch.utils.checkpoint import latest_checkpoint
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.models.precond import PassPrecond as JaxPassPrecond
from swift_tpu.models.swinv2 import SwinV2 as JaxSwinV2
from swift_tpu.parallel.sharding import shard_params
from swift_tpu.training.trainer import Trainer as JaxTrainer
from tests import _torch_tp_worker as worker
from tests.test_tensor_parallel import C, H, W, make, make_tp
from tests.test_torch_parallel import E2E_VARS, _close, _two_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIABLES = ["2m_temperature", "geopotential_500", "temperature_850", "specific_humidity_700"]
GB, LR, EPS = 4, 1e-3, 1e-8  # optax.adamw's lr of the JAX step, its eps
JAX_MAIN = dict(window_size=(2, 2), shift_size=(1, 1), patch_size=(2, 2), depth=2, dim=64,
                heads=4, logvar=True)
# 256-token windows and d 8: the whole-grid attention route (kernels 2, 6, 7 on the card)
BLOCK_RES = (32, 64)
JAX_BLOCK = dict(window_size=(16, 16), shift_size=(8, 8), patch_size=(2, 2), depth=2, dim=32,
                 heads=4, logvar=True)


def _jax_block():
    model = JaxSwinV2(img_resolution=BLOCK_RES, in_channels=2 * C, out_channels=C,
                      dtype=jnp.float32, use_pallas=False, **JAX_BLOCK)
    return JaxPassPrecond(model=model, img_resolution=BLOCK_RES, img_channels=C,
                          condition_channels=C, sigma_data=1.0)


def _noisy(params, seed):
    """Non-trivial weights (the zero-initialised head would hide errors)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape).astype(np.float32), params)


def _inputs(rng, B, res):
    return {"x": rng.standard_normal((B, *res, C)).astype(np.float32),
            "cond": rng.standard_normal((B, *res, C)).astype(np.float32),
            "t": rng.uniform(0.2, 1.2, (B,)).astype(np.float32),
            "dx": rng.standard_normal((B, *res, C)).astype(np.float32),
            "dt": rng.uniform(0.1, 0.5, (B,)).astype(np.float32)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX pairs' weights, the inputs and the draws; the spec the
    workers read."""
    work = tmp_path_factory.mktemp("tp")
    jmain, jblock = make(), _jax_block()
    params = {"main": _noisy(jmain.init(jax.random.PRNGKey(0)), 0),
              "block": _noisy(jblock.init(jax.random.PRNGKey(1)), 1)}
    for geom, p in params.items():
        np.savez(work / f"init-{geom}.npz", **convert.params_to_state_dict(p))
    rng = np.random.default_rng(5)
    batch = {}
    for geom, B, res in (("main", GB, (H, W)), ("block", 2, BLOCK_RES)):
        batch.update({f"{geom}_{k}": v for k, v in _inputs(rng, B, res).items()})
    batch.update(x=rng.standard_normal((GB, H, W, C)).astype(np.float32),
                 t=rng.standard_normal((GB, H, W, C)).astype(np.float32),
                 delta=np.full((GB, 1), 0.6, np.float32))
    port = worker.SCMLoss(H, VARIABLES, dict(worker.NOISE), sigma_data=1.0)
    draw_t, draw_z = port.draw(torch.from_numpy(batch["t"]), torch.Generator().manual_seed(3))
    batch.update(draw_t=draw_t.numpy(), draw_z=draw_z.numpy())
    np.savez(work / "batch.npz", **batch)
    geoms = {"main": {"res": [H, W], "model": JAX_MAIN},
             "block": {"res": list(BLOCK_RES), "model": JAX_BLOCK}}
    spec = {"C": C, "variables": VARIABLES, "geoms": geoms, "global_batch": GB, "lr": LR,
            "dir": str(work)}
    return {"work": work, "spec": spec, "params": params, "batch": batch,
            "jax": {"main": jmain, "block": jblock}}


def _launch(setup, n: int, model: int, forward: bool) -> list[dict]:
    work = setup["work"] / f"ranks{n}"
    work.mkdir()
    for f in ("init-main.npz", "init-block.npz", "batch.npz"):
        os.symlink(setup["work"] / f, work / f)
    spec = {**setup["spec"], "dir": str(work), "model_size": model, "forward": forward}
    (work / "spec.json").write_text(json.dumps(spec))
    cmd = [sys.executable, os.path.join(ROOT, "tests", "_torch_tp_worker.py"), str(work)]
    outs = _two_ranks(cmd, str(work), ranks=n)
    assert all(f"TP_WORKER_OK rank={r}" in out for r, out in enumerate(outs)), outs
    return [torch.load(work / f"rank{r}.pt") for r in range(n)]


@pytest.fixture(scope="module")
def two(setup):
    return _launch(setup, 2, 2, forward=True)


@pytest.fixture(scope="module")
def four(setup):
    return _launch(setup, 4, 2, forward=False)


@pytest.fixture(scope="module")
def one(setup):
    """One process's step on the global batch, the workers' builders."""
    spec, batch = setup["spec"], setup["batch"]
    init = dict(np.load(setup["work"] / "init-main.npz"))
    trainer = worker.build_trainer(spec, init, batch)
    loss = trainer.backward(worker.rows_of(batch, slice(None)))
    gnorm = trainer.update()
    return {"loss": float(loss), "grad_norm": float(gnorm),
            "grads": {n: p.grad.clone() for n, p in trainer.params.items()},
            "params": {n: p.detach().clone() for n, p in trainer.params.items()},
            "ema": {n: e.clone() for n, e in trainer.ema.items()}}


def _adamw_first_step_spread(g_got: torch.Tensor, g_want: torch.Tensor) -> torch.Tensor:
    """How far AdamW's first update, lr·g/(|g| + eps), can move between two
    gradients: lr·eps·|Δg| / (min|g| + eps)², min|g| = 0 where they differ
    in sign (``tests/test_torch_parallel.py``'s allowance at this step's lr
    and eps)."""
    gmin = torch.where(g_got * g_want > 0, torch.minimum(g_got.abs(), g_want.abs()),
                       torch.zeros_like(g_got))
    return LR * EPS * (g_got - g_want).abs() / (gmin + EPS) ** 2


def _mesh(shape):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), ("data", "model"))


# -- the layout -------------------------------------------------------------------


def test_port_shards_equal_jax_device_shards(setup):
    """For every parameter: rank r's slice equals the torch layout of the
    (0, r) device's shard of ``shard_params`` on a (1, 2) mesh; w1 is rank
    r's rows of gate and up, where JAX's device r holds all of one."""
    params = setup["params"]["main"]
    m = _mesh((1, 2))
    sharded = shard_params(jax.tree_util.tree_map(jnp.asarray, params), m)
    full = convert.params_to_state_dict(params)
    init = dict(np.load(setup["work"] / "init-main.npz"))
    hidden = full["model.transformer.layers.0.1.w2.weight"].shape[1]
    for r in range(2):
        dev = m.devices[0, r]
        local = jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == dev)),
            sharded)
        want = convert.params_to_state_dict(local)
        shards = module_shards(worker.build_net(setup["spec"], "main", init,
                                                mesh.Layout(1, 2, 0, r)))
        got = {n: v.numpy() for n, v in shard_state_dict(
            {n: torch.from_numpy(v) for n, v in full.items()}, shards).items()}
        assert sorted(got) == sorted(want)
        for n in want:
            if n.endswith(".w1.weight"):
                # JAX: device r holds the whole gate (r 0) or up (r 1)
                half = full[n][r * hidden:(r + 1) * hidden]
                assert np.array_equal(want[n], half), n
                h = hidden // 2
                want_n = np.concatenate([full[n][r * h:(r + 1) * h],
                                         full[n][hidden + r * h:hidden + (r + 1) * h]])
                assert np.array_equal(got[n], want_n), n
            else:
                assert got[n].shape == want[n].shape and np.array_equal(got[n], want[n]), n
        split = [n for n in got if got[n].shape != full[n].shape]
        assert len(split) == 4 * JAX_MAIN["depth"]


def test_gather_inverts_the_slices_exactly(setup):
    """The slices placed in -0.0 and summed (what ``gather_state_dict``'s
    all-reduce does over the model group) give one process's state dict bit
    for bit, -0.0 and all, along the shards a tensor-parallel network
    declares."""
    init = dict(np.load(setup["work"] / "init-main.npz"))
    sd = {k: torch.from_numpy(v) for k, v in init.items()}
    sd["model.transformer.layers.0.0.wo.weight"][0, :3] = -0.0
    specs = [module_shards(worker.build_net(setup["spec"], "main", init, mesh.Layout(1, 2, 0, r)))
             for r in (0, 1)]
    parts = [shard_state_dict(sd, specs[r]) for r in (0, 1)]
    for n, v in sd.items():
        if n in specs[0]:
            whole = specs[0][n].place(parts[0][n]) + specs[1][n].place(parts[1][n])
            assert torch.equal(whole, v) and torch.equal(whole.signbit(), v.signbit()), n
        else:
            assert all(torch.equal(p[n], v) for p in parts), n
    assert {n for n in specs[1]} == {
        f"model.transformer.layers.{i}.{j}" for i in range(2)
        for j in ("0.to_qkv.weight", "0.wo.weight", "1.w1.weight", "1.w2.weight")}
    assert specs[1]["model.transformer.layers.1.1.w1.weight"] == Shard(
        (2 * 170, 64), 0, 1, 2, halves=True)


@pytest.mark.parametrize("cfg,world,want", [
    ({"axes": ["data", "model"], "sizes": [-1, 2]}, 4, (2, 2, 1)),
    ({"axes": ["data", "model"], "sizes": [-1, 2]}, 2, (1, 2, 1)),
    ({"axes": ["data"], "sizes": [-1]}, 3, (3, 1, 1)),
    ({"axes": ["data", "model"], "sizes": [-1, 2]}, 3, ValueError),
    # a model axis beside a pipe axis is not ported (a pipe axis alone:
    # tests/test_torch_pipeline.py)
    ({"axes": ["data", "model", "pipe"], "sizes": [-1, 2, 2]}, 2, NotImplementedError),
])
def test_mesh_sizes(cfg, world, want):
    cfg = {"system": {"mesh": cfg}}
    if isinstance(want, tuple):
        assert mesh.mesh_sizes(cfg, world) == want
    else:
        with pytest.raises(want):
            mesh.mesh_sizes(cfg, world)


def test_layout_puts_model_fastest(four):
    """Rank = data index × 2 + model index, as the JAX package's
    ``make_mesh`` lays (data, model) out."""
    assert [res["layout"] for res in four] == [[2, 2, r // 2, r % 2] for r in range(4)]


# -- the forward and its tangent ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_forward(setup):
    """The JAX model's replicated forward and jvp of both geometries, and
    the TP forward of the main one on a (4, 2) mesh."""
    out = {}
    b = setup["batch"]
    for geom, p in setup["jax"].items():
        params = setup["params"][geom]
        x, cond, t, dx, dt = (jnp.asarray(b[f"{geom}_{k}"]) for k in ("x", "cond", "t", "dx", "dt"))
        fn = lambda xx, tt, p=p, params=params, cond=cond: p.apply(params, xx, tt, condition=cond)  # noqa: E731
        y, tan = jax.jvp(fn, (x, t), (dx, dt))
        out[geom] = {"replicated": np.asarray(fn(x, t)), "jvp": np.asarray(y),
                     "tangent": np.asarray(tan)}
    m = _mesh((4, 2))
    params = setup["params"]["main"]
    x, cond, t = (jnp.asarray(b[f"main_{k}"]) for k in ("x", "cond", "t"))
    p_tp = make_tp(m)
    y_tp = jax.jit(lambda pp, xx: p_tp.apply(pp, xx, t, condition=cond))(
        shard_params(jax.tree_util.tree_map(jnp.asarray, params), m),
        jax.device_put(x, NamedSharding(m, P("data"))))
    out["main"]["tp"] = np.asarray(y_tp)
    return out


def _near(got, want, rtol=1e-5):
    got = got.numpy() if hasattr(got, "numpy") else got
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("geom,ref", [("main", "replicated"), ("main", "tp"),
                                      ("block", "replicated")])
def test_tp_forward_matches_jax(two, jax_forward, geom, ref):
    for res in two:
        _near(res["forward"][geom]["y"], jax_forward[geom][ref])
    assert torch.equal(two[0]["forward"][geom]["y"], two[1]["forward"][geom]["y"])


@pytest.mark.parametrize("geom", ["main", "block"])
def test_tp_jvp_matches_jax(two, jax_forward, geom):
    for res in two:
        _near(res["forward"][geom]["jvp_y"], jax_forward[geom]["jvp"])
        _near(res["forward"][geom]["tangent"], jax_forward[geom]["tangent"])


# -- the training step -----------------------------------------------------------------


def test_tp_scm_step_matches_jax(setup, two, monkeypatch):
    """``test_tp_train_step_matches_replicated``'s step (sCM, optax.adamw(1e-3),
    nimg 0) on the JAX model's TP and replicated forms, the port's draws
    handed to both: the two-rank port within its limits of each."""
    b = setup["batch"]
    draws = (jnp.asarray(b["draw_t"]), jnp.asarray(b["draw_z"]))
    monkeypatch.setattr(jloss.SCMLoss, "_draw", lambda self, key, xx: draws)
    m = _mesh((4, 2))
    batch = {"x": b["x"], "t": b["t"], "idx": np.arange(GB, dtype=np.int32), "delta": b["delta"]}

    def run(p, sharded):
        loss = jloss.SCMLoss(precond=p, lat_dim=H, variables=tuple(VARIABLES),
                             noise=dict(worker.NOISE), tangent_warmup_kimg=1)
        tr = JaxTrainer(p, optax.adamw(LR), loss, global_batch_size=GB, total_kimg=1,
                        run_dir=str(setup["work"] / "jax"), checkpoint_ticks=None,
                        val_ticks=None, seed=0)
        state = tr.state
        state = type(state)(setup["params"]["main"], setup["params"]["main"],
                            optax.adamw(LR).init(setup["params"]["main"]), state.nimg)
        bt = batch
        if sharded:
            state = type(state)(shard_params(state.params, m), shard_params(state.ema, m),
                                jax.device_put(state.opt_state, NamedSharding(m, P())),
                                state.nimg)
            bt = {k: jax.device_put(v, NamedSharding(m, P("data", *([None] * (v.ndim - 1)))))
                  for k, v in batch.items()}
        new_state, metrics = tr._get_step(1, None)(state, bt, jax.random.PRNGKey(3))
        return convert.params_to_state_dict(jax.device_get(new_state.params)), float(
            metrics["loss"])

    r0 = two[0]["step"]
    for p, sharded in ((make(), False), (make_tp(m), True)):
        want, loss = run(p, sharded)
        np.testing.assert_allclose(r0["mean_loss"], loss, rtol=1e-5)
        for n, v in want.items():
            np.testing.assert_allclose(r0["params"][n].numpy(), v, rtol=2e-4, atol=2e-4,
                                       err_msg=n)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_step_equals_one_process(two, four, one, n):
    ranks = two if n == 2 else four
    r0 = ranks[0]["step"]
    np.testing.assert_allclose(r0["mean_loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"], rtol=1e-5)
    _close(r0["grads"], one["grads"], 1e-5)
    for key in ("params", "ema"):
        for name, want in one[key].items():
            tol = 1e-6 + _adamw_first_step_spread(r0["grads"][name], one["grads"][name])
            assert torch.all((r0[key][name] - want).abs() <= tol), (key, name)
    for res in ranks[1:]:  # every rank ends with one replica's state, gathered
        for key in ("params", "ema"):
            for name, v in r0[key].items():
                assert torch.equal(res["step"][key][name], v), (key, name)
        assert res["step"]["mean_loss"] == r0["mean_loss"]
        assert res["step"]["grad_norm"] == r0["grad_norm"]


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_grads_alike_on_model_ranks(two, four, n):
    """A replicated parameter on replicated work gets the same gradient on
    every model rank of a data row before any reduction (so none is
    summed); the per-head scales alone are used on a slice."""
    ranks = two if n == 2 else four
    for a, b in zip(ranks[0::2], ranks[1::2]):
        own_a, own_b = a["step"]["own_replicated_grads"], b["step"]["own_replicated_grads"]
        assert sorted(own_a) == sorted(own_b)
        for name, g in own_a.items():
            if name in a["step"]["sliced"]:
                assert not torch.equal(g, own_b[name]), name
            else:
                assert torch.equal(g, own_b[name]), name
    assert ranks[0]["step"]["sliced"] == [f"model.transformer.layers.{i}.0.scale"
                                          for i in range(2)]


@pytest.mark.parametrize("n", [2, 4])
def test_global_norm_and_scale_grads(two, four, one, n):
    """The gradient norm (slices' squares summed over the model group, the
    replicated ones once) to rtol 1e-6 and the per-head scales' gradients
    (summed over it; sums over every token in another order) to 1e-5 of
    their max, against one process's."""
    r0 = (two if n == 2 else four)[0]["step"]
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"], rtol=1e-6)
    for name in r0["sliced"]:
        want = one["grads"][name]
        torch.testing.assert_close(r0["grads"][name], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", ["float32-slices", "float32-whole", "bfloat16-slices",
                                  "bfloat16-whole"])
@pytest.mark.parametrize("n", [2, 4])
def test_muon_split_equals_one_process_bit_for_bit(two, four, n, case):
    for res in (two if n == 2 else four):
        got = res["muon"][case]
        assert got["equal"] and got["max_diff"] == 0.0, got
        assert got["split"] == (8 if case.endswith("slices") else 0)


@pytest.mark.parametrize("kind", ["mars-adamw", "mars-lion", "mars-shampoo"])
@pytest.mark.parametrize("n", [2, 4])
def test_mars_on_slices_equals_one_process_bit_for_bit(two, four, n, kind):
    """MARS on a tensor-parallel rank's slices: the clip's norm over the
    whole corrected gradient and mars-shampoo's Newton-Schulz over the
    whole momentum (both gathered over the model group), so two steps equal
    one process's on the same gradients, bit for bit."""
    for res in (two if n == 2 else four):
        got = res["mars"][kind]
        assert got["equal"] and got["max_diff"] == 0.0, got
        assert got["split"] == 8


# -- the entry points ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """``train experiment=synthetic-tiny-scm system=tpu-tp`` on two ranks (3
    steps), then resumed from its checkpoint on two ranks."""
    work = tmp_path_factory.mktemp("tp_run")
    data = make_synthetic_era5(str(work / "data"), E2E_VARS, ["land_sea_mask"], n_train=12,
                               n_val=2, n_test=8)
    args = [sys.executable, "-m", "swift_torch.train", "experiment=synthetic-tiny-scm",
            "system=tpu-tp", "trainer.kimg_per_tick=0.004", "--device", "cpu"]
    first = _two_ranks(args + ["trainer.total_kimg=0.012"], cwd=str(work),
                       SWIFT_SYNTH_ROOT=data, RUN_ID="tp")
    resumed = _two_ranks(args + ["trainer.total_kimg=0.020", "resume=tp"], cwd=str(work),
                         SWIFT_SYNTH_ROOT=data, RUN_ID="tp-resumed")
    return work, data, first, resumed


def test_tp_train_writes_one_process_checkpoint_and_resumes(tp_run, monkeypatch):
    work, data, first, resumed = tp_run
    run = work / "results" / "synthetic-tiny-scm" / "tp"
    ckpt = latest_checkpoint(str(run / "checkpoints"))
    assert "Tensor parallel over 2 ranks a replica (1 replicas): 4 weights split" in first[0]
    assert "Saving checkpoint" not in first[1]
    with np.load(ckpt) as f:
        saved = {k: f[k].shape for k in f.files}
    # one process's layout: a one-process net of the run's config takes it
    monkeypatch.chdir(work)
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    monkeypatch.setenv("RUN_ID", "tp-one")
    trainer, loader, _ = train.setup(["experiment=synthetic-tiny-scm", "resume=tp",
                                      "system=tpu", "trainer.total_kimg=0.016", "--device",
                                      "cpu"])
    assert not trainer.shards and trainer.updates == 0
    qkv = "model.transformer.layers.0.0.to_qkv.weight"
    assert trainer.params[qkv].shape == (96, 32)
    assert saved["params/pairs/even/attn/to_qkv/kernel"] == (1, 32, 96)
    assert saved[f"opt_state/{qkv}/exp_avg"] == (96, 32)
    it = iter(loader)
    out = trainer.step(next(it))
    it.close()
    assert np.isfinite(float(out["loss"]))
    losses = [float(x) for x in re.findall(r" loss=(\S+)", resumed[0])]
    # the checkpoint is at kimg 0 (0.012 kimg of training): 0.020 kimg is five steps more
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert "Resuming from" in resumed[0]


def test_generate_forecasts_a_tp_run_on_one_process(tp_run, monkeypatch):
    work, data, _, _ = tp_run
    run = work / "results" / "synthetic-tiny-scm" / "tp"
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    store = generate.cli(["--input", str(run), "--members", "2", "--steps", "2", "--batch", "2",
                          "--samples", "2", "--segment", "1", "--solver", "scm",
                          "--num-solver-steps", "1", "--device", "cpu", "--output",
                          str(work / "store")])
    got = generate.read_store(store)
    assert got and all(np.isfinite(v).all() for v in got.values())


def test_tp_run_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.setup(["experiment=synthetic-tiny-scm", "system=tpu-tp"])


def test_tensor_parallel_modules_import_no_jax():
    code = """
import sys
from swift_torch.parallel import sharding, tensor
from swift_torch import factory
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "swift_tpu"))
assert not bad, bad
print("no-jax-ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "no-jax-ok" in res.stdout, res.stderr[-2000:]

