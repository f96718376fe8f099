"""Data parallelism of the port on the CPU: two gloo processes against one.

* One optimizer step of the port's ``Trainer`` under two ranks, each on its
  rows of a global batch of 4 (``tests/_torch_dp_worker.py``), against the
  one-process step on the global batch: sCM with AdamW and with Muon,
  TrigFlow, sCM with ``grad_accum=2`` (one process on the ranks'
  microbatches side by side) and the CRPS fine-tune loss over two unrolled
  steps (its all-but-last step under ``torch.utils.checkpoint``). The loss
  averaged over the ranks and the gradients to rtol 1e-5 of max|g|, the
  parameters after one AdamW step to 1e-6 and after one Muon step to
  3·lr·2^-8; both ranks' parameters and EMA bit for bit alike.
* The two-rank sCM step against the JAX package's single-process step on
  the same global batch with the port's draws (``SCMLoss._draw`` handed
  them), to the tolerances of ``tests/test_torch_train.py``: loss rtol 1e-5,
  gradients rtol 1e-4 of max|g|, parameters and EMA 1e-6 beyond what each
  element's gradient difference moves AdamW's first update, lr·g/(|g| +
  eps) (near |g| ≈ eps a rounding-sized difference moves it by lr·Δg/eps;
  the same allowance holds the ``grad_accum=2`` case, whose per-sample
  gradients sum in another grouping than one process's).
* The losses' draws: one process draws what it drew before, and the ranks'
  rows of a sharded draw are the one-process draw's, bit for bit.
* The collectives (bucketed, over fp32, bf16 and int64) and the replica
  check, which names a tensor that differs.
* A stop signal that reaches one rank stops both after the same step, and
  rank 0 writes the checkpoint.
* One rank's forecast engine hands the sampler the draws it would make
  itself, bit for bit.
* ``python -m swift_torch.train experiment=synthetic-tiny-scm`` under two
  ranks: one ``stats.jsonl`` line a tick and the checkpoint, from rank 0
  only; ``generate`` from it under two ranks with 3 members (one rank rolls
  out a pad member) and 2, into zarr and numpy stores equal to the
  one-rank store to rtol 1e-5; the offline ``validate`` under two ranks
  (both log one mean).
* ``train`` and ``generate`` accept a ``model`` mesh axis (``system=tpu-tp``:
  ``train`` sets up on two ranks, ``generate`` forecasts the run on one)
  and a ``pipe`` axis (``system=tpu-pp``: ``train`` sets up on two ranks;
  ``generate`` refuses the run's two stages on one process unless ``--pp
  1`` turns them off); the new modules load no JAX.

Each launch of two processes has its own timeout.
"""

import functools
import glob
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import swift_tpu.factory as jfactory
import swift_tpu.ops.pallas_block_attention as pba
import swift_tpu.ops.pallas_ffn as pffn
import swift_tpu.ops.pallas_linear as plin
import swift_tpu.ops.pallas_modnorm as pmn
import swift_tpu.training.loss as jloss
import swift_tpu.training.trainer as jtrainer
from swift_torch import generate, train
from swift_torch.models import convert
from swift_torch.parallel import mesh
from swift_torch.sampling.ensemble import member_block
from swift_torch.training import loss as tloss
from swift_torch.utils import stats
from swift_tpu.data.synthetic import make_synthetic_era5
from tests import _torch_dp_worker as worker
from tests.test_torch_train import COMMON, GEOMS, NOISE, RES, VARS, _batch, _grads_by_name, _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEED = 4, 21
CASES = {
    "scm-adamw": {"loss": "scm", "opt": "adamw"},
    "scm-muon": {"loss": "scm", "opt": "muon"},
    "trigflow-adamw": {"loss": "trigflow", "opt": "adamw"},
    "scm-accum2": {"loss": "scm", "opt": "adamw", "accum": 2},
    "crps-unroll2": {"loss": "crps", "opt": "adamw", "steps": 2},
}
E2E_VARS = ["2m_temperature", "sea_surface_temperature", "geopotential_500", "temperature_850"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(cmd, cwd, timeout=120, ranks=2, **env) -> list[str]:
    """Run ``cmd`` as ranks 0 and 1 (of ``ranks``) of a gloo group (the JAX
    package's env contract); returns their outputs, failing unless all exit
    0."""
    base = dict(os.environ, SWIFT_COORDINATOR=f"localhost:{_free_port()}",
                SWIFT_NUM_PROCESSES=str(ranks), OMP_NUM_THREADS=str(4 // ranks or 1),
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), **env)
    base.pop("SWIFT_NO_DIST_INIT", None)
    procs = [subprocess.Popen(cmd, cwd=cwd, env=dict(base, SWIFT_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture
def interpret_mode(monkeypatch):
    """The Pallas interpreter off-TPU (as tests/test_torch_jvp.py forces it)."""
    if jax.default_backend() != "tpu":
        orig = pl.pallas_call
        for mod in (pba, pffn, plin, pmn):
            monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(orig, interpret=True))


def _global_batches():
    """The single-step and the multistep global batches (one Δ, 2 steps of
    forcings)."""
    x, cond, _, aux = _batch(SEED, B=GB)
    single = {"x": cond, "t": x, "delta": aux}
    rng = np.random.default_rng(SEED + 1)
    multistep = {"x": cond, "t": x, "delta": np.full((GB, 1), 0.6, np.float32),
                 "forcings_seq": rng.standard_normal((GB, 2, *RES, 1)).astype(np.float32)}
    return single, multistep


def _one_process_order(case) -> np.ndarray:
    """The global rows in the order one process takes them to match two
    ranks: with ``accum`` microbatches, each global microbatch is the
    ranks' microbatches side by side."""
    accum, local = case.get("accum", 1), GB // 2
    mb = local // accum
    return np.array([r * local + m * mb + i for m in range(accum) for r in (0, 1)
                     for i in range(mb)])


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """(spec, the JAX pair, global batches, each case's rank results and
    one-process result, the collectives' results)."""
    work = tmp_path_factory.mktemp("dp")
    jpre, params, _ = _pair("d16", seed=SEED)
    spec = {"res": list(RES), "variables": VARS, "forcings": 1, "noise": NOISE,
            "model": {**COMMON, **GEOMS["d16"]}, "global_batch": GB, "seed": SEED,
            "dir": str(work), "cases": CASES}
    (work / "spec.json").write_text(json.dumps(spec))
    init = convert.params_to_state_dict(params)
    np.savez(work / "init.npz", **init)
    single, multistep = _global_batches()
    np.savez(work / "batch-single.npz", **single)
    np.savez(work / "batch-multistep.npz", **multistep)

    outs = _two_ranks([sys.executable, os.path.join(ROOT, "tests", "_torch_dp_worker.py"),
                       str(work)], cwd=str(work))
    assert all(f"DP_WORKER_OK rank={r}" in out for r, out in enumerate(outs)), outs
    ranks = {name: [torch.load(work / f"{name}.rank{r}.pt") for r in (0, 1)] for name in CASES}
    one = {}
    for name, case in CASES.items():
        batch = multistep if case["loss"] == "crps" else single
        trainer = worker.build_trainer(case, spec, init)
        one[name] = worker.step(trainer, worker.rows_of(batch, _one_process_order(case)), case)
    coll = [torch.load(work / f"collectives.rank{r}.pt") for r in (0, 1)]
    stop = [json.loads((work / f"stop.rank{r}.json").read_text()) for r in (0, 1)]
    return {"spec": spec, "jax": (jpre, params), "batch": single, "ranks": ranks, "one": one,
            "collectives": coll, "stop": stop}


def _close(got: dict, want: dict, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for n in want:
        scale = max(float(want[n].abs().max()), 1e-30)
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=rtol * scale, msg=n)


def _adamw_first_step_spread(g_got: torch.Tensor, g_want: torch.Tensor) -> torch.Tensor:
    """How far AdamW's first update, lr·g/(|g| + eps), can move between two
    gradients: lr·eps·|Δg| / (min|g| + eps)², min|g| = 0 where they differ
    in sign. Where |g| nears eps a rounding-sized Δg moves it by ≈ lr·Δg/eps."""
    cfg = worker.OPTIMIZERS["adamw"]
    gmin = torch.where(g_got * g_want > 0, torch.minimum(g_got.abs(), g_want.abs()),
                       torch.zeros_like(g_got))
    return cfg["lr"] * cfg["eps"] * (g_got - g_want).abs() / (gmin + cfg["eps"]) ** 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_step_equals_one_process(dp, name):
    """With ``grad_accum`` 2 the per-sample gradients sum in another
    grouping than one process's, so the gradients agree to fp32 rounding
    (rtol 1e-5 of max|g|) and AdamW's first update, lr·g/(|g| + eps),
    passes on each element's rounding difference
    (:func:`_adamw_first_step_spread`) on top of 1e-6."""
    case, (r0, _), one = CASES[name], dp["ranks"][name], dp["one"][name]
    np.testing.assert_allclose(r0["mean_loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"], rtol=1e-5)
    _close(r0["grads"], one["grads"], 1e-5)
    lr = worker.OPTIMIZERS[case["opt"]]["lr"]
    for key in ("params", "ema"):
        for n, want in one[key].items():
            tol = 3 * lr * 2 ** -8 if case["opt"] == "muon" else 1e-6
            if "accum" in case:
                tol = tol + _adamw_first_step_spread(r0["grads"][n], one["grads"][n])
            assert torch.all((r0[key][n] - want).abs() <= tol), (key, n)
    assert r0["params"].keys() == one["params"].keys()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_hold_one_replica(dp, name):
    """The gradients, parameters and EMA after the step are bit for bit
    alike on both ranks; each rank's own loss is its rows' (they differ)."""
    r0, r1 = dp["ranks"][name]
    for key in ("grads", "params", "ema"):
        for n in r0[key]:
            assert torch.equal(r0[key][n], r1[key][n]), (key, n)
    assert r0["mean_loss"] == r1["mean_loss"] and r0["grad_norm"] == r1["grad_norm"]
    assert r0["loss"] != r1["loss"]
    np.testing.assert_allclose((r0["loss"] + r1["loss"]) / 2, r0["mean_loss"], rtol=1e-6)


def test_two_ranks_scm_step_matches_jax(dp, interpret_mode, monkeypatch):
    """The global batch and the port's draws through the JAX package's
    single-process step: value_and_grad, clamp, AdamW by optax, EMA. The
    parameters and EMA to 1e-6 on top of what each element's gradient
    difference moves AdamW's first update (:func:`_adamw_first_step_spread`;
    ``tests/test_torch_train.py`` hands the port JAX's gradients instead)."""
    jpre, params = dp["jax"]
    b = dp["batch"]
    x, cond, aux = jnp.asarray(b["t"]), jnp.asarray(b["x"]), jnp.asarray(b["delta"])
    port = tloss.SCMLoss(RES[0], VARS, dict(NOISE), sigma_data=1.0, tangent_warmup_kimg=1)
    t, z = port.draw(torch.from_numpy(b["t"]), torch.Generator().manual_seed(SEED))
    monkeypatch.setattr(jloss.SCMLoss, "_draw",
                        lambda self, key, xx: (jnp.asarray(t.numpy()), jnp.asarray(z.numpy())))
    jl = jloss.SCMLoss(precond=jpre, lat_dim=RES[0], variables=tuple(VARS), noise=dict(NOISE),
                       sigma_data=1.0, tangent_warmup_kimg=1)
    jval, jg = jax.value_and_grad(lambda p: jl(p, jax.random.PRNGKey(0), x,
                                               jnp.float32(worker.NIMG), condition=cond,
                                               auxiliary=aux))(params)
    jg = jtrainer.clamp_grads(jg)
    jopt, _ = jfactory.build_optimizer(worker.OPTIMIZERS["adamw"], worker.TRAINER_CFG, GB,
                                       params)
    updates, _ = jopt.update(jg, jopt.init(params), params)
    jparams = optax.apply_updates(params, updates)
    jema = jtrainer.ema_update(params, jparams, worker.NIMG, float(GB), 500, 0.05)

    r0 = dp["ranks"]["scm-adamw"][0]
    np.testing.assert_allclose(r0["mean_loss"], float(jval), rtol=1e-5)
    want_g = {n: torch.from_numpy(np.array(g)) for n, g in _grads_by_name(jg).items()}
    _close(r0["grads"], want_g, 1e-4)
    for key, tree in (("params", jparams), ("ema", jema)):
        want = convert.params_to_state_dict(jax.device_get(tree))
        for n, p in r0[key].items():
            tol = 1e-6 + _adamw_first_step_spread(r0["grads"][n], want_g[n])
            assert torch.all((p - torch.from_numpy(want[n])).abs() <= tol), (key, n)


def test_one_process_draws_what_it_drew_before():
    """The sCM draw of one process: τ by ``torch.rand``, then z by
    ``torch.randn``, from the trainer's generator, as before sharding."""
    x = torch.zeros(4, *RES, len(VARS))
    gen = torch.Generator().manual_seed(3)
    u = torch.rand(4, 1, 1, 1, generator=gen)
    z = torch.randn(x.shape, generator=gen)
    lo, hi = np.log(NOISE["sigma_min"]), np.log(NOISE["sigma_max"])
    t = torch.atan(torch.exp(lo + u * (hi - lo)))
    got = tloss.SCMLoss(RES[0], VARS, dict(NOISE)).draw(x, torch.Generator().manual_seed(3))
    assert torch.equal(got[0], t) and torch.equal(got[1], z)


@pytest.mark.parametrize("loss", ["scm", "edm", "mse"])
def test_ranks_rows_of_a_sharded_draw_are_the_one_process_draw(loss):
    x = torch.zeros(4, *RES, len(VARS))
    fn = {"scm": tloss.SCMLoss(RES[0], VARS, dict(NOISE)).draw,
          "edm": tloss.EDMLoss(RES[0], VARS, dict(NOISE)).draw,
          "mse": lambda xx, gen, shard: (tloss._rows(torch.randn, xx.shape, gen, None, shard),)}
    want = fn[loss](x, torch.Generator().manual_seed(3), (0, 1))
    halves = [fn[loss](x[:2], torch.Generator().manual_seed(3), (r, 2)) for r in (0, 1)]
    for i, w in enumerate(want):
        assert torch.equal(torch.cat([halves[0][i], halves[1][i]]), w)


def test_collectives_and_replica_check(dp):
    r0, r1 = dp["collectives"]
    f32 = (r0["inputs"][0] + r1["inputs"][0]) / 2
    b16 = ((r0["inputs"][1].float() + r1["inputs"][1].float()) / 2).to(torch.bfloat16)
    for out in (r0, r1):
        assert torch.equal(out["reduced"][0], f32)
        assert out["reduced"][1].dtype == torch.bfloat16 and torch.equal(out["reduced"][1], b16)
        for got, want in zip(out["broadcast"], r0["inputs"]):
            assert got.dtype == want.dtype and torch.equal(got, want)
        assert out["agree"] is True
        assert re.search(r"replica mismatch in inputs: 3 of 3 tensors differ", out["differ"])


def test_stop_signal_on_one_rank_stops_both_after_one_step(dp):
    """Rank 1 alone is signalled before its third step: its request rides
    that step's gradient all-reduce, so both ranks end the tick after step 3
    (the first tick ended at step 1), and rank 0 writes the one checkpoint."""
    r0, r1 = dp["stop"]
    assert r0["updates"] == r1["updates"] == 3
    assert r0["iters"] == r1["iters"] == [1, 3]
    assert r0["checkpoints"] == r1["checkpoints"] == ["checkpoint-000000.npz"]


class _ToyNet:
    """An analytic net(x, t, condition, auxiliary) with the metadata the
    solvers read."""

    sigma_data, sigma_min, sigma_max = 1.0, 0.0, float("inf")
    img_channels, img_resolution = 2, (8, 16)

    def __call__(self, x, t, condition=None, auxiliary=None):
        t = torch.as_tensor(t).abs()
        return (torch.tanh(0.7 * x) / (1.0 + t) + 0.2 * torch.cos(condition[..., :2])
                + 0.05 * auxiliary)


@pytest.mark.parametrize("mode,kw", [
    ("scm", {"num_steps": 3}),
    ("edm", {"num_steps": 4, "S_churn": 2.5, "S_min": 0.0, "S_max": 80.0}),
    ("dpm", {"num_steps": 3}),
])
def test_one_rank_engine_hands_the_sampler_its_own_draws(mode, kw):
    """On one rank the engine's draws for the whole batch (latents, then
    each re-noise in the solver's order), handed over as ``latents=`` and
    ``noise=``, are what the sampler draws from the same generator itself:
    the stores are equal bit for bit."""
    from swift_torch.data.synthetic import SyntheticERA5
    from swift_torch.sampling.ensemble import EnsembleRollout
    from swift_torch.sampling.factory import sampler_factory

    ds = SyntheticERA5(["2m_temperature", "geopotential_500"], ["land_sea_mask"], n_files=4)
    sampler = sampler_factory(mode, _ToyNet(), sigma_min=0.02, sigma_max=200.0, **kw)
    rng = np.random.default_rng(7)
    X0 = rng.standard_normal((2, 8, 16, 2)).astype(np.float32)
    forc = rng.standard_normal((2, 3, 8, 16, 1)).astype(np.float32)
    stores = []
    # the reference ignores the engine's draws and lets the sampler draw its
    # own from the step's generator rewound to its seed
    own = lambda X, gen, auxiliary=None, **draws: sampler(  # noqa: E731
        X, gen.manual_seed(gen.initial_seed()), auxiliary)
    for fn in (sampler, own):
        out = {}
        EnsembleRollout(fn, ds, 3, 3, segment=2, base_seed=5, device="cpu").run(
            X0, forc, 0, lambda ic, m, lead, chunk: out.setdefault((m, lead), chunk.copy()))
        stores.append(out)
    assert sorted(stores[0]) == sorted(stores[1]) and len(stores[0]) == 9
    for k, want in stores[1].items():
        assert np.array_equal(stores[0][k], want), k


def test_one_process_runtime_is_a_no_op(monkeypatch):
    for var in ("SWIFT_COORDINATOR", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not mesh.maybe_initialize_distributed("cpu")
    assert (mesh.rank(), mesh.world_size(), mesh.local_rank(), mesh.local_world_size()) == (
        0, 1, 0, 1)
    assert mesh.rank_rows(3) == slice(0, 3)
    t = torch.arange(4.0)
    mesh.all_reduce_mean([t])
    mesh.broadcast_from_rank0([t])
    mesh.barrier()
    assert torch.equal(t, torch.arange(4.0))
    assert stats.check_replica_consistency([t])
    table = np.array([[1.0, 3.0]])
    assert stats.sum_over_ranks(table) is table
    monkeypatch.setenv("SWIFT_NO_DIST_INIT", "1")
    monkeypatch.setenv("SWIFT_COORDINATOR", "localhost:1")
    monkeypatch.setenv("SWIFT_NUM_PROCESSES", "2")
    assert not mesh.maybe_initialize_distributed("cpu")


def test_launchers_name_the_local_rank(monkeypatch):
    for var in ("SWIFT_NO_DIST_INIT", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "SWIFT_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "3")
    assert (mesh.local_rank(), mesh.local_world_size()) == (3, 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert (mesh.local_rank(), mesh.local_world_size()) == (1, 2)
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var)
    monkeypatch.setenv("SWIFT_COORDINATOR", "localhost:1")
    monkeypatch.setenv("SWIFT_NUM_PROCESSES", "3")
    monkeypatch.setenv("SWIFT_PROCESS_ID", "2")
    assert (mesh.local_rank(), mesh.local_world_size()) == (2, 3)


@pytest.mark.parametrize("members,world", [(1, 2), (2, 2), (3, 2), (5, 4), (12, 8)])
def test_member_blocks_cover_each_member_once(members, world):
    """Every member is written by exactly one rank (a zarr chunk holds one
    member, so no chunk has two writers); blocks are contiguous and equal."""
    blocks = [member_block(members, r, world) for r in range(world)]
    assert len({len(b) for b in blocks}) == 1
    real = np.concatenate([b[b < members] for b in blocks])
    assert np.array_equal(real, np.arange(members))
    pad = np.concatenate(blocks)[members:]
    assert np.array_equal(pad % members, np.arange(len(pad)) % members)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """A two-rank ``train`` run of synthetic-tiny-scm (3 steps, a tick
    each): (work dir, data root, run dir, the ranks' logs)."""
    work = tmp_path_factory.mktemp("dp_run")
    data = make_synthetic_era5(str(work / "data"), E2E_VARS, ["land_sea_mask"], n_train=12,
                               n_val=2, n_test=8)
    outs = _two_ranks([sys.executable, "-m", "swift_torch.train", "experiment=synthetic-tiny-scm",
                       "trainer.total_kimg=0.012", "trainer.kimg_per_tick=0.004",
                       "--device", "cpu"], cwd=str(work), SWIFT_SYNTH_ROOT=data, RUN_ID="dp")
    return work, data, work / "results" / "synthetic-tiny-scm" / "dp", outs


def test_train_cli_two_ranks_writes_from_rank0(dp_run):
    work, _, run, (out0, out1) = dp_run
    lines = [json.loads(line) for line in (run / "stats.jsonl").read_text().splitlines()]
    assert [line["train/iter"]["mean"] for line in lines] == [1, 2, 3]
    assert all(np.isfinite(line["train/loss"]["mean"]) for line in lines)
    assert len(glob.glob(str(run / "checkpoints" / "*.npz"))) == 1
    assert "Data parallel over 2 ranks: 2 of the global batch of 4" in out0
    assert "Saving checkpoint" in out0 and "Saving checkpoint" not in out1
    assert "Data parallel" not in out1  # log0: rank 0 only
    # both ranks logged the same losses: the means over the ranks
    losses = [re.findall(r" loss=(\S+)", out) for out in (out0, out1)]
    assert losses[0] == losses[1] and len(losses[0]) == 3


@pytest.mark.parametrize("dump,members", [("zarr", 3), ("numpy", 2)])
def test_generate_two_ranks_writes_the_one_rank_store(dp_run, dump, members):
    """3 members over 2 ranks: rank 1 rolls out member 2 and a pad member,
    which it does not write."""
    work, data, run, _ = dp_run
    argv = ["--input", str(run), "--members", str(members), "--steps", "3", "--batch", "2",
            "--samples", "3", "--segment", "2", "--solver", "scm", "--num-solver-steps", "2",
            "--dump", dump, "--device", "cpu"]
    one = generate.cli(argv + ["--output", str(work / f"one-{dump}")])
    _two_ranks([sys.executable, "-m", "swift_torch.generate", *argv, "--output",
                str(work / f"two-{dump}")], cwd=str(work), SWIFT_SYNTH_ROOT=data)
    two = os.path.join(work / f"two-{dump}", os.path.basename(one))
    if dump == "zarr":
        assert os.path.exists(os.path.join(two, ".zmetadata"))
        want, got = generate.read_store(one), generate.read_store(two)
    else:
        want, got = {"all": np.load(one)}, {"all": np.load(two)}
    assert sorted(got) == sorted(want)
    assert any(np.abs(w[:, :, 1:]).max() > 0 for w in want.values())  # SST is zeroed
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)


def test_validate_two_ranks_log_one_mean(dp_run):
    work, data, run, _ = dp_run
    outs = _two_ranks([sys.executable, "-m", "swift_torch.training.validate", "--input",
                       str(run), "--target_interval", "4", "--batch", "1", "--samples", "4",
                       "--device", "cpu"], cwd=str(work), SWIFT_SYNTH_ROOT=data)
    agg = re.findall(r"aggregate rmse: (\S+)", outs[0])
    assert len(agg) == 1 and np.isfinite(float(agg[0]))
    assert "aggregate rmse" not in outs[1]  # log0


@pytest.mark.parametrize("system", ["tpu-tp", "tpu-pp"])
def test_tensor_and_pipeline_parallelism_refused(dp_run, system, monkeypatch):
    """Neither axis is refused by ``train``: it sets up on two ranks (a dry
    run), the model ranks splitting a replica or the stage ranks repeating
    its step (the JAX package does not pipeline training). ``generate``
    forecasts a ``tpu-tp`` run on one process, data-parallel with its
    ``model`` axis ignored; a ``tpu-pp`` run's two stages need two ranks, so
    one process refuses them unless ``--pp 1`` turns them off."""
    work, data, run, _ = dp_run
    monkeypatch.chdir(work)
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    monkeypatch.setenv("RUN_ID", f"refused-{system}")
    cfg = train.cfglib.load_config(run / ".hydra" / "config.yaml")
    cfg["system"] = train.cfglib.compose("train", [f"system={system}"])["system"]
    saved = work / f"run-{system}"
    train.cfglib.save_config(cfg, saved / ".hydra" / "config.yaml")
    argv = ["--input", str(saved), "--device", "cpu"]
    outs = _two_ranks([sys.executable, "-m", "swift_torch.train", "experiment=synthetic-tiny-scm",
                       f"system={system}", "dry_run=true", "--device", "cpu"], cwd=str(work),
                      SWIFT_SYNTH_ROOT=data)
    if system == "tpu-tp":
        assert "Tensor parallel over 2 ranks a replica (1 replicas)" in outs[0]
    else:
        assert "Pipe axis of 2 ranks a replica (1 replicas)" in outs[0]
    assert "Dry run requested" in outs[0]
    os.makedirs(saved / "checkpoints")
    for ckpt in glob.glob(str(run / "checkpoints" / "*.npz")):
        os.symlink(ckpt, saved / "checkpoints" / os.path.basename(ckpt))
    rollout = ["--members", "1", "--steps", "2", "--batch", "1", "--samples", "1", "--segment",
               "1", "--solver", "scm", "--num-solver-steps", "1", "--output",
               str(work / f"{system}-store")]
    if system == "tpu-pp":
        with pytest.raises(ValueError, match="2 pipeline stages need a multiple of 2 ranks"):
            generate.cli(argv + rollout)
        rollout += ["--pp", "1"]
    store = generate.cli(argv + rollout)
    assert all(np.isfinite(v).all() for v in generate.read_store(store).values())


def test_parallel_modules_import_no_jax():
    code = """
import sys
from swift_torch import generate, train
from swift_torch.parallel import mesh, sharding, tensor
from swift_torch.sampling.ensemble import EnsembleRollout, RowDraws, member_block
from swift_torch.training import trainer, validate
from swift_torch.utils import device, stats
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "swift_tpu"))
assert not bad, bad
print("no-jax-ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "no-jax-ok" in res.stdout, res.stderr[-2000:]
