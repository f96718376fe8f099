"""Pipeline parallelism of the port on the CPU: gloo ranks against one
process and against the JAX package's pipeline on the host devices.

* The stage split (``SwinV2.forward(stage=...)``): embed → pairs → head,
  and two stage models' pairs in turn, equal the port's one-shot forward
  bit for bit; each piece matches JAX's staged ``apply``.
* ``pipelined_swinv2_forward`` on 2 gloo ranks (depth 4) and on 3 (depth
  6), M ∈ {S, 2S}, with and without aux (``tests/_torch_pp_worker.py``):
  every rank's output equals the port's one-process forward of each
  microbatch bit for bit (JAX's own test holds its pipeline to its
  forward at rtol/atol 1e-6) and JAX's ``pipelined_swinv2_forward`` on
  the host devices within the model's parity limit against JAX, 1e-4 of
  max|y| (XLA and PyTorch sum in different orders: about 1e-5 of max|y|
  at these depths; ``tests/test_torch_swinv2.py``'s rtol).
* Gradients of mean(y²) through the pipeline (S = 2 and S = 3; the
  replicated parameters' summed over the pipe group): against one process
  on the whole batch at JAX's limits (rtol 1e-5, atol 1e-6 of max|g|)
  and against ``jax.grad`` at the model's gradient limits
  (``tests/test_torch_train.py``: rtol 1e-4, atol 1e-4 of max|g|),
  through JAX's pipeline at S = 2, of its one-device forward (to which
  JAX's tests hold its pipeline's) at S = 3.
* dp × pp on 4 ranks (data 2 × pipe 2, ``data_axis="data"``), forward and
  gradients, as ``test_pipelined_dp_composition`` checks: the output
  against JAX's pipeline on a (2, 2) mesh, the gradients against one
  process and JAX's one-device forward.
* The same validation errors as JAX; the pipelined precond refuses model
  kwargs (``jvp``, ``return_logvar``).
* ``train experiment=synthetic-tiny-scm system=tpu-pp`` on two ranks logs
  one process's losses and saves its mesh; ``generate --pp 2`` on 2 ranks
  and on 4 (data 2 × pipe 2), scm, dpm and ``--int8``, and the pipe axis
  taken from the saved config, each write the one-process store within
  1e-5 of max|store|; ``--pp 1`` turns it off; too few ranks, or no CUDA
  without ``--device cpu``, fail; offline validation and the solver sweep
  take the run.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from swift_torch import generate, train
from swift_torch.models import convert
from swift_torch.models.precond import EDMPrecond, PassPrecond
from swift_torch.parallel import mesh
from swift_torch.parallel.pipeline import pipelined_precond, pipelined_swinv2_forward
from swift_torch.eval import sampler as sweep
from swift_torch.training import validate
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.models.swinv2 import SwinV2 as JaxSwinV2
from swift_tpu.parallel.pipeline import pipelined_swinv2_forward as jax_pipelined
from tests import _torch_pp_worker as worker
from tests.test_torch_parallel import E2E_VARS, _two_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4  # the port's SwinV2 against JAX's, of max|want| (tests/test_torch_swinv2.py)


def _case(name, depth, n_micro, aux, B, **kw):
    return dict(name=name, depth=depth, n_micro=n_micro, aux=aux, B=B, **kw)


# (pipe size, world) -> the worker's cases
CASES = {
    2: [_case(f"d4-m{m}-{'aux' if a else 'noaux'}", 4, m, a, 4) for m in (2, 4)
        for a in (True, False)] + [_case("grads", 4, 2, True, 4, grads=True)],
    3: [_case(f"d6-m{m}-{'aux' if a else 'noaux'}", 6, m, a, 6) for m in (3, 6)
        for a in (True, False)] + [_case("grads", 6, 3, True, 6, grads=True)],
    4: [_case("dp", 4, 2, True, 8, grads=True, data_axis=True)],
}


def _jax_model(depth, aux):
    return JaxSwinV2(img_resolution=(16, 32), in_channels=8, out_channels=5, window_size=(4, 4),
                     shift_size=(2, 2), patch_size=(2, 2), depth=depth, dim=32, heads=4,
                     auxiliary_dim=1 if aux else 0, dtype=jnp.float32, use_pallas=False,
                     remat_layers=False)


def _inputs(case, seed):
    """x, t, aux of a case (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    B = case["B"]
    return {"x": rng.normal(size=(B, 16, 32, 8)).astype(np.float32),
            "t": rng.uniform(0.1, 1.4, size=(B,)).astype(np.float32),
            "aux": rng.normal(size=(B, 1)).astype(np.float32)}


def _weights(depth, aux, seed):
    """The JAX model and its weights, noisy (the zero-initialised head would
    hide errors)."""
    rng = np.random.default_rng(seed)
    model = _jax_model(depth, aux)
    x = np.zeros((1, 16, 32, 8), np.float32)
    params = model.init(jax.random.PRNGKey(seed), x, np.zeros(1, np.float32),
                        np.zeros((1, 1), np.float32) if aux else None)["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape).astype(np.float32), params)
    return model, params


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's JAX model, weights (one set a depth and aux) and inputs,
    written for the workers."""
    work = tmp_path_factory.mktemp("pp")
    out, weights = {}, {}
    for world, specs in CASES.items():
        d = work / f"world{world}"
        d.mkdir()
        for i, case in enumerate(specs):
            key = (case["depth"], case["aux"])
            if key not in weights:
                weights[key] = _weights(*key, seed=len(weights))
            model, params = weights[key]
            arrays = _inputs(case, seed=10 * world + i)
            np.savez(d / f"{case['name']}.npz", **arrays, **convert.params_to_state_dict(params))
            out[world, case["name"]] = (case, model, params, arrays)
        pipe = 2 if world == 4 else world
        (d / "spec.json").write_text(json.dumps({"pipe": pipe, "cases": specs}))
    return work, out


@pytest.fixture(scope="module")
def ranks(cases):
    """Each world's ranks' results (2 and 3 stages, data 2 × pipe 2)."""
    work, _ = cases
    out = {}
    for world in CASES:
        cmd = [sys.executable, os.path.join(ROOT, "tests", "_torch_pp_worker.py"),
               str(work / f"world{world}")]
        logs = _two_ranks(cmd, str(work), ranks=world)
        assert all(f"PP_WORKER_OK rank={r}" in log for r, log in enumerate(logs)), logs
        out[world] = [torch.load(work / f"world{world}" / f"rank{r}.pt") for r in range(world)]
    return out


def _one_process(case, params, arrays):
    """The port's whole network: each microbatch's forward (no grad), and
    the whole batch's output and gradients of mean(y²)."""
    net = worker.build(case["depth"], case["aux"], convert.params_to_state_dict(params))
    x, t = torch.from_numpy(arrays["x"]), torch.from_numpy(arrays["t"])
    aux = torch.from_numpy(arrays["aux"]) if case["aux"] else None
    mb = case["B"] // case["n_micro"]
    with torch.no_grad():
        parts = [net(x[i:i + mb], t[i:i + mb], None if aux is None else aux[i:i + mb])
                 for i in range(0, case["B"], mb)]
    y = net(x, t, aux)
    (y ** 2).mean().backward()
    return torch.cat(parts), y.detach(), {n: p.grad for n, p in net.named_parameters()}


def _jax_pipeline(case, model, params, arrays, grads=False):
    S = 3 if case["depth"] == 6 else 2
    data = 2 if case.get("data_axis") else 1
    devices = np.array(jax.devices()[:S * data])
    m = Mesh(devices.reshape(data, S), ("data", "pipe")) if data > 1 else Mesh(devices, ("pipe",))
    aux = arrays["aux"] if case["aux"] else None
    kw = dict(mesh=m, n_micro=case["n_micro"], data_axis="data" if data > 1 else None)

    def f(v):
        return jax_pipelined(model, v, arrays["x"], arrays["t"], aux, **kw)

    y = np.asarray(f({"params": params}))
    if not grads:
        return y, None
    return y, _jax_grads(f, params)


def _jax_grads(f, params) -> dict:
    """``jax.grad`` of mean(f(variables)²), under the port's names."""
    g = jax.grad(lambda v: jnp.mean(f(v) ** 2))({"params": params})["params"]
    return {k[len("model."):]: v for k, v in convert.params_to_state_dict(g).items()}


def _jax_direct_grads(model, params, arrays, aux: bool) -> dict:
    """The gradients of JAX's one-device forward, to which JAX's own tests
    hold its pipeline's (``tests/test_pipeline.py``)."""
    a = arrays["aux"] if aux else None
    return _jax_grads(lambda v: model.apply(v, arrays["x"], arrays["t"], a), params)


def _near(got, want, rtol: float = RTOL) -> None:
    """Within ``rtol`` of max|want|: the elements near 0 take the rounding
    of the whole stack's values (about 1e-5 of them between XLA and
    PyTorch in fp32 at these depths)."""
    got = got.numpy() if hasattr(got, "numpy") else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def _near_grads(got: dict, want: dict, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for n in want:
        w = np.asarray(want[n])
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(np.asarray(got[n]), w, rtol=rtol, atol=rtol * scale,
                                   err_msg=n)


# -- the stage split ---------------------------------------------------------------------


def test_stage_split_bit_for_bit(cases):
    """embed → pairs → head is the one-shot forward, and stage 0's pairs then
    stage 1's are the whole pair stack, bit for bit."""
    _, all_cases = cases
    case, _, params, arrays = all_cases[2, "d4-m2-aux"]
    sd = convert.params_to_state_dict(params)
    net = worker.build(4, True, sd)
    stages = [worker.build(4, True, sd, 2, s) for s in (0, 1)]
    x, t, aux = (torch.from_numpy(arrays[k]) for k in ("x", "t", "aux"))
    with torch.no_grad():
        y = net(x, t, aux)
        h, cond = net(x, t, aux, stage="embed")
        assert h.shape == (4, 8, 16, 32) and cond.dtype == torch.float32
        h_all = net(h, cond, stage="pairs")
        assert torch.equal(net(h_all, cond, stage="head"), y)
        h2 = stages[1](stages[0](h, cond, stage="pairs"), cond, stage="pairs")
        assert torch.equal(h2, h_all)
        assert torch.equal(stages[1](h2, cond, stage="head"), y)
    assert len(stages[0].transformer.layers) == 2 and stages[1].first_layer == 2


def test_stage_split_matches_jax_staged_apply(cases):
    _, all_cases = cases
    case, model, params, arrays = all_cases[2, "d4-m2-aux"]
    v = {"params": params}
    x, t, aux = arrays["x"], arrays["t"], arrays["aux"]
    jh, jc = model.apply(v, x, t, aux, stage="embed")
    jh2 = model.apply(v, jh, jc, stage="pairs")
    jy = model.apply(v, jh2, jc, stage="head")
    net = worker.build(4, True, convert.params_to_state_dict(params))
    with torch.no_grad():
        h, cond = net(*(torch.from_numpy(a) for a in (x, t, aux)), stage="embed")
        # the port's h is (B, gh, gw, dim), JAX's (B, gh·gw, dim)
        _near(h.reshape(4, -1, 32).numpy(), np.asarray(jh))
        _near(cond.numpy(), np.asarray(jc))
        # each stage from JAX's input to it
        h_in = torch.from_numpy(np.array(jh)).reshape(4, 8, 16, 32)
        c_in = torch.from_numpy(np.array(jc))
        h2 = net(h_in, c_in, stage="pairs")
        _near(h2.reshape(4, -1, 32).numpy(), np.asarray(jh2))
        y = net(torch.from_numpy(np.array(jh2)).reshape(4, 8, 16, 32), c_in, stage="head")
        _near(y.numpy(), np.asarray(jy))


# -- the pipelined forward --------------------------------------------------------------------


@pytest.mark.parametrize("world,name", [(w, c["name"]) for w in (2, 3) for c in CASES[w]
                                        if not c.get("grads")])
def test_pipelined_forward_matches(cases, ranks, world, name):
    _, all_cases = cases
    case, model, params, arrays = all_cases[world, name]
    res = ranks[world]
    assert [r["layout"] for r in res] == [[1, world, 0, s] for s in range(world)]
    parts, _, _ = _one_process(case, params, arrays)
    for r in res:  # every stage holds the output, each microbatch's one-process forward
        assert torch.equal(r[name]["y"], parts), r["layout"]
    want, _ = _jax_pipeline(case, model, params, arrays)
    _near(res[0][name]["y"].numpy(), want)


@pytest.mark.parametrize("world", [2, 3])
def test_pipelined_forward_grads_match(cases, ranks, world):
    """Each stage holds its own pairs' gradients; the replicated
    parameters' are alike on every stage after the pipe group's sum."""
    _, all_cases = cases
    case, model, params, arrays = all_cases[world, "grads"]
    res = [r["grads"] for r in ranks[world]]
    got = {}
    per = case["depth"] // world
    for s, r in enumerate(res):
        mine = {int(n.split(".")[2]) for n in r["grads"] if n.startswith("transformer.layers.")}
        assert mine == set(range(s * per, (s + 1) * per)) and r["first_layer"] == s * per
        for n, g in r["grads"].items():
            if n.startswith("transformer.layers."):
                got[n] = g
            else:
                assert torch.equal(g, res[0]["grads"][n]), n
                got[n] = g
    _, y, one = _one_process(case, params, arrays)
    np.testing.assert_allclose(res[0]["y"].numpy(), y.numpy(), rtol=1e-6, atol=1e-6)
    _near_grads(got, one, 1e-5)
    if world == 2:  # through JAX's pipeline (its compile takes most of a minute)
        _, want = _jax_pipeline(case, model, params, arrays, grads=True)
    else:
        want = _jax_direct_grads(model, params, arrays, case["aux"])
    _near_grads(got, want, RTOL)


def test_pipelined_dp_composition(cases, ranks):
    """data 2 × pipe 2, ``data_axis="data"``: each data row pipelines its
    half of the batch; the output and the gradients are the whole batch's."""
    _, all_cases = cases
    case, model, params, arrays = all_cases[4, "dp"]
    res = ranks[4]
    assert [r["layout"] for r in res] == [[2, 2, r // 2, r % 2] for r in range(4)]
    parts, y, one = _one_process(case, params, arrays)
    for r in res:
        assert torch.equal(r["dp"]["y"], parts)
    got = dict(res[0]["dp"]["grads"])
    got.update({n: g for n, g in res[1]["dp"]["grads"].items() if "layers" in n})
    for a, b in ((0, 2), (1, 3)):  # the data rows end alike
        for n, g in res[a]["dp"]["grads"].items():
            assert torch.equal(g, res[b]["dp"]["grads"][n]), n
    _near_grads(got, one, 1e-5)
    want_y, _ = _jax_pipeline(case, model, params, arrays)
    _near(res[0]["dp"]["y"].numpy(), want_y)
    _near_grads(got, _jax_direct_grads(model, params, arrays, case["aux"]), RTOL)


def test_pipelined_forward_validates_split(cases):
    """JAX's errors, raised before any transfer: pairs that do not split
    over the stages, a batch that does not split into the microbatches (and
    data shards), n_micro < 1; and a model that is not this rank's stage."""
    _, all_cases = cases
    case, _, params, arrays = all_cases[2, "d4-m2-aux"]
    net = worker.build(4, True, convert.params_to_state_dict(params))
    x, t, aux = (torch.from_numpy(arrays[k]) for k in ("x", "t", "aux"))
    three = mesh.Layout(1, 1, 0, 0, pipe=3)
    two = mesh.Layout(1, 1, 0, 0, pipe=2)
    with pytest.raises(ValueError, match="block pairs"):
        pipelined_swinv2_forward(net, x, t, aux, mesh=three)
    with pytest.raises(ValueError, match="microbatches"):
        pipelined_swinv2_forward(net, x, t, aux, mesh=two, n_micro=3)
    with pytest.raises(ValueError, match="microbatches x 2 data shards"):
        pipelined_swinv2_forward(net, x[:2], t[:2], aux[:2], data_axis="data",
                                 mesh=mesh.Layout(2, 1, 0, 0, pipe=2))
    for bad in (0, -2):
        with pytest.raises(ValueError, match="n_micro"):
            pipelined_swinv2_forward(net, x, t, aux, mesh=two, n_micro=bad)
    with pytest.raises(ValueError, match="stage 0 of 1; this rank is stage 0 of 2"):
        pipelined_swinv2_forward(net, x, t, aux, mesh=two)
    with pytest.raises(ValueError, match="block pairs do not split over 3 stages"):
        worker.build(4, True, convert.params_to_state_dict(params), 3, 0)


@pytest.mark.parametrize("precond", [PassPrecond, EDMPrecond])
@pytest.mark.parametrize("kwarg", ["jvp", "return_logvar"])
def test_pipelined_precond_refuses_model_kwargs(cases, precond, kwarg):
    _, all_cases = cases
    case, _, params, arrays = all_cases[2, "d4-m2-aux"]
    stage = worker.build(4, True, convert.params_to_state_dict(params), 2, 0)
    net = pipelined_precond(precond(stage, (16, 32), 4, condition_channels=4, auxiliary_dim=1),
                            mesh.Layout(1, 1, 0, 0, pipe=2))
    x = torch.from_numpy(arrays["x"][:, :, :, :4])
    with pytest.raises(ValueError, match="plain prediction call only"):
        net(x, torch.ones(4), x, 0.6, **{kwarg: True})
    assert net.model is stage and net.pipeline.n_micro is None


@pytest.mark.parametrize("cfg,world,want", [
    ({"axes": ["data", "pipe"], "sizes": [-1, 2]}, 4, (2, 1, 2)),
    ({"axes": ["data", "pipe"], "sizes": [-1, 2]}, 2, (1, 1, 2)),
    ({"axes": ["data", "pipe"], "sizes": [2, -1]}, 6, (2, 1, 3)),
    ({"axes": ["data", "pipe"], "sizes": [-1, 2]}, 3, ValueError),
    ({"axes": ["data", "model", "pipe"], "sizes": [1, 2, 2]}, 4, NotImplementedError),
])
def test_pipe_mesh_sizes(cfg, world, want):
    cfg = {"system": {"mesh": cfg}}
    if isinstance(want, tuple):
        assert mesh.mesh_sizes(cfg, world) == want
    else:
        with pytest.raises(want):
            mesh.mesh_sizes(cfg, world)


# -- the entry points -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    """``train experiment=synthetic-tiny-scm model.depth=4 system=tpu-pp`` on
    two ranks (3 steps), and the same on one process without the pipe axis."""
    work = tmp_path_factory.mktemp("pp_run")
    data = make_synthetic_era5(str(work / "data"), E2E_VARS, ["land_sea_mask"], n_train=12,
                               n_val=2, n_test=8)
    args = ["experiment=synthetic-tiny-scm", "model.depth=4", "trainer.kimg_per_tick=0.004",
            "trainer.total_kimg=0.012", "--device", "cpu"]
    outs = _two_ranks([sys.executable, "-m", "swift_torch.train", *args, "system=tpu-pp"],
                      cwd=str(work), SWIFT_SYNTH_ROOT=data, RUN_ID="pp")
    (work / "one").mkdir()  # the same run id (so the same seed), its own results
    one = subprocess.run([sys.executable, "-m", "swift_torch.train", *args], cwd=str(work / "one"),
                         env=dict(os.environ, SWIFT_SYNTH_ROOT=data, RUN_ID="pp",
                                  SWIFT_NO_DIST_INIT="1",
                                  PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")),
                         capture_output=True, text=True, timeout=120)
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    run = work / "results" / "synthetic-tiny-scm" / "pp"
    return work, data, run, outs, one.stdout + one.stderr


def test_train_tpu_pp_takes_one_process_steps(pp_run):
    """The stage ranks hold the whole network and take one process's steps:
    the same losses; the saved config keeps the pipe axis."""
    _, _, run, outs, one = pp_run
    assert "Pipe axis of 2 ranks a replica (1 replicas): training is not pipelined" in outs[0]
    losses = [re.findall(r" loss=(\S+)", out) for out in (outs[0], outs[1], one)]
    assert len(losses[0]) == 3 and losses[0] == losses[1] == losses[2]
    cfg = train.cfglib.load_config(run / ".hydra" / "config.yaml")
    assert cfg["system"]["mesh"] == {"axes": ["data", "pipe"], "sizes": [-1, 2]}
    assert "n_micro" in cfg["system"]["pipeline"]


def _generate_argv(run, solver="scm"):
    return ["--input", str(run), "--members", "2", "--steps", "2", "--batch", "2",
            "--samples", "2", "--segment", "1", "--solver", solver,
            "--num-solver-steps", "2" if solver == "dpm" else "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def one_stores(pp_run):
    """One process's stores of the run (``--pp 1`` over the saved pipe axis)."""
    work, data, run, _, _ = pp_run
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWIFT_SYNTH_ROOT", data)
        return {name: generate.read_store(generate.cli(
            _generate_argv(run, solver) + extra + ["--pp", "1", "--output", str(work / name)]))
            for name, solver, extra in (("scm", "scm", []), ("dpm", "dpm", []),
                                        ("int8", "scm", ["--int8"]))}


def _store_near(store: str, want: dict) -> None:
    got = generate.read_store(store)
    assert sorted(got) == sorted(want)
    assert any(np.abs(w[:, :, 1:]).max() > 0 for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("world,solver,extra", [
    (2, "scm", ["--pp", "2", "--pp-micro", "2"]),
    (2, "dpm", ["--pp", "2", "--pp-micro", "4"]),
    (2, "scm", []),  # the pipe axis from the saved config
    (4, "scm", ["--pp", "2"]),  # data 2 x pipe 2
    (2, "int8", ["--pp", "2", "--int8"]),
])
def test_generate_pp_writes_the_one_process_store(pp_run, one_stores, world, solver, extra):
    work, data, run, _, _ = pp_run
    out = work / f"pp-{world}-{solver}-{len(extra)}"
    argv = _generate_argv(run, "scm" if solver == "int8" else solver)
    logs = _two_ranks([sys.executable, "-m", "swift_torch.generate", *argv, *extra, "--output",
                       str(out)], cwd=str(work), ranks=world, SWIFT_SYNTH_ROOT=data)
    micro = extra[extra.index("--pp-micro") + 1] if "--pp-micro" in extra else "2"
    assert (f"Pipeline parallel: 2 stages a replica ({world // 2} replicas), 1 block pairs a "
            f"stage, {micro} microbatches") in logs[0]
    store = os.path.join(out, "output-2i-2s-2m-6h.zarr")
    _store_near(store, one_stores[solver])


def test_generate_pp_needs_its_ranks(pp_run, monkeypatch):
    """A saved pipe axis of 2, or ``--pp 2``, on one process raises; ``--pp
    1`` forecasts it on one (the ``one_stores`` fixture)."""
    work, data, run, _, _ = pp_run
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    for extra in ([], ["--pp", "2"]):
        with pytest.raises(ValueError, match="2 pipeline stages need a multiple of 2 ranks"):
            generate.cli(_generate_argv(run) + extra + ["--output", str(work / "refused")])


@pytest.mark.parametrize("tool", ["validate", "sampler"])
def test_offline_tools_accept_a_tpu_pp_run(pp_run, monkeypatch, tool):
    """Offline validation and the solver sweep run such a run on one
    process, its pipe axis ignored, as they run a ``tpu-tp`` run."""
    work, data, run, _, _ = pp_run
    monkeypatch.setenv("SWIFT_SYNTH_ROOT", data)
    if tool == "validate":
        agg, _ = validate.main(["--input", str(run), "--target_interval", "4", "--batch", "1",
                                "--samples", "2", "--device", "cpu"])
        assert np.isfinite(float(agg))
    else:
        rows = sweep.main(["--input", str(run), "--num-steps", "1", "--samples", "2",
                           "--batch", "2", "--device", "cpu"])
        assert rows and (run / "output" / "sampler_results.csv").exists()


def test_pp_needs_cuda_unless_asked_for_the_cpu(pp_run):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, run, _, _ = pp_run
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.setup(["experiment=synthetic-tiny-scm", "system=tpu-pp"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.cli(["--input", str(run), "--pp", "2"])


def test_pipeline_modules_import_no_jax():
    code = """
import sys
from swift_torch.parallel import pipeline
from swift_torch import generate
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "swift_tpu"))
assert not bad, bad
print("no-jax-ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "no-jax-ok" in res.stdout, res.stderr[-2000:]
