"""swift_torch's ensemble rollout and generate CLI against the JAX package.

* A 3-step residual rollout of the same network on the same synthetic data
  with identical latents: the JAX engine draws them from its keys, and the
  port's engine is handed the same numbers (jax.random and torch.Generator
  differ). fp32 model; tolerance rtol 1e-4 / atol 1e-4 on physical-space
  fields of magnitude ~10 after three residual steps.
* ``swift_torch.generate`` on a tiny run directory whose checkpoint the
  JAX package wrote, against ``swift_tpu.generate`` on the same run: the
  same store layout (arrays, shapes, chunks, dims, coordinates) and the
  same lead-0 fields; later leads differ by their random latents.
* Checkpoints cross both ways: the port reads a JAX-written npz and the JAX
  loader reads the one the port writes, bit for bit.
* ``--dump numpy`` writes the (n, members, steps+1, C, H, W) array.
* Importing and running the port (its training modules too) leaves jax,
  flax, optax and every ``swift_tpu`` module out of ``sys.modules``.
* ``generate`` runs on CUDA unless ``--device cpu`` asks for the CPU, and
  raises where CUDA is absent.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import swift_tpu.factory as jfactory
import swift_tpu.generate as jgenerate
from swift_torch import factory, generate
from swift_torch.models import convert
from swift_torch.sampling.ensemble import EnsembleRollout
from swift_torch.sampling.factory import sampler_factory
from swift_tpu.data.era5 import ERA5Dataset
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.sampling.ensemble import EnsembleRollout as JaxEnsembleRollout
from swift_tpu.sampling.factory import param_sampler_factory
from swift_tpu.utils import zarr_lite
from swift_torch.utils.checkpoint import load_checkpoint
from swift_torch.utils.checkpoint import save_checkpoint as save_checkpoint_torch
from swift_tpu.utils.checkpoint import load_checkpoint as load_checkpoint_jax
from swift_tpu.utils.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARS = ["2m_temperature", "sea_surface_temperature", "geopotential_500",
        "geopotential_850", "temperature_850"]
FORC = ["land_sea_mask"]
MODEL = {"_target_": "swift_tpu.models.swinv2.SwinV2", "window_size": [2, 2],
         "shift_size": [1, 1], "patch_size": [2, 2], "depth": 2, "dim": 32, "heads": 2,
         "logvar": True}
PRECOND = {"_target_": "swift_tpu.models.precond.PassPrecond", "auxiliary_dim": 1,
           "sigma_data": 1.0}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Synthetic data + a run dir whose config and checkpoint the JAX package wrote."""
    base = tmp_path_factory.mktemp("torch_generate")
    data = make_synthetic_era5(str(base / "data"), VARS, FORC, n_train=2, n_val=2,
                               n_test=10, shape=(8, 16), seed=0)
    run = base / "run"
    (run / ".hydra").mkdir(parents=True)
    cfg = {"data": {"dataset": {"_target_": "swift.data.era5.ERA5Dataset", "root": data,
                                "variables": VARS, "forcings": FORC, "residual": True}},
           "model": MODEL, "precond": PRECOND}
    (run / ".hydra" / "config.yaml").write_text(yaml.safe_dump(cfg))
    ds = ERA5Dataset(data, VARS, FORC, split="test", residual=True)
    pre = jfactory.build_precond(PRECOND, MODEL, ds.img_resolution, ds.n_target_channels,
                                 ds.n_condition_channels, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        pre.init(jax.random.PRNGKey(0)))
    save_checkpoint(str(run / "checkpoints" / "checkpoint-000002.npz"),
                    {"params": params, "ema": params})
    return run, ds, pre, params


def test_residual_rollout_matches_jax(run_dir):
    _, ds, jpre, params = run_dir
    members, steps, seed = 2, 3, 5
    rng = np.random.default_rng(2)
    X0 = np.stack([ds.standardize_x(ds._load_file(ds.files[i], VARS)) for i in (0, 3)])
    forc = rng.standard_normal((2, steps, 8, 16, 1)).astype(np.float32)

    def collect(out):
        return lambda ic, m, lead, chunk: out.setdefault((m, lead), np.array(chunk))

    want = {}
    jsampler = param_sampler_factory("scm", jpre, num_steps=1, sigma_min=0.02,
                                     sigma_max=200.0, auxiliary=0.6)
    JaxEnsembleRollout(jsampler, params, ds, members, steps, segment=2,
                       base_seed=seed).run(X0, forc, 0, collect(want))

    # the JAX engine's latents: key(step) = fold_in(PRNGKey(seed*7919 + ic), step),
    # latents = normal(split(key)[0], (members*B, H, W, C))
    root = jax.random.PRNGKey(seed * 7919 + 0)
    latents = iter([
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.split(jax.random.fold_in(root, s))[0], (members * 2, 8, 16, len(VARS)))))
        for s in range(steps)
    ])
    tpre = factory.build_precond(PRECOND, MODEL, ds.img_resolution, ds.n_target_channels,
                                 ds.n_condition_channels, dtype=torch.float32)
    tpre.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.params_to_state_dict(params).items()})
    sampler = sampler_factory("scm", tpre.eval(), num_steps=1, sigma_min=0.02,
                              sigma_max=200.0, auxiliary=0.6)
    got = {}
    EnsembleRollout(lambda X, gen, auxiliary=None: sampler(X, gen, auxiliary, next(latents)),
                    ds, members, steps, segment=2, base_seed=seed).run(X0, forc, 0, collect(got))

    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=str(k))
    sst = VARS.index("sea_surface_temperature")
    assert not np.any(got[(1, 3)][..., sst]), "SST is zeroed at a 6 h interval"


def test_generate_store_layout_matches_jax(run_dir, monkeypatch, tmp_path):
    run = run_dir[0]
    monkeypatch.setenv("SWIFT_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("SWIFT_DEVICE_KEEPALIVE", "0")
    argv = ["--input", str(run), "--members", "2", "--steps", "2", "--batch", "2",
            "--samples", "3", "--segment", "1", "--seed", "3"]
    got_file = generate.cli(argv + ["--output", str(tmp_path / "torch"), "--device", "cpu"])
    want_file = jgenerate.main(jgenerate.parser.parse_args(argv + ["--output",
                                                                   str(tmp_path / "jax")]))
    assert os.path.basename(got_file) == os.path.basename(want_file)
    got, want = zarr_lite.open_group(got_file), zarr_lite.open_group(want_file)
    names = sorted(n for n in os.listdir(want_file) if not n.startswith("."))
    assert sorted(n for n in os.listdir(got_file) if not n.startswith(".")) == names
    fields = generate.read_store(got_file)
    assert sorted(fields) == [n for n in names if len(want[n].shape) >= 5]
    for n in names:
        g, w = got[n], want[n]
        assert (g.shape, g.chunks, g.dtype) == (w.shape, w.chunks, w.dtype), n
        assert g.attrs == w.attrs, n
        gv, wv = np.asarray(g[:]), np.asarray(w[:])
        if gv.ndim <= 1:  # coordinates
            np.testing.assert_array_equal(gv, wv, err_msg=n)
        else:  # lead 0 is the physical initial condition for every member
            np.testing.assert_allclose(gv[:, :, 0], wv[:, :, 0], rtol=1e-6, err_msg=n)
            assert np.isfinite(gv).all(), n
            if n != "sea_surface_temperature":  # SST is zeroed at a 6 h interval
                assert np.abs(gv[:, :, 1:]).max() > 0, n


def test_checkpoint_round_trip_through_jax(run_dir, tmp_path):
    """The port reads the JAX package's checkpoint, and the JAX loader reads
    the one the port writes back, to the same weights."""
    run, ds, jpre, params = run_dir
    sd = load_checkpoint(str(run / "checkpoints" / "checkpoint-000002.npz"))
    path = str(tmp_path / "checkpoint-000003.npz")
    save_checkpoint_torch(path, sd, depth=MODEL["depth"])
    back = load_checkpoint_jax(path, {"ema": jpre.init(jax.random.PRNGKey(1))})["ema"]
    flat_b, flat_p = convert.flatten(back), convert.flatten(params)
    assert sorted(flat_b) == sorted(flat_p)
    for k in flat_p:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), np.asarray(flat_p[k]), err_msg=k)


def test_port_never_imports_jax():
    code = """
import sys
import numpy as np, torch
from swift_torch import config, factory, generate, train
from swift_torch.data import era5, pipeline, samplers, synthetic
from swift_torch.data.synthetic import SyntheticERA5
from swift_torch.ops import block_attention, ffn, jvp_guard, linear, modnorm
from swift_torch.training import loss, trainer
from swift_torch.training.optimizers import muon
from swift_torch.utils import checkpoint, io, zarr_lite
VARS = %r
ds = SyntheticERA5(VARS, ["land_sea_mask"], n_files=8, shape=(8, 16))
net = factory.build_precond(%r, %r, ds.img_resolution, ds.n_target_channels,
                            ds.n_condition_channels).eval()
class Args: members, steps, batch, samples, interval, segment, seed, solver, \
    num_solver_steps, dump = 2, 2, 2, 2, 6, 1, 0, "scm", 1, "zarr"
generate.rollout_to_store(Args, ds, net, sys.argv[1])
# the 0.25° model's pieces: latitude padding, factorized table, tiled route
quarter = factory.build_precond(%r, {**%r, "pos_embed_mode": "factorized",
                                     "window_size": [4, 8], "shift_size": [2, 4]},
                                (30, 64), 5, 6).eval()
with torch.no_grad():
    quarter(torch.randn(1, 30, 64, 5), torch.ones(1), torch.randn(1, 30, 64, 6),
            torch.ones(1, 1))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "swift_tpu"))
assert not bad, bad
print("no-jax-ok")
""" % (VARS, PRECOND, MODEL, PRECOND, MODEL)
    import tempfile

    with tempfile.TemporaryDirectory() as odir:
        res = subprocess.run([sys.executable, "-c", code, odir], cwd=ROOT, capture_output=True,
                             text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0 and "no-jax-ok" in res.stdout, res.stdout + res.stderr


def test_numpy_dump_layout(tmp_path):
    """``--dump numpy``: one (n, members, steps+1, C, H, W) float32 array,
    lead 0 the physical initial condition of every member."""
    from swift_torch.data.synthetic import SyntheticERA5

    ds = SyntheticERA5(VARS, FORC, n_files=8, shape=(8, 16), seed=4)
    net = factory.build_precond(PRECOND, MODEL, ds.img_resolution, ds.n_target_channels,
                                ds.n_condition_channels, dtype=torch.float32).eval()
    args = generate.parser.parse_args(["--input", str(tmp_path), "--members", "2",
                                       "--steps", "3", "--batch", "2", "--samples", "3",
                                       "--segment", "2", "--dump", "numpy"])
    ofile, _, n_steps = generate.rollout_to_store(args, ds, net, str(tmp_path))
    out = np.load(ofile)
    assert n_steps == 3 * 2 * 3
    assert out.shape == (3, 2, 4, len(VARS), 8, 16) and out.dtype == np.float32
    ics = generate.select_indices(len(ds), 3, 3, 6)
    for k, i in enumerate(ics):
        ic = ds._load_file(ds.files[i], VARS)
        ic[..., VARS.index("sea_surface_temperature")] = 0.0  # zeroed at 6 h
        for m in range(2):
            np.testing.assert_allclose(out[k, m, 0], ic.transpose(2, 0, 1), rtol=1e-6, atol=1e-6)
    assert np.isfinite(out).all() and out[:, :, 1:].std() > 0


def test_generate_needs_cuda_unless_cpu_is_asked_for(run_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    argv = ["--input", str(run_dir[0]), "--steps", "1", "--samples", "1",
            "--output", str(tmp_path / "out")]
    assert generate.parser.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.cli(argv)
