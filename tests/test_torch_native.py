"""The port's packed-data route against the JAX package's, on the CPU.

* ``swift_torch/native`` builds ``loader.cpp`` with g++ into its git-ignored
  ``_build/``, and a build that g++ refuses raises; ``pack_split`` writes
  the JAX package's file byte for byte.
* ``BatchLoader._pack_batch`` (one native call for each distinct Δ,
  scattered back in order) equals the JAX package's bit for bit, for a
  batch of mixed Δ and of one Δ, and the loader's whole stream over the
  pack equals the JAX loader's over it; the packed batches equal the
  per-file ones within 1e-6 (the same arithmetic in C++ and numpy).
* Multistep batches are read file by file, as in the JAX package.
* ``swift_torch.native`` and its packing, and the modules of the fine-tune
  and distill flows (``train``, the samplers and loader, the multistep
  losses, MARS), load no module of jax, flax, optax or swift_tpu (checked
  in a subprocess).
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from swift_torch.data.era5 import ERA5Dataset
from swift_torch.data.pipeline import BatchLoader
from swift_torch.data.samplers import DeltaBatchSampler, InfiniteSampler
from swift_torch.native import PackedDataset, _LIB_PATH, _get_lib
from swift_torch.native.pack import pack_split
from swift_tpu.data.era5 import ERA5Dataset as JaxERA5Dataset
from swift_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from swift_tpu.data.samplers import InfiniteSampler as JaxInfiniteSampler
from swift_tpu.data.synthetic import make_synthetic_era5
from swift_tpu.native.pack import pack_split as jax_pack_split

VARS = ["2m_temperature", "sea_surface_temperature", "geopotential_500", "temperature_850"]
FORCINGS = ["land_sea_mask"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = make_synthetic_era5(str(tmp_path_factory.mktemp("pack") / "data"), VARS, FORCINGS,
                               n_train=14, n_val=1, n_test=1)
    kw = dict(variables=VARS, forcings=FORCINGS, residual=True, seed=3)
    ds = ERA5Dataset(root, **kw)
    pack_split(ds, os.path.join(root, "train.pack"))
    return root, kw


def test_native_builds_into_an_ignored_directory():
    assert _get_lib() is not None, "g++ build of swift_torch/native/loader.cpp failed"
    rel = os.path.relpath(_LIB_PATH, ROOT)
    assert rel.startswith(os.path.join("swift_torch", "native", "_build"))
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "swift_torch/native/_build/" in f.read().split(), f"{rel} is not git-ignored"


def test_pack_file_equals_jax(packed, tmp_path):
    root, kw = packed
    jax_pack_split(JaxERA5Dataset(root, **kw), str(tmp_path / "jax.pack"))
    with open(os.path.join(root, "train.pack"), "rb") as a, open(tmp_path / "jax.pack", "rb") as b:
        assert a.read() == b.read()
    pd = PackedDataset(os.path.join(root, "train.pack"))
    assert pd.shape == (14, 8, 16, len(VARS) + len(FORCINGS))
    ds = ERA5Dataset(root, **kw)
    with pytest.raises(IndexError):
        pd.batch(np.array([0, 13]), np.array([1, 14]), np.array([0, 13]), ds.x_means,
                 ds.x_stds, ds.t_stds[6], len(VARS))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A build that g++ refuses raises with the compiler's error; nothing
    reads the pack another way."""
    import swift_torch.native as native

    (tmp_path / "loader.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "_build" / "libswift_loader.so")
    with pytest.raises(RuntimeError, match="native loader build failed") as err:
        native._build_lib()
    assert "error" in str(err.value)


@pytest.mark.parametrize("deltas", [(6, 24, 12, 6, 24), (12,) * 5], ids=["mixed", "uniform"])
def test_pack_batch_matches_jax(packed, deltas):
    root, kw = packed
    ds, jds = ERA5Dataset(root, **kw), JaxERA5Dataset(root, **kw)
    loader = BatchLoader(ds, InfiniteSampler(ds), 5)
    jloader = JaxBatchLoader(jds, JaxInfiniteSampler(jds), 5)
    assert loader._pack is not None and jloader._pack is not None
    specs = [(i, 1, d) for i, d in zip((0, 3, 7, 2, 9), deltas)]
    got, want = loader._pack_batch(specs), jloader._pack_batch(specs)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the per-file route computes the same standardized residuals
    files = BatchLoader(ds, InfiniteSampler(ds), 5, use_pack=False)._build_batch(specs, _Serial())
    for k in ("x", "t"):
        np.testing.assert_allclose(got[k], files[k], rtol=1e-6, atol=1e-6, err_msg=k)


class _Serial:
    def map(self, fn, items):
        return map(fn, items)


def test_packed_stream_matches_jax(packed):
    """Mixed-Δ single-step batches (Δ drawn by the dataset's RNG in the
    producer) through both loaders over the same pack."""
    root, kw = packed
    ds, jds = ERA5Dataset(root, **kw), JaxERA5Dataset(root, **kw)
    got = iter(BatchLoader(ds, InfiniteSampler(ds, seed=5), 4, num_workers=2))
    want = iter(JaxBatchLoader(jds, JaxInfiniteSampler(jds, seed=5), 4, num_workers=2))
    for _ in range(4):
        g, w = next(got), next(want)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    got.close()


def test_multistep_batches_are_read_file_by_file(packed, caplog):
    root, kw = packed
    ds = ERA5Dataset(root, **kw)
    sampler = InfiniteSampler(ds, seed=5)
    with caplog.at_level(logging.INFO, logger="swift_torch"):
        loader = BatchLoader(ds, sampler, 2, multistep_forcings=2,
                             batch_sampler=DeltaBatchSampler(sampler, 2, ds.intervals, seed=1))
    assert any("multistep batches file by file" in r.getMessage() for r in caplog.records)
    loader._pack = _Refuse()
    sampler.set_offset(2)
    it = iter(loader)
    batch = next(it)
    it.close()
    assert batch["forcings_seq"].shape == (2, 2, 8, 16, 1)


class _Refuse:
    def batch(self, *a, **k):
        raise AssertionError("a multistep batch went to the pack")


def test_native_imports_no_jax(tmp_path):
    code = f"""
import sys
from swift_torch import train
from swift_torch.data.pipeline import BatchLoader
from swift_torch.data.samplers import DeltaBatchSampler
from swift_torch.training.loss import CRPSLoss, MSELoss
from swift_torch.training.optimizers.mars import MARS
from swift_torch.data.synthetic import SyntheticERA5
from swift_torch.native import PackedDataset
from swift_torch.native.pack import pack_split
ds = SyntheticERA5({VARS!r}, {FORCINGS!r}, n_files=6)
pd = PackedDataset(pack_split(ds, {str(tmp_path / "s.pack")!r}))
x, t = pd.batch([0, 1], [1, 2], [0, 1], ds.x_means, ds.x_stds, ds.t_stds[6], {len(VARS)})
assert x.shape == (2, 8, 16, {len(VARS) + len(FORCINGS)})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "swift_tpu"))
assert not bad, bad
print("no-jax-ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "no-jax-ok" in res.stdout, res.stderr[-2000:]
