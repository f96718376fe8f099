"""In-memory synthetic ERA5 dataset with the ``ERA5Dataset`` interface.

Where h5py is absent (or a run should not touch the disk), this stands in
for ``swift_tpu.data.synthetic.make_synthetic_era5`` + ``ERA5Dataset``:
the same per-variable offsets (crc32 of the name mod 7) over standard
normal fields, unit state stds and residual stds of √2, made from a seed
and held in memory: a residual dataset over the 6/12/24 h intervals, one
file every 6 h from 2000-01-01. ``files`` are time indices; the
standardisation, SST zeroing and channel slicing are ``ERA5Dataset``'s own.
``SyntheticERA5RollOut`` is its ``ERA5RollOutDataset`` form (the
validation rollout's items), for online validation without h5py.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np

from swift_torch.data.era5 import ERA5Dataset, ERA5RollOutDataset


class SyntheticERA5(ERA5Dataset):
    def __init__(
        self,
        variables: Sequence[str],
        forcings: Sequence[str] = (),
        n_files: int = 8,
        shape: tuple[int, int] = (8, 16),
        seed: int = 0,
    ):
        # ERA5Dataset.__init__ globs h5 files; set its attributes directly.
        self.root, self.split = None, "test"
        self.variables, self.forcings = list(variables), list(forcings)
        self.intervals, self.residual = [6, 12, 24], True
        self.files = list(range(n_files))
        self._rng = np.random.default_rng(seed)
        H, W = shape
        names = self.variables + self.forcings
        self._channel = {v: i for i, v in enumerate(names)}
        base = np.array([zlib.crc32(v.encode()) % 7 for v in names], np.float32)
        fields = np.random.default_rng(seed).standard_normal(
            (n_files, H, W, len(names)), dtype=np.float32)
        self._fields = fields + base
        self.x_means = base.reshape(1, 1, -1)
        self.x_stds = np.ones_like(self.x_means)
        nv = len(self.variables)
        self.t_stds = {i: np.full((1, 1, nv), np.sqrt(2.0), np.float32) for i in self.intervals}
        self.t_means = {i: np.zeros((1, 1, nv), np.float32) for i in self.intervals}
        self._shape = (H, W, nv)
        self._t0 = np.datetime64("2000-01-01T00:00")

    def _load_file(self, path: int, variables: list[str]) -> np.ndarray:
        return self._fields[path][..., [self._channel[v] for v in variables]]

    def get_lat_lon(self) -> tuple[np.ndarray, np.ndarray]:
        H, W = self._shape[:2]
        return (np.linspace(-90, 90, H).astype(np.float32),
                np.linspace(0, 360, W, endpoint=False).astype(np.float32))

    def get_time(self, idx: int) -> np.datetime64:
        return self._t0 + np.timedelta64(6 * int(idx), "h")


class SyntheticERA5RollOut(SyntheticERA5, ERA5RollOutDataset):
    """The same fields as rollout items: ``ERA5RollOutDataset.__len__`` and
    ``__getitem__`` over ``target_interval`` 6 h steps."""

    def __init__(self, interval: int, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.interval = interval
