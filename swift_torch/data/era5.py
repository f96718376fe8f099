"""ERA5 per-timestep h5 dataset, numpy/channels-last.

The port's own copy of ``swift_tpu/data/era5.py`` (pure numpy; ``h5py`` is
imported where a file is read), so that ``swift_torch`` imports nothing of
the JAX package. Behavioral parity with the reference dataset
(src/swift/data/era5.py:12-257):

  * per-timestep ``.h5`` files under ``root/split/*.h5`` with an ``input/``
    group holding one (H, W) array per variable, NaNs filled with nanmin
    (reference :58-74);
  * standardization from ``normalize_mean/std.npz`` for states, per-interval
    ``normalize_diff_std_{6,12,24}.npz`` for residual targets (:88-108);
  * "pseudo-dynamic" channel slicing — stats subset by whether the tensor
    carries variables, forcings, or both (:110-133);
  * ``zero_field`` zeroes the SST channel except at Δ=24h (:135-148);
  * ``__getitem__`` accepts ``idx | (idx, offset) | (idx, offset, delta)``,
    residual target ``t − x_prev`` (:190-227), returning channels-LAST
    ``(H, W, C)`` arrays (TPU layout; the reference is channels-first).

This class is pure numpy. Batching and prefetch live in
``swift_torch.data.pipeline``.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Union

import numpy as np

Array = np.ndarray

_VALID_INTERVALS = (
    [6], [12], [24], [6, 12], [6, 24], [12, 24], [6, 12, 24],
)


class ERA5Dataset:
    def __init__(
        self,
        root: str,
        variables: list[str],
        forcings: Optional[list[str]] = None,
        intervals: Optional[list[int]] = None,
        split: str = "train",
        residual: bool = False,
        seed: int = 0,
    ):
        forcings = list(forcings or [])
        intervals = list(intervals or [6, 12, 24])
        assert sorted(intervals) in _VALID_INTERVALS, (
            "must be combination of [6, 12, 24]"
        )
        self.root = root
        self.split = split
        self.files = sorted(glob(os.path.join(root, split, "*.h5")))
        assert self.files, f"no .h5 files under {os.path.join(root, split)}"
        self.variables = list(variables)
        self.forcings = forcings
        self.intervals = intervals
        self.residual = residual
        self._rng = np.random.default_rng(seed)

        (self.x_means, self.x_stds, self.t_means, self.t_stds) = (
            self._setup_standardize()
        )
        self._shape = self._load_file(self.files[0], self.variables).shape  # (H, W, C)

    # ------------------------------------------------------------------ io
    def _load_file(self, path: str, variables: list[str]) -> Array:
        import h5py

        with h5py.File(path, "r") as f:
            grp = f["input"]
            fields = []
            for v in variables:
                a = np.asarray(grp[v][()], dtype=np.float32)
                if np.isnan(a).any():
                    np.copyto(a, np.nanmin(a), where=np.isnan(a))
                fields.append(a)
        return np.stack(fields, axis=-1)  # (H, W, C) channels-last

    def _load_and_stack(self, filename: str, variables: list[str]) -> Array:
        with np.load(os.path.join(self.root, filename)) as data:
            return np.stack(
                [np.asarray(data[v], np.float32).reshape(()) for v in variables],
                axis=0,
            ).reshape(1, 1, -1)  # broadcast over (H, W, C)

    # -------------------------------------------------------- standardize
    def _setup_standardize(self):
        x_means = self._load_and_stack("normalize_mean.npz", self.variables + self.forcings)
        x_stds = self._load_and_stack("normalize_std.npz", self.variables + self.forcings)
        if self.residual:
            t_stds = {
                i: self._load_and_stack(f"normalize_diff_std_{i}.npz", self.variables)
                for i in self.intervals
            }
            t_means = {i: np.zeros_like(t_stds[i]) for i in self.intervals}
        else:
            if len(self.intervals) > 1 and self.intervals[0] != 6:
                raise ValueError(
                    "Only 6h intervals are supported for standardization at the moment."
                )
            t_means, t_stds = x_means, x_stds
        return x_means, x_stds, t_means, t_stds

    def _slice_stats(self, v, m: Array, s: Array):
        """Pseudo-dynamic stat slicing by channel count (reference :122-128)."""
        channels = v.shape[-1]
        nv, nf = len(self.variables), len(self.forcings)
        if channels == nv:
            return m[..., :nv], s[..., :nv]
        if channels == nf:
            return m[..., nv:], s[..., nv:]
        return m, s

    def _transform(self, v, means: Array, stds: Array, inverse: bool = False):
        m, s = self._slice_stats(v, means, stds)
        if inverse:
            return v * s + m
        return (v - m) / s

    def zero_field(self, x, delta: int = 6):
        """Zero the SST channel except for Δ=24h (reference :135-148)."""
        channels = x.shape[-1]
        if (
            delta == 24
            or "sea_surface_temperature" not in self.variables
            or channels == len(self.forcings)
        ):
            return x
        idx = self.variables.index("sea_surface_temperature")
        x = np.array(x, copy=True)
        x[..., idx] = 0
        return x

    def standardize_x(self, x, delta: int = 6):
        return self.zero_field(self._transform(x, self.x_means, self.x_stds), delta)

    def unstandardize_x(self, x, delta: int = 6):
        return self.zero_field(
            self._transform(x, self.x_means, self.x_stds, inverse=True), delta
        )

    def standardize_t(self, t, delta: int = 6):
        return self.zero_field(
            self._transform(t, self.t_means[delta], self.t_stds[delta]), delta
        )

    def unstandardize_t(self, t, delta: int = 6):
        return self.zero_field(
            self._transform(t, self.t_means[delta], self.t_stds[delta], inverse=True),
            delta,
        )

    # -------------------------------------------------------------- meta
    @property
    def n_target_channels(self) -> int:
        return self._shape[-1]

    @property
    def n_condition_channels(self) -> int:
        return self.n_target_channels + len(self.forcings)

    @property
    def img_resolution(self) -> tuple[int, int]:
        return self._shape[0], self._shape[1]

    def get_lat_lon(self) -> tuple[Array, Array]:
        lat = np.load(os.path.join(self.root, "lat.npy")).astype(np.float32)
        lon = np.load(os.path.join(self.root, "lon.npy")).astype(np.float32)
        return lat, lon

    def get_time(self, idx: int) -> np.datetime64:
        import h5py

        with h5py.File(self.files[idx], "r") as f:
            ts = f["input"]["time"][()]
            if isinstance(ts, bytes):
                ts = ts.decode("utf-8")
            return np.datetime64(ts)

    def get_forcings(self, idx: int) -> Array:
        return self._load_file(self.files[idx], self.forcings)

    # ------------------------------------------------------------ access
    def __len__(self) -> int:
        return len(self.files[: -(max(self.intervals) * 1 // 6)])

    def __getitem__(self, spec: Union[int, tuple]):
        if isinstance(spec, tuple):
            spec = tuple(int(i) for i in spec)
            if len(spec) == 2:
                idx, offset, delta = spec[0], spec[1], None
            elif len(spec) == 3:
                idx, offset, delta = spec
            else:
                raise ValueError(f"Invalid index spec: {spec!r}")
        else:
            idx, offset, delta = int(spec), 1, None

        if delta is None:
            delta = int(self._rng.choice(self.intervals))

        x = self._load_file(self.files[idx], self.variables + self.forcings)
        t = self._load_file(self.files[idx + (offset * delta // 6)], self.variables)

        if self.residual:
            x_prev = (
                self._load_file(
                    self.files[idx + (offset - 1) * delta // 6], self.variables
                )
                if offset > 1
                else x[..., : len(self.variables)]
            )
            t = t - x_prev

        x = self.standardize_x(x, delta).astype(np.float32)  # (H, W, C+F)
        t = self.standardize_t(t, delta).astype(np.float32)  # (H, W, C)
        return (x, t), (idx, np.float32(delta / 10.0))



class ERA5RollOutDataset(ERA5Dataset):
    """Validation rollout dataset: the standardized initial condition (H, W,
    C), the unstandardized targets at the 6 h lead and at each day's end
    (days + 1, H, W, C), and the index."""

    def __init__(self, interval: int, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.interval = interval

    def __len__(self) -> int:
        return len(self.files[: -self.interval])

    def __getitem__(self, idx: int):
        idx = int(idx)
        x = self.standardize_x(self._load_file(self.files[idx], self.variables)).astype(np.float32)
        num_interval_per_day = 4
        assert self.interval >= num_interval_per_day, "cannot even predict one day"
        strt = idx + num_interval_per_day
        t_lst = [self._load_file(self.files[idx + 1], self.variables)]  # the 6 h lead
        for i in range(strt, strt + self.interval, num_interval_per_day):
            t_lst.append(self._load_file(self.files[i], self.variables))
        t = np.stack(t_lst, axis=0).astype(np.float32)
        return x, t, idx
