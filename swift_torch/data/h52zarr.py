"""Ground-truth zarr builder: per-timestep fields -> WB2-layout truth store.

The port's own copy of ``swift_tpu/data/h52zarr.py`` (the reference's
h5 -> zarr converter, src/swift/data/h52zarr.py:85-112): it builds the
``--truth`` input of ``swift_torch.eval.metrics``, per-variable arrays
shaped (time, [level], latitude, longitude) of unstandardized fields, with
the port's zarr_lite writer and a thread pool over timesteps. It reads
through the dataset's ``_load_file``, so ``SyntheticERA5`` serves it
without h5py.

    python -m swift_torch.data.h52zarr --root <data> --split test \\
        --out truth.zarr --variables 2m_temperature geopotential_500 ...
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from swift_torch.data.constants import compress_variables
from swift_torch.data.era5 import ERA5Dataset
from swift_torch.utils import zarr_lite
from swift_torch.utils.log import log0


def build_truth_zarr(dataset, ofile: str, indices=None, time_chunk: int = 8,
                     workers: int = 8) -> str:
    """Write the fields of ``indices`` (default: every file) of a dataset with
    the ``ERA5Dataset`` interface; returns ``ofile``."""
    if indices is None:
        indices = list(range(len(dataset.files)))
    n = len(indices)
    lat, lon = dataset.get_lat_lon()
    n_lat, n_lon = len(lat), len(lon)

    time_coord = np.array([dataset.get_time(int(i)) for i in indices], dtype="datetime64[ns]")

    g = zarr_lite.open_group(ofile, mode="w")
    g.create_array("time", (n,), (n,), time_coord.dtype, fill_value=None,
                   dims=["time"], data=time_coord)
    g.create_array("latitude", (n_lat,), (n_lat,), lat.dtype, fill_value=None,
                   dims=["latitude"], data=lat)
    g.create_array("longitude", (n_lon,), (n_lon,), lon.dtype, fill_value=None,
                   dims=["longitude"], data=lon)

    compressed = compress_variables(dataset.variables)
    if any(len(lv) for lv in compressed.values()):
        level_sets = [lv for lv in compressed.values() if lv]
        if all(lv == level_sets[0] for lv in level_sets):
            levels = np.asarray(level_sets[0], np.int32)
        else:
            levels = np.arange(max(len(lv) for lv in level_sets), dtype=np.int32)
        g.create_array("level", (len(levels),), (len(levels),), "<i4",
                       fill_value=None, dims=["level"], data=levels)

    arrays = {}
    for var, levels in compressed.items():
        if levels:
            shape = (n, len(levels), n_lat, n_lon)
            chunks = (time_chunk, len(levels), n_lat, n_lon)
            dims = ["time", "level", "latitude", "longitude"]
        else:
            shape = (n, n_lat, n_lon)
            chunks = (time_chunk, n_lat, n_lon)
            dims = ["time", "latitude", "longitude"]
        attrs = {"levels": list(levels)} if levels else None
        # a rerun of the same layout overwrites every chunk, so a crashed
        # earlier run cannot leave old data among the new
        arrays[var] = g.create_array(var, shape, chunks, "<f4", fill_value=0.0, dims=dims,
                                     attrs=attrs, overwrite_chunks=True)

    def load(i):
        return dataset._load_file(dataset.files[int(i)], dataset.variables)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for t0 in range(0, n, time_chunk):
            block_idx = indices[t0:t0 + time_chunk]
            block = np.stack(list(pool.map(load, block_idx)), 0)  # (T, H, W, C)
            c0 = 0
            for var, levels in compressed.items():
                k = max(len(levels), 1)
                sel = block[..., c0:c0 + k]
                if levels:
                    arrays[var][t0:t0 + len(block_idx)] = sel.transpose(0, 3, 1, 2)
                else:
                    arrays[var][t0:t0 + len(block_idx)] = sel[..., 0]
                c0 += k
    g.consolidate_metadata()
    log0(f"truth zarr written: {ofile}")
    return ofile


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--out", required=True)
    p.add_argument("--variables", nargs="+", required=True)
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    ds = ERA5Dataset(root=args.root, variables=args.variables, split=args.split)
    return build_truth_zarr(ds, args.out, workers=args.workers)


if __name__ == "__main__":
    main()
