"""Forecast output stores (reference: src/swift/utils/io.py:85-259).

The port's own copy of the store writers of ``swift_tpu/utils/io.py`` that
``swift_torch.generate`` uses, built on the port's ``zarr_lite``.
"""

from __future__ import annotations

import numpy as np

from swift_torch.data.constants import compress_variables
from swift_torch.utils import zarr_lite


def create_forecast_zarr(
    ofile: str,
    dataset,
    members: int,
    steps: int,
    interval: int = 6,
    batch: int = 1,
    indices=None,
):
    """WB2-layout forecast store: per-variable arrays shaped
    (time, number, prediction_timedelta, [level], latitude, longitude), one
    chunk per (IC batch, member, lead)."""
    n = len(dataset)
    if indices is None:
        indices = np.arange(n, dtype=int)
    else:
        assert len(indices) == n

    lat, lon = dataset.get_lat_lon()
    n_lat, n_lon = len(lat), len(lon)
    time_coord = np.array(
        [dataset.get_time(int(i)) for i in indices], dtype="datetime64[ns]"
    )
    pred_td = (np.arange(steps + 1) * np.timedelta64(interval, "h")).astype(
        "timedelta64[ns]"
    )

    g = zarr_lite.open_group(ofile, mode="w")
    g.create_array("time", (n,), (n,), time_coord.dtype, fill_value=None,
                   dims=["time"], data=time_coord,
                   attrs={"calendar": "proleptic_gregorian",
                          "units": "nanoseconds since 1970-01-01"})
    g.create_array("prediction_timedelta", (steps + 1,), (steps + 1,),
                   pred_td.dtype, fill_value=None,
                   dims=["prediction_timedelta"], data=pred_td)
    g.create_array("latitude", (n_lat,), (n_lat,), lat.dtype, fill_value=None,
                   dims=["latitude"], data=lat)
    g.create_array("longitude", (n_lon,), (n_lon,), lon.dtype, fill_value=None,
                   dims=["longitude"], data=lon)
    g.create_array("number", (members,), (members,), "<i4", fill_value=None,
                   dims=["number"], data=np.arange(members, dtype=np.int32))

    compressed = compress_variables(dataset.variables)
    if any(len(lv) for lv in compressed.values()):
        level_sets = [lv for lv in compressed.values() if lv]
        # real pressure values when all multi-level vars share them
        if all(lv == level_sets[0] for lv in level_sets):
            levels = np.asarray(level_sets[0], np.int32)
        else:
            levels = np.arange(max(len(lv) for lv in level_sets), dtype=np.int32)
        g.create_array("level", (len(levels),), (len(levels),), "<i4",
                       fill_value=None, dims=["level"], data=levels)

    for var, levels in compressed.items():
        has_levels = bool(levels)
        shape = (
            (n, members, steps + 1, n_lat, n_lon)
            if not has_levels
            else (n, members, steps + 1, len(levels), n_lat, n_lon)
        )
        # one chunk per (ic-batch, member, lead): segment writes are whole chunks
        chunks = (
            (batch, 1, 1, n_lat, n_lon)
            if not has_levels
            else (batch, 1, 1, len(levels), n_lat, n_lon)
        )
        dims = (
            ["time", "number", "prediction_timedelta", "latitude", "longitude"]
            if not has_levels
            else [
                "time", "number", "prediction_timedelta", "level",
                "latitude", "longitude",
            ]
        )
        attrs = {"levels": list(levels)} if has_levels else None
        g.create_array(var, shape, chunks, "<f4", fill_value=0.0, dims=dims,
                       attrs=attrs, overwrite_chunks=True)
    return g


def create_empty_numpy(ofile: str, dataset, members: int, steps: int):
    """(samples, members, steps+1, channels, H, W) float32 memmap
    (reference io.py:237-259)."""
    return np.lib.format.open_memmap(
        ofile,
        dtype=np.float32,
        mode="w+",
        shape=(
            len(dataset),
            members,
            steps + 1,
            dataset.n_target_channels,
            *dataset.img_resolution,
        ),
    )
