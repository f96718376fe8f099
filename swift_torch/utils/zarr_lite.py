"""Minimal zarr-v2 store reader/writer (pure numpy + stdlib zlib); the
port's own copy of ``swift_tpu/utils/zarr_lite.py``.

The environment ships no ``zarr``/``xarray``, so the framework carries its
own implementation of the subset it needs: directory stores with
``.zgroup``/``.zarray``/``.zattrs``/``.zmetadata`` JSON, C-order chunks with
optional zlib compression, ``_ARRAY_DIMENSIONS`` attributes for xarray
compatibility, and basic (slice/int) region assignment with
read-modify-write on partial chunks.

Output stores match the reference WB2 forecast layout
(reference: src/swift/utils/io.py:161-231): per-variable arrays shaped
(time, number, prediction_timedelta, [level], latitude, longitude) and are
readable by ``xr.open_zarr`` wherever xarray is available.
"""

from __future__ import annotations

import json
import os
import zlib
from pathlib import Path
from typing import Any, Optional, Sequence, Union

import numpy as np

Selection = Union[int, slice, tuple]


def _atomic_write(path: Path, text: str) -> None:
    """Write-then-rename so concurrent readers never see a truncated file."""
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def _dtype_str(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype.kind in "Mm":
        # datetime64/timedelta64 with unit
        return dtype.str
    return dtype.str


class ZarrArray:
    def __init__(self, path: Path):
        self.path = Path(path)
        meta = json.loads((self.path / ".zarray").read_text())
        self.meta = meta
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        comp = meta.get("compressor")
        self.compressed = bool(comp) and comp.get("id") == "zlib"
        self.clevel = comp.get("level", 1) if self.compressed else 0

    # ---------------- attrs
    @property
    def attrs(self) -> dict:
        p = self.path / ".zattrs"
        return json.loads(p.read_text()) if p.exists() else {}

    # ---------------- chunk io
    def _chunk_path(self, idx: Sequence[int]) -> Path:
        return self.path / ".".join(str(i) for i in idx)

    def _read_chunk(self, idx: Sequence[int]) -> np.ndarray:
        p = self._chunk_path(idx)
        if not p.exists():
            fv = self.fill_value
            if fv is None:
                fv = 0
            return np.full(self.chunks, fv, self.dtype)
        raw = p.read_bytes()
        if self.compressed:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, self.dtype).reshape(self.chunks).copy()

    def _write_chunk(self, idx: Sequence[int], data: np.ndarray):
        raw = np.ascontiguousarray(data, self.dtype).tobytes()
        if self.compressed:
            raw = zlib.compress(raw, self.clevel)
        self._chunk_path(idx).write_bytes(raw)

    # ---------------- selection handling
    def _normalize(self, sel: Selection) -> tuple[tuple[int, int], ...]:
        if not isinstance(sel, tuple):
            sel = (sel,)
        out = []
        for d, s in enumerate(self.shape):
            if d < len(sel):
                item = sel[d]
            else:
                item = slice(None)
            if isinstance(item, (int, np.integer)):
                i = int(item) % s
                out.append((i, i + 1))
            elif isinstance(item, slice):
                start, stop, step = item.indices(s)
                assert step == 1, "only unit-step slices supported"
                out.append((start, stop))
            else:
                raise TypeError(f"unsupported index: {item!r}")
        return tuple(out)

    def __setitem__(self, sel: Selection, value):
        bounds = self._normalize(sel)
        region_shape = tuple(b - a for a, b in bounds)
        value = np.asarray(value, self.dtype)
        if value.shape != region_shape:
            n_region = int(np.prod(region_shape))
            if value.size == n_region:
                # same elements, possibly missing singleton dims (int-indexed
                # axes) — a plain reshape is exact.
                value = value.reshape(region_shape)
            else:
                value = np.broadcast_to(value, region_shape)

        ranges = [
            range(a // c, (b - 1) // c + 1) if b > a else range(0)
            for (a, b), c in zip(bounds, self.chunks)
        ]
        jobs = []
        for idx in np.ndindex(*[len(r) for r in ranges]):
            cidx = [ranges[d][i] for d, i in enumerate(idx)]
            c0 = [ci * c for ci, c in zip(cidx, self.chunks)]
            inter = [
                (max(a, o), min(b, o + c))
                for (a, b), o, c in zip(bounds, c0, self.chunks)
            ]
            if any(lo >= hi for lo, hi in inter):
                continue
            chunk_sel = tuple(
                slice(lo - o, hi - o) for (lo, hi), o in zip(inter, c0)
            )
            val_sel = tuple(
                slice(lo - a, hi - a) for (lo, hi), (a, b) in zip(inter, bounds)
            )
            full = all(
                (hi - lo) == c and lo == o
                for (lo, hi), o, c in zip(inter, c0, self.chunks)
            )
            jobs.append((tuple(cidx), chunk_sel, val_sel, full))

        def run(job):
            cidx, chunk_sel, val_sel, full = job
            if full:
                self._write_chunk(cidx, value[val_sel])
            else:
                chunk = self._read_chunk(cidx)
                chunk[chunk_sel] = value[val_sel]
                self._write_chunk(cidx, chunk)

        # zlib.compress/decompress and file IO release the GIL — fan the
        # per-chunk work over threads (chunks within one assignment are
        # disjoint by construction).
        if len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as ex:
                list(ex.map(run, jobs))
        else:
            for job in jobs:
                run(job)

    def __getitem__(self, sel: Selection) -> np.ndarray:
        bounds = self._normalize(sel)
        out_shape = tuple(b - a for a, b in bounds)
        out = np.empty(out_shape, self.dtype)
        ranges = [
            range(a // c, (b - 1) // c + 1) if b > a else range(0)
            for (a, b), c in zip(bounds, self.chunks)
        ]
        for idx in np.ndindex(*[len(r) for r in ranges]):
            cidx = [ranges[d][i] for d, i in enumerate(idx)]
            c0 = [ci * c for ci, c in zip(cidx, self.chunks)]
            inter = [
                (max(a, o), min(b, o + c))
                for (a, b), o, c in zip(bounds, c0, self.chunks)
            ]
            if any(lo >= hi for lo, hi in inter):
                continue
            chunk = self._read_chunk(cidx)
            chunk_sel = tuple(
                slice(lo - o, hi - o) for (lo, hi), o in zip(inter, c0)
            )
            out_sel = tuple(
                slice(lo - a, hi - a) for (lo, hi), (a, b) in zip(inter, bounds)
            )
            out[out_sel] = chunk[chunk_sel]
        # squeeze int-indexed axes like numpy would
        squeeze_axes = tuple(
            d
            for d, s in enumerate(
                sel if isinstance(sel, tuple) else (sel,)
            )
            if isinstance(s, (int, np.integer))
        )
        return out.squeeze(axis=squeeze_axes) if squeeze_axes else out

    def __array__(self, dtype=None):
        a = self[tuple(slice(None) for _ in self.shape)]
        return a.astype(dtype) if dtype else a




class ZarrGroup:
    def __init__(self, path: str | Path, mode: str = "a"):
        self.path = Path(path)
        if mode in ("w", "a"):
            self.path.mkdir(parents=True, exist_ok=True)
            zg = self.path / ".zgroup"
            if not zg.exists() or mode == "w":
                zg.write_text(json.dumps({"zarr_format": 2}, indent=4))

    def create_array(
        self,
        name: str,
        shape: Sequence[int],
        chunks: Sequence[int],
        dtype="f4",
        fill_value: Any = 0.0,
        dims: Optional[Sequence[str]] = None,
        attrs: Optional[dict] = None,
        compressor: Optional[str] = "zlib",
        clevel: int = 1,
        data: Optional[np.ndarray] = None,
        overwrite_chunks: bool = False,
    ) -> ZarrArray:
        """``overwrite_chunks=True`` clears existing chunk files even when
        the array layout is unchanged — pass it from a single-writer
        context (e.g. the process-0 + barrier store creation in
        generate.py) so a re-run into an existing store can't silently
        serve a previous run's data. The default keeps same-layout
        re-creation a no-op, which concurrent creators rely on."""
        adir = self.path / name
        dt = np.dtype(dtype)
        meta = {
            "zarr_format": 2,
            "shape": list(int(s) for s in shape),
            "chunks": list(int(c) for c in chunks),
            "dtype": _dtype_str(dt),
            "compressor": (
                {"id": "zlib", "level": clevel} if compressor == "zlib" else None
            ),
            "fill_value": fill_value if not isinstance(fill_value, float) or np.isfinite(fill_value) else None,
            "order": "C",
            "filters": None,
        }
        unchanged = False
        if adir.exists():
            # Idempotent re-creation: in a distributed generate run every
            # process calls create on the shared store. Only wipe when the
            # layout actually changed (stale chunk files from a previous
            # shape/chunking would silently bloat the store) or the caller
            # is a single writer asking for a clean slate; a matching
            # concurrent create must be a no-op, not an rmtree that races
            # another process's just-written chunks.
            try:
                unchanged = json.loads((adir / ".zarray").read_text()) == meta
            except (OSError, ValueError):
                unchanged = False
            if not unchanged or overwrite_chunks:
                import shutil

                shutil.rmtree(adir, ignore_errors=True)
                unchanged = False
        adir.mkdir(parents=True, exist_ok=True)
        a = dict(attrs or {})
        if dims is not None:
            a["_ARRAY_DIMENSIONS"] = list(dims)
        if not unchanged:
            # atomic metadata writes: a concurrent same-layout creator may
            # be reading .zarray while we write — rename is atomic, a
            # truncated read is not.
            _atomic_write(adir / ".zarray", json.dumps(meta, indent=4))
            if a:
                _atomic_write(adir / ".zattrs", json.dumps(a, indent=4))
        arr = ZarrArray(adir)
        if data is not None:
            arr[tuple(slice(None) for _ in shape)] = data
        return arr

    def __getitem__(self, name: str) -> ZarrArray:
        return ZarrArray(self.path / name)

    def __contains__(self, name: str) -> bool:
        return (self.path / name / ".zarray").exists()

    def array_names(self) -> list[str]:
        return sorted(
            p.parent.name for p in self.path.glob("*/.zarray")
        )

    def consolidate_metadata(self):
        """Write .zmetadata (zarr consolidated format 1)."""
        metadata = {".zgroup": json.loads((self.path / ".zgroup").read_text())}
        zattrs = self.path / ".zattrs"
        if zattrs.exists():
            metadata[".zattrs"] = json.loads(zattrs.read_text())
        for name in self.array_names():
            metadata[f"{name}/.zarray"] = json.loads(
                (self.path / name / ".zarray").read_text()
            )
            za = self.path / name / ".zattrs"
            if za.exists():
                metadata[f"{name}/.zattrs"] = json.loads(za.read_text())
        (self.path / ".zmetadata").write_text(
            json.dumps(
                {"metadata": metadata, "zarr_consolidated_format": 1}, indent=4
            )
        )


def open_group(path: str | Path, mode: str = "a") -> ZarrGroup:
    return ZarrGroup(path, mode)
