"""Pack a per-timestep split into one mmap-able file for the native loader:
a 4 KiB header (magic and int64 dims) followed by the raw float32
(N, H, W, C) tensor, channels ordered variables then forcings as the
training condition is. The format is the JAX package's: either package's
loader reads the other's files.

    python -m swift_torch.native.pack --root <h5 root> --split train \\
        --variables ... [--forcings ...] [--out FILE]

writes ``<root>/<split>.pack`` unless ``--out`` says otherwise;
``BatchLoader`` takes that file when it is there.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from swift_torch.native import HEADER_BYTES, MAGIC

_CHUNK = 64  # files read and written at a time


def pack_split(dataset, out_path: str) -> str:
    """Write every file of ``dataset`` (an ``ERA5Dataset``) to ``out_path``."""
    names = dataset.variables + dataset.forcings
    files = dataset.files
    H, W, C = dataset._load_file(files[0], names).shape
    header = MAGIC + np.asarray([len(files), H, W, C], np.int64).tobytes()
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header + b"\0" * (HEADER_BYTES - len(header)))
        for i in range(0, len(files), _CHUNK):
            block = np.stack([dataset._load_file(p, names) for p in files[i:i + _CHUNK]])
            f.write(np.ascontiguousarray(block, np.float32).tobytes())
    os.replace(tmp, out_path)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--variables", nargs="+", required=True)
    p.add_argument("--forcings", nargs="+", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from swift_torch.data.era5 import ERA5Dataset

    ds = ERA5Dataset(root=args.root, variables=args.variables, forcings=args.forcings,
                     split=args.split, residual=True)
    out = pack_split(ds, args.out or os.path.join(args.root, f"{args.split}.pack"))
    print(f"packed {len(ds.files)} timesteps -> {out}")
    return out


if __name__ == "__main__":
    main()
