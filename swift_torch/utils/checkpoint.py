"""Checkpoints in the JAX package's format: ``checkpoint-{kimg:06d}.npz``.

A JAX checkpoint is one npz of its flattened state tree, ``/``-joined keys
under ``params/``, ``ema/`` and (from training) ``opt_state/``. The port
reads the EMA weights (either transformer layout) into its state dict, and
writes a network's weights as ``ema/...`` in the stacked ``pairs`` layout
the JAX model uses by default, so ``swift_tpu``'s loader takes the file too.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Mapping, Optional

import numpy as np
import torch

from swift_torch.models.convert import flatten, nest, params_to_state_dict, state_dict_to_params


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor], depth: int) -> None:
    """Write ``state_dict`` (the precond's, ``model.``-prefixed) as ``ema/...``
    entries of a JAX-layout npz, atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    params = state_dict_to_params(state_dict, depth, scan_layers=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten({"ema": params}))
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read the ``ema/...`` weights of a JAX-layout npz as a ``model.``-
    prefixed fp32 state dict."""
    prefix = "ema/"
    with np.load(path) as data:
        flat = {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}
    if not flat:
        raise KeyError(f"{path} holds no '{prefix}' weights")
    sd = params_to_state_dict(nest(flat))
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def get_ckpt_num(path: str) -> int:
    """kimg from ``checkpoint-{kimg}.{ext}``."""
    m = re.search(r"checkpoint-(\d+)", os.path.basename(path))
    if not m:
        raise ValueError(f"cannot parse checkpoint number from {path}")
    return int(m.group(1))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    paths = glob(os.path.join(ckpt_dir, "checkpoint-*.npz"))
    return max(paths, key=get_ckpt_num) if paths else None
