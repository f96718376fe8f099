"""Checkpoints in the JAX package's format: ``checkpoint-{kimg:06d}.npz``.

A JAX checkpoint is one npz of its flattened state tree, ``/``-joined keys
under ``params/``, ``ema/`` and (from training) ``opt_state/``. The port
writes ``ema/`` (and, from its trainer, ``params/``) in the stacked
``pairs`` layout the JAX model uses by default, through the converter in
``swift_torch.models.convert``, so ``swift_tpu.utils.checkpoint.
load_checkpoint`` takes the file with a ``{"params", "ema"}`` template and
``swift_torch.generate`` runs its EMA. The optimizer state goes under
``opt_state/`` in the port's own layout, ``opt_state/<parameter name>/
<AdamW state key>``: interchange of ``opt_state`` with optax is out of
scope, and the JAX loader ignores those keys.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Mapping, Optional

import numpy as np
import torch

from swift_torch.models.convert import flatten, nest, params_to_state_dict, state_dict_to_params

_OPT = "opt_state/"


def save_checkpoint(path: str, ema: Mapping[str, torch.Tensor], depth: int,
                    params: Optional[Mapping[str, torch.Tensor]] = None,
                    opt_state: Optional[Mapping[str, np.ndarray]] = None) -> None:
    """Write ``ema`` (a ``model.``-prefixed state dict of the precond) as
    ``ema/...`` entries of a JAX-layout npz, atomically; ``params`` as
    ``params/...`` and ``opt_state`` (flat arrays) under ``opt_state/``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = {"ema": state_dict_to_params(ema, depth, scan_layers=True)}
    if params is not None:
        tree["params"] = state_dict_to_params(params, depth, scan_layers=True)
    flat = flatten(tree)
    for k, v in (opt_state or {}).items():
        flat[_OPT + k] = v
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _state_dict(flat: Mapping[str, np.ndarray], prefix: str) -> dict[str, torch.Tensor]:
    sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if not sub:
        raise KeyError(f"checkpoint holds no '{prefix}' weights")
    return {k: torch.from_numpy(v) for k, v in params_to_state_dict(nest(sub)).items()}


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read the ``ema/...`` weights of a JAX-layout npz as a ``model.``-
    prefixed fp32 state dict."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k.startswith("ema/")}
    return _state_dict(flat, "ema/")


def load_training_state(path: str):
    """(params, ema, opt_state) of a checkpoint the port's trainer wrote:
    two state dicts and the flat optimizer arrays ({} when absent)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    opt = {k[len(_OPT):]: v for k, v in flat.items() if k.startswith(_OPT)}
    return _state_dict(flat, "params/"), _state_dict(flat, "ema/"), opt


def get_ckpt_num(path: str) -> int:
    """kimg from ``checkpoint-{kimg}.{ext}``."""
    m = re.search(r"checkpoint-(\d+)", os.path.basename(path))
    if not m:
        raise ValueError(f"cannot parse checkpoint number from {path}")
    return int(m.group(1))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    paths = glob(os.path.join(ckpt_dir, "checkpoint-*.npz"))
    return max(paths, key=get_ckpt_num) if paths else None
