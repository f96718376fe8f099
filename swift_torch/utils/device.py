"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """CUDA unless the caller asked for the CPU; raises where CUDA was asked
    for and is absent (the port never falls back to the CPU by itself)."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (pass --device cpu "
                           "to run on the CPU)")
    return torch.device(name)
