"""The device an entry point of the port runs on."""

from __future__ import annotations

import os

import torch

from swift_torch.parallel.mesh import local_rank, local_world_size


def resolve_device(name: str) -> torch.device:
    """CUDA unless the caller asked for the CPU; raises where CUDA was asked
    for and is absent (the port never falls back to the CPU by itself).

    Launched as several processes a host, ``"cuda"`` is the local rank's
    card, ``cuda:{LOCAL_RANK}``, made the current device; more ranks than
    cards raise unless the launcher set ``SWIFT_SHARE_DEVICE=1``, which
    puts local rank i on card i modulo the count."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (pass --device cpu "
                           "to run on the CPU)")
    if name != "cuda" or local_world_size() == 1:
        return torch.device(name)
    cards = torch.cuda.device_count()
    if local_world_size() > cards and not os.environ.get("SWIFT_SHARE_DEVICE"):
        raise RuntimeError(f"{local_world_size()} ranks on this host and {cards} CUDA "
                           "devices: launch one rank a card, or set SWIFT_SHARE_DEVICE=1 "
                           "(with SWIFT_DIST_BACKEND=gloo) to share them")
    device = torch.device("cuda", local_rank() % cards)
    torch.cuda.set_device(device)
    return device
