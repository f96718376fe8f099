"""Logging helpers: ``log0`` logs from rank 0 only (torch.distributed's rank
when a process group is up, else always)."""

from __future__ import annotations

import logging
import sys

import torch.distributed as dist

_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] %(message)s"


def get_logger(name: str = "swift_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    root = logging.getLogger("swift_torch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT, "%Y-%m-%d %H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logger


def is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def log0(msg, *args, logger: logging.Logger | None = None):
    if is_main_process():
        (logger or get_logger()).info(msg, *args)
