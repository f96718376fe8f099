"""Window partition / reverse and cyclic shift, channels-last.

Counterpart of ``swift_tpu/ops/windows.py``: ``(B, H, W, C)`` activations,
the batch kept apart from the window axis, ``(B, H, W, C) -> (B, nW, n, C)``.
"""

from __future__ import annotations

import torch


def window_partition(x: torch.Tensor, window_size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, num_windows, wh*ww, C)."""
    B, H, W, C = x.shape
    wh, ww = window_size
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // wh) * (W // ww), wh * ww, C)


def window_reverse(
    windows: torch.Tensor, window_size: tuple[int, int], img_size: tuple[int, int]
) -> torch.Tensor:
    """(B, num_windows, wh*ww, C) -> (B, H, W, C)."""
    H, W = img_size
    wh, ww = window_size
    B, C = windows.shape[0], windows.shape[-1]
    x = windows.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def cyclic_shift(x: torch.Tensor, shift: tuple[int, int]) -> torch.Tensor:
    """Roll the two spatial dims of (B, H, W, C); positive values move
    content toward larger indices (``torch.roll``'s convention)."""
    sh, sw = shift
    if sh == 0 and sw == 0:
        return x
    return torch.roll(x, shifts=(sh, sw), dims=(1, 2))
