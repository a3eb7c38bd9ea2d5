"""Window partition and reverse (JAX counterpart: transformerupscaler_tpu
ops/windows.py): (B, H, W, C) <-> (B, nWindows, ws*ws, C)."""

from __future__ import annotations

import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nH*nW, ws*ws, C); H and W must divide."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // ws) * (w // ws), ws * ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int,
                   w: int) -> torch.Tensor:
    """(B, nWindows, ws*ws, C) -> (B, H, W, C)."""
    b, c = windows.shape[0], windows.shape[-1]
    ws = window_size
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)
