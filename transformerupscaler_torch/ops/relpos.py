"""Relative position bias for window attention.

JAX counterpart: transformerupscaler_tpu ops/relpos.py:20-50. A learned table
((2*ws-1)^2, heads) indexed by the static (ws^2, ws^2) map of pairwise
offsets; here the lookup is a plain gather.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """(ws^2, ws^2) int64 map of pairwise relative-offset table indices."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int64)


def gather_relative_bias(table: torch.Tensor, window_size: int) -> torch.Tensor:
    """table ((2*ws-1)^2, heads) -> bias (heads, ws^2, ws^2)."""
    n = window_size * window_size
    bias = table[_index_on(window_size, table.device)]
    return bias.reshape(n, n, -1).permute(2, 0, 1)


@lru_cache(maxsize=8)
def _index_on(window_size: int, device: torch.device) -> torch.Tensor:
    """The flattened index map on ``device``, copied there once, outside
    inference mode: a train-mode forward saves it for backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            relative_position_index(window_size)).reshape(-1).to(device)
