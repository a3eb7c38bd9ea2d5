"""Sub-pixel (depth-to-space) shuffle on NHWC tensors, and the commutation of
a conv through it.

Same semantics as ``torch.nn.PixelShuffle(r)`` moved to NHWC: input
(B, H, W, C*r*r) with channels ordered (c, i, j) maps to
out[b, h*r+i, w*r+j, c] (JAX counterpart: transformerupscaler_tpu
ops/pixel_shuffle.py:18,61).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


@lru_cache(maxsize=None)
def _commute_maps(r: int, k: int = 3):
    """Index maps for commuting a k x k (odd) conv through pixel_shuffle(r).

    For high-res offset (dm, dn) and output phase (a, b), the low-res
    equivalent reads input phase (p, q) at low-res offset (di, dj) where
    dm = di*r + p - a (same for dn); exactly one (dm, dn) feeds each
    combination, or none. The base-resolution kernel spans
    di in [-pad_lo, pad_lo] with pad_lo = ceil((pad + r - 1) / r).
    """
    pad = (k - 1) // 2
    pad_lo = (pad + r - 1) // r
    klo = 2 * pad_lo + 1
    rr = r * r
    dm_idx = np.zeros((klo, klo, rr, rr), np.int64)
    dn_idx = np.zeros((klo, klo, rr, rr), np.int64)
    mask = np.zeros((klo, klo, rr, rr), bool)
    for di in range(-pad_lo, pad_lo + 1):
        for dj in range(-pad_lo, pad_lo + 1):
            for p in range(r):
                for q in range(r):
                    for a in range(r):
                        for b in range(r):
                            dm = di * r + p - a
                            dn = dj * r + q - b
                            if -pad <= dm <= pad and -pad <= dn <= pad:
                                ij = (di + pad_lo, dj + pad_lo,
                                      p * r + q, a * r + b)
                                dm_idx[ij] = dm + pad
                                dn_idx[ij] = dn + pad
                                mask[ij] = True
    return dm_idx, dn_idx, mask


@lru_cache(maxsize=None)
def _commute_maps_on(r: int, k: int, device: torch.device):
    """``_commute_maps`` as tensors on ``device``, copied there once: the
    exact path composes tails on every forward, and a CUDA graph cannot
    capture a copy from pageable host memory."""
    return tuple(torch.from_numpy(a).to(device) for a in _commute_maps(r, k))


def commute_conv_through_shuffle(kernel: torch.Tensor, r: int) -> torch.Tensor:
    """Repack an odd k x k HWIO kernel meant for ``conv(pixel_shuffle_r(x))``
    into the equivalent kernel for ``pixel_shuffle_r(conv'(x))``.

    (k, k, C, O) at r-fold resolution -> (k', k', C*r*r, O*r*r) at base
    resolution, k' = 2*ceil(((k-1)/2 + r - 1)/r) + 1. Exact, including the
    zero padding at the border. Channel orders match ``pixel_shuffle``:
    input (c, p, q), output (o, a, b).
    """
    dm_idx, dn_idx, mask = _commute_maps_on(r, int(kernel.shape[0]),
                                            kernel.device)
    klo = dm_idx.shape[0]
    c, o = kernel.shape[2], kernel.shape[3]
    g = kernel[dm_idx, dn_idx]
    g = g.masked_fill(~mask[..., None, None], 0)
    g = g.permute(0, 1, 4, 2, 5, 3)  # (k', k', C, pq, O, ab)
    return g.reshape(klo, klo, c * r * r, o * r * r)
