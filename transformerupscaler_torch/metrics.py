"""Image quality metrics: PSNR, SSIM and MSE on host arrays (JAX
counterpart: transformerupscaler_tpu/metrics.py; the port keeps its own
copy).

The reference scores with skimage's ``peak_signal_noise_ratio`` and
``structural_similarity(data_range=1, channel_axis=-1)``; skimage is not
a dependency, so both are written out here with skimage's defaults (SSIM:
a 7x7 uniform window, K1 = 0.01, K2 = 0.03, the unbiased covariance
normalization, the mean over channels of the mean over the window-cropped
map). Everything is computed in float64.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    err = np.mean((a - b) ** 2)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / err))


def _ssim_single(x: np.ndarray, y: np.ndarray, data_range: float,
                 win_size: int) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    n = win_size ** x.ndim
    cov_norm = n / (n - 1)  # unbiased, skimage's default

    def filt(im):
        return uniform_filter(im, size=win_size, mode="reflect")

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    # skimage crops the filter's border (pad = (win_size - 1) // 2) before
    # averaging.
    pad = (win_size - 1) // 2
    return float(s[tuple(slice(pad, d - pad) for d in s.shape)].mean())


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         channel_axis: int | None = -1, win_size: int = 7) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    if channel_axis is None:
        return _ssim_single(a, b, data_range, win_size)
    a = np.moveaxis(a, channel_axis, 0)
    b = np.moveaxis(b, channel_axis, 0)
    return float(np.mean([_ssim_single(a[c], b[c], data_range, win_size)
                          for c in range(a.shape[0])]))


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)) ** 2))
