"""GPTQ-style error-compensated int8 weight quantization (offline, CPU).

The port's own copy of transformerupscaler_tpu/ops/gptq.py, plain numpy
and the same function bit for bit: ``UpscalerEngine.gptq_int8`` runs it
once at setup on activations computed on the CPU, and the serving path
consumes the result as pre-quantized (int8 kernel, per-output-channel
scale, bias) entries, ``FastTransformer.int8_weights``, through the int8
conv kernels.

GPTQ [Frantar et al. 2022, arXiv:2210.17323] quantizes weight rows (input
dims) sequentially and redistributes each row's rounding error onto the
rows not yet quantized through the inverse Hessian of the layer inputs
(H = X^T X from calibration activations): the same scales, the same int8
format, a lower output error than plain rounding.

Bias correction: after quantization the residual weight error W - Q*s is
systematic; absorbing its response to the mean calibration input into the
conv bias (b += mean(X) @ (W - Q*s)) removes the DC component of the
quantization error.
"""

from __future__ import annotations

import numpy as np


def im2col_patches(feat: np.ndarray, kh: int, kw: int,
                   n_samples: int = 32768, seed: int = 0) -> np.ndarray:
    """Sample im2col rows from NHWC feature maps.

    feat: (B, H, W, C) float; returns (n, kh*kw*C) rows drawn at uniform
    random interior positions (zero-pad border positions contribute little
    and complicate indexing).
    """
    b, h, w, c = feat.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    rng = np.random.default_rng(seed)
    n = min(n_samples, b * (h - 2 * ph) * (w - 2 * pw))
    bi = rng.integers(0, b, n)
    yi = rng.integers(ph, h - ph, n)
    xi = rng.integers(pw, w - pw, n)
    rows = np.empty((n, kh * kw * c), feat.dtype)
    for dy in range(kh):
        for dx in range(kw):
            sl = feat[bi, yi + dy - ph, xi + dx - pw, :]
            rows[:, (dy * kw + dx) * c:(dy * kw + dx + 1) * c] = sl
    return rows


def gptq_quantize(w: np.ndarray, hess: np.ndarray,
                  damp: float = 0.01) -> tuple[np.ndarray, np.ndarray]:
    """GPTQ for a (D, Co) weight with input Hessian (D, D).

    Returns (int8 (D, Co) kernel, (Co,) per-output-channel scales). Scales
    are the plain abs-max grid — GPTQ changes WHICH grid point each weight
    rounds to, not the grid.
    """
    w = np.asarray(w, np.float64).copy()
    d, co = w.shape
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.where(scale == 0, 1.0, scale)

    hess = np.asarray(hess, np.float64).copy()
    diag_mean = float(np.mean(np.diag(hess)))
    if diag_mean <= 0:
        diag_mean = 1.0
    hess[np.diag_indices(d)] += damp * diag_mean
    # Dead inputs: no signal, no compensation possible or needed.
    dead = np.diag(hess) == 0
    hess[dead, dead] = 1.0
    w[dead, :] = 0.0

    # Hinv via Cholesky of H^{-1} (upper), as in the reference algorithm.
    hinv = np.linalg.inv(hess)
    # Symmetrize against fp drift before Cholesky.
    hinv = (hinv + hinv.T) / 2.0
    try:
        u = np.linalg.cholesky(hinv).T  # upper triangular
    except np.linalg.LinAlgError:
        hinv[np.diag_indices(d)] += 1e-8 * np.mean(np.diag(hinv))
        u = np.linalg.cholesky(hinv).T

    q = np.zeros((d, co), np.int8)
    for i in range(d):
        qi = np.clip(np.round(w[i, :] / scale), -127, 127)
        q[i, :] = qi.astype(np.int8)
        err = (w[i, :] - qi * scale) / u[i, i]
        if i + 1 < d:
            w[i + 1:, :] -= np.outer(u[i, i + 1:], err)
    return q, scale.astype(np.float32)


def quantize_conv_gptq(kernel: np.ndarray, feat: np.ndarray,
                       act_scale: np.ndarray | float,
                       n_samples: int = 32768,
                       bias: np.ndarray | None = None,
                       seed: int = 0):
    """GPTQ an HWIO conv kernel against calibration feature maps.

    kernel: (kh, kw, Cin, Co) float (RAW — the per-input-channel activation
    scale is folded here exactly as the serving path folds it);
    feat: (B, H, W, Cin) the conv's input activations; act_scale: the STATIC
    activation scale (per-channel (Cin,) or scalar) the serving path will
    quantize with. Returns (int8 (kh,kw,Cin,Co), (Co,) scales,
    corrected bias) in the pre-quantized format of the int8 convs
    (``kernels.stream.conv3x3_int8_stream``, ``tail_conv_int8_stream``).
    """
    kh, kw, cin, co = kernel.shape
    s_in = np.broadcast_to(np.asarray(act_scale, np.float64), (cin,))
    keff = np.asarray(kernel, np.float64) * s_in.reshape(1, 1, -1, 1)
    w = keff.reshape(kh * kw * cin, co)

    # Hessian in the QUANTIZED activation domain (X / s_in), matching the
    # domain keff multiplies at serve time.
    rows = im2col_patches(np.asarray(feat, np.float32), kh, kw,
                          n_samples, seed)
    rows = rows.astype(np.float64) / np.tile(s_in, kh * kw)
    hess = rows.T @ rows

    q, scale = gptq_quantize(w, hess)

    new_bias = None
    if bias is not None:
        # Bias correction: absorb the mean input's response to the residual
        # weight error.
        resid = w - q.astype(np.float64) * scale[None, :].astype(np.float64)
        mean_in = rows.mean(axis=0)
        new_bias = (np.asarray(bias, np.float64)
                    + mean_in @ resid).astype(np.float32)
    return q.reshape(kh, kw, cin, co), scale, new_bias
