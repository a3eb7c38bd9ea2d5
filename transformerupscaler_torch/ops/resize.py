"""Separable resize as matrix products, with PyTorch/PIL semantics.

JAX counterpart: transformerupscaler_tpu ops/resize.py:27-112 (the numpy
``resize_matrix``), :113-174 (``_banded_factors``, ``_banded_on``), :180
``resize``, :228-284 ``resize_shuffled``, :344 ``interpolate_bicubic`` and
:350 ``resize_antialias_bilinear``; and :288-341, ``bicubic_upscale_conv``,
the integer-scale bicubic upscale as one 5x5 conv that emits pixel-shuffle
channels (JAX ``bicubic_upscale_conv_packed``, without the TPU's width-2
packed layout). The matrices are built once per geometry in numpy
float64, cast to the compute dtype as the JAX ops cast them, and kept on the
device per (sizes, dtype).

Each pass runs dense, one product over the whole input axis, or banded:
the same matrix cut into blocks of ``_MB`` output rows, each block
contracting only the window of input rows under it. The dropped terms are
exact zeros, so the two forms differ only by the order of the sums; the
banded one does a tenth of the dense one's products at 720x1280 ->
1080x1920. ``TUX_BANDED_RESIZE`` picks the form as JAX's does, read at
every call (``_banded_on``).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic kernel: a=-0.75 is PyTorch's bicubic, a=-0.5 PIL's."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax <= 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _matrix_no_antialias(in_size, out_size, method, a):
    """``F.interpolate(align_corners=False)``: fixed-width kernel, source
    coords (i + 0.5) * in/out - 0.5, indices clamped to the border."""
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    src = (i + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base
    if method == "bilinear":
        offsets = np.array([0, 1])
        weights = np.stack([1.0 - t, t], axis=1)
    elif method == "bicubic":
        offsets = np.array([-1, 0, 1, 2])
        weights = np.stack([_cubic(t - off, a) for off in offsets], axis=1)
    else:
        raise ValueError(f"unknown method {method!r}")
    idx = np.clip(base[:, None] + offsets[None, :], 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(i.astype(np.int64), len(offsets)), idx.ravel()),
              weights.ravel())
    return mat


def _matrix_antialias(in_size, out_size, method, a):
    """PIL / torchvision(antialias=True): support widened by the downscale
    factor, weights renormalized per output pixel."""
    if method == "bilinear":
        filt, base_support = _triangle, 1.0
    elif method == "bicubic":
        filt, base_support = (lambda x: _cubic(x, a)), 2.0
    else:
        raise ValueError(f"unknown method {method!r}")
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        j = np.arange(xmin, xmax, dtype=np.float64)
        w = filt((j + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        mat[i, xmin:xmax] = w
    return mat


@lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, method: str = "bicubic",
                  antialias: bool = False, a: float | None = None) -> np.ndarray:
    """1-D resampling matrix (out_size, in_size), float32. ``a`` defaults to
    -0.75 without antialias (PyTorch) and -0.5 with it (PIL/torchvision)."""
    if a is None:
        a = -0.5 if antialias else -0.75
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    build = _matrix_antialias if antialias else _matrix_no_antialias
    return build(in_size, out_size, method, a).astype(np.float32)


@lru_cache(maxsize=None)
def _banded_factors(in_size: int, out_size: int, method: str,
                    antialias: bool, a: float | None, mb: int, r: int = 1):
    """``resize_matrix(in_size * r, out_size)`` as ceil(out / mb) blocks of
    ``mb`` output rows, each over a window of ``wb`` input rows (all ``r``
    phases of each): (weights (nb, mb, wb, r) float32, starts (nb,) int64)
    with out[b*mb + o] = sum_{k,i} weights[b, o, k, i] x[starts[b] + k, i].
    ``wb`` is the widest block's span of nonzero columns rounded up to 8,
    the starts clipped to fit. None where the band is no real saving: ``wb``
    at least 0.7 of the input, or fewer than 2 mb output rows (JAX
    ops/resize.py:113-153, array for array)."""
    mat = resize_matrix(in_size * r, out_size, method, antialias, a)
    mat3 = mat.reshape(out_size, in_size, r)
    nb = -(-out_size // mb)
    nz_any = np.any(mat3 != 0.0, axis=2)
    starts = np.zeros(nb, np.int64)
    ends = np.zeros(nb, np.int64)
    for b in range(nb):
        nzc = np.nonzero(nz_any[b * mb:(b + 1) * mb].any(axis=0))[0]
        starts[b], ends[b] = ((nzc[0], nzc[-1] + 1) if len(nzc)
                              else (0, 1))
    wb = int((ends - starts).max())
    wb = min(-(-wb // 8) * 8, in_size)
    if wb >= in_size * 0.7 or out_size < 2 * mb:
        return None
    starts = np.clip(starts, 0, in_size - wb)
    wts = np.zeros((nb, mb, wb, r), np.float32)
    for b in range(nb):
        o0, o1 = b * mb, min((b + 1) * mb, out_size)
        wts[b, :o1 - o0] = mat3[o0:o1, starts[b]:starts[b] + wb]
    return wts, starts


_MB = 128  # output rows a band block


def _banded_on(precise: bool = False, dtype=None) -> bool:
    """JAX's tri-state gate (ops/resize.py:156-174), ``TUX_BANDED_RESIZE``
    read at every call: "1" bands every resize, "0" none; unset or "auto"
    bands where the product is asked to be precise (JAX's ``precision``
    given: the ``serve_quality`` "squash" part) or runs in float32."""
    v = os.environ.get("TUX_BANDED_RESIZE", "auto")
    if v in ("0", "1"):
        return v == "1"
    return precise or dtype == torch.float32


@lru_cache(maxsize=32)
def _band_on(in_size, r, out_size, method, antialias, a, device, dtype):
    """``_banded_factors(in_size, out_size, ..., _MB, r)`` on ``device``:
    the weights (nb, mb, wb * r) in ``dtype``, (k, i) flattened, and the
    input rows each block reads, (nb * wb * r,) in the (row, phase) order
    of an input whose rows are flattened with their phases; None where
    JAX runs dense. Built and copied once per geometry, outside inference
    mode (a train-mode forward saves them for backward)."""
    bf = _banded_factors(in_size, out_size, method, antialias, a, _MB, r)
    if bf is None:
        return None
    wts, starts = bf
    nb, mb, wb, _ = wts.shape
    rows = ((starts[:, None] + np.arange(wb))[:, :, None] * r
            + np.arange(r)).reshape(-1)
    with torch.inference_mode(False):
        return (torch.from_numpy(wts.reshape(nb, mb, wb * r)).to(device,
                                                                 dtype),
                torch.from_numpy(rows).to(device))


def _band_pass(x: torch.Tensor, band, out_size: int) -> torch.Tensor:
    """One banded pass: x (n, L, N), its L = in_size * r rows in the order
    of ``band``'s row indices -> (n, out_size, N). Each block's window is
    gathered and multiplied by the block's weights in x's dtype."""
    wts, rows = band
    nb, mb, k = wts.shape
    n, _, cols = x.shape
    xw = x.index_select(1, rows).view(n, nb, k, cols)
    return torch.matmul(wts, xw).reshape(n, nb * mb, cols)[:, :out_size]


def resize(x: torch.Tensor, out_hw: tuple[int, int], method: str = "bicubic",
           antialias: bool = False, a: float | None = None) -> torch.Tensor:
    """Resize NHWC (or HWC) images to ``out_hw`` by two matrix products, the
    height pass first, each in x's dtype with its matrix rounded to it. An
    extent that does not change is skipped. Dense unless
    ``TUX_BANDED_RESIZE=1``, as in JAX (no precision is asked here)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    n, h, w, c = x.shape
    oh, ow = out_hw
    banded = _banded_on()
    if oh != h:
        band = (_band_on(h, 1, oh, method, antialias, a, x.device, x.dtype)
                if banded else None)
        if band is None:
            wh = _phase_matrix(h, 1, oh, method, antialias, a, x.device,
                               x.dtype)
            x = torch.einsum("oh,bhwc->bowc", wh[:, :, 0], x)
        else:
            x = _band_pass(x.reshape(n, h, w * c), band, oh).view(n, oh, w,
                                                                  c)
    if ow != w:
        band = (_band_on(w, 1, ow, method, antialias, a, x.device, x.dtype)
                if banded else None)
        if band is None:
            ww = _phase_matrix(w, 1, ow, method, antialias, a, x.device,
                               x.dtype)
            x = torch.einsum("pw,bhwc->bhpc", ww[:, :, 0], x)
        else:
            rows = x.shape[1]
            xt = x.permute(0, 2, 1, 3).reshape(n, w, rows * c)
            x = _band_pass(xt, band, ow).view(n, ow, rows, c).permute(
                0, 2, 1, 3).contiguous()
    return x[0] if squeeze else x


def interpolate_bicubic(x: torch.Tensor,
                        out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode="bicubic", align_corners=False)`` on
    NHWC: cubic a = -0.75, no antialias, border indices clamped."""
    return resize(x, out_hw, method="bicubic", antialias=False)


def resize_antialias_bilinear(x: torch.Tensor,
                              out_hw: tuple[int, int]) -> torch.Tensor:
    """``torchvision.transforms.Resize(size)`` on tensors: bilinear,
    antialias=True (the reference's require_ratio and training squash)."""
    return resize(x, out_hw, method="bilinear", antialias=True)


def resize_shuffled(z: torch.Tensor, r: int, out_hw: tuple[int, int],
                    method: str = "bilinear", antialias: bool = True,
                    a: float | None = None,
                    precise: bool = False) -> torch.Tensor:
    """``resize(pixel_shuffle(z, r), out_hw)`` without building the shuffled
    image. z: (B, H, W, C*r*r), channels ordered (c, i, j).

    The resize matrices split by phase, M_i[o, h] = M[o, h*r + i], and apply
    in the packed domain. Both products run in z's dtype with the matrices
    rounded to it, and the height pass is rounded to it before the width
    pass, as in the JAX op. ``precise``: the product is asked to keep its
    precision (JAX's ``precision`` given), which bands it under
    ``TUX_BANDED_RESIZE`` "auto"; f32 products here are exact f32 anyway
    (no TF32 unless a caller enables it)."""
    b, h, w, crr = z.shape
    c = crr // (r * r)
    oh, ow = out_hw
    banded = _banded_on(precise, z.dtype)
    z6 = z.reshape(b, h, w, c, r, r)
    band = (_band_on(h, r, oh, method, antialias, a, z.device, z.dtype)
            if banded else None)
    if band is None:
        mh = _phase_matrix(h, r, oh, method, antialias, a, z.device, z.dtype)
        t = torch.einsum("ohi,nhwcij->nowcj", mh, z6)
    else:  # rows (h, i), columns (w, c, j)
        zt = z6.permute(0, 1, 4, 2, 3, 5).reshape(b, h * r, w * c * r)
        t = _band_pass(zt, band, oh).view(b, oh, w, c, r)
    band = (_band_on(w, r, ow, method, antialias, a, z.device, z.dtype)
            if banded else None)
    if band is None:
        mw = _phase_matrix(w, r, ow, method, antialias, a, z.device, z.dtype)
        return torch.einsum("pwj,nowcj->nopc", mw, t)
    tt = t.permute(0, 2, 4, 1, 3).reshape(b, w * r, oh * c)  # rows (w, j)
    return _band_pass(tt, band, ow).view(b, ow, oh, c).permute(
        0, 2, 1, 3).contiguous()


@lru_cache(maxsize=32)
def _phase_matrix(in_size, r, out_size, method, antialias, a, device, dtype):
    """``resize_matrix(in_size * r, out_size)`` split by phase to
    (out, in, r), on ``device`` in ``dtype``: built and copied once per
    geometry, not on every frame, outside inference mode (a train-mode
    forward saves it for backward)."""
    m = resize_matrix(in_size * r, out_size, method, antialias, a)
    with torch.inference_mode(False):
        return torch.from_numpy(m.reshape(out_size, in_size, r)).to(device,
                                                                    dtype)


@lru_cache(maxsize=None)
def bicubic_shuffle_kernel(r: int, c: int = 3) -> np.ndarray:
    """``F.interpolate(bicubic, align_corners=False)`` by an integer ``r``
    as one 5x5 correlation kernel (5, 5, c, c*r*r), float32, whose output
    channels are pixel_shuffle(r)-ordered (c, i, j) at the input's
    resolution: every output phase reads 4 input pixels at offsets
    base + [-1, 2] with base in {-1, 0}, so all phases fit a 5-tap frame,
    applied as a VALID conv over the input edge-padded by 2 (edge
    replication is the border index clamp). The 2-D taps are the outer
    product of the 1-D ones (JAX ops/resize.py:288-319)."""
    k1d = np.zeros((5, r), np.float64)
    for phase in range(r):
        src = (phase + 0.5) / r - 0.5
        base = int(np.floor(src))
        frac = src - base
        for m in (-1, 0, 1, 2):
            k1d[base + m + 2, phase] = _cubic(np.array([frac - m]), -0.75)[0]
    kern = np.zeros((5, 5, c, c * r * r), np.float64)
    for ch in range(c):
        for i in range(r):
            for j in range(r):
                kern[:, :, ch, ch * r * r + i * r + j] = np.outer(
                    k1d[:, i], k1d[:, j])
    return kern.astype(np.float32)


@lru_cache(maxsize=32)
def _shuffle_kernel_on(r, c, device, dtype) -> torch.Tensor:
    """``bicubic_shuffle_kernel`` as an OIHW weight in ``dtype`` on
    ``device``, copied once (outside inference mode)."""
    with torch.inference_mode(False):
        k = torch.from_numpy(bicubic_shuffle_kernel(r, c))
        return k.permute(3, 2, 0, 1).contiguous().to(device, dtype)


def bicubic_upscale_conv(x: torch.Tensor, r: int) -> torch.Tensor:
    """``interpolate_bicubic(x, (H*r, W*r))`` before its pixel shuffle:
    x (B, H, W, C) -> (B, H, W, C*r*r) in pixel_shuffle(r) channel order,
    borders included. The conv runs in x's dtype with the kernel rounded to
    it and one rounding of its result, as the JAX function's XLA conv."""
    c = x.shape[-1]
    xe = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate")
    out = F.conv2d(xe, _shuffle_kernel_on(r, c, x.device, x.dtype))
    return out.permute(0, 2, 3, 1).contiguous()
