"""Separable resize as dense matrix products, with PyTorch/PIL semantics.

JAX counterpart: transformerupscaler_tpu ops/resize.py:27-112 (the numpy
``resize_matrix``), :180 ``resize``, :344 ``interpolate_bicubic`` and
:228-284 ``resize_shuffled``, each in its dense form only: the banded form
(:113-176) is a TPU tiling; and :288-341, ``bicubic_upscale_conv``, the
integer-scale bicubic upscale as one 5x5 conv that emits pixel-shuffle
channels (JAX ``bicubic_upscale_conv_packed``, without the TPU's width-2
packed layout). The matrices are built once per geometry in numpy
float64, cast to the compute dtype as the JAX ops cast them, and kept on the
device per (sizes, dtype).
"""

from __future__ import annotations

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


def resize(x: torch.Tensor, out_hw: tuple[int, int], method: str = "bicubic",
           antialias: bool = False, a: float | None = None) -> torch.Tensor:
    """Resize NHWC (or HWC) images to ``out_hw`` by two matrix products, the
    height pass first, each in x's dtype with its matrix rounded to it. An
    extent that does not change is skipped."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if oh != h:
        wh = _phase_matrix(h, 1, oh, method, antialias, a, x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", wh[:, :, 0], x)
    if ow != w:
        ww = _phase_matrix(w, 1, ow, method, antialias, a, x.device, x.dtype)
        x = torch.einsum("pw,bhwc->bhpc", ww[:, :, 0], x)
    return x[0] if squeeze else x


def interpolate_bicubic(x: torch.Tensor,
                        out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode="bicubic", align_corners=False)`` on
    NHWC: cubic a = -0.75, no antialias, border indices clamped."""
    return resize(x, out_hw, method="bicubic", antialias=False)


def resize_shuffled(z: torch.Tensor, r: int, out_hw: tuple[int, int],
                    method: str = "bilinear", antialias: bool = True,
                    a: float | None = None) -> torch.Tensor:
    """``resize(pixel_shuffle(z, r), out_hw)`` without building the shuffled
    image. z: (B, H, W, C*r*r), channels ordered (c, i, j).

    The resize matrices split by phase, M_i[o, h] = M[o, h*r + i], and apply
    in the packed domain. Both products run in z's dtype with the matrices
    rounded to it, and the height pass is rounded to it before the width
    pass, as in the JAX op.
    """
    b, h, w, crr = z.shape
    c = crr // (r * r)
    oh, ow = out_hw
    z6 = z.reshape(b, h, w, c, r, r)
    mh = _phase_matrix(h, r, oh, method, antialias, a, z.device, z.dtype)
    t = torch.einsum("ohi,nhwcij->nowcj", mh, z6)
    mw = _phase_matrix(w, r, ow, method, antialias, a, z.device, z.dtype)
    return torch.einsum("pwj,nowcj->nopc", mw, t)


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
