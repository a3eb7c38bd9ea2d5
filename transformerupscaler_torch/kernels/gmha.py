"""Global multi-head attention core as a Hopper kernel: softmax(q k^T) v over
all tokens, heads packed in the channels. Wrapper and plain PyTorch version.

===============  ====================  ==================================
wrapper          CUDA source           TPU kernel it replaces
===============  ====================  ==================================
``global_mha``   csrc/global_mha.cu    ops/pallas/gmha.py:60 ``global_mha``
===============  ====================  ==================================

The qkv and output products stay outside the kernel
(``ops.attention.multihead_attention`` wraps them around this core), as in the
JAX package. The TPU function pads N to a multiple of 128 and masks the pad
keys with -1e9; the CUDA kernel bounds its key loop at N instead, and the plain
version has nothing to pad.

Rounding points (gmha.py:46-57 and :81), with ``dt`` the dtype of q:
q * head_dim^-0.5 in ``dt``; scores in f32; max, exp, sum and the division in
f32; the probabilities rounded to ``dt`` before the product with v, which
accumulates in f32 and is rounded once to ``dt``. The CUDA kernel keeps that
rounding point by making two passes over the keys (see its source).

A wrapper given CPU tensors computes the plain version (any shape); given CUDA
tensors it launches the kernel, adds one to ``LAUNCHES["global_mha"]`` and
never falls back.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels._common import (
    LAUNCHES,
    on_card,
    raise_on,
    stream_of,
)

# What the CUDA kernel is compiled for.
HEAD_DIM, MAX_DIM = 16, 256


def global_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Plain version of ``global_mha``; any widths. Materializes the
    (B, heads, N, N) f32 scores."""
    b, n, c = q.shape
    hd = c // num_heads
    dt = q.dtype
    q, k, v = (t.reshape(b, n, num_heads, hd).transpose(1, 2)
               for t in (q, k, v))  # (B, heads, N, hd)
    q = q * torch.tensor(hd ** -0.5, dtype=dt)
    s = q.float() @ k.float().transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    ctx = (p.float() @ v.float()).to(dt)
    return ctx.transpose(1, 2).reshape(b, n, c)


def _check_rows(t: torch.Tensor, name: str, shape, strides) -> None:
    """A (B, N, C) bf16 view with unit channel stride whose rows and batches
    start on 16-byte boundaries, such as a slice of the packed qkv."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: expected torch.bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if tuple(t.stride()) != tuple(strides) or strides[2] != 1 \
            or strides[0] % 8 or strides[1] % 8:
        raise ValueError(f"{name}: strides {tuple(t.stride())} not supported "
                         f"(q, k and v must share them, channels contiguous, "
                         f"rows and batches on 16-byte boundaries)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def global_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over packed-head channels.

    q, k, v: (B, N, C) with head h in channels [h hd, (h+1) hd); they may be
    the three channel slices of one packed (B, N, 3C) tensor, which are not
    copied. Returns (B, N, C) in q's dtype, contiguous. On the card: bf16,
    16 channels a head, C <= 256; any N.
    """
    if not on_card(q, k, v):
        return global_mha_plain(q, k, v, num_heads)
    b, n, c = q.shape
    if c != HEAD_DIM * num_heads or c > MAX_DIM:
        raise ValueError(
            f"global_mha: the kernel takes heads of {HEAD_DIM} channels up "
            f"to C = {MAX_DIM}; got C = {c} with {num_heads} heads")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(t, name, (b, n, c), q.stride())
    out = torch.empty(b, n, c, dtype=torch.bfloat16, device=q.device)
    err = _build.load("global_mha").tux_global_mha(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, c,
        num_heads, q.stride(0), q.stride(1), q.device.index, stream_of(q))
    raise_on(err, "global_mha")
    LAUNCHES["global_mha"] += 1
    return out
