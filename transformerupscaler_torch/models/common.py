"""Shared model pieces: geometry resolution, the conv layer, the window
transformer block and the window trunk.

JAX counterpart: transformerupscaler_tpu models/common.py:26, :55-76 and
:123-243 (the trunk block by block, ``attn_impl="xla"`` or ``"pallas"``, and
the fused one, ``"fused"`` or ``"fused2"``). Parameters are kept in the JAX
layout, HWIO conv kernels and (in, out) dense kernels, and in f32; compute
runs in the activation dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from transformerupscaler_torch.kernels.trunk2 import (
    fused_window_trunk,
    stack_trunk_params,
)
from transformerupscaler_torch.ops.attention import window_attention
from transformerupscaler_torch.ops.conv import conv2d
from transformerupscaler_torch.ops.windows import window_partition, window_reverse


def resolve_geometry(in_hw: tuple[int, int], res_out, upscale_factor):
    """``upscale_factor`` wins and redefines res_out; otherwise
    scale = ceil(max(res_out / in)) (reference FastTransformer/model.py:244-248)."""
    h, w = in_hw
    if upscale_factor is not None:
        res_out = (h * upscale_factor, w * upscale_factor)
    else:
        upscale_factor = math.ceil(max(res_out[0] / h, res_out[1] / w))
    return tuple(res_out), int(upscale_factor)


def param(*shape) -> nn.Parameter:
    """An inference parameter, zeros until weights are loaded."""
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class ConvLayer(nn.Module):
    """k x k conv with an HWIO ``kernel`` and a ``bias``, PyTorch's
    ``padding=1`` output extents, optional ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 relu: bool = False):
        super().__init__()
        self.kernel = param(k, k, cin, cout)
        self.bias = param(cout)
        self.stride, self.relu = stride, relu

    def forward(self, x):
        return conv2d(x, self.kernel, self.bias, stride=self.stride,
                      relu=self.relu)


class Dense(nn.Module):
    """``x @ kernel + bias`` in x's dtype, kernel (in, out)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = param(d_in, d_out)
        self.bias = param(d_out)

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)`` numerics: f32 statistics with
    var = E[x^2] - E[x]^2 clipped at 0, the affine in f32, one rounding to
    x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = param(dim)
        self.bias = param(dim)
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.qkv_kernel = param(dim, 3 * dim)
        self.qkv_bias = param(3 * dim)
        self.proj_kernel = param(dim, dim)
        self.proj_bias = param(dim)
        self.bias_table = param((2 * window_size - 1) ** 2, num_heads)
        self.window_size = window_size
        self.num_heads = num_heads

    def forward(self, x, impl: str = "xla"):
        return window_attention(x, self.qkv_kernel, self.qkv_bias,
                                self.proj_kernel, self.proj_bias,
                                self.bias_table, self.num_heads,
                                self.window_size, impl)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU written as ``jax.nn.gelu(approximate=False)`` is,
    0.5 * x * erfc(-x * sqrt(1/2)) with each step in x's dtype, so that
    bf16 rounds where the JAX reference rounds."""
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


class WindowBlock(nn.Module):
    """Pre-LN window attention + pre-LN 4x exact-GELU MLP, with residuals
    (inference: no dropout)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, hidden)
        self.mlp_fc2 = Dense(hidden, dim)

    def forward(self, x, impl: str = "xla"):
        x = x + self.attn(self.norm1(x), impl)
        h = gelu(self.mlp_fc1(self.norm2(x)))
        return x + self.mlp_fc2(h)


TRUNK_IMPLS = ("xla", "pallas", "fused", "fused2")
# The fused trunk's kernel mode per ``attn_impl``: "fused" is trunk.py's v1
# (the other residual association), "fused2" trunk2.py's v2.
FUSED_MODES = {"fused": "v1", "fused2": "v2"}


def run_window_trunk(tokens: torch.Tensor, blocks, window_size: int,
                     impl: str = "xla", stacked=None,
                     int8_acts=None) -> torch.Tensor:
    """tokens (B, Ht, Wt, D) -> same shape: zero-pad the grid to a window
    multiple, run the blocks on the windows, unpad.

    ``impl`` follows the JAX ``attn_impl``: "xla" runs the blocks one by one
    in PyTorch; "pallas" does too, with each block's attention core on the
    ``window_attention_core`` kernel; "fused" and "fused2" hand all windows
    to ``fused_window_trunk`` once, in its mode "v1" or "v2", with
    ``stacked`` (default: ``stack_trunk_params(blocks, dtype, ...)``, which a
    caller may compute once and keep). ``int8_acts="rowwise"`` turns
    "fused2" into the mode "int8_rowwise" (``stacked`` must then hold the
    int8 weights) and, as in JAX, is ignored by every other impl; the static
    per-channel scales (a tuple) are not ported. The zero tokens of the
    padding go through either as ordinary tokens, unmasked, as in JAX."""
    if impl not in TRUNK_IMPLS:
        raise ValueError(f"impl: one of {TRUNK_IMPLS}, got {impl!r}")
    mode = FUSED_MODES.get(impl)
    if mode == "v2" and int8_acts is not None:
        if not isinstance(int8_acts, str):
            raise NotImplementedError(
                "int8_acts: the static per-channel scales (int8_gemms=True) "
                "are not ported; the port serves int8_acts='rowwise'")
        if int8_acts != "rowwise":
            raise ValueError(f"unknown int8_acts mode {int8_acts!r}")
        mode = "int8_rowwise"
    b, ht, wt, d = tokens.shape
    ws = window_size
    pad_b = (ws - ht % ws) % ws
    pad_r = (ws - wt % ws) % ws
    if pad_b or pad_r:
        tokens = F.pad(tokens, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = ht + pad_b, wt + pad_r
    win = window_partition(tokens, ws)
    n_win = win.shape[1]
    win = win.reshape(b * n_win, ws * ws, d)
    if mode is not None:
        if stacked is None:
            stacked = stack_trunk_params(blocks, tokens.dtype,
                                         mode == "int8_rowwise")
        win = fused_window_trunk(win.contiguous(), stacked, mode)
    else:
        for block in blocks:
            win = block(win, impl)
    tokens = window_reverse(win.reshape(b, n_win, ws * ws, d), ws, hp, wp)
    return tokens[:, :ht, :wt, :]


class FusedTrunk:
    """For a model with ``blocks``, ``window_size``, ``dtype``,
    ``attn_impl`` and ``int8_trunk``: its trunk, with the blocks' weights
    stacked for the fused kernel once per device."""

    int8_trunk = False

    def clear_derived(self) -> None:
        """Drop what was derived from the parameters; call after changing
        them (``weights.params_from_jax`` does)."""
        self._trunk = {}

    def trunk_params(self) -> dict:
        key = self.blocks[0].norm1.scale.device
        if key not in self._trunk:
            self._trunk[key] = stack_trunk_params(
                self.blocks, self.dtype,
                self.int8_trunk and self.attn_impl == "fused2")
        return self._trunk[key]

    def run_trunk(self, tokens: torch.Tensor) -> torch.Tensor:
        fused = self.attn_impl in FUSED_MODES
        return run_window_trunk(
            tokens, self.blocks, self.window_size, self.attn_impl,
            self.trunk_params() if fused else None,
            "rowwise" if self.int8_trunk else None)
