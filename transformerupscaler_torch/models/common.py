"""Shared model pieces: geometry resolution, the conv layer, the window
transformer block, its int8 calibration and the window trunk.

JAX counterpart: transformerupscaler_tpu models/common.py:26, :55-76 and
:123-243 (the trunk block by block, ``attn_impl="xla"`` or ``"pallas"``, the
blocks' MLP in int8 with ``int8_mlp``, and the fused one, ``"fused"`` or
``"fused2"``, with ``int8_acts``; the blocks' ``calib_trunk_int8`` as
``trunk_int8_scales``). Parameters are kept in the
JAX layout, HWIO conv kernels and (in, out) dense kernels, and in f32;
compute runs in the activation dtype.

Training mode (JAX's ``deterministic=False``): a model serves in eval
mode, where its forward runs under ``torch.inference_mode()``
(``inference_unless_training``); after ``train()`` the forward runs under
autograd, block by block in PyTorch whatever ``attn_impl`` says (no fused
trunk, no window-attention kernel, no int8 MLP: the kernels have no
backward, as the Pallas ones have no VJP), with ``Dropout`` at JAX's
sites: window attention's probabilities and projected output, global
attention's probabilities, and each block's MLP output.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from transformerupscaler_torch.kernels.trunk2 import (
    add_static_int8,
    check_static_scales,
    fused_window_trunk,
    stack_trunk_params,
)
from transformerupscaler_torch.ops.attention import window_attention
from transformerupscaler_torch.ops.conv import conv2d
from transformerupscaler_torch.ops.quant import int8_dense, quantize_weight
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
    """A parameter, zeros until weights are loaded. It requires no grad:
    serving models never do; a ``Trainer`` turns it on for its own."""
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


def inference_unless_training(forward):
    """Decorate a model's ``forward``: in eval mode (serving, the models'
    mode from construction) it runs under ``torch.inference_mode()``; in
    train mode under autograd as the caller has it."""
    @functools.wraps(forward)
    def run(self, *args, **kwargs):
        if self.training:
            return forward(self, *args, **kwargs)
        with torch.inference_mode():
            return forward(self, *args, **kwargs)
    return run


class Dropout:
    """Inverted dropout at ``rate`` with masks drawn from ``generator``:
    an element is kept with probability keep = 1 - rate and then divided by
    keep rounded to the element's dtype, as JAX divides by a weakly typed
    Python float (``ops/attention._dropout``, ``nn.Dropout``). One instance
    serves one forward; every call draws a new mask."""

    def __init__(self, rate: float, generator: torch.Generator):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
        self.rate = rate
        self.generator = generator

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        """Drawn on the generator's device, then moved to x's (a head group
        on another device of a mesh)."""
        return (torch.rand(x.shape, generator=self.generator,
                           device=self.generator.device)
                < 1.0 - self.rate).to(x.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.full((), 1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(self.keep_mask(x), x / keep, keep.new_zeros(()))


def dropout_for(model: nn.Module, generator) -> Dropout | None:
    """The ``Dropout`` of one train-mode forward of ``model`` (None in eval
    mode or at rate 0). Train mode at a rate above 0 needs a
    ``torch.Generator`` on the input's device, as JAX needs a dropout
    key."""
    if not model.training or model.dropout == 0.0:
        return None
    if generator is None:
        raise ValueError(f"{type(model).__name__} in train mode with dropout "
                         f"{model.dropout} needs a torch.Generator "
                         f"(generator=)")
    return Dropout(model.dropout, generator)


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

    def forward(self, x, impl: str = "xla", calib: dict | None = None,
                drop: Dropout | None = None):
        if calib is not None:
            # proj's input is a per-head convex combination of v rows, so
            # the per-channel max |v| bounds it (JAX common.py:104-111): v
            # from the product rounded to x's dtype, the f32 bias added in
            # f32, as JAX promotes it.
            d = self.qkv_kernel.shape[0]
            qkv = (x @ self.qkv_kernel.to(x.dtype)).float() + self.qkv_bias
            calib["proj"] = _abs_max(qkv[..., 2 * d:3 * d])
        return window_attention(x, self.qkv_kernel, self.qkv_bias,
                                self.proj_kernel, self.proj_bias,
                                self.bias_table, self.num_heads,
                                self.window_size, impl, drop)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU written as ``jax.nn.gelu(approximate=False)`` is,
    0.5 * x * erfc(-x * sqrt(1/2)) with each step in x's dtype, so that
    bf16 rounds where the JAX reference rounds."""
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def _abs_max(v: torch.Tensor) -> torch.Tensor:
    """Per-channel max |v| over every axis but the last, in f32."""
    return v.float().abs().reshape(-1, v.shape[-1]).amax(dim=0)


class WindowBlock(nn.Module):
    """Pre-LN window attention + pre-LN 4x exact-GELU MLP, with residuals,
    and in train mode ``drop`` at JAX's sites (attention, then the MLP's
    output, ``mlp_drop``).

    ``int8_mlp`` (JAX common.py:136, 168-180): the MLP's two products as
    ``ops.quant.int8_dense``, the f32 weights quantized per output channel
    at each forward (``quantize_weight``), the activations per tensor over
    the whole (zero-padded) window batch the block is given. Only the
    block-by-block trunk runs the blocks; the fused trunk ignores it, as in
    JAX, and so does train mode (JAX applies it only when deterministic)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, int8_mlp: bool = False):
        super().__init__()
        self.int8_mlp = int8_mlp
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, hidden)
        self.mlp_fc2 = Dense(hidden, dim)

    def forward(self, x, impl: str = "xla", calib: dict | None = None,
                drop: Dropout | None = None):
        """``calib``: a dict that receives the per-channel max |input| of
        the four GEMMs, as JAX ``calib_trunk_int8`` sows them (common.py:
        98-110, 136-186): "qkv" (LN1 output), "proj" (v), "fc1" (LN2
        output), "fc2" (GELU output). The output is the same with or
        without it."""
        y = self.norm1(x)
        if calib is not None:
            calib["qkv"] = _abs_max(y)
        x = x + self.attn(y, impl, calib, drop)
        z = self.norm2(x)
        if calib is not None:
            calib["fc1"] = _abs_max(z)
        if self.int8_mlp and not self.training:
            # As in JAX, the int8 MLP records no "fc2" maximum.
            f1, f2 = self.mlp_fc1, self.mlp_fc2
            y = gelu(int8_dense(z, *quantize_weight(f1.kernel), f1.bias))
            return x + int8_dense(y, *quantize_weight(f2.kernel), f2.bias)
        h = gelu(self.mlp_fc1(z))
        if calib is not None:
            calib["fc2"] = _abs_max(h)
        y = self.mlp_fc2(h)
        return x + (y if drop is None else drop(y))


CALIB_GEMMS = ("qkv", "proj", "fc1", "fc2")


def trunk_int8_scales(blocks, win: torch.Tensor):
    """The static int8 trunk's activation scales from calibration windows:
    the blocks run one by one on ``win`` (nW, n, C) in PyTorch, each
    recording the per-channel max |input| of its four GEMMs. Returns
    (s_qkv (L, C), s_proj (L, C), s_fc1 (L, C), s_fc2 (L, H)) f32, the
    ``int8_acts`` tuple of ``run_window_trunk``."""
    per_block = []
    for block in blocks:
        calib = {}
        win = block(win, "xla", calib)
        per_block.append(calib)
    return tuple(torch.stack([c[k] for c in per_block])
                 for k in CALIB_GEMMS)


TRUNK_IMPLS = ("xla", "pallas", "fused", "fused2")
# The fused trunk's kernel mode per ``attn_impl``: "fused" is trunk.py's v1
# (the other residual association), "fused2" trunk2.py's v2.
FUSED_MODES = {"fused": "v1", "fused2": "v2"}


def run_window_trunk(tokens: torch.Tensor, blocks, window_size: int,
                     impl: str = "xla", stacked=None, int8_acts=None,
                     drop: Dropout | None = None) -> torch.Tensor:
    """tokens (B, Ht, Wt, D) -> same shape: zero-pad the grid to a window
    multiple, run the blocks on the windows, unpad.

    ``impl`` follows the JAX ``attn_impl``: "xla" runs the blocks one by one
    in PyTorch; "pallas" does too, with each block's attention core on the
    ``window_attention_core`` kernel; "fused" and "fused2" hand all windows
    to ``fused_window_trunk`` once, in its mode "v1" or "v2", with
    ``stacked`` (default: ``stack_trunk_params(blocks, dtype, ...)``, which a
    caller may compute once and keep). ``int8_acts`` turns "fused2" into an
    int8 mode and, as in JAX, is ignored by every other impl: "rowwise"
    into "int8_rowwise" (``stacked`` must then hold the int8 weights), the
    static per-channel scales (s_qkv (L, C), s_proj (L, C), s_fc1 (L, C),
    s_fc2 (L, 4C), as ``trunk_int8_scales`` returns them) into
    "int8_static", whose weights are folded and quantized from ``stacked``
    for these scales (``add_static_int8``) unless ``stacked`` was so folded
    for this very tuple, as a caller that keeps ``add_static_int8(stacked,
    scales)`` and passes the same ``scales`` does (any other shapes raise
    ValueError;
    ``chip_smoke.py``'s ``trunk_static`` line runs it at full width,
    ``tests/test_torch_int8_static_trunk.py`` against JAX on the CPU).
    The zero tokens of the padding go through either as ordinary tokens,
    unmasked, as in JAX. ``drop`` goes to the blocks ("xla" and "pallas"
    only; a train-mode model runs "xla")."""
    if impl not in TRUNK_IMPLS:
        raise ValueError(f"impl: one of {TRUNK_IMPLS}, got {impl!r}")
    mode = FUSED_MODES.get(impl)
    if mode == "v2" and int8_acts is not None:
        if not isinstance(int8_acts, str):
            mode = "int8_static"
            check_static_scales(int8_acts, len(blocks), tokens.shape[-1],
                                blocks[0].mlp_fc1.kernel.shape[1])
        elif int8_acts != "rowwise":
            raise ValueError(f"unknown int8_acts mode {int8_acts!r}")
        else:
            mode = "int8_rowwise"
    b, ht, wt, d = tokens.shape
    win, (n_win, hp, wp) = trunk_windows(tokens, window_size)
    if mode is not None:
        if stacked is None:
            stacked = stack_trunk_params(blocks, tokens.dtype,
                                         mode == "int8_rowwise")
        if mode == "int8_static" and stacked.get("int8_acts") is not int8_acts:
            stacked = add_static_int8(stacked, int8_acts)
        win = fused_window_trunk(win.contiguous(), stacked, mode)
    else:
        for block in blocks:
            win = block(win, impl, drop=drop)
    tokens = window_reverse(win.reshape(b, n_win, -1, d), window_size, hp, wp)
    return tokens[:, :ht, :wt, :]


def trunk_windows(tokens: torch.Tensor, window_size: int):
    """tokens (B, Ht, Wt, D), the grid zero-padded to a window multiple, as
    the trunk's windows (B * nW, ws * ws, D); also (nW, padded Ht, padded
    Wt)."""
    b, ht, wt, d = tokens.shape
    ws = window_size
    pad_b = (ws - ht % ws) % ws
    pad_r = (ws - wt % ws) % ws
    if pad_b or pad_r:
        tokens = F.pad(tokens, (0, 0, 0, pad_r, 0, pad_b))
    win = window_partition(tokens, ws)
    n_win = win.shape[1]
    return win.reshape(b * n_win, ws * ws, d), (n_win, ht + pad_b, wt + pad_r)


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

    def run_trunk(self, tokens: torch.Tensor,
                  drop: Dropout | None = None) -> torch.Tensor:
        """The trunk by ``attn_impl``; in train mode block by block in
        PyTorch, with ``drop`` (JAX common.py:214: the fused trunk and the
        Pallas core serve only when deterministic)."""
        if self.training:
            return run_window_trunk(tokens, self.blocks, self.window_size,
                                    "xla", drop=drop)
        fused = self.attn_impl in FUSED_MODES
        return run_window_trunk(
            tokens, self.blocks, self.window_size, self.attn_impl,
            self.trunk_params() if fused else None,
            "rowwise" if self.int8_trunk else None)
