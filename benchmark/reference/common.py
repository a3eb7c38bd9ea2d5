"""Plain PyTorch pieces shared by the reference models.

Written from the published model descriptions, not from the code under
test: NCHW tensors, ``torch.nn.functional`` ops, float32. The weights are
the JAX layout of the committed ``.npz`` copies, keyed by path
(``conv1/kernel`` HWIO, dense kernels (in, out)), converted here.

``precision`` is "f32" (float32, TF32 off: ``strict_f32``), or "fp8" or
"int8", the precisions below the bfloat16 the configurations serve in, for
the control of the comparison that decides ``correct``: every tensor a
layer takes or makes (the input, each conv, patch product, dense layer,
LayerNorm, attention's probabilities and context, GELU, residual sum and
resize) is rounded to float8 e4m3, or to symmetric int8 (127 steps a
side), with one scale over the tensor, each weight with a scale per output
channel, as a program computed in that precision would store them; the
sums run in float32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value
INT8_MAX = 127.0  # the largest symmetric int8 step


@contextlib.contextmanager
def strict_f32():
    """float32 products without TF32, on cuBLAS and cuDNN, for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_device(flat: dict, device) -> dict:
    """{path: numpy array} -> {path: float32 tensor on ``device``}."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in flat.items()}


def _round(x: torch.Tensor, amax: torch.Tensor,
           precision: str) -> torch.Tensor:
    """``x`` stored in the precision with the scale that maps ``amax`` to
    its largest value."""
    if precision == "fp8":
        s = amax.clamp_min(1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    if precision == "int8":
        s = amax.clamp_min(1e-30) / INT8_MAX
        return torch.round(x / s).clamp(-INT8_MAX, INT8_MAX) * s
    raise ValueError(f"unknown precision {precision!r}")


def rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as the precision stores it: with one scale over the tensor, or
    unchanged in "f32"."""
    if precision == "f32":
        return x
    return _round(x, x.abs().amax(), precision)


def _w(w: torch.Tensor, precision: str, out_dim: int) -> torch.Tensor:
    """A weight as the precision stores it, one scale per output channel
    (axis ``out_dim``)."""
    if precision == "f32":
        return w
    dims = [d for d in range(w.ndim) if d != out_dim]
    return _round(w, w.abs().amax(dim=dims, keepdim=True), precision)


def conv(x, p, name, relu=False, stride=1, bias=True, precision="f32"):
    """3x3 conv, zero padding 1, of NCHW ``x`` with ``<name>/kernel`` (HWIO)
    and ``<name>/bias``."""
    w = p[f"{name}/kernel"] if f"{name}/kernel" in p else p[f"{name}_kernel"]
    w = _w(w.permute(3, 2, 0, 1), precision, 0)
    b = None
    if bias:
        b = p[f"{name}/bias"] if f"{name}/bias" in p else p[f"{name}_bias"]
        b = rnd(b, precision)
    y = F.conv2d(x, w, b, stride=stride, padding=(w.shape[-1] - 1) // 2)
    return rnd(torch.relu(y) if relu else y, precision)


def dense(x, p, name, precision="f32"):
    """``x @ kernel + bias`` with ``<name>/kernel`` (in, out)."""
    w = _w(p[f"{name}/kernel"] if f"{name}/kernel" in p
           else p[f"{name}_kernel"], precision, 1)
    b = p[f"{name}/bias"] if f"{name}/bias" in p else p[f"{name}_bias"]
    return rnd(x @ w + rnd(b, precision), precision)


def patch_embed(x, kernel, bias, precision="f32"):
    """Conv with kernel = stride = ps, no padding: NCHW (N, C, H, W) ->
    tokens (N, H/ps, W/ps, D); ``kernel`` (ps, ps, C, D)."""
    w = _w(kernel.permute(3, 2, 0, 1), precision, 0)
    y = F.conv2d(x, w, rnd(bias, precision), stride=kernel.shape[0])
    return rnd(y.permute(0, 2, 3, 1), precision)


def patch_unembed(tokens, kernel, bias, precision="f32"):
    """Transposed conv with kernel = stride = ps: tokens (N, Ht, Wt, D) ->
    NCHW (N, C, Ht*ps, Wt*ps); ``kernel`` (D, ps, ps, C)."""
    w = _w(kernel.permute(0, 3, 1, 2), precision, 1)
    return rnd(F.conv_transpose2d(tokens.permute(0, 3, 1, 2), w,
                                  rnd(bias, precision),
                                  stride=kernel.shape[1]), precision)


def relative_index(ws: int) -> torch.Tensor:
    """Swin's (ws^2, ws^2) index into the ((2 ws - 1)^2, heads) table:
    (dy + ws - 1) * (2 ws - 1) + (dx + ws - 1) for token pairs."""
    yy, xx = torch.meshgrid(torch.arange(ws), torch.arange(ws),
                            indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    dy = yy[:, None] - yy[None, :] + ws - 1
    dx = xx[:, None] - xx[None, :] + ws - 1
    return dy * (2 * ws - 1) + dx


def window_block(x, p, prefix, heads, ws, precision="f32"):
    """One pre-LN Swin-style block (no shift) on windows x (nW, ws^2, C):
    multi-head attention with a relative position bias, then a 4x MLP with
    exact GELU, each with its residual."""
    nw, n, c = x.shape
    hd = c // heads
    y = rnd(F.layer_norm(x, (c,), p[f"{prefix}/norm1/scale"],
                         p[f"{prefix}/norm1/bias"], eps=1e-5), precision)
    qkv = dense(y, p, f"{prefix}/attn/qkv", precision)
    qkv = qkv.reshape(nw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    table = p[f"{prefix}/attn/bias_table"]
    bias = table[relative_index(ws).to(table.device).reshape(-1)]
    bias = bias.reshape(n, n, heads).permute(2, 0, 1)
    attn = rnd(torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1),
               precision)
    ctx = rnd((attn @ v).permute(0, 2, 1, 3).reshape(nw, n, c), precision)
    x = rnd(x + dense(ctx, p, f"{prefix}/attn/proj", precision), precision)
    z = rnd(F.layer_norm(x, (c,), p[f"{prefix}/norm2/scale"],
                         p[f"{prefix}/norm2/bias"], eps=1e-5), precision)
    h = rnd(F.gelu(dense(z, p, f"{prefix}/mlp_fc1", precision)), precision)
    return rnd(x + dense(h, p, f"{prefix}/mlp_fc2", precision), precision)


def window_trunk(tokens, p, blocks, heads, ws, precision="f32"):
    """tokens (N, Ht, Wt, D): the grid zero-padded at the bottom and right
    to whole windows (the padding tokens go through the blocks as ordinary
    tokens), ``blocks`` blocks over non-overlapping ws x ws windows,
    unpadded."""
    n, ht, wt, d = tokens.shape
    hp, wp = math.ceil(ht / ws) * ws, math.ceil(wt / ws) * ws
    t = F.pad(tokens, (0, 0, 0, wp - wt, 0, hp - ht))
    win = (t.reshape(n, hp // ws, ws, wp // ws, ws, d)
           .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, d))
    for i in range(blocks):
        win = window_block(win, p, f"blocks_{i}", heads, ws, precision)
    t = (win.reshape(n, hp // ws, wp // ws, ws, ws, d)
         .permute(0, 1, 3, 2, 4, 5).reshape(n, hp, wp, d))
    return t[:, :ht, :wt]


def padded_windows(ht: int, wt: int, ws: int) -> int:
    """Windows of the padded token grid of one frame."""
    return math.ceil(ht / ws) * math.ceil(wt / ws)


def trunk_flops(tokens: int, dim: int, blocks: int, ws: int) -> float:
    """Multiply-adds x 2 of ``blocks`` window blocks over ``tokens`` tokens
    of the padded window grid: qkv, proj, fc1, fc2 (12 dim^2 a token) and
    the two attention products (2 ws^2 dim a token)."""
    return blocks * tokens * (2.0 * 12 * dim * dim + 2.0 * 2 * ws * ws * dim)


def conv_flops(h: int, w: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * k * k * cin * cout


def resize_flops(in_hw, out_hw, channels: int, taps_per_unit: float) -> float:
    """Two separable passes, height then width; each output value takes
    ``taps_per_unit`` x max(1, in / out) input taps, a multiply-add each."""
    (ih, iw), (oh, ow) = in_hw, out_hw
    th = taps_per_unit * max(1.0, ih / oh)
    tw = taps_per_unit * max(1.0, iw / ow)
    return 2.0 * channels * (oh * iw * th + oh * ow * tw)
