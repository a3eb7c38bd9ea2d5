"""The window-attention core as a Hopper kernel: per window and head,
softmax(q k^T + relative-position bias) v. Wrapper and plain PyTorch version.

=========================  ====================  ================================
wrapper                    CUDA source           TPU kernel it replaces
=========================  ====================  ================================
``window_attention_core``  csrc/window_attn.cu   ops/pallas/window_attn.py:58
                                                 ``fused_window_attention``
=========================  ====================  ================================

The qkv and output products stay outside the kernel, as they stay outside the
TPU kernel's body (window_attn.py:68, :99); ``ops.attention.window_attention``
with ``impl="pallas"`` wraps them around this core. The TPU function hands its
body q, k, v transposed to (C, N), tokens on the lanes; that layout is not
carried: the core takes the (windows, N, 3C) tensor the qkv product leaves.

Rounding points (window_attn.py:44-55 and :71-72), with ``dt`` the dtype of
``qkv``: q * head_dim^-0.5 in ``dt``; scores in f32 plus the f32 bias; max,
exp, sum and the division in f32; the probabilities rounded to ``dt``; P.V
accumulated in f32 and rounded once to ``dt``.

A wrapper given CPU tensors computes the plain version (any shape); given CUDA
tensors it launches the kernel, adds one to
``LAUNCHES["window_attention_core"]`` and never falls back (no windows: no
launch, nothing counted). ``window_attention_empty`` launches the source's
empty kernel on the core's grid, the floor a launch of that grid costs.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels._common import (
    LAUNCHES,
    check,
    on_card,
    raise_on,
    stream_of,
)

# What the CUDA kernel is compiled for.
TOKENS, HEAD_DIM, MAX_DIM = 64, 16, 256


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Plain version of ``window_attention_core``; any widths."""
    nw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    dt = qkv.dtype
    q, k, v = (t.reshape(nw, n, num_heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))  # (nW, heads, n, hd)
    q = q * torch.tensor(hd ** -0.5, dtype=dt)
    s = q.float() @ k.float().transpose(-1, -2) + bias.float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    ctx = (p.float() @ v.float()).to(dt)
    return ctx.transpose(1, 2).reshape(nw, n, c)


def window_attention_core(qkv: torch.Tensor, bias: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Attention inside each window.

    qkv: (windows, N, 3C), q in channels [0, C), k in [C, 2C), v in [2C, 3C),
    head h in channels [h C/heads, (h+1) C/heads) of each; bias:
    (heads, N, N) f32, added to the scaled scores. Returns (windows, N, C) in
    qkv's dtype. On the card: bf16, N = 64, 16 channels a head, C <= 256.
    """
    if not on_card(qkv, bias):
        return window_attention_plain(qkv, bias, num_heads)
    nw, n, c3 = qkv.shape
    c = c3 // 3
    if (n != TOKENS or c3 != 3 * c or c != HEAD_DIM * num_heads
            or c > MAX_DIM):
        raise ValueError(
            f"window_attention_core: the kernel takes {TOKENS} tokens and "
            f"heads of {HEAD_DIM} channels up to C = {MAX_DIM}; got qkv "
            f"{tuple(qkv.shape)} with {num_heads} heads")
    check(qkv, "qkv", torch.bfloat16, (nw, TOKENS, 3 * c))
    check(bias, "bias", torch.float32, (num_heads, TOKENS, TOKENS))
    out = torch.empty(nw, TOKENS, c, dtype=torch.bfloat16, device=qkv.device)
    if nw == 0:
        return out
    err = _build.load("window_attn").tux_window_attn(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), nw, c, num_heads,
        qkv.device.index, stream_of(qkv))
    raise_on(err, "window_attention_core")
    LAUNCHES["window_attention_core"] += 1
    return out


def window_attention_empty(n_windows: int, num_heads: int,
                           device: torch.device) -> None:
    """Launch csrc/window_attn.cu's empty kernel on the grid the core takes
    for ``n_windows`` windows of ``num_heads`` heads (``chip_smoke.py``
    times it beside the core). Counted by no wrapper."""
    err = _build.load("window_attn").tux_window_attn_empty(
        n_windows, num_heads, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    raise_on(err, "window_attention_empty")
