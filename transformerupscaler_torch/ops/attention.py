"""Window multi-head self-attention with relative position bias.

JAX counterpart: transformerupscaler_tpu ops/attention.py:56-78 (the XLA
path). Written out as matrix products rather than a fused attention call so
that the roundings follow the reference: the qkv and output projections run
in the activation dtype, the scores and the softmax in f32, and the
probabilities are rounded to the activation dtype before the product with v.
Dense weights are (in, out).
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.ops.relpos import gather_relative_bias


def window_attention(x: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
                     bias_table, num_heads: int,
                     window_size: int) -> torch.Tensor:
    """x: (B, N, C) with N == window_size**2 tokens per window."""
    b, n, c = x.shape
    dt = x.dtype
    hd = c // num_heads
    qkv = x @ qkv_w.to(dt) + qkv_b.to(dt)
    qkv = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, hd)
    q = q * hd ** -0.5
    attn = q.float() @ k.float().transpose(-1, -2)
    attn = attn + gather_relative_bias(bias_table.float(), window_size)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = (attn @ v).permute(0, 2, 1, 3).reshape(b, n, c)
    return out @ proj_w.to(dt) + proj_b.to(dt)
