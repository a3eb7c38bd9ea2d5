"""Window multi-head self-attention with relative position bias, and global
multi-head self-attention.

JAX counterpart: transformerupscaler_tpu ops/attention.py:33
(``window_attention``) and :81 (``multihead_attention``). The eager forms are
written out as matrix products rather than a fused attention call so that the
roundings follow the reference: the qkv and output projections run in the
activation dtype, the scores and the softmax in f32, and the probabilities
are rounded to the activation dtype before the product with v. Dense weights
are (in, out).

``impl`` follows the JAX ``attn_impl``. ``window_attention``: "xla" is the
eager form, "pallas" puts ``kernels.window_attn.window_attention_core``
between the two projections. ``multihead_attention``: "xla" is the eager
form, which materializes the (B, heads, N, N) f32 scores; any other value puts
``kernels.gmha.global_mha`` between the two projections.

``drop`` (a ``models.common.Dropout``, train mode) drops at JAX's sites:
window attention's probabilities and its projected output
(ops/attention.py:69-77), global attention's probabilities (:123-125).
A caller in train mode passes impl "xla": the kernels have no backward.

The eager forms call ``parallel.context.maybe_shard_heads`` on q, k and v
where the JAX ops do: under ``activation_sharding`` with a ``model`` axis
above 1, each group of heads computes its scores, softmax and context on
its own device, and the contexts are gathered back (``parallel.context``).
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels.gmha import global_mha
from transformerupscaler_torch.kernels.window_attn import window_attention_core
from transformerupscaler_torch.ops.relpos import gather_relative_bias
from transformerupscaler_torch.parallel.context import (
    gather_heads,
    maybe_shard_heads,
)

WINDOW_IMPLS = ("xla", "pallas")


def window_attention(x: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
                     bias_table, num_heads: int, window_size: int,
                     impl: str = "xla", drop=None) -> torch.Tensor:
    """x: (B, N, C) with N == window_size**2 tokens per window."""
    if impl not in WINDOW_IMPLS:
        raise ValueError(f"impl: one of {WINDOW_IMPLS}, got {impl!r}")
    b, n, c = x.shape
    dt = x.dtype
    hd = c // num_heads
    qkv = x @ qkv_w.to(dt) + qkv_b.to(dt)
    bias = gather_relative_bias(bias_table.float(), window_size)
    if impl == "pallas":
        if drop is not None:
            raise ValueError("dropout runs on the eager form (impl='xla')")
        out = window_attention_core(qkv, bias.contiguous(), num_heads)
        return out @ proj_w.to(dt) + proj_b.to(dt)
    qkv = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, hd)
    q, k, v = maybe_shard_heads(q), maybe_shard_heads(k), maybe_shard_heads(v)
    if isinstance(q, list):  # head groups on their devices
        ctx = gather_heads([
            _heads(qg * hd ** -0.5, kg, vg, bg, dt, drop)
            for qg, kg, vg, bg in zip(q, k, v, maybe_shard_heads(bias))],
            x.device)
    else:
        ctx = _heads(q * hd ** -0.5, k, v, bias, dt, drop)
    out = ctx.permute(0, 2, 1, 3).reshape(b, n, c)
    out = out @ proj_w.to(dt) + proj_b.to(dt)
    return out if drop is None else drop(out)


def _heads(q, k, v, bias, dt, drop):
    """softmax(q k^T + bias) v over (B, H, N, hd) heads: the scores and the
    softmax in f32, the probabilities rounded to ``dt`` (and dropped) before
    the product with v."""
    attn = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        attn = attn + bias
    attn = torch.softmax(attn, dim=-1).to(dt)
    if drop is not None:
        attn = drop(attn)
    return attn @ v


def multihead_attention(x: torch.Tensor, in_w, in_b, out_w, out_b,
                        num_heads: int, impl: str = "xla",
                        drop=None) -> torch.Tensor:
    """Self-attention as ``nn.MultiheadAttention(batch_first=True)`` computes
    it. x: (B, N, C); in_w: (C, 3C) packed q/k/v projection; out_w: (C, C)."""
    b, n, c = x.shape
    dt = x.dtype
    hd = c // num_heads
    qkv = x @ in_w.to(dt) + in_b.to(dt)
    if impl != "xla":
        if drop is not None:
            raise ValueError("dropout runs on the eager form (impl='xla')")
        ctx = global_mha(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                         num_heads)
        return ctx @ out_w.to(dt) + out_b.to(dt)
    qkv = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, hd)
    q, k, v = maybe_shard_heads(q), maybe_shard_heads(k), maybe_shard_heads(v)
    scale = torch.tensor(hd ** -0.5, dtype=dt)
    if isinstance(q, list):  # head groups on their devices
        ctx = gather_heads([_heads(qg * scale, kg, vg, None, dt, drop)
                            for qg, kg, vg in zip(q, k, v)], x.device)
    else:
        ctx = _heads(q * scale, k, v, None, dt, drop)
    out = ctx.permute(0, 2, 1, 3).reshape(b, n, c)
    return out @ out_w.to(dt) + out_b.to(dt)
