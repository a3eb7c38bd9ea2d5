"""Patch embedding and unembedding as a block reshape and one matrix product.

JAX counterpart: transformerupscaler_tpu ops/patch.py:18 (``patch_embed``) and
:129 (``patch_unembed``); their width-2 packed forms (:36, :58) compute the
same sums on a TPU layout and map to these. Kernel size equals stride with no
padding, so a conv / transposed conv is exactly this. Any widths; the products
run in the activation dtype, as the JAX ops' do. (FastTransformer's 192-wide
serving path uses the ``embed_stream`` / ``unembed_combine_stream`` kernels
instead; its all-XLA packed path, ``pallas_serve=False``, these.)

``patch_embed_int8`` / ``patch_unembed_int8`` are the int8 GEMMs of the all-XLA
path's "full" and "residual" scopes (``patch_embed_packed_int8`` /
``patch_unembed_packed_int8``, :77-126): the activation scale folds into the
f32 weights, which are quantized per output column, and the int8 products sum
exactly in int32 (``ops.conv.int_mm``). The packed forms permute the rows or
columns of the weights only, so each column's scale and values are these.

Weight layouts: embed kernel (ps, ps, C_in, D); unembed kernel
(D, ps, ps, C_out).
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.ops.conv import int_mm
from transformerupscaler_torch.ops.quant import div127


def patch_embed(x: torch.Tensor, kernel: torch.Tensor,
                bias=None) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/ps, W/ps, D). H, W must be multiples of ps."""
    ps = kernel.shape[0]
    b, h, w, c = x.shape
    ht, wt = h // ps, w // ps
    if ht == 0 or wt == 0:
        raise ValueError(f"input {h}x{w} is smaller than the patch size {ps}; "
                         f"the token grid would be empty")
    patches = (x.reshape(b, ht, ps, wt, ps, c).permute(0, 1, 3, 2, 4, 5)
               .reshape(b, ht, wt, ps * ps * c))
    out = patches @ kernel.reshape(ps * ps * c, -1).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def patch_unembed(tokens: torch.Tensor, kernel: torch.Tensor,
                  bias=None) -> torch.Tensor:
    """(B, Ht, Wt, D) -> (B, Ht*ps, Wt*ps, C)."""
    d, ps, _, c = kernel.shape
    b, ht, wt, _ = tokens.shape
    out = tokens @ kernel.reshape(d, ps * ps * c).to(tokens.dtype)
    out = (out.reshape(b, ht, wt, ps, ps, c).permute(0, 1, 3, 2, 4, 5)
           .reshape(b, ht * ps, wt * ps, c))
    if bias is not None:
        out = out + bias.to(tokens.dtype)
    return out


def _quantize_columns(k2: torch.Tensor):
    """(kq int8, ks f32 (1, N)) of an f32 (K, N) matrix, per column: ks =
    max_k |k| / 127, 1 where that is 0; kq = clip(round(k / ks), -127,
    127)."""
    ks = div127(k2.abs().amax(dim=0, keepdim=True))
    ks = torch.where(ks == 0, torch.ones_like(ks), ks)
    return torch.clamp(torch.round(k2 / ks), -127, 127).to(torch.int8), ks


def patch_embed_int8(xq: torch.Tensor, x_scale, kernel: torch.Tensor,
                     bias=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``patch_embed`` of an int8 map ``xq`` (B, H, W, C) quantized per
    channel with ``x_scale`` (C,): keff = kernel * x_scale in f32, quantized
    per output column; y = f32(sum xq * kq) * ks + bias in f32, rounded once
    to ``out_dtype``. Returns (B, H/ps, W/ps, D)."""
    ps, _, c, d = kernel.shape
    b, h, w, _ = xq.shape
    ht, wt = h // ps, w // ps
    patches = (xq.reshape(b, ht, ps, wt, ps, c).permute(0, 1, 3, 2, 4, 5)
               .reshape(b * ht * wt, ps * ps * c))
    s = torch.as_tensor(x_scale, dtype=torch.float32, device=kernel.device)
    keff = kernel.to(torch.float32) * s.reshape(1, 1, -1, 1)
    kq, ks = _quantize_columns(keff.reshape(ps * ps * c, d))
    y = int_mm(patches, kq).to(torch.float32) * ks
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype).reshape(b, ht, wt, d)


def patch_unembed_int8(tq: torch.Tensor, t_scale, kernel: torch.Tensor,
                       bias=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``patch_unembed`` of int8 tokens ``tq`` (B, Ht, Wt, D) quantized per
    channel with ``t_scale`` (D,): keff = kernel * t_scale in f32, quantized
    per output column (ps, ps, C); y = f32(sum tq * kq) * ks, scattered to
    (B, Ht ps, Wt ps, C), + bias in f32, rounded once to ``out_dtype``."""
    d, ps, _, c = kernel.shape
    b, ht, wt, _ = tq.shape
    s = torch.as_tensor(t_scale, dtype=torch.float32, device=kernel.device)
    keff = kernel.to(torch.float32) * s.reshape(-1, 1, 1, 1)
    kq, ks = _quantize_columns(keff.reshape(d, ps * ps * c))
    y = int_mm(tq.reshape(-1, d), kq).to(torch.float32) * ks
    y = (y.reshape(b, ht, wt, ps, ps, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, ht * ps, wt * ps, c))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)
