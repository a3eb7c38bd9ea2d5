"""Patch embedding and unembedding as a block reshape and one matrix product.

JAX counterpart: transformerupscaler_tpu ops/patch.py:18 (``patch_embed``) and
:129 (``patch_unembed``); their width-2 packed forms (:36, :58) compute the
same sums on a TPU layout and map to these. Kernel size equals stride with no
padding, so a conv / transposed conv is exactly this. Any widths; the products
run in the activation dtype, as the JAX ops' do. (FastTransformer's 192-wide
serving path uses the ``embed_stream`` / ``unembed_combine_stream`` kernels
instead.)

Weight layouts: embed kernel (ps, ps, C_in, D); unembed kernel
(D, ps, ps, C_out).
"""

from __future__ import annotations

import torch


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
