"""The patch embed and unembed + add of the JAX package's archived
``ops/pallas/patch_kernels.py``, served by the serving path's patch kernels
(``csrc/patch_gemm.cu``) with the archived functions' own rounding points.

===========================  =====================  ===========================
wrapper                      kernel it launches     TPU kernel it replaces
===========================  =====================  ===========================
``fused_patch_embed``        ``embed_stream``'s     ops/pallas/patch_kernels.py
                                                    :50 ``fused_patch_embed``
``fused_patch_unembed_add``  ``unembed_combine_     ops/pallas/patch_kernels.py
                             stream``'s, epilogue   :106
                             option round_steps     ``fused_patch_unembed_add``
===========================  =====================  ===========================

``fused_patch_embed`` is ``embed_stream`` with the bias rounded to x's
dtype first (patch_kernels.py:87), then added in f32 before the one
rounding. ``fused_patch_unembed_add`` rounds three times where
``unembed_combine_stream`` rounds once (patch_kernels.py:99-103, 126): y =
dt(tokens @ W) from the f32 sum, then y + dt(bias) in dt, then + feat in
dt. No model reaches them (the JAX package's tests and its TPU probe
``tools/serve_bench.py`` call them). Given CPU tensors each computes its
plain version; given CUDA tensors (bf16, D % 64 == 0 for the embed, D % 16
== 0 and D <= 512 for the unembed) it launches the kernel and adds one to
its own count in ``ARCHIVED_LAUNCHES``, not to the serving wrapper's.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels._common import ARCHIVED_LAUNCHES, on_card
from transformerupscaler_torch.kernels.stream import (
    embed_launch,
    embed_plain,
    unembed_launch,
)


def _rounded(bias, dtype):
    return None if bias is None else bias.to(dtype)


def fused_patch_embed_plain(x, kernel, bias=None):
    """Plain version of ``fused_patch_embed``."""
    return embed_plain(x, kernel, _rounded(bias, x.dtype))


def fused_patch_embed(x: torch.Tensor, kernel: torch.Tensor, bias=None,
                      token_rows_per_cell: int | None = None) -> torch.Tensor:
    """8x8/8 patch embed: x (B, 8 Ht, 8 Wt, 64), kernel (8, 8, 64, D) and
    bias (D,) both rounded to x's dtype. Returns (B, Ht, Wt, D) in x's
    dtype. ``token_rows_per_cell`` is a TPU tiling, accepted and ignored."""
    del token_rows_per_cell
    if not on_card(x, kernel, bias):
        return fused_patch_embed_plain(x, kernel, bias)
    out = embed_launch(x, kernel, _rounded(bias, x.dtype))
    ARCHIVED_LAUNCHES["fused_patch_embed"] += 1
    return out


def fused_patch_unembed_add_plain(tokens, feat, kernel, bias=None):
    """Plain version of ``fused_patch_unembed_add``: the f32 product
    rounded to tokens' dtype, then the bias and feat added in that dtype."""
    b, ht, wt, d = tokens.shape
    _, ps, _, c = kernel.shape
    dt = tokens.dtype
    y = (tokens.float() @ kernel.to(dt).float().reshape(d, -1)).to(dt)
    y = (y.reshape(b, ht, wt, ps, ps, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, ht * ps, wt * ps, c))
    if bias is not None:
        y = y + bias.to(dt)
    return (y + feat).to(dt)


def fused_patch_unembed_add(tokens: torch.Tensor, feat: torch.Tensor,
                            kernel: torch.Tensor, bias=None,
                            token_rows_per_cell: int | None = None
                            ) -> torch.Tensor:
    """``patch_unembed(tokens) + feat`` in one pass, rounded as the archived
    kernel rounds: tokens (B, Ht, Wt, D), feat (B, 8 Ht, 8 Wt, 64), kernel
    (D, 8, 8, 64) rounded to tokens' dtype, bias (64,). Returns (B, 8 Ht,
    8 Wt, 64) in tokens' dtype. ``token_rows_per_cell`` is a TPU tiling,
    accepted and ignored."""
    del token_rows_per_cell
    if not on_card(tokens, feat, kernel, bias):
        return fused_patch_unembed_add_plain(tokens, feat, kernel, bias)
    out = unembed_launch(tokens, feat, kernel, _rounded(bias, tokens.dtype),
                         round_steps=True)
    ARCHIVED_LAUNCHES["fused_patch_unembed_add"] += 1
    return out
