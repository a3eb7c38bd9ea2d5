"""WindowTransformer: resolution-agnostic window-attention upscaler.

JAX counterpart: transformerupscaler_tpu models/window_transformer.py:28-122.
Pipeline: two 3x3 convs to 64 channels with ReLU, a stride-2 downsample, an
8x8/8 patch embed to dim 128, eight window blocks (8 heads of 16, windows of
8x8 tokens), the patch unembed, a skip add cropped to the common extent, two
decoder convs, and the bicubic upscale of that residual added to the bicubic
upscale of the input, clipped to [0, 1].

Kernels (``pallas_serve`` and ``attn_impl`` as in the JAX model):

  conv1 3->64 + ReLU          ops.conv.conv2d
  conv2 64->64 + ReLU         pallas_serve at base_channels 64, h % 8 == 0,
                              w % 16 == 0: kernels.stream.conv3x3_stream
                              (JAX: conv3x3_packed_stream); else ops.conv.conv2d
  window blocks               attn_impl "fused2" / "fused": all eight in one
                              kernels.trunk2.fused_window_trunk launch, mode
                              "v2" / "v1" (JAX: trunk2.py / trunk.py, the
                              route ``--fast`` picks); "pallas": each block's
                              attention core on
                              kernels.window_attn.window_attention_core;
                              "xla": plain PyTorch
  everything else             plain PyTorch, as it is XLA in the JAX package

``int8_mlp`` (window_transformer.py:40, 59) runs each block's MLP as two
int8 products (``models.common.WindowBlock``) under ``attn_impl`` "xla" and
"pallas"; the fused trunks ignore it, as in JAX.

In train mode (``train()``, JAX's ``deterministic=False``) the forward runs
under autograd on plain PyTorch only: conv2 as ``conv2d``, the blocks in
PyTorch with ``dropout`` (0.01) drawn from the forward's ``generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from transformerupscaler_torch.kernels.stream import conv3x3_stream
from transformerupscaler_torch.models.common import (
    TRUNK_IMPLS,
    ConvLayer,
    FusedTrunk,
    WindowBlock,
    dropout_for,
    inference_unless_training,
    param,
    resolve_geometry,
)
from transformerupscaler_torch.ops.patch import patch_embed, patch_unembed
from transformerupscaler_torch.ops.resize import interpolate_bicubic


class WindowTransformer(FusedTrunk, nn.Module):
    """WindowTransformer. Parameters are f32 in the JAX layout (see
    ``transformerupscaler_torch.weights``); compute runs in ``dtype``.
    Input x: (B, H, W, 3) in [0, 1]; output (B, res_out..., 3). Serves in
    eval mode; trains in train mode (module docstring)."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 transformer_dim: int = 128, num_window_blocks: int = 8,
                 num_heads: int = 8, mlp_ratio: float = 4.0,
                 window_size: int = 8, patch_size: int = 8,
                 attn_impl: str = "xla", pallas_serve: bool = False,
                 int8_mlp: bool = False, dtype=torch.float32,
                 dropout: float = 0.01):
        super().__init__()
        bc, td, ps, ic = base_channels, transformer_dim, patch_size, in_channels
        if attn_impl not in TRUNK_IMPLS:
            raise ValueError(f"attn_impl: one of {TRUNK_IMPLS}, got "
                             f"{attn_impl!r}")
        self.base_channels = bc
        self.window_size = window_size
        self.patch_size = ps
        self.attn_impl = attn_impl
        self.pallas_serve = pallas_serve
        self.int8_mlp = int8_mlp
        self.dtype = dtype
        self.dropout = dropout
        self.conv1 = ConvLayer(ic, bc, relu=True)
        self.conv2 = ConvLayer(bc, bc, relu=True)
        self.downsample = ConvLayer(bc, bc, stride=2)
        self.patch_embed_kernel = param(ps, ps, bc, td)
        self.patch_embed_bias = param(td)
        self.blocks = nn.ModuleList(
            WindowBlock(td, window_size, num_heads, mlp_ratio, int8_mlp)
            for _ in range(num_window_blocks))
        self.patch_unembed_kernel = param(td, ps, ps, bc)
        self.patch_unembed_bias = param(bc)
        self.decoder_conv1 = ConvLayer(bc, bc, relu=True)
        self.decoder_conv2 = ConvLayer(bc, ic)
        self.clear_derived()
        self.eval()

    @inference_unless_training
    def forward(self, x: torch.Tensor, res_out=(1080, 1920),
                upscale_factor: int | None = None,
                require_ratio: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout masks' source in train mode."""
        del require_ratio  # accepted and unused, as in the reference
        res_out, _ = resolve_geometry(x.shape[1:3], res_out, upscale_factor)
        dt = self.dtype
        x = x.to(dt)
        upscaled_input = interpolate_bicubic(x, res_out)

        h0, w0 = x.shape[1:3]
        if (self.pallas_serve and not self.training
                and self.base_channels == 64 and h0 % 8 == 0
                and w0 % 16 == 0):
            feat = conv3x3_stream(self.conv1(x), self.conv2.kernel.to(dt),
                                  self.conv2.bias, relu=True)
        else:
            feat = self.conv2(self.conv1(x))
        feat_down = self.downsample(feat)

        # The patch embed floors non-divisible extents like a strided conv.
        ps = self.patch_size
        hd, wd = feat_down.shape[1:3]
        ht, wt = hd // ps, wd // ps
        tokens = patch_embed(feat_down[:, :ht * ps, :wt * ps, :],
                             self.patch_embed_kernel, self.patch_embed_bias)
        tokens = self.run_trunk(tokens, dropout_for(self, generator))
        feat_trans = patch_unembed(tokens, self.patch_unembed_kernel,
                                   self.patch_unembed_bias)

        # Both maps are cropped to the common extent before the skip add.
        mh, mw = min(hd, feat_trans.shape[1]), min(wd, feat_trans.shape[2])
        combined = feat_down[:, :mh, :mw, :] + feat_trans[:, :mh, :mw, :]

        residual = self.decoder_conv2(self.decoder_conv1(combined))
        out = upscaled_input + interpolate_bicubic(residual, res_out)
        return out.clamp(0.0, 1.0)
