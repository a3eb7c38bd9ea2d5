"""ResidualTransformer: global-attention upscaler with a fixed token grid.

JAX counterpart: transformerupscaler_tpu models/residual_transformer.py:31-280.
Pipeline: two 3x3 convs to 64 channels with ReLU, a stride-2 downsample, an
8x8/8 patch embed to dim 128 (45x80 = 3600 tokens from a 720x1280 frame), a
learned absolute ``pos_embed``, eight blocks of global attention (8 heads of
16) with a 4x exact-GELU MLP, the patch unembed, a skip add, two decoder convs,
and the bicubic upscale of that residual added to the bicubic upscale of the
input, clipped to [0, 1]. The positional embedding fixes the token grid
(``token_hw``): another input size raises ``ValueError``.

Routes, as in the JAX model:

- the exact ``forward``: every conv through ``ops.conv.conv2d``;
- ``packed_serve=True`` at an integer scale >= 2 with h % 2 == 0 and
  w % 16 == 0 takes ``_packed_forward``. The JAX method runs the same
  arithmetic on the TPU's width-2 packed layout, which is not carried: here it
  is NHWC. With ``pallas_serve=True`` conv2 and ``decoder_conv1`` run on
  ``kernels.stream.conv3x3_stream`` (JAX: ``conv3x3_packed_stream``). Both
  bicubic branches are the resize products (the JAX default,
  ``TUX_RESID_BICUBIC=matmul``);
- on either route ``attn_impl`` other than "xla" puts each block's attention
  core on ``kernels.gmha.global_mha``.

The packed route reads JAX's two switches at each forward, as JAX reads
them at trace time (residual_transformer.py:244-255, 264-301):

- ``TUX_RESID_DEC_PALLAS`` other than "1" under ``pallas_serve``:
  ``decoder_conv1`` runs as JAX's XLA conv (``conv2d_packed_raw``): a plain
  conv rounded to the dtype, then the dtype bias, then ReLU; the stream
  kernel then launches once a frame (conv2), not twice;
- ``TUX_RESID_BICUBIC`` other than "matmul": both bicubic branches are
  ``ops.resize.bicubic_upscale_conv`` convs emitting pixel-shuffle
  channels, the residual's at 2 x scale from half resolution, its channels
  permuted and shuffled by 2 onto the full-resolution grid, added to the
  input's and shuffled once by the scale.

In train mode (``train()``, JAX's ``deterministic=False``) the exact route
runs under autograd with the eager attention whatever ``attn_impl`` says,
and ``dropout`` (0.1) on the attention probabilities and each block's MLP
output, drawn from the forward's ``generator``.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn as nn

from transformerupscaler_torch.kernels.stream import conv3x3_stream
from transformerupscaler_torch.models.common import (
    ConvLayer,
    Dense,
    Dropout,
    LayerNorm,
    dropout_for,
    gelu,
    inference_unless_training,
    param,
    resolve_geometry,
)
from transformerupscaler_torch.ops.attention import multihead_attention
from transformerupscaler_torch.ops.patch import patch_embed, patch_unembed
from transformerupscaler_torch.ops.pixel_shuffle import pixel_shuffle
from transformerupscaler_torch.ops.resize import (
    bicubic_upscale_conv,
    interpolate_bicubic,
)


@functools.lru_cache(maxsize=None)
def _resid_perm(r: int, device) -> torch.Tensor:
    """The channel order ((c, i, j), a, b) of the residual's pre-shuffle
    channels (c, a r + i, b r + j) at 2 r (residual_transformer.py:289-297),
    on ``device``, made once outside inference mode."""
    perm = [(c * 2 * r + a * r + i) * 2 * r + bb * r + j
            for c in range(3) for i in range(r) for j in range(r)
            for a in range(2) for bb in range(2)]
    with torch.inference_mode(False):
        return torch.tensor(perm, device=device)



class GlobalAttentionBlock(nn.Module):
    """Pre-LN global multi-head attention + pre-LN 4x exact-GELU MLP, with
    residuals, and in train mode ``drop`` on the attention probabilities and
    the MLP's output (``mlp_drop``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.in_kernel = param(dim, 3 * dim)
        self.in_bias = param(3 * dim)
        self.out_kernel = param(dim, dim)
        self.out_bias = param(dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim)
        self.num_heads = num_heads

    def forward(self, x, impl: str = "xla", drop: Dropout | None = None):
        x = x + multihead_attention(self.norm1(x), self.in_kernel,
                                    self.in_bias, self.out_kernel,
                                    self.out_bias, self.num_heads, impl, drop)
        y = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))
        return x + (y if drop is None else drop(y))


class ResidualTransformer(nn.Module):
    """ResidualTransformer. Parameters are f32 in the JAX layout (see
    ``transformerupscaler_torch.weights``); compute runs in ``dtype``. Input
    x: (B, H, W, 3) in [0, 1] with H / 16 x W / 16 equal to ``token_hw``;
    output (B, res_out..., 3). Serves in eval mode; trains in train mode
    (module docstring)."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 transformer_dim: int = 128, num_transformer_blocks: int = 8,
                 num_heads: int = 8, mlp_ratio: float = 4.0,
                 patch_size: int = 8, token_hw: tuple[int, int] = (45, 80),
                 packed_serve: bool = False, pallas_serve: bool = False,
                 attn_impl: str = "xla", dtype=torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        bc, td, ps, ic = base_channels, transformer_dim, patch_size, in_channels
        self.token_hw = tuple(token_hw)
        self.packed_serve = packed_serve
        self.pallas_serve = pallas_serve
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.dropout = dropout
        self.conv1 = ConvLayer(ic, bc, relu=True)
        self.conv2 = ConvLayer(bc, bc, relu=True)
        self.downsample = ConvLayer(bc, bc, stride=2)
        self.patch_embed_kernel = param(ps, ps, bc, td)
        self.patch_embed_bias = param(td)
        self.pos_embed = param(1, self.token_hw[0] * self.token_hw[1], td)
        self.blocks = nn.ModuleList(
            GlobalAttentionBlock(td, num_heads, mlp_ratio)
            for _ in range(num_transformer_blocks))
        self.patch_unembed_kernel = param(td, ps, ps, bc)
        self.patch_unembed_bias = param(bc)
        self.decoder_conv1 = ConvLayer(bc, bc, relu=True)
        self.decoder_conv2 = ConvLayer(bc, ic)
        self.eval()

    def _transformer(self, feat_down: torch.Tensor,
                     drop: Dropout | None = None) -> torch.Tensor:
        """Embed, add ``pos_embed``, run the blocks (in train mode the eager
        attention, with ``drop``), unembed."""
        tokens = patch_embed(feat_down, self.patch_embed_kernel,
                             self.patch_embed_bias)
        b, ht, wt, d = tokens.shape
        if (ht, wt) != self.token_hw:
            raise ValueError(
                f"ResidualTransformer pos_embed is baked for token grid "
                f"{self.token_hw} ({16 * self.token_hw[0]}x"
                f"{16 * self.token_hw[1]} input); got {(ht, wt)}")
        seq = tokens.reshape(b, ht * wt, d) + self.pos_embed.to(self.dtype)
        impl = "xla" if self.training else self.attn_impl
        for block in self.blocks:
            seq = block(seq, impl, drop)
        return patch_unembed(seq.reshape(b, ht, wt, d),
                             self.patch_unembed_kernel,
                             self.patch_unembed_bias)

    @inference_unless_training
    def forward(self, x: torch.Tensor, res_out=(1080, 1920),
                upscale_factor: int | None = None,
                require_ratio: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout masks' source in train mode."""
        del require_ratio  # accepted and unused, as in the reference
        res_out, _ = resolve_geometry(x.shape[1:3], res_out, upscale_factor)
        x = x.to(self.dtype)
        h, w = x.shape[1:3]
        if (self.packed_serve and not self.training
                and res_out[0] % h == 0 and res_out[1] % w == 0
                and res_out[0] // h == res_out[1] // w
                and res_out[0] // h >= 2 and h % 2 == 0 and w % 16 == 0):
            return self._packed_forward(x, res_out[0] // h)

        upscaled_input = interpolate_bicubic(x, res_out)
        feat_down = self.downsample(self.conv2(self.conv1(x)))
        combined = feat_down + self._transformer(feat_down,
                                                 dropout_for(self, generator))
        residual = self.decoder_conv2(self.decoder_conv1(combined))
        out = upscaled_input + interpolate_bicubic(residual, res_out)
        return out.clamp(0.0, 1.0)

    def _packed_forward(self, x: torch.Tensor, scale: int) -> torch.Tensor:
        """The integer-scale serving path: the exact path's arithmetic with
        the two 64 -> 64 stride-1 convs on the stream kernel when
        ``pallas_serve`` is set."""
        dt = self.dtype
        h, w = x.shape[1:3]
        feat = self.conv1(x)
        if self.pallas_serve:
            feat = conv3x3_stream(feat, self.conv2.kernel.to(dt),
                                  self.conv2.bias, relu=True)
        else:
            feat = self.conv2(feat)
        feat_down = self.downsample(feat)
        combined = feat_down + self._transformer(feat_down)
        if self.pallas_serve and \
                os.environ.get("TUX_RESID_DEC_PALLAS", "1") == "1":
            dec = conv3x3_stream(combined, self.decoder_conv1.kernel.to(dt),
                                 self.decoder_conv1.bias, relu=True)
        else:
            dec = self.decoder_conv1(combined)
        residual = self.decoder_conv2(dec)
        if os.environ.get("TUX_RESID_BICUBIC", "matmul") == "matmul":
            res_out = (h * scale, w * scale)
            out = interpolate_bicubic(x, res_out) + interpolate_bicubic(
                residual, res_out)
            return out.clamp(0.0, 1.0)
        # The residual at half resolution, upscaled by 2 * scale: channels
        # (c, I, J), I, J < 2 scale, reordered to ((c, i, j), a, b) with
        # I = a scale + i, so that a shuffle by 2 leaves the input branch's
        # pre-shuffle channels (c, i, j) on the full-resolution grid.
        pre2 = bicubic_upscale_conv(residual, 2 * scale)
        resid_pre = pixel_shuffle(
            pre2.index_select(-1, _resid_perm(scale, pre2.device)), 2)
        out = pixel_shuffle(bicubic_upscale_conv(x, scale) + resid_pre, scale)
        return out.clamp(0.0, 1.0)
