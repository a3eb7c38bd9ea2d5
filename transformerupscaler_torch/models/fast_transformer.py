"""FastTransformer: learned sub-pixel upscaling around a window transformer
over full-resolution 8x8 patch tokens.

JAX counterpart: transformerupscaler_tpu models/fast_transformer.py:38-226
(parameters) and the serving forward ``_packed_forward`` (:333-961) with
``compose_tails=True, pallas_serve=True``. At a supported geometry that
forward runs:

  conv1 3->64 + ReLU              ops.conv.conv2d (PyTorch conv)
  conv2 64->64 + ReLU             kernels.stream.conv3x3_stream
  branch A: composed tail + ReLU  kernels.stream.tail_conv_stream (5x5 at x2)
  patch embed 8x8/8               kernels.stream.embed_stream
  trunk: window blocks            attn_impl "fused2" / "fused":
                                    kernels.trunk2.fused_window_trunk,
                                    mode "v2" / "v1"; "fused2" with
                                    ``int8_trunk``: mode "int8_rowwise"
                                  attn_impl "xla": the blocks in PyTorch
                                  attn_impl "pallas": the blocks in PyTorch
                                    around kernels.window_attn
                                    .window_attention_core
  unembed + feature skip          kernels.stream.unembed_combine_stream
  decoder conv 64->64 + ReLU      kernels.stream.conv3x3_stream
  branch B tail                   split: kernels.stream.tail_finish_stream
                                    (5x5 mid + 3x3 finish at x2)
                                  folded: kernels.stream.tail_conv_stream
                                    (7x7 at x2)
  branch add, squash or shuffle, clip

The B tail is split when ``split_tail`` is True, or None (the default) and
the compute dtype is bfloat16 (fast_transformer.py:829-851; the JAX
``serve_quality`` mode is not ported, so its exception does not arise): an
f32 model keeps the fold unless asked. ``int8_trunk`` (fast_transformer.py:
91-96, :699-701) runs the trunk's four GEMMs as int8 with per-token scales
under ``attn_impl="fused2"`` and, as in JAX, is ignored by the other trunks.
The JAX package's ``TUX_*`` environment switches are not carried.

Other geometries (outside scale 2/3/4 with h % 8 == 0 and w % 16 == 0, where
the JAX model takes its exact path, and x6, whose tails run other kernels)
raise ``NotImplementedError``: they are later slices of the port.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from transformerupscaler_torch.kernels.stream import (
    HI_LO_FIN,
    conv3x3_stream,
    embed_stream,
    tail_conv_stream,
    tail_finish_stream,
    unembed_combine_stream,
)
from transformerupscaler_torch.models.common import (
    TRUNK_IMPLS,
    ConvLayer,
    FusedTrunk,
    WindowBlock,
    param,
    resolve_geometry,
)
from transformerupscaler_torch.models.upsampler import (
    Upsampler,
    composed_tail_kernel,
    split_tail_kernels,
)
from transformerupscaler_torch.ops.conv import conv2d
from transformerupscaler_torch.ops.pixel_shuffle import pixel_shuffle
from transformerupscaler_torch.ops.resize import resize_shuffled

SERVE_SCALES = (2, 3, 4)


class FastTransformer(FusedTrunk, nn.Module):
    """Inference-only FastTransformer. Parameters are f32 in the JAX layout
    (see ``transformerupscaler_torch.weights``); compute runs in ``dtype``.
    Input x: (B, H, W, 3) in [0, 1]; output (B, res_out..., 3).

    ``attn_impl``: "xla", "pallas", "fused" or "fused2" (the trunk, see the
    module docstring); ``int8_trunk``: the fused2 trunk's GEMMs in int8;
    ``split_tail``: None (automatic), True or False; ``hi_lo_fin``: how the
    split tail's finish rounds, None (= "off"), "off", "wf" or "full"."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 transformer_dim: int = 192, num_window_blocks: int = 6,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 window_size: int = 8, patch_size: int = 8,
                 dtype=torch.float32, attn_impl: str = "xla",
                 split_tail: bool | None = None,
                 hi_lo_fin: str | None = None, int8_trunk: bool = False):
        super().__init__()
        bc, td, ps, ic = base_channels, transformer_dim, patch_size, in_channels
        if bc != 64 or ps != 8:
            raise NotImplementedError("the serving kernels take 64 channels "
                                      "and 8x8 patches")
        if attn_impl not in TRUNK_IMPLS:
            raise ValueError(f"attn_impl: one of {TRUNK_IMPLS}, got "
                             f"{attn_impl!r}")
        if hi_lo_fin is not None and hi_lo_fin not in HI_LO_FIN:
            raise ValueError(f"hi_lo_fin: None or one of {HI_LO_FIN}, got "
                             f"{hi_lo_fin!r}")
        self.window_size = window_size
        self.patch_size = ps
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.int8_trunk = int8_trunk
        self.split_tail = split_tail
        self.hi_lo_fin = hi_lo_fin
        self.conv1 = ConvLayer(ic, bc)
        self.conv2 = ConvLayer(bc, bc)
        self.up1 = Upsampler(bc)
        self.up1_conv_kernel = param(3, 3, bc, ic)
        self.final_upscale = Upsampler(ic)
        self.final_upscale_conv_kernel = param(3, 3, ic, ic)
        self.final_upscale_conv_bias = param(ic)
        self.patch_embed_kernel = param(ps, ps, bc, td)
        self.patch_embed_bias = param(td)
        self.blocks = nn.ModuleList(
            WindowBlock(td, window_size, num_heads, mlp_ratio)
            for _ in range(num_window_blocks))
        self.patch_unembed_kernel = param(td, ps, ps, bc)
        self.patch_unembed_bias = param(bc)
        self.decoder_conv1 = ConvLayer(bc, bc)
        self.decoder_conv2 = ConvLayer(bc, ic)
        self.clear_derived()

    def clear_derived(self) -> None:
        """Drop what was derived from the parameters (the composed tail
        kernels, the stacked trunk weights); call after changing them."""
        super().clear_derived()
        self._tails = {}

    @property
    def splits_tail(self) -> bool:
        """Whether branch B runs as the split tail (mid + finish)."""
        if self.split_tail is not None:
            return bool(self.split_tail)
        return self.dtype == torch.bfloat16

    def tail_kernels(self, scale: int):
        """(branch A, branch B). Branch A is (kernel, bias): the up1 chain
        with its commuted RGB tail. Branch B takes decoder_conv2, the
        final_upscale chain and its tail: folded into one (kernel, bias),
        or split as ((k_mid, b_mid), (k_fin, b_fin)). Composed once per
        scale in f32 and cast to the compute dtype."""
        key = (scale, self.conv1.kernel.device)
        if key not in self._tails:
            dt = self.dtype
            ka = composed_tail_kernel(self.up1.stage_params(), scale,
                                      self.up1_conv_kernel, None, dt)
            compose = (split_tail_kernels if self.splits_tail
                       else composed_tail_kernel)
            kb = compose(
                self.final_upscale.stage_params(), scale,
                self.final_upscale_conv_kernel, self.final_upscale_conv_bias,
                dt, pre_kernel=self.decoder_conv2.kernel,
                pre_bias=self.decoder_conv2.bias)
            self._tails[key] = (ka, kb)
        return self._tails[key]

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, res_out=(1080, 1920),
                upscale_factor: int | None = None,
                require_ratio: bool = True) -> torch.Tensor:
        res_out, scale = resolve_geometry(x.shape[1:3], res_out,
                                          upscale_factor)
        dt = self.dtype
        x = x.to(dt)
        b, h, w, _ = x.shape
        if scale not in SERVE_SCALES or h % self.patch_size or w % 16:
            raise NotImplementedError(
                f"serving path covers scales {SERVE_SCALES} with h % 8 == 0 "
                f"and w % 16 == 0; got {h}x{w} at scale {scale}")
        out_hw = (h * scale, w * scale)
        # The reference compares res_out with (H, H) (model.py:323), kept as
        # the JAX model keeps it; an exact multiple is an identity resize and
        # is skipped.
        squash = (require_ratio and tuple(res_out) != (out_hw[0], out_hw[0])
                  and tuple(res_out) != out_hw)
        (ka, ba), tail_b = self.tail_kernels(scale)

        feat = conv2d(x, self.conv1.kernel, self.conv1.bias, relu=True)
        feat = conv3x3_stream(feat, self.conv2.kernel.to(dt), self.conv2.bias,
                              relu=True)
        a = tail_conv_stream(feat, ka, ba, relu=True)
        tokens = embed_stream(feat, self.patch_embed_kernel,
                              self.patch_embed_bias)
        tokens = self.run_trunk(tokens)
        combined = unembed_combine_stream(tokens.contiguous(), feat,
                                          self.patch_unembed_kernel,
                                          self.patch_unembed_bias)
        dec = conv3x3_stream(combined, self.decoder_conv1.kernel.to(dt),
                             self.decoder_conv1.bias, relu=True)
        if self.splits_tail:
            (km, bm), (kf, bf) = tail_b
            bt = tail_finish_stream(dec, km, bm, kf, bf,
                                    hi_lo_fin=self.hi_lo_fin or "off")
        else:
            bt = tail_conv_stream(dec, *tail_b)
        out = a + bt
        if squash:
            out = resize_shuffled(out, scale, res_out)
        else:
            out = pixel_shuffle(out, scale)
        return out.clamp(0.0, 1.0)
