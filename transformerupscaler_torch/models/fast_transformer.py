"""FastTransformer: learned sub-pixel upscaling around a window transformer
over full-resolution 8x8 patch tokens.

JAX counterpart: transformerupscaler_tpu models/fast_transformer.py:38-226
(parameters and fields, at the same defaults), ``__call__`` (:228-330) and
the serving forward ``_packed_forward`` (:333-961). ``forward`` routes as
``__call__`` does (:236-242): with ``compose_tails`` and one of
``packed_serve``, ``int8_serve`` or ``pallas_serve``, at scale 2, 3, 4 or 6
with h % 8 == 0 and w % 16 == 0, the serving forward; everything else, the
default fields included, the exact path.

The exact path (fast_transformer.py:244-330) runs in plain PyTorch but for
the trunk: conv1 and conv2, the features reflect-padded to the patch size,
branch A through ``up1`` (its RGB tail commuted through the last shuffle,
composed into the last stage under ``compose_tails``), the patch embed, the
window trunk by ``attn_impl`` (``models.common.run_window_trunk``: "fused2"
and "fused" on ``kernels.trunk2.fused_window_trunk``, "fused2" with
``int8_trunk`` in its mode "int8_rowwise"), the patch unembed cropped to the
features, the skip add, the decoder convs (decoder_conv2 folded into
``final_upscale``'s first stage under ``compose_tails``), the branch add and
the squash or shuffle, clipped.

The serving forward is ``_packed_forward`` with ``pallas_serve=True`` (JAX's
all-XLA packed path, ``pallas_serve=False``, and x6, whose direct tails run
other kernels, raise ``NotImplementedError``; its stream kernels take 64
feature channels and 8x8 patches). At a supported geometry it runs:

  conv1 3->64 + ReLU              ops.conv.conv2d (PyTorch conv); with
                                    ``conv1_stream``: kernels.stream
                                    .conv1_stream
  conv2 64->64 + ReLU             kernels.stream.conv3x3_stream
  branch A: composed tail + ReLU  kernels.stream.tail_conv_stream (5x5 at x2)
                                  (conv2 and branch A under TUX_FUSE_STREAM=1:
                                    kernels.stream.conv3x3_tail_emit_stream)
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
                                  (decoder conv and the folded tail under
                                    TUX_FUSE_STREAM=1: kernels.stream
                                    .conv3x3_tail_stream)
  branch add, squash or shuffle, clip

The B tail is split when ``split_tail`` is True, or None (the default) and
the compute dtype is bfloat16 (fast_transformer.py:829-851; the JAX
``serve_quality`` mode is not ported, so its exception does not arise): an
f32 model keeps the fold unless asked; under ``TUX_FUSE_STREAM=1`` (below)
it is always folded. ``int8_trunk`` (fast_transformer.py:
91-96, :699-701) runs the trunk's four GEMMs as int8 with per-token scales
under ``attn_impl="fused2"`` and, as in JAX, is ignored by the other trunks.

``int8_serve`` (fast_transformer.py:68-87, 373-398, 495-507, 527-539,
596-683, 708-715, 747-824, 903-924) quantizes activations per channel to
int8 in one of three scopes, with the branch-B tail always folded
(``split_tail`` does not apply):

  conv2         tails: conv3x3_stream with ``out_scale`` (int8 out);
                residual: conv3x3_stream; full: act_q(feat1),
                conv3x3_int8_stream
  tail A        tails: tail_conv_int8_stream; residual: tail_conv_stream;
                full: act_q(feat), tail_conv_int8_stream
  embed         embed_stream, in tails with ``in_scale`` (int8 in)
  unembed       unembed_combine_stream, in tails with ``feat_scale``
  decoder conv  tails: conv3x3_stream with ``out_scale``; residual, full:
                act_q(combined), conv3x3_int8_stream
  tail B        tails: tail_conv_int8_stream; residual, full: act_q(dec),
                tail_conv_int8_stream

``int8_scales`` holds static per-channel scales (feat1, feat, combined,
dec, tokens), each a tuple of 64 floats or the placeholder ``(1.0,)`` for a
tensor the scope does not quantize (``UpscalerEngine.calibrate_int8``
makes them); with static scales the tails scope quantizes in the convs'
epilogues. None means dynamic scales, the abs-max of each channel over the
frame (``ops.quant.act_scale``), quantized by a PyTorch pass, and the
weights, whose fold depends on the scale, quantized again every frame as
JAX does at trace time. Every forward records the scales it used in
``int8_scales_used`` under the JAX ``sow`` names (``int8_scale_feat``, ...).
JAX's int8 tail is the XLA ``conv2d_tail_packed_int8`` unless
``TUX_INT8_TAIL=pallas`` picks ``tail_macro8_stream_int8``; both compute one
function, which the port serves with the one int8 tail kernel, so the
switch is not carried.

Two environment switches are read at forward time on the serving forward,
as JAX reads them at trace time (fast_transformer.py:514-520, 581-595,
702-706, 780-789):

- ``TUX_FUSE_STREAM``, on only when it is "1": conv2 and the branch-A tail
  run as one kernel that also emits conv2's output (``fuse_enc``: not under
  the "full" and "tails" scopes), and the decoder conv and the folded
  branch-B tail as one kernel (``fuse_dec``: not under "full" and
  "residual"; the split tail does not apply). So "residual" fuses the
  encoder in bf16 and keeps its int8 decoder, and "tails" fuses the decoder
  in bf16 on the unembed's output with the int8 skip and quantizes no
  ``dec``. conv1 is then the plain ``ops.conv.conv2d``.
- ``TUX_CONV1_STREAM``: unset, the ``conv1_stream`` field decides; set, any
  value but "0" (the empty string too) runs conv1 on ``conv1_stream``. It
  applies where JAX's deinterleaved conv1 runs: not under the "full" scope
  and not under the fused encoder.

``fix_ratio_bug`` (fast_transformer.py:51, 300, 434) compares ``res_out``
with the output extent instead of the reference's (H, H) on both paths. The
JAX package's other ``TUX_*`` switches are not carried, nor its serving
fields other than those above at values other than their defaults
(``registry.FIXED_ROUTE``).
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from transformerupscaler_torch.kernels.stream import (
    HI_LO_FIN,
    conv1_stream,
    conv3x3_int8_stream,
    conv3x3_stream,
    conv3x3_tail_emit_stream,
    conv3x3_tail_stream,
    embed_stream,
    tail_conv_int8_stream,
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
    last_shuffle_factor,
    split_tail_kernels,
)
from transformerupscaler_torch.ops.conv import conv2d
from transformerupscaler_torch.ops.patch import patch_embed, patch_unembed
from transformerupscaler_torch.ops.pixel_shuffle import pixel_shuffle
from transformerupscaler_torch.ops.quant import (
    act_scale,
    fold_conv_kernel,
    quantize_act_ch,
)
from transformerupscaler_torch.ops.resize import resize_shuffled

# The serving forward's gate (fast_transformer.py:238-240) and the scales
# the port serves there.
GATE_SCALES = (2, 3, 4, 6)
SERVE_SCALES = (2, 3, 4)
INT8_SCOPES = ("full", "residual", "tails")
# The int8 activations in the order of ``int8_scales``.
INT8_TENSORS = ("feat1", "feat", "combined", "dec", "tokens")


def fuse_stream() -> bool:
    """JAX's ``TUX_FUSE_STREAM`` switch: on only when it is "1"."""
    return os.environ.get("TUX_FUSE_STREAM", "0") == "1"


class FastTransformer(FusedTrunk, nn.Module):
    """Inference-only FastTransformer. Parameters are f32 in the JAX layout
    (see ``transformerupscaler_torch.weights``); compute runs in ``dtype``.
    Input x: (B, H, W, 3) in [0, 1]; output (B, res_out..., 3).

    ``attn_impl``: "xla", "pallas", "fused" or "fused2" (the trunk, see the
    module docstring); ``int8_trunk``: the fused2 trunk's GEMMs in int8;
    ``split_tail``: None (automatic), True or False; ``hi_lo_fin``: how the
    split tail's finish rounds, None (= "off"), "off", "wf" or "full";
    ``int8_serve``, ``int8_scope`` ("full", "residual" or "tails") and
    ``int8_scales`` (None or five tuples): the int8 serving scopes;
    ``conv1_stream``: None (off), False or True, conv1 on its kernel;
    ``compose_tails``, ``pallas_serve``, ``packed_serve``: the serving
    forward's gate (module docstring); ``fix_ratio_bug``: the squash
    compares res_out with the output extent. All at the JAX defaults."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 transformer_dim: int = 192, num_window_blocks: int = 6,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 window_size: int = 8, patch_size: int = 8,
                 dtype=torch.float32, attn_impl: str = "xla",
                 split_tail: bool | None = None,
                 hi_lo_fin: str | None = None, int8_trunk: bool = False,
                 int8_serve: bool = False, int8_scope: str = "full",
                 int8_scales: tuple | None = None,
                 conv1_stream: bool | None = None,
                 compose_tails: bool = False, pallas_serve: bool = False,
                 packed_serve: bool = False, fix_ratio_bug: bool = False):
        super().__init__()
        bc, td, ps, ic = base_channels, transformer_dim, patch_size, in_channels
        if attn_impl not in TRUNK_IMPLS:
            raise ValueError(f"attn_impl: one of {TRUNK_IMPLS}, got "
                             f"{attn_impl!r}")
        if hi_lo_fin is not None and hi_lo_fin not in HI_LO_FIN:
            raise ValueError(f"hi_lo_fin: None or one of {HI_LO_FIN}, got "
                             f"{hi_lo_fin!r}")
        if int8_scope not in INT8_SCOPES:
            raise ValueError(f"int8_scope: one of {INT8_SCOPES}, got "
                             f"{int8_scope!r}")
        if conv1_stream not in (None, False, True):
            raise ValueError(f"conv1_stream: None, False or True, got "
                             f"{conv1_stream!r}")
        if int8_scales is not None and len(int8_scales) != len(INT8_TENSORS):
            raise ValueError(f"int8_scales: one tuple for each of "
                             f"{INT8_TENSORS}")
        self.base_channels = bc
        self.window_size = window_size
        self.patch_size = ps
        self.dtype = dtype
        self.compose_tails = compose_tails
        self.pallas_serve = pallas_serve
        self.packed_serve = packed_serve
        self.fix_ratio_bug = fix_ratio_bug
        self.attn_impl = attn_impl
        self.int8_trunk = int8_trunk
        self.split_tail = split_tail
        self.hi_lo_fin = hi_lo_fin
        self.int8_serve = int8_serve
        self.int8_scope = int8_scope
        self.int8_scales = (None if int8_scales is None else
                            tuple(tuple(map(float, s)) for s in int8_scales))
        self.int8_scales_used = {}
        self.conv1_stream = conv1_stream
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
        self._int8 = {}

    @property
    def splits_tail(self) -> bool:
        """Whether branch B runs as the split tail (mid + finish); never
        under ``int8_serve``, which folds it (fast_transformer.py:747-749),
        nor under ``TUX_FUSE_STREAM=1``, whose fused decoder takes the folded
        tail (:780-789)."""
        if self.int8_serve or fuse_stream():
            return False
        if self.split_tail is not None:
            return bool(self.split_tail)
        return self.dtype == torch.bfloat16

    def tail_kernels(self, scale: int):
        """(branch A, branch B). Branch A is (kernel, bias): the up1 chain
        with its commuted RGB tail. Branch B takes decoder_conv2, the
        final_upscale chain and its tail: folded into one (kernel, bias),
        or split as ((k_mid, b_mid), (k_fin, b_fin)). Composed once per
        scale in f32 and cast to the compute dtype; kept per scale, device
        and form of branch B."""
        split = self.splits_tail
        key = (scale, self.conv1.kernel.device, split)
        if key not in self._tails:
            dt = self.dtype
            ka = composed_tail_kernel(self.up1.stage_params(), scale,
                                      self.up1_conv_kernel, None, dt)
            compose = split_tail_kernels if split else composed_tail_kernel
            kb = compose(
                self.final_upscale.stage_params(), scale,
                self.final_upscale_conv_kernel, self.final_upscale_conv_bias,
                dt, pre_kernel=self.decoder_conv2.kernel,
                pre_bias=self.decoder_conv2.bias)
            self._tails[key] = (ka, kb)
        return self._tails[key]

    def _scale(self, name: str, t, device) -> torch.Tensor:
        """The int8 scale of activation ``name``: static (``int8_scales``),
        or measured on ``t``; recorded in ``int8_scales_used``."""
        if self.int8_scales is None:
            s = act_scale(t)
        else:
            key = (name, device)
            if key not in self._int8:
                vals = self.int8_scales[INT8_TENSORS.index(name)]
                if len(vals) != 64:
                    raise ValueError(f"int8_scales: {name} needs 64 channel "
                                     f"scales, got {len(vals)}")
                self._int8[key] = torch.tensor(vals, dtype=torch.float32,
                                               device=device)
            s = self._int8[key]
        self.int8_scales_used[f"int8_scale_{name}"] = s
        return s

    def _act_q(self, name: str, t: torch.Tensor):
        """(int8 t, its scale): JAX ``act_q`` / ``tail_scale`` with
        ``quantize_act_ch``."""
        s = self._scale(name, t, t.device)
        return quantize_act_ch(t, s)[0], s

    def _conv_q(self, name: str, x: torch.Tensor, kernel: torch.Tensor,
                bias):
        """The tails scope's 3x3 conv + ReLU with int8 output and its scale:
        static scales quantize in the kernel's epilogue, dynamic ones in a
        PyTorch pass after the bf16 conv."""
        k = kernel.to(self.dtype)
        if self.int8_scales is not None:
            s = self._scale(name, None, x.device)
            return conv3x3_stream(x, k, bias, relu=True, out_scale=s), s
        return self._act_q(name, conv3x3_stream(x, k, bias, relu=True))

    def _fold(self, name: str, kernel: torch.Tensor, s: torch.Tensor,
              scale: int):
        """(kq, ks) of ``kernel`` with the input scale ``s`` folded in, kept
        per upscale factor when the scales are static; with dynamic scales
        the fold depends on the frame and runs every forward."""
        if self.int8_scales is None:
            return fold_conv_kernel(kernel, s)
        key = (name, scale, kernel.device)
        if key not in self._int8:
            self._int8[key] = fold_conv_kernel(kernel, s)
        return self._int8[key]

    def _squash(self, out_hw, res_out, require_ratio: bool) -> bool:
        """Whether the output is resized to ``res_out``. The reference
        compares res_out with (H, H) (model.py:323), kept as the JAX model
        keeps it unless ``fix_ratio_bug``; an exact multiple is an identity
        resize and is skipped (fast_transformer.py:296-305, 434-439)."""
        compare = out_hw if self.fix_ratio_bug else (out_hw[0], out_hw[0])
        return (require_ratio and tuple(res_out) != compare
                and tuple(res_out) != out_hw)

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, res_out=(1080, 1920),
                upscale_factor: int | None = None,
                require_ratio: bool = True) -> torch.Tensor:
        res_out, scale = resolve_geometry(x.shape[1:3], res_out,
                                          upscale_factor)
        x = x.to(self.dtype)
        h, w = x.shape[1:3]
        self.int8_scales_used = {}
        if not ((self.packed_serve or self.int8_serve or self.pallas_serve)
                and self.compose_tails and scale in GATE_SCALES
                and h % self.patch_size == 0 and w % 16 == 0):
            return self._exact_forward(x, res_out, scale, require_ratio)
        if scale not in SERVE_SCALES:
            raise NotImplementedError(
                f"the serving forward covers scales {SERVE_SCALES}; x{scale} "
                f"runs direct tails the port has no kernels for")
        if not self.pallas_serve:
            raise NotImplementedError(
                "pallas_serve=False: JAX's all-XLA packed serving forward is "
                "not ported; serve with pallas_serve=True or without "
                "compose_tails")
        if self.base_channels != 64 or self.patch_size != 8:
            raise NotImplementedError("the serving kernels take 64 channels "
                                      "and 8x8 patches")
        return self._served_forward(x, res_out, scale, require_ratio)

    def _exact_forward(self, x, res_out, scale, require_ratio):
        """JAX ``__call__``'s own path (fast_transformer.py:244-330)."""
        feat = conv2d(x, self.conv1.kernel, self.conv1.bias, relu=True)
        feat = conv2d(feat, self.conv2.kernel, self.conv2.bias, relu=True)
        h, w = feat.shape[1:3]
        ps = self.patch_size
        feat_pad = _reflect_pad(feat, (ps - h % ps) % ps, (ps - w % ps) % ps)
        squash = self._squash((h * scale, w * scale), res_out, require_ratio)
        upscaled_input = self.up1(feat, scale,
                                  tail_kernel=self.up1_conv_kernel,
                                  tail_relu=True,
                                  compose_tail=self.compose_tails,
                                  return_preshuffle=squash)
        tokens = patch_embed(feat_pad, self.patch_embed_kernel,
                             self.patch_embed_bias)
        tokens = self.run_trunk(tokens)
        feat_trans = patch_unembed(tokens, self.patch_unembed_kernel,
                                   self.patch_unembed_bias)
        combined = feat + feat_trans[:, :h, :w, :]
        dec = conv2d(combined, self.decoder_conv1.kernel,
                     self.decoder_conv1.bias, relu=True)
        tail = dict(tail_kernel=self.final_upscale_conv_kernel,
                    tail_bias=self.final_upscale_conv_bias,
                    return_preshuffle=squash)
        if self.compose_tails:
            residual_up = self.final_upscale(
                dec, scale, compose_tail=True,
                pre_kernel=self.decoder_conv2.kernel,
                pre_bias=self.decoder_conv2.bias, **tail)
        else:
            residual = conv2d(dec, self.decoder_conv2.kernel,
                              self.decoder_conv2.bias)
            residual_up = self.final_upscale(residual, scale, **tail)
        out = upscaled_input + residual_up
        if squash:
            out = resize_shuffled(out, last_shuffle_factor(scale), res_out)
        return out.clamp(0.0, 1.0)

    def _served_forward(self, x, res_out, scale, require_ratio):
        """JAX ``_packed_forward`` with ``pallas_serve=True`` (module
        docstring)."""
        dt = self.dtype
        b, h, w, _ = x.shape
        squash = self._squash((h * scale, w * scale), res_out, require_ratio)
        (ka, ba), tail_b = self.tail_kernels(scale)

        scope = self.int8_scope if self.int8_serve else None
        fuse = fuse_stream()
        fuse_enc = fuse and scope not in ("full", "tails")
        fuse_dec = fuse and scope not in ("full", "residual")
        k2, b2 = self.conv2.kernel, self.conv2.bias
        c1_env = os.environ.get("TUX_CONV1_STREAM")
        c1_stream = self.conv1_stream if c1_env is None else c1_env != "0"
        if c1_stream and scope != "full" and not fuse_enc:
            feat1 = conv1_stream(x, self.conv1.kernel, self.conv1.bias,
                                 relu=True)
        else:
            feat1 = conv2d(x, self.conv1.kernel, self.conv1.bias, relu=True)
        skip_scale = None
        if scope == "full":
            f1q, s1 = self._act_q("feat1", feat1)
            feat = conv3x3_int8_stream(
                f1q, *self._fold("conv2", k2, s1, scale), b2, relu=True,
                out_dtype=dt)
            fq, s2 = self._act_q("feat", feat)
            a = tail_conv_int8_stream(fq, *self._fold("tail_a", ka, s2, scale),
                                      ba, relu=True, out_dtype=dt)
        elif scope == "tails":
            # ``feat`` is the int8 map from here on, dequantized in the
            # embed's and the unembed's kernels.
            feat, skip_scale = self._conv_q("feat", feat1, k2, b2)
            a = tail_conv_int8_stream(
                feat, *self._fold("tail_a", ka, skip_scale, scale), ba,
                relu=True, out_dtype=dt)
        elif fuse_enc:
            a, feat = conv3x3_tail_emit_stream(feat1, k2.to(dt), b2, ka, ba)
        else:
            feat = conv3x3_stream(feat1, k2.to(dt), b2, relu=True)
            a = tail_conv_stream(feat, ka, ba, relu=True)
        tokens = embed_stream(feat, self.patch_embed_kernel,
                              self.patch_embed_bias, in_scale=skip_scale,
                              out_dtype=dt)
        tokens = self.run_trunk(tokens)
        combined = unembed_combine_stream(tokens.contiguous(), feat,
                                          self.patch_unembed_kernel,
                                          self.patch_unembed_bias,
                                          feat_scale=skip_scale)
        kd, bd = self.decoder_conv1.kernel, self.decoder_conv1.bias
        if fuse_dec:
            bt = conv3x3_tail_stream(combined, kd.to(dt), bd, *tail_b)
        elif scope is None:
            dec = conv3x3_stream(combined, kd.to(dt), bd, relu=True)
            if self.splits_tail:
                (km, bm), (kf, bf) = tail_b
                bt = tail_finish_stream(dec, km, bm, kf, bf,
                                        hi_lo_fin=self.hi_lo_fin or "off")
            else:
                bt = tail_conv_stream(dec, *tail_b)
        else:
            if scope == "tails":
                dq, s4 = self._conv_q("dec", combined, kd, bd)
            else:
                cq, s3 = self._act_q("combined", combined)
                dec = conv3x3_int8_stream(
                    cq, *self._fold("dec", kd, s3, scale), bd, relu=True,
                    out_dtype=dt)
                dq, s4 = self._act_q("dec", dec)
            bt = tail_conv_int8_stream(
                dq, *self._fold("tail_b", tail_b[0], s4, scale), tail_b[1],
                out_dtype=dt)
        out = a + bt
        if squash:
            out = resize_shuffled(out, scale, res_out)
        else:
            out = pixel_shuffle(out, scale)
        return out.clamp(0.0, 1.0)


def _reflect_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """NHWC ``x`` reflect-padded at the bottom and the right, as
    ``jnp.pad(mode="reflect")`` pads (the edge row is not repeated)."""
    for dim, pad in ((1, pad_h), (2, pad_w)):
        if pad:
            n = x.shape[dim]
            # Rows n .. n + pad - 1 read 2 (n - 1) - i: n - 2 down to
            # n - 1 - pad. Made on the device: a CUDA graph cannot capture
            # a copy from pageable host memory.
            idx = torch.cat([torch.arange(n, device=x.device),
                             torch.arange(n - 2, n - 2 - pad, -1,
                                          device=x.device)])
            x = x.index_select(dim, idx)
    return x
