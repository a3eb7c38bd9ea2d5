"""FastTransformer: learned sub-pixel upscaling around a window transformer
over full-resolution 8x8 patch tokens.

JAX counterpart: transformerupscaler_tpu models/fast_transformer.py:38-226
(parameters and fields, at the same defaults), ``__call__`` (:228-330) and
the serving forward ``_packed_forward`` (:333-961). ``forward`` routes as
``__call__`` does (:236-242): with ``compose_tails`` and one of
``packed_serve``, ``int8_serve`` or ``pallas_serve``, at scale 2, 3, 4 or 6
with h % 8 == 0 and w % 16 == 0, the serving forward; everything else, the
default fields included, the exact path. Every field of the JAX model is
served, ``int8_mlp`` and the offline GPTQ weights ``int8_weights`` (below)
included.

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

The serving forward is ``_packed_forward``; ``route(scale)`` makes JAX's
trace-time choices (``PackedRoute``). With ``pallas_serve`` it runs the
stream kernels (they take 64 feature channels and 8x8 patches):

  conv1 3->64 + ReLU              ops.conv.conv2d (PyTorch conv); with
                                    ``conv1_stream``: kernels.stream
                                    .conv1_stream; serve_quality's "conv1"
                                    part: ops.conv.conv2d_uint8_exact
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
                                  factored (``fold_pre=False``): plain
                                  (decoder conv and the folded tail under
                                    TUX_FUSE_STREAM=1: kernels.stream
                                    .conv3x3_tail_stream)
  branch add, squash or shuffle, clip

At x6 the composed tails have 3 * 36 = 108 outputs and JAX runs them as
direct XLA convs (``direct_tails``, :445-448, 671-676, 932-940): here
``ops.conv.conv2d`` (5x5 64->108 + ReLU, folded 7x7 64->108), conv1 plain,
conv2 and the decoder conv on ``conv3x3_stream``, the patch kernels and the
trunk as above. The split tail, ``f32_tail`` and the fused kernels do not
apply there (:850-851, the direct convs emit the compute dtype).

Without ``pallas_serve`` (``packed_serve`` or ``int8_serve`` alone) it is
JAX's all-XLA packed path, which runs no Pallas kernel: conv1, conv2 and the
decoder conv (``conv2d_packed_raw``), the composed tails
(``conv2d_tail_packed``, the B tail folded or factored, never split) and the
patch embed and unembed (``patch_embed_packed`` / ``patch_unembed_packed``,
then ``+ featp``) in plain PyTorch with XLA's rounding points: each conv or
product rounded to the compute dtype, then the bias added in it
(ops/conv.py:305-312, 524-530, ops/patch.py:53-56, 69-73); the trunk by
``attn_impl``; the same in f32.

The B tail is split when ``split_tail`` is True, or None (the default) and
the compute dtype is bfloat16, under ``serve_quality`` at x4 only
(fast_transformer.py:829-851): an f32 model keeps the fold unless asked. It
is split only on the Pallas path, at x2, x3 and x4, with ``fold_pre``, and
not under ``TUX_FUSE_STREAM=1`` or an int8 scope. ``hi_lo_fin`` None means
"wf" under ``serve_quality`` and "off" otherwise (:881-895).
``int8_trunk`` (fast_transformer.py:91-96, :699-701) runs the trunk's four
GEMMs as int8 with per-token scales under ``attn_impl="fused2"`` and, as in
JAX, is ignored by the other trunks.

``int8_serve`` (fast_transformer.py:68-87, 373-398, 485-507, 527-539,
596-683, 708-726, 747-824, 903-931) quantizes activations per channel to
int8 in one of three scopes, with the branch-B tail always folded. On the
Pallas path at x2, x3, x4:

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

At x6 on the Pallas path "tails" quantizes the two direct tails' inputs
(``i8dt``: act_q(feat), act_q(dec), the int8 convs of ``ops.conv
.conv2d_int8_mm``); "full" and "residual" run as above with the embed and
the unembed in bf16 and the 108-output int8 tails on ``conv2d_int8_mm``.
On the all-XLA path "tails" quantizes nothing (:488-493: plain bf16);
"residual" keeps conv1, conv2 and tail A in bf16 and "full" quantizes
feat1, feat, combined, dec and the tokens: the int8 3x3 convs on
``conv3x3_int8_stream`` and the int8 tails on ``tail_conv_int8_stream``
(up to 48 outputs; ``conv2d_int8_mm`` above), which compute JAX's
``conv2d_packed_int8`` and ``conv2d_tail_packed_int8`` bit for bit (exact
int32 sums, the f32 scale and bias, one cast), and the patch GEMMs
``ops.patch.patch_embed_int8`` / ``patch_unembed_int8`` (the tokens
quantized with a scale per token channel, ``transformer_dim`` of them).

``int8_scales`` holds static per-channel scales (feat1, feat, combined,
dec, tokens): 64 floats each, ``transformer_dim`` for the tokens, or the
placeholder ``(1.0,)`` for a tensor the scope does not quantize
(``UpscalerEngine.calibrate_int8`` makes them); with static scales the tails
scope quantizes in the convs' epilogues. None means dynamic scales, the
abs-max of each channel over the frame (``ops.quant.act_scale``), quantized
by a PyTorch pass, and the weights, whose fold depends on the scale,
quantized again every frame as JAX does at trace time. Every forward
records the scales it used in ``int8_scales_used`` under the JAX ``sow``
names (``int8_scale_feat``, ...). JAX's int8 tail is the XLA
``conv2d_tail_packed_int8`` unless ``TUX_INT8_TAIL=pallas`` picks
``tail_macro8_stream_int8``; both compute one function, which the port
serves with the one int8 tail kernel, so the switch matters only where the
XLA form would read a GPTQ entry (below).

``int8_weights`` (fast_transformer.py:102, 414-421): JAX's entries
``(name, shape, int8 kernel bytes, f32 scale bytes, f32 bias bytes or
None)``, as ``UpscalerEngine.gptq_int8`` bakes them, decoded once per
device (``clear_derived`` drops them). An entry's kernel and scales go to
the int8 conv in place of the fold of the raw kernel (the activation scale
is already in them), and its bias, where not None, replaces the layer's.
They are read where JAX reads them, and nowhere else:

  "conv2"         conv2 under "full" off ``pallas_serve`` (:539); on the
                  Pallas path JAX's ``conv3x3_packed_int8_stream`` ignores
                  it (:529-536), and so does the port, on the same kernel
  "tailA_s<r>"    tail A under "full" (:638), and under "tails" unless
                  ``TUX_INT8_TAIL=pallas`` (:651-660)
  "tailB_s<r>"    tail B under "tails" unless ``TUX_INT8_TAIL=pallas``
                  (:817-824)

Not at x6's direct int8 tails under "tails" (:664-670), and never the
"conv1" entry ``gptq_int8`` bakes: conv1 stays bf16 (:426-432).

``int8_mlp`` (fast_transformer.py:50, 219): the window blocks' MLP in int8
(``models.common.WindowBlock``) under ``attn_impl`` "xla" and "pallas", on
the exact path and the serving forward; the fused trunks ignore it.

``serve_quality`` (or ``TUX_SERVE_QUALITY=1``) with ``quality_parts``
(default "tails"; comma-separated, fast_transformer.py:107-138, 467-480):
"tails" makes the Pallas tails emit f32 (as ``f32_tail`` or
``TUX_F32_TAIL=1`` does: tail A, the folded and the split tail B and both
fused kernels; the int8 tails and the direct x6 convs emit the compute
dtype), so the branch add, the squash and the clip run in f32; "conv1" runs
conv1 on the pre-cast f32 input as exact uint8 values (where JAX's
deinterleaved conv1 runs, and only for an f32 input); "squash" is JAX's
squash at ``Precision.HIGH``, which on the CPU is its exact f32, as the
port's f32 squash always is; it also bands the squash under
``TUX_BANDED_RESIZE`` "auto", as JAX's precision does.

``fold_pre=False`` (or ``TUX_FOLD_PRE=0``; the int8 scopes force the fold,
:746-749) runs the factored B tail: decoder_conv2 (3x3 64->3), then the
composed 5x5 3->3r^2 tail without it, each zero-padding its own input, in
plain PyTorch as JAX runs it on XLA (``factored_b_tail``, :761-779; with
f32 tails asked for it warns, as JAX does).

The environment switches are read at each forward, as JAX reads them at
trace time:

- ``TUX_FUSE_STREAM``, on only when it is "1": conv2 and the branch-A tail
  run as one kernel that also emits conv2's output (``fuse_enc``: not under
  the "full" and "tails" scopes, not at x6), and the decoder conv and the
  folded branch-B tail as one kernel (``fuse_dec``: not under "full" and
  "residual", not at x6; the split tail does not apply). So "residual"
  fuses the encoder in bf16 and keeps its int8 decoder, and "tails" fuses
  the decoder in bf16 on the unembed's output with the int8 skip and
  quantizes no ``dec``. conv1 is then the plain ``ops.conv.conv2d``.
- ``TUX_CONV1_STREAM``: unset, the ``conv1_stream`` field decides; set, any
  value but "0" (the empty string too) runs conv1 on ``conv1_stream``. It
  applies where JAX's deinterleaved conv1 runs: not under the "full" scope,
  not under the fused encoder, not at x6, not for the exact-uint8 conv1.
- ``TUX_SPLIT_TAIL``: set, "1" splits the B tail and anything else folds
  it, over ``split_tail``.
- ``TUX_HILO_FIN``: set, the split tail's finish mode, over ``hi_lo_fin``;
  it warns when it differs from the mode the model would pass (JAX's
  ``tail_finish_stream``, ops/pallas/stream.py:1118-1131).
- ``TUX_FOLD_PRE``: set, anything but "0" folds, over ``fold_pre``.
- ``TUX_F32_TAIL``: "1" makes the Pallas tails emit f32 (``f32_tail``).
- ``TUX_SERVE_QUALITY``: "1" turns ``serve_quality`` on.
- ``TUX_PALLAS_PATCH`` (default "embed,unembed"): without "embed" the
  Pallas path embeds as the all-XLA path does (the int8 GEMM under "full"
  and "residual"), likewise without "unembed"; the tails scope on its
  Pallas tails keeps both kernels (:481-493).
- ``TUX_BANDED_RESIZE`` (ops/resize.py): "1" bands every resize, "0"
  none; unset or "auto" bands the squash where it runs in float32 (the
  exact path of an f32 model, the f32 tails of ``serve_quality``) or under
  the "squash" part, as JAX's ``_banded_on`` does (ops/resize.py:156-174).

``fix_ratio_bug`` (fast_transformer.py:51, 300, 434) compares ``res_out``
with the output extent instead of the reference's (H, H) on both paths.
The JAX package's other ``TUX_*`` switches pick TPU tilings or one of two
forms of one function and have no counterpart.

The stages that run in plain PyTorch on the card are those JAX computes
outside Pallas: conv1 (but under ``conv1_stream``), x6's direct tails, the
108-output int8 tails, the quantize passes, the factored B tail, the
all-XLA path's convs, tails and patch products (its int8 3x3 convs and
int8 tails up to 48 outputs run rows 8 and 9's kernels, as said), the
branch add, the squash and the clip.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
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
    dropout_for,
    inference_unless_training,
    param,
    resolve_geometry,
)
from transformerupscaler_torch.models.upsampler import (
    Upsampler,
    composed_tail_kernel,
    last_shuffle_factor,
    split_tail_kernels,
)
from transformerupscaler_torch.ops.conv import (
    conv2d,
    conv2d_int8_mm,
    conv2d_uint8_exact,
)
from transformerupscaler_torch.ops.patch import (
    patch_embed,
    patch_embed_int8,
    patch_unembed,
    patch_unembed_int8,
)
from transformerupscaler_torch.ops.pixel_shuffle import pixel_shuffle
from transformerupscaler_torch.ops.quant import (
    act_scale,
    fold_conv_kernel,
    quantize_act_ch,
)
from transformerupscaler_torch.ops.resize import resize_shuffled

# The serving forward's gate (fast_transformer.py:238-240).
GATE_SCALES = (2, 3, 4, 6)
INT8_SCOPES = ("full", "residual", "tails")
# The int8 activations in the order of ``int8_scales``.
INT8_TENSORS = ("feat1", "feat", "combined", "dec", "tokens")
B_TAILS = ("split", "fold", "factored")
# Outputs the int8 tail kernel takes; wider int8 tails run conv2d_int8_mm.
INT8_TAIL_MAX_CO = 48


def fuse_stream() -> bool:
    """JAX's ``TUX_FUSE_STREAM`` switch: on only when it is "1"."""
    return os.environ.get("TUX_FUSE_STREAM", "0") == "1"


@dataclasses.dataclass(frozen=True)
class PackedRoute:
    """How the serving forward runs at one upscale factor: the choices JAX
    ``_packed_forward`` makes at trace time (fast_transformer.py:373-520,
    702-706, 744-851), from the fields and the ``TUX_*`` switches."""

    pallas: bool          # pallas_serve: the stream kernels
    direct_tails: bool    # x6: the tails as direct convs
    quality: bool         # serve_quality or TUX_SERVE_QUALITY=1
    qparts: frozenset     # the quality_parts in force
    tail_f32: bool        # the Pallas tails emit f32 (``_tail_odt``)
    i8a: bool             # "full": conv2 and tail A int8
    i8b: bool             # "full", "residual": the residual branch int8
    i8t: bool             # "tails" on the Pallas tails
    i8dt: bool            # "tails" at x6 on the Pallas path
    pallas_embed: bool
    pallas_unembed: bool
    fuse_enc: bool
    fuse_dec: bool
    enc_deint: bool       # conv1 and conv2 as JAX's deinterleaved stages
    conv1_stream: bool
    b_tail: str           # "split", "fold" or "factored"


class FastTransformer(FusedTrunk, nn.Module):
    """FastTransformer. Parameters are f32 in the JAX layout (see
    ``transformerupscaler_torch.weights``); compute runs in ``dtype``.
    Input x: (B, H, W, 3) in [0, 1]; output (B, res_out..., 3). It serves
    in eval mode; in train mode (``train()``, JAX's ``deterministic=False``)
    the forward runs the exact path under autograd with the trunk in
    PyTorch and ``dropout`` (0.1) drawn from the forward's ``generator``.

    ``attn_impl``: "xla", "pallas", "fused" or "fused2" (the trunk, see the
    module docstring); ``int8_trunk``: the fused2 trunk's GEMMs in int8;
    ``split_tail``: None (automatic), True or False; ``hi_lo_fin``: how the
    split tail's finish rounds, None (automatic), "off", "wf" or "full";
    ``int8_serve``, ``int8_scope`` ("full", "residual" or "tails") and
    ``int8_scales`` (None or five tuples): the int8 serving scopes;
    ``conv1_stream``: None (off), False or True, conv1 on its kernel;
    ``compose_tails``, ``pallas_serve``, ``packed_serve``: the serving
    forward's gate and path (module docstring); ``fix_ratio_bug``: the
    squash compares res_out with the output extent; ``serve_quality``,
    ``quality_parts``, ``f32_tail``: f32 image boundaries; ``fold_pre``:
    False for the factored B tail. All at the JAX defaults."""

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
                 packed_serve: bool = False, fix_ratio_bug: bool = False,
                 serve_quality: bool = False, quality_parts: str = "tails",
                 f32_tail: bool = False, fold_pre: bool = True,
                 int8_mlp: bool = False, int8_weights: tuple | None = None,
                 dropout: float = 0.1):
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
        if int8_weights is not None and any(len(e) != 5
                                            for e in int8_weights):
            raise ValueError("int8_weights: entries (name, shape, kernel "
                             "bytes, scale bytes, bias bytes or None)")
        self.in_channels = ic
        self.base_channels = bc
        self.transformer_dim = td
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
        self.serve_quality = serve_quality
        self.quality_parts = quality_parts
        self.f32_tail = f32_tail
        self.fold_pre = fold_pre
        self.int8_mlp = int8_mlp
        self.int8_weights = (None if int8_weights is None
                             else tuple(map(tuple, int8_weights)))
        self.dropout = dropout
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
            WindowBlock(td, window_size, num_heads, mlp_ratio, int8_mlp)
            for _ in range(num_window_blocks))
        self.patch_unembed_kernel = param(td, ps, ps, bc)
        self.patch_unembed_bias = param(bc)
        self.decoder_conv1 = ConvLayer(bc, bc)
        self.decoder_conv2 = ConvLayer(bc, ic)
        self.clear_derived()
        self.eval()

    def clear_derived(self) -> None:
        """Drop what was derived from the parameters (the composed tail
        kernels, the stacked trunk weights); call after changing them."""
        super().clear_derived()
        self._tails = {}
        self._int8 = {}

    def route(self, scale: int) -> PackedRoute:
        """The serving forward's choices at ``scale`` (``PackedRoute``),
        with the switches as they stand now."""
        env = os.environ.get
        pallas = bool(self.pallas_serve)
        scope = self.int8_scope if self.int8_serve else None
        direct = self.in_channels * scale * scale >= 64
        patches = env("TUX_PALLAS_PATCH", "embed,unembed")
        quality = bool(self.serve_quality
                       or env("TUX_SERVE_QUALITY", "0") == "1")
        qparts = (frozenset(self.quality_parts.split(",")) if quality
                  else frozenset())
        pallas_patch = pallas and self.patch_size == 8
        i8a = scope == "full"
        i8b = scope in ("full", "residual")
        i8dt = scope == "tails" and pallas and direct
        i8t = scope == "tails" and pallas and not direct and pallas_patch
        fuse = fuse_stream()
        fuse_enc = fuse and pallas and not i8a and not i8t and not direct
        fuse_dec = fuse and pallas and not i8b and not direct
        c1_env = env("TUX_CONV1_STREAM")
        fp_env = env("TUX_FOLD_PRE")
        fold_pre = bool(i8t or i8b or i8dt or (
            self.fold_pre if fp_env is None else fp_env != "0"))
        b_tail = "fold" if fold_pre else "factored"
        if pallas and not (i8b or i8t or direct or fuse_dec):
            st_env = env("TUX_SPLIT_TAIL")
            if st_env is not None:
                want = st_env == "1"
            elif self.split_tail is not None:
                want = bool(self.split_tail)
            else:
                want = self.dtype == torch.bfloat16 and (scale == 4
                                                         or not quality)
            if want and fold_pre and scale in (2, 3, 4):
                b_tail = "split"
        return PackedRoute(
            pallas=pallas, direct_tails=direct, quality=quality,
            qparts=qparts,
            tail_f32=bool(self.f32_tail or "tails" in qparts
                          or env("TUX_F32_TAIL", "0") == "1"),
            i8a=i8a, i8b=i8b, i8t=i8t, i8dt=i8dt,
            pallas_embed=pallas_patch and ("embed" in patches or i8t),
            pallas_unembed=pallas_patch and ("unembed" in patches or i8t),
            fuse_enc=fuse_enc, fuse_dec=fuse_dec,
            enc_deint=pallas and not i8a and not direct and not fuse_enc,
            conv1_stream=bool(self.conv1_stream if c1_env is None
                              else c1_env != "0"),
            b_tail=b_tail)

    @property
    def splits_tail(self) -> bool:
        """Whether branch B runs as the split tail (mid + finish) at x2:
        never under ``int8_serve``, which folds it (fast_transformer.py:
        747-749), under ``TUX_FUSE_STREAM=1``, whose fused decoder takes the
        folded tail (:780-789), or off the Pallas path."""
        return self.route(2).b_tail == "split"

    def tail_kernels(self, scale: int, b_tail: str | None = None):
        """(branch A, branch B). Branch A is (kernel, bias): the up1 chain
        with its commuted RGB tail. Branch B (``b_tail``, default the
        route's) takes decoder_conv2, the final_upscale chain and its tail:
        folded into one (kernel, bias), split as ((k_mid, b_mid), (k_fin,
        b_fin)), or factored, without decoder_conv2 (a (kernel, bias) with
        3 input channels). Composed once per scale in f32 and cast to the
        compute dtype; kept per scale, device and form of branch B."""
        b_tail = b_tail or self.route(scale).b_tail
        if b_tail not in B_TAILS:
            raise ValueError(f"b_tail: one of {B_TAILS}, got {b_tail!r}")
        key = (scale, self.conv1.kernel.device, b_tail)
        if key not in self._tails:
            dt = self.dtype
            ka = composed_tail_kernel(self.up1.stage_params(), scale,
                                      self.up1_conv_kernel, None, dt)
            pre = {} if b_tail == "factored" else dict(
                pre_kernel=self.decoder_conv2.kernel,
                pre_bias=self.decoder_conv2.bias)
            compose = (split_tail_kernels if b_tail == "split"
                       else composed_tail_kernel)
            kb = compose(
                self.final_upscale.stage_params(), scale,
                self.final_upscale_conv_kernel, self.final_upscale_conv_bias,
                dt, **pre)
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
                n = (self.transformer_dim if name == "tokens"
                     else self.base_channels)
                if len(vals) != n:
                    raise ValueError(f"int8_scales: {name} needs {n} "
                                     f"channel scales, got {len(vals)}")
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

    def _pre_q(self, name: str, device, tails: bool = False):
        """The ``int8_weights`` entry ``name`` as (kq int8 HWIO, ks f32,
        bias f32 or None) on ``device``, or None. ``tails``: a read of the
        tails scope, which ``TUX_INT8_TAIL=pallas`` turns off."""
        if self.int8_weights is None or (
                tails and os.environ.get("TUX_INT8_TAIL", "xla") == "pallas"):
            return None
        key = ("int8_weights", device)
        if key not in self._int8:
            def put(b, dt):
                return torch.from_numpy(np.frombuffer(b, dt).copy()).to(device)

            self._int8[key] = {
                name: (put(kq, np.int8).reshape(tuple(shape)),
                       put(ks, np.float32),
                       None if bb is None else put(bb, np.float32))
                for name, shape, kq, ks, bb in self.int8_weights}
        return self._int8[key].get(name)

    def _int8_weights(self, name, kernel, s, bias, scale, pre):
        """(kq, ks, bias) of an int8 conv: the GPTQ entry ``pre`` (its bias
        where it has one), else the fold of ``kernel`` for ``s``."""
        if pre is None:
            return (*self._fold(name, kernel, s, scale), bias)
        return pre[0], pre[1], bias if pre[2] is None else pre[2]

    def _tail_int8(self, name, xq, kernel, s, bias, relu, scale, pre=None):
        """JAX's int8 composed tail (``conv2d_tail_packed_int8`` /
        ``conv2d_int8``): the int8 tail kernel up to 48 outputs, the exact
        int32 im2col product beyond (x6); ``pre``: a GPTQ entry."""
        kq, ks, bias = self._int8_weights(name, kernel, s, bias, scale, pre)
        if kernel.shape[3] <= INT8_TAIL_MAX_CO:
            return tail_conv_int8_stream(xq, kq, ks, bias, relu=relu,
                                         out_dtype=self.dtype)
        return conv2d_int8_mm(xq, kq, ks, bias, relu=relu,
                              out_dtype=self.dtype)

    def _squash(self, out_hw, res_out, require_ratio: bool) -> bool:
        """Whether the output is resized to ``res_out``. The reference
        compares res_out with (H, H) (model.py:323), kept as the JAX model
        keeps it unless ``fix_ratio_bug``; an exact multiple is an identity
        resize and is skipped (fast_transformer.py:296-305, 434-439)."""
        compare = out_hw if self.fix_ratio_bug else (out_hw[0], out_hw[0])
        return (require_ratio and tuple(res_out) != compare
                and tuple(res_out) != out_hw)

    @inference_unless_training
    def forward(self, x: torch.Tensor, res_out=(1080, 1920),
                upscale_factor: int | None = None,
                require_ratio: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout masks' source in train mode."""
        res_out, scale = resolve_geometry(x.shape[1:3], res_out,
                                          upscale_factor)
        x_in = x  # the pre-cast input: the exact-uint8 conv1 reads it
        x = x.to(self.dtype)
        h, w = x.shape[1:3]
        self.int8_scales_used = {}
        if self.training or not (
                (self.packed_serve or self.int8_serve or self.pallas_serve)
                and self.compose_tails and scale in GATE_SCALES
                and h % self.patch_size == 0 and w % 16 == 0):
            return self._exact_forward(x, res_out, scale, require_ratio,
                                       dropout_for(self, generator))
        if self.pallas_serve and (self.base_channels != 64
                                  or self.patch_size != 8):
            raise NotImplementedError("the serving kernels take 64 channels "
                                      "and 8x8 patches")
        return self._packed_forward(x, x_in, res_out, scale, require_ratio)

    def _exact_forward(self, x, res_out, scale, require_ratio, drop=None):
        """JAX ``__call__``'s own path (fast_transformer.py:244-330), with
        ``drop`` in the trunk in train mode."""
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
        tokens = self.run_trunk(tokens, drop)
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

    def _packed_forward(self, x, x_in, res_out, scale, require_ratio):
        """JAX ``_packed_forward`` (module docstring), as ``route`` says."""
        dt = self.dtype
        r = self.route(scale)
        h, w = x.shape[1:3]
        squash = self._squash((h * scale, w * scale), res_out, require_ratio)
        (ka, ba), tail_b = self.tail_kernels(scale, r.b_tail)
        todt = torch.float32 if r.tail_f32 else dt  # the Pallas tails' out
        k2, b2 = self.conv2.kernel, self.conv2.bias
        feat = feat_q = s_feat = fq = s2 = a = None

        # conv1, conv2 (fast_transformer.py:515-622).
        exact_uint8 = "conv1" in r.qparts and x_in.dtype == torch.float32
        if r.enc_deint and exact_uint8:
            feat1 = conv2d_uint8_exact(x_in, self.conv1.kernel,
                                       self.conv1.bias, relu=True,
                                       out_dtype=dt)
        elif r.enc_deint and r.conv1_stream:
            feat1 = conv1_stream(x, self.conv1.kernel, self.conv1.bias,
                                 relu=True)
        else:
            feat1 = conv2d(x, self.conv1.kernel, self.conv1.bias, relu=True)
        if r.i8a:
            f1q, s1 = self._act_q("feat1", feat1)
            pre = None if r.pallas else self._pre_q("conv2", x.device)
            feat = conv3x3_int8_stream(
                f1q, *self._int8_weights("conv2", k2, s1, b2, scale, pre),
                relu=True, out_dtype=dt)
        elif r.i8t:
            # ``feat_q`` is the int8 map from here on, dequantized in the
            # embed's and the unembed's kernels.
            feat_q, s_feat = self._conv_q("feat", feat1, k2, b2)
        elif r.fuse_enc:
            a, feat = conv3x3_tail_emit_stream(feat1, k2.to(dt), b2, ka, ba,
                                               out_dtype=todt)
        elif r.pallas:
            feat = conv3x3_stream(feat1, k2.to(dt), b2, relu=True)
        else:
            feat = conv2d(feat1, k2, b2, relu=True)

        # Branch A (:634-678).
        if r.i8a or r.i8dt:
            fq, s2 = self._act_q("feat", feat)
            pre = self._pre_q(f"tailA_s{scale}", x.device) if r.i8a else None
            a = self._tail_int8("tail_a", fq, ka, s2, ba, True, scale, pre)
        elif r.i8t:
            pre = self._pre_q(f"tailA_s{scale}", x.device, tails=True)
            a = tail_conv_int8_stream(
                feat_q, *self._int8_weights("tail_a", ka, s_feat, ba, scale,
                                            pre), relu=True, out_dtype=dt)
        elif r.pallas and not r.direct_tails and not r.fuse_enc:
            a = tail_conv_stream(feat, ka, ba, relu=True, out_dtype=todt)
        elif not r.fuse_enc:  # x6's direct conv, or the all-XLA tail
            a = conv2d(feat, ka, ba, padding=(ka.shape[0] - 1) // 2,
                       relu=True)

        # The patch embed, the trunk, the unembed and the skip (:679-731).
        ke, be = self.patch_embed_kernel, self.patch_embed_bias
        if r.pallas_embed:
            tokens = embed_stream(feat if feat_q is None else feat_q, ke, be,
                                  in_scale=s_feat, out_dtype=dt)
        elif r.i8b:
            if fq is None:
                fq, s2 = self._act_q("feat", feat)
            tokens = patch_embed_int8(fq, s2, ke, be, out_dtype=dt)
        else:
            tokens = patch_embed(feat, ke, be)
        tokens = self.run_trunk(tokens)
        ku, bu = self.patch_unembed_kernel, self.patch_unembed_bias
        if r.pallas_unembed:
            combined = unembed_combine_stream(
                tokens.contiguous(), feat if feat_q is None else feat_q, ku,
                bu, feat_scale=s_feat)
        elif r.i8b:
            tq, s5 = self._act_q("tokens", tokens)
            combined = patch_unembed_int8(tq, s5, ku, bu, out_dtype=dt) + feat
        else:
            combined = patch_unembed(tokens, ku, bu) + feat

        # The decoder conv and branch B (:744-944).
        kd, bd = self.decoder_conv1.kernel, self.decoder_conv1.bias
        if r.fuse_dec:
            bt = conv3x3_tail_stream(combined, kd.to(dt), bd, *tail_b,
                                     out_dtype=todt)
        elif r.i8t:
            dq, s4 = self._conv_q("dec", combined, kd, bd)
            pre = self._pre_q(f"tailB_s{scale}", x.device, tails=True)
            bt = tail_conv_int8_stream(
                dq, *self._int8_weights("tail_b", tail_b[0], s4, tail_b[1],
                                        scale, pre), out_dtype=dt)
        else:
            if r.i8b:
                cq, s3 = self._act_q("combined", combined)
                dec = conv3x3_int8_stream(
                    cq, *self._fold("dec", kd, s3, scale), bd, relu=True,
                    out_dtype=dt)
            elif r.pallas:
                dec = conv3x3_stream(combined, kd.to(dt), bd, relu=True)
            else:
                dec = conv2d(combined, kd, bd, relu=True)
            pallas_b = r.pallas and not r.direct_tails and not r.i8b
            if r.i8b or r.i8dt:
                dq, s4 = self._act_q("dec", dec)
                bt = self._tail_int8("tail_b", dq, tail_b[0], s4, tail_b[1],
                                     False, scale)
            elif r.b_tail == "split":
                (km, bm), (kf, bf) = tail_b
                bt = tail_finish_stream(dec, km, bm, kf, bf, out_dtype=todt,
                                        hi_lo_fin=self._hi_lo_fin(r))
            elif r.b_tail == "factored":
                bt = self._factored_b_tail(dec, *tail_b, r)
            elif pallas_b:
                bt = tail_conv_stream(dec, *tail_b, out_dtype=todt)
            else:  # x6's direct conv, or the all-XLA tail
                kb, bb = tail_b
                bt = conv2d(dec, kb, bb, padding=(kb.shape[0] - 1) // 2)

        # The branch add, the squash or the shuffle, the clip (:946-961).
        # JAX runs the squash at Precision.HIGH under the "squash" part; its
        # f32 products on the CPU are exact, as the port's f32 products are
        # (matmuls run without TF32 unless a caller enables it). The flag
        # still picks the banded squash under TUX_BANDED_RESIZE "auto".
        out = a + bt
        if squash:
            out = resize_shuffled(out, scale, res_out,
                                  precise="squash" in r.qparts)
        else:
            out = pixel_shuffle(out, scale)
        return out.clamp(0.0, 1.0)

    def _hi_lo_fin(self, r: PackedRoute) -> str:
        """The split tail's finish mode: ``hi_lo_fin``, else "wf" under
        serve_quality and "off" otherwise; ``TUX_HILO_FIN`` overrides it,
        with JAX's warning when they differ."""
        mode = self.hi_lo_fin or ("wf" if r.quality else "off")
        env = os.environ.get("TUX_HILO_FIN")
        if env is not None:
            if env != mode:
                warnings.warn(f"TUX_HILO_FIN={env!r} overrides the explicitly "
                              f"passed hi_lo_fin={mode!r} for "
                              f"tail_finish_stream", stacklevel=3)
            mode = env
        return mode

    def _factored_b_tail(self, dec, kc, bc, r: PackedRoute):
        """JAX ``factored_b_tail`` (fast_transformer.py:761-779):
        decoder_conv2, 3x3 64 -> 3, then the composed tail without it, each
        rounded to the compute dtype before its bias as XLA's convs are, each
        zero-padding its own input."""
        if r.tail_f32:
            warnings.warn("TUX_F32_TAIL=1 has no effect on the factored "
                          "branch-B tail (TUX_FOLD_PRE=0): the XLA "
                          "macro-block convs emit the compute dtype.",
                          stacklevel=3)
        dt = self.dtype
        r3 = conv2d(dec, self.decoder_conv2.kernel.to(dt),
                    self.decoder_conv2.bias.to(dt))
        return conv2d(r3, kc, bc, padding=(kc.shape[0] - 1) // 2)


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
