"""Hand-written Hopper kernels of the port: wrappers, plain PyTorch versions
and launch counters. ``PLAIN_VERSIONS`` maps every wrapper a model calls to
the plain version that computes the same function, ``ARCHIVED_PLAIN_VERSIONS``
likewise every wrapper of an archived TPU kernel, which no model calls."""

from transformerupscaler_torch.kernels import (
    conv3x3,
    encoder,
    gmha,
    patch_kernels,
    stream,
    trunk2,
    window_attn,
)
from transformerupscaler_torch.kernels._common import (
    ARCHIVED_LAUNCHES,
    LAUNCHES,
    MODE_LAUNCHES,
    OPTION_LAUNCHES,
    add_launches,
    launch_counts,
    reset_launches,
)

PLAIN_VERSIONS = {
    "conv3x3_stream": stream.conv3x3_plain,
    "tail_conv_stream": stream.tail_conv_plain,
    "embed_stream": stream.embed_plain,
    "unembed_combine_stream": stream.unembed_combine_plain,
    "tail_finish_stream": stream.tail_finish_plain,
    "fused_window_trunk": trunk2.fused_window_trunk_plain,
    "window_attention_core": window_attn.window_attention_plain,
    "global_mha": gmha.global_mha_plain,
    "conv3x3_int8_stream": stream.conv3x3_int8_plain,
    "tail_conv_int8_stream": stream.tail_conv_int8_plain,
    "conv1_stream": stream.conv1_plain,
    "conv3x3_tail_stream": stream.conv3x3_tail_plain,
    "conv3x3_tail_emit_stream": stream.conv3x3_tail_emit_plain,
}
ARCHIVED_PLAIN_VERSIONS = {
    "conv3x3": conv3x3.conv3x3_plain,
    "fused_patch_embed": patch_kernels.fused_patch_embed_plain,
    "fused_patch_unembed_add": patch_kernels.fused_patch_unembed_add_plain,
}

__all__ = ["ARCHIVED_LAUNCHES", "ARCHIVED_PLAIN_VERSIONS", "LAUNCHES",
           "MODE_LAUNCHES", "OPTION_LAUNCHES", "PLAIN_VERSIONS",
           "add_launches", "conv3x3", "encoder", "gmha", "launch_counts",
           "patch_kernels", "reset_launches", "stream", "trunk2",
           "window_attn"]
