"""Hand-written Hopper kernels of the port: wrappers, plain PyTorch versions
and launch counters. ``PLAIN_VERSIONS`` maps every wrapper to the plain
version that computes the same function."""

from transformerupscaler_torch.kernels import (
    encoder,
    gmha,
    stream,
    trunk2,
    window_attn,
)
from transformerupscaler_torch.kernels._common import (
    LAUNCHES,
    MODE_LAUNCHES,
    OPTION_LAUNCHES,
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

__all__ = ["LAUNCHES", "MODE_LAUNCHES", "OPTION_LAUNCHES", "PLAIN_VERSIONS",
           "encoder", "gmha", "launch_counts", "reset_launches", "stream",
           "trunk2", "window_attn"]
