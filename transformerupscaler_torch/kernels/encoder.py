"""The fused encoder and decoder of the JAX package's archived
``ops/pallas/encoder.py``, served by the fused conv + tail kernel
(``csrc/conv_tail.cu``) through the wrappers of ``kernels/stream.py``.

=====================  =============================  ==========================
adapter                wrapper it calls               TPU kernel it replaces
=====================  =============================  ==========================
``fused_encoder``      ``conv3x3_tail_emit_stream``   ops/pallas/encoder.py:239
                                                      ``fused_encoder``
``fused_decoder``      ``conv3x3_tail_stream``        ops/pallas/encoder.py:279
                                                      ``fused_decoder``
=====================  =============================  ==========================

They compute the functions of ``conv3x3_tail_emit_stream`` and
``conv3x3_tail_stream`` on the TPU's width-2 packed layout; the one
difference is that they round both biases to the compute dtype first
(encoder.py:250-254, 290-294). The port's tensors are NHWC, so the tail
output is (B, H, W, co), which is what the TPU kernels' macro-8 output
(B, H, W / 8, 8 co) is, reshaped. No model reaches them (the JAX package
kept them as a record, and its tests call them); a launch counts under the
wrapper the adapter calls.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels.stream import (
    conv3x3_tail_emit_plain,
    conv3x3_tail_emit_stream,
    conv3x3_tail_plain,
    conv3x3_tail_stream,
)


def _rounded(bias, dtype):
    return None if bias is None else bias.to(dtype)


def fused_encoder(feat1: torch.Tensor, k2, b2, ka, ba, relu_a: bool = True):
    """conv2 (3x3 64 -> 64 + bias + ReLU) and the composed branch-A tail
    (k x k 64 -> co + bias, ReLU if ``relu_a``) in one kernel.

    feat1: (B, H, W, 64), conv1's output. Returns (feat (B, H, W, 64),
    a (B, H, W, co)), both in feat1's dtype."""
    dt = feat1.dtype
    a, feat = conv3x3_tail_emit_stream(feat1, k2, _rounded(b2, dt), ka,
                                       _rounded(ba, dt), relu_a)
    return feat, a


def fused_encoder_plain(feat1, k2, b2, ka, ba, relu_a: bool = True):
    """Plain version of ``fused_encoder``."""
    dt = feat1.dtype
    a, feat = conv3x3_tail_emit_plain(feat1, k2, _rounded(b2, dt), ka,
                                      _rounded(ba, dt), relu_a)
    return feat, a


def fused_decoder(combined: torch.Tensor, k1, b1, kc, bc) -> torch.Tensor:
    """decoder_conv1 (3x3 64 -> 64 + bias + ReLU) and the composed
    dec2-and-branch-B tail (k x k 64 -> co + bias, no ReLU) in one kernel.

    combined: (B, H, W, 64). Returns (B, H, W, co) in combined's dtype."""
    dt = combined.dtype
    return conv3x3_tail_stream(combined, k1, _rounded(b1, dt), kc,
                               _rounded(bc, dt), False)


def fused_decoder_plain(combined, k1, b1, kc, bc) -> torch.Tensor:
    """Plain version of ``fused_decoder``."""
    dt = combined.dtype
    return conv3x3_tail_plain(combined, k1, _rounded(b1, dt), kc,
                              _rounded(bc, dt), False)
