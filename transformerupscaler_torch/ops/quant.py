"""Int8 quantization for the fused trunk's rowwise mode.

The port's own copy of what that mode needs from the JAX package: the
weights as ``quantize_gemm_weights`` (transformerupscaler_tpu/ops/pallas/
trunk2.py:506) quantizes them, with the rowwise scale of trunk2.py:724-734,
and the per-token activation quantize of trunk2.py:176-178. Symmetric, round
half to even, every step in f32 as there.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def _f32(v: float) -> torch.Tensor:
    """A Python constant as the f32 value a weakly typed JAX scalar takes."""
    return torch.tensor(v, dtype=_F32)


def rowwise_weights(wstack: torch.Tensor):
    """(wq int8 (L, k, n), sw f32 (L, n)) from stacked (L, k, n) GEMM
    weights (as ``dt`` values), per output channel: sw0 = max(max_k |w| /
    127, 1e-8), wq = clip(round(w / sw0), -127, 127). The per-row
    activation scale applies at run time, so the static path's /127 is
    undone as the reference undoes it: sw = (sw0 / 127) * 127 in f32, which
    is not always sw0."""
    wf = wstack.to(_F32)
    sw = torch.maximum(wf.abs().amax(dim=1) / _f32(127.0), _f32(1e-8))
    wq = torch.clamp(torch.round(wf / sw[:, None]), -127, 127)
    return wq.to(torch.int8), (sw / _f32(127.0)) * _f32(127.0)


def quantize_rows(x: torch.Tensor):
    """(xq, srow): per token row of ``x`` (..., k), srow = max(max|x_row|,
    1e-6) * (1/127) in f32 and xq = round_half_even(x * (1 / srow)), as
    float values in [-127, 127]; srow keeps a trailing axis of 1."""
    xf = x.to(_F32)
    srow = torch.maximum(xf.abs().amax(dim=-1, keepdim=True),
                         _f32(1e-6)) * _f32(1.0 / 127.0)
    return torch.round(xf * torch.reciprocal(srow)), srow
