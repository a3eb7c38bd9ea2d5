"""BicubicInterpolation: the parameterless baseline the other models are
compared with.

JAX counterpart: transformerupscaler_tpu models/bicubic.py:23. Like it, the
model takes (x, res_out) only; ``UpscalerEngine`` resolves an
``upscale_factor`` to a ``res_out`` before calling it. No TPU kernel lies on
this path and none of the port's kernels does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from transformerupscaler_torch.models.common import inference_unless_training
from transformerupscaler_torch.ops.resize import interpolate_bicubic


class BicubicInterpolation(nn.Module):
    """x: (B, H, W, C) -> (B, res_out..., C) in x's dtype, not clipped."""

    def __init__(self):
        super().__init__()
        self.eval()  # serves in eval mode, as the other models

    @inference_unless_training
    def forward(self, x: torch.Tensor, res_out=(1080, 1920)) -> torch.Tensor:
        return interpolate_bicubic(x, tuple(res_out))
