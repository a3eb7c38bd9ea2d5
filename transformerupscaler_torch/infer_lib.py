"""Inference engine (JAX counterpart: transformerupscaler_tpu
infer_lib.py:27-180, the ``upscale`` contract).

It serves every model of ``registry.get_model``. The engine takes a JAX
parameter tree (``weights.params_from_jax`` maps all four models' trees by
name), or draws seeded random weights when given none, as the JAX engine
random-inits when it finds no checkpoint. Reading the committed Orbax
checkpoints needs JAX and is done by the tests only; a reader for the card
waits until the weights exist in a numpy- or torch-readable form.
"""

from __future__ import annotations

import numpy as np
import torch

from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params


class UpscalerEngine:
    """Upscale HWC or NHWC images: uint8 is normalized to [0, 1], float
    input is taken as [0, 1]; returns float32 numpy of the same rank."""

    def __init__(self, model_name: str = "FastTransformer", params=None,
                 dtype=torch.float32, device=None, seed: int = 0, **config):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.dtype = dtype
        self.model = get_model(model_name, device=self.device, dtype=dtype,
                               **config)
        if params is None:
            params = seeded_params(self.model, seed)
        params_from_jax(self.model, params)

    def upscale(self, image: np.ndarray, res_out=None, upscale_factor=None,
                require_ratio: bool = True) -> np.ndarray:
        squeeze = image.ndim == 3
        x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        # Normalize on the device: uint8 crosses the bus, not float32.
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        if squeeze:
            x = x[None]
        if self.model_name == "BicubicInterpolation":
            # It takes res_out only: a scale is resolved to one here.
            if upscale_factor is not None:
                res_out = (x.shape[1] * upscale_factor,
                           x.shape[2] * upscale_factor)
            kwargs = {}
        else:
            kwargs = {"upscale_factor": upscale_factor,
                      "require_ratio": require_ratio}
        if res_out is not None:
            kwargs["res_out"] = tuple(res_out)
        out = self.model(x, **kwargs).float().cpu().numpy()
        return out[0] if squeeze else out
