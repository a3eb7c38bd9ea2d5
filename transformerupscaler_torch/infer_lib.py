"""Inference engine (JAX counterpart: transformerupscaler_tpu
infer_lib.py:27-180, the ``upscale`` contract, and :182-274, 361-382, the
static int8 calibration).

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
from transformerupscaler_torch.models.fast_transformer import INT8_TENSORS
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params


class UpscalerEngine:
    """Upscale HWC or NHWC images: uint8 is normalized to [0, 1], float
    input is taken as [0, 1]; returns float32 numpy of the same rank.

    ``config`` takes the model's fields and the JAX route flags
    (``registry.get_model``); ``int8_serve`` implies ``compose_tails``, as
    in JAX. Built with no flags, the engine serves JAX's default route:
    FastTransformer's exact path at f32 with ``attn_impl="xla"``."""

    def __init__(self, model_name: str = "FastTransformer", params=None,
                 dtype=torch.float32, device=None, seed: int = 0, **config):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.dtype = dtype
        if config.get("int8_serve"):
            config["compose_tails"] = True
        self._config = config
        self.model = get_model(model_name, device=self.device, dtype=dtype,
                               **config)
        if params is None:
            params = seeded_params(self.model, seed)
        self._params = params
        params_from_jax(self.model, params)
        # The model without baked scales: calibration passes measure
        # dynamic scales through it after static ones are baked in.
        self._base_model = self.model
        self._calib_scales = None

    def _input(self, image: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        # Normalize on the device: uint8 crosses the bus, not float32.
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        return x[None] if image.ndim == 3 else x

    def _call(self, model, x, res_out, upscale_factor, require_ratio):
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
        return model(x, **kwargs)

    def upscale(self, image: np.ndarray, res_out=None, upscale_factor=None,
                require_ratio: bool = True) -> np.ndarray:
        out = self._call(self.model, self._input(image), res_out,
                         upscale_factor, require_ratio).float().cpu().numpy()
        return out[0] if image.ndim == 3 else out

    def _dynamic_scales(self, image, res_out, upscale_factor,
                        require_ratio) -> dict:
        """One forward of the model without baked scales; the per-channel
        scales it recorded, by name (``feat``, ``dec``, ...), as float64."""
        model = self._base_model
        self._call(model, self._input(np.asarray(image)), res_out,
                   upscale_factor, require_ratio)
        used = getattr(model, "int8_scales_used", {})
        if not used:
            raise RuntimeError(
                "calibrate_int8: the calibration forward recorded no "
                "activation scale; calibrate an int8_serve FastTransformer")
        return {k[len("int8_scale_"):]: v.double().cpu().numpy()
                for k, v in used.items()}

    def calibrate_int8(self, images, res_out=None, upscale_factor=None,
                       require_ratio: bool = True, margin: float = 1.25,
                       floor_frac: float = 0.02) -> tuple:
        """Static int8 activation calibration (int8_serve engines only).

        One dynamic forward per frame (a HWC/NHWC array or a list of
        frames); per channel the maximum over the frames, floored at
        ``floor_frac`` of the tensor's largest channel (a channel the frames
        never fired would clip the first time a scene does), times
        ``margin``. The engine then serves a model with the scales baked in,
        and the tuple (feat1, feat, combined, dec, tokens) is returned, with
        ``(1.0,)`` for a tensor the scope does not quantize.
        """
        if isinstance(images, np.ndarray) and images.ndim == 4:
            frames = list(images)
        elif isinstance(images, (list, tuple)):
            frames = list(images)
        else:
            frames = [images]
        acc: dict = {}
        for f in frames:
            got = self._dynamic_scales(f, res_out, upscale_factor,
                                       require_ratio)
            for k, v in got.items():
                acc[k] = np.maximum(acc[k], v) if k in acc else v
        self._calib_scales = {
            k: np.maximum(v, floor_frac * v.max()) * margin
            for k, v in acc.items()}
        scales = tuple(tuple(self._calib_scales[n].tolist())
                       if n in self._calib_scales else (1.0,)
                       for n in INT8_TENSORS)
        self.model = get_model(self.model_name, device=self.device,
                               dtype=self.dtype,
                               **{**self._config, "int8_scales": scales})
        params_from_jax(self.model, self._params)
        return scales

    def calibration_check(self, image, res_out=None, upscale_factor=None,
                          require_ratio: bool = True) -> dict:
        """Clip risk of a held-out frame against the baked scales: per
        quantized tensor, the frame's dynamic scale over the static one;
        a ratio above 1 means that channel clips. Returns
        {name: {"max_ratio": r, "clip_channel_frac": f}}."""
        if not self._calib_scales:
            raise RuntimeError("calibration_check requires calibrate_int8 "
                               "to have run first")
        got = self._dynamic_scales(image, res_out, upscale_factor,
                                   require_ratio)
        report = {}
        for k, dyn in got.items():
            ratio = dyn / np.maximum(self._calib_scales[k], 1e-12)
            report[k] = {"max_ratio": float(ratio.max()),
                         "clip_channel_frac": float((ratio > 1.0).mean())}
        return report
