"""Inference engine (JAX counterpart: transformerupscaler_tpu/infer_lib.py).

It serves every model of ``registry.get_model``. Given no parameters, it
loads the latest ``model_epoch_{n}`` checkpoint of the model, as the JAX
engine does (``checkpoint``: the committed Orbax checkpoints through their
numpy copies), and draws seeded random weights only where there is no
checkpoint, as the JAX engine random-inits there.

The JAX engine compiles each geometry once (its per-geometry jit cache). On
the card this engine captures each geometry's forward once in a CUDA graph,
from a static input buffer to the float32 output, and replays it for every
later frame of that geometry; ``cuda_graphs=False`` runs every frame
eagerly, as the engine does on the CPU.
"""

from __future__ import annotations

import functools
import os
import time
import traceback
import warnings

import numpy as np
import torch

from transformerupscaler_torch.checkpoint import (
    default_checkpoint_dir,
    get_latest_checkpoint,
    load_checkpoint,
    param_count,
)
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.kernels import add_launches, launch_counts
from transformerupscaler_torch.models.common import resolve_geometry
from transformerupscaler_torch.models.fast_transformer import INT8_TENSORS
from transformerupscaler_torch.ops.quant import quantize_linear_params
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

DEFAULT_RES_OUT = (1080, 1920)  # every model's res_out when given none


class CapturedForward:
    """One geometry's forward in a CUDA graph: ``static_in`` (NHWC frames
    as the caller gives them, on the card) to ``out`` (float32 NHWC).

    The forward runs twice eagerly on a side stream first, so that kernels
    build, derived weights are cached and every allocation of the forward
    is seen before capture. The launch counters tick in Python, so they
    tick at capture and not at replay: the capture's launches are taken off
    the counters again and added back on every replay, which keeps them per
    frame as on the eager path."""

    def __init__(self, forward, frame: torch.Tensor, what: str):
        self.static_in = frame
        main = torch.cuda.current_stream(frame.device)
        side = torch.cuda.Stream(frame.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(2):
                forward(self.static_in)
        main.wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.out = forward(self.static_in)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {what} failed at "
                               f"{_failing_op(e)}: {e}") from e
        self.launches = {k: n - before[k]
                         for k, n in launch_counts().items()
                         if n != before[k]}
        add_launches({k: -n for k, n in self.launches.items()})

    def replay(self) -> torch.Tensor:
        """Run the captured forward on ``static_in``; returns ``out``, which
        the next replay overwrites."""
        self.graph.replay()
        add_launches(self.launches)
        return self.out


def _failing_op(err: BaseException) -> str:
    """The innermost line of the port's model code in the tracebacks of
    ``err`` and the errors it was raised while handling: the op a capture
    failed on (the capture's own end reports only that it failed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    while err is not None:
        ours = [fr for fr in traceback.extract_tb(err.__traceback__)
                if fr.filename.startswith(here)
                and not fr.filename.endswith("infer_lib.py")]
        if ours:
            fr = ours[-1]
            return (f"{os.path.relpath(fr.filename, here)}:{fr.lineno} "
                    f"`{fr.line}`")
        err = err.__context__
    return "an op outside the port's code"


class UpscalerEngine:
    """Upscale HWC or NHWC images: uint8 is normalized to [0, 1] on the
    device, float input is taken as [0, 1]; returns float32 numpy of the
    same rank, or with ``device_out`` the device tensor.

    ``config`` takes the model's fields and the JAX route flags
    (``registry.get_model``); ``int8_serve`` implies ``compose_tails``, as
    in JAX. Built with no flags, the engine serves JAX's default route:
    FastTransformer's exact path at f32 with ``attn_impl="xla"``.

    Weights: ``params`` (a JAX tree) if given, else the latest checkpoint in
    ``checkpoint_dir`` (default ``models/<model_name>/checkpoints`` under
    ``root``), recorded as ``epoch`` and ``checkpoint_path``; where there
    is none, ``seeded_params(model, seed)`` with ``epoch`` 0. A checkpoint
    that does not fit the configured model raises. ``quantize`` int8
    round-trips the linear kernels of given or loaded weights (the
    reference's ``--quantize``)."""

    def __init__(self, model_name: str = "FastTransformer",
                 checkpoint_dir: str | None = None, params=None,
                 dtype=torch.float32, device=None, seed: int = 0,
                 root: str = ".", quantize: bool = False,
                 cuda_graphs: bool = True, **config):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.dtype = dtype
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        if config.get("int8_serve"):
            config["compose_tails"] = True
        self._config = config
        self.model = get_model(model_name, device=self.device, dtype=dtype,
                               **config)
        self.epoch = self.checkpoint_path = None
        seeded = params is None
        if params is None:
            ckpt_dir = checkpoint_dir or default_checkpoint_dir(model_name,
                                                                root)
            try:
                path, epoch = get_latest_checkpoint(ckpt_dir)
            except (FileNotFoundError, NotADirectoryError):
                # No checkpoint: seeded weights, never quantized (the JAX
                # engine random-inits at the first call, unquantized).
                self.epoch = 0
                params = seeded_params(self.model, seed)
            else:
                seeded = False
                self.checkpoint_path, self.epoch = path, epoch
                params = load_checkpoint(path, model_name)
        if quantize and not seeded:
            params = quantize_linear_params(params)
        self._params = params
        params_from_jax(self.model, params)
        # The model without baked scales: calibration passes measure
        # dynamic scales through it after static ones are baked in.
        self._base_model = self.model
        self._calib_scales = None
        self._cache: dict = {}
        self._warned_fast_gate = False

    def param_count(self) -> int:
        return param_count(self._params)

    def _input(self, image: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def _normalize_call(self, x_shape, res_out, upscale_factor):
        # Bicubic takes res_out only: a scale is resolved to one here.
        if self.model_name == "BicubicInterpolation" and \
                upscale_factor is not None:
            h, w = x_shape[-3:-1]
            return (h * upscale_factor, w * upscale_factor), None
        return res_out, upscale_factor

    def _forward(self, model, x, res_out, upscale_factor, require_ratio):
        """uint8 or float frames on the device -> the model's float32
        output; uint8 is normalized here, on the device, so that uint8 and
        not float32 crosses the bus."""
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        x = x[None] if x.ndim == 3 else x
        kwargs = {}
        if self.model_name != "BicubicInterpolation":
            kwargs = {"upscale_factor": upscale_factor,
                      "require_ratio": require_ratio}
        if res_out is not None:
            kwargs["res_out"] = tuple(res_out)
        return model(x, **kwargs).float()

    def _warn_if_fast_gate_misses(self, x_shape, res_out, upscale_factor):
        """The --fast / --int8 flags fall back to the plain compose path
        for geometries their packed path does not take; say so once, so
        that a command-line user knows the flag did nothing (JAX
        infer_lib.py:119-141, the same condition and message)."""
        if not (self._config.get("packed_serve")
                or self._config.get("int8_serve")):
            return
        if self.model_name != "FastTransformer" or self._warned_fast_gate:
            return
        h, w = x_shape[1:3]
        _, scale = resolve_geometry((h, w), res_out or DEFAULT_RES_OUT,
                                    upscale_factor)
        if scale in (2, 3, 4, 6) and h % 8 == 0 and w % 16 == 0:
            return
        self._warned_fast_gate = True
        warnings.warn(
            f"fast/int8 serving path requires scale in {{2,3,4,6}} with "
            f"input h % 8 == 0 and w % 16 == 0; got {h}x{w} at scale "
            f"{scale} — falling back to the plain (bf16, unquantized) "
            f"compose path for this geometry.", stacklevel=3)

    def captured(self, image: np.ndarray, res_out=None, upscale_factor=None,
                 require_ratio: bool = True) -> CapturedForward:
        """The CUDA graph of ``image``'s geometry (NHWC shape, dtype,
        res_out, upscale_factor, require_ratio), captured on first use from
        ``image`` (CUDA engines only). A capture that fails raises."""
        image = np.asarray(image)
        frames = image[None] if image.ndim == 3 else image
        res_out, upscale_factor = self._normalize_call(frames.shape, res_out,
                                                       upscale_factor)
        key = (None if res_out is None else tuple(res_out), upscale_factor,
               require_ratio, frames.shape, frames.dtype.str)
        if key not in self._cache:
            forward = functools.partial(self._forward, self.model,
                                        res_out=res_out,
                                        upscale_factor=upscale_factor,
                                        require_ratio=require_ratio)
            self._cache[key] = CapturedForward(
                forward, self._input(frames),
                what=f"{self.model_name} {self._config} on {key}")
        return self._cache[key]

    def upscale(self, image: np.ndarray, res_out=None, upscale_factor=None,
                require_ratio: bool = True, device_out: bool = False):
        """Upscale HWC or NHWC image(s); returns the same rank back: float32
        numpy, or with ``device_out`` a float32 tensor on the engine's
        device (never the graph's own buffer)."""
        image = np.asarray(image)
        squeeze = image.ndim == 3
        nhwc = (1, *image.shape) if squeeze else image.shape
        res_out, upscale_factor = self._normalize_call(nhwc, res_out,
                                                       upscale_factor)
        self._warn_if_fast_gate_misses(nhwc, res_out, upscale_factor)
        if self.cuda_graphs:
            g = self.captured(image, res_out, upscale_factor, require_ratio)
            g.static_in.copy_(torch.from_numpy(
                np.ascontiguousarray(image)).reshape(nhwc))
            out = g.replay()
            if device_out:
                out = out.clone()
        else:
            out = self._forward(self.model, self._input(image), res_out,
                                upscale_factor, require_ratio)
        if not device_out:
            out = out.cpu().numpy()
        return out[0] if squeeze else out

    def warmup(self, in_hw: tuple[int, int], res_out=None,
               upscale_factor=None, require_ratio: bool = True,
               batch: int = 1) -> float:
        """Serve one batch of zero uint8 frames of this geometry ahead of
        use (on the card: capture its graph; float frames are another
        graph); returns the seconds."""
        x = np.zeros((batch, *in_hw, 3), np.uint8)
        t0 = time.perf_counter()
        y = self.upscale(x, res_out=res_out, upscale_factor=upscale_factor,
                         require_ratio=require_ratio, device_out=True)
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        return time.perf_counter() - t0

    def _dynamic_scales(self, image, res_out, upscale_factor,
                        require_ratio) -> dict:
        """One eager forward of the model without baked scales; the
        per-channel scales it recorded, by name (``feat``, ``dec``, ...), as
        float64."""
        model = self._base_model
        image = np.asarray(image)
        res_out, upscale_factor = self._normalize_call(image.shape, res_out,
                                                       upscale_factor)
        self._forward(model, self._input(image), res_out, upscale_factor,
                      require_ratio)
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
        ``margin``. The engine then serves a model with the scales baked in
        (its graphs are captured anew), and the tuple (feat1, feat,
        combined, dec, tokens) is returned, with ``(1.0,)`` for a tensor the
        scope does not quantize.
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
        self._cache.clear()
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
