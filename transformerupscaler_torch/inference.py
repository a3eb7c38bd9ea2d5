"""Single-image upscale with quality scores (JAX counterpart: the root
inference.py).

    python3 -m transformerupscaler_torch.inference \\
        --image_path models/FastTransformer/demo/model_x6.png \\
        --res_in 720 --scale 2 --fast [--device cpu]

The flags and defaults of the root CLI (inference.py:141-190), plus
``--device`` (the card unless ``--device cpu``), and its report: the
device, the saved paths, the "Bicubic Scores" and "Model Scores" lines and
the parameter count.

- The image is read with ``png.read_png`` and, with ``--res_in``,
  downscaled by ``native.resize_bilinear_u8`` (PIL's antialiased bilinear
  filter, within one level of PIL's pixels). It is saved as ``--inp``, and
  its PIL-BICUBIC upscale by ``--scale`` (``native.resize_bicubic_u8``, bit
  for bit PIL's) as ``bicubic.png``.
- The engine gets the root CLI's flags (``cli.serve_flags``): on the card
  ``--fast`` / ``--quality`` serve the stream kernels and the fused trunk
  (``pallas_serve=True, attn_impl="fused2"``), as the root CLI does on a
  TPU; under ``--device cpu`` they serve JAX's choice off a TPU, the
  all-XLA packed path. The card's stream kernels take bf16: where they
  serve and ``--dtype`` is f32, the CLI says so and computes in bf16 (the
  root CLI makes the same switch for ``--quality``).
- The output is saved as ``(clip(out, 0, 1) * 255).astype(uint8)``
  (truncation, as the root CLI), read back, and scored with
  ``metrics.ssim`` / ``metrics.psnr`` against the original, bilinear-
  resized to the output's size where they differ; the bicubic control arm
  is the saved input bilinear-resized to that size, as in the root CLI.

The card's host has no JPEG codec, so the defaults are ``input.png``,
``model.png`` and ``bicubic.png``, and a ``.jpg`` image, ``--inp`` or
``--out`` raises naming the missing decoder or encoder. The root CLI's
scores are taken on its re-read JPEG output (lossy), the port's on a
lossless PNG: run the root CLI with PNG paths to compare the two.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from transformerupscaler_torch.cli import (
    card_dtype,
    device_name,
    read_image,
    require_png,
    serve_flags,
    write_image,
)
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.metrics import psnr, ssim
from transformerupscaler_torch.native import (
    resize_bicubic_u8,
    resize_bilinear_u8,
)
from transformerupscaler_torch.resolutions import resolutions

BICUBIC_PATH = "bicubic.png"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _u8_float(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, dtype=np.float32) / 255.0


def main(args) -> dict:
    """Runs the CLI; returns the scores and the model's float32 output."""
    if args.scale not in [2, 3, 4, 6]:
        print(f"Resolution {args.scale} not found in supported output "
              f"resolutions.")
        sys.exit(-1)
    if args.res_in:
        if args.res_in not in resolutions:
            print(f"Resolution {args.res_in} not found in supported input "
                  f"resolutions.")
            sys.exit(-1)
        res_in = resolutions[args.res_in]
    else:
        res_in = None
    require_png(args.image_path, "decoder")
    require_png(args.inp, "encoder")
    require_png(args.out, "encoder")

    device = resolve_device(args.device)
    print(f"Running inference on device: {device} ({device_name(device)})")

    image = read_image(args.image_path)
    lr_image = (resize_bilinear_u8(image, res_in) if res_in is not None
                else image)
    lr = _u8_float(lr_image)
    write_image(args.inp, lr_image)
    print(f"Downscaled image saved to: {args.inp}")

    h, w = lr_image.shape[:2]
    write_image(BICUBIC_PATH, resize_bicubic_u8(
        lr_image, (h * args.scale, w * args.scale)))
    print(f"Bicubic image saved to: {BICUBIC_PATH}")

    dtype = DTYPES[args.dtype]
    if args.quality and dtype == torch.float32:
        print("--quality implies the bf16 serving path; using bf16 compute")
        dtype = torch.bfloat16
    card = device.type == "cuda"
    flags = serve_flags(args.fast, args.quality, args.int8_serve,
                        args.int8_trunk, card)
    dtype = card_dtype(dtype, flags, card)
    engine = UpscalerEngine(args.model, checkpoint_dir=args.checkpoint_dir,
                            quantize=args.quantize, dtype=dtype,
                            device=device, int8_mlp=args.int8_mlp,
                            int8_trunk=args.int8_trunk, **flags)
    if engine.checkpoint_path:
        print(f"Loading checkpoint: {engine.checkpoint_path}")
    else:
        print(f"No checkpoint found for {args.model}; using random init")
    if args.quantize:
        print("Applied int8 weight quantization to linear layers.")

    out = engine.upscale(lr, upscale_factor=args.scale)
    n_params = engine.param_count()

    write_image(args.out, (np.clip(out, 0, 1) * 255).astype(np.uint8))
    print(f"Upscaled image saved to: {args.out}")

    original_u8 = read_image(args.image_path)
    pred = _u8_float(read_image(args.out))
    if original_u8.shape[:2] != pred.shape[:2]:
        original_u8 = resize_bilinear_u8(original_u8, pred.shape[:2])
    original = _u8_float(original_u8)
    lowres_up = _u8_float(resize_bilinear_u8(read_image(args.inp),
                                             original.shape[:2]))

    scores = dict(
        model_ssim=ssim(original, pred, data_range=1, channel_axis=-1),
        model_psnr=psnr(original, pred, data_range=1),
        bicubic_ssim=ssim(original, lowres_up, data_range=1, channel_axis=-1),
        bicubic_psnr=psnr(original, lowres_up, data_range=1))
    print(f"Bicubic Scores:\tSSIM: {scores['bicubic_ssim']:.4f}, "
          f"PSNR: {scores['bicubic_psnr']:.2f} dB")
    print(f"Model Scores:\tSSIM: {scores['model_ssim']:.4f}, "
          f"PSNR: {scores['model_psnr']:.2f} dB")
    print(f"Model has {n_params} trainable parameters")
    return dict(scores, output=out, n_params=n_params, dtype=dtype)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Inference script for the Transformer upscaler on the "
                    "GPU with dynamic input resolution and quantization")
    p.add_argument("--image_path", type=str,
                   default="images/training_set/image_100.png",
                   help="Path to the input image file (.png)")
    p.add_argument("--model", type=str, default="FastTransformer",
                   help="Model name from the registry")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Directory containing model checkpoints (default: "
                        "models/{model}/checkpoints/)")
    p.add_argument("--scale", type=int, default=3,
                   help="Output resolution scale (2, 3, 4, 6)")
    p.add_argument("--res_in", type=str, default=None,
                   help="Input resolution key (None for no downscaling)")
    p.add_argument("--inp", type=str, default="input.png",
                   help="Output file path for the downscaled input image "
                        "(.png)")
    p.add_argument("--out", type=str, default="model.png",
                   help="Output file path for the upscaled output image "
                        "(.png)")
    p.add_argument("--compile", action="store_true",
                   help="Accepted for reference-CLI parity; the card serves "
                        "each geometry from a CUDA graph anyway")
    p.add_argument("--quantize", action="store_true",
                   help="Enable int8 quantization of linear layers")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="Inference compute dtype")
    p.add_argument("--fast", action="store_true",
                   help="packed bf16 serving fast path (composed tails; on "
                        "the card the stream kernels and the fused trunk). "
                        "Requires scale in {2,3,4,6}, input h %% 8 == 0 and "
                        "w %% 16 == 0; other geometries fall back with a "
                        "warning")
    p.add_argument("--quality", action="store_true",
                   help="serve_quality mode: the --fast bf16 serving path "
                        "with f32 image boundaries. Implies --fast")
    p.add_argument("--int8_serve",
                   choices=["off", "residual", "full", "tails"],
                   default="off",
                   help="int8 conv/GEMM serving scope on the packed path "
                        "('residual' keeps the image branch bf16)")
    p.add_argument("--int8_mlp", action="store_true",
                   help="Run transformer MLP GEMMs as int8 products")
    p.add_argument("--int8_trunk", action="store_true",
                   help="rowwise int8 trunk GEMMs inside the fused trunk "
                        "(composes with --fast/--int8_serve)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card ('cpu' to run "
                        "without one)")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
