"""A/B evaluation: per-sample MSE of two models over a dataset (JAX
counterpart: the root ab_test.py).

    python3 -m transformerupscaler_torch.ab_test --data_dir DIR \\
        --model_a FastTransformer --model_b BicubicInterpolation [--device cpu]

The flags of the root CLI (ab_test.py:87-104), plus ``--device`` (the card
unless ``--device cpu``), and its filters, skip rule and report. The
samples come from the port's ``data.HighresImageDataset`` (the ``.png``
images of ``--data_dir``, each expanded into the ten scale pairs). With
``--res_in`` / ``--res_out``, a sample of another height is resized to that
height as torchvision's ``Resize(int)`` sizes it (the shorter side to the
size, the longer truncated), by the float antialiased bilinear resize
(``ops.resize.resize(..., "bilinear", antialias=True)``) on the engines'
device, never through uint8. Samples that do not upscale are skipped. The
MSE is taken on the host copies of the outputs (``metrics.mse``).

The engines run eagerly (``cuda_graphs=False``): a sweep meets a new
geometry with every scale pair, and each captured CUDA graph would keep
its own memory pool for the rest of the run; eager and graphed outputs
are the same bit for bit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from transformerupscaler_torch.cli import device_name
from transformerupscaler_torch.data.datasets import HighresImageDataset
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.metrics import mse
from transformerupscaler_torch.ops.resize import resize


def resize_to_height(img_hwc: np.ndarray, height: int,
                     device="cpu") -> np.ndarray:
    """torchvision ``Resize(height)`` on a float HWC image: the shorter
    side to ``height``, the longer int(long * height / short) (truncated),
    antialiased bilinear in float32."""
    h, w = img_hwc.shape[:2]
    if h <= w:
        new_h, new_w = height, max(1, int(w * height / h))
    else:
        new_w, new_h = height, max(1, int(h * height / w))
    x = torch.from_numpy(np.ascontiguousarray(img_hwc, np.float32))
    out = resize(x.to(device), (new_h, new_w), "bilinear", antialias=True)
    return out.cpu().numpy()


def main(args) -> dict:
    """Runs the CLI; returns the totals and the sample count."""
    device = resolve_device(args.device)
    print(f"Running AB test on device: {device} ({device_name(device)})")

    dataset = HighresImageDataset(args.data_dir)

    engine_a = UpscalerEngine(args.model_a, device=device, cuda_graphs=False,
                              checkpoint_dir=args.checkpoint_dir_a)
    engine_b = UpscalerEngine(args.model_b, device=device, cuda_graphs=False,
                              checkpoint_dir=args.checkpoint_dir_b)
    print(f"Model A ({args.model_a}) checkpoint: {engine_a.checkpoint_path}")
    print(f"Model B ({args.model_b}) checkpoint: {engine_b.checkpoint_path}")

    total_loss_a = 0.0
    total_loss_b = 0.0
    processed = 0

    for batch_idx, (lr, hr) in enumerate(dataset):
        if args.res_in is not None and lr.shape[0] != args.res_in:
            lr = resize_to_height(lr, args.res_in, device)
        if args.res_out is not None and hr.shape[0] != args.res_out:
            hr = resize_to_height(hr, args.res_out, device)

        # Skip non-upscales (reference ab_test.py:108-109).
        if hr.shape[0] / lr.shape[0] <= 1 or hr.shape[1] / lr.shape[1] <= 1:
            continue

        target = (hr.shape[0], hr.shape[1])
        out_a = engine_a.upscale(lr, res_out=target)
        out_b = engine_b.upscale(lr, res_out=target)
        total_loss_a += mse(out_a, hr)
        total_loss_b += mse(out_b, hr)
        processed += 1
        if (batch_idx + 1) % args.log_interval == 0:
            print(f"Processed {processed} samples so far...")

    result = dict(total_loss_a=total_loss_a, total_loss_b=total_loss_b,
                  processed=processed)
    if processed == 0:
        print("No samples matched the specified resolution criteria.")
        return result

    print("========================================")
    print(f"Model A ({args.model_a}) Total Loss: {total_loss_a:.6f} | "
          f"Average Loss: {total_loss_a / processed:.6f}")
    print(f"Model B ({args.model_b}) Total Loss: {total_loss_b:.6f} | "
          f"Average Loss: {total_loss_b / processed:.6f}")
    print("========================================")
    return result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="AB Test for Transformer Upscaler Models on the GPU")
    p.add_argument("--data_dir", type=str, default="images/training_set",
                   help="Directory containing images (.png)")
    p.add_argument("--batch_size", type=int, default=1,
                   help="Accepted for reference-CLI parity (iteration is "
                        "per-sample)")
    p.add_argument("--log_interval", type=int, default=10,
                   help="Log progress every N samples")
    p.add_argument("--model_a", type=str, required=True, help="Model A name")
    p.add_argument("--model_b", type=str, required=True, help="Model B name")
    p.add_argument("--checkpoint_dir_a", type=str, default=None,
                   help="Checkpoint directory for model A (default: "
                        "models/{model_a}/checkpoints/)")
    p.add_argument("--checkpoint_dir_b", type=str, default=None,
                   help="Checkpoint directory for model B (default: "
                        "models/{model_b}/checkpoints/)")
    p.add_argument("--res_in", type=int, default=None,
                   help="Restrict to LR images with this height")
    p.add_argument("--res_out", type=int, default=None,
                   help="Restrict to HR images with this height")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card ('cpu' to run "
                        "without one)")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
