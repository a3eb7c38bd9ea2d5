"""Throughput test: per-image inference time to 4K (JAX counterpart: the
root speed_test.py).

    python3 -m transformerupscaler_torch.speed_test --data_dir DIR --fast
    python3 -m transformerupscaler_torch.speed_test --data_dir DIR --mesh -1

The flags of the root CLI (speed_test.py:149-182), plus ``--device`` (the
card unless ``--device cpu``), its workload (every sample of the port's
``data.HighresImageDataset`` upscaled to ``--res_out``) and its report
(the compile time, the summed per-image time, the wall-clock time, the
average per image).

- The engine gets the root CLI's flags (``cli.serve_flags``, with the card
  in the TPU's place) and bf16 exactly when ``--fast`` (or ``--quality``)
  is given; where the card's stream kernels serve without it, bf16 too,
  said on stdout (they take nothing else).
- Samples are uint8, normalized on the device as the engine does it
  (uint8 / 255, the dataset's own float values). Each new geometry pays
  ``engine.warmup``, which on the card captures that geometry's CUDA
  graph; that time is the compile time and stays out of the per-image
  times. An image's time is ``upscale(..., device_out=True)`` through
  ``torch.cuda.synchronize``. A geometry the model refuses (ValueError,
  e.g. a scale outside {2, 3, 4, 6}) is skipped and counted.
- ``--mesh N`` (-1: every device) serves batches over a mesh's data axis
  (``parallel.batch_infer.ShardedUpscaler``, bf16, the model's default
  route) on the dataset's float frames, as JAX's does: samples grouped by
  geometry, one warm-up batch per geometry, chunks of the data-axis size,
  the same report. Under ``--device cpu``
  the mesh repeats the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from transformerupscaler_torch.checkpoint import load_latest_params
from transformerupscaler_torch.cli import card_dtype, device_name, serve_flags
from transformerupscaler_torch.data.datasets import HighresImageDataset
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.parallel.batch_infer import ShardedUpscaler
from transformerupscaler_torch.parallel.mesh import cli_mesh
from transformerupscaler_torch.resolutions import resolutions


def _sync(out) -> None:
    for t in out if isinstance(out, list) else [out]:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


def _report(compile_time, total_inference_time, overall_time,
            total_images) -> dict:
    average = total_inference_time / total_images if total_images else 0.0
    print(f"Compile time (excluded from per-image stats): "
          f"{compile_time:.4f} seconds")
    print(f"Total inference time (sum over images): "
          f"{total_inference_time:.4f} seconds")
    print(f"Overall wall-clock time: {overall_time:.4f} seconds")
    print(f"Average inference time per image: {average:.4f} seconds")
    return dict(compile_s=compile_time, total_s=total_inference_time,
                wall_s=overall_time, average_s=average, images=total_images)


def main(args) -> dict:
    """Runs the CLI; returns the report's numbers (and ``skipped``)."""
    device = resolve_device(args.device)
    print(f"Running speed test on device: {device} ({device_name(device)})")
    if args.mesh:
        return main_sharded(args, device)

    res_out = resolutions[args.res_out]
    card = device.type == "cuda"
    flags = serve_flags(args.fast, args.quality, args.int8, args.int8_trunk,
                        card)
    dtype = torch.bfloat16 if args.fast or args.quality else torch.float32
    engine = UpscalerEngine(args.model, checkpoint_dir=args.checkpoint_dir,
                            dtype=card_dtype(dtype, flags, card),
                            device=device, int8_trunk=args.int8_trunk,
                            **flags)
    if engine.checkpoint_path:
        print(f"Loading checkpoint from: {engine.checkpoint_path}")
    else:
        print(f"No checkpoint found for {args.model}; using random init")

    dataset = HighresImageDataset(args.data_dir, uint8=True)
    total_images = len(dataset)
    print(f"Processing {total_images} images...")

    total_inference_time = 0.0
    compile_time = 0.0
    seen_geometries = set()

    skipped = 0
    overall_start = time.time()
    for lr, _ in dataset:
        geom = lr.shape[:2]
        try:
            if geom not in seen_geometries:
                compile_time += engine.warmup(geom, res_out=res_out)
                seen_geometries.add(geom)
            start = time.time()
            _sync(engine.upscale(lr, res_out=res_out, device_out=True))
            total_inference_time += time.time() - start
        except ValueError as e:
            # e.g. FastTransformer's upsampler takes scales {2, 3, 4, 6}; a
            # 96x96 sample to 4K is scale 40.
            if not skipped:
                print(f"Skipping unsupported sample geometry {geom}: {e}")
            skipped += 1
            total_images -= 1
            seen_geometries.add(geom)
    overall_time = time.time() - overall_start
    if skipped:
        print(f"Skipped {skipped} samples with unsupported scales")
    return dict(_report(compile_time, total_inference_time, overall_time,
                        total_images), skipped=skipped)


def main_sharded(args, device) -> dict:
    """The image stream batch-sharded over a mesh's data axis: each device
    upscales its share of every chunk, no collectives on the forward
    path."""
    res_out = resolutions[args.res_out]
    mesh = cli_mesh(args.mesh, 1, device)
    n = mesh.shape["data"]
    print(f"Device mesh: {mesh.shape} — batch-sharded inference")
    params = load_latest_params(args.model, args.checkpoint_dir)
    print("Loaded checkpoint" if params else "No checkpoint; random init")
    upscaler = ShardedUpscaler(args.model, mesh, params=params)

    dataset = HighresImageDataset(args.data_dir)
    groups: dict = {}
    skipped = 0
    for lr, _ in dataset:
        h, w = lr.shape[:2]
        scale = max(-(-res_out[0] // h), -(-res_out[1] // w))
        if scale not in (2, 3, 4, 6):
            skipped += 1
            continue
        groups.setdefault((h, w), []).append(np.asarray(lr))
    if skipped:
        print(f"Skipped {skipped} samples with unsupported scales")

    total_images = sum(len(v) for v in groups.values())
    print(f"Processing {total_images} images in {len(groups)} "
          f"geometries...")
    compile_time = total_inference_time = 0.0
    overall_start = time.time()
    for images in groups.values():
        t0 = time.time()
        _sync(upscaler.upscale_batch(np.stack(images[:1] * n), res_out))
        compile_time += time.time() - t0
        for i in range(0, len(images), n):
            chunk = np.stack(images[i:i + n])
            t0 = time.time()
            _sync(upscaler.upscale_batch(chunk, res_out))
            total_inference_time += time.time() - t0
    overall_time = time.time() - overall_start
    return dict(_report(compile_time, total_inference_time, overall_time,
                        total_images), skipped=skipped, mesh=mesh.shape)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Speed test for Transformer upscaler inference on the "
                    "GPU")
    p.add_argument("--data_dir", type=str, required=True,
                   help="Directory containing images (.png) for inference")
    p.add_argument("--model", type=str, default="FastTransformer",
                   help="Model name from the registry")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Directory containing model checkpoints (default: "
                        "models/{model}/checkpoints/)")
    p.add_argument("--mesh", type=int, default=0,
                   help="Shard the image stream over a mesh of this many "
                        "devices (-1 = all; 0 = single device)")
    p.add_argument("--fast", action="store_true",
                   help="bf16 packed serving fast path; geometries outside "
                        "the packed gate (scale in {2,3,4,6}, h %% 8 == 0, "
                        "w %% 16 == 0) fall back with a warning")
    p.add_argument("--quality", action="store_true",
                   help="serve_quality mode: the --fast bf16 path with f32 "
                        "image boundaries. Implies --fast")
    p.add_argument("--int8", choices=["off", "residual", "full", "tails"],
                   default="off",
                   help="int8 serving scope on the packed path")
    p.add_argument("--int8_trunk", action="store_true",
                   help="rowwise int8 trunk GEMMs inside the fused trunk "
                        "(composes with --fast/--int8)")
    p.add_argument("--res_out", type=str, default="4k",
                   help="Output resolution name (the reference hardcodes "
                        "4K)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card ('cpu' to run "
                        "without one)")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
