"""Training CLI (JAX counterpart: the repo's train.py).

    python3 -m transformerupscaler_torch.train --model FastTransformer \
        --data_dir models/FastTransformer/demo --pairs small --epochs 1
    python3 -m transformerupscaler_torch.train ... --device cpu

The same flags and defaults as the JAX CLI (reference train.py:161-194),
including the stale ``StrippedTransformer`` default model name, which
raises KeyError with the list of models, and JAX's ``--pairs``,
``--dtype``, ``--no_device_cache`` and ``--fallback_dir``; ``--device``
picks the device (default: the card). ``--traceback`` writes a
``torch.profiler`` trace of the run into ``--trace_dir``
(``profiling.trace``). ``--mesh N --tp T`` trains on a mesh of N devices
(-1: all), T of them a model row (``parallel.mesh.cli_mesh``: the visible
cards, or under ``--device cpu`` the CPU repeated N times); on one card
``--mesh 2`` raises JAX's ValueError. Without ``--data_dir`` the online dataset
needs ``--fallback_dir`` (a directory of PNGs): the port has no network
fetch. Checkpoints are ``model_epoch_{n}.npz`` in ``--checkpoint_dir``
(default ``models/<model>/checkpoints/``), which the engine serves.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from transformerupscaler_torch.data.datasets import (
    HighresImageDataset,
    OnlineHighresDataset,
)
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.parallel.mesh import cli_mesh
from transformerupscaler_torch.profiling import trace
from transformerupscaler_torch.resolutions import SCALE_PAIRS
from transformerupscaler_torch.train_lib import Trainer

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def main(args) -> None:
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Training on device: {device} ({name})")

    if args.pairs == "small":
        pairs = [p for p in SCALE_PAIRS if p["lr"] == (96, 96)]
    elif args.pairs == "720":
        # ResidualTransformer's pos_embed is baked to 720p inputs: the
        # three 720p -> {1080p, 1440p, 4K} pairs only.
        pairs = [p for p in SCALE_PAIRS if p["lr"] == (720, 1280)]
    else:
        pairs = None
    if args.data_dir is None:
        dataset = OnlineHighresDataset(fallback_dir=args.fallback_dir)
        if pairs is not None:
            dataset.scale_pairs = pairs
            dataset.num_scale_pairs = len(pairs)
    else:
        dataset = HighresImageDataset(args.data_dir, scale_pairs=pairs,
                                      cache=True, uint8=True)

    mesh = None
    if args.mesh:
        mesh = cli_mesh(args.mesh, args.tp, device)
        print(f"Device mesh: {mesh.shape} (data-parallel replicas, gradients "
              f"summed on the first device; heads over 'model')")
    trainer = Trainer(args.model, checkpoint_dir=args.checkpoint_dir,
                      learning_rate=args.lr, dtype=DTYPES[args.dtype],
                      device=None if mesh else device, mesh=mesh)
    ctx = (trace(args.trace_dir) if args.traceback
           else contextlib.nullcontext())
    try:
        with ctx:
            trainer.fit(dataset, epochs=args.epochs,
                        batch_size=args.batch_size,
                        log_interval=args.log_interval,
                        checkpoint_interval=args.checkpoint_interval,
                        device_cache=(args.data_dir is not None
                                      and not args.no_device_cache))
    finally:
        if isinstance(dataset, OnlineHighresDataset):
            dataset.close()
    if args.traceback:
        print(f"Profiler trace written to "
              f"{os.path.join(args.trace_dir, 'trace.json')}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the TransformerModel for image upscaling on the "
                    "GPU")
    p.add_argument("--data_dir", type=str, default=None,
                   help="Path to the directory containing training images "
                        "(.png)")
    p.add_argument("--fallback_dir", type=str, default=None,
                   help="Feed the online dataset from this directory of "
                        "PNGs (the port has no network fetch)")
    p.add_argument("--batch_size", type=int, default=6,
                   help="Batch size for training")
    p.add_argument("--epochs", type=int, default=10,
                   help="Number of training epochs")
    p.add_argument("--lr", type=float, default=1e-4,
                   help="Learning rate for optimizer")
    p.add_argument("--log_interval", type=int, default=1,
                   help="Interval (in batches) to log training progress")
    p.add_argument("--checkpoint_interval", type=int, default=1,
                   help="Save model checkpoint every n epochs")
    p.add_argument("--model", type=str, default="StrippedTransformer",
                   help="Model name from the registry")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Directory to save model checkpoints (default: "
                        "models/{model}/checkpoints/)")
    p.add_argument("--pairs", choices=["all", "small", "720"],
                   default="all",
                   help="Restrict training to the small 96x96 pairs or the "
                        "720p-input pairs (ResidualTransformer)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                   help="Training compute dtype (params and loss stay f32)")
    p.add_argument("--mesh", type=int, default=0,
                   help="Train data-parallel over this many devices "
                        "(-1 = all; 0 = one device, no mesh)")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel size: the attention heads split "
                        "over this many devices of each mesh row")
    p.add_argument("--no_device_cache", action="store_true",
                   help="Keep training samples host-side")
    p.add_argument("--traceback", action="store_true",
                   help="Write a torch.profiler trace of the run")
    p.add_argument("--trace_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "tux_trace"),
                   help="Directory for the profiler trace")
    p.add_argument("--device", type=str, default=None,
                   help="Device to train on (default: the card; 'cpu')")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
