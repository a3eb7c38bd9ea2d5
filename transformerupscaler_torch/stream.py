"""Headless streaming upscale (JAX counterpart: the root stream.py).

    python -m transformerupscaler_torch.stream --model FastTransformer \\
        --res_in 720 --res_out 1080 --fast [--frames 100] [--device cpu] \\
        [--trace_out frames.json]

Feeds frames (synthetic by default, or the images of a ``--source``
directory, cycled) through ``stream_lib.StreamPipeline`` at a fixed
geometry and prints the frame rate and the per-stage timing report. The
flags are those of the root stream.py, plus ``--device``: the card unless
``--device cpu``.

``--fast`` (and ``--quality``, a mode of it) on the card serve the stream
kernels with the fused trunk (``pallas_serve=True, attn_impl="fused2"``),
the counterpart of the JAX CLI's choice on a TPU (stream.py:47-59); with
``--device cpu`` they serve JAX's choice off a TPU, the all-XLA packed path
with ``attn_impl="xla"`` (``cli.serve_flags``). ``--source`` reads the
``.png`` images of a directory (``png.read_png``) and ``--save_last``
writes a ``.png`` (``png.write_png``); a ``.jpg`` in either raises, naming
the missing JPEG codec: the card's host has no PIL. ``--trace_out`` records
every frame's spans (``profiling.FrameTrace``) and writes them as a Chrome
trace: host spans on their threads, the card's copies and replay on a track
of their own, one clock.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from transformerupscaler_torch import profiling
from transformerupscaler_torch.cli import (
    on_card,
    read_image,
    require_png,
    serve_flags,
    write_image,
)
from transformerupscaler_torch.resolutions import resolutions
from transformerupscaler_torch.stream_lib import StreamPipeline


def frame_source(args, res_in):
    """The frames: the images of ``args.source`` cycled, or 8 seeded
    synthetic frames of ``res_in`` cycled (the JAX CLI's)."""
    if args.source:
        files = sorted(
            os.path.join(args.source, f) for f in os.listdir(args.source)
            if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not files:
            raise SystemExit(f"no .png or .jpg in {args.source}")
        for path in files:
            require_png(path, "decoder")

        def gen():
            for path in itertools.cycle(files):
                yield read_image(path)
        return gen()
    rng = np.random.default_rng(0)
    frames = [(rng.random((*res_in, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    return itertools.cycle(frames)


def pipeline_flags(args) -> dict:
    """The model flags of the CLI's pipeline (root stream.py:47-59, with the
    card in place of the TPU)."""
    return dict(quantize=args.quantize, int8_mlp=args.int8_mlp,
                **serve_flags(args.fast, args.quality, args.int8,
                              card=on_card(getattr(args, "device", None))))


def build_pipeline(args, **overrides) -> StreamPipeline:
    """The pipeline as the CLI builds it; ``overrides`` replace arguments
    (``bgr_out=True``, as the overlays build it)."""
    kwargs = dict(checkpoint_dir=args.checkpoint_dir,
                  device=getattr(args, "device", None),
                  **pipeline_flags(args))
    kwargs.update(overrides)
    return StreamPipeline(args.model, resolutions[args.res_in],
                          resolutions[args.res_out], **kwargs)


def main(args):
    res_in = resolutions[args.res_in]
    res_out = resolutions[args.res_out]
    if args.save_last:
        require_png(args.save_last, "encoder")
    pipe = build_pipeline(args)
    dev = pipe.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"Streaming on device: {dev} ({name}) | {res_in} -> {res_out}")
    print(f"checkpoint loaded: {pipe.from_checkpoint}")
    print(f"compiled in {pipe.warmup():.1f}s")
    if args.trace_out:
        pipe.trace = profiling.FrameTrace(max(args.frames, 1))

    last = {}

    def sink(frame):
        last["frame"] = frame

    stats = pipe.run(frame_source(args, res_in), sink=sink,
                     max_frames=args.frames)
    print(f"\n{stats['frames']} frames in {stats['wall_s']:.2f}s "
          f"-> {stats['fps']:.2f} fps")
    print("Profiling results:")
    print(stats["report"])

    if args.trace_out:
        pipe.trace.write_chrome_trace(args.trace_out)
        print(f"{len(pipe.trace.frames)} frames' spans written to "
              f"{args.trace_out}")

    if args.save_last and "frame" in last:
        write_image(args.save_last, last["frame"])
        print(f"last frame saved to {args.save_last}")
    return stats


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Streaming upscale pipeline")
    p.add_argument("--model", type=str, default="FastTransformer")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--res_in", type=str, default="720",
                   help="Input resolution key")
    p.add_argument("--res_out", type=str, default="1080",
                   help="Output resolution key")
    p.add_argument("--source", type=str, default=None,
                   help="Directory of frames (cycled); synthetic if unset")
    p.add_argument("--frames", type=int, default=50)
    p.add_argument("--save_last", type=str, default=None)
    p.add_argument("--quantize", action="store_true",
                   help="int8 weight quantization of linear layers")
    p.add_argument("--int8", choices=["off", "residual", "full", "tails"],
                   default="off", help="int8 serving scope")
    p.add_argument("--int8_mlp", action="store_true",
                   help="the transformer MLPs as int8 products")
    p.add_argument("--fast", action="store_true",
                   help="serving fast path: composed tails; on the card the "
                        "stream kernels and the fused trunk")
    p.add_argument("--quality", action="store_true",
                   help="serve_quality mode of the fast path (f32 image "
                        "boundaries)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card ('cpu' to run "
                        "without one)")
    p.add_argument("--trace_out", type=str, default=None,
                   help="write each frame's spans to this file as a Chrome "
                        "trace")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
