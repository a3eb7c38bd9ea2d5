"""Benchmark of the port: FastTransformer 720p -> 1080p 2x upscaling,
frames per second on one GPU. The counterpart of the repo's bench.py, with
no JAX:

    python3 -m transformerupscaler_torch.bench

    TUX_BENCH_CONFIG=int8_tails python3 -m transformerupscaler_torch.bench

The workload is bench.py's: one 720x1280 frame, uniform from a seeded
generator, to res_out 1080x1920 (x2 and the squash), bf16, batch 1, on
``get_model("FastTransformer", compose_tails=True, pallas_serve=True,
attn_impl="fused2")`` with the trained weights, served by
``UpscalerEngine`` on its CUDA graph. ``TUX_BENCH_CONFIG`` takes bench.py's
values (``CONFIGS``): ``bf16`` (the default), ``int8_tails``,
``int8_residual``, ``int8_full``, each optionally with ``_trunk`` (the
trunk's GEMMs in int8), and ``bf16_trunk``. The int8 configs take their
static scales as bench.py does: one dynamic forward on the bench frame,
times 1.1. ``quality`` (``serve_quality``) is not ported yet.

Timing: CUDA events around each replay of the frame's graph, ``FRAMES``
replays after ``WARMUP``; frames/sec = 1000 / median ms. Then one
closed-loop request median (a uint8 frame in, float32 numpy out, host
clock). stderr gets the card's name and power limit, the checkpoint epoch,
the config and the times; the last line of stdout is one JSON object with
bench.py's ``metric``, ``value`` and ``unit``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from transformerupscaler_torch.infer_lib import UpscalerEngine

METRIC = "FastTransformer 720p->1080p 2x upscaling throughput"
FRAME_HW, RES_OUT = (720, 1280), (1080, 1920)
WARMUP, FRAMES, REQUESTS = 5, 100, 20
INT8_CONFIGS = ("int8_tails", "int8_residual", "int8_full")
CONFIGS = ("bf16", "bf16_trunk") + INT8_CONFIGS + tuple(
    f"{c}_trunk" for c in INT8_CONFIGS)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def bench_flags(config: str) -> tuple[dict, bool]:
    """(the FastTransformer flags of ``config``, whether it takes static
    int8 scales), as bench.py builds its served model, but for
    ``int8_residual`` and ``int8_full``: bench.py serves them on JAX's
    all-XLA packed path (``pallas_serve=False``), which the port does not
    have; here they run with ``pallas_serve=True``."""
    if config == "quality":
        raise NotImplementedError(
            "TUX_BENCH_CONFIG=quality serves with serve_quality, which the "
            "port does not have yet")
    if config not in CONFIGS:
        raise ValueError(f"TUX_BENCH_CONFIG: one of {CONFIGS}, got "
                         f"{config!r}")
    int8_trunk = config.endswith("_trunk")
    base = config.removesuffix("_trunk")
    if base in INT8_CONFIGS:
        scope = base.split("_", 1)[1]
        return dict(compose_tails=True, int8_serve=True, int8_scope=scope,
                    pallas_serve=True, int8_trunk=int8_trunk,
                    attn_impl="fused2" if scope == "tails" or int8_trunk
                    else "xla"), True
    flags = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
    if int8_trunk:
        flags["int8_trunk"] = True
    return flags, False


def main() -> None:
    config = os.environ.get("TUX_BENCH_CONFIG", "bf16")
    flags, calibrate = bench_flags(config)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {smi} ({torch.cuda.get_device_name(0)})")
    t0 = time.perf_counter()
    engine = UpscalerEngine("FastTransformer", dtype=torch.bfloat16, **flags)
    weights = (f"epoch {engine.epoch} ({engine.checkpoint_path})"
               if engine.checkpoint_path else "seeded (no checkpoint)")
    log(f"config: {config} {flags}; weights: {weights}")
    if config.removesuffix("_trunk") in ("int8_residual", "int8_full"):
        log("differs from bench.py: served with pallas_serve=True (bench.py "
            "runs JAX's all-XLA packed path, which the port does not have)")
    x = np.random.default_rng(0).random((1, *FRAME_HW, 3), dtype=np.float32)
    if calibrate:
        engine.calibrate_int8(x, res_out=RES_OUT, margin=1.1, floor_frac=0.0)
    engine.upscale(x, res_out=RES_OUT, device_out=True)
    graph = engine.captured(x, res_out=RES_OUT)
    for _ in range(WARMUP):
        graph.replay()
    torch.cuda.synchronize()
    log(f"setup (load, calibration, build, capture): "
        f"{time.perf_counter() - t0:.3f} s")

    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(FRAMES)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    ms = [start.elapsed_time(end) for start, end in events]
    med = float(np.median(ms))

    frame = np.random.default_rng(1).integers(0, 256, (*FRAME_HW, 3),
                                              np.uint8)
    request_ms = []
    for i in range(WARMUP + REQUESTS):
        t1 = time.perf_counter()
        engine.upscale(frame, res_out=RES_OUT)
        if i >= WARMUP:
            request_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"forward ms over {FRAMES} graph replays: median {med}, min "
        f"{min(ms)}, max {max(ms)}; request ms (uint8 in, numpy out) over "
        f"{REQUESTS}: median {float(np.median(request_ms))}")
    print(json.dumps({"metric": METRIC, "value": round(1e3 / med, 2),
                      "unit": "frames/sec/chip"}), flush=True)


if __name__ == "__main__":
    main()
