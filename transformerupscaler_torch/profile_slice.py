"""Where one serving frame's time goes on the GPU.

    python3 -m transformerupscaler_torch.profile_slice

    python3 -m transformerupscaler_torch.profile_slice --route xla_fold

Runs one model (bf16 but on ``fast_exact``, full width, the trained weights
of its latest checkpoint, seeded where it has none) eagerly on 720x1280
frames, as ``chip_smoke.py`` serves them, and prints JSON lines: the
weights' epoch and the forward's time by CUDA events, then a
``torch.profiler`` trace of five forwards summed by kernel name (device milliseconds per frame), the device's busy time per
frame and its idle share of the forward. Routes: ``bench`` (the default:
FastTransformer as bench.py runs it, fused trunk, split tail), ``xla_fold``
(FastTransformer with the PyTorch trunk and the folded tail),
``bench_int8_trunk`` (``bench`` with the trunk's GEMMs in int8),
``window_pallas`` (WindowTransformer on the stream conv and the
window-attention kernel), ``window_fused2`` (WindowTransformer as ``--fast``
serves it: the stream conv and the fused trunk), ``resid_packed``
(ResidualTransformer's packed x2 route, res_out 1440x2560) and
``resid_exact`` (its exact route), both on the global attention kernel;
FastTransformer's int8 serving scopes on the ``bench`` route: ``int8_tails``
(bench.py's ``int8_tails``), ``int8_residual`` and ``int8_full``, each with
static scales from ``UpscalerEngine.calibrate_int8`` on three random
frames, and ``int8_tails_dyn`` (the tails scope with dynamic scales, as the
command lines' ``--int8`` serves it); ``bench_conv1`` (``bench`` with conv1
on its kernel, ``conv1_stream=True``) and ``bench_fuse`` (``bench`` with
``TUX_FUSE_STREAM=1``: conv2 and tail A, and the decoder conv and the folded
tail B, each as one kernel; the variable is set for the run);
``fast_exact`` (FastTransformer as JAX's default engine serves it: f32,
``attn_impl="xla"``, no serving flags, the exact path) and
``fast_exact_fused2`` (the exact path in bf16 on the fused trunk);
``quality`` (``bench`` with ``serve_quality=True`` on an f32 frame: both
tails emit f32, the B tail folded), ``quality_x4`` (the same at x4,
264x480 -> 1056x1920: the split tail in "wf" with f32 output),
``fast_x6`` (``bench`` at x6, 176x320 -> 1056x1920: the direct tails),
``xla_packed`` (JAX's all-XLA packed path, ``packed_serve=True,
attn_impl="xla"``: no kernel) and ``int8_full_xla`` (bench.py's
``int8_full``: that path with the "full" scope, calibrated); every other
route at res_out 1080x1920 from 720x1280.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from transformerupscaler_torch.infer_lib import UpscalerEngine

FRAMES, TOP = 5, 25
RES_OUT = (1080, 1920)
_RESID = dict(packed_serve=True, pallas_serve=True, attn_impl="fused2")
# route -> (model, flags, res_out); the int8 routes named in CALIBRATED
# are served with static scales
_BENCH = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
ROUTES = {
    "bench": ("FastTransformer", _BENCH, RES_OUT),
    "bench_int8_trunk": ("FastTransformer", dict(_BENCH, int8_trunk=True),
                         RES_OUT),
    "bench_conv1": ("FastTransformer", dict(_BENCH, conv1_stream=True),
                    RES_OUT),
    "bench_fuse": ("FastTransformer", _BENCH, RES_OUT),
    "xla_fold": ("FastTransformer", dict(compose_tails=True,
                                         pallas_serve=True, attn_impl="xla",
                                         split_tail=False), RES_OUT),
    "window_pallas": ("WindowTransformer", dict(pallas_serve=True,
                                                attn_impl="pallas"), RES_OUT),
    "window_fused2": ("WindowTransformer", dict(pallas_serve=True,
                                                attn_impl="fused2"), RES_OUT),
    "fast_exact": ("FastTransformer", {}, RES_OUT),
    "fast_exact_fused2": ("FastTransformer", dict(attn_impl="fused2"),
                          RES_OUT),
    "resid_packed": ("ResidualTransformer", _RESID, (1440, 2560)),
    "resid_exact": ("ResidualTransformer", _RESID, RES_OUT),
    **{f"int8_{scope}{suffix}": (
        "FastTransformer", dict(_BENCH, int8_serve=True, int8_scope=scope),
        RES_OUT) for scope, suffix in (("tails", ""), ("tails", "_dyn"),
                                       ("residual", ""), ("full", ""))},
}
_XLA = dict(compose_tails=True, packed_serve=True, attn_impl="xla")
ROUTES.update({
    "quality": ("FastTransformer", dict(_BENCH, serve_quality=True),
                RES_OUT),
    "quality_x4": ("FastTransformer", dict(_BENCH, serve_quality=True),
                   (1056, 1920)),
    "fast_x6": ("FastTransformer", _BENCH, (1056, 1920)),
    "xla_packed": ("FastTransformer", _XLA, RES_OUT),
    "int8_full_xla": ("FastTransformer", dict(
        compose_tails=True, int8_serve=True, int8_scope="full",
        pallas_serve=False, attn_impl="xla"), RES_OUT),
})
CALIBRATED = ("int8_tails", "int8_residual", "int8_full", "int8_full_xla")
# Environment switches a route sets; the routes served in f32; the input
# size of the routes not served from 720x1280.
ENV = {"bench_fuse": {"TUX_FUSE_STREAM": "1"}}
F32_ROUTES = ("fast_exact",)
IN_HW = {"quality_x4": (264, 480), "fast_x6": (176, 320)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", choices=sorted(ROUTES), default="bench")
    route = parser.parse_args().route
    os.environ.update(ENV.get(route, {}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    model, flags, res_out = ROUTES[route]
    dtype = torch.float32 if route in F32_ROUTES else torch.bfloat16
    engine = UpscalerEngine(model, dtype=dtype, **flags)
    if route in CALIBRATED:
        engine.calibrate_int8(np.random.default_rng(1).integers(
            0, 256, (3, 720, 1280, 3), np.uint8), res_out=res_out)
    g = torch.Generator(device=engine.device).manual_seed(0)
    x = torch.rand(1, *IN_HW.get(route, (720, 1280)), 3, generator=g,
                   device=engine.device)

    def forward():
        return engine.model(x, res_out=res_out)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FRAMES):
        forward()
    end.record()
    torch.cuda.synchronize()
    fwd_ms = start.elapsed_time(end) / FRAMES

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(FRAMES):
            forward()
        torch.cuda.synchronize()
    per_kernel, launches = {}, 0
    for ev in prof.key_averages():
        # Device-side events only (kernels, copies): an operator's device
        # time is its kernels' time again.
        t = ev.self_device_time_total
        if t > 0 and ev.device_type == DeviceType.CUDA:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + t
            launches += ev.count
    busy_ms = sum(per_kernel.values()) / 1e3 / FRAMES
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    print(json.dumps({"device": smi, "route": route, "model": model,
                      "weights": f"epoch {engine.epoch}",
                      "env": ENV.get(route, {}),
                      "in_hw": list(x.shape[1:3]), "res_out": res_out,
                      "forward_ms": fwd_ms,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / fwd_ms,
                      "kernel_names": len(per_kernel),
                      "launches_per_frame": launches / FRAMES}))
    for name, t in top:
        print(json.dumps({"kernel": name[:120],
                          "ms_per_frame": t / 1e3 / FRAMES}))


if __name__ == "__main__":
    main()
