#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments. Phases, one line each:

1. the device: torch's name for it, and nvidia-smi's name and power limit
   and maximum SM clock;
2. the kernel build (nvcc, sm_90a) from transformerupscaler_torch/csrc/;
3. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes the served 720x1280 frames give it, with its time, the
   plain version's, one PyTorch library call's (where one computes the same
   function) and the card's bound for the same work; the fused encoder and
   decoder adapters against theirs;
4. each served route with a fixture at a small geometry against the
   committed JAX outputs (tests/fixtures/torch_port/*.npz), weights rebuilt
   from the numpy seed; FastTransformer's bf16 routes then at x3 and x4
   against the same model on the plain versions; JAX's default engine
   (``fast_exact``: f32, the exact path) on the whole frame at the f32
   bounds, TF32 off;
5. the trained weights (``weights``): for each of the three models the
   latest checkpoint found as the JAX engine finds it, read from its numpy
   copy (fingerprint and _METADATA checked), its epoch, parameter count and
   load time, and the default engine (f32, the exact path, TF32 off) on the
   model's demo input against the JAX default engine's output on the same
   weights (tests/fixtures/torch_port/trained_<Model>.npz) at the f32
   bounds;
6. the full slices: UpscalerEngine at full model width with the trained
   weights, serving 720x1280 frames on its CUDA graphs: FastTransformer on
   the route with the PyTorch
   trunk and the folded tail, then on the route bench.py runs (fused trunk,
   split tail), with its trunk's GEMMs in int8 (``int8_trunk``) and with the
   v1 trunk (``attn_impl="fused"``); FastTransformer as JAX's default
   engine serves it (``fast_exact``: f32, ``attn_impl="xla"``, no serving
   flags: the exact ``__call__``, no kernel) and the exact path in bf16 on
   the fused trunk (``fast_exact_fused2``); WindowTransformer with the stream conv
   and the window-attention kernel, then with the fused trunk (the
   ``--fast`` route) and the v1 trunk; ResidualTransformer on its packed x2
   route and on its exact route at 1080x1920, both on the global attention
   kernel; BicubicInterpolation; FastTransformer's int8 serving scopes
   (``int8_serve``): "tails" calibrated (bench.py's ``int8_tails``) and with
   dynamic scales (the command lines' ``--int8``), "residual" and "full"
   calibrated, each calibrated with ``UpscalerEngine.calibrate_int8`` on a
   few seeded frames; FastTransformer on the ``bench`` route with conv1 on
   its kernel (``conv1_stream=True``) and with ``TUX_FUSE_STREAM=1`` (conv2
   and tail A, and the decoder conv and the folded tail B, each as one
   kernel; the variable set for that route only). Each route is served
   twice, by the engine on its CUDA graphs and by the same engine with
   ``cuda_graphs=False``, each with the launch counts per frame (the
   trunk's also by kernel mode, the int8 options by option), set to zero
   just before; the two outputs must agree bit for bit, and the output is
   held against the eager engine on the plain versions;
7. ``quality``: FastTransformer's demo input (cropped to 176x320, which the
   serving gate takes) at x2 on every served FastTransformer route, the
   PSNR and the largest error against the trained exact f32 path on the
   same frame; the int8 routes' static scales calibrated on another frame
   (ResidualTransformer's demo input). It records, and fails only on a
   wrong shape or a value that is not finite;
8. the paths of the JAX package's archived kernels, which no model route
   reaches: ``archived``, the general 3x3 conv, the patch embed and the
   unembed + add of ``ops/pallas/conv3x3.py`` and ``patch_kernels.py``
   chained at the 720x1280 serving shapes with FastTransformer's seeded
   weights, as the JAX package's TPU probe (tools/serve_bench.py) runs them;
   ``trunk_static``, FastTransformer's full-width trunk in the static int8
   mode (``run_window_trunk(..., int8_acts=<scales>)``) on the tokens of a
   seeded frame, with scales from ``trunk_int8_scales`` on those tokens;
   each with its launch counts, set to zero just before, and held against
   the same calls on the plain versions;
9. ``bench``: ``python3 -m transformerupscaler_torch.bench`` (its ``bf16``
   config), its JSON result;
10. the status of every TPU kernel of the JAX package in the port.

The device line also says whether ``tensorstore`` and ``zstandard`` import
on this host (never a failure). Then one JSON line of kernel records and,
last, {"ok": true, "device": ...}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# exp2 and the other special functions: 16 a clock on each SM of compute
# capability 9.0 (CUDA C Programming Guide, arithmetic instruction
# throughput), at the card's maximum SM clock (``max_sm_clock_hz``).
SFU_PER_SM_CLOCK = 16
WARMUP, REPS = 3, 20
FRAME_HW, RES_OUT, SCALE = (720, 1280), (1080, 1920), 2
# Launch counters: one per wrapper, and the trunk's by kernel mode.
WRAPPERS = ("conv3x3_stream", "tail_conv_stream", "embed_stream",
            "unembed_combine_stream", "fused_window_trunk",
            "tail_finish_stream", "window_attention_core", "global_mha",
            "conv3x3_int8_stream", "tail_conv_int8_stream", "conv1_stream",
            "conv3x3_tail_stream", "conv3x3_tail_emit_stream")
ARCHIVED = ("conv3x3", "fused_patch_embed", "fused_patch_unembed_add")
INT8_OUT, INT8_IN, INT8_SKIP = ("conv3x3_stream.int8_out",
                                "embed_stream.int8_in",
                                "unembed_combine_stream.int8_skip")
TRUNK_MODES = ("v2", "v1", "int8_rowwise", "int8_static")
COUNTERS = WRAPPERS + ARCHIVED + tuple(
    f"fused_window_trunk.{m}" for m in TRUNK_MODES) + (
    INT8_OUT, INT8_IN, INT8_SKIP)


def counts(trunk_mode=None, **launched) -> dict:
    """Launches per frame of every counter: zero unless named; one trunk
    launch in ``trunk_mode`` if given."""
    if trunk_mode is not None:
        launched.update({"fused_window_trunk": 1,
                         f"fused_window_trunk.{trunk_mode}": 1})
    return {**dict.fromkeys(COUNTERS, 0), **launched}


def int8_counts(scope: str, static: bool) -> dict:
    """Launches per frame of FastTransformer's int8 scope at x2: the two
    tails always int8; the tails scope's convs with int8 out when the
    scales are static, its embed and unembed on the int8 map."""
    if scope == "tails":
        return counts("v2", conv3x3_stream=2, tail_conv_int8_stream=2,
                      embed_stream=1, unembed_combine_stream=1,
                      **{INT8_OUT: 2 if static else 0, INT8_IN: 1,
                         INT8_SKIP: 1})
    if scope == "residual":
        return counts("v2", conv3x3_stream=1, tail_conv_stream=1,
                      embed_stream=1, unembed_combine_stream=1,
                      conv3x3_int8_stream=1, tail_conv_int8_stream=1)
    return counts("v2", conv3x3_int8_stream=2, tail_conv_int8_stream=2,
                  embed_stream=1, unembed_combine_stream=1)


# The served routes: model, JAX flags, the committed JAX output (with the
# fields that shrink the model for it), res_out of the served frames,
# closed-loop requests to serve, and the kernel launches one frame must make.
ROUTE = dict(compose_tails=True, pallas_serve=True, split_tail=False,
             attn_impl="xla")
ROUTE_BENCH = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
ROUTE_WINDOW = dict(pallas_serve=True, attn_impl="fused2")
BENCH_LAUNCHES = dict(conv3x3_stream=2, tail_conv_stream=1, embed_stream=1,
                      unembed_combine_stream=1, tail_finish_stream=1)
ROUTE_RESID = dict(packed_serve=True, pallas_serve=True, attn_impl="fused2")
FIXTURES = "tests/fixtures/torch_port/"
# The default checkpoints: epoch and parameter count.
TRAINED = {"FastTransformer": (100, 6_447_379),
           "WindowTransformer": (40, 2_763_651),
           "ResidualTransformer": (17, 3_210_051)}
QUALITY_ROUTES = ("bench", "xla_fold", "bench_int8_trunk", "fast_fused",
                  "bench_conv1", "bench_fuse", "int8_tails", "int8_tails_dyn",
                  "int8_residual", "int8_full")
# The int8 routes' fixtures hold their static scales; bound of their
# interior error against JAX (tests/test_torch_int8_serve.py).
INT8_LIMIT = (1.5e-2, 2.5e-3)
F32_TOL = dict(atol=5e-5, rtol=1e-4)
INT8_TENSORS = ("feat1", "feat", "combined", "dec", "tokens")


def int8_route(scope: str) -> dict:
    return dict(ROUTE_BENCH, int8_serve=True, int8_scope=scope)
ROUTES = {
    "xla_fold": dict(
        model="FastTransformer", route=ROUTE,
        fixture=FIXTURES + "slice_x2_bf16.npz", res_out=RES_OUT, requests=3,
        launches=counts(conv3x3_stream=2, tail_conv_stream=2, embed_stream=1,
                        unembed_combine_stream=1)),
    "bench": dict(
        model="FastTransformer", route=ROUTE_BENCH,
        fixture=FIXTURES + "bench_x2_bf16.npz", res_out=RES_OUT, requests=20,
        launches=counts("v2", **BENCH_LAUNCHES)),
    "bench_conv1": dict(
        model="FastTransformer", route=dict(ROUTE_BENCH, conv1_stream=True),
        fixture=FIXTURES + "bench_x2_bf16.npz", res_out=RES_OUT, requests=10,
        launches=counts("v2", conv1_stream=1, **BENCH_LAUNCHES)),
    "bench_fuse": dict(
        model="FastTransformer", route=ROUTE_BENCH,
        env={"TUX_FUSE_STREAM": "1"},
        fixture=FIXTURES + "fuse_stream_x2_bf16.npz", res_out=RES_OUT,
        requests=10,
        launches=counts("v2", conv3x3_tail_emit_stream=1,
                        conv3x3_tail_stream=1, embed_stream=1,
                        unembed_combine_stream=1)),
    "bench_int8_trunk": dict(
        model="FastTransformer", route=dict(ROUTE_BENCH, int8_trunk=True),
        fixture=FIXTURES + "bench_int8_trunk_x2_bf16.npz", res_out=RES_OUT,
        requests=20, launches=counts("int8_rowwise", **BENCH_LAUNCHES)),
    "fast_fused": dict(
        model="FastTransformer", route=dict(ROUTE_BENCH, attn_impl="fused"),
        res_out=RES_OUT, requests=5, launches=counts("v1", **BENCH_LAUNCHES)),
    # JAX's default engine: f32, attn_impl="xla", no serving flags, the
    # exact __call__ in plain PyTorch; its fixture is held on the whole
    # frame at the f32 bounds of tests/test_parity.py, TF32 off.
    "fast_exact": dict(
        model="FastTransformer", route={}, dtype=torch.float32,
        fixture=FIXTURES + "fast_exact_f32.npz", fixture_tol=F32_TOL,
        res_out=RES_OUT, requests=3, launches=counts()),
    # The exact path with the fused trunk in bf16: one trunk launch a frame.
    "fast_exact_fused2": dict(
        model="FastTransformer", route=dict(attn_impl="fused2"),
        res_out=RES_OUT, requests=3, launches=counts("v2")),
    "window_pallas": dict(
        model="WindowTransformer",
        route=dict(pallas_serve=True, attn_impl="pallas"),
        fixture=FIXTURES + "window_pallas_bf16.npz", res_out=RES_OUT,
        requests=20,
        launches=counts(conv3x3_stream=1, window_attention_core=8)),
    "window_fused2": dict(
        model="WindowTransformer", route=ROUTE_WINDOW,
        fixture=FIXTURES + "window_fused2_bf16.npz", res_out=RES_OUT,
        requests=20, launches=counts("v2", conv3x3_stream=1)),
    "window_fused": dict(
        model="WindowTransformer", route=dict(ROUTE_WINDOW, attn_impl="fused"),
        res_out=RES_OUT, requests=5, launches=counts("v1", conv3x3_stream=1)),
    "resid_packed": dict(
        model="ResidualTransformer", route=ROUTE_RESID,
        fixture=FIXTURES + "resid_packed_x2_bf16.npz",
        fixture_config=dict(token_hw=(4, 6)), res_out=(1440, 2560),
        requests=20, launches=counts(conv3x3_stream=2, global_mha=8)),
    "resid_exact": dict(
        model="ResidualTransformer", route=ROUTE_RESID, res_out=RES_OUT,
        requests=5, launches=counts(global_mha=8)),
    "bicubic": dict(
        model="BicubicInterpolation", route={}, res_out=RES_OUT, requests=5,
        launches=counts()),
    "int8_tails": dict(
        model="FastTransformer", route=int8_route("tails"), calibrate=True,
        fixture=FIXTURES + "int8_tails_x2_bf16.npz", res_out=RES_OUT,
        requests=10, launches=int8_counts("tails", True)),
    "int8_tails_dyn": dict(
        model="FastTransformer", route=int8_route("tails"), res_out=RES_OUT,
        requests=10, launches=int8_counts("tails", False)),
    "int8_residual": dict(
        model="FastTransformer", route=int8_route("residual"),
        calibrate=True, res_out=RES_OUT, requests=10,
        launches=int8_counts("residual", True)),
    "int8_full": dict(
        model="FastTransformer", route=int8_route("full"), calibrate=True,
        fixture=FIXTURES + "int8_full_x2_bf16.npz", res_out=RES_OUT,
        requests=10, launches=int8_counts("full", True)),
}

# Every function of transformerupscaler_tpu/ops/pallas that reaches
# pl.pallas_call, and where the port stands on it.
TPU_KERNELS = [
    ("stream.py:425 conv3x3_deint_stream",
     "ported and checked: conv3x3_stream (csrc/conv3x3.cu; bf16, and its "
     "int8 out_scale)"),
    ("stream.py:777 tail_macro8_stream",
     "ported and checked: tail_conv_stream"),
    ("stream.py:325 embed_stream",
     "ported and checked: embed_stream (bf16, and its int8 in_scale)"),
    ("stream.py:239 unembed_combine_stream",
     "ported and checked: unembed_combine_stream (bf16, and its int8 "
     "feat_scale)"),
    ("trunk2.py:524 fused_window_trunk_v2",
     "ported and checked: fused_window_trunk (one kernel for the five TPU "
     "bodies, C=192 and 128, every mode on TMA + wgmma; bf16, and "
     "int8_acts='rowwise' and the static int8_gemms mode 'int8_static' on "
     "int8 wgmma at C=192)"),
    ("stream.py:1078 tail_finish_stream",
     "ported and checked: tail_finish_stream (hi_lo_fin off, wf, full)"),
    ("stream.py:82 conv3x3_packed_stream",
     "ported and checked: conv3x3_stream (the same conv without the "
     "width-2 packing; bf16)"),
    ("stream.py:147 conv3x3_packed_int8_stream",
     "ported and checked: conv3x3_int8_stream (int8 x int8 -> int32; the "
     "int8 form of csrc/conv3x3.cu's kernel)"),
    ("stream.py:893 tail_macro8_stream_int8",
     "ported and checked: tail_conv_int8_stream (5x5 and 7x7; also serves "
     "the XLA conv2d_tail_packed_int8; the int8 form of "
     "csrc/tail_strip.cu's tail)"),
    ("stream.py:584 conv3x3_tail_stream",
     "ported and checked: conv3x3_tail_stream (3x3, 5x5, 7x7 tails; bf16 "
     "and f32 out)"),
    ("stream.py:662 conv3x3_tail_emit_stream",
     "ported and checked: conv3x3_tail_emit_stream (the same kernel, "
     "emitting the conv output)"),
    ("stream.py:1269 conv1_dots_stream",
     "ported and checked: conv1_stream (persistent blocks: a TMA or "
     "cp.async halo ring, fragments gathered from the halo, TMA store)"),
    ("stream.py:1385 conv1_flat_stream",
     "ported and checked: conv1_stream (row 12's kernel: the same "
     "function, the operand built in the kernel as this one asked)"),
    ("gmha.py:60 global_mha", "ported and checked: global_mha (bf16)"),
    ("trunk.py:128 fused_window_trunk",
     "ported and checked: fused_window_trunk mode 'v1' (the same kernel, "
     "its residual association, C=128 and 192)"),
    ("window_attn.py:58 fused_window_attention",
     "ported and checked: window_attention_core (bf16; TMA in, bias loads "
     "at block start, ldmatrix, TMA store)"),
    ("encoder.py:239 fused_encoder",
     "ported and checked: kernels.encoder.fused_encoder over "
     "conv3x3_tail_emit_stream (biases rounded to the compute dtype)"),
    ("encoder.py:279 fused_decoder",
     "ported and checked: kernels.encoder.fused_decoder over "
     "conv3x3_tail_stream (biases rounded to the compute dtype)"),
    ("conv3x3.py:73 conv3x3_pallas",
     "ported and checked: kernels.conv3x3.conv3x3 (csrc/conv3x3.cu, any C "
     "and O, bias rounded to the compute dtype)"),
    ("patch_kernels.py:50 fused_patch_embed",
     "ported and checked: kernels.patch_kernels.fused_patch_embed on "
     "embed_stream's kernel (bias rounded to the compute dtype)"),
    ("patch_kernels.py:106 fused_patch_unembed_add",
     "ported and checked: kernels.patch_kernels.fused_patch_unembed_add on "
     "unembed_combine_stream's kernel, epilogue option round_steps (three "
     "roundings)"),
]


@contextlib.contextmanager
def route_env(values: dict):
    """The environment switches a route sets (``env`` of its spec), the old
    values restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call by CUDA events over ``reps`` calls, after
    a warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def port_kernels() -> re.Pattern:
    """Matches the name of any of the port's CUDA kernels: every
    ``__global__`` function of transformerupscaler_torch/csrc/."""
    from transformerupscaler_torch.kernels import _build

    names = set()
    for src in _build.CSRC.glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return re.compile(r"\b(?:%s)\b" % "|".join(sorted(names)))


def device_ms(fn, port_only: bool = True, reps: int = REPS) -> float:
    """Device milliseconds per call of ``fn``: the CUDA time torch.profiler
    traces for the kernels it launches over ``reps`` calls, after a
    warm-up. ``port_only``: only the port's own kernels, not the copies or
    casts a wrapper launches around them. A trace whose launch count is not
    a whole multiple of ``reps`` lost events (CUPTI sometimes delivers
    none): it is taken again, at most three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, traced = 0.0, 0
        for ev in prof.key_averages():
            if (ev.device_type != DeviceType.CUDA
                    or ev.self_device_time_total <= 0):
                continue
            if port_only and not port_kernels().search(ev.key):
                continue
            us += ev.self_device_time_total
            traced += ev.count
        if traced and traced % reps == 0:
            return us / 1e3 / reps
    raise AssertionError(f"torch.profiler traced {traced} launches over "
                         f"{reps} calls, three times")


def timing(run, plain, lib=None) -> dict:
    """The times of a kernel record, all taken in this run: ``ms``, the
    device time of the port's kernels that one call of the wrapper launches;
    ``wrapper_ms``, the wrapper called back to back, by CUDA events (host
    time included where it sets the pace); ``plain_ms``, the plain version
    likewise; ``library_ms``, the device time of one PyTorch call that
    computes the same function (None where there is none)."""
    return dict(ms=device_ms(run), wrapper_ms=cuda_ms(run),
                plain_ms=cuda_ms(plain, 3),
                library_ms=None if lib is None else device_ms(lib, False))


@functools.cache
def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def bound_ms(n_bytes: float, flops: float, int8_ops: float = 0.0,
             exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work, the largest of: bytes at the memory
    rate; the operations (bf16, plus any int8 ones at the int8 rate); the
    exponentials (special-function operations) at SFU_PER_SM_CLOCK on every
    SM at the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {"bytes": n_bytes / PEAK_BYTES,
             "operations": flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS,
             "exponentials": exps / (sms * SFU_PER_SM_CLOCK
                                     * max_sm_clock_hz())}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def close_enough(got, want, rtol, atol) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|
    everywhere."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    excess = (err - rtol * w.abs()).max().item()
    if not excess <= atol or not torch.isfinite(g).all():
        raise AssertionError(f"kernel disagrees with its plain version: max "
                             f"err {err.max().item():.3e}, excess {excess:.3e}"
                             f" over atol {atol} + rtol {rtol} |want|")
    return err.max().item()


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this run "
                 "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", torch_name=kind, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count(),
        max_sm_clock_mhz=max_sm_clock_hz() / 1e6,
        imports={m: imports(m) for m in ("tensorstore", "zstandard")})
    return kind


def imports(module: str) -> bool:
    """Whether ``module`` imports on this host (for the trained weights'
    reader: the committed Orbax stores are zstd-compressed)."""
    import importlib

    try:
        importlib.import_module(module)
    except Exception:  # noqa: BLE001 - any failure to import means "no"
        return False
    return True


def phase_build() -> None:
    from transformerupscaler_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    regs, spill_bytes = [], 0
    for f in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        for ln in f.read_text().splitlines():
            if "Used" in ln and "registers" in ln:
                regs.append(ln.split(":", 1)[1].strip())
            elif "bytes spill stores" in ln:
                spill_bytes += int(ln.split("stack frame,")[1].split()[0])
    say("build", seconds=round(time.perf_counter() - t0, 3),
        built={k: round(v, 3) for k, v in built.items()}, ptxas=regs,
        ptxas_spill_store_bytes=spill_bytes)


PATCH_MATMUL = "torch.matmul on the materialized patch view"


def unembed_yardsticks(run, plain, skip, tok2, w2) -> dict:
    """The unembed's times. Its library call is torch.addmm of the skip,
    materialized in patch order, with the tokens' product: the bytes the
    kernel moves, without the bias and the scatter back to NHWC;
    ``matmul_ms`` is the bare product, without the skip."""
    b, h, w, c = skip.shape
    skip_pm = (skip.reshape(b, h // 8, 8, w // 8, 8, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(-1, 64 * c).contiguous())
    return dict(timing(run, plain, lambda: torch.addmm(skip_pm, tok2, w2)),
                library_call="torch.addmm(skip in patch order, tokens, W)",
                matmul_ms=device_ms(lambda: torch.matmul(tok2, w2), False))


def phase_kernels() -> list[dict]:
    """Each kernel against its plain version at the main-path shapes."""
    import torch.nn.functional as F

    from transformerupscaler_torch.kernels import stream as S

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    h, w = FRAME_HW
    ht, wt, d = h // 8, w // 8, 192

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = rn(1, h, w, 64).bfloat16()
    x_cl = x.permute(0, 3, 1, 2)  # channels-last NCHW view for F.conv2d
    tok = rn(1, ht, wt, d).bfloat16()
    bf16 = dict(rtol=2.0 ** -7, atol=1e-3)  # one bf16 rounding step
    records = []

    def conv_case(name, k, co, relu, replaces, on="bench", x=x):
        h, w = x.shape[1:3]
        x_cl = x.permute(0, 3, 1, 2)  # channels-last NCHW view for F.conv2d
        kern = rn(k, k, 64, co, std=(k * k * 64) ** -0.5)
        bias = rn(co, std=0.1)
        if k == 3:
            run = lambda: S.conv3x3_stream(x, kern, bias, relu)  # noqa: E731
            plain = lambda: S.conv3x3_plain(x, kern, bias, relu)  # noqa: E731
        else:
            run = lambda: S.tail_conv_stream(x, kern, bias, relu)  # noqa: E731
            plain = lambda: S.tail_conv_plain(x, kern, bias, relu)  # noqa: E731
        w_oihw = kern.bfloat16().permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b16 = bias.bfloat16()
        lib = lambda: F.conv2d(x_cl, w_oihw, b16, padding=k // 2)  # noqa: E731
        out = run()
        err = close_enough(out, plain(), **bf16)
        if k != 3:  # the x3 and x4 widths and the f32 output, quarter frame
            xq = x[:, :h // 2, :w // 2].contiguous()
            for cw in (27, 48):
                kw, bw = rn(k, k, 64, cw, std=(k * k * 64) ** -0.5), rn(cw)
                for odt in (torch.bfloat16, torch.float32):
                    err = max(err, close_enough(
                        S.tail_conv_stream(xq, kw, bw, relu, odt),
                        S.tail_conv_plain(xq, kw, bw, relu, odt), **bf16))
        flops = 2.0 * h * w * k * k * 64 * co
        bnd, by = bound_ms(nbytes(x, out) + k * k * 64 * co * 2 + co * 4,
                           flops)
        src = "conv3x3" if k == 3 else "tail_strip"
        records.append(dict(
            name=name, route="cuda",
            source=f"transformerupscaler_torch/csrc/{src}.cu",
            replaces=replaces, max_abs_err=err, bound_ms=bnd, bound_by=by,
            **timing(run, plain, lib), on=on))

    conv_case("conv3x3_stream", 3, 64, True,
              "transformerupscaler_tpu/ops/pallas/stream.py:425")
    # ResidualTransformer's decoder conv, behind the stride-2 downsample.
    conv_case("conv3x3_stream/360x640", 3, 64, True,
              "transformerupscaler_tpu/ops/pallas/stream.py:82",
              on="resid_packed", x=rn(1, h // 2, w // 2, 64).bfloat16())
    conv_case("tail_conv_stream/5x5", 5, 12, True,
              "transformerupscaler_tpu/ops/pallas/stream.py:777")
    conv_case("tail_conv_stream/7x7", 7, 12, False,
              "transformerupscaler_tpu/ops/pallas/stream.py:777",
              on="xla_fold")

    # The weights bf16, as the model holds them: the wrappers then copy
    # nothing.
    ke = rn(8, 8, 64, d, std=4096 ** -0.5).bfloat16()
    be = rn(d, std=0.1)
    run = lambda: S.embed_stream(x, ke, be)  # noqa: E731
    plain = lambda: S.embed_plain(x, ke, be)  # noqa: E731
    out = run()
    err = close_enough(out, plain(), **bf16)
    patches = (x.reshape(1, ht, 8, wt, 8, 64).permute(0, 1, 3, 2, 4, 5)
               .reshape(-1, 8 * 8 * 64).contiguous())
    ke16 = ke.reshape(-1, d)
    bnd, by = bound_ms(nbytes(x, out, ke16) + d * 4, 2.0 * ht * wt * 4096 * d)
    records.append(dict(
        name="embed_stream", route="cuda",
        source="transformerupscaler_torch/csrc/patch_gemm.cu",
        replaces="transformerupscaler_tpu/ops/pallas/stream.py:325",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        **timing(run, plain, lambda: torch.matmul(patches, ke16)),
        library_call=PATCH_MATMUL, on="bench"))

    ku, bu = rn(d, 8, 8, 64, std=d ** -0.5).bfloat16(), rn(64, std=0.1)
    run = lambda: S.unembed_combine_stream(tok, x, ku, bu)  # noqa: E731
    plain = lambda: S.unembed_combine_plain(tok, x, ku, bu)  # noqa: E731
    out = run()
    err = close_enough(out, plain(), **bf16)
    err = max(err, close_enough(S.unembed_combine_stream(tok, x, ku, bu, True),
                                S.unembed_combine_plain(tok, x, ku, bu, True),
                                **bf16))
    tok2, ku16 = tok.reshape(-1, d), ku.reshape(d, -1)
    bnd, by = bound_ms(nbytes(tok, x, out, ku16) + 64 * 4,
                       2.0 * ht * wt * d * 4096)
    records.append(dict(
        name="unembed_combine_stream", route="cuda",
        source="transformerupscaler_torch/csrc/patch_gemm.cu",
        replaces="transformerupscaler_tpu/ops/pallas/stream.py:239",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        **unembed_yardsticks(run, plain, x, tok2, ku16), on="bench"))
    records.append(tail_finish_case(x, x_cl, rn, bf16))
    records.extend(trunk_case(rn, *case) for case in TRUNK_CASES)
    records.append(window_attention_case(rn, bf16))
    records.append(global_mha_case(rn, bf16))
    records.extend(int8_cases(x, tok, rn, bf16))
    records.extend(conv1_and_fused_cases(x, x_cl, rn, bf16))
    records.extend(archived_cases(x, x_cl, tok, rn, bf16))
    torch.cuda.synchronize()
    for r in records:
        say("kernel", **r)
    return records


def tail_finish_case(x, x_cl, rn, bf16) -> dict:
    """The split tail at the x2 serving shape (5x5 64 -> 12, 3x3 12 -> 12,
    "off"), then its other modes and the f32 output on a quarter frame, and
    the x3 and x4 widths."""
    import torch.nn.functional as F

    from transformerupscaler_torch.kernels import stream as S

    _, h, w, _ = x.shape
    km, bm = rn(5, 5, 64, 12, std=1600 ** -0.5), rn(12, std=0.1)
    kf, bf = rn(3, 3, 12, 12, std=108 ** -0.5), rn(12, std=0.1)

    def tol(xs, k_mid, b_mid, k_fin):
        # A mid element that sums in another order can land one bf16 step
        # (at most 2^-7 of its value) away, and a finish weight carries that
        # into the output: one such flip on top of the usual bound.
        mid = S.tail_conv_plain(xs, k_mid, b_mid, out_dtype=torch.float32)
        flip = 2.0 ** -7 * mid.abs().max().item() * k_fin.abs().max().item()
        return dict(rtol=bf16["rtol"], atol=bf16["atol"] + flip)

    out = S.tail_finish_stream(x, km, bm, kf, bf)
    t = tol(x, km, bm, kf)
    err = close_enough(out, S.tail_finish_plain(x, km, bm, kf, bf), **t)
    xq = x[:, :h // 2, :w // 2].contiguous()
    tq = tol(xq, km, bm, kf)
    for mode in S.HI_LO_FIN:
        for odt in (torch.bfloat16, torch.float32):
            err = max(err, close_enough(
                S.tail_finish_stream(xq, km, bm, kf, bf, odt, mode),
                S.tail_finish_plain(xq, km, bm, kf, bf, odt, mode), **tq))
    for cm, co in ((27, 27), (12, 48)):
        k2, b2 = rn(5, 5, 64, cm, std=1600 ** -0.5), rn(cm, std=0.1)
        k3, b3 = rn(3, 3, cm, co, std=(9 * cm) ** -0.5), rn(co, std=0.1)
        err = max(err, close_enough(
            S.tail_finish_stream(xq, k2, b2, k3, b3),
            S.tail_finish_plain(xq, k2, b2, k3, b3), **tol(xq, k2, b2, k3)))
    wm = km.bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    wf = kf.bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bm16, bf16_ = bm.bfloat16(), bf.bfloat16()
    lib = lambda: F.conv2d(F.conv2d(x_cl, wm, bm16, padding=2), wf,  # noqa: E731
                           bf16_, padding=1)
    flops = 2.0 * h * w * (25 * 64 * 12 + 9 * 12 * 12)
    bnd, by = bound_ms(nbytes(x, out) + (25 * 64 * 12 + 9 * 12 * 12) * 2
                       + 24 * 4, flops)
    return dict(
        name="tail_finish_stream", route="cuda",
        source="transformerupscaler_torch/csrc/tail_strip.cu",
        replaces="transformerupscaler_tpu/ops/pallas/stream.py:1078",
        max_abs_err=err, tolerance=t, bound_ms=bnd, bound_by=by,
        **timing(lambda: S.tail_finish_stream(x, km, bm, kf, bf),
                 lambda: S.tail_finish_plain(x, km, bm, kf, bf), lib),
        on="bench")


def window_attention_case(rn, bf16) -> dict:
    """WindowTransformer's attention core on one 720x1280 frame: 45 x 80
    tokens padded to 48 x 80 are 60 windows of 64 tokens, 8 heads of 16.

    Tolerance: the kernel's fast exponential can round a probability to the
    next bf16 value than the plain version's; a share of about 2^-20 / 2^-8
    of them does, each moving the f32 context by at most 2^-8 p |v|, far
    below atol; the context then rounds once: one bf16 step.

    ``empty_kernel_ms``: the device time of an empty kernel on the core's
    grid, taken the same way: the floor under ``ms`` that a launch of 240
    blocks costs, against a bound far below it."""
    import torch.nn.functional as F

    from transformerupscaler_torch.kernels import window_attn as A

    nw, n, heads, c = 60, 64, 8, 128
    qkv = rn(nw, n, 3 * c).bfloat16()
    bias = rn(heads, n, n, std=0.5)
    run = lambda: A.window_attention_core(qkv, bias, heads)  # noqa: E731
    plain = lambda: A.window_attention_plain(qkv, bias, heads)  # noqa: E731
    out = run()
    err = close_enough(out, plain(), **bf16)
    q, k, v = (t.reshape(nw, n, heads, 16).transpose(1, 2).contiguous()
               for t in qkv.split(c, dim=-1))
    mask = bias.bfloat16()[None]
    lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
    bnd, by = bound_ms(nbytes(qkv, bias, out), 2.0 * 2 * nw * heads * n * n * 16)
    return dict(
        name="window_attention_core", route="cuda",
        source="transformerupscaler_torch/csrc/window_attn.cu",
        replaces="transformerupscaler_tpu/ops/pallas/window_attn.py:58",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        **timing(run, plain, lib),
        empty_kernel_ms=device_ms(
            lambda: A.window_attention_empty(nw, heads, qkv.device)),
        on="window_pallas")


def global_mha_case(rn, bf16) -> dict:
    """ResidualTransformer's attention core on one 720x1280 frame: 3600
    tokens (28 key tiles of 128 and one of 16), 8 heads of 16, q, k, v as
    the slices of the packed qkv the model hands over; then two batches of
    1000 tokens. Tolerance: the kernel keeps the TPU body's rounding point
    (two passes over the keys), but its probabilities come from a fast
    exponential and a running sum, so a probability can round to the
    neighbouring bf16 value (one step, at most 2^-7 p), which moves the f32
    context by up to 2^-7 p |v|: at p near 1 and |v| ~ 6, several output
    steps. So one bf16 step of the plain version is required of all but a
    share of 1e-4 of the elements (measured on an H100 at these draws: none
    at (1, 3600), 3 of 256000 at (2, 1000)), and every element is held to
    attention carried in f64 from the same bf16 q, k, v: the kernel's max
    and mean error against it at most 1.25 times the plain version's
    (``held``). Bound: one exponential a score at the SFU's rate.
    """
    import torch.nn.functional as F

    from transformerupscaler_torch.kernels import gmha as G
    from transformerupscaler_torch.ops.attention import multihead_attention

    n, heads, c = 3600, 8, 128

    def sliced(b, n):
        qkv = rn(b, n, 3 * c, std=1.5).bfloat16()
        return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]

    def exact(q, k, v):
        b, m, _ = q.shape
        qh, kh, vh = (t.reshape(b, m, heads, 16).transpose(1, 2).double()
                      for t in (q, k, v))
        p = torch.softmax((qh * 0.25) @ kh.transpose(-1, -2), -1)
        return (p @ vh).transpose(1, 2).reshape(b, m, c)

    def held(got, q, k, v):
        """max |got - plain|, after the checks of the docstring."""
        want = G.global_mha_plain(q, k, v, heads)
        g, w = got.float(), want.float()
        err = (g - w).abs()
        share = (err > bf16["atol"] + bf16["rtol"] * w.abs()).float().mean()
        ref = exact(q, k, v)
        e_kernel, e_plain = (g.double() - ref).abs(), (w.double() - ref).abs()
        check = dict(beyond_one_step_share=share.item(),
                     kernel_vs_f64_max=e_kernel.max().item(),
                     plain_vs_f64_max=e_plain.max().item(),
                     kernel_vs_f64_mean=e_kernel.mean().item(),
                     plain_vs_f64_mean=e_plain.mean().item())
        say("gmha_check", shape=list(q.shape), **check)
        if not (torch.isfinite(g).all() and check["beyond_one_step_share"]
                <= 1e-4 and check["kernel_vs_f64_max"]
                <= 1.25 * check["plain_vs_f64_max"]
                and check["kernel_vs_f64_mean"]
                <= 1.25 * check["plain_vs_f64_mean"]):
            raise AssertionError(f"global_mha disagrees with its plain "
                                 f"version: {check}")
        return err.max().item()

    q, k, v = sliced(1, n)
    run = lambda: G.global_mha(q, k, v, heads)  # noqa: E731
    plain = lambda: G.global_mha_plain(q, k, v, heads)  # noqa: E731
    out = run()
    err = held(out, q, k, v)
    q2, k2, v2 = sliced(2, 1000)
    err = max(err, held(G.global_mha(q2, k2, v2, heads), q2, k2, v2))
    qh, kh, vh = (t.reshape(1, n, heads, 16).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
    # One exponential a score: 103.7 M at (1, 3600) with 8 heads.
    bnd, by = bound_ms(nbytes(q, k, v, out), 2.0 * 2 * n * n * c,
                       exps=float(heads) * n * n)
    # One whole attention layer (qkv product, core, output product) through
    # the kernel and through the eager branch, which writes the
    # (8, 3600, 3600) f32 scores: the other value of ``attn_impl``.
    x = rn(1, n, c).bfloat16()
    wts = (rn(c, 3 * c, std=c ** -0.5), rn(3 * c, std=0.1),
           rn(c, c, std=c ** -0.5), rn(c, std=0.1))
    say("gmha_layer",
        kernel_branch_ms=cuda_ms(
            lambda: multihead_attention(x, *wts, heads, "fused2")),
        eager_branch_ms=cuda_ms(
            lambda: multihead_attention(x, *wts, heads, "xla"), 5),
        note="multihead_attention at (1, 3600, 128): impl 'fused2' against "
             "impl 'xla', the eager form; not a yardstick")
    return dict(
        name="global_mha", route="cuda",
        source="transformerupscaler_torch/csrc/global_mha.cu",
        replaces="transformerupscaler_tpu/ops/pallas/gmha.py:60",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        **timing(run, plain, lib),
        on="resid_packed")


def int8_cases(x, tok, rn, bf16) -> list[dict]:
    """The int8 scopes' kernels and kernel options at the x2 serving shapes:
    the 720x1280 feature map quantized per channel (59 MB of int8), weights
    folded and quantized as the model folds them. The two int8 convs must
    equal their plain versions bit for bit (exact int32 sums, the same f32
    epilogue), at 720p and, bf16 and f32 out, on a quarter frame, the tails
    also at co 27 and 48 (x3, x4); each record carries the device time of
    its bf16 counterpart (``conv3x3_stream`` / ``tail_conv_stream`` on the
    dequantized map) as ``bf16_counterpart_ms``. The conv's int8 output
    may differ by one step on under 0.1% of elements (an f32 sum in another
    order near a half step); the int8 embed and unembed within one bf16
    step. No single PyTorch call computes
    an int8 convolution, or a product with an int8 quantize or dequantize
    around it, on CUDA: library_ms is null."""
    from transformerupscaler_torch.kernels import stream as S
    from transformerupscaler_torch.ops import quant as Q

    _, h, w, _ = x.shape
    _, ht, wt, d = tok.shape
    s = Q.act_scale(x)
    xq, _ = Q.quantize_act_ch(x, s)
    xd = (xq.float() * s).bfloat16()  # the map the bf16 counterparts take
    records = []

    def record(name, source, replaces, err, tol, run, plain, n_bytes, on,
               flops=0.0, int8_ops=0.0, **extra):
        bnd, by = bound_ms(n_bytes, flops, int8_ops)
        records.append(dict(
            name=name, route="cuda", source=source,
            replaces="transformerupscaler_tpu/ops/pallas/" + replaces,
            max_abs_err=err, tolerance=tol, bound_ms=bnd, bound_by=by,
            **timing(run, plain), on=on, **extra))

    def exact(name, wrap, plain_fn, *args):
        if not torch.equal(wrap(*args), plain_fn(*args)):
            raise AssertionError(f"{name} differs from its plain version")

    for name, k, co, relu, replaces, on in (
            ("conv3x3_int8_stream", 3, 64, True, "stream.py:147",
             "int8_full"),
            ("tail_conv_int8_stream/5x5", 5, 12, True, "stream.py:893",
             "int8_tails"),
            ("tail_conv_int8_stream/7x7", 7, 12, False, "stream.py:893",
             "int8_tails")):
        kf = rn(k, k, 64, co, std=(k * k * 64) ** -0.5)
        kq, ks = Q.fold_conv_kernel(kf, s)
        bias = rn(co, std=0.1)
        wrap = S.conv3x3_int8_stream if k == 3 else S.tail_conv_int8_stream
        plain_fn = S.conv3x3_int8_plain if k == 3 else S.tail_conv_int8_plain
        run = lambda: wrap(xq, kq, ks, bias, relu)  # noqa: E731
        plain = lambda: plain_fn(xq, kq, ks, bias, relu)  # noqa: E731
        out = run()
        exact(name, wrap, plain_fn, xq, kq, ks, bias, relu)
        # The f32 output and, for the tails, the x3 and x4 widths: quarter
        # frame, bit for bit too.
        xqq = xq[:, :h // 2, :w // 2].contiguous()
        for cw in (co,) if k == 3 else (co, 27, 48):
            kqw, ksw = Q.fold_conv_kernel(
                rn(k, k, 64, cw, std=(k * k * 64) ** -0.5), s)
            for odt in (torch.bfloat16, torch.float32):
                exact(f"{name} co {cw} {odt}", wrap, plain_fn, xqq, kqw, ksw,
                      rn(cw, std=0.1), relu, odt)
        # The bf16 kernel of the same convolution on the dequantized map.
        bf16_fn = S.conv3x3_stream if k == 3 else S.tail_conv_stream
        bf16_ms = device_ms(lambda: bf16_fn(xd, kf, bias, relu))
        src = "conv3x3" if k == 3 else "tail_strip"
        record(name, f"transformerupscaler_torch/csrc/{src}.cu", replaces,
               0.0, "bit for bit", run, plain,
               nbytes(xq, out, kq, ks) + co * 4, on,
               int8_ops=2.0 * h * w * k * k * 64 * co,
               bf16_counterpart=bf16_fn.__name__, bf16_counterpart_ms=bf16_ms)

    k3, b3 = rn(3, 3, 64, 64, std=576 ** -0.5), rn(64, std=0.1)
    so = Q.act_scale(S.conv3x3_plain(x, k3, b3, True)) * 1.1
    run = lambda: S.conv3x3_stream(x, k3, b3, True, out_scale=so)  # noqa: E731
    plain = lambda: S.conv3x3_plain(x, k3, b3, True, out_scale=so)  # noqa: E731
    out = run()
    diff = (out.int() - plain().int()).abs()
    flipped = (diff != 0).float().mean().item()
    say("int8_out_check", max_step=diff.max().item(), flipped_share=flipped,
        tolerance="at most 1 step on under 0.1% of elements")
    if diff.max().item() > 1 or flipped >= 1e-3:
        raise AssertionError("conv3x3_stream out_scale disagrees with its "
                             "plain version")
    record(INT8_OUT, "transformerupscaler_torch/csrc/conv3x3.cu",
           "stream.py:425", diff.max().item(), "1 step", run, plain,
           nbytes(x, out) + 9 * 64 * 64 * 2 + 3 * 64 * 4, "int8_tails",
           flops=2.0 * h * w * 9 * 64 * 64)

    ke, be = rn(8, 8, 64, d, std=4096 ** -0.5).bfloat16(), rn(d, std=0.1)
    run = lambda: S.embed_stream(xq, ke, be, in_scale=s)  # noqa: E731
    plain = lambda: S.embed_plain(xq, ke, be, in_scale=s)  # noqa: E731
    out = run()
    record(INT8_IN, "transformerupscaler_torch/csrc/patch_gemm.cu",
           "stream.py:325", close_enough(out, plain(), **bf16), bf16, run,
           plain, nbytes(xq, out) + 4096 * d * 2 + d * 4 + 64 * 4,
           "int8_tails", flops=2.0 * ht * wt * 4096 * d)

    ku, bu = rn(d, 8, 8, 64, std=d ** -0.5).bfloat16(), rn(64, std=0.1)
    run = lambda: S.unembed_combine_stream(tok, xq, ku, bu, feat_scale=s)  # noqa: E731
    plain = lambda: S.unembed_combine_plain(tok, xq, ku, bu, feat_scale=s)  # noqa: E731
    out = run()
    record(INT8_SKIP, "transformerupscaler_torch/csrc/patch_gemm.cu",
           "stream.py:239", close_enough(out, plain(), **bf16), bf16, run,
           plain, nbytes(tok, xq, out) + d * 4096 * 2 + 2 * 64 * 4,
           "int8_tails", flops=2.0 * ht * wt * d * 4096)
    return records


def conv1_and_fused_cases(x, x_cl, rn, bf16) -> list[dict]:
    """conv1 on the 720x1280 RGB frame (3 -> 64), and the fused conv + tail
    at the x2 serving shapes: the decoder's 3x3 64 -> 64 + ReLU with the
    folded 7x7 64 -> 12 tail, and the encoder's conv2 with the 5x5 64 -> 12
    tail + ReLU, emitting conv2's output; then the two adapters of
    kernels/encoder.py on the same inputs.

    Tolerance: conv1 rounds its f32 sum to bf16 before the bias, so a sum
    near a rounding boundary can land one step of the sum apart (2^-7 of
    it): atol 2^-7 x max |sum|, rtol one output step. The fused kernels
    round the conv output to bf16 in between, where a sum in another order
    can flip an element by one step, which a tail weight carries into the
    output: one bf16 step plus 2^-7 x max |conv output| x max |tail weight|.
    The library calls: F.conv2d (channels-last bf16) for conv1, and the two
    F.conv2d calls of each unfused pair."""
    import torch.nn.functional as F

    from transformerupscaler_torch.kernels import encoder as E
    from transformerupscaler_torch.kernels import stream as S

    _, h, w, _ = x.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    img = torch.rand(1, h, w, 3, generator=g, device="cuda").bfloat16()
    k1, b1 = rn(3, 3, 3, 64, std=27 ** -0.5), rn(64, std=0.1)
    run = lambda: S.conv1_stream(img, k1, b1, True)  # noqa: E731
    plain = lambda: S.conv1_plain(img, k1, b1, True)  # noqa: E731
    out = run()
    sums = S.conv1_plain(img, k1).float().abs().max().item()
    tol = dict(rtol=bf16["rtol"], atol=2.0 ** -7 * sums)
    err = close_enough(out, plain(), **tol)
    w1 = k1.bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    img_cl, b1_16 = img.permute(0, 3, 1, 2), b1.bfloat16()
    bnd, by = bound_ms(nbytes(img, out) + 27 * 64 * 2 + 64 * 4,
                       2.0 * h * w * 27 * 64)
    records = [dict(
        name="conv1_stream", route="cuda",
        source="transformerupscaler_torch/csrc/conv1.cu",
        replaces="transformerupscaler_tpu/ops/pallas/stream.py:1269",
        max_abs_err=err, tolerance=tol, bound_ms=bnd, bound_by=by,
        **timing(run, plain,
                 lambda: F.conv2d(img_cl, w1, b1_16, padding=1)),
        on="bench_conv1")]

    kc, bc = rn(3, 3, 64, 64, std=1 / 24), rn(64, std=0.1)
    feat = S.conv3x3_plain(x, kc, bc, True)
    wc = kc.bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bc16 = bc.bfloat16()
    adapters = {}
    for name, kt, relu, replaces in (
            ("conv3x3_tail_stream", 7, False, "stream.py:584"),
            ("conv3x3_tail_emit_stream", 5, True, "stream.py:662")):
        ktl = rn(kt, kt, 64, 12, std=(kt * kt * 64) ** -0.5)
        bt = rn(12, std=0.1)
        flip = 2.0 ** -7 * feat.float().abs().max().item() * \
            ktl.abs().max().item()
        tol = dict(rtol=bf16["rtol"], atol=bf16["atol"] + flip)
        emit = name.endswith("emit_stream")
        wrap = getattr(S, name)
        plain_fn = (S.conv3x3_tail_emit_plain if emit
                    else S.conv3x3_tail_plain)
        run = lambda: wrap(x, kc, bc, ktl, bt, relu)  # noqa: E731
        plain = lambda: plain_fn(x, kc, bc, ktl, bt, relu)  # noqa: E731
        got, want = run(), plain()
        if emit:
            err = max(close_enough(got[0], want[0], **tol),
                      close_enough(got[1], want[1], **bf16))
            outs = got
        else:
            err = close_enough(got, want, **tol)
            outs = (got,)
        wt = ktl.bfloat16().permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bt16 = bt.bfloat16()

        def lib(wt=wt, bt16=bt16, kt=kt):
            return F.conv2d(F.conv2d(x_cl, wc, bc16, padding=1), wt, bt16,
                            padding=kt // 2)

        def pair(ktl=ktl, bt=bt, relu=relu):
            return S.tail_conv_stream(S.conv3x3_stream(x, kc, bc, True), ktl,
                                      bt, relu)

        flops = 2.0 * h * w * (9 * 64 * 64 + kt * kt * 64 * 12)
        bnd, by = bound_ms(nbytes(x, *outs) + (9 * 64 * 64 + kt * kt * 64 * 12)
                           * 2 + (64 + 12) * 4, flops)
        records.append(dict(
            name=name, route="cuda",
            source="transformerupscaler_torch/csrc/conv_tail.cu",
            replaces="transformerupscaler_tpu/ops/pallas/" + replaces,
            max_abs_err=err, tolerance=tol, bound_ms=bnd, bound_by=by,
            **timing(run, plain, lib), pair_ms=device_ms(pair),
            pair="conv3x3_stream then tail_conv_stream (the port's unfused "
                 "kernels)", on="bench_fuse"))
        adapters[name] = (ktl, bt, tol)

    # Rows 17 and 18: the adapters round the biases to bf16 first and call
    # the two wrappers above; held against their plain versions (check
    # lines, not records).
    ka, ba, tol_a = adapters["conv3x3_tail_emit_stream"]
    kb, bb, tol_b = adapters["conv3x3_tail_stream"]
    feat_k, a_k = E.fused_encoder(x, kc, bc, ka, ba)
    feat_p, a_p = E.fused_encoder_plain(x, kc, bc, ka, ba)
    enc_err = max(close_enough(feat_k, feat_p, **bf16),
                  close_enough(a_k, a_p, **tol_a))
    dec_err = close_enough(E.fused_decoder(x, kc, bc, kb, bb),
                           E.fused_decoder_plain(x, kc, bc, kb, bb), **tol_b)
    for name, replaces, err, tol in (
            ("fused_encoder", "encoder.py:239", enc_err, tol_a),
            ("fused_decoder", "encoder.py:279", dec_err, tol_b)):
        say("adapter_check", name=name,
            replaces="transformerupscaler_tpu/ops/pallas/" + replaces,
            shape=list(x.shape), vs_plain_max_abs=err, tolerance=tol)
    return records


def archived_cases(x, x_cl, tok, rn, bf16) -> list[dict]:
    """The archived kernels' wrappers at the 720x1280 serving shapes: the
    general 3x3 conv 64 -> 64 with bias and ReLU (and, as checks, the JAX
    tests' widths 256 -> 16 and 8 -> 8), the patch embed and the unembed +
    add, D = 192. Tolerances: one bf16 step for the conv and the embed
    (one rounding each); the unembed + add rounds three times, and its
    product summed in another order can round one bf16 step apart, which
    the adds carry into the output: one step of the output plus 2^-7 max
    |product|. Library calls: F.conv2d (channels-last bf16, bf16 bias,
    without the ReLU, as for row 1), torch.matmul on the materialized patch
    view and torch.addmm with the skip in patch order, as for rows 3 and 4.
    Bounds: the bytes each
    input is read and each output written, as for rows 1, 3 and 4."""
    import torch.nn.functional as F

    from transformerupscaler_torch.kernels import conv3x3 as C3
    from transformerupscaler_torch.kernels import patch_kernels as P

    _, h, w, _ = x.shape
    _, ht, wt, d = tok.shape
    records = []

    def record(name, source, replaces, err, tol, times, n_bytes, flops):
        bnd, by = bound_ms(n_bytes, flops)
        records.append(dict(
            name=name, route="cuda", source=source,
            replaces="transformerupscaler_tpu/ops/pallas/" + replaces,
            max_abs_err=err, tolerance=tol, bound_ms=bnd, bound_by=by,
            **times, on="archived"))

    k3, b3 = rn(3, 3, 64, 64, std=576 ** -0.5), rn(64, std=0.1)
    run = lambda: C3.conv3x3(x, k3, b3, True)  # noqa: E731
    plain = lambda: C3.conv3x3_plain(x, k3, b3, True)  # noqa: E731
    out = run()
    err = close_enough(out, plain(), **bf16)
    for c, o, hw in ((256, 16, (16, 32)), (8, 8, (6, 16))):
        xs = rn(1, *hw, c).bfloat16()
        ks, bs = rn(3, 3, c, o, std=(9 * c) ** -0.5), rn(o, std=0.1)
        got, want = C3.conv3x3(xs, ks, bs), C3.conv3x3_plain(xs, ks, bs)
        if got.shape != (1, *hw, o):
            raise AssertionError(f"conv3x3 {c} -> {o}: shape {got.shape}")
        err = max(err, close_enough(got, want, **bf16))
    w3 = k3.bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b3_16 = b3.bfloat16()
    record("conv3x3", "transformerupscaler_torch/csrc/conv3x3.cu",
           "conv3x3.py:73", err, bf16,
           timing(run, plain, lambda: F.conv2d(x_cl, w3, b3_16, padding=1)),
           nbytes(x, out) + 9 * 64 * 64 * 2 + 64 * 4,
           2.0 * h * w * 9 * 64 * 64)

    ke, be = rn(8, 8, 64, d, std=4096 ** -0.5).bfloat16(), rn(d, std=0.1)
    run = lambda: P.fused_patch_embed(x, ke, be)  # noqa: E731
    plain = lambda: P.fused_patch_embed_plain(x, ke, be)  # noqa: E731
    out = run()
    patches = (x.reshape(1, ht, 8, wt, 8, 64).permute(0, 1, 3, 2, 4, 5)
               .reshape(-1, 8 * 8 * 64).contiguous())
    ke16 = ke.reshape(-1, d)
    record("fused_patch_embed", "transformerupscaler_torch/csrc/patch_gemm.cu",
           "patch_kernels.py:50", close_enough(out, plain(), **bf16), bf16,
           dict(timing(run, plain, lambda: torch.matmul(patches, ke16)),
                library_call=PATCH_MATMUL),
           nbytes(x, out, ke16) + d * 4, 2.0 * ht * wt * 4096 * d)

    ku, bu = rn(d, 8, 8, 64, std=d ** -0.5).bfloat16(), rn(64, std=0.1)
    run = lambda: P.fused_patch_unembed_add(tok, x, ku, bu)  # noqa: E731
    plain = lambda: P.fused_patch_unembed_add_plain(tok, x, ku, bu)  # noqa: E731
    out = run()
    tok2, ku16 = tok.reshape(-1, d), ku.reshape(d, -1)
    y_max = (tok2.float() @ ku16.float()).abs().max().item()
    tol = dict(rtol=bf16["rtol"], atol=bf16["atol"] + 2.0 ** -7 * y_max)
    record("fused_patch_unembed_add",
           "transformerupscaler_torch/csrc/patch_gemm.cu",
           "patch_kernels.py:106", close_enough(out, plain(), **tol), tol,
           unembed_yardsticks(run, plain, x, tok2, ku16),
           nbytes(tok, x, out, ku16) + 64 * 4, 2.0 * ht * wt * d * 4096)
    return records


# The fused trunk's records: name (its counter before any "/"), model and
# route whose frame gives the windows and weights, kernel mode, the TPU
# kernel it replaces, and the route that launches it.
TRUNK_CASES = (
    ("fused_window_trunk", "FastTransformer", ROUTE_BENCH, "v2",
     "trunk2.py:524", "bench"),
    ("fused_window_trunk.v2/128", "WindowTransformer", ROUTE_WINDOW, "v2",
     "trunk2.py:524", "window_fused2"),
    ("fused_window_trunk.v1/128", "WindowTransformer",
     dict(ROUTE_WINDOW, attn_impl="fused"), "v1", "trunk.py:128",
     "window_fused"),
    ("fused_window_trunk.v1", "FastTransformer",
     dict(ROUTE_BENCH, attn_impl="fused"), "v1", "trunk.py:128",
     "fast_fused"),
    ("fused_window_trunk.int8_rowwise", "FastTransformer",
     dict(ROUTE_BENCH, int8_trunk=True), "int8_rowwise", "trunk2.py:524",
     "bench_int8_trunk"),
    ("fused_window_trunk.int8_static", "FastTransformer", ROUTE_BENCH,
     "int8_static", "trunk2.py:524", "trunk_static"),
)


def trunk_case(rn, name, model_name, route, mode, replaces, on) -> dict:
    """The fused trunk in one mode on the windows of one serving frame, with
    the seeded full-width weights of the model that runs it there:
    FastTransformer's 90 x 160 tokens padded to 96 x 160 are 240 windows of
    dim 192 through six layers, WindowTransformer's 45 x 80 tokens (behind
    its stride-2 downsample) padded to 48 x 80 are 60 windows of dim 128
    through eight.

    Both the kernel and its plain version round to bf16 some twenty times a
    layer, and one element that rounds the other way shifts its token's next
    product by a fraction of a bf16 step (in the int8 mode it can also move
    a GEMM input to the neighbouring int8 value), so after the layers most
    elements sit a step or two apart. The bound is therefore stated against
    the same arithmetic carried in f32 from the same bf16 (and int8)
    weights: the kernel's mean error against it may be at most 1.25 times
    the plain version's, and against the plain version itself max abs <= 0.5
    and mean abs <= 0.03 at values of a few units. The bound on time counts
    the GEMMs at the card's dense int8 rate in the int8 mode, attention at
    the bf16 rate. The static mode's scales are calibrated on the record's
    own windows (``trunk_int8_scales``)."""
    from transformerupscaler_torch.kernels import trunk2 as T
    from transformerupscaler_torch.models.common import (
        run_window_trunk,
        trunk_int8_scales,
    )
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    model = get_model(model_name, dtype=torch.bfloat16, **route)
    params_from_jax(model, seeded_params(model, 0))
    params = model.trunk_params()
    down = 8 if model_name == "FastTransformer" else 16
    ht, wt = FRAME_HW[0] // down, FRAME_HW[1] // down
    n_win = -(-ht // 8) * -(-wt // 8)
    layers, dim = params["vpack"].shape[0], params["fc1w"].shape[1]
    tokens = T.TOKENS
    _, skey, ikey = T.PACKS[mode]
    win = rn(n_win, tokens, dim).bfloat16()
    if mode == "int8_static":
        params = T.add_static_int8(params, trunk_int8_scales(model.blocks,
                                                             win))
    run = lambda: T.fused_window_trunk(win, params, mode)  # noqa: E731
    plain = lambda: T.fused_window_trunk_plain(win, params, mode)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    want = plain()
    exact = T.fused_window_trunk_plain(
        win.float(), {k: v.float() if torch.is_tensor(v)
                      and v.is_floating_point() else v
                      for k, v in params.items()}, mode)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: output is not finite")
    err = (out.float() - want.float()).abs()
    e_kernel = (out.float() - exact).abs().mean().item()
    e_plain = (want.float() - exact).abs().mean().item()
    tolerance = ("vs plain max <= 0.5, mean <= 0.03; mean error vs the f32 "
                 "arithmetic <= 1.25 x the plain version's")
    say("trunk_check", name=name, shape=[n_win, tokens, dim], layers=layers,
        mode=mode, vs_plain_max_abs=err.max().item(),
        vs_plain_mean_abs=err.mean().item(), kernel_vs_f32_mean_abs=e_kernel,
        plain_vs_f32_mean_abs=e_plain, out_abs_mean=exact.abs().mean().item(),
        tolerance=tolerance)
    if not (err.max().item() <= 0.5 and err.mean().item() <= 0.03
            and e_kernel <= 1.25 * e_plain):
        raise AssertionError(f"{name} disagrees with its plain version")
    count = layers * n_win * tokens
    gemm_ops = 2.0 * 12 * dim * dim * count  # qkv, proj, fc1, fc2
    attn_ops = 2.0 * 2 * tokens * dim * count
    # Each GEMM's weights once (the rowwise pack carries fc1's twice).
    sfx = {"int8_rowwise": "_q", "int8_static": "_sq"}.get(mode, "")
    n_bytes = nbytes(win, out, params["vpack"], params["tables"],
                     *(params[k + sfx] for k in T.GEMMS),
                     *(params[k] for k in (skey, ikey) if k is not None))
    if skey is not None:
        bnd, by = bound_ms(n_bytes, attn_ops, int8_ops=gemm_ops)
    else:
        bnd, by = bound_ms(n_bytes, gemm_ops + attn_ops)
    if name == "fused_window_trunk":
        tok = win.reshape(1, 8 * n_win, 8, dim)  # any grid of whole windows
        eager = cuda_ms(
            lambda: run_window_trunk(tok, model.blocks, 8, "xla"), 5)
        say("trunk_eager", eager_trunk_ms=eager,
            note="run_window_trunk(impl='xla') on the same windows: the "
                 "other route's trunk, not a yardstick")
    return dict(
        name=name, route="cuda",
        source="transformerupscaler_torch/csrc/window_trunk.cu",
        replaces="transformerupscaler_tpu/ops/pallas/" + replaces,
        max_abs_err=err.max().item(), tolerance=tolerance, bound_ms=bnd,
        bound_by=by, **timing(run, plain), on=on)


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper the models call swapped for its plain version,
    by the kernels package's explicit mapping. No launch counter may move
    inside."""
    from transformerupscaler_torch import kernels as K
    from transformerupscaler_torch.models import (
        common,
        fast_transformer,
        residual_transformer,
        window_transformer,
    )
    from transformerupscaler_torch.ops import attention

    saved = [(mod, name, getattr(mod, name))
             for mod in (common, fast_transformer, residual_transformer,
                         window_transformer, attention)
             for name in K.PLAIN_VERSIONS if hasattr(mod, name)]
    missing = set(K.PLAIN_VERSIONS) - {name for _, name, _ in saved}
    if missing:
        raise AssertionError(f"no model module calls {sorted(missing)}")
    before = K.launch_counts()
    try:
        for mod, name, _ in saved:
            setattr(mod, name, K.PLAIN_VERSIONS[name])
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if K.launch_counts() != before:
        raise AssertionError(f"a kernel launched on the plain versions: "
                             f"{before} -> {K.launch_counts()}")


def interior_err(got: np.ndarray, want: np.ndarray, crop: int):
    err = np.abs(got - want)[..., crop:-crop, crop:-crop, :]
    return float(err.max()), float(err.mean())


LIMIT = (3e-2, 3e-3)


def within_limit(emax: float, emean: float, limit=LIMIT) -> bool:
    return emax <= limit[0] and emean <= limit[1]


def limit_text(limit=LIMIT) -> str:
    return f"interior max <= {limit[0]}, mean <= {limit[1]}"


def phase_fixture(name: str) -> None:
    """One route at a small geometry against its committed JAX output;
    FastTransformer then at x3 and x4 (other tail widths) against itself on
    the plain versions."""
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    spec = ROUTES[name]
    config = dict(spec.get("fixture_config", {}))
    with np.load(spec["fixture"]) as f:
        seed, x, want = int(f["seed"]), f["x"], f["y"]
        res_out = tuple(int(v) for v in f["res_out"])
        if "scale_feat" in f.files:  # an int8 route's static JAX scales
            config["int8_scales"] = tuple(tuple(f[f"scale_{n}"].tolist())
                                          for n in INT8_TENSORS)
    limit = INT8_LIMIT if "int8_scales" in config else LIMIT
    model = get_model(spec["model"], dtype=spec.get("dtype", torch.bfloat16),
                      **spec["route"], **config)
    params_from_jax(model, seeded_params(model, seed))
    with route_env(spec.get("env", {})):
        _fixture_checks(name, spec, model, x, want, res_out, limit)


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matrix products in full f32 (cuDNN's default is
    TF32), as the f32 reference computes them."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _fixture_checks(name, spec, model, x, want, res_out, limit) -> None:
    tol = spec.get("fixture_tol")
    if tol is not None:  # f32: the whole frame, border included
        with no_tf32():
            got = model(torch.from_numpy(x).cuda(), res_out=res_out).cpu()
        err = np.abs(got.numpy() - want)
        excess = float((err - tol["rtol"] * np.abs(want)).max())
        say("fixture", route=name, shape=list(got.shape),
            max_abs=float(err.max()), mean_abs=float(err.mean()),
            tolerance=f"whole frame |got - want| <= {tol['atol']} + "
                      f"{tol['rtol']} |want|, TF32 off")
        if got.shape != want.shape or excess > tol["atol"]:
            raise AssertionError(f"{name}: the port on the card disagrees "
                                 f"with the JAX fixture")
        return
    got = model(torch.from_numpy(x).cuda(), res_out=res_out).float().cpu()
    emax, emean = interior_err(got.numpy(), want, 4)
    say("fixture", route=name, shape=list(got.shape), max_abs=emax,
        mean_abs=emean, tolerance=limit_text(limit))
    if not within_limit(emax, emean, limit):
        raise AssertionError(f"{name}: the port on the card disagrees with "
                             f"the JAX fixture")
    if spec["model"] != "FastTransformer":
        return
    xs = torch.rand(1, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    for scale in (3, 4):
        got = model(xs.cuda(), upscale_factor=scale).float().cpu().numpy()
        with plain_versions():
            ref = model(xs.cuda(), upscale_factor=scale).float().cpu().numpy()
        emax, emean = interior_err(got, ref, 2 * scale)
        say("scale", route=name, scale=scale, shape=list(got.shape),
            vs_plain_max_abs=emax, vs_plain_mean_abs=emean,
            tolerance=limit_text())
        if not within_limit(emax, emean):
            raise AssertionError(f"{name} x{scale}: kernels and plain "
                                 f"versions disagree")


def phase_slice(name: str) -> dict:
    """Serve 720x1280 frames on one route; returns the launch counts."""
    with route_env(ROUTES[name].get("env", {})):
        return _serve(name)


def _serve(name: str) -> dict:
    from transformerupscaler_torch import kernels as K
    from transformerupscaler_torch.infer_lib import UpscalerEngine

    spec = ROUTES[name]
    res_out = spec["res_out"]
    dtype = spec.get("dtype", torch.bfloat16)
    # The trained weights (seeded only for a model with no checkpoint):
    # the engine on its CUDA graphs, and the same engine eager.
    engine = UpscalerEngine(spec["model"], dtype=dtype, **spec["route"])
    eager = UpscalerEngine(spec["model"], dtype=dtype, cuda_graphs=False,
                           **spec["route"])
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), np.uint8)
              for _ in range(spec["requests"])]
    calibration = None
    if spec.get("calibrate"):
        # Static scales from three other seeded frames, as a user
        # calibrates before serving; a served frame is held against them.
        cal = np.random.default_rng(1).integers(0, 256, (3, *FRAME_HW, 3),
                                                np.uint8)
        t0 = time.perf_counter()
        scales = engine.calibrate_int8(cal, res_out=res_out)
        calibration = dict(frames=len(cal),
                           seconds=time.perf_counter() - t0,
                           check=engine.calibration_check(frames[0],
                                                          res_out=res_out))
        if eager.calibrate_int8(cal, res_out=res_out) != scales:
            raise AssertionError(f"{name}: the two engines calibrated "
                                 f"different scales")
    served = {}
    for way, eng in (("graphed", engine), ("eager", eager)):
        for fr in frames[:WARMUP]:
            eng.upscale(fr, res_out=res_out)
        torch.cuda.synchronize()
        K.reset_launches()
        outs, request_ms = [], []
        for fr in frames:  # closed loop: one request after the other
            t0 = time.perf_counter()
            outs.append(eng.upscale(fr, res_out=res_out))
            request_ms.append((time.perf_counter() - t0) * 1e3)
        launches = K.launch_counts()
        per_frame = {k: v / len(frames) for k, v in launches.items()}
        if per_frame != spec["launches"]:
            raise AssertionError(f"{name} ({way}): launches per frame "
                                 f"{per_frame} != {spec['launches']}")
        served[way] = outs, request_ms, launches
    outs, request_ms, launches = served["graphed"]
    differ = [i for i, (a, b) in enumerate(zip(outs, served["eager"][0]))
              if not np.array_equal(a, b)]
    if differ:
        raise AssertionError(f"{name}: graphed and eager outputs differ on "
                             f"frames {differ}")
    out = outs[0]
    # Every model clips to [0, 1] but the bicubic baseline, which overshoots.
    lo, hi = (-0.5, 1.5) if spec["model"] == "BicubicInterpolation" else (0, 1)
    if out.shape != (*res_out, 3) or not np.isfinite(out).all() or \
            out.min() < lo or out.max() > hi:
        raise AssertionError(f"bad output: {out.shape} [{out.min()}, "
                             f"{out.max()}]")

    xd = torch.from_numpy(frames[0]).cuda().float().div(255.0)[None]
    fwd_ms = cuda_ms(lambda: eager.model(xd, res_out=res_out), 10)
    fwd_graphed_ms = cuda_ms(engine.captured(frames[0],
                                             res_out=res_out).replay, 10)

    with plain_versions():
        plain = eager.upscale(frames[0], res_out=res_out)
    emax, emean = interior_err(out, plain, 8)
    med = float(np.median(request_ms))
    eager_ms = served["eager"][1]
    say("slice", route=name, model=spec["model"], dtype=str(engine.dtype),
        flags=spec["route"], env=spec.get("env", {}),
        weights=(f"epoch {engine.epoch}" if engine.checkpoint_path
                 else "seeded (no checkpoint)"),
        graphed=True, res_out=list(res_out), frames=len(frames),
        request_ms_median=med, request_ms_min=min(request_ms),
        request_ms_max=max(request_ms), fps_median=1e3 / med,
        request_ms_median_eager=float(np.median(eager_ms)),
        request_ms_min_eager=min(eager_ms), forward_ms=fwd_ms,
        forward_ms_graphed=fwd_graphed_ms, launches=launches,
        launches_per_frame={k: v / len(frames) for k, v in launches.items()},
        graphed_equals_eager=True, out_shape=list(out.shape),
        out_range=[float(out.min()), float(out.max())],
        vs_plain_max_abs=emax, vs_plain_mean_abs=emean,
        tolerance=limit_text(), calibration=calibration)
    if not within_limit(emax, emean):
        raise AssertionError(f"{name}: kernels and plain versions disagree "
                             f"end to end")
    return launches


def phase_weights() -> None:
    """The three default checkpoints, found and read as the engine reads
    them, and each default engine on its model's demo input against the
    JAX default engine's output on the same weights, at the f32 bounds
    (``fast_exact``'s) with TF32 off."""
    from transformerupscaler_torch.checkpoint import (
        default_checkpoint_dir,
        fingerprint,
        get_latest_checkpoint,
        load_checkpoint,
        param_count,
    )
    from transformerupscaler_torch.infer_lib import UpscalerEngine

    atol, rtol = F32_TOL["atol"], F32_TOL["rtol"]
    for name, (epoch, count) in TRAINED.items():
        t0 = time.perf_counter()
        path, found = get_latest_checkpoint(default_checkpoint_dir(name))
        tree = load_checkpoint(path, name)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = UpscalerEngine(name)
        engine_s = time.perf_counter() - t0
        if (found, engine.epoch, engine.checkpoint_path) != (epoch, epoch,
                                                             path) or \
                param_count(tree) != count or engine.param_count() != count:
            raise AssertionError(f"{name}: loaded epoch {engine.epoch} from "
                                 f"{engine.checkpoint_path}, "
                                 f"{engine.param_count()} parameters")
        with np.load(f"{FIXTURES}trained_{name}.npz") as f:
            fix = {k: f[k] for k in f.files}
        if str(fix["fingerprint"]) != fingerprint(path):
            raise AssertionError(f"{name}: the trained fixture is not of "
                                 f"{path}")
        x, want = fix["x"], fix["y"]
        sums = {}
        with no_tf32():
            if "crop" in fix:
                y0, x0, h, w = (int(v) for v in fix["crop"])
                got = engine.upscale(x[y0:y0 + h, x0:x0 + w],
                                     upscale_factor=int(fix["scale"]))
            else:
                full = engine.upscale(x, res_out=tuple(
                    int(v) for v in fix["res_out"]))
                r0, c0, h, w = (int(v) for v in fix["window"])
                got = full[r0:r0 + h, c0:c0 + w]
                # Every element within atol + rtol |want| (want >= 0, the
                # output is clipped) keeps the mean within atol + rtol mean.
                mean = float(full.astype(np.float64).mean())
                sums = dict(mean=mean, want_mean=float(fix["y_mean"]),
                            sum=float(full.astype(np.float64).sum()),
                            want_sum=float(fix["y_sum"]))
                if abs(mean - sums["want_mean"]) > \
                        atol + rtol * sums["want_mean"]:
                    raise AssertionError(f"{name}: the whole output's mean "
                                         f"{sums}")
        err = np.abs(got - want)
        excess = float((err - rtol * np.abs(want)).max())
        say("weights", model=name, checkpoint=path, epoch=engine.epoch,
            param_count=engine.param_count(), load_seconds=load_s,
            engine_seconds=engine_s, input=list(x.shape),
            shape=list(got.shape), max_abs=float(err.max()),
            mean_abs=float(err.mean()), **sums,
            tolerance=f"|got - want| <= {atol} + {rtol} |want|, TF32 off")
        if got.shape != want.shape or not excess <= atol:
            raise AssertionError(f"{name}: the trained default engine "
                                 f"disagrees with the JAX fixture")


def phase_quality() -> None:
    """What each served FastTransformer route costs in fidelity on a real
    frame with the trained weights: FastTransformer's demo input cropped to
    176x320 at x2, against the trained exact f32 path (TF32 off) on the
    same frame. Static int8 scales come from ``calibrate_int8`` on another
    frame, ResidualTransformer's demo input. Numbers only: it fails on a
    wrong shape or a value that is not finite, and sets no quality bar."""
    from transformerupscaler_torch.infer_lib import UpscalerEngine

    with np.load(f"{FIXTURES}trained_FastTransformer.npz") as f:
        x = f["x"][:176]
    with np.load(f"{FIXTURES}trained_ResidualTransformer.npz") as f:
        cal = f["x"]
    with no_tf32():
        ref = UpscalerEngine("FastTransformer").upscale(x, upscale_factor=2)
    for name in QUALITY_ROUTES:
        spec = ROUTES[name]
        with route_env(spec.get("env", {})):
            engine = UpscalerEngine("FastTransformer", dtype=torch.bfloat16,
                                    **spec["route"])
            if spec.get("calibrate"):
                engine.calibrate_int8(cal, upscale_factor=2)
            got = engine.upscale(x, upscale_factor=2)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"quality {name}: output {got.shape}")
        err = np.abs(got.astype(np.float64) - ref)
        mse = float((err ** 2).mean())
        say("quality", route=name, weights=f"epoch {engine.epoch}",
            input=list(x.shape), scale=2,
            scales="static, calibrate_int8 on ResidualTransformer's demo "
                   "input" if spec.get("calibrate") else None,
            psnr_db=10 * np.log10(1.0 / mse) if mse else float("inf"),
            max_abs=float(err.max()), mean_abs=float(err.mean()),
            against="the trained exact f32 path (TF32 off)")


def phase_bench() -> None:
    """The port's bench (``bf16``) as a benchmark would run it: its own
    process, its JSON result and what it said on stderr."""
    cmd = [sys.executable, "-m", "transformerupscaler_torch.bench"]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "TUX_BENCH_CONFIG": "bf16"})
    if run.returncode:
        raise AssertionError(f"bench failed ({run.returncode}): "
                             f"{run.stderr[-4000:]}")
    result = json.loads(run.stdout.strip().splitlines()[-1])
    if set(result) != {"metric", "value", "unit"} or not result["value"] > 0:
        raise AssertionError(f"bench printed {result}")
    say("bench", command="python3 -m transformerupscaler_torch.bench",
        config="bf16", result=result, stderr=run.stderr.strip().splitlines())


def phase_archived() -> dict:
    """The archived kernels' path: a seeded 720x1280 feature map through the
    general 3x3 conv (FastTransformer's conv2 weights, ReLU), the patch
    embed and the unembed + add (its patch weights), with the launch counts
    set to zero just before and read just after. Each step is held against
    its plain version on the same input, with its record's tolerance."""
    from transformerupscaler_torch import kernels as K
    from transformerupscaler_torch.kernels import conv3x3 as C3
    from transformerupscaler_torch.kernels import patch_kernels as P
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    model = get_model("FastTransformer", dtype=torch.bfloat16, **ROUTE_BENCH)
    params_from_jax(model, seeded_params(model, 0))
    k2, b2 = model.conv2.kernel, model.conv2.bias
    ke, be = model.patch_embed_kernel, model.patch_embed_bias
    ku, bu = model.patch_unembed_kernel, model.patch_unembed_bias
    g = torch.Generator(device="cuda").manual_seed(2)
    feat1 = torch.rand(1, *FRAME_HW, 64, generator=g,
                       device="cuda").bfloat16()
    torch.cuda.synchronize()
    K.reset_launches()
    feat = C3.conv3x3(feat1, k2, b2, True)
    tokens = P.fused_patch_embed(feat, ke, be)
    out = P.fused_patch_unembed_add(tokens, feat, ku, bu)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    want = counts(conv3x3=1, fused_patch_embed=1, fused_patch_unembed_add=1)
    if launches != want:
        raise AssertionError(f"archived: launches {launches} != {want}")
    h, w = FRAME_HW
    bf16 = dict(rtol=2.0 ** -7, atol=1e-3)
    d = tokens.shape[-1]
    y_max = (tokens.reshape(-1, d).float() @ ku.bfloat16().float()
             .reshape(d, -1)).abs().max().item()
    errs = {}
    for name, got, plain, shape, tol in (
            ("conv3x3", feat, lambda: C3.conv3x3_plain(feat1, k2, b2, True),
             (1, h, w, 64), bf16),
            ("fused_patch_embed", tokens,
             lambda: P.fused_patch_embed_plain(feat, ke, be),
             (1, h // 8, w // 8, d), bf16),
            ("fused_patch_unembed_add", out,
             lambda: P.fused_patch_unembed_add_plain(tokens, feat, ku, bu),
             (1, h, w, 64), dict(rtol=bf16["rtol"],
                                 atol=bf16["atol"] + 2.0 ** -7 * y_max))):
        if tuple(got.shape) != shape:
            raise AssertionError(f"archived {name}: {tuple(got.shape)}")
        errs[name] = close_enough(got, plain(), **tol)
    if K.launch_counts() != launches:
        raise AssertionError("archived: a kernel launched on the plain path")
    say("archived", launches={k: v for k, v in launches.items() if v},
        vs_plain_max_abs=errs, out_abs_mean=out.float().abs().mean().item(),
        tolerance="one bf16 step; the unembed + add plus 2^-7 max |product|")
    return launches


def phase_trunk_static() -> dict:
    """FastTransformer's full-width trunk (dim 192, 6 blocks, 12 heads,
    seeded weights) in the static int8 mode: the tokens its own embed gives
    a seeded 720x1280 frame on the ``bench`` route, scales from
    ``trunk_int8_scales`` on those tokens' windows, then
    ``run_window_trunk(..., "fused2", int8_acts=scales)`` with the launch
    counts set to zero just before and read just after. Printed beside it:
    the error against the bf16 v2 trunk of this mode, of the rowwise mode
    and of the naive constant scales 8.0 (no order asserted); held against
    the same call on the plain versions by the trunk's criterion. Timed:
    that call, which folds the weights for the scales each time, the fold
    alone (``add_static_int8``), and the call given the folded pack kept
    for the same scales, which folds nothing."""
    from transformerupscaler_torch import kernels as K
    from transformerupscaler_torch.kernels import trunk2 as T
    from transformerupscaler_torch.models.common import (
        run_window_trunk,
        trunk_int8_scales,
        trunk_windows,
    )
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    model = get_model("FastTransformer", dtype=torch.bfloat16, **ROUTE_BENCH)
    params_from_jax(model, seeded_params(model, 0))
    seen = []
    run_trunk = model.run_trunk
    model.run_trunk = lambda t: (seen.append(t), run_trunk(t))[1]
    frame = np.random.default_rng(3).integers(0, 256, (*FRAME_HW, 3),
                                              np.uint8)
    x = torch.from_numpy(frame).cuda().float().div(255.0)[None]
    model(x, res_out=RES_OUT)
    del model.run_trunk
    tokens = seen[0]
    ws, blocks, stacked = model.window_size, model.blocks, model.trunk_params()
    t0 = time.perf_counter()
    scales = trunk_int8_scales(blocks, trunk_windows(tokens, ws)[0])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0

    def trunk(int8_acts=None, params=stacked):
        return run_window_trunk(tokens, blocks, ws, "fused2", params,
                                int8_acts)

    torch.cuda.synchronize()
    K.reset_launches()
    out = trunk(scales)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    if launches != counts("int8_static"):
        raise AssertionError(f"trunk_static: launches {launches}")
    if tuple(out.shape) != tuple(tokens.shape) or \
            not torch.isfinite(out.float()).all():
        raise AssertionError(f"trunk_static: output {tuple(out.shape)}")
    ref = trunk().float()
    naive = tuple(torch.full_like(s, 8.0) for s in scales)
    rowwise = T.stack_trunk_params(blocks, torch.bfloat16, True)
    errs = {}
    for name, got in (("static_calibrated", out),
                      ("rowwise", trunk("rowwise", rowwise)),
                      ("static_naive_8", trunk(naive))):
        e = (got.float() - ref).abs()
        errs[name] = dict(max_abs=e.max().item(), mean_abs=e.mean().item())
    with plain_versions():
        want = trunk(scales).float()
    e = (out.float() - want).abs()
    kept = T.add_static_int8(stacked, scales)
    if not torch.equal(trunk(scales, kept), out):
        raise AssertionError("trunk_static: the kept pack gives another "
                             "output")
    say("trunk_static", model="FastTransformer", tokens=list(tokens.shape),
        windows=trunk_windows(tokens, ws)[0].shape[0], layers=len(blocks),
        launches=launches, calibration_seconds=calib_s,
        call_ms=cuda_ms(lambda: trunk(scales)),
        fold_ms=cuda_ms(lambda: T.add_static_int8(stacked, scales)),
        call_kept_pack_ms=cuda_ms(lambda: trunk(scales, kept)),
        scale_max=[s.max().item() for s in scales],
        vs_bf16_v2_trunk=errs, vs_plain_max_abs=e.max().item(),
        vs_plain_mean_abs=e.mean().item(), out_abs_mean=ref.abs().mean().item(),
        tolerance="vs plain max <= 0.5, mean <= 0.03")
    if not (e.max().item() <= 0.5 and e.mean().item() <= 0.03):
        raise AssertionError("trunk_static: kernel and plain versions "
                             "disagree")
    return launches


def main() -> None:
    kind = phase_device()
    phase_build()
    records = phase_kernels()
    for name, spec in ROUTES.items():
        if "fixture" in spec:
            phase_fixture(name)
    phase_weights()
    launches = {name: phase_slice(name) for name in ROUTES}
    phase_quality()
    launches["archived"] = phase_archived()
    launches["trunk_static"] = phase_trunk_static()
    phase_bench()
    say("tpu_kernels", kernels=[dict(kernel=k, port=s) for k, s in TPU_KERNELS])
    for r in records:
        # The count of the record's counter (its wrapper, or the trunk's
        # mode) on the route that runs the record's shape (``on``).
        wrapper = r["name"].split("/")[0]
        r.pop("tolerance", None)
        r["launches"] = launches[r.pop("on")][wrapper]
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on its path")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
