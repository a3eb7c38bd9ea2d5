#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments. Phases, one line each:

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. the kernel build (nvcc, sm_90a) from transformerupscaler_torch/csrc/;
3. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes of the 720x1280 -> 1080x1920 (x2) serving frame, with its
   time, the plain version's, one PyTorch library call's and the card's
   bound for the same work;
4. the slice at 16x32 -> x2 against the committed JAX output
   (tests/fixtures/torch_port/slice_x2_bf16.npz), weights rebuilt from its
   numpy seed; then at x3 and x4 against the same model on the plain
   versions;
5. the full slice: UpscalerEngine at full model width with seeded weights,
   serving 720x1280 frames at res_out 1080x1920, with the launch counts per
   frame and the output held against the same engine on the plain versions;
6. the status of every TPU kernel of the JAX package in the port.

Then one JSON line of kernel records and, last, {"ok": true, "device": ...}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
WARMUP, REPS = 3, 20
FRAME_HW, RES_OUT, SCALE = (720, 1280), (1080, 1920), 2
N_REQUESTS = 20
FIXTURE = "tests/fixtures/torch_port/slice_x2_bf16.npz"
ROUTE = dict(compose_tails=True, pallas_serve=True, split_tail=False,
             attn_impl="xla")

# Every function of transformerupscaler_tpu/ops/pallas that reaches
# pl.pallas_call, and where the port stands on it.
TPU_KERNELS = [
    ("stream.py:425 conv3x3_deint_stream",
     "ported and checked: conv3x3_stream (bf16; int8 out_scale not yet)"),
    ("stream.py:777 tail_macro8_stream",
     "ported and checked: tail_conv_stream"),
    ("stream.py:325 embed_stream",
     "ported and checked: embed_stream (bf16; int8 in_scale not yet)"),
    ("stream.py:239 unembed_combine_stream",
     "ported and checked: unembed_combine_stream (bf16; int8 feat_scale "
     "not yet)"),
    ("trunk2.py:524 fused_window_trunk_v2", "not yet"),
    ("stream.py:1078 tail_finish_stream", "not yet"),
    ("stream.py:82 conv3x3_packed_stream", "not yet"),
    ("stream.py:147 conv3x3_packed_int8_stream", "not yet"),
    ("stream.py:893 tail_macro8_stream_int8", "not yet"),
    ("stream.py:584 conv3x3_tail_stream", "not yet"),
    ("stream.py:662 conv3x3_tail_emit_stream", "not yet"),
    ("stream.py:1269 conv1_dots_stream", "not yet"),
    ("stream.py:1385 conv1_flat_stream", "not yet"),
    ("gmha.py:60 global_mha", "not yet"),
    ("trunk.py:128 fused_window_trunk", "not yet"),
    ("window_attn.py:58 fused_window_attention", "not yet"),
    ("encoder.py:239 fused_encoder", "not yet"),
    ("encoder.py:279 fused_decoder", "not yet"),
    ("conv3x3.py:73 conv3x3_pallas", "not yet"),
    ("patch_kernels.py:50 fused_patch_embed", "not yet"),
    ("patch_kernels.py:106 fused_patch_unembed_add", "not yet"),
]


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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    return kind


def phase_build() -> None:
    from transformerupscaler_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    regs = []
    for f in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        regs += [ln.split(":", 1)[1].strip() for ln in f.read_text().splitlines()
                 if "Used" in ln and "registers" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 3),
        built={k: round(v, 3) for k, v in built.items()}, ptxas=regs)


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

    def conv_case(name, k, co, relu, replaces):
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
        flops = 2.0 * h * w * k * k * 64 * co
        bnd, by = bound_ms(nbytes(x, out) + k * k * 64 * co * 2 + co * 4,
                           flops)
        records.append(dict(
            name=name, route="cuda",
            source="transformerupscaler_torch/csrc/conv_nhwc.cu",
            replaces=replaces, max_abs_err=err, ms=cuda_ms(run),
            plain_ms=cuda_ms(plain, 3), bound_ms=bnd, bound_by=by,
            library_ms=cuda_ms(lib)))

    conv_case("conv3x3_stream", 3, 64, True,
              "transformerupscaler_tpu/ops/pallas/stream.py:425")
    conv_case("tail_conv_stream/5x5", 5, 12, True,
              "transformerupscaler_tpu/ops/pallas/stream.py:777")
    conv_case("tail_conv_stream/7x7", 7, 12, False,
              "transformerupscaler_tpu/ops/pallas/stream.py:777")

    ke, be = rn(8, 8, 64, d, std=4096 ** -0.5), rn(d, std=0.1)
    out = S.embed_stream(x, ke, be)
    err = close_enough(out, S.embed_plain(x, ke, be), **bf16)
    patches = (x.reshape(1, ht, 8, wt, 8, 64).permute(0, 1, 3, 2, 4, 5)
               .reshape(-1, 8 * 8 * 64).contiguous())
    ke16 = ke.bfloat16().reshape(-1, d)
    bnd, by = bound_ms(nbytes(x, out, ke16) + d * 4, 2.0 * ht * wt * 4096 * d)
    records.append(dict(
        name="embed_stream", route="cuda",
        source="transformerupscaler_torch/csrc/patch_gemm.cu",
        replaces="transformerupscaler_tpu/ops/pallas/stream.py:325",
        max_abs_err=err, ms=cuda_ms(lambda: S.embed_stream(x, ke, be)),
        plain_ms=cuda_ms(lambda: S.embed_plain(x, ke, be), 3),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: torch.matmul(patches, ke16))))

    ku, bu = rn(d, 8, 8, 64, std=d ** -0.5), rn(64, std=0.1)
    out = S.unembed_combine_stream(tok, x, ku, bu)
    err = close_enough(out, S.unembed_combine_plain(tok, x, ku, bu), **bf16)
    err = max(err, close_enough(S.unembed_combine_stream(tok, x, ku, bu, True),
                                S.unembed_combine_plain(tok, x, ku, bu, True),
                                **bf16))
    tok2, ku16 = tok.reshape(-1, d), ku.bfloat16().reshape(d, -1)
    bnd, by = bound_ms(nbytes(tok, x, out, ku16) + 64 * 4,
                       2.0 * ht * wt * d * 4096)
    records.append(dict(
        name="unembed_combine_stream", route="cuda",
        source="transformerupscaler_torch/csrc/patch_gemm.cu",
        replaces="transformerupscaler_tpu/ops/pallas/stream.py:239",
        max_abs_err=err,
        ms=cuda_ms(lambda: S.unembed_combine_stream(tok, x, ku, bu)),
        plain_ms=cuda_ms(lambda: S.unembed_combine_plain(tok, x, ku, bu), 3),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: torch.matmul(tok2, ku16))))
    torch.cuda.synchronize()
    for r in records:
        say("kernel", **r)
    return records


@contextlib.contextmanager
def plain_versions():
    """The model's kernel wrappers swapped for their plain versions."""
    from transformerupscaler_torch.kernels import stream as S
    from transformerupscaler_torch.models import fast_transformer as FT

    kernels = {n: getattr(FT, n) for n in S.KERNELS}
    try:
        for n in S.KERNELS:
            setattr(FT, n, getattr(S, n.replace("_stream", "_plain")))
        yield
    finally:
        for n, fn in kernels.items():
            setattr(FT, n, fn)


def interior_err(got: np.ndarray, want: np.ndarray, crop: int):
    err = np.abs(got - want)[..., crop:-crop, crop:-crop, :]
    return float(err.max()), float(err.mean())


def phase_fixture() -> None:
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    with np.load(FIXTURE) as f:
        seed, x, want = int(f["seed"]), f["x"], f["y"]
        res_out = tuple(int(v) for v in f["res_out"])
    model = get_model("FastTransformer", dtype=torch.bfloat16, **ROUTE)
    params_from_jax(model, seeded_params(model, seed))
    got = model(torch.from_numpy(x).cuda(), res_out=res_out).float().cpu()
    emax, emean = interior_err(got.numpy(), want, 4)
    say("fixture", shape=list(got.shape), max_abs=emax, mean_abs=emean,
        tolerance="interior max <= 3e-2, mean <= 3e-3")
    if not (emax <= 3e-2 and emean <= 3e-3):
        raise AssertionError("port on the card disagrees with the JAX fixture")
    # x3 and x4 run the tail kernel at co = 27 and 48: kernels vs plain.
    xs = torch.rand(1, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    for scale in (3, 4):
        got = model(xs.cuda(), upscale_factor=scale).float().cpu().numpy()
        with plain_versions():
            ref = model(xs.cuda(), upscale_factor=scale).float().cpu().numpy()
        emax, emean = interior_err(got, ref, 2 * scale)
        say("scale", scale=scale, shape=list(got.shape), vs_plain_max_abs=emax,
            vs_plain_mean_abs=emean,
            tolerance="interior max <= 3e-2, mean <= 3e-3")
        if not (emax <= 3e-2 and emean <= 3e-3):
            raise AssertionError(f"x{scale}: kernels and plain versions "
                                 f"disagree")


def phase_slice() -> dict:
    from transformerupscaler_torch.infer_lib import UpscalerEngine
    from transformerupscaler_torch.kernels import stream as S

    engine = UpscalerEngine("FastTransformer", dtype=torch.bfloat16, seed=0,
                            **ROUTE)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), np.uint8)
              for _ in range(N_REQUESTS)]
    for fr in frames[:WARMUP]:
        engine.upscale(fr, res_out=RES_OUT)
    torch.cuda.synchronize()
    S.reset_launches()
    outs, request_ms = [], []
    for fr in frames:  # closed loop: one request after the other
        t0 = time.perf_counter()
        outs.append(engine.upscale(fr, res_out=RES_OUT))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(S.LAUNCHES)
    per_frame = {k: v / len(frames) for k, v in launches.items()}
    want = {"conv3x3_stream": 2, "tail_conv_stream": 2, "embed_stream": 1,
            "unembed_combine_stream": 1}
    if per_frame != want:
        raise AssertionError(f"launches per frame {per_frame} != {want}")
    out = outs[0]
    if out.shape != (*RES_OUT, 3) or not np.isfinite(out).all() or \
            out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"bad output: {out.shape} [{out.min()}, "
                             f"{out.max()}]")

    xd = torch.from_numpy(frames[0]).cuda().float().div(255.0)[None]
    fwd_ms = cuda_ms(lambda: engine.model(xd, res_out=RES_OUT), 10)

    with plain_versions():
        plain = engine.upscale(frames[0], res_out=RES_OUT)
    emax, emean = interior_err(out, plain, 8)
    med = float(np.median(request_ms))
    say("slice", frames=len(frames), request_ms_median=med,
        request_ms_min=min(request_ms), request_ms_max=max(request_ms),
        fps_median=1e3 / med, forward_ms=fwd_ms, launches=launches,
        launches_per_frame=per_frame, out_shape=list(out.shape),
        out_range=[float(out.min()), float(out.max())],
        vs_plain_max_abs=emax, vs_plain_mean_abs=emean,
        tolerance="interior max <= 3e-2, mean <= 3e-3")
    if not (emax <= 3e-2 and emean <= 3e-3):
        raise AssertionError("kernels and plain versions disagree end to end")
    return launches


def main() -> None:
    kind = phase_device()
    phase_build()
    records = phase_kernels()
    phase_fixture()
    launches = phase_slice()
    say("tpu_kernels", kernels=[dict(kernel=k, port=s) for k, s in TPU_KERNELS])
    for r in records:
        r["launches"] = launches[r["name"].split("/")[0]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
