"""Where the fused trunk kernel's time goes, by ablation, on the GPU.

    python3 -m transformerupscaler_torch.trunk_ablation

Builds ``csrc/window_trunk.cu`` as it is and in variants with one part
switched off by a textual edit of the source (so the variants compute wrong
values: only their times mean anything), and times each on seeded inputs at
the serving shape (240 windows, six layers) and on one wave of windows (one
per SM), in the kernel's mode "v2" at C=192. Prints one JSON line per
variant; the difference from ``full`` is what the part costs where it is
not hidden behind another.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from transformerupscaler_torch.kernels import _build

LAYERS, WINDOWS, REPS = 6, 240, 20
OFF = "if (layers < 0) "  # never true: the call stays, the work goes
# variant -> [(text that stands once in the source, its replacement)]
EDITS = {
    "full": [],
    "no_attention": [("    attention<K>(big, ys,",
                      "    " + OFF + "attention<K>(big, ys,")],
    "no_layernorm": [(f"    layernorm<K>(xs, ys, srow, vp + K::V_LN{i}S",
                      f"    {OFF}layernorm<K>(xs, ys, srow, vp + K::V_LN{i}S")
                     for i in (1, 2)],
    "no_mma": [("        tux::mma_bf16(acc[f][j], af[f][0]",
                "        if (sa < 0) tux::mma_bf16(acc[f][j], af[f][0]")],
    "no_weight_fetch": [("    if (fetched < total) {",
                         "    if (fetched < 2) {")],
    "no_epilogue_math": [
        ("return round_bf16(r.x + bias.x, r.y + bias.y);",
         "return make_float2(v0 + bias.x, v1 + bias.y);"),
        ("return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));",
         "return h;")],
}


def build(out_dir) -> dict[str, ctypes.CDLL]:
    source = (_build.CSRC / "window_trunk.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = source.replace('"common.cuh"',
                              f'"{_build.CSRC / "common.cuh"}"')
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} does not stand once "
                                   f"in the source")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.tux_window_trunk.argtypes = \
            _build.SIGNATURES["window_trunk"]["tux_window_trunk"]
        lib.tux_window_trunk.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "trunk_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std):
        return torch.randn(*shape, device="cuda", generator=g) * std

    win = rn(WINDOWS, 64, 192, std=1.0).bfloat16()
    wpack = rn(LAYERS, 36, 64, 192, std=192 ** -0.5).bfloat16()
    vpack = rn(LAYERS, 2496, std=0.1).bfloat16()
    bias = rn(LAYERS, 12, 64, 64, std=0.5)
    out = torch.empty_like(win)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def ms(lib, n_windows: int) -> float:
        def run():
            err = lib.tux_window_trunk(
                win.data_ptr(), wpack.data_ptr(), vpack.data_ptr(),
                bias.data_ptr(), None, None, out.data_ptr(), n_windows,
                LAYERS, 192, 0, 0, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    for name, lib in libs.items():
        print(json.dumps({"device": smi, "variant": name,
                          "ms_240_windows": ms(lib, WINDOWS),
                          "ms_one_wave": ms(lib, min(sms, WINDOWS)),
                          "windows_in_one_wave": min(sms, WINDOWS)}))


if __name__ == "__main__":
    main()
