"""Where the fused trunk kernel's time goes, by ablation, on the GPU.

    python3 -m transformerupscaler_torch.trunk_ablation

Builds ``csrc/window_trunk.cu`` as it is and in variants with one part
switched off by a textual edit of the source (so the variants compute wrong
values: only their times mean anything), and times each on seeded inputs at
the serving shape (240 windows, six layers) and on 132 windows, in the
kernel's mode "v2" at C=192 (the TMA + ``wgmma`` kernel; at 132 windows it
takes one window a block). Each edit must stand once in the source, or the
build raises. Prints one JSON line per variant; the difference from
``full`` is what the part costs where it is not hidden behind another.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from transformerupscaler_torch.kernels import _build

LAYERS, WINDOWS, REPS = 6, 240, 20
OFF = "if (layers < 0) "  # never true: the call stays, the work goes
GELU = "return 0.5f * h * (1.0f + erf_branchless(h * 0.70710678118654752f));"
# variant -> [(text that stands once in the source, its replacement)]
EDITS = {
    "full": [],
    "no_attention": [("        attend(ctx[hh], q[hh],",
                      "        " + OFF + "attend(ctx[hh], q[hh],")],
    "no_layernorm": [(f"    layernorm_to_a<C>(xs, a_tile, vp + V::LN{i}S",
                      f"    {OFF}layernorm_to_a<C>(xs, a_tile, vp + V::LN{i}S")
                     for i in (1, 2)],
    "no_mma": [("      S::wgmma_ss_kb<64>(acc,",
                "      if (n < 0) S::wgmma_ss_kb<64>(acc,"),
               ("    S::wgmma_rs_kb<K::C>(acc,",
                "    if (n < 0) S::wgmma_rs_kb<K::C>(acc,")],
    # Only the first ring's worth of slabs is copied; the others complete
    # their barrier phase with a plain arrive.
    "no_weight_fetch": [
        ("      S::mbar_expect_tx(&full[stage], K::STAGE);",
         "      if (i >= K::STAGES) { S::mbar_arrive(&full[stage]); } else {\n"
         "      S::mbar_expect_tx(&full[stage], K::STAGE);"),
        ("                     i * C);", "                     i * C); }")],
    "no_rel_bias": [
        ("    s[nf][0] = s[nf][0] * 0.25f + __ldg(p);",
         "    s[nf][0] = s[nf][0] * 0.25f;"),
        ("    s[nf][1] = s[nf][1] * 0.25f + __ldg(p - 1);",
         "    s[nf][1] = s[nf][1] * 0.25f;"),
        ("    s[nf][2] = s[nf][2] * 0.25f + __ldg(p + 15);",
         "    s[nf][2] = s[nf][2] * 0.25f;"),
        ("    s[nf][3] = s[nf][3] * 0.25f + __ldg(p + 14);",
         "    s[nf][3] = s[nf][3] * 0.25f;")],
    "no_epilogue_math": [
        ("  return __hadd2(__floats2bfloat162_rn(v0, v1), bias);",
         "  return __floats2bfloat162_rn(v0, v1);"),
        ("return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));",
         "return h;")],
    # The two parts of the epilogue math apart.
    "no_gelu": [
        ("return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));",
         "return h;")],
    "no_bias_add": [
        ("  return __hadd2(__floats2bfloat162_rn(v0, v1), bias);",
         "  return __floats2bfloat162_rn(v0, v1);")],
    # Every block one window: no slab shared between two windows.
    "one_window_a_block": [
        ("const int wpb = n_windows <= S::sm_count(device) ? 1 : WG;",
         "const int wpb = 1;")],
}


def build(out_dir) -> dict[str, ctypes.CDLL]:
    source = (_build.CSRC / "window_trunk.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} does not stand once "
                                   f"in the source")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
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
    wpack = rn(LAYERS, 36, 192, 64, std=192 ** -0.5).bfloat16()
    vpack = rn(LAYERS, 2496, std=0.1).bfloat16()
    tables = rn(LAYERS, 12, 225, std=0.5)
    out = torch.empty_like(win)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def ms(lib, n_windows: int) -> float:
        def run():
            err = lib.tux_window_trunk(
                win.data_ptr(), wpack.data_ptr(), vpack.data_ptr(),
                tables.data_ptr(), None, None, out.data_ptr(), n_windows,
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
