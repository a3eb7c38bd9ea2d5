"""Where the fused trunk kernel's time goes, by ablation, on the GPU.

    python3 -m transformerupscaler_torch.trunk_ablation
        [--mode v2 | int8_rowwise | int8_static] [--csrc DIR]
        [--variants full no_mma ...]

Builds ``csrc/window_trunk.cu`` as it is and in variants with one part
switched off by a textual edit of the source (so the variants compute wrong
values: only their times mean anything), and times each on seeded inputs at
the serving shape (240 windows, six layers, C=192) and on 132 windows, in
one kernel mode (default "v2"; at 132 windows the kernel takes one window a
block). Each edit must stand once in the source, or the build raises.
``--csrc`` builds another tree's source (its ``common.cuh`` and ``sm90.cuh``
beside it): the int8 variants of the ``mma.sync`` kernel that trees before
the int8 modes' TMA + ``wgmma`` design hold are chosen by that source's
text. Prints one JSON line per variant; the difference from ``full`` is
what the part costs where it is not hidden behind another.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels._common import TRUNK_MODES

LAYERS, WINDOWS, REPS, DIM = 6, 240, 20, 192
OFF = "if (layers < 0) "  # never true: the call stays, the work goes
GELU = ("return 0.5f * h * (1.0f + erf_branchless(h * "
        "0.70710678118654752f));")
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
        (GELU, "return h;")],
    # The two parts of the epilogue math apart.
    "no_gelu": [
        (GELU, "return h;")],
    "no_bias_add": [
        ("  return __hadd2(__floats2bfloat162_rn(v0, v1), bias);",
         "  return __floats2bfloat162_rn(v0, v1);")],
    # Every block one window: no slab shared between two windows.
    "one_window_a_block": [
        ("const int wpb = n_windows <= S::sm_count(device) ? 1 : WG;",
         "const int wpb = 1;")],
}
# The int8 modes' variants by the design of the source: "mma_sync" is the
# one-window-a-block kernel with a cp.async ring (window_trunk_i8_kernel)
# of trees before the int8 modes moved onto TMA + wgmma.
I8_EDITS = {
    "wgmma": {
        "full": [],
        "no_mma": [(text, "if (n < 0) " + text) for text in (
            "S::wgmma_i8_ss_n64_init(acc, S::desc_k64(a, 0),",
            "S::wgmma_i8_ss_n64(acc, S::desc_k64(a + kt",
            "S::wgmma_i8_rs_n192_init(acc, frag[0],",
            "S::wgmma_i8_rs_n192(acc, frag[0],",
            "S::wgmma_i8_rs_n192(acc, frag[1],")],
        # Each quantize (LayerNorm's, the context's, the GELU output's) as
        # one xor of its input's bits with its scale's: the scales stay.
        "no_quantize": [
            ("  return __float2int_rn(__fmul_rn(a, inv));",
             "  return __float_as_int(a) ^ __float_as_int(inv);"),
            ("  const float v = fmaxf(__fmul_rn(a, ia), -127.f);",
             "  return __float_as_int(a) ^ __float_as_int(ia);\n"
             "  const float v = 0.f;")],
        "no_attention": [("        attend(ctx_g[hh], q[hh],",
                          "        " + OFF + "attend(ctx_g[hh], q[hh],")],
        "no_layernorm": [
            (f"    layernorm_to_a_i8<K>(xs, a_tile, vp + V::LN{i}S",
             f"    {OFF}layernorm_to_a_i8<K>(xs, a_tile, vp + V::LN{i}S")
            for i in (1, 2)],
        "no_weight_fetch": EDITS["no_weight_fetch"],
        "no_gelu": [("  return 0.5f * h * one_plus_erf;", "  return h;")],
        # "int8_rowwise": the first pass's products and epilogues; its slabs
        # are still waited for and released.
        "no_fc1_pass1": [(
            "      gelu_row_max<K>(hmax,",
            "      for (int j = 0; j < K::CHUNKS; ++j) {\n"
            "        const int n = ring.next++;\n"
            "        ring.wait_full(n);\n"
            "        ring.release(n, lane);\n"
            "      }\n"
            "      hmax[0] = hmax[1] = 1.f;\n"
            "      " + OFF + "gelu_row_max<K>(hmax,")],
        "one_window_a_block": EDITS["one_window_a_block"],
    },
    "mma_sync": {
        "full": [],
        "no_mma": [("        mma_s8(acc[f][j],",
                    "        if (kk < 0) mma_s8(acc[f][j],")],
        # The passes that quantize the context and the GELU output in place
        # (LayerNorm's quantize stays: it is no pass of its own).
        "no_quantize": [("    quantize_rows<C, K::ROWS>(ys,",
                         "    " + OFF + "quantize_rows<C, K::ROWS>(ys,"),
                        ("    quantize_rows<4 * C, K::ROWS>(big,",
                         "    " + OFF + "quantize_rows<4 * C, K::ROWS>(big,")],
        "no_attention": [("    attention<K>(big, ys,",
                          "    " + OFF + "attention<K>(big, ys,")],
        "no_layernorm": [(f"    layernorm<K>(xs, ys, srow, vp + V::LN{i}S",
                          f"    {OFF}layernorm<K>(xs, ys, srow, vp + V::LN{i}S")
                         for i in (1, 2)],
        # Only the slabs of the first prefetch are copied.
        "no_weight_fetch": [("    if (fetched < total) {",
                             "    if (fetched < I8_STAGES - 1) {")],
    },
}


def design_of(source: str, mode: str) -> dict:
    if mode in ("v2", "v1"):
        return EDITS
    table = I8_EDITS["mma_sync" if "window_trunk_i8_kernel" in source
                     else "wgmma"]
    if "no_fc1_pass1" not in table:
        return table
    if mode != "int8_rowwise":
        return {k: v for k, v in table.items() if k != "no_fc1_pass1"}
    # The floor of the rowwise design with the GELU output kept in shared
    # memory instead of a first pass (one window a block, for the room).
    return dict(table, one_window_no_fc1_pass1=table["no_fc1_pass1"]
                + table["one_window_a_block"])


def build(csrc: Path, edits: dict, out_dir: Path) -> dict[str, ctypes.CDLL]:
    source = (csrc / "window_trunk.cu").read_text()
    procs = {}
    for name, changes in edits.items():
        text = source
        for old, new in changes:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} does not stand once "
                                   f"in the source")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        (out_dir / f"{name}.ptxas.txt").write_text(log)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.tux_window_trunk.argtypes = \
            _build.SIGNATURES["window_trunk"]["tux_window_trunk"]
        lib.tux_window_trunk.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", default="v2",
                        choices=("v2", "v1", "int8_rowwise", "int8_static"))
    parser.add_argument("--csrc", type=Path, default=_build.CSRC,
                        help="the directory of the window_trunk.cu to build")
    parser.add_argument("--variants", nargs="*", default=None)
    args = parser.parse_args()
    source = (args.csrc / "window_trunk.cu").read_text()
    table = design_of(source, args.mode)
    names = args.variants or list(table)
    edits = {n: table[n] for n in names}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    tag = hashlib.sha256(source.encode()).hexdigest()[:10]
    out_dir = _build.BUILD_DIR / "trunk_ablation" / f"{args.mode}-{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(args.csrc, edits, out_dir)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std):
        return torch.randn(*shape, device="cuda", generator=g) * std

    c = DIM
    win = rn(WINDOWS, 64, c, std=1.0).bfloat16()
    vpack = rn(LAYERS, 13 * c, std=0.1).bfloat16()
    # The bf16 kernels read (L, heads, 225) tables, the mma_sync int8 kernel
    # the gathered (L, heads, 64, 64) bias: one buffer large enough for both.
    bias = rn(LAYERS, c // 16, 64, 64, std=0.5)
    sw = ia = None
    if args.mode.startswith("int8"):
        # Room for the largest int8 pack (48 slabs a layer); the product of
        # a unit-scale input row with a column of these weights is O(1).
        wpack = torch.randint(-127, 128, (LAYERS, 48, c, 64), device="cuda",
                              generator=g, dtype=torch.int8)
        sw = torch.full((LAYERS, 9 * c), 1.0 / (73.0 * 4 * c ** 0.5),
                        device="cuda")
        ia = torch.full((LAYERS, 7 * c), 127.0 / 4.0, device="cuda")
    else:
        wpack = rn(LAYERS, 12 * c // 64, c, 64, std=c ** -0.5).bfloat16()
    out = torch.empty_like(win)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    mode_index = TRUNK_MODES.index(args.mode)

    def ms(lib, n_windows: int) -> float:
        def run():
            err = lib.tux_window_trunk(
                win.data_ptr(), wpack.data_ptr(), vpack.data_ptr(),
                bias.data_ptr(), sw.data_ptr() if sw is not None else None,
                ia.data_ptr() if ia is not None else None, out.data_ptr(),
                n_windows, LAYERS, c, mode_index, 0, stream)
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
        print(json.dumps({"device": smi, "mode": args.mode,
                          "source": str(args.csrc), "variant": name,
                          "ms_240_windows": ms(lib, WINDOWS),
                          "ms_one_wave": ms(lib, min(sms, WINDOWS)),
                          "windows_in_one_wave": min(sms, WINDOWS)}))


if __name__ == "__main__":
    main()
