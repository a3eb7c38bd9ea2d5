"""Where the patch kernels' time goes, by ablation, on the GPU.

    python3 -m transformerupscaler_torch.patch_ablation [--variants full ...]

Builds ``csrc/patch_gemm.cu`` as it is and in variants with one part
switched off by a textual edit of the source (so the variants compute wrong
values: only their times mean anything), and times the bf16 embed and
unembed + skip at the 720x1280 serving shape (90 x 160 tokens, D = 192)
by CUDA events over back-to-back launches. A "no_*_refetch" variant loads
that operand only into the ring's first stages and reuses them after. Prints
one JSON line per variant; the difference from ``full`` is what the part
costs where it is not hidden behind another.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from transformerupscaler_torch.kernels import _build

B, HT, WT, D, REPS = 1, 90, 160, 192, 50
# Never true: the call stays, the work goes.
OFF, U_OFF = "if (D < 0) ", "if (relu < 0) "
TX = "S::mbar_expect_tx(&full[stage], L::STAGE);\n"
# The embed's stage: expected bytes, then its A and its W copies.
E_A = TX + "        for (int sg = 0; sg < 2 * E_WG; ++sg)"
E_W = "        for (int cc = 0; cc < E_NC; ++cc)"
# The unembed's stage: expected bytes with its W copies, then the skip's.
U_W = TX + "        for (int kc = 0; kc < KC; ++kc)"
U_SKIP = "        for (int sg = 0; sg < 2 * WG; ++sg)\n          S::tma_load_4d"


def _fill(text: str, bytes_after: str, loop: str | None, after: str) -> str:
    """``text`` with the stage's expected bytes ``bytes_after`` once the ring
    is full (stage index ``after``), and the copy loop ``loop`` cut to the
    fill."""
    full = f"{after} < {'E_STAGES' if after == 'q' else 'L::STAGES'}"
    text = text.replace("L::STAGE);", f"{full} ? L::STAGE : {bytes_after});")
    if loop is not None:
        text = text.replace(f" < {loop};", f" < ({full} ? {loop} : 0);")
    return text


# variant -> [(text that stands once in the source, its replacement)]
EDITS = {
    "full": [],
    "embed_no_w_refetch": [(E_A, _fill(E_A, "L::A_BYTES", None, "q")),
                           (E_W, _fill(E_W, "", "E_NC", "q"))],
    "embed_no_a_refetch": [(E_A, _fill(E_A, "L::STAGE - L::A_BYTES",
                                       "2 * E_WG", "q"))],
    "embed_no_refetch": [(E_A, _fill(E_A, "0", "2 * E_WG", "q")),
                         (E_W, _fill(E_W, "", "E_NC", "q"))],
    "embed_no_mma": [("          S::wgmma_ss_n192(acc,",
                      "          " + OFF + "S::wgmma_ss_n192(acc,")],
    "unembed_no_w_refetch": [(U_W, _fill(U_W, "L::STAGE - KC * TILE", "KC",
                                         "p"))],
    "unembed_no_skip_refetch": [(U_W, _fill(U_W, "KC * TILE", None, "p")),
                                (U_SKIP, _fill(U_SKIP, "", "2 * WG", "p"))],
    "unembed_no_refetch": [(U_W, _fill(U_W, "0", "KC", "p")),
                           (U_SKIP, _fill(U_SKIP, "", "2 * WG", "p"))],
    "unembed_no_mma": [("        S::wgmma_ss_n64(acc,",
                        "        " + U_OFF + "S::wgmma_ss_n64(acc,")],
    "unembed_no_epilogue_math": [
        ("      for (int j = 0; j < 8; ++j)\n#pragma unroll\n"
         "        for (int i = 0; i < 2; ++i) {\n"
         "          const int r = 16 * warp + g + 8 * i;",
         "      for (int j = 0; j < (relu < 0 ? 8 : 0); ++j)\n"
         "        for (int i = 0; i < 2; ++i) {\n"
         "          const int r = 16 * warp + g + 8 * i;")],
    "unembed_no_store": [("          S::tma_store_4d(&omap,",
                          "          " + U_OFF + "S::tma_store_4d(&omap,")],
    "embed_one_stage_less": [("constexpr int E_STAGES = 4;",
                              "constexpr int E_STAGES = 3;")],
    "unembed_one_stage_less": [
        ("static constexpr int STAGES = (WG == 2 && KC <= 3) ? 3 : 2;",
         "static constexpr int STAGES = (WG == 2 && KC <= 3) ? 2 : 1;")],
    "embed_no_rotation": [("        const int q = (i + lu) % (PS * PS);",
                           "        const int q = i;")],
}


def build(out_dir, names) -> dict[str, ctypes.CDLL]:
    source = (_build.CSRC / "patch_gemm.cu").read_text()
    procs = {}
    for name in names:
        edits = EDITS[name]
        text = source.replace('"sm90.cuh"', f'"{_build.CSRC / "sm90.cuh"}"')
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
        for fn, argtypes in _build.SIGNATURES["patch_gemm"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", choices=sorted(EDITS),
                        default=list(EDITS))
    names = parser.parse_args().variants
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "patch_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir, names)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * std
                ).bfloat16()

    feat = rn(B, 8 * HT, 8 * WT, 64)
    we, wu = rn(4096, D, std=4096 ** -0.5), rn(D, 4096, std=D ** -0.5)
    be = torch.zeros(D, device="cuda")
    bu = torch.zeros(64, device="cuda")
    tokens = rn(B, HT, WT, D)
    out_t, out_f = torch.empty_like(tokens), torch.empty_like(feat)
    stream = torch.cuda.current_stream().cuda_stream

    def ms(call) -> float:
        def run():
            err = call()
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
        embed = ms(lambda: lib.tux_embed(
            feat.data_ptr(), we.data_ptr(), be.data_ptr(), None,
            out_t.data_ptr(), B, HT, WT, D, 0, stream))
        unembed = ms(lambda: lib.tux_unembed_combine(
            tokens.data_ptr(), wu.data_ptr(), bu.data_ptr(), feat.data_ptr(),
            None, out_f.data_ptr(), B, HT, WT, D, 0, 0, 0, stream))
        print(json.dumps({"device": smi, "variant": name, "embed_ms": embed,
                          "unembed_ms": unembed}), flush=True)


if __name__ == "__main__":
    main()
