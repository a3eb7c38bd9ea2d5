"""Where the time of ``global_mha`` and the archived ``conv3x3`` goes, by
ablation, on the GPU.

    python3 -m transformerupscaler_torch.kernel_ablation \
        [--variants global_mha:full conv3x3:no_store ...]

Builds ``csrc/global_mha.cu`` and ``csrc/conv3x3.cu`` as they are and in
variants with one part switched off by a textual edit of the source (so the
variants compute wrong values: only their times mean anything), and times
each kernel at its 720p serving shape by CUDA events over back-to-back
launches: the attention core at (1, 3600, 128) with 8 heads on q, k, v
sliced from one packed qkv, the conv at (1, 720, 1280, 64) -> 64 with bias
and ReLU. A "no_*_refetch" variant loads that operand only into the ring's
first stages and reuses them after. The variants named for what they do
instead (``*_on_fma``, ``one_block_per_sm``) are alternatives that were
measured and not kept. Prints one JSON line per variant; the difference
from its kernel's ``full`` is what the part costs where it is not hidden
behind another.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from transformerupscaler_torch.kernels import _build

N, HEADS, H, W, C, REPS = 3600, 8, 720, 1280, 64, 50

# The pass-1 sums and the pass-2 probabilities of global_mha.cu.
P1 = ("        l0 += ex2(fmaf(s[4 * jj], C_LOG2, -b0)) +\n"
      "              ex2(fmaf(s[4 * jj + 1], C_LOG2, -b0));\n"
      "        l1 += ex2(fmaf(s[4 * jj + 2], C_LOG2, -b1)) +\n"
      "              ex2(fmaf(s[4 * jj + 3], C_LOG2, -b1));")
P2 = ("          a[f] = pack(ex2(fmaf(s[e], C_LOG2, -bm[f & 1])),\n"
      "                      ex2(fmaf(s[e + 1], C_LOG2, -bm[f & 1])));")
KV = ("      S::mbar_expect_tx(&full[st], j < tiles ? TILE : 2 * TILE);\n"
      "      S::tma_load_3d(dst, &kmap, &full[st], HD * h, KT * i, b);\n"
      "      if (j >= tiles)\n")
PV = ("        tux::mma_bf16(cx[0], a[0], a[1], a[2], a[3], bv[0], bv[1]);\n"
      "        tux::mma_bf16(cx[1], a[0], a[1], a[2], a[3], bv[2], bv[3]);\n")
EX2 = ("__device__ __forceinline__ float ex2(float x) {\n  float y;\n"
       "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
       "  return y;\n}\n")
# 2^x for x <= 0 on the FMA pipe, within 2.2e-7 of 2^x: x = n + f with n =
# rint(x) from the 1.5 * 2^23 rounding constant, 2^f by a degree-5
# polynomial fitted for relative error, n added to the exponent bits.
POLY = EX2 + """
__device__ __forceinline__ float ex2_mix(bool fma_pipe, float x) {
  if (!fma_pipe) return ex2(x);
  x = fmaxf(x, -127.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = 1.32764678e-3f;
  p = fmaf(p, f, 9.67554189e-3f);
  p = fmaf(p, f, 5.55071346e-2f);
  p = fmaf(p, f, 2.40221202e-1f);
  p = fmaf(p, f, 6.93146944e-1f);
  p = fmaf(p, f, 1.00000012f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
"""
REFILL = ("      if (j >= LAG && wid == j % (WG * 4)) {\n"
          "        if (lane == 0) load(j - LAG + STAGES);\n"
          "        __syncwarp();\n      }\n"
          "      S::mbar_wait(&full[st], (q / STAGES) & 1);")
HALO = ("        S::mbar_expect_tx(&h_full[hs], HALO);\n"
        "        S::tma_load_4d(")
WSLAB = ("            S::mbar_expect_tx(&w_full[wst], SLAB);\n"
         "            S::tma_load_2d(")


def _no_ex2(text: str) -> str:
    return text.replace("ex2(fmaf(", "(fmaf(")


# kernel -> variant -> [(text that stands once in the source, replacement)]
EDITS = {
    "global_mha": {
        "full": [],
        "no_pass1_exp": [(P1, _no_ex2(P1))],
        "no_pass2_exp": [(P2, _no_ex2(P2))],
        "no_exp": [(P1, _no_ex2(P1)), (P2, _no_ex2(P2))],
        # The probabilities and V's fragments are still computed and
        # folded into the output.
        "no_pv": [(PV, "        cx[kk & 1][0] += __int_as_float(a[0] ^ a[1] ^ "
                       "a[2] ^ a[3] ^ bv[0] ^ bv[1] ^ bv[2] ^ bv[3]);\n")],
        # k and v only into the ring's first stages of each pass of the
        # block's first unit.
        "no_kv_refetch": [(KV, "      const bool fill = k == 0 && i < int(STAGES);\n"
                               "      S::mbar_expect_tx(&full[st], fill ? (j < "
                               "tiles ? TILE : 2 * TILE) : 0);\n"
                               "      if (fill) S::tma_load_3d(dst, &kmap, "
                               "&full[st], HD * h, KT * i, b);\n"
                               "      if (j >= tiles && fill)\n")],
        # No copies after the ring's first fill and no waits for them: what
        # the copy machinery (waits, refills by a warp in turn) costs.
        "no_refill": [(REFILL, "      if (j < int(STAGES)) S::mbar_wait("
                               "&full[st], (q / STAGES) & 1);")],
        # S = Q K^T skipped: the scores are whatever the registers hold.
        "no_qk": [("      S::wgmma_ss_n128(s, qd, ",
                   "      if (n < 0) S::wgmma_ss_n128(s, qd, ")],
        "no_pass1_max": [("        t0 = fmaxf(t0, fmaxf(s[4 * jj], s[4 * jj + 1]));\n"
                          "        t1 = fmaxf(t1, fmaxf(s[4 * jj + 2], "
                          "s[4 * jj + 3]));\n", "")],
        # bf16 pairs by truncating bit operations instead of F2FP.
        "no_pack": [("  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
                     "  return *reinterpret_cast<const uint32_t*>(&v);",
                     "  return (__float_as_uint(lo) >> 16) | "
                     "(__float_as_uint(hi) & 0xffff0000u);")],
        # Tried: a quarter of one pass's exponentials on the FMA pipe.
        "pass1_quarter_on_fma": [(EX2, POLY),
                                 (P1, P1.replace("ex2(fmaf(",
                                                 "ex2_mix(jj < 4, fmaf("))],
        "pass2_quarter_on_fma": [(EX2, POLY),
                                 (P2, P2.replace("ex2(fmaf(",
                                                 "ex2_mix(kk < 2, fmaf("))],
        # Tried: one block an SM (8 warps), the units in up to two rounds.
        "one_block_per_sm": [("  const int slots = 2 * S::sm_count(device);",
                              "  const int slots = S::sm_count(device);")],
    },
    "conv3x3": {
        "full": [],
        # The halo of the block's first HSTAGES tiles only.
        "no_halo_refetch": [(HALO, "        const bool fill = u < int(blockIdx"
                                   ".x + HSTAGES * gridDim.x);\n"
                                   "        S::mbar_expect_tx(&h_full[hs], "
                                   "fill ? HALO : 0);\n"
                                   "        if (fill) S::tma_load_4d(")],
        # At C = 64 the nine slabs are resident and load once: this edits
        # only the streamed path (C > 64), so the kernel timed is the same.
        "no_weight_refetch": [(WSLAB, "            const bool fill = u == "
                                      "blockIdx.x && tap < WSTAGES;\n"
                                      "            S::mbar_expect_tx(&w_full"
                                      "[wst], fill ? SLAB : 0);\n"
                                      "            if (fill) S::tma_load_2d(")],
        "no_mma": [("          S::wgmma_ss_n64(acc, desc_shift(",
                    "          if (H < 0) S::wgmma_ss_n64(acc, desc_shift(")],
        "no_store": [("      if (y0 + wg < H) S::tma_store_4d(",
                      "      if (y0 + wg < H && H < 0) S::tma_store_4d(")],
    },
}
VARIANTS = [f"{k}:{v}" for k, vs in EDITS.items() for v in vs]


def build(out_dir, names) -> dict[str, ctypes.CDLL]:
    """One library per ``kernel:variant`` name, all nvcc runs at once."""
    procs = {}
    for name in names:
        kernel, variant = name.split(":")
        text = (_build.CSRC / f"{kernel}.cu").read_text()
        for old, new in EDITS[kernel][variant]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} does not stand once in "
                                   f"the source")
            text = text.replace(old, new)
        stem = name.replace(":", "-")
        (out_dir / f"{stem}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{stem}.so"), str(out_dir / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name.replace(':', '-')}.so"))
        for fn, argtypes in _build.SIGNATURES[name.split(":")[0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", choices=VARIANTS,
                        default=VARIANTS)
    names = parser.parse_args().variants
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "kernel_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir, names)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * std
                ).bfloat16()

    c = 16 * HEADS
    qkv = rn(1, N, 3 * c, std=1.5)
    ctx = torch.empty(1, N, c, dtype=torch.bfloat16, device="cuda")
    x = rn(1, H, W, C)
    wt = rn(9, C, 64, std=576 ** -0.5)
    bias = torch.zeros(64, device="cuda")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "global_mha": lambda lib: lib.tux_global_mha(
            qkv.data_ptr(), qkv[..., c:].data_ptr(),
            qkv[..., 2 * c:].data_ptr(), ctx.data_ptr(), 1, N, c, HEADS,
            qkv.stride(0), qkv.stride(1), 0, stream),
        "conv3x3": lambda lib: lib.tux_conv3x3_any(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), 1,
            H, W, C, C, 64, 64, 1, 0, stream),
    }

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
        kernel, variant = name.split(":")
        print(json.dumps({"device": smi, "kernel": kernel, "variant": variant,
                          "ms": ms(lambda: calls[kernel](lib))}), flush=True)


if __name__ == "__main__":
    main()
