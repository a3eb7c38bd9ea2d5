"""Where the time of ``global_mha``, the 3x3 conv, the fused conv + tail,
the two tails, the two int8 convs, conv1 and the window-attention core
goes, by ablation, on the GPU.

    python3 -m transformerupscaler_torch.kernel_ablation \
        [--variants global_mha:full conv3x3:no_store conv_tail7:full ...] \
        [--csrc DIR]

Builds ``csrc/global_mha.cu``, ``csrc/conv3x3.cu``, ``csrc/conv_tail.cu``
and ``csrc/tail_strip.cu`` (the int8 convs are forms of the kernels of
the second and the last) as they are and in variants with one part
switched off by a textual edit of the source or of a header it includes
(so the variants compute wrong values: only their times mean anything),
and times each kernel at its 720p serving shape by CUDA events over
back-to-back launches: the attention core at (1, 3600, 128) with 8 heads on
q, k, v sliced from one packed qkv; the 3x3 conv at (1, 720, 1280, 64) ->
64 with bias and ReLU, bf16 out (``conv3x3``: ``conv3x3_stream`` and the
archived conv) and int8 out (``conv3x3_int8_out``: ``conv3x3_stream``'s
``out_scale``); the int8 convs on a 720p int8 map, bf16 out: the 3x3 64
-> 64 with ReLU (``conv3x3_int8``) and the tails 64 -> 12, the 5x5 with
ReLU (``tail_int8_5``) and the 7x7 (``tail_int8_7``); the fused conv +
tail at x2 (co 12, npad 16), the encoder's 5x5 with ReLU emitting the
conv output (``conv_tail5``) and the decoder's 7x7 (``conv_tail7``); the
composed tail 64 -> 12 at x2, ``bench``'s 5x5 with ReLU (``tail_conv5``)
and ``xla_fold``'s 7x7 (``tail_conv7``), and the split tail, 5x5 64 -> 12
and 3x3 12 -> 12 in mode "off" (``tail_finish``); conv1 at (1, 720,
1280, 3) -> 64 with bias and ReLU (``conv1``); the window-attention core
at 60 windows, C = 128, 8 heads (``window_attn``), timed over a CUDA graph
of back-to-back launches, since one launch of it is shorter than the
host's launch rate. ``--csrc`` builds another tree's sources: a tree
before the strip tails holds them as ``conv_nhwc.cu`` and
``tail_finish.cu``, one before the TMA int8 convs as ``conv_int8.cu``,
timed under the same kernel names with their own variants; an older tree
holds the earlier designs of conv1 and the core under the same file names
(``EARLIER`` tells them apart by their text). A "no_*_refetch" / "no_halo_refill" / "no_ring_refill" variant
loads that operand only into the ring's first stages and reuses them
after. The variants named for what they do instead (``*_on_fma``,
``one_block_per_sm``, ``qs_in_smem``, ``emit_by_tail``, ``mid_ring_3``,
``*_wait_backoff``, ``deep_ring``) are alternatives that were measured and
not kept; ``--rounds`` times every variant again, in turns.
Prints one JSON line per variant; the difference from its kernel's
``full`` is what the part costs where it is not hidden behind another.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels import stream as S

N, HEADS, H, W, C, REPS = 3600, 8, 720, 1280, 64, 50
NW = 60  # windows of 64 tokens in WindowTransformer's 720p frame

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


# The strip kernels' output store (csrc/strip.cuh store_row), skipped.
NO_STORE = ("strip.cuh", "          if (oc < co) {",
            "          if (oc < co && W < 0) {")
CONV_MMA = "              S::wgmma_ss_n64(acc, desc_row("
TAIL_MMA = "S::wgmma_ss_kb<G::N>(D, desc_row(mrow"
ROWS = ("          S::mbar_expect_tx(&in_full[slot], ROW);\n"
        "          S::tma_load_4d(")
TAIL_WAIT = ("            S::wgmma_wait<0>();\n"
             "            release(&mid_empty[ms], lane);\n")
EMIT_BY_TAIL = """          if (feat != nullptr && grp == 0 && m >= sg.y0 && m < sg.y1) {
            bf16* frow = feat + (size_t(sg.b) * H + m) * W * 64;
            for (int c = tid - 128; c < G::OWN * 8; c += 128) {
              const int x = sg.x0 + (c >> 3);
              if (x < W)
                *reinterpret_cast<uint4*>(frow + size_t(x) * 64 +
                                          8 * (c & 7)) =
                    *reinterpret_cast<const uint4*>(
                        mrow + sw128(P + (c >> 3), c & 7));
            }
          }
"""
MID_FULL = "            S::mbar_wait(&mid_full[ms], par(mq, NM));\n"
MID_EMPTY = "          S::mbar_wait(&mid_empty[ms], par(mq, NM) ^ 1);\n"


def _backoff(wait: str) -> str:
    """An mbarrier wait that sleeps 100 ns after each failed poll."""
    bar, parity = wait.split("(", 1)[1].rsplit(");", 1)[0].split(", ", 1)
    return ("          for (uint32_t ok = 0; !ok;) {\n"
            "            asm volatile(\"{\\n.reg .pred p;\\n\"\n"
            "                \"mbarrier.try_wait.parity.shared::cta.b64 p, "
            "[%1], %2;\\n\"\n"
            "                \"selp.u32 %0, 1, 0, p;\\n}\\n\"\n"
            f"                : \"=r\"(ok) : \"r\"(S::smem({bar})), "
            f"\"r\"({parity}) : \"memory\");\n"
            "            if (!ok) __nanosleep(100);\n"
            "          }\n")


QUANT = """  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;"
      : "=r"(q)
      : "f"(fmaxf(__fmul_rn(v, qs), -127.f)));
  return int8_t(q);
"""
QS_LDG = ("          const float2 q2 = __ldg(reinterpret_cast<const float2*>(\n"
          "              qs + n0 + 8 * j + 2 * t));")


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
                    "          if (H < 0) S::wgmma_ss_n64(acc, desc_shift("),
                   ("            S::wgmma_i8_ss_n64(\n",
                    "            if (H < 0) S::wgmma_i8_ss_n64(\n")],
        "no_store": [("      if (y0 + wg < H) S::tma_store_4d(",
                      "      if (y0 + wg < H && H < 0) S::tma_store_4d(")],
        # The int8 epilogue's quantize replaced by a bit operation.
        "no_quant": [(QUANT, "  return int8_t(__float_as_int(v) ^ "
                             "__float_as_int(qs));\n")],
        # Tried: the int8 scales staged in shared memory once, not read
        # through L1 in every epilogue.
        "qs_in_smem": [(QS_LDG, "          const float2 q2 = qsm[4 * j + t];"),
                       ("  if (tid == 0) {\n    for (int s = 0; s < HSTAGES;",
                        "  __shared__ float2 qsm[32];\n"
                        "  if (I8 && tid < 32)\n"
                        "    qsm[tid] = reinterpret_cast<const float2*>(qs + "
                        "n0)[tid];\n"
                        "  if (tid == 0) {\n    for (int s = 0; s < HSTAGES;")],
    },
    "conv_tail": {
        "full": [],
        "no_mma": [(CONV_MMA, "              if (H < 0) " + CONV_MMA.lstrip()),
                   (TAIL_MMA, "if (H < 0) " + TAIL_MMA)],
        "no_conv_mma": [(CONV_MMA,
                         "              if (H < 0) " + CONV_MMA.lstrip())],
        "no_tail_mma": [(TAIL_MMA, "if (H < 0) " + TAIL_MMA)],
        # Input rows into the ring's first NS slots only.
        "no_halo_refill": [(ROWS, "          S::mbar_expect_tx(&in_full[slot], "
                                  "n < NS ? ROW : 0);\n"
                                  "          if (n < NS) S::tma_load_4d(")],
        "no_emit": [("              if (owned)\n",
                     "              if (owned && H < 0)\n")],
        "no_store": [NO_STORE],
        # Tried: the emit by the tail warpgroup, 16-byte copies of the owned
        # pixels from the mid row, off the conv warpgroup's path.
        "emit_by_tail": [("              if (owned)\n",
                          "              if (owned && H < 0)\n"),
                         (TAIL_WAIT, TAIL_WAIT + EMIT_BY_TAIL)],
        # Tried: the mid-ring waits back off with __nanosleep between polls.
        "tail_wait_backoff": [(MID_FULL, _backoff(MID_FULL))],
        "conv_wait_backoff": [(MID_EMPTY, _backoff(MID_EMPTY))],
        # Tried: three mid rows in flight where shared memory allows (k < 7).
        "mid_ring_3": [("  static constexpr int NM = 2;",
                        "  static constexpr int NM = KT < 7 ? 3 : 2;")],
    },
}
# csrc/tail_strip.cu: the composed tail's products, the split tail's mid and
# finish products (the finish's hi.hi: the only one of mode "off"), the
# consumers' waits for input rows.
STRIP_MMA = "S::wgmma_ss_kb<G::N>(D, desc_row(row"
MID_MMA = "S::wgmma_ss_kb<MN>("
FIN_HI = ("S::wgmma_ss_kb<FN>(D, desc_row(mrow, dx, s), desc_slab(wq, s),\n"
          "                             dx | s);")
I8_MMA = "S::wgmma_i8_ss_kb<G::N>("
EDITS["tail_strip"] = {
    "full": [],
    "no_mma": [(STRIP_MMA, "if (H < 0) " + STRIP_MMA),
               (I8_MMA, "if (H < 0) " + I8_MMA),
               (MID_MMA, "if (H < 0) " + MID_MMA),
               (FIN_HI, "if (H < 0) " + FIN_HI)],
    "no_mid_mma": [(MID_MMA, "if (H < 0) " + MID_MMA)],
    "no_finish": [(FIN_HI, "if (H < 0) " + FIN_HI)],
    # Input rows into the ring's first slots only: no consumer waits for
    # memory after the ring's first fill.
    "no_ring_refill": [
        ("          S::mbar_expect_tx(&in_full[slot], TROW);\n"
         "          S::tma_load_4d(",
         "          S::mbar_expect_tx(&in_full[slot], n < TNS ? TROW : 0);\n"
         "          if (n < TNS) S::tma_load_4d("),
        ("        S::mbar_expect_tx(&in_full[slot], TROW);\n"
         "        S::tma_load_4d(",
         "        S::mbar_expect_tx(&in_full[slot], n < NS ? TROW : 0);\n"
         "        if (n < NS) S::tma_load_4d(")],
    "no_store": [NO_STORE],
    # The two warpgroups issue their products as they come, not in turns.
    "no_turns": [(f"\n{ind}S::named_{op}({arg}, 256);  // {what}", "")
                 for ind in (" " * 12, " " * 10)
                 for op, arg, what in (("sync", "1 + c", "this warpgroup's turn"),
                                       ("arrive", "2 - c", "the other's turn"))],
    # Tried: deeper input rings (7 rows of the tail, 8 of the split tail).
    "deep_ring": [("static constexpr int TNS = I8 ? 8 : 4;",
                   "static constexpr int TNS = I8 ? 12 : 7;"),
                  ("(MAX_SMEM - fixed) / TROW < 6 ? (MAX_SMEM - fixed) / TROW : 6",
                   "(MAX_SMEM - fixed) / TROW < 8 ? (MAX_SMEM - fixed) / TROW : 8")],
}

# The tiled mma.sync tails of csrc/conv_nhwc.cu and csrc/tail_finish.cu,
# sources that trees before the strip tails hold (``--csrc``).
HALO_LOAD = "    if (iy >= 0 && iy < H && ix >= 0 && ix < W)"
TILE_STORE = ("    for (int e = tid; e < nv * co; e += THREADS) "
              "dst[e] = src[e];")
WROW = "      *reinterpret_cast<uint4*>(wsm + r * CS + chunk * 8) ="
TILE_EDITS = {
    "full": [],
    # Zeros into the halo instead of the input's loads.
    "no_halo": [(HALO_LOAD, "    if (H < 0)")],
    "no_weight_copy": [(WROW, "      if (H < 0) " + WROW.lstrip())],
    "no_store": [(TILE_STORE, "    if (H < 0) " + TILE_STORE.lstrip())],
}
FIN_MMA = ("          for (int f = 0; f < 2; ++f) {\n"
           "            tux::mma_bf16(acc2[f][j], ah[f][0],")
EDITS["conv_nhwc"] = dict(TILE_EDITS, no_mma=[(
    "            tux::mma_bf16(acc[f][j], a[f][0]",
    "            if (H < 0) tux::mma_bf16(acc[f][j], a[f][0]")])
# The tiled mma.sync int8 convs of csrc/conv_int8.cu (``--csrc``).
EDITS["conv_int8"] = dict(
    TILE_EDITS,
    no_weight_copy=[("      *reinterpret_cast<uint4*>(wsm + r * CSB + "
                     "chunk * 16) =",
                     "      if (H < 0) *reinterpret_cast<uint4*>(wsm + r * "
                     "CSB + chunk * 16) =")],
    no_mma=[("            tux::mma_s8(acc[f][j],",
             "            if (H < 0) tux::mma_s8(acc[f][j],")])
EDITS["tail_finish"] = dict(
    TILE_EDITS,
    no_mid_mma=[("            tux::mma_bf16(acc[i][j], a[i][0]",
                 "            if (H < 0) tux::mma_bf16(acc[i][j], a[i][0]")],
    no_finish_mma=[(FIN_MMA, FIN_MMA.replace("f < 2;", "f < 2 && H < 0;"))])

# conv1's earlier design: a tile of 8 x 32 pixels a block, the halo copied
# by scalar loads, an im2col operand in shared memory.
EDITS["conv1@im2col"] = {
    "full": [],
    # Zeros into the halo instead of the input's loads.
    "no_halo": [("    halo[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)",
                 "    halo[i] = (H < 0 && iy >= 0 && iy < H && ix >= 0 && "
                 "ix < W)")],
    "no_im2col": [("    a_sm[p * AS + k] = v;",
                   "    if (H < 0) a_sm[p * AS + k] = v;")],
    "no_products": [("        tux::mma_bf16(acc[f][j], a[f][0]",
                     "        if (H < 0) tux::mma_bf16(acc[f][j], a[f][0]")],
    "no_store": [("    if (y < H && xx < W)\n",
                  "    if (y < H && xx < W && H < 0)\n")],
}
# The window-attention core's earlier design: q, k, v copied through
# registers, the bias read from global memory after Q.K^T.
EDITS["window_attn@sync"] = {
    "full": [],
    "no_bias_load": [(
        "      const float2 ba = *reinterpret_cast<const float2*>(b0 + 8 * nf);\n"
        "      const float2 bb = *reinterpret_cast<const float2*>(b0 + 8 * NT "
        "+ 8 * nf);\n",
        "      const float2 ba = make_float2(0.f, 0.f), bb = ba;\n")],
    "no_products": [("      tux::mma_bf16(s[nf], aq[0]",
                     "      if (C < 0) tux::mma_bf16(s[nf], aq[0]"),
                    ("        tux::mma_bf16(ctx[j], ap[0]",
                     "        if (C < 0) tux::mma_bf16(ctx[j], ap[0]")],
    "no_store": [("    if (h0 + chunk / (HD / 8) < heads)\n",
                  "    if (h0 + chunk / (HD / 8) < heads && C < 0)\n")],
}
# csrc/conv1.cu: persistent blocks, a TMA halo ring, A
# fragments gathered from the halo, TMA-stored output.
EDITS["conv1"] = {
    "full": [],
    # The ring's mbarrier completes with no bytes: the halo stays as the
    # first loads left it.
    "no_halo": [("      S::mbar_expect_tx(&full[st], HALO_BYTES);\n"
                 "      S::tma_load_3d(",
                 "      S::mbar_expect_tx(&full[st], 0);\n"
                 "      if (H < 0) S::tma_load_3d(")],
    # The A fragments' shared-memory loads: the address bits instead.
    "no_gather": [("  return *reinterpret_cast<const uint16_t*>(p);",
                   "  return uint32_t(reinterpret_cast<uintptr_t>(p)) & "
                   "0xffffu;")],
    "no_products": [("          tux::mma_bf16(acc[f][j], a[f][kk][0]",
                     "          if (H < 0) tux::mma_bf16(acc[f][j], "
                     "a[f][kk][0]")],
    "no_store": [("      S::tma_store_4d(&omap,",
                  "      if (H < 0) S::tma_store_4d(&omap,")],
}
# csrc/window_attn.cu: every load issued at block start, TMA in, ldmatrix
# fragments, TMA store out.
EDITS["window_attn"] = {
    "full": [],
    # The bias copies skipped: the warp's barrier completes with no bytes.
    "no_bias_load": [
        ("  if (lane == 0) S::mbar_expect_tx(&bbar[warp], 16 * NT * 4);",
         "  if (lane == 0) S::mbar_expect_tx(&bbar[warp], 0);"),
        ("    bulk_load(wb + lane * BP,",
         "    if (C < 0) bulk_load(wb + lane * BP,")],
    "no_products": [("      tux::mma_bf16(s[2 * p + e],",
                     "      if (C < 0) tux::mma_bf16(s[2 * p + e],"),
                    ("      tux::mma_bf16(cx[j],",
                     "      if (C < 0) tux::mma_bf16(cx[j],")],
    "no_store": [("    S::tma_store_3d(&out_map,",
                  "    if (C < 0) S::tma_store_3d(&out_map,")],
}
# Sources whose earlier design has the same file name: source -> (text that
# only the earlier design holds, the key of its EDITS and SIGNATURES).
EARLIER = {"conv1": ("a_sm[p * AS + k] = v;", "conv1@im2col"),
           "window_attn": ("pack_raw(v0[0], v0[TS])", "window_attn@sync")}

# kernel -> the sources that may hold it, the first found in the source
# directory taken; the int8-out conv and both fused tails share the edits of
# their source.
SOURCES = {"global_mha": ("global_mha",), "conv3x3": ("conv3x3",),
           "conv3x3_int8_out": ("conv3x3",),
           "conv3x3_int8": ("conv_int8", "conv3x3"),
           "tail_int8_5": ("conv_int8", "tail_strip"),
           "tail_int8_7": ("conv_int8", "tail_strip"),
           "conv_tail5": ("conv_tail",),
           "conv_tail7": ("conv_tail",),
           "tail_conv5": ("tail_strip", "conv_nhwc"),
           "tail_conv7": ("tail_strip", "conv_nhwc"),
           "tail_finish": ("tail_strip", "tail_finish"),
           "conv1": ("conv1",), "window_attn": ("window_attn",)}
SKIP = {"conv3x3": ("qs_in_smem", "no_quant"),
        "conv3x3_int8_out": ("no_weight_refetch",),
        "conv3x3_int8": ("no_weight_refetch", "qs_in_smem", "no_quant"),
        "tail_int8_5": ("no_mid_mma", "no_finish"),
        "tail_int8_7": ("no_mid_mma", "no_finish"),
        "conv_tail7": ("no_emit", "emit_by_tail", "mid_ring_3"),
        "tail_conv5": ("no_mid_mma", "no_finish"),
        "tail_conv7": ("no_mid_mma", "no_finish")}
# The C functions of the sources that _build no longer lists.
SIGNATURES = {**_build.SIGNATURES,
              "conv_int8": {
                  "tux_conv3x3_int8": [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                  "tux_tail_conv_int8": [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 9 + [ctypes.c_void_p]},
              "conv_nhwc": {"tux_tail_conv": [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 9 + [ctypes.c_void_p]},
              "tail_finish": {"tux_tail_finish": [ctypes.c_void_p] * 6
                              + [ctypes.c_int] * 10 + [ctypes.c_void_p]},
              "conv1@im2col": {"tux_conv1": [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p]},
              "window_attn@sync": {"tux_window_attn": [ctypes.c_void_p] * 3
                                  + [ctypes.c_int] * 4 + [ctypes.c_void_p]}}
VARIANTS = sorted({f"{k}:{v}" for k, srcs in SOURCES.items() for src in srcs
                   for key in (src, EARLIER.get(src, (0, src))[1])
                   for v in EDITS[key] if v not in SKIP.get(k, ())})
# Kernels timed over a CUDA graph of REPS launches.
GRAPHED = ("window_attn",)


def source_of(kernel: str, csrc) -> str:
    """The first of the kernel's sources that ``csrc`` holds."""
    for src in SOURCES[kernel]:
        if (csrc / f"{src}.cu").exists():
            return src
    raise FileNotFoundError(f"{kernel}: none of {SOURCES[kernel]} in {csrc}")


def design_of(kernel: str, csrc) -> str:
    """The key of EDITS and SIGNATURES for the kernel's source in ``csrc``:
    its file stem, or the key of its earlier design (``EARLIER``)."""
    src = source_of(kernel, csrc)
    marker, key = EARLIER.get(src, (None, src))
    if marker is not None and marker in (csrc / f"{src}.cu").read_text():
        return key
    return src


def build(out_dir, names, csrc=_build.CSRC) -> dict[str, tuple]:
    """One library per ``kernel:variant`` name, all nvcc runs at once, from
    the sources in ``csrc``: name -> (library, its design's key)."""
    procs, srcs, keys = {}, {}, {}
    for name in names:
        kernel, variant = name.split(":")
        src = srcs[name] = source_of(kernel, csrc)
        key = keys[name] = design_of(kernel, csrc)
        if variant not in EDITS[key]:
            raise KeyError(f"{name}: {src}.cu ({key}) has no variant "
                           f"{variant}")
        vdir = out_dir / name.replace(":", "-")
        vdir.mkdir(parents=True, exist_ok=True)
        files = {f"{src}.cu": (csrc / f"{src}.cu").read_text()}
        for edit in EDITS[key][variant]:
            fname, old, new = edit if len(edit) == 3 else (f"{src}.cu",
                                                           *edit)
            if fname not in files:
                files[fname] = (csrc / fname).read_text()
            if files[fname].count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} does not stand once in "
                                   f"{fname}")
            files[fname] = files[fname].replace(old, new)
        for fname, text in files.items():  # an edited header shadows csrc's
            (vdir / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(vdir / "lib.so"), str(vdir / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out_dir / name.replace(":", "-") / "lib.so"))
        for fn, argtypes in SIGNATURES[keys[name]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, keys[name])
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", choices=VARIANTS,
                        help="default: every variant of the sources found")
    parser.add_argument("--rounds", type=int, default=1,
                        help="time every variant this many times, in turns")
    parser.add_argument("--csrc", type=Path, default=_build.CSRC,
                        help="the CUDA sources to build (another tree's "
                             "csrc/ to time its kernels)")
    args = parser.parse_args()
    csrc = args.csrc.resolve()
    names = args.variants or [
        v for v in VARIANTS if any((csrc / f"{src}.cu").exists()
                                   for src in SOURCES[v.split(":")[0]])
        and v.split(":")[1] in EDITS[design_of(v.split(":")[0], csrc)]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "kernel_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir, names, csrc)
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
    qs = torch.full((64,), 20.0, device="cuda")
    out = torch.empty_like(x)
    out8 = torch.empty(1, H, W, 64, dtype=torch.int8, device="cuda")
    tails = {k: (rn(k * k * 16, 64, std=(k * k * 64) ** -0.5),
                 torch.empty(1, H, W, 12, dtype=torch.bfloat16,
                             device="cuda")) for k in (5, 7)}
    bt = torch.zeros(12, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # The tails' weights in either tree's layout (as many elements or more):
    # the 5x5 mid (25 x 16 rows of 64), the finish's (18 x 16 rows of 64).
    wmid = rn(25 * 16, 64, std=1600 ** -0.5)
    wfin = rn(18 * 16, 64, std=0.1)
    y12 = torch.empty(1, H, W, 12, dtype=torch.bfloat16, device="cuda")
    # The int8 convs: an int8 map, int8 weights in either tree's layout (the
    # same sizes), scales near those of a folded kernel.
    xq = torch.randint(-127, 128, (1, H, W, C), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = {k: torch.randint(-127, 128, (k * k * (64 if k == 3 else 16), 64),
                           generator=g, device="cuda", dtype=torch.int8)
          for k in (3, 5, 7)}
    ksq = torch.full((64,), 1e-4, device="cuda")

    # conv1: an RGB frame in [0, 1), HWIO weights, an f32 bias. The earlier
    # design takes the weights as a (64, 32) slab and the bias in f32
    # holding bf16 values; the current one the HWIO weights, the bias and
    # the host's tap table as they are.
    img = torch.rand(1, H, W, 3, generator=g, device="cuda").bfloat16()
    k1 = rn(3, 3, 3, 64, std=27 ** -0.5)
    b1 = rn(64, std=0.1).float()
    slab = torch.zeros(64, 32, dtype=torch.bfloat16, device="cuda")
    slab[:, :27] = k1.reshape(27, 64).t()
    taps = (ctypes.c_int * 32)(*S.conv1_taps())

    def conv1(lib, key):
        if key == "conv1@im2col":
            return lib.tux_conv1(img.data_ptr(), slab.data_ptr(),
                                 b1.data_ptr(), out.data_ptr(), 1, H, W, 1,
                                 0, stream)
        return lib.tux_conv1(img.data_ptr(), k1.data_ptr(), b1.data_ptr(),
                             out.data_ptr(), ctypes.addressof(taps), 1, H, W,
                             1, 0, 1, 0, stream)

    # The window-attention core on WindowTransformer's 720p frame.
    wqkv = rn(NW, 64, 3 * c)
    wbias = torch.randn(HEADS, 64, 64, generator=g, device="cuda") * 0.5
    wctx = torch.empty(NW, 64, c, dtype=torch.bfloat16, device="cuda")

    def tail_i8(lib, k):
        return lib.tux_tail_conv_int8(
            xq.data_ptr(), wq[k].data_ptr(), ksq.data_ptr(), bt.data_ptr(),
            y12.data_ptr(), 1, H, W, k, 12, 16, int(k == 5), 0, 0, stream)

    def tail(lib, k, emit):
        slabs, y = tails[k]
        return lib.tux_conv_tail(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(), slabs.data_ptr(),
            bt.data_ptr(), y.data_ptr(), out.data_ptr() if emit else None, 1,
            H, W, k, 12, 16, int(emit), 0, 0, stream)

    calls = {
        "global_mha": lambda lib, key: lib.tux_global_mha(
            qkv.data_ptr(), qkv[..., c:].data_ptr(),
            qkv[..., 2 * c:].data_ptr(), ctx.data_ptr(), 1, N, c, HEADS,
            qkv.stride(0), qkv.stride(1), 0, stream),
        "conv3x3": lambda lib, key: lib.tux_conv3x3_any(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(), None,
            out.data_ptr(), 1, H, W, C, C, 64, 64, 1, 0, stream),
        "conv3x3_int8_out": lambda lib, key: lib.tux_conv3x3_any(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(), qs.data_ptr(),
            out8.data_ptr(), 1, H, W, C, C, 64, 64, 1, 0, stream),
        "conv3x3_int8": lambda lib, key: lib.tux_conv3x3_int8(
            xq.data_ptr(), wq[3].data_ptr(), ksq.data_ptr(), bias.data_ptr(),
            out.data_ptr(), 1, H, W, 1, 0, 0, stream),
        "tail_int8_5": lambda lib, key: tail_i8(lib, 5),
        "tail_int8_7": lambda lib, key: tail_i8(lib, 7),
        "conv_tail5": lambda lib, key: tail(lib, 5, True),
        "conv_tail7": lambda lib, key: tail(lib, 7, False),
        # The serving tails at x2 (co 12, npad 16): bench's branch-A 5x5
        # with ReLU, xla_fold's 7x7, the split tail in mode "off".
        "tail_conv5": lambda lib, key: lib.tux_tail_conv(
            x.data_ptr(), tails[5][0].data_ptr(), bt.data_ptr(),
            y12.data_ptr(), 1, H, W, 5, 12, 16, 1, 0, 0, stream),
        "tail_conv7": lambda lib, key: lib.tux_tail_conv(
            x.data_ptr(), tails[7][0].data_ptr(), bt.data_ptr(),
            y12.data_ptr(), 1, H, W, 7, 12, 16, 0, 0, 0, stream),
        "tail_finish": lambda lib, key: lib.tux_tail_finish(
            x.data_ptr(), wmid.data_ptr(), bt.data_ptr(), wfin.data_ptr(),
            bt.data_ptr(), y12.data_ptr(), 1, H, W, 12, 16, 12, 16, 0, 0, 0,
            stream),
        "conv1": conv1,
        # The core reads the stream when it is called: a graph captures on
        # a stream of its own.
        "window_attn": lambda lib, key: lib.tux_window_attn(
            wqkv.data_ptr(), wbias.data_ptr(), wctx.data_ptr(), NW, c, HEADS,
            0, torch.cuda.current_stream().cuda_stream),
    }

    def ms(call, graphed=False) -> float:
        def run():
            err = call()
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        if graphed:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(REPS):
                    run()
            graph.replay()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if graphed:
            graph.replay()
        else:
            for _ in range(REPS):
                run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    for rnd in range(args.rounds):
        for name, (lib, key) in libs.items():
            kernel, variant = name.split(":")
            print(json.dumps({"device": smi, "kernel": kernel,
                              "variant": variant, "design": key,
                              "round": rnd,
                              "ms": ms(lambda: calls[kernel](lib, key),
                                       kernel in GRAPHED)}),
                  flush=True)


if __name__ == "__main__":
    main()
