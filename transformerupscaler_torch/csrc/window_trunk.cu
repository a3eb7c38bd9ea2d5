// Fused window-transformer trunk for Hopper (sm_90a): every window block of
// the model in one kernel launch, on windows of 64 tokens.
//
// Replaces transformerupscaler_tpu/ops/pallas/trunk2.py:524
// fused_window_trunk_v2 and transformerupscaler_tpu/ops/pallas/trunk.py:128
// fused_window_trunk. The first has five kernel bodies (_trunk2_kernel :51,
// _trunk2_pair_kernel :105, _trunk2_pair_chunked_kernel :255,
// _trunk2_group_kernel :335, _trunk2_pair_truedot_kernel :432) which tile one
// arithmetic in five ways to fill 128-lane MXU tiles (head masks, window
// pairing, block-diagonal key matrices, a ones-matmul softmax denominator,
// padding of the window count). None of that is carried over: this source
// computes per-head products directly and answers for all of them, at model
// width C = 128 (8 heads) or 192 (12 heads), in four modes chosen at compile
// time (the int8 modes at C = 192).
//
// Per layer, on a window x (64 x C, bf16), with every rounding point of
// _trunk2_pair_kernel (trunk2.py:187-252):
//   y   = LN(x)            f32 mean, var = E[x^2] - mean^2, eps 1e-5, f32
//                          affine from bf16 scale and shift, one rounding
//   qkv = bf16(y Wqkv) + b the f32 sum rounded to bf16, then the bf16 bias
//                          added in bf16 (a second rounding); same for proj,
//                          fc1 and fc2
//   s   = (q/4) k^T + bias per head (16 dims), f32; the relative-position
//                          bias is f32. The reference scales q by 0.25 in
//                          bf16, which is exact, so scaling the f32 sum by
//                          0.25 gives the same number
//   p   = softmax(s)       f32, per window and head, rounded to bf16
//   ctx = bf16(p v)        f32 accumulation
//   x   = x + (bf16(ctx Wproj) + b)                        adds in bf16
//   h   = gelu(bf16(LN(x) Wfc1) + b)   0.5 h (1 + erf(h / sqrt 2)) in f32,
//                                      one rounding; erf within 2 ulp
//                                      (erf_branchless; the int8 modes'
//                                      gelu_i8 forms 1 + erf from its
//                                      fits without cancellation)
//   x   = x + (bf16(h Wfc2) + b)
// The modes:
//   V2    as above (trunk2.py:237-240, 247-250).
//   V1    trunk.py:109, 114-115: the residual adds associate the other way,
//         x = bf16(bf16(x + bf16(ctx Wproj)) + b), and so for fc2: three
//         roundings where V2 has three in another order.
//   INT8  V2 with the four GEMMs as int8 x int8 -> int32 (trunk2.py:165-181,
//         int8_gemms="rowwise"): per token row of the bf16 GEMM input,
//         srow = max(max|a_row|, 1e-6) * (1/127), aq = round_half_even(a *
//         (1/srow)); weights arrive quantized per output channel with f32
//         scales sw; the product is (float(acc) * srow) * sw, then rounded to
//         bf16 and the bias added as above. Attention stays bf16 / f32.
//   INT8_STATIC  INT8 with the static per-channel scales of the reference's
//         int8_gemms=True (trunk2.py:182-185): each element of a GEMM input is
//         quantized with its column's calibrated inverse scale ia (iapack),
//         aq = clip(round_half_even(a * ia), -127, 127); no row maximum, no
//         row scales. The scales are folded into the int8 weights, whose f32
//         scales sw arrive as in INT8; the product is float(acc) * sw.
//
// One design for every mode (window_trunk_kernel): TMA + wgmma. A block
// holds two windows, one a consumer warpgroup (rows 16 w .. 16 w + 15 of a
// window to warp w), and a producer warpgroup: one thread of it issues the
// copies, and setmaxnreg moves its registers to the consumers (24 and 240 a
// thread). Both windows take every weight slab from one ring, so the
// weights cross L2 once for two windows, and one window's LayerNorm,
// softmax and epilogues overlap the other's products. The
// weights arrive re-cut (kernels/trunk2.py ``_pack_slabs``) into slabs of
// C rows x 64 elements (bf16: C x 128 B, the 128B swizzle; int8: C x 64 B,
// the 64B swizzle), each one TMA box, in the order the products consume
// them:
//   per head group of 64 channels (4 heads): k, v and q, each an N = 64
//     output chunk as C/64 K-major tiles [64 outputs][64 inputs]
//     (wgmma m64n64, A = the LN output from shared memory), then proj's
//     rows of those 64 input channels, a K-major [C outputs][64 inputs]
//     (wgmma m64nC, A = the group's attention context from registers,
//     accumulated over the groups: the one product's sum in another
//     order, rounded once);
//   per hidden chunk of 64: fc1's N = 64 chunk, then fc2's [C][64] rows
//     (A = GELU of the fc1 chunk from registers, the fc2 sum over all
//     chunks, rounded once). The 64 x 4C hidden never exists.
// The k and v chunks go to shared memory for the group's attention; q
// stays in registers as the mma.sync A fragments of Q.K^T. Attention runs
// per warp on its 16 query rows (mma.sync m16n8k16: 16 x 64 scores in
// registers, quad shuffles for the row statistics, P.V from the score
// registers; the relative-position bias from the head's 225-entry table
// through L1). The epilogues round in bf16x2 adds (dense2, residual2: the
// same two roundings), read a layer's vectors from shared memory, and
// load a group of values before they store any (the compiler cannot move
// a load past a store that might alias it); GELU's erf is branch-free, so
// a warp's evaluations interleave. The producer keeps STAGES slabs in
// flight behind full / empty mbarriers; no block-wide barrier after the
// start, only one over a warpgroup where its LN output or k / v rows are
// read by all its warps. Each warpgroup waits for its products before its
// epilogue (issuing the next products first made ptxas wait for them at
// every branch), so a window's time is its products' latency plus its
// epilogues, and the tensor pipe is about a quarter busy (PERF.md).
//
// The int8 modes (C = 192) run the same schedule on wgmma m64nNk32 with
// s8 operands and s32 accumulators, which 8-bit types allow only K-major:
// the LN output is quantized inside LayerNorm into C/64 K-major int8 tiles
// in the 64B swizzle (the SS products' A); each accumulator is dequantized
// (dequant: the f32 products above) before v2's epilogues; the proj and
// fc2 inputs are quantized in registers into s8 A fragments. A k32
// fragment holds a thread's values of a row at K slots 4t..4t+3 and
// 16+4t..16+4t+3; an f32 accumulator holds columns 8j + 2t, +1, and
// attention's context fragments dims 2t, 2t+1, 8+2t, 9+2t of a head. They
// go into the slots in that order (to_frags_i8, ctx_frags_i8), and the
// host packs proj's and fc2's weight rows in the same K order (trunk2.py
// K_PERM): the int32 sum is the same set of products, exact in any order.
//   INT8_STATIC needs no row maximum: it quantizes each head group's
//     context and each GELU chunk with the columns' ia and accumulates proj
//     and fc2 across groups and chunks, exactly as v2 does.
//   INT8 needs each GEMM input's whole row first. LayerNorm has it. The
//     context of every head group stays in registers (48 of bf16 pairs)
//     until the last group; then the row maximum (the thread's values and
//     two quad shuffles), the quantize, and proj over K = C: proj's slabs
//     follow all of qkv's. The GELU output (4C a row) needs fc1 twice: a
//     first pass over the fc1 chunks finds each row's largest |h| and
//     keeps nothing, the second recomputes each chunk (dequant's multiplies
//     round each step, so the two agree bit for bit), quantizes it with the
//     row's scale and feeds fc2. Its slab stream carries fc1 twice: 48
//     slabs a layer, not 36. The first pass evaluates GELU at three
//     pre-activations a row, not 768: the int8 modes' GELU (gelu_i8) is
//     formed so that its bf16 values are monotone on each side of its
//     minimum (the tests check every bf16 input), so the largest |h| is
//     at the largest pre-activation, the largest <= GELU_TURN or the
//     smallest above it.
// The int8 weight scales sw (9C a layer) and static inverse activation
// scales ia (7C) are read through L1.
// Shared memory at C = 192 (C = 128), bytes:
//   ring         bf16: 3 x 24,576 = 73,728 (6 x 16,384 = 98,304); int8:
//                6 x 12,288 = 73,728
//   per window   LN output as the A operand, C/64 swizzled tiles of 64
//                rows: bf16 24,576 (16,384), int8 12,288; residual x, row
//                stride C + 8: 25,600 (17,408); k and v of one head group,
//                row stride 72: 18,432 (18,432); bf16 68,608 (52,224), int8
//                56,320; two windows 137,216 (104,448), int8 112,640
//   vectors      a layer's LN scales, shifts and biases (13 C bf16), two
//                layers a window: 19,968 (13,312)
//   barriers     2 x STAGES x 8 = 48 (96), int8 96; 1,024 to align the ring
//   total        231,984 (217,184), int8 207,456 of 232,448.
// Windows a block: one while the windows fit on the SMs one a block, else
// two (240 windows: 120 blocks, one wave); a block whose second window is
// past the end runs one consumer warpgroup.
//
// Bound on the H100 at 240 windows x 6 layers, C = 192: 86.1 G operations,
// 0.087 ms at 989 TF/s in bf16; with the GEMMs at the int8 rate 0.046 ms.
// x, out, weights and tables are ~13 MB, 0.004 ms. The weights cross L2
// once for two windows (0.64 GB a frame in bf16, 0.32 GB in int8; 0.43 GB
// in INT8, which reads fc1 twice), the relative-position bias as its
// 225-entry tables through L1.
// WindowTransformer's 720p frame is 60 windows: one a block on 60 SMs.
#include "common.cuh"
#include "sm90.cuh"

#include <math.h>

#include <type_traits>


namespace {

constexpr int NT = 64;       // tokens per window
constexpr int HD = 16;       // head width
enum Mode { V2 = 0, V1 = 1, INT8 = 2, INT8_STATIC = 3 };

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
namespace S = tux::sm90;

// Offsets into a layer's packed vectors (bf16 elements): ln1s, ln1b, qkvb,
// projb, ln2s, ln2b, fc1b, fc2b side by side.
template <int C>
struct Vec {
  static constexpr int LN1S = 0, LN1B = C, QKVB = 2 * C, PROJB = 5 * C,
                       LN2S = 6 * C, LN2B = 7 * C, FC1B = 8 * C,
                       FC2B = 12 * C, SIZE = 13 * C;
};

// Two floats rounded to bf16 and widened again; the packed conversion is one
// instruction for both.
__device__ __forceinline__ float2 round_bf16(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The same roundings in bf16x2 arithmetic: a bf16 add of two bf16 values,
// rounded once, equals their f32 sum rounded to bf16 (where the exponents
// differ by 16 or more the smaller is under 2^-8 of the larger's step and
// both give the larger; else the f32 sum is exact).
__device__ __forceinline__ bf162 dense2(float v0, float v1, bf162 bias) {
  return __hadd2(__floats2bfloat162_rn(v0, v1), bias);
}

// x + product + bias in the mode's association.
template <int MODE>
__device__ __forceinline__ bf162 residual2(bf162 x, float v0, float v1,
                                           bf162 bias) {
  if constexpr (MODE == V1)
    return __hadd2(__hadd2(x, __floats2bfloat162_rn(v0, v1)), bias);
  else
    return __hadd2(x, dense2(v0, v1, bias));
}

__device__ __forceinline__ bf162 ld_b2(const bf16* p) {
  return *reinterpret_cast<const bf162*>(p);
}
__device__ __forceinline__ uint32_t as_u32(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// erf without a branch, so that a warp's 32 evaluations interleave (and a
// product may stay in flight across them): |x| <= 1, x + x q(x^2); beyond,
// 1 - 2^(r(t) - t^2 log2 e) at t = min(|x|, 4) (erf rounds to 1 from 3.92),
// with the sign of x. q and r are least-squares fits on Chebyshev nodes;
// within 1.08 and 1.07 ulp of erf evaluated in f32 with fma, plus
// ex2.approx's 2^-22 relative error on the 2^(...) <= 0.16 term
// (tests/test_torch_trunk_erf.py holds them to 2 ulp). erff is within 2.
__device__ constexpr float ERF_Q[] = {
    0.12837916612625122f,   -0.3761262595653534f,   0.11283597350120544f,
    -0.02685432881116867f,  0.005189312156289816f,  -0.0008018855005502701f,
    7.882497448008507e-05f};
__device__ constexpr float ERF_R[] = {
    0.00043744384311139584f, -1.6304858922958374f,    0.5310025215148926f,
    -0.15866507589817047f,   0.038036245852708817f,   -0.006838695146143436f,
    0.000855185673572123f,   -6.577336171176285e-05f, 2.328598611711641e-06f};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// erf(x) for |x| <= 1.
__device__ __forceinline__ float erf_near(float x) {
  const float s = x * x;
  float q = ERF_Q[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) q = fmaf(q, s, ERF_Q[k]);
  return fmaf(q, x, x);
}
// erfc(u) for 1 <= u <= 4.
__device__ __forceinline__ float erfc_far(float u) {
  float r = ERF_R[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) r = fmaf(r, u, ERF_R[k]);
  return ex2_approx(fmaf(-(u * u), 1.4426950408889634f, r));
}

__device__ __forceinline__ float erf_branchless(float x) {
  const float t = fabsf(x);
  const float near = erf_near(x);
  const float far = 1.0f - erfc_far(fminf(t, 4.0f));
  return t <= 1.0f ? near : copysignf(far, x);
}

// The exact (erf) GELU, 0.5 h (1 + erf(h / sqrt 2)), in f32.
__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.0f + erf_branchless(h * 0.70710678118654752f));
}

// The int8 modes' GELU: the same fits, with 1 + erf formed without
// cancellation (erfc_far itself below x = -1, 0 below x = -4, where erfc <
// 2e-8) and 2 - erfc above 1. Its bf16 values never fall on h >= 0, and
// their magnitude rises on h <= GELU_TURN and falls on GELU_TURN < h < 0
// (GELU's minimum is at -0.7518), for every bf16 h (tests/
// test_torch_trunk_erf.py, emulated; tests/test_torch_gpu.py on the card):
// over a row, the largest |bf16(gelu_i8(h))| is at one of three h. No
// a * b + c is left for the compiler to contract, so every call gives the
// same bits. Its selects are selp instructions: as C++ conditionals the
// compiler branched around erfc_far, and a warp's evaluations diverged.
constexpr float GELU_TURN = -0.75f;
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nselp.f32 %0, %1, %2, q;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(uint32_t(p)));
  return r;
}
__device__ __forceinline__ float gelu_i8(float h) {
  const float x = h * 0.70710678118654752f;
  const float t = fabsf(x);
  const float e = select(t < 4.0f, erfc_far(fminf(t, 4.0f)), 0.0f);
  const float one_plus_erf = select(t <= 1.0f, 1.0f + erf_near(x),
                                    select(x > 0.0f, 2.0f - e, e));
  return 0.5f * h * one_plus_erf;
}

// The LayerNorm of R rows of C values, two a lane at columns 2 lane + 64 j
// (j < C / 64), rounded to bf16 in place: f32 mean and E[x^2] - mean^2 over
// the warp, eps 1e-5, the affine in f32 from the lane's scale and shift
// pairs. The rows' reductions interleave.
template <int C, int R>
__device__ __forceinline__ void layernorm_rows(float2 (&v)[R][C / 64],
                                               const float2 (&sc)[C / 64],
                                               const float2 (&sh)[C / 64]) {
  constexpr int P = C / 64;
  float s[R], ss[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = ss[r] = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      s[r] += v[r][j].x + v[r][j].y;
      ss[r] += v[r][j].x * v[r][j].x + v[r][j].y * v[r][j].y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], o);
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mu = s[r] / float(C);
    const float var = ss[r] / float(C) - mu * mu;
    const float rstd = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int j = 0; j < P; ++j)
      v[r][j] = round_bf16((v[r][j].x - mu) * rstd * sc[j].x + sh[j].x,
                           (v[r][j].y - mu) * rstd * sc[j].y + sh[j].y);
  }
}

// The lane's LayerNorm scale and shift pairs (columns 2 lane + 64 j).
template <int C>
__device__ __forceinline__ void ln_params(float2 (&sc)[C / 64],
                                          float2 (&sh)[C / 64],
                                          const bf16* scale,
                                          const bf16* shift, int lane) {
#pragma unroll
  for (int j = 0; j < C / 64; ++j) {
    sc[j] = ld2(scale + 2 * lane + 64 * j);
    sh[j] = ld2(shift + 2 * lane + 64 * j);
  }
}

// ============================================================ TMA + wgmma
constexpr int WG = 2;                  // consumer warpgroups = windows
// And a producer warpgroup, so that setmaxnreg can move registers: at 12
// warps a block ptxas allots 168 a thread; the producer gives back all but
// 24 and the consumers take 240 (2 x 240 + 24 = 3 x 168 on each
// sub-partition).
constexpr int W_THREADS = WG * 128 + 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int KS = 72;                 // k / v row stride (elements)
constexpr int TAB = 225;               // relative offsets of an 8 x 8 window

template <int C_, int MODE_>
struct WCfg {
  static constexpr int C = C_;
  static constexpr int MODE = MODE_;
  static constexpr bool I8 = MODE == INT8 || MODE == INT8_STATIC;
  static constexpr bool ROWS = MODE == INT8;  // per-row activation scales
  static constexpr int HEADS = C / HD;
  static constexpr int GROUPS = C / 64;  // head groups of 64 channels
  static constexpr int CHUNKS = 4 * C / 64;
  static constexpr int KT = C / 64;      // 64-wide K tiles of an N = 64 slab
  // 12 C / 64 slabs a layer; INT8 streams fc1's twice.
  static constexpr int SLABS = 4 * GROUPS + 2 * CHUNKS + (ROWS ? CHUNKS : 0);
  static constexpr int EL = I8 ? 1 : 2;  // bytes a weight / A element
  static constexpr int TILE = 64 * 64 * EL;  // a K-major [64][64] tile
  static constexpr int STAGE = C * 64 * EL;  // one slab: C rows of 64
  static constexpr int STAGES = I8 ? 6 : C == 192 ? 3 : 6;
  static constexpr int XS = C + 8;       // residual row stride (elements)
  static constexpr int A_BYTES = KT * TILE;
  static constexpr int X_BYTES = NT * XS * 2;
  static constexpr int KV_BYTES = NT * KS * 2;
  static constexpr int WIN = A_BYTES + X_BYTES + 2 * KV_BYTES;
  static constexpr int VEC_BYTES = 13 * C * 2;  // a layer's vectors
  static constexpr int BYTES = 1024 + STAGES * STAGE + WG * WIN +
                               WG * 2 * VEC_BYTES + 2 * STAGES * 8;
  static_assert(WIN % 1024 == 0, "window regions keep 1024-byte alignment");
  static_assert(!I8 || C == 192, "the int8 modes run at C = 192");
};

// Offsets into a layer's int8 weight scales sw (f32; qkv, proj, fc1, fc2
// side by side) and static inverse activation scales ia (f32; the inputs
// of qkv, proj, fc1, fc2).
template <int C>
struct Scales {
  static constexpr int S_QKV = 0, S_PROJ = 3 * C, S_FC1 = 4 * C,
                       S_FC2 = 8 * C, SW = 9 * C;
  static constexpr int I_QKV = 0, I_PROJ = C, I_FC1 = 2 * C, I_FC2 = 3 * C,
                       IA = 7 * C;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Byte offset of (row r, column c, even) in the LN output: C / 64 K-major
// tiles of 64 rows x 128 B, 16-byte chunks XORed with r % 8 (the 128B
// swizzle, as TMA would have written it).
__device__ __forceinline__ int a_offset(int r, int c) {
  return (c >> 6) * 8192 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// Each warp's 16 rows of the window, four at a time: LN of the residual x
// into the A tile.
template <int C>
__device__ __forceinline__ void layernorm_to_a(const bf16* xs,
                                               unsigned char* a,
                                               const bf16* scale,
                                               const bf16* shift, int warp,
                                               int lane) {
  constexpr int XS = C + 8, P = C / 64;
  float2 sc[P], sh[P];
  ln_params<C>(sc, sh, scale, shift, lane);
#pragma unroll 1
  for (int r0 = 16 * warp; r0 < 16 * warp + 16; r0 += 4) {
    float2 v[4][P];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < P; ++j)
        v[r][j] = ld2(xs + (r0 + r) * XS + 2 * lane + 64 * j);
    layernorm_rows<C, 4>(v, sc, sh);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < P; ++j)
        *reinterpret_cast<uint32_t*>(
            a + a_offset(r0 + r, 2 * lane + 64 * j)) =
            pack2(v[r][j].x, v[r][j].y);
  }
}

// The ring as one consumer warpgroup walks it: slab n in stage n % STAGES.
template <int STAGES>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes;
  int next;  // the next slab a product takes

  __device__ __forceinline__ const unsigned char* slab(int n) const {
    return base + (n % STAGES) * stage_bytes;
  }
  // Until slab n has landed.
  __device__ __forceinline__ void wait_full(int n) {
    S::mbar_wait(&full[n % STAGES], (n / STAGES) & 1);
  }
  // After this warp's products on slab n have completed.
  __device__ __forceinline__ void release(int n, int lane) {
    __syncwarp();
    if (lane == 0) S::mbar_arrive(&empty[n % STAGES]);
  }
};

// acc = A tile . the next slab, one N = 64 output chunk (the slab: KT
// K-major tiles of [64 outputs][64 inputs]).
template <class K, class R>
__device__ __forceinline__ void chunk64(float (&acc)[32], R& ring,
                                        const unsigned char* a, int lane) {
  const int n = ring.next++;
  ring.wait_full(n);
  const unsigned char* w = ring.slab(n);
  S::wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < K::KT; ++kt)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      S::wgmma_ss_kb<64>(acc, S::desc_a(a + kt * 8192, s),
                         S::desc_a(w + kt * 8192, s), kt | s);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(acc);
  ring.release(n, lane);
}

// acc (+)= frag[0..3] . the next slab, its 64 inputs of [C outputs][64
// inputs] as four k16 steps with A from registers; the first product of
// an accumulation passes ``first``.
template <class K, class R>
__device__ __forceinline__ void rows64(float (&acc)[K::C / 2],
                                       const uint32_t (&frag)[4][4],
                                       R& ring, bool first, int lane) {
  const int n = ring.next++;
  ring.wait_full(n);
  const unsigned char* w = ring.slab(n);
  S::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    S::wgmma_rs_kb<K::C>(acc, frag[s], S::desc_a(w, s), first ? s : 1);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(acc);
  ring.release(n, lane);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3},"
      " [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Attention of one head on this warp's 16 query rows: q the head's A
// fragment (rows 16 warp + g (+8), dims 2t.. (+8)), k and v rows in
// shared memory (row stride KS, this head's 16 dims at column 16 hh),
// tab_h the head's relative-position table (225 f32; the bias of tokens i
// = 8 yi + xi and j = 8 yj + xj is tab_h[(yi - yj + 7) 15 + xi - xj + 7],
// read through L1, where the 0.9 KB tables of a layer stay). Returns the
// context as the A fragment of the proj product (the same rows, the
// head's dims as K).
__device__ __forceinline__ void attend(uint32_t (&ctx_a)[4],
                                       const uint32_t (&q)[4],
                                       const bf16* kb, const bf16* vb,
                                       int hh, const float* tab_h, int warp,
                                       int g, int t) {
  // ldmatrix rows of this lane: matrix lane / 8 of four, row lane % 8. For
  // k: keys 8 nf + lane % 8 of the pair (nf, nf + 1) by lane / 16, dims
  // 0-7 / 8-15 by (lane / 8) % 2, giving B[nf][0..1], B[nf + 1][0..1]. For
  // v (transposed): keys 16 kk + lane % 8 (+8 by (lane / 8) % 2), dims 0-7
  // / 8-15 by lane / 16, giving the B fragments of both 8-dim blocks.
  const int lane = 4 * g + t;
  const int lrow = lane & 7, lsel = (lane >> 3) & 1, lhi = lane >> 4;
  const uint32_t k_lane =
      S::smem(kb + (8 * lhi + lrow) * KS + HD * hh + 8 * lsel);
  const uint32_t v_lane =
      S::smem(vb + (8 * lsel + lrow) * KS + HD * hh + 8 * lhi);
  float s[8][4];
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bk[4];
    ldsm_x4(bk, k_lane + np * 16 * KS * 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float (&sc)[4] = s[2 * np + h];
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = 0.f;
      tux::mma_bf16(sc, q[0], q[1], q[2], q[3], bk[2 * h], bk[2 * h + 1]);
    }
  }
  // Rows r0 = 16 warp + g (yi = 2 warp, xi = g; elements 0, 1) and r0 + 8
  // (yi + 1; elements 2, 3); keys 8 nf + 2 t (+1): yj = nf, xj = 2 t (+1).
  const float* tb = tab_h + (2 * warp + 7) * 15 + g - 2 * t + 7;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
    const float* p = tb - 15 * nf;
    s[nf][0] = s[nf][0] * 0.25f + __ldg(p);
    s[nf][1] = s[nf][1] * 0.25f + __ldg(p - 1);
    s[nf][2] = s[nf][2] * 0.25f + __ldg(p + 15);
    s[nf][3] = s[nf][3] * 0.25f + __ldg(p + 14);
    m0 = fmaxf(m0, fmaxf(s[nf][0], s[nf][1]));
    m1 = fmaxf(m1, fmaxf(s[nf][2], s[nf][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
    s[nf][0] = __expf(s[nf][0] - m0);
    s[nf][1] = __expf(s[nf][1] - m0);
    s[nf][2] = __expf(s[nf][2] - m1);
    s[nf][3] = __expf(s[nf][3] - m1);
    d0 += s[nf][0] + s[nf][1];
    d1 += s[nf][2] + s[nf][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }
  d0 = 1.0f / d0;
  d1 = 1.0f / d1;
  float ctx[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ctx[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // Two adjacent score fragments are one A fragment of 16 keys.
    uint32_t ap[4];
    ap[0] = pack2(s[2 * kk][0] * d0, s[2 * kk][1] * d0);
    ap[1] = pack2(s[2 * kk][2] * d1, s[2 * kk][3] * d1);
    ap[2] = pack2(s[2 * kk + 1][0] * d0, s[2 * kk + 1][1] * d0);
    ap[3] = pack2(s[2 * kk + 1][2] * d1, s[2 * kk + 1][3] * d1);
    // B[k][n] = v[key 16 kk + k][dim 8 j + n]: keys run down the rows, so
    // the fragments come transposed.
    uint32_t bv[4];
    ldsm_x4_trans(bv, v_lane + kk * 16 * KS * 2);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      tux::mma_bf16(ctx[j], ap[0], ap[1], ap[2], ap[3], bv[2 * j],
                    bv[2 * j + 1]);
  }
  ctx_a[0] = pack2(ctx[0][0], ctx[0][1]);
  ctx_a[1] = pack2(ctx[0][2], ctx[0][3]);
  ctx_a[2] = pack2(ctx[1][0], ctx[1][1]);
  ctx_a[3] = pack2(ctx[1][2], ctx[1][3]);
}

// An accumulator's value as f32: the value itself, or the f32 bits an
// int8 mode's dequant left in the int32 register.
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }

// The k16-step A fragments of a wgmma m64n64 accumulator's four 16-column
// blocks, fn(col, v0, v1) -> the pair as two bf16 (col within the chunk):
// the accumulator's pair layout is mma.m16n8k16's A layout.
template <typename T, typename F>
__device__ __forceinline__ void to_frags(uint32_t (&frag)[4][4],
                                         const T (&acc)[32], int t, F fn) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // k = 0: row g, cols 16 s + 2t; 1: row g + 8; 2, 3: cols + 8.
      const int jj = 2 * s + (k >> 1);
      const int i = k & 1;
      frag[s][k] = fn(8 * jj + 2 * t, as_f32(acc[4 * jj + 2 * i]),
                      as_f32(acc[4 * jj + 2 * i + 1]));
    }
}

// x[rows 16 warp + g (+8)] += the wgmma m64nC accumulator acc + bias, in
// the mode's association, eight column pairs at a time: their x values and
// biases are read before any of them is written.
template <int C, int MODE, typename T>
__device__ __forceinline__ void residual_rows(const T (&acc)[C / 2],
                                              bf16* xs, const bf16* b,
                                              int warp, int g, int t) {
  bf162* x0 = reinterpret_cast<bf162*>(xs + (16 * warp + g) * (C + 8) +
                                       2 * t);
  bf162* x1 = x0 + 4 * (C + 8);
  const bf162* b2 = reinterpret_cast<const bf162*>(b + 2 * t);
#pragma unroll
  for (int j0 = 0; j0 < C / 8; j0 += 8) {
    bf162 bb[8], xa[8], xb[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bb[k] = b2[4 * (j0 + k)];
      xa[k] = x0[4 * (j0 + k)];
      xb[k] = x1[4 * (j0 + k)];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = j0 + k;
      x0[4 * j] = residual2<MODE>(xa[k], as_f32(acc[4 * j]),
                                  as_f32(acc[4 * j + 1]), bb[k]);
      x1[4 * j] = residual2<MODE>(xb[k], as_f32(acc[4 * j + 2]),
                                  as_f32(acc[4 * j + 3]), bb[k]);
    }
  }
}

// ---------------------------------------------------- the int8 modes' parts
// The row scale of the rowwise int8 mode (trunk2.py:176-178): 1/127 is the
// f32 value of the double 1/127, as the reference's weakly typed constant.
__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(absmax, 1e-6f) * float(1.0 / 127.0);
}
// a quantized with a row's inv = 1 / srow (a correctly rounded f32
// division), rounded half to even: within +-127 since |a| <= the row's
// maximum.
__device__ __forceinline__ int q_row(float a, float inv) {
  return __float2int_rn(__fmul_rn(a, inv));
}
// a quantized with its column's inverse scale ia, rounded half to even and
// clipped to +-127 (trunk2.py:182): fmaxf(-127) and one convert that
// rounds half to even and saturates at 127, bit-identical to rint and two
// clamps.
__device__ __forceinline__ int q_col(float a, float ia) {
  const float v = fmaxf(__fmul_rn(a, ia), -127.f);
  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(q) : "f"(v));
  return q;
}
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
// Four int8 in one register, a in the low byte.
__device__ __forceinline__ uint32_t pack_i8(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}
__device__ __forceinline__ float quad_max(float m) {
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}
__device__ __forceinline__ float quad_min(float m) {
  m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

// Byte offset of (row r, column c) in the int8 LN output: C / 64 K-major
// tiles of 64 rows x 64 B, 16-byte chunks XORed with (r / 2) % 4 (the 64B
// swizzle, as TMA would have written it).
__device__ __forceinline__ int a_offset_i8(int r, int c) {
  return (c >> 6) * 4096 + r * 64 + ((((c & 63) >> 4) ^ ((r >> 1) & 3)) << 4) +
         (c & 15);
}

// layernorm_to_a with the output quantized into the int8 A tile: with the
// columns' inverse scales ia, or (ROWS) with each row's scale, which
// srow[i] keeps for row 16 warp + g + 8 i (the rows of the thread's
// accumulator values).
template <class K>
__device__ __forceinline__ void layernorm_to_a_i8(
    const bf16* xs, unsigned char* a, const bf16* scale, const bf16* shift,
    const float* ia, float (&srow)[2], int warp, int lane) {
  constexpr int C = K::C, XS = C + 8, P = C / 64;
  float2 sc[P], sh[P], iv[P];
  ln_params<C>(sc, sh, scale, shift, lane);
  if constexpr (!K::ROWS) {
#pragma unroll
    for (int j = 0; j < P; ++j) iv[j] = ld_f2(ia + 2 * lane + 64 * j);
  }
  const int g = lane >> 2;
#pragma unroll 1
  for (int r0 = 16 * warp; r0 < 16 * warp + 16; r0 += 4) {
    float2 v[4][P];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < P; ++j)
        v[r][j] = ld2(xs + (r0 + r) * XS + 2 * lane + 64 * j);
    layernorm_rows<C, 4>(v, sc, sh);
    float inv[4];
    if constexpr (K::ROWS) {
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        m[r] = 0.f;
#pragma unroll
        for (int j = 0; j < P; ++j)
          m[r] = fmaxf(m[r], fmaxf(fabsf(v[r][j].x), fabsf(v[r][j].y)));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sr = row_scale(m[r]);
        inv[r] = 1.0f / sr;
        const int rr = (r0 + r) & 15;
        if (rr == g) srow[0] = sr;
        if (rr == g + 8) srow[1] = sr;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int c = 2 * lane + 64 * j;
        const int q0 = K::ROWS ? q_row(v[r][j].x, inv[r])
                               : q_col(v[r][j].x, iv[j].x);
        const int q1 = K::ROWS ? q_row(v[r][j].y, inv[r])
                               : q_col(v[r][j].y, iv[j].y);
        *reinterpret_cast<char2*>(a + a_offset_i8(r0 + r, c)) =
            make_char2(static_cast<signed char>(q0),
                       static_cast<signed char>(q1));
      }
  }
}

// An int32 wgmma accumulator of R / 4 column pairs (acc[4j + 2i + e]: row
// g + 8i, column 8j + 2t + e) replaced, in place as f32 bits (as_f32), by
// its products: (float(acc) * srow[i]) * sw[col] with row scales (ROWS),
// else float(acc) * sw[col]; sw points at the first column's scale. In
// place, so that the accumulator, which the next product's asm reads, and
// the products are not both live. Each multiply rounds on its own, so
// every caller gets the same bits.
template <bool ROWS, int R>
__device__ __forceinline__ void dequant(int (&acc)[R], const float* sw,
                                        const float (&srow)[2], int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float2 w = ld_f2(sw + 8 * j + 2 * t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = __int2float_rn(acc[4 * j + 2 * i]);
      float v1 = __int2float_rn(acc[4 * j + 2 * i + 1]);
      if constexpr (ROWS) {
        v0 = __fmul_rn(v0, srow[i]);
        v1 = __fmul_rn(v1, srow[i]);
      }
      acc[4 * j + 2 * i] = __float_as_int(__fmul_rn(v0, w.x));
      acc[4 * j + 2 * i + 1] = __float_as_int(__fmul_rn(v1, w.y));
    }
  }
}

// The GELU output pair for the fc1 products v0, v1 and their bias: bf16(
// gelu_i8(bf16(v) + b)), v2's fc1 epilogue with gelu_i8.
__device__ __forceinline__ float2 hidden(float v0, float v1, bf162 bias) {
  const float2 d = __bfloat1622float2(dense2(v0, v1, bias));
  return round_bf16(gelu_i8(d.x), gelu_i8(d.y));
}

// The k32-step s8 A fragments (wgmma m64nNk32 from registers) of a wgmma
// m64n64 accumulator's values: fn(col, i, v0, v1) -> the pair at columns
// col, col + 1 of row g + 8 i quantized, as two int. Step kk, register r
// takes the pairs of j = 4 kk + 2 (r / 2) and j + 1 (columns 8 j + 2t, +1)
// in row g + 8 (r % 2): K slot 4t + e of each 16-slot half holds column
// 2t + e % 2 + 8 (e / 2) of that half, and the weight rows arrive in that
// K order (kernels/trunk2.py K_PERM).
template <typename T, typename F>
__device__ __forceinline__ void to_frags_i8(uint32_t (&frag)[2][4],
                                            const T (&acc)[32], int t,
                                            F fn) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * kk + 2 * (r >> 1), i = r & 1;
      const int2 p = fn(8 * j + 2 * t, i, as_f32(acc[4 * j + 2 * i]),
                        as_f32(acc[4 * j + 2 * i + 1]));
      const int2 q = fn(8 * j + 8 + 2 * t, i, as_f32(acc[4 * j + 4 + 2 * i]),
                        as_f32(acc[4 * j + 5 + 2 * i]));
      frag[kk][r] = pack_i8(p.x, p.y, q.x, q.y);
    }
}

// The same for a head group's context, four heads' attend() fragments
// ([0] row g, dims 2t, 2t + 1; [1] row g + 8; [2], [3] dims 8 + 2t, +1):
// step kk takes heads 2 kk and 2 kk + 1, in to_frags_i8's K order; col
// is within the group.
template <typename F>
__device__ __forceinline__ void ctx_frags_i8(uint32_t (&frag)[2][4],
                                             const uint32_t (&ctx)[4][4],
                                             int t, F fn) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int hh = 2 * kk + (r >> 1), i = r & 1;
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(&ctx[hh][i]));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(&ctx[hh][2 + i]));
      const int2 p = fn(16 * hh + 2 * t, i, a.x, a.y);
      const int2 q = fn(16 * hh + 8 + 2 * t, i, b.x, b.y);
      frag[kk][r] = pack_i8(p.x, p.y, q.x, q.y);
    }
}

// chunk64 in int8: acc = A tile . the next slab, KT tiles of two k32 steps
// (the slab's tiles are [64 outputs][64 inputs] of int8).
template <class K, class R>
__device__ __forceinline__ void chunk64_i8(int (&acc)[32], R& ring,
                                           const unsigned char* a, int lane) {
  const int n = ring.next++;
  ring.wait_full(n);
  const unsigned char* w = ring.slab(n);
  S::wgmma_fence();
  S::wgmma_i8_ss_n64_init(acc, S::desc_k64(a, 0), S::desc_k64(w, 0));
#pragma unroll
  for (int kt = 0; kt < K::KT; ++kt)
#pragma unroll
    for (int s = kt == 0; s < 2; ++s)
      S::wgmma_i8_ss_n64(acc, S::desc_k64(a + kt * 4096, s),
                         S::desc_k64(w + kt * 4096, s), 1);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(acc);
  ring.release(n, lane);
}

// rows64 in int8: acc (+)= frag . the next slab's [C outputs][64 inputs],
// two k32 steps. FIRST = 1: the first product of the accumulation, known
// at compile time (acc is then no input); else ``first`` says it.
template <class K, int FIRST = 0, class R>
__device__ __forceinline__ void rows64_i8(int (&acc)[K::C / 2],
                                          const uint32_t (&frag)[2][4],
                                          R& ring, bool first, int lane) {
  const int n = ring.next++;
  ring.wait_full(n);
  const unsigned char* w = ring.slab(n);
  S::wgmma_fence();
  if constexpr (FIRST) {
    S::wgmma_i8_rs_n192_init(acc, frag[0], S::desc_k64(w, 0));
  } else {
    S::wgmma_i8_rs_n192(acc, frag[0], S::desc_k64(w, 0), first ? 0 : 1);
  }
  S::wgmma_i8_rs_n192(acc, frag[1], S::desc_k64(w, 1), 1);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(acc);
  ring.release(n, lane);
}

// ------------------------------------------------------------ the kernel
// One consumer warpgroup's window: its shared-memory regions and place.
struct Window {
  unsigned char* a_tile;  // LN output, the SS products' A
  bf16* xs;               // residual x, row stride C + 8
  bf16* kb;               // k and v of one head group, row stride KS
  bf16* vb;
  bf16* vecs;             // two layers' vectors, in turns
  int wg, warp, lane, g, t;
};

// Layer l's vectors (LN scales and shifts, biases) into the window's buffer
// l % 2, by the warpgroup's 128 threads.
template <int C>
__device__ __forceinline__ void load_vec(const Window& w,
                                         const bf16* vpack, int l) {
  using V = Vec<C>;
  const uint4* src = reinterpret_cast<const uint4*>(vpack + l * V::SIZE);
  uint4* dst = reinterpret_cast<uint4*>(w.vecs + (l & 1) * V::SIZE);
  for (int i = w.lane + 32 * w.warp; i < V::SIZE / 8; i += 128)
    dst[i] = src[i];
}

// The bf16 modes' layers.
template <class K, class R>
__device__ __forceinline__ void layers_bf16(const Window& w, R& ring,
                                            const bf16* vpack,
                                            const float* tables,
                                            int layers) {
  constexpr int C = K::C;
  using V = Vec<C>;
  unsigned char* a_tile = w.a_tile;
  bf16* xs = w.xs;
  bf16* kb = w.kb;
  bf16* vb = w.vb;
  const int wg = w.wg, warp = w.warp, lane = w.lane, g = w.g, t = w.t;
  float acc[32];
  float big[C / 2];  // proj, then fc2: all C outputs of the warpgroup's rows
  for (int l = 0; l < layers; ++l) {
    const bf16* vp = w.vecs + (l & 1) * V::SIZE;
    const float* tab_l = tables + size_t(l) * K::HEADS * TAB;

    layernorm_to_a<C>(xs, a_tile, vp + V::LN1S, vp + V::LN1B, warp, lane);
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
    if (l + 1 < layers) load_vec<C>(w, vpack, l + 1);
#pragma unroll 1
    for (int hg = 0; hg < K::GROUPS; ++hg) {
      // k and v of the group's 4 heads into shared memory, q into
      // registers: bf16(y W) + b.
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        chunk64<K>(acc, ring, a_tile, lane);
        const bf16* b = vp + V::QKVB + (kv + 1) * C + 64 * hg + 2 * t;
        bf16* dst = (kv == 0 ? kb : vb) + (16 * warp + g) * KS + 2 * t;
        bf162 bb[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) bb[jj] = ld_b2(b + 8 * jj);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<bf162*>(dst + 8 * i * KS + 8 * jj) = dense2(
                acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1], bb[jj]);
      }
      chunk64<K>(acc, ring, a_tile, lane);
      uint32_t q[4][4];
      const bf16* bq = vp + V::QKVB + 64 * hg;
      to_frags(q, acc, t, [&](int c, float v0, float v1) {
        return as_u32(dense2(v0, v1, ld_b2(bq + c)));
      });
      S::named_sync(1 + wg, 128);  // k and v rows of every warp written
      uint32_t ctx[4][4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
        attend(ctx[hh], q[hh], kb, vb, hh,
               tab_l + (4 * hg + hh) * TAB, warp, g, t);
      S::named_sync(1 + wg, 128);  // every warp done with k and v
      rows64<K>(big, ctx, ring, hg == 0, lane);
    }
    residual_rows<C, K::MODE>(big, xs, vp + V::PROJB, warp, g, t);
    __syncwarp();

    layernorm_to_a<C>(xs, a_tile, vp + V::LN2S, vp + V::LN2B, warp, lane);
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
#pragma unroll 1
    for (int j = 0; j < K::CHUNKS; ++j) {
      chunk64<K>(acc, ring, a_tile, lane);
      uint32_t h[4][4];
      const bf16* b = vp + V::FC1B + 64 * j;
      to_frags(h, acc, t, [&](int c, float v0, float v1) {
        const float2 d = __bfloat1622float2(dense2(v0, v1, ld_b2(b + c)));
        return pack2(gelu(d.x), gelu(d.y));
      });
      rows64<K>(big, h, ring, j == 0, lane);
    }
    residual_rows<C, K::MODE>(big, xs, vp + V::FC2B, warp, g, t);
    __syncwarp();
  }
}

// INT8's first pass over the fc1 chunks: hmax[i] = the largest |GELU
// output| of row g + 8 i (the quad's whole row), from the same products,
// dequant and bias as the second pass, but GELU at three pre-activations a
// row (gelu_i8): the largest, the largest <= GELU_TURN and the smallest
// above it (0 if none is below 0, where GELU is 0). b, sw: fc1's biases
// and weight scales.
template <class K, class R>
__device__ __forceinline__ void gelu_row_max(float (&hmax)[2], int (&acc)[32],
                                             R& ring,
                                             const unsigned char* a_tile,
                                             const bf16* b, const float* sw,
                                             const float (&srow)[2],
                                             int lane) {
  const int t = lane & 3;
  float top[2] = {-INFINITY, -INFINITY}, lo[2] = {-1e30f, -1e30f},
        hi[2] = {0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < K::CHUNKS; ++j) {
    chunk64_i8<K>(acc, ring, a_tile, lane);
    dequant<true>(acc, sw + 64 * j, srow, t);
    const bf16* bj = b + 64 * j + 2 * t;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const bf162 bias = ld_b2(bj + 8 * jj);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 d = __bfloat1622float2(
            dense2(as_f32(acc[4 * jj + 2 * i]),
                   as_f32(acc[4 * jj + 2 * i + 1]), bias));
        top[i] = fmaxf(top[i], fmaxf(d.x, d.y));
        lo[i] = fmaxf(lo[i], fmaxf(d.x <= GELU_TURN ? d.x : -1e30f,
                                   d.y <= GELU_TURN ? d.y : -1e30f));
        hi[i] = fminf(hi[i], fminf(d.x > GELU_TURN ? d.x : 0.f,
                                   d.y > GELU_TURN ? d.y : 0.f));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = round_bf16(gelu_i8(quad_max(top[i])),
                                gelu_i8(quad_max(lo[i])));
    const float c = round_bf16(gelu_i8(quad_min(hi[i])), 0.f).x;
    hmax[i] = fmaxf(fabsf(a.x), fmaxf(fabsf(a.y), fabsf(c)));
  }
}

// The int8 modes' layers: layers_bf16's schedule on int8 wgmma (header).
// sw, ia: the (layers, 9C) weight scales and, in INT8_STATIC, the
// (layers, 7C) inverse activation scales.
template <class K, class R>
__device__ __forceinline__ void layers_i8(const Window& w, R& ring,
                                          const bf16* vpack,
                                          const float* tables,
                                          const float* sw_all,
                                          const float* ia_all, int layers) {
  constexpr int C = K::C, G = K::GROUPS;
  constexpr bool ROWS = K::ROWS;
  using V = Vec<C>;
  using Q = Scales<C>;
  unsigned char* a_tile = w.a_tile;
  bf16* xs = w.xs;
  bf16* kb = w.kb;
  bf16* vb = w.vb;
  const int wg = w.wg, warp = w.warp, lane = w.lane, g = w.g, t = w.t;
  int acc[32];      // a qkv or fc1 chunk
  int big[C / 2];   // proj, then fc2: all C outputs of the warpgroup's rows
  float srow[2] = {1.f, 1.f};  // ROWS: the LN output's row scales
  for (int l = 0; l < layers; ++l) {
    const bf16* vp = w.vecs + (l & 1) * V::SIZE;
    const float* tab_l = tables + size_t(l) * K::HEADS * TAB;
    const float* sw = sw_all + size_t(l) * Q::SW;
    const float* ia = ROWS ? nullptr : ia_all + size_t(l) * Q::IA;

    layernorm_to_a_i8<K>(xs, a_tile, vp + V::LN1S, vp + V::LN1B,
                         ROWS ? nullptr : ia + Q::I_QKV, srow, warp, lane);
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
    if (l + 1 < layers) load_vec<C>(w, vpack, l + 1);
    // INT8: every group's context, the newest last; its rows' maxima.
    uint32_t held[G][4][4];
    float cmax[2] = {0.f, 0.f};
#pragma unroll 1
    for (int hg = 0; hg < G; ++hg) {
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        chunk64_i8<K>(acc, ring, a_tile, lane);
        dequant<ROWS>(acc, sw + Q::S_QKV + (kv + 1) * C + 64 * hg, srow,
                      t);
        const bf16* b = vp + V::QKVB + (kv + 1) * C + 64 * hg + 2 * t;
        bf16* dst = (kv == 0 ? kb : vb) + (16 * warp + g) * KS + 2 * t;
        bf162 bb[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) bb[jj] = ld_b2(b + 8 * jj);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<bf162*>(dst + 8 * i * KS + 8 * jj) =
                dense2(as_f32(acc[4 * jj + 2 * i]),
                       as_f32(acc[4 * jj + 2 * i + 1]), bb[jj]);
      }
      chunk64_i8<K>(acc, ring, a_tile, lane);
      dequant<ROWS>(acc, sw + Q::S_QKV + 64 * hg, srow, t);
      uint32_t q[4][4];
      const bf16* bq = vp + V::QKVB + 64 * hg;
      to_frags(q, acc, t, [&](int c, float v0, float v1) {
        return as_u32(dense2(v0, v1, ld_b2(bq + c)));
      });
      S::named_sync(1 + wg, 128);  // k and v rows of every warp written
      if constexpr (ROWS) {
#pragma unroll
        for (int k = 0; k + 1 < G; ++k)
#pragma unroll
          for (int hh = 0; hh < 4; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) held[k][hh][e] = held[k + 1][hh][e];
      }
      uint32_t (&ctx_g)[4][4] = held[G - 1];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
        attend(ctx_g[hh], q[hh], kb, vb, hh,
               tab_l + (4 * hg + hh) * TAB, warp, g, t);
      S::named_sync(1 + wg, 128);  // every warp done with k and v
      if constexpr (ROWS) {
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(&ctx_g[hh][e]));
            cmax[e & 1] = fmaxf(cmax[e & 1], fmaxf(fabsf(v.x), fabsf(v.y)));
          }
      } else {
        const float* iap = ia + Q::I_PROJ + 64 * hg;
        uint32_t f[2][4];
        ctx_frags_i8(f, ctx_g, t, [&](int c, int, float v0, float v1) {
          const float2 s = ld_f2(iap + c);
          return make_int2(q_col(v0, s.x), q_col(v1, s.y));
        });
        rows64_i8<K>(big, f, ring, hg == 0, lane);
      }
    }
    float sc[2] = {1.f, 1.f};  // ROWS: the context rows' scales
    if constexpr (ROWS) {
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sc[i] = row_scale(quad_max(cmax[i]));
        inv[i] = 1.0f / sc[i];
      }
#pragma unroll
      for (int hg = 0; hg < G; ++hg) {
        uint32_t f[2][4];
        ctx_frags_i8(f, held[hg], t, [&](int, int i, float v0, float v1) {
          return make_int2(q_row(v0, inv[i]), q_row(v1, inv[i]));
        });
        if (hg == 0)
          rows64_i8<K, 1>(big, f, ring, true, lane);
        else
          rows64_i8<K>(big, f, ring, false, lane);
      }
    }
    dequant<ROWS>(big, sw + Q::S_PROJ, sc, t);
    residual_rows<C, K::MODE>(big, xs, vp + V::PROJB, warp, g, t);
    __syncwarp();

    layernorm_to_a_i8<K>(xs, a_tile, vp + V::LN2S, vp + V::LN2B,
                         ROWS ? nullptr : ia + Q::I_FC1, srow, warp, lane);
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
    // ROWS: the GELU rows' scales sh and their inverses. Over the fc2
    // loop sh waits in the thread's own two floats of the k / v region,
    // which the MLP leaves unused: two registers fewer there.
    float sh[2] = {1.f, 1.f}, ih[2];
    volatile float* sh_slot =
        reinterpret_cast<float*>(kb) + 2 * (32 * warp + lane);
    if constexpr (ROWS) {
      float hmax[2];
      gelu_row_max<K>(hmax, acc, ring, a_tile, vp + V::FC1B,
                      sw + Q::S_FC1, srow, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float s = row_scale(hmax[i]);
        sh_slot[i] = s;
        ih[i] = 1.0f / s;
      }
    }
    // Hidden chunk j: fc1, GELU, quantize, fc2's rows. The first is peeled
    // (FIRST = 1), so that big is no input before it.
    auto mlp_chunk = [&](int j, auto first) {
      chunk64_i8<K>(acc, ring, a_tile, lane);
      dequant<ROWS>(acc, sw + Q::S_FC1 + 64 * j, srow, t);
      uint32_t f[2][4];
      const bf16* b = vp + V::FC1B + 64 * j;
      const float* iah = ROWS ? nullptr : ia + Q::I_FC2 + 64 * j;
      to_frags_i8(f, acc, t, [&](int c, int i, float v0, float v1) {
        const float2 h = hidden(v0, v1, ld_b2(b + c));
        if constexpr (ROWS) {
          return make_int2(q_row(h.x, ih[i]), q_row(h.y, ih[i]));
        } else {
          const float2 s = ld_f2(iah + c);
          return make_int2(q_col(h.x, s.x), q_col(h.y, s.y));
        }
      });
      rows64_i8<K, decltype(first)::value>(big, f, ring, false, lane);
    };
    mlp_chunk(0, std::integral_constant<int, 1>{});
#pragma unroll 1
    for (int j = 1; j < K::CHUNKS; ++j)
      mlp_chunk(j, std::integral_constant<int, 0>{});
    if constexpr (ROWS) {
      sh[0] = sh_slot[0];
      sh[1] = sh_slot[1];
    }
    dequant<ROWS>(big, sw + Q::S_FC2, sh, t);
    residual_rows<C, K::MODE>(big, xs, vp + V::FC2B, warp, g, t);
    __syncwarp();
  }
}

// x, out (nW, 64, C) bf16; wmap: the slabs (layers x SLABS x C rows, 64)
// bf16 (box (64, C), 128B swizzle) or int8 (64B swizzle); vpack (layers,
// 13C) bf16; tables (layers, C/16, 225) f32, each head's relative-position
// table; sw, ia as for layers_i8 (unused in the bf16 modes). ``wpb``
// windows a block (1 or 2).
template <class K>
__global__ void __launch_bounds__(W_THREADS, 1)
window_trunk_kernel(const __grid_constant__ CUtensorMap wmap,
                    const bf16* __restrict__ x,
                    const bf16* __restrict__ vpack,
                    const float* __restrict__ tables,
                    const float* __restrict__ sw,
                    const float* __restrict__ ia,
                    bf16* __restrict__ out, int n_windows, int layers,
                    int wpb) {
  constexpr int C = K::C, XS = K::XS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_base = align1024(smem_raw);
  unsigned char* win_base = ring_base + K::STAGES * K::STAGE;
  bf16* vec_base = reinterpret_cast<bf16*>(win_base + WG * K::WIN);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      win_base + WG * K::WIN + WG * 2 * K::VEC_BYTES);
  uint64_t* empty = full + K::STAGES;
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * wpb;
  const int active = min(wpb, n_windows - w0);  // consumer warpgroups
  if (tid == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      S::mbar_init(&full[s], 1);
      S::mbar_init(&empty[s], 4 * active);
    }
    S::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= WG * 128) {  // producer warpgroup: one thread issues copies
    S::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != WG * 128) return;
    const int total = layers * K::SLABS;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < total; ++i) {
      S::mbar_wait(&empty[stage], phase ^ 1);
      S::mbar_expect_tx(&full[stage], K::STAGE);
      S::tma_load_2d(ring_base + stage * K::STAGE, &wmap, &full[stage], 0,
                     i * C);
      if (++stage == K::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  S::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7;
  if (wg >= active) return;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  unsigned char* win = win_base + wg * K::WIN;
  bf16* kb = reinterpret_cast<bf16*>(win + K::A_BYTES + K::X_BYTES);
  const Window w{win, reinterpret_cast<bf16*>(win + K::A_BYTES), kb,
                 kb + NT * KS, vec_base + wg * 2 * Vec<C>::SIZE, wg, warp,
                 lane, lane >> 2, lane & 3};
  Ring<K::STAGES> ring{ring_base, full, empty, K::STAGE, 0};

  // This warp's 16 rows of the window into x.
  const size_t wofs = size_t(w0 + wg) * NT * C;
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int r = 16 * warp + i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(w.xs + r * XS + c) =
        *reinterpret_cast<const uint4*>(x + wofs + r * C + c);
  }
  // Layer l + 1's vectors are loaded once every warp has passed layer l - 1
  // (the barrier after layer l's first LayerNorm).
  load_vec<C>(w, vpack, 0);
  S::named_sync(1 + wg, 128);
  if constexpr (K::I8)
    layers_i8<K>(w, ring, vpack, tables, sw, ia, layers);
  else
    layers_bf16<K>(w, ring, vpack, tables, layers);

  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int r = 16 * warp + i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(out + wofs + r * C + c) =
        *reinterpret_cast<const uint4*>(w.xs + r * XS + c);
  }
}

template <int C, int MODE>
int launch(const void* x, const void* wpack, const void* vpack,
           const void* tables, const void* sw, const void* ia, void* out,
           int n_windows, int layers, int device, cudaStream_t stream) {
  using K = WCfg<C, MODE>;
  static_assert(K::BYTES <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      window_trunk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::BYTES);
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  CUtensorMap wmap;
  const int rows = layers * K::SLABS * C;
  const int e = K::I8 ? S::map_matrix_i8(&wmap, wpack, rows, 64, C)
                      : S::map_matrix(&wmap, wpack, rows, 64, C);
  if (e) return e;
  const int wpb = n_windows <= S::sm_count(device) ? 1 : WG;
  const int grid = (n_windows + wpb - 1) / wpb;
  window_trunk_kernel<K><<<grid, W_THREADS, K::BYTES, stream>>>(
      wmap, static_cast<const bf16*>(x), static_cast<const bf16*>(vpack),
      static_cast<const float*>(tables), static_cast<const float*>(sw),
      static_cast<const float*>(ia), static_cast<bf16*>(out), n_windows,
      layers, wpb);
  return int(cudaGetLastError());
}

// The int8 wgmma helpers and the fragment map, one product each, as the
// trunk runs them (tests/test_torch_gpu.py holds them bit for bit): out1
// (64 x 64, s32) = a (64 x 192, s8) . b (64 x 192, s8)^T by the SS product
// on TMA-loaded 64B-swizzled tiles, as a qkv or fc1 chunk; out2 (64 x 192,
// s32) = a2 (64 x 64, s8) . w2 (64 x 192) by the RS product, its A
// fragments built from a2's values as an f32 wgmma accumulator by
// to_frags_i8, and b2 = w2's rows as a proj or fc2 slab ([192 outputs][64
// inputs], inputs in K_PERM order).
__global__ void __launch_bounds__(128, 1)
wgmma_i8_probe_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap b2map,
                      const int8_t* __restrict__ a2, int* __restrict__ out1,
                      int* __restrict__ out2) {
  constexpr int C = 192, KT = C / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* at = align1024(smem_raw);
  unsigned char* bt = at + KT * 4096;
  unsigned char* b2 = bt + KT * 4096;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b2 + C * 64);
  const int tid = threadIdx.x;
  if (tid == 0) {
    S::mbar_init(bar, 1);
    S::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    S::mbar_expect_tx(bar, 2 * KT * 4096 + C * 64);
    for (int kt = 0; kt < KT; ++kt) {
      S::tma_load_2d(at + kt * 4096, &amap, bar, 64 * kt, 0);
      S::tma_load_2d(bt + kt * 4096, &bmap, bar, 64 * kt, 0);
    }
    S::tma_load_2d(b2, &b2map, bar, 0, 0);
  }
  S::mbar_wait(bar, 0);
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  int acc[32];
  S::wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      S::wgmma_i8_ss_n64(acc, S::desc_k64(at + kt * 4096, s),
                         S::desc_k64(bt + kt * 4096, s), kt | s);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(acc);
  float f[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      out1[r * 64 + c] = acc[4 * j + e];
      f[4 * j + e] = float(a2[r * 64 + c]);
    }
  uint32_t frag[2][4];
  to_frags_i8(frag, f, t, [](int, int, float v0, float v1) {
    return make_int2(__float2int_rn(v0), __float2int_rn(v1));
  });
  int big[C / 2];
  S::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s)
    S::wgmma_i8_rs_n192(big, frag[s], S::desc_k64(b2, s), s);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(big);
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out2[(16 * warp + g + 8 * (e >> 1)) * C + 8 * j + 2 * t + (e & 1)] =
          big[4 * j + e];
}

// out[k] = bf16(gelu_i8(d[k])) as the int8 modes' epilogue computes it
// (hidden() with a zero bias).
__global__ void gelu_i8_probe_kernel(const bf16* __restrict__ d,
                                     bf16* __restrict__ out, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float v = __bfloat162float(d[k]);
  out[k] = __float2bfloat16(
      hidden(v, v, __floats2bfloat162_rn(0.f, 0.f)).x);
}

}  // namespace

// dim 128 or 192; mode 0 (V2), 1 (V1) or, at dim 192, 2 (INT8) or 3
// (INT8_STATIC). wpack holds the slabs (layers x SLABS x C rows, 64): bf16
// in modes 0 and 1, int8 in 2 and 3 (kernels/trunk2.py ``_pack_slabs``);
// tables the relative-position tables (layers, C/16, 225) f32. swpack
// (layers, 9C) and, in INT8_STATIC, iapack (layers, 7C) are read in the
// int8 modes only. Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_window_trunk(const void* x, const void* wpack,
                                const void* vpack, const void* tables,
                                const void* swpack, const void* iapack,
                                void* out, int n_windows, int layers, int dim,
                                int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TUX_TRUNK(C, M)                                                     \
  case C * 4 + M:                                                           \
    return launch<C, M>(x, wpack, vpack, tables, swpack, iapack, out,       \
                        n_windows, layers, device, st);
  switch (dim * 4 + mode) {
    TUX_TRUNK(128, V2)
    TUX_TRUNK(128, V1)
    TUX_TRUNK(192, V2)
    TUX_TRUNK(192, V1)
    TUX_TRUNK(192, INT8)
    TUX_TRUNK(192, INT8_STATIC)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef TUX_TRUNK
}

// a, b (64, 192), a2 (64, 64), b2 (192, 64) int8; out1 (64, 64), out2
// (64, 192) int32 (wgmma_i8_probe_kernel). Returns the cudaError_t.
extern "C" int tux_wgmma_i8_probe(const void* a, const void* b,
                                  const void* a2, const void* b2, void* out1,
                                  void* out2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  CUtensorMap amap, bmap, b2map;
  int e = S::map_matrix_i8(&amap, a, 64, 192, 64);
  if (!e) e = S::map_matrix_i8(&bmap, b, 64, 192, 64);
  if (!e) e = S::map_matrix_i8(&b2map, b2, 192, 64, 192);
  if (e) return e;
  constexpr int BYTES = 1024 + 3 * 12288 + 8;
  err = cudaFuncSetAttribute(wgmma_i8_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BYTES);
  if (err != cudaSuccess) return int(err);
  wgmma_i8_probe_kernel<<<1, 128, BYTES, static_cast<cudaStream_t>(stream)>>>(
      amap, bmap, b2map, static_cast<const int8_t*>(a2),
      static_cast<int*>(out1), static_cast<int*>(out2));
  return int(cudaGetLastError());
}

// d, out (n,) bf16: out = the int8 modes' bf16 GELU of d
// (gelu_i8_probe_kernel). Returns the cudaError_t of the launch.
extern "C" int tux_gelu_i8_probe(const void* d, void* out, int n, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n == 0) return 0;
  gelu_i8_probe_kernel<<<(n + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(d), static_cast<bf16*>(out), n);
  return int(cudaGetLastError());
}
