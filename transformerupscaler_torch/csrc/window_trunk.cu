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
//                                      (erff, or erf_branchless in the
//                                      bf16 modes)
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
//         quantized with its column's calibrated inverse scale ia (from
//         iapack, read through L1 / L2), aq = clip(round_half_even(a * ia),
//         -127, 127); no row maximum, no row scales. The scales are folded
//         into the int8 weights, whose f32 scales sw arrive as in INT8; the
//         product is float(acc) * sw.
//
// Two designs, by mode:
//
// V2 and V1 (bf16; window_trunk_kernel): TMA + wgmma. A block holds two
// windows, one a consumer warpgroup (rows 16 w .. 16 w + 15 of a window to
// warp w), and a producer warpgroup: one thread of it issues the copies,
// and setmaxnreg moves its registers to the consumers (24 and 240 a
// thread). Both windows take every weight slab from one ring, so the
// weights cross L2 once for two windows, and one window's LayerNorm,
// softmax and epilogues overlap the other's products. The
// weights arrive re-cut (kernels/trunk2.py ``_pack_slabs``) into 12C/64
// slabs a layer of C rows x 64 bf16 (C x 128 B), each one TMA box written
// with the 128B swizzle, in the order the products consume them:
//   per head group of 64 channels (4 heads): k, v and q, each an N = 64
//     output chunk as C/64 K-major tiles [64 outputs][64 inputs]
//     (wgmma m64n64k16, A = the LN output from shared memory), then proj's
//     rows of those 64 input channels, a K-major [C outputs][64 inputs]
//     (wgmma m64nCk16, A = the group's attention context from registers,
//     accumulated in f32 over the groups: the one product's sum in another
//     order, rounded once);
//   per hidden chunk of 64: fc1's N = 64 chunk, then fc2's [C][64] rows
//     (A = bf16(GELU) of the fc1 chunk from registers, the fc2 sum in f32
//     over all chunks, rounded once). The 64 x 4C hidden never exists.
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
// Shared memory at C = 192 (C = 128), bytes:
//   ring         3 x 24,576 = 73,728      (6 x 16,384 = 98,304)
//   per window   LN output as the A operand, C/64 swizzled 8 KB tiles
//                24,576 (16,384); residual x, row stride C + 8: 25,600
//                (17,408); k and v of one head group, row stride 72:
//                18,432 (18,432); 68,608 (52,224), two windows 137,216
//                (104,448)
//   vectors      a layer's LN scales, shifts and biases (13 C bf16), two
//                layers a window: 19,968 (13,312)
//   barriers     2 x STAGES x 8 = 48 (96); 1,024 to align the ring
//   total        231,984 (217,184) of 232,448.
// Windows a block: one while the windows fit on the SMs one a block, else
// two (240 windows: 120 blocks, one wave); a block whose second window is
// past the end runs one consumer warpgroup.
//
// INT8 and INT8_STATIC (window_trunk_i8_kernel, on mma.sync and cp.async):
// one block per window, 256 threads. Shared memory holds the residual
// stream x (64 x C), the LN output / attention context (64 x C) and one
// 64 x 4C buffer used for qkv (64 x 3C) and then for the MLP hidden: no
// intermediate goes to device memory. The int8 weights arrive as slabs of
// [64 outputs][C inputs] in the order the kernel consumes them (qkv 3C/64,
// proj C/64, fc1 4C/64, fc2 C/64 output chunks x 4 input chunks), and a
// three-slab ring is filled with cp.async two slabs ahead of the mma.sync
// products, also across the LN and attention phases. The 8 warps tile a
// slab's 64 x 64 output as 2 x 4 warp tiles of 32 x 16. Attention runs
// flash-style per (head, 16 query rows). Row strides of (multiple of 64) +
// 8 elements keep the fragment reads free of bank conflicts, for bf16 and
// for int8 fragments alike.
//
// The int8 modes at C = 192 use 227,328 - 37 KB of shared memory for the
// bf16 tiles and a ring of int8 slabs: there is no room for int8 copies of
// the activations beside the bf16 ones. Each GEMM input is consumed by its
// GEMM alone, so it is quantized in place: one warp per row reads the row's
// bf16 values into registers, takes their maximum, and writes the int8 row
// over the first half of the same bytes, and the row's scale to a 64-float
// array. An A fragment is then a plain 4-byte load, as fast as the bf16
// one, where quantizing fragments as they are loaded would redo each
// element's conversion for every output slab and warp column (36 times for
// qkv). The LN output is quantized inside LayerNorm; the attention context
// and the GELU output, whose row maxima need every head and every fc1 slab
// first, in a pass of their own after the phase that writes them
// (INT8_STATIC keeps that pass: its columns' scales need no maximum, but
// each row is read whole before it is overwritten, as in INT8).
//
// Bound on the H100 at 240 windows x 6 layers, C = 192: 86.1 G operations,
// 0.087 ms at 989 TF/s; x, out, weights and bias are ~13 MB, 0.004 ms. The
// bf16 design reads the weights from L2 once for two windows (0.64 GB a
// frame at C = 192) and the relative-position bias as its 225-entry tables
// through L1; the int8 design every block all weights (0.64 GB of int8)
// and every window the gathered 64 x 64 bias (0.28 GB, f32).
// WindowTransformer's 720p frame is 60 windows: one a block on 60 SMs.
#include "common.cuh"
#include "sm90.cuh"

#include <math.h>


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
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// bf16(acc) + bias in bf16 for a pair of outputs: the reference's two
// roundings.
__device__ __forceinline__ float2 dense_out(float v0, float v1, float2 bias) {
  const float2 r = round_bf16(v0, v1);
  return round_bf16(r.x + bias.x, r.y + bias.y);
}

// The residual x += product + bias at p, as x + (product + bias).
__device__ __forceinline__ void add_residual(bf16* p, float v0, float v1,
                                             float2 bias) {
  const float2 xv = ld2(p);
  const float2 d = dense_out(v0, v1, bias);
  st2(p, xv.x + d.x, xv.y + d.y);
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

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
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

__device__ __forceinline__ float erf_branchless(float x) {
  const float t = fabsf(x);
  const float s = x * x;
  float q = ERF_Q[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) q = fmaf(q, s, ERF_Q[k]);
  const float near = fmaf(q, x, x);
  const float u = fminf(t, 4.0f);
  float r = ERF_R[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) r = fmaf(r, u, ERF_R[k]);
  const float far = 1.0f - ex2_approx(fmaf(-(u * u), 1.4426950408889634f, r));
  return t <= 1.0f ? near : copysignf(far, x);
}

// The exact (erf) GELU, 0.5 h (1 + erf(h / sqrt 2)), in f32.
__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.0f + erf_branchless(h * 0.70710678118654752f));
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

// ==================================================== bf16: TMA + wgmma
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
  static constexpr int HEADS = C / HD;
  static constexpr int GROUPS = C / 64;  // head groups of 64 channels
  static constexpr int CHUNKS = 4 * C / 64;
  static constexpr int KT = C / 64;      // 64-wide K tiles of an N = 64 slab
  static constexpr int SLABS = 4 * GROUPS + 2 * CHUNKS;  // = 12 C / 64
  static constexpr int STAGE = C * 128;  // one slab: C rows of 64 bf16
  static constexpr int STAGES = C == 192 ? 3 : 6;
  static constexpr int XS = C + 8;       // residual row stride (elements)
  static constexpr int A_BYTES = KT * 8192;
  static constexpr int X_BYTES = NT * XS * 2;
  static constexpr int KV_BYTES = NT * KS * 2;
  static constexpr int WIN = A_BYTES + X_BYTES + 2 * KV_BYTES;
  static constexpr int VEC_BYTES = 13 * C * 2;  // a layer's vectors
  static constexpr int BYTES = 1024 + STAGES * STAGE + WG * WIN +
                               WG * 2 * VEC_BYTES + 2 * STAGES * 8;
  static_assert(WIN % 1024 == 0, "window regions keep 1024-byte alignment");
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

// The k16-step A fragments of a wgmma m64n64 accumulator's four 16-column
// blocks, fn(col, v0, v1) -> the pair as two bf16 (col within the chunk):
// the accumulator's pair layout is mma.m16n8k16's A layout.
template <typename F>
__device__ __forceinline__ void to_frags(uint32_t (&frag)[4][4],
                                         const float (&acc)[32], int t,
                                         F fn) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // k = 0: row g, cols 16 s + 2t; 1: row g + 8; 2, 3: cols + 8.
      const int jj = 2 * s + (k >> 1);
      const int i = k & 1;
      frag[s][k] =
          fn(8 * jj + 2 * t, acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
    }
}

// x[rows 16 warp + g (+8)] += the wgmma m64nC accumulator acc + bias, in
// the mode's association, eight column pairs at a time: their x values and
// biases are read before any of them is written.
template <int C, int MODE>
__device__ __forceinline__ void residual_rows(const float (&acc)[C / 2],
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
      x0[4 * j] = residual2<MODE>(xa[k], acc[4 * j], acc[4 * j + 1], bb[k]);
      x1[4 * j] = residual2<MODE>(xb[k], acc[4 * j + 2], acc[4 * j + 3],
                                  bb[k]);
    }
  }
}

// x, out (nW, 64, C) bf16; wmap: the slabs (layers x 12C/64 x C rows, 64)
// bf16, box (64, C), 128B swizzle; vpack (layers, 13C) bf16; tables
// (layers, C/16, 225) f32, each head's relative-position table. ``wpb``
// windows a block (1 or 2).
template <class K>
__global__ void __launch_bounds__(W_THREADS, 1)
window_trunk_kernel(const __grid_constant__ CUtensorMap wmap,
                    const bf16* __restrict__ x,
                    const bf16* __restrict__ vpack,
                    const float* __restrict__ tables,
                    bf16* __restrict__ out, int n_windows, int layers,
                    int wpb) {
  constexpr int C = K::C, XS = K::XS;
  using V = Vec<C>;
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
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned char* win = win_base + wg * K::WIN;
  unsigned char* a_tile = win;  // LN output, the SS products' A
  bf16* xs = reinterpret_cast<bf16*>(win + K::A_BYTES);
  bf16* kb = reinterpret_cast<bf16*>(win + K::A_BYTES + K::X_BYTES);
  bf16* vb = kb + NT * KS;
  Ring<K::STAGES> ring{ring_base, full, empty, K::STAGE, 0};

  // This warp's 16 rows of the window into x.
  const size_t wofs = size_t(w0 + wg) * NT * C;
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int r = 16 * warp + i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + r * XS + c) =
        *reinterpret_cast<const uint4*>(x + wofs + r * C + c);
  }
  // Each layer's vectors (LN scales and shifts, biases) into this
  // warpgroup's two buffers in turn: layer l + 1's once every warp has
  // passed layer l - 1 (the barrier after layer l's first LayerNorm).
  bf16* vecs = vec_base + wg * 2 * V::SIZE;
  const int wtid = tid & 127;
  auto load_vec = [&](int l) {
    const uint4* src = reinterpret_cast<const uint4*>(vpack + l * V::SIZE);
    uint4* dst = reinterpret_cast<uint4*>(vecs + (l & 1) * V::SIZE);
    for (int i = wtid; i < V::SIZE / 8; i += 128) dst[i] = src[i];
  };
  load_vec(0);
  S::named_sync(1 + wg, 128);

  float acc[32];
  float big[C / 2];  // proj, then fc2: all C outputs of the warpgroup's rows
  for (int l = 0; l < layers; ++l) {
    const bf16* vp = vecs + (l & 1) * V::SIZE;
    const float* tab_l = tables + size_t(l) * K::HEADS * TAB;

    layernorm_to_a<C>(xs, a_tile, vp + V::LN1S, vp + V::LN1B, warp, lane);
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
    if (l + 1 < layers) load_vec(l + 1);
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

  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int r = 16 * warp + i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(out + wofs + r * C + c) =
        *reinterpret_cast<const uint4*>(xs + r * XS + c);
  }
}

template <int C, int MODE>
int launch_bf16(const void* x, const void* wpack, const void* vpack,
                const void* tables, void* out, int n_windows, int layers,
                int device, cudaStream_t stream) {
  using K = WCfg<C, MODE>;
  static_assert(K::BYTES <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      window_trunk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::BYTES);
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  CUtensorMap wmap;
  const int rows = layers * K::SLABS * C;
  const int e = S::map_matrix(&wmap, wpack, rows, 64, C);
  if (e) return e;
  const int wpb = n_windows <= S::sm_count(device) ? 1 : WG;
  const int grid = (n_windows + wpb - 1) / wpb;
  window_trunk_kernel<K><<<grid, W_THREADS, K::BYTES, stream>>>(
      wmap, static_cast<const bf16*>(x), static_cast<const bf16*>(vpack),
      static_cast<const float*>(tables), static_cast<bf16*>(out), n_windows,
      layers, wpb);
  return int(cudaGetLastError());
}

// ================================= int8: mma.sync, cp.async weight ring
constexpr int SLAB_N = 64;   // outputs per weight slab
constexpr int I8_STAGES = 3; // slabs in the shared-memory ring
constexpr int THREADS = 256;

using tux::ld32;
using tux::mma_s8;

template <int C_, int MODE_>
struct Cfg {
  static constexpr int C = C_;
  static constexpr int MODE = MODE_;
  static constexpr bool ROWS = MODE == INT8;  // per-row activation scales
  static constexpr int HEADS = C / HD;
  static constexpr int XS = C + 8;       // row stride of the 64 x C tiles
  static constexpr int BS = 4 * C + 8;   // row stride of the 64 x 4C tile
  // A slab row: C int8 weights; in shared memory its stride is 16 bytes
  // longer.
  static constexpr int ROW_BYTES = C;
  static constexpr int WSB = ROW_BYTES + 16;
  static constexpr int SLABS = 12 * C / SLAB_N;
  // Offsets into a layer's packed weight scales (f32) and, in INT8_STATIC,
  // into its packed inverse activation scales (f32).
  static constexpr int S_QKV = 0, S_PROJ = 3 * C, S_FC1 = 4 * C,
                       S_FC2 = 8 * C, SW = 9 * C;
  static constexpr int I_QKV = 0, I_PROJ = C, I_FC1 = 2 * C, I_FC2 = 3 * C,
                       IA = 7 * C;
  static constexpr size_t TILE_BYTES =
      size_t(2 * NT * XS + NT * BS) * sizeof(bf16);
  static constexpr size_t SMEM_BYTES =
      TILE_BYTES + size_t(I8_STAGES) * SLAB_N * WSB +
      (ROWS ? NT * sizeof(float) : 0);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row scale of the rowwise int8 mode and the pair a * inv, b * inv
// rounded half to even into two int8 at p (trunk2.py:176-178). 1/127 is
// the f32 value of the double 1/127, as the reference's weakly typed
// constant; 1 / srow is a correctly rounded f32 division.
__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(absmax, 1e-6f) * float(1.0 / 127.0);
}
__device__ __forceinline__ void st_q2(int8_t* p, float a, float b, float inv) {
  *reinterpret_cast<char2*>(p) = make_char2(
      static_cast<signed char>(__float2int_rn(a * inv)),
      static_cast<signed char>(__float2int_rn(b * inv)));
}
// The pair a * ia.x, b * ia.y rounded half to even and clipped to +-127 into
// two int8 at p (trunk2.py:182).
__device__ __forceinline__ int8_t q_clip(float v) {
  return static_cast<int8_t>(max(-127, min(127, __float2int_rn(v))));
}
__device__ __forceinline__ void st_q2s(int8_t* p, float a, float b,
                                       float2 ia) {
  *reinterpret_cast<char2*>(p) =
      make_char2(q_clip(__fmul_rn(a, ia.x)), q_clip(__fmul_rn(b, ia.y)));
}
__device__ __forceinline__ float2 ld_ia(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
// The flat sequence of weight slabs, fetched I8_STAGES - 1 ahead into a
// ring.
template <class K>
struct WeightStream {
  const unsigned char* src;  // (total, 64, C) weights in device memory
  unsigned char* ring;       // I8_STAGES slabs of 64 rows, stride K::WSB
  int total, fetched, used, tid;

  // Start the copy of the next slab; past the end, commit an empty group so
  // that the group count stays one per call.
  __device__ __forceinline__ void prefetch() {
    constexpr int CHUNKS = K::ROW_BYTES / 16;
    if (fetched < total) {
      unsigned char* dst = ring + (fetched % I8_STAGES) * SLAB_N * K::WSB;
      const unsigned char* s = src + size_t(fetched) * SLAB_N * K::ROW_BYTES;
      for (int i = tid; i < SLAB_N * CHUNKS; i += THREADS) {
        const int r = i / CHUNKS;
        const int c = i % CHUNKS;
        cp_async16(dst + r * K::WSB + c * 16, s + r * K::ROW_BYTES + c * 16);
      }
    }
    cp_async_commit();
    ++fetched;
  }
  // The slab to consume now. Waits for this thread's copies of it, then
  // synchronizes the block: every thread's copies have landed, what the
  // previous phase wrote to shared memory is published, and every warp is
  // done with the slab before this one, whose place in the ring the next
  // fetch takes.
  __device__ __forceinline__ const unsigned char* acquire() {
    cp_async_wait<I8_STAGES - 2>();
    __syncthreads();
    prefetch();
    return ring + (used++ % I8_STAGES) * SLAB_N * K::WSB;
  }
};

// acc += A[64 x C] . slab^T in int8 for this warp's 32 x 16 tile: ``a``
// points at the first of the C quantized input columns, row stride ``sa``
// bytes; ``slab`` at the slab, [64 outputs][C inputs], row stride K::WSB
// bytes.
template <class K>
__device__ __forceinline__ void mma_slab(int (&acc)[2][2][4], const int8_t* a,
                                         int sa, const unsigned char* slab,
                                         int wm, int wn, int g, int t) {
  const int8_t* w = reinterpret_cast<const int8_t*>(slab);
  const int8_t* a0 = a + (32 * wm + g) * sa + 4 * t;
  const int8_t* w0 = w + (16 * wn + g) * K::WSB + 4 * t;
#pragma unroll
  for (int kk = 0; kk < K::C / 32; ++kk) {
    uint32_t af[2][4], bfr[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int8_t* r0 = a0 + (16 * f) * sa + kk * 32;
      const int8_t* r8 = r0 + 8 * sa;
      af[f][0] = ld32(r0);
      af[f][1] = ld32(r8);
      af[f][2] = ld32(r0 + 16);
      af[f][3] = ld32(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int8_t* c0 = w0 + 8 * j * K::WSB + kk * 32;
      bfr[j][0] = ld32(c0);
      bfr[j][1] = ld32(c0 + 16);
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_s8(acc[f][j], af[f][0], af[f][1], af[f][2], af[f][3], bfr[j][0],
               bfr[j][1]);
  }
}

__device__ __forceinline__ void zero(int (&acc)[2][2][4]) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;
}

// Calls fn(row, col, v0, v1) for each adjacent pair of this thread's
// accumulators, as the f32 products; (row, col) are within the slab's
// 64 x 64 output. An int32 accumulator becomes (float(acc) * srow[row]) *
// sw[col] with row scales (ROWS), else float(acc) * sw[col].
template <bool ROWS, typename F>
__device__ __forceinline__ void for_each_pair(const int (&acc)[2][2][4],
                                              const float* srow,
                                              const float* sw, int wm, int wn,
                                              int g, int t, F fn) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 32 * wm + 16 * f + g + 8 * hh;
        const int c = 16 * wn + 8 * j + 2 * t;
        const float2 w = *reinterpret_cast<const float2*>(sw + c);
        float v0 = __int2float_rn(acc[f][j][2 * hh]);
        float v1 = __int2float_rn(acc[f][j][2 * hh + 1]);
        if constexpr (ROWS) {
          const float s = srow[r];
          v0 *= s;
          v1 *= s;
        }
        fn(r, c, v0 * w.x, v1 * w.y);
      }
}

// ys = LN(xs) quantized: one warp per row, C / 32 channels per lane; ys
// receives the int8 values (row stride 2 XS bytes) and, in INT8, srow the
// row's scale; INT8_STATIC quantizes with the columns' inverse scales ia.
template <class K>
__device__ __forceinline__ void layernorm(const bf16* xs, bf16* ys,
                                          float* srow, const bf16* scale,
                                          const bf16* shift, const float* ia,
                                          int warp, int lane) {
  constexpr int P = K::C / 64;  // pairs per lane
  float2 sc[P], sh[P];
  ln_params<K::C>(sc, sh, scale, shift, lane);
  for (int r = warp; r < NT; r += THREADS / 32) {
    float2 rows[1][P];
    float2 (&v)[P] = rows[0];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = ld2(xs + r * K::XS + 2 * lane + 64 * j);
    layernorm_rows<K::C, 1>(rows, sc, sh);
    int8_t* q = reinterpret_cast<int8_t*>(ys + r * K::XS);
    if constexpr (K::ROWS) {
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j)
        m = fmaxf(m, fmaxf(fabsf(v[j].x), fabsf(v[j].y)));
      const float sr = row_scale(warp_max(m));
      const float inv = 1.0f / sr;
#pragma unroll
      for (int j = 0; j < P; ++j)
        st_q2(q + 2 * lane + 64 * j, v[j].x, v[j].y, inv);
      if (lane == 0) srow[r] = sr;
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int col = 2 * lane + 64 * j;
        st_q2s(q + col, v[j].x, v[j].y, ld_ia(ia + col));
      }
    }
  }
}

// In place, each of the 64 rows of ``buf`` (KW bf16 values, row stride
// ``stride`` elements) becomes KW int8 values over the first half of its
// bytes, and srow[row] its scale (ROWS), or each column quantized with its
// inverse scale ia[col]: one warp per row, which holds the whole row in
// registers before any lane writes.
template <int KW, bool ROWS>
__device__ __forceinline__ void quantize_rows(bf16* buf, int stride,
                                              float* srow, const float* ia,
                                              int warp, int lane) {
  constexpr int P = KW / 64;
  for (int r = warp; r < NT; r += THREADS / 32) {
    bf16* row = buf + r * stride;
    float2 v[P];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      v[j] = ld2(row + 2 * lane + 64 * j);
      m = fmaxf(m, fmaxf(fabsf(v[j].x), fabsf(v[j].y)));
    }
    int8_t* q = reinterpret_cast<int8_t*>(row);
    if constexpr (ROWS) {
      const float sr = row_scale(warp_max(m));
      const float inv = 1.0f / sr;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < P; ++j)
        st_q2(q + 2 * lane + 64 * j, v[j].x, v[j].y, inv);
      if (lane == 0) srow[r] = sr;
    } else {
      __syncwarp();
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int col = 2 * lane + 64 * j;
        st_q2s(q + col, v[j].x, v[j].y, ld_ia(ia + col));
      }
    }
  }
}

// ctx (into ys) = softmax(q k^T / 4 + bias) v per head, from qkv in ``big``
// (q at columns 0.., k at C.., v at 2C..). One unit of work is one head and
// 16 query rows; 4 HEADS units over 8 warps.
template <class K>
__device__ __forceinline__ void attention(const bf16* big, bf16* ys,
                                          const float* bias_l, int warp, int g,
                                          int t) {
  constexpr int C = K::C, BS = K::BS, XS = K::XS;
  for (int u = warp; u < K::HEADS * (NT / 16); u += THREADS / 32) {
    const int h = u >> 2;
    const int r0 = 16 * (u & 3);
    uint32_t aq[4];
    const bf16* q0 = big + (r0 + g) * BS + h * HD;
    tux::load_a(aq, q0, q0 + 8 * BS, t);
    float s[8][4];
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
      uint32_t bk[2];
      tux::load_b(bk, big + (8 * nf + g) * BS + C + h * HD, t);
      tux::mma_bf16(s[nf], aq[0], aq[1], aq[2], aq[3], bk[0], bk[1]);
    }
    // Rows r0 + g (elements 0, 1) and r0 + g + 8 (elements 2, 3).
    const float* b0 = bias_l + (size_t(h) * NT + r0 + g) * NT + 2 * t;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      const float2 ba = *reinterpret_cast<const float2*>(b0 + 8 * nf);
      const float2 bb = *reinterpret_cast<const float2*>(b0 + 8 * NT + 8 * nf);
      s[nf][0] = s[nf][0] * 0.25f + ba.x;
      s[nf][1] = s[nf][1] * 0.25f + ba.y;
      s[nf][2] = s[nf][2] * 0.25f + bb.x;
      s[nf][3] = s[nf][3] * 0.25f + bb.y;
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
    // P.V: two adjacent score fragments are one A fragment of 16 keys.
    float ctx[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ap[4];
      ap[0] = pack2(s[2 * kk][0] * d0, s[2 * kk][1] * d0);
      ap[1] = pack2(s[2 * kk][2] * d1, s[2 * kk][3] * d1);
      ap[2] = pack2(s[2 * kk + 1][0] * d0, s[2 * kk + 1][1] * d0);
      ap[3] = pack2(s[2 * kk + 1][2] * d1, s[2 * kk + 1][3] * d1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B[k][n] = v[key 16 kk + k][dim 8 j + n]: keys run down the rows of
        // ``big``, so the pairs along k are gathered from two rows.
        const bf16* v0 =
            big + (16 * kk + 2 * t) * BS + 2 * C + h * HD + 8 * j + g;
        uint32_t bv[2];
        bv[0] = pack_raw(v0[0], v0[BS]);
        bv[1] = pack_raw(v0[8 * BS], v0[9 * BS]);
        tux::mma_bf16(ctx[j], ap[0], ap[1], ap[2], ap[3], bv[0], bv[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bf16* c0 = ys + (r0 + g) * XS + h * HD + 8 * j + 2 * t;
      st2(c0, ctx[j][0], ctx[j][1]);
      st2(c0 + 8 * XS, ctx[j][2], ctx[j][3]);
    }
  }
}

// x, out (nW, 64, C) bf16; wpack (layers, 12C/64, 64, C) int8; vpack
// (layers, 13C) bf16; bias (layers, C/16, 64, 64) f32; swpack (layers, 9C)
// f32 (qkv, proj, fc1, fc2 side by side); iapack (layers, 7C) f32 in
// INT8_STATIC (the same order), else unused.
template <class K>
__global__ void __launch_bounds__(THREADS, 1)
window_trunk_i8_kernel(const bf16* __restrict__ x,
                       const unsigned char* __restrict__ wpack,
                       const bf16* __restrict__ vpack,
                       const float* __restrict__ bias,
                       const float* __restrict__ swpack,
                       const float* __restrict__ iapack,
                       bf16* __restrict__ out, int layers) {
  constexpr int C = K::C, XS = K::XS, BS = K::BS;
  using V = Vec<C>;
  // The GEMM inputs: the int8 rows quantized over the bf16 tiles.
  constexpr int ASX = 2 * XS;  // row strides in bytes
  constexpr int ASB = 2 * BS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // residual stream
  bf16* ys = xs + NT * XS;                   // LN output, then context
  bf16* big = ys + NT * XS;                  // qkv, then the MLP hidden
  unsigned char* ring = smem + K::TILE_BYTES;
  float* srow = reinterpret_cast<float*>(ring + I8_STAGES * SLAB_N * K::WSB);
  const int8_t* ya = reinterpret_cast<const int8_t*>(ys);
  const int8_t* ba = reinterpret_cast<const int8_t*>(big);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;

  WeightStream<K> ws{wpack, ring, layers * K::SLABS, 0, 0, tid};
  for (int i = 0; i < I8_STAGES - 1; ++i) ws.prefetch();

  const bf16* xw = x + size_t(blockIdx.x) * NT * C;
  for (int i = tid; i < NT * (C / 8); i += THREADS) {
    const int r = i / (C / 8);
    const int c = i % (C / 8);
    *reinterpret_cast<uint4*>(xs + r * XS + c * 8) =
        *reinterpret_cast<const uint4*>(xw + r * C + c * 8);
  }

  int acc[2][2][4];
  for (int l = 0; l < layers; ++l) {
    const bf16* vp = vpack + size_t(l) * V::SIZE;
    const float* sw = swpack + size_t(l) * K::SW;
    const float* ia = iapack + size_t(l) * K::IA;  // read in INT8_STATIC only

    // Each phase that reads what a GEMM's epilogues wrote starts behind a
    // barrier; a GEMM's first acquire() is the barrier after the others.
    __syncthreads();
    layernorm<K>(xs, ys, srow, vp + V::LN1S, vp + V::LN1B, ia + K::I_QKV,
                 warp, lane);
#pragma unroll 1
    for (int nc = 0; nc < 3 * C / SLAB_N; ++nc) {  // qkv -> big
      const unsigned char* w = ws.acquire();
      zero(acc);
      mma_slab<K>(acc, ya, ASX, w, wm, wn, g, t);
      const bf16* b = vp + V::QKVB + nc * SLAB_N;
      bf16* dst = big + nc * SLAB_N;
      for_each_pair<K::ROWS>(acc, srow, sw + K::S_QKV + nc * SLAB_N, wm, wn,
                             g, t, [&](int r, int c, float v0, float v1) {
                               const float2 d = dense_out(v0, v1, ld2(b + c));
                               st2(dst + r * BS + c, d.x, d.y);
                             });
    }

    __syncthreads();
    attention<K>(big, ys, bias + size_t(l) * K::HEADS * NT * NT, warp, g, t);
    __syncthreads();
    quantize_rows<C, K::ROWS>(ys, XS, srow, ia + K::I_PROJ, warp, lane);

#pragma unroll 1
    for (int nc = 0; nc < C / SLAB_N; ++nc) {  // proj, residual -> xs
      const unsigned char* w = ws.acquire();
      zero(acc);
      mma_slab<K>(acc, ya, ASX, w, wm, wn, g, t);
      const bf16* b = vp + V::PROJB + nc * SLAB_N;
      bf16* dst = xs + nc * SLAB_N;
      for_each_pair<K::ROWS>(acc, srow, sw + K::S_PROJ + nc * SLAB_N, wm, wn,
                             g, t, [&](int r, int c, float v0, float v1) {
                               add_residual(dst + r * XS + c, v0, v1,
                                            ld2(b + c));
                             });
    }

    __syncthreads();
    layernorm<K>(xs, ys, srow, vp + V::LN2S, vp + V::LN2B, ia + K::I_FC1,
                 warp, lane);
#pragma unroll 1
    for (int nc = 0; nc < 4 * C / SLAB_N; ++nc) {  // fc1, GELU -> big
      const unsigned char* w = ws.acquire();
      zero(acc);
      mma_slab<K>(acc, ya, ASX, w, wm, wn, g, t);
      const bf16* b = vp + V::FC1B + nc * SLAB_N;
      bf16* dst = big + nc * SLAB_N;
      for_each_pair<K::ROWS>(acc, srow, sw + K::S_FC1 + nc * SLAB_N, wm, wn,
                             g, t, [&](int r, int c, float v0, float v1) {
                               const float2 d = dense_out(v0, v1, ld2(b + c));
                               st2(dst + r * BS + c, gelu_erf(d.x),
                                   gelu_erf(d.y));
                             });
    }
    __syncthreads();
    quantize_rows<4 * C, K::ROWS>(big, BS, srow, ia + K::I_FC2, warp, lane);

#pragma unroll 1
    for (int nc = 0; nc < C / SLAB_N; ++nc) {  // fc2, residual -> xs
      zero(acc);
#pragma unroll 1
      for (int kc = 0; kc < 4; ++kc) {
        const unsigned char* w = ws.acquire();
        mma_slab<K>(acc, ba + kc * C, ASB, w, wm, wn, g, t);
        if (kc == 3) {
          const bf16* b = vp + V::FC2B + nc * SLAB_N;
          bf16* dst = xs + nc * SLAB_N;
          for_each_pair<K::ROWS>(
              acc, srow, sw + K::S_FC2 + nc * SLAB_N, wm, wn, g, t,
              [&](int r, int c, float v0, float v1) {
                add_residual(dst + r * XS + c, v0, v1, ld2(b + c));
              });
        }
      }
    }
  }

  __syncthreads();
  bf16* ow = out + size_t(blockIdx.x) * NT * C;
  for (int i = tid; i < NT * (C / 8); i += THREADS) {
    const int r = i / (C / 8);
    const int c = i % (C / 8);
    *reinterpret_cast<uint4*>(ow + r * C + c * 8) =
        *reinterpret_cast<const uint4*>(xs + r * XS + c * 8);
  }
}

template <int MODE>
int launch_i8(const void* x, const void* wpack, const void* vpack,
              const void* bias, const void* swpack, const void* iapack,
              void* out, int n_windows, int layers, cudaStream_t stream) {
  using K = Cfg<192, MODE>;
  static_assert(K::SMEM_BYTES <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      window_trunk_i8_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(K::SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  window_trunk_i8_kernel<K><<<n_windows, THREADS, K::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned char*>(wpack),
      static_cast<const bf16*>(vpack), static_cast<const float*>(bias),
      static_cast<const float*>(swpack), static_cast<const float*>(iapack),
      static_cast<bf16*>(out), layers);
  return int(cudaGetLastError());
}

}  // namespace

// dim 128 or 192; mode 0 (V2), 1 (V1) or, at dim 192, 2 (INT8) or 3
// (INT8_STATIC). In modes 0 and 1 wpack holds the bf16 slabs (layers x
// 12C/64 x C rows, 64) and bias the relative-position tables (layers,
// C/16, 225) f32; in the int8 modes the int8 slabs (layers, 12C/64, 64, C)
// and the gathered bias (layers, C/16, 64, 64) f32. swpack and iapack are
// read in the int8 modes only. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int tux_window_trunk(const void* x, const void* wpack,
                                const void* vpack, const void* bias,
                                const void* swpack, const void* iapack,
                                void* out, int n_windows, int layers, int dim,
                                int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dim * 4 + mode) {
    case 128 * 4 + V2:
      return launch_bf16<128, V2>(x, wpack, vpack, bias, out, n_windows,
                                  layers, device, st);
    case 128 * 4 + V1:
      return launch_bf16<128, V1>(x, wpack, vpack, bias, out, n_windows,
                                  layers, device, st);
    case 192 * 4 + V2:
      return launch_bf16<192, V2>(x, wpack, vpack, bias, out, n_windows,
                                  layers, device, st);
    case 192 * 4 + V1:
      return launch_bf16<192, V1>(x, wpack, vpack, bias, out, n_windows,
                                  layers, device, st);
    case 192 * 4 + INT8:
      return launch_i8<INT8>(x, wpack, vpack, bias, swpack, iapack, out,
                             n_windows, layers, st);
    case 192 * 4 + INT8_STATIC:
      return launch_i8<INT8_STATIC>(x, wpack, vpack, bias, swpack, iapack,
                                    out, n_windows, layers, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
