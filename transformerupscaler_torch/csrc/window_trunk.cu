// Fused window-transformer trunk for Hopper (sm_90a): every window block of
// the model in one kernel, one thread block per window of 64 tokens.
//
// Replaces transformerupscaler_tpu/ops/pallas/trunk2.py:524
// fused_window_trunk_v2 and transformerupscaler_tpu/ops/pallas/trunk.py:128
// fused_window_trunk. The first has five kernel bodies (_trunk2_kernel :51,
// _trunk2_pair_kernel :105, _trunk2_pair_chunked_kernel :255,
// _trunk2_group_kernel :335, _trunk2_pair_truedot_kernel :432) which tile one
// arithmetic in five ways to fill 128-lane MXU tiles (head masks, window
// pairing, block-diagonal key matrices, a ones-matmul softmax denominator,
// padding of the window count). None of that is carried over: this one kernel
// computes per-head products directly and answers for all of them, at model
// width C = 128 (8 heads) or 192 (12 heads), in four modes chosen at compile
// time.
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
//                                      one rounding
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
// Design. Shared memory holds the residual stream x (64 x C), the LN
// output / attention context (64 x C) and one 64 x 4C buffer used for qkv
// (64 x 3C) and then for the MLP hidden: no intermediate goes to device
// memory. The weights (0.885 MB a layer at C = 192) cannot live in shared
// memory; they arrive pre-cut into slabs of [64 outputs][C inputs] in the
// order the kernel consumes them (12C/64 a layer: qkv 3C/64, proj C/64, fc1
// 4C/64, fc2 C/64 output chunks x 4 input chunks), and a three-slab ring is
// filled with cp.async two slabs ahead of the mma.sync products, also across
// the LN and attention phases. The 8 warps tile a slab's 64 x 64 output as
// 2 x 4 warp tiles of 32 x 16. Attention runs flash-style per (head, 16 query
// rows): the 16 x 64 scores stay in registers, the row statistics come from
// quad shuffles, and the probabilities feed P.V straight from the accumulator
// registers. Row strides of (multiple of 64) + 8 elements keep the fragment
// reads free of bank conflicts, for bf16 and for int8 fragments alike.
//
// INT8 (and INT8_STATIC) at C = 192 uses 227,328 - 37 KB of shared memory for
// the bf16 tiles
// and a ring of int8 slabs: there is no room for int8 copies of the
// activations beside the bf16 ones. Each GEMM input is consumed by its GEMM
// alone, so it is quantized in place: one warp per row reads the row's bf16
// values into registers, takes their maximum, and writes the int8 row over
// the first half of the same bytes, and the row's scale to a 64-float array.
// An A fragment is then a plain 4-byte load, as fast as the bf16 one, where
// quantizing fragments as they are loaded would redo each element's
// conversion for every output slab and warp column (36 times for qkv). The
// LN output is quantized inside LayerNorm; the attention context and the
// GELU output, whose row maxima need every head and every fc1 slab first, in
// a pass of their own after the phase that writes them (INT8_STATIC keeps
// that pass: its columns' scales need no maximum, but each row is read whole
// before it is overwritten, as in INT8).
//
// Bound on the H100 at 240 windows x 6 layers, C = 192: 86.1 G operations,
// 0.087 ms at 989 TF/s; x, out, weights and bias are ~13 MB, 0.004 ms. Every
// block streams all weights from L2 (1.27 GB in total), which bounds this
// design near 0.25 ms; sharing slabs across a cluster with TMA multicast and
// wgmma are later work (see PERF.md). WindowTransformer's 720p frame is 60
// windows: 60 of 132 SMs hold a block.
#include "common.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int NT = 64;       // tokens per window
constexpr int HD = 16;       // head width
constexpr int SLAB_N = 64;   // outputs per weight slab
constexpr int STAGES = 3;    // slabs in the shared-memory ring
constexpr int THREADS = 256;
enum Mode { V2 = 0, V1 = 1, INT8 = 2, INT8_STATIC = 3 };

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using tux::ld32;
using tux::mma_s8;

template <int C_, int MODE_>
struct Cfg {
  static constexpr int C = C_;
  static constexpr int MODE = MODE_;
  static constexpr bool I8 = MODE == INT8 || MODE == INT8_STATIC;
  static constexpr bool ROWS = MODE == INT8;  // per-row activation scales
  static constexpr int HEADS = C / HD;
  static constexpr int XS = C + 8;       // row stride of the 64 x C tiles
  static constexpr int BS = 4 * C + 8;   // row stride of the 64 x 4C tile
  // A slab row: C weights of 2 bytes (bf16) or 1 (int8); in shared memory
  // its stride is 16 bytes longer.
  static constexpr int ROW_BYTES = I8 ? C : 2 * C;
  static constexpr int WSB = ROW_BYTES + 16;
  static constexpr int SLABS = 12 * C / SLAB_N;
  // Offsets into a layer's packed vectors (bf16 elements), in the int8 modes
  // into its packed weight scales (f32) and, in INT8_STATIC, into its packed
  // inverse activation scales (f32).
  static constexpr int V_LN1S = 0, V_LN1B = C, V_QKVB = 2 * C,
                       V_PROJB = 5 * C, V_LN2S = 6 * C, V_LN2B = 7 * C,
                       V_FC1B = 8 * C, V_FC2B = 12 * C, VEC = 13 * C;
  static constexpr int S_QKV = 0, S_PROJ = 3 * C, S_FC1 = 4 * C,
                       S_FC2 = 8 * C, SW = 9 * C;
  static constexpr int I_QKV = 0, I_PROJ = C, I_FC1 = 2 * C, I_FC2 = 3 * C,
                       IA = 7 * C;
  static constexpr size_t TILE_BYTES =
      size_t(2 * NT * XS + NT * BS) * sizeof(bf16);
  static constexpr size_t SMEM_BYTES =
      TILE_BYTES + size_t(STAGES) * SLAB_N * WSB +
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
__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The flat sequence of weight slabs, fetched STAGES - 1 ahead into a ring.
template <class K>
struct WeightStream {
  const unsigned char* src;  // (total, 64, C) weights in device memory
  unsigned char* ring;       // STAGES slabs of 64 rows, stride K::WSB bytes
  int total, fetched, used, tid;

  // Start the copy of the next slab; past the end, commit an empty group so
  // that the group count stays one per call.
  __device__ __forceinline__ void prefetch() {
    constexpr int CHUNKS = K::ROW_BYTES / 16;
    if (fetched < total) {
      unsigned char* dst = ring + (fetched % STAGES) * SLAB_N * K::WSB;
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
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    prefetch();
    return ring + (used++ % STAGES) * SLAB_N * K::WSB;
  }
};

// acc += A[64 x C] . slab^T for this warp's 32 x 16 tile. ``a`` points at
// the first of the C input columns, row stride ``sa`` elements; ``slab`` at
// the slab, [64 outputs][C inputs], row stride K::WSB bytes.
template <class K>
__device__ __forceinline__ void mma_slab(float (&acc)[2][2][4], const bf16* a,
                                         int sa, const unsigned char* slab,
                                         int wm, int wn, int g, int t) {
  constexpr int WS = K::WSB / 2;
  const bf16* w = reinterpret_cast<const bf16*>(slab);
  const bf16* a0 = a + (32 * wm + g) * sa;
  const bf16* w0 = w + (16 * wn + g) * WS;
#pragma unroll
  for (int kk = 0; kk < K::C / 16; ++kk) {
    uint32_t af[2][4], bfr[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
      tux::load_a(af[f], a0 + (16 * f) * sa + kk * 16,
                  a0 + (16 * f + 8) * sa + kk * 16, t);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      tux::load_b(bfr[j], w0 + 8 * j * WS + kk * 16, t);
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tux::mma_bf16(acc[f][j], af[f][0], af[f][1], af[f][2], af[f][3],
                      bfr[j][0], bfr[j][1]);
  }
}

// The same in int8: ``a`` is the quantized rows, row stride ``sa`` bytes.
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

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[2][2][4]) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = T(0);
}

// Calls fn(row, col, v0, v1) for each adjacent pair of this thread's
// accumulators, as the f32 products; (row, col) are within the slab's
// 64 x 64 output. An int32 accumulator becomes (float(acc) * srow[row]) *
// sw[col] with row scales (ROWS), else float(acc) * sw[col].
template <bool ROWS, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[2][2][4],
                                              const float*, const float*,
                                              int wm, int wn, int g, int t,
                                              F fn) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        fn(32 * wm + 16 * f + g + 8 * hh, 16 * wn + 8 * j + 2 * t,
           acc[f][j][2 * hh], acc[f][j][2 * hh + 1]);
}
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

// bf16(acc) + bias in bf16 for a pair of outputs: the reference's two
// roundings.
__device__ __forceinline__ float2 dense_out(float v0, float v1, float2 bias) {
  const float2 r = round_bf16(v0, v1);
  return round_bf16(r.x + bias.x, r.y + bias.y);
}

// The residual x += product + bias at p, in the mode's association.
template <int MODE>
__device__ __forceinline__ void add_residual(bf16* p, float v0, float v1,
                                             float2 bias) {
  const float2 xv = ld2(p);
  if constexpr (MODE == V1) {
    const float2 r = round_bf16(v0, v1);
    const float2 s = round_bf16(xv.x + r.x, xv.y + r.y);
    st2(p, s.x + bias.x, s.y + bias.y);
  } else {
    const float2 d = dense_out(v0, v1, bias);
    st2(p, xv.x + d.x, xv.y + d.y);
  }
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// ys = bf16(LN(xs)): one warp per row, C / 32 channels per lane. In the int8
// modes the row is quantized as well: ys receives its int8 values (row stride
// 2 XS bytes) and, in INT8, srow its scale; INT8_STATIC quantizes with the
// columns' inverse scales ia.
template <class K>
__device__ __forceinline__ void layernorm(const bf16* xs, bf16* ys,
                                          float* srow, const bf16* scale,
                                          const bf16* shift, const float* ia,
                                          int warp, int lane) {
  constexpr int P = K::C / 64;  // pairs per lane
  for (int r = warp; r < NT; r += THREADS / 32) {
    const bf16* xr = xs + r * K::XS;
    float2 v[P];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      v[j] = ld2(xr + 2 * lane + 64 * j);
      s += v[j].x + v[j].y;
      ss += v[j].x * v[j].x + v[j].y * v[j].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / float(K::C);
    const float var = ss / float(K::C) - mu * mu;
    const float rstd = rsqrtf(var + 1e-5f);
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int col = 2 * lane + 64 * j;
      const float2 sc = ld2(scale + col);
      const float2 sh = ld2(shift + col);
      v[j] = round_bf16((v[j].x - mu) * rstd * sc.x + sh.x,
                        (v[j].y - mu) * rstd * sc.y + sh.y);
      m = fmaxf(m, fmaxf(fabsf(v[j].x), fabsf(v[j].y)));
      if constexpr (!K::I8) st2(ys + r * K::XS + col, v[j].x, v[j].y);
    }
    if constexpr (K::I8) {
      int8_t* q = reinterpret_cast<int8_t*>(ys + r * K::XS);
      if constexpr (K::ROWS) {
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

// x, out (nW, 64, C) bf16; wpack (layers, 12C/64, 64, C) bf16, int8 in the
// int8 modes; vpack (layers, 13C) bf16; bias (layers, C/16, 64, 64) f32;
// swpack (layers, 9C) f32 in the int8 modes (qkv, proj, fc1, fc2 side by
// side), else unused; iapack (layers, 7C) f32 in INT8_STATIC (the same
// order), else unused.
template <class K>
__global__ void __launch_bounds__(THREADS, 1)
window_trunk_kernel(const bf16* __restrict__ x,
                    const unsigned char* __restrict__ wpack,
                    const bf16* __restrict__ vpack,
                    const float* __restrict__ bias,
                    const float* __restrict__ swpack,
                    const float* __restrict__ iapack, bf16* __restrict__ out,
                    int layers) {
  constexpr int C = K::C, XS = K::XS, BS = K::BS;
  // The GEMM inputs: bf16 tiles, or the int8 rows quantized over them.
  using A = std::conditional_t<K::I8, int8_t, bf16>;
  using Acc = std::conditional_t<K::I8, int, float>;
  constexpr int ASX = K::I8 ? 2 * XS : XS;  // row strides in A elements
  constexpr int ASB = K::I8 ? 2 * BS : BS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // residual stream
  bf16* ys = xs + NT * XS;                   // LN output, then context
  bf16* big = ys + NT * XS;                  // qkv, then the MLP hidden
  unsigned char* ring = smem + K::TILE_BYTES;
  float* srow = reinterpret_cast<float*>(ring + STAGES * SLAB_N * K::WSB);
  const A* ya = reinterpret_cast<const A*>(ys);
  const A* ba = reinterpret_cast<const A*>(big);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;

  WeightStream<K> ws{wpack, ring, layers * K::SLABS, 0, 0, tid};
  for (int i = 0; i < STAGES - 1; ++i) ws.prefetch();

  const bf16* xw = x + size_t(blockIdx.x) * NT * C;
  for (int i = tid; i < NT * (C / 8); i += THREADS) {
    const int r = i / (C / 8);
    const int c = i % (C / 8);
    *reinterpret_cast<uint4*>(xs + r * XS + c * 8) =
        *reinterpret_cast<const uint4*>(xw + r * C + c * 8);
  }

  Acc acc[2][2][4];
  for (int l = 0; l < layers; ++l) {
    const bf16* vp = vpack + size_t(l) * K::VEC;
    const float* sw = swpack + size_t(l) * K::SW;  // read in int8 modes only
    const float* ia = iapack + size_t(l) * K::IA;  // read in INT8_STATIC only

    // Each phase that reads what a GEMM's epilogues wrote starts behind a
    // barrier; a GEMM's first acquire() is the barrier after the others.
    __syncthreads();
    layernorm<K>(xs, ys, srow, vp + K::V_LN1S, vp + K::V_LN1B, ia + K::I_QKV,
                 warp, lane);
#pragma unroll 1
    for (int nc = 0; nc < 3 * C / SLAB_N; ++nc) {  // qkv -> big
      const unsigned char* w = ws.acquire();
      zero(acc);
      mma_slab<K>(acc, ya, ASX, w, wm, wn, g, t);
      const bf16* b = vp + K::V_QKVB + nc * SLAB_N;
      bf16* dst = big + nc * SLAB_N;
      for_each_pair<K::ROWS>(acc, srow, sw + K::S_QKV + nc * SLAB_N, wm, wn,
                             g, t, [&](int r, int c, float v0, float v1) {
                               const float2 d = dense_out(v0, v1, ld2(b + c));
                               st2(dst + r * BS + c, d.x, d.y);
                             });
    }

    __syncthreads();
    attention<K>(big, ys, bias + size_t(l) * K::HEADS * NT * NT, warp, g, t);
    if constexpr (K::I8) {
      __syncthreads();
      quantize_rows<C, K::ROWS>(ys, XS, srow, ia + K::I_PROJ, warp, lane);
    }

#pragma unroll 1
    for (int nc = 0; nc < C / SLAB_N; ++nc) {  // proj, residual -> xs
      const unsigned char* w = ws.acquire();
      zero(acc);
      mma_slab<K>(acc, ya, ASX, w, wm, wn, g, t);
      const bf16* b = vp + K::V_PROJB + nc * SLAB_N;
      bf16* dst = xs + nc * SLAB_N;
      for_each_pair<K::ROWS>(acc, srow, sw + K::S_PROJ + nc * SLAB_N, wm, wn,
                             g, t, [&](int r, int c, float v0, float v1) {
                               add_residual<K::MODE>(dst + r * XS + c, v0, v1,
                                                     ld2(b + c));
                             });
    }

    __syncthreads();
    layernorm<K>(xs, ys, srow, vp + K::V_LN2S, vp + K::V_LN2B, ia + K::I_FC1,
                 warp, lane);
#pragma unroll 1
    for (int nc = 0; nc < 4 * C / SLAB_N; ++nc) {  // fc1, GELU -> big
      const unsigned char* w = ws.acquire();
      zero(acc);
      mma_slab<K>(acc, ya, ASX, w, wm, wn, g, t);
      const bf16* b = vp + K::V_FC1B + nc * SLAB_N;
      bf16* dst = big + nc * SLAB_N;
      for_each_pair<K::ROWS>(acc, srow, sw + K::S_FC1 + nc * SLAB_N, wm, wn,
                             g, t, [&](int r, int c, float v0, float v1) {
                               const float2 d = dense_out(v0, v1, ld2(b + c));
                               st2(dst + r * BS + c, gelu_erf(d.x),
                                   gelu_erf(d.y));
                             });
    }
    if constexpr (K::I8) {
      __syncthreads();
      quantize_rows<4 * C, K::ROWS>(big, BS, srow, ia + K::I_FC2, warp,
                                    lane);
    }

#pragma unroll 1
    for (int nc = 0; nc < C / SLAB_N; ++nc) {  // fc2, residual -> xs
      zero(acc);
#pragma unroll 1
      for (int kc = 0; kc < 4; ++kc) {
        const unsigned char* w = ws.acquire();
        mma_slab<K>(acc, ba + kc * C, ASB, w, wm, wn, g, t);
        if (kc == 3) {
          const bf16* b = vp + K::V_FC2B + nc * SLAB_N;
          bf16* dst = xs + nc * SLAB_N;
          for_each_pair<K::ROWS>(
              acc, srow, sw + K::S_FC2 + nc * SLAB_N, wm, wn, g, t,
              [&](int r, int c, float v0, float v1) {
                add_residual<K::MODE>(dst + r * XS + c, v0, v1, ld2(b + c));
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

template <int C, int MODE>
int launch(const void* x, const void* wpack, const void* vpack,
           const void* bias, const void* swpack, const void* iapack,
           void* out, int n_windows, int layers, cudaStream_t stream) {
  using K = Cfg<C, MODE>;
  static_assert(K::SMEM_BYTES <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      window_trunk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(K::SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  window_trunk_kernel<K><<<n_windows, THREADS, K::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned char*>(wpack),
      static_cast<const bf16*>(vpack), static_cast<const float*>(bias),
      static_cast<const float*>(swpack), static_cast<const float*>(iapack),
      static_cast<bf16*>(out), layers);
  return int(cudaGetLastError());
}

}  // namespace

// dim 128 or 192; mode 0 (V2), 1 (V1) or, at dim 192, 2 (INT8) or 3
// (INT8_STATIC); wpack holds int8 slabs in the int8 modes. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tux_window_trunk(const void* x, const void* wpack,
                                const void* vpack, const void* bias,
                                const void* swpack, const void* iapack,
                                void* out, int n_windows, int layers, int dim,
                                int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  decltype(&launch<192, V2>) fn = nullptr;
  switch (dim * 4 + mode) {
    case 128 * 4 + V2: fn = launch<128, V2>; break;
    case 128 * 4 + V1: fn = launch<128, V1>; break;
    case 192 * 4 + V2: fn = launch<192, V2>; break;
    case 192 * 4 + V1: fn = launch<192, V1>; break;
    case 192 * 4 + INT8: fn = launch<192, INT8>; break;
    case 192 * 4 + INT8_STATIC: fn = launch<192, INT8_STATIC>; break;
    default: return int(cudaErrorInvalidValue);
  }
  return fn(x, wpack, vpack, bias, swpack, iapack, out, n_windows, layers,
            static_cast<cudaStream_t>(stream));
}
