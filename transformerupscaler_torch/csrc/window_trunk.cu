// Fused window-transformer trunk for Hopper (sm_90a): every window block of
// the model in one kernel, one thread block per window of 64 tokens.
//
// Replaces transformerupscaler_tpu/ops/pallas/trunk2.py:524
// fused_window_trunk_v2. That function has five kernel bodies (_trunk2_kernel
// :51, _trunk2_pair_kernel :105, _trunk2_pair_chunked_kernel :255,
// _trunk2_group_kernel :335, _trunk2_pair_truedot_kernel :432) which tile one
// arithmetic in five ways to fill 128-lane MXU tiles (head masks, window
// pairing, block-diagonal key matrices, a ones-matmul softmax denominator,
// padding of the window count). None of that is carried over: this one kernel
// computes per-head products directly and answers for all five.
//
// Per layer, on a window x (64 x 192, bf16), with every rounding point of
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
//
// Design. Shared memory holds the residual stream x (64 x 192), the LN
// output / attention context (64 x 192) and one 64 x 768 buffer used for qkv
// (64 x 576) and then for the MLP hidden: no intermediate goes to device
// memory. The weights (0.885 MB a layer) cannot live in shared memory; they
// arrive pre-cut into slabs of [64 outputs][192 inputs] in the order the
// kernel consumes them (36 a layer), and a three-slab ring is filled with
// cp.async two slabs ahead of the mma.sync m16n8k16 products, also across the
// LN and attention phases. The 8 warps tile a slab's 64 x 64 output as 2 x 4
// warp tiles of 32 x 16. Attention runs flash-style per (head, 16 query
// rows): the 16 x 64 scores stay in registers, the row statistics come from
// quad shuffles, and the probabilities feed P.V straight from the accumulator
// registers. Row strides of (multiple of 64) + 8 elements keep the fragment
// reads free of bank conflicts.
//
// Bound on the H100 at 240 windows x 6 layers: 86.1 G operations, 0.087 ms at
// 989 TF/s; x, out, weights and bias are ~13 MB, 0.004 ms. Every block streams
// all weights from L2 (1.27 GB in total), which bounds this design near
// 0.25 ms; sharing slabs across a cluster with TMA multicast and wgmma are
// later work (see PERF.md).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int NT = 64;     // tokens per window
constexpr int C = 192;     // model width
constexpr int HEADS = 12;
constexpr int HD = 16;     // head width
constexpr int XS = C + 8;        // row stride of the 64 x 192 tiles
constexpr int BS = 4 * C + 8;    // row stride of the 64 x 768 tile
constexpr int SLAB_N = 64;       // outputs per weight slab
constexpr int SLAB_K = 192;      // inputs per weight slab
constexpr int WS = SLAB_K + 8;   // row stride of a slab in shared memory
constexpr int SLABS = 36;        // slabs per layer: qkv 9, proj 3, fc1 12, fc2 12
constexpr int STAGES = 3;        // slabs in the shared-memory ring
constexpr int THREADS = 256;
// Offsets into a layer's packed vectors (bf16 elements).
constexpr int V_LN1S = 0, V_LN1B = 192, V_QKVB = 384, V_PROJB = 960,
              V_LN2S = 1152, V_LN2B = 1344, V_FC1B = 1536, V_FC2B = 2304,
              VEC = 2496;
constexpr size_t SMEM_BYTES =
    size_t(2 * NT * XS + NT * BS + STAGES * SLAB_N * WS) *
    sizeof(__nv_bfloat16);

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

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

// The flat sequence of weight slabs, fetched STAGES - 1 ahead into a ring.
struct WeightStream {
  const bf16* src;  // (total, 64, 192) in device memory
  bf16* ring;       // STAGES slabs of 64 rows, stride WS
  int total, fetched, used, tid;

  // Start the copy of the next slab; past the end, commit an empty group so
  // that the group count stays one per call.
  __device__ __forceinline__ void prefetch() {
    if (fetched < total) {
      bf16* dst = ring + (fetched % STAGES) * SLAB_N * WS;
      const bf16* s = src + size_t(fetched) * SLAB_N * SLAB_K;
      for (int i = tid; i < SLAB_N * (SLAB_K / 8); i += THREADS) {
        const int r = i / (SLAB_K / 8);
        const int c = i % (SLAB_K / 8);
        cp_async16(dst + r * WS + c * 8, s + r * SLAB_K + c * 8);
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
  __device__ __forceinline__ const bf16* acquire() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    prefetch();
    return ring + (used++ % STAGES) * SLAB_N * WS;
  }
};

// acc += A[64 x 192] . slab^T for this warp's 32 x 16 tile. ``a`` points at
// the first of the 192 input columns; ``w`` at the slab, [64 outputs][WS].
__device__ __forceinline__ void mma_slab(float (&acc)[2][2][4], const bf16* a,
                                         int sa, const bf16* w, int wm, int wn,
                                         int g, int t) {
  const bf16* a0 = a + (32 * wm + g) * sa;
  const bf16* w0 = w + (16 * wn + g) * WS;
#pragma unroll
  for (int kk = 0; kk < SLAB_K / 16; ++kk) {
    uint32_t af[2][4], bfr[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
      tux::load_a(af[f], a0 + (16 * f) * sa + kk * 16,
                  a0 + (16 * f + 8) * sa + kk * 16, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) tux::load_b(bfr[j], w0 + 8 * j * WS + kk * 16, t);
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tux::mma_bf16(acc[f][j], af[f][0], af[f][1], af[f][2], af[f][3],
                      bfr[j][0], bfr[j][1]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][2][4]) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
}

// Calls fn(row, col, v0, v1) for each adjacent pair of this thread's
// accumulators; (row, col) are within the slab's 64 x 64 output.
template <typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[2][2][4],
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

// bf16(acc) + bias in bf16 for a pair of outputs: the reference's two
// roundings.
__device__ __forceinline__ float2 dense_out(float v0, float v1, float2 bias) {
  const float2 r = round_bf16(v0, v1);
  return round_bf16(r.x + bias.x, r.y + bias.y);
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// ys = bf16(LN(xs)): one warp per row, six channels per lane.
__device__ __forceinline__ void layernorm(const bf16* xs, bf16* ys,
                                          const bf16* scale, const bf16* shift,
                                          int warp, int lane) {
  for (int r = warp; r < NT; r += THREADS / 32) {
    const bf16* xr = xs + r * XS;
    float2 v[3];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v[j] = ld2(xr + 2 * lane + 64 * j);
      s += v[j].x + v[j].y;
      ss += v[j].x * v[j].x + v[j].y * v[j].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / float(C);
    const float var = ss / float(C) - mu * mu;
    const float rstd = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int col = 2 * lane + 64 * j;
      const float2 sc = ld2(scale + col);
      const float2 sh = ld2(shift + col);
      st2(ys + r * XS + col, (v[j].x - mu) * rstd * sc.x + sh.x,
          (v[j].y - mu) * rstd * sc.y + sh.y);
    }
  }
}

// ctx (into ys) = softmax(q k^T / 4 + bias) v per head, from qkv in ``big``
// (q at columns 0.., k at C.., v at 2C..). One unit of work is one head and
// 16 query rows; 48 units over 8 warps.
__device__ __forceinline__ void attention(const bf16* big, bf16* ys,
                                          const float* bias_l, int warp, int g,
                                          int t) {
  for (int u = warp; u < HEADS * (NT / 16); u += THREADS / 32) {
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
        const bf16* v0 = big + (16 * kk + 2 * t) * BS + 2 * C + h * HD + 8 * j + g;
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

// x, out (nW, 64, 192) bf16; wpack (layers, 36, 64, 192) bf16; vpack
// (layers, 2496) bf16; bias (layers, 12, 64, 64) f32.
__global__ void __launch_bounds__(THREADS, 1)
window_trunk_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpack,
                    const bf16* __restrict__ vpack,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int layers) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // residual stream
  bf16* ys = xs + NT * XS;                   // LN output, then context
  bf16* big = ys + NT * XS;                  // qkv, then the MLP hidden
  bf16* ring = big + NT * BS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;

  WeightStream ws{wpack, ring, layers * SLABS, 0, 0, tid};
  for (int i = 0; i < STAGES - 1; ++i) ws.prefetch();

  const bf16* xw = x + size_t(blockIdx.x) * NT * C;
  for (int i = tid; i < NT * (C / 8); i += THREADS) {
    const int r = i / (C / 8);
    const int c = i % (C / 8);
    *reinterpret_cast<uint4*>(xs + r * XS + c * 8) =
        *reinterpret_cast<const uint4*>(xw + r * C + c * 8);
  }

  float acc[2][2][4];
  for (int l = 0; l < layers; ++l) {
    const bf16* vp = vpack + size_t(l) * VEC;

    // Each phase that reads what a GEMM's epilogues wrote starts behind a
    // barrier; a GEMM's first acquire() is the barrier after the others.
    __syncthreads();
    layernorm(xs, ys, vp + V_LN1S, vp + V_LN1B, warp, lane);
#pragma unroll 1
    for (int nc = 0; nc < 3 * C / SLAB_N; ++nc) {  // qkv -> big
      const bf16* w = ws.acquire();
      zero(acc);
      mma_slab(acc, ys, XS, w, wm, wn, g, t);
      const bf16* b = vp + V_QKVB + nc * SLAB_N;
      bf16* dst = big + nc * SLAB_N;
      for_each_pair(acc, wm, wn, g, t, [&](int r, int c, float v0, float v1) {
        const float2 d = dense_out(v0, v1, ld2(b + c));
        st2(dst + r * BS + c, d.x, d.y);
      });
    }

    __syncthreads();
    attention(big, ys, bias + size_t(l) * HEADS * NT * NT, warp, g, t);

#pragma unroll 1
    for (int nc = 0; nc < C / SLAB_N; ++nc) {  // proj, residual -> xs
      const bf16* w = ws.acquire();
      zero(acc);
      mma_slab(acc, ys, XS, w, wm, wn, g, t);
      const bf16* b = vp + V_PROJB + nc * SLAB_N;
      bf16* dst = xs + nc * SLAB_N;
      for_each_pair(acc, wm, wn, g, t, [&](int r, int c, float v0, float v1) {
        const float2 d = dense_out(v0, v1, ld2(b + c));
        const float2 xv = ld2(dst + r * XS + c);
        st2(dst + r * XS + c, xv.x + d.x, xv.y + d.y);
      });
    }

    __syncthreads();
    layernorm(xs, ys, vp + V_LN2S, vp + V_LN2B, warp, lane);
#pragma unroll 1
    for (int nc = 0; nc < 4 * C / SLAB_N; ++nc) {  // fc1, GELU -> big
      const bf16* w = ws.acquire();
      zero(acc);
      mma_slab(acc, ys, XS, w, wm, wn, g, t);
      const bf16* b = vp + V_FC1B + nc * SLAB_N;
      bf16* dst = big + nc * SLAB_N;
      for_each_pair(acc, wm, wn, g, t, [&](int r, int c, float v0, float v1) {
        const float2 d = dense_out(v0, v1, ld2(b + c));
        st2(dst + r * BS + c, gelu_erf(d.x), gelu_erf(d.y));
      });
    }

#pragma unroll 1
    for (int nc = 0; nc < C / SLAB_N; ++nc) {  // fc2, residual -> xs
      zero(acc);
#pragma unroll 1
      for (int kc = 0; kc < 4 * C / SLAB_K; ++kc) {
        const bf16* w = ws.acquire();
        mma_slab(acc, big + kc * SLAB_K, BS, w, wm, wn, g, t);
        if (kc == 4 * C / SLAB_K - 1) {
          const bf16* b = vp + V_FC2B + nc * SLAB_N;
          bf16* dst = xs + nc * SLAB_N;
          for_each_pair(acc, wm, wn, g, t,
                        [&](int r, int c, float v0, float v1) {
                          const float2 d = dense_out(v0, v1, ld2(b + c));
                          const float2 xv = ld2(dst + r * XS + c);
                          st2(dst + r * XS + c, xv.x + d.x, xv.y + d.y);
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

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_window_trunk(const void* x, const void* wpack,
                                const void* vpack, const void* bias, void* out,
                                int n_windows, int layers, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(window_trunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  window_trunk_kernel<<<n_windows, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpack),
      static_cast<const bf16*>(vpack), static_cast<const float*>(bias),
      static_cast<bf16*>(out), layers);
  return int(cudaGetLastError());
}
