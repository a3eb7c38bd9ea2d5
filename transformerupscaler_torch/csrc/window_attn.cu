// Window multi-head attention core for Hopper (sm_90a): per window and head,
// softmax(q k^T / 4 + bias) v on 64 tokens with 16-wide heads.
//
// Replaces transformerupscaler_tpu/ops/pallas/window_attn.py:58
// fused_window_attention (body _attn_kernel, :30). The qkv and output
// products stay outside, as there. The TPU kernel reads q, k, v transposed to
// (C, N) so that tokens lie on the lanes; that layout is not carried: this
// kernel reads the (windows, 64, 3C) tensor the qkv product leaves.
//
// Rounding points, those of the TPU body:
//   s   = q k^T * 0.25 + bias   f32; bias is the f32 relative-position bias.
//                               The reference scales q by hd^-0.5 = 0.25 in
//                               bf16 before the kernel, which is exact, so
//                               scaling the f32 sum gives the same number
//   p   = softmax(s)            f32 max, exp, sum; p / sum rounded to bf16
//   out = bf16(p v)             f32 accumulation, one rounding
//
// Design. The grid is (windows, ceil(heads / 2)): a block of 8 warps owns two
// heads of one window, so 60 windows of 8 heads give 240 blocks for 132 SMs.
// The block copies its heads' q, k, v columns (64 x 96 bf16) to shared memory;
// each warp takes one head and 16 query rows, keeps the 16 x 64 scores in
// registers (mma.sync m16n8k16), takes the row statistics with quad shuffles
// and feeds P.V straight from the accumulator registers. The context goes
// back into the q columns of the tile (only this warp read them) and leaves
// as 16-byte stores.
//
// Bound on the H100 at 60 windows, C = 128, 8 heads: 2.9 MB in, 1.0 MB out,
// 0.13 MB of bias: 0.0012 ms at 3.35 TB/s; 0.13 G operations are nothing. It
// is bound by bytes, and at this size by launch and fill latency.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int NT = 64;       // tokens per window
constexpr int HD = 16;       // head width
constexpr int HPB = 2;       // heads per block
constexpr int SEG = HPB * HD;            // columns per q, k or v segment
constexpr int TS = 3 * SEG + 8;          // row stride of the tile (elements)
constexpr int THREADS = 256;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// qkv (nW, 64, 3C) bf16, q at columns [0, C), k at [C, 2C), v at [2C, 3C),
// head h in columns [16h, 16h + 16) of each; bias (heads, 64, 64) f32;
// out (nW, 64, C) bf16.
__global__ void __launch_bounds__(THREADS)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   bf16* __restrict__ out, int C, int heads) {
  __shared__ __align__(16) bf16 tile[NT * TS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h0 = blockIdx.y * HPB;  // first head of this block
  const bf16* src = qkv + size_t(blockIdx.x) * NT * 3 * C;

  // 64 rows x 3 segments x 4 chunks of 16 bytes; a head past the last one
  // (odd head counts) is filled with zeros and never stored.
  for (int i = tid; i < NT * 3 * (SEG / 8); i += THREADS) {
    const int chunk = i % (SEG / 8);
    const int seg = (i / (SEG / 8)) % 3;
    const int row = i / (3 * (SEG / 8));
    const int head = h0 + chunk / (HD / 8);
    uint4 v = tux::zero16();
    if (head < heads)
      v = *reinterpret_cast<const uint4*>(src + size_t(row) * 3 * C + seg * C +
                                          h0 * HD + chunk * 8);
    *reinterpret_cast<uint4*>(tile + row * TS + seg * SEG + chunk * 8) = v;
  }
  __syncthreads();

  // One unit of work per warp: local head hl, query rows r0 .. r0 + 15.
  const int hl = warp >> 2;
  const int r0 = 16 * (warp & 3);
  const int h = h0 + hl;
  if (h < heads) {
    uint32_t aq[4];
    bf16* q0 = tile + (r0 + g) * TS + hl * HD;
    tux::load_a(aq, q0, q0 + 8 * TS, t);
    float s[8][4];
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
      uint32_t bk[2];
      tux::load_b(bk, tile + (8 * nf + g) * TS + SEG + hl * HD, t);
      tux::mma_bf16(s[nf], aq[0], aq[1], aq[2], aq[3], bk[0], bk[1]);
    }
    // Rows r0 + g (elements 0, 1) and r0 + g + 8 (elements 2, 3).
    const float* b0 = bias + (size_t(h) * NT + r0 + g) * NT + 2 * t;
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
        // the tile, so the pairs along k are gathered from two rows.
        const bf16* v0 =
            tile + (16 * kk + 2 * t) * TS + 2 * SEG + hl * HD + 8 * j + g;
        uint32_t bv[2];
        bv[0] = pack_raw(v0[0], v0[TS]);
        bv[1] = pack_raw(v0[8 * TS], v0[9 * TS]);
        tux::mma_bf16(ctx[j], ap[0], ap[1], ap[2], ap[3], bv[0], bv[1]);
      }
    }
    // Only this warp read these 16 rows of this head's q columns.
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bf16* c0 = q0 + 8 * j + 2 * t;
      *reinterpret_cast<bf162*>(c0) = __floats2bfloat162_rn(ctx[j][0], ctx[j][1]);
      *reinterpret_cast<bf162*>(c0 + 8 * TS) =
          __floats2bfloat162_rn(ctx[j][2], ctx[j][3]);
    }
  }
  __syncthreads();

  bf16* dst = out + size_t(blockIdx.x) * NT * C;
  for (int i = tid; i < NT * (SEG / 8); i += THREADS) {
    const int chunk = i % (SEG / 8);
    const int row = i / (SEG / 8);
    if (h0 + chunk / (HD / 8) < heads)
      *reinterpret_cast<uint4*>(dst + size_t(row) * C + h0 * HD + chunk * 8) =
          *reinterpret_cast<const uint4*>(tile + row * TS + chunk * 8);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_window_attn(const void* qkv, const void* bias, void* out,
                               int n_windows, int c, int heads, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  const dim3 grid(n_windows, (heads + HPB - 1) / HPB);
  window_attn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), c, heads);
  return int(cudaGetLastError());
}
