// Global multi-head attention core for Hopper (sm_90a): softmax(q k^T / 4) v
// over all N tokens, heads packed in the channels, 16 channels a head.
//
// Replaces transformerupscaler_tpu/ops/pallas/gmha.py:60 global_mha (body
// _gmha_kernel, :39). The qkv and output products stay outside, as there.
//
// The TPU body holds the whole (heads x 64, N) f32 score strip of a query
// block in VMEM, normalises it, rounds p to bf16 and only then multiplies by
// v. One head's strip for 64 queries is 0.9 MB at N = 3600 and does not fit
// an SM, so this kernel makes two passes over the keys and keeps the TPU's
// rounding point:
//   pass 1: s = q k^T * 0.25 in f32, running row max m and row sum
//           l = sum exp(s - m), rescaled when m grows;
//   pass 2: s again (16 channels deep: one mma a key fragment),
//           p = bf16(exp(s - m) / l), out += p v in f32; out rounded once.
// The reference scales q by hd^-0.5 = 0.25 in bf16 before the kernel, which
// is exact, so scaling the f32 sum gives the same number. The TPU pads N to a
// multiple of 128 and masks the pad keys with -1e9; here nothing is padded:
// the key loop stops at N, rows past N in the last key tile are zero in shared
// memory and their scores are -inf. The block-diagonal head mask of the TPU
// body (how it fills a 128-lane MXU) is not carried: a block owns one head.
//
// Design. The grid is (ceil(N / 64), heads, batch): a block of 4 warps owns
// 64 query rows of one head, a warp 16 of them, with its q fragment in
// registers for the whole kernel. Key tiles of 64 rows (k in pass 1, k and v
// in pass 2; 16 channels = 32 bytes a row) stream through a two-stage
// shared-memory ring filled by cp.async one tile ahead. The 16 x 64 scores of
// a tile stay in registers, the row statistics come from quad shuffles, and
// the probabilities feed P.V straight from the accumulator registers.
//
// Bound on the H100 at N = 3600, C = 128, 8 heads: q k^T and p v are
// 2 x 2 x 3600^2 x 128 = 6.6 G operations, 0.0067 ms at 989 TF/s; q, k, v and
// out are 3.7 MB, 0.0011 ms. It is bound by operations. This design spends
// half as many again on the second q k^T and two exponentials a score, on
// mma.sync; wgmma and an online single pass are later work (see PERF.md).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int HD = 16;            // head width
constexpr int QT = 64;            // query rows per block
constexpr int KT = 64;            // keys per tile
constexpr int RS = HD + 8;        // row stride of a key tile (elements)
constexpr int THREADS = 128;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// Copy rows [key0, key0 + 64) of one head (16 channels) into a tile; rows
// from N on are zero. ``src`` points at the head's first channel of row 0.
__device__ __forceinline__ void fetch_tile(bf16* dst, const bf16* src,
                                           size_t row_stride, int key0, int n,
                                           int tid) {
  const int row = tid >> 1;
  const int chunk = tid & 1;
  bf16* d = dst + row * RS + chunk * 8;
  if (key0 + row < n)
    cp_async16(d, src + size_t(key0 + row) * row_stride + chunk * 8);
  else
    *reinterpret_cast<uint4*>(d) = tux::zero16();
}

// s = q k^T * 0.25 for this warp's 16 rows against the tile's 64 keys; keys
// from N on get -inf.
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&aq)[4],
                                       const bf16* ks, int key0, int n, int g,
                                       int t) {
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
    uint32_t bk[2];
    tux::load_b(bk, ks + (8 * nf + g) * RS, t);
    tux::mma_bf16(s[nf], aq[0], aq[1], aq[2], aq[3], bk[0], bk[1]);
  }
  const bool ragged = key0 + KT > n;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nf][e] *= 0.25f;
      if (ragged && key0 + 8 * nf + 2 * t + (e & 1) >= n) s[nf][e] = -INFINITY;
    }
}

// q, k, v: (B, N, C) bf16 views with the same batch and row strides (elements)
// and unit channel stride; head h in channels [16h, 16h + 16).
// out: (B, N, C) bf16, contiguous.
__global__ void __launch_bounds__(THREADS)
global_mha_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int n,
                  int c, size_t batch_stride, size_t row_stride) {
  __shared__ __align__(16) bf16 ks[2][KT * RS];
  __shared__ __align__(16) bf16 vs[2][KT * RS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const size_t base = size_t(blockIdx.z) * batch_stride + size_t(h) * HD;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int row0 = blockIdx.x * QT + 16 * warp + g;  // and row0 + 8
  const int tiles = (n + KT - 1) / KT;

  // This warp's q fragment, rows past N as zeros (never stored).
  uint32_t aq[4] = {0u, 0u, 0u, 0u};
  if (row0 < n) {
    const bf16* qr = q + base + size_t(row0) * row_stride;
    aq[0] = tux::ld_pair(qr + 2 * t);
    aq[2] = tux::ld_pair(qr + 2 * t + 8);
  }
  if (row0 + 8 < n) {
    const bf16* qr = q + base + size_t(row0 + 8) * row_stride;
    aq[1] = tux::ld_pair(qr + 2 * t);
    aq[3] = tux::ld_pair(qr + 2 * t + 8);
  }

  float s[8][4];

  // Pass 1: row max and row sum. The sums stay per thread until the end:
  // the max is already shared across the quad when they are rescaled.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  fetch_tile(ks[0], kh, row_stride, 0, n, tid);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      fetch_tile(ks[(i + 1) & 1], kh, row_stride, (i + 1) * KT, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scores(s, aq, ks[i & 1], i * KT, n, g, t);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      t0 = fmaxf(t0, fmaxf(s[nf][0], s[nf][1]));
      t1 = fmaxf(t1, fmaxf(s[nf][2], s[nf][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, o));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, o));
    }
    // Every tile holds at least one key below N, so t0 and t1 are finite.
    t0 = fmaxf(t0, m0);
    t1 = fmaxf(t1, m1);
    l0 *= __expf(m0 - t0);
    l1 *= __expf(m1 - t1);
    m0 = t0;
    m1 = t1;
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      l0 += __expf(s[nf][0] - m0) + __expf(s[nf][1] - m0);
      l1 += __expf(s[nf][2] - m1) + __expf(s[nf][3] - m1);
    }
    __syncthreads();  // all warps are done with this stage before its refill
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float r0 = 1.0f / l0;
  const float r1 = 1.0f / l1;

  // Pass 2: p = bf16(exp(s - m) / l), out += p v.
  float ctx[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ctx[j][e] = 0.f;
  fetch_tile(ks[0], kh, row_stride, 0, n, tid);
  fetch_tile(vs[0], vh, row_stride, 0, n, tid);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      fetch_tile(ks[(i + 1) & 1], kh, row_stride, (i + 1) * KT, n, tid);
      fetch_tile(vs[(i + 1) & 1], vh, row_stride, (i + 1) * KT, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scores(s, aq, ks[i & 1], i * KT, n, g, t);
    const bf16* vt = vs[i & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // Two adjacent score fragments are one A fragment of 16 keys.
      uint32_t ap[4];
      ap[0] = pack2(__expf(s[2 * kk][0] - m0) * r0,
                    __expf(s[2 * kk][1] - m0) * r0);
      ap[1] = pack2(__expf(s[2 * kk][2] - m1) * r1,
                    __expf(s[2 * kk][3] - m1) * r1);
      ap[2] = pack2(__expf(s[2 * kk + 1][0] - m0) * r0,
                    __expf(s[2 * kk + 1][1] - m0) * r0);
      ap[3] = pack2(__expf(s[2 * kk + 1][2] - m1) * r1,
                    __expf(s[2 * kk + 1][3] - m1) * r1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B[k][n] = v[key 16 kk + k][dim 8 j + n]: keys run down the rows of
        // the tile, so the pairs along k are gathered from two rows.
        const bf16* v0 = vt + (16 * kk + 2 * t) * RS + 8 * j + g;
        uint32_t bv[2];
        bv[0] = pack_raw(v0[0], v0[RS]);
        bv[1] = pack_raw(v0[8 * RS], v0[9 * RS]);
        tux::mma_bf16(ctx[j], ap[0], ap[1], ap[2], ap[3], bv[0], bv[1]);
      }
    }
    __syncthreads();
  }

  bf16* ob = out + (size_t(blockIdx.z) * n) * c + size_t(h) * HD;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (row0 < n)
      *reinterpret_cast<bf162*>(ob + size_t(row0) * c + 8 * j + 2 * t) =
          __floats2bfloat162_rn(ctx[j][0], ctx[j][1]);
    if (row0 + 8 < n)
      *reinterpret_cast<bf162*>(ob + size_t(row0 + 8) * c + 8 * j + 2 * t) =
          __floats2bfloat162_rn(ctx[j][2], ctx[j][3]);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides in elements.
extern "C" int tux_global_mha(const void* q, const void* k, const void* v,
                              void* out, int batch, int n, int c, int heads,
                              long long batch_stride, long long row_stride,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (batch == 0 || n == 0) return 0;
  const dim3 grid((n + QT - 1) / QT, heads, batch);
  global_mha_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, c,
      size_t(batch_stride), size_t(row_stride));
  return int(cudaGetLastError());
}
