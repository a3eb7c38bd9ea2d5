// Column-strip convolutions on Hopper (sm_90a): what the strip kernels of
// csrc/conv_tail.cu (the fused 3x3 conv + k x k tail) and csrc/tail_strip.cu
// (the composed k x k tail, the split branch-B tail) share.
//
// A strip is a column of 64 pixels per warpgroup (wgmma's M) over the rows
// of an NHWC map, owning the outputs that its k x k reach leaves whole. The
// strip-rows of the image, in (batch, strip, row) order, are cut into one
// contiguous range per persistent block (one block an SM); a range breaks
// into segments at strip ends. Rows arrive in shared memory as 128B-swizzled
// rows of 64 channels (TMA, zero-filled outside the map), 128 bytes a pixel,
// in a ring behind full / empty mbarriers.
//
// The shift-add stage of a k x k conv over such rows: for each source row m
// one wgmma GEMM, M = 64 pixels, K = k dx shifts x the channels (the A
// descriptor started dx rows of 128 bytes in), N = k kernel rows (dy) x 16
// outputs side by side, B K-major (the `tail_slabs` layout of
// kernels/stream.py): D[p][dy, o] is row m's share of output row m + P - dy.
// The output rows m - P .. m + P - 1 are kept in registers and shifted one
// row per source row; output row m - P is complete after source row m. Each
// product runs once a source row instead of once for each of the k output
// rows it feeds, and source rows outside the image (the zero pad) cost no
// products.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "sm90.cuh"

namespace tux {
namespace strip {

namespace S = tux::sm90;
using bf16 = __nv_bfloat16;

constexpr int MW = 64;   // pixels of a warpgroup's strip: wgmma's M
constexpr int NG = 16;   // outputs of a group: one kernel row's share of N
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Byte offset of 16-byte chunk j of pixel r in a 128B-swizzled ring row.
__device__ __forceinline__ int sw128(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// One arrival per warp: the barriers count warps.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) S::mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Parity of the n-th use of a ring of `stages` slots.
__device__ __forceinline__ uint32_t par(uint32_t n, uint32_t stages) {
  return (n / stages) & 1;
}

// The A operand (64 pixels x k16 step s, K-major) of a 128B-swizzled ring
// row, starting `shift` pixels in.
__device__ __forceinline__ uint64_t desc_row(const unsigned char* row,
                                             int shift, int s) {
  return S::desc(row + 128 * shift + 32 * s, 16, 1024);
}

// A K-major B slab of 128-byte rows at the k16 step s.
__device__ __forceinline__ uint64_t desc_slab(const unsigned char* slab,
                                              int s) {
  return S::desc(slab + 32 * s, 16, 1024);
}

// This block's strip-rows [t0, t1) of T.
__device__ __forceinline__ void block_rows(int T, int& t0, int& t1) {
  t0 = int(static_cast<long long>(blockIdx.x) * T / gridDim.x);
  t1 = int(static_cast<long long>(blockIdx.x + 1) * T / gridDim.x);
}

// A segment of a block's range: batch b, the strip's first owned column x0,
// owned rows [y0, y1).
struct Seg {
  int b, x0, y0, y1;
};

// The segment that starts at strip-row t of a range ending at t_end, for
// strips owning `own` columns each.
__device__ __forceinline__ Seg segment(int t, int t_end, int H, int strips,
                                       int own) {
  Seg g;
  const int bs = t / H;
  g.y0 = t - bs * H;
  g.b = bs / strips;
  g.x0 = (bs - g.b * strips) * own;
  g.y1 = min(H, g.y0 + (t_end - t));
  return g;
}

// The shift-add of a KT x KT conv of NGR output groups (each one product
// chain of N = 16 KT), one source row a step, with partial sums of type Acc
// (f32 for bf16 products, int32 for int8 ones: exact in any order). step()
// takes source row m: products(q, D), only when the row is `inside` the
// image (else it is the zero pad), leaves in D[8 dy + e] row m's share of
// group q's output row m + P - dy in wgmma's accumulator layout (d[4 j + 2
// i + e] = D[16 warp + g + 8 i][8 j + 2 t + e], j = 2 dy + jj); the groups
// run one after the other, so one group's accumulator is live at a time.
// Then, when `done`, emit(y, o) gets the complete output row y = m - P,
// o[q][4 jj + 2 i + e] for output 16 q + 8 jj + 2 t + e.
template <int KT, int NGR, typename Acc = float>
struct ShiftAdd {
  static constexpr int P = (KT - 1) / 2;
  Acc R[2 * P][NGR][8];  // R[i]: the partial sums of output row m - P + i

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < 2 * P; ++i)
#pragma unroll
      for (int q = 0; q < NGR; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) R[i][q][e] = Acc(0);
  }

  template <class Products, class Emit>
  __device__ __forceinline__ void step(bool inside, bool done, int y,
                                       Products&& products, Emit&& emit) {
    Acc o[NGR][8];
#pragma unroll
    for (int q = 0; q < NGR; ++q) {
      Acc D[8 * KT];
      if (inside) {
        products(q, D);
      } else {
#pragma unroll
        for (int e = 0; e < 8 * KT; ++e) D[e] = Acc(0);
      }
      // Output row m - P, then the shift: R[i] becomes output row
      // m + 1 - P + i.
#pragma unroll
      for (int e = 0; e < 8; ++e) o[q][e] = R[0][q][e] + D[16 * P + e];
#pragma unroll
      for (int i = 0; i + 1 < 2 * P; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          R[i][q][e] = R[i + 1][q][e] + D[8 * (2 * P - 1 - i) + e];
#pragma unroll
      for (int e = 0; e < 8; ++e) R[2 * P - 1][q][e] = D[e];
    }
    if (done) emit(y, o);
  }
};

// The shift-add over the source rows m in [y0 - P, y1 + P) that output rows
// [y0, y1) need, rows [ma, mb) inside the image: products(m, q, D) as
// ShiftAdd's products for row m.
template <int KT, int NGR, typename Acc = float, class Products, class Emit>
__device__ __forceinline__ void shift_add(int y0, int y1, int ma, int mb,
                                          Products&& products, Emit&& emit) {
  constexpr int P = (KT - 1) / 2;
  ShiftAdd<KT, NGR, Acc> sa;
  sa.reset();
  for (int m = y0 - P; m < y1 + P; ++m)
    sa.step(m >= ma && m < mb, m - P >= y0, m - P,
            [&](int q, Acc (&D)[8 * KT]) { products(m, q, D); }, emit);
}

// The bias of this thread's outputs 16 (grp0 + q) + 8 jj + 2 t + e at
// b[q][2 jj + e], zero past co.
template <int NGR>
__device__ __forceinline__ void group_bias(float (&b)[NGR][4],
                                           const float* __restrict__ bias,
                                           int co, int grp0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int q = 0; q < NGR; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = NG * (grp0 + q) + 8 * (c >> 1) + 2 * t + (c & 1);
      b[q][c] = o < co ? bias[o] : 0.f;
    }
}

// Stores a warpgroup's output row from shift_add's o: pixel p = 16 warp + g
// + 8 i at column x0 + p of the row starting at element `row` x co (row =
// (b H + y) W), for p < own and x0 + p < W, outputs 16 (grp0 + q) + ... < co;
// + bias, optional ReLU, one rounding to bf16 or f32. int32 sums (Acc int)
// are first scaled by their output's ks: float(o) x ks + bias, each step
// rounded on its own, no fused multiply-add (ops.conv.conv2d_int8_q); ks is
// not read for f32 sums.
template <int NGR, typename Acc>
__device__ __forceinline__ void store_row(void* __restrict__ out, size_t row,
                                          int x0, int own, int W, int co,
                                          int grp0, const Acc (&o)[NGR][8],
                                          const float (&b)[NGR][4],
                                          const float (&ks)[NGR][4], int relu,
                                          int out_f32) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = 16 * warp + g + 8 * i;
    const int x = x0 + p;
    if (p < own && x < W) {
#pragma unroll
      for (int q = 0; q < NGR; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = 4 * (c >> 1) + 2 * i + (c & 1);
          const int oc = NG * (grp0 + q) + 8 * (c >> 1) + 2 * t + (c & 1);
          float v;
          if constexpr (std::is_same_v<Acc, int>)
            v = __fadd_rn(__fmul_rn(__int2float_rn(o[q][e]), ks[q][c]),
                          b[q][c]);
          else
            v = o[q][e] + b[q][c];
          if (relu) v = fmaxf(v, 0.f);
          if (oc < co) {
            if (out_f32)
              static_cast<float*>(out)[(row + x) * co + oc] = v;
            else
              static_cast<bf16*>(out)[(row + x) * co + oc] =
                  __float2bfloat16_rn(v);
          }
        }
    }
  }
}

template <int NGR>
__device__ __forceinline__ void store_row(void* __restrict__ out, size_t row,
                                          int x0, int own, int W, int co,
                                          int grp0, const float (&o)[NGR][8],
                                          const float (&b)[NGR][4], int relu,
                                          int out_f32) {
  store_row<NGR, float>(out, row, x0, own, W, co, grp0, o, b, b, relu,
                        out_f32);
}

}  // namespace strip
}  // namespace tux
