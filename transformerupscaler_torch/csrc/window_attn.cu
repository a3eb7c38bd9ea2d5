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
// Bound on the H100 at 60 windows, C = 128, 8 heads: 2.9 MB in, 1.0 MB out,
// 0.13 MB of bias: 0.0012 ms at 3.35 TB/s; 0.13 G operations are nothing.
// 240 blocks fit the card in one wave, so the kernel's time is one block's
// chain of dependent steps; the empty kernel of the same grid
// (tux_window_attn_empty) measures what a launch costs before any of it.
//
// What held the earlier design (0.0052 ms) back: the block's q, k, v
// went through registers into shared memory, then a __syncthreads; the
// bias was read from global memory only after Q.K^T, a second dependent
// trip to L2; V's fragments came by scalar 2-byte loads; the context left
// after another __syncthreads.
//
// Design. The grid is (windows, ceil(heads / 2)): a block of 8 warps owns two
// heads of one window, each warp one head and 16 query rows.
// - Every load is issued at block start. Thread 0 issues three TMA boxes
//   (q, k and v columns of the block's two heads: 64 rows x 64 bytes each,
//   64B swizzle) onto one mbarrier; then each warp's first 16 lanes issue
//   one bulk copy each, the 16 bias rows (256 bytes) its query rows add,
//   onto the warp's own mbarrier, into rows of 288 bytes (conflict-free
//   8-byte reads of the accumulator's layout). Only then does a warp wait
//   for q, k and v, and for its bias only after Q.K^T. (Loading the bias
//   into registers, ld.global.nc at block start, left it a quarter of the
//   kernel's time: kernel_ablation.py no_bias_load, PERF.md.) A head past
//   the last one (odd head counts) reads zeros or the next segment's
//   columns and is neither computed nor stored.
// - Fragments by ldmatrix: Q's A fragment and K's B fragments (x4, two key
//   groups a load), V's B fragments by ldmatrix.trans. The scores stay in
//   registers (mma.sync m16n8k16), the row statistics by quad shuffles,
//   P.V straight from the score registers.
// - The context leaves by TMA store: each warp stages its 16 x 16 bf16
//   block in its own 512 bytes and stores it as one box, no block-wide
//   barrier after the products.
//
// ptxas (nvcc 12.9, sm_90a): see PERF.md, row 16.
#include "common.cuh"
#include "sm90.cuh"

#include <math.h>

namespace {

namespace S = tux::sm90;

constexpr int NT = 64;                 // tokens per window
constexpr int HD = 16;                 // head width
constexpr int HPB = 2;                 // heads per block
constexpr int SEG = HPB * HD;          // columns of a q, k or v box
constexpr int TILE = NT * SEG * 2;     // 4096 bytes: one box
constexpr int CTX = HD * HD * 2;       // 512 bytes: a warp's context block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BP = NT + 8;             // bias row pitch in shared memory (f32)
constexpr int WBIAS = 16 * BP * 4;     // 4608 bytes: a warp's bias rows
constexpr int OFF_BIAS = 3 * TILE;
constexpr int OFF_CTX = OFF_BIAS + WARPS * WBIAS;
constexpr int OFF_BAR = OFF_CTX + WARPS * CTX;
constexpr int SMEM = 1024 + OFF_BAR + (1 + WARPS) * 8;  // 1024: alignment

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk ch of row r in a 64B-swizzled box of 64-byte
// rows (1024-byte aligned): the chunk index XORed with (r / 2) % 4.
__device__ __forceinline__ int sw64(int r, int ch) {
  return r * 64 + ((ch ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(S::smem(dst)),
      "l"(src), "r"(bytes), "r"(S::smem(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(S::smem(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(S::smem(p)));
}

// qkv_map: qkv (nW, 64, 3C) bf16 as (3C, 64, nW), box (32, 64, 1), 64B
// swizzle; q at columns [0, C), k at [C, 2C), v at [2C, 3C), head h in
// columns [16h, 16h + 16) of each. out_map: out (nW, 64, C) bf16 as (C, 64,
// nW), box (16, 16, 1), no swizzle. bias (heads, 64, 64) f32.
__global__ void __launch_bounds__(THREADS, 2)
window_attn_kernel(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const float* __restrict__ bias, int C, int heads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tile = align1024(smem_raw);  // q, k, v boxes
  float* bsm = reinterpret_cast<float*>(tile + OFF_BIAS);
  unsigned char* ctx = tile + OFF_CTX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + OFF_BAR);  // q, k, v
  uint64_t* bbar = bar + 1;                                     // a warp's bias

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h0 = blockIdx.y * HPB;  // first head of this block
  const int hl = warp >> 2;         // this warp's head in the block
  const int r0 = 16 * (warp & 3);   // and its query rows
  const int h = h0 + hl;

  if (tid == 0) {
    for (int i = 0; i <= WARPS; ++i) S::mbar_init(&bar[i], 1);
    S::fence_barrier_init();
    S::mbar_expect_tx(bar, 3 * TILE);
    for (int s = 0; s < 3; ++s)
      S::tma_load_3d(tile + s * TILE, &qkv_map, bar, s * C + h0 * HD, 0,
                     blockIdx.x);
  }
  __syncthreads();  // the barriers initialized before anyone uses them
  if (h >= heads) return;
  // This warp's bias rows r0 .. r0 + 15 of head h, in flight while q, k and
  // v arrive.
  float* wb = bsm + warp * (WBIAS / 4);
  if (lane == 0) S::mbar_expect_tx(&bbar[warp], 16 * NT * 4);
  __syncwarp();
  if (lane < 16)
    bulk_load(wb + lane * BP, bias + (size_t(h) * NT + r0 + lane) * NT,
              NT * 4, &bbar[warp]);
  S::mbar_wait(bar, 0);

  const unsigned char* qt = tile;
  const unsigned char* kt = tile + TILE;
  const unsigned char* vt = tile + 2 * TILE;
  // Q's A fragment: matrices (rows r0.., r0 + 8..) x (columns 0-7, 8-15).
  uint32_t aq[4];
  ldsm_x4(aq, qt + sw64(r0 + (lane & 7) + 8 * ((lane >> 3) & 1),
                        2 * hl + (lane >> 4)));
  float s[8][4];
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    // B fragments of key groups 2p and 2p + 1: K rows 16p + (0..7, 8..15),
    // columns 0-7 (b0) and 8-15 (b1).
    uint32_t bk[4];
    ldsm_x4(bk, kt + sw64(16 * p + (lane & 7) + 8 * (lane >> 4),
                          2 * hl + ((lane >> 3) & 1)));
#pragma unroll
    for (int e = 0; e < 2; ++e)
      tux::mma_bf16(s[2 * p + e], aq[0], aq[1], aq[2], aq[3], bk[2 * e],
                    bk[2 * e + 1]);
  }
  // Rows r0 + g (elements 0, 1) and r0 + g + 8 (elements 2, 3); the bias
  // of columns 8 nf + 2 t, + 1.
  S::mbar_wait(&bbar[warp], 0);
  const float* b0 = wb + g * BP + 2 * t;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
    const float2 ba = *reinterpret_cast<const float2*>(b0 + 8 * nf);
    const float2 bb = *reinterpret_cast<const float2*>(b0 + 8 * BP + 8 * nf);
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
  // P.V: two adjacent score fragments are one A fragment of 16 keys; V's B
  // fragments by ldmatrix.trans of V rows 16 kk + (0..7, 8..15), columns
  // 0-7 (j = 0) and 8-15 (j = 1).
  float cx[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cx[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ap[4];
    ap[0] = pack2(s[2 * kk][0] * d0, s[2 * kk][1] * d0);
    ap[1] = pack2(s[2 * kk][2] * d1, s[2 * kk][3] * d1);
    ap[2] = pack2(s[2 * kk + 1][0] * d0, s[2 * kk + 1][1] * d0);
    ap[3] = pack2(s[2 * kk + 1][2] * d1, s[2 * kk + 1][3] * d1);
    uint32_t bv[4];
    ldsm_x4_t(bv, vt + sw64(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                            2 * hl + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      tux::mma_bf16(cx[j], ap[0], ap[1], ap[2], ap[3], bv[2 * j],
                    bv[2 * j + 1]);
  }
  // The warp's 16 x 16 context block: rows of 32 bytes, one TMA box.
  unsigned char* cw = ctx + warp * CTX;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *reinterpret_cast<uint32_t*>(cw + g * 32 + (8 * j + 2 * t) * 2) =
        pack2(cx[j][0], cx[j][1]);
    *reinterpret_cast<uint32_t*>(cw + (g + 8) * 32 + (8 * j + 2 * t) * 2) =
        pack2(cx[j][2], cx[j][3]);
  }
  S::fence_async_smem();
  __syncwarp();
  if (lane == 0) {
    S::tma_store_3d(&out_map, cw, h * HD, r0, blockIdx.x);
    S::store_commit();
    S::store_wait_read<0>();
  }
}

// Nothing, on the core's grid: the launch and fill floor of its time.
__global__ void __launch_bounds__(THREADS) window_attn_empty_kernel() {}

dim3 grid_of(int n_windows, int heads) {
  return dim3(n_windows, (heads + HPB - 1) / HPB);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_window_attn(const void* qkv, const void* bias, void* out,
                               int n_windows, int c, int heads, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  CUtensorMap qm, om;
  const uint64_t qdims[3] = {3ull * c, NT, uint64_t(n_windows)};
  const uint64_t qstrides[2] = {6ull * c, 6ull * c * NT};
  const uint32_t qbox[3] = {SEG, NT, 1};
  int e = tux::sm90::encode_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qkv,
                                qdims, qstrides, qbox,
                                CU_TENSOR_MAP_SWIZZLE_64B);
  if (e) return e;
  const uint64_t odims[3] = {uint64_t(c), NT, uint64_t(n_windows)};
  const uint64_t ostrides[2] = {2ull * c, 2ull * c * NT};
  const uint32_t obox[3] = {HD, HD, 1};
  e = tux::sm90::encode_map(&om, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out,
                            odims, ostrides, obox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e) return e;
  err = cudaFuncSetAttribute(window_attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return int(err);
  window_attn_kernel<<<grid_of(n_windows, heads), THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      qm, om, static_cast<const float*>(bias), c, heads);
  return int(cudaGetLastError());
}

// The empty kernel on the grid tux_window_attn would launch.
extern "C" int tux_window_attn_empty(int n_windows, int heads, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n_windows == 0) return 0;
  window_attn_empty_kernel<<<grid_of(n_windows, heads), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}
