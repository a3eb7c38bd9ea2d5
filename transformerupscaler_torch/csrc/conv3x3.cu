// General NHWC 3x3 conv (stride 1, zero padding 1) with an optional bias and
// ReLU, any input and output width, for Hopper (sm_90a): TMA halo tiles, an
// implicit GEMM on wgmma, a TMA-stored epilogue.
//
// Replaces transformerupscaler_tpu/ops/pallas/conv3x3.py:73 conv3x3_pallas,
// the JAX package's archived conv kernel, which its tests pin at (C, O) =
// (64, 64), (64, 256), (256, 16), (8, 8), (16, 8), batch 3 and odd heights.
//
//   out[b, y, x, o] = bf16(act(sum_{dy,dx,c} x[b, y+dy-1, x+dx-1, c]
//                                 * w[dy, dx, c, o] + bias[o]))
// bf16 operands, f32 accumulation; the bias arrives as bf16 values (the TPU
// kernel rounds it to x's dtype first, conv3x3.py:103-104) and is added in
// f32, then the ReLU, then one rounding to bf16 (conv3x3.py:64-69).
//
// Bound on the H100 at 720x1280, 64 -> 64 (989 TF/s bf16, 3.35 TB/s): 67.9
// GFLOP, 0.069 ms; 236 MB moved, 0.070 ms. Both at once: the tensor cores
// have to run nearly all the time while every byte is read once.
//
// Design. A persistent block of four consumer warpgroups and one producer
// warp owns one 64-output slab of the weights (blockIdx.y) and walks tiles
// of 4 image rows x 64 pixels. The producer loads, by TMA with the 128-byte
// swizzle, the tile's halo as one box of 6 rows x 72 pixels x 64 channels
// from the NHWC map (C rounded up to 8: TMA zero-fills the rows, columns and
// channels outside the map, so the padding needs no copy) through a
// two-stage ring, so the next tile's halo lands under this tile's products.
// Warpgroup w computes output row w of the tile as an implicit GEMM: M = the
// row's 64 pixels, N = 64 outputs, K = 9 taps x 64 channels, wgmma
// m64n64k16. The A operand of tap (dy, dx) is the halo run of row w + dy
// starting at pixel dx: a descriptor whose start address is shifted by dx
// rows of 128 bytes (sm90.cuh desc()). B is the tap's (64 channels x 64
// outputs) slab, MN-major. Where the input has at most 64 channels the nine
// slabs (72 KB) stay in shared memory for the whole kernel, loaded once;
// wider inputs stream a slab for each (channel chunk, tap) through a
// four-stage ring. Epilogue: + bias in f32, ReLU, one rounding into a
// swizzled staging tile, one TMA store of the row's 64 pixels x 64 outputs
// (clipped at the map's edges).
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

namespace S = tux::sm90;

constexpr int KC = 64;                    // channels of a chunk: 128 B
constexpr int NT = 64;                    // outputs of a block
constexpr int WG = 4;                     // consumer warpgroups: tile rows
constexpr int TW = 64;                    // output pixels of a tile row
constexpr int HX = 72;                    // halo pixels of a row (TW + 2, x8)
constexpr int HROW = HX * 128;            // bytes of a halo row: 9 x 1024
constexpr int HALO = (WG + 2) * HROW;     // a ring stage
constexpr int SLAB = KC * NT * 2;         // one (tap, chunk) weight slab
constexpr int OUT = TW * NT * 2;          // a warpgroup's staging tile
constexpr int HSTAGES = 2;
constexpr int WSTAGES = 4;                // streamed weights
constexpr int THREADS = WG * 128 + 32;
constexpr int MAX_SMEM = 232448;

// RES: all nine slabs resident (C <= 64); else a ring of WSTAGES slabs.
template <bool RES>
struct ConvSmem {
  static constexpr int W_BYTES = (RES ? 9 : WSTAGES) * SLAB;
  static constexpr int BARS = 2 * HSTAGES + (RES ? 1 : 2 * WSTAGES);
  static constexpr int BYTES =
      1024 + W_BYTES + HSTAGES * HALO + WG * OUT + BARS * 8;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ int sw128(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) S::mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == N) {
    stage = 0;
    phase ^= 1;
  }
}

// The A operand (64 pixels x k16 step s, K-major) of a 128B-swizzled halo
// row, starting `shift` pixels in.
__device__ __forceinline__ uint64_t desc_shift(const unsigned char* row,
                                               int shift, int s) {
  return S::desc(row + 128 * shift + 32 * s, 16, 1024);
}

// Tile u: batch b, first row y0, first column x0.
__device__ __forceinline__ void tile_of(int u, int tiles_x, int tiles_y,
                                        int& b, int& y0, int& x0) {
  x0 = (u % tiles_x) * TW;
  y0 = ((u / tiles_x) % tiles_y) * WG;
  b = u / (tiles_x * tiles_y);
}

// xmap: x (B, H, W, C8) as (C8, W, H, B), box (64, 72, 6, 1); wmap: the
// weights (9 C16, O64) as taps x channels rows of outputs, box (64, 64);
// omap: out (B, H, W, O8) as (O8, W, H, B), box (64, 64, 1, 1). All with the
// 128B swizzle. bias (O64) f32.
template <bool RES>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap omap,
               const float* __restrict__ bias, int H, int C16, int relu,
               int tiles_x, int tiles_y, int n_tiles) {
  using L = ConvSmem<RES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = align1024(smem_raw);
  unsigned char* halo = ws + L::W_BYTES;
  unsigned char* out = halo + HSTAGES * HALO;
  uint64_t* h_full = reinterpret_cast<uint64_t*>(out + WG * OUT);
  uint64_t* h_empty = h_full + HSTAGES;
  uint64_t* w_full = h_empty + HSTAGES;  // RES: one; else WSTAGES
  uint64_t* w_empty = w_full + WSTAGES;  // streamed only
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * NT;
  const int chunks = (C16 + KC - 1) / KC;
  if (tid == 0) {
    for (int s = 0; s < HSTAGES; ++s) {
      S::mbar_init(&h_full[s], 1);
      S::mbar_init(&h_empty[s], WG * 4);
    }
    if constexpr (RES) {
      S::mbar_init(w_full, 1);
    } else {
      for (int s = 0; s < WSTAGES; ++s) {
        S::mbar_init(&w_full[s], 1);
        S::mbar_init(&w_empty[s], WG * 4);
      }
    }
    S::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= WG * 128) {  // producer warp: one thread issues every copy
    if (tid != WG * 128) return;
    if constexpr (RES) {
      S::mbar_expect_tx(w_full, 9 * SLAB);
      for (int tap = 0; tap < 9; ++tap)
        S::tma_load_2d(ws + tap * SLAB, &wmap, w_full, n0, tap * C16);
    }
    int hs = 0, wst = 0;
    uint32_t h_phase = 0, w_phase = 0;
    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
      int b, y0, x0;
      tile_of(u, tiles_x, tiles_y, b, y0, x0);
      for (int ch = 0; ch < chunks; ++ch) {
        S::mbar_wait(&h_empty[hs], h_phase ^ 1);
        S::mbar_expect_tx(&h_full[hs], HALO);
        S::tma_load_4d(halo + hs * HALO, &xmap, &h_full[hs], ch * KC, x0 - 1,
                       y0 - 1, b);
        advance<HSTAGES>(hs, h_phase);
        if constexpr (!RES) {
          for (int tap = 0; tap < 9; ++tap) {
            S::mbar_wait(&w_empty[wst], w_phase ^ 1);
            S::mbar_expect_tx(&w_full[wst], SLAB);
            S::tma_load_2d(ws + wst * SLAB, &wmap, &w_full[wst], n0,
                           tap * C16 + ch * KC);
            advance<WSTAGES>(wst, w_phase);
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned char* stg = out + wg * OUT;
  // Bias of this thread's outputs n0 + 8 j + 2 t + e.
  float bs[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) bs[i] = bias[n0 + 8 * (i >> 1) + 2 * t + (i & 1)];
  if constexpr (RES) S::mbar_wait(w_full, 0);
  float acc[32];
  int hs = 0, wst = 0;
  uint32_t h_phase = 0, w_phase = 0;
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    int b, y0, x0;
    tile_of(u, tiles_x, tiles_y, b, y0, x0);
    for (int ch = 0; ch < chunks; ++ch) {
      S::mbar_wait(&h_full[hs], h_phase);
      const unsigned char* hrow = halo + hs * HALO + wg * HROW;
      S::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const unsigned char* slab = ws + tap * SLAB;
        if constexpr (!RES) {
          S::mbar_wait(&w_full[wst], w_phase);
          slab = ws + wst * SLAB;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
          S::wgmma_ss_n64(acc, desc_shift(hrow + dy * HROW, dx, s),
                          S::desc_b(slab, s), ch | tap | s);
        S::wgmma_commit();
        if constexpr (!RES) {
          S::wgmma_wait<0>();
          release(&w_empty[wst], lane);
          advance<WSTAGES>(wst, w_phase);
        }
      }
      S::wgmma_wait<0>();
      release(&h_empty[hs], lane);
      advance<HSTAGES>(hs, h_phase);
    }
    S::fence_acc(acc);

    // Epilogue: + bias, ReLU, one rounding into the staging tile (64 pixels
    // x 64 outputs, swizzled), then one TMA store, clipped at the edges.
    if (wtid == 0) S::store_wait_read<0>();
    S::named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;
        float v0 = acc[4 * j + 2 * i] + bs[2 * j];
        float v1 = acc[4 * j + 2 * i + 1] + bs[2 * j + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(stg + sw128(r, j) + 4 * t) =
            pack(v0, v1);
      }
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
    if (wtid == 0) {
      if (y0 + wg < H) S::tma_store_4d(&omap, stg, n0, x0, y0 + wg, b);
      S::store_commit();
    }
  }
  if (wtid == 0) S::store_wait_all();
}

// An NHWC map (B, H, W, Cm) as (Cm, W, H, B), box (64, box_w, box_h, 1).
int map_nhwc(CUtensorMap* m, const void* p, int B, int H, int W, int Cm,
             int box_w, int box_h) {
  const uint64_t dims[4] = {uint64_t(Cm), uint64_t(W), uint64_t(H),
                            uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(Cm) * 2, uint64_t(W) * Cm * 2,
                               uint64_t(H) * W * Cm * 2};
  const uint32_t box[4] = {64, uint32_t(box_w), uint32_t(box_h), 1};
  return S::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A (rows, cols) bf16 row-major matrix, box (64 columns, box_rows rows).
int map_matrix(CUtensorMap* m, const void* p, int rows, int cols,
               int box_rows) {
  const uint64_t dims[2] = {uint64_t(cols), uint64_t(rows)};
  const uint64_t strides[1] = {uint64_t(cols) * 2};
  const uint32_t box[2] = {64, uint32_t(box_rows)};
  return S::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool RES>
int launch(const CUtensorMap& x, const CUtensorMap& w, const CUtensorMap& o,
           const void* bias, int B, int H, int W, int C16, int O64, int relu,
           int device, void* stream) {
  using L = ConvSmem<RES>;
  static_assert(L::BYTES <= MAX_SMEM, "conv3x3 shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return int(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + WG - 1) / WG;
  const int n_tiles = B * tiles_y * tiles_x;
  const int o_tiles = O64 / NT;
  int per = S::sm_count(device) / o_tiles;
  if (per < 1) per = 1;
  const dim3 grid(n_tiles < per ? n_tiles : per, o_tiles);
  conv3x3_kernel<RES>
      <<<grid, THREADS, L::BYTES, static_cast<cudaStream_t>(stream)>>>(
          x, w, o, static_cast<const float*>(bias), H, C16, relu, tiles_x,
          tiles_y, n_tiles);
  return int(cudaGetLastError());
}

// The descriptor-shift probe: one warpgroup computes D (64 x 64, f32) =
// A[shift : shift + 64] . B with A (72 x 64) and B (64 x 64) bf16 loaded by
// TMA with the 128B swizzle, A through desc_shift. D row-major.
__global__ void __launch_bounds__(128)
desc_probe_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  float* __restrict__ d, int shift) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a = align1024(smem_raw);
  unsigned char* bt = a + HROW;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bt + SLAB);
  const int tid = threadIdx.x;
  if (tid == 0) {
    S::mbar_init(bar, 1);
    S::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    S::mbar_expect_tx(bar, HROW + SLAB);
    S::tma_load_2d(a, &amap, bar, 0, 0);
    S::tma_load_2d(bt, &bmap, bar, 0, 0);
  }
  S::mbar_wait(bar, 0);
  float acc[32];
  S::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    S::wgmma_ss_n64(acc, desc_shift(a, shift, s), S::desc_b(bt, s), s);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(acc);
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] =
          acc[4 * j + e];
}

}  // namespace

// x (B,H,W,C8) bf16 with C8 = C rounded up to 8 (channels past C zero);
// wt (9 C16, O64) bf16 = w[dy][dx][c][o] as rows (tap, c), zero-padded to
// C16 = C rounded up to 16 and O64 = O rounded up to 64; bias (O64) f32
// (zeros for none); out (B,H,W,O8) bf16, O8 = O rounded up to 8. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tux_conv3x3_any(const void* x, const void* wt, const void* bias,
                               void* out, int B, int H, int W, int C8,
                               int C16, int O8, int O64, int relu, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (C8 % 8 || C16 % 16 || O8 % 8 || O64 % 64 || C16 < C8 || O64 < O8 ||
      C16 > C8 + 8)
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0 || O8 == 0) return 0;
  CUtensorMap xm, wm, om;
  int e = map_nhwc(&xm, x, B, H, W, C8, HX, WG + 2);
  if (e == 0) e = map_matrix(&wm, wt, 9 * C16, O64, KC);
  if (e == 0) e = map_nhwc(&om, out, B, H, W, O8, TW, 1);
  if (e != 0) return e;
  return C16 <= KC ? launch<true>(xm, wm, om, bias, B, H, W, C16, O64, relu,
                                  device, stream)
                   : launch<false>(xm, wm, om, bias, B, H, W, C16, O64, relu,
                                   device, stream);
}

// a (72, 64), b (64, 64) bf16; d (64, 64) f32. Returns a cudaError_t.
extern "C" int tux_conv3x3_desc_probe(const void* a, const void* b, void* d,
                                      int shift, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (shift < 0 || shift > HX - TW) return int(cudaErrorInvalidValue);
  CUtensorMap am, bm;
  int e = map_matrix(&am, a, HX, 64, HX);
  if (e == 0) e = map_matrix(&bm, b, 64, 64, 64);
  if (e != 0) return e;
  const int smem = 1024 + HROW + SLAB + 8;
  desc_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<float*>(d), shift);
  return int(cudaGetLastError());
}
