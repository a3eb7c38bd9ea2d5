// conv1 of FastTransformer for Hopper (sm_90a): 3x3 zero-padded conv,
// 3 -> 64 channels, NHWC bf16, with JAX's epilogue order.
//
// Replaces two TPU kernels of transformerupscaler_tpu/ops/pallas/stream.py,
// which compute one function:
//   conv1_dots_stream (:1269, kernel call conv1_stream_call :1308)
//   conv1_flat_stream (:1385)
// The first expanded the 27 taps into a K=108 operand in XLA and ran one dot
// per row slab; the second assembled that operand inside the kernel, which
// Mosaic refused on the TPU (:1398-1401). What it computes:
//   acc = sum over (dy, dx, c) of x[y+dy-1][x+dx-1][c] * w[dy][dx][c][n]
//         f32 accumulation, zero-padded x
//   out = bf16(acc), then + bf16(bias) in bf16 arithmetic (an f32 add rounded
//         once to bf16), then ReLU
// That is the TPU kernel's order (stream.py:1259-1263): the sum is rounded
// FIRST, unlike the port's other stream kernels with an f32 epilogue.
//
// Bound on the H100 at 720x1280: 5.5 MB in and 118 MB out, 0.037 ms at
// 3.35 TB/s; 3.2 GFLOP (K = 27) is 0.0032 ms at 989 TF/s. The kernel is
// bound by writing its output.
//
// What held the earlier design (an im2col tile kernel, 0.1453 ms) back: a
// block per 8 x 32 tile ran five phases between __syncthreads (scalar halo
// loads with two divides an element, a weight copy, an im2col operand of
// 8192 scalar shared-memory stores, the products, element-wise staged
// stores), none overlapping another inside the block, 3600 blocks each
// copying the weights, and a wrapper that rebuilt the weight slab with
// four device launches a call. Its output left at 0.81 TB/s.
//
// Design. Persistent blocks, two an SM (__launch_bounds__(256, 2)), walk
// the frame's 8 x 32 pixel tiles in row-major order.
// - Input: a two-stage ring of halo tiles, 10 rows x HP = 112 bf16 elements
//   (pixel x0 - 1's first channel at element LEAD = 5). The next tile's
//   halo is requested at the top of a tile, so it arrives while this one
//   computes. Where W % 8 == 0 (row stride 6W bytes a multiple of 16) it is
//   one TMA box of a 3-D map over (B, H, 3W), started at column element
//   3 x0 - 8: the box's innermost start has to lie on 16 bytes (a start at
//   3 x0 - 4 faulted on the card as an illegal instruction). TMA's zero
//   fill gives the padding at every edge and never reads the next row or
//   image. Otherwise every thread issues 4-byte cp.async
//   copies; a row whose first element is not 4-byte aligned (W odd, every
//   other row) lands one element further in (its shift s, derived in the
//   gather from the row's parity), and the words that straddle the image's
//   edges are written by plain stores with their outside half zero.
// - No im2col pass: each thread gathers its mma.sync m16n8k16 A fragments
//   from the halo into registers, two 16-bit loads a fragment register.
//   The tap table (kernels/stream.py conv1_taps, computed on the host and
//   passed by value) gives, for operand column k = (dy * 3 + dx) * 3 + c,
//   the element offset from the pixel's slot; -1 for k >= 27 (zero). A
//   thread's 8 columns and their offsets are fixed for the whole kernel.
// - Weights resident: each block reads the HWIO weights (f32 or bf16, as
//   the caller holds them; rounded to bf16 here) once into a [n][k] slab,
//   K padded 27 -> 32, and the bias into shared memory. The wrapper
//   launches nothing else.
// - Products: warp w owns tile row w, two M fragments of 16 pixels by 64
//   outputs, two k16 steps: 32 mma.sync a tile. At 9% of the byte bound
//   they do not need wgmma.
// - Output by TMA store: the rounded bf16 tile goes into one of two
//   staging tiles in the 128B swizzle (conflict-free stores from the
//   accumulator) and leaves as one TMA box of 64 channels x 32 pixels x 8
//   rows (clipped at the frame's edges, so any H and W), a bulk group
//   each; a staging tile is written again only after its group has been
//   read (cp.async.bulk.wait_group.read 1), so the store of tile i streams
//   while tile i + 1 loads and multiplies.
// Two __syncthreads a tile: one after the staging tile is free (and, on
// the cp.async path, the halo has landed), one before the store.
//
// ptxas (nvcc 12.9, sm_90a): see PERF.md, row 12.
#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace S = tux::sm90;
using bf16 = __nv_bfloat16;

constexpr int COUT = 64;
constexpr int TH = 8;                 // tile rows == warps per block
constexpr int TW = 32;                // tile columns: two M fragments a warp
constexpr int THREADS = 256;
constexpr int K = 27;                 // taps x input channels
constexpr int KP = 32;                // K padded to two k16 steps
constexpr int HR = TH + 2;            // halo rows
constexpr int HP = 112;               // halo row pitch (kernels/stream.py
                                      // CONV1_PITCH), elements
constexpr int LEAD = 5;               // pixel x0 - 1's first channel
constexpr int HALO_BYTES = HR * HP * 2;  // 2240: one TMA box
constexpr int HALO_STAGE = 2304;         // a ring stage, 128-byte aligned
constexpr int WS = KP + 8;               // weight row stride (elements)
constexpr int STAGE = TH * TW * COUT * 2;  // 32 KB: a staged output tile
constexpr int OFF_HALO = 2 * STAGE;
constexpr int OFF_W = OFF_HALO + 2 * HALO_STAGE;
constexpr int OFF_BIAS = OFF_W + COUT * WS * 2;
constexpr int OFF_TAPS = OFF_BIAS + COUT * 4;
constexpr int OFF_BAR = OFF_TAPS + KP * 4;
constexpr int SMEM = 1024 + OFF_BAR + 2 * 8;  // 1024: alignment slack

// For each operand column k, the element offset from an output pixel's
// slot in the halo tile, -1 where the column is zero padding.
struct Taps {
  int off[KP];
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ int sw128(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t ld_u16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   S::smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The halo of the tile at (b, y0, x0) into a ring stage by 4-byte cp.async
// copies, every thread a share: word m of halo row r holds row elements
// 2m, 2m + 1, that is halo elements j = 2m - LEAD - s (pixel x0 - 1 + j / 3,
// channel j % 3), where the row's shift s = (W odd) & (b H + y) makes the
// word's source 4-byte aligned. Words that reach outside the image (or
// rows outside it) are written as zeros by plain stores.
__device__ __forceinline__ void halo_async(unsigned char* dst,
                                           const bf16* __restrict__ x, int b,
                                           int y0, int x0, int H, int W) {
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
  for (int i = threadIdx.x; i < HR * (HP / 2); i += THREADS) {
    const int r = i / (HP / 2);
    const int m = i - r * (HP / 2);
    const int y = y0 - 1 + r;
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * HP * 2 + 4 * m);
    if (y < 0 || y >= H) {
      *d = 0;
      continue;
    }
    const long long row = (static_cast<long long>(b) * H + y) * W * 3;
    const int s = W & (b * H + y) & 1;
    const int c = 3 * x0 - 8 + 2 * m - s;  // column element of the word
    const bool lo = c >= 0 && c < 3 * W;
    const bool hi = c + 1 >= 0 && c + 1 < 3 * W;
    if (lo && hi) {
      cp_async4(d, xs + row + c);
    } else {
      *d = (lo ? uint32_t(xs[row + c]) : 0u) |
           (hi ? uint32_t(xs[row + c + 1]) << 16 : 0u);
    }
  }
}

// Tile u: batch b, first row y0, first column x0.
__device__ __forceinline__ void tile_of(int u, int tiles_x, int tiles_y,
                                        int& b, int& y0, int& x0) {
  x0 = (u % tiles_x) * TW;
  y0 = ((u / tiles_x) % tiles_y) * TH;
  b = u / (tiles_x * tiles_y);
}

// Request tile u's halo into ring stage st: one TMA box on full[st] issued
// by thread 0, or every thread's cp.async copies. xmap is the address of
// the kernel's __grid_constant__ parameter, taken in the kernel's body.
template <bool TMA>
__device__ __forceinline__ void load_halo(const CUtensorMap* xmap,
                                          uint64_t* full, unsigned char* halo,
                                          const bf16* __restrict__ x, int u,
                                          int st, int tiles_x, int tiles_y,
                                          int H, int W) {
  int b, y0, x0;
  tile_of(u, tiles_x, tiles_y, b, y0, x0);
  unsigned char* dst = halo + st * HALO_STAGE;
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      S::mbar_expect_tx(&full[st], HALO_BYTES);
      S::tma_load_3d(dst, xmap, &full[st], 3 * x0 - 8, y0 - 1, b);
    }
  } else {
    halo_async(dst, x, b, y0, x0, H, W);
  }
}

// xmap (TMA only): x (B, H, W, 3) as (3W, H, B), box (HP, HR, 1), no
// swizzle; omap: out (B, H, W, 64) as (64, W, H, B), box (64, TW, TH, 1),
// 128B swizzle. w: (27, 64) HWIO rows, f32 if w_f32 else bf16; bias: (64)
// f32 if bias_f32 else bf16, or null.
template <bool TMA>
__global__ void __launch_bounds__(THREADS, 2)
conv1_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap omap,
             const __grid_constant__ Taps taps, const bf16* __restrict__ x,
             const void* __restrict__ w, int w_f32,
             const void* __restrict__ bias, int bias_f32, int H, int W,
             int relu, int tiles_x, int tiles_y, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* halo = sm + OFF_HALO;
  bf16* w_sm = reinterpret_cast<bf16*>(sm + OFF_W);
  float* b_sm = reinterpret_cast<float*>(sm + OFF_BIAS);
  int* t_sm = reinterpret_cast<int*>(sm + OFF_TAPS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BAR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // The first tile's halo before anything else.
  if (TMA && tid == 0) {
    S::mbar_init(&full[0], 1);
    S::mbar_init(&full[1], 1);
    S::fence_barrier_init();
  }
  if (blockIdx.x < n_tiles)
    load_halo<TMA>(&xmap, full, halo, x, blockIdx.x, 0, tiles_x, tiles_y, H,
                   W);
  if constexpr (!TMA) cp_async_commit();

  // Weights as [n][k] rows, rounded to bf16, zero for k >= 27; the bias
  // rounded to bf16; the tap table.
  for (int i = tid; i < COUT * KP; i += THREADS) {
    const int n = i & (COUT - 1);
    const int k = i >> 6;
    bf16 v = __float2bfloat16_rn(0.f);
    if (k < K)
      v = w_f32
              ? __float2bfloat16_rn(static_cast<const float*>(w)[k * COUT + n])
              : static_cast<const bf16*>(w)[k * COUT + n];
    w_sm[n * WS + k] = v;
  }
  if (tid < COUT) {
    float v = 0.f;
    if (bias != nullptr)
      v = __bfloat162float(
          bias_f32 ? __float2bfloat16_rn(static_cast<const float*>(bias)[tid])
                   : static_cast<const bf16*>(bias)[tid]);
    b_sm[tid] = v;
  }
  if (tid < KP) t_sm[tid] = taps.off[tid];
  __syncthreads();

  // This thread's 8 operand columns k = 16 kk + 8 e + 2 t + p, q = 4 kk +
  // 2 e + p: byte offsets in a halo stage from its warp's row and pixel g,
  // which dy rows are odd (the cp.async shift), and which are padding.
  int aoff[8];
  uint32_t odd_dy = 0;
  uint32_t keep[4];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int o = t_sm[16 * (q >> 2) + 8 * ((q >> 1) & 1) + 2 * t + (q & 1)];
    const int oo = o < 0 ? 0 : o;
    aoff[q] = 2 * (warp * HP + 3 * g + oo);
    odd_dy |= uint32_t((oo / HP) & 1) << q;
    if ((q & 1) == 0) keep[q >> 1] = 0;
    keep[q >> 1] |= o < 0 ? 0u : (q & 1 ? 0xffff0000u : 0x0000ffffu);
  }
  if (TMA || (W & 1) == 0) odd_dy = 0;

  int i = 0;
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x, ++i) {
    const int st = i & 1;
    int b, y0, x0;
    tile_of(u, tiles_x, tiles_y, b, y0, x0);
    // The staging tile of tile i - 2 free, the next halo requested (its
    // stage was read by tile i - 1, before the last __syncthreads).
    if (tid == 0) S::store_wait_read<1>();
    if (u + int(gridDim.x) < n_tiles)
      load_halo<TMA>(&xmap, full, halo, x, u + gridDim.x, st ^ 1, tiles_x,
                     tiles_y, H, W);
    if constexpr (!TMA) {
      cp_async_commit();
      cp_async_wait<1>();
    }
    __syncthreads();
    if constexpr (TMA) S::mbar_wait(&full[st], (i >> 1) & 1);

    // A fragments [f][kk][reg] from the halo: reg 2 e + hh holds rows
    // g + 8 hh of M fragment f, columns q = 4 kk + 2 e + (0, 1).
    const unsigned char* hs = halo + st * HALO_STAGE;
    const uint32_t sh = TMA ? 0u : uint32_t(W & (b * H + y0 - 1 + warp) & 1);
    uint32_t a[2][2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 4 * kk + 2 * e;
        const unsigned char* p0 =
            hs + aoff[q] + 2 * ((sh ^ (odd_dy >> q)) & 1);
        const unsigned char* p1 =
            hs + aoff[q + 1] + 2 * ((sh ^ (odd_dy >> (q + 1))) & 1);
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int px = 2 * 3 * (16 * f + 8 * hh);
            a[f][kk][2 * e + hh] =
                (ld_u16(p0 + px) | (ld_u16(p1 + px) << 16)) & keep[2 * kk + e];
          }
      }

    float acc[2][COUT / 8][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[f][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j) {
        uint32_t bw[2];
        tux::load_b(bw, w_sm + (j * 8 + g) * WS + kk * 16, t);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          tux::mma_bf16(acc[f][j], a[f][kk][0], a[f][kk][1], a[f][kk][2],
                        a[f][kk][3], bw[0], bw[1]);
      }

    // Epilogue: round the sum, add the bf16 bias in f32, round again, ReLU,
    // into staging tile st (row r = tile pixel, 128B swizzle).
    unsigned char* so = sm + st * STAGE;
    const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(b_sm + 8 * j + 2 * t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * TW + 16 * f + 8 * hh + g;
          const float2 s = __bfloat1622float2(__floats2bfloat162_rn(
              acc[f][j][2 * hh], acc[f][j][2 * hh + 1]));
          __nv_bfloat162 o = __floats2bfloat162_rn(s.x + bv.x, s.y + bv.y);
          if (relu) o = __hmax2(o, zero2);
          *reinterpret_cast<__nv_bfloat162*>(so + sw128(r, j) + 4 * t) = o;
        }
      }
    S::fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      S::tma_store_4d(&omap, so, 0, x0, y0, b);
      S::store_commit();
    }
  }
  if (tid == 0) S::store_wait_all();
}

// x (B, H, W, 3) bf16 as the rank-3 map (3W, H, B) whose rows TMA reads
// with zero fill past every edge.
int map_rows(CUtensorMap* m, const void* x, int B, int H, int W) {
  const uint64_t dims[3] = {3ull * W, uint64_t(H), uint64_t(B)};
  const uint64_t strides[2] = {6ull * W, 6ull * W * H};
  const uint32_t box[3] = {HP, HR, 1};
  return S::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool TMA>
int launch(const CUtensorMap& xm, const CUtensorMap& om, const Taps& taps,
           const void* x, const void* w, int w_f32, const void* bias,
           int bias_f32, int B, int H, int W, int relu, int device,
           cudaStream_t stream) {
  auto kern = conv1_kernel<TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return int(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int n_tiles = B * tiles_y * tiles_x;
  const int slots = 2 * S::sm_count(device);
  kern<<<n_tiles < slots ? n_tiles : slots, THREADS, SMEM, stream>>>(
      xm, om, taps, static_cast<const bf16*>(x), w, w_f32, bias, bias_f32, H,
      W, relu, tiles_x, tiles_y, n_tiles);
  return int(cudaGetLastError());
}

}  // namespace

// taps: the host's table of 32 ints (kernels/stream.py conv1_taps), copied
// into the launch. Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_conv1(const void* x, const void* w, const void* bias,
                         void* out, const void* taps, int B, int H, int W,
                         int relu, int w_f32, int bias_f32, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Taps tp;
  for (int k = 0; k < KP; ++k) {
    tp.off[k] = static_cast<const int*>(taps)[k];
    // Every column inside the 3 halo rows a pixel reads, or -1.
    if (tp.off[k] < -1 || tp.off[k] > 2 * HP + 8 + LEAD)
      return int(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || W == 0) return 0;
  CUtensorMap xm = {}, om;
  int e = S::map_nhwc(&om, out, B, H, W, COUT, TW, TH);
  if (e) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 8 == 0) {
    e = map_rows(&xm, x, B, H, W);
    if (e) return e;
    return launch<true>(xm, om, tp, x, w, w_f32, bias, bias_f32, B, H, W,
                        relu, device, s);
  }
  return launch<false>(xm, om, tp, x, w, w_f32, bias, bias_f32, B, H, W, relu,
                       device, s);
}
