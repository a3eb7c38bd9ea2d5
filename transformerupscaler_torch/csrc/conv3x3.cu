// NHWC 3x3 conv (stride 1, zero padding 1) with an optional bias and ReLU,
// any input and output width, for Hopper (sm_90a): TMA halo tiles, an
// implicit GEMM on wgmma, a TMA-stored epilogue, bf16 or int8 out; and its
// int8-input form.
//
// Replaces four TPU kernels:
//   transformerupscaler_tpu/ops/pallas/conv3x3.py:73 conv3x3_pallas, the
//     JAX package's archived conv, which its tests pin at (C, O) = (64, 64),
//     (64, 256), (256, 16), (8, 8), (16, 8), batch 3 and odd heights
//     (kernels/conv3x3.py);
//   ops/pallas/stream.py:425 conv3x3_deint_stream and :82
//     conv3x3_packed_stream, the serving 3x3 64 -> 64 conv, bf16 out or,
//     with out_scale (stream.py:417-422, 474-475), int8 out
//     (kernels/stream.py conv3x3_stream). The TPU kernels' width-2 packing
//     and deinterleave4 layout fed 128 MXU lanes; here the maps stay NHWC;
//   ops/pallas/stream.py:147 conv3x3_packed_int8_stream, the int8 scopes'
//     3x3 64 -> 64 conv (kernels/stream.py conv3x3_int8_stream), in the
//     int8 form below.
//
//   out[b, y, x, o] = act(sum_{dy,dx,c} x[b, y+dy-1, x+dx-1, c]
//                         * w[dy, dx, c, o] + bias[o])
// bf16 operands, f32 accumulation, the f32 bias added in f32, then the ReLU,
// then one rounding: to bf16, or (qs given) to int8 as
//   q = int8(clamp(rint(__fmul_rn(v, qs[o])), -127, 127))
// from the f32 value v, never from a bf16-rounded one (qs = f32(1 / s)).
// The bias arrives as the caller's f32 values: conv3x3_stream passes them
// unrounded; the archived conv's wrapper rounds them to bf16 first, as its
// TPU kernel does (conv3x3.py:103-104).
//
// Bound on the H100 at 720x1280, 64 -> 64 (989 TF/s bf16, 3.35 TB/s): 67.9
// GFLOP, 0.069 ms; 236 MB moved, 0.070 ms (int8 out: 177 MB, 0.053 ms, so
// the operations bound it). Both at once: the tensor cores have to run
// nearly all the time while every byte is read once.
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
// swizzled staging tile (bf16: 128-byte rows, the 128B swizzle; int8:
// 64-byte rows, the 64B swizzle), one TMA store of the row's 64 pixels x 64
// outputs (clipped at the map's edges).
//
// The int8 form (tux_conv3x3_int8, C = O = 64): int8 activations quantized
// per input channel and int8 weights with that scale folded in, quantized
// per output with f32 scales ks (ops.quant.fold_conv_kernel);
//   out = act(float(acc) * ks[o] + bias[o]),
// acc the int32 sum of the int8 products, exact in any order, the multiply
// and the add each rounded on its own (no fused multiply-add, as the plain
// version ops.conv.conv2d_int8_q), then one rounding to bf16 or f32: bit for
// bit with the plain version. The same kernel with the operand type as a
// template parameter: the halo box is 6 rows x 72 pixels x 64 bytes in the
// 64B swizzle (half the bf16 box; three ring stages), each tap two wgmma
// m64n64k32 s8 whose A starts dx 64-byte pixels into the halo row (an odd
// shift starts inside a 128-byte line of the swizzle, which the hardware
// reads as well: tests/test_torch_gpu.py test_wgmma_i8_descriptor_row_shift),
// B nine resident K-major slabs (outputs x 64 channels, 36 KB: int8 wgmma
// has no transposed B). f32 out stages 128-byte rows of 32 outputs and
// stores two boxes. Bound at 720x1280, bf16 out: 59 MB of int8 read and 118
// MB written, 0.053 ms at 3.35 TB/s; 68 G int8 operations, 0.034 ms at
// 1,979 TOP/s.
#include <cuda_bf16.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

namespace S = tux::sm90;

constexpr int KC = 64;                    // channels of a chunk
constexpr int NT = 64;                    // outputs of a block
constexpr int WG = 4;                     // consumer warpgroups: tile rows
constexpr int TW = 64;                    // output pixels of a tile row
constexpr int HX = 72;                    // halo pixels of a row (TW + 2, x8)
constexpr int OUT = TW * NT * 2;          // a warpgroup's staging tile
constexpr int WSTAGES = 4;                // streamed weights
constexpr int THREADS = WG * 128 + 32;
constexpr int MAX_SMEM = 232448;

// What the epilogue writes: bf16; int8, quantized with qs; f32, as two
// 32-output halves of 128-byte rows.
enum Out { OUT_BF16, OUT_I8, OUT_F32 };

// The operands. bf16: a halo pixel's 64 channels in a 128-byte row (128B
// swizzle), MN-major weight slabs, wgmma k16 steps. I8IN, int8: 64-byte rows
// (64B swizzle), K-major slabs (rows of outputs, 64 channels each: int8
// wgmma has no transpose), k32 steps, three halo stages.
template <bool I8IN>
struct Operand {
  static constexpr int PIX = I8IN ? 64 : 128;   // bytes of a halo pixel
  static constexpr int HROW = HX * PIX;          // a halo row: 9 x 1024 or 512
  static constexpr int HALO = (WG + 2) * HROW;   // a ring stage
  static constexpr int SLAB = KC * NT * (I8IN ? 1 : 2);  // (tap, chunk)
  static constexpr int HSTAGES = I8IN ? 3 : 2;
};

// RES: all nine slabs resident (C <= 64); else a ring of WSTAGES slabs.
template <bool RES, int OUTK, bool I8IN>
struct ConvSmem {
  using O = Operand<I8IN>;
  static constexpr int OUT_BYTES = OUTK == OUT_F32 ? 2 * OUT : OUT;
  static constexpr int W_BYTES = (RES ? 9 : WSTAGES) * O::SLAB;
  static constexpr int BARS = 2 * O::HSTAGES + (RES ? 1 : 2 * WSTAGES);
  static constexpr int BYTES = 1024 + W_BYTES + O::HSTAGES * O::HALO +
                               WG * OUT_BYTES + BARS * 8;
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

// Byte offset of bytes 8 j .. 8 j + 7 of row r in a 64B-swizzled tile of
// 64-byte rows (int8 staging): 16-byte chunk j / 2 XORed with (r / 2) % 4.
__device__ __forceinline__ int sw64(int r, int j) {
  return r * 64 + (((j >> 1) ^ ((r >> 1) & 3)) << 4) + ((j & 1) << 3);
}

// int8(clamp(rint(v * qs), -127, 127)): the clamp from below, then one
// convert that rounds half to even and saturates at 127.
__device__ __forceinline__ int8_t quant(float v, float qs) {
  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;"
      : "=r"(q)
      : "f"(fmaxf(__fmul_rn(v, qs), -127.f)));
  return int8_t(q);
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

// xmap: x (B, H, W, C8) as (C8, W, H, B), box (64, 72, 6, 1), bf16 with the
// 128B swizzle or, I8IN, int8 (C8 = 64) with the 64B swizzle; wmap: bf16,
// the weights (9 C16, O64) as taps x channels rows of outputs, box (64, 64);
// I8IN, the K-major slabs (9 x 64, 64) = w[dy][dx][o][c], box (64, 64);
// omap: out (B, H, W, O8) as (O8, W, H, B), box (64, 64, 1, 1), bf16 with
// the 128B swizzle, OUT_I8 int8 with the 64B swizzle, OUT_F32 box (32, 64,
// 1, 1) f32 with the 128B swizzle. bias (O64) f32; scale (O64) f32: qs for
// OUT_I8, the weight scales ks for I8IN.
template <bool RES, int OUTK, bool I8IN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap omap,
               const float* __restrict__ bias,
               const float* __restrict__ scale, int H, int C16, int relu,
               int tiles_x, int tiles_y, int n_tiles) {
  using L = ConvSmem<RES, OUTK, I8IN>;
  using O = Operand<I8IN>;
  constexpr int HSTAGES = O::HSTAGES, HROW = O::HROW, HALO = O::HALO,
                SLAB = O::SLAB;
  static_assert(RES || !I8IN, "int8 operands: C = 64, resident weights");
  static_assert(OUTK != OUT_I8 || !I8IN, "int8 in, bf16 or f32 out");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = align1024(smem_raw);
  unsigned char* halo = ws + L::W_BYTES;
  unsigned char* out = halo + HSTAGES * HALO;
  uint64_t* h_full = reinterpret_cast<uint64_t*>(out + WG * L::OUT_BYTES);
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
      for (int tap = 0; tap < 9; ++tap) {
        if constexpr (I8IN)
          S::tma_load_2d(ws + tap * SLAB, &wmap, w_full, 0, tap * NT + n0);
        else
          S::tma_load_2d(ws + tap * SLAB, &wmap, w_full, n0, tap * C16);
      }
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
  unsigned char* stg = out + wg * L::OUT_BYTES;
  // Bias of this thread's outputs n0 + 8 j + 2 t + e.
  float bs[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) bs[i] = bias[n0 + 8 * (i >> 1) + 2 * t + (i & 1)];
  if constexpr (RES) S::mbar_wait(w_full, 0);
  std::conditional_t<I8IN, int, float> acc[32];
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
        if constexpr (I8IN) {
          // The tap's A: the halo row dy + wg started dx 64-byte pixels in.
#pragma unroll
          for (int s = 0; s < 2; ++s)
            S::wgmma_i8_ss_n64(
                acc, S::desc_k64(hrow + dy * HROW + 64 * dx, s),
                S::desc_k64(slab, s), tap | s);
        } else {
#pragma unroll
          for (int s = 0; s < 4; ++s)
            S::wgmma_ss_n64(acc, desc_shift(hrow + dy * HROW, dx, s),
                            S::desc_b(slab, s), ch | tap | s);
        }
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

    // Epilogue: (int8 operands: float(acc) x ks, rounded, then) + bias,
    // ReLU, one rounding into the staging tile (64 pixels x 64 outputs,
    // swizzled), then one TMA store (f32: one a 32-output half), clipped at
    // the edges.
    if (wtid == 0) S::store_wait_read<0>();
    S::named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;
        float v0, v1;
        if constexpr (I8IN) {
          // The exact int32 sums, scaled and biased with two roundings, no
          // fused multiply-add (ops.conv.conv2d_int8_q). The scales come
          // through L1, as qs does below.
          const float2 k2 = __ldg(reinterpret_cast<const float2*>(
              scale + n0 + 8 * j + 2 * t));
          v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), k2.x),
                         bs[2 * j]);
          v1 = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), k2.y),
              bs[2 * j + 1]);
        } else {
          v0 = acc[4 * j + 2 * i] + bs[2 * j];
          v1 = acc[4 * j + 2 * i + 1] + bs[2 * j + 1];
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if constexpr (OUTK == OUT_I8) {
          // The scales come through L1 in the epilogue: a 9-warp block
          // leaves no registers to keep them.
          const float2 q2 = __ldg(reinterpret_cast<const float2*>(
              scale + n0 + 8 * j + 2 * t));
          const char2 q = make_char2(quant(v0, q2.x), quant(v1, q2.y));
          *reinterpret_cast<char2*>(stg + sw64(r, j) + 2 * t) = q;
        } else if constexpr (OUTK == OUT_F32) {
          // Outputs 8 j + 2 t + e: half j / 4, 16-byte chunk 2 (j % 4) +
          // t / 2 of its 128-byte row.
          *reinterpret_cast<float2*>(stg + (j >> 2) * OUT +
                                     sw128(r, 2 * (j & 3) + (t >> 1)) +
                                     8 * (t & 1)) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(stg + sw128(r, j) + 4 * t) =
              pack(v0, v1);
        }
      }
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
    if (wtid == 0) {
      if (y0 + wg < H) S::tma_store_4d(&omap, stg, n0, x0, y0 + wg, b);
      if (OUTK == OUT_F32 && y0 + wg < H)
        S::tma_store_4d(&omap, stg + OUT, n0 + 32, x0, y0 + wg, b);
      S::store_commit();
    }
  }
  if (wtid == 0) S::store_wait_all();
}

template <bool RES, int OUTK, bool I8IN = false>
int launch(const CUtensorMap& x, const CUtensorMap& w, const CUtensorMap& o,
           const void* bias, const void* scale, int B, int H, int W, int C16,
           int O64, int relu, int device, void* stream) {
  using L = ConvSmem<RES, OUTK, I8IN>;
  static_assert(L::BYTES <= MAX_SMEM, "conv3x3 shared memory");
  auto kern = conv3x3_kernel<RES, OUTK, I8IN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return int(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + WG - 1) / WG;
  const int n_tiles = B * tiles_y * tiles_x;
  const int o_tiles = O64 / NT;
  int per = S::sm_count(device) / o_tiles;
  if (per < 1) per = 1;
  const dim3 grid(n_tiles < per ? n_tiles : per, o_tiles);
  kern<<<grid, THREADS, L::BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, w, o, static_cast<const float*>(bias),
      static_cast<const float*>(scale), H, C16, relu, tiles_x, tiles_y,
      n_tiles);
  return int(cudaGetLastError());
}

// The descriptor-shift probe: one warpgroup computes D (64 x 64, f32) =
// A[shift : shift + 64] . B with A (72 x 64) and B (64 x 64) bf16 loaded by
// TMA with the 128B swizzle, A through desc_shift. D row-major.
__global__ void __launch_bounds__(128)
desc_probe_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  float* __restrict__ d, int shift) {
  constexpr int HROW = Operand<false>::HROW, SLAB = Operand<false>::SLAB;
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

// The int8 form: A (72 x 64) and B (64 x 64) int8 loaded by TMA with the 64B
// swizzle, D (64 x 64, int32) = A[shift : shift + 64] . B^T, A through a
// descriptor started `shift` rows of 64 bytes in (an odd shift moves the
// start inside a 128-byte address line). D row-major.
__global__ void __launch_bounds__(128)
desc_probe_i8_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     int* __restrict__ d, int shift) {
  constexpr int AB = HX * 64, BB = 64 * 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a = align1024(smem_raw);
  unsigned char* bt = a + AB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bt + BB);
  const int tid = threadIdx.x;
  if (tid == 0) {
    S::mbar_init(bar, 1);
    S::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    S::mbar_expect_tx(bar, AB + BB);
    S::tma_load_2d(a, &amap, bar, 0, 0);
    S::tma_load_2d(bt, &bmap, bar, 0, 0);
  }
  S::mbar_wait(bar, 0);
  int acc[32];
  S::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s)
    S::wgmma_i8_ss_n64(acc, S::desc_k64(a + 64 * shift, s),
                       S::desc_k64(bt, s), s);
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
// (zeros for none); qs null: out (B,H,W,O8) bf16, O8 = O rounded up to 8;
// qs (O64) f32: out (B,H,W,O8) int8, quantized with qs, for C <= 64 and O8 a
// multiple of 16. Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_conv3x3_any(const void* x, const void* wt, const void* bias,
                               const void* qs, void* out, int B, int H, int W,
                               int C8, int C16, int O8, int O64, int relu,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (C8 % 8 || C16 % 16 || O8 % 8 || O64 % 64 || C16 < C8 || O64 < O8 ||
      C16 > C8 + 8 || (qs != nullptr && (C16 > KC || O8 % 16)))
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0 || O8 == 0) return 0;
  CUtensorMap xm, wm, om;
  int e = S::map_nhwc(&xm, x, B, H, W, C8, HX, WG + 2);
  if (e == 0) e = S::map_matrix(&wm, wt, 9 * C16, O64, KC);
  if (e == 0)
    e = qs != nullptr ? S::map_nhwc_i8(&om, out, B, H, W, O8, TW)
                      : S::map_nhwc(&om, out, B, H, W, O8, TW, 1);
  if (e != 0) return e;
  if (qs != nullptr)
    return launch<true, OUT_I8>(xm, wm, om, bias, qs, B, H, W, C16, O64,
                                relu, device, stream);
  return C16 <= KC ? launch<true, OUT_BF16>(xm, wm, om, bias, qs, B, H, W,
                                            C16, O64, relu, device, stream)
                   : launch<false, OUT_BF16>(xm, wm, om, bias, qs, B, H, W,
                                             C16, O64, relu, device, stream);
}

// The int8 3x3 conv, 64 -> 64: x (B,H,W,64) int8; w (9 x 64, 64) int8 = the
// folded kernel as K-major slabs, rows (dy, dx, o) of the 64 input channels
// (kernels/stream.py conv3x3_int8_slabs); ks, bias (64) f32; out (B,H,W,64)
// bf16 or, out_f32, f32. out = act(float(acc) x ks + bias), acc the exact
// int32 sum. Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_conv3x3_int8(const void* x, const void* w, const void* ks,
                                const void* bias, void* out, int B, int H,
                                int W, int relu, int out_f32, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (B == 0 || H == 0 || W == 0) return 0;
  CUtensorMap xm, wm, om;
  int e = S::map_nhwc_i8(&xm, x, B, H, W, KC, HX, WG + 2);
  if (e == 0) e = S::map_matrix_i8(&wm, w, 9 * NT, KC, NT);
  if (e == 0)
    e = out_f32 ? S::map_nhwc_f32(&om, out, B, H, W, NT, TW)
                : S::map_nhwc(&om, out, B, H, W, NT, TW, 1);
  if (e != 0) return e;
  return out_f32 ? launch<true, OUT_F32, true>(xm, wm, om, bias, ks, B, H, W,
                                               KC, NT, relu, device, stream)
                 : launch<true, OUT_BF16, true>(xm, wm, om, bias, ks, B, H,
                                                W, KC, NT, relu, device,
                                                stream);
}

// a (72, 64), b (64, 64) bf16; d (64, 64) f32. Returns a cudaError_t.
extern "C" int tux_conv3x3_desc_probe(const void* a, const void* b, void* d,
                                      int shift, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (shift < 0 || shift > HX - TW) return int(cudaErrorInvalidValue);
  CUtensorMap am, bm;
  int e = S::map_matrix(&am, a, HX, 64, HX);
  if (e == 0) e = S::map_matrix(&bm, b, 64, 64, 64);
  if (e != 0) return e;
  const int smem = 1024 + Operand<false>::HROW + Operand<false>::SLAB + 8;
  desc_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<float*>(d), shift);
  return int(cudaGetLastError());
}

// a (72, 64), b (64, 64) int8 (b as N rows of K); d (64, 64) int32. Returns
// a cudaError_t.
extern "C" int tux_conv3x3_i8_desc_probe(const void* a, const void* b,
                                         void* d, int shift, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (shift < 0 || shift > HX - TW) return int(cudaErrorInvalidValue);
  CUtensorMap am, bm;
  int e = S::map_matrix_i8(&am, a, HX, 64, HX);
  if (e == 0) e = S::map_matrix_i8(&bm, b, 64, 64, 64);
  if (e != 0) return e;
  const int smem = 1024 + HX * 64 + 64 * 64 + 8;
  desc_probe_i8_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<int*>(d), shift);
  return int(cudaGetLastError());
}
