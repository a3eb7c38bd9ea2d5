// General NHWC 3x3 conv (stride 1, zero padding 1) with an optional bias and
// ReLU, any input and output width, for Hopper (sm_90a).
//
// Replaces transformerupscaler_tpu/ops/pallas/conv3x3.py:73 conv3x3_pallas,
// the JAX package's archived conv kernel, which its tests pin at (C, O) =
// (64, 64), (64, 256), (256, 16), (8, 8), (16, 8), batch 3 and odd heights.
// The serving kernel conv_nhwc.cu is compiled for 64 -> 64 with the whole
// halo and all weights in shared memory; at C = 256 those alone would take
// ~180 KB, so this one streams the input channels instead.
//
//   out[b, y, x, o] = bf16(act(sum_{dy,dx,c} x[b, y+dy-1, x+dx-1, c]
//                                 * w[dy, dx, c, o] + bias[o]))
// bf16 operands, f32 accumulation; the bias arrives as bf16 values (the TPU
// kernel rounds it to x's dtype first, conv3x3.py:103-104) and is added in
// f32, then the ReLU, then one rounding to bf16 (conv3x3.py:64-69).
//
// Design: one block of 8 warps computes an 8 x 16 pixel tile for 64 output
// channels (grid.y walks the output chunks; the weights are zero-padded to a
// multiple of 8 outputs, and 8-column fragments past it are skipped). The
// input channels are zero-padded to a multiple of 16 and consumed in chunks
// of at most 64: each chunk loads the 10 x 18 pixel halo and the chunk's
// nine tap slabs [64 outputs][chunk] into shared memory, then every tap is a
// (128 pixels x chunk) . (chunk x 64) product on mma.sync m16n8k16. The 16
// pixels of an A fragment are one row of the tile, so a tap's A rows are
// halo rows read at an offset: no im2col copy. The warps tile the output as
// 4 (pixels, 32 each) x 2 (outputs, 32 each).
//
// Bound on the H100 at 720x1280, 64 -> 64 (989 TF/s bf16, 3.35 TB/s): 7.2
// GFLOP, 7.3 us; 236 MB moved, 70 us: bytes-bound, as conv_nhwc.cu. Every
// block reloads its chunk's weights (73.7 KB at 64 -> 64) from L2 and there
// is no copy/compute overlap: a first version; see PERF.md for its time.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;        // tile rows
constexpr int TW = 16;       // tile columns: one A fragment
constexpr int NT = 64;       // output channels per block
constexpr int KC = 64;       // input channels per chunk, at most
constexpr int S = KC + 8;    // shared-memory row stride (elements)
constexpr int HW_ = TW + 2;  // halo width
constexpr int HALO = (TH + 2) * HW_;
constexpr int THREADS = 256;
constexpr size_t SMEM = size_t(HALO + 9 * NT) * S * sizeof(bf16);

// x (B,H,W,C) bf16; wt (9, O8, C16) bf16 = w[dy][dx][c][o] as [tap][o][c],
// zero-padded; bias (O8) f32; out (B,H,W,O) bf16.
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
               const float* __restrict__ bias, bf16* __restrict__ out, int H,
               int W, int C, int C16, int O, int O8, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // halo [pixel][channel]
  bf16* ws = xs + HALO * S;                  // [tap][output][channel]
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tx = blockIdx.x % tiles_w;
  const int ty = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int y0 = ty * TH, x0 = tx * TW;
  const int n0 = blockIdx.y * NT;
  const int nn = min(NT, O8 - n0);  // weight rows of this output chunk
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 1;  // 0..3: tile rows 2 wm, 2 wm + 1
  const int wn = warp & 1;   // 0..1: 32 output channels

  float acc[2][4][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  for (int c0 = 0; c0 < C16; c0 += KC) {
    const int kc = min(KC, C16 - c0);
    const int kv = kc / 8;  // 16-byte vectors a row
    __syncthreads();        // the previous chunk's products are done
    for (int i = tid; i < HALO * kv; i += THREADS) {
      const int v = i % kv;
      const int p = i / kv;
      const int yy = y0 - 1 + p / HW_;
      const int xx = x0 - 1 + p % HW_;
      const int c = c0 + 8 * v;
      uint4 val = tux::zero16();
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < C) {
        const bf16* src = x + ((size_t(b) * H + yy) * W + xx) * C + c;
        if ((C & 7) == 0) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) bf16 e[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            e[k] = c + k < C ? src[k] : __float2bfloat16_rn(0.f);
          val = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(xs + p * S + 8 * v) = val;
    }
    for (int i = tid; i < 9 * nn * kv; i += THREADS) {
      const int v = i % kv;
      const int r = i / kv;  // tap * nn + output
      const int tap = r / nn;
      const int n = r % nn;
      *reinterpret_cast<uint4*>(ws + (tap * NT + n) * S + 8 * v) =
          *reinterpret_cast<const uint4*>(
              wt + (size_t(tap) * O8 + n0 + n) * C16 + c0 + 8 * v);
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      for (int kk = 0; kk < kc / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const bf16* r0 =
              xs + ((2 * wm + f + dy) * HW_ + g + dx) * S + kk * 16;
          tux::load_a(a[f], r0, r0 + 8 * S, t);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nl = wn * 32 + j * 8;  // warp-uniform
          if (n0 + nl >= O8) continue;
          uint32_t bfr[2];
          tux::load_b(bfr, ws + (tap * NT + nl + g) * S + kk * 16, t);
#pragma unroll
          for (int f = 0; f < 2; ++f)
            tux::mma_bf16(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3],
                          bfr[0], bfr[1]);
        }
      }
    }
  }

  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int yy = y0 + 2 * wm + f;
      const int xx = x0 + g + 8 * h;
      if (yy >= H || xx >= W) continue;
      bf16* dst = out + ((size_t(b) * H + yy) * W + xx) * O;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= O) continue;
        float v0 = acc[f][j][2 * h] + bias[n];
        float v1 = acc[f][j][2 * h + 1] + bias[n + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          dst[n] = __float2bfloat16_rn(v0);
          if (n + 1 < O) dst[n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

}  // namespace

// x (B,H,W,C), out (B,H,W,O) bf16; wt (9, O8, C16) bf16 with O8 and C16 the
// output and input widths rounded up to multiples of 8 and 16, zero-padded;
// bias (O8) f32 (zeros for none). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int tux_conv3x3_any(const void* x, const void* wt, const void* bias,
                               void* out, int B, int H, int W, int C, int C16,
                               int O, int O8, int relu, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (C16 % 16 || O8 % 8 || C16 < C || O8 < O)
    return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(conv3x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM));
  if (err != cudaSuccess) return int(err);
  const int tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0 || O == 0) return 0;
  const dim3 grid(tiles, (O8 + NT - 1) / NT);
  conv3x3_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, C, C16,
      O, O8, relu);
  return int(cudaGetLastError());
}
