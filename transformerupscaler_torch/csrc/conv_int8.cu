// NHWC int8 same-padding convolution, 64 input channels, for Hopper (sm_90a).
//
// Replaces two TPU kernels of transformerupscaler_tpu/ops/pallas/stream.py:
//   conv3x3_packed_int8_stream (:147)  ->  tux_conv3x3_int8    3x3, 64 -> 64
//   tail_macro8_stream_int8    (:893)  ->  tux_tail_conv_int8  k x k
//                                          (k = 5, 7), 64 -> co, co <= 48
// and serves the XLA conv2d_tail_packed_int8 (ops/conv.py:419) of the JAX
// int8 tails too: the three compute one function (stream.py:897-905,
// conv.py:424-430). Both take int8 activations quantized per input channel
// and int8 weights with that scale folded in, quantized per output channel
// with f32 scales ks. The products accumulate exactly in int32; the epilogue
// is float(acc) * ks[co] + bias[co] in f32, each step rounded on its own
// (no fused multiply-add, which the plain version cannot reproduce), optional
// ReLU, one rounding to bf16 or f32. The int32 sums are exact in any order,
// so kernel and plain version agree bit for bit.
//
// Design: an implicit GEMM with M = pixels, N = output channels
// (padded to a multiple of 8 with zero weights), K = taps x 64, in int8. One
// block owns an 8 x 32 pixel tile: it copies the zero-padded (8+k-1) x
// (32+k-1) x 64 int8 input halo to shared memory once, then streams the
// weights one kernel row (k taps) at a time. Each of the 8 warps owns one
// tile row (two 16-pixel M fragments) and all N, and runs mma.sync m16n8k32
// s8 (two k-steps per tap) with the A fragments read straight from the halo
// at the tap's offset. Shared-memory rows are 64 + 16 bytes, which keeps the
// int8 fragment reads free of bank conflicts. The epilogue stages the tile
// in shared memory so that the NHWC rows leave as coalesced stores; pixels
// outside the image are masked, so any H and W are covered.
//
// Bound on the H100 at 720x1280 (3.35 TB/s, 1,979 TOP/s int8): the 3x3 conv
// reads 59 MB of int8 and writes 118 MB of bf16 for 68 G operations, 0.053 ms
// bytes-bound; the 5x5 tail (64 -> 12) reads 59 MB and writes 22 MB, 0.024 ms
// bytes-bound; the 7x7 tail does 69 G operations, 0.035 ms operations-bound.
// This first version uses mma.sync from shared memory with no copy/compute
// overlap (see PERF.md for its times); wgmma s8 and TMA are later work.
#include "common.cuh"

namespace {

constexpr int CIN = 64;
constexpr int CSB = CIN + 16;  // shared-memory row stride (bytes) per pixel
constexpr int TH = 8;          // tile rows == warps per block
constexpr int TW = 32;         // tile columns == two M fragments per warp
constexpr int THREADS = 256;

template <int KS, int NPAD, typename OutT>
constexpr size_t conv_smem_bytes() {
  constexpr size_t halo = size_t(TH + KS - 1) * (TW + KS - 1) * CSB;
  constexpr size_t wrow = size_t(KS) * NPAD * CSB;
  constexpr size_t stage = size_t(TH) * TW * NPAD * sizeof(OutT);
  return halo + wrow > stage ? halo + wrow : stage;
}

// x (B,H,W,64) int8; w (KS,KS,NPAD,64) int8, [dy][dx][cout][cin];
// ks, bias (co) f32; out (B,H,W,co) OutT.
template <int KS, int NPAD, typename OutT>
__global__ void __launch_bounds__(THREADS)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ ks,
                 const float* __restrict__ bias, OutT* __restrict__ out,
                 int H, int W, int co, int relu) {
  constexpr int PAD = (KS - 1) / 2;
  constexpr int HW = TW + KS - 1;
  constexpr int HH = TH + KS - 1;
  constexpr int NF = NPAD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* halo = reinterpret_cast<int8_t*>(smem);
  int8_t* wsm = halo + HH * HW * CSB;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int8_t* xb = x + size_t(b) * H * W * CIN;
  for (int i = tid; i < HH * HW * 4; i += THREADS) {
    const int chunk = i & 3;
    const int p = i >> 2;
    const int iy = y0 + p / HW - PAD;
    const int ix = x0 + p % HW - PAD;
    uint4 v = tux::zero16();
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = *reinterpret_cast<const uint4*>(xb + (size_t(iy) * W + ix) * CIN +
                                          chunk * 16);
    *reinterpret_cast<uint4*>(halo + p * CSB + chunk * 16) = v;
  }

  int acc[2][NF][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;

  for (int dy = 0; dy < KS; ++dy) {
    __syncthreads();  // the previous kernel row is no longer being read
    const int8_t* wrow = w + size_t(dy) * KS * NPAD * CIN;
    for (int i = tid; i < KS * NPAD * 4; i += THREADS) {
      const int chunk = i & 3;
      const int r = i >> 2;  // dx * NPAD + n
      *reinterpret_cast<uint4*>(wsm + r * CSB + chunk * 16) =
          *reinterpret_cast<const uint4*>(wrow + size_t(r) * CIN + chunk * 16);
    }
    __syncthreads();
    for (int dx = 0; dx < KS; ++dx) {
      // Pixel 0 of this warp's tile row, shifted by the tap (dy, dx).
      const int8_t* arow = halo + ((warp + dy) * HW + dx) * CSB + 4 * t;
      const int8_t* wtap = wsm + dx * NPAD * CSB + 4 * t;
#pragma unroll
      for (int kk = 0; kk < CIN / 32; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int8_t* r0 = arow + (f * 16 + g) * CSB + kk * 32;
          const int8_t* r8 = r0 + 8 * CSB;
          a[f][0] = tux::ld32(r0);
          a[f][1] = tux::ld32(r8);
          a[f][2] = tux::ld32(r0 + 16);
          a[f][3] = tux::ld32(r8 + 16);
        }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int8_t* c0 = wtap + (j * 8 + g) * CSB + kk * 32;
          const uint32_t b0 = tux::ld32(c0);
          const uint32_t b1 = tux::ld32(c0 + 16);
#pragma unroll
          for (int f = 0; f < 2; ++f)
            tux::mma_s8(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3], b0, b1);
        }
      }
    }
  }

  __syncthreads();  // halo and weights are dead: reuse the space as staging
  OutT* stage = reinterpret_cast<OutT*>(smem);
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int p0 = warp * TW + f * 16 + g;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = j * 8 + 2 * t + (e & 1);
        const int p = p0 + (e >> 1) * 8;
        if (n < co) {
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[f][j][e]), ks[n]),
                              bias[n]);
          if (relu) v = fmaxf(v, 0.f);
          stage[p * co + n] = tux::from_f32<OutT>(v);
        }
      }
    }
  }
  __syncthreads();
  const int nv = min(TW, W - x0);
  for (int r = 0; r < TH; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    OutT* dst = out + ((size_t(b) * H + y) * W + x0) * co;
    const OutT* src = stage + r * TW * co;
    for (int e = tid; e < nv * co; e += THREADS) dst[e] = src[e];
  }
}

template <int KS, int NPAD, typename OutT>
int launch_conv(const void* x, const void* w, const void* ks,
                const void* bias, void* out, int B, int H, int W, int co,
                int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  constexpr size_t smem = conv_smem_bytes<KS, NPAD, OutT>();
  auto kern = conv_int8_kernel<KS, NPAD, OutT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(ks), static_cast<const float*>(bias),
      static_cast<OutT*>(out), H, W, co, relu);
  return int(cudaGetLastError());
}

template <int KS, typename OutT>
int dispatch_tail(const void* x, const void* w, const void* ks,
                  const void* bias, void* out, int B, int H, int W, int co,
                  int npad, int relu, int device, void* stream) {
  switch (npad) {
    case 16:
      return launch_conv<KS, 16, OutT>(x, w, ks, bias, out, B, H, W, co, relu,
                                       device, stream);
    case 32:
      return launch_conv<KS, 32, OutT>(x, w, ks, bias, out, B, H, W, co, relu,
                                       device, stream);
    case 48:
      return launch_conv<KS, 48, OutT>(x, w, ks, bias, out, B, H, W, co, relu,
                                       device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 on success).
// w is (3, 3, 64, 64) int8 [dy][dx][cout][cin]; ks and bias (64) f32.
extern "C" int tux_conv3x3_int8(const void* x, const void* w, const void* ks,
                                const void* bias, void* out, int B, int H,
                                int W, int relu, int out_f32, int device,
                                void* stream) {
  if (out_f32)
    return launch_conv<3, 64, float>(x, w, ks, bias, out, B, H, W, 64, relu,
                                     device, stream);
  return launch_conv<3, 64, __nv_bfloat16>(x, w, ks, bias, out, B, H, W, 64,
                                           relu, device, stream);
}

// w is (ksz, ksz, npad, 64) int8 with npad in {16, 32, 48} and co <= npad;
// ks and bias (co) f32.
extern "C" int tux_tail_conv_int8(const void* x, const void* w, const void* ks,
                                  const void* bias, void* out, int B, int H,
                                  int W, int ksz, int co, int npad, int relu,
                                  int out_f32, int device, void* stream) {
  if (ksz == 5 && out_f32)
    return dispatch_tail<5, float>(x, w, ks, bias, out, B, H, W, co, npad,
                                   relu, device, stream);
  if (ksz == 5)
    return dispatch_tail<5, __nv_bfloat16>(x, w, ks, bias, out, B, H, W, co,
                                           npad, relu, device, stream);
  if (ksz == 7 && out_f32)
    return dispatch_tail<7, float>(x, w, ks, bias, out, B, H, W, co, npad,
                                   relu, device, stream);
  if (ksz == 7)
    return dispatch_tail<7, __nv_bfloat16>(x, w, ks, bias, out, B, H, W, co,
                                           npad, relu, device, stream);
  return int(cudaErrorInvalidValue);
}
