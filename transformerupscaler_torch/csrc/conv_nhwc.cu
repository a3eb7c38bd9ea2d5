// NHWC bf16 same-padding k x k convolution (k = 5, 7), 64 -> co channels,
// for Hopper (sm_90a).
//
// Replaces transformerupscaler_tpu/ops/pallas/stream.py:777
// tail_macro8_stream (tux_tail_conv): out = act(conv(x, w) + bias) with zero
// padding, bf16 inputs, f32 accumulation and an f32 epilogue (bias, optional
// ReLU), rounded once to the output type (bf16 or f32). The TPU kernel needed
// the width-2 packing and the macro-8 output layout to fill 128 MXU lanes;
// here the tensors stay NHWC. (The serving 3x3 64 -> 64 conv is in
// csrc/conv3x3.cu.)
//
// Design: implicit GEMM with M = pixels, N = output channels (padded to
// npad = 16, 32 or 48 with zero weights), K = taps x 64. One block owns an
// 8 x 32 pixel tile: it copies the zero-padded (8+k-1) x (32+k-1) x 64 input
// halo to shared memory once, then streams the weights one kernel row (k
// taps) at a time. Each of the 8 warps owns one tile row (two 16-pixel M
// fragments) and all N, and runs mma.sync m16n8k16 bf16 with the A fragments
// read straight from the halo at the tap's offset. The epilogue stages the
// tile in shared memory so the NHWC rows leave as coalesced stores; pixels
// outside the image are masked, so any H and W are covered.
//
// Bound on the H100 at 720x1280 (989 TF/s bf16, 3.35 TB/s): the 5x5 tail (64
// -> 12) is bytes-bound near 42 us, the 7x7 tail flop-bound near 70 us. This
// first version uses mma.sync from shared memory with no copy/compute
// overlap, so it sits well above those bounds (see PERF.md).
#include "common.cuh"

namespace {

constexpr int CIN = 64;
constexpr int CS = CIN + 8;  // shared-memory row stride (elements) per pixel
constexpr int TH = 8;        // tile rows == warps per block
constexpr int TW = 32;       // tile columns == two M fragments per warp
constexpr int THREADS = 256;

template <int KS, int NPAD, typename OutT>
constexpr size_t conv_smem_bytes() {
  constexpr size_t halo = size_t(TH + KS - 1) * (TW + KS - 1) * CS * 2;
  constexpr size_t wrow = size_t(KS) * NPAD * CS * 2;
  constexpr size_t stage = size_t(TH) * TW * NPAD * sizeof(OutT);
  return halo + wrow > stage ? halo + wrow : stage;
}

// x (B,H,W,64) bf16; w (KS,KS,NPAD,64) bf16, [dy][dx][cout][cin];
// bias (co) f32; out (B,H,W,co) OutT.
template <int KS, int NPAD, typename OutT>
__global__ void __launch_bounds__(THREADS)
conv_nhwc_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, OutT* __restrict__ out,
                 int H, int W, int co, int relu) {
  constexpr int PAD = (KS - 1) / 2;
  constexpr int HW = TW + KS - 1;
  constexpr int HH = TH + KS - 1;
  constexpr int NF = NPAD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = halo + HH * HW * CS;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* xb = x + size_t(b) * H * W * CIN;
  for (int i = tid; i < HH * HW * 8; i += THREADS) {
    const int chunk = i & 7;
    const int p = i >> 3;
    const int iy = y0 + p / HW - PAD;
    const int ix = x0 + p % HW - PAD;
    uint4 v = tux::zero16();
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = *reinterpret_cast<const uint4*>(xb + (size_t(iy) * W + ix) * CIN +
                                          chunk * 8);
    *reinterpret_cast<uint4*>(halo + p * CS + chunk * 8) = v;
  }

  float acc[2][NF][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  for (int dy = 0; dy < KS; ++dy) {
    __syncthreads();  // the previous kernel row is no longer being read
    const __nv_bfloat16* wrow = w + size_t(dy) * KS * NPAD * CIN;
    for (int i = tid; i < KS * NPAD * 8; i += THREADS) {
      const int chunk = i & 7;
      const int r = i >> 3;  // dx * NPAD + n
      *reinterpret_cast<uint4*>(wsm + r * CS + chunk * 8) =
          *reinterpret_cast<const uint4*>(wrow + size_t(r) * CIN + chunk * 8);
    }
    __syncthreads();
    for (int dx = 0; dx < KS; ++dx) {
      // Pixel 0 of this warp's tile row, shifted by the tap (dy, dx).
      const __nv_bfloat16* arow = halo + ((warp + dy) * HW + dx) * CS;
      const __nv_bfloat16* wtap = wsm + dx * NPAD * CS;
#pragma unroll
      for (int kk = 0; kk < CIN / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
          tux::load_a(a[f], arow + (f * 16 + g) * CS + kk * 16,
                      arow + (f * 16 + g + 8) * CS + kk * 16, t);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          uint32_t bf[2];
          tux::load_b(bf, wtap + (j * 8 + g) * CS + kk * 16, t);
#pragma unroll
          for (int f = 0; f < 2; ++f)
            tux::mma_bf16(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3],
                          bf[0], bf[1]);
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
          float v = acc[f][j][e] + bias[n];
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
int launch_conv(const void* x, const void* w, const void* bias, void* out,
                int B, int H, int W, int co, int relu, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  constexpr size_t smem = conv_smem_bytes<KS, NPAD, OutT>();
  auto kern = conv_nhwc_kernel<KS, NPAD, OutT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<OutT*>(out), H, W, co, relu);
  return int(cudaGetLastError());
}

template <int KS, typename OutT>
int dispatch_tail(const void* x, const void* w, const void* bias, void* out,
                  int B, int H, int W, int co, int npad, int relu, int device,
                  void* stream) {
  switch (npad) {
    case 16:
      return launch_conv<KS, 16, OutT>(x, w, bias, out, B, H, W, co, relu,
                                       device, stream);
    case 32:
      return launch_conv<KS, 32, OutT>(x, w, bias, out, B, H, W, co, relu,
                                       device, stream);
    case 48:
      return launch_conv<KS, 48, OutT>(x, w, bias, out, B, H, W, co, relu,
                                       device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
// w is (ks, ks, npad, 64) with npad in {16, 32, 48} and co <= npad.
extern "C" int tux_tail_conv(const void* x, const void* w, const void* bias,
                             void* out, int B, int H, int W, int ks, int co,
                             int npad, int relu, int out_f32, int device,
                             void* stream) {
  if (ks == 5 && out_f32)
    return dispatch_tail<5, float>(x, w, bias, out, B, H, W, co, npad, relu,
                                   device, stream);
  if (ks == 5)
    return dispatch_tail<5, __nv_bfloat16>(x, w, bias, out, B, H, W, co, npad,
                                           relu, device, stream);
  if (ks == 7 && out_f32)
    return dispatch_tail<7, float>(x, w, bias, out, B, H, W, co, npad, relu,
                                   device, stream);
  if (ks == 7)
    return dispatch_tail<7, __nv_bfloat16>(x, w, bias, out, B, H, W, co, npad,
                                           relu, device, stream);
  return int(cudaErrorInvalidValue);
}
