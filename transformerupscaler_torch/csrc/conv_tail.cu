// A 3x3 64 -> 64 conv fused with a k x k tail conv 64 -> co, for Hopper
// (sm_90a); the conv's output never goes to device memory, unless asked for.
//
// Replaces two TPU kernels of transformerupscaler_tpu/ops/pallas/stream.py:
//   conv3x3_tail_stream      (:584, body :516)  ->  tux_conv_tail, feat null
//   conv3x3_tail_emit_stream (:662, body :504)  ->  tux_conv_tail, feat given
// and, through the adapters of kernels/encoder.py, the two of
// ops/pallas/encoder.py (fused_encoder :239, fused_decoder :279), which
// compute the same functions on the width-2 packed layout. What it computes,
// NHWC bf16 in:
//   f   = relu(conv3x3(x, wc) + bc)    zero-padded x, f32 accumulation, f32
//                                      bias (the TPU kernels' conv_relu=False
//                                      is passed by no caller: not carried)
//   f   = 0 outside the image          the tail sees the feature map's own
//                                      zero pad, not relu(bias)
//                                      (stream.py:516-521, 561-567)
//   f rounded once to bf16             what the unfused pair stores
//   out = conv_kxk(f, wt) + bt         k = 3, 5, 7; f32 accumulation, f32
//                                      bias, optional ReLU (tail_relu), one
//                                      rounding to bf16 or f32
//   feat = f inside the image          when feat is not null (the encoder:
//                                      conv2's output feeds the embed and
//                                      the unembed)
// The TPU kernels' deinterleave4 layout, macro-8 outputs and row slabs are
// not carried over.
//
// Design: one block owns a 16 x 16 output tile. With P = (k - 1) / 2 it
//   1. copies the zero-padded (16 + 2P + 2)^2 x 64 input halo to shared
//      memory;
//   2. computes the (16 + 2P)^2 conv pixels of the tile and its P-ring as an
//      implicit GEMM over those pixels in linear order (M fragments
//      warp + 8 i, all 64 channels, the weights streamed one kernel row at a
//      time, mma.sync m16n8k16);
//   3. writes them, biased, masked and rounded, over the halo (dead by
//      then), and stores the tile's 16 x 16 interior to feat if asked;
//   4. runs the k x k tail on them, each warp two output rows, the tail
//      weights streamed one kernel row at a time; the epilogue stages the
//      tile in f32 so NHWC rows leave coalesced, masked at the image edge,
//      so any H and W are covered (no rows left unwritten, unlike the TPU
//      kernels' rows fallback at stream.py:609-610, 679-680).
// Tile and recompute (the ring is computed by both neighbours):
//   k = 7: halo 24 x 24 (82,944 B), conv 22 x 22 pixels, 1.89x the conv
//          work of the unfused pair;
//   k = 5: halo 22 x 22, conv 20 x 20, 1.56x;
//   k = 3: halo 20 x 20, conv 18 x 18, 1.27x.
// Shared memory: the halo plus one 3 x 64 x 64 row of conv weights (110,592
// B at k = 7) in the first phase; in the second the conv tile in the halo's
// place, one k x npad x 64 row of tail weights and the f32 staging tile. One
// 256-thread block per SM: the conv phase keeps 4 x 8 accumulator fragments
// (128 registers) a thread, 174-200 registers in all (ptxas, no spills).
// co is padded with zero weights to npad = 16, 32 or 48 (x2, x3, x4).
//
// Bound on the H100 at 720x1280, x2 (co = 12):
//   decoder, 7x7, no emit: 67.9 + 69.4 GFLOP = 0.139 ms at 989 TF/s; 118 MB
//     in and 22 MB out, 0.042 ms at 3.35 TB/s;
//   encoder, 5x5, emitting: 67.9 + 35.4 GFLOP = 0.105 ms; 258 MB, 0.077 ms.
// This first version has no copy/compute overlap and one block per SM; it
// also does the recompute above and pads co to 16. See PERF.md.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CIN = 64;
constexpr int CS = CIN + 8;  // row stride (elements) of a pixel in shared
constexpr int T = 16;        // output tile side
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;

template <int KT, int NPAD>
struct Geo {
  static constexpr int P = (KT - 1) / 2;
  static constexpr int MI = T + 2 * P;  // conv tile side
  static constexpr int HI = MI + 2;     // input halo side
  static constexpr int MPIX = MI * MI;
  static constexpr int MFRAGS = (MPIX + 15) / 16;
  static constexpr int FPW = (MFRAGS + NWARP - 1) / NWARP;
  static constexpr size_t halo = size_t(HI) * HI * CS * 2;
  static constexpr size_t mid = size_t(MPIX) * CS * 2;
  static constexpr size_t crow = size_t(3) * CIN * CS * 2;
  static constexpr size_t trow = size_t(KT) * NPAD * CS * 2;
  static constexpr size_t stage = size_t(T) * T * NPAD * 4;
  static constexpr size_t region0 = halo > mid ? halo : mid;
  static constexpr size_t region1 =
      crow > trow ? (crow > stage ? crow : stage)
                  : (trow > stage ? trow : stage);
  static constexpr size_t bytes = region0 + region1;
};

// x (B,H,W,64) bf16; wc (3,3,64,64) bf16 [dy][dx][cout][cin]; bc (64) f32;
// wt (KT,KT,NPAD,64) bf16 [dy][dx][cout][cin]; bt (co) f32; out (B,H,W,co)
// bf16 or f32 (out_f32); feat (B,H,W,64) bf16 or null.
template <int KT, int NPAD>
__global__ void __launch_bounds__(THREADS, 1)
conv_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wc,
                 const float* __restrict__ bc, const bf16* __restrict__ wt,
                 const float* __restrict__ bt, void* __restrict__ out,
                 bf16* __restrict__ feat, int H, int W, int co, int tail_relu,
                 int out_f32) {
  using G = Geo<KT, NPAD>;
  constexpr int P = G::P, MI = G::MI, HI = G::HI, MPIX = G::MPIX;
  constexpr int MFRAGS = G::MFRAGS, FPW = G::FPW;
  constexpr int NFO = NPAD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* mid = reinterpret_cast<bf16*>(smem);  // after the conv
  bf16* wsm = reinterpret_cast<bf16*>(smem + G::region0);
  float* stage = reinterpret_cast<float*>(smem + G::region0);  // at the end

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * T;
  const int x0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // 1. Input halo: conv pixel (0, 0) is image (y0 - P, x0 - P), and its taps
  // reach one more.
  const bf16* xb = x + size_t(b) * H * W * CIN;
  for (int i = tid; i < HI * HI * 8; i += THREADS) {
    const int chunk = i & 7;
    const int p = i >> 3;
    const int iy = y0 + p / HI - P - 1;
    const int ix = x0 + p % HI - P - 1;
    uint4 v = tux::zero16();
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = *reinterpret_cast<const uint4*>(xb + (size_t(iy) * W + ix) * CIN +
                                          chunk * 8);
    *reinterpret_cast<uint4*>(halo + p * CS + chunk * 8) = v;
  }

  // 2. The conv over MPIX pixels, fragment warp + NWARP i. Rows past the
  // last pixel are clamped to it and never stored; a fragment wholly past
  // it is skipped (uniform per warp).
  int poff[FPW][2];
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = min((warp + NWARP * i) * 16 + g + 8 * hh, MPIX - 1);
      poff[i][hh] = ((p / MI) * HI + p % MI) * CS;
    }
  float acc[FPW][CIN / 8][4];
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int j = 0; j < CIN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    __syncthreads();  // the previous kernel row is no longer being read
    const bf16* wrow = wc + size_t(dy) * 3 * CIN * CIN;
    for (int i = tid; i < 3 * CIN * 8; i += THREADS) {
      const int chunk = i & 7;
      const int r = i >> 3;  // dx * 64 + cout
      *reinterpret_cast<uint4*>(wsm + r * CS + chunk * 8) =
          *reinterpret_cast<const uint4*>(wrow + size_t(r) * CIN + chunk * 8);
    }
    __syncthreads();
    for (int dx = 0; dx < 3; ++dx) {
      const bf16* tap = halo + (dy * HI + dx) * CS;
      const bf16* wtap = wsm + dx * CIN * CS;
#pragma unroll
      for (int kk = 0; kk < CIN / 16; ++kk) {
        uint32_t a[FPW][4];
#pragma unroll
        for (int i = 0; i < FPW; ++i)
          if (warp + NWARP * i < MFRAGS)
            tux::load_a(a[i], tap + poff[i][0] + kk * 16,
                        tap + poff[i][1] + kk * 16, t);
#pragma unroll
        for (int j = 0; j < CIN / 8; ++j) {
          uint32_t bw[2];
          tux::load_b(bw, wtap + (j * 8 + g) * CS + kk * 16, t);
#pragma unroll
          for (int i = 0; i < FPW; ++i)
            if (warp + NWARP * i < MFRAGS)
              tux::mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3],
                            bw[0], bw[1]);
        }
      }
    }
  }

  // 3. Bias, ReLU, zero outside the image, one rounding to bf16, into the
  // halo's place.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (warp + NWARP * i) * 16 + g + 8 * hh;
      if (p >= MPIX) continue;
      const int gy = y0 - P + p / MI;
      const int gx = x0 - P + p % MI;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < CIN / 8; ++j) {
        const int n = j * 8 + 2 * t;
        float v0 = fmaxf(acc[i][j][2 * hh] + bc[n], 0.f);
        float v1 = fmaxf(acc[i][j][2 * hh + 1] + bc[n + 1], 0.f);
        if (!inside) v0 = v1 = 0.f;
        *reinterpret_cast<__nv_bfloat162*>(mid + p * CS + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  __syncthreads();
  if (feat != nullptr) {
    bf16* fb = feat + size_t(b) * H * W * CIN;
    for (int i = tid; i < T * T * 8; i += THREADS) {
      const int chunk = i & 7;
      const int p = i >> 3;
      const int y = y0 + p / T;
      const int xx = x0 + p % T;
      if (y < H && xx < W)
        *reinterpret_cast<uint4*>(fb + (size_t(y) * W + xx) * CIN +
                                  chunk * 8) =
            *reinterpret_cast<const uint4*>(
                mid + ((p / T + P) * MI + p % T + P) * CS + chunk * 8);
    }
  }

  // 4. The tail: warp w computes output rows 2w and 2w + 1 (one M fragment
  // of 16 pixels each); output (r, c) reads conv pixel (r + dy, c + dx).
  float acc2[2][NFO][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NFO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[f][j][e] = 0.f;
  for (int dy = 0; dy < KT; ++dy) {
    __syncthreads();  // the previous kernel row is no longer being read
    const bf16* wrow = wt + size_t(dy) * KT * NPAD * CIN;
    for (int i = tid; i < KT * NPAD * 8; i += THREADS) {
      const int chunk = i & 7;
      const int r = i >> 3;  // dx * NPAD + cout
      *reinterpret_cast<uint4*>(wsm + r * CS + chunk * 8) =
          *reinterpret_cast<const uint4*>(wrow + size_t(r) * CIN + chunk * 8);
    }
    __syncthreads();
    for (int dx = 0; dx < KT; ++dx) {
      const bf16* wtap = wsm + dx * NPAD * CS;
#pragma unroll
      for (int kk = 0; kk < CIN / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const bf16* row =
              mid + ((2 * warp + f + dy) * MI + dx + g) * CS + kk * 16;
          tux::load_a(a[f], row, row + 8 * CS, t);
        }
#pragma unroll
        for (int j = 0; j < NFO; ++j) {
          uint32_t bw[2];
          tux::load_b(bw, wtap + (j * 8 + g) * CS + kk * 16, t);
#pragma unroll
          for (int f = 0; f < 2; ++f)
            tux::mma_bf16(acc2[f][j], a[f][0], a[f][1], a[f][2], a[f][3],
                          bw[0], bw[1]);
        }
      }
    }
  }

  __syncthreads();  // the tail weights are dead: stage the tile over them
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NFO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = j * 8 + 2 * t + (e & 1);
        const int p = (2 * warp + f) * T + g + 8 * (e >> 1);
        if (n < co) {
          float v = acc2[f][j][e] + bt[n];
          if (tail_relu) v = fmaxf(v, 0.f);
          stage[p * co + n] = v;
        }
      }
  __syncthreads();
  const int nv = min(T, W - x0);
  for (int r = 0; r < T; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    const size_t o = ((size_t(b) * H + y) * W + x0) * co;
    const float* src = stage + r * T * co;
    if (out_f32) {
      float* dst = static_cast<float*>(out) + o;
      for (int e = tid; e < nv * co; e += THREADS) dst[e] = src[e];
    } else {
      bf16* dst = static_cast<bf16*>(out) + o;
      for (int e = tid; e < nv * co; e += THREADS)
        dst[e] = __float2bfloat16_rn(src[e]);
    }
  }
}

template <int KT, int NPAD>
int launch(const void* x, const void* wc, const void* bc, const void* wt,
           const void* bt, void* out, void* feat, int B, int H, int W, int co,
           int tail_relu, int out_f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  constexpr size_t smem = Geo<KT, NPAD>::bytes;
  auto kern = conv_tail_kernel<KT, NPAD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wc),
      static_cast<const float*>(bc), static_cast<const bf16*>(wt),
      static_cast<const float*>(bt), out, static_cast<bf16*>(feat), H, W, co,
      tail_relu, out_f32);
  return int(cudaGetLastError());
}

template <int KT>
int dispatch(const void* x, const void* wc, const void* bc, const void* wt,
             const void* bt, void* out, void* feat, int B, int H, int W,
             int co, int npad, int tail_relu, int out_f32, int device,
             void* stream) {
  switch (npad) {
    case 16:
      return launch<KT, 16>(x, wc, bc, wt, bt, out, feat, B, H, W, co,
                            tail_relu, out_f32, device, stream);
    case 32:
      return launch<KT, 32>(x, wc, bc, wt, bt, out, feat, B, H, W, co,
                            tail_relu, out_f32, device, stream);
    case 48:
      return launch<KT, 48>(x, wc, bc, wt, bt, out, feat, B, H, W, co,
                            tail_relu, out_f32, device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// wt is (kt, kt, npad, 64) with kt in {3, 5, 7}, npad in {16, 32, 48} and
// co <= npad; feat null: no emit. Returns the cudaError_t of the launch.
extern "C" int tux_conv_tail(const void* x, const void* wc, const void* bc,
                             const void* wt, const void* bt, void* out,
                             void* feat, int B, int H, int W, int kt, int co,
                             int npad, int tail_relu, int out_f32,
                             int device, void* stream) {
  if (co > npad) return int(cudaErrorInvalidValue);
  switch (kt) {
    case 3:
      return dispatch<3>(x, wc, bc, wt, bt, out, feat, B, H, W, co, npad,
                         tail_relu, out_f32, device, stream);
    case 5:
      return dispatch<5>(x, wc, bc, wt, bt, out, feat, B, H, W, co, npad,
                         tail_relu, out_f32, device, stream);
    case 7:
      return dispatch<7>(x, wc, bc, wt, bt, out, feat, B, H, W, co, npad,
                         tail_relu, out_f32, device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
