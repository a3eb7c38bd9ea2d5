// conv1 of FastTransformer for Hopper (sm_90a): 3x3 zero-padded conv,
// 3 -> 64 channels, NHWC bf16, with JAX's epilogue order.
//
// Replaces two TPU kernels of transformerupscaler_tpu/ops/pallas/stream.py,
// which compute one function:
//   conv1_dots_stream (:1269, kernel call conv1_stream_call :1308)
//   conv1_flat_stream (:1385)
// The first expanded the 27 taps into a K=108 operand in XLA and ran one dot
// per row slab; the second assembled that operand inside the kernel, which
// Mosaic refused on the TPU (:1398-1401). Here the operand is assembled in
// shared memory, which is what the second one asked for. What it computes:
//   acc = sum over (dy, dx, c) of x[y+dy-1][x+dx-1][c] * w[dy][dx][c][n]
//         f32 accumulation, zero-padded x
//   out = bf16(acc), then + bf16(bias) in bf16 arithmetic (an f32 add rounded
//         once to bf16), then ReLU
// That is the TPU kernel's order (stream.py:1259-1263): the sum is rounded
// FIRST, unlike the port's other stream kernels with an f32 epilogue.
//
// Design: one block owns an 8 x 32 pixel tile (256 pixels). It copies the
// zero-padded 10 x 34 x 3 input halo (2 KB) to shared memory, builds the
// 256 x 32 im2col operand from it (K = 27 taps zero-padded to 32, two
// mma.sync k16 steps), reads the (64, 32) weights, and each of the 8 warps
// runs its tile row (two 16-pixel M fragments) against all 64 output
// channels: 32 mma.sync m16n8k16 per warp. The epilogue stages the
// 256 x 64 bf16 tile in shared memory (over the operand, which is dead by
// then) so that NHWC rows leave as 16-byte stores; pixels outside the image
// are masked, so any H and W are covered (no rows left unwritten, unlike the
// TPU kernel's rows fallback at stream.py:1321-1322).
//
// Bound on the H100 at 720x1280: 5.5 MB in and 118 MB out, 0.037 ms at
// 3.35 TB/s; 3.2 GFLOP (K = 27) is far below that at 989 TF/s, so the kernel
// is bytes-bound. This first version has no copy/compute overlap beyond what
// several resident blocks give; see PERF.md.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int COUT = 64;
constexpr int TH = 8;          // tile rows == warps per block
constexpr int TW = 32;         // tile columns == two M fragments per warp
constexpr int THREADS = 256;
constexpr int NPIX = TH * TW;  // 256
constexpr int K = 27;          // taps x input channels
constexpr int KP = 32;         // K padded to two k16 steps
constexpr int AS = KP + 8;     // row stride (elements) of the operand
constexpr int OS = COUT + 8;   // row stride (elements) of the staged output
constexpr int HH = TH + 2;     // input halo
constexpr int HW = TW + 2;

constexpr size_t kOperandBytes = size_t(NPIX) * AS * 2;
constexpr size_t kWeightBytes = size_t(COUT) * AS * 2;
constexpr size_t kHaloBytes = size_t(HH) * HW * 3 * 2;
constexpr size_t kStageBytes = size_t(NPIX) * OS * 2;
constexpr size_t kSmemBytes =
    kStageBytes > kOperandBytes + kWeightBytes + kHaloBytes
        ? kStageBytes
        : kOperandBytes + kWeightBytes + kHaloBytes;

// x (B,H,W,3) bf16; w (64, 32) bf16, [cout][(dy*3+dx)*3+c], zero for
// k >= 27; bias (64) f32 holding bf16 values; out (B,H,W,64) bf16.
__global__ void __launch_bounds__(THREADS)
conv1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ bias, bf16* __restrict__ out, int H,
             int W, int relu) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  bf16* a_sm = reinterpret_cast<bf16*>(smem);
  bf16* w_sm = a_sm + NPIX * AS;
  bf16* halo = w_sm + COUT * AS;
  bf16* stage = reinterpret_cast<bf16*>(smem);  // after the products

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const bf16 zero = __float2bfloat16_rn(0.f);
  const bf16* xb = x + size_t(b) * H * W * 3;
  for (int i = tid; i < HH * HW * 3; i += THREADS) {
    const int p = i / 3;
    const int iy = y0 + p / HW - 1;
    const int ix = x0 + p % HW - 1;
    halo[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                  ? xb[(size_t(iy) * W + ix) * 3 + i % 3]
                  : zero;
  }
  for (int i = tid; i < COUT * (KP / 8); i += THREADS) {
    const int r = i / (KP / 8);
    const int chunk = i % (KP / 8);
    *reinterpret_cast<uint4*>(w_sm + r * AS + chunk * 8) =
        *reinterpret_cast<const uint4*>(w + r * KP + chunk * 8);
  }
  __syncthreads();
  // The im2col operand: row p (pixel p / TW, p % TW of the tile), column
  // k = (dy*3 + dx)*3 + c.
  for (int i = tid; i < NPIX * KP; i += THREADS) {
    const int p = i / KP;
    const int k = i % KP;
    bf16 v = zero;
    if (k < K) {
      const int tap = k / 3;
      v = halo[((p / TW + tap / 3) * HW + p % TW + tap % 3) * 3 + k % 3];
    }
    a_sm[p * AS + k] = v;
  }
  __syncthreads();

  float acc[2][COUT / 8][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const bf16* row = a_sm + (warp * TW + f * 16 + g) * AS + kk * 16;
      tux::load_a(a[f], row, row + 8 * AS, t);
    }
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j) {
      uint32_t bw[2];
      tux::load_b(bw, w_sm + (j * 8 + g) * AS + kk * 16, t);
#pragma unroll
      for (int f = 0; f < 2; ++f)
        tux::mma_bf16(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3], bw[0],
                      bw[1]);
    }
  }

  __syncthreads();  // the operand is dead: stage the output over it
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = warp * TW + f * 16 + g + 8 * hh;
        const int n = j * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // Round the sum, add the bf16 bias in f32, round again.
          const float r = __bfloat162float(
              __float2bfloat16_rn(acc[f][j][2 * hh + e]));
          v[e] = __bfloat162float(__float2bfloat16_rn(r + bias[n + e]));
          if (relu) v[e] = fmaxf(v[e], 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(stage + p * OS + n) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
  __syncthreads();
  bf16* ob = out + size_t(b) * H * W * COUT;
  for (int i = tid; i < NPIX * (COUT / 8); i += THREADS) {
    const int p = i / (COUT / 8);
    const int chunk = i % (COUT / 8);
    const int y = y0 + p / TW;
    const int xx = x0 + p % TW;
    if (y < H && xx < W)
      *reinterpret_cast<uint4*>(ob + (size_t(y) * W + xx) * COUT +
                                chunk * 8) =
          *reinterpret_cast<const uint4*>(stage + p * OS + chunk * 8);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_conv1(const void* x, const void* w, const void* bias,
                         void* out, int B, int H, int W, int relu, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, relu);
  return int(cudaGetLastError());
}
