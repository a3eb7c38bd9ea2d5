// 8x8 patch embed and unembed as bf16 GEMMs on NHWC tensors, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of transformerupscaler_tpu/ops/pallas/stream.py:
//   embed_stream           (:325) -> tux_embed
//       tokens[m, :] = patch(m) @ W + bias      M = tokens, K = 8*8*64, N = D
//   unembed_combine_stream (:239) -> tux_unembed_combine
//       out[patch(m)] = act(tokens[m, :] @ W + bias + skip[patch(m)])
//                                               M = tokens, K = D, N = 8*8*64
// bf16 operands, f32 accumulation, f32 bias (and skip add) in the epilogue,
// one rounding to bf16. The TPU kernels permuted the weights to read the
// deinterleave4 layout; here each patch is gathered straight from NHWC: for
// a fixed patch row, 8 pixels x 64 channels are 1 KB contiguous.
// The TPU kernels' int8 options of the int8 tails scope:
//   embed in_scale (stream.py:317-321): feat is int8, quantized per channel
//       with s; each value is dequantized to bf16(f32(q) * s[c]) as its A
//       tile is loaded, before the product: half the input bytes.
//   unembed feat_scale (stream.py:229-236): the skip is int8 and adds as
//       f32(q) * s[c] in the f32 epilogue, in the order (g + bias) + skip.
// With them the bounds become 64 MB moved, ~19 us (embed), and 182 MB,
// ~54 us (unembed), still bytes-bound.
// The archived functions of transformerupscaler_tpu/ops/pallas/
// patch_kernels.py run on the same two kernels: fused_patch_embed (:50) on
// the embed with its bias rounded to bf16 by the caller; fused_patch_unembed_
// add (:106) on the unembed with the epilogue option round_steps, which
// rounds where that kernel rounds (patch_kernels.py:99-103, 126): y =
// bf16(acc), then bf16(y + bias) with the bias a bf16 value, then bf16(. +
// skip): three roundings where the epilogue above has one.
//
// Design: 64-token x 64/128-column block tiles, 8 warps as 2 (M) x 4 (N), each
// warp a 32 x 16 (embed) or 32 x 32 (unembed) tile of mma.sync m16n8k16.
// Embed streams K in chunks of two pixels (128 channels); unembed holds its
// whole K = D in shared memory. Tokens past M are masked.
//
// Bound on the H100 at 720x1280, D = 192 (989 TF/s bf16, 3.35 TB/s): each
// does 22.6 GFLOP; embed moves 125 MB (~37 us), unembed + skip 242 MB
// (~72 us): both are bytes-bound. This first version has no copy/compute
// overlap (see PERF.md for its times); wgmma + TMA is later work.
#include "common.cuh"

namespace {

constexpr int C = 64;    // feature channels
constexpr int PS = 8;    // patch size
constexpr int MT = 64;   // tokens per block
constexpr int THREADS = 256;

// ---------------------------------------------------------------- embed
constexpr int E_NT = 64;        // output columns per block
constexpr int E_KC = 2 * C;     // K chunk: two pixels of one patch row
constexpr int E_S = E_KC + 8;   // shared-memory row stride

// Eight values of one pixel's channels c0..c0+7 as 16 bytes of bf16: copied
// (bf16 feat) or dequantized, bf16(f32(q) * s) (int8 feat, scales in s).
template <bool I8>
__device__ __forceinline__ uint4 load8(const void* feat, size_t off,
                                       const float* s, int c0) {
  if constexpr (I8) {
    const uint2 q = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(feat) + off);
    const int8_t* qb = reinterpret_cast<const int8_t*>(&q);
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          __fmul_rn(float(qb[2 * i]), s[c0 + 2 * i]),
          __fmul_rn(float(qb[2 * i + 1]), s[c0 + 2 * i + 1]));
      r[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    return make_uint4(r[0], r[1], r[2], r[3]);
  } else {
    return *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(feat) + off);
  }
}

// feat (B,H,W,64) bf16, or int8 with scales in_scale (64) f32 when I8;
// wt (D, 4096) bf16 = W transposed, k = (dy*8+dx)*64+c; bias (D) f32;
// tokens (B,Ht,Wt,D) bf16. H = 8 Ht, W = 8 Wt.
template <bool I8>
__global__ void __launch_bounds__(THREADS)
embed_kernel(const void* __restrict__ feat,
             const __nv_bfloat16* __restrict__ wt,
             const float* __restrict__ bias,
             const float* __restrict__ in_scale,
             __nv_bfloat16* __restrict__ tokens, int M, int Ht, int Wt,
             int D) {
  __shared__ __align__(16) __nv_bfloat16 as[MT * E_S];
  __shared__ __align__(16) __nv_bfloat16 bs[E_NT * E_S];
  __shared__ float ssc[I8 ? C : 1];
  constexpr int K = PS * PS * C;
  const int H = Ht * PS;
  const int W = Wt * PS;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * E_NT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;  // 0..1: 32-token half
  const int wn = warp & 3;   // 0..3: 16-column quarter
  if constexpr (I8) {
    if (tid < C) ssc[tid] = in_scale[tid];
  }

  float acc[2][2][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  for (int q = 0; q < K / E_KC; ++q) {
    const int dy = (2 * q) / PS;
    const int dx = (2 * q) % PS;
    __syncthreads();
    for (int i = tid; i < MT * (E_KC / 8); i += THREADS) {
      const int chunk = i % (E_KC / 8);
      const int r = i / (E_KC / 8);
      const int m = m0 + r;
      uint4 v = tux::zero16();
      if (m < M) {
        const int tx = m % Wt;
        const int bt = m / Wt;  // b * Ht + ty
        const int ty = bt % Ht;
        const int b = bt / Ht;
        const size_t pix = (size_t(b) * H + ty * PS + dy) * W + tx * PS + dx;
        v = load8<I8>(feat, pix * C + chunk * 8, ssc, (chunk * 8) % C);
      }
      *reinterpret_cast<uint4*>(as + r * E_S + chunk * 8) = v;
    }
    for (int i = tid; i < E_NT * (E_KC / 8); i += THREADS) {
      const int chunk = i % (E_KC / 8);
      const int r = i / (E_KC / 8);
      *reinterpret_cast<uint4*>(bs + r * E_S + chunk * 8) =
          *reinterpret_cast<const uint4*>(wt + size_t(n0 + r) * K + q * E_KC +
                                          chunk * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < E_KC / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const __nv_bfloat16* r0 = as + (wm * 32 + f * 16 + g) * E_S + kk * 16;
        tux::load_a(a[f], r0, r0 + 8 * E_S, t);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[2];
        tux::load_b(bf, bs + (wn * 16 + j * 8 + g) * E_S + kk * 16, t);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          tux::mma_bf16(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3], bf[0],
                        bf[1]);
      }
    }
  }

#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + f * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + wn * 16 + j * 8 + 2 * t;
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(acc[f][j][2 * h] + bias[n]);
        v.y = __float2bfloat16_rn(acc[f][j][2 * h + 1] + bias[n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(tokens + size_t(m) * D + n) = v;
      }
    }
}

// -------------------------------------------------------------- unembed
constexpr int U_NT = 128;  // output columns per block: two pixels x 64

// tokens (M, D) bf16; wt (4096, D) bf16 = W transposed, n = (dy*8+dx)*64+c;
// bias (64) f32; skip (B,H,W,64) bf16, or int8 with scales feat_scale (64)
// f32 when I8; out (B,H,W,64) bf16. Dynamic shared memory holds the token
// tile and the weight tile, both with row stride D + 8. R3: the epilogue
// rounds three times (round_steps above), with no ReLU.
template <bool I8, bool R3>
__global__ void __launch_bounds__(THREADS)
unembed_kernel(const __nv_bfloat16* __restrict__ tokens,
               const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ bias, const void* __restrict__ skip,
               const float* __restrict__ feat_scale,
               __nv_bfloat16* __restrict__ out, int M, int Ht, int Wt, int D,
               int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = D + 8;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + MT * S;
  const int H = Ht * PS;
  const int W = Wt * PS;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * U_NT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;  // 0..1: 32-token half
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const int kc = D / 8;      // 16-byte chunks per row

  for (int i = tid; i < MT * kc; i += THREADS) {
    const int chunk = i % kc;
    const int r = i / kc;
    uint4 v = tux::zero16();
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(tokens + size_t(m0 + r) * D +
                                          chunk * 8);
    *reinterpret_cast<uint4*>(as + r * S + chunk * 8) = v;
  }
  for (int i = tid; i < U_NT * kc; i += THREADS) {
    const int chunk = i % kc;
    const int r = i / kc;
    *reinterpret_cast<uint4*>(bs + r * S + chunk * 8) =
        *reinterpret_cast<const uint4*>(wt + size_t(n0 + r) * D + chunk * 8);
  }
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const __nv_bfloat16* r0 = as + (wm * 32 + f * 16 + g) * S + kk * 16;
      tux::load_a(a[f], r0, r0 + 8 * S, t);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bf[2];
      tux::load_b(bf, bs + (wn * 32 + j * 8 + g) * S + kk * 16, t);
#pragma unroll
      for (int f = 0; f < 2; ++f)
        tux::mma_bf16(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3], bf[0],
                      bf[1]);
    }
  }

#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + f * 16 + g + 8 * h;
      if (m >= M) continue;
      const int tx = m % Wt;
      const int bt = m / Wt;  // b * Ht + ty
      const int ty = bt % Ht;
      const int b = bt / Ht;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        const int p = n / C;  // pixel within the patch: dy * 8 + dx
        const int c = n % C;
        const size_t off =
            ((size_t(b) * H + ty * PS + p / PS) * W + tx * PS + p % PS) * C +
            c;
        float s0, s1;
        if constexpr (I8) {
          const char2 q = *reinterpret_cast<const char2*>(
              static_cast<const int8_t*>(skip) + off);
          s0 = __fmul_rn(float(q.x), feat_scale[c]);
          s1 = __fmul_rn(float(q.y), feat_scale[c + 1]);
        } else {
          const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(skip) + off);
          s0 = __bfloat162float(s.x);
          s1 = __bfloat162float(s.y);
        }
        float v0, v1;
        if constexpr (R3) {
          const float2 y = __bfloat1622float2(__floats2bfloat162_rn(
              acc[f][j][2 * h], acc[f][j][2 * h + 1]));
          const float2 yb = __bfloat1622float2(
              __floats2bfloat162_rn(y.x + bias[c], y.y + bias[c + 1]));
          v0 = yb.x + s0;
          v1 = yb.y + s1;
        } else {
          v0 = acc[f][j][2 * h] + bias[c] + s0;
          v1 = acc[f][j][2 * h + 1] + bias[c + 1] + s1;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(v0);
        v.y = __float2bfloat16_rn(v1);
        *reinterpret_cast<__nv_bfloat162*>(out + off) = v;
      }
    }
}

template <bool I8, bool R3>
int launch_unembed(const void* tokens, const void* wt, const void* bias,
                   const void* skip, const void* feat_scale, void* out, int B,
                   int Ht, int Wt, int D, int relu, void* stream) {
  const int M = B * Ht * Wt;
  const size_t smem = size_t(MT + U_NT) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      unembed_kernel<I8, R3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((M + MT - 1) / MT, PS * PS * C / U_NT);
  unembed_kernel<I8, R3>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(tokens),
          static_cast<const __nv_bfloat16*>(wt),
          static_cast<const float*>(bias), skip,
          static_cast<const float*>(feat_scale),
          static_cast<__nv_bfloat16*>(out), M, Ht, Wt, D, relu);
  return int(cudaGetLastError());
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 on success).
// D must be a multiple of 64 (embed) or of 16 (unembed). A null in_scale /
// feat_scale means bf16 feat / skip; else they are int8 with these (64) f32
// scales. round_steps (bf16 skip, no ReLU): the three-rounding epilogue.
extern "C" int tux_embed(const void* feat, const void* wt, const void* bias,
                         const void* in_scale, void* tokens, int B, int Ht,
                         int Wt, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int M = B * Ht * Wt;
  const dim3 grid((M + MT - 1) / MT, D / E_NT);
  auto kern = in_scale != nullptr ? embed_kernel<true> : embed_kernel<false>;
  kern<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feat, static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(in_scale),
      static_cast<__nv_bfloat16*>(tokens), M, Ht, Wt, D);
  return int(cudaGetLastError());
}

extern "C" int tux_unembed_combine(const void* tokens, const void* wt,
                                   const void* bias, const void* skip,
                                   const void* feat_scale, void* out, int B,
                                   int Ht, int Wt, int D, int relu,
                                   int round_steps, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (round_steps && (feat_scale != nullptr || relu))
    return int(cudaErrorInvalidValue);
  if (round_steps)
    return launch_unembed<false, true>(tokens, wt, bias, skip, nullptr, out,
                                       B, Ht, Wt, D, 0, stream);
  if (feat_scale != nullptr)
    return launch_unembed<true, false>(tokens, wt, bias, skip, feat_scale,
                                       out, B, Ht, Wt, D, relu, stream);
  return launch_unembed<false, false>(tokens, wt, bias, skip, nullptr, out, B,
                                      Ht, Wt, D, relu, stream);
}
