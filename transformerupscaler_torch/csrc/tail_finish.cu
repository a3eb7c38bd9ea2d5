// Split branch-B tail for Hopper (sm_90a): a 5x5 mid conv 64 -> cm and a 3x3
// finish conv cm -> co in one kernel; the mid tensor never goes to device
// memory.
//
// Replaces transformerupscaler_tpu/ops/pallas/stream.py:1078
// tail_finish_stream (kernel body :991). What it computes, NHWC bf16 in:
//   mid = conv5x5(x, k_mid) + b_mid   zero-padded x, f32 accumulation, f32 bias
//   mid = 0 outside the image         rows < 0 or >= H, columns < 0 or >= W:
//                                     the finish's own zero pad, not the bias
//                                     and not a conv of padding
//   mid rounded once to bf16
//   out = conv3x3(mid, k_fin) + b_fin f32 accumulation, one rounding to OutT
// hi_lo_fin selects how the finish rounds: 0 ("off") takes k_fin rounded to
// bf16; 1 ("wf") takes k_fin as hi + lo bf16 halves, two products summed in
// f32; 2 ("full") also splits the f32 mid into hi + lo and sums hi.hi, hi.lo
// and lo.hi (lo.lo is dropped). The TPU kernel's macro-8 packing, K- and
// N-concatenated weight layouts and 3-row halo blocks are not carried over. A
// 3x3 mid conv arrives centred in a zero 5x5 frame.
//
// Design: one block owns an 8 x 32 output tile. It copies the zero-padded
// 14 x 38 x 64 input halo to shared memory, computes the 10 x 34 mid tile as
// an implicit GEMM over the 340 mid pixels taken in linear order (22 M
// fragments over 8 warps, weights streamed one kernel row at a time), writes
// the masked, rounded mid tile to shared memory with cm padded to 16 or 32,
// and runs the nine finish taps on it with mma.sync m16n8k16, each warp one
// output row. The epilogue stages the tile so that NHWC rows leave coalesced.
// The mid tile and the staging tile take the place of the halo and the mid
// weights, which are dead by then, so that two blocks of the x2 shape fit on
// an SM and one block's loads overlap the other's products.
// cm and co are padded with zero weights to (16, 16), (32, 32) or (16, 48):
// x2, x3 and x4.
//
// Bound on the H100 at 720x1280, x2 (cm = co = 12): 118 MB in and 22 MB out,
// 0.042 ms at 3.35 TB/s; 37.8 G operations, 0.038 ms at 989 TF/s. This first
// version has no copy/compute overlap and recomputes the mid ring of each
// tile (340 mid pixels for 256 outputs); see PERF.md.
#include "common.cuh"

namespace {

constexpr int CIN = 64;
constexpr int CS = CIN + 8;  // row stride (elements) of a pixel in the halo
constexpr int TH = 8;        // output tile rows == warps per block
constexpr int TW = 32;       // output tile columns == two M fragments
constexpr int THREADS = 256;
constexpr int KM = 5;                 // mid conv frame
constexpr int MH = TH + 2;            // mid tile: one ring around the outputs
constexpr int MW = TW + 2;
constexpr int HH = MH + KM - 1;       // input halo
constexpr int HW = MW + KM - 1;
constexpr int MPIX = MH * MW;                         // 340
constexpr int MFRAGS = (MPIX + 15) / 16;              // 22
constexpr int FPW = (MFRAGS + TH - 1) / TH;           // M fragments per warp
constexpr int MROWS = FPW * TH * 16;                  // mid rows kept

using bf16 = __nv_bfloat16;

template <int CMP, int COP, typename OutT>
struct Layout {
  static constexpr int MS = CMP + 8;  // row stride of mid pixels and of k_fin
  static constexpr size_t halo = size_t(HH) * HW * CS * 2;
  static constexpr size_t wrow = size_t(KM) * CMP * CS * 2;
  static constexpr size_t mid = size_t(2) * MROWS * MS * 2;     // hi, lo
  static constexpr size_t wfin = size_t(2) * 9 * COP * MS * 2;  // hi, lo
  static constexpr size_t stage = size_t(TH) * TW * COP * sizeof(OutT);
  // First the halo and a row of mid weights, then in their place the mid
  // tile and the staging tile; the finish weights stay throughout.
  static constexpr size_t phases =
      halo + wrow > mid + stage ? halo + wrow : mid + stage;
  static constexpr size_t bytes = phases + wfin;
};

// x (B,H,W,64) bf16; wm (5,5,CMP,64) bf16 [dy][dx][cm][cin]; bm (cm) f32;
// wf (2,3,3,COP,CMP) bf16 [hi|lo][dy][dx][co][cm]; bfin (co) f32;
// out (B,H,W,co) OutT.
template <int CMP, int COP, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
tail_finish_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wm,
                   const float* __restrict__ bm, const bf16* __restrict__ wf,
                   const float* __restrict__ bfin, OutT* __restrict__ out,
                   int H, int W, int cm, int co, int mode) {
  using L = Layout<CMP, COP, OutT>;
  constexpr int MS = L::MS;
  constexpr int NFM = CMP / 8;   // N fragments of the mid conv
  constexpr int NFO = COP / 8;   // N fragments of the finish
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* wsm = halo + HH * HW * CS;
  bf16* mid_hi = reinterpret_cast<bf16*>(smem);  // after the mid conv
  bf16* mid_lo = mid_hi + MROWS * MS;
  OutT* stage = reinterpret_cast<OutT*>(smem + L::mid);
  bf16* wf_hi = reinterpret_cast<bf16*>(smem + L::phases);
  bf16* wf_lo = wf_hi + 9 * COP * MS;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // Input halo: the mid tile starts one pixel up and left of the outputs,
  // and the 5x5 mid conv reaches two more.
  const bf16* xb = x + size_t(b) * H * W * CIN;
  for (int i = tid; i < HH * HW * 8; i += THREADS) {
    const int chunk = i & 7;
    const int p = i >> 3;
    const int iy = y0 + p / HW - 3;
    const int ix = x0 + p % HW - 3;
    uint4 v = tux::zero16();
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = *reinterpret_cast<const uint4*>(xb + (size_t(iy) * W + ix) * CIN +
                                          chunk * 8);
    *reinterpret_cast<uint4*>(halo + p * CS + chunk * 8) = v;
  }
  // Finish weights, both halves: 2 * 9 * COP rows of CMP elements.
  for (int i = tid; i < 2 * 9 * COP * (CMP / 8); i += THREADS) {
    const int chunk = i % (CMP / 8);
    const int r = i / (CMP / 8);
    *reinterpret_cast<uint4*>(wf_hi + r * MS + chunk * 8) =
        *reinterpret_cast<const uint4*>(wf + size_t(r) * CMP + chunk * 8);
  }

  // ---- mid conv: M = 340 mid pixels in linear order, fragment warp + 8 i.
  // Rows past the tile's last pixel are clamped to it and never stored.
  int poff[FPW][2];  // halo offsets of this thread's rows g and g + 8
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = min((warp + TH * i) * 16 + g + 8 * hh, MPIX - 1);
      poff[i][hh] = ((p / MW) * HW + p % MW) * CS;
    }
  float acc[FPW][NFM][4];
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int j = 0; j < NFM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int dy = 0; dy < KM; ++dy) {
    __syncthreads();  // the previous kernel row is no longer being read
    const bf16* wrow = wm + size_t(dy) * KM * CMP * CIN;
    for (int i = tid; i < KM * CMP * 8; i += THREADS) {
      const int chunk = i & 7;
      const int r = i >> 3;  // dx * CMP + n
      *reinterpret_cast<uint4*>(wsm + r * CS + chunk * 8) =
          *reinterpret_cast<const uint4*>(wrow + size_t(r) * CIN + chunk * 8);
    }
    __syncthreads();
    for (int dx = 0; dx < KM; ++dx) {
      const bf16* tap = halo + (dy * HW + dx) * CS;
      const bf16* wtap = wsm + dx * CMP * CS;
#pragma unroll
      for (int kk = 0; kk < CIN / 16; ++kk) {
        uint32_t a[FPW][4];
#pragma unroll
        for (int i = 0; i < FPW; ++i)
          tux::load_a(a[i], tap + poff[i][0] + kk * 16,
                      tap + poff[i][1] + kk * 16, t);
#pragma unroll
        for (int j = 0; j < NFM; ++j) {
          uint32_t bw[2];
          tux::load_b(bw, wtap + (j * 8 + g) * CS + kk * 16, t);
#pragma unroll
          for (int i = 0; i < FPW; ++i)
            tux::mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3],
                          bw[0], bw[1]);
        }
      }
    }
  }

  // Mid epilogue: bias, zero outside the image, one rounding to bf16 (and
  // the rounding's remainder as the lo half), into the halo's place.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (warp + TH * i) * 16 + g + 8 * hh;
      if (p >= MPIX) continue;
      const int gy = y0 - 1 + p / MW;
      const int gx = x0 - 1 + p % MW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < NFM; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = j * 8 + 2 * t + e;
          const float v = (inside && n < cm) ? acc[i][j][2 * hh + e] + bm[n]
                                             : 0.f;
          const bf16 hi = __float2bfloat16_rn(v);
          mid_hi[p * MS + n] = hi;
          mid_lo[p * MS + n] = __float2bfloat16_rn(v - __bfloat162float(hi));
        }
    }
  __syncthreads();

  // ---- finish: each warp one output row, nine taps on the mid tile.
  float acc2[2][NFO][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NFO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[f][j][e] = 0.f;
  for (int dy = 0; dy < 3; ++dy)
    for (int dx = 0; dx < 3; ++dx) {
      const int moff = ((warp + dy) * MW + dx) * MS;  // output column 0
      const int woff = (dy * 3 + dx) * COP * MS;
#pragma unroll
      for (int kk = 0; kk < CMP / 16; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int r = moff + (f * 16 + g) * MS + kk * 16;
          tux::load_a(ah[f], mid_hi + r, mid_hi + r + 8 * MS, t);
          if (mode == 2) tux::load_a(al[f], mid_lo + r, mid_lo + r + 8 * MS, t);
        }
#pragma unroll
        for (int j = 0; j < NFO; ++j) {
          const int r = woff + (j * 8 + g) * MS + kk * 16;
          uint32_t bh[2], bl[2];
          tux::load_b(bh, wf_hi + r, t);
          if (mode >= 1) tux::load_b(bl, wf_lo + r, t);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            tux::mma_bf16(acc2[f][j], ah[f][0], ah[f][1], ah[f][2], ah[f][3],
                          bh[0], bh[1]);
            if (mode >= 1)
              tux::mma_bf16(acc2[f][j], ah[f][0], ah[f][1], ah[f][2],
                            ah[f][3], bl[0], bl[1]);
            if (mode == 2)
              tux::mma_bf16(acc2[f][j], al[f][0], al[f][1], al[f][2],
                            al[f][3], bh[0], bh[1]);
          }
        }
      }
    }

  // Stage the output tile behind the mid tile.
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int p0 = warp * TW + f * 16 + g;
#pragma unroll
    for (int j = 0; j < NFO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = j * 8 + 2 * t + (e & 1);
        const int p = p0 + (e >> 1) * 8;
        if (n < co)
          stage[p * co + n] = tux::from_f32<OutT>(acc2[f][j][e] + bfin[n]);
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

template <int CMP, int COP, typename OutT>
int launch(const void* x, const void* wm, const void* bm, const void* wf,
           const void* bfin, void* out, int B, int H, int W, int cm, int co,
           int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  constexpr size_t smem = Layout<CMP, COP, OutT>::bytes;
  auto kern = tail_finish_kernel<CMP, COP, OutT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wm),
      static_cast<const float*>(bm), static_cast<const bf16*>(wf),
      static_cast<const float*>(bfin), static_cast<OutT*>(out), H, W, cm, co,
      mode);
  return int(cudaGetLastError());
}

template <typename OutT>
int dispatch(const void* x, const void* wm, const void* bm, const void* wf,
             const void* bfin, void* out, int B, int H, int W, int cm, int cmp,
             int co, int cop, int mode, int device, void* stream) {
  if (cmp == 16 && cop == 16)
    return launch<16, 16, OutT>(x, wm, bm, wf, bfin, out, B, H, W, cm, co,
                                mode, device, stream);
  if (cmp == 32 && cop == 32)
    return launch<32, 32, OutT>(x, wm, bm, wf, bfin, out, B, H, W, cm, co,
                                mode, device, stream);
  if (cmp == 16 && cop == 48)
    return launch<16, 48, OutT>(x, wm, bm, wf, bfin, out, B, H, W, cm, co,
                                mode, device, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// wm is (5, 5, cmp, 64) and wf (2, 3, 3, cop, cmp), zero beyond cm and co,
// with (cmp, cop) one of (16, 16), (32, 32), (16, 48); mode is 0 off, 1 wf,
// 2 full. Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_tail_finish(const void* x, const void* wm, const void* bm,
                               const void* wf, const void* bfin, void* out,
                               int B, int H, int W, int cm, int cmp, int co,
                               int cop, int mode, int out_f32, int device,
                               void* stream) {
  if (mode < 0 || mode > 2 || cm > cmp || co > cop)
    return int(cudaErrorInvalidValue);
  if (out_f32)
    return dispatch<float>(x, wm, bm, wf, bfin, out, B, H, W, cm, cmp, co,
                           cop, mode, device, stream);
  return dispatch<bf16>(x, wm, bm, wf, bfin, out, B, H, W, cm, cmp, co, cop,
                        mode, device, stream);
}
