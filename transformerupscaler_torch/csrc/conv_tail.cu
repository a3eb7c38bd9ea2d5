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
// Design. With P = (k - 1) / 2, a strip is a column of 64 conv pixels that
// owns the OWN = 64 - 2P tail outputs in its middle (60 at k = 5, 58 at
// k = 7): the horizontal overlap costs 64 / OWN of the conv work (1.07x,
// 1.10x). The strip-rows of the image, in (batch, strip, row) order, are cut
// into one contiguous range per persistent block (one block an SM), so every
// SM gets the same number of rows; a range breaks into segments at strip
// ends, and a segment of rows [y0, y1) computes the conv rows [y0 - P,
// y1 + P) once each: the vertical ring is paid once a segment, not once a
// tile. A block is one producer warp and two consumer warpgroups:
//   producer  TMA: the nine conv weight slabs once (72 KB, resident), the
//             tail weights (resident for the block's 16-output group), and
//             the strip's input rows, 72 pixels x 64 channels (9 KB,
//             128B-swizzled, zero-filled outside the map) through a ring of
//             NS rows, each row loaded once;
//   conv WG   conv row m as an implicit GEMM on wgmma m64n64k16, M = the 64
//             pixels, K = 9 taps x 64: the A operand of tap (dy, dx) is input
//             row m + dy - 1 shifted dx pixels (a descriptor shifted dx rows
//             of 128 bytes), B the tap's weight slab. Epilogue: + bias, ReLU,
//             zero outside the image, one rounding to bf16, into a ring of
//             NM mid rows laid out as the input rows (72 pixels, 128B
//             swizzle), so the tail reads them as the conv reads its input;
//             the owned pixels of the owned rows also go to feat, straight
//             from the registers;
//   tail WG   for each mid row m one wgmma GEMM, M = 64 pixels, K = k dx
//             shifts x 64 channels, N = k kernel rows (dy) x 16 outputs side
//             by side (m64n{48,80,112}k16, B K-major): D[p][dy, o] is mid row
//             m's contribution to output row m + P - dy. Output rows
//             m - P .. m + P - 1 are kept in registers and shifted one row
//             per mid row (the shift-add): output row m - P is complete after
//             mid row m and goes to device memory; rows outside the image
//             contribute zero and cost no products.
// Each product of the tail runs once a mid row instead of once for each of
// the k output rows it feeds, with both operands read from shared memory a
// k16 step at a time (A 2 KB, B 0.5 KB x k): at k = 7 the m64n112k16 reads
// 5.5 KB for 229 kFLOP, under the shared-memory port's 128 B a clock at the
// tensor rate, where k x k m64n16k16 products would read 2.5 KB for 33 kFLOP.
// co is padded with zero weights to npad = 16, 32 or 48 (x2, x3, x4); a
// block runs its range once for each 16-output group, computing the conv
// again for each (x3 and x4 run the conv 2x and 3x, which x2, the served
// case, does not).
//
// Bound on the H100 at 720x1280, x2 (co = 12):
//   decoder, 7x7, no emit: 67.9 + 69.4 GFLOP = 0.139 ms at 989 TF/s; 118 MB
//     in and 22 MB out, 0.042 ms at 3.35 TB/s;
//   encoder, 5x5, emitting: 67.9 + 35.4 GFLOP = 0.105 ms; 258 MB, 0.077 ms.
// The kernel does 1.07-1.10x the conv work (strip overlap), pads co 12 to
// 16 and computes the 2P ring rows once a segment (about 6% more rows).
#include "strip.cuh"

namespace {

namespace S = tux::sm90;
using namespace tux::strip;

constexpr int RX = 72;              // pixels of a ring row: M + 8
constexpr int ROW = RX * 128;       // bytes of a ring row (9 x 1024)
constexpr int CSLAB = 64 * 64 * 2;  // one tap of conv weights, 64 x 64
constexpr int NS = 4;               // input ring rows
constexpr int THREADS = 2 * 128 + 32;

template <int KT>
struct Geo {
  static constexpr int P = (KT - 1) / 2;
  static constexpr int OWN = MW - 2 * P;  // tail outputs a strip owns
  static constexpr int N = KT * NG;       // tail GEMM width: (dy, output)
  static constexpr int TSLAB = N * 128;   // one dx: N K-major rows of 64
  static constexpr int CW = 9 * CSLAB;
  static constexpr int TWB = KT * TSLAB;
  static constexpr int NM = 2;            // mid ring rows
  static constexpr int BARS = 3 + 2 * NS + 2 * NM;
  static constexpr int BYTES = 1024 + CW + TWB + (NS + NM) * ROW + BARS * 8;
};

// xmap: x (B, H, W, 64) as (64, W, H, B), box (64, 72, 1, 1); wmap: the conv
// weights (576, 64) = w[dy][dx][c][o] as rows (tap, c), box (64, 64); tmap:
// the tail slabs (groups x k x N, 64) = wt[grp][dx][dy][o][c], box (64, N).
// All 128B-swizzled. bc (64) and bt (co) f32; out (B, H, W, co) bf16 or f32;
// feat (B, H, W, 64) bf16 or null. T = B x strips x H strip-rows.
template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
conv_tail_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap tmap,
                 const float* __restrict__ bc, const float* __restrict__ bt,
                 void* __restrict__ out, bf16* __restrict__ feat, int H,
                 int W, int co, int groups, int strips, int T, int tail_relu,
                 int out_f32) {
  using G = Geo<KT>;
  constexpr int P = G::P, NM = G::NM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* cw = align1024(smem_raw);
  unsigned char* tw = cw + G::CW;
  unsigned char* in = tw + G::TWB;
  unsigned char* mid = in + NS * ROW;
  uint64_t* cw_full = reinterpret_cast<uint64_t*>(mid + NM * ROW);
  uint64_t* tw_full = cw_full + 1;
  uint64_t* tw_empty = cw_full + 2;
  uint64_t* in_full = cw_full + 3;
  uint64_t* in_empty = in_full + NS;
  uint64_t* mid_full = in_empty + NS;
  uint64_t* mid_empty = mid_full + NM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    S::mbar_init(cw_full, 1);
    S::mbar_init(tw_full, 1);
    S::mbar_init(tw_empty, 4);
    for (int s = 0; s < NS; ++s) {
      S::mbar_init(&in_full[s], 1);
      S::mbar_init(&in_empty[s], 4);
    }
    for (int s = 0; s < NM; ++s) {
      S::mbar_init(&mid_full[s], 4);
      S::mbar_init(&mid_empty[s], 4);
    }
    S::fence_barrier_init();
  }
  // Pixels MW.. of the mid rows feed only the last 2P rows of the tail's M,
  // which no strip stores; zero them once so they hold numbers.
  constexpr int PAD16 = (RX - MW) * 8;
  for (int i = tid; i < NM * PAD16; i += THREADS)
    *reinterpret_cast<uint4*>(mid + (i / PAD16) * ROW + MW * 128 +
                              (i % PAD16) * 16) = make_uint4(0, 0, 0, 0);
  S::fence_async_smem();
  __syncthreads();
  int t0, t1;  // this block's strip-rows
  block_rows(T, t0, t1);

  if (tid >= 256) {  // producer warp: one thread issues every copy
    if (tid != 256) return;
    S::mbar_expect_tx(cw_full, G::CW);
    for (int tap = 0; tap < 9; ++tap)
      S::tma_load_2d(cw + tap * CSLAB, &wmap, cw_full, 0, tap * 64);
    uint32_t n = 0;  // input rows loaded
    for (int grp = 0; grp < groups; ++grp) {
      S::mbar_wait(tw_empty, (grp & 1) ^ 1);
      S::mbar_expect_tx(tw_full, G::TWB);
      for (int dx = 0; dx < KT; ++dx)
        S::tma_load_2d(tw + dx * G::TSLAB, &tmap, tw_full, 0,
                       (grp * KT + dx) * G::N);
      for (int t = t0; t < t1;) {
        const Seg sg = segment(t, t1, H, strips, G::OWN);
        // Conv rows [ma, mb), the tail's reach clipped to the image, read
        // input rows ma - 1 .. mb.
        const int ma = max(sg.y0 - P, 0), mb = min(sg.y1 + P, H);
        for (int r = ma - 1; r <= mb; ++r, ++n) {
          const int slot = n % NS;
          S::mbar_wait(&in_empty[slot], par(n, NS) ^ 1);
          S::mbar_expect_tx(&in_full[slot], ROW);
          S::tma_load_4d(in + slot * ROW, &xmap, &in_full[slot], 0,
                         sg.x0 - P - 1, r, sg.b);
        }
        t += sg.y1 - sg.y0;
      }
    }
    return;
  }

  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  if (tid < 128) {  // the conv warpgroup
    // Bias of this thread's channels 8 j + 2 t4 + e at [2 j + e].
    float bs[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) bs[i] = bc[8 * (i >> 1) + 2 * t4 + (i & 1)];
    S::mbar_wait(cw_full, 0);
    float acc[32];
    uint32_t n = 0, mq = 0;  // input rows, mid rows used
    for (int grp = 0; grp < groups; ++grp) {
      for (int t = t0; t < t1;) {
        const Seg sg = segment(t, t1, H, strips, G::OWN);
        const int ma = max(sg.y0 - P, 0), mb = min(sg.y1 + P, H);
        S::mbar_wait(&in_full[n % NS], par(n, NS));
        S::mbar_wait(&in_full[(n + 1) % NS], par(n + 1, NS));
        for (int m = ma; m < mb; ++m) {
          const uint32_t q = n + (m - ma);  // input row m - 1
          S::mbar_wait(&in_full[(q + 2) % NS], par(q + 2, NS));
          const unsigned char* rows[3] = {in + (q % NS) * ROW,
                                          in + ((q + 1) % NS) * ROW,
                                          in + ((q + 2) % NS) * ROW};
          S::wgmma_fence();
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              S::wgmma_ss_n64(acc, desc_row(rows[tap / 3], tap % 3, s),
                              S::desc_b(cw + tap * CSLAB, s), tap | s);
          S::wgmma_commit();
          S::wgmma_wait<0>();
          release(&in_empty[q % NS], lane);
          if (m == mb - 1) {  // the segment's last two rows are done too
            release(&in_empty[(q + 1) % NS], lane);
            release(&in_empty[(q + 2) % NS], lane);
          }
          S::fence_acc(acc);

          // Epilogue: + bias, ReLU, zero outside the image, one rounding,
          // into mid row slot ms; the owned pixels of owned rows to feat.
          const int ms = mq % NM;
          S::mbar_wait(&mid_empty[ms], par(mq, NM) ^ 1);
          unsigned char* mrow = mid + ms * ROW;
          const bool emit =
              feat != nullptr && grp == 0 && m >= sg.y0 && m < sg.y1;
          bf16* frow =
              emit ? feat + (size_t(sg.b) * H + m) * W * 64 : nullptr;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 16 * warp + g + 8 * i;
            const int x = sg.x0 - P + r;
            const bool inside = x >= 0 && x < W;
            const bool owned = emit && inside && r >= P && r < MW - P;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint32_t v =
                  inside ? pack(fmaxf(acc[4 * j + 2 * i] + bs[2 * j], 0.f),
                                fmaxf(acc[4 * j + 2 * i + 1] + bs[2 * j + 1],
                                      0.f))
                         : 0u;
              *reinterpret_cast<uint32_t*>(mrow + sw128(r, j) + 4 * t4) = v;
              if (owned)
                *reinterpret_cast<uint32_t*>(frow + size_t(x) * 64 + 8 * j +
                                             2 * t4) = v;
            }
          }
          S::fence_async_smem();  // the tail's wgmma reads the row
          release(&mid_full[ms], lane);
          ++mq;
        }
        n += mb - ma + 2;
        t += sg.y1 - sg.y0;
      }
    }
    return;
  }

  // The tail warpgroup: the shift-add over the mid rows.
  uint32_t mq = 0;  // mid rows used
  for (int grp = 0; grp < groups; ++grp) {
    float bq[1][4];
    group_bias(bq, bt, co, grp);
    S::mbar_wait(tw_full, grp & 1);
    for (int t = t0; t < t1;) {
      const Seg sg = segment(t, t1, H, strips, G::OWN);
      shift_add<KT, 1>(
          sg.y0, sg.y1, max(sg.y0 - P, 0), min(sg.y1 + P, H),
          [&](int m, int, float (&D)[8 * KT]) {
            const int ms = mq % NM;
            S::mbar_wait(&mid_full[ms], par(mq, NM));
            const unsigned char* mrow = mid + ms * ROW;
            S::wgmma_fence();
#pragma unroll
            for (int dx = 0; dx < KT; ++dx)
#pragma unroll
              for (int s = 0; s < 4; ++s)
                S::wgmma_ss_kb<G::N>(D, desc_row(mrow, dx, s),
                                     desc_slab(tw + dx * G::TSLAB, s),
                                     dx | s);
            S::wgmma_commit();
            S::wgmma_wait<0>();
            release(&mid_empty[ms], lane);
            S::fence_acc(D);
            ++mq;
          },
          [&](int y, const float (&o)[1][8]) {
            store_row<1>(out, (size_t(sg.b) * H + y) * W, sg.x0, G::OWN, W,
                         co, grp, o, bq, tail_relu, out_f32);
          });
      t += sg.y1 - sg.y0;
    }
    release(tw_empty, lane);
  }
}

template <int KT>
int launch(const void* x, const void* wc, const void* bc, const void* wt,
           const void* bt, void* out, void* feat, int B, int H, int W, int co,
           int groups, int tail_relu, int out_f32, int device, void* stream) {
  using G = Geo<KT>;
  static_assert(G::BYTES <= MAX_SMEM, "conv_tail shared memory");
  CUtensorMap xm, wm, tm;
  int e = S::map_nhwc(&xm, x, B, H, W, 64, RX, 1);
  if (e == 0) e = S::map_matrix(&wm, wc, 9 * 64, 64, 64);
  if (e == 0) e = S::map_matrix(&tm, wt, groups * KT * G::N, 64, G::N);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      conv_tail_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::BYTES);
  if (err != cudaSuccess) return int(err);
  const int strips = (W + G::OWN - 1) / G::OWN;
  const int T = B * strips * H;
  const int sms = S::sm_count(device);
  conv_tail_kernel<KT>
      <<<T < sms ? T : sms, THREADS, G::BYTES,
         static_cast<cudaStream_t>(stream)>>>(
          xm, wm, tm, static_cast<const float*>(bc),
          static_cast<const float*>(bt), out, static_cast<bf16*>(feat), H, W,
          co, groups, strips, T, tail_relu, out_f32);
  return int(cudaGetLastError());
}

// The K-major-B wgmma probe: one warpgroup computes D (64 x N, f32) =
// A (64 x 64) . B^T with B (N x 64), both bf16 loaded by TMA with the 128B
// swizzle, through wgmma_ss_kb<N>. D row-major.
template <int N>
__global__ void __launch_bounds__(128)
kb_probe_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                float* __restrict__ d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a = align1024(smem_raw);
  unsigned char* bt = a + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bt + N * 128);
  const int tid = threadIdx.x;
  if (tid == 0) {
    S::mbar_init(bar, 1);
    S::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    S::mbar_expect_tx(bar, (64 + N) * 128);
    S::tma_load_2d(a, &amap, bar, 0, 0);
    S::tma_load_2d(bt, &bmap, bar, 0, 0);
  }
  S::mbar_wait(bar, 0);
  float acc[N / 2];
  S::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    S::wgmma_ss_kb<N>(acc, S::desc(a + 32 * s, 16, 1024),
                      S::desc(bt + 32 * s, 16, 1024), s);
  S::wgmma_commit();
  S::wgmma_wait<0>();
  S::fence_acc(acc);
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(16 * warp + g + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] =
          acc[4 * j + e];
}

template <int N>
int launch_probe(const void* a, const void* b, void* d, void* stream) {
  CUtensorMap am, bm;
  int e = S::map_matrix(&am, a, 64, 64, 64);
  if (e == 0) e = S::map_matrix(&bm, b, N, 64, N);
  if (e != 0) return e;
  kb_probe_kernel<N>
      <<<1, 128, 1024 + (64 + N) * 128 + 8,
         static_cast<cudaStream_t>(stream)>>>(am, bm, static_cast<float*>(d));
  return int(cudaGetLastError());
}

}  // namespace

// x (B,H,W,64) bf16; wc (576, 64) bf16 = the HWIO conv kernel as rows
// (dy, dx, c); bc (64) f32; wt (npad / 16 x kt x kt x 16, 64) bf16 = the
// tail kernel as rows (group, dx, dy, output) of 64 input channels, outputs
// past co zero; bt (co) f32; out (B,H,W,co) bf16 or f32 (out_f32); feat
// (B,H,W,64) bf16 or null (no emit). kt in {3, 5, 7}, npad in {16, 32, 48},
// co <= npad. Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_conv_tail(const void* x, const void* wc, const void* bc,
                             const void* wt, const void* bt, void* out,
                             void* feat, int B, int H, int W, int kt, int co,
                             int npad, int tail_relu, int out_f32,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (co > npad || co < 1 || npad % NG || npad < NG || npad > 3 * NG)
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int groups = npad / NG;
  switch (kt) {
    case 3:
      return launch<3>(x, wc, bc, wt, bt, out, feat, B, H, W, co, groups,
                       tail_relu, out_f32, device, stream);
    case 5:
      return launch<5>(x, wc, bc, wt, bt, out, feat, B, H, W, co, groups,
                       tail_relu, out_f32, device, stream);
    case 7:
      return launch<7>(x, wc, bc, wt, bt, out, feat, B, H, W, co, groups,
                       tail_relu, out_f32, device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// a (64, 64), b (n, 64) bf16; d (64, n) f32 = a . b^T, n in {48, 80, 112}.
// Returns a cudaError_t.
extern "C" int tux_wgmma_kb_probe(const void* a, const void* b, void* d,
                                  int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  switch (n) {
    case 48:
      return launch_probe<48>(a, b, d, stream);
    case 80:
      return launch_probe<80>(a, b, d, stream);
    case 112:
      return launch_probe<112>(a, b, d, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
