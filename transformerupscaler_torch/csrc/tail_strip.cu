// The composed k x k tail and the split branch-B tail as column-strip
// kernels on TMA + wgmma, for Hopper (sm_90a).
//
// Replaces three TPU kernels of transformerupscaler_tpu/ops/pallas/stream.py:
//   tail_macro8_stream (:777, body :740)   ->  tux_tail_conv
//   tail_finish_stream (:1078, body :991)  ->  tux_tail_finish
//   tail_macro8_stream_int8 (:893)         ->  tux_tail_conv_int8, which also
//                                              serves the XLA
//                                              conv2d_tail_packed_int8
//                                              (ops/conv.py:419) of the JAX
//                                              int8 tails: one function
//                                              (stream.py:897-905,
//                                              conv.py:424-430)
// What they compute, NHWC bf16 in, f32 accumulation:
//   tux_tail_conv    out = act(conv_kxk(x, w) + b), k = 5, 7, 64 -> co <= 48,
//                    zero-padded x, f32 bias, optional ReLU, one rounding to
//                    bf16 or f32;
//   tux_tail_finish  mid = conv_kxk(x, k_mid) + b_mid (k = 5; a 3x3 arrives
//                    centred in a zero 5x5 frame), 64 -> cm; mid = 0 outside
//                    the image, in rows and in columns (the finish's own zero
//                    pad); mid rounded once to bf16;
//                    out = conv3x3(mid, k_fin) + b_fin, one rounding to bf16
//                    or f32. hi_lo_fin (mode) 0 "off": k_fin rounded to bf16;
//                    1 "wf": k_fin as hi + lo bf16 halves, two products; 2
//                    "full": also the mid's remainder as lo, hi.hi + hi.lo +
//                    lo.hi (lo.lo dropped). (cm, co) padded with zero weights
//                    to (16, 16), (32, 32) or (16, 48): x2, x3, x4.
//   tux_tail_conv_int8  the tail conv on an int8 map quantized per input
//                    channel, int8 weights with that scale folded in and
//                    per-output f32 scales ks (ops.quant.fold_conv_kernel):
//                    out = act(float(acc) * ks + b), acc the exact int32 sum,
//                    the multiply and the add each rounded on its own (no
//                    fused multiply-add), one rounding to bf16 or f32: bit
//                    for bit with ops.conv.conv2d_int8_q.
// The TPU kernels' macro-8 packing and row slabs are not carried over.
//
// Design: csrc/strip.cuh's column strips, persistent blocks and shift-add
// stage, as csrc/conv_tail.cu runs them, fed here by the input rows
// themselves. A producer warpgroup (one thread issues, setmaxnreg gives its
// registers to the consumers) keeps a strip's input rows in a TMA ring of
// 136-pixel rows (128B swizzle, zero fill outside the map, each row loaded
// once a segment) and the weights resident. Two consumer warpgroups share
// each ring row, 64 pixels each, and issue their products in turns (named
// barriers), so that each one's epilogue runs under the other's products;
// without the turns they run in step, epilogue beside epilogue, 15-17%
// slower (kernel_ablation.py, no_turns).
//   tail conv    a strip of 128 pixels owns 128 - 2P outputs (124 at k = 5,
//                122 at k = 7). Each warpgroup runs the shift-add over the
//                input rows: one m64n{80,112}k16 chain a row (K = k dx x
//                64), the k output rows in registers, a finished row stored
//                from them. npad 32 and 48 run the range once per 16-output
//                group.
//   split tail   a strip owns 124 outputs, 62 a warpgroup; warpgroup c's
//                64 mid pixels are the columns x0 - 1 + 62 c .. x0 + 62 + 62 c.
//                It runs the 5x5 mid shift-add over the input rows (N = 5 x
//                16 a 16-channel group); each finished mid row gets its
//                bias, the image mask and one rounding (plus the remainder
//                as lo in "full") and goes into the warpgroup's mid row in
//                shared memory, 128B-swizzled like the input rows: hi at
//                channels 0..cmp-1, lo at cmp..2 cmp-1. The warpgroup then
//                takes the finish's 3x3 shift-add one step on it (K = 3 dx x
//                16, N = 3 dy x 16 a 16-output group, m64n48k16): "wf" adds a
//                product of the hi channels with the lo weights, "full" one
//                of the lo channels with the hi weights (the finish slab
//                holds w_hi at channels 0..cmp-1 and w_lo at cmp..2 cmp-1).
//                Each mid row is computed once a segment.
//   int8 tail    the tail conv's kernel with int8 operands: ring rows of
//                136 pixels x 64 bytes in the 64B swizzle (eight in the
//                ring), each dx two m64n{80,112}k32 s8 products whose A
//                starts MW c + dx 64-byte pixels in, the tail_slabs weights
//                in int8 (64-byte K-major rows), the shift-add's partial
//                rows in int32 (exact in any order, so bit for bit), and the
//                ks multiply in store_row.
// Input rows are read from device memory once a segment: 1.10x at 720p
// (strip overlap), plus the ring rows of each segment.
//
// Bound on the H100 at 720x1280, x2 (co = 12): the 5x5 tail and the split
// tail move 118 MB in and 22 MB out, 0.042 ms at 3.35 TB/s (35 and 38
// GFLOP, 0.036 / 0.038 ms at 989 TF/s); the 7x7 tail does 69 GFLOP, 0.070
// ms. Padding co 12 to 16 and the strip overlap add 1.4-1.5x to the
// products, and each m64nNk16 product with N = 80 or 112 reads its A (2 KB)
// and B (N x 32 B) from shared memory: with the rows' TMA writes, about
// 100-120 B a clock at the tensor rate, near the port's 128 B a clock. The
// int8 tail reads 59 MB and writes 22 MB: 0.024 ms; its 7x7 does 69 G int8
// operations, 0.035 ms at 1,979 TOP/s.
#include "strip.cuh"

namespace {

namespace S = tux::sm90;
using namespace tux::strip;

// Two consumer warpgroups and a producer warpgroup, so that setmaxnreg can
// move registers: at 12 warps a block ptxas allots 168 a thread; the
// producer keeps 24 and the consumers take 240 (2 x 240 + 24 = 3 x 168 on
// each sub-partition).
constexpr int THREADS = 3 * 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// ------------------------------------------------------ the composed tail
constexpr int TX = 2 * MW + 8;  // pixels of an input ring row: 2 M + 8
constexpr int TROW = TX * 128;  // bytes of a bf16 input ring row

// I8: int8 operands, a pixel's 64 channels in a 64-byte row (64B swizzle),
// k32 steps, int32 partial sums; twice the ring rows in the same bytes.
template <int KT, bool I8 = false>
struct TailGeo {
  static constexpr int P = (KT - 1) / 2;
  static constexpr int OWN = 2 * MW - 2 * P;  // outputs a strip owns
  static constexpr int N = KT * NG;           // GEMM width: (dy, output)
  static constexpr int PIX = I8 ? 64 : 128;   // bytes of a pixel's channels
  static constexpr int ROW = TX * PIX;        // bytes of an input ring row
  static constexpr int TNS = I8 ? 8 : 4;      // input ring rows
  static constexpr int TSLAB = N * PIX;       // one dx: N K-major rows
  static constexpr int TWB = KT * TSLAB;
  static constexpr int BARS = 2 + 2 * TNS;
  static constexpr int BYTES = 1024 + TWB + TNS * ROW + BARS * 8;
};

// xmap: x (B, H, W, 64) as (64, W, H, B), box (64, 136, 1, 1); tmap: the
// slabs (groups x k x N, 64) = w[grp][dx][dy][o][c], box (64, N); both
// 128B-swizzled bf16, or I8 int8 with the 64B swizzle. bt (co) f32, and for
// I8 the weight scales ks (co) f32; out (B, H, W, co) bf16 or f32.
// T = B x strips x H strip-rows.
template <int KT, bool I8>
__global__ void __launch_bounds__(THREADS, 1)
tail_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap tmap,
                 const float* __restrict__ bt, const float* __restrict__ ks,
                 void* __restrict__ out, int H, int W, int co, int groups,
                 int strips, int T, int relu, int out_f32) {
  using G = TailGeo<KT, I8>;
  using Acc = std::conditional_t<I8, int, float>;
  constexpr int P = G::P, TNS = G::TNS, TROW = G::ROW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tw = align1024(smem_raw);
  unsigned char* in = tw + G::TWB;
  uint64_t* tw_full = reinterpret_cast<uint64_t*>(in + TNS * TROW);
  uint64_t* tw_empty = tw_full + 1;
  uint64_t* in_full = tw_full + 2;
  uint64_t* in_empty = in_full + TNS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    S::mbar_init(tw_full, 1);
    S::mbar_init(tw_empty, 8);
    for (int s = 0; s < TNS; ++s) {
      S::mbar_init(&in_full[s], 1);
      S::mbar_init(&in_empty[s], 8);
    }
    S::fence_barrier_init();
  }
  __syncthreads();
  int t0, t1;
  block_rows(T, t0, t1);

  if (tid >= 256) {  // producer warpgroup: one thread issues every copy
    S::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 256) return;
    uint32_t n = 0;  // input rows loaded
    for (int grp = 0; grp < groups; ++grp) {
      S::mbar_wait(tw_empty, (grp & 1) ^ 1);
      S::mbar_expect_tx(tw_full, G::TWB);
      for (int dx = 0; dx < KT; ++dx)
        S::tma_load_2d(tw + dx * G::TSLAB, &tmap, tw_full, 0,
                       (grp * KT + dx) * G::N);
      for (int t = t0; t < t1;) {
        const Seg sg = segment(t, t1, H, strips, G::OWN);
        for (int r = max(sg.y0 - P, 0); r < min(sg.y1 + P, H); ++r, ++n) {
          const int slot = n % TNS;
          S::mbar_wait(&in_empty[slot], par(n, TNS) ^ 1);
          S::mbar_expect_tx(&in_full[slot], TROW);
          S::tma_load_4d(in + slot * TROW, &xmap, &in_full[slot], 0,
                         sg.x0 - P, r, sg.b);
        }
        t += sg.y1 - sg.y0;
      }
    }
    return;
  }

  // Warpgroup c takes pixels 64 c .. 64 c + 63 of the strip. Both read the
  // same ring row, so they issue their products in turns (named barriers 1
  // and 2), warpgroup 0 first: each one's epilogue then runs under the
  // other's products instead of beside it.
  S::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = tid >> 7;
  if (c == 1) S::named_arrive(1, 256);
  uint32_t n = 0;  // input rows used
  for (int grp = 0; grp < groups; ++grp) {
    float bq[1][4], kq[1][4];
    group_bias(bq, bt, co, grp);
    if constexpr (I8) group_bias(kq, ks, co, grp);
    S::mbar_wait(tw_full, grp & 1);
    for (int t = t0; t < t1;) {
      const Seg sg = segment(t, t1, H, strips, G::OWN);
      shift_add<KT, 1, Acc>(
          sg.y0, sg.y1, max(sg.y0 - P, 0), min(sg.y1 + P, H),
          [&](int, int, Acc (&D)[8 * KT]) {
            const int slot = n % TNS;
            S::mbar_wait(&in_full[slot], par(n, TNS));
            const unsigned char* row = in + slot * TROW;
            S::named_sync(1 + c, 256);  // this warpgroup's turn
            S::wgmma_fence();
            if constexpr (I8) {
              // A: the ring row started MW c + dx 64-byte pixels in.
#pragma unroll
              for (int dx = 0; dx < KT; ++dx)
#pragma unroll
                for (int s = 0; s < 2; ++s)
                  S::wgmma_i8_ss_kb<G::N>(
                      D, S::desc_k64(row + 64 * (MW * c + dx), s),
                      S::desc_k64(tw + dx * G::TSLAB, s), dx | s);
            } else {
#pragma unroll
              for (int dx = 0; dx < KT; ++dx)
#pragma unroll
                for (int s = 0; s < 4; ++s)
                  S::wgmma_ss_kb<G::N>(D, desc_row(row, MW * c + dx, s),
                                       desc_slab(tw + dx * G::TSLAB, s),
                                       dx | s);
            }
            S::wgmma_commit();
            S::named_arrive(2 - c, 256);  // the other's turn
            S::wgmma_wait<0>();
            release(&in_empty[slot], lane);
            S::fence_acc(D);
            ++n;
          },
          [&](int y, const Acc (&o)[1][8]) {
            store_row<1>(out, (size_t(sg.b) * H + y) * W, sg.x0 + MW * c,
                         G::OWN - MW * c, W, co, grp, o, bq, kq, relu,
                         out_f32);  // kq is read for int32 sums only
          });
      t += sg.y1 - sg.y0;
    }
    release(tw_empty, lane);
  }
  if (c == 0) S::named_sync(1, 256);  // warpgroup 1's last turn
}

template <int KT, bool I8 = false>
int launch_tail(const void* x, const void* w, const void* bias,
                const void* ks, void* out, int B, int H, int W, int co,
                int groups, int relu, int out_f32, int device, void* stream) {
  using G = TailGeo<KT, I8>;
  static_assert(G::BYTES <= MAX_SMEM, "tail_conv shared memory");
  CUtensorMap xm, tm;
  int e = I8 ? S::map_nhwc_i8(&xm, x, B, H, W, 64, TX)
             : S::map_nhwc(&xm, x, B, H, W, 64, TX, 1);
  if (e == 0)
    e = I8 ? S::map_matrix_i8(&tm, w, groups * KT * G::N, 64, G::N)
           : S::map_matrix(&tm, w, groups * KT * G::N, 64, G::N);
  if (e != 0) return e;
  auto kern = tail_conv_kernel<KT, I8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return int(err);
  const int strips = (W + G::OWN - 1) / G::OWN;
  const int T = B * strips * H;
  const int sms = S::sm_count(device);
  kern<<<T < sms ? T : sms, THREADS, G::BYTES,
         static_cast<cudaStream_t>(stream)>>>(
      xm, tm, static_cast<const float*>(bias), static_cast<const float*>(ks),
      out, H, W, co, groups, strips, T, relu, out_f32);
  return int(cudaGetLastError());
}

// ------------------------------------------------------- the split tail
constexpr int FOWN = MW - 2;     // outputs of a warpgroup's half-strip
constexpr int FX = MW + 8;       // pixels of a mid row
constexpr int FROW = FX * 128;
constexpr int KM = 5;            // the mid conv's frame
constexpr int MN = KM * NG;      // mid GEMM width a group: (dy, channel)
constexpr int FN = 3 * NG;       // finish GEMM width a group: (dy, output)

template <int CMP, int COP>
struct FinGeo {
  // Mid channel groups, also the k16 steps of the mid's hi half; finish
  // output groups.
  static constexpr int GM = CMP / NG, GF = COP / NG;
  static constexpr int MSLAB = MN * 128;
  static constexpr int FSLAB = FN * 128;
  static constexpr int MWB = GM * KM * MSLAB;
  static constexpr int FWB = GF * 3 * FSLAB;
  // Input ring rows: 6, or what x3's weights leave room for (4).
  static constexpr int fixed = 1024 + MWB + FWB + 2 * FROW + 32 * 8;
  static constexpr int NS =
      (MAX_SMEM - fixed) / TROW < 6 ? (MAX_SMEM - fixed) / TROW : 6;
  static constexpr int BARS = 1 + 2 * NS;
  static constexpr int BYTES = 1024 + MWB + FWB + NS * TROW + 2 * FROW +
                               BARS * 8;
};

// xmap: x as for the tail, box (64, 136, 1, 1); wmap: the mid slabs
// (GM x 5 x 80, 64) = k_mid[grp][dx][dy][cm][c], box (64, 80); fmap: the
// finish slabs (GF x 3 x 48, 64) = [grp][dx][dy][o][c], the hi weights at
// channels 0..cmp-1 and the lo weights at cmp..2 cmp-1, box (64, 48). bm
// (cm) and bfin (co) f32; out (B, H, W, co) bf16 or f32. T = B x strips x H
// strip-rows.
template <int CMP, int COP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
tail_finish_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap fmap,
                   const float* __restrict__ bm,
                   const float* __restrict__ bfin, void* __restrict__ out,
                   int H, int W, int cm, int co, int strips, int T,
                   int out_f32) {
  using G = FinGeo<CMP, COP>;
  constexpr int NS = G::NS, GM = G::GM, GF = G::GF;
  constexpr int OWN = 2 * FOWN;  // outputs a strip owns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* mw = align1024(smem_raw);
  unsigned char* fw = mw + G::MWB;
  unsigned char* in = fw + G::FWB;
  unsigned char* mid = in + NS * TROW;  // one mid row a warpgroup
  uint64_t* w_full = reinterpret_cast<uint64_t*>(mid + 2 * FROW);
  uint64_t* in_full = w_full + 1;
  uint64_t* in_empty = in_full + NS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    S::mbar_init(w_full, 1);
    for (int s = 0; s < NS; ++s) {
      S::mbar_init(&in_full[s], 1);
      S::mbar_init(&in_empty[s], 8);
    }
    S::fence_barrier_init();
  }
  // Pixels MW.. of the mid rows feed only the finish's last two M rows,
  // which no warpgroup stores; zero them once so they hold numbers.
  constexpr int PAD16 = (FX - MW) * 8;
  for (int i = tid; i < 2 * PAD16; i += THREADS)
    *reinterpret_cast<uint4*>(mid + (i / PAD16) * FROW + MW * 128 +
                              (i % PAD16) * 16) = make_uint4(0, 0, 0, 0);
  S::fence_async_smem();
  __syncthreads();
  int t0, t1;
  block_rows(T, t0, t1);

  if (tid >= 256) {  // producer warpgroup
    S::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 256) return;
    S::mbar_expect_tx(w_full, G::MWB + G::FWB);
    for (int i = 0; i < GM * KM; ++i)
      S::tma_load_2d(mw + i * G::MSLAB, &wmap, w_full, 0, i * MN);
    for (int i = 0; i < GF * 3; ++i)
      S::tma_load_2d(fw + i * G::FSLAB, &fmap, w_full, 0, i * FN);
    uint32_t n = 0;
    for (int t = t0; t < t1;) {
      const Seg sg = segment(t, t1, H, strips, OWN);
      // Mid rows [y0 - 1, y1 + 1) read input rows y0 - 3 .. y1 + 2.
      for (int r = max(sg.y0 - 3, 0); r < min(sg.y1 + 3, H); ++r, ++n) {
        const int slot = n % NS;
        S::mbar_wait(&in_empty[slot], par(n, NS) ^ 1);
        S::mbar_expect_tx(&in_full[slot], TROW);
        S::tma_load_4d(in + slot * TROW, &xmap, &in_full[slot], 0, sg.x0 - 3,
                       r, sg.b);
      }
      t += sg.y1 - sg.y0;
    }
    return;
  }

  // Warpgroup c: the half-strip of mid pixels q (column x0 - 1 + 62 c + q)
  // and outputs p < 62 (column x0 + 62 c + p). The two warpgroups share the
  // input rows and issue their mid products in turns, as the tail's.
  S::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = tid >> 7;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  if (c == 1) S::named_arrive(1, 256);
  float bqm[GM][4], bqf[GF][4];
  group_bias(bqm, bm, cm, 0);
  group_bias(bqf, bfin, co, 0);
  unsigned char* mrow = mid + c * FROW;
  S::mbar_wait(w_full, 0);
  uint32_t n = 0;  // input rows used
  for (int t = t0; t < t1;) {
    const Seg sg = segment(t, t1, H, strips, OWN);
    const int xm = sg.x0 - 1 + FOWN * c;  // column of mid pixel 0
    const int ma = max(sg.y0 - 1, 0), mb = min(sg.y1 + 1, H);
    // The finish: a 3x3 shift-add over mid rows y0 - 1 .. y1, one step as
    // each mid row is done (rows outside the image: the zero pad).
    ShiftAdd<3, GF> fin;
    fin.reset();
    auto fin_products = [&](int q, float (&D)[8 * 3]) {
      S::wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const unsigned char* wq = fw + (q * 3 + dx) * G::FSLAB;
#pragma unroll
        for (int s = 0; s < GM; ++s) {
          S::wgmma_ss_kb<FN>(D, desc_row(mrow, dx, s), desc_slab(wq, s),
                             dx | s);
          if (MODE >= 1)  // hi.lo: the weights' remainder
            S::wgmma_ss_kb<FN>(D, desc_row(mrow, dx, s),
                               desc_slab(wq, GM + s), 1);
          if (MODE == 2)  // lo.hi: the mid's remainder
            S::wgmma_ss_kb<FN>(D, desc_row(mrow, dx, GM + s),
                               desc_slab(wq, s), 1);
        }
      }
      S::wgmma_commit();
      S::wgmma_wait<0>();
      S::fence_acc(D);
    };
    auto fin_emit = [&](int y, const float (&o)[GF][8]) {
      store_row<GF>(out, (size_t(sg.b) * H + y) * W, sg.x0 + FOWN * c, FOWN,
                    W, co, 0, o, bqf, 0, out_f32);
    };
    if (sg.y0 - 1 < ma)  // mid row -1
      fin.step(false, false, 0, fin_products, fin_emit);
    shift_add<KM, GM>(
        ma, mb, max(ma - 2, 0), min(mb + 2, H),
        [&](int, int q, float (&D)[8 * KM]) {
          // The row is waited for before the first group's products and
          // released after the last's.
          const int slot = n % NS;
          if (q == 0) S::mbar_wait(&in_full[slot], par(n, NS));
          const unsigned char* row = in + slot * TROW;
          S::named_sync(1 + c, 256);  // this warpgroup's turn
          S::wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < KM; ++dx)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              S::wgmma_ss_kb<MN>(D, desc_row(row, FOWN * c + dx, s),
                                 desc_slab(mw + (q * KM + dx) * G::MSLAB, s),
                                 dx | s);
          S::wgmma_commit();
          S::named_arrive(2 - c, 256);  // the other's turn
          S::wgmma_wait<0>();
          S::fence_acc(D);
          if (q == GM - 1) {
            release(&in_empty[slot], lane);
            ++n;
          }
        },
        [&](int j, const float (&o)[GM][8]) {
          // Mid row j: + bias, zero outside the image's columns, one
          // rounding (and the remainder as lo), into this warpgroup's mid
          // row; then the finish's step on it.
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 16 * warp + g + 8 * i;
            const int x = xm + r;
            const bool inside = x >= 0 && x < W;
#pragma unroll
            for (int q = 0; q < GM; ++q)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const float v0 =
                    inside ? o[q][4 * jj + 2 * i] + bqm[q][2 * jj] : 0.f;
                const float v1 =
                    inside ? o[q][4 * jj + 2 * i + 1] + bqm[q][2 * jj + 1]
                           : 0.f;
                const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
                *reinterpret_cast<__nv_bfloat162*>(
                    mrow + sw128(r, 2 * q + jj) + 4 * t4) = hi;
                if (MODE == 2)
                  *reinterpret_cast<uint32_t*>(
                      mrow + sw128(r, 2 * (GM + q) + jj) + 4 * t4) =
                      pack(v0 - __low2float(hi), v1 - __high2float(hi));
              }
          }
          S::fence_async_smem();  // the finish's wgmma reads the row
          S::named_sync(3 + c, 128);
          fin.step(true, j - 1 >= sg.y0, j - 1, fin_products, fin_emit);
        });
    if (mb < sg.y1 + 1)  // mid row H
      fin.step(false, true, mb - 1, fin_products, fin_emit);
    t += sg.y1 - sg.y0;
  }
  if (c == 0) S::named_sync(1, 256);  // warpgroup 1's last turn
}

template <int CMP, int COP, int MODE>
int launch_finish(const void* x, const void* wm, const void* bm,
                  const void* wf, const void* bfin, void* out, int B, int H,
                  int W, int cm, int co, int out_f32, int device,
                  void* stream) {
  using G = FinGeo<CMP, COP>;
  static_assert(G::NS >= 2 && G::BYTES <= MAX_SMEM,
                "tail_finish shared memory");
  CUtensorMap xm, wmm, fm;
  int e = S::map_nhwc(&xm, x, B, H, W, 64, TX, 1);
  if (e == 0) e = S::map_matrix(&wmm, wm, G::GM * KM * MN, 64, MN);
  if (e == 0) e = S::map_matrix(&fm, wf, G::GF * 3 * FN, 64, FN);
  if (e != 0) return e;
  auto kern = tail_finish_kernel<CMP, COP, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return int(err);
  const int strips = (W + 2 * FOWN - 1) / (2 * FOWN);
  const int T = B * strips * H;
  const int sms = S::sm_count(device);
  kern<<<T < sms ? T : sms, THREADS, G::BYTES,
         static_cast<cudaStream_t>(stream)>>>(
      xm, wmm, fm, static_cast<const float*>(bm),
      static_cast<const float*>(bfin), out, H, W, cm, co, strips, T, out_f32);
  return int(cudaGetLastError());
}

template <int CMP, int COP>
int finish_mode(const void* x, const void* wm, const void* bm,
                const void* wf, const void* bfin, void* out, int B, int H,
                int W, int cm, int co, int mode, int out_f32, int device,
                void* stream) {
  switch (mode) {
    case 0:
      return launch_finish<CMP, COP, 0>(x, wm, bm, wf, bfin, out, B, H, W, cm,
                                        co, out_f32, device, stream);
    case 1:
      return launch_finish<CMP, COP, 1>(x, wm, bm, wf, bfin, out, B, H, W, cm,
                                        co, out_f32, device, stream);
    case 2:
      return launch_finish<CMP, COP, 2>(x, wm, bm, wf, bfin, out, B, H, W, cm,
                                        co, out_f32, device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (B,H,W,64) bf16; w (npad / 16 x ks x ks x 16, 64) bf16 = the kernel as
// rows (group, dx, dy, output) of 64 input channels, outputs past co zero
// (kernels/stream.py tail_slabs); bias (co) f32; out (B,H,W,co) bf16 or f32
// (out_f32). ks in {5, 7}, npad in {16, 32, 48}, co <= npad. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tux_tail_conv(const void* x, const void* w, const void* bias,
                             void* out, int B, int H, int W, int ks, int co,
                             int npad, int relu, int out_f32, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (co > npad || co < 1 || npad % NG || npad < NG || npad > 3 * NG)
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int groups = npad / NG;
  switch (ks) {
    case 5:
      return launch_tail<5>(x, w, bias, nullptr, out, B, H, W, co, groups,
                            relu, out_f32, device, stream);
    case 7:
      return launch_tail<7>(x, w, bias, nullptr, out, B, H, W, co, groups,
                            relu, out_f32, device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The int8 tail conv: x (B,H,W,64) int8; w (npad / 16 x ksz x ksz x 16, 64)
// int8 = the folded kernel as tux_tail_conv's rows (kernels/stream.py
// tail_slabs with dtype int8); ks, bias (co) f32; out (B,H,W,co) bf16 or
// f32. out = act(float(acc) x ks + bias), acc the exact int32 sum. ksz in
// {5, 7}, npad in {16, 32, 48}, co <= npad. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int tux_tail_conv_int8(const void* x, const void* w,
                                  const void* ks, const void* bias, void* out,
                                  int B, int H, int W, int ksz, int co,
                                  int npad, int relu, int out_f32, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (co > npad || co < 1 || npad % NG || npad < NG || npad > 3 * NG)
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int groups = npad / NG;
  switch (ksz) {
    case 5:
      return launch_tail<5, true>(x, w, bias, ks, out, B, H, W, co, groups,
                                  relu, out_f32, device, stream);
    case 7:
      return launch_tail<7, true>(x, w, bias, ks, out, B, H, W, co, groups,
                                  relu, out_f32, device, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// x (B,H,W,64) bf16; wm (cmp / 16 x 5 x 5 x 16, 64) bf16 = the 5x5 mid
// kernel (a 3x3 centred, zero frame) as tail_slabs rows; bm (cm) f32; wf
// (cop / 16 x 3 x 3 x 16, 64) bf16 = the finish kernel as rows (group, dx,
// dy, output) of 64 mid channels, its bf16 hi half at channels 0..cm-1 and
// its lo half at cmp..cmp+cm-1 (kernels/stream.py finish_slabs); bfin (co)
// f32; out (B,H,W,co) bf16 or f32. (cmp, cop) one of (16, 16), (32, 32), (16, 48); mode 0 off, 1 wf, 2
// full. Returns the cudaError_t of the launch (0 on success).
extern "C" int tux_tail_finish(const void* x, const void* wm, const void* bm,
                               const void* wf, const void* bfin, void* out,
                               int B, int H, int W, int cm, int cmp, int co,
                               int cop, int mode, int out_f32, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (mode < 0 || mode > 2 || cm > cmp || co > cop || cm < 1 || co < 1)
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  if (cmp == 16 && cop == 16)
    return finish_mode<16, 16>(x, wm, bm, wf, bfin, out, B, H, W, cm, co,
                               mode, out_f32, device, stream);
  if (cmp == 32 && cop == 32)
    return finish_mode<32, 32>(x, wm, bm, wf, bfin, out, B, H, W, cm, co,
                               mode, out_f32, device, stream);
  if (cmp == 16 && cop == 48)
    return finish_mode<16, 48>(x, wm, bm, wf, bfin, out, B, H, W, cm, co,
                               mode, out_f32, device, stream);
  return int(cudaErrorInvalidValue);
}
