// Global multi-head attention core for Hopper (sm_90a): softmax(q k^T / 4) v
// over all N tokens, heads packed in the channels, 16 channels a head.
//
// Replaces transformerupscaler_tpu/ops/pallas/gmha.py:60 global_mha (body
// _gmha_kernel, :39). The qkv and output products stay outside, as there.
//
// The TPU body holds the whole (heads x 64, N) f32 score strip of a query
// block in VMEM, normalises it, rounds p to bf16 and only then multiplies by
// v. One head's strip for 64 queries is 0.9 MB at N = 3600 and does not fit
// an SM, so this kernel makes two passes over the keys and keeps the TPU's
// rounding point:
//   pass 1: s = q k^T in f32, running row max m and row sum
//           l = sum 2^((s - m) / 4 log2 e), rescaled when m grows;
//   pass 2: s again, p = bf16(2^((s - m) / 4 log2 e - log2 l)), out += p v
//           in f32; out rounded once.
// The reference scales q by hd^-0.5 = 0.25 in bf16 before the kernel, which
// is exact, so the scale folds into the exponent, and so does 1 / l: one
// FFMA a score (s times 0.25 log2 e minus a per-row constant) and one
// ex2.approx. Keys from N on are zeros by TMA and masked to -inf in the
// last tile only.
//
// What bounds it on the H100 at N = 3600, C = 128, 8 heads: 103.7 M scores.
// Their products are 6.6 G operations (0.0067 ms at 989 TF/s) and q, k, v and
// out 3.7 MB (0.0011 ms), but every score needs an exponential, and the
// special-function unit (SFU) does 16 a clock on each SM: 0.025 ms at 1.98
// GHz. The two passes need two a score, a floor of ~0.05 ms.
//
// Design. A block is two warpgroups, 64 query rows each (128 rows of one
// head); two blocks an SM, 16 warps, so ptxas may give each thread 128
// registers (a sub-partition holds 4 warps; a ninth, producer warp a block
// would cap them at 96). The head's 128-key tiles (k in pass 1, k and v in
// pass 2) stream by TMA through a 4-stage mbarrier ring; a row of a head is
// 32 bytes, so tiles use the 32-byte swizzle (sm90.cuh). Both warpgroups read
// every tile, which halves the L2 reads of one warpgroup a block. A stage is
// refilled two steps after its use, by one thread of a warp that takes its
// turn (the copies' instructions spread over the sub-partitions). Per tile a
// warpgroup issues one wgmma m64n128k16 (S = Q K^T, K as a K-major B) and
// keeps each thread's own running max and sum (the quad is combined once,
// at the end of pass 1); in pass 2 the f32 accumulator turns straight into
// the A fragments of P, and P.V runs on mma.sync m16n8k16 with V's B
// fragments from ldmatrix.trans. The last tile of each pass is a separate
// copy, the only one that masks. Work units (128 query rows, head, batch)
// walk a persistent grid of up to two blocks an SM. Each tile costs a fixed
// set of instructions (waits, copies, descriptors), which the 128-key tiles
// spread over twice the scores of 64-key ones; the SFU stays about two
// thirds busy (PERF.md, kernel_ablation.py).
#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace S = tux::sm90;
using bf16 = __nv_bfloat16;

constexpr int HD = 16;              // head width: one k16 step
constexpr int QT = 64;              // query rows of a warpgroup
constexpr int KT = 128;             // keys of a tile
constexpr int WG = 2;               // warpgroups of a block
constexpr int THREADS = WG * 128;
constexpr unsigned STAGES = 4;      // a power of two
constexpr int LAG = 2;              // steps between a stage's use and refill
constexpr int Q_TILE = QT * HD * 2;
constexpr int TILE = KT * HD * 2;   // bytes of a k or v tile
// exp((s - m) / 4) = 2^((s - m) C_LOG2) for raw scores s = q . k.
constexpr float C_LOG2 = 0.25f * 1.4426950408889634f;
constexpr int SMEM = 1024 + WG * Q_TILE + 2 * STAGES * TILE +
                     (2 * STAGES + 2) * 8;
static_assert(SMEM <= 48 * 1024, "dynamic shared memory without opt-in");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One arrive of the warp on `bar`, without a branch.
__device__ __forceinline__ void release(uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nelect.sync _|p, 0xffffffff;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(S::smem(bar))
      : "memory");
}

// Unit u: batch b, head h, first query row r0 of the block.
__device__ __forceinline__ void unit(int u, int pairs, int heads, int& b,
                                     int& h, int& r0) {
  r0 = (u % pairs) * WG * QT;
  h = (u / pairs) % heads;
  b = u / (pairs * heads);
}

// Keys from N on (zeros from TMA) out of the softmax. s[4j + 2i + e] is row
// g + 8i of the warp's 16, key 8j + 2t + e of the tile.
__device__ __forceinline__ void mask_keys(float (&s)[64], int key0, int n,
                                          int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * j + 2 * t + (e & 1) >= n) s[4 * j + e] = -INFINITY;
}

// qmap: (B, N, C) bf16 as (C, N, B), box (16, 64, 1); kmap, vmap: likewise,
// box (16, 128, 1); the 32-byte swizzle. out: (B, N, C) bf16, contiguous.
__global__ void __launch_bounds__(THREADS, 2)
global_mha_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  bf16* __restrict__ out, int n, int c, int heads, int pairs,
                  int n_units) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + WG * Q_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * STAGES * TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_empty = q_full + 1;
  const int tid = threadIdx.x;
  const int tiles = (n + KT - 1) / KT;
  const int steps = 2 * tiles;  // pass 1's tiles, then pass 2's
  if (tid == 0) {
    for (unsigned s = 0; s < STAGES; ++s) {
      S::mbar_init(&full[s], 1);
      S::mbar_init(&empty[s], WG * 4);
    }
    S::mbar_init(q_full, 1);
    S::mbar_init(q_empty, WG * 4);
    S::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int wid = tid >> 5;
  const int warp = wid & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // ldmatrix.x4.trans row of this lane in a v tile: key (lane & 7) + 8 ((lane
  // >> 3) & 1), 16-byte chunk lane >> 4 (channels 0-7, 8-15), swizzled.
  const int vkey = (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t v_lane = S::smem(ring) + TILE + vkey * 32 +
                          (((lane >> 4) ^ ((vkey >> 2) & 1)) << 4);
  const uint64_t k_desc = S::desc_k32(ring);
  unsigned base = 0;  // ring steps of the block's earlier units
  int k = 0;          // the block's earlier units
  for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++k) {
    int b, h, r0;
    unit(u, pairs, heads, b, h, r0);
    // Step j of the unit reads ring stage (base + j) % STAGES in phase
    // ((base + j) / STAGES) % 2; it is loaded once both warpgroups have
    // released the stage's previous step.
    auto load = [&](int j) {
      if (j >= steps) return;
      const unsigned q = base + j, st = q % STAGES;
      S::mbar_wait(&empty[st], ((q / STAGES) & 1) ^ 1);
      unsigned char* dst = ring + st * 2 * TILE;
      const int i = j < tiles ? j : j - tiles;
      S::mbar_expect_tx(&full[st], j < tiles ? TILE : 2 * TILE);
      S::tma_load_3d(dst, &kmap, &full[st], HD * h, KT * i, b);
      if (j >= tiles)
        S::tma_load_3d(dst + TILE, &vmap, &full[st], HD * h, KT * i, b);
    };
    if (tid == 0) {
      S::mbar_wait(q_empty, (k & 1) ^ 1);
      S::mbar_expect_tx(q_full, WG * Q_TILE);
      for (int w = 0; w < WG; ++w)
        S::tma_load_3d(qs + w * Q_TILE, &qmap, q_full, HD * h, r0 + QT * w,
                       b);
      for (unsigned j = 0; j < STAGES; ++j) load(j);
    }
    S::mbar_wait(q_full, k & 1);
    const uint64_t qd = S::desc_k32(qs + wg * Q_TILE);

    // Step j's scores: wait for its tile, refill the stage used LAG steps
    // ago (warp j % 8's turn), one wgmma.
    float s[64];
    auto scores = [&](int j) {
      const unsigned q = base + j, st = q % STAGES;
      if (j >= LAG && wid == j % (WG * 4)) {
        if (lane == 0) load(j - LAG + STAGES);
        __syncwarp();
      }
      S::mbar_wait(&full[st], (q / STAGES) & 1);
      S::wgmma_fence();
      S::wgmma_ss_n128(s, qd, k_desc + st * (2 * TILE / 16), 0);
      S::wgmma_commit();
      S::wgmma_wait<0>();
      S::fence_acc(s);
      return st;
    };

    // The last tile of each pass is peeled: its keys from N on are masked
    // (a runtime test in the loop would cost every tile ~140 predicated
    // instructions).
    using No = std::integral_constant<bool, false>;
    using Yes = std::integral_constant<bool, true>;

    // Pass 1: each thread's own running max (from -1e30, so a thread whose
    // keys are all masked stays finite) and its sum relative to it.
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
    auto step1 = [&](int j, auto last) {
      release(&empty[scores(j)]);
      if constexpr (decltype(last)::value) mask_keys(s, KT * j, n, t);
      float t0 = m0, t1 = m1;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        t0 = fmaxf(t0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        t1 = fmaxf(t1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
      l0 *= ex2((m0 - t0) * C_LOG2);
      l1 *= ex2((m1 - t1) * C_LOG2);
      m0 = t0;
      m1 = t1;
      const float b0 = m0 * C_LOG2, b1 = m1 * C_LOG2;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        l0 += ex2(fmaf(s[4 * jj], C_LOG2, -b0)) +
              ex2(fmaf(s[4 * jj + 1], C_LOG2, -b0));
        l1 += ex2(fmaf(s[4 * jj + 2], C_LOG2, -b1)) +
              ex2(fmaf(s[4 * jj + 3], C_LOG2, -b1));
      }
    };
    for (int j = 0; j < tiles - 1; ++j) step1(j, No());
    step1(tiles - 1, Yes());
    // The quad's rows: one max, the sums rescaled to it; then p =
    // 2^(s C_LOG2 - bm) with bm = m C_LOG2 + log2 l.
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float x0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      const float x1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      l0 *= ex2((m0 - x0) * C_LOG2);
      l1 *= ex2((m1 - x1) * C_LOG2);
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      m0 = x0;
      m1 = x1;
    }
    const float bm[2] = {fmaf(m0, C_LOG2, log2f(l0)),
                         fmaf(m1, C_LOG2, log2f(l1))};

    // Pass 2: p = bf16(2^(s C_LOG2 - bm)), out += p v.
    float cx[2][4] = {};  // channels 0-7 and 8-15 (mma.sync C layout)
    auto step2 = [&](int j, auto last) {
      const unsigned st = scores(j);
      if constexpr (decltype(last)::value)
        mask_keys(s, KT * (j - tiles), n, t);
      const uint32_t vt = v_lane + st * (2 * TILE);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        // Keys 16 kk .. 16 kk + 15: the accumulator's pairs in order are
        // mma.m16n8k16's A fragment of rows g, g + 8 (sm90.cuh).
        uint32_t a[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int e = 8 * kk + 2 * f;
          a[f] = pack(ex2(fmaf(s[e], C_LOG2, -bm[f & 1])),
                      ex2(fmaf(s[e + 1], C_LOG2, -bm[f & 1])));
        }
        uint32_t bv[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3},"
            " [%4];\n"
            : "=r"(bv[0]), "=r"(bv[1]), "=r"(bv[2]), "=r"(bv[3])
            : "r"(vt + 512 * kk));
        tux::mma_bf16(cx[0], a[0], a[1], a[2], a[3], bv[0], bv[1]);
        tux::mma_bf16(cx[1], a[0], a[1], a[2], a[3], bv[2], bv[3]);
      }
      release(&empty[st]);
    };
    for (int j = tiles; j < steps - 1; ++j) step2(j, No());
    step2(steps - 1, Yes());
    release(q_empty);
    base += steps;

    // cx[j][2i + e]: row 16 warp + g + 8i, channel 8j + 2t + e.
    const int row = r0 + QT * wg + 16 * warp + g;
    bf16* ob = out + size_t(b) * n * c + size_t(h) * HD + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row + 8 * i >= n) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        *reinterpret_cast<uint32_t*>(ob + size_t(row + 8 * i) * c + 8 * jj) =
            pack(cx[jj][2 * i], cx[jj][2 * i + 1]);
    }
  }
}

// A (B, N, C) bf16 view with unit channel stride as (C, N, B), box (16,
// rows, 1). Strides in elements.
int map_rows(CUtensorMap* m, const void* p, int batch, int n, int c,
             long long batch_stride, long long row_stride, int rows) {
  const uint64_t dims[3] = {uint64_t(c), uint64_t(n), uint64_t(batch)};
  const uint64_t strides[2] = {uint64_t(row_stride) * 2,
                               uint64_t(batch_stride) * 2};
  const uint32_t box[3] = {HD, uint32_t(rows), 1};
  return S::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). q, k, v share the
// batch and row strides (elements, multiples of 8); channels contiguous; C =
// 16 heads.
extern "C" int tux_global_mha(const void* q, const void* k, const void* v,
                              void* out, int batch, int n, int c, int heads,
                              long long batch_stride, long long row_stride,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (c != HD * heads || batch_stride % 8 || row_stride % 8)
    return int(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return 0;
  CUtensorMap qm, km, vm;
  int e = map_rows(&qm, q, batch, n, c, batch_stride, row_stride, QT);
  if (e == 0)
    e = map_rows(&km, k, batch, n, c, batch_stride, row_stride, KT);
  if (e == 0)
    e = map_rows(&vm, v, batch, n, c, batch_stride, row_stride, KT);
  if (e != 0) return e;
  const int pairs = ((n + QT - 1) / QT + WG - 1) / WG;
  const int n_units = batch * heads * pairs;
  const int slots = 2 * S::sm_count(device);
  const int grid = n_units < slots ? n_units : slots;
  global_mha_kernel<<<grid, THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<bf16*>(out), n, c, heads, pairs, n_units);
  return int(cudaGetLastError());
}
