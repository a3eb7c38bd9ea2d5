// 8x8 patch embed and unembed + skip as bf16 GEMMs on NHWC tensors, for
// Hopper (sm_90a): a TMA-fed shared-memory ring, wgmma, and a TMA epilogue.
//
// Replaces two TPU kernels of transformerupscaler_tpu/ops/pallas/stream.py:
//   embed_stream           (:325) -> tux_embed
//       tokens[m, :] = patch(m) @ W + bias      M = tokens, K = 8*8*64, N = D
//   unembed_combine_stream (:239) -> tux_unembed_combine
//       out[patch(m)] = act(tokens[m, :] @ W + bias + skip[patch(m)])
//                                               M = tokens, K = D, N = 8*8*64
// and the archived functions of ops/pallas/patch_kernels.py that run on the
// same two kernels: fused_patch_embed (:50; the caller rounds the bias to
// bf16) and fused_patch_unembed_add (:106; the epilogue option round_steps,
// which rounds where that kernel rounds, patch_kernels.py:99-103, 126: y =
// bf16(acc), then bf16(y + bias) with a bf16 bias, then bf16(. + skip)).
// bf16 operands, f32 accumulation, f32 bias (and skip) in the epilogue, one
// rounding to bf16. The int8 options of the int8 tails scope:
//   embed in_scale (stream.py:317-321): feat is int8, quantized per channel;
//       each value is dequantized to bf16(f32(q) * s[c]) before its product.
//   unembed feat_scale (stream.py:229-236): the skip is int8 and adds as
//       f32(q) * s[c], in the order (acc + bias) + skip.
//
// Bound on the H100 at 720x1280, D = 192 (3.35 TB/s, 989 TF/s bf16): each
// does 22.6 GFLOP (23 us); the embed moves 125 MB (feat 118, W 1.6, tokens
// 5.5; 37 us), the unembed 243 MB (tokens, W, skip 118 in, out 118; 73 us):
// both bytes-bound, so the design reads every byte of the map once and keeps
// copies in flight while the tensor cores work.
//
// The layout they rest on: for consecutive tokens tx of one (b, ty) row and
// a fixed patch row dy, the patch rows are one run of the NHWC map, so the
// map (B, 8 Ht, 8 Wt, 64) is the 4-D tensor (B Ht, 8, Wt, 512) and a TMA box
// (64 channels, 32 tokens, 1, 1) of it is 32 token rows of one pixel (dy,
// dx) of the patch: an A tile of the embed, a skip or output tile of the
// unembed. TMA zero-fills boxes past Wt (or past the last row) on loads and
// clips them on stores, which handles every ragged edge. A block's tile is
// 2 x 2 such runs ("segments": the tokens of all rows cut into runs of 32),
// 128 tokens, two consumer warpgroups of 64 rows each; one producer warp
// issues the TMA copies. Layouts and swizzles: sm90.cuh.
//
// Embed (tux_embed): a persistent grid walks units of 128 tokens x 192
// output columns (D > 192: more column groups; columns past D compute on
// zero-filled weights and are not stored): 113 units at 720p, one wave. The
// K loop runs over the 64 pixels of the patch; each ring stage holds the
// four segments' 64-channel A boxes (16 KB bf16, 8 KB int8) and the (64 k x
// 192) rows of W in its stored (4096, D) layout as three MN-major 64-column
// boxes (24 KB): four stages of 40 KB. Each warpgroup issues wgmma
// m64n192k16 (96 f32 registers a thread), one stage's group in flight while
// the next is issued; the whole D of a tile is one unit, so the map is read
// once. Each unit starts its K loop at its own pixel (u mod 64): when every
// block read the same pixel at once, all requests shared address bits 7-9
// and the map was read at 2.1 TB/s (patch_ablation.py). Units are counted
// per frame (a frame's last unit holds zero-filled segments rather than the
// next frame's first ones) and the start pixel is the unit's index in its
// frame, so a frame's tokens sum in the same order whatever its batch: a
// batch of 3 equals three batches of 1 bit for bit. int8 A comes by TMA
// at half the bytes and is dequantized into wgmma's register A fragment.
// Epilogue: + bias, one rounding, staged swizzled in shared memory (2 x 24
// KB) and TMA-stored, clipped at Wt.
//
// Unembed (tux_unembed_combine): a persistent block keeps its 128-token
// tile resident (D x 128 bf16, 48 KB at D = 192) and walks the 64 output
// pixels of the patch; each ring stage holds one pixel's (D x 64) slab of W
// in its stored (D, 4096) layout (MN-major, 8 KB a 64-row chunk of K) and
// the same pixel's skip boxes of the four segments (16 KB bf16, 8 KB int8):
// three stages of 40 KB (two when D > 192), the producer up to three slabs
// ahead. wgmma m64n64k16 over K in 64-row chunks, a compile-time count
// (KC = ceil(D / 64), rows past D zero-filled), so the products unroll
// and ptxas inserts no waits between them; the f32 epilogue adds bias and
// skip, rounds once into a swizzled staging buffer and TMA-stores it in full
// 128-byte lines, double-buffered, with one barrier a slab (the previous
// slab's store is waited for, cp.async.bulk.wait_group.read, before it).
// W (1.5 MB) is read from L2 once per 128-token tile, 113 tiles at 720p.
// D <= 256: two warpgroups; 256 < D <= 512: one (64-token tiles).
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

namespace S = tux::sm90;

constexpr int C = 64;              // feature channels
constexpr int PS = 8;              // patch size
constexpr int SEG = 32;            // tokens of one TMA box: a run of one row
constexpr int TILE = 8192;         // 64 rows x 128 B: one wgmma operand tile
constexpr int MAX_SMEM = 232448;   // per block on the H100

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Segment s: token row bt = b * Ht + ty and first token tx0. Past the last
// segment bt is past the last row: its loads zero-fill.
__device__ __forceinline__ void segment(int s, int seg_row, int& bt,
                                        int& tx0) {
  bt = s / seg_row;
  tx0 = (s - bt * seg_row) * SEG;
}

// Byte offset of (row r, 16-byte chunk j) in a 128-byte-row tile written
// with the 128B swizzle, and of (row r, byte b) in a 64-byte-row one with the
// 64B swizzle.
__device__ __forceinline__ int sw128(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}
__device__ __forceinline__ int sw64(int r, int b) {
  return r * 64 + (((b >> 4) ^ ((r >> 1) & 3)) << 4) + (b & 15);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) S::mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- embed
constexpr int E_WG = 2;                 // consumer warpgroups
constexpr int E_THREADS = E_WG * 128 + 32;
constexpr int E_NG = 192;               // output columns of a unit
constexpr int E_NC = E_NG / 64;
constexpr int E_STAGES = 4;

template <bool I8>
struct EmbedSmem {
  static constexpr int A_BOX = SEG * C * (I8 ? 1 : 2);
  static constexpr int A_BYTES = 2 * E_WG * A_BOX;
  static constexpr int STAGE = A_BYTES + E_NC * TILE;
  static constexpr int OUT = E_WG * E_NC * TILE;
  static constexpr int BYTES = 1024 + E_STAGES * STAGE + OUT +
                               2 * E_STAGES * 8;
};

// fmap: feat as (B Ht, 8, Wt, 512), box (64, 32, 1, 1), bf16 with the 128B
// swizzle or int8 with the 64B one; wmap: W (4096, D), box (64, 64); tmap:
// tokens (B Ht, Wt, D), box (64, 32, 1). bias (D) f32; in_scale (64) f32
// when I8.
template <bool I8>
__global__ void __launch_bounds__(E_THREADS, 1)
embed_kernel(const __grid_constant__ CUtensorMap fmap,
             const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap tmap,
             const float* __restrict__ bias,
             const float* __restrict__ in_scale, int D, int seg_row,
             int frame_seg, int frame_tiles, int n_groups, int n_units,
             int n_rows) {
  using L = EmbedSmem<I8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  unsigned char* out = stages + E_STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + L::OUT);
  uint64_t* empty = full + E_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < E_STAGES; ++s) {
      S::mbar_init(&full[s], 1);
      S::mbar_init(&empty[s], E_WG * 4);
    }
    S::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= E_WG * 128) {  // producer warp: one thread issues every copy
    if (tid != E_WG * 128) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int n0 = (u % n_groups) * E_NG;
      const int b = u / (frame_tiles * n_groups);
      const int lu = u - b * frame_tiles * n_groups;  // the unit in its frame
      const int s0 = (lu / n_groups) * 2 * E_WG;
      int bt[2 * E_WG], tx0[2 * E_WG];
      for (int sg = 0; sg < 2 * E_WG; ++sg) {
        if (s0 + sg < frame_seg) {
          segment(b * frame_seg + s0 + sg, seg_row, bt[sg], tx0[sg]);
        } else {  // past the frame's last segment: zero-filled loads
          bt[sg] = n_rows;
          tx0[sg] = 0;
        }
      }
      for (int i = 0; i < PS * PS; ++i) {
        const int q = (i + lu) % (PS * PS);  // pixel (dy, dx) = (q / 8, q % 8)
        S::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = stages + stage * L::STAGE;
        S::mbar_expect_tx(&full[stage], L::STAGE);
        for (int sg = 0; sg < 2 * E_WG; ++sg)
          S::tma_load_4d(st + sg * L::A_BOX, &fmap, &full[stage], (q % PS) * C,
                         tx0[sg], q / PS, bt[sg]);
        for (int cc = 0; cc < E_NC; ++cc)
          S::tma_load_2d(st + L::A_BYTES + cc * TILE, &wmap, &full[stage],
                         n0 + cc * 64, q * C);
        if (++stage == E_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned char* my_out = out + wg * E_NC * TILE;
  // int8: the scales of this thread's channels 16 s + 8 h + 2 t + e.
  float sc[I8 ? 16 : 1];
  if constexpr (I8) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      sc[i] = in_scale[16 * (i >> 2) + 8 * ((i >> 1) & 1) + 2 * t + (i & 1)];
  }
  float acc[E_NC * 32];
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int b = u / (frame_tiles * n_groups);
    const int s0 = ((u - b * frame_tiles * n_groups) / n_groups) * 2 * E_WG;
    const int n0 = (u % n_groups) * E_NG;
    int prev = 0;
    for (int q = 0; q < PS * PS; ++q) {
      S::mbar_wait(&full[stage], phase);
      unsigned char* st = stages + stage * L::STAGE;
      const unsigned char* a_tile = st + wg * 2 * L::A_BOX;
      const unsigned char* b_tile = st + L::A_BYTES;
      if constexpr (!I8) {
        S::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          S::wgmma_ss_n192(acc, S::desc_a(a_tile, s), S::desc_b(b_tile, s),
                           q | s);
        S::wgmma_commit();
        S::wgmma_wait<1>();  // the previous stage's products are done
        if (q > 0) release(&empty[prev], lane);
      } else {
        // A fragment of rows r0 = 16 warp + g and r0 + 8, channels
        // 16 s + 2 t (+1, +8, +9), dequantized as the TPU kernel does.
        const int r0 = 16 * warp + g;
        uint32_t a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int r = r0 + 8 * (f & 1);
            const int h = f >> 1;
            const char2 v = *reinterpret_cast<const char2*>(
                a_tile + sw64(r, 16 * s + 8 * h + 2 * t));
            a[s][f] = pack(__fmul_rn(float(v.x), sc[4 * s + 2 * h]),
                           __fmul_rn(float(v.y), sc[4 * s + 2 * h + 1]));
          }
        S::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          S::wgmma_rs_n192(acc, a[s], S::desc_b(b_tile, s), q | s);
        S::wgmma_commit();
        S::wgmma_wait<0>();
        release(&empty[stage], lane);
      }
      prev = stage;
      if (++stage == E_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (!I8) {
      S::wgmma_wait<0>();
      release(&empty[prev], lane);
    }
    S::fence_acc(acc);

    // Epilogue: + bias, one rounding, into the swizzled staging tile (64
    // rows x 192 columns as three 64-column tiles), then TMA stores.
    if (wtid == 0) S::store_wait_read<0>();
    S::named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < E_NC * 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float b0 = n < D ? bias[n] : 0.f;
      const float b1 = n < D ? bias[n + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;
        *reinterpret_cast<uint32_t*>(my_out + (j >> 3) * TILE +
                                     sw128(r, j & 7) + 4 * t) =
            pack(acc[4 * j + 2 * i] + b0, acc[4 * j + 2 * i + 1] + b1);
      }
    }
    S::fence_async_smem();
    S::named_sync(1 + wg, 128);
    if (wtid == 0) {
      for (int sg = 0; sg < 2; ++sg) {
        const int s = s0 + 2 * wg + sg;
        if (s >= frame_seg) break;
        int bt, tx0;
        segment(b * frame_seg + s, seg_row, bt, tx0);
        for (int cc = 0; cc < E_NC && n0 + cc * 64 < D; ++cc)
          S::tma_store_3d(&tmap, my_out + cc * TILE + sg * (TILE / 2),
                          n0 + cc * 64, tx0, bt);
      }
      S::store_commit();
    }
  }
  if (wtid == 0) S::store_wait_all();
}

// -------------------------------------------------------------- unembed
// The unembed at KC 64-row chunks of K (D <= 64 KC; rows past D load as
// zeros): consumer warpgroups, ring stages and dynamic shared memory, laid
// out as A tile, ring, two staging buffers a warpgroup, barriers.
template <bool I8, int KC>
struct UnembedSmem {
  static constexpr int WG = KC <= 4 ? 2 : 1;
  static constexpr int STAGES = (WG == 2 && KC <= 3) ? 3 : 2;
  static constexpr int SK_BOX = SEG * C * (I8 ? 1 : 2);
  static constexpr int A_BYTES = KC * WG * TILE;
  static constexpr int STAGE = KC * TILE + 2 * WG * SK_BOX;
  static constexpr int OUT = WG * 2 * TILE;
  static constexpr int BYTES = 1024 + A_BYTES + STAGES * STAGE + OUT +
                               (2 * STAGES + 2) * 8;
};

// tmap: tokens (B Ht, Wt, D), box (64, 32, 1); wmap: W (D, 4096), box
// (64, 64); smap / omap: skip / out as (B Ht, 8, Wt, 512), box (64, 32, 1,
// 1) (the skip int8 with the 64B swizzle when I8). bias (64) f32;
// feat_scale (64) f32 when I8. R3: round_steps, no ReLU.
template <bool I8, bool R3, int KC>
__global__ void __launch_bounds__(UnembedSmem<I8, KC>::WG * 128 + 32, 1)
unembed_kernel(const __grid_constant__ CUtensorMap tmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap smap,
               const __grid_constant__ CUtensorMap omap,
               const float* __restrict__ bias,
               const float* __restrict__ feat_scale, int relu, int seg_row,
               int n_seg, int n_tiles) {
  using L = UnembedSmem<I8, KC>;
  constexpr int WG = L::WG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_all = align1024(smem_raw);
  unsigned char* stages = a_all + L::A_BYTES;
  unsigned char* out = stages + L::STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + L::OUT);
  uint64_t* empty = full + L::STAGES;
  uint64_t* a_full = empty + L::STAGES;
  uint64_t* a_empty = a_full + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      S::mbar_init(&full[s], 1);
      S::mbar_init(&empty[s], WG * 4);
    }
    S::mbar_init(a_full, 1);
    S::mbar_init(a_empty, WG * 4);
    S::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= WG * 128) {  // producer warp
    if (tid != WG * 128) return;
    int stage = 0;
    uint32_t phase = 0, a_phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int bt[2 * WG], tx0[2 * WG];
      for (int sg = 0; sg < 2 * WG; ++sg)
        segment(tile * 2 * WG + sg, seg_row, bt[sg], tx0[sg]);
      S::mbar_wait(a_empty, a_phase ^ 1);
      S::mbar_expect_tx(a_full, L::A_BYTES);
      for (int kc = 0; kc < KC; ++kc)
        for (int sg = 0; sg < 2 * WG; ++sg)
          S::tma_load_3d(a_all + (kc * WG + sg / 2) * TILE +
                             (sg & 1) * (TILE / 2),
                         &tmap, a_full, kc * 64, tx0[sg], bt[sg]);
      a_phase ^= 1;
      for (int p = 0; p < PS * PS; ++p) {  // output pixel (p / 8, p % 8)
        S::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = stages + stage * L::STAGE;
        S::mbar_expect_tx(&full[stage], L::STAGE);
        for (int kc = 0; kc < KC; ++kc)
          S::tma_load_2d(st + kc * TILE, &wmap, &full[stage], p * C, kc * 64);
        for (int sg = 0; sg < 2 * WG; ++sg)
          S::tma_load_4d(st + KC * TILE + sg * L::SK_BOX, &smap, &full[stage],
                         (p % PS) * C, tx0[sg], p / PS, bt[sg]);
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // Bias (and int8 scales) of this thread's channels 8 j + 2 t + e.
  float bs[16], sc[I8 ? 16 : 1];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bs[i] = bias[8 * (i >> 1) + 2 * t + (i & 1)];
    if constexpr (I8) sc[i] = feat_scale[8 * (i >> 1) + 2 * t + (i & 1)];
  }
  float acc[32];
  int stage = 0, ob = 0;
  uint32_t phase = 0, a_phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    S::mbar_wait(a_full, a_phase);
    a_phase ^= 1;
    for (int p = 0; p < PS * PS; ++p) {
      S::mbar_wait(&full[stage], phase);
      const unsigned char* st = stages + stage * L::STAGE;
      S::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4 * KC; ++s)
        S::wgmma_ss_n64(acc, S::desc_a(a_all + ((s >> 2) * WG + wg) * TILE,
                                       s & 3),
                        S::desc_b(st + (s >> 2) * TILE, s & 3), s);
      S::wgmma_commit();
      S::wgmma_wait<0>();
      S::fence_acc(acc);
      if (p == PS * PS - 1) release(a_empty, lane);

      // Epilogue in f32 from the skip box; one rounding into the staging
      // buffer `ob`, which the store of two slabs ago has read (waited for
      // before the last slab's barrier).
      const unsigned char* sk = st + KC * TILE + wg * 2 * L::SK_BOX;
      unsigned char* ot = out + (wg * 2 + ob) * TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * warp + g + 8 * i;
          const int e = 4 * j + 2 * i;
          float s0, s1;
          if constexpr (I8) {
            const char2 v = *reinterpret_cast<const char2*>(
                sk + sw64(r, 8 * j + 2 * t));
            s0 = __fmul_rn(float(v.x), sc[2 * j]);
            s1 = __fmul_rn(float(v.y), sc[2 * j + 1]);
          } else {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sk + sw128(r, j) +
                                                         4 * t));
            s0 = v.x;
            s1 = v.y;
          }
          float v0, v1;
          if constexpr (R3) {
            const float2 y = __bfloat1622float2(
                __floats2bfloat162_rn(acc[e], acc[e + 1]));
            const float2 yb = __bfloat1622float2(__floats2bfloat162_rn(
                y.x + bs[2 * j], y.y + bs[2 * j + 1]));
            v0 = yb.x + s0;
            v1 = yb.y + s1;
          } else {
            v0 = acc[e] + bs[2 * j] + s0;
            v1 = acc[e + 1] + bs[2 * j + 1] + s1;
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<uint32_t*>(ot + sw128(r, j) + 4 * t) =
              pack(v0, v1);
        }
      release(&empty[stage], lane);
      S::fence_async_smem();
      // The previous slab's store has read its buffer, the next slab's.
      if (wtid == 0) S::store_wait_read<0>();
      S::named_sync(1 + wg, 128);
      if (wtid == 0) {
        for (int sg = 0; sg < 2; ++sg) {
          const int s = tile * 2 * WG + 2 * wg + sg;
          if (s >= n_seg) break;
          int bt, tx0;
          segment(s, seg_row, bt, tx0);
          S::tma_store_4d(&omap, ot + sg * (TILE / 2), (p % PS) * C, tx0,
                          p / PS, bt);
        }
        S::store_commit();
      }
      ob ^= 1;
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if (wtid == 0) S::store_wait_all();
}

// The NHWC map (B, 8 Ht, 8 Wt, 64) as (B Ht, 8, Wt, 512), box (64, 32, 1, 1).
int map_patches(CUtensorMap* m, const void* p, bool i8, int B, int Ht,
                int Wt) {
  const uint64_t es = i8 ? 1 : 2;
  const uint64_t dims[4] = {uint64_t(PS * C), uint64_t(Wt), uint64_t(PS),
                            uint64_t(B) * Ht};
  const uint64_t strides[3] = {PS * C * es, uint64_t(Wt) * PS * C * es,
                               uint64_t(Wt) * PS * PS * C * es};
  const uint32_t box[4] = {C, SEG, 1, 1};
  return S::encode_map(m,
                       i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       4, p, dims, strides, box,
                       i8 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_128B);
}

// Tokens (B, Ht, Wt, D) bf16 as (B Ht, Wt, D), box (64, 32, 1).
int map_tokens(CUtensorMap* m, const void* p, int B, int Ht, int Wt, int D) {
  const uint64_t dims[3] = {uint64_t(D), uint64_t(Wt), uint64_t(B) * Ht};
  const uint64_t strides[2] = {uint64_t(D) * 2, uint64_t(Wt) * D * 2};
  const uint32_t box[3] = {64, SEG, 1};
  return S::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A (rows, cols) bf16 row-major weight, box (64, 64).
int map_weight(CUtensorMap* m, const void* p, int rows, int cols) {
  const uint64_t dims[2] = {uint64_t(cols), uint64_t(rows)};
  const uint64_t strides[1] = {uint64_t(cols) * 2};
  const uint32_t box[2] = {64, 64};
  return S::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool I8>
int launch_embed(const CUtensorMap& f, const CUtensorMap& w,
                 const CUtensorMap& tk, const void* bias,
                 const void* in_scale, int B, int Ht, int Wt, int D,
                 int device, void* stream) {
  const int smem = EmbedSmem<I8>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      embed_kernel<I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int seg_row = (Wt + SEG - 1) / SEG;
  const int frame_seg = Ht * seg_row;
  const int frame_tiles = (frame_seg + 2 * E_WG - 1) / (2 * E_WG);
  const int n_groups = (D + E_NG - 1) / E_NG;
  const int n_units = B * frame_tiles * n_groups;
  const int grid = n_units < S::sm_count(device) ? n_units
                                                 : S::sm_count(device);
  embed_kernel<I8>
      <<<grid, E_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          f, w, tk, static_cast<const float*>(bias),
          static_cast<const float*>(in_scale), D, seg_row, frame_seg,
          frame_tiles, n_groups, n_units, B * Ht);
  return int(cudaGetLastError());
}

template <bool I8, bool R3, int KC>
int launch_unembed(const CUtensorMap& tk, const CUtensorMap& w,
                   const CUtensorMap& sk, const CUtensorMap& o,
                   const void* bias, const void* feat_scale, int B, int Ht,
                   int Wt, int relu, int device, void* stream) {
  using L = UnembedSmem<I8, KC>;
  static_assert(L::BYTES <= MAX_SMEM, "unembed shared memory");
  auto kern = unembed_kernel<I8, R3, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return int(err);
  const int seg_row = (Wt + SEG - 1) / SEG;
  const int n_seg = B * Ht * seg_row;
  const int n_tiles = (n_seg + 2 * L::WG - 1) / (2 * L::WG);
  const int grid = n_tiles < S::sm_count(device) ? n_tiles
                                                 : S::sm_count(device);
  kern<<<grid, L::WG * 128 + 32, L::BYTES,
         static_cast<cudaStream_t>(stream)>>>(
      tk, w, sk, o, static_cast<const float*>(bias),
      static_cast<const float*>(feat_scale), relu, seg_row, n_seg, n_tiles);
  return int(cudaGetLastError());
}

// The instantiation for D = 16..512: KC = ceil(D / 64).
template <bool I8, bool R3>
int unembed_kc(const CUtensorMap& tk, const CUtensorMap& w,
               const CUtensorMap& sk, const CUtensorMap& o, const void* bias,
               const void* feat_scale, int B, int Ht, int Wt, int D, int relu,
               int device, void* stream) {
#define TUX_UNEMBED(KC)                                                      \
  case KC:                                                                   \
    return launch_unembed<I8, R3, KC>(tk, w, sk, o, bias, feat_scale, B, Ht, \
                                      Wt, relu, device, stream);
  switch ((D + 63) / 64) {
    TUX_UNEMBED(1)
    TUX_UNEMBED(2)
    TUX_UNEMBED(3)
    TUX_UNEMBED(4)
    TUX_UNEMBED(5)
    TUX_UNEMBED(6)
    TUX_UNEMBED(7)
    TUX_UNEMBED(8)
  }
#undef TUX_UNEMBED
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 on success).
// wt is the weight in its stored layout: (8, 8, 64, D) = (4096, D) for the
// embed, (D, 8, 8, 64) = (D, 4096) for the unembed, bf16, contiguous. D must
// be a multiple of 64 (embed) or of 16 and at most 512 (unembed). A null
// in_scale / feat_scale means bf16 feat / skip; else they are int8 with
// these (64) f32 scales. round_steps (bf16 skip, no ReLU): the
// three-rounding epilogue.
extern "C" int tux_embed(const void* feat, const void* wt, const void* bias,
                         const void* in_scale, void* tokens, int B, int Ht,
                         int Wt, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (D % 64 != 0) return int(cudaErrorInvalidValue);
  const bool i8 = in_scale != nullptr;
  CUtensorMap f, w, tk;
  int e = map_patches(&f, feat, i8, B, Ht, Wt);
  if (e == 0) e = map_weight(&w, wt, PS * PS * C, D);
  if (e == 0) e = map_tokens(&tk, tokens, B, Ht, Wt, D);
  if (e != 0) return e;
  static_assert(EmbedSmem<false>::BYTES <= MAX_SMEM, "embed shared memory");
  return i8 ? launch_embed<true>(f, w, tk, bias, in_scale, B, Ht, Wt, D,
                                 device, stream)
            : launch_embed<false>(f, w, tk, bias, in_scale, B, Ht, Wt, D,
                                  device, stream);
}

extern "C" int tux_unembed_combine(const void* tokens, const void* wt,
                                   const void* bias, const void* skip,
                                   const void* feat_scale, void* out, int B,
                                   int Ht, int Wt, int D, int relu,
                                   int round_steps, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const bool i8 = feat_scale != nullptr;
  if (D % 16 != 0 || D > 512 || (round_steps && (i8 || relu)))
    return int(cudaErrorInvalidValue);
  CUtensorMap tk, w, sk, o;
  int e = map_tokens(&tk, tokens, B, Ht, Wt, D);
  if (e == 0) e = map_weight(&w, wt, D, PS * PS * C);
  if (e == 0) e = map_patches(&sk, skip, i8, B, Ht, Wt);
  if (e == 0) e = map_patches(&o, out, false, B, Ht, Wt);
  if (e != 0) return e;
  if (round_steps)
    return unembed_kc<false, true>(tk, w, sk, o, bias, nullptr, B, Ht, Wt, D,
                                   0, device, stream);
  if (i8)
    return unembed_kc<true, false>(tk, w, sk, o, bias, feat_scale, B, Ht, Wt,
                                   D, relu, device, stream);
  return unembed_kc<false, false>(tk, w, sk, o, bias, nullptr, B, Ht, Wt, D,
                                  relu, device, stream);
}
