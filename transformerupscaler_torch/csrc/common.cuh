// Shared pieces of the port's hand-written Hopper kernels: the bf16
// tensor-core product (mma.sync m16n8k16, f32 accumulate) and its B
// fragment from shared memory.
//
// Fragment layout of mma.sync.m16n8k16.row.col (PTX ISA, "Matrix fragments
// for mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, stored as Bt[n][k]): b0 = Bt[g][2t..2t+1], b1 = Bt[g][2t+8..2t+9]
//   C (16x8, f32): c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Every operand pair is two adjacent bf16 in shared memory, read as one
// 32-bit word. Tiles keep a row stride of (multiple of 64) + 8 elements, so
// the eight rows g = 0..7 of one read land on eight distinct 4-bank groups
// and a warp's 32 reads hit 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tux {

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load_b(uint32_t (&b)[2],
                                       const __nv_bfloat16* col_g, int t) {
  b[0] = ld_pair(col_g + 2 * t);
  b[1] = ld_pair(col_g + 2 * t + 8);
}

}  // namespace tux
