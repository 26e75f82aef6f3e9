// Warp-level tensor-core helpers shared by the attention kernels (K3, K5, K6):
// `mma.sync` m16n8k16 (bf16 in, f32 accumulate) with fragments taken from
// shared memory by 32-bit loads or `ldmatrix`.
//
// Fragment layout of one m16n8k16 product, lane = 4 g + t (g = lane / 4,
// t = lane % 4): the A fragment holds A[g][2t..2t+1], A[g+8][2t..2t+1],
// A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]; the B fragment B[2t..2t+1][g],
// B[2t+8..2t+9][g]; the accumulator C[g][2t..2t+1], C[g+8][2t..2t+1].  So
// the accumulators of two adjacent 8-column tiles are, packed to bf16, the A
// fragment of one 16-deep step: a product's result feeds the next product
// without leaving registers.
#pragma once

#include "common.cuh"

namespace sdtk {

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed, from shared memory.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace sdtk
