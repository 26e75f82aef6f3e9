// Warp-level tensor-core helpers shared by the attention kernels (K3, K5, K6):
// `mma.sync` m16n8k16 (bf16 in, f32 accumulate) with fragments taken from
// shared memory by 32-bit loads or `ldmatrix`; and by the W8A8 kernels
// (K7, K8, K9): the int8 quantizer and the s8 fragment layout (their
// products are `wgmma`, wgmma.cuh).
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

// The s8 A fragment of 16 rows x 32 bytes (the register operand of K7's
// s8 wgmma, wgmma.cuh WgmmaS8RS), lane = 4 g + t: a0 = A[g][4t..4t+3], a1
// = A[g+8][4t..4t+3], a2 = A[g][4t+16..4t+19], a3 = A[g+8][4t+16..4t+19]:
// byte for byte the bf16 m16n8k16 A fragment, so `ldmatrix.x4` gives it.

// An activation quantized with the static step s: clip(rint(v / s), +-127),
// from inv = 1 / s (rounded once, IEEE): q0 = v * inv is within an ulp of
// v / s, and one FMA correction, q0 + (v - q0 s) inv with the residual
// exact, gives the correctly rounded quotient (Markstein's theorem, for a
// correctly rounded reciprocal and no underflow; a quotient small enough
// to underflow rounds to code 0 either way), and __float2int_rn rounds half
// to even, as torch.round and jnp.round: the plain versions' codes for the
// same f32 input.  Five instructions where the IEEE division's inlined
// slow-path check costs ~25 and a call site (K7, K8 and K9 quantize every
// value with it; their first designs divided, 45-90 times a value in K7).
__device__ __forceinline__ int quantize_s8_rcp(float v, float s, float inv) {
  const float q0 = v * inv;
  const float q = fmaf(fmaf(-q0, s, v), inv, q0);
  return max(-127, min(127, __float2int_rn(q)));
}

// Four int8 codes packed into one 32-bit word, lowest address first.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i .. 8i+7 give the
// shared-space addresses of matrix i's eight 16-byte rows, and r[i] holds
// matrix i in the fragment layout above (lane 4g + t: row g, elements 2t,
// 2t+1).  So rows of 16 A rows x 8 k (matrices 0, 1 at k 0-7, then 2, 3 at
// k 8-15) give the m16n8k16 A fragment, and rows of 8 n x 8 k of a
// K-contiguous B give its b0, b1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 bf16 matrices, transposed, from shared memory.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  ldmatrix_x4_trans(r, static_cast<uint32_t>(__cvta_generic_to_shared(p)));
}

// 2^x on the special-function unit (one MUFU.EX2): relative error ~2^-22,
// subnormal results flushed to 0; 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sdtk
