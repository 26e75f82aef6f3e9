// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream and returns cudaGetLastError() (0 on success); the Python
// wrappers (stable_diffusion_tpu_torch/ops/*.py) bind them with ctypes and
// raise on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace sdtk {

using bf16 = __nv_bfloat16;

// 8 bf16 values moved as one 16-byte vector.
union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The shared-space address of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte asynchronous copy from global to shared memory (cp.async.cg:
// through L2 only).  With ok false nothing is read and the 16 bytes are
// zero-filled (source size 0); src must still be a valid address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy ROWS rows x DP columns of one head (row r at src + r * ss) into a
// shared tile, 16 bytes a cp.async; row r's piece p lands at shared address
// addr(r, p).  Rows at or past `rows` and columns at or past D are
// zero-filled (src, a valid address, stands in as their source).
template <int ROWS, int DP, int NTHREADS, class Addr>
__device__ __forceinline__ void copy_rows(const bf16* src, long ss, int rows, int D, Addr addr) {
  constexpr int VPR = DP / 8;
#pragma unroll
  for (int i = 0; i < (ROWS * VPR + NTHREADS - 1) / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    if (ROWS * VPR % NTHREADS == 0 || idx < ROWS * VPR) {
      const int r = idx / VPR, p = idx - r * VPR;
      const bool ok = r < rows && 8 * p < D;
      cp_async16(addr(r, p), ok ? src + r * ss + 8 * p : src, ok);
    }
  }
}

// Round a byte count up so every shared-memory region starts 128-byte aligned
// (WMMA needs 32-byte aligned fragment pointers).
__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) & ~127; }

}  // namespace sdtk
