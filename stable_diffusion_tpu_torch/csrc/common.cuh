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

// Round a byte count up so every shared-memory region starts 128-byte aligned
// (WMMA needs 32-byte aligned fragment pointers).
__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) & ~127; }

}  // namespace sdtk
