// The tensor-memory accelerator (TMA) and shared-memory mbarriers, shared by
// K10/K11 (linear.cu) and K3's wide body (attention_fwd.cuh).
//
// One thread asks for a whole box of a tensor (2-D: 64 channels x rows; 4-D:
// 64 head columns x 1 head x rows x 1 batch) to be copied from device memory
// into shared memory, in the 128-byte swizzle; the copy reports its bytes to
// an mbarrier, on which the consumers wait.  Boxes reaching past the tensor
// arrive zero-filled.  The tensor maps are encoded on the host through the
// driver's cuTensorMapEncodeTiled, reached through the runtime (no libcuda
// link), and cached by everything they encode.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace sdtk {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
}
// Box (channels c .. c + 63, rows r ..) of the tensor map into shared dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}
// Box at coordinates (c0, c1, c2, c3), innermost first, of a 4-D tensor map.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Box (columns c .., rows r ..) of shared src to the tensor map's tensor.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c, int r, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(src)
               : "memory");
}

// Byte offset of 16-byte piece j of 128-byte row r in the 128-byte swizzle
// (from a 1024-byte aligned region): where TMA's SWIZZLE_128B puts it.
__device__ __forceinline__ uint32_t swz(int r, int j) { return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4)); }

namespace {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA map of a bf16 tensor of `rank` dimensions (dims innermost first,
// the innermost contiguous; strides[i] the bytes between steps of dimension
// i + 1) in boxes of `box`, in the given swizzle, zeros read out of bounds
// and nothing written there.
bool encode_map_nd(CUtensorMap* map, const void* base, int rank, const uint64_t* dims, const uint64_t* strides,
                   const uint32_t* box, CUtensorMapSwizzle swizzle) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return false;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  cuuint64_t d[4], s[3];
  cuuint32_t b[4], elem[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), d, s, b, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_map_nd through a small cache keyed by everything the map encodes (a
// hit is the same map): weights' maps, and activations' while the caching
// allocator hands their buffers back at the same addresses, cost a lookup
// instead of ~1-5 us of host time each.  One card, one host thread.
bool cached_map_nd(CUtensorMap* map, const void* base, int rank, const uint64_t* dims, const uint64_t* strides,
                   const uint32_t* box, CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* base;
    int rank, swizzle;
    uint64_t dims[4], strides[3];
    uint32_t box[4];
    CUtensorMap map;
  };
  constexpr int kEntries = 512;
  static Entry cache[kEntries];
  uint64_t key = (uint64_t)(uintptr_t)base ^ ((uint64_t)swizzle << 60) ^ ((uint64_t)rank << 56);
  for (int i = 0; i < rank; ++i) {
    key = key * 0x9E3779B97F4A7C15ull ^ dims[i] ^ ((uint64_t)box[i] << 40);
    if (i + 1 < rank) key = key * 0x9E3779B97F4A7C15ull ^ strides[i];
  }
  Entry& e = cache[(key ^ (key >> 29) ^ (key >> 47)) % kEntries];
  bool hit = e.base == base && e.rank == rank && e.swizzle == (int)swizzle;
  for (int i = 0; hit && i < rank; ++i)
    hit = e.dims[i] == dims[i] && e.box[i] == box[i] && (i + 1 == rank || e.strides[i] == strides[i]);
  if (hit) {
    *map = e.map;
    return true;
  }
  if (!encode_map_nd(map, base, rank, dims, strides, box, swizzle)) return false;
  e.base = base;
  e.rank = rank;
  e.swizzle = (int)swizzle;
  for (int i = 0; i < rank; ++i) {
    e.dims[i] = dims[i];
    e.box[i] = box[i];
    if (i + 1 < rank) e.strides[i] = strides[i];
  }
  e.map = *map;
  return true;
}

// The cached TMA map of a (rows, cols) row-major bf16 tensor in boxes of
// box_cols x box_rows.
bool cached_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
  return cached_map_nd(map, base, 2, dims, strides, box, swizzle);
}

}  // namespace
}  // namespace sdtk
