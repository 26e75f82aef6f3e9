// K8: static-W8A8 matmul: (LayerNorm ->) quantize the activation to int8
// with the layer's calibrated step -> int8 x int8 -> int32 product ->
// dequantize, +bias (+residual), bf16 out.
//
// Replaces: stable_diffusion_tpu/ops/linear.py `_make_q_kernel` (launched by
// `_q_mm_call`, reached through `ln_matmul_w8a8` and `matmul_w8a8`).
//
// What bounds it on Hopper: at the UNet's shapes (M = 8 x 4096 rows down
// to 1, K and N 320-3840) the int8 tensor-core work is 2*M*K*N operations
// against M*K*2 + K*N + M*N*2(*2) bytes: 2*K*N / (2*K + 2*N) operations a
// byte at large M, 160-480 at the path's widths, under the H100's int8
// ridge (1979 TOP/s / 3.35 TB/s ~ 590): every path shape is bound by its
// bytes, the large-M ones by reading x and writing y, the M = 1 time
// embeddings by the weight.  So x must be read once, y written once, and
// the products must keep up with both.
//
// Design (the first design, `mma.sync` on 64 x 128 blocks, re-read and
// re-normalized each row in every one of the N / 128 column blocks and
// left 122 of 132 SMs idle at M = 1; PERF.md keeps its readings).  Two
// launches:
// * quantize_rows_kernel LayerNorms and quantizes each row once, one warp a
//   row, into an int8 scratch (M x K): f32 statistics (two passes, mean then
//   squared deviations), the normalize in f32 (the LN output goes to the
//   quantizer unrounded, as in the TPU kernel; the plain version, JAX's XLA
//   form, casts it to the input dtype first: in f32 the two are one
//   function) and quantize_s8_rcp: v * (1 / s) with one FMA correction, the
//   correctly rounded v / s, so the same codes as the plain version's
//   division (the IEEE division inlined a slow-path check and a call site
//   at every value and doubled the quantize's time on an NVIDIA H100 80GB
//   HBM3 at 700 W).
// * linear_q_kernel: a block owns BM rows (64 or 128: a warpgroup each 64)
//   and walks a contiguous range of BN-column tiles (the plan's nsplit
//   ranges a row block) over a contiguous range of 128-byte K chunks (its
//   ksplit part).  Its int8 rows come by cp.async, a chunk with each of the
//   first tile's weight slabs, into shared memory in the 128-byte swizzle,
//   where they stay for every later tile; wgmma reads them by descriptor
//   (s8 wgmma takes both operands K-major; PyTorch's (N, K) int8 weight
//   already is).  The weight comes through a STAGES-deep cp.async ring of
//   BN x 128-byte slabs (K2's and K4's: one commit group and one barrier a
//   step), STAGES - 2 slabs ahead while one step's products stay in flight
//   across the next step's barrier.  A tile's out_scale and bias come with
//   its first slab into a side buffer.
// * Why two launches: the first design of this one quantized its rows in
//   the GEMM's prologue (staged through the ring's space); a block's
//   prologue, products and stores then ran one after another and the
//   blocks of a wave in step, so the card streamed ~1.2 TB/s.  The int8
//   rows make one round trip through device memory instead (M K bytes each
//   way, L2-resident at the path's sizes), and the GEMM's loads pipeline:
//   on an NVIDIA H100 80GB HBM3 at 700 W the W8A8 pass took 3.48 ms on the
//   device against 4.37 for the fused prologue (same call), faster at 16 of
//   the 19 shapes and within 0.7 us (the second launch) at the other three.
// * Epilogue: acc * out_scale[n] + bias[n] (+ residual) in f32, one rounding
//   to bf16; the tile's residual is fetched into registers before its last
//   products are waited for; the bf16 tile is staged in a free ring slot and
//   stored in coalesced 16-byte rows (4-byte stores of pairs wrote half
//   sectors: 3.48 -> 3.05 ms a pass).
// * Split K (ksplit > 1: the M <= 64 time embeddings, where at least 132
//   blocks must stream the weight, and K too long for a block's rows): each
//   part adds its int32 partial tile into a zeroed workspace with atomics
//   (exact in any order, so the result is deterministic), and the last part
//   to take the tile's ticket (K1's method) reads the sums, zeroes them and
//   its ticket for the next call, and runs the epilogue.
// linear_q_plan (ops/linear.py) mirrors the dispatch: the variant (BM, BN,
// STAGES, blocks an SM), the N split, the K split and the shared bytes.
// Not yet: a persistent block (one tile's epilogue under the next one's
// loads), TMA.
#include <string.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace sdtk {
namespace {

constexpr int QKC = 128;          // K a step: one 128-byte swizzled row of int8
constexpr int QREG_K = 1280;      // rows up to this K are held in registers (5 vectors a lane)
constexpr int kQMaxSmem = 232448;  // 227 KB a block may use on Hopper

// A tile's out_scale (f32) and bias (bf16), staged for its epilogue.
__host__ __device__ constexpr int lq_side(int BN) { return BN * 6; }

// Shared bytes: 1024 to align the ring, the ring, the block's int8 rows,
// three tiles' side buffers, 16 for the split-K ticket's flag.
__host__ __device__ constexpr int lq_smem(int BM, int BN, int STAGES, int nkc) {
  return 1024 + STAGES * BN * QKC + BM * nkc * QKC + 3 * lq_side(BN) + 16;
}

// Byte offset of 16-byte piece j of 128-byte row r in the 128-byte swizzle.
__device__ __forceinline__ uint32_t qswz(int r, int j) {
  return (uint32_t)(r * QKC + ((j ^ (r & 7)) << 4));
}

// The first launch: (LN ->) quantize x into the int8 rows q.
struct QuantArgs {
  const bf16* x;         // (M, K)
  const bf16* ln_w;      // (K) or null
  const bf16* ln_b;      // (K) or null
  const float* sx;       // (1) the activation step
  int8_t* q;             // (M, K)
  int M, K;
  float eps;
};

// The second: the int8 product and its epilogue.
struct LqArgs {
  const int8_t* q;       // (M, K) the quantized rows
  const int8_t* w;       // (N, K)
  const float* oscale;   // (N) sx * weight_scale
  const bf16* bias;      // (N) or null
  const bf16* res;       // (M, N) or null
  bf16* y;               // (M, N)
  int* ws;               // (M, N) int32, zero, when ksplit > 1
  int* tickets;          // (row blocks, N tiles), zero, when ksplit > 1
  int M, N, K, nsplit, ksplit;
};

// The codes of 8 values of a row: (LN ->) quantize.
__device__ __forceinline__ uint2 codes8(const Pack8& x, const Pack8& gw, const Pack8& gb, bool ln,
                                        float mean, float rstd, float sx, float inv) {
  int c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float v = to_f(x.h[k]);
    if (ln) v = (v - mean) * rstd * to_f(gw.h[k]) + to_f(gb.h[k]);
    c[k] = quantize_s8_rcp(v, sx, inv);
  }
  return make_uint2(pack_s8(c[0], c[1], c[2], c[3]), pack_s8(c[4], c[5], c[6], c[7]));
}

// One warp a row: the LayerNorm statistics in f32 (two passes: mean, then
// squared deviations), the normalize in f32, the codes, stored as 8 bytes a
// lane-vector.  NV > 0: lane l holds the row's vectors l + 32 i (i < NV) in
// registers (K <= 256 NV); NV = 0: any K, three passes over the row (L1).
template <int NV>
__global__ void __launch_bounds__(256) quantize_rows_kernel(QuantArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * 8 + warp;
  if (row >= a.M) return;
  const float sx = *a.sx, inv = 1.f / sx;
  const bool ln = a.ln_w != nullptr;
  const int nvec = a.K >> 3;
  const bf16* src = a.x + row * a.K;
  int8_t* dst = a.q + row * a.K;
  if constexpr (NV > 0) {
    Pack8 xv[NV], gw[NV], gb[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      xv[i].u = v < nvec ? *reinterpret_cast<const uint4*>(src + 8 * v) : make_uint4(0, 0, 0, 0);
      if (ln && v < nvec) {
        gw[i].u = *reinterpret_cast<const uint4*>(a.ln_w + 8 * v);
        gb[i].u = *reinterpret_cast<const uint4*>(a.ln_b + 8 * v);
      }
    }
    float mean = 0.f, rstd = 1.f;
    if (ln) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += to_f(xv[i].h[k]);
      mean = warp_sum(sum) / a.K;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i < nvec) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float d = to_f(xv[i].h[k]) - mean;
            q += d * d;
          }
        }
      }
      rstd = rsqrtf(warp_sum(q) / a.K + a.eps);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec)
        *reinterpret_cast<uint2*>(dst + 8 * v) = codes8(xv[i], gw[i], gb[i], ln, mean, rstd, sx, inv);
    }
  } else {
    float mean = 0.f, rstd = 1.f;
    if (ln) {
      float sum = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        Pack8 xv;
        xv.u = *reinterpret_cast<const uint4*>(src + 8 * v);
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += to_f(xv.h[k]);
      }
      mean = warp_sum(sum) / a.K;
      float q = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        Pack8 xv;
        xv.u = *reinterpret_cast<const uint4*>(src + 8 * v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = to_f(xv.h[k]) - mean;
          q += d * d;
        }
      }
      rstd = rsqrtf(warp_sum(q) / a.K + a.eps);
    }
    for (int v = lane; v < nvec; v += 32) {
      Pack8 xv, gw, gb;
      xv.u = *reinterpret_cast<const uint4*>(src + 8 * v);
      if (ln) {
        gw.u = *reinterpret_cast<const uint4*>(a.ln_w + 8 * v);
        gb.u = *reinterpret_cast<const uint4*>(a.ln_b + 8 * v);
      }
      *reinterpret_cast<uint2*>(dst + 8 * v) = codes8(xv, gw, gb, ln, mean, rstd, sx, inv);
    }
  }
}

// BM rows (a warpgroup each 64) x BN columns a tile; grid (row block, N
// split, K split).
template <int BM, int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(2 * BM, MINB) linear_q_kernel(LqArgs a) {
  constexpr int THREADS = 2 * BM, LOOK = STAGES - 2, SLAB = BN * QKC;
  static_assert(STAGES >= 3, "products stay in flight across a barrier: three stages at least");
  static_assert(BN * 8 % THREADS == 0 && SLAB % 1024 == 0, "whole swizzle atoms a slab");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t abase = ring + STAGES * SLAB;  // chunk j of the rows at abase + j * BM * QKC

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int M = a.M, N = a.N, K = a.K;
  const int m0 = blockIdx.x * BM;
  const int ntiles = (N + BN - 1) / BN, kch = (K + QKC - 1) / QKC;
  const int t0 = blockIdx.y * ntiles / a.nsplit, t1 = (blockIdx.y + 1) * ntiles / a.nsplit;
  const int c0 = blockIdx.z * kch / a.ksplit, c1 = (blockIdx.z + 1) * kch / a.ksplit;
  const int nkc = c1 - c0, nsteps = (t1 - t0) * nkc;
  const int j8 = tid & 7;
  const int nkc_max = (kch + a.ksplit - 1) / a.ksplit;
  const uint32_t sbase = abase + BM * nkc_max * QKC;  // tile i's side buffer at sbase + (i % 3) * SIDE
  const unsigned char* side = smem_raw + (sbase - raw);
  constexpr int SIDE = lq_side(BN);
  int& last_s = *reinterpret_cast<int*>(smem_raw + (sbase - raw) + 3 * SIDE);

  // Step s's weight slab (tile t0 + s / nkc, chunk c0 + s % nkc) into stage
  // s % STAGES, rows past N and K past K zero-filled; the first tile's
  // steps also bring the block's int8 rows, a chunk each.  With a tile's first
  // chunk come its out_scale and bias (16 bytes a copy: 4 scales or 8
  // biases; N % 8 == 0, so none straddles N), into side buffer (tile - t0)
  // % 3: it is read by the tile's last step, and rewritten (tile + 3) only
  // after two more tiles' steps.
  auto load_slab = [&](int s) {
    const int n0 = (t0 + s / nkc) * BN, k = (c0 + s % nkc) * QKC + j8 * 16;
    const uint32_t dst = ring + (s % STAGES) * SLAB;
#pragma unroll
    for (int i = 0; i < BN * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8);
      const bool ok = n0 + r < N && k < K;
      cp_async16(dst + qswz(r, j8), ok ? a.w + (long)(n0 + r) * K + k : a.w, ok);
    }
    if (s < nkc) {  // the block's int8 rows of chunk c0 + s, kept for every later tile
      const uint32_t adst = abase + s * BM * QKC;
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int r = (tid >> 3) + i * (THREADS / 8);
        const bool ok = m0 + r < M && k < K;
        cp_async16(adst + qswz(r, j8), ok ? a.q + (long)(m0 + r) * K + k : a.q, ok);
      }
    }
    if (s % nkc == 0 && tid < BN / 4 + BN / 8) {
      const uint32_t sd = sbase + (s / nkc % 3) * SIDE;
      if (tid < BN / 4) {
        const bool ok = n0 + 4 * tid < N;
        cp_async16(sd + 16 * tid, ok ? a.oscale + n0 + 4 * tid : a.oscale, ok);
      } else {
        const int j = tid - BN / 4;
        const bool ok = a.bias != nullptr && n0 + 8 * j < N;
        cp_async16(sd + BN * 4 + 16 * j, ok ? (const void*)(a.bias + n0 + 8 * j) : (const void*)a.oscale,
                   ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < LOOK; ++s) {
    if (s < nsteps) load_slab(s);
    cp_async_commit();
  }

  const int g = lane >> 2, tq = lane & 3;
  const int row0 = m0 + wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: row0, row0 + 8
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  // Tile t's epilogue, acc holding its complete sums: out_scale and bias
  // from the tile's side buffer; the residual fetched into registers before
  // the tile's last products are waited for.
  uint32_t rbuf[BN / 8][2];
  auto fetch_res = [&](int t) {
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      const int col = t * BN + ni * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        rbuf[ni][hh] = col < N && row < M
                           ? *reinterpret_cast<const uint32_t*>(a.res + (long)row * N + col)
                           : 0u;
      }
    }
  };
  // The warpgroup's 64 x BN bf16 tile goes through shared memory so that it
  // leaves in coalesced 16-byte rows: ring slot (s - wg) % STAGES, one
  // warpgroup's 64 rows x BN x 2 bytes exactly, is free at a tile's last
  // step s once every warpgroup's products of steps s - 1 and s are done
  // (both warpgroups read each slab; the caller's block barrier after
  // wgmma_wait0 sees to it), and neither slot is refilled before the next
  // step's barrier.
  auto store = [&](int t, int s) {
    const float* so = reinterpret_cast<const float*>(side + (t - t0) % 3 * SIDE);
    const bf16* sb = reinterpret_cast<const bf16*>(side + (t - t0) % 3 * SIDE + BN * 4);
    unsigned char* stg = smem_raw + (ring - raw) + (s + STAGES - wg) % STAGES * SLAB;
    const int lr = (warp & 3) * 16 + g;  // the thread's rows lr, lr + 8 of the warpgroup's 64
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      const int c = ni * 8 + 2 * tq;
      const float2 s2 = *reinterpret_cast<const float2*>(so + c);
      const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sb + c));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v0 = (float)acc[4 * ni + 2 * hh] * s2.x + b2.x;
        float v1 = (float)acc[4 * ni + 2 * hh + 1] * s2.y + b2.y;
        if (a.res != nullptr) {
          const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rbuf[ni][hh]));
          v0 += r2.x, v1 += r2.y;
        }
        *reinterpret_cast<uint32_t*>(stg + (lr + 8 * hh) * BN * 2 + c * 2) = pack_bf16(v0, v1);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's tile is staged
    for (int i = tid & 127; i < 64 * BN / 8; i += 128) {
      const int r = i / (BN / 8), cc = i - r * (BN / 8);
      const int row = m0 + wg * 64 + r, col = t * BN + cc * 8;
      if (row < M && col < N)  // N % 8 == 0: whole 16-byte pieces
        *reinterpret_cast<uint4*>(a.y + (long)row * N + col) =
            *reinterpret_cast<const uint4*>(stg + r * BN * 2 + cc * 16);
    }
  };
  // Split K: add the partial tile into the workspace; the last part to take
  // the tile's ticket gathers the sums (and zeroes them and the ticket).
  auto merge = [&](int t) -> bool {
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      const int col = t * BN + ni * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (col < N && row < M) {
          atomicAdd(a.ws + (long)row * N + col, acc[4 * ni + 2 * hh]);
          atomicAdd(a.ws + (long)row * N + col + 1, acc[4 * ni + 2 * hh + 1]);
        }
      }
    }
    __threadfence();
    __syncthreads();
    int* ticket = a.tickets + (long)blockIdx.x * ntiles + t;
    if (tid == 0) last_s = atomicAdd(ticket, 1) == a.ksplit - 1;
    __syncthreads();
    if (!last_s) return false;
    __threadfence();
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      const int col = t * BN + ni * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (col < N && row < M) {
          int2* p = reinterpret_cast<int2*>(a.ws + (long)row * N + col);
          const int2 v = __ldcg(p);
          acc[4 * ni + 2 * hh] = v.x, acc[4 * ni + 2 * hh + 1] = v.y;
          *p = make_int2(0, 0);
        }
      }
    }
    if (tid == 0) *ticket = 0;
    return true;
  };

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<LOOK - 1>();
    fence_async_shared();  // the landed slab (and rows), for wgmma
    __syncthreads();       // slab s is in; the stage refilled below was read two steps ago
    if (s + LOOK < nsteps) load_slab(s + LOOK);
    cp_async_commit();
    const int kc = s % nkc;
    const uint64_t da = sw128_desc(abase + kc * BM * QKC + wg * 64 * QKC);
    const uint64_t db = sw128_desc(ring + (s % STAGES) * SLAB);
    const int nk32 = min(QKC, K - (c0 + kc) * QKC) / 32;  // k32 steps inside K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QKC / 32; ++kk)
      if (kk < nk32) WgmmaS8<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    if (kc != nkc - 1) {
      wgmma_wait<1>();
      continue;
    }
    const int t = t0 + s / nkc;
    if (a.res != nullptr) fetch_res(t);
    wgmma_wait0();
    fence_operands(acc);
    if (a.ksplit == 1) {
      // Two warpgroups read slabs s - 1 and s: both must be done with them
      // before either stages its tile there (merge's barriers do this under
      // split K).
      if constexpr (BM > 64) __syncthreads();
      store(t, s);
    } else if (merge(t)) {
      store(t, s);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  }
  cp_async_wait<0>();
}

// The first launch: one warp a row, the variant that holds the row in
// registers where K allows.
cudaError_t launch_q_rows(const QuantArgs& qa, cudaStream_t st) {
  const unsigned qgrid = (unsigned)((qa.M + 7) / 8);
  if (qa.K <= 512)
    quantize_rows_kernel<2><<<qgrid, 256, 0, st>>>(qa);
  else if (qa.K <= 768)
    quantize_rows_kernel<3><<<qgrid, 256, 0, st>>>(qa);
  else if (qa.K <= QREG_K)
    quantize_rows_kernel<5><<<qgrid, 256, 0, st>>>(qa);
  else
    quantize_rows_kernel<0><<<qgrid, 256, 0, st>>>(qa);
  return cudaGetLastError();
}

template <class F>
int lq_attrs_of(F fn, int threads, int smem, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kQMaxSmem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem + (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

}  // namespace
}  // namespace sdtk

// The compiled variants (BM, BN, STAGES, blocks an SM for the launch
// bound); linear_q_plan (ops/linear.py) chooses among them.
#define SDTK_LQ_VARIANTS(X) \
  X(128, 160, 4, 1) X(128, 160, 3, 1) X(64, 160, 4, 2) X(64, 64, 4, 2) X(64, 32, 4, 2) X(64, 16, 4, 2)

// Arguments packed as int64 (a[i]): x, ln_w, ln_b, w, sx, oscale, bias, res,
// y, ws, tickets, q (pointers), M, N, K, (bm, bn, stages, minb) a compiled
// variant, nsplit, ksplit, eps (its f32 bits), stream.  Shape rules
// (checked by the Python wrapper, which also plans): K % 32 == 0, N % 8 ==
// 0, x, w and q 16-byte aligned, every tensor contiguous; ln_w and ln_b both
// given or both null; bias and res may be null; q (M, K) int8 scratch; 1 <=
// nsplit <= N tiles, 1 <= ksplit <= K chunks, the variant's shared memory
// for ceil(K chunks / ksplit) chunks within a block; ws (M, N) int32 and
// tickets (row blocks, N tiles) int32, both zero, when ksplit > 1 (the
// kernel leaves them zero).  Launches the quantize, then the product.  An
// unknown variant returns cudaErrorInvalidValue.
extern "C" int sdtk_linear_q(const long long* p) {
  using namespace sdtk;
  QuantArgs qa;
  qa.x = (const bf16*)p[0];
  qa.ln_w = (const bf16*)p[1];
  qa.ln_b = (const bf16*)p[2];
  qa.sx = (const float*)p[4];
  qa.q = (int8_t*)p[11];
  LqArgs a;
  a.q = qa.q;
  a.w = (const int8_t*)p[3];
  a.oscale = (const float*)p[5];
  a.bias = (const bf16*)p[6];
  a.res = (const bf16*)p[7];
  a.y = (bf16*)p[8];
  a.ws = (int*)p[9];
  a.tickets = (int*)p[10];
  a.M = qa.M = (int)p[12], a.N = (int)p[13], a.K = qa.K = (int)p[14];
  const int bm = (int)p[15], bn = (int)p[16], stages = (int)p[17], minb = (int)p[18];
  a.nsplit = (int)p[19], a.ksplit = (int)p[20];
  const int eps_bits = (int)p[21];
  memcpy(&qa.eps, &eps_bits, sizeof qa.eps);
  cudaStream_t st = (cudaStream_t)p[22];
  const int kch = (a.K + QKC - 1) / QKC, ntiles = bn > 0 ? (a.N + bn - 1) / bn : 0;
  const int nkc = a.ksplit > 0 ? (kch + a.ksplit - 1) / a.ksplit : 0;
  const int smem = lq_smem(bm, bn, stages, nkc);
  if (a.M < 1 || a.K % 32 != 0 || a.N % 8 != 0 || a.nsplit < 1 || a.nsplit > ntiles ||
      a.ksplit < 1 || a.ksplit > kch || smem > kQMaxSmem || qa.q == nullptr ||
      (a.ksplit > 1 && (a.ws == nullptr || a.tickets == nullptr)) ||
      (qa.ln_w == nullptr) != (qa.ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_q_rows(qa, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.M + bm - 1) / bm), (unsigned)a.nsplit, (unsigned)a.ksplit);
  err = cudaErrorInvalidValue;
#define SDTK_LQ(bm_, bn_, st_, mb_)                                                        \
  if (bm == bm_ && bn == bn_ && stages == st_ && minb == mb_) {                            \
    auto fn = linear_q_kernel<bm_, bn_, st_, mb_>;                                         \
    static bool ready = false; /* the shared-memory limit, set once (one card) */         \
    err = ready ? cudaSuccess                                                              \
                : cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kQMaxSmem); \
    ready = err == cudaSuccess;                                                            \
    if (err == cudaSuccess) {                                                              \
      fn<<<grid, 2 * bm_, smem, st>>>(a);                                                  \
      err = cudaGetLastError();                                                            \
    }                                                                                      \
  }
  SDTK_LQ_VARIANTS(SDTK_LQ)
#undef SDTK_LQ
  return (int)err;
}

// The first launch alone (K9's: its LayerNorm and first quantize), its
// arguments packed as int64: x, ln_w, ln_b, sx, q (pointers), M, K, eps
// (its f32 bits), stream.  K % 8 == 0, x and q 16-byte aligned; ln_w and
// ln_b both given or both null.
extern "C" int sdtk_q_rows(const long long* p) {
  using namespace sdtk;
  QuantArgs qa;
  qa.x = (const bf16*)p[0];
  qa.ln_w = (const bf16*)p[1];
  qa.ln_b = (const bf16*)p[2];
  qa.sx = (const float*)p[3];
  qa.q = (int8_t*)p[4];
  qa.M = (int)p[5], qa.K = (int)p[6];
  const int eps_bits = (int)p[7];
  memcpy(&qa.eps, &eps_bits, sizeof qa.eps);
  if (qa.M < 1 || qa.K % 8 != 0 || qa.x == nullptr || qa.q == nullptr ||
      (qa.ln_w == nullptr) != (qa.ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_q_rows(qa, (cudaStream_t)p[8]);
}

// A compiled variant from the runtime, its shared memory for nkc resident
// K chunks: out = {registers a thread, local (spill) bytes a thread, shared
// bytes a block, resident blocks an SM}.
extern "C" int sdtk_linear_q_attrs(int bm, int bn, int stages, int minb, int nkc, int* out) {
  using namespace sdtk;
#define SDTK_LQ_ATTRS(bm_, bn_, st_, mb_)                                  \
  if (bm == bm_ && bn == bn_ && stages == st_ && minb == mb_)              \
    return lq_attrs_of(linear_q_kernel<bm_, bn_, st_, mb_>, 2 * bm_,       \
                       lq_smem(bm_, bn_, st_, nkc), out);
  SDTK_LQ_VARIANTS(SDTK_LQ_ATTRS)
#undef SDTK_LQ_ATTRS
  return (int)cudaErrorInvalidValue;
}
