// K9: static-W8A8 LayerNorm -> GeGLU FFN -> +residual: LN -> quantize with
// the first linear's step -> int8 value and gate products -> dequantize ->
// GeGLU in f32 -> requantize with the second linear's step -> int8 W2
// product -> dequantize, +b2, +residual.
//
// Replaces: stable_diffusion_tpu/ops/ffn.py:319 int8 `_make_q_kernel`
// (launched by `_ffn_q`, reached through `geglu_ffn` with W8A8 parameters).
//
// What bounds it on Hopper: the products, 6 M C H operations (x W1 is 4 M C
// H, h W2 2 M C H; 80.5 GOP at (M, C, H) = (32768, 320, 1280), 41 us at
// 1979 TOP/s), far above the int8 ridge (~590 operations a byte) at every
// path shape.  So the products must run at the wgmma rate, with the LN, the
// quantizers and the GeGLU off their critical path.
//
// Design: K4's two-GEMM structure in s8 (csrc/ffn.cu), with K8's quantize
// launch in front; three launches:
// * Launch 1: K8's quantize_rows_kernel (csrc/linear_q.cu, called through
//   sdtk_q_rows): each row LayerNormed (f32 two-pass statistics) and
//   quantized once with the first linear's step into an int8 (M, C)
//   scratch.
// * Launch 2, G1 (ffn_q_up_kernel): h = quantize(GeGLU(x_q W1^T)).  K8's
//   GEMM shape: a block owns BM rows (a warpgroup each 64), its int8 rows of
//   all of C kept in shared memory (C <= 1280: at most 160 KB at BM = 128),
//   and walks a contiguous range of G1 tiles (the plan's nsplit ranges a
//   row block); W1 comes through a STAGES-deep cp.async ring of 128-row x
//   128-byte slabs, one step's products in flight across the next step's
//   barrier; s8 wgmma reads both operands by descriptor.  W1 stays in
//   PyTorch's layout; the slab loads pair its rows as K4's G1 does: each 64
//   slab rows are 32 value rows, then the 32 gate rows of the same hidden
//   units, so a thread's accumulators hold each value beside its gate.  The
//   epilogue, in f32: hv = acc_v * os1[j] + b1[j], hg = acc_g * os1[H + j]
//   + b1[H + j], hv * gelu_erf(hg), quantize_s8_rcp with the second
//   linear's step; the tile's int8 (64 rows x 64 units a warpgroup) is
//   staged in a free ring slot and stored in 16-byte rows into an int8
//   (M, H) scratch.  A tile's os1 and b1 come with its first slab into a
//   side buffer (K8's).
// * Launch 3, G2 (ffn_q_down_kernel): out = h_q W2^T * os2 + b2 +
//   residual, in f32, rounded once.  K4's G2 in s8: both operands, BM rows
//   of h and BN rows of W2, streamed through one ring, so no K split and no
//   atomics; one tile a block; the tile staged in the ring and stored in
//   16-byte rows.  K8's GEMM on the int8 h (its rows of all of H kept in
//   shared memory where they fit, else K split with int32 atomics and a
//   ticket) was measured beside it at the four path shapes and lost at all
//   four, 1.2x at H = 1280 and 2.7-5.7x where it splits K (PERF.md), so it
//   is not a form of K9.
// * What is gone: the first design (mma.sync) split the hidden range over
//   blocks, re-ran the LN and the quantizer in every split (IEEE division),
//   multiplied on mma.sync m16n8k32 through a two-stage register ring and
//   wrote int32 (nsplit, M, C) slices (126 MB each way at (32768, 320,
//   1280)) that a second kernel summed.  Here the int8 x (10.5 MB) and the
//   int8 h (42 MB) each make one round trip instead.
// ffn_q_plan (ops/ffn.py) mirrors the dispatch.
// Not yet: TMA and a producer warp (every thread issues cp.async), a
// persistent tile loop, G1 blocks that keep their W1 tile and walk rows.
#include <math.h>
#include <string.h>

#include "mma.cuh"
#include "wgmma.cuh"

// K8's quantize launch (csrc/linear_q.cu).
extern "C" int sdtk_q_rows(const long long* p);

namespace sdtk {
namespace {

constexpr int FQK = 128;   // K bytes a step: one 128-byte swizzled row of int8
constexpr int G1N = 128;   // W1 rows a G1 tile: (32 values, 32 gates) x 2 = 64 hidden units
constexpr int kFqMaxSmem = 232448;  // 227 KB a block may use on Hopper

// Byte offset of 16-byte piece j of 128-byte row r in the 128-byte swizzle.
__device__ __forceinline__ uint32_t fswz(int r, int j) {
  return (uint32_t)(r * FQK + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// G1's shared bytes: 1024 to align the ring, the ring, the block's int8
// rows (kch 128-byte chunks), three tiles' side buffers (os1 f32 and b1
// bf16 of the tile's 128 W1 rows).  G2's: the ring of (BM + BN) rows a
// step.
__host__ __device__ constexpr int g1_side() { return G1N * 6; }
__host__ __device__ constexpr int g1_smem(int BM, int STAGES, int kch) {
  return 1024 + STAGES * G1N * FQK + BM * kch * FQK + 3 * g1_side();
}
__host__ __device__ constexpr int g2_smem(int BM, int BN, int STAGES) {
  return 1024 + STAGES * (BM + BN) * FQK;
}

// The W1 row that slab row r of G1 tile t holds: hidden unit u = 64 t +
// 32 (r >> 6) + (r & 31), its value row, or its gate row H + u for r & 32.
__device__ __forceinline__ int w1_row(int t, int r, int H) {
  const int u = t * 64 + (r >> 6) * 32 + (r & 31);
  return (r & 32) ? H + u : u;
}

struct G1Args {
  const int8_t* q;    // (M, C) the LN'd rows' codes
  const int8_t* w1;   // (2H, C): value rows [0, H), gate rows [H, 2H)
  const float* os1;   // (2H) s1 * w1 scale
  const bf16* b1;     // (2H)
  const float* s2;    // (1) the second linear's activation step
  int8_t* h;          // (M, H) the GeGLU output's codes
  int M, C, H, nsplit;
};

// G1: BM rows (a warpgroup each 64) x 128 W1 rows a tile; grid (row block, N split).
template <int BM, int STAGES, int MINB>
__global__ void __launch_bounds__(2 * BM, MINB) ffn_q_up_kernel(G1Args a) {
  constexpr int THREADS = 2 * BM, LOOK = STAGES - 2, SLAB = G1N * FQK, SIDE = g1_side();
  static_assert(STAGES >= 3, "products stay in flight across a barrier: three stages at least");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t abase = ring + STAGES * SLAB;  // chunk j of the rows at abase + j * BM * FQK

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int M = a.M, C = a.C, H = a.H;
  const int m0 = blockIdx.x * BM;
  const int ntiles = H / 64, kch = (C + FQK - 1) / FQK;
  const int t0 = blockIdx.y * ntiles / a.nsplit, t1 = (blockIdx.y + 1) * ntiles / a.nsplit;
  const int nsteps = (t1 - t0) * kch;
  const int j8 = tid & 7;
  const uint32_t sbase = abase + BM * kch * FQK;  // tile i's side buffer at sbase + (i % 3) * SIDE
  const unsigned char* side = smem_raw + (sbase - raw);

  // Step s's W1 slab (tile t0 + s / kch, chunk s % kch) into stage s %
  // STAGES, K past C zero-filled; the first tile's steps also bring the
  // block's int8 rows, a chunk each (rows past M zero-filled); a tile's
  // first step its os1 and b1 in slab order (16 bytes a copy: 4 scales or 8
  // biases, which never straddle a 32-row value or gate run) into side
  // buffer (tile - t0) % 3, read at the tile's last step and rewritten
  // (tile + 3) only two tiles later (K8's argument).
  auto load_slab = [&](int s) {
    const int t = t0 + s / kch, kc = s % kch, k = kc * FQK + j8 * 16;
    const uint32_t dst = ring + (s % STAGES) * SLAB;
#pragma unroll
    for (int i = 0; i < G1N * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8);
      const bool ok = k < C;
      cp_async16(dst + fswz(r, j8), ok ? a.w1 + (long)w1_row(t, r, H) * C + k : a.w1, ok);
    }
    if (s < kch) {
      const uint32_t adst = abase + s * BM * FQK;
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int r = (tid >> 3) + i * (THREADS / 8);
        const bool ok = m0 + r < M && k < C;
        cp_async16(adst + fswz(r, j8), ok ? a.q + (long)(m0 + r) * C + k : a.q, ok);
      }
    }
    if (kc == 0 && tid < G1N / 4 + G1N / 8) {
      const uint32_t sd = sbase + ((s / kch) % 3) * SIDE;
      if (tid < G1N / 4)
        cp_async16(sd + 16 * tid, a.os1 + w1_row(t, 4 * tid, H), true);
      else
        cp_async16(sd + G1N * 4 + 16 * (tid - G1N / 4), a.b1 + w1_row(t, 8 * (tid - G1N / 4), H), true);
    }
  };
#pragma unroll
  for (int s = 0; s < LOOK; ++s) {
    if (s < nsteps) load_slab(s);
    cp_async_commit();
  }

  const int g = lane >> 2, tq = lane & 3;
  const float s2 = *a.s2, inv2 = 1.f / s2;
  int acc[G1N / 2];
#pragma unroll
  for (int i = 0; i < G1N / 2; ++i) acc[i] = 0;

  // Tile t's epilogue at its last step s: each 64 columns of the tile are
  // 32 values (n8 tiles 0-3 of the 64), then their 32 gates (4-7).  The
  // warpgroup's 64 rows x 64 units of codes go through ring slot (s - wg) %
  // STAGES (free once both warpgroups' products of steps s - 1 and s are
  // done: the caller's barrier) and leave in 16-byte rows.
  auto store = [&](int t, int s) {
    const float* so = reinterpret_cast<const float*>(side + (t - t0) % 3 * SIDE);
    const bf16* sb = reinterpret_cast<const bf16*>(side + (t - t0) % 3 * SIDE + G1N * 4);
    unsigned char* stg = smem_raw + (ring - raw) + (s + STAGES - wg) % STAGES * SLAB;
    const int lr = (warp & 3) * 16 + g;  // the thread's rows lr, lr + 8 of the warpgroup's 64
#pragma unroll
    for (int pb = 0; pb < 2; ++pb) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cv = pb * 64 + ni * 8 + 2 * tq, cg = cv + 32;  // a value's column, its gate's
        const float2 sv = *reinterpret_cast<const float2*>(so + cv);
        const float2 sg = *reinterpret_cast<const float2*>(so + cg);
        const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sb + cv));
        const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sb + cg));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int iv = 4 * (pb * 8 + ni) + 2 * hh, ig = iv + 16;
          const int c0 = quantize_s8_rcp(((float)acc[iv] * sv.x + bv.x) *
                                             gelu_erf((float)acc[ig] * sg.x + bg.x), s2, inv2);
          const int c1 = quantize_s8_rcp(((float)acc[iv + 1] * sv.y + bv.y) *
                                             gelu_erf((float)acc[ig + 1] * sg.y + bg.y), s2, inv2);
          *reinterpret_cast<uint16_t*>(stg + (lr + 8 * hh) * 64 + pb * 32 + ni * 8 + 2 * tq) =
              (uint16_t)((c0 & 0xff) | ((c1 & 0xff) << 8));
        }
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's codes are staged
    for (int i = tid & 127; i < 64 * 4; i += 128) {
      const int r = i >> 2, cc = i & 3;
      const int row = m0 + wg * 64 + r;
      if (row < M)  // H % 64 == 0: whole 16-byte pieces
        *reinterpret_cast<uint4*>(a.h + (long)row * H + t * 64 + cc * 16) =
            *reinterpret_cast<const uint4*>(stg + r * 64 + cc * 16);
    }
  };

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<LOOK - 1>();
    fence_async_shared();  // the landed slab (and rows), for wgmma
    __syncthreads();       // slab s is in; the stage refilled below was read two steps ago
    if (s + LOOK < nsteps) load_slab(s + LOOK);
    cp_async_commit();
    const int kc = s % kch;
    const uint64_t da = sw128_desc(abase + kc * BM * FQK + wg * 64 * FQK);
    const uint64_t db = sw128_desc(ring + (s % STAGES) * SLAB);
    const int nk32 = min(FQK, C - kc * FQK) / 32;  // k32 steps inside C
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FQK / 32; ++kk)
      if (kk < nk32) WgmmaS8<G1N>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    if (kc != kch - 1) {
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait0();
    fence_operands(acc);
    // Two warpgroups read slabs s - 1 and s: both must be done with them
    // before either stages its codes there.
    if constexpr (BM > 64) __syncthreads();
    store(t0 + s / kch, s);
#pragma unroll
    for (int i = 0; i < G1N / 2; ++i) acc[i] = 0;
  }
  cp_async_wait<0>();
}

struct G2Args {
  const int8_t* h;    // (M, H) codes
  const int8_t* w2;   // (C, H)
  const float* os2;   // (C) s2 * w2 scale
  const bf16* b2;     // (C)
  const bf16* res;    // (M, C) or null
  bf16* out;          // (M, C)
  int M, C, H;
};

// G2: BM rows (a warpgroup each 64) x BN columns, both
// operands through one ring; grid (column block, row block), so a row
// block's column blocks run together and read its h from L2.
template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(2 * BM) ffn_q_down_kernel(G2Args a) {
  constexpr int THREADS = 2 * BM, LOOK = STAGES - 2, STAGE = (BM + BN) * FQK;
  static_assert(STAGES >= 3 && STAGE % 1024 == 0, "whole swizzle atoms, a step in flight");
  static_assert(BM * BN * 2 <= STAGES * STAGE, "the output tile stages in the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int M = a.M, C = a.C, H = a.H;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nsteps = (H + FQK - 1) / FQK;
  const int j8 = tid & 7;

  // Step s: rows m0.. of h and rows n0.. of W2 at K chunk s.
  auto load = [&](int s) {
    const int k = s * FQK + j8 * 16;
    const uint32_t dst = ring + (s % STAGES) * STAGE;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8);
      const bool ok = m0 + r < M && k < H;
      cp_async16(dst + fswz(r, j8), ok ? a.h + (long)(m0 + r) * H + k : a.h, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8);
      const bool ok = n0 + r < C && k < H;
      cp_async16(dst + BM * FQK + fswz(r, j8), ok ? a.w2 + (long)(n0 + r) * H + k : a.w2, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < LOOK; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<LOOK - 1>();
    fence_async_shared();
    __syncthreads();
    if (s + LOOK < nsteps) load(s + LOOK);
    cp_async_commit();
    const uint32_t st = ring + (s % STAGES) * STAGE;
    const uint64_t da = sw128_desc(st + wg * 64 * FQK), db = sw128_desc(st + BM * FQK);
    const int nk32 = min(FQK, H - s * FQK) / 32;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FQK / 32; ++kk)
      if (kk < nk32) WgmmaS8<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait0();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: the output tile stages there

  // Epilogue: acc[4 ni ..] holds rows g, g + 8 at columns 8 ni + 2 tq, +1;
  // acc * os2 + b2 (+ residual) in f32, one rounding, staged as the
  // warpgroup's 64 x BN bf16 rows, stored in 16-byte pieces.
  const int g = lane >> 2, tq = lane & 3;
  unsigned char* stg = smem_raw + (ring - raw) + wg * 64 * BN * 2;
  const int lr = (warp & 3) * 16 + g;
#pragma unroll
  for (int ni = 0; ni < BN / 8; ++ni) {
    const int c = ni * 8 + 2 * tq, col = n0 + c;
    float2 s2 = make_float2(0.f, 0.f), b2 = s2;
    if (col < C) {  // C % 8 == 0: col and col + 1 together
      s2 = *reinterpret_cast<const float2*>(a.os2 + col);
      b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b2 + col));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wg * 64 + lr + 8 * hh;
      float v0 = (float)acc[4 * ni + 2 * hh] * s2.x + b2.x;
      float v1 = (float)acc[4 * ni + 2 * hh + 1] * s2.y + b2.y;
      if (a.res != nullptr && row < M && col < C) {
        const float2 r2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.res + (long)row * C + col));
        v0 += r2.x, v1 += r2.y;
      }
      *reinterpret_cast<uint32_t*>(stg + (lr + 8 * hh) * BN * 2 + c * 2) = pack_bf16(v0, v1);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's tile is staged
  for (int i = tid & 127; i < 64 * BN / 8; i += 128) {
    const int r = i / (BN / 8), cc = i - r * (BN / 8);
    const int row = m0 + wg * 64 + r, col = n0 + cc * 8;
    if (row < M && col < C)
      *reinterpret_cast<uint4*>(a.out + (long)row * C + col) =
          *reinterpret_cast<const uint4*>(stg + r * BN * 2 + cc * 16);
  }
}

template <class F>
int fq_attrs_of(F fn, int threads, int smem, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kFqMaxSmem);
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

// The compiled variants; ffn_q_plan (ops/ffn.py) chooses among them.  G1
// (BM, STAGES, blocks an SM for the launch bound), G2 (BM, BN, STAGES).  The
// H100 sweep (chip_smoke.py --w8a8-sweep, PERF.md) also ran G1 as (128, 4,
// 1) and (64, 4, 2) and G2 as (64, 160, 3): slower at every path shape.
#define SDTK_FFN_Q_UP_VARIANTS(X) X(128, 3, 2)
#define SDTK_FFN_Q_DN_VARIANTS(X) X(128, 160, 4) X(64, 64, 4)

// Arguments packed as int64 (p[i]): x, ln_w, ln_b, w1, s1, os1, b1, w2, s2,
// os2, b2, res, out, xq, hq (pointers), M, C, H, (bm1, st1, minb1) a
// compiled G1 variant, nsplit1, (bm2, bn2, st2) a compiled G2 variant,
// parts, eps (its f32 bits), stream.  Shape rules (checked by the Python
// wrapper, which also plans): C % 32 == 0 and C <= 1280, H % 64 == 0, every
// tensor contiguous, x, w1, w2, xq and hq 16-byte aligned; xq (M, C) and hq
// (M, H) int8 scratch; ln_w and ln_b both given or both null; res may be
// null.  parts & 1 launches the quantize, & 2 G1, & 4 G2: 7 runs the block.
// An unknown variant returns cudaErrorInvalidValue.
extern "C" int sdtk_ffn_q(const long long* p) {
  using namespace sdtk;
  const long long x = p[0], ln_w = p[1], ln_b = p[2], w1 = p[3], s1 = p[4], os1 = p[5], b1 = p[6],
                  w2 = p[7], s2 = p[8], os2 = p[9], b2 = p[10], res = p[11], out = p[12], xq = p[13],
                  hq = p[14];
  const int M = (int)p[15], C = (int)p[16], H = (int)p[17];
  const int bm1 = (int)p[18], st1 = (int)p[19], mb1 = (int)p[20], nsplit1 = (int)p[21];
  const int bm2 = (int)p[22], bn2 = (int)p[23], st2 = (int)p[24], parts = (int)p[25];
  const long long eps_bits = p[26], stream = p[27];
  const int kch = (C + FQK - 1) / FQK;
  if (M < 1 || C % 32 != 0 || C > 1280 || H % 64 != 0 || xq == 0 || hq == 0 || nsplit1 < 1 ||
      nsplit1 > H / 64 || g1_smem(bm1, st1, kch) > kFqMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (parts & 1) {
    const long long q[9] = {x, ln_w, ln_b, s1, xq, M, C, eps_bits, stream};
    const int err = sdtk_q_rows(q);
    if (err != 0) return err;
  }
  cudaError_t err = cudaSuccess;
  if (parts & 2) {
    G1Args u{(const int8_t*)xq, (const int8_t*)w1, (const float*)os1, (const bf16*)b1,
             (const float*)s2, (int8_t*)hq, M, C, H, nsplit1};
    const int smem = g1_smem(bm1, st1, kch);
    const dim3 grid((unsigned)((M + bm1 - 1) / bm1), (unsigned)nsplit1);
    err = cudaErrorInvalidValue;
#define SDTK_FQ_UP(bm_, st_, mb_)                                                              \
  if (bm1 == bm_ && st1 == st_ && mb1 == mb_) {                                                \
    auto fn = ffn_q_up_kernel<bm_, st_, mb_>;                                                  \
    static bool ready = false; /* the shared-memory limit, set once (one card) */             \
    err = ready ? cudaSuccess                                                                  \
                : cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kFqMaxSmem); \
    ready = err == cudaSuccess;                                                                \
    if (err == cudaSuccess) {                                                                  \
      fn<<<grid, 2 * bm_, smem, st>>>(u);                                                      \
      err = cudaGetLastError();                                                                \
    }                                                                                          \
  }
    SDTK_FFN_Q_UP_VARIANTS(SDTK_FQ_UP)
#undef SDTK_FQ_UP
    if (err != cudaSuccess) return (int)err;
  }
  if (!(parts & 4)) return 0;
  G2Args d{(const int8_t*)hq, (const int8_t*)w2, (const float*)os2, (const bf16*)b2,
           (const bf16*)res, (bf16*)out, M, C, H};
  const dim3 grid((unsigned)((C + bn2 - 1) / bn2), (unsigned)((M + bm2 - 1) / bm2));
  const int smem = g2_smem(bm2, bn2, st2);
  err = cudaErrorInvalidValue;
#define SDTK_FQ_DN(bm_, bn_, st_)                                                              \
  if (bm2 == bm_ && bn2 == bn_ && st2 == st_) {                                                \
    auto fn = ffn_q_down_kernel<bm_, bn_, st_>;                                                \
    static bool ready = false;                                                                 \
    err = ready ? cudaSuccess                                                                  \
                : cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kFqMaxSmem); \
    ready = err == cudaSuccess;                                                                \
    if (err == cudaSuccess) {                                                                  \
      fn<<<grid, 2 * bm_, smem, st>>>(d);                                                      \
      err = cudaGetLastError();                                                                \
    }                                                                                          \
  }
  SDTK_FFN_Q_DN_VARIANTS(SDTK_FQ_DN)
#undef SDTK_FQ_DN
  return (int)err;
}

// A compiled variant from the runtime: kernel 0 is G1 (bm, stages, minb;
// shared memory for width C), kernel 1 G2 (bm, bn, stages);
// out = {registers a thread, local (spill) bytes a thread, shared bytes a
// block, resident blocks an SM}.
extern "C" int sdtk_ffn_q_attrs(int kernel, int bm, int bn, int stages, int minb, int C, int* out) {
  using namespace sdtk;
#define SDTK_FQ_UP_ATTRS(b_, s_, m_)                                                       \
  if (kernel == 0 && bm == b_ && stages == s_ && minb == m_)                               \
    return fq_attrs_of(ffn_q_up_kernel<b_, s_, m_>, 2 * b_, g1_smem(b_, s_, (C + FQK - 1) / FQK), out);
  SDTK_FFN_Q_UP_VARIANTS(SDTK_FQ_UP_ATTRS)
#undef SDTK_FQ_UP_ATTRS
#define SDTK_FQ_DN_ATTRS(b_, n_, s_)                                                       \
  if (kernel == 1 && bm == b_ && bn == n_ && stages == s_)                                 \
    return fq_attrs_of(ffn_q_down_kernel<b_, n_, s_>, 2 * b_, g2_smem(b_, n_, s_), out);
  SDTK_FFN_Q_DN_VARIANTS(SDTK_FQ_DN_ATTRS)
#undef SDTK_FQ_DN_ATTRS
  return (int)cudaErrorInvalidValue;
}
