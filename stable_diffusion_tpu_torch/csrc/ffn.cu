// K4: LayerNorm -> GeGLU up-projection -> down-projection -> +b2 ->
// +residual, the spatial transformer's feed-forward block, as two `wgmma`
// GEMMs with a fused prologue and epilogues.
//
// Replaces: stable_diffusion_tpu/ops/ffn.py:67 bf16 `_make_kernel` (launched
// by `_ffn_call`, reached through `geglu_ffn` -> `_ln_ffn_res`).
//
// The hidden width H is 4C in a whole model and 4C / tp on a rank of a
// tensor-parallel mesh (parallel/mesh.py: each rank holds matching value
// and gate halves of W1 and the matching columns of W2); H % 64 == 0.
//
// What bounds it on Hopper: the products, 6*M*C*H FLOPs (x W1 is 4 M C H,
// h W2 2 M C H; 20 GFLOP at every full SD1.5 site), on the tensor cores:
// far above the ~295 FLOP/byte ridge at every path shape but the 77-token
// sized M.  So the products must run at the wgmma rate, and the weights
// must not be re-streamed from L2 by small row blocks.
//
// Why two kernels: the fused form (the first design, WMMA) kept a block's (BM
// x 4C) GeGLU slab on chip, but at C = 1280 that slab and the (BM x C)
// accumulators cannot sit in a warpgroup's registers, so it split the
// hidden range over blocks and wrote an f32 (nsplit, M, C) workspace that
// a second kernel summed (31 MB at (8192, 320)); it lost to two cuBLAS
// products.  Here the bf16 h (M x 4C) makes one round trip instead (42 MB
// at (8192, 320), ~12.5 us, against >= 20 us of products).
//
// G1: h = (LN(x) W1^T + b1), split into value and gate, value * gelu_erf(gate).
// h is (M, H); W1 (2H, C), its first H rows the values.
// * A block owns BM rows (128: two warpgroups of 64 rows, where the rows'
//   A fits shared memory with the ring; else 64, the two warpgroups
//   splitting N) and a contiguous range of N tiles.  Its rows of x are
//   copied once with cp.async into shared memory in the 128-byte swizzle
//   (one 64-channel chunk a region), LayerNormed in place (f32 statistics,
//   two passes over registers, one warp a row), and taken by `ldmatrix`
//   for every N tile: wgmma's A comes from registers.
// * W1 stays in PyTorch's layout; G1's loads pair its rows: each 64 rows
//   of a slab are 32 value rows, then the 32 gate rows of the same hidden
//   units (slab row r of tile t is W1 row u, or H + u for r & 32, with u
//   = 64 t + 32 (r >> 6) + (r & 31)), so a warpgroup's accumulators hold
//   each value beside its gate and the GeGLU is taken in the epilogue, in
//   f32 with erff, stored as bf16 pairs (the tile's biases fetched while
//   its last products run).  (A W1 re-laid once in that order and cached
//   would cost 200 MB at SD1.5's width for nothing the addresses cannot
//   do.)  A block tile is 128 such rows (64 hidden units), fed through a
//   STAGES-deep cp.async ring (K2's: one commit group and one barrier a
//   64-channel step) that wgmma reads by descriptor.
// * Two pipelines (Pipe below).  At C = 320 a two-slab ring with each
//   step waiting for its own products lets two blocks share an SM, so one
//   block's GeGLU epilogue and LayerNorm run under the other's products;
//   at C = 640 and 1280 (one block an SM) a four-slab ring keeps one
//   step's products in flight across the next step's barrier.
// G2: out = h W2^T + b2 + residual.
// * One warpgroup a block, two blocks an SM: 64 rows x BN columns (160
//   where C % 160 == 0: 320, 640, 1280; else 128 or 64, columns past C
//   masked); each K step a 64-row slab of h and a BN-row slab of W2
//   (K-contiguous as PyTorch keeps it) through one ring, A by `ldmatrix`,
//   B by descriptor; the f32 epilogue adds b2 and the residual and stores
//   bf16.  The grid runs a row block's column blocks together, so its
//   slab of h is read from L2 once it is in.
// * Where the output tiles leave most SMs idle (tiles <= SMs / 2: M <= 512
//   at C = 1280), K is split over blocks that write f32 partials, and
//   ffn_reduce adds them in split order with b2 and the residual: the result
//   is deterministic.
// ffn_plan (ops/ffn.py) mirrors the dispatch: the variants, the N split of
// G1 and the K split of G2, and each kernel's shared memory.  The H100
// sweep (chip_smoke.py --k4-sweep, PERF.md) also measured G1 with
// synchronous four-slab rings and G2 in 128-row blocks with six-slab rings
// (synchronous or not): none was faster per pass, so they are not built.
// Not yet: TMA and a producer warp (every thread issues cp.async), a
// persistent tile loop, products nearer the bound (on an H100 at 700 W
// G1 and G2 run ~180-200 TFLOP/s at (8192, 320)).
#include <string.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace sdtk {
namespace {

constexpr int KC = 64;           // channels a K step (one 128-byte swizzled row)
constexpr int RB = KC * 2;       // bytes of a K step's row
constexpr int UP_THREADS = 256;  // G1: two warpgroups
constexpr int UP_N = 128;        // G1: W1 rows (paired) a block tile: 64 hidden units
constexpr int MAX_C = 1280;      // the LN prologue's registers: C / 8 vectors <= 5 a lane
constexpr int kMaxSmem = 232448;  // 227 KB a block may use on Hopper

// Byte offset of 16-byte piece j of 128-byte row r, XOR-swizzled by the row
// (Hopper's 128-byte swizzle from 1024-byte aligned regions).
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * RB + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Shared bytes: 1024 to align the ring, the ring, and (G1) the block's rows
// of x, one 128-byte row a K step.
__host__ __device__ constexpr int up_smem(int BM, int STAGES, int C) {
  return 1024 + STAGES * UP_N * RB + BM * ((C + KC - 1) / KC) * RB;
}
__host__ __device__ constexpr int dn_smem(int BM, int BN, int STAGES) {
  return 1024 + STAGES * (BM + BN) * RB;
}

// A pipeline of K steps, one commit group and one barrier a step.  In the
// synchronous form (ASYNC false) a step waits for its own products and the
// ring runs STAGES - 1 slabs ahead; in the asynchronous form one step's
// products stay in flight across the next step's barrier, so the ring runs
// STAGES - 2 ahead and the A fragments alternate between two register sets.
template <int STAGES, bool ASYNC>
struct Pipe {
  static_assert(!ASYNC || STAGES >= 3, "an asynchronous ring needs three stages");
  static constexpr int LOOK = ASYNC ? STAGES - 2 : STAGES - 1;  // slabs loaded ahead
  static __device__ __forceinline__ void wait_products() {
    if constexpr (ASYNC)
      wgmma_wait<1>();
    else
      wgmma_wait0();
  }
};

struct UpArgs {
  const bf16* x;     // (M, C)
  const bf16* ln_w;  // (C)
  const bf16* ln_b;  // (C)
  const bf16* w1;    // (2H, C): value rows, then gate rows
  const bf16* b1;    // (2H) PyTorch's order: value biases, then gate biases
  bf16* h;           // (M, H)
  int M, C, H, nsplit;
  float eps;
};

template <int BM, int STAGES, bool ASYNC>
__global__ void __launch_bounds__(UP_THREADS, STAGES == 2 ? 2 : 1) ffn_up_kernel(UpArgs a) {
  using P = Pipe<STAGES, ASYNC>;
  constexpr int NWG = BM == 128 ? UP_N : UP_N / 2;  // columns of a warpgroup's product
  constexpr int NP = NWG / 64;                      // (32 values, 32 gates) pairs of them
  constexpr int SLAB = UP_N * RB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (ring - raw);
  const uint32_t abase = ring + STAGES * SLAB;  // chunk kc of the rows at abase + kc * BM * RB
  unsigned char* as = smem + STAGES * SLAB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int wg_m = BM == 128 ? wg * 64 : 0, wg_n = BM == 128 ? 0 : wg * NWG;
  const int C = a.C, H = a.H;
  const int kchunks = (C + KC - 1) / KC;
  const int m0 = blockIdx.x * BM;
  const int ntiles = H / 64;  // 2H / UP_N
  const int t0 = blockIdx.y * ntiles / a.nsplit, t1 = (blockIdx.y + 1) * ntiles / a.nsplit;
  const int nsteps = (t1 - t0) * kchunks;  // one step a (tile, K chunk)
  const int j8 = tid & 7;

  // Step s's W1 slab (tile t0 + s / kchunks, chunk s % kchunks) into stage s % STAGES.
  auto load_slab = [&](int s) {
    const int t = t0 + s / kchunks, k = (s % kchunks) * KC + j8 * 8;
    const uint32_t dst = ring + (s % STAGES) * SLAB;
#pragma unroll
    for (int i = 0; i < UP_N * 8 / UP_THREADS; ++i) {
      const int r = (tid >> 3) + i * (UP_THREADS / 8);
      const int u = t * (UP_N / 2) + (r >> 6) * 32 + (r & 31);  // the row's hidden unit
      const bool ok = k < C;
      cp_async16(dst + swz(r, j8), ok ? a.w1 + (long)((r & 32) ? H + u : u) * C + k : a.w1, ok);
    }
  };
  // The block's rows of x (zero past M and past C), group 0; then the ring.
  for (int p = tid; p < BM * kchunks * 8; p += UP_THREADS) {
    const int r = p / (kchunks * 8), v = p - r * kchunks * 8, c = v * 8;
    const bool ok = m0 + r < a.M && c < C;
    cp_async16(abase + (c / KC) * BM * RB + swz(r, v & 7), ok ? a.x + (long)(m0 + r) * C + c : a.x, ok);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < P::LOOK; ++s) {
    if (s < nsteps) load_slab(s);
    cp_async_commit();
  }
  // LayerNorm in place, one warp a row: the lane's vectors v = lane + 32 i.
  cp_async_wait<P::LOOK>();
  __syncthreads();
  {
    constexpr int NV = MAX_C / 8 / 32;
    Pack8 gw[NV], gb[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c < C) {
        gw[i].u = *reinterpret_cast<const uint4*>(a.ln_w + c);
        gb[i].u = *reinterpret_cast<const uint4*>(a.ln_b + c);
      }
    }
    for (int r = warp; r < BM && m0 + r < a.M; r += UP_THREADS / 32) {
      Pack8 xv[NV];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (lane + 32 * i) * 8;
        if (c < C) {
          xv[i] = *reinterpret_cast<const Pack8*>(as + (c / KC) * BM * RB + swz(r, (c / 8) & 7));
#pragma unroll
          for (int k = 0; k < 8; ++k) s += to_f(xv[i].h[k]);
        }
      }
      const float mean = warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if ((lane + 32 * i) * 8 < C) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float d = to_f(xv[i].h[k]) - mean;
            q += d * d;
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(q) / C + a.eps);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (lane + 32 * i) * 8;
        if (c < C) {
          Pack8 o;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            o.h[k] = to_bf((to_f(xv[i].h[k]) - mean) * rstd * to_f(gw[i].h[k]) + to_f(gb[i].h[k]));
          *reinterpret_cast<Pack8*>(as + (c / KC) * BM * RB + swz(r, (c / 8) & 7)) = o;
        }
      }
    }
  }

  // The main loop: each warp's A rows m_a, ldmatrix'd per step; B by descriptor.
  const int m_a = wg_m + (warp & 3) * 16 + (lane & 15);
  const uint64_t desc0 = sw128_desc(ring + wg_n * RB);
  const int g = lane >> 2, tq = lane & 3;
  float acc[NWG / 2];
#pragma unroll
  for (int k = 0; k < NWG / 2; ++k) acc[k] = 0.f;
  auto step = [&](int s, uint32_t (&af)[KC / 16][4]) {
    cp_async_wait<P::LOOK - 1>();
    fence_async_shared();
    __syncthreads();  // slab s (and, at s = 0, the LN'd rows) is in; the slot refilled is free
    if (s + P::LOOK < nsteps) load_slab(s + P::LOOK);
    cp_async_commit();
    const int kc = s % kchunks;
    const uint32_t arow = abase + kc * BM * RB;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) ldmatrix_x4(af[kk], arow + swz(m_a, 2 * kk + (lane >> 4)));
    const uint64_t desc = desc0 + (uint64_t)(((s % STAGES) * SLAB) >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) Wgmma<NWG>::mma(acc, af[kk], desc + 2 * kk);
    wgmma_commit();
    if (kc != kchunks - 1) {
      P::wait_products();
      return;
    }
    // Epilogue of tile t: each 64 columns are 32 values (n8 tiles 0-3), then
    // their 32 gates (4-7); h = (v + bv) gelu(g + bg), stored as bf16 pairs.
    // The biases are fetched while the last products run.
    const int pblk = ((t0 + s / kchunks) * UP_N + wg_n) / 64;
    __nv_bfloat162 bv[NP][4], bg[NP][4];
#pragma unroll
    for (int pb = 0; pb < NP; ++pb) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int j = (pblk + pb) * 32 + ni * 8 + 2 * tq;
        bv[pb][ni] = *reinterpret_cast<const __nv_bfloat162*>(a.b1 + j);
        bg[pb][ni] = *reinterpret_cast<const __nv_bfloat162*>(a.b1 + H + j);
      }
    }
    wgmma_wait0();
    fence_operands(acc);
#pragma unroll
    for (int pb = 0; pb < NP; ++pb) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int j = (pblk + pb) * 32 + ni * 8 + 2 * tq;
        const float2 v2 = __bfloat1622float2(bv[pb][ni]), g2 = __bfloat1622float2(bg[pb][ni]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + wg_m + (warp & 3) * 16 + g + 8 * hh;
          const int iv = 4 * (pb * 8 + ni) + 2 * hh, ig = iv + 16;  // a value, its gate
          if (row < a.M)
            *reinterpret_cast<uint32_t*>(a.h + (long)row * H + j) =
                pack_bf16((acc[iv] + v2.x) * gelu_erf(acc[ig] + g2.x),
                          (acc[iv + 1] + v2.y) * gelu_erf(acc[ig + 1] + g2.y));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NWG / 2; ++k) acc[k] = 0.f;
  };
  uint32_t af0[KC / 16][4], af1[KC / 16][4];
  for (int s = 0; s < nsteps; s += 2) {  // two steps a turn: the A registers alternate
    step(s, af0);
    if (s + 1 < nsteps) step(s + 1, af1);
  }
  cp_async_wait<0>();
}

struct DnArgs {
  const bf16* h;     // (M, K): K = H
  const bf16* w2;    // (C, K)
  const bf16* b2;    // (C)
  const bf16* res;   // (M, C) or null
  bf16* out;         // (M, C)
  float* ws;         // (ksplit, M, C) f32 partials when ksplit > 1
  int M, C, K, ksplit;
};

// G2: BM rows (a warpgroup each 64) x BN columns; grid (column block, row
// block, split), so the column blocks of one row block run together and
// read its slab of h from L2.
template <int BM, int BN, int STAGES, bool ASYNC>
__global__ void __launch_bounds__(2 * BM) ffn_down_kernel(DnArgs a) {
  using P = Pipe<STAGES, ASYNC>;
  constexpr int THREADS = 2 * BM;
  constexpr int STAGE = (BM + BN) * RB;
  static_assert(STAGE % 1024 == 0, "128-byte swizzle atoms");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kch = K / KC;
  const int c_begin = blockIdx.z * kch / a.ksplit, c_end = (blockIdx.z + 1) * kch / a.ksplit;
  const int nsteps = c_end - c_begin;
  const int j8 = tid & 7;

  // Step s: rows m0.. of h and rows n0.. of W2 at K chunk c_begin + s.
  auto load = [&](int s) {
    const int k = (c_begin + s) * KC + j8 * 8;
    const uint32_t dst = ring + (s % STAGES) * STAGE;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8);
      const bool ok = m0 + r < a.M;
      cp_async16(dst + swz(r, j8), ok ? a.h + (long)(m0 + r) * K + k : a.h, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8);
      const bool ok = n0 + r < C;
      cp_async16(dst + BM * RB + swz(r, j8), ok ? a.w2 + (long)(n0 + r) * K + k : a.w2, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < P::LOOK; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  const int m_a = warp * 16 + (lane & 15);  // (warp >> 2) * 64 + (warp & 3) * 16
  const uint64_t desc0 = sw128_desc(ring + BM * RB);
  float acc[BN / 2];
#pragma unroll
  for (int k = 0; k < BN / 2; ++k) acc[k] = 0.f;
  auto step = [&](int s, uint32_t (&af)[KC / 16][4]) {
    cp_async_wait<P::LOOK - 1>();
    fence_async_shared();
    __syncthreads();
    if (s + P::LOOK < nsteps) load(s + P::LOOK);
    cp_async_commit();
    const uint32_t st = ring + (s % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) ldmatrix_x4(af[kk], st + swz(m_a, 2 * kk + (lane >> 4)));
    const uint64_t desc = desc0 + (uint64_t)(((s % STAGES) * STAGE) >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) Wgmma<BN>::mma(acc, af[kk], desc + 2 * kk);
    wgmma_commit();
    P::wait_products();
  };
  uint32_t af0[KC / 16][4], af1[KC / 16][4];
  for (int s = 0; s < nsteps; s += 2) {
    step(s, af0);
    if (s + 1 < nsteps) step(s + 1, af1);
  }
  wgmma_wait0();
  fence_operands(acc);
  cp_async_wait<0>();
  // Epilogue: acc[4 ni ..] holds rows g, g + 8 at columns 8 ni + 2 tq, +1.
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < BN / 8; ++ni) {
    const int n = n0 + ni * 8 + 2 * tq;
    if (n >= C) continue;
    const float b0 = a.ksplit > 1 ? 0.f : to_f(a.b2[n]), b1 = a.ksplit > 1 ? 0.f : to_f(a.b2[n + 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + warp * 16 + g + 8 * hh;
      if (row >= a.M) continue;
      float v0 = acc[4 * ni + 2 * hh], v1 = acc[4 * ni + 2 * hh + 1];
      const long o = (long)row * C + n;
      if (a.ksplit > 1) {
        *reinterpret_cast<float2*>(a.ws + (long)blockIdx.z * a.M * C + o) = make_float2(v0, v1);
        continue;
      }
      v0 += b0, v1 += b1;
      if (a.res != nullptr) {
        const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(a.res + o);
        v0 += __low2float(r2), v1 += __high2float(r2);
      }
      *reinterpret_cast<uint32_t*>(a.out + o) = pack_bf16(v0, v1);
    }
  }
}

// out = (sum over splits of ws, in split order) + b2 + residual, cast once.
__global__ void ffn_reduce_kernel(const float* ws, const bf16* b2, const bf16* res, bf16* out, long M,
                                  int C, int ksplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * C) return;
  float s = 0.f;
  for (int z = 0; z < ksplit; ++z) s += ws[z * M * C + i];
  s += to_f(b2[i % C]);
  if (res != nullptr) s += to_f(res[i]);
  out[i] = to_bf(s);
}

template <class F>
int attrs_of(F fn, int threads, int smem, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

// The compiled variants; ffn_plan (ops/ffn.py) chooses among them.
// G1 (BM, STAGES, ASYNC), G2 (BM, BN, STAGES, ASYNC).
#define SDTK_FFN_UP_VARIANTS(X) X(128, 2, 0) X(128, 4, 1) X(64, 4, 1)
#define SDTK_FFN_DN_VARIANTS(X) X(64, 160, 3, 0) X(64, 128, 4, 0) X(64, 64, 6, 0)

// The block, its arguments packed as int64 (a[i]): x, ln_w, ln_b, w1,
// b1, w2, b2, res, h, ws, out (pointers), M, C, H, (bm1, st1, as1) a
// compiled G1 variant, nsplit1, (bm2, bn2, st2, as2) a compiled G2 variant,
// ksplit2, parts, eps (its f32 bits), stream.  Shape rules (checked by the
// Python wrapper, which also plans): C % 16 == 0 and C <= 1280, H % 64 ==
// 0, every tensor contiguous and 16-byte aligned, the G1 variant's
// up_smem within a block, 1 <= nsplit1 <= H / 64, 1 <= ksplit2 <= H / 64
// with ws (ksplit2, M, C) f32 when ksplit2 > 1; h (M, H) bf16 scratch;
// res may be null.  Launches G1 (parts & 1), then G2 and, split, the
// reduce (parts & 2): 3 runs the block; 1 or 2 times one GEMM alone.  An
// unknown variant returns cudaErrorInvalidValue.
extern "C" int sdtk_ffn(const long long* a) {
  using namespace sdtk;
  const void *x = (const void*)a[0], *ln_w = (const void*)a[1], *ln_b = (const void*)a[2],
             *w1 = (const void*)a[3], *b1 = (const void*)a[4], *w2 = (const void*)a[5],
             *b2 = (const void*)a[6], *res = (const void*)a[7];
  void *h = (void*)a[8], *ws = (void*)a[9], *out = (void*)a[10];
  const int M = (int)a[11], C = (int)a[12], H = (int)a[13], bm1 = (int)a[14], st1 = (int)a[15],
            as1 = (int)a[16], nsplit1 = (int)a[17], bm2 = (int)a[18], bn2 = (int)a[19],
            st2 = (int)a[20], as2 = (int)a[21], ksplit2 = (int)a[22], parts = (int)a[23],
            eps_bits = (int)a[24];
  float eps;
  memcpy(&eps, &eps_bits, sizeof eps);
  void* stream = (void*)a[25];
  if (M < 1 || C % 16 != 0 || C > MAX_C || H < 64 || H % 64 != 0 ||
      up_smem(bm1, st1, C) > kMaxSmem || nsplit1 < 1 || nsplit1 > H / 64 || ksplit2 < 1 ||
      ksplit2 > H / KC || (ksplit2 > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    UpArgs u{static_cast<const bf16*>(x),   static_cast<const bf16*>(ln_w),
             static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w1),
             static_cast<const bf16*>(b1),  static_cast<bf16*>(h),
             M, C, H, nsplit1, eps};
    const int smem = up_smem(bm1, st1, C);
    const dim3 grid((unsigned)((M + bm1 - 1) / bm1), (unsigned)nsplit1);
    err = cudaErrorInvalidValue;
#define SDTK_UP(bm, stg, asy)                                                                  \
  if (bm1 == bm && st1 == stg && as1 == asy) {                                                 \
    auto fn = ffn_up_kernel<bm, stg, (bool)asy>;                                               \
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    if (err == cudaSuccess) {                                                                  \
      fn<<<grid, UP_THREADS, smem, st>>>(u);                                                   \
      err = cudaGetLastError();                                                                \
    }                                                                                          \
  }
    SDTK_FFN_UP_VARIANTS(SDTK_UP)
#undef SDTK_UP
    if (err != cudaSuccess || !(parts & 2)) return (int)err;
  }
  DnArgs d{static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
           static_cast<const bf16*>(res), static_cast<bf16*>(out), static_cast<float*>(ws),
           M, C, H, ksplit2};
  const dim3 grid((unsigned)((C + bn2 - 1) / bn2), (unsigned)((M + bm2 - 1) / bm2), (unsigned)ksplit2);
  const int smem = dn_smem(bm2, bn2, st2);
  err = cudaErrorInvalidValue;
#define SDTK_DN(bm, bn, stg, asy)                                                              \
  if (bm2 == bm && bn2 == bn && st2 == stg && as2 == asy) {                                    \
    auto fn = ffn_down_kernel<bm, bn, stg, (bool)asy>;                                         \
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    if (err == cudaSuccess) {                                                                  \
      fn<<<grid, 2 * bm, smem, st>>>(d);                                                       \
      err = cudaGetLastError();                                                                \
    }                                                                                          \
  }
  SDTK_FFN_DN_VARIANTS(SDTK_DN)
#undef SDTK_DN
  if (err != cudaSuccess || ksplit2 == 1) return (int)err;
  const long n = (long)M * C;
  ffn_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(b2), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), M, C, ksplit2);
  return (int)cudaGetLastError();
}

// A compiled variant from the runtime: kernel 0 is G1 (bm, stages, async;
// shared memory for width C), kernel 1 G2 (bm, bn, stages, async); out =
// {registers a thread, local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM}.
extern "C" int sdtk_ffn_attrs(int kernel, int bm, int bn, int stages, int async, int C, int* out) {
  using namespace sdtk;
#define SDTK_UP_ATTRS(b_, s_, a_)                                                          \
  if (kernel == 0 && bm == b_ && stages == s_ && async == a_)                              \
    return attrs_of(ffn_up_kernel<b_, s_, (bool)a_>, UP_THREADS, up_smem(b_, s_, C), out);
  SDTK_FFN_UP_VARIANTS(SDTK_UP_ATTRS)
#undef SDTK_UP_ATTRS
#define SDTK_DN_ATTRS(b_, n_, s_, a_)                                                      \
  if (kernel == 1 && bm == b_ && bn == n_ && stages == s_ && async == a_)                  \
    return attrs_of(ffn_down_kernel<b_, n_, s_, (bool)a_>, 2 * b_, dn_smem(b_, n_, s_), out);
  SDTK_FFN_DN_VARIANTS(SDTK_DN_ATTRS)
#undef SDTK_DN_ATTRS
  return (int)cudaErrorInvalidValue;
}
