// K10: bf16 (LayerNorm ->) matmul -> +bias (-> +residual), and
// K11: bf16 GroupNorm-normalize -> matmul -> +bias, one `wgmma` GEMM with
// three prologues (none, LayerNorm, GroupNorm).
//
// Replaces: stable_diffusion_tpu/ops/linear.py:45 `_make_kernel` (K10;
// launched by `_mm_call`, entries `ln_matmul` and `matmul_residual`) and
// :283 `_gn_mm_kernel` (K11; `_gn_mm_call`, entry `gn_matmul`).  Both sit
// behind SD_TPU_FUSED_MM in the JAX package and here.
//
// What bounds them on Hopper: 2*M*K*N bf16 tensor-core operations against
// (M*K + K*N + M*N (+ M*N residual)) * 2 bytes.  At the UNet's shapes (M =
// 2 x 9216 rows at SD2.1's 768^2 down to 2 x 144, K 320-2560, N 320-3840)
// the 320-wide sites (the largest M) sit near the ridge (989 TFLOP/s /
// 3.35 TB/s ~ 295 FLOP/byte): their time is reading x and writing y (and
// reading the residual); the 640- and 1280-wide ones are above it, bound by
// the products; the 288-row mid-block sites are bound by the weight and by
// how few output tiles they have.  So: x read once and y written once, in
// whole sectors; the prologue taken once per value, not once per column
// block; the products at the wgmma rate; and enough blocks at small M.
//
// The first design ran `mma.sync` from 64 x 128 block tiles with
// operands staged through registers, recomputed each row's LayerNorm
// statistics in every column block (N / 128 re-reads of x), read K11's
// scale/shift a scalar at a time and stored bf16 pairs (half sectors): 3.5x
// `F.linear` a switched SD2.1 pass on an H100.  This design:
// * Two warpgroups a block (256 threads).  BM = 128 rows: a warpgroup each
//   64 rows, every column of the tile; BM = 64: the warpgroups split the
//   tile's BN = 160 columns (m64n80 each).  Both operands are read by
//   descriptor from shared memory in the 128-byte swizzle (one 64-channel
//   K step a 128-byte row): no A fragments in registers.
// * Every load is a TMA box (64 channels x the tile's rows) issued by one
//   thread and counted by an mbarrier; out-of-range rows and channels
//   arrive as zeros.  (Copies issued by every thread, cp.async, left the
//   products waiting for their slabs: PERF.md.)
// * Schedule R, resident A (the LN and GN sites: K <= 1280 at every such
//   site of SD1.5 and SD2.1).  A block owns BM rows and a contiguous range
//   of N tiles (the plan's N split).  Its rows of x come once into shared
//   memory, one 64-channel chunk a region (K4's G1 layout); the prologue
//   runs there in place, once per value, rounded once to bf16 (the TPU
//   kernels' `.astype(x.dtype)` before the dot): LN takes each row's f32
//   statistics in two passes, THREADS / BM threads a row (the LN affine
//   staged in shared memory first); GN applies the row's image's
//   scale/shift (img = row / rows_per_img, so a row block may straddle two
//   images), read as float4s.  The normalized rows then serve every N tile
//   of the block.  The weight (PyTorch's (N, K) layout, K-contiguous)
//   streams through a STAGES-deep ring of 160 x 128-byte slabs.
// * Schedule S, streamed A (the plain and residual sites; K up to 2560,
//   where a block's rows cannot stay resident).  A block owns one BM x 160
//   tile and a contiguous range of K chunks (the plan's K split); each K
//   step's slab of x and slab of W come through one ring.  Where a LN or
//   GN site's rows do not fit shared memory (K > 1280 in the tests, no path
//   site), S takes the prologue too: LN statistics per row over all of K
//   first, then each landed x slab normalized in place.
// * The ring: a stage's "full" mbarrier gates its products; once both
//   warpgroups' products of step s - 1 are done (wgmma_wait<1>) each marks
//   the stage "empty" and the loading thread refills it, so STAGES - 1
//   slabs are in flight and no block barrier is taken a step.
// * Epilogue: acc + bias (+ residual) in f32, one rounding to bf16.  The
//   bias pairs and the residual's 16-byte row pieces are fetched before the
//   tile's last products are waited for; the tile is staged in free ring
//   slots as 64-row x 16-column boxes in the 32-byte swizzle (no bank
//   conflicts for the fragments' 4-byte accesses; K8's lesson: bf16
//   pairs stored from registers wrote half sectors) and written by TMA
//   stores, which read the staging while the next tile's products run.
// * Split K (S only, where the output tiles leave most SMs idle: the mid
//   block's 288 rows, the time-embedding sized M): each part writes an f32
//   partial tile, and linear_reduce_kernel adds the parts in split order
//   with the bias and residual (K4's ffn_reduce): deterministic.
// linear_plan (ops/linear.py) mirrors the dispatch: the schedule and
// variant (BM, BN, STAGES, blocks an SM), the N split, the K split and the
// shared bytes.  Any M, K % 8 == 0, N % 8 == 0: the TPU geometry gates (M %
// 128, the VMEM plan, row blocks inside one image) do not apply.
// Not yet (PERF.md says where the time goes): a persistent tile loop (one
// block's prologue and epilogue under another tile's products), two-block
// clusters sharing the weight's slabs.
#include <string.h>

#include "mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace sdtk {
namespace {

constexpr int KC = 64;            // channels a K step: one 128-byte swizzled row
constexpr int THREADS = 256;      // two warpgroups
constexpr int RB = KC * 2;        // bytes of a K step's row
constexpr int kMaxSmem = 232448;  // 227 KB a block may use on Hopper

enum Prologue { kNone = 0, kLN = 1, kGN = 2 };

// Shared bytes: 1024 to align the ring, the ring, either (R) the block's
// rows (one 128-byte row a K chunk) and the LayerNorm affine (bf16 weight
// and bias, K padded to whole chunks) or (S) its rows' LayerNorm mean and
// rstd, and 128 for the mbarriers (two a stage, one for R's rows).
__host__ __device__ constexpr int lin_smem(int resident, int BM, int BN, int STAGES, int kch) {
  return 1024 + (resident ? STAGES * BN * RB + BM * kch * RB + kch * 4 * KC : STAGES * (BM + BN) * RB + BM * 8) +
         128;
}

struct LinArgs {
  const bf16* x;      // (M, K)
  const bf16* ln_w;   // (K) or null
  const bf16* ln_b;   // (K) or null
  const float* ss;    // (B, 2, K) GroupNorm scale/shift, or null
  const bf16* w;      // (N, K)
  const bf16* bias;   // (N) or null
  const bf16* res;    // (M, N) or null
  bf16* y;            // (M, N)
  float* ws;          // (ksplit, M, N) f32 partials when ksplit > 1
  int rows_per_img;   // rows of one image (GN)
  int M, N, K, pro, nsplit, ksplit;
  float eps;
};

// Eight values normalized in f32 and rounded once: LayerNorm from the row's
// (mean, rstd) and the affine (g, b), or GroupNorm from the row's image's
// folded scale and shift (8 each, as two float4s).
__device__ __forceinline__ Pack8 ln8(const Pack8& xv, const Pack8& g, const Pack8& b, float mean,
                                     float rstd) {
  Pack8 o;
#pragma unroll
  for (int j = 0; j < 8; ++j) o.h[j] = to_bf((to_f(xv.h[j]) - mean) * rstd * to_f(g.h[j]) + to_f(b.h[j]));
  return o;
}

struct SS8 {
  float4 s0, s1, h0, h1;
};

__device__ __forceinline__ SS8 load_ss8(const LinArgs& a, int row, int c) {
  const float* sc = a.ss + (long)(row / a.rows_per_img) * 2 * a.K + c;
  return SS8{*reinterpret_cast<const float4*>(sc), *reinterpret_cast<const float4*>(sc + 4),
             *reinterpret_cast<const float4*>(sc + a.K), *reinterpret_cast<const float4*>(sc + a.K + 4)};
}

__device__ __forceinline__ Pack8 gn8(const Pack8& xv, const SS8& q) {
  const float s[8] = {q.s0.x, q.s0.y, q.s0.z, q.s0.w, q.s1.x, q.s1.y, q.s1.z, q.s1.w};
  const float h[8] = {q.h0.x, q.h0.y, q.h0.z, q.h0.w, q.h1.x, q.h1.y, q.h1.z, q.h1.w};
  Pack8 o;
#pragma unroll
  for (int j = 0; j < 8; ++j) o.h[j] = to_bf(to_f(xv.h[j]) * s[j] + h[j]);
  return o;
}

// BM rows x BN columns a tile, STAGES ring slabs, RES_A: schedule R
// (resident rows, grid (row blocks, N splits)) or S (streamed rows, grid
// (N tiles, row blocks, K splits): the column blocks of one row block run
// together and read its slabs of x from L2).
template <int BM, int BN, int STAGES, bool RES_A, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    linear_kernel(LinArgs a, const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap ymap) {
  constexpr bool SPLIT_N = BM == 64;           // two warpgroups: 64 rows each, or 64 rows' columns split
  constexpr int WN = SPLIT_N ? BN / 2 : BN;     // columns of a warpgroup's product
  constexpr int LOOK = STAGES - 1;             // slabs loaded ahead
  constexpr int STAGE = (RES_A ? BN : BM + BN) * RB;
  constexpr int BOFF = RES_A ? 0 : BM * RB;    // the weight slab's offset in a stage
  static_assert(STAGES >= 3, "a tile's staging takes two stages while the next slab loads");
  static_assert(STAGE % 1024 == 0 && BOFF % 1024 == 0, "whole swizzle atoms a slab");
  static_assert(BM * 8 % THREADS == 0 && THREADS % BM == 0, "whole pieces and rows a thread");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (ring - raw);
  const uint32_t abase = ring + STAGES * STAGE;  // R: chunk kc of the rows at abase + kc * BM * RB
  unsigned char* as = smem + STAGES * STAGE;
  float* mean_s = reinterpret_cast<float*>(as);  // S: the rows' LayerNorm statistics
  float* rstd_s = mean_s + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int wg_m = SPLIT_N ? 0 : wg * 64, wg_n = SPLIT_N ? wg * WN : 0;
  const int M = a.M, N = a.N, K = a.K;
  const int kch = (K + KC - 1) / KC, ntiles = (N + BN - 1) / BN;
  int m0, t0, t1, c0, c1;
  if constexpr (RES_A) {
    m0 = blockIdx.x * BM;
    t0 = blockIdx.y * ntiles / a.nsplit;
    t1 = (blockIdx.y + 1) * ntiles / a.nsplit;
    c0 = 0;
    c1 = kch;
  } else {
    t0 = blockIdx.x;
    t1 = t0 + 1;
    m0 = blockIdx.y * BM;
    c0 = blockIdx.z * kch / a.ksplit;
    c1 = (blockIdx.z + 1) * kch / a.ksplit;
  }
  const int nkc = c1 - c0, nsteps = (t1 - t0) * nkc;
  // The mbarriers after the rows (R) or the statistics (S): a stage's
  // "full" (its slabs landed) and "empty" (both warpgroups' products read
  // it), then (R) the rows'.
  const uint32_t bars = abase + (RES_A ? BM * kch * RB : BM * 8), empty = bars + 8 * (STAGES + 1);
  bf16* affine = reinterpret_cast<bf16*>(as + BM * kch * RB + 128);  // R: ln_w, then ln_b, kch * KC each
  if (RES_A && a.pro == kLN)  // staged once: every row's normalize reads it
    for (int v = tid; v < 2 * (K / 8); v += THREADS) {
      const int w = v >= K / 8, c = 8 * (v - w * (K / 8));
      *reinterpret_cast<uint4*>(affine + w * kch * KC + c) =
          *reinterpret_cast<const uint4*>((w ? a.ln_b : a.ln_w) + c);
    }
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    for (int i = 0; i < STAGES; ++i) mbar_init(empty + 8 * i, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Step s's slabs (tile t0 + s / nkc, chunk c0 + s % nkc) into stage s %
  // STAGES by one thread: the weight's BN rows and (S) the block's BM rows
  // of x; rows past N or M and channels past K arrive as zeros.
  auto load = [&](int s) {
    const int n0 = (t0 + s / nkc) * BN, k = (c0 + s % nkc) * KC;
    const uint32_t dst = ring + (s % STAGES) * STAGE, bar = bars + 8 * (s % STAGES);
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // a staged tile's store has read the stage
    mbar_expect(bar, STAGE);
    tma_load(dst + BOFF, &wmap, k, n0, bar);
    if constexpr (!RES_A) tma_load(dst, &xmap, k, m0, bar);
  };
  if (tid == 0) {
    if constexpr (RES_A) {  // the block's rows of all of K, a 64-channel box each
      const uint32_t bar = bars + 8 * STAGES;
      mbar_expect(bar, BM * kch * RB);
      for (int kc = 0; kc < kch; ++kc) tma_load(abase + kc * BM * RB, &xmap, kc * KC, m0, bar);
    }
    for (int s = 0; s < LOOK && s < nsteps; ++s) load(s);
  }

  // The prologue, in place and once per value (rows past M and channels
  // past K stay zero).  R: TPR = THREADS / BM threads a row, each holding
  // every TPR-th 16-byte piece of it, the row's two-pass f32 statistics
  // (LN) summed across them by shuffles; S with a LayerNorm: each row's
  // statistics over all of K from device memory, the same way.
  constexpr int TPR = THREADS / BM;
  const int prow = tid / TPR, pq = tid % TPR;
  if (RES_A || a.pro == kLN) {
    float mean = 0.f, rstd = 1.f;
    if constexpr (RES_A) mbar_wait(bars + 8 * STAGES, 0);  // the rows are in
    const bool live = m0 + prow < M;
    auto piece = [&](int v) -> Pack8 {  // piece v (channels 8v ..) of the thread's row, zero past M
      Pack8 p;
      if constexpr (RES_A)
        p = *reinterpret_cast<const Pack8*>(as + (v >> 3) * BM * RB + swz(prow, v & 7));
      else
        p.u = live ? *reinterpret_cast<const uint4*>(a.x + (long)(m0 + prow) * K + 8 * v) : make_uint4(0, 0, 0, 0);
      return p;
    };
    if (a.pro == kLN) {  // every lane, so that the shuffles see the whole warp
      float sum = 0.f;
#pragma unroll 4
      for (int v = pq; v < K / 8; v += TPR) {
        const Pack8 p = piece(v);
        float f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = to_f(p.h[j]);
        sum += ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      mean = sum / K;
      float q = 0.f;
#pragma unroll 4
      for (int v = pq; v < K / 8; v += TPR) {
        const Pack8 p = piece(v);
        float f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = to_f(p.h[j]) - mean;
          f[j] = d * d;
        }
        q += ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      rstd = rsqrtf(q / K + a.eps);
    }
    if constexpr (RES_A) {
      if (live && a.pro != kNone) {
#pragma unroll 4
        for (int v = pq; v < K / 8; v += TPR) {
          Pack8* q = reinterpret_cast<Pack8*>(as + (v >> 3) * BM * RB + swz(prow, v & 7));
          if (a.pro == kLN) {
            Pack8 g, b;
            g.u = *reinterpret_cast<const uint4*>(affine + 8 * v);
            b.u = *reinterpret_cast<const uint4*>(affine + kch * KC + 8 * v);
            *q = ln8(*q, g, b, mean, rstd);
          } else {
            *q = gn8(*q, load_ss8(a, m0 + prow, 8 * v));
          }
        }
      }
    } else if (pq == 0) {
      mean_s[prow] = mean;
      rstd_s[prow] = rstd;
    }
  }
  fence_async_shared();  // the normalized rows, for wgmma's reads
  __syncthreads();       // every thread's rows (R) or statistics (S) are in place

  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  const int g = lane >> 2, tq = lane & 3;
  const int lr = (warp & 3) * 16 + g;  // the thread's rows lr, lr + 8 of its warpgroup's 64
  constexpr int VPR = WN / 8;          // 16-byte pieces a row of the warpgroup's tile
  constexpr int PR = 64 * VPR / 128;   // of them a thread

  // Tile t's epilogue at its last step s.  Split K: the f32 partial tile
  // (columns 2 tq, +1 of each 8: whole 32-byte sectors a quad).  Else acc +
  // bias (+ residual) in f32, rounded once, staged in shared memory as boxes
  // of 64 rows x 16 columns in the 32-byte swizzle (the fragments' 4-byte
  // writes and reads meet no bank conflict there) and stored by TMA, which
  // reads the staging while the next tile's products run.  The bias pairs
  // and the residual's 16-byte row pieces are fetched before the tile's
  // last products are waited for.  The staging: BM = 128, ring slot (s -
  // wg) % STAGES, one slab for one warpgroup's tile, free once both
  // warpgroups' products of steps s - 1 and s are done (no load is in
  // flight into either: the next, slab s + STAGES - 1 into slot s - 1, is
  // issued once both warpgroups mark that slot empty, after their
  // epilogues); BM = 64, the warpgroup's own half of slot s.  A later TMA
  // load into either slot first waits for the store's reads (load() above).
  auto stg_of = [&](int w, int s) -> uint32_t {
    return ring + ((SPLIT_N ? s : s + STAGES - w) % STAGES) * STAGE + BOFF + (SPLIT_N ? w * WN * RB : 0);
  };
  auto epilogue = [&](int t, int s) {
    const int n0 = t * BN + wg_n, r0 = m0 + wg_m;
    uint4 rv[PR];
    uint32_t bb[WN / 8];  // the bias pairs of the thread's columns
    const bool res = a.res != nullptr && a.ksplit == 1;
    if (a.ksplit == 1) {
#pragma unroll
      for (int ni = 0; ni < WN / 8; ++ni) {
        const int col = n0 + ni * 8 + 2 * tq;
        bb[ni] = a.bias != nullptr && col < N ? *reinterpret_cast<const uint32_t*>(a.bias + col) : 0u;
      }
    }
    if (res) {
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const int p = (tid & 127) + 128 * i, r = p / VPR, cc = p - r * VPR;
        const int row = r0 + r, col = n0 + cc * 8;
        rv[i] = row < M && col < N ? *reinterpret_cast<const uint4*>(a.res + (long)row * N + col)
                                   : make_uint4(0, 0, 0, 0);
      }
    }
    wgmma_wait0();
    fence_operands(acc);
    if (a.ksplit > 1) {
      float* ws = a.ws + (long)blockIdx.z * M * N;
#pragma unroll
      for (int ni = 0; ni < WN / 8; ++ni) {
        const int col = n0 + ni * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + lr + 8 * hh;
          if (row < M && col < N)
            *reinterpret_cast<float2*>(ws + (long)row * N + col) =
                make_float2(acc[4 * ni + 2 * hh], acc[4 * ni + 2 * hh + 1]);
        }
      }
      return;
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // earlier tiles' stores
    __syncthreads();  // both warpgroups are done with slabs s - 1 and s, and no store reads them
    unsigned char* stg = smem + (stg_of(wg, s) - ring);
    // byte of (row r, 16-byte piece cc) of the warpgroup's tile in its boxes
    auto at = [](int r, int cc) { return (cc >> 1) * 2048 + r * 32 + (((cc & 1) ^ ((r >> 2) & 1)) << 4); };
    if (res) {
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const int p = (tid & 127) + 128 * i, r = p / VPR, cc = p - r * VPR;
        *reinterpret_cast<uint4*>(stg + at(r, cc)) = rv[i];
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's residual is staged
    }
#pragma unroll
    for (int ni = 0; ni < WN / 8; ++ni) {
      const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb[ni]));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t* q = reinterpret_cast<uint32_t*>(stg + at(lr + 8 * hh, ni) + 4 * tq);
        float v0 = acc[4 * ni + 2 * hh] + b2.x, v1 = acc[4 * ni + 2 * hh + 1] + b2.y;
        if (res) {
          const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q));
          v0 += r2.x, v1 += r2.y;
        }
        *q = pack_bf16(v0, v1);
      }
    }
    fence_async_shared();  // the staged tile, for the TMA store
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint32_t src = stg_of(w, s);
        const int c0w = t * BN + (SPLIT_N ? w * WN : 0), r0w = m0 + (SPLIT_N ? 0 : 64 * w);
#pragma unroll
        for (int b = 0; b < WN / 16; ++b)
          if (c0w + 16 * b < N && r0w < M) tma_store(&ymap, c0w + 16 * b, r0w, src + b * 2048);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  };

  // Step s: wait for its slabs, issue its products; once a warpgroup's
  // products of step s - 1 are done (wgmma_wait<1>, or the tile's epilogue)
  // it marks that stage empty, and thread 0 refills it with slab s +
  // STAGES - 1 once both have.  No block barrier a step.
  const uint64_t bdesc0 = sw128_desc(ring + BOFF + wg_n * RB);
  for (int s = 0; s < nsteps; ++s) {
    mbar_wait(bars + 8 * (s % STAGES), (s / STAGES) & 1);  // slab s is in
    const int kc = s % nkc;
    if (!RES_A && a.pro != kNone) {  // S with a prologue: normalize the landed x slab in place
      unsigned char* st = smem + (s % STAGES) * STAGE;
      const int k0 = (c0 + kc) * KC + (tid & 7) * 8;  // the thread's channels: one piece of each row
      if (k0 < K) {
#pragma unroll
        for (int i = 0; i < BM * 8 / THREADS; ++i) {
          const int r = (tid >> 3) + i * (THREADS / 8);
          if (m0 + r >= M) continue;
          Pack8* q = reinterpret_cast<Pack8*>(st + swz(r, tid & 7));
          if (a.pro == kLN) {
            Pack8 lw, lb;
            lw.u = *reinterpret_cast<const uint4*>(a.ln_w + k0);
            lb.u = *reinterpret_cast<const uint4*>(a.ln_b + k0);
            *q = ln8(*q, lw, lb, mean_s[r], rstd_s[r]);
          } else {
            *q = gn8(*q, load_ss8(a, m0 + r, k0));
          }
        }
      }
      fence_async_shared();
      __syncthreads();
    }
    const uint32_t arow = RES_A ? abase + kc * BM * RB : ring + (s % STAGES) * STAGE;
    const uint64_t da = sw128_desc(arow + wg_m * RB);
    const uint64_t db = bdesc0 + (uint64_t)(((s % STAGES) * STAGE) >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) WgmmaSS<WN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    if (kc != nkc - 1) {
      wgmma_wait<1>();
    } else {
      epilogue(t0 + s / nkc, s);
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    }
    const int u = s - 1;  // the step whose stage frees
    if (u >= 0 && (tid & 127) == 0) mbar_arrive(empty + 8 * (u % STAGES));
    if (tid == 0 && s + LOOK < nsteps) {
      if (u >= 0) mbar_wait(empty + 8 * (u % STAGES), (u / STAGES) & 1);
      load(s + LOOK);  // into stage (s - 1) % STAGES
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// y = (the K parts' f32 partials, summed in split order) + bias (+ res),
// rounded once; eight outputs a thread.
__global__ void linear_reduce_kernel(const float* ws, const bf16* bias, const bf16* res, bf16* y, long mn,
                                     int N, int ksplit) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= mn) return;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int z = 0; z < ksplit; ++z) {
    const float4 p0 = *reinterpret_cast<const float4*>(ws + z * mn + i);
    const float4 p1 = *reinterpret_cast<const float4*>(ws + z * mn + i + 4);
    v[0] += p0.x, v[1] += p0.y, v[2] += p0.z, v[3] += p0.w;
    v[4] += p1.x, v[5] += p1.y, v[6] += p1.z, v[7] += p1.w;
  }
  Pack8 b, r, o;
  b.u = bias != nullptr ? *reinterpret_cast<const uint4*>(bias + i % N) : make_uint4(0, 0, 0, 0);
  r.u = res != nullptr ? *reinterpret_cast<const uint4*>(res + i) : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) o.h[j] = to_bf(v[j] + to_f(b.h[j]) + to_f(r.h[j]));
  *reinterpret_cast<uint4*>(y + i) = o.u;
}

template <class F>
int lin_attrs_of(F fn, int smem, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem + (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

}  // namespace
}  // namespace sdtk

// The compiled variants (resident, BM, BN, STAGES, blocks an SM for the
// launch bound); linear_plan (ops/linear.py) chooses among them.  (64-row
// blocks of one warpgroup taking all 160 columns, m64n160 products, lost
// to two warpgroups of m64n80 at every path shape on an H100: PERF.md.)
#define SDTK_LIN_VARIANTS(X) X(1, 128, 160, 3, 1) X(1, 64, 160, 3, 2) X(0, 128, 160, 4, 1) X(0, 64, 160, 3, 2)

// Arguments packed as int64 (p[i]): x, ln_w, ln_b, ss, w, bias, res, y, ws
// (pointers), rows_per_img, M, N, K, (resident, bm, bn, stages, minb) a
// compiled variant, nsplit, ksplit, eps (its f32 bits), stream.  Takes the
// TMA maps of x, w and y from a cache, encoding the ones it lacks.  Shape
// rules (checked by the Python wrapper, which also plans): K % 8 == 0, N %
// 8 == 0, x, w, ln_w, ln_b, ss, bias and res 16-byte aligned, every tensor
// contiguous; ln_w and ln_b both given or both null, and not with ss; ss
// given: K11 (GroupNorm, rows_per_img >= 1), else K10 (LayerNorm when ln_w
// is given); bias and res may be null.  Schedule R (resident = 1): 1 <=
// nsplit <= N tiles, ksplit == 1; S: ksplit in
// [1, K chunks], ws (ksplit, M, N) f32 when ksplit > 1; the variant's
// shared bytes within a block.  Launches the product and, split, the
// reduce.  An unknown variant returns cudaErrorInvalidValue.
extern "C" int sdtk_linear(const long long* p) {
  using namespace sdtk;
  LinArgs a;
  a.x = (const bf16*)p[0];
  a.ln_w = (const bf16*)p[1];
  a.ln_b = (const bf16*)p[2];
  a.ss = (const float*)p[3];
  a.w = (const bf16*)p[4];
  a.bias = (const bf16*)p[5];
  a.res = (const bf16*)p[6];
  a.y = (bf16*)p[7];
  a.ws = (float*)p[8];
  a.rows_per_img = (int)p[9];
  a.M = (int)p[10], a.N = (int)p[11], a.K = (int)p[12];
  const int resident = (int)p[13], bm = (int)p[14], bn = (int)p[15], stages = (int)p[16],
            minb = (int)p[17];
  a.nsplit = (int)p[18], a.ksplit = (int)p[19];
  const int eps_bits = (int)p[20];
  memcpy(&a.eps, &eps_bits, sizeof a.eps);
  cudaStream_t st = (cudaStream_t)p[21];
  a.pro = a.ss != nullptr ? kGN : a.ln_w != nullptr ? kLN : kNone;
  const int kch = (a.K + KC - 1) / KC, ntiles = bn > 0 ? (a.N + bn - 1) / bn : 0;
  const int smem = lin_smem(resident, bm, bn, stages, kch);
  if (a.M < 1 || a.K < 8 || a.K % 8 != 0 || a.N % 8 != 0 || smem > kMaxSmem ||
      (a.ln_w == nullptr) != (a.ln_b == nullptr) || (a.ss != nullptr && a.ln_w != nullptr) ||
      (a.ss != nullptr && a.rows_per_img < 1) || a.ksplit < 1 || a.ksplit > kch ||
      (a.ksplit > 1 && a.ws == nullptr) ||
      (resident && (a.nsplit < 1 || a.nsplit > ntiles || a.ksplit != 1)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, ymap;
  if (!cached_map(&xmap, a.x, a.M, a.K, KC, bm, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !cached_map(&wmap, a.w, a.N, a.K, KC, bn, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !cached_map(&ymap, a.y, a.M, a.N, 16, 64, CU_TENSOR_MAP_SWIZZLE_32B))
    return (int)cudaErrorInvalidValue;
  const unsigned mb = (unsigned)((a.M + bm - 1) / bm);
  const dim3 grid = resident ? dim3(mb, (unsigned)a.nsplit) : dim3((unsigned)ntiles, mb, (unsigned)a.ksplit);
  cudaError_t err = cudaErrorInvalidValue;
#define SDTK_LIN(r_, bm_, bn_, st_, mb_)                                                      \
  if (resident == r_ && bm == bm_ && bn == bn_ && stages == st_ && minb == mb_) {             \
    auto fn = linear_kernel<bm_, bn_, st_, (bool)r_, mb_>;                                   \
    static bool ready = false; /* the shared-memory limit, set once (one card) */            \
    err = ready ? cudaSuccess                                                                 \
                : cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem); \
    ready = err == cudaSuccess;                                                               \
    if (err == cudaSuccess) {                                                                 \
      fn<<<grid, THREADS, smem, st>>>(a, xmap, wmap, ymap);                                   \
      err = cudaGetLastError();                                                               \
    }                                                                                         \
  }
  SDTK_LIN_VARIANTS(SDTK_LIN)
#undef SDTK_LIN
  if (err != cudaSuccess || a.ksplit == 1) return (int)err;
  const long mn = (long)a.M * a.N;
  linear_reduce_kernel<<<(unsigned)((mn / 8 + 255) / 256), 256, 0, st>>>(a.ws, a.bias, a.res, a.y, mn,
                                                                          a.N, a.ksplit);
  return (int)cudaGetLastError();
}

// A compiled variant from the runtime, its shared memory for kch K chunks
// (R: the rows of all of them resident): out = {registers a thread, local
// (spill) bytes a thread, shared bytes a block, resident blocks an SM}.
extern "C" int sdtk_linear_attrs(int resident, int bm, int bn, int stages, int minb, int kch, int* out) {
  using namespace sdtk;
#define SDTK_LIN_ATTRS(r_, bm_, bn_, st_, mb_)                                               \
  if (resident == r_ && bm == bm_ && bn == bn_ && stages == st_ && minb == mb_)              \
    return lin_attrs_of(linear_kernel<bm_, bn_, st_, (bool)r_, mb_>, lin_smem(r_, bm_, bn_, st_, kch), out);
  SDTK_LIN_VARIANTS(SDTK_LIN_ATTRS)
#undef SDTK_LIN_ATTRS
  return (int)cudaErrorInvalidValue;
}
