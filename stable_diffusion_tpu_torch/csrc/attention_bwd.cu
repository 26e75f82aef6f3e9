// K5 and K6: the backward of non-causal self-attention over (B, S, H, D) bf16.
//
// Replace the two TPU kernels of stable_diffusion_tpu/ops/flash_attention.py
// `_premerged_flash_bwd`: K5 `_bwd_dq_kernel` (pass A: dQ, and delta =
// rowsum(dO * O)) and K6 `_bwd_dkv_kernel` (pass B: dK = sum dS^T Q and
// dV = sum P^T dO with P = exp(S - LSE)).  dS = P * (dP - delta) * scale,
// dP = dO V^T.
//
// What bounds it on Hopper: the tensor cores and the exponentials.  The
// gradient needs five S x S x D products per head (S, dP, dV, dQ, dK); at
// S = 4096 that is 10 B H S^2 D FLOP against ~84 MB of q, k, v, o, dO, dq,
// dk and dv, and one exponential per logit on the SFUs (at d = 40 about
// as long as the products).  So the aim is to keep every S x S tile in
// registers and the tensor cores fed from registers and `ldmatrix`.
//
// FlashAttention-2's backward on `mma.sync` (mma.cuh), in two kernels like
// the TPU's, and no atomics.  The row statistics come from the forward: K3
// writes each row's log-sum-exp (log2 domain), so P = 2^(S scale log2 e -
// lse) is exact at the first visit and the TPU's pass-A recompute of the row
// max and sum is gone.  The two kernels do seven products per head, not the
// five the function needs, and two exponentials per logit: S and dP are
// computed in both, since a block that owns query rows cannot also own the
// key rows' sums without atomics.  K5 owns query rows and streams K/V; K6
// owns key rows and streams Q/dO, computing the transposed products S^T =
// K Q^T and dP^T = V dO^T so that P^T and dS^T come out in the accumulator
// layout and feed dV += P^T dO and dK += dS^T Q from registers.  P and dS
// are rounded to bf16 before their products, as the TPU kernels do.
//
// Measured on an H100 and not kept: the single-pass backward on K6's ring
// body (each tile's dS^T kept in shared memory, two buffers deep; dQ's
// partial over the block's 128 keys formed there and added by float4
// atomics into an f32 accumulator; K5 cut to the delta pass).  Right at its
// first build, it took 1.0517 ms through the entry point against the split's
// 1.1752 at (4, 4096, 8, 40), but 0.1580 against 0.1575 at (4, 1024, 8, 80)
// and more at d = 64 (PERF.md, Findings): the partials and their atomics
// cost nearly what K5's recomputed S and dP do.
//
// Two bodies each; `attention_bwd_plan` (ops/flash_attention.py) picks one
// and its tiles, and passes them in:
// * The ring body (attention_bwd_ring.cuh, whose note gives its design and
//   occupancy): padded head dims 48, 64 and 80 (every UNet self-attention)
//   at S % 4 == 0.  The owned operands' fragments held in registers for the
//   whole sweep, the streamed tiles through a cp.async ring, B fragments by
//   `ldmatrix.x4`.
// * The general body (the first design; d = 160 and other head dims): 64
//   owned rows a block (4 warps), each streamed 64-row tile loaded
//   synchronously into one buffer between two barriers, the A fragments
//   re-read from shared memory at every tile.  K6's dK and dV accumulators
//   hold at most 80 columns; a wider head (d = 160) runs two passes over
//   the queries that recompute S^T and dP^T.  Head dims zero-padded to a
//   multiple of 16; rows past S zero and their P masked to 0.  At d = 160 a
//   block takes 86.5 KB of shared memory and ~200-230 registers a thread:
//   two blocks an SM.
#include <math.h>

#include "attention_bwd_ring.cuh"

namespace sdtk {
namespace {

constexpr int BQ = 64;   // query rows per tile (general body)
constexpr int BKV = 64;  // key rows per tile (general body)
constexpr int THREADS = 128;

// Rows r0 .. r0 + n - 1 of one head of a (B, S, H, D) view into shared
// memory [n][LD], zero past S and in the padded columns.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long ss, int r0, int S,
                                          int D, int DQ, int LD, int n) {
  const int vpr = DQ / 8;
  for (int idx = threadIdx.x; idx < n * vpr; idx += THREADS) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S && c < D) val = *reinterpret_cast<const uint4*>(base + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// acc (16 x 64) += A B^T: A is 16 rows at `a`, B 64 rows at `b`, both
// [row][LD] in shared memory, contracted over DQ columns.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* a, const bf16* b, int LD,
                                        int DQ, int g, int t) {
  for (int kk = 0; kk < DQ / 16; ++kk) {
    uint32_t fa[4];
    const bf16* ap = a + g * LD + kk * 16 + 2 * t;
    fa[0] = lds32(ap);
    fa[1] = lds32(ap + 8 * LD);
    fa[2] = lds32(ap + 8);
    fa[3] = lds32(ap + 8 * LD + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* bp = b + (8 * j + g) * LD + kk * 16 + 2 * t;
      mma16816(acc[j], fa, lds32(bp), lds32(bp + 8));
    }
  }
}

// acc (16 x 8 NT) += P B: P (16 x 64) in accumulator registers, B 64 rows
// [row][LD] in shared memory starting at the first output column.
template <int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[NT][4], float (&p)[8][4], const bf16* b,
                                       int LD, int lane) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    // lane l addresses row kk*16 + (l & 15), columns +8 for lanes 16..31
    const bf16* bp = b + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bp + j * 8);
      mma16816(acc[j], pa, r[0], r[1]);
      mma16816(acc[j + 1], pa, r[2], r[3]);
    }
  }
}

// K5, general body: dQ and delta for 64 query rows.  NT = DQ / 8.
template <int NT>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int DQ = a.DQ, LD = DQ + 8, D = a.D, S = a.S;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BKV * LD;
  float* stat = reinterpret_cast<float*>(Vs + BKV * LD);  // [BQ] lse, [BQ] delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * BQ;
  const long hd = (long)h * D;
  const bf16* qb = a.q + b * a.q_sb + hd;
  const bf16* ob = a.o + b * a.o_sb + hd;
  const bf16* db = a.dout + b * a.do_sb + hd;
  const bf16* kb = a.k + b * a.k_sb + hd;
  const bf16* vb = a.v + b * a.v_sb + hd;

  load_tile(Qs, qb, a.q_ss, q0, S, D, DQ, LD, BQ);
  load_tile(dOs, db, a.do_ss, q0, S, D, DQ, LD, BQ);
  // delta = rowsum(dO * O) in f32, one warp per row in turn
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S)
      for (int c = lane; c < D; c += 32) acc += to_f(ob[row * a.o_ss + c]) * to_f(db[row * a.do_ss + c]);
    acc = warp_sum(acc);
    if (lane == 0) {
      stat[r] = row < S ? a.lse[(long)bh * S + row] : 0.f;
      stat[BQ + r] = acc;
      if (row < S) a.delta[(long)bh * S + row] = acc;
    }
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this lane's rows in the tile: r0 and r0 + 8
  const float lse0 = stat[r0], lse1 = stat[r0 + 8];
  const float dl0 = stat[BQ + r0], dl1 = stat[BQ + r0 + 8];
  const bf16* qw = Qs + warp * 16 * LD;
  const bf16* dow = dOs + warp * 16 * LD;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BKV) {
    __syncthreads();  // the previous K/V tile is done with
    load_tile(Ks, kb, a.k_ss, k0, S, D, DQ, LD, BKV);
    load_tile(Vs, vb, a.v_ss, k0, S, D, DQ, LD, BKV);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_abt(s, qw, Ks, LD, DQ, g, t);    // S = Q K^T
    mma_abt(dp, dow, Vs, LD, DQ, g, t);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + 8 * j + 2 * t + e < S;
        const float p0 = ok ? exp2f(s[j][e] * a.scale_log2 - lse0) : 0.f;
        const float p1 = ok ? exp2f(s[j][2 + e] * a.scale_log2 - lse1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - dl0) * a.scale;  // dS
        s[j][2 + e] = p1 * (dp[j][2 + e] - dl1) * a.scale;
      }
    }
    mma_pb<NT>(acc, s, Ks, LD, lane);  // dQ += dS K
  }
  store_rows<NT>(a.dq, acc, b, h, q0 + r0, 0, a, t, 1.f);
}

// K6, general body: dK and dV for 64 key rows, NT * 8 output columns per pass.
template <int NT>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(BwdArgs a, int passes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int DQ = a.DQ, LD = DQ + 8, D = a.D, S = a.S;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;
  bf16* dOs = Qs + BQ * LD;
  float* stat = reinterpret_cast<float*>(dOs + BQ * LD);  // [BQ] lse, [BQ] delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.x * BKV;
  const long hd = (long)h * D;
  const bf16* qb = a.q + b * a.q_sb + hd;
  const bf16* db = a.dout + b * a.do_sb + hd;

  load_tile(Ks, a.k + b * a.k_sb + hd, a.k_ss, k0, S, D, DQ, LD, BKV);
  load_tile(Vs, a.v + b * a.v_sb + hd, a.v_ss, k0, S, D, DQ, LD, BKV);
  const bf16* kw = Ks + warp * 16 * LD;  // this warp's 16 key rows
  const bf16* vw = Vs + warp * 16 * LD;

  for (int pass = 0; pass < passes; ++pass) {
    const int d0 = pass * NT * 8;
    float dk[NT][4], dv[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    for (int q0 = 0; q0 < S; q0 += BQ) {
      __syncthreads();  // the previous Q/dO tile is done with (first: K/V are loaded)
      load_tile(Qs, qb, a.q_ss, q0, S, D, DQ, LD, BQ);
      load_tile(dOs, db, a.do_ss, q0, S, D, DQ, LD, BQ);
      for (int r = tid; r < BQ; r += THREADS) {
        const bool ok = q0 + r < S;
        stat[r] = ok ? a.lse[(long)bh * S + q0 + r] : 0.f;
        stat[BQ + r] = ok ? a.delta[(long)bh * S + q0 + r] : 0.f;
      }
      __syncthreads();

      float st[8][4], dpt[8][4];  // S^T and dP^T: this warp's 16 keys x 64 queries
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
      mma_abt(st, kw, Qs, LD, DQ, g, t);    // S^T = K Q^T
      mma_abt(dpt, vw, dOs, LD, DQ, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;  // query within the tile
          const bool ok = q0 + col < S;
          const float l = stat[col], dl = stat[BQ + col];
          const float p0 = ok ? exp2f(st[j][e] * a.scale_log2 - l) : 0.f;
          const float p1 = ok ? exp2f(st[j][2 + e] * a.scale_log2 - l) : 0.f;
          st[j][e] = p0;  // P^T
          st[j][2 + e] = p1;
          dpt[j][e] = p0 * (dpt[j][e] - dl) * a.scale;  // dS^T
          dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dl) * a.scale;
        }
      }
      mma_pb<NT>(dv, st, dOs + d0, LD, lane);  // dV += P^T dO
      mma_pb<NT>(dk, dpt, Qs + d0, LD, lane);  // dK += dS^T Q
    }
    store_rows<NT>(a.dk, dk, b, h, k0 + warp * 16 + g, d0, a, t, 1.f);
    store_rows<NT>(a.dv, dv, b, h, k0 + warp * 16 + g, d0, a, t, 1.f);
  }
}

int general_smem(int DQ) { return 4 * 64 * (DQ + 8) * 2 + 2 * BQ * 4; }

// K6's output chunk in the general body: the widest of at most 80 columns
// that divides the padded head (its dK and dV accumulators hold one chunk);
// 0 if none.
int dkv_chunk(int DQ) {
  if (DQ > 160) return 0;
  if (DQ <= 80) return DQ;
  for (int c = 80; c > 16; c -= 16)
    if (DQ % c == 0) return c;
  return 16;
}

template <class Fn, class... Args>
int launch(Fn fn, int smem, int threads, dim3 grid, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spill) bytes a thread, shared bytes a
// block, resident blocks an SM.
template <class Fn>
int kernel_attrs(Fn fn, int smem, int threads, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem + (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

// The general body's K5 (dq) or K6 (dkv) for padded head dim DQ: the
// launch, or with `out` the attributes.
int general(bool dkv, const BwdArgs& a, int B, cudaStream_t st, int* out) {
  const int smem = general_smem(a.DQ);
  const dim3 grid((unsigned)((a.S + 63) / 64), (unsigned)(B * a.H));
#define SDTK_RUN(fn, ...) \
  return out ? kernel_attrs(fn, smem, THREADS, out) : launch(fn, smem, THREADS, grid, st, a, ##__VA_ARGS__)
  if (!dkv) {
    switch (a.DQ) {
      case 16: SDTK_RUN(bwd_dq_kernel<2>);
      case 32: SDTK_RUN(bwd_dq_kernel<4>);
      case 48: SDTK_RUN(bwd_dq_kernel<6>);
      case 64: SDTK_RUN(bwd_dq_kernel<8>);
      case 80: SDTK_RUN(bwd_dq_kernel<10>);
      case 96: SDTK_RUN(bwd_dq_kernel<12>);
      case 112: SDTK_RUN(bwd_dq_kernel<14>);
      case 128: SDTK_RUN(bwd_dq_kernel<16>);
      case 144: SDTK_RUN(bwd_dq_kernel<18>);
      case 160: SDTK_RUN(bwd_dq_kernel<20>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int dc = dkv_chunk(a.DQ);
  const int passes = dc ? a.DQ / dc : 0;
  switch (dc) {
    case 16: SDTK_RUN(bwd_dkv_kernel<2>, passes);
    case 32: SDTK_RUN(bwd_dkv_kernel<4>, passes);
    case 48: SDTK_RUN(bwd_dkv_kernel<6>, passes);
    case 64: SDTK_RUN(bwd_dkv_kernel<8>, passes);
    case 80: SDTK_RUN(bwd_dkv_kernel<10>, passes);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDTK_RUN
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv, long q_sb, long q_ss,
                  long k_sb, long k_ss, long v_sb, long v_ss, long o_sb, long o_ss, long do_sb,
                  long do_ss, int H, int S, int D, float scale) {
  return BwdArgs{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),    static_cast<const bf16*>(o),
                 static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                 static_cast<float*>(delta),     static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk),         static_cast<bf16*>(dv),
                 q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss,
                 H, S, D, (D + 15) / 16 * 16, scale, scale * 1.4426950408889634f};
}

}  // namespace
}  // namespace sdtk

// The compiled ring variants (padded D, owned rows, streamed tile rows, the
// blocks an SM promised to ptxas: each the most that compiles without
// spills); attention_bwd_plan (ops/flash_attention.py) chooses among them.
#define SDTK_BWD_DQ_RING(X) \
  X(48, 128, 64, 2)         \
  X(64, 128, 64, 2)         \
  X(80, 128, 64, 1)
#define SDTK_BWD_DKV_RING(X) \
  X(48, 128, 64, 2)          \
  X(64, 64, 64, 3)           \
  X(80, 128, 64, 1)

enum { SDTK_BWD_GENERAL = 0, SDTK_BWD_RING = 1 };

namespace sdtk {
namespace {

// A ring variant of K5 (dkv false) or K6: the launch, or with `out` the
// attributes; cudaErrorInvalidValue if (DP, rows, tile) is not compiled.
int ring(bool dkv, const BwdArgs& a, int B, int rows, int tile, cudaStream_t st, int* out) {
  const dim3 grid((unsigned)((a.S + rows - 1) / rows), (unsigned)(B * a.H));
#define SDTK_RING(kern, smem, dp, rows_, tile_)                                          \
  if (a.DQ == dp && rows == rows_ && tile == tile_)                                      \
    return out ? kernel_attrs(kern, BwdRing<dp, rows_, tile_>::smem, 2 * rows_, out)     \
               : launch(kern, BwdRing<dp, rows_, tile_>::smem, 2 * rows_, grid, st, a);
#define SDTK_DQ(dp, r, t, minb) SDTK_RING((bwd_dq_ring<dp, r, t, minb>), SMEM_DQ, dp, r, t)
#define SDTK_DKV(dp, r, t, minb) SDTK_RING((bwd_dkv_ring<dp, r, t, minb>), SMEM_DKV, dp, r, t)
  if (dkv) {
    SDTK_BWD_DKV_RING(SDTK_DKV)
  } else {
    SDTK_BWD_DQ_RING(SDTK_DQ)
  }
#undef SDTK_DQ
#undef SDTK_DKV
#undef SDTK_RING
  return (int)cudaErrorInvalidValue;
}

int dispatch(bool dkv, const BwdArgs& a, int B, int body, int rows, int tile, cudaStream_t st,
             int* out) {
  if (body == SDTK_BWD_RING) {
    if (a.S % 4 != 0) return (int)cudaErrorInvalidValue;
    return ring(dkv, a, B, rows, tile, st, out);
  }
  if (body != SDTK_BWD_GENERAL || rows != 64 || tile != 64) return (int)cudaErrorInvalidValue;
  return general(dkv, a, B, st, out);
}

}  // namespace
}  // namespace sdtk

// Shape rules (checked by the Python wrapper): D % 8 == 0, D <= 160, every
// stride a multiple of 8, 16-byte aligned pointers; lse from K3 on the same
// q, k, v; o and dO (B, S, H, D) views with packed (H, D) axes.  body 0:
// the general body (rows = tile = 64); body 1: the ring body, for a
// compiled (padded D, rows, tile) and S % 4 == 0.  An unknown variant
// returns cudaErrorInvalidValue.

// K5: dq and delta.
extern "C" int sdtk_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     long q_sb, long q_ss, long k_sb, long k_ss, long v_sb,
                                     long v_ss, long o_sb, long o_ss, long do_sb, long do_ss,
                                     int B, int H, int S, int D, float scale, int body, int rows,
                                     int tile, void* stream) {
  using namespace sdtk;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, q_sb, q_ss, k_sb,
                              k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss, H, S, D, scale);
  return dispatch(false, a, B, body, rows, tile, static_cast<cudaStream_t>(stream), nullptr);
}

// K6: dk and dv, from the delta that K5 wrote.
extern "C" int sdtk_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, long q_sb, long q_ss, long k_sb,
                                      long k_ss, long v_sb, long v_ss, long do_sb, long do_ss,
                                      int B, int H, int S, int D, float scale, int body, int rows,
                                      int tile, void* stream) {
  using namespace sdtk;
  const BwdArgs a =
      make_args(q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv, q_sb, q_ss,
                k_sb, k_ss, v_sb, v_ss, 0, 0, do_sb, do_ss, H, S, D, scale);
  return dispatch(true, a, B, body, rows, tile, static_cast<cudaStream_t>(stream), nullptr);
}

// A compiled K5 (kernel 5) or K6 (kernel 6) variant on the current card,
// from the runtime: out = {registers a thread, local (spill) bytes a
// thread, shared bytes a block, resident blocks an SM}.  body, rows and
// tile as above; dp the padded head dim.
extern "C" int sdtk_attention_bwd_attrs(int kernel, int body, int dp, int rows, int tile,
                                        int* out) {
  using namespace sdtk;
  if (kernel != 5 && kernel != 6) return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.D = a.DQ = dp;
  a.S = 4;
  return dispatch(kernel == 6, a, 0, body, rows, tile, nullptr, out);
}
