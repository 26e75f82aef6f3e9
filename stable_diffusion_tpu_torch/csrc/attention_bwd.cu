// K5 and K6: the backward of non-causal self-attention over (B, S, H, D) bf16.
//
// Replace the two TPU kernels of stable_diffusion_tpu/ops/flash_attention.py
// `_premerged_flash_bwd`: K5 `_bwd_dq_kernel` (pass A: dQ, and delta =
// rowsum(dO * O)) and K6 `_bwd_dkv_kernel` (pass B: dK = sum dS^T Q and
// dV = sum P^T dO with P = exp(S - LSE)).  dS = P * (dP - delta) * scale,
// dP = dO V^T.
//
// What bounds it on Hopper: the tensor cores.  The gradient needs five
// S x S x D products per head (S, dP, dV, dQ, dK); at S = 4096 that is
// 10 B H S^2 D FLOP against ~84 MB of q, k, v, o, dO, dq, dk and dv.  So the
// aim, as in the forward, is to keep every S x S tile in registers.
//
// Design: FlashAttention-2's backward on `mma.sync` (mma.cuh), in two
// kernels like the TPU's, and no atomics.
//  * The row statistics come from the forward: K3 writes each row's
//    log-sum-exp (log2 domain) when asked, so P = exp2(S log2e scale - lse)
//    is exact at the first visit and the TPU's pass-A recompute of the row
//    max and sum is gone.  The two kernels do seven products per head, not
//    the five the function needs: S and dP are computed in both, since a
//    block that owns query rows cannot also own the key rows' sums without
//    atomics.  One kernel with f32 atomic dQ is later work.
//  * K5: a block owns 64 query rows of one (batch, head), 16 per warp, with
//    its Q and dO tiles in shared memory, and walks K/V in 64-key tiles.
//    Each warp computes S = Q K^T and dP = dO V^T (16 x 64 each) into
//    registers, forms dS there, and feeds it, packed to bf16, as the A
//    operand of dQ += dS K, K's B fragments taken with `ldmatrix.trans`.
//    delta is computed from dO and O at the start and written for K6.
//  * K6: a block owns 64 key rows, 16 per warp, with its K and V tiles in
//    shared memory, and walks the queries in 64-row tiles.  Each warp
//    computes the transposed products S^T = K Q^T and dP^T = V dO^T, so P^T
//    and dS^T come out in the accumulator layout and feed dV += P^T dO and
//    dK += dS^T Q straight from registers.  Its dK and dV accumulators hold
//    at most 80 columns (80 f32 registers a lane for the two); a wider head
//    (D = 160 at S = 256 and 64) runs two passes over the queries that
//    recompute S^T and dP^T.
//  * Head dims are zero-padded to a multiple of 16 in shared memory, as in
//    K3; rows past S are zero and their P is masked to 0.  bf16 operands,
//    f32 accumulation; P and dS are rounded to bf16 before their products,
//    as the TPU kernels do.
//  * Occupancy (`sdtk_attention_bwd_attrs` below reads registers, spill
//    bytes, shared memory and blocks per SM from the runtime; chip_smoke.py
//    prints them): at D = 160 a block takes 86.5 KB of shared memory (four
//    64 x 168 bf16 tiles) and ~200-230 registers a thread, so two blocks
//    (8 warps) fit an SM, by both limits; at D = 40 (29 KB, 128-168
//    registers) three to four, by registers.  Raising it needs the
//    accumulators out of registers (wgmma) or smaller tiles: later work.
#include <math.h>

#include "mma.cuh"

namespace sdtk {
namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // key rows per tile
constexpr int THREADS = 128;

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, S), log2 domain, from K3
  float* delta;      // (B, H, S): written by K5, read by K6
  bf16 *dq, *dk, *dv;  // (B, S, H, D) contiguous
  long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss;  // in elements
  int H, S, D, DQ;  // DQ: head dim padded to a multiple of 16
  float scale, scale_log2;
};

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

// Rows `row` and `row + 8` of a (B, S, H, D) output: columns d0 + 8j + 2t.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, float (&acc)[NT][4], int b, int h,
                                           int row, int d0, const BwdArgs& a, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = d0 + 8 * j + 2 * t;
    if (c >= a.D) continue;
    if (row < a.S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * a.S + row) * a.H + h) * a.D + c) =
          pack_bf16(acc[j][0], acc[j][1]);
    if (row + 8 < a.S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * a.S + row + 8) * a.H + h) * a.D + c) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

// K5: dQ and delta for 64 query rows.  NT = DQ / 8.
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
  store_rows<NT>(a.dq, acc, b, h, q0 + r0, 0, a, t);
}

// K6: dK and dV for 64 key rows, NT * 8 output columns per pass.
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
    store_rows<NT>(a.dk, dk, b, h, k0 + warp * 16 + g, d0, a, t);
    store_rows<NT>(a.dv, dv, b, h, k0 + warp * 16 + g, d0, a, t);
  }
}

int smem_bytes(int DQ) { return 4 * 64 * (DQ + 8) * 2 + 2 * BQ * 4; }

template <int NT>
int launch_dq(const BwdArgs& a, int B, cudaStream_t st) {
  const int smem = smem_bytes(a.DQ);
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dq_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.S + BQ - 1) / BQ), (unsigned)(B * a.H));
  bwd_dq_kernel<NT><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_dkv(const BwdArgs& a, int B, int passes, cudaStream_t st) {
  const int smem = smem_bytes(a.DQ);
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dkv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.S + BKV - 1) / BKV), (unsigned)(B * a.H));
  bwd_dkv_kernel<NT><<<grid, THREADS, smem, st>>>(a, passes);
  return (int)cudaGetLastError();
}

// K6's output chunk: the widest of at most 80 columns that divides the
// padded head (its dK and dV accumulators hold one chunk); 0 if none.
int dkv_chunk(int DQ) {
  if (DQ > 160) return 0;
  if (DQ <= 80) return DQ;
  for (int c = 80; c > 16; c -= 16)
    if (DQ % c == 0) return c;
  return 16;
}

// out: registers a thread, local (spill) bytes a thread, shared bytes a
// block, resident blocks an SM.
template <typename... Args>
int kernel_attrs(void (*fn)(Args...), int smem, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem + (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
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

// Shape rules (checked by the Python wrapper): D % 8 == 0, D <= 160, every
// stride a multiple of 8, 16-byte aligned pointers; lse from K3 on the same
// q, k, v; o and dO (B, S, H, D) views with packed (H, D) axes.

// K5: dq and delta.
extern "C" int sdtk_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     long q_sb, long q_ss, long k_sb, long k_ss, long v_sb,
                                     long v_ss, long o_sb, long o_ss, long do_sb, long do_ss,
                                     int B, int H, int S, int D, float scale, void* stream) {
  using namespace sdtk;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, q_sb, q_ss, k_sb,
                              k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss, H, S, D, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.DQ) {
    case 16: return launch_dq<2>(a, B, st);
    case 32: return launch_dq<4>(a, B, st);
    case 48: return launch_dq<6>(a, B, st);
    case 64: return launch_dq<8>(a, B, st);
    case 80: return launch_dq<10>(a, B, st);
    case 96: return launch_dq<12>(a, B, st);
    case 112: return launch_dq<14>(a, B, st);
    case 128: return launch_dq<16>(a, B, st);
    case 144: return launch_dq<18>(a, B, st);
    case 160: return launch_dq<20>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6: dk and dv, from the delta that K5 wrote.
extern "C" int sdtk_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, long q_sb, long q_ss, long k_sb,
                                      long k_ss, long v_sb, long v_ss, long do_sb, long do_ss,
                                      int B, int H, int S, int D, float scale, void* stream) {
  using namespace sdtk;
  const BwdArgs a =
      make_args(q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv, q_sb, q_ss,
                k_sb, k_ss, v_sb, v_ss, 0, 0, do_sb, do_ss, H, S, D, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dc = dkv_chunk(a.DQ);
  if (dc == 0) return (int)cudaErrorInvalidValue;
  const int passes = a.DQ / dc;
  switch (dc) {
    case 16: return launch_dkv<2>(a, B, passes, st);
    case 32: return launch_dkv<4>(a, B, passes, st);
    case 48: return launch_dkv<6>(a, B, passes, st);
    case 64: return launch_dkv<8>(a, B, passes, st);
    case 80: return launch_dkv<10>(a, B, passes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The compiled K5 (out[0..3]) and K6 (out[4..7]) for head dim D, as
// kernel_attrs reports them.
extern "C" int sdtk_attention_bwd_attrs(int D, int* out) {
  using namespace sdtk;
  const int DQ = (D + 15) / 16 * 16, smem = smem_bytes(DQ);
  int err;
  switch (DQ) {
    case 16: err = kernel_attrs(bwd_dq_kernel<2>, smem, out); break;
    case 32: err = kernel_attrs(bwd_dq_kernel<4>, smem, out); break;
    case 48: err = kernel_attrs(bwd_dq_kernel<6>, smem, out); break;
    case 64: err = kernel_attrs(bwd_dq_kernel<8>, smem, out); break;
    case 80: err = kernel_attrs(bwd_dq_kernel<10>, smem, out); break;
    case 96: err = kernel_attrs(bwd_dq_kernel<12>, smem, out); break;
    case 112: err = kernel_attrs(bwd_dq_kernel<14>, smem, out); break;
    case 128: err = kernel_attrs(bwd_dq_kernel<16>, smem, out); break;
    case 144: err = kernel_attrs(bwd_dq_kernel<18>, smem, out); break;
    case 160: err = kernel_attrs(bwd_dq_kernel<20>, smem, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  switch (dkv_chunk(DQ)) {
    case 16: return kernel_attrs(bwd_dkv_kernel<2>, smem, out + 4);
    case 32: return kernel_attrs(bwd_dkv_kernel<4>, smem, out + 4);
    case 48: return kernel_attrs(bwd_dkv_kernel<6>, smem, out + 4);
    case 64: return kernel_attrs(bwd_dkv_kernel<8>, smem, out + 4);
    case 80: return kernel_attrs(bwd_dkv_kernel<10>, smem, out + 4);
    default: return (int)cudaErrorInvalidValue;
  }
}
