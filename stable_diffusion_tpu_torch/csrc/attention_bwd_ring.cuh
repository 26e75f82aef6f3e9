// The ring bodies of K5 and K6 (attention_bwd.cu): the self-attention
// backward at padded head dims 48, 64 and 80 (d = 40, 64, 80: every UNet
// self-attention of SD1.5 and SD2.1), for S a multiple of 4.
//
// What held the first bodies back (the general bodies in attention_bwd.cu):
// every streamed tile was copied through registers between two barriers
// into one buffer, so each load stalled its products; the block's own
// operands (Q and dO in K5, K and V in K6), which never change over the
// sweep, were re-read from shared memory by four 32-bit loads per k16 step
// at every tile, and the streamed operand by two 32-bit loads per product;
// shared-memory instructions, not the tensor cores, set the pace.  At
// (4, 4096, 8, 40) the pair took 3.6 ms against 0.84 for SDPA's backward
// on an H100 (PERF.md, Findings).
//
// The ring bodies keep the two-kernel split (no atomics) and change how
// each kernel feeds its tensor cores, as K3's ring body did:
//  * A block owns ROWS rows of one (batch, head), 16 a warp.  Its two owned
//    operands are copied once and each warp's m16n8k16 A fragments taken
//    by `ldmatrix.x4` into registers for the whole sweep (K5: Q and dO;
//    K6: K and V; 2 x 4 DP / 16 registers, 24 at d = 40, 40 at d = 80).
//  * The other side streams through a cp.async ring of BWD_STAGES buffers
//    of TILE rows (copy_rows: 16 bytes a copy, zero-filled past S and past
//    D), one commit group and one barrier a tile, so the next tiles land
//    while this one computes.  K6's buffers also carry the tile's lse and
//    delta, 16 bytes a copy (hence S % 4 == 0: every tile's statistics
//    start 16-byte aligned).
//  * Each warp walks its tile 16 streamed rows at a time: the two logit
//    products (K5: S = Q K^T and dP = dO V^T; K6: S^T = K Q^T and
//    dP^T = V dO^T) take their B fragments by one `ldmatrix.x4` per two
//    products; P = 2^(s scale log2 e - lse) on the SFU (ex2.approx) with
//    the lse K3 wrote, dS = P (dP - delta); P and dS, packed to bf16 from
//    the accumulators, are the A operand of the accumulating products
//    (K5: dQ += dS K; K6: dV += P^T dO and dK += dS^T Q), whose B
//    fragments come by `ldmatrix.x4.trans`.  Sixteen rows at a time keep
//    16 f32 of logits live, not 64, so that the held fragments and the
//    accumulators (K6 at d = 80: 40 + 80 registers) fit without spills.
//    The scale multiplies dQ and dK once, at the store.
//  * K5 computes delta = rowsum(dO O) for its rows first, two lanes a row
//    with 16-byte loads, in f32, while its first tiles land, and writes it
//    for K6.
//  * Rows past S are zero-filled, so they add nothing to any product; the
//    last tile's P is masked to 0 past S as well.
//  * Occupancy (attention_bwd_occupancy reads it from the runtime;
//    chip_smoke.py prints it): each variant's launch bound is the most
//    blocks an SM that compile without spills.  On an H100: d = 40, both
//    kernels 128 rows a block at 128 registers, two blocks (16 warps) an
//    SM; d = 80, 128 rows at 224 (K5) and 255 (K6) registers, one block
//    (here registers buy more than warps); d = 64, K5 as at d = 40, K6 64
//    rows at 168 registers, three blocks.  The pair then takes 1.20 ms at
//    (4, 4096, 8, 40) and 0.17 at (4, 1024, 8, 80) (PERF.md, Findings).
#pragma once

#include "mma.cuh"

namespace sdtk {
namespace {

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, S), log2 domain, from K3
  float* delta;      // (B, H, S): written by K5, read by K6
  bf16 *dq, *dk, *dv;  // (B, S, H, D) contiguous
  long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss;  // in elements
  int H, S, D, DQ;  // DQ: head dim padded to a multiple of 16
  float scale, scale_log2;
};

// Rows `row` and `row + 8` of a (B, S, H, D) output, times `mul`: columns
// d0 + 8j + 2t.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, float (&acc)[NT][4], int b, int h,
                                           int row, int d0, const BwdArgs& a, int t, float mul) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = d0 + 8 * j + 2 * t;
    if (c >= a.D) continue;
    if (row < a.S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * a.S + row) * a.H + h) * a.D + c) =
          pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (row + 8 < a.S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * a.S + row + 8) * a.H + h) * a.D + c) =
          pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// delta = rowsum(dO O) in f32 for the 16 rows r0 .. r0 + 15 of a warp
// ((B, S, H, D) views of one head at ob and db): lanes 2r and 2r + 1 take
// row r's 16-byte pieces in turn, and both return its sum; lane 2r writes
// it.  Rows at or past S give 0.
__device__ __forceinline__ float warp_delta(const BwdArgs& a, const bf16* ob, const bf16* db,
                                            int bh, int r0, int lane) {
  const int row = r0 + (lane >> 1);
  float acc = 0.f;
  if (row < a.S) {
    for (int c = 8 * (lane & 1); c < a.D; c += 16) {
      Pack8 x, y;
      x.u = *reinterpret_cast<const uint4*>(ob + row * a.o_ss + c);
      y.u = *reinterpret_cast<const uint4*>(db + row * a.do_ss + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(to_f(x.h[i]), to_f(y.h[i]), acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((lane & 1) == 0 && row < a.S) a.delta[(long)bh * a.S + row] = acc;
  return acc;
}

constexpr int BWD_STAGES = 3;  // streamed tiles in the ring

template <int DP, int ROWS, int TILE>
struct BwdRing {
  static constexpr int THREADS = 2 * ROWS;          // a warp per 16 owned rows
  static constexpr int LD = DP + 8;                 // padded row, elements
  static constexpr int OWN = ROWS * LD * 2;         // bytes of one owned tile
  static constexpr int STREAM = TILE * LD * 2;      // bytes of one streamed tile
  static constexpr int STAT = TILE * 4;             // bytes of one tile's lse (or delta)
  static constexpr int STAGE_DQ = 2 * STREAM;                  // K5: K, V
  static constexpr int STAGE_DKV = 2 * STREAM + 2 * STAT;      // K6: Q, dO, lse, delta
  // The two owned tiles are staged in the ring's last buffer (and past it
  // if larger), which the prologue leaves empty: read once into registers,
  // they are dead before tile BWD_STAGES - 1 lands there.
  static constexpr int SMEM_DQ =
      (BWD_STAGES - 1) * STAGE_DQ + (2 * OWN > STAGE_DQ ? 2 * OWN : STAGE_DQ);
  static constexpr int SMEM_DKV =
      (BWD_STAGES - 1) * STAGE_DKV + (2 * OWN > STAGE_DKV ? 2 * OWN : STAGE_DKV);
};

// Lane offsets, in bytes, into a tile of rows LD elements apart.  koff: the
// ldmatrix.x4 rows that give b0, b1 of two 8-row B tiles over 16 columns
// (matrices (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)).
// toff: the ldmatrix.x4.trans rows that give b0, b1 of two 8-column B
// tiles over 16 rows (rows lane & 15, columns 8 (lane >> 4)); also the A
// fragment of 16 rows x 16 columns by ldmatrix.x4.
template <int LD>
__device__ __forceinline__ uint32_t koff_bytes(int lane) {
  return (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8) * 2;
}
template <int LD>
__device__ __forceinline__ uint32_t toff_bytes(int lane) {
  return ((lane & 15) * LD + (lane >> 4) * 8) * 2;
}

// acc (16 x 16: two m16n8 tiles) += A B^T over DP: A the held fragments,
// B 16 rows of a streamed tile at `tile` (+ this lane's koff).
template <int KT>
__device__ __forceinline__ void mma_held(float (&acc)[2][4], const uint32_t (&a)[KT][4],
                                         uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t f[4];
    ldmatrix_x4(f, tile + kk * 32);
    mma16816(acc[0], a[kk], f[0], f[1]);
    mma16816(acc[1], a[kk], f[2], f[3]);
  }
}

// acc (16 x 8 NO) += A B: A the 16 x 16 bf16 fragment pa, B 16 rows of a
// streamed tile at `tile` (+ this lane's toff), all NO 8-column tiles.
template <int NO>
__device__ __forceinline__ void mma_trans(float (&acc)[NO][4], const uint32_t (&pa)[4],
                                          uint32_t tile) {
#pragma unroll
  for (int j = 0; j < NO; j += 2) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, tile + j * 16);
    mma16816(acc[j], pa, f[0], f[1]);
    mma16816(acc[j + 1], pa, f[2], f[3]);
  }
}

// The A fragment of one 16-deep step from two m16n8 accumulator tiles.
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4], const float (&x)[2][4]) {
  pa[0] = pack_bf16(x[0][0], x[0][1]);
  pa[1] = pack_bf16(x[0][2], x[0][3]);
  pa[2] = pack_bf16(x[1][0], x[1][1]);
  pa[3] = pack_bf16(x[1][2], x[1][3]);
}

// K5, ring body: dQ and delta for ROWS query rows; K/V tiles of TILE keys.
// MINB: the blocks an SM promised to ptxas (registers a thread at most
// 65536 / (2 ROWS MINB), and 255).
template <int DP, int ROWS, int TILE, int MINB>
__global__ void __launch_bounds__(2 * ROWS, MINB) bwd_dq_ring(BwdArgs a) {
  using C = BwdRing<DP, ROWS, TILE>;
  constexpr int LD = C::LD, KT = DP / 16, NO = DP / 8, STAGES = BWD_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);  // stage st: K, then V
  const uint32_t qs = ring + (STAGES - 1) * C::STAGE_DQ, dos = qs + C::OWN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * ROWS, S = a.S, D = a.D;
  const long hd = (long)h * D;
  const bf16* qb = a.q + b * a.q_sb + hd;
  const bf16* kb = a.k + b * a.k_sb + hd;
  const bf16* vb = a.v + b * a.v_sb + hd;
  const bf16* ob = a.o + b * a.o_sb + hd;
  const bf16* db = a.dout + b * a.do_sb + hd;
  const int ntiles = (S + TILE - 1) / TILE;

  auto load_kv = [&](int j) {  // tile j into stage j % STAGES: K, then V
    const uint32_t kd = ring + (j % STAGES) * C::STAGE_DQ, vd = kd + C::STREAM;
    const int k0 = j * TILE;
    copy_rows<TILE, DP, C::THREADS>(kb + k0 * a.k_ss, a.k_ss, S - k0, D,
                                    [&](int r, int p) { return kd + (r * LD + 8 * p) * 2; });
    copy_rows<TILE, DP, C::THREADS>(vb + k0 * a.v_ss, a.v_ss, S - k0, D,
                                    [&](int r, int p) { return vd + (r * LD + 8 * p) * 2; });
  };

  // The ring: Q and dO ride in commit group 0 with tile 0; tile j is group j.
  copy_rows<ROWS, DP, C::THREADS>(qb + q0 * a.q_ss, a.q_ss, S - q0, D,
                                  [&](int r, int p) { return qs + (r * LD + 8 * p) * 2; });
  copy_rows<ROWS, DP, C::THREADS>(db + q0 * a.do_ss, a.do_ss, S - q0, D,
                                  [&](int r, int p) { return dos + (r * LD + 8 * p) * 2; });
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load_kv(st);
    cp_async_commit();
  }

  // delta for this warp's 16 rows while the copies land; this lane's rows
  // in the mma layout are g and g + 8 of them
  float dl[2], lse[2];
  {
    const float acc = warp_delta(a, ob, db, bh, q0 + warp * 16, lane);
    dl[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = q0 + warp * 16 + g + 8 * e;
      lse[e] = r < S ? a.lse[(long)bh * S + r] : 0.f;
    }
  }

  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t qa[KT][4], da[KT][4];  // this warp's 16 rows of Q and dO, for the whole sweep
  const uint32_t aoff = (warp * 16 * LD) * 2 + toff_bytes<LD>(lane);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    ldmatrix_x4(qa[kk], qs + aoff + kk * 32);
    ldmatrix_x4(da[kk], dos + aoff + kk * 32);
  }
  __syncthreads();  // the staging buffer is the ring's last, which tile 0's step refills

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const uint32_t koff = koff_bytes<LD>(lane), toff = toff_bytes<LD>(lane);
  const float sl = a.scale_log2;

  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    }
    if (j + STAGES - 1 < ntiles) load_kv(j + STAGES - 1);  // into tile j - 1's stage
    cp_async_commit();

    const uint32_t kst = ring + (j % STAGES) * C::STAGE_DQ, vst = kst + C::STREAM;
    const int valid = min(TILE, S - j * TILE);
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {  // 16 keys at a time
      float s[2][4] = {}, dp[2][4] = {};
      mma_held<KT>(s, qa, kst + koff + c * 16 * LD * 2);   // S = Q K^T
      mma_held<KT>(dp, da, vst + koff + c * 16 * LD * 2);  // dP = dO V^T
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = fast_exp2(fmaf(s[n][i], sl, -lse[i >> 1]));
          if (valid < TILE && c * 16 + 8 * n + 2 * t + (i & 1) >= valid) p = 0.f;
          s[n][i] = p * (dp[n][i] - dl[i >> 1]);  // dS / scale
        }
      uint32_t pa[4];
      pack_a(pa, s);
      mma_trans<NO>(acc, pa, kst + toff + c * 16 * LD * 2);  // dQ += dS K
    }
  }
  store_rows<NO>(a.dq, acc, b, h, q0 + warp * 16 + g, 0, a, t, a.scale);
}

// K6, ring body: dK and dV for ROWS key rows; Q/dO tiles of TILE queries.
template <int DP, int ROWS, int TILE, int MINB>
__global__ void __launch_bounds__(2 * ROWS, MINB) bwd_dkv_ring(BwdArgs a) {
  using C = BwdRing<DP, ROWS, TILE>;
  constexpr int LD = C::LD, KT = DP / 16, NO = DP / 8, STAGES = BWD_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);  // stage st: Q, dO, lse, delta
  const uint32_t ks = ring + (STAGES - 1) * C::STAGE_DKV, vs = ks + C::OWN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.x * ROWS, S = a.S, D = a.D;
  const long hd = (long)h * D;
  const bf16* qb = a.q + b * a.q_sb + hd;
  const bf16* db = a.dout + b * a.do_sb + hd;
  const float* lseb = a.lse + (long)bh * S;
  const float* dlb = a.delta + (long)bh * S;
  const int ntiles = (S + TILE - 1) / TILE;

  auto load_q = [&](int j) {  // tile j into stage j % STAGES
    const uint32_t qd = ring + (j % STAGES) * C::STAGE_DKV, dd = qd + C::STREAM;
    const uint32_t sd = dd + C::STREAM;  // lse, then delta
    const int r0 = j * TILE;
    copy_rows<TILE, DP, C::THREADS>(qb + r0 * a.q_ss, a.q_ss, S - r0, D,
                                    [&](int r, int p) { return qd + (r * LD + 8 * p) * 2; });
    copy_rows<TILE, DP, C::THREADS>(db + r0 * a.do_ss, a.do_ss, S - r0, D,
                                    [&](int r, int p) { return dd + (r * LD + 8 * p) * 2; });
    if (tid < TILE / 2) {  // TILE / 4 pieces of 4 rows each for lse and for delta
      const int which = tid >= TILE / 4, p = tid - which * (TILE / 4);
      const float* src = which ? dlb : lseb;
      const bool ok = r0 + 4 * p < S;  // S % 4 == 0: a piece is all in or all out
      cp_async16(sd + which * C::STAT + 16 * p, ok ? src + r0 + 4 * p : src, ok);
    }
  };

  copy_rows<ROWS, DP, C::THREADS>(a.k + b * a.k_sb + hd + k0 * a.k_ss, a.k_ss, S - k0, D,
                                  [&](int r, int p) { return ks + (r * LD + 8 * p) * 2; });
  copy_rows<ROWS, DP, C::THREADS>(a.v + b * a.v_sb + hd + k0 * a.v_ss, a.v_ss, S - k0, D,
                                  [&](int r, int p) { return vs + (r * LD + 8 * p) * 2; });
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load_q(st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t ka[KT][4], va[KT][4];  // this warp's 16 key rows of K and V, for the whole sweep
  const uint32_t aoff = (warp * 16 * LD) * 2 + toff_bytes<LD>(lane);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    ldmatrix_x4(ka[kk], ks + aoff + kk * 32);
    ldmatrix_x4(va[kk], vs + aoff + kk * 32);
  }
  __syncthreads();  // the staging buffer is the ring's last, which tile 0's step refills

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  const uint32_t koff = koff_bytes<LD>(lane), toff = toff_bytes<LD>(lane);
  const float sl = a.scale_log2;

  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    }
    if (j + STAGES - 1 < ntiles) load_q(j + STAGES - 1);  // into tile j - 1's stage
    cp_async_commit();

    const int off = (j % STAGES) * C::STAGE_DKV;
    const uint32_t qst = ring + off, dst = qst + C::STREAM;
    const float* lst = reinterpret_cast<const float*>(smem + off + 2 * C::STREAM);
    const float* dlst = lst + TILE;
    const int valid = min(TILE, S - j * TILE);
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {  // 16 queries at a time
      float st[2][4] = {}, dpt[2][4] = {};
      mma_held<KT>(st, ka, qst + koff + c * 16 * LD * 2);   // S^T = K Q^T
      mma_held<KT>(dpt, va, dst + koff + c * 16 * LD * 2);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = c * 16 + 8 * n + 2 * t;  // this lane's queries: col, col + 1
        const float2 l = *reinterpret_cast<const float2*>(lst + col);
        const float2 dl = *reinterpret_cast<const float2*>(dlst + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = fast_exp2(fmaf(st[n][i], sl, -((i & 1) ? l.y : l.x)));
          if (valid < TILE && col + (i & 1) >= valid) p = 0.f;
          st[n][i] = p;                                          // P^T
          dpt[n][i] = p * (dpt[n][i] - ((i & 1) ? dl.y : dl.x));  // dS^T / scale
        }
      }
      uint32_t pa[4], sa[4];
      pack_a(pa, st);
      pack_a(sa, dpt);
      mma_trans<NO>(dv, pa, dst + toff + c * 16 * LD * 2);  // dV += P^T dO
      mma_trans<NO>(dk, sa, qst + toff + c * 16 * LD * 2);  // dK += dS^T Q
    }
  }
  const int row = k0 + warp * 16 + g;
  store_rows<NO>(a.dk, dk, b, h, row, 0, a, t, a.scale);
  store_rows<NO>(a.dv, dv, b, h, row, 0, a, t, 1.f);
}

}  // namespace
}  // namespace sdtk
