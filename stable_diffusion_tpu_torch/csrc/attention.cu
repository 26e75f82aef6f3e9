// K3: non-causal attention over (B, S, H, D) bf16 with an optional kv length.
//
// Replaces three TPU kernels of stable_diffusion_tpu/ops/flash_attention.py:
// `_single_pass_kernel` (K/V resident, `_flash_merged_single`),
// `_flash_kernel` (online softmax, `_flash_merged_online`) and
// `_cross_kernel` (77-token cross-attention masked by `kv_len`,
// `_flash_cross_merged`).
//
// What bounds it on Hopper: the two products Q K^T and P V on the tensor
// cores, and one exponential per logit on the special-function units
// (16 a clock per SM: at the UNet's head dims 40-80 the exponentials take
// as long as the products).  Reading Q, K and V once is small next to
// that, so the aim is to keep the S x S logits out of device memory, the
// tensor cores busy and the exponentials beside the products, not after
// them.
//
// Four bodies; `attention_plan` (ops/flash_attention.py) picks one, its tile
// and its splits, and passes them in.  Every K3 call of the four paths
// (SD1.5 and SD2.1 serving, W8A8 serving, the train step) takes the ring,
// cross or wide body; the general body only takes shapes none of them does.
//
// * The ring body, for self-attention (Sq == Sk == kv_len) at a head dim
//   padded to a multiple of 16 of 48, 64 or 80: every UNet self-attention
//   of SD1.5 and SD2.1 (d = 40, 64, 80).  A block owns BQ query rows of one
//   (batch, head), 16 rows per warp; K/V tiles of 64 keys stream through a
//   cp.async ring of three buffers, one commit group and one barrier per
//   tile, so tiles j+1 and j+2 are in flight while tile j computes.  Q is
//   copied once and its m16n8k16 A fragments taken by `ldmatrix` into
//   registers for the whole key loop (4 DP / 16 registers).  S = Q K^T on
//   `mma.sync` m16n8k16 with K's B fragments by `ldmatrix.x4` (one load per
//   two products), K and V in rows padded by 16 bytes so that eight rows
//   hit eight bank groups.  The scale is folded into the exponent: p =
//   2^(s * scale log2 e - m) on the SFU (ex2.approx), with the running max m
//   kept in that domain.  P V runs on `mma.sync` from the logits'
//   accumulators repacked to bf16 (the accumulator layout of two 8-key
//   tiles is the A fragment of one 16-key step), V's B fragments by
//   `ldmatrix.trans`.  Keys past Sk are zero-filled and masked in the last
//   tile only; query rows past Sq are zero and never stored.
//   Measured on an H100 and not kept: S on `wgmma` (A = Q from registers,
//   B = K in the 128-byte swizzle) issued a tile ahead so that the
//   exponentials ran beside it, with P V still on `mma.sync`: right, but
//   no faster at d = 40 (PERF.md, Findings).
// * The cross body (`_cross_kernel`), for at most 128 keys that are not a
//   plain self-attention (Sq != Sk, or kv_len < Sk): every 77-token text
//   cross-attention (SD1.5 d = 40, 80, 160; SD2.1 d = 64).  It is bound by
//   bytes: Q read once, O written once (K and V are 77 rows a head).  A
//   block owns one (batch, head) and a run of query tiles; the head's K and
//   V come into shared memory once, zero-filled to NK = 80 or 128 keys, and
//   serve all its tiles; Q tiles stream through a ring of two or three
//   cp.async buffers; each warp's 16 rows take one exact softmax over all
//   keys in registers (no online rescale; keys at or past kv_len masked),
//   and O leaves in 16-byte row pieces.
// * The wide body (`_single_pass_kernel` / `_flash_kernel` at padded head
//   dims 160 and 512: SD1.5's d = 160 self-attention at s = 256 and 64, the
//   VAE's single d = 512 head at s = 4096 and 9216).  A 64 x 512 f32
//   output is 256 registers a thread in one warpgroup, so the output is
//   split by columns across warps (d = 512: eight warps of 64 x 64, 128
//   registers each) while S of each 64-key tile is computed once, by
//   warpgroup 0 on `wgmma` (m64n64k16, Q and K by descriptor straight from
//   their TMA boxes): every logit is computed once and its exponential
//   taken once (B H Sq Sk of them at every path shape, whose lengths are
//   multiples of 64), P (bf16) and the row statistics handed to the other
//   warps through shared memory.  Q, K and V arrive by TMA (one thread,
//   64-column boxes in the 128-byte swizzle, mbarriers); K tile j + 1 loads
//   under P V of tile j, V tile j + 1 under S of tile j + 1.  Where the
//   query tiles leave SMs idle (s = 4096: 64 tiles for 132 SMs) the keys
//   are split across blocks; each split writes its unnormalized O and (m,
//   l) and a second launch merges them in split order (deterministic; the
//   log-sum-exp the same value).  P V stays on `mma.sync` (P's fragments by
//   ldmatrix, V's by ldmatrix.trans: 0.25 x4 loads a product at 64 x 64
//   blocks).  Measured on an H100 and not kept: S on `mma.sync` too, 16
//   warps of 16 x 16 blocks (one x4 load a product, ~1.4x slower at d = 512:
//   PERF.md, Findings).
// * The general body (the first design), for shapes no other body takes
//   (head dims the others do not compile; Sq != Sk with more than 128
//   keys): 64 query rows a block, 64-key tiles loaded synchronously into
//   one buffer, Q's fragments read from shared memory at every tile.  The
//   output accumulator holds at most 160 columns; wider heads run as
//   128-column passes, one pass per blockIdx.z, each recomputing the
//   logits.  The row log-sum-exp is written by pass 0.
//
// Softmax statistics stay in f32; P is rounded to bf16 before P V.  For a
// training step the kernel also writes each row's log-sum-exp in the log2
// domain (f32 (B, H, Sq)), so that the backward (K5/K6, attention_bwd.cu)
// need not recompute the row statistics.
#include <math.h>

#include "mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace sdtk {
namespace {

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;  // (B, Sq, H, D) contiguous
  float* lse;  // (B, H, Sq) log2(sum_k exp2(s_k * scale * log2 e)), or null
  long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;  // batch and sequence strides, in elements
  int H, Sq, Sk, D, DQ, passes, kv_len;     // DQ: padded head dim held in shared memory
  float scale_log2;  // scale * log2(e)
};

// The cross and wide bodies' launch (the general and ring bodies take the
// base alone: its layout is theirs).
struct AttnArgsX : AttnArgs {
  int tiles;         // cross: query tiles a block
  int splits;        // wide: key splits (blockIdx.z)
  float* ws;         // wide, splits > 1: (splits, B H Sq, D) partial O, then (splits, B H Sq) m, then l
};

// ---------------------------------------------------------------------------
// The general body
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block (4 warps x 16)
constexpr int BKV = 64; // keys per tile
constexpr int THREADS = 128;
constexpr int kMaxSmem = 232448;  // 227 KB a block may use on Hopper

template <int DC>  // output columns per pass, a multiple of 16
__global__ void __launch_bounds__(THREADS) attention_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NT = DC / 8;  // 8-column output tiles per pass
  const int DQ = a.DQ, LD = DQ + 8, D = a.D;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * BQ;
  const int pass = blockIdx.z, d0 = pass * DC;
  const bf16* qb = a.q + b * a.q_sb + (long)h * D;
  const bf16* kb = a.k + b * a.k_sb + (long)h * D;
  const bf16* vb = a.v + b * a.v_sb + (long)h * D;
  const int vpr = DQ / 8;  // 16-byte vectors per padded row

  for (int idx = tid; idx < BQ * vpr; idx += THREADS) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < a.Sq && c < D) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * a.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }

  const bf16* qw = Qs + (warp * 16) * LD;  // this warp's 16 query rows
  const int nkb = (a.kv_len + BKV - 1) / BKV;
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int kbk = 0; kbk < nkb; ++kbk) {
    const int k0 = kbk * BKV;
    __syncthreads();  // the previous tile (and, first, the Q tile) is done with
    for (int idx = tid; idx < BKV * vpr; idx += THREADS) {
      const int r = idx / vpr, c = (idx - r * vpr) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < a.kv_len && c < D) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * a.k_ss + c);
        if (c >= d0 && c < d0 + DC) vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * a.v_ss + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv;
    }
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, eight 8-key tiles.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < DQ / 16; ++kk) {
      uint32_t qa[4];
      const bf16* qp = qw + g * LD + kk * 16 + 2 * t;
      qa[0] = lds32(qp);
      qa[1] = lds32(qp + 8 * LD);
      qa[2] = lds32(qp + 8);
      qa[3] = lds32(qp + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kp = Ks + (8 * j + g) * LD + kk * 16 + 2 * t;
        mma16816(s[j], qa, lds32(kp), lds32(kp + 8));
      }
    }

    // Online softmax in registers; lanes 4g..4g+3 share rows g and g + 8.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + 8 * j + 2 * t + e < a.kv_len;
        s[j][e] = ok ? s[j][e] * a.scale_log2 : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * a.scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o2);
    }
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }

    // O += P V: P's A fragments are the logits' accumulators, repacked.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // lane l addresses key row kk*16 + (l & 15), columns +8 for lanes 16..31
      const bf16* vp = Vs + (kk * 16 + (lane & 15)) * LD + d0 + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vp + j * 8);
        mma16816(o[j], pa, vb4[0], vb4[1]);
        mma16816(o[j + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

  // O / l -> bf16 for this pass's columns.
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g;
  if (a.lse != nullptr && pass == 0 && t == 0) {  // lanes 4g..4g+3 hold the same row stats
    if (r0 < a.Sq) a.lse[(long)bh * a.Sq + r0] = m0 + log2f(l0);
    if (r0 + 8 < a.Sq) a.lse[(long)bh * a.Sq + r0 + 8] = m1 + log2f(l1);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = d0 + 8 * j + 2 * t;
    if (c >= D) continue;
    if (r0 < a.Sq)
      *reinterpret_cast<uint32_t*>(a.o + (((long)b * a.Sq + r0) * a.H + h) * D + c) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r0 + 8 < a.Sq)
      *reinterpret_cast<uint32_t*>(a.o + (((long)b * a.Sq + r0 + 8) * a.H + h) * D + c) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

int general_smem(int DQ) { return (BQ + 2 * BKV) * (DQ + 8) * 2; }

// ---------------------------------------------------------------------------
// The self-attention body
// ---------------------------------------------------------------------------

constexpr int RING_BKV = 64;   // keys per tile
constexpr int RING_STAGES = 3; // K/V tiles in the ring

// One warp's online softmax over its 16 x 64 raw logits s (Q K^T, unscaled;
// the m16n8 accumulator layout per 8-key tile: rows g and g + 8 of lane
// 4 g + t), then O += P V over the tile.  Keys at or past `valid` are
// masked.  m: running row maxima in the log2 domain of the scaled logits;
// l: this lane's partial row sums (the four lanes of a row are added at the
// end).  vaddr: the shared address of this lane's ldmatrix.trans row in
// the V tile (key lane & 15, column 8 (lane >> 4)), rows LDV elements
// apart.
template <int NO, int LDV>
__device__ __forceinline__ void softmax_pv(float* s, float* o, float* m, float* l, int valid,
                                           float sl, uint32_t vaddr, int t) {
  constexpr int NS = RING_BKV / 8;
  if (valid < RING_BKV) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * t + e >= valid) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float al[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    // sl > 0, so the max of the scaled logits is the scaled max; every tile
    // holds a valid key, so the new max is finite
    const float mn = fmaxf(m[e], mx[e] * sl);
    al[e] = fast_exp2(m[e] - mn);  // 0 on the first tile
    m[e] = mn;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[4 * j + i] = fast_exp2(fmaf(s[4 * j + i], sl, -m[i >> 1]));
    sum[0] += s[4 * j] + s[4 * j + 1];
    sum[1] += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * al[e] + sum[e];
#pragma unroll
  for (int i = 0; i < 4 * NO; ++i) o[i] *= al[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const float* x = s + 8 * kk;
    const uint32_t pa[4] = {pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                            pack_bf16(x[6], x[7])};
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vaddr + (uint32_t)((kk * 16 * LDV + j * 8) * 2));
      mma16816(o + 4 * j, pa, vf[0], vf[1]);
      mma16816(o + 4 * j + 4, pa, vf[2], vf[3]);
    }
  }
}

template <int DP, int BQ_>
struct RingCfg {
  static constexpr int THREADS = 2 * BQ_;         // a warp per 16 query rows
  static constexpr int LD = DP + 8;               // padded row, elements
  static constexpr int TILE = RING_BKV * LD * 2;  // bytes of one K or V tile
  static constexpr int SMEM = BQ_ * LD * 2 + RING_STAGES * 2 * TILE;
};

// Up to 128 query rows a block (8 warps), at most 128 registers a thread so
// that two blocks share an SM.
template <int DP, int BQ_>
__global__ void __launch_bounds__(2 * BQ_, BQ_ <= 128 ? 2 : 1) attention_kernel_ring(AttnArgs a) {
  using C = RingCfg<DP, BQ_>;
  constexpr int LD = C::LD, KT = DP / 16, NS = RING_BKV / 8, NO = DP / 8, STAGES = RING_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem), ring = qs + BQ_ * LD * 2;  // stage st: K, then V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * BQ_, S = a.Sk, D = a.D;
  const bf16* qb = a.q + b * a.q_sb + (long)h * D;
  const bf16* kb = a.k + b * a.k_sb + (long)h * D;
  const bf16* vb = a.v + b * a.v_sb + (long)h * D;
  const int ntiles = (S + RING_BKV - 1) / RING_BKV;

  auto load_kv = [&](int j) {
    const uint32_t kd = ring + (j % STAGES) * 2 * C::TILE, vd = kd + C::TILE;
    const int k0 = j * RING_BKV;
    copy_rows<RING_BKV, DP, C::THREADS>(kb + k0 * a.k_ss, a.k_ss, S - k0, D,
                                        [&](int r, int p) { return kd + (r * LD + 8 * p) * 2; });
    copy_rows<RING_BKV, DP, C::THREADS>(vb + k0 * a.v_ss, a.v_ss, S - k0, D,
                                        [&](int r, int p) { return vd + (r * LD + 8 * p) * 2; });
  };

  // The ring: Q rides in commit group 0 with tile 0; tile j is group j.
  copy_rows<BQ_, DP, C::THREADS>(qb + q0 * a.q_ss, a.q_ss, a.Sq - q0, D,
                                 [&](int r, int p) { return qs + (r * LD + 8 * p) * 2; });
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load_kv(st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();

  uint32_t qa[KT][4];  // this warp's 16 rows of Q, for the whole key loop
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qa[kk], qs + ((warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8) * 2);

  float o[NO * 4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  // K's x4: matrices (keys 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  // = b0, b1 of two 8-key tiles; V's x4.trans: keys lane & 15, cols 8 (lane >> 4)
  const uint32_t koff = (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t voff = ((lane & 15) * LD + (lane >> 4) * 8) * 2;

  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    }
    if (j + STAGES - 1 < ntiles) load_kv(j + STAGES - 1);  // into tile j - 1's stage
    cp_async_commit();

    const uint32_t kst = ring + (j % STAGES) * 2 * C::TILE;
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int jj = 0; jj < NS; jj += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kst + koff + (uint32_t)((jj * 8 * LD + kk * 16) * 2));
        mma16816(s + 4 * jj, qa[kk], kf[0], kf[1]);
        mma16816(s + 4 * jj + 4, qa[kk], kf[2], kf[3]);
      }
    }
    softmax_pv<NO, LD>(s, o, m, l, min(RING_BKV, S - j * RING_BKV), a.scale_log2,
                       kst + C::TILE + voff, t);
  }

  // O / l to bf16 and the row log-sum-exp: rows r0 + g and r0 + g + 8.
  const int r0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float sum = l[e];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = r0 + 8 * e;
    if (r >= a.Sq) continue;
    if (a.lse != nullptr && t == 0) a.lse[(long)bh * a.Sq + r] = m[e] + log2f(sum);
    const float inv = 1.f / sum;
    bf16* row = a.o + (((long)b * a.Sq + r) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      if (8 * j + 2 * t < D)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(o[4 * j + 2 * e] * inv, o[4 * j + 2 * e + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// The cross body
// ---------------------------------------------------------------------------

constexpr int CROSS_BQ = 64;  // query rows a tile: 4 warps x 16 rows, per head
constexpr int CROSS_THREADS = 128;

// Shared memory of a cross block: its head's K and V (NK keys, rows of DP +
// 8: 16 bytes of padding, so eight rows of an ldmatrix fall in eight bank
// groups), then two or three Q buffers of 64 rows of DP + 8.
template <int DP, int NK>
struct CrossCfg {
  static constexpr int LD = DP + 8;
  // blocks an SM the registers are held to (__launch_bounds__)
  static constexpr int MINB = DP <= 64 ? (NK <= 80 ? 4 : 3) : DP <= 80 ? 3 : 2;
  // Q buffers: three where a block has three tiles or more, else two
  __host__ __device__ static constexpr int nbuf(int tiles) { return tiles >= 3 ? 3 : 2; }
  __host__ __device__ static constexpr int smem(int tiles) { return (2 * NK + nbuf(tiles) * CROSS_BQ) * LD * 2; }
};

// A block owns one (batch, head) and a run of `tiles` query tiles.  The
// head's K and V (kv_len keys, zero-filled to NK) come once into shared
// memory and serve every tile; Q tiles stream through a ring of cp.async
// buffers (tiles i + 1 and, with three buffers, i + 2 are in flight while
// tile i computes and leaves).  Each warp takes 16 rows: S = Q K^T over all
// NK keys in registers, one exact softmax (keys at or past kv_len masked,
// the scale folded into ex2), P V from the logits' accumulators repacked to
// bf16.  O goes back into the warp's own Q rows, and the tile leaves in
// 16-byte pieces of its rows.  (Two adjacent heads a block, a 160-byte Q
// row segment at d = 40, measured slower on an H100: PERF.md, Findings.)
template <int DP, int NK>
__global__ void __launch_bounds__(CROSS_THREADS, CrossCfg<DP, NK>::MINB) attention_kernel_cross(AttnArgsX a) {
  using C = CrossCfg<DP, NK>;
  constexpr int LD = C::LD, KT = DP / 16, NS = NK / 8, NO = DP / 8;
  constexpr int NOC = NO % 10 == 0 ? 10 : NO;  // 8-column output tiles a chunk: at most 80 columns
  static_assert(NS % 2 == 0 && NOC % 2 == 0 && NO % NOC == 0, "x4 loads take two 8-wide tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, H = a.H, VPR = D / 8, NBUF = C::nbuf(a.tiles);
  const uint32_t ks = smem_u32(smem), vs = ks + NK * LD * 2, qs = vs + NK * LD * 2;
  bf16* qsp = reinterpret_cast<bf16*>(smem + 4 * NK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int ntile = (a.Sq + CROSS_BQ - 1) / CROSS_BQ;
  const int tile0 = blockIdx.x * a.tiles, tile1 = min(ntile, tile0 + a.tiles);
  const bf16* qb = a.q + b * a.q_sb + (long)h * D;
  const bf16* kb = a.k + b * a.k_sb + (long)h * D;
  const bf16* vb = a.v + b * a.v_sb + (long)h * D;

  if (D < DP)  // columns D .. DP of every Q buffer stay zero (O writes zeros there too)
    for (int r = tid; r < NBUF * CROSS_BQ; r += CROSS_THREADS)
      for (int c = D; c < DP; c += 8) *reinterpret_cast<uint4*>(qsp + r * LD + c) = make_uint4(0, 0, 0, 0);

  auto load_q = [&](int tile, int buf) {  // query rows [q0, q0 + 64), rows past Sq zero
    const int q0 = tile * CROSS_BQ, rows = a.Sq - q0;
    const uint32_t dst = qs + buf * CROSS_BQ * LD * 2;
    for (int idx = tid; idx < CROSS_BQ * VPR; idx += CROSS_THREADS) {
      const int r = idx / VPR, p = idx - r * VPR;
      const bool ok = r < rows;
      cp_async16(dst + (r * LD + 8 * p) * 2, ok ? qb + (long)(q0 + r) * a.q_ss + 8 * p : qb, ok);
    }
  };
  // K and V once, zero past kv_len and column D
  copy_rows<NK, DP, CROSS_THREADS>(kb, a.k_ss, a.kv_len, D, [&](int r, int p) { return ks + (r * LD + 8 * p) * 2; });
  copy_rows<NK, DP, CROSS_THREADS>(vb, a.v_ss, a.kv_len, D, [&](int r, int p) { return vs + (r * LD + 8 * p) * 2; });
  if (tile0 < tile1) load_q(tile0, 0);
  cp_async_commit();  // group 0: K, V and tile 0
  if (tile0 + 1 < tile1) load_q(tile0 + 1, 1);
  cp_async_commit();  // group 1: tile 1

  // K's x4: (keys 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15); V's
  // x4.trans: keys lane & 15, columns 8 (lane >> 4); Q's x4: rows lane & 15,
  // columns 8 (lane >> 4).
  const uint32_t koff = (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t voff = ((lane & 15) * LD + (lane >> 4) * 8) * 2;
  const float sl = a.scale_log2;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int buf = (tile - tile0) % NBUF, q0 = tile * CROSS_BQ;
    cp_async_wait<1>();
    __syncthreads();  // tile `tile` (and, first, K and V) has landed; with two buffers, tile - 1 has left
    bf16* qt = qsp + buf * CROSS_BQ * LD;
    // S = Q K^T over all NK keys: this warp's rows 16 warp .. 16 warp + 15.
    const uint32_t qrow = smem_u32(qt) + ((warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8) * 2;
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qrow + kk * 32);
#pragma unroll
      for (int jj = 0; jj < NS; jj += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + koff + (uint32_t)((jj * 8 * LD + kk * 16) * 2));
        mma16816(s + 4 * jj, qa, kf[0], kf[1]);
        mma16816(s + 4 * jj + 4, qa, kf[2], kf[3]);
      }
    }
    // One exact softmax over the keys: rows g and g + 8 of lane 4 g + t.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * jj + 2 * t + e >= a.kv_len) s[4 * jj + e] = s[4 * jj + 2 + e] = -INFINITY;
      m[0] = fmaxf(m[0], fmaxf(s[4 * jj], s[4 * jj + 1]));
      m[1] = fmaxf(m[1], fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], 1));
      m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], 2));
      m[e] *= sl;  // sl > 0: the max of the scaled logits; kv_len >= 1 keeps it finite
    }
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[4 * jj + i] = fast_exp2(fmaf(s[4 * jj + i], sl, -m[i >> 1]));
      l[0] += s[4 * jj] + s[4 * jj + 1];
      l[1] += s[4 * jj + 2] + s[4 * jj + 3];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    }
    // O = P V / l in chunks of NOC 8-column tiles (the softmax is exact, so
    // each chunk is final as it leaves), to bf16 in place of the warp's own
    // Q rows; the row log-sum-exp.
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll 1
    for (int c0 = 0; c0 < NO; c0 += NOC) {
      float o[NOC * 4];
#pragma unroll
      for (int i = 0; i < NOC * 4; ++i) o[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const float* x = s + 8 * kk;
        const uint32_t pa[4] = {pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                                pack_bf16(x[6], x[7])};
#pragma unroll
        for (int jn = 0; jn < NOC; jn += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + voff + (uint32_t)((kk * 16 * LD + (c0 + jn) * 8) * 2));
          mma16816(o + 4 * jn, pa, vf[0], vf[1]);
          mma16816(o + 4 * jn + 4, pa, vf[2], vf[3]);
        }
      }
      bf16* orow = qt + (warp * 16 + (lane >> 2)) * LD + 8 * c0 + 2 * t;
#pragma unroll
      for (int jn = 0; jn < NOC; ++jn) {
        *reinterpret_cast<uint32_t*>(orow + 8 * jn) = pack_bf16(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
        *reinterpret_cast<uint32_t*>(orow + 8 * LD + 8 * jn) = pack_bf16(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
      }
    }
    if (a.lse != nullptr && t == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = q0 + warp * 16 + (lane >> 2) + 8 * e;
        if (r < a.Sq) a.lse[(long)bh * a.Sq + r] = m[e] + log2f(l[e]);
      }
    __syncthreads();  // the tile's O is staged
    if (NBUF == 3) {  // tile + 2 into the buffer tile - 1 left (every thread passed its barrier since)
      if (tile + 2 < tile1) load_q(tile + 2, (buf + 2) % 3);
      cp_async_commit();
    }
    for (int idx = tid; idx < CROSS_BQ * VPR; idx += CROSS_THREADS) {
      const int r = idx / VPR, p = idx - r * VPR;
      if (q0 + r < a.Sq)
        *reinterpret_cast<uint4*>(a.o + (((long)b * a.Sq + q0 + r) * H + h) * D + 8 * p) =
            *reinterpret_cast<const uint4*>(qt + r * LD + 8 * p);
    }
    if (NBUF == 2) {  // tile + 2 into this tile's buffer, once every thread's O has left it
      __syncthreads();
      if (tile + 2 < tile1) load_q(tile + 2, buf);
      cp_async_commit();
    }
  }
}

// ---------------------------------------------------------------------------
// The wide body
// ---------------------------------------------------------------------------

constexpr int WIDE_BQ = 64;  // query rows a block
constexpr int WIDE_BK = 64;  // keys a tile

// NW warps.  S of each 64 x 64 tile on warpgroup 0 (warps 0-3: rows 16 w ..
// 16 w + 15, all 64 keys); O split into RT-row x CT-column blocks, one a
// warp.  Shared memory, from a 1024-byte aligned base: the Q, K and V tiles
// as TMA boxes of 64 columns x 64 rows in the 128-byte swizzle (NB boxes
// each), P (64 rows of 64 + 8 bf16), the tile's row maxima and sums (64
// f32 each), and three mbarriers (Q, K, V landed).
template <int DP, int NW, int RT, int CT>
struct WideCfg {
  static constexpr int THREADS = 32 * NW;
  static constexpr int NB = (DP + 63) / 64;  // 64-column boxes a row
  static constexpr int TILE = NB * 64 * 128;
  static constexpr int LP = WIDE_BK + 8;
  static constexpr int SMEM = 1024 + 3 * TILE + WIDE_BQ * LP * 2 + 2 * WIDE_BQ * 4 + 64;
  static_assert(WIDE_BQ / RT * (DP / CT) == NW && NW % 4 == 0 && DP % CT == 0 && RT % 16 == 0 &&
                    CT % 16 == 0,
                "the O blocks cover the tile once");
};

// The shared address of the 16-byte piece (row r, columns c .. c + 7) of a
// tile of 64-column boxes in the 128-byte swizzle.
__device__ __forceinline__ uint32_t box_at(uint32_t tile, int r, int c) {
  return tile + (uint32_t)((c >> 6) * 8192) + swz(r, (c >> 3) & 7);
}

// A block owns 64 query rows of one (batch, head) and the key tiles of its
// split, [j0, j1).  One thread loads Q once and each 64-key K and V tile by
// TMA (one box per 64 columns, keys past kv_len zero), counted by an
// mbarrier each: K tile j + 1 loads while P V of tile j runs, V tile j + 1
// while S of tile j + 1 runs.  For each tile, warpgroup 0 computes S = Q K^T
// once on `wgmma` (m64n64k16, Q and K by descriptor straight from the
// boxes), each warp then its 16 rows' maxima over the 64 keys, the running
// max m (log2 domain of the scaled logits) and p = 2^(s sl - m), once per
// logit, into P (bf16), with the row maxima and sums; after a barrier
// every warp rescales its RT x CT block of O by 2^(m_old - m) and adds P V
// (`mma.sync`: P's fragments by ldmatrix, V's by ldmatrix.trans).  One
// split (splits == 1): O / l is staged in the Q tile's boxes and leaves in
// 16-byte row pieces, with the row log-sum-exp.  More: the split's
// unnormalized O (f32), m and l go to the workspace, and
// attention_merge_kernel adds the splits in split order.
template <int DP, int NW, int RT, int CT>
__global__ void __launch_bounds__(32 * NW, 1)
    attention_kernel_wide(AttnArgsX a, const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap) {
  using C = WideCfg<DP, NW, RT, CT>;
  constexpr int NB = C::NB, KT = DP / 16, RI = RT / 16, NO = CT / 8, CG = DP / CT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), qs = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (qs - raw);
  const uint32_t kst = qs + C::TILE, vst = kst + C::TILE, ps = vst + C::TILE;
  bf16* P = reinterpret_cast<bf16*>(smem + 3 * C::TILE);
  float* smax = reinterpret_cast<float*>(smem + 3 * C::TILE + WIDE_BQ * C::LP * 2);
  float* ssum = smax + WIDE_BQ;
  const uint32_t bars = ps + WIDE_BQ * C::LP * 2 + 2 * WIDE_BQ * 4;  // Q, K, V landed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H, q0 = blockIdx.x * WIDE_BQ, split = blockIdx.z;
  const int ntiles = (a.kv_len + WIDE_BK - 1) / WIDE_BK;
  const int j0 = split * ntiles / a.splits, j1 = (split + 1) * ntiles / a.splits;
  const int rr = warp / CG, cc = warp % CG;  // O: rows RT rr .., columns CT cc ..

  auto load = [&](uint32_t dst, const CUtensorMap* map, int row, uint32_t bar) {  // one thread
    mbar_expect(bar, C::TILE);
#pragma unroll
    for (int c = 0; c < NB; ++c) tma_load4(dst + c * 8192, map, 64 * c, h, row, b, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load(qs, &qmap, q0, bars);
    load(kst, &kmap, j0 * WIDE_BK, bars + 8);
    load(vst, &vmap, j0 * WIDE_BK, bars + 16);
  }
  __syncthreads();  // the mbarriers are initialized

  float o[RI * NO * 4], mo[2 * RI], lo[2 * RI], ms[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < RI * NO * 4; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * RI; ++i) mo[i] = -INFINITY, lo[i] = 0.f;
  const float sl = a.scale_log2;
  const uint64_t dq = sw128_desc(qs), dk = sw128_desc(kst);  // box c at + c * (8192 >> 4)
  if (warp < 4) mbar_wait(bars, 0);  // Q
  for (int j = j0; j < j1; ++j) {
    const int it = j - j0, valid = min(WIDE_BK, a.kv_len - j * WIDE_BK);
    if (warp < 4) {  // S, P and the row statistics of the tile
      mbar_wait(bars + 8, it & 1);  // K tile j
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        WgmmaSS<64>::mma(s, dq + (kk >> 2) * 512 + 2 * (kk & 3), dk + (kk >> 2) * 512 + 2 * (kk & 3));
      wgmma_commit();
      wgmma_wait0();
      fence_operands(s);
      // Rows 16 warp + g and + 8 of lane 4 g + t: keys 8 jj + 2 t (+1).
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (valid < WIDE_BK) {  // keys past kv_len, in the last tile only
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * jj + 2 * t + e >= valid) s[4 * jj + e] = s[4 * jj + 2 + e] = -INFINITY;
        }
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * jj], s[4 * jj + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        ms[e] = fmaxf(ms[e], mx[e] * sl);  // every tile holds a valid key: finite
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = fast_exp2(fmaf(s[4 * jj + 2 * e], sl, -ms[e]));
          const float p1 = fast_exp2(fmaf(s[4 * jj + 2 * e + 1], sl, -ms[e]));
          sum[e] += p0 + p1;
          *reinterpret_cast<uint32_t*>(P + (16 * warp + g + 8 * e) * C::LP + 8 * jj + 2 * t) = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
        if (t == 0) smax[16 * warp + g + 8 * e] = mx[e], ssum[16 * warp + g + 8 * e] = sum[e];
      }
    }
    mbar_wait(bars + 16, it & 1);  // V tile j
    __syncthreads();                // P and the row statistics are in; S is done with K tile j
    if (tid == 0 && j + 1 < j1) load(kst, &kmap, (j + 1) * WIDE_BK, bars + 8);

    // O = O 2^(m_old - m) + P V on the warp's RT x CT block.
#pragma unroll
    for (int i = 0; i < 2 * RI; ++i) {
      const int r = RT * rr + 16 * (i >> 1) + g + 8 * (i & 1);
      const float mn = fmaxf(mo[i], smax[r] * sl), al = fast_exp2(mo[i] - mn);  // 0 on the first tile
      mo[i] = mn;
      lo[i] = lo[i] * al + ssum[r];
#pragma unroll
      for (int jn = 0; jn < NO; ++jn) {
        o[((i >> 1) * NO + jn) * 4 + 2 * (i & 1)] *= al;
        o[((i >> 1) * NO + jn) * 4 + 2 * (i & 1) + 1] *= al;
      }
    }
#pragma unroll 1
    for (int kk = 0; kk < WIDE_BK / 16; ++kk) {
      uint32_t pa[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        ldmatrix_x4(pa[i], ps + ((RT * rr + 16 * i + (lane & 15)) * C::LP + kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int jn = 0; jn < NO; jn += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, box_at(vst, kk * 16 + (lane & 15), CT * cc + jn * 8 + (lane >> 4) * 8));
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          mma16816(o + (i * NO + jn) * 4, pa[i], vf[0], vf[1]);
          mma16816(o + (i * NO + jn + 1) * 4, pa[i], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with V tile j, P and the row statistics
    if (tid == 0 && j + 1 < j1) load(vst, &vmap, (j + 1) * WIDE_BK, bars + 16);
  }

  // Rows r of the warp's O block: lane 4 g + t holds r = RT rr + 16 i' + g (+ 8).
  if (a.splits == 1) {  // O / l to bf16, staged in the Q tile's boxes (every S is done)
#pragma unroll
    for (int i = 0; i < 2 * RI; ++i) {
      const int r = RT * rr + 16 * (i >> 1) + g + 8 * (i & 1);
      if (a.lse != nullptr && cc == 0 && t == 0 && q0 + r < a.Sq)
        a.lse[(long)bh * a.Sq + q0 + r] = mo[i] + log2f(lo[i]);
      const float inv = 1.f / lo[i];
#pragma unroll
      for (int jn = 0; jn < NO; ++jn) {
        const float* x = o + ((i >> 1) * NO + jn) * 4 + 2 * (i & 1);
        const int col = CT * cc + 8 * jn;
        *reinterpret_cast<uint32_t*>(smem + (box_at(qs, r, col) - qs) + 4 * t) = pack_bf16(x[0] * inv, x[1] * inv);
      }
    }
    __syncthreads();
    const int vpr = a.D / 8;
    for (int idx = tid; idx < WIDE_BQ * vpr; idx += C::THREADS) {
      const int r = idx / vpr, p = idx - r * vpr;
      if (q0 + r < a.Sq)
        *reinterpret_cast<uint4*>(a.o + (((long)b * a.Sq + q0 + r) * a.H + h) * a.D + 8 * p) =
            *reinterpret_cast<const uint4*>(smem + (box_at(qs, r, 8 * p) - qs));
    }
  } else {  // the split's partial: unnormalized O (f32; a quad writes 32-byte pieces), m and l
    const long rows = (long)gridDim.y * a.Sq;  // B H Sq
    float* wo = a.ws + ((long)split * rows + (long)bh * a.Sq) * a.D;
    float* wm = a.ws + (long)a.splits * rows * a.D + (long)split * rows + (long)bh * a.Sq;
    float* wl = wm + (long)a.splits * rows;
#pragma unroll
    for (int i = 0; i < 2 * RI; ++i) {
      const int r = RT * rr + 16 * (i >> 1) + g + 8 * (i & 1);
      if (q0 + r >= a.Sq) continue;
      if (cc == 0 && t == 0) wm[q0 + r] = mo[i], wl[q0 + r] = lo[i];
#pragma unroll
      for (int jn = 0; jn < NO; ++jn) {
        const float* x = o + ((i >> 1) * NO + jn) * 4 + 2 * (i & 1);
        const int col = CT * cc + 8 * jn + 2 * t;
        if (col < a.D) *reinterpret_cast<float2*>(wo + (long)(q0 + r) * a.D + col) = make_float2(x[0], x[1]);
      }
    }
  }
}

// The key splits of the wide body merged in split order: for each row, M =
// max m_s, L = sum_s 2^(m_s - M) l_s, O = sum_s 2^(m_s - M) O_s / L and the
// log-sum-exp M + log2 L; eight columns a thread.
__global__ void attention_merge_kernel(AttnArgsX a, long rows) {
  const int vpr = a.D / 8;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * vpr) return;
  const long row = i / vpr;
  const int c = (int)(i - row * vpr) * 8;
  const float* wm = a.ws + (long)a.splits * rows * a.D;
  const float* wl = wm + (long)a.splits * rows;
  float M = -INFINITY;
  for (int s = 0; s < a.splits; ++s) M = fmaxf(M, wm[s * rows + row]);
  float L = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < a.splits; ++s) {
    const float w = fast_exp2(wm[s * rows + row] - M);
    L += w * wl[s * rows + row];
    const float4* x = reinterpret_cast<const float4*>(a.ws + (s * rows + row) * a.D + c);
    const float4 x0 = x[0], x1 = x[1];
    acc[0] += w * x0.x, acc[1] += w * x0.y, acc[2] += w * x0.z, acc[3] += w * x0.w;
    acc[4] += w * x1.x, acc[5] += w * x1.y, acc[6] += w * x1.z, acc[7] += w * x1.w;
  }
  const float inv = 1.f / L;
  Pack8 out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.h[j] = to_bf(acc[j] * inv);
  const long bh = row / a.Sq, q = row - bh * a.Sq, b = bh / a.H, h = bh - b * a.H;
  *reinterpret_cast<uint4*>(a.o + ((b * a.Sq + q) * a.H + h) * a.D + c) = out.u;
  if (c == 0 && a.lse != nullptr) a.lse[row] = M + log2f(L);
}

// Grid: query blocks of BQ_ rows x (batch, head) x the general body's passes.
// The dynamic shared-memory limit of kernel fn raised to what a block may
// use, once per kernel (one card; the call costs host time at every launch
// otherwise).
cudaError_t allow_smem(const void* fn) {
  static const void* done[64];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (done[i] == fn) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && n < 64) done[n++] = fn;
  return err;
}

template <class Fn>
int launch_with(Fn fn, int smem, int threads, const AttnArgs& a, int B, int BQ_, cudaStream_t st) {
  cudaError_t err = allow_smem((const void*)fn);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.Sq + BQ_ - 1) / BQ_), (unsigned)(B * a.H), (unsigned)a.passes);
  fn<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DC>
int launch_general(const AttnArgs& a, int B, cudaStream_t st) {
  return launch_with(attention_kernel<DC>, general_smem(a.DQ), THREADS, a, B, BQ, st);
}

template <int DP, int NK>
int launch_cross(const AttnArgsX& a, int B, cudaStream_t st) {
  const int smem = CrossCfg<DP, NK>::smem(a.tiles);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto fn = attention_kernel_cross<DP, NK>;
  cudaError_t err = allow_smem((const void*)fn);
  if (err != cudaSuccess) return (int)err;
  const int ntile = (a.Sq + CROSS_BQ - 1) / CROSS_BQ;
  dim3 grid((unsigned)((ntile + a.tiles - 1) / a.tiles), (unsigned)(B * a.H));
  fn<<<grid, CROSS_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The 4-D TMA map (D, H, rows, B) of q, k or v, boxes of 64 columns x 1 head
// x 64 rows x 1 batch element in the 128-byte swizzle: columns past D and
// rows past `rows` (Sq, or kv_len for K and V) arrive as zeros.
bool head_map(CUtensorMap* map, const bf16* p, int B, int H, int D, int rows, long ss, long sb) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)ss * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)WIDE_BQ, 1};
  return cached_map_nd(map, p, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DP, int NW, int RT, int CT>
int launch_wide(const AttnArgsX& a, int B, cudaStream_t st) {
  using C = WideCfg<DP, NW, RT, CT>;
  CUtensorMap qm, km, vm;
  if (!head_map(&qm, a.q, B, a.H, a.D, a.Sq, a.q_ss, a.q_sb) ||
      !head_map(&km, a.k, B, a.H, a.D, a.kv_len, a.k_ss, a.k_sb) ||
      !head_map(&vm, a.v, B, a.H, a.D, a.kv_len, a.v_ss, a.v_sb))
    return (int)cudaErrorInvalidValue;
  auto fn = attention_kernel_wide<DP, NW, RT, CT>;
  cudaError_t err = allow_smem((const void*)fn);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.Sq + WIDE_BQ - 1) / WIDE_BQ), (unsigned)(B * a.H), (unsigned)a.splits);
  fn<<<grid, C::THREADS, C::SMEM, st>>>(a, qm, km, vm);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const long rows = (long)B * a.H * a.Sq;
  attention_merge_kernel<<<(unsigned)((rows * (a.D / 8) + 255) / 256), 256, 0, st>>>(a, rows);
  return (int)cudaGetLastError();
}

template <class Fn>
int attrs_of(Fn fn, int smem, int threads, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = allow_smem((const void*)fn);
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

// The compiled ring variants (DP, BQ), cross variants (DP, NK) and wide
// variants (DP, warps, O block rows, O block columns); attention_plan
// (ops/flash_attention.py) chooses among them.
#define SDTK_ATTN_RING_VARIANTS(X) \
  X(48, 128)                       \
  X(64, 64)                        \
  X(64, 192)                       \
  X(64, 256)                       \
  X(80, 128)
#define SDTK_ATTN_CROSS_VARIANTS(X) X(48, 80) X(64, 80) X(80, 80) X(160, 80) X(48, 128) X(64, 128) X(80, 128)
#define SDTK_ATTN_WIDE_VARIANTS(X) X(160, 4, 16, 160) X(512, 8, 64, 64)

enum { SDTK_BODY_GENERAL = 0, SDTK_BODY_RING = 1, SDTK_BODY_CROSS = 2, SDTK_BODY_WIDE = 3 };

// Shape rules (checked by the Python wrapper): D % 8 == 0, D <= 512, every
// stride a multiple of 8, 16-byte aligned pointers, 0 < kv_len <= Sk.  lse
// may be null.  body 0: the general body (bq 64); 1: the ring body, for
// Sq == Sk == kv_len and a compiled (padded D, bq); 2: the cross body (bq
// 64), kv_len <= nk for a compiled (padded D, nk), `tiles` >= 1 query tiles
// a block; 3: the wide body (bq 64) at a compiled
// padded D, 1 <= splits <= the key tiles, ws (splits * B * H * Sq * (D + 2)
// f32) when splits > 1.  An unknown variant returns cudaErrorInvalidValue.
extern "C" int sdtk_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                              long q_sb, long q_ss, long k_sb, long k_ss, long v_sb, long v_ss,
                              int B, int H, int Sq, int Sk, int D, int kv_len, float scale,
                              int body, int bq, int nk, int tiles, int splits, void* ws,
                              void* stream) {
  using namespace sdtk;
  const int DP = (D + 15) / 16 * 16;
  AttnArgsX a;
  static_cast<AttnArgs&>(a) = AttnArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                       static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                       static_cast<float*>(lse), q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                       H, Sq, Sk, D, DP, 1, kv_len, scale * 1.4426950408889634f};
  a.tiles = tiles;
  a.splits = splits;
  a.ws = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == SDTK_BODY_RING) {
    if (Sq != Sk || kv_len != Sk) return (int)cudaErrorInvalidValue;
#define SDTK_RING(dp, bq_)                                                                     \
  if (DP == dp && bq == bq_)                                                                   \
    return launch_with(attention_kernel_ring<dp, bq_>, RingCfg<dp, bq_>::SMEM, 2 * bq_, a, B, bq_, \
                       st);
    SDTK_ATTN_RING_VARIANTS(SDTK_RING)
#undef SDTK_RING
    return (int)cudaErrorInvalidValue;
  }
  if (body == SDTK_BODY_CROSS) {
    if (bq != CROSS_BQ || kv_len > nk || tiles < 1) return (int)cudaErrorInvalidValue;
    a.tiles = min(tiles, (Sq + CROSS_BQ - 1) / CROSS_BQ);  // no more Q buffers than tiles
#define SDTK_CROSS(dp, nk_) \
  if (DP == dp && nk == nk_) return launch_cross<dp, nk_>(a, B, st);
    SDTK_ATTN_CROSS_VARIANTS(SDTK_CROSS)
#undef SDTK_CROSS
    return (int)cudaErrorInvalidValue;
  }
  if (body == SDTK_BODY_WIDE) {
    const int ntiles = (kv_len + WIDE_BK - 1) / WIDE_BK;
    if (bq != WIDE_BQ || splits < 1 || splits > ntiles || (splits > 1 && ws == nullptr))
      return (int)cudaErrorInvalidValue;
#define SDTK_WIDE(dp, nw, rt, ct) \
  if (DP == dp) return launch_wide<dp, nw, rt, ct>(a, B, st);
    SDTK_ATTN_WIDE_VARIANTS(SDTK_WIDE)
#undef SDTK_WIDE
    return (int)cudaErrorInvalidValue;
  }
  if (body != SDTK_BODY_GENERAL || bq != BQ) return (int)cudaErrorInvalidValue;
  switch (DP) {  // one pass with the output tile as wide as the padded head
    case 16: return launch_general<16>(a, B, st);
    case 32: return launch_general<32>(a, B, st);
    case 48: return launch_general<48>(a, B, st);
    case 64: return launch_general<64>(a, B, st);
    case 80: return launch_general<80>(a, B, st);
    case 96: return launch_general<96>(a, B, st);
    case 112: return launch_general<112>(a, B, st);
    case 128: return launch_general<128>(a, B, st);
    case 144: return launch_general<144>(a, B, st);
    case 160: return launch_general<160>(a, B, st);
    default: break;
  }
  if (D > 512) return (int)cudaErrorInvalidValue;
  a.DQ = (DP + 127) / 128 * 128;  // wider heads: 128-column passes across the grid
  a.passes = a.DQ / 128;
  return launch_general<128>(a, B, st);
}

// A compiled variant on the current card, from the runtime: out =
// {registers a thread, local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM}.  body and bq as sdtk_attention's; dp the padded
// head dim (the general body: <= 160, or a multiple of 128 run in
// 128-column passes); nk and tiles the cross body's keys and query tiles a
// block.
extern "C" int sdtk_attention_attrs(int body, int dp, int bq, int nk, int tiles, int* out) {
  using namespace sdtk;
  if (body == SDTK_BODY_RING) {
#define SDTK_RING(dp_, bq_) \
  if (dp == dp_ && bq == bq_)  \
    return attrs_of(attention_kernel_ring<dp_, bq_>, RingCfg<dp_, bq_>::SMEM, 2 * bq_, out);
    SDTK_ATTN_RING_VARIANTS(SDTK_RING)
#undef SDTK_RING
    return (int)cudaErrorInvalidValue;
  }
  if (body == SDTK_BODY_CROSS) {
    if (bq != CROSS_BQ || tiles < 1) return (int)cudaErrorInvalidValue;
#define SDTK_CROSS(dp_, nk_) \
  if (dp == dp_ && nk == nk_)  \
    return attrs_of(attention_kernel_cross<dp_, nk_>, CrossCfg<dp_, nk_>::smem(tiles), CROSS_THREADS, out);
    SDTK_ATTN_CROSS_VARIANTS(SDTK_CROSS)
#undef SDTK_CROSS
    return (int)cudaErrorInvalidValue;
  }
  if (body == SDTK_BODY_WIDE) {
    if (bq != WIDE_BQ) return (int)cudaErrorInvalidValue;
#define SDTK_WIDE(dp_, nw, rt, ct) \
  if (dp == dp_)                   \
    return attrs_of(attention_kernel_wide<dp_, nw, rt, ct>, WideCfg<dp_, nw, rt, ct>::SMEM, 32 * nw, out);
    SDTK_ATTN_WIDE_VARIANTS(SDTK_WIDE)
#undef SDTK_WIDE
    return (int)cudaErrorInvalidValue;
  }
  if (body != SDTK_BODY_GENERAL || bq != BQ) return (int)cudaErrorInvalidValue;
  switch (dp) {
    case 48: return attrs_of(attention_kernel<48>, general_smem(48), THREADS, out);
    case 64: return attrs_of(attention_kernel<64>, general_smem(64), THREADS, out);
    case 80: return attrs_of(attention_kernel<80>, general_smem(80), THREADS, out);
    case 160: return attrs_of(attention_kernel<160>, general_smem(160), THREADS, out);
    default: break;
  }
  if (dp % 128 != 0 || dp > 512) return (int)cudaErrorInvalidValue;
  return attrs_of(attention_kernel<128>, general_smem(dp), THREADS, out);
}
