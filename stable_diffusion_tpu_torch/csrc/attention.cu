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
// Two bodies; `attention_plan` (ops/flash_attention.py) picks one and its
// tile, and passes them in:
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
// * The general body (the first design: cross-attention masked by kv_len,
//   other head dims, the VAE's d = 512): 64 query rows a block, 64-key
//   tiles loaded synchronously into one buffer, Q's fragments read from
//   shared memory at every tile.  The output accumulator holds at most 160
//   columns; wider heads (d = 512) run as 128-column passes, one pass per
//   blockIdx.z, each recomputing the logits.  The row log-sum-exp is
//   written by pass 0.
//
// Softmax statistics stay in f32; P is rounded to bf16 before P V.  For a
// training step the kernel also writes each row's log-sum-exp in the log2
// domain (f32 (B, H, Sq)), so that the backward (K5/K6, attention_bwd.cu)
// need not recompute the row statistics.
#include <math.h>

#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// The general body
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block (4 warps x 16)
constexpr int BKV = 64; // keys per tile
constexpr int THREADS = 128;

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

// Grid: query blocks of BQ_ rows x (batch, head) x the general body's passes.
template <class Fn>
int launch_with(Fn fn, int smem, int threads, const AttnArgs& a, int B, int BQ_, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.Sq + BQ_ - 1) / BQ_), (unsigned)(B * a.H), (unsigned)a.passes);
  fn<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DC>
int launch_general(const AttnArgs& a, int B, cudaStream_t st) {
  return launch_with(attention_kernel<DC>, general_smem(a.DQ), THREADS, a, B, BQ, st);
}

template <class Fn>
int attrs_of(Fn fn, int smem, int threads, int* out) {
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

// The compiled ring variants (DP, BQ); attention_plan (ops/flash_attention.py)
// chooses among them.
#define SDTK_ATTN_RING_VARIANTS(X) \
  X(48, 128)                       \
  X(64, 64)                        \
  X(64, 192)                       \
  X(64, 256)                       \
  X(80, 128)

enum { SDTK_BODY_GENERAL = 0, SDTK_BODY_RING = 1 };

// Shape rules (checked by the Python wrapper): D % 8 == 0, D <= 512, every
// stride a multiple of 8, 16-byte aligned pointers, 0 < kv_len <= Sk.  lse
// may be null.  body 0: the general body (bq 64); body 1: the ring body, for
// Sq == Sk == kv_len and a compiled (padded D, bq).  An unknown variant
// returns cudaErrorInvalidValue.
extern "C" int sdtk_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                              long q_sb, long q_ss, long k_sb, long k_ss, long v_sb, long v_ss,
                              int B, int H, int Sq, int Sk, int D, int kv_len, float scale,
                              int body, int bq, void* stream) {
  using namespace sdtk;
  const int DP = (D + 15) / 16 * 16;
  AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
             static_cast<bf16*>(o),       static_cast<float*>(lse),
             q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
             H, Sq, Sk, D, DP, 1, kv_len, scale * 1.4426950408889634f};
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
// 128-column passes).
extern "C" int sdtk_attention_attrs(int body, int dp, int bq, int* out) {
  using namespace sdtk;
  if (body == SDTK_BODY_RING) {
#define SDTK_RING(dp_, bq_) \
  if (dp == dp_ && bq == bq_)  \
    return attrs_of(attention_kernel_ring<dp_, bq_>, RingCfg<dp_, bq_>::SMEM, 2 * bq_, out);
    SDTK_ATTN_RING_VARIANTS(SDTK_RING)
#undef SDTK_RING
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
