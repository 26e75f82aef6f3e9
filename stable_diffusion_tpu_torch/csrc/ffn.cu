// K4: fused LayerNorm -> GeGLU up-projection -> down-projection -> +b2
// -> +residual, for the spatial transformer's feed-forward block.
//
// Replaces: stable_diffusion_tpu/ops/ffn.py bf16 `_make_kernel` (launched by
// `_ffn_call`, reached through `geglu_ffn` -> `_ln_ffn_res`).
//
// What bounds it on Hopper: the three products (x W1 is 2*M*C*8C FLOPs,
// h W2 is 2*M*4C*C) on the tensor cores, and the weights: W1 and W2 are
// 3*C*4C bf16 values (39 MB at C = 1280), re-read from L2 by every block of
// rows.  The point of fusing is that the (M, 8C) GeGLU intermediate never
// reaches device memory.
//
// Design: a block owns BM rows (64, or 32 where 64 LN'd rows of width C
// would not leave room in shared memory) and a contiguous range of the
// hidden units (at most 512).
// It LayerNorms its rows once (f32 statistics, two passes over the row) into
// shared memory as bf16.  Phase A walks its hidden range 64 units at a
// time: the value and gate halves (value rows first, gate rows second, as
// the reference splits W1) come from WMMA products whose W1 tiles are
// staged through a two-stage shared-memory ring, 64 input channels per
// step, the next tile fetched into registers while the current one is
// multiplied; (hv + bv) * gelu_erf(hg + bg) is taken in
// f32 with the exact erff and kept as bf16 in shared memory, so the block's
// whole (BM x range) slab of h stays on chip.  Phase B multiplies that slab
// by the matching columns of W2 (staged the same way), 64 output columns at
// a time with the accumulators in registers, and writes each f32 tile once
// to a workspace slice (nsplit, M, C).  The hidden range is split over
// `nsplit` blocks per row block so the grid fills the card; a second kernel
// sums the slices in a fixed order and adds b2 and the residual in f32
// before the cast, so the result is deterministic.  Simple first: WMMA, no
// TMA/wgmma pipeline yet.
#include <math.h>

#include "common.cuh"

using namespace nvcuda;

namespace sdtk {
namespace {

constexpr int FTHREADS = 256;
constexpr int HB = 64;   // hidden units per phase-A step
constexpr int OC = 64;   // output columns per phase-B pass (W2 rows per tile)
constexpr int KS = 64;   // K per staged weight tile
constexpr int LDW = KS + 8;
constexpr int W1_VECS = 2 * HB * KS / 8 / FTHREADS;  // 16-byte vectors per thread
constexpr int W2_VECS = OC * KS / 8 / FTHREADS;
constexpr int LDS = HB + 4;  // f32 staging of hv / hg

struct FfnArgs {
  const bf16* x;     // (M, C)
  const bf16* ln_w;  // (C)
  const bf16* ln_b;  // (C)
  const bf16* w1;    // (8C, C): value rows [0, 4C), gate rows [4C, 8C)
  const bf16* b1;    // (8C)
  const bf16* w2;    // (C, 4C)
  float* ws;         // (nsplit, Mpad, C)
  int M, Mpad, C, nsplit, rb;  // rb: most 64-unit hidden blocks per block
  float eps;
};

struct FfnLayout {
  int ldx, ldh, off_w1, off_hvg, off_w2, off_h, total;
};

// W1 and W2 tiles are double-buffered: the tile of step k goes to stage k & 1.
__host__ __device__ inline FfnLayout ffn_layout(int BM, int C, int rb) {
  FfnLayout L;
  L.ldx = (C + KS - 1) / KS * KS + 8;  // LN'd rows, zero past C to a whole K step
  L.ldh = rb * HB + 8;
  int off = align128(BM * L.ldx * 2);
  L.off_w1 = off;
  off += 2 * align128(2 * HB * LDW * 2);
  L.off_hvg = off;
  off += align128(2 * BM * LDS * 4);
  L.off_w2 = off;
  off += 2 * align128(OC * LDW * 2);
  L.off_h = off;
  off += align128(BM * L.ldh * 2);
  L.total = off;
  return L;
}

template <int BM>
__global__ void __launch_bounds__(FTHREADS) ffn_main_kernel(FfnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RT = BM / 16;               // row tiles
  constexpr int UP_T = RT * 4 * 2 / 8;      // phase-A tiles per warp (value and gate)
  constexpr int DN_T = RT * (OC / 16) / 8;  // phase-B tiles per warp
  constexpr int W1_STAGE = align128(2 * HB * LDW * 2) / 2;  // elements per ring stage
  constexpr int W2_STAGE = align128(OC * LDW * 2) / 2;
  const int C = a.C;
  const FfnLayout L = ffn_layout(BM, C, a.rb);
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L.off_w1);
  float* Hvg = reinterpret_cast<float*>(smem + L.off_hvg);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L.off_w2);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.off_h);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int H4 = 4 * C;
  const int nh = H4 / HB;
  const int hb_begin = (int)((long)split * nh / a.nsplit);
  const int nhb = (int)((long)(split + 1) * nh / a.nsplit) - hb_begin;

  // LayerNorm, f32 statistics, two passes; each warp takes BM/8 rows.
  // Columns from C up to a whole K step stay 0.
  const int cpad = L.ldx - 8;
  for (int r = warp; r < BM; r += FTHREADS / 32) {
    const int row = m0 + r;
    bf16* dst = Xs + r * L.ldx;
    if (row < a.M) {
      const bf16* src = a.x + (long)row * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f(src[c]);
      const float mean = warp_sum(s) / C;
      float q = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(src[c]) - mean;
        q += d * d;
      }
      const float rstd = rsqrtf(warp_sum(q) / C + a.eps);
      for (int c = lane; c < cpad; c += 32)
        dst[c] = c < C ? to_bf((to_f(src[c]) - mean) * rstd * to_f(a.ln_w[c]) + to_f(a.ln_b[c]))
                       : to_bf(0.f);
    } else {
      for (int c = lane; c < cpad; c += 32) dst[c] = to_bf(0.f);
    }
  }
  __syncthreads();

  // Phase A: h = (x W1v + bv) * gelu(x W1g + bg) for the block's hidden range.
  // W1 tiles go through a two-stage ring: one barrier per K step.
  const int kchunks = cpad / KS;
  const int t0 = warp * UP_T;  // tiles t: gate = t & 1, column tile (t >> 1) & 3, row tile t >> 3
  const int up_rt = t0 >> 3;
  for (int hb = 0; hb < nhb; ++hb) {
    const int j0 = (hb_begin + hb) * HB;
    Pack8 rw[W1_VECS];
    auto fetch_w1 = [&](int kc) {
#pragma unroll
      for (int i = 0; i < W1_VECS; ++i) {
        const int q = tid + FTHREADS * i;  // (gate, unit, 8-wide k) over 2 x 64 x 64
        const int g = q >> 9, n = (q >> 3) & 63, c = kc * KS + (q & 7) * 8;
        rw[i].u = make_uint4(0, 0, 0, 0);
        if (c < C)
          rw[i].u = *reinterpret_cast<const uint4*>(a.w1 + (long)(g * H4 + j0 + n) * C + c);
      }
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[UP_T];
#pragma unroll
    for (int i = 0; i < UP_T; ++i) wmma::fill_fragment(acc[i], 0.f);
    fetch_w1(0);
    for (int kc = 0; kc < kchunks; ++kc) {
      bf16* w1s = W1s + (kc & 1) * W1_STAGE;
#pragma unroll
      for (int i = 0; i < W1_VECS; ++i) {
        const int q = tid + FTHREADS * i;
        const int g = q >> 9, n = (q >> 3) & 63, kv = q & 7;
        *reinterpret_cast<uint4*>(w1s + (g * HB + n) * LDW + kv * 8) = rw[i].u;
      }
      __syncthreads();
      if (kc + 1 < kchunks) fetch_w1(kc + 1);
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Xs + up_rt * 16 * L.ldx + kc * KS + kk * 16, L.ldx);
#pragma unroll
        for (int i = 0; i < UP_T; ++i) {
          const int t = t0 + i, g = t & 1, ct = (t >> 1) & 3;
          // B(k, n) = W1[n][k]: column-major in the staged tile.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, w1s + (g * HB + ct * 16) * LDW + kk * 16, LDW);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < UP_T; ++i) {
      const int t = t0 + i, g = t & 1, ct = (t >> 1) & 3;
      wmma::store_matrix_sync(Hvg + g * BM * LDS + up_rt * 16 * LDS + ct * 16, acc[i], LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < BM * HB; idx += FTHREADS) {
      const int r = idx / HB, j = idx - r * HB;
      const float hv = Hvg[r * LDS + j] + to_f(a.b1[j0 + j]);
      const float hg = Hvg[BM * LDS + r * LDS + j] + to_f(a.b1[H4 + j0 + j]);
      const float gelu = 0.5f * hg * (1.f + erff(hg * 0.70710678118654752f));
      Hs[r * L.ldh + hb * HB + j] = to_bf(hv * gelu);
    }
    __syncthreads();
  }

  // Phase B: partial out = h W2[:, range]^T, 64 output columns at a time,
  // W2 tiles through the same kind of ring.
  const int ksteps = nhb * HB / KS;
  const int jb = hb_begin * HB;
  float* wsb = a.ws + ((long)split * a.Mpad + m0) * C;
  for (int oc = 0; oc < C; oc += OC) {
    Pack8 r2[W2_VECS];
    auto fetch_w2 = [&](int ks) {
#pragma unroll
      for (int i = 0; i < W2_VECS; ++i) {
        const int q = tid + FTHREADS * i;  // (output column, 8-wide k) over 64 x 64
        const int n = q >> 3, kv = q & 7;
        r2[i].u = make_uint4(0, 0, 0, 0);
        if (oc + n < C)
          r2[i].u = *reinterpret_cast<const uint4*>(a.w2 + (long)(oc + n) * H4 + jb + ks * KS +
                                                    kv * 8);
      }
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DN_T];
#pragma unroll
    for (int i = 0; i < DN_T; ++i) wmma::fill_fragment(acc[i], 0.f);
    fetch_w2(0);
    for (int ks = 0; ks < ksteps; ++ks) {
      bf16* w2s = W2s + (ks & 1) * W2_STAGE;
#pragma unroll
      for (int i = 0; i < W2_VECS; ++i) {
        const int q = tid + FTHREADS * i;
        *reinterpret_cast<uint4*>(w2s + (q >> 3) * LDW + (q & 7) * 8) = r2[i].u;
      }
      __syncthreads();
      if (ks + 1 < ksteps) fetch_w2(ks + 1);
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < DN_T; ++i) {
          const int t = warp * DN_T + i, ct = t / RT, rt = t - ct * RT;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          // B(k=j, n=o) = W2[o][j]: column-major in the staged tile.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Hs + rt * 16 * L.ldh + ks * KS + kk * 16, L.ldh);
          wmma::load_matrix_sync(fb, w2s + ct * 16 * LDW + kk * 16, LDW);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < DN_T; ++i) {
      const int t = warp * DN_T + i, ct = t / RT, rt = t - ct * RT;
      if (oc + ct * 16 < C)
        wmma::store_matrix_sync(wsb + (long)rt * 16 * C + oc + ct * 16, acc[i], C,
                                wmma::mem_row_major);
    }
    __syncthreads();  // the next pass refills the ring
  }
}

// out = sum over splits of ws + b2 + residual, in f32, then cast.
__global__ void ffn_finalize_kernel(const float* ws, const bf16* b2, const bf16* res, bf16* out,
                                    int M, int Mpad, int C, int nsplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * C) return;
  const long m = i / C;
  const int c = (int)(i - m * C);
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += ws[((long)sp * Mpad + m) * C + c];
  s += to_f(b2[c]);
  if (res != nullptr) s += to_f(res[i]);
  out[i] = to_bf(s);
}

constexpr int kMaxSmem = 232448;  // 227 KB a block may use on Hopper

}  // namespace
}  // namespace sdtk

// The launch plan for M rows of width C: rows per block (bm), most 64-unit
// hidden blocks per block (rb) and the number of hidden splits (nsplit).
// The wrapper sizes the workspace (nsplit, ceil(M/bm)*bm, C) f32 from it.
// Returns 0, or cudaErrorInvalidValue when no plan fits shared memory.
extern "C" int sdtk_ffn_plan(int M, int C, int* bm, int* rb, int* nsplit) {
  using namespace sdtk;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *bm = ffn_layout(64, C, 4).total <= kMaxSmem ? 64 : 32;
  const int mblocks = (M + *bm - 1) / *bm;
  const int nh = 4 * C / HB;
  int r = 8;
  while (r > 1 && (long)mblocks * ((nh + r - 1) / r) < sms) r /= 2;
  while (r > 1 && ffn_layout(*bm, C, r).total > kMaxSmem) r /= 2;
  if (ffn_layout(*bm, C, r).total > kMaxSmem) return (int)cudaErrorInvalidValue;
  *rb = r;
  *nsplit = (nh + r - 1) / r;
  return 0;
}

// Shape rules (checked by the Python wrapper): C % 16 == 0, every tensor
// contiguous and 32-byte aligned, (bm, rb, nsplit) from sdtk_ffn_plan and ws
// sized from them.
extern "C" int sdtk_ffn(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                        const void* b1, const void* w2, const void* b2, const void* res,
                        void* ws, void* out, int M, int C, int bm, int rb, int nsplit, float eps,
                        void* stream) {
  using namespace sdtk;
  const int Mpad = (M + bm - 1) / bm * bm;
  const int smem = ffn_layout(bm, C, rb).total;
  auto kernel = bm == 64 ? ffn_main_kernel<64> : ffn_main_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FfnArgs a{static_cast<const bf16*>(x),  static_cast<const bf16*>(ln_w),
            static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w1),
            static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
            static_cast<float*>(ws),      M, Mpad, C, nsplit, rb, eps};
  kernel<<<dim3(Mpad / bm, nsplit), FTHREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)M * C;
  ffn_finalize_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(b2), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), M, Mpad, C, nsplit);
  return (int)cudaGetLastError();
}
