// K1: GroupNorm statistics folded into a (B, 2, C) f32 scale/shift, and the
// normalize (+SiLU) pass, over NHWC activations viewed as (B, HW, C).
//
// Replaces: stable_diffusion_tpu/ops/groupnorm.py:30 `_stats_kernel` (launched
// by `_stats_call`) and :71 `_norm_kernel` (launched by `_run_kernels`).
//
// What bounds it on Hopper: device-memory bytes (the activation read once
// for the statistics, once more and written once for the normalize; a few
// FLOPs a byte), and at the UNet's 8^2-32^2 stages the launch itself: a
// UNet pass makes 61 statistics calls and a VAE decode ~30, most of them a
// few microseconds of device work.  The first port (Triton) spent two
// launches and a partials allocation on each statistics call; here a call
// is one launch of one kernel, and the wrapper allocates only its output.
//
// Design of the statistics kernel, one launch a call:
// * Grid (row chunk, channel slab, batch), 256 threads a block.  A slab is
//   `gs` whole groups (the most whose channels fit 256 vector lanes, so a
//   row's slab is read contiguously); a tile is tr x r rows, tr rows read
//   at once by tr x lanes threads, each thread holding its r <= 8 rows of
//   one 16-byte vector (8 bf16 or 4 f32 channels; 1 channel where C % that
//   != 0, in the same kernel) in registers; a chunk is `tiles` tiles, taken
//   in order.  gn_plan (ops/groupnorm.py) and sdtk_gn_plan pick gs, r and
//   tiles: one wave of two blocks an SM on the large shapes (the UNet's
//   64^2, the VAE's 256^2-768^2), one chunk a (batch, slab) where a block's
//   registers hold the whole image (the UNet's 8^2 and 16^2).
// * One read from device memory: each tile's per-group (mean, M2) come
//   from two passes over the registers, the sums in a fixed order through
//   shared memory (per channel over the row lanes, then over the group's
//   channels), Chan-merged in order into the chunk's, so the result does
//   not depend on scheduling.
// * Across chunks, a ticket: each block writes its partial (mean, M2) to a
//   workspace, fences, and takes a ticket from a per-(batch, slab) counter
//   with atomicAdd; the last block to arrive merges the partials with
//   Chan's formula (M2 = M2a + M2b + d^2 na nb / n) in chunk order (a
//   group's mlanes lanes each a contiguous run of chunks, 8 loads in
//   flight, then a fixed shuffle tree over those lanes), not in arrival
//   order, folds in gamma and beta and resets the counter to 0.  With one
//   chunk there is no ticket.  The counters live in a per-device
//   workspace zeroed once by the wrapper, so no memset is launched per
//   call.  The one-pass E[x^2] - E[x]^2 is not used: the VAE's activations
//   (means far from 0 at 512^2) lose its digits in f32.
// * The normalize kernel: silu(x * scale + shift) in f32 from the folded
//   scale/shift, 16-byte loads and stores, a grid-stride loop.
//   When asked, the statistics kernel also writes each group's (mean,
//   rstd), which the backward takes: the numbers the forward used.
//
// The backward (no TPU kernel: the JAX package differentiates the plain
// formula, `_gn_bwd` and `_gn_split_bwd`, and XLA fuses it).  With x^ =
// (x - mean) rstd, z = gamma x^ + beta = x scale + shift and dz = dy
// silu'(z) (dy without the SiLU), dx = rstd (gamma dz - mean_g(gamma dz) -
// x^ mean_g(gamma dz x^)), dgamma = sum dz x^ and dbeta = sum dz.  Bound
// by bytes: x and dy read twice and dx written once (10 bytes an element
// in bf16) against the ~200 of the eager f32 VJP.  Two launches a call:
// * The reduction takes the statistics' slabs and splits each (batch,
//   slab) over `nchunks` blocks of `chunk` rows, so that the blocks make one
//   wave of two an SM even at a small batch.  A thread streams its rows
//   (four at a time, 16-byte loads of x and dy) and keeps per-channel sums
//   of dz and dz x^ in registers; they are summed over the row lanes in
//   shared memory, weighted by gamma into the group sums, and the chunks
//   meet through the statistics' workspace and tickets (the last block sums
//   the partials in chunk order, so the result does not depend on
//   scheduling).  It writes (B, 4, C) coefficients: dx = scale dz + m x + n.
// * The apply pass streams x and dy again and writes dx, each thread on
//   fixed channels (the grid's stride a multiple of the row's vectors) with
//   its coefficients in registers; its first row of blocks also sums each
//   image's per-channel dgamma and dbeta over the batch, when asked.
// Not yet: the normalize fused into the statistics launch (a cooperative
// grid whose blocks keep their chunk in registers), a cluster merge over
// distributed shared memory.
#include <string.h>

#include <algorithm>
#include <numeric>
#include <type_traits>

#include "common.cuh"

namespace sdtk {
namespace {

constexpr int GN_THREADS = 256;    // most threads a statistics block (vector lanes x row lanes)
constexpr int GN_RMAX = 8;         // most rows a thread holds
constexpr int GN_MAX_GROUPS = 128; // most groups a slab

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// VEC channels of type T moved as one load: 16 bytes, or one value.
template <typename T, int VEC>
union Vec {
  typename std::conditional<VEC * sizeof(T) == 16, uint4, T>::type u;
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(Vec<T, VEC>& d, const T* p) {
  d.u = *reinterpret_cast<const decltype(d.u)*>(p);
}

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// Chan's merge of (n, mean, m2) with (nb, mean_b, m2_b), the left side first.
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mean_b,
                                     float m2_b) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mean_b - mean;
  mean += d * (nb / nn);
  m2 += m2_b + d * d * (n * (nb / nn));
  n = nn;
}

struct GnArgs {
  const void* x;     // (B, HW, C) bf16 or f32
  const void* w;     // (C) GroupNorm weight, bf16 or f32 (w_f32)
  const void* bias;  // (C), the weight's dtype
  float* ss;         // (B, 2, C): scale, then shift
  float2* part;      // (B, nchunks, G) chunk partials (mean, M2) when nchunks > 1
  int* count;        // (B, slabs) tickets, 0 between launches
  float2* mr;        // (B, G) each group's (mean, rstd), or null
  int HW, C, G, gs, lanes, tr, r, tiles, chunk, nchunks, mlanes, w_f32;
  float eps;
};

__device__ __forceinline__ float load_param(const void* p, int c, int f32) {
  return f32 ? static_cast<const float*>(p)[c] : to_f(static_cast<const bf16*>(p)[c]);
}

// A channel's folded affine from its group's statistics: y = x scale + shift.
__device__ __forceinline__ void gn_fold(float w, float b, float mean, float rstd, float& scale,
                                        float& shift) {
  scale = w * rstd;
  shift = b - mean * scale;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(GN_THREADS) gn_stats_kernel(GnArgs a) {
  __shared__ float red[GN_THREADS * VEC];  // per thread per channel, then per channel of the slab
  __shared__ float gstat[2][GN_MAX_GROUPS];  // a tile's group (mean, M2)
  __shared__ float gacc[3][GN_MAX_GROUPS];   // the block's group (n, mean, M2)
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lv = tid % a.lanes, rl = tid / a.lanes;  // vector lane in the row, row lane
  const int chunk = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int cpg = a.C / a.G, sc = a.gs * cpg, c0 = slab * sc;
  const int trow = a.tr * a.r;  // rows a tile

  // Per-group sums of the slab, in a fixed order: thread t's channels sit
  // at red[t * VEC ..] = red[rl * sc + lv * VEC ..]; each channel's column
  // is summed over the row lanes into red[c], then each group's channels.
  auto group_sums = [&](const float* t, float* out, float n) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[tid * VEC + i] = t[i];
    __syncthreads();
    for (int c = tid; c < sc; c += GN_THREADS) {
      float acc = 0.f;
      for (int i = 0; i < a.tr; ++i) acc += red[i * sc + c];
      red[c] = acc;
    }
    __syncthreads();
    for (int g = tid; g < a.gs; g += GN_THREADS) {
      float acc = 0.f;
      for (int j = 0; j < cpg; ++j) acc += red[g * cpg + j];
      out[g] = acc / n;
    }
    __syncthreads();
  };
  for (int g = tid; g < a.gs; g += GN_THREADS) gacc[0][g] = gacc[1][g] = gacc[2][g] = 0.f;
  // The block's tiles in order: each into registers (row rl + k tr of the
  // tile, k < r), its group (mean, M2) in two passes over the registers,
  // Chan-merged into the block's.
  for (int t = 0; t < a.tiles; ++t) {
    const int row0 = chunk * a.chunk + t * trow;
    const int rows = min(trow, a.HW - row0);
    if (rows <= 0) break;
    const T* xb = static_cast<const T*>(a.x) + ((long)b * a.HW + row0) * a.C + c0 + lv * VEC;
    Vec<T, VEC> v[GN_RMAX];
    float s[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < GN_RMAX; ++k) {
      const int rr = rl + k * a.tr;
      if (rl < a.tr && k < a.r && rr < rows) {
        load_vec(v[k], xb + (long)rr * a.C);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] += to_float(v[k].v[i]);
      }
    }
    group_sums(s, gstat[0], (float)rows * cpg);  // the tile's group means
    float mu[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = gstat[0][(lv * VEC + i) / cpg];
      s[i] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < GN_RMAX; ++k) {
      const int rr = rl + k * a.tr;
      if (rl < a.tr && k < a.r && rr < rows) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = to_float(v[k].v[i]) - mu[i];
          s[i] += d * d;
        }
      }
    }
    group_sums(s, gstat[1], 1.f);  // the tile's group M2
    for (int g = tid; g < a.gs; g += GN_THREADS)
      chan(gacc[0][g], gacc[1][g], gacc[2][g], (float)rows * cpg, gstat[0][g], gstat[1][g]);
  }
  __syncthreads();

  const int slabs = a.G / a.gs;
  if (a.nchunks > 1) {
    for (int g = tid; g < a.gs; g += GN_THREADS)
      a.part[((long)b * a.nchunks + chunk) * a.G + slab * a.gs + g] =
          make_float2(gacc[1][g], gacc[2][g]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.count + b * slabs + slab, 1) == a.nchunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // The last block: mlanes lanes a group, lane l of a group a contiguous
    // run of chunks in order (loads batched 8 at a time), then a fixed
    // shuffle tree over the group's lanes.
    const int warp = tid >> 5, lane = tid & 31, L = a.mlanes;
    const int gpw = 32 / L, sub = lane & (L - 1);
    const int per = (a.nchunks + L - 1) / L;
    for (int base = warp * gpw; base < a.gs; base += (GN_THREADS / 32) * gpw) {
      const int g = base + lane / L;
      float cn = 0.f, cmean = 0.f, cm2 = 0.f;
      if (g < a.gs) {
        const float2* pp = a.part + (long)b * a.nchunks * a.G + slab * a.gs + g;
        const int i1 = min((sub + 1) * per, a.nchunks);
        for (int i = sub * per; i < i1; i += 8) {
          float2 p[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (i + k < i1) p[k] = __ldcg(pp + (long)(i + k) * a.G);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (i + k < i1)
              chan(cn, cmean, cm2, (float)min(a.chunk, a.HW - (i + k) * a.chunk) * cpg, p[k].x, p[k].y);
        }
      }
      for (int off = 1; off < L; off <<= 1) {
        const float n2 = __shfl_down_sync(0xffffffffu, cn, off);
        const float mean2 = __shfl_down_sync(0xffffffffu, cmean, off);
        const float m22 = __shfl_down_sync(0xffffffffu, cm2, off);
        if ((sub & (2 * off - 1)) == 0) chan(cn, cmean, cm2, n2, mean2, m22);
      }
      if (sub == 0 && g < a.gs) {
        gacc[1][g] = cmean;
        gacc[2][g] = cm2;
      }
    }
    __syncthreads();
    if (tid == 0) a.count[b * slabs + slab] = 0;
  }
  // Fold: scale = gamma rstd, shift = beta - mean scale, per channel.
  const float total = (float)a.HW * cpg;
  float* ssb = a.ss + (long)b * 2 * a.C + c0;
  for (int c = tid; c < sc; c += GN_THREADS) {
    const int g = c / cpg;
    const float rstd = 1.f / sqrtf(gacc[2][g] / total + a.eps);
    float scale, shift;
    gn_fold(load_param(a.w, c0 + c, a.w_f32), load_param(a.bias, c0 + c, a.w_f32), gacc[1][g],
            rstd, scale, shift);
    ssb[c] = scale;
    ssb[a.C + c] = shift;
  }
  if (a.mr != nullptr)
    for (int g = tid; g < a.gs; g += GN_THREADS)
      a.mr[b * a.G + slab * a.gs + g] =
          make_float2(gacc[1][g], 1.f / sqrtf(gacc[2][g] / total + a.eps));
}

// y = x * scale + shift (+ SiLU) in f32, cast back; VEC channels a load.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) gn_apply_kernel(const T* x, const float* ss, T* y, long HW,
                                                       int C, int silu_on) {
  const int b = blockIdx.y, cv = C / VEC;
  const long nvec = HW * cv;
  const T* xb = x + (long)b * HW * C;
  T* yb = y + (long)b * HW * C;
  const float* sc = ss + (long)b * 2 * C;
  const float* sh = sc + C;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += (long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * VEC;
    Vec<T, VEC> u;
    load_vec(u, xb + i * VEC);
    float s[VEC], h[VEC];
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(sc + c + k);
        const float4 h4 = *reinterpret_cast<const float4*>(sh + c + k);
        s[k] = s4.x, s[k + 1] = s4.y, s[k + 2] = s4.z, s[k + 3] = s4.w;
        h[k] = h4.x, h[k + 1] = h4.y, h[k + 2] = h4.z, h[k + 3] = h4.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[k] = sc[c + k], h[k] = sh[c + k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float f = to_float(u.v[k]) * s[k] + h[k];
      if (silu_on) f = silu(f);
      u.v[k] = from_float<T>(f);
    }
    *reinterpret_cast<decltype(u.u)*>(yb + i * VEC) = u.u;
  }
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

constexpr int GN_BWD_ROWS = 4;  // rows a thread loads at once in the reduction
constexpr int GN_BWD_PER = 4;   // vectors a thread of the apply pass

struct GnBwdArgs {
  const void* x;      // (B, HW, C) bf16 or f32
  const void* dy;     // (B, HW, C), x's type: the gradient of GroupNorm(+SiLU)'s output
  const void* w;      // (C) gamma, bf16 or f32 (w_f32)
  const void* bias;   // (C) beta, gamma's type
  const float2* mr;   // (B, G) the forward's (mean, rstd)
  float2* part;       // (B, nchunks, G) chunk partials (sum gamma dz, sum gamma dz x^), nchunks > 1
  float2* cpart;      // (B, nchunks, C) chunk partials (sum dz, sum dz x^), affine and nchunks > 1
  int* count;         // (B, slabs) tickets, 0 between launches
  float* coef;        // (B, 4, C): scale, shift, m, n (dx = scale dz + m x + n)
  float* dwb;         // (B, 2, C): each image's dgamma, dbeta (affine)
  int HW, C, G, gs, lanes, tr, chunk, nchunks, mlanes, w_f32, silu, affine;
};

// dz = dy silu'(z), z = x scale + shift (the forward's pre-activation); dy
// where the SiLU is off.
__device__ __forceinline__ float gn_dz(float x, float dy, float scale, float shift, int silu_on) {
  if (!silu_on) return dy;
  const float z = fmaf(x, scale, shift);
  const float s = 1.f / (1.f + __expf(-z));
  return dy * s * fmaf(z, 1.f - s, 1.f);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(GN_THREADS, 2) gn_bwd_reduce_kernel(GnBwdArgs a) {
  __shared__ float red[2][GN_THREADS * VEC];  // per thread per channel, then per slab channel
  __shared__ float gsum[2][GN_MAX_GROUPS];    // the slab's group sums of gamma dz, gamma dz x^
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lv = tid % a.lanes, rl = tid / a.lanes;  // vector lane in the row, row lane
  const int chunk = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int cpg = a.C / a.G, sc = a.gs * cpg, c0 = slab * sc, slabs = a.G / a.gs;
  float scale[VEC], shift[VEC], mu[VEC], rs[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = c0 + lv * VEC + i;
    const float2 m = a.mr[b * a.G + c / cpg];
    mu[i] = m.x, rs[i] = m.y;
    gn_fold(load_param(a.w, c, a.w_f32), load_param(a.bias, c, a.w_f32), m.x, m.y, scale[i],
            shift[i]);
    s1[i] = s2[i] = 0.f;
  }
  auto take = [&](const Vec<T, VEC>& xv, const Vec<T, VEC>& dv) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xf = to_float(xv.v[i]);
      const float dz = gn_dz(xf, to_float(dv.v[i]), scale[i], shift[i], a.silu);
      s1[i] += dz;
      s2[i] += dz * ((xf - mu[i]) * rs[i]);
    }
  };
  if (rl < a.tr) {
    const long base = (long)b * a.HW * a.C + c0 + lv * VEC;
    const T* xb = static_cast<const T*>(a.x) + base;
    const T* dyb = static_cast<const T*>(a.dy) + base;
    const int r1 = min((chunk + 1) * a.chunk, a.HW);
    int row = chunk * a.chunk + rl;
    for (; row + (GN_BWD_ROWS - 1) * a.tr < r1; row += GN_BWD_ROWS * a.tr) {
      Vec<T, VEC> xv[GN_BWD_ROWS], dv[GN_BWD_ROWS];
#pragma unroll
      for (int k = 0; k < GN_BWD_ROWS; ++k) {
        load_vec(xv[k], xb + (long)(row + k * a.tr) * a.C);
        load_vec(dv[k], dyb + (long)(row + k * a.tr) * a.C);
      }
#pragma unroll
      for (int k = 0; k < GN_BWD_ROWS; ++k) take(xv[k], dv[k]);
    }
    for (; row < r1; row += a.tr) {
      Vec<T, VEC> xv, dv;
      load_vec(xv, xb + (long)row * a.C);
      load_vec(dv, dyb + (long)row * a.C);
      take(xv, dv);
    }
  }
  // Per channel over the row lanes (thread t's channels at red[.][t * VEC
  // ..] = red[.][rl * sc + lv * VEC ..]), in a fixed order.
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[0][tid * VEC + i] = s1[i], red[1][tid * VEC + i] = s2[i];
  __syncthreads();
  // Each channel's sums go to the chunk's partials (affine; with one chunk
  // straight to the image's dgamma, dbeta) and, gamma-weighted, to red.
  float* dwb = a.affine ? a.dwb + (long)b * 2 * a.C + c0 : nullptr;
  for (int c = tid; c < sc; c += GN_THREADS) {
    float p = 0.f, q = 0.f;
    for (int i = 0; i < a.tr; ++i) p += red[0][i * sc + c], q += red[1][i * sc + c];
    if (a.affine && a.nchunks > 1)
      a.cpart[((long)b * a.nchunks + chunk) * a.C + c0 + c] = make_float2(p, q);
    else if (a.affine)
      dwb[c] = q, dwb[a.C + c] = p;
    const float w = load_param(a.w, c0 + c, a.w_f32);
    red[0][c] = w * p, red[1][c] = w * q;
  }
  __syncthreads();
  for (int g = tid; g < a.gs; g += GN_THREADS) {
    float p = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) p += red[0][g * cpg + j], q += red[1][g * cpg + j];
    gsum[0][g] = p, gsum[1][g] = q;
  }
  __syncthreads();

  if (a.nchunks > 1) {
    for (int g = tid; g < a.gs; g += GN_THREADS)
      a.part[((long)b * a.nchunks + chunk) * a.G + slab * a.gs + g] =
          make_float2(gsum[0][g], gsum[1][g]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.count + b * slabs + slab, 1) == a.nchunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // The last block: the group sums as the statistics' merge (mlanes
    // lanes a group, each a contiguous run of chunks, then a fixed shuffle
    // tree), then each channel's (affine) over the chunks in order.
    const int warp = tid >> 5, lane = tid & 31, L = a.mlanes;
    const int gpw = 32 / L, sub = lane & (L - 1);
    const int per = (a.nchunks + L - 1) / L;
    for (int base = warp * gpw; base < a.gs; base += (GN_THREADS / 32) * gpw) {
      const int g = base + lane / L;
      float p = 0.f, q = 0.f;
      if (g < a.gs) {
        const float2* pp = a.part + (long)b * a.nchunks * a.G + slab * a.gs + g;
        const int i1 = min((sub + 1) * per, a.nchunks);
#pragma unroll 4
        for (int i = sub * per; i < i1; ++i) {
          const float2 v = __ldcg(pp + (long)i * a.G);
          p += v.x, q += v.y;
        }
      }
      for (int off = 1; off < L; off <<= 1) {
        const float p2 = __shfl_down_sync(0xffffffffu, p, off);
        const float q2 = __shfl_down_sync(0xffffffffu, q, off);
        if ((sub & (2 * off - 1)) == 0) p += p2, q += q2;
      }
      if (sub == 0 && g < a.gs) gsum[0][g] = p, gsum[1][g] = q;
    }
    if (a.affine)
      for (int c = tid; c < sc; c += GN_THREADS) {
        const float2* pp = a.cpart + (long)b * a.nchunks * a.C + c0 + c;
        float p = 0.f, q = 0.f;
#pragma unroll 4
        for (int i = 0; i < a.nchunks; ++i) {
          const float2 v = __ldcg(pp + (long)i * a.C);
          p += v.x, q += v.y;
        }
        dwb[c] = q, dwb[a.C + c] = p;
      }
    __syncthreads();
    if (tid == 0) a.count[b * slabs + slab] = 0;
  }
  // The apply pass's coefficients: dx = rstd (gamma dz - S1 / N - x^ S2 /
  // N) = scale dz + m x + n, m = -rstd^2 S2 / N, n = rstd (mean rstd S2 -
  // S1) / N.
  const float inv_n = 1.f / ((float)a.HW * cpg);
  float* cb = a.coef + (long)b * 4 * a.C + c0;
  for (int c = tid; c < sc; c += GN_THREADS) {
    const int g = c / cpg;
    const float2 m = a.mr[b * a.G + slab * a.gs + g];
    float scale, shift;
    gn_fold(load_param(a.w, c0 + c, a.w_f32), load_param(a.bias, c0 + c, a.w_f32), m.x, m.y,
            scale, shift);
    const float t1 = gsum[0][g] * inv_n, t2 = gsum[1][g] * inv_n;
    cb[c] = scale;
    cb[a.C + c] = shift;
    cb[2 * a.C + c] = -m.y * m.y * t2;
    cb[3 * a.C + c] = m.y * (m.x * m.y * t2 - t1);
  }
}

// dx = scale dz + m x + n, VEC channels a load; a thread's channels are
// fixed (gridDim.x * blockDim.x is a multiple of C / VEC), so it loads its
// coefficients once.  With dwb, the blocks of image 0 also write dgamma and
// dbeta (gamma's type): each image's sums added in image order.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) gn_bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ coef,
    T* __restrict__ dx, int HW, int C, int silu_on, const float* __restrict__ dwb, void* dw,
    void* db, int w_f32, int B) {
  const int b = blockIdx.y, cv = C / VEC;
  const long nvec = (long)HW * cv;
  const long start = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  const int c = (int)(start % cv) * VEC;
  float k[4][VEC];  // scale, shift, m, n
  const float* cb = coef + (long)b * 4 * C + c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cb + j * C + i);
        k[j][i] = v.x, k[j][i + 1] = v.y, k[j][i + 2] = v.z, k[j][i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) k[j][i] = cb[j * C + i];
    }
  }
  const T* xb = x + (long)b * HW * C;
  const T* dyb = dy + (long)b * HW * C;
  T* ob = dx + (long)b * HW * C;
  auto out = [&](const Vec<T, VEC>& xv, const Vec<T, VEC>& dv, long i) {
    Vec<T, VEC> o;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const float xf = to_float(xv.v[q]);
      const float dz = gn_dz(xf, to_float(dv.v[q]), k[0][q], k[1][q], silu_on);
      o.v[q] = from_float<T>(fmaf(k[0][q], dz, fmaf(k[2][q], xf, k[3][q])));
    }
    *reinterpret_cast<decltype(o.u)*>(ob + i * VEC) = o.u;
  };
  long i = start;
  for (; i + stride < nvec; i += 2 * stride) {
    Vec<T, VEC> x0, d0, x1, d1;
    load_vec(x0, xb + i * VEC);
    load_vec(d0, dyb + i * VEC);
    load_vec(x1, xb + (i + stride) * VEC);
    load_vec(d1, dyb + (i + stride) * VEC);
    out(x0, d0, i);
    out(x1, d1, i + stride);
  }
  if (i < nvec) {
    Vec<T, VEC> x0, d0;
    load_vec(x0, xb + i * VEC);
    load_vec(d0, dyb + i * VEC);
    out(x0, d0, i);
  }
  if (dwb != nullptr && b == 0)
    for (long ch = start; ch < C; ch += stride) {
      float p = 0.f, q = 0.f;
      for (int bb = 0; bb < B; ++bb)
        p += dwb[(long)bb * 2 * C + ch], q += dwb[(long)bb * 2 * C + C + ch];
      if (w_f32) {
        static_cast<float*>(dw)[ch] = p;
        static_cast<float*>(db)[ch] = q;
      } else {
        static_cast<bf16*>(dw)[ch] = to_bf(p);
        static_cast<bf16*>(db)[ch] = to_bf(q);
      }
    }
}

// The plan's derived sizes; false when (vec, gs, r, tiles) is not a plan.
struct GnShape {
  int cpg, lanes, tr, chunk, nchunks, slabs, mlanes;
};

__host__ inline bool gn_shape(int HW, int C, int G, int vec, int gs, int r, int tiles, GnShape& s) {
  if (HW < 1 || G < 1 || C % G != 0 || gs < 1 || gs > GN_MAX_GROUPS || G % gs != 0 || r < 1 ||
      r > GN_RMAX || tiles < 1 || C % vec != 0)
    return false;
  s.cpg = C / G;
  if ((gs * s.cpg) % vec != 0) return false;
  s.lanes = gs * s.cpg / vec;
  if (s.lanes > GN_THREADS) return false;
  s.tr = GN_THREADS / s.lanes;
  s.chunk = s.tr * r * tiles;
  s.nchunks = (HW + s.chunk - 1) / s.chunk;
  s.slabs = G / gs;
  s.mlanes = 32;  // merge lanes a group: the most (a power of two) that 8 warps hold
  while (s.mlanes * gs > GN_THREADS) s.mlanes /= 2;
  return true;
}

__host__ inline bool gn_slab_ok(int G, int cpg, int vec, int d) {
  return G % d == 0 && d <= GN_MAX_GROUPS && (d * cpg) % vec == 0 && d * cpg / vec <= GN_THREADS;
}

__host__ inline bool gn_bwd_shape(int HW, int C, int G, int vec, int gs, int chunk, GnShape& s) {
  if (chunk < 1 || !gn_shape(HW, C, G, vec, gs, 1, 1, s)) return false;
  s.chunk = chunk;
  s.nchunks = (HW + chunk - 1) / chunk;
  return true;
}

template <typename Fn>
int kernel_attrs(Fn fn, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, GN_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

}  // namespace
}  // namespace sdtk

// The plan of a statistics call (ops/groupnorm.gn_plan mirrors it), out =
// {vec, gs, r, tiles}: vec channels a load (16 bytes: 8 bf16 or 4 f32; 1
// where C % that != 0 or no slab fits it); where some slab of gs groups
// lets one block hold a whole image's rows (HW <= 8 tr), the largest such
// gs and r = ceil(HW / tr), one chunk and no ticket; else the largest gs,
// the largest r in 8, 4, 2, 1 whose tiles (tr r rows) give two blocks an
// SM (r = 1 where none does), and, where there are more tiles than that,
// as many a block as make one wave of two blocks an SM, and at least
// enough that no (batch, slab) has more than 512 chunks.  Returns cudaErrorInvalidValue when no slab fits.
extern "C" int sdtk_gn_plan(int B, int HW, int C, int G, int elem_bytes, int sms, int* out) {
  using namespace sdtk;
  if (G < 1 || C % G != 0 || HW < 1) return (int)cudaErrorInvalidValue;
  const int cpg = C / G;
  int vec = 16 / elem_bytes;
  if (C % vec != 0) vec = 1;
  int best = 0;
  for (int d = G; d >= 1 && best == 0; --d)
    if (gn_slab_ok(G, cpg, vec, d)) best = d;
  if (best == 0) {
    vec = 1;
    for (int d = G; d >= 1 && best == 0; --d)
      if (gn_slab_ok(G, cpg, vec, d)) best = d;
  }
  if (best == 0) return (int)cudaErrorInvalidValue;
  for (int d = G; d >= 1; --d) {  // one chunk a (batch, slab)
    if (!gn_slab_ok(G, cpg, vec, d)) continue;
    const int tr = GN_THREADS / (d * cpg / vec);
    if (HW <= GN_RMAX * tr) {
      out[0] = vec, out[1] = d, out[2] = (HW + tr - 1) / tr, out[3] = 1;
      return 0;
    }
  }
  const int tr = GN_THREADS / (best * cpg / vec), slabs = G / best;
  int r = GN_RMAX;
  for (; r > 1; r /= 2)
    if ((long)B * slabs * ((HW + tr * r - 1) / (tr * r)) >= 2L * sms) break;
  const long ntiles = (HW + tr * r - 1) / (tr * r);  // tiles a (batch, slab)
  const long all = (long)B * slabs * ntiles;
  long tiles = all > 2L * sms ? (all + 2L * sms - 1) / (2L * sms) : 1;  // one wave, two an SM
  tiles = std::max(tiles, (ntiles + 511) / 512);
  out[0] = vec, out[1] = best, out[2] = r, out[3] = (int)tiles;
  return 0;
}

// Statistics, one launch, the arguments packed as int64 (a[i]): x, w, bias,
// ss, part, count (pointers), x_f32, w_f32, B, HW, C, G, vec, gs, r, tiles,
// eps (its f32 bits), stream, mr (a pointer, may be null: else each group's
// (mean, rstd), (B, G) float2).  ss (B, 2, C) f32 from x (B, HW, C) (f32
// when x_f32, else bf16) and the GroupNorm affine (f32 when w_f32, else
// bf16), with the plan (vec, gs, r, tiles) from sdtk_gn_plan.  part holds
// B * nchunks * G float2 (may be null with one chunk); count B * G / gs
// ints, all 0, left 0.  Shape rules (checked by the Python wrapper):
// contiguous tensors, x 16-byte aligned.
extern "C" int sdtk_gn_stats(const long long* a) {
  using namespace sdtk;
  const void *x = (const void*)a[0], *w = (const void*)a[1], *bias = (const void*)a[2];
  void *ss = (void*)a[3], *part = (void*)a[4], *count = (void*)a[5];
  const int x_f32 = (int)a[6], w_f32 = (int)a[7], B = (int)a[8], HW = (int)a[9], C = (int)a[10],
            G = (int)a[11], vec = (int)a[12], gs = (int)a[13], r = (int)a[14], tiles = (int)a[15];
  const int eps_bits = (int)a[16];
  float eps;
  memcpy(&eps, &eps_bits, sizeof eps);
  cudaStream_t st = (cudaStream_t)a[17];
  float2* mr = (float2*)a[18];
  GnShape s;
  if (!gn_shape(HW, C, G, vec, gs, r, tiles, s) ||
      (s.nchunks > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  GnArgs ga{x, w, bias, static_cast<float*>(ss), static_cast<float2*>(part), static_cast<int*>(count),
            mr, HW, C, G, gs, s.lanes, s.tr, r, tiles, s.chunk, s.nchunks, s.mlanes, w_f32, eps};
  const dim3 grid((unsigned)s.nchunks, (unsigned)s.slabs, (unsigned)B);
  if (x_f32 && vec == 4)
    gn_stats_kernel<float, 4><<<grid, GN_THREADS, 0, st>>>(ga);
  else if (x_f32 && vec == 1)
    gn_stats_kernel<float, 1><<<grid, GN_THREADS, 0, st>>>(ga);
  else if (!x_f32 && vec == 8)
    gn_stats_kernel<bf16, 8><<<grid, GN_THREADS, 0, st>>>(ga);
  else if (!x_f32 && vec == 1)
    gn_stats_kernel<bf16, 1><<<grid, GN_THREADS, 0, st>>>(ga);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Normalize (+SiLU), the arguments packed as int64: x, ss, y (pointers),
// x_f32, B, HW, C, vec, silu, stream.  y = silu?(x * ss[b, 0] + ss[b, 1]),
// x and y (B, HW, C) of x's type, vec as the plan's.
extern "C" int sdtk_gn_apply(const long long* a) {
  using namespace sdtk;
  const void* x = (const void*)a[0];
  const float* sf = (const float*)a[1];
  void* y = (void*)a[2];
  const int x_f32 = (int)a[3], B = (int)a[4], HW = (int)a[5], C = (int)a[6], vec = (int)a[7],
            silu = (int)a[8];
  cudaStream_t st = (cudaStream_t)a[9];
  if (vec < 1 || C % vec != 0) return (int)cudaErrorInvalidValue;
  const long nvec = (long)HW * (C / vec);
  const dim3 grid((unsigned)std::min<long>((nvec + 255) / 256, 2048), (unsigned)B);
  if (x_f32 && vec == 4)
    gn_apply_kernel<float, 4><<<grid, 256, 0, st>>>(static_cast<const float*>(x), sf,
                                                     static_cast<float*>(y), HW, C, silu);
  else if (x_f32 && vec == 1)
    gn_apply_kernel<float, 1><<<grid, 256, 0, st>>>(static_cast<const float*>(x), sf,
                                                     static_cast<float*>(y), HW, C, silu);
  else if (!x_f32 && vec == 8)
    gn_apply_kernel<bf16, 8><<<grid, 256, 0, st>>>(static_cast<const bf16*>(x), sf,
                                                    static_cast<bf16*>(y), HW, C, silu);
  else if (!x_f32 && vec == 1)
    gn_apply_kernel<bf16, 1><<<grid, 256, 0, st>>>(static_cast<const bf16*>(x), sf,
                                                    static_cast<bf16*>(y), HW, C, silu);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The compiled statistics kernel for (x_f32, vec), from the runtime: out =
// {registers a thread, local (spill) bytes a thread, static shared bytes,
// resident blocks an SM at 256 threads}.
extern "C" int sdtk_gn_attrs(int x_f32, int vec, int* out) {
  using namespace sdtk;
  if (x_f32 && vec == 4) return kernel_attrs(gn_stats_kernel<float, 4>, out);
  if (x_f32 && vec == 1) return kernel_attrs(gn_stats_kernel<float, 1>, out);
  if (!x_f32 && vec == 8) return kernel_attrs(gn_stats_kernel<bf16, 8>, out);
  if (!x_f32 && vec == 1) return kernel_attrs(gn_stats_kernel<bf16, 1>, out);
  return (int)cudaErrorInvalidValue;
}

// The backward, two launches, the arguments packed as int64 (a[i]): x, dy,
// w, bias, mr, dx, part, cpart, count, coef, dwb, dw, db (pointers), x_f32,
// w_f32, B, HW, C, G, vec, gs, chunk, silu, affine, stream.  x, dy and dx
// (B, HW, C) of x's type (f32 when x_f32, else bf16), w and bias (C) (f32
// when w_f32, else bf16), mr (B, G) float2 the forward's (mean, rstd); the
// plan (vec, gs, chunk) from ops/groupnorm.gn_bwd_plan.  part holds B *
// nchunks * G float2 and, when affine, cpart B * nchunks * C (both may be
// null with one chunk); count B * G / gs ints, all 0, left 0; coef B * 4 *
// C floats and, when affine, dwb B * 2 * C; dw and db (C) of w's type are
// written when affine (else may be null).  Shape rules (checked by the
// Python wrapper): contiguous tensors, x, dy and dx 16-byte aligned.
extern "C" int sdtk_gn_bwd(const long long* a) {
  using namespace sdtk;
  const void *x = (const void*)a[0], *dy = (const void*)a[1], *w = (const void*)a[2],
             *bias = (const void*)a[3];
  const float2* mr = (const float2*)a[4];
  void* dx = (void*)a[5];
  float2 *part = (float2*)a[6], *cpart = (float2*)a[7];
  int* count = (int*)a[8];
  float *coef = (float*)a[9], *dwb = (float*)a[10];
  void *dw = (void*)a[11], *db = (void*)a[12];
  const int x_f32 = (int)a[13], w_f32 = (int)a[14], B = (int)a[15], HW = (int)a[16],
            C = (int)a[17], G = (int)a[18], vec = (int)a[19], gs = (int)a[20], chunk = (int)a[21],
            silu = (int)a[22], affine = (int)a[23];
  cudaStream_t st = (cudaStream_t)a[24];
  GnShape s;
  if (B < 1 || !gn_bwd_shape(HW, C, G, vec, gs, chunk, s) || mr == nullptr || coef == nullptr ||
      (s.nchunks > 1 && (part == nullptr || count == nullptr || (affine && cpart == nullptr))) ||
      (affine && (dwb == nullptr || dw == nullptr || db == nullptr)))
    return (int)cudaErrorInvalidValue;
  GnBwdArgs ga{x, dy, w, bias, mr, part, cpart, count, coef, dwb, HW, C, G, gs, s.lanes, s.tr,
               chunk, s.nchunks, s.mlanes, w_f32, silu, affine};
  const dim3 grid1((unsigned)s.nchunks, (unsigned)s.slabs, (unsigned)B);
  // The apply pass: enough blocks for GN_BWD_PER vectors a thread, their
  // count a multiple of cv / gcd(cv, 256) so that the stride is a multiple of cv.
  const int cv = C / vec;
  const long nvec = (long)HW * cv, unit = cv / std::gcd(cv, 256);
  long gx = (nvec + 256L * GN_BWD_PER - 1) / (256L * GN_BWD_PER);
  gx = (gx + unit - 1) / unit * unit;
  const dim3 grid2((unsigned)gx, (unsigned)B);
  const float* fdwb = affine ? dwb : nullptr;
#define SDTK_GN_BWD(T, V)                                                                        \
  do {                                                                                           \
    gn_bwd_reduce_kernel<T, V><<<grid1, GN_THREADS, 0, st>>>(ga);                                \
    const cudaError_t e = cudaGetLastError();                                                    \
    if (e != cudaSuccess) return (int)e;                                                         \
    gn_bwd_apply_kernel<T, V><<<grid2, 256, 0, st>>>(static_cast<const T*>(x),                   \
                                                     static_cast<const T*>(dy), coef,            \
                                                     static_cast<T*>(dx), HW, C, silu, fdwb, dw, \
                                                     db, w_f32, B);                              \
  } while (0)
  if (x_f32 && vec == 4)
    SDTK_GN_BWD(float, 4);
  else if (x_f32 && vec == 1)
    SDTK_GN_BWD(float, 1);
  else if (!x_f32 && vec == 8)
    SDTK_GN_BWD(bf16, 8);
  else if (!x_f32 && vec == 1)
    SDTK_GN_BWD(bf16, 1);
  else
    return (int)cudaErrorInvalidValue;
#undef SDTK_GN_BWD
  return (int)cudaGetLastError();
}

// The compiled backward kernels for (x_f32, vec), as sdtk_gn_attrs: the
// reduction (apply 0) or the apply pass (apply 1).
extern "C" int sdtk_gn_bwd_attrs(int x_f32, int vec, int apply, int* out) {
  using namespace sdtk;
  if (x_f32 && vec == 4)
    return apply ? kernel_attrs(gn_bwd_apply_kernel<float, 4>, out)
                 : kernel_attrs(gn_bwd_reduce_kernel<float, 4>, out);
  if (x_f32 && vec == 1)
    return apply ? kernel_attrs(gn_bwd_apply_kernel<float, 1>, out)
                 : kernel_attrs(gn_bwd_reduce_kernel<float, 1>, out);
  if (!x_f32 && vec == 8)
    return apply ? kernel_attrs(gn_bwd_apply_kernel<bf16, 8>, out)
                 : kernel_attrs(gn_bwd_reduce_kernel<bf16, 8>, out);
  if (!x_f32 && vec == 1)
    return apply ? kernel_attrs(gn_bwd_apply_kernel<bf16, 1>, out)
                 : kernel_attrs(gn_bwd_reduce_kernel<bf16, 1>, out);
  return (int)cudaErrorInvalidValue;
}
