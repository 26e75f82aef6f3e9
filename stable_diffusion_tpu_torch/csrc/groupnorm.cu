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
// Not yet: the normalize fused into the statistics launch (a cooperative
// grid whose blocks keep their chunk in registers), a cluster merge over
// distributed shared memory.
#include <string.h>

#include <algorithm>
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
  int HW, C, G, gs, lanes, tr, r, tiles, chunk, nchunks, mlanes, w_f32;
  float eps;
};

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
    const float w = a.w_f32 ? static_cast<const float*>(a.w)[c0 + c]
                            : to_f(static_cast<const bf16*>(a.w)[c0 + c]);
    const float bb = a.w_f32 ? static_cast<const float*>(a.bias)[c0 + c]
                             : to_f(static_cast<const bf16*>(a.bias)[c0 + c]);
    const float scale = w * rstd;
    ssb[c] = scale;
    ssb[a.C + c] = bb - gacc[1][g] * scale;
  }
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

template <typename T, int VEC>
int gn_attrs(int* out) {
  auto fn = gn_stats_kernel<T, VEC>;
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
// eps (its f32 bits), stream.  ss (B, 2, C) f32 from x (B, HW, C) (f32
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
  GnShape s;
  if (!gn_shape(HW, C, G, vec, gs, r, tiles, s) ||
      (s.nchunks > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  GnArgs ga{x, w, bias, static_cast<float*>(ss), static_cast<float2*>(part), static_cast<int*>(count),
            HW, C, G, gs, s.lanes, s.tr, r, tiles, s.chunk, s.nchunks, s.mlanes, w_f32, eps};
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
  if (x_f32 && vec == 4) return gn_attrs<float, 4>(out);
  if (x_f32 && vec == 1) return gn_attrs<float, 1>(out);
  if (!x_f32 && vec == 8) return gn_attrs<bf16, 8>(out);
  if (!x_f32 && vec == 1) return gn_attrs<bf16, 1>(out);
  return (int)cudaErrorInvalidValue;
}
