// K10: bf16 (LayerNorm ->) matmul -> +bias (-> +residual), and
// K11: bf16 GroupNorm-normalize -> matmul -> +bias, one source.
//
// Replaces: stable_diffusion_tpu/ops/linear.py `_make_kernel` (K10; launched
// by `_mm_call`, entries `ln_matmul` and `matmul_residual`) and
// `_gn_mm_kernel` (K11; `_gn_mm_call`, entry `gn_matmul`).  Both sit
// behind SD_TPU_FUSED_MM in the JAX package and here.
//
// What bounds them on Hopper: 2*M*K*N bf16 tensor-core operations against
// (M*K + K*N + M*N (+ M*N residual)) * 2 bytes.  At the UNet's shapes (M =
// 2 x 9216 rows at SD2.1's 768^2 down to 2 x 144, K and N 320-1280, N 3840
// for the fused QKV) the products are above the ridge (989 TFLOP/s / 3.35
// TB/s ~ 295 flop/byte) once M is in the thousands and K, N >= 320; the
// 144-row deep stage and the 77-token sites are bytes-bound.
//
// Design (K8's skeleton with bf16 operands): one block computes 64 rows x
// 128 output columns; 8 warps, each a 32 x 32 tile of m16n8k16 bf16
// `mma.sync` products with f32 accumulators.  K is walked 32 at a time
// through a two-stage shared-memory ring; each thread fetches its share of
// the next x tile and weight tile (PyTorch's (N, K) layout, K-contiguous as
// the B operand wants) into registers while the current tile is multiplied.
// The prologue runs as the x tile is staged, in f32, rounded once to bf16
// (the TPU kernels' `.astype(x.dtype)` before the dot):
//   K10 LN: each row's f32 mean and rstd first (two passes, one warp a row;
//           recomputed by every column block), then (x - mean) rstd g + b;
//   K11 GN: x * scale[img, k] + shift[img, k] from K1's folded (B, 2, K)
//           f32 scale/shift, img = row / rows_per_img, so a row block may
//           straddle two images (the TPU kernel needed blocks inside one).
// The normalized activation exists only in shared memory.  Epilogue: acc +
// bias (+ residual) in f32, one rounding to bf16, bf16 pairs stored.  Any M
// (rows past M masked), K % 8 == 0, N % 8 == 0: the TPU geometry gates
// (M % 128, the VMEM plan) do not apply.  Simple first: no TMA, no wgmma.
#include "mma.cuh"

namespace sdtk {
namespace {

constexpr int MBM = 64;       // rows per block
constexpr int MBN = 128;      // output columns per block
constexpr int MKT = 32;       // K per staged tile
constexpr int MTHREADS = 256;
constexpr int MLD = MKT + 8;  // bf16 a staged row: 80 bytes, conflict-free fragments

enum Prologue { kNone = 0, kLN = 1, kGN = 2 };

struct MmArgs {
  const bf16* x;        // (M, K)
  const bf16* ln_w;     // (K) or null
  const bf16* ln_b;     // (K) or null
  const float* ss;      // (B, 2, K) GroupNorm scale/shift, or null
  int rows_per_img;     // rows of one image (K11)
  const bf16* w;        // (N, K)
  const bf16* bias;     // (N) or null
  const bf16* res;      // (M, N) or null
  bf16* y;              // (M, N)
  int M, N, K;
  float eps;
};

template <int PRO>
__global__ void __launch_bounds__(MTHREADS) linear_kernel(MmArgs a) {
  __shared__ __align__(16) bf16 As[2][MBM * MLD];
  __shared__ __align__(16) bf16 Bs[2][MBN * MLD];
  __shared__ float mean_s[MBM], rstd_s[MBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 32 x 32
  const int m0 = blockIdx.x * MBM, n0 = blockIdx.y * MBN;

  if (PRO == kLN) {  // f32 row statistics, two passes, one warp a row
    for (int r = warp; r < MBM; r += MTHREADS / 32) {
      const int row = m0 + r;
      float mean = 0.f, rstd = 1.f;
      if (row < a.M) {
        const bf16* src = a.x + (long)row * a.K;
        float s = 0.f;
        for (int c = lane; c < a.K; c += 32) s += to_f(src[c]);
        mean = warp_sum(s) / a.K;
        float q = 0.f;
        for (int c = lane; c < a.K; c += 32) {
          const float d = to_f(src[c]) - mean;
          q += d * d;
        }
        rstd = rsqrtf(warp_sum(q) / a.K + a.eps);
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
  }

  // Per K tile each thread fetches one 8-value x vector (row tid >> 2, k
  // vector tid & 3) and two 8-value weight vectors (row q >> 2, q = tid,
  // tid + 256).
  Pack8 ra, rb[2];
  bool va;
  auto fetch = [&](int kt) {
    const int k0 = kt * MKT;
    const int r = tid >> 2, c = k0 + (tid & 3) * 8;
    va = m0 + r < a.M && c < a.K;
    ra.u = va ? *reinterpret_cast<const uint4*>(a.x + (long)(m0 + r) * a.K + c)
              : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + MTHREADS * i;
      const int n = q >> 2, cb = k0 + (q & 3) * 8;
      rb[i].u = n0 + n < a.N && cb < a.K
                    ? *reinterpret_cast<const uint4*>(a.w + (long)(n0 + n) * a.K + cb)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&](int kt, int s) {
    const int k0 = kt * MKT;
    const int r = tid >> 2, cv = (tid & 3) * 8, c = k0 + cv;
    Pack8 o = ra;
    if (PRO != kNone && va) {
      Pack8 g, b;
      const float* sc = nullptr;
      float mean = 0.f, rstd = 0.f;
      if (PRO == kLN) {
        g.u = *reinterpret_cast<const uint4*>(a.ln_w + c);
        b.u = *reinterpret_cast<const uint4*>(a.ln_b + c);
        mean = mean_s[r];
        rstd = rstd_s[r];
      } else {
        sc = a.ss + (long)((m0 + r) / a.rows_per_img) * 2 * a.K;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = to_f(ra.h[j]);
        o.h[j] = PRO == kLN ? to_bf((v - mean) * rstd * to_f(g.h[j]) + to_f(b.h[j]))
                            : to_bf(v * sc[c + j] + sc[a.K + c + j]);
      }
    }
    *reinterpret_cast<uint4*>(&As[s][r * MLD + cv]) = o.u;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + MTHREADS * i;
      *reinterpret_cast<uint4*>(&Bs[s][(q >> 2) * MLD + (q & 3) * 8]) = rb[i].u;
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Two-stage ring, one barrier a step: stage s is rewritten two steps after
  // its last read, and every warp has passed the barrier between.
  const int g = lane >> 2, t = lane & 3;
  const int nk = (a.K + MKT - 1) / MKT;
  fetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    stage(kt, s);
    __syncthreads();
    if (kt + 1 < nk) fetch(kt + 1);
#pragma unroll
    for (int ks = 0; ks < MKT; ks += 16) {
      uint32_t fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* ap = &As[s][(wm * 32 + i * 16) * MLD + ks];
        fa[i][0] = lds32(ap + g * MLD + 2 * t);
        fa[i][1] = lds32(ap + (g + 8) * MLD + 2 * t);
        fa[i][2] = lds32(ap + g * MLD + 2 * t + 8);
        fa[i][3] = lds32(ap + (g + 8) * MLD + 2 * t + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* bp = &Bs[s][(wn * 32 + j * 8 + g) * MLD + ks];
        const uint32_t b0 = lds32(bp + 2 * t), b1 = lds32(bp + 2 * t + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16816(acc[i][j], fa[i], b0, b1);
      }
    }
  }

  // Epilogue: y = acc + bias[n] (+ res), f32, one rounding.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * t;
    if (col >= a.N) continue;  // N % 8 == 0: col and col + 1 together
    const float b0 = a.bias != nullptr ? to_f(a.bias[col]) : 0.f;
    const float b1 = a.bias != nullptr ? to_f(a.bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (row >= a.M) continue;
        float v0 = acc[i][j][2 * h] + b0;
        float v1 = acc[i][j][2 * h + 1] + b1;
        const long o = (long)row * a.N + col;
        if (a.res != nullptr) {
          v0 += to_f(a.res[o]);
          v1 += to_f(a.res[o + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(a.y + o) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

}  // namespace
}  // namespace sdtk

// Shape rules (checked by the Python wrapper): K % 8 == 0, N % 8 == 0, x,
// w, ln_w and ln_b 16-byte aligned, every tensor contiguous; at most one of
// (ln_w, ln_b) and ss given; bias and res may be null.  ss given: K11;
// otherwise K10, with the LayerNorm when ln_w is given.
extern "C" int sdtk_linear(const void* x, const void* ln_w, const void* ln_b, const void* ss,
                           int rows_per_img, const void* w, const void* bias, const void* res,
                           void* y, int M, int N, int K, float eps, void* stream) {
  using namespace sdtk;
  MmArgs a{static_cast<const bf16*>(x),    static_cast<const bf16*>(ln_w),
           static_cast<const bf16*>(ln_b), static_cast<const float*>(ss),
           rows_per_img,                   static_cast<const bf16*>(w),
           static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
           static_cast<bf16*>(y),          M, N, K, eps};
  dim3 grid((unsigned)((M + MBM - 1) / MBM), (unsigned)((N + MBN - 1) / MBN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ss != nullptr)
    linear_kernel<kGN><<<grid, MTHREADS, 0, st>>>(a);
  else if (ln_w != nullptr)
    linear_kernel<kLN><<<grid, MTHREADS, 0, st>>>(a);
  else
    linear_kernel<kNone><<<grid, MTHREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
