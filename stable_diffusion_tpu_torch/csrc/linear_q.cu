// K8: static-W8A8 matmul: (LayerNorm ->) quantize the activation to int8
// with the layer's calibrated step -> int8 x int8 -> int32 product ->
// dequantize, +bias (+residual), bf16 out.
//
// Replaces: stable_diffusion_tpu/ops/linear.py `_make_q_kernel` (launched by
// `_q_mm_call`, reached through `ln_matmul_w8a8` and `matmul_w8a8`).
//
// What bounds it on Hopper: at the UNet's shapes (M = 8 x 4096 rows down
// to 1, K and N 320-3840) the int8 tensor-core work is 2*M*K*N operations
// against M*K*2 + K*N + M*N*2(*2) bytes; the large-M projections are above
// the ridge (1979 TOPS / 3.35 TB/s ~ 590 ops/byte), the M = 1 time
// embeddings and the 616-row cross k/v far below it (weight bytes).
//
// Design: one block computes 64 rows x 128 output columns; 8 warps, each a
// 32 x 32 tile of m16n8k32 s8 `mma.sync` products with s32 accumulators.
// K is walked 64 at a time through a two-stage shared-memory ring: each
// thread fetches its share of the next x tile (bf16) and weight tile (int8,
// PyTorch's (N, K) layout, already K-contiguous for the B operand) into
// registers while the current tile is multiplied, then quantizes the x
// values as it stages them.  So the int8 activation exists only in shared
// memory (the TPU kernel's point too; XLA wrote it to HBM).  With a
// LayerNorm, the block first takes each of its rows' f32 mean and rstd
// (two passes, one warp a row), and the prologue normalizes in f32 and
// divides by s_x: the LN output goes to the quantizer unrounded, as in the
// TPU kernel (the plain version, JAX's XLA form, casts it to the input
// dtype first; in f32 the two are one function).  Any M: rows past M and
// columns past N are masked, so the M = 1 time embedding and the 616-row
// context projections need no padding (the TPU kernel took M % 128 only).  The epilogue multiplies the int32 sum by
// s_x * weight_scale[n], adds the bias (and residual) in f32 and stores
// bf16 pairs.  Simple first: no TMA, no wgmma.
#include "mma.cuh"

namespace sdtk {
namespace {

constexpr int LBM = 64;      // rows per block
constexpr int LBN = 128;     // output columns per block
constexpr int LKT = 64;      // K per staged tile
constexpr int LTHREADS = 256;
constexpr int LLD = LKT + 16;  // bytes a staged row: 16 mod 32, conflict-free fragments

struct LinArgs {
  const bf16* x;         // (M, K)
  const bf16* ln_w;      // (K) or null
  const bf16* ln_b;      // (K) or null
  const int8_t* w;       // (N, K)
  const float* sx;       // (1) the activation step
  const float* oscale;   // (N) sx * weight_scale
  const bf16* bias;      // (N) or null
  const bf16* res;       // (M, N) or null
  bf16* y;               // (M, N)
  int M, N, K;
  float eps;
};

__global__ void __launch_bounds__(LTHREADS) linear_q_kernel(LinArgs a) {
  __shared__ __align__(16) int8_t As[2][LBM * LLD];
  __shared__ __align__(16) int8_t Bs[2][LBN * LLD];
  __shared__ float mean_s[LBM], rstd_s[LBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 32 x 32
  const int m0 = blockIdx.x * LBM, n0 = blockIdx.y * LBN;
  const bool ln = a.ln_w != nullptr;

  if (ln) {  // f32 row statistics, two passes, one warp a row
    for (int r = warp; r < LBM; r += LTHREADS / 32) {
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
  const float sx = *a.sx;

  // Per K tile each thread fetches two 8-value x vectors (row q >> 3, k
  // vector q & 7) and two 16-byte weight vectors (row q >> 2, k vector q & 3).
  Pack8 ra[2];
  uint4 rb[2];
  bool va[2];
  auto fetch = [&](int kt) {
    const int k0 = kt * LKT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + LTHREADS * i;
      const int r = q >> 3, c = k0 + (q & 7) * 8;
      va[i] = m0 + r < a.M && c < a.K;
      ra[i].u = va[i] ? *reinterpret_cast<const uint4*>(a.x + (long)(m0 + r) * a.K + c)
                      : make_uint4(0, 0, 0, 0);
      const int n = q >> 2, cb = k0 + (q & 3) * 16;
      rb[i] = n0 + n < a.N && cb < a.K
                  ? *reinterpret_cast<const uint4*>(a.w + (long)(n0 + n) * a.K + cb)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&](int kt, int s) {
    const int k0 = kt * LKT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + LTHREADS * i;
      const int r = q >> 3, c = k0 + (q & 7) * 8;
      int code[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = to_f(ra[i].h[j]);
        if (ln && va[i])
          v = (v - mean_s[r]) * rstd_s[r] * to_f(a.ln_w[c + j]) + to_f(a.ln_b[c + j]);
        code[j] = va[i] ? quantize_s8(v, sx) : 0;
      }
      *reinterpret_cast<uint2*>(&As[s][r * LLD + (q & 7) * 8]) =
          make_uint2(pack_s8(code[0], code[1], code[2], code[3]),
                     pack_s8(code[4], code[5], code[6], code[7]));
      *reinterpret_cast<uint4*>(&Bs[s][(q >> 2) * LLD + (q & 3) * 16]) = rb[i];
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // Two-stage ring, one barrier a step: stage s is rewritten two steps after
  // its last read, and every warp has passed the barrier between.
  const int nk = (a.K + LKT - 1) / LKT;
  fetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    stage(kt, s);
    __syncthreads();
    if (kt + 1 < nk) fetch(kt + 1);
#pragma unroll
    for (int ks = 0; ks < LKT; ks += 32) {
      uint32_t fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a_s8(fa[i], &As[s][(wm * 32 + i * 16) * LLD + ks], LLD, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        load_b_s8(b0, b1, &Bs[s][(wn * 32 + j * 8) * LLD + ks], LLD, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16832_s8(acc[i][j], fa[i], b0, b1);
      }
    }
  }

  // Epilogue: y = acc * oscale[n] + bias[n] (+ res), f32, one rounding.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * t;
    if (col >= a.N) continue;  // N % 8 == 0: col and col + 1 together
    const float s0 = a.oscale[col], s1 = a.oscale[col + 1];
    const float b0 = a.bias != nullptr ? to_f(a.bias[col]) : 0.f;
    const float b1 = a.bias != nullptr ? to_f(a.bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (row >= a.M) continue;
        float v0 = (float)acc[i][j][2 * h] * s0 + b0;
        float v1 = (float)acc[i][j][2 * h + 1] * s1 + b1;
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

// Shape rules (checked by the Python wrapper): K % 32 == 0, N % 8 == 0, x
// and w 16-byte aligned, every tensor contiguous; ln_w and ln_b both given
// or both null; bias and res may be null.
extern "C" int sdtk_linear_q(const void* x, const void* ln_w, const void* ln_b, const void* w,
                             const void* sx, const void* oscale, const void* bias, const void* res,
                             void* y, int M, int N, int K, float eps, void* stream) {
  using namespace sdtk;
  LinArgs a{static_cast<const bf16*>(x),     static_cast<const bf16*>(ln_w),
            static_cast<const bf16*>(ln_b),  static_cast<const int8_t*>(w),
            static_cast<const float*>(sx),   static_cast<const float*>(oscale),
            static_cast<const bf16*>(bias),  static_cast<const bf16*>(res),
            static_cast<bf16*>(y),           M, N, K, eps};
  dim3 grid((unsigned)((M + LBM - 1) / LBM), (unsigned)((N + LBN - 1) / LBN));
  linear_q_kernel<<<grid, LTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
