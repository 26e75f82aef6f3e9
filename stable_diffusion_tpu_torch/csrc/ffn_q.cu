// K9: static-W8A8 LayerNorm -> GeGLU FFN -> +residual: LN -> quantize with
// the first linear's step -> int8 value and gate products -> dequantize ->
// GeGLU in f32 -> requantize with the second linear's step -> int8 W2
// product -> dequantize, +b2, +residual.
//
// Replaces: stable_diffusion_tpu/ops/ffn.py int8 `_make_q_kernel` (launched
// by `_ffn_q`, reached through `geglu_ffn` with W8A8 parameters).
//
// What bounds it on Hopper: the three int8 products (2*M*C*2H + 2*M*H*C
// operations) on the tensor cores, and the int8 weights (3*C*H bytes, 19.7
// MB at C = 1280), re-read from L2 by every block of rows.  As in K4, the
// point of fusing is that the (M, 2H) value/gate intermediate and the int8
// activations never reach device memory.
//
// Design: K4's.  A block owns 64 rows and a contiguous range of the hidden
// units (at most 512).  It LayerNorms its rows (f32 statistics, two
// passes) and quantizes the f32 result once into shared memory as int8, as
// the TPU kernel does (the plain version, JAX's XLA form, casts the LN
// output and each linear's output to the input dtype; in f32 they agree).
// Phase A walks its hidden range 64 units at a time: each warp takes 32
// rows x 16 units of both the value and the gate half, so the two products
// of one (row, unit) land in the same thread's registers (m16n8k32 s8
// `mma.sync`, W1 tiles staged through a two-stage ring, the next fetched
// while the current one is multiplied); the thread dequantizes both, takes
// (hv + bv) * gelu_erf(hg + bg) in f32 and requantizes it with the second
// linear's step into the block's int8 (64 x range) slab in shared memory.
// Phase B multiplies that slab by the matching columns of W2, 128 output
// columns a pass, and writes each int32 tile once to a workspace slice
// (nsplit, M, C).
// The hidden range is split over `nsplit` blocks per row block so the grid
// fills the card; a second kernel adds the int32 slices (exact in any
// order), dequantizes, and adds b2 and the residual in f32 before the cast.
// Simple first: no TMA, no wgmma.
#include <math.h>

#include "mma.cuh"

namespace sdtk {
namespace {

constexpr int QTHREADS = 256;
constexpr int QBM = 64;   // rows per block
constexpr int QHB = 64;   // hidden units per phase-A step
constexpr int QOC = 128;  // output columns per phase-B pass
constexpr int QKT = 64;   // K bytes per staged weight tile
constexpr int QLD = QKT + 16;  // bytes a staged row: 16 mod 32, conflict-free fragments

struct FfnQArgs {
  const bf16* x;        // (M, C)
  const bf16* ln_w;     // (C) or null
  const bf16* ln_b;     // (C) or null
  const int8_t* w1;     // (2H, C): value rows [0, H), gate rows [H, 2H)
  const float* s1;      // (1) the first linear's activation step
  const float* os1;     // (2H) s1 * w1 scale
  const bf16* b1;       // (2H)
  const int8_t* w2;     // (C, H)
  const float* s2;      // (1) the second linear's activation step
  int* ws;              // (nsplit, Mpad, C) int32 partial sums
  int M, Mpad, C, H, nsplit, rb;
  float eps;
};

struct FfnQLayout {
  int ldx, ldh, off_w1, off_h, off_w2, off_stats, total;
};

__host__ __device__ inline FfnQLayout ffn_q_layout(int C, int rb) {
  FfnQLayout L;
  L.ldx = (C + QKT - 1) / QKT * QKT + 16;  // int8 rows, zero past C to a whole K tile
  L.ldh = rb * QHB + 16;
  int off = align128(QBM * L.ldx);
  L.off_w1 = off;
  off += 2 * align128(2 * QHB * QLD);
  L.off_h = off;
  off += align128(QBM * L.ldh);
  L.off_w2 = off;
  off += 2 * align128(QOC * QLD);
  L.off_stats = off;
  off += align128(2 * QBM * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__global__ void __launch_bounds__(QTHREADS) ffn_q_kernel(FfnQArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int W1_STAGE = align128(2 * QHB * QLD);
  constexpr int W2_STAGE = align128(QOC * QLD);
  const int C = a.C, H = a.H;
  const FfnQLayout L = ffn_q_layout(C, a.rb);
  int8_t* Xq = reinterpret_cast<int8_t*>(smem);
  int8_t* W1s = reinterpret_cast<int8_t*>(smem + L.off_w1);
  int8_t* Hq = reinterpret_cast<int8_t*>(smem + L.off_h);
  int8_t* W2s = reinterpret_cast<int8_t*>(smem + L.off_w2);
  float* mean_s = reinterpret_cast<float*>(smem + L.off_stats);
  float* rstd_s = mean_s + QBM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps
  const int m0 = blockIdx.x * QBM;
  const int split = blockIdx.y;
  const int nh = H / QHB;
  const int hb_begin = (int)((long)split * nh / a.nsplit);
  const int nhb = (int)((long)(split + 1) * nh / a.nsplit) - hb_begin;
  const bool ln = a.ln_w != nullptr;

  // LayerNorm statistics, f32, two passes, one warp a row.
  for (int r = warp; r < QBM; r += QTHREADS / 32) {
    const int row = m0 + r;
    float mean = 0.f, rstd = 1.f;
    if (ln && row < a.M) {
      const bf16* src = a.x + (long)row * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f(src[c]);
      mean = warp_sum(s) / C;
      float q = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(src[c]) - mean;
        q += d * d;
      }
      rstd = rsqrtf(warp_sum(q) / C + a.eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();

  // The block's rows, normalized and quantized, as int8.
  const float s1 = *a.s1, s2 = *a.s2;
  const int vecs = (L.ldx - 16) / 8;  // 8-channel vectors a row
  for (int idx = tid; idx < QBM * vecs; idx += QTHREADS) {
    const int r = idx / vecs, c = (idx - r * vecs) * 8;
    int code[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (m0 + r < a.M && c < C) {
      Pack8 v;
      v.u = *reinterpret_cast<const uint4*>(a.x + (long)(m0 + r) * C + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f = to_f(v.h[j]);
        if (ln) f = (f - mean_s[r]) * rstd_s[r] * to_f(a.ln_w[c + j]) + to_f(a.ln_b[c + j]);
        code[j] = quantize_s8(f, s1);
      }
    }
    *reinterpret_cast<uint2*>(Xq + r * L.ldx + c) =
        make_uint2(pack_s8(code[0], code[1], code[2], code[3]),
                   pack_s8(code[4], code[5], code[6], code[7]));
  }
  __syncthreads();

  int acc[2][4][4];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  };
  // The warp's 32 x 32 product over one staged K tile: A rows from `atile`
  // (ld bytes), B rows (N) `brow[j]` of the staged weight tile.
  auto mma_tile = [&](const int8_t* atile, int ld, const int8_t* btile, const int* brow) {
#pragma unroll
    for (int ks = 0; ks < QKT; ks += 32) {
      uint32_t fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a_s8(fa[i], atile + (wm * 32 + i * 16) * ld + ks, ld, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        load_b_s8(b0, b1, btile + brow[j] * QLD + ks, QLD, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16832_s8(acc[i][j], fa[i], b0, b1);
      }
    }
  };

  // Phase A: Hq = quantize((x W1v + bv) * gelu(x W1g + bg)) for the range.
  // Tile rows 0..63 are value units, 64..127 the same gate units; the warp
  // takes value units wn*16 + [0, 16) (n tiles 0, 1) and their gates (2, 3).
  const int brow_a[4] = {wn * 16, wn * 16 + 8, QHB + wn * 16, QHB + wn * 16 + 8};
  const int kchunks = (L.ldx - 16) / QKT;
  for (int hb = 0; hb < nhb; ++hb) {
    const int j0 = (hb_begin + hb) * QHB;
    uint4 rw[2];
    auto fetch_w1 = [&](int kc) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + QTHREADS * i;  // (tile row, 16-byte k vector) over 128 x 4
        const int n = q >> 2, c = kc * QKT + (q & 3) * 16;
        const long row = n < QHB ? j0 + n : H + j0 + n - QHB;
        rw[i] = c < C ? *reinterpret_cast<const uint4*>(a.w1 + row * C + c) : make_uint4(0, 0, 0, 0);
      }
    };
    zero();
    fetch_w1(0);
    for (int kc = 0; kc < kchunks; ++kc) {
      int8_t* w1s = W1s + (kc & 1) * W1_STAGE;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + QTHREADS * i;
        *reinterpret_cast<uint4*>(w1s + (q >> 2) * QLD + (q & 3) * 16) = rw[i];
      }
      __syncthreads();
      if (kc + 1 < kchunks) fetch_w1(kc + 1);
      mma_tile(Xq + kc * QKT, L.ldx, w1s, brow_a);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 32 + i * 16 + g + 8 * hh;
#pragma unroll
        for (int jv = 0; jv < 2; ++jv) {
          const int u = wn * 16 + jv * 8 + 2 * t;  // units u, u + 1 of this step
          int code[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = j0 + u + e;
            const float hv = (float)acc[i][jv][2 * hh + e] * a.os1[jj] + to_f(a.b1[jj]);
            const float hg = (float)acc[i][jv + 2][2 * hh + e] * a.os1[H + jj] + to_f(a.b1[H + jj]);
            code[e] = quantize_s8(hv * gelu_erf(hg), s2);
          }
          *reinterpret_cast<uint16_t*>(Hq + r * L.ldh + hb * QHB + u) =
              (uint16_t)((code[0] & 0xff) | ((code[1] & 0xff) << 8));
        }
      }
    __syncthreads();  // the next step restarts the ring; phase B reads Hq
  }

  // Phase B: partial out = Hq W2[:, range]^T, int32, 128 columns a pass.
  const int jb = hb_begin * QHB;
  int* wsb = a.ws + ((long)split * a.Mpad + m0) * C;
  const int brow_b[4] = {wn * 32, wn * 32 + 8, wn * 32 + 16, wn * 32 + 24};
  for (int oc = 0; oc < C; oc += QOC) {
    uint4 r2[2];
    auto fetch_w2 = [&](int ks) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + QTHREADS * i;  // (output column, 16-byte k vector)
        const int n = q >> 2;
        r2[i] = oc + n < C ? *reinterpret_cast<const uint4*>(a.w2 + (long)(oc + n) * H + jb +
                                                              ks * QKT + (q & 3) * 16)
                           : make_uint4(0, 0, 0, 0);
      }
    };
    zero();
    fetch_w2(0);
    for (int ks = 0; ks < nhb; ++ks) {
      int8_t* w2s = W2s + (ks & 1) * W2_STAGE;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + QTHREADS * i;
        *reinterpret_cast<uint4*>(w2s + (q >> 2) * QLD + (q & 3) * 16) = r2[i];
      }
      __syncthreads();
      if (ks + 1 < nhb) fetch_w2(ks + 1);
      mma_tile(Hq + ks * QKT, L.ldh, w2s, brow_b);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = oc + wn * 32 + j * 8 + 2 * t;
      if (col >= C) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * 32 + i * 16 + g + 8 * hh;
          *reinterpret_cast<int2*>(wsb + (long)r * C + col) =
              make_int2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
    }
    __syncthreads();  // the next pass refills the ring
  }
}

// out = (sum over splits of ws) * os2 + b2 + residual, in f32, then cast.
__global__ void ffn_q_finalize(const int* ws, const float* os2, const bf16* b2, const bf16* res,
                               bf16* out, int M, int Mpad, int C, int nsplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * C) return;
  const long m = i / C;
  const int c = (int)(i - m * C);
  int s = 0;
  for (int sp = 0; sp < nsplit; ++sp) s += ws[((long)sp * Mpad + m) * C + c];
  float v = (float)s * os2[c] + to_f(b2[c]);
  if (res != nullptr) v += to_f(res[i]);
  out[i] = to_bf(v);
}

constexpr int kMaxSmemQ = 232448;  // 227 KB a block may use on Hopper

}  // namespace
}  // namespace sdtk

// Rows per block: the wrapper pads the workspace's M to a multiple of it.
extern "C" int sdtk_ffn_q_rows() { return sdtk::QBM; }

// The launch plan for M rows of width C and H hidden units: the most
// 64-unit hidden blocks per block (rb) and the number of hidden splits
// (nsplit); the workspace is (nsplit, ceil(M/64)*64, C) int32.  Returns 0,
// or cudaErrorInvalidValue when no plan fits shared memory.
extern "C" int sdtk_ffn_q_plan(int M, int C, int H, int* rb, int* nsplit) {
  using namespace sdtk;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int mblocks = (M + QBM - 1) / QBM;
  const int nh = H / QHB;
  int r = 8;
  while (r > 1 && (long)mblocks * ((nh + r - 1) / r) < sms) r /= 2;
  while (r > 1 && ffn_q_layout(C, r).total > kMaxSmemQ) r /= 2;
  if (ffn_q_layout(C, r).total > kMaxSmemQ) return (int)cudaErrorInvalidValue;
  *rb = r;
  *nsplit = (nh + r - 1) / r;
  return 0;
}

// Shape rules (checked by the Python wrapper): C % 32 == 0, H % 64 == 0,
// x, w1 and w2 16-byte aligned, every tensor contiguous, (rb, nsplit) from
// sdtk_ffn_q_plan and ws sized from them; ln_w/ln_b both given or both
// null, res may be null.
extern "C" int sdtk_ffn_q(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                          const void* s1, const void* os1, const void* b1, const void* w2,
                          const void* s2, const void* os2, const void* b2, const void* res,
                          void* ws, void* out, int M, int C, int H, int rb, int nsplit, float eps,
                          void* stream) {
  using namespace sdtk;
  const int Mpad = (M + QBM - 1) / QBM * QBM;
  const int smem = ffn_q_layout(C, rb).total;
  cudaError_t err =
      cudaFuncSetAttribute(ffn_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FfnQArgs a{static_cast<const bf16*>(x),    static_cast<const bf16*>(ln_w),
             static_cast<const bf16*>(ln_b), static_cast<const int8_t*>(w1),
             static_cast<const float*>(s1),  static_cast<const float*>(os1),
             static_cast<const bf16*>(b1),   static_cast<const int8_t*>(w2),
             static_cast<const float*>(s2),  static_cast<int*>(ws),
             M, Mpad, C, H, nsplit, rb, eps};
  ffn_q_kernel<<<dim3(Mpad / QBM, nsplit), QTHREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)M * C;
  ffn_q_finalize<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const int*>(ws), static_cast<const float*>(os2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), M, Mpad, C, nsplit);
  return (int)cudaGetLastError();
}
