// K12: 3x3 SAME stride-1 conv as Winograd F(2x2, 3x3), with K2's optional
// GroupNorm+SiLU prologue, NHWC bf16 in and out.
//
// Replaces: stable_diffusion_tpu/ops/winograd.py `_wino_kernel` (launched by
// `conv3x3_winograd`, reached from ops/conv.py `_conv3x3` under
// SD_TPU_WINOGRAD=1, so from `conv3x3` and `_gn_silu_conv`).
//
// Per 4x4 input patch d (stride 2, one per 2x2 output tile) and channel:
//   V = B^T d B (f32, adds only), U = G w G^T (once per weight, in Python),
//   M_k = sum_c V_k[tile, c] U_k[c, cout] for the 16 positions k = (k1, k2),
//   Y = A^T M A (+ bias).
// 2*B*H*W*4*Cin*Cout operations (16 products per 4 outputs against 36 for a
// direct conv: 2.25x fewer), against (B*H*W*(Cin + Cout) + 16*Cin*Cout) * 2
// bytes; at the UNet's and the VAE's shapes above the ridge (~295 flop/byte),
// so the tensor cores bound it, as they bound K2.
//
// Design: one block takes 32 consecutive tiles (row-major over batch, tile
// row, tile column) and 64 output channels; 8 warps, each 16 tiles x 16
// channels.  Cin is walked 16 at a time.  Per step each thread loads one
// tile's 16 pixels for two channels (zero outside the image), applies the
// prologue silu(x * scale + shift) rounded to bf16 (the zero halo comes
// after the activation, as in K2), forms V in f32 and rounds it to bf16 into
// shared memory (16 x 32 x 16); the block loads U's 16 x 64 x 16 slab (the
// transformed weight, (16, Cout, Cin) bf16, cached per weight in Python).
// Then each warp runs the 16 position products on m16n8k16 `mma.sync` and
// folds them straight into the output transform's rows
//   F[0][k2] = M[0][k2] + M[1][k2] + M[2][k2],  F[1][k2] = M[1][k2] - M[2][k2] - M[3][k2]
// (A^T's rows): k1 = 0 accumulates into F[0] directly, k1 = 1..3 through
// one temporary, so the 16 M's never coexist and 8 accumulator sets stay in
// registers across the Cin loop.  The epilogue applies A^T on the other side
// (Y[o1][0] = F[o1][0] + F[o1][1] + F[o1][2], Y[o1][1] = F[o1][1] - F[o1][2]
// - F[o1][3]), adds the bias in f32 and stores bf16 pairs straight into the
// NHWC output: no host-side patch slab (the TPU kernel's `xw`) and no
// position-major output to re-interleave.  The V and U roundings to bf16
// after transforms that grow magnitudes make its error larger than K2's, by
// design.  Simple first: one stage, no TMA, no wgmma.
#include "mma.cuh"

namespace sdtk {
namespace {

constexpr int WBT = 32;       // 2x2 output tiles per block
constexpr int WBN = 64;       // output channels per block
constexpr int WCK = 16;       // input channels per step
constexpr int WTHREADS = 256;
constexpr int WLD = WCK + 8;  // bf16 a staged row: 48 bytes, conflict-free fragments

constexpr int V_ELEMS = 16 * WBT * WLD;
constexpr int U_ELEMS = 16 * WBN * WLD;
constexpr int WSMEM = (V_ELEMS + U_ELEMS) * 2;

struct WinoArgs {
  const bf16* x;      // (B, H, W, Cin)
  const bf16* u;      // (16, Cout, Cin)
  const bf16* bias;   // (Cout) or null
  const float* ss;    // (B, 2, Cin) or null
  bf16* y;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout;
};

// As K2's: for v << 0, __expf(-v) overflows to inf and __fdividef gives -0.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

__global__ void __launch_bounds__(WTHREADS, 2) winograd_kernel(WinoArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Vs = reinterpret_cast<bf16*>(smem);  // [16][WBT][WLD]
  bf16* Us = Vs + V_ELEMS;                   // [16][WBN][WLD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 16 tiles x 16 channels
  const int g = lane >> 2, t = lane & 3;
  const int th = a.H / 2, tw = a.W / 2;
  const long ntiles = (long)a.B * th * tw;
  const long t0 = (long)blockIdx.x * WBT;
  const int n0 = blockIdx.y * WBN;

  // This thread's V work: tile t0 + vt, channels 2 vc, 2 vc + 1 of the step.
  const int vt = tid >> 3, vc = tid & 7;
  const long vtile = t0 + vt;
  int vb = 0, vy = 0, vx = 0;
  if (vtile < ntiles) {
    vb = (int)(vtile / ((long)th * tw));
    const int rem = (int)(vtile - (long)vb * th * tw);
    vy = 2 * (rem / tw) - 1;  // the patch's top-left input pixel
    vx = 2 * (rem % tw) - 1;
  }

  float F[2][4][2][4];  // [o1][k2][n8 tile][fragment]
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) F[o][k][j][e] = 0.f;

  for (int c0 = 0; c0 < a.Cin; c0 += WCK) {
    __syncthreads();  // the previous step's fragments are read
    // V = B^T d B for two channels of one tile: the 16 pixels stay packed
    // as bf16 pairs (after the prologue, which rounds to bf16 anyway) and
    // each channel is transformed in f32 on its own, to keep registers for F.
    {
      const int c = c0 + 2 * vc;
      const bool live = vtile < ntiles && c < a.Cin;
      float sc0 = 1.f, sc1 = 1.f, sh0 = 0.f, sh1 = 0.f;
      if (live && a.ss != nullptr) {
        const float* s = a.ss + (long)vb * 2 * a.Cin;
        sc0 = s[c];
        sc1 = s[c + 1];
        sh0 = s[a.Cin + c];
        sh1 = s[a.Cin + c + 1];
      }
      __nv_bfloat162 raw[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int yy = vy + i, xx = vx + j;
          __nv_bfloat162 p = __floats2bfloat162_rn(0.f, 0.f);
          if (live && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
            p = *reinterpret_cast<const __nv_bfloat162*>(
                a.x + (((long)vb * a.H + yy) * a.W + xx) * a.Cin + c);
            if (a.ss != nullptr)  // the activation, rounded to bf16 as K2's
              p = __floats2bfloat162_rn(silu(__low2float(p) * sc0 + sh0),
                                        silu(__high2float(p) * sc1 + sh1));
          }
          raw[i * 4 + j] = p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) d[k] = h ? __high2float(raw[k]) : __low2float(raw[k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // rows: E = B^T d
          const float r0 = d[j], r1 = d[4 + j], r2 = d[8 + j], r3 = d[12 + j];
          d[j] = r0 - r2;
          d[4 + j] = r1 + r2;
          d[8 + j] = r2 - r1;
          d[12 + j] = r1 - r3;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // columns: V = E B
          const float r0 = d[4 * i], r1 = d[4 * i + 1], r2 = d[4 * i + 2], r3 = d[4 * i + 3];
          d[4 * i] = r0 - r2;
          d[4 * i + 1] = r1 + r2;
          d[4 * i + 2] = r2 - r1;
          d[4 * i + 3] = r1 - r3;
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) Vs[(k * WBT + vt) * WLD + 2 * vc + h] = to_bf(d[k]);
      }
    }
    // U's slab: 16 positions x 64 channels x 16 inputs, two 8-value vectors a row.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = tid + WTHREADS * i;
      const int k = q >> 7, n = (q >> 1) & 63, half = q & 1;
      const int c = c0 + half * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + n < a.Cout && c < a.Cin)
        v = *reinterpret_cast<const uint4*>(a.u + ((long)k * a.Cout + n0 + n) * a.Cin + c);
      *reinterpret_cast<uint4*>(&Us[(k * WBN + n) * WLD + half * 8]) = v;
    }
    __syncthreads();

    // The 16 position products, folded into A^T's rows.
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) {
        const int pos = k1 * 4 + k2;
        const bf16* ap = &Vs[(pos * WBT + wm * 16) * WLD];
        uint32_t fa[4];
        fa[0] = lds32(ap + g * WLD + 2 * t);
        fa[1] = lds32(ap + (g + 8) * WLD + 2 * t);
        fa[2] = lds32(ap + g * WLD + 2 * t + 8);
        fa[3] = lds32(ap + (g + 8) * WLD + 2 * t + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* bp = &Us[(pos * WBN + wn * 16 + j * 8 + g) * WLD];
          const uint32_t b0 = lds32(bp + 2 * t), b1 = lds32(bp + 2 * t + 8);
          if (k1 == 0) {
            mma16816(F[0][k2][j], fa, b0, b1);
          } else {
            float m[4] = {0.f, 0.f, 0.f, 0.f};
            mma16816(m, fa, b0, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (k1 == 1) {
                F[0][k2][j][e] += m[e];
                F[1][k2][j][e] += m[e];
              } else if (k1 == 2) {
                F[0][k2][j][e] += m[e];
                F[1][k2][j][e] -= m[e];
              } else {
                F[1][k2][j][e] -= m[e];
              }
            }
          }
        }
      }
  }

  // Epilogue: Y = F A + bias, straight to NHWC.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = n0 + wn * 16 + j * 8 + 2 * t;
    if (col >= a.Cout) continue;  // Cout % 8 == 0: col and col + 1 together
    const float b0 = a.bias != nullptr ? to_f(a.bias[col]) : 0.f;
    const float b1 = a.bias != nullptr ? to_f(a.bias[col + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long tile = t0 + wm * 16 + g + 8 * h;
      if (tile >= ntiles) continue;
      const int b = (int)(tile / ((long)th * tw));
      const int rem = (int)(tile - (long)b * th * tw);
      const int oy = 2 * (rem / tw), ox = 2 * (rem % tw);
#pragma unroll
      for (int o1 = 0; o1 < 2; ++o1) {
        const float* f0 = F[o1][0][j];
        const float* f1 = F[o1][1][j];
        const float* f2 = F[o1][2][j];
        const float* f3 = F[o1][3][j];
        const int e0 = 2 * h, e1 = 2 * h + 1;
        const float y00 = f0[e0] + f1[e0] + f2[e0] + b0, y01 = f0[e1] + f1[e1] + f2[e1] + b1;
        const float y10 = f1[e0] - f2[e0] - f3[e0] + b0, y11 = f1[e1] - f2[e1] - f3[e1] + b1;
        bf16* out = a.y + (((long)b * a.H + oy + o1) * a.W + ox) * a.Cout + col;
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y00, y01);
        *reinterpret_cast<__nv_bfloat162*>(out + a.Cout) = __floats2bfloat162_rn(y10, y11);
      }
    }
  }
}

}  // namespace
}  // namespace sdtk

// Shape rules (checked by the Python wrapper): H and W even, Cin % 8 == 0,
// Cout % 8 == 0, every tensor contiguous and 16-byte aligned; bias and ss
// may be null.
extern "C" int sdtk_winograd(const void* x, const void* u, const void* bias, const void* ss,
                             void* y, int B, int H, int W, int Cin, int Cout, void* stream) {
  using namespace sdtk;
  cudaError_t err =
      cudaFuncSetAttribute(winograd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err != cudaSuccess) return (int)err;
  WinoArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(u),
             static_cast<const bf16*>(bias), static_cast<const float*>(ss),
             static_cast<bf16*>(y), B, H, W, Cin, Cout};
  const long ntiles = (long)B * (H / 2) * (W / 2);
  dim3 grid((unsigned)((ntiles + WBT - 1) / WBT), (unsigned)((Cout + WBN - 1) / WBN));
  winograd_kernel<<<grid, WTHREADS, WSMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
