// K7: static-W8A8 3x3 SAME stride-1 convolution over NHWC bf16: the
// GroupNorm scale/shift + SiLU prologue, the activation quantized to int8
// with the layer's calibrated step, an int8 x int8 -> int32 implicit GEMM,
// and the epilogue acc * (s_x * weight_scale[n]) + bias[n] in f32, bf16 out.
//
// Replaces: stable_diffusion_tpu/ops/conv.py `_conv3x3_q_kernel` (launched
// by `_conv3x3_q_call`, reached through `gn_silu_conv3x3`'s W8A8 branch).
//
// What bounds it on Hopper: the int8 tensor-core work.  A UNet resblock
// conv does 2*9*Cin*Cout operations per output pixel against 2*Cin + 2*Cout
// bytes, far above the ridge (1979 TOPS / 3.35 TB/s ~ 590 ops/byte); the
// nine taps re-read the input halo from L1/L2.
//
// Design: K2's implicit GEMM.  M = output pixels (B*H*W), N = Cout, K =
// 9*Cin ordered (tap, channel).  A block computes 128 pixels x 128 output
// channels (64 where Cout is not a multiple of 128); 8 warps, each 32
// pixels x half the channels, of m16n8k32 s8 `mma.sync` products with s32
// accumulators.  Each K step gathers a (128 pixel x 64 channel) tile of one
// tap straight from NHWC with 16-byte loads into registers, while the
// previous step is multiplied; the prologue, silu(x * scale + shift) rounded
// to bf16 (the plain version casts the normalized activation to its dtype
// before the quantizer, as JAX's W8A8 branch does) and then
// clip(rint(v / s_x), +-127), is applied as the tile is staged to shared
// memory, and an out-of-image tap stages 0.  So the int8 activation exists
// only in shared memory; the TPU kernel wrote it to HBM (`_conv3x3_q` builds
// `xq`, then a width-im2col slab).  The weight is read as (3, 3, Cout, Cin)
// int8, each tap's slab K-contiguous for the B operand, through a two-stage
// ring with A.  Where the output tiles alone would leave SMs idle (the 8^2
// and 16^2 stages), the K steps are split over blocks that write int32
// partial sums, and a second kernel adds them (exact in any order) and
// applies the epilogue.  Simple first: no TMA, no wgmma.
#include "mma.cuh"

namespace sdtk {
namespace {

constexpr int CBM = 128;      // output pixels per block
constexpr int CBK = 64;       // input channels (bytes) per K step, one tap
constexpr int CTHREADS = 256;
constexpr int CLD = CBK + 16;  // bytes a staged row: 16 mod 32, conflict-free fragments
constexpr int CA_VECS = CBM * CBK / 8 / CTHREADS;  // 8-channel input vectors per thread

struct ConvQArgs {
  const bf16* x;       // (B, H, W, Cin)
  const int8_t* w;     // (3, 3, Cout, Cin)
  const float* sx;     // (1) the activation step
  const float* os;     // (Cout) sx * weight_scale
  const bf16* bias;    // (Cout) or null
  const float* ss;     // (B, 2, Cin) GroupNorm scale/shift, or null
  bf16* y;             // (B, H, W, Cout)
  int* ws;             // (ksplit, B*H*W, Cout) int32 partial sums when ksplit > 1
  int B, H, W, Cin, Cout, ksplit;
};

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

template <int BN>
__global__ void __launch_bounds__(CTHREADS) conv3x3_q_kernel(ConvQArgs a) {
  constexpr int NT = BN / 16;          // n8 tiles per warp: a warp takes BN / 2 columns
  constexpr int B_VECS = BN / 64;      // 16-byte weight vectors per thread per step
  __shared__ __align__(16) int8_t As[2][CBM * CLD];
  __shared__ __align__(16) int8_t Bs[2][BN * CLD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps
  const long m0 = (long)blockIdx.x * CBM;
  const int n0 = blockIdx.y * BN;
  const int HW = a.H * a.W;
  const long M = (long)a.B * HW;
  const float sx = *a.sx;

  // Each thread gathers CA_VECS 8-channel vectors of the A tile per step,
  // pixel rows (tid >> 3) + 32 i, channel vector tid & 7.
  const int a_vec = tid & 7;
  int a_b[CA_VECS], a_y[CA_VECS], a_x[CA_VECS];
  bool a_ok[CA_VECS];
#pragma unroll
  for (int i = 0; i < CA_VECS; ++i) {
    const long p = m0 + (tid >> 3) + 32 * i;
    a_ok[i] = p < M;
    const long pp = a_ok[i] ? p : 0;
    a_b[i] = (int)(pp / HW);
    const int rem = (int)(pp - (long)a_b[i] * HW);
    a_y[i] = rem / a.W;
    a_x[i] = rem - a_y[i] * a.W;
  }

  const int kchunks = (a.Cin + CBK - 1) / CBK;  // channels past Cin stage as 0
  const int nk = 9 * kchunks;
  const int k_begin = (int)((long)blockIdx.z * nk / a.ksplit);
  const int k_end = (int)((long)(blockIdx.z + 1) * nk / a.ksplit);
  Pack8 ra[CA_VECS];
  bool va[CA_VECS];
  uint4 rb[B_VECS];
  int cur_c = 0;  // the fetched step's first channel of this thread's vectors

  auto fetch = [&](int kt) {
    const int tap = kt / kchunks;
    const int ci0 = (kt - tap * kchunks) * CBK;
    const int ky = tap / 3, kx = tap - ky * 3;
    cur_c = ci0 + a_vec * 8;
#pragma unroll
    for (int i = 0; i < CA_VECS; ++i) {
      const int yy = a_y[i] + ky - 1, xx = a_x[i] + kx - 1;
      va[i] = a_ok[i] && cur_c < a.Cin && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
      ra[i].u = va[i] ? *reinterpret_cast<const uint4*>(
                            a.x + (((long)a_b[i] * a.H + yy) * a.W + xx) * a.Cin + cur_c)
                      : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int q = tid + CTHREADS * i;  // (output channel, 16-byte k vector) over BN x 4
      const int n = n0 + (q >> 2), cb = ci0 + (q & 3) * 16;
      rb[i] = n < a.Cout && cb < a.Cin
                  ? *reinterpret_cast<const uint4*>(a.w + ((long)tap * a.Cout + n) * a.Cin + cb)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&](int s) {
#pragma unroll
    for (int i = 0; i < CA_VECS; ++i) {
      int code[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (va[i]) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = to_f(ra[i].h[j]);
        if (a.ss != nullptr) {
          // 32-byte aligned: Cin % 32 == 0 and cur_c % 8 == 0
          const float* base = a.ss + (long)a_b[i] * 2 * a.Cin + cur_c;
          const float4 s0 = reinterpret_cast<const float4*>(base)[0];
          const float4 s1 = reinterpret_cast<const float4*>(base)[1];
          const float4 h0 = reinterpret_cast<const float4*>(base + a.Cin)[0];
          const float4 h1 = reinterpret_cast<const float4*>(base + a.Cin)[1];
          const float scale[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float shift[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = to_f(to_bf(silu(v[j] * scale[j] + shift[j])));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) code[j] = quantize_s8(v[j], sx);
      }
      *reinterpret_cast<uint2*>(&As[s][((tid >> 3) + 32 * i) * CLD + a_vec * 8]) =
          make_uint2(pack_s8(code[0], code[1], code[2], code[3]),
                     pack_s8(code[4], code[5], code[6], code[7]));
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int q = tid + CTHREADS * i;
      *reinterpret_cast<uint4*>(&Bs[s][(q >> 2) * CLD + (q & 3) * 16]) = rb[i];
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // Two-stage ring, one barrier a step (stage s is rewritten two steps after
  // its last read, with a barrier between).
  if (k_begin < k_end) fetch(k_begin);
  for (int kt = k_begin; kt < k_end; ++kt) {
    const int s = (kt - k_begin) & 1;
    stage(s);
    __syncthreads();
    if (kt + 1 < k_end) fetch(kt + 1);  // global loads in flight during the MMAs
#pragma unroll
    for (int ks = 0; ks < CBK; ks += 32) {
      uint32_t fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a_s8(fa[i], &As[s][(wm * 32 + i * 16) * CLD + ks], CLD, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        load_b_s8(b0, b1, &Bs[s][(wn * (BN / 2) + j * 8) * CLD + ks], CLD, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16832_s8(acc[i][j], fa[i], b0, b1);
      }
    }
  }

  // Epilogue from the accumulators: int32 partial sums to the workspace when
  // split, else y = acc * os[n] + bias[n] in f32, stored as bf16 pairs.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * (BN / 2) + j * 8 + 2 * t;
    if (col >= a.Cout) continue;  // Cout % 8 == 0: col and col + 1 together
    const float s0 = a.os[col], s1 = a.os[col + 1];
    const float b0 = a.bias != nullptr ? to_f(a.bias[col]) : 0.f;
    const float b1 = a.bias != nullptr ? to_f(a.bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long p = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (p >= M) continue;
        if (a.ksplit > 1) {
          *reinterpret_cast<int2*>(a.ws + ((long)blockIdx.z * M + p) * a.Cout + col) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(a.y + p * a.Cout + col) = __floats2bfloat162_rn(
              (float)acc[i][j][2 * h] * s0 + b0, (float)acc[i][j][2 * h + 1] * s1 + b1);
        }
      }
  }
}

// y = (sum over splits of ws) * os + bias, cast to bf16.
__global__ void conv3x3_q_reduce(const int* ws, const float* os, const bf16* bias, bf16* y,
                                 long M, int Cout, int ksplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * Cout) return;
  const int c = (int)(i % Cout);
  int s = 0;
  for (int z = 0; z < ksplit; ++z) s += ws[z * M * Cout + i];
  y[i] = to_bf((float)s * os[c] + (bias != nullptr ? to_f(bias[c]) : 0.f));
}

// Output channels per block: 128 where Cout is a multiple of it, else 64.
inline int tile_n_q(int Cout) { return Cout % 128 == 0 ? 128 : 64; }

template <int BN>
cudaError_t launch_q(const ConvQArgs& a, long M, cudaStream_t st) {
  dim3 grid((unsigned)((M + CBM - 1) / CBM), (unsigned)((a.Cout + BN - 1) / BN),
            (unsigned)a.ksplit);
  conv3x3_q_kernel<BN><<<grid, CTHREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdtk

// Number of K splits: enough blocks for two per SM when the output tile
// grid alone is small, keeping at least 8 K steps per split (K2's rule).
// The wrapper sizes the int32 workspace (ksplit, B*H*W, Cout) from it.
extern "C" int sdtk_conv3x3_q_ksplit(int B, int H, int W, int Cin, int Cout) {
  using namespace sdtk;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long M = (long)B * H * W;
  const int bn = tile_n_q(Cout);
  const long tiles = ((M + CBM - 1) / CBM) * ((Cout + bn - 1) / bn);
  const int nk = 9 * ((Cin + CBK - 1) / CBK);
  long ks = (2 * sms + tiles - 1) / tiles;
  if (ks > nk / 8) ks = nk / 8;
  if (ks > 16) ks = 16;
  return ks < 1 ? 1 : (int)ks;
}

// Shape rules (checked by the Python wrapper): Cin % 32 == 0, Cout % 8 ==
// 0, x and w 16-byte aligned, tensors contiguous, ws sized as
// sdtk_conv3x3_q_ksplit says (null when it says 1); bias and ss may be null.
extern "C" int sdtk_conv3x3_q(const void* x, const void* w, const void* sx, const void* os,
                              const void* bias, const void* ss, void* y, void* ws, int B, int H,
                              int W, int Cin, int Cout, int ksplit, void* stream) {
  using namespace sdtk;
  ConvQArgs a{static_cast<const bf16*>(x),    static_cast<const int8_t*>(w),
              static_cast<const float*>(sx),  static_cast<const float*>(os),
              static_cast<const bf16*>(bias), static_cast<const float*>(ss),
              static_cast<bf16*>(y),          static_cast<int*>(ws),
              B, H, W, Cin, Cout, ksplit};
  const long M = (long)B * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = tile_n_q(Cout) == 128 ? launch_q<128>(a, M, st) : launch_q<64>(a, M, st);
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const long n = M * Cout;
  conv3x3_q_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const int*>(ws), static_cast<const float*>(os), static_cast<const bf16*>(bias),
      static_cast<bf16*>(y), M, Cout, ksplit);
  return (int)cudaGetLastError();
}
