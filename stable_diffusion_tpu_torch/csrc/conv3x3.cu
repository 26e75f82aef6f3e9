// K2: 3x3 SAME stride-1 convolution over NHWC bf16, with an optional
// GroupNorm scale/shift + SiLU prologue applied to the input as it is read.
//
// Replaces: stable_diffusion_tpu/ops/conv.py `_conv3x3_kernel` (launched by
// `_conv3x3_call`, reached through `conv3x3` and `gn_silu_conv3x3`).
//
// What bounds it on Hopper: the tensor-core work.  A UNet resblock conv has
// 2*9*Cin*Cout FLOPs per output pixel against 2*Cin+2*Cout bytes, far above
// the H100's ~295 FLOP/byte ridge, so the kernel must keep the tensor cores
// fed; the input halo re-read by the nine taps comes from L1/L2.
//
// Design: an implicit GEMM.  M = output pixels (B*H*W), N = Cout,
// K = 9*Cin ordered (tap, channel) to match the HWIO weight.  A block
// computes 128 pixels x 128 output channels (64 where Cout is not a
// multiple of 128), so each gathered and activated input tile serves as
// many outputs as the registers allow.  The TPU kernel
// built a width-im2col slab x3 (B, H+2, W, 3C) in HBM (3x the input bytes);
// here each K step gathers a (128 pixel x 64 channel) tile of one tap
// straight from NHWC with 16-byte loads, so nothing extra reaches device
// memory.  The GroupNorm+SiLU prologue is applied to those registers before
// they are staged to shared memory, and an out-of-image tap writes 0: the
// zero halo comes after the activation, as in the JAX path, which
// normalises and SiLUs first and pads with zeros afterwards.  Products run on
// the tensor cores through WMMA (bf16 in, f32 accumulate); the next K tile is
// fetched into registers while the current one is multiplied, through a
// two-stage shared-memory ring.  Bias is added
// in the f32 epilogue.  Where the output tiles alone would leave SMs idle
// (the UNet's 8^2 and 16^2 stages: 128 and 512 pixels at batch 2, with K up
// to 9*2560), the K steps are split over blocks that write f32 partial sums
// and a second kernel adds them in a fixed order with the bias.  Simple
// first: no TMA/wgmma pipeline yet.
#include "common.cuh"

using namespace nvcuda;

namespace sdtk {
namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BK = 64;   // input channels per K step (one tap)
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;
constexpr int SMEM_A = BM * LDA * 2;
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 8-channel vectors per thread

// Tile shape for BN output channels per block (64, or 128 where Cout allows):
// 8 warps, each a (BM / WM) x 32 tile of 16x16 WMMA accumulators.
template <int BN>
struct Tile {
  static constexpr int WM = BN == 64 ? 4 : 2;      // warps along M
  static constexpr int FM = BM / WM / 16;          // accumulators along M per warp
  static constexpr int LDB = BN + 8;
  static constexpr int LDC = BN + 4;
  static constexpr int SMEM_B = BK * LDB * 2;
  static constexpr int STAGE = SMEM_A + SMEM_B;    // one of two ring stages
  static constexpr int SMEM_C = BM * LDC * 4;
  static constexpr int SMEM = SMEM_C > 2 * STAGE ? SMEM_C : 2 * STAGE;
  static constexpr int BROW = BN / 8;              // 8-channel vectors per B row
  static constexpr int B_VECS = BK * BN / 8 / THREADS;
};

struct ConvArgs {
  const bf16* x;     // (B, H, W, Cin)
  const bf16* w;     // (3, 3, Cin, Cout) = HWIO
  const bf16* bias;  // (Cout) or null
  const float* ss;   // (B, 2, Cin) GroupNorm scale/shift, or null
  bf16* y;           // (B, H, W, Cout)
  float* ws;         // (ksplit, B*H*W, Cout) f32 partial sums when ksplit > 1
  int B, H, W, Cin, Cout, ksplit;
};

// Fast-math SiLU (the prologue runs once per tap, 9x per input element).
// For v << 0, __expf(-v) overflows to inf and __fdividef gives -0, as silu does.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

template <int BN>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(ConvArgs a) {
  using T = Tile<BN>;
  constexpr int LDB = T::LDB, LDC = T::LDC, STAGE = T::STAGE, FM = T::FM, B_VECS = T::B_VECS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue staging, reuses the ring

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp % T::WM;  // warp's rows: wm * FM * 16 ...
  const int wn = warp / T::WM;  // ... and columns: wn * 32
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int HW = a.H * a.W;
  const long M = (long)a.B * HW;

  // Each thread gathers A_VECS 8-channel vectors of the A tile per K step,
  // one per pixel row (tid >> 3) + 32 i.
  const int a_vec = tid & 7;
  int a_b[A_VECS], a_y[A_VECS], a_x[A_VECS];
  bool a_ok[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const long p = m0 + (tid >> 3) + 32 * i;
    a_ok[i] = p < M;
    const long pp = a_ok[i] ? p : 0;
    a_b[i] = (int)(pp / HW);
    const int rem = (int)(pp - (long)a_b[i] * HW);
    a_y[i] = rem / a.W;
    a_x[i] = rem - a_y[i] * a.W;
  }
  // ... and B_VECS 8-channel vectors of the B (weight) tile, rows
  // tid / BROW + (THREADS / BROW) i, column vector tid % BROW.
  const int b_col = n0 + (tid % T::BROW) * 8;
  const bool b_ok = b_col < a.Cout;

  const int kchunks = (a.Cin + BK - 1) / BK;  // channels past Cin read as 0
  const int nk = 9 * kchunks;
  // Split-K: block z of ksplit takes K steps [k_begin, k_end).
  const int k_begin = (int)((long)blockIdx.z * nk / a.ksplit);
  const int k_end = (int)((long)(blockIdx.z + 1) * nk / a.ksplit);
  Pack8 ra[A_VECS], rb[B_VECS];

  auto fetch = [&](int kt) {
    const int tap = kt / kchunks;
    const int ci0 = (kt - tap * kchunks) * BK;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int c = ci0 + a_vec * 8;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int yy = a_y[i] + ky - 1, xx = a_x[i] + kx - 1;
      ra[i].u = make_uint4(0, 0, 0, 0);
      if (a_ok[i] && c < a.Cin && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
        ra[i].u = *reinterpret_cast<const uint4*>(
            a.x + (((long)a_b[i] * a.H + yy) * a.W + xx) * a.Cin + c);
        if (a.ss != nullptr) {
          // 32-byte aligned: Cin % 8 == 0 and c % 8 == 0
          const float4* sc = reinterpret_cast<const float4*>(a.ss + (long)a_b[i] * 2 * a.Cin + c);
          const float4* sh = reinterpret_cast<const float4*>(a.ss + (long)a_b[i] * 2 * a.Cin +
                                                             a.Cin + c);
          const float4 s0 = sc[0], s1 = sc[1], h0 = sh[0], h1 = sh[1];
          const float scale[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float shift[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            ra[i].h[j] = to_bf(silu(to_f(ra[i].h[j]) * scale[j] + shift[j]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int ci = ci0 + tid / T::BROW + (THREADS / T::BROW) * i;
      rb[i].u = make_uint4(0, 0, 0, 0);
      if (b_ok && ci < a.Cin)
        rb[i].u = *reinterpret_cast<const uint4*>(a.w + (long)(tap * a.Cin + ci) * a.Cout + b_col);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Two-stage ring: the tile for step kt goes to stage kt & 1, so one barrier
  // per step suffices (stage s is rewritten only after every warp has passed
  // the barrier of the step that followed its last use).
  fetch(k_begin);
  for (int kt = k_begin; kt < k_end; ++kt) {
    bf16* As = reinterpret_cast<bf16*>(smem + (kt & 1) * STAGE);
    bf16* Bs = reinterpret_cast<bf16*>(smem + (kt & 1) * STAGE + SMEM_A);
#pragma unroll
    for (int i = 0; i < A_VECS; ++i)
      *reinterpret_cast<uint4*>(As + ((tid >> 3) + 32 * i) * LDA + a_vec * 8) = ra[i].u;
#pragma unroll
    for (int i = 0; i < B_VECS; ++i)
      *reinterpret_cast<uint4*>(Bs + (tid / T::BROW + (THREADS / T::BROW) * i) * LDB +
                                (tid % T::BROW) * 8) = rb[i].u;
    __syncthreads();
    if (kt + 1 < k_end) fetch(kt + 1);  // global loads in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * FM * 16 + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * 16 * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();  // the epilogue staging reuses the ring

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: +bias in f32, cast, 16-byte stores of 8 channels.
#pragma unroll
  for (int it = 0; it < (BM * BN / 8) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx / T::BROW;
    const int cv = idx % T::BROW;
    const int col = n0 + cv * 8;
    const long p = m0 + r;
    if (p >= M || col >= a.Cout) continue;
    const float* src = Cs + r * LDC + cv * 8;
    if (a.ksplit > 1) {  // partial sum; conv3x3_reduce adds the splits and the bias
      float4* dst = reinterpret_cast<float4*>(a.ws + ((long)blockIdx.z * M + p) * a.Cout + col);
      dst[0] = make_float4(src[0], src[1], src[2], src[3]);
      dst[1] = make_float4(src[4], src[5], src[6], src[7]);
      continue;
    }
    Pack8 o;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = src[j];
      if (a.bias != nullptr) v += to_f(a.bias[col + j]);
      o.h[j] = to_bf(v);
    }
    *reinterpret_cast<uint4*>(a.y + p * a.Cout + col) = o.u;
  }
}

// y = sum over splits of ws + bias, cast to bf16.
__global__ void conv3x3_reduce(const float* ws, const bf16* bias, bf16* y, long M, int Cout,
                               int ksplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * Cout) return;
  float s = bias != nullptr ? to_f(bias[i % Cout]) : 0.f;
  for (int z = 0; z < ksplit; ++z) s += ws[z * M * Cout + i];
  y[i] = to_bf(s);
}

// Output channels per block: 128 where Cout is a multiple of it (the prologue
// and the A tile are then shared by twice the outputs), else 64.
inline int tile_n(int Cout) { return Cout % 128 == 0 ? 128 : 64; }

template <int BN>
cudaError_t launch(const ConvArgs& a, long M, cudaStream_t st) {
  using T = Tile<BN>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(a.Cout / BN + (a.Cout % BN != 0)),
            (unsigned)a.ksplit);
  conv3x3_kernel<BN><<<grid, THREADS, T::SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdtk

// Number of K splits the launch below uses: enough blocks for two per SM
// when the output tile grid alone is small (the UNet's 8^2 and 16^2 stages),
// keeping at least 8 K steps per split.  The wrapper sizes the f32 workspace
// (ksplit, B*H*W, Cout) from it.
extern "C" int sdtk_conv3x3_ksplit(int B, int H, int W, int Cin, int Cout) {
  using namespace sdtk;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long M = (long)B * H * W;
  const int bn = tile_n(Cout);
  const long tiles = ((M + BM - 1) / BM) * ((Cout + bn - 1) / bn);
  const int nk = 9 * ((Cin + BK - 1) / BK);
  long ks = (2 * sms + tiles - 1) / tiles;
  if (ks > nk / 8) ks = nk / 8;
  if (ks > 16) ks = 16;
  return ks < 1 ? 1 : (int)ks;
}

// Shape rules (checked by the Python wrapper): Cin % 8 == 0, Cout % 8 == 0,
// all pointers 16-byte aligned, tensors contiguous, ws sized as
// sdtk_conv3x3_ksplit says (null when it says 1).
extern "C" int sdtk_conv3x3(const void* x, const void* w, const void* bias, const void* ss,
                            void* y, void* ws, int B, int H, int W, int Cin, int Cout, int ksplit,
                            void* stream) {
  using namespace sdtk;
  ConvArgs a{static_cast<const bf16*>(x),    static_cast<const bf16*>(w),
             static_cast<const bf16*>(bias), static_cast<const float*>(ss),
             static_cast<bf16*>(y),          static_cast<float*>(ws),
             B, H, W, Cin, Cout, ksplit};
  const long M = (long)B * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = tile_n(Cout) == 128 ? launch<128>(a, M, st) : launch<64>(a, M, st);
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const long n = M * Cout;
  conv3x3_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(bias), static_cast<bf16*>(y), M,
      Cout, ksplit);
  return (int)cudaGetLastError();
}
