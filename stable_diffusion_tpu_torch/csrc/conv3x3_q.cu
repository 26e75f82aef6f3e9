// K7: static-W8A8 3x3 SAME stride-1 convolution over NHWC bf16: the
// GroupNorm scale/shift + SiLU prologue, the activation quantized to int8
// with the layer's calibrated step, an int8 x int8 -> int32 implicit GEMM,
// and the epilogue acc * (s_x * weight_scale[n]) + bias[n] in f32, bf16 out.
//
// Replaces: stable_diffusion_tpu/ops/conv.py:333 `_conv3x3_q_kernel`
// (launched by `_conv3x3_q_call`, reached through `gn_silu_conv3x3`'s W8A8
// branch).
//
// What bounds it on Hopper: the int8 tensor-core work.  A UNet resblock
// conv does 2*9*Cin*Cout operations per output pixel against 2*Cin + 2*Cout
// bytes, far above the ridge (1979 TOP/s / 3.35 TB/s ~ 590 ops/byte).  So
// the products must run at the wgmma rate, the prologue and the quantizer
// must not run once per tap and column block, and the weight slabs, which
// every output tile streams from L2 (9 Cin x BN bytes a tile), must keep up.
//
// Design: two launches.
// * Launch 1 (conv_q_codes_kernel) quantizes once: silu(x * scale + shift)
//   in f32 from K1's (B, 2, Cin) scale/shift, rounded to bf16 (the plain
//   version casts the activation to its dtype before the quantizer, as
//   JAX's W8A8 branch does), then quantize_s8_rcp (mma.cuh: the codes of
//   the IEEE division v / s_x in five instructions), into an int8 NHWC
//   scratch (B, H, W, Cin).  This is the TPU design's structure (JAX
//   quantizes in XLA before its kernel, `_conv3x3_q`'s `xq`) and K8's first
//   launch.  The first design (mma.sync) ran the prologue and the IEEE
//   division inside the GEMM on every tap's gather, 45-90 times a value.
// * Launch 2 (conv3x3_q_kernel) is K2's halo-tile implicit GEMM on the int8
//   codes (csrc/conv3x3.cu, whose notes this follows).  A block computes a
//   TH x TW rectangle of one image (BM = 128 or 64 GEMM rows) by BN output
//   channels (128 or 160, whichever fills the SMs in fewer waves; else 64).
//   For each 128-channel chunk the (TH+2) x (TW+2) int8 halo is copied by
//   cp.async into shared memory, one 128-byte row a pixel in the 128-byte
//   swizzle, pixels outside the image and channels past Cin zero-filled
//   (code 0 is the zero padding after the activation, as in JAX); two halo
//   buffers let chunk c+1 land while chunk c's nine taps multiply.  For tap
//   (ky, kx) each lane hands `ldmatrix.x4` its pixel's halo row shifted by
//   (ky, kx): the im2col gather is address arithmetic, and the fragments
//   are the register-A operand of s8 `wgmma` m64nNk32 (WgmmaS8RS in
//   wgmma.cuh; ldmatrix gives the s8 k32 fragment from 16 rows x 32 bytes
//   as it gives the bf16 k16 one).  The weight, re-laid once and cached as
//   (3, 3, Cout, Cin) int8, comes through a STAGES-deep cp.async ring of
//   (tap, chunk) slabs of BN rows x 128 bytes, read by descriptor.  A ragged
//   last chunk (Cin = 320, 960) skips its k32 steps past Cin.
// * Epilogue: acc * out_scale[n] + bias[n] in f32, rounded once to bf16,
//   staged per warp in the ring and stored in 16-byte rows.
// * Split K where the output tiles leave SMs without a block (the 8^2
//   stage): each part adds its int32 partial tile into a zeroed workspace
//   with atomics (exact in any order, so the result is deterministic), and
//   the last part to take the tile's ticket (K1's and K8's method) reads
//   the sums back, zeroes them and its ticket for the next call, and runs
//   the epilogue.  No second launch.
// * Measured and not kept (chip_smoke.py --w8a8-sweep, PERF.md): the
//   fused form, K2's, with no launch 1: each chunk's bf16 halo (two
//   128-byte rows a pixel) landed and one pass computed GN+SiLU, the bf16
//   rounding and the codes into an int8 halo.  It repeated the prologue
//   ~1.4 x (column blocks) times a value, held 2.5x the halo bytes and ran
//   one block an SM: 9.3 ms a W8A8 pass against 5.7 for the two launches
//   on an NVIDIA H100 80GB HBM3 at 700 W.  And split K beyond the 8^2
//   stage: the int32 atomic merge cost more than the idle SMs it filled.
// conv3x3_q_plan (ops/conv.py) mirrors the dispatch: the tile, the variant,
// the ring depth, the K split and the shared bytes.
// Not yet: TMA for the halo and the weight slabs (every thread issues
// cp.async), a producer warp, products kept in flight across a step's
// barrier, clusters multicasting the weight slabs.
#include <string.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace sdtk {
namespace {

constexpr int QCH = 128;       // input channels (int8 bytes) a chunk: one swizzled row
constexpr int QTHREADS = 256;  // 8 warps = 2 warpgroups
constexpr int kConvQMaxSmem = 232448;  // 227 KB a block may use on Hopper

struct ConvQArgs {
  const bf16* x;      // (B, H, W, Cin): launch 1's input
  int8_t* xq;         // (B, H, W, Cin) codes: launch 1's output, launch 2's input
  const int8_t* w;    // (3, 3, Cout, Cin): each tap's (Cout, Cin), K-contiguous
  const float* sx;    // (1) the activation step
  const float* os;    // (Cout) sx * weight_scale
  const bf16* bias;   // (Cout) or null
  const float* ss;    // (B, 2, Cin) GroupNorm scale/shift, or null
  bf16* y;            // (B, H, W, Cout)
  int* ws;            // (B*H*W, Cout) int32, zero, when ksplit > 1
  int* tickets;       // (output tiles, column blocks) int32, zero, when ksplit > 1
  int B, H, W, Cin, Cout, TH, TW, ksplit;
};

// Byte offset of 16-byte piece j of 128-byte row r, XOR-swizzled by the row
// (Hopper's 128-byte swizzle from 1024-byte aligned regions).
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * QCH + ((j ^ (r & 7)) << 4));
}

// Fast-math SiLU, as K2's prologue.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// The codes of 8 channels: (silu(v * scale + shift) rounded to bf16 ->)
// clip(rint(v / sx), +-127), packed lowest channel first.
__device__ __forceinline__ uint2 codes8(const Pack8& u, const float* scale, const float* shift,
                                        bool act, float sx, float inv) {
  int c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float v = to_f(u.h[k]);
    if (act) v = to_f(to_bf(silu(v * scale[k] + shift[k])));
    c[k] = quantize_s8_rcp(v, sx, inv);
  }
  return make_uint2(pack_s8(c[0], c[1], c[2], c[3]), pack_s8(c[4], c[5], c[6], c[7]));
}

// Channels c .. c + 7 of image b's scale and shift (32-byte aligned: Cin %
// 8 == 0 and c % 8 == 0).
__device__ __forceinline__ void scale_shift8(const float* ss, int b, int Cin, int c, float* scale,
                                             float* shift) {
  const float4* sc = reinterpret_cast<const float4*>(ss + (long)b * 2 * Cin + c);
  const float4* sh = reinterpret_cast<const float4*>(ss + (long)b * 2 * Cin + Cin + c);
  const float4 s0 = sc[0], s1 = sc[1], h0 = sh[0], h1 = sh[1];
  scale[0] = s0.x, scale[1] = s0.y, scale[2] = s0.z, scale[3] = s0.w;
  scale[4] = s1.x, scale[5] = s1.y, scale[6] = s1.z, scale[7] = s1.w;
  shift[0] = h0.x, shift[1] = h0.y, shift[2] = h0.z, shift[3] = h0.w;
  shift[4] = h1.x, shift[5] = h1.y, shift[6] = h1.z, shift[7] = h1.w;
}

// Launch 1: one thread an 8-channel vector, its codes written once.
__global__ void __launch_bounds__(256) conv_q_codes_kernel(ConvQArgs a) {
  const int cv = a.Cin >> 3;
  const long v = (long)blockIdx.x * 256 + threadIdx.x;
  if (v >= (long)a.B * a.H * a.W * cv) return;
  const long p = v / cv;
  const int c = (int)(v - p * cv) * 8;
  const float sx = *a.sx, inv = 1.f / sx;
  float scale[8], shift[8];
  const bool act = a.ss != nullptr;
  if (act) scale_shift8(a.ss, (int)(p / ((long)a.H * a.W)), a.Cin, c, scale, shift);
  Pack8 u;
  u.u = *reinterpret_cast<const uint4*>(a.x + p * a.Cin + c);
  *reinterpret_cast<uint2*>(a.xq + p * a.Cin + c) = codes8(u, scale, shift, act, sx, inv);
}

// A compiled variant: BM x BN block tile, a ring of STAGES weight slabs.
template <int BM, int BN, int STAGES>
struct QCfg {
  static constexpr int NWG = BM == 128 ? BN : BN / 2;  // columns of a warpgroup's product
  static constexpr int NI = NWG / 8;                   // n8 column tiles of a warp's rows
  static constexpr int SLAB = BN * QCH;                // one (tap, chunk) weight slab
  static constexpr int RING = STAGES * SLAB;
  static constexpr int LDS = NWG + 8;                  // epilogue staging row (bf16)
  static_assert(BM == 128 || BM == 64, "a warpgroup product has 64 rows");
  static_assert(SLAB % 1024 == 0 && (BN / 2 * QCH) % 1024 == 0, "128-byte swizzle atoms");
  static_assert(8 * 16 * LDS * 2 <= RING, "the epilogue staging fits in the ring");
};

// Shared memory of a launch: 1024 bytes to align the ring, the weight ring,
// two int8 halo buffers, 16 for the ticket's flag.
__host__ __device__ inline int qhalo_bytes(int TH, int TW) { return (TH + 2) * (TW + 2) * QCH; }
__host__ __device__ inline int conv_q_smem(int ring, int TH, int TW) {
  return 1024 + ring + 2 * qhalo_bytes(TH, TW) + 16;
}

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(QTHREADS, 2) conv3x3_q_kernel(ConvQArgs a) {
  using C = QCfg<BM, BN, STAGES>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle atoms are absolute
  unsigned char* smem = smem_raw + (ring - raw);
  const int HW2 = a.TW + 2;
  const int hpix = (a.TH + 2) * HW2;
  const int hbytes = qhalo_bytes(a.TH, a.TW);
  const uint32_t halo = ring + C::RING;  // buffer h at halo + h * hbytes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int wg_m = BM == 128 ? wg * 64 : 0, wg_n = BM == 128 ? 0 : wg * C::NWG;
  const int m_w = wg_m + (warp & 3) * 16;

  // The block's output rectangle: image b, rows ty0.., columns tx0..
  const int tiles_x = (a.W + a.TW - 1) / a.TW, tiles_y = (a.H + a.TH - 1) / a.TH;
  int t = blockIdx.x;
  const int tx0 = (t % tiles_x) * a.TW;
  t /= tiles_x;
  const int ty0 = (t % tiles_y) * a.TH;
  const int b = t / tiles_y;
  const int n0 = blockIdx.y * BN;
  const int npix = a.TH * a.TW;

  // Split-K over chunks: block z of ksplit takes chunks [c_begin, c_end).
  const int nchunks = (a.Cin + QCH - 1) / QCH;
  const int c_begin = blockIdx.z * nchunks / a.ksplit;
  const int c_end = (blockIdx.z + 1) * nchunks / a.ksplit;
  const int nsteps = 9 * (c_end - c_begin);  // one step per (chunk, tap)
  const long img = (long)b * a.H * a.W;
  const int j8 = tid & 7;

  // Chunk c's halo into buffer (c - c_begin) & 1: 8 pieces of 16 codes a pixel.
  auto load_halo = [&](int c) {
    const int ch = c * QCH + j8 * 16;
    const uint32_t dst = halo + ((c - c_begin) & 1) * hbytes;
    for (int p = tid >> 3; p < hpix; p += QTHREADS / 8) {
      const int hy = p / HW2, hx = p - hy * HW2;
      const int gy = ty0 + hy - 1, gx = tx0 + hx - 1;
      const bool ok = ch < a.Cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      cp_async16(dst + swz(p, j8), ok ? a.xq + (img + (long)gy * a.W + gx) * a.Cin + ch : a.xq, ok);
    }
  };
  // Step s's weight slab (chunk c_begin + s / 9, tap s % 9) into ring stage s % STAGES.
  auto load_slab = [&](int s) {
    const int c = c_begin + s / 9, tap = s % 9;
    const uint32_t dst = ring + (s % STAGES) * C::SLAB;
    const int ch = c * QCH + j8 * 16;
#pragma unroll
    for (int i = 0; i < BN * 8 / QTHREADS; ++i) {
      const int r = (tid >> 3) + i * (QTHREADS / 8), n = n0 + r;
      const bool ok = ch < a.Cin && n < a.Cout;
      cp_async16(dst + swz(r, j8), ok ? a.w + ((long)tap * a.Cout + n) * a.Cin + ch : a.w, ok);
    }
  };
  // Each lane's A row: output row m = m_w + (lane & 15) sits at halo pixel
  // hp0 + (ky * HW2 + kx) for tap (ky, kx).  Rows past the rectangle read
  // pixel 0 and are never stored.
  const int m_a = m_w + (lane & 15);
  const int hp0 = m_a < npix ? (m_a / a.TW) * HW2 + m_a % a.TW : 0;
  const uint64_t desc0 = sw128_desc(ring + wg_n * QCH);

  int acc[C::NWG / 2];
#pragma unroll
  for (int k = 0; k < C::NWG / 2; ++k) acc[k] = 0;

  // The ring: step s's slab is in commit group s; chunk c's halo rides in
  // the group issued at the first step of chunk c - 1 (the first chunk's
  // in group 0), so it has landed by chunk c's first step (STAGES <= 10).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) {
      if (s == 0) load_halo(c_begin);
      load_slab(s);
    }
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();  // step s's slab and halo have landed; step s - 1's reads are done
    const int cc = s / 9, tap = s - cc * 9;
    if (s + STAGES - 1 < nsteps) load_slab(s + STAGES - 1);
    if (tap == 0 && c_begin + cc + 1 < c_end) load_halo(c_begin + cc + 1);
    cp_async_commit();
    const uint32_t hrow = halo + (cc & 1) * hbytes;
    const int hp = hp0 + (tap / 3) * HW2 + tap % 3;
    const int nk32 = min(QCH, a.Cin - (c_begin + cc) * QCH) / 32;  // k32 steps inside Cin
    uint32_t af[QCH / 32][4];  // past Cin the halo holds zeros: loaded, not multiplied
#pragma unroll
    for (int kk = 0; kk < QCH / 32; ++kk) ldmatrix_x4(af[kk], hrow + swz(hp, 2 * kk + (lane >> 4)));
    const uint64_t desc = desc0 + (uint64_t)(((s % STAGES) * C::SLAB) >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QCH / 32; ++kk)
      if (kk < nk32) WgmmaS8RS<C::NWG>::mma(acc, af[kk], desc + 2 * kk);
    wgmma_commit();
    wgmma_wait0();
  }
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the staging reuses it

  // Epilogue.  acc[4 ni ..]: the warp's rows g and g + 8, columns
  // ni*8 + 2t, 2t+1 of the warpgroup's (lane = 4g + t).
  const int g = lane >> 2, tq = lane & 3;
  const int n_w = n0 + wg_n;
  auto pixel = [&](int m, long& p) {  // block row m -> output pixel p, false if masked
    if (m >= npix) return false;
    const int gy = ty0 + m / a.TW, gx = tx0 + m % a.TW;
    if (gy >= a.H || gx >= a.W) return false;
    p = img + (long)gy * a.W + gx;
    return true;
  };
  if (a.ksplit > 1) {  // add the partial tile; the last part to take the ticket goes on
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      long p;
      if (!pixel(m_w + g + 8 * h, p)) continue;
      int* row = a.ws + p * a.Cout;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const int n = n_w + ni * 8 + 2 * tq;
        if (n < a.Cout) {
          atomicAdd(row + n, acc[4 * ni + 2 * h]);
          atomicAdd(row + n + 1, acc[4 * ni + 2 * h + 1]);
        }
      }
    }
    __threadfence();
    __syncthreads();
    int& last_s = *reinterpret_cast<int*>(smem + C::RING + 2 * hbytes);
    int* ticket = a.tickets + (long)blockIdx.x * gridDim.y + blockIdx.y;
    if (tid == 0) last_s = atomicAdd(ticket, 1) == a.ksplit - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      long p;
      if (!pixel(m_w + g + 8 * h, p)) continue;
      int* row = a.ws + p * a.Cout;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const int n = n_w + ni * 8 + 2 * tq;
        if (n < a.Cout) {
          int2* q = reinterpret_cast<int2*>(row + n);
          const int2 v = __ldcg(q);
          acc[4 * ni + 2 * h] = v.x, acc[4 * ni + 2 * h + 1] = v.y;
          *q = make_int2(0, 0);
        }
      }
    }
    if (tid == 0) *ticket = 0;
  }
  bf16* stg = reinterpret_cast<bf16*>(smem) + warp * 16 * C::LDS;
#pragma unroll
  for (int ni = 0; ni < C::NI; ++ni) {
    const int n = n_w + ni * 8 + 2 * tq;
    float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (n < a.Cout) {  // Cout % 8 == 0: n and n + 1 together
      s0 = a.os[n], s1 = a.os[n + 1];
      if (a.bias != nullptr) b0 = to_f(a.bias[n]), b1 = to_f(a.bias[n + 1]);
    }
    bf16* o = stg + g * C::LDS + ni * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(o) =
        pack_bf16((float)acc[4 * ni] * s0 + b0, (float)acc[4 * ni + 1] * s1 + b1);
    *reinterpret_cast<uint32_t*>(o + 8 * C::LDS) =
        pack_bf16((float)acc[4 * ni + 2] * s0 + b0, (float)acc[4 * ni + 3] * s1 + b1);
  }
  __syncwarp();
  constexpr int VPR = C::NWG / 8;  // 16-byte vectors a row of the warp's
  for (int i = lane; i < 16 * VPR; i += 32) {
    const int r = i / VPR, v = i - r * VPR;
    const int n = n_w + v * 8;
    long p;
    if (n >= a.Cout || !pixel(m_w + r, p)) continue;
    *reinterpret_cast<uint4*>(a.y + p * a.Cout + n) =
        *reinterpret_cast<const uint4*>(stg + r * C::LDS + v * 8);
  }
}

template <class F>
int qconv_attrs_of(F fn, int smem, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kConvQMaxSmem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, QTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem + (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

}  // namespace
}  // namespace sdtk

// The compiled variants (BM, BN, stages); conv3x3_q_plan (ops/conv.py)
// chooses among them.
#define SDTK_CONV3X3_Q_VARIANTS(X) X(128, 128, 4) X(128, 160, 3) X(128, 64, 6) X(64, 128, 4) X(64, 64, 6)

// Arguments packed as int64 (p[i]): x, xq, w, sx, os, bias, ss, y, ws,
// tickets (pointers), B, H, W, Cin, Cout, TH, TW, (BM, BN, stages) a
// compiled variant, ksplit, parts, stream.  Shape rules (checked by the
// Python wrapper, which also plans): Cin % 32 == 0, Cout % 8 == 0, x, xq
// and w 16-byte aligned, tensors contiguous, TH * TW <= BM, 1 <= ksplit <=
// ceil(Cin / 128), ws (B*H*W, Cout) int32 and tickets (output tiles, column
// blocks) int32, both zero, when ksplit > 1 (the kernel leaves them zero);
// xq a (B, H, W, Cin) int8 scratch; bias and ss may be null.  parts & 1
// launches the codes, parts & 2 the GEMM: 3 runs the conv, 1 or 2 times
// one launch alone.  An unknown variant returns
// cudaErrorInvalidValue.
extern "C" int sdtk_conv3x3_q(const long long* p) {
  using namespace sdtk;
  ConvQArgs a;
  a.x = (const bf16*)p[0];
  a.xq = (int8_t*)p[1];
  a.w = (const int8_t*)p[2];
  a.sx = (const float*)p[3];
  a.os = (const float*)p[4];
  a.bias = (const bf16*)p[5];
  a.ss = (const float*)p[6];
  a.y = (bf16*)p[7];
  a.ws = (int*)p[8];
  a.tickets = (int*)p[9];
  a.B = (int)p[10], a.H = (int)p[11], a.W = (int)p[12], a.Cin = (int)p[13], a.Cout = (int)p[14];
  a.TH = (int)p[15], a.TW = (int)p[16];
  const int bm = (int)p[17], bn = (int)p[18], stages = (int)p[19];
  a.ksplit = (int)p[20];
  const int parts = (int)p[21];
  cudaStream_t st = (cudaStream_t)p[22];
  const int smem = conv_q_smem(stages * bn * QCH, a.TH, a.TW);
  if (a.TH < 1 || a.TW < 1 || a.TH * a.TW > bm || a.Cin % 32 != 0 || a.Cout % 8 != 0 || a.ksplit < 1 ||
      a.ksplit > (a.Cin + QCH - 1) / QCH || smem > kConvQMaxSmem ||
      (a.ksplit > 1 && (a.ws == nullptr || a.tickets == nullptr)) || a.xq == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    const long vecs = (long)a.B * a.H * a.W * (a.Cin / 8);
    conv_q_codes_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!(parts & 2)) return 0;
  const int tiles = a.B * ((a.H + a.TH - 1) / a.TH) * ((a.W + a.TW - 1) / a.TW);
  const dim3 grid((unsigned)tiles, (unsigned)((a.Cout + bn - 1) / bn), (unsigned)a.ksplit);
  err = cudaErrorInvalidValue;
#define SDTK_Q_LAUNCH(bm_, bn_, st_)                                                           \
  if (bm == bm_ && bn == bn_ && stages == st_) {                                               \
    auto fn = conv3x3_q_kernel<bm_, bn_, st_>;                                                 \
    static bool ready = false; /* the shared-memory limit, set once (one card) */             \
    err = ready ? cudaSuccess                                                                  \
                : cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kConvQMaxSmem); \
    ready = err == cudaSuccess;                                                                \
    if (err == cudaSuccess) {                                                                  \
      fn<<<grid, QTHREADS, smem, st>>>(a);                                                     \
      err = cudaGetLastError();                                                                \
    }                                                                                          \
  }
  SDTK_CONV3X3_Q_VARIANTS(SDTK_Q_LAUNCH)
#undef SDTK_Q_LAUNCH
  return (int)err;
}

// A compiled variant launched with `smem` bytes of dynamic shared memory,
// from the runtime: out = {registers a thread, local (spill) bytes a
// thread, shared bytes a block, resident blocks an SM}.
extern "C" int sdtk_conv3x3_q_attrs(int bm, int bn, int stages, int smem, int* out) {
  using namespace sdtk;
#define SDTK_Q_ATTRS(bm_, bn_, st_)                                       \
  if (bm == bm_ && bn == bn_ && stages == st_)                            \
    return qconv_attrs_of(conv3x3_q_kernel<bm_, bn_, st_>, smem, out);
  SDTK_CONV3X3_Q_VARIANTS(SDTK_Q_ATTRS)
#undef SDTK_Q_ATTRS
  return (int)cudaErrorInvalidValue;
}
