// K2: 3x3 SAME stride-1 convolution over NHWC bf16, with an optional
// GroupNorm scale/shift + SiLU prologue applied to its input.
//
// Replaces: stable_diffusion_tpu/ops/conv.py:36 `_conv3x3_kernel` (launched by
// `_conv3x3_call`, reached through `_conv3x3`, `_gn_silu_conv` and
// `_dx_conv`).
//
// What bounds it on Hopper: the tensor-core work.  A resblock conv does
// 2*9*Cin*Cout FLOPs per output pixel against 2*Cin + 2*Cout bytes, far
// above the H100's ~295 FLOP/byte ridge.  So the kernel has to keep the
// tensor cores fed: each input value should cross the memory system and the
// prologue about once, not once per tap, and the copies must not take issue
// slots from the products.
//
// Design: an implicit GEMM (M = output pixels, N = Cout, K = 9 taps x Cin)
// over a halo tile.
// * Tiles.  A block computes a TH x TW rectangle of one image's output
//   pixels (TH*TW <= BM rows, BM = 128 or 64) by BN output channels (128
//   where Cout allows, 160 for Cout = 320 and 960, else 64: a wide product
//   amortizes a step's barrier and A fragments).  `conv3x3_plan` in
//   ops/conv.py picks TH, TW, BM, BN, the ring depth and the K split from
//   the shape and passes them in; small images get a narrower tile, never
//   one that straddles images.  Ragged edges are masked at the store.
// * The halo tile.  For each 64-channel chunk of Cin, the (TH+2) x (TW+2)
//   input pixels around the output rectangle are copied into shared memory
//   with 16-byte cp.async requests; pixels outside the image and channels
//   past Cin use the zero-fill form.  Each pixel's 128 bytes are
//   XOR-swizzled by (pixel & 7) in 16-byte pieces, so eight neighbouring
//   pixels read by one ldmatrix hit eight distinct bank groups.  Two halo
//   buffers: chunk c+1's copy is in flight while chunk c's taps multiply.
// * The prologue once per input value.  When a chunk's halo lands, one pass
//   over it in shared memory replaces every in-image value with
//   silu(x * scale + shift), in f32, rounded to bf16 in place; each thread
//   reads its 8 channels' scale and shift once per chunk.  Out-of-image
//   positions stay 0, so the zero padding comes after the activation, as in
//   the JAX path.  A value is transformed (TH+2)(TW+2)/(TH*TW) ~ 1.4 times
//   (the halo overlap between tiles), where a per-tap gather did it 9 times.
// * The nine taps are addresses.  For tap (ky, kx) each lane hands
//   `ldmatrix.x4` the halo row of its output pixel shifted by (ky, kx): the
//   im2col gather is an address computation, the fragments land in
//   registers in the layout `wgmma` takes for A, and one halo chunk serves
//   9 taps x 4 k16 steps.
// * Weights.  Re-laid once (by the wrapper, cached) as (3, 3, Cout, Cin):
//   each (tap, chunk) slab of BN rows x 64 channels is K-contiguous, copied
//   with cp.async through a STAGES-deep ring (one commit group and one
//   barrier per slab), swizzled as the halo.  That swizzle is Hopper's
//   128-byte one (16-byte piece j of 128-byte row r at j ^ (r & 7), slabs
//   1024-byte aligned), so `wgmma` reads B straight from the slab through a
//   shared-memory descriptor.
// * Products: `wgmma.mma_async` m64nNk16, bf16 in, f32 accumulate, A from
//   registers, B from shared memory.  8 warps = 2 warpgroups: at BM = 128
//   each takes 64 rows x BN, at BM = 64 each the 64 rows x BN / 2.  A step
//   (one tap of one chunk) is four k16 products, committed as one group and
//   waited for before the step's slab may be overwritten; the other
//   warpgroups on the SM keep the tensor cores busy meanwhile.
// * Epilogue: bias added in f32 from registers, the result packed to bf16
//   through a per-warp staging tile (which reuses the ring) into 16-byte
//   stores.  Where the output tiles alone would give the SMs fewer than two
//   blocks each (the UNet's 8^2 to 32^2 stages), the chunks are split over
//   `ksplit` blocks that write f32 partial sums, and conv3x3_reduce adds
//   them in a fixed order with the bias, so the result is deterministic.
// Not yet: TMA for the weight slabs and warp specialisation (every thread
// issues cp.async), and A through a descriptor (the halo gather's rows are
// not one strided layout).  Keeping one step's products in flight across
// the next step's barrier (A double-buffered, the ring refilled a step
// later) measured no faster on the H100 and took 127 registers, so a step
// waits for its own products.
#include "mma.cuh"
#include "wgmma.cuh"

namespace sdtk {
namespace {

constexpr int CH = 64;         // input channels per chunk (one halo tile)
constexpr int ROW = CH * 2;    // bytes of a pixel's chunk, and of a weight row's
constexpr int THREADS = 256;   // 8 warps

struct ConvArgs {
  const bf16* x;     // (B, H, W, Cin)
  const bf16* w;     // (3, 3, Cout, Cin): each tap's (Cout, Cin), K-contiguous
  const bf16* bias;  // (Cout) or null
  const float* ss;   // (B, 2, Cin) GroupNorm scale/shift, or null
  bf16* y;           // (B, H, W, Cout)
  float* ws;         // (ksplit, B*H*W, Cout) f32 partial sums when ksplit > 1
  int B, H, W, Cin, Cout, TH, TW, ksplit;
};

// Byte offset of 16-byte piece j of row r in a tile of 128-byte rows,
// XOR-swizzled by the row.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * ROW + ((j ^ (r & 7)) << 4));
}

// Fast-math SiLU.  For v << 0, __expf(-v) overflows to inf and __fdividef
// gives -0, as silu does.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// A compiled variant: BM x BN block tile, a ring of STAGES weight slabs.
template <int BM, int BN, int STAGES>
struct Cfg {
  static constexpr int NWG = BM == 128 ? BN : BN / 2;  // columns of a warpgroup's product
  static constexpr int NI = NWG / 8;                   // n8 column tiles of a warp's rows
  static constexpr int SLAB = BN * ROW;                // one (tap, chunk) weight slab
  static constexpr int RING = STAGES * SLAB;
  static constexpr int LDS = NWG + 8;                  // epilogue staging row (bf16)
  static_assert(BM == 128 || BM == 64, "a warpgroup product has 64 rows");
  static_assert(SLAB % 1024 == 0 && (BN / 2 * ROW) % 1024 == 0, "128-byte swizzle atoms");
  static_assert(8 * 16 * LDS * 2 <= RING, "the epilogue staging fits in the ring");
};

// Shared memory of a launch: 1024 bytes to align the ring, the weight ring,
// then two halo buffers.
__host__ __device__ inline int halo_bytes(int TH, int TW) { return (TH + 2) * (TW + 2) * ROW; }

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_kernel(ConvArgs a) {
  using C = Cfg<BM, BN, STAGES>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle atoms are absolute
  unsigned char* smem = smem_raw + (ring - raw);
  const int HW2 = a.TW + 2;
  const int hpix = (a.TH + 2) * HW2;
  const int hbytes = halo_bytes(a.TH, a.TW);
  const uint32_t halo = ring + C::RING;  // buffer h at halo + h * hbytes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  // The warpgroup's rows and columns of the block tile; the warp's 16 rows.
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
  const int nchunks = (a.Cin + CH - 1) / CH;
  const int c_begin = blockIdx.z * nchunks / a.ksplit;
  const int c_end = (blockIdx.z + 1) * nchunks / a.ksplit;
  const int nsteps = 9 * (c_end - c_begin);  // one step per (chunk, tap)

  const bf16* xb = a.x + (long)b * a.H * a.W * a.Cin;
  const int j8 = tid & 7;  // every copy and the prologue: this thread's 16-byte piece

  // Chunk c's halo into buffer (c - c_begin) & 1.
  auto load_halo = [&](int c) {
    const uint32_t dst = halo + ((c - c_begin) & 1) * hbytes;
    const int ch = c * CH + j8 * 8;
    for (int p = tid >> 3; p < hpix; p += THREADS / 8) {
      const int hy = p / HW2, hx = p - hy * HW2;
      const int gy = ty0 + hy - 1, gx = tx0 + hx - 1;
      const bool ok = ch < a.Cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      cp_async16(dst + swz(p, j8), ok ? xb + ((long)gy * a.W + gx) * a.Cin + ch : a.x, ok);
    }
  };
  // Step s's weight slab (chunk c_begin + s / 9, tap s % 9) into ring stage s % STAGES.
  auto load_slab = [&](int s) {
    const int c = c_begin + s / 9, tap = s % 9;
    const uint32_t dst = ring + (s % STAGES) * C::SLAB;
    const int ch = c * CH + j8 * 8;
#pragma unroll
    for (int i = 0; i < BN * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8), n = n0 + r;
      const bool ok = ch < a.Cin && n < a.Cout;
      cp_async16(dst + swz(r, j8), ok ? a.w + ((long)tap * a.Cout + n) * a.Cin + ch : a.w, ok);
    }
  };
  // The GroupNorm+SiLU prologue over chunk c's landed halo, in place.
  auto activate = [&](int c) {
    unsigned char* buf = smem + C::RING + ((c - c_begin) & 1) * hbytes;
    const int ch = c * CH + j8 * 8;
    if (ch >= a.Cin) return;  // zero-filled channels stay 0
    // 32-byte aligned: Cin % 8 == 0 and ch % 8 == 0
    const float4* sc = reinterpret_cast<const float4*>(a.ss + (long)b * 2 * a.Cin + ch);
    const float4* sh = reinterpret_cast<const float4*>(a.ss + (long)b * 2 * a.Cin + a.Cin + ch);
    const float4 s0 = sc[0], s1 = sc[1], h0 = sh[0], h1 = sh[1];
    const float scale[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float shift[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    for (int p = tid >> 3; p < hpix; p += THREADS / 8) {
      const int hy = p / HW2, hx = p - hy * HW2;
      const int gy = ty0 + hy - 1, gx = tx0 + hx - 1;
      if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) continue;  // the zero halo stays 0
      Pack8* v = reinterpret_cast<Pack8*>(buf + swz(p, j8));
      Pack8 u = *v;
#pragma unroll
      for (int k = 0; k < 8; ++k) u.h[k] = to_bf(silu(to_f(u.h[k]) * scale[k] + shift[k]));
      *v = u;
    }
  };

  // Each lane's A row: output row m = m_w + (lane & 15) sits at halo pixel
  // hp0 + (ky * HW2 + kx) for tap (ky, kx).  Rows past the rectangle read
  // pixel 0 and are never stored.
  const int m_a = m_w + (lane & 15);
  const int hp0 = m_a < npix ? (m_a / a.TW) * HW2 + m_a % a.TW : 0;
  const uint64_t desc0 = sw128_desc(ring + wg_n * ROW);

  float acc[C::NWG / 2];
#pragma unroll
  for (int k = 0; k < C::NWG / 2; ++k) acc[k] = 0.f;

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
    if (tap == 0 && a.ss != nullptr) {
      activate(c_begin + cc);
      __syncthreads();
    }
    const uint32_t hrow = halo + (cc & 1) * hbytes;
    const int hp = hp0 + (tap / 3) * HW2 + tap % 3;
    uint32_t af[CH / 16][4];
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) ldmatrix_x4(af[kk], hrow + swz(hp, 2 * kk + (lane >> 4)));
    const uint64_t desc = desc0 + (uint64_t)(((s % STAGES) * C::SLAB) >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) Wgmma<C::NWG>::mma(acc, af[kk], desc + 2 * kk);
    wgmma_commit();
    wgmma_wait0();
  }
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
    p = ((long)b * a.H + gy) * a.W + gx;
    return true;
  };
  if (a.ksplit > 1) {  // f32 partial sums; conv3x3_reduce adds the splits and the bias
    const long M = (long)a.B * a.H * a.W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      long p;
      if (!pixel(m_w + g + 8 * h, p)) continue;
      float* row = a.ws + ((long)blockIdx.z * M + p) * a.Cout;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const int n = n_w + ni * 8 + 2 * tq;
        if (n < a.Cout)
          *reinterpret_cast<float2*>(row + n) = make_float2(acc[4 * ni + 2 * h], acc[4 * ni + 2 * h + 1]);
      }
    }
    return;
  }
  bf16* stg = reinterpret_cast<bf16*>(smem) + warp * 16 * C::LDS;
#pragma unroll
  for (int ni = 0; ni < C::NI; ++ni) {
    const int n = n_w + ni * 8 + 2 * tq;
    float b0 = 0.f, b1 = 0.f;
    if (a.bias != nullptr && n < a.Cout) b0 = to_f(a.bias[n]), b1 = to_f(a.bias[n + 1]);
    bf16* o = stg + g * C::LDS + ni * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[4 * ni] + b0, acc[4 * ni + 1] + b1);
    *reinterpret_cast<uint32_t*>(o + 8 * C::LDS) = pack_bf16(acc[4 * ni + 2] + b0, acc[4 * ni + 3] + b1);
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

// y = sum over splits of ws (in split order) + bias, cast to bf16.
__global__ void conv3x3_reduce(const float* ws, const bf16* bias, bf16* y, long M, int Cout,
                               int ksplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * Cout) return;
  float s = bias != nullptr ? to_f(bias[i % Cout]) : 0.f;
  for (int z = 0; z < ksplit; ++z) s += ws[z * M * Cout + i];
  y[i] = to_bf(s);
}

template <int BM, int BN, int STAGES>
cudaError_t launch(const ConvArgs& a, cudaStream_t st) {
  const int smem = 1024 + Cfg<BM, BN, STAGES>::RING + 2 * halo_bytes(a.TH, a.TW);
  auto fn = conv3x3_kernel<BM, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = a.B * ((a.H + a.TH - 1) / a.TH) * ((a.W + a.TW - 1) / a.TW);
  dim3 grid((unsigned)tiles, (unsigned)((a.Cout + BN - 1) / BN), (unsigned)a.ksplit);
  fn<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM, int BN, int STAGES>
int attrs(int smem, int* out) {
  auto fn = conv3x3_kernel<BM, BN, STAGES>;
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem + (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

}  // namespace
}  // namespace sdtk

// The compiled variants (BM, BN, stages); conv3x3_plan (ops/conv.py)
// chooses among them.
#define SDTK_CONV3X3_VARIANTS(X) \
  X(128, 128, 4)                 \
  X(128, 160, 3)                 \
  X(128, 64, 6)                  \
  X(64, 128, 4)                  \
  X(64, 64, 6)

// Shape rules (checked by the Python wrapper): Cin % 8 == 0, Cout % 8 == 0,
// x and w 16-byte aligned, tensors contiguous, TH * TW <= BM, 1 <= ksplit
// <= ceil(Cin / 64), ws (ksplit, B*H*W, Cout) f32 when ksplit > 1 (else
// null); bias and ss may be null.  An unknown (BM, BN, stages) returns
// cudaErrorInvalidValue.
extern "C" int sdtk_conv3x3(const void* x, const void* w, const void* bias, const void* ss,
                            void* y, void* ws, int B, int H, int W, int Cin, int Cout, int TH,
                            int TW, int BM, int BN, int stages, int ksplit, void* stream) {
  using namespace sdtk;
  if (TH < 1 || TW < 1 || TH * TW > BM || ksplit < 1 || ksplit > (Cin + CH - 1) / CH ||
      (ksplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{static_cast<const bf16*>(x),    static_cast<const bf16*>(w),
             static_cast<const bf16*>(bias), static_cast<const float*>(ss),
             static_cast<bf16*>(y),          static_cast<float*>(ws),
             B, H, W, Cin, Cout, TH, TW, ksplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SDTK_LAUNCH(bm, bn, stg) \
  if (BM == bm && BN == bn && stages == stg) err = launch<bm, bn, stg>(a, st);
  SDTK_CONV3X3_VARIANTS(SDTK_LAUNCH)
#undef SDTK_LAUNCH
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const long M = (long)B * H * W, n = M * Cout;
  conv3x3_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(bias), static_cast<bf16*>(y), M,
      Cout, ksplit);
  return (int)cudaGetLastError();
}

// The compiled variant (BM, BN, stages) launched with `smem` bytes of
// dynamic shared memory (1024 of them for the ring's alignment), from the runtime: out = {registers a thread, local
// (spill) bytes a thread, shared bytes a block, resident blocks an SM}.
extern "C" int sdtk_conv3x3_attrs(int BM, int BN, int stages, int smem, int* out) {
  using namespace sdtk;
#define SDTK_ATTRS(bm, bn, stg) \
  if (BM == bm && BN == bn && stages == stg) return attrs<bm, bn, stg>(smem, out);
  SDTK_CONV3X3_VARIANTS(SDTK_ATTRS)
#undef SDTK_ATTRS
  return (int)cudaErrorInvalidValue;
}
