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
// bytes: above the ridge (~295 flop/byte) at the UNet's and the VAE's
// shapes, so the tensor cores bound it, as they bound K2.  What a design
// must not do is re-read: U is 16/9 the direct weight, and its 16 products
// a tile take only Cin deep, so U is read from L2 once for every block of
// tiles and the input once for every block of output channels.
//
// Design (the first design, 32 tiles x 64 channels a block walking Cin 16
// at a time through one stage, re-read U ~50 times and activated each input
// value ~20 times at the UNet's widths; PERF.md keeps its readings):
// * A block owns a region of 64 tiles (4 x 16 or 8 x 8 tiles of one
//   image, winograd_plan's choice for the least padding) and 64 output
//   channels, two warpgroups.  Cin is walked 64 channels (one 128-byte
//   row) a chunk.
// * The chunk's input halo, (2 th + 2) x (2 tw + 2) pixels, comes in by
//   cp.async (zero outside the image), two halo buffers so the next chunk's
//   lands while this one is used; the GN+SiLU prologue runs on it in place,
//   once per input value, rounded to bf16, the out-of-image halo left zero
//   (after the activation, as in K2).
// * Each chunk is four steps, one a column k2 of V: every thread builds
//   V[k1][k2] (k1 = 0..3) for its (tile, channel quad)s in f32 as B^T (d
//   B[:, k2]), exact from bf16 inputs, rounded to bf16 once into shared
//   memory in the 128-byte swizzle, where `ldmatrix` takes wgmma's A
//   fragments.  U's slab for the step (its 4 positions x 64 channels x 64
//   inputs, (16, Cout, Cin) bf16 as cached by the wrapper) comes through a
//   three-slab cp.async ring, wgmma's B by descriptor; one step's last
//   products stay in flight while the next step's V is built.
// * F-fold: the accumulators are F[o1][k2] = sum_k1 A^T[o1][k1] M[k1][k2].
//   Warpgroup o1 holds its four sets F[o1][0..3], 64 tiles x 64 channels
//   each (128 registers a thread), and takes the three positions k1 = o1 +
//   i its row of A^T feeds; A^T's signs go into A: the negated fragments of
//   V[2][k2] and V[3][k2] are the same registers with the bf16 sign bits
//   flipped, so each position's product accumulates straight into its F
//   set: 3 m64n64k16 products a warpgroup, k2 and 16-deep step (24 n64
//   products a chunk step for the block against 16 products and 20 set
//   adds on CUDA cores before, still 1.5x fewer than a direct conv's 36).
//   The first build of this design split the 64 channels between the
//   warpgroups instead, each holding all eight sets at 32 channels (six
//   m64n32k16 products a step): 19-21% slower at every switched shape on
//   an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --k12-sweep, the two
//   in one call).  Keeping four A fragment sets in flight spilled (255
//   registers) and was no faster.  Y-direct (four Y sets and a temporary,
//   36 set adds a chunk) was not built.
// * Epilogue: Y[o1][0] = F[o1][0] + F[o1][1] + F[o1][2], Y[o1][1] = F[o1][1]
//   - F[o1][2] - F[o1][3], + bias in f32: warpgroup o1 stores row o1 of each
//   2 x 2 tile, bf16 pairs straight into NHWC.
// winograd_plan (ops/winograd.py) mirrors the dispatch: the region, the
// channel blocks and the shared bytes.  The V and U roundings to bf16 after
// transforms that grow magnitudes make its error larger than K2's, by
// design.  A block's time at (2, 96, 96, 320 -> 320) on that card (a
// globaltimer trace): the prologue ~24% (done again by each of the Cout /
// 64 channel blocks), the V build ~23%, the products ~21%.  Not yet: a
// producer warpgroup for the prologue and V while the consumers multiply,
// TMA.
#include <string.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace sdtk {
namespace {

constexpr int WKC = 64;                      // input channels a chunk (one 128-byte row)
constexpr int WBN = 64;                      // output channels a block
constexpr int WT = 64;                       // tiles a block
constexpr int WTHREADS = 256;
constexpr int WSTAGES = 3;                   // U slabs in the ring
constexpr int WHALO = 340;                   // halo pixels at most: (2 th + 2)(2 tw + 2)
constexpr int U_SLAB = 4 * WBN * 128;        // a step's U: 4 positions x 64 channels x 128 bytes
constexpr int V_POS = WT * 128;              // one position's V: 64 tiles x 128 bytes
constexpr int HALO_BYTES = WHALO * 128;
// Shared bytes: 1024 to align, the U ring, V (one column of 4 positions),
// two halo buffers, two chunks' scale and shift (64 + 64 f32 each).
constexpr int WSMEM = 1024 + WSTAGES * U_SLAB + 4 * V_POS + 2 * HALO_BYTES + 2 * 2 * WKC * 4;
constexpr int kWMaxSmem = 232448;
static_assert(WSMEM <= kWMaxSmem, "within a block's shared memory");

// Byte offset of 16-byte piece j of 128-byte row r, XOR-swizzled by the row.
__device__ __forceinline__ uint32_t wswz(int r, int j) { return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4)); }

// As K2's: for v << 0, __expf(-v) overflows to inf and __fdividef gives -0.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

struct WinoArgs {
  const bf16* x;      // (B, H, W, Cin)
  const bf16* u;      // (16, Cout, Cin)
  const bf16* bias;   // (Cout) or null
  const float* ss;    // (B, 2, Cin) or null
  bf16* y;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, th, tw;
};

__global__ void __launch_bounds__(WTHREADS, 1) winograd_kernel(WinoArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t vbase = ring + WSTAGES * U_SLAB;
  const uint32_t hbase = vbase + 4 * V_POS;
  const uint32_t sbase = hbase + 2 * HALO_BYTES;
  unsigned char* smem = smem_raw + (ring - raw);
  unsigned char* vs = smem + WSTAGES * U_SLAB;
  unsigned char* hs = vs + 4 * V_POS;
  const float* ssv = reinterpret_cast<const float*>(hs + 2 * HALO_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int TH = a.H / 2, TW = a.W / 2, th = a.th, tw = a.tw;
  const int ry = (TH + th - 1) / th, rx = (TW + tw - 1) / tw;
  const int b = blockIdx.x / (ry * rx), rrem = blockIdx.x - b * ry * rx;
  const int ty0 = (rrem / rx) * th, tx0 = (rrem % rx) * tw;
  const int HW = 2 * tw + 2, npix = (2 * th + 2) * HW;
  const int hy0 = 2 * ty0 - 1, hx0 = 2 * tx0 - 1;  // the halo's first input pixel
  const int n0 = blockIdx.y * WBN;
  const int nchunks = (a.Cin + WKC - 1) / WKC, nsteps = 4 * nchunks;
  const bool pro = a.ss != nullptr;

  // Chunk c's halo (and its scale and shift) into halo buffer c & 1.
  auto load_halo = [&](int c) {
    const uint32_t dst = hbase + (c & 1) * HALO_BYTES;
    for (int p = tid; p < npix * 8; p += WTHREADS) {
      const int pix = p >> 3, j = p & 7, hy = pix / HW, hx = pix - hy * HW;
      const int iy = hy0 + hy, ix = hx0 + hx, ch = c * WKC + j * 8;
      const bool ok = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W && ch < a.Cin;
      cp_async16(dst + wswz(pix, j), ok ? a.x + (((long)b * a.H + iy) * a.W + ix) * a.Cin + ch : a.x,
                 ok);
    }
    if (pro && tid < 2 * WKC / 4) {  // 16 copies of 4 scales, then 16 of 4 shifts
      const int half = tid >> 4, ch = c * WKC + (tid & 15) * 4;
      const bool ok = ch < a.Cin;
      cp_async16(sbase + (c & 1) * 2 * WKC * 4 + half * WKC * 4 + (tid & 15) * 16,
                 ok ? a.ss + ((long)b * 2 + half) * a.Cin + ch : a.ss, ok);
    }
  };
  // Step s's U slab (chunk s / 4, column k2 = s % 4): row k1 * 64 + n is
  // U[(k1 * 4 + k2), n0 + n, chunk's 64 inputs], zero past Cout and Cin.
  auto load_u = [&](int s) {
    const int c = s >> 2, k2 = s & 3, j = tid & 7;
    const uint32_t dst = ring + (s % WSTAGES) * U_SLAB;
#pragma unroll
    for (int i = 0; i < 4 * WBN * 8 / WTHREADS; ++i) {
      const int r = (tid >> 3) + i * (WTHREADS / 8), k1 = r >> 6, n = r & 63;
      const int ch = c * WKC + j * 8;
      const bool ok = n0 + n < a.Cout && ch < a.Cin;
      cp_async16(dst + wswz(r, j),
                 ok ? a.u + ((long)(k1 * 4 + k2) * a.Cout + n0 + n) * a.Cin + ch : a.u, ok);
    }
  };

  // Warpgroup o1 folds F[o1][k2] = sum_k1 A^T[o1][k1] M[k1][k2] for the
  // block's 64 tiles x 64 channels: o1 = 0 takes k1 = 0, 1, 2 (+, +, +),
  // o1 = 1 takes k1 = 1, 2, 3 (+, -, -), so its positions are k1 = wg + i.
  float F[4][32];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 32; ++e) F[k][e] = 0.f;
  uint32_t af[2][3][4];  // A fragments of V[wg + i], two sets
  const int m_a = (warp & 3) * 16 + (lane & 15);

  load_halo(0);
  load_u(0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      const int s = 4 * c + k2;
      cp_async_wait<0>();
      fence_async_shared();  // the landed U slab, for wgmma
      __syncthreads();       // slab s and (k2 = 0) chunk c's halo are in; V is free
      if (s + 1 < nsteps) load_u(s + 1);
      if (k2 == 0 && c + 1 < nchunks) load_halo(c + 1);
      cp_async_commit();
      unsigned char* halo = hs + (c & 1) * HALO_BYTES;
      if (k2 == 0 && pro) {  // the prologue, in place, once per input value
        const float* sc = ssv + (c & 1) * 2 * WKC;
        for (int p = tid; p < npix * 8; p += WTHREADS) {
          const int pix = p >> 3, j = p & 7, hy = pix / HW, hx = pix - hy * HW;
          const int iy = hy0 + hy, ix = hx0 + hx;
          if (iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) continue;  // the zero halo stays zero
          Pack8* q = reinterpret_cast<Pack8*>(halo + wswz(pix, j));
          Pack8 v = *q;
          const float4* s4 = reinterpret_cast<const float4*>(sc + j * 8);
          const float4* h4 = reinterpret_cast<const float4*>(sc + WKC + j * 8);
          const float4 sa = s4[0], sb = s4[1], ha = h4[0], hb = h4[1];
          const float scl[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
          const float shf[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)  // scale and shift are zero past Cin: silu(0) = 0
            v.h[e] = to_bf(silu(to_f(v.h[e]) * scl[e] + shf[e]));
          *q = v;
        }
        __syncthreads();
      }
      // V[k1][k2] for (tile, channel quad)s: w = d B[:, k2] per patch row,
      // then V[k1] = (B^T w)[k1]; rows of 64 channels in the 128-byte swizzle.
      constexpr int JA[4] = {0, 1, 2, 1}, JB[4] = {2, 2, 1, 3};  // w[i] = d[i][JA] +- d[i][JB]
#pragma unroll
      for (int it = 0; it < WT * 16 / WTHREADS; ++it) {
        const int item = tid + it * WTHREADS, t = item >> 4, cq = item & 15;
        const int tyl = t / tw, txl = t - tyl * tw;
        const int pix0 = 2 * tyl * HW + 2 * txl, off = (cq & 1) * 8;
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 ra = *reinterpret_cast<const uint2*>(halo + wswz(pix0 + i * HW + JA[k2], cq >> 1) + off);
          const uint2 rb = *reinterpret_cast<const uint2*>(halo + wswz(pix0 + i * HW + JB[k2], cq >> 1) + off);
          const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ra.x));
          const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ra.y));
          const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rb.x));
          const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rb.y));
          const float da[4] = {a0.x, a0.y, a1.x, a1.y}, db[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
          for (int e = 0; e < 4; ++e)  // k2 = 2: d2 - d1 (JA = 2, JB = 1)
            w[i][e] = k2 == 1 ? da[e] + db[e] : da[e] - db[e];
        }
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = k1 == 0 ? w[0][e] - w[2][e] : k1 == 1 ? w[1][e] + w[2][e]
                 : k1 == 2 ? w[2][e] - w[1][e] : w[1][e] - w[3][e];
          *reinterpret_cast<uint2*>(vs + k1 * V_POS + wswz(t, cq >> 1) + off) =
              make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
        }
      }
      __syncthreads();  // V's column is built
      // The step's products: per 16-deep step, F[wg][k2] += sum_i
      // sign(wg, i) V[wg + i] U[wg + i] (U's rows k1 * 64 + the 64 channels),
      // A^T's signs flipped into the A fragments' bf16 sign bits.
      const uint64_t bd = sw128_desc(ring + (s % WSTAGES) * U_SLAB);
      const uint64_t step = (uint64_t)((WBN * 128) >> 4);  // one k1's rows
#pragma unroll
      for (int kk = 0; kk < WKC / 16; ++kk) {
        const int st = kk & 1;
        wgmma_wait<1>();  // the products that read set st (two steps of kk ago) are done
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldmatrix_x4(af[st][i], vbase + (wg + i) * V_POS + wswz(m_a, 2 * kk + (lane >> 4)));
        if (wg == 1)
#pragma unroll
          for (int i = 1; i < 3; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) af[st][i][e] ^= 0x80008000u;
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < 3; ++i) Wgmma<64>::mma(F[k2], af[st][i], bd + 2 * kk + (wg + i) * step);
        wgmma_commit();
      }
    }
  }
  wgmma_wait0();
#pragma unroll
  for (int k = 0; k < 4; ++k) fence_operands(F[k]);
  cp_async_wait<0>();

  // Epilogue: Y = F A + bias, straight to NHWC; warpgroup o1 stores row o1
  // of each 2 x 2 tile.  F[k2][4 ni + 2 hh + e]: tile (warp & 3) * 16 + g +
  // 8 hh, channel n0 + 8 ni + 2 tq + e.
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < WBN / 8; ++ni) {
    const int col = n0 + ni * 8 + 2 * tq;
    if (col >= a.Cout) continue;  // Cout % 8 == 0: col and col + 1 together
    const float b0 = a.bias != nullptr ? to_f(a.bias[col]) : 0.f;
    const float b1 = a.bias != nullptr ? to_f(a.bias[col + 1]) : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = (warp & 3) * 16 + g + 8 * hh, ty = ty0 + t / tw, tx = tx0 + t % tw;
      if (ty >= TH || tx >= TW) continue;
      const int e0 = 4 * ni + 2 * hh, e1 = e0 + 1;
      const float y00 = F[0][e0] + F[1][e0] + F[2][e0] + b0, y01 = F[0][e1] + F[1][e1] + F[2][e1] + b1;
      const float y10 = F[1][e0] - F[2][e0] - F[3][e0] + b0, y11 = F[1][e1] - F[2][e1] - F[3][e1] + b1;
      bf16* out = a.y + (((long)b * a.H + 2 * ty + wg) * a.W + 2 * tx) * a.Cout + col;
      *reinterpret_cast<uint32_t*>(out) = pack_bf16(y00, y01);
      *reinterpret_cast<uint32_t*>(out + a.Cout) = pack_bf16(y10, y11);
    }
  }
}

}  // namespace
}  // namespace sdtk

// Arguments packed as int64 (a[i]): x, u, bias, ss, y (pointers), B, H, W,
// Cin, Cout, th, tw (the region of tiles a block: 8 x 8 or 4 x 16),
// stream.  Shape rules (checked by the Python wrapper, which also
// plans): H and W even, Cin % 8 == 0, Cout % 8 == 0, every tensor
// contiguous and 16-byte aligned; bias and ss may be null.
extern "C" int sdtk_winograd(const long long* p) {
  using namespace sdtk;
  WinoArgs a{(const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2], (const float*)p[3], (bf16*)p[4],
             (int)p[5], (int)p[6], (int)p[7], (int)p[8], (int)p[9], (int)p[10], (int)p[11]};
  cudaStream_t st = (cudaStream_t)p[12];
  if (a.B < 1 || a.H % 2 || a.W % 2 || a.Cin % 8 || a.Cout % 8 || a.th * a.tw != WT ||
      (a.th != 8 && a.th != 4))
    return (int)cudaErrorInvalidValue;
  static bool ready = false;  // the shared-memory limit, set once (one card)
  cudaError_t err = ready ? cudaSuccess
                          : cudaFuncSetAttribute(winograd_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  ready = err == cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  const int ry = (a.H / 2 + a.th - 1) / a.th, rx = (a.W / 2 + a.tw - 1) / a.tw;
  const dim3 grid((unsigned)(a.B * ry * rx), (unsigned)((a.Cout + WBN - 1) / WBN));
  winograd_kernel<<<grid, WTHREADS, WSMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// The kernel from the runtime: out = {registers a thread, local (spill)
// bytes a thread, shared bytes a block, resident blocks an SM}.
extern "C" int sdtk_winograd_attrs(int* out) {
  using namespace sdtk;
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(winograd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, winograd_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, winograd_kernel, WTHREADS, WSMEM);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = WSMEM + (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}
