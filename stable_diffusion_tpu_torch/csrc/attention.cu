// K3: non-causal attention over (B, S, H, D) bf16 with an optional kv length.
//
// Replaces three TPU kernels of stable_diffusion_tpu/ops/flash_attention.py:
// `_single_pass_kernel` (K/V resident, `_flash_merged_single`),
// `_flash_kernel` (online softmax, `_flash_merged_online`) and
// `_cross_kernel` (77-token cross-attention masked by `kv_len`,
// `_flash_cross_merged`).  One kernel serves self- and cross-attention.
//
// What bounds it on Hopper: the two products Q K^T and P V on the tensor
// cores at S = 4096..64 with head dims 40/80/160 (UNet) and 512 (the VAE's
// single head), plus the exp of every logit.  Reading Q, K and V once is
// small next to that, so the aim is to keep the S x S logits out of device
// memory and the tensor cores busy.
//
// Design: FlashAttention-2.  A block owns 64 query rows of one (batch, head),
// 16 rows per warp, and walks K/V in 64-key tiles staged in shared memory.
// Each warp computes its 16 x 64 logits with `mma.sync` m16n8k16 (bf16 in,
// f32 accumulate) straight into registers, keeps the running row max and
// sum in f32 registers (two rows per lane, reduced over the four lanes that
// share a row), rescales its f32 output accumulator in registers, and feeds
// the probabilities back as the A operand of P V without leaving registers
// (the accumulator layout of two adjacent 8-key tiles is the A-fragment
// layout of one 16-key step); V's B fragments come from shared memory with
// `ldmatrix.trans`.  Keys at or past kv_len get P = 0 and their K/V rows are
// zero-filled, which replaces the TPU kernel's padding of 77 to 128.  Head
// dims are zero-padded to a multiple of 16 (40 -> 48), not to the TPU's 128
// lanes.  The output accumulator holds at most 160 columns per pass; wider
// heads (the VAE's d=512) run four 128-column passes over the keys,
// recomputing the logits.  Softmax statistics stay in f32; scale is d^-0.5.
#include <math.h>

#include "common.cuh"

namespace sdtk {
namespace {

constexpr int BQ = 64;  // query rows per block (4 warps x 16)
constexpr int BKV = 64; // keys per tile
constexpr int THREADS = 128;

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;  // (B, Sq, H, D) contiguous
  long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;  // batch and sequence strides, in elements
  int H, Sq, Sk, D, DQ, passes, kv_len;     // DQ: padded head dim held in shared memory
  float scale_log2;  // d^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed, from shared memory.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int DC>  // output columns per pass, a multiple of 16
__global__ void __launch_bounds__(THREADS) attention_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NT = DC / 8;  // 8-column output tiles per pass
  const int DQ = a.DQ, LD = DQ + 8, D = a.D;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = a.q + b * a.q_sb + (long)h * D;
  const bf16* kb = a.k + b * a.k_sb + (long)h * D;
  const bf16* vb = a.v + b * a.v_sb + (long)h * D;
  const int vpr = DQ / 8;  // 16-byte vectors per padded row

  for (int idx = tid; idx < BQ * vpr; idx += THREADS) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < a.Sq && c < D) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * a.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }

  const bf16* qw = Qs + (warp * 16) * LD;  // this warp's 16 query rows
  const int nkb = (a.kv_len + BKV - 1) / BKV;
  for (int pass = 0; pass < a.passes; ++pass) {
    const int d0 = pass * DC;
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

    for (int kbk = 0; kbk < nkb; ++kbk) {
      const int k0 = kbk * BKV;
      __syncthreads();  // the previous tile (and, first, the Q tile) is done with
      for (int idx = tid; idx < BKV * vpr; idx += THREADS) {
        const int r = idx / vpr, c = (idx - r * vpr) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (k0 + r < a.kv_len && c < D) {
          kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * a.k_ss + c);
          vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * a.v_ss + c);
        }
        *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
        *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv;
      }
      __syncthreads();

      // S = Q K^T: 16 x 64 per warp, eight 8-key tiles.
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int kk = 0; kk < DQ / 16; ++kk) {
        uint32_t qa[4];
        const bf16* qp = qw + g * LD + kk * 16 + 2 * t;
        qa[0] = lds32(qp);
        qa[1] = lds32(qp + 8 * LD);
        qa[2] = lds32(qp + 8);
        qa[3] = lds32(qp + 8 * LD + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* kp = Ks + (8 * j + g) * LD + kk * 16 + 2 * t;
          mma16816(s[j], qa, lds32(kp), lds32(kp + 8));
        }
      }

      // Online softmax in registers; lanes 4g..4g+3 share rows g and g + 8.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = k0 + 8 * j + 2 * t + e < a.kv_len;
          s[j][e] = ok ? s[j][e] * a.scale_log2 : -INFINITY;
          s[j][2 + e] = ok ? s[j][2 + e] * a.scale_log2 : -INFINITY;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o2);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o2);
      }
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);  // 0 on the first tile
      m0 = mn0;
      m1 = mn1;
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }

      // O += P V: P's A fragments are the logits' accumulators, repacked.
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        // lane l addresses key row kk*16 + (l & 15), columns +8 for lanes 16..31
        const bf16* vp = Vs + (kk * 16 + (lane & 15)) * LD + d0 + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t vb4[4];
          ldmatrix_x4_trans(vb4, vp + j * 8);
          mma16816(o[j], pa, vb4[0], vb4[1]);
          mma16816(o[j + 1], pa, vb4[2], vb4[3]);
        }
      }
    }

    // O / l -> bf16 for this pass's columns.
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = d0 + 8 * j + 2 * t;
      if (c >= D) continue;
      if (r0 < a.Sq)
        *reinterpret_cast<uint32_t*>(a.o + (((long)b * a.Sq + r0) * a.H + h) * D + c) =
            pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
      if (r0 + 8 < a.Sq)
        *reinterpret_cast<uint32_t*>(a.o + (((long)b * a.Sq + r0 + 8) * a.H + h) * D + c) =
            pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
}

template <int DC>
int launch(const AttnArgs& a, int B, cudaStream_t st) {
  const int smem = (BQ + 2 * BKV) * (a.DQ + 8) * 2;
  cudaError_t err =
      cudaFuncSetAttribute(attention_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.Sq + BQ - 1) / BQ), (unsigned)(B * a.H));
  attention_kernel<DC><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sdtk

// Shape rules (checked by the Python wrapper): D % 8 == 0, D <= 512, every
// stride a multiple of 8, 16-byte aligned pointers, 0 < kv_len <= Sk.
extern "C" int sdtk_attention(const void* q, const void* k, const void* v, void* o, long q_sb,
                              long q_ss, long k_sb, long k_ss, long v_sb, long v_ss, int B, int H,
                              int Sq, int Sk, int D, int kv_len, float scale, void* stream) {
  using namespace sdtk;
  const int DP = (D + 15) / 16 * 16;
  AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
             static_cast<bf16*>(o),       q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
             H, Sq, Sk, D, DP, 1, kv_len, scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DP) {  // one pass with the output tile as wide as the padded head
    case 16: return launch<16>(a, B, st);
    case 32: return launch<32>(a, B, st);
    case 48: return launch<48>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 80: return launch<80>(a, B, st);
    case 96: return launch<96>(a, B, st);
    case 112: return launch<112>(a, B, st);
    case 128: return launch<128>(a, B, st);
    case 144: return launch<144>(a, B, st);
    case 160: return launch<160>(a, B, st);
    default: break;
  }
  if (D > 512) return (int)cudaErrorInvalidValue;
  a.DQ = (DP + 127) / 128 * 128;  // wider heads: 128-column passes
  a.passes = a.DQ / 128;
  return launch<128>(a, B, st);
}
