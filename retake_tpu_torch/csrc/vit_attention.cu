// K3: Qwen2-VL ViT attention with the 2-D rotary fused in, bf16.
//
// Replaces the TPU kernel retake_tpu/ops/pallas/vit_attention.py
// (vit_attention_qkv / _qkv_kernel). Per temporal slice t and head n: rotary
// on q and k in fp32 (rotate_half), cast to bf16, full bidirectional softmax
// over the S = h*w patches, p normalized and cast to bf16 before p @ v.
// Input: the qkv projection output in HEAD-MAJOR column order
// [T, S, N, 3, D] (the port reorders the projection's weight columns once,
// when the VisionTower is built); output [T, S, N*D].
//
// What bounds it on the H100: per (t, n) the S x S scores (4*S*S*D flops
// plus a recompute pass, S=576, D=80), small next to the ViT's linears; the
// cost to avoid is round trips of the [T, N, S, S] fp32 logits through
// device memory. The design:
//  * one CTA per (t, n, 16*NWARPS query rows), one warp per 16-row q tile;
//    keys and values stream through shared memory in 64-key tiles, so any
//    patch count S works (up to the 5120 patches of the processor's
//    largest frame) with 22 KB of shared memory per CTA;
//  * keys are rotated as they are staged, 8 channels per thread with 16-byte
//    loads (D/2 is a multiple of 8, so a vector never straddles the halves);
//  * D = 80 = 5 x 16: the products tile k by 16 with mma.sync m16n8k16;
//  * rotary in fp32 with explicit round-to-nearest products and sum (no FMA
//    contraction), then one bf16 rounding, as the TPU kernel does;
//  * two passes over the key tiles: row max and sum, then p = exp(s - m) / l
//    rounded to bf16 and multiplied into V, which reproduces the TPU
//    kernel's normalize-then-round order (an online softmax would round p
//    before normalizing).
// Plain twin: retake_tpu_torch/ops/cuda/vit_attention.py vit_attention_qkv_plain.

#include <math.h>

#include "mma.cuh"

namespace {

using retake::group_max;
using retake::group_sum;
using retake::load_pair;
using retake::mma_bf16_16816;
using retake::pack_bf16;
using retake::pack_raw;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;     // keys per tile
constexpr int NWARPS = 8;  // 16-row query tiles per CTA (4, 6, 12 timed slower)
constexpr int VEC = 8;     // bf16 per 16-byte vector

__device__ __forceinline__ float rope_elem(const bf16* x, const float* cos,
                                           const float* sin, int c, int D) {
  const int half = D / 2;
  const float xv = __bfloat162float(x[c]);
  const float partner = c < half ? -__bfloat162float(x[c + half])
                                 : __bfloat162float(x[c - half]);
  return __fadd_rn(__fmul_rn(xv, cos[c]), __fmul_rn(partner, sin[c]));
}

// channels [c, c + 8) of one rotated row, as 8 packed bf16 (c % 8 == 0)
__device__ __forceinline__ uint4 rope_vec(const bf16* x, const float* cos,
                                          const float* sin, int c, int half) {
  const bool lo = c < half;
  const uint4 xv = *reinterpret_cast<const uint4*>(x + c);
  const uint4 pv = *reinterpret_cast<const uint4*>(x + (lo ? c + half : c - half));
  const float4 cv[2] = {*reinterpret_cast<const float4*>(cos + c),
                        *reinterpret_cast<const float4*>(cos + c + 4)};
  const float4 sv[2] = {*reinterpret_cast<const float4*>(sin + c),
                        *reinterpret_cast<const float4*>(sin + c + 4)};
  const bf16* xe = reinterpret_cast<const bf16*>(&xv);
  const bf16* pe = reinterpret_cast<const bf16*>(&pv);
  const float* ce = reinterpret_cast<const float*>(cv);
  const float* se = reinterpret_cast<const float*>(sv);
  uint4 res;
  bf16* re = reinterpret_cast<bf16*>(&res);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float p = lo ? -__bfloat162float(pe[e]) : __bfloat162float(pe[e]);
    re[e] = __float2bfloat16(
        __fadd_rn(__fmul_rn(__bfloat162float(xe[e]), ce[e]), __fmul_rn(p, se[e])));
  }
  return res;
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32) vit_attention_kernel(
    const bf16* __restrict__ qkv,  // [T, S, N, 3, D]
    const float* __restrict__ cos_t,  // [S, D]
    const float* __restrict__ sin_t,
    bf16* __restrict__ out,  // [T, S, N*D]
    int S, int N, float scale_log2) {
  constexpr int KSTEPS = D / 16;
  constexpr int NB_D = D / 8;
  constexpr int NB_K = BK / 8;
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  __shared__ __align__(16) bf16 ks[BK * LD];  // rotated keys of one tile
  __shared__ __align__(16) bf16 vs[BK * LD];

  const int tt = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row_stride = (size_t)N * 3 * D;  // one patch's qkv row
  const bf16* base = qkv + (size_t)tt * S * row_stride + (size_t)n * 3 * D;
  const int q0 = (blockIdx.z * NWARPS + warp) * 16;
  const bool active = q0 < S;  // idle warps still stage tiles
  const int rows[2] = {q0 + g, q0 + g + 8};

  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1];
      const int c = kk * 16 + 2 * t + (r >> 1) * 8;
      uint32_t v = 0u;
      if (row < S) {
        const bf16* x = base + (size_t)row * row_stride;
        const float* cs = cos_t + (size_t)row * D;
        const float* sn = sin_t + (size_t)row * D;
        v = pack_bf16(rope_elem(x, cs, sn, c, D), rope_elem(x, cs, sn, c + 1, D));
      }
      qa[kk][r] = v;
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NB_D][4];
#pragma unroll
  for (int i = 0; i < NB_D; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int kb = 0; kb < S; kb += BK) {
      __syncthreads();  // previous tile fully consumed
      for (int i = threadIdx.x; i < BK * (D / VEC); i += blockDim.x) {
        const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
        const int s = kb + r;
        uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
        if (s < S) {
          const bf16* row = base + (size_t)s * row_stride;
          kv4 = rope_vec(row + D, cos_t + (size_t)s * D, sin_t + (size_t)s * D, c, D / 2);
          if (pass == 1) vv4 = *reinterpret_cast<const uint4*>(row + 2 * D + c);
        }
        *reinterpret_cast<uint4*>(ks + r * LD + c) = kv4;
        if (pass == 1) *reinterpret_cast<uint4*>(vs + r * LD + c) = vv4;
      }
      __syncthreads();
      if (!active) continue;

      float sc[NB_K][4];
#pragma unroll
      for (int nb = 0; nb < NB_K; ++nb) {
        sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
        const bf16* krow = ks + (nb * 8 + g) * LD + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t b[2] = {load_pair(krow + kk * 16), load_pair(krow + kk * 16 + 8)};
          mma_bf16_16816(sc[nb], qa[kk], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kb + nb * 8 + 2 * t + (e & 1);
          sc[nb][e] = j < S ? sc[nb][e] * scale_log2 : -INFINITY;
        }
      }
      if (pass == 0) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nb = 0; nb < NB_K; ++nb) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[nb][0], sc[nb][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[nb][2], sc[nb][3]));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mnew = fmaxf(m[h], group_max(mx[h]));
          float rs = 0.f;
#pragma unroll
          for (int nb = 0; nb < NB_K; ++nb)
            rs += exp2f(sc[nb][2 * h] - mnew) + exp2f(sc[nb][2 * h + 1] - mnew);
          l[h] = l[h] * exp2f(m[h] - mnew) + group_sum(rs);
          m[h] = mnew;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          float p[2][4];
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[half][e] = exp2f(sc[2 * kk + half][e] - m[e >> 1]) / l[e >> 1];
          uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
          const bf16* vcol = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
          for (int nd = 0; nd < NB_D; ++nd) {
            const bf16* v = vcol + nd * 8;
            uint32_t b[2] = {pack_raw(v[0], v[LD]), pack_raw(v[8 * LD], v[9 * LD])};
            mma_bf16_16816(o[nd], a, b);
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= S) continue;
    bf16* orow = out + ((size_t)tt * S + rows[h]) * N * D + (size_t)n * D;
#pragma unroll
    for (int nd = 0; nd < NB_D; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) =
          pack_bf16(o[nd][2 * h], o[nd][2 * h + 1]);
  }
}

}  // namespace

extern "C" int retake_vit_attention_bf16(const void* qkv, const void* cos_t,
                                         const void* sin_t, void* out, int T,
                                         int S, int N, int D, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(T, N, (S + 16 * NWARPS - 1) / (16 * NWARPS));
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
#define RETAKE_K3_ARGS \
  (const bf16*)qkv, (const float*)cos_t, (const float*)sin_t, (bf16*)out, S, N, scale_log2
  switch (D) {
    case 64:
      vit_attention_kernel<64><<<grid, NWARPS * 32, 0, st>>>(RETAKE_K3_ARGS);
      break;
    case 80:
      vit_attention_kernel<80><<<grid, NWARPS * 32, 0, st>>>(RETAKE_K3_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RETAKE_K3_ARGS
  return (int)cudaGetLastError();
}
