// K1: chunked-prefill flash attention over [static KV cache | chunk], with a
// bf16 mode and an int8-KV mode.
//
// Replaces the TPU kernel retake_tpu/ops/pallas/flash_prefill.py
// (flash_prefill_attention / _kernel): one prefill chunk's queries attend to
// the cached prefix (column live iff col < cache_len) and causally to the
// chunk's own keys (live iff j <= i and (j < valid_len or j == i)). Online
// softmax in fp32 on bf16 inputs; out = acc / max(l, 1e-37).
//
// int8-KV mode (the TPU kernel's quantized mode, flash_prefill.py:137-143):
// cache and chunk K/V are int8 with one fp32 scale per key row. A tile
// comes in as int8 (half the bytes of bf16) and every element is
// dequantized while it is staged in shared memory, bf16(f32(x) * s) with
// one rounding (no FMA), which are the TPU kernel's numerics (it
// dequantizes before the dot, it does not commute the scales). From there
// the bf16 tensor-core path is the same as in the bf16 mode.
//
// What bounds it on the H100: tensor-core work, 4*S*cache_len*D*H flops per
// layer per chunk (about 0.3 TFLOP at S=2304, cache 20000, 12 heads), with
// the K/V bytes re-read by every query tile. The design:
//  * one CTA per (16-token query tile, KV head); its G warps are the G query
//    heads of that KV head and share every K/V tile staged in shared memory,
//    so each K/V byte is loaded once per 16*G query rows;
//  * the cache and the chunk come in through two base pointers: no
//    [cache | chunk] concatenation (a whole-cache copy per layer per chunk);
//  * cache_len and valid_len are read from device memory: no host sync, and
//    the step stays capturable in a CUDA graph;
//  * tiles past cache_len and chunk tiles above the diagonal are never
//    loaded or computed, so work follows the fill level, not the budget;
//  * mma.sync m16n8k16 with fp32 accumulators; the running max, sum and
//    output stay in registers (flash-attention 2 layout).
// Plain twin (both modes): retake_tpu_torch/ops/cuda/flash_prefill.py
// flash_prefill_attention_plain.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

using retake::group_max;
using retake::group_sum;
using retake::load_pair;
using retake::mma_bf16_16816;
using retake::pack_bf16;
using retake::pack_raw;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;  // keys per tile

// byte k (0..3) of a word as a signed int8, as float
__device__ __forceinline__ float i8_at(uint32_t word, int k) {
  return (float)((int32_t)(word << (24 - 8 * k)) >> 24);
}

// 8 int8 values -> 8 bf16 of f32(x) * s, each rounded once
__device__ __forceinline__ uint4 dequant8(uint2 raw, float s) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? raw.x : raw.y;
    const int k = (i & 1) * 2;
    w[i] = pack_bf16(__fmul_rn(i8_at(word, k), s), __fmul_rn(i8_at(word, k + 1), s));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int D, bool INT8>
__global__ void flash_prefill_kernel(
    const bf16* __restrict__ q,  // [H, S, D]
    const std::conditional_t<INT8, int8_t, bf16>* __restrict__ kc,  // [KV, budget, D]
    const std::conditional_t<INT8, int8_t, bf16>* __restrict__ vc,
    const std::conditional_t<INT8, int8_t, bf16>* __restrict__ kn,  // [KV, S, D]
    const std::conditional_t<INT8, int8_t, bf16>* __restrict__ vn,
    const float* __restrict__ kcs,  // int8: [KV, budget] per-key scales
    const float* __restrict__ vcs,
    const float* __restrict__ kns,  // int8: [KV, S]
    const float* __restrict__ vns,
    const int* __restrict__ cache_len_p, const int* __restrict__ valid_len_p,
    bf16* __restrict__ out,  // [H, S, D]
    int group, int S, int budget, float scale_log2) {
  typedef std::conditional_t<INT8, int8_t, bf16> KT;
  constexpr int KSTEPS = D / 16;
  constexpr int NB_D = D / 8;
  constexpr int NB_K = BK / 8;
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  constexpr int VEC = 8;     // bf16 per 16-byte vector
  __shared__ __align__(16) bf16 ks[BK * LD];
  __shared__ __align__(16) bf16 vs[BK * LD];

  const int kvh = blockIdx.y;
  const int q0 = blockIdx.x * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int head = kvh * group + warp;
  const int cache_len = min(*cache_len_p, budget);
  const int valid_len = *valid_len_p;
  const int rows[2] = {q0 + g, q0 + g + 8};

  uint32_t qa[KSTEPS][4];
  const bf16* qh = q + (size_t)head * S * D;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = rows[0] < S ? load_pair(qh + (size_t)rows[0] * D + c) : 0u;
    qa[kk][1] = rows[1] < S ? load_pair(qh + (size_t)rows[1] * D + c) : 0u;
    qa[kk][2] = rows[0] < S ? load_pair(qh + (size_t)rows[0] * D + c + 8) : 0u;
    qa[kk][3] = rows[1] < S ? load_pair(qh + (size_t)rows[1] * D + c + 8) : 0u;
  }

  float o[NB_D][4];
#pragma unroll
  for (int i = 0; i < NB_D; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const KT* kc_h = kc + (size_t)kvh * budget * D;
  const KT* vc_h = vc + (size_t)kvh * budget * D;
  const KT* kn_h = kn + (size_t)kvh * S * D;
  const KT* vn_h = vn + (size_t)kvh * S * D;
  const int n_cache_tiles = (cache_len + BK - 1) / BK;
  const int last_row = min(q0 + 15, S - 1);
  const int n_chunk_tiles = last_row / BK + 1;  // tiles above the diagonal skipped

  for (int it = 0; it < n_cache_tiles + n_chunk_tiles; ++it) {
    const bool in_cache = it < n_cache_tiles;
    const int base = in_cache ? it * BK : (it - n_cache_tiles) * BK;
    const KT* ksrc = in_cache ? kc_h : kn_h;
    const KT* vsrc = in_cache ? vc_h : vn_h;
    const int limit = in_cache ? cache_len : S;

    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < BK * (D / VEC); i += blockDim.x) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (base + r < limit) {
        const size_t off = (size_t)(base + r) * D + c;
        if constexpr (INT8) {  // 8 bytes in, 8 dequantized bf16 out
          const size_t srow = in_cache ? (size_t)kvh * budget : (size_t)kvh * S;
          const float ks_r = (in_cache ? kcs : kns)[srow + base + r];
          const float vs_r = (in_cache ? vcs : vns)[srow + base + r];
          kv4 = dequant8(*reinterpret_cast<const uint2*>(ksrc + off), ks_r);
          vv4 = dequant8(*reinterpret_cast<const uint2*>(vsrc + off), vs_r);
        } else {
          kv4 = *reinterpret_cast<const uint4*>(ksrc + off);
          vv4 = *reinterpret_cast<const uint4*>(vsrc + off);
        }
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kv4;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vv4;
    }
    __syncthreads();

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
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB_K; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int j = base + nb * 8 + 2 * t + (e & 1);
        const bool live = in_cache
                              ? (j < cache_len)
                              : (j < S && j <= row && (j < valid_len || j == row));
        const float s2 = live ? sc[nb][e] * scale_log2 : -INFINITY;
        sc[nb][e] = s2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s2);
      }
    }
    float alpha[2], mnew[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mnew[h] = fmaxf(m[h], group_max(mx[h]));
      alpha[h] = mnew[h] == -INFINITY ? 1.f : exp2f(m[h] - mnew[h]);
    }
#pragma unroll
    for (int nb = 0; nb < NB_K; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = mnew[h] == -INFINITY ? 0.f : exp2f(sc[nb][e] - mnew[h]);
        sc[nb][e] = p;
        rs[h] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + group_sum(rs[h]);
      m[h] = mnew[h];
    }
#pragma unroll
    for (int nd = 0; nd < NB_D; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // P (bf16) @ V: two adjacent score blocks form one A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                       pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                       pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                       pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const bf16* vcol = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < NB_D; ++nd) {
        const bf16* v = vcol + nd * 8;
        uint32_t b[2] = {pack_raw(v[0], v[LD]), pack_raw(v[8 * LD], v[9 * LD])};
        mma_bf16_16816(o[nd], a, b);
      }
    }
  }

  bf16* oh = out + (size_t)head * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= S) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-37f);
#pragma unroll
    for (int nd = 0; nd < NB_D; ++nd) {
      *reinterpret_cast<uint32_t*>(oh + (size_t)rows[h] * D + nd * 8 + 2 * t) =
          pack_bf16(o[nd][2 * h] * inv, o[nd][2 * h + 1] * inv);
    }
  }
}

template <bool INT8>
int launch(const void* q, const void* kc, const void* vc, const void* kn, const void* vn,
           const void* kcs, const void* vcs, const void* kns, const void* vns,
           const void* cache_len, const void* valid_len, void* out, int num_kv, int group,
           int S, int budget, int D, void* stream) {
  typedef std::conditional_t<INT8, int8_t, bf16> KT;
  const dim3 grid((S + 15) / 16, num_kv);
  const dim3 block(32 * group);
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define RETAKE_K1_ARGS                                                                \
  (const bf16*)q, (const KT*)kc, (const KT*)vc, (const KT*)kn, (const KT*)vn,         \
      (const float*)kcs, (const float*)vcs, (const float*)kns, (const float*)vns,     \
      (const int*)cache_len, (const int*)valid_len, (bf16*)out, group, S, budget,     \
      scale_log2
  switch (D) {
    case 64:
      flash_prefill_kernel<64, INT8><<<grid, block, 0, st>>>(RETAKE_K1_ARGS);
      break;
    case 128:
      flash_prefill_kernel<128, INT8><<<grid, block, 0, st>>>(RETAKE_K1_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RETAKE_K1_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int retake_flash_prefill_bf16(
    const void* q, const void* kc, const void* vc, const void* kn,
    const void* vn, const void* cache_len, const void* valid_len, void* out,
    int num_kv, int group, int S, int budget, int D, void* stream) {
  return launch<false>(q, kc, vc, kn, vn, nullptr, nullptr, nullptr, nullptr, cache_len,
                       valid_len, out, num_kv, group, S, budget, D, stream);
}

extern "C" int retake_flash_prefill_int8(
    const void* q, const void* kc, const void* vc, const void* kn, const void* vn,
    const void* kc_scale, const void* vc_scale, const void* kn_scale, const void* vn_scale,
    const void* cache_len, const void* valid_len, void* out, int num_kv, int group, int S,
    int budget, int D, void* stream) {
  return launch<true>(q, kc, vc, kn, vn, kc_scale, vc_scale, kn_scale, vn_scale, cache_len,
                      valid_len, out, num_kv, group, S, budget, D, stream);
}
