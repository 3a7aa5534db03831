// K4: batched single-token decode attention over the gap-layout cache, with
// a bf16 mode and an int8-KV mode.
//
// Replaces the TPU kernel retake_tpu/ops/pallas/decode_gapped.py
// (decode_gapped_flash_state / _kernel). For each slot b, KV head k and
// query row g < G it returns the UNNORMALIZED flash state over the slot's
// live cache columns
//     [0, final_len[b])  u  [dec_start[b], write_end)
// m = row max of q.k^T / sqrt(D), l = sum exp(s - m), acc = sum exp(s - m) v
// (fp32). The caller merges the current token's key/value and normalizes
// (ops/attention.py decode_attention_batch_gapped). A slot with no live
// column gives m = -1e30, l = 0, acc = 0.
//
// int8-KV mode (the TPU kernel's quantized mode, decode_gapped.py:183-214):
// K/V are int8 with one fp32 scale per key column, and the scales are
// commuted as there: int8 -> bf16 without the scale (exact, |x| <= 127),
// s = (q.k) / sqrt(D) * ks, THEN the validity mask (a masked column with a
// zero scale must not become a live 0 logit), l sums the unscaled p, and
// p * vs is rounded to bf16 for the product with V.
//
// What bounds it on the H100: device-memory bandwidth. One query token per
// slot reads every live K/V byte once (2 * 2 * D bytes per column and KV
// head in bf16, 2 * D + 8 in int8) for 4 * G * D flops per column: far below
// the tensor cores' ridge. At serving shapes B * KV is 8-16, so one CTA per
// (slot, head) would use 8-16 of the 132 SMs. The design (flash-decoding):
//  * launch 1: one CTA per (slot, KV head, SPLIT-column range). A split that
//    misses both live regions reads final_len / dec_start / write_end from
//    device memory and exits at once (the TPU kernel's per-slot dead-block
//    skipping); inside a live split, 64-column tiles that miss both regions
//    are never loaded;
//  * K/V tiles (and in int8 mode the scale rows) stream through a two-stage
//    cp.async ring in shared memory; masked columns of a live tile are
//    zero-filled by the copy itself, scales included, so whatever the
//    buffer holds there never reaches the sums (no 0 x NaN);
//  * the G query rows (padded to 16) are one mma.sync m16n8k16 A operand;
//    each of the 4 warps owns 16 columns of every tile and keeps its own
//    online-softmax state in registers; the 4 states merge in shared memory
//    in warp order, and the split writes its partial (acc, m, l). int8
//    tiles are widened to bf16 as the fragments are read;
//  * launch 2 combines the splits of each (slot, head) in split order: no
//    atomics, so the result repeats bit for bit.
// Plain twin (both modes): retake_tpu_torch/ops/cuda/decode_gapped.py
// decode_gapped_flash_state_plain.

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

constexpr int BK = 64;       // columns per tile
constexpr int SPLIT = 512;   // columns per CTA (a multiple of BK)
constexpr int WARPS = 4;     // each owns BK / WARPS = 16 columns of a tile
constexpr int MAX_GROUP = 16;
constexpr float NEG_INF_OUT = -1e30f;  // the JAX NEG_INF of an empty slot
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

struct Live {
  int final_len, dec_start, write_end;
  // does [lo, hi) hold a live column?
  __device__ __forceinline__ bool any(int lo, int hi) const {
    return lo < min(hi, final_len) || max(lo, dec_start) < min(hi, write_end);
  }
  __device__ __forceinline__ bool col(int j) const {
    return j < final_len || (j >= dec_start && j < write_end);
  }
};

__device__ __forceinline__ Live live_of(const int* final_len, const int* dec_start,
                                        int b, int write_end, int S) {
  Live lv;
  lv.final_len = min(max(final_len[b], 0), S);
  lv.dec_start = max(dec_start[b], 0);
  lv.write_end = min(write_end, S);
  return lv;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = fill ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// one 4-byte scale; 0: zero-fill
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = fill ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// two int8 values (low byte first) -> two bf16, packed; exact for |x| <= 127
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint16_t w) {
  return pack_bf16((float)(int8_t)(w & 0xff), (float)(int8_t)(w >> 8));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Shared-memory layout of one ring stage: K tile, V tile ([BK][LD] each,
// rows padded by 16 bytes: conflict-free fragment loads), and in int8 mode
// the K and V scale rows [BK] f32.
template <int D, bool INT8>
struct Ring {
  typedef std::conditional_t<INT8, int8_t, bf16> KT;
  static constexpr int LD = D + 16 / (int)sizeof(KT);  // elements per padded row
  static constexpr int TILE_BYTES = BK * LD * (int)sizeof(KT);
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + (INT8 ? 2 * BK * 4 : 0);
  static constexpr int MERGE_BYTES = (WARPS * 16 * D + 2 * WARPS * 16) * 4;
  // two stages; reused for the warps' states at the end
  static constexpr int SMEM = 2 * STAGE_BYTES > MERGE_BYTES ? 2 * STAGE_BYTES : MERGE_BYTES;
};

template <int D, bool INT8>
__global__ void __launch_bounds__(32 * WARPS) decode_gapped_split_kernel(
    const bf16* __restrict__ q,  // [B, KV, G, D]
    const std::conditional_t<INT8, int8_t, bf16>* __restrict__ k,  // [B, KV, S, D]
    const std::conditional_t<INT8, int8_t, bf16>* __restrict__ v,
    const float* __restrict__ k_scale,  // int8: [B, KV, S]
    const float* __restrict__ v_scale,
    const int* __restrict__ final_len, const int* __restrict__ dec_start,
    int write_end,
    float* __restrict__ part_acc,  // [B * KV, n_split, G, D]
    float* __restrict__ part_ml,   // [B * KV, n_split, 2, G] (m in log2 units, l)
    int num_kv, int group, int S, float scale_log2, float inv_sqrt_d) {
  typedef Ring<D, INT8> R;
  typedef typename R::KT KT;
  constexpr int KSTEPS = D / 16;
  constexpr int NB_D = D / 8;
  constexpr int LD = R::LD;
  constexpr int CPR = D * (int)sizeof(KT) / 16;  // 16-byte copies per row
  constexpr int VEC = 16 / (int)sizeof(KT);      // elements per copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto k_tile = [&](int stage) {
    return reinterpret_cast<KT*>(smem_raw + stage * R::STAGE_BYTES);
  };
  auto v_tile = [&](int stage) {
    return reinterpret_cast<KT*>(smem_raw + stage * R::STAGE_BYTES + R::TILE_BYTES);
  };
  auto ks_row = [&](int stage) {  // int8 only
    return reinterpret_cast<float*>(smem_raw + stage * R::STAGE_BYTES + 2 * R::TILE_BYTES);
  };

  const int bk = blockIdx.y;  // b * num_kv + kv head
  const int b = bk / num_kv;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int s0 = split * SPLIT, s1 = min(s0 + SPLIT, S);
  const Live lv = live_of(final_len, dec_start, b, write_end, S);
  if (!lv.any(s0, s1)) return;  // dead split: launch 2 skips it too

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {g, g + 8};

  uint32_t qa[KSTEPS][4];
  const bf16* qh = q + (size_t)bk * group * D;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = rows[0] < group ? load_pair(qh + rows[0] * D + c) : 0u;
    qa[kk][1] = rows[1] < group ? load_pair(qh + rows[1] * D + c) : 0u;
    qa[kk][2] = rows[0] < group ? load_pair(qh + rows[0] * D + c + 8) : 0u;
    qa[kk][3] = rows[1] < group ? load_pair(qh + rows[1] * D + c + 8) : 0u;
  }

  const KT* kh = k + (size_t)bk * S * D;
  const KT* vh = v + (size_t)bk * S * D;
  const int n_tiles = (s1 - s0 + BK - 1) / BK;
  auto tile_live = [&](int it) {
    const int lo = s0 + it * BK;
    return lv.any(lo, min(lo + BK, s1));
  };
  auto next_live = [&](int it) {
    while (it < n_tiles && !tile_live(it)) ++it;
    return it;
  };
  auto issue = [&](int it, int stage) {
    KT* ks = k_tile(stage);
    KT* vs = v_tile(stage);
    const int base = s0 + it * BK;
    for (int i = threadIdx.x; i < BK * CPR; i += blockDim.x) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      const int j = base + r;
      const bool fill = j < s1 && lv.col(j);
      const size_t off = fill ? (size_t)j * D + c : 0;
      cp_async16(ks + r * LD + c, kh + off, fill);
      cp_async16(vs + r * LD + c, vh + off, fill);
    }
    if constexpr (INT8) {
      float* sk = ks_row(stage);
      for (int r = threadIdx.x; r < BK; r += blockDim.x) {
        const int j = base + r;
        const bool fill = j < s1 && lv.col(j);
        const size_t off = (size_t)bk * S + (fill ? j : 0);
        cp_async4(sk + r, k_scale + off, fill);
        cp_async4(sk + BK + r, v_scale + off, fill);
      }
    }
  };

  float o[NB_D][4];
#pragma unroll
  for (int i = 0; i < NB_D; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  int cur = next_live(0), stage = 0;
  issue(cur, 0);
  cp_async_commit();
  while (cur < n_tiles) {
    const int nxt = next_live(cur + 1);
    if (nxt < n_tiles) issue(nxt, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();

    const KT* ks = k_tile(stage);
    const KT* vs = v_tile(stage);
    const float* sk = INT8 ? ks_row(stage) : nullptr;  // [K scales | V scales]
    const int col0 = warp * 16;  // this warp's 16 columns of the tile
    const int base = s0 + cur * BK + col0;

    float sc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
      const KT* krow = ks + (col0 + nb * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t bb[2];
        if constexpr (INT8) {
          bb[0] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(krow + kk * 16));
          bb[1] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(krow + kk * 16 + 8));
        } else {
          bb[0] = load_pair(krow + kk * 16);
          bb[1] = load_pair(krow + kk * 16 + 8);
        }
        mma_bf16_16816(sc[nb], qa[kk], bb);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + 2 * t + (e & 1);  // column within the warp's 16
        const bool live = base + c < s1 && lv.col(base + c);
        float s2;
        if constexpr (INT8) {  // the TPU order: / sqrt(D), * ks, then the mask
          s2 = live ? (sc[nb][e] * inv_sqrt_d) * sk[col0 + c] * LOG2E : -INFINITY;
        } else {
          s2 = live ? sc[nb][e] * scale_log2 : -INFINITY;
        }
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
    for (int nb = 0; nb < 2; ++nb) {
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
    if constexpr (INT8) {  // l summed the unscaled p; the product takes p * vs
      const float* sv = sk + BK + col0 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] *= sv[nb * 8 + (e & 1)];
      }
    }
    // P (bf16, as the TPU kernel rounds it) @ V over the warp's 16 columns
    const uint32_t a[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                           pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    const KT* vcol = vs + (col0 + 2 * t) * LD + g;
#pragma unroll
    for (int nd = 0; nd < NB_D; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
      const KT* vp = vcol + nd * 8;
      uint32_t bb[2];
      if constexpr (INT8) {
        bb[0] = pack_bf16((float)vp[0], (float)vp[LD]);
        bb[1] = pack_bf16((float)vp[8 * LD], (float)vp[9 * LD]);
      } else {
        bb[0] = pack_raw(vp[0], vp[LD]);
        bb[1] = pack_raw(vp[8 * LD], vp[9 * LD]);
      }
      mma_bf16_16816(o[nd], a, bb);
    }
    __syncthreads();  // this stage is free for the tile after next
    cur = nxt;
    stage ^= 1;
  }

  // merge the warps' states in warp order (the ring is free: reuse it)
  float* w_acc = reinterpret_cast<float*>(smem_raw);  // [WARPS][16][D]
  float* w_m = w_acc + WARPS * 16 * D;                 // [WARPS][16]
  float* w_l = w_m + WARPS * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = w_acc + (warp * 16 + rows[h]) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < NB_D; ++nd) {
      dst[nd * 8] = o[nd][2 * h];
      dst[nd * 8 + 1] = o[nd][2 * h + 1];
    }
    if (t == 0) {
      w_m[warp * 16 + rows[h]] = m[h];
      w_l[warp * 16 + rows[h]] = l[h];
    }
  }
  __syncthreads();
  float* pacc = part_acc + ((size_t)bk * n_split + split) * group * D;
  float* pml = part_ml + ((size_t)bk * n_split + split) * 2 * group;
  for (int i = threadIdx.x; i < group * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float mt = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, w_m[w * 16 + r]);
    float acc = 0.f, ls = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(w_m[w * 16 + r] - mt);  // a warp that saw nothing: 0
      acc += w_acc[(w * 16 + r) * D + d] * wt;
      ls += w_l[w * 16 + r] * wt;
    }
    pacc[i] = acc;
    if (d == 0) {
      pml[r] = mt;
      pml[group + r] = ls;
    }
  }
}

// launch 2: one CTA per (slot * head, row); thread d sums column d over the
// live splits in split order
__global__ void decode_gapped_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ final_len, const int* __restrict__ dec_start, int write_end,
    float* __restrict__ acc_out,  // [B * KV, G, D]
    float* __restrict__ m_out,    // [B * KV, G]
    float* __restrict__ l_out, int num_kv, int group, int S, int D, int n_split) {
  const int bk = blockIdx.x, r = blockIdx.y;
  const Live lv = live_of(final_len, dec_start, bk / num_kv, write_end, S);
  const size_t stride_acc = (size_t)group * D, stride_ml = 2 * (size_t)group;
  const float* pml = part_ml + (size_t)bk * n_split * stride_ml;
  const float* pacc = part_acc + (size_t)bk * n_split * stride_acc + (size_t)r * D;
  float mt = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (lv.any(s * SPLIT, min((s + 1) * SPLIT, S))) mt = fmaxf(mt, pml[s * stride_ml + r]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f, ls = 0.f;
    if (mt != -INFINITY) {
      for (int s = 0; s < n_split; ++s) {
        if (!lv.any(s * SPLIT, min((s + 1) * SPLIT, S))) continue;
        const float wt = exp2f(pml[s * stride_ml + r] - mt);
        acc += pacc[s * stride_acc + d] * wt;
        ls += pml[s * stride_ml + group + r] * wt;
      }
    }
    acc_out[((size_t)bk * group + r) * D + d] = acc;
    if (d == 0) {
      m_out[(size_t)bk * group + r] = mt == -INFINITY ? NEG_INF_OUT : mt * LN2;
      l_out[(size_t)bk * group + r] = ls;
    }
  }
}

template <int D, bool INT8>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q, const void* k,
                         const void* v, const void* ks, const void* vs, const int* fl,
                         const int* ds, int write_end, float* pacc, float* pml, int num_kv,
                         int group, int S) {
  typedef typename Ring<D, INT8>::KT KT;
  constexpr int smem = Ring<D, INT8>::SMEM;
  static bool attr_set = false;  // > 48 KB of dynamic shared memory: opt in once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(decode_gapped_split_kernel<D, INT8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (1.0f / sqrtf((float)D)) * LOG2E;
  decode_gapped_split_kernel<D, INT8><<<grid, 32 * WARPS, smem, st>>>(
      (const bf16*)q, (const KT*)k, (const KT*)v, (const float*)ks, (const float*)vs, fl, ds,
      write_end, pacc, pml, num_kv, group, S, scale_log2, inv_sqrt_d);
  return cudaGetLastError();
}

template <bool INT8>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* final_len, const void* dec_start, void* part_acc, void* part_ml,
           void* acc, void* m, void* l, int batch, int num_kv, int group, int S, int D,
           int write_end, void* stream) {
  if (group < 1 || group > MAX_GROUP || S < 1) return (int)cudaErrorInvalidValue;
  const int n_split = (S + SPLIT - 1) / SPLIT;
  const dim3 grid(n_split, batch * num_kv);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int *fl = (const int*)final_len, *ds = (const int*)dec_start;
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_split<64, INT8>(grid, st, q, k, v, ks, vs, fl, ds, write_end,
                                   (float*)part_acc, (float*)part_ml, num_kv, group, S);
      break;
    case 128:
      err = launch_split<128, INT8>(grid, st, q, k, v, ks, vs, fl, ds, write_end,
                                    (float*)part_acc, (float*)part_ml, num_kv, group, S);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  decode_gapped_combine_kernel<<<dim3(batch * num_kv, group), D, 0, st>>>(
      (const float*)part_acc, (const float*)part_ml, fl, ds, write_end, (float*)acc,
      (float*)m, (float*)l, num_kv, group, S, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int retake_decode_gapped_split_count(int S) { return (S + SPLIT - 1) / SPLIT; }

extern "C" int retake_decode_gapped_bf16(const void* q, const void* k, const void* v,
                                         const void* final_len, const void* dec_start,
                                         void* part_acc, void* part_ml, void* acc,
                                         void* m, void* l, int batch, int num_kv,
                                         int group, int S, int D, int write_end,
                                         void* stream) {
  return launch<false>(q, k, v, nullptr, nullptr, final_len, dec_start, part_acc, part_ml,
                       acc, m, l, batch, num_kv, group, S, D, write_end, stream);
}

extern "C" int retake_decode_gapped_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* final_len, const void* dec_start,
                                         void* part_acc, void* part_ml, void* acc,
                                         void* m, void* l, int batch, int num_kv,
                                         int group, int S, int D, int write_end,
                                         void* stream) {
  return launch<true>(q, k, v, k_scale, v_scale, final_len, dec_start, part_acc, part_ml,
                      acc, m, l, batch, num_kv, group, S, D, write_end, stream);
}
