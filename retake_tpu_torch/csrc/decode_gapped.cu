// K4: batched single-token decode attention over the gap-layout cache, bf16.
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
// What bounds it on the H100: device-memory bandwidth. One query token per
// slot reads every live K/V byte once (2 * 2 * D bytes per column and KV
// head) for 4 * G * D flops per column: far below the tensor cores' ridge.
// At serving shapes B * KV is 8, so one CTA per (slot, head) would use 8 of
// the 132 SMs. The design (flash-decoding):
//  * launch 1: one CTA per (slot, KV head, SPLIT-column range). A split that
//    misses both live regions reads final_len / dec_start / write_end from
//    device memory and exits at once (the TPU kernel's per-slot dead-block
//    skipping); inside a live split, 64-column tiles that miss both regions
//    are never loaded;
//  * K/V tiles stream through a two-stage cp.async ring in shared memory;
//    masked columns of a live tile are zero-filled by the copy itself, so
//    whatever the buffer holds there never reaches the sums (no 0 x NaN);
//  * the G query rows (padded to 16) are one mma.sync m16n8k16 A operand;
//    each of the 4 warps owns 16 columns of every tile and keeps its own
//    online-softmax state in registers; the 4 states merge in shared memory
//    in warp order, and the split writes its partial (acc, m, l);
//  * launch 2 combines the splits of each (slot, head) in split order: no
//    atomics, so the result repeats bit for bit.
// Plain twin: retake_tpu_torch/ops/cuda/decode_gapped.py
// decode_gapped_flash_state_plain.

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

constexpr int BK = 64;       // columns per tile
constexpr int SPLIT = 512;   // columns per CTA (a multiple of BK)
constexpr int WARPS = 4;     // each owns BK / WARPS = 16 columns of a tile
constexpr int MAX_GROUP = 16;
constexpr float NEG_INF_OUT = -1e30f;  // the JAX NEG_INF of an empty slot
constexpr float LN2 = 0.6931471805599453f;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int D>
constexpr int smem_bytes() {
  // two stages of K and V tiles; reused for the warps' states at the end
  return 2 * 2 * BK * (D + 8) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(32 * WARPS) decode_gapped_split_kernel(
    const bf16* __restrict__ q,  // [B, KV, G, D]
    const bf16* __restrict__ k,  // [B, KV, S, D]
    const bf16* __restrict__ v,
    const int* __restrict__ final_len, const int* __restrict__ dec_start,
    int write_end,
    float* __restrict__ part_acc,  // [B * KV, n_split, G, D]
    float* __restrict__ part_ml,   // [B * KV, n_split, 2, G] (m in log2 units, l)
    int num_kv, int group, int S, float scale_log2) {
  constexpr int KSTEPS = D / 16;
  constexpr int NB_D = D / 8;
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  constexpr int VEC = 8;     // bf16 per 16-byte copy
  constexpr int TILE = BK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage_base = reinterpret_cast<bf16*>(smem_raw);  // [2][K|V][BK][LD]

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

  const bf16* kh = k + (size_t)bk * S * D;
  const bf16* vh = v + (size_t)bk * S * D;
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
    bf16* ks = stage_base + stage * 2 * TILE;
    bf16* vs = ks + TILE;
    const int base = s0 + it * BK;
    for (int i = threadIdx.x; i < BK * (D / VEC); i += blockDim.x) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      const int j = base + r;
      const bool fill = j < s1 && lv.col(j);
      const size_t off = fill ? (size_t)j * D + c : 0;
      cp_async16(ks + r * LD + c, kh + off, fill);
      cp_async16(vs + r * LD + c, vh + off, fill);
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

    const bf16* ks = stage_base + stage * 2 * TILE;
    const bf16* vs = ks + TILE;
    const int col0 = warp * 16;  // this warp's 16 columns of the tile
    const int base = s0 + cur * BK + col0;

    float sc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
      const bf16* krow = ks + (col0 + nb * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t bb[2] = {load_pair(krow + kk * 16), load_pair(krow + kk * 16 + 8)};
        mma_bf16_16816(sc[nb], qa[kk], bb);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = base + nb * 8 + 2 * t + (e & 1);
        const float s2 = (j < s1 && lv.col(j)) ? sc[nb][e] * scale_log2 : -INFINITY;
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
    // P (bf16, as the TPU kernel rounds it) @ V over the warp's 16 columns
    const uint32_t a[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                           pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    const bf16* vcol = vs + (col0 + 2 * t) * LD + g;
#pragma unroll
    for (int nd = 0; nd < NB_D; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
      const bf16* vp = vcol + nd * 8;
      uint32_t bb[2] = {pack_raw(vp[0], vp[LD]), pack_raw(vp[8 * LD], vp[9 * LD])};
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

template <int D>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const bf16* q, const bf16* k,
                         const bf16* v, const int* fl, const int* ds, int write_end,
                         float* pacc, float* pml, int num_kv, int group, int S,
                         float scale_log2) {
  static bool attr_set = false;  // > 48 KB of dynamic shared memory: opt in once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(decode_gapped_split_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes<D>());
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  decode_gapped_split_kernel<D><<<grid, 32 * WARPS, smem_bytes<D>(), st>>>(
      q, k, v, fl, ds, write_end, pacc, pml, num_kv, group, S, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int retake_decode_gapped_split_count(int S) { return (S + SPLIT - 1) / SPLIT; }

extern "C" int retake_decode_gapped_bf16(const void* q, const void* k, const void* v,
                                         const void* final_len, const void* dec_start,
                                         void* part_acc, void* part_ml, void* acc,
                                         void* m, void* l, int batch, int num_kv,
                                         int group, int S, int D, int write_end,
                                         void* stream) {
  if (group < 1 || group > MAX_GROUP || S < 1) return (int)cudaErrorInvalidValue;
  const int n_split = (S + SPLIT - 1) / SPLIT;
  const dim3 grid(n_split, batch * num_kv);
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  const int *fl = (const int*)final_len, *ds = (const int*)dec_start;
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_split<64>(grid, st, qq, kk, vv, fl, ds, write_end, (float*)part_acc,
                             (float*)part_ml, num_kv, group, S, scale_log2);
      break;
    case 128:
      err = launch_split<128>(grid, st, qq, kk, vv, fl, ds, write_end, (float*)part_acc,
                              (float*)part_ml, num_kv, group, S, scale_log2);
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
