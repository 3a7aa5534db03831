// K4: batched single-token decode attention over the gap-layout cache, with
// a bf16 mode and an int8-KV mode, for Hopper (one launch, TMA ring).
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
// (slot, head) would use 8-16 of the 132 SMs. The design (flash-decoding in
// one launch):
//  * one CTA per (slot, KV head, SPLIT-column range). A split that misses
//    both live regions reads final_len / dec_start / write_end from device
//    memory and exits at once (the TPU kernel's per-slot dead-block
//    skipping); inside a live split, 64-column tiles that miss both regions
//    are never loaded;
//  * one producer thread feeds a ring of STAGES K|V tiles paced by full /
//    empty mbarriers: each tile is one or two TMA boxes per K and V (3-D
//    maps over [B * KV, S, D], swizzled so that fragment reads are free of
//    bank conflicts; rows past S arrive as zeros). A first version brought
//    each live row by its own 1-D bulk copy: 128 copies a tile, and the
//    copy engine's cost per copy made it slower than the kernel it
//    replaced. The maps are encoded at each launch. int8 scale rows come by
//    1-D bulk copy where their address is 16-byte aligned, else by plain
//    loads (a 1-D copy at an unaligned offset faults);
//  * a tile whose columns are not all live zeroes the V rows of its dead
//    columns in shared memory before the product (a masked p = 0 still
//    multiplies V, and 0 x NaN is NaN) and masks their logits whatever the
//    K row or the scale held, so the kernel never relies on the cache's
//    dead columns;
//  * NCW consumer warps each take 64 / NCW columns of every tile, with
//    their own online-softmax state. The G query rows (padded to 16) are
//    one mma.sync m16n8k16 A operand: wgmma needs 64 rows, so for G <= 16 it
//    would issue 4-10x the tensor work for nothing, and tensor work is not
//    what bounds this kernel. B fragments come by ldmatrix (.trans for V).
//    int8 tiles are read by the same ldmatrix as 16-bit pairs and widened
//    in registers by byte permutes and one exact fp32 subtraction: K's pairs
//    are consecutive head dims, so Q's A fragment takes the same permutation
//    of the dims; V's pairs are two head dims of two keys, split into two
//    products whose output columns are dims 2n and 2n + 1;
//  * the warps' states merge in shared memory in warp order. A (slot, head)
//    with one live split writes its state directly. Otherwise each split
//    writes its partial (acc, m, l) to a workspace, fences, and bumps its
//    group's arrival counter (GSPLITS splits a group): the last to arrive
//    merges the group's live splits in split order, then bumps the (slot,
//    head)'s counter; the last group to arrive merges the groups in group
//    order and writes (acc, m, l). Each resets the counter it used to 0.
//    Which CTA merges varies, the order does not: the result repeats bit
//    for bit. A merging CTA brings its sources into shared memory by 1-D
//    bulk copies, double-buffered. With no live split at all, split 0
//    writes the empty state.
// The plan (SPLIT, STAGES, NCW) is fixed; ops/cuda/decode_gapped.py
// launch_plan states it, and PERF.md gives the timings that chose it.
// Plain twin (both modes): retake_tpu_torch/ops/cuda/decode_gapped.py
// decode_gapped_flash_state_plain.

#include <cuda.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace retake::sm90;
using retake::group_max;
using retake::group_sum;
using retake::ldmatrix_x4;
using retake::ldmatrix_x4_trans;
using retake::load_pair;
using retake::mma_bf16_16816;
using retake::pack_bf16;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;       // columns per tile
constexpr int SPLIT = 1024;  // columns per CTA (a multiple of BK)
constexpr int STAGES = 3;    // tiles in the ring
constexpr int NCW = 4;       // consumer warps, each 64 / NCW columns of every tile
constexpr int WCOLS = BK / NCW;
constexpr int THREADS = 32 * (NCW + 1);
constexpr int MAX_GROUP = 16;
constexpr int MAX_SPLITS = 128;  // splits of one (slot, head) the kernel takes
constexpr int GSPLITS = 8;       // splits merged as one group first
constexpr int MAX_GROUPS = MAX_SPLITS / GSPLITS;
constexpr int MAX_SRC = MAX_GROUPS > GSPLITS ? MAX_GROUPS : GSPLITS;  // states one merge sums
constexpr float NEG_INF_OUT = -1e30f;  // the JAX NEG_INF of an empty slot
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }

// Shared memory, from a 1024-aligned base: STAGES ring stages of [K tile |
// V tile | int8: K scales, V scales] (each stage 1024-aligned); after the
// loop the same bytes hold the merge: SCRATCH (row maxima, the live splits
// and groups, the m and l of a merge's sources), then the warps' states,
// which two staging buffers of partials overlay once the CTA's own state is
// written. Then 2 * STAGES + 2 mbarriers. A tile is BK rows in swizzled boxes of
// LINE bytes a row (two boxes for a 256-byte bf16 row).
template <int D, bool INT8>
struct Plan {
  static constexpr int ROW = D * (INT8 ? 1 : 2);        // bytes of one cache row
  static constexpr int LINE = ROW < 128 ? ROW : 128;    // bytes of a row in one box
  static constexpr int TILE = BK * ROW;
  static constexpr int STAGE = align1k(2 * TILE + (INT8 ? 2 * BK * 4 : 0));
  static constexpr int SCRATCH =
      ((MAX_GROUP + MAX_SPLITS + 2 * MAX_GROUPS + 1 + MAX_SRC * 2 * MAX_GROUP) * 4 + 15) & ~15;
  static constexpr int WARPS_STATE = (NCW * 16 * D + 2 * NCW * 16) * 4;
  static constexpr int STAGING = 2 * MAX_GROUP * D * 4;  // the least: one partial a buffer
  static constexpr int MERGE = SCRATCH + (WARPS_STATE > STAGING ? WARPS_STATE : STAGING);
  static constexpr int BODY = STAGES * STAGE > MERGE ? STAGES * STAGE : MERGE;
  static constexpr int SMEM = 1024 + BODY + (2 * STAGES + 2) * 8;
  // byte offset of byte `byte` of row r in a tile, as the TMA's swizzle
  // stores it: 16-byte chunk index ^= bits 7-9 (128-byte rows) or 7-8
  // (64-byte rows) of the offset
  static __device__ __forceinline__ int at(int r, int byte) {
    const int off = (byte / LINE) * (BK * LINE) + r * LINE + byte % LINE;
    return off ^ (((off >> 7) & (LINE / 16 - 1)) << 4);
  }
};

struct Maps {  // 3-D TMA maps over the cache [B * KV, S, D], in parameter space
  CUtensorMap k, v;
};

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

__device__ __forceinline__ bool split_live(const Live& lv, int s, int S) {
  return lv.any(s * SPLIT, min((s + 1) * SPLIT, S));
}

// bytes lo and hi of `biased` (int8 values XOR 0x80, so a byte holds x +
// 128) as a bf16 pair, exactly: each byte becomes the low mantissa bits of
// 2^23, one fp32 subtraction takes the bias off, and the upper halves of
// the two floats are their bf16 values (|x| <= 127 needs 7 mantissa bits)
__device__ __forceinline__ uint32_t i8pair(uint32_t biased, int lo, int hi) {
  const float a = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + lo)) - 8388736.0f;
  const float b = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + hi)) - 8388736.0f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// head dim of accumulator element (nd, e) of thread t (e & 1 picks the
// pair; rows g and g + 8 share it). bf16: o[nd] covers dims 8 nd .. 8 nd +
// 7. int8: o[2 blk] and o[2 blk + 1] cover the even and odd dims of the
// 16-dim block blk, so thread t owns dims 16 blk + 4t .. 16 blk + 4t + 3.
template <bool INT8>
__device__ __forceinline__ int dim_of(int nd, int e, int t) {
  return INT8 ? 16 * (nd >> 1) + 4 * t + (nd & 1) + 2 * (e & 1) : 8 * nd + 2 * t + (e & 1);
}

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS) decode_gapped_kernel(
    const __grid_constant__ Maps maps,  // K, V: [B * KV, S, D] bf16 or int8
    const bf16* __restrict__ q,         // [B, KV, G, D]
    const float* __restrict__ k_scale,  // int8: [B, KV, S]
    const float* __restrict__ v_scale,
    const int* __restrict__ final_len, const int* __restrict__ dec_start, int write_end,
    // partials: the splits' acc [B * KV, n_split, G, D] | their (m in log2
    // units, l) [B * KV, n_split, 2, G] | the same two for the groups
    float* __restrict__ work,
    int* __restrict__ counters,  // [B * KV, 1 + groups], 0 between launches
    float* __restrict__ out,     // acc [B * KV, G, D] | m [B * KV, G] | l [B * KV, G]
    int num_kv, int group, int S, float scale_log2, float inv_sqrt_d) {
  typedef Plan<D, INT8> P;
  constexpr int NB = D / 8;  // 8-column output blocks
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last, s_live, s_groups;
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // the swizzle needs 1024
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BODY);
  uint64_t* empty = full + STAGES;
  uint64_t* staged = empty + STAGES;  // the merge's two staging buffers

  const int bk = blockIdx.y, n_bk = gridDim.y;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int s0 = split * SPLIT, s1 = min(s0 + SPLIT, S);
  const Live lv = live_of(final_len, dec_start, bk / num_kv, write_end, S);
  const int gd = group * D;
  float* acc_out = out + (size_t)bk * gd;
  float* m_out = out + (size_t)n_bk * gd + (size_t)bk * group;
  float* l_out = m_out + (size_t)n_bk * group;
  const size_t row0 = (size_t)bk * S;  // first cache row of this (slot, head)

  if (!lv.any(s0, s1)) {
    if (split == 0) {  // the empty state, if no split of the (slot, head) is live
      bool none = true;
      for (int s = 1; s < n_split && none; ++s) none = !split_live(lv, s, S);
      if (none) {
        for (int i = threadIdx.x; i < gd; i += THREADS) acc_out[i] = 0.f;
        for (int r = threadIdx.x; r < group; r += THREADS) {
          m_out[r] = NEG_INF_OUT;
          l_out[r] = 0.f;
        }
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);     // the producer's lane 0 (plus the copies' bytes)
      mbar_init(&empty[s], NCW);  // lane 0 of every consumer warp
    }
    mbar_init(&staged[0], 1);
    mbar_init(&staged[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (s1 - s0 + BK - 1) / BK;
  auto next_live = [&](int it) {
    while (it < n_tiles && !lv.any(s0 + it * BK, min(s0 + (it + 1) * BK, s1))) ++it;
    return it;
  };

  float o[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the log2-scaled logits
  float l[2] = {0.f, 0.f};

  if (warp == NCW) {
    // ---- producer warp: lane 0 brings each live tile by TMA (whole boxes;
    // rows past S arrive as zeros); the scale rows by bulk copy where the
    // address allows it, else every lane loads two ----
    int j = 0;
    for (int it = next_live(0); it < n_tiles; it = next_live(it + 1), ++j) {
      const int stage = j % STAGES;
      mbar_wait(&empty[stage], ((j / STAGES) & 1) ^ 1);
      uint8_t* kt = smem + stage * P::STAGE;
      float* sc = reinterpret_cast<float*>(kt + 2 * P::TILE);  // int8: [K scales | V scales]
      const int base = s0 + it * BK;
      bool bulk_scales = false;
      if constexpr (INT8) {
        bulk_scales = (row0 + base) % 4 == 0 && base + BK <= S;
        if (!bulk_scales) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = lane + 32 * h;
            const bool in = base + r < S;
            sc[r] = in ? k_scale[row0 + base + r] : 0.f;
            sc[BK + r] = in ? v_scale[row0 + base + r] : 0.f;
          }
          fence_proxy_async();  // these stores before later bulk writes here
          __syncwarp();
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * P::TILE + (bulk_scales ? 2 * BK * 4 : 0));
#pragma unroll
        for (int bx = 0; bx < P::ROW / P::LINE; ++bx) {
          const int c0 = bx * P::LINE / (INT8 ? 1 : 2);
          tma_load_3d(kt + bx * BK * P::LINE, &maps.k, &full[stage], c0, base, bk);
          tma_load_3d(kt + P::TILE + bx * BK * P::LINE, &maps.v, &full[stage], c0, base, bk);
        }
        if (bulk_scales) {
          bulk_load(sc, k_scale + row0 + base, BK * 4, &full[stage]);
          bulk_load(sc + BK, v_scale + row0 + base, BK * 4, &full[stage]);
        }
      }
    }
  } else {
    // ---- consumer warps: warp w takes columns w * WCOLS .. + WCOLS of
    // every live tile, with its own online-softmax state ----
    // Q as the A operand of every k-step; int8 mode permutes the dims of a
    // k-step as its K fragments arrive (pairs 4t, 4t + 1 and 4t + 2, 4t + 3)
    uint32_t qa[D / 16][4];
    const bf16* qh = q + (size_t)bk * gd;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = INT8 ? 16 * kk + 4 * t : 16 * kk + 2 * t;
      const int c1 = INT8 ? c0 + 2 : c0 + 8;
      qa[kk][0] = g < group ? load_pair(qh + g * D + c0) : 0u;
      qa[kk][1] = g + 8 < group ? load_pair(qh + (g + 8) * D + c0) : 0u;
      qa[kk][2] = g < group ? load_pair(qh + g * D + c1) : 0u;
      qa[kk][3] = g + 8 < group ? load_pair(qh + (g + 8) * D + c1) : 0u;
    }

    const int col0 = warp * WCOLS;
    int j = 0;
    for (int it = next_live(0); it < n_tiles; it = next_live(it + 1), ++j) {
      const int stage = j % STAGES;
      mbar_wait(&full[stage], (j / STAGES) & 1);
      uint8_t* kt = smem + stage * P::STAGE;
      uint8_t* vt = kt + P::TILE;
      const float* sk = reinterpret_cast<const float*>(kt + 2 * P::TILE);
      const int base = s0 + it * BK;
      // masks only on a tile with a dead column
      const bool whole = base + BK <= s1 && (base + BK <= lv.final_len ||
                                             (base >= lv.dec_start && base + BK <= lv.write_end));
      if (!whole) {  // V rows of dead columns -> 0: a masked p = 0 still multiplies V
        for (int i = lane; i < WCOLS * (P::ROW / 16); i += 32) {
          const int r = col0 + i / (P::ROW / 16);
          if (!(base + r < s1 && lv.col(base + r)))
            *reinterpret_cast<uint4*>(vt + P::at(r, 16 * (i % (P::ROW / 16)))) =
                make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();  // before the TMA writes this stage again
        __syncwarp();
      }

      // S = Q K^T over the warp's columns
      float sc[WCOLS / 8][4];
#pragma unroll
      for (int nb = 0; nb < WCOLS / 8; ++nb) {
        sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
        const int kr = col0 + nb * 8 + (lane & 7);
#pragma unroll
        for (int kq = 0; kq < (INT8 ? D / 64 : D / 32); ++kq) {
          uint32_t r[4];
          ldmatrix_x4(r, kt + P::at(kr, kq * 64 + (lane >> 3) * 16));
          if constexpr (INT8) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t w = r[i] ^ 0x80808080u;
              const uint32_t bb[2] = {i8pair(w, 0, 1), i8pair(w, 2, 3)};
              mma_bf16_16816(sc[nb], qa[4 * kq + i], bb);
            }
          } else {
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16_16816(sc[nb], qa[2 * kq], b0);
            mma_bf16_16816(sc[nb], qa[2 * kq + 1], b1);
          }
        }
      }

      uint32_t dead = 0;  // bit 2 nb + e: column col0 + nb * 8 + 2t + e is dead
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < WCOLS / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col0 + nb * 8 + 2 * t + (e & 1);
          float s2;
          if constexpr (INT8) {  // the TPU order: / sqrt(D), * ks, then the mask
            s2 = (sc[nb][e] * inv_sqrt_d) * sk[c] * LOG2E;
          } else {
            s2 = sc[nb][e] * scale_log2;
          }
          if (!whole && !(base + c < s1 && lv.col(base + c))) {
            s2 = -INFINITY;  // whatever the row or its scale held
            dead |= 1u << (2 * nb + (e & 1));
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
      for (int nb = 0; nb < WCOLS / 8; ++nb) {
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
#pragma unroll
        for (int nb = 0; nb < WCOLS / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = col0 + nb * 8 + 2 * t + (e & 1);
            // a dead column's scale may be anything the copy brought
            sc[nb][e] = (dead >> (2 * nb + (e & 1))) & 1 ? 0.f : sc[nb][e] * sk[BK + c];
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < NB; ++nd) {
        o[nd][0] *= alpha[0];
        o[nd][1] *= alpha[0];
        o[nd][2] *= alpha[1];
        o[nd][3] *= alpha[1];
      }

      // O += P (bf16, as the TPU kernel rounds it) V, 16 columns a k-step
#pragma unroll
      for (int kk = 0; kk < WCOLS / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                               pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                               pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                               pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
        const int vr = col0 + kk * 16 + (lane & 15);
#pragma unroll
        for (int dq = 0; dq < (INT8 ? D / 32 : D / 16); ++dq) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vt + P::at(vr, dq * 32 + (lane >> 4) * 16));
          if constexpr (INT8) {
            // r[i] = (key 2t: dims 2g, 2g + 1 | key 2t + 1: dims 2g, 2g + 1)
#pragma unroll
            for (int hb = 0; hb < 2; ++hb) {
              const uint32_t w0 = r[2 * hb] ^ 0x80808080u, w1 = r[2 * hb + 1] ^ 0x80808080u;
              const uint32_t even[2] = {i8pair(w0, 0, 2), i8pair(w1, 0, 2)};
              const uint32_t odd[2] = {i8pair(w0, 1, 3), i8pair(w1, 1, 3)};
              mma_bf16_16816(o[4 * dq + 2 * hb], a, even);
              mma_bf16_16816(o[4 * dq + 2 * hb + 1], a, odd);
            }
          } else {
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16_16816(o[2 * dq], a, b0);
            mma_bf16_16816(o[2 * dq + 1], a, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
  }

  // ---- the CTA's state: the warps' states merged in warp order (the ring
  // is free once every consumer has waited for the last tile) ----
  __syncthreads();
  float* row_m = reinterpret_cast<float*>(smem);       // [MAX_GROUP]: a merge's row maxima
  int* list = reinterpret_cast<int*>(row_m + MAX_GROUP);  // [MAX_SPLITS]: live splits in order
  int* gid = list + MAX_SPLITS;                        // [MAX_GROUPS]: live groups in order
  int* gstart = gid + MAX_GROUPS;                      // [MAX_GROUPS + 1]: their first in list
  float* ml = reinterpret_cast<float*>(gstart + MAX_GROUPS + 1);  // [MAX_SRC][2][group]
  float* w_acc = reinterpret_cast<float*>(smem + P::SCRATCH);    // [NCW][16][D]
  float* w_m = w_acc + NCW * 16 * D;                               // [NCW][16]
  float* w_l = w_m + NCW * 16;
  if (warp < NCW) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = w_acc + (warp * 16 + g + 8 * h) * D;
#pragma unroll
      for (int nd = 0; nd < NB; ++nd) {
        dst[dim_of<INT8>(nd, 0, t)] = o[nd][2 * h];
        dst[dim_of<INT8>(nd, 1, t)] = o[nd][2 * h + 1];
      }
      if (t == 0) {
        w_m[warp * 16 + g + 8 * h] = m[h];
        w_l[warp * 16 + g + 8 * h] = l[h];
      }
    }
  } else {  // the producer warp lists the live splits and their groups, in order
    int n = 0;
    for (int s = lane; s - lane < n_split; s += 32) {
      const bool live = s < n_split && split_live(lv, s, S);
      const uint32_t mask = __ballot_sync(~0u, live);
      if (live) list[n + __popc(mask & ((1u << lane) - 1))] = s;
      n += __popc(mask);
    }
    __syncwarp();
    if (lane == 0) {
      int ng = 0;
      for (int k = 0; k < n; ++k) {
        if (ng == 0 || gid[ng - 1] != list[k] / GSPLITS) {
          gid[ng] = list[k] / GSPLITS;
          gstart[ng++] = k;
        }
      }
      gstart[ng] = n;
      s_live = n;
      s_groups = ng;
    }
  }
  __syncthreads();
  const int n_live = s_live, n_groups = s_groups;
  const bool direct = n_live == 1;
  const int grp = split / GSPLITS, n_grp_all = (n_split + GSPLITS - 1) / GSPLITS;
  int gi = 0;  // this split's group among the live ones
  while (gid[gi] != grp) ++gi;
  const int g_count = gstart[gi + 1] - gstart[gi];
  // workspace: the splits' partials, then the groups' (acc [gd], then m, l [2 group])
  const size_t sp_all = (size_t)n_bk * n_split;
  float* sp_acc = work + (size_t)bk * n_split * gd;
  float* sp_ml = work + sp_all * gd + (size_t)bk * n_split * 2 * group;
  float* gp_acc = work + sp_all * (gd + 2 * group) + (size_t)bk * n_grp_all * gd;
  float* gp_ml = work + sp_all * (gd + 2 * group) + (size_t)n_bk * n_grp_all * gd +
                 (size_t)bk * n_grp_all * 2 * group;
  int* cnt = counters + (size_t)bk * (1 + n_grp_all);  // [0]: the groups', [1 + g]: group g's
  for (int i = threadIdx.x; i < gd; i += THREADS) {
    const int r = i / D, d = i % D;
    float mt = -INFINITY;
    for (int w = 0; w < NCW; ++w) mt = fmaxf(mt, w_m[w * 16 + r]);
    float acc = 0.f, ls = 0.f;
    for (int w = 0; w < NCW; ++w) {
      const float wt = exp2f(w_m[w * 16 + r] - mt);  // a warp that saw nothing: 0
      acc += w_acc[(w * 16 + r) * D + d] * wt;
      ls += w_l[w * 16 + r] * wt;
    }
    if (direct) {
      acc_out[i] = acc;
      if (d == 0) {
        m_out[r] = mt == -INFINITY ? NEG_INF_OUT : mt * LN2;
        l_out[r] = ls;
      }
    } else {
      sp_acc[(size_t)split * gd + i] = acc;
      if (d == 0) {
        sp_ml[split * 2 * group + r] = mt;
        sp_ml[split * 2 * group + group + r] = ls;
      }
    }
  }
  if (direct) return;

  // Merge n states (acc at acc_of(k), m and l at ml_of(k)) in order k into
  // dst: m in log2 units, or natural-log units when `final`. The sources
  // come by bulk copy into two staging buffers of C each, the next in
  // flight while this one is summed.
  int done = 0;  // staging rounds of earlier merges: round rr uses buffer rr & 1
  constexpr int EPT = (MAX_GROUP * D / 4 + THREADS - 1) / THREADS;  // float4s per thread
  auto merge = [&](int n, auto acc_of, auto ml_of, float* dst_acc, float* dst_m, float* dst_l,
                   bool final) {
    const int pbytes = gd * 4, gd4 = gd / 4;
    const int C = (P::BODY - P::SCRATCH) / 2 / pbytes;
    const int rounds = (n + C - 1) / C, r0 = done;
    uint8_t* staging = smem + P::SCRATCH;
    auto issue = [&](int r) {
      const int nr = min(C, n - r * C), b = (r0 + r) & 1;
      mbar_arrive_expect_tx(&staged[b], nr * pbytes);
      for (int i = 0; i < nr; ++i)
        bulk_load(staging + (b * C + i) * pbytes, acc_of(r * C + i), pbytes, &staged[b]);
    };
    if (threadIdx.x == 0) {
      fence_proxy_async_global();  // the sources other CTAs wrote, acquired by the caller
      issue(0);
      if (rounds > 1) issue(1);
    }
    // meanwhile every source's (m, l), read past L1; the row maxima; and
    // each source's weight in place of its m
    for (int i = threadIdx.x; i < n * 2 * group; i += THREADS)
      ml[i] = __ldcg(ml_of(i / (2 * group)) + i % (2 * group));
    __syncthreads();
    if (threadIdx.x < group) {
      float mt = -INFINITY;
      for (int k = 0; k < n; ++k) mt = fmaxf(mt, ml[k * 2 * group + threadIdx.x]);
      row_m[threadIdx.x] = mt;  // a live source's max is finite
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * group; i += THREADS) {
      float* x = ml + (i / group) * 2 * group + i % group;
      *x = exp2f(*x - row_m[i % group]);
    }
    __syncthreads();
    float4 av[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) av[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < rounds; ++r) {
      const int b = (r0 + r) & 1;
      mbar_wait(&staged[b], ((r0 + r) >> 1) & 1);
      const float4* buf = reinterpret_cast<const float4*>(staging + b * C * pbytes);
      for (int i = 0; i < min(C, n - r * C); ++i) {
        const float* wk = ml + (r * C + i) * 2 * group;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const int f = threadIdx.x + e * THREADS;
          if (f < gd4) {
            const float4 x = buf[i * gd4 + f];
            const float w = wk[4 * f / D];
            av[e].x += x.x * w;
            av[e].y += x.y * w;
            av[e].z += x.z * w;
            av[e].w += x.w * w;
          }
        }
      }
      __syncthreads();  // every thread has read buffer b
      if (threadIdx.x == 0 && r + 2 < rounds) issue(r + 2);
    }
    done += rounds;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int f = threadIdx.x + e * THREADS;
      if (f < gd4) reinterpret_cast<float4*>(dst_acc)[f] = av[e];
    }
    if (threadIdx.x < group) {
      float ls = 0.f;
      for (int k = 0; k < n; ++k)
        ls += ml[k * 2 * group + group + threadIdx.x] * ml[k * 2 * group + threadIdx.x];
      dst_m[threadIdx.x] = final ? row_m[threadIdx.x] * LN2 : row_m[threadIdx.x];
      dst_l[threadIdx.x] = ls;
    }
  };

  // ---- two levels, each in a fixed order: the last split of a group to
  // arrive merges the group's live splits in split order; the last group
  // to arrive merges the live groups in group order ----
  __threadfence();
  fence_proxy_async();  // the warps' states, before staging copies overwrite them
  if (g_count > 1) {
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(&cnt[1 + grp], 1) == g_count - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const int k0 = gstart[gi];
    const bool final = n_groups == 1;
    merge(
        g_count, [&](int k) { return sp_acc + (size_t)list[k0 + k] * gd; },
        [&](int k) { return sp_ml + list[k0 + k] * 2 * group; },
        final ? acc_out : gp_acc + (size_t)grp * gd, final ? m_out : gp_ml + grp * 2 * group,
        final ? l_out : gp_ml + grp * 2 * group + group, final);
    if (threadIdx.x == 0) cnt[1 + grp] = 0;  // every split of the group has arrived
    if (final) return;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&cnt[0], 1) == n_groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // a group of one live split is that split's partial
  auto one = [&](int k) { return gstart[k + 1] - gstart[k] == 1; };
  merge(
      n_groups,
      [&](int k) { return one(k) ? sp_acc + (size_t)list[gstart[k]] * gd : gp_acc + (size_t)gid[k] * gd; },
      [&](int k) { return one(k) ? sp_ml + list[gstart[k]] * 2 * group : gp_ml + gid[k] * 2 * group; },
      acc_out, m_out, l_out, true);
  if (threadIdx.x == 0) cnt[0] = 0;  // every group has arrived
}

// [B * KV, S, D] row-major, boxes of [LINE bytes, BK rows], swizzled by
// LINE bytes (128 or 64); rows past S read as zeros
template <int D, bool INT8>
bool map_cache(CUtensorMap* m, const void* ptr, int S, int n_bk) {
  typedef Plan<D, INT8> P;
  const int elt = INT8 ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)n_bk};
  const cuuint64_t strides[2] = {(cuuint64_t)P::ROW, (cuuint64_t)S * P::ROW};
  const cuuint32_t box[3] = {(cuuint32_t)(P::LINE / elt), (cuuint32_t)BK, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return encoder()(m, INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(ptr), dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   P::LINE == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool INT8>
int launch_t(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* fl, const void* ds, int write_end,
             void* work, void* counters, void* out, int num_kv, int group, int S) {
  auto kern = decode_gapped_kernel<D, INT8>;
  constexpr int smem = Plan<D, INT8>::SMEM;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!map_cache<D, INT8>(&maps.k, k, S, grid.y) || !map_cache<D, INT8>(&maps.v, v, S, grid.y))
    return (int)cudaErrorInvalidValue;
  static unsigned attr_set = 0;  // per device: above 48 KB of shared memory, opt in once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(attr_set >> dev & 1u)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set |= 1u << dev;
  }
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (1.0f / sqrtf((float)D)) * LOG2E;
  kern<<<grid, THREADS, smem, st>>>(maps, (const bf16*)q, (const float*)ks, (const float*)vs,
                                    (const int*)fl, (const int*)ds, write_end, (float*)work,
                                    (int*)counters, (float*)out, num_kv, group, S, scale_log2,
                                    inv_sqrt_d);
  return (int)cudaGetLastError();
}

template <bool INT8>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* final_len, const void* dec_start, void* work, void* counters, void* out,
           int batch, int num_kv, int group, int S, int D, int write_end, void* stream) {
  const int n_split = (S + SPLIT - 1) / SPLIT;
  if (batch < 1 || num_kv < 1 || group < 1 || group > MAX_GROUP || S < 1 ||
      n_split > MAX_SPLITS || batch * num_kv > 65535)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const dim3 grid(n_split, batch * num_kv);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_t<64, INT8>(grid, st, q, k, v, ks, vs, final_len, dec_start, write_end, work,
                                counters, out, num_kv, group, S);
    case 128:
      return launch_t<128, INT8>(grid, st, q, k, v, ks, vs, final_len, dec_start, write_end,
                                 work, counters, out, num_kv, group, S);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int retake_decode_gapped_bf16(const void* q, const void* k, const void* v,
                                         const void* final_len, const void* dec_start,
                                         void* work, void* counters, void* out, int batch,
                                         int num_kv, int group, int S, int D, int write_end,
                                         void* stream) {
  return launch<false>(q, k, v, nullptr, nullptr, final_len, dec_start, work, counters, out,
                       batch, num_kv, group, S, D, write_end, stream);
}

extern "C" int retake_decode_gapped_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* final_len, const void* dec_start,
                                         void* work, void* counters, void* out, int batch,
                                         int num_kv, int group, int S, int D, int write_end,
                                         void* stream) {
  return launch<true>(q, k, v, k_scale, v_scale, final_len, dec_start, work, counters, out,
                      batch, num_kv, group, S, D, write_end, stream);
}
