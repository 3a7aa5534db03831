// K1: chunked-prefill flash attention over [static KV cache | chunk], with a
// bf16 mode and an int8-KV mode, for Hopper (TMA ring + wgmma).
//
// Replaces the TPU kernel retake_tpu/ops/pallas/flash_prefill.py
// (flash_prefill_attention / _kernel): one prefill chunk's queries [H, S, D]
// attend to the cached prefix (column live iff col < cache_len) and causally
// to the chunk's own keys (live iff j <= i and (j < valid_len or j == i)).
// Online softmax in fp32 on bf16 inputs; out = acc / max(l, 1e-37), bf16.
//
// int8-KV mode (the TPU kernel's quantized mode, flash_prefill.py:137-143):
// cache and chunk K/V are int8 with one fp32 scale per key row. TMA brings
// the int8 tile (half the bytes of bf16); two producer warpgroups read its
// scale rows from global memory (one tile ahead) and dequantize every
// element to bf16(f32(x) * s) with one rounding (no FMA), the TPU kernel's
// numerics (it dequantizes before the dot, it does not commute the scales),
// into a bf16 operand tile in the swizzled layout the wgmma descriptors
// read. The consumers then run the bf16 mode's path on it.
//
// What bounds it on the H100: tensor-core work. FLOPs = 4 * D * H * (S *
// cache_len + live chunk pairs), about 299 GFLOP at 2B heads (H = 12, D =
// 128), S = 2304, cache 20000: 0.303 ms at 989 TFLOP/s bf16; the bytes
// (each K/V byte once) are ~37 MB, 0.011 ms. The design:
//  * one CTA per (query head, block of BQ = 128 query rows); the head
//    index varies fastest, so the G heads of one KV head run side by side
//    and their K/V re-reads hit L2; the longest blocks start first (block
//    y takes rows from (gridDim.y - 1 - y) * BQ);
//  * one producer thread issues TMA loads (cp.async.bulk.tensor) of the Q
//    block once and of 64-key K/V tiles into a ring of STAGES = 4 buffers
//    paced by full / empty mbarriers; 3-D tensor maps over [KV, rows, D]
//    zero-fill rows past the end of a head, 128-byte swizzle for bf16;
//  * two consumer warpgroups of 64 query rows each: S = Q K^T by wgmma
//    m64n64k16 with Q and K from shared memory, then O += P V by wgmma
//    m64nDk16 with P (the fp32 scores packed to bf16) in registers and V
//    read MN-major (transposed) from shared memory; fp32 online softmax with
//    exp2 in registers; setmaxnreg moves registers from the producers. The
//    two warpgroups interleave on the tensor cores (one's softmax beside the
//    other's products); masks are computed only on the tiles that need them
//    (the last cache tile, chunk tiles at the diagonal or the valid length);
//  * int8 mode: the dequantization runs in the producer warpgroups, so the
//    consumers never wait on a barrier for it; int8 -> f32 by an exact
//    byte-into-mantissa trick on the FP32 pipe instead of I2F;
//  * the cache and the chunk come in through separate tensor maps: no
//    [cache | chunk] concatenation; cache_len and valid_len are read from
//    device memory (no host sync, capturable in a CUDA graph); tiles past
//    cache_len and chunk tiles above a warpgroup's diagonal are not
//    computed (above the CTA's diagonal not loaded either), so work follows
//    the fill level, not the budget;
//  * bf16 mode zeroes the V rows past cache_len of the last partial cache
//    tile in shared memory (int8 mode writes them as 0): a masked p = 0
//    still multiplies V;
//  * no split over keys and no atomics: bitwise repeatable.
// The plan is fixed: on the H100 at 2B heads, S = 2304, cache 20000, BQ =
// 64 (one consumer warpgroup) took 1.6x the time of BQ = 128, and 2 ring
// stages the same as 4.
// Plain twin (both modes): retake_tpu_torch/ops/cuda/flash_prefill.py
// flash_prefill_attention_plain; launch_plan there states this plan.

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
using retake::pack_bf16;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;          // keys per tile
constexpr int NCWG = 2;         // consumer warpgroups
constexpr int BQ = 64 * NCWG;   // query rows per CTA
constexpr int STAGES = 4;       // K/V tiles in the TMA ring
constexpr int OPS8 = 3;         // int8 mode: dequantized operand tiles in flight
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16

// byte offsets in dynamic shared memory, after aligning its base to 1024;
// `total` includes that alignment slack.
//  bf16: Q block | STAGES K|V operand tiles (TMA) | mbarriers
//  int8: Q block | STAGES int8 K|V tiles (TMA) | OPS8 bf16 K|V operand
//        tiles (dequantized) | mbarriers
struct Layout {
  int q, raw, raw_bytes, ops, n_ops, op_bytes, bars, total;
};

__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }

__host__ __device__ constexpr Layout layout(int d, bool int8) {
  Layout L{};
  L.q = 0;
  L.raw = BQ * d * 2;
  L.raw_bytes = int8 ? align1k(2 * BK * d) : 0;
  L.ops = L.raw + STAGES * L.raw_bytes;
  L.n_ops = int8 ? OPS8 : STAGES;
  L.op_bytes = 2 * BK * d * 2;  // K then V, bf16, swizzled
  L.bars = L.ops + L.n_ops * L.op_bytes;
  L.total = 1024 + L.bars + 8 * (2 * L.n_ops + 1 + (int8 ? STAGES : 0));
  return L;
}

struct Maps {  // TMA tensor maps [H|KV, rows, D], passed in parameter space
  CUtensorMap q, kc, vc, kn, vn;
};

struct Scales {  // int8 mode: per-key f32 scales, [KV, budget] and [KV, S]
  const float *kc, *vc, *kn, *vn;
};

// byte offset of the 16-byte chunk c (of D / 8) of row r in a swizzled
// [BK, D] bf16 tile stored as D / 64 boxes of [BK, 64]
__device__ __forceinline__ int swz_offset(int r, int c) {
  return (c >> 3) * BK * ROW_BYTES + r * ROW_BYTES + (((c & 7) ^ (r & 7)) << 4);
}

// byte k (0..3) of `biased` (a word of int8 values XOR 0x80808080, so each
// byte holds x + 128) as the float x, exactly: the byte becomes the low
// mantissa bits of 2^23 and the bias comes off in one exact subtraction.
// This keeps the conversion on the FP32 pipe: the CUDA programming guide
// gives sm_90 128 FP32 adds per clock per SM but 16 type conversions, and
// the dequantization converts every K/V element of every tile.
__device__ __forceinline__ float i8_at(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + k)) - 8388736.0f;
}

// 8 int8 values -> 8 bf16 of f32(x) * s, each rounded once
__device__ __forceinline__ uint4 dequant8(uint2 raw, float s) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t biased = (i < 2 ? raw.x : raw.y) ^ 0x80808080u;
    const int k = (i & 1) * 2;
    w[i] = pack_bf16(__fmul_rn(i8_at(biased, k), s), __fmul_rn(i8_at(biased, k + 1), s));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 2^x on the SFU, flushing denormal results to 0 (a p that small adds
// nothing at bf16): one instruction where exp2f adds a denormal fix-up
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One producer thread's share of an int8 K|V tile (NPT producer threads):
// thread `tid` takes 16-byte operand chunk c = tid % (D / 8) of rows
// tid / (D / 8) + k * ROWS_PER for k < ITEMS. Its scales come from global
// memory one tile ahead.
template <int D, int NPT>
struct Deq {
  static constexpr int CH = D / 8;             // 16-byte bf16 chunks per row
  static constexpr int ROWS_PER = NPT / CH;    // rows one pass of NPT threads covers
  static constexpr int ITEMS = BK / ROWS_PER;  // passes per tile

  // this thread's K and V scales of the tile at `base` (0 past `limit`)
  static __device__ __forceinline__ void load_scales(float (&ks)[ITEMS], float (&vs)[ITEMS],
                                                     const float* kg, const float* vg,
                                                     int base, int limit, int tid) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = tid / CH + k * ROWS_PER;
      const bool live = base + r < limit;
      ks[k] = live ? kg[r] : 0.f;
      vs[k] = live ? vg[r] : 0.f;
    }
  }

  // int8 tile (K rows then V rows) -> bf16 K|V operand tiles, swizzled;
  // rows at or past `limit` become 0. All loads first, then the math.
  static __device__ __forceinline__ void tile(const uint8_t* src, const float (&ks)[ITEMS],
                                              const float (&vs)[ITEMS], uint8_t* dst, int base,
                                              int limit, int tid) {
    const int c = tid % CH;
    uint2 kr[ITEMS], vr[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = tid / CH + k * ROWS_PER;
      kr[k] = *reinterpret_cast<const uint2*>(src + r * D + c * 8);
      vr[k] = *reinterpret_cast<const uint2*>(src + BK * D + r * D + c * 8);
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = tid / CH + k * ROWS_PER;
      const bool live = base + r < limit;
      const int off = swz_offset(r, c);
      *reinterpret_cast<uint4*>(dst + off) =
          live ? dequant8(kr[k], ks[k]) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dst + BK * D * 2 + off) =
          live ? dequant8(vr[k], vs[k]) : make_uint4(0, 0, 0, 0);
    }
  }
};

// int8 mode: two producer warpgroups (TMA + dequantization), bf16 mode one
template <bool INT8>
__host__ __device__ constexpr int producer_wgs() {
  return INT8 ? 2 : 1;
}

template <int D, bool INT8>
__global__ void __launch_bounds__(128 * (NCWG + producer_wgs<INT8>()), 1)
    flash_prefill_kernel(const __grid_constant__ Maps maps, const Scales scales,
                         const int* __restrict__ cache_len_p,
                         const int* __restrict__ valid_len_p, bf16* __restrict__ out,
                         int group, int S, int budget, float scale_log2) {
  constexpr int NBOX = D / 64;
  constexpr int NCT = 128 * NCWG;                   // consumer threads
  constexpr int NPT = 128 * producer_wgs<INT8>();  // producer threads
  typedef Deq<D, NPT> Dq;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  constexpr Layout L = layout(D, INT8);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // operand tile ready
  uint64_t* empty = full + L.n_ops;                              // operand tile consumed
  uint64_t* qfull = empty + L.n_ops;
  uint64_t* raw_full = qfull + 1;  // int8: TMA'd int8 tile ready

  const int head = blockIdx.x;
  const int kvh = head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest blocks first
  const int cache_len = min(*cache_len_p, budget);
  const int valid_len = *valid_len_p;
  const int n_cache = (cache_len + BK - 1) / BK;
  const int n_tiles = n_cache + min(q0 + BQ - 1, S - 1) / BK + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.n_ops; ++s) {
      mbar_init(&full[s], INT8 ? NPT / 32 : 1);  // the producer warps, or the TMA thread
      mbar_init(&empty[s], 4 * NCWG);     // lane 0 of every consumer warp
    }
    mbar_init(qfull, 1);
    if (INT8)
      for (int s = 0; s < STAGES; ++s) mbar_init(&raw_full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * NCWG) {
    // ---- producer warpgroups: thread 0 issues every TMA load; in int8
    // mode all NPT threads dequantize each tile into an operand tile ----
    setmaxnreg_dec<INT8 ? 56 : 72>();
    const int ptid = threadIdx.x - NCT;
    if (ptid == 0) {
      mbar_arrive_expect_tx(qfull, BQ * D * 2);
#pragma unroll
      for (int b = 0; b < NBOX; ++b)
        tma_load_3d(smem + L.q + b * BQ * ROW_BYTES, &maps.q, qfull, b * 64, q0, head);
    }
    if constexpr (INT8) {
      auto issue = [&](int it) {  // int8 tile `it` into raw stage it % STAGES
        const bool in_cache = it < n_cache;
        const int base = (in_cache ? it : it - n_cache) * BK;
        uint8_t* st = smem + L.raw + (it % STAGES) * L.raw_bytes;
        uint64_t* bar = &raw_full[it % STAGES];
        mbar_arrive_expect_tx(bar, 2 * BK * D);
        tma_load_3d(st, in_cache ? &maps.kc : &maps.kn, bar, 0, base, kvh);
        tma_load_3d(st + BK * D, in_cache ? &maps.vc : &maps.vn, bar, 0, base, kvh);
      };
      if (ptid == 0)
        for (int it = 0; it < min(STAGES, n_tiles); ++it) issue(it);
      // this thread's scales of the next tile, loaded while the current
      // one is dequantized
      auto scales_of = [&](int it, float (&ks)[Dq::ITEMS], float (&vs)[Dq::ITEMS]) {
        const bool in_cache = it < n_cache;
        const int base = (in_cache ? it : it - n_cache) * BK;
        const size_t srow = (size_t)kvh * (in_cache ? budget : S) + base;
        Dq::load_scales(ks, vs, (in_cache ? scales.kc : scales.kn) + srow,
                            (in_cache ? scales.vc : scales.vn) + srow, base,
                            in_cache ? cache_len : S, ptid);
      };
      float ks[Dq::ITEMS], vs[Dq::ITEMS], ks_next[Dq::ITEMS], vs_next[Dq::ITEMS];
      scales_of(0, ks_next, vs_next);
      for (int it = 0; it < n_tiles; ++it) {
        const int rs = it % STAGES, os = it % OPS8;
        const bool in_cache = it < n_cache;
        const int base = (in_cache ? it : it - n_cache) * BK;
#pragma unroll
        for (int k = 0; k < Dq::ITEMS; ++k) {
          ks[k] = ks_next[k];
          vs[k] = vs_next[k];
        }
        if (it + 1 < n_tiles) scales_of(it + 1, ks_next, vs_next);
        mbar_wait(&raw_full[rs], (it / STAGES) & 1);
        mbar_wait(&empty[os], ((it / OPS8) & 1) ^ 1);
        Dq::tile(smem + L.raw + rs * L.raw_bytes, ks, vs, smem + L.ops + os * L.op_bytes,
                     base, in_cache ? cache_len : S, ptid);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[os]);
        named_barrier(2, NPT);  // raw stage rs read by every producer thread
        if (ptid == 0 && it + STAGES < n_tiles) issue(it + STAGES);
      }
    } else if (ptid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(&empty[stage], phase ^ 1);
        const bool in_cache = it < n_cache;
        const int base = (in_cache ? it : it - n_cache) * BK;
        uint8_t* st = smem + L.ops + stage * L.op_bytes;
        const CUtensorMap* km = in_cache ? &maps.kc : &maps.kn;
        const CUtensorMap* vm = in_cache ? &maps.vc : &maps.vn;
        mbar_arrive_expect_tx(&full[stage], 2 * BK * D * 2);
#pragma unroll
        for (int b = 0; b < NBOX; ++b) {
          tma_load_3d(st + b * BK * ROW_BYTES, km, &full[stage], b * 64, base, kvh);
          tma_load_3d(st + BK * D * 2 + b * BK * ROW_BYTES, vm, &full[stage], b * 64, base, kvh);
        }
        if (++stage == L.n_ops) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<INT8 ? 200 : 208>();
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int wg_first = q0 + wg * 64, wg_last = wg_first + 63;
    const int row0 = wg_first + (warp & 3) * 16 + g;
    const int rows[2] = {row0, row0 + 8};
    const uint32_t q_addr = smem_addr(smem + L.q) + wg * 64 * ROW_BYTES;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the log2-scaled scores
    float l[2] = {0.f, 0.f};

    mbar_wait(qfull, 0);
    int slot = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const bool in_cache = it < n_cache;
      const int base = (in_cache ? it : it - n_cache) * BK;
      mbar_wait(&full[slot], phase);
      uint8_t* tile = smem + L.ops + slot * L.op_bytes;
      if constexpr (!INT8) {
        if (in_cache && base + BK > cache_len) {  // V rows past cache_len -> 0
          for (int i = threadIdx.x; i < BK * (D / 8); i += NCT) {
            const int r = i / (D / 8);
            if (base + r >= cache_len)
              *reinterpret_cast<uint4*>(tile + BK * D * 2 + swz_offset(r, i % (D / 8))) =
                  make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          named_barrier(1, NCT);
        }
      }

      if (in_cache || base <= wg_last) {  // a chunk tile above the diagonal adds nothing
        const uint32_t k_addr = smem_addr(tile), v_addr = k_addr + BK * D * 2;
        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk & 3) * 32;  // 16 columns into the 64-column box
          wgmma_ss_m64n64k16(sc, sw128_desc(q_addr + (kk >> 2) * BQ * ROW_BYTES + koff, 16, 1024),
                             sw128_desc(k_addr + (kk >> 2) * BK * ROW_BYTES + koff, 16, 1024),
                             kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // masks only where some (row, key) of the warpgroup is dead: the
        // last cache tile, and chunk tiles reaching the diagonal or the
        // chunk's valid / total length
        const bool masked = in_cache ? base + BK > cache_len
                                     : (base + BK - 1 > wg_first || base + BK > valid_len ||
                                        base + BK > S);
        if (masked) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int row = rows[(i >> 1) & 1];
            const int j = base + (i >> 2) * 8 + 2 * t + (i & 1);
            const bool live = in_cache ? (j < cache_len)
                                       : (j < S && j <= row && (j < valid_len || j == row));
            if (!live) sc[i] = -INFINITY;
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2], neg_m[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // scale_log2 > 0, so the max of the scaled scores is the scaled max
          const float mnew = fmaxf(m[h], group_max(mx[h]) * scale_log2);
          alpha[h] = mnew == -INFINITY ? 1.f : ex2(m[h] - mnew);
          neg_m[h] = mnew == -INFINITY ? 0.f : -mnew;  // all dead so far: p = exp2(-inf) = 0
          m[h] = mnew;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int h = (i >> 1) & 1;
          const float p = ex2(fmaf(sc[i], scale_log2, neg_m[h]));
          sc[i] = p;
          rs[h] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + group_sum(rs[h]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // P (bf16) @ V: two adjacent 8-key score blocks form one A slice
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = sw128_desc(v_addr + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
          if constexpr (D == 128)
            wgmma_rs_m64n128k16_tb(o, pa[kk], dv, 1);
          else
            wgmma_rs_m64n64k16_tb(o, pa[kk], dv, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == L.n_ops) {
        slot = 0;
        phase ^= 1;
      }
    }

    bf16* oh = out + (size_t)head * S * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= S) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-37f);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<uint32_t*>(oh + (size_t)rows[h] * D + nd * 8 + 2 * t) =
            pack_bf16(o[4 * nd + 2 * h] * inv, o[4 * nd + 2 * h + 1] * inv);
      }
    }
  }
}

// ---- host side: tensor maps through the driver entry point (no -lcuda) ----

// [heads, rows, d] row-major, boxes of [box_rows, box_cols]; 128-byte swizzle
// for bf16 operand tiles, none for int8 staging tiles
bool map3d(CUtensorMap* m, const void* ptr, bool int8, int d, int rows, int heads, int box_cols,
           int box_rows) {
  const int elt = int8 ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elt, (cuuint64_t)rows * d * elt};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return encoder()(m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(ptr), dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool INT8>
int launch_t(const Maps& maps, const Scales& scales, const void* cache_len,
             const void* valid_len, void* out, int heads, int group, int S, int budget,
             float scale_log2, cudaStream_t st) {
  auto kern = flash_prefill_kernel<D, INT8>;
  constexpr int smem = layout(D, INT8).total;  // above 48 KB: opt in
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(heads, (S + BQ - 1) / BQ);
  kern<<<grid, 128 * (NCWG + producer_wgs<INT8>()), smem, st>>>(
      maps, scales, (const int*)cache_len, (const int*)valid_len, (bf16*)out, group, S, budget,
      scale_log2);
  return (int)cudaGetLastError();
}

template <bool INT8>
int launch(const void* q, const void* kc, const void* vc, const void* kn, const void* vn,
           const void* kcs, const void* vcs, const void* kns, const void* vns,
           const void* cache_len, const void* valid_len, void* out, int num_kv, int group,
           int S, int budget, int D, void* stream) {
  if ((D != 64 && D != 128) || num_kv < 1 || group < 1 || S < 1 || budget < 1)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const int heads = num_kv * group;
  bool ok = map3d(&maps.q, q, false, D, S, heads, 64, BQ);
  if (INT8) {
    ok = ok && map3d(&maps.kc, kc, true, D, budget, num_kv, D, BK) &&
         map3d(&maps.vc, vc, true, D, budget, num_kv, D, BK) &&
         map3d(&maps.kn, kn, true, D, S, num_kv, D, BK) &&
         map3d(&maps.vn, vn, true, D, S, num_kv, D, BK);
  } else {
    ok = ok && map3d(&maps.kc, kc, false, D, budget, num_kv, 64, BK) &&
         map3d(&maps.vc, vc, false, D, budget, num_kv, 64, BK) &&
         map3d(&maps.kn, kn, false, D, S, num_kv, 64, BK) &&
         map3d(&maps.vn, vn, false, D, S, num_kv, 64, BK);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const Scales scales = {(const float*)kcs, (const float*)vcs, (const float*)kns,
                         (const float*)vns};
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_t<64, INT8>(maps, scales, cache_len, valid_len, out, heads, group, S, budget,
                              scale_log2, st);
  return launch_t<128, INT8>(maps, scales, cache_len, valid_len, out, heads, group, S, budget,
                             scale_log2, st);
}

}  // namespace

extern "C" int retake_flash_prefill_bf16(const void* q, const void* kc, const void* vc,
                                         const void* kn, const void* vn, const void* cache_len,
                                         const void* valid_len, void* out, int num_kv, int group,
                                         int S, int budget, int D, void* stream) {
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
