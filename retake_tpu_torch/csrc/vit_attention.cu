// K3: Qwen2-VL ViT attention with the 2-D rotary fused in, bf16, for Hopper
// (TMA ring + wgmma).
//
// Replaces the TPU kernel retake_tpu/ops/pallas/vit_attention.py
// (vit_attention_qkv / _qkv_kernel). Per temporal slice t and head n: rotary
// on q and k in fp32 (rotate_half), cast to bf16, full bidirectional softmax
// over the S = h*w patches in fp32, output bf16. Input: the qkv projection
// output in HEAD-MAJOR column order [T, S, N, 3, D] (the port reorders the
// projection's weight columns once, when the VisionTower is built), cos /
// sin [S, D] fp32; output [T, S, N*D]. D = 64 or 80, any S >= 1.
//
// What bounds it on the H100: per (t, n) the S x S scores and P.V, 4 * S^2 *
// D operations (217 GFLOP at T = 128, S = 576, N = 16, D = 80: 0.220 ms at
// 989 TFLOP/s), next to 755 MB of qkv in and output out (0.2255 ms at 3.35
// TB/s). The cost to avoid is work and traffic repeated per query block:
// every CTA of a (t, n) needs all S rotated keys. The design:
//  * one CTA per (block of BQ = 192 query rows, n, t), the query block
//    fastest: 576 = 3 x 192, so a 448x252 frame's (t, n) is three CTAs that
//    run side by side and share their K, V and table reads in L2;
//  * one pass over the keys with an fp32 online softmax (ex2.approx and one
//    FFMA per score); p is rounded to bf16 before P.V and out = acc / l, the
//    TPU's K1 order (its K3 normalizes first; the plain twin keeps that);
//  * one producer warpgroup: thread 0 brings raw 64-key K rows and their cos
//    / sin rows by TMA into a ring of RAW_STAGES staging buffers, and V by
//    TMA straight into the 32-byte-swizzled operand layout; all 128 threads
//    rotate each key once per CTA (fp32, products and sum each rounded, no
//    FMA contraction, one bf16 rounding) into the 128-byte-swizzled K-major
//    operand tile, 4 channels and their partners a thread, consecutive
//    threads on consecutive table bytes (no bank conflicts), fence the async
//    proxy and arrive on the tile's full barrier. OP_STAGES operand tiles
//    are paced by full / empty mbarriers;
//  * D = 80 is wider than one 128-byte swizzle span: K is a 64-column box
//    and a 16-column box in the 128-byte layout (48 columns unused), k-steps
//    0-3 read the first, k-step 4 the second; V is five 16-column boxes in
//    the 32-byte layout, which one m64n80k16 descriptor covers (lbo = the box
//    stride). D = 64 is one K box and four V boxes;
//  * three consumer warpgroups of 64 query rows: each rotates its rows once
//    into registers as the wgmma A fragment, then S = Q K^T by wgmma
//    m64n64k16 (A in registers, K K-major from shared memory) and O += P V by
//    wgmma m64nDk16 (P in registers, V MN-major); setmaxnreg moves registers
//    from the producer to the consumers;
//  * edges: only the last key tile is masked (S % 64 != 0); TMA zero-fills
//    K, V and table rows past S (a masked p = 0 still multiplies V); query
//    rows past S are neither loaded nor stored, and a warpgroup whose rows
//    all lie past S only keeps the ring's pace;
//  * no split over keys and no atomics: bitwise repeatable.
// The plan is fixed. On the H100 at the main-path shape, these were timed
// and not kept: 3 raw and 2 operand stages (slower), V as two 64-column
// 128-byte-swizzled boxes read by one n = 80 product, query
// rows rotated by the producer from the key tiles' own table rows, a
// persistent grid, P V of tile i - 1 in flight with Q K^T of tile i (all
// slower), and sharing the table rows of a tile across a cluster of heads
// by TMA multicast (slower as the cluster grew).
// Plain twin: retake_tpu_torch/ops/cuda/vit_attention.py
// vit_attention_qkv_plain; launch_plan there states this plan.

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
constexpr int NCWG = 3;         // consumer warpgroups
constexpr int BQ = 64 * NCWG;   // query rows per CTA
constexpr int RAW_STAGES = 2;   // raw K | cos | sin tiles in flight (TMA)
constexpr int OP_STAGES = 3;    // rotated K | V operand tiles in flight
constexpr int ROW_BYTES = 128;  // one 128-byte-swizzled row: 64 bf16
constexpr int VBOX = 16;        // V columns per 32-byte-swizzled box

// byte offsets in dynamic shared memory, after aligning its base to 1024;
// `total` includes that alignment slack.
//  RAW_STAGES x [raw K rows bf16 | cos rows f32 | sin rows f32]
//  OP_STAGES x [rotated K, ceil(D / 64) boxes of 64 x 128 B | V, D / 16
//               boxes of 64 x 32 B] | mbarriers
struct Layout {
  int raw, raw_bytes, ops, k_bytes, v_bytes, op_bytes, bars, total;
};

__host__ __device__ constexpr Layout layout(int d) {
  Layout L{};
  L.raw = 0;
  L.raw_bytes = BK * d * 2 + 2 * BK * d * 4;
  L.ops = RAW_STAGES * L.raw_bytes;
  L.k_bytes = (d + 63) / 64 * BK * ROW_BYTES;
  L.v_bytes = d / VBOX * BK * 32;
  L.op_bytes = L.k_bytes + L.v_bytes;
  L.bars = L.ops + OP_STAGES * L.op_bytes;
  L.total = 1024 + L.bars + 8 * (RAW_STAGES + 2 * OP_STAGES);
  return L;
}

struct Maps {  // TMA tensor maps, passed in parameter space
  CUtensorMap k, v;      // [T, S, N, D] views of the qkv input (4-D)
  CUtensorMap cos, sin;  // [S, D] f32
};

// byte offset of channel c (a multiple of 4) of row r in a [BK, D] bf16
// tile stored as ceil(D / 64) 128-byte-swizzled boxes of [BK, 64]: its
// 16-byte chunk c / 8 moves to chunk (c / 8 % 8) ^ (r % 8) of the row
__device__ __forceinline__ int swz_offset(int r, int c) {
  return (c >> 6) * BK * ROW_BYTES + r * ROW_BYTES + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// 2^x on the SFU, flushing denormal results to 0 (a p that small adds
// nothing at bf16)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rotate_half rotary of one channel pair (c, c + D/2) in fp32, products and
// sum each rounded once (no FMA contraction): (lo, hi) before the bf16 cast
__device__ __forceinline__ float2 rope_pair(float xl, float xh, float cl, float sl, float ch,
                                            float sh) {
  return make_float2(__fadd_rn(__fmul_rn(xl, cl), __fmul_rn(-xh, sl)),
                     __fadd_rn(__fmul_rn(xh, ch), __fmul_rn(xl, sh)));
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

// channels c, c + 1 of a row and their partners c + D/2, c + D/2 + 1 (x as
// bf16 pairs, tables as f32 pairs): the rotated pairs, packed bf16
__device__ __forceinline__ void rope2(uint32_t xl, uint32_t xh, float2 cl, float2 sl, float2 ch,
                                      float2 sh, uint32_t& lo, uint32_t& hi) {
  const float2 a = bf16x2_to_float2(xl), b = bf16x2_to_float2(xh);
  const float2 e0 = rope_pair(a.x, b.x, cl.x, sl.x, ch.x, sh.x);
  const float2 e1 = rope_pair(a.y, b.y, cl.y, sl.y, ch.y, sh.y);
  lo = pack_bf16(e0.x, e1.x);
  hi = pack_bf16(e0.y, e1.y);
}

// One raw tile (BK key rows of bf16 k, f32 cos and sin, dense) rotated into
// the swizzled K operand tile by the 128 producer threads. Item i = (row
// i / (D/8), quad i % (D/8)) takes channels 4q .. 4q + 3 and their partners
// D/2 + 4q ..; consecutive threads take consecutive quads, so each read of
// a table row is 128 contiguous bytes per quarter-warp (no bank conflicts).
template <int D>
__device__ __forceinline__ void rotate_tile(const uint8_t* raw, uint8_t* op, int tid) {
  constexpr int QH = D / 8;  // 4-channel quads in half a row
  static_assert(BK * QH % 128 == 0, "whole passes of the 128 producer threads");
  const bf16* xk = reinterpret_cast<const bf16*>(raw);
  const float* cs = reinterpret_cast<const float*>(raw + BK * D * 2);
  const float* sn = cs + BK * D;
#pragma unroll
  for (int k = 0; k < BK * QH / 128; ++k) {
    const int i = tid + 128 * k;
    const int r = i / QH, c = 4 * (i % QH);
    const uint2 xl = *reinterpret_cast<const uint2*>(xk + r * D + c);
    const uint2 xh = *reinterpret_cast<const uint2*>(xk + r * D + D / 2 + c);
    const float4 cl = *reinterpret_cast<const float4*>(cs + r * D + c);
    const float4 ch = *reinterpret_cast<const float4*>(cs + r * D + D / 2 + c);
    const float4 sl = *reinterpret_cast<const float4*>(sn + r * D + c);
    const float4 sh = *reinterpret_cast<const float4*>(sn + r * D + D / 2 + c);
    uint2 lo, hi;
    rope2(xl.x, xh.x, make_float2(cl.x, cl.y), make_float2(sl.x, sl.y), make_float2(ch.x, ch.y),
          make_float2(sh.x, sh.y), lo.x, hi.x);
    rope2(xl.y, xh.y, make_float2(cl.z, cl.w), make_float2(sl.z, sl.w), make_float2(ch.z, ch.w),
          make_float2(sh.z, sh.w), lo.y, hi.y);
    *reinterpret_cast<uint2*>(op + swz_offset(r, c)) = lo;
    *reinterpret_cast<uint2*>(op + swz_offset(r, D / 2 + c)) = hi;
  }
}

template <int D>
__global__ void __launch_bounds__(128 * (NCWG + 1), 1)
    vit_attention_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ qkv,
                         const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                         bf16* __restrict__ out, int S, int N, float scale_log2) {
  constexpr int H2 = D / 16;   // 8-column chunks in half a row
  constexpr int NCH = D / 8;   // 8-column chunks of a row
  constexpr int KSTEPS = D / 16;
  constexpr int NCT = 128 * NCWG;  // consumer threads
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((base_addr + 1023) & ~1023u) - base_addr);
  constexpr Layout L = layout(D);
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + L.bars);  // raw tile landed
  uint64_t* full = raw_full + RAW_STAGES;  // operand tile ready (rotated K and V)
  uint64_t* empty = full + OP_STAGES;      // operand tile consumed

  const int n = blockIdx.y, tt = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < OP_STAGES; ++s) {
      mbar_init(&full[s], 4 + 1);     // the producer warps, and the V TMA's expect_tx
      mbar_init(&empty[s], 4 * NCWG);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * NCWG) {
    // ---- producer warpgroup: thread 0 issues every TMA load; all 128
    // threads rotate each raw K tile into an operand tile ----
    setmaxnreg_dec<72>();
    const int ptid = threadIdx.x - NCT;
    auto issue_raw = [&](int it) {
      uint8_t* st = smem + L.raw + (it % RAW_STAGES) * L.raw_bytes;
      uint64_t* bar = &raw_full[it % RAW_STAGES];
      mbar_arrive_expect_tx(bar, L.raw_bytes);
      tma_load_4d(st, &maps.k, bar, 0, n, it * BK, tt);
      tma_load_2d(st + BK * D * 2, &maps.cos, bar, 0, it * BK);
      tma_load_2d(st + BK * D * 6, &maps.sin, bar, 0, it * BK);
    };
    if (ptid == 0)
      for (int it = 0; it < min(RAW_STAGES, n_tiles); ++it) issue_raw(it);
    for (int it = 0; it < n_tiles; ++it) {
      const int rs = it % RAW_STAGES, os = it % OP_STAGES;
      uint8_t* op = smem + L.ops + os * L.op_bytes;
      mbar_wait(&empty[os], ((it / OP_STAGES) & 1) ^ 1);
      if (ptid == 0) {
        mbar_arrive_expect_tx(&full[os], L.v_bytes);
#pragma unroll
        for (int b = 0; b < D / VBOX; ++b)
          tma_load_4d(op + L.k_bytes + b * BK * 32, &maps.v, &full[os], b * VBOX, n, it * BK, tt);
      }
      mbar_wait(&raw_full[rs], (it / RAW_STAGES) & 1);
      rotate_tile<D>(smem + L.raw + rs * L.raw_bytes, op, ptid);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[os]);
      named_barrier(1, 128);  // raw stage rs read by every producer thread
      if (ptid == 0 && it + RAW_STAGES < n_tiles) issue_raw(it + RAW_STAGES);
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<144>();
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int wg_first = q0 + wg * 64;
    const bool active = wg_first < S;  // else the warpgroup only keeps the ring's pace
    const int row0 = wg_first + (warp & 3) * 16 + g;
    const int rows[2] = {row0, row0 + 8};

    // this thread's rows of Q, rotated once, as the A fragments of the
    // k-steps: columns 8j + 2t, +1 of rows g and g + 8 (j < D / 8); the
    // rotate_half partner of chunk j is chunk j +- D/16, held by this thread.
    // Every fragment is written, zeros where a row lies past S: a fragment
    // left unwritten on some path let ptxas give its registers to P, which
    // the next tile's Q K^T then read as Q (seen at D = 64)
    uint32_t qa[KSTEPS][4];
    const size_t row_stride = (size_t)N * 3 * D;  // one patch's qkv row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t qv[NCH];
#pragma unroll
      for (int j = 0; j < NCH; ++j) qv[j] = 0u;
      if (active && rows[h] < S) {
        const bf16* x = qkv + ((size_t)tt * S + rows[h]) * row_stride + (size_t)n * 3 * D + 2 * t;
        const float* c = cos_t + (size_t)rows[h] * D + 2 * t;
        const float* s = sin_t + (size_t)rows[h] * D + 2 * t;
        uint32_t xv[NCH];
#pragma unroll
        for (int j = 0; j < NCH; ++j) xv[j] = *reinterpret_cast<const uint32_t*>(x + 8 * j);
#pragma unroll
        for (int j = 0; j < H2; ++j)
          rope2(xv[j], xv[j + H2], *reinterpret_cast<const float2*>(c + 8 * j),
                *reinterpret_cast<const float2*>(s + 8 * j),
                *reinterpret_cast<const float2*>(c + 8 * (j + H2)),
                *reinterpret_cast<const float2*>(s + 8 * (j + H2)), qv[j], qv[j + H2]);
      }
#pragma unroll
      for (int j = 0; j < NCH; ++j) qa[j >> 1][(j & 1) * 2 + h] = qv[j];
    }

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the log2-scaled scores
    float l[2] = {0.f, 0.f};

    int slot = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      mbar_wait(&full[slot], phase);
      if (active) {
        const uint32_t k_addr = smem_addr(smem + L.ops + slot * L.op_bytes);
        const uint32_t v_addr = k_addr + L.k_bytes;
        float sc[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
        fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) fence_regs(qa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)  // 16 columns of box kk / 4 at byte (kk % 4) * 32
          wgmma_rs_m64n64k16(sc, qa[kk],
                             sw128_desc(k_addr + (kk >> 2) * BK * ROW_BYTES + (kk & 3) * 32, 16,
                                        1024),
                             kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) fence_regs(qa[kk]);

        const int base = i * BK;
        if (base + BK > S) {  // the last tile, keys past S
#pragma unroll
          for (int e = 0; e < BK / 2; ++e)
            if (base + (e >> 2) * 8 + 2 * t + (e & 1) >= S) sc[e] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        // key 0 lives in the first tile, so every row's max is finite from
        // there on and the first alpha = exp2(-inf) = 0 only clears zeros
        float alpha[2], neg_m[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // scale_log2 > 0, so the max of the scaled scores is the scaled max
          const float mnew = fmaxf(m[h], group_max(mx[h]) * scale_log2);
          alpha[h] = ex2(m[h] - mnew);
          neg_m[h] = -mnew;
          m[h] = mnew;
        }
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int h = (e >> 1) & 1;
          const float p = ex2(fmaf(sc[e], scale_log2, neg_m[h]));
          sc[e] = p;
          rs[h] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + group_sum(rs[h]);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

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
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // 16 key rows of 32 bytes per k-step; lbo = the 16-column box stride
          const uint64_t dv = sw32_desc(v_addr + kk * 16 * 32, BK * 32, 256);
          if constexpr (D == 80)
            wgmma_rs_m64n80k16_tb(o, pa[kk], dv, 1);
          else
            wgmma_rs_m64n64k16_tb(o, pa[kk], dv, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == OP_STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }

    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= S) continue;
        const float inv = 1.f / l[h];
        bf16* orow = out + ((size_t)tt * S + rows[h]) * N * D + (size_t)n * D + 2 * t;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
          *reinterpret_cast<uint32_t*>(orow + nd * 8) =
              pack_bf16(o[4 * nd + 2 * h] * inv, o[4 * nd + 2 * h + 1] * inv);
      }
    }
  }
}

// ---- host side: tensor maps through the driver entry point (no -lcuda) ----

// a row-major tensor of `rank` dims (innermost first) with byte strides of
// the outer dims, read in boxes of `box` elements
bool encode(CUtensorMap* m, CUtensorMapDataType type, int rank, const void* ptr,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return encoder()(m, type, rank, const_cast<void*>(ptr), dims, strides, box, es,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_t(const bf16* qkv, const float* cos_t, const float* sin_t, bf16* out, int T, int S,
             int N, cudaStream_t st) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  // k and v of slice t, patch s, head n as 4-D [T, S, N, D] views of qkv
  // (coordinates d, n, s, t); a box is BK patches of one head; coordinates
  // past S (and, for V's boxes, past D) read as zeros
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)T};
  const cuuint64_t strides[3] = {(cuuint64_t)3 * D * 2, (cuuint64_t)N * 3 * D * 2,
                                 (cuuint64_t)S * N * 3 * D * 2};
  const cuuint32_t kbox[4] = {(cuuint32_t)D, 1, BK, 1};
  const cuuint32_t vbox[4] = {VBOX, 1, BK, 1};
  const cuuint64_t tdims[2] = {(cuuint64_t)D, (cuuint64_t)S};
  const cuuint64_t tstrides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t tbox[2] = {(cuuint32_t)D, BK};
  const bool ok =
      encode(&maps.k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qkv + D, dims, strides, kbox,
             CU_TENSOR_MAP_SWIZZLE_NONE) &&
      encode(&maps.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qkv + 2 * D, dims, strides, vbox,
             CU_TENSOR_MAP_SWIZZLE_32B) &&
      encode(&maps.cos, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, cos_t, tdims, tstrides, tbox,
             CU_TENSOR_MAP_SWIZZLE_NONE) &&
      encode(&maps.sin, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, sin_t, tdims, tstrides, tbox,
             CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = vit_attention_kernel<D>;
  constexpr int smem = layout(D).total;  // above 48 KB: opt in
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  const dim3 grid((S + BQ - 1) / BQ, N, T);
  kern<<<grid, 128 * (NCWG + 1), smem, st>>>(maps, qkv, cos_t, sin_t, out, S, N, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int retake_vit_attention_bf16(const void* qkv, const void* cos_t, const void* sin_t,
                                         void* out, int T, int S, int N, int D, void* stream) {
  if ((D != 64 && D != 80) || T < 1 || T > 65535 || S < 1 || N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* x = (const bf16*)qkv;
  const float *c = (const float*)cos_t, *s = (const float*)sin_t;
  if (D == 64) return launch_t<64>(x, c, s, (bf16*)out, T, S, N, st);
  return launch_t<80>(x, c, s, (bf16*)out, T, S, N, st);
}
