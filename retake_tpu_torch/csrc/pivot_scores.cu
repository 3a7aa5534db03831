// K2: PivotKV eviction scores, bf16 in, fp32 out, for Hopper (two TMA ring +
// wgmma launches and a fixed-order merge).
//
// Replaces the TPU kernel retake_tpu/ops/pallas/pivot_scores.py
// (pivot_score_sums / _kernel): per KV head, the column sums over valid
// query rows of softmax_row(q_s k_s^T / sqrt(d)), keys >= valid_len masked,
// non-causal, chunk-local. Output [KV, S] fp32, 0 at columns >= valid_len;
// the caller divides the sum over KV heads by KV*G and applies keypatch /
// padding.
//
// What bounds it on the H100, per pass over the S x S logits of H heads:
//  * operations: 2*D*H*S^2 for Q K^T, 16.3 GFLOP at 2B heads (H = 12,
//    D = 128, S = 2304), 0.0165 ms at 989 TFLOP/s bf16; 38.1 GFLOP, 0.0385
//    ms at 7B heads (H = 28);
//  * exponentials: H*S^2, 63.7 M at 2B (148.6 M at 7B); the special-
//    function units give 16 ex2 a clock per SM (~4.2 T/s over 132 SMs at
//    1.98 GHz): ~0.015 ms a pass at 2B, as long as the product at D = 128.
// The TPU kernel held the whole [G*BQ, S] fp32 logit strip (9 MB) in VMEM
// and needed one pass. A Hopper CTA has 227 KB of shared memory, so this
// kernel recomputes: two products and two exponential passes, a floor of
// ~0.033 ms at 2B with the tensor cores and the SFUs running side by side.
// The design:
//  * launch 1 (row statistics): one CTA per (query head, 128 query rows),
//    head index fastest (the G heads of a KV head share their K tiles in
//    L2). One producer thread brings the CTA's Q block once and 128-key K
//    tiles by TMA (3-D maps over [H | KV, S, D], 128-byte swizzle, zero fill
//    past S) through a STAGES-deep full / empty mbarrier ring; two consumer
//    warpgroups of 64 query rows compute S = Q K^T by wgmma m64n128k16 with
//    both operands in shared memory. Each thread keeps an online max and
//    sum (exp2, log2(e) folded into the scale) over its own columns and the
//    four threads of a row merge once at the end: no shuffle per tile. Key
//    tiles at or past valid_len are not loaded. The row's log2-sum-exp goes
//    to a [H, S_pad] fp32 workspace; rows at or past valid_len get +inf, so
//    they add exactly 0 below, and blocks that hold only such rows do
//    nothing else;
//  * launch 2 (column sums, keys on the M side): one CTA per (query head,
//    128 keys, KV head), head index fastest. The producer brings the CTA's K
//    block once, then the head's query rows as 128-row Q tiles with their
//    128 row statistics (one 1-D bulk copy) through the ring. S^T = K Q^T by
//    wgmma m64n128k16, p = exp2(s*c - lse2[row]), and a column sum of the
//    softmax is a row sum of the accumulator: thread-local adds on every
//    tile and one quad shuffle at the end, no per-tile shuffle or
//    __syncthreads tail. Each CTA writes its 128 sums to a second [H, S_pad]
//    workspace;
//  * launch 3 adds the G heads' sums of each key in head order and writes
//    the output (0 past valid_len). No atomics: every sum has a fixed order,
//    so two calls give bitwise-equal scores (PivotKV's kept set depends on
//    it). The workspaces are kept per device and size by the wrapper, so a
//    call allocates nothing but its output;
//  * launches 1 and 2: 2 x 64-row consumer warpgroups + one producer warp,
//    2 CTAs an SM (at most 96 registers a thread; 2 ring stages of 128 rows
//    keep two CTAs within the SM's shared memory at D = 128). Grids at
//    S = 2304: 12 x 18 and 6 x 18 x 2 = 216 CTAs each at 2B heads (0.82 of
//    one wave of 264), 28 x 18 and 7 x 18 x 4 = 504 at 7B heads (1.91 waves);
//  * tried on the H100 and slower (PERF.md, §6): the G heads merged
//    through distributed shared memory in one cluster of G CTAs per key
//    block (at 7B heads clusters of 7 fill the GPCs' CTA slots badly, and
//    the column launch took far longer than launch 1 for the same work);
//    the fixed rows as register A fragments with 64-row tiles and
//    m64n64k16 (the products ran well below the tensor-core peak); the
//    same with each tile split into two 32-row halves so that one half's
//    exponentials overlap the other's product (m64n32k16, slower again);
//    four consumer warpgroups a CTA (no faster);
//  * valid_len is read from device memory (no host sync; capturable in a
//    CUDA graph), and work follows it: key tiles, query tiles and key blocks
//    wholly at or past it are skipped.
// Plain twin: retake_tpu_torch/ops/cuda/pivot_scores.py
// pivot_score_sums_plain; launch_plan there states this plan.

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
typedef __nv_bfloat16 bf16;

constexpr int NCWG = 2;                    // consumer warpgroups
constexpr int BQ = 64 * NCWG;              // rows of the fixed operand per CTA
constexpr int BN = 128;                    // rows of one streamed tile
constexpr int STAGES = 2;                  // tiles in the TMA ring
constexpr int NTHREADS = 128 * NCWG + 32;  // + one producer warp
constexpr int MAX_GROUP = 16;
constexpr int ROW_BYTES = 128;
constexpr int MERGE_THREADS = 256;  // launch 3: keys per CTA
static_assert(BN == BQ, "one TMA box shape serves the fixed blocks and the streamed tiles");

// byte offsets in dynamic shared memory, after aligning its base to 1024;
// `total` includes that slack. The fixed BQ-row block (swizzled bf16) |
// STAGES streamed tiles (the same) | STAGES x BN f32 row statistics
// (launch 2) | mbarriers (full and empty per stage, one for the block)
struct Layout {
  int fixed, tiles, tile_bytes, lse, bars, total;
};

__host__ __device__ constexpr Layout layout(int d) {
  Layout L{};
  L.fixed = 0;
  L.tiles = BQ * d * 2;
  L.tile_bytes = BN * d * 2;
  L.lse = L.tiles + STAGES * L.tile_bytes;
  L.bars = L.lse + STAGES * BN * 4;
  L.total = 1024 + L.bars + 8 * (2 * STAGES + 1);
  return L;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[64 x BN] = (this warpgroup's 64 rows of the fixed block) . tile^T,
// both K-major in the swizzled layout (D / 64 boxes of [rows, 64])
template <int D>
__device__ __forceinline__ void product(float (&acc)[BN / 2], uint32_t rows, uint32_t tile) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n128k16(acc, sw128_desc(rows + (kk >> 2) * BQ * ROW_BYTES + (kk & 3) * 32, 16, 1024),
                        sw128_desc(tile + (kk >> 2) * BN * ROW_BYTES + (kk & 3) * 32, 16, 1024),
                        kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// D / 64 TMA boxes of 128 rows (BQ = BN) from `row` of head `head` into `dst`
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row, int head) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b) tma_load_3d(dst + b * BN * ROW_BYTES, map, bar, b * 64, row, head);
}

// barriers: full[s] (one producer arrival + the TMA bytes), empty[s] (lane
// 0 of every consumer warp), fixed_full (the fixed block's TMA)
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, uint64_t* fixed_full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NCWG);
    }
    mbar_init(fixed_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw_base) {
  const uint32_t raw = smem_addr(raw_base);
  return raw_base + (((raw + 1023) & ~1023u) - raw);
}

// ---- launch 1: log2-sum-exp of every query row ------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
    row_stats_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap qmap, const int* __restrict__ valid_len_p,
                     float* __restrict__ lse2, int group, int S, int s_pad, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  constexpr Layout L = layout(D);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* fixed_full = empty + STAGES;

  const int head = blockIdx.x, kvh = head / group;
  const int q0 = blockIdx.y * BQ;
  const int valid_len = max(0, min(*valid_len_p, S));
  float* out = lse2 + (size_t)head * s_pad + q0;
  if (q0 >= valid_len) {  // padding rows only: +inf, they add 0 in launch 2
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) out[i] = INFINITY;
    return;
  }
  const int n_tiles = (valid_len + BN - 1) / BN;
  init_ring(full, empty, fixed_full);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * NCWG) {
    if (lane == 0) {  // producer: this CTA's Q block, then K tiles of its KV head
      mbar_arrive_expect_tx(fixed_full, BQ * D * 2);
      load_tile<D>(smem + L.fixed, &qmap, fixed_full, q0, head);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], BN * D * 2);
        load_tile<D>(smem + L.tiles + s * L.tile_bytes, &kmap, &full[s], it * BN, kvh);
      }
    }
    return;
  }

  // consumers: 64 query rows per warpgroup
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r_local = wg * 64 + (warp & 3) * 16 + g;
  const bool live = q0 + wg * 64 < valid_len;  // the warpgroup holds a valid row
  const uint32_t rows = smem_addr(smem + L.fixed) + wg * 64 * ROW_BYTES;
  mbar_wait(fixed_full, 0);
  float m[2] = {-INFINITY, -INFINITY};  // this thread's max of its scaled logits
  float l[2] = {0.f, 0.f};              // and its sum of exp2(logit - m)
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    float acc[BN / 2];
    if (live) product<D>(acc, rows, smem_addr(smem + L.tiles + s * L.tile_bytes));
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (!live) continue;
    const int base = it * BN;
    if (base + BN > valid_len) {  // the tile reaching valid_len: mask dead keys
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if (base + (i >> 2) * 8 + 2 * t + (i & 1) >= valid_len) acc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
    float neg_m[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // scale_log2 > 0, so the max of the scaled logits is the scaled max
      const float mnew = fmaxf(m[h], mx[h] * scale_log2);
      alpha[h] = mnew == -INFINITY ? 1.f : ex2(m[h] - mnew);
      neg_m[h] = mnew == -INFINITY ? 0.f : -mnew;  // all dead so far: p = exp2(-inf) = 0
      m[h] = mnew;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) rs[(i >> 1) & 1] += ex2(fmaf(acc[i], scale_log2, neg_m[(i >> 1) & 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
  }
  // merge the four threads of each row, in a fixed butterfly
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mrow = group_max(m[h]);
    const float lrow = group_sum(mrow == -INFINITY ? 0.f : l[h] * ex2(m[h] - mrow));
    const int r = r_local + 8 * h;
    if (t == 0) out[r] = q0 + r < valid_len ? mrow + log2f(lrow) : INFINITY;
  }
}

// ---- launch 2: one query head's share of the column sums --------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
    col_sums_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const float* __restrict__ lse2, const int* __restrict__ valid_len_p,
                    float* __restrict__ part, int group, int S, int s_pad, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  constexpr Layout L = layout(D);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* fixed_full = empty + STAGES;

  const int kvh = blockIdx.z, k0 = blockIdx.y * BQ;
  const int head = kvh * group + blockIdx.x;
  const int valid_len = max(0, min(*valid_len_p, S));
  if (k0 >= valid_len) return;  // dead keys: launch 3 writes 0 without reading
  const int n_tiles = (valid_len + BN - 1) / BN;  // query tiles past valid_len add 0
  const float* lse_h = lse2 + (size_t)head * s_pad;
  init_ring(full, empty, fixed_full);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * NCWG) {
    if (lane == 0) {  // producer: this CTA's K block, then Q tiles of this head
                      // and their statistics
      mbar_arrive_expect_tx(fixed_full, BQ * D * 2);
      load_tile<D>(smem + L.fixed, &kmap, fixed_full, k0, kvh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], BN * D * 2 + BN * 4);
        load_tile<D>(smem + L.tiles + s * L.tile_bytes, &qmap, &full[s], it * BN, head);
        bulk_load(smem + L.lse + s * BN * 4, lse_h + it * BN, BN * 4, &full[s]);
      }
    }
    return;
  }

  // consumers: 64 keys per warpgroup
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r_local = wg * 64 + (warp & 3) * 16 + g;
  const bool live = k0 + wg * 64 < valid_len;  // the warpgroup holds a live key
  const uint32_t rows = smem_addr(smem + L.fixed) + wg * 64 * ROW_BYTES;
  mbar_wait(fixed_full, 0);
  float cs[2] = {0.f, 0.f};  // this thread's share of its two keys' column sums
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (live) {
      float acc[BN / 2];
      product<D>(acc, rows, smem_addr(smem + L.tiles + s * L.tile_bytes));
      // the statistics of query rows 8j + 2t, + 1
      const float2* ls = reinterpret_cast<const float2*>(smem + L.lse + s * BN * 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 lse = ls[4 * j + t];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cs[e >> 1] += ex2(fmaf(acc[4 * j + e], scale_log2, -((e & 1) ? lse.y : lse.x)));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float c = group_sum(cs[h]);
    if (t == 0) part[(size_t)head * s_pad + k0 + r_local + 8 * h] = c;
  }
}

// ---- launch 3: the G heads' shares of each key, added in head order --------------

__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const float* __restrict__ part, const int* __restrict__ valid_len_p,
                 float* __restrict__ out, int group, int S, int s_pad) {
  const int kvh = blockIdx.y, key = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (key >= S) return;
  const int valid_len = *valid_len_p;
  float sum = 0.f;
  if (key < valid_len) {
    const float* p = part + (size_t)kvh * group * s_pad + key;
    for (int h = 0; h < group; ++h) sum += p[(size_t)h * s_pad];
  }
  out[(size_t)kvh * S + key] = sum;
}

// ---- host side ----------------------------------------------------------------

// [heads, rows, d] bf16 row-major, boxes of [BN rows, 64 columns], 128-byte swizzle
bool map3d(CUtensorMap* m, const void* ptr, int d, int rows, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, BN, 1};  // BN = BQ: streamed tiles and fixed blocks
  const cuuint32_t es[3] = {1, 1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                   box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_t(const CUtensorMap& qmap, const CUtensorMap& kmap, const void* valid_len, float* lse2, float* part, float* out, int num_kv, int group,
             int S, cudaStream_t st) {
  constexpr int smem = layout(D).total;  // above 48 KB: opt in
  const int s_pad = (S + BQ - 1) / BQ * BQ;
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  cudaError_t e = cudaFuncSetAttribute(row_stats_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(col_sums_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  row_stats_kernel<D><<<dim3(num_kv * group, s_pad / BQ), NTHREADS, smem, st>>>(
      kmap, qmap, (const int*)valid_len, lse2, group, S, s_pad, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  col_sums_kernel<D><<<dim3(group, s_pad / BQ, num_kv), NTHREADS, smem, st>>>(
      qmap, kmap, lse2, (const int*)valid_len, part, group, S, s_pad, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<dim3((S + MERGE_THREADS - 1) / MERGE_THREADS, num_kv), MERGE_THREADS, 0, st>>>(
      part, (const int*)valid_len, out, group, S, s_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// q [H, S, D], k [KV, S, D] bf16; valid_len one int32 on the device;
// workspace 2 x [H, ceil(S / 128) * 128] f32 (the row statistics, then each
// head's column sums); out [KV, S] f32
extern "C" int retake_pivot_scores_bf16(const void* q, const void* k, const void* valid_len,
                                        void* workspace, void* out, int num_kv, int group, int S,
                                        int D, void* stream) {
  if ((D != 64 && D != 128) || num_kv < 1 || group < 1 || group > MAX_GROUP || S < 1)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qmap, kmap;
  memset(&qmap, 0, sizeof(qmap));
  memset(&kmap, 0, sizeof(kmap));
  if (!map3d(&qmap, q, D, S, num_kv * group) || !map3d(&kmap, k, D, S, num_kv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* lse2 = (float*)workspace;
  float* part = lse2 + (size_t)num_kv * group * ((S + BQ - 1) / BQ * BQ);
  if (D == 64)
    return launch_t<64>(qmap, kmap, valid_len, lse2, part, (float*)out, num_kv, group, S, st);
  return launch_t<128>(qmap, kmap, valid_len, lse2, part, (float*)out, num_kv, group, S, st);
}
