// K2: PivotKV eviction scores, bf16 in, fp32 out.
//
// Replaces the TPU kernel retake_tpu/ops/pallas/pivot_scores.py
// (pivot_score_sums / _kernel): per KV head, the column sums over valid
// query rows of softmax_row(q_s k_s^T / sqrt(d)), keys >= valid_len masked,
// non-causal, chunk-local. Output [KV, S] fp32; the caller divides the sum
// over KV heads by KV*G and applies keypatch / padding.
//
// What bounds it on the H100: the S x S softmax (2*S*S*D*H flops per pass,
// about 16 GFLOP at S=2304 and 12 heads) and its exponentials. The TPU kernel
// held a whole [G*BQ, S] fp32 logit block (9 MB) in VMEM; a Hopper block has
// at most 227 KB of shared memory, so this kernel recomputes instead:
//  * pass 1 sweeps the key tiles once for each row's max and sum (registers);
//  * pass 2 recomputes the logits, normalizes p and sums it down each column:
//    within a warp by shuffles, across the G warps (query heads) through
//    shared memory in a fixed order;
//  * every 16-row query tile writes its column sums to its own row of a
//    partials buffer, and a second launch adds those rows in order. There is
//    no atomicAdd: the sums, and with them top-k ties and the kept token set,
//    are identical from run to run.
// Plain twin: retake_tpu_torch/ops/cuda/pivot_scores.py pivot_score_sums_plain.

#include <math.h>

#include "mma.cuh"

namespace {

using retake::group_max;
using retake::group_sum;
using retake::load_pair;
using retake::mma_bf16_16816;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;
constexpr int MAX_GROUP = 16;

template <int D>
__device__ __forceinline__ void tile_scores(float sc[BK / 8][4],
                                            const uint32_t qa[D / 16][4],
                                            const bf16* ks, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
    sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    const bf16* krow = ks + (nb * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2] = {load_pair(krow + kk * 16), load_pair(krow + kk * 16 + 8)};
      mma_bf16_16816(sc[nb], qa[kk], b);
    }
  }
}

template <int D>
__global__ void pivot_partials_kernel(
    const bf16* __restrict__ q,  // [H, S, D]
    const bf16* __restrict__ k,  // [KV, S, D]
    const int* __restrict__ valid_len_p,
    float* __restrict__ partial,  // [KV, n_qtiles, S]
    int group, int S, float scale_log2) {
  constexpr int KSTEPS = D / 16;
  constexpr int NB_K = BK / 8;
  constexpr int LD = D + 8;
  constexpr int VEC = 8;
  __shared__ __align__(16) bf16 ks[BK * LD];
  __shared__ float colsum[MAX_GROUP][BK];

  const int kvh = blockIdx.y;
  const int qt = blockIdx.x, n_qtiles = gridDim.x;
  const int q0 = qt * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int head = kvh * group + warp;
  const int valid_len = min(*valid_len_p, S);
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
  const bf16* kh = k + (size_t)kvh * S * D;
  const int n_tiles = (valid_len + BK - 1) / BK;  // tiles of masked keys skipped

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)  // padding query rows contribute no mass
        inv_l[h] = rows[h] < valid_len ? 1.f / fmaxf(l[h], 1e-37f) : 0.f;
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int base = it * BK;
      __syncthreads();
      for (int i = threadIdx.x; i < BK * (D / VEC); i += blockDim.x) {
        const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
        uint4 kv4 = make_uint4(0, 0, 0, 0);
        if (base + r < valid_len)
          kv4 = *reinterpret_cast<const uint4*>(kh + (size_t)(base + r) * D + c);
        *reinterpret_cast<uint4*>(ks + r * LD + c) = kv4;
      }
      __syncthreads();

      float sc[NB_K][4];
      tile_scores<D>(sc, qa, ks, g, t);
#pragma unroll
      for (int nb = 0; nb < NB_K; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = base + nb * 8 + 2 * t + (e & 1);
          sc[nb][e] = j < valid_len ? sc[nb][e] * scale_log2 : -INFINITY;
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
          if (mnew != -INFINITY) {
#pragma unroll
            for (int nb = 0; nb < NB_K; ++nb)
              rs += exp2f(sc[nb][2 * h] - mnew) + exp2f(sc[nb][2 * h + 1] - mnew);
          }
          rs = group_sum(rs);
          l[h] = (mnew == -INFINITY ? l[h] : l[h] * exp2f(m[h] - mnew)) + rs;
          m[h] = mnew;
        }
      } else {
        // column sums of p * inv_l over this warp's 16 rows
#pragma unroll
        for (int nb = 0; nb < NB_K; ++nb) {
          float c0 = 0.f, c1 = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (m[h] != -INFINITY) {
              c0 += exp2f(sc[nb][2 * h] - m[h]) * inv_l[h];
              c1 += exp2f(sc[nb][2 * h + 1] - m[h]) * inv_l[h];
            }
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, off);
            c1 += __shfl_xor_sync(0xffffffffu, c1, off);
          }
          if (g == 0) {
            colsum[warp][nb * 8 + 2 * t] = c0;
            colsum[warp][nb * 8 + 2 * t + 1] = c1;
          }
        }
        __syncthreads();
        // fixed-order sum over the G query heads of this KV head
        for (int c = threadIdx.x; c < BK; c += blockDim.x) {
          if (base + c < S) {
            float acc = 0.f;
            for (int w = 0; w < group; ++w) acc += colsum[w][c];
            partial[((size_t)kvh * n_qtiles + qt) * S + base + c] = acc;
          }
        }
      }
    }
  }
}

__global__ void pivot_reduce_kernel(const float* __restrict__ partial,
                                    const int* __restrict__ valid_len_p,
                                    float* __restrict__ out,  // [KV, S]
                                    int n_qtiles, int S) {
  const int kvh = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= S) return;
  const int valid_len = *valid_len_p;
  float acc = 0.f;
  if (c < valid_len) {
    const float* p = partial + (size_t)kvh * n_qtiles * S + c;
    for (int i = 0; i < n_qtiles; ++i) acc += p[(size_t)i * S];
  }
  out[(size_t)kvh * S + c] = acc;
}

}  // namespace

extern "C" int retake_pivot_scores_bf16(const void* q, const void* k,
                                        const void* valid_len, void* partial,
                                        void* out, int num_kv, int group,
                                        int S, int D, void* stream) {
  if (group > MAX_GROUP) return (int)cudaErrorInvalidValue;
  const int n_qtiles = (S + 15) / 16;
  const dim3 grid(n_qtiles, num_kv);
  const dim3 block(32 * group);
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      pivot_partials_kernel<64><<<grid, block, 0, st>>>(
          (const bf16*)q, (const bf16*)k, (const int*)valid_len,
          (float*)partial, group, S, scale_log2);
      break;
    case 128:
      pivot_partials_kernel<128><<<grid, block, 0, st>>>(
          (const bf16*)q, (const bf16*)k, (const int*)valid_len,
          (float*)partial, group, S, scale_log2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pivot_reduce_kernel<<<dim3((S + 255) / 256, num_kv), 256, 0, st>>>(
      (const float*)partial, (const int*)valid_len, (float*)out, n_qtiles, S);
  return (int)cudaGetLastError();
}
