// Warp-level bf16 tensor-core helpers shared by the port's kernels.
//
// One mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Fragment layouts, with
// g = lane / 4 ("group") and t = lane % 4 ("thread in group"):
//   A 16x16 (row-major): a[0] = (row g,   cols 2t, 2t+1)
//                        a[1] = (row g+8, cols 2t, 2t+1)
//                        a[2] = (row g,   cols 2t+8, 2t+9)
//                        a[3] = (row g+8, cols 2t+8, 2t+9)
//   B 16x8 (k x n):      b[0] = (k 2t, 2t+1;   col g)
//                        b[1] = (k 2t+8, 2t+9; col g)
//   C/D 16x8:            c[0], c[1] = (row g,   cols 2t, 2t+1)
//                        c[2], c[3] = (row g+8, cols 2t, 2t+1)
// Each 32-bit register packs two bf16 values, the lower column (or k) in
// the low half. Two adjacent 16x8 accumulators of a score tile are, after
// packing to bf16, exactly the A fragment of the next product (P @ V).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace retake {

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 values as one 32-bit word (address must be 4-aligned)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// reductions over the four threads of a group (lanes sharing g)
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace retake
