// Tensor-core and async-copy helpers shared by the kernels that compute
// fp32-accurate dot products as 3xTF32 split products with mma.sync
// (fused_l2_argmin.cu, and the list scans through scan_common.cuh).
//
// 3xTF32: each operand splits into a = a_hi + a_lo with both parts TF32
// (10 explicit mantissa bits, round to nearest), and
//   a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi          (f32 accumulation)
// drops only a_lo.b_lo and the rounding of the lo parts, ~2^-22 |a||b| a
// product: f32's accuracy within a few ulps. An operand that is exact in
// TF32 (bf16 data) has a_lo = 0, and two products suffice.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

// f32 -> TF32 (round to nearest, ties away from zero), as f32 bits
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// c += a (16 x 8, row-major) * b (8 x 8, col-major), TF32 in, f32 out.
// Fragments, with g = lane / 4 and t = lane % 4:
//   a: (g, t) (g + 8, t) (g, t + 4) (g + 8, t + 4)   [row, k]
//   b: (t, g) (t + 4, g)                              [k, col]
//   c: (g, 2t) (g, 2t + 1) (g + 8, 2t) (g + 8, 2t + 1) [row, col]
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes, bypassing L1 (streamed data), zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes through L1, zero-filled where !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes through L1, zero-filled where !valid (no alignment beyond 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace rtt
