// The top-k order shared by the kernels that select (select_k, the ring
// kernels, and select_common.cuh's gather_refine and grouped_scan):
// lexicographic on (value, position): the smaller value wins, and among
// equal values the lower position wins -- the tie rule of the TPU kernels
// (their argmin extraction picks the first minimum).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rtt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxK = 64;  // two buffer slots per lane

__device__ __forceinline__ bool key_less(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// Unsigned image of a float whose order is a stable ascending sort's:
// -0.0 and +0.0 map to one key (they tie, so position decides), and every
// NaN maps to one key above +inf (torch.sort puts NaN last).
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return v != v ? 0xffffff00u : u;
}

}  // namespace rtt
