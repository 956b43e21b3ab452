// Warp-cooperative sorted top-k buffers (k <= 64) shared by the select_k,
// gather_refine and grouped_scan kernels.
//
// A buffer is a sorted run of (value, position) pairs in shared memory.
// Order is lexicographic on (value, position): the smaller value wins, and
// among equal values the lower position wins -- the tie rule of the TPU
// kernels (their argmin extraction picks the first minimum).
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

// Insert (v, i) into the sorted buffer (sv, si) of `cnt` entries and
// capacity k. Every lane of the warp calls it with the same (v, i).
// Returns the new count.
__device__ __forceinline__ int warp_insert(float* sv, int* si, int cnt, int k,
                                           float v, int i, int lane) {
  __syncwarp();
  if (cnt == k && !key_less(v, i, sv[k - 1], si[k - 1])) return cnt;
  int p = 0;
  for (int s = lane; s < cnt; s += 32) p += key_less(sv[s], si[s], v, i) ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(kFullMask, p, o);
  const int nc = cnt < k ? cnt + 1 : k;
  float rv[2];
  int ri[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s = lane + 32 * j;
    if (s > p && s < nc) {
      rv[j] = sv[s - 1];
      ri[j] = si[s - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s = lane + 32 * j;
    if (s > p && s < nc) {
      sv[s] = rv[j];
      si[s] = ri[j];
    }
  }
  if (lane == 0) {
    sv[p] = v;
    si[p] = i;
  }
  __syncwarp();
  return nc;
}

// One 32-wide chunk offered to the sorted buffer (sv, si) of `cnt` entries:
// lane l offers (v, pos) when `in`; the entries that beat the buffer's
// last one (or fill it) are inserted. Every lane of the warp calls it.
// Returns the new count.
__device__ __forceinline__ int warp_offer(float v, int pos, bool in, int k,
                                          float* sv, int* si, int cnt, int lane) {
  __syncwarp();
  const bool full = cnt == k;
  const float tv = full ? sv[k - 1] : CUDART_INF_F;
  const int ti = full ? si[k - 1] : 0x7fffffff;
  const bool pred = in && (!full || key_less(v, pos, tv, ti));
  unsigned m = __ballot_sync(kFullMask, pred);
  while (m) {
    const int src_lane = __ffs(m) - 1;
    m &= m - 1;
    const float vv = __shfl_sync(kFullMask, v, src_lane);
    const int pp = __shfl_sync(kFullMask, pos, src_lane);
    cnt = warp_insert(sv, si, cnt, k, vv, pp, lane);
  }
  return cnt;
}

// One warp scans src[pos] for pos = first, first + stride, ... (stride a
// multiple of 32, lane-strided inside each 32-wide chunk) and keeps the k
// smallest of sign * src[pos] in (sv, si). Returns the count kept.
__device__ __forceinline__ int warp_scan_topk(const float* src, int len, int k,
                                              float sign, int first, int stride,
                                              float* sv, int* si, int lane) {
  int cnt = 0;
  for (int base = first; base < len; base += stride) {
    const int pos = base + lane;
    const bool in = pos < len;
    const float v = in ? sign * src[pos] : 0.f;
    cnt = warp_offer(v, pos, in, k, sv, si, cnt, lane);
  }
  return cnt;
}

// Block-wide top-k of sign * src[0:len]: each warp keeps a local buffer
// over its strided chunks, then warp 0 merges the others into its own.
// `sv`/`si` hold n_warps * kMaxK slots, `cnts` n_warps ints. On return
// (after a __syncthreads) warp 0's buffer, sv[0:k]/si[0:k], is the result
// and cnts[0] its count, readable by every thread.
__device__ __forceinline__ int block_topk(const float* src, int len, int k,
                                          float sign, float* sv, int* si,
                                          int* cnts) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* wv = sv + warp * kMaxK;
  int* wi = si + warp * kMaxK;
  int cnt = warp_scan_topk(src, len, k, sign, warp * 32, n_warps * 32, wv, wi, lane);
  if (lane == 0) cnts[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < n_warps; ++w) {
      const int cw = cnts[w];
      for (int j = 0; j < cw; ++j) {
        const float v = sv[w * kMaxK + j];
        const int i = si[w * kMaxK + j];
        if (cnt == k && !key_less(v, i, wv[k - 1], wi[k - 1])) break;  // sorted: the rest lose too
        cnt = warp_insert(wv, wi, cnt, k, v, i, lane);
      }
    }
    if (lane == 0) cnts[0] = cnt;
  }
  __syncthreads();
  return cnt;
}

}  // namespace rtt
