// gather_refine_topk: exact re-rank of each query's C candidate rows with a
// top-k (k <= 64) kept on chip; the [m, C, d] gather buffer never exists.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:gather_refine_topk
// (l.1176, body _gather_refine_kernel l.1038, merge _extract_topk_block
// l.988), which streamed candidate rows HBM->VMEM through per-row DMAs.
//
// Keys follow raft_tpu/neighbors/refine.py:_refine_rows exactly:
//   l2  : max(|q|^2 + |r|^2 - 2<q, r>, 0)      (callers apply sqrt)
//   ip  : -<q, r>                              (callers negate back)
//   cos : 1 - <q, r> / (sqrt(max(|q|^2, 1e-30)) * sqrt(max(|r|^2, 1e-30)))
// Ids < 0 are invalid (key +inf, id -1); other ids are clipped to
// [0, n - 1] for the fetch, as the TPU kernel clips its DMA addresses.
//
// Bound on the H100: bytes. The m * C candidate rows are a random gather
// (m * C * d * 4 bytes); at the main path's [500, 400] x 96 f32 that is
// 76.8 MB, ~23 us at 3.35 TB/s. The arithmetic is 4 FLOPs per element.
//
// Design: one block per query, four warps. A warp takes one candidate row
// at a time: its 32 lanes read the row with coalesced loads (d = 96 is
// three floats a lane) and reduce <q, r> and |r|^2 by shuffles, so each
// row costs one or two 128-byte transactions per lane group. The keys go
// to shared memory and the block's warps select the top-k with the same
// lexicographic (key, candidate position) order as select_k: ties go to
// the earliest candidate, as in the TPU kernel's extraction merge.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(rtt::kFullMask, v, o);
  return v;
}

// dynamic shared memory: q [d] f32, keys [C] f32
__global__ void __launch_bounds__(kWarps * 32)
gather_refine_kernel(const float* __restrict__ data, long n, int d,
                     const float* __restrict__ queries,
                     const int* __restrict__ cand, int C, int k, int metric,
                     float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* q = smem;
  float* keys = smem + d;
  __shared__ float sv[kWarps * rtt::kMaxK];
  __shared__ int si[kWarps * rtt::kMaxK];
  __shared__ int cnts[kWarps];

  const long row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < d; j += blockDim.x) q[j] = queries[row * d + j];
  __syncthreads();

  float qsq = 0.f;
  for (int j = lane; j < d; j += 32) qsq = fmaf(q[j], q[j], qsq);
  qsq = warp_sum(qsq);

  const int* crow = cand + row * C;
  for (int c = warp; c < C; c += kWarps) {
    const int id = crow[c];
    long r = id < 0 ? 0 : (long)id;
    if (r > n - 1) r = n - 1;
    const float* xr = data + r * d;
    float s = 0.f, rsq = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = __ldg(xr + j);
      s = fmaf(q[j], v, s);
      rsq = fmaf(v, v, rsq);
    }
    s = warp_sum(s);
    rsq = warp_sum(rsq);
    float key;
    if (metric == 1) {
      key = -s;
    } else if (metric == 2) {
      const float qn = sqrtf(fmaxf(qsq, 1e-30f));
      const float cn = sqrtf(fmaxf(rsq, 1e-30f));
      key = 1.f - s / (qn * cn);
    } else {
      key = fmaxf(qsq + rsq - 2.f * s, 0.f);
    }
    if (id < 0) key = CUDART_INF_F;
    if (lane == 0) keys[c] = key;
  }
  __syncthreads();

  rtt::block_topk(keys, C, k, 1.f, sv, si, cnts);
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    const float v = s < cnts[0] ? sv[s] : CUDART_INF_F;
    out_v[row * k + s] = v;
    out_i[row * k + s] = (v == CUDART_INF_F) ? -1 : crow[si[s]];
  }
}

}  // namespace

// metric: 0 l2 (squared), 1 inner product, 2 cosine.
extern "C" int rtt_gather_refine_topk(const float* data, long n, int d,
                                      const float* queries, const int* cand,
                                      int m, int C, int k, int metric,
                                      float* out_v, int* out_i, void* stream) {
  const size_t smem = (size_t)(d + C) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gather_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (m > 0) {
    gather_refine_kernel<<<m, kWarps * 32, smem, (cudaStream_t)stream>>>(
        data, n, d, queries, cand, C, k, metric, out_v, out_i);
  }
  return (int)cudaGetLastError();
}
