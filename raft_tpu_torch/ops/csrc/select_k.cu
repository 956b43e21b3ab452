// select_k: row-wise top-k (k <= 64), sorted, ties to the lowest position.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:select_k_pallas
// (l.1317, body _select_k_kernel l.155), which merged a running [bm, 128]
// buffer with each score tile by k rounds of min + mask extraction.
//
// Bound on the H100: bytes. Each score is read once (m * len * 4 bytes)
// against a few comparisons per element; at the main path's [500, 8192],
// k = 64 that is 16.4 MB, ~4.9 us at 3.35 TB/s.
//
// Design: one block per row, four warps. Each warp streams its strided
// 32-wide chunks with coalesced loads and keeps a sorted k-buffer in shared
// memory; a chunk element is inserted only when it beats the buffer's
// worst entry (one ballot per chunk filters the rest), so after the first
// few chunks the row streams at load speed. Warp 0 then merges the other
// warps' buffers. Ordering is lexicographic on (value, position), which is
// the TPU kernel's tie rule.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
select_k_kernel(const float* __restrict__ scores, int len, int k, float sign,
                float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float sv[kWarps * rtt::kMaxK];
  __shared__ int si[kWarps * rtt::kMaxK];
  __shared__ int cnts[kWarps];
  const long row = blockIdx.x;
  rtt::block_topk(scores + row * len, len, k, sign, sv, si, cnts);
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    out_v[row * k + s] = sign * sv[s];
    out_i[row * k + s] = si[s];
  }
}

}  // namespace

extern "C" int rtt_select_k(const float* scores, int m, int len, int k,
                            int select_min, float* out_v, int* out_i,
                            void* stream) {
  if (m > 0) {
    select_k_kernel<<<m, kWarps * 32, 0, (cudaStream_t)stream>>>(
        scores, len, k, select_min ? 1.f : -1.f, out_v, out_i);
  }
  return (int)cudaGetLastError();
}
