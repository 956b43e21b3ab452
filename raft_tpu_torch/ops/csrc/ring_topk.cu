// ring_topk_merge: ring reduce-scatter of per-rank top-k tables over a mesh
// of ranks in one process, all on one card. Rank r holds a local table
// [m, kin] (f32 keys, int32 ids, -1 invalid); the query axis is cut into n
// chunks of mc rows (rows >= m empty); the result for chunk c, which rank c
// owns, is its k best over all ranks, ascending (descending for
// max-select, an empty slot -inf there; an infinite key carries id -1).
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:ring_topk_merge
// (l.1581; body _ring_topk_kernel l.1420, merge _extract_topk_block
// l.988), one persistent program per chip that shipped its running block to
// the right neighbour by async remote DMA, guarded by semaphores.
//
// The ring, unrolled (ring_common.cuh): with every rank on one card a hop
// moves nothing, so chunk c's result is a chain of merges -- rank (c + 1)
// mod n's top-k, then ranks (c + 2) mod n, ..., c merged in, incoming
// before local -- walked by one warp per output row in registers.
//
// Bound on the H100: bytes. The call reads each rank's table once and
// writes the [n, mc, k] result: 450 KB at the sharded path's 4 ranks x
// [500, 10], mc 128, k 10 -- about 0.13 us at 3.35 TB/s. What it costs is
// the launch and the host around it.
//
// Design: one launch per call and no running blocks in device memory. The
// wrapper's former preparation is folded in: rows >= m and ids < 0 read as
// +inf, max-select negates on load and on store. Ranks on several cards
// are not ported (ROADMAP A15): the wrapper refuses them.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ring_common.cuh"

// One call: `tables` holds 2n pointers, rank r's [m, kin] keys at r and
// its ids at n + r, all on card `device`; out_k/out_i are [n, mc, k] (chunk
// c at index c).
extern "C" int rtt_ring_topk_merge(const void* const* tables, int n, int m,
                                   int mc, int kin, int k, int select_min,
                                   void* out_k, void* out_i, int device,
                                   void* stream) {
  if (n < 1 || n > rtt::kMaxRanks || k < 1 || k > rtt::kMaxK || kin < k ||
      mc < 1 || m < 0 || (long)n * mc < m)
    return (int)cudaErrorInvalidValue;
  rtt::RankTables t;
  for (int r = 0; r < n; ++r) {
    t.keys[r] = (const float*)tables[r];
    t.ids[r] = (const int*)tables[n + r];
  }
  // the stream belongs to `device`; switch only when another card is current
  int prev = device;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  rtt::ring_chain_kernel<<<rtt::ring_chain_blocks(n, mc), 32 * rtt::kChainWarps,
                           0, (cudaStream_t)stream>>>(
      t, n, m, mc, kin, k, select_min != 0, (float*)out_k, (int*)out_i);
  e = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}
