// ring_topk_merge: ring reduce-scatter of per-rank top-k tables over a mesh
// of ranks in one process. Rank r holds a local table [n * mc, kin] (keys
// minimized, +inf empty; ids int32, -1 invalid), chunk c being rows
// [c * mc, (c + 1) * mc); after n - 1 hops rank r holds chunk r's k best
// over all ranks, ascending.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:ring_topk_merge
// (l.1581; body _ring_topk_kernel l.1420, merge _extract_topk_block
// l.988). The TPU kernel was one persistent program per chip that shipped
// its running block to the right neighbour by async remote DMA, guarded by
// semaphores. Here the ring is one launch per hop (the TPU kernel's
// `serial` schedule) over every rank of the mesh, all on one card (grid
// axis y over ranks), and each block reads its left neighbour's running
// block through the pointer table. Ranks on several cards (peer pointers
// over NVLink) are not ported yet. The hop order and the per-hop slots are
// set out in ring_common.cuh.
//
// Bound on the H100: bytes. Per hop and rank the kernel reads the incoming
// [mc, k] block and the local [mc, kin] chunk and writes one [mc, k] block
// (f32 keys + i32 ids): 2.2 MB a hop at mc 128, k 64, 4 ranks -- ~1 us at
// 3.35 TB/s, so a launch's fixed cost (a few us) is what the kernel costs.
// A persistent kernel with flag-based flow control (the TPU kernel's
// semaphores) is later work.
//
// Design: one warp per query row, four rows per block. The warp loads the
// incoming row (already sorted: positions 0..k-1) into the sorted k-buffer
// of topk_common.cuh and offers the local row's entries at positions
// k + j, 32 at a time, so the buffer ends as the (key, position) k best of
// incoming ++ local -- the TPU kernel's merge. Ids are looked up from the
// winning positions when the row is written.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "ring_common.cuh"

namespace {

constexpr int kWarps = 4;

struct RingTables {
  const float* loc_k[rtt::kMaxRanks];  // [n * mc, kin] per rank
  const int* loc_i[rtt::kMaxRanks];
  float* run_k[rtt::kMaxRanks];        // [n, mc, k] per rank
  int* run_i[rtt::kMaxRanks];
};

__global__ void __launch_bounds__(32 * kWarps)
ring_topk_hop_kernel(RingTables t, int n, int mc, int kin, int k, int hop) {
  __shared__ float sv[kWarps][rtt::kMaxK];
  __shared__ int si[kWarps][rtt::kMaxK];
  const int r = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= mc) return;  // whole warps leave together
  float* bv = sv[warp];
  int* bi = si[warp];
  const int c = rtt::ring_chunk(r, hop, n);
  int cnt = 0;
  const float* ik = nullptr;
  const int* ii = nullptr;
  if (hop >= 0) {
    const int left = rtt::ring_mod(r - 1, n);
    const size_t in_off = ((size_t)hop * mc + row) * k;
    ik = t.run_k[left] + in_off;
    ii = t.run_i[left] + in_off;
    cnt = rtt::ring_load_incoming(ik, k, bv, bi, lane);
  }
  const size_t loc_off = ((size_t)c * mc + row) * kin;
  const float* lk = t.loc_k[r] + loc_off;
  const int* li = t.loc_i[r] + loc_off;
  for (int base = 0; base < kin; base += 32) {
    const int j = base + lane;
    const float v = j < kin ? lk[j] : CUDART_INF_F;
    cnt = rtt::warp_offer(v, k + j, v < CUDART_INF_F, k, bv, bi, cnt, lane);
  }
  const size_t out_off = ((size_t)(hop + 1) * mc + row) * k;
  rtt::ring_store(bv, bi, cnt, k, t.run_k[r] + out_off, t.run_i[r] + out_off,
                  [&](int pos) { return pos < k ? ii[pos] : li[pos - k]; },
                  lane);
}

}  // namespace

// One hop (hop = -1: the start) for the n ranks, all on card `device`, on
// `stream`. loc_*/run_* are tables of n pointers, one per rank.
extern "C" int rtt_ring_topk_hop(const void* const* loc_k,
                                 const void* const* loc_i, void* const* run_k,
                                 void* const* run_i, int n, int mc, int kin,
                                 int k, int hop, int device, void* stream) {
  if (n < 1 || n > rtt::kMaxRanks || k < 1 || k > rtt::kMaxK || kin < 1 ||
      mc < 1 || hop < -1 || hop > n - 2)
    return (int)cudaErrorInvalidValue;
  RingTables t;
  for (int r = 0; r < n; ++r) {
    t.loc_k[r] = (const float*)loc_k[r];
    t.loc_i[r] = (const int*)loc_i[r];
    t.run_k[r] = (float*)run_k[r];
    t.run_i[r] = (int*)run_i[r];
  }
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  dim3 grid((mc + kWarps - 1) / kWarps, n);
  ring_topk_hop_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      t, n, mc, kin, k, hop);
  e = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)e;
}
