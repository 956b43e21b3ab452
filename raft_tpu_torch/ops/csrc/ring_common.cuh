// The ring top-k exchange with every rank on one card, shared by
// ring_topk.cu (B7) and ring_lut_scan.cu (B8, its second launch).
//
// A mesh of n ranks lives in one process, all on one card. The query axis
// is cut into n chunks of mc rows; rank c owns chunk c's result. On the
// TPU, chunk c's partial starts at rank (c + 1) mod n and travels the ring
// for n - 1 hops, each rank merging it with its own candidates: the k best
// of incoming ++ local by (key, position in that concatenation), incoming
// before local (the TPU kernel's _extract_topk_block). With every rank on
// one card a hop moves nothing: it only orders the merges. So chunk c's
// result is a chain: rank (c + 1) mod n's k best, then ranks (c + 2) mod n,
// ..., c merged in, in that order. tests/test_torch_parallel.py holds the
// chain against the hop-by-hop schedule (ops/kernels.py:
// _ring_schedule_plain) and the JAX package's interpreted kernel.
//
// One warp per output row (chunk c, row i) walks the chain in registers:
// lane l holds entries l and l + 32 of the running list (k <= 64) and
// entries l and l + 32 of the local row's next 64. A merge is k rounds over
// those four candidates a lane: the lane's best by (key, position), then
// two warp-wide unsigned min reductions (the order key of topk_common.cuh,
// then the position among the lanes holding it) pick the winner, which the
// others read by shuffle. A local row with no entry beating the running
// k-th is skipped by one vote. Keys are minimized (max-select negates on
// load and on store); rows >= m and ids < 0 read as +inf; an output slot
// whose key is infinite carries id -1.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace rtt {

constexpr int kMaxRanks = 16;
constexpr int kChainWarps = 4;             // warps (output rows) a block
constexpr uint32_t kGone = 0xffffffffu;    // a taken or absent entry

struct RankTables {
  const float* keys[kMaxRanks];  // [m, kin] per rank
  const int* ids[kMaxRanks];
};

// A candidate: value (minimized key), id, order key, position.
struct Cand {
  float v;
  int id;
  uint32_t key, pos;
};

__device__ __forceinline__ bool cand_less(const Cand& a, const Cand& b) {
  return a.key < b.key || (a.key == b.key && a.pos < b.pos);
}

__device__ __forceinline__ Cand gone() {
  return {CUDART_INF_F, -1, kGone, kGone};
}

// Merge the four candidates of each lane (running r[0..1], local l[0..1])
// into the k best: k rounds; the result goes back to r with positions kept.
__device__ __forceinline__ void merge_rounds(Cand r[2], Cand l[2], int k,
                                             int lane) {
  Cand out[2] = {gone(), gone()};
  for (int t = 0; t < k; ++t) {
    Cand b = r[0];
    int bi = 0;
    if (cand_less(r[1], b)) b = r[1], bi = 1;
    if (cand_less(l[0], b)) b = l[0], bi = 2;
    if (cand_less(l[1], b)) b = l[1], bi = 3;
    const uint32_t wk = __reduce_min_sync(kFullMask, b.key);
    const uint32_t wp =
        __reduce_min_sync(kFullMask, b.key == wk ? b.pos : kGone);
    const bool win = b.key == wk && b.pos == wp;
    const int src = __ffs(__ballot_sync(kFullMask, win)) - 1;
    const float v = __shfl_sync(kFullMask, b.v, src);
    const int id = __shfl_sync(kFullMask, b.id, src);
    if (win) {
      if (bi == 0) r[0] = gone();
      if (bi == 1) r[1] = gone();
      if (bi == 2) l[0] = gone();
      if (bi == 3) l[1] = gone();
    }
    if (t == lane) out[0] = {v, id, wk, wp};
    if (t == lane + 32) out[1] = {v, id, wk, wp};
  }
  r[0] = out[0];
  r[1] = out[1];
}

// Offer the lanes' candidates l[0..1] to the running list r (k entries at
// most): merged only when one of them beats the running k-th.
__device__ __forceinline__ void offer_cands(Cand r[2], Cand l[2], int k,
                                            int lane) {
  const int kl = (k - 1) & 31;
  const Cand kth = {
      0.f, 0, __shfl_sync(kFullMask, k > 32 ? r[1].key : r[0].key, kl),
      __shfl_sync(kFullMask, k > 32 ? r[1].pos : r[0].pos, kl)};
  const bool beats = cand_less(l[0], kth) || cand_less(l[1], kth);
  if (__any_sync(kFullMask, beats)) merge_rounds(r, l, k, lane);
}

// Chunk c's chain for each padded row w = c * mc + i (one warp each):
// rank q's table row w ([m, kin]) for q = c + 1, ..., c (mod n); out_k /
// out_i [n * mc, k].
__global__ void __launch_bounds__(32 * kChainWarps)
ring_chain_kernel(RankTables t, int n, int m, int mc, int kin, int k,
                  bool select_min, float* __restrict__ out_k,
                  int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kChainWarps + (threadIdx.x >> 5);
  if (w >= n * mc) return;  // whole warps leave together
  const int c = w / mc;
  const long row = (long)c * mc + (w % mc);  // in the padded query axis
  // the running list; step 1 fills it with rank (c + 1) mod n's k best
  Cand r[2] = {gone(), gone()};
  if (row < m) {
    for (int step = 1; step <= n; ++step) {
      const int q = (c + step) % n;
      const float* lk = t.keys[q] + row * kin;
      const int* li = t.ids[q] + row * kin;
      for (int b0 = 0; b0 < kin; b0 += 64) {
        Cand l[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = b0 + lane + 32 * s;
          if (j < kin) {
            const int id = li[j];
            float v = select_min ? lk[j] : -lk[j];
            if (id < 0) v = CUDART_INF_F;
            l[s] = {v, id, order_key(v), (uint32_t)(k + j)};
          } else {
            l[s] = gone();
          }
        }
        offer_cands(r, l, k, lane);
      }
      // the merged list is the next rank's incoming block, in rank order
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (lane + 32 * s < k) r[s].pos = (uint32_t)(lane + 32 * s);
      }
    }
  }
  float* ok = out_k + (size_t)w * k;
  int* oi = out_i + (size_t)w * k;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    if (j < k) {
      const float v = row < m ? r[s].v : CUDART_INF_F;  // pad rows: empty
      const bool inf = isinf(v);
      ok[j] = select_min ? v : (inf ? -CUDART_INF_F : -v);
      oi[j] = inf ? -1 : r[s].id;
    }
  }
}

inline int ring_chain_blocks(int n, int mc) {
  return (n * mc + kChainWarps - 1) / kChainWarps;
}

}  // namespace rtt
