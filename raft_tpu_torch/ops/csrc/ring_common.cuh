// The ring top-k exchange's per-hop device code of ring_lut_scan.cu (B8);
// ring_topk.cu (B7), which walks each chunk's merge chain in one launch,
// takes only its rank limit.
//
// A mesh of n ranks lives in one process, all on one card; each rank owns
// a running block run[r] = [n][mc][k] (keys ascending, ids; one slot per
// hop). Chunk c's partial starts at rank (c + 1) mod n and travels the ring
// for n - 1 hops; at hop s (0 .. n-2) rank r reads the incoming partial from
// slot s of its left neighbour r - 1, merges it with its own candidates for
// chunk (r - s - 2) mod n, and writes slot s + 1 of its own block. Before
// hop 0 (hop = -1) every rank writes slot 0 with its own candidates for
// chunk (r - 1) mod n. After hop n - 2, slot n - 1 of rank r holds chunk r
// fully merged. A hop is one launch, so a neighbour's slot is complete
// before it is read; it is read through the pointer table passed with the
// launch.
//
// Merge order (the TPU kernel's _extract_topk_block over incoming ++
// local): ascending key, ties to the lower position in the concatenation
// incoming-then-local. Keys are minimized (the wrapper negates for
// max-select); +inf marks an empty slot; an output slot whose key is
// infinite carries id -1.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_common.cuh"

namespace rtt {

constexpr int kMaxRanks = 16;

__device__ __forceinline__ int ring_mod(int a, int n) { return ((a % n) + n) % n; }

// The chunk rank r merges at `hop` (-1: the chunk it starts).
__device__ __forceinline__ int ring_chunk(int r, int hop, int n) {
  return hop < 0 ? ring_mod(r - 1, n) : ring_mod(r - hop - 2, n);
}

// Load one incoming row (k keys, ascending) into the warp's sorted buffer
// at positions 0..k-1. Returns the count of entries below +inf (a prefix).
__device__ __forceinline__ int ring_load_incoming(const float* ik, int k,
                                                  float* sv, int* si,
                                                  int lane) {
  int cnt = 0;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    const float v = j < k ? ik[j] : CUDART_INF_F;
    if (j < k) {
      sv[j] = v;
      si[j] = j;
    }
    cnt += __popc(__ballot_sync(kFullMask, v < CUDART_INF_F));
  }
  __syncwarp();
  return cnt;
}

// Write the warp's buffer (cnt entries) as one output row of k: key and id
// (via id_of(position)), (+inf, -1) past cnt, id -1 where the key is
// infinite.
template <typename IdOf>
__device__ __forceinline__ void ring_store(const float* sv, const int* si,
                                           int cnt, int k, float* ok, int* oi,
                                           IdOf id_of, int lane) {
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    float v = CUDART_INF_F;
    int id = -1;
    if (j < cnt) {
      v = sv[j];
      id = isinf(v) ? -1 : id_of(si[j]);
    }
    ok[j] = v;
    oi[j] = id;
  }
}

}  // namespace rtt
