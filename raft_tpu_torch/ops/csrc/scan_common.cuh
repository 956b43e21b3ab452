// Shared pieces of the two IVF list-scan kernels (segmented_scan.cu and
// grouped_scan.cu): the block's live queries, the staged list tile and the
// exact fp32 dot products of a 128-row tile with up to 32 queries.
//
// A block owns one segment (one list) and a group of up to 32 of the
// segment's live queries. Its 256 threads are 2 halves of 128: thread t
// takes list row t mod 128 of every 128-row tile and the 16 queries of
// half t / 128, so each thread keeps 16 running dot products in registers.
// The feature axis is staged through shared memory 32 columns at a time
// (rows at an odd word stride, so a thread's row reads hit distinct banks;
// query columns are read as broadcasts), so no width of d is bound by
// shared memory. bf16 list data is widened to f32 as it is staged. All
// arithmetic is fp32 FMA: the TPU kernels asked for Precision.HIGHEST.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rtt_scan {

constexpr int kRows = 128;                 // list rows per tile (= strided bins)
constexpr int kHalves = 2;                 // query halves per block
constexpr int kQPT = 16;                   // queries per thread
constexpr int kQG = kHalves * kQPT;        // live queries per block
constexpr int kThreads = kRows * kHalves;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kDK = 32;                    // feature columns per staged chunk
constexpr int kXStride = kDK + 1;
constexpr int kMaxS = 1024;                // largest segment
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Stage {
  float xs[kRows * kXStride];  // the tile's rows, kDK columns of them
  float qs[kQG * kDK];         // the block's queries, the same columns
  int live[kMaxS];             // live slots of the segment, in slot order
  int slot[kQG];               // slot of each of the block's queries
  int qidx[kQG];               // its query row
  float qsq[kQG];              // its squared norm (f32 sum)
  int wcnt[kWarps];
};

// Live slots (seg_q >= 0) of the segment into st.live, in slot order (warp
// ballots). Returns their count.
__device__ __forceinline__ int compact_live(const int* sq, int S, Stage& st) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n_live = 0;
  for (int base = 0; base < S; base += kThreads) {
    const int j = base + tid;
    const bool is_live = j < S && sq[j] >= 0;
    const unsigned bal = __ballot_sync(kFull, is_live);
    if (lane == 0) st.wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = n_live, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += st.wcnt[w];
      total += st.wcnt[w];
    }
    if (is_live) st.live[off + __popc(bal & ((1u << lane) - 1u))] = j;
    __syncthreads();
    n_live += total;
  }
  return n_live;
}

// The block's live queries (group `grp` of the segment's live slots): slot,
// query row and squared norm of each. Returns their count, 0..kQG.
__device__ __forceinline__ int load_queries(const int* sq, int S, int grp,
                                            const float* __restrict__ q, int d,
                                            Stage& st) {
  const int n_live = compact_live(sq, S, st);
  const int g0 = grp * kQG;
  const int nq = min(kQG, max(0, n_live - g0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < nq) {
    st.slot[tid] = st.live[g0 + tid];
    st.qidx[tid] = sq[st.slot[tid]];
  }
  __syncthreads();
  for (int g = warp; g < nq; g += kWarps) {
    const float* qr = q + (long)st.qidx[g] * d;
    float a = 0.f;
    for (int j = lane; j < d; j += 32) a = fmaf(qr[j], qr[j], a);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    if (lane == 0) st.qsq[g] = a;
  }
  __syncthreads();
  return nq;
}

// acc[g] = <q_(h*kQPT+g), x_(t0+r)> and nsq = |x_(t0+r)|^2 for this thread's
// row r = tid mod 128 and half h = tid / 128; rows >= L and queries >= nq
// read zeros. Starts with a __syncthreads, so the caller may reuse shared
// memory it read after the previous call.
template <typename T>
__device__ __forceinline__ void tile_dots(const T* __restrict__ list, int L, int d,
                                          int t0, const float* __restrict__ q,
                                          int nq, Stage& st, float (&acc)[kQPT],
                                          float& nsq) {
  const int tid = threadIdx.x;
  const int r = tid % kRows, h = tid / kRows;
#pragma unroll
  for (int g = 0; g < kQPT; ++g) acc[g] = 0.f;
  nsq = 0.f;
  for (int c0 = 0; c0 < d; c0 += kDK) {
    __syncthreads();
    for (int e = tid; e < kRows * kDK; e += kThreads) {
      const int row = e / kDK, col = e % kDK;
      const int gr = t0 + row, gc = c0 + col;
      st.xs[row * kXStride + col] =
          (gr < L && gc < d) ? to_f32(list[(long)gr * d + gc]) : 0.f;
    }
    for (int e = tid; e < kQG * kDK; e += kThreads) {
      const int g = e / kDK, gc = c0 + e % kDK;
      st.qs[e] = (g < nq && gc < d) ? q[(long)st.qidx[g] * d + gc] : 0.f;
    }
    __syncthreads();
    const float* xr = st.xs + r * kXStride;
    const float* qh = st.qs + h * kQPT * kDK;
#pragma unroll 4
    for (int j = 0; j < kDK; ++j) {
      const float x = xr[j];
      nsq = fmaf(x, x, nsq);
#pragma unroll
      for (int g = 0; g < kQPT; ++g) acc[g] = fmaf(qh[g * kDK + j], x, acc[g]);
    }
  }
}

// Minimized key: 0 l2 max(|q|^2 + |x|^2 - 2<q,x>, 0), 1 ip -<q,x>,
// 2 cos 1 - <q,x> rsqrt(max(|q|^2, 1e-30)) rsqrt(max(|x|^2, 1e-30)).
__device__ __forceinline__ float scan_key(int metric, float dot, float qsq,
                                          float nsq) {
  if (metric == 1) return -dot;
  if (metric == 2)
    return 1.f - dot * rsqrtf(fmaxf(qsq, 1e-30f)) * rsqrtf(fmaxf(nsq, 1e-30f));
  return fmaxf(qsq + nsq - 2.f * dot, 0.f);
}

}  // namespace rtt_scan
