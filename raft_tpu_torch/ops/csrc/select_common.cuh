// The top-k selection shared by gather_refine.cu and grouped_scan.cu: an
// exact top-kk (kk <= 64) in (key, position) order, fed only the keys that
// beat a threshold.
//
// - The buffer: kk slots sorted ascending in (key, position) in shared
//   memory; an empty slot holds the sentinel (+inf, INT_MAX), greater than
//   any real entry. Order is topk_common.cuh's key_less: ties go to the
//   lower position, the TPU kernels' first-index rule.
// - The threshold: the buffer's kk-th key (+inf while it is not full), or
//   any key known to be >= the final kk-th key. It only falls, so a stale
//   value is safe: it lets more keys through, never fewer. A key is offered
//   when key <= threshold; ties with it go to the exact insert.
// - The insert (LaneRun): a warp holds the buffer one slot a lane and puts
//   each offered key in place by shifting the slots after it down one: two
//   shuffles and two comparisons a key, no serial rank search.
// gather_refine.cu has every warp offer its keys to one shared buffer: each
// warp queues them in shared memory and merges a full queue under the
// buffer's lock (warp_flush); grouped_scan.cu has each warp own its queries'
// buffers and insert directly.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_common.cuh"

namespace rtt_sel {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_volatile(const float* p) {
  return *reinterpret_cast<const volatile float*>(p);
}

__device__ __forceinline__ void store_volatile(float* p, float v) {
  *reinterpret_cast<volatile float*>(p) = v;
}

// n sentinels, by the threads of the block (a barrier must follow)
__device__ __forceinline__ void buffer_init(float* bv, int* bp, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    bv[j] = CUDART_INF_F;
    bp[j] = INT_MAX;
  }
}

// A sorted run of kk <= 64 (key, position) slots held by a warp, slot j in
// lane j (a) and slot 32 + j in lane j (b); slots >= kk hold what falls off
// the end. A key is inserted by shifting the slots after it down one.
struct LaneRun {
  float av, bv;
  int ap, bp;

  __device__ __forceinline__ void load(const float* v, const int* p, int kk, int lane) {
    av = lane < kk ? v[lane] : CUDART_INF_F;
    ap = lane < kk ? p[lane] : INT_MAX;
    bv = lane + 32 < kk ? v[lane + 32] : CUDART_INF_F;
    bp = lane + 32 < kk ? p[lane + 32] : INT_MAX;
  }

  __device__ __forceinline__ void store(float* v, int* p, int kk, int lane) const {
    __syncwarp();
    if (lane < kk) {
      v[lane] = av;
      p[lane] = ap;
    }
    if (lane + 32 < kk) {
      v[lane + 32] = bv;
      p[lane + 32] = bp;
    }
    __syncwarp();
  }

  // every lane, with the same (w, wp)
  __device__ __forceinline__ void insert(float w, int wp, int kk, int lane) {
    const float uav = __shfl_up_sync(kFull, av, 1);
    const int uap = __shfl_up_sync(kFull, ap, 1);
    if (kk > 32) {  // the b half first: its slot 32 follows slot 31 of a
      float ubv = __shfl_up_sync(kFull, bv, 1);
      int ubp = __shfl_up_sync(kFull, bp, 1);
      const float a31v = __shfl_sync(kFull, av, 31);
      const int a31p = __shfl_sync(kFull, ap, 31);
      if (lane == 0) {
        ubv = a31v;
        ubp = a31p;
      }
      if (rtt::key_less(w, wp, bv, bp)) {
        const bool up = rtt::key_less(w, wp, ubv, ubp);
        bv = up ? ubv : w;
        bp = up ? ubp : wp;
      }
    }
    if (rtt::key_less(w, wp, av, ap)) {
      const bool up = lane > 0 && rtt::key_less(w, wp, uav, uap);
      av = up ? uav : w;
      ap = up ? uap : wp;
    }
  }

  // the kk-th key (the run's threshold), in every lane
  __device__ __forceinline__ float last(int kk) const {
    return __shfl_sync(kFull, kk > 32 ? bv : av, (kk - 1) & 31);
  }
};

__device__ __forceinline__ void warp_lock(int* lock, int lane) {
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) __nanosleep(20);
    __threadfence_block();
  }
  __syncwarp();
}

__device__ __forceinline__ void warp_unlock(int* lock, int lane) {
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(lock, 0);
}

// Merge this warp's queue (n <= 32 entries at qv / qp, real: finite keys,
// distinct positions) into the shared buffer under its lock, and lower the
// threshold to the buffer's kk-th key. Entries above the buffer's kk-th key
// (it may have fallen since they were queued) are skipped.
__device__ __forceinline__ void warp_flush(float* bv, int* bp, int kk, float* thr,
                                           int* lock, const float* qv,
                                           const int* qp, int n, int lane) {
  __syncwarp();
  const float x = lane < n ? qv[lane] : CUDART_INF_F;
  const int xp = lane < n ? qp[lane] : INT_MAX;
  warp_lock(lock, lane);
  LaneRun run;
  run.load(bv, bp, kk, lane);
  const float last = run.last(kk);  // a shuffle: every lane
  unsigned m = __ballot_sync(kFull, lane < n && x <= last);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    run.insert(__shfl_sync(kFull, x, src), __shfl_sync(kFull, xp, src), kk, lane);
  }
  run.store(bv, bp, kk, lane);
  const float kth = run.last(kk);  // a shuffle: every lane
  if (lane == 0) store_volatile(thr, kth);
  warp_unlock(lock, lane);
}

// Ascending bitonic sort of one value a lane across the warp: lane i
// returns the i-th smallest.
__device__ __forceinline__ float warp_sort(float x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, j);
      x = (((lane & k) == 0) == ((lane & j) == 0)) ? fminf(x, y) : fmaxf(x, y);
    }
  return x;
}

}  // namespace rtt_sel
