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
// With a filter (the TPU kernel's filter_bits, l.1178: packed 32-bit words
// over dataset rows) a candidate whose bit is clear is invalid too.
// Output: ascending (key, candidate position), ties to the earliest
// candidate, as the TPU kernel's first-index extraction gives.
//
// Bound on the H100: bytes. The m * C candidate rows are a random gather
// (m * C * d * 4 bytes); at the main path's [500, 400] x 96 f32 that is
// 76.8 MB, ~23 us at 3.35 TB/s. The arithmetic is 4 FLOPs per element, on
// the CUDA cores in fp32. Filtered: the kept candidates' rows and a 4-byte
// word a candidate.
//
// Design: enough rows in flight to reach the bytes bound. One block of four
// warps per query; a warp splits into four lane groups of 8 lanes, and a
// group takes 4 candidate rows at a time: each lane issues the 16-, 8- or
// 4-byte loads (the widest the rows' bytes and alignment allow) of its
// share of all 4 rows before it reduces any of them, so a warp has 16 rows
// in flight and a group reduces a row in 3 shuffles. The next step's ids
// are read while the rows load. At m = 500 the 500 blocks are resident at
// once (3.8 an SM): ~243 rows, ~93 KB at d 96 (~125 KB at d 128), in
// flight on each SM, against the ~18 KB that Little's law asks for 3.35
// TB/s at ~0.7 us of DRAM latency. At m = 32 only 32 of the 132 SMs work,
// ~24.6 KB in flight on each: such a call moves ~5 MB and is bound by the
// latency of its ~7 steps, not by bytes.
//
// Selection (select_common.cuh): the block keeps its query's running top-k
// in shared memory, sorted on (key, candidate position), with its k-th key
// as a threshold. A row's key is offered only when it is <= the threshold
// (read without a barrier: it only falls); the offered keys go to the
// warp's queue, which is merged into the top-k under a lock when full and
// at the end. About k (1 + ln(C / k)) keys are offered in random order (47
// of 400 at k 10). No [C] key array exists, so any C runs.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kG = 8;                   // lanes of a row
constexpr int kU = 4;                   // rows a lane group loads at a time
constexpr int kP = 4;                   // loads a lane issues per row and pass
constexpr int kStep = (32 / kG) * kU;   // rows a warp takes at a time: 16
constexpr int kQW = 32;                 // queue entries a warp

// V floats from global memory, not kept in L1 (the rows are streamed)
template <int V>
__device__ __forceinline__ void load_row(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                 : "l"(p));
  } else if constexpr (V == 2) {
    asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];"
                 : "=f"(x[0]), "=f"(x[1])
                 : "l"(p));
  } else {
    asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(x[0]) : "l"(p));
  }
}

// V floats of the query row (read by every group of the block: kept in L1)
template <int V>
__device__ __forceinline__ void load_query(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

// Candidate id `id` after the filter `bits` (null: none): -1 where its bit
// is clear -- bit id mod 32 of the word of the row the fetch reads (the id
// clipped to [0, n - 1], the word index to the last word), the TPU kernel's
// test.
__device__ __forceinline__ int kept_id(int id, const int* __restrict__ bits,
                                       long n_words, long n) {
  if (bits == nullptr || id < 0) return id;
  long w = (id > n - 1 ? n - 1 : (long)id) >> 5;
  if (w > n_words - 1) w = n_words - 1;
  return (bits[w] >> (id & 31)) & 1 ? id : -1;
}

template <int V>
__global__ void __launch_bounds__(kThreads, 4)
gather_refine_kernel(const float* __restrict__ data, long n, int d,
                     const float* __restrict__ queries,
                     const int* __restrict__ cand,
                     const int* __restrict__ bits, long n_words, int C, int k,
                     int metric, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  __shared__ float bv[rtt::kMaxK];
  __shared__ int bp[rtt::kMaxK];
  __shared__ float qk[kWarps][kQW];
  __shared__ int qp[kWarps][kQW];
  __shared__ float thr;
  __shared__ int lock;

  const long row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kG, r = lane % kG;
  rtt_sel::buffer_init(bv, bp, k);
  if (threadIdx.x == 0) {
    thr = CUDART_INF_F;
    lock = 0;
  }
  const float* qrow = queries + row * d;
  float qsq = 0.f;
  for (int j = lane; j < d; j += 32) qsq = fmaf(qrow[j], qrow[j], qsq);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qsq += __shfl_xor_sync(rtt_sel::kFull, qsq, o);
  __syncthreads();

  const int nv = d / V;  // loads a row (d % V == 0)
  const int* crow = cand + row * C;
  int cnt = 0;           // this warp's queue entries
  int c0 = warp * kStep;
  int id[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int c = c0 + grp * kU + u;
    id[u] = c < C ? kept_id(crow[c], bits, n_words, n) : -1;
  }
  for (; c0 < C; c0 += kWarps * kStep) {
    const float* xr[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      long rr = id[u] < 0 ? 0 : (long)id[u];
      if (rr > n - 1) rr = n - 1;
      xr[u] = data + rr * d;
      ok[u] = id[u] >= 0;  // past C: id -1
    }
    float s[kU], rsq[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) s[u] = rsq[u] = 0.f;
    int nid[kU];  // the next step's ids, read while the rows load
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = c0 + kWarps * kStep + grp * kU + u;
      nid[u] = c < C ? kept_id(crow[c], bits, n_words, n) : -1;
    }
    for (int vb = 0; vb < nv; vb += kG * kP) {
      float x[kU][kP][V];
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int vi = vb + r + kG * p;
          if (ok[u] && vi < nv) {
            load_row<V>(x[u][p], xr[u] + vi * V);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[u][p][e] = 0.f;
          }
        }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int vi = vb + r + kG * p;
        float qv[V];
        if (vi < nv) {
          load_query<V>(qv, qrow + vi * V);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) qv[e] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            s[u] = fmaf(qv[e], x[u][p][e], s[u]);
            rsq[u] = fmaf(x[u][p][e], x[u][p][e], rsq[u]);
          }
      }
    }
    // the group's sums: 3 shuffles; then lane r < kU keeps row r's key
    float key = CUDART_INF_F;
    bool valid = false;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int o = 1; o < kG; o <<= 1) {
        s[u] += __shfl_xor_sync(rtt_sel::kFull, s[u], o);
        rsq[u] += __shfl_xor_sync(rtt_sel::kFull, rsq[u], o);
      }
      float kv;
      if (metric == 1) {
        kv = -s[u];
      } else if (metric == 2) {
        const float qn = sqrtf(fmaxf(qsq, 1e-30f));
        const float cn = sqrtf(fmaxf(rsq[u], 1e-30f));
        kv = 1.f - s[u] / (qn * cn);
      } else {
        kv = fmaxf(qsq + rsq[u] - 2.f * s[u], 0.f);
      }
      if (r == u) {
        key = kv;
        valid = ok[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) id[u] = nid[u];
    // offer the keys that beat the threshold
    const int pos = c0 + grp * kU + r;
    const bool live = valid && key != CUDART_INF_F;
    bool pass = live && key <= rtt_sel::load_volatile(&thr);
    unsigned m = __ballot_sync(rtt_sel::kFull, pass);
    if (m) {
      if (cnt + __popc(m) > kQW) {
        rtt_sel::warp_flush(bv, bp, k, &thr, &lock, qk[warp], qp[warp], cnt, lane);
        cnt = 0;
        pass = pass && key <= rtt_sel::load_volatile(&thr);
        m = __ballot_sync(rtt_sel::kFull, pass);
      }
      if (pass) {
        const int o = cnt + __popc(m & ((1u << lane) - 1u));
        qk[warp][o] = key;
        qp[warp][o] = pos;
      }
      cnt += __popc(m);
    }
  }
  if (cnt > 0)
    rtt_sel::warp_flush(bv, bp, k, &thr, &lock, qk[warp], qp[warp], cnt, lane);
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float v = bv[j];
    out_v[row * k + j] = v;
    out_i[row * k + j] = v == CUDART_INF_F ? -1 : crow[bp[j]];
  }
}

template <int V>
cudaError_t launch(const float* data, long n, int d, const float* queries,
                   const int* cand, const int* bits, long n_words, int m, int C,
                   int k, int metric, float* out_v, int* out_i, cudaStream_t st) {
  gather_refine_kernel<V><<<m, kThreads, 0, st>>>(
      data, n, d, queries, cand, bits, n_words, C, k, metric, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// metric: 0 l2 (squared), 1 inner product, 2 cosine. Any C; k <= 64.
// bits: the filter's n_words 32-bit words, or null for no filter.
extern "C" int rtt_gather_refine_topk(const float* data, long n, int d,
                                      const float* queries, const int* cand,
                                      const int* bits, long n_words, int m,
                                      int C, int k, int metric, float* out_v,
                                      int* out_i, void* stream) {
  if (n < 1 || d < 1 || C < 1 || k < 1 || k > rtt::kMaxK || k > C || metric < 0 ||
      metric > 2 || (bits != nullptr && n_words < 1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  // the widest load the rows (and the query rows) allow
  const uintptr_t a = (uintptr_t)data | (uintptr_t)queries;
  const cudaError_t e =
      d % 4 == 0 && a % 16 == 0
          ? launch<4>(data, n, d, queries, cand, bits, n_words, m, C, k, metric,
                      out_v, out_i, st)
      : d % 2 == 0 && a % 8 == 0
          ? launch<2>(data, n, d, queries, cand, bits, n_words, m, C, k, metric,
                      out_v, out_i, st)
          : launch<1>(data, n, d, queries, cand, bits, n_words, m, C, k, metric,
                      out_v, out_i, st);
  return (int)e;
}
