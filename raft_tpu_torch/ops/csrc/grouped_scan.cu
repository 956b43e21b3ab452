// grouped_scan_topk: grouped IVF list scan over raw (f32, bf16, int8 or
// uint8) vectors with an exact per-(segment, query slot) top-kk (kk <= 64)
// kept on chip.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:grouped_scan_topk
// (l.281; body _grouped_scan_kernel l.207), which took gathered per-chunk
// list blocks [G, L, d], ran a [bq, d] x [d, Lp] contraction on the MXU,
// added a +inf mask and extracted the top-kk with kk argmin rounds (ties to
// the lowest position). Here the list block comes straight out of
// packed[seg_list[s]] (no [C, L, d] gather copy) and ids < 0 are the mask.
//
// Keys are those of segmented_scan.cu (l2 / ip / cos, minimized). Output
// [n_seg, S, kk]: keys ascending in (key, position) order and in-list
// positions, -1 where the key is +inf (fewer than kk valid rows). Pad slots
// (seg_q < 0) get (+inf, -1).
//
// Bound on the H100: operations, at the exact leg of the main path (1M x 128
// f32, 1024 lists, batch 10,000, n_probes 32, kk 10): 2 d FLOPs per (live
// pair, real row), 125 GFLOP, run as three TF32 products: 0.76 ms at 495
// TFLOP/s (1.87 ms at the fp32 rate); the bytes (probed rows once, a small
// output table) take about 0.25 ms.
//
// Design: the distance tile is the segmented kernel's (scan_common.cuh:
// one block of 256 threads per segment and group of 32 live queries, 3xTF32
// mma.sync fragments, a cp.async ring per warp, rows walked to the list's
// last valid id; two blocks an SM). The selection (select_common.cuh):
// - Each warp owns four of the block's queries, their sorted kk-buffers in
//   shared memory and their thresholds (the buffers' kk-th keys) in
//   registers.
// - At the end of each 128-row tile every thread writes its 16 keys to the
//   tile's [32, 128] key block; one barrier; each warp reads its queries'
//   rows (4 keys a lane), tests them against the exact thresholds in
//   registers, and inserts the few that pass into the buffer held one
//   entry a lane, by a shuffle shift a key; a second barrier frees the
//   block for the next tile. In random order about kk / (t + 1) keys of a
//   query pass in tile t (~21 of 1536 at kk 10); in tile 0 the kk-th
//   smallest of the 32 lane minima (a warp bitonic sort, kk <= 32) bounds
//   the keys.
// A barrier-free design (every warp testing its 16 keys against all 32
// queries' shared, stale thresholds and queueing the survivors, merged
// under per-query locks) took 7.37 ms on the main path's table against
// this one's 5.34, in turns on an H100 (700 W): its stale thresholds
// pass about kk (1 + ln(L / kk)) keys a query (~60 at kk 10), and the
// kernel is issue-bound, so every queued key cost time.
// Order is (key, position) throughout: the TPU kernel's tie rule. Masked
// rows are never offered.
#include <climits>

#include "scan_common.cuh"
#include "select_common.cuh"

namespace {

using namespace rtt_scan;

// stages of each warp's ring: three (six for 1-byte rows with the queries
// resident, scan_common.cuh)
template <typename T, bool kQRes>
constexpr int kStagesOf = kQRes && sizeof(T) == 1 ? kByteStages : 3;
constexpr int kPerWarp = kQG / kWarps;    // queries a warp owns
constexpr int kKeyStride = kRows + 1;     // the tile's keys: [kQG][kRows + 1]

template <typename T, bool kQRes>
size_t dyn_smem_bytes(int d, int kk) {
  // + the tile's keys, the buffers [kQG][kk] of keys and of positions
  return ring_bytes<T, kQRes, kStagesOf<T, kQRes>>() + (kQRes ? qres_bytes(d) : 0) +
         ((size_t)kQG * kKeyStride + 2 * (size_t)kQG * kk) * sizeof(float);
}

// One tile of one query, by its warp: the tile's keys (row r at key[r],
// +inf where masked) against the threshold tq, the keys that pass inserted
// into the sorted buffer (bv, bp) of kk slots. Returns the new threshold.
__device__ __forceinline__ float merge_tile(const float* key, int t0, int kk, float* bv,
                                            int* bp, float tq, int lane) {
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = key[lane + 32 * c];
  float b = tq;
  if (t0 == 0 && kk <= 32) {  // the kk-th of 32 of the keys bounds the kk-th
    const float mn = rtt_sel::warp_sort(fminf(fminf(v[0], v[1]), fminf(v[2], v[3])),
                                        lane);
    b = fminf(b, __shfl_sync(rtt_sel::kFull, mn, kk - 1));
  }
  unsigned m[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    m[c] = __ballot_sync(rtt_sel::kFull, v[c] != CUDART_INF_F && v[c] <= b);
  if ((m[0] | m[1] | m[2] | m[3]) == 0) return tq;
  rtt_sel::LaneRun run;
  run.load(bv, bp, kk, lane);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    unsigned mm = m[c];
    while (mm) {
      const int src = __ffs(mm) - 1;
      mm &= mm - 1;
      run.insert(__shfl_sync(rtt_sel::kFull, v[c], src), t0 + src + 32 * c, kk, lane);
    }
  }
  run.store(bv, bp, kk, lane);
  return run.last(kk);
}

template <typename T, bool kQRes>
__global__ void __launch_bounds__(kThreads, 2)
grouped_scan_kernel(const int* __restrict__ seg_list, const int* __restrict__ seg_q,
                    const float* __restrict__ q, const T* __restrict__ packed,
                    const int* __restrict__ ids, float* __restrict__ out_keys,
                    int* __restrict__ out_pos, int S, int d, int L, int kk, int n_groups,
                    int metric, int xvec, int qvec) {
  __shared__ Stage st;
  extern __shared__ __align__(16) char dyn[];
  char* ring = dyn;
  float2* qres = reinterpret_cast<float2*>(dyn + ring_bytes<T, kQRes, kStagesOf<T, kQRes>>());
  float* tkey = reinterpret_cast<float*>(dyn + ring_bytes<T, kQRes, kStagesOf<T, kQRes>>() +
                                         (kQRes ? qres_bytes(d) : 0));  // [kQG][kKeyStride]
  float* bv = tkey + kQG * kKeyStride;               // [kQG][kk] sorted keys
  int* bp = reinterpret_cast<int*>(bv + kQG * kk);   // [kQG][kk] positions

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long s = blockIdx.x / n_groups;
  const int grp = blockIdx.x % n_groups;
  const int* sq = seg_q + s * S;

  write_pads(sq, S, grp, s * S, kk, out_keys, out_pos);
  const int nq = load_queries(sq, S, grp, q, d, st);
  if (nq == 0) return;

  const long lst = seg_list[s];
  const T* list = packed + lst * (long)L * d;
  const int* lid = ids + lst * (long)L;
  const int n_rows = list_rows(lid, L, st);
  if constexpr (kQRes) split_queries(qres, q, d, st, nq);
  rtt_sel::buffer_init(bv, bp, kQG * kk);
  float tq[kPerWarp];  // the owned queries' thresholds
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) tq[u] = CUDART_INF_F;

  scan_tiles<T, kQRes, kStagesOf<T, kQRes>>(ring, qres, list, lid, n_rows, d, q, st, nq, xvec, qvec,
                           [&](int t0, auto& acc, auto& xn, auto& id) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = 16 * i + g + 8 * (c >> 1);
          const int e = c & 1;
          if (qi < nq)
            tkey[qi * kKeyStride + 16 * warp + 8 * j + 2 * t + e] =
                id[j][e] >= 0 ? scan_key(metric, acc[i][j][c], st.qsq[qi], xn[j][e])
                              : CUDART_INF_F;
        }
    __syncthreads();  // the tile's keys are in
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const int qi = warp + u * kWarps;
      if (qi < nq)
        tq[u] = merge_tile(tkey + qi * kKeyStride, t0, kk, bv + qi * kk, bp + qi * kk,
                           tq[u], lane);
    }
    __syncthreads();  // every warp has read them
  });
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int qi = warp + u * kWarps;
    if (qi < nq) {
      const long o = (s * S + st.slot[qi]) * kk;
      for (int j = lane; j < kk; j += 32) {
        const float v = bv[qi * kk + j];
        out_keys[o + j] = v;
        out_pos[o + j] = v == CUDART_INF_F ? -1 : bp[qi * kk + j];
      }
    }
  }
}

template <typename T, bool kQRes>
cudaError_t launch(long blocks, cudaStream_t st, const int* seg_list,
                   const int* seg_q, const float* q, const void* packed, const int* ids,
                   float* out_keys, int* out_pos, int S, int d, int L, int kk,
                   int n_groups, int metric) {
  const size_t smem = dyn_smem_bytes<T, kQRes>(d, kk);
  cudaError_t e = cudaFuncSetAttribute(grouped_scan_kernel<T, kQRes>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int xvec = copy_width(d * (int)sizeof(T), packed);
  const int qvec = copy_width(d * 4, q) == 16 ? 16 : 4;
  grouped_scan_kernel<T, kQRes><<<(unsigned)blocks, kThreads, smem, st>>>(
      seg_list, seg_q, q, static_cast<const T*>(packed), ids, out_keys, out_pos, S, d, L,
      kk, n_groups, metric, xvec, qvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(long blocks, cudaStream_t st, const int* seg_list,
                   const int* seg_q, const float* q, const void* packed, const int* ids,
                   float* out_keys, int* out_pos, int S, int d, int L, int kk,
                   int n_groups, int metric) {
  return queries_resident(d)
             ? launch<T, true>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys,
                               out_pos, S, d, L, kk, n_groups, metric)
             : launch<T, false>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys,
                                out_pos, S, d, L, kk, n_groups, metric);
}

}  // namespace

// metric: 0 l2, 1 inner product, 2 cosine. row_type: the packed rows'
// element type (RowType: 0 f32, 1 bf16, 2 int8, 3 uint8).
extern "C" int rtt_grouped_scan_topk(const int* seg_list, const int* seg_q,
                                     const float* q, const void* packed, const int* ids,
                                     float* out_keys, int* out_pos, int n_seg, int S,
                                     int d, int L, int kk, int row_type, int metric,
                                     void* stream) {
  if (S < 1 || S > kMaxS || d < 1 || L < 1 || kk < 1 || kk > rtt::kMaxK || metric < 0 ||
      metric > 2 || row_type < kRowF32 || row_type > kRowU8)
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return (int)cudaSuccess;
  const int n_groups = (S + kQG - 1) / kQG;
  const long blocks = (long)n_seg * n_groups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto row) {
    using T = decltype(row);
    return launch<T>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys, out_pos,
                     S, d, L, kk, n_groups, metric);
  };
  const cudaError_t e = row_type == kRowBF16 ? go(__nv_bfloat16{})
                        : row_type == kRowI8 ? go(int8_t{})
                        : row_type == kRowU8 ? go(uint8_t{})
                                             : go(float{});
  return (int)e;
}
