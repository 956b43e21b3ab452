// segmented_scan_topk: segmented IVF list scan over raw (f32 or bf16)
// vectors keeping the two best candidates per strided bin (position mod
// 128) for every (segment, query slot).
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:segmented_scan_topk
// (l.397; body _segmented_scan_kernel l.335), which DMA'd each segment's
// list block [Lp, d] into VMEM by a scalar-prefetched index, ran one
// [S, d] x [d, Lp] contraction on the MXU and reduced the [S, Lp] distance
// block into 128 strided bins with two argmin rounds.
//
// For a live slot with query q of a segment owning list l, at position p:
//   key = max(|q|^2 + |x|^2 - 2<q, x>, 0)     (l2; |x|^2 of the row as stored)
//       | -<q, x>                              (ip)
//       | 1 - <q, x> / (|q| |x|)               (cos, rsqrt of max(., 1e-30))
// ids[l, p] < 0 or p >= L gives (+inf, -1). Bin b = p mod 128 keeps the two
// smallest (key, position) pairs in lexicographic order; output
// [n_seg, S, 256]: columns 0..127 each bin's best, 128..255 its second
// best, with the global id, -1 where the key is +inf. Pad slots
// (seg_q < 0) get the (+inf, -1) sentinel.
//
// Bound on the H100: operations, at the main path (1M x 128 f32, 1024
// lists, batch 10,000, n_probes 32): 2 d FLOPs per (live pair, real row of
// its list), 125 GFLOP, 1.87 ms at 67 TFLOP/s fp32 (spill fills the probed
// lists near the 1464-row cap); the bytes (the probed lists' rows once, the
// 0.92 GB output table) take about 0.4 ms.
//
// Design (scan_common.cuh): one block of 256 threads per (segment, group of
// 32 live queries); the segment's groups are adjacent in launch order, so
// the list block is read from HBM about once and from L2 by the other
// groups. Thread t owns bin t mod 128 for 16 queries and walks the list
// tiles in order, so its positions rise and a strict < keeps the earlier
// position on equal keys: the TPU's first-index argmin, exactly. The
// running state (2 keys + 2 ids for 16 queries) lives in registers (238 a
// thread, so one block per SM); the 128 x 128 bins x 2 best of a full
// segment (256 KB) is spread over four blocks. Keeping the state in shared
// memory instead (64 KB a block, two blocks per SM) measured 7 % slower at
// the main path. A group with no live query writes its pad sentinels and
// exits, so unused trailing segments cost only their sentinel rows.
#include <climits>

#include "scan_common.cuh"

namespace {

using namespace rtt_scan;

constexpr int kCols = 2 * kRows;  // output columns per slot
static_assert(kCols == kThreads, "one output column per thread");

template <typename T>
__global__ void __launch_bounds__(kThreads)
segmented_scan_kernel(const int* __restrict__ seg_list, const int* __restrict__ seg_q,
                      const float* __restrict__ q, const T* __restrict__ packed,
                      const int* __restrict__ ids, float* __restrict__ out_keys,
                      int* __restrict__ out_ids, int S, int d, int L, int n_groups,
                      int metric) {
  __shared__ Stage st;
  const int tid = threadIdx.x;
  const long s = blockIdx.x / n_groups;
  const int grp = blockIdx.x % n_groups;
  const int* sq = seg_q + s * S;

  // the pad slots of this group's slot range
  for (int j = grp * kQG; j < min(S, (grp + 1) * kQG); ++j) {
    if (sq[j] < 0) {
      const long o = (s * S + j) * kCols + tid;
      out_keys[o] = CUDART_INF_F;
      out_ids[o] = -1;
    }
  }
  const int nq = load_queries(sq, S, grp, q, d, st);
  if (nq == 0) return;

  const long lst = seg_list[s];
  const T* list = packed + lst * (long)L * d;
  const int* lid = ids + lst * (long)L;
  const int r = tid % kRows, h = tid / kRows;
  const int ngh = min(kQPT, max(0, nq - h * kQPT));

  float k1[kQPT], k2[kQPT];
  int i1[kQPT], i2[kQPT];
#pragma unroll
  for (int g = 0; g < kQPT; ++g) {
    k1[g] = k2[g] = CUDART_INF_F;
    i1[g] = i2[g] = -1;
  }
  for (int t0 = 0; t0 < L; t0 += kRows) {
    float acc[kQPT], nsq;
    tile_dots(list, L, d, t0, q, nq, st, acc, nsq);
    const int pos = t0 + r;
    const int id = pos < L ? lid[pos] : -1;
#pragma unroll
    for (int g = 0; g < kQPT; ++g) {
      if (g < ngh) {
        const float key = id >= 0
            ? scan_key(metric, acc[g], st.qsq[h * kQPT + g], nsq) : CUDART_INF_F;
        if (key < k1[g]) {
          k2[g] = k1[g]; i2[g] = i1[g];
          k1[g] = key; i1[g] = id;
        } else if (key < k2[g]) {
          k2[g] = key; i2[g] = id;
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kQPT; ++g) {
    if (g < ngh) {
      const long o = (s * S + st.slot[h * kQPT + g]) * kCols;
      out_keys[o + r] = k1[g];
      out_keys[o + kRows + r] = k2[g];
      out_ids[o + r] = i1[g];
      out_ids[o + kRows + r] = i2[g];
    }
  }
}

template <typename T>
cudaError_t launch(long blocks, cudaStream_t st, const int* seg_list, const int* seg_q,
                   const float* q, const void* packed, const int* ids, float* out_keys,
                   int* out_ids, int S, int d, int L, int n_groups, int metric) {
  segmented_scan_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      seg_list, seg_q, q, static_cast<const T*>(packed), ids, out_keys, out_ids, S, d,
      L, n_groups, metric);
  return cudaGetLastError();
}

}  // namespace

// metric: 0 l2, 1 inner product, 2 cosine. bf16: packed is bf16, else f32.
extern "C" int rtt_segmented_scan_topk(const int* seg_list, const int* seg_q,
                                       const float* q, const void* packed,
                                       const int* ids, float* out_keys, int* out_ids,
                                       int n_seg, int S, int d, int L, int bf16,
                                       int metric, void* stream) {
  if (S < 1 || S > kMaxS || d < 1 || L < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return (int)cudaSuccess;
  const int n_groups = (S + kQG - 1) / kQG;
  const long blocks = (long)n_seg * n_groups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys,
                                   out_ids, S, d, L, n_groups, metric)
           : launch<float>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys, out_ids,
                           S, d, L, n_groups, metric);
  return (int)e;
}
