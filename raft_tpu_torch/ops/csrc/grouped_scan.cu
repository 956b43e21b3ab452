// grouped_scan_topk: grouped IVF list scan over raw (f32 or bf16) vectors
// with an exact per-(segment, query slot) top-kk (kk <= 64) kept on chip.
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
// mma.sync fragments, a cp.async ring, rows walked to the list's last valid
// id; two blocks an SM, so one block's merges run beside the other's
// products). Each 128-row tile's [32, 128] keys go from the fragments to shared
// memory; then each warp merges its four queries' rows into their sorted
// kk-buffers with the warp-cooperative buffer of topk_common.cuh (ballot of
// the lanes that beat the buffer's last entry, then one ordered insert
// each), ordered on (key, position): the TPU kernel's tie rule. Masked rows
// are never offered. The merges run while the next tile's slices load.
#include <climits>

#include "scan_common.cuh"
#include "topk_common.cuh"

namespace {

using namespace rtt_scan;

constexpr int kDistStride = kRows + 1;
constexpr int kS = 3;  // stages of each warp's ring
constexpr int kPerWarp = kQG / kWarps;  // queries merged by each warp

template <typename T, bool kQRes>
size_t dyn_smem_bytes(int d, int kk) {
  return ring_bytes<T, kQRes, kS>() + (kQRes ? qres_bytes(d) : 0) +
         ((size_t)kQG * kDistStride + 2 * (size_t)kQG * kk) * sizeof(float);
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
  float2* qres = reinterpret_cast<float2*>(dyn + ring_bytes<T, kQRes, kS>());
  float* dist = reinterpret_cast<float*>(dyn + ring_bytes<T, kQRes, kS>() +
                                         (kQRes ? qres_bytes(d) : 0));  // [kQG][kDistStride]
  float* sv = dist + kQG * kDistStride;      // [kQG][kk] sorted keys
  int* si = reinterpret_cast<int*>(sv + kQG * kk);  // [kQG][kk] positions

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
  float qsq[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * i + g + 8 * h;
      qsq[i][h] = qi < nq ? st.qsq[qi] : 0.f;
    }
  int cnt[kPerWarp];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) cnt[u] = 0;

  scan_tiles<T, kQRes, kS>(ring, qres, list, lid, n_rows, d, q, st, nq, xvec, qvec,
                           [&](int t0, auto& acc, auto& xn, auto& id) {
    __syncthreads();  // every warp's merges of the previous tile are done
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = 16 * i + g + 8 * (c >> 1);
          if (qi < nq) {
            const int e = c & 1;
            dist[qi * kDistStride + 16 * warp + 8 * j + 2 * t + e] =
                id[j][e] >= 0
                    ? scan_key(metric, acc[i][j][c], qsq[i][c >> 1], xn[j][e])
                    : CUDART_INF_F;
          }
        }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const int qi = warp + u * kWarps;
      if (qi < nq) {
        const float* row = dist + qi * kDistStride;
        for (int c = 0; c < kRows; c += 32) {
          const float v = row[c + lane];
          cnt[u] = rtt::warp_offer(v, t0 + c + lane, v != CUDART_INF_F, kk,
                                   sv + qi * kk, si + qi * kk, cnt[u], lane);
        }
      }
    }
  });
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int qi = warp + u * kWarps;
    if (qi < nq) {
      const long o = (s * S + st.slot[qi]) * kk;
      for (int j = lane; j < kk; j += 32) {
        const bool f = j < cnt[u];
        out_keys[o + j] = f ? sv[qi * kk + j] : CUDART_INF_F;
        out_pos[o + j] = f ? si[qi * kk + j] : -1;
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

// metric: 0 l2, 1 inner product, 2 cosine. bf16: packed is bf16, else f32.
extern "C" int rtt_grouped_scan_topk(const int* seg_list, const int* seg_q,
                                     const float* q, const void* packed, const int* ids,
                                     float* out_keys, int* out_pos, int n_seg, int S,
                                     int d, int L, int kk, int bf16, int metric,
                                     void* stream) {
  if (S < 1 || S > kMaxS || d < 1 || L < 1 || kk < 1 || kk > rtt::kMaxK || metric < 0 ||
      metric > 2)
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return (int)cudaSuccess;
  const int n_groups = (S + kQG - 1) / kQG;
  const long blocks = (long)n_seg * n_groups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(blocks, st, seg_list, seg_q, q, packed, ids,
                                   out_keys, out_pos, S, d, L, kk, n_groups, metric)
           : launch<float>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys,
                           out_pos, S, d, L, kk, n_groups, metric);
  return (int)e;
}
