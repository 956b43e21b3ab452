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
// pair, real row), 125 GFLOP, 1.87 ms at 67 TFLOP/s fp32; the bytes
// (probed rows once, a small output table) take about 0.25 ms.
//
// Design: the dot products are those of the segmented kernel (one block of
// 256 threads per segment and group of 32 live queries, scan_common.cuh).
// Each 128-row tile's [32, 128] keys go to shared memory; then each warp
// merges its four queries' rows into their sorted kk-buffers with the
// warp-cooperative buffer of topk_common.cuh (ballot of the lanes that beat
// the buffer's last entry, then one ordered insert each), ordered on (key,
// position): the TPU kernel's tie rule. Masked rows are never offered.
#include <climits>

#include "scan_common.cuh"
#include "topk_common.cuh"

namespace {

using namespace rtt_scan;

constexpr int kDistStride = kRows + 1;
constexpr int kPerWarp = kQG / kWarps;  // queries merged by each warp

size_t dyn_smem_bytes(int kk) {
  return ((size_t)kQG * kDistStride + 2 * (size_t)kQG * kk) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_scan_kernel(const int* __restrict__ seg_list, const int* __restrict__ seg_q,
                    const float* __restrict__ q, const T* __restrict__ packed,
                    const int* __restrict__ ids, float* __restrict__ out_keys,
                    int* __restrict__ out_pos, int S, int d, int L, int kk, int n_groups,
                    int metric) {
  __shared__ Stage st;
  extern __shared__ float dyn[];
  float* dist = dyn;                         // [kQG][kDistStride]
  float* sv = dist + kQG * kDistStride;      // [kQG][kk] sorted keys
  int* si = reinterpret_cast<int*>(sv + kQG * kk);  // [kQG][kk] positions

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long s = blockIdx.x / n_groups;
  const int grp = blockIdx.x % n_groups;
  const int* sq = seg_q + s * S;

  for (int j = grp * kQG; j < min(S, (grp + 1) * kQG); ++j) {
    if (sq[j] < 0) {
      for (int c = tid; c < kk; c += kThreads) {
        out_keys[(s * S + j) * kk + c] = CUDART_INF_F;
        out_pos[(s * S + j) * kk + c] = -1;
      }
    }
  }
  const int nq = load_queries(sq, S, grp, q, d, st);
  if (nq == 0) return;

  const long lst = seg_list[s];
  const T* list = packed + lst * (long)L * d;
  const int* lid = ids + lst * (long)L;
  const int r = tid % kRows, h = tid / kRows;
  const int ngh = min(kQPT, max(0, nq - h * kQPT));
  int cnt[kPerWarp];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) cnt[u] = 0;

  for (int t0 = 0; t0 < L; t0 += kRows) {
    // tile_dots opens with a barrier: the previous tile's merges are done
    float acc[kQPT], nsq;
    tile_dots(list, L, d, t0, q, nq, st, acc, nsq);
    const int pos = t0 + r;
    const bool valid = pos < L && lid[pos] >= 0;
#pragma unroll
    for (int g = 0; g < kQPT; ++g) {
      if (g < ngh) {
        dist[(h * kQPT + g) * kDistStride + r] =
            valid ? scan_key(metric, acc[g], st.qsq[h * kQPT + g], nsq) : CUDART_INF_F;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const int g = warp + u * kWarps;
      if (g < nq) {
        const float* row = dist + g * kDistStride;
        for (int c = 0; c < kRows; c += 32) {
          const float v = row[c + lane];
          cnt[u] = rtt::warp_offer(v, t0 + c + lane, v != CUDART_INF_F, kk,
                                   sv + g * kk, si + g * kk, cnt[u], lane);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int g = warp + u * kWarps;
    if (g < nq) {
      const long o = (s * S + st.slot[g]) * kk;
      for (int j = lane; j < kk; j += 32) {
        const bool f = j < cnt[u];
        out_keys[o + j] = f ? sv[g * kk + j] : CUDART_INF_F;
        out_pos[o + j] = f ? si[g * kk + j] : -1;
      }
    }
  }
}

template <typename T>
cudaError_t launch(long blocks, size_t smem, cudaStream_t st, const int* seg_list,
                   const int* seg_q, const float* q, const void* packed, const int* ids,
                   float* out_keys, int* out_pos, int S, int d, int L, int kk,
                   int n_groups, int metric) {
  cudaError_t e = cudaFuncSetAttribute(
      grouped_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  grouped_scan_kernel<T><<<(unsigned)blocks, kThreads, smem, st>>>(
      seg_list, seg_q, q, static_cast<const T*>(packed), ids, out_keys, out_pos, S, d, L,
      kk, n_groups, metric);
  return cudaGetLastError();
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
  const size_t smem = dyn_smem_bytes(kk);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(blocks, smem, st, seg_list, seg_q, q, packed, ids,
                                   out_keys, out_pos, S, d, L, kk, n_groups, metric)
           : launch<float>(blocks, smem, st, seg_list, seg_q, q, packed, ids, out_keys,
                           out_pos, S, d, L, kk, n_groups, metric);
  return (int)e;
}
