// ivfpq_lut_scan_topk: fused IVF-PQ scan over packed pq_bits (4..8) codes,
// keeping the two best candidates per strided bin (position mod 128) for
// every (segment, query slot). Unfolded code layout only.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:ivfpq_lut_scan_topk
// (l.807; body _ivfpq_lut_scan_kernel l.721, tile update _lut_tile_update
// l.588, operands _lut_scan_operands l.685). The TPU decoded codes with a
// one-hot x codebook matmul on the MXU; here the per-query look-up table
// lives in shared memory, the shape of the reference CUDA
// ivf_pq_compute_similarity kernel.
//
// For a live slot with query q (rotated) of a segment owning list l:
//   LUT[s, c] = <q_s, cb[s, c]>                        (f32, shared memory)
//   dot      = <q, centers_rot[l]> + sum_s LUT[s, code_s(p)]
//   key      = norms[l, p] - 2 * dot   (l2)  |  -dot   (ip)
// invalid ids (< 0) and positions >= L give (+inf, -1). Bin b = p mod 128
// keeps the two smallest (key, position) pairs in lexicographic order --
// what a walk of the bin in position order with a strict < keeps, i.e. the
// TPU kernel's bin contents. Output [n_seg, seg, 256]: columns 0..127 the
// best per bin, 128..255 the second best. Pad slots (seg_q < 0) get the
// (+inf, -1) sentinel.
//
// Bound on the H100: bytes, at the main path. The kernel must read the
// probed lists' codes, ids and norms once and write the [n_seg, seg, 256]
// key/id tables (2.2 GB at 500 queries x 64 probes over 8192 lists, where
// most of the 128 slots of a segment are pads): ~0.9 ms at 3.35 TB/s.
// The arithmetic is pq_dim shared-memory look-ups and adds per
// (live query, candidate).
//
// Design: one block of 128 * R threads per segment (R row groups, 1..4),
// each thread one strided bin of a row group; the f32 LUTs of up to QG
// live queries in shared memory; code tiles loaded 16 bytes a thread one
// tile ahead. The device code (lut_scan_segment) lives in
// lut_scan_common.cuh, shared with the fused scan of ring_lut_scan.cu. Pad
// slots are skipped: at the main path a segment holds ~4 live queries of
// its 128 slots; a separate pass writes their sentinels.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lut_scan_common.cuh"

namespace {

using rtt::kLutBins;

template <bool kBytes8>
__global__ void __launch_bounds__(kLutBins * rtt::kLutMaxR)
lut_scan_kernel(const int* __restrict__ seg_list, const int* __restrict__ seg_q,
                const float* __restrict__ q_rot, const uint8_t* __restrict__ codes,
                const int* __restrict__ ids, const float* __restrict__ norms,
                const float* __restrict__ centers_rot, const float* __restrict__ cb,
                float* __restrict__ out_keys, int* __restrict__ out_ids, int seg,
                int rot, int S, int K, int P, int pq_bits, int nb, int L,
                int metric, int qg, int stride, int n_chunks) {
  extern __shared__ float smem[];
  const long s = blockIdx.x;
  rtt::lut_scan_segment<kBytes8>(smem, s, seg_list[s], seg_q + s * seg, q_rot,
                                 codes, ids, norms, centers_rot, cb, out_keys,
                                 out_ids, seg, rot, S, K, P, pq_bits, nb, L,
                                 metric, qg, stride, n_chunks);
}

// (+inf, -1) sentinel rows for pad slots: a separate pass without shared
// memory, so many blocks per SM stream the writes (the scan kernel's
// large shared-memory footprint leaves it one block per SM).
__global__ void __launch_bounds__(2 * kLutBins)
pad_fill_kernel(const int* __restrict__ seg_q, float* __restrict__ out_keys,
                int* __restrict__ out_ids, int seg) {
  const long s = blockIdx.x;
  for (int j = 0; j < seg; ++j) {
    if (seg_q[s * seg + j] < 0) {
      const long o = (s * seg + j) * (2 * kLutBins) + threadIdx.x;
      out_keys[o] = CUDART_INF_F;
      out_ids[o] = -1;
    }
  }
}

template <bool kBytes8>
cudaError_t launch(int n_seg, int R, size_t smem, cudaStream_t stream,
                   const int* seg_list, const int* seg_q, const float* q_rot,
                   const uint8_t* codes, const int* ids, const float* norms,
                   const float* centers_rot, const float* cb, float* out_keys,
                   int* out_ids, int seg, int rot, int S, int K, int P,
                   int pq_bits, int nb, int L, int metric, int qg,
                   int n_chunks) {
  cudaError_t e = cudaFuncSetAttribute(
      lut_scan_kernel<kBytes8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  lut_scan_kernel<kBytes8><<<n_seg, kLutBins * R, smem, stream>>>(
      seg_list, seg_q, q_rot, codes, ids, norms, centers_rot, cb, out_keys,
      out_ids, seg, rot, S, K, P, pq_bits, nb, L, metric, qg,
      rtt::lut_row_stride(nb), n_chunks);
  return cudaSuccess;
}

}  // namespace

extern "C" long rtt_lut_scan_smem_bytes(int qg, int R, int S, int K, int rot,
                                        int seg, int nb) {
  return (long)rtt::lut_smem_bytes(qg, R, S, K, rot, seg, nb);
}

// metric: 0 l2, 1 inner product. qg: live queries per pass, 1..4; R: row
// groups, 1..4 (128 * R threads); seg <= 128 * R.
extern "C" int rtt_ivfpq_lut_scan_topk(
    const int* seg_list, const int* seg_q, const float* q_rot,
    const uint8_t* codes, const int* ids, const float* norms,
    const float* centers_rot, const float* cb, float* out_keys, int* out_ids,
    int n_seg, int seg, int rot, int S, int K, int P, int pq_bits, int nb,
    int L, int metric, int qg, int R, void* stream) {
  if (qg < 1 || qg > rtt::kLutMaxQG || R < 1 || R > rtt::kLutMaxR ||
      seg > kLutBins * R)
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = rtt::lut_smem_bytes(qg, R, S, K, rot, seg, nb);
  pad_fill_kernel<<<n_seg, 2 * kLutBins, 0, st>>>(seg_q, out_keys, out_ids, seg);
  const bool bytes8 = pq_bits == 8 && S % 4 == 0;
  const int n_chunks = rtt::lut_prefetch_chunks(nb, codes);
  cudaError_t e = bytes8
      ? launch<true>(n_seg, R, smem, st, seg_list, seg_q, q_rot, codes, ids, norms,
                     centers_rot, cb, out_keys, out_ids, seg, rot, S, K, P,
                     pq_bits, nb, L, metric, qg, n_chunks)
      : launch<false>(n_seg, R, smem, st, seg_list, seg_q, q_rot, codes, ids, norms,
                      centers_rot, cb, out_keys, out_ids, seg, rot, S, K, P,
                      pq_bits, nb, L, metric, qg, n_chunks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
