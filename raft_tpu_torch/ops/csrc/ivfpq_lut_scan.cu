// ivfpq_lut_scan_topk: fused IVF-PQ scan over packed pq_bits (4..8) codes,
// keeping the two best candidates per strided bin (position mod 128) for
// every (query, probe) pair. Unfolded code layout only.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:ivfpq_lut_scan_topk
// (l.807; body _ivfpq_lut_scan_kernel l.721, tile update _lut_tile_update
// l.588, operands _lut_scan_operands l.685). The TPU decoded codes with a
// one-hot x codebook matmul on the MXU; here the per-query look-up table
// lives in shared memory, the shape of the reference CUDA
// ivf_pq_compute_similarity kernel.
//
// For a (query q, probe) pair whose list l holds size[l] real rows:
//   LUT[s, c] = <q_s, cb[s, c]>                        (f32, shared memory)
//   dot      = <q, centers_rot[l]> + sum_s LUT[s, code_s(p)]
//   key      = norms[l, p] - 2 * dot   (l2)  |  -dot   (ip)
// invalid ids (< 0), positions >= size[l] and, with a filter, rows whose
// keep bit fbytes[l, p / 8] >> (p mod 8) is clear give (+inf, -1) -- the
// TPU kernel's filter_bytes (l.813, unpacked by _lut_unpack_filter l.577).
// Bin
// b = p mod 128 keeps the two smallest (key, position) pairs in
// lexicographic order -- what a walk of the bin in position order with a
// strict < keeps, i.e. the TPU kernel's bin contents wherever the rows past
// a list's size are pads (id -1), as pack_lists leaves them. Output
// [B, P, 256] in pair order: columns 0..127 the best per bin, 128..255 the
// second best. The TPU kernel wrote [n_seg, seg, 256], pad slots included,
// and its caller gathered the pairs' rows out of it.
//
// Bound on the H100: bytes, at the main path -- the probed lists' real
// rows (codes, ids, norms) once and the [B, P, 256] key/id table (65.5 MB
// at 500 queries x 64 probes) -- against the look-ups: pq_dim shared-memory
// reads per (live pair, real row), 32 a clock per SM. With a filter the
// look-ups fall to the kept (live pair, real row) pairs, and the bytes grow
// by the probed lists' keep bytes (L / 8 a list).
//
// Design: one block of 128 * R threads per (segment, group of up to QG live
// queries), found from the inclusive prefix `grp_end` of the groups per
// segment (`blk_seg` names each block's segment), so a list probed by many
// queries is walked by several blocks at once and no block re-walks its list
// pass after pass. Each block walks its list only to the list's size; the
// bins of each live slot are written straight to the slot's pair row
// (`slot_row`), so no sentinel table exists. The device code
// (lut_scan_segment: f32 LUTs in shared memory, strided two-best bins, code
// tiles loaded 16 bytes a thread one tile ahead, the bank-conflict-free
// rotated look-up of 8-bit codes) lives in lut_scan_common.cuh, shared with
// ring_lut_scan.cu. A filter is one null-or-not pointer: a row's keep byte
// is read beside its id, and a row that is not kept takes the pad's path
// (no look-ups), so no second pass and no other template.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lut_scan_common.cuh"

namespace {

using rtt::kLutBins;

template <bool kBytes8, int kW>
__global__ void __launch_bounds__(kLutBins * rtt::kLutMaxR)
lut_scan_kernel(const int* __restrict__ seg_list, const int* __restrict__ seg_q,
                const int* __restrict__ slot_row, const int* __restrict__ grp_end,
                const int* __restrict__ blk_seg,
                const float* __restrict__ q_rot, const uint8_t* __restrict__ codes,
                const int* __restrict__ ids, const float* __restrict__ norms,
                const int* __restrict__ sizes,
                const float* __restrict__ centers_rot, const float* __restrict__ cb,
                const uint8_t* __restrict__ fbytes,
                float* __restrict__ out_keys, int* __restrict__ out_ids, int n_seg,
                int seg, int rot, int S, int K, int P, int pq_bits, int nb, int L,
                int metric, int qg, int stride, int n_chunks) {
  extern __shared__ float smem[];
  // this block's (segment, query group): the first segment whose
  // inclusive group prefix passes the block index (n_seg past the end)
  const int b = blockIdx.x;
  const int lo = blk_seg[b];
  if (lo >= n_seg) return;
  const int grp = b - (lo ? grp_end[lo - 1] : 0);
  const long lst = seg_list[lo];
  const int size = max(0, min(sizes[lst], L));
  const uint8_t* frow = fbytes ? fbytes + lst * ((L + 7) >> 3) : nullptr;
  rtt::lut_scan_segment<kBytes8, kW>(
      smem, lo, lst, size, seg_q + (long)lo * seg, slot_row + (long)lo * seg,
      grp * qg, qg, frow, q_rot, codes, ids, norms, centers_rot, cb, out_keys,
      out_ids, seg, rot, S, K, P, pq_bits, nb, L, metric, qg, stride, n_chunks);
}

template <bool kBytes8, int kW>
cudaError_t launch(int n_blocks, int R, size_t smem, cudaStream_t stream,
                   const int* seg_list, const int* seg_q, const int* slot_row,
                   const int* grp_end, const int* blk_seg, const float* q_rot,
                   const uint8_t* codes,
                   const int* ids, const float* norms, const int* sizes,
                   const float* centers_rot, const float* cb,
                   const uint8_t* fbytes, float* out_keys,
                   int* out_ids, int n_seg, int seg, int rot, int S, int K,
                   int P, int pq_bits, int nb, int L, int metric, int qg,
                   int n_chunks) {
  cudaError_t e = cudaFuncSetAttribute(
      lut_scan_kernel<kBytes8, kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  lut_scan_kernel<kBytes8, kW><<<n_blocks, kLutBins * R, smem, stream>>>(
      seg_list, seg_q, slot_row, grp_end, blk_seg, q_rot, codes, ids, norms,
      sizes, centers_rot, cb, fbytes, out_keys, out_ids, n_seg, seg, rot, S, K,
      P, pq_bits, nb, L, metric, qg, rtt::lut_row_stride(nb), n_chunks);
  return cudaSuccess;
}

}  // namespace

extern "C" long rtt_lut_scan_smem_bytes(int qg, int R, int S, int K, int rot,
                                        int seg, int nb) {
  return (long)rtt::lut_smem_bytes(qg, R, S, K, rot, seg, nb);
}

// metric: 0 l2, 1 inner product. qg: live queries per block, 1..4; R: row
// groups, 1..4 (128 * R threads); seg <= 128 * R. grp_end [n_seg]: the
// inclusive prefix of ceil(live slots / qg) per segment; blk_seg
// [n_blocks]: each block's segment (the first whose grp_end passes the
// block index; n_seg for blocks past the last group, which return at
// once); n_blocks: at least grp_end's last entry. slot_row
// [n_seg, seg]: the output row of each live slot. rot_lut: 1 for the
// rotated look-up (8-bit codes, S a multiple of 32 up to 128, codes
// 16-byte aligned, cb [K, S, P]-major), 0 for cb [S, K, P]. fbytes: the
// keep bytes [n_lists, ceil(L / 8)], or null for no filter.
extern "C" int rtt_ivfpq_lut_scan_topk(
    const int* seg_list, const int* seg_q, const int* slot_row,
    const int* grp_end, const int* blk_seg, const float* q_rot,
    const uint8_t* codes, const int* ids, const float* norms, const int* sizes,
    const float* centers_rot, const float* cb, const uint8_t* fbytes,
    float* out_keys, int* out_ids,
    int n_seg, int n_blocks, int seg, int rot, int S, int K, int P,
    int pq_bits, int nb, int L, int metric, int qg, int R, int rot_lut,
    void* stream) {
  if (qg < 1 || qg > rtt::kLutMaxQG || R < 1 || R > rtt::kLutMaxR ||
      seg > kLutBins * R ||
      (rot_lut && (pq_bits != 8 || S % 32 != 0 || S > 128 ||
                   ((uintptr_t)codes & 15))))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0 || n_blocks == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = rtt::lut_smem_bytes(qg, R, S, K, rot, seg, nb);
  const bool bytes8 = pq_bits == 8 && S % 4 == 0;
  const int n_chunks = rtt::lut_prefetch_chunks(nb, codes);
#define RTT_LUT_LAUNCH(B8, KW)                                                 \
  launch<B8, KW>(n_blocks, R, smem, st, seg_list, seg_q, slot_row, grp_end,   \
                 blk_seg, q_rot, codes, ids, norms, sizes, centers_rot, cb,   \
                 fbytes, out_keys, out_ids, n_seg, seg, rot, S, K, P, pq_bits,\
                 nb, L, metric, qg, n_chunks)
  cudaError_t e;
  if (rot_lut) {
    e = S == 32   ? RTT_LUT_LAUNCH(true, 8)
        : S == 64 ? RTT_LUT_LAUNCH(true, 16)
        : S == 96 ? RTT_LUT_LAUNCH(true, 24)
                  : RTT_LUT_LAUNCH(true, 32);
  } else {
    e = bytes8 ? RTT_LUT_LAUNCH(true, 0) : RTT_LUT_LAUNCH(false, 0);
  }
#undef RTT_LUT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
