// segmented_scan_topk: segmented IVF list scan over raw (f32, bf16, int8
// or uint8) vectors keeping the two best candidates per strided bin (position mod
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
// its list), 125 GFLOP, run as three TF32 products (two for bf16 lists):
// 375 GFLOP at 495 TFLOP/s, 0.76 ms (1.87 ms at the 67 TFLOP/s fp32 rate of
// PRs 2-5's FMA kernel); the bytes (the probed lists' rows once, the 0.92
// GB output table) take about 0.4 ms.
//
// Design (scan_common.cuh): one block of 256 threads per (segment, group
// of 32 live queries); the segment's groups are adjacent in launch order,
// so the list block is read from HBM about once and from L2 by the other
// groups. The products are 3xTF32 mma.sync fragments: the thread whose
// accumulator holds (query, tile row r) in one tile holds it in every
// tile, and tile row r is bin r, so each thread keeps the running two-best
// of its 16 (query, bin) pairs in registers across the whole list and no
// key passes through shared memory. It keeps each pick's tile index (16
// bits; the position is tile x 128 + the bin), reading the ids once at the
// end, which leaves room for two blocks an SM. Its positions rise tile by
// tile, so a strict < keeps the earlier position on equal keys: the TPU's
// first-index argmin, exactly. Rows past the list's last valid id are not
// walked. A group with no live query writes its pad sentinels and exits,
// so unused trailing segments cost only their sentinel rows. The bins
// leave as 8-byte pairs of adjacent columns. Measured in turns on an H100
// (700 W) at the main path: with one block-wide ring (a barrier a stage),
// queries split at every fragment load and ids kept, 197 registers left one
// block an SM: 9.3 ms; resident split queries and 16-bit pick tiles, two
// blocks an SM: 5.8 ms; a ring per warp: 5.5 ms; stage and copy cursors
// kept by increments and shifts, not divisions: 4.8 ms (PR 5's fp32 FMA
// kernel: 16.0 ms).
#include <climits>

#include "scan_common.cuh"

namespace {

using namespace rtt_scan;

constexpr int kCols = 2 * kRows;  // output columns per slot

constexpr uint32_t kNoTile = 0xffffu;

// stages of each warp's ring: four with the queries resident (six for
// 1-byte rows), three when each stage also carries the query slice
template <typename T, bool kQRes>
constexpr int kStagesOf = !kQRes ? 3 : sizeof(T) == 1 ? kByteStages : 4;

template <typename T, bool kQRes>
__global__ void __launch_bounds__(kThreads, 2)
segmented_scan_kernel(const int* __restrict__ seg_list, const int* __restrict__ seg_q,
                      const float* __restrict__ q, const T* __restrict__ packed,
                      const int* __restrict__ ids, float* __restrict__ out_keys,
                      int* __restrict__ out_ids, int S, int d, int L, int n_groups,
                      int metric, int xvec, int qvec) {
  __shared__ Stage st;
  extern __shared__ __align__(16) char dyn[];
  char* ring = dyn;
  constexpr int kS = kStagesOf<T, kQRes>;
  float2* qres = reinterpret_cast<float2*>(dyn + ring_bytes<T, kQRes, kS>());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long s = blockIdx.x / n_groups;
  const int grp = blockIdx.x % n_groups;
  const int* sq = seg_q + s * S;

  write_pads(sq, S, grp, s * S, kCols, out_keys, out_ids);
  const int nq = load_queries(sq, S, grp, q, d, st);
  if (nq == 0) return;

  const long lst = seg_list[s];
  const T* list = packed + lst * (long)L * d;
  const int* lid = ids + lst * (long)L;
  const int n_rows = list_rows(lid, L, st);
  if constexpr (kQRes) split_queries(qres, q, d, st, nq);

  // the running two-best of this thread's (query 16i + g + 8h, bin
  // 16w + 8j + 2t + e), c = 2h + e: keys, and the tiles of the picks
  // (first | second << 16, kNoTile for none)
  float qsq[kMT][2];
  bool live[kMT][2];
  float k1[kMT][kNT][4], k2[kMT][kNT][4];
  uint32_t tp[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * i + g + 8 * h;
      live[i][h] = qi < nq;
      qsq[i][h] = live[i][h] ? st.qsq[qi] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        k1[i][j][c] = k2[i][j][c] = CUDART_INF_F;
        tp[i][j][c] = kNoTile | (kNoTile << 16);
      }
  }
  scan_tiles<T, kQRes, kS>(ring, qres, list, lid, n_rows, d, q, st, nq, xvec, qvec,
                           [&](int t0, auto& acc, auto& xn, auto& id) {
    const uint32_t tile = (uint32_t)t0 / kRows;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (live[i][c >> 1]) {
            const int e = c & 1;
            const float key = id[j][e] >= 0
                ? scan_key(metric, acc[i][j][c], qsq[i][c >> 1], xn[j][e])
                : CUDART_INF_F;
            if (key < k1[i][j][c]) {
              k2[i][j][c] = k1[i][j][c];
              k1[i][j][c] = key;
              tp[i][j][c] = tile | (tp[i][j][c] << 16);
            } else if (key < k2[i][j][c]) {
              k2[i][j][c] = key;
              tp[i][j][c] = (tp[i][j][c] & kNoTile) | (tile << 16);
            }
          }
        }
  });
  auto id_of = [&](uint32_t tl, int row) {
    return tl == kNoTile ? -1 : lid[tl * kRows + row];
  };
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * i + g + 8 * h;
      if (qi < nq) {
        const long o = (s * S + st.slot[qi]) * kCols;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int col = 16 * warp + 8 * j + 2 * t;
          const int c = 2 * h;
          const uint32_t a = tp[i][j][c], b = tp[i][j][c + 1];
          *reinterpret_cast<float2*>(out_keys + o + col) =
              make_float2(k1[i][j][c], k1[i][j][c + 1]);
          *reinterpret_cast<float2*>(out_keys + o + kRows + col) =
              make_float2(k2[i][j][c], k2[i][j][c + 1]);
          *reinterpret_cast<int2*>(out_ids + o + col) =
              make_int2(id_of(a & kNoTile, col), id_of(b & kNoTile, col + 1));
          *reinterpret_cast<int2*>(out_ids + o + kRows + col) =
              make_int2(id_of(a >> 16, col), id_of(b >> 16, col + 1));
        }
      }
    }
  }
}

template <typename T, bool kQRes>
cudaError_t launch(long blocks, cudaStream_t st, const int* seg_list, const int* seg_q,
                   const float* q, const void* packed, const int* ids, float* out_keys,
                   int* out_ids, int S, int d, int L, int n_groups, int metric) {
  const size_t smem =
      ring_bytes<T, kQRes, kStagesOf<T, kQRes>>() + (kQRes ? qres_bytes(d) : 0);
  cudaError_t e = cudaFuncSetAttribute(segmented_scan_kernel<T, kQRes>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int xvec = copy_width(d * (int)sizeof(T), packed);
  const int qvec = copy_width(d * 4, q) == 16 ? 16 : 4;
  segmented_scan_kernel<T, kQRes><<<(unsigned)blocks, kThreads, smem, st>>>(
      seg_list, seg_q, q, static_cast<const T*>(packed), ids, out_keys, out_ids, S, d,
      L, n_groups, metric, xvec, qvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(long blocks, cudaStream_t st, const int* seg_list, const int* seg_q,
                   const float* q, const void* packed, const int* ids, float* out_keys,
                   int* out_ids, int S, int d, int L, int n_groups, int metric) {
  return queries_resident(d)
             ? launch<T, true>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys,
                               out_ids, S, d, L, n_groups, metric)
             : launch<T, false>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys,
                                out_ids, S, d, L, n_groups, metric);
}

}  // namespace

// metric: 0 l2, 1 inner product, 2 cosine. row_type: the packed rows'
// element type (RowType: 0 f32, 1 bf16, 2 int8, 3 uint8). out_keys /
// out_ids must be 8-byte aligned (fresh tensors are); L < 2^23 (a pick
// keeps its 16-bit tile index).
extern "C" int rtt_segmented_scan_topk(const int* seg_list, const int* seg_q,
                                       const float* q, const void* packed,
                                       const int* ids, float* out_keys, int* out_ids,
                                       int n_seg, int S, int d, int L, int row_type,
                                       int metric, void* stream) {
  if (S < 1 || S > kMaxS || d < 1 || L < 1 || L >= (int)(kNoTile * kRows) ||
      metric < 0 || metric > 2 || row_type < kRowF32 || row_type > kRowU8 ||
      ((uintptr_t)out_keys & 7) || ((uintptr_t)out_ids & 7))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return (int)cudaSuccess;
  const int n_groups = (S + kQG - 1) / kQG;
  const long blocks = (long)n_seg * n_groups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto row) {
    using T = decltype(row);
    return launch<T>(blocks, st, seg_list, seg_q, q, packed, ids, out_keys, out_ids,
                     S, d, L, n_groups, metric);
  };
  const cudaError_t e = row_type == kRowBF16 ? go(__nv_bfloat16{})
                        : row_type == kRowI8 ? go(int8_t{})
                        : row_type == kRowU8 ? go(uint8_t{})
                                             : go(float{});
  return (int)e;
}
