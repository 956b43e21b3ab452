// ring_lut_scan_merge: the sharded IVF-PQ scan folded into the ring top-k
// exchange. Per hop, each rank scans the union of probed lists of the
// chunk it merges next on its own shard, keeps the two best per strided
// bin per (member query, list) -- exactly as ivfpq_lut_scan.cu does --
// then k-merges across the lists and with the incoming partial in one
// pass, so the per-shard [m, k] candidate table of the unfused path never
// exists.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:ring_lut_scan_merge
// (l.2010; body _ring_lut_scan_kernel l.1696). The TPU kernel was one
// persistent program per chip whose scan of chunk c ran under the remote
// copy of the previous hop. Here each hop is two launches over every rank
// of the mesh, all on one card: the scan kernel (one block per union list
// of the chunk and rank; the device code of lut_scan_common.cuh, LUTs in
// shared memory, 16-byte code tile loads, strided two-best bins) writes
// the members' bins to a per-rank scratch [NS, mc, 256]; the merge kernel
// (one block per chunk row and rank) walks the row's member lists in union
// order and merges their bins, and the incoming partial from the left
// neighbour's running block, into the k best -- the ring's hop order and
// slots of ring_common.cuh. The
// union lists are sorted ascending (the JAX package's _chunk_unions), so
// ties go to the incoming partial, then to the earlier list, then to the
// lower bin column: the TPU kernel's extraction order. Fusing both into
// one persistent kernel, with the scan under the exchange, is later work.
//
// Bound on the H100: bytes, as the LUT scan: the codes, ids and norms of
// the union lists' real rows, read once per chunk, plus the LUT builds'
// operations (2 * pq_dim * 2^bits * pq_len per member pair).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lut_scan_common.cuh"
#include "ring_common.cuh"

namespace {

constexpr int kMergeWarps = 8;
constexpr int kBinCols = 2 * rtt::kLutBins;  // 256 bin columns per pair

struct ScanTables {
  const int* lists[rtt::kMaxRanks];   // [n, NS] union lists per chunk, -1 pad
  const int* seg_q[rtt::kMaxRanks];   // [n, NS, mc] member row or -1
  const float* qv[rtt::kMaxRanks];    // [n, mc, rot] rotated chunk queries
  const uint8_t* codes[rtt::kMaxRanks];
  const int* ids[rtt::kMaxRanks];
  const float* norms[rtt::kMaxRanks];
  const int* sizes[rtt::kMaxRanks];   // [n_lists] real rows per list
  const float* centers_rot[rtt::kMaxRanks];
  const float* cb[rtt::kMaxRanks];
  float* bins_k[rtt::kMaxRanks];      // [NS, mc, 256] scratch per rank
  int* bins_i[rtt::kMaxRanks];
};

struct MergeTables {
  const int* seg_q[rtt::kMaxRanks];
  const float* bins_k[rtt::kMaxRanks];
  const int* bins_i[rtt::kMaxRanks];
  float* run_k[rtt::kMaxRanks];       // [n, mc, k] per rank
  int* run_i[rtt::kMaxRanks];
};

template <bool kBytes8, int kW>
__global__ void __launch_bounds__(rtt::kLutBins * rtt::kLutMaxR)
ring_scan_kernel(ScanTables t, int n, int NS, int mc, int hop, int rot, int S,
                 int K, int P, int pq_bits, int nb, int L, int metric, int qg,
                 int stride, int n_chunks) {
  extern __shared__ float smem[];
  const int r = blockIdx.y;
  const int p = blockIdx.x;
  const int c = rtt::ring_chunk(r, hop, n);
  const int lst = t.lists[r][(size_t)c * NS + p];
  if (lst < 0) return;  // a pad segment: no member rows
  // every member row of the list in one block, walked to its size
  const int size = max(0, min(t.sizes[r][lst], L));
  rtt::lut_scan_segment<kBytes8, kW>(
      smem, p, lst, size, t.seg_q[r] + ((size_t)c * NS + p) * mc, nullptr, 0,
      mc, t.qv[r] + (size_t)c * mc * rot, t.codes[r], t.ids[r], t.norms[r],
      t.centers_rot[r], t.cb[r], t.bins_k[r], t.bins_i[r], mc, rot, S, K, P,
      pq_bits, nb, L, metric, qg, stride, n_chunks);
}

__global__ void __launch_bounds__(32 * kMergeWarps)
ring_lut_merge_kernel(MergeTables t, int n, int NS, int mc, int k, int hop) {
  __shared__ float sv[kMergeWarps][rtt::kMaxK];
  __shared__ int si[kMergeWarps][rtt::kMaxK];
  __shared__ int cnts[kMergeWarps];
  const int r = blockIdx.y;
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = rtt::ring_chunk(r, hop, n);
  const int* sq = t.seg_q[r] + (size_t)c * NS * mc;
  const int* ii = nullptr;
  float* bv = sv[warp];
  int* bi = si[warp];
  int cnt = 0;
  if (hop >= 0 && warp == 0) {  // warp 0 starts from the incoming partial
    const int left = rtt::ring_mod(r - 1, n);
    const size_t in_off = ((size_t)hop * mc + row) * k;
    ii = t.run_i[left] + in_off;
    cnt = rtt::ring_load_incoming(t.run_k[left] + in_off, k, bv, bi, lane);
  }
  // each warp walks every kMergeWarps-th member list of the row
  for (int p = warp; p < NS; p += kMergeWarps) {
    if (sq[(size_t)p * mc + row] < 0) continue;  // not a member (warp-uniform)
    const float* bk = t.bins_k[r] + ((size_t)p * mc + row) * kBinCols;
    for (int base = 0; base < kBinCols; base += 32) {
      const float v = bk[base + lane];
      cnt = rtt::warp_offer(v, k + p * kBinCols + base + lane,
                            v < CUDART_INF_F, k, bv, bi, cnt, lane);
    }
  }
  if (lane == 0) cnts[warp] = cnt;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kMergeWarps; ++w) {
    const int cw = cnts[w];
    for (int j = 0; j < cw; ++j) {
      const float v = sv[w][j];
      const int pos = si[w][j];
      if (cnt == k && !rtt::key_less(v, pos, bv[k - 1], bi[k - 1])) break;
      cnt = rtt::warp_insert(bv, bi, cnt, k, v, pos, lane);
    }
  }
  const int* bins_i = t.bins_i[r];
  const size_t out_off = ((size_t)(hop + 1) * mc + row) * k;
  rtt::ring_store(bv, bi, cnt, k, t.run_k[r] + out_off, t.run_i[r] + out_off,
                  [&](int pos) {
                    if (pos < k) return ii[pos];
                    const int q = pos - k;
                    const int p = q / kBinCols;
                    return bins_i[((size_t)p * mc + row) * kBinCols + q % kBinCols];
                  },
                  lane);
}

template <bool kBytes8, int kW>
cudaError_t launch_scan(const ScanTables& t, size_t smem, int R,
                        cudaStream_t st, int n, int NS, int mc, int hop,
                        int rot, int S, int K, int P, int pq_bits, int nb,
                        int L, int metric, int qg, int n_chunks) {
  cudaError_t e = cudaFuncSetAttribute(
      ring_scan_kernel<kBytes8, kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  ring_scan_kernel<kBytes8, kW><<<dim3(NS, n), rtt::kLutBins * R, smem, st>>>(
      t, n, NS, mc, hop, rot, S, K, P, pq_bits, nb, L, metric, qg,
      rtt::lut_row_stride(nb), n_chunks);
  return cudaGetLastError();
}

}  // namespace

// One hop (hop = -1: the start) for the n ranks, all on card `device`: the
// scan launch, then the merge launch, on `stream`. Tables hold n pointers
// each, one per rank; `sizes` holds each rank's real rows per list. metric: 0 l2, 1 inner product. qg: live queries per
// scan pass (1..4); R: row groups (1..4); mc <= 128 * R. rot_lut: 1 for
// the rotated look-up (8-bit codes, S a multiple of 32 up to 128, every
// rank's codes 16-byte aligned and cb [K, S, P]-major), 0 for cb [S, K, P].
extern "C" int rtt_ring_lut_scan_hop(
    const void* const* lists, const void* const* seg_q, const void* const* qv,
    const void* const* codes, const void* const* ids, const void* const* norms,
    const void* const* sizes, const void* const* centers_rot,
    const void* const* cb,
    void* const* bins_k, void* const* bins_i, void* const* run_k,
    void* const* run_i, int n, int NS, int mc, int k, int hop, int rot, int S,
    int K, int P, int pq_bits, int nb, int L, int metric, int qg, int R,
    int rot_lut, int device, void* stream) {
  if (n < 1 || n > rtt::kMaxRanks || k < 1 || k > rtt::kMaxK || NS < 1 ||
      mc < 1 || hop < -1 || hop > n - 2 || qg < 1 || qg > rtt::kLutMaxQG ||
      R < 1 || R > rtt::kLutMaxR || mc > rtt::kLutBins * R ||
      (rot_lut && (pq_bits != 8 || S % 32 != 0 || S > 128)))
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n && rot_lut; ++r)
    if ((uintptr_t)codes[r] & 15) return (int)cudaErrorInvalidValue;
  ScanTables st;
  MergeTables mt;
  for (int r = 0; r < n; ++r) {
    st.lists[r] = (const int*)lists[r];
    st.seg_q[r] = mt.seg_q[r] = (const int*)seg_q[r];
    st.qv[r] = (const float*)qv[r];
    st.codes[r] = (const uint8_t*)codes[r];
    st.ids[r] = (const int*)ids[r];
    st.norms[r] = (const float*)norms[r];
    st.sizes[r] = (const int*)sizes[r];
    st.centers_rot[r] = (const float*)centers_rot[r];
    st.cb[r] = (const float*)cb[r];
    st.bins_k[r] = (float*)bins_k[r];
    st.bins_i[r] = (int*)bins_i[r];
    mt.bins_k[r] = (const float*)bins_k[r];
    mt.bins_i[r] = (const int*)bins_i[r];
    mt.run_k[r] = (float*)run_k[r];
    mt.run_i[r] = (int*)run_i[r];
  }
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = rtt::lut_smem_bytes(qg, R, S, K, rot, mc, nb);
  // every rank's codes must allow the 16-byte path for the launch to take it
  int n_chunks = rtt::kLutMaxChunks + 1;
  for (int r = 0; r < n; ++r) {
    const int c = rtt::lut_prefetch_chunks(nb, codes[r]);
    n_chunks = c < n_chunks ? c : n_chunks;
  }
  const bool bytes8 = pq_bits == 8 && S % 4 == 0;
#define RTT_RING_SCAN(B8, KW)                                                  \
  launch_scan<B8, KW>(st, smem, R, s, n, NS, mc, hop, rot, S, K, P, pq_bits, \
                      nb, L, metric, qg, n_chunks)
  if (rot_lut) {
    e = S == 32   ? RTT_RING_SCAN(true, 8)
        : S == 64 ? RTT_RING_SCAN(true, 16)
        : S == 96 ? RTT_RING_SCAN(true, 24)
                  : RTT_RING_SCAN(true, 32);
  } else {
    e = bytes8 ? RTT_RING_SCAN(true, 0) : RTT_RING_SCAN(false, 0);
  }
#undef RTT_RING_SCAN
  if (e == cudaSuccess) {
    ring_lut_merge_kernel<<<dim3(mc, n), 32 * kMergeWarps, 0, s>>>(
        mt, n, NS, mc, k, hop);
    e = cudaGetLastError();
  }
  cudaSetDevice(prev);
  return (int)e;
}
