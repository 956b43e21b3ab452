// ring_lut_scan_merge: the sharded IVF-PQ scan folded into the ring top-k
// exchange. Each rank scans, for every chunk row, the lists that row probed
// on the rank's own shard, keeps the two best per strided bin per (row,
// list) -- exactly as ivfpq_lut_scan.cu does -- and k-merges them across
// the lists and along the ring, so the per-shard [m, k] candidate table of
// the unfused path never exists.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:ring_lut_scan_merge
// (l.2010; body _ring_lut_scan_kernel l.1696), one persistent program per
// chip whose scan of chunk c ran under the remote copy of the previous hop.
// Its result for a chunk row is the top-k, by (key, position), of incoming
// ++ local, where local is the row's bins laid out in union order (list
// after list, each its 256 bin columns) -- ops/kernels.py:
// ring_lut_scan_merge_plain.
//
// Bound on the H100: bytes, the codes, ids and norms of the probed lists'
// real rows, once per (rank, member row), 0.19 ms at the sharded fused
// tier's shape (4 ranks on one card, 32 queries, 8192 member pairs, lists
// of ~1,100 rows, 64-byte codes); the look-up floor beside it, pq_dim
// shared-memory words per (member pair, real row) at 32 words a clock on
// 132 SMs, is about 0.07 ms.
//
// Design: two launches a call, whatever the rank count.
// 1. Query-major local top-k: one block per (rank r, chunk c, chunk row i)
//    builds the row's LUT against the rank's codebook once into shared
//    memory (lut_scan_common.cuh's layouts: the rotated [2^bits][pq_dim]
//    look-up for 8-bit codes, pq_dim a multiple of 32), then its warps walk
//    the lists the row probed. Work items are (list, quarter of the bins):
//    a warp takes the next item from a shared counter and its lane l walks
//    the list's rows 32q + l, 32q + l + 128, ... up to the list's size, so
//    the lane owns strided bin 32q + l of that list and keeps its two best
//    in registers (positions rise: a strict < keeps the first). At the
//    item's end the 64 bin entries go to the warp's running top-k in
//    registers (ring_common.cuh's merge, skipped by one vote when none
//    beats the k-th), ordered on (key, position) with position = union
//    position of the list x 256 + bin column: the plain version's order,
//    whatever order the items are taken in. The warps' lists then merge in
//    the block into the row's local top-k, the only scratch: [n, mc, k] per
//    rank. No barrier separates items, and a warp keeps the next row's
//    16-byte code loads in flight while it scans the current one.
// 2. The ring as chains (ring_common.cuh, B7's kernel): chunk c's result is
//    rank c + 1's local top-k, then ranks c + 2 ... c merged in, incoming
//    before local -- the ring's hop order, exactly, with every rank on one
//    card.
// The LUT is built once per (query, rank): PRs 3-5 built it once per
// (probed list, rank), 256 times a query at 64 probes and 4 ranks.
// A filter (the TPU kernel's filter_bytes, l.2017) is one pointer a rank to
// its keep bytes [n_lists, ceil(L / 8)], or null: a row's keep bit is read
// beside its id, and a row that is not kept takes the pad's path (id -1,
// no look-ups), so its bins hold only kept rows.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lut_scan_common.cuh"
#include "ring_common.cuh"

namespace {

using rtt::Cand;
using rtt::kMaxRanks;

constexpr int kMaxWarps = 16;
constexpr int kCtrWords = 2 + 32;  // item count, next item, warp counts

struct ScanTables {
  const int* lists[kMaxRanks];   // [n, NS] union lists per chunk, -1 pad
  const float* ind[kMaxRanks];   // [n, NS, mc] 1 where the row probed it
  const float* qv[kMaxRanks];    // [n, mc, rot] rotated chunk queries
  const uint8_t* codes[kMaxRanks];
  const int* ids[kMaxRanks];
  const float* norms[kMaxRanks];
  const int* sizes[kMaxRanks];   // [n_lists] real rows per list
  const float* centers_rot[kMaxRanks];
  const float* cb[kMaxRanks];
  float* part_k[kMaxRanks];      // [n * mc, k] local top-k per rank
  int* part_i[kMaxRanks];
  const uint8_t* fbytes[kMaxRanks];  // [n_lists, ceil(L / 8)] keep bytes, or null
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Dynamic shared memory of a local block of W warps: the member-list table
// (int4 a list), the LUT and the query, the warps' top-k for the final
// merge, the counters, then (unrotated look-up) a code tile of 32 rows a
// warp.
inline size_t local_smem_bytes(int W, int S, int K, int rot, int NS, int nb,
                               int k, int rot_lut) {
  size_t b = (size_t)NS * 16 +
             ((size_t)S * K + rot + 3 * (size_t)W * k + kCtrWords) * 4;
  b = align16(b);
  if (!rot_lut) b += (size_t)W * 32 * rtt::lut_row_stride(nb);
  return b;
}

__device__ __forceinline__ Cand cand_of(float v, int id, uint32_t pos) {
  return v < CUDART_INF_F ? Cand{v, id, rtt::order_key(v), pos} : rtt::gone();
}

template <bool kBytes8, int kW>
__global__ void __launch_bounds__(32 * kMaxWarps)
ring_local_kernel(ScanTables t, int n, int NS, int mc, int k, int rot, int S,
                  int K, int P, int pq_bits, int nb, int L, int metric,
                  int stride) {
  extern __shared__ __align__(16) float smem[];
  const int SK = S * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, W = nthr >> 5;
  const int r = blockIdx.x / (n * mc);
  const int c = (blockIdx.x / mc) % n;
  const int row = blockIdx.x % mc;

  int4* items = reinterpret_cast<int4*>(smem);        // [NS] p, list, size, qc
  float* lut = reinterpret_cast<float*>(items + NS);  // [S * K]
  float* qvs = lut + SK;                               // [rot]
  float* mv = qvs + rot;                               // [W][k] final merge
  int* mid = reinterpret_cast<int*>(mv + W * k);
  int* mpos = mid + W * k;
  int* ctr = mpos + W * k;                             // [kCtrWords]
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem) +
                   align16((size_t)NS * 16 + ((size_t)SK + rot + 3 * W * k +
                                                kCtrWords) * 4);

  const int* lists = t.lists[r] + (size_t)c * NS;
  const float* ind = t.ind[r] + (size_t)c * NS * mc + row;
  const float* q = t.qv[r] + ((size_t)c * mc + row) * rot;
  const int* sizes = t.sizes[r];
  const float* ctr_rot = t.centers_rot[r];
  const float* cb = t.cb[r];

  // the row's member lists, in union order (warp ballots), and its query
  for (int j = tid; j < rot; j += nthr) qvs[j] = q[j];
  int n_mem = 0;
  for (int base = 0; base < NS; base += nthr) {
    const int p = base + tid;
    const int lst = p < NS ? lists[p] : -1;
    const bool mem = lst >= 0 && ind[(size_t)p * mc] > 0.5f;
    const unsigned bal = __ballot_sync(rtt::kFullMask, mem);
    if (lane == 0) ctr[2 + warp] = __popc(bal);
    __syncthreads();
    int off = n_mem, total = 0;
    for (int w = 0; w < W; ++w) {
      if (w < warp) off += ctr[2 + w];
      total += ctr[2 + w];
    }
    if (mem)
      items[off + __popc(bal & ((1u << lane) - 1u))] =
          make_int4(p, lst, max(0, min(sizes[lst], L)), 0);
    __syncthreads();
    n_mem += total;
  }
  if (tid == 0) ctr[1] = 0;
  // the LUT of the row's query against the rank's codebook: entry e is
  // (subspace e / K, code e % K), or (e % S, e / S) rotated
  if (P == 2) {
    const float2* cb2 = reinterpret_cast<const float2*>(cb);
    for (int e0 = tid; e0 < SK; e0 += 16 * nthr) {
      float2 cc[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * nthr;
        cc[u] = e < SK ? cb2[e] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * nthr;
        if (e < SK) {
          const float* qs = qvs + (kW ? e % (4 * kW) : e / K) * 2;
          lut[e] = fmaf(qs[1], cc[u].y, qs[0] * cc[u].x);
        }
      }
    }
  } else {
    for (int e = tid; e < SK; e += nthr) {
      const float* qs = qvs + (kW ? e % (4 * kW) : e / K) * P;
      const float* ce = cb + (long)e * P;
      float a = 0.f;
      for (int p = 0; p < P; ++p) a = fmaf(qs[p], ce[p], a);
      lut[e] = a;
    }
  }
  // <q, center> of each member list: a warp a list
  for (int u = warp; u < n_mem; u += W) {
    const float* ce = ctr_rot + (long)items[u].y * rot;
    float a = 0.f;
    for (int j = lane; j < rot; j += 32) a = fmaf(qvs[j], ce[j], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(rtt::kFullMask, a, off);
    if (lane == 0) items[u].w = __float_as_int(a);
  }
  __syncthreads();

  // the warp's items: (member u, quarter qd) = (it / 4, it % 4)
  const int n_items = 4 * n_mem;
  auto steps = [&](int it) {  // rows a lane walks in the item
    const int sz = items[it >> 2].z, q0 = 32 * (it & 3);
    return sz > q0 ? (sz - q0 + 127) >> 7 : 0;
  };
  auto next_item = [&]() {  // the next item with rows, or -1
    for (;;) {
      int it = 0;
      if (lane == 0) it = atomicAdd(&ctr[1], 1);
      it = __shfl_sync(rtt::kFullMask, it, 0);
      if (it >= n_items) return -1;
      if (steps(it) > 0) return it;
    }
  };
  const long lrow0_of = (long)L;  // rows of a list in the code table
  constexpr int C = kW > 0 ? kW / 4 : 1;  // 16-byte chunks of a row (rotated)
  const uint4* rows = reinterpret_cast<const uint4*>(t.codes[r]);
  const int* gids = t.ids[r];
  const float* gnorms = t.norms[r];
  const uint8_t* fb = t.fbytes[r];
  const long fb_row = (L + 7) >> 3;  // keep bytes a list

  Cand top[2] = {rtt::gone(), rtt::gone()};  // the warp's running top-k
  float k1 = CUDART_INF_F, k2 = CUDART_INF_F;
  int i1 = -1, i2 = -1;
  // the row fetched ahead: item, step, and (rotated) codes, id, norm
  int f_it = next_item(), f_m = 0, f_steps = f_it >= 0 ? steps(f_it) : 0;
  uint4 nx[C];
  int nx_id = -1;
  float nx_nrm = 0.f;
  auto fetch = [&]() {
    nx_id = -1;
    if (f_it < 0) return;
    const int4 e = items[f_it >> 2];
    const int pos = 128 * f_m + 32 * (f_it & 3) + lane;
    const uint8_t* frow = fb ? fb + e.y * fb_row : nullptr;
    if (pos < e.z && rtt::row_kept(frow, pos)) {  // a row not kept loads nothing
      const long g = e.y * lrow0_of + pos;
      nx_id = gids[g];
      nx_nrm = gnorms[g];
      if constexpr (kW > 0) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) nx[cc] = rows[g * C + cc];
      }
    }
  };
  fetch();
  while (f_it >= 0) {
    const int it = f_it, m = f_m, n_steps = f_steps;
    const int id = nx_id;
    const float nrm = nx_nrm;
    uint32_t w[kW > 0 ? kW : 1];
    if constexpr (kW > 0) {
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        w[4 * cc] = nx[cc].x;
        w[4 * cc + 1] = nx[cc].y;
        w[4 * cc + 2] = nx[cc].z;
        w[4 * cc + 3] = nx[cc].w;
      }
    }
    if (++f_m == f_steps) {
      f_it = next_item();
      f_m = 0;
      f_steps = f_it >= 0 ? steps(f_it) : 0;
    }
    fetch();
    const int4 e = items[it >> 2];
    float acc = 0.f;
    if constexpr (kW > 0) {
      if (id >= 0) rtt::adc_words_rot<kW>(w, lut, SK, 1, &acc);
    } else {
      // the item step's 32 rows into the warp's tile, then a row a lane
      const int pos0 = 128 * m + 32 * (it & 3);
      const int nv = min(32, e.z - pos0);
      const uint8_t* src = t.codes[r] + (e.y * lrow0_of + pos0) * nb;
      uint8_t* tile = tiles + (size_t)warp * 32 * stride;
      __syncwarp();
      for (int b = lane; b < nv * nb; b += 32) tile[(b / nb) * stride + b % nb] = src[b];
      __syncwarp();
      if (id >= 0)
        rtt::adc_row<kBytes8>(tile + lane * stride, lut, S, K, SK, pq_bits, nb, 1,
                              &acc);
    }
    if (id >= 0) {
      const float dot = __int_as_float(e.w) + acc;
      const float key = metric == 1 ? -dot : nrm - 2.f * dot;
      if (key < k1) {
        k2 = k1; i2 = i1;
        k1 = key; i1 = id;
      } else if (key < k2) {
        k2 = key; i2 = id;
      }
    }
    if (m == n_steps - 1) {  // the item's bins to the warp's top-k
      const uint32_t col = (uint32_t)e.x * 256u + 32u * (it & 3) + lane;
      Cand l[2] = {cand_of(k1, i1, col), cand_of(k2, i2, col + 128u)};
      rtt::offer_cands(top, l, k, lane);
      k1 = k2 = CUDART_INF_F;
      i1 = i2 = -1;
    }
  }

  // the warps' top-ks into the row's: warp 0 merges the others
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    if (j < k) {
      mv[warp * k + j] = top[s].v;
      mid[warp * k + j] = top[s].id;
      mpos[warp * k + j] = (int)top[s].pos;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w2 = 1; w2 < W; ++w2) {
    Cand l[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = lane + 32 * s;
      l[s] = j < k ? cand_of(mv[w2 * k + j], mid[w2 * k + j], (uint32_t)mpos[w2 * k + j])
                   : rtt::gone();
    }
    rtt::offer_cands(top, l, k, lane);
  }
  const size_t o = ((size_t)c * mc + row) * k;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    if (j < k) {
      const bool inf = !(top[s].v < CUDART_INF_F);
      t.part_k[r][o + j] = inf ? CUDART_INF_F : top[s].v;
      t.part_i[r][o + j] = inf ? -1 : top[s].id;
    }
  }
}

template <bool kBytes8, int kW>
cudaError_t launch_local(const ScanTables& t, size_t smem, int W, cudaStream_t st,
                         int n, int NS, int mc, int k, int rot, int S, int K,
                         int P, int pq_bits, int nb, int L, int metric) {
  cudaError_t e = cudaFuncSetAttribute(ring_local_kernel<kBytes8, kW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  ring_local_kernel<kBytes8, kW><<<n * n * mc, 32 * W, smem, st>>>(
      t, n, NS, mc, k, rot, S, K, P, pq_bits, nb, L, metric, rtt::lut_row_stride(nb));
  return cudaGetLastError();
}

}  // namespace

extern "C" long rtt_ring_lut_scan_smem_bytes(int W, int S, int K, int rot, int NS,
                                             int nb, int k, int rot_lut) {
  return (long)local_smem_bytes(W, S, K, rot, NS, nb, k, rot_lut);
}

// One call over the n ranks, all on card `device`, on `stream`: the local
// launch, then the chain launch. `tables` holds 12 groups of n pointers
// (rank r's at group * n + r): lists [n, NS], ind [n, NS, mc], qv
// [n, mc, rot], codes, ids, norms, sizes, centers_rot, cb (the kernel
// layout: [K, S, P] for rot_lut, else [S, K, P]), part_k / part_i
// [n * mc, k] scratch, and fbytes [n_lists, ceil(L / 8)] (null pointers:
// no filter). out_k / out_i [n, mc, k]: chunk c at index c. W:
// warps of a local block (1, 2, 4, 8 or 16). metric: 0 l2, 1 inner
// product. rot_lut: 1 for the rotated look-up (8-bit codes, S a multiple
// of 32 up to 128, every rank's codes 16-byte aligned).
extern "C" int rtt_ring_lut_scan_merge(const void* const* tables, int n, int NS,
                                       int mc, int k, int rot, int S, int K, int P,
                                       int pq_bits, int nb, int L, int metric,
                                       int W, int rot_lut, void* out_k,
                                       void* out_i, int device, void* stream) {
  if (n < 1 || n > kMaxRanks || k < 1 || k > rtt::kMaxK || NS < 1 || mc < 1 ||
      W < 1 || W > kMaxWarps || (W & (W - 1)) || (long)n * n * mc > 0x7fffffffL ||
      (rot_lut && (pq_bits != 8 || S % 32 != 0 || S > 128)))
    return (int)cudaErrorInvalidValue;
  ScanTables t;
  for (int r = 0; r < n; ++r) {
    t.lists[r] = (const int*)tables[r];
    t.ind[r] = (const float*)tables[n + r];
    t.qv[r] = (const float*)tables[2 * n + r];
    t.codes[r] = (const uint8_t*)tables[3 * n + r];
    t.ids[r] = (const int*)tables[4 * n + r];
    t.norms[r] = (const float*)tables[5 * n + r];
    t.sizes[r] = (const int*)tables[6 * n + r];
    t.centers_rot[r] = (const float*)tables[7 * n + r];
    t.cb[r] = (const float*)tables[8 * n + r];
    t.part_k[r] = (float*)tables[9 * n + r];
    t.part_i[r] = (int*)tables[10 * n + r];
    t.fbytes[r] = (const uint8_t*)tables[11 * n + r];
    if (rot_lut && ((uintptr_t)t.codes[r] & 15)) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = local_smem_bytes(W, S, K, rot, NS, nb, k, rot_lut);
  int prev = device;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const bool bytes8 = pq_bits == 8 && S % 4 == 0;
#define RTT_RING_LOCAL(B8, KW)                                                   \
  launch_local<B8, KW>(t, smem, W, s, n, NS, mc, k, rot, S, K, P, pq_bits, nb, L, \
                       metric)
  if (rot_lut) {
    e = S == 32   ? RTT_RING_LOCAL(true, 8)
        : S == 64 ? RTT_RING_LOCAL(true, 16)
        : S == 96 ? RTT_RING_LOCAL(true, 24)
                  : RTT_RING_LOCAL(true, 32);
  } else {
    e = bytes8 ? RTT_RING_LOCAL(true, 0) : RTT_RING_LOCAL(false, 0);
  }
#undef RTT_RING_LOCAL
  if (e == cudaSuccess) {
    rtt::RankTables ch;
    for (int r = 0; r < n; ++r) {
      ch.keys[r] = t.part_k[r];
      ch.ids[r] = t.part_i[r];
    }
    rtt::ring_chain_kernel<<<rtt::ring_chain_blocks(n, mc), 32 * rtt::kChainWarps,
                             0, s>>>(ch, n, n * mc, mc, k, k, true, (float*)out_k,
                                     (int*)out_i);
    e = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}
