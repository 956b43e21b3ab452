// Shared pieces of the two IVF list-scan kernels (segmented_scan.cu and
// grouped_scan.cu): the block's live queries and the distance tile, the
// dot products of a 128-row list tile with up to 32 queries.
//
// Numerics: the TPU kernels asked for Precision.HIGHEST
// (pallas_kernels.py:219-221, 351-353). Here <q, x> is 3xTF32 on the
// tensor cores (mma_common.cuh): q_lo.x_hi + q_hi.x_lo + q_hi.x_hi with
// mma.sync m16n8k8, each 32-deep k slice into a fresh accumulator that is
// then added in f32 (as fused_l2_argmin.cu: the tensor cores' accumulation
// does not round to nearest, and over one long k its error grew past the
// tolerance there). bf16 list data is exact in TF32, so x_lo = 0 and two
// products suffice; so are int8 and uint8 rows (|x| <= 255 needs 8 of
// TF32's 11 significant bits), which load as bytes and widen to f32 in
// registers as the fragments are read. |x|^2 and |q|^2 are plain f32 sums.
//
// A block owns one segment (one list) and a group of up to 32 of its live
// queries, and walks the list in tiles of 128 rows up to its last row with
// a valid id (rows past it only hold pads, whose keys are +inf). The 256
// threads are 8 warps; warp w computes the [32 queries x 16 rows] block of
// rows 16w .. 16w + 15 of every tile as 2 x 2 m16n8 fragments. Thread
// (warp w, lane = 4g + t) holds, in accumulator c of fragment (i, j),
//   query 16i + g + 8(c / 2)   against   tile row 16w + 8j + 2t + c % 2,
// the same (query, tile row) in every tile: tile row r of a 128-row tile
// is strided bin r, so the thread that owns a (query, bin) sees all of its
// positions, in rising order. Up to d 256 (padded to 32) the block's
// queries are split once into a resident (hi, lo) tile in shared memory,
// so the fragments load ready TF32 pairs; past that each stage also
// carries the queries' slice, split as the fragments load. A warp reads
// only its own 16 rows of each list tile, so each warp streams them through
// its own cp.async ring of (tile, k slice) stages (16-, 8- or 4-byte copies
// as the rows' alignment allows; plain loads for 2-byte-aligned bf16 rows),
// zero-filled past d and past the walked rows, so any d runs; the warps
// never wait for each other inside the walk. Slices are stored at row
// strides of 36 words (f32), 20 words (bf16) and 12 words (int8, uint8:
// 48 bytes, so 16-byte copies stay aligned and the 8 rows of a fragment
// load start in 8 distinct banks), the resident queries at dp + 4 (hi, lo)
// pairs, and read as fragments free of bank conflicts.
//
// 1-byte rows keep the 128-row x 32-deep tile: a tile row is a strided bin,
// and the fragment ownership that keeps each (query, bin) in one thread's
// registers fixes the tile's shape. What the smaller rows change is the
// ring: a stage holds 768 bytes of list rows against f32's 2,304, so with
// resident queries each warp's ring runs 6 stages deep (kByteStages), 4.5
// KB of rows in flight a warp, and a block takes 36.9 KB of ring beside its
// resident queries (two blocks an SM up to d 256, as for f32 rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace rtt_scan {

constexpr int kRows = 128;                 // list rows per tile (= strided bins)
constexpr int kQG = 32;                    // live queries per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;      // 256
constexpr int kMT = 2;                     // m16 fragments a warp: 32 queries
constexpr int kNT = 2;                     // n8 fragments a warp: 16 rows
static_assert(16 * kMT == kQG && 8 * kNT * kWarps == kRows, "tile cover");
constexpr int kBK = 32;                    // k depth of a ring stage
constexpr int kWRows = kRows / kWarps;     // list rows of a warp: 16
constexpr int kQS = kBK + 4;               // query slice row stride, words
constexpr int kMaxS = 1024;                // largest segment
constexpr int kQResMax = 256;              // resident queries up to this dp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kByteStages = 6;             // ring stages of 1-byte rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return (float)v; }

// The list rows' element type, as the wrappers pass it.
enum RowType { kRowF32 = 0, kRowBF16 = 1, kRowI8 = 2, kRowU8 = 3 };

template <typename T>
struct ListSlice;
template <>
struct ListSlice<float> {           // 36 words a row (= 4 mod 32)
  static constexpr int kStride = kBK + 4;
  static __device__ __forceinline__ float zero() { return 0.f; }
};
template <>
struct ListSlice<__nv_bfloat16> {   // 40 halves = 20 words a row
  static constexpr int kStride = kBK + 8;
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.f);
  }
};
template <>
struct ListSlice<int8_t> {          // 48 bytes = 12 words a row
  static constexpr int kStride = kBK + 16;
  static __device__ __forceinline__ int8_t zero() { return 0; }
};
template <>
struct ListSlice<uint8_t> {
  static constexpr int kStride = kBK + 16;
  static __device__ __forceinline__ uint8_t zero() { return 0; }
};


// one stage of a warp's ring: its list rows [16][stride] T, then (queries
// streamed) the query slice [32][kQS] f32 (both multiples of 16 bytes)
template <typename T>
__host__ __device__ constexpr size_t list_slice_bytes() {
  return (size_t)kWRows * ListSlice<T>::kStride * sizeof(T);
}
template <typename T, bool kQRes>
__host__ __device__ constexpr size_t stage_bytes() {
  return list_slice_bytes<T>() + (kQRes ? 0 : (size_t)kQG * kQS * 4);
}
// the block's kWarps rings of kS stages
template <typename T, bool kQRes, int kS>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)kWarps * kS * stage_bytes<T, kQRes>();
}

// d padded to the k slice; the resident query tile [kQG][dp + 4] float2
// (dp + 4 = 4 mod 16 pairs: a half warp's 8-byte fragment loads hit 16
// distinct bank pairs)
__host__ __device__ inline int kpad(int d) { return (d + kBK - 1) / kBK * kBK; }
__host__ __device__ inline size_t qres_bytes(int d) {
  return (size_t)kQG * (kpad(d) + 4) * 8;
}
inline bool queries_resident(int d) { return kpad(d) <= kQResMax; }

struct Stage {
  int live[kMaxS];  // live slots of the segment, in slot order
  int slot[kQG];    // slot of each of the block's queries
  int qidx[kQG];    // its query row
  float qsq[kQG];   // its squared norm (f32 sum)
  int wcnt[kWarps];
  int last;         // the list's last row with a valid id
};

// Live slots (seg_q >= 0) of the segment into st.live, in slot order (warp
// ballots). Returns their count.
__device__ __forceinline__ int compact_live(const int* sq, int S, Stage& st) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n_live = 0;
  for (int base = 0; base < S; base += kThreads) {
    const int j = base + tid;
    const bool is_live = j < S && sq[j] >= 0;
    const unsigned bal = __ballot_sync(kFull, is_live);
    if (lane == 0) st.wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = n_live, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += st.wcnt[w];
      total += st.wcnt[w];
    }
    if (is_live) st.live[off + __popc(bal & ((1u << lane) - 1u))] = j;
    __syncthreads();
    n_live += total;
  }
  return n_live;
}

// The block's live queries (group `grp` of the segment's live slots): slot,
// query row and squared norm of each. Returns their count, 0..kQG.
__device__ __forceinline__ int load_queries(const int* sq, int S, int grp,
                                            const float* __restrict__ q, int d,
                                            Stage& st) {
  const int n_live = compact_live(sq, S, st);
  const int g0 = grp * kQG;
  const int nq = min(kQG, max(0, n_live - g0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < nq) {
    st.slot[tid] = st.live[g0 + tid];
    st.qidx[tid] = sq[st.slot[tid]];
  }
  __syncthreads();
  for (int g = warp; g < nq; g += kWarps) {
    const float* qr = q + (long)st.qidx[g] * d;
    float a = 0.f;
    for (int j = lane; j < d; j += 32) a = fmaf(qr[j], qr[j], a);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    if (lane == 0) st.qsq[g] = a;
  }
  __syncthreads();
  return nq;
}

// The pad slots (seg_q < 0) of the block's slot range get (+inf, -1) in
// all `cols` columns of their output rows (row0 + slot).
__device__ __forceinline__ void write_pads(const int* sq, int S, int grp, long row0,
                                           int cols, float* __restrict__ ok,
                                           int* __restrict__ oi) {
  static_assert(kQG == 32, "a warp ballot covers the block's slots");
  const int j0 = grp * kQG, j = j0 + (threadIdx.x & 31);
  unsigned pads = __ballot_sync(kFull, j < S && sq[j] < 0);
  while (pads) {
    const long o = (row0 + j0 + __ffs(pads) - 1) * cols;
    pads &= pads - 1;
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      ok[o + c] = CUDART_INF_F;
      oi[o + c] = -1;
    }
  }
}

// The block's queries split once into the resident tile: (hi, lo) TF32
// pairs, zero past d and for queries >= nq. Read after scan_tiles' first
// barrier.
__device__ __forceinline__ void split_queries(float2* __restrict__ qres,
                                              const float* __restrict__ q, int d,
                                              const Stage& st, int nq) {
  const int dp = kpad(d), QS2 = dp + 4;
  for (int e = threadIdx.x; e < kQG * dp; e += kThreads) {
    const int g = e / dp, k = e % dp;
    const float v = g < nq && k < d ? q[(long)st.qidx[g] * d + k] : 0.f;
    const uint32_t hi = rtt::tf32(v);
    qres[g * QS2 + k] = make_float2(__uint_as_float(hi),
                                    __uint_as_float(rtt::tf32(v - __uint_as_float(hi))));
  }
}

// Rows of the list to walk: one past its last row with a valid id.
__device__ __forceinline__ int list_rows(const int* __restrict__ lid, int L,
                                         Stage& st) {
  if (threadIdx.x == 0) st.last = -1;
  __syncthreads();
  int last = -1;
  for (int p = threadIdx.x; p < L; p += kThreads)
    if (lid[p] >= 0) last = p;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(kFull, last, o));
  if ((threadIdx.x & 31) == 0 && last >= 0) atomicMax(&st.last, last);
  __syncthreads();
  return st.last + 1;
}

// Copy the warp's list rows [r0, r0 + 16) x columns [c0, c0 + 32) (and,
// streamed, the query slice) into its ring stage `dst` and commit them as
// one group; an invalid stage (past the walk) commits an empty group.
// xvec / qvec: bytes a copy (16, 8 or 4; xvec 0: plain loads); lx: log2 of
// the list copies a row slice takes (32 / elements a copy).
template <typename T, bool kQRes>
__device__ __forceinline__ void issue_stage(char* dst, bool valid, long r0, int c0,
                                            const T* __restrict__ list, int n_rows,
                                            int d, const float* __restrict__ q,
                                            const Stage& st, int nq, int xvec, int lx,
                                            int qvec) {
  constexpr int XS = ListSlice<T>::kStride;
  if (valid) {
    const int lane = threadIdx.x & 31;
    T* xs = reinterpret_cast<T*>(dst);
    if (xvec > 0) {  // d is a multiple of the elements a copy
      // a lane's copies share one column and step over rows by 32 >> lx
      const int r = lane >> lx, step = 32 >> lx;
      const int col = (lane & ((1 << lx) - 1)) << (5 - lx);
      const bool col_ok = c0 + col < d;
      const T* src = list + (r0 + r) * d + c0 + col;
      T* to = xs + r * XS + col;
      for (int u = r; u < kWRows; u += step, src += (long)step * d, to += step * XS) {
        const bool ok = col_ok && r0 + u < n_rows;
        const T* from = ok ? src : list;
        if (xvec == 16) rtt::cp_async16(to, from, ok);
        else if (xvec == 8) rtt::cp_async8(to, from, ok);
        else rtt::cp_async4(to, from, ok);
      }
    } else {  // rows not 4-byte aligned: plain loads, read stages on
      for (int e = lane; e < kWRows * kBK; e += 32) {
        const int r = e / kBK, col = e % kBK;
        const bool ok = r0 + r < n_rows && c0 + col < d;
        xs[r * XS + col] = ok ? list[(r0 + r) * d + c0 + col] : ListSlice<T>::zero();
      }
    }
    if constexpr (!kQRes) {
      float* qs = reinterpret_cast<float*>(dst + list_slice_bytes<T>());
      const int lq = qvec == 16 ? 3 : 5, lqe = 5 - lq;  // copies a row: 8 or 32
      for (int e = lane; e < kQG << lq; e += 32) {
        const int g = e >> lq, col = (e & ((1 << lq) - 1)) << lqe;
        const bool ok = g < nq && c0 + col < d;
        const float* src = q + (ok ? (long)st.qidx[g] * d + c0 + col : 0);
        float* to = qs + g * kQS + col;
        if (qvec == 16) rtt::cp_async16(to, src, ok);
        else rtt::cp_async4(to, src, ok);
      }
    }
  }
  rtt::cp_commit();
}

// One stage's products: acc[i][j][:] += the 32-deep slice's split products
// (a fresh accumulator, added in f32); nsq[j] += the squares of this
// thread's B-fragment row 16w + 8j + g over its columns t, t + 4. kQRes:
// the A fragments are the resident tile's pairs at columns c0 + ...
template <typename T, bool kQRes>
__device__ __forceinline__ void stage_mma(const char* stage,
                                          const float2* __restrict__ qres, int QS2,
                                          int c0, float (&acc)[kMT][kNT][4],
                                          float (&nsq)[kNT]) {
  constexpr int XS = ListSlice<T>::kStride;
  constexpr bool kExact = sizeof(T) <= 2;  // bf16, int8, uint8: exact in TF32
  const T* xs = reinterpret_cast<const T*>(stage);
  const float* qs = reinterpret_cast<const float*>(stage + list_slice_bytes<T>());
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float part[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if constexpr (kQRes) {
        const float2* qa = qres + (16 * i + g) * QS2 + c0 + kk + t;
        const float2 v[4] = {qa[0], qa[8 * QS2], qa[4], qa[8 * QS2 + 4]};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ah[i][c] = __float_as_uint(v[c].x);
          al[i][c] = __float_as_uint(v[c].y);
        }
      } else {
        const float* qa = qs + (16 * i + g) * kQS + kk + t;
        const float v[4] = {qa[0], qa[8 * kQS], qa[4], qa[8 * kQS + 4]};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ah[i][c] = rtt::tf32(v[c]);
          al[i][c] = rtt::tf32(v[c] - __uint_as_float(ah[i][c]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const T* xr = xs + (8 * j + g) * XS + kk + t;
      const float x0 = to_f32(xr[0]), x1 = to_f32(xr[4]);
      nsq[j] = fmaf(x0, x0, nsq[j]);
      nsq[j] = fmaf(x1, x1, nsq[j]);
      if constexpr (kExact) {
        const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          rtt::mma_tf32(part[i][j], al[i], b0, b1);
          rtt::mma_tf32(part[i][j], ah[i], b0, b1);
        }
      } else {
        const uint32_t h0 = rtt::tf32(x0), h1 = rtt::tf32(x1);
        const uint32_t l0 = rtt::tf32(x0 - __uint_as_float(h0));
        const uint32_t l1 = rtt::tf32(x1 - __uint_as_float(h1));
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          rtt::mma_tf32(part[i][j], al[i], h0, h1);
          rtt::mma_tf32(part[i][j], ah[i], l0, l1);
          rtt::mma_tf32(part[i][j], ah[i], h0, h1);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
}

// Walk the first n_rows rows of `list` ([L, d], ids `lid`) in 128-row
// tiles and call epi(t0, acc, xn, id) at the end of each tile, where for
// this thread's fragments
//   acc[i][j][c] = <q_(16i + g + 8(c / 2)), x_(t0 + 16w + 8j + 2t + c % 2)>
//   xn[j][e] = |x_(t0 + 16w + 8j + 2t + e)|^2,   id[j][e] = its id (-1 past
//   n_rows).
// Queries >= nq read zeros. kQRes: the queries come from the resident tile
// qres (split_queries, before the call). kS: stages of each warp's ring.
// Every thread calls it; the walk holds no block barrier after its first,
// but each tile's epi is reached by every warp, so epi may hold barriers.
template <typename T, bool kQRes, int kS, typename Epi>
__device__ __forceinline__ void scan_tiles(char* ring, const float2* __restrict__ qres,
                                           const T* __restrict__ list,
                                           const int* __restrict__ lid, int n_rows,
                                           int d, const float* __restrict__ q,
                                           const Stage& st, int nq, int xvec,
                                           int qvec, Epi&& epi) {
  static_assert(kS >= 2, "a ring of two stages at least");
  constexpr size_t SB = stage_bytes<T, kQRes>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int nck = (d + kBK - 1) / kBK, QS2 = kpad(d) + 4;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int lx = xvec > 0 ? 5 - (31 - __clz(xvec / (int)sizeof(T))) : 0;
  char* wring = ring + (size_t)warp * kS * SB;
  // the next stage to copy (tile, k slice); stages cycle through the slots
  int i_tile = 0, i_ck = 0;
  auto issue = [&](int slot) {
    issue_stage<T, kQRes>(wring + slot * SB, i_tile < n_tiles,
                          (long)i_tile * kRows + kWRows * warp, i_ck * kBK, list,
                          n_rows, d, q, st, nq, xvec, lx, qvec);
    if (++i_ck == nck) {
      i_ck = 0;
      ++i_tile;
    }
  };
  __syncthreads();  // the resident queries are split
#pragma unroll
  for (int p = 0; p < kS - 1; ++p) issue(p);
  float acc[kMT][kNT][4], nsq[kNT];
  int id[kNT][2];
  int slot = 0, ck = 0;
  for (int t0 = 0; t0 < n_tiles * kRows;) {
    if (ck == 0) {  // the tile's ids, read while its slices arrive
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        nsq[j] = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = t0 + 16 * warp + 8 * j + 2 * t + e;
          id[j][e] = pos < n_rows ? lid[pos] : -1;
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
      }
    }
    rtt::cp_wait<kS - 2>();
    __syncwarp();  // this stage landed for the warp; the previous one is free
    issue(slot == 0 ? kS - 1 : slot - 1);
    stage_mma<T, kQRes>(wring + slot * SB, qres, QS2, ck * kBK, acc, nsq);
    slot = slot == kS - 1 ? 0 : slot + 1;
    if (++ck == nck) {
      ck = 0;
      // |x|^2 of the B-fragment rows summed over the quad, then moved to
      // the lanes whose accumulator columns hold those rows
      float xn[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float v = nsq[j];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        xn[j][0] = __shfl_sync(kFull, v, (2 * t) << 2);
        xn[j][1] = __shfl_sync(kFull, v, (2 * t + 1) << 2);
      }
      epi(t0, acc, xn, id);
      t0 += kRows;
    }
  }
  rtt::cp_wait<0>();
}

// Minimized key: 0 l2 max(|q|^2 + |x|^2 - 2<q,x>, 0), 1 ip -<q,x>,
// 2 cos 1 - <q,x> rsqrt(max(|q|^2, 1e-30)) rsqrt(max(|x|^2, 1e-30)).
__device__ __forceinline__ float scan_key(int metric, float dot, float qsq,
                                          float nsq) {
  if (metric == 1) return -dot;
  if (metric == 2)
    return 1.f - dot * rsqrtf(fmaxf(qsq, 1e-30f)) * rsqrtf(fmaxf(nsq, 1e-30f));
  return fmaxf(qsq + nsq - 2.f * dot, 0.f);
}

// Bytes of a copy the rows allow: the largest of 16, 8, 4 that divides the
// row's bytes and the base address, else 0 (plain loads).
inline int copy_width(int row_bytes, const void* base) {
  for (int w = 16; w >= 4; w >>= 1)
    if (row_bytes % w == 0 && ((uintptr_t)base % w) == 0) return w;
  return 0;
}

}  // namespace rtt_scan
