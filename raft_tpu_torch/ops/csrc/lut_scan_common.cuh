// Device code of the IVF-PQ LUT scan over packed pq_bits (4..8) codes:
// the segment scan of ivfpq_lut_scan.cu (one block per segment and group
// of live queries), whose look-ups (adc_row, adc_words_rot) and layouts
// ring_lut_scan.cu shares.
//
// For a live slot with query q (rotated) of a segment owning list l:
//   LUT[s, c] = <q_s, cb[s, c]>                        (f32, shared memory)
//   dot      = <q, centers_rot[l]> + sum_s LUT[s, code_s(p)]
//   key      = norms[l, p] - 2 * dot   (l2)  |  -dot   (ip)
// invalid ids (< 0), positions >= the list's size and, with a filter, rows
// whose keep bit is clear give (+inf, -1). Bin
// b = p mod 128 keeps the two smallest (key, position) pairs in
// lexicographic order -- what a walk of the bin in position order with a
// strict < keeps, i.e. the TPU kernel's bin contents. Output per live
// slot: 256 columns, 0..127 the best per bin, 128..255 the second best,
// in the row the caller names for the slot. Pad slots are not written.
//
// Design: a block of 128 * R threads (R row groups, 1..4) walks the list
// in tiles of 128 * R rows up to the list's size (rows past it are pads:
// pack_lists fills lists from the front); thread t owns bin t mod 128 of
// row group t / 128 and takes row t of each tile, so every thread scans
// every R-th row of its bin in position order and keeps a partial
// two-best; the R partials of a bin are merged lexicographically on (key,
// position) at the end of a pass. Code tiles are staged in shared memory
// (rows padded to an odd word count, so per-thread row reads are bank-
// conflict free); when the packed row width is a multiple of 16 bytes the
// next tile is loaded into registers with 16-byte loads while the current
// one is scanned. Each tile is shared by up to QG live queries, whose f32
// LUTs (pq_dim * 2^bits * 4 bytes each, 64 KB at 64 x 256) fill the
// dynamic shared memory.
//
// The look-ups are the kernel's arithmetic floor. With 8-bit codes and
// pq_dim a multiple of 32 (<= 128) the LUT is [2^bits][pq_dim]-major and
// the lane with index l sums its row's subspaces in the order l, l + 1,
// ... (mod pq_dim): at every step the 32 lanes of a warp read 32
// consecutive subspaces, i.e. 32 distinct banks, whatever their codes.
// (A [pq_dim][2^bits] LUT read at one subspace by 32 random codes puts
// several lanes on one bank.) The caller then passes the codebook [2^bits,
// pq_dim, pq_len]-major, so the LUT build writes consecutive words too.
// On that path each thread loads its own rows' codes (16-byte aligned)
// into registers one row ahead and rotates them there, and the warps walk
// the list without a barrier between tiles.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rtt {

constexpr int kLutBins = 128;
constexpr int kLutMaxR = 4;
constexpr int kLutMaxQG = 4;
constexpr int kLutMaxChunks = 8;  // 16-byte chunks per row on the prefetch path
constexpr int kLutNoPos = 0x7fffffff;

struct Best2 {
  float k1, k2;
  int i1, i2, p1, p2;
};

__device__ __forceinline__ void best2_init(Best2& b) {
  b.k1 = b.k2 = CUDART_INF_F;
  b.i1 = b.i2 = -1;
  b.p1 = b.p2 = kLutNoPos;
}

// The keep bit of row p of a list whose keep bytes start at `frow` (null:
// no filter): bit p mod 8 of byte p / 8, as sample_filter.list_filter_bytes
// packs it. A row that is not kept is skipped as a pad is (id -1), which
// gives the bins the (+inf, -1) sentinel the TPU kernel's _lut_tile_update
// put on a filtered row.
__device__ __forceinline__ bool row_kept(const uint8_t* __restrict__ frow,
                                         int p) {
  return frow == nullptr || ((frow[p >> 3] >> (p & 7)) & 1);
}

// Insert (k, i, p) in lexicographic (key, position) order.
__device__ __forceinline__ void best2_insert(Best2& b, float k, int i, int p) {
  if (k < b.k1 || (k == b.k1 && p < b.p1)) {
    b.k2 = b.k1; b.i2 = b.i1; b.p2 = b.p1;
    b.k1 = k; b.i1 = i; b.p1 = p;
  } else if (k < b.k2 || (k == b.k2 && p < b.p2)) {
    b.k2 = k; b.i2 = i; b.p2 = p;
  }
}

__device__ __forceinline__ int code_at(const uint8_t* crow, int si, int pq_bits,
                                       int nb) {
  const int bit = si * pq_bits;
  const int bi = bit >> 3;
  int v = crow[bi];
  if (bi + 1 < nb) v |= ((int)crow[bi + 1]) << 8;
  return (v >> (bit & 7)) & ((1 << pq_bits) - 1);
}

// sum_s LUT_g[s, code_s] of one code row for the ng queries of the pass.
template <bool kBytes8>
__device__ __forceinline__ void adc_row(const uint8_t* crow, const float* lut,
                                        int S, int K, int SK, int pq_bits, int nb,
                                        int ng, float* acc) {
  if (kBytes8) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(crow);
    for (int s0 = 0; s0 < S; s0 += 4) {
      const uint32_t word = w[s0 >> 2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* lrow = lut + (s0 + j) * K + ((word >> (8 * j)) & 0xff);
#pragma unroll
        for (int g = 0; g < kLutMaxQG; ++g)
          if (g < ng) acc[g] += lrow[g * SK];
      }
    }
  } else {
    for (int si = 0; si < S; ++si) {
      const float* lrow = lut + si * K + code_at(crow, si, pq_bits, nb);
#pragma unroll
      for (int g = 0; g < kLutMaxQG; ++g)
        if (g < ng) acc[g] += lrow[g * SK];
    }
  }
}

// a[k] <- a[(k + kS) mod kW] where `on` (a select per word: the rotation
// amount differs between lanes, so it cannot index the registers)
template <int kW, int kS>
__device__ __forceinline__ void rot_words(uint32_t (&a)[kW], bool on) {
  uint32_t b[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) b[k] = on ? a[(k + kS) % kW] : a[k];
#pragma unroll
  for (int k = 0; k < kW; ++k) a[k] = b[k];
}

// The rotated look-up (8-bit codes, pq_dim = 4 * kW a multiple of 32) of
// one row's code words `a`: LUT_g[c * S + s]; the lane with index l
// rotates its words by l bytes (l / 4 words by selects, l mod 4 bytes by
// funnel shifts), so byte j of word k is subspace (4k + j + l) mod S.
template <int kW>
__device__ __forceinline__ void adc_words_rot(uint32_t (&a)[kW],
                                              const float* lut, int SK, int ng,
                                              float* acc) {
  constexpr int S = 4 * kW;
  const int l = threadIdx.x & 31;
  const int q = l >> 2, sh = 8 * (l & 3);
  rot_words<kW, 1>(a, q & 1);
  rot_words<kW, 2>(a, q & 2);
  rot_words<kW, 4>(a, q & 4);
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const uint32_t word = __funnelshift_r(a[k], a[k + 1 < kW ? k + 1 : 0], sh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int s = 4 * k + j + l;
      s = s < S ? s : s - S;
      const float* e = lut + ((word >> (8 * j)) & 0xff) * S + s;
#pragma unroll
      for (int g = 0; g < kLutMaxQG; ++g)
        if (g < ng) acc[g] += e[g * SK];
    }
  }
}

// One segment: list `lst` of `size` real rows, slot table `sq` [seg]
// (query row per slot, -1 pad), queries `q_rot` [*, rot], the list's keep
// bytes `frow` (null: no filter). Scans live slots
// [g_first, g_first + g_count) of the segment (in slot order), qg at a
// time, and writes the 256 bin columns of live slot j to row
// out_row[j] of out_* (or row s_out * seg + j where out_row is null).
// kW > 0: the rotated look-up of 8-bit codes, pq_dim 4 * kW, with the LUT
// and the codebook [K][S]-major. Called by every thread of a block of
// 128 * R threads with `smem` the block's dynamic shared memory
// (lut_smem_bytes below).
template <bool kBytes8, int kW>
__device__ __forceinline__ void lut_scan_segment(
    float* smem, long s_out, long lst, int size, const int* __restrict__ sq,
    const int* __restrict__ out_row, int g_first, int g_count,
    const uint8_t* __restrict__ frow,
    const float* __restrict__ q_rot, const uint8_t* __restrict__ codes,
    const int* __restrict__ ids, const float* __restrict__ norms,
    const float* __restrict__ centers_rot, const float* __restrict__ cb,
    float* __restrict__ out_keys, int* __restrict__ out_ids, int seg, int rot,
    int S, int K, int P, int pq_bits, int nb, int L, int metric, int qg,
    int stride, int n_chunks) {
  const int SK = S * K;
  const int nthr = blockDim.x;  // 128 * R: also the rows of a tile
  float* lut = smem;                       // [qg][S*K]
  float* qv = lut + qg * SK;               // [qg][rot]
  float* qc = qv + qg * rot;               // [qg]
  int* live = (int*)(qc + qg);             // [seg]
  int* wcnt = live + seg;                  // [32]
  uint8_t* tile = (uint8_t*)(wcnt + 32);   // [nthr][stride]; merge scratch too
  Best2* part = reinterpret_cast<Best2*>(tile);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nthr >> 5;

  // live slots of the segment, in slot order (warp ballots)
  int n_live = 0;
  for (int base = 0; base < seg; base += nthr) {
    const int j = base + tid;
    const bool is_live = j < seg && sq[j] >= 0;
    const unsigned bal = __ballot_sync(0xffffffffu, is_live);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = n_live, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (w < warp) off += wcnt[w];
      total += wcnt[w];
    }
    if (is_live) live[off + __popc(bal & ((1u << lane) - 1u))] = j;
    __syncthreads();
    n_live += total;
  }
  const int g_end = min(n_live, g_first + g_count);

  const long list_row0 = lst * L;
  const bool prefetch = n_chunks > 0;  // 16-byte chunks per row, or 0
  const int n_tiles = (size + nthr - 1) / nthr;

  // the rotated path's row fetch: each thread loads its own rows' codes
  // straight into registers (16 bytes at a time, one row ahead)
  constexpr int C = kW > 0 ? kW / 4 : 1;  // 16-byte chunks of a row
  const uint4* rows = reinterpret_cast<const uint4*>(codes) + list_row0 * C;
  uint4 nx[C];
  int nx_id = -1;
  float nx_nrm = 0.f;
  auto fetch = [&](int t) {
    const int p = t * nthr + tid;
    nx_id = -1;
    if (p < size && row_kept(frow, p)) {  // a row not kept loads nothing
      nx_id = ids[list_row0 + p];
      nx_nrm = norms[list_row0 + p];
#pragma unroll
      for (int c = 0; c < C; ++c) nx[c] = rows[(long)p * C + c];
    }
  };

  for (int g0 = g_first; g0 < g_end; g0 += qg) {
    const int ng = min(qg, g_end - g0);
    // the first rows load under the LUT build
    if (kW > 0 && n_tiles > 0) fetch(0);
    for (int e = tid; e < ng * rot; e += nthr) {
      const int g = e / rot, j = e % rot;
      qv[e] = q_rot[(long)sq[live[g0 + g]] * rot + j];
    }
    __syncthreads();
    if (warp < ng) {  // <q, center>: a warp per query
      float a = 0.f;
      for (int j = lane; j < rot; j += 32)
        a = fmaf(qv[warp * rot + j], centers_rot[lst * rot + j], a);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) qc[warp] = a;
    }
    // LUT entries: each codebook row is read once for the pass's queries;
    // entry r is (subspace r / K, code r % K), or (r % S, r / S) rotated.
    // pq_len 2 (the paths' shapes) loads 16 entries a thread ahead of use.
    if (P == 2) {
      const float2* cb2 = reinterpret_cast<const float2*>(cb);
      for (int r0 = tid; r0 < SK; r0 += 16 * nthr) {
        float2 c[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int r = r0 + u * nthr;
          c[u] = r < SK ? cb2[r] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int r = r0 + u * nthr;
          if (r < SK) {
            const float* qs = qv + (kW ? r % (4 * kW) : r / K) * 2;
#pragma unroll
            for (int g = 0; g < kLutMaxQG; ++g)
              if (g < ng)
                lut[g * SK + r] = fmaf(qs[g * rot + 1], c[u].y, qs[g * rot] * c[u].x);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int r = tid; r < SK; r += nthr) {
        const float* qs = qv + (kW ? r % (4 * kW) : r / K) * P;
        const float* c = cb + (long)r * P;
        float a[kLutMaxQG];
#pragma unroll
        for (int g = 0; g < kLutMaxQG; ++g) a[g] = 0.f;
        for (int p = 0; p < P; ++p) {
          const float cp = c[p];
#pragma unroll
          for (int g = 0; g < kLutMaxQG; ++g)
            if (g < ng) a[g] = fmaf(qs[g * rot + p], cp, a[g]);
        }
#pragma unroll
        for (int g = 0; g < kLutMaxQG; ++g)
          if (g < ng) lut[g * SK + r] = a[g];
      }
    }

    Best2 best[kLutMaxQG];
#pragma unroll
    for (int g = 0; g < kLutMaxQG; ++g) best2_init(best[g]);
    // a real row's keys into the running two-bests: positions rise within
    // a thread, so a strict < keeps the earlier position on ties
    auto offer = [&](int id, float nrm, int pos, const float* acc) {
#pragma unroll
      for (int g = 0; g < kLutMaxQG; ++g) {
        if (g < ng) {
          const float dot = qc[g] + acc[g];
          const float key = metric == 1 ? -dot : nrm - 2.f * dot;
          Best2& b = best[g];
          if (key < b.k1) {
            b.k2 = b.k1; b.i2 = b.i1; b.p2 = b.p1;
            b.k1 = key; b.i1 = id; b.p1 = pos;
          } else if (key < b.k2) {
            b.k2 = key; b.i2 = id; b.p2 = pos;
          }
        }
      }
    };

    if constexpr (kW > 0) {
      // rotated look-up: rows from registers, so the warps walk the list
      // without a barrier between tiles
      __syncthreads();  // the LUTs and <q, center> are built
      for (int t = 0; t < n_tiles; ++t) {
        uint32_t w[kW];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          w[4 * c] = nx[c].x;
          w[4 * c + 1] = nx[c].y;
          w[4 * c + 2] = nx[c].z;
          w[4 * c + 3] = nx[c].w;
        }
        const int id = nx_id;
        const float nrm = nx_nrm;
        if (t + 1 < n_tiles) fetch(t + 1);
        if (id >= 0) {
          float acc[kLutMaxQG];
#pragma unroll
          for (int g = 0; g < kLutMaxQG; ++g) acc[g] = 0.f;
          adc_words_rot<kW>(w, lut, SK, ng, acc);
          offer(id, nrm, t * nthr + tid, acc);
        }
      }
    } else {
      uint4 pre[kLutMaxChunks];
      auto load_tile = [&](int t) {  // next tile's code chunks -> registers
        const long row0 = list_row0 + (long)t * nthr;
        const int rows = min(nthr, size - t * nthr);
#pragma unroll
        for (int c = 0; c < kLutMaxChunks; ++c) {
          if (c < n_chunks) {
            const int e = tid + c * nthr;
            const int r = e / n_chunks;
            pre[c] = make_uint4(0u, 0u, 0u, 0u);
            if (r < rows)
              pre[c] = reinterpret_cast<const uint4*>(codes + (row0 + r) * nb)[e % n_chunks];
          }
        }
      };
      // the id and norm of this thread's row of the next tile (-1: a pad)
      int nxt_id = -1;
      float nxt_nrm = 0.f;
      auto load_meta = [&](int t) {
        const int p = t * nthr + tid;
        nxt_id = p < size && row_kept(frow, p) ? ids[list_row0 + p] : -1;
        nxt_nrm = p < size ? norms[list_row0 + p] : 0.f;
      };
      load_meta(0);
      if (prefetch) load_tile(0);

      for (int t = 0; t < n_tiles; ++t) {
        const int t0 = t * nthr;
        const long row0 = list_row0 + t0;
        __syncthreads();  // the previous tile (or the LUT build) is done
        if (prefetch) {
#pragma unroll
          for (int c = 0; c < kLutMaxChunks; ++c) {
            if (c < n_chunks) {
              const int e = tid + c * nthr;
              uint32_t* dst = reinterpret_cast<uint32_t*>(
                  tile + (e / n_chunks) * stride + 16 * (e % n_chunks));
              dst[0] = pre[c].x;
              dst[1] = pre[c].y;
              dst[2] = pre[c].z;
              dst[3] = pre[c].w;
            }
          }
        } else if ((nb & 3) == 0) {
          const int wpr = nb >> 2;
          for (int e = tid; e < nthr * wpr; e += nthr) {
            const int r = e / wpr, w = e % wpr;
            uint32_t v = 0;
            if (t0 + r < size) v = reinterpret_cast<const uint32_t*>(codes + (row0 + r) * nb)[w];
            *reinterpret_cast<uint32_t*>(tile + r * stride + 4 * w) = v;
          }
        } else {
          for (int e = tid; e < nthr * nb; e += nthr) {
            const int r = e / nb, b = e % nb;
            tile[r * stride + b] = (t0 + r < size) ? codes[(row0 + r) * nb + b] : 0;
          }
        }
        __syncthreads();
        const int id = nxt_id;
        const float nrm = nxt_nrm;
        if (t + 1 < n_tiles) {
          load_meta(t + 1);
          if (prefetch) load_tile(t + 1);
        }
        if (id >= 0) {
          float acc[kLutMaxQG];
#pragma unroll
          for (int g = 0; g < kLutMaxQG; ++g) acc[g] = 0.f;
          adc_row<kBytes8>(tile + tid * stride, lut, S, K, SK, pq_bits, nb, ng, acc);
          offer(id, nrm, t0 + tid, acc);
        }
      }
    }

    // merge the row groups' partial two-bests of each bin, query by query
#pragma unroll
    for (int g = 0; g < kLutMaxQG; ++g) {
      if (g < ng) {
        __syncthreads();  // the tile / previous query's scratch is free
        part[tid] = best[g];
        __syncthreads();
        if (tid < kLutBins) {
          Best2 m = part[tid];
          for (int r = kLutBins + tid; r < nthr; r += kLutBins) {
            const Best2 o = part[r];
            best2_insert(m, o.k1, o.i1, o.p1);
            best2_insert(m, o.k2, o.i2, o.p2);
          }
          const int j = live[g0 + g];
          const long o = (out_row ? (long)out_row[j] : s_out * seg + j) * (2 * kLutBins);
          out_keys[o + tid] = m.k1;
          out_keys[o + kLutBins + tid] = m.k2;
          out_ids[o + tid] = m.i1;
          out_ids[o + kLutBins + tid] = m.i2;
        }
      }
    }
    __syncthreads();
  }
}

inline int lut_row_stride(int nb) {  // bytes: an odd number of 4-byte words
  const int words = (nb + 3) / 4;
  return 4 * ((words & 1) ? words : words + 1);
}

inline size_t lut_smem_bytes(int qg, int R, int S, int K, int rot, int seg,
                             int nb) {
  const size_t nthr = (size_t)kLutBins * R;
  size_t b = (size_t)qg * S * K * 4 + (size_t)qg * rot * 4 + (size_t)qg * 4 +
             (size_t)seg * 4 + 32 * 4;
  b = (b + 15) & ~(size_t)15;
  const size_t tile = nthr * lut_row_stride(nb);
  const size_t merge = nthr * sizeof(Best2);
  return b + (tile > merge ? tile : merge);
}

// 16-byte chunks per code row on the register-prefetch path, or 0 where it
// does not apply (rows not a multiple of 16 bytes, too wide, or unaligned).
inline int lut_prefetch_chunks(int nb, const void* codes) {
  return ((nb & 15) == 0 && (nb >> 4) <= kLutMaxChunks &&
          ((uintptr_t)codes & 15) == 0) ? nb >> 4 : 0;
}

}  // namespace rtt
