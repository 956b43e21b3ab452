// select_k: row-wise top-k (k <= 64), sorted, ties to the lowest position.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:select_k_pallas
// (l.1317, body _select_k_kernel l.155), which merged a running [bm, 128]
// buffer with each score tile by k rounds of min + mask extraction.
//
// Bound on the H100: bytes. Each score is read once (m * len * 4 bytes)
// against a few comparisons per element: 16.4 MB (~4.9 us at 3.35 TB/s)
// at the IVF-PQ path's [500, 8192], k 64; 328 MB (~98 us) at the IVF-Flat
// path's [320,000, 256] bin rows, k 10.
//
// Order: every score maps to an unsigned key whose order is the stable
// sort's (order_key of topk_common.cuh, complemented for max-select), and
// the pair (key, position) is unique, so the k smallest pairs are the
// stable sort's first k, ties included. Values are read back from the row
// at the winning positions, bit for bit.
//
// Design: two variants, chosen by the wrapper from len alone
// (ops/kernels.py:select_k_plan, which also sizes the shared memory).
//
// - Short rows (len <= 1024: the bin rows, the ring's [mc, 2k] cut, the
//   coarse probes of IVF-Flat, predict_topk's Gram tiles): one warp per
//   row, eight rows a block. The row goes into registers with coalesced
//   16-byte loads where it is aligned (at most 32 keys a lane); then k
//   rounds, each a min over the lane's keys and two warp-wide unsigned
//   min reductions (__reduce_min_sync: the key, then the position among
//   the lanes holding it); the winning lane drops its key. No shared
//   memory and no serial insert chain: a round costs the same for every k.
// - Long rows (len > 1024: the IVF-PQ coarse probes, brute-force tiles):
//   one block of 256 threads per row. The keys are staged once in shared
//   memory where they fit (len <= 10240), else re-read from the row. Radix
//   select: 8-bit histogram passes in shared memory (a warp whose lanes
//   share one bin adds once) narrow the k-th key down to its bin; the
//   descent stops at the first bin whose entries are all needed. Then
//   every entry of a lower bin, and the first (k - count below) entries of
//   that bin in position order (per-warp counts over contiguous spans, a
//   prefix over the warps), land in a k-slot shared table; one warp sorts
//   those k by (key, position) with the short variant's rounds.
//
// Bias row: with `bias` (a row of len floats, or null) the kernel ranks
// bias[j] - 2 * scores[i, j], formed as it loads a score, and returns
// those values: the IVF-PQ coarse probe's ||c||^2 - 2<q, c> without a
// separate elementwise launch before the select. 2 * score is exact, so
// the value equals torch.sub(bias, scores, alpha=2) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using rtt::kFullMask;
using rtt::kMaxK;
constexpr uint32_t kGone = 0xffffffffu;  // a taken or absent entry
constexpr int kShortWarps = 8;
constexpr int kLongWarps = 8;
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kMaxStagedBytes = 40960;  // kernels.py: SELECT_K_STAGE_MAX * 4

__device__ __forceinline__ uint32_t select_key(float v, bool select_min) {
  const uint32_t o = rtt::order_key(v);
  return select_min ? o : ~o;
}

// The value the select ranks at position p of a row.
__device__ __forceinline__ float score_at(const float* src,
                                          const float* bias, int p) {
  const float v = __ldg(src + p);
  return bias != nullptr ? __ldg(bias + p) - 2.f * v : v;
}

// Position of a lane's i-th register in a row read as 16-byte vectors
// (kVec 4) or as single floats (kVec 1); it grows with i, so a lane's
// first minimum is its lowest position.
template <int kVec>
__device__ __forceinline__ uint32_t lane_pos(int lane, int i) {
  return kVec == 4 ? 4u * (lane + 32u * (i >> 2)) + (i & 3)
                   : lane + 32u * i;
}

// Ranks lane and lane + 32 of a row's result: positions and the row's
// values at them.
__device__ __forceinline__ void store_row(const float* src,
                                          const float* bias, uint32_t res0,
                                          uint32_t res1, int k, float* ov,
                                          int* oi, int lane) {
  if (lane < k) {
    oi[lane] = (int)res0;
    ov[lane] = score_at(src, bias, (int)res0);
  }
  if (lane + 32 < k) {
    oi[lane + 32] = (int)res1;
    ov[lane + 32] = score_at(src, bias, (int)res1);
  }
}

// One warp per row; kPer keys a lane (a multiple of kVec).
template <int kVec, int kPer>
__global__ void __launch_bounds__(kShortWarps * 32)
select_k_short(const float* __restrict__ scores,
               const float* __restrict__ bias, int m, int len, int k,
               bool select_min, float* __restrict__ out_v,
               int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kShortWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps leave together
  const float* src = scores + row * len;
  uint32_t key[kPer];
  if (kVec == 4) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int n4 = len >> 2;
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      const int v = lane + 32 * j;
      const bool in = v < n4;
      float4 f = in ? __ldg(src4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (bias != nullptr && in) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + v);
        f = make_float4(b.x - 2.f * f.x, b.y - 2.f * f.y, b.z - 2.f * f.z,
                        b.w - 2.f * f.w);
      }
      key[4 * j + 0] = in ? select_key(f.x, select_min) : kGone;
      key[4 * j + 1] = in ? select_key(f.y, select_min) : kGone;
      key[4 * j + 2] = in ? select_key(f.z, select_min) : kGone;
      key[4 * j + 3] = in ? select_key(f.w, select_min) : kGone;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = lane + 32 * i;
      key[i] = p < len ? select_key(score_at(src, bias, p), select_min)
                       : kGone;
    }
  }
  uint32_t res0 = 0u, res1 = 0u;  // positions of ranks lane and lane + 32
  for (int t = 0; t < k; ++t) {
    uint32_t bk = key[0];
    int bi = 0;
#pragma unroll
    for (int i = 1; i < kPer; ++i) {
      if (key[i] < bk) {
        bk = key[i];
        bi = i;
      }
    }
    const uint32_t wk = __reduce_min_sync(kFullMask, bk);
    const uint32_t mine = bk == wk ? lane_pos<kVec>(lane, bi) : kGone;
    const uint32_t wp = __reduce_min_sync(kFullMask, mine);
    if (mine == wp) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) key[i] = i == bi ? kGone : key[i];
    }
    if (t == lane) res0 = wp;
    if (t == lane + 32) res1 = wp;
  }
  store_row(src, bias, res0, res1, k, out_v + row * k, out_i + row * k,
            lane);
}

// One block per row. kStaged: the row's keys sit in dynamic shared memory.
template <bool kStaged>
__global__ void __launch_bounds__(kLongWarps * 32)
select_k_long(const float* __restrict__ scores,
              const float* __restrict__ bias, int len, int k, bool select_min, float* __restrict__ out_v,
              int* __restrict__ out_i) {
  extern __shared__ uint32_t staged[];
  __shared__ uint32_t hist[kBins];
  __shared__ int warp_eq[kLongWarps];
  __shared__ uint32_t surv_key[kMaxK];
  __shared__ uint32_t surv_pos[kMaxK];
  __shared__ int s_bin, s_before, s_count, s_nless;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row = blockIdx.x;
  const float* src = scores + row * len;
  auto key_at = [&](int p) -> uint32_t {
    return kStaged ? staged[p]
                   : select_key(score_at(src, bias, p), select_min);
  };
  if (kStaged) {
    for (int p = tid; p < len; p += blockDim.x)
      staged[p] = select_key(score_at(src, bias, p), select_min);
  }

  // Radix descent: after each pass `prefix` holds the k-th key's top bits
  // (down to `shift`), `need` the rank of the k-th key among the entries
  // sharing them.
  uint32_t prefix = 0;
  int shift = 32;
  int need = k;
  while (true) {
    shift -= kRadixBits;
    for (int b = tid; b < kBins; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    const int above = shift + kRadixBits;
    for (int base = 0; base < len; base += blockDim.x) {
      const int p = base + tid;
      const uint32_t key = p < len ? key_at(p) : 0u;
      const bool part = p < len && (above == 32 || (key >> above) == prefix);
      const uint32_t bin = (key >> shift) & (kBins - 1);
      const unsigned act = __ballot_sync(kFullMask, part);
      if (act == 0) continue;
      const int lead = __ffs(act) - 1;
      const uint32_t b0 = __shfl_sync(kFullMask, bin, lead);
      if (__all_sync(kFullMask, !part || bin == b0)) {
        if (lane == lead) atomicAdd(&hist[b0], (uint32_t)__popc(act));
      } else if (part) {
        atomicAdd(&hist[bin], 1u);
      }
    }
    __syncthreads();
    if (warp == 0) {
      constexpr int kPerLane = kBins / 32;
      uint32_t c[kPerLane];
      uint32_t sum = 0;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        c[j] = hist[kPerLane * lane + j];
        sum += c[j];
      }
      uint32_t inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(kFullMask, inc, o);
        if (lane >= o) inc += t;
      }
      uint32_t acc = inc - sum;
      if (acc < (uint32_t)need && (uint32_t)need <= inc) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          if (acc < (uint32_t)need && (uint32_t)need <= acc + c[j]) {
            s_bin = kPerLane * lane + j;
            s_before = (int)acc;
            s_count = (int)c[j];
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    prefix = (prefix << kRadixBits) | (uint32_t)s_bin;
    need -= s_before;
    if (shift == 0 || s_count == need) break;
  }

  // Survivors: entries whose top bits fall below `prefix` (k - need of
  // them, in any order) and the first `need` entries equal to it, in
  // position order. Each warp walks one contiguous span of the row.
  const int span = ((len + kLongWarps - 1) / kLongWarps + 31) & ~31;
  const int lo = min(len, warp * span);
  const int hi = min(len, lo + span);
  int eq_count = 0;
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const bool eq = p < hi && (key_at(p) >> shift) == prefix;
    eq_count += __popc(__ballot_sync(kFullMask, eq));
  }
  if (lane == 0) warp_eq[warp] = eq_count;
  if (tid == 0) s_nless = 0;
  __syncthreads();
  int eq_rank = 0;
  for (int w = 0; w < warp; ++w) eq_rank += warp_eq[w];
  const int n_less = k - need;
  const unsigned below = (1u << lane) - 1u;
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const bool in = p < hi;
    const uint32_t key = in ? key_at(p) : kGone;
    const uint32_t top = key >> shift;
    const bool less = in && top < prefix;
    const bool eq = in && top == prefix;
    const unsigned lb = __ballot_sync(kFullMask, less);
    if (lb) {
      int slot0 = 0;
      if (lane == 0) slot0 = atomicAdd(&s_nless, __popc(lb));
      slot0 = __shfl_sync(kFullMask, slot0, 0);
      if (less) {
        const int slot = slot0 + __popc(lb & below);
        surv_key[slot] = key;
        surv_pos[slot] = (uint32_t)p;
      }
    }
    const unsigned eb = __ballot_sync(kFullMask, eq);
    if (eq) {
      const int r = eq_rank + __popc(eb & below);
      if (r < need) {
        surv_key[n_less + r] = key;
        surv_pos[n_less + r] = (uint32_t)p;
      }
    }
    eq_rank += __popc(eb);
  }
  __syncthreads();

  // Sort the k survivors by (key, position): k rounds in warp 0.
  if (warp != 0) return;
  uint32_t sk[2], sp[2], res0 = 0u, res1 = 0u;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    sk[s] = j < k ? surv_key[j] : kGone;
    sp[s] = j < k ? surv_pos[j] : kGone;
  }
  for (int t = 0; t < k; ++t) {
    const bool second = sk[1] < sk[0] || (sk[1] == sk[0] && sp[1] < sp[0]);
    const uint32_t bk = second ? sk[1] : sk[0];
    const uint32_t bp = second ? sp[1] : sp[0];
    const uint32_t wk = __reduce_min_sync(kFullMask, bk);
    const uint32_t wp = __reduce_min_sync(kFullMask, bk == wk ? bp : kGone);
    if (bk == wk && bp == wp) {
      sk[0] = second ? sk[0] : kGone;
      sp[0] = second ? sp[0] : kGone;
      sk[1] = second ? kGone : sk[1];
      sp[1] = second ? kGone : sp[1];
    }
    if (t == lane) res0 = wp;
    if (t == lane + 32) res1 = wp;
  }
  store_row(src, bias, res0, res1, k, out_v + row * k, out_i + row * k,
            lane);
}

struct Launch {
  const float* scores;
  const float* bias;
  int m, len, k;
  bool select_min;
  float* out_v;
  int* out_i;
  cudaStream_t stream;
};

template <int kVec, int kPer>
int launch_short(const Launch& a) {
  const int blocks = (a.m + kShortWarps - 1) / kShortWarps;
  select_k_short<kVec, kPer><<<blocks, kShortWarps * 32, 0, a.stream>>>(
      a.scores, a.bias, a.m, a.len, a.k, a.select_min, a.out_v, a.out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// scores [m, len] f32 (with bias, a [len] f32 row or null: the select
// ranks bias[j] - 2 * scores[i, j]) -> out_v [m, k] f32, out_i [m, k] i32.
// The variant
// comes from ops/kernels.py:select_k_plan: per_lane > 0 is the short
// variant with `vec`-wide loads and per_lane keys a lane; per_lane == 0 the
// long one, its keys staged when smem_bytes == len * 4 (0: not staged).
extern "C" int rtt_select_k(const float* scores, const float* bias, int m,
                            int len, int k, int select_min, int vec, int per_lane,
                            int smem_bytes, float* out_v, int* out_i,
                            void* stream) {
  if (k < 1 || k > kMaxK || k > len) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  const Launch a{scores, bias, m, len, k, select_min != 0, out_v, out_i,
                 (cudaStream_t)stream};
  if (per_lane > 0) {
    if (len > 32 * per_lane) return (int)cudaErrorInvalidValue;
    if (vec == 4) {
      if (len % 4 != 0 || ((uintptr_t)scores & 15u) != 0 ||
          ((uintptr_t)bias & 15u) != 0)
        return (int)cudaErrorInvalidValue;
      switch (per_lane) {
        case 4: return launch_short<4, 4>(a);
        case 8: return launch_short<4, 8>(a);
        case 16: return launch_short<4, 16>(a);
        case 32: return launch_short<4, 32>(a);
      }
    } else if (vec == 1) {
      switch (per_lane) {
        case 1: return launch_short<1, 1>(a);
        case 2: return launch_short<1, 2>(a);
        case 4: return launch_short<1, 4>(a);
        case 8: return launch_short<1, 8>(a);
        case 16: return launch_short<1, 16>(a);
        case 32: return launch_short<1, 32>(a);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes < 0 || smem_bytes > kMaxStagedBytes ||
      (smem_bytes != 0 && (long)smem_bytes != (long)len * 4))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 0) {
    select_k_long<true><<<m, kLongWarps * 32, smem_bytes, a.stream>>>(
        scores, bias, len, k, a.select_min, out_v, out_i);
  } else {
    select_k_long<false><<<m, kLongWarps * 32, 0, a.stream>>>(
        scores, bias, len, k, a.select_min, out_v, out_i);
  }
  return (int)cudaGetLastError();
}
