// fused_l2_argmin: for each x row, min over y rows of max(|x|^2 + |y|^2 -
// 2<x, y>, 0) and its argmin (first index on ties). The [m, n] distance
// matrix is never stored.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:fused_l2_argmin
// (l.112, body _fused_l2_argmin_kernel l.62), whose sequential grid axis
// over y tiles carried the running (min, argmin) in the output block.
//
// Numerics: the TPU kernel computes <x, y> on its matrix unit at
// Precision.HIGHEST (pallas_kernels.py:86-91): fp32 emulated from several
// bf16 passes, because one bf16 pass loses ~1e-3 relative and flips
// argmins. The same move on Hopper is 3xTF32 on the tensor cores: each
// operand splits into a = a_hi + a_lo with both parts TF32 (10 explicit
// mantissa bits, round to nearest), and
//   a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi          (f32 accumulation)
// drops only a_lo.b_lo and the rounding of the lo parts, ~2^-22 |a||b| a
// product: about 21 mantissa bits, f32's accuracy within a few ulps. One
// TF32 product alone (~2^-11) would flip argmins, as one bf16 pass would.
//
// Bound on the H100: operations. 2 * m * n * d FLOPs (the row's bound, at
// the 67 TFLOP/s fp32 rate) run as 3 TF32 products: 3 * 2 * m * n * d at
// 495 TFLOP/s, e.g. 95 ms at [10M, 96] x [8192, 96].
//
// Design: a pre-pass splits y once into y_hi / y_lo (scratch [n, dp], k
// padded with zeros to dp, a multiple of 32) and computes |y|^2. One block
// of 8 warps owns BM rows of x and streams every y tile of BN = 128 rows
// through a 2-stage cp.async ring in k slices of 32. Each warp computes a
// (16 * MT) x (8 * NT) sub-tile with mma.sync m16n8k8 TF32 (three per
// product) into a fresh accumulator per k slice, added to the tile's in f32
// (the tensor cores' accumulation does not round to nearest: over one long
// k its error grew past the tolerance at d 1216), and the distance / clamp /
// min / argmin epilogue runs on the accumulator fragments; the running
// (min, argmin) of each row stays in registers across all y tiles, so no
// reduction crosses blocks. A block holds 128 x rows as 4 x 2 warps of 32 x
// 64; x is split into hi / lo as the fragments load. Up to d 256 the x tile
// stays resident in shared memory; past that its k slices ride the ring
// beside y's, read once per y tile, so every d runs (at d 544 and 1152 this
// beat resident tiles of 64 and 32 rows by 1.12x and 1.64x on the H100).
// Within a group of 8, a resident tile and y store k in the order 0 4 1 5 2
// 6 3 7, so a thread's two fragment values (k = t, t + 4) are one 8-byte
// load, and the row strides (= 8 mod 16 words) keep those loads free of bank
// conflicts; a streamed x slice keeps k in order at a row stride of 36
// words (= 4 mod 32), so its scalar fragment loads are conflict free too. A
// thread visits its columns in increasing order with a strict <; the
// reductions over the 4 threads of a quad and over the warps sharing a row
// are lexicographic on (distance, index): the first index wins ties.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using rtt::cp_async16;
using rtt::cp_async4;
using rtt::cp_commit;
using rtt::mma_tf32;
using rtt::tf32;

constexpr int BN = 128;     // y rows per tile: 4 warps x 32 columns
constexpr int BK = 32;      // k depth of a ring stage
constexpr int STAGES = 2;
constexpr int YS = BK + 8;  // ring row stride (words), = 8 mod 16
constexpr int XSS = BK + 4; // streamed x slice row stride (words), = 4 mod 32
constexpr int TPB = 256;    // 8 warps: WN along n, WM along m
constexpr int MT = 2;       // m16 tiles a warp
constexpr int WN = 2;
constexpr int WM = 8 / WN;
constexpr int NT = BN / (8 * WN);  // n8 tiles a warp
constexpr int BM = 16 * MT * WM;   // x rows a block: 128
constexpr size_t kMaxSmem = 232448;

inline int kpad(int d) { return (d + BK - 1) / BK * BK; }

// the x tile resident (xres) or streamed through the ring
size_t smem_bytes(int dp, bool xres) {
  return (xres ? (size_t)BM * (dp + 8) : (size_t)STAGES * BM * XSS) * 4  // x
         + (size_t)STAGES * 2 * BN * YS * 4  // y_hi / y_lo ring
         + BM * 4                            // |x|^2
         + WN * BM * 8;                      // (min, argmin) of the n-warps
}

// position p of a k group of 8 holds k = perm(p): 0 4 1 5 2 6 3 7
__device__ __forceinline__ int k_of(int p) {
  return (p & ~7) + ((p & 7) >> 1) + 4 * (p & 1);
}

// y -> y_hi, y_lo [n, dp] (k-permuted, zero past d)
__global__ void split_y_kernel(const float* __restrict__ y, int n, int d, int dp,
                               float* __restrict__ y_hi,
                               float* __restrict__ y_lo) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)n * dp) return;
  const long r = e / dp;
  const int k = k_of((int)(e % dp));
  const float v = k < d ? y[r * d + k] : 0.f;
  const float hi = __uint_as_float(tf32(v));
  y_hi[e] = hi;
  y_lo[e] = __uint_as_float(tf32(v - hi));
}

__global__ void row_sqnorm_kernel(const float* __restrict__ y, int n, int d,
                                  float* __restrict__ out) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float acc = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = y[r * d + j];
    acc = fmaf(v, v, acc);
  }
  out[r] = acc;
}

template <bool XRES>
__global__ void __launch_bounds__(TPB, 1)
fused_l2_argmin_kernel(const float* __restrict__ x,
                       const float* __restrict__ y_hi,
                       const float* __restrict__ y_lo,
                       const float* __restrict__ ysq, int m, int n, int d,
                       int dp, float* __restrict__ out_d,
                       int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const int XS = dp + 8;
  float* xs = smem;  // resident [BM][XS], or streamed [STAGES][BM][XSS]
  float* ring = xs + (XRES ? BM * XS : STAGES * BM * XSS);  // [STAGES][2][BN][YS]
  float* xsq = ring + STAGES * 2 * BN * YS;   // [BM]
  float* red_v = xsq + BM;                    // [WN][BM]
  int* red_i = reinterpret_cast<int*>(red_v + WN * BM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const long m0 = (long)blockIdx.x * BM;
  const int nck = dp / BK;
  const int total = (n + BN - 1) / BN * nck;  // ring stages: (y tile, k slice)

  auto issue = [&](int s) {
    if (s < total) {
      const int tile = s / nck, ck = s % nck;
      float* dst = ring + (s % STAGES) * 2 * BN * YS;
#pragma unroll
      for (int e0 = 0; e0 < 2 * BN * (BK / 4); e0 += TPB) {
        const int e = e0 + tid;
        const int arr = e / (BN * (BK / 4));
        const int r = (e / (BK / 4)) % BN, c4 = e % (BK / 4);
        const long row = (long)tile * BN + r;
        const bool ok = row < n;
        const float* src = (arr ? y_lo : y_hi) + (ok ? row : 0) * dp + ck * BK + 4 * c4;
        cp_async16(dst + arr * BN * YS + r * YS + 4 * c4, src, ok);
      }
      if constexpr (!XRES) {  // the x slice, k in order
        float* xdst = xs + (s % STAGES) * BM * XSS;
#pragma unroll 4
        for (int e = tid; e < BM * BK; e += TPB) {
          const int r = e / BK, c = e % BK;
          const long gr = m0 + r;
          const int k = ck * BK + c;
          const bool ok = gr < m && k < d;
          cp_async4(xdst + r * XSS + c, x + (ok ? gr * d + k : 0), ok);
        }
      }
    }
    cp_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  if constexpr (XRES) {
    // the resident x tile (k-permuted; zero rows past m and k past d)
    for (int e = tid; e < BM * dp; e += TPB) {
      const int r = e / dp, p = e % dp;
      const int k = k_of(p);
      const long gr = m0 + r;
      xs[r * XS + p] = (gr < m && k < d) ? x[gr * d + k] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
      const float* xr = xs + tid * XS;
      float a = 0.f;
      for (int j = 0; j < d; ++j) {
        const float v = xr[(j & ~7) + 2 * (j & 3) + ((j & 7) >> 2)];
        a = fmaf(v, v, a);
      }
      xsq[tid] = a;
    }
  } else {
    // |x|^2 from global memory, a warp per row (read after the ring's
    // first barrier)
    for (int r = warp; r < BM; r += TPB / 32) {
      const long gr = m0 + r;
      float a = 0.f;
      if (gr < m)
        for (int j = lane; j < d; j += 32) {
          const float v = __ldg(x + gr * d + j);
          a = fmaf(v, v, a);
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) xsq[r] = a;
    }
  }

  float acc[MT][NT][4];
  float best_v[MT][2];
  int best_i[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_v[i][h] = CUDART_INF_F;
      best_i[i][h] = 0;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }
  const int row0 = wm * 16 * MT + g;  // + 16 i (+ 8 for the fragment's upper half)

  for (int s = 0; s < total; ++s) {
    rtt::cp_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1 is free
    issue(s + STAGES - 1);
    const float* yh = ring + (s % STAGES) * 2 * BN * YS;
    const float* yl = yh + BN * YS;
    const float* xst = xs + (s % STAGES) * BM * XSS;  // streamed x slice
    const int ck = s % nck;
    // the slice's products go to a fresh accumulator, added to the tile's
    // with a rounded f32 add: the tensor cores' accumulation does not round
    // to nearest, and over a long k its error would grow with d
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float v[4];  // (g,t) (g+8,t) (g,t+4) (g+8,t+4)
        if constexpr (XRES) {
          const float* xr = xs + (row0 + 16 * i) * XS + ck * BK + kk + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(xr);
          const float2 v1 = *reinterpret_cast<const float2*>(xr + 8 * XS);
          v[0] = v0.x; v[1] = v1.x; v[2] = v0.y; v[3] = v1.y;
        } else {
          const float* xr = xst + (row0 + 16 * i) * XSS + kk + t;
          v[0] = xr[0]; v[1] = xr[8 * XSS]; v[2] = xr[4]; v[3] = xr[8 * XSS + 4];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ah[i][c] = tf32(v[c]);
          al[i][c] = tf32(v[c] - __uint_as_float(ah[i][c]));
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = (wn * 8 * NT + j * 8 + g) * YS + kk + 2 * t;
        const float2 bh = *reinterpret_cast<const float2*>(yh + col);
        const float2 bl = *reinterpret_cast<const float2*>(yl + col);
        const uint32_t h0 = __float_as_uint(bh.x), h1 = __float_as_uint(bh.y);
        const uint32_t l0 = __float_as_uint(bl.x), l1 = __float_as_uint(bl.y);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_tf32(part[i][j], al[i], h0, h1);
          mma_tf32(part[i][j], ah[i], l0, l1);
          mma_tf32(part[i][j], ah[i], h0, h1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
    if (ck == nck - 1) {  // the y tile is complete: fold it into the best
      const int n0 = (s / nck) * BN + wn * 8 * NT + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + j * 8 + e;
          if (col < n) {
            const float yn = __ldg(ysq + col);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float d2 = fmaxf(
                    xsq[row0 + 16 * i + 8 * h] + yn - 2.f * acc[i][j][2 * h + e], 0.f);
                if (d2 < best_v[i][h]) {
                  best_v[i][h] = d2;
                  best_i[i][h] = col;
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
      }
    }
  }

  // (min, argmin) over the quad's 4 threads, then over the 4 n-warps
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best_v[i][h];
      int ix = best_i[i][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        if (ov < v || (ov == v && oi < ix)) {
          v = ov;
          ix = oi;
        }
      }
      if (t == 0) {
        red_v[wn * BM + row0 + 16 * i + 8 * h] = v;
        red_i[wn * BM + row0 + 16 * i + 8 * h] = ix;
      }
    }
  }
  __syncthreads();
  if (tid < BM && m0 + tid < m) {
    float bv = red_v[tid];
    int bi = red_i[tid];
    for (int w = 1; w < WN; ++w) {
      const float v = red_v[w * BM + tid];
      const int ix = red_i[w * BM + tid];
      if (v < bv || (v == bv && ix < bi)) {
        bv = v;
        bi = ix;
      }
    }
    out_d[m0 + tid] = bv;
    out_i[m0 + tid] = bi;
  }
}

template <bool XRES>
cudaError_t launch(const float* x, const float* y_hi, const float* y_lo,
                   const float* ysq, int m, int n, int d, int dp, float* out_d,
                   int* out_i, cudaStream_t s) {
  const size_t smem = smem_bytes(dp, XRES);
  cudaError_t e = cudaFuncSetAttribute(fused_l2_argmin_kernel<XRES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  fused_l2_argmin_kernel<XRES><<<(int)(((long)m + BM - 1) / BM), TPB, smem, s>>>(
      x, y_hi, y_lo, ysq, m, n, d, dp, out_d, out_i);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch the caller allocates: y_hi, y_lo [n, dp] then |y|^2 [n].
extern "C" long rtt_fused_l2_argmin_scratch_floats(int n, int d) {
  return (long)n * (2L * kpad(d) + 1);
}

extern "C" int rtt_fused_l2_argmin(const float* x, const float* y, int m, int n,
                                   int d, float* scratch, float* out_d,
                                   int* out_i, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int dp = kpad(d);
  float* y_hi = scratch;
  float* y_lo = y_hi + (size_t)n * dp;
  float* ysq = y_lo + (size_t)n * dp;
  if (n > 0) {
    const long e = (long)n * dp;
    split_y_kernel<<<(int)((e + 255) / 256), 256, 0, s>>>(y, n, d, dp, y_hi, y_lo);
    row_sqnorm_kernel<<<(n + 255) / 256, 256, 0, s>>>(y, n, d, ysq);
  }
  if (m > 0) {
    // the x tile resident where it fits, else streamed
    const cudaError_t e =
        smem_bytes(dp, true) <= kMaxSmem
            ? launch<true>(x, y_hi, y_lo, ysq, m, n, d, dp, out_d, out_i, s)
            : launch<false>(x, y_hi, y_lo, ysq, m, n, d, dp, out_d, out_i, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
