// fused_l2_argmin: for each x row, min over y rows of max(|x|^2 + |y|^2 -
// 2<x, y>, 0) and its argmin (first index on ties). The [m, n] distance
// matrix is never stored.
//
// Replaces the TPU kernel raft_tpu/ops/pallas_kernels.py:fused_l2_argmin
// (l.112, body _fused_l2_argmin_kernel l.62), whose sequential grid axis
// over y tiles carried the running (min, argmin) in the output block.
//
// Bound on the H100: operations. 2 * m * n * d fp32 FLOPs against
// (m + n) * d * 4 bytes; at the build's final sweeps (5M x 8192 x 96) that
// is 7.9 TFLOP, ~117 ms at the 67 TFLOP/s fp32 non-tensor rate. Tensor
// cores are out: TF32 would flip argmins (fp32-exact is the contract).
//
// Design: one block per 64-row tile of x loops over ALL y tiles, so the
// running (min, argmin) stays in registers and no reduction crosses
// blocks. Each 64 x 64 output tile is a classic shared-memory SGEMM tile
// (16-deep k slices, a 4 x 4 register micro-tile per thread, fp32 FMAs)
// with the distance/min epilogue fused on the registers. A thread visits
// its columns in increasing order with a strict <, and the final
// reduction over the 16 threads sharing a row is lexicographic on
// (distance, index): the first index wins ties, as on the TPU.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TPB = 256;  // 16 x 16 threads, 4 x 4 outputs each

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

__global__ void __launch_bounds__(TPB)
fused_l2_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ ysq, int m, int n, int d,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float xs[BK][BM];
  __shared__ float ys[BK][BN];
  __shared__ float xsq[BM];
  __shared__ float red_v[16][BM];
  __shared__ int red_i[16][BM];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long m0 = (long)blockIdx.x * BM;

  if (tid < BM) {
    float acc = 0.f;
    if (m0 + tid < m) {
      const float* xr = x + (m0 + tid) * d;
      for (int j = 0; j < d; ++j) acc = fmaf(xr[j], xr[j], acc);
    }
    xsq[tid] = acc;
  }

  float best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

  for (int n0 = 0; n0 < n; n0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BM * BK; e += TPB) {
        const int r = e / BK, kk = e % BK;
        const long gr = m0 + r;
        const int gk = k0 + kk;
        xs[kk][r] = (gr < m && gk < d) ? x[gr * d + gk] : 0.f;
        const long gc = (long)n0 + r;
        ys[kk][r] = (gc < n && gk < d) ? y[gc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ys[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) {
        const float yn = ysq[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float d2 = xsq[ty + 16 * i] + yn - 2.f * acc[i][j];
          d2 = fmaxf(d2, 0.f);
          if (d2 < best_v[i]) {
            best_v[i] = d2;
            best_i[i] = col;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red_v[tx][ty + 16 * i] = best_v[i];
    red_i[tx][ty + 16 * i] = best_i[i];
  }
  __syncthreads();
  if (tid < BM && m0 + tid < m) {
    float bv = red_v[0][tid];
    int bi = red_i[0][tid];
    for (int t = 1; t < 16; ++t) {
      const float v = red_v[t][tid];
      const int ix = red_i[t][tid];
      if (v < bv || (v == bv && ix < bi)) {
        bv = v;
        bi = ix;
      }
    }
    out_d[m0 + tid] = bv;
    out_i[m0 + tid] = bi;
  }
}

}  // namespace

// ysq_scratch: [n] floats allocated by the caller.
extern "C" int rtt_fused_l2_argmin(const float* x, const float* y, int m, int n,
                                   int d, float* ysq_scratch, float* out_d,
                                   int* out_i, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) row_sqnorm_kernel<<<(n + 255) / 256, 256, 0, s>>>(y, n, d, ysq_scratch);
  if (m > 0) {
    fused_l2_argmin_kernel<<<(m + BM - 1) / BM, TPB, 0, s>>>(x, y, ysq_scratch, m, n,
                                                            d, out_d, out_i);
  }
  return (int)cudaGetLastError();
}
