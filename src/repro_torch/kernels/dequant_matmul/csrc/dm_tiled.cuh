// The 64x64 f32 output-tile dequantize-matmul of dequant_matmul_grouped.cu's
// f32-x instance, one matrix per expert on blockIdx.z.  For the z-th
// matrix:
//     out[z] (M, N) f32 = x[z] (M, K) @ (w[z] (K, N) int8 * scale[z] (N,))
// with x, w and out packed back to back ((z, M, K), (z, K, N), (z, M, N))
// and scale advancing by scale_stride per matrix (0: one (N,) scale shared
// by all of them).  The x tile and the weight tile
// (dequantized, q * scale, in f32) are staged in shared memory, K in steps
// of 16; each of 256 threads accumulates a 4x4 register tile with f32 FMAs.
// Ragged M, N and K edges are masked here; offsets are 64-bit.  (Folding
// z * M and z * K into the indices instead of shifting the pointers slowed
// the kernel.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dm {

constexpr int TB_M = 64, TB_N = 64, TB_K = 16, TB_THREADS = 256;
constexpr int TB_XPAD = 4;                  // keeps float4 rows, fewer conflicts

__global__ void __launch_bounds__(TB_THREADS)
dm_tiled(const float* __restrict__ x, const int8_t* __restrict__ w,
         const float* __restrict__ scale, float* __restrict__ out,
         int M, int K, int N, long long scale_stride) {
  __shared__ __align__(16) float xs[TB_K][TB_M + TB_XPAD];
  __shared__ __align__(16) float ws[TB_K][TB_N];
  {
    const long long z = blockIdx.z;
    x += z * M * K;
    w += z * K * N;
    out += z * M * N;
    scale += z * scale_stride;
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * TB_M;
  const long long n0 = (long long)blockIdx.x * TB_N;
  // the weight column this thread stages is the same on every K step
  const int lcol = tid % TB_N;
  const float sc = (n0 + lcol < N) ? scale[n0 + lcol] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TB_K) {
#pragma unroll
    for (int i = 0; i < (TB_M * TB_K) / TB_THREADS; ++i) {
      const int e = tid + TB_THREADS * i;
      const int row = e / TB_K, kk = e % TB_K;
      const long long m = m0 + row, k = k0 + kk;
      xs[kk][row] = (m < M && k < K) ? x[m * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (TB_K * TB_N) / TB_THREADS; ++i) {
      const int e = tid + TB_THREADS * i;
      const int kk = e / TB_N;
      const long long k = k0 + kk, n = n0 + lcol;
      ws[kk][lcol] = (k < K && n < N) ? (float)w[k * N + n] * sc : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx * 4 + j;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

// Launch `matrices` tiled products (grid z).  Returns cudaGetLastError().
inline int launch_tiled(const void* x, const void* w, const void* scale,
                        void* out, int M, int K, int N, int matrices,
                        long long scale_stride, cudaStream_t st) {
  dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M, matrices);
  dm_tiled<<<grid, TB_THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N,
      scale_stride);
  return (int)cudaGetLastError();
}

}  // namespace dm
