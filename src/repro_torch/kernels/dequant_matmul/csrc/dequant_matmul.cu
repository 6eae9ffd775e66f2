// Fused int8-dequantize matmul for Hopper (sm_90a):
//     out (M, N) f32 = x (M, K) f32|bf16 @ (w_q (K, N) int8 * scale (N,) f32)
//
// Replaces dequant_matmul_pallas / _dequant_matmul_kernel
// (src/repro/kernels/dequant_matmul/kernel.py).  As there, the per-channel
// scale is applied to the weight tile before the products, and every sum is
// taken in f32.
//
// What bounds it: at decode (M = live slots) the int8 weight bytes.  A
// full-width llama3-8b step reads 7.51 GB of levels in 225 calls, 2.24 ms at
// 3.35 TB/s.
// At prefill (M = B*S = 512) the f32 arithmetic: the contract is f32, so the
// tensor cores' bf16/TF32 rates do not apply and the bound is the 67 TFLOP/s
// f32 peak.
//
// Design (simple first; tensor cores, wgmma, TMA and split-K come later):
// * M <= 5 (decode): one block per 32-column strip of N covering all M rows.
//   The K loop runs inside the block: 8 threads span the strip's 32 bytes of
//   a weight row (one char4 each, coalesced along N, which is contiguous),
//   and 128 such groups take every 128th row.  The bytes are the bound, so a
//   block of 1024 threads issues all 8 of each thread's row loads of a
//   1024-row pass before using any (32 KB in flight per SM).  x is staged
//   through shared memory in f32, one pass at a time; M is a template
//   argument so the accumulator is exactly M x 4 registers.  The 128 partial
//   sums per output are reduced by warp shuffles, then through the same
//   shared buffer.  Narrow strips give N/32 blocks: 32 for the 4096x1024
//   projections, which therefore use a quarter of the SMs.  At 1024 threads
//   M = 6..8 would spill the accumulator, so those take the tiled path.
// * M > 5 (prefill): a 64x64 output tile per block, K in steps of 16
//   (dm_tiled.cuh, shared with dequant_matmul_grouped.cu).  The x tile
//   (converted to f32) and the weight tile (dequantized, q * scale, in f32)
//   are staged in shared memory; each of 256 threads accumulates a 4x4
//   register tile with f32 FMAs.
// Both mask the ragged edges of M, N and K themselves; no host padding.
// Offsets are 64-bit: the head's K*N is 525 M.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dm_tiled.cuh"

namespace {

using dm::to_f32;

// ---- decode path: M <= 5 ------------------------------------------------
constexpr int SM_MAXM = 5;
constexpr int SM_THREADS = 1024;
constexpr int SM_BN = 32;                   // output columns per block
constexpr int SM_CG = SM_BN / 4;            // threads across a row, 4 cols each
constexpr int SM_KS = SM_THREADS / SM_CG;   // row slices (128)
constexpr int SM_KC = 1024;                 // rows of x staged per pass
constexpr int SM_WARPS = SM_THREADS / 32;
constexpr int SM_UNROLL = SM_KC / SM_KS;    // weight rows in flight per thread

// MR = M rows, fixed at compile time so the accumulator is MR x 4 registers
template <typename XT, int MR>
__global__ void __launch_bounds__(SM_THREADS)
dm_small_m(const XT* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, float* __restrict__ out,
           int K, int N, int vec) {
  // x staging during the K loop, then the cross-warp partial sums
  __shared__ float buf[MR * SM_KC];
  static_assert(SM_WARPS * SM_BN <= SM_KC, "partials must fit the buffer");
  const int tid = threadIdx.x;
  const int cg = tid % SM_CG;
  const int ks = tid / SM_CG;
  const long long n0 = (long long)blockIdx.x * SM_BN + cg * 4;

  float s[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = (n0 + c < N) ? scale[n0 + c] : 0.f;

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  const bool full4 = vec && (n0 + 3 < N);
  for (int k0 = 0; k0 < K; k0 += SM_KC) {
    const int kc = min(SM_KC, K - k0);
    __syncthreads();                      // the last pass is done with buf
#pragma unroll
    for (int m = 0; m < MR; ++m)
      buf[m * SM_KC + tid] =
          tid < kc ? to_f32(x[(long long)m * K + k0 + tid]) : 0.f;
    __syncthreads();
    // all of this thread's rows of the pass are loaded before any is used;
    // each row stays packed as one char4 (one register) until its FMAs
    char4 wq[SM_UNROLL];
#pragma unroll
    for (int j = 0; j < SM_UNROLL; ++j) {
      const int kk = ks + j * SM_KS;
      const int8_t* wr = w + (long long)(k0 + kk) * N + n0;
      if (kk >= kc) {
        wq[j] = make_char4(0, 0, 0, 0);
      } else if (full4) {
        wq[j] = *reinterpret_cast<const char4*>(wr);
      } else {
        wq[j] = make_char4(n0 < N ? wr[0] : 0, n0 + 1 < N ? wr[1] : 0,
                           n0 + 2 < N ? wr[2] : 0, n0 + 3 < N ? wr[3] : 0);
      }
    }
#pragma unroll
    for (int j = 0; j < SM_UNROLL; ++j) {
      const int kk = ks + j * SM_KS;
      const float wf[4] = {(float)wq[j].x * s[0], (float)wq[j].y * s[1],
                           (float)wq[j].z * s[2], (float)wq[j].w * s[3]};
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = buf[m * SM_KC + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
      }
    }
  }

  // lanes l, l^8, l^16, l^24 of a warp hold the same columns
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();                        // buf is free: reuse for partials
  if (lane < SM_CG) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        buf[(m * SM_WARPS + warp) * SM_BN + cg * 4 + c] = acc[m][c];
  }
  __syncthreads();
  if (tid < MR * SM_BN) {
    const int m = tid / SM_BN, col = tid % SM_BN;
    const long long n = (long long)blockIdx.x * SM_BN + col;
    if (n < N) {
      float v = 0.f;
#pragma unroll 8
      for (int wi = 0; wi < SM_WARPS; ++wi)
        v += buf[(m * SM_WARPS + wi) * SM_BN + col];
      out[(long long)m * N + n] = v;
    }
  }
}

template <typename XT>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K, int N, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= SM_MAXM) {
    const int vec = (N % 4 == 0) && ((uintptr_t)w % 4 == 0);
    dim3 grid((N + SM_BN - 1) / SM_BN);
#define DM_SMALL(MR)                                                      \
  case MR:                                                                \
    dm_small_m<XT, MR><<<grid, SM_THREADS, 0, st>>>(xp, wp, sp, op, K, N, \
                                                    vec);                 \
    break;
    switch (M) {
      DM_SMALL(1) DM_SMALL(2) DM_SMALL(3) DM_SMALL(4) DM_SMALL(5)
    }
#undef DM_SMALL
    return (int)cudaGetLastError();
  }
  return dm::launch_tiled<XT, false>(x, w, scale, out, M, K, N, 1, 0, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x_is_bf16 selects the x type;
// all tensors are contiguous and on the current device; the launch goes on
// `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int dequant_matmul_launch(const void* x, int x_is_bf16,
                                     const void* w, const void* scale,
                                     void* out, int M, int K, int N,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (x_is_bf16)
    return launch<__nv_bfloat16>(x, w, scale, out, M, K, N, st);
  return launch<float>(x, w, scale, out, M, K, N, st);
}
