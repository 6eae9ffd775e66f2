// Grouped-expert int8-dequantize matmul for Hopper (sm_90a), one
// independent product per expert e:
//     out[e] (M, N) f32 = x[e] (M, K) f32|bf16 @ (w_q[e] (K, N) int8 * s)
// with s = scale[e] for an (E, N) scale, or the one (N,) scale all experts
// share (the stacked-MoE wire format), passed as an expert stride of 0.
//
// Replaces dequant_matmul_grouped_pallas / _dequant_matmul_grouped_kernel
// (src/repro/kernels/dequant_matmul/kernel.py).  As there, the per-channel
// scale multiplies the weight tile before the products and every sum is f32.
//
// What bounds it, at the main path's shapes (deepseek-moe-16b: E = 64,
// (K, N) = (2048, 1408) for w_gate / w_up and (1408, 2048) for w_down, x in
// bf16; 81 calls per forward pass): 184.5 MB of int8 levels per call, plus x
// and the f32 output.  The capacity buffer gives M = 64 rows per expert at
// a 4 x 128-token prefill and M = 32 at a 4-slot decode step, most of them
// zero rows at decode; the function is the dense product of that buffer.
// In f32 outside the tensor cores that is 23.6 GFLOP (0.35 ms at
// 67 TFLOP/s) at prefill and 11.8 GFLOP (0.18 ms) at decode, against
// 0.061-0.069 ms of bytes at 3.35 TB/s: the arithmetic bounds both.
//
// Design (simple first): the 64x64 f32 output tile of dequant_matmul.cu's
// prefill path (dm_tiled.cuh), with the expert on blockIdx.z and 64-bit
// per-expert row offsets; ragged M, K and N are masked in the kernel, with no
// host padding.  The capacity buffer stays dense: empty experts and padding
// rows are computed, as the reference computes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dm_tiled.cuh"

// Plain C entry point (loaded with ctypes).  x (E, M, K), w (E, K, N) and
// out (E, M, N) are contiguous; scale holds E * scale_stride + N floats
// (scale_stride N for an (E, N) scale, 0 for a shared (N,) one).  The launch
// goes on `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int dequant_matmul_grouped_launch(const void* x, int x_is_bf16,
                                             const void* w,
                                             const void* scale,
                                             long long scale_stride,
                                             void* out, int E, int M, int K,
                                             int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (x_is_bf16)
    return dm::launch_tiled<__nv_bfloat16, true>(x, w, scale, out, M, K, N,
                                                 E, scale_stride, st);
  return dm::launch_tiled<float, true>(x, w, scale, out, M, K, N, E,
                                       scale_stride, st);
}
