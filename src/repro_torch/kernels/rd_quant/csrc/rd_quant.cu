// Rate-distortion level assignment (paper eq. 11) for Hopper (sm_90a):
//     out[i] = argmin_k  F_i (w_i - step k)^2 + lam * rate(k, prev_sig_i)
// over k in {clip(nn_i + d) : |d| <= window} and {0}, the first minimum on
// a strict <, with nn_i = clip(rint(w_i / step)).  One launch is one pass
// of the prev_sig fixed-point iteration.
//
// Replaces rd_quant_pallas / _rd_quant_kernel
// (src/repro/kernels/rd_quant/kernel.py), computing what its jnp oracle
// rd_quant_ref (src/repro/kernels/rd_quant/ref.py) computes, element by
// element.  Not a copy of the (M, 1024) VMEM tiling.
//
// What bounds it: the operations.  A pass reads w (2 B in bf16), writes the
// int32 levels (4 B) and, after the first pass, reads the previous pass's
// int32 levels (4 B); Fisher weights add 4 B when given: 16 B per bf16
// element for 2 passes.  Each pass does ~300 operations per element (10
// candidates x ~30 f32, integer and select operations, plus the nearest
// level), none fused into an FMA, so each takes one lane-issue slot: on an
// H100 (3.35 TB/s; 67 TFLOP/s f32 counting an FMA as 2, so 33.5 T un-fused
// operations/s) the operation bound is ~4x the byte bound.  chip_smoke.py
// computes both from its inputs.
//
// Design:
// * prev_sig is read, never materialised: pass 1 (prev == nullptr) takes
//   the significance of element i-1's f32 nearest level, which the warp
//   already holds (a shuffle; lane 0 recomputes it); later passes read
//   element i-1 of the previous pass's int32 output (the wrapper
//   ping-pongs two buffers).  No full-size f32 prev_sig or ones array.
// * fisher == nullptr means F = 1 (the product by 1 is exact, so the
//   oracle's ones array changes nothing).
// * w is read as f32 or bf16 (bf16 -> f32 is exact).
// * Rounding equals the oracle's f32 operations one by one: every
//   product, sum and the division use the _rn intrinsics, which nvcc never
//   contracts into an FMA, in the oracle's order ((l1 + sign) + mag, then
//   dist + lam * rate); rintf rounds half to even as jnp.round does.
// * The magnitude-class select is a direct index into the (num_gr + 32)
//   class table in shared memory; a class outside it costs 0, as the
//   oracle's one-hot sum gives.  The class comes from integer arithmetic on
//   |k| (exact: the wrapper requires max_level < 2^24).
// * One thread per element over the flat tensor, a grid-stride loop with a
//   block-uniform trip count (the shuffle needs every lane), no padding.
//   No work crosses blocks within a pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_CLASSES = 288;   // num_gr <= 255 (a u8) + 32 exponents
constexpr int THREADS = 256;

struct RateCoeffs {
  float sc[8];   // l0_sig0, l0_sig1, l1_sig0, l1_sig1, l_neg, l_pos, pad
  float mag[MAX_CLASSES];
};

__device__ __forceinline__ float load_w(const float* w, int64_t i) {
  return w[i];
}
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int64_t i) {
  return __bfloat162float(w[i]);
}

__device__ __forceinline__ float nearest(float w, float step, float ml) {
  return fminf(fmaxf(rintf(__fdiv_rn(w, step)), -ml), ml);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
rd_quant_pass(const WT* __restrict__ w, const float* __restrict__ fisher,
              const int32_t* __restrict__ prev, int32_t* __restrict__ out,
              int64_t n, float step, float lam, int window, float ml,
              int num_gr, int n_classes, RateCoeffs coeffs) {
  __shared__ float mag[MAX_CLASSES];
  for (int c = threadIdx.x; c < n_classes; c += blockDim.x)
    mag[c] = coeffs.mag[c];
  __syncthreads();
  const float l_neg = coeffs.sc[4], l_pos = coeffs.sc[5];
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < n;
    const float wi = valid ? load_w(w, i) : 0.f;
    const float nn = nearest(wi, step, ml);
    int ps;
    if (prev == nullptr) {
      float nn_prev = __shfl_up_sync(0xffffffffu, nn, 1);
      if (lane == 0)
        nn_prev = (valid && i > 0) ? nearest(load_w(w, i - 1), step, ml) : 0.f;
      ps = (i > 0 && nn_prev != 0.f) ? 1 : 0;
    } else {
      ps = (valid && i > 0 && prev[i - 1] != 0) ? 1 : 0;
    }
    if (!valid) continue;
    const float fi = fisher != nullptr ? fisher[i] : 1.f;
    const float l0 = ps ? coeffs.sc[1] : coeffs.sc[0];
    const float l1 = ps ? coeffs.sc[3] : coeffs.sc[2];
    float best_cost = INFINITY;
    float best_k = nn;
    for (int d = -window; d <= window + 1; ++d) {
      // d == window + 1 stands for the zero candidate, taken last
      const float k = d <= window ? fminf(fmaxf(__fadd_rn(nn, (float)d), -ml), ml)
                                  : 0.f;
      const float e = __fsub_rn(wi, __fmul_rn(step, k));
      float dist = __fmul_rn(e, e);
      if (fisher != nullptr) dist = __fmul_rn(fi, dist);
      float rate;
      if (k == 0.f) {
        rate = l0;
      } else {
        const int a = (int)fabsf(k);
        const int cls = a <= num_gr ? a - 1
                                    : num_gr + (31 - __clz(a - num_gr));
        const float m = cls < n_classes ? mag[cls] : 0.f;
        rate = __fadd_rn(__fadd_rn(l1, k < 0.f ? l_neg : l_pos), m);
      }
      const float cost = __fadd_rn(dist, __fmul_rn(lam, rate));
      if (cost < best_cost) {
        best_cost = cost;
        best_k = k;
      }
    }
    out[i] = (int32_t)best_k;
  }
}

}  // namespace

// One assignment pass.  w: n f32 (w_is_bf16 = 0) or bf16 values; fisher:
// n f32 or null (F = 1); prev: n int32 levels of the previous pass or null
// (pass 1); out: n int32.  scalars (8) and mag (n_classes) are host arrays,
// passed to the kernel by value.  The grid is at most blocks_per_sm blocks
// per SM (the threads stride over the rest); each element's level depends
// on its own inputs only, so the levels do not depend on it.  Returns the
// cudaError_t of the launch.
extern "C" int rd_quant_launch(const void* w, int w_is_bf16,
                               const void* fisher, const void* prev,
                               void* out, int64_t n, float step, float lam,
                               int window, float max_level, int num_gr,
                               const float* scalars, const float* mag,
                               int n_classes, int blocks_per_sm,
                               void* stream) {
  if (n <= 0) return 0;
  if (n_classes > MAX_CLASSES || n_classes < 1 || window < 0 ||
      blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  RateCoeffs c;
  for (int j = 0; j < 8; ++j) c.sc[j] = scalars[j];
  for (int j = 0; j < MAX_CLASSES; ++j) c.mag[j] = j < n_classes ? mag[j] : 0.f;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t need = (n + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * blocks_per_sm;
  const int blocks = (int)(need < cap ? need : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(fisher);
  const int32_t* p = static_cast<const int32_t*>(prev);
  int32_t* o = static_cast<int32_t*>(out);
  if (w_is_bf16)
    rd_quant_pass<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), f, p, o, n, step, lam, window,
        max_level, num_gr, n_classes, c);
  else
    rd_quant_pass<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(w), f, p, o, n, step, lam, window,
        max_level, num_gr, n_classes, c);
  return (int)cudaGetLastError();
}
