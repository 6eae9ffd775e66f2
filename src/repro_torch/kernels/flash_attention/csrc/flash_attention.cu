// Causal flash attention (online softmax) for Hopper (sm_90a):
//     q (B, Sq, H, D), k, v (B, Skv, G, D), G | H, f32 or bf16 -> (B, Sq, H, D)
//
// Replaces flash_attention_pallas / _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py) with the same function:
// query row i sees key j when j <= i + (Skv - Sq); masked scores are the
// finite -1e30; the running max, denominator and output accumulator stay in
// f32; p is rounded to v's type before the PV product while the denominator
// sums the f32 p; the denominator is floored at 1e-30; the output is in q's
// type; KV tiles past the causal limit of a query tile are never read.
//
// What bounds it: bytes.  At the full-width prefill (B=4, S=128, H=32, G=8,
// D=128, bf16) it reads q, k, v and writes the output once, 10.5 MB, a
// 3.1 us bound at 3.35 TB/s, against 0.54 GFLOP of work.
//
// Design (simple first): one block of 4 warps per (b*h, 16-row query tile).
// The block stages its query rows and then 32-key tiles of K and V in shared
// memory as f32 (K rows padded by one word so 32 lanes reading 32 keys hit
// 32 banks).  Each warp owns 4 query rows; for each row, lane j scores key j
// of the tile, the warp reduces max and sum by shuffles, and each lane keeps
// D/32 columns of the f32 accumulator in registers.  GQA reads KV head
// h / (H/G) in place; nothing is repeated in memory.  Ragged query and key
// edges are masked in the kernel (keys past Skv get p = 0 exactly), so no
// power-of-two tile has to divide S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FA_BQ = 16;                   // query rows per block
constexpr int FA_BKV = 32;                  // keys per tile (one per lane)
constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_ROWS = FA_BQ / FA_WARPS;   // query rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
          int H, int G, float scale) {
  constexpr int DL = D / 32;                // accumulator columns per lane
  __shared__ float ks[FA_BKV][D + 1];
  __shared__ float vs[FA_BKV][D];
  __shared__ float qs[FA_BQ][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int q0 = blockIdx.x * FA_BQ;
  const int offs = Skv - Sq;                // causal alignment (q at the end)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < FA_BQ * D; e += FA_THREADS) {
    const int r = e / D, d = e % D, s = q0 + r;
    qs[r][d] = s < Sq ? to_f32(q[(((long long)b * Sq + s) * H + h) * D + d])
                      : 0.f;
  }

  float m_i[FA_ROWS], l_i[FA_ROWS], acc[FA_ROWS][DL];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  // the tile's last query row reaches key q_last + offs: later tiles are dead
  const int q_last = min(q0 + FA_BQ, Sq) - 1;
  const int kv_end = min(Skv, q_last + offs + 1);
  for (int t0 = 0; t0 < kv_end; t0 += FA_BKV) {
    __syncthreads();                        // q staged / last tile consumed
    for (int e = tid; e < FA_BKV * D; e += FA_THREADS) {
      const int j = e / D, d = e % D, t = t0 + j;
      const long long off = (((long long)b * Skv + t) * G + g) * D + d;
      ks[j][d] = t < Skv ? to_f32(k[off]) : 0.f;
      vs[j][d] = t < Skv ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    const int col = t0 + lane;
    const bool in_range = col < Skv;
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      const int row = warp * FA_ROWS + r;
      const int qi = q0 + row;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[row][d], ks[lane][d], s);
      s *= scale;
      if (col > qi + offs) s = NEG_INF;
      const float m_new = fmaxf(m_i[r], warp_max(in_range ? s : -INFINITY));
      const float p = in_range ? expf(s - m_new) : 0.f;
      const float corr = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr + warp_sum(p);
      const float pv = to_f32(from_f32<T>(p));   // p.astype(v.dtype)
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < FA_BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
        for (int i = 0; i < DL; ++i)
          acc[r][i] = fmaf(pj, vs[j][lane + 32 * i], acc[r][i]);
      }
      m_i[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int qi = q0 + warp * FA_ROWS + r;
    if (qi >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l_i[r], 1e-30f);
    T* orow = out + (((long long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      orow[lane + 32 * i] = from_f32<T>(acc[r][i] * inv_l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int G, int D, float scale,
           cudaStream_t st) {
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  switch (D) {
    case 32:
      flash_fwd<T, 32><<<grid, FA_THREADS, 0, st>>>(qp, kp, vp, op, Sq, Skv,
                                                    H, G, scale);
      break;
    case 128:
      flash_fwd<T, 128><<<grid, FA_THREADS, 0, st>>>(qp, kp, vp, op, Sq, Skv,
                                                     H, G, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All tensors contiguous in the
// (B, S, heads, D) layout, on the current device; is_bf16 selects the type.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int B, int Sq, int Skv, int H, int G,
                                      int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, G, D, scale, st);
  return launch<float>(q, k, v, out, B, Sq, Skv, H, G, D, scale, st);
}
