// Grouped-expert int8-dequantize matmul for Hopper (sm_90a), one
// independent product per expert e:
//     out[e] (M, N) f32 = x[e] (M, K) f32|bf16 @ (w_q[e] (K, N) int8 * s)
// with s = scale[e] for an (E, N) scale, or the one (N,) scale all experts
// share (the stacked-MoE wire format), passed as an expert stride of 0.
//
// Replaces dequant_matmul_grouped_pallas / _dequant_matmul_grouped_kernel
// (src/repro/kernels/dequant_matmul/kernel.py).  Every sum is f32.
//
// Two instances, chosen by x's type:
//
// * bf16 x (dm_grouped_tc, the main path): tensor cores.
//   Why it computes the reference's function.  The reference multiplies the
//   weight tile by the per-column scale and sums x * (q * s) in f32.  A bf16
//   x has an 8-bit significand and an int8 level is exactly a bf16, so each
//   product x * q is exact in f32 (at most 16 significant bits); the tensor
//   cores take bf16 x bf16 and sum those exact products in f32; and s[n]
//   factors out of the sum over K, so it multiplies once in the epilogue:
//   out = s[n] * sum_k x * q.  Only the order and the rounding points of the
//   f32 sums differ.  Measured on the CPU (E = 8, M = 32, K = 2048,
//   N = 1408, bf16 x, shared scale; tests/test_torch_precision.py prints it
//   when run as a script), relative to max|exact f64|: s * (x @ q) in f32 is
//   6.1e-7 from the reference's x @ (q * s), which is itself 6.5e-7 from the
//   exact result (s * (x @ q): 1.4e-7).  On the card (chip_smoke.py, NVIDIA
//   H100 80GB HBM3, 700 W) the kernel is 2.1e-6 to 2.8e-6 of max|plain| from
//   its plain version at the main path's 8 shapes; the tolerance is 1e-4.
//   What bounds it: bytes.  At E = 64, (K, N) = (2048, 1408), M = 32 it
//   reads 184.5 MB of levels, 8.4 MB of x and writes 11.5 MB of f32 output:
//   0.061 ms at 3.35 TB/s, against 11.8 GFLOP (0.012 ms at the 989 TFLOP/s
//   bf16 rate).
//   Design: one block of 4 warps per (expert, 128-column strip of N, up to
//   64 rows of M), so at the main path's M (32 at decode, 64 at prefill)
//   each weight byte is read from HBM once per call and converted once; the
//   M tile is 32 or 64 rows (a template argument), padded in registers,
//   not in memory.  K advances 64 at a time through a 4-stage cp.async ring
//   (16 KB per stage at M = 64: 48 KB in flight per block) with one barrier
//   per step.  Each warp owns 32 columns and all rows: per k16 step it loads
//   4 words of levels (rows 4tg..4tg+3, columns 4gr..4gr+3 of its strip),
//   turns each byte into an f32 by the 2^23 exponent trick (exact), packs
//   pairs into bf16 B fragments and runs mma.sync.m16n8k16 (bf16 in, f32
//   accumulate).  That needs a fixed permutation of k and n inside the
//   fragments: fragment k 2tg, 2tg+1, 2tg+8, 2tg+9 is level row 4tg..4tg+3
//   (A takes x's columns in the same order, one 8-byte load), and fragment
//   column j * 8 + c is output column 4c + j, so each lane ends up holding 8
//   consecutive output columns and stores them as two float4.  Both shared
//   tiles are XOR-swizzled by 16-byte chunk so every load phase hits 32
//   banks.  Rows of x and w whose length is not a multiple of 16 bytes, or
//   operands off a 16-byte boundary, take the element-wise loader of the
//   same kernel (ALIGNED = false): synchronous loads into the same ring.
//   Ragged M, N and K are masked in the kernel (zero-filled operands in the
//   K tail); no host padding.
// * f32 x: dm_tiled.cuh's 64x64 f32 FMA tile (shared with dequant_matmul.cu's
//   prefill path), the expert on blockIdx.z, the scale applied to the weight
//   tile before the products as in the reference.  A f32 x has 24
//   significant bits, so the bf16 argument above does not hold for it.
//
// The capacity buffer stays dense: empty experts and padding rows are
// computed, as the reference computes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/ptx.cuh"
#include "dm_tiled.cuh"

namespace {

using namespace ptx;

constexpr int TC_BN = 128;                  // output columns per block
constexpr int TC_BK = 64;                   // K per ring stage
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 128;             // 4 warps x 32 columns

template <int MT>                           // MT m16 tiles: 16 * MT rows
struct TcTile {
  static constexpr int BM = 16 * MT;
  static constexpr int X_BYTES = BM * TC_BK * 2;   // bf16 x, 128 B per row
  static constexpr int W_BYTES = TC_BK * TC_BN;    // int8 levels
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = TC_STAGES * STAGE;
};

// Byte offsets in a stage's tiles, XOR-swizzled by 16-byte chunk.  x: row m
// (128 B = 64 bf16 of K), chunk ch ^ 2 (m & 3): a half-warp's 8-byte A loads
// (rows gr, chunks 2 k16 + tg / 2) land in 8 distinct chunks.  w: row k
// (128 B = the strip's columns), chunk ch ^ 2 ((k >> 2) & 3): a warp's word
// loads (rows 4 tg + r, chunks 2 warp + gr / 4) land in 8 distinct chunks.
__device__ __forceinline__ int x_off(int m, int byte) {
  return m * 128 + ((((byte >> 4) ^ ((m & 3) << 1))) << 4) + (byte & 15);
}
__device__ __forceinline__ int w_off(int k, int byte) {
  return k * 128 + ((((byte >> 4) ^ (((k >> 2) & 3) << 1))) << 4) +
         (byte & 15);
}

// Stage one K step: x rows m0.. (BM of them, K columns k0..k0+63) and level
// rows k0..k0+63 (columns n0..n0+127), zero outside M, K and N.
template <int MT, bool ALIGNED>
__device__ __forceinline__ void load_stage(
    unsigned char* xs, unsigned char* ws, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int N, int m0, int n0,
    int k0, int tid) {
  constexpr int BM = TcTile<MT>::BM;
  if (ALIGNED) {                 // K % 8 == 0, N % 16 == 0, aligned bases
    for (int c = tid; c < BM * 8; c += TC_THREADS) {
      const int r = c >> 3, kk = k0 + (c & 7) * 8, m = m0 + r;
      const bool ok = m < M && kk < K;
      cp_async16(smem_u32(xs + x_off(r, (c & 7) * 16)),
                 x + (ok ? (long long)m * K + kk : 0), ok);
    }
    for (int c = tid; c < TC_BK * 8; c += TC_THREADS) {
      const int r = c >> 3, n = n0 + (c & 7) * 16, kk = k0 + r;
      const bool ok = kk < K && n < N;
      cp_async16(smem_u32(ws + w_off(r, (c & 7) * 16)),
                 w + (ok ? (long long)kk * N + n : 0), ok);
    }
  } else {
    for (int e = tid; e < BM * TC_BK; e += TC_THREADS) {
      const int r = e / TC_BK, kc = e % TC_BK, m = m0 + r, kk = k0 + kc;
      const __nv_bfloat16 v = (m < M && kk < K) ? x[(long long)m * K + kk]
                                                : __float2bfloat16(0.f);
      *reinterpret_cast<__nv_bfloat16*>(xs + x_off(r, kc * 2)) = v;
    }
    for (int e = tid; e < TC_BK * TC_BN; e += TC_THREADS) {
      const int r = e / TC_BN, nc = e % TC_BN, kk = k0 + r, n = n0 + nc;
      ws[w_off(r, nc)] = (kk < K && n < N)
                             ? static_cast<unsigned char>(
                                   w[(long long)kk * N + n])
                             : 0;
    }
  }
}

// byte i of u (an int8 level xor 0x80, i.e. level + 128) as an exact f32
__device__ __forceinline__ uint32_t level_f32_bits(uint32_t u, int i) {
  const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i));
  return __float_as_uint(f - 8388736.f);    // 2^23 + 128
}

template <int MT, bool ALIGNED>
__global__ void __launch_bounds__(TC_THREADS)
dm_grouped_tc(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ w, const float* __restrict__ scale,
              float* __restrict__ out, int M, int K, int N,
              long long scale_stride) {
  using Tile = TcTile<MT>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  {
    const long long z = blockIdx.z;
    x += z * M * K;
    w += z * K * N;
    out += z * M * N;
    scale += z * scale_stride;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.y * Tile::BM;
  const int KT = (K + TC_BK - 1) / TC_BK;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < KT) {
      unsigned char* st = tc_smem + s * Tile::STAGE;
      load_stage<MT, ALIGNED>(st, st + Tile::X_BYTES, x, w, M, K, N, m0, n0,
                              s * TC_BK, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<TC_STAGES - 2>();         // step kt has landed
    __syncthreads();                        // and step kt - 1 is consumed
    {
      const int nk = kt + TC_STAGES - 1;
      if (nk < KT) {
        unsigned char* st = tc_smem + (nk % TC_STAGES) * Tile::STAGE;
        load_stage<MT, ALIGNED>(st, st + Tile::X_BYTES, x, w, M, K, N, m0,
                                n0, nk * TC_BK, tid);
      }
      cp_async_commit();
    }
    const unsigned char* xs = tc_smem + (kt % TC_STAGES) * Tile::STAGE;
    const unsigned char* ws = xs + Tile::X_BYTES;
#pragma unroll
    for (int k16 = 0; k16 < TC_BK / 16; ++k16) {
      // B fragments of this warp's 4 n8 blocks: rows 4tg..4tg+3, columns
      // 4gr + j of the warp's 32
      uint32_t b[4][2];
      {
        uint32_t f[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t u =
              *reinterpret_cast<const uint32_t*>(
                  ws + w_off(16 * k16 + 4 * tg + r, 32 * warp + 4 * gr)) ^
              0x80808080u;
#pragma unroll
          for (int j = 0; j < 4; ++j) f[r][j] = level_f32_bits(u, j);
        }
        // bf16 of a small integer is the top half of its f32
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j][0] = __byte_perm(f[0][j], f[1][j], 0x7632);
          b[j][1] = __byte_perm(f[2][j], f[3][j], 0x7632);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              xs + x_off(16 * mt + gr + 8 * hh, 32 * k16 + 8 * tg));
          a[hh] = v.x;                      // x columns 4tg, 4tg + 1
          a[2 + hh] = v.y;                  // x columns 4tg + 2, 4tg + 3
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // element (j, c) of a row is output column 32 warp + 8 tg + 4 c + j
  const int ncol = n0 + 32 * warp + 8 * tg;
  float sc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (ALIGNED) {
      if (c % 4 == 0 && ncol < N) {
        const float4 s4 = *reinterpret_cast<const float4*>(scale + ncol + c);
        sc[c] = s4.x, sc[c + 1] = s4.y, sc[c + 2] = s4.z, sc[c + 3] = s4.w;
      }
    } else {
      sc[c] = ncol + c < N ? scale[ncol + c] : 0.f;
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 16 * mt + gr + 8 * hh;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * hh] * sc[j];
        v[4 + j] = acc[mt][j][2 * hh + 1] * sc[4 + j];
      }
      float* orow = out + (long long)m * N + ncol;
      if (ALIGNED) {
        if (ncol < N) {                     // N % 16 == 0: all 8 or none
          reinterpret_cast<float4*>(orow)[0] =
              make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(orow)[1] =
              make_float4(v[4], v[5], v[6], v[7]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (ncol + c < N) orow[c] = v[c];
      }
    }
}

template <int MT, bool ALIGNED>
int launch_tc(const void* x, const void* w, const void* scale,
              long long scale_stride, void* out, int E, int M, int K, int N,
              cudaStream_t st) {
  constexpr int bytes = TcTile<MT>::SMEM;
  // once per instance and process: the attribute is not a stream
  // operation, and a launch captured into a CUDA graph needs none
  static const cudaError_t attr =
      bytes > 48 * 1024
          ? cudaFuncSetAttribute(dm_grouped_tc<MT, ALIGNED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes)
          : cudaSuccess;
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TcTile<MT>::BM - 1) /
            TcTile<MT>::BM, E);
  dm_grouped_tc<MT, ALIGNED><<<grid, TC_THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N,
      scale_stride);
  return (int)cudaGetLastError();
}

template <bool ALIGNED>
int launch_tc_rows(const void* x, const void* w, const void* scale,
                   long long scale_stride, void* out, int E, int M, int K,
                   int N, cudaStream_t st) {
  if (M <= 32)
    return launch_tc<2, ALIGNED>(x, w, scale, scale_stride, out, E, M, K, N,
                                 st);
  return launch_tc<4, ALIGNED>(x, w, scale, scale_stride, out, E, M, K, N,
                               st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x (E, M, K), w (E, K, N) and
// out (E, M, N) are contiguous; scale holds E * scale_stride + N floats
// (scale_stride N for an (E, N) scale, 0 for a shared (N,) one).  bf16 x
// takes the tensor-core instance (16-byte copies where K % 8 == 0,
// N % 16 == 0 and every base is 16-byte aligned, element-wise loads
// otherwise), f32 x the f32 tile.  The launch goes on `stream` and does not
// synchronise.  Returns cudaGetLastError().
extern "C" int dequant_matmul_grouped_launch(const void* x, int x_is_bf16,
                                             const void* w,
                                             const void* scale,
                                             long long scale_stride,
                                             void* out, int E, int M, int K,
                                             int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (!x_is_bf16)
    return dm::launch_tiled<float, true>(x, w, scale, out, M, K, N, E,
                                         scale_stride, st);
  if (K % 8 == 0 && N % 16 == 0 && scale_stride % 4 == 0 && aligned16(x) &&
      aligned16(w) && aligned16(scale) && aligned16(out))
    return launch_tc_rows<true>(x, w, scale, scale_stride, out, E, M, K, N,
                                st);
  return launch_tc_rows<false>(x, w, scale, scale_stride, out, E, M, K, N,
                               st);
}
