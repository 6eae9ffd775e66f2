// Tensor-core fragment code of the int8-dequantize matmuls (sm_90a), shared
// by dequant_matmul.cu (its tensor-core instance, M > 8) and
// dequant_matmul_grouped.cu (both x types).  Both compute
//     out = s[n] * sum_k x[m, k] * q[k, n]
// with mma.sync.m16n8k16 (bf16 in, f32 accumulate) over a ring of stages in
// shared memory, each stage BK = 64 rows of K: an x tile (rows of the
// block's M tile, 64 values of K each) and a level tile (64 rows, the
// block's BN = 128 columns).  Each warp owns a 32-column strip of the level
// tile.
//
// * int8 -> bf16 is exact: byte ^ 0x80 placed under the exponent of 2^23
//   is the f32 2^23 + 128 + level; subtracting 2^23 + 128 leaves the level,
//   and the bf16 of a small integer is the top half of its f32.
// * Fragment permutation: fragment k 2tg, 2tg+1, 2tg+8, 2tg+9 is level row
//   4tg..4tg+3 of the k16 step (A takes x's columns in the same order), and
//   fragment column j * 8 + c is strip column 4c + j.  So a lane loads one
//   4-byte word per level row (4 columns) and one 8-byte word of bf16 x (or
//   16 bytes of f32 x) per A row, and after the k loop holds 8 consecutive
//   output columns, 32 wn + 8 tg .. + 7, of each of its rows.
// * Both tiles are XOR-swizzled by 16-byte chunk so that every load phase
//   hits 32 banks (the offsets below say how).
// * Loaders: ALIGNED = 16-byte cp.async copies (rows a multiple of 16 bytes
//   long, bases on a 16-byte boundary, kend on a chunk boundary); otherwise
//   synchronous element-wise loads into the same layout.  Everything at or
//   past M, N or kend is zero, so ragged edges need no host padding.
// * f32 x (bf16x3): x = hi + mid + lo exactly, each a bf16 (hi = rn(x),
//   mid = rn(x - hi), lo = x - hi - mid; exact for |x| >= 2^-110 and below
//   bf16's largest finite value), so each piece times a level is exact in
//   f32 and three MMAs on one B fragment sum x * q in f32.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "../../common/ptx.cuh"

namespace dmtc {

constexpr int BN = 128;                     // output columns per block
constexpr int BK = 64;                      // K per ring stage
constexpr int W_BYTES = BK * BN;            // a stage's level tile

// bf16 x: row m is 128 B (64 values), chunk ch ^ 2 (m & 3): a half-warp's
// 8-byte A loads (rows gr, chunks 2 k16 + tg / 2) land in 8 distinct chunks
__device__ __forceinline__ int x_off(int m, int byte) {
  return m * 128 + ((((byte >> 4) ^ ((m & 3) << 1))) << 4) + (byte & 15);
}
// f32 x: row m is 256 B, chunk ch ^ 4 (m & 1): a quarter-warp's 16-byte A
// loads (rows gr in {2p, 2p + 1}, chunks 4 k16 + tg) land in 8 distinct
// 16-byte bank groups
__device__ __forceinline__ int x_off_f32(int m, int byte) {
  return m * 256 + ((((byte >> 4) ^ ((m & 1) << 2))) << 4) + (byte & 15);
}
// levels: row k is 128 B (the block's columns), chunk ch ^ 2 ((k >> 2) & 3):
// a warp's word loads (rows 4 tg + r, chunks 2 wn + gr / 4) land in 8
// distinct chunks
__device__ __forceinline__ int w_off(int k, int byte) {
  return k * 128 + ((((byte >> 4) ^ (((k >> 2) & 3) << 1))) << 4) +
         (byte & 15);
}

template <typename XT>
__device__ __forceinline__ int xs_off(int m, int byte) {
  return sizeof(XT) == 2 ? x_off(m, byte) : x_off_f32(m, byte);
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}

// Level rows k0..k0+63 (columns n0..n0+127, row stride N) into a stage.
template <int THREADS, bool ALIGNED>
__device__ __forceinline__ void load_w_tile(unsigned char* ws,
                                            const int8_t* __restrict__ w,
                                            int N, int kend, int n0, int k0,
                                            int tid) {
  if (ALIGNED) {                 // N % 16 == 0, aligned base
    for (int c = tid; c < BK * 8; c += THREADS) {
      const int r = c >> 3, n = n0 + (c & 7) * 16, kk = k0 + r;
      const bool ok = kk < kend && n < N;
      ptx::cp_async16(ptx::smem_u32(ws + w_off(r, (c & 7) * 16)),
                      w + (ok ? (long long)kk * N + n : 0), ok);
    }
  } else {
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, nc = e % BN, kk = k0 + r, n = n0 + nc;
      ws[w_off(r, nc)] = (kk < kend && n < N)
                             ? static_cast<unsigned char>(
                                   w[(long long)kk * N + n])
                             : 0;
    }
  }
}

// x rows m0..m0+BM-1 (K columns k0..k0+63, row stride ldx) into a stage.
template <typename XT, int BM, int THREADS, bool ALIGNED>
__device__ __forceinline__ void load_x_tile(unsigned char* xs,
                                            const XT* __restrict__ x, int M,
                                            int ldx, int kend, int m0,
                                            int k0, int tid) {
  constexpr int EPC = 16 / sizeof(XT);      // values per 16-byte chunk
  constexpr int CPR = BK / EPC;             // chunks per row
  if (ALIGNED) {
    for (int c = tid; c < BM * CPR; c += THREADS) {
      const int r = c / CPR, ch = c % CPR, kk = k0 + ch * EPC, m = m0 + r;
      const bool ok = m < M && kk < kend;
      ptx::cp_async16(ptx::smem_u32(xs + xs_off<XT>(r, ch * 16)),
                      x + (ok ? (long long)m * ldx + kk : 0), ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kc = e % BK, m = m0 + r, kk = k0 + kc;
      const XT v = (m < M && kk < kend) ? x[(long long)m * ldx + kk]
                                        : zero_of(XT());
      *reinterpret_cast<XT*>(xs + xs_off<XT>(r, kc * (int)sizeof(XT))) = v;
    }
  }
}

// byte i of u (an int8 level xor 0x80, i.e. level + 128) as an exact f32
__device__ __forceinline__ uint32_t level_f32_bits(uint32_t u, int i) {
  const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i));
  return __float_as_uint(f - 8388736.f);    // 2^23 + 128
}

// B fragments of the 4 n8 blocks of a 32-column strip from its level words
// u[r] (row 4tg + r of the k16 step, strip columns 4gr..4gr+3, each byte
// xor 0x80): fragment column gr of n8 block j is strip column 4gr + j
__device__ __forceinline__ void b_frags(const uint32_t (&u)[4],
                                        uint32_t (&b)[4][2]) {
  uint32_t f[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[r][j] = level_f32_bits(u[r], j);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j][0] = __byte_perm(f[0][j], f[1][j], 0x7632);
    b[j][1] = __byte_perm(f[2][j], f[3][j], 0x7632);
  }
}

// B fragments of one k16 step for the 4 n8 blocks of strip wn: rows
// 4tg..4tg+3, strip columns 4gr + j
__device__ __forceinline__ void load_b(const unsigned char* ws, int k16,
                                       int wn, int gr, int tg,
                                       uint32_t (&b)[4][2]) {
  uint32_t u[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    u[r] = *reinterpret_cast<const uint32_t*>(
               ws + w_off(16 * k16 + 4 * tg + r, 32 * wn + 4 * gr)) ^
           0x80808080u;
  b_frags(u, b);
}

// A fragment of a bf16 x tile: rows row and row + 8 of the stage
__device__ __forceinline__ void load_a(const unsigned char* xs, int row,
                                       int k16, int tg, uint32_t (&a)[4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        xs + x_off(row + 8 * hh, 32 * k16 + 8 * tg));
    a[hh] = v.x;                            // x columns 4tg, 4tg + 1
    a[2 + hh] = v.y;                        // x columns 4tg + 2, 4tg + 3
  }
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (f0, f1) = (hi + mid + lo) pairwise, each piece a packed bf16 pair
__device__ __forceinline__ void split3(float f0, float f1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = f0 - hf.x, r1 = f1 - hf.y;        // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bf2_bits(h);
  mid = bf2_bits(m);
  lo = bf2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));  // exact
}

// A fragments (hi, mid, lo) of a f32 x tile: rows row and row + 8
__device__ __forceinline__ void load_a_x3(const unsigned char* xs, int row,
                                          int k16, int tg,
                                          uint32_t (&hi)[4],
                                          uint32_t (&mid)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float4 v = *reinterpret_cast<const float4*>(
        xs + x_off_f32(row + 8 * hh, 64 * k16 + 16 * tg));
    split3(v.x, v.y, hi[hh], mid[hh], lo[hh]);
    split3(v.z, v.w, hi[2 + hh], mid[2 + hh], lo[2 + hh]);
  }
}

}  // namespace dmtc
