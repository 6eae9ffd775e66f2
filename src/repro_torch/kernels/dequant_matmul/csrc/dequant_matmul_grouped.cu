// Grouped-expert int8-dequantize matmul for Hopper (sm_90a), one
// independent product per expert e:
//     out[e] (M, N) f32 = x[e] (M, K) f32|bf16 @ (w_q[e] (K, N) int8 * s)
// with s = scale[e] for an (E, N) scale, or the one (N,) scale all experts
// share (the stacked-MoE wire format), passed as an expert stride of 0.
//
// Replaces dequant_matmul_grouped_pallas / _dequant_matmul_grouped_kernel
// (src/repro/kernels/dequant_matmul/kernel.py).  Every sum is f32.
//
// Two tensor-core kernels: dm_grouped_tc (mma.sync), instantiated for each
// x type, and dm_grouped_wg (wgmma) for a f32 x above 32 rows.
//
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
//   A f32 x has 24 significant bits, so it is split in the kernel into
//   three bf16 pieces, hi + mid + lo == x exactly (bf16x3, dm_tc.cuh's
//   split3, as dequant_matmul.cu's f32 x): each piece times a level is
//   exact in f32, and three MMAs per k16 step on the same B fragment sum
//   x * q in f32; the scale again multiplies once in the epilogue.
//   What bounds it: bytes.  At E = 64, (K, N) = (2048, 1408), M = 32 it
//   reads 184.5 MB of levels, 8.4 MB of x and writes 11.5 MB of f32 output:
//   0.061 ms at 3.35 TB/s, against 11.8 GFLOP (0.012 ms at the 989 TFLOP/s
//   bf16 rate).  A f32 x reads 16.8 MB of x: 0.0635 ms, against 0.036 ms
//   of its three MMAs per product at that rate.
//   Design: one block per (expert, column strip of N, up to 64 rows of M),
//   so at the main path's M (32 at decode, 64 at prefill) each weight byte
//   is read from HBM once per call and converted once; the M tile is 32 or
//   64 rows (a template argument), padded in registers, not in memory.  A
//   block is WG groups of 4 warps, a group a 128-column strip, a warp 32
//   columns and all rows.  K advances 64 at a time through a cp.async ring
//   with one barrier per step.
//   - bf16 x: WG = 1, 4 stages (16 KB each at M = 64).
//   - f32 x: WG = 2 (256 columns, so each x tile is loaded and split once
//     per 256 columns), 2 stages (32 KB each at M = 64) and, after a step
//     lands, one pass of the block splits its x tile into three bf16 tiles
//     (hi, mid, lo; 24 KB) and a second barrier follows, so each value is
//     split once per block and not once per warp (88 KB and at most 128
//     registers: two blocks per SM; two stages and 256 columns measured
//     faster than three or four stages and 128 columns).
//   Per k16 step a warp loads 4 words of levels (rows 4tg..4tg+3, columns
//   4gr..4gr+3 of its strip), turns each byte into an f32 by the 2^23
//   exponent trick (exact), packs pairs into bf16 B fragments and runs
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate) on them, once per m16 tile
//   for a bf16 x and three times for a f32 x (the lo products of every m16
//   tile and n8 block, then the mid, then the hi ones, so no two MMAs on
//   one accumulator follow each other).  That needs a fixed permutation of
//   k and n inside the fragments: fragment k 2tg, 2tg+1, 2tg+8, 2tg+9 is
//   level row 4tg..4tg+3 (A takes x's columns in the same order, one 8-byte
//   load per row of a bf16 tile), and fragment column j * 8 + c is output
//   column 4c + j, so each lane ends up holding 8 consecutive output
//   columns and stores them as two float4.  Both shared tiles are
//   XOR-swizzled by 16-byte chunk so every load phase hits 32 banks.  Rows
//   of x and w whose length is not a multiple of 16 bytes, or operands off
//   a 16-byte boundary, take the element-wise loader of the same kernel
//   (ALIGNED = false): synchronous loads into the same ring.
//   Ragged M, N and K are masked in the kernel (zero-filled operands in the
//   K tail); no host padding.  The fragment code, the swizzles and the
//   stage loaders are dm_tc.cuh's, shared with dequant_matmul.cu's
//   tensor-core instance.
//   That is dm_grouped_tc: bf16 x at every M, f32 x up to 32 rows (the
//   decode step's capacity buffer).
// * f32 x above 32 rows (prefill's 64 rows), dm_grouped_wg: wgmma.  With
//   three MMAs per product, mma.sync's operand traffic through registers
//   and its issue slots bound the tile above; wgmma takes both operands
//   from shared memory and runs while the threads prepare the next step.
//   A block is one M tile of 64 rows (wgmma's M) and 256 columns: two
//   consumer warpgroups, each m64n128k16 on its 128 columns (64 f32
//   accumulators a thread), and two producer warpgroups, which load raw
//   steps by cp.async into a ring of 3 (x as f32, levels as int8,
//   dm_tc.cuh's loaders and layouts) and split x into its three bf16
//   pieces, each a 64 x 64 tile, K-major with the 128-byte swizzle, in one
//   of 2 operand buffers.  Each consumer warpgroup turns its 64 x 128
//   levels into bf16 (MN-major, two 128-byte-swizzled atoms of 64 columns;
//   wgmma reads it transposed) while the producers split x, then issues 12
//   wgmma (4 k16 steps x lo, mid, hi) and, once those of the step before
//   have run, frees that step's buffers.  mbarriers order it: raw step
//   landed, x pieces written, levels converted, products done.  209 KB of
//   shared memory: one block per SM.
//
// The capacity buffer stays dense: empty experts and padding rows are
// computed, as the reference computes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/ptx.cuh"
#include "dm_tc.cuh"

namespace {

using namespace ptx;
using dmtc::BK;
using dmtc::BN;

// A block is WG groups of 4 warps, each group BN = 128 columns (a warp 32
// of them).  The ring holds STAGES K steps of x (as loaded) and levels
// (WG tiles of BN columns); a f32 x also has one step's three bf16 pieces
// (PIECE bytes each, the bf16 layout).
template <typename XT, int MT>             // MT m16 tiles: 16 * MT rows
struct TcTile {
  static constexpr bool F32 = sizeof(XT) == 4;
  static constexpr int WG = F32 ? 2 : 1;
  static constexpr int THREADS = 128 * WG;
  static constexpr int BNB = BN * WG;       // a block's columns
  static constexpr int BM = 16 * MT;
  static constexpr int STAGES = F32 ? 2 : 4;
  static constexpr int X_BYTES = BM * BK * (int)sizeof(XT);  // a row: 64 x
  static constexpr int STAGE = X_BYTES + WG * dmtc::W_BYTES;
  static constexpr int PIECE = BM * BK * 2;
  static constexpr int SMEM = STAGES * STAGE + (F32 ? 3 * PIECE : 0);
  static constexpr int MIN_BLOCKS = F32 ? 2 : 1;  // per SM
};

// byte offset of 16-byte chunk `chunk` of 128-byte row `row` of a
// 128-byte-swizzled tile (chunk ^ row % 8), wgmma's SWIZZLE_128B
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// A stage's f32 x tile (x_off_f32 layout) as its three exact bf16 pieces
// hi, mid, lo (dm_tc.cuh's split3), each a BM x 64 tile: in the bf16
// layout (x_off) that load_a reads, or (SW128) K-major with wgmma's
// 128-byte swizzle.  Every value is split once per block.  Thread task: 8
// values of a row, one 16-byte chunk of each piece.
template <int BM, int THREADS, bool SW128>
__device__ __forceinline__ void split_x_tile(const unsigned char* xs,
                                             unsigned char* pcs, int tid) {
  constexpr int PIECE = BM * BK * 2;
  for (int t = tid; t < BM * BK / 8; t += THREADS) {
    const int r = t >> 3, c = t & 7;        // row r, k 8c..8c+7
    const float4 a = *reinterpret_cast<const float4*>(
        xs + dmtc::x_off_f32(r, 32 * c));
    const float4 b = *reinterpret_cast<const float4*>(
        xs + dmtc::x_off_f32(r, 32 * c + 16));
    uint4 hi, mid, lo;
    dmtc::split3(a.x, a.y, hi.x, mid.x, lo.x);
    dmtc::split3(a.z, a.w, hi.y, mid.y, lo.y);
    dmtc::split3(b.x, b.y, hi.z, mid.z, lo.z);
    dmtc::split3(b.z, b.w, hi.w, mid.w, lo.w);
    const int off = SW128 ? sw128(r, c) : dmtc::x_off(r, 16 * c);
    *reinterpret_cast<uint4*>(pcs + off) = hi;
    *reinterpret_cast<uint4*>(pcs + PIECE + off) = mid;
    *reinterpret_cast<uint4*>(pcs + 2 * PIECE + off) = lo;
  }
}

// Stage one K step: x rows m0.. (BM of them, K columns k0..k0+63) and level
// rows k0..k0+63 (columns n0..n0+BNB-1, one tile per BN), zero outside M,
// K and N.
template <typename XT, int MT, bool ALIGNED>
__device__ __forceinline__ void load_stage(
    unsigned char* xs, unsigned char* ws, const XT* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int N, int m0, int n0,
    int k0, int tid) {
  using Tile = TcTile<XT, MT>;
  dmtc::load_x_tile<XT, Tile::BM, Tile::THREADS, ALIGNED>(xs, x, M, K, K,
                                                         m0, k0, tid);
#pragma unroll
  for (int wg = 0; wg < Tile::WG; ++wg)
    dmtc::load_w_tile<Tile::THREADS, ALIGNED>(ws + wg * dmtc::W_BYTES, w, N,
                                              K, n0 + wg * BN, k0, tid);
}

template <typename XT, int MT, bool ALIGNED>
__global__ void __launch_bounds__(TcTile<XT, MT>::THREADS,
                                  TcTile<XT, MT>::MIN_BLOCKS)
dm_grouped_tc(const XT* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out, int M,
              int K, int N, long long scale_stride) {
  using Tile = TcTile<XT, MT>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  {
    const long long z = blockIdx.z;
    x += z * M * K;
    w += z * K * N;
    out += z * M * N;
    scale += z * scale_stride;
  }
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, wg = tid >> 7;   // strip of group wg
  const int gr = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * Tile::BNB;
  const int m0 = blockIdx.y * Tile::BM;
  const int KT = (K + BK - 1) / BK;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  constexpr int S_ = Tile::STAGES;
  unsigned char* pcs = tc_smem + S_ * Tile::STAGE;     // f32 x: the pieces
#pragma unroll
  for (int s = 0; s < S_ - 1; ++s) {
    if (s < KT) {
      unsigned char* st = tc_smem + s * Tile::STAGE;
      load_stage<XT, MT, ALIGNED>(st, st + Tile::X_BYTES, x, w, M, K, N, m0,
                                  n0, s * BK, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S_ - 2>();                // step kt has landed
    __syncthreads();                        // and step kt - 1 is consumed
    {
      const int nk = kt + S_ - 1;
      if (nk < KT) {
        unsigned char* st = tc_smem + (nk % S_) * Tile::STAGE;
        load_stage<XT, MT, ALIGNED>(st, st + Tile::X_BYTES, x, w, M, K, N,
                                    m0, n0, nk * BK, tid);
      }
      cp_async_commit();
    }
    const unsigned char* xs = tc_smem + (kt % S_) * Tile::STAGE;
    const unsigned char* ws = xs + Tile::X_BYTES + wg * dmtc::W_BYTES;
    if constexpr (Tile::F32) {
      split_x_tile<Tile::BM, Tile::THREADS, false>(xs, pcs, tid);
      __syncthreads();                      // the pieces are written
    }
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      uint32_t b[4][2];
      dmtc::load_b(ws, k16, warp, gr, tg, b);
      if constexpr (sizeof(XT) == 2) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          dmtc::load_a(xs, 16 * mt + gr, k16, tg, a);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
        }
      } else {
        // bf16x3: the lo, mid and hi products of every (m16 tile, n8
        // block) in that order, so that 4 MT independent MMAs separate
        // two on one accumulator
        uint32_t a3[3][MT][4];              // lo, mid, hi
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            dmtc::load_a(pcs + (2 - p) * Tile::PIECE, 16 * mt + gr, k16, tg,
                         a3[p][mt]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[mt][j], a3[p][mt], b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // element (j, c) of a row is output column BN wg + 32 warp + 8 tg + 4 c
  // + j
  const int ncol = n0 + BN * wg + 32 * warp + 8 * tg;
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

template <typename XT, int MT, bool ALIGNED>
int launch_tc(const XT* x, const void* w, const void* scale,
              long long scale_stride, void* out, int E, int M, int K, int N,
              cudaStream_t st) {
  using Tile = TcTile<XT, MT>;
  // once per instance and process: the attribute is not a stream
  // operation, and a launch captured into a CUDA graph needs none
  static const cudaError_t attr =
      Tile::SMEM > 48 * 1024
          ? cudaFuncSetAttribute(dm_grouped_tc<XT, MT, ALIGNED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Tile::SMEM)
          : cudaSuccess;
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + Tile::BNB - 1) / Tile::BNB, (M + Tile::BM - 1) / Tile::BM,
            E);
  dm_grouped_tc<XT, MT, ALIGNED><<<grid, Tile::THREADS, Tile::SMEM, st>>>(
      x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), M, K, N, scale_stride);
  return (int)cudaGetLastError();
}

template <typename XT, bool ALIGNED>
int launch_tc_rows(const XT* x, const void* w, const void* scale,
                   long long scale_stride, void* out, int E, int M, int K,
                   int N, cudaStream_t st) {
  if (M <= 32)
    return launch_tc<XT, 2, ALIGNED>(x, w, scale, scale_stride, out, E, M, K,
                                     N, st);
  return launch_tc<XT, 4, ALIGNED>(x, w, scale, scale_stride, out, E, M, K,
                                   N, st);
}

// ---- f32 x above 32 rows: wgmma ------------------------------------------
namespace wgk {
constexpr int CONSUMERS = 2;              // warpgroups, 128 columns each
constexpr int PRODUCERS = 2;              // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + PRODUCERS);
constexpr int PT = 128 * PRODUCERS;       // producer threads
constexpr int BNB = CONSUMERS * BN;       // a block's columns
constexpr int BM = 64;                    // wgmma's M
constexpr int XRAW = BM * BK * 4;         // a step's f32 x tile
constexpr int RAW = XRAW + CONSUMERS * dmtc::W_BYTES;
constexpr int RAWS = 3;                   // raw stages
constexpr int PIECE = BM * BK * 2;        // a bf16 x piece, K-major
constexpr int BT = BK * BN * 2;           // a group's bf16 levels, MN-major
constexpr int OPS = 3 * PIECE + CONSUMERS * BT;  // one buffer of operands
constexpr int NOPS = 2;                   // operand buffers
constexpr int SMEM = RAWS * RAW + NOPS * OPS + 256 + 1024;
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// d (64 x 128 f32) = A (64 x 16 bf16, K-major) * B (16 x 128 bf16,
// MN-major) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// A step's levels of one group (128 columns, raw tile wr) as bf16,
// MN-major in two 64-column atoms, swizzled (bt), by the group's thread ct
__device__ __forceinline__ void wg_levels(const unsigned char* wr,
                                          unsigned char* bt, int ct) {
#pragma unroll
  for (int i = 0; i < BK * 8 / 128; ++i) {
    // level row t / 8, columns 16 (t % 8) .. + 15
    const int t = ct + 128 * i, r = t >> 3, c = t & 7;
    const uint4 q = *reinterpret_cast<const uint4*>(wr +
                                                    dmtc::w_off(r, 16 * c));
    const uint32_t u[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                           q.z ^ 0x80808080u, q.w ^ 0x80808080u};
    uint32_t pk[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pk[2 * j] = __byte_perm(dmtc::level_f32_bits(u[j], 0),
                              dmtc::level_f32_bits(u[j], 1), 0x7632);
      pk[2 * j + 1] = __byte_perm(dmtc::level_f32_bits(u[j], 2),
                                  dmtc::level_f32_bits(u[j], 3), 0x7632);
    }
    unsigned char* at = bt + (c >> 2) * 8192;
    *reinterpret_cast<uint4*>(at + sw128(r, 2 * (c & 3))) =
        make_uint4(pk[0], pk[1], pk[2], pk[3]);
    *reinterpret_cast<uint4*>(at + sw128(r, 2 * (c & 3) + 1)) =
        make_uint4(pk[4], pk[5], pk[6], pk[7]);
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(wgk::THREADS, 1)
dm_grouped_wg(const float* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out,
              int M, int K, int N, long long scale_stride) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base =
      wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* ops = base;                        // [NOPS][OPS]
  unsigned char* raw = base + wgk::NOPS * wgk::OPS; // [RAWS][RAW]
  // mbarriers: full[s], operands s have x's pieces; empty[s], the
  // products on operands s have run; rawready[s], raw stage s has landed;
  // rawfree[s], the consumers have converted raw stage s's levels
  const uint32_t full = smem_u32(raw + wgk::RAWS * wgk::RAW);  // [NOPS]
  const uint32_t empty = full + 8 * wgk::NOPS;                 // [NOPS]
  const uint32_t rawready = empty + 8 * wgk::NOPS;             // [RAWS]
  const uint32_t rawfree = rawready + 8 * wgk::RAWS;           // [RAWS]
  {
    const long long z = blockIdx.z;
    x += z * M * K;
    w += z * K * N;
    out += z * M * N;
    scale += z * scale_stride;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wq = warp & 3;
  const int n0 = blockIdx.x * wgk::BNB, m0 = blockIdx.y * wgk::BM;
  const int KT = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int i = 0; i < wgk::NOPS; ++i) {
      mbar_init(full + 8 * i, wgk::PT);
      mbar_init(empty + 8 * i, 128 * wgk::CONSUMERS);
    }
    for (int i = 0; i < wgk::RAWS; ++i) {
      mbar_init(rawready + 8 * i, wgk::PT);
      mbar_init(rawfree + 8 * i, 128 * wgk::CONSUMERS);
    }
  }
  __syncthreads();

  if (grp >= wgk::CONSUMERS) {
    // producer: raw steps by cp.async into a ring of RAWS, then operands
    const int pt = tid - 128 * wgk::CONSUMERS;
    auto load_raw = [&](unsigned char* st, int k0) {
      dmtc::load_x_tile<float, wgk::BM, wgk::PT, ALIGNED>(st, x, M, K, K,
                                                         m0, k0, pt);
#pragma unroll
      for (int g = 0; g < wgk::CONSUMERS; ++g)
        dmtc::load_w_tile<wgk::PT, ALIGNED>(
            st + wgk::XRAW + g * dmtc::W_BYTES, w, N, K, n0 + g * BN, k0,
            pt);
    };
#pragma unroll
    for (int s = 0; s < wgk::RAWS - 1; ++s) {
      if (s < KT) load_raw(raw + s * wgk::RAW, s * BK);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<wgk::RAWS - 2>();       // raw step kt has landed
      mbar_arrive(rawready + 8 * (kt % wgk::RAWS));
      asm volatile("bar.sync 1, %0;\n" ::"n"(wgk::PT) : "memory");
      {
        const int nk = kt + wgk::RAWS - 1;  // into the stage of kt - 1
        if (nk < KT) {
          if (kt > 0)
            mbar_wait(rawfree + 8 * ((kt - 1) % wgk::RAWS),
                      ((kt - 1) / wgk::RAWS) & 1);
          load_raw(raw + (nk % wgk::RAWS) * wgk::RAW, nk * BK);
        }
        cp_async_commit();
      }
      const int sb = kt % wgk::NOPS;
      if (kt >= wgk::NOPS)
        mbar_wait(empty + 8 * sb, (kt / wgk::NOPS - 1) & 1);
      split_x_tile<wgk::BM, wgk::PT, true>(
          raw + (kt % wgk::RAWS) * wgk::RAW, ops + sb * wgk::OPS, pt);
      fence_async_smem();
      mbar_arrive(full + 8 * sb);
    }
    cp_async_wait<0>();
    return;
  }

  // consumers: warpgroup grp, the group's 128 columns
  // no other instruction writes the accumulators (the first product
  // ignores them), so the wgmma of a step are not serialized
  float d[64];
  const int ct = tid - 128 * grp;
  for (int kt = 0; kt < KT; ++kt) {
    const int sb = kt % wgk::NOPS, sr = kt % wgk::RAWS;
    mbar_wait(rawready + 8 * sr, (kt / wgk::RAWS) & 1);
    // this group's levels, into operands the products of kt - 2 are done
    // with (waited for at the end of step kt - 1), while the producers
    // split x
    unsigned char* bt = ops + sb * wgk::OPS + 3 * wgk::PIECE + grp * wgk::BT;
    wg_levels(raw + sr * wgk::RAW + wgk::XRAW + grp * dmtc::W_BYTES, bt, ct);
    mbar_arrive(rawfree + 8 * sr);
    fence_async_smem();
    mbar_wait(full + 8 * sb, (kt / wgk::NOPS) & 1);
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + grp) : "memory");
    const uint32_t a0 = smem_u32(ops + sb * wgk::OPS);
    const uint32_t b0 = smem_u32(bt);
    wg_fence();
    pin(d);
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16)
#pragma unroll
      for (int p = 2; p >= 0; --p)          // lo, mid, hi
        wgmma_128(d, wg_desc(a0 + p * wgk::PIECE + 32 * k16, 16, 1024),
                  wg_desc(b0 + 2048 * k16, 8192, 1024),
                  kt > 0 || k16 > 0 || p < 2);
    wg_commit();
    wg_wait<1>();                           // step kt - 1's products ran
    pin(d);
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % wgk::NOPS));
  }
  wg_wait<0>();
  pin(d);

  // d[4 j + c]: row 16 wq + gr + 8 (c >> 1), column 8 j + 2 tg + (c & 1)
  // of the group's 128
  const int gr = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + grp * BN + 8 * j + 2 * tg;
    const float s0 = n < N ? scale[n] : 0.f;
    const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 16 * wq + gr + 8 * hh;
      if (m >= M) continue;
      float* o = out + (long long)m * N + n;
      const float v0 = d[4 * j + 2 * hh] * s0, v1 = d[4 * j + 2 * hh + 1] * s1;
      if (ALIGNED) {
        if (n < N) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (n < N) o[0] = v0;
        if (n + 1 < N) o[1] = v1;
      }
    }
  }
}

template <bool ALIGNED>
int launch_wg(const float* x, const void* w, const void* scale,
              long long scale_stride, void* out, int E, int M, int K, int N,
              cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dm_grouped_wg<ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wgk::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + wgk::BNB - 1) / wgk::BNB, (M + wgk::BM - 1) / wgk::BM, E);
  dm_grouped_wg<ALIGNED><<<grid, wgk::THREADS, wgk::SMEM, st>>>(
      x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), M, K, N, scale_stride);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte copies where x's rows (K values) and w's (N levels) are whole
// chunks, the scale's expert stride keeps 16-byte alignment and every base
// is on a 16-byte boundary; element-wise loads otherwise
template <typename XT>
int launch(const void* xv, const void* w, const void* scale,
           long long scale_stride, void* out, int E, int M, int K, int N,
           cudaStream_t st) {
  const XT* x = static_cast<const XT*>(xv);
  const bool aligned = K % (16 / (int)sizeof(XT)) == 0 && N % 16 == 0 &&
                       scale_stride % 4 == 0 && aligned16(x) &&
                       aligned16(w) && aligned16(scale) && aligned16(out);
  if constexpr (sizeof(XT) == 4) {
    if (M > 32)       // prefill's 64 rows and more: wgmma
      return aligned ? launch_wg<true>(x, w, scale, scale_stride, out, E, M,
                                       K, N, st)
                     : launch_wg<false>(x, w, scale, scale_stride, out, E,
                                        M, K, N, st);
    return aligned ? launch_tc<XT, 2, true>(x, w, scale, scale_stride, out, E,
                                            M, K, N, st)
                   : launch_tc<XT, 2, false>(x, w, scale, scale_stride, out,
                                             E, M, K, N, st);
  } else {
    return aligned ? launch_tc_rows<XT, true>(x, w, scale, scale_stride, out,
                                              E, M, K, N, st)
                   : launch_tc_rows<XT, false>(x, w, scale, scale_stride, out,
                                               E, M, K, N, st);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x (E, M, K), w (E, K, N) and
// out (E, M, N) are contiguous; scale holds E * scale_stride + N floats
// (scale_stride N for an (E, N) scale, 0 for a shared (N,) one).  x_is_bf16
// selects x's type: bf16 x takes dm_grouped_tc, f32 x dm_grouped_tc up to
// 32 rows and dm_grouped_wg above.  The launch goes on `stream` and does
// not synchronise.  Returns cudaGetLastError().
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
    return launch<__nv_bfloat16>(x, w, scale, scale_stride, out, E, M, K, N,
                                 st);
  return launch<float>(x, w, scale, scale_stride, out, E, M, K, N, st);
}
