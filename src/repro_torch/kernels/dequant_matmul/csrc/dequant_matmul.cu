// Fused int8-dequantize matmul for Hopper (sm_90a):
//     out (M, N) f32 = x (M, K) f32|bf16 @ (w_q (K, N) int8 * scale (N,) f32)
//
// Replaces dequant_matmul_pallas / _dequant_matmul_kernel
// (src/repro/kernels/dequant_matmul/kernel.py).  Every sum is f32.  Two
// instances, chosen by M inside the launcher; both take either x type.
//
// * M > 8 (prefill, continuous batching of more than 8 slots, the MoE
//   router at prefill): tensor cores, dm_tc.
//   What bounds it: operations.  One llama3-8b prefill (M = 512) makes 224
//   calls, 7.15 TFLOP: 7.2 ms at the 989 TFLOP/s bf16 rate.
//   Why it computes the reference's function.  The reference multiplies
//   the weight by the per-column scale and sums x * (q * s) in f32.  The
//   scale factors out of the sum over K, so out = s[n] * sum_k x * q, with
//   s applied once in the epilogue; what remains is to sum x * q in f32.
//   - bf16 x: a bf16 has 8 significant bits and an int8 level is exactly a
//     bf16, so each product x * q is exact in f32 (at most 16 bits), and
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate) sums exact products in
//     f32.
//   - f32 x (bf16x3): split x exactly into three bf16 pieces in the kernel,
//     hi = rn(x), mid = rn(x - hi), lo = x - hi - mid; hi + mid + lo == x
//     (for |x| >= 2^-110; below, lo loses bits under 2^-133), each piece
//     times a level is exact in f32, and three MMAs per k step on the same
//     B fragment sum x * q in f32.  The reference's function with f32 sums
//     in another order, at a third of the bf16 rate: the bound counts f32 x
//     at BF16_FLOPS / 3.
//   Design: a block of 4 warps, K in steps of 64 through a cp.async ring
//   (bf16 x: 4 stages; f32 x: 3 stages of the 128-row tile, 4 of the
//   32-row one), one barrier per step.  Tiles (ops.schedule picks one):
//   - 128 x 128 (dm_tc<XT, 8, 1>): each warp all 128 rows (8 m16 tiles) of
//     one 32-column strip, so each level byte is converted once per block;
//     bf16 x: 24 KB a stage, two blocks per SM.  It measured faster than
//     2 x 2 warps of 64 x 64, which convert every level twice.
//   - 32 x 128 (dm_tc<XT, 1, 2>): 2 x 2 warps of 16 rows x 64 columns, for
//     few rows and for shapes whose 128-row tiles would leave most SMs
//     idle (4096 x 1024 at M = 512).
//   - 32 x 128 at N <= 64 (dm_tc<XT, 1, 2, NARROW>, the MoE router): both
//     warps of a row pair take columns 0..63, each half of every stage's
//     k16 steps, and add their sums in shared memory (warp 0's + warp 1's).
//   The fragment code is dm_tc.cuh's (shared with dequant_matmul_grouped.cu):
//   one 4-byte level load per row, int8 -> bf16 by the 2^23 exponent trick
//   in registers, XOR-swizzled tiles, 16-byte copies where the shapes
//   allow and element-wise loads otherwise; the scales are loaded while the
//   ring fills.  Shapes whose tiles do not fill the card split K over grid
//   z (below).
//
// * M <= 8 (decode): stream the weight bytes, dm_decode.
//   What bounds it: bytes.  A full-width llama3-8b step reads 7.51 GB of
//   levels and scales in 225 calls: 2.24 ms at 3.35 TB/s.
//   Design: a block of 8 warps per (128-column strip of N, K chunk).  Each
//   lane loads 16 contiguous bytes of a level row, 8 lanes a full 128-byte
//   line, so a warp reads 4 rows and the block 32 rows per load round.  A
//   thread loads its rows in groups of 4 rounds and issues the next group
//   before it uses the last (4 to 8 loads in flight), with no barrier in
//   the K loop; the first two groups go out before x is staged.  At M <= 4
//   two blocks share an SM (128 registers).  The block's x chunk is staged
//   once in shared memory as f32 ([m][k]: the 4 rows a warp reads are 4
//   broadcasts; 16-byte loads where x's rows allow).  The accumulator is
//   M x 16 f32 (M is a template argument).  f32 x keeps the reference's
//   order, x * (q * s) by FMA, the strip's scales read from shared memory
//   (registers would spill at M = 4): bytes bound this path, so the
//   multiplies are free; bf16 x sums exact products x * q and scales the
//   block's sum.  The 32 partial sums per output (4 row groups x 8 warps)
//   are reduced by shuffles, then through shared memory in a fixed order.
//
// Split K, deterministic.  The caller gives kc, the K rows per block; grid
// z (tensor cores) or y (decode) runs S = ceil(K / kc) <= 8 chunks, and the
// S blocks of an output tile form one thread-block cluster.  Each block
// leaves its partial sums in its shared memory; after a cluster barrier,
// block r adds a share of the tile over blocks 0..S-1 of the cluster in
// that order (distributed shared memory), so two calls give identical
// bits, no workspace or counter is needed, and the launch is capturable
// in a CUDA graph.  Offsets are 64-bit: the head's K * N is 525 M.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/ptx.cuh"
#include "dm_tc.cuh"

namespace {

using namespace ptx;
using dmtc::BK;
using dmtc::BN;

constexpr int MAX_SPLITS = 8;               // a portable cluster's blocks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- tensor-core instance: M > 8 ----------------------------------------
constexpr int TC_THREADS = 128;             // 4 warps

// Each warp takes MT m16 tiles (16 MT rows) of NS of dm_tc.cuh's 32-column
// strips: 4 / NS warps across the 128 columns, NS down the rows, so the
// output tile is 16 MT NS rows x 128 columns
template <typename XT, int MT, int NS>
struct TcCfg {
  static constexpr int WN = 4 / NS;
  static constexpr int BM = 16 * MT * NS;
  static constexpr int STAGES = sizeof(XT) == 2 || BM <= 32 ? 4 : 3;
  static constexpr int X_BYTES = BM * BK * (int)sizeof(XT);
  static constexpr int STAGE = X_BYTES + dmtc::W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
};

template <typename XT, int MT, int NS, bool ALIGNED>
__device__ __forceinline__ void tc_stage(unsigned char* st,
                                         const XT* __restrict__ x,
                                         const int8_t* __restrict__ w, int M,
                                         int K, int N, int kend, int m0,
                                         int n0, int k0, int tid) {
  using C = TcCfg<XT, MT, NS>;
  dmtc::load_x_tile<XT, C::BM, TC_THREADS, ALIGNED>(st, x, M, K, kend, m0,
                                                    k0, tid);
  dmtc::load_w_tile<TC_THREADS, ALIGNED>(st + C::X_BYTES, w, N, kend, n0, k0,
                                         tid);
}

template <typename XT, int MT, int NS, bool NARROW, bool ALIGNED>
__global__ void __launch_bounds__(TC_THREADS, 1)
dm_tc(const XT* __restrict__ x, const int8_t* __restrict__ w,
      const float* __restrict__ scale, float* __restrict__ out, int M, int K,
      int N, int kc) {
  using C = TcCfg<XT, MT, NS>;
  static_assert(!NARROW || NS == 2, "the narrow tile pairs warps by NS");
  constexpr int S_ = C::STAGES;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int gr = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  const int KT = (kend - kbeg + BK - 1) / BK;

  // acc[mt][4 h + j]: m16 tile mt, n8 block j of the warp's strip h
  float acc[MT][4 * NS][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < S_ - 1; ++s) {
    if (s < KT)
      tc_stage<XT, MT, NS, ALIGNED>(tc_smem + s * C::STAGE, x, w, M, K, N, kend,
                                m0, n0, kbeg + s * BK, tid);
    cp_async_commit();
  }

  // the scales of the warp's columns, loaded while the ring fills
  float sc[NS][8];
#pragma unroll
  for (int h = 0; h < NS; ++h) {
    const int ncol = n0 + 32 * (NS * wn + h) + 8 * tg;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (ALIGNED) {
        if (c % 4 == 0) {
          const float4 s4 = ncol < N ? __ldg(reinterpret_cast<const float4*>(
                                           scale + ncol + c))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          sc[h][c] = s4.x, sc[h][c + 1] = s4.y, sc[h][c + 2] = s4.z;
          sc[h][c + 3] = s4.w;
        }
      } else {
        sc[h][c] = ncol + c < N ? scale[ncol + c] : 0.f;
      }
    }
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S_ - 2>();                // step kt has landed
    __syncthreads();                        // and step kt - 1 is consumed
    {
      const int nk = kt + S_ - 1;
      if (nk < KT)
        tc_stage<XT, MT, NS, ALIGNED>(tc_smem + (nk % S_) * C::STAGE, x, w, M, K,
                                  N, kend, m0, n0, kbeg + nk * BK, tid);
      cp_async_commit();
    }
    const unsigned char* xs = tc_smem + (kt % S_) * C::STAGE;
    const unsigned char* ws = xs + C::X_BYTES;
#pragma unroll
    for (int kk = 0; kk < (NARROW ? 2 : 4); ++kk) {
      const int k16 = NARROW ? 2 * wn + kk : kk;
      uint32_t b[NS][4][2];                 // the warp's strips
#pragma unroll
      for (int h = 0; h < NS; ++h)
        dmtc::load_b(ws, k16, (NARROW ? 0 : NS * wn) + h, gr, tg, b[h]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = 16 * MT * wm + 16 * mt + gr;
        if constexpr (sizeof(XT) == 2) {
          uint32_t a[4];
          dmtc::load_a(xs, row, k16, tg, a);
#pragma unroll
          for (int j = 0; j < 4 * NS; ++j)
            mma_bf16(acc[mt][j], a, b[j >> 2][j & 3][0],
                     b[j >> 2][j & 3][1]);
        } else {
          uint32_t hi[4], mid[4], lo[4];
          dmtc::load_a_x3(xs, row, k16, tg, hi, mid, lo);
#pragma unroll
          for (int j = 0; j < 4 * NS; ++j) {
            const uint32_t b0 = b[j >> 2][j & 3][0], b1 = b[j >> 2][j & 3][1];
            mma_bf16(acc[mt][j], lo, b0, b1);
            mma_bf16(acc[mt][j], mid, b0, b1);
            mma_bf16(acc[mt][j], hi, b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (NARROW) {       // warp (wm, 1)'s sums join warp (wm, 0)'s
    float* red = reinterpret_cast<float*>(tc_smem);
    __syncthreads();                        // the ring is free
    if (wn == 1) {
#pragma unroll
      for (int j = 0; j < 4 * NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[((j * 4 + c) * 2 + wm) * 32 + lane] = acc[0][j][c];
    }
    __syncthreads();
    if (wn == 0) {
#pragma unroll
      for (int j = 0; j < 4 * NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[0][j][c] += red[((j * 4 + c) * 2 + wm) * 32 + lane];
    }
  }

  // element (j, c) of a row of strip h is output column
  // 32 (NS wn + h) + 8 tg + 4 c + j
  const int splits = gridDim.z;
  auto put = [&](float* dst, int ncol, long long m, const float (&v)[8]) {
    float* row = dst + m * N + ncol;
    if (ALIGNED) {
      if (ncol < N) {                       // N % 16 == 0: all 8 or none
        reinterpret_cast<float4*>(row)[0] = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        reinterpret_cast<float4*>(row)[1] = make_float4(v[4], v[5], v[6],
                                                        v[7]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (ncol + c < N) row[c] = v[c];
    }
  };
  auto vals = [&](int mt, int h, int hh, float (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[mt][4 * h + j][2 * hh];
      v[4 + j] = acc[mt][4 * h + j][2 * hh + 1];
    }
  };
  if (splits > 1) {
    // The cluster (the tile's S blocks along z) sums the tile in shared
    // memory: each block stores its sums, and after the barrier block r
    // adds every (S r + i)-th group of 4 elements over blocks 0..S-1 in
    // that order, so the bits do not depend on which block ran first.
    float* red = reinterpret_cast<float*>(tc_smem);    // C::BM x BN
    __syncthreads();                // the ring and the narrow join are done
#pragma unroll
    for (int h = 0; h < NS; ++h)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v[8];
          vals(mt, h, hh, v);
          float4* dst = reinterpret_cast<float4*>(
              red + (16 * MT * wm + 16 * mt + gr + 8 * hh) * BN +
              32 * (NS * wn + h) + 8 * tg);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    cluster_sync();
    const uint32_t base = smem_u32(red);
    const int rank = (int)cluster_rank();
    for (int e = rank * TC_THREADS + tid; e < C::BM * BN / 4;
         e += splits * TC_THREADS) {
      const int row = e / (BN / 4), col = (e % (BN / 4)) * 4;
      const int m = m0 + row, n = n0 + col;
      if (m >= M || n >= N) continue;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < splits; ++r) {
        const float4 q = ld_cluster4(cluster_map(base + e * 16, r));
        t.x += q.x, t.y += q.y, t.z += q.z, t.w += q.w;
      }
      float* o = out + (long long)m * N + n;
      if (ALIGNED) {                        // N % 16 == 0: all 4 or none
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + n));
        *reinterpret_cast<float4*>(o) =
            make_float4(t.x * s4.x, t.y * s4.y, t.z * s4.z, t.w * s4.w);
      } else {
        const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) o[c] = tv[c] * scale[n + c];
      }
    }
    cluster_sync();                 // the other blocks have read our sums
    return;
  }

#pragma unroll
  for (int h = 0; h < NS; ++h) {
    const int ncol = n0 + 32 * (NS * wn + h) + 8 * tg;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + 16 * MT * wm + 16 * mt + gr + 8 * hh;
        if (m >= M) continue;
        float v[8];
        vals(mt, h, hh, v);
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] *= sc[h][c];
        put(out, ncol, m, v);
      }
  }
}

// ---- decode instance: M <= 8 ---------------------------------------------
constexpr int DC_THREADS = 256;
constexpr int DC_WARPS = DC_THREADS / 32;
constexpr int DC_ROWS = DC_THREADS / 8;     // level rows per load round
constexpr int DC_U = 4;                     // load rounds per group
constexpr int DC_X_BYTES = 64 * 1024;       // the most x a block stages

__device__ __forceinline__ int4 ld_stream16(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The end of a decode block: the per-warp sums red[w][m][col] (written
// before a barrier) summed over the warps in order and scaled if
// scale_after, to out; with more than one K chunk, to tot (MR x BN after
// red), and the cluster (the strip's S blocks along y) adds tot over
// blocks 0..S-1 in that order, block r taking every S-th output from r.
template <int MR>
__device__ __forceinline__ void decode_finish(float* red, int N,
                                              const float* __restrict__ scale,
                                              bool scale_after,
                                              float* __restrict__ out) {
  constexpr int OUTS = (MR * BN + DC_THREADS - 1) / DC_THREADS;
  const int tid = threadIdx.x, splits = gridDim.y;
  float* tot = red + DC_WARPS * MR * BN;
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int o = tid + i * DC_THREADS;
    if (o >= MR * BN) continue;
    const int m = o / BN, col = o % BN;
    const long long n = (long long)blockIdx.x * BN + col;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < DC_WARPS; ++wi) v += red[(wi * MR + m) * BN + col];
    if (scale_after && n < N) v *= scale[n];
    if (splits > 1)
      tot[o] = v;
    else if (n < N)
      out[(long long)m * N + n] = v;
  }
  if (splits == 1) return;
  cluster_sync();
  const uint32_t base = smem_u32(tot);
  for (int o = (int)cluster_rank() * DC_THREADS + tid; o < MR * BN;
       o += splits * DC_THREADS) {
    const int m = o / BN, col = o % BN;
    const long long n = (long long)blockIdx.x * BN + col;
    if (n >= N) continue;
    float t = 0.f;
    for (int r = 0; r < splits; ++r) t += ld_cluster(cluster_map(base + o * 4, r));
    out[(long long)m * N + n] = t;
  }
  cluster_sync();                   // the other blocks have read our sums
}

// M <= 4: at most 128 registers, so that two blocks share an SM
template <typename XT, int MR>
__global__ void __launch_bounds__(DC_THREADS, MR <= 4 ? 2 : 1)
dm_decode(const XT* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scale, float* __restrict__ out, int K,
          int N, int kc, int vec) {
  // the strip's scales (BN f32), then the x chunk (MR x kc f32), which
  // the per-warp sums (DC_WARPS x MR x BN) take over after the K loop
  extern __shared__ __align__(16) float dc_smem[];
  float* ss = dc_smem;
  float* xs = dc_smem + BN;
  constexpr bool SCALE_AFTER = sizeof(XT) == 2;
  constexpr int G = DC_ROWS * DC_U;         // rows per group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = lane & 7;                  // 16-column group of the strip
  const int rs = tid >> 3;                  // row slot, 0..DC_ROWS-1
  const long long n0 = (long long)blockIdx.x * BN + cg * 16;
  const int kbeg = blockIdx.y * kc;
  const int kn = min(K - kbeg, kc);
  const int groups = (kn + G - 1) / G;
  const bool full = (vec & 1) && n0 + 16 <= N;
  const int8_t* wp = w + (long long)(kbeg + rs) * N + n0;

  float acc[MR][16];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;
  // group g: the thread's rows g G + rs + j DC_ROWS, j < DC_U
  auto load = [&](int g, int4 (&q)[DC_U]) {
#pragma unroll
    for (int j = 0; j < DC_U; ++j) {
      const int r = g * G + rs + j * DC_ROWS;
      const int8_t* src = wp + (long long)(g * G + j * DC_ROWS) * N;
      if (r >= kn || n0 >= N) {
        q[j] = make_int4(0, 0, 0, 0);
      } else if (full) {
        q[j] = ld_stream16(src);
      } else {                              // ragged N or unaligned rows
        uint32_t b[4] = {0, 0, 0, 0};
        for (int c = 0; c < 16 && n0 + c < N; ++c)
          b[c >> 2] |= (uint32_t)(uint8_t)src[c] << (8 * (c & 3));
        q[j] = make_int4(b[0], b[1], b[2], b[3]);
      }
    }
  };
  auto use = [&](int g, const int4 (&q)[DC_U]) {
#pragma unroll
    for (int j = 0; j < DC_U; ++j) {
      const int r = g * G + rs + j * DC_ROWS;
      if (r >= kn) break;
      float xv[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) xv[m] = xs[m * kc + r];
      const uint32_t words[4] = {(uint32_t)q[j].x, (uint32_t)q[j].y,
                                 (uint32_t)q[j].z, (uint32_t)q[j].w};
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        const uint32_t u = words[wd] ^ 0x80808080u;
        const float4 s4 =
            SCALE_AFTER
                ? make_float4(1.f, 1.f, 1.f, 1.f)
                : *reinterpret_cast<const float4*>(ss + cg * 16 + 4 * wd);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * wd + i;
          float wv = __uint_as_float(dmtc::level_f32_bits(u, i));
          if (!SCALE_AFTER) wv *= sv[i];    // the reference's q * s
#pragma unroll
          for (int m = 0; m < MR; ++m) acc[m][c] = fmaf(xv[m], wv, acc[m][c]);
        }
      }
    }
  };
  // two groups in flight: both go out before x is staged, and each later
  // one as soon as its registers are free
  int4 qa[DC_U], qb[DC_U];
  load(0, qa);
  load(1, qb);

  if (!SCALE_AFTER && tid < BN) {
    const long long n = (long long)blockIdx.x * BN + tid;
    ss[tid] = n < N ? scale[n] : 0.f;
  }
  if (vec & 2) {                // x rows on 16-byte boundaries: one load
    constexpr int EPC = 16 / (int)sizeof(XT);   // x values per load
    const int per_row = kn / EPC;
    for (int e = tid; e < MR * per_row; e += DC_THREADS) {
      const int m = e / per_row, c = e - m * per_row;
      const int4 v = __ldg(
          reinterpret_cast<const int4*>(x + (long long)m * K + kbeg) + c);
      float4* dst = reinterpret_cast<float4*>(xs + m * kc + c * EPC);
      if constexpr (EPC == 4) {
        dst[0] = make_float4(__int_as_float(v.x), __int_as_float(v.y),
                             __int_as_float(v.z), __int_as_float(v.w));
      } else {                  // bf16 pairs: the low half is the first
        const uint32_t u[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                               (uint32_t)v.w};
        dst[0] = make_float4(__uint_as_float(u[0] << 16),
                             __uint_as_float(u[0] & 0xffff0000u),
                             __uint_as_float(u[1] << 16),
                             __uint_as_float(u[1] & 0xffff0000u));
        dst[1] = make_float4(__uint_as_float(u[2] << 16),
                             __uint_as_float(u[2] & 0xffff0000u),
                             __uint_as_float(u[3] << 16),
                             __uint_as_float(u[3] & 0xffff0000u));
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll 4
      for (int r = tid; r < kn; r += DC_THREADS)
        xs[m * kc + r] = to_f32(x[(long long)m * K + kbeg + r]);
  }
  __syncthreads();

  for (int g = 0; g < groups; g += 2) {
    use(g, qa);
    load(g + 2, qa);
    use(g + 1, qb);
    load(g + 3, qb);
  }

  // lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same columns
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();                          // the x chunk is used up
  float* red = xs;
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < 16; c += 4)
        *reinterpret_cast<float4*>(&red[(warp * MR + m) * BN + cg * 16 + c]) =
            make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2],
                        acc[m][c + 3]);
  }
  __syncthreads();
  decode_finish<MR>(red, N, scale, SCALE_AFTER, out);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch `kernel` on `grid` with the K chunks (grid dimension `dim`, 1 or
// 2) as one thread-block cluster per output tile when there is more than
// one.
template <typename... Params, typename... Args>
int launch_split(void (*kernel)(Params...), dim3 grid, int threads,
                 int smem, int dim, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = dim == 1 ? grid.y : 1;
  attr[0].val.clusterDim.z = dim == 2 ? grid.z : 1;
  cfg.attrs = attr;
  cfg.numAttrs = (dim == 1 ? grid.y : grid.z) > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename XT, int MT, int NS, bool NARROW, bool ALIGNED>
int launch_tc_mt(const XT* x, const int8_t* w, const float* scale,
                 float* out, int M, int K, int N, int kc, int splits,
                 cudaStream_t st) {
  using C = TcCfg<XT, MT, NS>;
  // once per instance and process: the attribute is not a stream
  // operation, and a launch captured into a CUDA graph needs none
  static const cudaError_t attr = cudaFuncSetAttribute(
      dm_tc<XT, MT, NS, NARROW, ALIGNED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, (M + C::BM - 1) / C::BM, splits);
  return launch_split(dm_tc<XT, MT, NS, NARROW, ALIGNED>, grid, TC_THREADS,
                      C::SMEM, 2, st, x, w, scale, out, M, K, N, kc);
}

// bm: the output tile's rows, 128 (prefill) or 32 (few rows, or N <= 64)
template <typename XT, bool ALIGNED>
int launch_tc(const XT* x, const int8_t* w, const float* scale, float* out,
              int M, int K, int N, int kc, int bm, int splits,
              cudaStream_t st) {
  if (bm == 32 && N <= 64)
    return launch_tc_mt<XT, 1, 2, true, ALIGNED>(x, w, scale, out, M, K, N,
                                                 kc, splits, st);
  if (bm == 32)
    return launch_tc_mt<XT, 1, 2, false, ALIGNED>(x, w, scale, out, M, K, N,
                                                  kc, splits, st);
  return launch_tc_mt<XT, 8, 1, false, ALIGNED>(x, w, scale, out, M, K, N,
                                                kc, splits, st);
}

template <typename XT, int MR>
int launch_decode(const XT* x, const int8_t* w, const float* scale,
                  float* out, int K, int N, int kc, int splits, int vec,
                  cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dm_decode<XT, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DC_X_BYTES + (BN + DC_WARPS * MR * BN) * 4);
  if (attr != cudaSuccess) return (int)attr;
  // scales, then x or the per-warp sums and the block's totals
  const int red = (DC_WARPS + 1) * MR * BN;
  const int floats = BN + (MR * kc > red ? MR * kc : red);
  dim3 grid((N + BN - 1) / BN, splits);
  return launch_split(dm_decode<XT, MR>, grid, DC_THREADS, floats * 4, 1, st,
                      x, w, scale, out, K, N, kc, vec);
}

template <typename XT>
int launch(const void* xv, const void* wv, const void* sv, void* ov, int M,
           int K, int N, int kc, int bm, cudaStream_t st) {
  const XT* x = static_cast<const XT*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* scale = static_cast<const float*>(sv);
  float* out = static_cast<float*>(ov);
  const long long splits = ((long long)K + kc - 1) / kc;
  if (splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if (bm == M && M <= 8) {
    if (kc % DC_ROWS || (long long)M * kc * 4 > DC_X_BYTES)
      return (int)cudaErrorInvalidValue;
    // bit 0: 16-byte level loads; bit 1: 16-byte x loads
    const int vec = (N % 16 == 0 && aligned16(w) ? 1 : 0) |
                    (K % (16 / (int)sizeof(XT)) == 0 && aligned16(x) ? 2 : 0);
#define DM_DECODE(MR)                                                     \
  case MR:                                                                \
    return launch_decode<XT, MR>(x, w, scale, out, K, N, kc, (int)splits, \
                                 vec, st);
    switch (M) {
      DM_DECODE(1) DM_DECODE(2) DM_DECODE(3) DM_DECODE(4)
      DM_DECODE(5) DM_DECODE(6) DM_DECODE(7) DM_DECODE(8)
    }
#undef DM_DECODE
    return (int)cudaErrorInvalidValue;
  }
  if (kc % BK || (bm != 128 && bm != 32) || (M + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  if (K % (16 / (int)sizeof(XT)) == 0 && N % 16 == 0 && aligned16(x) &&
      aligned16(w) && aligned16(scale) && aligned16(out))
    return launch_tc<XT, true>(x, w, scale, out, M, K, N, kc, bm,
                               (int)splits, st);
  return launch_tc<XT, false>(x, w, scale, out, M, K, N, kc, bm, (int)splits,
                              st);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x_is_bf16 selects the x type;
// x, w, scale and out are contiguous and on the current device.  kc is the
// K rows per block; bm is M for the decode instance (M <= 8; kc a multiple
// of 32, M * kc * 4 bytes of x at most 64 KB) and otherwise the tensor-core
// tile's rows, 128 or 32 (kc a multiple of 64).  K splits into at most 8
// chunks.  The launch goes on `stream` and does not synchronise.  Returns
// cudaGetLastError().
extern "C" int dequant_matmul_launch(const void* x, int x_is_bf16,
                                     const void* w, const void* scale,
                                     void* out, int M, int K, int N, int kc,
                                     int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || kc <= 0)
    return (int)cudaErrorInvalidValue;
  if (x_is_bf16)
    return launch<__nv_bfloat16>(x, w, scale, out, M, K, N, kc, bm, st);
  return launch<float>(x, w, scale, out, M, K, N, kc, bm, st);
}
