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
// 3.1 us bound at 3.35 TB/s, against 0.54 GFLOP of work (0.5 us on the bf16
// tensor cores).
//
// Two instances:
//
// * bf16 (flash_fwd_tc, the main path): tensor cores.  The reference takes
//   q.k^T from bf16 inputs into f32 and p.astype(bf16) @ v into f32;
//   mma.sync.m16n8k16 bf16 x bf16 -> f32 computes exactly those products,
//   in another summation order.  Blocks of 4 warps, 16 query rows per warp.
//   A warp's rows are 16 positions of one query head, and a block's 4 warps
//   are neighbours in (position tile, head of the KV group) order, so at
//   llama3-8b's 4 query heads per KV head one block serves the whole group
//   at 16 positions and stages each K and V tile once for it.  Q is staged
//   in shared memory and held in registers as A fragments for the whole KV
//   loop.  K and V tiles of 64 keys are staged in bf16 by 16-byte cp.async
//   (zero-filled past Skv), double-buffered, K and V in separate commit
//   groups so Q K^T starts while V is in flight; rows are padded by 16
//   bytes, which makes every ldmatrix phase hit 32 distinct banks.
//   S = Q K^T takes K's (key, d) rows as the .col B operand straight from
//   ldmatrix; the online softmax runs on the accumulator fragments (a row
//   lives in one quad: two xor-shuffles reduce it), with exp as __expf
//   (ex2.approx: relative error about 2^-22, far below the bf16 rounding of
//   p) and no mask work on tiles every row of the warp sees whole; the f32
//   S fragments are re-packed in registers as bf16 A fragments for P V
//   (FlashAttention-2), and V's B fragments come from ldmatrix.trans.  Keys
//   >= Skv get p = 0 exactly by index (zero-filled rows would otherwise
//   score 0).  The output goes through the warp's own Q rows in shared
//   memory so that every lane stores whole 16-byte chunks.  Shared memory
//   is 85 KB at D = 128, set once with cudaFuncSetAttribute.
// * f32 (flash_fwd): not on a main path.  One block of 4 warps per (b*h,
//   16-row query tile); 32-key tiles of K and V in shared memory as f32 (K
//   rows padded by one word); lane j scores key j of the tile, the warp
//   reduces max and sum by shuffles, and each lane keeps D/32 columns of the
//   accumulator.  f32 FMAs outside the tensor cores.
//
// Both mask ragged query and key edges in the kernel, so no power-of-two
// tile has to divide S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/ptx.cuh"

namespace {

using namespace ptx;

constexpr int FA_BQ = 16;                   // query rows per block
constexpr int FA_BKV = 32;                  // keys per tile (one per lane)
constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_ROWS = FA_BQ / FA_WARPS;   // query rows per warp
constexpr float NEG_INF = -1e30f;

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

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int Sq,
          int Skv, int H, int G, float scale) {
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
    qs[r][d] = s < Sq ? q[(((long long)b * Sq + s) * H + h) * D + d] : 0.f;
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
      ks[j][d] = t < Skv ? k[off] : 0.f;
      vs[j][d] = t < Skv ? v[off] : 0.f;
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
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < FA_BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
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
    float* orow = out + (((long long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[lane + 32 * i] = acc[r][i] * inv_l;
  }
}

// ---- bf16 on the tensor cores --------------------------------------------

constexpr int TC_BKV = 64;                  // keys per tile
constexpr int TC_PAD = 8;                   // bf16 of padding per shared row

constexpr int TC_WARPS = 4;                 // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;

template <int D>
constexpr int tc_smem_bytes() {             // Q + 2 stages of K and V
  return (16 * TC_WARPS + 4 * TC_BKV) * (D + TC_PAD) * 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// two f32 -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * gr + tg):
//   A: a0 (row gr, k 2tg..2tg+1), a1 (row gr+8, same k), a2 (row gr,
//      k 2tg+8..+9), a3 (row gr+8, k 2tg+8..+9)
//   B: b0 (k 2tg..2tg+1, col gr), b1 (k 2tg+8..+9, col gr)
//   C: c0, c1 (row gr, cols 2tg, 2tg+1), c2, c3 (row gr+8, same cols)
//
// Work units: the rows of one KV head g are (position tile p of 16 query
// positions, query head j of the group's rep = H / G), numbered u = p * rep
// + j, so that the group's heads at the same positions are neighbours.  A
// block takes TC_WARPS consecutive units of one (b, g), one per warp, and
// stages each K and V tile once for all of them.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int G,
             float scale) {
  constexpr int LD = D + TC_PAD;            // shared row stride (bf16)
  constexpr int KD = D / 16;                // k16 steps of Q K^T
  constexpr int NS = TC_BKV / 8;            // n8 blocks of S
  constexpr int NO = D / 8;                 // n8 blocks of O
  constexpr int CPR = D / 8;                // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sk = sq + 16 * TC_WARPS * LD;   // [2][TC_BKV][LD]
  __nv_bfloat16* sv = sk + 2 * TC_BKV * LD;

  const int rep = H / G;
  const int units = rep * ((Sq + 15) / 16);
  const int bg = blockIdx.y;
  const int b = bg / G, g = bg % G;
  const int u0 = blockIdx.x * TC_WARPS;
  const int offs = Skv - Sq;                // causal alignment (q at the end)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const long long q_row = (long long)H * D, kv_row = (long long)G * D;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * G + g) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * G + g) * D;

  // Q rows: block row r is position 16 p + r % 16 of head g * rep + j,
  // (p, j) the unit of warp r / 16; rows past Sq or past the last unit are
  // zero and never stored
  for (int c = tid; c < 16 * TC_WARPS * CPR; c += TC_THREADS) {
    const int r = c / CPR, cc = c % CPR, u = u0 + r / 16;
    const int s = (u / rep) * 16 + r % 16, h = g * rep + u % rep;
    const bool ok = u < units && s < Sq;
    const __nv_bfloat16* src =
        q + ((long long)b * Sq + (ok ? s : 0)) * q_row + (long long)h * D;
    cp_async16(smem_u32(sq + r * LD + cc * 8), src + cc * 8, ok);
  }
  auto load_tile = [&](const __nv_bfloat16* base, __nv_bfloat16* dst,
                       int t0) {
    for (int c = tid; c < TC_BKV * CPR; c += TC_THREADS) {
      const int r = c / CPR, cc = c % CPR, t = t0 + r;
      cp_async16(smem_u32(dst + r * LD + cc * 8),
                 base + min(t, Skv - 1) * kv_row + cc * 8, t < Skv);
    }
  };

  // the block's last query position reaches key q_last + offs: later tiles
  // are dead
  const int u_last = min(u0 + TC_WARPS, units) - 1;
  const int q_last = min((u_last / rep) * 16 + 15, Sq - 1);
  const int kv_end = min(Skv, q_last + offs + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + TC_BKV - 1) / TC_BKV : 0;
  // commit groups per tile t: K_t, then V_t (Q rides with K_0), so Q K^T
  // starts while V is still in flight
  if (n_tiles > 0) load_tile(kb, sk, 0);
  cp_async_commit();
  if (n_tiles > 0) load_tile(vb, sv, 0);
  cp_async_commit();

  const int u = u0 + warp;
  const int pos0 = (u / rep) * 16;          // this warp's first position
  const int h = g * rep + u % rep;
  const int row0 = pos0 + gr;               // rows row0 and row0 + 8
  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};                // this lane's share of the sum

  for (int t = 0; t < n_tiles; ++t) {
    const int nb_ = (t + 1) & 1;
    if (t + 1 < n_tiles)
      load_tile(kb, sk + nb_ * TC_BKV * LD, (t + 1) * TC_BKV);
    cp_async_commit();
    if (t + 1 < n_tiles)
      load_tile(vb, sv + nb_ * TC_BKV * LD, (t + 1) * TC_BKV);
    cp_async_commit();
    cp_async_wait<3>();                     // K_t (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kd * 16 + (lane >> 4) * 8;
        ldsm_x4(smem_u32(sq + r * LD + c), qf[kd][0], qf[kd][1], qf[kd][2],
                qf[kd][3]);
      }
    }
    const __nv_bfloat16* ks = sk + (t & 1) * TC_BKV * LD;
    const __nv_bfloat16* vs = sv + (t & 1) * TC_BKV * LD;

    // S = Q K^T (16 rows x 64 keys per warp)
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int nb = 0; nb < NS; nb += 2) {
        const int key = nb * 8 + (lane & 7) + (lane >> 4) * 8;
        const int c = kd * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(ks + key * LD + c), b0, b1, b2, b3);
        mma_bf16(s[nb], qf[kd], b0, b1);
        mma_bf16(s[nb + 1], qf[kd], b2, b3);
      }
    }

    // online softmax on the fragments: element i of block nb is row
    // row0 + 8 (i >> 1), key t0 + 8 nb + 2 tg + (i & 1).  A tile that every
    // row of the warp sees whole needs no mask.
    const int t0 = t * TC_BKV;
    const bool whole = t0 + TC_BKV <= Skv && t0 + TC_BKV - 1 <= pos0 + offs;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sc = s[nb][i] * scale;
        if (!whole) {
          const int key = t0 + nb * 8 + 2 * tg + (i & 1);
          if (key > row0 + 8 * (i >> 1) + offs) sc = NEG_INF;
          if (key >= Skv) sc = -INFINITY;   // not a key: p = 0 exactly
        }
        s[nb][i] = sc;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc);
      }
    float m_new[2], corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_r[r], mx[r]);
      corr[r] = __expf(m_r[r] - m_new[r]);
      m_r[r] = m_new[r];
    }
    // P as bf16 A fragments, 16 keys each (p.astype(v.dtype)); l sums f32 p
    uint32_t pf[NS / 2][4];
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = __expf(s[nb][i] - m_new[i >> 1]);
        ls[i >> 1] += p[i];
      }
      pf[nb >> 1][(nb & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + ls[r];
#pragma unroll
    for (int i = 0; i < NO; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= corr[j >> 1];

    cp_async_wait<2>();                     // V_t has landed
    __syncthreads();
    // O += P V
#pragma unroll
    for (int kk = 0; kk < TC_BKV / 16; ++kk) {
#pragma unroll
      for (int nd = 0; nd < NO; nd += 2) {
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = nd * 8 + (lane >> 4) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(vs + key * LD + c), b0, b1, b2, b3);
        mma_bf16(o[nd], pf[kk], b0, b1);
        mma_bf16(o[nd + 1], pf[kk], b2, b3);
      }
    }
    __syncthreads();                        // tile t's buffers are free
  }
  cp_async_wait<0>();

  if (u >= units) return;
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[r] = 1.f / fmaxf(l, 1e-30f);
  }
  // through this warp's own Q rows in shared memory (read only by this
  // warp, at t = 0), so each lane stores whole 16-byte chunks of a row
  __nv_bfloat16* so = sq + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nd = 0; nd < NO; ++nd)
      *reinterpret_cast<uint32_t*>(so + (gr + 8 * r) * LD + nd * 8 + 2 * tg) =
          pack_bf16(o[nd][2 * r] * inv_l[r], o[nd][2 * r + 1] * inv_l[r]);
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, cc = c % CPR, qi = pos0 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(out + (((long long)b * Sq + qi) * H + h) * D +
                                cc * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + cc * 8);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int H, int G, float scale, cudaStream_t st) {
  constexpr int bytes = tc_smem_bytes<D>();
  // once per instance and process: the attribute is not a stream
  // operation, and a launch captured into a CUDA graph needs none
  static const cudaError_t attr =
      bytes > 48 * 1024
          ? cudaFuncSetAttribute(flash_fwd_tc<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes)
          : cudaSuccess;
  if (attr != cudaSuccess) return (int)attr;
  const int units = (H / G) * ((Sq + 15) / 16);
  dim3 grid((units + TC_WARPS - 1) / TC_WARPS, B * G);
  flash_fwd_tc<D><<<grid, TC_THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, G, scale);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Skv, int H, int G, int D, float scale,
               cudaStream_t st) {
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * H);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  switch (D) {
    case 32:
      flash_fwd<32><<<grid, FA_THREADS, 0, st>>>(qp, kp, vp, op, Sq, Skv, H,
                                                 G, scale);
      break;
    case 128:
      flash_fwd<128><<<grid, FA_THREADS, 0, st>>>(qp, kp, vp, op, Sq, Skv,
                                                  H, G, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All tensors contiguous in the
// (B, S, heads, D) layout, on the current device; is_bf16 selects the type
// (bf16 rows must start 16-byte aligned: the wrapper copies a tensor that
// does not).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int B, int Sq, int Skv, int H, int G,
                                      int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return launch_f32(q, k, v, out, B, Sq, Skv, H, G, D, scale, st);
  switch (D) {
    case 32:
      return launch_tc<32>(q, k, v, out, B, Sq, Skv, H, G, scale, st);
    case 128:
      return launch_tc<128>(q, k, v, out, B, Sq, Skv, H, G, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
