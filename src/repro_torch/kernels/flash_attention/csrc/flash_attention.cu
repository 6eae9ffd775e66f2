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
// tensor cores).  In f32 at deepseek-moe-16b's (H, G) = (16, 16): 16.8 MB,
// 5.0 us, against 0.27 GFLOP (1.6 us at the 3xTF32 rate below).  At
// musicgen-medium's prefill (B=4, S=128, H=G=24, D=64): 6.3 MB in bf16,
// 1.9 us, against 0.20 GFLOP (0.2 us); 12.6 MB in f32, 3.8 us, against
// 1.2 us at the 3xTF32 rate.
//
// Two kernels, each built for D = 32 (the smoke models), 64 (musicgen-
// medium) and 128 (the other full-width models).  Nothing in either
// depends on D but the loop counts and the shared rows, and D = 64 keeps
// the D = 128 instance's bank arithmetic: a bf16 row of D + 8 elements is
// 144 bytes (36 words, 4 mod 32, as 272 bytes at D = 128), so the 8 rows
// of an ldmatrix phase start at banks 0, 4, .., 28 and hit 32 distinct
// banks; f32 Q and K rows of D + 8 words are 8 mod 32 and V rows of D + 4
// are 4 mod 32, as at D = 128.  A row is D / 8 (bf16) or D / 4 (f32)
// 16-byte cp.async copies, 8 or 16 at D = 64.  Q stays in registers in the
// bf16 kernel (4 k16 fragments at D = 64, 8 at D = 128).  Shared memory
// per block at D = 64: 45 KB in bf16 (under the 48 KB default, so no
// attribute; 4 blocks per SM), 88 KB in f32 (2 blocks per SM).
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
// * f32 (flash_fwd_f32, the f32 models' path): tensor cores by the 3xTF32
//   split.  The reference takes q.k^T and p @ v from f32 operands into f32
//   (p stays f32: astype(v.dtype) is the identity), and one TF32 or bf16
//   MMA would drop bits of both operands.  So each operand is split in
//   registers, a = big + small: big is a rounded to TF32 (10 explicit
//   significand bits), a - big is exact, and small is a - big rounded to
//   TF32; mma.sync.m16n8k8.tf32 sums small * big + big * small + big * big
//   in f32.  What is left out (small * small and the rounding of small) is
//   about 2^-22 of each product, under the f32 rounding of the sums.  Three
//   TF32 products per product run at a third of the TF32 rate, BF16_FLOPS
//   / 6 (165 TFLOP/s).  The design follows the bf16 instance's: the same
//   units (a block serves one KV head), the online softmax on the
//   accumulator fragments, no mask work on whole tiles, output stores
//   through the unit's Q rows.  What differs, and why:
//   - The split triples the MMAs and f32 tiles take twice the shared
//     memory, and at deepseek-moe-16b's (16, 16) a (batch row, head) has
//     only 8 units of 16 rows, so with one warp per unit an SM would hold
//     4 warps, each on a chain of up to 128 keys.  So each unit has two
//     warps (halves) that take alternate 32-key tiles of its keys and at
//     the end add their running maxima, sums and accumulators through
//     shared memory as the online softmax adds tiles, each half for half
//     of the output columns: blocks of 8 warps and 4 units.  Each half
//     runs its own pipeline: its K and V tiles of each 64-key stage by
//     cp.async, double-buffered, K and V in separate commit groups, and a
//     barrier of its 4 warps after each lands (168 KB of shared memory at
//     D = 128: one block per SM).  A warp skips the products of a tile
//     whose every key is past its rows' limit.
//   - A unit's work grows with its position, so a block takes two units
//     from the front of the (position, head) order and two from the back,
//     and the two halves of a unit sit on two of the SM's four
//     sub-partitions, beside a unit from the other end, so that the
//     tensor cores of all four share the block's work.
//   - Q stays in shared memory and is split again for each tile (split Q
//     fragments would take 128 registers at D = 128); exp is expf; the
//     three MMAs of a product go to 4 different accumulators in turn, so
//     none waits on the one before.
//   - The k index of both products is permuted so that no operand needs a
//     shuffle: A's k columns tg and tg + 4 are the pair 2tg, 2tg + 1 of d
//     (Q K^T: one 8-byte load each from a Q row and a K row) or of keys
//     (P V: the pair each row of an S accumulator fragment holds).  Q and
//     K rows are padded by 8 words, so a half-warp's 8-byte loads from 4
//     rows hit 32 banks; V rows by 4, so a warp's loads of rows 2tg,
//     column gr hit 32 banks.
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

constexpr float NEG_INF = -1e30f;

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

// ---- f32 on the tensor cores: 3xTF32 ------------------------------------

constexpr int F_BKV = 32;                   // keys per warp and step
constexpr int F_PAD = 8;                    // f32 padding of Q and K rows
constexpr int F_VPAD = 4;                   // f32 padding of V rows
constexpr int F_WARPS = 2 * TC_WARPS;       // two halves of the key range
constexpr int F_THREADS = 32 * F_WARPS;

template <int D>
constexpr int f32_smem_bytes() {  // Q + 2 stages of 2 tiles of K and V
  return (16 * TC_WARPS * (D + F_PAD) + 4 * F_BKV * (D + F_PAD) +
          4 * F_BKV * (D + F_VPAD)) * 4;
}

// x = big + small: big is x rounded to TF32 (10 explicit significand bits,
// ties away from zero), so x - big is exact; small is x - big rounded to
// TF32 as well, which leaves about 2^-22 |x| out
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) &
          0xffffe000u;
}

// c[i] += a * b[i] for NB column blocks from split operands: small a *
// big b, big a * small b, then big a * big b, each product in f32 on the
// tensor cores; the blocks' MMAs take turns, so none waits on the one
// before on its accumulator
template <int NB>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[NB][2],
                                           const uint32_t (&bs)[NB][2]) {
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(c[i], as, bb[i][0], bb[i][1]);
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(c[i], ab, bs[i][0], bs[i][1]);
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(c[i], ab, bb[i][0], bb[i][1]);
}

// Fragment layouts of mma.m16n8k8 tf32 (lane = 4 * gr + tg):
//   A: a0 (row gr, k tg), a1 (row gr+8, k tg), a2 (row gr, k tg+4),
//      a3 (row gr+8, k tg+4)
//   B: b0 (k tg, col gr), b1 (k tg+4, col gr)
//   C: as for m16n8k16
// k tg and tg + 4 of an 8-wide step are taken to be the pair 2tg, 2tg + 1
// of it (d for Q K^T, keys for P V), the same order in A and B.  The units
// are flash_fwd_tc's, 4 to a block (unit_of), two warps to a unit: in step
// i, warp w (half w % 2 of slot w / 2, on sub-partition w % 4) takes keys
// 64 i + 32 (w % 2) .. + 31, and at the end the two halves of a unit add
// their running maxima, sums and accumulators through shared memory.

// The unit of slot s (0..3) of block x of nblk, or -1 for none: slots 0
// and 1 take units 2x and 2x + 1, slots 2 and 3 count down from the last
// unit, so that the units 0..units-1 are each taken once.
__device__ __forceinline__ int unit_of(int x, int s, int units, int nblk) {
  const int i = 2 * x + (s & 1);
  if (s < 2) return i < units ? i : -1;
  const int u = units - 1 - i;
  return u >= 2 * nblk ? u : -1;
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int Sq,
              int Skv, int H, int G, float scale) {
  constexpr int LQ = D + F_PAD;             // Q and K row stride (f32)
  constexpr int LV = D + F_VPAD;            // V row stride
  constexpr int KD = D / 8;                 // k8 steps of Q K^T
  constexpr int NS = F_BKV / 8;             // n8 blocks of S, k8 steps of P V
  constexpr int NO = D / 8;                 // n8 blocks of O
  constexpr int CPR = D / 4;                // 16-byte chunks per row
  constexpr int SK = 2 * F_BKV;             // keys per stage
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* sq = reinterpret_cast<float*>(f32_smem);
  float* sk = sq + 16 * TC_WARPS * LQ;      // [2][SK][LQ]
  float* sv = sk + 2 * SK * LQ;             // [2][SK][LV]

  const int rep = H / G;
  const int units = rep * ((Sq + 15) / 16);
  const int bg = blockIdx.y;
  const int b = bg / G, g = bg % G;
  const int x = blockIdx.x, nblk = gridDim.x;
  const int offs = Skv - Sq;                // causal alignment (q at the end)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = warp >> 1, half = warp & 1;
  const int gr = lane >> 2, tg = lane & 3;
  const long long q_row = (long long)H * D, kv_row = (long long)G * D;
  const float* kb = k + ((long long)b * Skv * G + g) * D;
  const float* vb = v + ((long long)b * Skv * G + g) * D;

  for (int c = tid; c < 16 * TC_WARPS * CPR; c += F_THREADS) {
    const int r = c / CPR, cc = c % CPR;
    const int u = max(unit_of(x, r / 16, units, nblk), 0);
    const int s = (u / rep) * 16 + r % 16, h = g * rep + u % rep;
    const bool ok = unit_of(x, r / 16, units, nblk) >= 0 && s < Sq;
    const float* src =
        q + ((long long)b * Sq + (ok ? s : 0)) * q_row + (long long)h * D;
    cp_async16(smem_u32(sq + r * LQ + cc * 4), src + cc * 4, ok);
  }
  cp_async_commit();
  // The two halves run their own pipelines: half h loads and reads only
  // its tiles (keys 64 i + 32 h .. + 31 of step i, rows 32 h .. of a
  // stage), with commit groups K then V per step and a barrier of its 4
  // warps (ids 1 and 2; 0 is __syncthreads)
  const int th = (warp >> 1) * 32 + lane;   // thread of the half, 0..127
  auto load_tile = [&](const float* base, float* dst, int ld, int i) {
    for (int c = th; c < F_BKV * CPR; c += F_THREADS / 2) {
      const int r = half * F_BKV + c / CPR, cc = c % CPR, t = i * SK + r;
      cp_async16(smem_u32(dst + ((i & 1) * SK + r) * ld + cc * 4),
                 base + min(t, Skv - 1) * kv_row + cc * 4, t < Skv);
    }
  };
  auto half_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "r"(F_THREADS / 2)
                 : "memory");
  };

  // the block's last query position reaches key q_last + offs, a warp's
  // last one key pos0 + 15 + offs: later keys are dead
  int q_last = -1;
#pragma unroll
  for (int sl = 0; sl < TC_WARPS; ++sl) {
    const int us = unit_of(x, sl, units, nblk);
    if (us >= 0) q_last = max(q_last, min((us / rep) * 16 + 15, Sq - 1));
  }
  const int kv_end = min(Skv, q_last + offs + 1);
  const int n_steps = kv_end > 0 ? (kv_end + SK - 1) / SK : 0;
  if (n_steps > 0) load_tile(kb, sk, LQ, 0);
  cp_async_commit();
  if (n_steps > 0) load_tile(vb, sv, LV, 0);
  cp_async_commit();
  cp_async_wait<2>();                       // Q has landed
  __syncthreads();

  const int u_ = unit_of(x, slot, units, nblk);
  const bool valid = u_ >= 0;
  const int u = max(u_, 0);
  const int pos0 = (u / rep) * 16;
  const int h = g * rep + u % rep;
  const int row0 = pos0 + gr;
  const int w_end = valid ? min(Skv, pos0 + 15 + offs + 1) : 0;
  const float* qw = sq + slot * 16 * LQ;    // this unit's Q rows
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  // per step: after the first half barrier the half's K tile is visible and
  // its warps are done with step i - 1, whose buffers take step i + 1;
  // after the second its V tile is
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<1>();                     // K_i has landed
    half_sync();
    if (i + 1 < n_steps) load_tile(kb, sk, LQ, i + 1);
    cp_async_commit();
    if (i + 1 < n_steps) load_tile(vb, sv, LV, i + 1);
    cp_async_commit();
    const int t0 = i * SK + half * F_BKV;   // this warp's first key
    const bool live = t0 < w_end;           // not every key is past it
    const float* ks = sk + ((i & 1) * SK + half * F_BKV) * LQ;
    const float* vs = sv + ((i & 1) * SK + half * F_BKV) * LV;

    // S = Q K^T (16 rows x 32 keys), k step kd: d = 8 kd + 2 tg (k tg) and
    // 8 kd + 2 tg + 1 (k tg + 4)
    float s[NS][4];
#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nb][j] = 0.f;
    if (live) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const float2 q0 =
            *reinterpret_cast<const float2*>(qw + gr * LQ + kd * 8 + 2 * tg);
        const float2 q1 = *reinterpret_cast<const float2*>(
            qw + (gr + 8) * LQ + kd * 8 + 2 * tg);
        uint32_t ab[4], as[4];
        split_tf32(q0.x, ab[0], as[0]);
        split_tf32(q1.x, ab[1], as[1]);
        split_tf32(q0.y, ab[2], as[2]);
        split_tf32(q1.y, ab[3], as[3]);
        uint32_t bb[NS][2], bs[NS][2];
#pragma unroll
        for (int nb = 0; nb < NS; ++nb) {
          const float2 kk = *reinterpret_cast<const float2*>(
              ks + (nb * 8 + gr) * LQ + kd * 8 + 2 * tg);
          split_tf32(kk.x, bb[nb][0], bs[nb][0]);
          split_tf32(kk.y, bb[nb][1], bs[nb][1]);
        }
        mma_3xtf32<NS>(s, ab, as, bb, bs);
      }

      // online softmax on the fragments, as flash_fwd_tc's, with expf
      const bool whole = t0 + F_BKV <= Skv && t0 + F_BKV - 1 <= pos0 + offs;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < NS; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sc = s[nb][j] * scale;
          if (!whole) {
            const int key = t0 + nb * 8 + 2 * tg + (j & 1);
            if (key > row0 + 8 * (j >> 1) + offs) sc = NEG_INF;
            if (key >= Skv) sc = -INFINITY;   // not a key: p = 0 exactly
          }
          s[nb][j] = sc;
          mx[j >> 1] = fmaxf(mx[j >> 1], sc);
        }
      float m_new[2], corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m_r[r], mx[r]);
        corr[r] = expf(m_r[r] - m_new[r]);
        m_r[r] = m_new[r];
      }
#pragma unroll
      for (int nb = 0; nb < NS; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[nb][j] = expf(s[nb][j] - m_new[j >> 1]);
          ls[j >> 1] += s[nb][j];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + ls[r];
#pragma unroll
      for (int nd = 0; nd < NO; ++nd)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[nd][j] *= corr[j >> 1];
    }
    cp_async_wait<2>();                     // V_i has landed
    half_sync();
    if (live) {
      // O += P V, k step kk: keys 8 kk + 2 tg (k tg) and + 1 (k tg + 4),
      // the pair S block kk holds in elements 0, 1 (row gr) and 2, 3
      // (row gr + 8)
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t ab[4], as[4];
        split_tf32(s[kk][0], ab[0], as[0]);
        split_tf32(s[kk][2], ab[1], as[1]);
        split_tf32(s[kk][1], ab[2], as[2]);
        split_tf32(s[kk][3], ab[3], as[3]);
        const float* v0 = vs + (kk * 8 + 2 * tg) * LV + gr;
#pragma unroll
        for (int n4 = 0; n4 < NO; n4 += 4) {  // 4 n8 blocks of O at a time
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split_tf32(v0[(n4 + j) * 8], bb[j][0], bs[j][0]);
            split_tf32(v0[LV + (n4 + j) * 8], bb[j][1], bs[j][1]);
          }
          mma_3xtf32<4>(o + n4, ab, as, bb, bs);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the K stages are free

  // The halves add their (m, l, o) through the K stages (free after the
  // last barrier), each for half the output columns: half h finishes
  // columns h D / 2 .. and hands the other half of its o to its partner.
  // Per unit: 2 x 16 x D / 2 accumulators, then each half's 16 maxima and
  // 16 sums.
  constexpr int DH = D / 2;
  float* xb = sk + slot * (16 * D + 64);
  float* ml = xb + 16 * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    if (tg == 0) {
      ml[32 * half + gr + 8 * r] = m_r[r];
      ml[32 * half + 16 + gr + 8 * r] = l_r[r];
    }
  }
#pragma unroll
  for (int nd = 0; nd < NO; ++nd) {
    if (nd / (NO / 2) == half) continue;    // the partner's columns
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(xb + half * 16 * DH + (gr + 8 * r) * DH +
                                 (nd % (NO / 2)) * 8 + 2 * tg) =
          make_float2(o[nd][2 * r], o[nd][2 * r + 1]);
  }
  __syncthreads();
  if (!valid) return;
  const int ph = half ^ 1;
  float inv_l[2], c0[2], c1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = ml[32 * ph + gr + 8 * r];
    const float l1 = ml[32 * ph + 16 + gr + 8 * r];
    const float mm = fmaxf(m_r[r], m1);
    c0[r] = expf(m_r[r] - mm);
    c1[r] = expf(m1 - mm);
    inv_l[r] = 1.f / fmaxf(l_r[r] * c0[r] + l1 * c1[r], 1e-30f);
  }
  // the output goes through this unit's own Q rows (read by no warp since
  // the last step), each half its columns, so each lane stores whole
  // 16-byte chunks
  float* so = sq + slot * 16 * LQ;
#pragma unroll
  for (int nd = 0; nd < NO; ++nd) {
    if (nd / (NO / 2) != half) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 o1 = *reinterpret_cast<const float2*>(
          xb + ph * 16 * DH + (gr + 8 * r) * DH + (nd % (NO / 2)) * 8 +
          2 * tg);
      *reinterpret_cast<float2*>(so + (gr + 8 * r) * LQ + nd * 8 + 2 * tg) =
          make_float2(
              (o[nd][2 * r] * c0[r] + o1.x * c1[r]) * inv_l[r],
              (o[nd][2 * r + 1] * c0[r] + o1.y * c1[r]) * inv_l[r]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CPR / 2; c += 32) {
    const int r = c / (CPR / 2), cc = half * (CPR / 2) + c % (CPR / 2);
    const int qi = pos0 + r;
    if (qi < Sq)
      *reinterpret_cast<float4*>(out + (((long long)b * Sq + qi) * H + h) * D +
                                 cc * 4) =
          *reinterpret_cast<const float4*>(so + r * LQ + cc * 4);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int G, float scale, cudaStream_t st) {
  constexpr int bytes = f32_smem_bytes<D>();
  static const cudaError_t attr =
      bytes > 48 * 1024
          ? cudaFuncSetAttribute(flash_fwd_f32<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes)
          : cudaSuccess;
  if (attr != cudaSuccess) return (int)attr;
  const int units = (H / G) * ((Sq + 15) / 16);
  dim3 grid((units + TC_WARPS - 1) / TC_WARPS, B * G);
  flash_fwd_f32<D><<<grid, F_THREADS, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, G,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All tensors contiguous in the
// (B, S, heads, D) layout, on the current device; is_bf16 selects the type
// (rows must start 16-byte aligned: the wrapper copies a tensor that does
// not).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int B, int Sq, int Skv, int H, int G,
                                      int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return is_bf16 ? launch_tc<32>(q, k, v, out, B, Sq, Skv, H, G, scale, st)
                     : launch_f32<32>(q, k, v, out, B, Sq, Skv, H, G, scale,
                                      st);
    case 64:
      return is_bf16 ? launch_tc<64>(q, k, v, out, B, Sq, Skv, H, G, scale, st)
                     : launch_f32<64>(q, k, v, out, B, Sq, Skv, H, G, scale,
                                      st);
    case 128:
      return is_bf16
                 ? launch_tc<128>(q, k, v, out, B, Sq, Skv, H, G, scale, st)
                 : launch_f32<128>(q, k, v, out, B, Sq, Skv, H, G, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
