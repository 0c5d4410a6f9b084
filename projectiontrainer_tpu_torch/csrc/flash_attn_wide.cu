// Flash attention at head dims above 512 for Hopper (sm_90a): the forward (K1), dK/dV (K4)
// and dQ (K5) of ops/flash_attention.py at any head dim D > 512 that is a multiple of 64
// (the wrapper zero-pads the others), bf16 in and out, fp32 accumulation. The wrappers run
// these column blocks only past the reach of flash_attn_cluster.cu (D above 8192:
// ops/flash_attention.py:forward_plan, dkv_plan, dq_plan).
//
// Replaces the TPU kernels projectiontrainer_tpu/ops/flash_attention.py:_fwd_kernel,
// :_bwd_dkv_kernel and :_bwd_dq_kernel at those widths (the JAX kernels take any head
// dim: their K/V block is the whole [T, D] of a head). Same contract as
// flash_attn_fwd.cu and flash_attn_bwd.cu: causal, sliding window, per-batch key padding
// mask, GQA, rows with no valid key give 0 and zero gradients, and the three rules of
// precision found on the card: O is divided by the sum of the bf16-rounded weights that
// its product applied, lse = m + log(l) with l the fp32 sum of the unrounded weights,
// the forward writes O in fp32 for the backward's delta, and dS enters the dK and dQ
// products as hi + lo, two bf16 terms.
//
// What bounds it on the H100: the tensor cores in principle (4 * pairs * D operations
// forward, ~10 and ~8 backward, against one read of the operands). Above 512 neither the
// query tile nor the accumulators of a row block fit on one SM, so this design trades
// operations for room: no model of the repository has such a head dim, and the kernels
// are here to match the JAX package, simply.
//
// Design: column blocks. The output's D columns are cut into blocks of DC = 128, and a
// CTA owns one block of one row tile: grid x = row tiles x column blocks. The scores
// (and dP) contract over the whole D, so every column block computes them again over
// D / 64 chunks of 64 columns: the operands' chunks are copied to shared memory (rows of
// 72 elements, so the fragment reads meet no bank conflict), and the products run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulators in registers), a warp of 4 owning 16
// rows. The CTA then writes only its block: K1 O[:, blk] += P V[:, blk]; K4 dV[blk] +=
// P^T dO[:, blk] and dK[blk] += dS^T Q[:, blk]; K5 dQ[blk] += dS K[:, blk]. The operand
// of that last product is copied transposed into shared memory, so its fragments are
// two 32-bit reads like every other. P and dS go from the score accumulators to the A
// fragments of the next product in registers (the accumulator's places of two 8-column
// tiles are those of a 16-deep A fragment). Every column block skips the same tiles
// (kv_tile_range, q_tile_range of ops/flash_attention.py at 64 rows and 64 keys), and
// computes the same scores in the same order, so its softmax statistics are the same
// bits: lse is written by block 0 alone. The last column block of a D that 128 does not
// divide holds 64 columns: its loads past D are zeros and its stores stop at D. Each
// element of a result is summed by one thread in program order: a rerun gives the same
// bits. Measured: PERF.md (kernels/check_flash_attn.py, chip_smoke.py phase 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using sm90::bf16_hi;
using sm90::bf16_lo;
using sm90::ex2;
using sm90::pack_bf16;

constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int BR = 64;        // rows a CTA owns (queries in K1 and K5, keys in K4)
constexpr int BT = 64;        // rows of the other operand a tile (keys, or queries in K4)
constexpr int DC = 128;       // output columns a CTA: one column block
constexpr int CH = 64;        // columns a chunk of the score contraction
constexpr int LDS = CH + 8;   // shared row stride (elements) of a [rows x 64] chunk
constexpr int LDT = BT + 8;   // ... of a transposed [DC x 64] block
constexpr int CHUNK_ELEMS = BR * LDS;  // one chunk buffer (BR == BT)
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

static_assert(BR == BT, "one chunk buffer size serves both operands");
static_assert(DC * LDT <= 2 * CHUNK_ELEMS, "a transposed block fits in two chunk buffers");

struct Strides {  // (b, t, h) in elements
  long long b, t, h;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a row-major shared tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int r0, int k0,
                                       int g, int t) {
  a[0] = ld32(s + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + k0 + 8 + 2 * t);
  a[3] = ld32(s + (r0 + g + 8) * ld + k0 + 8 + 2 * t);
}

// acc[nt] (16 rows x 8 columns each, NT of them) += A . M^T over one 64-column chunk,
// A the warp's 16 rows of sa, M the rows of sm (B[k][n] = M[n][k])
template <int NT>
__device__ __forceinline__ void chunk_product(float (&acc)[NT][4], const bf16* sa, const bf16* sm,
                                              int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < CH / 16; ++kk) {
    uint32_t a[4];
    load_a(a, sa, LDS, r0, 16 * kk, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* m = sm + (8 * nt + g) * LDS + 16 * kk + 2 * t;
      sm90::mma16816(acc[nt], a, ld32(m), ld32(m + 8));
    }
  }
}

// acc[nt] (16 rows x 8 columns, DC / 8 of them) += A . B, A from registers (a[kk]: 16
// rows x 16 of the tile's 64), B[k][n] = st[n][k] (a transposed block)
__device__ __forceinline__ void block_product(float (&acc)[DC / 8][4], const uint32_t (&a)[BT / 16][4],
                                              const bf16* st, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt) {
      const bf16* m = st + (8 * nt + g) * LDT + 16 * kk + 2 * t;
      sm90::mma16816(acc[nt], a[kk], ld32(m), ld32(m + 8));
    }
  }
}

// rows r0 .. r0 + 63 (zeros at and past T) of [B, T, H, D] at (b, h), columns c0 .. c0 + 63,
// into a [64 x LDS] shared chunk; 16-byte copies
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, const Strides& s, int b,
                                           int h, int r0, int c0, int T) {
  for (int i = threadIdx.x; i < BR * (CH / 8); i += THREADS) {
    const int r = i / (CH / 8), c = (i % (CH / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) v = *reinterpret_cast<const uint4*>(src + b * s.b + (r0 + r) * s.t + h * s.h + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = v;
  }
}

// rows r0 .. r0 + 63 of [B, T, H, D] at (b, h), columns c0 .. c0 + DC - 1, transposed into
// dst[DC][LDT]: dst[c][r]; zeros past T and past D
__device__ __forceinline__ void load_block_t(bf16* dst, const bf16* src, const Strides& s, int b,
                                             int h, int r0, int c0, int T, int D) {
  for (int i = threadIdx.x; i < BT * (DC / 8); i += THREADS) {
    const int r = i % BT, c = (i / BT) * 8;  // a warp: 32 rows of one column group
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < T && c0 + c < D)
      v = *reinterpret_cast<const uint4*>(src + b * s.b + (r0 + r) * s.t + h * s.h + c0 + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * LDT + r] = e[j];
  }
}

// one key of the tile at k0: inside T and unpadded
__device__ __forceinline__ int key_valid(const int* mb, int key, int T) {
  return key < T && (mb == nullptr || mb[key] != 0);
}

// ------------------------------------------------------------------------------- K1

__global__ void __launch_bounds__(THREADS)
wide_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const int* __restrict__ kv_mask, bf16* __restrict__ out, float* __restrict__ lse,
                float* __restrict__ out_f32, int T, int Hq, int Hkv, int D, Strides sq,
                Strides sk, Strides sv, Strides so, float scale, int causal, int window) {
  // the Q and K chunks, then the V^T block over the same bytes
  __shared__ __align__(16) bf16 smem[2 * CHUNK_ELEMS];
  __shared__ int ok[BT];
  bf16 *sa = smem, *sb = smem + CHUNK_ELEMS, *svt = smem;
  const int ncb = (D + DC - 1) / DC, n_qt = (T + BR - 1) / BR;
  const int qt = n_qt - 1 - blockIdx.x / ncb, cb = blockIdx.x % ncb;  // last tiles first
  const int q0 = qt * BR, c0 = cb * DC, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
  const float qk_scale = scale * LOG2E;

  // the K/V tiles this CTA's rows can see (ops/flash_attention.py:kv_tile_range)
  int kt_end = (T + BT - 1) / BT;
  if (causal) kt_end = min(kt_end, (q0 + BR - 1) / BT + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BT : 0;

  float o[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, u_run[2] = {0.f, 0.f};
  const int row = q0 + 16 * warp + g;  // this thread's rows: row, row + 8

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    float s[BT / 8][4];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    for (int c = 0; c < D / CH; ++c) {
      __syncthreads();  // the previous chunk (or V^T block) is read by every warp
      load_chunk(sa, q, sq, b, h, q0, c * CH, T);
      load_chunk(sb, k, sk, b, hk, k0, c * CH, T);
      if (c == 0 && threadIdx.x < BT) ok[threadIdx.x] = key_valid(mb, k0 + threadIdx.x, T);
      __syncthreads();
      chunk_product<BT / 8>(s, sa, sb, 16 * warp, g, t);
    }

    // the softmax of the tile in the exp2 domain; invalid pairs set to 0 explicitly
    float corr[2];
    uint32_t pa[BT / 16][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = 8 * nt + 2 * t + e, key = k0 + kc;
          const bool valid = ok[kc] && (!causal || key <= qi) && (window <= 0 || key > qi - window);
          s[nt][2 * r + e] = valid ? s[nt][2 * r + e] * qk_scale : NEG_INF;
          mx = fmaxf(mx, s[nt][2 * r + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      float sum = 0.f, used = 0.f;
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[nt][2 * r + e];
          p[e] = x > 0.5f * NEG_INF ? ex2(x - m_new) : 0.f;
          sum += p[e];
        }
        const uint32_t packed = pack_bf16(p[0], p[1]);
        used += bf16_lo(packed) + bf16_hi(packed);
        pa[nt / 2][(nt % 2) * 2 + r] = packed;
      }
      corr[r] = ex2(m_run[r] - m_new);
      l_run[r] = l_run[r] * corr[r] + sum;
      u_run[r] = u_run[r] * corr[r] + used;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    __syncthreads();  // every warp is done with the K chunk
    load_block_t(svt, v, sv, b, hk, k0, c0, T, D);
    __syncthreads();
    block_product(o, pa, svt, g, t);
  }

  // epilogue: out = O / max(u, 1e-30), lse = m + log(l) (block 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r], u = u_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    const int qi = row + 8 * r;
    if (qi >= T) continue;
    const float inv = 1.f / fmaxf(u, 1e-30f);
    bf16* ob = out + b * so.b + qi * so.t + h * so.h;
    float* of = out_f32 ? out_f32 + (((long long)b * T + qi) * Hq + h) * D : nullptr;
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt) {
      const int col = c0 + 8 * nt + 2 * t;
      if (col >= D) continue;
      const float x0 = o[nt][2 * r] * inv, x1 = o[nt][2 * r + 1] * inv;
      *reinterpret_cast<uint32_t*>(ob + col) = pack_bf16(x0, x1);
      if (of) *reinterpret_cast<float2*>(of + col) = make_float2(x0, x1);
    }
    if (t == 0 && cb == 0)
      lse[((long long)b * Hq + h) * T + qi] = m_run[r] * LN2 + logf(fmaxf(l, 1e-30f));
  }
}

// ------------------------------------------------------------------- the backward's P, dS

// P = exp2(S * qk_scale - lse2) on valid pairs (0 elsewhere: the lse of a row with no
// valid key is only "very negative"), dS = P (dP - delta), as bf16 A fragments: P once,
// dS as hi + lo. valid(nt, r, e) says whether the pair at accumulator place (nt, 2 r + e)
// is used; lse2(nt, r, e) and dl(...) its row's or column's statistics.
template <typename Valid, typename Lse, typename Delta>
__device__ __forceinline__ void p_and_ds(const float (&s)[BT / 8][4], const float (&dp)[BT / 8][4],
                                         float qk_scale, Valid valid, Lse lse2, Delta dl,
                                         uint32_t (&pa)[BT / 16][4], uint32_t (&ds_hi)[BT / 16][4],
                                         uint32_t (&ds_lo)[BT / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = valid(nt, r, e) ? ex2(fmaf(s[nt][2 * r + e], qk_scale, -lse2(nt, r, e))) : 0.f;
        ds[e] = p[e] * (dp[nt][2 * r + e] - dl(nt, r, e));
      }
      const int slot = (nt % 2) * 2 + r;
      pa[nt / 2][slot] = pack_bf16(p[0], p[1]);
      const uint32_t hi = pack_bf16(ds[0], ds[1]);
      ds_hi[nt / 2][slot] = hi;
      ds_lo[nt / 2][slot] = pack_bf16(ds[0] - bf16_lo(hi), ds[1] - bf16_hi(hi));
    }
  }
}

// ------------------------------------------------------------------------------- K4

__global__ void __launch_bounds__(THREADS)
wide_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const int* __restrict__ kv_mask, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hq, int Hkv, int D,
                Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                float scale, int causal, int window) {
  // four chunk buffers (K, V, Q, dO), then Q^T and dO^T blocks over the same bytes
  __shared__ __align__(16) bf16 smem[4 * CHUNK_ELEMS];
  __shared__ float lse2_s[BT], delta_s[BT];
  bf16 *s_k = smem, *s_v = smem + CHUNK_ELEMS, *s_q = smem + 2 * CHUNK_ELEMS,
       *s_do = smem + 3 * CHUNK_ELEMS;
  bf16 *s_qt = smem, *s_dot = smem + 2 * CHUNK_ELEMS;
  const int ncb = (D + DC - 1) / DC;
  const int k0 = blockIdx.x / ncb * BR, cb = blockIdx.x % ncb, c0 = cb * DC;
  const int hk = blockIdx.y, b = blockIdx.z, n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
  const float qk_scale = scale * LOG2E;
  const int key = k0 + 16 * warp + g;  // this thread's keys: key, key + 8
  const bool key_ok[2] = {key_valid(mb, key, T) != 0, key_valid(mb, key + 8, T) != 0};

  // the query tiles that can see a key of this CTA (ops/flash_attention.py:q_tile_range)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(T, k0 + BR - 1 + window) : T;
  const int qt_begin = q_lo / BT, qt_end = (q_hi + BT - 1) / BT;

  float acc_dk[DC / 8][4], acc_dv[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const long long row_off = ((long long)b * Hq + h) * T;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BT;
      // S^T = K Q^T and dP^T = V dO^T: [64 keys x 64 queries]
      float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
      for (int i = 0; i < BT / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < D / CH; ++c) {
        __syncthreads();
        load_chunk(s_k, k, sk, b, hk, k0, c * CH, T);
        load_chunk(s_v, v, sv, b, hk, k0, c * CH, T);
        load_chunk(s_q, q, sq, b, h, q0, c * CH, T);
        load_chunk(s_do, dout, sdo, b, h, q0, c * CH, T);
        if (c == 0 && threadIdx.x < BT) {
          const int qi = q0 + threadIdx.x;
          lse2_s[threadIdx.x] = qi < T ? lse[row_off + qi] * LOG2E : 0.f;
          delta_s[threadIdx.x] = qi < T ? delta[row_off + qi] : 0.f;
        }
        __syncthreads();
        chunk_product<BT / 8>(s, s_k, s_q, 16 * warp, g, t);
        chunk_product<BT / 8>(dp, s_v, s_do, 16 * warp, g, t);
      }
      uint32_t pa[BT / 16][4], ds_hi[BT / 16][4], ds_lo[BT / 16][4];
      p_and_ds(
          s, dp, qk_scale,
          [&](int nt, int r, int e) {
            const int qi = q0 + 8 * nt + 2 * t + e, kp = key + 8 * r;
            return key_ok[r] && qi < T && (!causal || kp <= qi) && (window <= 0 || kp > qi - window);
          },
          [&](int nt, int, int e) { return lse2_s[8 * nt + 2 * t + e]; },
          [&](int nt, int, int e) { return delta_s[8 * nt + 2 * t + e]; }, pa, ds_hi, ds_lo);

      // dV += P^T dO[:, blk], dK += (dS_hi + dS_lo)^T Q[:, blk]
      __syncthreads();  // every warp is done with the chunks
      load_block_t(s_qt, q, sq, b, h, q0, c0, T, D);
      load_block_t(s_dot, dout, sdo, b, h, q0, c0, T, D);
      __syncthreads();
      block_product(acc_dv, pa, s_dot, g, t);
      block_product(acc_dk, ds_hi, s_qt, g, t);
      block_product(acc_dk, ds_lo, s_qt, g, t);
    }
  }

  // epilogue: dK = scale * acc, dV = acc, as bf16, the thread's two keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key + 8 * r;
    if (kp >= T) continue;
    bf16* dkb = dk + b * sdk.b + kp * sdk.t + hk * sdk.h;
    bf16* dvb = dv + b * sdv.b + kp * sdv.t + hk * sdv.h;
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt) {
      const int col = c0 + 8 * nt + 2 * t;
      if (col >= D) continue;
      *reinterpret_cast<uint32_t*>(dkb + col) =
          pack_bf16(acc_dk[nt][2 * r] * scale, acc_dk[nt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + col) = pack_bf16(acc_dv[nt][2 * r], acc_dv[nt][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------------------- K5

__global__ void __launch_bounds__(THREADS)
wide_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ kv_mask, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, int T, int Hq, int Hkv, int D, Strides sq, Strides sk,
               Strides sv, Strides sdo, Strides sdq, float scale, int causal, int window) {
  // four chunk buffers (Q, dO, K, V), then the K^T block over the same bytes
  __shared__ __align__(16) bf16 smem[4 * CHUNK_ELEMS];
  __shared__ int ok[BT];
  bf16 *s_q = smem, *s_do = smem + CHUNK_ELEMS, *s_k = smem + 2 * CHUNK_ELEMS,
       *s_v = smem + 3 * CHUNK_ELEMS;
  bf16* s_kt = smem;
  const int ncb = (D + DC - 1) / DC;
  const int q0 = blockIdx.x / ncb * BR, cb = blockIdx.x % ncb, c0 = cb * DC;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
  const float qk_scale = scale * LOG2E;
  const int row = q0 + 16 * warp + g;  // this thread's queries: row, row + 8
  const long long row_off = ((long long)b * Hq + h) * T;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    lse2[r] = qi < T ? lse[row_off + qi] * LOG2E : 0.f;
    dl[r] = qi < T ? delta[row_off + qi] : 0.f;
  }

  int kt_end = (T + BT - 1) / BT;
  if (causal) kt_end = min(kt_end, (q0 + BR - 1) / BT + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BT : 0;

  float acc[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    // S = Q K^T and dP = dO V^T: [64 queries x 64 keys]
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < D / CH; ++c) {
      __syncthreads();
      load_chunk(s_q, q, sq, b, h, q0, c * CH, T);
      load_chunk(s_do, dout, sdo, b, h, q0, c * CH, T);
      load_chunk(s_k, k, sk, b, hk, k0, c * CH, T);
      load_chunk(s_v, v, sv, b, hk, k0, c * CH, T);
      if (c == 0 && threadIdx.x < BT) ok[threadIdx.x] = key_valid(mb, k0 + threadIdx.x, T);
      __syncthreads();
      chunk_product<BT / 8>(s, s_q, s_k, 16 * warp, g, t);
      chunk_product<BT / 8>(dp, s_do, s_v, 16 * warp, g, t);
    }
    uint32_t pa[BT / 16][4], ds_hi[BT / 16][4], ds_lo[BT / 16][4];
    p_and_ds(
        s, dp, qk_scale,
        [&](int nt, int r, int e) {
          const int kc = 8 * nt + 2 * t + e, kp = k0 + kc, qi = row + 8 * r;
          return ok[kc] && (!causal || kp <= qi) && (window <= 0 || kp > qi - window);
        },
        [&](int, int r, int) { return lse2[r]; }, [&](int, int r, int) { return dl[r]; }, pa,
        ds_hi, ds_lo);

    // dQ += (dS_hi + dS_lo) K[:, blk]
    __syncthreads();
    load_block_t(s_kt, k, sk, b, hk, k0, c0, T, D);
    __syncthreads();
    block_product(acc, ds_hi, s_kt, g, t);
    block_product(acc, ds_lo, s_kt, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= T) continue;
    bf16* o = dq + b * sdq.b + qi * sdq.t + h * sdq.h;
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt) {
      const int col = c0 + 8 * nt + 2 * t;
      if (col >= D) continue;
      *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
    }
  }
}

bool shape_ok(int T, int Hq, int Hkv, int D, float scale) {
  return T > 0 && Hkv > 0 && Hq % Hkv == 0 && D > 512 && D % CH == 0 && scale > 0.f;
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// q [B, T, Hq, D], k and v [B, T, Hkv, D] bf16 (D > 512, a multiple of 64) with 16-byte
// aligned rows; strides: (b, t, h) in elements of q, k, v, out (12 values); kv_mask [B, T]
// int32 or null -> out [B, T, Hq, D] bf16, lse [B, Hq, T] fp32, out_f32 dense
// [B, T, Hq, D] fp32 or null
extern "C" int flash_attn_wide_fwd_bf16(const void* q, const void* k, const void* v,
                                        const void* kv_mask, void* out, void* lse, void* out_f32,
                                        int B, int T, int Hq, int Hkv, int D,
                                        const long long* s, float scale, int causal, int window,
                                        void* stream) {
  if (!shape_ok(T, Hq, Hkv, D, scale)) return (int)cudaErrorInvalidValue;
  const int ncb = (D + DC - 1) / DC;
  dim3 grid((T + BR - 1) / BR * ncb, Hq, B);
  wide_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_mask), static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<float*>(out_f32), T, Hq, Hkv, D, strides(s), strides(s + 3), strides(s + 6),
      strides(s + 9), scale, causal, window);
  return (int)cudaGetLastError();
}

// strides: (b, t, h) of q, k, v, dout, dk, dv (18 values); lse and delta [B, Hq, T] fp32
extern "C" int flash_attn_wide_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* kv_mask, const void* dout,
                                            const void* lse, const void* delta, void* dk,
                                            void* dv, int B, int T, int Hq, int Hkv, int D,
                                            const long long* s, float scale, int causal,
                                            int window, void* stream) {
  if (!shape_ok(T, Hq, Hkv, D, scale)) return (int)cudaErrorInvalidValue;
  const int ncb = (D + DC - 1) / DC;
  dim3 grid((T + BR - 1) / BR * ncb, Hkv, B);
  wide_dkv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, Hq, Hkv, D, strides(s), strides(s + 3), strides(s + 6),
      strides(s + 9), strides(s + 12), strides(s + 15), scale, causal, window);
  return (int)cudaGetLastError();
}

// strides: (b, t, h) of q, k, v, dout, dq (15 values)
extern "C" int flash_attn_wide_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* kv_mask, const void* dout,
                                           const void* lse, const void* delta, void* dq, int B,
                                           int T, int Hq, int Hkv, int D, const long long* s,
                                           float scale, int causal, int window, void* stream) {
  if (!shape_ok(T, Hq, Hkv, D, scale)) return (int)cudaErrorInvalidValue;
  const int ncb = (D + DC - 1) / DC;
  dim3 grid((T + BR - 1) / BR * ncb, Hq, B);
  wide_dq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      T, Hq, Hkv, D, strides(s), strides(s + 3), strides(s + 6), strides(s + 9), strides(s + 12),
      scale, causal, window);
  return (int)cudaGetLastError();
}
