// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in and out, fp32
// accumulation, FlashAttention-2 recomputation from the forward's log-sum-exp.
//
// Replaces the TPU kernels projectiontrainer_tpu/ops/flash_attention.py:_bwd_dkv_kernel
// and :_bwd_dq_kernel (launched from _bwd). Same contract: P = exp(S - lse) recomputed
// tile by tile in the exp2 domain, dV = P^T dO, dS = P * (dP - delta) with
// dP = dO V^T and delta = rowsum(dO * O) (computed by the caller, as JAX does outside
// its kernels, from the forward's fp32 copy of O in training: see flash_attn_fwd.cu),
// dK = scale * dS^T Q, dQ = scale * dS K. P is rounded to bf16 before the dV product,
// as the TPU kernels round it to the input type. dS is not: it enters the dK/dQ
// products as two bf16 terms, hi = bf16(dS) and lo = bf16(dS - hi) (~16 bits of
// mantissa). A row of dS sums to zero, but a row of bf16(dS) sums to ~2^-9 |dS|, and
// dQ takes that sum on along K's common component: on tokens whose common part is 15-60x
// their spread (a trained tower's last layers) a single bf16 term left dq at a cosine
// of 0.9994-0.991 of fp32 where plain bf16 attention reads 0.9997-0.9955; hi + lo reads
// as plain does (measured on the card), for +4-8% on dK/dV and +12-16% on dQ at
// [16, 1024, 16, 72]. Causal, sliding window, per-batch key padding mask and GQA.
//
// What bounds it on the H100: at the decoder's shapes ([4, 1087, 4|1, 256]) the five
// tile products (~10 * B * Hq * T^2 * D flops before causal/window skipping) against
// ~B * T * (Hq + Hkv) * D * 2 * 4 bytes of operands: compute-bound. The tensor cores
// are reached through WMMA (mma.sync 16x16x16 bf16, fp32 accumulate).
//
// Design:
// - dK/dV: one CTA of 8 warps per (32-key tile, KV head, batch). The TPU kernel keeps
//   the whole of Q and dO in VMEM; here the 32-row K and V tiles stay in shared memory
//   and 64-row Q/dO tiles stream through it. The dK and dV accumulators ([32, D] fp32
//   each, 64 KB at D = 256) live in WMMA accumulator fragments in registers (each warp
//   owns 16 rows x D/4 columns of both, 64 registers at D = 256), so shared memory
//   holds only the operand tiles (127 KB at D = 256).
// - GQA: the CTA loops over the n_rep query heads that read its KV head and
//   accumulates all of them into the same fragments: no fp32 per-query-head buffer
//   and no reduction afterwards (JAX writes fp32 dK/dV per query head and sums them
//   outside its kernel).
// - dQ: one CTA of 8 warps per (64-query tile, query head, batch); 64-key K/V tiles
//   stream through shared memory (181 KB at D = 256) and the [64, D] dQ accumulator
//   lives in fragments (each warp: 16 rows x D/2 columns).
// - Masking: the lse of a query row with no valid key is only "very negative" (the
//   finite NEG_INF of the forward), so exp2(s - lse) would overflow there. P is set
//   to 0 explicitly wherever the (query, key) pair is invalid, before any exponent is
//   taken. Query tiles wholly above the diagonal (causal) or below the window are
//   skipped, as are key tiles outside them in the dQ kernel. Rows past T are
//   zero-filled on load and never written.
//
// - Head dims that are not a multiple of 16 (so400m's D = 72): the shared tiles are
//   [rows][DP], DP = D rounded up to 16 (WMMA's k and n); their columns D..DP-1 are
//   zeroed once and never loaded, so they add nothing to S or dP and give zero dK, dV
//   and dQ columns, which are never written back. A warp's share of the DP / 16 column
//   tiles of dK/dV/dQ is rounded up and the tiles past DP are skipped. The scale is the
//   caller's (72^-0.5), and delta stays the caller's sum over the D real columns.
//
// Left for later PRs: wgmma with TMA-fed multi-stage rings, and a 64-key dK/dV tile
// (it needs the accumulators split across two warpgroups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int KV_BK = 32;  // keys per dK/dV CTA
constexpr int KV_BQ = 64;  // queries per step of the dK/dV CTA
constexpr int Q_BQ = 64;   // queries per dQ CTA
constexpr int Q_BK = 64;   // keys per step of the dQ CTA

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// the shared tiles' row length: D rounded up to a multiple of 16
template <int D>
__host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int DP = padded<D>();
  return (size_t)KV_BK * DP * 2 * 2        // sK, sV
         + (size_t)KV_BQ * DP * 2 * 2      // sQ, sdO
         + (size_t)KV_BQ * KV_BK * 4 * 2  // sS, sdP fp32
         + (size_t)KV_BQ * KV_BK * 2 * 3  // sP, sdS (hi), sdS_lo bf16
         + (size_t)KV_BQ * 4 * 2;         // sLse, sDelta
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int DP = padded<D>();
  return (size_t)Q_BQ * DP * 2 * 2       // sQ, sdO
         + (size_t)Q_BK * DP * 2 * 2     // sK, sV
         + (size_t)Q_BQ * Q_BK * 4 * 2  // sS, sdP fp32
         + (size_t)Q_BQ * Q_BK * 2 * 2  // sdS (hi), sdS_lo bf16
         + (size_t)Q_BQ * 4 * 2;        // sLse, sDelta
}

// copy `n_rows` rows (row r at src + r * row_stride, D contiguous bf16) into columns
// 0..D-1 of a [n_rows][DP] shared tile, zero-filling rows >= valid
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int valid, int n_rows) {
  constexpr int VEC = 8;  // 16 bytes
  constexpr int PER_ROW = D / VEC;
  constexpr int DP = padded<D>();
  for (int i = threadIdx.x; i < n_rows * PER_ROW; i += THREADS) {
    int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// zero the pad columns D..DP-1 of a [n_rows][DP] shared tile (once: loads never
// write them)
template <int D>
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int n_rows) {
  constexpr int DP = padded<D>();
  constexpr int PAD = (DP - D) / 8;  // 16-byte chunks a row
  if constexpr (PAD > 0) {
    for (int i = threadIdx.x; i < n_rows * PAD; i += THREADS) {
      int r = i / PAD, c = D + (i % PAD) * 8;
      *reinterpret_cast<uint4*>(dst + r * DP + c) = make_uint4(0, 0, 0, 0);
    }
  }
}

// lse (natural log, scaled to log2) and delta of `n` query rows from q0; 0 past T
__device__ __forceinline__ void load_rows(float* sLse, float* sDelta, const float* lse,
                                          const float* delta, int q0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int t = q0 + i;
    sLse[i] = t < T ? lse[t] * LOG2E : 0.f;
    sDelta[i] = t < T ? delta[t] : 0.f;
  }
}

__device__ __forceinline__ bool attends(int q_pos, int k_pos, int T, int causal, int window,
                                        const int* mb) {
  if (q_pos >= T || k_pos >= T) return false;
  if (causal && k_pos > q_pos) return false;
  if (window > 0 && k_pos <= q_pos - window) return false;
  return mb == nullptr || mb[k_pos] != 0;
}

// P and dS (as bf16 hi + lo) of one warp's 16x16 tile at (row0, col0) of [rows][LD]
// score tiles
template <int LD>
__device__ __forceinline__ void probs_tile(const float* sS, const float* sdP, bf16* sP,
                                           bf16* sdS, bf16* sdS_lo, const float* sLse,
                                           const float* sDelta,
                                           int row0, int col0, int q0, int k0, int T,
                                           int causal, int window, const int* mb,
                                           float qk_scale, int lane) {
  for (int e = lane; e < 256; e += 32) {
    const int r = row0 + e / 16, c = col0 + e % 16;
    float p = 0.f;  // explicit zero for invalid pairs: see the header
    if (attends(q0 + r, k0 + c, T, causal, window, mb))
      p = exp2f(sS[r * LD + c] * qk_scale - sLse[r]);
    if (sP) sP[r * LD + c] = __float2bfloat16(p);
    const float ds = p * (sdP[r * LD + c] - sDelta[r]);
    const bf16 hi = __float2bfloat16(ds);
    sdS[r * LD + c] = hi;
    sdS_lo[r * LD + c] = __float2bfloat16(ds - __bfloat162float(hi));
  }
}

// write one accumulator fragment (times `mul`) as bf16 rows [row0, row0+16) x
// [col0, col0+16) of out (row t at out + t * row_stride), rows < T and columns < D only
__device__ __forceinline__ void store_frag(Acc& frag, float mul, float* stage, bf16* out,
                                           long long row_stride, int row0, int col0, int T,
                                           int D, int lane) {
  for (int i = 0; i < frag.num_elements; ++i) frag.x[i] *= mul;
  wmma::store_matrix_sync(stage, frag, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int t = row0 + e / 16, c = col0 + e % 16;
    if (t < T && c < D) out[t * row_stride + c] = __float2bfloat16(stage[e]);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kv_mask,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int Hq, int Hkv,
                     long long sqb, long long sqt, long long sqh,
                     long long skb, long long skt, long long skh,
                     long long svb, long long svt, long long svh,
                     long long sob, long long sot, long long soh,
                     long long sdkb, long long sdkt, long long sdkh,
                     long long sdvb, long long sdvt, long long sdvh,
                     float scale, int causal, int window) {
  constexpr int DP = padded<D>();
  constexpr int NT = DP / 16;       // d tiles of dK (and of dV)
  constexpr int NF = (NT + 3) / 4;  // ... per warp (4 column groups); tiles past NT skipped
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KV_BK * DP;
  bf16* sQ = sV + KV_BK * DP;
  bf16* sdO = sQ + KV_BQ * DP;
  float* sS = reinterpret_cast<float*>(sdO + KV_BQ * DP);
  float* sdP = sS + KV_BQ * KV_BK;
  bf16* sP = reinterpret_cast<bf16*>(sdP + KV_BQ * KV_BK);
  bf16* sdS = sP + KV_BQ * KV_BK;
  bf16* sdS_lo = sdS + KV_BQ * KV_BK;
  float* sLse = reinterpret_cast<float*>(sdS_lo + KV_BQ * KV_BK);
  float* sDelta = sLse + KV_BQ;

  const int k0 = blockIdx.x * KV_BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float qk_scale = scale * LOG2E;
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  zero_pad_cols<D>(sK, KV_BK);
  zero_pad_cols<D>(sV, KV_BK);
  zero_pad_cols<D>(sQ, KV_BQ);
  zero_pad_cols<D>(sdO, KV_BQ);
  load_tile<D>(sK, k + b * skb + hk * skh + k0 * skt, skt, min(KV_BK, T - k0), KV_BK);
  load_tile<D>(sV, v + b * svb + hk * svh + k0 * svt, svt, min(KV_BK, T - k0), KV_BK);

  // this warp's score tile: query rows s_row.., key columns s_col..
  const int s_row = 16 * (warp % 4), s_col = 16 * (warp / 4);
  // this warp's dK/dV tiles: key rows kv_row.., d columns d0 .. d0 + 16 * NF
  const int kv_row = 16 * (warp % 2), d0 = (warp / 2) * NF * 16;
  Acc acc_dk[NF], acc_dv[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(acc_dk[f], 0.f);
    wmma::fill_fragment(acc_dv[f], 0.f);
  }

  // query tiles that can see a key of this tile
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(T, k0 + KV_BK - 1 + window) : T;
  const int qt_begin = q_lo / KV_BQ, qt_end = (q_hi + KV_BQ - 1) / KV_BQ;

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const bf16* qh = q + b * sqb + h * sqh;
    const bf16* oh = dout + b * sob + h * soh;
    const long long row_off = ((long long)b * Hq + h) * T;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * KV_BQ;
      __syncthreads();  // every warp is done with the previous Q/dO/P/dS tiles
      load_tile<D>(sQ, qh + q0 * sqt, sqt, min(KV_BQ, T - q0), KV_BQ);
      load_tile<D>(sdO, oh + q0 * sot, sot, min(KV_BQ, T - q0), KV_BQ);
      load_rows(sLse, sDelta, lse + row_off, delta + row_off, q0, KV_BQ, T);
      __syncthreads();

      {  // S = Q K^T and dP = dO V^T on this warp's tile
        Acc s_acc, dp_acc;
        wmma::fill_fragment(s_acc, 0.f);
        wmma::fill_fragment(dp_acc, 0.f);
#pragma unroll 4
        for (int kd = 0; kd < DP / 16; ++kd) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(a, sQ + s_row * DP + kd * 16, DP);
          wmma::load_matrix_sync(bt, sK + s_col * DP + kd * 16, DP);
          wmma::mma_sync(s_acc, a, bt, s_acc);
          wmma::load_matrix_sync(a, sdO + s_row * DP + kd * 16, DP);
          wmma::load_matrix_sync(bt, sV + s_col * DP + kd * 16, DP);
          wmma::mma_sync(dp_acc, a, bt, dp_acc);
        }
        wmma::store_matrix_sync(sS + s_row * KV_BK + s_col, s_acc, KV_BK, wmma::mem_row_major);
        wmma::store_matrix_sync(sdP + s_row * KV_BK + s_col, dp_acc, KV_BK,
                                wmma::mem_row_major);
      }
      __syncwarp();
      probs_tile<KV_BK>(sS, sdP, sP, sdS, sdS_lo, sLse, sDelta, s_row, s_col, q0, k0, T,
                        causal, window, mb, qk_scale, lane);
      __syncthreads();

      // dV += P^T dO, dK += (dS_hi + dS_lo)^T Q over the tile's 64 queries
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        // P stored [BQ][BK] row-major is P^T [BK][BQ] column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt, dst, dst_lo;
        wmma::load_matrix_sync(pt, sP + kk * 16 * KV_BK + kv_row, KV_BK);
        wmma::load_matrix_sync(dst, sdS + kk * 16 * KV_BK + kv_row, KV_BK);
        wmma::load_matrix_sync(dst_lo, sdS_lo + kk * 16 * KV_BK + kv_row, KV_BK);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          if (NT % 4 != 0 && d0 + f * 16 >= DP) break;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, sdO + kk * 16 * DP + d0 + f * 16, DP);
          wmma::mma_sync(acc_dv[f], pt, bm, acc_dv[f]);
          wmma::load_matrix_sync(bm, sQ + kk * 16 * DP + d0 + f * 16, DP);
          wmma::mma_sync(acc_dk[f], dst, bm, acc_dk[f]);
          wmma::mma_sync(acc_dk[f], dst_lo, bm, acc_dk[f]);
        }
      }
    }
  }

  __syncthreads();  // sS becomes per-warp staging for the epilogue
  float* stage = sS + warp * 256;
  bf16* dkb = dk + b * sdkb + hk * sdkh + k0 * sdkt;
  bf16* dvb = dv + b * sdvb + hk * sdvh + k0 * sdvt;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (NT % 4 != 0 && d0 + f * 16 >= DP) break;
    store_frag(acc_dk[f], scale, stage, dkb, sdkt, kv_row, d0 + f * 16, T - k0, D, lane);
    store_frag(acc_dv[f], 1.f, stage, dvb, sdvt, kv_row, d0 + f * 16, T - k0, D, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_mask,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int T, int Hq, int Hkv,
                    long long sqb, long long sqt, long long sqh,
                    long long skb, long long skt, long long skh,
                    long long svb, long long svt, long long svh,
                    long long sob, long long sot, long long soh,
                    long long sdqb, long long sdqt, long long sdqh,
                    float scale, int causal, int window) {
  constexpr int DP = padded<D>();
  constexpr int NT = DP / 16;       // d tiles of dQ
  constexpr int NF = (NT + 1) / 2;  // ... per warp (2 column groups); tiles past NT skipped
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + Q_BQ * DP;
  bf16* sK = sdO + Q_BQ * DP;
  bf16* sV = sK + Q_BK * DP;
  float* sS = reinterpret_cast<float*>(sV + Q_BK * DP);
  float* sdP = sS + Q_BQ * Q_BK;
  bf16* sdS = reinterpret_cast<bf16*>(sdP + Q_BQ * Q_BK);
  bf16* sdS_lo = sdS + Q_BQ * Q_BK;
  float* sLse = reinterpret_cast<float*>(sdS_lo + Q_BQ * Q_BK);
  float* sDelta = sLse + Q_BQ;

  const int q0 = blockIdx.x * Q_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float qk_scale = scale * LOG2E;
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
  const long long row_off = ((long long)b * Hq + h) * T;

  zero_pad_cols<D>(sQ, Q_BQ);
  zero_pad_cols<D>(sdO, Q_BQ);
  zero_pad_cols<D>(sK, Q_BK);
  zero_pad_cols<D>(sV, Q_BK);
  load_tile<D>(sQ, q + b * sqb + h * sqh + q0 * sqt, sqt, min(Q_BQ, T - q0), Q_BQ);
  load_tile<D>(sdO, dout + b * sob + h * soh + q0 * sot, sot, min(Q_BQ, T - q0), Q_BQ);
  load_rows(sLse, sDelta, lse + row_off, delta + row_off, q0, Q_BQ, T);

  // this warp's score tiles: query rows s_row.., key columns s_col and s_col + 16;
  // its dQ tiles: the same rows, d columns d0 .. d0 + 16 * NF
  const int s_row = 16 * (warp % 4), s_col = 32 * (warp / 4);
  const int d0 = (warp / 4) * NF * 16;
  Acc acc_dq[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc_dq[f], 0.f);

  int kt_end = (T + Q_BK - 1) / Q_BK;
  if (causal) kt_end = min(kt_end, (q0 + Q_BQ - 1) / Q_BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / Q_BK : 0;

  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * Q_BK;
    __syncthreads();  // every warp is done with the previous K/V/dS tiles
    load_tile<D>(sK, kb + k0 * skt, skt, min(Q_BK, T - k0), Q_BK);
    load_tile<D>(sV, vb + k0 * svt, svt, min(Q_BK, T - k0), Q_BK);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 2; ++j) {  // S = Q K^T and dP = dO V^T on this warp's tiles
      const int col = s_col + 16 * j;
      Acc s_acc, dp_acc;
      wmma::fill_fragment(s_acc, 0.f);
      wmma::fill_fragment(dp_acc, 0.f);
#pragma unroll 4
      for (int kd = 0; kd < DP / 16; ++kd) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + s_row * DP + kd * 16, DP);
        wmma::load_matrix_sync(bt, sK + col * DP + kd * 16, DP);
        wmma::mma_sync(s_acc, a, bt, s_acc);
        wmma::load_matrix_sync(a, sdO + s_row * DP + kd * 16, DP);
        wmma::load_matrix_sync(bt, sV + col * DP + kd * 16, DP);
        wmma::mma_sync(dp_acc, a, bt, dp_acc);
      }
      wmma::store_matrix_sync(sS + s_row * Q_BK + col, s_acc, Q_BK, wmma::mem_row_major);
      wmma::store_matrix_sync(sdP + s_row * Q_BK + col, dp_acc, Q_BK, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j)
      probs_tile<Q_BK>(sS, sdP, nullptr, sdS, sdS_lo, sLse, sDelta, s_row, s_col + 16 * j,
                       q0, k0, T, causal, window, mb, qk_scale, lane);
    __syncthreads();

    // dQ += (dS_hi + dS_lo) K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < Q_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a, a_lo;
      wmma::load_matrix_sync(a, sdS + s_row * Q_BK + kk * 16, Q_BK);
      wmma::load_matrix_sync(a_lo, sdS_lo + s_row * Q_BK + kk * 16, Q_BK);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (NT % 2 != 0 && d0 + f * 16 >= DP) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, sK + kk * 16 * DP + d0 + f * 16, DP);
        wmma::mma_sync(acc_dq[f], a, bm, acc_dq[f]);
        wmma::mma_sync(acc_dq[f], a_lo, bm, acc_dq[f]);
      }
    }
  }

  __syncthreads();  // sS becomes per-warp staging for the epilogue
  float* stage = sS + warp * 256;
  bf16* dqb = dq + b * sdqb + h * sdqh + q0 * sdqt;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (NT % 2 != 0 && d0 + f * 16 >= DP) break;
    store_frag(acc_dq[f], scale, stage, dqb, sdqt, s_row, d0 + f * 16, T - q0, D, lane);
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* kv_mask,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int B, int T, int Hq, int Hkv, const long long* s, float scale,
                       int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + KV_BK - 1) / KV_BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq, Hkv,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[12], s[13], s[14], s[15], s[16], s[17], scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* kv_mask,
                      const void* dout, const void* lse, const void* delta, void* dq,
                      int B, int T, int Hq, int Hkv, const long long* s, float scale,
                      int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + Q_BQ - 1) / Q_BQ, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), T, Hq, Hkv,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[12], s[13], s[14], scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// strides: (b, t, h) in elements for q, k, v, dout, dk, dv (18 values)
extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* kv_mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int B, int T, int Hq, int Hkv, int D,
                                       const long long* strides, float scale, int causal,
                                       int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_dkv<64>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                 strides, scale, causal, window, st);
    case 72:
      return (int)launch_dkv<72>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                 strides, scale, causal, window, st);
    case 128:
      return (int)launch_dkv<128>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                  strides, scale, causal, window, st);
    case 256:
      return (int)launch_dkv<256>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                  strides, scale, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// strides: (b, t, h) in elements for q, k, v, dout, dq (15 values)
extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* kv_mask, const void* dout, const void* lse,
                                      const void* delta, void* dq,
                                      int B, int T, int Hq, int Hkv, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_dq<64>(q, k, v, kv_mask, dout, lse, delta, dq, B, T, Hq, Hkv,
                                strides, scale, causal, window, st);
    case 72:
      return (int)launch_dq<72>(q, k, v, kv_mask, dout, lse, delta, dq, B, T, Hq, Hkv,
                                strides, scale, causal, window, st);
    case 128:
      return (int)launch_dq<128>(q, k, v, kv_mask, dout, lse, delta, dq, B, T, Hq, Hkv,
                                 strides, scale, causal, window, st);
    case 256:
      return (int)launch_dq<256>(q, k, v, kv_mask, dout, lse, delta, dq, B, T, Hq, Hkv,
                                 strides, scale, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
