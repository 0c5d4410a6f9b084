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
// What bounds it on the H100: the tile products (dK/dV: S^T, dP^T, dV and two terms of
// dK, ~10 * B * Hq * T^2 * D operations before causal/window skipping; dQ: ~8) against
// ~B * T * (Hq + Hkv) * D * 2 * 4 bytes of operands: the tensor cores. The dK/dV kernel
// runs at 3.2 times its bound at [16, 1024, 16, 72] and at 9 times at the decoder's
// [4, 1087, 4|1, 256] (68 CTAs for 132 SMs, and S^T and dP^T computed twice); the WMMA dQ
// kernel at 24-55.
//
// Design:
// - dK/dV (namespace dkv, wgmma; it replaces a WMMA kernel of 32-key CTAs that passed S,
//   dP, P and dS through shared memory). One CTA owns 128 keys of one (batch, KV head):
//   two consumer warpgroups of 64 keys and one producer warp (setmaxnreg 232 / 40). K and
//   V are loaded once by TMA and stay in shared memory; the Q and dO tiles of 64 queries
//   (32 from D = 128 up) stream through a ring of 3 (4) stages that the producer warp
//   fills by TMA, writing the tile's lse (in log2 units) and delta rows beside them;
//   full / empty mbarriers, every wait traps after ~2 s. The tiles are computed
//   transposed, so nothing is transposed in shared memory: S^T = K Q^T and
//   dP^T = V dO^T (A = K or V, B = Q or dO, all K-major in the TMA unit's
//   128-byte-swizzled layout), then P^T and dS^T are formed on the accumulators in
//   registers, rounded to bf16 in wgmma's A-operand places, and feed dV += P^T dO and
//   dK += dS_hi^T Q + dS_lo^T Q with the same dO and Q boxes read as MN-major B
//   operands. dK and dV stay in registers ([64, D] fp32 each a warpgroup, 64 + 64
//   registers a thread at D = 128) until the epilogue writes them as bf16. A sum is made
//   by one thread in program order, so a rerun gives the same bits.
//   At D = 256 dK and dV of 64 keys would be 256 registers a thread: there the CTA owns
//   64 keys, both warpgroups compute S^T and dP^T of all of them (two of the five
//   products done twice) and each keeps one half of the columns of dK and dV, reading
//   its half of the dO and Q boxes. No warpgroup waits for the other.
//   The 4-D tensor maps (D, T, H, B) over the strided tensors zero-fill past T and past
//   D: head dim 72 takes five k-steps over a zero-filled second box and wgmma's n = 72.
//   Measured (NVIDIA H100 80GB HBM3, 700 W; kernels/check_flash_attn.py --time, ms a
//   launch with the host's share out; the WMMA kernel before it / the library's whole
//   backward, dq, dk and dv together, beside it): [16, 1024, 16, 72] 0.502 (4.300 timed
//   a launch at a time / 1.139); decoder [4, 1087, 4|1, 256] causal, window 512,
//   right-padded 0.121 (0.696 / 1.358, its math backend); prefill shape [8, 831, 4|1,
//   256] left-padded 0.124 (1.148 / 1.475); merged [2, 1024, 8 * 128] 0.054 (0.091).
//   Tried and taken out: 64 queries a stage at D = 128 (12-28 bytes of spills at 232 and
//   at 240 registers; 0.077 against 0.085 ms at the merged shape, timed a launch at a
//   time); 240 / 24 registers (4-12 bytes of spills at every head dim: the producer
//   warp's address arithmetic does not fit 24; same times).
// - GQA: the CTA loops over the n_rep query heads that read its KV head and
//   accumulates all of them into the same accumulators: no fp32 per-query-head buffer
//   and no reduction afterwards (JAX writes fp32 dK/dV per query head and sums them
//   outside its kernel). At 8 query heads on 2 KV heads and B * T = 2048 that is 32 CTAs
//   for 132 SMs (0.171 ms against 0.054 with 8 KV heads).
// - dQ (WMMA, all four head dims): one CTA of 8 warps per (64-query tile, query head,
//   batch); 64-key K/V tiles stream through shared memory (181 KB at D = 256), S and dP
//   pass through fp32 shared memory, and the [64, D] dQ accumulator lives in fragments
//   (each warp: 16 rows x D/2 columns).
// - Masking: the lse of a query row with no valid key is only "very negative" (the
//   finite NEG_INF of the forward), so exp2(s - lse) would overflow there. P is set
//   to 0 explicitly wherever the (query, key) pair is invalid (the dK/dV kernel: only in
//   tiles that hold such a pair). Query tiles wholly above the diagonal (causal) or
//   below the window are skipped, as are key tiles outside them in the dQ kernel. Rows
//   past T are zero-filled on load and never written.
// - Head dim 72 in the dQ kernel: the shared tiles are [rows][DP], DP = D rounded up to
//   16 (WMMA's k and n); their columns D..DP-1 are zeroed once and never loaded, so
//   they add nothing to S or dP and give zero dQ columns, which are never written back.
//   The scale is the caller's (72^-0.5), and delta stays the caller's sum over the D
//   real columns.
//
// Left for a later PR: dQ on wgmma.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "tensor_map.cuh"
#include "wgmma_sm90.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int Q_BQ = 64;   // queries per dQ CTA
constexpr int Q_BK = 64;   // keys per step of the dQ CTA

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// the shared tiles' row length: D rounded up to a multiple of 16
template <int D>
__host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }

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

// dS (as bf16 hi + lo) of one warp's 16x16 tile at (row0, col0) of [rows][LD] score
// tiles
template <int LD>
__device__ __forceinline__ void probs_tile(const float* sS, const float* sdP,
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
      probs_tile<Q_BK>(sS, sdP, sdS, sdS_lo, sLse, sDelta, s_row, s_col + 16 * j,
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


// ------------------------------------------------- dK/dV on wgmma (head dims 64, 72, 128)

namespace dkv {

using namespace sm90;

constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; warp 8: the producer

template <int D>
struct Cfg {
  // At D = 256 dK and dV of 64 keys are 256 registers a thread for one warpgroup: the two
  // warpgroups then share the CTA's 64 keys (each computes S^T and dP^T of all of them)
  // and own one half of the columns of dK and dV each.
  static constexpr int SPLIT = D > 128 ? 2 : 1;
  static constexpr int BKV = 128 / SPLIT;  // keys a CTA
  static constexpr int DW = D / SPLIT;     // columns of dK and dV a warpgroup
  // queries a ring stage: with dK and dV at 128 registers a thread, 64-query S^T and dP^T
  // (64 more) spilled 12-28 bytes at 232 and 240 registers
  static constexpr int BQ = DW > 72 ? 32 : 64;
  static constexpr int STAGES = DW > 72 ? 4 : 3;
  static constexpr int NB = (D + 63) / 64;      // 64-column blocks (TMA boxes) of a row
  static constexpr int KSTEPS = (D + 15) / 16;  // k-steps over D (zero columns past D)
  static constexpr int KV_BLOCK = BKV * 128;    // bytes of one 64-column block of K or V
  static constexpr int Q_BLOCK = BQ * 128;      // ... of a Q or dO tile
  static constexpr int KV_BYTES = NB * KV_BLOCK;
  static constexpr int TILE_BYTES = NB * Q_BLOCK;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // Q, then dO
  static constexpr int STATS_BYTES = 2 * BQ * 4;      // lse (log2 units), then delta
  static constexpr size_t SMEM = 2 * KV_BYTES + STAGES * (STAGE_BYTES + STATS_BYTES) + 1024 +
                                 8 * (2 * STAGES + 1);
  static_assert(SMEM <= 232448, "shared memory of one SM");
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const int* __restrict__ kv_mask, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int T, int Hq, int Hkv,
                           long long sdkb, long long sdkt, long long sdkh,
                           long long sdvb, long long sdvt, long long sdvh,
                           float scale, int causal, int window) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, STAGES = C::STAGES, BKV = C::BKV, DW = C::DW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sk = smem_addr(smem), sv = sk + C::KV_BYTES;
  const uint32_t ring = sv + C::KV_BYTES;
  float* stats = reinterpret_cast<float*>(smem + 2 * C::KV_BYTES + STAGES * C::STAGE_BYTES);
  const uint32_t full = ring + STAGES * (C::STAGE_BYTES + C::STATS_BYTES);
  const uint32_t empty = full + 8 * STAGES, kv_full = empty + 8 * STAGES;

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  // a warpgroup whose keys all lie past T leaves
  const int active_wgs = C::SPLIT == 2 || k0 + 64 < T ? 2 : 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active_wgs);  // lane 0 of each consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the query tiles that can see a key of this CTA (ops/flash_attention.py:q_tile_range)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(T, k0 + BKV - 1 + window) : T;
  const int qt_begin = q_lo / BQ, qt_end = (q_hi + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x >= 288) return;  // one producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int kb = 0; kb < C::NB; ++kb) {
        tma_load_4d(sk + kb * C::KV_BLOCK, &map_k, kv_full, 64 * kb, k0, hk, b);
        tma_load_4d(sv + kb * C::KV_BLOCK, &map_v, kv_full, 64 * kb, k0, hk, b);
      }
    }
    RingPos r;
    for (int rep = 0; rep < n_rep; ++rep) {
      const int h = hk * n_rep + rep;
      const long long row_off = ((long long)b * Hq + h) * T;
      for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int q0 = qt * BQ;
        const uint32_t st = ring + r.stage * C::STAGE_BYTES, bar = full + 8 * r.stage;
        float* row_stats = stats + r.stage * 2 * BQ;
        mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
        // the tile's lse (to log2 units) and delta rows, 0 past T, by the whole warp; the
        // arrival below releases them to the consumers with the TMA's bytes
#pragma unroll
        for (int i = lane; i < BQ; i += 32) {
          const int t = q0 + i;
          row_stats[i] = t < T ? lse[row_off + t] * LOG2E : 0.f;
          row_stats[BQ + i] = t < T ? delta[row_off + t] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(bar, C::STAGE_BYTES);
#pragma unroll
          for (int kb = 0; kb < C::NB; ++kb) {
            tma_load_4d(st + kb * C::Q_BLOCK, &map_q, bar, 64 * kb, q0, h, b);
            tma_load_4d(st + C::TILE_BYTES + kb * C::Q_BLOCK, &map_do, bar, 64 * kb, q0, h, b);
          }
        }
        r.advance<STAGES>();
      }
    }
    return;
  }

  reg_alloc<232>();
  if (wg >= active_wgs) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int tq = lane % 4;
  // this warpgroup's 64 keys of the CTA's, and its columns of dK and dV
  const int key_wg = C::SPLIT == 2 ? 0 : wg, col0 = C::SPLIT == 2 ? DW * wg : 0;
  const int wg_lo = k0 + 64 * key_wg, wg_hi = wg_lo + 63;
  const int warp_lo = wg_lo + 16 * warp;                // this warp's 16 keys
  const int key = warp_lo + lane / 4;                   // this thread's keys: key, key + 8
  const float qk_scale = scale * LOG2E;
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
  bool key_ok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kp = key + 8 * rr;
    key_ok[rr] = kp < T && (mb == nullptr || mb[kp] != 0);
  }
  const bool keys_all_ok = __all_sync(0xffffffffu, key_ok[0] && key_ok[1]);

  float acc_dk[DW / 2], acc_dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }

  mbar_wait(kv_full, 0);
  RingPos r;
  for (int rep = 0; rep < n_rep; ++rep) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const uint32_t st = ring + r.stage * C::STAGE_BYTES;
      const float* row_stats = stats + r.stage * 2 * BQ;
      mbar_wait(full + 8 * r.stage, r.phase);
      // no query of the tile sees a key of this warpgroup
      const bool outside = (causal && q0 + BQ - 1 < wg_lo) || (window > 0 && q0 >= wg_hi + window);
      if (!outside) {
        // S^T = K Q^T and dP^T = V dO^T: [64 keys x 64 queries] each
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < C::KSTEPS; ++kd) {
          const uint32_t a_off = (kd / 4) * C::KV_BLOCK + key_wg * 8192 + 32 * (kd % 4);
          const uint32_t b_off = (kd / 4) * C::Q_BLOCK + 32 * (kd % 4);
          WgmmaSS<BQ, 0>::run(s, smem_desc(sk + a_off, 16, 1024), smem_desc(st + b_off, 16, 1024),
                              kd != 0);
          WgmmaSS<BQ, 0>::run(dp, smem_desc(sv + a_off, 16, 1024),
                              smem_desc(st + C::TILE_BYTES + b_off, 16, 1024), kd != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P^T = exp2(S^T - lse) on valid pairs (0 elsewhere, set explicitly: the lse of a
        // query with no valid key is only "very negative"), dS^T = P^T (dP^T - delta);
        // P once and dS as hi + lo rounded to bf16, in wgmma's A-operand places. The
        // thread's queries of a tile are columns 8 j + 2 tq + e.
        const bool masked = !keys_all_ok || q0 + BQ > T || (causal && q0 < warp_lo + 15) ||
                            (window > 0 && q0 + BQ - 1 >= warp_lo + window);
        // the columns (queries relative to q0) that each of the thread's keys may pair with
        int c_lo[2], c_hi[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int kp = key + 8 * rr;
          c_lo[rr] = causal ? kp - q0 : 0;
          c_hi[rr] = window > 0 ? min(T - 1, kp + window - 1) - q0 : T - 1 - q0;
          if (!key_ok[rr]) c_hi[rr] = -1;
        }
        uint32_t pa[BQ / 16][4], ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(row_stats + 8 * j + 2 * tq);
          const float2 dl = *reinterpret_cast<const float2*>(row_stats + BQ + 8 * j + 2 * tq);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * rr + e, c = 8 * j + 2 * tq + e;
              p[e] = ex2(fmaf(s[i], qk_scale, -(e ? l2.y : l2.x)));
              if (masked) p[e] = (c >= c_lo[rr]) & (c <= c_hi[rr]) ? p[e] : 0.f;
              ds[e] = p[e] * (dp[i] - (e ? dl.y : dl.x));
            }
            const int slot = (j % 2) * 2 + rr;
            pa[j / 2][slot] = pack_bf16(p[0], p[1]);
            const uint32_t hi = pack_bf16(ds[0], ds[1]);
            ds_hi[j / 2][slot] = hi;
            ds_lo[j / 2][slot] = pack_bf16(ds[0] - bf16_lo(hi), ds[1] - bf16_hi(hi));
          }
        }

        // dV += P^T dO, dK += (dS_hi + dS_lo)^T Q; dO and Q are read from the same boxes as
        // MN-major B operands, from this warpgroup's first 64-column block on
        const uint32_t b_off = (col0 / 64) * C::Q_BLOCK;
        fence_regs(acc_dk);
        fence_regs(acc_dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t b_do =
              smem_desc(st + C::TILE_BYTES + b_off + 2048 * kk, C::Q_BLOCK, 1024);
          const uint64_t b_q = smem_desc(st + b_off + 2048 * kk, C::Q_BLOCK, 1024);
          WgmmaRS<DW, 1>::run(acc_dv, pa[kk], b_do, 1);
          WgmmaRS<DW, 1>::run(acc_dk, ds_hi[kk], b_q, 1);
          WgmmaRS<DW, 1>::run(acc_dk, ds_lo[kk], b_q, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dk);
        fence_regs(acc_dv);
        keep_regs(pa);
        keep_regs(ds_hi);
        keep_regs(ds_lo);
      }
      if (lane == 0) mbar_arrive(empty + 8 * r.stage);
      r.advance<STAGES>();
    }
  }

  // epilogue: dK = scale * acc, dV = acc, as bf16, the thread's two keys and its
  // warpgroup's columns
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kp = key + 8 * rr;
    if (kp >= T) continue;
    bf16* dkb = dk + b * sdkb + kp * sdkt + hk * sdkh + col0 + 2 * tq;
    bf16* dvb = dv + b * sdvb + kp * sdvt + hk * sdvh + col0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkb + 8 * j) =
          pack_bf16(acc_dk[4 * j + 2 * rr] * scale, acc_dk[4 * j + 2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + 8 * j) =
          pack_bf16(acc_dv[4 * j + 2 * rr], acc_dv[4 * j + 2 * rr + 1]);
    }
  }
}

// maps: q, k, v, dout, 11 numbers each (tensor_map.cuh:make_map_4d); s: the 18 strides of
// the entry point, of which dk's and dv's are used
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask,
                   const void* dout, const void* lse, const void* delta, void* dk_out,
                   void* dv_out, int B, int T, int Hq, int Hkv, const long long* s,
                   const long long* maps, int bk, int bq, float scale, int causal, int window,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  if (bk != C::BKV || bq != C::BQ) return cudaErrorInvalidValue;  // the wrapper's plan is another
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tmap::make_map_4d(&map_q, q, maps) || !tmap::make_map_4d(&map_k, k, maps + 11) ||
      !tmap::make_map_4d(&map_v, v, maps + 22) || !tmap::make_map_4d(&map_do, dout, maps + 33))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((T + C::BKV - 1) / C::BKV, Hkv, B);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const int*>(kv_mask),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk_out),
      static_cast<bf16*>(dv_out), T, Hq, Hkv, s[12], s[13], s[14], s[15], s[16], s[17], scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace dkv

}  // namespace

// strides: (b, t, h) in elements for q, k, v, dout, dk, dv (18 values); maps: the 4-D
// tensor maps of q, k, v, dout (4 x 11 numbers, ops/flash_attention.py:tensor_map_plan) for
// tiles of bk keys and bq queries (ops/flash_attention.py:dkv_plan)
extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* kv_mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int B, int T, int Hq, int Hkv, int D,
                                       const long long* strides, const long long* maps, int bk,
                                       int bq, float scale, int causal, int window,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)dkv::launch<64>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                  strides, maps, bk, bq, scale, causal, window, st);
    case 72:
      return (int)dkv::launch<72>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                  strides, maps, bk, bq, scale, causal, window, st);
    case 128:
      return (int)dkv::launch<128>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                   strides, maps, bk, bq, scale, causal, window, st);
    case 256:
      return (int)dkv::launch<256>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                   strides, maps, bk, bq, scale, causal, window, st);
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
