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
// dK, ~10 * B * Hq * T^2 * D operations before causal/window skipping; dQ: S, dP and two
// terms of dQ, ~8) against ~B * T * (Hq + Hkv) * D * 2 * 4 bytes of operands: the tensor
// cores. The dK/dV kernel runs at 3.2 times its bound at [16, 1024, 16, 72] and at 9
// times at the decoder's [4, 1087, 4|1, 256] (68 CTAs for 132 SMs, and S^T and dP^T
// computed twice); the dQ kernel at 4.0 and 6 times (144 CTAs for 132 SMs there, and
// n = 32 products for S and dP).
//
// Both kernels have one shape: a CTA of two consumer warpgroups and one producer warp
// (setmaxnreg 232 / 40). The operand the CTA owns is loaded once by TMA and stays in
// shared memory; the other streams through a ring of stages that the producer warp fills
// by TMA; full / empty mbarriers, and every wait traps after ~2 s. All operands are read
// in the TMA unit's 128-byte-swizzled layout, as K-major A and B operands of the first
// two products and as MN-major B operands of the last ones, so nothing is transposed in
// shared memory. P and dS are formed on the accumulators in registers, rounded to bf16
// in wgmma's A-operand places, and fed to the next products from there. The results
// stay in registers until the epilogue writes them as bf16; each element is summed by
// one thread in program order, so a rerun gives the same bits.
// The 4-D tensor maps (D, T, H, B) over the strided tensors zero-fill past T and past D:
// head dim 72 takes five k-steps over a zero-filled second box and wgmma's n = 72.
//
// - dK/dV (namespace dkv). One CTA owns 128 keys of one (batch, KV head), 64 a
//   warpgroup; K and V stay in shared memory; the Q and dO tiles of 64 queries (32 from
//   D = 128 up) stream through a ring of 3 (4) stages, with the tile's lse (in log2
//   units) and delta rows that the producer warp writes beside them. The tiles are
//   computed transposed: S^T = K Q^T and dP^T = V dO^T (A = K or V, B = Q or dO), then
//   dV += P^T dO and dK += dS_hi^T Q + dS_lo^T Q. dK and dV are [64, D] fp32 each a
//   warpgroup, 64 + 64 registers a thread at D = 128.
//   At D = 256 dK and dV of 64 keys would be 256 registers a thread: there the CTA owns
//   64 keys, both warpgroups compute S^T and dP^T of all of them (two of the five
//   products done twice) and each keeps one half of the columns of dK and dV, reading
//   its half of the dO and Q boxes. No warpgroup waits for the other. At D = 512 the
//   columns of dK and dV are cut once more, over two CTAs a key tile (grid x = key
//   tiles x 2): each CTA computes S^T and dP^T of its 64 keys over all 512 columns and its
//   warpgroups keep 128 columns each (the products S^T and dP^T done four times), with
//   one stage of 32 queries (K and V 128 KB, Q and dO 64 KB).
//   Measured (NVIDIA H100 80GB HBM3, 700 W; kernels/check_flash_attn.py --time, ms a
//   launch with the host's share out; the kernel it replaced / the library's whole
//   backward, dq, dk and dv together, beside it): [16, 1024, 16, 72] 0.502 (4.300 timed
//   a launch at a time / 1.139); decoder [4, 1087, 4|1, 256] causal, window 512,
//   right-padded 0.121 (0.696 / 1.358, its math backend); prefill shape [8, 831, 4|1,
//   256] left-padded 0.124 (1.148 / 1.475); merged [2, 1024, 8 * 128] 0.054 (0.091).
//   Tried and taken out: 64 queries a stage at D = 128 (12-28 bytes of spills at 232 and
//   at 240 registers; 0.077 against 0.085 ms at the merged shape, timed a launch at a
//   time); 240 / 24 registers (4-12 bytes of spills at every head dim: the producer
//   warp's address arithmetic does not fit 24; same times).
// - GQA in dK/dV: the CTA loops over the n_rep query heads that read its KV head and
//   accumulates all of them into the same accumulators: no fp32 per-query-head buffer
//   and no reduction afterwards (JAX writes fp32 dK/dV per query head and sums them
//   outside its kernel). At 8 query heads on 2 KV heads and B * T = 2048 that is 32 CTAs
//   for 132 SMs (0.171 ms against 0.054 with 8 KV heads).
// - dQ (namespace dq). One CTA owns 128 queries of one (batch, query head), 64 a
//   warpgroup; Q and dO stay in shared memory, and each thread keeps the lse (in log2
//   units) and delta of its two query rows in registers; the K and V tiles of the key
//   range the CTA's queries see (ops/flash_attention.py:kv_tile_range) stream through a
//   ring of 3 stages, 64 keys each (32 at D = 256), with the tile's key-mask bits that
//   the producer warp writes beside them. S = Q K^T and dP = dO V^T (A = Q or dO, B = K
//   or V), then dQ += dS_hi K + dS_lo K with the same K box read as the MN-major B
//   operand. dQ is [64, D] fp32 a warpgroup: D / 2 registers a thread, 128 at D = 256,
//   where S and dP of 64 keys would not fit beside it: hence the 32-key stages there. At
//   D = 512 dQ of 64 queries would be 256 registers: a CTA owns 64 queries, both
//   warpgroups compute S and dP of all of them and each keeps half of dQ's columns, with
//   one stage of 32 keys (Q and dO 128 KB, K and V 64 KB). GQA:
//   query head h reads KV head h / n_rep; each dQ row belongs to one CTA.
//   Measured (NVIDIA H100 80GB HBM3, 700 W; kernels/check_flash_attn.py --time and
//   chip_smoke.py phase 2, device ms; the kernel it replaced, whose S and dP went through
//   fp32 shared memory, / the library's whole backward beside it): [16, 1024, 16, 72]
//   0.465 (2.809 / 1.139); decoder [4, 1087, 4|1, 256] causal, right-padded, window 512
//   0.059-0.061 (0.542 / 1.367), no window 0.082-0.085 (0.891 / 1.368); prefill shape
//   [8, 831, 4|1, 256] left-padded, window 512 0.086, none 0.099 (library 1.484); merged
//   [2, 1024, 8 * 128] 0.043 (0.489 / 0.091). ptxas: 168 registers at launch, 0 bytes of
//   spills at all four head dims.
// - Masking: the lse of a query row with no valid key is only "very negative" (the
//   finite NEG_INF of the forward), so exp2(s - lse) would overflow there. P is set
//   to 0 explicitly wherever the (query, key) pair is invalid, on the per-element path
//   that only tiles holding such a pair take (one ballot of the key mask a tile, and the
//   tile's place against the diagonal, the window's edge and T). Tiles outside the
//   causal / window range of a warpgroup's queries are skipped by it; rows past T are
//   zero-filled on load and never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_map.cuh"
#include "wgmma_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------- dK/dV on wgmma (head dims 64, 72, 128, 256, 512)

namespace dkv {

using namespace sm90;

constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; warp 8: the producer

template <int D>
struct Cfg {
  // At D = 256 dK and dV of 64 keys are 256 registers a thread for one warpgroup: the two
  // warpgroups then share the CTA's 64 keys (each computes S^T and dP^T of all of them)
  // and own one half of the columns of dK and dV each.
  static constexpr int SPLIT = D > 128 ? 2 : 1;
  // At D = 512 two CTAs share a key tile, each with one half of the columns
  static constexpr int COLS = D > 256 ? 2 : 1;
  static constexpr int BKV = 128 / SPLIT;         // keys a CTA
  static constexpr int DW = D / SPLIT / COLS;     // columns of dK and dV a warpgroup
  // queries a ring stage: with dK and dV at 128 registers a thread, 64-query S^T and dP^T
  // (64 more) spilled 12-28 bytes at 232 and 240 registers
  static constexpr int BQ = DW > 72 ? 32 : 64;
  static constexpr int STAGES = D > 256 ? 1 : (DW > 72 ? 4 : 3);
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

  const int k0 = blockIdx.x / C::COLS * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int cta_col0 = blockIdx.x % C::COLS * (D / C::COLS);  // this CTA's columns
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
  const int key_wg = C::SPLIT == 2 ? 0 : wg, col0 = cta_col0 + (C::SPLIT == 2 ? DW * wg : 0);
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
  dim3 grid((T + C::BKV - 1) / C::BKV * C::COLS, Hkv, B);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const int*>(kv_mask),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk_out),
      static_cast<bf16*>(dv_out), T, Hq, Hkv, s[12], s[13], s[14], s[15], s[16], s[17], scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace dkv

// ---------------------------------------------- dQ on wgmma (head dims 64, 72, 128, 256, 512)

namespace dq {

using namespace sm90;

constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; warp 8: the producer

template <int D>
struct Cfg {
  // At D = 512 the two warpgroups share the CTA's 64 queries and split dQ's columns
  static constexpr int SPLIT = D > 256 ? 2 : 1;
  static constexpr int BQ = 128 / SPLIT;  // queries a CTA: 64 a warpgroup
  static constexpr int DW = D / SPLIT;    // columns of dQ a warpgroup
  // keys a ring stage: dQ is DW / 2 registers a thread, S and dP BK / 2 each
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int STAGES = D > 256 ? 1 : 3;
  static constexpr int NB = (D + 63) / 64;      // 64-column blocks (TMA boxes) of a row
  static constexpr int KSTEPS = (D + 15) / 16;  // k-steps over D (zero columns past D)
  static constexpr int Q_BLOCK = BQ * 128;      // bytes of one 64-column block of Q or dO
  static constexpr int KV_BLOCK = BK * 128;     // ... of a K or V tile
  static constexpr int Q_BYTES = NB * Q_BLOCK;
  static constexpr int KV_BYTES = NB * KV_BLOCK;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K, then V
  static constexpr int MASK_WORDS = BK / 32;        // key-mask bits of a tile, 2 words a stage
  static constexpr size_t SMEM = 2 * Q_BYTES + STAGES * (STAGE_BYTES + 8) + 1024 +
                                 8 * (2 * STAGES + 1);
  static_assert(SMEM <= 232448, "shared memory of one SM");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const int* __restrict__ kv_mask, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq,
                          int T, int Hq, int Hkv, long long sdqb, long long sdqt, long long sdqh,
                          float scale, int causal, int window) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sq = smem_addr(smem), sdo = sq + C::Q_BYTES, ring = sdo + C::Q_BYTES;
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(smem + 2 * C::Q_BYTES + STAGES * C::STAGE_BYTES);
  const uint32_t full = ring + STAGES * (C::STAGE_BYTES + 8);
  const uint32_t empty = full + 8 * STAGES, q_full = empty + 8 * STAGES;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // a warpgroup whose queries all lie past T leaves
  const int active_wgs = C::SPLIT == 2 || q0 + 64 < T ? 2 : 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active_wgs);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the K/V tiles that a query of this CTA can see (ops/flash_attention.py:kv_tile_range)
  int kt_end = (T + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x >= 288) return;  // one producer warp
    const int lane = threadIdx.x % 32;
    const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int kb = 0; kb < C::NB; ++kb) {
        tma_load_4d(sq + kb * C::Q_BLOCK, &map_q, q_full, 64 * kb, q0, h, b);
        tma_load_4d(sdo + kb * C::Q_BLOCK, &map_do, q_full, 64 * kb, q0, h, b);
      }
    }
    RingPos r;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * BK;
      const uint32_t st = ring + r.stage * C::STAGE_BYTES, bar = full + 8 * r.stage;
      mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
      // one bit a key of the tile: inside T and not padded; lane 0 writes them and its
      // arrival below releases them to the consumers with the TMA's bytes
      uint32_t bits[C::MASK_WORDS];
#pragma unroll
      for (int w = 0; w < C::MASK_WORDS; ++w) {
        const int key = k0 + 32 * w + lane;
        bits[w] = __ballot_sync(0xffffffffu, key < T && (mb == nullptr || mb[key] != 0));
      }
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < C::MASK_WORDS; ++w) key_bits[2 * r.stage + w] = bits[w];
        mbar_expect_tx(bar, C::STAGE_BYTES);
#pragma unroll
        for (int kb = 0; kb < C::NB; ++kb) {
          tma_load_4d(st + kb * C::KV_BLOCK, &map_k, bar, 64 * kb, k0, hk, b);
          tma_load_4d(st + C::KV_BYTES + kb * C::KV_BLOCK, &map_v, bar, 64 * kb, k0, hk, b);
        }
      }
      r.advance<STAGES>();
    }
    return;
  }

  reg_alloc<232>();
  if (wg >= active_wgs) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int tq = lane % 4;
  constexpr int DW = C::DW;
  // this warpgroup's 64 queries, and its columns of dQ
  const int row_wg = C::SPLIT == 2 ? 0 : wg, col0 = C::SPLIT == 2 ? DW * wg : 0;
  const int wg_lo = q0 + 64 * row_wg;
  const int warp_lo = wg_lo + 16 * warp;   // this warp's 16
  const int row = warp_lo + lane / 4;      // this thread's queries: row, row + 8
  const float qk_scale = scale * LOG2E;
  const long long row_off = ((long long)b * Hq + h) * T;
  float lse2[2], dl[2];  // lse in log2 units and delta of the thread's rows, 0 past T
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = row + 8 * rr;
    lse2[rr] = qp < T ? lse[row_off + qp] * LOG2E : 0.f;
    dl[rr] = qp < T ? delta[row_off + qp] : 0.f;
  }

  float acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  RingPos r;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const uint32_t st = ring + r.stage * C::STAGE_BYTES;
    mbar_wait(full + 8 * r.stage, r.phase);
    // no key of the tile is seen by a query of this warpgroup
    const bool outside =
        (causal && k0 > wg_lo + 63) || (window > 0 && k0 + BK - 1 <= wg_lo - window);
    if (!outside) {
      // S = Q K^T and dP = dO V^T: [64 queries x BK keys] each
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < C::KSTEPS; ++kd) {
        const uint32_t a_off = (kd / 4) * C::Q_BLOCK + row_wg * 8192 + 32 * (kd % 4);
        const uint32_t b_off = (kd / 4) * C::KV_BLOCK + 32 * (kd % 4);
        WgmmaSS<BK, 0>::run(s, smem_desc(sq + a_off, 16, 1024), smem_desc(st + b_off, 16, 1024),
                            kd != 0);
        WgmmaSS<BK, 0>::run(dp, smem_desc(sdo + a_off, 16, 1024),
                            smem_desc(st + C::KV_BYTES + b_off, 16, 1024), kd != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp2(S - lse) on valid pairs (0 elsewhere, set explicitly: the lse of a query
      // with no valid key is only "very negative"), dS = P (dP - delta), rounded to bf16
      // as hi + lo in wgmma's A-operand places. The thread's keys of the tile are columns
      // 8 j + 2 tq + e.
      uint32_t bits[C::MASK_WORDS];
      bool keys_all_ok = true;
#pragma unroll
      for (int w = 0; w < C::MASK_WORDS; ++w) {
        bits[w] = key_bits[2 * r.stage + w];
        keys_all_ok = keys_all_ok && bits[w] == 0xffffffffu;
      }
      const bool masked = !keys_all_ok || (causal && k0 + BK - 1 > warp_lo) ||
                          (window > 0 && k0 <= warp_lo + 15 - window);
      // the columns (keys relative to k0) that each of the thread's queries may pair with
      int c_lo[2], c_hi[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qp = row + 8 * rr;
        c_lo[rr] = window > 0 ? qp - window + 1 - k0 : 0;
        c_hi[rr] = causal ? qp - k0 : BK - 1;
      }
      uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * rr + e, c = 8 * j + 2 * tq + e;
            float p = ex2(fmaf(s[i], qk_scale, -lse2[rr]));
            if (masked)
              p = (c >= c_lo[rr]) & (c <= c_hi[rr]) & ((bits[j / 4] >> (c % 32)) & 1u) ? p : 0.f;
            ds[e] = p * (dp[i] - dl[rr]);
          }
          const int slot = (j % 2) * 2 + rr;
          const uint32_t hi = pack_bf16(ds[0], ds[1]);
          ds_hi[j / 2][slot] = hi;
          ds_lo[j / 2][slot] = pack_bf16(ds[0] - bf16_lo(hi), ds[1] - bf16_hi(hi));
        }
      }

      // dQ += (dS_hi + dS_lo) K; K is read from the same box as an MN-major B operand,
      // from this warpgroup's first 64-column block on
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b_k = smem_desc(st + (col0 / 64) * C::KV_BLOCK + 2048 * kk, C::KV_BLOCK, 1024);
        WgmmaRS<DW, 1>::run(acc, ds_hi[kk], b_k, 1);
        WgmmaRS<DW, 1>::run(acc, ds_lo[kk], b_k, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      keep_regs(ds_hi);
      keep_regs(ds_lo);
    }
    if (lane == 0) mbar_arrive(empty + 8 * r.stage);
    r.advance<STAGES>();
  }

  // epilogue: dQ = scale * acc as bf16, the thread's two rows
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = row + 8 * rr;
    if (qp >= T) continue;
    bf16* out = dq + b * sdqb + qp * sdqt + h * sdqh + col0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2 * rr] * scale, acc[4 * j + 2 * rr + 1] * scale);
  }
}

// maps: q, k, v, dout, 11 numbers each (tensor_map.cuh:make_map_4d); s: the 15 strides of
// the entry point, of which dq's are used
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask,
                   const void* dout, const void* lse, const void* delta, void* dq_out, int B,
                   int T, int Hq, int Hkv, const long long* s, const long long* maps, int bq,
                   int bk, float scale, int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  if (bq != C::BQ || bk != C::BK) return cudaErrorInvalidValue;  // the wrapper's plan is another
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tmap::make_map_4d(&map_q, q, maps) || !tmap::make_map_4d(&map_k, k, maps + 11) ||
      !tmap::make_map_4d(&map_v, v, maps + 22) || !tmap::make_map_4d(&map_do, dout, maps + 33))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((T + C::BQ - 1) / C::BQ, Hq, B);
  flash_bwd_dq_wgmma_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const int*>(kv_mask),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq_out),
      T, Hq, Hkv, s[12], s[13], s[14], scale, causal, window);
  return cudaGetLastError();
}

}  // namespace dq

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
    case 512:
      return (int)dkv::launch<512>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                                   strides, maps, bk, bq, scale, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// strides: (b, t, h) in elements for q, k, v, dout, dq (15 values, of which dq's are
// used); maps: the 4-D tensor maps of q, k, v, dout (4 x 11 numbers) for tiles of bq
// queries and bk keys (ops/flash_attention.py:dq_plan)
extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* kv_mask, const void* dout, const void* lse,
                                      const void* delta, void* dq_out,
                                      int B, int T, int Hq, int Hkv, int D,
                                      const long long* strides, const long long* maps, int bq,
                                      int bk, float scale, int causal, int window,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)dq::launch<64>(q, k, v, kv_mask, dout, lse, delta, dq_out, B, T, Hq, Hkv,
                                 strides, maps, bq, bk, scale, causal, window, st);
    case 72:
      return (int)dq::launch<72>(q, k, v, kv_mask, dout, lse, delta, dq_out, B, T, Hq, Hkv,
                                 strides, maps, bq, bk, scale, causal, window, st);
    case 128:
      return (int)dq::launch<128>(q, k, v, kv_mask, dout, lse, delta, dq_out, B, T, Hq, Hkv,
                                  strides, maps, bq, bk, scale, causal, window, st);
    case 256:
      return (int)dq::launch<256>(q, k, v, kv_mask, dout, lse, delta, dq_out, B, T, Hq, Hkv,
                                  strides, maps, bq, bk, scale, causal, window, st);
    case 512:
      return (int)dq::launch<512>(q, k, v, kv_mask, dout, lse, delta, dq_out, B, T, Hq, Hkv,
                                  strides, maps, bq, bk, scale, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
