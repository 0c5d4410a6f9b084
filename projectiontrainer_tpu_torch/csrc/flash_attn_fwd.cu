// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + fp32 log-sum-exp.
//
// Replaces the TPU kernel projectiontrainer_tpu/ops/flash_attention.py:_fwd_kernel
// (launched from _fwd) and, through a strided [B, T, H, D] view of the head-merged
// tensors, :_fwd_lanes_kernel. Same contract: online softmax in the exp2 domain, fp32
// running max / sum / output accumulator, causal (tiles above the diagonal are
// skipped), sliding window (tiles below it are skipped), per-batch key padding mask,
// GQA (query head h reads kv head h / n_rep), and rows with no valid key give 0.
//
// What bounds it on the H100: the two products, 4 * pairs * D operations a head against
// one read of q, k, v and one write of o, so the tensor cores from T ~ 300 up; and next
// to them the softmax's exponentials on the SM's 16-a-clock special-function unit, which
// at D = 64 take as many clocks as both products of a tile together. At the main paths'
// shapes the kernel runs at 3.5 (D = 72, T = 1024) to 5.5 (D = 64, T = 576) times its
// bound: a warpgroup's own softmax and products do not overlap, and a CTA of five to
// eight K/V tiles pays its prologue (tensor maps, Q, the first stage) and epilogue alone
// on its SM.
//
// Design. A CTA owns 128 query rows of one (batch, query head): two consumer
// warpgroups of 64 rows each and one producer thread (setmaxnreg moves the producer
// warpgroup's registers to the consumers: 40 / 232). The producer keeps TMA loads of K
// and V tiles (128 keys; 64 at D = 256) in flight into a ring of shared-memory stages
// (4 at D = 64, 3 at 72 and 128, 2 at 256: what 227 KB hold), each with a "full"
// mbarrier that the TMA unit completes and an "empty" one on which every consumer warp
// arrives when its wgmma reads of the stage are done; every wait traps after ~2 s, so a
// ring fault is a CUDA error and not a hang. There is no block-wide barrier after the
// set-up. Both products are wgmma.mma_async with fp32 accumulators in registers:
//   S = Q K^T   A = the Q tile, B = the K tile, both K-major in the 128-byte-swizzled
//               layout the TMA unit writes (blocks of [rows x 64 columns]);
//   softmax     on S in registers: a row lives in the 4 lanes of a quad, so its max is
//               two shuffles; the sums stay per thread until the epilogue;
//   O += P V    P rounded to bf16 in registers is the A operand (an accumulator's
//               registers are already in A's places); the V tile is read as an MN-major B
//               operand, wgmma's transposed form, so V is never transposed.
// No score, no P and no O passes through shared memory; O is scaled and written from
// the registers. At D = 512 a warpgroup's O of 64 rows would be 256 registers a thread:
// there a CTA owns 64 query rows, both warpgroups compute S and the softmax of all of
// them (the same bits) and each keeps one half of O's columns (128 registers), with
// 32-key stages (Q 64 KB and two stages of K and V, 192 KB). The two warpgroups are not synchronised with each other, so one's
// softmax runs under the other's products. Each (128-row tile, query head, batch) is a
// CTA of its own, the last tiles first; the query heads of one KV head are neighbours in
// the grid, so their K/V reads meet in L2, and they are not packed into one CTA's rows.
//
// The tensors are read as they lie, [B, T, H, D] with any (16-byte aligned) strides,
// through one 4-D tensor map each, dims (D, T, H, B): a box that runs past T or past D
// is zero-filled by the TMA unit and never reaches the next head's or batch's rows.
// That is also what serves D = 72 (so400m): the second 64-column box of a row holds
// columns 64..71 and zeros, so the fifth k-step of Q K^T (columns 64..79) adds zeros,
// and O's width is wgmma's n = 72. The scale stays the caller's (72^-0.5) and nothing is
// padded on the host.
//
// Masks. NEG_INF is finite, so for a row with no valid key m = NEG_INF and
// exp2(s - m) = 1: invalid probabilities are set to 0 explicitly and the output is
// divided by max(u, 1e-30), so left-padded query rows come out as exactly 0. A warp
// learns which keys of a tile are inside T and unpadded from one coalesced read of the
// mask and a ballot (32 keys a word); only a tile with a masked key, or one that crosses
// the diagonal or the window's edge for this warpgroup's rows, takes the per-element
// path. A warpgroup skips the tiles that lie wholly outside its own rows' range.
//
// The three rules of precision (found on the card, on tokens that are nearly alike):
// O is divided by the sum of the bf16-rounded weights that the PV product applied (u),
// so its weights sum to 1 and V's common part passes through exactly; lse = m + log(l)
// with l the fp32 sum of the unrounded weights, so the backward's exp(S - lse) sums to
// 1; and in training the kernel also writes O in fp32 (out_f32, dense [B, T, Hq, D];
// null skips it), from which the backward takes delta = rowsum(dO * O).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W with kernels/check_flash_attn.py --time
// (ms a launch, launches queued so that the host's share is out; the variants on builds
// that were not kept), at [16,1024,16,72] / [8,576,16,64] / the left-padded prefill
// [8,831,4|1,256], causal, no window:
//   this kernel                                            0.275 / 0.061 / 0.055
//   the WMMA kernel it replaces (one 64-row CTA of 4 warps, S, P and O through shared
//   memory, one K/V tile, no copy in flight), timed a launch at a time
//                                          2.975 / 0.643 / 0.939 (with a window of 512)
//   scaled_dot_product_attention's flash backend           0.362 / 0.058 / refused
// Tried and taken out:
//   - a warpgroup's softmax of tile i + 1 under its own O += P V of tile i (S of the next
//     tile started before the product, FlashAttention-3's second overlap): 0.308 / 0.068 /
//     0.071, and 40 bytes of spills at D = 128;
//   - the same with the two warpgroups taking turns at the tensor cores through two
//     named barriers (its first overlap): 0.309 / 0.067 / 0.071;
//   - two stages instead of three at D = 72 and 128: 0.317 against 0.309 at D = 72, both
//     timed a launch at a time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_map.cuh"
#include "wgmma_sm90.cuh"

using namespace sm90;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; warpgroup 2: the producer thread
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  // At D = 512 the two warpgroups share the CTA's 64 rows and split O's columns
  static constexpr int SPLIT = D > 256 ? 2 : 1;
  static constexpr int BQ = 128 / SPLIT;         // query rows a CTA
  static constexpr int DW = D / SPLIT;           // O's columns a warpgroup
  static constexpr int NB = (D + 63) / 64;       // 64-column blocks (TMA boxes) of a row
  static constexpr int KSTEPS = (D + 15) / 16;   // k-steps of Q K^T (zero columns past D)
  static constexpr int BK = D > 256 ? 32 : (D > 128 ? 64 : 128);  // keys a stage
  static constexpr int STAGES = D <= 64 ? 4 : (D <= 128 ? 3 : 2);
  static constexpr int Q_BLOCK = BQ * 128;       // bytes of one 64-column block of the Q tile
  static constexpr int KV_BLOCK = BK * 128;      // ... of a K or V tile
  static constexpr int Q_BYTES = NB * Q_BLOCK;
  static constexpr int TILE_BYTES = NB * KV_BLOCK;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K, then V
  static constexpr size_t SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024 + 8 * (2 * STAGES + 1);
  static_assert(SMEM <= 232448, "shared memory of one SM");
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The thread's scores of row r of its warp's 16 (r = 0: row l / 4, r = 1: that + 8) are
// s[4 j + 2 r + e], column 8 j + 2 (l % 4) + e of the tile.

// The tile's scores of one warpgroup, in place: s -> P (fp32, unnormalised), with the
// running max, the thread's part of the running fp32 sum and corr, the factor by which
// the older sums and O shrink. Bit 2 j + e of valid[r] says whether that pair may be
// used (MASKED tiles only).
template <int BK, bool MASKED>
__device__ __forceinline__ void exp_tile(float (&s)[BK / 2], float (&m_run)[2], float (&l_run)[2],
                                         float (&corr)[2], const uint32_t (&valid)[2],
                                         float qk_scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        if (MASKED) s[i] = (valid[r] >> (2 * j + e)) & 1 ? s[i] * qk_scale : NEG_INF;
        mx = fmaxf(mx, s[i]);
      }
    }
    if (!MASKED) mx *= qk_scale;  // qk_scale > 0: the max of the scaled scores
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        if (MASKED) {
          // explicit zero: with m_new = NEG_INF the exponent of a masked pair is 0
          s[i] = (valid[r] >> (2 * j + e)) & 1 ? ex2(s[i] - m_new) : 0.f;
        } else {
          s[i] = ex2(fmaf(s[i], qk_scale, -m_new));
        }
        sum += s[i];
      }
    }
    corr[r] = ex2(m_run[r] - m_new);
    l_run[r] = l_run[r] * corr[r] + sum;
    m_run[r] = m_new;
  }
}

// P rounded to bf16 into wgmma's A-operand places, and the thread's part of the running
// sum of the rounded weights (what the PV product applies)
template <int BK>
__device__ __forceinline__ void pack_tile(const float (&p)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                          float (&u_run)[2], const float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float used = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t packed = pack_bf16(p[4 * j + 2 * r], p[4 * j + 2 * r + 1]);
      used += bf16_lo(packed) + bf16_hi(packed);
      pa[j / 2][(j % 2) * 2 + r] = packed;
    }
    u_run[r] = u_run[r] * corr[r] + used;
  }
}

// exp_tile on the tile at k0 for the warpgroup's rows wg_lo .. wg_hi: the per-element path
// only where a key is masked or the tile crosses the diagonal or the window's edge.
// key_ok: this lane's key of each 32 of the tile (inside T and unpadded).
template <int BK>
__device__ __forceinline__ void score_tile(float (&s)[BK / 2], float (&m_run)[2],
                                           float (&l_run)[2], float (&corr)[2],
                                           const int (&key_ok)[BK / 32], int k0, int row, int tq,
                                           int wg_lo, int wg_hi, int causal, int window,
                                           float qk_scale) {
  uint32_t words[BK / 32];
  bool masked = (causal && k0 + BK - 1 > wg_lo) || (window > 0 && k0 <= wg_hi - window);
#pragma unroll
  for (int w = 0; w < BK / 32; ++w) {
    words[w] = __ballot_sync(0xffffffffu, key_ok[w] != 0);
    masked = masked || words[w] != 0xffffffffu;
  }
  uint32_t valid[2] = {0, 0};
  if (!masked) {
    exp_tile<BK, false>(s, m_run, l_run, corr, valid, qk_scale);
    return;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int q_pos = row + 8 * rr;
    // the thread's keys relative to k0 that this row may see: [lo, hi]
    const int hi = causal ? q_pos - k0 : BK;
    const int lo = window > 0 ? q_pos - window + 1 - k0 : 0;
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e;
        const uint32_t ok = (words[j / 4] >> (8 * (j % 4) + 2 * tq + e)) & (c <= hi) & (c >= lo);
        bits |= ok << (2 * j + e);
      }
    }
    valid[rr] = bits;
  }
  exp_tile<BK, true>(s, m_run, l_run, corr, valid, qk_scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const int* __restrict__ kv_mask,
                 bf16* __restrict__ out, float* __restrict__ lse, float* __restrict__ out_f32,
                 int T, int Hq, int Hkv, long long sob, long long sot, long long soh,
                 float scale, int causal, int window) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES, DW = C::DW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = smem_addr(align_1024(smem_raw));
  const uint32_t ring = sq + C::Q_BYTES;
  const uint32_t full = ring + STAGES * C::STAGE_BYTES, empty = full + 8 * STAGES;
  const uint32_t q_full = empty + 8 * STAGES;

  // the last query tiles first: under a causal mask they hold the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // a warpgroup whose rows all lie past T leaves
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

  // the K/V tiles this CTA's rows can see (ops/flash_attention.py:kv_tile_range)
  int kt_end = (T + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int kb = 0; kb < C::NB; ++kb)
      tma_load_4d(sq + kb * C::Q_BLOCK, &map_q, q_full, 64 * kb, q0, h, b);
    RingPos r;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const uint32_t st = ring + r.stage * C::STAGE_BYTES, bar = full + 8 * r.stage;
      mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
      mbar_expect_tx(bar, C::STAGE_BYTES);
#pragma unroll
      for (int kb = 0; kb < C::NB; ++kb) {
        tma_load_4d(st + kb * C::KV_BLOCK, &map_k, bar, 64 * kb, kt * BK, hk, b);
        tma_load_4d(st + C::TILE_BYTES + kb * C::KV_BLOCK, &map_v, bar, 64 * kb, kt * BK, hk, b);
      }
      r.advance<STAGES>();
    }
    return;
  }

  reg_alloc<232>();
  if (wg >= active_wgs) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int tq = lane % 4;
  // this warpgroup's 64 rows of the CTA's, and its columns of O
  const int row_wg = C::SPLIT == 2 ? 0 : wg, col0 = C::SPLIT == 2 ? DW * wg : 0;
  const int wg_lo = q0 + 64 * row_wg, wg_hi = wg_lo + 63;
  const int row = wg_lo + 16 * warp + lane / 4;         // this thread's rows: row, row + 8
  const float qk_scale = scale * LOG2E;                 // exp2 domain
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  float o[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) o[i] = 0.f;
  // per row: running max (log2 domain), this thread's part of the fp32 sum of the
  // weights (for lse) and of the sum of their bf16 roundings (what PV applies, for O)
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, u_run[2] = {0.f, 0.f};

  // this lane's key of each 32 of the tile at kt: inside T and unpadded
  auto load_key_ok = [&](int (&key_ok)[BK / 32], int kt) {
#pragma unroll
    for (int w = 0; w < BK / 32; ++w) {
      const int kp = kt * BK + 32 * w + lane;
      key_ok[w] = kp < T ? (mb ? mb[kp] : 1) : 0;
    }
  };
  // S = Q K^T on the stage at rp, one group
  auto start_scores = [&](float (&s)[BK / 2], const RingPos& rp) {
    const uint32_t st = ring + rp.stage * C::STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < C::KSTEPS; ++kd)
      WgmmaSS<BK, 0>::run(
          s, smem_desc(sq + (kd / 4) * C::Q_BLOCK + row_wg * 8192 + 32 * (kd % 4), 16, 1024),
          smem_desc(st + (kd / 4) * C::KV_BLOCK + 32 * (kd % 4), 16, 1024), kd != 0);
    wgmma_commit();
  };
  // a tile that lies wholly outside this warpgroup's rows' range is only handed back
  auto pass = [&](RingPos& rp) {
    mbar_wait(full + 8 * rp.stage, rp.phase);
    if (lane == 0) mbar_arrive(empty + 8 * rp.stage);
    rp.advance<STAGES>();
  };

  // the tiles that this warpgroup's own rows can see
  const int wg_begin = window > 0 ? max(kt_begin, max(0, wg_lo - window + 1) / BK) : kt_begin;
  const int wg_end = causal ? min(kt_end, wg_hi / BK + 1) : kt_end;

  mbar_wait(q_full, 0);
  RingPos r;
  for (int kt = kt_begin; kt < wg_begin; ++kt) pass(r);

  for (int kt = wg_begin; kt < wg_end; ++kt) {
    float s[BK / 2], corr[2];
    uint32_t pa[BK / 16][4];
    int key_ok[BK / 32];
    load_key_ok(key_ok, kt);
    mbar_wait(full + 8 * r.stage, r.phase);
    start_scores(s, r);
    wgmma_wait<0>();
    fence_regs(s);
    score_tile<BK>(s, m_run, l_run, corr, key_ok, kt * BK, row, tq, wg_lo, wg_hi, causal, window,
                   qk_scale);
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o[i] *= corr[(i / 2) % 2];
    pack_tile<BK>(s, pa, u_run, corr);
    // V from this warpgroup's first 64-column block on
    const uint32_t sv = ring + r.stage * C::STAGE_BYTES + C::TILE_BYTES + (col0 / 64) * C::KV_BLOCK;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<DW, 1>::run(o, pa[kk], smem_desc(sv + 2048 * kk, C::KV_BLOCK, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    keep_regs(pa);
    if (lane == 0) mbar_arrive(empty + 8 * r.stage);
    r.advance<STAGES>();
  }
  for (int kt = wg_end; kt < kt_end; ++kt) pass(r);

  // epilogue: out = O / max(u, 1e-30); lse = m + log(l) in natural-log units
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr], u = u_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    const int q_pos = row + 8 * rr;
    if (q_pos >= T) continue;
    const float inv = 1.f / fmaxf(u, 1e-30f);
    bf16* ob = out + b * sob + q_pos * sot + h * soh + col0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + 8 * j) =
          pack_bf16(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    if (out_f32) {
      float* of = out_f32 + (((long long)b * T + q_pos) * Hq + h) * D + col0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j)
        *reinterpret_cast<float2*>(of + 8 * j) =
            make_float2(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    }
    if (tq == 0 && col0 == 0)
      lse[((long long)b * Hq + h) * T + q_pos] = m_run[rr] * LN2 + logf(fmaxf(l, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *kv_mask;
  void *out, *lse, *out_f32;
  int B, T, Hq, Hkv;
  const long long* maps;  // q, k, v: 11 numbers each (tensor_map.cuh:make_map_4d)
  int bq, bk;
  long long sob, sot, soh;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  using C = Cfg<D>;
  if (a.bq != C::BQ || a.bk != C::BK) return cudaErrorInvalidValue;  // the wrapper's plan is another
  CUtensorMap map_q, map_k, map_v;
  if (!tmap::make_map_4d(&map_q, a.q, a.maps) || !tmap::make_map_4d(&map_k, a.k, a.maps + 11) ||
      !tmap::make_map_4d(&map_v, a.v, a.maps + 22))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + C::BQ - 1) / C::BQ, a.Hq, a.B);
  flash_fwd_kernel<D><<<grid, THREADS, C::SMEM, a.stream>>>(
      map_q, map_k, map_v, static_cast<const int*>(a.kv_mask), static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.out_f32), a.T, a.Hq, a.Hkv, a.sob, a.sot,
      a.soh, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

}  // namespace

// q [B, T, Hq, D], k and v [B, T, Hkv, D] bf16 with any 16-byte aligned strides, described
// by `maps` (3 x 11 numbers: dims, byte strides and box of each tensor's 4-D tensor map,
// planned by ops/flash_attention.py:tensor_map_plan for tiles of bq query rows and bk
// keys); kv_mask [B, T] int32 or null -> out [B, T, Hq, D] bf16 (strides sob, sot, soh in
// elements), lse [B, Hq, T] fp32, out_f32 dense [B, T, Hq, D] fp32 or null.
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* kv_mask, void* out, void* lse, void* out_f32,
                                   int B, int T, int Hq, int Hkv, int D, const long long* maps,
                                   int bq, int bk, long long sob, long long sot, long long soh,
                                   float scale, int causal, int window, void* stream) {
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, kv_mask, out, lse, out_f32, B, T, Hq, Hkv, maps, bq, bk,
               sob, sot, soh, scale, causal, window, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64:
      return (int)launch<64>(a);
    case 72:
      return (int)launch<72>(a);
    case 128:
      return (int)launch<128>(a);
    case 256:
      return (int)launch<256>(a);
    case 512:
      return (int)launch<512>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
