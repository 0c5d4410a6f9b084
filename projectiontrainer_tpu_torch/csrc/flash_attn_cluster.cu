// Flash attention at head dims above 512 for Hopper (sm_90a), split over a thread-block
// cluster: the forward (K1) at D <= 4096, dK/dV (K4) and dQ (K5) at D <= 8192, any multiple
// of 64 (the wrapper zero-pads the others), bf16 in and out, fp32 accumulation.
//
// Replaces the TPU kernels projectiontrainer_tpu/ops/flash_attention.py:_fwd_kernel,
// :_bwd_dkv_kernel and :_bwd_dq_kernel at those widths (the JAX kernels take any head dim:
// their K/V block is the whole [T, D] of a head). Past the reach (K1 above 4096, K4 and K5
// above 8192) flash_attn_wide.cu's column blocks run instead (ops/flash_attention.py:
// forward_plan, dkv_plan, dq_plan). Same contract as flash_attn_wide.cu: causal, sliding
// window, per-batch key padding mask, GQA, rows with no valid key give 0 and zero
// gradients, O divided by the sum of the bf16-rounded weights its product applied, lse =
// m + log(l) with l the fp32 sum of the unrounded weights (written by one warpgroup), the
// forward's fp32 copy of O for the backward's delta, and dS entering the dK and dQ
// products as hi + lo, two bf16 terms.
//
// What bounds it on the H100: the tensor cores (4 * pairs * D operations forward, 10 * pairs
// * D for dK/dV, 8 * pairs * D for dQ, against one read of the operands). Above 512 neither
// the 64-row operand tile nor its accumulators fit one SM, so the column-block kernels
// compute the scores (and dP) again for every 128 output columns: 9 products' worth where
// 2 would do at D = 1024 forward, 19 where 5 would do for dK/dV, 24 where 4 would do for
// dQ, on mma.sync with no copy in flight.
//
// Design: the head dim is cut over a cluster of C CTAs of two warpgroups (256 threads;
// thread 0, or warp 0 in K4, also issues the TMA loads into a ring of mbarrier stages and
// refills a stage once both warpgroups have handed it back). The D / 64 column blocks are
// dealt out to the W = 2 C warpgroups, D / 64 % W of them one block wider, so that the
// CTAs' shares differ by at most one block (640 = 192 + 128 | 192 + 128): K1's warpgroups
// own at most 256 columns of O (C = ceil(D / 512): O is 128 registers a thread, as at
// D = 512), K4's at most 128 of dK and of dV, K5's at most 128 of dQ (C = ceil(D / 256):
// K5's CTA keeps Q and dO of 64 rows, and at 256 columns a warpgroup those alone and one
// ring stage of K and V would fill 256 KB). A CTA loads only its warpgroups' blocks, from
// the same 4-D tensor maps as flash_attn_fwd.cu (the TMA unit zero-fills past T). A
// warpgroup runs its slice's part of the score contraction on wgmma: K1 S_w = Q[:, w]
// K[:, w]^T and K5 S_w and dP_w = dO[:, w] V[:, w]^T over TILE keys a tile, K4 S^T_w =
// K[:, w] Q[:, w]^T and dP^T_w = V[:, w] dO[:, w]^T over TILE queries a tile, fp32 in
// registers. The partials are summed over the cluster (Exchange below): each 16-byte
// chunk goes by st.async to the CTA that reduces it, CTA r sums its C-th of the tile over
// the W partials in slice order and sends the sum to every CTA, and each warpgroup reads
// the whole sum from its own CTA. Every element of S (and dP) is summed by one thread in
// one order, so every warpgroup holds the same bits of S, m, l and P (and dS), and a rerun
// gives the same bits. Then each warpgroup runs its own slice's products, one wgmma of N =
// its width a k-step: K1 O[:, w] += P V[:, w]; K4 dV[:, w] += P^T dO[:, w] and dK[:, w] +=
// dS_hi^T Q[:, w] + dS_lo^T Q[:, w]; K5 dQ[:, w] += dS_hi K[:, w] + dS_lo K[:, w], the
// operands read as MN-major B operands from the same boxes. Every score product is done
// once, on the tensor cores; the softmax (the exponentials) is repeated by each warpgroup.
// K1 and K5 issue the next tile's partials before this tile's sums are taken, so those
// products run while the sums cross the cluster (K4 does not). K5 keeps each row's lse and
// delta in registers, as flash_attn_bwd.cu's K5 does.
//
// Passes (K4 and K5 above 4096): 16 CTAs of two warpgroups of 128 columns hold 4096 columns
// of dK and dV (of dQ), and a wider slice does not fit in registers, so the output columns
// are cut into P = ceil(D / 4096) passes (2 up to 8192) in one launch of 16 CTAs. The D /
// 64 blocks are dealt over the 2 C P slots (CTA r, warpgroup w, pass p), the wider ones to
// the lowest ranks (2 p + w) C + r, and a CTA lays out its slots warpgroup by warpgroup, so
// a warpgroup's slices of all passes are one run of its CTA's blocks. The CTA keeps its whole
// share of D resident (K and V in K4, Q and dO in K5: up to 8 blocks of 64 rows at 8192) and
// its ring streams the other operand's share once a pass. In every pass a warpgroup
// contracts the scores over all its slices (the cluster's sum is then the whole score,
// formed by the same products in the same order each pass: the same bits), and runs the
// products on that pass's slice alone; its dK and dV (dQ) are written at the pass's end.
// So each score (and dP) is formed P times, where the column blocks form it D / 128 times
// (33-64 from 4160 to 8192). Two passes run 16 rows of the other operand a ring stage (TILE,
// a template constant of K4 and K5): at 32, a warpgroup that contracts three blocks beside
// its 128 columns of dK and dV spills registers (ptxas, whatever the descriptors' form), and
// 8192's resident share (8 blocks of K and V, 128 KB) leaves room for two stages of 16 (64
// KB) beside 24 KB of exchange. The contraction's descriptors are formed inside each wgmma's
// own block from two per-tile bases (WgmmaSS::run_at, per_tile): hoisted, they held two
// registers a step of the chain and spilled the longest chains.
//
// Synchronisation: no cluster-wide barrier inside the loop, and no memory fence. Each
// st.async counts its bytes on the receiving CTA's mbarrier (complete_tx), so a CTA
// knows its partials or sums have landed when that barrier's phase completes (a release
// at cluster scope compiles to a GPU-wide MEMBAR and an acquire to an L1 invalidate, which
// cost more than the tile's products when taken on every tile). A buffer is written
// again once every reader warp of the cluster has arrived on the writers' barrier (a
// plain remote mbarrier.arrive, as a cluster's TMA multicast hands its stages back).
// Every wait traps after ~2 s, like the ring's. Every warpgroup of a cluster visits the
// same tiles (kv_tile_range, q_tile_range of ops/flash_attention.py at 64 rows) in every
// pass, so the tile count over the passes is the barriers' phase. The cluster synchronises
// once after the barriers' set-up and once before it exits (no CTA leaves while another
// may still write or signal its shared memory).
//
// Registers: 256 threads leave a thread up to 255. With a third, producer warpgroup and
// setmaxnreg (232 / 40, as flash_attn_fwd.cu), ptxas kept these kernels within 168
// registers whatever was tried: O or dK/dV spilled and every wgmma was serialized. The
// slice's width and the contraction's length are compile-time constants of the loop (one
// copy a pair): a wgmma chain under a runtime guard is serialized too.
// Launched with cudaLaunchKernelEx and the cluster-dimension attribute: K1 in at most 8
// CTAs (the portable limit; its 256 columns a warpgroup reach 4096 there), K4 and K5 in up
// to 16 (ceil(D / 256): 9-16 CTAs from 2112 to 4096, 16 past it; the kernel allowed the
// H100's non-portable cluster sizes above 8). A CTA's shared memory does not grow with the
// cluster: the exchange's piece shrinks as C grows (at C = 16, 64 of the 1024 chunks a CTA,
// each summed over 32 partials by one of its threads and sent to 16 CTAs), so K4 and K5
// keep three ring stages from 1024 to 4096. A cluster the card cannot place is the
// launch's error, raised by the wrapper; nothing retries at a smaller size. The cluster
// primitives are cluster_sm90.cuh's. Measured: PERF.md (kernels/check_flash_attn.py,
// chip_smoke.py phase 2).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "cluster_sm90.cuh"
#include "tensor_map.cuh"
#include "wgmma_sm90.cuh"

using namespace sm90;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;   // two warpgroups; thread 0 also issues the TMA loads
constexpr int ROWS = 64;       // rows a cluster owns: queries in K1 and K5, keys in K4
constexpr int TILE = 32;       // rows of the other operand a ring stage (K4 and K5 in two passes: 16)
constexpr int BOX = 64;        // columns of a TMA box (128 bytes of bf16)
constexpr int FWD_BLOCKS = 4;  // 64-column blocks a K1 warpgroup at most (O: 128 registers)
constexpr int DKV_BLOCKS = 2;  // ... a K4 warpgroup (dK and dV: 128 registers), and a K5 one
constexpr int PASS_BLOCKS = 2 * MAX_NONPORTABLE_CLUSTER * DKV_BLOCKS;  // K4's, K5's a pass: 4096 columns
constexpr int MAX_PASSES = 2;  // K4 and K5 up to 8192
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// ---- the column slices and the shared-memory plan (ops/flash_attention.py computes the same)

// the three kernels of this file (ops/flash_attention.py:cluster_plan's `kind`)
enum Kind { FWD, DKV, DQ };

// The nb column blocks of D dealt out to the 2 c passes slots (CTA r, warpgroup w, pass p):
// nb / slots blocks each, one more for the nb % slots lowest ranks (2 p + w) c + r, so that
// the CTAs' blocks differ by at most one and CTA 0 holds the most (640 over 2 CTAs in one
// pass: 192 + 128 | 192 + 128). A CTA's blocks are one run of D, its slots in order
// warpgroup by warpgroup, pass by pass within each.
struct Slices {
  int nb, c, passes;
  __host__ __device__ __forceinline__ int slots() const { return 2 * passes * c; }
  __host__ __device__ __forceinline__ int width(int r, int w, int p) const {
    return nb / slots() + ((2 * p + w) * c + r < nb % slots() ? 1 : 0);
  }
  // the first block of CTA r: the even share of the CTAs before it, and of the extra
  // blocks those of each rank k c + r' (r' < r) below nb % slots
  __host__ __device__ __forceinline__ int cta_first(int r) const {
    const int extra = nb % slots();
    int first = r * 2 * passes * (nb / slots());
    for (int k = 0; k < 2 * passes; ++k) {
      const int below = extra - k * c;
      first += below < 0 ? 0 : (below < r ? below : r);
    }
    return first;
  }
  __host__ __device__ __forceinline__ int cta_blocks(int r) const {
    return cta_first(r + 1) - cta_first(r);
  }
  // the first block of slot (r, w, p)
  __host__ __device__ __forceinline__ int first(int r, int w, int p) const {
    int first = cta_first(r);
    for (int k = 0; k < w * passes + p; ++k) first += width(r, k / passes, k % passes);
    return first;
  }
};

// byte offsets from the 1024-aligned base: the operands a CTA keeps (K1: Q; K4: K, V; K5: Q,
// dO), the ring of `tile`-row stages, both warpgroups' partials, the sums, K4's per-stage
// query statistics, barriers
struct Layout {
  int nbc;
  uint32_t own, stage, ring, part, sum, stats, bars, bytes;
  __host__ __device__ Layout(Kind kind, const Slices& sl, int stages, int tile) {
    nbc = sl.cta_blocks(0);  // CTA 0 holds the most blocks
    own = (kind == FWD ? 1 : 2) * nbc * ROWS * 128;
    stage = 2 * nbc * tile * 128;
    ring = own;
    part = ring + stages * stage;
    const int total = (kind == FWD ? 1 : 2) * tile / 8 * 128;  // float4 chunks of the partials
    sum = part + 2 * sl.c * ((total + sl.c - 1) / sl.c) * 16;  // W pieces of ceil(total / C)
    stats = sum + total * 16;
    bars = stats + (kind == DKV ? stages * 2 * tile * 4 : 0);
    bytes = bars + 8 * (2 * MAX_STAGES + 5);
  }
  // the dynamic shared memory a launch asks for (the base is aligned up to 1024)
  __host__ __device__ uint32_t request() const { return bytes + 1024; }
};

// K4's and K5's passes over the output columns (1 up to 4096); K1 runs one
int plan_passes(Kind kind, int nb) {
  return kind == FWD ? 1 : (nb + PASS_BLOCKS - 1) / PASS_BLOCKS;
}

// the fewest CTAs that hold D in one pass; 16 where it takes more than one
int plan_cluster(Kind kind, int nb) {
  if (plan_passes(kind, nb) > 1) return MAX_NONPORTABLE_CLUSTER;
  const int per_cta = 2 * (kind == FWD ? FWD_BLOCKS : DKV_BLOCKS);
  return (nb + per_cta - 1) / per_cta;
}

// the ring's rows: TILE in one pass, half of it in two (at TILE rows a warpgroup that
// contracts three blocks and keeps 128 columns of dK and dV spills registers)
constexpr int tile_of(int passes) { return passes > 1 ? TILE / 2 : TILE; }
int plan_tile(Kind kind, int nb) { return tile_of(plan_passes(kind, nb)); }

// the most ring stages that fit an SM (at least 2), or 0 where even 2 do not
int plan_stages(Kind kind, int nb, int c, int tile) {
  const Slices sl{nb, c, plan_passes(kind, nb)};
  for (int s = MAX_STAGES; s >= 2; --s)
    if (Layout(kind, sl, s, tile).request() <= (uint32_t)SMEM_LIMIT) return s;
  return 0;
}

template <int N>
struct Blocks {
  static constexpr int value = N;
};

// f(std::integral_constant<int, 0>{}), ..., f(<N - 1>), in order: a loop each of whose
// steps knows its index at compile time
template <typename F, int... I>
__device__ __forceinline__ void for_steps_of(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void for_steps(F&& f) {
  for_steps_of(f, std::make_integer_sequence<int, N>{});
}

// K4's and K5's passes over a warpgroup's run of nc blocks from block `run`, each slice's
// width known at compile time: consume(contraction, width, pass, first block); pass 1's slice
// follows pass 0's in the run (no state of one pass is held through the other's loop)
template <int PASSES, typename F>
__device__ __forceinline__ void run_passes(F&& consume, int nc, int run) {
  if constexpr (PASSES == 1) {
    if (nc == 1)
      consume(Blocks<1>{}, Blocks<1>{}, 0, run);
    else
      consume(Blocks<2>{}, Blocks<2>{}, 0, run);
  } else if (nc == 4) {  // slices of 2 and 2 blocks
    consume(Blocks<4>{}, Blocks<2>{}, 0, run);
    consume(Blocks<4>{}, Blocks<2>{}, 1, run + 2);
  } else if (nc == 3) {  // 2 and 1
    consume(Blocks<3>{}, Blocks<2>{}, 0, run);
    consume(Blocks<3>{}, Blocks<1>{}, 1, run + 2);
  } else {  // 1 and 1
    consume(Blocks<2>{}, Blocks<1>{}, 0, run);
    consume(Blocks<2>{}, Blocks<1>{}, 1, run + 1);
  }
}

// v, in a form the compiler cannot prove constant over a loop whose count n stays below
// 2^31 (it adds n >> 31 = 0): the descriptors formed from it are formed in the loop, next to
// their wgmma, not hoisted out of it and held in registers (two of them a step of a chain)
__device__ __forceinline__ uint32_t per_tile(uint32_t v, uint32_t n) { return v + (n >> 31); }

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- the cluster's sum of the warpgroups' partial tiles

// NT tensors of [64 x TILE] fp32 a warpgroup (TILE: the ring's rows), in wgmma's
// accumulator layout (TILE / 2 values a thread). A tensor is CHUNKS float4s, chunk j * 128 + t holding thread t's
// values 4 j .. 4 j + 3; chunk i of the NT tensors (i = n * CHUNKS + chunk) is reduced by
// CTA i / PIECE, PIECE = ceil(NT * CHUNKS / C). In CTA r, `part` is [W][PIECE] float4: the
// W warpgroups' chunks of its piece, and `sum` [NT * CHUNKS] float4: the whole sum. Data
// moves only by st.async into the receiving CTA's shared memory, with complete_tx on its
// barrier: the barrier's byte count says when all has landed, so no fence is needed. A
// buffer is reused once each reader warp of the cluster has arrived on the writers'
// barrier (a plain remote mbarrier.arrive after the reads, as a cluster's TMA multicast
// hands its stages back).
template <int NT, int TILE>
struct Exchange {
  static constexpr int CHUNKS = TILE / 8 * 128, TOTAL = NT * CHUNKS;
  uint32_t part, sum;  // shared-memory addresses in this CTA
  uint32_t bar;        // partials landed, partials read, sums landed, sums read
  uint32_t ctas, rank;

  __device__ int piece() const { return (TOTAL + ctas - 1) / ctas; }
  __device__ int piece_chunks() const { return min(TOTAL, (int)(rank + 1) * piece()) - rank * piece(); }

  // thread 0, before the cluster's first synchronisation: a "landed" barrier takes one
  // local arrival that posts the phase's bytes, a "read" one an arrival from every
  // consumer warp of the cluster
  __device__ void init() const {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 8 * ctas);
    mbar_init(bar + 16, 1);
    mbar_init(bar + 24, 8 * ctas);
    mbar_expect_tx(bar, 2 * ctas * piece_chunks() * 16);
    mbar_expect_tx(bar + 16, TOTAL * 16);
  }

  // s: this warpgroup's partials in, the cluster's sums out; `parity`: the tile count's
  // lowest bit (each barrier completes once a tile)
  __device__ __forceinline__ void run(float (&s)[NT][TILE / 2], int wg, int t, uint32_t parity) const {
    publish(s, wg, t, parity);
    finish(s, wg, t, parity);
  }

  // 1. each chunk of this warpgroup's partials to the CTA that reduces it, once every
  //    reducer has read the previous tile's
  __device__ __forceinline__ void publish(const float (&s)[NT][TILE / 2], int wg, int t,
                                          uint32_t parity) const {
    const uint32_t landed_p = bar, read_p = bar + 8;
    const int g = 2 * rank + wg, p = piece();
    mbar_wait(read_p, parity ^ 1);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const int i = n * CHUNKS + j * 128 + t, r = i / p;
        st_async(map_cta(part + 16 * (g * p + i - r * p), r),
                 make_float4(s[n][4 * j], s[n][4 * j + 1], s[n][4 * j + 2], s[n][4 * j + 3]),
                 map_cta(landed_p, r));
      }
  }

  // 2. and 3.: the sums of the tile whose partials every warpgroup has published
  __device__ __forceinline__ void finish(float (&s)[NT][TILE / 2], int wg, int t,
                                         uint32_t parity) const {
    const uint32_t landed_p = bar, read_p = bar + 8, landed_s = bar + 16, read_s = bar + 24;
    const int lane = t % 32, tid = wg * 128 + t, p = piece();
    // 2. this CTA's piece: the W partials summed in slice order, to every CTA's `sum`
    //    once its readers have read the previous tile's
    mbar_wait(landed_p, parity);
    if (tid == 0) mbar_expect_tx(landed_p, 2 * ctas * piece_chunks() * 16);  // the next tile's
    mbar_wait(read_s, parity ^ 1);
    const int lo = rank * p, n_chunks = piece_chunks();
    for (int i = tid; i < n_chunks; i += 256) {
      float4 acc = ld_shared(part + 16 * i);
      for (uint32_t w = 1; w < 2 * ctas; ++w) acc = add4(acc, ld_shared(part + 16 * (w * p + i)));
      for (uint32_t c = 0; c < ctas; ++c)
        st_async(map_cta(sum + 16 * (lo + i), c), acc, map_cta(landed_s, c));
    }
    __syncwarp();  // the warp's reads of `part` before its arrivals, one lane a CTA
    if (lane < (int)ctas) arrive_remote(map_cta(read_p, lane));

    // 3. the whole sums, from this CTA's `sum`
    mbar_wait(landed_s, parity);
    if (tid == 0) mbar_expect_tx(landed_s, TOTAL * 16);  // the next tile's
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float4 v = ld_shared(sum + 16 * (n * CHUNKS + j * 128 + t));
        s[n][4 * j] = v.x;
        s[n][4 * j + 1] = v.y;
        s[n][4 * j + 2] = v.z;
        s[n][4 * j + 3] = v.w;
      }
    __syncwarp();
    if (lane < (int)ctas) arrive_remote(map_cta(read_s, lane));
    __syncwarp();  // converged for the warpgroup's next wgmma
  }
};

// ------------------------------------------------------------------------------- K1

// The thread's scores of row r of its warp's 16 (r = 0: row lane / 4, r = 1: that + 8) are
// s[4 j + 2 r + e], column 8 j + 2 (lane % 4) + e of the tile.
__global__ void __launch_bounds__(THREADS, 1)
cluster_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const int* __restrict__ kv_mask,
                   bf16* __restrict__ out, float* __restrict__ lse, float* __restrict__ out_f32,
                   int T, int Hq, int Hkv, int D, int stages, long long sob, long long sot,
                   long long soh, float scale, int causal, int window) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ctas = cluster_ctas(), rank = cluster_rank();
  const Slices sl{D / BOX, (int)ctas, 1};
  const Layout L(FWD, sl, stages, TILE);
  constexpr int Q_BLOCK = ROWS * 128, KV_BLOCK = TILE * 128;
  const uint32_t sq = smem_addr(smem), ring = sq + L.ring;  // Q first
  const uint32_t full = sq + L.bars, empty = full + 8 * MAX_STAGES, q_full = empty + 8 * MAX_STAGES;
  const Exchange<1, TILE> ex{sq + L.part, sq + L.sum, q_full + 8, ctas, rank};

  const int q0 = (int)(blockIdx.x / ctas) * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int cb0 = sl.cta_first(rank), cta_blocks = sl.cta_blocks(rank);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    ex.init();
    mbar_init_fence();
  }
  cluster_sync();

  // the K/V tiles the cluster's rows can see (ops/flash_attention.py:kv_tile_range)
  int kt_end = (T + TILE - 1) / TILE;
  if (causal) kt_end = min(kt_end, (q0 + ROWS - 1) / TILE + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / TILE : 0;
  const int n_tiles = kt_end - kt_begin, wg = threadIdx.x / 128;

  // thread 0: the K and V boxes of tile n (of the range) into stage n % stages
  const auto load_kv = [&](int n) {
    const int stage = n % stages, k0 = (kt_begin + n) * TILE;
    const uint32_t st = ring + stage * L.stage, bar = full + 8 * stage;
    mbar_expect_tx(bar, 2 * cta_blocks * KV_BLOCK);
    for (int j = 0; j < cta_blocks; ++j) {
      tma_load_4d(st + j * KV_BLOCK, &map_k, bar, BOX * (cb0 + j), k0, hk, b);
      tma_load_4d(st + (L.nbc + j) * KV_BLOCK, &map_v, bar, BOX * (cb0 + j), k0, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, cta_blocks * Q_BLOCK);
    for (int j = 0; j < cta_blocks; ++j)
      tma_load_4d(sq + j * Q_BLOCK, &map_q, q_full, BOX * (cb0 + j), q0, h, b);
    for (int n = 0; n < min(stages, n_tiles); ++n) load_kv(n);
  }

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
  // this warpgroup's slice: blocks gs .. gs + gn - 1 of D, lb .. of the CTA's
  const int g = 2 * rank + wg, gs = sl.first(rank, wg, 0), gn = sl.width(rank, wg, 0);
  const int lb = gs - cb0;
  const int row = q0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  const float qk_scale = scale * LOG2E;       // exp2 domain
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  // the slice's width is a constant of the loop below, one copy of it a width
  const auto consume = [&](auto width) {
    constexpr int NB = decltype(width)::value;
    float o[NB * 32];  // one accumulator: wgmma's N = 64 NB
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) o[i] = 0.f;
    // per row: running max (log2 domain), this thread's part of the fp32 sum of the weights
    // (for lse) and of the sum of their bf16 roundings (what PV applies, for O)
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, u_run[2] = {0.f, 0.f};

    // this slice's part of S = Q K^T for the tile in stage rp, issued (not waited for)
    const auto partial = [&](float (&s)[TILE / 2], const RingPos& rp) {
      const uint32_t st = ring + rp.stage * L.stage;
      mbar_wait(full + 8 * rp.stage, rp.phase);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 columns a k-step
          WgmmaSS<TILE, 0>::run(s, smem_desc(sq + (lb + j) * Q_BLOCK + 32 * kk, 16, 1024),
                                smem_desc(st + (lb + j) * KV_BLOCK + 32 * kk, 16, 1024),
                                j + kk != 0);
      wgmma_commit();
    };

    // The next tile's partial runs on the tensor cores while this tile's is summed over
    // the cluster and its softmax and O product run; it is published once done.
    mbar_wait(q_full, 0);
    RingPos r;
    float s[1][TILE / 2], s_next[1][TILE / 2];
    partial(s[0], r);
    wgmma_wait<0>();
    fence_regs(s[0]);
    ex.publish(s, wg, t, 0);
    uint32_t tile = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt, ++tile) {
      const int k0 = kt * TILE;
      const int key_ok = k0 + lane < T ? (mb ? mb[k0 + lane] != 0 : 1) : 0;
      const uint32_t st = ring + r.stage * L.stage;
      RingPos r_next = r;
      if (++r_next.stage == stages) {
        r_next.stage = 0;
        r_next.phase ^= 1;
      }
      const bool more = kt + 1 < kt_end;
      partial(s_next[0], more ? r_next : r);  // after the last tile a product unused (no branch
      ex.finish(s, wg, t, tile & 1);           // around a wgmma: it would be serialized)

      // the softmax of the tile in the exp2 domain, the same in every warpgroup; invalid
      // pairs set to 0 explicitly (a row with no valid key has m = NEG_INF)
      const uint32_t word = __ballot_sync(0xffffffffu, key_ok != 0);
      const bool masked = word != 0xffffffffu || (causal && k0 + TILE - 1 > q0) ||
                          (window > 0 && k0 <= q0 + ROWS - 1 - window);
      float corr[2];
      uint32_t pa[TILE / 16][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qp = row + 8 * rr;
        const int hi = causal ? qp - k0 : TILE;               // keys relative to k0 it may see
        const int lo = window > 0 ? qp - window + 1 - k0 : 0;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * rr + e, c = 8 * j + 2 * tq + e;
            const bool ok = !masked || (((word >> c) & 1) && c <= hi && c >= lo);
            s[0][i] = ok ? s[0][i] * qk_scale : NEG_INF;
            mx = fmaxf(mx, s[0][i]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[rr], mx);
        float sum = 0.f, used = 0.f;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[0][4 * j + 2 * rr + e];
            p[e] = x > 0.5f * NEG_INF ? ex2(x - m_new) : 0.f;
            sum += p[e];
          }
          const uint32_t packed = pack_bf16(p[0], p[1]);
          used += bf16_lo(packed) + bf16_hi(packed);
          pa[j / 2][(j % 2) * 2 + rr] = packed;
        }
        corr[rr] = ex2(m_run[rr] - m_new);
        l_run[rr] = l_run[rr] * corr[rr] + sum;
        u_run[rr] = u_run[rr] * corr[rr] + used;
        m_run[rr] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NB * 32; ++i) o[i] *= corr[(i / 2) % 2];

      // O[:, slice] += P V[:, slice]; V read MN-major, its 64-column boxes KV_BLOCK apart
      const uint32_t sv = st + L.nbc * KV_BLOCK + lb * KV_BLOCK;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        WgmmaRS<64 * NB, 1>::run(o, pa[kk], smem_desc(sv + 2048 * kk, KV_BLOCK, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();  // this tile's O product and the next tile's partial
      fence_regs(o);
      fence_regs(s_next[0]);
      keep_regs(pa);
      if (lane == 0) mbar_arrive(empty + 8 * r.stage);
      // thread 0 refills the stage, with the tile `stages` ahead, once both warpgroups are
      // done with it
      if (threadIdx.x == 0 && (int)tile + stages < n_tiles) {
        mbar_wait(empty + 8 * r.stage, r.phase);
        load_kv(tile + stages);
      }
      __syncwarp();
      if (more) {
        ex.publish(s_next, wg, t, (tile + 1) & 1);
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) s[0][i] = s_next[0][i];
      }
      r = r_next;
    }

    // epilogue: out = O / max(u, 1e-30); lse = m + log(l) in natural-log units (slice 0)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_run[rr], u = u_run[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      u += __shfl_xor_sync(0xffffffffu, u, 1);
      u += __shfl_xor_sync(0xffffffffu, u, 2);
      const int qp = row + 8 * rr;
      if (qp >= T) continue;
      const float inv = 1.f / fmaxf(u, 1e-30f);
      bf16* ob = out + b * sob + qp * sot + h * soh + BOX * gs + 2 * tq;
      float* of = out_f32 ? out_f32 + (((long long)b * T + qp) * Hq + h) * D + BOX * gs + 2 * tq : nullptr;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 32 * j + 4 * jj + 2 * rr;
          const float x0 = o[i] * inv, x1 = o[i + 1] * inv;
          *reinterpret_cast<uint32_t*>(ob + BOX * j + 8 * jj) = pack_bf16(x0, x1);
          if (of) *reinterpret_cast<float2*>(of + BOX * j + 8 * jj) = make_float2(x0, x1);
        }
      }
      if (tq == 0 && g == 0)
        lse[((long long)b * Hq + h) * T + qp] = m_run[rr] * LN2 + logf(fmaxf(l, 1e-30f));
    }
  };
  if (gn == 2)
    consume(Blocks<2>{});
  else if (gn == 3)
    consume(Blocks<3>{});
  else
    consume(Blocks<4>{});
  cluster_sync();
}

// ------------------------------------------------------------------------------- K4

// S^T and dP^T are [64 keys x TILE queries]: the thread's keys are rows lane / 4 (+ 8) of
// its warp's 16, its queries columns 8 j + 2 (lane % 4) + e. TILE: queries a ring stage
// (32 in one pass, 16 in two); PASSES: passes over the output columns (2 above 4096).
template <int TILE, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
cluster_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                   const int* __restrict__ kv_mask, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int T, int Hq, int Hkv, int D, int stages, long long sdkb, long long sdkt,
                   long long sdkh, long long sdvb, long long sdvt, long long sdvh, float scale,
                   int causal, int window) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ctas = cluster_ctas(), rank = cluster_rank();
  const Slices sl{D / BOX, (int)ctas, PASSES};
  const Layout L(DKV, sl, stages, TILE);
  constexpr int KV_BLOCK = ROWS * 128, Q_BLOCK = TILE * 128;
  const uint32_t base = smem_addr(smem), sk = base, sv = base + L.nbc * KV_BLOCK;
  const uint32_t ring = base + L.ring, tile_bytes = L.nbc * Q_BLOCK;  // Q, then dO, a stage
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  const uint32_t full = base + L.bars, empty = full + 8 * MAX_STAGES, kv_full = empty + 8 * MAX_STAGES;
  const Exchange<2, TILE> ex{base + L.part, base + L.sum, kv_full + 8, ctas, rank};

  const int k0 = (int)(blockIdx.x / ctas) * ROWS, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int cb0 = sl.cta_first(rank), cta_blocks = sl.cta_blocks(rank);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(kv_full, 1);
    ex.init();
    mbar_init_fence();
  }
  cluster_sync();

  // the query tiles that can see a key of the cluster (ops/flash_attention.py:q_tile_range),
  // visited by every pass
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(T, k0 + ROWS - 1 + window) : T;
  const int qt_begin = q_lo / TILE, qt_end = (q_hi + TILE - 1) / TILE;
  const int n_qt = qt_end - qt_begin, n_tiles = n_rep * n_qt, wg = threadIdx.x / 128;
  const int all_tiles = PASSES * n_tiles;

  // warp 0: tile n's lse (to log2 units) and delta rows (0 past T) into stage n % stages,
  // then lane 0 its Q and dO boxes; the arrival with the TMA's bytes releases both
  const auto load_q = [&](int n) {
    const int stage = n % stages, m = n % n_tiles;
    const int h = hk * n_rep + m / n_qt, q0 = (qt_begin + m % n_qt) * TILE;
    const long long row_off = ((long long)b * Hq + h) * T;
    const int qi = q0 + threadIdx.x;
    float* row_stats = stats + stage * 2 * TILE;
    if (threadIdx.x < TILE) {
      row_stats[threadIdx.x] = qi < T ? lse[row_off + qi] * LOG2E : 0.f;
      row_stats[TILE + threadIdx.x] = qi < T ? delta[row_off + qi] : 0.f;
    }
    __syncwarp();
    if (threadIdx.x == 0) {
      const uint32_t st = ring + stage * L.stage, bar = full + 8 * stage;
      mbar_expect_tx(bar, 2 * cta_blocks * Q_BLOCK);
      for (int j = 0; j < cta_blocks; ++j) {
        tma_load_4d(st + j * Q_BLOCK, &map_q, bar, BOX * (cb0 + j), q0, h, b);
        tma_load_4d(st + tile_bytes + j * Q_BLOCK, &map_do, bar, BOX * (cb0 + j), q0, h, b);
      }
    }
  };
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * cta_blocks * KV_BLOCK);
      for (int j = 0; j < cta_blocks; ++j) {
        tma_load_4d(sk + j * KV_BLOCK, &map_k, kv_full, BOX * (cb0 + j), k0, hk, b);
        tma_load_4d(sv + j * KV_BLOCK, &map_v, kv_full, BOX * (cb0 + j), k0, hk, b);
      }
    }
    for (int n = 0; n < min(stages, all_tiles); ++n) load_q(n);
  }

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
  // this warpgroup's blocks lc .. lc + nc - 1 of the CTA's: its slices of every pass, over
  // which it contracts the scores in each
  const int run = sl.first(rank, wg, 0), lc = run - cb0;
  const int nc = sl.first(rank, wg, PASSES - 1) + sl.width(rank, wg, PASSES - 1) - run;
  const float qk_scale = scale * LOG2E;
  // the thread's keys (key, key + 8): inside T and unpadded; the queries [warp_first,
  // warp_last] with which every key of the warp pairs (a tile inside takes the unmasked path)
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
  const int key = k0 + 16 * warp + lane / 4;
  bool key_ok[2];
  int warp_first = 0, warp_last = T - 1;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kp = key + 8 * rr;
    key_ok[rr] = kp < T && (mb == nullptr || mb[kp] != 0);
    if (causal) warp_first = max(warp_first, kp);
    warp_last = !key_ok[rr] ? -1 : (window > 0 ? min(warp_last, kp + window - 1) : warp_last);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    warp_first = max(warp_first, __shfl_xor_sync(0xffffffffu, warp_first, o));
    warp_last = min(warp_last, __shfl_xor_sync(0xffffffffu, warp_last, o));
  }

  // pass p: its slice (blocks gs .. of D) of dK and dV; the contraction's length NC and the
  // slice's width NB are constants of the loop below, one copy of it a pair
  const auto consume = [&](auto contraction, auto width, int p, int gs) {
    constexpr int NC = decltype(contraction)::value, NB = decltype(width)::value;
    const int lb = gs - cb0;
    // tiles consumed over the passes (the ring's and the exchange's phase) and the ring's place
    uint32_t tile = p * n_tiles;
    RingPos r;
    r.stage = tile % stages;
    r.phase = (tile / stages) & 1;
    float acc_dk[NB * 32], acc_dv[NB * 32];  // wgmma's N = 64 NB
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int rep = 0; rep < n_rep; ++rep) {
      for (int qt = qt_begin; qt < qt_end; ++qt, ++tile) {
        const int q0 = qt * TILE;
        const uint32_t st = ring + r.stage * L.stage;
        const float* row_stats = stats + r.stage * 2 * TILE;
        mbar_wait(full + 8 * r.stage, r.phase);

        // this warpgroup's parts of S^T = K Q^T and dP^T = V dO^T, then the cluster's sums;
        // the descriptors of its run's first block, each step's formed in its wgmma's block
        float sp[2][TILE / 2];
        const uint64_t k_desc = smem_desc(per_tile(sk, tile) + lc * KV_BLOCK, 16, 1024);
        const uint64_t v_desc = smem_desc(per_tile(sv, tile) + lc * KV_BLOCK, 16, 1024);
        const uint64_t q_desc = smem_desc(st + lc * Q_BLOCK, 16, 1024);
        const uint64_t do_desc = smem_desc(st + tile_bytes + lc * Q_BLOCK, 16, 1024);
        wgmma_fence();
        for_steps<NC * 4>([&](auto step) {  // block j of the run, 16 columns kk a k-step
          constexpr int J = decltype(step)::value / 4, KK = decltype(step)::value % 4;
          constexpr int A = (J * KV_BLOCK + 32 * KK) / 16, B = (J * Q_BLOCK + 32 * KK) / 16;
          WgmmaSS<TILE, 0>::template run_at<A, B>(sp[0], k_desc, q_desc, J + KK != 0);
          WgmmaSS<TILE, 0>::template run_at<A, B>(sp[1], v_desc, do_desc, J + KK != 0);
        });
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sp[0]);
        fence_regs(sp[1]);
        ex.run(sp, wg, t, tile & 1);

        // P^T = exp2(S^T - lse) on valid pairs (0 elsewhere, set explicitly: the lse of a
        // query with no valid key is only "very negative"), dS^T = P^T (dP^T - delta); P
        // once and dS as hi + lo rounded to bf16, in wgmma's A-operand places
        const bool masked = q0 < warp_first || q0 + TILE - 1 > warp_last;
        uint32_t pa[TILE / 16][4], ds_hi[TILE / 16][4], ds_lo[TILE / 16][4];
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(row_stats + 8 * j + 2 * tq);
          const float2 dl = *reinterpret_cast<const float2*>(row_stats + TILE + 8 * j + 2 * tq);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * rr + e, c = 8 * j + 2 * tq + e;
              p[e] = ex2(fmaf(sp[0][i], qk_scale, -(e ? l2.y : l2.x)));
              if (masked) {
                const int qi = q0 + c, kp = key + 8 * rr;
                p[e] = key_ok[rr] && qi < T && (!causal || kp <= qi) &&
                               (window <= 0 || qi <= kp + window - 1)
                           ? p[e]
                           : 0.f;
              }
              ds[e] = p[e] * (sp[1][i] - (e ? dl.y : dl.x));
            }
            const int slot = (j % 2) * 2 + rr;
            pa[j / 2][slot] = pack_bf16(p[0], p[1]);
            const uint32_t hi = pack_bf16(ds[0], ds[1]);
            ds_hi[j / 2][slot] = hi;
            ds_lo[j / 2][slot] = pack_bf16(ds[0] - bf16_lo(hi), ds[1] - bf16_hi(hi));
          }
        }

        // dV[:, slice] += P^T dO[:, slice], dK[:, slice] += (dS_hi + dS_lo)^T Q[:, slice];
        // dO and Q read MN-major from the same boxes, Q_BLOCK apart
        fence_regs(acc_dk);
        fence_regs(acc_dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const uint32_t off = lb * Q_BLOCK + 2048 * kk;
          const uint64_t b_do = smem_desc(st + tile_bytes + off, Q_BLOCK, 1024);
          const uint64_t b_q = smem_desc(st + off, Q_BLOCK, 1024);
          WgmmaRS<64 * NB, 1>::run(acc_dv, pa[kk], b_do, 1);
          WgmmaRS<64 * NB, 1>::run(acc_dk, ds_hi[kk], b_q, 1);
          WgmmaRS<64 * NB, 1>::run(acc_dk, ds_lo[kk], b_q, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dk);
        fence_regs(acc_dv);
        keep_regs(pa);
        keep_regs(ds_hi);
        keep_regs(ds_lo);
        if (lane == 0) mbar_arrive(empty + 8 * r.stage);
        // warp 0 refills the stage, with the tile `stages` ahead (of this pass or the
        // next), once both warpgroups are done with it
        if (threadIdx.x < 32 && (int)tile + stages < all_tiles) {
          if (threadIdx.x == 0) mbar_wait(empty + 8 * r.stage, r.phase);
          __syncwarp();
          load_q(tile + stages);
        }
        __syncwarp();
        if (++r.stage == stages) {
          r.stage = 0;
          r.phase ^= 1;
        }
      }
    }

    // epilogue: dK = scale * acc, dV = acc, as bf16, the thread's two keys and its slice
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kp = key + 8 * rr;
      if (kp >= T) continue;
      bf16* dkb = dk + b * sdkb + kp * sdkt + hk * sdkh + BOX * gs + 2 * tq;
      bf16* dvb = dv + b * sdvb + kp * sdvt + hk * sdvh + BOX * gs + 2 * tq;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 32 * j + 4 * jj + 2 * rr;
          *reinterpret_cast<uint32_t*>(dkb + BOX * j + 8 * jj) =
              pack_bf16(acc_dk[i] * scale, acc_dk[i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvb + BOX * j + 8 * jj) = pack_bf16(acc_dv[i], acc_dv[i + 1]);
        }
      }
    }
  };
  run_passes<PASSES>(consume, nc, run);
  cluster_sync();
}

// ------------------------------------------------------------------------------- K5

// S and dP are [64 queries x TILE keys], as K1's S: the thread's queries are rows lane / 4
// (+ 8) of its warp's 16, its keys columns 8 j + 2 (lane % 4) + e. TILE: keys a ring stage
// (32 in one pass, 16 in two); PASSES: passes over the output columns (2 above 4096).
template <int TILE, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
cluster_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                  const int* __restrict__ kv_mask, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq, int T, int Hq, int Hkv,
                  int D, int stages, long long sdqb, long long sdqt, long long sdqh, float scale,
                  int causal, int window) {
  constexpr uint32_t TILE_LANES = (TILE == 32 ? 0u : 1u << (TILE % 32)) - 1u;  // a tile's keys
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ctas = cluster_ctas(), rank = cluster_rank();
  const Slices sl{D / BOX, (int)ctas, PASSES};
  const Layout L(DQ, sl, stages, TILE);
  constexpr int Q_BLOCK = ROWS * 128, KV_BLOCK = TILE * 128;
  const uint32_t base = smem_addr(smem), sq = base, sdo = base + L.nbc * Q_BLOCK;
  const uint32_t ring = base + L.ring, tile_bytes = L.nbc * KV_BLOCK;  // K, then V, a stage
  const uint32_t full = base + L.bars, empty = full + 8 * MAX_STAGES, q_full = empty + 8 * MAX_STAGES;
  const Exchange<2, TILE> ex{base + L.part, base + L.sum, q_full + 8, ctas, rank};

  const int q0 = (int)(blockIdx.x / ctas) * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int cb0 = sl.cta_first(rank), cta_blocks = sl.cta_blocks(rank);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    ex.init();
    mbar_init_fence();
  }
  cluster_sync();

  // the K/V tiles the cluster's rows can see (ops/flash_attention.py:kv_tile_range), visited
  // by every pass
  int kt_end = (T + TILE - 1) / TILE;
  if (causal) kt_end = min(kt_end, (q0 + ROWS - 1) / TILE + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / TILE : 0;
  const int n_tiles = kt_end - kt_begin, wg = threadIdx.x / 128;
  const int all_tiles = PASSES * n_tiles;

  // thread 0: the K and V boxes of tile n (of the passes' ranges) into stage n % stages
  const auto load_kv = [&](int n) {
    const int stage = n % stages, k0 = (kt_begin + n % n_tiles) * TILE;
    const uint32_t st = ring + stage * L.stage, bar = full + 8 * stage;
    mbar_expect_tx(bar, 2 * cta_blocks * KV_BLOCK);
    for (int j = 0; j < cta_blocks; ++j) {
      tma_load_4d(st + j * KV_BLOCK, &map_k, bar, BOX * (cb0 + j), k0, hk, b);
      tma_load_4d(st + tile_bytes + j * KV_BLOCK, &map_v, bar, BOX * (cb0 + j), k0, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * cta_blocks * Q_BLOCK);
    for (int j = 0; j < cta_blocks; ++j) {
      tma_load_4d(sq + j * Q_BLOCK, &map_q, q_full, BOX * (cb0 + j), q0, h, b);
      tma_load_4d(sdo + j * Q_BLOCK, &map_do, q_full, BOX * (cb0 + j), q0, h, b);
    }
    for (int n = 0; n < min(stages, all_tiles); ++n) load_kv(n);
  }

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
  // this warpgroup's blocks lc .. lc + nc - 1 of the CTA's: its slices of every pass, over
  // which it contracts the scores in each
  const int run = sl.first(rank, wg, 0), lc = run - cb0;
  const int nc = sl.first(rank, wg, PASSES - 1) + sl.width(rank, wg, PASSES - 1) - run;
  const int row = q0 + 16 * warp + lane / 4;  // this thread's queries: row, row + 8
  const float qk_scale = scale * LOG2E;       // exp2 domain
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;
  const long long row_off = ((long long)b * Hq + h) * T;
  float lse2[2], dl[2];  // lse in log2 units and delta of the thread's rows, 0 past T
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = row + 8 * rr;
    lse2[rr] = qp < T ? lse[row_off + qp] * LOG2E : 0.f;
    dl[rr] = qp < T ? delta[row_off + qp] : 0.f;
  }

  // pass p: its slice (blocks gs .. of D) of dQ; the contraction's length NC and the slice's
  // width NB are constants of the loop below, one copy of it a pair
  const auto consume = [&](auto contraction, auto width, int p, int gs) {
    constexpr int NC = decltype(contraction)::value, NB = decltype(width)::value;
    const int lb = gs - cb0;
    // tiles consumed over the passes (the ring's and the exchange's phase) and the ring's place
    uint32_t tile = p * n_tiles;
    RingPos r;
    r.stage = tile % stages;
    r.phase = (tile / stages) & 1;
    float acc[NB * 32];  // dQ[:, slice]: wgmma's N = 64 NB
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;

    // this warpgroup's parts of S = Q K^T and dP = dO V^T for the tile in stage rp, issued
    // (not waited for)
    const auto partial = [&](float (&sp)[2][TILE / 2], const RingPos& rp) {
      const uint32_t st = ring + rp.stage * L.stage;
      // the descriptors of the run's first block, each step's formed in its wgmma's block
      const uint64_t q_desc = smem_desc(per_tile(sq, tile) + lc * Q_BLOCK, 16, 1024);
      const uint64_t do_desc = smem_desc(per_tile(sdo, tile) + lc * Q_BLOCK, 16, 1024);
      const uint64_t k_desc = smem_desc(st + lc * KV_BLOCK, 16, 1024);
      const uint64_t v_desc = smem_desc(st + tile_bytes + lc * KV_BLOCK, 16, 1024);
      mbar_wait(full + 8 * rp.stage, rp.phase);
      wgmma_fence();
      for_steps<NC * 4>([&](auto step) {  // block j of the run, 16 columns kk a k-step
        constexpr int J = decltype(step)::value / 4, KK = decltype(step)::value % 4;
        constexpr int A = (J * Q_BLOCK + 32 * KK) / 16, B = (J * KV_BLOCK + 32 * KK) / 16;
        WgmmaSS<TILE, 0>::template run_at<A, B>(sp[0], q_desc, k_desc, J + KK != 0);
        WgmmaSS<TILE, 0>::template run_at<A, B>(sp[1], do_desc, v_desc, J + KK != 0);
      });
      wgmma_commit();
    };

    // The next tile's partials run on the tensor cores while this tile's are summed over
    // the cluster and its dS and dQ product run; they are published once done.
    mbar_wait(q_full, 0);
    float sp[2][TILE / 2], sp_next[2][TILE / 2];
    partial(sp, r);
    wgmma_wait<0>();
    fence_regs(sp[0]);
    fence_regs(sp[1]);
    ex.publish(sp, wg, t, tile & 1);
    for (int kt = kt_begin; kt < kt_end; ++kt, ++tile) {
      const int k0 = kt * TILE;
      const int key_ok = lane < TILE && k0 + lane < T ? (mb ? mb[k0 + lane] != 0 : 1) : 0;
      const uint32_t st = ring + r.stage * L.stage;
      RingPos r_next = r;
      if (++r_next.stage == stages) {
        r_next.stage = 0;
        r_next.phase ^= 1;
      }
      const bool more = kt + 1 < kt_end;
      partial(sp_next, more ? r_next : r);  // after the last tile a product unused (no branch
      ex.finish(sp, wg, t, tile & 1);       // around a wgmma: it would be serialized)

      // P = exp2(S - lse) on valid pairs (0 elsewhere, set explicitly: the lse of a query
      // with no valid key is only "very negative"), dS = P (dP - delta), rounded to bf16 as
      // hi + lo in wgmma's A-operand places; the same bits in every warpgroup
      const uint32_t word = __ballot_sync(0xffffffffu, key_ok != 0);
      const bool masked = word != TILE_LANES || (causal && k0 + TILE - 1 > q0) ||
                          (window > 0 && k0 <= q0 + ROWS - 1 - window);
      uint32_t ds_hi[TILE / 16][4], ds_lo[TILE / 16][4];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int qp = row + 8 * rr;
          const int hi = causal ? qp - k0 : TILE;  // keys relative to k0 it may see
          const int lo = window > 0 ? qp - window + 1 - k0 : 0;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * rr + e, c = 8 * j + 2 * tq + e;
            float p = ex2(fmaf(sp[0][i], qk_scale, -lse2[rr]));
            if (masked) p = ((word >> c) & 1) && c <= hi && c >= lo ? p : 0.f;
            ds[e] = p * (sp[1][i] - dl[rr]);
          }
          const int slot = (j % 2) * 2 + rr;
          const uint32_t packed = pack_bf16(ds[0], ds[1]);
          ds_hi[j / 2][slot] = packed;
          ds_lo[j / 2][slot] = pack_bf16(ds[0] - bf16_lo(packed), ds[1] - bf16_hi(packed));
        }
      }

      // dQ[:, slice] += (dS_hi + dS_lo) K[:, slice]; K read MN-major from its boxes,
      // KV_BLOCK apart
      const uint32_t sk = st + lb * KV_BLOCK;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        const uint64_t b_k = smem_desc(sk + 2048 * kk, KV_BLOCK, 1024);
        WgmmaRS<64 * NB, 1>::run(acc, ds_hi[kk], b_k, 1);
        WgmmaRS<64 * NB, 1>::run(acc, ds_lo[kk], b_k, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // this tile's dQ product and the next tile's partials
      fence_regs(acc);
      fence_regs(sp_next[0]);
      fence_regs(sp_next[1]);
      keep_regs(ds_hi);
      keep_regs(ds_lo);
      if (lane == 0) mbar_arrive(empty + 8 * r.stage);
      // thread 0 refills the stage, with the tile `stages` ahead (of this pass or the next),
      // once both warpgroups are done with it
      if (threadIdx.x == 0 && (int)tile + stages < all_tiles) {
        mbar_wait(empty + 8 * r.stage, r.phase);
        load_kv(tile + stages);
      }
      __syncwarp();
      if (more) {
        ex.publish(sp_next, wg, t, (tile + 1) & 1);
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) {
          sp[0][i] = sp_next[0][i];
          sp[1][i] = sp_next[1][i];
        }
      }
      r = r_next;
    }

    // epilogue: dQ = scale * acc as bf16, the thread's two rows and its slice
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qp = row + 8 * rr;
      if (qp >= T) continue;
      bf16* out = dq + b * sdqb + qp * sdqt + h * sdqh + BOX * gs + 2 * tq;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 32 * j + 4 * jj + 2 * rr;
          *reinterpret_cast<uint32_t*>(out + BOX * j + 8 * jj) =
              pack_bf16(acc[i] * scale, acc[i + 1] * scale);
        }
      }
    }
  };
  run_passes<PASSES>(consume, nc, run);
  cluster_sync();
}

// the plan the wrapper computed against this file's: the same, or refused. K1 in at most the
// portable 8 CTAs and one pass at 32 keys a stage; K4 and K5 in up to the H100's 16, in one
// pass at 32 rows a stage or two at 16 (the kernels' instances)
bool plan_ok(Kind kind, int D, int cluster, int stages, int tile, float scale) {
  if (!(D > 512 && D % BOX == 0 && scale > 0.f)) return false;
  const int nb = D / BOX;
  const int most = kind == FWD ? MAX_CLUSTER : MAX_NONPORTABLE_CLUSTER;
  return plan_passes(kind, nb) <= MAX_PASSES && cluster == plan_cluster(kind, nb) &&
         cluster >= 2 && cluster <= most && tile == plan_tile(kind, nb) && stages >= 2 &&
         stages == plan_stages(kind, nb, cluster, tile);
}

// K4's (K == DKV) or K5's instance for a plan of `passes` passes, at its ring tile (tile_of)
template <Kind K, int PASSES>
auto instance() {
  if constexpr (K == DKV)
    return cluster_dkv_kernel<tile_of(PASSES), PASSES>;
  else
    return cluster_dq_kernel<tile_of(PASSES), PASSES>;
}
template <Kind K>
auto kernel_for(int passes) { return passes == 1 ? instance<K, 1>() : instance<K, 2>(); }

}  // namespace

// q [B, T, Hq, D], k and v [B, T, Hkv, D] bf16 (D > 512, a multiple of 64) with any 16-byte
// aligned strides, described by `maps` (3 x 11 numbers, ops/flash_attention.py:
// tensor_map_plan, boxes of 64 query rows and 32 keys); `cluster` and `stages` as
// ops/flash_attention.py:forward_plan gives them; kv_mask [B, T] int32 or null -> out
// [B, T, Hq, D] bf16 (strides sob, sot, soh in elements), lse [B, Hq, T] fp32, out_f32
// dense [B, T, Hq, D] fp32 or null
extern "C" int flash_attn_cluster_fwd_bf16(const void* q, const void* k, const void* v,
                                           const void* kv_mask, void* out, void* lse,
                                           void* out_f32, int B, int T, int Hq, int Hkv, int D,
                                           const long long* maps, int cluster, int stages,
                                           long long sob, long long sot, long long soh,
                                           float scale, int causal, int window, void* stream) {
  if (!plan_ok(FWD, D, cluster, stages, TILE, scale) || T <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!tmap::make_map_4d(&map_q, q, maps) || !tmap::make_map_4d(&map_k, k, maps + 11) ||
      !tmap::make_map_4d(&map_v, v, maps + 22))
    return (int)cudaErrorNotSupported;
  const Layout L(FWD, Slices{D / BOX, cluster, 1}, stages, TILE);
  const dim3 grid((T + ROWS - 1) / ROWS * cluster, Hq, B);
  return (int)launch_cluster(cluster_fwd_kernel, grid, THREADS, cluster, L.request(),
                             static_cast<cudaStream_t>(stream), map_q, map_k, map_v,
                             static_cast<const int*>(kv_mask), static_cast<bf16*>(out),
                             static_cast<float*>(lse), static_cast<float*>(out_f32), T, Hq, Hkv,
                             D, stages, sob, sot, soh, scale, causal, window);
}

// strides: (b, t, h) in elements for q, k, v, dout, dk, dv (18 values, of which dk's and
// dv's are used); maps: the 4-D tensor maps of q, k, v, dout (4 x 11 numbers) for boxes of
// `tile` queries and 64 keys; `cluster`, `stages` and `tile` as ops/flash_attention.py:
// dkv_plan gives them; lse and delta [B, Hq, T] fp32
extern "C" int flash_attn_cluster_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                               const void* kv_mask, const void* dout,
                                               const void* lse, const void* delta, void* dk,
                                               void* dv, int B, int T, int Hq, int Hkv, int D,
                                               const long long* s, const long long* maps,
                                               int cluster, int stages, int tile, float scale,
                                               int causal, int window, void* stream) {
  if (!plan_ok(DKV, D, cluster, stages, tile, scale) || T <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tmap::make_map_4d(&map_q, q, maps) || !tmap::make_map_4d(&map_k, k, maps + 11) ||
      !tmap::make_map_4d(&map_v, v, maps + 22) || !tmap::make_map_4d(&map_do, dout, maps + 33))
    return (int)cudaErrorNotSupported;
  const int passes = plan_passes(DKV, D / BOX);
  const Layout L(DKV, Slices{D / BOX, cluster, passes}, stages, tile);
  const dim3 grid((T + ROWS - 1) / ROWS * cluster, Hkv, B);
  return (int)launch_cluster(kernel_for<DKV>(passes), grid, THREADS, cluster, L.request(),
                             static_cast<cudaStream_t>(stream), map_q, map_k, map_v, map_do,
                             static_cast<const int*>(kv_mask), static_cast<const float*>(lse),
                             static_cast<const float*>(delta), static_cast<bf16*>(dk),
                             static_cast<bf16*>(dv), T, Hq, Hkv, D, stages, s[12], s[13], s[14],
                             s[15], s[16], s[17], scale, causal, window);
}

// strides: (b, t, h) in elements for q, k, v, dout, dq (15 values, of which dq's are used);
// maps: the 4-D tensor maps of q, k, v, dout (4 x 11 numbers) for boxes of 64 queries and
// `tile` keys; `cluster`, `stages` and `tile` as ops/flash_attention.py:dq_plan gives them;
// lse and delta [B, Hq, T] fp32
extern "C" int flash_attn_cluster_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                              const void* kv_mask, const void* dout,
                                              const void* lse, const void* delta, void* dq,
                                              int B, int T, int Hq, int Hkv, int D,
                                              const long long* s, const long long* maps,
                                              int cluster, int stages, int tile, float scale,
                                              int causal, int window, void* stream) {
  if (!plan_ok(DQ, D, cluster, stages, tile, scale) || T <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tmap::make_map_4d(&map_q, q, maps) || !tmap::make_map_4d(&map_k, k, maps + 11) ||
      !tmap::make_map_4d(&map_v, v, maps + 22) || !tmap::make_map_4d(&map_do, dout, maps + 33))
    return (int)cudaErrorNotSupported;
  const int passes = plan_passes(DQ, D / BOX);
  const Layout L(DQ, Slices{D / BOX, cluster, passes}, stages, tile);
  const dim3 grid((T + ROWS - 1) / ROWS * cluster, Hq, B);
  return (int)launch_cluster(kernel_for<DQ>(passes), grid, THREADS, cluster, L.request(),
                             static_cast<cudaStream_t>(stream), map_q, map_k, map_v, map_do,
                             static_cast<const int*>(kv_mask), static_cast<const float*>(lse),
                             static_cast<const float*>(delta), static_cast<bf16*>(dq), T, Hq,
                             Hkv, D, stages, s[12], s[13], s[14], scale, causal, window);
}

// kind 0, 1, 2 (K1, K4, K5) at head dim D, in the plan's `cluster` CTAs, `stages` and ring
// `tile` -> how many of its clusters the card holds at once (cudaOccupancyMaxActiveClusters
// at the plan's shared memory); 0 where it cannot place one, -1 for a plan this file would
// refuse
extern "C" int flash_attn_cluster_fit(int kind, int D, int cluster, int stages, int tile) {
  if (kind < FWD || kind > DQ || !plan_ok((Kind)kind, D, cluster, stages, tile, 1.f)) return -1;
  const int passes = plan_passes((Kind)kind, D / BOX);
  const uint32_t smem = Layout((Kind)kind, Slices{D / BOX, cluster, passes}, stages, tile).request();
  if (kind == FWD) return max_active_clusters(cluster_fwd_kernel, THREADS, cluster, smem);
  if (kind == DKV) return max_active_clusters(kernel_for<DKV>(passes), THREADS, cluster, smem);
  return max_active_clusters(kernel_for<DQ>(passes), THREADS, cluster, smem);
}
