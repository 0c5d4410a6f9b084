// Single-token decode attention over a split prefix / generated KV cache, for Hopper
// (sm_90a), bf16 in and out, fp32 softmax.
//
// Replaces the TPU kernel projectiontrainer_tpu/ops/decode_attention.py:_decode_kernel
// (launched from _pallas_decode_attention). Same contract: the rows of one sample are
// its beams; the prefix cache [B, Hkv, P, D] is shared by all of them and masked by
// the per-sample prefix padding mask; each row has its own generated cache
// [R, Hkv, G, D] of which slots j <= t are live; a sliding window is measured in cache
// slot space, with the query at slot prefix_len + t; one softmax spans both caches.
//
// What bounds it on the H100: bytes. Each step reads the whole live cache once for
// ~4 flops per byte, far below the ~295 flops per byte where the tensor cores would
// become the limit; and at the served shape (batch 8, one KV head) there are only 8
// (batch, KV head) pairs for 132 SMs.
//
// Design: the live keys of each (batch, KV head) are cut into splits of `chunk` keys
// (ops/decode_attention.py:decode_plan sizes them so that the grid fills the card),
// one CTA each: grid (splits, Hkv, B * groups). A split of the shared prefix serves ALL
// nb * n_rep query rows of its (batch, KV head) (12 at 3 beams x 4 heads), so each
// prefix key is still read once for all beams, as the split cache intends; a split of
// one beam's generated slots serves that beam's n_rep rows. Shared memory holds the
// rows of a CTA in fp32 (q and O), at most MAX_M<D> of them (64; 16 at D = 512): more
// rows per (batch, KV head) (17 beams x 4 heads) are cut into row groups, each its own
// set of splits and its own combine, as if it were a (batch, KV head) of its own. A
// group is `bpg` whole beams of all n_rep rows or, where n_rep alone is too many, `rpg`
// of one beam's rows; each group reads the prefix again
// (ops/decode_attention.py:group_shape sizes them). Up to MAX_M rows there is one group,
// and the kernel is compiled without the groups' index arithmetic (GROUPED false). Inside a split, tiles of 32
// keys are loaded with 16-byte cp.async copies, the next tile in flight while the
// current one is computed on CUDA cores (scores with a warp a key, an online softmax
// with a warp a row, then P V with a thread a column pair and group of rows). Keys
// below the sliding window and generated slots after t belong to no split; padded
// prefix keys are masked inside their split. Each split writes its partial (row max m,
// sum l, unnormalised O) in fp32; the CTA that arrives last at its (batch, KV head)'s
// counter combines the partials in split order (so a rerun gives the same bits), writes
// the output and sets the counter back to 0, so one launch does everything and nothing
// is cleared between launches. A split whose keys are all padded leaves m = NEG_INF, l = 0, O = 0 and
// weighs exactly 0 in the combine. P stays fp32 up to the final division (the TPU
// kernel rounds the normalised P to bf16 before its P V product; a split cannot
// normalise before the combine). P and G may be any length: the kernel masks its own
// edges, so the caches need no padding.
//
// Head dims above 512 (any multiple of 256; the wrapper zero-pads the others) cut O's
// columns into slices of DC = 256, and each (batch, KV head, row group, slice) is a unit of
// its own, with its own partials, counter and combine (ops/decode_attention.py:decode_plan
// names the route):
// - "cluster", up to D = 2048 (C = D / 256 <= 8, the portable cluster size): a split runs
//   on a thread-block cluster of C CTAs, CTA `rank` owning columns [256 rank, 256 rank +
//   256) of q, K, V and O. It copies only its slice of each 32-key tile (the next tile in
//   flight, as at 512 and below), computes its slice's partial scores of the tile on the
//   tensor cores (mma.sync m16n8k16, q in bf16, rows padded to 16; with the scores on CUDA
//   cores and shuffle reductions the CTA was bound by instruction issue: 0.128 ms at
//   chip_smoke.py phase 2's shape against 0.059, kernels/check_decode_attn.py --wide
//   --time), and the C partial [rows x 32] tiles are summed once over the cluster
//   (cluster_sm90.cuh:ClusterSum: each element summed by one thread in slice order and the
//   sum sent to every CTA by st.async, so every CTA holds the same bits of S, m and l and a
//   rerun gives the same bits). Then every CTA runs the same online softmax and its own
//   slice's P V on CUDA cores (P in fp32). Each score is computed once, each K and V
//   element read by one CTA, and q is held at the slice's width, so a CTA holds 64 rows at
//   every D of the route.
// - "column blocks", above 2048: one CTA a column block, which computes its split's scores
//   over the whole D again, K's row chunk by chunk (256 columns at a time, accumulated in
//   fp32 in sS), so every block finds the same (m, l) of a split, bit for bit; it reads V
//   and writes O only in its block. The q rows are held in fp32 at the full width, so the
//   rows a CTA holds are what 227 KB leave beside them (ops/decode_attention.py:max_rows: 8
//   at 4096). The chunks are copied one at a time, not ahead of their use: no model of the
//   repository has such a head dim, and the kernel is here to match the JAX package,
//   which runs XLA's decode attention there.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 2 and
// kernels/check_decode_attn.py --time, device ms; the kernel it replaced, one CTA a
// (batch, KV head), / the plain version / the library call beside it): batch 8, 3 beams,
// P = 831, G = 32, 128 CTAs: 0.039 (0.415 / 0.106 / 0.333); window 512, 144-152 CTAs:
// 0.043-0.045 (0.252 / 0.116 / 0.334); batch 1, 18-29 CTAs: 0.032-0.041 (plain
// 0.093-0.103, library 0.090-0.091); G = 1024 at t = 1000: 0.116, window 512 0.035 (plain
// 0.205 / 0.218, library 0.632 / 0.637). The bound at the served shape is 0.0023 (bytes):
// what is left is the splits' latency (load, scores with shuffle reductions, softmax,
// P V, partial written) and the serial combine of ~14 partials in one CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TK = 32;  // keys per tile: one per lane in the softmax pass
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -2.3819763e38f;

// query rows a CTA holds (ops/decode_attention.py:max_rows): the K/V tiles in flight
// and the rows' fp32 q and O within the 227 KB of one SM (199 KB at 64 rows of 256 and at
// 16 rows of 512; 191,264 bytes at 64 rows of a cluster's slice)
template <int D>
constexpr int MAX_M = D > 256 ? 16 : 64;

constexpr int DC = 256;  // O's columns a CTA above 512 (a slice or a column block)
constexpr int KS = DC + 8;  // a cluster CTA's K and bf16 q rows in shared memory: the 8 rows
                            // of an mma.sync fragment on distinct banks
constexpr size_t SMEM_LIMIT = 232448;

// the kernel's routes: one CTA a split (up to 512); above it column blocks, or slices
// over a cluster
enum Route { SPLITS, BLOCKS, CLUSTER };

// the cluster's exchange at M rows over C CTAs (cluster_sm90.cuh:ClusterSum): [C][piece]
// and [M * TK / 4] float4, four barriers
__host__ __device__ __forceinline__ size_t exchange_bytes(int M, int C) {
  const int total = M * TK / 4, piece = (total + C - 1) / C;
  return (size_t)16 * (C * piece + total) + 32;
}

// W: the rows' width (D, or the whole head dim above 512, where D is a slice or block)
template <int D>
size_t smem_bytes(int M, int W, Route route) {
  if (route == CLUSTER)
    return (size_t)2 * TK * KS * 2              // sK bf16 [2][TK][KS]: two tiles in flight
           + (size_t)2 * TK * D * 2             // sV bf16 [2][TK][D]
           + (size_t)(M + 15) / 16 * 16 * KS * 2  // q bf16 [M rounded up to 16][KS]
           + (size_t)M * D * 4 + (size_t)M * TK * 4 + exchange_bytes(M, W / D) + (size_t)M * 4 * 3;
  return (size_t)2 * TK * D * 2 * 2                     // sK, sV bf16 [2][TK][D]: two tiles in flight
         + (size_t)M * (route == BLOCKS ? W : D) * 4    // sQ fp32 [M][W or D]
         + (size_t)M * D * 4                            // sO fp32 [M][D]
         + (size_t)M * TK * 4                           // sS fp32 [M][TK]: scores, then probabilities
         + (size_t)M * 4 * 3;                           // sM, sL, sCorr fp32 [M]
}

struct Shared {
  bf16* k;  // [2][TK][D] ([2][TK][KS] on a cluster)
  bf16* v;
  float* q;  // [M][W] (column blocks) or [M][D]
  bf16* qb;  // on a cluster: [M rounded up to 16][KS], zero past the split's rows
  float* o;  // [M][D]
  float* s;
  float* m;
  float* l;
  float* corr;
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// start copying n <= TK columns c0 .. c0 + D - 1 of key rows (row r at kbase + r * W) and
// of value rows into a tile buffer each (sv null: the keys alone; the keys' rows ks apart)
template <int D>
__device__ __forceinline__ void load_tile(bf16* sk, bf16* sv, const bf16* kbase,
                                          const bf16* vbase, int n, int W = D, int ks = D) {
  for (int i = threadIdx.x; i < n * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (sk) cp_async_16(sk + r * ks + c, kbase + (long long)r * W + c);
    if (sv) cp_async_16(sv + r * D + c, vbase + (long long)r * W + c);
  }
  cp_async_commit();
}

// The scores of a tile of n <= TK keys against the nr query rows of the split, over the
// columns c0 .. c0 + D - 1 of the rows (sk: those columns of the keys; the q rows of
// width W in sQ), into sS: the first chunk of a row writes, later ones add, the last
// scales. key_valid(j) says whether tile key j (0-based inside the tile) is attended.
template <int D, typename KeyValid>
__device__ void tile_scores(const Shared& sh, const bf16* sk, int n, int nr, float scale,
                            KeyValid key_valid, int W = D, int c0 = 0, bool first = true,
                            bool last = true) {
  constexpr int E = D / 32;  // elements of a key row per lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // scores: warp w takes keys w, w + 8, ...; lanes split D, then shuffle reductions of
  // four rows at a time, interleaved
  for (int kk = warp; kk < TK; kk += WARPS) {
    if (!(kk < n && key_valid(kk))) {  // the same for the whole warp
      if (last)
        for (int r = lane; r < nr; r += 32) sh.s[r * TK + kk] = NEG_INF;
      continue;
    }
    float kr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kr[e] = __bfloat162float(sk[kk * D + lane * E + e]);
    for (int r0 = 0; r0 < nr; r0 += 4) {
      float part[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // past nr: not stored
        const float* qr = sh.q + min(r0 + j, nr - 1) * W + c0 + lane * E;
        part[j] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part[j] += qr[e] * kr[e];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r0 + j < nr) {
            float* s = sh.s + (r0 + j) * TK + kk;
            const float v = first ? part[j] : *s + part[j];
            *s = last ? v * scale : v;
          }
      }
    }
  }
}

// A cluster CTA's partial scores of a tile of n <= TK keys (sk: their 256 columns of this
// CTA's slice, rows KS apart) against the split's nr rows (sh.qb) on the tensor cores
// (mma.sync m16n8k16: bf16 operands, exact; fp32 sums), into sS [nr][TK]; keys that are not
// attended 0 (key_ok(j)). Warp w takes the keys 8 (w % 4) .. + 7 of the row tiles w / 4,
// w / 4 + 2, two chains of sums (even and odd k-steps, added at the end).
template <typename KeyOk>
__device__ void slice_scores(const Shared& sh, const bf16* sk, int nr, KeyOk key_ok) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nt = warp % 4;
  for (int mt = warp / 4; mt * 16 < nr; mt += 2) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk) {
      const bf16* qa = sh.qb + (16 * mt + g) * KS + 16 * kk + 2 * t;
      const bf16* kb = sk + (8 * nt + g) * KS + 16 * kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * KS), ld32(qa + 8), ld32(qa + 8 * KS + 8)};
      sm90::mma16816(acc[kk & 1], a, ld32(kb), ld32(kb + 8));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
      if (r < nr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 8 * nt + 2 * t + e;
          sh.s[r * TK + kk] = key_ok(kk) ? acc[0][2 * h + e] + acc[1][2 * h + e] : 0.f;
        }
    }
  }
}

// The online softmax of the tile's scores in sS, then O = O * corr + P V (sv: the tile's
// value rows, D columns), the tile's keys KH at a time (KH < TK: the row's sum carried
// through sO in fp32 between them, so the same additions in the same order, and KH
// values of V in a thread's registers instead of TK)
template <int D, int KH = TK>
__device__ void softmax_pv(const Shared& sh, const bf16* sv, int n, int nr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // online softmax: warp per row, lane per key
  for (int r = warp; r < nr; r += WARPS) {
    const float s = sh.s[r * TK + lane];
    const bool ok = s > 0.5f * NEG_INF;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = sh.m[r];
    const float m_new = fmaxf(m_old, mx);
    const float p = ok ? __expf(s - m_new) : 0.f;  // explicit zero for masked keys
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float corr = __expf(m_old - m_new);
    sh.s[r * TK + lane] = p;
    __syncwarp();
    if (lane == 0) {
      sh.l[r] = sh.l[r] * corr + sum;
      sh.m[r] = m_new;
      sh.corr[r] = corr;
    }
  }
  __syncthreads();

  // O = O * corr + P V: a thread per column pair and group of rows, with the values of its
  // two columns of KH keys in registers (zero past n, where P is 0 too)
  constexpr int CP = D / 2;           // column pairs
  constexpr int RG = THREADS / CP;    // row groups: 2 at D = 256, 4 at 128, 8 at 64
  const int cp = threadIdx.x % CP, rg = threadIdx.x / CP;
#pragma unroll
  for (int k0 = 0; k0 < TK; k0 += KH) {
    float2 vr[KH];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
      vr[kk] = k0 + kk < n ? __bfloat1622float2(
                                 reinterpret_cast<const __nv_bfloat162*>(sv + (k0 + kk) * D)[cp])
                           : make_float2(0.f, 0.f);
    for (int r = rg; r < nr; r += RG) {
      float2* o = reinterpret_cast<float2*>(sh.o + r * D) + cp;
      float2 acc = *o;
      if (k0 == 0) {
        const float corr = sh.corr[r];
        acc = make_float2(acc.x * corr, acc.y * corr);
      }
      const float4* pr = reinterpret_cast<const float4*>(sh.s + r * TK + k0);
#pragma unroll
      for (int k4 = 0; k4 < KH / 4; ++k4) {
        const float4 p = pr[k4];
        acc.x += p.x * vr[4 * k4].x + p.y * vr[4 * k4 + 1].x + p.z * vr[4 * k4 + 2].x +
                 p.w * vr[4 * k4 + 3].x;
        acc.y += p.x * vr[4 * k4].y + p.y * vr[4 * k4 + 1].y + p.z * vr[4 * k4 + 2].y +
                 p.w * vr[4 * k4 + 3].y;
      }
      *o = acc;
    }
  }
}

// One tile of n <= TK keys in shared memory (D columns) against the nr query rows of the
// split. key_valid(j) says whether tile key j (0-based inside the tile) is attended.
template <int D, typename KeyValid>
__device__ void attend_tile(const Shared& sh, const bf16* sk, const bf16* sv, int n, int nr,
                            float scale, KeyValid key_valid) {
  tile_scores<D>(sh, sk, n, nr, scale, key_valid);
  __syncthreads();
  softmax_pv<D>(sh, sv, n, nr);
}

// the u-th split that holds keys of a row of `beam`: every prefix split, then the beam's
// own generated ones, in split order
__device__ __forceinline__ int covering_split(int u, int beam, int p_splits, int g_splits) {
  return u < p_splits ? u : p_splits + beam * g_splits + (u - p_splits);
}

// GROUPED: the rows of a (batch, KV head) are cut into row groups; without it the
// group is the whole (batch, KV head), and the indices below fold to constants. ROUTE
// (above 512, where the rows are W wide, a multiple of D = DC): BLOCKS, a CTA owns the
// column block blockIdx.z % (W / D) of O; CLUSTER, the W / D CTAs of a cluster (along
// x) share a split, CTA `rank` owning slice `rank` of q, K, V and O. SPLITS: W = D.
template <int D, bool GROUPED, Route ROUTE>
__device__ __forceinline__ void
decode_attn(const bf16* __restrict__ q, const bf16* __restrict__ kp,
            const bf16* __restrict__ vp, const bf16* __restrict__ kg,
            const bf16* __restrict__ vg, const int* __restrict__ prefix_mask,
            bf16* __restrict__ out, float* __restrict__ o_part, float* __restrict__ ml_part,
            int* __restrict__ counter, int nb, int Hkv, int n_rep, int P, int G, int p_begin,
            int p_splits, int g_begin, int g_end, int g_splits, int chunk, int groups, int bpg,
            int rpg, float scale, int W_) {
  constexpr bool WIDE = ROUTE != SPLITS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;  // one a CTA: each kernel below instantiates this function once
  const int W = WIDE ? W_ : D, ncb = WIDE ? W_ / D : 1;
  const int cb = ROUTE == BLOCKS    ? blockIdx.z % ncb
                 : ROUTE == CLUSTER ? (int)sm90::cluster_rank()
                                    : 0;
  const int z = ROUTE == BLOCKS ? blockIdx.z / ncb : blockIdx.z;
  const int split = ROUTE == CLUSTER ? blockIdx.x / ncb : blockIdx.x;
  const int h = blockIdx.y, b = GROUPED ? z / groups : z;
  // this CTA's row group: beams [beam0, beam0 + nbu) x reps [rep0, rep0 + nru) of its
  // (batch, KV head); its rows r = local beam * nru + local rep
  const int grp = GROUPED ? z % groups : 0;
  const int n_rg = GROUPED ? (n_rep + rpg - 1) / rpg : 1;
  const int beam0 = GROUPED ? grp / n_rg * bpg : 0, nbu = GROUPED ? min(bpg, nb - beam0) : nb;
  const int rep0 = GROUPED ? grp % n_rg * rpg : 0, nru = GROUPED ? min(rpg, n_rep - rep0) : n_rep;
  const int M = nbu * nru, M_max = GROUPED ? bpg * rpg : M;
  const int S = p_splits + nbu * g_splits, S_max = GROUPED ? p_splits + bpg * g_splits : S;
  if (GROUPED && split >= S) return;  // a smaller last group: this split (and its cluster) is not its
  // the columns of q a CTA holds: all W of them (column blocks), or its D from q0
  const int QW = ROUTE == BLOCKS ? W : D, q0 = ROUTE == CLUSTER ? cb * D : 0;
  const int KST = ROUTE == CLUSTER ? KS : D;  // K's rows in shared memory
  Shared sh;
  sh.k = reinterpret_cast<bf16*>(smem);
  sh.v = sh.k + 2 * TK * KST;
  sh.q = reinterpret_cast<float*>(sh.v + 2 * TK * D);
  sh.qb = reinterpret_cast<bf16*>(sh.q);
  sh.o = ROUTE == CLUSTER ? reinterpret_cast<float*>(sh.qb + (M + 15) / 16 * 16 * KS) : sh.q + M * QW;
  sh.s = sh.o + M * D;
  float* stats = sh.s + M * TK;

  const int Hq = Hkv * n_rep;
  const int bh = b * Hkv + h;
  // the group's (and column block's or slice's) counter and scratch
  const int unit = (GROUPED ? bh * groups + grp : bh) * ncb + cb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this split's keys [k_begin, k_end) and query rows [row0, row0 + nr)
  const bool in_prefix = split < p_splits;
  int row0, nr, k_begin, k_end;
  const bf16 *kbase, *vbase;
  if (in_prefix) {
    row0 = 0;
    nr = M;
    k_begin = p_begin + split * chunk;
    k_end = min(P, k_begin + chunk);
    kbase = kp + (long long)bh * P * W + q0;
    vbase = vp + (long long)bh * P * W + q0;
  } else {
    const int gs = split - p_splits, beam = gs / g_splits;  // the group's local beam
    row0 = beam * nru;
    nr = nru;
    k_begin = g_begin + (gs % g_splits) * chunk;
    k_end = min(g_end, k_begin + chunk);
    const long long row = (long long)(b * nb + beam0 + beam) * Hkv + h;
    kbase = kg + row * G * W + q0;
    vbase = vg + row * G * W + q0;
  }

  // a cluster's exchange of partial scores: nr rows x TK keys a round (after sS)
  sm90::ClusterSum ex{};
  if (ROUTE == CLUSTER) {
    const uint32_t part = sm90::smem_addr(stats);
    const int total = M * TK / 4, piece = (total + ncb - 1) / ncb;
    ex = {part, part + 16 * ncb * piece, part + 16 * (ncb * piece + total), (uint32_t)ncb,
          (uint32_t)cb, nr * TK / 4, WARPS};
    stats += exchange_bytes(M, ncb) / 4;
    if (threadIdx.x == 0) {
      ex.init();
      sm90::mbar_init_fence();
    }
    sm90::cluster_sync();  // the barriers ready in every CTA before any remote use
  }
  sh.m = stats;
  sh.l = sh.m + M;
  sh.corr = sh.l + M;

  const int* pm = prefix_mask + (long long)b * P;
  const int n_tiles = (k_end - k_begin + TK - 1) / TK;
  if (ROUTE != BLOCKS && n_tiles > 0)
    load_tile<D>(sh.k, sh.v, kbase + (long long)k_begin * W, vbase + (long long)k_begin * W,
                 min(TK, k_end - k_begin), W, KST);

  // query rows r = local beam * nru + local rep: row (b * nb + beam0 + beam) of q, head
  // h * n_rep + rep0 + rep; its columns [q0, q0 + QW) (on a cluster bf16, 16 bytes a copy,
  // and zero rows up to a multiple of 16)
  const auto q_row = [&](int r) {
    const int beam = beam0 + (row0 + r) / nru, rep = rep0 + (row0 + r) % nru;
    return q + ((long long)(b * nb + beam) * Hq + h * n_rep + rep) * W + q0;
  };
  for (int i = threadIdx.x; ROUTE == CLUSTER && i < (nr + 15) / 16 * 16 * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    *reinterpret_cast<uint4*>(sh.qb + r * KS + c) =
        r < nr ? *reinterpret_cast<const uint4*>(q_row(r) + c) : make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; ROUTE != CLUSTER && i < nr * QW; i += THREADS)
    sh.q[i] = __bfloat162float(q_row(i / QW)[i % QW]);
  for (int i = threadIdx.x; i < nr * D; i += THREADS) sh.o[i] = 0.f;
  for (int r = threadIdx.x; r < nr; r += THREADS) {
    sh.m[r] = NEG_INF;
    sh.l[r] = 0.f;
  }

  // column blocks: a tile's scores chunk by chunk of D columns, then the tile's V block; one
  // copy at a time (a chunk in flight while the one before it is computed took 0.580
  // against 0.584 ms at 8 x 3 beams, P = 831, D = 1024: the scores' arithmetic, done
  // again by every column block, bounds it, not the copies)
  for (int it = 0; ROUTE == BLOCKS && it < n_tiles; ++it) {
    const int j0 = k_begin + it * TK, n = min(TK, k_end - j0);
    for (int c = 0; c < ncb; ++c) {
      __syncthreads();  // the buffer's last reads (and, at the first, the query rows' writes)
      load_tile<D>(sh.k, nullptr, kbase + (long long)j0 * W + c * D, nullptr, n, W);
      cp_async_wait<0>();
      __syncthreads();
      if (in_prefix)
        tile_scores<D>(sh, sh.k, n, nr, scale, [&](int kk) { return pm[j0 + kk] != 0; }, W,
                       c * D, c == 0, c == ncb - 1);
      else
        tile_scores<D>(sh, sh.k, n, nr, scale, [](int) { return true; }, W, c * D, c == 0,
                       c == ncb - 1);
    }
    load_tile<D>(nullptr, sh.v, nullptr, vbase + (long long)j0 * W + cb * D, n, W);
    cp_async_wait<0>();
    __syncthreads();  // the tile's scores and values in place for all
    softmax_pv<D, TK / 2>(sh, sh.v, n, nr);
  }
  if (ROUTE == BLOCKS) __syncthreads();

  for (int it = 0; ROUTE != BLOCKS && it < n_tiles; ++it) {
    const int j0 = k_begin + it * TK, n = min(TK, k_end - j0);
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile into the other buffer, then wait for this one
      const int j1 = j0 + TK;
      load_tile<D>(sh.k + (buf ^ 1) * TK * KST, sh.v + (buf ^ 1) * TK * D,
                   kbase + (long long)j1 * W, vbase + (long long)j1 * W, min(TK, k_end - j1), W,
                   KST);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, at the first, the query rows) in place for all
    const bf16* sk = sh.k + buf * TK * KST;
    const bf16* sv = sh.v + buf * TK * D;
    const auto key_ok = [&](int kk) { return kk < n && (!in_prefix || pm[j0 + kk] != 0); };
    if (ROUTE == SPLITS) {
      if (in_prefix)
        attend_tile<D>(sh, sk, sv, n, nr, scale, [&](int kk) { return pm[j0 + kk] != 0; });
      else
        attend_tile<D>(sh, sk, sv, n, nr, scale, [](int) { return true; });
    } else {
      // this slice's partial scores, summed over the cluster; then the sums scaled (keys
      // that are not attended NEG_INF) into sS, the same bits in every CTA
      slice_scores(sh, sk, nr, key_ok);
      __syncthreads();
      ex.run(reinterpret_cast<const float4*>(sh.s), it & 1, threadIdx.x, THREADS);
      for (int i = threadIdx.x; i < nr * TK / 4; i += THREADS) {
        const float4 v = sm90::ld_shared(ex.sum + 16 * i);
        const int kk = 4 * i % TK;
        float4 s;
        s.x = key_ok(kk) ? v.x * scale : NEG_INF;
        s.y = key_ok(kk + 1) ? v.y * scale : NEG_INF;
        s.z = key_ok(kk + 2) ? v.z * scale : NEG_INF;
        s.w = key_ok(kk + 3) ? v.w * scale : NEG_INF;
        reinterpret_cast<float4*>(sh.s)[i] = s;
      }
      ex.release(lane);
      __syncthreads();
      softmax_pv<D, TK / 2>(sh, sv, n, nr);
    }
    __syncthreads();  // every thread is done with the buffer before it is refilled
  }
  // no CTA leaves while another of its cluster may still signal its barriers
  if (ROUTE == CLUSTER) sm90::cluster_sync();

  // this split's partial: unnormalised O, row max m and sum l, fp32
  // [B * Hkv * groups, S_max, M_max, ...] (the group's M of M_max rows used)
  const long long part = (long long)unit * S_max + split;
  for (int i = threadIdx.x; i < nr * D; i += THREADS)
    o_part[(part * M_max + row0) * D + i] = sh.o[i];
  for (int r = threadIdx.x; r < nr; r += THREADS) {
    ml_part[(part * M_max + row0 + r) * 2] = sh.m[r];
    ml_part[(part * M_max + row0 + r) * 2 + 1] = sh.l[r];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter + unit, 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last CTA of the (batch, KV head): combine the partials of each row in split
  // order; every row has a live key (its own slot t), so its total sum is positive.
  // A warp a row finds its max and sum, the lanes taking the splits (a fixed order of
  // sums); then the weighted partials are summed into sO, in split order.
  const int n_cover = p_splits + g_splits;
  const float* ml = ml_part + (long long)unit * S_max * M_max * 2;
  const float* op = o_part + (long long)unit * S_max * M_max * D;
  for (int r = warp; r < M; r += WARPS) {
    const int beam = r / nru;
    float mt = NEG_INF;
    for (int u = lane; u < n_cover; u += 32) {
      const long long sp = covering_split(u, beam, p_splits, g_splits);
      mt = fmaxf(mt, __ldcg(ml + (sp * M_max + r) * 2));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    float lt = 0.f;
    for (int u = lane; u < n_cover; u += 32) {
      const long long sp = covering_split(u, beam, p_splits, g_splits);
      lt += __ldcg(ml + (sp * M_max + r) * 2 + 1) * __expf(__ldcg(ml + (sp * M_max + r) * 2) - mt);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    if (lane == 0) {
      sh.m[r] = mt;
      sh.l[r] = lt;
    }
  }
  // the partials go through the K/V buffers (free now), `per` of the row blocks [M][D]
  // that the rows' u-th covering splits hold at a time, by 16-byte cp.async copies; their
  // weights exp(m - max) go to sS
  float* stage = reinterpret_cast<float*>(sh.k);
  const int per = max(1, min(TK, 2 * TK / M));  // [M][D] fp32 blocks in 4 * TK * D bf16,
                                                // their weights in sS [M][TK]
  for (int i = threadIdx.x; i < M * D; i += THREADS) sh.o[i] = 0.f;
  for (int u0 = 0; u0 < n_cover; u0 += per) {
    const int nu = min(per, n_cover - u0);
    __syncthreads();  // the row statistics, or the previous round's last reads
    for (int i = threadIdx.x; i < nu * M * (D / 4); i += THREADS) {
      const int uu = i / (M * (D / 4)), r = (i / (D / 4)) % M, c = (i % (D / 4)) * 4;
      const long long sp = covering_split(u0 + uu, r / nru, p_splits, g_splits);
      cp_async_16(stage + ((long long)uu * M + r) * D + c, op + (sp * M_max + r) * D + c);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < M * nu; i += THREADS) {
      const int r = i / nu, uu = i % nu;
      const long long sp = covering_split(u0 + uu, r / nru, p_splits, g_splits);
      sh.s[r * TK + uu] = __expf(__ldcg(ml + (sp * M_max + r) * 2) - sh.m[r]);
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < M * D; i += THREADS) {
      const int r = i / D;
      float acc = sh.o[i];
      for (int uu = 0; uu < nu; ++uu) acc += sh.s[r * TK + uu] * stage[uu * M * D + i];
      sh.o[i] = acc;
    }
  }
  for (int i = threadIdx.x; i < M * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int beam = beam0 + r / nru, rep = rep0 + r % nru;
    out[((long long)(b * nb + beam) * Hq + h * n_rep + rep) * W + cb * D + d] =
        __float2bfloat16(sh.o[i] / sh.l[r]);
  }
  if (threadIdx.x == 0) counter[unit] = 0;  // ready for the next launch
}

#define DECODE_ATTN_PARAMS                                                                    \
  const bf16 *__restrict__ q, const bf16 *__restrict__ kp, const bf16 *__restrict__ vp,       \
      const bf16 *__restrict__ kg, const bf16 *__restrict__ vg,                                \
      const int *__restrict__ prefix_mask, bf16 *__restrict__ out,                             \
      float *__restrict__ o_part, float *__restrict__ ml_part, int *__restrict__ counter,      \
      int nb, int Hkv, int n_rep, int P, int G, int p_begin, int p_splits, int g_begin,        \
      int g_end, int g_splits, int chunk, int groups, int bpg, int rpg, float scale, int W
#define DECODE_ATTN_ARGS                                                                      \
  q, kp, vp, kg, vg, prefix_mask, out, o_part, ml_part, counter, nb, Hkv, n_rep, P, G,         \
      p_begin, p_splits, g_begin, g_end, g_splits, chunk, groups, bpg, rpg, scale, W

template <int D, bool GROUPED, Route ROUTE>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(DECODE_ATTN_PARAMS) {
  decode_attn<D, GROUPED, ROUTE>(DECODE_ATTN_ARGS);
}

// the cluster route: two CTAs an SM where shared memory allows (up to ~20 rows), in 128
// registers (left to itself ptxas took 80 and spilled)
template <bool GROUPED>
__global__ void __launch_bounds__(THREADS, 2) decode_attn_cluster_kernel(DECODE_ATTN_PARAMS) {
  decode_attn<DC, GROUPED, CLUSTER>(DECODE_ATTN_ARGS);
}
#undef DECODE_ATTN_ARGS
#undef DECODE_ATTN_PARAMS

template <int D, bool GROUPED, Route ROUTE>
auto kernel_of() {
  if constexpr (ROUTE == CLUSTER)
    return decode_attn_cluster_kernel<GROUPED>;
  else
    return decode_attn_kernel<D, GROUPED, ROUTE>;
}

// W: the rows' width (D, or a multiple of D = DC above 512: column blocks or a cluster)
template <int D, bool GROUPED, Route ROUTE>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* kg,
                   const void* vg, const void* prefix_mask, void* out, void* o_part,
                   void* ml_part, void* counter, int B, int nb, int Hkv, int n_rep, int P, int G,
                   int p_begin, int p_splits, int g_begin, int g_end, int g_splits, int chunk,
                   int groups, int bpg, int rpg, float scale, int W, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(bpg * rpg, W, ROUTE);
  if (chunk <= 0 || chunk % TK || g_splits <= 0 || p_splits < 0 || bpg < 1 || rpg < 1 ||
      (ROUTE == BLOCKS ? bytes > SMEM_LIMIT : bpg * rpg > MAX_M<D>) || bytes > SMEM_LIMIT ||
      (rpg < n_rep && bpg != 1) || rpg > n_rep ||
      groups != (nb + bpg - 1) / bpg * ((n_rep + rpg - 1) / rpg))
    return cudaErrorInvalidValue;  // not a plan of ops/decode_attention.py:decode_plan
  const auto kernel = kernel_of<D, GROUPED, ROUTE>();
  const int splits = p_splits + bpg * g_splits, ncb = W / D;
  const auto args = [&](auto run) {
    return run(static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
               static_cast<const bf16*>(vp), static_cast<const bf16*>(kg),
               static_cast<const bf16*>(vg), static_cast<const int*>(prefix_mask),
               static_cast<bf16*>(out), static_cast<float*>(o_part), static_cast<float*>(ml_part),
               static_cast<int*>(counter), nb, Hkv, n_rep, P, G, p_begin, p_splits, g_begin, g_end,
               g_splits, chunk, groups, bpg, rpg, scale, W);
  };
  if (ROUTE == CLUSTER)  // the slices of a split along x, one cluster
    return args([&](auto... a) {
      return sm90::launch_cluster(kernel, dim3(splits * ncb, Hkv, B * groups), THREADS, ncb,
                                  (uint32_t)bytes, stream, a...);
    });
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, Hkv, B * groups * ncb);
  args([&](auto... a) {
    kernel<<<grid, THREADS, bytes, stream>>>(a...);
    return 0;
  });
  return cudaGetLastError();
}

}  // namespace

// o_part, ml_part: fp32 scratch of B * Hkv * groups * ncb * (p_splits + bpg * g_splits) *
// bpg * rpg * min(D, 256) and * 2 floats; counter: B * Hkv * groups * ncb ints, 0 before
// the launch and 0 after it (ncb = D / 256 slices or column blocks above 512, else 1);
// p_begin .. rpg: the plan of ops/decode_attention.py:decode_plan
extern "C" int decode_attn_bf16(const void* q, const void* kp, const void* vp,
                                const void* kg, const void* vg, const void* prefix_mask,
                                void* out, void* o_part, void* ml_part, void* counter, int B,
                                int nb, int Hkv, int n_rep, int P, int G, int D, int p_begin,
                                int p_splits, int g_begin, int g_end, int g_splits, int chunk,
                                int groups, int bpg, int rpg, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_ATTN_ARGS                                                                      \
  q, kp, vp, kg, vg, prefix_mask, out, o_part, ml_part, counter, B, nb, Hkv, n_rep, P, G,     \
      p_begin, p_splits, g_begin, g_end, g_splits, chunk, groups, bpg, rpg, scale, D, s
#define DECODE_ATTN_CASE(W)                                                                   \
  case W:                                                                                     \
    return (int)(groups > 1 ? launch<W, true, SPLITS> : launch<W, false, SPLITS>)(            \
        DECODE_ATTN_ARGS);
  switch (D) {
    DECODE_ATTN_CASE(64)
    DECODE_ATTN_CASE(128)
    DECODE_ATTN_CASE(256)
    DECODE_ATTN_CASE(512)
    default:
      if (D > 512 && D % DC == 0 && D / DC <= sm90::MAX_CLUSTER)
        return (int)(groups > 1 ? launch<DC, true, CLUSTER> : launch<DC, false, CLUSTER>)(
            DECODE_ATTN_ARGS);
      if (D > 512 && D % DC == 0)
        return (int)(groups > 1 ? launch<DC, true, BLOCKS> : launch<DC, false, BLOCKS>)(
            DECODE_ATTN_ARGS);
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_ATTN_CASE
#undef DECODE_ATTN_ARGS
}
