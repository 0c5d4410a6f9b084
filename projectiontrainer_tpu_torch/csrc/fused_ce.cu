// Fused linear + cross-entropy for Hopper (sm_90a): per-token NLL and its gradient
// with respect to the hidden states, the [tokens, vocab] logits never stored.
//
// Replaces the TPU kernels projectiontrainer_tpu/ops/fused_ce.py:_fwd_kernel (launched
// from _fwd_call) and :_bwd_kernel (launched from _bwd_call). Same contract:
//   forward   lse[t] = logsumexp_v(h[t] . W[v] * scale) (online over vocab tiles),
//             picked[t] = h[t] . W[label[t]] * scale, nll = lse - picked;
//   backward  dh[t] = sum_v (softmax[t, v] - onehot[t, v]) * g[t] * W[v], fp32, the
//             (softmax - onehot) * g factor rounded to bf16 before its product, as the
//             TPU kernel does; `* scale` and the downcast stay outside.
// The vocab tail past V is masked (probability 0) and its table rows are zero-filled by
// the TMA unit, as are the token rows past N, so nothing out of bounds reaches a sum.
// Ignored labels arrive as a dummy 0 with g = 0. Deterministic: every sum has a fixed
// order (each scratch element is owned by one thread; splits are combined in order).
//
// What bounds it on the H100: the tensor cores. 2 * N * D * V operations forward
// (1.24e12 at N = 2048, D = 1152, V = 262,144: 1.25 ms at 989 TFLOP/s) and twice that
// backward (the logits again, then dh = Q . W: 2.50 ms), against 0.18 ms for one read
// of the 604 MB table. What the design has to watch is the traffic from L2 to the SMs,
// since every token tile sweeps the whole table.
//
// Design (both kernels): a grid of (token tile of 128, vocab split) CTAs, one per SM,
// token tile fastest so that the CTAs of one vocab range run together and find the
// table in L2. A CTA is one producer warp and two consumer warpgroups of 64 token rows
// each (setmaxnreg moves the producer's registers to the consumers). One producer
// thread keeps TMA loads (128-byte swizzle) in flight into a ring of shared-memory
// stages; each stage has a "full" mbarrier that the TMA unit completes and an "empty"
// one on which the consumer warps arrive once their wgmma reads of it have finished.
// There is no block-wide barrier after the set-up. The consumers run
// wgmma.mma_async (bf16 in, fp32 accumulators in registers) and do the row-wise work
// on the accumulators in registers: a row lives in the 4 lanes of a quad, so its max
// and sum are two shuffles.
//
// Forward: tiles of 128 tokens x 256 vocab; a stage is one 64-wide slice of D (hidden
// [128 x 64] + table [256 x 64], 48 KB, 4 stages). The hidden tile no longer stays in
// shared memory, so D is bounded only by being a multiple of 64. Each thread keeps the
// running (max, sum-exp, picked) of its two rows; a second small kernel combines the
// splits into lse and nll. L2 -> SM traffic a pass: 16 token tiles x (604 MB of table
// + 302 MB of hidden slices) = 14.5 GB (the WMMA version it replaces: 19.3 GB).
//
// Backward, per vocab range of 512 rows, in two phases over one ring of 32 KB stages (3):
//   1. logits: four sub-tiles of 128 vocab rows, each a sweep over D as in the forward
//      (stage: hidden [128 x 64] + table [128 x 64]); Q = (softmax - onehot) * g goes
//      from the accumulators to shared memory as bf16, in the swizzled K-major layout
//      wgmma reads as its A operand ([128 tokens x 512 vocab], 128 KB; each warpgroup
//      writes and reads only its own 64 rows).
//   2. dh: for each 128-wide slice of D, acc[64 x 128] = Q . W over the range's 512
//      vocab rows (stage: table [128 vocab x 128 d] as two TMA boxes; the same swizzled
//      tile read as an MN-major B operand, wgmma's transposed-B form, so no transposed
//      copy of the table exists), then added into the CTA's own fp32 slab of dh in
//      device memory with red.global.add: no read latency on the path, and still
//      deterministic, since every slab element is touched by one thread in program
//      order. A second small kernel sums the splits' slabs in order.
//   dh for 128 tokens x D is 590 KB of fp32 and fits neither registers (64K a SM) nor
//   shared memory, hence the slab; building Q for 512 vocab rows before touching it
//   cuts its traffic to one pass per 512 rows: 512 ranges x 2048 x D x 4 B = 4.8 GB of
//   reductions a pass (the version it replaces: 38.7 GB of reads and writes, once per
//   128 rows). L2 -> SM traffic a pass: table 2 x 9.7 GB (once per phase), hidden slices
//   9.7 GB, slab 4.8 GB: 33.8 GB (the version it replaces: 38.6 GB of table + 38.7 GB
//   of slab).
//   What bounds the backward now is that slab: the 128 CTAs' slabs are 75 MB, more than
//   the 50 MB of L2, so each reduction misses and the 4.8 GB go to device memory and
//   back (9.7 GB, 2.9 ms at 3.35 TB/s), and that time adds to the products' instead of
//   hiding under them (with the slab updates left out the kernel takes 4.3 ms, with
//   them 7.1-7.5 ms; at D = 576 and 384, where the slabs are 38 and 25 MB, the backward
//   takes 2.9 and 2.1 times the forward's time, against 4.2 times at D = 1152). Tried
//   on the card and taken out again: a range of 640 to 1024 with the extra sub-tiles
//   of Q kept in registers as wgmma's A operand (6.4 ms at 768 and 8.2 ms at 1024, with
//   spills and wgmma serialized for lack of registers, and wrong numbers at 640 that
//   were not traced), and, none of them faster, L2 eviction hints on the slab,
//   odd splits shifted by half a range, the slab updates placed between the next
//   slice's stages, a read-modify-write with the loads started before the products, and
//   clusters of 2 or 4 CTAs that share a token tile, pass Q to each other through
//   distributed shared memory and keep 1/2 or 1/4 of dh each (right at every shape,
//   8.2-8.7 and 16.7 ms: two cluster-wide waits a range and 64-wide products cost more
//   than the smaller slabs save). A range of 1024 in shared memory needs 256 KB for Q
//   at 128 tokens, or 64-token tiles, which double the table's traffic.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

using namespace sm90;

namespace {

constexpr int BM = 128;          // tokens per CTA: two consumer warpgroups of 64 rows
constexpr int DK = 64;           // columns of D per stage of a logits sweep (128-byte rows)
constexpr int BOX = 128;         // rows of every TMA box (both tensor maps: [128 rows x 64 cols])
constexpr int BOX_BYTES = BOX * DK * 2;  // 16 KB
constexpr int FWD_BV = 256;      // forward: vocab rows per tile
constexpr int BWD_BV = 128;      // backward: vocab rows per logits sub-tile
constexpr int SUBS = 4;          // backward: logits sub-tiles per vocab range
constexpr int VW = SUBS * BWD_BV;  // backward: vocab rows per range (Q's width), 512
constexpr int DN = 128;          // backward: columns of D per dh accumulator
constexpr int THREADS = 384;     // warpgroups 0, 1: consumers; warpgroup 2: the producer warp
constexpr int FWD_STAGES = 4, FWD_STAGE_BYTES = 3 * BOX_BYTES;
constexpr int BWD_STAGE_BYTES = 2 * BOX_BYTES;
constexpr int BWD_STAGES = 3;
constexpr int Q_WG_BYTES = 64 * VW * 2;  // one warpgroup's Q: 8 blocks of [64 x 64] bf16
constexpr int EMPTY_ARRIVALS = 8;        // lane 0 of each consumer warp
constexpr size_t FWD_SMEM = FWD_STAGES * FWD_STAGE_BYTES + 1024 + 16 * FWD_STAGES;
constexpr size_t BWD_SMEM = BWD_STAGES * BWD_STAGE_BYTES + 2 * Q_WG_BYTES + 1024 + 16 * BWD_STAGES;
constexpr float NEG_BIG = -1e30f;
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

static_assert(BWD_SMEM <= 232448 && FWD_SMEM <= 232448, "shared memory of one SM");

// position in the ring: stage index and the parity of its current use
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int STAGES>
__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, EMPTY_ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// A consumer warpgroup's side of a sweep over stages: after the wgmmas of stage i are
// committed, stage i - 1's have finished (one group stays in flight), so its buffer is
// handed back to the producer; finish() drains and hands back the last.
struct Release {
  uint32_t pending = 0;  // "empty" barrier of the stage whose wgmmas are still running
  __device__ __forceinline__ void committed(uint32_t empty_bar) {
    if (pending) {
      wgmma_wait<1>();
      if (threadIdx.x % 32 == 0) mbar_arrive(pending);
    }
    pending = empty_bar;
  }
  __device__ __forceinline__ void finish() {
    wgmma_wait<0>();
    if (pending && threadIdx.x % 32 == 0) mbar_arrive(pending);
    pending = 0;
  }
};

// ------------------------------------------------------------------------ forward

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_fwd_kernel(const __grid_constant__ CUtensorMap map_h,
                    const __grid_constant__ CUtensorMap map_w, const int* __restrict__ labels,
                    float* __restrict__ part, int N, int V, int D, int n_pad,
                    int tiles_per_split, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + FWD_STAGES * FWD_STAGE_BYTES, empty = full + 8 * FWD_STAGES;
  init_ring<FWD_STAGES>(full, empty);

  const int n0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_vtiles = (V + FWD_BV - 1) / FWD_BV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_vtiles, vt_begin + tiles_per_split);
  const int n_chunks = D / DK;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    Ring r;
    for (int vt = vt_begin; vt < vt_end; ++vt) {
      const int v0 = vt * FWD_BV;
      const bool two = v0 + BOX < V;  // else the second box lies wholly past V: not loaded
      for (int c = 0; c < n_chunks; ++c) {
        const uint32_t st = ring + r.stage * FWD_STAGE_BYTES, bar = full + 8 * r.stage;
        mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
        mbar_expect_tx(bar, two ? 3 * BOX_BYTES : 2 * BOX_BYTES);
        tma_load_2d(st, &map_h, bar, c * DK, n0);
        tma_load_2d(st + BOX_BYTES, &map_w, bar, c * DK, v0);
        if (two) tma_load_2d(st + 2 * BOX_BYTES, &map_w, bar, c * DK, v0 + BOX);
        r.advance<FWD_STAGES>();
      }
    }
    return;
  }

  reg_alloc<232>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row = n0 + wg * 64 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  const int col0 = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;  // logits in units of log2: exp(x) = exp2(x * log2 e)
  int lbl[2];
  float m_run[2], l_run[2], pick[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lbl[h] = row + 8 * h < N ? labels[row + 8 * h] : -1;
    m_run[h] = NEG_BIG;
    l_run[h] = 0.f;
    pick[h] = 0.f;
  }

  Ring r;
  Release rel;
  float acc[FWD_BV / 2];
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    for (int c = 0; c < n_chunks; ++c) {
      const uint32_t st = ring + r.stage * FWD_STAGE_BYTES;
      mbar_wait(full + 8 * r.stage, r.phase);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DK / 16; ++k)
        wgmma_m64n256k16<0>(acc, smem_desc(st + wg * 8192 + 32 * k, 16, 1024),
                            smem_desc(st + BOX_BYTES + 32 * k, 16, 1024), (c | k) != 0);
      wgmma_commit();
      rel.committed(empty + 8 * r.stage);
      r.advance<FWD_STAGES>();
    }
    rel.finish();
    fence_regs(acc);

    // online logsumexp over this tile; columns past V (garbage where the second box
    // was not loaded) are replaced before any arithmetic touches them
    const int v0 = vt * FWD_BV;
    const int v_lim = V - v0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int want = lbl[h] - v0 - col0;  // the label's column, relative to this lane
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < FWD_BV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, c = 8 * j + e;  // column = col0 + c
          if (c == want) pick[h] = acc[i];
          const float x = col0 + c < v_lim ? acc[i] * sl2 : NEG_BIG;
          acc[i] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < FWD_BV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += exp2f(acc[4 * j + 2 * h + e] - m_new);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * exp2f(m_run[h] - m_new) + sum;
      m_run[h] = m_new;
    }
  }

  // this split's (max, sum-exp, picked) of each row: part [3][splits][n_pad]
  const long long plane = (long long)gridDim.y * n_pad;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float p = pick[h];  // found by at most one lane of the quad
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (lane % 4 == 0) {
      const long long i = (long long)split * n_pad + row + 8 * h;
      part[i] = m_run[h] * LN2;
      part[plane + i] = l_run[h];
      part[2 * plane + i] = p * scale;
    }
  }
}

__global__ void fused_ce_fwd_combine(const float* __restrict__ part, float* __restrict__ lse,
                                     float* __restrict__ nll, int N, int n_pad, int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long plane = (long long)splits * n_pad;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[(long long)s * n_pad + n]);
  float sum = 0.f, picked = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long i = (long long)s * n_pad + n;
    sum += part[plane + i] * expf(part[i] - m);
    picked += part[2 * plane + i];
  }
  const float out = m + logf(sum);
  lse[n] = out;
  nll[n] = out - picked;
}

// ----------------------------------------------------------------------- backward

// slab[0..1] (+)= (a, b): a plain store on the first range, a reduction afterwards
__device__ __forceinline__ void slab_update(float* p, float a, float b, bool first) {
  if (first) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(a), "f"(b) : "memory");
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_bwd_kernel(const __grid_constant__ CUtensorMap map_h,
                    const __grid_constant__ CUtensorMap map_w, const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ part, int N, int V, int D, int n_pad,
                    int ranges_per_split, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ring = smem_addr(smem);
  const uint32_t q_base = ring + BWD_STAGES * BWD_STAGE_BYTES;
  const uint32_t full = q_base + 2 * Q_WG_BYTES, empty = full + 8 * BWD_STAGES;
  init_ring<BWD_STAGES>(full, empty);

  const int n0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  // this split's vocab rows, walked in ranges of VW
  const int v_begin = split * ranges_per_split * VW;
  const int v_end = min(V, v_begin + ranges_per_split * VW);
  const int n_chunks = D / DK;           // stages of a logits sweep
  const int n_slices = (D + DN - 1) / DN;  // dh accumulators across D
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    Ring r;
    for (int v_r = v_begin; v_r < v_end; v_r += VW) {
      const int n_sub = (min(VW, v_end - v_r) + BWD_BV - 1) / BWD_BV;
      for (int sub = 0; sub < n_sub; ++sub) {
        for (int c = 0; c < n_chunks; ++c) {
          const uint32_t st = ring + r.stage * BWD_STAGE_BYTES, bar = full + 8 * r.stage;
          mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
          mbar_expect_tx(bar, 2 * BOX_BYTES);
          tma_load_2d(st, &map_h, bar, c * DK, n0);
          tma_load_2d(st + BOX_BYTES, &map_w, bar, c * DK, v_r + sub * BWD_BV);
          r.advance<BWD_STAGES>();
        }
      }
      for (int sl = 0; sl < n_slices; ++sl) {
        const bool two = sl * DN + DK < D;  // else D ends after the slice's first 64 columns
        for (int kb = 0; kb < n_sub; ++kb) {
          const uint32_t st = ring + r.stage * BWD_STAGE_BYTES, bar = full + 8 * r.stage;
          mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
          mbar_expect_tx(bar, two ? 2 * BOX_BYTES : BOX_BYTES);
          tma_load_2d(st, &map_w, bar, sl * DN, v_r + kb * BOX);
          if (two) tma_load_2d(st + BOX_BYTES, &map_w, bar, sl * DN + DK, v_r + kb * BOX);
          r.advance<BWD_STAGES>();
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int rr = 16 * warp + lane / 4;  // this thread's rows of the warpgroup: rr, rr + 8
  const int row = n0 + wg * 64 + rr;
  const int col0 = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  const uint32_t q_wg = q_base + wg * Q_WG_BYTES;
  float* slab = part + ((long long)split * n_pad + row) * D + col0;
  int lbl[2];
  float lse2[2], gr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = row + 8 * h < N;
    lbl[h] = live ? labels[row + 8 * h] : -1;
    lse2[h] = live ? lse[row + 8 * h] * LOG2E : 0.f;
    gr[h] = live ? g[row + 8 * h] : 0.f;  // rows past N contribute nothing
  }

  Ring r;
  Release rel;
  for (int v_r = v_begin; v_r < v_end; v_r += VW) {
    const int n_sub = (min(VW, v_end - v_r) + BWD_BV - 1) / BWD_BV;

    // phase 1: Q = (softmax - onehot) * g of this range, sub-tile by sub-tile
    for (int sub = 0; sub < n_sub; ++sub) {
      float s[BWD_BV / 2];
      for (int c = 0; c < n_chunks; ++c) {
        const uint32_t st = ring + r.stage * BWD_STAGE_BYTES;
        mbar_wait(full + 8 * r.stage, r.phase);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < DK / 16; ++k)
          wgmma_m64n128k16<0>(s, smem_desc(st + wg * 8192 + 32 * k, 16, 1024),
                              smem_desc(st + BOX_BYTES + 32 * k, 16, 1024), (c | k) != 0);
        wgmma_commit();
        rel.committed(empty + 8 * r.stage);
        r.advance<BWD_STAGES>();
      }
      rel.finish();
      fence_regs(s);

      const int v0 = v_r + sub * BWD_BV;
      const int v_lim = V - v0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int want = lbl[h] - v0 - col0;
        // byte offset of (row rr + 8 h, column col0) inside a [64 x 64] block: rows of
        // 128 bytes, 16-byte groups XOR-ed with row % 8 (= lane / 4 for both rows)
        const uint32_t row_off = q_wg + (rr + 8 * h) * 128 + 2 * col0;
#pragma unroll
        for (int j = 0; j < BWD_BV / 8; ++j) {
          float q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + e;  // column = col0 + c
            float p = exp2f(s[4 * j + 2 * h + e] * sl2 - lse2[h]);
            if (c == want) p -= 1.f;
            q[e] = col0 + c < v_lim ? p * gr[h] : 0.f;
          }
          const __nv_bfloat162 packed = __floats2bfloat162_rn(q[0], q[1]);
          const int block = sub * (BWD_BV / 64) + j / 8;  // 64-column block of Q
          const int group = (j % 8) ^ (lane / 4);         // swizzled 16-byte group
          const uint32_t addr = row_off + block * 8192 + group * 16;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(*reinterpret_cast<const uint32_t*>(&packed))
                       : "memory");
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync<128>(1 + wg);  // the warpgroup's Q is written before any wgmma reads it

    // phase 2: dh[:, slice] += Q . W[range, slice], slice by slice
    const bool first = v_r == v_begin;
    for (int sl = 0; sl < n_slices; ++sl) {
      float acc[DN / 2];
      for (int kb = 0; kb < n_sub; ++kb) {
        const uint32_t st = ring + r.stage * BWD_STAGE_BYTES;
        mbar_wait(full + 8 * r.stage, r.phase);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BOX / 16; ++k)
          wgmma_m64n128k16<1>(
              acc, smem_desc(q_wg + (kb * 2 + k / 4) * 8192 + 32 * (k % 4), 16, 1024),
              smem_desc(st + 2048 * k, BOX_BYTES, 1024), (kb | k) != 0);
        wgmma_commit();
        rel.committed(empty + 8 * r.stage);
        r.advance<BWD_STAGES>();
      }
      rel.finish();
      fence_regs(acc);

      const int d_lim = D - sl * DN - col0;  // columns of this slice inside D
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* out = slab + (long long)(8 * h) * D + sl * DN;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j)
          if (8 * j < d_lim)
            slab_update(out + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], first);
      }
    }
  }
}

__global__ void fused_ce_bwd_combine(const float* __restrict__ part, float* __restrict__ dh,
                                     int N, int D, int n_pad, int splits) {
  const long long total = (long long)N * D;
  const long long plane = (long long)n_pad * D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * plane + i];
    dh[i] = sum;
  }
}

// -------------------------------------------------------------------------- host

bool supported(int D) { return D > 0 && D % DK == 0; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has loaded already (the
// kernels' library is linked against the runtime only)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// tensor map of a row-major bf16 [rows, cols] matrix cut into boxes of [BOX rows x 64
// columns], written to shared memory with the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int rows, int cols) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {DK, BOX};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// hidden [N, D] bf16, table [V, D] bf16, labels [N] int32 -> lse [N], nll [N] fp32.
// part: fp32 scratch [3][splits][n_pad], n_pad = N rounded up to 128; a split is
// tiles_per_split vocab tiles of 256 rows.
extern "C" int fused_ce_fwd_bf16(const void* hidden, const void* table, const void* labels,
                                 void* part, void* lse, void* nll, int N, int V, int D,
                                 int splits, int tiles_per_split, float scale, void* stream) {
  if (!supported(D)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_h, map_w;
  if (!make_map(&map_h, hidden, N, D) || !make_map(&map_w, table, V, D))
    return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(fused_ce_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + BM - 1) / BM;
  const int n_pad = n_tiles * BM;
  fused_ce_fwd_kernel<<<dim3(n_tiles, splits), THREADS, FWD_SMEM, st>>>(
      map_h, map_w, static_cast<const int*>(labels), static_cast<float*>(part), N, V, D, n_pad,
      tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_combine<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(lse), static_cast<float*>(nll), N,
      n_pad, splits);
  return (int)cudaGetLastError();
}

// hidden, table, labels as above; lse [N], g [N] fp32 -> dh [N, D] fp32 (unscaled).
// part: fp32 scratch [splits][n_pad][D]; a split is ranges_per_split vocab ranges of
// 512 rows.
extern "C" int fused_ce_bwd_bf16(const void* hidden, const void* table, const void* labels,
                                 const void* lse, const void* g, void* part, void* dh, int N,
                                 int V, int D, int splits, int ranges_per_split, float scale,
                                 void* stream) {
  if (!supported(D)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_h, map_w;
  if (!make_map(&map_h, hidden, N, D) || !make_map(&map_w, table, V, D))
    return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(fused_ce_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + BM - 1) / BM;
  const int n_pad = n_tiles * BM;
  fused_ce_bwd_kernel<<<dim3(n_tiles, splits), THREADS, BWD_SMEM, st>>>(
      map_h, map_w, static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(part), N, V, D, n_pad, ranges_per_split,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_bwd_combine<<<264, 256, 0, st>>>(static_cast<const float*>(part),
                                            static_cast<float*>(dh), N, D, n_pad, splits);
  return (int)cudaGetLastError();
}
