// LayerNorm backward for Hopper (sm_90a): dx, dscale and dbias of rows [N, D] in one
// persistent launch, bf16 or fp32 rows, fp32 math and fp32 parameter gradients.
//
// Replaces the TPU kernel projectiontrainer_tpu/ops/fused_layernorm.py:_bwd_kernel
// (launched from _bwd). Same function: the row statistics are recomputed from x in fp32
// (eps inside the rsqrt), dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) with
// g = dy * scale, written in x's type, and dscale = sum over rows of dy * xhat,
// dbias = sum over rows of dy, in fp32. The TPU carries the two column sums across
// its sequential grid; CTAs on the card run in no order, so each CTA sums its own rows
// and a grid-wide combine adds the CTAs' partials in CTA order (deterministic: a rerun
// gives the same bits; no float atomics).
//
// What bounds it on the H100: bytes. x and dy are read once and dx written once
// (113 MB at the stage-0 tower's [16384, 1152] bf16: 0.034 ms at 3.35 TB/s) for ~20
// flops an element. Hiding the device memory's latency at that rate needs tens of KB
// in flight on every SM, and the combine of the column sums must not add a serial
// tail.
//
// Design (ops/fused_layernorm.py:bwd_plan sizes it on the host):
// - One CTA an SM, persistent, launched cooperatively (all CTAs resident). CTA c owns a
//   contiguous band of rows; band sizes differ by at most 1.
// - One producer thread copies each row of x and of dy whole into a ring of stages in
//   shared memory with 1-D bulk copies (cp.async.bulk), reported to the stage's "full"
//   mbarrier; a stage holds R rows (8 at D <= 2048 in bf16: 4 stages, 147 KB at
//   D = 1152, of which three are in flight while one is read). Rows past the band's end
//   are never copied and never read: a part-filled stage adds nothing to any sum.
//   A row's slot is DP = D rounded up to 8 elements. Rows that a bulk copy cannot take
//   (D * size not a multiple of 16 bytes, or a row that does not start on 16 bytes: D =
//   1001, 1004 in bf16) are copied by the row warps instead ("direct"): each its own rows,
//   with cp.async in the widest units (16, 8 or 4 bytes) that the row's start allows,
//   the rest element by element and the slot's pad set to 0, one or two chunks ahead of
//   the chunk it computes; the column warps learn from the "ready" barrier that a
//   stage's rows are in. (On an NVIDIA H100 80GB HBM3 at 700 W, kernels/check_layernorm.py
//   --time at [16384, 1004]: the producer warp alone issuing every copy took 0.20 ms,
//   row warps that copied and then computed 0.13.)
// - Eight row warps, a row each, no block barrier: the lanes read the row from shared
//   memory in 16-byte vectors; mean in one pass, then the centred sum of squares, sum(g)
//   and sum(g * (x - mean)) in a second (three interleaved shuffle reductions); a third
//   pass writes dx with 16-byte stores. Each warp leaves its rows' mean and rstd in
//   shared memory and arrives on the stage's "ready" mbarrier.
// - Four column warps, a stage behind: column thread t owns the 16-byte column vectors
//   t, t + 128, ... and adds dy * xhat and dy of the stage's rows, in row order, into
//   fp32 registers (64 a thread: D <= 4096). Above 4096 ("wide"), the thread adds each
//   stage's rows to the CTA's own partial row in device memory (it reads back its own
//   writes, in the same order: the same sums as in registers). Row and column warps both arrive on the
//   stage's "empty" mbarrier, which frees it for the producer. On warps of their own the
//   two passes overlap, where one set of warps would wait at a barrier between them.
// - The CTA writes its two partial rows to a [C, 2, D] fp32 scratch, all CTAs cross one
//   grid barrier (a counter whose top bit flips once a barrier, so it is never reset),
//   and CTA c then sums its slice of the 2D columns over all C partials in CTA order,
//   16 loads in flight a thread: the combine is spread over every SM instead of one CTA
//   reading all the partials. A grid of one CTA writes its sums directly.
// Every mbarrier wait and the grid barrier trap after ~2 s, so a fault is a CUDA error
// and not a hang.
//
// Rows too wide for one ring row of x and dy beside the fp32 scale (D above 19,368;
// ops/fused_layernorm.py:bwd_plan names the route):
// - "cluster", up to 32,768 columns: layernorm_bwd_cluster_kernel cuts each row over a
//   thread-block cluster of C = ceil(D / MAX_D) CTAs (5 at 20480, 8 at 32768), each with
//   the warps' roles above and its slice of the row in a ring slot, copied once from
//   device memory by one bulk copy (any alignment: the copy takes the slice's 16-byte
//   envelope and the readers start inside it); the row statistics are summed over the
//   cluster through distributed shared memory (a CTA's partial by st.async to every CTA,
//   summed in rank order by each, so every CTA holds the same bits); dx is written from
//   shared memory and the column sums stay in registers until the band ends. Grid barrier
//   and combine as above, the grid sized by cudaOccupancyMaxActiveClusters (a cluster
//   needs C SMs of one GPC, so fewer CTAs than SMs run) and a larger one refused.
// - "streamed", wider: a kernel of its own, layernorm_bwd_streamed_kernel, streams each
//   row from device memory in column chunks of STREAM_THREADS vectors, the whole CTA on
//   STREAM_ROWS rows at a time. Pass 1 takes a row's mean; pass 2 its centred sum of
//   squares, sum(g) and sum(g * (x - mean)) (three block reductions: warp shuffles, then
//   the warps' sums in warp order); pass 3 writes the rows' dx and adds their dy * xhat
//   and dy, in row order, into the CTA's partial column sums in device memory, each
//   column vector by the one thread that owns it, once for the STREAM_ROWS rows. x is read
//   three times and dy twice, mostly from L2; rows that are not 16-byte multiples or do
//   not start on 16 bytes element by element. The grid barrier and a combine in CTA order
//   follow (each column of the combine summed by one thread): deterministic, no atomics.
// Measured: PERF.md (chip_smoke.py phase 2, kernels/check_layernorm.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sm90.cuh"
#include "wgmma_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROW_WARPS = 8;              // a row each
constexpr int COL_WARPS = 4;              // the column sums
constexpr int ROW_THREADS = ROW_WARPS * 32, COL_THREADS = COL_WARPS * 32;
constexpr int PRODUCER = ROW_WARPS + COL_WARPS;  // the producer's warp
constexpr int THREADS = (PRODUCER + 1) * 32;
constexpr int MAX_STAGES = 8;
constexpr int MAX_D = 4096;               // column sums in registers: COL_THREADS x 32 each
constexpr int COMBINE_BATCH = 16;         // partials a thread loads at once in the combine
constexpr int SMEM_LIMIT = 232448;        // dynamic shared memory a block may opt into

// 16 bytes of T <-> fp32
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(uint4 u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void load(const bf16* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
  __device__ __forceinline__ static void store(bf16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ void load_f32x8(const float* p, float* f) {
  Vec<float>::load(p, f);
  Vec<float>::load(p + 4, f + 4);
}

// a row's slot in shared memory and in the partial sums: D rounded up to 8 elements
__host__ __device__ __forceinline__ int slot_width(int d) { return (d + 7) / 8 * 8; }

// shared-memory layout (dp = slot_width(D)):
// [ring | scale fp32 [dp] | stats fp32 [S][R][2] | full[S], empty[S], stats_ready[S]];
// after the ring has drained its first bytes hold the combine's sums
template <typename T>
__host__ __device__ __forceinline__ size_t ring_bytes(int dp, int rows, int stages) {
  return (size_t)stages * rows * 2 * dp * sizeof(T);
}

__host__ __device__ __forceinline__ size_t combine_bytes(int dp) {
  return (size_t)4 * (2 * dp > THREADS ? 2 * dp : THREADS);
}

template <typename T>
size_t smem_bytes(int d, int rows, int stages) {
  const int dp = slot_width(d);
  const size_t ring = ring_bytes<T>(dp, rows, stages);
  const size_t region = ring > combine_bytes(dp) ? ring : combine_bytes(dp);
  return region + (size_t)4 * dp + (size_t)8 * stages * rows + (size_t)24 * stages;
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most n (0, 1 or 2) of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a row of d elements at src into the 16-byte aligned slot dst of dp elements, by one
// warp: cp.async in units of the widest size that src's alignment allows, the tail
// element by element, then the pad [d, dp) set to 0
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int d, int dp, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint32_t sd = sm90::smem_addr(dst);
  const int bytes = d * (int)sizeof(T);
  int done = 0;  // bytes copied in units
  if (a % 16 == 0) {
    done = bytes / 16 * 16;
    for (int i = 16 * lane; i < done; i += 16 * 32)
      cp_async<16>(sd + i, reinterpret_cast<const char*>(src) + i);
  } else if (a % 8 == 0) {
    done = bytes / 8 * 8;
    for (int i = 8 * lane; i < done; i += 8 * 32)
      cp_async<8>(sd + i, reinterpret_cast<const char*>(src) + i);
  } else if (a % 4 == 0) {
    done = bytes / 4 * 4;
    for (int i = 4 * lane; i < done; i += 4 * 32)
      cp_async<4>(sd + i, reinterpret_cast<const char*>(src) + i);
  }
  for (int e = done / (int)sizeof(T) + lane; e < d; e += 32) dst[e] = src[e];
  for (int e = d + lane; e < dp; e += 32) dst[e] = T(0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the same bits in every lane: each step adds the same pair in every lane
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of the grid (all resident: a cooperative launch) arrives before any goes on.
// CTA 0 adds 2^31 - (C - 1), the others 1: the counter's top bit flips when the last one
// arrives, and the counter moves by exactly 2^31 a barrier, so it is never reset.
__device__ __forceinline__ void grid_barrier(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(counter, add);
    const long long t0 = clock64();
    while (((old ^ ld_acquire(counter)) & 0x80000000u) == 0) {
      if (clock64() - t0 > 4000000000ll) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// After the grid barrier: CTA c of `ctas` sums its slice [c0, c1) of the `width` columns
// over the `parts` partial rows of `part` ([parts][width]) in row order; `groups`
// threads share a column (partials g, g + groups, ...; COMBINE_BATCH of them loaded at
// once), then their sums are added in group order. `red` (shared memory of at least
// 4 * max(THREADS, ceil(width / ctas)) bytes) holds the group sums.
__device__ __forceinline__ void combine_columns(const float* __restrict__ part,
                                                float* __restrict__ sums, int width, int parts,
                                                int c, int ctas, float* red) {
  const int cols = (width + ctas - 1) / ctas;
  const int c0 = c * cols, c1 = min(width, c0 + cols);
  if (c0 >= c1) return;
  const int ncol = c1 - c0, groups = max(1, THREADS / ncol);
  for (int j = threadIdx.x; j < ncol * groups; j += THREADS) {
    const float* col = part + c0 + j % ncol;
    float acc = 0.f;
    for (int p0 = j / ncol; p0 < parts; p0 += COMBINE_BATCH * groups) {
      float v[COMBINE_BATCH];
#pragma unroll
      for (int k = 0; k < COMBINE_BATCH; ++k) {
        const int p = p0 + k * groups;
        v[k] = p < parts ? __ldcg(col + (size_t)p * width) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < COMBINE_BATCH; ++k) acc += v[k];
    }
    red[j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ncol; j += THREADS) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += red[g * ncol + j];
    sums[c0 + j] = acc;
  }
}

// ANY: rows of any width and alignment (slots of D rounded up to 8, direct copies,
// column sums in device memory above MAX_D); without it the kernel takes D a multiple
// of 8 up to MAX_D in bulk copies only, and those paths fold away
template <typename T, bool ANY>
__global__ void __launch_bounds__(THREADS, 1)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const void* __restrict__ scale, T* __restrict__ dx,
                     float* __restrict__ part, float* __restrict__ sums,
                     unsigned int* __restrict__ counter, int n, int d, long long x_stride,
                     long long dy_stride, int rows, int stages, int scale_f32, int direct_rows,
                     float eps) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CV = MAX_D / VEC / COL_THREADS;  // column vectors a column thread owns
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = ANY ? slot_width(d) : d;
  const int row_bytes = d * (int)sizeof(T), slot_bytes = dp * (int)sizeof(T);
  const int nv = ANY ? (d + VEC - 1) / VEC : d / VEC;  // 16-byte vectors in a row
  const int v_tail = ANY && d % VEC ? d / VEC : -1;    // a part-filled last one (direct rows)
  const bool wide = ANY && nv > CV * COL_THREADS;      // column sums in device memory
  const bool direct = ANY && direct_rows;              // the row warps' own copies
  const size_t ring = ring_bytes<T>(dp, rows, stages);
  float* s_scale = reinterpret_cast<float*>(smem + (ring > combine_bytes(dp) ? ring : combine_bytes(dp)));
  float* s_stats = s_scale + dp;  // [S][R] x (mean, rstd)
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_stats + 2 * stages * rows);
  const uint32_t full0 = sm90::smem_addr(bars), empty0 = full0 + 8 * stages,
                 ready0 = empty0 + 8 * stages;

  // this CTA's band: rows [row0, row0 + band)
  const int C = gridDim.x, c = blockIdx.x;
  const int q = n / C, extra = n % C;
  const int row0 = c * q + min(c, extra), band = q + (c < extra ? 1 : 0);
  const int chunks = (band + rows - 1) / rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, ROW_WARPS + COL_WARPS);
      sm90::mbar_init(ready0 + 8 * s, ROW_WARPS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == PRODUCER) {
    if (lane == 0 && !direct) {
      for (int i = 0; i < chunks; ++i) {
        const int s = i % stages;
        const uint32_t full = full0 + 8 * s;
        sm90::mbar_wait(empty0 + 8 * s, ((i / stages) & 1) ^ 1);
        const int r0 = row0 + i * rows, nr = min(rows, row0 + band - r0);
        sm90::mbar_expect_tx(full, 2 * nr * row_bytes);
        const uint32_t stage = sm90::smem_addr(smem) + s * rows * 2 * slot_bytes;
        for (int r = 0; r < nr; ++r) {
          sm90::bulk_load_1d(stage + r * slot_bytes, x + (r0 + r) * x_stride, row_bytes, full);
          sm90::bulk_load_1d(stage + (rows + r) * slot_bytes, dy + (r0 + r) * dy_stride,
                             row_bytes, full);
        }
      }
    }
  } else if (warp < ROW_WARPS) {
    // row warps: dx and each row's (mean, rstd); warp w takes rows w, w + ROW_WARPS, ...
    const float inv_d = 1.f / d;
    // the scale in fp32, while the first stages are in flight
    for (int i = threadIdx.x; i < dp; i += ROW_THREADS)
      s_scale[i] = ANY && i >= d ? 0.f
                   : scale_f32   ? static_cast<const float*>(scale)[i]
                                 : __bfloat162float(static_cast<const bf16*>(scale)[i]);
    // direct rows: this warp copies its own rows of chunk j into its stage `ahead`
    // chunks before it computes them (the stage's last chunk, j - stages, must have been
    // read by then: two chunks back where there are three stages or more)
    const int ahead = stages >= 3 ? stages - 2 : stages - 1;
    auto copy_chunk = [&](int j) {
      if (j < chunks) {
        const int s = j % stages;
        sm90::mbar_wait(empty0 + 8 * s, ((j / stages) & 1) ^ 1);
        const int r0 = row0 + j * rows, nr = min(rows, row0 + band - r0);
        T* sx = reinterpret_cast<T*>(smem + (size_t)s * rows * 2 * slot_bytes);
        for (int r = warp; r < nr; r += ROW_WARPS) {
          copy_row(sx + (size_t)r * dp, x + (r0 + r) * x_stride, d, dp, lane);
          copy_row(sx + (size_t)(rows + r) * dp, dy + (r0 + r) * dy_stride, d, dp, lane);
        }
      }
      cp_async_commit();  // one group a chunk, empty past the last
    };
    if (direct)
      for (int j = 0; j < ahead; ++j) copy_chunk(j);
    sm90::named_barrier_sync<ROW_THREADS>(1);

    for (int i = 0; i < chunks; ++i) {
      const int s = i % stages;
      const int r0 = row0 + i * rows, nr = min(rows, row0 + band - r0);
      const T* sx = reinterpret_cast<const T*>(smem + (size_t)s * rows * 2 * slot_bytes);
      const T* sg = sx + (size_t)rows * dp;
      float* st = s_stats + 2 * s * rows;
      if (direct) {
        copy_chunk(i + ahead);
        cp_async_wait_upto(ahead);  // this thread's copies of chunk i have landed
        __syncwarp();               // and its lanes' too
      } else {
        sm90::mbar_wait(full0 + 8 * s, (i / stages) & 1);
      }
      for (int r = warp; r < nr; r += ROW_WARPS) {
        const T* xr = sx + (size_t)r * dp;
        const T* gr = sg + (size_t)r * dp;
        float sum = 0.f;
#pragma unroll 4
        for (int v = lane; v < nv; v += 32) {
          float f[VEC];
          Vec<T>::load(xr + v * VEC, f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) sum += f[e];
        }
        const float mean = warp_sum(sum) * inv_d;
        float sq = 0.f, sgs = 0.f, sgx = 0.f;
#pragma unroll 2
        for (int v = lane; v < nv; v += 32) {
          float f[VEC], g[VEC], w[VEC];
          Vec<T>::load(xr + v * VEC, f);
          Vec<T>::load(gr + v * VEC, g);
          if constexpr (VEC == 8) load_f32x8(s_scale + v * VEC, w);
          else Vec<float>::load(s_scale + v * VEC, w);
          if (v == v_tail) {  // the slot's pad (0) adds nothing to the centred squares
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (v * VEC + e >= d) f[e] = mean;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xc = f[e] - mean, gg = g[e] * w[e];
            sq += xc * xc;
            sgs += gg;
            sgx += gg * xc;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
          sgs += __shfl_xor_sync(0xffffffffu, sgs, off);
          sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
        }
        const float rstd = rsqrtf(sq * inv_d + eps);
        const float gm = sgs * inv_d, gxm = rstd * sgx * inv_d;  // mean(g), mean(g * xhat)
        T* out = dx + (size_t)(r0 + r) * d;
#pragma unroll 2
        for (int v = lane; v < nv; v += 32) {
          float f[VEC], g[VEC], w[VEC];
          Vec<T>::load(xr + v * VEC, f);
          Vec<T>::load(gr + v * VEC, g);
          if constexpr (VEC == 8) load_f32x8(s_scale + v * VEC, w);
          else Vec<float>::load(s_scale + v * VEC, w);
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = rstd * (g[e] * w[e] - gm - (f[e] - mean) * rstd * gxm);
          if (!ANY || d % VEC == 0) {
            Vec<T>::store(out + v * VEC, f);
          } else {  // dx's rows are not 16-byte aligned: element by element
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (v * VEC + e < d) out[v * VEC + e] = T(f[e]);
          }
        }
        if (lane == 0) {
          st[2 * r] = mean;
          st[2 * r + 1] = rstd;
        }
      }
      __syncwarp();
      if (lane == 0) {
        sm90::mbar_arrive(ready0 + 8 * s);  // this warp's rows' statistics are in place
        sm90::mbar_arrive(empty0 + 8 * s);
      }
    }
  } else {
    // column warps: thread t owns the column vectors t, t + COL_THREADS, ... and adds
    // dy * xhat and dy of the band's rows, in row order, into fp32 registers, a stage
    // behind the row warps
    const int t = threadIdx.x - ROW_THREADS;
    float acc_s[CV][VEC], acc_b[CV][VEC];
#pragma unroll
    for (int j = 0; j < CV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[j][e] = acc_b[j][e] = 0.f;

    // this CTA's partial rows, [0] = dscale, [1] = dbias, [2, dp]: the sums themselves if
    // the grid is one CTA (a slot's pad, dy = 0, adds 0 to its columns)
    float* ps = C == 1 ? sums : part + (size_t)c * 2 * dp;
    for (int i = 0; i < chunks; ++i) {
      const int s = i % stages;
      const int r0 = row0 + i * rows, nr = min(rows, row0 + band - r0);
      const T* sx = reinterpret_cast<const T*>(smem + (size_t)s * rows * 2 * slot_bytes);
      const T* sg = sx + (size_t)rows * dp;
      const float* st = s_stats + 2 * s * rows;
      if (!direct) sm90::mbar_wait(full0 + 8 * s, (i / stages) & 1);  // the stage's bytes
      sm90::mbar_wait(ready0 + 8 * s, (i / stages) & 1);  // its rows' statistics (and, for
                                                          // direct rows, their copies)
      if (!wide) {
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          const int v = t + j * COL_THREADS;
          if (v < nv) {
            for (int r = 0; r < nr; ++r) {
              float f[VEC], g[VEC];
              Vec<T>::load(sx + (size_t)r * dp + v * VEC, f);
              Vec<T>::load(sg + (size_t)r * dp + v * VEC, g);
              const float mean = st[2 * r], rstd = st[2 * r + 1];
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                acc_s[j][e] += g[e] * ((f[e] - mean) * rstd);
                acc_b[j][e] += g[e];
              }
            }
          }
        }
      } else {  // the running sums of each column vector in ps, read back and written
        for (int v = t; v < nv; v += COL_THREADS) {
          float as[VEC], ab[VEC];
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 a = i ? __ldcg(reinterpret_cast<const float4*>(ps + v * VEC + e))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 b = i ? __ldcg(reinterpret_cast<const float4*>(ps + dp + v * VEC + e))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
            as[e] = a.x, as[e + 1] = a.y, as[e + 2] = a.z, as[e + 3] = a.w;
            ab[e] = b.x, ab[e + 1] = b.y, ab[e + 2] = b.z, ab[e + 3] = b.w;
          }
          for (int r = 0; r < nr; ++r) {
            float f[VEC], g[VEC];
            Vec<T>::load(sx + (size_t)r * dp + v * VEC, f);
            Vec<T>::load(sg + (size_t)r * dp + v * VEC, g);
            const float mean = st[2 * r], rstd = st[2 * r + 1];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              as[e] += g[e] * ((f[e] - mean) * rstd);
              ab[e] += g[e];
            }
          }
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            __stcg(reinterpret_cast<float4*>(ps + v * VEC + e),
                   make_float4(as[e], as[e + 1], as[e + 2], as[e + 3]));
            __stcg(reinterpret_cast<float4*>(ps + dp + v * VEC + e),
                   make_float4(ab[e], ab[e + 1], ab[e + 2], ab[e + 3]));
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
    }

    if (!wide) {
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        const int v = t + j * COL_THREADS;
        if (v < nv) {
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            *reinterpret_cast<float4*>(ps + v * VEC + e) =
                make_float4(acc_s[j][e], acc_s[j][e + 1], acc_s[j][e + 2], acc_s[j][e + 3]);
            *reinterpret_cast<float4*>(ps + dp + v * VEC + e) =
                make_float4(acc_b[j][e], acc_b[j][e + 1], acc_b[j][e + 2], acc_b[j][e + 3]);
          }
        }
      }
    }
  }
  if (C == 1) return;

  grid_barrier(counter);

  combine_columns(part, sums, 2 * dp, C, c, C, reinterpret_cast<float*>(smem));
}

// ------------------------------------------------------------------ rows on a cluster

constexpr int CLUSTER_SLOTS = 16;  // ring slots of the cluster kernel at most (a row each)

// The C slices of a row of nv 16-byte vectors: nv % C of them one vector wider; slice r
// starts at vector first(r) (ops/fused_layernorm.py:bwd_cluster_slices).
struct RowSlices {
  int nv, c;
  __host__ __device__ __forceinline__ int first(int r) const {
    return r * (nv / c) + (r < nv % c ? r : nv % c);
  }
};

// The cluster kernel's shared memory at `slots` ring slots (byte offsets; the same in
// ops/fused_layernorm.py:bwd_cluster_smem): the ring, a slot holding a CTA's slice of one
// row of x and of dy, each in its 16-byte envelope (the slice's widest vectors + 1); the
// slice's scale in fp32; each slot's (mean, rstd); each slot's two rounds of the
// statistics' exchange ([2][MAX_CLUSTER] float4); six barriers a slot. After the ring has
// drained its first bytes hold the combine's sums.
template <typename T>
struct ClusterLayout {
  uint32_t slot, scale, stats, recv, bars, bytes;
  __host__ __device__ ClusterLayout(int d, int c, int slots) {
    constexpr int VEC = Vec<T>::N;
    const int nv = (d + VEC - 1) / VEC, widest = (nv + c - 1) / c;
    slot = (widest + 1) * 16;
    scale = slots * 2 * slot;
    stats = scale + widest * VEC * 4;
    recv = (stats + slots * 8 + 15) / 16 * 16;
    bars = recv + slots * 2 * sm90::MAX_CLUSTER * 16;
    bytes = bars + slots * 6 * 8;
  }
};

// 16 bytes at byte offset `shift` (0..15, a multiple of the element's size) into the
// 16-byte chunks p[v], p[v + 1] of shared memory (p[v] taken as 0 where v < 0)
__device__ __forceinline__ uint4 load_shifted(const uint4* p, int v, int shift) {
  const uint4 a = v >= 0 ? p[v] : make_uint4(0, 0, 0, 0);
  if (shift == 0) return a;
  const uint4 b = p[v + 1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = shift / 4, bits = shift % 4 * 8;
  uint32_t o[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) o[k] = q == 0 ? w[k] : q == 1 ? w[k + 1] : q == 2 ? w[k + 2] : w[k + 3];
  return make_uint4(__funnelshift_r(o[0], o[1], bits), __funnelshift_r(o[1], o[2], bits),
                    __funnelshift_r(o[2], o[3], bits), __funnelshift_r(o[3], o[4], bits));
}

// the 16-byte aligned envelope of the n elements at p: its start, its bytes and p's offset
// in it. The bytes read past the n elements share a 16-byte chunk with one of them, so
// they lie inside the allocation of the tensor (allocations are 16-byte aligned).
struct Envelope {
  const void* start;
  uint32_t bytes;
  int shift;
};

template <typename T>
__device__ __forceinline__ Envelope envelope(const T* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p), a0 = a & ~uintptr_t(15);
  const uintptr_t a1 = (a + n * sizeof(T) + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const void*>(a0), (uint32_t)(a1 - a0), (int)(a - a0)};
}

// Rows too wide for a ring row of the kernel above (19,369 to 32,768 columns; ops/
// fused_layernorm.py:bwd_plan, route "cluster"): a row is cut over a cluster of C =
// ceil(D / MAX_D) CTAs, CTA `rank` owning the vectors of its slice (RowSlices), and
// cluster k owns a contiguous band of rows. The warps keep the roles of the kernel above,
// a row a ring slot: the producer thread copies the CTA's slice of each row of x and dy
// once, by a 1-D bulk copy of its 16-byte envelope (any alignment: the readers start
// `shift` bytes in); row warp w takes rows w, w + R, ... (R = min(8, slots)), sums its
// slice's partial statistics and exchanges them over the cluster: each CTA sends its
// partial to every CTA by st.async (counted on the receiver's barrier), and every CTA
// adds the C partials in rank order, so each holds the same bits. First the row's sum,
// then its centred squares, sum(g) and sum(g * (x - mean)), as the kernel above; then it
// writes the slice's dx from shared memory. The column warps add each row's dy * xhat and
// dy into fp32 registers, in row order, until the band ends; then the CTA's slice of its
// cluster's partial rows is written, a grid barrier, and the combine in cluster order.
// A slot's exchange buffers are written again once every CTA's row warp has read them
// (a remote arrival on the writers' barrier). Every warp of the grid is resident (the
// wrapper sizes the grid by cudaOccupancyMaxActiveClusters and refuses more).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
layernorm_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                             const void* __restrict__ scale, T* __restrict__ dx,
                             float* __restrict__ part, float* __restrict__ sums,
                             unsigned int* __restrict__ counter, int n, int d, long long x_stride,
                             long long dy_stride, int slots, int scale_f32, float eps) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CV = MAX_D / VEC / COL_THREADS;  // column vectors a column thread owns
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = (int)sm90::cluster_ctas(), rank = (int)sm90::cluster_rank();
  const ClusterLayout<T> L(d, C, slots);
  const int dp = slot_width(d), nv = (d + VEC - 1) / VEC;
  const RowSlices sl{nv, C};
  const int v0 = sl.first(rank), sv = sl.first(rank + 1) - v0;  // this CTA's vectors
  const int e0 = v0 * VEC, ne = min(d, (v0 + sv) * VEC) - e0;   // and elements
  const int v_tail = ne % VEC ? sv - 1 : -1;                     // a part-filled last vector
  // this cluster's band: rows [row0, row0 + band)
  const int K = gridDim.x / C, k = blockIdx.x / C;
  const int q = n / K, extra = n % K;
  const int row0 = k * q + min(k, extra), band = q + (k < extra ? 1 : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_warps = min(ROW_WARPS, slots);
  const uint32_t base = sm90::smem_addr(smem);
  float* s_scale = reinterpret_cast<float*>(smem + L.scale);
  float* s_stats = reinterpret_cast<float*>(smem + L.stats);  // [slots] x (mean, rstd)
  // a slot's barriers: the bytes landed; freed; its statistics in place; the two rounds of
  // partials landed; the rounds' buffers read by every CTA
  const uint32_t full0 = base + L.bars, empty0 = full0 + 8 * slots, ready0 = empty0 + 8 * slots;
  const uint32_t landed0 = ready0 + 8 * slots, read0 = landed0 + 16 * slots;
  const auto x_row = [&](int j) { return x + (row0 + j) * x_stride + e0; };
  const auto dy_row = [&](int j) { return dy + (row0 + j) * dy_stride + e0; };
  const auto slot_x = [&](int s) { return reinterpret_cast<const uint4*>(smem + s * 2 * L.slot); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 1 + COL_WARPS);
      sm90::mbar_init(ready0 + 8 * s, 1);
      sm90::mbar_init(landed0 + 16 * s, 1);
      sm90::mbar_init(landed0 + 16 * s + 8, 1);
      sm90::mbar_init(read0 + 8 * s, C);
    }
    sm90::mbar_init_fence();
  }
  sm90::cluster_sync();  // every CTA's barriers before any remote use

  // the slice's vector v of a slot's x or dy (xs: the slot's chunks, shift: the row's
  // offset into them), as floats
  const auto load = [&](const uint4* xs, int shift, int v, float* f) {
    Vec<T>::unpack(load_shifted(xs, v, shift), f);
  };

  if (warp == PRODUCER) {
    for (int j = 0; lane == 0 && j < band; ++j) {
      const int s = j % slots;
      const uint32_t full = full0 + 8 * s, dst = base + s * 2 * L.slot;
      sm90::mbar_wait(empty0 + 8 * s, ((j / slots) & 1) ^ 1);
      const Envelope ex = envelope(x_row(j), ne), eg = envelope(dy_row(j), ne);
      sm90::mbar_expect_tx(full, ex.bytes + eg.bytes);
      sm90::bulk_load_1d(dst, ex.start, ex.bytes, full);
      sm90::bulk_load_1d(dst + L.slot, eg.start, eg.bytes, full);
    }
  } else if (warp < ROW_WARPS) {
    const float inv_d = 1.f / d;
    for (int i = threadIdx.x; i < sv * VEC; i += ROW_THREADS)
      s_scale[i] = i >= ne      ? 0.f
                   : scale_f32 ? static_cast<const float*>(scale)[e0 + i]
                               : __bfloat162float(static_cast<const bf16*>(scale)[e0 + i]);
    sm90::named_barrier_sync<ROW_THREADS>(1);
    for (int j = warp; warp < row_warps && j < band; j += row_warps) {
      const int s = j % slots;
      const uint32_t par = (j / slots) & 1, landed = landed0 + 16 * s, read = read0 + 8 * s;
      const uint32_t recv = base + L.recv + s * 2 * sm90::MAX_CLUSTER * 16;
      const uint4* xs = slot_x(s);
      const uint4* gs = reinterpret_cast<const uint4*>(smem + s * 2 * L.slot + L.slot);
      const int shx = envelope(x_row(j), ne).shift, shg = envelope(dy_row(j), ne).shift;
      sm90::mbar_wait(full0 + 8 * s, par);
      if (lane == 0) {  // this row's two rounds, C partials of 16 bytes each
        sm90::mbar_expect_tx(landed, C * 16);
        sm90::mbar_expect_tx(landed + 8, C * 16);
      }
      // round 1: the row's sum over the cluster
      float sum = 0.f;
#pragma unroll 2
      for (int v = lane; v < sv; v += 32) {
        float f[VEC];
        load(xs, shx, v, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (v != v_tail || v * VEC + e < ne) sum += f[e];
      }
      sum = warp_sum(sum);
      sm90::mbar_wait(read, par ^ 1);  // every CTA has read this slot's last rounds
      if (lane < C)
        sm90::st_async(sm90::map_cta(recv + 16 * rank, lane), make_float4(sum, 0.f, 0.f, 0.f),
                       sm90::map_cta(landed, lane));
      sm90::mbar_wait(landed, par);
      float total = 0.f;
      for (int c = 0; c < C; ++c) total += sm90::ld_shared(recv + 16 * c).x;
      const float mean = total * inv_d;
      // round 2: the centred squares, sum(g), sum(g * (x - mean))
      float sq = 0.f, sgs = 0.f, sgx = 0.f;
#pragma unroll 2
      for (int v = lane; v < sv; v += 32) {
        float f[VEC], g[VEC], w[VEC];
        load(xs, shx, v, f);
        load(gs, shg, v, g);
        if constexpr (VEC == 8) load_f32x8(s_scale + v * VEC, w);
        else Vec<float>::load(s_scale + v * VEC, w);
        if (v == v_tail) {  // past the row: adds nothing
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (v * VEC + e >= ne) f[e] = mean, g[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xc = f[e] - mean, gg = g[e] * w[e];
          sq += xc * xc;
          sgs += gg;
          sgx += gg * xc;
        }
      }
      sq = warp_sum(sq);
      sgs = warp_sum(sgs);
      sgx = warp_sum(sgx);
      if (lane < C)
        sm90::st_async(sm90::map_cta(recv + 16 * (sm90::MAX_CLUSTER + rank), lane),
                       make_float4(sq, sgs, sgx, 0.f), sm90::map_cta(landed + 8, lane));
      sm90::mbar_wait(landed + 8, par);
      float4 st = sm90::ld_shared(recv + 16 * sm90::MAX_CLUSTER);
      for (int c = 1; c < C; ++c) st = sm90::add4(st, sm90::ld_shared(recv + 16 * (sm90::MAX_CLUSTER + c)));
      __syncwarp();  // the warp's reads of both rounds, then one arrival a CTA
      if (lane < C) sm90::arrive_remote(sm90::map_cta(read, lane));
      const float rstd = rsqrtf(st.x * inv_d + eps);
      const float gm = st.y * inv_d, gxm = rstd * st.z * inv_d;  // mean(g), mean(g * xhat)
      // dx of the slice, in 16-byte stores: where dx's rows are not 16-byte aligned, each
      // lane takes an aligned 16 bytes of dx (x and dy read at its offset in the slots),
      // element by element where it reaches past the slice (all element by element: 0.152
      // ms at [1000,24577], against 0.131; kernels/check_layernorm.py --wide --time)
      T* out = dx + (size_t)(row0 + j) * d + e0;
      if (d % VEC == 0) {
#pragma unroll 2
        for (int v = lane; v < sv; v += 32) {
          float f[VEC], g[VEC], w[VEC];
          load(xs, shx, v, f);
          load(gs, shg, v, g);
          if constexpr (VEC == 8) load_f32x8(s_scale + v * VEC, w);
          else Vec<float>::load(s_scale + v * VEC, w);
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = rstd * (g[e] * w[e] - gm - (f[e] - mean) * rstd * gxm);
          Vec<T>::store(out + v * VEC, f);
        }
      } else {
        const int so = (int)(reinterpret_cast<uintptr_t>(out) % 16 / sizeof(T));
        for (int c = lane; c * VEC < so + ne; c += 32) {
          const int first = c * VEC - so;  // the slice's element at the chunk's start
          const int bx = shx + first * (int)sizeof(T), bg = shg + first * (int)sizeof(T);
          float f[VEC], g[VEC];
          Vec<T>::unpack(load_shifted(xs, (bx + 16) / 16 - 1, (bx + 16) % 16), f);
          Vec<T>::unpack(load_shifted(gs, (bg + 16) / 16 - 1, (bg + 16) % 16), g);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const bool in = first + e >= 0 && first + e < ne;
            f[e] = in ? rstd * (g[e] * s_scale[first + e] - gm - (f[e] - mean) * rstd * gxm) : 0.f;
          }
          if (first >= 0 && first + VEC <= ne) {
            Vec<T>::store(out + first, f);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (first + e >= 0 && first + e < ne) out[first + e] = T(f[e]);
          }
        }
      }
      if (lane == 0) {
        s_stats[2 * s] = mean;
        s_stats[2 * s + 1] = rstd;
      }
      __syncwarp();
      if (lane == 0) {
        sm90::mbar_arrive(ready0 + 8 * s);  // the row's statistics are in place
        sm90::mbar_arrive(empty0 + 8 * s);
      }
    }
  } else {
    // column warps: thread t owns the slice's vectors t, t + COL_THREADS, ... and adds
    // dy * xhat and dy of the band's rows, in row order, into fp32 registers
    const int t = threadIdx.x - ROW_THREADS;
    float acc_s[CV][VEC], acc_b[CV][VEC];
#pragma unroll
    for (int i = 0; i < CV; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[i][e] = acc_b[i][e] = 0.f;
    for (int j = 0; j < band; ++j) {
      const int s = j % slots;
      const uint32_t par = (j / slots) & 1;
      const uint4* xs = slot_x(s);
      const uint4* gs = reinterpret_cast<const uint4*>(smem + s * 2 * L.slot + L.slot);
      const int shx = envelope(x_row(j), ne).shift, shg = envelope(dy_row(j), ne).shift;
      sm90::mbar_wait(full0 + 8 * s, par);   // the slot's bytes
      sm90::mbar_wait(ready0 + 8 * s, par);  // its row's statistics
      const float mean = s_stats[2 * s], rstd = s_stats[2 * s + 1];
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int v = t + i * COL_THREADS;
        if (v < sv) {
          float f[VEC], g[VEC];
          load(xs, shx, v, f);
          load(gs, shg, v, g);
          if (v == v_tail) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (v * VEC + e >= ne) f[e] = mean, g[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc_s[i][e] += g[e] * ((f[e] - mean) * rstd);
            acc_b[i][e] += g[e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
    }
    // this CTA's slice of its cluster's partial rows ([0] dscale, [1] dbias; the sums
    // themselves for one cluster); columns past the last vector up to the slot width 0
    float* ps = K == 1 ? sums : part + (size_t)k * 2 * dp;
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const int v = t + i * COL_THREADS;
      if (v < sv) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          *reinterpret_cast<float4*>(ps + e0 + v * VEC + e) =
              make_float4(acc_s[i][e], acc_s[i][e + 1], acc_s[i][e + 2], acc_s[i][e + 3]);
          *reinterpret_cast<float4*>(ps + dp + e0 + v * VEC + e) =
              make_float4(acc_b[i][e], acc_b[i][e + 1], acc_b[i][e + 2], acc_b[i][e + 3]);
        }
      }
    }
    if (rank == C - 1)
      for (int col = nv * VEC + t; col < dp; col += COL_THREADS) ps[col] = ps[dp + col] = 0.f;
  }
  sm90::cluster_sync();  // every exchange done: no CTA leaves while another may signal it
  if (K == 1) return;

  grid_barrier(counter);
  combine_columns(part, sums, 2 * dp, K, blockIdx.x, gridDim.x, reinterpret_cast<float*>(smem));
}

// ------------------------------------------------------------------ streamed rows

constexpr int STREAM_THREADS = 512;
constexpr int STREAM_WARPS = STREAM_THREADS / 32;
constexpr int STREAM_ROWS = 8;  // rows whose column sums are added to the partials at once

// the sums of v[0..N) over the CTA, in every thread: warp shuffles, then the warps' sums
// in warp order (the same bits at every launch)
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  __syncthreads();  // the previous reduction's reads of red
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * STREAM_WARPS + warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
    for (int w = 0; w < STREAM_WARPS; ++w) acc += red[i * STREAM_WARPS + w];
    v[i] = acc;
  }
}

__device__ __forceinline__ float load_scale(const void* scale, int i, int scale_f32) {
  return scale_f32 ? static_cast<const float*>(scale)[i]
                   : __bfloat162float(static_cast<const bf16*>(scale)[i]);
}

// VEC: elements a thread reads at once (16 bytes; 1 for rows a vector load cannot take)
template <typename T, int VEC>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
layernorm_bwd_streamed_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const void* __restrict__ scale, T* __restrict__ dx,
                              float* __restrict__ part, float* __restrict__ sums,
                              unsigned int* __restrict__ counter, int n, int d,
                              long long x_stride, long long dy_stride, int scale_f32, float eps) {
  __shared__ float red[3 * STREAM_WARPS];
  __shared__ float4 row_stats[STREAM_ROWS];  // mean, rstd, mean(g), mean(g * xhat)
  const int dp = slot_width(d);
  const int C = gridDim.x, c = blockIdx.x;
  const int q = n / C, extra = n % C;
  const int row0 = c * q + min(c, extra), band = q + (c < extra ? 1 : 0);
  const float inv_d = 1.f / d;
  const int nv = d / VEC;  // VEC divides d (the host sends the rest to VEC = 1)
  // this CTA's partial rows (the sums themselves for a grid of one CTA); the slot's pad
  // columns 0
  float* ps = C == 1 ? sums : part + (size_t)c * 2 * dp;
  for (int i = d + threadIdx.x; i < dp; i += STREAM_THREADS) ps[i] = ps[dp + i] = 0.f;

  auto load = [&](const T* p, int v, float* f) {
    if constexpr (VEC == 1) f[0] = static_cast<float>(p[v]);
    else Vec<T>::load(p + v * VEC, f);
  };
  for (int i0 = 0; i0 < band; i0 += STREAM_ROWS) {
    const int nr = min(STREAM_ROWS, band - i0);
    // passes 1 and 2, row by row: the rows' statistics
    for (int r = 0; r < nr; ++r) {
      const T* xr = x + (row0 + i0 + r) * x_stride;
      const T* gr = dy + (row0 + i0 + r) * dy_stride;
      float m[1] = {0.f};
      for (int v = threadIdx.x; v < nv; v += STREAM_THREADS) {
        float f[VEC];
        load(xr, v, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) m[0] += f[e];
      }
      block_sums(m, red);
      const float mean = m[0] * inv_d;
      float st[3] = {0.f, 0.f, 0.f};  // centred squares, sum(g), sum(g * (x - mean))
      for (int v = threadIdx.x; v < nv; v += STREAM_THREADS) {
        float f[VEC], g[VEC];
        load(xr, v, f);
        load(gr, v, g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xc = f[e] - mean, gg = g[e] * load_scale(scale, v * VEC + e, scale_f32);
          st[0] += xc * xc;
          st[1] += gg;
          st[2] += gg * xc;
        }
      }
      block_sums(st, red);
      const float rstd = rsqrtf(st[0] * inv_d + eps);
      // mean(g), mean(g * xhat)
      if (threadIdx.x == 0) row_stats[r] = make_float4(mean, rstd, st[1] * inv_d,
                                                       rstd * st[2] * inv_d);
    }
    __syncthreads();
    // pass 3: dx of the rows, and their column sums added to the partials once
    for (int v = threadIdx.x; v < nv; v += STREAM_THREADS) {
      float as[VEC], ab[VEC], w[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        as[e] = ab[e] = 0.f;
        w[e] = load_scale(scale, v * VEC + e, scale_f32);
      }
      for (int r = 0; r < nr; ++r) {
        const float4 st = row_stats[r];
        float f[VEC], g[VEC], o[VEC];
        load(x + (row0 + i0 + r) * x_stride, v, f);
        load(dy + (row0 + i0 + r) * dy_stride, v, g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xhat = (f[e] - st.x) * st.y;
          o[e] = st.y * (g[e] * w[e] - st.z - xhat * st.w);
          as[e] += g[e] * xhat;
          ab[e] += g[e];
        }
        T* out = dx + (size_t)(row0 + i0 + r) * d;
        if constexpr (VEC == 1) out[v] = T(o[0]);
        else Vec<T>::store(out + v * VEC, o);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = v * VEC + e;
        const float a = i0 ? __ldcg(ps + col) : 0.f, b = i0 ? __ldcg(ps + dp + col) : 0.f;
        __stcg(ps + col, a + as[e]);
        __stcg(ps + dp + col, b + ab[e]);
      }
    }
  }
  if (C == 1) return;

  grid_barrier(counter);

  // combine: CTA c sums columns [c0, c1) of the 2 dp over all C partials in CTA order,
  // one thread a column, COMBINE_BATCH loads in flight
  const int width = 2 * dp, cols = (width + C - 1) / C;
  const int c0 = c * cols, c1 = min(width, c0 + cols);
  for (int j = c0 + threadIdx.x; j < c1; j += STREAM_THREADS) {
    float acc = 0.f;
    for (int p0 = 0; p0 < C; p0 += COMBINE_BATCH) {
      float v[COMBINE_BATCH];
#pragma unroll
      for (int k = 0; k < COMBINE_BATCH; ++k)
        v[k] = p0 + k < C ? __ldcg(part + (size_t)(p0 + k) * width + j) : 0.f;
#pragma unroll
      for (int k = 0; k < COMBINE_BATCH; ++k) acc += v[k];
    }
    sums[j] = acc;
  }
}

template <typename T>
cudaError_t launch_streamed(const void* x, const void* dy, const void* scale, void* dx,
                            void* part, void* sums, void* counter, int n, int d,
                            long long x_stride, long long dy_stride, int ctas, int scale_f32,
                            int direct, float eps, cudaStream_t stream) {
  if (d < 1 || ctas < 1 || ctas > n) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* partp = static_cast<float*>(part);
  float* sumsp = static_cast<float*>(sums);
  unsigned int* counterp = static_cast<unsigned int*>(counter);
  void* args[] = {(void*)&xp,       (void*)&dyp,      (void*)&scale,     (void*)&dxp,
                  (void*)&partp,    (void*)&sumsp,    (void*)&counterp,  (void*)&n,
                  (void*)&d,        (void*)&x_stride, (void*)&dy_stride, (void*)&scale_f32,
                  (void*)&eps};
  // 16-byte loads where every row starts on 16 bytes and holds whole vectors
  const void* kernel = direct || d % Vec<T>::N
                           ? (const void*)layernorm_bwd_streamed_kernel<T, 1>
                           : (const void*)layernorm_bwd_streamed_kernel<T, Vec<T>::N>;
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(STREAM_THREADS), args,
                                                0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cluster_rows(const void* x, const void* dy, const void* scale, void* dx,
                                void* part, void* sums, void* counter, int n, int d,
                                long long x_stride, long long dy_stride, int cluster,
                                int clusters, int slots, int scale_f32, float eps,
                                cudaStream_t stream) {
  const ClusterLayout<T> L(d, cluster, slots);
  const int dp = slot_width(d), ctas = clusters * cluster;
  const size_t red = (size_t)4 * max(THREADS, (2 * dp + ctas - 1) / ctas);  // the combine's
  if (d <= 0 || cluster != (d + MAX_D - 1) / MAX_D || cluster < 2 ||
      cluster > sm90::MAX_CLUSTER || slots < 1 || slots > CLUSTER_SLOTS || clusters < 1 ||
      clusters > n || L.bytes > (uint32_t)SMEM_LIMIT || (clusters > 1 && L.scale < red))
    return cudaErrorInvalidValue;  // not a plan of ops/fused_layernorm.py:bwd_plan
  const auto kernel = layernorm_bwd_cluster_kernel<T>;
  // the grid barrier needs every CTA resident: more clusters than fit are refused
  if (clusters > sm90::max_active_clusters(kernel, THREADS, cluster, L.bytes))
    return cudaErrorCooperativeLaunchTooLarge;
  return sm90::launch_cluster(kernel, dim3(ctas), THREADS, cluster, L.bytes, stream,
                              static_cast<const T*>(x), static_cast<const T*>(dy), scale,
                              static_cast<T*>(dx), static_cast<float*>(part),
                              static_cast<float*>(sums), static_cast<unsigned int*>(counter), n,
                              d, x_stride, dy_stride, slots, scale_f32, eps);
}

template <typename T, bool ANY>
cudaError_t launch(const void* x, const void* dy, const void* scale, void* dx, void* part,
                   void* sums, void* counter, int n, int d, long long x_stride,
                   long long dy_stride, int rows, int stages, int ctas, int scale_f32, int direct,
                   float eps, cudaStream_t stream) {
  if (d < 1 || rows < 1 || stages < 1 || stages > MAX_STAGES || ctas < 1 || ctas > n ||
      (!ANY && (d % 8 || d > MAX_D || direct)))
    return cudaErrorInvalidValue;  // not a plan of ops/fused_layernorm.py:bwd_plan
  // a bulk copy takes 16-byte aligned rows of a multiple of 16 bytes only
  const long long sz = sizeof(T);
  if (!direct && ((d * sz) % 16 || (x_stride * sz) % 16 || (dy_stride * sz) % 16 ||
                  reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(dy) % 16))
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T>(d, rows, stages);
  if (bytes > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(layernorm_bwd_kernel<T, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* partp = static_cast<float*>(part);
  float* sumsp = static_cast<float*>(sums);
  unsigned int* counterp = static_cast<unsigned int*>(counter);
  void* args[] = {(void*)&xp,       (void*)&dyp,  (void*)&scale,     (void*)&dxp,
                  (void*)&partp,    (void*)&sumsp, (void*)&counterp, (void*)&n,
                  (void*)&d,        (void*)&x_stride, (void*)&dy_stride, (void*)&rows,
                  (void*)&stages,   (void*)&scale_f32, (void*)&direct, (void*)&eps};
  err = cudaLaunchCooperativeKernel((const void*)layernorm_bwd_kernel<T, ANY>, dim3(ctas),
                                    dim3(THREADS), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, dy: [n, d] rows with the given row strides (elements), copied in bulk unless
// `direct` (then any alignment of the element type); scale [d] (fp32 if scale_f32, else
// bf16); dx [n, d] contiguous in x's type; part: fp32 scratch of ctas * 2 * dp (dp = d
// rounded up to 8); sums: fp32 [2, dp] (dscale, dbias; the pad columns 0); counter: one
// uint32, 0 before the first launch on a stream and left for the next; rows .. ctas: the
// plan of ops/fused_layernorm.py:bwd_plan (stages 0: the streamed kernel)
extern "C" int layernorm_bwd_bf16(const void* x, const void* dy, const void* scale, void* dx,
                                  void* part, void* sums, void* counter, int n, int d,
                                  long long x_stride, long long dy_stride, int rows, int stages,
                                  int ctas, int scale_f32, int direct, float eps,
                                  void* stream) {
  if (stages == 0)
    return (int)launch_streamed<bf16>(x, dy, scale, dx, part, sums, counter, n, d, x_stride,
                                      dy_stride, ctas, scale_f32, direct, eps,
                                      static_cast<cudaStream_t>(stream));
  const bool any = direct || d % 8 || d > MAX_D;
  return (int)(any ? launch<bf16, true> : launch<bf16, false>)(
      x, dy, scale, dx, part, sums, counter, n, d, x_stride, dy_stride, rows, stages, ctas,
      scale_f32, direct, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int layernorm_bwd_f32(const void* x, const void* dy, const void* scale, void* dx,
                                 void* part, void* sums, void* counter, int n, int d,
                                 long long x_stride, long long dy_stride, int rows, int stages,
                                 int ctas, int scale_f32, int direct, float eps,
                                 void* stream) {
  if (stages == 0)
    return (int)launch_streamed<float>(x, dy, scale, dx, part, sums, counter, n, d, x_stride,
                                       dy_stride, ctas, scale_f32, direct, eps,
                                       static_cast<cudaStream_t>(stream));
  const bool any = direct || d % 8 || d > MAX_D;
  return (int)(any ? launch<float, true> : launch<float, false>)(
      x, dy, scale, dx, part, sums, counter, n, d, x_stride, dy_stride, rows, stages, ctas,
      scale_f32, direct, eps, static_cast<cudaStream_t>(stream));
}

// Rows cut over a cluster (ops/fused_layernorm.py:bwd_plan, route "cluster"): x, dy [n, d]
// with the given row strides (elements), any alignment of the element type; scale [d]
// (fp32 if scale_f32, else bf16); dx [n, d] contiguous in x's type; part: fp32 scratch of
// clusters * 2 * dp (dp = d rounded up to 8); sums: fp32 [2, dp]; counter as above;
// cluster, clusters, slots: the plan's. Refused (cudaErrorCooperativeLaunchTooLarge)
// where more clusters are asked than can be resident at once.
extern "C" int layernorm_bwd_cluster_bf16(const void* x, const void* dy, const void* scale,
                                          void* dx, void* part, void* sums, void* counter, int n,
                                          int d, long long x_stride, long long dy_stride,
                                          int cluster, int clusters, int slots, int scale_f32,
                                          float eps, void* stream) {
  return (int)launch_cluster_rows<bf16>(x, dy, scale, dx, part, sums, counter, n, d, x_stride,
                                        dy_stride, cluster, clusters, slots, scale_f32, eps,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int layernorm_bwd_cluster_f32(const void* x, const void* dy, const void* scale,
                                         void* dx, void* part, void* sums, void* counter, int n,
                                         int d, long long x_stride, long long dy_stride,
                                         int cluster, int clusters, int slots, int scale_f32,
                                         float eps, void* stream) {
  return (int)launch_cluster_rows<float>(x, dy, scale, dx, part, sums, counter, n, d, x_stride,
                                         dy_stride, cluster, clusters, slots, scale_f32, eps,
                                         static_cast<cudaStream_t>(stream));
}

// how many clusters of the cluster kernel at this width (itemsize 2: bf16, 4: fp32),
// cluster size and ring slots can be resident at once on the current device; 0 where the
// layout does not fit
extern "C" int layernorm_bwd_cluster_fit(int itemsize, int d, int cluster, int slots) {
  if (cluster < 1 || cluster > sm90::MAX_CLUSTER || slots < 1) return 0;
  if (itemsize == 2) {
    const ClusterLayout<bf16> L(d, cluster, slots);
    return L.bytes > (uint32_t)SMEM_LIMIT ? 0
               : sm90::max_active_clusters(layernorm_bwd_cluster_kernel<bf16>, THREADS, cluster, L.bytes);
  }
  const ClusterLayout<float> L(d, cluster, slots);
  return L.bytes > (uint32_t)SMEM_LIMIT ? 0
             : sm90::max_active_clusters(layernorm_bwd_cluster_kernel<float>, THREADS, cluster, L.bytes);
}
