// Fused linear + cross-entropy for Hopper (sm_90a): per-token NLL and its gradient
// with respect to the hidden states, the [tokens, vocab] logits never stored.
//
// Replaces the TPU kernels projectiontrainer_tpu/ops/fused_ce.py:_fwd_kernel (launched
// from _fwd_call) and :_bwd_kernel (launched from _bwd_call). Same contract:
//   forward   lse[t] = logsumexp_v(h[t] . W[v] * scale) (online over vocab tiles),
//             picked[t] = h[t] . W[label[t]] * scale, nll = lse - picked;
//   backward  dh[t] = sum_v (softmax[t, v] - onehot[t, v]) * g[t] * W[v], fp32, the
//             (softmax - onehot) * g factor rounded to the input type before its
//             product, as the TPU kernel does; `* scale` and the downcast stay outside.
// The padded vocab tail is masked (logit NEG_INF, probability 0) and its table rows are
// zero-filled on load, so no garbage reaches an accumulator (the TPU kernel masks them
// because 0 * NaN would poison its sum). Ignored labels arrive as a dummy 0 and are
// masked by the caller.
//
// What bounds it on the H100: 2 * N * D * V flops per pass (1.24 TFLOP forward at
// N = 2048, D = 1152, V = 262,144; the backward does it twice), against one sweep of
// the 604 MB bf16 table per 64-token tile: compute-bound when the token tiles that
// sweep the same vocab range hit the table in L2 together.
//
// Design:
// - One CTA of 8 warps per (64-token tile, vocab split). The 64 x D bf16 hidden tile
//   stays in shared memory for the whole sweep (148 KB at D = 1152, rows padded by 8
//   elements against bank conflicts); the table streams through a two-buffer ring of
//   [128 vocab, 64 d] chunks filled by cp.async, so the copy of the next chunk runs
//   under the tensor-core work on the current one (one barrier per chunk). Each
//   64 x 128 logit tile is accumulated in WMMA fragments over the D chunks, then
//   spilled once to shared memory for the row-wise work.
// - Occupancy: 2048 tokens are 32 token tiles for 132 SMs, so the vocab is split
//   across CTAs (the wrapper picks the split count from the SM count). Split CTAs of
//   one vocab range are launched next to each other (token tile is the fastest grid
//   dimension), so they read the same table chunks at nearly the same time.
// - Forward: each CTA keeps a running (max, sum-exp, picked) per row in registers and
//   writes it per split; a second small kernel combines the splits into lse and nll.
// - Backward: dh is 64 x D fp32 per token tile (295 KB at D = 1152), which fits
//   neither shared memory nor the registers of one CTA. Each CTA therefore keeps its
//   (split, token tile) slab of dh in device memory, L2-resident (37.7 MB at the
//   slice's shape with 4 splits), and after each vocab tile's logits sweeps the same
//   table chunks a second time, adding (P - onehot) * g @ W into the slab chunk by
//   chunk in fragments (one warp owns each 16 x 16 tile, so no atomics; the
//   fragments' loads start before the barrier that waits for the chunk). A
//   second small kernel sums the splits. The choice trades dh traffic through L2 for
//   no logit recomputation (the other option, splitting D across CTAs, recomputes
//   every logit once per D part).
//
// Left for later PRs: TMA and wgmma, a deeper ring, and hidden sizes above 1216 (the
// resident hidden tile bounds D by shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 64;           // tokens per CTA
constexpr int BV = 128;          // vocab rows per tile
constexpr int DK = 64;           // hidden columns per table chunk
constexpr int LDW = DK + 8;      // padded row of a table chunk
constexpr int LDQ = BV + 8;      // padded row of the bf16 (P - onehot) * g tile
constexpr int ROWS_PER_WARP = BN / WARPS;  // 8
constexpr float NEG_INF = -2.3819763e38f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

size_t smem_bytes(int D) {
  return (size_t)BN * (D + 8) * 2    // sH bf16 [BN][D + 8]
         + (size_t)2 * BV * LDW * 2  // table ring bf16 2 x [BV][LDW]
         + (size_t)BN * BV * 4       // sS fp32 [BN][BV]; the backward's sQ aliases it
         + (size_t)BN * 4 * 3;       // labels, lse, g
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// rows [n0, n0 + BN) of the [N, D] hidden states into sH (row stride D + 8), zero past N
__device__ __forceinline__ void load_hidden(bf16* sH, const bf16* h, int n0, int N, int D) {
  const int per_row = D / 8;
  for (int i = threadIdx.x; i < BN * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + r < N) val = *reinterpret_cast<const uint4*>(h + (long long)(n0 + r) * D + c);
    *reinterpret_cast<uint4*>(sH + r * (D + 8) + c) = val;
  }
}

// start copying table rows [v0, v0 + BV), columns [c0, c0 + DK) into buf [BV][LDW];
// rows past V are zero-filled
__device__ __forceinline__ void start_table_chunk(bf16* buf, const bf16* w, int v0, int c0,
                                                  int V, int D) {
  constexpr int PER_ROW = DK / 8;
  for (int i = threadIdx.x; i < BV * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool live = v0 + r < V;
    cp_async16(buf + r * LDW + c, live ? w + (long long)(v0 + r) * D + c0 + c : w, live);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc[j] += sH[row : row + 16, c0 : c0 + DK] @ buf[col + 16 j : col + 16 j + 16, :]^T
__device__ __forceinline__ void logits_chunk(Acc* acc, const bf16* sH, int ldh, const bf16* buf,
                                             int c0, int row, int col) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sH + row * ldh + c0 + kk * 16, ldh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a chunk stored [BV][LDW] row-major is W^T [DK][BV] column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(bt, buf + (col + 16 * j) * LDW + kk * 16, LDW);
      wmma::mma_sync(acc[j], a, bt, acc[j]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fused_ce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ part, int N, int V,
                    int D, int n_pad, int tiles_per_split, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = D + 8;
  bf16* sH = reinterpret_cast<bf16*>(smem);
  bf16* ring = sH + BN * ldh;
  float* sS = reinterpret_cast<float*>(ring + 2 * BV * LDW);
  int* sLbl = reinterpret_cast<int*>(sS + BN * BV);

  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_vtiles = (V + BV - 1) / BV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_vtiles, vt_begin + tiles_per_split);
  const int n_chunks = D / DK;
  const int total = (vt_end - vt_begin) * n_chunks;
  const int row = 16 * (warp % 4), col = 64 * (warp / 4);  // this warp's logit tiles

  start_table_chunk(ring, w, vt_begin * BV, 0, V, D);
  load_hidden(sH, h, n0, N, D);
  for (int i = threadIdx.x; i < BN; i += THREADS) sLbl[i] = n0 + i < N ? labels[n0 + i] : -1;

  // running max / sum-exp per row (every lane holds the row's value) and this lane's
  // share of the picked logit
  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP], pick[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
    pick[r] = 0.f;
  }

  Acc acc[4];
  for (int it = 0; it < total; ++it) {
    const int c = it % n_chunks;
    const int v0 = (vt_begin + it / n_chunks) * BV;
    cp_async_wait_all();
    __syncthreads();  // chunk `it` visible; every warp is done with chunk it - 1
    if (it + 1 < total)
      start_table_chunk(ring + ((it + 1) & 1) * BV * LDW, w,
                        (vt_begin + (it + 1) / n_chunks) * BV, ((it + 1) % n_chunks) * DK, V, D);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    }
    logits_chunk(acc, sH, ldh, ring + (it & 1) * BV * LDW, c * DK, row, col);
    if (c < n_chunks - 1) continue;

#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sS + row * BV + col + 16 * j, acc[j], BV, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int srow = warp * ROWS_PER_WARP + r;
      const int lbl = sLbl[srow];
      float x[BV / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BV / 32; ++j) {
        const int vv = v0 + lane + 32 * j;
        x[j] = vv < V ? sS[srow * BV + lane + 32 * j] * scale : NEG_INF;  // vocab tail
        if (vv == lbl) pick[r] += x[j];
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BV / 32; ++j) sum += v0 + lane + 32 * j < V ? expf(x[j] - m_new) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + sum;
      m_run[r] = m_new;
    }
  }

  // this split's (max, sum-exp, picked) of each row: part [3][splits][n_pad]
  const long long plane = (long long)gridDim.y * n_pad;
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    float p = pick[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
    if (lane == 0) {
      const long long i = (long long)split * n_pad + n0 + warp * ROWS_PER_WARP + r;
      part[i] = m_run[r];
      part[plane + i] = l_run[r];
      part[2 * plane + i] = p;
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

__global__ void __launch_bounds__(THREADS)
fused_ce_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ labels, const float* __restrict__ lse,
                    const float* __restrict__ g, float* __restrict__ part, int N, int V, int D,
                    int n_pad, int tiles_per_split, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = D + 8;
  bf16* sH = reinterpret_cast<bf16*>(smem);
  bf16* ring = sH + BN * ldh;
  float* sS = reinterpret_cast<float*>(ring + 2 * BV * LDW);
  bf16* sQ = reinterpret_cast<bf16*>(sS);  // [BN][LDQ], written once sS has been read
  int* sLbl = reinterpret_cast<int*>(sS + BN * BV);
  float* sLse = reinterpret_cast<float*>(sLbl + BN);
  float* sG = sLse + BN;

  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int n_vtiles = (V + BV - 1) / BV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_vtiles, vt_begin + tiles_per_split);
  const int n_chunks = D / DK;
  const int steps = 2 * n_chunks;  // per vocab tile: the logits sweep, then the dh sweep
  const int total = (vt_end - vt_begin) * steps;
  const int row = 16 * (warp % 4);
  const int col = 64 * (warp / 4);   // logit tiles (4 of 16 columns)
  const int dcol = 32 * (warp / 4);  // dh tiles of a chunk (2 of 16 columns)
  float* slab = part + ((long long)split * n_pad + n0) * D;

  start_table_chunk(ring, w, vt_begin * BV, 0, V, D);
  load_hidden(sH, h, n0, N, D);
  for (int i = threadIdx.x; i < BN; i += THREADS) {
    const bool live = n0 + i < N;
    sLbl[i] = live ? labels[n0 + i] : -1;
    sLse[i] = live ? lse[n0 + i] : 0.f;
    sG[i] = live ? g[n0 + i] : 0.f;  // rows past N contribute nothing
  }

  Acc acc[4], dacc[2];
  for (int it = 0; it < total; ++it) {
    const int s = it % steps, c = s % n_chunks;
    const bool dh_pass = s >= n_chunks;
    const bool first_tile = it < steps;
    const int v0 = (vt_begin + it / steps) * BV;
    if (dh_pass) {  // start the slab's loads before waiting for the chunk
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (first_tile)
          wmma::fill_fragment(dacc[j], 0.f);
        else
          wmma::load_matrix_sync(dacc[j], slab + (long long)row * D + c * DK + dcol + 16 * j,
                                 D, wmma::mem_row_major);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // chunk `it` visible; every warp is done with chunk it - 1
    if (it + 1 < total)
      start_table_chunk(ring + ((it + 1) & 1) * BV * LDW, w,
                        (vt_begin + (it + 1) / steps) * BV, ((it + 1) % n_chunks) * DK, V, D);
    const bf16* buf = ring + (it & 1) * BV * LDW;

    if (dh_pass) {  // dh[:, c-chunk] += Q @ W[v0 : v0 + BV, c-chunk]
#pragma unroll
      for (int kk = 0; kk < BV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + row * LDQ + kk * 16, LDQ);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, buf + kk * 16 * LDW + dcol + 16 * j, LDW);
          wmma::mma_sync(dacc[j], a, bm, dacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(slab + (long long)row * D + c * DK + dcol + 16 * j, dacc[j], D,
                                wmma::mem_row_major);
      continue;
    }

    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    }
    logits_chunk(acc, sH, ldh, buf, c * DK, row, col);
    if (c < n_chunks - 1) continue;

#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sS + row * BV + col + 16 * j, acc[j], BV, wmma::mem_row_major);
    __syncthreads();
    // Q = (softmax - onehot) * g, rounded to bf16, 0 on the vocab tail; read every
    // logit first, then overwrite sS with Q (it aliases sS)
    constexpr int PER_THREAD = BN * BV / THREADS;
    float q[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int r = e / BV, vv = v0 + e % BV;
      float p = vv < V ? expf(sS[e] * scale - sLse[r]) : 0.f;
      if (vv == sLbl[r]) p -= 1.f;
      q[k] = p * sG[r];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = threadIdx.x + k * THREADS;
      sQ[(e / BV) * LDQ + e % BV] = __float2bfloat16(q[k]);
    }
    // the next iteration's barrier makes sQ visible before the dh sweep reads it
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

bool supported(int D) {
  return D % DK == 0 && D > 0 && smem_bytes(D) <= 232448;
}

}  // namespace

// hidden [N, D] bf16, table [V, D] bf16, labels [N] int32 -> lse [N], nll [N] fp32.
// part: fp32 scratch [3][splits][n_pad], n_pad = N rounded up to 64.
extern "C" int fused_ce_fwd_bf16(const void* hidden, const void* table, const void* labels,
                                 void* part, void* lse, void* nll, int N, int V, int D,
                                 int splits, int tiles_per_split, float scale, void* stream) {
  if (!supported(D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(fused_ce_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + BN - 1) / BN;
  const int n_pad = n_tiles * BN;
  fused_ce_fwd_kernel<<<dim3(n_tiles, splits), THREADS, bytes, st>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(table),
      static_cast<const int*>(labels), static_cast<float*>(part), N, V, D, n_pad,
      tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_combine<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(lse), static_cast<float*>(nll), N,
      n_pad, splits);
  return (int)cudaGetLastError();
}

// hidden, table, labels as above; lse [N], g [N] fp32 -> dh [N, D] fp32 (unscaled).
// part: fp32 scratch [splits][n_pad][D].
extern "C" int fused_ce_bwd_bf16(const void* hidden, const void* table, const void* labels,
                                 const void* lse, const void* g, void* part, void* dh, int N,
                                 int V, int D, int splits, int tiles_per_split, float scale,
                                 void* stream) {
  if (!supported(D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(fused_ce_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + BN - 1) / BN;
  const int n_pad = n_tiles * BN;
  fused_ce_bwd_kernel<<<dim3(n_tiles, splits), THREADS, bytes, st>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(table),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(part), N, V, D, n_pad,
      tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_bwd_combine<<<264, 256, 0, st>>>(static_cast<const float*>(part),
                                            static_cast<float*>(dh), N, D, n_pad, splits);
  return (int)cudaGetLastError();
}
