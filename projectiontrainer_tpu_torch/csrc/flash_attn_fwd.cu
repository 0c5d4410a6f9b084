// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + fp32 log-sum-exp.
//
// Replaces the TPU kernel projectiontrainer_tpu/ops/flash_attention.py:_fwd_kernel
// (launched from _fwd). Same contract: online softmax in the exp2 domain, fp32
// running max / sum / output accumulator, causal (tiles above the diagonal are
// skipped), sliding window (tiles below it are skipped), per-batch key padding mask,
// GQA (query head h reads kv head h / n_rep), and rows with no valid key give 0.
//
// What bounds it on the H100: at the prefill and tower shapes the score and PV
// products dominate (~4*B*H*T^2*D flops against ~2*B*T*H*D*2 bytes), so it is
// compute-bound; the tensor cores are reached through WMMA (mma.sync, 16x16x16 bf16,
// fp32 accumulate).
//
// Design, simple first: one CTA of 4 warps per (64-row query tile, query head,
// batch). Q, the current 64-row K and V tiles, the fp32 scores, the bf16
// probabilities and the fp32 output accumulator all live in shared memory (188 KB at
// D=256, 66 KB at D=64); warp w owns query rows 16w..16w+15 of every tile, so only
// the K/V tile loads need a block barrier. Inputs are read in their [B, T, H, D]
// layout through strides (unit stride on D), with no transposes.
//
// The trap the design handles: NEG_INF is finite, so for a row with no valid key
// m = NEG_INF and exp2(s - m) = 1. Invalid probabilities are therefore set to 0
// explicitly and the output divided by max(l, 1e-30), so left-padded query rows
// come out as 0 and not as a uniform average.
//
// For training, the kernel can also write O in fp32 (``out_f32``, dense [B, T, Hq, D];
// null skips it): the backward's delta = rowsum(dO * O) must equal sum_j P_ij dP_ij,
// whose rows of dS then sum to zero. From the bf16 output, delta is off by a per-row
// constant of ~2^-9 |dO| |O|, which dQ and dK take on along the keys' and queries'
// common component; on a trained tower whose tokens are nearly alike that error
// dominated the last layers' q/k gradients (measured on the card). For the same
// reason O is divided by the sum of the bf16-rounded weights the PV product applied
// (u), not by the fp32 sum of the unrounded ones (l): O's weights then sum to 1, so
// V's common part passes through exactly. With l they summed to 1 +- ~2^-9 / sqrt(T),
// and that error in delta still cost dq a cosine of 0.94 of fp32 on tokens whose
// common part is 15x their spread (plain bf16 attention: 0.9997). The lse stays
// m + log(l), so the backward's exp(S - lse) sums to 1.
//
// Head dims that are not a multiple of 16 (so400m's D = 72) are padded INSIDE the
// kernel to DP, the next multiple of 16 (WMMA's k and n): the shared tiles are
// [rows][DP], their columns D..DP-1 are zeroed once and never loaded, and only the D
// real columns are written back. The scale is the caller's (72^-0.5, not 80^-0.5); the
// zero columns add nothing to Q K^T and produce zero output columns, which are dropped.
// Nothing is padded on the host.
//
// Left for later PRs: wgmma with the output kept in registers, TMA loads of K/V
// into a multi-stage ring, a warp-specialised producer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;  // 16: one WMMA row block per warp
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;

// the shared tiles' row length: D rounded up to a multiple of 16
template <int D>
__host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }

template <int D>
constexpr size_t smem_bytes() {
  constexpr int DP = padded<D>();
  return (size_t)BQ * DP * 2          // sQ  bf16 [BQ][DP]
         + (size_t)BK * DP * 2 * 2    // sK, sV bf16 [BK][DP]
         + (size_t)BQ * BK * 4        // sS  fp32 [BQ][BK]
         + (size_t)BQ * BK * 2        // sP  bf16 [BQ][BK]
         + (size_t)BQ * DP * 4        // sO  fp32 [BQ][DP]
         + (size_t)BQ * 4;            // sCorr fp32 [BQ]
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_mask,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ out_f32, int T, int Hq, int Hkv,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh,
                 long long svb, long long svt, long long svh,
                 long long sob, long long sot, long long soh,
                 float scale, int causal, int window) {
  constexpr int DP = padded<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * DP;
  bf16* sV = sK + BK * DP;
  float* sS = reinterpret_cast<float*>(sV + BK * DP);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * BK);
  float* sO = reinterpret_cast<float*>(sP + BQ * BK);
  float* sCorr = sO + BQ * DP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * ROWS_PER_WARP;
  const float qk_scale = scale * LOG2E;  // exp2 domain

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;
  const int* mb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  zero_pad_cols<D>(sQ, BQ);
  zero_pad_cols<D>(sK, BK);
  zero_pad_cols<D>(sV, BK);
  load_tile<D>(sQ, qb + q0 * sqt, sqt, min(BQ, T - q0), BQ);
  for (int i = threadIdx.x; i < BQ * DP; i += THREADS) sO[i] = 0.f;

  // per-row running max (log2 domain), sum of the fp32 probabilities (for lse) and sum
  // of their bf16 roundings (the weights the PV product applies, for O's
  // normalisation), kept by every lane of the owning warp
  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP], u_run[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
    u_run[r] = 0.f;
  }

  int kt_end = (T + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb + k0 * skt, skt, min(BK, T - k0), BK);
    load_tile<D>(sV, vb + k0 * svt, svt, min(BK, T - k0), BK);
    __syncthreads();

    // S[row0:row0+16, 0:BK] = Q K^T for this warp's rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
      for (int kd = 0; kd < DP / 16; ++kd) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + row0 * DP + kd * 16, DP);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // K stored [BK][DP] row-major is K^T [DP][BK] column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, sK + n * 16 * DP + kd * 16, DP);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(sS + row0 * BK + n * 16, acc[n], BK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time; lane owns columns lane, lane+32
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = row0 + r;
      const int q_pos = q0 + row;
      float s[BK / 32];
      bool ok[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int col = lane + 32 * j;
        const int k_pos = k0 + col;
        bool valid = k_pos < T;
        if (causal) valid = valid && k_pos <= q_pos;
        if (window > 0) valid = valid && k_pos > q_pos - window;
        if (mb) valid = valid && k_pos < T && mb[min(k_pos, T - 1)] != 0;
        ok[j] = valid;
        s[j] = valid ? sS[row * BK + col] * qk_scale : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      float sum = 0.f, used = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = ok[j] ? exp2f(s[j] - m_new) : 0.f;  // explicit zero: see header
        const bf16 pb = __float2bfloat16(p);
        sum += p;
        used += __bfloat162float(pb);
        sP[row * BK + lane + 32 * j] = pb;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        used += __shfl_xor_sync(0xffffffffu, used, off);
      }
      const float corr = exp2f(m_run[r] - m_new);
      l_run[r] = l_run[r] * corr + sum;
      u_run[r] = u_run[r] * corr + used;
      m_run[r] = m_new;
      if (lane == 0) sCorr[row] = corr;
    }
    __syncwarp();

    // O[rows] *= corr, then O[rows] += P V
    for (int i = lane; i < ROWS_PER_WARP * DP; i += 32) {
      const int row = row0 + i / DP;
      sO[row * DP + i % DP] *= sCorr[row];
    }
    __syncwarp();
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, sO + row0 * DP + n * 16, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + row0 * BK + kk * 16, BK);
        wmma::load_matrix_sync(bv, sV + kk * 16 * DP + n * 16, DP);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(sO + row0 * DP + n * 16, o, DP, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // epilogue: out = O / max(u, 1e-30); lse = m + log(l) in natural-log units (see
  // the header)
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + r;
    const int t = q0 + row;
    if (t >= T) continue;
    const float l_safe = fmaxf(l_run[r], 1e-30f);
    const float inv = 1.f / fmaxf(u_run[r], 1e-30f);
    bf16* ob = out + b * sob + t * sot + h * soh;
    for (int c = lane; c < D; c += 32) ob[c] = __float2bfloat16(sO[row * DP + c] * inv);
    if (out_f32) {
      float* of = out_f32 + (((long long)b * T + t) * Hq + h) * D;
      for (int c = lane; c < D; c += 32) of[c] = sO[row * DP + c] * inv;
    }
    if (lane == 0) lse[((long long)b * Hq + h) * T + t] = m_run[r] / LOG2E + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask,
                   void* out, void* lse, void* out_f32, int B, int T, int Hq, int Hkv,
                   long long sqb, long long sqt, long long sqh,
                   long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh,
                   long long sob, long long sot, long long soh,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_mask), static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<float*>(out_f32), T, Hq, Hkv, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
      scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* kv_mask, void* out, void* lse, void* out_f32,
                                   int B, int T, int Hq, int Hkv, int D,
                                   long long sqb, long long sqt, long long sqh,
                                   long long skb, long long skt, long long skh,
                                   long long svb, long long svt, long long svh,
                                   long long sob, long long sot, long long soh,
                                   float scale, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_FLASH_CASE(DIM)                                                              \
  case DIM:                                                                              \
    return (int)launch<DIM>(q, k, v, kv_mask, out, lse, out_f32, B, T, Hq, Hkv, sqb, sqt, \
                            sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale,     \
                            causal, window, s);
  switch (D) {
    PTT_FLASH_CASE(64)
    PTT_FLASH_CASE(72)
    PTT_FLASH_CASE(128)
    PTT_FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PTT_FLASH_CASE
}
