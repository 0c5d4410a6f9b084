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
// become the limit. The design keeps the property the split cache exists for: one
// CTA per (batch, kv head) holds ALL nb * n_rep query rows of that kv head (12 at 3
// beams x 4 heads) and streams the shared prefix once for all of them, then each
// beam's own generated rows, with an online softmax in fp32 across both. Keys below
// the sliding window and generated slots after t are never read. P and G may be any
// length: the kernel masks its own edges, so the caches need no padding.
//
// Left for later PRs: with B * Hkv = 8 CTAs at batch 8 the card is mostly idle, so
// the next step is to split P across CTAs (split-K, a second pass combining the
// partial softmaxes), then cp.async / TMA double buffering of the K/V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TK = 32;  // keys per tile: one per lane in the softmax pass
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -2.3819763e38f;

template <int D>
size_t smem_bytes(int M) {
  return (size_t)M * D * 4        // sQ fp32 [M][D]
         + (size_t)TK * D * 2 * 2 // sK, sV bf16 [TK][D]
         + (size_t)M * TK * 4     // sS fp32 [M][TK]: scores, then probabilities
         + (size_t)M * D * 4      // sO fp32 [M][D]
         + (size_t)M * 4 * 3;     // sM, sL, sCorr fp32 [M]
}

struct Shared {
  float* q;
  bf16* k;
  bf16* v;
  float* s;
  float* o;
  float* m;
  float* l;
  float* corr;
};

// One tile of up to TK keys, rows [row_lo, row_hi) of the M query rows taking part.
// key_valid(j) says whether tile key j (0-based inside the tile) is attended.
template <int D, typename KeyValid>
__device__ void attend_tile(const Shared& sh, const bf16* kbase, const bf16* vbase, int n,
                            int M, int row_lo, int row_hi, float scale, KeyValid key_valid) {
  constexpr int E = D / 32;  // elements of a key row per lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  __syncthreads();  // the previous tile's K/V/S are no longer read
  for (int i = threadIdx.x; i < n * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(sh.k + r * D + c) =
        *reinterpret_cast<const uint4*>(kbase + (long long)r * D + c);
    *reinterpret_cast<uint4*>(sh.v + r * D + c) =
        *reinterpret_cast<const uint4*>(vbase + (long long)r * D + c);
  }
  __syncthreads();

  // scores: warp w takes keys w, w + 8, ...; lanes split D, then a shuffle reduction
  for (int kk = warp; kk < TK; kk += WARPS) {
    const bool live = kk < n && key_valid(kk);
    float kr[E];
    if (live) {
#pragma unroll
      for (int e = 0; e < E; ++e) kr[e] = __bfloat162float(sh.k[kk * D + lane * E + e]);
    }
    for (int r = 0; r < M; ++r) {
      float s = NEG_INF;
      if (live && r >= row_lo && r < row_hi) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += sh.q[r * D + lane * E + e] * kr[e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        s = part * scale;
      }
      if (lane == 0) sh.s[r * TK + kk] = s;
    }
  }
  __syncthreads();

  // online softmax: warp per row, lane per key
  for (int r = warp; r < M; r += WARPS) {
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

  // O = O * corr + P V; thread per (row, column), columns adjacent across threads
  for (int i = threadIdx.x; i < M * D; i += THREADS) {
    const int r = i / D, d = i % D;
    if (r < row_lo || r >= row_hi) continue;
    float acc = sh.o[i] * sh.corr[r];
    for (int kk = 0; kk < n; ++kk) acc += sh.s[r * TK + kk] * __bfloat162float(sh.v[kk * D + d]);
    sh.o[i] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                   const bf16* __restrict__ vp, const bf16* __restrict__ kg,
                   const bf16* __restrict__ vg, const int* __restrict__ prefix_mask,
                   bf16* __restrict__ out, int nb, int Hkv, int n_rep, int P, int G,
                   int t, int prefix_len, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = nb * n_rep;
  Shared sh;
  sh.q = reinterpret_cast<float*>(smem);
  sh.k = reinterpret_cast<bf16*>(sh.q + M * D);
  sh.v = sh.k + TK * D;
  sh.s = reinterpret_cast<float*>(sh.v + TK * D);
  sh.o = sh.s + M * TK;
  sh.m = sh.o + M * D;
  sh.l = sh.m + M;
  sh.corr = sh.l + M;

  const int h = blockIdx.x, b = blockIdx.y;
  const int Hq = Hkv * n_rep;

  // query rows r = beam * n_rep + rep: row (b * nb + beam) of q, head h * n_rep + rep
  for (int i = threadIdx.x; i < M * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int beam = r / n_rep, rep = r % n_rep;
    sh.q[i] = __bfloat162float(q[((long long)(b * nb + beam) * Hq + h * n_rep + rep) * D + d]);
    sh.o[i] = 0.f;
  }
  for (int r = threadIdx.x; r < M; r += THREADS) {
    sh.m[r] = NEG_INF;
    sh.l[r] = 0.f;
  }

  // shared prefix, read once for all beams
  const int q_slot = prefix_len + t;
  const int p_begin = window > 0 ? max(0, q_slot - window + 1) : 0;
  const bf16* kpb = kp + ((long long)b * Hkv + h) * P * D;
  const bf16* vpb = vp + ((long long)b * Hkv + h) * P * D;
  const int* pm = prefix_mask + (long long)b * P;
  for (int j0 = p_begin; j0 < P; j0 += TK) {
    const int n = min(TK, P - j0);
    attend_tile<D>(sh, kpb + (long long)j0 * D, vpb + (long long)j0 * D, n, M, 0, M, scale,
                   [&](int kk) { return pm[j0 + kk] != 0; });
  }

  // each beam's own generated slots j <= t (and inside the window)
  const int g_end = min(t + 1, G);
  const int g_begin = window > 0 ? max(0, t - window + 1) : 0;
  for (int beam = 0; beam < nb; ++beam) {
    const long long row = (long long)(b * nb + beam) * Hkv + h;
    const bf16* kgb = kg + row * G * D;
    const bf16* vgb = vg + row * G * D;
    for (int j0 = g_begin; j0 < g_end; j0 += TK) {
      const int n = min(TK, g_end - j0);
      attend_tile<D>(sh, kgb + (long long)j0 * D, vgb + (long long)j0 * D, n, M,
                     beam * n_rep, (beam + 1) * n_rep, scale, [](int) { return true; });
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < M * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int beam = r / n_rep, rep = r % n_rep;
    const float inv = 1.f / fmaxf(sh.l[r], 1e-30f);
    out[((long long)(b * nb + beam) * Hq + h * n_rep + rep) * D + d] =
        __float2bfloat16(sh.o[i] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* kg,
                   const void* vg, const void* prefix_mask, void* out, int B, int nb,
                   int Hkv, int n_rep, int P, int G, int t, int prefix_len, int window,
                   float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(nb * n_rep);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  decode_attn_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const bf16*>(kg), static_cast<const bf16*>(vg),
      static_cast<const int*>(prefix_mask), static_cast<bf16*>(out), nb, Hkv, n_rep, P, G,
      t, prefix_len, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attn_bf16(const void* q, const void* kp, const void* vp,
                                const void* kg, const void* vg, const void* prefix_mask,
                                void* out, int B, int nb, int Hkv, int n_rep, int P, int G,
                                int D, int t, int prefix_len, int window, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, kp, vp, kg, vg, prefix_mask, out, B, nb, Hkv, n_rep, P, G,
                             t, prefix_len, window, scale, s);
    case 128:
      return (int)launch<128>(q, kp, vp, kg, vg, prefix_mask, out, B, nb, Hkv, n_rep, P, G,
                              t, prefix_len, window, scale, s);
    case 256:
      return (int)launch<256>(q, kp, vp, kg, vg, prefix_mask, out, B, nb, Hkv, n_rep, P, G,
                              t, prefix_len, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
