// Thread-block clusters on Hopper (sm_90a): the cluster's ranks and barrier, distributed
// shared memory (mapped addresses, st.async counted on the receiver's mbarrier, remote
// arrivals), a sum of fp32 partials held in each CTA's shared memory over the cluster
// (ClusterSum), and the launch with the cluster-dimension attribute (clusters above the
// portable 8 CTAs, up to the H100's 16, allowed on the kernel only where asked for: K4 and
// K5 past head dim 2048). Used by flash_attn_cluster.cu (K1/K4/K5 above head dim 512),
// decode_attention.cu (K3 above 512) and layernorm_bwd.cu (K8's rows from 19,369 to 32,768
// wide).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace sm90 {

constexpr int MAX_CLUSTER = 8;  // the portable cluster size
// the H100's largest cluster, which a kernel may take once it allows non-portable sizes
constexpr int MAX_NONPORTABLE_CLUSTER = 16;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of the cluster: what each did before is seen by all after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address of the same shared-memory byte in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_cta(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// one arrival on a barrier of any CTA of the cluster (a mapped address), after reads of
// the buffer it guards
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// 16 bytes into the shared memory of any CTA of the cluster (mapped addresses), counted on
// that CTA's barrier `bar` as complete_tx bytes when they have landed
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
               ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}

__device__ __forceinline__ float4 ld_shared(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The sum over the cluster of `total` float4 chunks of fp32 partials that every CTA holds
// in its own shared memory, in the CTA's `sum` buffer when run() returns: chunk i is
// reduced by CTA i / piece (piece = ceil(total / C)), which adds the C partials in rank
// order and sends the sum to every CTA, so each element is summed by one thread in one
// order and every CTA holds the same bits. `part` is [C][piece] float4: the CTAs'
// chunks of this CTA's piece. Data moves only by st.async into the receiving CTA's
// shared memory, counted on its barrier (no fence); a buffer is written again once every
// reader warp of the cluster has arrived on the writers' barrier (a plain remote
// arrival). Every warp of the CTA calls run() and then, once it has read `sum`,
// release(), once a round; `parity` is the round's lowest bit. `total` may change from
// launch to launch, not between rounds. The pattern of flash_attn_cluster.cu's Exchange,
// on chunks in shared memory instead of wgmma's registers.
struct ClusterSum {
  uint32_t part, sum;  // shared-memory addresses in this CTA
  uint32_t bar;        // partials landed, partials read, sums landed, sums read
  uint32_t ctas, rank;
  int total, warps;    // chunks a round; warps of a CTA

  __device__ int piece() const { return (total + (int)ctas - 1) / (int)ctas; }
  __device__ int piece_chunks() const {
    const int lo = (int)rank * piece(), hi = min(total, lo + piece());
    return hi > lo ? hi - lo : 0;
  }

  // one thread, before the cluster's first synchronisation
  __device__ void init() const {
    mbar_init(bar, 1);
    mbar_init(bar + 8, warps * ctas);
    mbar_init(bar + 16, 1);
    mbar_init(bar + 24, warps * ctas);
    mbar_expect_tx(bar, ctas * piece_chunks() * 16);
    mbar_expect_tx(bar + 16, total * 16);
  }

  // mine: this CTA's partials (generic pointer into its shared memory), every thread
  // of the CTA (tid of n)
  __device__ __forceinline__ void run(const float4* mine, uint32_t parity, int tid, int n) const {
    const uint32_t landed_p = bar, read_p = bar + 8, landed_s = bar + 16, read_s = bar + 24;
    const int lane = tid % 32, p = piece();
    // 1. each chunk to the CTA that reduces it, once every reducer has read the last round's
    mbar_wait(read_p, parity ^ 1);
    for (int i = tid; i < total; i += n) {
      const int r = i / p;
      st_async(map_cta(part + 16 * (rank * p + i - r * p), r), mine[i], map_cta(landed_p, r));
    }
    // 2. this CTA's piece summed in rank order, to every CTA's `sum` once its readers have
    //    read the last round's
    mbar_wait(landed_p, parity);
    if (tid == 0) mbar_expect_tx(landed_p, ctas * piece_chunks() * 16);  // the next round's
    mbar_wait(read_s, parity ^ 1);
    const int lo = rank * p, n_chunks = piece_chunks();
    for (int i = tid; i < n_chunks; i += n) {
      float4 acc = ld_shared(part + 16 * i);
      for (uint32_t w = 1; w < ctas; ++w) acc = add4(acc, ld_shared(part + 16 * (w * p + i)));
      for (uint32_t c = 0; c < ctas; ++c)
        st_async(map_cta(sum + 16 * (lo + i), c), acc, map_cta(landed_s, c));
    }
    __syncwarp();  // the warp's reads of `part` before its arrivals, one lane a CTA
    if (lane < (int)ctas) arrive_remote(map_cta(read_p, lane));
    // 3. the whole sums landed in this CTA's `sum`
    mbar_wait(landed_s, parity);
    if (tid == 0) mbar_expect_tx(landed_s, total * 16);  // the next round's
  }

  // after the warp's reads of `sum`
  __device__ __forceinline__ void release(int lane) const {
    __syncwarp();
    if (lane < (int)ctas) arrive_remote(map_cta(bar + 24, lane));
    __syncwarp();
  }
};

// `kernel` set up for clusters of `cluster` CTAs at `smem` bytes of dynamic shared memory:
// above the portable 8 it is allowed the non-portable sizes. The attribute stays on the
// kernel for the rest of the process, so a later launch of the same kernel in at most 8
// CTAs carries it too (it only permits the larger sizes); K1's, K3's and K8's kernels never
// ask for more than 8 and never get it
template <typename Kernel>
cudaError_t cluster_attributes(Kernel kernel, int cluster, uint32_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > MAX_CLUSTER)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// a launch of `kernel` over `grid` (x a multiple of `cluster`) in clusters of `cluster`
// CTAs along x; returns the launch's error (a cluster the card cannot place, such as
// cudaErrorClusterOutOfResources, included: no retry at another size)
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, int cluster, uint32_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cluster_attributes(kernel, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// how many clusters of `cluster` CTAs of `kernel` (threads, dynamic shared memory) can be
// resident at once on the current device: cudaOccupancyMaxActiveClusters; 0 on an error
template <typename Kernel>
int max_active_clusters(Kernel kernel, int threads, int cluster, uint32_t smem) {
  if (cluster_attributes(kernel, cluster, smem) != cudaSuccess) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return 0;
  return n;
}

}  // namespace sm90
