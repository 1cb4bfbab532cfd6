// Thread-block cluster helpers shared by kernels B16 (mlp_fused.cu), B2
// (pair_attention.cuh) and B18 (fused_rcu.cu): the CTA's rank, cluster barriers, loads and stores
// into a peer CTA's shared memory (distributed shared memory, DSM) at the
// addresses `mapa` gives, and the launch configuration of a cluster grid.

#pragma once

#include "wgmma.cuh"

namespace lseg {
namespace {
namespace cluster {

__device__ __forceinline__ int rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: this thread's earlier writes
// (to its own or a peer's shared memory) are visible to every thread of
// the cluster after it.
__device__ __forceinline__ void sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// The two halves of a cluster barrier that orders nothing: `arrive`
// early (say, at the kernel's start), `wait` just before the first access
// of a peer's shared memory, which then has certainly started.
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The address of `p` (in this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(wg::smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, uint32_t lo,
                                        uint32_t hi) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(lo), "r"(hi)
               : "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_peer(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The launch configuration of a grid whose x axis is cut into clusters
// of `size` CTAs.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(dim3 grid, int threads, int smem, int size, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace cluster
}  // namespace
}  // namespace lseg
