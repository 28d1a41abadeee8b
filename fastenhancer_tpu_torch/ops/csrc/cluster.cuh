// Thread block clusters on Hopper (sm_90a): the rank of a block in its
// cluster, the cluster-wide barrier, and addresses of another block's
// shared memory (distributed shared memory). The BSRNN stack's tensor-core
// form (band_tc.cuh: two blocks, each writing into its peer) and the
// segmental RMS kernel (segmental_rms.cu: K blocks per row, each writing
// its frame powers into rank 0) use them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fe {

// this block's rank in its cluster, 0 .. cluster_size() - 1
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// every thread of every block of the cluster; orders shared and global
// memory across them
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the generic address of *p's counterpart in the shared memory of the
// cluster's block `rank` (loads and stores through it reach that block)
template <typename P>
__device__ __forceinline__ P* cluster_map(P* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)),
                 "r"(static_cast<uint32_t>(rank)));
  return reinterpret_cast<P*>(out);
}

// *p = v in the shared memory of the cluster's block `rank`, p being the
// address of the same variable in this block's shared memory
__device__ __forceinline__ void store_cluster(float* p, int rank, float v) {
  uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(static_cast<uint32_t>(rank)));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

}  // namespace fe
