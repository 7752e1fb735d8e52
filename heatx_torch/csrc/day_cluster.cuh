// The CTAs of one zone-closed block, for the four day bodies (day_march_tr.cu,
// day_march_parity.cu, day_adjoint_tr.cu, day_adjoint_parity.cu).  In the
// launch variants of one CTA a block (kLaunchVariants' cluster 1) that CTA
// holds all of the block's lanes.  In the cluster variant (kCl) a block of C
// x 128 lanes runs as one thread-block cluster of C CTAs, CTA r holding lanes
// [128 r, 128 r + 128): each keeps today's per-surface code and registers for
// its lanes, and a copy of the whole component's zone rows, which every CTA
// computes alike (the same face values summed in the same order, so the same
// bits).  Only the zone phase reads across CTAs: a zone's sum takes each face
// of its fixed-order list from the face rows of the CTA that owns the face,
// over distributed shared memory (cluster.map_shared_rank), so the sums keep
// the one-CTA order and determinism (no float atomics).  Every barrier of the
// bodies is then a cluster barrier (cluster.sync): it orders a face row's
// writes before the other CTAs' reads, and those reads before the next
// writes.  Per-zone outputs are the lead CTA's (rank 0) to write.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "day_common.cuh"

namespace heatx {

namespace cg = cooperative_groups;

// The block's CTAs.  Ctas<true, kCtaLanes> is the cluster variant's: C CTAs
// of kCtaLanes lanes, read at run time (C = 1 runs as one CTA).  Ctas<false>
// is every other variant's: the block is this CTA (its own face rows, its own
// barrier), an empty type, so that the G = 4 variants compile as before.
template <bool kCl, int kCtaLanes>
struct Ctas {
  int b;      // the zone-closed block (component) of this CTA
  int rank;   // this CTA's rank in the cluster
  int C;      // the cluster's CTAs
  int lane0;  // the block-local index of this CTA's first lane

  __device__ Ctas() {
    const cg::cluster_group cl = cg::this_cluster();
    C = static_cast<int>(cl.num_blocks());
    rank = static_cast<int>(cl.block_rank());
    b = static_cast<int>(blockIdx.x) / C;
    lane0 = rank * kCtaLanes;
  }
  __device__ __forceinline__ int block() const { return b; }
  // Whether this CTA writes the block's per-zone outputs.
  __device__ __forceinline__ bool lead() const { return rank == 0; }
  __device__ __forceinline__ void sync() const {
    if (C > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
  // Block-local face f (lane*2 + side) of a face row (`row`: this CTA's
  // copy, indexed by its lanes' faces), from the CTA that owns the face.
  template <typename T>
  __device__ __forceinline__ T face(const T* row, int f) const {
    if (C == 1) return row[f];
    const int r = f / (2 * kCtaLanes);
    return *cg::this_cluster().map_shared_rank(const_cast<T*>(row) + (f - r * 2 * kCtaLanes), r);
  }
  // The lead CTA's copy of a shared int (the non-finite count's).
  __device__ __forceinline__ int* lead_int(int* p) const {
    return C > 1 ? cg::this_cluster().map_shared_rank(p, 0) : p;
  }
};

template <int kCtaLanes>
struct Ctas<false, kCtaLanes> {
  static constexpr int lane0 = 0;
  __device__ Ctas() {}
  __device__ __forceinline__ int block() const { return blockIdx.x; }
  __device__ __forceinline__ bool lead() const { return true; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  template <typename T>
  __device__ __forceinline__ T face(const T* row, int f) const {
    return row[f];
  }
  __device__ __forceinline__ int* lead_int(int* p) const { return p; }
};

// Launch `kernel(arg)` over NB blocks, each a cluster of C CTAs of `threads`
// threads and `smem` bytes of dynamic shared memory.  Returns
// kClusterRefused when the card holds no such cluster
// (cudaOccupancyMaxActiveClusters: the variant's threads, registers and
// shared memory), else the launch's error.
template <typename Arg>
int launch_cluster(void (*kernel)(Arg), int NB, int C, int threads, size_t smem, cudaStream_t stream,
                   const Arg& arg) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(NB * C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return kClusterRefused;
  e = cudaLaunchKernelEx(&cfg, kernel, arg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace heatx
