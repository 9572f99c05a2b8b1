// The split-K merge of the decode and verify kernels (K1, K3 and K4: in
// decode_mma.cu for bf16 q; in paged_attention.cu and flash_decode.cu for
// f32 q) across a thread-block cluster, and the launch of such a cluster.
//
// The TPU kernels carried their split partials through a sequential grid
// and merged them in XLA. Here the n_splits blocks of one (slot, kv head)
// are one cluster (grid x = the split, cluster (n_splits, 1, 1)): each
// block leaves its rows' merged (m, l, acc) in its own shared memory, and
// rank 0 reads its peers' through distributed shared memory and writes the
// output. No partial buffer in device memory, no second pass, no atomics
// and no counter to reset between launches; the merge order is fixed, so
// the kernels are deterministic.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace port_kernels {

// The most splits of one (slot, kv head): the portable cluster size.
constexpr int kMaxSplits = 8;

// Rank 0 of the cluster merges, for each of its n_rows rows, the rows
// that every block of the cluster (one split each, in rank order) left in
// its shared memory: m[r] and l[r] (the running max of the scores, in
// base 2 where kExp2 and else natural, and the row sum under it) and the
// unnormalised acc_row(r)[0 .. HD). In split order: M = max m_s, w_s =
// exp(m_s - M), out_row(r) = sum w_s acc_s / sum w_s l_s, cast to OT. A
// split that saw nothing of the row (m = -inf or kNegInf, l = 0) drops
// out, and a row that no split saw yields zeros. acc rows are 16-byte
// aligned. Every thread of every block of the cluster calls it; its first
// cluster.sync() also orders the block's own writes of m, l and acc.
template <int HD, bool kExp2, typename OT, typename AccRow, typename OutRow>
__device__ __forceinline__ void cluster_merge_rows(int n_rows, float* m,
                                                   float* l, AccRow acc_row,
                                                   OutRow out_row) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                         // every split's rows are written
  if (cluster.block_rank() == 0) {
    const int ns = static_cast<int>(cluster.num_blocks());
    constexpr int V = HD / 4;
    for (int i = threadIdx.x; i < n_rows * V; i += blockDim.x) {
      const int r = i / V;
      const int d = (i - r * V) * 4;
      float ms[kMaxSplits];
      float mx = -INFINITY;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        ms[s] = s < ns ? *cluster.map_shared_rank(m + r, s) : -INFINITY;
        mx = fmaxf(mx, ms[s]);
      }
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float lsum = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s >= ns || ms[s] == -INFINITY) continue;
        const float w = kExp2 ? exp2f(ms[s] - mx) : expf(ms[s] - mx);
        const float4 x = *reinterpret_cast<float4*>(
            cluster.map_shared_rank(acc_row(r) + d, s));
        a.x += w * x.x;
        a.y += w * x.y;
        a.z += w * x.z;
        a.w += w * x.w;
        lsum += w * *cluster.map_shared_rank(l + r, s);
      }
      const float den = fmaxf(lsum, 1e-20f);
      store4(out_row(r) + d, a.x / den, a.y / den, a.z / den, a.w / den);
    }
  }
  cluster.sync();                         // peers keep their shared memory
}                                         // until rank 0 has read it

// The launch of grid in clusters of grid.x blocks (the splits).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  ClusterLaunch(dim3 grid, int threads, size_t smem, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid.x;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;   // cfg points into attr
};

template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  ClusterLaunch launch(grid, threads, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Once per kernel (checked flag): can the card co-schedule a cluster of
// kMaxSplits blocks of it with this much shared memory each? A cluster
// whose blocks cannot all be resident at once is refused at launch; this
// says so before the first one, as cudaErrorLaunchOutOfResources.
template <typename... Params>
cudaError_t check_cluster_fits(void (*kernel)(Params...), int threads,
                               size_t smem, bool& checked) {
  if (checked) return cudaSuccess;
  note_first_use();
  ClusterLaunch launch(dim3(kMaxSplits), threads, smem, nullptr);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  checked = true;
  return cudaSuccess;
}

}  // namespace port_kernels
