// The staged (idx, t) search, shared by K2 and K3 (eval_kernels.cu) and R3idx
// (bigknots_kernels.cu): one kernel on search.cuh's StagedAxis, with or
// without the fraction.
//
// A block stages the axis once as the breadth-first tree of search.cuh (the
// whole axis, or every w-th knot as leaders with the search ending on the
// global axis between two of them), then strides over the queries: the
// clamped lower index, and with kFrac t = (q - x_l) / (x_r - x_l), its
// endpoints read from the tree where it holds the whole axis, else from the
// axis.  A NaN query gives n-2 (StagedAxis::index).  The arithmetic is K2's
// plain version's (ops/eval_kernels.py _index_frac_plain) in its operation
// order, so the result does not depend on the budget or the stride.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"  // StagedAxis, staged_grid, tree_levels, kSearchThreads

namespace {

// K3 (idx) and, with kFrac, K2 and R3idx (idx and t) on the staged tree of
// ax: knot j w, j < c, in h levels of shared memory (kWhole: w = 1, the whole
// axis, and t's endpoints read from the tree)
template <typename T, bool kWhole, bool kFrac>
__global__ void __launch_bounds__(kSearchThreads)
    staged_index_kernel(StagedAxis<T> ax, int h, const T* __restrict__ q,
                        int32_t* __restrict__ idx_out, T* __restrict__ t_out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  ax.tree = reinterpret_cast<T*>(smem);
  ax.stage(h);
  __syncthreads();
#pragma unroll 1
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T qi = q[i];
    // NaN gives n-2, as lower_index (the tree's compares would all be false)
    const int idx = ax.template lower<kWhole>(qi, h);
    idx_out[i] = idx;
    if (kFrac) t_out[i] = ax.template frac<kWhole>(qi, idx, h);
  }
}

template <typename T, bool kWhole, bool kFrac>
cudaError_t staged_index(const StagedAxis<T>& ax, const T* q, int32_t* idx, T* t, int64_t nq,
                         cudaStream_t s) {
  auto kernel = staged_index_kernel<T, kWhole, kFrac>;
  const int h = tree_levels(ax.c);
  const size_t smem = (static_cast<size_t>(1) << h) * sizeof(T);
  const int threads = kWhole ? kSearchThreads : kSearchThreads / 2;
  unsigned int blocks = 0;
  const cudaError_t err = staged_grid(kernel, threads, smem, nq, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(ax, h, q, idx, t, nq);
  return cudaGetLastError();
}

}  // namespace
