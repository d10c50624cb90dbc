// The 1-D evaluation body on the staged search, shared by K1 (eval_kernels.cu:
// the rows of the interval table) and R3 (bigknots_kernels.cu: the interval's
// values from four 1-D arrays).
//
// A block stages the axis once as search.cuh's breadth-first tree and, where
// the row source asks for it, the rows after the tree, then strides over the
// queries: the clamped lower index from the tree (leaders: the search ends on
// the global axis), the row [x_l, x_r, y_l, y_r, a, b] from the row source, the
// symmetric Hermite form with the +-inf lerp of linear tables, in the plain
// versions' operation order (ops/eval_kernels.py _eval_plain).  A row source
// is a struct with
//   static size_t staged_bytes(int n)  the shared memory its rows take after the tree
//   void stage(T* smem, int n)         stage them (the block, before the search)
//   void load(int idx, T v[6])         the row of interval idx

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"  // StagedAxis, staged_grid, tree_levels, kSearchThreads

namespace {

// K1's row forms: six scalar loads; three 2-element loads (float2 / double2,
// where the table's base and width keep every row 8- / 16-byte aligned); the
// six columns staged once a block in shared memory after the tree (where the
// tree is the whole axis and both fit a block)
enum RowRead { kRowScalar = 0, kRowWide = 1, kRowShared = 2 };

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <typename T, int kRead>
__device__ __forceinline__ void load_row(const T* __restrict__ row, T v[6]) {
  if (kRead == kRowScalar) {
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = __ldg(row + j);
  } else {
    using P = typename Pair<T>::type;
    const P* p = reinterpret_cast<const P*>(row);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const P e = kRead == kRowShared ? p[j] : __ldg(p + j);
      v[2 * j] = e.x;
      v[2 * j + 1] = e.y;
    }
  }
}

// K1's rows: the interval table tbl (n - 1, ch), ch >= 6, read in the form
// kRead; with kRowShared its six columns are staged after the tree, 6 (n - 1)
// elements
template <typename T, int kRead>
struct TableRows {
  const T* tbl;
  int64_t ch;
  const T* rows;  // the staged columns (kRowShared)

  static size_t staged_bytes(int n) {
    return kRead == kRowShared ? 6 * static_cast<size_t>(n - 1) * sizeof(T) : 0;
  }

  __device__ __forceinline__ void stage(T* smem, int n) {
    if (kRead == kRowShared) {
      for (int e = threadIdx.x; e < 6 * (n - 1); e += blockDim.x) {
        smem[e] = __ldg(tbl + (e / 6) * ch + e % 6);
      }
      rows = smem;
    }
  }

  __device__ __forceinline__ void load(int idx, T v[6]) const {
    load_row<T, kRead>(kRead == kRowShared ? rows + 6 * static_cast<int64_t>(idx)
                                           : tbl + idx * ch,
                       v);
  }
};

// The evaluation on the staged tree of ax: knot j w, j < c, in h levels of
// shared memory (kWhole: w = 1, the whole axis), the rows from `rows`
template <typename T, bool kWhole, class Rows>
__global__ void __launch_bounds__(kSearchThreads)
    staged_eval1d_kernel(StagedAxis<T> ax, int h, Rows rows, const T* __restrict__ q,
                         T* __restrict__ out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  ax.tree = reinterpret_cast<T*>(smem);
  ax.stage(h);
  rows.stage(ax.tree + (1 << h), ax.n);
  __syncthreads();
#pragma unroll 1
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T qi = q[i];
    // NaN takes row n-2, as lower_index (the tree's compares would all be false)
    const int idx = ax.template lower<kWhole>(qi, h);
    T v[6];
    rows.load(idx, v);
    const T x_l = v[0], x_r = v[1], y_l = v[2], y_r = v[3], a = v[4], b = v[5];
    const T one = T(1);
    const T t = (qi - x_l) / (x_r - x_l);
    // symmetric Hermite form, cubic_spline.rs:818-828
    const T base = (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t);
    // a linear table (a = b = 0) extrapolates to +-inf like calc_frac
    // (linear.rs:29-37); the symmetric lerp would give inf - inf = NaN there
    const bool lin_inf = isinf(t) && a == T(0) && b == T(0);
    out[i] = lin_inf ? y_l + t * (y_r - y_l) : base;
  }
}

// The shared memory of the evaluation on ax with `Rows`: the tree, then the rows
template <typename T, class Rows>
size_t staged_eval1d_bytes(const StagedAxis<T>& ax) {
  return (static_cast<size_t>(1) << tree_levels(ax.c)) * sizeof(T) + Rows::staged_bytes(ax.n);
}

// Launch it: blocks of kSearchThreads on a whole tree, half as many on leaders
// (their last levels leave the tree for the global axis), no more than fill
// the card once
template <typename T, bool kWhole, class Rows>
cudaError_t staged_eval1d(const StagedAxis<T>& ax, const Rows& rows, const T* q, T* out,
                          int64_t nq, cudaStream_t s) {
  auto kernel = staged_eval1d_kernel<T, kWhole, Rows>;
  const int h = tree_levels(ax.c);
  const size_t smem = staged_eval1d_bytes<T, Rows>(ax);
  const int threads = kWhole ? kSearchThreads : kSearchThreads / 2;
  unsigned int blocks = 0;
  const cudaError_t err = staged_grid(kernel, threads, smem, nq, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(ax, h, rows, q, out, nq);
  return cudaGetLastError();
}

}  // namespace
