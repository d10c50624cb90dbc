// The clamped interval search shared by the search kernels (K1-K3 in
// eval_kernels.cu, R1 in cell2d_kernels.cu).
//
// lower_index(knots, n, q) is the count of knots <= q minus one, clamped to
// [0, n-2]: exactly torch.searchsorted(right=True) - 1 clamped, as
// ops/searchsorted.py get_lower_index computes it.  A NaN query gives n-2 as
// torch does (every comparison with NaN is false, so it is explicit here).
// The axis is read through the read-only path (__ldg).

#pragma once

#include <cuda_runtime.h>

namespace {

// Clamped lower-interval index of q on the strictly rising axis knots[0..n).
template <typename T>
__device__ __forceinline__ int lower_index(const T* __restrict__ knots, int n, T q) {
  if (q != q) return n - 2;  // NaN
  int lo = 0, hi = n;        // upper bound: first knot > q
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(knots + mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int idx = lo - 1;
  return idx < 0 ? 0 : (idx > n - 2 ? n - 2 : idx);
}

}  // namespace
