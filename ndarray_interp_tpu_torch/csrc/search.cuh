// The interval searches shared by the search kernels (K1-K3 in
// eval_kernels.cu, R1 in cell2d_kernels.cu, K6 and K7 in df_kernels.cu, R3
// and R3idx in bigknots_kernels.cu).
//
// lower_index(knots, n, q) is the count of knots <= q minus one, clamped to
// [0, n-2]: exactly torch.searchsorted(right=True) - 1 clamped, as
// ops/searchsorted.py get_lower_index computes it.  A NaN query gives n-2 as
// torch does (every comparison with NaN is false, so it is explicit here).
// The axis is read through the read-only path (__ldg): one dependent global
// load a level, and below the first levels the 32 lanes of a warp read 32
// different lines.  Only K2's first design still searches so: its wrapper
// keeps it where a staged tree does not pay (ops/eval_kernels.py _k2_budget).
//
// The staged search (K1, K2, K3, R1 on each of its two axes, R3, R3idx, and
// K6 and K7 on their widened pairs) reads a copy of the axis that each block stages once in
// shared memory, in breadth-first (Eytzinger) order: slot 1 the middle knot,
// slots 2k and 2k + 1 the middles of the halves below slot k, a perfect tree
// of 2^h - 1 slots, those past the c staged knots +inf.  A search step is then s = 2s + (tree[s] <= q): one
// shared load, a compare and a shift-add on the dependent chain, and after h
// steps s - 2^h is the count of staged knots <= q (the path's bits; +inf
// passes the +inf slots, so the count is clamped to c).  The probes of level L
// lie in 2^L consecutive slots.  (In sorted order a level's mids are
// multiples of the level's stride and fell in one bank of 8-byte words, up to
// 32 ways, on a 10,240-knot axis: K7 took 0.034 ms against 0.019.)  The tree
// holds knot j w for j < c: the whole axis (w = 1) up to a budget, else every
// w-th knot (the leaders), and the count of leaders <= q then puts q between
// knot (count-1) w and knot count w, where the search ends on the global
// axis.  The comparisons are those of the plain searchsorted on the same
// values, so the result does not depend on the budget.  StagedAxis bundles
// one staged axis (K1, K2, K3, R1's two, R3, R3idx).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

// Threads a block of a staged search whose tree holds the whole axis; a
// leader search runs half as many (its last levels leave the shared tree for
// the global axis).
constexpr int kSearchThreads = 1024;

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

// -- the staged search -------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T positive_inf();
template <>
__device__ __forceinline__ float positive_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double positive_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// the slot of the knot of sorted rank r in a tree of h levels
__device__ __forceinline__ int slot_of_rank(int r, int h) {
  const int t = __ffs(r + 1) - 1;  // r + 1 = (2 j + 1) 2^t at depth h - 1 - t
  return (1 << (h - 1 - t)) + ((r + 1) >> (t + 1));
}

// the sorted rank of the knot in slot i
__device__ __forceinline__ int rank_of_slot(int i, int h) {
  const int d = 31 - __clz(i);
  return ((2 * (i - (1 << d)) + 1) << (h - 1 - d)) - 1;
}

// the levels of a perfect tree of at least c slots
inline int tree_levels(int64_t c) {
  int h = 1;
  while ((static_cast<int64_t>(1) << h) - 1 < c) ++h;
  return h;
}

// the upper bound of q in the sorted at(lo .. hi-1): lo plus the count of them <= q
template <class I, class At, typename V>
__device__ __forceinline__ I upper_bound(At at, I lo, I hi, V q) {
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (at(mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The block stages knot(j w), j < c, in tree[1 .. 2^h), the pad slots +inf;
// the caller synchronises the block after it.
template <typename T, class Knot>
__device__ __forceinline__ void stage_tree(T* tree, Knot knot, int64_t w, int c, int h) {
  for (int i = threadIdx.x + 1; i < (1 << h); i += blockDim.x) {
    const int r = rank_of_slot(i, h);
    tree[i] = r < c ? knot(r * w) : positive_inf<T>();
  }
}

// The count of knots <= q (q not NaN) of an axis of n knots whose knots j w,
// j < c, are staged in a tree of h levels, from the slot s that h steps down
// the tree reached: the tree's count, then, unless the tree holds the whole
// axis, the search between two leaders on knot(m).
template <bool kWhole, typename T, class Knot>
__device__ __forceinline__ int64_t leader_count(int s, int h, int c, int64_t w, int64_t n,
                                                Knot knot, T q) {
  const int count = s - (1 << h) < c ? s - (1 << h) : c;  // +inf passes the +inf slots
  if (kWhole || count == 0) return count;
  const int64_t base = (count - 1) * w;  // knot base <= q < knot base + w, where it exists
  return upper_bound(knot, base + 1, base + w < n ? base + w : n, q);
}

// The same count, h steps down tree from its root first.
template <bool kWhole, typename T, class Knot>
__device__ __forceinline__ int64_t staged_count(const T* tree, int h, int c, int64_t w, int64_t n,
                                                Knot knot, T q) {
  int s = 1;
  for (int l = 0; l < h; ++l) s = 2 * s + (tree[s] <= q);
  return leader_count<kWhole>(s, h, c, w, n, knot, q);
}

// a count of knots <= q minus one, clamped to [0, n-2]
__device__ __forceinline__ int clamp_index(int64_t count, int64_t n) {
  const int64_t idx = count - 1;
  return static_cast<int>(idx < 0 ? 0 : (idx > n - 2 ? n - 2 : idx));
}

// One axis staged in shared memory: knot j w, j < c, in a tree of the
// kernel's h levels, at tree (set by the kernel)
template <typename T>
struct StagedAxis {
  const T* knots;
  int n;
  int64_t w;
  int c;
  T* tree;

  __device__ __forceinline__ T knot(int64_t m) const { return __ldg(knots + m); }

  // the block stages the tree; the caller synchronises the block after it
  __device__ __forceinline__ void stage(int h) const {
    stage_tree(tree, [&](int64_t m) { return knot(m); }, w, c, h);
  }

  // the clamped lower index of q from the slot s that h steps down the tree
  // reached; NaN gives n-2, as lower_index (the tree's compares would all be
  // false)
  template <bool kWhole>
  __device__ __forceinline__ int index(int s, int h, T q) const {
    const auto at = [&](int64_t m) { return knot(m); };
    return q == q ? clamp_index(leader_count<kWhole>(s, h, c, w, n, at, q), n) : n - 2;
  }

  // the clamped lower index of q: h steps down the tree, then index
  template <bool kWhole>
  __device__ __forceinline__ int lower(T q, int h) const {
    int s = 1;
    for (int l = 0; l < h; ++l) s = 2 * s + (tree[s] <= q);
    return index<kWhole>(s, h, q);
  }

  // K2's fraction of q in interval i, the endpoints from the tree where it
  // holds the whole axis
  template <bool kWhole>
  __device__ __forceinline__ T frac(T q, int i, int h) const {
    const T l = kWhole ? tree[slot_of_rank(i, h)] : knot(i);
    const T r = kWhole ? tree[slot_of_rank(i + 1, h)] : knot(i + 1);
    return (q - l) / (r - l);
  }
};

// an axis of n knots staged as at most `budget` of them: every w-th knot,
// w = ceil(n / budget), or with pow2 (R3, R3idx) the least power of two that
// fits, so that the knots between two leaders lie in one aligned run of w
template <typename T>
StagedAxis<T> staged_axis(const void* knots, int64_t n, int64_t budget, bool pow2 = false) {
  int64_t w = (n + budget - 1) / budget;
  if (pow2) {
    w = 1;
    while (w * budget < n) w *= 2;
  }
  return {static_cast<const T*>(knots), static_cast<int>(n), w,
          static_cast<int>((n + w - 1) / w), nullptr};
}

// A staged search's launch figures are properties of the device and the
// kernel: each is asked of the runtime once and kept, so a launch makes no
// runtime call but cudaGetDevice (a read of the thread's state) and its own.
// Most of K3's launches are two-query calls, which the calls would slow.
struct StagedLaunches {
  std::mutex mu;
  std::map<int, int> optin;  // by device: a block's shared memory, bytes
  // by (kernel, device): the dynamic shared memory the kernel was opened to
  std::map<std::pair<const void*, int>, size_t> opened;
  // by (kernel, device, threads, tree bytes): the blocks that fill the card once
  std::map<std::tuple<const void*, int, int, size_t>, int64_t> fill;
};

inline StagedLaunches& staged_launches() {
  static StagedLaunches kept;
  return kept;
}

// The shared memory a block of the current device may take, in bytes.
inline cudaError_t block_optin(int* out) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  StagedLaunches& kept = staged_launches();
  const std::lock_guard<std::mutex> lock(kept.mu);
  const auto it = kept.optin.find(dev);
  if (it != kept.optin.end()) {
    *out = it->second;
  } else {
    int optin = 48 * 1024;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    kept.optin.emplace(dev, optin);
    *out = optin;
  }
  return cudaSuccess;
}

// The most knots a tree of elements of `size` bytes holds in 1 / `trees` of a
// block's shared memory, capped at `budget` (at least 1).
inline cudaError_t tree_budget(int64_t budget, size_t size, int64_t* out, int trees = 1) {
  int optin = 0;
  const cudaError_t err = block_optin(&optin);
  if (err != cudaSuccess) return err;
  int64_t most = 1;
  while ((most + 1) * 2 * static_cast<int64_t>(size) * trees <= optin) most = 2 * most + 1;
  *out = budget < 1 ? 1 : (budget < most ? budget : most);
  return cudaSuccess;
}

// The grid of a staged search: blocks of `threads` with `smem` bytes of tree,
// no more than fill the card once (each block stages its tree once and strides
// over the queries), no more than the nq queries need.  The kernel's limit of
// dynamic shared memory only grows, so a launch of a smaller tree on another
// thread never finds it too low.
template <class Kernel>
cudaError_t staged_grid(Kernel kernel, int threads, size_t smem, int64_t nq, unsigned int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  StagedLaunches& kept = staged_launches();
  const std::lock_guard<std::mutex> lock(kept.mu);
  const auto key = std::make_tuple(fn, dev, threads, smem);
  auto it = kept.fill.find(key);
  if (it == kept.fill.end()) {
    size_t& opened = kept.opened[std::make_pair(fn, dev)];
    if (smem > opened) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      opened = smem;
    }
    int sms = 132, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    it = kept.fill.emplace(key, static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1)).first;
  }
  const int64_t need = (nq + threads - 1) / threads;
  *blocks = static_cast<unsigned int>(need < it->second ? need : it->second);
  return cudaSuccess;
}

}  // namespace
