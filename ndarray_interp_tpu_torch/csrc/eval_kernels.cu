// Interval search and 1-D evaluation kernels for Hopper (sm_90a).
//
// K1  eval1d       replaces the Pallas kernel ndarray_interp_tpu/ops/pallas_eval.py
//                  _kernel (fused_eval_1d): bucketize, interval fetch and the
//                  symmetric Hermite form, with the +-inf lerp of linear tables.
// K2  index_frac   replaces pallas_eval.py _frac_kernel (fused_index_frac):
//                  the search emitting (idx, t).
// K3  lower_index  replaces pallas_eval.py _index_kernel (fused_lower_index):
//                  the search emitting idx.
//
// What bounds them on this card: one query costs log2(n) dependent steps of
// the search plus, for K1, one 24- or 48-byte row of the interval table and 15
// operations.  The queries and results stream once (8 bytes a query for K1 in
// f32: 8 MB and 0.0024 ms at 1M queries), so the kernels are bound by the
// loads of the search and the row, not by device memory.  K2 answers
// with plenty of independent work: one thread per query and enough blocks to
// fill all SMs, the axis read through the read-only path (__ldg).  Below the
// first levels the 32 lanes of a warp then read 32 different lines, which the
// first-level cache serves one at a time.
//
// K1 and K3 search a copy of the axis staged in shared memory (search.cuh):
// each block stages it once, in the kernel's type, as a breadth-first tree,
// and strides over the queries; a grid that fills the card once.  The whole
// axis up to the budget the wrapper passes (2,048 knots are 16 KB of tree in
// f32, 32 KB in f64), else every w-th knot as leaders with the last log2(w)
// levels on the global axis (a 65,536-knot f32 tree would be 512 KB).  At a
// budget of one knot the search runs every level on the global axis, as K2's
// does: the first design's search.  K3's tree beat it at every batch size
// measured, two queries included (0.0093 against 0.0179 ms at 2,048 knots x
// 1M f32, an H100 80GB HBM3 at 700 W).  K1 then reads its row in one of three
// forms the wrapper picks (RowRead): six scalar loads, three 2-element loads
// where the table's base and width allow them, or from a copy of the table's
// six columns staged in shared memory beside the tree where both fit; the
// times that chose the wrapper's form are in ops/eval_kernels.py.  At 2,048
// knots x 1M f32 queries K1 took 0.0124 ms against 0.0244 for the first
// design's search and six scalar loads (tools/search_phases.py); K3, the same
// search alone, took 0.0095 there.  Neither loading each thread's next query
// early (0.0124) nor two queries a thread with both walks in one loop (0.0122
// against 0.0123 in one run) gained, so neither was kept.
//
// What the Pallas kernels did for the TPU and these do not: the one-hot MXU
// window fetch, the bf16 split passes, the finfo.max padding of the axis and
// the 64k-knot plan.  A GPU thread loads the row it needs, so any n >= 2 works
// and a NaN in the data stays in the intervals that touch it.
//
// Numerics: the index is the clamped count of knots <= q minus one, exactly
// torch.searchsorted(right=True) - 1 clamped to [0, n-2]; a NaN query gives
// n-2 as torch does (every comparison with NaN is false, so it is explicit
// here).  The arithmetic is written in the operation order of the plain
// PyTorch versions in ops/eval_kernels.py and is compiled with --fmad=false,
// so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"  // lower_index (K2), the staged search (K1, K3)

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void index_frac_kernel(const T* __restrict__ knots, int n,
                                  const T* __restrict__ q, int32_t* __restrict__ idx_out,
                                  T* __restrict__ t_out, int64_t nq) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= nq) return;
  const T qi = q[i];
  const int idx = lower_index(knots, n, qi);
  const T x_l = __ldg(knots + idx);
  const T x_r = __ldg(knots + idx + 1);
  idx_out[i] = idx;
  t_out[i] = (qi - x_l) / (x_r - x_l);
}

// K3 on the staged tree: knot j w, j < c, in h levels of shared memory
// (kWhole: w = 1, the whole axis)

template <typename T, bool kWhole>
__global__ void __launch_bounds__(kSearchThreads)
    staged_lower_index_kernel(const T* __restrict__ knots, int n, int64_t w, int c, int h,
                              const T* __restrict__ q, int32_t* __restrict__ idx_out,
                              int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tree = reinterpret_cast<T*>(smem);
  const auto knot = [&](int64_t m) { return __ldg(knots + m); };
  stage_tree(tree, knot, w, c, h);
  __syncthreads();
#pragma unroll 1
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T qi = q[i];
    // NaN gives n-2, as lower_index (the tree's compares would all be false)
    idx_out[i] = qi == qi ? clamp_index(staged_count<kWhole>(tree, h, c, w, n, knot, qi), n)
                          : n - 2;
  }
}

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

// K1 on the staged tree: knot j w, j < c, in h levels of shared memory
// (kWhole: w = 1, the whole axis); with kRowShared the rows' six columns
// follow the tree, 6 (n - 1) elements
template <typename T, bool kWhole, int kRead>
__global__ void __launch_bounds__(kSearchThreads)
    staged_eval1d_kernel(const T* __restrict__ knots, int n, int64_t w, int c, int h,
                         const T* __restrict__ tbl, int64_t ch, const T* __restrict__ q,
                         T* __restrict__ out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tree = reinterpret_cast<T*>(smem);
  T* rows = tree + (1 << h);
  const auto knot = [&](int64_t m) { return __ldg(knots + m); };
  stage_tree(tree, knot, w, c, h);
  if (kRead == kRowShared) {
    for (int e = threadIdx.x; e < 6 * (n - 1); e += blockDim.x) {
      rows[e] = __ldg(tbl + (e / 6) * ch + e % 6);
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T qi = q[i];
    // NaN takes row n-2, as lower_index (the tree's compares would all be false)
    const int idx =
        qi == qi ? clamp_index(staged_count<kWhole>(tree, h, c, w, n, knot, qi), n) : n - 2;
    T v[6];
    load_row<T, kRead>(kRead == kRowShared ? rows + 6 * static_cast<int64_t>(idx)
                                           : tbl + idx * ch,
                       v);
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

inline unsigned int blocks_for(int64_t nq) {
  return static_cast<unsigned int>((nq + kThreads - 1) / kThreads);
}

template <typename T>
int index_frac(const void* knots, int64_t n, const void* q, void* idx, void* t,
               int64_t nq, void* stream) {
  if (nq > 0) {
    index_frac_kernel<T><<<blocks_for(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(knots), static_cast<int>(n), static_cast<const T*>(q),
        static_cast<int32_t*>(idx), static_cast<T*>(t), nq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWhole>
cudaError_t staged_lower_index(const T* knots, int n, int64_t w, const T* q, int32_t* idx,
                               int64_t nq, cudaStream_t s) {
  auto kernel = staged_lower_index_kernel<T, kWhole>;
  const int c = static_cast<int>((n + w - 1) / w);
  const int h = tree_levels(c);
  const size_t smem = (static_cast<size_t>(1) << h) * sizeof(T);
  const int threads = kWhole ? kSearchThreads : kSearchThreads / 2;
  unsigned int blocks = 0;
  const cudaError_t err = staged_grid(kernel, threads, smem, nq, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(knots, n, w, c, h, q, idx, nq);
  return cudaGetLastError();
}

template <typename T, bool kWhole, int kRead>
cudaError_t staged_eval1d(const T* knots, int n, int64_t w, const T* tbl, int64_t ch,
                          const T* q, T* out, int64_t nq, cudaStream_t s) {
  auto kernel = staged_eval1d_kernel<T, kWhole, kRead>;
  const int c = static_cast<int>((n + w - 1) / w);
  const int h = tree_levels(c);
  size_t smem = (static_cast<size_t>(1) << h) * sizeof(T);
  if (kRead == kRowShared) smem += 6 * static_cast<size_t>(n - 1) * sizeof(T);
  const int threads = kWhole ? kSearchThreads : kSearchThreads / 2;
  unsigned int blocks = 0;
  const cudaError_t err = staged_grid(kernel, threads, smem, nq, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(knots, n, w, c, h, tbl, ch, q, out, nq);
  return cudaGetLastError();
}

// K1 on a tree of at most shared_knots knots (capped at the largest a block
// holds; at least 1), its rows read in the form row_read asks for where the
// table allows it: kRowWide where every row is 2-element aligned, else
// scalar; kRowShared where the tree is the whole axis, the tree and the rows
// fit a block and each block has at least as many queries as rows to stage
// (at 2,048 f64 knots the staging took 0.0061 ms against 0.0036 for 2
// queries), else as kRowWide
template <typename T>
int eval1d_launch(const void* knots, int64_t n, const void* tbl, int64_t ch,
                  int64_t shared_knots, int64_t row_read, const void* q, void* out, int64_t nq,
                  void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const T* k = static_cast<const T*>(knots);
  const T* tb = static_cast<const T*>(tbl);
  const T* qq = static_cast<const T*>(q);
  T* o = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  int64_t budget = 1;
  cudaError_t err = tree_budget(shared_knots, sizeof(T), &budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t w = (n + budget - 1) / budget;  // the stride between staged knots
  int optin = 0;
  err = block_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t tree_bytes = (static_cast<size_t>(1) << tree_levels((n + w - 1) / w)) * sizeof(T);
  const size_t smem = tree_bytes + 6 * static_cast<size_t>(n - 1) * sizeof(T);
  bool shared = row_read == kRowShared && w == 1 && smem <= static_cast<size_t>(optin);
  if (shared) {
    unsigned int blocks = 0;
    err = staged_grid(staged_eval1d_kernel<T, true, kRowShared>, kSearchThreads, smem, nq,
                      &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    shared = nq >= static_cast<int64_t>(blocks) * (n - 1);
  }
  const bool wide = row_read != kRowScalar && ch % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(tbl) % (2 * sizeof(T)) == 0;
  if (w == 1) {
    err = shared ? staged_eval1d<T, true, kRowShared>(k, nn, w, tb, ch, qq, o, nq, s)
          : wide ? staged_eval1d<T, true, kRowWide>(k, nn, w, tb, ch, qq, o, nq, s)
                 : staged_eval1d<T, true, kRowScalar>(k, nn, w, tb, ch, qq, o, nq, s);
  } else {
    err = wide ? staged_eval1d<T, false, kRowWide>(k, nn, w, tb, ch, qq, o, nq, s)
               : staged_eval1d<T, false, kRowScalar>(k, nn, w, tb, ch, qq, o, nq, s);
  }
  return static_cast<int>(err);
}

// K3 on a tree of at most shared_knots knots (capped at the largest a block
// holds; at least 1)
template <typename T>
int lower_index_launch(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                       void* idx, int64_t nq, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const T* k = static_cast<const T*>(knots);
  const T* qq = static_cast<const T*>(q);
  int32_t* ix = static_cast<int32_t*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  int64_t budget = 1;
  cudaError_t err = tree_budget(shared_knots, sizeof(T), &budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t w = (n + budget - 1) / budget;  // the stride between staged knots
  err = w == 1 ? staged_lower_index<T, true>(k, nn, w, qq, ix, nq, s)
               : staged_lower_index<T, false>(k, nn, w, qq, ix, nq, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// K1: knots, n, tbl, ch, shared_knots (the most knots a block stages; 1: every
// level of the search on the global axis), row_read (RowRead), q, out, nq
int ndi_eval1d_f32(const void* knots, int64_t n, const void* tbl, int64_t ch,
                   int64_t shared_knots, int64_t row_read, const void* q, void* out, int64_t nq,
                   void* stream) {
  return eval1d_launch<float>(knots, n, tbl, ch, shared_knots, row_read, q, out, nq, stream);
}

int ndi_eval1d_f64(const void* knots, int64_t n, const void* tbl, int64_t ch,
                   int64_t shared_knots, int64_t row_read, const void* q, void* out, int64_t nq,
                   void* stream) {
  return eval1d_launch<double>(knots, n, tbl, ch, shared_knots, row_read, q, out, nq, stream);
}

int ndi_index_frac_f32(const void* knots, int64_t n, const void* q, void* idx, void* t,
                       int64_t nq, void* stream) {
  return index_frac<float>(knots, n, q, idx, t, nq, stream);
}

int ndi_index_frac_f64(const void* knots, int64_t n, const void* q, void* idx, void* t,
                       int64_t nq, void* stream) {
  return index_frac<double>(knots, n, q, idx, t, nq, stream);
}

// K3: knots, n, shared_knots (the most knots a block stages; 1: every level of
// the search on the global axis), q, idx, nq
int ndi_lower_index_f32(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                        void* idx, int64_t nq, void* stream) {
  return lower_index_launch<float>(knots, n, shared_knots, q, idx, nq, stream);
}

int ndi_lower_index_f64(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                        void* idx, int64_t nq, void* stream) {
  return lower_index_launch<double>(knots, n, shared_knots, q, idx, nq, stream);
}

const char* ndi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
