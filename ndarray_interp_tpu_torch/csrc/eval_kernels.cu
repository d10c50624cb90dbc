// Interval search and 1-D evaluation kernels for Hopper (sm_90a).
//
// K1  eval1d       replaces the Pallas kernel ndarray_interp_tpu/ops/pallas_eval.py
//                  _kernel (fused_eval_1d): bucketize, interval fetch and the
//                  symmetric Hermite form, with the +-inf lerp of linear tables.
// K2  index_frac   replaces pallas_eval.py _frac_kernel (fused_index_frac):
//                  the search emitting (idx, t), K3's kernel with the fraction.
// K3  lower_index  replaces pallas_eval.py _index_kernel (fused_lower_index):
//                  the search emitting idx.
//
// What bounds them on this card: one query costs log2(n) dependent steps of
// the search plus, for K1, one 24- or 48-byte row of the interval table and 15
// operations.  The queries and results stream once (8 bytes a query for K1 in
// f32: 8 MB and 0.0024 ms at 1M queries), so the kernels are bound by the
// loads of the search and the row, not by device memory.
//
// All three search a copy of the axis staged in shared memory (search.cuh,
// StagedAxis): each block stages it once, in the kernel's type, as a
// breadth-first tree, and strides over the queries; a grid that fills the
// card once.  The whole axis up to the budget the wrapper passes (2,048 knots
// are 16 KB of tree in f32, 32 KB in f64), else every w-th knot as leaders
// with the last log2(w) levels on the global axis (a 65,536-knot f32 tree
// would be 512 KB).  At a budget of one knot the search runs every level on
// the global axis: the first design's search.  K3's tree beat it at every
// batch size measured, two queries included (0.0093 against 0.0179 ms at
// 2,048 knots x 1M f32, an H100 80GB HBM3 at 700 W).  K1 then reads its row
// in one of three forms the wrapper picks (RowRead, staged_eval1d.cuh, whose
// body R3 shares): six scalar loads, three 2-element loads where the table's
// base and width allow them, or from a copy of the table's six columns staged
// in shared memory beside the tree where both fit; the times that chose the
// wrapper's form are in ops/eval_kernels.py.  At 2,048 knots x 1M f32 queries
// K1 took 0.0124 ms against 0.0244 for the first design's search and six
// scalar loads (tools/search_phases.py); K3, the same search alone, took
// 0.0095 there.  Neither loading each thread's next query early (0.0124) nor
// two queries a thread with both walks in one loop (0.0122 against 0.0123 in
// one run) gained, so neither was kept.
//
// K2 is K3's kernel with the fraction (kFrac): t's endpoints come from the
// tree where it holds the whole axis (slot_of_rank), else from the axis, as
// R1's.  Its first design, a thread a query with every level on the global
// axis through the read-only path (lower_index), stays beside it (budget 0),
// because the tree does not pay everywhere K2 runs.  On an H100 80GB HBM3 at
// 700 W (tools/search_phases.py --sweeps, f32, ms; first design / 16 KB tree):
// 256 knots x 1M 0.0097 / 0.0090, 512 x 1M 0.0123 / 0.0097 (f64 0.0200 /
// 0.0106), 10,240 x 1M 0.0236 / 0.0162 (32 KB of leaders 0.0181, 64 KB whole
// 0.0159), but 64 x 1M 0.0075 / 0.0081 (a 256-byte axis, whose two lines the
// L1 serves as fast as shared memory; f64's 512 bytes 0.0106 / 0.0088), and at
// the bank eval's 10,000 x 262,144 (26 queries a knot) 0.0073 / 0.0080 (32 KB
// 0.0106, 64 KB whole 0.0099): a block of one query a thread spends more on
// staging its tree than the search saves; at 70,001 x 1M 0.0280 against
// 0.0304-0.0397 for trees of 16-128 KB.  So the wrapper passes budget 0 below
// 64 queries a knot or on an axis of at most 256 bytes (ops/eval_kernels.py
// _k2_budget), a 16 KB tree else.
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

#include "search.cuh"         // lower_index (K2's first design), StagedAxis (K1-K3)
#include "staged_eval1d.cuh"  // K1's body on the staged search, its row forms
#include "staged_index.cuh"   // K2's and K3's staged kernel, which R3idx shares

namespace {

constexpr int kThreads = 256;

// K2's first design: one thread a query, lower_index on the global axis; the
// wrapper's choice where the tree does not pay (shared_knots = 0)
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

// K3 (t null) or K2 on a tree of at most shared_knots knots (capped at the
// largest a block holds; at least 1: every level on the global axis); K2 at
// shared_knots = 0 runs its first design
template <typename T, bool kFrac>
int index_launch(const void* knots, int64_t n, int64_t shared_knots, const void* q, void* idx,
                 void* t, int64_t nq, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const T* qq = static_cast<const T*>(q);
  int32_t* ix = static_cast<int32_t*>(idx);
  T* tt = static_cast<T*>(t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kFrac && shared_knots == 0) {
    const unsigned int blocks = static_cast<unsigned int>((nq + kThreads - 1) / kThreads);
    index_frac_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(knots),
                                                     static_cast<int>(n), qq, ix, tt, nq);
    return static_cast<int>(cudaGetLastError());
  }
  int64_t budget = 1;
  cudaError_t err = tree_budget(shared_knots, sizeof(T), &budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StagedAxis<T> ax = staged_axis<T>(knots, n, budget);
  err = ax.w == 1 ? staged_index<T, true, kFrac>(ax, qq, ix, tt, nq, s)
                  : staged_index<T, false, kFrac>(ax, qq, ix, tt, nq, s);
  return static_cast<int>(err);
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
  const T* tb = static_cast<const T*>(tbl);
  const T* qq = static_cast<const T*>(q);
  T* o = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t budget = 1;
  cudaError_t err = tree_budget(shared_knots, sizeof(T), &budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StagedAxis<T> ax = staged_axis<T>(knots, n, budget);
  int optin = 0;
  err = block_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  using Shared = TableRows<T, kRowShared>;
  const size_t smem = staged_eval1d_bytes<T, Shared>(ax);
  bool shared = row_read == kRowShared && ax.w == 1 && smem <= static_cast<size_t>(optin);
  if (shared) {
    unsigned int blocks = 0;
    err = staged_grid(staged_eval1d_kernel<T, true, Shared>, kSearchThreads, smem, nq, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    shared = nq >= static_cast<int64_t>(blocks) * (n - 1);
  }
  const bool wide = row_read != kRowScalar && ch % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(tbl) % (2 * sizeof(T)) == 0;
  const TableRows<T, kRowShared> in_shared{tb, ch, nullptr};
  const TableRows<T, kRowWide> in_pairs{tb, ch, nullptr};
  const TableRows<T, kRowScalar> in_scalars{tb, ch, nullptr};
  if (ax.w == 1) {
    err = shared ? staged_eval1d<T, true>(ax, in_shared, qq, o, nq, s)
          : wide ? staged_eval1d<T, true>(ax, in_pairs, qq, o, nq, s)
                 : staged_eval1d<T, true>(ax, in_scalars, qq, o, nq, s);
  } else {
    err = wide ? staged_eval1d<T, false>(ax, in_pairs, qq, o, nq, s)
               : staged_eval1d<T, false>(ax, in_scalars, qq, o, nq, s);
  }
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

// K2: knots, n, shared_knots (the most knots a block stages; 1: every level of
// the search on the global axis; 0: the first design), q, idx, t, nq
int ndi_index_frac_f32(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                       void* idx, void* t, int64_t nq, void* stream) {
  return index_launch<float, true>(knots, n, shared_knots, q, idx, t, nq, stream);
}

int ndi_index_frac_f64(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                       void* idx, void* t, int64_t nq, void* stream) {
  return index_launch<double, true>(knots, n, shared_knots, q, idx, t, nq, stream);
}

// K3: knots, n, shared_knots (the most knots a block stages; 1: every level of
// the search on the global axis), q, idx, nq
int ndi_lower_index_f32(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                        void* idx, int64_t nq, void* stream) {
  return index_launch<float, false>(knots, n, shared_knots, q, idx, nullptr, nq, stream);
}

int ndi_lower_index_f64(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                        void* idx, int64_t nq, void* stream) {
  return index_launch<double, false>(knots, n, shared_knots, q, idx, nullptr, nq, stream);
}

const char* ndi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
