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
// What bounds them on this card: one query costs log2(n) dependent loads of
// the knot axis plus, for K1, one 24- or 48-byte row of the interval table.
// The axis of a 2,048-knot spline is 8 KB (f32), so after the first queries
// every search step hits L1/L2 and the kernels are bound by the latency of
// that dependent chain, not by device memory; the queries and results stream
// once (8 bytes per query for K1 in f32).  K1 and K2 answer with plenty of
// independent work: one thread per query and enough blocks to fill all SMs,
// so the scheduler hides each thread's load chain behind other warps; the
// axis is read through the read-only path (__ldg).  Below the first levels
// the 32 lanes of a warp then read 32 different lines, which the first-level
// cache serves one at a time.
//
// K3 searches a copy of the axis staged in shared memory (search.cuh): each
// block stages it once, in the kernel's type, as a breadth-first tree, and
// strides over the queries; a grid that fills the card once.  The whole axis
// up to the budget the wrapper passes (2,048 knots are 16 KB of tree in f32,
// 32 KB in f64), else every w-th knot as leaders with the last log2(w) levels
// on the global axis (a 65,536-knot f32 tree would be 512 KB).  At a budget
// of one knot the search runs every level on the global axis, as K1's and
// K2's do (the first design's search; the tree beat it at every batch size
// measured, two queries included).
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

#include "search.cuh"  // lower_index, the staged search (K3)

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void eval1d_kernel(const T* __restrict__ knots, int n,
                              const T* __restrict__ tbl, int64_t ch,
                              const T* __restrict__ q, T* __restrict__ out,
                              int64_t nq) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= nq) return;
  const T qi = q[i];
  const T* row = tbl + lower_index(knots, n, qi) * ch;
  const T x_l = __ldg(row + 0);
  const T x_r = __ldg(row + 1);
  const T y_l = __ldg(row + 2);
  const T y_r = __ldg(row + 3);
  const T a = __ldg(row + 4);
  const T b = __ldg(row + 5);
  const T one = T(1);
  const T t = (qi - x_l) / (x_r - x_l);
  // symmetric Hermite form, cubic_spline.rs:818-828
  const T base = (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t);
  // a linear table (a = b = 0) extrapolates to +-inf like calc_frac
  // (linear.rs:29-37); the symmetric lerp would give inf - inf = NaN there
  const bool lin_inf = isinf(t) && a == T(0) && b == T(0);
  out[i] = lin_inf ? y_l + t * (y_r - y_l) : base;
}

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
constexpr int kSearchThreads = 1024;

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

inline unsigned int blocks_for(int64_t nq) {
  return static_cast<unsigned int>((nq + kThreads - 1) / kThreads);
}

template <typename T>
int eval1d(const void* knots, int64_t n, const void* tbl, int64_t ch, const void* q,
           void* out, int64_t nq, void* stream) {
  if (nq > 0) {
    eval1d_kernel<T><<<blocks_for(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(knots), static_cast<int>(n), static_cast<const T*>(tbl), ch,
        static_cast<const T*>(q), static_cast<T*>(out), nq);
  }
  return static_cast<int>(cudaGetLastError());
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

int ndi_eval1d_f32(const void* knots, int64_t n, const void* tbl, int64_t ch, const void* q,
                   void* out, int64_t nq, void* stream) {
  return eval1d<float>(knots, n, tbl, ch, q, out, nq, stream);
}

int ndi_eval1d_f64(const void* knots, int64_t n, const void* tbl, int64_t ch, const void* q,
                   void* out, int64_t nq, void* stream) {
  return eval1d<double>(knots, n, tbl, ch, q, out, nq, stream);
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
