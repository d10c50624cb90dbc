// Double-float 1-D evaluation kernels for Hopper (sm_90a), in native FP64.
//
// K6  df_eval1d      replaces the Pallas kernel ndarray_interp_tpu/ops/pallas_eval_df.py
//                    _df_kernel (fused_eval_1d_df): search, symmetric Hermite form
//                    and the +-inf linear escape, for scalar data.
// K7  df_index_frac  replaces pallas_eval_df.py _df_index_kernel
//                    (fused_index_frac_df): the search emitting (idx, t_hi, t_lo).
// K8  df_bank_tail   replaces pallas_eval_df.py _df_tail_kernel (banked_df_tail):
//                    the Hermite form on packed (hi, lo) bank rows.
// K9  f48_bank_tail  replaces pallas_eval_df.py _f48_bank_tail_kernel
//                    (banked_f48_tail): the same on rows whose lo half is packed
//                    as bf16 pairs.
//
// Every value crosses the interface as an (hi, lo) float32 pair, as in the JAX
// package.  The TPU has no float64, so its kernels carried every operation
// through error-free transforms on float32 (about 180 vector operations for one
// Hermite form) and fetched rows with one-hot matrix products.  Hopper has
// native FP64: each kernel widens every pair once, (double)hi + (double)lo,
// which is exact for pairs that df_from_f64 made (24 + 24 significant bits fit
// in 53), computes in double in the JAX package's operation order, and splits
// the result back into a pair (hi = (float)r, lo = (float)(r - hi), lo = 0 where
// hi is not finite).  CUDA's double division is correctly rounded and the
// library is built with --fmad=false, so each kernel is bit-identical to its
// plain PyTorch float64 version in ops/eval_kernels_df.py.
//
// Search: the upper-bound binary search of K1-K3 on the widened knots.  For
// pairs made by rounding (df_from_f64), float64 order is the JAX package's
// lexicographic (hi, lo) order, so knots that collide in float32 are still told
// apart.  A NaN query gets index 0, as in both JAX double-float forms (the
// float32 K1-K3 give n-2).  There is no knot limit: the JAX package sends axes
// longer than its 65,536-knot window plan to XLA.
//
// K7 widens the knots once, into shared memory.  Searching the global pairs,
// every level costs two 4-byte loads from two arrays and two FP64 conversions
// (a quarter of the FP64 add rate), and below the first levels the 32 lanes of
// a warp read 32 different cache lines of each array.  Instead each block
// stages the knots widened to float64 in shared memory, in breadth-first
// order: the whole axis where it fits the budget the wrapper passes (the 2-D
// and N-D paths' 64 to 1,024 knots, the serving path's 10,240), else every
// w-th knot (the leaders), and then strides over many queries.  Then a level
// is one 8-byte shared load, a compare and a shift-add; beyond the budget the
// last log2(w) levels read the global pairs between two leaders.  The
// comparisons are those of the plain searchsorted on the same float64
// values, so the result does not depend on the budget.
//
// K6 searches K7's tree (the first design, a thread a query on
// df_lower_index, paid K7's old cost: at 4,096 knots 12 levels of two
// scattered 4-byte loads and two FP64 conversions each, then twelve scalar
// loads).  Its wrapper passes K7's budget; with the whole axis staged, x_l and
// x_r come from the tree's slots, and where the tree and the widened d, a and
// b fit a block and each block has as many queries as rows, the rows are
// widened once a block after the tree (4,096 knots: a 64 KB tree and 96 KB of
// rows).  The halves a, b of the linear escape and the hi halves of its
// float32 fraction are read only on a segment whose widened a and b are 0.
// K6 also has the float64 store form of df_common.cuh (out_lo null), which
// the scalar DoubleFloatEvaluator takes.  The first design stays at budget 0.
// On an H100 80GB HBM3 at 700 W (tools/search_phases.py, 2^20 queries): at
// 4,096 knots 0.0192 ms (rows from the global pairs 0.0240, the first design
// 0.0529; float64 store form 0.0193); past the whole tree the rows' scattered
// loads from the L2 bound it: 20,000 knots 0.0960 against 0.0999, 70,001
// 0.1143 against 0.1502.
//
// K8 and K9 write 8 bytes per (query, bank column) and read one packed row per
// query (8 or 6 floats per column): the output (537 MB at 1M queries x 64) is
// the memory bound.  The row gather is fused in: the gathered (Q, 8 bp)
// intermediate of the JAX route (2.1 GB at that shape) is never written.  In
// query order (small batches) a warp covers 32 neighbouring bank columns of one
// query's row, so the row loads and the output stores coalesce; the table (21
// MB DF, 16 MB f48 at 10,240 x 64) stays in the 50 MB L2.
//
// K8 and K9 at large batches.  In query order every query brings its whole row
// (2 KiB at bank 64) from the L2 and widens it again: 13 FP64 conversions a
// K8 result (K9: the same after unpacking the bf16 lo halves).  Above a batch
// size the wrapper first orders the queries by interval (csrc/cell_order.cu,
// its 1-D form) and runs bank_tail_ordered_kernel on the records: a lane
// widens its chunk of a row once for the run of records on it.  Both have the
// float64 store form of df_common.cuh on both paths (out_lo null), which the
// DoubleFloatEvaluator takes, so it no longer widens and adds the (Q, bank)
// pair itself.  The two tails differ only in their row layout (DfRows,
// F48Rows below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "df_common.cuh"
#include "search.cuh"  // upper_bound, clamp_index, the staged search (K7)

namespace {

constexpr int kTailCols = 32;  // bank columns per block of K8/K9 (one warp)
constexpr int kTailRows = 8;   // queries per block of K8/K9

__device__ __forceinline__ double load_pair(const float* __restrict__ hi,
                                            const float* __restrict__ lo, int64_t i) {
  return widen(__ldg(hi + i), __ldg(lo + i));
}

// r as a pair, lo = 0 where hi is not finite (ops/df.py df_from_f64)
__device__ __forceinline__ void store_pair(double r, float* __restrict__ out_hi,
                                           float* __restrict__ out_lo, int64_t i) {
  store_split<1>(PairOut{out_hi, out_lo}, i, &r);
}

// count of knots <= q minus one, clamped to [0, n-2]; NaN gives 0
__device__ __forceinline__ int df_lower_index(const float* __restrict__ xh,
                                              const float* __restrict__ xl, int n, double q) {
  if (q != q) return 0;
  return clamp_index(upper_bound([&](int m) { return load_pair(xh, xl, m); }, 0, n, q), n);
}

// symmetric Hermite form, cubic_spline.rs:818-828 (pallas_eval_df.py:269-275)
__device__ __forceinline__ double hermite(double y_l, double y_r, double a, double b, double t) {
  const double omt = 1.0 - t;
  return (omt * y_l + t * y_r) + (t * omt) * (a * omt + b * t);
}

// a linear segment: a = b = 0, both halves
__device__ __forceinline__ bool linear_segment(float a_h, float a_l, float b_h, float b_l) {
  return a_h == 0.0f && a_l == 0.0f && b_h == 0.0f && b_l == 0.0f;
}

// The result pair (h, l), with the escape of pallas_eval_df.py:276-285: where
// the float32 fraction tn of the hi values is +-inf on a linear segment
// (a = b = 0), the float32 lerp of the hi values, l = 0 (the symmetric form
// gives inf - inf = NaN there).
__device__ __forceinline__ void bank_result(double base, float tn, float y_lh, float y_rh,
                                            bool linear, float& h, float& l) {
  if (isinf(tn) && linear) {
    h = y_lh + tn * (y_rh - y_lh);
    l = 0.0f;
  } else {
    h = static_cast<float>(base);
    l = split_lo(base, h);
  }
}

// -- K6 ------------------------------------------------------------------------------
inline unsigned int blocks_for(int64_t nq) {
  return static_cast<unsigned int>((nq + kThreads - 1) / kThreads);
}

// A scalar spline's pairs: knots x, data d (n), coefficients a, b (n - 1)
struct DfSpline {
  const float *xh, *xl, *dh, *dl, *ah, *al, *bh, *bl;
  int n;

  __device__ __forceinline__ double knot(int64_t m) const { return load_pair(xh, xl, m); }

  // the widened y_l, y_r, a, b of interval k from the global pairs
  __device__ __forceinline__ void row(int k, double v[4]) const {
    v[0] = load_pair(dh, dl, k);
    v[1] = load_pair(dh, dl, k + 1);
    v[2] = load_pair(ah, al, k);
    v[3] = load_pair(bh, bl, k);
  }

  // The rows widened once into shared memory: d at [0, n), a at [n, 2n - 1),
  // b at [2n - 1, 3n - 2); the caller synchronises the block after it
  __device__ __forceinline__ void stage_rows(double* rows) const {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      rows[e] = load_pair(dh, dl, e);
      if (e < n - 1) {
        rows[n + e] = load_pair(ah, al, e);
        rows[2 * n - 1 + e] = load_pair(bh, bl, e);
      }
    }
  }

  // The result pair of base, the Hermite form of interval k whose widened a
  // and b are a, b, at the query whose hi half is q_h: the escape of
  // bank_result on a linear segment.  Only a segment whose widened a and b
  // are 0 can be linear (both halves of each 0), so the halves are read only
  // there; the float32 fraction tn is taken of the knots' hi halves, as the
  // plain version takes it for any pair (the widened knots rounded to float32
  // equal them only for pairs that df_from_f64 made).
  __device__ __forceinline__ void result(double base, double a, double b, int k, float q_h,
                                         float& h, float& l) const {
    if (a == 0.0 && b == 0.0 &&
        linear_segment(__ldg(ah + k), __ldg(al + k), __ldg(bh + k), __ldg(bl + k))) {
      const float x_lh = __ldg(xh + k);
      const float x_rh = __ldg(xh + k + 1);
      bank_result(base, (q_h - x_lh) / (x_rh - x_lh), __ldg(dh + k), __ldg(dh + k + 1), true,
                  h, l);
    } else {
      h = static_cast<float>(base);
      l = split_lo(base, h);
    }
  }
};

// K6's first design (shared_knots = 0): a thread a query, df_lower_index on
// the global pairs, then the interval's twelve halves; the result in either
// store form
template <class Out>
__global__ void df_eval1d_kernel(DfSpline sp, const float* __restrict__ qh,
                                 const float* __restrict__ ql, Out out, int64_t nq) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= nq) return;
  const float q_h = qh[i];
  const double q = widen(q_h, ql[i]);
  const int k = df_lower_index(sp.xh, sp.xl, sp.n, q);
  const float x_lh = __ldg(sp.xh + k);
  const float x_rh = __ldg(sp.xh + k + 1);
  const float y_lh = __ldg(sp.dh + k);
  const float y_rh = __ldg(sp.dh + k + 1);
  const float a_h = __ldg(sp.ah + k);
  const float a_l = __ldg(sp.al + k);
  const float b_h = __ldg(sp.bh + k);
  const float b_l = __ldg(sp.bl + k);
  const double x_l = widen(x_lh, __ldg(sp.xl + k));
  const double x_r = widen(x_rh, __ldg(sp.xl + k + 1));
  const double t = (q - x_l) / (x_r - x_l);
  const double base = hermite(widen(y_lh, __ldg(sp.dl + k)), widen(y_rh, __ldg(sp.dl + k + 1)),
                              widen(a_h, a_l), widen(b_h, b_l), t);
  const float tn = (q_h - x_lh) / (x_rh - x_lh);
  float h, l;
  bank_result(base, tn, y_lh, y_rh, linear_segment(a_h, a_l, b_h, b_l), h, l);
  out.template put<1>(i, &h, &l);
}

// K6 on K7's tree: the knots widened once a block into shared memory, knot
// j w, j < c, in h levels (kWhole: w = 1, the whole axis, and x_l, x_r read
// from the tree), with kRows also d, a and b widened after it; blocks stride
// over the queries.  The index is K7's (NaN gives 0); the arithmetic is the
// first design's in its order.
template <bool kWhole, bool kRows, class Out>
__global__ void __launch_bounds__(kSearchThreads)
    df_eval1d_staged_kernel(DfSpline sp, int64_t w, int c, int h, const float* __restrict__ qh,
                            const float* __restrict__ ql, Out out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* tree = reinterpret_cast<double*>(smem);
  double* rows = tree + (1 << h);
  const int n = sp.n;
  const auto knot = [&](int64_t m) { return sp.knot(m); };
  stage_tree(tree, knot, w, c, h);
  if (kRows) sp.stage_rows(rows);
  __syncthreads();
#pragma unroll 1
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float q_h = qh[i];
    const double q = widen(q_h, ql[i]);
    const int k = q == q ? clamp_index(staged_count<kWhole>(tree, h, c, w, n, knot, q), n) : 0;
    const double x_l = kWhole ? tree[slot_of_rank(k, h)] : sp.knot(k);
    const double x_r = kWhole ? tree[slot_of_rank(k + 1, h)] : sp.knot(k + 1);
    double v[4];
    if (kRows) {
      v[0] = rows[k];
      v[1] = rows[k + 1];
      v[2] = rows[n + k];
      v[3] = rows[2 * n - 1 + k];
    } else {
      sp.row(k, v);
    }
    const double base = hermite(v[0], v[1], v[2], v[3], (q - x_l) / (x_r - x_l));
    float hv, lv;
    sp.result(base, v[2], v[3], k, q_h, hv, lv);
    out.template put<1>(i, &hv, &lv);
  }
}

template <bool kWhole, bool kRows, class Out>
cudaError_t df_eval1d_staged(const DfSpline& sp, int64_t w, int c, const float* qh,
                             const float* ql, Out out, int64_t nq, cudaStream_t s) {
  auto kernel = df_eval1d_staged_kernel<kWhole, kRows, Out>;
  const int h = tree_levels(c);
  const size_t smem =
      ((static_cast<size_t>(1) << h) + (kRows ? 3 * static_cast<size_t>(sp.n) - 2 : 0)) *
      sizeof(double);
  const int threads = kWhole ? kSearchThreads : kSearchThreads / 2;
  unsigned int blocks = 0;
  const cudaError_t err = staged_grid(kernel, threads, smem, nq, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(sp, w, c, h, qh, ql, out, nq);
  return cudaGetLastError();
}

// K6 on a tree of at most shared_knots widened knots (capped at the largest a
// block holds; at least 1: every level on the global pairs); at shared_knots
// = 0 the first design.  Its rows are d, a and b widened once a block into
// shared memory after the tree where the tree is the whole axis, the tree and
// the rows fit a block and each block of the grid that fills the card has at
// least as many queries as rows to widen; else the interval's halves from the
// global pairs.  On an H100 80GB HBM3 at 700 W, 4,096 knots x 2^20 queries:
// 0.0192 ms with the rows in shared memory, 0.0240 with them read from the
// global pairs (equal at 20,000 and 70,001 knots, where only leaders fit).
template <class Out>
cudaError_t df_eval1d(const DfSpline& sp, int64_t shared_knots, const float* qh,
                      const float* ql, Out out, int64_t nq, cudaStream_t s) {
  if (shared_knots == 0) {
    df_eval1d_kernel<<<blocks_for(nq), kThreads, 0, s>>>(sp, qh, ql, out, nq);
    return cudaGetLastError();
  }
  int64_t budget = 1;
  cudaError_t err = tree_budget(shared_knots, sizeof(double), &budget);
  if (err != cudaSuccess) return err;
  const int64_t n = sp.n;
  const int64_t w = (n + budget - 1) / budget;  // the stride between staged knots
  const int c = static_cast<int>((n + w - 1) / w);
  if (w > 1) return df_eval1d_staged<false, false>(sp, w, c, qh, ql, out, nq, s);
  int optin = 0;
  err = block_optin(&optin);
  if (err != cudaSuccess) return err;
  const size_t smem = ((static_cast<size_t>(1) << tree_levels(c)) + 3 * n - 2) * sizeof(double);
  if (smem <= static_cast<size_t>(optin)) {
    unsigned int blocks = 0;
    err = staged_grid(df_eval1d_staged_kernel<true, true, Out>, kSearchThreads, smem, nq,
                      &blocks);
    if (err != cudaSuccess) return err;
    if (nq >= static_cast<int64_t>(blocks) * (n - 1))
      return df_eval1d_staged<true, true>(sp, w, c, qh, ql, out, nq, s);
  }
  return df_eval1d_staged<true, false>(sp, w, c, qh, ql, out, nq, s);
}

// -- K7 ------------------------------------------------------------------------------
// Threads a block (search.cuh's kSearchThreads, 1,024): a block that holds
// the whole axis (up to 128 KB) is alone on its SM, so it brings the warps; a
// leader search launches half as many, which at 70,001 knots took 0.053 ms
// against 0.070 with 1,024.

// Shared memory holds c widened knots, knot j w for j < c, as the tree of
// search.cuh.  kWhole (w = 1): the whole axis, and the search and x_l, x_r
// never touch global memory.  Else the leaders, and the search ends on the
// global pairs between two of them.
template <bool kWhole>
__global__ void __launch_bounds__(kSearchThreads)
    df_index_frac_kernel(const float* __restrict__ xh, const float* __restrict__ xl, int n,
                         int64_t w, int c, int h, const float* __restrict__ qh,
                         const float* __restrict__ ql, int32_t* __restrict__ idx_out,
                         float* __restrict__ t_hi, float* __restrict__ t_lo, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* lead = reinterpret_cast<double*>(smem);
  const auto knot = [&](int64_t m) { return load_pair(xh, xl, m); };
  stage_tree(lead, knot, w, c, h);
  __syncthreads();
  // one query at a time: unrolled, the loop takes more registers
#pragma unroll 1
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const double q = widen(qh[i], ql[i]);
    // NaN gives 0
    const int k = q == q ? clamp_index(staged_count<kWhole>(lead, h, c, w, n, knot, q), n) : 0;
    const double x_l = kWhole ? lead[slot_of_rank(k, h)] : knot(k);
    const double x_r = kWhole ? lead[slot_of_rank(k + 1, h)] : knot(k + 1);
    idx_out[i] = k;
    store_pair((q - x_l) / (x_r - x_l), t_hi, t_lo, i);
  }
}

template <bool kWhole>
cudaError_t df_index_frac(const float* xh, const float* xl, int n, int64_t w, const float* qh,
                          const float* ql, int32_t* idx, float* t_hi, float* t_lo, int64_t nq,
                          cudaStream_t s) {
  auto kernel = df_index_frac_kernel<kWhole>;
  const int c = static_cast<int>((n + w - 1) / w);
  const int h = tree_levels(c);
  const size_t smem = (static_cast<size_t>(1) << h) * sizeof(double);
  const int threads = kWhole ? kSearchThreads : kSearchThreads / 2;
  unsigned int blocks = 0;
  const cudaError_t err = staged_grid(kernel, threads, smem, nq, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(xh, xl, n, w, c, h, qh, ql, idx, t_hi, t_lo, nq);
  return cudaGetLastError();
}

// -- K8 and K9 ---------------------------------------------------------------------------
// The widened values of W columns of one interval row.
template <int W>
struct Widened {
  double y_l[W], y_r[W], a[W], b[W];
  float y_lh[W], y_rh[W];
  bool linear[W];

  __device__ __forceinline__ void set(int j, float ylh, float yll, float yrh, float yrl,
                                      float ah, float al, float bh, float bl) {
    y_l[j] = widen(ylh, yll);
    y_r[j] = widen(yrh, yrl);
    a[j] = widen(ah, al);
    b[j] = widen(bh, bl);
    y_lh[j] = ylh;
    y_rh[j] = yrh;
    linear[j] = linear_segment(ah, al, bh, bl);
  }

  // the result pair of column j at the fraction t = (t_h, t_l) widened
  __device__ __forceinline__ void eval(int j, double t, float t_h, float& h, float& l) const {
    bank_result(hermite(y_l[j], y_r[j], a[j], b[j], t), t_h, y_lh[j], y_rh[j], linear[j], h, l);
  }
};

// K8's rows: [y_l | y_r | a | b] hi blocks, then the same lo blocks, bp
// columns each (pack_bank_rows_df)
struct DfRows {
  static constexpr int kBlocks = 8;
  template <int W>
  __device__ __forceinline__ static void widen_row(const float* __restrict__ cr, int64_t bp,
                                                   Widened<W>& w) {
    float v[kBlocks][W];
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) Vec<W>::load(cr + i * bp, v[i]);
#pragma unroll
    for (int j = 0; j < W; ++j)
      w.set(j, v[0][j], v[4][j], v[1][j], v[5][j], v[2][j], v[6][j], v[3][j], v[7][j]);
  }
};

// K9's rows: the four hi blocks, then 2 bp packed lanes: lane c holds
// bf16(y_l_lo) in its high 16 bits and bf16(a_lo) in its low 16, lane bp + c
// bf16(y_r_lo) and bf16(b_lo) (pack_bank_rows_f48; _unpack_f48_lo inverts)
struct F48Rows {
  static constexpr int kBlocks = 6;
  template <int W>
  __device__ __forceinline__ static void widen_row(const float* __restrict__ cr, int64_t bp,
                                                   Widened<W>& w) {
    float v[kBlocks][W];
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) Vec<W>::load(cr + i * bp, v[i]);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const unsigned int left = __float_as_uint(v[4][j]);
      const unsigned int right = __float_as_uint(v[5][j]);
      w.set(j, v[0][j], __uint_as_float(left & 0xFFFF0000u), v[1][j],
            __uint_as_float(right & 0xFFFF0000u), v[2][j], __uint_as_float(left << 16),
            v[3][j], __uint_as_float(right << 16));
    }
  }
};

// The row of query qi in a table of `rows` rows of `ch` floats, offset to
// column c.  Indices come from K7 and lie in [0, rows); one outside is clamped
// so that a bad index cannot read outside the table (the plain version clamps
// the same way).
__device__ __forceinline__ const float* tail_row(const float* __restrict__ packed, int64_t rows,
                                                 int64_t ch, const int32_t* __restrict__ idx,
                                                 int64_t qi, int64_t c) {
  int64_t r = __ldg(idx + qi);
  r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  return packed + r * ch + c;
}

// K8 / K9 in query order: a thread a (query, column); the result in either
// store form (df_common.cuh)
template <class Rows, class Out>
__global__ void bank_tail_kernel(const float* __restrict__ packed, int64_t rows, int64_t ch,
                                 int64_t bp, int64_t bank, const int32_t* __restrict__ idx,
                                 const float* __restrict__ th, const float* __restrict__ tl,
                                 Out out, int64_t nq) {
  const int64_t qi = blockIdx.x * static_cast<int64_t>(kTailRows) + threadIdx.y;
  const int64_t c = blockIdx.y * static_cast<int64_t>(kTailCols) + threadIdx.x;
  if (qi >= nq || c >= bank) return;
  Widened<1> w;
  Rows::template widen_row<1>(tail_row(packed, rows, ch, idx, qi, c), bp, w);
  const float t_h = __ldg(th + qi);
  float h, l;
  w.eval(0, widen(t_h, __ldg(tl + qi)), t_h, h, l);
  out.template put<1>(qi * bank + c, &h, &l);
}

// K8 / K9 on queries ordered by interval: the 1-D records of cell_order.cu,
// [v, qid, t_hi, t_lo, 0, 0, 0, 0], v the interval clamped to the table as
// tail_row clamps it.  A warp takes 32 / L slots of L lanes, L = bank / W
// column chunks (at most 32); a slot takes kGroup consecutive records, each
// lane one chunk of each: float4 rows and outputs where bank % 4 == 0 and
// bp % 4 == 0 (the packers make bp a multiple of 8), one column a lane else.
// In interval order consecutive records mostly share their row, so a lane
// loads and widens its chunk of the row once for the run of records on it
// and evaluates each record from the widened values in registers.  What
// that saves is instructions, not bytes: the body in query order converts 10
// floats to double and back 3 a result (FP64 conversions run at a quarter of
// the FP64 add rate), 13 in all, and at 2^20 x 64 K8's takes as long on one
// row in L1 as on random rows.  Each element is computed by the operations
// of bank_tail_kernel in the same order.
constexpr int kGroup = 8;

template <class Rows, int W, class Out>
__global__ void __launch_bounds__(kThreads)
    bank_tail_ordered_kernel(const float* __restrict__ packed, int64_t ch, int64_t bp,
                             int64_t bank, const int4* __restrict__ rec, Out out, int64_t n) {
  const int64_t chunks = bank / W;
  const Slot s = slot_of(chunks, (n + kGroup - 1) / kGroup);
  if (!s.valid) return;
  const int64_t first = s.q * kGroup;
  const int64_t last = first + kGroup < n ? first + kGroup : n;
  for (int64_t k = s.sub; k < chunks; k += s.size) {
    int32_t row = -1;  // the row widened in w (rows are >= 0)
    Widened<W> w;
    for (int64_t q = first; q < last; ++q) {
      const int4 r = __ldg(rec + 2 * q);  // [v, qid, t_hi, t_lo]
      if (r.x != row) {
        row = r.x;
        Rows::template widen_row<W>(packed + static_cast<int64_t>(row) * ch + k * W, bp, w);
      }
      const float t_h = __int_as_float(r.z);
      const double t = widen(t_h, __int_as_float(r.w));
      float h[W], l[W];
#pragma unroll
      for (int j = 0; j < W; ++j) w.eval(j, t, t_h, h[j], l[j]);
      out.template put<W>(static_cast<int64_t>(r.y) * bank + k * W, h, l);
    }
  }
}

// the query-order tail in the store form out_lo selects (null: float64 in out_hi)
template <class Rows>
int bank_tail(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t bank,
              const void* idx, const void* th, const void* tl, void* out_hi, void* out_lo,
              int64_t nq, void* stream) {
  if (nq > 0 && bank > 0) {
    const float* p = static_cast<const float*>(packed);
    const int32_t* ix = static_cast<const int32_t*>(idx);
    const float* h = static_cast<const float*>(th);
    const float* l = static_cast<const float*>(tl);
    const dim3 grid(static_cast<unsigned int>((nq + kTailRows - 1) / kTailRows),
                    static_cast<unsigned int>((bank + kTailCols - 1) / kTailCols));
    const dim3 block(kTailCols, kTailRows);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (out_lo)
      bank_tail_kernel<Rows><<<grid, block, 0, s>>>(
          p, rows, ch, bp, bank, ix, h, l,
          PairOut{static_cast<float*>(out_hi), static_cast<float*>(out_lo)}, nq);
    else
      bank_tail_kernel<Rows><<<grid, block, 0, s>>>(p, rows, ch, bp, bank, ix, h, l,
                                                    F64Out{static_cast<double*>(out_hi)}, nq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Rows, int W, class Out>
void bank_tail_ordered_launch(const float* p, int64_t ch, int64_t bp, int64_t bank,
                              const int4* rec, Out out, int64_t nq, cudaStream_t s) {
  const unsigned int blocks = ordered_blocks(bank / W, (nq + kGroup - 1) / kGroup);
  bank_tail_ordered_kernel<Rows, W><<<blocks, kThreads, 0, s>>>(p, ch, bp, bank, rec, out, nq);
}

template <class Rows, class Out>
void bank_tail_ordered_form(const float* p, int64_t ch, int64_t bp, int64_t bank,
                            const int4* rec, Out out, int64_t nq, cudaStream_t s) {
  if (bank % 4 == 0 && bp % 4 == 0)  // 16-byte row blocks and output chunks
    bank_tail_ordered_launch<Rows, 4>(p, ch, bp, bank, rec, out, nq, s);
  else
    bank_tail_ordered_launch<Rows, 1>(p, ch, bp, bank, rec, out, nq, s);
}

template <class Rows>
int bank_tail_ordered(const void* packed, int64_t ch, int64_t bp, int64_t bank, const void* rec,
                      void* out_hi, void* out_lo, int64_t nq, void* stream) {
  if (nq > 0 && bank > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* p = static_cast<const float*>(packed);
    const int4* q = static_cast<const int4*>(rec);
    if (out_lo)
      bank_tail_ordered_form<Rows>(
          p, ch, bp, bank, q,
          PairOut{static_cast<float*>(out_hi), static_cast<float*>(out_lo)}, nq, s);
    else
      bank_tail_ordered_form<Rows>(p, ch, bp, bank, q, F64Out{static_cast<double*>(out_hi)},
                                   nq, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6: xh, xl, n, dh, dl, ah, al, bh, bl, shared_knots (the most widened
// knots a block stages; 1: every level on the global pairs; 0: the first
// design), qh, ql, out_hi, out_lo (null: the float64 store form, out_hi
// then float64), nq
int ndi_df_eval1d_f32(const void* xh, const void* xl, int64_t n, const void* dh, const void* dl,
                      const void* ah, const void* al, const void* bh, const void* bl,
                      int64_t shared_knots, const void* qh, const void* ql,
                      void* out_hi, void* out_lo, int64_t nq, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const DfSpline sp{f(xh), f(xl), f(dh), f(dl), f(ah), f(al), f(bh), f(bl), static_cast<int>(n)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_lo ? df_eval1d(sp, shared_knots, f(qh), f(ql),
                         PairOut{static_cast<float*>(out_hi), static_cast<float*>(out_lo)}, nq, s)
             : df_eval1d(sp, shared_knots, f(qh), f(ql),
                         F64Out{static_cast<double*>(out_hi)}, nq, s);
  return static_cast<int>(err);
}

// K7: xh, xl, n, shared_knots (the most widened knots a block stages), qh, ql,
// idx, t_hi, t_lo, nq
int ndi_df_index_frac_f32(const void* xh, const void* xl, int64_t n, int64_t shared_knots,
                          const void* qh, const void* ql, void* idx, void* t_hi, void* t_lo,
                          int64_t nq, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  int64_t budget = 1;
  cudaError_t err = tree_budget(shared_knots, sizeof(double), &budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t w = (n + budget - 1) / budget;  // the stride between staged knots
  const float* h = static_cast<const float*>(xh);
  const float* l = static_cast<const float*>(xl);
  const float* q_h = static_cast<const float*>(qh);
  const float* q_l = static_cast<const float*>(ql);
  int32_t* ix = static_cast<int32_t*>(idx);
  float* o_h = static_cast<float*>(t_hi);
  float* o_l = static_cast<float*>(t_lo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  err = w == 1 ? df_index_frac<true>(h, l, nn, w, q_h, q_l, ix, o_h, o_l, nq, s)
               : df_index_frac<false>(h, l, nn, w, q_h, q_l, ix, o_h, o_l, nq, s);
  return static_cast<int>(err);
}

// K8: out_lo null selects the float64 store form, out_hi then (nq, bank) float64
int ndi_df_bank_tail_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t bank,
                         const void* idx, const void* th, const void* tl, void* out_hi,
                         void* out_lo, int64_t nq, void* stream) {
  return bank_tail<DfRows>(packed, rows, ch, bp, bank, idx, th, tl, out_hi, out_lo, nq, stream);
}

// K8 on the 1-D records of cell_order.cu: packed, rows, ch, bp, bank, rec (nq, 8)
// int32, out_hi, out_lo (null: the float64 store form), nq
int ndi_df_bank_tail_ordered_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp,
                                 int64_t bank, const void* rec, void* out_hi, void* out_lo,
                                 int64_t nq, void* stream) {
  (void)rows;
  return bank_tail_ordered<DfRows>(packed, ch, bp, bank, rec, out_hi, out_lo, nq, stream);
}

// K9: the arguments of K8, on a pack_bank_rows_f48 table
int ndi_f48_bank_tail_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t bank,
                          const void* idx, const void* th, const void* tl, void* out_hi,
                          void* out_lo, int64_t nq, void* stream) {
  return bank_tail<F48Rows>(packed, rows, ch, bp, bank, idx, th, tl, out_hi, out_lo, nq, stream);
}

int ndi_f48_bank_tail_ordered_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp,
                                  int64_t bank, const void* rec, void* out_hi, void* out_lo,
                                  int64_t nq, void* stream) {
  (void)rows;
  return bank_tail_ordered<F48Rows>(packed, ch, bp, bank, rec, out_hi, out_lo, nq, stream);
}

}  // extern "C"
