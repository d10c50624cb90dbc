// Double-float 2-D tail kernels for Hopper (sm_90a), in native FP64.
//
// K10 df_bilinear_tail   the lerp form of ndarray_interp_tpu/ops/pallas_eval_df.py
//                        _df_bilinear_core (:882) on the corner rows of a
//                        pack_bilinear_rows_df table.  It replaces the Pallas kernels
//                        _df_bilinear_mxu_kernel (:1027, bilinear_df_tail_mxu: the weight
//                        form on the TPU) and _df_bilinear_tail_kernel (:892,
//                        bilinear_df_tail, R4a: this form in this order).
// K11 f48_bilinear_tail  replaces pallas_eval_df.py _f48_bilinear_tail_kernel
//                        (bilinear_f48_tail): the same on rows whose lo half is packed as
//                        bf16 pairs (pack_bilinear_rows_f48).
// K12 df_bicubic_tail    the five nested Hermite forms of pallas_eval_df.py
//                        _df_bicubic_tail (:1355) on bicubic cell rows
//                        (pack_bicubic_rows_df).  It replaces _df_bicubic_mxu_kernel
//                        (:1571, bicubic_df_tail_mxu: a weight form summed in a halving
//                        tree on the TPU) and _df_bicubic_tail_kernel (:1378,
//                        bicubic_df_tail, R4b: this form in this order).
// K13 f48_bicubic_tail   replaces pallas_eval_df.py _f48_bicubic_mxu_kernel
//                        (bicubic_f48_tail): the same on bf16-pair lo halves
//                        (pack_bicubic_rows_f48).
// R4c df_bicubic_weight_tail  replaces ndarray_interp_tpu/ops/df_records.py
//                        _df_bicubic_weight_kernel (:159, bicubic_df_tail_w): the weight
//                        form of _df_bicubic_weight_tail, 16 tensor-product Hermite
//                        weights a query summed against the 16 cell-row blocks one block
//                        after another.
// K14 df_bicubic_node_tail  replaces pallas_eval_df.py _df_node_tail_kernel
//                        (bicubic_df_node_tail): the same Hermite forms from the four
//                        node rows of the memory-frugal node layout
//                        (pack_bicubic_nodes_df), the derivatives scaled in the tail.
//
// What each computes, not how the TPU computed it.  The TPU has no float64: its
// kernels built per-query weight rows with one-hot HIGHEST-precision matrix
// products, multiplied them into the rows with error-free two_prod and summed with
// a compensated halving tree.  Here each thread widens every (hi, lo) pair once,
// (double)hi + (double)lo (exact for pairs df_from_f64 made), and evaluates the
// JAX package's XLA form in double: bilinear as the lerp z1 + t (z2 - z1), along x
// at both y-knots, then along y (_df_bilinear_core); bicubic as five nested scaled
// Hermite forms, dy = y_r - y_l, a = K_l - dy, b = dy - K_r, u = 1 - t,
// (u y_l + t y_r) + (t u)(a u + b t) (_df_hermite_scaled, _df_bicubic_tail), or
// for R4c as the weights u = 1 - t, d = u - t, p = t u, pd = p d,
// [u + pd, t - pd, p u, -(p t)] per axis, W[4 i + c] = Ax[i][c >> 1] Ay[i][c & 1],
// s = W[0] v[0], s = s + W[b] v[b] (_df_bicubic_weights, _df_bicubic_weight_tail).
// The result is split back into a pair (lo = 0 where hi is not finite).  With
// --fmad=false each kernel is bit-identical to its plain PyTorch float64 version
// in ops/eval_kernels_df2d.py.
//
// Layout.  A kernel takes the packed table, the interval indices xi and yi of
// both axes (from K7), ny - 1 and the four fraction halves, and fetches the row
// of cell xi (ny-1) + yi itself: the (Q, 32 bp) gathered rows of the JAX route
// (2.1 GB at 2^20 queries x 16 channels) are never written.  It writes a (Q, bp)
// result, a pair or (K10, K11, K13) float64; the route slices it to the r
// channels.  Consecutive threads take
// consecutive (query, channel) elements, so each corner block of a row is read
// as bp contiguous floats (64 bytes at bp = 16) and the outputs are written
// contiguously.
//
// What bounds them on this card: bytes.  Per channel they read 8, 6, 32 or 24
// floats of the row and write 8 bytes, for about 11 (bilinear) or 70 (bicubic)
// FP64 operations: at 3.35 TB/s and 34 TFLOP/s the bytes take 10-20 times longer
// than the arithmetic.  The table (100-535 MB on a 512 x 512 x 16 grid) does not
// fit the 50 MB L2, so each query's row (0.4-2 KB) comes from HBM.
//
// K14 reads four node rows of 8 r + 4 floats a query (the nodes xi ny + yi, +1,
// +ny, +ny+1, each clamped to the table as the plain version clamps it), widens
// the pairs, takes dx and dy from the rows' coordinate pairs and scales the
// derivatives (k dx) before the same five Hermite forms (_df_node_tail).  It
// writes (Q, r): the node table has no padding.  The JAX route materialises the
// four gathered (Q, 8 r + 4) row arrays first (2.2 GB at 1M queries x 16
// channels); here they stay in registers.  Its table (8 r + 4 floats a node,
// about the grid's float64 memory) is a quarter of the DF cell table's, for
// four row fetches a query instead of one.
//
// K12, K13, K14 and R4c at large batches.  With queries in random order each
// query's row comes from HBM: ~2.1 GB (K13: 1.6 GB) for 1M queries, where the
// tables are 535, 401 and 554 MB.  Above a batch size the wrappers first order
// the queries by cell (csrc/cell_order.cu) and run bicubic_ordered_kernel
// (K12, generic over its row reader DFRows), cached_ordered_kernel (K13, R4c)
// or node_ordered_kernel on the ordered records: several queries a warp, W = 4
// channels a lane on float4 rows where the blocks allow it (K13, R4c: W = 2,
// each lane keeping its channels of the cell's blocks widened for the run of
// queries on the cell; R4c builds its 16 weights once a record), the results
// written to each query's own slot.  Queries of one cell then share one fetch
// in a load instruction or through L1, and the sweep over the cells reads
// each row from HBM about once (K14's next x-column of nodes is reused from
// L2 one column later).  Each element is computed by the same operations in
// the same order as in cell_tail_kernel and node_tail_kernel, so both paths
// are bit-identical to the plain versions.  At NS3d's 1M queries R4c takes
// 0.370 ms so, ordering included, against 0.705 in query order; K12's
// uncached body with the weight form (W = 4, weights once a record) took
// 0.488 (an H100 80GB HBM3 at 700 W).  K10 and K11 keep the unordered kernel:
// the bilinear rows (512 and 384 B at 16 channels) are too narrow for the
// ordering to pay.
//
// K10, K11 and K13 also have the float64 store form of df_common.cuh (out_lo
// null; K13 on both paths): DoubleFloatEvaluator2D takes it for Bilinear (both
// grades) and the f48 Bicubic cell layout, and no longer widens and adds the
// (Q, bp) pair itself.

#include <cuda_runtime.h>
#include <stdint.h>

#include "df_common.cuh"

namespace {

// r as a pair, lo = 0 where hi is not finite (ops/df.py df_from_f64)
__device__ __forceinline__ void store_pair(double r, float* __restrict__ out_hi,
                                           float* __restrict__ out_lo, int64_t i) {
  store_split<1>(PairOut{out_hi, out_lo}, i, &r);
}

// the two bf16 halves of a packed lo lane: high 16 bits, low 16 bits
__device__ __forceinline__ float lo_high(float lane) {
  return __uint_as_float(__float_as_uint(lane) & 0xFFFF0000u);
}
__device__ __forceinline__ float lo_low(float lane) {
  return __uint_as_float(__float_as_uint(lane) << 16);
}

// _df_bilinear_core: along x at both y-knots, then along y
__device__ __forceinline__ double bilinear(double z11, double z12, double z21, double z22,
                                           double tx, double ty) {
  const double zq1 = z11 + tx * (z21 - z11);
  const double zq2 = z12 + tx * (z22 - z12);
  return zq1 + ty * (zq2 - zq1);
}

// _df_hermite_scaled: the symmetric Hermite form with pre-scaled derivatives
__device__ __forceinline__ double hermite_scaled(double y_l, double y_r, double k_l, double k_r,
                                                 double t) {
  const double dy = y_r - y_l;
  const double a = k_l - dy;
  const double b = dy - k_r;
  const double u = 1.0 - t;
  return (u * y_l + t * y_r) + (t * u) * (a * u + b * t);
}

// a row index clamped to the table, as the plain versions' gather clamps it
__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t rows) {
  return i < 0 ? 0 : (i >= rows ? rows - 1 : i);
}

// W channels of a (hi, lo) block pair, widened
template <int W>
__device__ __forceinline__ void widen_w(const float* __restrict__ hi,
                                        const float* __restrict__ lo, double* out) {
  float h[W], l[W];
  Vec<W>::load(hi, h);
  Vec<W>::load(lo, l);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = widen(h[j], l[j]);
}

// The cell layouts of K10-K13 and R4c: a cell row holds kValues (hi, lo)
// blocks a channel.  all<W> widens W channels of every block into v, point
// turns a query's fractions into what at<W> takes (the fractions; R4c's 16
// weights), at<W> evaluates channel j of v there, and eval is one element in
// query order (cell_tail_kernel) by the same three; cached_ordered_kernel
// keeps v for the run of records on a cell (K13, R4c) and takes point once a
// record.
struct Fractions {
  double tx, ty;
};

struct BilinearForm {  // _df_bilinear_core on [z11, z12, z21, z22]
  static constexpr int kValues = 4;
  using Point = Fractions;
  __device__ __forceinline__ static Point point(double tx, double ty) { return {tx, ty}; }
  template <int W>
  __device__ __forceinline__ static double at(double (*z)[W], int j, const Point& p) {
    return bilinear(z[0][j], z[1][j], z[2][j], z[3][j], p.tx, p.ty);
  }
};

struct BicubicForm {  // _df_bicubic_tail on [f, kx, ky, kxy] x [11, 12, 21, 22]
  static constexpr int kValues = 16;
  using Point = Fractions;
  __device__ __forceinline__ static Point point(double tx, double ty) { return {tx, ty}; }
  template <int W>
  __device__ __forceinline__ static double at(double (*v)[W], int j, const Point& p) {
    const double f1 = hermite_scaled(v[0][j], v[2][j], v[4][j], v[6][j], p.tx);
    const double f2 = hermite_scaled(v[1][j], v[3][j], v[5][j], v[7][j], p.tx);
    const double g1 = hermite_scaled(v[8][j], v[10][j], v[12][j], v[14][j], p.tx);
    const double g2 = hermite_scaled(v[9][j], v[11][j], v[13][j], v[15][j], p.tx);
    return hermite_scaled(f1, f2, g1, g2, p.ty);
  }
};

// _df_hermite_basis: the weights of (y_l, y_r, K_l, K_r) at t
__device__ __forceinline__ void hermite_basis(double t, double* w) {
  const double u = 1.0 - t;
  const double d = u - t;
  const double p = t * u;
  const double pd = p * d;
  w[0] = u + pd;
  w[1] = t - pd;
  w[2] = p * u;
  w[3] = -(p * t);
}

// _df_bicubic_weights, _df_bicubic_weight_tail on the blocks of BicubicForm:
// W[4 i + c] = Ax[i][c >> 1] Ay[i][c & 1], the value basis along x for f and
// ky, the derivative basis for kx and kxy; along y the value basis for f and
// kx, the derivative basis else; then s = W[0] v[0], s = s + W[b] v[b]
struct BicubicWeightForm {
  static constexpr int kValues = 16;
  struct Point {
    double w[16];
  };
  // W[b] from the bases bx, by of tx, ty
  __device__ __forceinline__ static double weight(const double* bx, const double* by, int b) {
    const int i = b >> 2, c = b & 3;
    const double ax = (i == 0 || i == 2) ? bx[c >> 1] : bx[2 + (c >> 1)];
    const double ay = (i < 2) ? by[c & 1] : by[2 + (c & 1)];
    return ax * ay;
  }
  __device__ __forceinline__ static Point point(double tx, double ty) {
    double bx[4], by[4];
    hermite_basis(tx, bx);
    hermite_basis(ty, by);
    Point p;
#pragma unroll
    for (int b = 0; b < 16; ++b) p.w[b] = weight(bx, by, b);
    return p;
  }
  template <int W>
  __device__ __forceinline__ static double at(double (*v)[W], int j, const Point& p) {
    double s = 0.0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const double term = p.w[b] * v[b][j];
      s = b == 0 ? term : s + term;
    }
    return s;
  }
};

template <class Cell>
__device__ __forceinline__ double cached_eval(const float* __restrict__ row, int64_t bp,
                                              double tx, double ty) {
  double v[Cell::kValues][1];
  Cell::template all<1>(row, bp, v);
  return Cell::template at<1>(v, 0, Cell::point(tx, ty));
}

// K10: [z11 | z12 | z21 | z22] hi blocks, then the same lo blocks
struct BilinearDF : BilinearForm {
  template <int W>
  __device__ __forceinline__ static void all(const float* __restrict__ row, int64_t bp,
                                             double (*z)[W]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) widen_w<W>(row + i * bp, row + (i + 4) * bp, z[i]);
  }
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    return cached_eval<BilinearDF>(row, bp, tx, ty);
  }
};

// K11: four hi blocks, then 2 bp packed lanes: lane c holds z11_lo (high 16
// bits) and z21_lo (low 16), lane bp + c z12_lo and z22_lo
struct BilinearF48 : BilinearForm {
  template <int W>
  __device__ __forceinline__ static void all(const float* __restrict__ row, int64_t bp,
                                             double (*z)[W]) {
    float hi[4][W], first[W], second[W];
#pragma unroll
    for (int i = 0; i < 4; ++i) Vec<W>::load(row + i * bp, hi[i]);
    Vec<W>::load(row + 4 * bp, first);
    Vec<W>::load(row + 5 * bp, second);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      z[0][j] = widen(hi[0][j], lo_high(first[j]));
      z[1][j] = widen(hi[1][j], lo_high(second[j]));
      z[2][j] = widen(hi[2][j], lo_low(first[j]));
      z[3][j] = widen(hi[3][j], lo_low(second[j]));
    }
  }
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    return cached_eval<BilinearF48>(row, bp, tx, ty);
  }
};

// K12: 16 hi blocks, then the 16 lo blocks
struct BicubicDF : BicubicForm {
  template <int W>
  __device__ __forceinline__ static void all(const float* __restrict__ row, int64_t bp,
                                             double (*v)[W]) {
#pragma unroll
    for (int b = 0; b < 16; ++b) widen_w<W>(row + b * bp, row + (b + 16) * bp, v[b]);
  }
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    return cached_eval<BicubicDF>(row, bp, tx, ty);
  }
};

// R4c: the K12 row, in the weight form summed block by block.  In query order
// the 16 weights are built per thread (the bp threads of a query repeat those
// ~40 operations), each as the sum reaches its block; on ordered records
// they are built once a record (point).
struct BicubicWeightDF : BicubicWeightForm {
  template <int W>
  __device__ __forceinline__ static void all(const float* __restrict__ row, int64_t bp,
                                             double (*v)[W]) {
    BicubicDF::all<W>(row, bp, v);
  }
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    double bx[4], by[4];
    hermite_basis(tx, bx);
    hermite_basis(ty, by);
    double s = 0.0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const double term =
          weight(bx, by, b) * widen(__ldg(row + b * bp), __ldg(row + (b + 16) * bp));
      s = b == 0 ? term : s + term;
    }
    return s;
  }
};

// K13: 16 hi blocks, then 8 bp packed lanes: lane k bp + c holds lo block k in
// its high 16 bits and lo block k + 8 in its low 16; each packed lane is
// loaded once for its two blocks
struct BicubicF48 : BicubicForm {
  template <int W>
  __device__ __forceinline__ static void all(const float* __restrict__ row, int64_t bp,
                                             double (*v)[W]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float lo[W], hi0[W], hi8[W];
      Vec<W>::load(row + (16 + k) * bp, lo);
      Vec<W>::load(row + k * bp, hi0);
      Vec<W>::load(row + (k + 8) * bp, hi8);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        v[k][j] = widen(hi0[j], lo_high(lo[j]));
        v[k + 8][j] = widen(hi8[j], lo_low(lo[j]));
      }
    }
  }
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    return cached_eval<BicubicF48>(row, bp, tx, ty);
  }
};

// One thread per (query, channel) element e = qi bp + c of the (nq, bp) output,
// in either store form (df_common.cuh).  Indices come from K7 and address a
// cell of the table; a cell outside it is clamped so that a bad index cannot
// read outside the table (the plain versions clamp the same way).
template <class Tail, class Out>
__global__ void cell_tail_kernel(const float* __restrict__ packed, int64_t rows, int64_t ch,
                                 int64_t bp, const int32_t* __restrict__ xi,
                                 const int32_t* __restrict__ yi, int64_t ny1,
                                 const float* __restrict__ txh, const float* __restrict__ txl,
                                 const float* __restrict__ tyh, const float* __restrict__ tyl,
                                 Out out, int64_t n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t qi = e / bp;
  const int64_t c = e - qi * bp;
  const int64_t cell =
      clamp_row(static_cast<int64_t>(__ldg(xi + qi)) * ny1 + __ldg(yi + qi), rows);
  const double tx = widen(__ldg(txh + qi), __ldg(txl + qi));
  const double ty = widen(__ldg(tyh + qi), __ldg(tyl + qi));
  const double r = Tail::eval(packed + cell * ch + c, bp, tx, ty);
  store_split<1>(out, e, &r);
}

// quantity i of [f, kx, ky, kxy] at channel c of a block-interleaved node row
__device__ __forceinline__ double node_block(const float* __restrict__ g, int64_t r, int i,
                                             int64_t c) {
  return widen(__ldg(g + 2 * i * r + c), __ldg(g + (2 * i + 1) * r + c));
}

// coordinate j of [x, y] of a node row
__device__ __forceinline__ double node_coord(const float* __restrict__ g, int64_t r, int j) {
  return widen(__ldg(g + 8 * r + 2 * j), __ldg(g + 8 * r + 2 * j + 1));
}

// K14: one thread per (query, channel) element e = qi r + c of the (nq, r) output
__global__ void node_tail_kernel(const float* __restrict__ packed, int64_t rows, int64_t ch,
                                 int64_t r, const int32_t* __restrict__ xi,
                                 const int32_t* __restrict__ yi, int64_t ny,
                                 const float* __restrict__ txh, const float* __restrict__ txl,
                                 const float* __restrict__ tyh, const float* __restrict__ tyl,
                                 float* __restrict__ out_hi, float* __restrict__ out_lo,
                                 int64_t n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t qi = e / r;
  const int64_t c = e - qi * r;
  const int64_t base = static_cast<int64_t>(__ldg(xi + qi)) * ny + __ldg(yi + qi);
  const float* g11 = packed + clamp_row(base, rows) * ch;
  const float* g12 = packed + clamp_row(base + 1, rows) * ch;
  const float* g21 = packed + clamp_row(base + ny, rows) * ch;
  const float* g22 = packed + clamp_row(base + ny + 1, rows) * ch;
  const double dx = node_coord(g21, r, 0) - node_coord(g11, r, 0);
  const double dy = node_coord(g12, r, 1) - node_coord(g11, r, 1);
  const double tx = widen(__ldg(txh + qi), __ldg(txl + qi));
  const double ty = widen(__ldg(tyh + qi), __ldg(tyl + qi));
  const double f_y1 = hermite_scaled(node_block(g11, r, 0, c), node_block(g21, r, 0, c),
                                     node_block(g11, r, 1, c) * dx,
                                     node_block(g21, r, 1, c) * dx, tx);
  const double f_y2 = hermite_scaled(node_block(g12, r, 0, c), node_block(g22, r, 0, c),
                                     node_block(g12, r, 1, c) * dx,
                                     node_block(g22, r, 1, c) * dx, tx);
  const double g_y1 = hermite_scaled(node_block(g11, r, 2, c), node_block(g21, r, 2, c),
                                     node_block(g11, r, 3, c) * dx,
                                     node_block(g21, r, 3, c) * dx, tx);
  const double g_y2 = hermite_scaled(node_block(g12, r, 2, c), node_block(g22, r, 2, c),
                                     node_block(g12, r, 3, c) * dx,
                                     node_block(g22, r, 3, c) * dx, tx);
  store_pair(hermite_scaled(f_y1, f_y2, g_y1 * dy, g_y2 * dy, ty), out_hi, out_lo, e);
}

// -- K12, K13 and K14 on queries ordered by cell ---------------------------------------
// The records come from csrc/cell_order.cu in cell order, 32 bytes each:
// [v, qid, tx_hi, tx_lo, ty_hi, ty_lo, 0, 0] (the halves' bits), v the clamped
// cell (K12, K13) or the base node clamped to [-(ny + 1), rows - 1] (K14).  A warp
// takes 32 / L slots of L lanes (L = a query's channel chunks, at most 32; the
// lanes past them idle; slot_of in df_common.cuh), each slot one query (K13: 8
// consecutive ones), each lane W channels of one chunk at a time: float4 rows
// where the blocks are 16-byte aligned (K12 at bp % 4 == 0, K14 at r % 4 == 0;
// K13 float2 at bp % 2 == 0), one float else.  Neighbouring queries
// of one warp mostly share a cell, so one load instruction fetches their row
// once; the next warps, on the same and the next cells, find it in L1 or L2.
// Each result goes to its query's own slot (qid, c), as the unordered kernels
// write it.

// A record: the row value, the query's index and its two fractions, widened
struct Record {
  int32_t v, qid;
  double tx, ty;
};

__device__ __forceinline__ Record record_at(const int4* __restrict__ rec, int64_t q) {
  const int4 a = __ldg(rec + 2 * q);
  const int4 b = __ldg(rec + 2 * q + 1);
  return {a.x, a.y, widen(__int_as_float(a.z), __int_as_float(a.w)),
          widen(__int_as_float(b.x), __int_as_float(b.y))};
}

// K12's row reader: W channels of block b of [f, kx, ky, kxy] x [11, 12, 21,
// 22] of a cell row (the 16 hi blocks, then the 16 lo blocks), widened as
// BicubicDF widens them
struct DFRows {
  template <int W>
  __device__ __forceinline__ static void block(const float* __restrict__ row, int64_t bp, int b,
                                               double* out) {
    widen_w<W>(row + b * bp, row + (b + 16) * bp, out);
  }
};

// _df_hermite_scaled of W channels from the blocks a, b, c, d of a cell row:
// (y_l, y_r, K_l, K_r)
template <class Rows, int W>
__device__ __forceinline__ void cell_hermite(const float* __restrict__ row, int64_t bp, int a,
                                             int b, int c, int d, double t, double* out) {
  double yl[W], yr[W], kl[W], kr[W];
  Rows::template block<W>(row, bp, a, yl);
  Rows::template block<W>(row, bp, b, yr);
  Rows::template block<W>(row, bp, c, kl);
  Rows::template block<W>(row, bp, d, kr);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = hermite_scaled(yl[j], yr[j], kl[j], kr[j], t);
}

// K12 on ordered records (Rows = DFRows): the five forms of BicubicForm, four
// blocks at a time, each result in the store form Out
template <class Rows, int W, class Out>
__global__ void __launch_bounds__(kThreads)
    bicubic_ordered_kernel(const float* __restrict__ packed, int64_t ch, int64_t bp,
                           const int4* __restrict__ rec, Out out, int64_t n) {
  const int64_t chunks = bp / W;
  const Slot s = slot_of(chunks, n);
  if (!s.valid) return;
  const Record q = record_at(rec, s.q);
  const double tx = q.tx, ty = q.ty;
  const float* row = packed + static_cast<int64_t>(q.v) * ch;
  for (int64_t k = s.sub; k < chunks; k += s.size) {
    const float* cr = row + k * W;
    double f1[W], f2[W], g1[W], g2[W], v[W];
    cell_hermite<Rows, W>(cr, bp, 0, 2, 4, 6, tx, f1);
    cell_hermite<Rows, W>(cr, bp, 1, 3, 5, 7, tx, f2);
    cell_hermite<Rows, W>(cr, bp, 8, 10, 12, 14, tx, g1);
    cell_hermite<Rows, W>(cr, bp, 9, 11, 13, 15, tx, g2);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = hermite_scaled(f1[j], f2[j], g1[j], g2[j], ty);
    store_split<W>(out, static_cast<int64_t>(q.qid) * bp + k * W, v);
  }
}

// K13 on ordered records with a row cache (Cell = BicubicF48): a slot takes G
// consecutive records, and each lane keeps its W channels of the current
// cell's 16 blocks widened in registers, loading and widening them again only
// where the cell changes.  At NS3f's 1M queries over 261,121 cells ~3.8
// consecutive records share a cell, and widening is what the tail spends most
// on: 32 FP64 conversions a result (a quarter of the FP64 add rate) against 81
// adds and products.  Each result is Cell::at of the widened values, the form
// and order of the unordered tail's eval, in the store form Out.  W = 2 keeps
// the 32 widened values a lane holds in registers.
template <class Cell, int W, int G, class Out>
__global__ void __launch_bounds__(kThreads)
    cached_ordered_kernel(const float* __restrict__ packed, int64_t ch, int64_t bp,
                          const int4* __restrict__ rec, Out out, int64_t n) {
  const int64_t chunks = bp / W;
  const Slot s = slot_of(chunks, (n + G - 1) / G);
  if (!s.valid) return;
  const int64_t first = s.q * G;
  const int64_t last = first + G < n ? first + G : n;
  for (int64_t k = s.sub; k < chunks; k += s.size) {
    int32_t cell = -1;  // the cell widened in v (cells are >= 0)
    double v[Cell::kValues][W];
    for (int64_t i = first; i < last; ++i) {
      const Record q = record_at(rec, i);
      if (q.v != cell) {
        cell = q.v;
        Cell::template all<W>(packed + static_cast<int64_t>(cell) * ch + k * W, bp, v);
      }
      const typename Cell::Point p = Cell::point(q.tx, q.ty);
      double r[W];
#pragma unroll
      for (int j = 0; j < W; ++j) r[j] = Cell::template at<W>(v, j, p);
      store_split<W>(out, static_cast<int64_t>(q.qid) * bp + k * W, r);
    }
  }
}

// The Hermite form along x of quantities i (value) and i + 1 (its x
// derivative, scaled by dx) of W channels at c, between the node rows gl, gr
template <int W>
__device__ __forceinline__ void node_hermite(const float* __restrict__ gl,
                                             const float* __restrict__ gr, int64_t r, int64_t c,
                                             int i, double dx, double t, double* out) {
  double yl[W], yr[W], kl[W], kr[W];
  widen_w<W>(gl + 2 * i * r + c, gl + (2 * i + 1) * r + c, yl);
  widen_w<W>(gr + 2 * i * r + c, gr + (2 * i + 1) * r + c, yr);
  widen_w<W>(gl + (2 * i + 2) * r + c, gl + (2 * i + 3) * r + c, kl);
  widen_w<W>(gr + (2 * i + 2) * r + c, gr + (2 * i + 3) * r + c, kr);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = hermite_scaled(yl[j], yr[j], kl[j] * dx, kr[j] * dx, t);
}

// K14 on ordered records: the group's first lane reads the node coordinates
// and passes dx, dy to the others, once a query
template <int W>
__global__ void __launch_bounds__(kThreads)
    node_ordered_kernel(const float* __restrict__ packed, int64_t rows, int64_t ch, int64_t r,
                        int64_t ny, const int4* __restrict__ rec,
                        float* __restrict__ out_hi, float* __restrict__ out_lo, int64_t n) {
  const int64_t chunks = r / W;
  const Slot s = slot_of(chunks, n);
  const Record q = s.valid ? record_at(rec, s.q) : Record{0, 0, 0.0, 0.0};
  const int64_t base = q.v;
  const float* g11 = packed + clamp_row(base, rows) * ch;
  const float* g12 = packed + clamp_row(base + 1, rows) * ch;
  const float* g21 = packed + clamp_row(base + ny, rows) * ch;
  const float* g22 = packed + clamp_row(base + ny + 1, rows) * ch;
  double dx = 0.0, dy = 0.0;
  if (s.valid && s.sub == 0) {
    // [x_hi, x_lo, y_hi, y_lo] at 8 r: 16-byte aligned, since a row is 8 r + 4 floats
    const float4 c11 = __ldg(reinterpret_cast<const float4*>(g11 + 8 * r));
    const float2 x21 = __ldg(reinterpret_cast<const float2*>(g21 + 8 * r));
    const float2 y12 = __ldg(reinterpret_cast<const float2*>(g12 + 8 * r + 2));
    dx = widen(x21.x, x21.y) - widen(c11.x, c11.y);
    dy = widen(y12.x, y12.y) - widen(c11.z, c11.w);
  }
  dx = __shfl_sync(0xFFFFFFFFu, dx, s.leader);
  dy = __shfl_sync(0xFFFFFFFFu, dy, s.leader);
  if (!s.valid) return;
  const double tx = q.tx, ty = q.ty;
  for (int64_t k = s.sub; k < chunks; k += s.size) {
    const int64_t c = k * W;
    double f1[W], f2[W], g1[W], g2[W], v[W];
    node_hermite<W>(g11, g21, r, c, 0, dx, tx, f1);
    node_hermite<W>(g12, g22, r, c, 0, dx, tx, f2);
    node_hermite<W>(g11, g21, r, c, 2, dx, tx, g1);
    node_hermite<W>(g12, g22, r, c, 2, dx, tx, g2);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = hermite_scaled(f1[j], f2[j], g1[j] * dy, g2[j] * dy, ty);
    store_split<W>(PairOut{out_hi, out_lo}, static_cast<int64_t>(q.qid) * r + c, v);
  }
}

template <class Tail, class Out>
int launch(const void* packed, int64_t rows, int64_t ch, int64_t bp, const void* xi,
           const void* yi, int64_t ny1, const void* txh, const void* txl, const void* tyh,
           const void* tyl, Out out, int64_t nq, void* stream) {
  const int64_t n = nq * bp;
  if (n > 0) {
    const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
    cell_tail_kernel<Tail, Out><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), rows, ch, bp, static_cast<const int32_t*>(xi),
        static_cast<const int32_t*>(yi), ny1, static_cast<const float*>(txh),
        static_cast<const float*>(txl), static_cast<const float*>(tyh),
        static_cast<const float*>(tyl), out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kGroup = 8;  // consecutive records a slot of cached_ordered_kernel

template <class Cell, int W, class Out>
void cached_launch(const float* p, int64_t ch, int64_t bp, const int4* q, Out out, int64_t nq,
                   cudaStream_t s) {
  const int64_t groups = (nq + kGroup - 1) / kGroup;
  if (bp % W == 0)
    cached_ordered_kernel<Cell, W, kGroup><<<ordered_blocks(bp / W, groups), kThreads, 0, s>>>(
        p, ch, bp, q, out, nq);
  else
    cached_ordered_kernel<Cell, 1, kGroup><<<ordered_blocks(bp, groups), kThreads, 0, s>>>(
        p, ch, bp, q, out, nq);
}

// a cached tail on ordered records, W channels a lane where bp allows it; out_lo
// null selects the float64 store form, out_hi then (nq, bp) float64
template <class Cell, int W>
int cached_ordered(const void* packed, int64_t ch, int64_t bp, const void* rec, void* out_hi,
                   void* out_lo, int64_t nq, void* stream) {
  if (nq > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* p = static_cast<const float*>(packed);
    const int4* q = static_cast<const int4*>(rec);
    if (out_lo)
      cached_launch<Cell, W>(p, ch, bp, q,
                             PairOut{static_cast<float*>(out_hi), static_cast<float*>(out_lo)},
                             nq, s);
    else
      cached_launch<Cell, W>(p, ch, bp, q, F64Out{static_cast<double*>(out_hi)}, nq, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define NDI_CELL_TAIL(name, Tail)                                                           \
  int name(const void* packed, int64_t rows, int64_t ch, int64_t bp, const void* xi,        \
           const void* yi, int64_t ny1, const void* txh, const void* txl, const void* tyh,  \
           const void* tyl, void* out_hi, void* out_lo, int64_t nq, void* stream) {         \
    return launch<Tail>(packed, rows, ch, bp, xi, yi, ny1, txh, txl, tyh, tyl,             \
                        PairOut{static_cast<float*>(out_hi), static_cast<float*>(out_lo)},  \
                        nq, stream);                                                        \
  }

NDI_CELL_TAIL(ndi_df_bicubic_tail_f32, BicubicDF)
NDI_CELL_TAIL(ndi_df_bicubic_weight_tail_f32, BicubicWeightDF)

#undef NDI_CELL_TAIL

// K10, K11, K13: out_lo null selects the float64 store form, out_hi then (nq, bp)
// float64
#define NDI_CELL_TAIL_FORMS(name, Tail)                                                     \
  int name(const void* packed, int64_t rows, int64_t ch, int64_t bp, const void* xi,        \
           const void* yi, int64_t ny1, const void* txh, const void* txl, const void* tyh,  \
           const void* tyl, void* out_hi, void* out_lo, int64_t nq, void* stream) {         \
    if (out_lo)                                                                             \
      return launch<Tail>(packed, rows, ch, bp, xi, yi, ny1, txh, txl, tyh, tyl,           \
                          PairOut{static_cast<float*>(out_hi), static_cast<float*>(out_lo)}, \
                          nq, stream);                                                      \
    return launch<Tail>(packed, rows, ch, bp, xi, yi, ny1, txh, txl, tyh, tyl,             \
                        F64Out{static_cast<double*>(out_hi)}, nq, stream);                  \
  }

NDI_CELL_TAIL_FORMS(ndi_df_bilinear_tail_f32, BilinearDF)
NDI_CELL_TAIL_FORMS(ndi_f48_bilinear_tail_f32, BilinearF48)
NDI_CELL_TAIL_FORMS(ndi_f48_bicubic_tail_f32, BicubicF48)

#undef NDI_CELL_TAIL_FORMS

int ndi_df_bicubic_node_tail_f32(const void* packed, int64_t rows, int64_t ch, int64_t r,
                                 const void* xi, const void* yi, int64_t ny, const void* txh,
                                 const void* txl, const void* tyh, const void* tyl, void* out_hi,
                                 void* out_lo, int64_t nq, void* stream) {
  const int64_t n = nq * r;
  if (n > 0) {
    const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
    node_tail_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), rows, ch, r, static_cast<const int32_t*>(xi),
        static_cast<const int32_t*>(yi), ny, static_cast<const float*>(txh),
        static_cast<const float*>(txl), static_cast<const float*>(tyh),
        static_cast<const float*>(tyl), static_cast<float*>(out_hi),
        static_cast<float*>(out_lo), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K12 and K13 (and K14 below) on records of csrc/cell_order.cu: packed, rows,
// ch, bp (K12, K13) or r (K14), ny, rec (nq, 8) int32, out_hi, out_lo, nq
int ndi_df_bicubic_tail_ordered_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp,
                                    int64_t ny, const void* rec, void* out_hi, void* out_lo,
                                    int64_t nq, void* stream) {
  (void)rows;
  (void)ny;
  if (nq > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* p = static_cast<const float*>(packed);
    const int4* q = static_cast<const int4*>(rec);
    const PairOut out{static_cast<float*>(out_hi), static_cast<float*>(out_lo)};
    if (bp % 4 == 0)
      bicubic_ordered_kernel<DFRows, 4><<<ordered_blocks(bp / 4, nq), kThreads, 0, s>>>(
          p, ch, bp, q, out, nq);
    else
      bicubic_ordered_kernel<DFRows, 1><<<ordered_blocks(bp, nq), kThreads, 0, s>>>(
          p, ch, bp, q, out, nq);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13, the row cached: out_lo null selects the float64 store form, out_hi then
// (nq, bp) float64
int ndi_f48_bicubic_tail_ordered_f32(const void* packed, int64_t, int64_t ch, int64_t bp,
                                     int64_t, const void* rec, void* out_hi, void* out_lo,
                                     int64_t nq, void* stream) {
  return cached_ordered<BicubicF48, 2>(packed, ch, bp, rec, out_hi, out_lo, nq, stream);
}

// R4c on records of csrc/cell_order.cu, the row cached (the pair store form)
int ndi_df_bicubic_weight_tail_ordered_f32(const void* packed, int64_t, int64_t ch, int64_t bp,
                                           int64_t, const void* rec, void* out_hi,
                                           void* out_lo, int64_t nq, void* stream) {
  if (nq > 0)
    cached_launch<BicubicWeightDF, 2>(
        static_cast<const float*>(packed), ch, bp, static_cast<const int4*>(rec),
        PairOut{static_cast<float*>(out_hi), static_cast<float*>(out_lo)}, nq,
        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int ndi_df_bicubic_node_tail_ordered_f32(const void* packed, int64_t rows, int64_t ch,
                                         int64_t r, int64_t ny, const void* rec,
                                         void* out_hi, void* out_lo, int64_t nq,
                                         void* stream) {
  if (nq > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* p = static_cast<const float*>(packed);
    const int4* q = static_cast<const int4*>(rec);
    float* oh = static_cast<float*>(out_hi);
    float* ol = static_cast<float*>(out_lo);
    if (r % 4 == 0)
      node_ordered_kernel<4><<<ordered_blocks(r / 4, nq), kThreads, 0, s>>>(
          p, rows, ch, r, ny, q, oh, ol, nq);
    else
      node_ordered_kernel<1><<<ordered_blocks(r, nq), kThreads, 0, s>>>(
          p, rows, ch, r, ny, q, oh, ol, nq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
