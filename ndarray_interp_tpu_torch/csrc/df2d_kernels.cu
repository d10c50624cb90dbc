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
// result pair; the route slices it to the r channels.  Consecutive threads take
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
// K12 and K14 at large batches.  With queries in random order each query's
// row comes from HBM: ~2.1 GB for 1M queries, where the tables are 535 and
// 554 MB.  Above a batch size the wrappers first order the queries by cell
// (csrc/cell_order.cu) and run bicubic_ordered_kernel / node_ordered_kernel
// on the ordered records: several queries a warp, W = 4 channels a lane on
// float4 rows where the blocks allow it, the results written to each query's
// own slot.  Queries of one cell then share one fetch in a load instruction
// or through L1, and the sweep over the cells reads each row from HBM about
// once (K14's next x-column of nodes is reused from L2 one column later).
// Each element is computed by the same operations in the same order as in
// cell_tail_kernel<BicubicDF> and node_tail_kernel, so both paths are
// bit-identical to the plain versions.  K10, K11, K13 and R4c keep the
// unordered kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double widen(float hi, float lo) {
  return static_cast<double>(hi) + static_cast<double>(lo);
}

// r as a pair, lo = 0 where hi is not finite (ops/df.py df_from_f64)
__device__ __forceinline__ void store_pair(double r, float* __restrict__ out_hi,
                                           float* __restrict__ out_lo, int64_t i) {
  const float hi = static_cast<float>(r);
  out_hi[i] = hi;
  out_lo[i] = isfinite(hi) ? static_cast<float>(r - static_cast<double>(hi)) : 0.0f;
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

// _df_bicubic_tail on the 16 widened blocks v[4 i + c] (quantity i of
// [f, kx, ky, kxy], corner c of [11, 12, 21, 22])
__device__ __forceinline__ double bicubic(const double* v, double tx, double ty) {
  const double f_y1 = hermite_scaled(v[0], v[2], v[4], v[6], tx);
  const double f_y2 = hermite_scaled(v[1], v[3], v[5], v[7], tx);
  const double g_y1 = hermite_scaled(v[8], v[10], v[12], v[14], tx);
  const double g_y2 = hermite_scaled(v[9], v[11], v[13], v[15], tx);
  return hermite_scaled(f_y1, f_y2, g_y1, g_y2, ty);
}

// a row index clamped to the table, as the plain versions' gather clamps it
__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t rows) {
  return i < 0 ? 0 : (i >= rows ? rows - 1 : i);
}

// K10: [z11 | z12 | z21 | z22] hi blocks, then the same lo blocks
struct BilinearDF {
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    double z[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = widen(__ldg(row + j * bp), __ldg(row + (j + 4) * bp));
    return bilinear(z[0], z[1], z[2], z[3], tx, ty);
  }
};

// K11: four hi blocks, then 2 bp packed lanes: lane c holds z11_lo (high 16
// bits) and z21_lo (low 16), lane bp + c z12_lo and z22_lo
struct BilinearF48 {
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    const float first = __ldg(row + 4 * bp);
    const float second = __ldg(row + 5 * bp);
    return bilinear(widen(__ldg(row), lo_high(first)), widen(__ldg(row + bp), lo_high(second)),
                    widen(__ldg(row + 2 * bp), lo_low(first)),
                    widen(__ldg(row + 3 * bp), lo_low(second)), tx, ty);
  }
};

// K12: 16 hi blocks, then the 16 lo blocks
struct BicubicDF {
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    double v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) v[b] = widen(__ldg(row + b * bp), __ldg(row + (b + 16) * bp));
    return bicubic(v, tx, ty);
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

// R4c: the K12 row, in the weight form summed block by block.  The 16 weights
// are built per thread: the bp threads of a query repeat those ~40 operations.
struct BicubicWeightDF {
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    double bx[4], by[4];
    hermite_basis(tx, bx);
    hermite_basis(ty, by);
    double s = 0.0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int i = b >> 2, c = b & 3;
      // the value basis along x for f and ky, the derivative basis for kx and
      // kxy; along y the value basis for f and kx, the derivative basis else
      const double ax = (i == 0 || i == 2) ? bx[c >> 1] : bx[2 + (c >> 1)];
      const double ay = (i < 2) ? by[c & 1] : by[2 + (c & 1)];
      const double term = (ax * ay) * widen(__ldg(row + b * bp), __ldg(row + (b + 16) * bp));
      s = b == 0 ? term : s + term;
    }
    return s;
  }
};

// K13: 16 hi blocks, then 8 bp packed lanes: lane k bp + c holds lo block k in
// its high 16 bits and lo block k + 8 in its low 16
struct BicubicF48 {
  __device__ static double eval(const float* __restrict__ row, int64_t bp, double tx,
                                double ty) {
    double v[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float lane = __ldg(row + (16 + k) * bp);
      v[k] = widen(__ldg(row + k * bp), lo_high(lane));
      v[k + 8] = widen(__ldg(row + (k + 8) * bp), lo_low(lane));
    }
    return bicubic(v, tx, ty);
  }
};

// One thread per (query, channel) element e = qi bp + c of the (nq, bp) output.
// Indices come from K7 and address a cell of the table; a cell outside it is
// clamped so that a bad index cannot read outside the table (the plain versions
// clamp the same way).
template <class Tail>
__global__ void cell_tail_kernel(const float* __restrict__ packed, int64_t rows, int64_t ch,
                                 int64_t bp, const int32_t* __restrict__ xi,
                                 const int32_t* __restrict__ yi, int64_t ny1,
                                 const float* __restrict__ txh, const float* __restrict__ txl,
                                 const float* __restrict__ tyh, const float* __restrict__ tyl,
                                 float* __restrict__ out_hi, float* __restrict__ out_lo,
                                 int64_t n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t qi = e / bp;
  const int64_t c = e - qi * bp;
  const int64_t cell =
      clamp_row(static_cast<int64_t>(__ldg(xi + qi)) * ny1 + __ldg(yi + qi), rows);
  const double tx = widen(__ldg(txh + qi), __ldg(txl + qi));
  const double ty = widen(__ldg(tyh + qi), __ldg(tyl + qi));
  store_pair(Tail::eval(packed + cell * ch + c, bp, tx, ty), out_hi, out_lo, e);
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

// -- K12 and K14 on queries ordered by cell -------------------------------------------
// The records come from csrc/cell_order.cu in cell order, 32 bytes each:
// [v, qid, tx_hi, tx_lo, ty_hi, ty_lo, 0, 0] (the halves' bits), v the clamped
// cell (K12) or the base node clamped to [-(ny + 1), rows - 1] (K14).  A warp takes
// 32 / L queries of L lanes (L = the query's channel chunks, at most 32; the
// lanes past them idle), each lane W channels of one chunk at a time: float4
// rows where the blocks are 16-byte aligned (K12 at bp % 4 == 0, K14 at
// r % 4 == 0), one float else.  Neighbouring queries of one warp mostly share
// a cell, so one load instruction fetches their row once; the next warps, on
// the same and the next cells, find it in L1 or L2.  Each result goes to its
// query's own slot (qid, c), as the unordered kernels write it.

template <int W>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void load(const float* __restrict__ p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* __restrict__ p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<1> {
  __device__ static void load(const float* __restrict__ p, float* v) { v[0] = __ldg(p); }
  __device__ static void store(float* __restrict__ p, const float* v) { *p = v[0]; }
};

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

// store_pair of W results at element i
template <int W>
__device__ __forceinline__ void store_pair_w(const double* r, float* __restrict__ out_hi,
                                             float* __restrict__ out_lo, int64_t i) {
  float h[W], l[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    h[j] = static_cast<float>(r[j]);
    l[j] = isfinite(h[j]) ? static_cast<float>(r[j] - static_cast<double>(h[j])) : 0.0f;
  }
  Vec<W>::store(out_hi + i, h);
  Vec<W>::store(out_lo + i, l);
}

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

// This lane's query slot in its warp: record q (valid only below n and in
// the warp's 32 / size slots), lane `sub` of the `size` lanes that start at
// lane `leader`.
struct Slot {
  int64_t q;
  int sub, size, leader;
  bool valid;
};

__device__ __forceinline__ Slot slot_of(int64_t chunks, int64_t n) {
  Slot s;
  s.size = chunks < 32 ? static_cast<int>(chunks) : 32;
  const int per_warp = 32 / s.size;
  const int lane = threadIdx.x & 31;
  const int slot = lane / s.size;
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  s.q = warp * per_warp + slot;
  s.sub = lane - slot * s.size;
  s.leader = slot * s.size;
  s.valid = slot < per_warp && s.q < n;
  return s;
}

// _df_hermite_scaled of W channels at c from the (hi, lo) blocks a, b, c, d
// of a cell row: (y_l, y_r, K_l, K_r)
template <int W>
__device__ __forceinline__ void cell_hermite(const float* __restrict__ row, int64_t bp, int a,
                                             int b, int c, int d, double t, double* out) {
  double yl[W], yr[W], kl[W], kr[W];
  widen_w<W>(row + a * bp, row + (a + 16) * bp, yl);
  widen_w<W>(row + b * bp, row + (b + 16) * bp, yr);
  widen_w<W>(row + c * bp, row + (c + 16) * bp, kl);
  widen_w<W>(row + d * bp, row + (d + 16) * bp, kr);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = hermite_scaled(yl[j], yr[j], kl[j], kr[j], t);
}

// K12 on ordered records: BicubicDF's forms, four blocks at a time
template <int W>
__global__ void __launch_bounds__(kThreads)
    bicubic_ordered_kernel(const float* __restrict__ packed, int64_t ch, int64_t bp,
                           const int4* __restrict__ rec, float* __restrict__ out_hi,
                           float* __restrict__ out_lo, int64_t n) {
  const int64_t chunks = bp / W;
  const Slot s = slot_of(chunks, n);
  if (!s.valid) return;
  const Record q = record_at(rec, s.q);
  const double tx = q.tx, ty = q.ty;
  const float* row = packed + static_cast<int64_t>(q.v) * ch;
  for (int64_t k = s.sub; k < chunks; k += s.size) {
    const float* cr = row + k * W;
    double f1[W], f2[W], g1[W], g2[W], v[W];
    cell_hermite<W>(cr, bp, 0, 2, 4, 6, tx, f1);
    cell_hermite<W>(cr, bp, 1, 3, 5, 7, tx, f2);
    cell_hermite<W>(cr, bp, 8, 10, 12, 14, tx, g1);
    cell_hermite<W>(cr, bp, 9, 11, 13, 15, tx, g2);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = hermite_scaled(f1[j], f2[j], g1[j], g2[j], ty);
    store_pair_w<W>(v, out_hi, out_lo, static_cast<int64_t>(q.qid) * bp + k * W);
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
    store_pair_w<W>(v, out_hi, out_lo, static_cast<int64_t>(q.qid) * r + c);
  }
}

// the grid of an ordered kernel: whole warps of 32 / L queries each
inline unsigned int ordered_blocks(int64_t chunks, int64_t n) {
  const int64_t per_warp = 32 / (chunks < 32 ? chunks : 32);
  const int64_t warps = (n + per_warp - 1) / per_warp;
  return static_cast<unsigned int>((warps * 32 + kThreads - 1) / kThreads);
}

template <class Tail>
int launch(const void* packed, int64_t rows, int64_t ch, int64_t bp, const void* xi,
           const void* yi, int64_t ny1, const void* txh, const void* txl, const void* tyh,
           const void* tyl, void* out_hi, void* out_lo, int64_t nq, void* stream) {
  const int64_t n = nq * bp;
  if (n > 0) {
    const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
    cell_tail_kernel<Tail><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), rows, ch, bp, static_cast<const int32_t*>(xi),
        static_cast<const int32_t*>(yi), ny1, static_cast<const float*>(txh),
        static_cast<const float*>(txl), static_cast<const float*>(tyh),
        static_cast<const float*>(tyl), static_cast<float*>(out_hi),
        static_cast<float*>(out_lo), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define NDI_CELL_TAIL(name, Tail)                                                           \
  int name(const void* packed, int64_t rows, int64_t ch, int64_t bp, const void* xi,        \
           const void* yi, int64_t ny1, const void* txh, const void* txl, const void* tyh,  \
           const void* tyl, void* out_hi, void* out_lo, int64_t nq, void* stream) {         \
    return launch<Tail>(packed, rows, ch, bp, xi, yi, ny1, txh, txl, tyh, tyl, out_hi,     \
                        out_lo, nq, stream);                                                \
  }

NDI_CELL_TAIL(ndi_df_bilinear_tail_f32, BilinearDF)
NDI_CELL_TAIL(ndi_f48_bilinear_tail_f32, BilinearF48)
NDI_CELL_TAIL(ndi_df_bicubic_tail_f32, BicubicDF)
NDI_CELL_TAIL(ndi_df_bicubic_weight_tail_f32, BicubicWeightDF)
NDI_CELL_TAIL(ndi_f48_bicubic_tail_f32, BicubicF48)

#undef NDI_CELL_TAIL

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

// K12 and K14 on records of csrc/cell_order.cu: packed, rows, ch, bp (K12) or
// r (K14), ny, rec (nq, 8) int32, out_hi, out_lo, nq
int ndi_df_bicubic_tail_ordered_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp,
                                    int64_t ny, const void* rec, void* out_hi, void* out_lo,
                                    int64_t nq, void* stream) {
  (void)rows;
  (void)ny;
  if (nq > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* p = static_cast<const float*>(packed);
    const int4* q = static_cast<const int4*>(rec);
    float* oh = static_cast<float*>(out_hi);
    float* ol = static_cast<float*>(out_lo);
    if (bp % 4 == 0)
      bicubic_ordered_kernel<4><<<ordered_blocks(bp / 4, nq), kThreads, 0, s>>>(
          p, ch, bp, q, oh, ol, nq);
    else
      bicubic_ordered_kernel<1><<<ordered_blocks(bp, nq), kThreads, 0, s>>>(
          p, ch, bp, q, oh, ol, nq);
  }
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
