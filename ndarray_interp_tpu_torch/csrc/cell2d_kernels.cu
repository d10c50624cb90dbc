// The f32/f64 2-D cell route for Hopper (sm_90a): the fused cell search and
// the tails on the grid and on the packed cell-row tables.
//
// R1   cell_index         replaces the Pallas kernel ndarray_interp_tpu/ops/pallas_eval.py
//                         _cell_kernel (fused_cell_index): both axis searches in one
//                         pass, emitting the flat cell xi * (ny - 1) + yi and the
//                         fractions tx, ty.
// R2b  bilinear_tail      replaces ndarray_interp_tpu/ops/pallas_tail.py _bilinear_kernel
//                         (bilinear_tail): three calc_frac lerps on the packed corner
//                         row [z11 | z12 | z21 | z22 | x1 x2 y1 y2] (width >= 4r + 4).
// R2g  bilinear_grid      R2b's function on the grid itself, (nx, ny, r) and the two
//                         axes: what the Bilinear route runs.
// R2c  bicubic seq tail   replaces pallas_tail.py _bicubic_weight_kernel
//                         (bicubic_weight_tail): the 16 tensor-product weights times the
//                         16 blocks of the cell row (width >= 16r), summed in order.
// R2d  bicubic tree tail  replaces pallas_tail.py _bicubic_mxu_kernel (bicubic_mxu_tail):
//                         the same products, summed by the halving tree (block b + b+8,
//                         then + b+4, b+2, b+1).
// R2n  bicubic nested     the nested scaled-Hermite order of the strategy's tail
//                         (models/strategies/bicubic.py _cell_tail_nested; XLA, not
//                         Pallas, in the JAX package): the order the Bicubic route takes.
// R2c, R2d and R2n share their forms (CellForm) and, on records ordered by cell,
// one kernel (cell_tail_ordered_kernel); in query order R2c and R2d run on R2b's
// lanes (cell_tail_kernel), R2n a thread an element (nested_tail_kernel).
//
// What the TPU kernels did and these do not.  R1's Pallas body searched a
// two-level window with one-hot bf16 split matrix products (_axis_search); here
// each block stages both axes once in shared memory, each as K3's breadth-first
// tree (search.cuh), and a thread walks both trees in one loop and reads the two
// endpoints of each axis from its tree.  The Pallas tails took rows that XLA had
// already gathered, so the gathered (Q, 4r + 4) or (Q, 16r) intermediate was
// written and read again; here each thread fetches its own row from the packed
// table, as K8-K14 and R2a do, so that intermediate never exists.  The
// corner-row table itself was a TPU device: a gather a query was the cost there,
// so one row held all a query needed.  Here R2g reads the grid, which the L2
// holds, where the table (four times the grid) does not fit it.  R2d's one-hot
// MXU build of the weight row (exact at Precision.HIGHEST) was a TPU relayout
// trick: here each weight is the one product Ax * Ay it stands for.  Neither the
// TPU's block multiples of the query count nor its r % 8 == 0 apply.
//
// What bounds them on this card.  R1 reads 8 bytes a query and writes 12 (f32):
// 20 MB and 0.0060 ms at 1M queries.  Its two searches of 10 levels on NS3's
// 512-knot axes are shared-memory loads at addresses that spread over the banks
// below the fifth level: 0.0152 ms at NS3's 1M queries (an H100 80GB HBM3 at
// 700 W, tools/search_phases.py), against 0.0266 with every level on the global
// axes (the first design's search, at a budget of one knot) and 0.0171 with the
// two searches one after the other and no query loaded early.  Keeping the last
// knot <= q and > q of each walk in registers, to spare the four endpoint loads,
// took 0.0176: two more selects a level cost more than the loads.
//
// The tails write 4r bytes a query (f32).  R2b reads one corner row a query at
// an address the cell selects, 272 B at r = 16: 272 MB at 1M queries from a
// 71 MB table at 512 x 512 x 16, past the 50 MB L2.  R2g reads the same values from
// the 16.8 MB grid, two runs of 2r contiguous values (data[xi, yi:yi+2],
// data[xi+1, yi:yi+2]) and four axis values, all from L2; only the cells,
// queries and outputs (76 MB) cross HBM.  At NS3's 1M queries (an H100 80GB HBM3
// at 700 W, tools/tail2d_phases.py): R2g 0.0562 ms, R2b on 16-byte lanes 0.0994
// (its row-read floor 0.104), a channel a lane 0.1215, the first design (a
// thread an element, a 64-bit division each) 0.1281; on a 2048 x 2048 x 16 grid
// past the L2, R2g 0.1212 against R2b's 0.1384.  Both take W channels a lane
// with 16-byte loads and stores (f32 4, f64 2) where r and the base allow them,
// one channel a lane else, up to 32 lanes a query and as many queries as fill a
// block: no per-element division.
//
// R2c, R2d and R2n read a 1 KiB cell row a query (r = 16, f32): 1.07 GB at 1M
// queries from a 267 MB table.  In query order each query's row comes from HBM:
// at NS3b (an H100 80GB HBM3 at 700 W, tools/tail2d_phases.py) R2c 0.3212 ms,
// R2d 0.3334, R2n 0.3240 against the row-read floor 0.3284; the first design (a
// thread an element, the 16 weights built again for each, a 64-bit division)
// read 0.3268 / 0.3297 / 0.3316.  Above a batch size (eval_kernels_df2d._orders,
// K12's rule) the wrapper first orders the queries by cell (cell_order.cu's
// flat-cell form, 0.058) and runs cell_tail_ordered_kernel on the records: R2c
// 0.1329 alone, 0.1936 with the ordering; R2d 0.1527 / 0.2134; R2n 0.1339 /
// 0.1947.  The weight forms build their 16 weights once a record (a lane) and
// spend 16 products and 15 adds a channel.  Their registers bound them: without
// a register target ptxas gave the block-order sum 32 registers, which
// serialised its loads (R2c 0.3632 in query order, 0.5453 ordered in f64), and
// the halving tree 88, two blocks an SM (R2d ordered 0.1933); min_blocks below
// sets the target.  R2n's form on the lanes read 3% slower than a thread an
// element at 2^17 queries, so R2n keeps that body in query order.  A lane keeping
// its channels of a cell's 16 blocks for the run of records on the cell (K13's
// row cache, 8 records a slot) took 0.2203 for R2n against 0.2198 without it: in
// f32 nothing is widened, so it saved loads the L1 already served.
//
// Numerics: every form is written in its plain PyTorch version's operation order
// (ops/eval_kernels.py _cell_index_plain, ops/tail2d.py _bilinear_plain,
// _bilinear_grid_plain, _bicubic_weight_plain, _bicubic_tree_plain,
// _cell_tail_nested) and the library is compiled with --fmad=false, so each
// kernel is bit-identical to its plain version, and R2g to R2b on the corner
// rows of its grid (the strategy packs them only where the axes' dtype is the
// data's, so the endpoints are the same values).  R1's index is K3's and its
// fractions K2's.  A cell outside the table is clamped, as the plain versions
// clamp it, so a bad cell cannot read outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

#include "df_common.cuh"  // kThreads, Vec, wide_lanes, lane_grid, Slot, slot_of, ordered_blocks
#include "search.cuh"     // the staged search, StagedAxis (R1)

namespace {

enum Order { kSeq = 0, kTree = 1, kNested = 2 };

__device__ __forceinline__ int64_t clamp_cell(int64_t c, int64_t rows) {
  return c < 0 ? 0 : (c >= rows ? rows - 1 : c);
}
// calc_frac (linear.rs:29-37): m = (y2 - y1) / (x2 - x1); m * (x - x1) + y1
template <typename T>
__device__ __forceinline__ T calc_frac(T x1, T y1, T x2, T y2, T x) {
  const T m = (y2 - y1) / (x2 - x1);
  return m * (x - x1) + y1;
}

// the symmetric Hermite form with pre-scaled derivatives K = k * dx
// (bicubic._hermite_scaled)
template <typename T>
__device__ __forceinline__ T hermite_scaled(T y_l, T y_r, T k_l, T k_r, T t) {
  const T one = T(1);
  const T dy = y_r - y_l;
  const T a = k_l - dy;
  const T b = dy - k_r;
  return (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t);
}

// the scaled-Hermite weights (w_yl, w_yr, w_Kl, w_Kr) of t
// (pallas_tail._bicubic_basis): u + p d, t - p d, p u, -(p t)
template <typename T>
__device__ __forceinline__ void basis(T t, T w[4]) {
  const T u = T(1) - t;
  const T p = t * u;
  const T pd = p * (u - t);
  w[0] = u + pd;
  w[1] = t - pd;
  w[2] = p * u;
  w[3] = -(p * t);
}

// R1 on two staged trees of h levels each, x's then y's in the block's shared
// memory (kWhole: both hold their whole axis).  Both searches step down their
// trees in one loop, two independent shared loads a level, and each thread
// loads its next queries before it searches the present ones.
template <typename T, bool kWhole>
__global__ void __launch_bounds__(kSearchThreads)
    staged_cell_index_kernel(StagedAxis<T> ax, StagedAxis<T> ay, int h,
                             const T* __restrict__ qx, const T* __restrict__ qy,
                             int32_t* __restrict__ cell, T* __restrict__ tx,
                             T* __restrict__ ty, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  ax.tree = reinterpret_cast<T*>(smem);
  ay.tree = ax.tree + (1 << h);
  ax.stage(h);
  ay.stage(h);
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  T qxi = i < nq ? qx[i] : T(0);
  T qyi = i < nq ? qy[i] : T(0);
#pragma unroll 1
  for (; i < nq; i += stride) {
    const bool more = i + stride < nq;
    const T qx_next = more ? qx[i + stride] : T(0);
    const T qy_next = more ? qy[i + stride] : T(0);
    int sx = 1, sy = 1;
    for (int l = 0; l < h; ++l) {
      sx = 2 * sx + (ax.tree[sx] <= qxi);
      sy = 2 * sy + (ay.tree[sy] <= qyi);
    }
    const int xi = ax.template index<kWhole>(sx, h, qxi);
    const int yi = ay.template index<kWhole>(sy, h, qyi);
    cell[i] = xi * (ay.n - 1) + yi;  // < 2^31: the wrapper checks the cell count
    tx[i] = ax.template frac<kWhole>(qxi, xi, h);
    ty[i] = ay.template frac<kWhole>(qyi, yi, h);
    qxi = qx_next;
    qyi = qy_next;
  }
}

// A (query, channel chunk) lane of the tails on W-wide lanes: threadIdx.y the
// query of the block, threadIdx.x its chunk; q < 0 past the batch or the row
struct Lane {
  int64_t q, c;
};

template <int W>
__device__ __forceinline__ Lane lane_of(int64_t r, int64_t nq) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.y) + threadIdx.y;
  const int64_t c = (blockIdx.y * static_cast<int64_t>(blockDim.x) + threadIdx.x) * W;
  return {q < nq && c < r ? q : -1, c};
}

// the three lerps of bilinear.rs:88-97 on W channels: along x at both
// y-knots, then along y
template <typename T, int W>
__device__ __forceinline__ void bilinear_lerps(const T* z11, const T* z12, const T* z21,
                                               const T* z22, T x1, T x2, T y1, T y2, T xq,
                                               T yq, T* out) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const T z1 = calc_frac(x1, z11[j], x2, z21[j], xq);
    const T z2 = calc_frac(x1, z12[j], x2, z22[j], xq);
    out[j] = calc_frac(y1, z1, y2, z2, yq);
  }
}

// R2b on the corner rows.  tbl (rows, ch), ch >= 4r + 4: [z11 | z12 | z21 | z22
// | x1 x2 y1 y2]; out (nq, r).  A lane takes W channels of one query.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    bilinear_rows_kernel(const T* __restrict__ tbl, int64_t rows, int64_t ch, int64_t r,
                         const int32_t* __restrict__ cell, const T* __restrict__ qx,
                         const T* __restrict__ qy, T* __restrict__ out, int64_t nq) {
  const Lane l = lane_of<W>(r, nq);
  if (l.q < 0) return;
  const T* row = tbl + clamp_cell(__ldg(cell + l.q), rows) * ch;
  T z11[W], z12[W], z21[W], z22[W], o[W];
  Vec<W>::load(row + l.c, z11);
  Vec<W>::load(row + r + l.c, z12);
  Vec<W>::load(row + 2 * r + l.c, z21);
  Vec<W>::load(row + 3 * r + l.c, z22);
  const T* ends = row + 4 * r;
  bilinear_lerps<T, W>(z11, z12, z21, z22, __ldg(ends), __ldg(ends + 1), __ldg(ends + 2),
                       __ldg(ends + 3), __ldg(qx + l.q), __ldg(qy + l.q), o);
  Vec<W>::store(out + l.q * r + l.c, o);
}

// R2g: R2b's function on the grid itself.  data (nx, ny, r), x (nx), y (ny);
// the cell, clamped to the (nx - 1)(ny - 1) cells, is xi (ny - 1) + yi.  The
// corner blocks are data[xi, yi : yi + 2] and data[xi + 1, yi : yi + 2], two
// runs of 2r contiguous values.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    bilinear_grid_kernel(const T* __restrict__ data, const T* __restrict__ x,
                         const T* __restrict__ y, int64_t nx, int64_t ny, int64_t r,
                         const int32_t* __restrict__ cell, const T* __restrict__ qx,
                         const T* __restrict__ qy, T* __restrict__ out, int64_t nq) {
  const Lane l = lane_of<W>(r, nq);
  if (l.q < 0) return;
  const int64_t ny1 = ny - 1;
  // < 2^31 cells (the cell search checks): 32-bit division
  const int32_t c = static_cast<int32_t>(clamp_cell(__ldg(cell + l.q), (nx - 1) * ny1));
  const int32_t xi = c / static_cast<int32_t>(ny1);
  const int32_t yi = c - xi * static_cast<int32_t>(ny1);
  const T* lo = data + (static_cast<int64_t>(xi) * ny + yi) * r + l.c;  // z11, z12 at + r
  const T* hi = lo + ny * r;                                             // z21, z22 at + r
  T z11[W], z12[W], z21[W], z22[W], o[W];
  Vec<W>::load(lo, z11);
  Vec<W>::load(lo + r, z12);
  Vec<W>::load(hi, z21);
  Vec<W>::load(hi + r, z22);
  bilinear_lerps<T, W>(z11, z12, z21, z22, __ldg(x + xi), __ldg(x + xi + 1), __ldg(y + yi),
                       __ldg(y + yi + 1), __ldg(qx + l.q), __ldg(qy + l.q), o);
  Vec<W>::store(out + l.q * r + l.c, o);
}

// The three forms of one channel of R2c / R2d / R2n from its 16 blocks v[b] of
// the cell row (block b = 4 i + c: quantity i in [f, kx*dx, ky*dy, kxy*dx*dy],
// corner c in [11, 12, 21, 22]) at the query's fractions (t, s).  A form is
// built once a query and applied to each of its channels: the weight forms
// hold their 16 weights, the nested form its fractions.
template <typename T, int kOrder>
struct CellForm {  // kSeq, kTree
  T w[16];
  __device__ __forceinline__ CellForm(T t, T s) {
    T bx[4], by[4];
    basis(t, bx);
    basis(s, by);
    // W[4 i + c] = Ax[i][c >> 1] * Ay[i][c & 1] (pallas_tail._bicubic_weights):
    // f and ky take the value bases along x, kx and kxy the derivative bases;
    // f and kx take the value bases along y, ky and kxy the derivative bases
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int i = b >> 2;
      w[b] = bx[(i & 1) * 2 + ((b & 3) >> 1)] * by[(i >> 1) * 2 + (b & 1)];
    }
  }
  __device__ __forceinline__ T operator()(const T (&v)[16]) const {
    T p[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) p[b] = w[b] * v[b];
    if (kOrder == kSeq) {
      T acc = p[0];
#pragma unroll
      for (int b = 1; b < 16; ++b) acc = acc + p[b];
      return acc;
    }
    // the halving tree, one level at a time (constant bounds: p stays in registers)
#pragma unroll
    for (int b = 0; b < 8; ++b) p[b] = p[b] + p[b + 8];
#pragma unroll
    for (int b = 0; b < 4; ++b) p[b] = p[b] + p[b + 4];
#pragma unroll
    for (int b = 0; b < 2; ++b) p[b] = p[b] + p[b + 2];
    return p[0] + p[1];
  }
};

template <typename T>
struct CellForm<T, kNested> {
  T t, s;
  __device__ __forceinline__ CellForm(T t_, T s_) : t(t_), s(s_) {}
  // f and ky*dy along x at both bracketing y-knots, then along y
  __device__ __forceinline__ T operator()(const T (&v)[16]) const {
    const T f_y1 = hermite_scaled(v[0], v[2], v[4], v[6], t);
    const T f_y2 = hermite_scaled(v[1], v[3], v[5], v[7], t);
    const T g_y1 = hermite_scaled(v[8], v[10], v[12], v[14], t);
    const T g_y2 = hermite_scaled(v[9], v[11], v[13], v[15], t);
    return hermite_scaled(f_y1, f_y2, g_y1, g_y2, s);
  }
};

// W channels of one query: the 16 blocks at `blocks` (block b at blocks + b r)
// read as W-wide loads, the form applied to each channel, W results to dst
template <typename T, int W, int kOrder>
__device__ __forceinline__ void cell_chunk(const T* __restrict__ blocks, int64_t r,
                                           const CellForm<T, kOrder>& form, T* __restrict__ dst) {
  T v[16][W], o[W];
#pragma unroll
  for (int b = 0; b < 16; ++b) Vec<W>::load(blocks + b * r, v[b]);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    T col[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) col[b] = v[b][j];
    o[j] = form(col);
  }
  Vec<W>::store(dst, o);
}

// The blocks an SM the bicubic tails' launch bounds ask for: four (64
// registers a thread) keep the most warps in flight; the f64 weight forms,
// whose 16 weights take 32 registers, spill or wait on their loads below
// 128 registers, so they take two.
template <typename T, int kOrder>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 8 && kOrder != kNested ? 2 : 4;
}

// R2c / R2d in query order.  tbl (rows, ch), ch >= 16r: block b holds columns
// [b r, (b + 1) r); out (nq, r).  A lane takes W channels of one query (R2b's
// lanes), its 16 weights built once.
template <typename T, int W, int kOrder>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, kOrder>()))
    cell_tail_kernel(const T* __restrict__ tbl, int64_t rows, int64_t ch, int64_t r,
                     const int32_t* __restrict__ cell, const T* __restrict__ tx,
                     const T* __restrict__ ty, T* __restrict__ out, int64_t nq) {
  const Lane l = lane_of<W>(r, nq);
  if (l.q < 0) return;
  const T* row = tbl + clamp_cell(__ldg(cell + l.q), rows) * ch;
  const CellForm<T, kOrder> form(__ldg(tx + l.q), __ldg(ty + l.q));
  cell_chunk<T, W, kOrder>(row + l.c, r, form, out + l.q * r + l.c);
}

// R2n in query order: a thread an element e = q r + c of out (nq, r), n = nq r.
// The lane body above, on R2n's form, read rows 3% slower at 2^17 queries
// and 2% at 1M (tools/tail2d_phases.py), so R2n keeps this body.
template <typename T>
__global__ void nested_tail_kernel(const T* __restrict__ tbl, int64_t rows, int64_t ch,
                                   int64_t r, const int32_t* __restrict__ cell,
                                   const T* __restrict__ tx, const T* __restrict__ ty,
                                   T* __restrict__ out, int64_t n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t q = e / r;
  const T* v = tbl + clamp_cell(__ldg(cell + q), rows) * ch + (e - q * r);  // block b at v[b r]
  T col[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) col[b] = __ldg(v + b * r);
  out[e] = CellForm<T, kNested>(__ldg(tx + q), __ldg(ty + q))(col);
}

// -- R2c / R2d / R2n on queries ordered by cell ------------------------------------------
// The records come from csrc/cell_order.cu's form keyed on the flat cell, 32
// bytes each: [v, qid, tx, ty, ...], v the cell clamped to the table and the
// fractions' bits in the tail's dtype (f32 one word each, f64 two).
template <typename T>
struct CellRecord {
  int32_t v, qid;
  T tx, ty;
};

__device__ __forceinline__ void record_at(const int4* __restrict__ rec, int64_t i,
                                          CellRecord<float>* q) {
  const int4 a = __ldg(rec + 2 * i);
  *q = {a.x, a.y, __int_as_float(a.z), __int_as_float(a.w)};
}

__device__ __forceinline__ void record_at(const int4* __restrict__ rec, int64_t i,
                                          CellRecord<double>* q) {
  const int4 a = __ldg(rec + 2 * i);
  const int4 b = __ldg(rec + 2 * i + 1);
  *q = {a.x, a.y, __hiloint2double(a.w, a.z), __hiloint2double(b.y, b.x)};
}

// A warp takes 32 / L slots of L lanes (L = the query's chunks of W channels,
// at most 32; slot_of in df_common.cuh), each slot one record, each lane W
// channels of one chunk at a time: float4 (double2) where the blocks are
// 16-byte aligned, one value else.  Neighbouring slots mostly share a cell, so
// one load instruction fetches their blocks once.  Each lane builds the
// record's form once (the weight forms' 16 weights) and writes each result to
// its query's slot (qid, c): the query-order body's values.
template <typename T, int W, int kOrder>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, kOrder>()))
    cell_tail_ordered_kernel(const T* __restrict__ tbl, int64_t ch, int64_t r,
                             const int4* __restrict__ rec, T* __restrict__ out, int64_t n) {
  const int64_t chunks = r / W;
  const Slot s = slot_of(chunks, n);
  if (!s.valid) return;
  CellRecord<T> q;
  record_at(rec, s.q, &q);
  const T* row = tbl + static_cast<int64_t>(q.v) * ch;
  T* dst = out + static_cast<int64_t>(q.qid) * r;
  const CellForm<T, kOrder> form(q.tx, q.ty);
  for (int64_t k = s.sub; k < chunks; k += s.size)
    cell_chunk<T, W, kOrder>(row + k * W, r, form, dst + k * W);
}

template <typename T, bool kWhole>
cudaError_t staged_cell_index(const StagedAxis<T>& ax, const StagedAxis<T>& ay, const T* qx,
                              const T* qy, int32_t* cell, T* tx, T* ty, int64_t nq,
                              cudaStream_t s) {
  auto kernel = staged_cell_index_kernel<T, kWhole>;
  // one depth for both trees, the larger axis's: the smaller tree's extra
  // levels are +inf slots, walked beside the larger tree's
  const int hx = tree_levels(ax.c), hy = tree_levels(ay.c);
  const int h = hx > hy ? hx : hy;
  const size_t smem = (static_cast<size_t>(2) << h) * sizeof(T);
  const int threads = kWhole ? kSearchThreads : kSearchThreads / 2;
  unsigned int blocks = 0;
  const cudaError_t err = staged_grid(kernel, threads, smem, nq, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(ax, ay, h, qx, qy, cell, tx, ty, nq);
  return cudaGetLastError();
}

// R1 with each axis on a tree of at most shared_knots knots (capped at the
// largest of two trees a block holds; at least 1)
template <typename T>
int cell_index(const void* x, int64_t nx, const void* y, int64_t ny, int64_t shared_knots,
               const void* qx, const void* qy, void* cell, void* tx, void* ty, int64_t nq,
               void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  int64_t budget = 1;
  cudaError_t err = tree_budget(shared_knots, sizeof(T), &budget, 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StagedAxis<T> ax = staged_axis<T>(x, nx, budget);
  const StagedAxis<T> ay = staged_axis<T>(y, ny, budget);
  const T* qxx = static_cast<const T*>(qx);
  const T* qyy = static_cast<const T*>(qy);
  int32_t* c = static_cast<int32_t*>(cell);
  T* txx = static_cast<T*>(tx);
  T* tyy = static_cast<T*>(ty);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = ax.w == 1 && ay.w == 1
            ? staged_cell_index<T, true>(ax, ay, qxx, qyy, c, txx, tyy, nq, s)
            : staged_cell_index<T, false>(ax, ay, qxx, qyy, c, txx, tyy, nq, s);
  return static_cast<int>(err);
}

// R2b: 16-byte lanes where the rows allow them, one channel a lane else
template <typename T>
int bilinear_tail(const void* tbl, int64_t rows, int64_t ch, int64_t r, const void* cell,
                  const void* qx, const void* qy, void* out, int64_t nq, void* stream) {
  if (nq > 0 && r > 0) {
    constexpr int W = 16 / sizeof(T);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* p = static_cast<const T*>(tbl);
    const int32_t* c = static_cast<const int32_t*>(cell);
    const T* a = static_cast<const T*>(qx);
    const T* b = static_cast<const T*>(qy);
    T* o = static_cast<T*>(out);
    if (wide_lanes<W>(tbl, r, ch)) {
      const LaneGrid g = lane_grid(r / W, nq);
      bilinear_rows_kernel<T, W><<<g.grid, g.block, 0, s>>>(p, rows, ch, r, c, a, b, o, nq);
    } else {
      const LaneGrid g = lane_grid(r, nq);
      bilinear_rows_kernel<T, 1><<<g.grid, g.block, 0, s>>>(p, rows, ch, r, c, a, b, o, nq);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// R2g: the same lanes on the grid
template <typename T>
int bilinear_grid(const void* data, const void* x, const void* y, int64_t nx, int64_t ny,
                  int64_t r, const void* cell, const void* qx, const void* qy, void* out,
                  int64_t nq, void* stream) {
  if (nq > 0 && r > 0) {
    constexpr int W = 16 / sizeof(T);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* d = static_cast<const T*>(data);
    const T* xs = static_cast<const T*>(x);
    const T* ys = static_cast<const T*>(y);
    const int32_t* c = static_cast<const int32_t*>(cell);
    const T* a = static_cast<const T*>(qx);
    const T* b = static_cast<const T*>(qy);
    T* o = static_cast<T*>(out);
    if (wide_lanes<W>(data, r, r)) {
      const LaneGrid g = lane_grid(r / W, nq);
      bilinear_grid_kernel<T, W><<<g.grid, g.block, 0, s>>>(d, xs, ys, nx, ny, r, c, a, b, o, nq);
    } else {
      const LaneGrid g = lane_grid(r, nq);
      bilinear_grid_kernel<T, 1><<<g.grid, g.block, 0, s>>>(d, xs, ys, nx, ny, r, c, a, b, o, nq);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// R2c / R2d in query order: 16-byte lanes where the rows allow them, one
// channel a lane else; R2n a thread an element
template <typename T, int kOrder>
int bicubic_tail(const void* tbl, int64_t rows, int64_t ch, int64_t r, const void* cell,
                 const void* tx, const void* ty, void* out, int64_t nq, void* stream) {
  if (nq > 0 && r > 0) {
    constexpr int W = 16 / sizeof(T);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* p = static_cast<const T*>(tbl);
    const int32_t* c = static_cast<const int32_t*>(cell);
    const T* a = static_cast<const T*>(tx);
    const T* b = static_cast<const T*>(ty);
    T* o = static_cast<T*>(out);
    if constexpr (kOrder == kNested) {
      const int64_t n = nq * r;
      nested_tail_kernel<T><<<static_cast<unsigned int>((n + kThreads - 1) / kThreads), kThreads,
                              0, s>>>(p, rows, ch, r, c, a, b, o, n);
    } else if (wide_lanes<W>(tbl, r, ch)) {
      const LaneGrid g = lane_grid(r / W, nq);
      cell_tail_kernel<T, W, kOrder><<<g.grid, g.block, 0, s>>>(p, rows, ch, r, c, a, b, o, nq);
    } else {
      const LaneGrid g = lane_grid(r, nq);
      cell_tail_kernel<T, 1, kOrder><<<g.grid, g.block, 0, s>>>(p, rows, ch, r, c, a, b, o, nq);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// R2c / R2d / R2n on ordered records: the same lanes
template <typename T, int kOrder>
int bicubic_tail_ordered(const void* tbl, int64_t, int64_t ch, int64_t r, const void* rec,
                         void* out, int64_t nq, void* stream) {
  if (nq > 0 && r > 0) {
    constexpr int W = 16 / sizeof(T);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* p = static_cast<const T*>(tbl);
    const int4* q = static_cast<const int4*>(rec);
    T* o = static_cast<T*>(out);
    if (wide_lanes<W>(tbl, r, ch))
      cell_tail_ordered_kernel<T, W, kOrder>
          <<<ordered_blocks(r / W, nq), kThreads, 0, s>>>(p, ch, r, q, o, nq);
    else
      cell_tail_ordered_kernel<T, 1, kOrder>
          <<<ordered_blocks(r, nq), kThreads, 0, s>>>(p, ch, r, q, o, nq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// R1: x, nx, y, ny, shared_knots (the most knots a block stages of each axis;
// 1: every level of both searches on the global axes), qx, qy, cell, tx, ty, nq
int ndi_cell_index_f32(const void* x, int64_t nx, const void* y, int64_t ny,
                       int64_t shared_knots, const void* qx, const void* qy, void* cell,
                       void* tx, void* ty, int64_t nq, void* stream) {
  return cell_index<float>(x, nx, y, ny, shared_knots, qx, qy, cell, tx, ty, nq, stream);
}

int ndi_cell_index_f64(const void* x, int64_t nx, const void* y, int64_t ny,
                       int64_t shared_knots, const void* qx, const void* qy, void* cell,
                       void* tx, void* ty, int64_t nq, void* stream) {
  return cell_index<double>(x, nx, y, ny, shared_knots, qx, qy, cell, tx, ty, nq, stream);
}

#define NDI_CELL_TAIL(name, body)                                                         \
  int name(const void* tbl, int64_t rows, int64_t ch, int64_t r, const void* cell,        \
           const void* a, const void* b, void* out, int64_t nq, void* stream) {           \
    return body(tbl, rows, ch, r, cell, a, b, out, nq, stream);                           \
  }

NDI_CELL_TAIL(ndi_bilinear_tail_f32, bilinear_tail<float>)
NDI_CELL_TAIL(ndi_bilinear_tail_f64, bilinear_tail<double>)
NDI_CELL_TAIL(ndi_bicubic_seq_tail_f32, (bicubic_tail<float, kSeq>))
NDI_CELL_TAIL(ndi_bicubic_seq_tail_f64, (bicubic_tail<double, kSeq>))
NDI_CELL_TAIL(ndi_bicubic_tree_tail_f32, (bicubic_tail<float, kTree>))
NDI_CELL_TAIL(ndi_bicubic_tree_tail_f64, (bicubic_tail<double, kTree>))
NDI_CELL_TAIL(ndi_bicubic_nested_tail_f32, (bicubic_tail<float, kNested>))
NDI_CELL_TAIL(ndi_bicubic_nested_tail_f64, (bicubic_tail<double, kNested>))

#undef NDI_CELL_TAIL

// R2g: data (nx, ny, r), x (nx), y (ny), cell, qx, qy (nq), out (nq, r)
int ndi_bilinear_grid_tail_f32(const void* data, const void* x, const void* y, int64_t nx,
                               int64_t ny, int64_t r, const void* cell, const void* qx,
                               const void* qy, void* out, int64_t nq, void* stream) {
  return bilinear_grid<float>(data, x, y, nx, ny, r, cell, qx, qy, out, nq, stream);
}

int ndi_bilinear_grid_tail_f64(const void* data, const void* x, const void* y, int64_t nx,
                               int64_t ny, int64_t r, const void* cell, const void* qx,
                               const void* qy, void* out, int64_t nq, void* stream) {
  return bilinear_grid<double>(data, x, y, nx, ny, r, cell, qx, qy, out, nq, stream);
}

// R2c, R2d and R2n on the records of csrc/cell_order.cu keyed on the flat cell:
// tbl (rows, ch), ch >= 16 r, rec (nq, 8) int32, out (nq, r)
#define NDI_CELL_TAIL_ORDERED(name, body)                                                 \
  int name(const void* tbl, int64_t rows, int64_t ch, int64_t r, const void* rec,         \
           void* out, int64_t nq, void* stream) {                                         \
    return body(tbl, rows, ch, r, rec, out, nq, stream);                                  \
  }

NDI_CELL_TAIL_ORDERED(ndi_bicubic_seq_tail_ordered_f32, (bicubic_tail_ordered<float, kSeq>))
NDI_CELL_TAIL_ORDERED(ndi_bicubic_seq_tail_ordered_f64, (bicubic_tail_ordered<double, kSeq>))
NDI_CELL_TAIL_ORDERED(ndi_bicubic_tree_tail_ordered_f32, (bicubic_tail_ordered<float, kTree>))
NDI_CELL_TAIL_ORDERED(ndi_bicubic_tree_tail_ordered_f64, (bicubic_tail_ordered<double, kTree>))
NDI_CELL_TAIL_ORDERED(ndi_bicubic_nested_tail_ordered_f32,
                      (bicubic_tail_ordered<float, kNested>))
NDI_CELL_TAIL_ORDERED(ndi_bicubic_nested_tail_ordered_f64,
                      (bicubic_tail_ordered<double, kNested>))

#undef NDI_CELL_TAIL_ORDERED

}  // extern "C"
