// Banked 1-D evaluation kernels for Hopper (sm_90a).
//
// K5   banked_eval  replaces the Pallas kernel ndarray_interp_tpu/ops/pallas_bank.py
//                   _direct_kernel (banked_eval): the symmetric Hermite form of a
//                   wide bank of splines that share one short knot axis, at each
//                   query's (idx, t).  Tables data (n, bank), a and b (n-1, bank).
// R2a  bank_tail    replaces ndarray_interp_tpu/ops/pallas_tail.py _kernel
//                   (banked_hermite_tail): the same form on packed per-interval
//                   rows [y_l | y_r | a | b] (pack_bank_rows: each channel bp >= bank
//                   columns wide), the row at idx fetched by the kernel itself.
//
// What the TPU kernels did and these do not.  K5's Pallas body selected each
// query's rows with one-hot bf16 matrix products (three truncation splits per
// table, so the select is exact for finite values), a stand-in for a gather on
// a chip whose vector unit cannot load at a per-query address; one NaN datum
// NaNs its whole bank lane there (0 * NaN in the product).  A GPU thread loads
// the value it needs, so a NaN datum reaches only the queries of its two
// intervals, as in the plain gather.  R2a's Pallas kernel took rows already
// gathered by XLA; here the row gather is fused in, as in K8-K14, so the
// gathered (Q, 4 bp) intermediate is never written.
//
// What bounds them on this card.  Both write 4 (f32) or 8 (f64) bytes for each
// (query, bank column) and read, per output, four table values at addresses
// the query's idx selects.  The output is the memory bound: 268 MB at 4,096
// queries x 16,384 splines (K5's tables are 50 MB), 1 GB at 256 x 1,000,000
// (the tables 768 MB), 67 MB at 262,144 x 64 for R2a (its table 10 MB).
//
// K5 reads its four values from the L2, which holds or streams the tables:
// 16 B of row reads for each 4 B output in f32, 1 GB of them at NS2b's
// 10,240 x 64 and 1M queries for 256 MB written, so at wide banks the L2's
// read rate, not device memory, is what the kernel runs into.  Its first
// design ran a thread a column of a 256-column tile, 32 queries in turn,
// four 4-byte loads an output: at a bank of 8, 8 of a block's 256 threads
// worked.  The second design sizes its lanes to the bank, as R2a's below: a
// lane takes W columns with 16-byte loads and stores (f32 4, f64 2) where the
// bank is a multiple of W and the three tables and the output start on
// 16-byte boundaries, one column a lane else; L = min(bank / W, 32) lanes a
// query, rounded up to a power of two, and 32 / L queries a warp, so every
// warp of a 256-thread block works (a bank of 8 in f32: 2 lanes a query, 16
// queries a warp).  A block is one tile of L * W columns and a chunk of
// consecutive queries its threads take in rounds (two at L >= 16, where a
// lane's second query overlaps its first's loads; one below), numbered
// tile-major (the query block is the fastest), so the blocks that share a
// table tile run together and read it from device memory about once.  The
// output is stored evict-first (st.global.cs), so the 268 MB or 1 GB written
// does not push the table tile out of the L2.  ops/bank_eval.py _k5_geometry
// picks W, L and the chunk.  Staging the tile of the three tables in shared
// memory (48 to 200 KB a block) and loading the tables L2-only were slower
// at every shape timed (PERF.md §6, K5's row).
//
// R2a reads each query's whole packed row, 4 bp values (1 KiB at bank 64 in
// f32), from the L2 that holds the table, for bank values of output: at
// NS2b's 10,240 x 64 and 1M queries 1 GB of row reads for 256 MB written.
// The first design (a thread a column, four 4-byte loads) was bound by its
// load instructions, not by that traffic: it took as long with every query
// in one interval.  A lane takes W columns with 16-byte loads and stores
// (f32 4, f64 2) where the row blocks and the output rows are 16-byte
// aligned (bank and bp multiples of W, the table's base aligned:
// pack_bank_rows makes bp a multiple of 8), one column a lane else; a block
// is 256 / L queries of L = min(bank / W, 32) lanes, so narrow banks fill the
// warps.  Ordering the queries by interval first (cell_order.cu's 1-D form,
// a lane holding its chunk of a row for a run of records) lost at every batch
// on 128-byte and 1 KiB rows and tied on 2 KiB ones; it won only on rows of
// 4 KiB and up from 2^17 queries, which no path reads, so it was not kept
// (PERF.md).
//
// Numerics: the Hermite form is written in the plain PyTorch versions'
// operation order, ((1-t) y_l + t y_r) + (t (1-t)) (a (1-t) + b t), and the
// library is compiled with --fmad=false, so each kernel is bit-identical to
// its plain version (ops/bank_eval.py _gather_form, ops/bank_tail.py
// _tail_plain).  An idx outside [0, rows) is clamped, as the plain versions
// clamp it, so a bad index cannot read outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

#include "df_common.cuh"  // Vec, kThreads, wide_lanes, lane_grid

namespace {

template <typename T>
__device__ __forceinline__ T hermite(T y_l, T y_r, T a, T b, T t) {
  const T one = T(1);
  return (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t);
}

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// The W results of one lane at (row r of the four tables, fraction tq),
// stored evict-first: the output is written once and never read here.  `yl`
// points at the lane's columns of data row r, `yr` of row r + 1, `al`/`bl` of
// a and b row r.
template <typename T, int W>
__device__ __forceinline__ void lane_eval(const T* yl, const T* yr, const T* al, const T* bl,
                                          T tq, T* dst) {
  T y0[W], y1[W], av[W], bv[W], r[W];
  Vec<W>::load(yl, y0);
  Vec<W>::load(yr, y1);
  Vec<W>::load(al, av);
  Vec<W>::load(bl, bv);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = hermite(y0[j], y1[j], av[j], bv[j], tq);
  Vec<W>::store_cs(dst, r);
}

// K5.  rows = n - 1 intervals; data has rows + 1 rows of `bank` columns.  A
// lane (threadIdx.x) takes W columns of a query (threadIdx.y), blockDim.x
// lanes a query; a block is one tile of blockDim.x * W columns and `chunk`
// consecutive queries, `qblocks` blocks a tile.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
banked_eval_kernel(const T* __restrict__ data, const T* __restrict__ a,
                   const T* __restrict__ b, int64_t rows, int64_t bank,
                   const int32_t* __restrict__ idx, const T* __restrict__ t,
                   T* __restrict__ out, int64_t nq, int64_t chunk, int64_t qblocks) {
  const int64_t tile = blockIdx.x / qblocks;
  const int64_t q_lo = (blockIdx.x - tile * qblocks) * chunk;
  const int64_t q_hi = q_lo + chunk < nq ? q_lo + chunk : nq;
  const int64_t c = (tile * blockDim.x + threadIdx.x) * W;
  if (c >= bank) return;
  for (int64_t q = q_lo + threadIdx.y; q < q_hi; q += blockDim.y) {
    const int64_t off = clamp_row(__ldg(idx + q), rows) * bank + c;
    lane_eval<T, W>(data + off, data + off + bank, a + off, b + off, __ldg(t + q),
                    out + q * bank + c);
  }
}

// R2a.  packed (rows, ch) with ch = 4 bp: [y_l | y_r | a | b],
// bp columns each; a lane (threadIdx.x) takes W columns of one query
// (threadIdx.y).
template <typename T, int W>
__global__ void bank_tail_kernel(const T* __restrict__ packed, int64_t rows, int64_t ch,
                                 int64_t bp, int64_t bank, const int32_t* __restrict__ idx,
                                 const T* __restrict__ t, T* __restrict__ out, int64_t nq) {
  const int64_t qi = blockIdx.x * static_cast<int64_t>(blockDim.y) + threadIdx.y;
  const int64_t c = (blockIdx.y * static_cast<int64_t>(blockDim.x) + threadIdx.x) * W;
  if (qi >= nq || c >= bank) return;
  const T* row = packed + clamp_row(__ldg(idx + qi), rows) * ch + c;
  T y_l[W], y_r[W], a[W], b[W], r[W];
  Vec<W>::load(row, y_l);
  Vec<W>::load(row + bp, y_r);
  Vec<W>::load(row + 2 * bp, a);
  Vec<W>::load(row + 3 * bp, b);
  const T tq = __ldg(t + qi);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = hermite(y_l[j], y_r[j], a[j], b[j], tq);
  Vec<W>::store(out + qi * bank + c, r);
}

template <typename T, int W>
int banked_launch(const T* data, const T* a, const T* b, int64_t rows, int64_t bank,
                  const int32_t* idx, const T* t, T* out, int64_t nq, int lanes, int64_t chunk,
                  cudaStream_t s) {
  const int64_t tiles = (bank / W + lanes - 1) / lanes;
  const int64_t qblocks = (nq + chunk - 1) / chunk;
  if (tiles * qblocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  banked_eval_kernel<T, W><<<static_cast<unsigned int>(tiles * qblocks),
                             dim3(lanes, kThreads / lanes), 0, s>>>(data, a, b, rows, bank, idx,
                                                                    t, out, nq, chunk, qblocks);
  return static_cast<int>(cudaGetLastError());
}

// K5 at the geometry ops/bank_eval.py _k5_geometry chose: w columns a lane
// (16 / sizeof(T), or 1), `lanes` lanes a query (a power of two up to 32),
// `chunk` queries a block.  16-byte lanes on a bank that is no multiple of w
// or on a base off 16-byte alignment are refused, not run.
template <typename T>
int banked_eval(const void* data, const void* a, const void* b, int64_t rows, int64_t bank,
                const void* idx, const void* t, void* out, int64_t nq, int64_t w, int64_t lanes,
                int64_t chunk, void* stream) {
  if (nq <= 0 || bank <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kW = 16 / sizeof(T);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* d = static_cast<const T*>(data);
  const T* aa = static_cast<const T*>(a);
  const T* bb = static_cast<const T*>(b);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const T* tt = static_cast<const T*>(t);
  T* o = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int l = static_cast<int>(lanes);
  if (w == kW) {
    if (!(wide_lanes<kW>(data, bank, bank) && wide_lanes<kW>(a, bank, bank) &&
          wide_lanes<kW>(b, bank, bank) && wide_lanes<kW>(out, bank, bank)))
      return static_cast<int>(cudaErrorInvalidValue);
    return banked_launch<T, kW>(d, aa, bb, rows, bank, ix, tt, o, nq, l, chunk, s);
  }
  if (w != 1) return static_cast<int>(cudaErrorInvalidValue);
  return banked_launch<T, 1>(d, aa, bb, rows, bank, ix, tt, o, nq, l, chunk, s);
}

template <typename T, int W>
void bank_tail_launch(const T* packed, int64_t rows, int64_t ch, int64_t bp, int64_t bank,
                      const int32_t* idx, const T* t, T* out, int64_t nq, cudaStream_t s) {
  const LaneGrid g = lane_grid(bank / W, nq);
  bank_tail_kernel<T, W><<<g.grid, g.block, 0, s>>>(packed, rows, ch, bp, bank, idx, t, out, nq);
}

// R2a: 16-byte lanes where the layout allows them, else a column a lane
template <typename T>
int bank_tail(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t bank,
              const void* idx, const void* t, void* out, int64_t nq, void* stream) {
  if (nq > 0 && bank > 0) {
    constexpr int W = 16 / sizeof(T);
    const T* p = static_cast<const T*>(packed);
    const int32_t* ix = static_cast<const int32_t*>(idx);
    const T* tt = static_cast<const T*>(t);
    T* o = static_cast<T*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (wide_lanes<W>(packed, bp, bank))
      bank_tail_launch<T, W>(p, rows, ch, bp, bank, ix, tt, o, nq, s);
    else
      bank_tail_launch<T, 1>(p, rows, ch, bp, bank, ix, tt, o, nq, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ndi_banked_eval_f32(const void* data, const void* a, const void* b, int64_t rows,
                        int64_t bank, const void* idx, const void* t, void* out, int64_t nq,
                        int64_t w, int64_t lanes, int64_t chunk, void* stream) {
  return banked_eval<float>(data, a, b, rows, bank, idx, t, out, nq, w, lanes, chunk, stream);
}

int ndi_banked_eval_f64(const void* data, const void* a, const void* b, int64_t rows,
                        int64_t bank, const void* idx, const void* t, void* out, int64_t nq,
                        int64_t w, int64_t lanes, int64_t chunk, void* stream) {
  return banked_eval<double>(data, a, b, rows, bank, idx, t, out, nq, w, lanes, chunk, stream);
}

int ndi_bank_tail_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t bank,
                      const void* idx, const void* t, void* out, int64_t nq, void* stream) {
  return bank_tail<float>(packed, rows, ch, bp, bank, idx, t, out, nq, stream);
}

int ndi_bank_tail_f64(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t bank,
                      const void* idx, const void* t, void* out, int64_t nq, void* stream) {
  return bank_tail<double>(packed, rows, ch, bp, bank, idx, t, out, nq, stream);
}

}  // extern "C"
