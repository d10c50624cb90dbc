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
// K5: threads run along the bank axis, so every table read and every output
// write of a warp is one 128-byte line (f32); a block owns one tile of
// kBankTile bank columns and a chunk of kQueryChunk queries, whose idx and t
// it stages in shared memory; blocks are numbered bank-tile-major (the query
// chunk is blockIdx.x, the fastest), so the blocks that share a table tile run
// together and the tile is read from device memory about once and then from
// L2, as the TPU grid's bank-outer order (pallas_bank.py:138) does for VMEM.
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

constexpr int kBankTile = 256;   // K5: bank columns per block, one per thread
constexpr int kQueryChunk = 32;  // K5: queries per block, idx and t in shared memory

template <typename T>
__device__ __forceinline__ T hermite(T y_l, T y_r, T a, T b, T t) {
  const T one = T(1);
  return (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t);
}

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// K5.  rows = n - 1 intervals; data has rows + 1 rows of `bank` columns.
template <typename T>
__global__ void banked_eval_kernel(const T* __restrict__ data, const T* __restrict__ a,
                                   const T* __restrict__ b, int64_t rows, int64_t bank,
                                   const int32_t* __restrict__ idx, const T* __restrict__ t,
                                   T* __restrict__ out, int64_t nq) {
  __shared__ int64_t s_off[kQueryChunk];
  __shared__ T s_t[kQueryChunk];
  const int64_t q0 = blockIdx.x * static_cast<int64_t>(kQueryChunk);
  const int64_t c = blockIdx.y * static_cast<int64_t>(kBankTile) + threadIdx.x;
  const int64_t m = nq - q0 < kQueryChunk ? nq - q0 : kQueryChunk;
  if (threadIdx.x < m) {
    s_off[threadIdx.x] = clamp_row(__ldg(idx + q0 + threadIdx.x), rows) * bank;
    s_t[threadIdx.x] = __ldg(t + q0 + threadIdx.x);
  }
  __syncthreads();
  if (c >= bank) return;
  T* dst = out + q0 * bank + c;
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const int64_t off = s_off[j] + c;
    dst[j * bank] = hermite(__ldg(data + off), __ldg(data + off + bank), __ldg(a + off),
                            __ldg(b + off), s_t[j]);
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

template <typename T>
int banked_eval(const void* data, const void* a, const void* b, int64_t rows, int64_t bank,
                const void* idx, const void* t, void* out, int64_t nq, void* stream) {
  if (nq > 0 && bank > 0) {
    const dim3 grid(static_cast<unsigned int>((nq + kQueryChunk - 1) / kQueryChunk),
                    static_cast<unsigned int>((bank + kBankTile - 1) / kBankTile));
    banked_eval_kernel<T><<<grid, kBankTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), static_cast<const T*>(a), static_cast<const T*>(b), rows,
        bank, static_cast<const int32_t*>(idx), static_cast<const T*>(t), static_cast<T*>(out),
        nq);
  }
  return static_cast<int>(cudaGetLastError());
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
                        void* stream) {
  return banked_eval<float>(data, a, b, rows, bank, idx, t, out, nq, stream);
}

int ndi_banked_eval_f64(const void* data, const void* a, const void* b, int64_t rows,
                        int64_t bank, const void* idx, const void* t, void* out, int64_t nq,
                        void* stream) {
  return banked_eval<double>(data, a, b, rows, bank, idx, t, out, nq, stream);
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
