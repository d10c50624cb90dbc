// Query ordering by cell for the f64-grade bicubic tails K12 and K14 (sm_90a).
//
// No TPU twin.  The TPU routes gathered every query's row in query order; on
// this card a 1M-query batch over a 512 x 512 cell table (535 MB, ten times
// the 50 MB L2) then reads each query's 2 KB row from HBM, about four times
// for each row.  A counting sort of the batch by cell puts the queries of one
// cell, and of neighbouring cells, next to each other, so the tails that read
// the ordered records (csrc/df2d_kernels.cu) fetch each row from HBM about
// once and share it between the queries of a warp.
//
// The key of query i is its row value v = xi[i] * row_step + yi[i], clamped
// to [lo, rows - 1]: the cell xi (ny - 1) + yi with lo = 0 (K12), or the base
// node xi ny + yi with lo = -(ny + 1) (K14, whose tail clamps each of its
// four nodes: every base below -(ny + 1) clamps them all to row 0, as that
// one does).  Its bucket is max(v, 0) >> shift; the wrapper picks the shift
// so that there are at most 2^22 buckets (16 MB of counts).
//
// Three steps, four launches:
//   1. order_count_kernel      a histogram of the buckets;
//   2. order_scan_tiles_kernel an exclusive scan of the counts, 4,096 a block,
//      order_scan_top_kernel   then of the blocks' totals (at most 1,024);
//   3. order_scatter_kernel    each query's record at its bucket's next slot:
//      rec[p] = [v, i, tx_hi, tx_lo, ty_hi, ty_lo, 0, 0], 32 bytes (the
//      halves' bits), written one whole sector at a time.
// Both passes over the queries aggregate their atomics: a block whose queries
// share one bucket adds once, else the lanes of a warp that share a bucket
// (__match_any_sync) add once through their leader.  A batch in one cell thus
// makes one atomic a block, not one a query.  The order within a bucket
// depends on the atomics' order and may vary from run to run; the tails'
// results do not, since each element is computed by the same operations
// whatever thread computes it.
//
// What bounds it: bytes, and the atomics.  At 1M queries it reads xi and yi
// twice and the fraction halves once (32 MB), writes 32 MB of records, and
// scans 4 B a bucket twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBits = 12;  // counts scanned 4,096 a block, 4 a thread
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t row_value(const int32_t* __restrict__ xi,
                                             const int32_t* __restrict__ yi, int64_t i,
                                             int64_t row_step, int64_t lo, int64_t rows) {
  const int64_t v = static_cast<int64_t>(__ldg(xi + i)) * row_step + __ldg(yi + i);
  return static_cast<int32_t>(v < lo ? lo : (v >= rows ? rows - 1 : v));
}

__device__ __forceinline__ int32_t bucket_of(int32_t v, int shift) {
  return (v < 0 ? 0 : v) >> shift;
}

// Exclusive scan of one value a thread over a block of kScanThreads (32
// warps); *total gets the block's sum.  Called once a launch.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[31];
  return x - v + (warp ? s_warp[warp - 1] : 0u);
}

__global__ void __launch_bounds__(kThreads)
    order_count_kernel(const int32_t* __restrict__ xi, const int32_t* __restrict__ yi,
                       int64_t row_step, int64_t lo, int64_t rows, int shift, int64_t n,
                       uint32_t* __restrict__ counts) {
  __shared__ int32_t s_first;
  const int64_t start = blockIdx.x * static_cast<int64_t>(kThreads);
  const int64_t i = start + threadIdx.x;
  const bool active = i < n;
  const int32_t b = active ? bucket_of(row_value(xi, yi, i, row_step, lo, rows), shift) : -1;
  if (threadIdx.x == 0) s_first = b;  // thread 0 is active: start < n
  __syncthreads();
  if (__syncthreads_and(!active || b == s_first)) {
    if (threadIdx.x == 0)
      atomicAdd(counts + s_first,
                static_cast<uint32_t>(n - start < kThreads ? n - start : kThreads));
    return;
  }
  const int lane = threadIdx.x & 31;
  // an inactive lane keys itself apart (-1 - lane is no bucket)
  const uint32_t peers = __match_any_sync(kFull, active ? b : -1 - lane);
  if (active && lane == __ffs(peers) - 1)
    atomicAdd(counts + b, static_cast<uint32_t>(__popc(peers)));
}

// counts -> the exclusive prefix of each count within its tile of 4,096;
// tile_sums[t] = the tile's total
__global__ void __launch_bounds__(kScanThreads)
    order_scan_tiles_kernel(uint32_t* __restrict__ counts, uint32_t* __restrict__ tile_sums) {
  uint4* c = reinterpret_cast<uint4*>(counts + (static_cast<int64_t>(blockIdx.x) << kTileBits)) +
             threadIdx.x;
  const uint4 v = *c;
  uint32_t total;
  const uint32_t e = block_exclusive_scan(v.x + v.y + v.z + v.w, &total);
  *c = make_uint4(e, e + v.x, e + v.x + v.y, e + v.x + v.y + v.z);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// tile_sums -> their exclusive prefix (ntiles <= kScanThreads)
__global__ void __launch_bounds__(kScanThreads)
    order_scan_top_kernel(uint32_t* __restrict__ tile_sums, int ntiles) {
  const bool mine = static_cast<int>(threadIdx.x) < ntiles;
  uint32_t total;
  const uint32_t e = block_exclusive_scan(mine ? tile_sums[threadIdx.x] : 0u, &total);
  if (mine) tile_sums[threadIdx.x] = e;
}

// Each query's record at tile_off[tile] + cursor[bucket]++ (the cursor starts
// at the bucket's prefix within its tile).  A record is 32 bytes, one sector:
// the lanes of a warp write them in pairs, lane 2k the first half of the
// record of lane 16 h + k and lane 2k + 1 its second half, so every store
// instruction writes 16 whole sectors.  (Records of 24 bytes in two arrays,
// each store a part of a sector, took twice as long once the L2 no longer held
// their lines: a partial sector is read from HBM before it is written.)
__global__ void __launch_bounds__(kThreads)
    order_scatter_kernel(const int32_t* __restrict__ xi, const int32_t* __restrict__ yi,
                         int64_t row_step, int64_t lo, int64_t rows, int shift,
                         const float* __restrict__ txh, const float* __restrict__ txl,
                         const float* __restrict__ tyh, const float* __restrict__ tyl,
                         int64_t n, uint32_t* __restrict__ cursor,
                         const uint32_t* __restrict__ tile_off, int4* __restrict__ rec) {
  __shared__ int32_t s_first;
  __shared__ uint32_t s_base;
  const int64_t start = blockIdx.x * static_cast<int64_t>(kThreads);
  const int64_t i = start + threadIdx.x;
  const bool active = i < n;
  const int32_t v = active ? row_value(xi, yi, i, row_step, lo, rows) : 0;
  const int32_t b = active ? bucket_of(v, shift) : -1;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_first = b;
  __syncthreads();
  uint32_t pos;
  if (__syncthreads_and(!active || b == s_first)) {
    if (threadIdx.x == 0)
      s_base = __ldg(tile_off + (s_first >> kTileBits)) +
               atomicAdd(cursor + s_first,
                         static_cast<uint32_t>(n - start < kThreads ? n - start : kThreads));
    __syncthreads();
    pos = s_base + threadIdx.x;
  } else {
    const uint32_t peers = __match_any_sync(kFull, active ? b : -1 - lane);
    const int leader = __ffs(peers) - 1;
    uint32_t base = 0;
    if (active && lane == leader)
      base = __ldg(tile_off + (b >> kTileBits)) +
             atomicAdd(cursor + b, static_cast<uint32_t>(__popc(peers)));
    base = __shfl_sync(peers, base, leader);
    pos = base + __popc(peers & ((1u << lane) - 1u));
  }
  const int a = active ? __float_as_int(__ldg(txh + i)) : 0;
  const int c = active ? __float_as_int(__ldg(txl + i)) : 0;
  const int d = active ? __float_as_int(__ldg(tyh + i)) : 0;
  const int e = active ? __float_as_int(__ldg(tyl + i)) : 0;
  const int second = lane & 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int src = 16 * h + (lane >> 1);  // the lane whose record this lane writes half of
    const uint32_t p = __shfl_sync(kFull, pos, src);
    const int live = __shfl_sync(kFull, static_cast<int>(active), src);
    const int sv = __shfl_sync(kFull, v, src);
    const int sa = __shfl_sync(kFull, a, src);
    const int sc = __shfl_sync(kFull, c, src);
    const int sd = __shfl_sync(kFull, d, src);
    const int se = __shfl_sync(kFull, e, src);
    const int qid = static_cast<int>(start + (threadIdx.x & ~31u) + src);
    if (live)
      rec[2 * static_cast<int64_t>(p) + second] =
          second ? make_int4(sd, se, 0, 0) : make_int4(sv, qid, sa, sc);
  }
}

}  // namespace

extern "C" {

// xi, yi (n,) int32 from K7; the four fraction halves (n,) float32; counts
// (ntiles * 4096,) uint32 zeroed by the caller; tile_sums (ntiles,); out: rec
// (n, 8) int32 in bucket order, [v, i, tx_hi, tx_lo, ty_hi, ty_lo, 0, 0] (the
// halves' bits).
int ndi_cell_order_f32(const void* xi, const void* yi, int64_t row_step, int64_t lo,
                       int64_t rows, int64_t shift, const void* txh, const void* txl,
                       const void* tyh, const void* tyl, void* counts, void* tile_sums,
                       int64_t ntiles, void* rec, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const int32_t* x = static_cast<const int32_t*>(xi);
  const int32_t* y = static_cast<const int32_t*>(yi);
  uint32_t* c = static_cast<uint32_t*>(counts);
  uint32_t* t = static_cast<uint32_t*>(tile_sums);
  order_count_kernel<<<blocks, kThreads, 0, s>>>(x, y, row_step, lo, rows,
                                                 static_cast<int>(shift), n, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  order_scan_tiles_kernel<<<static_cast<unsigned int>(ntiles), kScanThreads, 0, s>>>(c, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  order_scan_top_kernel<<<1, kScanThreads, 0, s>>>(t, static_cast<int>(ntiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  order_scatter_kernel<<<blocks, kThreads, 0, s>>>(
      x, y, row_step, lo, rows, static_cast<int>(shift), static_cast<const float*>(txh),
      static_cast<const float*>(txl), static_cast<const float*>(tyh),
      static_cast<const float*>(tyl), n, c, t, static_cast<int4*>(rec));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
