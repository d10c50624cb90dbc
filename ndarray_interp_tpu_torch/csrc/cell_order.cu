// Query ordering by cell for the f64-grade bicubic tails K12, K13, K14 and R4c,
// and by interval for the 1-D bank tails K8 and K9 (sm_90a).
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
// to [lo, rows - 1]: the cell xi (ny - 1) + yi with lo = 0 (K12, K13, R4c), or
// the base node xi ny + yi with lo = -(ny + 1) (K14, whose tail clamps each of
// its four nodes: every base below -(ny + 1) clamps them all to row 0, as that
// one does).  A 1-D batch (K8, K9) passes no yi and no ty halves (null): its
// key is the interval xi[i] clamped to [0, rows - 1] (row_step 1, lo 0), its
// record [v, i, t_hi, t_lo, 0, 0, 0, 0].  K8's and K9's tables sit in the L2;
// there the ordering saves the L2 -> SM traffic of ~100 queries a row.  The
// bucket of v is max(v, 0) >> shift; the wrapper picks the shift so that
// there are at most 2^22 buckets.  A record rec[p] = [v, i, tx_hi, tx_lo,
// ty_hi, ty_lo, 0, 0] is 32 bytes (the halves' bits), one sector, written
// whole (write_records).
//
// Two forms, by the number of buckets (the wrapper picks):
//
// The shared form, up to 32,768 buckets (the 1-D keys: 10,239 intervals at
// the DF bank serving's shape, ~100 queries a bucket).  There the global
// form's atomics, one a query in each pass, queue on the L2 lines of a 40 KB
// counts array: its count took 0.026 ms and its scatter 0.042 of 0.078 (an
// H100 80GB HBM3 at 700 W, tools/cell_order_phases.py).  Here each of G
// blocks (one an SM) takes a contiguous chunk of the queries:
//   1. shared_count_kernel   counts its chunk in shared memory and writes the
//      histogram as row g of a (G, nb) table, plain coalesced stores;
//   2. shared_scan_kernel    32 buckets a block: thread (segment, bucket b)
//      loads its segment of bucket b's column of the table at once, leaves
//      in row g the bucket's queries in the blocks before g, and the last
//      block done scans the blocks' totals (scan_sums_if_last);
//   3. shared_scatter_kernel re-reads its chunk and puts each query at its
//      bucket's offset + its table entry + its rank, from cursors in shared
//      memory.
// No global atomic and no memset: three launches.  Its scatter's stores of
// records to scattered slots are now the most of it.  Past ~32 Ki buckets
// the table of G rows costs more than the global form's atomics.
//
// The global form, the first design, more buckets (the 2-D keys: 261,121
// cells at NS3d and NS3f, 1,048,576 base nodes at NS3e, 1-4 queries a
// bucket, where the global atomics hardly contend):
//   1. global_count_kernel      a histogram of the buckets (zeroed by the
//      wrapper);
//   2. global_scan_tiles_kernel an exclusive scan of the counts, 4,096 a block,
//      global_scan_top_kernel   then of the blocks' totals (at most 1,024);
//   3. global_scatter_kernel    each query's record at its bucket's next slot.
// Atomics are aggregated: a block whose queries share one bucket adds once,
// else the lanes of a warp that share a bucket (__match_any_sync) add once
// through their leader.  One scan launch that left the counts zero for the
// next call (no memset), per-lane atomics, and the fraction halves loaded
// before the scatter's atomic were each timed here and none was faster at
// NS3d or NS3e: the memset and the second scan are 3-4 us of ~0.06 ms, and
// the scatter's stores of 32 MB of records to scattered slots take ~0.034.
//
// In either form the order within a bucket follows the atomics and may vary
// from run to run; the tails' results do not, since each element is computed
// by the same operations whatever thread computes it.  (A stable shared form,
// one warp handing out a tile's slots warp by warp, cost 14 us more at the DF
// bank serving's shape.)
//
// What bounds it: bytes.  At 1M queries it reads xi and yi twice and the
// fraction halves once (32 MB), and writes 32 MB of records (1-D: 12 MB read).

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBits = 12;  // counts scanned 4,096 a block, 4 a thread
constexpr int kScanThreads = 1024;
constexpr int kSharedThreads = 1024;  // a block of the shared form
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t row_value(const int32_t* __restrict__ xi,
                                             const int32_t* __restrict__ yi, int64_t i,
                                             int64_t row_step, int64_t lo, int64_t rows) {
  const int64_t v = static_cast<int64_t>(__ldg(xi + i)) * row_step + (yi ? __ldg(yi + i) : 0);
  return static_cast<int32_t>(v < lo ? lo : (v >= rows ? rows - 1 : v));
}

__device__ __forceinline__ int32_t bucket_of(int32_t v, int shift) {
  return (v < 0 ? 0 : v) >> shift;
}

// Exclusive scan of one value a thread over a block of kWarps warps; *total
// gets the block's sum.  Callers that scan again sync first.
template <int kWarps>
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
    uint32_t w = lane < kWarps ? s_warp[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kWarps - 1];
  return x - v + (warp ? s_warp[warp - 1] : 0u);
}

// The query's fraction halves as the record holds their bits (the y halves 0
// in 1-D)
struct Fields {
  int a, c, d, e;
};

__device__ __forceinline__ Fields fields_of(const float* __restrict__ txh,
                                            const float* __restrict__ txl,
                                            const float* __restrict__ tyh,
                                            const float* __restrict__ tyl, int64_t i,
                                            bool active) {
  Fields f{0, 0, 0, 0};
  if (active) {
    f.a = __float_as_int(__ldg(txh + i));
    f.c = __float_as_int(__ldg(txl + i));
    if (tyh) {
      f.d = __float_as_int(__ldg(tyh + i));
      f.e = __float_as_int(__ldg(tyl + i));
    }
  }
  return f;
}

// Every active lane's record at its slot pos; all 32 lanes call it.  The lanes
// write the records in pairs, lane 2k the first half of the record of lane
// 16 h + k and lane 2k + 1 its second half, so every store instruction writes
// 16 whole sectors.  (Records of 24 bytes in two arrays, each store a part of
// a sector, took twice as long once the L2 no longer held their lines: a
// partial sector is read from HBM before it is written.  1-D records of 16
// bytes, [v, i, t_hi, t_lo], ordered as fast and were read 4% faster by K8
// and K9 alone, but 6% slower with the ordering before them: the tail's
// reads of the half-written sectors waited on those fills.)
__device__ __forceinline__ void write_records(int4* __restrict__ rec, bool active, uint32_t pos,
                                              int32_t v, int32_t qid, const Fields& f) {
  const int lane = threadIdx.x & 31;
  const int second = lane & 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int src = 16 * h + (lane >> 1);  // the lane whose record this lane writes half of
    const uint32_t p = __shfl_sync(kFull, pos, src);
    const int live = __shfl_sync(kFull, static_cast<int>(active), src);
    const int sv = __shfl_sync(kFull, v, src);
    const int sq = __shfl_sync(kFull, qid, src);
    const int sa = __shfl_sync(kFull, f.a, src);
    const int sc = __shfl_sync(kFull, f.c, src);
    const int sd = __shfl_sync(kFull, f.d, src);
    const int se = __shfl_sync(kFull, f.e, src);
    if (live)
      rec[2 * static_cast<int64_t>(p) + second] =
          second ? make_int4(sd, se, 0, 0) : make_int4(sv, sq, sa, sc);
  }
}

// The scan of a table in tiles, one block a tile, in one launch: each block
// writes its tile's total to sums[tile] and counts itself done; the last block
// done turns sums into their exclusive prefix (the tiles' offsets), which the
// scatter adds.  Called by every thread of a block of kWarps warps.
template <int kWarps>
__device__ __forceinline__ void scan_sums_if_last(uint32_t* sums, uint32_t* done, int ntiles) {
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    __threadfence();  // this tile's total is seen before it counts itself done
    s_last = atomicAdd(done, 1u) == static_cast<uint32_t>(ntiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  uint32_t carry = 0;
  for (int t0 = 0; t0 < ntiles; t0 += 32 * kWarps) {
    const int t = t0 + threadIdx.x;
    const uint32_t v = t < ntiles ? __ldcg(sums + t) : 0u;
    uint32_t total;
    const uint32_t e = block_exclusive_scan<kWarps>(v, &total);
    if (t < ntiles) sums[t] = carry + e;
    carry += total;
    __syncthreads();
  }
}

// -- the global form --------------------------------------------------------------------
// A histogram of the buckets in counts (zeroed by the caller): a block whose
// queries share one bucket adds once, else the lanes of a warp that share a
// bucket (__match_any_sync) add once through their leader
__global__ void __launch_bounds__(kThreads)
    global_count_kernel(const int32_t* __restrict__ xi, const int32_t* __restrict__ yi,
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
    global_scan_tiles_kernel(uint32_t* __restrict__ counts, uint32_t* __restrict__ tile_sums) {
  uint4* c = reinterpret_cast<uint4*>(counts + (static_cast<int64_t>(blockIdx.x) << kTileBits)) +
             threadIdx.x;
  const uint4 v = *c;
  uint32_t total;
  const uint32_t e = block_exclusive_scan<32>(v.x + v.y + v.z + v.w, &total);
  *c = make_uint4(e, e + v.x, e + v.x + v.y, e + v.x + v.y + v.z);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// tile_sums -> their exclusive prefix (ntiles <= kScanThreads)
__global__ void __launch_bounds__(kScanThreads)
    global_scan_top_kernel(uint32_t* __restrict__ tile_sums, int ntiles) {
  const bool mine = static_cast<int>(threadIdx.x) < ntiles;
  uint32_t total;
  const uint32_t e = block_exclusive_scan<32>(mine ? tile_sums[threadIdx.x] : 0u, &total);
  if (mine) tile_sums[threadIdx.x] = e;
}

// Each query's record at tile_off[tile] + cursor[bucket]++ (the cursor starts
// at the bucket's prefix within its tile), a warp's lanes of one bucket
// adding once
__global__ void __launch_bounds__(kThreads)
    global_scatter_kernel(const int32_t* __restrict__ xi, const int32_t* __restrict__ yi,
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
    base = __shfl_sync(kFull, base, leader);
    pos = base + __popc(peers & ((1u << lane) - 1u));
  }
  const Fields f = fields_of(txh, txl, tyh, tyl, i, active);
  write_records(rec, active, pos, v, static_cast<int32_t>(i), f);
}

// -- the shared form --------------------------------------------------------------------
// Block g takes the queries [g chunk, (g + 1) chunk), kAhead tiles of
// kSharedThreads at a time: each thread issues the loads of its kAhead
// queries before it waits for any.  Each lane adds to its bucket's shared
// count or cursor itself: the lanes of one bucket are serialised by the
// shared memory, which costs less than grouping them (__match_any_sync).
constexpr int kAhead = 4;

__device__ __forceinline__ void chunk_of(int64_t n, int64_t chunk, int64_t* start, int64_t* end) {
  *start = blockIdx.x * chunk;
  *end = *start + chunk < n ? *start + chunk : n;
}

// hist[g nb + b] = the queries of bucket b in block g's chunk.  Block 0 also
// zeroes the scan's count of tiles done.
__global__ void __launch_bounds__(kSharedThreads)
    shared_count_kernel(const int32_t* __restrict__ xi, const int32_t* __restrict__ yi,
                        int64_t row_step, int64_t lo, int64_t rows, int shift, int64_t n,
                        int64_t chunk, int nb, uint32_t* __restrict__ hist,
                        uint32_t* __restrict__ done) {
  extern __shared__ uint32_t s_count[];
  for (int b = threadIdx.x; b < nb; b += kSharedThreads) s_count[b] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *done = 0;
  __syncthreads();
  int64_t start, end;
  chunk_of(n, chunk, &start, &end);
  for (int64_t base = start; base < end; base += kAhead * kSharedThreads) {
    int32_t b[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = base + u * kSharedThreads + threadIdx.x;
      b[u] = i < end ? bucket_of(row_value(xi, yi, i, row_step, lo, rows), shift) : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (b[u] >= 0) atomicAdd(s_count + b[u], 1u);
  }
  __syncthreads();
  uint32_t* row = hist + static_cast<int64_t>(blockIdx.x) * nb;
  for (int b = threadIdx.x; b < nb; b += kSharedThreads) row[b] = s_count[b];
}

// 32 buckets a block, the blocks' rows of the table cut in kSegments
// segments: thread (segment s, bucket b) loads its segment of bucket b's
// column at once.  hist[g nb + b] -> the queries of bucket b in blocks before
// g; bucket_start[b] = the queries of the buckets before b in its tile of 32;
// tile_sums -> the tiles' offsets (scan_sums_if_last).
constexpr int kSegments = 8;
constexpr int kSegmentMax = 32;  // rows a segment: blocks <= 256

__global__ void __launch_bounds__(32 * kSegments)
    shared_scan_kernel(uint32_t* __restrict__ hist, int blocks, int nb,
                       uint32_t* __restrict__ bucket_start, uint32_t* __restrict__ tile_sums,
                       uint32_t* __restrict__ done, int nscan) {
  __shared__ uint32_t s_segment[kSegments][32];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (blocks + kSegments - 1) / kSegments;
  const int g0 = seg * per;
  uint32_t c[kSegmentMax];
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < kSegmentMax; ++k) {
    const int g = g0 + k;
    c[k] = b < nb && k < per && g < blocks ? hist[static_cast<int64_t>(g) * nb + b] : 0u;
    sum += c[k];
  }
  s_segment[seg][lane] = sum;
  __syncthreads();
  uint32_t run = 0, total = 0;
#pragma unroll
  for (int s = 0; s < kSegments; ++s) {
    const uint32_t t = s_segment[s][lane];
    run += s < seg ? t : 0u;
    total += t;
  }
#pragma unroll
  for (int k = 0; k < kSegmentMax; ++k) {
    const int g = g0 + k;
    if (b < nb && k < per && g < blocks) hist[static_cast<int64_t>(g) * nb + b] = run;
    run += c[k];
  }
  if (seg == 0) {  // warp 0: the 32 buckets' totals, scanned
    uint32_t x = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (b < nb) bucket_start[b] = x - total;
    if (lane == 31) tile_sums[blockIdx.x] = x;
  }
  __syncthreads();
  scan_sums_if_last<kSegments>(tile_sums, done, nscan);
}

// Each query of block g's chunk at tile_off[b >> 5] + bucket_start[b] +
// hist[g nb + b] + its rank among the block's queries of bucket b
__global__ void __launch_bounds__(kSharedThreads)
    shared_scatter_kernel(const int32_t* __restrict__ xi, const int32_t* __restrict__ yi,
                          int64_t row_step, int64_t lo, int64_t rows, int shift,
                          const float* __restrict__ txh, const float* __restrict__ txl,
                          const float* __restrict__ tyh, const float* __restrict__ tyl,
                          int64_t n, int64_t chunk, int nb, const uint32_t* __restrict__ hist,
                          const uint32_t* __restrict__ bucket_start,
                          const uint32_t* __restrict__ tile_off, int4* __restrict__ rec) {
  extern __shared__ uint32_t s_cursor[];
  const uint32_t* row = hist + static_cast<int64_t>(blockIdx.x) * nb;
  for (int b = threadIdx.x; b < nb; b += kSharedThreads)
    s_cursor[b] = __ldg(tile_off + (b >> 5)) + __ldg(bucket_start + b) + __ldg(row + b);
  __syncthreads();
  int64_t start, end;
  chunk_of(n, chunk, &start, &end);
  for (int64_t base = start; base < end; base += kAhead * kSharedThreads) {
    int32_t v[kAhead];
    Fields f[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = base + u * kSharedThreads + threadIdx.x;
      v[u] = i < end ? row_value(xi, yi, i, row_step, lo, rows) : 0;
      f[u] = fields_of(txh, txl, tyh, tyl, i, i < end);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = base + u * kSharedThreads + threadIdx.x;
      const bool active = i < end;
      const uint32_t pos = active ? atomicAdd(s_cursor + bucket_of(v[u], shift), 1u) : 0u;
      write_records(rec, active, pos, v[u], static_cast<int32_t>(i), f[u]);
    }
  }
}

// A kernel's dynamic shared memory is opened once a device and kernel to what
// it asks, and kept
template <class Kernel>
cudaError_t open_shared(Kernel kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> opened;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& have = opened[std::make_pair(reinterpret_cast<const void*>(kernel), dev)];
  if (bytes > have) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    have = bytes;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// xi, yi (n,) int32 from K7 (yi null: 1-D); the four fraction halves (n,)
// float32 (ty_hi, ty_lo null: 1-D); work, int32, by form:
//   form 0 (global): counts (ntiles * 4096, ntiles = ceil(buckets / 4096))
//     zeroed by the caller, then the tiles' sums (ntiles); `blocks` = ntiles;
//   form 1 (shared): hist (blocks * nb), bucket_start (nb), the tiles' sums
//     (ceil(nb / 32)) and a count (1), with `blocks` (at most 256) blocks of
//     1,024 threads;
// out: rec (n, 8) int32 in bucket order.
int ndi_cell_order_f32(const void* xi, const void* yi, int64_t row_step, int64_t lo,
                       int64_t rows, int64_t shift, const void* txh, const void* txl,
                       const void* tyh, const void* tyl, void* work, int64_t blocks,
                       int64_t form, void* rec, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* x = static_cast<const int32_t*>(xi);
  const int32_t* y = static_cast<const int32_t*>(yi);
  const float* th = static_cast<const float*>(txh);
  const float* tl = static_cast<const float*>(txl);
  const float* uh = static_cast<const float*>(tyh);
  const float* ul = static_cast<const float*>(tyl);
  uint32_t* w = static_cast<uint32_t*>(work);
  int4* out = static_cast<int4*>(rec);
  const int sh = static_cast<int>(shift);
  cudaError_t err;
  if (form == 0) {
    const int nt = static_cast<int>(blocks);
    const unsigned int grid = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
    uint32_t* tile_sums = w + (static_cast<int64_t>(nt) << kTileBits);
    global_count_kernel<<<grid, kThreads, 0, s>>>(x, y, row_step, lo, rows, sh, n, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    global_scan_tiles_kernel<<<static_cast<unsigned int>(nt), kScanThreads, 0, s>>>(w,
                                                                                   tile_sums);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    global_scan_top_kernel<<<1, kScanThreads, 0, s>>>(tile_sums, nt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    global_scatter_kernel<<<grid, kThreads, 0, s>>>(x, y, row_step, lo, rows, sh, th, tl, uh, ul,
                                                    n, w, tile_sums, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int nb = static_cast<int>(((rows - 1) >> shift) + 1);
  const int nscan = (nb + 31) / 32;
  uint32_t* hist = w;
  uint32_t* bucket_start = hist + blocks * nb;
  uint32_t* tile_sums = bucket_start + nb;
  uint32_t* done = tile_sums + nscan;
  const int64_t chunk = (n + blocks - 1) / blocks;
  const size_t smem = static_cast<size_t>(nb) * sizeof(uint32_t);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if ((err = open_shared(shared_count_kernel, smem)) != cudaSuccess) return static_cast<int>(err);
  shared_count_kernel<<<grid, kSharedThreads, smem, s>>>(x, y, row_step, lo, rows, sh, n, chunk,
                                                         nb, hist, done);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  shared_scan_kernel<<<static_cast<unsigned int>(nscan), 32 * kSegments, 0, s>>>(
      hist, static_cast<int>(blocks), nb, bucket_start, tile_sums, done, nscan);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = open_shared(shared_scatter_kernel, smem)) != cudaSuccess)
    return static_cast<int>(err);
  shared_scatter_kernel<<<grid, kSharedThreads, smem, s>>>(x, y, row_step, lo, rows, sh, th, tl,
                                                           uh, ul, n, chunk, nb, hist,
                                                           bucket_start, tile_sums, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
