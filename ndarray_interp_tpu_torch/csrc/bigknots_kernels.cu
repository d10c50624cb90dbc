// Long-knot-axis 1-D evaluation kernels for Hopper (sm_90a): axes of more than
// 65,536 knots, where the JAX package leaves the one-pass search kernels.
//
// R3     big_eval        replaces the Pallas kernel ndarray_interp_tpu/ops/bigknots.py
//                        _refine_kernel (and the search and block-row gather around
//                        it, big_eval_1d): the lower-interval index of each query,
//                        its interval's row, and the symmetric Hermite form with the
//                        +-inf lerp of linear tables.
// R3idx  big_index_frac  the same search emitting (idx, t) (big_lower_index_frac),
//                        which feeds the banked routes: K2's staged kernel
//                        (staged_index.cuh) on R3's leader tree.
//
// The TPU route is three passes: a search of the block leaders (one knot of
// every W), an XLA gather of the block's packed row [knots | data | a | b]
// (C, 4W+2), and a refine that counts the block's knots <= q and selects the
// interval's values with one-hot masks.  On this card one launch does all of
// it, and no packed row table is built: R3 runs K1's body (staged_eval1d.cuh)
// with a row source that reads the interval's two knots, two data values and
// a, b straight from the four 1-D arrays.  Each block stages every w-th knot
// as search.cuh's breadth-first tree in shared memory (the route's axes, past
// 65,536 knots, never fit whole), its threads stride over the queries, walk
// the tree, and end the search between two leaders on the knot array (L2).
// w is the least power of two that fits the wrapper's budget, so the knots
// between two leaders lie in one aligned run (64 bytes at NS1b: every 16th of
// 262,144 f32 knots in a 128 KB tree of 16,384 leaders).
//
// What bounds it: each query is a chain of dependent loads (15 shared-memory
// levels, log2 w L2 steps, then the six row values), so the kernel is bound by
// that latency, hidden by the warps in flight, and not by the 12 bytes a
// query (f32: q in, value out, 4 for the search's share of the knots) that
// stream.  On an H100 80GB HBM3 at 700 W (tools/search_phases.py --sweeps,
// 1M f32 queries, ms), the 128 KB tree against the first design (kept at
// budget 0: a block stages the 512 leaders knots[0], knots[W], ... of 2 KB
// once, big_lower_index binary-searches them, then the W knots of the block;
// W = 512 at 262,144 knots): 65,537 knots 0.0450 / 0.0583, 262,144 0.0509 /
// 0.0772, 8,388,480 0.1672 / 0.1685 (134 MB of arrays, past the L2); f64
// 0.0468 / 0.0681 and 0.0569 / 0.0898.  At 262,144 the trees of 16, 32 and
// 64 KB (every 128th, 64th and 32nd knot) took 0.0791, 0.0785 and 0.0802;
// in an earlier run the 128 KB tree strided by the budget alone (every 9th
// knot, 29,128 leaders) took 0.0549 where every 16th took 0.0504: the
// 15-level tree and the power-of-two stride both pay.  The design before the
// first, 8,192 leaders at 4 blocks per SM, took 0.1226.
//
// R3idx is the same search without the four row loads: K2's staged kernel
// (staged_index_kernel<T, false, true>) on R3's tree, the same power-of-two
// stride (staged_axis with pow2), t's endpoints read from the knot array
// (the tree holds only leaders).  It writes 8 bytes a query (idx, t) where
// R3 writes 4.  Its first design, the 512 sorted leaders and
// big_lower_index, stays beside it at budget 0 for timing: at 65,537 f32
// knots x 1M it took 0.0290 ms against the tree's 0.0350, at 262,144 0.0519
// against 0.0416 (tools/search_phases.py, H100 80GB HBM3, 700 W); the wrapper
// stages the tree at every length (ops/bigknots.py).
//
// Numerics.  The index is the global upper bound minus one, clamped to
// [0, n-2], exactly torch.searchsorted(right=True) - 1 as in K1-K3: the leader
// search finds the block whose first knot is the last leader <= q, and the
// count inside it completes the count of knots <= q.  A NaN query gives n-2
// as K2 does (the JAX package's TPU search gives 0; both outputs are NaN).
// The mask-sum select of the TPU refine NaNs a whole W-knot block on one NaN
// datum (the D5 hazard of tests/test_bigknots.py); a load here reads only its
// own interval, so a NaN datum reaches only the queries of its two intervals.
// The arithmetic is K1's, in the plain versions' operation order, with
// --fmad=false: R3 is bit-identical to K1's plain version and R3idx to K2's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_eval1d.cuh"  // R3 on K1's body and the staged search
#include "staged_index.cuh"   // R3idx on K2's staged kernel

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 8 x 256 threads: the SM's 2,048
constexpr int kLeaderBytes = 2048;  // shared memory for the leaders

struct Geometry {
  int64_t w;  // knots per block of the leader search
  int64_t c;  // leaders: ceil(n / w)
};

// The smallest power-of-two w >= 16 whose leaders fit kLeaderBytes.
Geometry geometry(int64_t n, int64_t elem) {
  const int64_t cap = kLeaderBytes / elem;
  int64_t w = 16;
  while ((n + w - 1) / w > cap) w *= 2;
  return {w, (n + w - 1) / w};
}

// Stage knots[0], knots[w], ... knots[(c-1) w] in shared memory.
template <typename T>
__device__ __forceinline__ void stage_leaders(const T* __restrict__ knots, int64_t w, int c,
                                              T* lead) {
  for (int j = threadIdx.x; j < c; j += blockDim.x) lead[j] = __ldg(knots + j * w);
  __syncthreads();
}

// Clamped lower-interval index of q: count of knots <= q, minus one, in [0, n-2].
template <typename T>
__device__ __forceinline__ int64_t big_lower_index(const T* __restrict__ knots, int64_t n,
                                                   const T* lead, int c, int64_t w, T q) {
  if (q != q) return n - 2;  // NaN
  int lo = 0, hi = c;        // leaders <= q
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lead[mid] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo == 0) return 0;  // below the first knot
  // knots[base] <= q, and knots[base + w] > q where it exists: the upper
  // bound lies in (base, min(base + w, n)]
  const int64_t base = (lo - 1) * w;
  int64_t l2 = base + 1;
  int64_t h2 = base + w < n ? base + w : n;
  while (l2 < h2) {
    const int64_t mid = (l2 + h2) >> 1;
    if (__ldg(knots + mid) <= q) {
      l2 = mid + 1;
    } else {
      h2 = mid;
    }
  }
  const int64_t idx = l2 - 1;
  return idx > n - 2 ? n - 2 : idx;
}

// R3's first design: the sorted leaders, big_lower_index; kept so that every
// run times it beside the staged kernel (shared_knots = 0)
template <typename T>
__global__ void big_eval_kernel(const T* __restrict__ knots, int64_t n, int64_t w, int c,
                                const T* __restrict__ data, const T* __restrict__ a,
                                const T* __restrict__ b, const T* __restrict__ q,
                                T* __restrict__ out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lead = reinterpret_cast<T*>(smem);
  stage_leaders(knots, w, c, lead);
  const T one = T(1);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T qi = q[i];
    const int64_t k = big_lower_index(knots, n, lead, c, w, qi);
    const T x_l = __ldg(knots + k);
    const T x_r = __ldg(knots + k + 1);
    const T y_l = __ldg(data + k);
    const T y_r = __ldg(data + k + 1);
    const T av = __ldg(a + k);
    const T bv = __ldg(b + k);
    const T t = (qi - x_l) / (x_r - x_l);
    // symmetric Hermite form, cubic_spline.rs:818-828
    const T base = (one - t) * y_l + t * y_r + t * (one - t) * (av * (one - t) + bv * t);
    // a linear table (a = b = 0) extrapolates to +-inf like calc_frac
    const bool lin_inf = isinf(t) && av == T(0) && bv == T(0);
    out[i] = lin_inf ? y_l + t * (y_r - y_l) : base;
  }
}

// R3idx's first design: the sorted leaders, big_lower_index (shared_knots = 0)
template <typename T>
__global__ void big_index_frac_kernel(const T* __restrict__ knots, int64_t n, int64_t w, int c,
                                      const T* __restrict__ q, int32_t* __restrict__ idx_out,
                                      T* __restrict__ t_out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lead = reinterpret_cast<T*>(smem);
  stage_leaders(knots, w, c, lead);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T qi = q[i];
    const int64_t k = big_lower_index(knots, n, lead, c, w, qi);
    const T x_l = __ldg(knots + k);
    const T x_r = __ldg(knots + k + 1);
    idx_out[i] = static_cast<int32_t>(k);
    t_out[i] = (qi - x_l) / (x_r - x_l);
  }
}

// A few blocks per SM, fewer when the queries do not need them.
inline unsigned int grid_for(int64_t nq) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t need = (nq + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<unsigned int>(need < most ? need : most);
}

// R3's rows: the interval's values read from the four 1-D arrays, as the
// first design reads them
template <typename T>
struct ArrayRows {
  const T* knots;
  const T* data;
  const T* a;
  const T* b;

  static size_t staged_bytes(int) { return 0; }

  __device__ __forceinline__ void stage(T*, int) {}

  __device__ __forceinline__ void load(int k, T v[6]) const {
    v[0] = __ldg(knots + k);
    v[1] = __ldg(knots + k + 1);
    v[2] = __ldg(data + k);
    v[3] = __ldg(data + k + 1);
    v[4] = __ldg(a + k);
    v[5] = __ldg(b + k);
  }
};

// R3's and R3idx's axis on a tree of at most shared_knots knots (capped at the
// largest a block holds; at least 1: every level on the global axis), every
// w-th knot for the least power of two w that fits
template <typename T>
cudaError_t big_axis(const void* knots, int64_t n, int64_t shared_knots, StagedAxis<T>* ax) {
  int64_t budget = 1;
  const cudaError_t err = tree_budget(shared_knots, sizeof(T), &budget);
  if (err == cudaSuccess) *ax = staged_axis<T>(knots, n, budget, true);
  return err;
}

// R3 on K1's body on that tree; at shared_knots = 0 the first design
template <typename T>
int big_eval(const void* knots, int64_t n, const void* data, const void* a, const void* b,
             int64_t shared_knots, const void* q, void* out, int64_t nq, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const T* qq = static_cast<const T*>(q);
  T* o = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* k = static_cast<const T*>(knots);
  const T* d = static_cast<const T*>(data);
  const T* aa = static_cast<const T*>(a);
  const T* bb = static_cast<const T*>(b);
  if (shared_knots == 0) {
    const Geometry g = geometry(n, sizeof(T));
    big_eval_kernel<T><<<grid_for(nq), kThreads, g.c * sizeof(T), s>>>(
        k, n, g.w, static_cast<int>(g.c), d, aa, bb, qq, o, nq);
    return static_cast<int>(cudaGetLastError());
  }
  StagedAxis<T> ax;
  cudaError_t err = big_axis(knots, n, shared_knots, &ax);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ArrayRows<T> rows{k, d, aa, bb};
  err = ax.w == 1 ? staged_eval1d<T, true>(ax, rows, qq, o, nq, s)
                  : staged_eval1d<T, false>(ax, rows, qq, o, nq, s);
  return static_cast<int>(err);
}

// R3idx on K2's staged kernel on that tree; at shared_knots = 0 the first design
template <typename T>
int big_index_frac(const void* knots, int64_t n, int64_t shared_knots, const void* q, void* idx,
                   void* t, int64_t nq, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const T* qq = static_cast<const T*>(q);
  int32_t* ix = static_cast<int32_t*>(idx);
  T* tt = static_cast<T*>(t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared_knots == 0) {
    const Geometry g = geometry(n, sizeof(T));
    big_index_frac_kernel<T><<<grid_for(nq), kThreads, g.c * sizeof(T), s>>>(
        static_cast<const T*>(knots), n, g.w, static_cast<int>(g.c), qq, ix, tt, nq);
    return static_cast<int>(cudaGetLastError());
  }
  StagedAxis<T> ax;
  cudaError_t err = big_axis(knots, n, shared_knots, &ax);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ax.w == 1 ? staged_index<T, true, true>(ax, qq, ix, tt, nq, s)
                  : staged_index<T, false, true>(ax, qq, ix, tt, nq, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// R3: knots, n, data, a, b, shared_knots (the most knots a block stages; 1:
// every level of the search on the global axis; 0: the first design), q, out, nq
int ndi_big_eval_f32(const void* knots, int64_t n, const void* data, const void* a, const void* b,
                     int64_t shared_knots, const void* q, void* out, int64_t nq, void* stream) {
  return big_eval<float>(knots, n, data, a, b, shared_knots, q, out, nq, stream);
}

int ndi_big_eval_f64(const void* knots, int64_t n, const void* data, const void* a, const void* b,
                     int64_t shared_knots, const void* q, void* out, int64_t nq, void* stream) {
  return big_eval<double>(knots, n, data, a, b, shared_knots, q, out, nq, stream);
}

// R3idx: knots, n, shared_knots (as R3's), q, idx, t, nq
int ndi_big_index_frac_f32(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                           void* idx, void* t, int64_t nq, void* stream) {
  return big_index_frac<float>(knots, n, shared_knots, q, idx, t, nq, stream);
}

int ndi_big_index_frac_f64(const void* knots, int64_t n, int64_t shared_knots, const void* q,
                           void* idx, void* t, int64_t nq, void* stream) {
  return big_index_frac<double>(knots, n, shared_knots, q, idx, t, nq, stream);
}

}  // extern "C"
