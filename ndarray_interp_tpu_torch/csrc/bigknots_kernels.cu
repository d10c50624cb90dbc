// Long-knot-axis 1-D evaluation kernels for Hopper (sm_90a): axes of more than
// 65,536 knots, where the JAX package leaves the one-pass search kernels.
//
// R3     big_eval        replaces the Pallas kernel ndarray_interp_tpu/ops/bigknots.py
//                        _refine_kernel (and the search and block-row gather around
//                        it, big_eval_1d): the lower-interval index of each query,
//                        its interval's row, and the symmetric Hermite form with the
//                        +-inf lerp of linear tables.
// R3idx  big_index_frac  the same search emitting (idx, t) (big_lower_index_frac),
//                        which feeds the banked routes.
//
// The TPU route is three passes: a search of the block leaders (one knot of
// every W), an XLA gather of the block's packed row [knots | data | a | b]
// (C, 4W+2), and a refine that counts the block's knots <= q and selects the
// interval's values with one-hot masks.  On this card one launch does all of
// it: a block stages the leader vector knots[0], knots[W], knots[2W], ...
// (at most kLeaderBytes: 512 f32 leaders) in shared memory once, then its
// threads stride over the queries; each binary-searches the leaders in shared
// memory, then the W knots of its block in the knot array (L2), then reads the
// interval's two knots, two data values and a, b straight from the 1-D arrays.
// No packed row table is built.  The kernel picks its own W, the smallest
// power of two >= 16 whose leader vector fits kLeaderBytes (W = 512 at 262,144
// knots, 16,384 at the 8,388,480 of MAX_BIG_KNOTS): the result does not depend
// on W.  The grid is kBlocksPerSm blocks per SM (full occupancy), so the
// leader vector is staged once per block, not once per 256 queries.
//
// What bounds it: each query is a chain of dependent loads (log2 C shared-
// memory steps, log2 W L2 steps, then the row), so the kernel is bound by that
// latency, hidden by the warps in flight, and not by the 12 bytes a query
// (f32: q in, value out, 4 for the search's share of the knots) that stream.
// On the H100 a larger leader vector was slower, not faster: the first
// design, 8,192 leaders at 4 blocks per SM, took 0.1226 ms at 262,144 knots x
// 1,000,000 queries where K1 takes 0.0732 (chip_smoke.py): the strided
// staging and the bank conflicts of a random search in shared memory cost
// more than the L2 steps they save.  This design's time is in PERF.md.
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

template <typename T>
int big_eval(const void* knots, int64_t n, const void* data, const void* a, const void* b,
             const void* q, void* out, int64_t nq, void* stream) {
  if (nq > 0) {
    const Geometry g = geometry(n, sizeof(T));
    big_eval_kernel<T><<<grid_for(nq), kThreads, g.c * sizeof(T),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(knots), n, g.w, static_cast<int>(g.c), static_cast<const T*>(data),
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(q),
        static_cast<T*>(out), nq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int big_index_frac(const void* knots, int64_t n, const void* q, void* idx, void* t, int64_t nq,
                   void* stream) {
  if (nq > 0) {
    const Geometry g = geometry(n, sizeof(T));
    big_index_frac_kernel<T><<<grid_for(nq), kThreads, g.c * sizeof(T),
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(knots), n, g.w, static_cast<int>(g.c), static_cast<const T*>(q),
        static_cast<int32_t*>(idx), static_cast<T*>(t), nq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ndi_big_eval_f32(const void* knots, int64_t n, const void* data, const void* a, const void* b,
                     const void* q, void* out, int64_t nq, void* stream) {
  return big_eval<float>(knots, n, data, a, b, q, out, nq, stream);
}

int ndi_big_eval_f64(const void* knots, int64_t n, const void* data, const void* a, const void* b,
                     const void* q, void* out, int64_t nq, void* stream) {
  return big_eval<double>(knots, n, data, a, b, q, out, nq, stream);
}

int ndi_big_index_frac_f32(const void* knots, int64_t n, const void* q, void* idx, void* t,
                           int64_t nq, void* stream) {
  return big_index_frac<float>(knots, n, q, idx, t, nq, stream);
}

int ndi_big_index_frac_f64(const void* knots, int64_t n, const void* q, void* idx, void* t,
                           int64_t nq, void* stream) {
  return big_index_frac<double>(knots, n, q, idx, t, nq, stream);
}

}  // extern "C"
