// What the double-float tails share (df_kernels.cu K6-K9, df2d_kernels.cu
// K10-K14): the widening of a pair, the two store forms of a result, W-wide
// loads and stores, and the query slots of the tails that run on the
// ordered records of cell_order.cu (bank_kernels.cu's K5 and R2a take the loads
// and stores too).
//
// Store forms.  A tail computes its result r in FP64 and splits it into the
// pair (hi, lo) of ops/df.py df_from_f64: hi = (float)r, lo = (float)(r - hi),
// lo = 0 where hi is not finite.  PairOut writes the pair to two float32
// arrays, as the JAX package's kernels return it.  F64Out writes
// (double)hi + (double)lo of that same pair to one float64 array: bit for bit
// ops/df.py df_to_f64 of the pair, which is what the evaluators returned after
// recombining it (not the unsplit r, which would be more accurate and another
// value).  It saves the evaluators two widening copies and an add over the
// (Q, bank) result.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double widen(float hi, float lo) {
  return static_cast<double>(hi) + static_cast<double>(lo);
}

// the lo half of r's pair whose hi half is hi = (float)r
__device__ __forceinline__ float split_lo(double r, float hi) {
  return isfinite(hi) ? static_cast<float>(r - static_cast<double>(hi)) : 0.0f;
}

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
  __device__ static void store(double* __restrict__ p, const double* v) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
  // evict-first (st.global.cs): for output the kernel writes once and never reads
  __device__ static void store_cs(float* __restrict__ p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* __restrict__ p, float* v) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void load(const double* __restrict__ p, double* v) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(float* __restrict__ p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
  __device__ static void store(double* __restrict__ p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
  __device__ static void store_cs(double* __restrict__ p, const double* v) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
};
template <>
struct Vec<1> {
  __device__ static void load(const float* __restrict__ p, float* v) { v[0] = __ldg(p); }
  __device__ static void load(const double* __restrict__ p, double* v) { v[0] = __ldg(p); }
  __device__ static void store(float* __restrict__ p, const float* v) { *p = v[0]; }
  __device__ static void store(double* __restrict__ p, const double* v) { *p = v[0]; }
  __device__ static void store_cs(float* __restrict__ p, const float* v) { __stcs(p, v[0]); }
  __device__ static void store_cs(double* __restrict__ p, const double* v) { __stcs(p, v[0]); }
};

// The pair (h, l) of W results at element i, as two float32 arrays
struct PairOut {
  float* hi;
  float* lo;
  template <int W>
  __device__ void put(int64_t i, const float* h, const float* l) const {
    Vec<W>::store(hi + i, h);
    Vec<W>::store(lo + i, l);
  }
};

// ... or as one float64 array of h + l
struct F64Out {
  double* out;
  template <int W>
  __device__ void put(int64_t i, const float* h, const float* l) const {
    double v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = widen(h[j], l[j]);
    Vec<W>::store(out + i, v);
  }
};

// W results r split into their pairs and stored at element i
template <int W, class Out>
__device__ __forceinline__ void store_split(const Out& out, int64_t i, const double* r) {
  float h[W], l[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    h[j] = static_cast<float>(r[j]);
    l[j] = split_lo(r[j], h[j]);
  }
  out.template put<W>(i, h, l);
}

// -- W-wide lanes (R2a, R2b, R2g) -------------------------------------------------------
// A query's W channels a lane with 16-byte loads and stores where its row
// blocks allow them: both strides multiples of W and the table's base 16-byte
// aligned.
template <int W>
bool wide_lanes(const void* base, int64_t a, int64_t b) {
  return a % W == 0 && b % W == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// The launch shape of a query's `chunks` lanes: up to 32 lanes a query
// (threadIdx.x), as many queries as fill a block of kThreads (threadIdx.y)
struct LaneGrid {
  dim3 grid, block;
};

inline LaneGrid lane_grid(int64_t chunks, int64_t nq) {
  const int lanes = static_cast<int>(chunks < 32 ? chunks : 32);
  const int per_block = kThreads / lanes;
  return {dim3(static_cast<unsigned int>((nq + per_block - 1) / per_block),
               static_cast<unsigned int>((chunks + lanes - 1) / lanes)),
          dim3(lanes, per_block)};
}

// -- the ordered tails' query slots ----------------------------------------------------
// Records come from cell_order.cu in bucket order, 32 bytes each:
// [v, qid, t0_hi, t0_lo, t1_hi, t1_lo, 0, 0] (the halves' bits; a 1-D record
// has t1 = 0).  A warp takes 32 / L slots of L lanes (L = a query's chunks of
// W channels, at most 32; the lanes past them idle), each slot one query or
// one group of consecutive queries, each lane one chunk at a time.

// This lane's slot in its warp: query (or group) q of n (valid only below n
// and in the warp's 32 / size slots), lane `sub` of the `size` lanes that
// start at lane `leader`.
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

// the grid of an ordered kernel: whole warps of 32 / L slots each, n slots
inline unsigned int ordered_blocks(int64_t chunks, int64_t n) {
  const int64_t per_warp = 32 / (chunks < 32 ? chunks : 32);
  const int64_t warps = (n + per_warp - 1) / per_warp;
  return static_cast<unsigned int>((warps * 32 + kThreads - 1) / kThreads);
}

}  // namespace
