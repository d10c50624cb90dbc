// Double-float InterpND tail kernel for Hopper (sm_90a), in native FP64.
//
// K15 df_nd_tail / f48_nd_tail  replaces the Pallas kernel
//     ndarray_interp_tpu/ops/pallas_eval_df_nd.py _df_nd_mxu_kernel (nd_df_tail_mxu,
//     tiers df and f48): the k-axis tensor-product Hermite (nbasis 4, the cubic
//     cell layout) or multilinear (nbasis 2) form on the packed cell rows of a
//     pack_rows_nd_df / pack_rows_nd_f48 table.
//
// What it computes, not how the TPU computed it.  The TPU kernel had no float64:
// it built the (nb, B) weight matrix channel-major with one-hot HIGHEST-precision
// matrix products, multiplied it into the rows with error-free two_prod and summed
// with a compensated halving tree, in two layouts (bp == 1 fully channel-major, bp
// > 1 with a row-major weight row).  Here one design serves every bp: each thread
// takes one (query, channel) element, widens every pair once, (double)hi +
// (double)lo (exact for pairs df_from_f64 made), and computes in double what the
// plain version _df_nd_tail (ops/eval_kernels_df_nd.py) computes:
//   * per axis d the basis of t_d: _cubic_basis, [(1-t)^2 (1+2t), t^2 (3-2t),
//     t (1-t)^2, -t^2 (1-t)], or [1-t, t];
//   * the weight of channel j (one base-nbasis digit per axis, axis 0 most
//     significant, the pack's order) folded axis 0 first: b_0[j_0] b_1[j_1] ...;
//   * the products w_j z_j summed by the plain version's halving tree
//     p[:h] + p[h:].  That tree is the pairwise sum of the products taken in
//     bit-reversed channel order, so the thread walks j = bitrev(i) and merges a
//     stack of partial sums as a binary counter (at most 2 k + 1 entries).
// The result is split back into a pair (lo = 0 where hi is not finite).  With
// --fmad=false the kernel is bit-identical to the plain version.  The f48 rows
// carry the lo halves as bf16, block j in the high 16 bits of lane j (mod nb/2)
// for j < nb/2 and in the low 16 bits above; a mask and a shift unpack them, as
// in K9, K11 and K13.
//
// Layout.  The kernel takes the table, the (k, nq) interval indices (K7's, one row
// per axis), the k cell strides (by value), the (k, nq) fraction halves, and
// gathers the cell row sum_d idx_d stride_d itself (clamped to the table as the
// plain version clamps it): the (Q, 2 nb bp) gathered rows of the JAX route (512
// MB at 1M queries for a tricubic scalar grid) are never written.  It handles any
// k up to kMaxAxes (the wrapper raises above it) and writes a (Q, bp) pair.
//
// Two designs, as the JAX kernel has two layouts:
//   * bp > 1 (nd_tail_kernel): one thread per (query, channel); neighbouring
//     threads read neighbouring channels of a block.
//   * bp = 1 and nb >= 32 (nd_warp_kernel): one warp per query, so that the row
//     is read coalesced.  Lane l takes the channels j = l + 32 m.  The halving tree's
//     levels with h >= 32 pair channels of one lane (pairwise over m, bit-reversed,
//     as above); the last five levels pair lane l with lane l + h, which is
//     __shfl_down_sync.  The bases live in shared memory, one set per warp.
//   A thread per query measured 4.14 ms at ND3 (64^3, cubic, nb = 64, 1M queries,
//   H100) against its plain version's 3.66 and the warp's 0.715: each thread read
//   its own 512 B row, uncoalesced, with its bases and partial sums in local
//   memory.  At nb = 8 (trilinear) the warp leaves 24 lanes idle and the thread
//   per query is faster (0.148 against 0.474 ms), so it keeps nb < 32.
//
// What bounds it on this card: bytes, by the count of the guide's bound (each
// input byte once): the table, 12 k bytes of idx and t a query and 8 bytes out
// per channel.  The work really moves each query's whole row, 2 nb bp floats
// (512 B for a tricubic scalar grid), from HBM once the table is past the 50 MB
// L2, and does about (k + 4) nb FP64 operations per channel.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxAxes = 6;  // ops/_cuda.py MAX_ND_AXES

// the cell strides, passed by value (ops/_cuda.py NdStrides)
struct NdStrides {
  int64_t s[kMaxAxes];
};

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

// _nd_basis: the Hermite basis for pre-scaled derivatives, or the multilinear one
template <int NBASIS>
__device__ __forceinline__ void basis(double t, double* b) {
  if (NBASIS == 4) {
    const double omt = 1.0 - t;
    b[0] = omt * omt * (1.0 + 2.0 * t);
    b[1] = t * t * (3.0 - 2.0 * t);
    b[2] = t * omt * omt;
    b[3] = -t * t * omt;
  } else {
    b[0] = 1.0 - t;
    b[1] = t;
  }
}

// One thread per (query, channel) element e = qi bp + c of the (nq, bp) output.
template <int NBASIS, bool F48>
__global__ void nd_tail_kernel(const float* __restrict__ packed, int64_t rows, int64_t ch,
                               int64_t bp, int k, NdStrides strides,
                               const int32_t* __restrict__ idx, const float* __restrict__ th,
                               const float* __restrict__ tl, float* __restrict__ out_hi,
                               float* __restrict__ out_lo, int64_t nq, int64_t n) {
  constexpr int kBits = NBASIS == 4 ? 2 : 1;  // bits of one axis digit
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t qi = e / bp;
  const int64_t c = e - qi * bp;
  double b[kMaxAxes][NBASIS];
  int64_t cell = 0;
  for (int d = 0; d < k; ++d) {
    cell += static_cast<int64_t>(__ldg(idx + d * nq + qi)) * strides.s[d];
    basis<NBASIS>(widen(__ldg(th + d * nq + qi), __ldg(tl + d * nq + qi)), b[d]);
  }
  cell = cell < 0 ? 0 : (cell >= rows ? rows - 1 : cell);
  const float* row = packed + cell * ch + c;
  const int levels = k * kBits;
  const int nb = 1 << levels;
  double partial[2 * kMaxAxes + 1];
  int top = 0;
  for (int i = 0; i < nb; ++i) {
    const int j = static_cast<int>(__brev(static_cast<unsigned int>(i)) >> (32 - levels));
    double w = b[0][(j >> ((k - 1) * kBits)) & (NBASIS - 1)];
    for (int d = 1; d < k; ++d) w = w * b[d][(j >> ((k - 1 - d) * kBits)) & (NBASIS - 1)];
    double z;
    if (F48) {
      const float lane = __ldg(row + (nb + (j & (nb / 2 - 1))) * bp);
      z = widen(__ldg(row + j * bp), j < nb / 2 ? lo_high(lane) : lo_low(lane));
    } else {
      z = widen(__ldg(row + j * bp), __ldg(row + (nb + j) * bp));
    }
    partial[top++] = w * z;
    for (int m = i + 1; (m & 1) == 0; m >>= 1) {
      partial[top - 2] = partial[top - 2] + partial[top - 1];
      --top;
    }
  }
  store_pair(partial[0], out_hi, out_lo, e);
}

// bp = 1: one warp per query (kWarps queries a block), lane l on channels l + 32 m
constexpr int kWarps = kThreads / 32;

template <int NBASIS, bool F48>
__global__ void nd_warp_kernel(const float* __restrict__ packed, int64_t rows, int64_t ch, int k,
                               NdStrides strides, const int32_t* __restrict__ idx,
                               const float* __restrict__ th, const float* __restrict__ tl,
                               float* __restrict__ out_hi, float* __restrict__ out_lo,
                               int64_t nq) {
  constexpr int kBits = NBASIS == 4 ? 2 : 1;
  __shared__ double bases[kWarps][kMaxAxes][NBASIS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (qi >= nq) return;  // the whole warp leaves together
  double (*b)[NBASIS] = bases[warp];
  if (lane < k) {
    basis<NBASIS>(widen(__ldg(th + lane * nq + qi), __ldg(tl + lane * nq + qi)), b[lane]);
  }
  int64_t cell = 0;
  for (int d = 0; d < k; ++d) cell += static_cast<int64_t>(__ldg(idx + d * nq + qi)) * strides.s[d];
  cell = cell < 0 ? 0 : (cell >= rows ? rows - 1 : cell);
  __syncwarp();
  const float* row = packed + cell * ch;
  const int levels = k * kBits;
  const int nb = 1 << levels;
  const int width = nb < 32 ? nb : 32;  // lanes in use
  const int per_lane = nb / width;      // a power of two
  double partial[kMaxAxes * 2 - 4];     // pairwise sums over m: depth log2(nb / 32) + 1
  int top = 0;
  if (lane < width) {
    const int mbits = levels - (nb < 32 ? levels : 5);
    for (int i = 0; i < per_lane; ++i) {
      const int m = mbits ? static_cast<int>(__brev(static_cast<unsigned int>(i)) >> (32 - mbits))
                          : 0;
      const int j = lane + width * m;
      double w = b[0][(j >> ((k - 1) * kBits)) & (NBASIS - 1)];
      for (int d = 1; d < k; ++d) w = w * b[d][(j >> ((k - 1 - d) * kBits)) & (NBASIS - 1)];
      double z;
      if (F48) {
        const float lane_lo = __ldg(row + nb + (j & (nb / 2 - 1)));
        z = widen(__ldg(row + j), j < nb / 2 ? lo_high(lane_lo) : lo_low(lane_lo));
      } else {
        z = widen(__ldg(row + j), __ldg(row + nb + j));
      }
      partial[top++] = w * z;
      for (int c = i + 1; (c & 1) == 0; c >>= 1) {
        partial[top - 2] = partial[top - 2] + partial[top - 1];
        --top;
      }
    }
  }
  double v = lane < width ? partial[0] : 0.0;
  for (int h = width / 2; h >= 1; h /= 2) {
    const double other = __shfl_down_sync(0xFFFFFFFFu, v, h);
    if (lane < h) v = v + other;
  }
  if (lane == 0) store_pair(v, out_hi, out_lo, qi);
}

__host__ __device__ constexpr int64_t nbasis_pow(int64_t nbasis, int64_t k) {
  return k == 0 ? 1 : nbasis * nbasis_pow(nbasis, k - 1);
}

template <bool F48>
int launch(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t k, int64_t nbasis,
           const void* idx, NdStrides strides, const void* th, const void* tl, void* out_hi,
           void* out_lo, int64_t nq, void* stream) {
  if (k < 1 || k > kMaxAxes || (nbasis != 2 && nbasis != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the warp path needs a whole warp of channels (measured on the H100: at nb = 8
  // it took 0.474 ms where the thread path took 0.148, at nb = 64 0.715 against 4.14)
  if (bp == 1 && nbasis_pow(nbasis, k) >= 32 && nq > 0) {
    const unsigned int blocks = static_cast<unsigned int>((nq + kWarps - 1) / kWarps);
    auto kernel = nbasis == 4 ? nd_warp_kernel<4, F48> : nd_warp_kernel<2, F48>;
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(packed), rows, ch, static_cast<int>(k), strides,
        static_cast<const int32_t*>(idx), static_cast<const float*>(th),
        static_cast<const float*>(tl), static_cast<float*>(out_hi), static_cast<float*>(out_lo),
        nq);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t n = nq * bp;
  if (n > 0) {
    const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
    auto kernel = nbasis == 4 ? nd_tail_kernel<4, F48> : nd_tail_kernel<2, F48>;
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(packed), rows, ch, bp, static_cast<int>(k), strides,
        static_cast<const int32_t*>(idx), static_cast<const float*>(th),
        static_cast<const float*>(tl), static_cast<float*>(out_hi), static_cast<float*>(out_lo),
        nq, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ndi_df_nd_tail_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t k,
                       int64_t nbasis, const void* idx, NdStrides strides, const void* th,
                       const void* tl, void* out_hi, void* out_lo, int64_t nq, void* stream) {
  return launch<false>(packed, rows, ch, bp, k, nbasis, idx, strides, th, tl, out_hi, out_lo,
                       nq, stream);
}

int ndi_f48_nd_tail_f32(const void* packed, int64_t rows, int64_t ch, int64_t bp, int64_t k,
                        int64_t nbasis, const void* idx, NdStrides strides, const void* th,
                        const void* tl, void* out_hi, void* out_lo, int64_t nq, void* stream) {
  return launch<true>(packed, rows, ch, bp, k, nbasis, idx, strides, th, tl, out_hi, out_lo,
                      nq, stream);
}

}  // extern "C"
