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
// > 1 with a row-major weight row).  Here every pair is widened once, (double)hi +
// (double)lo (exact for pairs df_from_f64 made), and the kernel computes in double
// what the plain version _df_nd_tail (ops/eval_kernels_df_nd.py) computes:
//   * per axis d the basis of t_d: _cubic_basis, [(1-t)^2 (1+2t), t^2 (3-2t),
//     t (1-t)^2, -t^2 (1-t)], or [1-t, t];
//   * the weight of channel j (one base-nbasis digit per axis, axis 0 most
//     significant, the pack's order) folded axis 0 first: b_0[j_0] b_1[j_1] ...;
//   * the products w_j z_j summed by the plain version's halving tree
//     p[:h] + p[h:].  Over channels that one thread walks, that tree is the
//     pairwise sum of the products taken in bit-reversed order, merged on a stack
//     of partial sums as a binary counter.
// The result is split back into a pair (lo = 0 where hi is not finite).  With
// --fmad=false the kernel is bit-identical to the plain version.  The f48 rows
// carry the lo halves as bf16, block j in the high 16 bits of lane j (mod nb/2)
// for j < nb/2 and in the low 16 bits above; a mask and a shift unpack them, as
// in K9, K11 and K13.
//
// Layout.  The kernel takes the table, the (k, nq) interval indices (K7's, one row
// per axis), the k cell strides (by value), the (k, nq) fraction halves, and
// gathers the cell row sum_d idx_d stride_d itself (clamped to the table as the
// plain version clamps it): the (Q, 2 nb bp) gathered rows of the JAX route are
// never written.  It writes a (Q, bp) pair.
//
// What bounds it on this card: the bytes of each query's own row, 2 nb bp floats
// (512 B for a tricubic scalar grid; f48 384 B), read from HBM once the table is
// past the 50 MB L2: random queries cannot share rows, so the reachable floor is
// those bytes (1M queries at ND3: 512 MB, 0.153 ms), not the table read once.
// Each channel costs about (k + 4) FP64 operations.  The first design (a warp a
// query, 4-byte loads, the axis count a run-time argument) kept its bases and
// partial sums in local memory and one query in flight a warp: 0.705 ms at ND3.
//
// What the design does about it:
//   * the axis count k and nbasis are template arguments (k = 1..6 x nbasis 2, 4 x
//     df, f48, dispatched on the host), so the bases, the weights and the
//     partial sums live in registers: up to 64 terms are summed unrolled, more
//     (nb = 256 to 4,096) in groups of 16 whose sums climb a binary counter of
//     unrolled levels (carry), so that no term count needs a stack;
//   * bp = 1, nb >= 32 (nd_group_kernel): a group of L = 16 lanes (8 at nb = 32)
//     a query, 32 / L queries a warp, a grid that loops over the queries with the
//     next query's idx and t loaded before the current query's sum.  Lane l reads
//     its channels 4 l + 4 L m + (0..3) of hi and lo as float4s.  The tree's top
//     levels (h >= 4 L) pair the m of one lane, the next log2(L) pair lane l with
//     lane l + h / 4 (__shfl_down_sync), the last two pair values inside a lane;
//   * bp = 1, 4 <= nb < 32 (nd_row_kernel): a thread a query reads its row as
//     float4s (float2s where the f48 row is 24 B wide);
//   * bp > 1, or nb = 2 (nd_tail_kernel): a thread a (query, channel) element,
//     neighbouring threads on neighbouring channels of a block.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxAxes = 6;  // ops/_cuda.py MAX_ND_AXES

// the cell strides, passed by value (ops/_cuda.py NdStrides)
struct NdStrides {
  int64_t s[kMaxAxes];
};

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

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

// One query's bases, NBASIS a axis for K axes, and its clamped cell row.
template <int K, int NBASIS>
struct Query {
  double b[K][NBASIS];
  int64_t cell;
};

// the raw operands of one query, loaded ahead of their use
template <int K>
struct Raw {
  int32_t idx[K];
  float th[K], tl[K];
};

template <int K>
__device__ __forceinline__ Raw<K> load_raw(const int32_t* __restrict__ idx,
                                           const float* __restrict__ th,
                                           const float* __restrict__ tl, int64_t nq, int64_t q) {
  Raw<K> r;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    r.idx[d] = __ldg(idx + d * nq + q);
    r.th[d] = __ldg(th + d * nq + q);
    r.tl[d] = __ldg(tl + d * nq + q);
  }
  return r;
}

// _nd_basis: the Hermite basis for pre-scaled derivatives, or the multilinear one
template <int K, int NBASIS>
__device__ __forceinline__ Query<K, NBASIS> prepare(const Raw<K>& r, const NdStrides& strides,
                                                    int64_t rows) {
  Query<K, NBASIS> q;
  int64_t cell = 0;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    cell += static_cast<int64_t>(r.idx[d]) * strides.s[d];
    const double t = widen(r.th[d], r.tl[d]);
    if constexpr (NBASIS == 4) {
      const double omt = 1.0 - t;
      q.b[d][0] = omt * omt * (1.0 + 2.0 * t);
      q.b[d][1] = t * t * (3.0 - 2.0 * t);
      q.b[d][2] = t * omt * omt;
      q.b[d][3] = -t * t * omt;
    } else {
      q.b[d][0] = 1.0 - t;
      q.b[d][1] = t;
    }
  }
  q.cell = cell < 0 ? 0 : (cell >= rows ? rows - 1 : cell);
  return q;
}

// b[digit] without indexing a register array at run time
template <int NBASIS>
__device__ __forceinline__ double pick(const double (&b)[NBASIS], int digit) {
  if constexpr (NBASIS == 2) {
    return digit ? b[1] : b[0];
  } else {
    const double lo = digit & 1 ? b[1] : b[0];
    const double hi = digit & 1 ? b[3] : b[2];
    return digit & 2 ? hi : lo;
  }
}

// the weight of channel j, folded axis 0 first
template <int K, int NBASIS>
__device__ __forceinline__ double weight(const Query<K, NBASIS>& q, int j) {
  constexpr int kBits = NBASIS == 4 ? 2 : 1;
  double w = pick<NBASIS>(q.b[0], (j >> ((K - 1) * kBits)) & (NBASIS - 1));
#pragma unroll
  for (int d = 1; d < K; ++d) w = w * pick<NBASIS>(q.b[d], (j >> ((K - 1 - d) * kBits)) & (NBASIS - 1));
  return w;
}

// The outer levels of the pairwise sum when the terms come one group at a
// time: after group g's sum v, carry it up the binary counter of pending sums
// pend[l] (left operand first) while bit l of g is set, else park it at level
// l.  After the last group (all bits set) v is the whole sum.  The levels are
// unrolled, so pend lives in registers whether or not the groups are.
template <int LG, int W>
__device__ __forceinline__ void carry(double (&pend)[LG > 0 ? LG : 1][W], double (&v)[W], int g) {
  bool up = true;
#pragma unroll
  for (int l = 0; l < LG; ++l) {
    if (up) {
      if ((g >> l) & 1) {
#pragma unroll
        for (int e = 0; e < W; ++e) v[e] = pend[l][e] + v[e];
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) pend[l][e] = v[e];
        up = false;
      }
    }
  }
}

// One thread per (query, channel) element e = qi bp + c of the (nq, bp) output.
template <int K, int NBASIS, bool F48>
__global__ void __launch_bounds__(kThreads) nd_tail_kernel(
    const float* __restrict__ packed, int64_t rows, int64_t ch, int64_t bp, NdStrides strides,
    const int32_t* __restrict__ idx, const float* __restrict__ th, const float* __restrict__ tl,
    float* __restrict__ out_hi, float* __restrict__ out_lo, int64_t nq, int64_t n) {
  constexpr int NB = ipow(NBASIS, K);
  constexpr int kLevels = ilog2(NB);
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t qi = e / bp;
  const int64_t c = e - qi * bp;
  const Query<K, NBASIS> q = prepare<K, NBASIS>(load_raw<K>(idx, th, tl, nq, qi), strides, rows);
  const float* row = packed + q.cell * ch + c;
  // groups of B terms i = g B + ii, channel j = bitrev(ii) G + bitrev(g): each
  // group's pairwise sum unrolled, the groups carried (all registers for any nb;
  // 64 terms unrolled at nb = 256 took 255 registers and spilled)
  constexpr int B = NB <= 64 ? NB : 16;
  constexpr int G = NB / B;
  constexpr int LB = ilog2(B), LG = ilog2(G);
  double pend[LG > 0 ? LG : 1][1];
  double v[1];
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    const int jlo = LG ? static_cast<int>(__brev(static_cast<unsigned int>(g)) >> (32 - LG)) : 0;
    double partial[LB + 1];
    int top = 0;
#pragma unroll
    for (int ii = 0; ii < B; ++ii) {
      const int jhi = LB ? static_cast<int>(__brev(static_cast<unsigned int>(ii)) >> (32 - LB)) : 0;
      const int j = jhi * G + jlo;
      double z;
      if (F48) {
        const float lane = __ldg(row + (NB + (j & (NB / 2 - 1))) * bp);
        z = widen(__ldg(row + j * bp), j < NB / 2 ? lo_high(lane) : lo_low(lane));
      } else {
        z = widen(__ldg(row + j * bp), __ldg(row + (NB + j) * bp));
      }
      partial[top++] = weight<K, NBASIS>(q, j) * z;
      for (int m = ii + 1; (m & 1) == 0; m >>= 1) {
        partial[top - 2] = partial[top - 2] + partial[top - 1];
        --top;
      }
    }
    v[0] = partial[0];
    carry<LG, 1>(pend, v, g);
  }
  store_pair(v[0], out_hi, out_lo, e);
}

// N floats from p (aligned to VW floats) into v, VW at a time
template <int N, int VW>
__device__ __forceinline__ void load_floats(const float* __restrict__ p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
    if (VW == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    } else {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p + i));
      v[i] = x.x;
      v[i + 1] = x.y;
    }
  }
}

// bp = 1, 4 <= nb < 32: a thread a query, its whole row in registers.
template <int K, int NBASIS, bool F48>
__global__ void __launch_bounds__(kThreads) nd_row_kernel(
    const float* __restrict__ packed, int64_t rows, NdStrides strides,
    const int32_t* __restrict__ idx, const float* __restrict__ th, const float* __restrict__ tl,
    float* __restrict__ out_hi, float* __restrict__ out_lo, int64_t nq) {
  constexpr int NB = ipow(NBASIS, K);
  constexpr int kLevels = ilog2(NB);
  constexpr int NLO = F48 ? NB / 2 : NB;
  constexpr int CH = NB + NLO;  // floats a row
  constexpr int VW = CH % 4 == 0 ? 4 : 2;
  const int64_t qi = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (qi >= nq) return;
  const Query<K, NBASIS> q = prepare<K, NBASIS>(load_raw<K>(idx, th, tl, nq, qi), strides, rows);
  const float* row = packed + q.cell * CH;
  float hi[NB], lo[NLO];
  load_floats<NB, VW>(row, hi);
  load_floats<NLO, VW>(row + NB, lo);
  double partial[kLevels + 1];
  int top = 0;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int j = static_cast<int>(__brev(static_cast<unsigned int>(i)) >> (32 - kLevels));
    const double z =
        F48 ? widen(hi[j], j < NB / 2 ? lo_high(lo[j & (NB / 2 - 1)]) : lo_low(lo[j & (NB / 2 - 1)]))
            : widen(hi[j], lo[j % NLO]);
    partial[top++] = weight<K, NBASIS>(q, j) * z;
    for (int m = i + 1; (m & 1) == 0; m >>= 1) {
      partial[top - 2] = partial[top - 2] + partial[top - 1];
      --top;
    }
  }
  store_pair(partial[0], out_hi, out_lo, qi);
}

// bp = 1, nb >= 32: L lanes a query, 32 / L queries a warp, looping over the
// queries; lane l of a group holds channels 4 l + 4 L m + (0..3).
template <int K, int NBASIS, bool F48>
__global__ void __launch_bounds__(kThreads) nd_group_kernel(
    const float* __restrict__ packed, int64_t rows, NdStrides strides,
    const int32_t* __restrict__ idx, const float* __restrict__ th, const float* __restrict__ tl,
    float* __restrict__ out_hi, float* __restrict__ out_lo, int64_t nq) {
  constexpr int NB = ipow(NBASIS, K);
  constexpr int L = NB >= 64 ? 16 : 8;  // lanes a query
  constexpr int G = 32 / L;             // queries a warp
  constexpr int M = NB / (4 * L);       // float4s a lane
  constexpr int CH = F48 ? NB + NB / 2 : 2 * NB;
  static_assert(NB >= 32 && M >= 1, "the group kernel takes nb >= 32");
  const int lane = threadIdx.x % 32;
  const int g = lane / L;
  const int gl = lane % L;
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / 32;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / 32 * G;
  auto query = [&](int64_t base) { return base + g < nq ? base + g : nq - 1; };

  int64_t base = warp * G;  // the warp's first query; uniform over the warp
  Raw<K> raw = load_raw<K>(idx, th, tl, nq, query(base));
  for (; base < nq; base += step) {
    const Query<K, NBASIS> q = prepare<K, NBASIS>(raw, strides, rows);
    const float* row = packed + q.cell * CH;
    raw = load_raw<K>(idx, th, tl, nq, query(base + step));  // the next query, ahead

    // the levels h >= 4 L: pairwise over m in bit-reversed order (unrolled, with
    // every row load ahead of the sums, up to four float4s a lane)
    constexpr int LM = ilog2(M);
    double pend[LM > 0 ? LM : 1][4];
    double s[4];
#pragma unroll(M <= 4 ? M : 1)
    for (int i = 0; i < M; ++i) {
      const int m = LM ? static_cast<int>(__brev(static_cast<unsigned int>(i)) >> (32 - LM)) : 0;
      const int j0 = 4 * L * m + 4 * gl;
      const float4 hv = __ldg(reinterpret_cast<const float4*>(row + j0));
      const float4 lv =
          __ldg(reinterpret_cast<const float4*>(row + NB + (F48 ? j0 & (NB / 2 - 1) : j0)));
      const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
      const float l4[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = F48 ? (j0 < NB / 2 ? lo_high(l4[e]) : lo_low(l4[e])) : l4[e];
        s[e] = weight<K, NBASIS>(q, j0 + e) * widen(h4[e], lo);
      }
      carry<LM, 4>(pend, s, i);
    }
    // the levels 4 L > h >= 4: lane gl with lane gl + h / 4 of its group
#pragma unroll
    for (int off = L / 2; off >= 1; off /= 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = s[e] + __shfl_down_sync(kFull, s[e], off, L);
    }
    // h = 2, 1 inside the lane
    const double r = (s[0] + s[2]) + (s[1] + s[3]);
    if (gl == 0 && base + g < nq) store_pair(r, out_hi, out_lo, base + g);
  }
}

// nd_group_kernel's grid at most: two waves of the 8 blocks of kThreads that each of
// the H100's 132 SMs holds; every group then loops over its queries
constexpr int64_t kGroupBlocks = 132 * 16;

template <int K, int NBASIS, bool F48>
cudaError_t launch_k(const float* packed, int64_t rows, int64_t ch, int64_t bp,
                     const NdStrides& strides, const int32_t* idx, const float* th,
                     const float* tl, float* out_hi, float* out_lo, int64_t nq, cudaStream_t s) {
  constexpr int NB = ipow(NBASIS, K);
  if (nq <= 0 || bp <= 0) return cudaGetLastError();
  if (bp == 1 && NB >= 4) {
    // the vector loads need a 16-byte aligned table of whole rows
    if (reinterpret_cast<uintptr_t>(packed) % 16 != 0) return cudaErrorMisalignedAddress;
    if (ch != (F48 ? NB + NB / 2 : 2 * NB)) return cudaErrorInvalidValue;
    if constexpr (NB >= 32) {
      constexpr int64_t per_block = kThreads / 32 * (32 / (NB >= 64 ? 16 : 8));
      const int64_t want = (nq + per_block - 1) / per_block;
      const unsigned int blocks =
          static_cast<unsigned int>(want < kGroupBlocks ? want : kGroupBlocks);
      nd_group_kernel<K, NBASIS, F48><<<blocks, kThreads, 0, s>>>(
          packed, rows, strides, idx, th, tl, out_hi, out_lo, nq);
    } else {
      const unsigned int blocks = static_cast<unsigned int>((nq + kThreads - 1) / kThreads);
      nd_row_kernel<K, NBASIS, F48><<<blocks, kThreads, 0, s>>>(packed, rows, strides, idx, th,
                                                                 tl, out_hi, out_lo, nq);
    }
    return cudaGetLastError();
  }
  const int64_t n = nq * bp;
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  nd_tail_kernel<K, NBASIS, F48><<<blocks, kThreads, 0, s>>>(
      packed, rows, ch, bp, strides, idx, th, tl, out_hi, out_lo, nq, n);
  return cudaGetLastError();
}

template <bool F48>
int launch(const void* packed_, int64_t rows, int64_t ch, int64_t bp, int64_t k, int64_t nbasis,
           const void* idx_, NdStrides strides, const void* th_, const void* tl_, void* out_hi_,
           void* out_lo_, int64_t nq, void* stream) {
  const auto* packed = static_cast<const float*>(packed_);
  const auto* idx = static_cast<const int32_t*>(idx_);
  const auto* th = static_cast<const float*>(th_);
  const auto* tl = static_cast<const float*>(tl_);
  auto* out_hi = static_cast<float*>(out_hi_);
  auto* out_lo = static_cast<float*>(out_lo_);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NDI_ND_CASE(KK, NBB)                                                                    \
  case 10 * (NBB) + (KK):                                                                      \
    return static_cast<int>(launch_k<KK, NBB, F48>(packed, rows, ch, bp, strides, idx, th, tl, \
                                                   out_hi, out_lo, nq, s));
  switch (10 * nbasis + k) {
    NDI_ND_CASE(1, 2)
    NDI_ND_CASE(2, 2)
    NDI_ND_CASE(3, 2)
    NDI_ND_CASE(4, 2)
    NDI_ND_CASE(5, 2)
    NDI_ND_CASE(6, 2)
    NDI_ND_CASE(1, 4)
    NDI_ND_CASE(2, 4)
    NDI_ND_CASE(3, 4)
    NDI_ND_CASE(4, 4)
    NDI_ND_CASE(5, 4)
    NDI_ND_CASE(6, 4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NDI_ND_CASE
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
