// Native host runtime for ndarray_interp_tpu.
//
// The TPU (XLA/Pallas) path owns batched workloads; this C++ core owns the
// host-side eager path — scalar and small-batch queries where device
// dispatch latency would dominate.  It mirrors the roles of the
// reference's CPU hot loops (cited per function) without porting their
// code: interval lookup with an even-spacing O(1) guess, and per-interval
// polynomial evaluation vectorized over trailing axes.
//
// Exposed as a plain extern "C" ABI consumed via ctypes
// (ndarray_interp_tpu/native/__init__.py).  All arrays are dense
// row-major; `trailing` is the flattened product of all non-interp axes.
//
// Build: python -m ndarray_interp_tpu.native.build

#include <cmath>
#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace {

// Interval lookup on a strictly-rising axis; clamps to [0, n-2].
// Role of VectorExtensions::get_lower_index
// (reference crate, src/vector_extensions.rs:55-111): O(1) guess assuming
// even spacing, verified, else binary search.
template <typename T>
inline int64_t lower_index(const T* x, int64_t n, T q) {
  if (q != q) return 0;  // NaN: int64_t(NaN) is UB; interval 0 → NaN output
  if (q <= x[0]) return 0;
  if (q >= x[n - 1]) return n - 2;
  // even-spacing guess
  double frac = (double(q) - double(x[0])) / (double(x[n - 1]) - double(x[0]));
  int64_t guess = (int64_t)(frac * double(n - 1));
  if (guess < 0) guess = 0;
  if (guess > n - 2) guess = n - 2;
  if (x[guess] <= q && q < x[guess + 1]) return guess;
  int64_t lo, hi;
  if (x[guess] <= q) {
    lo = guess;
    hi = n - 1;
  } else {
    lo = 0;
    hi = guess;
  }
  while (lo + 1 < hi) {
    int64_t mid = lo + (hi - lo) / 2;
    if (x[mid] <= q)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// calc_frac with the reference's exact op order (linear.rs:29-37):
// b = y1; m = (y2-y1)/(x2-x1); m*(x-x1)+b
template <typename T>
inline T lerp(T x1, T y1, T x2, T y2, T x) {
  T m = (y2 - y1) / (x2 - x1);
  return m * (x - x1) + y1;
}

template <typename T>
inline void eval_linear_one(const T* x, const T* y, int64_t n,
                            int64_t trailing, T qi, T* o) {
  int64_t idx = lower_index(x, n, qi);
  const T x1 = x[idx], x2 = x[idx + 1];
  const T* y1 = y + idx * trailing;
  const T* y2 = y + (idx + 1) * trailing;
  for (int64_t t = 0; t < trailing; ++t) o[t] = lerp(x1, y1[t], x2, y2[t], qi);
}

// Interval lookup for a query block: branchless even-spacing guess +
// gather-verify, with a scalar binary-search fix-up only for lanes whose
// guess missed (rare on near-uniform axes — the reference's own
// O(1)-guess insight, vector_extensions.rs:70-96, in SIMD form).  GCC
// will not auto-generate the gathers, so the AVX-512 form is explicit;
// the scalar form is the portable fallback.
template <typename T, int B>
inline void lower_index_block(const T* x, int64_t n, const T* q, int cnt,
                              int32_t* idx) {
  const double x0 = double(x[0]);
  const double inv = double(n - 1) / (double(x[n - 1]) - x0);
  int32_t nmax = int32_t(n - 2);
  for (int j = 0; j < cnt; ++j) {
    // clamp as double BEFORE the cast: int32_t(1e33) is UB; NaN escapes
    // both comparisons, so route it to 0 (matching the AVX-512 saturate
    // + clamp behavior) — the verify below then sends it to lower_index,
    // which is NaN-safe
    double g = (double(q[j]) - x0) * inv;
    g = (g != g) ? 0.0
                 : (g < 0.0 ? 0.0 : (g > double(nmax) ? double(nmax) : g));
    idx[j] = int32_t(g);
  }
  unsigned char miss[B];
  for (int j = 0; j < cnt; ++j)
    miss[j] = !(x[idx[j]] <= q[j] && q[j] < x[idx[j] + 1]);
  for (int j = 0; j < cnt; ++j)
    if (miss[j]) idx[j] = int32_t(lower_index(x, n, q[j]));
}

#ifdef __AVX512F__

// Fused lookup + evaluation for flat (trailing == 1) banks: branchless
// even-spacing guess, gather-verify sharing its x1/x2 gathers with the
// evaluation (4 gathers per vector instead of 6), scalar binary-search
// fix-up only for miss lanes.  Exact reference op order, no FMA
// contraction (matches -ffp-contract=off scalar results bit-for-bit).

// f64, 8 lanes.  lerp: linear.rs:29-37.
inline void linear_flat_avx(const double* x, const double* y, int64_t n,
                            const double* q, double* o, int cnt) {
  const double x0 = x[0];
  const double inv = double(n - 1) / (x[n - 1] - x0);
  const int32_t nmax = int32_t(n - 2);
  const __m512d vx0 = _mm512_set1_pd(x0);
  const __m512d vinv = _mm512_set1_pd(inv);
  const __m256i v0 = _mm256_setzero_si256();
  const __m256i vmax = _mm256_set1_epi32(nmax);
  const __m256i vone = _mm256_set1_epi32(1);
  int32_t tmp[8];
  int j = 0;
  for (; j + 8 <= cnt; j += 8) {
    __m512d qv = _mm512_loadu_pd(q + j);
    __m256i gi =
        _mm512_cvttpd_epi32(_mm512_mul_pd(_mm512_sub_pd(qv, vx0), vinv));
    gi = _mm256_min_epi32(_mm256_max_epi32(gi, v0), vmax);
    __m512d x1 = _mm512_i32gather_pd(gi, x, 8);
    __m512d x2 = _mm512_i32gather_pd(_mm256_add_epi32(gi, vone), x, 8);
    __mmask8 ok = _mm512_cmp_pd_mask(x1, qv, _CMP_LE_OQ) &
                  _mm512_cmp_pd_mask(qv, x2, _CMP_LT_OQ);
    if (ok != 0xFF) {
      _mm256_storeu_si256((__m256i*)tmp, gi);
      unsigned miss = (~unsigned(ok)) & 0xFFu;
      while (miss) {
        int l = __builtin_ctz(miss);
        tmp[l] = int32_t(lower_index(x, n, q[j + l]));
        miss &= miss - 1;
      }
      gi = _mm256_loadu_si256((__m256i const*)tmp);
      x1 = _mm512_i32gather_pd(gi, x, 8);
      x2 = _mm512_i32gather_pd(_mm256_add_epi32(gi, vone), x, 8);
    }
    __m512d y1 = _mm512_i32gather_pd(gi, y, 8);
    __m512d y2 = _mm512_i32gather_pd(_mm256_add_epi32(gi, vone), y, 8);
    __m512d m =
        _mm512_div_pd(_mm512_sub_pd(y2, y1), _mm512_sub_pd(x2, x1));
    _mm512_storeu_pd(
        o + j, _mm512_add_pd(_mm512_mul_pd(m, _mm512_sub_pd(qv, x1)), y1));
  }
  for (; j < cnt; ++j) {
    const int64_t k = lower_index(x, n, q[j]);
    o[j] = lerp(x[k], y[k], x[k + 1], y[k + 1], q[j]);
  }
}

// f32, 16 lanes.
inline void linear_flat_avx(const float* x, const float* y, int64_t n,
                            const float* q, float* o, int cnt) {
  const float x0 = x[0];
  const float inv = float(double(n - 1) / (double(x[n - 1]) - double(x0)));
  const int32_t nmax = int32_t(n - 2);
  const __m512 vx0 = _mm512_set1_ps(x0);
  const __m512 vinv = _mm512_set1_ps(inv);
  const __m512i v0 = _mm512_setzero_si512();
  const __m512i vmax = _mm512_set1_epi32(nmax);
  const __m512i vone = _mm512_set1_epi32(1);
  int32_t tmp[16];
  int j = 0;
  for (; j + 16 <= cnt; j += 16) {
    __m512 qv = _mm512_loadu_ps(q + j);
    __m512i gi =
        _mm512_cvttps_epi32(_mm512_mul_ps(_mm512_sub_ps(qv, vx0), vinv));
    gi = _mm512_min_epi32(_mm512_max_epi32(gi, v0), vmax);
    __m512 x1 = _mm512_i32gather_ps(gi, x, 4);
    __m512 x2 = _mm512_i32gather_ps(_mm512_add_epi32(gi, vone), x, 4);
    __mmask16 ok = _mm512_cmp_ps_mask(x1, qv, _CMP_LE_OQ) &
                   _mm512_cmp_ps_mask(qv, x2, _CMP_LT_OQ);
    if (ok != 0xFFFF) {
      _mm512_storeu_si512((__m512i*)tmp, gi);
      unsigned miss = (~unsigned(ok)) & 0xFFFFu;
      while (miss) {
        int l = __builtin_ctz(miss);
        tmp[l] = int32_t(lower_index(x, n, q[j + l]));
        miss &= miss - 1;
      }
      gi = _mm512_loadu_si512((__m512i const*)tmp);
      x1 = _mm512_i32gather_ps(gi, x, 4);
      x2 = _mm512_i32gather_ps(_mm512_add_epi32(gi, vone), x, 4);
    }
    __m512 y1 = _mm512_i32gather_ps(gi, y, 4);
    __m512 y2 = _mm512_i32gather_ps(_mm512_add_epi32(gi, vone), y, 4);
    __m512 m = _mm512_div_ps(_mm512_sub_ps(y2, y1), _mm512_sub_ps(x2, x1));
    _mm512_storeu_ps(
        o + j, _mm512_add_ps(_mm512_mul_ps(m, _mm512_sub_ps(qv, x1)), y1));
  }
  for (; j < cnt; ++j) {
    const int64_t k = lower_index(x, n, q[j]);
    o[j] = lerp(x[k], y[k], x[k + 1], y[k + 1], q[j]);
  }
}

// f64 Hermite, op order of cubic_spline.rs:818-828.
inline void hermite_flat_avx(const double* x, const double* y,
                             const double* a, const double* b, int64_t n,
                             const double* q, double* o, int cnt) {
  const double x0 = x[0];
  const double inv = double(n - 1) / (x[n - 1] - x0);
  const int32_t nmax = int32_t(n - 2);
  const __m512d vx0 = _mm512_set1_pd(x0);
  const __m512d vinv = _mm512_set1_pd(inv);
  const __m256i v0 = _mm256_setzero_si256();
  const __m256i vmax = _mm256_set1_epi32(nmax);
  const __m256i vone = _mm256_set1_epi32(1);
  const __m512d one = _mm512_set1_pd(1.0);
  int32_t tmp[8];
  int j = 0;
  for (; j + 8 <= cnt; j += 8) {
    __m512d qv = _mm512_loadu_pd(q + j);
    __m256i gi =
        _mm512_cvttpd_epi32(_mm512_mul_pd(_mm512_sub_pd(qv, vx0), vinv));
    gi = _mm256_min_epi32(_mm256_max_epi32(gi, v0), vmax);
    __m512d x1 = _mm512_i32gather_pd(gi, x, 8);
    __m512d x2 = _mm512_i32gather_pd(_mm256_add_epi32(gi, vone), x, 8);
    __mmask8 ok = _mm512_cmp_pd_mask(x1, qv, _CMP_LE_OQ) &
                  _mm512_cmp_pd_mask(qv, x2, _CMP_LT_OQ);
    if (ok != 0xFF) {
      _mm256_storeu_si256((__m256i*)tmp, gi);
      unsigned miss = (~unsigned(ok)) & 0xFFu;
      while (miss) {
        int l = __builtin_ctz(miss);
        tmp[l] = int32_t(lower_index(x, n, q[j + l]));
        miss &= miss - 1;
      }
      gi = _mm256_loadu_si256((__m256i const*)tmp);
      x1 = _mm512_i32gather_pd(gi, x, 8);
      x2 = _mm512_i32gather_pd(_mm256_add_epi32(gi, vone), x, 8);
    }
    __m512d y1 = _mm512_i32gather_pd(gi, y, 8);
    __m512d y2 = _mm512_i32gather_pd(_mm256_add_epi32(gi, vone), y, 8);
    __m512d av = _mm512_i32gather_pd(gi, a, 8);
    __m512d bv = _mm512_i32gather_pd(gi, b, 8);
    __m512d t =
        _mm512_div_pd(_mm512_sub_pd(qv, x1), _mm512_sub_pd(x2, x1));
    __m512d omt = _mm512_sub_pd(one, t);
    __m512d inner =
        _mm512_add_pd(_mm512_mul_pd(av, omt), _mm512_mul_pd(bv, t));
    __m512d r = _mm512_add_pd(
        _mm512_add_pd(_mm512_mul_pd(omt, y1), _mm512_mul_pd(t, y2)),
        _mm512_mul_pd(_mm512_mul_pd(t, omt), inner));
    _mm512_storeu_pd(o + j, r);
  }
  for (; j < cnt; ++j) {
    const int64_t k = lower_index(x, n, q[j]);
    const double t = (q[j] - x[k]) / (x[k + 1] - x[k]);
    o[j] = (1.0 - t) * y[k] + t * y[k + 1] +
           t * (1.0 - t) * (a[k] * (1.0 - t) + b[k] * t);
  }
}

// f32 Hermite, 16 lanes.
inline void hermite_flat_avx(const float* x, const float* y, const float* a,
                             const float* b, int64_t n, const float* q,
                             float* o, int cnt) {
  const float x0 = x[0];
  const float inv = float(double(n - 1) / (double(x[n - 1]) - double(x0)));
  const int32_t nmax = int32_t(n - 2);
  const __m512 vx0 = _mm512_set1_ps(x0);
  const __m512 vinv = _mm512_set1_ps(inv);
  const __m512i v0 = _mm512_setzero_si512();
  const __m512i vmax = _mm512_set1_epi32(nmax);
  const __m512i vone = _mm512_set1_epi32(1);
  const __m512 one = _mm512_set1_ps(1.0f);
  int32_t tmp[16];
  int j = 0;
  for (; j + 16 <= cnt; j += 16) {
    __m512 qv = _mm512_loadu_ps(q + j);
    __m512i gi =
        _mm512_cvttps_epi32(_mm512_mul_ps(_mm512_sub_ps(qv, vx0), vinv));
    gi = _mm512_min_epi32(_mm512_max_epi32(gi, v0), vmax);
    __m512 x1 = _mm512_i32gather_ps(gi, x, 4);
    __m512 x2 = _mm512_i32gather_ps(_mm512_add_epi32(gi, vone), x, 4);
    __mmask16 ok = _mm512_cmp_ps_mask(x1, qv, _CMP_LE_OQ) &
                   _mm512_cmp_ps_mask(qv, x2, _CMP_LT_OQ);
    if (ok != 0xFFFF) {
      _mm512_storeu_si512((__m512i*)tmp, gi);
      unsigned miss = (~unsigned(ok)) & 0xFFFFu;
      while (miss) {
        int l = __builtin_ctz(miss);
        tmp[l] = int32_t(lower_index(x, n, q[j + l]));
        miss &= miss - 1;
      }
      gi = _mm512_loadu_si512((__m512i const*)tmp);
      x1 = _mm512_i32gather_ps(gi, x, 4);
      x2 = _mm512_i32gather_ps(_mm512_add_epi32(gi, vone), x, 4);
    }
    __m512 y1 = _mm512_i32gather_ps(gi, y, 4);
    __m512 y2 = _mm512_i32gather_ps(_mm512_add_epi32(gi, vone), y, 4);
    __m512 av = _mm512_i32gather_ps(gi, a, 4);
    __m512 bv = _mm512_i32gather_ps(gi, b, 4);
    __m512 t = _mm512_div_ps(_mm512_sub_ps(qv, x1), _mm512_sub_ps(x2, x1));
    __m512 omt = _mm512_sub_ps(one, t);
    __m512 inner =
        _mm512_add_ps(_mm512_mul_ps(av, omt), _mm512_mul_ps(bv, t));
    __m512 r = _mm512_add_ps(
        _mm512_add_ps(_mm512_mul_ps(omt, y1), _mm512_mul_ps(t, y2)),
        _mm512_mul_ps(_mm512_mul_ps(t, omt), inner));
    _mm512_storeu_ps(o + j, r);
  }
  for (; j < cnt; ++j) {
    const int64_t k = lower_index(x, n, q[j]);
    const float t = (q[j] - x[k]) / (x[k + 1] - x[k]);
    o[j] = (1.0f - t) * y[k] + t * y[k + 1] +
           t * (1.0f - t) * (a[k] * (1.0f - t) + b[k] * t);
  }
}

#endif  // __AVX512F__

template <typename T>
int64_t eval_linear(const T* x, const T* y, int64_t n, int64_t trailing,
                    const T* q, int64_t m, T* out, int extrapolate) {
  if (!extrapolate) {
    // abort-before-write semantics (docs/PARITY.md: whole-call abort, no
    // partial buffer writes)
    for (int64_t i = 0; i < m; ++i)
      if (!(x[0] <= q[i] && q[i] <= x[n - 1])) return i + 1;
  }
  if (trailing == 1) {
    // scalar-bank fast path: blocked guess/verify + gathered lerp;
    // blocks are independent, so they also split across threads
    constexpr int B = 256;
#pragma omp parallel for schedule(static) if (m > (1 << 15))
    for (int64_t i0 = 0; i0 < m; i0 += B) {
      int32_t idx[B];
      const int cnt = int(m - i0 < B ? m - i0 : B);
      const T* qb = q + i0;
      T* ob = out + i0;
#ifdef __AVX512F__
      (void)idx;
      linear_flat_avx(x, y, n, qb, ob, cnt);
#else
      lower_index_block<T, B>(x, n, qb, cnt, idx);
      for (int j = 0; j < cnt; ++j) {
        const int32_t k = idx[j];
        ob[j] = lerp(x[k], y[k], x[k + 1], y[k + 1], qb[j]);
      }
#endif
    }
    return 0;
  }
#pragma omp parallel for schedule(static) if (m * (trailing + 8) > 1 << 15)
  for (int64_t i = 0; i < m; ++i)
    eval_linear_one(x, y, n, trailing, q[i], out + i * trailing);
  return 0;
}

// Hermite symmetric-form evaluation, op order of cubic_spline.rs:818-828.
// mode: 0 = error on OOB, 1 = extrapolate, 2 = periodic wrap
template <typename T>
inline void eval_hermite_one(const T* x, const T* y, const T* a, const T* b,
                             int64_t n, int64_t trailing, T qi, int mode,
                             T x0, T xn, T* o) {
  if (mode == 2 && !(x0 <= qi && qi <= xn)) {
    // rem_euclid analogue (cubic_spline.rs:804-809)
    T span = xn - x0;
    T r = std::fmod(qi - x0, span);
    if (r < 0) r += span;
    qi = r + x0;
  }
  int64_t idx = lower_index(x, n, qi);
  const T xl = x[idx], xr = x[idx + 1];
  const T t = (qi - xl) / (xr - xl);
  const T* yl = y + idx * trailing;
  const T* yr = y + (idx + 1) * trailing;
  const T* ai = a + idx * trailing;
  const T* bi = b + idx * trailing;
  const T one = T(1);
  for (int64_t k = 0; k < trailing; ++k) {
    o[k] = (one - t) * yl[k] + t * yr[k] +
           t * (one - t) * (ai[k] * (one - t) + bi[k] * t);
  }
}

template <typename T>
int64_t eval_hermite(const T* x, const T* y, const T* a, const T* b,
                     int64_t n, int64_t trailing, const T* q, int64_t m,
                     T* out, int mode) {
  const T x0 = x[0], xn = x[n - 1];
  if (mode == 0) {
    // abort-before-write semantics (docs/PARITY.md)
    for (int64_t i = 0; i < m; ++i)
      if (!(x0 <= q[i] && q[i] <= xn)) return i + 1;
  }
  if (trailing == 1 && mode != 2) {
    // scalar-bank fast path (see eval_linear): blocked guess/verify +
    // gathered Hermite, same op order as cubic_spline.rs:818-828
    constexpr int B = 256;
    const T one = T(1);
#pragma omp parallel for schedule(static) if (m > (1 << 15))
    for (int64_t i0 = 0; i0 < m; i0 += B) {
      int32_t idx[B];
      const int cnt = int(m - i0 < B ? m - i0 : B);
      const T* qb = q + i0;
      T* ob = out + i0;
#ifdef __AVX512F__
      (void)idx;
      (void)one;
      hermite_flat_avx(x, y, a, b, n, qb, ob, cnt);
#else
      lower_index_block<T, B>(x, n, qb, cnt, idx);
      for (int j = 0; j < cnt; ++j) {
        const int32_t k = idx[j];
        const T xl = x[k], xr = x[k + 1];
        const T t = (qb[j] - xl) / (xr - xl);
        ob[j] = (one - t) * y[k] + t * y[k + 1] +
                t * (one - t) * (a[k] * (one - t) + b[k] * t);
      }
#endif
    }
    return 0;
  }
#pragma omp parallel for schedule(static) if (m * (trailing + 8) > 1 << 15)
  for (int64_t i = 0; i < m; ++i)
    eval_hermite_one(x, y, a, b, n, trailing, q[i], mode, x0, xn,
                     out + i * trailing);
  return 0;
}

// Bilinear: two lookups, 4 corners, 3 lerps (bilinear.rs:64-98).
template <typename T>
int64_t eval_bilinear(const T* x, const T* yax, const T* z, int64_t nx,
                      int64_t ny, int64_t trailing, const T* qx, const T* qy,
                      int64_t m, T* out, int extrapolate) {
  if (!extrapolate) {
    // abort-before-write semantics (docs/PARITY.md); x errors are
    // positive indices, y errors negative (matching the ctypes wrapper)
    for (int64_t i = 0; i < m; ++i) {
      if (!(x[0] <= qx[i] && qx[i] <= x[nx - 1])) return i + 1;
      if (!(yax[0] <= qy[i] && qy[i] <= yax[ny - 1])) return -(i + 1);
    }
  }
  if (trailing == 1) {
    // flat fast path: blocked lookups on both axes, then a scalar
    // corner loop (the 4 corner loads are 2-D-strided — gather-hostile)
    constexpr int B = 256;
#pragma omp parallel for schedule(static) if (m > (1 << 15))
    for (int64_t i0 = 0; i0 < m; i0 += B) {
      int32_t xb[B], yb[B];
      const int cnt = int(m - i0 < B ? m - i0 : B);
      const T* qxb = qx + i0;
      const T* qyb = qy + i0;
      lower_index_block<T, B>(x, nx, qxb, cnt, xb);
      lower_index_block<T, B>(yax, ny, qyb, cnt, yb);
      T* o = out + i0;
      for (int j = 0; j < cnt; ++j) {
        const int64_t xi = xb[j], yi = yb[j];
        const T x1 = x[xi], x2 = x[xi + 1];
        const T y1 = yax[yi], y2 = yax[yi + 1];
        const T* base = z + xi * ny + yi;
        const T zq1 = lerp(x1, base[0], x2, base[ny], qxb[j]);
        const T zq2 = lerp(x1, base[1], x2, base[ny + 1], qxb[j]);
        o[j] = lerp(y1, zq1, y2, zq2, qyb[j]);
      }
    }
    return 0;
  }
  for (int64_t i = 0; i < m; ++i) {
    T qxi = qx[i], qyi = qy[i];
    int64_t xi = lower_index(x, nx, qxi);
    int64_t yi = lower_index(yax, ny, qyi);
    const T x1 = x[xi], x2 = x[xi + 1];
    const T y1 = yax[yi], y2 = yax[yi + 1];
    const T* z11 = z + (xi * ny + yi) * trailing;
    const T* z12 = z + (xi * ny + yi + 1) * trailing;
    const T* z21 = z + ((xi + 1) * ny + yi) * trailing;
    const T* z22 = z + ((xi + 1) * ny + yi + 1) * trailing;
    T* o = out + i * trailing;
    for (int64_t t = 0; t < trailing; ++t) {
      T zq1 = lerp(x1, z11[t], x2, z21[t], qxi);
      T zq2 = lerp(x1, z12[t], x2, z22[t], qxi);
      o[t] = lerp(y1, zq1, y2, zq2, qyi);
    }
  }
  return 0;
}

// Bicubic (tensor-product cubic spline): two lookups + the nested
// scaled-Hermite patch on the four corner states [f | kx | ky | kxy]
// (the beyond-reference 2-D strategy; same arithmetic as the node
// layout of models/strategies/bicubic.py::_eval_node, itself the
// symmetric 1-D form of cubic_spline.rs:818-828 applied three times).
template <typename T>
inline T hermite_d(T yl, T yr, T kl, T kr, T d, T t) {
  const T dy = yr - yl;
  const T a = kl * d - dy;
  const T b = dy - kr * d;
  const T one = T(1);
  return (one - t) * yl + t * yr + t * (one - t) * (a * (one - t) + b * t);
}

template <typename T>
int64_t eval_bicubic(const T* x, const T* yax, const T* f, const T* kx,
                     const T* ky, const T* kxy, int64_t nx, int64_t ny,
                     int64_t trailing, const T* qx, const T* qy, int64_t m,
                     T* out, int extrapolate) {
  if (!extrapolate) {
    // abort-before-write semantics (docs/PARITY.md); x errors positive,
    // y errors negative (matching eval_bilinear's contract)
    for (int64_t i = 0; i < m; ++i) {
      if (!(x[0] <= qx[i] && qx[i] <= x[nx - 1])) return i + 1;
      if (!(yax[0] <= qy[i] && qy[i] <= yax[ny - 1])) return -(i + 1);
    }
  }
#pragma omp parallel for schedule(static) if (m * (trailing + 16) > 1 << 15)
  for (int64_t i = 0; i < m; ++i) {
    const T qxi = qx[i], qyi = qy[i];
    const int64_t xi = lower_index(x, nx, qxi);
    const int64_t yi = lower_index(yax, ny, qyi);
    const T dx = x[xi + 1] - x[xi];
    const T dyv = yax[yi + 1] - yax[yi];
    const T tx = (qxi - x[xi]) / dx;
    const T ty = (qyi - yax[yi]) / dyv;
    const int64_t i11 = (xi * ny + yi) * trailing;
    const int64_t i12 = i11 + trailing;
    const int64_t i21 = i11 + ny * trailing;
    const int64_t i22 = i21 + trailing;
    T* o = out + i * trailing;
    for (int64_t k = 0; k < trailing; ++k) {
      // interpolate f and ky along x at both bracketing y-knots
      // (kx / kxy supply the x-derivatives), then Hermite along y
      const T f_y1 = hermite_d(f[i11 + k], f[i21 + k], kx[i11 + k],
                               kx[i21 + k], dx, tx);
      const T f_y2 = hermite_d(f[i12 + k], f[i22 + k], kx[i12 + k],
                               kx[i22 + k], dx, tx);
      const T k_y1 = hermite_d(ky[i11 + k], ky[i21 + k], kxy[i11 + k],
                               kxy[i21 + k], dx, tx);
      const T k_y2 = hermite_d(ky[i12 + k], ky[i22 + k], kxy[i12 + k],
                               kxy[i22 + k], dx, tx);
      o[k] = hermite_d(f_y1, f_y2, k_y1, k_y2, dyv, ty);
    }
  }
  return 0;
}

// Monotonic classification over diffs (role of monotonic_prop,
// vector_extensions.rs:40-53).  0 rising-strict, 1 rising, 2
// falling-strict, 3 falling, 4 not-monotonic.
template <typename T>
int monotonic(const T* x, int64_t n) {
  if (n <= 1) return 4;
  bool up = false, down = false, flat = false;
  for (int64_t i = 0; i + 1 < n; ++i) {
    if (x[i] < x[i + 1])
      up = true;
    else if (x[i] > x[i + 1])
      down = true;
    else
      flat = true;
    if (up && down) return 4;
  }
  if (up && !down) return flat ? 1 : 0;
  if (down && !up) return flat ? 3 : 2;
  return 4;
}

// Cubic-spline coefficient construction with a uniform boundary condition
// on both ends — the host-side analogue of the batched solve in
// models/strategies/cubic.py (role of calc_coefficients + solve_for_k +
// thomas, cubic_spline.rs:310-721, with the SciPy-correct right-NAK
// diagonal).  kind codes: 0 not-a-knot, 1 first-deriv, 2 second-deriv.
// a_out/b_out: (n-1) x trailing.  Returns 0 on success.
template <typename T>
int cubic_build(const T* x, const T* y, int64_t n, int64_t trailing,
                int left_kind, T left_val, int right_kind, T right_val,
                T* a_out, T* b_out) {
  if (n < 3) return 1;
  const int64_t m = trailing;
  T* dx = new T[n - 1];
  for (int64_t i = 0; i + 1 < n; ++i) dx[i] = x[i + 1] - x[i];
  const T dx0 = dx[0], dx1 = dx[1];
  const T dx_1 = dx[n - 2], dx_2 = dx[n - 3];

  T* au = new T[n];
  T* am = new T[n];
  T* al = new T[n];
  T* rhs = new T[n * m];
  T* k = new T[n * m];

  // interior rows
  for (int64_t i = 1; i + 1 < n; ++i) {
    au[i] = dx[i - 1];
    am[i] = T(2) * (dx[i] + dx[i - 1]);
    al[i] = dx[i];
    const T* yl = y + (i - 1) * m;
    const T* ym = y + i * m;
    const T* yr = y + (i + 1) * m;
    T* r = rhs + i * m;
    for (int64_t t = 0; t < m; ++t)
      r[t] = T(3) * (dx[i] * (ym[t] - yl[t]) / dx[i - 1] +
                     dx[i - 1] * (yr[t] - ym[t]) / dx[i]);
  }

  const bool both_nak3 = (n == 3 && left_kind == 0 && right_kind == 0);
  const T* y0 = y;
  const T* y1 = y + m;
  const T* y2 = y + 2 * m;
  const T* yn1 = y + (n - 1) * m;
  const T* yn2 = y + (n - 2) * m;
  const T* yn3 = y + (n - 3) * m;

  // left boundary row
  if (both_nak3) {
    am[0] = T(1);
    au[0] = T(1);
    for (int64_t t = 0; t < m; ++t)
      rhs[t] = T(2) * (y1[t] - y0[t]) / dx0;
  } else if (left_kind == 0) {
    const T d = x[2] - x[0];
    am[0] = dx1;
    au[0] = d;
    const T tmp1 = (dx0 + T(2) * d) * dx1;
    for (int64_t t = 0; t < m; ++t)
      rhs[t] = (tmp1 * (y1[t] - y0[t]) / dx0 +
                dx0 * dx0 * (y2[t] - y1[t]) / dx1) /
               d;
  } else if (left_kind == 1) {
    am[0] = T(1);
    au[0] = T(0);
    for (int64_t t = 0; t < m; ++t) rhs[t] = left_val;
  } else {
    au[0] = dx0;
    am[0] = T(2) * dx0;
    for (int64_t t = 0; t < m; ++t)
      rhs[t] = T(3) * (y1[t] - y0[t]) - left_val * dx0 * dx0 / T(2);
  }

  // right boundary row
  T* rn = rhs + (n - 1) * m;
  if (both_nak3) {
    am[n - 1] = T(1);
    al[n - 1] = T(1);
    for (int64_t t = 0; t < m; ++t)
      rn[t] = T(2) * (yn1[t] - yn2[t]) / dx_1;
  } else if (right_kind == 0) {
    const T d = x[n - 1] - x[n - 3];
    am[n - 1] = dx_2;  // SciPy's formulation (see cubic.py)
    al[n - 1] = d;
    const T tmp1 = (T(2) * d + dx_1) * dx_2;
    for (int64_t t = 0; t < m; ++t)
      rn[t] = (dx_1 * dx_1 * (yn2[t] - yn3[t]) / dx_2 +
               tmp1 * (yn1[t] - yn2[t]) / dx_1) /
              d;
  } else if (right_kind == 1) {
    am[n - 1] = T(1);
    al[n - 1] = T(0);
    for (int64_t t = 0; t < m; ++t) rn[t] = right_val;
  } else {
    am[n - 1] = T(2) * dx_1;
    al[n - 1] = dx_1;
    for (int64_t t = 0; t < m; ++t)
      rn[t] = T(3) * (yn1[t] - yn2[t]) + right_val * dx_1 * dx_1 / T(2);
  }
  au[n - 1] = T(0);
  al[0] = T(0);

  // Thomas: forward sweep then back substitution (same op order as
  // ops/thomas.py)
  for (int64_t i = 1; i < n; ++i) {
    const T w = al[i] / am[i - 1];
    am[i] -= w * au[i - 1];
    T* ri = rhs + i * m;
    const T* rp = rhs + (i - 1) * m;
    for (int64_t t = 0; t < m; ++t) ri[t] = ri[t] - w * rp[t];
  }
  {
    T* kl = k + (n - 1) * m;
    const T* rl = rhs + (n - 1) * m;
    for (int64_t t = 0; t < m; ++t) kl[t] = rl[t] / am[n - 1];
  }
  for (int64_t i = n - 2; i >= 0; --i) {
    T* ki = k + i * m;
    const T* kn = k + (i + 1) * m;
    const T* ri = rhs + i * m;
    for (int64_t t = 0; t < m; ++t)
      ki[t] = (ri[t] - au[i] * kn[t]) / am[i];
  }

  // a[i] = k[i]·dx[i] - Δy;  b[i] = Δy - k[i+1]·dx[i]
  for (int64_t i = 0; i + 1 < n; ++i) {
    const T* yi = y + i * m;
    const T* yr = y + (i + 1) * m;
    const T* ki = k + i * m;
    const T* kr = k + (i + 1) * m;
    T* ai = a_out + i * m;
    T* bi = b_out + i * m;
    for (int64_t t = 0; t < m; ++t) {
      const T dyv = yr[t] - yi[t];
      ai[t] = ki[t] * dx[i] - dyv;
      bi[t] = dyv - kr[t] * dx[i];
    }
  }

  delete[] dx;
  delete[] au;
  delete[] am;
  delete[] al;
  delete[] rhs;
  delete[] k;
  return 0;
}

}  // namespace

extern "C" {

int ndi_cubic_build_f64(const double* x, const double* y, int64_t n,
                        int64_t trailing, int lk, double lv, int rk,
                        double rv, double* a_out, double* b_out) {
  return cubic_build(x, y, n, trailing, lk, lv, rk, rv, a_out, b_out);
}
int ndi_cubic_build_f32(const float* x, const float* y, int64_t n,
                        int64_t trailing, int lk, float lv, int rk, float rv,
                        float* a_out, float* b_out) {
  return cubic_build(x, y, n, trailing, lk, lv, rk, rv, a_out, b_out);
}

// ---- scalar fast path (interp_scalar: 1-D data / 2-D data) ----------------
// err: 0 ok, 1 out-of-bounds, 2 NaN query
double ndi_scalar_linear_f64(const double* x, const double* y, int64_t n,
                             double q, int extrapolate, int* err) {
  *err = 0;
  if (q != q) { *err = 2; return q; }
  if (!extrapolate && !(x[0] <= q && q <= x[n - 1])) { *err = 1; return 0.0; }
  int64_t i = lower_index(x, n, q);
  return lerp(x[i], y[i], x[i + 1], y[i + 1], q);
}

double ndi_scalar_hermite_f64(const double* x, const double* y,
                              const double* a, const double* b, int64_t n,
                              double q, int mode, int* err) {
  *err = 0;
  if (q != q) { *err = 2; return q; }
  bool in_range = (x[0] <= q && q <= x[n - 1]);
  if (mode == 0 && !in_range) { *err = 1; return 0.0; }
  if (mode == 2 && !in_range) {
    double span = x[n - 1] - x[0];
    double r = std::fmod(q - x[0], span);
    if (r < 0) r += span;
    q = r + x[0];
  }
  int64_t i = lower_index(x, n, q);
  const double t = (q - x[i]) / (x[i + 1] - x[i]);
  return (1.0 - t) * y[i] + t * y[i + 1] +
         t * (1.0 - t) * (a[i] * (1.0 - t) + b[i] * t);
}

double ndi_scalar_bilinear_f64(const double* x, const double* yax,
                               const double* z, int64_t nx, int64_t ny,
                               double qx, double qy, int extrapolate,
                               int* err) {
  *err = 0;
  if (qx != qx || qy != qy) { *err = 2; return qx + qy; }
  if (!extrapolate) {
    if (!(x[0] <= qx && qx <= x[nx - 1])) { *err = 1; return 0.0; }
    if (!(yax[0] <= qy && qy <= yax[ny - 1])) { *err = -1; return 0.0; }
  }
  int64_t xi = lower_index(x, nx, qx);
  int64_t yi = lower_index(yax, ny, qy);
  const double z11 = z[xi * ny + yi], z12 = z[xi * ny + yi + 1];
  const double z21 = z[(xi + 1) * ny + yi], z22 = z[(xi + 1) * ny + yi + 1];
  double zq1 = lerp(x[xi], z11, x[xi + 1], z21, qx);
  double zq2 = lerp(x[xi], z12, x[xi + 1], z22, qx);
  return lerp(yax[yi], zq1, yax[yi + 1], zq2, qy);
}

int64_t ndi_lower_index_f64(const double* x, int64_t n, double q) {
  return lower_index(x, n, q);
}
int64_t ndi_lower_index_f32(const float* x, int64_t n, float q) {
  return lower_index(x, n, q);
}

void ndi_lower_index_batch_f64(const double* x, int64_t n, const double* q,
                               int64_t m, int64_t* out) {
  for (int64_t i = 0; i < m; ++i) out[i] = lower_index(x, n, q[i]);
}

int ndi_monotonic_f64(const double* x, int64_t n) { return monotonic(x, n); }
int ndi_monotonic_f32(const float* x, int64_t n) { return monotonic(x, n); }

int64_t ndi_eval_linear_f64(const double* x, const double* y, int64_t n,
                            int64_t trailing, const double* q, int64_t m,
                            double* out, int extrapolate) {
  return eval_linear(x, y, n, trailing, q, m, out, extrapolate);
}
int64_t ndi_eval_linear_f32(const float* x, const float* y, int64_t n,
                            int64_t trailing, const float* q, int64_t m,
                            float* out, int extrapolate) {
  return eval_linear(x, y, n, trailing, q, m, out, extrapolate);
}

int64_t ndi_eval_hermite_f64(const double* x, const double* y, const double* a,
                             const double* b, int64_t n, int64_t trailing,
                             const double* q, int64_t m, double* out,
                             int mode) {
  return eval_hermite(x, y, a, b, n, trailing, q, m, out, mode);
}
int64_t ndi_eval_hermite_f32(const float* x, const float* y, const float* a,
                             const float* b, int64_t n, int64_t trailing,
                             const float* q, int64_t m, float* out, int mode) {
  return eval_hermite(x, y, a, b, n, trailing, q, m, out, mode);
}

int64_t ndi_eval_bicubic_f64(const double* x, const double* y,
                             const double* f, const double* kx,
                             const double* ky, const double* kxy, int64_t nx,
                             int64_t ny, int64_t trailing, const double* qx,
                             const double* qy, int64_t m, double* out,
                             int extrapolate) {
  return eval_bicubic(x, y, f, kx, ky, kxy, nx, ny, trailing, qx, qy, m, out,
                      extrapolate);
}
int64_t ndi_eval_bicubic_f32(const float* x, const float* y, const float* f,
                             const float* kx, const float* ky,
                             const float* kxy, int64_t nx, int64_t ny,
                             int64_t trailing, const float* qx,
                             const float* qy, int64_t m, float* out,
                             int extrapolate) {
  return eval_bicubic(x, y, f, kx, ky, kxy, nx, ny, trailing, qx, qy, m, out,
                      extrapolate);
}
int64_t ndi_eval_bilinear_f64(const double* x, const double* y,
                              const double* z, int64_t nx, int64_t ny,
                              int64_t trailing, const double* qx,
                              const double* qy, int64_t m, double* out,
                              int extrapolate) {
  return eval_bilinear(x, y, z, nx, ny, trailing, qx, qy, m, out, extrapolate);
}
int64_t ndi_eval_bilinear_f32(const float* x, const float* y, const float* z,
                              int64_t nx, int64_t ny, int64_t trailing,
                              const float* qx, const float* qy, int64_t m,
                              float* out, int extrapolate) {
  return eval_bilinear(x, y, z, nx, ny, trailing, qx, qy, m, out, extrapolate);
}

}  // extern "C"
