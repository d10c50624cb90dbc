// The f32/f64 2-D cell route for Hopper (sm_90a): the fused cell search and
// the tails on the packed cell-row tables.
//
// R1   cell_index         replaces the Pallas kernel ndarray_interp_tpu/ops/pallas_eval.py
//                         _cell_kernel (fused_cell_index): both axis searches in one
//                         pass, emitting the flat cell xi * (ny - 1) + yi and the
//                         fractions tx, ty.
// R2b  bilinear_tail      replaces ndarray_interp_tpu/ops/pallas_tail.py _bilinear_kernel
//                         (bilinear_tail): three calc_frac lerps on the packed corner
//                         row [z11 | z12 | z21 | z22 | x1 x2 y1 y2] (width >= 4r + 4).
// R2c  bicubic seq tail   replaces pallas_tail.py _bicubic_weight_kernel
//                         (bicubic_weight_tail): the 16 tensor-product weights times the
//                         16 blocks of the cell row (width >= 16r), summed in order.
// R2d  bicubic tree tail  replaces pallas_tail.py _bicubic_mxu_kernel (bicubic_mxu_tail):
//                         the same products, summed by the halving tree (block b + b+8,
//                         then + b+4, b+2, b+1).
// R2n  bicubic nested     the nested scaled-Hermite order of the strategy's tail
//                         (models/strategies/bicubic.py _cell_tail_nested; XLA, not
//                         Pallas, in the JAX package): the order the Bicubic route takes.
//
// What the TPU kernels did and these do not.  R1's Pallas body searched a
// two-level window with one-hot bf16 split matrix products (_axis_search); a GPU
// thread runs the plain binary search through L2, as K3 does, and loads the two
// endpoints.  The Pallas tails took rows that XLA had already gathered, so the
// gathered (Q, 4r + 4) or (Q, 16r) intermediate was written and read again; here
// each thread fetches its own row from the packed table, as K8-K14 and R2a do, so
// that intermediate never exists.  R2d's one-hot MXU build of the weight row
// (exact at Precision.HIGHEST) was a TPU relayout trick: here each weight is the
// one product Ax * Ay it stands for.  Neither the TPU's block multiples of the
// query count nor its r % 8 == 0 apply.
//
// What bounds them on this card.  R1 reads 8 bytes a query and writes 12 (f32);
// its two searches of 9 steps on a 512-knot axis hit L1/L2, so it is latency
// bound like K3.  The tails write 4r bytes a query and read one row a query at
// an address the cell selects: 272 B (R2b) or 1 KB (R2c/R2d/R2n) at r = 16, so
// the rows read (272 MB / 1.07 GB at 1M queries) are several times the table
// (71 / 267 MB at 512 x 512 x 16), which does not fit the 50 MB L2.  One thread
// a (query, channel) element, threads along the channel: adjacent threads read
// adjacent channels of one block and write adjacent outputs, so at r = 16 a warp
// reads two rows' blocks in 64-byte segments and writes 128 contiguous bytes.
//
// Numerics: every form is written in its plain PyTorch version's operation order
// (ops/eval_kernels.py _cell_index_plain, ops/tail2d.py _bilinear_plain,
// _bicubic_weight_plain, _bicubic_tree_plain, _cell_tail_nested) and the library
// is compiled with --fmad=false, so each kernel is bit-identical to its plain
// version.  R1's index is K3's and its fractions K2's.  A cell outside the table
// is clamped, as the plain versions clamp it, so a bad cell cannot read outside
// the table.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"  // lower_index

namespace {

constexpr int kThreads = 256;

enum Order { kSeq = 0, kTree = 1, kNested = 2 };

__device__ __forceinline__ int64_t clamp_cell(int64_t c, int64_t rows) {
  return c < 0 ? 0 : (c >= rows ? rows - 1 : c);
}

// calc_frac (linear.rs:29-37): m = (y2 - y1) / (x2 - x1); m * (x - x1) + y1
template <typename T>
__device__ __forceinline__ T calc_frac(T x1, T y1, T x2, T y2, T x) {
  const T m = (y2 - y1) / (x2 - x1);
  return m * (x - x1) + y1;
}

// the symmetric Hermite form with pre-scaled derivatives K = k * dx
// (bicubic._hermite_scaled)
template <typename T>
__device__ __forceinline__ T hermite_scaled(T y_l, T y_r, T k_l, T k_r, T t) {
  const T one = T(1);
  const T dy = y_r - y_l;
  const T a = k_l - dy;
  const T b = dy - k_r;
  return (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t);
}

// the scaled-Hermite weights (w_yl, w_yr, w_Kl, w_Kr) of t
// (pallas_tail._bicubic_basis): u + p d, t - p d, p u, -(p t)
template <typename T>
__device__ __forceinline__ void basis(T t, T w[4]) {
  const T u = T(1) - t;
  const T p = t * u;
  const T pd = p * (u - t);
  w[0] = u + pd;
  w[1] = t - pd;
  w[2] = p * u;
  w[3] = -(p * t);
}

template <typename T>
__global__ void cell_index_kernel(const T* __restrict__ x, int nx, const T* __restrict__ y,
                                  int ny, const T* __restrict__ qx, const T* __restrict__ qy,
                                  int32_t* __restrict__ cell, T* __restrict__ tx,
                                  T* __restrict__ ty, int64_t nq) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= nq) return;
  const T qxi = qx[i];
  const T qyi = qy[i];
  const int xi = lower_index(x, nx, qxi);
  const int yi = lower_index(y, ny, qyi);
  const T x_l = __ldg(x + xi);
  const T x_r = __ldg(x + xi + 1);
  const T y_l = __ldg(y + yi);
  const T y_r = __ldg(y + yi + 1);
  cell[i] = xi * (ny - 1) + yi;  // < 2^31: the wrapper checks the cell count
  tx[i] = (qxi - x_l) / (x_r - x_l);
  ty[i] = (qyi - y_l) / (y_r - y_l);
}

// R2b.  tbl (rows, ch), ch >= 4r + 4; out (nq, r); n = nq * r elements.
template <typename T>
__global__ void bilinear_tail_kernel(const T* __restrict__ tbl, int64_t rows, int64_t ch,
                                     int64_t r, const int32_t* __restrict__ cell,
                                     const T* __restrict__ qx, const T* __restrict__ qy,
                                     T* __restrict__ out, int64_t n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t q = e / r;
  const int64_t c = e - q * r;
  const T* row = tbl + clamp_cell(__ldg(cell + q), rows) * ch;
  const T z11 = __ldg(row + c);
  const T z12 = __ldg(row + r + c);
  const T z21 = __ldg(row + 2 * r + c);
  const T z22 = __ldg(row + 3 * r + c);
  const T x1 = __ldg(row + 4 * r);
  const T x2 = __ldg(row + 4 * r + 1);
  const T y1 = __ldg(row + 4 * r + 2);
  const T y2 = __ldg(row + 4 * r + 3);
  const T xq = __ldg(qx + q);
  // the lerp composition and order of bilinear.rs:88-97
  const T z1 = calc_frac(x1, z11, x2, z21, xq);
  const T z2 = calc_frac(x1, z12, x2, z22, xq);
  out[e] = calc_frac(y1, z1, y2, z2, __ldg(qy + q));
}

// R2c / R2d / R2n.  tbl (rows, ch), ch >= 16r: block b = 4 i + c of the row
// (quantity i in [f, kx*dx, ky*dy, kxy*dx*dy], corner c in [11, 12, 21, 22])
// holds columns [b r, (b + 1) r).  out (nq, r); n = nq * r elements.
template <typename T, int kOrder>
__global__ void bicubic_cell_tail_kernel(const T* __restrict__ tbl, int64_t rows, int64_t ch,
                                         int64_t r, const int32_t* __restrict__ cell,
                                         const T* __restrict__ tx, const T* __restrict__ ty,
                                         T* __restrict__ out, int64_t n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int64_t q = e / r;
  const int64_t c = e - q * r;
  const T* v = tbl + clamp_cell(__ldg(cell + q), rows) * ch + c;  // block b at v[b * r]
  const T t = __ldg(tx + q);
  const T s = __ldg(ty + q);
  if (kOrder == kNested) {
    // f and ky*dy along x at both bracketing y-knots, then along y
    const T f_y1 = hermite_scaled(__ldg(v), __ldg(v + 2 * r), __ldg(v + 4 * r),
                                  __ldg(v + 6 * r), t);
    const T f_y2 = hermite_scaled(__ldg(v + r), __ldg(v + 3 * r), __ldg(v + 5 * r),
                                  __ldg(v + 7 * r), t);
    const T g_y1 = hermite_scaled(__ldg(v + 8 * r), __ldg(v + 10 * r), __ldg(v + 12 * r),
                                  __ldg(v + 14 * r), t);
    const T g_y2 = hermite_scaled(__ldg(v + 9 * r), __ldg(v + 11 * r), __ldg(v + 13 * r),
                                  __ldg(v + 15 * r), t);
    out[e] = hermite_scaled(f_y1, f_y2, g_y1, g_y2, s);
    return;
  }
  T bx[4], by[4];
  basis(t, bx);
  basis(s, by);
  // W[4 i + c] = Ax[i][c >> 1] * Ay[i][c & 1] (pallas_tail._bicubic_weights):
  // f and ky take the value bases along x, kx and kxy the derivative bases;
  // f and kx take the value bases along y, ky and kxy the derivative bases
  T p[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int i = b >> 2;
    const T w = bx[(i & 1) * 2 + ((b & 3) >> 1)] * by[(i >> 1) * 2 + (b & 1)];
    p[b] = w * __ldg(v + b * r);
  }
  if (kOrder == kSeq) {
    T acc = p[0];
#pragma unroll
    for (int b = 1; b < 16; ++b) acc = acc + p[b];
    out[e] = acc;
  } else {  // the halving tree, one level at a time (constant bounds: p stays in registers)
#pragma unroll
    for (int b = 0; b < 8; ++b) p[b] = p[b] + p[b + 8];
#pragma unroll
    for (int b = 0; b < 4; ++b) p[b] = p[b] + p[b + 4];
#pragma unroll
    for (int b = 0; b < 2; ++b) p[b] = p[b] + p[b + 2];
    out[e] = p[0] + p[1];
  }
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int cell_index(const void* x, int64_t nx, const void* y, int64_t ny, const void* qx,
               const void* qy, void* cell, void* tx, void* ty, int64_t nq, void* stream) {
  if (nq > 0) {
    cell_index_kernel<T><<<blocks_for(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<int>(nx), static_cast<const T*>(y),
        static_cast<int>(ny), static_cast<const T*>(qx), static_cast<const T*>(qy),
        static_cast<int32_t*>(cell), static_cast<T*>(tx), static_cast<T*>(ty), nq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bilinear_tail(const void* tbl, int64_t rows, int64_t ch, int64_t r, const void* cell,
                  const void* qx, const void* qy, void* out, int64_t nq, void* stream) {
  const int64_t n = nq * r;
  if (n > 0) {
    bilinear_tail_kernel<T><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(tbl), rows, ch, r, static_cast<const int32_t*>(cell),
        static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kOrder>
int bicubic_tail(const void* tbl, int64_t rows, int64_t ch, int64_t r, const void* cell,
                 const void* tx, const void* ty, void* out, int64_t nq, void* stream) {
  const int64_t n = nq * r;
  if (n > 0) {
    bicubic_cell_tail_kernel<T, kOrder>
        <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(tbl), rows, ch, r, static_cast<const int32_t*>(cell),
            static_cast<const T*>(tx), static_cast<const T*>(ty), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ndi_cell_index_f32(const void* x, int64_t nx, const void* y, int64_t ny, const void* qx,
                       const void* qy, void* cell, void* tx, void* ty, int64_t nq,
                       void* stream) {
  return cell_index<float>(x, nx, y, ny, qx, qy, cell, tx, ty, nq, stream);
}

int ndi_cell_index_f64(const void* x, int64_t nx, const void* y, int64_t ny, const void* qx,
                       const void* qy, void* cell, void* tx, void* ty, int64_t nq,
                       void* stream) {
  return cell_index<double>(x, nx, y, ny, qx, qy, cell, tx, ty, nq, stream);
}

#define NDI_CELL_TAIL(name, body)                                                         \
  int name(const void* tbl, int64_t rows, int64_t ch, int64_t r, const void* cell,        \
           const void* a, const void* b, void* out, int64_t nq, void* stream) {           \
    return body(tbl, rows, ch, r, cell, a, b, out, nq, stream);                           \
  }

NDI_CELL_TAIL(ndi_bilinear_tail_f32, bilinear_tail<float>)
NDI_CELL_TAIL(ndi_bilinear_tail_f64, bilinear_tail<double>)
NDI_CELL_TAIL(ndi_bicubic_seq_tail_f32, (bicubic_tail<float, kSeq>))
NDI_CELL_TAIL(ndi_bicubic_seq_tail_f64, (bicubic_tail<double, kSeq>))
NDI_CELL_TAIL(ndi_bicubic_tree_tail_f32, (bicubic_tail<float, kTree>))
NDI_CELL_TAIL(ndi_bicubic_tree_tail_f64, (bicubic_tail<double, kTree>))
NDI_CELL_TAIL(ndi_bicubic_nested_tail_f32, (bicubic_tail<float, kNested>))
NDI_CELL_TAIL(ndi_bicubic_nested_tail_f64, (bicubic_tail<double, kNested>))

#undef NDI_CELL_TAIL

}  // extern "C"
