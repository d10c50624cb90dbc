// Batched tridiagonal (Thomas) solve for Hopper (sm_90a).
//
// K4  thomas  replaces both Pallas kernels of ndarray_interp_tpu/ops/pallas_thomas.py:
//             _kernel (shared 1-D diagonals, _thomas_pallas) and
//             _kernel_batched (per-column diagonals, _thomas_pallas_batched).
//
// Layout: rhs and k are row-major (n, bank), as the spline build produces
// them; per-column diagonals are laid out like rhs, shared ones are (n,).
//
// What bounds it on this card.  Each column is a chain of 2(n - 1) dependent
// steps: forward w = a_low / mid', mid' = a_mid - w a_up, r = rhs - w r', back
// k = (r - a_up k') / mid'.  A narrow bank (10,000 x 64: a warp or two) is bound
// by the latency of that chain, which holds an IEEE division in every forward
// step (through the divisor) and every back step (through the numerator); a
// wide bank (64 x 1,000,000) by the bytes of rhs and k.  The first design read
// every operand of a step from device memory inside the chain and wrote a
// per-column copy of mid' to scratch: 3.74 ms at 10,000 x 64, ~187 ns a step.
//
// What the design does about it:
//   * Shared diagonals: w and mid' do not depend on the column, so one warp
//     computes them once (thomas_chain_kernel, a small first launch) into a
//     (2, n) buffer; each column then runs only r = rhs - w r' forward and the
//     back substitution.  The plain loop broadcasts the same w and mid' to every
//     column, so the bits are the same.
//   * Every operand reaches the chain from shared memory: a block is one warp,
//     a lane a column (kCols columns), and the lanes stage chunks of kRows rows
//     (their own column of rhs and of any per-column diagonal, and one row each
//     of the shared vectors) with cp.async, kStages chunks in flight, so the
//     loads run ahead of the chain and never sit in it.  Blocks of one warp put
//     a 64-column bank on two SMs and a 1,000,000-column bank on every SM.
//   * Where the block's whole slice fits in shared memory (the resident form:
//     (kCols + 3) n elements, n padded to whole chunks, within kResidentBytes, so
//     n <= 1,440 in f32 and 704 in f64 -- NS5b's 64 knots, NS3b's 512), rhs is
//     staged into the slice, r overwrites it in place and the back substitution
//     reads it there: device memory sees rhs read once and k written once, the
//     bytes bound.  Otherwise (the streaming form) r goes to k in the forward
//     sweep and comes back, last chunk first, through the same ring.
//   * Per-column diagonals keep their per-column chain (streaming form): the
//     three diagonals' chunks are staged beside rhs, mid' goes to an (n, bank)
//     scratch and comes back through the ring with r.
//
// Numerics: the forward sweep and back substitution follow thomas.py
// (cubic_spline.rs:678-721) operation for operation, compiled with
// --fmad=false, so the result is bit-identical to the plain loop in
// ops/thomas.py on the same inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;    // columns a block: one warp, a lane a column
constexpr int kRows = 32;    // rows a chunk
constexpr int kStages = 8;   // chunks in flight, shared diagonals
constexpr int kStagesPc = 4; // chunks in flight, per-column diagonals (four tiles a chunk)
constexpr size_t kResidentBytes = 200 * 1024;  // the resident slice's shared memory, at most

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(static_cast<int>(sizeof(T)))
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The software pipeline of one pass over nc chunks (last chunk first when
// reverse): stage(chunk, slot) issues a chunk's copies, compute(chunk, slot)
// runs the chain over it.  A ring of S slots, or one slot per chunk (the
// resident slice), which is never reused.
template <int S, typename Stage, typename Compute>
__device__ __forceinline__ void pipeline(int64_t nc, bool reverse, bool ring, Stage stage,
                                         Compute compute) {
  auto chunk = [&](int64_t t) { return reverse ? nc - 1 - t : t; };
  auto slot = [&](int64_t t) { return ring ? t % S : chunk(t); };
  for (int s = 0; s < S; ++s) {
    if (s < nc) stage(chunk(s), slot(s));
    commit();
  }
  for (int64_t t = 0; t < nc; ++t) {
    wait_prior<S - 1>();
    __syncwarp();  // the other lanes' rows of the shared vectors have landed
    compute(chunk(t), slot(t));
    __syncwarp();  // every lane is done with the slot before it is refilled
    if (t + S < nc) stage(chunk(t + S), slot(t + S));
    commit();
  }
  wait_prior<0>();
  __syncwarp();
}

// Rows a batch: a batch's operands are read from shared memory into registers
// before its steps run, so no shared-memory load sits in the chain.  Only
// chunks that hold neither the first nor the last row take this path; those
// two run row by row with their special cases.
constexpr int kBatch = 8;

// Shared diagonals: w[i] = a_low[i] / mid'[i-1], mid'[i] = a_mid[i] - w[i] a_up[i-1]
// into wm = (w, mid') (2, n), w[0] = 0.  One warp: the lanes stage the
// diagonals, lane 0 runs the chain.
template <typename T>
__global__ void __launch_bounds__(kCols) thomas_chain_kernel(
    const T* __restrict__ a_up, const T* __restrict__ a_mid, const T* __restrict__ a_low,
    T* __restrict__ wm, int64_t n) {
  __shared__ T ring[kStages][3][kRows];  // a_low[i], a_mid[i], a_up[i - 1]
  const int lane = threadIdx.x;
  T mid = T(0);
  auto stage = [&](int64_t c, int64_t s) {
    const int64_t i = c * kRows + lane;
    if (i < n) {
      copy_async(&ring[s][0][lane], a_low + i);
      copy_async(&ring[s][1][lane], a_mid + i);
      if (i > 0) copy_async(&ring[s][2][lane], a_up + i - 1);
    }
  };
  auto compute = [&](int64_t c, int64_t s) {
    if (lane != 0) return;
    const int64_t i0 = c * kRows;
    if (c > 0 && i0 + kRows <= n) {
#pragma unroll
      for (int j0 = 0; j0 < kRows; j0 += kBatch) {
        T lo[kBatch], am[kBatch], up[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          lo[j] = ring[s][0][j0 + j];
          am[j] = ring[s][1][j0 + j];
          up[j] = ring[s][2][j0 + j];
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const T w = lo[j] / mid;
          mid = am[j] - w * up[j];
          wm[i0 + j0 + j] = w;
          wm[n + i0 + j0 + j] = mid;
        }
      }
      return;
    }
    for (int j = 0; j < kRows && i0 + j < n; ++j) {
      const int64_t i = i0 + j;
      T w = T(0);
      if (i == 0) {
        mid = ring[s][1][0];
      } else {
        w = ring[s][0][j] / mid;
        mid = ring[s][1][j] - w * ring[s][2][j];
      }
      wm[i] = w;
      wm[n + i] = mid;
    }
  };
  pipeline<kStages>((n + kRows - 1) / kRows, false, true, stage, compute);
}

// The column sweeps: a block is one warp on kCols columns.  Shared diagonals
// read w, mid' from wm (2, n) and a_up (n,); per-column ones are (n, bank) and
// write mid' to mid_s (n, bank).  RESIDENT keeps the block's whole (n, kCols)
// slice, and the three shared vectors, in shared memory.
template <typename T, bool PER_COLUMN, bool RESIDENT>
__global__ void __launch_bounds__(kCols) thomas_sweep_kernel(
    const T* __restrict__ a_up, const T* __restrict__ a_mid, const T* __restrict__ a_low,
    const T* __restrict__ rhs, T* __restrict__ k, const T* __restrict__ wm,
    T* __restrict__ mid_s, int64_t n, int64_t bank) {
  static_assert(!(PER_COLUMN && RESIDENT), "per-column diagonals stream");
  constexpr int S = PER_COLUMN ? kStagesPc : kStages;
  constexpr int NT = PER_COLUMN ? 4 : 1;  // (kRows, kCols) tiles a slot
  constexpr int NV = PER_COLUMN ? 0 : 2;  // kRows-long vectors a slot
  constexpr int kTile = kRows * kCols;
  constexpr int kSlot = NT * kTile + NV * kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  const bool live = col < bank;
  const int64_t nc = (n + kRows - 1) / kRows;
  const int64_t npad = nc * kRows;
  // resident: the vectors w, mid', a_up (3, npad), then the slice (npad, kCols)
  T* const slice = sm + 3 * npad;
  auto tile = [&](int64_t s) {  // this lane's column of the first (kRows, kCols) tile of slot s
    return (RESIDENT ? slice + s * kTile : sm + s * kSlot) + lane;
  };
  auto vec = [&](int64_t s, int f) {  // kRows-long vector f of slot s
    return RESIDENT ? sm + f * npad + s * kRows : sm + s * kSlot + NT * kTile + f * kRows;
  };

  // this lane's column of rows c kRows, ... of the (n, bank) arrays src[0..nt)
  // into tiles 0..nt of slot s; with shift, tile 2 takes row i - 1 (a_up[i - 1]
  // in the per-column forward chain, never read at row 0)
  auto stage_tiles = [&](int64_t c, int64_t s, const T* const (&src)[4], int nt, bool shift) {
    if (!live) return;
    const int64_t i0 = c * kRows;
    const int rows = static_cast<int>(n - i0 < kRows ? n - i0 : kRows);
    T* const dst = tile(s);
    for (int f = 0; f < nt; ++f) {
      const int back = shift && f == 2 ? 1 : 0;
      const int first = back && c == 0 ? 1 : 0;
      const T* p = src[f] + (i0 + first - back) * bank + col;
      for (int j = first; j < rows; ++j, p += bank) copy_async(dst + f * kTile + j * kCols, p);
    }
  };

  // forward sweep: r = rhs - w r' (and, per column, the w, mid' chain)
  T r = T(0), mid = T(0);
  auto stage_fwd = [&](int64_t c, int64_t s) {
    if (!PER_COLUMN) {
      const int64_t i = c * kRows + lane;
      if (i < n) {
        copy_async(vec(s, 0) + lane, wm + i);
        if (RESIDENT) {
          copy_async(vec(s, 1) + lane, wm + n + i);
          copy_async(vec(s, 2) + lane, a_up + i);
        }
      }
      const T* const src[4] = {rhs, rhs, rhs, rhs};
      stage_tiles(c, s, src, 1, false);
    } else {
      const T* const src[4] = {a_low, a_mid, a_up, rhs};
      stage_tiles(c, s, src, 4, true);
    }
  };
  auto compute_fwd = [&](int64_t c, int64_t s) {
    if (!live) return;
    const int64_t i0 = c * kRows;
    T* const t = tile(s);
    const T* const w = vec(s, 0);
    if (c > 0 && i0 + kRows <= n) {
#pragma unroll
      for (int j0 = 0; j0 < kRows; j0 += kBatch) {
        if (PER_COLUMN) {
          T lo[kBatch], am[kBatch], up[kBatch], rh[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const T* e = t + (j0 + j) * kCols;
            lo[j] = e[0];
            am[j] = e[kTile];
            up[j] = e[2 * kTile];
            rh[j] = e[3 * kTile];
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const T wi = lo[j] / mid;
            mid = am[j] - wi * up[j];
            r = rh[j] - wi * r;
            mid_s[(i0 + j0 + j) * bank + col] = mid;
            k[(i0 + j0 + j) * bank + col] = r;
          }
        } else {
          T rh[kBatch], wj[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            rh[j] = t[(j0 + j) * kCols];
            wj[j] = w[j0 + j];
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            r = rh[j] - wj[j] * r;
            if (RESIDENT) {
              t[(j0 + j) * kCols] = r;
            } else {
              k[(i0 + j0 + j) * bank + col] = r;
            }
          }
        }
      }
      return;
    }
    for (int j = 0; j < kRows && i0 + j < n; ++j) {
      const int64_t i = i0 + j;
      T* e = t + j * kCols;
      if (PER_COLUMN) {
        if (i == 0) {
          mid = e[kTile];
          r = e[3 * kTile];
        } else {
          const T wi = e[0] / mid;
          mid = e[kTile] - wi * e[2 * kTile];
          r = e[3 * kTile] - wi * r;
        }
        mid_s[i * bank + col] = mid;
        k[i * bank + col] = r;
      } else {
        r = i == 0 ? *e : *e - w[j] * r;
        if (RESIDENT) {
          *e = r;
        } else {
          k[i * bank + col] = r;
        }
      }
    }
  };
  pipeline<S>(nc, false, !RESIDENT, stage_fwd, compute_fwd);
  // this thread's stores of r (and mid') are read back by its own cp.async
  __threadfence_block();

  // back substitution, last row first: k = (r - a_up k') / mid'
  T kn = T(0);
  auto stage_back = [&](int64_t c, int64_t s) {
    if (!PER_COLUMN) {
      const int64_t i = c * kRows + lane;
      if (i < n) {
        copy_async(vec(s, 0) + lane, wm + n + i);
        copy_async(vec(s, 1) + lane, a_up + i);
      }
      const T* const src[4] = {k, k, k, k};
      stage_tiles(c, s, src, 1, false);
    } else {
      const T* const src[4] = {k, mid_s, a_up, k};
      stage_tiles(c, s, src, 3, false);
    }
  };
  // mid' and a_up of row j of the slot: per column from tiles 1 and 2, shared
  // from the vectors (0, 1 when streamed; 1, 2 in the resident layout)
  auto mu = [&](int64_t s, const T* e, int j, T& m, T& u) {
    if (PER_COLUMN) {
      m = e[kTile];
      u = e[2 * kTile];
    } else {
      m = vec(s, RESIDENT ? 1 : 0)[j];
      u = vec(s, RESIDENT ? 2 : 1)[j];
    }
  };
  auto compute_back = [&](int64_t c, int64_t s) {
    if (!live) return;
    const int64_t i0 = c * kRows;
    const T* const t = tile(s);
    if (i0 + kRows < n) {
#pragma unroll
      for (int j0 = kRows - kBatch; j0 >= 0; j0 -= kBatch) {
        T rj[kBatch], m[kBatch], u[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const T* e = t + (j0 + j) * kCols;
          rj[j] = *e;
          mu(s, e, j0 + j, m[j], u[j]);
        }
#pragma unroll
        for (int j = kBatch - 1; j >= 0; --j) {
          kn = (rj[j] - u[j] * kn) / m[j];
          k[(i0 + j0 + j) * bank + col] = kn;
        }
      }
      return;
    }
    for (int j = kRows - 1; j >= 0; --j) {
      const int64_t i = i0 + j;
      if (i >= n) continue;
      const T* e = t + j * kCols;
      T m, u;
      mu(s, e, j, m, u);
      kn = i == n - 1 ? *e / m : (*e - u * kn) / m;
      k[i * bank + col] = kn;
    }
  };
  if (RESIDENT) {
    for (int64_t c = nc - 1; c >= 0; --c) compute_back(c, c);
  } else {
    pipeline<S>(nc, true, true, stage_back, compute_back);
  }
}

template <typename T>
size_t sweep_smem(int64_t n, bool per_column, bool resident) {
  const int64_t npad = (n + kRows - 1) / kRows * kRows;
  if (resident) return static_cast<size_t>((3 + kCols) * npad) * sizeof(T);
  const int64_t slot = per_column ? 4 * kRows * kCols : kRows * kCols + 2 * kRows;
  return static_cast<size_t>((per_column ? kStagesPc : kStages) * slot) * sizeof(T);
}

template <typename T, bool PER_COLUMN, bool RESIDENT>
cudaError_t sweep(const T* a_up, const T* a_mid, const T* a_low, const T* rhs, T* k, T* scratch,
                  int64_t n, int64_t bank, cudaStream_t s) {
  auto kernel = thomas_sweep_kernel<T, PER_COLUMN, RESIDENT>;
  const size_t smem = sweep_smem<T>(n, PER_COLUMN, RESIDENT);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned int blocks = static_cast<unsigned int>((bank + kCols - 1) / kCols);
  kernel<<<blocks, kCols, smem, s>>>(a_up, a_mid, a_low, rhs, k, scratch, scratch, n, bank);
  return cudaGetLastError();
}

// scratch: (2, n) for w and mid' with shared diagonals, (n, bank) for mid'
// with per-column ones (ops/thomas_kernel.py allocates it)
template <typename T>
int thomas(const void* a_up_, const void* a_mid_, const void* a_low_, const void* rhs_, void* k_,
           void* scratch_, int64_t n, int64_t bank, int64_t per_column, void* stream) {
  if (n <= 0 || bank <= 0) return static_cast<int>(cudaGetLastError());
  const T* a_up = static_cast<const T*>(a_up_);
  const T* a_mid = static_cast<const T*>(a_mid_);
  const T* a_low = static_cast<const T*>(a_low_);
  const T* rhs = static_cast<const T*>(rhs_);
  T* k = static_cast<T*>(k_);
  T* scratch = static_cast<T*>(scratch_);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (per_column) {
    err = sweep<T, true, false>(a_up, a_mid, a_low, rhs, k, scratch, n, bank, s);
  } else {
    thomas_chain_kernel<T><<<1, kCols, 0, s>>>(a_up, a_mid, a_low, scratch, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool resident = sweep_smem<T>(n, false, true) <= kResidentBytes;
    err = resident ? sweep<T, false, true>(a_up, a_mid, a_low, rhs, k, scratch, n, bank, s)
                   : sweep<T, false, false>(a_up, a_mid, a_low, rhs, k, scratch, n, bank, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int ndi_thomas_f32(const void* a_up, const void* a_mid, const void* a_low, const void* rhs,
                   void* k, void* scratch, int64_t n, int64_t bank, int64_t per_column,
                   void* stream) {
  return thomas<float>(a_up, a_mid, a_low, rhs, k, scratch, n, bank, per_column, stream);
}

int ndi_thomas_f64(const void* a_up, const void* a_mid, const void* a_low, const void* rhs,
                   void* k, void* scratch, int64_t n, int64_t bank, int64_t per_column,
                   void* stream) {
  return thomas<double>(a_up, a_mid, a_low, rhs, k, scratch, n, bank, per_column, stream);
}

}  // extern "C"
