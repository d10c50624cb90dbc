"""Host serving with the native C++ runtime.

The port's twin of the JAX package's ``examples/native_host_serving.py``.
The card owns batched work; scalar lookups and small host batches, where a
launch and the copy back would cost more than the arithmetic, are served by
the native runtime (``ndarray_interp_tpu_torch.native``): the interval
search with an even-spacing guess, the flat linear and Hermite forms and the
bilinear and bicubic ones.  The eager entry points (``interp_scalar``,
``interp_array`` on numpy queries) take it by themselves where it is built.

Run: ``python -m ndarray_interp_tpu_torch.examples.native_host_serving``
(the interpolators on the GPU; ``main(device="cpu")`` on the CPU).
"""

import numpy as np
import torch

from ndarray_interp_tpu_torch import native
from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D, bicubic_node_grids


def main(device=None):
    """The runtime's batch and scalar forms, then interpolators serving host
    queries through it; ``device`` as the builder takes it (the GPU unless
    named)."""
    if not native.HAVE_NATIVE:
        print("native runtime unavailable: build it with "
              "`python -m ndarray_interp_tpu_torch.native.build`")
        return
    rng = np.random.default_rng(0)

    # 1-D cubic bank, built on the host (no card needed)
    n = 4096
    x = np.cumsum(rng.uniform(0.5, 1.5, n))
    y = rng.normal(size=n)
    a, b = native.cubic_build(x, y, 0, 0.0, 0, 0.0)  # not-a-knot both ends
    q = rng.uniform(x[0], x[-1], 100_000)
    out, rc = native.eval_hermite(x, y, a, b, q, mode=1)
    assert rc == 0
    print(f"1-D cubic: {out.shape[0]} queries, first={out[0]:.6f}")

    # the scalar serving object (one C call a query)
    s1 = native.ScalarEval1D(x, y, a, b, mode=1)
    v, err = s1(float(x[10]))
    assert err == 0
    print(f"scalar eval at x={x[10]:.3f}: {v:.6f} (== y[10] {y[10]:.6f})")

    # the same spline as an interpolator: numpy and float queries take the
    # native route, tensors the interpolator's device
    itp = Interp1D.builder(y, device=device).x(x).strategy(CubicSpline().extrapolate(True)).build()
    got = itp.interp_scalar(float(x[10]))
    assert isinstance(got, float) and abs(got - y[10]) <= 1e-12 * np.abs(y).max()
    assert isinstance(itp.interp_array(q[:8]), np.ndarray)

    # 2-D bicubic: the node grids from the strategy's solves, served natively
    nx, ny = 200, 160
    gx = np.cumsum(rng.uniform(0.5, 1.5, nx))
    gy = np.cumsum(rng.uniform(0.5, 1.5, ny))
    z = rng.normal(size=(nx, ny))
    kx, ky, kxy = (g.numpy() for g in bicubic_node_grids(
        torch.as_tensor(gx), torch.as_tensor(gy), torch.as_tensor(z)))
    qx = rng.uniform(gx[0], gx[-1], 50_000)
    qy = rng.uniform(gy[0], gy[-1], 50_000)
    out2, rc = native.eval_bicubic(gx, gy, z, kx, ky, kxy, qx, qy, False)
    assert rc == 0
    print(f"2-D bicubic: {out2.shape[0]} queries, first={out2[0]:.6f}")
    itp2 = Interp2D.builder(z, device=device).x(gx).y(gy).strategy(Bicubic()).build()
    v2 = itp2.interp_scalar(float(qx[0]), float(qy[0]))
    assert abs(v2 - out2[0]) <= 1e-10 * max(1.0, abs(out2[0]))


if __name__ == "__main__":
    main()
