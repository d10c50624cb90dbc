"""The port's native host runtime (``ndarray_interp_tpu_torch/native``) and
the eager paths it serves, on the CPU.

Twins of every test of ``tests/test_native.py``, case by case, on the same
inputs: the port's own build of the runtime's C++ source held to the JAX
package's XLA results (its interpolators built from and queried with jnp
arrays, so the JAX package's library is never built or loaded here) at the
JAX file's tolerances (``rtol=1e-13, atol=1e-14`` for the batch forms, 1e-12
for the cubic build, 1e-10 for the bicubic node form), and the port's
interpolators taking the native route for numpy and float queries.  Also:
six processes importing the loader at once with no library in their build
directory all end with ``HAVE_NATIVE``, and ``config.use_native_host`` off
puts every query on the tensor path.  The native route on a card
interpolator is a ``cuda`` test in ``tests/test_torch_kernels.py``.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
from ndarray_interp_tpu.interp1d.cubic_spline import BoundaryCondition as JBC
from ndarray_interp_tpu.models.strategies.cubic import _ab_from_k as j_ab_from_k
from ndarray_interp_tpu.models.strategies.cubic import _solve_for_k as j_solve_for_k
from ndarray_interp_tpu_torch import OutOfBoundsError, config, native
from ndarray_interp_tpu_torch.interp1d import Akima, CubicSpline, Interp1D, Linear
from ndarray_interp_tpu_torch.interp1d.cubic_spline import BoundaryCondition
from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
from ndarray_interp_tpu_torch.native.build import LIB_NAME
from ndarray_interp_tpu_torch.models.strategies.bicubic import (
    _solve_axis0,
    _solve_axis1,
    bicubic_node_grids,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _runtime():
    if not native.HAVE_NATIVE:
        pytest.fail("the native runtime did not build (is g++ installed?)")


def T(a):
    return torch.as_tensor(np.asarray(a))


def test_lower_index_contract():
    # the contract of ops/searchsorted (vector_extensions.rs:55-111)
    x = np.linspace(0.0, 10.0, 11)
    assert native.lower_index(x, -1.0) == 0
    assert native.lower_index(x, 25.0) == 9
    assert native.lower_index(x, 0.0) == 0
    assert native.lower_index(x, 10.0) == 9
    assert native.lower_index(x, np.inf) == 9
    assert native.lower_index(x, -np.inf) == 0
    for i in range(100):
        assert native.lower_index(x, i / 10.0) == i // 10
    # log-spaced stresses the guess-then-bisect path
    xe = np.array([2.0**i for i in range(11)])
    for xi in range(100):
        assert native.lower_index(xe, 2.0 ** (xi / 10.0)) == xi // 10


def test_monotonic_codes():
    assert native.monotonic(np.array([1.0, 2, 3])) == 0
    assert native.monotonic(np.array([1.0, 1, 2])) == 1
    assert native.monotonic(np.array([3.0, 2, 1])) == 2
    assert native.monotonic(np.array([3.0, 3, 1])) == 3
    assert native.monotonic(np.array([1.0, 3, 2])) == 4
    assert native.monotonic(np.array([1.0])) == 4


def test_native_linear_matches_jax():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 30))
    y = rng.normal(size=(30, 4))
    q = rng.uniform(-2, 12, 200)
    itp = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)) \
        .strategy(j1.Linear().extrapolate(True)).build()
    jax_out = np.asarray(itp.interp_array(jnp.asarray(q)))
    nat_out, rc = native.eval_linear(x, y, q, True)
    assert rc == 0
    np.testing.assert_allclose(nat_out, jax_out, rtol=1e-13, atol=1e-14)
    # the port's interpolator serves numpy queries natively, as numpy
    t = Interp1D.builder(y, device="cpu").x(x).strategy(Linear().extrapolate(True)).build()
    got = t.interp_array(q)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, nat_out)


def test_native_hermite_matches_jax():
    rng = np.random.default_rng(1)
    y = rng.normal(size=16)
    q = rng.uniform(-2, 17, 300)
    itp = j1.Interp1D.builder(jnp.asarray(y)).strategy(j1.CubicSpline().extrapolate(True)).build()
    jax_out = np.asarray(itp.interp_array(jnp.asarray(q)))
    x = np.arange(16.0)
    nat_out, rc = native.eval_hermite(x, y, np.asarray(itp.strategy.a),
                                      np.asarray(itp.strategy.b), q, 1)
    assert rc == 0
    np.testing.assert_allclose(nat_out, jax_out, rtol=1e-13, atol=1e-14)
    t = Interp1D.builder(y, device="cpu").strategy(CubicSpline().extrapolate(True)).build()
    np.testing.assert_allclose(t.interp_array(q), jax_out, rtol=1e-13, atol=1e-14)


def test_scalar_fast_path_fires_and_matches():
    y = np.array([1.5, 2.0, 3.0, 4.0, 5.0, 7.0, 7.0, 8.0, 9.0, 10.5])
    itp = Interp1D.builder(y, device="cpu").build()
    assert itp.interp_scalar(4.5) == 6.0
    assert itp._native_state() is not None  # cache primed, native eligible
    assert itp._scalar_evaluator() is not None
    jitp = j1.Interp1D.builder(jnp.asarray(y)).build()
    assert float(jitp.interp_scalar(jnp.asarray(4.5))) == 6.0
    # OOB through the native path
    with pytest.raises(OutOfBoundsError):
        itp.interp_scalar(-0.5)


def test_scalar_fast_path_akima():
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(0, 10, 12))
    y = rng.normal(size=12)
    itp = Interp1D.builder(y, device="cpu").x(x).strategy(Akima()).build()
    jitp = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)).strategy(j1.Akima()).build()
    ref = si.Akima1DInterpolator(x, y)
    for q in np.linspace(x[0], x[-1], 17):
        got = itp.interp_scalar(q)
        assert isinstance(got, float)
        assert abs(got - float(ref(q))) < 1e-12
        assert abs(got - float(jitp.interp_scalar(jnp.asarray(q)))) < 1e-12


def test_scalar_fast_path_2d():
    data = np.array([[1.0, 2.0, 2.5], [3.0, 4.0, 3.5]])
    itp = Interp2D.builder(data, device="cpu").build()
    assert itp.interp_scalar(0.0, 0.5) == 1.5
    assert itp._native_state() is not None
    jitp = j2.Interp2D.builder(jnp.asarray(data)).build()
    assert float(jitp.interp_scalar(jnp.asarray(0.0), jnp.asarray(0.5))) == 1.5
    with pytest.raises(OutOfBoundsError, match="y ="):
        itp.interp_scalar(0.5, 99.0)


def test_native_periodic_wrap():
    data = np.array([1.0, 2.0, 2.5, 2.5, 3.0, 2.0, 1.0, -2.0, 3.0, 5.0, 6.3, 1.0])
    itp = Interp1D.builder(data, device="cpu").strategy(
        CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic)).build()
    jitp = j1.Interp1D.builder(jnp.asarray(data)).strategy(
        j1.CubicSpline().extrapolate(True).boundary(JBC.Periodic)).build()
    # the native scalar path wraps as the tensor path and the JAX path do
    for q in (-3.0, 14.5, 25.0):
        nat = itp.interp_scalar(q)
        assert isinstance(nat, float)
        assert abs(nat - float(itp.interp(q))) < 1e-12
        assert abs(nat - float(jitp.interp(jnp.asarray(q)))) < 1e-12


def test_native_cubic_build_matches_jax():
    rng = np.random.default_rng(3)
    for kinds in [(0, 0.0, 0, 0.0), (2, 0.0, 2, 0.0), (1, -0.1, 2, -0.5)]:
        n, bank = 14, 3
        x = np.sort(rng.uniform(0, 10, n))
        y = rng.normal(size=(n, bank))
        a, b = native.cubic_build(x, y, *kinds)
        k = j_solve_for_k(jnp.asarray(x), jnp.asarray(y), *kinds)
        aj, bj = j_ab_from_k(jnp.asarray(x), jnp.asarray(y), k)
        np.testing.assert_allclose(a, np.asarray(aj), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b, np.asarray(bj), rtol=1e-12, atol=1e-12)


def test_scalar_fast_path_cubic_exact():
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0, 10, 15))
    y = rng.normal(size=15)
    itp = Interp1D.builder(y, device="cpu").x(x).strategy(CubicSpline().extrapolate(True)).build()
    ref = si.CubicSpline(x, y, bc_type="not-a-knot")
    for q in np.linspace(x[0] - 1, x[-1] + 1, 23):
        assert abs(float(itp.interp_scalar(float(q))) - float(ref(q))) < 1e-10


def test_lower_index_nan_safe():
    # NaN queries must not reach the int cast of the C entry points: NaN
    # takes interval 0 and evaluates to NaN
    x = np.linspace(0.0, 10.0, 11)
    assert native.lower_index(x, np.nan) == 0
    lib = native._load()
    q = np.array([np.nan, 2.5, np.nan, 11.0])
    idx = np.zeros(4, np.int64)
    lib.ndi_lower_index_batch_f64(
        native._ptr(x), 11, native._ptr(q), 4,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    assert list(idx) == [0, 2, 0, 9]
    # the blocked (SIMD) eval path: NaN reaches it only when extrapolating
    y = np.arange(11.0)
    qs = np.full(300, np.nan)
    qs[::3] = 4.5
    out, rc = native.eval_linear(x, y, qs, True)
    assert rc == 0
    assert np.isnan(out[1]) and np.isnan(out[2])
    np.testing.assert_allclose(out[::3], 4.5)
    # not extrapolating: NaN aborts, the 1-based index of the bad query
    out, rc = native.eval_linear(x, y, np.array([1.0, np.nan]), False)
    assert rc == 2


def test_native_bicubic_matches_jax():
    """The native bicubic (node-state nested Hermite) on the port's node
    grids equals the JAX ``Bicubic`` (XLA) and the port's tensor path,
    extrapolation included; the out-of-range codes mirror bilinear's."""
    rng = np.random.default_rng(17)
    nx, ny = 14, 11
    x = np.cumsum(rng.uniform(0.3, 1.0, nx))
    y = np.cumsum(rng.uniform(0.3, 1.0, ny))
    for trailing in [(), (3,)]:
        z = rng.normal(size=(nx, ny) + trailing)
        jitp = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)) \
            .strategy(j2.Bicubic().extrapolate(True)).build()
        kx, ky, kxy = (g.numpy() for g in bicubic_node_grids(T(x), T(y), T(z)))
        # the public helper equals the private solves it wraps
        np.testing.assert_array_equal(kx, _solve_axis0(T(x), T(z), "not_a_knot").numpy())
        span = x[-1] - x[0]
        qx = rng.uniform(x[0] - span / 4, x[-1] + span / 4, 200)
        qy = rng.uniform(y[0], y[-1], 200)
        out, rc = native.eval_bicubic(x, y, z, kx, ky, kxy, qx, qy, True)
        assert rc == 0
        want = np.asarray(jitp.interp_array(jnp.asarray(qx), jnp.asarray(qy)))
        np.testing.assert_allclose(out, want, rtol=1e-10, atol=1e-10)
        t = Interp2D.builder(z, device="cpu").x(x).y(y).strategy(Bicubic().extrapolate(True)) \
            .build()
        got = t.interp_array(qx, qy)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, out)
        np.testing.assert_allclose(got, t.interp_array(T(qx), T(qy)).numpy(), rtol=1e-10,
                                   atol=1e-10)
    # out of range: positive 1-based for x, negative for y; nothing written
    z = rng.normal(size=(nx, ny))
    kx = _solve_axis0(T(x), T(z), "not_a_knot").numpy()
    ky = _solve_axis1(T(y), T(z), "not_a_knot").numpy()
    kxy = _solve_axis1(T(y), T(kx), "not_a_knot").numpy()
    _, rc = native.eval_bicubic(x, y, z, kx, ky, kxy, np.array([x[1], x[-1] + 1.0]),
                                np.array([y[1], y[1]]), False)
    assert rc == 2
    _, rc = native.eval_bicubic(x, y, z, kx, ky, kxy, np.array([x[1], x[1]]),
                                np.array([y[0] - 1.0, y[1]]), False)
    assert rc == -1


def test_native_host_serving_example_runs():
    from ndarray_interp_tpu_torch.examples import native_host_serving

    native_host_serving.main(device="cpu")  # asserts inside (rc == 0, the scalar round trip)


def test_native_2d_query_length_mismatch_raises():
    # the C++ loops index qy by qx's length: the wrapper refuses mismatched
    # pairs instead of reading out of bounds
    x = np.linspace(0.0, 3.0, 4)
    y = np.linspace(0.0, 2.0, 3)
    z = np.zeros((4, 3))
    with pytest.raises(ValueError, match="do not match"):
        native.eval_bilinear(x, y, z, np.zeros(5), np.zeros(2), True)
    with pytest.raises(ValueError, match="do not match"):
        native.eval_bicubic(x, y, z, z, z, z, np.zeros(5), np.zeros(2), True)


# -- beyond the JAX file ------------------------------------------------------------------
_IMPORT_AT_ONCE = """
import sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
ready = Path({tmp!r}) / "ready"
ready.mkdir(exist_ok=True)
(ready / str({i})).touch()
deadline = time.monotonic() + 60
while len(list(ready.iterdir())) < {n} and time.monotonic() < deadline:
    time.sleep(0.01)
from ndarray_interp_tpu_torch import native
lib = native.NativeLibrary(Path({tmp!r}) / "build").load()
print(native.HAVE_NATIVE and lib is not None and lib.ndi_monotonic_f64 is not None)
"""


def test_concurrent_first_imports_all_load(tmp_path):
    """Six processes that import the loader at once, with no library in
    their build directory, all end with the library loaded: the build runs
    under a file lock and moves a finished library into place."""
    n = 6
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _IMPORT_AT_ONCE.format(root=str(ROOT), tmp=str(tmp_path),
                                                          i=i, n=n)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(n)
    ]
    outs = []
    deadline = time.monotonic() + 240
    for p in procs:
        out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        outs.append((p.returncode, out.strip(), err[-2000:]))
    assert all(rc == 0 and out == "True" for rc, out, _ in outs), outs
    assert (tmp_path / "build" / LIB_NAME).exists()


def test_use_native_host_off_takes_the_tensor_path(monkeypatch):
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 10, 15))
    y = rng.normal(size=15)
    monkeypatch.setattr(config, "use_native_host", False)
    itp = Interp1D.builder(y, device="cpu").x(x).strategy(CubicSpline()).build()
    got = itp.interp_array(np.array([1.0, 2.0]))
    assert isinstance(got, torch.Tensor)
    assert isinstance(itp.interp_scalar(3.0), torch.Tensor)
    assert itp._native_state() is None
    itp2 = Interp2D.builder(rng.normal(size=(4, 5)), device="cpu").build()
    assert isinstance(itp2.interp_scalar(1.0, 1.0), torch.Tensor)


def test_grad_inputs_take_the_tensor_path():
    """A CPU interpolator whose tensors need their gradient keeps the tensor
    path (the native runtime would drop the gradient)."""
    x = torch.linspace(0.0, 1.0, 8, dtype=torch.float64)
    y = torch.randn(8, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    y.requires_grad_()
    itp = Interp1D.builder(y).x(x).strategy(CubicSpline()).build()
    out = itp.interp_scalar(0.3)
    assert isinstance(out, torch.Tensor) and out.requires_grad


@pytest.mark.parametrize("when", ["after_builder", "after_build"])
def test_writes_to_numpy_inputs_change_no_route(when):
    """A write to the caller's numpy arrays after they were handed to the
    builder changes neither the native route nor the tensor path: both
    answer from the data as it was given."""
    rng = np.random.default_rng(11)
    x, v = np.sort(rng.uniform(0, 10, 12)), rng.normal(size=12)
    z = rng.normal(size=(6, 7))
    want1 = si.CubicSpline(x, v, bc_type="not-a-knot")(3.3)
    b1 = Interp1D.builder(v, device="cpu").x(x).strategy(CubicSpline())
    b2 = Interp2D.builder(z, device="cpu").strategy(Bicubic())
    if when == "after_builder":
        v[:], x[:], z[:] = 0.0, np.arange(12.0), 0.0
    itp1, itp2 = b1.build(), b2.build()
    want2 = float(itp2(T(2.5), T(3.25)))
    if when == "after_build":
        v[:], x[:], z[:] = 0.0, np.arange(12.0), 0.0
    host1, host2 = itp1.interp_scalar(3.3), itp2.interp_scalar(2.5, 3.25)
    assert isinstance(host1, float) and isinstance(host2, float)
    assert host1 == pytest.approx(want1, rel=1e-12)
    assert host1 == pytest.approx(float(itp1(T(3.3))), rel=1e-12)
    assert host2 == pytest.approx(want2, rel=1e-12)
    assert host2 == pytest.approx(float(itp2(T(2.5), T(3.25))), rel=1e-12)
