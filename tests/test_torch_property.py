"""Property tests of the port: random axes, data and queries against SciPy,
numpy and the JAX package, on the CPU.

Twins of every test of ``tests/test_property.py``, case by case: the same
seeds draw the same fixtures, the port (numpy inputs on ``device="cpu"``,
tensor queries: the tensor path) is held to the JAX test's oracle at its
tolerance and to the JAX interpolator (XLA, jnp inputs and queries) at the
same tolerance.  The native case holds the port's numpy-query route (the
native host runtime, numpy out) to its tensor route and to the JAX XLA
result at ``rtol=1e-13, atol=1e-13``.
"""

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
from ndarray_interp_tpu.interp1d import cubic_spline as jcs
from ndarray_interp_tpu_torch.interp1d import Akima, CubicSpline, Interp1D, Pchip
from ndarray_interp_tpu_torch.interp1d.cubic_spline import (
    BoundaryCondition,
    RowBoundary,
    SingleBoundary,
)
from ndarray_interp_tpu_torch.interp2d import Interp2D

SEEDS = [1, 7, 42]


def axis(rng, n, spacing):
    if spacing == "uniform":
        return np.linspace(0.0, 10.0, n)
    if spacing == "log":
        return np.logspace(0.0, 1.0, n)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    x[0], x[-1] = 0.0, 10.0
    return x


def T(v):
    return torch.as_tensor(np.asarray(v))


def both1d(x, y, strat, jstrat=None):
    t = Interp1D.builder(y, device="cpu").x(x)
    j = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x))
    if strat is not None:
        t, j = t.strategy(strat), j.strategy(jstrat)
    return t.build(), j.build()


def check(t, j, q, want, **tol):
    got = t.interp_array(T(q)).numpy()
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, np.asarray(j.interp_array(jnp.asarray(q))), **tol)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spacing", ["uniform", "random", "log"])
def test_linear_vs_numpy_interp(seed, spacing):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    x = axis(rng, n, spacing)
    y = rng.normal(size=n)
    q = rng.uniform(x[0], x[-1], 257)
    t, j = both1d(x, y, None)
    check(t, j, q, np.interp(q, x, y), atol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bc, bc_scipy", [("NotAKnot", "not-a-knot"), ("Natural", "natural"),
                                          ("Clamped", "clamped")])
def test_cubic_random_fixtures(seed, bc, bc_scipy):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 50))
    x = axis(rng, n, "random")
    y = rng.normal(size=(n, int(rng.integers(1, 4))))
    q = rng.uniform(x[0] - 2, x[-1] + 2, 301)
    t, j = both1d(x, y, CubicSpline().extrapolate(True).boundary(getattr(BoundaryCondition, bc)),
                  jcs.CubicSpline().extrapolate(True).boundary(getattr(jcs.BoundaryCondition, bc)))
    check(t, j, q, si.CubicSpline(x, y, bc_type=bc_scipy)(q), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("seed", SEEDS)
def test_cubic_periodic_random(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 30))
    x = axis(rng, n, "random")
    y = rng.normal(size=n)
    y[-1] = y[0]
    q = rng.uniform(x[0] - 13, x[-1] + 13, 301)
    t, j = both1d(x, y, CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic),
                  jcs.CubicSpline().extrapolate(True).boundary(jcs.BoundaryCondition.Periodic))
    qw = np.mod(q - x[0], x[-1] - x[0]) + x[0]
    check(t, j, q, si.CubicSpline(x, y, bc_type="periodic")(qw), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name, oracle_cls", [("Akima", si.Akima1DInterpolator),
                                              ("Pchip", si.PchipInterpolator)])
def test_hermite_strategies_random(seed, name, oracle_cls):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    x = axis(rng, n, "random")
    y = rng.normal(size=n)
    q = rng.uniform(x[0], x[-1], 301)
    port = {"Akima": Akima, "Pchip": Pchip}[name]
    t, j = both1d(x, y, port(), getattr(j1, name)())
    check(t, j, q, oracle_cls(x, y)(q), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_bilinear_random_fixtures(seed):
    rng = np.random.default_rng(seed)
    nx = int(rng.integers(2, 30))
    ny = int(rng.integers(2, 30))
    x = axis(rng, nx, "random")
    y = axis(rng, ny, "uniform")
    z = rng.normal(size=(nx, ny))
    qx = rng.uniform(x[0], x[-1], 301)
    qy = rng.uniform(y[0], y[-1], 301)
    t = Interp2D.builder(z, device="cpu").x(x).y(y).build()
    j = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).build()
    want = si.RegularGridInterpolator((x, y), z, method="linear")(np.stack([qx, qy], -1))
    got = t.interp_array(T(qx), T(qy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        got, np.asarray(j.interp_array(jnp.asarray(qx), jnp.asarray(qy))), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("seed", SEEDS)
def test_native_batch_agrees_with_jax_random(seed):
    """The numpy-input (native) and tensor-input routes agree on random
    data, and with the JAX package's jnp (XLA) route."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    x = axis(rng, n, "random")
    y = rng.normal(size=n)
    q = rng.uniform(x[0] - 1, x[-1] + 1, 123)
    t, j = both1d(x, y, CubicSpline().extrapolate(True), jcs.CubicSpline().extrapolate(True))
    native_out = t.interp_array(q)  # numpy in: the native route
    assert isinstance(native_out, np.ndarray)
    np.testing.assert_allclose(native_out, t.interp_array(T(q)).numpy(), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(native_out, np.asarray(j.interp_array(jnp.asarray(q))),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("seed", [13, 21, 99])
def test_individual_boundaries_random_vs_scipy(seed):
    """Random per-row boundary assignments against per-column SciPy splines."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 24))
    bank = int(rng.integers(2, 5))
    x = axis(rng, n, "random")
    y = rng.normal(size=(n, bank))
    kinds = ["not-a-knot", "natural", "clamped", (1, 0.7), (2, -1.3)]

    def single(m, k):
        if isinstance(k, str):
            return getattr(m.SingleBoundary, {"not-a-knot": "NotAKnot", "natural": "Natural",
                                              "clamped": "Clamped"}[k])
        d, v = k
        return m.SingleBoundary.FirstDeriv(v) if d == 1 else m.SingleBoundary.SecondDeriv(v)

    picks = [(kinds[rng.integers(0, 5)], kinds[rng.integers(0, 5)]) for _ in range(bank)]

    def rows(m):
        return m.BoundaryCondition.Individual(np.array(
            [[m.RowBoundary.Mixed(single(m, lft), single(m, rgt)) for lft, rgt in picks]],
            dtype=object))

    class port:
        BoundaryCondition, RowBoundary, SingleBoundary = (BoundaryCondition, RowBoundary,
                                                          SingleBoundary)

    t, j = both1d(x, y, CubicSpline().extrapolate(True).boundary(rows(port)),
                  jcs.CubicSpline().extrapolate(True).boundary(rows(jcs)))
    q = rng.uniform(x[0] - 1, x[-1] + 1, 151)
    got = t.interp_array(T(q)).numpy()
    for col, (lft, rgt) in enumerate(picks):
        oracle = si.CubicSpline(x, y[:, col], bc_type=(lft, rgt))
        np.testing.assert_allclose(got[:, col], oracle(q), rtol=1e-7, atol=1e-7,
                                   err_msg=f"col {col} bounds {lft}/{rgt}")
    np.testing.assert_allclose(got, np.asarray(j.interp_array(jnp.asarray(q))), rtol=1e-7,
                               atol=1e-7)
