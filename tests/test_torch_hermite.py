"""The port's Akima, Makima and Pchip strategies
(``models/strategies/hermite.py``) against the JAX package's and SciPy, on
the CPU: the twins of ``TestAkima``, ``TestMakima`` and ``TestPchip`` in
``tests/test_strategies.py``.

The same numpy inputs, made from seeds, build an interpolator in both
packages; the coefficient banks ``a``, ``b`` are compared, and the values
with SciPy (``Akima1DInterpolator``, with ``method="makima"`` for Makima,
and ``PchipInterpolator``).

Tolerances: float64 values against SciPy at ``atol=1e-13`` and extrapolated
values at ``1e-11``, as the JAX tests (``test_strategies.py:43``, ``:86``);
``a``, ``b`` against the JAX package at ``rtol=1e-12`` with ``atol=1e-12``
of the largest |value| in float64, and ``rtol=2e-5`` with ``atol=1e-6`` of
it in float32 (the two frameworks may contract multiply-adds differently).
"""

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.errors as j_err
import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.models.strategies.hermite as j_herm
import ndarray_interp_tpu.ops.pallas_eval as j_pe
import ndarray_interp_tpu_torch.errors as t_err
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.models.strategies.cubic as t_cubic
from ndarray_interp_tpu_torch.interop import interp1d_from_numpy
from ndarray_interp_tpu_torch.models.strategies.cubic import CubicSplineStrategy
from ndarray_interp_tpu_torch import config as tconfig


@pytest.fixture(autouse=True)
def native_host(request, monkeypatch):
    """The route of numpy and float queries: the tensor path (on the CPU the
    kernels' plain versions), and in the cases marked ``BOTH_ROUTES`` also the
    native host runtime, the default, on the same inputs and tolerances."""
    on = getattr(request, "param", False)
    monkeypatch.setattr(tconfig, "use_native_host", on)
    return on


BOTH_ROUTES = pytest.mark.parametrize(
    "native_host", [False, True], ids=["tensor", "native"], indirect=True
)


NAMES = ("Akima", "Makima", "Pchip")
TOL = {np.float32: (2e-5, 1e-6), np.float64: (1e-12, 1e-12)}


def scipy_of(name, x, y, extrapolate=None):
    if name == "Pchip":
        return si.PchipInterpolator(x, y, extrapolate=extrapolate)
    method = "makima" if name == "Makima" else "akima"
    return si.Akima1DInterpolator(x, y, method=method, extrapolate=extrapolate)


def case(n=20, bank=None, seed=5):
    """``tests/test_strategies.py:24-30``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    shape = (n,) if bank is None else (n, bank)
    y = rng.normal(size=shape)
    q = np.linspace(x[0], x[-1], 7 * n)
    return x, y, q


def build(pkg, name, x, y, extrapolate=False):
    if pkg == "jax":
        return (j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x))
                .strategy(getattr(j1, name)(extrapolate=extrapolate)).build())
    return (t1.Interp1D.builder(y, device="cpu").x(x)
            .strategy(getattr(t1, name)(extrapolate=extrapolate)).build())


def assert_close(got, want, dtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bank", [None, 7, (3, 4)])
@pytest.mark.parametrize("name", NAMES)
def test_coefficients_match_jax(name, bank, dtype):
    n = 20
    rng = np.random.default_rng(len(name))
    x = np.sort(rng.uniform(0, 10, n)).astype(dtype)
    shape = (n,) if bank is None else (n,) + ((bank,) if isinstance(bank, int) else bank)
    y = rng.normal(size=shape).astype(dtype)
    j, t = build("jax", name, x, y), build("torch", name, x, y)
    assert isinstance(t.strategy, CubicSplineStrategy) and t.strategy.mode == "no"
    assert t.strategy.a.dtype == torch.as_tensor(y).dtype
    assert_close(t.strategy.a, j.strategy.a, dtype)
    assert_close(t.strategy.b, j.strategy.b, dtype)
    q = np.linspace(x[0], x[-1], 41).astype(dtype)
    assert_close(t(torch.as_tensor(q)), j(jnp.asarray(q)), dtype)


@pytest.mark.parametrize("name", NAMES)
@BOTH_ROUTES
def test_matches_scipy(name):
    x, y, q = case(seed={"Akima": 5, "Makima": 9, "Pchip": 6}[name])
    itp = build("torch", name, x, y)
    np.testing.assert_allclose(np.asarray(itp.interp_array(q)), scipy_of(name, x, y)(q), atol=1e-13)


@pytest.mark.parametrize("name", NAMES)
@BOTH_ROUTES
def test_bank_matches_scipy_per_column(name):
    x, y, q = case(bank=5, seed=10)
    got = np.asarray(build("torch", name, x, y).interp_array(q))
    ref = np.stack([scipy_of(name, x, y[:, j])(q) for j in range(5)], -1)
    np.testing.assert_allclose(got, ref, atol=1e-13)


@pytest.mark.parametrize("name", NAMES)
@BOTH_ROUTES
def test_extrapolate_and_oob(name):
    x, y, _ = case(seed=11)
    with pytest.raises(t_err.OutOfBoundsError):
        build("torch", name, x, y).interp(x[0] - 1.0)
    q = np.array([x[0] - 0.5, x[-1] + 0.5])
    got = np.asarray(build("torch", name, x, y, extrapolate=True).interp_array(q))
    np.testing.assert_allclose(got, scipy_of(name, x, y, extrapolate=True)(q), atol=1e-11)
    # without extrapolation __call__ masks out-of-range queries to NaN
    assert np.isnan(build("torch", name, x, y)(torch.as_tensor(q)).numpy()).all()


@pytest.mark.parametrize("name", NAMES)
def test_min_points_and_dtype_errors_match_jax(name):
    short = np.array([1.0, 2.0] if name != "Pchip" else [1.0])
    errs = []
    for pkg, mod in (("jax", j1), ("torch", t1)):
        with pytest.raises(Exception) as info:
            if pkg == "jax":
                mod.Interp1D.builder(jnp.asarray(short)).strategy(getattr(mod, name)()).build()
            else:
                mod.Interp1D.builder(short, device="cpu").strategy(getattr(mod, name)()).build()
        errs.append(info.value)
    assert type(errs[0]) is j_err.NotEnoughDataError
    assert type(errs[1]) is t_err.NotEnoughDataError
    assert str(errs[0]) == str(errs[1])
    ints = np.arange(6, dtype=np.int64)
    with pytest.raises(TypeError) as j_info:
        j1.Interp1D.builder(jnp.asarray(ints)).strategy(getattr(j1, name)()).build()
    with pytest.raises(TypeError) as t_info:
        t1.Interp1D.builder(ints, device="cpu").strategy(getattr(t1, name)()).build()
    assert str(t_info.value) == str(j_info.value)


@BOTH_ROUTES
def test_makima_differs_from_akima_on_flat_ties():
    """``tests/test_strategies.py:106-131``: on a flat run, classic Akima's
    0/0 tie takes the average slope, makima's weights pull toward the flat
    side; both pinned against SciPy."""
    x = np.arange(10.0)
    y = np.array([0.0, 0, 0, 0, 1, 1, 2, 4, 8, 16])
    q = np.linspace(0, 9, 91)
    mk = np.asarray(build("torch", "Makima", x, y).interp_array(q))
    ak = np.asarray(build("torch", "Akima", x, y).interp_array(q))
    np.testing.assert_allclose(mk, scipy_of("Makima", x, y)(q), atol=1e-13)
    np.testing.assert_allclose(ak, scipy_of("Akima", x, y)(q), atol=1e-13)
    assert np.abs(mk - ak).max() > 1e-3


@BOTH_ROUTES
def test_pchip_preserves_monotonicity():
    rng = np.random.default_rng(9)
    x = np.sort(rng.uniform(0, 10, 25))
    y = np.cumsum(rng.uniform(0, 1, 25))
    q = np.linspace(x[0], x[-1], 500)
    r = np.asarray(build("torch", "Pchip", x, y).interp_array(q))
    assert (np.diff(r) >= -1e-12).all()
    np.testing.assert_allclose(r, si.PchipInterpolator(x, y)(q), atol=1e-13)


def test_pchip_two_points_is_linear():
    itp = build("torch", "Pchip", np.array([0.0, 1.0]), np.array([1.0, 3.0]))
    assert float(itp.interp_scalar(0.5)) == 2.0


@pytest.mark.parametrize("name", NAMES)
def test_builder_api(name):
    cls = getattr(t1, name)
    assert cls().extrapolates is False
    assert cls().extrapolate(True).extrapolates is True
    assert type(cls().extrapolate(True)) is cls
    assert repr(cls(extrapolate=True)) == repr(getattr(j1, name)(extrapolate=True))
    assert cls.MINIMUM_DATA_LENGTH == getattr(j_herm, name).MINIMUM_DATA_LENGTH


@pytest.mark.parametrize("name", NAMES)
def test_state_round_trips_through_interop(name):
    """The builders return ``CubicSplineStrategy`` banks, so
    ``interp1d_from_numpy`` carries a JAX-built Akima/Makima/Pchip across
    with no new function."""
    x, y, q = case(bank=3, seed=2)
    j = build("jax", name, x, y, extrapolate=True)
    s = j.strategy
    t = interp1d_from_numpy(np.asarray(j.x), np.asarray(j.data), a=np.asarray(s.a),
                            b=np.asarray(s.b), mode=s.mode, device="cpu")
    assert isinstance(t.strategy, CubicSplineStrategy) and t.strategy.mode == "yes"
    qe = np.r_[q, x[0] - 0.5, x[-1] + 0.5]
    np.testing.assert_allclose(t(torch.as_tensor(qe)).numpy(), np.asarray(j(jnp.asarray(qe))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t(torch.as_tensor(qe)).numpy(),
                               build("torch", name, x, y, extrapolate=True)(
                                   torch.as_tensor(qe)).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["Akima", "Pchip"])
def test_long_axis_rides_the_r3_route(monkeypatch, name):
    """``tests/test_bigknots.py:145``: at 66,000 f32 knots the Hermite
    strategies take the long-axis route (R3) in both packages; values as
    JAX's gather formulation."""
    rng = np.random.default_rng(9)
    n = 66_000
    x = np.linspace(0.0, 1.0, n).astype(np.float32)
    d = rng.normal(size=n).astype(np.float32)
    q = rng.uniform(-0.05, 1.05, 512).astype(np.float32)
    jitp = build("jax", name, x, d, extrapolate=True)
    titp = build("torch", name, x, d, extrapolate=True)
    calls = []
    fn = t_cubic.big_eval_1d
    monkeypatch.setattr(t_cubic, "big_eval_1d", lambda *a: (calls.append("R3"), fn(*a))[1])
    got = titp(torch.as_tensor(q)).numpy()
    assert calls == ["R3"]
    s = jitp.strategy
    want = np.asarray(j_pe._eval_xla(jnp.asarray(x), j_pe.make_interval_table(
        jnp.asarray(x), jnp.asarray(d), s.a, s.b), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, np.asarray(jitp(jnp.asarray(q))), rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
