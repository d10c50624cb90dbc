"""The port's calculus (``derivative``, ``integrate``, ``solve``, ``roots``
in 1-D; ``derivative``, ``integrate`` in 2-D; ``ops/cubicroots.py``)
against the JAX package on the CPU.

Twins of every test of ``tests/test_calculus.py``: the same seeded numpy
inputs go through the JAX interpolator (float64, x64) and the port's (on the
CPU), each held to the JAX test's SciPy oracle at the JAX test's tolerance,
and the port also to the JAX result at that tolerance.  ``jax.grad`` becomes
``torch.autograd`` and ``torch.func.vmap(torch.func.grad(...))``;
``jax.jit`` a check that a repeated call gives the same values; ``vmap``
``torch.func.vmap`` beside a loop or a reshaped call.
"""

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.interp2d as t2
from ndarray_interp_tpu import config as jconfig
from ndarray_interp_tpu.errors import OutOfBoundsError as JOutOfBounds
from ndarray_interp_tpu.interp1d.cubic_spline import BoundaryCondition as JBC
from ndarray_interp_tpu.ops import cubicroots as jroots
from ndarray_interp_tpu_torch import OutOfBoundsError
from ndarray_interp_tpu_torch import config as tconfig
from ndarray_interp_tpu_torch.interp1d.cubic_spline import BoundaryCondition as TBC
from ndarray_interp_tpu_torch.ops import cubicroots as troots

BCS = ["not-a-knot", "natural", "clamped", "periodic"]
_BC_ATTR = {"not-a-knot": "NotAKnot", "natural": "Natural", "clamped": "Clamped",
            "periodic": "Periodic"}
HERMITE = {
    "akima": ("Akima", lambda x, y: si.Akima1DInterpolator(x, y)),
    "makima": ("Makima", lambda x, y: si.Akima1DInterpolator(x, y, method="makima")),
    "pchip": ("Pchip", lambda x, y: si.PchipInterpolator(x, y)),
}


def case(n=20, bank=None, seed=5):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=(n,) if bank is None else (n, bank))
    return x, y, np.linspace(x[0], x[-1], 7 * n)


def strategy(name, *args, **kw):
    """The strategy ``name`` of both packages: ``(jax, port)``."""
    return getattr(j1, name)(*args, **kw), getattr(t1, name)(*args, **kw)


def cubic(bc="not-a-knot", extrapolate=False):
    return (j1.CubicSpline(extrapolate=extrapolate).boundary(getattr(JBC, _BC_ATTR[bc])),
            t1.CubicSpline(extrapolate=extrapolate).boundary(getattr(TBC, _BC_ATTR[bc])))


def build(x, y, strats):
    """The JAX and the port's (CPU) interpolator of ``y`` on ``x``."""
    sj, st = strats
    j = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)).strategy(sj).build()
    t = t1.Interp1D.builder(y, device="cpu").x(x).strategy(st).build()
    return j, t


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def periodic_y(y, bc):
    if bc == "periodic":
        y = y.copy()
        y[-1] = y[0]
    return y


def finite(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a[np.isfinite(a)]


# -- TestDerivative ------------------------------------------------------------------
@pytest.mark.parametrize("bc", BCS)
def test_derivative_cubic_matches_scipy(bc):
    x, y, q = case()
    y = periodic_y(y, bc)
    j, t = build(x, y, cubic(bc))
    ref = si.CubicSpline(x, y, bc_type=bc).derivative()(q)
    got = t.derivative(q)
    close(got, ref, rtol=1e-9, atol=1e-10)
    close(got, j.derivative(q), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("name", list(HERMITE))
def test_derivative_hermite_family_matches_scipy(name):
    cls, oracle = HERMITE[name]
    x, y, q = case(seed=7)
    j, t = build(x, y, strategy(cls))
    got = t.derivative(q)
    close(got, oracle(x, y).derivative()(q), rtol=1e-9, atol=1e-11)
    close(got, j.derivative(q), rtol=1e-9, atol=1e-11)


def test_derivative_linear_slopes():
    x, y, _ = case(seed=8)
    j, t = build(x, y, strategy("Linear"))
    mids = 0.5 * (x[:-1] + x[1:])
    close(t.derivative(mids), np.diff(y) / np.diff(x), rtol=1e-12)
    close(t.derivative(mids), j.derivative(mids), rtol=1e-12)


def test_derivative_bank_shape_and_values():
    x, y, q = case(bank=4, seed=9)
    j, t = build(x, y, cubic())
    got = t.derivative(q)
    assert tuple(got.shape) == (q.shape[0], 4)
    close(got, si.CubicSpline(x, y).derivative()(q), rtol=1e-9, atol=1e-10)
    close(got, j.derivative(q), rtol=1e-9, atol=1e-10)


def test_derivative_matches_autograd():
    """test_matches_autodiff: ``torch.autograd`` of the pure eval equals the
    analytic derivative (and ``jax.grad`` of JAX's)."""
    x, y, q = case(seed=10)
    j, t = build(x, y, cubic(extrapolate=True))
    qt = torch.as_tensor(q).requires_grad_()
    (ad,) = torch.autograd.grad(t(qt).sum(), qt)
    close(t.derivative(q), ad, rtol=1e-8, atol=1e-10)
    close(ad, jax.vmap(jax.grad(lambda p: j(p)))(jnp.asarray(q)), rtol=1e-8, atol=1e-10)


def test_derivative_matches_torch_func_vmap_grad():
    """test_matches_autodiff with ``torch.func.vmap(torch.func.grad(itp))``,
    JAX's transform pair: the analytic derivative and JAX's within its
    tolerance, autograd's gradient bit for bit."""
    x, y, q = case(seed=10)
    j, t = build(x, y, cubic(extrapolate=True))
    qt = torch.as_tensor(q)
    ad = torch.func.vmap(torch.func.grad(lambda p: t(p)))(qt)
    close(t.derivative(q), ad, rtol=1e-8, atol=1e-10)
    close(ad, jax.vmap(jax.grad(lambda p: j(p)))(jnp.asarray(q)), rtol=1e-8, atol=1e-10)
    qg = qt.clone().requires_grad_()
    (want,) = torch.autograd.grad(t(qg).sum(), qg)
    assert torch.equal(ad, want)


def test_derivative_repeat_and_query_dims():
    """test_jit_and_query_dims: a second call and a reshaped call give the
    same values; query dims lead."""
    x, y, q = case(seed=11)
    j, t = build(x, y, cubic())
    first = t.derivative(q)
    close(t.derivative(torch.as_tensor(q)), first, rtol=1e-12)
    close(first, jax.jit(lambda a, p: a.derivative(p))(j, jnp.asarray(q)), rtol=1e-12)
    q2 = q[:20].reshape(4, 5)
    assert tuple(t.derivative(q2).shape) == (4, 5) == j.derivative(q2).shape
    close(t.derivative(q2).reshape(-1), first[:20], rtol=0)


def test_derivative_oob_raises_unless_extrapolating():
    x, y, _ = case(seed=12)
    j, t = build(x, y, cubic())
    with pytest.raises(JOutOfBounds) as jerr:
        j.derivative(x[0] - 1.0)
    with pytest.raises(OutOfBoundsError) as terr:
        t.derivative(x[0] - 1.0)
    assert str(terr.value) == str(jerr.value)
    j, t = build(x, y, cubic(extrapolate=True))
    got = t.derivative(x[0] - 1.0)
    close(got, si.CubicSpline(x, y).derivative()(x[0] - 1.0), rtol=1e-9)
    close(got, j.derivative(x[0] - 1.0), rtol=1e-9)


def test_derivative_unsupported_strategy():
    x, y, _ = case(seed=13)
    j, t = build(x, y, strategy("Nearest"))
    with pytest.raises(TypeError, match="does not support") as terr:
        t.derivative(x[1])
    with pytest.raises(TypeError) as jerr:
        j.derivative(x[1])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("order", [2, 3])
def test_derivative_higher_orders_match_scipy(order):
    x, y, q = case(seed=23)
    j, t = build(x, y, cubic())
    # order 3 is piecewise constant with jumps at the knots: query inside
    qin = 0.5 * (x[:-1] + x[1:])
    got = t.derivative(qin, order=order)
    close(got, si.CubicSpline(x, y).derivative(order)(qin), rtol=1e-8, atol=1e-9)
    close(got, j.derivative(qin, order=order), rtol=1e-8, atol=1e-9)
    if order == 2:  # continuous: the full query grid also matches
        close(t.derivative(q, order=order), si.CubicSpline(x, y).derivative(order)(q),
              rtol=1e-8, atol=1e-9)


def test_derivative_order_validation_and_linear_zeros():
    x, y, _ = case(seed=24)
    j, t = build(x, y, cubic())
    with pytest.raises(ValueError, match="order") as terr:
        t.derivative(x[1], order=4)
    with pytest.raises(ValueError) as jerr:
        j.derivative(x[1], order=4)
    assert str(terr.value) == str(jerr.value)
    _, lin = build(x, y, strategy("Linear"))
    mids = 0.5 * (x[:-1] + x[1:])
    np.testing.assert_array_equal(lin.derivative(mids, order=2).numpy(), 0.0)


# -- TestIntegrate -----------------------------------------------------------------------
@pytest.mark.parametrize("bc", BCS)
def test_integrate_cubic_matches_scipy(bc):
    x, y, _ = case(seed=14)
    y = periodic_y(y, bc)
    j, t = build(x, y, cubic(bc))
    sp = si.CubicSpline(x, y, bc_type=bc)
    for lo, hi in [(x[0], x[-1]), (x[2] + 0.3, x[-3] - 0.2)]:
        got = t.integrate(lo, hi)
        close(got, sp.integrate(lo, hi), rtol=1e-9, atol=1e-11)
        close(got, j.integrate(lo, hi), rtol=1e-9, atol=1e-11)


def test_integrate_signed_and_zero_width():
    x, y, _ = case(seed=15)
    j, t = build(x, y, cubic())
    a, b = x[1] + 0.1, x[-2] - 0.1
    fwd = t.integrate(a, b)
    close(t.integrate(b, a), -fwd, rtol=1e-12)
    close(t.integrate(a, a), 0.0, atol=1e-14)
    close(fwd, j.integrate(a, b), rtol=1e-12)


def test_integrate_periodic_extension():
    """Bounds beyond the range integrate the periodic extension (SciPy
    ``integrate(..., extrapolate="periodic")``)."""
    x, y, _ = case(seed=16)
    y = periodic_y(y, "periodic")
    j, t = build(x, y, cubic("periodic", extrapolate=True))
    period = x[-1] - x[0]
    lo, hi = x[0] - 1.3 * period, x[-1] + 2.6 * period
    got = t.integrate(lo, hi)
    close(got, si.CubicSpline(x, y, bc_type="periodic").integrate(lo, hi, extrapolate="periodic"),
          rtol=1e-9, atol=1e-10)
    close(got, j.integrate(lo, hi), rtol=1e-9, atol=1e-10)


def test_integrate_extrapolated_bounds_match_scipy():
    x, y, _ = case(seed=17)
    j, t = build(x, y, cubic(extrapolate=True))
    got = t.integrate(x[0] - 0.7, x[-1] + 0.4)
    close(got, si.CubicSpline(x, y).integrate(x[0] - 0.7, x[-1] + 0.4), rtol=1e-9)
    close(got, j.integrate(x[0] - 0.7, x[-1] + 0.4), rtol=1e-9)


@pytest.mark.parametrize("name", list(HERMITE))
def test_integrate_hermite_family_matches_scipy(name):
    cls, oracle = HERMITE[name]
    x, y, _ = case(seed=18)
    j, t = build(x, y, strategy(cls))
    lo, hi = x[1] + 0.2, x[-2] + 0.1
    got = t.integrate(lo, hi)
    close(got, oracle(x, y).integrate(lo, hi), rtol=1e-9)
    close(got, j.integrate(lo, hi), rtol=1e-9)


def test_integrate_linear_exact_trapezoid():
    x, y, _ = case(seed=19)
    j, t = build(x, y, strategy("Linear"))
    lo, hi = x[3] + 0.25, x[-4] - 0.5
    pts = np.unique(np.concatenate([[lo], x[(x > lo) & (x < hi)], [hi]]))
    got = t.integrate(lo, hi)
    close(got, np.trapezoid(np.interp(pts, x, y), pts), rtol=1e-12)
    close(got, j.integrate(lo, hi), rtol=1e-12)


def test_integrate_bank_shape():
    x, y, _ = case(bank=3, seed=20)
    j, t = build(x, y, cubic())
    got = t.integrate(x[0], x[-1])
    assert tuple(got.shape) == (3,)
    close(got, si.CubicSpline(x, y).integrate(x[0], x[-1]), rtol=1e-9)
    close(got, j.integrate(x[0], x[-1]), rtol=1e-9)


def test_integrate_tensor_bounds():
    """test_jit_traced_bounds: tensor bounds give the float bounds' value."""
    x, y, _ = case(seed=21)
    j, t = build(x, y, cubic())
    got = t.integrate(torch.tensor(x[0] + 0.5), torch.tensor(x[-1] - 0.5))
    close(got, t.integrate(x[0] + 0.5, x[-1] - 0.5), rtol=1e-12)
    close(got, jax.jit(lambda a, b: j.integrate(a, b))(x[0] + 0.5, x[-1] - 0.5), rtol=1e-12)


def test_integrate_oob_raises_unless_extrapolating():
    x, y, _ = case(seed=22)
    j, t = build(x, y, cubic())
    with pytest.raises(JOutOfBounds) as jerr:
        j.integrate(x[0] - 1.0, x[-1])
    with pytest.raises(OutOfBoundsError) as terr:
        t.integrate(x[0] - 1.0, x[-1])
    assert str(terr.value) == str(jerr.value)
    _, near = build(x, y, strategy("Nearest"))
    with pytest.raises(TypeError, match="does not support"):
        near.integrate(x[0], x[-1])


# -- TestCubicRootsOp --------------------------------------------------------------------
def test_cubic_roots_random_cubics_match_numpy():
    rng = np.random.default_rng(31)
    c = rng.normal(size=(200, 4))
    got = troots.real_cubic_roots(*(torch.as_tensor(c[:, i]) for i in range(4))).numpy()
    want_j = np.asarray(jroots.real_cubic_roots(*(jnp.asarray(c[:, i]) for i in range(4))))
    for i in range(200):
        want = np.roots(c[i, ::-1])
        want = np.sort(want[np.abs(want.imag) < 1e-9].real)
        mine = np.sort(finite(got[i]))
        assert mine.shape == want.shape == np.sort(finite(want_j[i])).shape, (i, mine, want)
        if want.size:
            np.testing.assert_allclose(mine, want, rtol=1e-7, atol=1e-9)
            np.testing.assert_allclose(mine, np.sort(finite(want_j[i])), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize(
    "coef,want",
    [
        ((6.0, -5.0, 1.0, 0.0), [2.0, 3.0]),  # quadratic
        ((-4.0, 0.0, 1.0, 0.0), [-2.0, 2.0]),  # quadratic, c1 == 0
        ((1.0, 1.0, 1.0, 0.0), []),  # complex pair
        ((3.0, -1.5, 0.0, 0.0), [2.0]),  # linear
        ((2.0, 0.0, 0.0, 0.0), []),  # constant nonzero
        ((0.0, 0.0, 0.0, 0.0), []),  # identically zero: the caller's call
        ((0.0, 0.0, 0.0, 1.0), [0.0, 0.0, 0.0]),  # triple root
        ((-1.0, 0.0, 0.0, 1.0), [1.0]),  # p == 0 Cardano branch
    ],
)
def test_cubic_roots_degenerate_forms(coef, want):
    got = finite(troots.real_cubic_roots(*(torch.tensor(v, dtype=torch.float64) for v in coef)))
    np.testing.assert_allclose(np.sort(got), np.asarray(want), rtol=1e-12, atol=1e-12)
    jgot = finite(jroots.real_cubic_roots(*map(jnp.float64, coef)))
    np.testing.assert_allclose(np.sort(got), np.sort(jgot), rtol=1e-12, atol=1e-12)


# -- TestSolve ------------------------------------------------------------------------------
def roots_close(got, want, **tol):
    got = finite(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got, want)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("level", [0.0, 0.3, -0.5])
def test_solve_cubic_matches_scipy(bc, level):
    x, y, _ = case(seed=32)
    y = periodic_y(y, bc)
    j, t = build(x, y, cubic(bc))
    got = t.solve(level)
    # near-tangent roots amplify coefficient rounding
    roots_close(got, np.sort(si.CubicSpline(x, y, bc_type=bc).solve(level, extrapolate=False)),
                rtol=1e-7, atol=1e-8)
    roots_close(got, finite(j.solve(level)), rtol=1e-7, atol=1e-8)


def test_solve_extrapolating_edge_roots():
    x, y, _ = case(seed=33)
    j, t = build(x, y, cubic(extrapolate=True))
    got = t.solve(0.25)
    roots_close(got, np.sort(si.CubicSpline(x, y).solve(0.25, extrapolate=True)),
                rtol=1e-7, atol=1e-8)
    roots_close(got, finite(j.solve(0.25)), rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("name", list(HERMITE))
def test_solve_hermite_family_roots(name):
    cls, oracle = HERMITE[name]
    x, y, _ = case(seed=34)
    j, t = build(x, y, strategy(cls))
    got = t.roots()
    roots_close(got, np.sort(oracle(x, y).solve(0.0, extrapolate=False)), rtol=1e-7, atol=1e-8)
    roots_close(got, finite(j.roots()), rtol=1e-7, atol=1e-8)


def linear_ppoly(x, y):
    return si.PPoly(np.stack([np.diff(y) / np.diff(x), y[:-1]]), x)


def test_solve_linear_crossings():
    x, y, _ = case(seed=35)
    j, t = build(x, y, strategy("Linear"))
    got = t.roots()
    roots_close(got, np.sort(linear_ppoly(x, y).solve(0.0, extrapolate=False)),
                rtol=1e-9, atol=1e-10)
    roots_close(got, finite(j.roots()), rtol=1e-9, atol=1e-10)


def test_solve_banked_per_column():
    x, y, _ = case(bank=4, seed=36)
    j, t = build(x, y, cubic())
    got = t.roots()
    assert tuple(got.shape) == (3 * (x.size - 1), 4) == j.roots().shape
    for c in range(4):
        want = np.sort(si.CubicSpline(x, y[:, c]).solve(0.0, extrapolate=False))
        roots_close(got[:, c], want, rtol=1e-7, atol=1e-8)
        roots_close(got[:, c], finite(np.asarray(j.roots())[:, c]), rtol=1e-7, atol=1e-8)


def test_solve_per_column_levels_broadcast():
    x, y, _ = case(bank=3, seed=37)
    j, t = build(x, y, cubic())
    lv = np.asarray([0.1, -0.2, 0.4])
    got = t.solve(torch.as_tensor(lv))
    jgot = np.asarray(j.solve(jnp.asarray(lv)))
    for c in range(3):
        want = np.sort(si.CubicSpline(x, y[:, c]).solve(lv[c], extrapolate=False))
        close(finite(got[:, c]), want, rtol=1e-7, atol=1e-8)
        close(finite(got[:, c]), finite(jgot[:, c]), rtol=1e-7, atol=1e-8)


def test_solve_sorted_nan_padded_and_trim():
    x, y, _ = case(seed=38)
    j, t = build(x, y, cubic())
    r = t.roots().numpy()
    k = np.isfinite(r).sum()
    assert np.all(np.isnan(r[k:])) and np.all(np.diff(r[:k]) > 0)
    trimmed = t.roots(max_roots=2)
    assert tuple(trimmed.shape) == (2,)
    np.testing.assert_array_equal(trimmed.numpy(), r[:2])
    close(r, j.roots(), rtol=1e-7, atol=1e-8, equal_nan=True)


def test_solve_no_roots_all_nan():
    x, y, _ = case(seed=39)
    j, t = build(x, y + 100.0, cubic())
    assert np.all(np.isnan(t.roots().numpy())) and np.all(np.isnan(np.asarray(j.roots())))


def test_solve_constant_segment_representative_root():
    x = np.arange(6.0)
    y = np.asarray([1.0, -1.0, 0.0, 0.0, 0.0, 2.0])
    j, t = build(x, y, strategy("Linear"))
    # a crossing at 0.5; the flat run [2, 4] reports its left knots; 4.0 is
    # the zero at the start of the rising [4, 5] segment
    close(finite(t.roots()), [0.5, 2.0, 3.0, 4.0], atol=1e-12)
    close(finite(t.roots()), finite(j.roots()), atol=1e-12)


def test_solve_root_at_knot_reported_once():
    x = np.arange(7.0)
    y = np.asarray([2.0, 1.0, 0.0, -1.0, -2.0, -1.5, 3.0])
    j, t = build(x, y, strategy("Linear"))
    want = np.sort(linear_ppoly(x, y).solve(0.0, extrapolate=False))
    close(finite(t.roots()), want, atol=1e-12)
    close(finite(t.roots()), finite(j.roots()), atol=1e-12)


def test_solve_repeat_and_levels():
    """test_jit_and_vmap: a repeated call is equal; a level at a time equals
    the JAX ``vmap`` over levels."""
    x, y, _ = case(seed=40)
    j, t = build(x, y, cubic())
    close(t.roots(), t.roots(), rtol=1e-12, equal_nan=True)
    lv = jnp.asarray([0.0, 0.1, 0.2])
    vm = np.asarray(jax.vmap(lambda level: j.solve(level))(lv))
    for i, level in enumerate(np.asarray(lv)):
        close(t.solve(float(level)), vm[i], rtol=1e-7, atol=1e-8, equal_nan=True)


def test_solve_levels_under_torch_func_vmap():
    """test_jit_and_vmap's ``vmap`` over levels with ``torch.func.vmap``:
    each row equals the solve at that level and JAX's ``vmap``."""
    x, y, _ = case(seed=40)
    j, t = build(x, y, cubic())
    lv = np.array([0.0, 0.1, 0.2])
    vm = torch.func.vmap(lambda level: t.solve(level))(torch.as_tensor(lv))
    jvm = np.asarray(jax.vmap(lambda level: j.solve(level))(jnp.asarray(lv)))
    for i, level in enumerate(lv):
        close(vm[i], t.solve(float(level)), rtol=0, atol=0, equal_nan=True)
        close(vm[i], jvm[i], rtol=1e-7, atol=1e-8, equal_nan=True)


def test_solve_solutions_evaluate_to_level():
    """Every reported root satisfies spline(r) = y."""
    x, y, _ = case(n=40, seed=41)
    _, t = build(x, y, cubic())
    r = finite(t.solve(0.2))
    close(t.interp_array(r), 0.2, atol=1e-9)


def test_solve_unsupported_strategy():
    x, y, _ = case(seed=42)
    _, t = build(x, y, strategy("Nearest"))
    with pytest.raises(TypeError, match="does not support"):
        t.solve(0.0)


# -- TestDerivative2D ------------------------------------------------------------------------
def grid(nx=12, ny=10, bank=None, seed=50):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 5, nx))
    y = np.sort(rng.uniform(0, 4, ny))
    z = rng.normal(size=(nx, ny) if bank is None else (nx, ny, bank))
    return x, y, z, rng.uniform(x[0], x[-1], 60), rng.uniform(y[0], y[-1], 60)


def build2(x, y, z, name, **kw):
    """The JAX and the port's (CPU) 2-D interpolator with strategy ``name``."""
    j = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).strategy(
        getattr(j2, name)(**kw)).build()
    t = t2.Interp2D.builder(z, device="cpu").x(x).y(y).strategy(getattr(t2, name)(**kw)).build()
    return j, t


def seq_oracle(x, y, z, qx, qy, ox, oy, bc="not-a-knot"):
    """Sequential 1-D CubicSplines: y first at each x-knot, then x."""
    out = np.empty(qx.shape[0])
    for q in range(qx.shape[0]):
        col = np.array([
            (si.CubicSpline(y, z[i], bc_type=bc).derivative(oy) if oy
             else si.CubicSpline(y, z[i], bc_type=bc))(qy[q])
            for i in range(x.shape[0])
        ])
        cs = si.CubicSpline(x, col, bc_type=bc)
        out[q] = cs.derivative(ox)(qx[q]) if ox else cs(qx[q])
    return out


@pytest.mark.parametrize("ox,oy", [(1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2), (3, 1)])
def test_derivative2d_bicubic_matches_sequential_scipy(ox, oy):
    x, y, z, qx, qy = grid()
    j, t = build2(x, y, z, "Bicubic")
    got = t.derivative(qx, qy, dx=ox, dy=oy)
    close(got, seq_oracle(x, y, z, qx, qy, ox, oy), rtol=1e-9, atol=1e-10)
    close(got, j.derivative(qx, qy, dx=ox, dy=oy), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("bc", ["natural", "clamped", "periodic"])
def test_derivative2d_boundary_families(bc):
    x, y, z, qx, qy = grid(seed=51)
    if bc == "periodic":
        z = z.copy()
        z[-1, :] = z[0, :]
        z[:, -1] = z[:, 0]
    j, t = build2(x, y, z, "Bicubic", bc_x=bc, bc_y=bc)
    got = t.derivative(qx, qy, dx=1, dy=1)
    close(got, seq_oracle(x, y, z, qx, qy, 1, 1, bc=bc), rtol=1e-9, atol=1e-10)
    close(got, j.derivative(qx, qy, dx=1, dy=1), rtol=1e-9, atol=1e-10)


def test_derivative2d_node_layout_matches_cell(monkeypatch):
    x, y, z, qx, qy = grid(seed=52)
    _, cell = build2(x, y, z, "Bicubic")
    assert cell.strategy.layout == "cell"
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    monkeypatch.setattr(jconfig, "bicubic_pack_max_elems", 10)
    jnode, node = build2(x, y, z, "Bicubic")
    assert node.strategy.layout == jnode.strategy.layout == "node"
    for ox, oy in [(1, 0), (0, 1), (1, 1), (2, 1)]:
        got = node.derivative(qx, qy, dx=ox, dy=oy)
        close(got, cell.derivative(qx, qy, dx=ox, dy=oy), rtol=1e-11, atol=1e-12)
        close(got, jnode.derivative(qx, qy, dx=ox, dy=oy), rtol=1e-11, atol=1e-12)


def test_derivative2d_banked_trailing_dims():
    x, y, z, qx, qy = grid(bank=3, seed=53)
    j, t = build2(x, y, z, "Bicubic")
    got = t.derivative(qx, qy, dx=1, dy=0)
    assert tuple(got.shape) == (60, 3)
    for c in range(3):
        close(got[:, c], seq_oracle(x, y, z[..., c], qx, qy, 1, 0), rtol=1e-9, atol=1e-10)
    close(got, j.derivative(qx, qy, dx=1, dy=0), rtol=1e-9, atol=1e-10)


def autograd_partials(t, qx, qy):
    ax, ay = (torch.as_tensor(v).requires_grad_() for v in (qx, qy))
    return torch.autograd.grad(t(ax, ay).sum(), (ax, ay))


def test_derivative2d_matches_autograd():
    """test_matches_autodiff: ``torch.autograd`` of the pure eval (R1 + R2n
    on the CPU) equals the analytic partials."""
    x, y, z, qx, qy = grid(seed=54)
    j, t = build2(x, y, z, "Bicubic", extrapolate=True)
    gx, gy = autograd_partials(t, qx, qy)
    close(t.derivative(qx, qy, dx=1), gx, rtol=1e-8, atol=1e-10)
    close(t.derivative(qx, qy, dy=1), gy, rtol=1e-8, atol=1e-10)
    jgx = jax.vmap(jax.grad(lambda a, b: j(a, b), argnums=0))(jnp.asarray(qx), jnp.asarray(qy))
    close(gx, jgx, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("strategy", ["Bicubic", "Bilinear"])
def test_derivative2d_matches_torch_func_vmap_grad(strategy):
    """test_matches_autodiff / test_bilinear_partials with JAX's transform
    pair, ``torch.func.vmap(torch.func.grad(itp, argnums))``: the analytic
    partials, JAX's, and autograd's bit for bit."""
    x, y, z, qx, qy = grid(seed=54 if strategy == "Bicubic" else 55)
    j, t = build2(x, y, z, strategy, extrapolate=strategy == "Bicubic")
    tol = dict(rtol=1e-8, atol=1e-10) if strategy == "Bicubic" else dict(rtol=1e-12)
    want = autograd_partials(t, qx, qy)
    qs = (torch.as_tensor(qx), torch.as_tensor(qy))
    for argnums, order in ((0, dict(dx=1)), (1, dict(dy=1))):
        g = torch.func.vmap(torch.func.grad(lambda a, b: t(a, b), argnums=argnums))(*qs)
        assert torch.equal(g, want[argnums])
        close(t.derivative(qx, qy, **order), g, **tol)
        jg = jax.vmap(jax.grad(lambda a, b: j(a, b), argnums=argnums))(jnp.asarray(qx),
                                                                        jnp.asarray(qy))
        close(g, jg, **tol)


def test_derivative2d_bilinear_partials():
    x, y, z, qx, qy = grid(seed=55)
    j, t = build2(x, y, z, "Bilinear")
    gx, gy = autograd_partials(t, qx, qy)
    close(t.derivative(qx, qy, dx=1), gx, rtol=1e-12)
    close(t.derivative(qx, qy, dy=1), gy, rtol=1e-12)
    # the twist term: a finite difference of d/dx across y
    eps = 1e-7
    fd = (t.derivative(qx, qy + eps, dx=1) - t.derivative(qx, qy, dx=1)) / eps
    twist = t.derivative(qx, qy, dx=1, dy=1)
    close(twist, fd, rtol=1e-5, atol=1e-6)
    close(twist, j.derivative(qx, qy, dx=1, dy=1), rtol=1e-12)
    assert bool((t.derivative(qx, qy, dx=2) == 0.0).all())


def test_derivative2d_query_dims_and_value_parity():
    """test_jit_query_dims_and_value_parity (without jit)."""
    x, y, z, qx, qy = grid(seed=56)
    j, t = build2(x, y, z, "Bicubic")
    got = t.derivative(qx, qy, dx=1, dy=1)
    close(got, jax.jit(lambda a, b: j.derivative(a, b, dx=1, dy=1))(qx, qy), rtol=1e-12)
    assert tuple(t.derivative(qx[:12].reshape(3, 4), qy[:12].reshape(3, 4), dx=1).shape) == (3, 4)
    # order (0, 0) is the surface itself
    close(t.derivative(qx, qy), t.interp_array(qx, qy), rtol=1e-12)


def test_derivative2d_validation():
    x, y, z, qx, qy = grid(seed=57)
    j, t = build2(x, y, z, "Bicubic")
    for call, err in ((lambda itp: itp.derivative(qx, qy[:5], dx=1), ValueError),
                      (lambda itp: itp.derivative(qx, qy, dx=4), ValueError)):
        with pytest.raises(err) as terr:
            call(t)
        with pytest.raises(err) as jerr:
            call(j)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(OutOfBoundsError):
        t.derivative(qx - 100.0, qy, dx=1)
    _, nn = build2(x, y, z, "Nearest2D")
    with pytest.raises(TypeError, match="does not support"):
        nn.derivative(qx, qy, dx=1)


def test_derivative2d_periodic_wrap_queries():
    x, y, z, qx, qy = grid(seed=58)
    z = z.copy()
    z[-1, :] = z[0, :]
    z[:, -1] = z[:, 0]
    j, t = build2(x, y, z, "Bicubic", bc_x="periodic", bc_y="periodic")
    px, py = x[-1] - x[0], y[-1] - y[0]
    base = t.derivative(qx, qy, dx=1, dy=1)
    wrapped = t.derivative(qx + 2 * px, qy - 3 * py, dx=1, dy=1)
    close(wrapped, base, rtol=1e-8, atol=1e-10)
    close(wrapped, j.derivative(qx + 2 * px, qy - 3 * py, dx=1, dy=1), rtol=1e-8, atol=1e-10)


# -- TestIntegrate2D ---------------------------------------------------------------------------
def seq_integral(x, y, z, xlo, xhi, ylo, yhi, bc="not-a-knot"):
    col = np.array([si.CubicSpline(y, z[i], bc_type=bc).integrate(ylo, yhi)
                    for i in range(x.shape[0])])
    return si.CubicSpline(x, col, bc_type=bc).integrate(xlo, xhi)


def test_integrate2d_bicubic_matches_sequential_scipy():
    x, y, z, _, _ = grid(seed=60)
    j, t = build2(x, y, z, "Bicubic")
    box = (x[2] + 0.17, x[-2] - 0.31, y[1] + 0.05, y[-3] + 0.4)
    got = float(t.integrate(*box))
    np.testing.assert_allclose(got, seq_integral(x, y, z, *box), rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(got, float(j.integrate(*box)), rtol=1e-10, atol=1e-11)


def test_integrate2d_bilinear_matches_trapezoid():
    x, y, z, _, _ = grid(seed=61)
    j, t = build2(x, y, z, "Bilinear")
    got = float(t.integrate(x[1], x[-2], y[2], y[-1]))
    want = np.trapezoid(np.trapezoid(z[1:-1, 2:], y[2:], axis=1), x[1:-1])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, float(j.integrate(x[1], x[-2], y[2], y[-1])), rtol=1e-12)


def test_integrate2d_bilinear_exact_on_plane():
    x = np.array([0.0, 1.0, 3.0])
    y = np.array([0.0, 2.0, 5.0])
    z = 2.0 * x[:, None] + 3.0 * y[None, :] + 1.0
    _, t = build2(x, y, z, "Bilinear")
    xlo, xhi, ylo, yhi = 0.5, 2.5, 1.0, 4.0
    want = (2.0 * (xhi**2 - xlo**2) / 2 * (yhi - ylo) + 3.0 * (yhi**2 - ylo**2) / 2 * (xhi - xlo)
            + 1.0 * (xhi - xlo) * (yhi - ylo))
    np.testing.assert_allclose(float(t.integrate(xlo, xhi, ylo, yhi)), want, rtol=1e-12)


def test_integrate2d_signed_bounds():
    x, y, z, _, _ = grid(seed=62)
    j, t = build2(x, y, z, "Bicubic")
    a = float(t.integrate(x[1], x[-2], y[1], y[-2]))
    np.testing.assert_allclose(float(t.integrate(x[-2], x[1], y[1], y[-2])), -a, rtol=1e-12)
    np.testing.assert_allclose(float(t.integrate(x[-2], x[1], y[-2], y[1])), a, rtol=1e-12)
    assert float(t.integrate(x[1], x[1], y[1], y[-2])) == 0.0
    np.testing.assert_allclose(a, float(j.integrate(x[1], x[-2], y[1], y[-2])), rtol=1e-12)


def test_integrate2d_trailing_dims():
    x, y, z, _, _ = grid(bank=3, seed=63)
    j, t = build2(x, y, z, "Bicubic")
    box = (x[1] + 0.1, x[-2], y[0] + 0.2, y[-1] - 0.3)
    got = t.integrate(*box)
    assert tuple(got.shape) == (3,)
    for c in range(3):
        np.testing.assert_allclose(float(got[c]), seq_integral(x, y, z[..., c], *box),
                                   rtol=1e-10, atol=1e-11)
    close(got, j.integrate(*box), rtol=1e-10, atol=1e-11)


def test_integrate2d_extrapolated_and_oob():
    x, y, z, _, _ = grid(seed=64)
    j, t = build2(x, y, z, "Bicubic")
    with pytest.raises(JOutOfBounds) as jerr:
        j.integrate(x[0] - 1.0, x[-1], y[0], y[-1])
    with pytest.raises(OutOfBoundsError) as terr:
        t.integrate(x[0] - 1.0, x[-1], y[0], y[-1])
    assert str(terr.value) == str(jerr.value)
    j, t = build2(x, y, z, "Bicubic", extrapolate=True)
    box = (x[0] - 0.5, x[-1] + 0.25, y[0] - 0.1, y[-1])
    got = float(t.integrate(*box))
    # SciPy's CubicSpline extrapolates its edge polynomials too
    np.testing.assert_allclose(got, seq_integral(x, y, z, *box), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got, float(j.integrate(*box)), rtol=1e-9, atol=1e-10)


def test_integrate2d_periodic_rejected():
    x, y, z, _, _ = grid(seed=65)
    z = z.copy()
    z[-1, :] = z[0, :]
    j, t = build2(x, y, z, "Bicubic", bc_x="periodic")
    with pytest.raises(ValueError, match="periodic") as terr:
        t.integrate(x[1], x[-2], y[1], y[-2])
    with pytest.raises(ValueError) as jerr:
        j.integrate(x[1], x[-2], y[1], y[-2])
    assert str(terr.value) == str(jerr.value)


def test_integrate2d_tensor_bounds():
    """test_jit_traced_bounds: tensor bounds give the float bounds' value."""
    x, y, z, _, _ = grid(seed=66)
    j, t = build2(x, y, z, "Bicubic")
    box = (x[1] + 0.3, x[-2] - 0.2, y[1] + 0.1, y[-2])
    got = float(t.integrate(*map(torch.tensor, box)))
    np.testing.assert_allclose(got, float(t.integrate(*box)), rtol=1e-12)
    np.testing.assert_allclose(got, float(jax.jit(j.integrate)(*map(jnp.asarray, box))),
                               rtol=1e-12)


def test_integrate2d_integer_grid_promotes():
    z = np.arange(12).reshape(3, 4)
    j = j2.Interp2D.builder(z).build()
    t = t2.Interp2D.builder(z, device="cpu").build()
    got = float(t.integrate(0.5, 1.5, 0.5, 2.5))
    xs, ys = np.linspace(0.5, 1.5, 201), np.linspace(0.5, 2.5, 201)
    rgi = si.RegularGridInterpolator((np.arange(3.0), np.arange(4.0)), z.astype(np.float64))
    xg, yg = np.meshgrid(xs, ys, indexing="ij")
    samples = rgi(np.stack([xg.ravel(), yg.ravel()], -1)).reshape(xg.shape)
    want = np.trapezoid(np.trapezoid(samples, ys, axis=1), xs)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, float(j.integrate(0.5, 1.5, 0.5, 2.5)), rtol=1e-6)


def test_integrate2d_unsupported_strategy():
    x, y, z, _, _ = grid(seed=67)
    _, t = build2(x, y, z, "Nearest2D")
    with pytest.raises(TypeError, match="does not support"):
        t.integrate(x[1], x[2], y[1], y[2])
