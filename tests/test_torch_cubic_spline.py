"""The port's ``CubicSpline`` against the reference's value tables, SciPy and
the JAX package, on the CPU.

Twins of every test of ``tests/test_cubic_spline.py`` (the reference's
``tests/cubic_spline_strat.rs`` tables and SciPy), case by case, on the same
inputs: the port (numpy inputs on ``device="cpu"``, tensor queries, so the
tensor path with the kernels' plain versions) is held to the JAX test's
table or oracle at the JAX test's tolerance, and to the JAX interpolator
(XLA, jnp inputs and queries) at the same tolerance.  ``jax.jit`` of a build
becomes the build of the strategy and ``new_unchecked`` called twice (equal
values), ``jax.grad`` becomes ``torch.autograd``.
"""

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
from ndarray_interp_tpu.interp1d import cubic_spline as jcs
from ndarray_interp_tpu_torch.errors import (
    BuilderValueError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)
from ndarray_interp_tpu_torch.interp1d import Interp1D
from ndarray_interp_tpu_torch.interp1d.cubic_spline import (
    BoundaryCondition,
    CubicSpline,
    RowBoundary,
    SingleBoundary,
)

DATA12 = np.array([1.0, 2.0, 2.5, 2.5, 3.0, 2.0, 1.0, -2.0, 3.0, 5.0, 6.3, 8.0])
Q30 = np.linspace(-3.0, 15.0, 30)


def build(data, strat, x=None):
    """The port's interpolator (numpy inputs on the CPU)."""
    b = Interp1D.builder(np.asarray(data), device="cpu")
    if x is not None:
        b = b.x(np.asarray(x))
    return b.strategy(strat).build()


def jbuild(data, strat, x=None):
    """The JAX package's interpolator, from jnp inputs."""
    b = j1.Interp1D.builder(jnp.asarray(data))
    if x is not None:
        b = b.x(jnp.asarray(x))
    return b.strategy(strat).build()


def ev(itp, q):
    """``interp_array`` of the port on a tensor query, as numpy."""
    return itp.interp_array(torch.as_tensor(np.asarray(q))).numpy()


def jev(itp, q):
    return np.asarray(itp.interp_array(jnp.asarray(q)))


def _jbc(bc):
    return getattr(jcs.BoundaryCondition, bc)


def test_wikipedia_doctest():
    # cubic_spline.rs:55-83
    y = np.array([0.5, 0.0, 3.0])
    x = np.array([-1.0, 0.0, 3.0])
    q = np.linspace(-1.0, 3.0, 10)
    res = ev(build(y, CubicSpline(), x=x), q)
    expect = [
        0.5, 0.1851851851851852, 0.01851851851851853, -5.551115123125783e-17,
        0.12962962962962965, 0.40740740740740755, 0.8333333333333331,
        1.407407407407407, 2.1296296296296293, 3.0,
    ]
    np.testing.assert_allclose(res, expect, atol=1e-13)
    np.testing.assert_allclose(res, jev(jbuild(y, jcs.CubicSpline(), x=x), q), atol=1e-13)


def test_interp_natural():
    # cubic_spline_strat.rs:10-27
    data = np.array([1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0, 0.0, 2.0, 4.0, 6.0, 8.0])
    q = np.linspace(0.0, 11.0, 30)
    res = ev(build(data, CubicSpline().boundary(BoundaryCondition.Natural)), q)
    expect = [
        1., 1.39170823, 1.77091526, 2.125721, 2.47352006, 2.87359686,
        3.36922189, 3.82291953, 3.99824026, 3.75923077, 3.27970993,
        2.78813427, 2.3908915, 2.05692316, 1.74411903, 1.38442937,
        0.89919307, 0.32738558, -0.0156797, 0.20564422, 0.96539094,
        1.91643779, 2.75736868, 3.48596188, 4.19763049, 4.94786851,
        5.71920918, 6.4877215, 7.24638389, 8.,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    oracle = si.CubicSpline(np.arange(12.0), data, bc_type="natural")
    np.testing.assert_allclose(res, oracle(q), atol=1e-12)
    j = jbuild(data, jcs.CubicSpline().boundary(jcs.BoundaryCondition.Natural))
    np.testing.assert_allclose(res, jev(j, q), atol=1e-12)


def test_too_little_data():
    # :29-35
    with pytest.raises(NotEnoughDataError):
        build(np.array([1.0, 2.0]), CubicSpline())


def test_enough_data():
    # :37-43
    build(np.array([1.0, 2.0, 1.0]), CubicSpline())


def test_extrapolate_false():
    # :45-55
    interp = build(np.array([1.0, 2.0, 1.0]), CubicSpline())
    with pytest.raises(OutOfBoundsError):
        interp.interp(-0.5)
    with pytest.raises(OutOfBoundsError):
        interp.interp(3.5)


@pytest.mark.parametrize(
    "bc, bc_scipy",
    [("Natural", "natural"), ("Clamped", "clamped"), ("NotAKnot", "not-a-knot")],
)
def test_extrapolate_uniform_boundaries_vs_scipy(bc, bc_scipy):
    # :57-105 (natural), :257-305 (clamped), :108-154 (not-a-knot)
    res = ev(build(DATA12, CubicSpline().extrapolate(True).boundary(
        getattr(BoundaryCondition, bc))), Q30)
    oracle = si.CubicSpline(np.arange(12.0), DATA12, bc_type=bc_scipy)
    np.testing.assert_allclose(res, oracle(Q30), atol=1e-11)
    j = jbuild(DATA12, jcs.CubicSpline().extrapolate(True).boundary(_jbc(bc)))
    np.testing.assert_allclose(res, jev(j, Q30), atol=1e-11)


def test_extrapolate_not_a_knot_f32():
    # :108-154, in f32 as the reference runs it
    data = DATA12.astype(np.float32)
    q = Q30.astype(np.float32)
    res = ev(build(data, CubicSpline().extrapolate(True)), q)
    assert res.dtype == np.float32
    oracle = si.CubicSpline(np.arange(12.0), data.astype(np.float64), bc_type="not-a-knot")
    np.testing.assert_allclose(res, oracle(Q30), rtol=2e-4, atol=2e-4)
    j = jbuild(data, jcs.CubicSpline().extrapolate(True))
    np.testing.assert_allclose(res, jev(j, q), rtol=2e-4, atol=2e-4)


def test_not_a_knot_3_values():
    # :157-188
    y = np.array([1.0, 2.0, 0.0])
    q = np.linspace(-1.0, 3.0, 15)
    res = ev(build(y, CubicSpline().boundary(BoundaryCondition.NotAKnot).extrapolate(True)), q)
    expect = [
        -3., -1.55102041, -0.34693878, 0.6122449, 1.32653061, 1.79591837,
        2.02040816, 2., 1.73469388, 1.2244898, 0.46938776, -0.53061224,
        -1.7755102, -3.26530612, -5.,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    j = jbuild(y, jcs.CubicSpline().boundary(jcs.BoundaryCondition.NotAKnot).extrapolate(True))
    np.testing.assert_allclose(res, jev(j, q), rtol=0.001, atol=1e-7)


def _mixed_rows(m):
    return m.BoundaryCondition.Individual(np.array([[
        m.RowBoundary.Natural,
        m.RowBoundary.Mixed(m.SingleBoundary.NotAKnot, m.SingleBoundary.FirstDeriv(0.5)),
    ]], dtype=object))


class _Port:
    BoundaryCondition, RowBoundary, SingleBoundary = BoundaryCondition, RowBoundary, SingleBoundary


def test_multidim_multi_bounds():
    # :191-255
    y = np.array([[0.5, 1.0], [0.0, 1.5], [3.0, 0.5]])
    x = np.array([-1.0, 0.0, 3.0])
    q = np.linspace(-2.0, 4.0, 15)
    res = ev(build(y, CubicSpline().boundary(_mixed_rows(_Port)).extrapolate(True), x=x), q)
    col0 = [
        1., 0.85787172, 0.59766764, 0.30794461, 0.07725948, -0.00655977,
        0.10058309, 0.375, 0.78717201, 1.30758017, 1.90670554, 2.55502915,
        3.22303207, 3.88119534, 4.5,
    ]
    col1 = [
        -1.13194444, 0.02834467, 0.81235828, 1.27749433, 1.48115079,
        1.48072562, 1.33361678, 1.09722222, 0.82893991, 0.5861678,
        0.42630385, 0.40674603, 0.58489229, 1.01814059, 1.76388889,
    ]
    np.testing.assert_allclose(res[:, 0], col0, rtol=0.001, atol=1e-7)
    np.testing.assert_allclose(res[:, 1], col1, rtol=0.001, atol=1e-7)
    j = jbuild(y, jcs.CubicSpline().boundary(_mixed_rows(jcs)).extrapolate(True), x=x)
    np.testing.assert_allclose(res, jev(j, q), rtol=0.001, atol=1e-7)


@pytest.mark.parametrize("deriv,bc", [(1, "FirstDeriv"), (2, "SecondDeriv")])
def test_extrapolate_deriv_boundaries(deriv, bc):
    # :308-411
    def rows(m):
        mk = getattr(m.SingleBoundary, bc)
        return m.BoundaryCondition.Individual(
            np.array([m.RowBoundary.Mixed(mk(-0.1), mk(-0.5))], dtype=object))

    res = ev(build(DATA12, CubicSpline().extrapolate(True).boundary(rows(_Port))), Q30)
    oracle = si.CubicSpline(np.arange(12.0), DATA12, bc_type=((deriv, -0.1), (deriv, -0.5)))
    np.testing.assert_allclose(res, oracle(Q30), atol=1e-11)
    j = jbuild(DATA12, jcs.CubicSpline().extrapolate(True).boundary(rows(jcs)))
    np.testing.assert_allclose(res, jev(j, Q30), atol=1e-11)


def test_bounds_shape_error1():
    # :413-426
    y = np.array([[0.5, 1.0], [0.0, 1.5], [3.0, 0.5]])
    boundaries = BoundaryCondition.Individual(np.array(
        [[RowBoundary.Natural, RowBoundary.Clamped, RowBoundary.NotAKnot]], dtype=object))
    with pytest.raises(ShapeError, match=r"Expected: \[1, 2\], got: \[1, 3\]"):
        build(y, CubicSpline().boundary(boundaries))


def test_bounds_shape_error2():
    # :428-440
    y = np.array([[0.5, 1.0], [0.0, 1.5], [3.0, 0.5]])
    boundaries = BoundaryCondition.Individual(np.array(
        [[RowBoundary.Natural, RowBoundary.NotAKnot],
         [RowBoundary.Natural, RowBoundary.NotAKnot]], dtype=object))
    with pytest.raises(ShapeError, match=r"Expected: \[1, 2\], got: \[2, 2\]"):
        build(y, CubicSpline().boundary(boundaries))


def test_periodic_wrong_values():
    # :442-452
    y = np.array([[0.5, 1.0], [0.0, 1.5], [0.5, 1.1]])
    with pytest.raises(BuilderValueError, match="first and last value must be equal"):
        build(y, CubicSpline().boundary(BoundaryCondition.Periodic))


def _periodic(x=None, data=None, q=None):
    res = ev(build(data, CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic),
                   x=x), q)
    j = jbuild(data, jcs.CubicSpline().extrapolate(True).boundary(jcs.BoundaryCondition.Periodic),
               x=x)
    return res, jev(j, q)


def test_extrapolate_periodic():
    # :455-501
    data = np.array([1.0, 2.0, 2.5, 2.5, 3.0, 2.0, 1.0, -2.0, 3.0, 5.0, 6.3, 1.0])
    res, jres = _periodic(data=data, q=Q30)
    expect = [
        3., 4.45171164, 5.5978812, 6.54905092, 3.79486808, 0.76011398,
        1.36656494, 2.4432986, 2.50822019, 2.40158688, 2.63514361,
        3.01451693, 2.59950279, 1.96267846, 1.65029582, -0.22831889,
        -2.04318459, 0.41031552, 3.63201944, 4.66215778, 6.05245899,
        6.19632834, 2.68818585, 0.64246067, 1.77979077, 2.52789822,
        2.46676892, 2.41681682, 2.76866398, 3.,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    oracle = si.CubicSpline(np.arange(12.0), data, bc_type="periodic")
    np.testing.assert_allclose(res, oracle(np.mod(Q30, 11.0)), atol=1e-12)
    np.testing.assert_allclose(res, jres, atol=1e-12)


def test_extrapolate_periodic_multidim():
    # :504-537
    y = np.array([[0.5, 1.0], [0.0, 1.5], [0.0, 1.5], [0.5, 1.0]])
    res, jres = _periodic(x=np.array([-1.0, 0.0, 2.0, 3.0]), data=y,
                          q=np.linspace(-1.5, 3.5, 15))
    expect = [
        [0.325, 1.175], [0.48279883, 1.01720117], [0.46260933, 1.03739067],
        [0.28075802, 1.21924198], [0.04424198, 1.45575802],
        [-0.14693878, 1.64693878], [-0.26173469, 1.76173469], [-0.3, 1.8],
        [-0.26173469, 1.76173469], [-0.14693878, 1.64693878],
        [0.04424198, 1.45575802], [0.28075802, 1.21924198],
        [0.46260933, 1.03739067], [0.48279883, 1.01720117], [0.325, 1.175],
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    np.testing.assert_allclose(res, jres, rtol=0.001, atol=1e-7)


def test_extrapolate_periodic_len3():
    # :540-573
    res, jres = _periodic(x=np.array([-1.0, 0.0, 3.0]), data=np.array([0.5, 0.0, 0.5]),
                          q=np.linspace(-1.5, 3.5, 15))
    expect = [
        0.55555556, 0.53773891, 0.40889213, 0.20845481, 0.02623907,
        -0.05701328, -0.03717201, 0.05555556, 0.19080013, 0.33819242,
        0.46736314, 0.54794299, 0.54956268, 0.44314869, 0.25,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    np.testing.assert_allclose(res, jres, rtol=0.001, atol=1e-7)


def test_extrapolate_periodic_len3_multidim():
    # :576-609
    y = np.array([[0.5, 1.0], [0.0, 2.5], [0.5, 1.0]])
    res, jres = _periodic(x=np.array([-1.0, 0.0, 3.0]), data=y, q=np.linspace(-1.5, 3.5, 15))
    expect = [
        [0.55555556, 0.83333333], [0.53773891, 0.88678328],
        [0.40889213, 1.27332362], [0.20845481, 1.87463557],
        [0.02623907, 2.4212828], [-0.05701328, 2.67103984],
        [-0.03717201, 2.61151603], [0.05555556, 2.33333333],
        [0.19080013, 1.92759961], [0.33819242, 1.48542274],
        [0.46736314, 1.09791059], [0.54794299, 0.85617104],
        [0.54956268, 0.85131195], [0.44314869, 1.17055394], [0.25, 1.75],
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    np.testing.assert_allclose(res, jres, rtol=0.001, atol=1e-7)


# --- beyond the reference (the JAX package's additions) --------------------------------------
def test_batched_individual_matches_per_row_solve():
    """The batched Individual solve equals solving each row alone."""
    rng = np.random.default_rng(7)
    y = rng.normal(size=(8, 3))
    x = np.sort(rng.uniform(0, 10, size=8))

    def rows(m):
        return np.array([[
            m.RowBoundary.Natural,
            m.RowBoundary.Mixed(m.SingleBoundary.FirstDeriv(1.5),
                                m.SingleBoundary.SecondDeriv(-2.0)),
            m.RowBoundary.NotAKnot,
        ]], dtype=object)

    q = np.linspace(-1.0, 11.0, 23)
    strat = CubicSpline().extrapolate(True).boundary(BoundaryCondition.Individual(rows(_Port)))
    batched = ev(build(y, strat, x=x), q)
    for col in range(3):
        one = BoundaryCondition.Individual(np.array([rows(_Port)[0, col]], dtype=object))
        single = ev(build(y[:, col], CubicSpline().extrapolate(True).boundary(one), x=x), q)
        np.testing.assert_allclose(batched[:, col], single, rtol=1e-14, atol=1e-14)
    j = jbuild(y, jcs.CubicSpline().extrapolate(True).boundary(
        jcs.BoundaryCondition.Individual(rows(jcs))), x=x)
    np.testing.assert_allclose(batched, jev(j, q), rtol=1e-12, atol=1e-12)


def _unchecked_twice(x, data, strat, q):
    """``strat.build`` + ``new_unchecked`` + ``__call__`` twice (the JAX
    file's jitted build): both calls equal, returned as numpy."""
    xt, dt, qt = (torch.as_tensor(v) for v in (x, data, q))
    first = Interp1D.new_unchecked(xt, dt, strat.build(xt, dt))(qt)
    again = Interp1D.new_unchecked(xt, dt, strat.build(xt, dt))(qt)
    assert torch.equal(first, again)
    return first.numpy()


def test_build_under_jit():
    """The strategy's build outside the builder (uniform boundaries)."""
    x = np.linspace(0.0, 1.0, 16)
    data = np.random.default_rng(3).normal(size=(16, 4))
    q = np.linspace(0.0, 1.0, 11)
    got = _unchecked_twice(x, data, CubicSpline().extrapolate(True), q)
    np.testing.assert_allclose(got, ev(build(data, CubicSpline().extrapolate(True), x=x), q),
                               atol=1e-14)

    @jax.jit
    def jmake(data, q):
        strat = jcs.CubicSpline().extrapolate(True).build(jnp.asarray(x), data)
        return j1.Interp1D.new_unchecked(jnp.asarray(x), data, strat)(q)

    np.testing.assert_allclose(got, jmake(jnp.asarray(data), jnp.asarray(q)), atol=1e-14)


def test_periodic_build_under_jit():
    """The periodic strategy's build outside the builder."""
    x = np.linspace(0.0, 1.0, 12)
    data = np.random.default_rng(7).normal(size=(12, 3))
    data[-1] = data[0]
    q = np.linspace(-0.3, 1.3, 9)
    strat = CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic)
    got = _unchecked_twice(x, data, strat, q)
    np.testing.assert_allclose(got, ev(build(data, strat, x=x), q), atol=1e-14)
    j = jbuild(data, jcs.CubicSpline().extrapolate(True).boundary(jcs.BoundaryCondition.Periodic),
               x=x)
    np.testing.assert_allclose(got, jev(j, q), atol=1e-14)


def test_individual_boundaries_build_under_jit():
    """Per-row boundaries as kind/value tensors (``IndividualArrays``) equal
    the object-array ``Individual`` form exactly."""
    x = np.linspace(0.0, 2.0, 10)
    data = np.random.default_rng(11).normal(size=(10, 4))

    def rows(m):
        r = np.empty((1, 4), dtype=object)
        r[0, 0] = m.RowBoundary.NotAKnot
        r[0, 1] = m.RowBoundary.Natural
        r[0, 2] = m.RowBoundary.Mixed(m.SingleBoundary.FirstDeriv(0.5),
                                      m.SingleBoundary.SecondDeriv(-1.0))
        r[0, 3] = m.RowBoundary.Clamped
        return r

    q = np.linspace(-0.2, 2.2, 13)
    eager = ev(build(data, CubicSpline().extrapolate(True).boundary(
        BoundaryCondition.Individual(rows(_Port))), x=x), q)
    # same encoding as arrays: 0 = NAK, 1 = first derivative, 2 = second
    arrays = (torch.tensor([0, 2, 1, 1], dtype=torch.int32),
              torch.tensor([0.0, 0.0, 0.5, 0.0], dtype=torch.float64),
              torch.tensor([0, 2, 2, 1], dtype=torch.int32),
              torch.tensor([0.0, 0.0, -1.0, 0.0], dtype=torch.float64))
    strat = CubicSpline().extrapolate(True).boundary(BoundaryCondition.IndividualArrays(*arrays))
    got = _unchecked_twice(x, data, strat, q)
    np.testing.assert_allclose(got, eager, atol=1e-14)
    j = jbuild(data, jcs.CubicSpline().extrapolate(True).boundary(
        jcs.BoundaryCondition.IndividualArrays(*(jnp.asarray(a.numpy()) for a in arrays))), x=x)
    np.testing.assert_allclose(got, jev(j, q), atol=1e-12)


def test_individual_arrays_shape_error():
    x = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    data = torch.ones((5, 3), dtype=torch.float64)
    bc = BoundaryCondition.IndividualArrays(
        torch.zeros((2,), dtype=torch.int32), torch.zeros((2,)),
        torch.zeros((2,), dtype=torch.int32), torch.zeros((2,)))
    with pytest.raises(ShapeError, match="wrong shape"):
        CubicSpline().boundary(bc).build(x, data)


def test_grad_through_build_and_eval():
    x = np.linspace(0.0, 1.0, 8)
    q = np.linspace(0.1, 0.9, 5)
    d0 = np.random.default_rng(0).normal(size=8)
    xt, qt = torch.as_tensor(x), torch.as_tensor(q)

    def loss(data):
        strat = CubicSpline().extrapolate(True).build(xt, data)
        return (Interp1D.new_unchecked(xt, data, strat)(qt) ** 2).sum()

    data = torch.as_tensor(d0).requires_grad_()
    (g,) = torch.autograd.grad(loss(data), data)
    eps = 1e-6
    fd = np.zeros_like(d0)
    for i in range(8):
        dp, dm = d0.copy(), d0.copy()
        dp[i] += eps
        dm[i] -= eps
        fd[i] = (float(loss(torch.as_tensor(dp))) - float(loss(torch.as_tensor(dm)))) / (2 * eps)
    np.testing.assert_allclose(g.numpy(), fd, rtol=1e-5, atol=1e-8)

    def jloss(data):
        strat = jcs.CubicSpline().extrapolate(True).build(jnp.asarray(x), data)
        itp = j1.Interp1D.new_unchecked(jnp.asarray(x), data, strat)
        return jnp.sum(itp(jnp.asarray(q)) ** 2)

    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(d0))),
                               rtol=1e-10, atol=1e-12)
