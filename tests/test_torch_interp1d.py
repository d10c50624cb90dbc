"""The PyTorch port's ``Interp1D`` against the JAX package's, on the CPU.

Every case builds the same interpolator in both packages from the same
numpy inputs (made from seeds) and compares what the public API returns:
values, output shapes (``M + N - 1``), NaN masks, and the exception class
and message of every error path.

Tolerances: f32 ``rtol=2e-5`` with ``atol=1e-6`` scaled by the largest
|value| (``test_pallas_eval.py:55-57``; the two packages build and evaluate
in different operation orders where FMA contraction differs); f64
``rtol=1e-12`` with the same scaling (``atol=1e-12`` times the largest
|value|), the bar the repo's f64 check against SciPy sets.
"""

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.errors as j_err
import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp1d.cubic_spline as j_cs
import ndarray_interp_tpu_torch.errors as t_err
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.interp1d.cubic_spline as t_cs
from ndarray_interp_tpu_torch.interop import interp1d_from_numpy
from ndarray_interp_tpu_torch.ops import kernel_wrappers
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


PKG = {"jax": (j1, j_cs, jnp.asarray), "torch": (t1, t_cs, torch.as_tensor)}
TOL = {np.float32: (2e-5, 1e-6), np.float64: (1e-12, 1e-12)}


def assert_close(got, want, dtype):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    rtol, atol = TOL[dtype]
    finite = want[~nan_w]
    scale = float(np.max(np.abs(finite))) if finite.size else 1.0
    np.testing.assert_allclose(got[~nan_g], finite, rtol=rtol, atol=atol * scale)


# -- strategies, built the same way in both packages -----------------------------
KINDS = [
    "linear", "not_a_knot", "natural", "clamped", "periodic", "individual",
    "individual_arrays",
]


def strategy(pkg, kind, extrapolate, trailing):
    m, cs, _ = PKG[pkg]
    if kind == "linear":
        return m.Linear().extrapolate(extrapolate)
    bc = cs.BoundaryCondition
    if kind in ("not_a_knot", "natural", "clamped", "periodic"):
        named = {"not_a_knot": bc.NotAKnot, "natural": bc.Natural,
                 "clamped": bc.Clamped, "periodic": bc.Periodic}[kind]
        return m.CubicSpline().extrapolate(extrapolate).boundary(named)
    rb, sb = cs.RowBoundary, cs.SingleBoundary
    cycle = [
        rb.Natural,
        rb.Mixed(sb.NotAKnot, sb.FirstDeriv(0.5)),
        rb.Clamped,
        rb.Mixed(sb.SecondDeriv(-1.0), sb.NotAKnot),
        rb.NotAKnot,
    ]
    size = int(np.prod(trailing)) if trailing else 1
    if kind == "individual":
        rows = np.empty(size, dtype=object)
        for i in range(size):
            rows[i] = cycle[i % len(cycle)]
        return m.CubicSpline().extrapolate(extrapolate).boundary(
            bc.Individual(rows.reshape((1,) + trailing))
        )
    # individual_arrays: 0 = not-a-knot, 1 = first derivative, 2 = second
    i = np.arange(size)
    lk = (i % 3).astype(np.int32).reshape(trailing)
    rk = ((i + 1) % 3).astype(np.int32).reshape(trailing)
    lv = np.linspace(-1.0, 1.0, size).reshape(trailing)
    rv = np.linspace(0.5, -0.5, size).reshape(trailing)
    return m.CubicSpline().extrapolate(extrapolate).boundary(
        bc.IndividualArrays(lk, lv, rk, rv)
    )


def case(kind, trailing, dtype, n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    x[0], x[-1] = 0.0, 10.0
    data = rng.normal(size=(n,) + trailing)
    if kind == "periodic":
        data[-1] = data[0]
    return x.astype(dtype), data.astype(dtype)


def build(pkg, kind, x, data, extrapolate=False):
    m, _, arr = PKG[pkg]
    trailing = tuple(data.shape[1:])
    return (
        m.Interp1D.builder(arr(data))
        .x(arr(x))
        .strategy(strategy(pkg, kind, extrapolate, trailing))
        .build()
    )


# -- values ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("trailing", [(), (8,), (3, 4)])
@pytest.mark.parametrize("kind", KINDS)
def test_values_match_jax(kind, trailing, dtype):
    if kind == "individual" and trailing == ():
        trailing = (1,)
    x, data = case(kind, trailing, dtype)
    q = np.random.default_rng(1).uniform(-2.0, 12.0, 40).astype(dtype)
    for extrapolate in (False, True):
        j = build("jax", kind, x, data, extrapolate)
        t = build("torch", kind, x, data, extrapolate)
        got = t(torch.as_tensor(q))
        assert got.dtype == torch.as_tensor(data).dtype
        assert tuple(got.shape) == (40,) + trailing
        # out-of-range queries are NaN unless the strategy extrapolates
        assert_close(got, j(jnp.asarray(q)), dtype)
        inside = q[(q >= 0.0) & (q <= 10.0)]
        assert_close(t.interp_array(inside), j.interp_array(jnp.asarray(inside)), dtype)
        if kind != "linear":
            assert_close(t.strategy.a, j.strategy.a, dtype)
            assert_close(t.strategy.b, j.strategy.b, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_main_path_slice_matches_jax_and_scipy(dtype):
    """The slice end to end, at small widths: a not-a-knot spline with
    extrapolation, a spline bank, and the default Linear on a bank."""
    rng = np.random.default_rng(42)
    kn = np.linspace(0.0, 100.0, 256).astype(dtype)
    vals = rng.normal(size=256).astype(dtype)
    q = rng.uniform(-1.0, 101.0, 4096).astype(dtype)
    itps = {
        pkg: PKG[pkg][0].Interp1D.builder(PKG[pkg][2](vals)).x(PKG[pkg][2](kn))
        .strategy(PKG[pkg][0].CubicSpline().extrapolate(True)).build()
        for pkg in PKG
    }
    got = itps["torch"](torch.as_tensor(q))
    assert_close(got, itps["jax"](jnp.asarray(q)), dtype)
    ref = si.CubicSpline(kn.astype(np.float64), vals.astype(np.float64))(q.astype(np.float64))
    scaled = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert scaled <= (1e-5 if dtype == np.float32 else 1e-12)

    xb = np.linspace(0.0, 1.0, 500).astype(dtype)
    bank = rng.normal(size=(500, 16)).astype(dtype)
    qb = rng.uniform(0.0, 1.0, 2048).astype(dtype)
    for kind in ("not_a_knot", "linear"):
        j = build("jax", kind, xb, bank, extrapolate=kind != "linear")
        t = build("torch", kind, xb, bank, extrapolate=kind != "linear")
        assert_close(t.interp_array(torch.as_tensor(qb)), j.interp_array(jnp.asarray(qb)), dtype)


@pytest.mark.parametrize("qshape", [(), (5,), (2, 3)])
@pytest.mark.parametrize("trailing", [(), (3, 4)])
def test_query_shapes_give_m_plus_n_minus_1_dims(qshape, trailing):
    x, data = case("not_a_knot", trailing, np.float64)
    q = np.random.default_rng(2).uniform(0.0, 10.0, qshape)
    j = build("jax", "not_a_knot", x, data)
    t = build("torch", "not_a_knot", x, data)
    want = qshape + trailing
    for fn in ("__call__", "interp_array", "eval_unchecked"):
        got = getattr(t, fn)(torch.as_tensor(q))
        assert tuple(got.shape) == want
        assert_close(got, getattr(j, fn)(jnp.asarray(q)), np.float64)
    assert t.get_buffer_shape(qshape) == j.get_buffer_shape(qshape) == want


def test_periodic_wrap_matches_jax():
    x, data = case("periodic", (2,), np.float64, n=9)
    q = np.linspace(-25.0, 35.0, 121)
    j = build("jax", "periodic", x, data, extrapolate=True)
    t = build("torch", "periodic", x, data, extrapolate=True)
    assert t.strategy.mode == "periodic"
    assert_close(t(torch.as_tensor(q)), j(jnp.asarray(q)), np.float64)
    # one period apart gives the same value
    assert_close(t(torch.as_tensor(q + 10.0)), t(torch.as_tensor(q)), np.float64)


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("kind", ["not_a_knot", "periodic"])
def test_short_axis_special_cases_match_jax(kind, n):
    # three knots: the not-a-knot parabola and the periodic closed form
    x, data = case(kind, (3,), np.float64, n=n, seed=n)
    q = np.linspace(-1.0, 11.0, 25)
    j = build("jax", kind, x, data, extrapolate=True)
    t = build("torch", kind, x, data, extrapolate=True)
    assert_close(t(torch.as_tensor(q)), j(jnp.asarray(q)), np.float64)


# -- integer data ---------------------------------------------------------------
@pytest.mark.parametrize("q", [[0, 1, 2, 3], [0.5, 2.5]])
def test_integer_linear_matches_jax(q):
    data = np.array([0, 3, 4, -7], np.int64)
    j = j1.Interp1D.builder(jnp.asarray(data)).build()
    t = t1.Interp1D.builder(data, device="cpu").build()
    want = np.asarray(j.interp_array(jnp.asarray(q)))
    got = t.interp_array(q).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- eager API -------------------------------------------------------------------
@BOTH_ROUTES
def test_interp_family_and_buffers():
    x, data = case("not_a_knot", (), np.float64)
    j = build("jax", "not_a_knot", x, data)
    t = build("torch", "not_a_knot", x, data)
    s = t.interp_scalar(3.7)
    assert np.ndim(s) == 0
    np.testing.assert_allclose(float(s), float(j.interp_scalar(3.7)), rtol=1e-12)
    np.testing.assert_allclose(float(t.interp(3.7)), float(np.asarray(j.interp(3.7))), rtol=1e-12)

    xb, bank = case("not_a_knot", (2, 3), np.float64)
    jb = build("jax", "not_a_knot", xb, bank)
    tb = build("torch", "not_a_knot", xb, bank)
    q = np.array([[1.0, 2.5], [9.0, 0.0]])
    for buf in (np.zeros((2, 2, 2, 3)), torch.zeros((2, 2, 2, 3), dtype=torch.float64)):
        out = tb.interp_array_into(q, buf)
        assert out is buf
        assert_close(buf, jb.interp_array(jnp.asarray(q)), np.float64)
    for buf in (np.zeros((2, 3)), torch.zeros((2, 3), dtype=torch.float64)):
        assert tb.interp_into(4.2, buf) is buf
        assert_close(buf, jb.interp(4.2), np.float64)


def test_new_unchecked_and_interop_carry_jax_state():
    for dtype in (np.float32, np.float64):
        for kind, extrap in (("not_a_knot", True), ("periodic", True), ("linear", False)):
            x, data = case(kind, (4,), dtype)
            j = build("jax", kind, x, data, extrapolate=extrap)
            q = np.linspace(-3.0, 13.0, 33).astype(dtype)
            s = j.strategy
            if kind == "linear":
                t = interp1d_from_numpy(np.asarray(j.x), np.asarray(j.data),
                                        mode="yes" if s.extrapolates else "no", device="cpu")
            else:
                t = interp1d_from_numpy(np.asarray(j.x), np.asarray(j.data),
                                        a=np.asarray(s.a), b=np.asarray(s.b), mode=s.mode,
                                        device="cpu")
            assert t.strategy.extrapolates == s.extrapolates
            assert_close(t(torch.as_tensor(q)), j(jnp.asarray(q)), dtype)
    with pytest.raises(ValueError, match="mode"):
        interp1d_from_numpy(x, data, mode="sideways", device="cpu")


def test_builder_device_and_dtype_placement():
    t = t1.Interp1D.builder([0.0, 1.0, 4.0], device="cpu").build()
    assert t.x.device.type == "cpu" and t.data.dtype == torch.float64  # lists go via numpy
    d = torch.arange(5, dtype=torch.float32)
    t = t1.Interp1D.builder(d).x(np.arange(5.0)).build()
    assert t.data.device == d.device and t.x.dtype == torch.float64  # promoted as in JAX
    j = j1.Interp1D.builder(jnp.arange(5, dtype=jnp.float32)).x(jnp.arange(5.0)).build()
    assert str(t.data.dtype).removeprefix("torch.") == str(j.data.dtype)


def test_numpy_input_without_a_device_needs_the_card(monkeypatch):
    """Entry points put numpy and list inputs on the GPU unless a device is
    named; without a CUDA device they raise instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.arange(4.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t1.Interp1D.builder(data)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        interp1d_from_numpy(np.arange(4.0), data)
    # a named device or a tensor needs no card
    assert t1.Interp1D.builder(data, device="cpu").build().x.device.type == "cpu"
    assert t1.Interp1D.builder(torch.as_tensor(data)).x(data).build().x.device.type == "cpu"


def test_autograd_through_build_and_eval_matches_jax():
    x, data = case("not_a_knot", (3,), np.float64)
    q = np.linspace(0.5, 9.5, 17)
    jx, jq = jnp.asarray(x), jnp.asarray(q)

    def loss(d):
        s = j_cs.CubicSpline().extrapolate(True).build(jx, d)
        return jnp.sum(j1.Interp1D.new_unchecked(jx, d, s)(jq) ** 2)

    want = jax.grad(loss)(jnp.asarray(data))
    d = torch.as_tensor(data).requires_grad_(True)
    t = (
        t1.Interp1D.builder(d).x(torch.as_tensor(x))
        .strategy(t1.CubicSpline().extrapolate(True)).build()
    )
    (t(torch.as_tensor(q)) ** 2).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_cpu_interpolators_launch_no_kernel():
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    x, data = case("not_a_knot", (4,), np.float32)
    for kind in ("not_a_knot", "linear"):
        build("torch", kind, x, data, extrapolate=True)(torch.linspace(0, 10, 9))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


# -- errors: same class, same message ------------------------------------------------
def _bad_rows(pkg):
    _, cs, _ = PKG[pkg]
    return cs.BoundaryCondition.Individual(
        np.array([[cs.RowBoundary.Natural, cs.RowBoundary.Clamped]], dtype=object)
    )


def _bad_arrays(pkg):
    _, cs, _ = PKG[pkg]
    z = np.zeros((2,))
    return cs.BoundaryCondition.IndividualArrays(z.astype(np.int32), z, z.astype(np.int32), z)


ERROR_CASES = {
    "scalar data": lambda m, cs, a: m.Interp1D.builder(a(np.float64(1.0))).build(),
    "linear needs 2": lambda m, cs, a: m.Interp1D.builder(a(np.array([1.0]))).build(),
    "cubic needs 3": lambda m, cs, a: m.Interp1D.builder(a(np.array([1.0, 2.0])))
    .strategy(m.CubicSpline()).build(),
    "not monotonic": lambda m, cs, a: m.Interp1D.builder(a(np.arange(4.0)))
    .x(a(np.array([0.0, 2.0, 1.0, 3.0]))).build(),
    "flat x": lambda m, cs, a: m.Interp1D.builder(a(np.arange(4.0)))
    .x(a(np.array([0.0, 1.0, 1.0, 3.0]))).build(),
    "length mismatch": lambda m, cs, a: m.Interp1D.builder(a(np.arange(4.0)))
    .x(a(np.arange(5.0))).build(),
    "periodic first != last": lambda m, cs, a: m.Interp1D.builder(a(np.array([0.0, 1.0, 2.0, 3.0])))
    .strategy(m.CubicSpline().boundary(cs.BoundaryCondition.Periodic)).build(),
    "individual shape": lambda m, cs, a: m.Interp1D.builder(a(np.ones((4, 3))))
    .strategy(m.CubicSpline().boundary(_bad_rows("jax" if m is j1 else "torch"))).build(),
    "individual arrays shape": lambda m, cs, a: m.Interp1D.builder(a(np.ones((4, 3))))
    .strategy(m.CubicSpline().boundary(_bad_arrays("jax" if m is j1 else "torch"))).build(),
    "cubic integer data": lambda m, cs, a: m.Interp1D.builder(a(np.arange(5)))
    .strategy(m.CubicSpline()).build(),
    "interp_scalar on a bank": lambda m, cs, a: m.Interp1D.builder(a(np.ones((4, 2))))
    .build().interp_scalar(1.0),
    "out of bounds": lambda m, cs, a: m.Interp1D.builder(a(np.arange(4.0))).build()
    .interp_array(a(np.array([1.0, 5.5, -1.0]))),
    "out of bounds f32": lambda m, cs, a: m.Interp1D.builder(a(np.arange(4.0, dtype=np.float32)))
    .build().interp(a(np.float32(3.1))),
    "NaN query, not extrapolating": lambda m, cs, a: m.Interp1D.builder(a(np.arange(4.0)))
    .build().interp_array(a(np.array([1.0, np.nan]))),
    "NaN query, extrapolating": lambda m, cs, a: m.Interp1D.builder(a(np.arange(4.0)))
    .strategy(m.Linear().extrapolate(True)).build().interp_array(a(np.array([np.nan]))),
    "buffer shape": lambda m, cs, a: m.Interp1D.builder(a(np.ones((4, 2)))).build()
    .interp_into(1.0, np.zeros(3)),
    "array buffer shape": lambda m, cs, a: m.Interp1D.builder(a(np.ones((4, 2)))).build()
    .interp_array_into(np.array([1.0]), np.zeros((2, 2))),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_errors_match_jax(name):
    raised = {}
    for pkg, (m, cs, arr) in PKG.items():
        with pytest.raises(Exception) as info:
            ERROR_CASES[name](m, cs, arr)
        raised[pkg] = info.value
    j, t = raised["jax"], raised["torch"]
    assert type(t).__name__ == type(j).__name__
    assert str(t) == str(j)
    if isinstance(j, j_err.BuilderError):
        assert isinstance(t, t_err.BuilderError)
    if isinstance(j, j_err.InterpolateError):
        assert isinstance(t, t_err.InterpolateError)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["linear", "not_a_knot"])
def test_is_in_range_matches_jax(kind, dtype):
    """``Interp1D.is_in_range`` (``models/interp1d.py:188-189`` of the JAX
    package, ``mod.rs:384-386``): the same booleans for queries inside, at
    both ends, just outside, far outside, +-inf and NaN, given as numpy (the
    port moves them to the axis's device) and as a tensor."""
    x, data = case(kind, (3,), dtype)
    lo, hi = x[0], x[-1]
    q = np.r_[np.random.default_rng(5).uniform(-2.0, 12.0, 30), x,
              [lo - 1e-3, np.nextafter(hi, np.inf), -1e30, 1e30,
               np.inf, -np.inf, np.nan]].astype(dtype)
    want = np.asarray(build("jax", kind, x, data).is_in_range(jnp.asarray(q)))
    t = build("torch", kind, x, data)
    assert want.dtype == np.bool_ and want[30] and want[41] and not want[42:].any()
    for given in (q, torch.as_tensor(q)):
        got = t.is_in_range(given)
        assert got.dtype == torch.bool and got.device == t.x.device
        np.testing.assert_array_equal(got.numpy(), want)


def test_call_masks_out_of_range_to_nan_without_raising():
    x, data = case("not_a_knot", (2,), np.float64)
    t = build("torch", "not_a_knot", x, data)
    out = t(torch.tensor([-1.0, 5.0, 11.0, float("nan")], dtype=torch.float64))
    assert torch.isnan(out[[0, 2, 3]]).all() and torch.isfinite(out[1]).all()


def test_zero_coefficient_spline_at_infinity_diverges_from_jax_xla():
    """A cubic state with a = b = 0 (a straight line) at a +-inf query: the
    port's eval kernel, like the JAX package's Pallas kernel
    (``pallas_eval.py:184-188``), extrapolates the lerp to +-inf; the JAX XLA
    formulation gives inf - inf = NaN.  Logged in ROADMAP Queue 3."""
    x = np.linspace(0.0, 3.0, 4)
    data = 2.0 * x
    zeros = np.zeros(3)
    t = interp1d_from_numpy(x, data, a=zeros, b=zeros, mode="yes", device="cpu")
    q = np.array([np.inf, -np.inf, 1.5])
    got = t(torch.as_tensor(q)).numpy()
    assert got[0] == np.inf and got[1] == -np.inf and got[2] == 3.0
    j = j1.Interp1D.new_unchecked(
        jnp.asarray(x), jnp.asarray(data),
        j_cs.CubicSplineStrategy(jnp.asarray(zeros), jnp.asarray(zeros), "yes"),
    )
    want = np.asarray(j(jnp.asarray(q)))
    assert np.isnan(want[0]) and np.isnan(want[1]) and want[2] == 3.0
