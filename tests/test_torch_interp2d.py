"""The port's ``Interp2D`` and ``Bilinear`` against the JAX package's, on the
CPU.

The same numpy inputs, made from seeds, go to interpolators built in both
packages (the port's with ``device="cpu"``, where its kernels' plain
versions run).  The JAX side runs on the CPU in x64, as conftest sets it, so
every dtype is passed explicitly.  These are the twins of
``tests/test_interp2d.py``, plus value, mask, autograd and interop parity.

Tolerances, scaled by the largest |value|: float32 ``rtol=2e-5, atol=1e-6``,
float64 1e-12 (``tests/test_torch_interp1d.py``); the reference's own
tables as the JAX tests hold them.  Errors are compared by class and
message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp2d as j2
import ndarray_interp_tpu_torch.interp2d as t2
from ndarray_interp_tpu.errors import OutOfBoundsError as JOOB
from ndarray_interp_tpu_torch import errors as terr
from ndarray_interp_tpu_torch.interop import interp2d_from_numpy
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


TOL = {np.float32: dict(rtol=2e-5, atol=1e-6), np.float64: dict(rtol=1e-12, atol=1e-12)}


def build(pkg, data, x=None, y=None, strategy=None):
    """The same interpolator in either package; ``strategy`` is a function
    of the package's ``interp2d`` module."""
    m = j2 if pkg == "jax" else t2
    if pkg == "jax":
        b = m.Interp2D.builder(jnp.asarray(data))
        arr = jnp.asarray
    else:
        b = m.Interp2D.builder(data, device="cpu")
        arr = np.asarray
    if x is not None:
        b = b.x(arr(x))
    if y is not None:
        b = b.y(arr(y))
    if strategy is not None:
        b = b.strategy(strategy(m))
    return b.build()


def both(data, x=None, y=None, strategy=None):
    return (build("jax", data, x, y, strategy), build("torch", data, x, y, strategy))


def assert_scaled_close(got, want, dtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max(np.abs(want[fin]).max(), 1.0) if fin.any() else 1.0
    tol = TOL[dtype]
    np.testing.assert_allclose(got[fin] / scale, want[fin] / scale, **tol)


def grid(nx=20, ny=16, trailing=(), seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.0, nx))
    y = np.cumsum(rng.uniform(0.2, 1.0, ny))
    z = rng.normal(size=(nx, ny) + trailing)
    return x.astype(dtype), y.astype(dtype), z.astype(dtype), rng


def raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


def same_error(jax_fn, torch_fn):
    j, t = raised(jax_fn), raised(torch_fn)
    assert type(t).__name__ == type(j).__name__
    assert str(t) == str(j)


# -- values, masks and shapes -----------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("trailing", [(), (3,), (2, 3)])
def test_bilinear_values_match_jax(dtype, extrapolate, trailing):
    x, y, z, rng = grid(trailing=trailing, dtype=dtype)
    j, t = both(z, x, y, lambda m: m.Bilinear().extrapolate(extrapolate))
    assert type(t.strategy).__name__ == type(j.strategy).__name__ == "BilinearPacked"
    qx = rng.uniform(x[0] - 1, x[-1] + 1, (6, 50)).astype(dtype)
    qy = rng.uniform(y[0] - 1, y[-1] + 1, (6, 50)).astype(dtype)
    got = t(qx, qy)
    assert tuple(got.shape) == (6, 50) + trailing and got.dtype == t.data.dtype
    assert_scaled_close(got, j(jnp.asarray(qx), jnp.asarray(qy)), dtype)
    assert_scaled_close(t.eval_unchecked(qx, qy), j.eval_unchecked(jnp.asarray(qx),
                                                                   jnp.asarray(qy)), dtype)
    if extrapolate:
        assert_scaled_close(t.interp_array(qx, qy), j.interp_array(qx, qy), dtype)
    else:  # the NaN mask is set where a query leaves its axis's range
        out = (qx < x[0]) | (qx > x[-1]) | (qy < y[0]) | (qy > y[-1])
        mask = np.isnan(got.numpy().reshape(out.shape + (-1,))).all(axis=-1)
        np.testing.assert_array_equal(mask, out)


def test_unpacked_bilinear_matches_packed(monkeypatch):
    """The search route (``Bilinear.eval``: K3 on each axis and the four
    corners gathered, which integer data takes, and the JAX package above
    its 64 Mi-element cap) gives the grid route's values bit for bit.  The
    port's builder has no cap: with the JAX cap at 10 elements JAX takes the
    search route and the port the grid route, within the JAX tolerance (the
    route divergence of ROADMAP Queue 3)."""
    from ndarray_interp_tpu.models.strategies import bilinear as j_bilinear
    from ndarray_interp_tpu_torch.models.strategies import bilinear

    x, y, z, rng = grid(trailing=(3,))
    packed = build("torch", z, x, y)
    assert type(packed.strategy).__name__ == "BilinearPacked"
    assert not hasattr(bilinear, "_PACK_MAX_ELEMS")
    plain = t2.Interp2D.new_unchecked(packed.x, packed.y, packed.data, bilinear.Bilinear())
    qx, qy = rng.uniform(x[0], x[-1], 200), rng.uniform(y[0], y[-1], 200)
    assert torch.equal(plain(qx, qy), packed(qx, qy))
    monkeypatch.setattr(j_bilinear, "_PACK_MAX_ELEMS", 10)
    j = build("jax", z, x, y)
    assert type(j.strategy).__name__ == "Bilinear"
    assert_scaled_close(packed(qx, qy), j(jnp.asarray(qx), jnp.asarray(qy)), np.float64)


def test_pack_corner_rows_matches_jax():
    from ndarray_interp_tpu.models.strategies.bilinear import pack_corner_rows as jpack
    from ndarray_interp_tpu_torch.models.strategies.bilinear import pack_corner_rows as tpack

    x, y, z, _ = grid(nx=7, ny=5, trailing=(2, 3))
    want = np.asarray(jpack(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    got = tpack(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z)).numpy()
    np.testing.assert_array_equal(got, want)


# -- the reference's tests (tests/test_interp2d.py twins) -------------------------------------
def data_i64():
    return np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]])


def data_f64():
    return data_i64().astype(np.float64)


@BOTH_ROUTES
def test_crate_doctest_2d():
    data = np.array([[1.0, 2.0, 2.5], [3.0, 4.0, 3.5]])
    j, t = both(data)
    assert float(t.interp_scalar(0.0, 0.5)) == 1.5 == float(j.interp_scalar(0.0, 0.5))
    got = t.interp_array(np.array([0.0, 1.0]), np.array([0.5, 2.0]))
    np.testing.assert_array_equal(np.asarray(got), [1.5, 3.5])


@BOTH_ROUTES
def test_crate_doctest_2d_multidim():
    data = np.array([
        [[1.0, -1.0], [2.0, -2.0], [3.0, -3.0]],
        [[4.0, -4.0], [5.0, -5.0], [6.0, -6.0]],
        [[7.0, -7.0], [8.0, -8.0], [9.0, -9.0]],
        [[7.5, -7.5], [8.5, -8.5], [9.5, -9.5]],
    ])
    t = build("torch", data, [1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(np.asarray(t.interp(1.5, 2.0)), [3.5, -3.5])
    np.testing.assert_array_equal(
        np.asarray(t.interp_array(np.array([1.5, 1.5]), np.array([2.0, 2.5]))),
        [[3.5, -3.5], [4.0, -4.0]],
    )


@pytest.mark.parametrize("axes", ["none", "x", "y"])
@BOTH_ROUTES
def test_corners_only(axes):
    """tests/interp2d.rs:26-60: integer data with the default axes or a
    custom x, float data with a custom y; the corners come back exactly."""
    if axes == "y":
        t = build("torch", data_f64(), y=[-3.0, -2.0, -1.0, 0.0])
        pts = [((0.0, -3.0), 1.0), ((2.0, 0.0), 12.0), ((2.0, -3.0), 9.0), ((0.0, 0.0), 4.0)]
    else:
        x0 = 1 if axes == "x" else 0
        t = build("torch", data_i64(), x=None if axes == "none" else [1, 2, 3])
        pts = [((x0, 0), 1), ((x0 + 2, 3), 12), ((x0 + 2, 0), 9), ((x0, 3), 4)]
    for (qx, qy), want in pts:
        got = t.interp_scalar(qx, qy)
        assert np.ndim(got) == 0 and float(got) == want


def test_integer_bilinear_matches_jax():
    """C-style truncating division in the lerp, as the reference's integer
    path (``tests/interp2d.rs``)."""
    j, t = both(data_i64() * 7)
    qx, qy = np.array([0, 1, 2, 1]), np.array([3, 1, 2, 0])
    got = t.interp_array(qx, qy)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.interp_array(qx, qy)))


@pytest.mark.parametrize("q", [(-1, 1), (1, -1), (3, 1), (1, 4), (-1, 4)])
def test_extrapolate_errors(q):
    j, t = both(data_i64())
    same_error(lambda: j.interp(*q), lambda: t.interp(*q))


@BOTH_ROUTES
def test_interpolate_array_meshgrid():
    """tests/interp2d.rs:84-238: a plane, where bilinear is exact."""
    data = np.linspace(0.0, 8.0, 9).reshape(3, 3)
    t = build("torch", data, [1.0, 2.0, 3.0], [4.0, 5.0, 6.0])
    n = 11
    qx = np.repeat(np.linspace(1.0, 3.0, n), n).reshape(n, n)
    qy = np.tile(np.linspace(4.0, 6.0, n), n).reshape(n, n)
    res = np.asarray(t.interp_array(qx, qy))
    np.testing.assert_allclose(res, 3.0 * (qx - 1.0) + (qy - 4.0), atol=4.5e-15)
    assert abs(res[0, 0]) < 1e-15 and abs(res[10, 10] - 8.0) < 1e-14


@BOTH_ROUTES
def test_interp_nd_data():
    data = np.array([
        [[[1.0, 10.0], [-1.0, -10.0]], [[2.0, 20.0], [-2.0, -20.0]]],
        [[[3.0, 30.0], [-3.0, -30.0]], [[5.0, 50.0], [-5.0, -50.0]]],
    ])
    t = t2.Interp2DBuilder(data, device="cpu").build()
    np.testing.assert_allclose(np.asarray(t.interp(0.0, 0.5)), [[1.5, 15.0], [-1.5, -15.0]],
                               atol=1e-15)
    expect = [[[1.5, 15.0], [-1.5, -15.0]], [[3.5, 35.0], [-3.5, -35.0]]]
    got = t.interp_array(np.array([0.0, 0.5]), np.array([0.5, 1.0]))
    np.testing.assert_allclose(np.asarray(got), expect, atol=1e-15)


def test_interp_array_with_unmatched_axis():
    j, t = both(np.linspace(0.0, 8.0, 9).reshape(3, 3))
    xs, ys = np.array([0.0, 1.0]), np.array([0.0, 1.0, 2.0])
    same_error(lambda: j.interp_array(jnp.asarray(xs), jnp.asarray(ys)),
               lambda: t.interp_array(xs, ys))
    for fn in (t, t.eval_unchecked):
        with pytest.raises(ValueError, match="do not match"):
            fn(xs, ys)


@pytest.mark.parametrize("case", [
    "1x1", "1x2", "2x1", "x short", "x long", "y short", "y long", "x flat", "y flat",
    "1-d data", "bicubic 2 rows",
])
def test_builder_errors_match_jax(case):
    """tests/interp2d.rs:279-329, by class and message."""
    sq = np.array([[1, 2], [3, 4]])
    data, x, y, strategy = {
        "1x1": (np.array([[1]]), None, None, None),
        "1x2": (np.array([[1, 2]]), None, None, None),
        "2x1": (np.array([[1], [2]]), None, None, None),
        "x short": (sq, [1], None, None),
        "x long": (sq, [1, 2, 3], None, None),
        "y short": (sq, None, [1], None),
        "y long": (sq, None, [1, 2, 3], None),
        "x flat": (sq, [2, 2], None, None),
        "y flat": (sq, None, [2, 2], None),
        "1-d data": (np.array([1.0, 2.0, 3.0]), None, None, None),
        "bicubic 2 rows": (np.zeros((2, 5)), None, None, lambda m: m.Bicubic()),
    }[case]
    same_error(lambda: build("jax", data, x, y, strategy),
               lambda: build("torch", data, x, y, strategy))


def test_nan_queries_raise_like_jax():
    """Extrapolating: NaN refuses to index (ValueError); not extrapolating:
    NaN is out of range."""
    x, y, z, _ = grid(nx=6, ny=5)
    for extrapolate in (False, True):
        j, t = both(z, x, y, lambda m: m.Bilinear().extrapolate(extrapolate))
        for qx, qy in (([x[1], np.nan], [y[1], y[2]]), ([x[1], x[2]], [np.nan, y[2]])):
            same_error(lambda: j.interp_array(jnp.asarray(qx), jnp.asarray(qy)),
                       lambda: t.interp_array(np.asarray(qx), np.asarray(qy)))


def test_x_is_checked_before_y():
    j, t = both(data_f64())
    same_error(lambda: j.interp_array(jnp.asarray([5.0]), jnp.asarray([-7.0])),
               lambda: t.interp_array(np.asarray([5.0]), np.asarray([-7.0])))
    with pytest.raises(terr.OutOfBoundsError, match="x = 5.0"):
        t.interp_array(np.asarray([5.0]), np.asarray([-7.0]))


def rand_arr(shape, seed=64):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=shape)


@pytest.mark.parametrize("ndim", [2, 3, 4, 5, 6, 7, 8])
@BOTH_ROUTES
def test_dim_sweep(ndim):
    """src/interp2d/mod.rs:541-576, against the JAX values."""
    j, t = both(rand_arr((4,) * ndim))
    res = np.asarray(t.interp(2.2, 2.2))
    assert res.ndim == ndim - 2
    np.testing.assert_allclose(res, np.asarray(j.interp(2.2, 2.2)), atol=1e-15)
    buf = np.zeros(tuple(res.shape))
    t.interp_into(2.2, 2.2, buf)
    np.testing.assert_allclose(buf, res, atol=2.3e-16)
    xq = np.array([[0.5, 1.0], [1.5, 2.0]])
    yq = np.array([[1.5, 2.0], [2.5, 3.0]])
    res = np.asarray(t.interp_array(xq, yq))
    assert res.ndim == ndim - 2 + xq.ndim
    np.testing.assert_allclose(res, np.asarray(j.interp_array(xq, yq)), atol=1e-15)
    buf = torch.zeros(tuple(res.shape), dtype=torch.float64)
    assert t.interp_array_into(xq, yq, buf) is buf
    np.testing.assert_allclose(buf.numpy(), res, atol=2.3e-16)


@BOTH_ROUTES
def test_interp2d_2d_scalar_type(native_host):
    t = build("torch", rand_arr((4, 4)))
    out = t.interp_scalar(2.2, 2.2)
    if native_host:  # float64 data on the native runtime: a float, as in JAX
        assert isinstance(out, float)
    else:
        assert isinstance(out, torch.Tensor) and out.shape == ()
    with pytest.raises(terr.ShapeError, match="interp_scalar requires 2-D data"):
        build("torch", rand_arr((4, 4, 2))).interp_scalar(1.0, 1.0)


def test_into_buffers_check_shape_first():
    """A wrong buffer raises with the JAX message and is left untouched; the
    query shapes are checked after the buffer's."""
    j, t = both(rand_arr((4, 4, 3)))
    xq, yq = np.array([0.5, 1.0]), np.array([1.5, 2.0])
    for make in (np.zeros, torch.zeros):
        bad = make((2, 4))
        same_error(lambda: j.interp_array_into(xq, yq, np.zeros((2, 4))),
                   lambda: t.interp_array_into(xq, yq, bad))
        assert not bad.any()
        same_error(lambda: j.interp_into(1.0, 1.0, np.zeros((4,))),
                   lambda: t.interp_into(1.0, 1.0, make((4,))))
    with pytest.raises(ValueError, match="do not match"):
        t.interp_array_into(xq, np.array([1.0, 2.0, 3.0]), np.zeros((2, 3)))
    bad = np.zeros((2, 3))
    with pytest.raises(terr.OutOfBoundsError):
        t.interp_array_into(np.array([0.5, 9.0]), yq, bad)
    assert not bad.any()


# -- helpers, construction and interop ---------------------------------------------------
def test_strategy_helpers_match_jax():
    x, y, z, rng = grid(nx=9, ny=7, trailing=(2,))
    j, t = both(z, x, y)
    for a, b in zip(t.index_point(3, 4), j.index_point(3, 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    qx = np.r_[rng.uniform(x[0] - 1, x[-1] + 1, 40), x[0], x[-1]]
    qy = np.r_[rng.uniform(y[0] - 1, y[-1] + 1, 40), y[0], y[-1]]
    for a, b in zip(t.get_index_left_of(qx, qy), j.get_index_left_of(jnp.asarray(qx),
                                                                     jnp.asarray(qy))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t.is_in_x_range(qx).numpy(), np.asarray(j.is_in_x_range(qx)))
    np.testing.assert_array_equal(t.is_in_y_range(qy).numpy(), np.asarray(j.is_in_y_range(qy)))
    assert t.get_buffer_shape((5, 6)) == j.get_buffer_shape((5, 6)) == (5, 6, 2)


def test_new_unchecked_keeps_the_state():
    x, y, z, rng = grid(trailing=(2,))
    t = build("torch", z, x, y)
    again = t2.Interp2D.new_unchecked(t.x, t.y, t.data, t.strategy)
    qx, qy = rng.uniform(x[0], x[-1], 30), rng.uniform(y[0], y[-1], 30)
    assert torch.equal(again(qx, qy), t(qx, qy))


def test_default_axes_and_dtype_promotion_match_jax():
    data = np.arange(12, dtype=np.int32).reshape(3, 4)
    j, t = both(data, x=np.array([0.0, 0.5, 1.0], np.float32))
    assert str(t.data.dtype).removeprefix("torch.") == str(j.data.dtype) == "float32"
    assert t.y.tolist() == np.asarray(j.y).tolist() == [0.0, 1.0, 2.0, 3.0]


def test_numpy_input_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t2.Interp2D.builder(np.ones((3, 3)))
    t = t2.Interp2D.builder(torch.ones((3, 3))).build()  # tensors keep their device
    assert t.data.device.type == "cpu"


@pytest.mark.parametrize("kind", ["bilinear", "bilinear packed", "bicubic cell", "bicubic node"])
def test_interop_carries_jax_state(kind, monkeypatch):
    """``interp2d_from_numpy`` turns the numpy state of a JAX ``Interp2D``
    into the port's, which then evaluates the same function."""
    from ndarray_interp_tpu import config

    if kind == "bicubic node":
        monkeypatch.setattr(config, "bicubic_pack_max_elems", 10)
    x, y, z, rng = grid(trailing=(3,), seed=4)
    bicubic = kind.startswith("bicubic")
    j = build("jax", z, x, y, (lambda m: m.Bicubic().boundary("natural", "clamped")
                               .extrapolate(True)) if bicubic else None)
    s = j.strategy
    state = dict(extrapolate=s.extrapolates)
    if bicubic:
        state.update(rows=np.asarray(s.rows), layout=s.layout, bc_x=s.bc_x, bc_y=s.bc_y)
    elif kind == "bilinear packed":
        state.update(rows=np.asarray(s.rows))
    t = interp2d_from_numpy(np.asarray(j.x), np.asarray(j.y), np.asarray(j.data),
                            device="cpu", **state)
    want_kind = "Bilinear" if kind == "bilinear" else type(s).__name__  # no rows: unpacked
    assert type(t.strategy).__name__ == want_kind
    assert getattr(t.strategy, "layout", None) == getattr(s, "layout", None)
    qx = rng.uniform(x[0] - 0.5, x[-1] + 0.5, 200)
    qy = rng.uniform(y[0] - 0.5, y[-1] + 0.5, 200)
    assert_scaled_close(t(qx, qy), j(jnp.asarray(qx), jnp.asarray(qy)), np.float64)
    with pytest.raises(ValueError, match="strategy must be"):
        interp2d_from_numpy(x, y, z, strategy="lanczos", device="cpu")


# -- autograd -------------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("strategy", ["bilinear", "bicubic"])
def test_query_gradients_match_jax(dtype, strategy):
    """test_bicubic.py:107-119 and test_interp2d.py:213-233: the gradient of
    ``sum(itp(xs, ys)**2)`` with respect to both query arrays."""
    x, y, z, rng = grid(trailing=(3,), dtype=dtype, seed=9)

    def strat(m):
        return (m.Bicubic() if strategy == "bicubic" else m.Bilinear()).extrapolate(True)

    j, t = both(z, x, y, strat)
    qx = rng.uniform(x[0], x[-1], 64).astype(dtype)
    qy = rng.uniform(y[0], y[-1], 64).astype(dtype)
    if strategy == "bilinear" and dtype == np.float32:
        # the JAX float32 bilinear search runs through a custom_partitioning
        # wrapper that has no differentiation rule; its float64 form, on the
        # same float32-rounded inputs, is the reference
        j = build("jax", z.astype(np.float64), x.astype(np.float64), y.astype(np.float64), strat)
        qx, qy = qx.astype(np.float64), qy.astype(np.float64)
    want = jax.grad(lambda a, b: jnp.sum(j(a, b) ** 2), argnums=(0, 1))(
        jnp.asarray(qx), jnp.asarray(qy))
    qx, qy = qx.astype(dtype), qy.astype(dtype)
    tx = torch.tensor(qx, requires_grad=True)
    ty = torch.tensor(qy, requires_grad=True)
    (t(tx, ty) ** 2).sum().backward()
    for got, w in zip((tx.grad, ty.grad), want):
        assert np.isfinite(got.numpy()).all()
        assert_scaled_close(got, w, dtype)


def test_cpu_tensors_launch_no_kernel():
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    x, y, z, rng = grid(trailing=(2,))
    for strategy in (lambda m: m.Bilinear(), lambda m: m.Bicubic()):
        t = build("torch", z, x, y, strategy)
        t.interp_array(rng.uniform(x[0], x[-1], 20), rng.uniform(y[0], y[-1], 20))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


def test_out_of_bounds_message_matches_jax():
    x, y, z, _ = grid(nx=6, ny=5)
    j, t = both(z.astype(np.float32), x.astype(np.float32), y.astype(np.float32))
    q = (np.array([x[1], x[-1] + 2.5], np.float32), np.array([y[1], y[2]], np.float32))
    same_error(lambda: j.interp_array(*q), lambda: t.interp_array(*q))
    err = raised(lambda: t.interp_array(*q))
    assert isinstance(err, terr.OutOfBoundsError) and type(raised(lambda: j.interp_array(*q))) is JOOB


@pytest.mark.parametrize("strategy", ["Bilinear", "Bicubic"])
def test_jit_vmap_2d(strategy):
    """test_jit_vmap_2d: a second call equals ``interp_array``, and
    ``torch.func.vmap`` over query rows equals it bit for bit (R1 and the
    tail run once on the flattened rows) and JAX's ``vmap`` at its
    tolerance; ``vmap(grad)`` gives the query gradients."""
    data = np.random.default_rng(64).uniform(0.0, 1.0, size=(8, 8, 3))
    j, t = both(data, strategy=lambda m: getattr(m, strategy)().extrapolate(True))
    qx, qy = np.linspace(0.0, 7.0, 32), np.linspace(7.0, 0.0, 32)
    tx, ty = torch.as_tensor(qx), torch.as_tensor(qy)
    want = t.interp_array(tx, ty)
    assert torch.equal(t(tx, ty), want) and torch.equal(t(tx, ty), want)
    got = torch.func.vmap(t)(tx.reshape(4, 8), ty.reshape(4, 8))
    assert torch.equal(got, want.reshape(4, 8, 3))
    jv = jax.vmap(lambda a, b: j(a, b))(jnp.asarray(qx).reshape(4, 8), jnp.asarray(qy).reshape(4, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(jv), atol=1e-15)
    gx = torch.func.vmap(torch.func.grad(lambda a, b: t(a, b).sum()))(tx, ty)
    ax = tx.clone().requires_grad_(True)
    (want_gx,) = torch.autograd.grad(t(ax, ty).sum(), ax)
    assert torch.equal(gx, want_gx)
