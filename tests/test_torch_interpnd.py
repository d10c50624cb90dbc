"""The port's ``InterpND`` (``models/interpnd.py``) and ``EvaluatorND``
against the JAX package's, on the CPU.

The twin of ``tests/test_interpnd.py`` without the parts that do not apply
(mesh sharding, jit/vmap/pytree); its checkpoint cases are twinned in
``tests/test_torch_aux.py``, with the checkpoint module.  The same numpy
inputs, made from seeds, go through both packages (JAX on the CPU in x64)
and SciPy.

Tolerances: float64 against SciPy and against the JAX values within 1e-12
of the value scale (``test_interpnd.py:58`` holds 1e-12 absolute on values
of order 1; its cubic k = 3 oracle 1e-11); float32 within 1e-5 of the
scale, the port's float32 gate (``chip_smoke.py``), as the JAX tests run in
x64 only.  Tables packed from the same state are compared bit for bit; the
node layouts, which blend in one order, bit for bit with each other.
Errors by class and message.
"""

import itertools

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.models.interpnd as jm
import ndarray_interp_tpu.serving as js
import ndarray_interp_tpu_torch.models.interpnd as tm
import ndarray_interp_tpu_torch.serving as ts
from ndarray_interp_tpu import config
from ndarray_interp_tpu.interpnd import InterpND as JND
from ndarray_interp_tpu_torch import config as tconfig
from ndarray_interp_tpu_torch.errors import OutOfBoundsError
from ndarray_interp_tpu_torch.interop import interpnd_from_numpy
from ndarray_interp_tpu_torch.interpnd import InterpND, InterpNDBuilder
from ndarray_interp_tpu_torch.ops import kernel_wrappers


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


def grid_case(k, trailing=(), seed=0, sizes=None):
    rng = np.random.default_rng(seed)
    sizes = sizes or [5, 4, 6, 3, 4][:k]
    axes = [np.sort(rng.uniform(-4.0, 4.0, n)) for n in sizes]
    return axes, rng.normal(size=tuple(sizes) + tuple(trailing)), rng


def queries(axes, rng, n=64, shape=None, pad=0.0):
    qs = [rng.uniform(ax[0] - pad, ax[-1] + pad, n) for ax in axes]
    return qs if shape is None else [q.reshape(shape) for q in qs]


def both(data, axes, method="linear", extrapolate=False, bcs=None, layout=None, dtype=None):
    """A JAX and a port interpolator built from the same numpy inputs."""
    if dtype is not None:
        data, axes = data.astype(dtype), [a.astype(dtype) for a in axes]

    def configure(b):
        b = b.points(*axes).method(method).extrapolate(extrapolate)
        if bcs is not None:
            b = b.boundary(*bcs)
        return b if layout is None else b.layout(layout)

    return (configure(JND.builder(data)).build(),
            configure(InterpND.builder(data, device="cpu")).build())


def scaled(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.abs(want).max(), 1e-300))


def bits(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v.view(np.int64 if v.dtype == np.float64 else np.int32)


def raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return info.value


def same_error(j_fn, t_fn):
    je, te = raised(j_fn), raised(t_fn)
    assert type(te).__name__ == type(je).__name__
    assert str(te) == str(je)


# -- SciPy oracle -------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_scipy_oracle(k, method):
    axes, data, rng = grid_case(k, seed=k)
    j, t = both(data, axes, method)
    qs = queries(axes, rng)
    got = t.interp_array(*qs)
    assert got.dtype == torch.float64
    want = si.RegularGridInterpolator(axes, data, method=method)(np.stack(qs, axis=-1))
    assert scaled(got, want) <= 1e-12
    assert scaled(got, j.interp_array(*qs)) <= 1e-12


@pytest.mark.parametrize("k", [2, 3])
def test_scipy_oracle_trailing_dims(k):
    axes, data, rng = grid_case(k, trailing=(3, 2), seed=10 + k)
    _, t = both(data, axes)
    qs = queries(axes, rng, n=40)
    got = t.interp_array(*qs)
    assert tuple(got.shape) == (40, 3, 2)
    assert scaled(got, si.RegularGridInterpolator(axes, data)(np.stack(qs, axis=-1))) <= 1e-12


@BOTH_ROUTES
def test_matches_interp2d_bilinear():
    from ndarray_interp_tpu_torch.interp2d import Interp2D

    axes, data, rng = grid_case(2, trailing=(3,), seed=3)
    _, nd = both(data, axes)
    i2 = Interp2D.builder(data, device="cpu").x(axes[0]).y(axes[1]).build()
    xs, ys = queries(axes, rng, n=32)
    np.testing.assert_allclose(nd.interp_array(xs, ys).numpy(), np.asarray(i2.interp_array(xs, ys)),
                               rtol=0, atol=1e-13)


def test_grid_nodes_exact():
    axes, data, _ = grid_case(3, seed=5)
    _, t = both(data, axes)
    mesh = np.meshgrid(*axes, indexing="ij")
    np.testing.assert_allclose(t.interp_array(*(m.ravel() for m in mesh)).numpy(), data.ravel(),
                               rtol=0, atol=1e-13)


# -- call conventions --------------------------------------------------------------
def test_output_shape_m_plus_n_minus_k():
    axes, data, rng = grid_case(3, trailing=(2,), seed=7)
    j, t = both(data, axes)
    qs = queries(axes, rng, n=24, shape=(2, 3, 4))
    out = t.interp_array(*qs)
    assert tuple(out.shape) == (2, 3, 4, 2)
    assert scaled(out, j.interp_array(*qs)) <= 1e-12
    assert t.get_buffer_shape((2, 3, 4)) == j.get_buffer_shape((2, 3, 4)) == (2, 3, 4, 2)
    pt = [float(0.5 * (a[0] + a[-1])) for a in axes]
    assert tuple(t.interp(*pt).shape) == (2,)
    assert tuple(t(*pt).shape) == (2,)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_interp_array_into(as_tensor):
    axes, data, rng = grid_case(2, trailing=(2,), seed=71)
    j, t = both(data, axes)
    qs = queries(axes, rng, n=12, shape=(3, 4))
    new = (lambda s, v=0.0: torch.full(s, v, dtype=torch.float64)) if as_tensor else (
        lambda s, v=0.0: np.full(s, v))
    buf = new((3, 4, 2))
    assert t.interp_array_into(*qs, buffer=buf) is buf
    np.testing.assert_array_equal(np.asarray(buf), t.interp_array(*qs).numpy())
    same_error(lambda: j.interp_array_into(*qs, buffer=np.zeros((3, 4))),
               lambda: t.interp_array_into(*qs, buffer=new((3, 4))))
    bad = [q.copy() for q in qs]
    bad[0].flat[0] = axes[0][-1] + 5.0
    buf2 = new((3, 4, 2), -1.0)
    with pytest.raises(OutOfBoundsError):
        t.interp_array_into(*bad, buffer=buf2)
    assert np.all(np.asarray(buf2) == -1.0)  # untouched on an out-of-range query


def test_default_axes_are_indices():
    data = np.arange(24.0).reshape(2, 3, 4)
    t = InterpND.builder(data, device="cpu").build()
    assert t.k == 3
    want = si.RegularGridInterpolator([np.arange(2.0), np.arange(3.0), np.arange(4.0)],
                                      data)([0.5, 1.0, 2.5])[0]
    assert float(t.interp(0.5, 1.0, 2.5)) == pytest.approx(want, abs=1e-14)


@pytest.mark.parametrize("case", ["shapes", "arity", "oob axis 1", "oob axis 0", "nan"])
def test_query_errors_match_jax(case):
    axes, data, _ = grid_case(2)
    j, t = both(data, axes)
    call = {
        "shapes": lambda i: i.interp_array(np.zeros(3), np.zeros(4)),
        "arity": lambda i: i.interp_array(np.zeros(3)),
        "oob axis 1": lambda i: i.interp(axes[0][0], axes[1][-1] + 1.0),
        "oob axis 0": lambda i: i.interp_array(np.array([axes[0][1], axes[0][0] - 0.5]),
                                               np.array([axes[1][1], axes[1][-1] + 2.0])),
        "nan": lambda i: i.interp(np.nan, axes[1][0]),
    }[case]
    same_error(lambda: call(j), lambda: call(t))


def test_out_of_bounds_masks_to_nan_in_pure_path():
    axes, data, _ = grid_case(2)
    j, t = both(data, axes)
    qx = np.array([axes[0][0], axes[0][0]])
    qy = np.array([axes[1][0], axes[1][-1] + 1.0])
    out = t(qx, qy).numpy()
    assert np.isfinite(out[0]) and np.isnan(out[1])
    np.testing.assert_allclose(out, np.asarray(j(qx, qy)), rtol=0, atol=1e-13)
    assert np.isfinite(t.eval_unchecked(qx, qy).numpy()).all()


def test_extrapolate_extends_edge_cells():
    ax = [np.array([0.0, 1.0, 2.0]), np.array([0.0, 1.0])]
    x, y = np.meshgrid(*ax, indexing="ij")
    data = 2.0 * x + 3.0 * y + 1.0
    _, t = both(data, ax, extrapolate=True)
    assert float(t.interp(3.5, -1.0)) == pytest.approx(2 * 3.5 - 3.0 + 1.0, abs=1e-13)
    _, near = both(data, ax, "nearest", extrapolate=True)
    assert float(near.interp(9.0, 9.0)) == data[-1, -1]


def test_nearest_ties_go_to_the_lower_node():
    ax = [np.array([0.0, 1.0, 3.0])]
    data = np.array([10.0, 20.0, 30.0])
    j, t = both(data, ax, "nearest")
    q = np.array([0.5, 0.5000001, 2.0, 2.1])
    np.testing.assert_array_equal(t.interp_array(q).numpy(), [10.0, 20.0, 20.0, 30.0])
    np.testing.assert_array_equal(t.interp_array(q).numpy(), np.asarray(j.interp_array(q)))


# -- builder ----------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    "not enough data", "axis length", "not monotonic", "2-d axis", "too few dims",
    "no axes", "bad method", "boundary not cubic", "bad boundary", "boundary count",
    "cubic not enough data", "periodic ends", "bad layout", "layout pairs too many",
])
def test_builder_errors_match_jax(case):
    axes, data, _ = grid_case(2)
    rng = np.random.default_rng(60)
    cub = [np.sort(rng.uniform(0, 1, 5)) for _ in range(2)]
    d5 = rng.normal(size=(5, 5))

    def make(pkg):
        b = (lambda v: JND.builder(v)) if pkg == "jax" else (
            lambda v: InterpND.builder(v, device="cpu"))
        return {
            "not enough data": lambda: b(np.zeros((1, 4))).points(np.zeros(1), axes[1]).build(),
            "axis length": lambda: b(data).points(np.arange(3.0), axes[1]).build(),
            "not monotonic": lambda: b(data).points(axes[0], axes[1][::-1].copy()).build(),
            "2-d axis": lambda: b(data).points(axes[0].reshape(-1, 1), axes[1]).build(),
            "too few dims": lambda: b(np.zeros(5)).points(np.arange(5.0), np.arange(3.0)).build(),
            "no axes": lambda: b(data).points().build(),
            "bad method": lambda: b(data).method("quintic"),
            "boundary not cubic": lambda: b(d5).points(*cub).boundary("natural").build(),
            "bad boundary": lambda: b(d5).method("cubic").boundary("nak"),
            "boundary count": lambda: b(d5).points(*cub).method("cubic").boundary(
                "natural", "natural", "natural").build(),
            "cubic not enough data": lambda: b(np.zeros((2, 5))).points(
                np.arange(2.0), cub[1]).method("cubic").build(),
            "periodic ends": lambda: b(d5).points(*cub).method("cubic").boundary(
                "periodic", "natural").build(),
            "bad layout": lambda: b(d5).method("cubic").layout("packed"),
            "layout pairs too many": lambda: b(d5).points(*cub).method("cubic").layout(
                "node4").build(),
        }[case]

    same_error(make("jax"), make("torch"))


def test_builder_type_and_chaining():
    axes, data, _ = grid_case(2)
    b = InterpND.builder(data, device="cpu")
    assert isinstance(b, InterpNDBuilder)
    itp = b.points(*axes).method("nearest").extrapolate().build()
    assert itp.method == "nearest" and itp.extrapolates
    assert repr(itp).startswith("InterpND(k=2")


def test_int_data_promotes_to_float():
    data = np.arange(12, dtype=np.int32).reshape(3, 4)
    j = JND.builder(data).build()
    t = InterpND.builder(data, device="cpu").build()
    assert t.data.dtype == torch.float32 and np.asarray(j.data).dtype == np.float32
    out = t.interp(0.5, 0.5)
    assert out.is_floating_point()
    assert float(out) == (0 + 1 + 4 + 5) / 4.0


def test_packed_route_matches_unpacked(monkeypatch):
    axes, data, rng = grid_case(3, trailing=(2,), seed=41)
    _, packed = both(data, axes)
    assert tuple(packed.table.shape) == (4 * 3 * 5, 8 * 2)
    monkeypatch.setattr(tconfig, "interpnd_pack_max_elems", 0)
    monkeypatch.setattr(config, "interpnd_pack_max_elems", 0)
    j, unpacked = both(data, axes)
    assert unpacked.table is None and j.table is None
    qs = queries(axes, rng, n=200)
    np.testing.assert_allclose(packed.interp_array(*qs).numpy(),
                               unpacked.interp_array(*qs).numpy(), rtol=0, atol=1e-13)
    assert scaled(unpacked.interp_array(*qs), j.interp_array(*qs)) <= 1e-12


def test_corner_table_matches_jax_bit_for_bit():
    axes, data, _ = grid_case(3, trailing=(2, 3), seed=42)
    j, t = both(data, axes)
    np.testing.assert_array_equal(bits(t.table), bits(j.table))


# -- method("cubic") -------------------------------------------------------------------
BC_SCIPY = {"not_a_knot": "not-a-knot", "natural": "natural", "clamped": "clamped",
            "periodic": "periodic"}


def seq_cubic_oracle(axes, data, pts, bcs):
    """The exact tensor-product spline by sequential 1-D SciPy solves
    (``test_interpnd.py:397``)."""
    out = []
    for pt in zip(*pts):
        g = data
        for d in reversed(range(len(axes))):
            g = si.CubicSpline(axes[d], g, axis=d, bc_type=BC_SCIPY[bcs[d]])(pt[d])
        out.append(g)
    return np.array(out)


@pytest.mark.parametrize("bc", ["not_a_knot", "natural", "clamped"])
def test_cubic_k1_matches_scipy(bc):
    rng = np.random.default_rng(51)
    x = np.sort(rng.uniform(0, 10, 9))
    y = rng.normal(size=9)
    _, t = both(y, [x], "cubic", bcs=(bc,))
    q = rng.uniform(x[0], x[-1], 100)
    assert scaled(t.interp_array(q), si.CubicSpline(x, y, bc_type=BC_SCIPY[bc])(q)) <= 1e-12


@BOTH_ROUTES
def test_cubic_k2_matches_bicubic():
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D

    rng = np.random.default_rng(52)
    axes = [np.sort(rng.uniform(0, 5, 8)), np.sort(rng.uniform(-2, 2, 7))]
    data = rng.normal(size=(8, 7, 3))
    _, nd = both(data, axes, "cubic")
    b2 = Interp2D.builder(data, device="cpu").x(axes[0]).y(axes[1]).strategy(Bicubic()).build()
    qx, qy = [rng.uniform(a[0], a[-1], 60) for a in axes]
    assert scaled(nd.interp_array(qx, qy), np.asarray(b2.interp_array(qx, qy))) <= 1e-12


@pytest.mark.parametrize("bcs", [("not_a_knot",) * 3, ("natural",) * 3,
                                 ("clamped", "not_a_knot", "natural")])
def test_cubic_k3_matches_tensor_product_oracle(bcs):
    rng = np.random.default_rng(53)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 7, 5)]
    data = rng.normal(size=(6, 7, 5))
    _, t = both(data, axes, "cubic", bcs=bcs)
    qs = [rng.uniform(a[0], a[-1], 40) for a in axes]
    np.testing.assert_allclose(t.interp_array(*qs).numpy(), seq_cubic_oracle(axes, data, qs, bcs),
                               rtol=0, atol=1e-11)


def test_cubic_k3_trailing_dims():
    rng = np.random.default_rng(54)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (5, 6, 7)]
    data = rng.normal(size=(5, 6, 7, 2))
    _, t = both(data, axes, "cubic")
    qs = [rng.uniform(a[0], a[-1], 25) for a in axes]
    got = t.interp_array(*qs)
    assert tuple(got.shape) == (25, 2)
    np.testing.assert_allclose(got.numpy(), seq_cubic_oracle(axes, data, qs, ("not_a_knot",) * 3),
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cubic_matches_jax(k, dtype):
    """f64 within 1e-12 of the JAX values (scaled), f32 within 1e-5."""
    rng = np.random.default_rng(90 + k)
    axes = [np.cumsum(rng.uniform(0.5, 1.5, n)) / n for n in (7, 6, 5)[:k]]
    data = rng.normal(size=tuple(a.size for a in axes) + (2,))
    j, t = both(data, axes, "cubic", extrapolate=True, dtype=dtype)
    qs = [rng.uniform(a[0] - 0.1, a[-1] + 0.1, 80).astype(dtype) for a in axes]
    got = t.interp_array(*qs)
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    want = np.asarray(j.interp_array(*qs))
    assert scaled(got.double(), want.astype(np.float64)) <= (1e-12 if dtype == np.float64 else 1e-5)


def test_cubic_periodic_axis_wraps():
    rng = np.random.default_rng(55)
    axes = [np.linspace(0, 2 * np.pi, 9), np.sort(rng.uniform(0, 1, 6))]
    data = rng.normal(size=(9, 6))
    data[-1] = data[0]
    bcs = ("periodic", "not_a_knot")
    j, t = both(data, axes, "cubic", bcs=bcs)
    qx, qy = rng.uniform(0, 2 * np.pi, 30), rng.uniform(axes[1][0], axes[1][-1], 30)
    base = t.interp_array(qx, qy).numpy()
    np.testing.assert_allclose(t.interp_array(qx + 2 * np.pi, qy).numpy(), base, rtol=0, atol=1e-10)
    np.testing.assert_allclose(base, seq_cubic_oracle(axes, data, [qx, qy], bcs), rtol=0,
                               atol=1e-11)
    assert scaled(t.interp_array(qx - 4 * np.pi, qy), j.interp_array(qx - 4 * np.pi, qy)) <= 1e-12
    t.interp(100.0, float(axes[1][2]))  # a periodic axis is never out of range
    assert np.isfinite(t(np.array([100.0]), np.array([axes[1][2]])).numpy()).all()


def test_cubic_extrapolates_edge_polynomial():
    rng = np.random.default_rng(57)
    x = np.sort(rng.uniform(0, 10, 8))
    y = rng.normal(size=8)
    _, t = both(y, [x], "cubic", extrapolate=True)
    q = np.array([x[0] - 1.5, x[-1] + 2.0])
    np.testing.assert_allclose(t.interp_array(q).numpy(), si.CubicSpline(x, y)(q), rtol=0,
                               atol=1e-10)


def test_cubic_node_layouts_bit_identical_and_match_cell():
    rng = np.random.default_rng(56)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 7)]
    data = rng.normal(size=(6, 5, 7, 2))
    _, cell = both(data, axes, "cubic")
    assert cell.layout == "cell"
    qs = queries(axes, rng, n=50, pad=0.1)
    outs = {}
    for lay, m in tm._NODE_PAIRS.items():
        _, t = both(data, axes, "cubic", extrapolate=True, layout=lay)
        assert t.layout == lay
        assert tuple(t.table.shape) == (6 * 5 * 7, (2**m) * 8 * 2 + 3 + m)
        outs[lay] = t.interp_array(*qs).numpy()
    np.testing.assert_array_equal(outs["node2"], outs["node"])
    np.testing.assert_array_equal(outs["node4"], outs["node"])
    _, cell_x = both(data, axes, "cubic", extrapolate=True)
    np.testing.assert_allclose(outs["node"], cell_x.interp_array(*qs).numpy(), rtol=0, atol=1e-11)


def test_cubic_tables_match_jax_on_the_same_state():
    """Packed from the JAX solves' node grids, the port's cell and node
    tables equal the JAX tables bit for bit; its own solves agree with
    JAX's within 1e-12 of the scale."""
    rng = np.random.default_rng(58)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 4)]
    data = rng.normal(size=(6, 5, 4, 2))
    bcs = ("natural", "not_a_knot", "clamped")
    jax_axes = tuple(jnp.asarray(a) for a in axes)
    jgrids = jm.interpnd_node_grids(jax_axes, jnp.asarray(data), 3, bcs)
    tgrids = {e: torch.tensor(np.asarray(g)) for e, g in jgrids.items()}
    t_axes = [torch.as_tensor(a) for a in axes]
    mine = tm.interpnd_node_grids(t_axes, torch.as_tensor(data), 3, bcs)
    for e in jgrids:
        assert scaled(mine[e], jgrids[e]) <= 1e-12
    np.testing.assert_array_equal(
        bits(tm.pack_cubic_rows_nd(t_axes, torch.as_tensor(data), 3, tgrids)),
        bits(jm.pack_cubic_rows_nd(jax_axes, jnp.asarray(data), 3, jgrids)))
    for m in (0, 1, 2):
        np.testing.assert_array_equal(
            bits(tm.pack_cubic_nodes_nd(t_axes, torch.as_tensor(data), 3, tgrids, pairs=m)),
            bits(jm.pack_cubic_nodes_nd(jax_axes, jnp.asarray(data), 3, jgrids, pairs=m)))


# -- layout cost model and dispatch ----------------------------------------------------
def test_route_cost_ns_matches_jax():
    for k, r, lay in itertools.product((1, 2, 3, 4), (1, 4, 16, 64), ("cell", "node", "node2",
                                                                       "node4")):
        if lay != "cell" and tm._NODE_PAIRS[lay] >= k:
            continue
        assert InterpND.route_cost_ns(k, (64,) * k, r, lay) == JND.route_cost_ns(
            k, (64,) * k, r, lay)
    assert InterpND.route_cost_ns(3, (64,) * 3, 1, "node") == 8 * 6.0


@pytest.mark.parametrize("cap", [None, 100, 3000, 30_000])
@pytest.mark.parametrize("k,trailing", [(2, ()), (3, ()), (3, (3,)), (4, ())])
def test_layout_dispatch_matches_jax(monkeypatch, cap, k, trailing):
    if cap is not None:
        monkeypatch.setattr(tconfig, "interpnd_pack_max_elems", cap)
        monkeypatch.setattr(config, "interpnd_pack_max_elems", cap)
    axes, data, _ = grid_case(k, trailing, seed=77, sizes=[9, 8, 7, 5][:k])
    j, t = both(data, axes, "cubic")
    assert t.layout == j.layout
    assert tuple(t.table.shape) == tuple(j.table.shape)


def test_forced_layout_matches_auto():
    axes, data, rng = grid_case(3, seed=77, sizes=[9, 8, 7])
    _, auto = both(data, axes, "cubic")
    _, node = both(data, axes, "cubic", layout="node")
    assert (auto.layout, node.layout) == ("cell", "node")
    qs = queries(axes, rng, n=200)
    np.testing.assert_allclose(node.interp_array(*qs).numpy(), auto.interp_array(*qs).numpy(),
                               rtol=1e-12, atol=1e-12)


# -- autograd ------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_grad_wrt_queries_matches_jax(method):
    rng = np.random.default_rng(62)
    axes = [np.sort(rng.uniform(0, 1, 6)) for _ in range(3)]
    data = rng.normal(size=(6, 6, 6))
    j, t = both(data, axes, method)
    lo, hi = max(a[0] for a in axes) + 0.01, min(a[-1] for a in axes) - 0.01
    pts = rng.uniform(lo, hi, (3, 5))
    jg = jax.grad(lambda a, b, c: j(a, b, c).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(p) for p in pts))
    leaves = [torch.as_tensor(p).requires_grad_(True) for p in pts]
    t(*leaves).sum().backward()
    for leaf, g in zip(leaves, jg):
        assert scaled(leaf.grad, g) <= 1e-10


# -- carried state ---------------------------------------------------------------------
@pytest.mark.parametrize("method,layout", [("linear", None), ("nearest", None), ("cubic", None),
                                           ("cubic", "node2")])
def test_interpnd_from_numpy_reproduces_jax_without_a_solve(monkeypatch, method, layout):
    axes, data, rng = grid_case(3, trailing=(2,), seed=81, sizes=[6, 5, 4])
    bcs = ("natural", "periodic", "not_a_knot") if method == "cubic" else None
    if bcs:
        data[:, -1] = data[:, 0]
    j = JND.builder(data).points(*axes).method(method).extrapolate(True)
    j = (j.boundary(*bcs) if bcs else j)
    j = (j.layout(layout) if layout else j).build()

    def no_solve(*a, **kw):
        raise AssertionError("interpnd_from_numpy ran a spline solve")

    monkeypatch.setattr(tm, "_solve_axis0", no_solve)
    t = interpnd_from_numpy([np.asarray(a) for a in j.axes], np.asarray(j.data), j.method,
                            j.extrapolates, None if j.table is None else np.asarray(j.table),
                            j.bcs, j.layout, device="cpu")
    assert (t.layout, t.bcs, t.k) == (j.layout, j.bcs, 3)
    qs = queries(axes, rng, n=100, pad=0.3)
    assert scaled(t(*qs), j(*qs)) <= 1e-12
    with pytest.raises(ValueError, match="method"):
        interpnd_from_numpy(axes, data, method="quintic", device="cpu")


# -- EvaluatorND ---------------------------------------------------------------------
def test_evaluator_nd_matches_direct_and_jax():
    axes, data, rng = grid_case(3, trailing=(2,), seed=95)
    j, t = both(data, axes)
    ev = ts.EvaluatorND(t, max_batch=2048).warmup()
    jev = js.EvaluatorND(j, max_batch=2048)
    assert ev.buckets == jev.buckets == (256, 512, 1024, 2048)
    for n in (1, 300, 2048, 5000):
        qs = queries(axes, rng, n=n, pad=0.5)
        got = ev(*qs)
        torch.testing.assert_close(got, t(*qs), rtol=0, atol=0, equal_nan=True)
        want = np.asarray(jev(*(jnp.asarray(q) for q in qs)))
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    qs = queries(axes, rng, n=24, shape=(4, 6))
    assert tuple(ev(*qs).shape) == (4, 6, 2)
    assert tuple(ev(np.zeros(0), np.zeros(0), np.zeros(0)).shape) == (0, 2)
    for bad in ((np.zeros(3), np.zeros(4), np.zeros(3)), (np.zeros(3), np.zeros(3))):
        same_error(lambda: jev(*(jnp.asarray(b) for b in bad)), lambda: ev(*bad))


def test_cpu_tensors_launch_no_kernel():
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    axes, data, rng = grid_case(3, seed=97)
    for method in ("linear", "nearest", "cubic"):
        _, t = both(data, axes, method)
        ts.EvaluatorND(t, max_batch=256)(*queries(axes, rng, n=40))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


# -- calculus: derivative --------------------------------------------------------------
# The twins of test_interpnd.py:615-821.  Each holds the port to the JAX test's
# oracle at its tolerance and to the JAX result on the same inputs: float64
# within 1e-12 of the value scale, float32 within 1e-5.  A mixed partial of
# order 3 on two or more axes cancels terms ~dx^-3 times larger than itself,
# where the packages' different summation orders part at ~2e-12: those are
# held at the JAX test's own 1e-10 of the scale.
def deriv_tol(orders):
    return 1e-10 if sum(o >= 3 for o in orders) >= 2 else 1e-12


def test_derivative_cubic_matches_bicubic():
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D

    rng = np.random.default_rng(61)
    axes = [np.sort(rng.uniform(0, 5, 8)), np.sort(rng.uniform(-2, 2, 7))]
    data = rng.normal(size=(8, 7))
    j, t = both(data, axes, "cubic")
    b2 = Interp2D.builder(data, device="cpu").x(axes[0]).y(axes[1]).strategy(Bicubic()).build()
    qx, qy = [rng.uniform(a[0], a[-1], 50) for a in axes]
    for dx, dy in [(1, 0), (0, 1), (1, 1), (2, 0), (2, 1), (3, 3)]:
        a = t.derivative(qx, qy, orders=(dx, dy))
        b = b2.derivative(qx, qy, dx=dx, dy=dy).numpy()
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10 * scale)
        assert scaled(a, j.derivative(qx, qy, orders=(dx, dy))) <= deriv_tol((dx, dy))


@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_derivative_matches_autograd(method):
    """test_derivative_matches_grad: ``torch.autograd`` of ``__call__``
    equals the order-1 derivative on each axis (rtol 1e-10)."""
    rng = np.random.default_rng(62)
    axes = [np.sort(rng.uniform(0, 1, 6)) for _ in range(3)]
    lo = max(a[0] for a in axes) + 0.01
    hi = min(a[-1] for a in axes) - 0.01
    data = rng.normal(size=(6, 6, 6))
    pt = rng.uniform(lo, hi, 3)
    j, t = both(data, axes, method)
    leaves = [torch.tensor([p], requires_grad=True) for p in pt]
    grads = torch.autograd.grad(t(*leaves).sum(), leaves)
    for g, o in zip(grads, [(1, 0, 0), (0, 1, 0), (0, 0, 1)]):
        di = t.derivative(*(np.array([p]) for p in pt), orders=o)
        np.testing.assert_allclose(float(g), float(di[0]), rtol=1e-10)
        assert scaled(di, j.derivative(*(np.array([p]) for p in pt), orders=o)) <= 1e-12


def test_derivative_keeps_autograd():
    """The derivative itself is differentiable in the queries: the gradient
    of the order-1 partial along an axis is the order-2 partial."""
    rng = np.random.default_rng(65)
    axes = [np.sort(rng.uniform(0, 1, 7)) for _ in range(2)]
    _, t = both(rng.normal(size=(7, 7)), axes, "cubic")
    q = [torch.as_tensor(rng.uniform(0.1, 0.9, 20)).requires_grad_() for _ in range(2)]
    (gx,) = torch.autograd.grad(t.derivative(*q, orders=(1, 0)).sum(), [q[0]])
    np.testing.assert_allclose(gx.numpy(), t.derivative(*q, orders=(2, 0)).detach().numpy(),
                               rtol=1e-10, atol=1e-12)


def test_derivative_linear_higher_orders_zero():
    rng = np.random.default_rng(63)
    axes, data, _ = grid_case(2, seed=63)
    j, t = both(data, axes)
    qs = queries(axes, rng, n=20)
    for orders in [(2, 0), (0, 3), (2, 2)]:
        got = t.derivative(*qs, orders=orders)
        np.testing.assert_array_equal(got.numpy(), 0.0)
        np.testing.assert_array_equal(np.asarray(j.derivative(*qs, orders=orders)), 0.0)


@pytest.mark.parametrize("layout", ["node", "node2", "node4"])
def test_derivative_node_layout_and_trailing(monkeypatch, layout):
    """The node layout from the cap (the JAX test's route) and forced, and
    the paired node layouts: each within 1e-10 of the scale of the cell
    layout's, and of JAX's on the same layout."""
    rng = np.random.default_rng(64)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 7)]
    data = rng.normal(size=(6, 5, 7, 2))
    jcell, cell = both(data, axes, "cubic")
    assert cell.layout == "cell"
    if layout == "node":
        monkeypatch.setattr(tconfig, "interpnd_pack_max_elems", 0)
        monkeypatch.setattr(config, "interpnd_pack_max_elems", 0)
        jnode, node = both(data, axes, "cubic")
    else:
        jnode, node = both(data, axes, "cubic", layout=layout)
    assert node.layout == jnode.layout == layout
    qs = queries(axes, rng, n=30)
    for orders in [(1, 0, 0), (0, 1, 1), (2, 1, 0), (3, 0, 2)]:
        a = cell.derivative(*qs, orders=orders).numpy()
        b = node.derivative(*qs, orders=orders)
        assert a.shape == tuple(b.shape) == (30, 2)
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-10 * scale)
        assert scaled(b, jnode.derivative(*qs, orders=orders)) <= 1e-12
        assert scaled(a, jcell.derivative(*qs, orders=orders)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_derivative_matches_jax(method, dtype):
    """Orders 0-4 on each axis of a 3-axis grid with trailing dims (total
    order up to 6 in float64, 3 in float32), queries of shape (4, 10)
    (output ``M + N - k`` dims), extrapolating: within 1e-12 (float64) or
    1e-5 (float32) of the scale of JAX's.  The grid and queries are
    ``test_cubic_matches_jax``'s; a float32 partial of higher total order
    loses about a digit an order to cancellation in both packages alike
    (order (2, 3, 1): JAX 1.3e-5 of the scale from the float64 value, the
    port 6.6e-6)."""
    rng = np.random.default_rng(66)
    axes = [np.cumsum(rng.uniform(0.5, 1.5, n)) / n for n in (7, 6, 5)]
    data = rng.normal(size=tuple(a.size for a in axes) + (3,))
    j, t = both(data, axes, method, extrapolate=True, dtype=dtype)
    qs = [rng.uniform(a[0] - 0.1, a[-1] + 0.1, (4, 10)).astype(dtype) for a in axes]
    for orders in itertools.product(range(5), repeat=3):
        if sum(orders) > (6 if dtype == np.float64 else 3):
            continue
        got = t.derivative(*qs, orders=orders)
        want = np.asarray(j.derivative(*qs, orders=orders))
        assert tuple(got.shape) == want.shape == (4, 10, 3)
        assert got.dtype == t.data.dtype
        if not np.abs(want).max():
            np.testing.assert_array_equal(got.numpy(), 0.0)
            continue
        tol = 1e-5 if dtype == np.float32 else deriv_tol(orders)
        assert scaled(got, want) <= tol, orders


def test_derivative_order0_is_the_value_and_cpu_launches_nothing():
    axes, data, rng = grid_case(3, seed=67)
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    for method in ("linear", "cubic"):
        _, t = both(data, axes, method)
        qs = queries(axes, rng, n=50)
        torch.testing.assert_close(t.derivative(*qs, orders=(0, 0, 0)), t.interp_array(*qs),
                                   rtol=0, atol=0)
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


def test_derivative_errors():
    axes, data, _ = grid_case(2)
    jlin, lin = both(data, axes)
    q = [np.zeros(2) + axes[0][1], np.zeros(2) + axes[1][1]]
    for orders in [(1,), (-1, 0)]:
        same_error(lambda: jlin.derivative(*q, orders=orders),
                   lambda: lin.derivative(*q, orders=orders))
    jnear, near = both(data, axes, "nearest")
    same_error(lambda: jnear.derivative(np.zeros(1), np.zeros(1), orders=(1, 0)),
               lambda: near.derivative(np.zeros(1), np.zeros(1), orders=(1, 0)))
    with pytest.raises(TypeError, match="nearest does not support"):
        near.derivative(np.zeros(1), np.zeros(1), orders=(1, 0))
    # out of range raises eagerly (the axis and value as JAX says them); NaN first
    bad = [np.array([axes[0][0], axes[0][-1] + 1.0]), np.array([axes[1][0]] * 2)]
    same_error(lambda: jlin.derivative(*bad, orders=(1, 0)),
               lambda: lin.derivative(*bad, orders=(1, 0)))
    with pytest.raises(OutOfBoundsError):
        lin.derivative(*bad, orders=(1, 0))
    nan = [np.array([np.nan]), np.array([axes[1][1]])]
    same_error(lambda: jlin.derivative(*nan, orders=(1, 0)),
               lambda: lin.derivative(*nan, orders=(1, 0)))
    same_error(lambda: jlin.derivative(np.zeros(2), np.zeros(3), orders=(1, 0)),
               lambda: lin.derivative(np.zeros(2), np.zeros(3), orders=(1, 0)))


# -- calculus: integrate ---------------------------------------------------------------
def test_integrate_cubic_matches_sequential_scipy():
    rng = np.random.default_rng(81)
    for k in (1, 2, 3):
        axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 7, 5)[:k]]
        data = rng.normal(size=tuple(a.shape[0] for a in axes))
        j, t = both(data, axes, "cubic")
        box = [(a[0] + 0.05, a[-1] - 0.07) for a in axes]
        # sequential 1-D spline integration, axis k-1 inward
        g = data
        for d in reversed(range(k)):
            g = si.CubicSpline(axes[d], g, axis=d).integrate(*box[d])
        got = t.integrate(*box)
        assert tuple(got.shape) == () and got.dtype == torch.float64
        np.testing.assert_allclose(float(got), float(g), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(got), float(j.integrate(*box)), rtol=0, atol=1e-12)


def test_integrate_trailing_and_signed():
    rng = np.random.default_rng(82)
    axes = [np.sort(rng.uniform(0, 1, 6)), np.sort(rng.uniform(0, 1, 7))]
    data = rng.normal(size=(6, 7, 2))
    j, t = both(data, axes, "cubic")
    box = [(axes[0][0] + 0.02, axes[0][-1] - 0.02), (axes[1][0] + 0.03, axes[1][-1] - 0.01)]
    g = si.CubicSpline(axes[1], data, axis=1).integrate(*box[1])
    ref = si.CubicSpline(axes[0], g, axis=0).integrate(*box[0])
    got = t.integrate(*box)
    assert tuple(got.shape) == (2,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    assert scaled(got, j.integrate(*box)) <= 1e-12
    # swapping one axis's bounds negates
    flipped = t.integrate((box[0][1], box[0][0]), box[1])
    np.testing.assert_allclose(flipped.numpy(), -got.numpy(), rtol=0, atol=1e-13)
    assert scaled(flipped, j.integrate((box[0][1], box[0][0]), box[1])) <= 1e-12


def test_integrate_linear_exact_on_plane():
    ax = [np.array([0.0, 1.0, 3.0]), np.array([0.0, 2.0])]
    x, y = np.meshgrid(*ax, indexing="ij")
    data = 2.0 * x + 3.0 * y + 1.0
    j, t = both(data, ax)
    got = float(t.integrate((0.0, 3.0), (0.0, 2.0)))
    np.testing.assert_allclose(got, 42.0, atol=1e-12)
    np.testing.assert_allclose(got, float(j.integrate((0.0, 3.0), (0.0, 2.0))), atol=1e-12)


@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_integrate_extrapolated_bounds(method):
    rng = np.random.default_rng(83)
    x = np.sort(rng.uniform(0, 10, 8))
    y = rng.normal(size=8)
    j, t = both(y, [x], method, extrapolate=True)
    lo, hi = x[0] - 2.0, x[-1] + 1.0
    got = float(t.integrate((lo, hi)))
    if method == "cubic":
        np.testing.assert_allclose(got, si.CubicSpline(x, y).integrate(lo, hi), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(got, float(j.integrate((lo, hi))), rtol=0, atol=1e-12)


def test_integrate_matches_interp1d():
    """Two of these knots lie 2.7e-4 apart, so the integral is -5,618: the
    JAX test's absolute 1e-12 is under one ulp of it there, and is held here
    as 1e-12 of the value scale (the port's ``Interp1D`` and JAX's 4 and 3
    ulps away)."""
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D

    rng = np.random.default_rng(84)
    x = np.sort(rng.uniform(0, 10, 9))
    y = rng.normal(size=9)
    j, nd = both(y, [x], "cubic")
    i1 = Interp1D.builder(y, device="cpu").x(x).strategy(CubicSpline()).build()
    lo, hi = x[0] + 0.5, x[-1] - 0.5
    got = float(nd.integrate((lo, hi)))
    want = float(i1.integrate(lo, hi))
    atol = 1e-12 * max(1.0, abs(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, float(j.integrate((lo, hi))), rtol=0, atol=atol)


@pytest.mark.parametrize("bounds", ["python floats", "float32 tensors", "numpy float32"])
def test_integrate_float32_and_tensor_bounds(bounds):
    """A float32 grid integrates in float32 within 1e-5 of the scale of
    JAX's; bounds may be tensors or numpy scalars."""
    axes, data, rng = grid_case(2, trailing=(2,), seed=86)
    j, t = both(data, axes, "cubic", dtype=np.float32)
    box = [(float(a[1]) + 0.1, float(a[-2])) for a in axes]
    conv = {"python floats": float, "numpy float32": np.float32,
            "float32 tensors": lambda v: torch.tensor(v, dtype=torch.float32)}[bounds]
    got = t.integrate(*[(conv(lo), conv(hi)) for lo, hi in box])
    assert got.dtype == torch.float32
    assert scaled(got, j.integrate(*box)) <= 1e-5


def test_integrate_errors():
    rng = np.random.default_rng(85)
    axes = [np.sort(rng.uniform(0, 1, 6)), np.sort(rng.uniform(0, 1, 6))]
    data = rng.normal(size=(6, 6))
    j, t = both(data, axes, "cubic")
    for bounds in [((axes[0][0] - 1.0, axes[0][-1]), (0.5, 0.6)), ((0.1, 0.2),),
                   ((0.5, 0.6), (0.2, axes[1][-1] + 0.5))]:
        same_error(lambda: j.integrate(*bounds), lambda: t.integrate(*bounds))
    with pytest.raises(OutOfBoundsError, match="bounds"):
        t.integrate((axes[0][0] - 1.0, axes[0][-1]), (0.5, 0.6))
    jn, near = both(data, axes, "nearest")
    same_error(lambda: jn.integrate((0.1, 0.2), (0.1, 0.2)),
               lambda: near.integrate((0.1, 0.2), (0.1, 0.2)))
    per = np.concatenate([data[:-1], data[:1]], axis=0)
    jp, tp = both(per, axes, "cubic", bcs=("periodic", "natural"))
    same_error(lambda: jp.integrate((0.1, 0.2), (0.1, 0.2)),
               lambda: tp.integrate((0.1, 0.2), (0.1, 0.2)))
    with pytest.raises(ValueError, match="periodic"):
        tp.integrate((0.1, 0.2), (0.1, 0.2))
