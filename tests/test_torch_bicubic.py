"""The port's ``Bicubic`` against the JAX package's, and against SciPy, on
the CPU.

The twins of ``tests/test_bicubic.py`` (its checkpoint cases are twinned in
``tests/test_torch_aux.py``, with the checkpoint module).  Oracle: the sequential per-axis SciPy
``CubicSpline``, the defining construction of the tensor-product spline.
The same numpy inputs go to both packages (the port's with
``device="cpu"``, where the Thomas kernel's plain loop builds the spline).

Tolerances: against JAX, scaled by the largest |value|, float64 1e-12 and
float32 ``rtol=2e-5, atol=1e-6``; against SciPy the JAX tests' own
(``rtol=1e-10, atol=1e-12``, boundary families ``1e-9 / 1e-11``).
"""

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.interp2d as j2
import ndarray_interp_tpu_torch.interp2d as t2
from ndarray_interp_tpu_torch import config as tconfig
from ndarray_interp_tpu_torch import errors as terr
from ndarray_interp_tpu_torch.models.strategies import bicubic as tb
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


KINDS = ["not_a_knot", "natural", "clamped", "periodic"]
_SCIPY_BC = {"not_a_knot": "not-a-knot", "natural": "natural", "clamped": "clamped",
             "periodic": "periodic"}


def tensor_oracle(x, y, z, qx, qy, bcx="not_a_knot", bcy="not_a_knot"):
    """Sequential per-axis SciPy CubicSpline (the exact tensor spline)."""
    g = si.CubicSpline(x, z, axis=0, bc_type=_SCIPY_BC[bcx])(qx)
    out = np.empty(qx.shape + z.shape[2:])
    for i in range(qx.shape[0]):
        out[i] = si.CubicSpline(y, g[i], axis=0, bc_type=_SCIPY_BC[bcy])(qy[i])
    return out


def fixture(nx=14, ny=11, trailing=(), seed=0, periodic=(False, False)):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.0, nx))
    y = np.cumsum(rng.uniform(0.2, 1.0, ny))
    z = rng.normal(size=(nx, ny) + trailing)
    if periodic[0]:
        z[-1] = z[0]
    if periodic[1]:
        z[:, -1] = z[:, 0]
    return x, y, z, rng


def build(pkg, x, y, z, extrapolate=True, bc=("not_a_knot", "not_a_knot"), dtype=np.float64):
    x, y, z = (v.astype(dtype) for v in (x, y, z))
    if pkg == "jax":
        b = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y))
        s = j2.Bicubic()
    else:
        b = t2.Interp2D.builder(z, device="cpu").x(x).y(y)
        s = t2.Bicubic()
    return b.strategy(s.boundary(*bc).extrapolate(extrapolate)).build()


def scaled(got, want, rtol, atol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=rtol if atol is None else atol)


def raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


# -- against the JAX package --------------------------------------------------------
@pytest.mark.parametrize("bcx", KINDS)
@pytest.mark.parametrize("bcy", KINDS)
def test_every_boundary_pair_matches_jax(bcx, bcy):
    """Each pair of per-axis kinds, periodic on either axis included: the
    packed cell table and the values (in and out of range; a periodic axis
    wraps) within 1e-12 of the JAX package's."""
    periodic = (bcx == "periodic", bcy == "periodic")
    x, y, z, rng = fixture(nx=12, ny=10, trailing=(2,), seed=KINDS.index(bcx) * 4
                           + KINDS.index(bcy), periodic=periodic)
    j = build("jax", x, y, z, bc=(bcx, bcy))
    t = build("torch", x, y, z, bc=(bcx, bcy))
    assert (t.strategy.layout, t.strategy.bc_x, t.strategy.bc_y) == ("cell", bcx, bcy)
    assert (t.strategy.wraps_x, t.strategy.wraps_y) == periodic
    scaled(t.strategy.rows, j.strategy.rows, 1e-12)
    qx = rng.uniform(x[0] - 2.0, x[-1] + 2.0, 300)
    qy = rng.uniform(y[0] - 2.0, y[-1] + 2.0, 300)
    scaled(t(qx, qy), j(jnp.asarray(qx), jnp.asarray(qy)), 1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("extrapolate", [False, True])
def test_values_and_masks_match_jax(dtype, extrapolate):
    x, y, z, rng = fixture(trailing=(3,), seed=2)
    j = build("jax", x, y, z, extrapolate, dtype=dtype)
    t = build("torch", x, y, z, extrapolate, dtype=dtype)
    qx = rng.uniform(x[0] - 1, x[-1] + 1, (4, 60)).astype(dtype)
    qy = rng.uniform(y[0] - 1, y[-1] + 1, (4, 60)).astype(dtype)
    got = t(qx, qy)
    want = np.asarray(j(jnp.asarray(qx), jnp.asarray(qy)))
    assert tuple(got.shape) == want.shape == (4, 60, 3) and got.dtype == t.data.dtype
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    fin = ~np.isnan(want)
    tol = (2e-5, 1e-6) if dtype == np.float32 else (1e-12, 1e-12)
    scaled(got.numpy()[fin], want[fin], *tol)


def test_periodic_wrap_and_range_check_match_jax():
    """A periodic x axis wraps (never out of range); y still raises."""
    x, y, z, rng = fixture(nx=12, ny=10, seed=7, periodic=(True, False))
    j = build("jax", x, y, z, extrapolate=False, bc=("periodic", "not_a_knot"))
    t = build("torch", x, y, z, extrapolate=False, bc=("periodic", "not_a_knot"))
    period = x[-1] - x[0]
    qx = rng.uniform(x[0] - 3 * period, x[-1] + 3 * period, 200)
    qy = rng.uniform(y[0], y[-1], 200)
    scaled(t.interp_array(qx, qy), j.interp_array(qx, qy), 1e-12)
    for q in (([x[0] + 0.1], [y[-1] + 1.0]), ([np.nan], [y[2]])):
        jerr = raised(lambda: j.interp_array(np.asarray(q[0]), np.asarray(q[1])))
        terr_ = raised(lambda: t.interp_array(np.asarray(q[0]), np.asarray(q[1])))
        assert type(terr_).__name__ == type(jerr).__name__ and str(terr_) == str(jerr)


# -- the JAX package's own tests (tests/test_bicubic.py twins) --------------------------------
@BOTH_ROUTES
def test_matches_sequential_scipy_oracle():
    x, y, z, rng = fixture()
    t = build("torch", x, y, z)
    qx, qy = rng.uniform(x[0], x[-1], 400), rng.uniform(y[0], y[-1], 400)
    np.testing.assert_allclose(np.asarray(t.interp_array(qx, qy)), tensor_oracle(x, y, z, qx, qy),
                               rtol=1e-10, atol=1e-12)


@BOTH_ROUTES
def test_knot_exactness():
    x, y, z, _ = fixture()
    t = build("torch", x, y, z)
    xi, yi = np.meshgrid(x, y, indexing="ij")
    np.testing.assert_allclose(np.asarray(t.interp_array(xi.ravel(), yi.ravel())), z.ravel(),
                               rtol=1e-12, atol=1e-12)


@BOTH_ROUTES
def test_trailing_dims():
    x, y, z, rng = fixture(trailing=(3,))
    t = build("torch", x, y, z)
    qx, qy = rng.uniform(x[0], x[-1], 50), rng.uniform(y[0], y[-1], 50)
    got = t.interp_array(qx, qy)
    assert tuple(got.shape) == (50, 3)
    np.testing.assert_allclose(np.asarray(got), tensor_oracle(x, y, z, qx, qy),
                               rtol=1e-10, atol=1e-12)


@BOTH_ROUTES
def test_extrapolation_continues_edge_patch():
    x, y, z, _ = fixture()
    j, t = build("jax", x, y, z), build("torch", x, y, z)
    qx, qy = np.asarray([x[0] - 0.5, x[-1] + 0.5]), np.asarray([y[0] - 0.3, y[-1] + 0.3])
    got = t.interp_array(qx, qy)
    assert np.isfinite(np.asarray(got)).all()
    scaled(got, j.interp_array(qx, qy), 1e-12)


def test_oob_raises_without_extrapolate():
    x, y, z, _ = fixture()
    j = build("jax", x, y, z, extrapolate=False)
    t = build("torch", x, y, z, extrapolate=False)
    q = (np.asarray([x[0] - 1.0]), np.asarray([y[2]]))
    jerr, terr_ = raised(lambda: j.interp_array(*q)), raised(lambda: t.interp_array(*q))
    assert isinstance(terr_, terr.OutOfBoundsError) and str(terr_) == str(jerr)


def test_min_points_enforced():
    jerr = raised(lambda: j2.Interp2D.builder(jnp.zeros((2, 5))).strategy(j2.Bicubic()).build())
    terr_ = raised(lambda: t2.Interp2D.builder(np.zeros((2, 5)), device="cpu")
                   .strategy(t2.Bicubic()).build())
    assert isinstance(terr_, terr.NotEnoughDataError) and str(terr_) == str(jerr)


@BOTH_ROUTES
def test_smooth_function_convergence():
    """On a smooth function the bicubic error is orders below bilinear's."""
    x = np.linspace(0, np.pi, 24)
    y = np.linspace(0, np.pi, 20)
    z = np.sin(x)[:, None] * np.cos(y)[None, :]
    rng = np.random.default_rng(5)
    qx, qy = rng.uniform(0, np.pi, 500), rng.uniform(0, np.pi, 500)
    truth = np.sin(qx) * np.cos(qy)
    cubic = np.asarray(build("torch", x, y, z).interp_array(qx, qy))
    lin = np.asarray(t2.Interp2D.builder(z, device="cpu").x(x).y(y).build().interp_array(qx, qy))
    assert np.abs(cubic - truth).max() < 1e-4
    assert np.abs(cubic - truth).max() < np.abs(lin - truth).max() / 50


@pytest.mark.parametrize("bcx,bcy", [("natural", "natural"), ("clamped", "clamped"),
                                     ("natural", "clamped"), ("clamped", "not_a_knot"),
                                     ("not_a_knot", "natural")])
@BOTH_ROUTES
def test_boundaries_match_scipy_oracle(bcx, bcy):
    x, y, z, rng = fixture(seed=len(bcx) * 10 + len(bcy))
    t = build("torch", x, y, z, bc=(bcx, bcy))
    qx, qy = rng.uniform(x[0], x[-1], 300), rng.uniform(y[0], y[-1], 300)
    np.testing.assert_allclose(np.asarray(t.interp_array(qx, qy)),
                               tensor_oracle(x, y, z, qx, qy, bcx, bcy), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("bcx,bcy", [("periodic", "not_a_knot"), ("periodic", "periodic")])
def test_periodic_axes(bcx, bcy):
    x, y, z, rng = fixture(nx=12, ny=10, seed=7, periodic=(True, bcy == "periodic"))
    t = build("torch", x, y, z, extrapolate=False, bc=(bcx, bcy))
    qx, qy = rng.uniform(x[0], x[-1], 200), rng.uniform(y[0], y[-1], 200)
    got = t.interp_array(qx, qy).numpy()
    np.testing.assert_allclose(got, tensor_oracle(x, y, z, qx, qy, bcx, bcy),
                               rtol=1e-9, atol=1e-11)
    period = x[-1] - x[0]
    np.testing.assert_allclose(t.interp_array(qx + 2 * period, qy).numpy(), got,
                               rtol=1e-4, atol=1e-6)
    if bcy != "periodic":
        with pytest.raises(terr.OutOfBoundsError):
            t.interp_array(np.asarray([x[0] + 0.1]), np.asarray([y[-1] + 1.0]))


@pytest.mark.parametrize("bc", [("periodic", "not_a_knot"), ("natural", "periodic")])
def test_periodic_requires_first_equals_last(bc):
    x, y, z, _ = fixture(seed=3)
    jerr = raised(lambda: build("jax", x, y, z, bc=bc))
    terr_ = raised(lambda: build("torch", x, y, z, bc=bc))
    assert isinstance(terr_, terr.BuilderValueError)
    assert type(terr_).__name__ == type(jerr).__name__ and str(terr_) == str(jerr)


def test_unknown_kind_rejected():
    jerr = raised(lambda: j2.Bicubic().boundary("cubic"))
    terr_ = raised(lambda: t2.Bicubic().boundary("cubic"))
    assert isinstance(terr_, ValueError) and str(terr_) == str(jerr)


def test_integer_data_is_refused():
    with pytest.raises(TypeError, match="floating-point"):
        t2.Interp2D.builder(np.arange(16).reshape(4, 4), device="cpu").strategy(
            t2.Bicubic()).build()


# -- layouts -----------------------------------------------------------------------------------
@BOTH_ROUTES
def test_node_layout_matches_cell_and_jax(monkeypatch):
    """The port's threshold patched low gives the node layout: its table
    matches the JAX node table, and its values the cell layout's and the
    JAX node layout's."""
    from ndarray_interp_tpu import config

    x, y, z, rng = fixture(trailing=(3,), seed=21)
    qx = rng.uniform(x[0] - 1, x[-1] + 1, 300)
    qy = rng.uniform(y[0] - 1, y[-1] + 1, 300)
    cell = build("torch", x, y, z)
    assert cell.strategy.layout == "cell"
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    monkeypatch.setattr(config, "bicubic_pack_max_elems", 10)
    node, jnode = build("torch", x, y, z), build("jax", x, y, z)
    assert node.strategy.layout == jnode.strategy.layout == "node"
    assert node.strategy.rows.numel() < cell.strategy.rows.numel() / 2.5
    scaled(node.strategy.rows, jnode.strategy.rows, 1e-12)
    got = node.interp_array(qx, qy)
    np.testing.assert_allclose(np.asarray(got), np.asarray(cell.interp_array(qx, qy)),
                               rtol=1e-9, atol=1e-11)
    scaled(got, jnode.interp_array(qx, qy), 1e-12)


@BOTH_ROUTES
def test_node_layout_matches_scipy(monkeypatch):
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    x, y, z, rng = fixture(seed=22)
    t = build("torch", x, y, z)
    assert t.strategy.layout == "node"
    qx, qy = rng.uniform(x[0], x[-1], 200), rng.uniform(y[0], y[-1], 200)
    np.testing.assert_allclose(np.asarray(t.interp_array(qx, qy)), tensor_oracle(x, y, z, qx, qy),
                               rtol=1e-10, atol=1e-12)


def test_packers_match_jax():
    from ndarray_interp_tpu.models.strategies import bicubic as jb

    x, y, z, _ = fixture(nx=7, ny=6, trailing=(2, 2), seed=8)
    jargs = [jnp.asarray(v) for v in (x, y, z)]
    targs = [torch.as_tensor(v) for v in (x, y, z)]
    jgrids = jb.bicubic_node_grids(*jargs, "clamped", "natural")
    tgrids = t2.bicubic_node_grids(*targs, "clamped", "natural")
    for g_t, g_j in zip(tgrids, jgrids):
        scaled(g_t, g_j, 1e-12)
    for name in ("pack_bicubic_rows", "pack_bicubic_nodes"):
        # the same grids into both packers: the tables agree bit for bit
        want = np.asarray(getattr(jb, name)(*jargs, *jgrids))
        got = getattr(tb, name)(*targs, *(torch.as_tensor(np.array(g)) for g in jgrids))
        np.testing.assert_array_equal(got.numpy(), want)


# -- the build's solves (K4 on the card, the plain Thomas loop here) ----------------------
def test_build_runs_three_solves_through_the_thomas_wrapper(monkeypatch):
    """``Bicubic.build`` solves along x, along y, and along y again for the
    cross derivative, each through ``thomas_solve_fast``: on a CPU tensor
    its plain loop (no launch), on the card K4.  The derivative grids equal
    SciPy's knot derivatives."""
    from ndarray_interp_tpu_torch.models.strategies import cubic

    calls = []
    fast = cubic.thomas_solve_fast
    monkeypatch.setattr(cubic, "thomas_solve_fast",
                        lambda *a: calls.append(a[3].shape) or fast(*a))
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    x, y, z, rng = fixture(nx=9, ny=7, trailing=(2,), seed=13)
    t = build("torch", x, y, z)
    assert calls == [(9, 14), (7, 18), (7, 18)]  # (n, bank) of the three solves
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before
    kx, ky, kxy = t2.bicubic_node_grids(*(torch.as_tensor(v) for v in (x, y, z)))
    np.testing.assert_allclose(kx.numpy(), si.CubicSpline(x, z, axis=0)(x, 1), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ky.numpy(), si.CubicSpline(y, z, axis=1)(y, 1),
                               rtol=1e-12, atol=1e-12)
    assert t.strategy.rows.shape == (8 * 6, 16 * 2)
