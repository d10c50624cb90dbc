"""The port's step family (``Nearest``, ``Nearest2D``), the pointwise
strategy adapters (``PointwiseStrategy``, ``PointwiseStrategy2D``) and the
custom-strategy example, against the JAX package on the CPU.

Twins of ``tests/test_strategies.py``'s ``TestCustomStrategy``,
``TestNearest`` and ``TestNearest2D``: the same seeded numpy inputs through
the JAX interpolator and the port's, the values equal (selection does no
arithmetic, so ``atol=0``, as the JAX tests hold them against SciPy), and
against SciPy's ``interp1d(kind=...)`` and ``RegularGridInterpolator(
method="nearest")``.  JAX's ``jit``/``vmap``/pytree tests become
``torch.func.vmap`` and reshaped-call checks.  A JAX ``Nearest`` or
``Nearest2D`` interpolator's own state carries across with ``interop``.
"""

import sys
from pathlib import Path

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
from ndarray_interp_tpu.errors import OutOfBoundsError as JOutOfBounds
from ndarray_interp_tpu_torch import OutOfBoundsError
from ndarray_interp_tpu_torch.examples import custom_strategy as tex
from ndarray_interp_tpu_torch.interop import interp1d_from_numpy, interp2d_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import custom_strategy as jex  # noqa: E402  (the JAX package's example)

MODES = ["nearest", "nearest-up", "previous", "next"]


def case(n=20, bank=None, seed=5):
    """``tests/test_strategies.py:case``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=(n,) if bank is None else (n, bank))
    return x, y, np.linspace(x[0], x[-1], 7 * n)


def both1(y, strat_j, strat_t, x=None):
    """The JAX interpolator and the port's (on the CPU) of the same data."""
    bj = j1.Interp1D.builder(jnp.asarray(y))
    bt = t1.Interp1D.builder(y, device="cpu")
    if x is not None:
        bj, bt = bj.x(jnp.asarray(x)), bt.x(x)
    return bj.strategy(strat_j).build(), bt.strategy(strat_t).build()


def both2(z, strat_j, strat_t, x=None, y=None):
    bj = j2.Interp2D.builder(jnp.asarray(z))
    bt = t2.Interp2D.builder(z, device="cpu")
    if x is not None:
        bj, bt = bj.x(jnp.asarray(x)).y(jnp.asarray(y)), bt.x(x).y(y)
    return bj.strategy(strat_j).build(), bt.strategy(strat_t).build()


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# -- TestCustomStrategy -------------------------------------------------------------
@pytest.mark.parametrize("cls_name", ["StepInterpolator", "StepInterpolatorBatched"])
def test_custom_step_strategy(cls_name):
    """examples/custom_strategy.rs:56-68, both formulations."""
    data = np.array([2.0, 4.0, 5.0])
    query = np.linspace(-0.5, 2.5, 6)
    j, t = both1(data, getattr(jex, cls_name)(), getattr(tex, cls_name)())
    got = t.interp_array(query)
    np.testing.assert_allclose(got.numpy(), [2.0, 2.0, 4.0, 4.0, 5.0, 5.0], atol=1e-15)
    same(got, j.interp_array(jnp.asarray(query)))


def test_pointwise_and_batched_custom_strategies_agree():
    """test_pointwise_and_batched_agree_under_jit: the ``vmap``-ed pointwise
    form equals the batched one on bank data, and both equal JAX's."""
    data = np.random.default_rng(0).normal(size=(10, 3))
    q = np.linspace(0.0, 9.0, 40)
    outs = []
    for name in ("StepInterpolator", "StepInterpolatorBatched"):
        j, t = both1(data, getattr(jex, name)(), getattr(tex, name)())
        outs.append(t(q))
        same(outs[-1], j(jnp.asarray(q)))
    assert torch.equal(outs[0], outs[1])


def test_custom_strategy_example_main_runs_on_the_cpu(capsys):
    tex.main(device="cpu")
    assert "StepInterpolator: [2. 2. 4. 4. 5. 5.]" in capsys.readouterr().out


def test_pointwise_strategy_empty_batch_and_query_shapes():
    """An empty batch keeps the trailing shape and dtype; query dims lead."""
    data = np.arange(12.0).reshape(4, 3)
    _, t = both1(data, jex.StepInterpolator(), tex.StepInterpolator())
    assert tuple(t(np.zeros(0)).shape) == (0, 3) and t(np.zeros(0)).dtype == torch.float64
    q = np.array([[0.2, 1.6], [2.5, 3.0]])
    assert torch.equal(t(q), t(q.ravel()).reshape(2, 2, 3))


def test_pointwise_strategy2d_vectorizes_eval_point():
    """``PointwiseStrategy2D``: a nearest-node strategy written for one
    point equals ``Nearest2D`` (ties left), on bank data."""

    class Nearest2DPointwise(t2.PointwiseStrategy2D):
        extrapolates = True

        def eval_point(self, interp, x, y):
            xi, yi = interp.get_index_left_of(x, y)
            x1, y1, _ = interp.index_point(xi, yi)
            x2, y2, _ = interp.index_point(xi + 1, yi + 1)
            px = torch.where((x - x1) <= (x2 - x), xi, xi + 1)
            py = torch.where((y - y1) <= (y2 - y), yi, yi + 1)
            return interp.index_point(px, py)[2]

    rng = np.random.default_rng(21)
    x, y = np.sort(rng.uniform(0, 10, 9)), np.sort(rng.uniform(0, 8, 7))
    z = rng.normal(size=(9, 7, 2))
    qx, qy = rng.uniform(-1, 11, 300), rng.uniform(-1, 9, 300)
    pointwise = t2.Interp2D.builder(z, device="cpu").x(x).y(y).strategy(Nearest2DPointwise()).build()
    _, batched = both2(z, j2.Nearest2D(extrapolate=True), t2.Nearest2D(extrapolate=True), x, y)
    assert torch.equal(pointwise(qx, qy), batched(qx, qy))
    assert tuple(pointwise(np.zeros(0), np.zeros(0)).shape) == (0, 2)


# -- TestNearest ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_nearest_matches_scipy_and_jax(mode):
    x, y, q = case(seed=11)
    j, t = both1(y, j1.Nearest(mode), t1.Nearest(mode), x)
    got = t.interp_array(q)
    np.testing.assert_allclose(got.numpy(), si.interp1d(x, y, kind=mode)(q), atol=0)
    same(got, j.interp_array(q))


def test_nearest_midpoint_ties():
    x = np.array([0.0, 1.0, 2.0])
    y = np.array([10.0, 20.0, 30.0])
    mid = np.array([0.5, 1.5])
    for mode, want in (("nearest", [10.0, 20.0]), ("nearest-up", [20.0, 30.0])):
        j, t = both1(y, j1.Nearest(mode), t1.Nearest(mode), x)
        np.testing.assert_array_equal(t.interp_array(mid).numpy(), want)
        same(t.interp_array(mid), j.interp_array(mid))


def test_nearest_exact_knot_hits():
    x = np.array([0.0, 1.0, 2.0, 3.0])
    y = np.array([1.0, 2.0, 3.0, 4.0])
    for mode in MODES:
        j, t = both1(y, j1.Nearest(mode), t1.Nearest(mode), x)
        np.testing.assert_array_equal(t.interp_array(x).numpy(), y, err_msg=mode)
        same(t.interp_array(x), j.interp_array(x))


def test_nearest_oob_and_clamped_extrapolation():
    x = np.array([0.0, 1.0, 2.0])
    y = np.array([10.0, 20.0, 30.0])
    j, t = both1(y, j1.Nearest("nearest"), t1.Nearest("nearest"), x)
    with pytest.raises(JOutOfBounds) as jerr:
        j.interp(-0.5)
    with pytest.raises(OutOfBoundsError) as terr:
        t.interp(-0.5)
    assert str(terr.value) == str(jerr.value)
    out = t(np.array([-0.5, 1.2]))  # the pure call masks out-of-range floats
    assert np.isnan(out[0].item()) and out[1].item() == 20.0
    j, t = both1(y, j1.Nearest("nearest").extrapolate(True),
                 t1.Nearest("nearest").extrapolate(True), x)
    np.testing.assert_array_equal(t.interp_array(np.array([-5.0, 7.0])).numpy(), [10.0, 30.0])
    same(t.interp_array(np.array([-5.0, 7.0])), j.interp_array(np.array([-5.0, 7.0])))
    with pytest.raises(ValueError, match="unknown step mode"):
        t1.Nearest("cubic")


def test_nearest_integer_data_stays_exact():
    y = np.array([1, 5, 9], np.int32)
    j, t = both1(y, j1.Nearest("previous"), t1.Nearest("previous"))
    q = np.array([0.9, 1.0, 1.9])
    out = t.interp_array(q)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), [1, 5, 5])
    same(out, j.interp_array(q))
    # integer data cannot hold NaN: the pure call clamps, as in JAX
    same(t(np.array([-3.0, 5.0])), j(jnp.asarray([-3.0, 5.0])))


def test_nearest_vmap_and_query_dims():
    """test_jit_vmap_and_pytree: ``torch.func.vmap`` over query rows and a
    reshaped call equal the direct call (and JAX's)."""
    x, y, q = case(seed=13)
    j, t = both1(y, j1.Nearest("nearest-up", extrapolate=True),
                 t1.Nearest("nearest-up", extrapolate=True), x)
    direct = t(q)
    same(direct, j(jnp.asarray(q)))
    qt = torch.as_tensor(q)
    assert torch.equal(torch.func.vmap(t)(qt.reshape(4, -1)).reshape(-1), direct)
    assert torch.equal(t(q.reshape(4, -1)).reshape(-1), direct)


@pytest.mark.parametrize("name", ["Akima", "Makima", "Pchip"])
def test_hermite_vmap_of_itp(name):
    """The query-row ``vmap`` of test_jit_vmap_and_pytree on the strategies
    that run K1: ``torch.func.vmap(itp)`` equals the direct call bit for bit
    (one K1 call on the flattened rows) and JAX's ``vmap``."""
    x, y, q = case(seed=13)
    j, t = both1(y, getattr(j1, name)(), getattr(t1, name)(), x)
    qt = torch.as_tensor(q)
    direct = t(qt)
    got = torch.func.vmap(t)(qt.reshape(4, -1))
    assert torch.equal(got.reshape(-1), direct)
    jv = jax.vmap(lambda qq: j(qq))(jnp.asarray(q).reshape(4, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(jv), rtol=1e-12, atol=1e-12)


# -- TestNearest2D --------------------------------------------------------------------
def test_nearest2d_matches_scipy_rgi_and_jax():
    rng = np.random.default_rng(23)
    x = np.sort(rng.uniform(0, 10, 15))
    y = np.sort(rng.uniform(0, 8, 12))
    z = rng.normal(size=(15, 12, 2))
    j, t = both2(z, j2.Nearest2D(), t2.Nearest2D(), x, y)
    qx = rng.uniform(x[0], x[-1], 400)
    qy = rng.uniform(y[0], y[-1], 400)
    got = t.interp_array(qx, qy)
    ref = si.RegularGridInterpolator((x, y), z, method="nearest")(np.stack([qx, qy], axis=-1))
    np.testing.assert_allclose(got.numpy(), ref, atol=0)
    same(got, j.interp_array(qx, qy))


def test_nearest2d_grid_node_hits_and_ties():
    x = np.array([0.0, 1.0, 2.0])
    y = np.array([0.0, 2.0])
    z = np.arange(6.0).reshape(3, 2)
    j, t = both2(z, j2.Nearest2D(), t2.Nearest2D(), x, y)
    gx, gy = np.meshgrid(x, y, indexing="ij")
    np.testing.assert_array_equal(t.interp_array(gx.ravel(), gy.ravel()).numpy(), z.ravel())
    assert float(t.interp_scalar(0.5, 1.0)) == z[0, 0] == float(j.interp_scalar(0.5, 1.0))


def test_nearest2d_oob_and_clamped_extrapolation():
    z = np.arange(12.0).reshape(4, 3)
    j, t = both2(z, j2.Nearest2D(), t2.Nearest2D())
    with pytest.raises(JOutOfBounds) as jerr:
        j.interp(-1.0, 0.0)
    with pytest.raises(OutOfBoundsError) as terr:
        t.interp(-1.0, 0.0)
    assert str(terr.value) == str(jerr.value)
    _, ex = both2(z, j2.Nearest2D(extrapolate=True), t2.Nearest2D(extrapolate=True))
    assert float(ex.interp_scalar(-5.0, -5.0)) == 0.0
    assert float(ex.interp_scalar(99.0, 99.0)) == 11.0


def test_nearest2d_call_matches_eager():
    """test_jit_matches_eager: ``itp(xs, ys)`` equals ``interp_array`` (and
    JAX's call)."""
    rng = np.random.default_rng(27)
    z = rng.normal(size=(9, 7))
    j, t = both2(z, j2.Nearest2D(extrapolate=True), t2.Nearest2D(extrapolate=True))
    qx, qy = rng.uniform(0, 8, 50), rng.uniform(0, 6, 50)
    assert torch.equal(t(qx, qy), t.interp_array(qx, qy))
    same(t(qx, qy), j(jnp.asarray(qx), jnp.asarray(qy)))


def test_nearest2d_integer_grid_stays_exact():
    z = np.arange(20, dtype=np.int32).reshape(4, 5) * 7
    j, t = both2(z, j2.Nearest2D(), t2.Nearest2D())
    qx, qy = np.array([0.2, 2.9]), np.array([0.9, 3.8])
    out = t.interp_array(qx, qy)
    np.testing.assert_array_equal(out.numpy(), [7 * 1, 7 * (3 * 5 + 4)])
    same(out, j.interp_array(qx, qy))


# -- state carried across from the JAX package ----------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("extrapolate", [False, True])
def test_interop_carries_a_jax_nearest(mode, extrapolate):
    x, y, _ = case(bank=2, seed=31)
    j = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)).strategy(
        j1.Nearest(mode, extrapolate=extrapolate)).build()
    s = j.strategy
    t = interp1d_from_numpy(np.asarray(j.x), np.asarray(j.data), strategy="nearest",
                            nearest_mode=s.mode, mode="yes" if s.extrapolates else "no",
                            device="cpu")
    assert isinstance(t.strategy, t1.Nearest) and t.strategy.mode == mode
    q = np.linspace(x[0] - 1, x[-1] + 1, 97)
    same(t(q), j(jnp.asarray(q)))


def test_interop_carries_a_jax_nearest2d():
    rng = np.random.default_rng(33)
    x, y = np.sort(rng.uniform(0, 5, 8)), np.sort(rng.uniform(0, 4, 6))
    j = j2.Interp2D.builder(jnp.asarray(rng.normal(size=(8, 6, 3)))).x(jnp.asarray(x)).y(
        jnp.asarray(y)).strategy(j2.Nearest2D(extrapolate=True)).build()
    t = interp2d_from_numpy(np.asarray(j.x), np.asarray(j.y), np.asarray(j.data),
                            strategy="nearest", extrapolate=j.strategy.extrapolates, device="cpu")
    qx, qy = rng.uniform(-1, 6, 200), rng.uniform(-1, 5, 200)
    same(t(qx, qy), j(jnp.asarray(qx), jnp.asarray(qy)))
    with pytest.raises(ValueError, match="no periodic mode"):
        interp1d_from_numpy(x, x, strategy="nearest", mode="periodic", device="cpu")
