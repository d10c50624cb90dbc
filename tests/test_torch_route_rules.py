"""The port's route rules, on the CPU: the bank route (K5 or the packed
route), the K1/R3 split, the N-D layout choice, the layout caps and the
``Bilinear`` grid route, each set from an H100's times or memory
(``tools/route_phases.py``, ``PERF.md``), not from the JAX package's TPU
numbers.

Each rule is a plain function of shapes, dtypes and the config, pinned here
at shapes on both sides of its boundary (meta tensors stand in for the large
ones); then the public entry points on small CPU inputs take the route the
rule picks (the route's wrappers spied on, with a boundary moved down by
patching its constant where the real one is too large for the CPU), launch
no kernel, and give the JAX package's values at the matching JAX test's
tolerance, also where the JAX package takes another route (ROADMAP Queue 3,
route divergences): the bank and long-axis routes at ``rtol = atol = 1e-6``
(``tests/test_torch_bank.py``, ``tests/test_torch_bigknots.py``), float64
2-D and N-D values within 1e-12 of their scale (``tests/test_torch_bicubic.py``,
``tests/test_torch_interpnd.py``), ``Bilinear`` at ``tests/test_torch_interp2d.py``'s
float64 tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
from ndarray_interp_tpu import config as jconfig
from ndarray_interp_tpu.interpnd import InterpND as JInterpND
from ndarray_interp_tpu.models.strategies import bilinear as j_bilinear
from ndarray_interp_tpu.models.strategies.cubic import CubicSplineStrategy as JCubicState
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.interp2d as t2
from ndarray_interp_tpu_torch import config as tconfig
from ndarray_interp_tpu_torch.interpnd import InterpND
from ndarray_interp_tpu_torch.models.strategies import bicubic as t_bicubic
from ndarray_interp_tpu_torch.models.strategies import bilinear as t_bilinear
from ndarray_interp_tpu_torch.models.strategies import cubic as t_cubic
from ndarray_interp_tpu_torch.models.strategies.cubic import CubicSplineStrategy
from ndarray_interp_tpu_torch.ops import bank_eval as t_bank
from ndarray_interp_tpu_torch.ops import bigknots as t_bk
from ndarray_interp_tpu_torch.ops import kernel_wrappers
from ndarray_interp_tpu_torch.ops import knotshard as t_ks


@pytest.fixture
def no_launch():
    """The CPU routes launch no kernel."""
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    yield
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def spy(monkeypatch, module, names):
    """Record which of ``module``'s ``names`` are called, in order."""
    calls = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    return calls


def scale_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def bank_state(n, bank, seed, dtype=np.float32):
    """A bank spline's state, no solve: knots, data, a, b."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(dtype)
    d, a, b = (rng.normal(size=(m, bank)).astype(dtype) for m in (n, n - 1, n - 1))
    return x, d, a, b, rng


def both_banks(x, d, a, b):
    jit = j1.Interp1D.new_unchecked(jnp.asarray(x), jnp.asarray(d),
                                    JCubicState(jnp.asarray(a), jnp.asarray(b), "yes"))
    tit = t1.Interp1D.new_unchecked(torch.as_tensor(x), torch.as_tensor(d),
                                    CubicSplineStrategy(torch.as_tensor(a),
                                                        torch.as_tensor(b), "yes"))
    return jit, tit


# -- rule 1: the bank route ------------------------------------------------------------
def bank_route(n, bank, nq, dtype=torch.float32):
    """Rule 1's pick for ``nq`` queries: eligibility alone (the card's K5
    won at every float32 shape of the sweep, whatever ``nq``)."""
    return "K5" if t_bank.can_use_banked(meta(n), meta(n, bank, dtype=dtype)) else "packed"


# (knots, bank, queries) -> the route the card measured faster (PERF.md §6, rule 1: K5 at
# every float32 shape, the packed route's two former corners included)
BANK_CASES = [
    ((10_000, 64, 262_144), "K5"),  # the bank eval (the JAX package: packed)
    ((256, 16_384, 4096), "K5"),  # NS5
    ((64, 1_000_000, 256), "K5"),  # NS5b
    ((10_240, 64, 1_000_000), "K5"),  # NS2b (the JAX package: packed)
    ((262_144, 8, 1_000_000), "K5"),  # NS1b's bank of 8: 3.8 queries a knot
    ((4096, 1024, 262_144), "K5"),  # 64 queries a knot
    ((10_000, 256, 1_048_576), "K5"),  # the former wide corner: >= 100 queries a knot
    ((10_000, 1024, 1_048_576), "K5"),
    ((4096, 256, 409_600), "K5"),
    ((4096, 256, 409_599), "K5"),
    ((4095, 256, 1_048_576), "K5"),
    ((4096, 255, 1_048_576), "K5"),
    ((10_000, 32, 1_048_576), "K5"),
    ((10_000, 31, 1_048_576), "K5"),  # the former narrow corner: >= 8 queries a knot, 2^20 outputs
    ((10_000, 8, 262_144), "K5"),
    ((10_000, 8, 131_072), "K5"),
    ((10_000, 8, 131_071), "K5"),
    ((65_537, 8, 524_296), "K5"),
    ((65_537, 8, 524_295), "K5"),
    ((1024, 8, 4096), "K5"),
    ((64, 1, 1_048_576), "K5"),
    ((64, 1, 262_144), "K5"),
]


@pytest.mark.parametrize("shape,route", BANK_CASES, ids=[str(c[0]) for c in BANK_CASES])
def test_bank_rule_at_its_boundaries(shape, route):
    assert bank_route(*shape) == route


@pytest.mark.parametrize("n,bank,dtype,route", [
    (3, 1024, torch.float32, "packed"), (4, 1024, torch.float32, "K5"),
    (10_000, 64, torch.float64, "packed"), (10_000, 8, torch.float64, "packed"),
    (64, 1, torch.float64, "packed"),
])
def test_bank_rule_leaves_short_axes_and_float64_to_the_packed_route(n, bank, dtype, route):
    assert bank_route(n, bank, 1_048_576, dtype) == route


def test_bank_eligibility_bounds():
    """K5 takes float32 banks of any width on 4 knots and up (its knot bound
    is the long axis's); float64 and scalar data take the packed route."""
    top = t_bk.MAX_BIG_KNOTS
    assert t_bank.can_use_banked(meta(top), meta(top, 8))
    assert not t_bank.can_use_banked(meta(top + 1), meta(top + 1, 8))
    assert t_bank.can_use_banked(meta(64), meta(64, 1))
    assert t_bank.can_use_banked(meta(64), meta(64, 2, 3))
    assert not t_bank.can_use_banked(meta(64), meta(64, 64, dtype=torch.float64))
    assert not t_bank.can_use_banked(meta(3), meta(3, 1024))
    assert t_bank.can_use_banked(meta(4), meta(4, 1024))
    assert not t_bank.can_use_banked(meta(64), meta(64))


@pytest.mark.parametrize("bank,nq,dtype,route", [
    (8, 512, np.float32, "K5"), (8, 511, np.float32, "K5"), (32, 512, np.float32, "K5"),
    (256, 6400, np.float32, "K5"), (256, 6399, np.float32, "K5"),
    (8, 512, np.float64, "packed"), (256, 6400, np.float64, "packed"),
])
def test_bank_route_through_interp1d_matches_jax(monkeypatch, no_launch, bank, nq, dtype,
                                                 route):
    """The route the rule picks on a 64-knot bank at the packed route's two
    former corners (narrow banks at >= 8 queries a knot, wide ones at >=
    100; now K5) and in float64 (the packed route), and the JAX package's
    values on the same state."""
    x, d, a, b, rng = bank_state(64, bank, seed=bank, dtype=dtype)
    assert bank_route(64, bank, nq, torch.float64 if dtype == np.float64 else torch.float32) == route
    q = rng.uniform(x[0] - 1, x[-1] + 1, nq).astype(dtype)
    jit, tit = both_banks(x, d, a, b)
    calls = spy(monkeypatch, t_cubic, ("banked_eval", "gathered_bank_eval"))
    got = tit(torch.as_tensor(q))
    assert calls == ["banked_eval" if route == "K5" else "gathered_bank_eval"]
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.numpy(), np.asarray(jit(jnp.asarray(q))), rtol=tol,
                               atol=tol)


# -- rule 2: the K1/R3 split -----------------------------------------------------------
def test_one_split_constant():
    """``can_use_big``, the bank route's search and the knot shards read one
    constant."""
    split = t_bk.K1_MAX_KNOTS
    assert t_ks._LOCAL_BIG == split
    assert not t_bk.long_axis(split) and t_bk.long_axis(split + 1)
    assert t_bk.long_axis(t_bk.MAX_BIG_KNOTS) and not t_bk.long_axis(t_bk.MAX_BIG_KNOTS + 1)
    for n, big in ((split, False), (split + 1, True)):
        assert t_bk.can_use_big(meta(n), meta(n)) == big
        assert not t_bk.can_use_big(meta(n, dtype=torch.float64), meta(n, dtype=torch.float64))
        assert not t_bk.can_use_big(meta(n), meta(n, 2))


@pytest.mark.parametrize("offset", [0, 1])
def test_split_routes_scalar_data_matches_jax(monkeypatch, no_launch, offset):
    """K1 at the split, R3 one knot above it (their plain versions on the
    CPU), with the JAX package's values on a ``Linear`` spline of the same
    axis (no solve)."""
    n = t_bk.K1_MAX_KNOTS + offset
    x, d, _, _, rng = bank_state(n, 1, seed=offset)
    d = d[:, 0]
    q = rng.uniform(x[0] - 5, x[-1] + 5, 2000).astype(np.float32)
    jit = j1.Interp1D.builder(jnp.asarray(d)).x(jnp.asarray(x)).strategy(
        j1.Linear().extrapolate(True)).build()
    tit = t1.Interp1D.builder(torch.as_tensor(d)).x(torch.as_tensor(x)).strategy(
        t1.Linear().extrapolate(True)).build()
    from ndarray_interp_tpu_torch.models.strategies import linear as t_linear

    calls = spy(monkeypatch, t_linear, ("big_eval_1d", "fused_eval_1d"))
    got = tit(torch.as_tensor(q))
    assert calls == ["big_eval_1d" if offset else "fused_eval_1d"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jit(jnp.asarray(q))), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("offset", [0, 1])
def test_split_routes_bank_search_matches_jax(monkeypatch, no_launch, offset):
    """K2 at the split, R3idx one knot above it, for a bank's ``(idx, t)``."""
    n = t_bk.K1_MAX_KNOTS + offset
    x, d, a, b, rng = bank_state(n, 4, seed=10 + offset)
    q = rng.uniform(x[0] - 5, x[-1] + 5, 2000).astype(np.float32)
    jit, tit = both_banks(x, d, a, b)
    calls = spy(monkeypatch, t_cubic, ("big_lower_index_frac", "fused_index_frac"))
    got = tit(torch.as_tensor(q))
    assert calls == ["big_lower_index_frac" if offset else "fused_index_frac"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jit(jnp.asarray(q))), rtol=1e-6,
                               atol=1e-6)


# -- rule 3: the N-D layout --------------------------------------------------------------
def cell_elems(shape, r):
    k = len(shape)
    return int(np.prod([n - 1 for n in shape])) * 4**k * r


# (k, r) -> the layout the builder takes with every table under the cap (the
# cell layout: the card ran it fastest from two axes up, and one axis keeps it
# for DoubleFloatEvaluatorND), and with the cell table over it, the node layout
# the card ran fastest (PERF.md PR 24 rule 3)
LAYOUT_PICKS = {
    (1, 1): ("cell", "node"), (1, 4): ("cell", "node"), (1, 16): ("cell", "node"),
    (2, 1): ("cell", "node"), (2, 4): ("cell", "node"), (2, 16): ("cell", "node2"),
    (3, 1): ("cell", "node"), (3, 4): ("cell", "node"), (3, 16): ("cell", "node2"),
    (4, 1): ("cell", "node2"), (4, 4): ("cell", "node2"), (4, 16): ("cell", "node"),
}
LAYOUT_GRID = {1: (4_000_000,), 2: (1024, 1024), 3: (64, 64, 64), 4: (17, 17, 17, 17)}


@pytest.mark.parametrize("k,r", sorted(LAYOUT_PICKS))
def test_layout_rule_pick(monkeypatch, k, r):
    shape = LAYOUT_GRID[k]
    monkeypatch.setattr(tconfig, "interpnd_pack_max_elems", 1 << 62)
    assert InterpND.pick_layout(k, shape, r) == LAYOUT_PICKS[k, r][0]
    monkeypatch.setattr(tconfig, "interpnd_pack_max_elems", cell_elems(shape, r) - 1)
    assert InterpND.pick_layout(k, shape, r) == LAYOUT_PICKS[k, r][1]


def test_layout_costs_past_four_axes():
    """Past four axes the ``k = 4`` constants grow fourfold an axis: the
    ranking stays ``k = 4``'s."""
    for r in (1, 16):
        for lay in ("cell", "node", "node2", "node4"):
            c4 = InterpND.route_cost_ns(4, (9,) * 4, r, lay)
            assert InterpND.route_cost_ns(6, (9,) * 6, r, lay) == pytest.approx(16 * c4)


@pytest.mark.parametrize("over_cap", [False, True])
def test_one_axis_layout_matches_jax(monkeypatch, no_launch, over_cap):
    """On one axis both packages build the cell layout where it fits (the
    port although the card ran the node layout's eval faster there), and the
    node layout with the cell table over the cap; the same values within
    1e-12 of their scale, and the cell table serves
    ``DoubleFloatEvaluatorND``."""
    from ndarray_interp_tpu_torch.serving import DoubleFloatEvaluatorND

    rng = np.random.default_rng(12)
    ax = np.sort(rng.uniform(-3, 3, 40))
    data = rng.normal(size=40)
    if over_cap:
        monkeypatch.setattr(jconfig, "interpnd_pack_max_elems", 39 * 4 - 1)
        monkeypatch.setattr(tconfig, "interpnd_pack_max_elems", 39 * 4 - 1)
    j = JInterpND.builder(jnp.asarray(data)).points(ax).method("cubic").build()
    t = InterpND.builder(data, device="cpu").points(ax).method("cubic").build()
    lay = "node" if over_cap else "cell"
    assert (j.layout, t.layout) == (lay, lay)
    assert t.layout == InterpND.pick_layout(1, (40,), 1)
    q = rng.uniform(ax[0], ax[-1], 500)
    assert scale_err(t.interp_array(q), j.interp_array(jnp.asarray(q))) <= 1e-12
    if not over_cap:
        ev = DoubleFloatEvaluatorND(t)
        assert scale_err(ev(torch.as_tensor(q)), j.interp_array(jnp.asarray(q))) <= 1e-12


# -- rule 4: the layout caps -------------------------------------------------------------
def test_caps_come_from_the_card():
    """2^30 elements: a float64 table at the cap peaks at 2.19 (``Bicubic``)
    or 2.0 (``InterpND``) times its 8 GiB in the build, within a quarter of
    the card's 85.0 GB (PERF.md PR 24 rule 4); the JAX package's is 128 Mi."""
    assert tconfig.bicubic_pack_max_elems == 1 << 30
    assert tconfig.interpnd_pack_max_elems == 1 << 30
    assert jconfig.bicubic_pack_max_elems == 128 * 1024 * 1024
    for peak_over_table in (2.19, 2.0):
        assert peak_over_table * (1 << 30) * 8 <= 0.25 * 85_017_493_504


@pytest.mark.parametrize("shape,layout", [
    ((2048, 2048, 16), "cell"),  # between the JAX package's cap and this one
    ((1024, 1024, 16), "cell"),  # NS3e's grid (the JAX package: node)
    ((4096, 4096, 16), "node"),
    ((8193, 8193), "cell"),  # 8192 x 8192 x 16 = 2^30 cell elements
    ((8193, 8194), "node"),  # 2^30 + 2^17
])
def test_bicubic_layout_at_the_cap(shape, layout):
    assert t_bicubic.pick_layout(shape) == layout


def test_bicubic_layout_boundary(monkeypatch):
    cap = (12 - 1) * (10 - 1) * 16 * 3
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", cap)
    assert t_bicubic.pick_layout((12, 10, 3)) == "cell"
    assert t_bicubic.pick_layout((13, 10, 3)) == "node"
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", cap - 1)
    assert t_bicubic.pick_layout((12, 10, 3)) == "node"


def test_bicubic_between_the_caps_takes_the_cell_layout_matching_jax(monkeypatch, no_launch):
    """A grid whose cell table is over the JAX package's cap and under the
    port's (both caps scaled down to the CPU's size by the same factor, 8)
    builds the cell layout here and the node layout in JAX, with the JAX
    values within 1e-12 of their scale."""
    rng = np.random.default_rng(5)
    x, y = np.cumsum(rng.uniform(0.2, 1, 20)), np.cumsum(rng.uniform(0.2, 1, 16))
    z = rng.normal(size=(20, 16, 3))
    elems = 19 * 15 * 16 * 3
    monkeypatch.setattr(jconfig, "bicubic_pack_max_elems", elems // 2)
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", elems // 2 * 8)
    j = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).strategy(
        j2.Bicubic()).build()
    t = t2.Interp2D.builder(z, device="cpu").x(x).y(y).strategy(t2.Bicubic()).build()
    assert (j.strategy.layout, t.strategy.layout) == ("node", "cell")
    qx, qy = rng.uniform(x[0], x[-1], 500), rng.uniform(y[0], y[-1], 500)
    assert scale_err(t(torch.as_tensor(qx), torch.as_tensor(qy)),
                     j(jnp.asarray(qx), jnp.asarray(qy))) <= 1e-12


def test_interpnd_at_the_cap():
    """256^3 (ND2c's grid) takes the cell layout under the port's cap, and
    the linear corner rows stay packed up to 2^27 data elements in 3-D."""
    assert InterpND.pick_layout(3, (256, 256, 256), 1) == "cell"
    assert cell_elems((256, 256, 256), 1) <= tconfig.interpnd_pack_max_elems
    assert cell_elems((256, 256, 256), 2) > tconfig.interpnd_pack_max_elems
    assert InterpND.pick_layout(3, (256, 256, 256), 2) != "cell"
    assert (512**3) * 8 <= tconfig.interpnd_pack_max_elems < (512**3 + 1) * 8


# -- rule 5: the Bilinear grid route ------------------------------------------------------
def test_bilinear_grid_route_has_no_cap():
    """A float grid whose axes share its dtype takes ``BilinearPacked`` at
    any size (above the JAX package's 64 Mi elements here, on meta tensors),
    without packing the corner rows; integer data and axes of another
    dtype keep the search route."""
    nx, ny, r = 2304, 2048, 16
    s = t_bilinear.Bilinear().build(meta(nx), meta(ny), meta(nx, ny, r))
    assert type(s).__name__ == "BilinearPacked" and s._rows is None
    assert nx * ny * r > j_bilinear._PACK_MAX_ELEMS
    assert f"rows=({(nx - 1) * (ny - 1)}, {4 * r + 4})" in repr(s) and s._rows is None
    ints = meta(nx, ny, dtype=torch.int64)
    assert type(t_bilinear.Bilinear().build(meta(nx), meta(ny), ints)).__name__ == "Bilinear"
    f64 = meta(ny, dtype=torch.float64)
    assert type(t_bilinear.Bilinear().build(meta(nx), f64, meta(nx, ny))).__name__ == "Bilinear"


def test_bilinear_rows_are_packed_when_read(no_launch):
    """``rows`` is packed once, on the first read, and equals the JAX
    package's table bit for bit."""
    rng = np.random.default_rng(9)
    x, y = np.cumsum(rng.uniform(0.2, 1, 9)), np.cumsum(rng.uniform(0.2, 1, 7))
    z = rng.normal(size=(9, 7, 2, 3))
    t = t2.Interp2D.builder(z, device="cpu").x(x).y(y).build()
    assert t.strategy._rows is None
    rows = t.strategy.rows
    assert t.strategy.rows is rows
    want = j_bilinear.pack_corner_rows(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))


def test_bilinear_above_the_jax_cap_takes_the_grid_route_matching_jax(monkeypatch, no_launch):
    """With the JAX package's cap below the grid (as a grid above 64 Mi
    elements is), JAX takes the search route and the port R1 + R2g (their
    plain versions), the same values."""
    rng = np.random.default_rng(10)
    x, y = np.cumsum(rng.uniform(0.2, 1, 30)), np.cumsum(rng.uniform(0.2, 1, 20))
    z = rng.normal(size=(30, 20, 4))
    monkeypatch.setattr(j_bilinear, "_PACK_MAX_ELEMS", z.size - 1)
    j = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).build()
    t = t2.Interp2D.builder(z, device="cpu").x(x).y(y).build()
    assert (type(j.strategy).__name__, type(t.strategy).__name__) == ("Bilinear",
                                                                     "BilinearPacked")
    calls = spy(monkeypatch, t_bilinear, ("fused_cell_index", "lower_index_fast"))
    qx, qy = rng.uniform(x[0], x[-1], 700), rng.uniform(y[0], y[-1], 700)
    got = t(torch.as_tensor(qx), torch.as_tensor(qy))
    assert calls == ["fused_cell_index"]
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(qx), jnp.asarray(qy))),
                               rtol=1e-12, atol=1e-12)
