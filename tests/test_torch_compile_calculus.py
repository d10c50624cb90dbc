"""The port's calculus and ``InterpND``'s own programs under ``torch.compile``,
against the JAX package under ``jax.jit``, on the CPU.

Twins of the JAX package's jit tests of the calculus on the same seeded
inputs (``tests/test_calculus.py:118-127``, ``:292-299``, ``:496-509``,
``:678-690``, ``:840-850``; ``InterpND.derivative`` and ``integrate`` on
traced queries and bounds): each compiled call (``backend="aot_eager"``,
the kernels' plain versions) bit for bit the port's eager call, and within
``rtol=1e-12`` (scale-relative, the error over the largest |value|; f32 at
``test_torch_compile.py``'s ``rtol=2e-5``) of JAX's jitted result; the
compiled and eager calls reaching the same ops the same number of times
(``Runs``).  ``InterpND.integrate`` over traced bounds: compiled and under
``torch.func.vmap``, a reversed box included, as ``jax.jit`` of the JAX
``integrate`` gives it.

Then the three programs of ``models/interpnd.py``, the counterparts of the
JAX package's jitted ``_eval_flat``, ``_eval_flat_masked`` and
``_eval_flat_deriv``: each compiled on ``aot_eager``, bit for bit its eager
body and within tolerance of JAX's program; the JAX package's two others,
``_integrate_fn`` and ``_cubic_pack_fn``, whose bodies the port runs op by op,
compiled by the caller the same way.  The public calls routed through the
programs (``_runs_program`` patched to take CPU tensors as the card's), with
their gradients equal to eager's; no recompile across query lengths; more
variants of one call than Dynamo's recompile limit, each a program of its
own; the calls that run the body inline (traced, DTensor) compiling no
program; a CPU call compiles nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
import ndarray_interp_tpu.interpnd as jn
import ndarray_interp_tpu.models.interpnd as jmi
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.interp2d as t2
import ndarray_interp_tpu_torch.models.interpnd as tmi
import ndarray_interp_tpu_torch.serving as ts
from ndarray_interp_tpu.interp1d import cubic_spline as jcs
from ndarray_interp_tpu_torch.interp1d import cubic_spline as tcs
from ndarray_interp_tpu_torch.interpnd import InterpND
from ndarray_interp_tpu_torch.ops._cuda import traced
from test_torch_compile import Runs, same  # the op counter and the bit-for-bit check

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_dynamo():
    """Each test compiles from an empty Dynamo cache and no N-D program."""
    torch._dynamo.reset()
    tmi.clear_programs()
    yield
    torch._dynamo.reset()
    tmi.clear_programs()


def compiled(fn):
    """``fn`` compiled on ``aot_eager`` with a code object of its own
    (``serving.compile_program``), so that lambdas made in a loop do not
    share Dynamo's recompile count."""
    return ts.compile_program(fn, CPU)


def close(got, want, rtol=1e-12):
    """Within ``rtol`` of the largest |value| (NaN where NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.nanmax(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, equal_nan=True)


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


# -- 1-D --------------------------------------------------------------------------------
def case1d(n=20, bank=None, seed=5):
    """``tests/test_calculus.py:case``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=(n,) if bank is None else (n, bank))
    return x, y, np.linspace(x[0], x[-1], 7 * n)


STRATEGIES = ("CubicSpline", "Akima", "Makima", "Pchip", "Linear")
DTYPES = {"f64": (np.float64, 1e-12), "f32": (np.float32, 2e-5)}


def build1d(x, y, name, extrapolate=False, periodic=False):
    t = getattr(t1, name)().extrapolate(extrapolate)
    j = getattr(j1, name)().extrapolate(extrapolate)
    if periodic:
        t = t.boundary(tcs.BoundaryCondition.Periodic)
        j = j.boundary(jcs.BoundaryCondition.Periodic)
    return (t1.Interp1D.builder(y, device="cpu").x(x).strategy(t).build(),
            j1.Interp1D.builder(J(y)).x(J(x)).strategy(j).build())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", STRATEGIES)
def test_derivative_under_compile(name, dt):
    """``test_jit_and_query_dims`` (``test_calculus.py:118-127``) for the
    cubic-Hermite family and ``Linear``, orders 1-3 (K3): compiled, bit for
    bit eager and within the JAX test's ``rtol=1e-12`` (f32: 2e-5) of
    ``jax.jit(lambda t, p: t.derivative(p, order))``; query dims kept."""
    npdt, rtol = DTYPES[dt]
    x, y, q = case1d(seed=11)
    x, y, q = x.astype(npdt), y.astype(npdt), q.astype(npdt)
    t, j = build1d(x, y, name)
    for order in (1, 2, 3):
        got = compiled(lambda p: t.derivative(p, order=order))(T(q))
        same(got, t.derivative(T(q), order=order))
        want = jax.jit(lambda i, p: i.derivative(p, order=order))(j, J(q))
        close(got.numpy(), want, rtol)
    dims = compiled(lambda p: t.derivative(p))(T(q[:20].reshape(4, 5)))
    assert dims.shape == (4, 5)


INTEGRATE_1D = {
    # name: (strategy, extrapolate, periodic, bounds as fractions of the range)
    "not_a_knot": ("CubicSpline", False, False, (0.05, 0.95)),
    "reversed": ("CubicSpline", False, False, (0.9, 0.1)),
    "periodic": ("CubicSpline", True, True, (-1.3, 0.8)),
    "extrapolating": ("CubicSpline", True, False, (-0.15, 1.2)),
    "akima": ("Akima", True, False, (-0.1, 1.1)),
    "linear": ("Linear", True, False, (-0.07, 1.12)),
}


@pytest.mark.parametrize("case", list(INTEGRATE_1D))
def test_integrate_under_compile(case):
    """``test_jit_traced_bounds`` (``test_calculus.py:292-299``): tensor
    bounds compiled (K3), bit for bit eager and within 1e-12 of JAX's
    jitted integral; also a reversed pair, the periodic extension and the
    extrapolated edge polynomials."""
    name, extrap, periodic, (fa, fb) = INTEGRATE_1D[case]
    x, y, _ = case1d(seed=21)
    if periodic:
        y[-1] = y[0]
    t, j = build1d(x, y, name, extrap, periodic)
    lo, hi = (x[0] + f * (x[-1] - x[0]) for f in (fa, fb))
    a, b = T(lo), T(hi)
    got = compiled(lambda u, v: t.integrate(u, v))(a, b)
    same(got, t.integrate(a, b))
    close(got.numpy(), jax.jit(lambda i, u, v: i.integrate(u, v))(j, J(lo), J(hi)))


@pytest.mark.parametrize("name", ["CubicSpline", "Linear"])
def test_solve_under_compile(name):
    """``test_jit_and_vmap`` (``test_calculus.py:496-509``): ``roots()``
    compiled, the NaN-padded ``3*(n-1)`` rows bit for bit eager and within
    1e-12 of JAX's jitted roots; ``torch.func.vmap(lambda l: itp.solve(l))``
    over three levels compiled, each row equal to the eager ``solve`` and to
    JAX's vmapped rows."""
    x, y, _ = case1d(seed=40)
    t, j = build1d(x, y, name)
    roots = compiled(lambda: t.roots())()
    assert roots.shape == (3 * (len(x) - 1),)
    same(roots, t.roots())
    close(roots.numpy(), jax.jit(lambda i: i.roots())(j))
    lv = np.array([0.0, 0.1, 0.2])
    rows = compiled(lambda levels: torch.func.vmap(lambda l: t.solve(l))(levels))(T(lv))
    jrows = np.asarray(jax.vmap(lambda l: j.solve(l))(J(lv)))
    for i, level in enumerate(lv):
        same(rows[i], t.solve(float(level)))
        close(rows[i].numpy(), jrows[i])


def test_build_and_derivative_in_one_program():
    """``strategy.build`` + ``new_unchecked`` + ``derivative`` and
    ``integrate`` in one compiled program (K4 and K3), as the build twins of
    ``test_torch_compile.py`` (``Interp1D.builder``'s host checks outside,
    as under ``jax.jit``): bit for bit eager, within 1e-12 of JAX's jitted program."""
    x, y, q = case1d(bank=3, seed=11)
    xt, xj = T(x), J(x)

    def make(d, p):
        itp = t1.Interp1D.new_unchecked(xt, d, t1.CubicSpline().build(xt, d))
        return itp.derivative(p, order=2), itp.integrate(p[3], p[-5])

    def jmake(d, p):
        itp = j1.Interp1D.new_unchecked(xj, d, j1.CubicSpline().build(xj, d))
        return itp.derivative(p, order=2), itp.integrate(p[3], p[-5])

    got = compiled(make)(T(y), T(q))
    for g, w, jw in zip(got, make(T(y), T(q)), jax.jit(jmake)(J(y), J(q))):
        same(g, w)
        close(g.numpy(), jw)


# -- 2-D --------------------------------------------------------------------------------
def grid2d(seed):
    """A 9 x 8 grid on non-uniform axes with 3 channels, and 30 queries."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.0, 9))
    y = np.cumsum(rng.uniform(0.2, 1.0, 8))
    z = rng.normal(size=(9, 8, 3))
    return x, y, z, rng.uniform(x[0], x[-1], 30), rng.uniform(y[0], y[-1], 30)


def build2d(x, y, z, name):
    return (t2.Interp2D.builder(z, device="cpu").x(x).y(y).strategy(getattr(t2, name)()).build(),
            j2.Interp2D.builder(J(z)).x(J(x)).y(J(y)).strategy(getattr(j2, name)()).build())


@pytest.mark.parametrize("name", ["Bicubic", "Bilinear"])
def test_derivative2d_under_compile(name):
    """``test_jit_query_dims_and_value_parity`` (``test_calculus.py:678-690``):
    ``derivative(dx=1, dy=1)`` compiled (K2 for ``Bicubic``, K3 for
    ``Bilinear``), bit for bit eager and within 1e-12 of JAX's jitted
    call; query dims kept."""
    x, y, z, qx, qy = grid2d(seed=56)
    t, j = build2d(x, y, z, name)
    got = compiled(lambda a, b: t.derivative(a, b, dx=1, dy=1))(T(qx), T(qy))
    same(got, t.derivative(T(qx), T(qy), dx=1, dy=1))
    close(got.numpy(), jax.jit(lambda i, a, b: i.derivative(a, b, dx=1, dy=1))(j, J(qx), J(qy)))
    dims = compiled(lambda a, b: t.derivative(a, b, dx=1))(T(qx[:12].reshape(3, 4)),
                                                          T(qy[:12].reshape(3, 4)))
    assert dims.shape == (3, 4, 3)


@pytest.mark.parametrize("name", ["Bicubic", "Bilinear"])
def test_integrate2d_under_compile(name):
    """``test_jit_traced_bounds`` (``test_calculus.py:840-850``): the box
    over traced bounds compiled (``Bicubic``: K4, the grid solved again),
    bit for bit eager and within 1e-12 of JAX's jitted integral."""
    x, y, z, _, _ = grid2d(seed=66)
    t, j = build2d(x, y, z, name)
    box = (x[1] + 0.3, x[-2] - 0.2, y[1] + 0.1, y[-2])
    got = compiled(lambda *b: t.integrate(*b))(*map(T, box))
    same(got, t.integrate(*map(T, box)))
    close(got.numpy(), jax.jit(lambda *b: j.integrate(*b))(*map(J, box)))


# -- N-D --------------------------------------------------------------------------------
def grid_nd(k, seed, trailing=()):
    """``tests/test_interpnd.py:_grid_case``, axes from -4 to 4."""
    rng = np.random.default_rng(seed)
    axes = [np.concatenate([[-4.0], np.sort(rng.uniform(-4.0, 4.0, n - 2)), [4.0]])
            for n in [5, 4, 6, 4][:k]]
    data = rng.normal(size=tuple(len(a) for a in axes) + tuple(trailing))
    qs = [rng.uniform(-4.0, 4.0, 24) for _ in axes]
    return axes, data, qs


# method, layout, k, derivative orders
ND_CASES = {"linear": ("linear", None, 3, (1, 0, 1)), "cell": ("cubic", "cell", 2, (1, 2)),
            "node": ("cubic", "node", 2, (2, 1)), "node2": ("cubic", "node2", 3, (1, 0, 3)),
            "node4": ("cubic", "node4", 3, (0, 1, 2))}


def build_nd(axes, data, method, layout=None, extrapolate=False):
    t = InterpND.builder(data, device="cpu").points(*axes).method(method).extrapolate(extrapolate)
    j = jn.InterpND.builder(J(data)).points(*map(J, axes)).method(method).extrapolate(extrapolate)
    if layout is not None:
        t, j = t.layout(layout), j.layout(layout)
    return t.build(), j.build()


@pytest.mark.parametrize("case", list(ND_CASES))
def test_interpnd_derivative_under_compile(case):
    """``InterpND.derivative`` on traced queries (``interpnd.py:800-826`` of
    the JAX package), linear and cubic in every layout, with a channel
    axis: compiled (K2 on each axis), bit for bit eager and within 1e-12 of
    ``jax.jit(lambda i, *q: i.derivative(*q, orders=...))``."""
    method, layout, k, orders = ND_CASES[case]
    axes, data, qs = grid_nd(k, seed=61, trailing=(2,))
    t, j = build_nd(axes, data, method, layout)
    assert t.layout == layout
    tq = [T(q) for q in qs]
    got = compiled(lambda *q: t.derivative(*q, orders=orders))(*tq)
    same(got, t.derivative(*tq, orders=orders))
    close(got.numpy(), jax.jit(lambda i, *q: i.derivative(*q, orders=orders))(j, *map(J, qs)))


BOXES = (((-3.1, 2.2), (-1.5, 3.9), (0.4, -2.6)),  # the last axis reversed
         ((2.7, -3.3), (3.0, -0.5), (-1.0, 1.0)))  # two reversed


@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_interpnd_integrate_traced_bounds(method):
    """The repair of ``InterpND.integrate`` under a trace: with tensor
    bounds the host reads (``float()``, the swap of a reversed pair, the
    range check) are skipped, as the JAX package skips them on tracers, so
    ``torch.compile(fullgraph=True)`` and ``torch.func.vmap`` over the
    bounds both trace it (on the parent both raised: ``Could not guard on
    data-dependent expression``).  A reversed traced box integrates to the
    signed value directly, within 1e-12 of ``jax.jit`` of the JAX
    ``integrate`` on the same reversed box and of the eager call."""
    axes, data, _ = grid_nd(3, seed=71)
    t, j = build_nd(axes, data, method)
    fn = compiled(lambda b: t.integrate(*((b[d, 0], b[d, 1]) for d in range(3))))
    jfn = jax.jit(lambda b: j.integrate(*((b[d, 0], b[d, 1]) for d in range(3))))
    boxes = np.array(BOXES)
    rows = torch.func.vmap(lambda b: t.integrate(*((b[d, 0], b[d, 1]) for d in range(3))))(
        T(boxes))
    for i, box in enumerate(boxes):
        got = fn(T(box))
        want = jfn(J(box))
        close(got.numpy(), want)
        close(rows[i].numpy(), want)
        close(got.numpy(), t.integrate(*map(tuple, box)).numpy())
    vrows = compiled(lambda bs: torch.func.vmap(
        lambda b: t.integrate(*((b[d, 0], b[d, 1]) for d in range(3))))(bs))(T(boxes))
    same(vrows, rows)


def test_interpnd_build_and_derivative_in_one_program():
    """``InterpND.build_state`` + ``new_unchecked`` + ``derivative`` and
    ``integrate`` in one compiled program (the cubic pack inline: K4; K2),
    bit for bit eager and within 1e-12 of JAX's jitted program."""
    axes, data, qs = grid_nd(2, seed=73)
    bcs = ("natural", "not_a_knot")
    ta, ja = tuple(map(T, axes)), tuple(map(J, axes))

    def make(d, lo, hi, *q):
        table, layout = InterpND.build_state(ta, d, 2, "cubic", bcs)
        itp = InterpND.new_unchecked(ta, d, "cubic", False, table, bcs, layout)
        return itp.derivative(*q, orders=(1, 1)), itp.integrate((lo, hi), (-3.0, 3.5))

    def jmake(d, lo, hi, *q):
        table, layout = jn.InterpND.build_state(ja, d, 2, "cubic", bcs)
        itp = jn.InterpND.new_unchecked(ja, d, "cubic", False, table, bcs, layout)
        return itp.derivative(*q, orders=(1, 1)), itp.integrate((lo, hi), (-3.0, 3.5))

    args = (T(data), T(-2.5), T(1.5), *map(T, qs))
    got = compiled(make)(*args)
    for g, w, jw in zip(got, make(*args), jax.jit(jmake)(J(data), J(-2.5), J(1.5),
                                                         *map(J, qs))):
        same(g, w)
        close(g.numpy(), jw)


def test_compiled_calculus_reaches_the_same_ops(monkeypatch):
    """Each compiled calculus call runs each kernel op as often as its
    eager call: K3 for the 1-D derivative and integral and the ``Bilinear``
    derivative, K2 for the ``Bicubic`` and N-D derivatives, K4 for the
    ``Bicubic`` and N-D integrals (the grids solved again) and the build."""
    runs = Runs(monkeypatch)
    x, y, q = case1d(bank=2, seed=7)
    itp1, _ = build1d(x, y, "CubicSpline", extrapolate=True)
    x2, y2, z2, qx, qy = grid2d(seed=8)
    bic, _ = build2d(x2, y2, z2, "Bicubic")
    bil, _ = build2d(x2, y2, z2, "Bilinear")
    axes, data, qs = grid_nd(2, seed=9)
    nd, _ = build_nd(axes, data, "cubic")
    xt = T(x)
    cases = {
        "1-D derivative": (lambda p: itp1.derivative(p), (T(q),), {"fused_lower_index"}),
        "1-D integrate": (lambda a, b: itp1.integrate(a, b), (T(x[1]), T(x[-3])),
                          {"fused_lower_index"}),
        "Bicubic derivative": (lambda a, b: bic.derivative(a, b, dx=1, dy=1), (T(qx), T(qy)),
                               {"fused_index_frac"}),
        "Bilinear derivative": (lambda a, b: bil.derivative(a, b, dx=1), (T(qx), T(qy)),
                                {"fused_lower_index"}),
        "Bicubic integrate": (lambda *b: bic.integrate(*b), tuple(map(T, (x2[1], x2[-2], y2[0],
                                                                          y2[-1]))),
                              {"thomas_solve_fast"}),
        "N-D derivative": (lambda *p: nd.derivative(*p, orders=(0, 1)), tuple(map(T, qs)),
                           {"fused_index_frac"}),
        "N-D integrate": (lambda a, b: nd.integrate((a, b), (-4.0, 2.0)), (T(-3.0), T(3.0)),
                          {"thomas_solve_fast"}),
        "build + derivative": (lambda d, p: t1.Interp1D.new_unchecked(
            xt, d, t1.CubicSpline().build(xt, d)).derivative(p), (T(y), T(q)),
            {"thomas_solve_fast", "fused_lower_index"}),
    }
    for label, (fn, args, expect) in cases.items():
        runs.take()
        want = fn(*args)
        eager = runs.take()
        got = compiled(fn)(*args)
        assert runs.take() == eager, label
        assert set(eager) == expect, (label, eager)
        same(got, want)


# -- InterpND's own programs ------------------------------------------------------------
def statics(itp):
    return itp.method, itp.extrapolates, itp.bcs, itp.layout


@pytest.mark.parametrize("case", list(ND_CASES))
def test_eval_programs_are_their_body(case):
    """``_eval_flat``, ``_eval_flat_masked`` and ``_eval_flat_deriv`` of
    each method and layout compiled on ``aot_eager``: bit for bit the eager
    body (``_eval_flat_body``), and within 1e-12 of the JAX package's
    jitted program of the same name on the same interpolator; out-of-range
    queries NaN in the masked one."""
    method, layout, k, orders = ND_CASES[case]
    axes, data, qs = grid_nd(k, seed=81, trailing=(3,))
    qs[0][:4] = [-4.5, 4.5, 0.0, np.nan]  # out of range and NaN in the masked program
    t, j = build_nd(axes, data, method, layout)
    st = statics(t)
    flats = list(map(T, qs))
    args = (t.axes, t.data, t.table, *flats)
    key = tmi._signature(t.axes, t.data, t.table, flats)
    for masked, order, program, jprogram in (
            (False, None, tmi._eval_flat(st, key), lambda *q: jmi._eval_flat(j, *q)),
            (True, None, tmi._eval_flat_masked(st, key), lambda *q: jmi._eval_flat_masked(j, *q)),
            (False, orders, tmi._eval_flat_deriv(st, orders, key),
             lambda *q: jmi._eval_flat_deriv(j, orders, *q))):
        got = program(*args)
        same(got, tmi._eval_flat_body(st, order, masked, *args))
        close(got.numpy(), jprogram(*map(J, qs)))
    assert bool(torch.isnan(tmi._eval_flat_masked(st, key)(*args)[:2]).all())


@pytest.mark.parametrize("method,bcs,extrapolate", [
    ("cubic", ("not_a_knot", "clamped", "natural"), False), ("cubic", ("natural",) * 3, True),
    ("linear", None, False)])
def test_integrate_box_compiles_to_its_body(method, bcs, extrapolate):
    """``integrate_box``, the body of the JAX package's ``_integrate_fn(k,
    bcs, method, extrapolate)`` program, compiled by the caller: bit for bit
    its eager call on boxes with reversed axes and, extrapolating, ends past
    the grid; within 1e-12 of the JAX package's program."""
    axes, data, _ = grid_nd(3, seed=83, trailing=(2,))
    ta, ja = tuple(map(T, axes)), tuple(map(J, axes))
    program = compiled(lambda *a: tmi.integrate_box(*a, method, bcs, extrapolate))
    jprogram = jmi._integrate_fn(3, bcs, method, extrapolate)
    for box in BOXES + (((-4.5, 4.2), (-4.0, 4.0), (3.9, -4.1)),) * extrapolate:
        los, his = T([b[0] for b in box]), T([b[1] for b in box])
        got = program(ta, T(data), los, his)
        same(got, tmi.integrate_box(ta, T(data), los, his, method, bcs, extrapolate))
        close(got.numpy(), jprogram(ja, J(data), J([b[0] for b in box]), J([b[1] for b in box])))


@pytest.mark.parametrize("layout,k", [("cell", 2), ("node", 2), ("node2", 3), ("node4", 3)])
def test_cubic_pack_compiles_to_its_body(layout, k):
    """``InterpND.build_state``'s cubic pack, the body of the JAX package's
    ``_cubic_pack_fn(k, bcs, layout)`` program (the ``2^k`` mixed-derivative
    solves, K4, and the pack), compiled by the caller: bit for bit its eager
    call and within 1e-12 of the JAX package's program."""
    axes, data, _ = grid_nd(k, seed=85, trailing=(2,))
    bcs = ("clamped", "not_a_knot", "natural")[:k]
    ta = tuple(map(T, axes))

    def pack(d):
        return InterpND.build_state(ta, d, k, "cubic", bcs, layout)[0]

    got = compiled(pack)(T(data))
    same(got, pack(T(data)))
    close(got.numpy(), jmi._cubic_pack_fn(k, bcs, layout)(tuple(map(J, axes)), J(data)))


@pytest.fixture
def as_on_card(monkeypatch):
    """Route the public calls to the programs as on the card: a CPU tensor
    runs its program too (``aot_eager``), traced ones still run inline."""
    monkeypatch.setattr(tmi, "_runs_program",
                        lambda *ts_: not any(traced(t) for t in ts_ if t is not None))


def cache_sizes():
    return [g.cache_info().currsize for g in tmi.PROGRAMS]


# the public calls' cases: ND_CASES's, at k = 2 where the layout allows it; the
# gradients taken in the queries and the data (True: through the eager cubic
# pack and the eval program), in the queries only (False) or not at all (None)
PUBLIC = {
    "linear": ("linear", None, 3, (1, 0, 1), True),
    "cell": ("cubic", "cell", 2, (1, 2), True),
    "node": ("cubic", "node", 2, (2, 1), False),
    "node2": ("cubic", "node2", 2, (0, 3), None),
    "node4": ("cubic", "node4", 3, (0, 1, 2), None),
}


@pytest.mark.parametrize("case", list(PUBLIC))
def test_public_calls_run_the_programs(case, as_on_card):
    """The plain API as on the card: ``__call__``, ``eval_unchecked``,
    ``interp_array`` and ``derivative`` each through its program, bit for
    bit the eager calls; the build and ``integrate`` op by op, asking for no
    program; the gradients of ``__call__`` and ``derivative`` (AOTAutograd)
    equal to eager's, in the queries (linear, cell, node) and the data
    (linear, cell: through the eager cubic pack)."""
    method, layout, k, orders, data_grad = PUBLIC[case]
    axes, data, qs = grid_nd(k, seed=87)
    with torch.compiler.set_stance("force_eager"):  # jax.disable_jit: every body eager
        want_itp, _ = build_nd(axes, data, method, layout)
    got_itp, _ = build_nd(axes, data, method, layout)
    assert cache_sizes() == [0, 0, 0]
    if method == "cubic":
        same(got_itp.table, want_itp.table)
    tq = [T(q) for q in qs]
    box = tuple((a[1], a[-2]) for a in axes)
    calls = {"__call__": lambda i, *q: i(*q), "eval_unchecked": lambda i, *q: i.eval_unchecked(*q),
             "interp_array": lambda i, *q: i.interp_array(*q),
             "derivative": lambda i, *q: i.derivative(*q, orders=orders)}
    for name, call in calls.items():
        with torch.compiler.set_stance("force_eager"):
            want = call(want_itp, *tq)
        same(call(got_itp, *tq), want)
    assert all(n >= 1 for n in cache_sizes())
    sizes = cache_sizes()
    with torch.compiler.set_stance("force_eager"):
        want = want_itp.integrate(*box)
    same(got_itp.integrate(*box), want)
    assert cache_sizes() == sizes
    for name in ("__call__", "derivative") if data_grad is not None else ():
        grads = []
        for stance in ("force_eager", "default"):
            with torch.compiler.set_stance(stance):
                d = T(data).requires_grad_(data_grad)
                table, lay = InterpND.build_state(got_itp.axes, d, k, method, got_itp.bcs, layout)
                itp = InterpND.new_unchecked(got_itp.axes, d, method, False, table, got_itp.bcs,
                                             lay)
                leaves = [q.clone().requires_grad_(True) for q in tq]
                out = calls[name](itp, *leaves)
                wrt = [*leaves, itp.data] if data_grad else leaves
                grads.append(torch.autograd.grad((out * out).sum(), wrt, allow_unused=True))
        for g, w in zip(*grads):
            if w is None:
                assert g is None
            else:
                same(g, w)


def test_no_recompile_across_query_lengths(as_on_card):
    """The query axis is dynamic: after two calls of each program, calls of
    other query lengths run under ``fail_on_recompile``, bit for bit the
    eager calls."""
    axes, data, _ = grid_nd(2, seed=89)
    itp, _ = build_nd(axes, data, "cubic")
    rng = np.random.default_rng(3)

    def calls(n):
        qs = [T(rng.uniform(-4.0, 4.0, n)) for _ in axes]
        return (itp(*qs), itp.eval_unchecked(*qs), itp.derivative(*qs, orders=(0, 1)))

    for n in (17, 40):
        calls(n)
    with torch.compiler.set_stance("fail_on_recompile"):
        for n in (2, 33, 1000):
            rng = np.random.default_rng(n)
            got = calls(n)
            rng = np.random.default_rng(n)
            with torch.compiler.set_stance("force_eager"):
                want = calls(n)
            for g, w in zip(got, want):
                same(g, w)


@pytest.mark.parametrize("method,layout", [("linear", None), ("cubic", "cell"),
                                           ("cubic", "node")])
def test_no_recompile_across_grid_sizes(method, layout, as_on_card):
    """The grid's sizes are dynamic too (``_dynamic_grid``): after the first
    grid, interpolators on grids of other sizes run every program under
    ``fail_on_recompile``, equal to their eager calls."""
    rng = np.random.default_rng(97)

    def calls(shape, n):
        axes = [np.concatenate([[-4.0], np.sort(rng.uniform(-4.0, 4.0, m - 2)), [4.0]])
                for m in shape]
        itp, _ = build_nd(axes, rng.normal(size=shape), method, layout)
        qs = [T(rng.uniform(-4.0, 4.0, n)) for _ in shape]
        out = (itp(*qs), itp.eval_unchecked(*qs), itp.derivative(*qs, orders=(1, 0)))
        with torch.compiler.set_stance("force_eager"):
            for g, w in zip(out, (itp(*qs), itp.eval_unchecked(*qs),
                                  itp.derivative(*qs, orders=(1, 0)))):
                same(g, w)

    calls((5, 4), 24)
    with torch.compiler.set_stance("fail_on_recompile"):
        calls((9, 7), 30)
        calls((12, 6), 50)


def test_more_variants_than_the_recompile_limit(as_on_card):
    """More variants of one public call than Dynamo's recompile limit
    (``torch._dynamo.config.recompile_limit``): linear interpolators of
    k = 1..3 axes, a trailing axis on every other k, with and without a
    table, their queries with and without gradients.  Each variant is a
    program of its own (``_signature``), so none of them raises, and each
    equals its eager call."""
    variants = 0
    for k in range(1, 4):
        axes, data, qs = grid_nd(k, seed=95 + k, trailing=(2,) * (k % 2))
        built = InterpND.builder(data, device="cpu").points(*axes).build()
        for table in (built.table, None):
            itp = InterpND.new_unchecked(built.axes, built.data, "linear", False, table)
            for grad in (False, True):
                tq = [T(q).requires_grad_(grad) for q in qs]
                got = itp(*tq)
                with torch.compiler.set_stance("force_eager"):
                    same(got, itp(*tq))
                variants += 1
    assert variants > torch._dynamo.config.recompile_limit
    assert cache_sizes()[1] == variants


def test_inline_calls_compile_no_program(as_on_card, monkeypatch):
    """As a nested ``jax.jit`` is inlined, the body runs inline under an
    outer ``torch.compile`` (one graph), a ``torch.func`` transform and for
    DTensor queries (``local_call`` on each rank's shard): no program is
    made, and each call equals its eager one."""
    axes, data, qs = grid_nd(2, seed=91)
    tq = [T(q) for q in qs]
    with torch.compiler.set_stance("force_eager"):
        itp, _ = build_nd(axes, data, "cubic")
        want = itp(*tq)
    tmi.clear_programs()
    same(compiled(lambda *q: itp(*q))(*tq), want)
    same(torch.func.vmap(itp)(*(q.reshape(4, 6) for q in tq)).reshape(-1), want)
    monkeypatch.setattr(tmi, "is_dtensor", lambda c: True)
    monkeypatch.setattr(tmi, "local_call", lambda fn, *cs: fn(*cs))
    same(itp(*tq), want)
    assert cache_sizes() == [0] * 3


def test_a_cpu_call_compiles_nothing():
    """On CPU tensors (unpatched) the bodies run eagerly: no program is
    made and Dynamo captures no graph."""
    from torch._dynamo.utils import counters

    graphs = counters["stats"]["unique_graphs"]
    axes, data, qs = grid_nd(3, seed=93)
    itp, _ = build_nd(axes, data, "cubic")
    tq = [T(q) for q in qs]
    itp(*tq)
    itp.derivative(*tq, orders=(1, 0, 0))
    itp.integrate((-1.0, 1.0), (-2.0, 2.0), (0.0, 3.0))
    assert cache_sizes() == [0] * 3
    assert counters["stats"]["unique_graphs"] == graphs
