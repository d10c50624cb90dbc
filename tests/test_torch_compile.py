"""The port under ``torch.compile``, against the JAX package under
``jax.jit``, on the CPU.

The f32/f64 kernels are operators of the ``ndarray_interp`` namespace
(``ops.kernel_ops``), so ``torch.compile(fullgraph=True)`` traces the public
calls with no graph break.  Here the graph runs on ``backend="aot_eager"``
(PyTorch's CPU operators, the kernels' plain versions; inductor is the card's
backend).  Twins of the JAX package's ``jax.jit`` tests, on the same seeded
inputs: the 1-D and 2-D eval (``test_interp2d.py:224``,
``test_strategies.py:237``, ``:270``, ``:382``, ``:453``), the three
builds under jit (``test_cubic_spline.py:380-470``) and ``test_checkify_1d``
(``test_transforms.py:30-48``), each held against JAX's jitted result at the
JAX test's tolerance and against the port's eager call bit for bit (the
graphs here hold the ops, copies, selects and the build's arithmetic, which
``aot_eager`` runs on the same CPU operators as the eager call).  Then
``torch.library.opcheck`` on every op, with and without gradients; the
compiled and eager calls reaching the same op implementations the same
number of times (on the card, the same launches); ``Evaluator`` and
``Evaluator2D`` after ``warmup()`` serving every bucket under
``torch.compiler.set_stance("fail_on_recompile")``; and a trace that breaks
raising rather than falling back to eager.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
from ndarray_interp_tpu.interp1d import cubic_spline as jcs
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.interp2d as t2
import ndarray_interp_tpu_torch.serving as ts
from ndarray_interp_tpu_torch.examples import custom_strategy as tex
from ndarray_interp_tpu_torch.interp1d import cubic_spline as tcs
from ndarray_interp_tpu_torch.models.strategies.base import Interp1DStrategy
from ndarray_interp_tpu_torch.ops import _cuda, kernel_ops
from ndarray_interp_tpu_torch.ops.eval_kernels import make_interval_table

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import custom_strategy as jex  # noqa: E402  (the JAX package's example)


@pytest.fixture(autouse=True)
def fresh_dynamo():
    """Each test compiles from an empty Dynamo cache, so no test's programs
    count against another's recompile limit."""
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def compiled(fn):
    return torch.compile(fn, fullgraph=True, backend="aot_eager")


def same(got, want):
    """Bit for bit, NaN where NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


# -- the 1-D eval ------------------------------------------------------------------------
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("method", ["__call__", "eval_unchecked", "interp_array"])
def test_cubic_eval_under_compile(method, dt):
    """``jax.jit(lambda t, q: t(q))`` on a 64-knot not-a-knot spline bank
    and scalar data (K1, K2 + R2a / K5): bit for bit the eager call, and
    JAX's jitted values (``atol=1e-14`` in f64, the JAX tests' own; f32
    ``rtol=2e-5``, ``test_torch_transforms.py``'s)."""
    npdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(7)
    x = np.cumsum(rng.uniform(0.1, 1.0, 64)).astype(npdt)
    # out of range queries too, except for the eager-checked interp_array
    lo, hi = (x[0], x[-1]) if method == "interp_array" else (x[0] - 2, x[-1] + 2)
    q = rng.uniform(lo, hi, 300).astype(npdt)
    tol = dict(atol=1e-14) if dt == "f64" else dict(rtol=2e-5, atol=2e-5)
    for shape in ((64,), (64, 3)):
        y = rng.normal(size=shape).astype(npdt)
        t = t1.Interp1D.builder(y, device="cpu").x(x).strategy(tcs.CubicSpline()).build()
        j = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)).strategy(
            jcs.CubicSpline()).build()
        qt = torch.as_tensor(q)
        got = compiled(lambda q_: getattr(t, method)(q_))(qt)
        same(got, getattr(t, method)(qt))
        jfn = jax.jit(lambda t_, q_: getattr(t_, method)(q_) if method != "interp_array"
                      else t_(q_))
        want = np.asarray(jfn(j, jnp.asarray(q)))
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, **tol)


def test_checkify_1d_under_compile():
    """``test_checkify_1d``: ``eval_checked`` compiled returns the
    ``CheckError`` of device flags, which throws only for the out-of-range
    batch, and the eager call's values."""
    t = t1.Interp1D.builder(np.array([1.0, 2.0, 3.0]), device="cpu").build()
    j = j1.Interp1D.builder(jnp.array([1.0, 2.0, 3.0])).build()
    fn = compiled(lambda q: t.eval_checked(q))
    jfn = jax.jit(lambda t_, q: t_.eval_checked(q))
    for q, bad in (([0.5, 1.5], False), ([0.5, 99.0], True)):
        err, out = fn(torch.tensor(q, dtype=torch.float64))
        same(out, t.eval_checked(torch.tensor(q, dtype=torch.float64))[1])
        jerr, jout = jfn(j, jnp.asarray(q))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-15)
        assert (err.get() is not None) == bad == (jerr.get() is not None)
        if bad:
            with pytest.raises(Exception, match="not in range"):
                err.throw()
        else:
            err.throw()


# -- the builds under compile ------------------------------------------------------------
def _arrays():
    # the encoding of test_individual_boundaries_build_under_jit: 0 = NAK,
    # 1 = first derivative, 2 = second derivative
    return ([0, 2, 1, 1], [0.0, 0.0, 0.5, 0.0], [0, 2, 2, 1], [0.0, 0.0, -1.0, 0.0])


BUILDS = {
    # JAX test: (x, data shape, seed, queries, periodic data, boundary, atol)
    "not_a_knot": (np.linspace(0.0, 1.0, 16), (16, 4), 3, np.linspace(0.0, 1.0, 11), False,
                   None, 1e-14),
    "periodic": (np.linspace(0.0, 1.0, 12), (12, 3), 7, np.linspace(-0.3, 1.3, 9), True,
                 "Periodic", 1e-14),
    "individual": (np.linspace(0.0, 2.0, 10), (10, 4), 11, np.linspace(-0.2, 2.2, 13), False,
                   "IndividualArrays", 1e-12),
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_build_under_compile(case):
    """``test_build_under_jit``, ``test_periodic_build_under_jit`` and
    ``test_individual_boundaries_build_under_jit``: ``strategy.build`` +
    ``new_unchecked`` + the call in one compiled program (K4 and K2 +
    R2a), the periodic first==last check skipped while tracing as under
    ``jax.jit``; bit for bit the eager build and call, and JAX's jitted
    build at the JAX test's tolerance."""
    x, shape, seed, q, periodic, bc, atol = BUILDS[case]
    data = np.random.default_rng(seed).normal(size=shape)
    if periodic:
        data[-1] = data[0]

    def strategy(m, arrays):
        s = m.CubicSpline().extrapolate(True)
        if bc == "Periodic":
            s = s.boundary(m.BoundaryCondition.Periodic)
        elif bc == "IndividualArrays":
            s = s.boundary(m.BoundaryCondition.IndividualArrays(*arrays))
        return s

    tarr = [torch.tensor(v, dtype=torch.int32 if i % 2 == 0 else torch.float64)
            for i, v in enumerate(_arrays())]
    xt = torch.as_tensor(x)

    def make(d, q_):
        s = strategy(tcs, tarr).build(xt, d)
        return t1.Interp1D.new_unchecked(xt, d, s)(q_)

    dt, qt = torch.as_tensor(data), torch.as_tensor(q)
    got = compiled(make)(dt, qt)
    same(got, make(dt, qt))
    jarr = [jnp.asarray(np.asarray(v, dtype=np.int32 if i % 2 == 0 else np.float64))
            for i, v in enumerate(_arrays())]

    @jax.jit
    def jmake(d, q_):
        s = strategy(jcs, jarr).build(jnp.asarray(x), d)
        return j1.Interp1D.new_unchecked(jnp.asarray(x), d, s)(q_)

    np.testing.assert_allclose(got.numpy(), np.asarray(jmake(jnp.asarray(data), jnp.asarray(q))),
                               atol=atol)


# -- the other strategies' jit twins -----------------------------------------------------
def _case(seed, n=20, bank=None):
    """``tests/test_strategies.py:case``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=(n,) if bank is None else (n, bank))
    return x, y, np.linspace(x[0], x[-1], 7 * n)


def test_pchip_under_compile():
    """``TestPchip.test_jit_and_grad`` (``test_strategies.py:237``)."""
    x, y, q = _case(seed=3, bank=5)
    t = t1.Interp1D.builder(y, device="cpu").x(x).strategy(t1.Pchip().extrapolate(True)).build()
    j = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)).strategy(
        j1.Pchip().extrapolate(True)).build()
    qt = torch.as_tensor(q)
    got = compiled(lambda q_: t(q_))(qt)
    same(got, t(qt))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(lambda t_, q_: t_(q_))(
        j, jnp.asarray(q))), atol=1e-14)


def test_custom_strategies_agree_under_compile():
    """``test_pointwise_and_batched_agree_under_jit``
    (``test_strategies.py:270``): the pointwise strategy (``torch.func.vmap``
    of ``eval_point``) and the batched one, compiled, equal each other, the
    eager calls and the JAX example's jitted values."""
    data = np.random.default_rng(0).normal(size=(10, 3))
    q = np.linspace(0.0, 9.0, 40)
    got = []
    for tcls, jcls in ((tex.StepInterpolator, jex.StepInterpolator),
                       (tex.StepInterpolatorBatched, jex.StepInterpolatorBatched)):
        t = t1.Interp1D.builder(data, device="cpu").strategy(tcls()).build()
        j = j1.Interp1D.builder(jnp.asarray(data)).strategy(jcls()).build()
        qt = torch.as_tensor(q)
        out = compiled(lambda q_: t(q_))(qt)
        same(out, t(qt))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jax.jit(lambda t_, q_: t_(q_))(
            j, jnp.asarray(q))))
        got.append(out)
    same(got[0], got[1])


def test_nearest_under_compile():
    """``TestNearest.test_jit_vmap_and_pytree`` (``test_strategies.py:382``):
    the compiled call and the compiled ``vmap`` over 4 rows."""
    x, y, q = _case(seed=13)
    t = t1.Interp1D.builder(y, device="cpu").x(x).strategy(
        t1.Nearest("nearest-up", extrapolate=True)).build()
    j = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)).strategy(
        j1.Nearest("nearest-up", extrapolate=True)).build()
    qt = torch.as_tensor(q)
    direct = t(qt)
    same(compiled(lambda q_: t(q_))(qt), direct)
    same(compiled(lambda q_: torch.func.vmap(t)(q_))(qt.reshape(4, -1)).reshape(-1), direct)
    np.testing.assert_array_equal(direct.numpy(), np.asarray(jax.jit(lambda t_, q_: t_(q_))(
        j, jnp.asarray(q))))


def test_nearest2d_under_compile():
    """``TestNearest2D.test_jit_matches_eager`` (``test_strategies.py:453``)."""
    rng = np.random.default_rng(27)
    z = rng.normal(size=(9, 7))
    t = t2.Interp2D.builder(z, device="cpu").strategy(t2.Nearest2D(extrapolate=True)).build()
    j = j2.Interp2D.builder(jnp.asarray(z)).strategy(j2.Nearest2D(extrapolate=True)).build()
    qx, qy = rng.uniform(0, 8, 50), rng.uniform(0, 6, 50)
    a, b = torch.as_tensor(qx), torch.as_tensor(qy)
    got = compiled(lambda u, v: t(u, v))(a, b)
    same(got, t(a, b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(lambda t_, u, v: t_(u, v))(
        j, jnp.asarray(qx), jnp.asarray(qy))))


# -- the 2-D eval ------------------------------------------------------------------------
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("strategy", ["Bilinear", "Bicubic"])
def test_interp2d_under_compile(strategy, dt):
    """``test_jit_vmap_2d`` (``test_interp2d.py:224``) for ``Bilinear``
    (R1 + R2g) and the ``Bicubic`` cell layout (R1 + R2n) on non-uniform
    axes: the compiled call (the out-of-range mask included) and the
    compiled ``vmap`` over 4 rows, bit for bit the eager call, and JAX's
    jitted values (``atol=1e-15`` scaled as the JAX test's in f64; f32
    ``rtol=2e-5``)."""
    npdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(31)
    x = np.cumsum(rng.uniform(0.2, 1.0, 8)).astype(npdt)
    y = np.cumsum(rng.uniform(0.2, 1.0, 8)).astype(npdt)
    z = rng.normal(size=(8, 8, 3)).astype(npdt)
    qx = np.linspace(x[0] - 0.5, x[-1], 32).astype(npdt)
    qy = np.linspace(y[-1], y[0], 32).astype(npdt)
    t = t2.Interp2D.builder(z, device="cpu").x(x).y(y).strategy(
        getattr(t2, strategy)()).build()
    j = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).strategy(
        getattr(j2, strategy)()).build()
    assert strategy == "Bilinear" or t.strategy.layout == "cell"
    a, b = torch.as_tensor(qx), torch.as_tensor(qy)
    got = compiled(lambda u, v: t(u, v))(a, b)
    same(got, t(a, b))
    rows = compiled(lambda u, v: torch.func.vmap(t)(u, v))(a.reshape(4, 8), b.reshape(4, 8))
    same(rows.reshape(got.shape), got)
    want = np.asarray(jax.jit(lambda t_, u, v: t_(u, v))(j, jnp.asarray(qx), jnp.asarray(qy)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    tol = dict(atol=1e-14) if dt == "f64" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, **tol)


# -- the ops -----------------------------------------------------------------------------
def op_samples():
    """A small CPU sample of every op's arguments, by op name (the R2b-R2n
    op once per form, K4's in both of its forms)."""
    rng = np.random.default_rng(5)

    def T(*shape):
        return torch.as_tensor(rng.normal(size=shape))

    def ints(hi, n=20):
        return torch.as_tensor(rng.integers(0, hi, n), dtype=torch.int32)

    x = torch.linspace(0.0, 1.0, 9, dtype=torch.float64)
    y = torch.linspace(0.0, 2.0, 7, dtype=torch.float64)
    q = torch.as_tensor(rng.uniform(-0.1, 1.1, 20))
    qy = torch.as_tensor(rng.uniform(-0.1, 2.1, 20))
    tbl = make_interval_table(x, T(9), T(8), T(8))
    diag = torch.as_tensor(rng.uniform(0.5, 1.0, 9))
    cells = 8 * 6
    samples = {
        "fused_eval_1d": (x, tbl, q),
        "fused_index_frac": (x, q),
        "fused_lower_index": (x, q),
        "fused_cell_index": (x, y, q, qy),
        "thomas_solve shared": (diag, diag + 4.0, diag.flip(0), T(9, 3)),
        "thomas_solve per column": (T(9, 3), T(9, 3) + 8.0, T(9, 3), T(9, 3)),
        "banked_eval": (T(9, 4), T(8, 4), T(8, 4), ints(8), q),
        "gathered_bank_eval": (T(9, 4), T(8, 4), T(8, 4), ints(8), q),
        "big_eval_1d": (x, T(9), T(8), T(8), q),
        "big_lower_index_frac": (x, q),
        "bilinear_grid_eval": (T(9, 7, 2), x, y, ints(cells), q, qy),
    }
    for form, width in (("bilinear", 4 * 2 + 4), ("seq", 16 * 2), ("tree", 16 * 2),
                        ("nested", 16 * 2)):
        samples[f"cell_tail {form}"] = (form, T(cells, width), ints(cells), q, qy, 2)
    return samples


# the ops whose first output is an index: opcheck's AOT gradient check sums
# every output into one tensor, in place, starting from the integer one, which
# cannot hold the float sums that follow
INDEX_FIRST = {"fused_index_frac", "fused_cell_index", "big_lower_index_frac"}


@pytest.mark.parametrize("grad", [False, True], ids=["values", "gradients"])
@pytest.mark.parametrize("case", list(op_samples()))
def test_opcheck(case, grad):
    """``torch.library.opcheck`` on every op: its schema, autograd
    registration, fake implementation against the real one, and AOT
    dispatch with dynamic shapes; with ``gradients`` the float operands
    require grad, so the backward (the VJP of the plain version) is traced
    too.  For the ops of ``INDEX_FIRST`` the AOT step with gradients is this
    test's own: the float outputs of the op compiled on ``aot_eager``, and
    their gradients, bit for bit the eager op's."""
    args = op_samples()[case]
    if grad:
        args = tuple(a.clone().requires_grad_(True)
                     if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                     for a in args)
    name = case.split()[0]
    op = kernel_ops()[name]
    if not (grad and name in INDEX_FIRST):
        torch.library.opcheck(op, args)
        return
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_autograd_registration",
                                                "test_faketensor"))
    diff = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]

    def floats(*a):
        return op(*a)[1:]

    for fn in (floats, compiled(floats)):
        outs = fn(*args)
        grads = torch.autograd.grad(sum(o.sum() for o in outs), diff)
        if fn is floats:
            want = outs, grads
    for got, ref in zip((*outs, *grads), (*want[0], *want[1])):
        same(got, ref)


# the ops of the f64-grade kernels and ORD, sampled in test_torch_compile_df.py
DF_OPS = {"fused_eval_1d_df", "fused_eval_1d_df_f64", "fused_index_frac_df", "df_bank_tail",
          "df_bank_tail_f64", "df_cell_tail", "df_cell_tail_f64", "df_nd_tail", "order_by_cell"}


def test_every_kernel_is_an_op():
    """The eleven f32/f64 kernel wrappers (K1-K5, R1, R2a, R2b-R2d with
    R2n, R2g, R3, R3idx), each behind an op of the one namespace, each op
    sampled above; beside them the nine ops of the f64-grade kernels and
    ORD."""
    assert sorted(kernel_ops()) == sorted({c.split()[0] for c in op_samples()} | DF_OPS)
    assert all(op.namespace == _cuda.NAMESPACE for op in kernel_ops().values())
    assert len(kernel_ops()) == 20


# -- launches ----------------------------------------------------------------------------
class Runs:
    """Counts each kernel op's implementation (``_cuda.run``: the plain
    version here, the launch on the card) by name."""

    def __init__(self, mp):
        self.seen = Counter()
        self._run = _cuda.run
        mp.setattr(_cuda, "run", self)

    def __call__(self, name, *args):
        self.seen[name] += 1
        return self._run(name, *args)

    def take(self):
        out, self.seen = self.seen, Counter()
        return out


def test_compiled_calls_reach_the_same_ops(monkeypatch):
    """A compiled call runs each kernel op as often as the eager call: K1
    on scalar data, K2 + R2a on a bank, K4 + K2 + R2a in a build, R1 + R2g
    for ``Bilinear``, R1 + R2n for ``Bicubic``, R3 and R3idx + R2a on a
    long axis (float32, ``bigknots.K1_MAX_KNOTS`` lowered to 8)."""
    from ndarray_interp_tpu_torch.ops import bigknots

    monkeypatch.setattr(bigknots, "K1_MAX_KNOTS", 8)
    runs = Runs(monkeypatch)
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.uniform(0.1, 1.0, 40))
    q = torch.as_tensor(rng.uniform(x[0], x[-1], 64))
    xt = torch.as_tensor(x)

    def build_and_call(d, q_):
        s = tcs.CubicSpline().extrapolate(True).build(xt, d)
        return t1.Interp1D.new_unchecked(xt, d, s)(q_)

    cases = {}
    for shape in ((40,), (40, 3)):
        t = t1.Interp1D.builder(rng.normal(size=shape), device="cpu").x(x).strategy(
            tcs.CubicSpline()).build()
        cases[f"cubic {shape}"] = (lambda q_, t=t: t(q_), (q,))
        d32 = rng.normal(size=shape).astype(np.float32)
        t32 = t1.Interp1D.builder(d32, device="cpu").x(x.astype(np.float32)).strategy(
            tcs.CubicSpline()).build()
        cases[f"long axis {shape}"] = (lambda q_, t=t32: t(q_), (q.float(),))
    cases["build"] = (build_and_call, (torch.as_tensor(rng.normal(size=(40, 2))), q))
    z = rng.normal(size=(9, 7, 2))
    for name in ("Bilinear", "Bicubic"):
        t = t2.Interp2D.builder(z, device="cpu").strategy(getattr(t2, name)()).build()
        cases[name] = (lambda a, b, t=t: t(a, b),
                       (torch.as_tensor(rng.uniform(0, 8, 64)), torch.as_tensor(
                           rng.uniform(0, 6, 64))))
    expect = {"cubic (40,)": {"fused_eval_1d"},
              "cubic (40, 3)": {"fused_index_frac", "gathered_bank_eval"},
              "long axis (40,)": {"big_eval_1d"},
              "long axis (40, 3)": {"big_lower_index_frac", "banked_eval"},
              "build": {"thomas_solve_fast", "fused_index_frac", "gathered_bank_eval"},
              "Bilinear": {"fused_cell_index", "bilinear_grid_eval"},
              "Bicubic": {"fused_cell_index", "bicubic_nested_tail"}}
    for label, (fn, args) in cases.items():
        runs.take()
        want = fn(*args)
        eager = runs.take()
        got = compiled(fn)(*args)
        assert runs.take() == eager, label
        assert set(eager) == expect[label], (label, eager)
        same(got, want)


# -- serving -----------------------------------------------------------------------------
def test_evaluator_serves_every_bucket_without_recompile():
    """``Evaluator`` after ``warmup()``: every bucket, a partial one and a
    chunked request, under ``fail_on_recompile``, bit for bit ``itp(q)``;
    the one program has one graph."""
    from torch._dynamo.utils import counters

    rng = np.random.default_rng(9)
    for shape in ((48,), (48, 3)):
        t = t1.Interp1D.builder(rng.normal(size=shape), device="cpu").strategy(
            tcs.CubicSpline()).build()
        ev = ts.Evaluator(t, max_batch=4096).warmup()
        graphs = counters["stats"]["unique_graphs"]
        with torch.compiler.set_stance("fail_on_recompile"):
            for n in (*ev.buckets, 1, 700, 9000):
                q = torch.as_tensor(rng.uniform(-1.0, 48.0, n))
                same(ev(q), t(q))
        assert counters["stats"]["unique_graphs"] == graphs


def test_evaluator2d_serves_every_bucket_without_recompile():
    """``Evaluator2D`` the same way, for ``Bilinear`` and ``Bicubic``."""
    rng = np.random.default_rng(10)
    z = rng.normal(size=(9, 7, 2))
    for name in ("Bilinear", "Bicubic"):
        t = t2.Interp2D.builder(z, device="cpu").strategy(getattr(t2, name)()).build()
        ev = ts.Evaluator2D(t, max_batch=2048).warmup()
        with torch.compiler.set_stance("fail_on_recompile"):
            for n in (*ev.buckets, 3, 5000):
                a = torch.as_tensor(rng.uniform(-0.5, 8.0, n))
                b = torch.as_tensor(rng.uniform(0.0, 6.5, n))
                same(ev(a, b), t(a, b))


class _ReadsBack(Interp1DStrategy):
    """A strategy whose eval branches on a value read to the host: no graph
    holds it."""

    extrapolates = True

    def eval(self, interp, xq):
        return xq * 2 if bool(xq.sum() > 0) else xq


def test_a_trace_that_breaks_raises():
    """``fullgraph=True``: an interpolator whose call cannot be one graph
    raises from the evaluator, instead of running eagerly."""
    t = t1.Interp1D.new_unchecked(torch.arange(4.0), torch.arange(4.0), _ReadsBack())
    with pytest.raises(torch._dynamo.exc.TorchDynamoException):
        ts.Evaluator(t, max_batch=256)(torch.ones(3))
