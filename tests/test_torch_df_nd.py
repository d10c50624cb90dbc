"""The port's f64-grade ``InterpND`` path (``ops/eval_kernels_df_nd.py``
and ``serving.DoubleFloatEvaluatorND``) against the JAX package's, on the
CPU: the twin of ``tests/test_df.py::TestDoubleFloatND``.

The same numpy inputs, made from seeds, go through the JAX functions (CPU,
x64: the XLA forms, and the Pallas tail in interpret mode) and through the
port's counterparts, which run K15's plain float64 version on CPU tensors.
``InterpND`` state is carried from the JAX interpolator with
``interop.interpnd_from_numpy``, so both evaluate the same table.

Tolerances, scale-relative (the error over max(|value|, 1% of the largest
|value|), as ``tests/test_df.py`` does): the double-float tail and route
within 4e-12 of the JAX XLA forms, within 1e-4 of the Pallas tail in
interpret mode, which degrades the error-free transforms
(``test_df.py:1465-1470``); f48 within 1e-8; the evaluators within 1e-9 of
the float64 ``InterpND`` (``test_df.py:1380``, which includes the ~2^-49
representation of axes and queries) and within 1e-12 of the JAX evaluator
(f48: 1e-8).  Packed tables are compared bit for bit; errors by class and
message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.models.interpnd as jm
import ndarray_interp_tpu.serving as js
import ndarray_interp_tpu_torch.serving as ts
from ndarray_interp_tpu.interpnd import InterpND as JND
from ndarray_interp_tpu.ops import df as jdf
from ndarray_interp_tpu.ops import pallas_eval_df as jp
from ndarray_interp_tpu.ops import pallas_eval_df_nd as jn
from ndarray_interp_tpu_torch.interop import interpnd_from_numpy
from ndarray_interp_tpu_torch.ops import df as tdf
from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as tn
from ndarray_interp_tpu_torch.ops import kernel_wrappers


def jpair(v):
    return [jnp.asarray(w) for w in jdf.df_from_f64(np.asarray(v, np.float64))]


def tpair(v):
    return list(tdf.df_from_f64(torch.as_tensor(np.array(v, np.float64))))


def bits(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v.view(np.int32)


def scaled_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
    return float(np.max(np.abs(got - want) / scale))


def case(k, trailing=(), seed=0, sizes=None):
    rng = np.random.default_rng(seed)
    sizes = sizes or [9, 8, 7, 5][:k]
    axes = [np.sort(rng.uniform(-3.0, 3.0, n)) for n in sizes]
    return axes, rng.normal(size=tuple(sizes) + tuple(trailing)), rng


def both(data, axes, method="cubic", bcs=None, extrapolate=False):
    """A JAX InterpND in float64 and the port's from its carried state."""
    b = JND.builder(data).points(*axes).method(method).extrapolate(extrapolate)
    j = (b.boundary(*bcs) if bcs else b).build()
    t = interpnd_from_numpy([np.asarray(a) for a in j.axes], np.asarray(j.data), j.method,
                            j.extrapolates, None if j.table is None else np.asarray(j.table),
                            j.bcs, j.layout, device="cpu")
    return j, t


def tail_inputs(k, nbasis, r, grade, seed, nq=256):
    """Random packed cell rows of ``nbasis^k`` blocks (JAX and port tables),
    random cells and fractions (some outside [0, 1])."""
    rng = np.random.default_rng(seed)
    nb = nbasis**k
    cells = [3, 4, 2, 3][:k]
    ncell = int(np.prod(cells))
    payload = rng.normal(size=(ncell, nb * r)) * 10.0 ** rng.integers(-3, 3, (ncell, 1))
    pack = f"pack_rows_nd_{grade}"
    jpk = getattr(jn, pack)(*jpair(payload), nb, r)
    tpk = getattr(tn, pack)(*tpair(payload), nb, r)
    idx = np.stack([rng.integers(0, c, nq) for c in cells]).astype(np.int32)
    t = rng.uniform(-0.5, 1.5, (k, nq))
    cstrides = [int(np.prod(cells[d + 1:])) for d in range(k)]
    return jpk, tpk, idx, t, cstrides


# -- packed tables --------------------------------------------------------------------
@pytest.mark.parametrize("nb", [2, 4, 8, 16, 64])
@pytest.mark.parametrize("r", [1, 3, 8, 20])
def test_packers_match_jax_bit_for_bit(nb, r):
    rng = np.random.default_rng(nb * 100 + r)
    rows = rng.normal(size=(7, nb * r))
    for name, units in (("pack_rows_nd_df", 2 * nb), ("pack_rows_nd_f48", 3 * nb // 2)):
        want = np.asarray(getattr(jn, name)(*jpair(rows), nb, r))
        got = getattr(tn, name)(*tpair(rows), nb, r)
        assert tuple(got.shape) == want.shape == (7, units * tn._nd_bp(r)), name
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)
    assert tn._nd_bp(r) == jn._nd_bp(r)


def test_f48_table_holds_bf16_lo_halves():
    rng = np.random.default_rng(5)
    pair = tpair(rng.normal(size=(6, 64 * 3)))
    df = tn.pack_rows_nd_df(*pair, 64, 3)
    f48 = tn.pack_rows_nd_f48(*pair, 64, 3)
    np.testing.assert_array_equal(bits(f48[:, : 64 * 3]), bits(df[:, : 64 * 3]))
    lo = tn._unpack_f48_lo(f48[:, 64 * 3 :])
    np.testing.assert_array_equal(bits(lo), bits(df[:, 64 * 3 :].to(torch.bfloat16).float()))


# -- the tail K15 (plain version) against the JAX tails --------------------------------
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("nbasis", [2, 4])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("grade", ["df", "f48"])
def test_tail_matches_jax_xla_tail(k, nbasis, r, grade):
    jpk, tpk, idx, t, cstrides = tail_inputs(k, nbasis, r, grade, seed=10 * k + nbasis + r)
    nb, bp = nbasis**k, tn._nd_bp(r)
    cell = sum(idx[d].astype(np.int64) * s for d, s in enumerate(cstrides))
    rows = jnp.take(jpk, jnp.asarray(cell), axis=0)
    if grade == "f48":
        rows = jnp.concatenate([rows[:, : nb * bp], jp._unpack_f48_lo(rows[:, nb * bp :])], 1)
    jt = [jpair(v) for v in t]
    whi, wlo = jax.jit(lambda rows, *a: jn._df_nd_weight_tail_xla(
        rows, list(a[::2]), list(a[1::2]), k, bp, nbasis))(rows, *(h for p in jt for h in p))
    want = jdf.df_to_f64(whi[:, :r], wlo[:, :r])
    tp = [tpair(v) for v in t]
    th, tl = torch.stack([p[0] for p in tp]), torch.stack([p[1] for p in tp])
    tail = {"df": tn.nd_df_tail, "f48": tn.nd_f48_tail}[grade]
    hi, lo = tail(tpk, torch.as_tensor(idx), th, tl, cstrides, nbasis)
    assert tuple(hi.shape) == tuple(lo.shape) == (256, bp)
    assert hi.dtype == lo.dtype == torch.float32
    assert scaled_err(tdf.df_to_f64(hi[:, :r], lo[:, :r]), want) <= 4e-12
    plain = {"df": tn._nd_df_tail_plain, "f48": tn._nd_f48_tail_plain}[grade]
    for a, b in zip((hi, lo), plain(tpk, torch.as_tensor(idx), th, tl, cstrides, nbasis)):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("k,nbasis,grade", [(2, 4, "df"), (3, 2, "df"), (2, 4, "f48")])
def test_tail_matches_jax_pallas_tail_interpret(k, nbasis, grade):
    """The JAX Mosaic tail in interpret mode: a check of block layout and
    channel order (interpret mode degrades its error-free transforms)."""
    jpk, tpk, idx, t, cstrides = tail_inputs(k, nbasis, 3, grade, seed=41 + k + nbasis)
    cell = sum(idx[d].astype(np.int64) * s for d, s in enumerate(cstrides))
    rows = jnp.take(jpk, jnp.asarray(cell), axis=0)
    jt = [h for v in t for h in jpair(v)]
    mh, ml = jn.nd_df_tail_mxu(rows, jt, k, nbasis=nbasis, interpret=True, tier=grade)
    want = jdf.df_to_f64(mh[:, :3], ml[:, :3])
    tp = [tpair(v) for v in t]
    tail = {"df": tn.nd_df_tail, "f48": tn.nd_f48_tail}[grade]
    hi, lo = tail(tpk, torch.as_tensor(idx), torch.stack([p[0] for p in tp]),
                  torch.stack([p[1] for p in tp]), cstrides, nbasis)
    got = tdf.df_to_f64(hi[:, :3], lo[:, :3]).numpy()
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3)) < 1e-4


def test_tail_is_the_halving_tree_of_weighted_blocks():
    """The plain K15 on one bilinear cell: the weights ``(1-t)``/``t``
    folded axis 0 first, times the widened blocks, summed by the halving
    tree ``(p0 + p2) + (p1 + p3)`` in float64."""
    z = np.array([1.0, 2.0, 3.0, 5.0]) + 1e-9
    packed = tn.pack_rows_nd_df(*tpair(z[None, :]), 4, 1)
    t0, t1 = 0.3, 0.6
    th, tl = (torch.stack(v) for v in zip(*(tpair([t0]), tpair([t1]))))
    hi, lo = tn.nd_df_tail(packed, torch.zeros((2, 1), dtype=torch.int32), th, tl, [1, 1], 2)
    zr = tdf.df_to_f64(*tpair(z)).numpy()
    t0, t1 = (tdf.df_to_f64(*tpair([v])).item() for v in (t0, t1))
    w = [(1 - t0) * (1 - t1), (1 - t0) * t1, t0 * (1 - t1), t0 * t1]
    p = [wi * zi for wi, zi in zip(w, zr)]
    assert tdf.df_to_f64(hi[:, 0], lo[:, 0]).item() == (p[0] + p[2]) + (p[1] + p[3])


# -- the route -----------------------------------------------------------------------
@pytest.mark.parametrize("k,method", [(2, "cubic"), (3, "cubic"), (3, "linear")])
@pytest.mark.parametrize("grade", ["df", "f48"])
def test_route_matches_jax_route(k, method, grade):
    axes, data, rng = case(k, trailing=(2,), seed=21 + k)
    j, t = both(data, axes, method, extrapolate=True)
    nbasis = 4 if method == "cubic" else 2
    rows64 = np.asarray(j.table if method == "cubic" else jm.pack_corner_rows_nd(j.data, k))
    pack = f"pack_rows_nd_{grade}"
    jpk = getattr(jn, pack)(*jpair(rows64), nbasis**k, 2)
    tpk = getattr(tn, pack)(*tpair(rows64), nbasis**k, 2)
    qs = [rng.uniform(a[0] - 0.5, a[-1] + 0.5, 300) for a in axes]
    grid = tuple(data.shape[:k])
    jroute = jn.gathered_nd_eval_df_packed(k, grid, 2, nbasis=nbasis, tier=grade)
    jargs = [h for a in axes for h in jpair(a)] + [jpk] + [h for q in qs for h in jpair(q)]
    want = jdf.df_to_f64(*jax.jit(jroute)(*jargs))
    troute = tn.gathered_nd_eval_df_packed(k, grid, 2, nbasis=nbasis, tier=grade)
    targs = [h for a in axes for h in tpair(a)] + [tpk] + [h for q in qs for h in tpair(q)]
    got = tdf.df_to_f64(*troute(*targs))
    assert tuple(got.shape) == (300, 2)
    assert scaled_err(got, want) <= (4e-12 if grade == "df" else 1e-8)
    assert scaled_err(got, j.eval_unchecked(*qs)) <= (1e-9 if grade == "df" else 1e-8)
    with pytest.raises(ValueError, match="tier"):
        tn.gathered_nd_eval_df_packed(k, grid, 2, tier="f24")


# -- DoubleFloatEvaluatorND ---------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("grade", ["df", "f48"])
def test_evaluator_matches_jax_and_the_f64_interpolator(k, method, grade):
    """TestDoubleFloatND::test_evaluator_nd_matches_f64_oracle and
    ::test_evaluator_nd_f48_grade."""
    axes, data, rng = case(k, trailing=(2,), seed=11 + k)
    j, t = both(data, axes, method)
    ev = ts.DoubleFloatEvaluatorND(t, max_batch=512, grade=grade).warmup()
    jev = js.DoubleFloatEvaluatorND(j, max_batch=512, grade=grade)
    assert tuple(ev._packed.shape) == tuple(jev._packed.shape)
    np.testing.assert_array_equal(bits(ev._packed), bits(jev._packed))
    qs = [rng.uniform(ax[0], ax[-1], 700) for ax in axes]
    got = ev(*qs)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert tuple(got.shape) == (700, 2)
    assert scaled_err(got, t.interp_array(*qs).numpy()) < (1e-9 if grade == "df" else 1e-8)
    assert scaled_err(got, jev(*qs)) <= (1e-12 if grade == "df" else 1e-8)
    shaped = ev(*(q[:12].reshape(3, 4) for q in qs))
    assert tuple(shaped.shape) == (3, 4, 2)
    assert tuple(ev(*(np.zeros(0) for _ in axes)).shape) == (0, 2)


def test_f48_table_is_three_quarters_of_df():
    axes, data, _ = case(2, trailing=(2,), seed=13)
    _, t = both(data, axes)
    ev48 = ts.DoubleFloatEvaluatorND(t, max_batch=512, grade="f48")
    evdf = ts.DoubleFloatEvaluatorND(t, max_batch=512)
    assert ev48._packed.shape[1] * 4 == evdf._packed.shape[1] * 3


def test_evaluator_periodic_wrap_matches_jax():
    """TestDoubleFloatND::test_evaluator_nd_periodic_wrap: a periodic axis
    wraps in float64 on the device and is never out of range."""
    axes, data, rng = case(2, seed=29)
    data[-1] = data[0]
    j, t = both(data, axes, bcs=("periodic", "not_a_knot"))
    ev = ts.DoubleFloatEvaluatorND(t, max_batch=512)
    span = axes[0][-1] - axes[0][0]
    q0 = rng.uniform(axes[0][0] - 2 * span, axes[0][-1] + 2 * span, 200)
    q1 = rng.uniform(axes[1][0], axes[1][-1], 200)
    got = ev(q0, q1)
    assert scaled_err(got, t.interp_array(q0, q1).numpy()) < 1e-9
    assert scaled_err(got, js.DoubleFloatEvaluatorND(j, max_batch=512)(q0, q1)) <= 1e-12


def test_evaluator_from_a_port_build():
    """Built by the port itself on the CPU, not carried over."""
    from ndarray_interp_tpu_torch.interpnd import InterpND

    axes, data, rng = case(3, trailing=(2,), seed=33)
    for method in ("cubic", "linear"):
        t = InterpND.builder(data, device="cpu").points(*axes).method(method).build()
        qs = [rng.uniform(a[0], a[-1], 300) for a in axes]
        got = ts.DoubleFloatEvaluatorND(t, max_batch=256)(*qs)
        assert scaled_err(got, t.interp_array(*qs).numpy()) < 1e-9


@pytest.mark.parametrize("case_", [
    "axis 0 low", "axis 2 high", "nan axis 0", "nan axis 1 after oob axis 0",
    "oob axis 1 after nan axis 0", "shapes", "arity", "nan, extrapolating",
])
def test_evaluator_errors_match_jax(case_):
    """TestDoubleFloatND::test_evaluator_nd_errors: per axis, NaN raises
    before the range check; the same class and message as JAX."""
    axes, data, _ = case(3, seed=31)
    j, t = both(data, axes, extrapolate=case_ == "nan, extrapolating")
    mid = [np.asarray([0.5 * (a[0] + a[-1]), a[1]]) for a in axes]
    qs = [m.copy() for m in mid]
    if case_ == "axis 0 low":
        qs[0][1] = axes[0][0] - 1.0
    elif case_ == "axis 2 high":
        qs[2][1] = axes[2][-1] + 1.0
    elif case_ in ("nan axis 0", "nan, extrapolating"):
        qs[0][1] = np.nan
    elif case_ == "nan axis 1 after oob axis 0":
        qs[0][0], qs[1][1] = axes[0][-1] + 1.0, np.nan
    elif case_ == "oob axis 1 after nan axis 0":
        qs[0][1], qs[1][0] = np.nan, axes[1][0] - 2.0
    elif case_ == "shapes":
        qs[1] = np.zeros(3)
    else:
        qs = qs[:2]
    raised = {}
    for pkg, ev in (("jax", js.DoubleFloatEvaluatorND(j)), ("torch", ts.DoubleFloatEvaluatorND(t))):
        with pytest.raises(Exception) as info:
            ev(*qs)
        raised[pkg] = info.value
    assert type(raised["torch"]).__name__ == type(raised["jax"]).__name__
    assert str(raised["torch"]) == str(raised["jax"])


@pytest.mark.parametrize("what", ["nearest", "node layout", "grade"])
def test_evaluator_refusals_match_jax(what):
    axes, data, _ = case(3, seed=35)
    if what == "nearest":
        j, t = both(data, axes, "nearest")
    else:
        b = JND.builder(data).points(*axes).method("cubic")
        j = (b.layout("node2") if what == "node layout" else b).build()
        t = interpnd_from_numpy([np.asarray(a) for a in j.axes], np.asarray(j.data), j.method,
                                j.extrapolates, np.asarray(j.table), j.bcs, j.layout, device="cpu")
    kw = {"grade": "f24"} if what == "grade" else {}
    with pytest.raises(ValueError) as t_err:
        ts.DoubleFloatEvaluatorND(t, **kw)
    with pytest.raises(ValueError) as j_err:
        js.DoubleFloatEvaluatorND(j, **kw)
    assert str(t_err.value) == str(j_err.value)


def test_infinite_queries_are_nan_in_both():
    """±inf queries on an extrapolating plane: the weight form meets
    ``inf - inf``, so both packages' DF evaluators, and both float64
    interpolators, give NaN (no divergence here, unlike the 2-D DF
    bilinear route)."""
    ax = [np.arange(10.0), np.arange(8.0)]
    x, y = np.meshgrid(*ax, indexing="ij")
    z = 2 * x - 3 * y + 1
    qx, qy = np.array([3.5, 3.5, np.inf, -np.inf]), np.array([np.inf, -np.inf, 2.5, 2.5])
    for method in ("linear", "cubic"):
        j, t = both(z, ax, method, extrapolate=True)
        for grade in ("df", "f48"):
            assert np.isnan(js.DoubleFloatEvaluatorND(j, grade=grade)(qx, qy)).all()
            assert torch.isnan(ts.DoubleFloatEvaluatorND(t, grade=grade)(qx, qy)).all()
        assert torch.isnan(t(qx, qy)).all()


def test_cpu_tensors_launch_no_kernel():
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    axes, data, rng = case(2, seed=44)
    for method in ("cubic", "linear"):
        _, t = both(data, axes, method)
        for grade in ("df", "f48"):
            ts.DoubleFloatEvaluatorND(t, max_batch=256, grade=grade)(
                *(rng.uniform(a[0], a[-1], 30) for a in axes))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before
