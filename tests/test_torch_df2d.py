"""The port's f64-grade 2-D path (``ops/eval_kernels_df2d.py`` and the 2-D
part of ``serving``) against the JAX package's, on the CPU.

The same numpy inputs, made from seeds, go through the JAX functions (CPU,
x64: the plain XLA forms, and the Pallas tails in interpret mode) and
through the port's counterparts, which run their kernels' plain float64
versions on CPU tensors.  Bicubic state is carried from the JAX
interpolator with ``interop.interp2d_from_numpy``, so both evaluate the
same table.

Tolerances, scale-relative (the error over max(|value|, 1% of the largest
|value|), as ``tests/test_df.py`` does): the double-float tails and routes
within 4e-12 of the JAX XLA forms and of the float64 oracle on
double-float-representable inputs (``test_tpu_parity.py:454-465``), within
1e-5 of the Pallas tails in interpret mode, which degrades the error-free
transforms (``tests/test_df.py:352-399``); f48 within 1e-8; the evaluators
within 1e-9 of the float64 strategies (``test_df.py:251-295``, which
includes the ~2^-49 representation of knots and queries).  Packed tables
are compared bit for bit; errors by class and message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp2d as j2
import ndarray_interp_tpu.serving as js
import ndarray_interp_tpu_torch.interp2d as t2
import ndarray_interp_tpu_torch.serving as ts
from ndarray_interp_tpu.ops import df as jdf
from ndarray_interp_tpu.ops import pallas_eval_df as jp
from ndarray_interp_tpu_torch.interop import interp2d_from_numpy
from ndarray_interp_tpu_torch.ops import df as tdf
from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as tp
from ndarray_interp_tpu_torch.ops import kernel_wrappers


def jpair(v):
    return [jnp.asarray(w) for w in jdf.df_from_f64(np.asarray(v, np.float64))]


def tpair(v):
    return list(tdf.df_from_f64(torch.as_tensor(np.array(v, np.float64))))


def jf64(pair):
    return jdf.df_to_f64(*pair)


def tf64(pair):
    return tdf.df_to_f64(*pair).numpy()


def bits(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v.view(np.int32)


def rep(v):
    """``v`` rounded to the double-float format (exact as a pair)."""
    return jdf.df_to_f64(*jdf.df_from_f64(np.asarray(v, np.float64)))


def scaled_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
    return float(np.max(np.abs(got - want) / scale))


def axes(nx=20, ny=16, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.uniform(0.2, 1.0, nx)), np.cumsum(rng.uniform(0.2, 1.0, ny)), rng


def both(z, x, y, bicubic=False, extrapolate=True, bc=("not_a_knot", "not_a_knot")):
    """A JAX interpolator in float64 and the port's from its carried state."""
    b = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y))
    s = j2.Bicubic().boundary(*bc) if bicubic else j2.Bilinear()
    j = b.strategy(s.extrapolate(extrapolate)).build()
    s = j.strategy
    state = dict(extrapolate=s.extrapolates)
    if bicubic:
        state.update(rows=np.asarray(s.rows), layout=s.layout, bc_x=s.bc_x, bc_y=s.bc_y)
    t = interp2d_from_numpy(np.asarray(j.x), np.asarray(j.y), np.asarray(j.data),
                            device="cpu", **state)
    return j, t


def cell_rows(nx, ny, r, rng):
    """Random bicubic cell rows ``(cells, 16 r)``, float64."""
    return rng.normal(size=((nx - 1) * (ny - 1), 16 * r))


# -- packed tables ----------------------------------------------------------------
@pytest.mark.parametrize("trailing", [(), (3,), (2, 5), (16,)])
def test_packers_match_jax_bit_for_bit(trailing):
    rng = np.random.default_rng(len(trailing) + sum(trailing))
    r = int(np.prod(trailing))
    z = rng.normal(size=(9, 7) + trailing)
    rows = cell_rows(9, 7, r, rng)
    bp = -(-r // 8) * 8
    for name, src, extra, width in (
        ("pack_bilinear_rows_df", z, (), 8), ("pack_bilinear_rows_f48", z, (), 6),
        ("pack_bicubic_rows_df", rows, (r,), 32), ("pack_bicubic_rows_f48", rows, (r,), 24),
    ):
        want = np.asarray(getattr(jp, name)(*jpair(src), *extra))
        got = getattr(tp, name)(*tpair(src), *extra)
        assert tuple(got.shape) == want.shape == (8 * 6, width * bp), name
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
def test_f48_tables_hold_bf16_lo_halves(kind):
    """The f48 table is the double-float table's hi half plus its lo half
    rounded to bfloat16 (TestF48BicubicTier::test_pack_unpack_roundtrip_exact)."""
    rng = np.random.default_rng(5)
    src, extra, hi_blocks = ((rng.normal(size=(6, 5, 13)), (), 4) if kind == "bilinear"
                             else (cell_rows(6, 5, 13, rng), (13,), 16))
    pair = tpair(src)
    df = getattr(tp, f"pack_{kind}_rows_df")(*pair, *extra)
    f48 = getattr(tp, f"pack_{kind}_rows_f48")(*pair, *extra)
    split = hi_blocks * 16  # bp = 16
    assert f48.shape[1] * 4 == df.shape[1] * 3
    np.testing.assert_array_equal(bits(f48[:, :split]), bits(df[:, :split]))
    lo = tp._unpack_f48_lo(f48[:, split:])
    np.testing.assert_array_equal(bits(lo), bits(df[:, split:].to(torch.bfloat16).float()))


# -- the tails K10-K13 (plain versions) against the JAX tails ------------------------------
def tail_case(kind, grade, r, seed=3, nq=512, nx=11, ny=9):
    """A packed table, random cells and fractions, the JAX gathered rows and
    the JAX XLA and interpret-mode Pallas results."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(nx, ny, r)) if kind == "bilinear" else cell_rows(nx, ny, r, rng)
    extra = () if kind == "bilinear" else (r,)
    name = f"pack_{kind}_rows_{grade}"
    jpk = getattr(jp, name)(*jpair(src), *extra)
    tpk = getattr(tp, name)(*tpair(src), *extra)
    xi = rng.integers(0, nx - 1, nq).astype(np.int32)
    yi = rng.integers(0, ny - 1, nq).astype(np.int32)
    t = rng.uniform(-0.5, 1.5, (2, nq))
    rows = jnp.take(jpk, jnp.asarray(xi * (ny - 1) + yi), axis=0)
    jt = jpair(t[0]) + jpair(t[1])
    blocks = {"bilinear": 4, "bicubic": 16}[kind]
    bp = jpk.shape[1] // (2 * blocks if grade == "df" else 3 * blocks // 2)
    full = rows if grade == "df" else jnp.concatenate(
        [rows[:, : blocks * bp], jp._unpack_f48_lo(rows[:, blocks * bp:])], axis=1)
    if kind == "bilinear":
        xla = jp._df_bilinear_xla_tail(full, *jt, r)
        pallas = {"df": jp.bilinear_df_tail_mxu, "f48": jp.bilinear_f48_tail}[grade]
    else:
        xla = jp._df_bicubic_tail(full, *(v[:, None] for v in jt), bp)
        xla = (xla[0][:, :r], xla[1][:, :r])
        pallas = {"df": jp.bicubic_df_tail_mxu, "f48": jp.bicubic_f48_tail}[grade]
    mosaic = pallas(rows, *jt, interpret=True)
    args = (tpk, torch.as_tensor(xi), torch.as_tensor(yi), ny, *tpair(t[0]), *tpair(t[1]))
    return args, jf64(xla), jf64((mosaic[0][:, :r], mosaic[1][:, :r])), bp


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
@pytest.mark.parametrize("grade", ["df", "f48"])
@pytest.mark.parametrize("r", [1, 3, 16])
def test_tails_match_jax_tails(kind, grade, r):
    args, want_xla, want_mosaic, bp = tail_case(kind, grade, r)
    tail = getattr(tp, f"gathered_{kind}_{grade}_tail")
    hi, lo = tail(*args)
    assert tuple(hi.shape) == tuple(lo.shape) == (512, bp)
    assert hi.dtype == lo.dtype == torch.float32
    got = tdf.df_to_f64(hi[:, :r], lo[:, :r]).numpy()
    assert scaled_err(got, want_xla) <= 4e-12
    assert scaled_err(got, want_mosaic) <= 1e-5
    plain = getattr(tp, f"_{kind}_{grade}_tail_plain")(*args)
    for a, b in zip((hi, lo), plain):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_bilinear_tail_is_the_lerp_form_in_float64():
    """The plain K10 version on one cell: ``z1 + t (z2 - z1)`` along x at
    both y-knots, then along y, in float64, split into a pair."""
    z = rep(np.array([[1.0, 2.0], [3.0, 5.0]]) + 1e-9)
    packed = tp.pack_bilinear_rows_df(*tpair(z))
    tx, ty = rep(0.3), rep(0.6)
    zero = torch.zeros(1, dtype=torch.int32)
    hi, lo = tp.gathered_bilinear_df_tail(packed, zero, zero, 2, *tpair([tx]), *tpair([ty]))
    z1 = z[0, 0] + tx * (z[1, 0] - z[0, 0])
    z2 = z[0, 1] + tx * (z[1, 1] - z[0, 1])
    want = z1 + ty * (z2 - z1)
    assert tdf.df_to_f64(hi[:, 0], lo[:, 0]).item() == want


# -- routes ------------------------------------------------------------------------------
def route_case(kind, trailing, nq=600, seed=27):
    """DF-representable axes, data and queries (in and out of range), and
    the carried pair inputs of both packages."""
    x, y, rng = axes(seed=seed)
    x, y = rep(x), rep(y)
    z = rep(rng.normal(size=(20, 16) + trailing))
    qx = rep(rng.uniform(x[0] - 1, x[-1] + 1, nq))
    qy = rep(rng.uniform(y[0] - 1, y[-1] + 1, nq))
    return x, y, z, qx, qy


def bilinear_oracle(x, y, z, qx, qy):
    """test_df.py:239-247: the float64 calc_frac form."""
    xi = np.clip(np.searchsorted(x, qx, side="right") - 1, 0, len(x) - 2)
    yi = np.clip(np.searchsorted(y, qy, side="right") - 1, 0, len(y) - 2)
    e = (slice(None),) + (None,) * (z.ndim - 2)

    def lerp(x1, y1, x2, y2, q):
        return (y2 - y1) / (x2 - x1)[e] * (q - x1)[e] + y1

    z1 = lerp(x[xi], z[xi, yi], x[xi + 1], z[xi + 1, yi], qx)
    z2 = lerp(x[xi], z[xi, yi + 1], x[xi + 1], z[xi + 1, yi + 1], qx)
    return lerp(y[yi], z1, y[yi + 1], z2, qy)


@pytest.mark.parametrize("trailing", [(), (5,)])
@pytest.mark.parametrize("grade", ["df", "f48"])
def test_bilinear_routes_match_jax_and_the_f64_oracle(trailing, grade):
    x, y, z, qx, qy = route_case("bilinear", trailing)
    r = int(np.prod(trailing))
    q = dict(j=jpair(qx) + jpair(qy), t=tpair(qx) + tpair(qy))
    name = f"gathered_bilinear_eval_{grade}_packed"
    jpk = getattr(jp, f"pack_bilinear_rows_{grade}")(*jpair(z))
    want = jf64(jax.jit(lambda *a: getattr(jp, name)(*a[:4], a[4], 16, r, *a[5:]))(
        *jpair(x), *jpair(y), jpk, *q["j"]))
    tpk = getattr(tp, f"pack_bilinear_rows_{grade}")(*tpair(z))
    got = tf64(getattr(tp, name)(*tpair(x), *tpair(y), tpk, 16, r, *q["t"]))
    assert got.shape == (600, r)
    tol = 4e-12 if grade == "df" else 1e-8
    assert scaled_err(got, want) <= tol
    assert scaled_err(got, bilinear_oracle(x, y, z, qx, qy).reshape(600, r)) <= tol
    if grade == "df":
        unpacked = tf64(tp.gathered_bilinear_eval_df(*tpair(x), *tpair(y), *tpair(z), *q["t"]))
        assert unpacked.shape == (600,) + trailing
        np.testing.assert_array_equal(unpacked.reshape(600, r), got)
        eval2d = jf64(jp.eval_xla_df_2d(*jpair(x), *jpair(y), *jpair(z), *q["j"]))
        assert scaled_err(unpacked, eval2d) <= 4e-12
    with pytest.raises(ValueError, match="ny = 15"):
        getattr(tp, name)(*tpair(x), *tpair(y), tpk, 15, r, *q["t"])


@pytest.mark.parametrize("trailing", [(), (3,)])
@pytest.mark.parametrize("grade", ["df", "f48"])
def test_bicubic_routes_match_jax_and_the_f64_strategy(trailing, grade):
    """TestDFBicubicGatherRoute::test_route_matches_f64_strategy and
    TestF48BicubicTier::test_route_grade_on_cpu."""
    x, y, z, qx, qy = route_case("bicubic", trailing, seed=37)
    r = int(np.prod(trailing))
    j, t = both(z, x, y, bicubic=True)
    rows64 = np.asarray(j.strategy.rows)
    name = f"gathered_bicubic_eval_{grade}_packed"
    jpk = getattr(jp, f"pack_bicubic_rows_{grade}")(*jpair(rows64), r)
    want = jf64(jax.jit(lambda *a: getattr(jp, name)(*a, r=r))(
        *jpair(x), *jpair(y), jpk, *jpair(qx), *jpair(qy)))
    tpk = getattr(tp, f"pack_bicubic_rows_{grade}")(*tpair(rows64), r)
    got = tf64(getattr(tp, name)(*tpair(x), *tpair(y), tpk, *tpair(qx), *tpair(qy), r=r))
    assert got.shape == (600, r)
    tol = 4e-12 if grade == "df" else 1e-8
    assert scaled_err(got, want) <= tol
    strategy = np.asarray(j.interp_array(qx, qy)).reshape(600, r)  # the f64 strategy eval
    assert scaled_err(got, strategy) <= (1e-11 if grade == "df" else 1e-8)
    if grade == "df":
        unpacked = tf64(tp.gathered_bicubic_eval_df(*tpair(x), *tpair(y), *tpair(rows64),
                                                    *tpair(qx), *tpair(qy), r=r))
        np.testing.assert_array_equal(unpacked, got)


# -- Evaluator2D ----------------------------------------------------------------------
def test_evaluator2d_matches_direct_and_jax():
    """test_aux.py:113 in 2-D: every request size, through warmed buckets,
    equals ``itp(xs, ys)`` bit for bit and the JAX evaluator's values."""
    x, y, rng = axes(seed=1)
    z = rng.normal(size=(20, 16, 3))
    j, t = both(z, x, y)
    ev = ts.Evaluator2D(t, max_batch=2048).warmup()
    jev = js.Evaluator2D(j, max_batch=2048)
    assert ev.buckets == jev.buckets == (256, 512, 1024, 2048)
    for n in (1, 300, 2048, 5000):
        qx = rng.uniform(x[0] - 1, x[-1] + 1, n)
        qy = rng.uniform(y[0] - 1, y[-1] + 1, n)
        got = ev(qx, qy)
        assert torch.equal(got, t(qx, qy))
        want = np.asarray(jev(jnp.asarray(qx), jnp.asarray(qy)))
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    q = rng.uniform(x[0], x[-1], (4, 6))
    assert tuple(ev(q, q * 0 + y[3]).shape) == (4, 6, 3)
    assert tuple(ev(np.zeros(0), np.zeros(0)).shape) == (0, 3)
    jerr = pytest.raises(ValueError, jev, jnp.zeros(3), jnp.zeros(4)).value
    terr = pytest.raises(ValueError, ev, np.zeros(3), np.zeros(4)).value
    assert str(terr) == str(jerr)


def test_eval_into_donated_2d_matches_jax():
    x, y, rng = axes(seed=2)
    j, t = both(rng.normal(size=(20, 16, 4)), x, y)
    qx = torch.as_tensor(rng.uniform(x[0], x[-1], (10, 3)))
    qy = torch.as_tensor(rng.uniform(y[0], y[-1], (10, 3)))
    out = torch.zeros((10, 3, 4), dtype=torch.float64)
    assert ts.eval_into_donated_2d(t, qx, qy, out) is out
    want = np.asarray(j.interp_array(qx.numpy(), qy.numpy()))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-14)
    for bad_q, bad_out in ((qy[:5], out), (qy, torch.zeros((10, 3)))):
        with pytest.raises(ValueError) as t_err:
            ts.eval_into_donated_2d(t, qx, bad_q, bad_out)
        with pytest.raises(ValueError) as j_err:
            js.eval_into_donated_2d(j, jnp.asarray(qx.numpy()), jnp.asarray(bad_q.numpy()),
                                    jnp.zeros(tuple(bad_out.shape)))
        assert str(t_err.value) == str(j_err.value)


# -- DoubleFloatEvaluator2D -------------------------------------------------------------
@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
@pytest.mark.parametrize("grade", ["df", "f48"])
@pytest.mark.parametrize("trailing", [(), (3,)])
def test_df_evaluator2d_matches_jax(kind, grade, trailing):
    """TestDF2D::test_serving_evaluator_2d(_banked),
    TestDFBicubicGatherRoute::test_serving_evaluator_bicubic and the f48
    serving tests: the f64 strategy within 1e-9 (f48: 1e-8), and the JAX
    evaluator within 1e-12 (f48: 1e-8)."""
    x, y, rng = axes(seed=28)
    j, t = both(rng.normal(size=(20, 16) + trailing), x, y, bicubic=kind == "bicubic")
    ev = ts.DoubleFloatEvaluator2D(t, max_batch=512, grade=grade)
    jev = js.DoubleFloatEvaluator2D(j, max_batch=512, grade=grade)
    assert ev._packed.shape == tuple(jev._packed.shape)
    qx = rng.uniform(x[0] - 0.5, x[-1] + 0.5, 700)
    qy = rng.uniform(y[0] - 0.5, y[-1] + 0.5, 700)
    got = ev(qx, qy)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert tuple(got.shape) == (700,) + trailing
    assert scaled_err(got, j.interp_array(qx, qy)) < (1e-9 if grade == "df" else 1e-8)
    assert scaled_err(got, jev(qx, qy)) <= (1e-12 if grade == "df" else 1e-8)
    shaped = ev(qx[:12].reshape(3, 4), qy[:12].reshape(3, 4))
    assert tuple(shaped.shape) == (3, 4) + trailing
    assert tuple(ev(np.zeros(0), np.zeros(0)).shape) == (0,) + trailing
    assert ev.warmup() is ev


@pytest.mark.parametrize("bc", [("periodic", "not_a_knot"), ("not_a_knot", "periodic"),
                                ("periodic", "periodic")])
def test_df_evaluator2d_periodic_wraps_like_jax(bc):
    """TestDFBicubicGatherRoute::test_serving_evaluator_bicubic_periodic_wraps:
    a periodic axis wraps in float64 on the device (never out of range) and
    still refuses NaN."""
    x, y, rng = axes(nx=16, ny=14, seed=39)
    z = rng.normal(size=(16, 14))
    if bc[0] == "periodic":
        z[-1] = z[0]
    if bc[1] == "periodic":
        z[:, -1] = z[:, 0]
    j, t = both(z, x, y, bicubic=True, extrapolate=False, bc=bc)
    ev = ts.DoubleFloatEvaluator2D(t, max_batch=512)
    jev = js.DoubleFloatEvaluator2D(j, max_batch=512)
    px, py = x[-1] - x[0], y[-1] - y[0]
    qx = rng.uniform(x[0], x[-1], 100)
    qy = rng.uniform(y[0], y[-1], 100)
    base = ev(qx, qy)
    sx, sy = (2 * px if bc[0] == "periodic" else 0.0), (-3 * py if bc[1] == "periodic" else 0.0)
    wrapped = ev(qx + sx, qy + sy)
    np.testing.assert_allclose(wrapped.numpy(), base.numpy(), rtol=1e-6, atol=1e-9)
    assert scaled_err(wrapped, jev(qx + sx, qy + sy)) <= 1e-12
    nan_q = (np.array([np.nan]), np.array([y[1]])) if bc[0] == "periodic" else (
        np.array([x[1]]), np.array([np.nan]))
    for fn in (ev, jev):
        with pytest.raises(ValueError, match="NaN"):
            fn(*nan_q)


@pytest.mark.parametrize("case", ["x low", "x high", "y low", "y high", "x nan", "y nan",
                                  "both out", "nan, extrapolating", "shapes"])
def test_df_evaluator2d_errors_match_jax(case):
    """OutOfBoundsError for each axis (x checked first, NaN out of range),
    ValueError for NaN when extrapolating and for unmatched shapes: the
    same class and message as the JAX evaluator."""
    x, y, rng = axes(nx=12, ny=9, seed=18)
    j, t = both(rng.normal(size=(12, 9)), x, y, extrapolate=case == "nan, extrapolating")
    qx, qy = np.array([x[2], x[5]]), np.array([y[2], y[5]])
    if case == "shapes":
        qy = np.zeros(3)
    elif case == "nan, extrapolating":
        qy = np.array([y[2], np.nan])
    else:
        axis, what = case.split(" ")
        bad = {"low": -3.0, "high": 1e3, "nan": np.nan, "out": -3.0}[what]
        if axis in ("x", "both"):
            qx = np.array([x[2], bad])
        if axis in ("y", "both"):
            qy = np.array([y[2], bad + 0.5])
    raised = {}
    for pkg, ev in (("jax", js.DoubleFloatEvaluator2D(j)), ("torch", ts.DoubleFloatEvaluator2D(t))):
        with pytest.raises(Exception) as info:
            ev(qx, qy)
        raised[pkg] = info.value
    assert type(raised["torch"]).__name__ == type(raised["jax"]).__name__
    assert str(raised["torch"]) == str(raised["jax"])


def test_df_evaluator2d_grades_and_layouts(monkeypatch):
    """TestF48BicubicTier::test_serving_grade_kwarg: f48 tables are 3/4 of
    the DF tables; a bad grade raises as in JAX.  The bicubic node layout:
    f48 raises JAX's ValueError, df takes the node route (K14)."""
    from ndarray_interp_tpu_torch import config as tconfig

    x, y, rng = axes(seed=41)
    z = rng.normal(size=(20, 16, 2))
    for bicubic in (False, True):
        _, t = both(z, x, y, bicubic=bicubic)
        ev48 = ts.DoubleFloatEvaluator2D(t, max_batch=512, grade="f48")
        evdf = ts.DoubleFloatEvaluator2D(t, max_batch=512)
        assert ev48._packed.shape[1] * 4 == evdf._packed.shape[1] * 3
        with pytest.raises(ValueError, match="grade must be"):
            ts.DoubleFloatEvaluator2D(t, grade="f24")
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 1)
    node = t2.Interp2D.builder(np.ones((8, 8)), device="cpu").strategy(t2.Bicubic()).build()
    assert node.strategy.layout == "node"
    with pytest.raises(ValueError, match="cell layout and bilinear"):
        ts.DoubleFloatEvaluator2D(node, grade="f48")
    ev = ts.DoubleFloatEvaluator2D(node)
    assert tuple(ev._packed.shape) == (64, 12)  # the node table: 8r + 4 columns
    np.testing.assert_allclose(ev([1.5, 6.25], [2.5, 0.5]).numpy(), [1.0, 1.0], rtol=0, atol=1e-14)


def test_df_evaluator2d_from_a_port_build():
    """Built by the port itself (Interp2D.builder on the CPU), not carried
    over: the f64 strategy within 1e-9."""
    x, y, rng = axes(seed=43)
    z = rng.normal(size=(20, 16, 2))
    for strategy in (t2.Bilinear(), t2.Bicubic().boundary("natural", "clamped")):
        t = t2.Interp2D.builder(z, device="cpu").x(x).y(y).strategy(strategy).build()
        qx, qy = rng.uniform(x[0], x[-1], 300), rng.uniform(y[0], y[-1], 300)
        got = ts.DoubleFloatEvaluator2D(t, max_batch=256)(qx, qy)
        assert scaled_err(got, t.interp_array(qx, qy)) < 1e-9


# -- K13's float64 store form -------------------------------------------------------------
def i64(v):
    return v.numpy().view(np.int64)


@pytest.mark.parametrize("r", [1, 3, 16, 20])
def test_f48_bicubic_f64_entries_are_the_recombined_pair(r):
    """``_gathered_bicubic_f48_tail_f64`` and
    ``_gathered_bicubic_eval_f48_packed_f64`` (the entries of K13's float64
    store form) on the CPU: bit for bit ``df_to_f64`` of the pair entries,
    with NaN, +-inf and huge fractions and far extrapolation among the
    queries."""
    x, y, rng = axes(nx=13, ny=10, seed=50 + r)
    rows = cell_rows(13, 10, r, rng)
    packed = tp.pack_bicubic_rows_f48(*tpair(rows), r)
    xi = torch.as_tensor(rng.integers(0, 12, 600), dtype=torch.int32)
    yi = torch.as_tensor(rng.integers(0, 9, 600), dtype=torch.int32)
    t = rng.uniform(-0.5, 1.5, (2, 600))
    t[0, :4], t[1, -4:] = [np.nan, np.inf, -np.inf, 1e30], [np.nan, np.inf, -np.inf, 1e30]
    args = (packed, xi, yi, 10, *tpair(t[0]), *tpair(t[1]))
    got = tp._gathered_bicubic_f48_tail_f64(*args)
    bp = -(-r // 8) * 8
    assert got.dtype == torch.float64 and tuple(got.shape) == (600, bp)
    np.testing.assert_array_equal(i64(got), i64(tdf.df_to_f64(*tp.gathered_bicubic_f48_tail(
        *args))))
    qx = np.r_[rng.uniform(x[0] - 2, x[-1] + 2, 596), [np.nan, np.inf, -np.inf, x[3]]]
    qy = np.r_[rng.uniform(y[0] - 2, y[-1] + 2, 596), [y[2], np.inf, np.nan, -np.inf]]
    q = (*tpair(x), *tpair(y), packed, *tpair(qx), *tpair(qy))
    route = tp._gathered_bicubic_eval_f48_packed_f64(*q, r=r)
    assert tuple(route.shape) == (600, r)
    np.testing.assert_array_equal(
        i64(route.contiguous()), i64(tdf.df_to_f64(*tp.gathered_bicubic_eval_f48_packed(*q, r=r))))


# -- K10's and K11's float64 store form --------------------------------------------------
@pytest.mark.parametrize("grade", ["df", "f48"])
@pytest.mark.parametrize("r", [1, 3, 16, 20])
def test_bilinear_f64_entries_are_the_recombined_pair(grade, r):
    """``_gathered_bilinear_{df,f48}_tail_f64`` and their routes
    ``_gathered_bilinear_eval_{df,f48}_packed_f64`` (the entries of K10's and
    K11's float64 store form) on the CPU: bit for bit ``df_to_f64`` of the
    pair entries, with NaN, +-inf and huge fractions and far extrapolation
    among the queries; CPU tensors launch no kernel."""
    x, y, rng = axes(nx=13, ny=10, seed=70 + r)
    packed = getattr(tp, f"pack_bilinear_rows_{grade}")(*tpair(rng.normal(size=(13, 10, r))))
    tail, tail64 = (getattr(tp, f"gathered_bilinear_{grade}_tail"),
                    getattr(tp, f"_gathered_bilinear_{grade}_tail_f64"))
    route, route64 = (getattr(tp, f"gathered_bilinear_eval_{grade}_packed"),
                      getattr(tp, f"_gathered_bilinear_eval_{grade}_packed_f64"))
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    xi = torch.as_tensor(rng.integers(0, 12, 600), dtype=torch.int32)
    yi = torch.as_tensor(rng.integers(0, 9, 600), dtype=torch.int32)
    t = rng.uniform(-0.5, 1.5, (2, 600))
    t[0, :4], t[1, -4:] = [np.nan, np.inf, -np.inf, 1e30], [np.nan, np.inf, -np.inf, 1e30]
    args = (packed, xi, yi, 10, *tpair(t[0]), *tpair(t[1]))
    got = tail64(*args)
    bp = -(-r // 8) * 8
    assert got.dtype == torch.float64 and tuple(got.shape) == (600, bp)
    np.testing.assert_array_equal(i64(got), i64(tdf.df_to_f64(*tail(*args))))
    qx = np.r_[rng.uniform(x[0] - 2, x[-1] + 2, 596), [np.nan, np.inf, -np.inf, x[3]]]
    qy = np.r_[rng.uniform(y[0] - 2, y[-1] + 2, 596), [y[2], np.inf, np.nan, -np.inf]]
    q = (*tpair(x), *tpair(y), packed, 10, r, *tpair(qx), *tpair(qy))
    got = route64(*q)
    assert got.dtype == torch.float64 and tuple(got.shape) == (600, r)
    np.testing.assert_array_equal(i64(got.contiguous()), i64(tdf.df_to_f64(*route(*q))))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


@pytest.mark.parametrize("grade", ["df", "f48"])
@pytest.mark.parametrize("trailing", [(), (3,), (2, 5), (16,)])
@pytest.mark.parametrize("max_batch", [256, 2048])
def test_bilinear_evaluator2d_output_is_the_recombined_pair_route(grade, trailing, max_batch):
    """``DoubleFloatEvaluator2D`` on ``Bilinear`` runs K10's (K11's) float64
    store form: bit for bit ``df_to_f64`` of the pair route
    ``gathered_bilinear_eval_{df,f48}_packed`` on the same chunks (several
    of them at ``max_batch`` 256), padded with the first knots."""
    x, y, rng = axes(seed=61)
    _, t = both(rng.normal(size=(20, 16) + trailing), x, y)
    ev = ts.DoubleFloatEvaluator2D(t, max_batch=max_batch, grade=grade)
    route = getattr(tp, f"gathered_bilinear_eval_{grade}_packed")
    n = 1000
    qx = torch.as_tensor(rng.uniform(x[0] - 0.5, x[-1] + 0.5, n))
    qy = torch.as_tensor(rng.uniform(y[0] - 0.5, y[-1] + 0.5, n))
    got = ev(qx, qy)
    r = int(np.prod(trailing))
    bsz = ev._bucket(n)
    outs = []
    for start in range(0, n, bsz):
        halves = []
        for flat, pad in ((qx, x[0]), (qy, y[0])):
            chunk = flat[start:start + bsz]
            halves += tpair(torch.cat([chunk, chunk.new_full((bsz - chunk.shape[0],), pad)]))
        outs.append(tdf.df_to_f64(*route(*ev._run.args, *halves)))
    want = torch.cat(outs)[:n]
    assert got.dtype == torch.float64 and tuple(got.shape) == (n,) + trailing
    np.testing.assert_array_equal(i64(got.reshape(n, r).contiguous()), i64(want))


@pytest.mark.parametrize("trailing", [(), (3,), (2, 5), (16,)])
@pytest.mark.parametrize("max_batch", [256, 2048])
def test_f48_bicubic_evaluator2d_output_is_the_recombined_pair_route(trailing, max_batch):
    """``DoubleFloatEvaluator2D(grade="f48")`` on the Bicubic cell layout
    runs K13's float64 store form: bit for bit ``df_to_f64`` of the pair
    route ``gathered_bicubic_eval_f48_packed`` on the same chunks (several
    of them at ``max_batch`` 256), padded with the first knots."""
    x, y, rng = axes(seed=60)
    _, t = both(rng.normal(size=(20, 16) + trailing), x, y, bicubic=True)
    ev = ts.DoubleFloatEvaluator2D(t, max_batch=max_batch, grade="f48")
    n = 1000
    qx = torch.as_tensor(rng.uniform(x[0] - 0.5, x[-1] + 0.5, n))
    qy = torch.as_tensor(rng.uniform(y[0] - 0.5, y[-1] + 0.5, n))
    got = ev(qx, qy)
    r = int(np.prod(trailing))
    bsz = ev._bucket(n)
    outs = []
    for start in range(0, n, bsz):
        halves = []
        for flat, pad in ((qx, x[0]), (qy, y[0])):
            chunk = flat[start:start + bsz]
            halves += tpair(torch.cat([chunk, chunk.new_full((bsz - chunk.shape[0],), pad)]))
        outs.append(tdf.df_to_f64(*tp.gathered_bicubic_eval_f48_packed(*ev._run.args, *halves,
                                                                       r=r)))
    want = torch.cat(outs)[:n]
    assert got.dtype == torch.float64 and tuple(got.shape) == (n,) + trailing
    np.testing.assert_array_equal(i64(got.reshape(n, r).contiguous()), i64(want))


def test_cpu_tensors_launch_no_2d_kernel():
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    x, y, rng = axes(nx=10, ny=8, seed=44)
    z = rng.normal(size=(10, 8, 2))
    for bicubic in (False, True):
        _, t = both(z, x, y, bicubic=bicubic)
        for grade in ("df", "f48"):
            ts.DoubleFloatEvaluator2D(t, max_batch=256, grade=grade)(
                np.linspace(x[0], x[-1], 30), np.linspace(y[0], y[-1], 30))
        ts.Evaluator2D(t, max_batch=256)(np.linspace(x[0], x[-1], 30), np.full(30, y[1]))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


def test_infinite_queries_diverge_from_jax():
    """±inf queries on an extrapolating plane ``2x - 3y + 1``: the port's
    float64 fraction is ±inf, so its double-float bilinear routes give the
    f64 strategy's answer, ∓inf at y = ±inf, where the JAX double-float
    fraction is NaN and its routes NaN.  At x = ±inf the y-lerp meets
    inf - inf: NaN in both; bicubic is NaN at any infinite query in both.
    Logged in ROADMAP Queue 3."""
    x, y = np.arange(10.0), np.arange(8.0)
    z = 2.0 * x[:, None] - 3.0 * y[None, :] + 1.0
    qx = np.array([3.5, 3.5, np.inf, -np.inf])
    qy = np.array([np.inf, -np.inf, 2.5, 2.5])
    for bicubic in (False, True):
        j, t = both(z, x, y, bicubic=bicubic)
        for grade in ("df", "f48"):
            assert np.isnan(js.DoubleFloatEvaluator2D(j, grade=grade)(qx, qy)).all()
            got = ts.DoubleFloatEvaluator2D(t, grade=grade)(qx, qy).numpy()
            want = [np.nan] * 4 if bicubic else [-np.inf, np.inf, np.nan, np.nan]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, t(qx, qy).numpy())


# -- the bicubic node route: K14 ----------------------------------------------------------
def node_case(trailing=(), nx=18, ny=15, seed=41, monkeypatch=None):
    """TestDFBicubicNodeRoute._build: a float64 extrapolating Bicubic on the
    node layout, in JAX and (carried) in the port."""
    from ndarray_interp_tpu import config

    monkeypatch.setattr(config, "bicubic_pack_max_elems", 10)
    x, y, rng = axes(nx, ny, seed)
    j, t = both(rng.normal(size=(nx, ny) + trailing), x, y, bicubic=True)
    assert j.strategy.layout == t.strategy.layout == "node"
    return j, t, x, y, rng


def node_rows(nn, r, rng):
    """Random node rows ``(nn, 4r+2)`` with rising coordinates."""
    nodes = rng.normal(size=(nn, 4 * r + 2))
    nodes[:, 4 * r] = np.cumsum(rng.uniform(0.2, 1.0, nn))
    nodes[:, 4 * r + 1] = np.cumsum(rng.uniform(0.2, 1.0, nn))
    return nodes


@pytest.mark.parametrize("r", [1, 3, 16])
def test_node_table_matches_jax_bit_for_bit(r):
    nodes = node_rows(40, r, np.random.default_rng(r))
    want = np.asarray(jp.pack_bicubic_nodes_df(*jpair(nodes)))
    got = tp.pack_bicubic_nodes_df(*tpair(nodes))
    assert tuple(got.shape) == want.shape == (40, 8 * r + 4)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("r", [1, 16])
def test_node_tail_matches_jax_node_tail(r):
    """The plain K14 against JAX ``_df_node_tail`` (XLA, 4e-12) and its
    Mosaic kernel in interpret mode (1e-5, TestDFBicubicNodeRoute::
    test_node_tail_kernel_interpret_plumbing), on the same gathered rows."""
    rng = np.random.default_rng(7)
    nn, nq = 40, 512
    nodes = node_rows(nn, r, rng)
    jpk, tpk = jp.pack_bicubic_nodes_df(*jpair(nodes)), tp.pack_bicubic_nodes_df(*tpair(nodes))
    ny = 5
    xi = rng.integers(0, nn // ny - 1, nq).astype(np.int32)
    yi = rng.integers(0, ny - 1, nq).astype(np.int32)
    base = xi.astype(np.int64) * ny + yi
    g = [jnp.take(jpk, jnp.asarray(base + off), axis=0) for off in (0, 1, ny, ny + 1)]
    t64 = rng.uniform(-0.5, 1.5, (2, nq))
    jt = jpair(t64[0]) + jpair(t64[1])
    xla = jax.jit(lambda *a: jp._df_node_tail(*a[:4], *(v[:, None] for v in a[4:]), r))(*g, *jt)
    mosaic = jp.bicubic_df_node_tail(*g, *jt, r=r, interpret=True, bq=256)
    args = (tpk, torch.as_tensor(xi), torch.as_tensor(yi), ny, *tpair(t64[0]), *tpair(t64[1]))
    hi, lo = tp.gathered_bicubic_node_df_tail(*args)
    assert tuple(hi.shape) == (nq, r) and hi.dtype == torch.float32
    got = tdf.df_to_f64(hi, lo).numpy()
    assert scaled_err(got, jf64(xla)) <= 4e-12
    want = jf64(mosaic)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    for a, b in zip((hi, lo), tp._bicubic_node_df_tail_plain(*args)):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_node_route_matches_jax_and_the_f64_strategy(trailing, monkeypatch):
    """TestDFBicubicNodeRoute::test_route_matches_f64_strategy: in range,
    and extrapolating a quarter span past x (test_extrapolation_matches_strategy)."""
    j, t, x, y, rng = node_case(trailing, monkeypatch=monkeypatch)
    r = int(np.prod(trailing))
    x, y = rep(x), rep(y)
    rows64 = np.asarray(j.strategy.rows)
    span = x[-1] - x[0]
    qx = rep(np.r_[rng.uniform(x[0], x[-1], 300), x[0] - rng.uniform(0, span / 4, 50),
                   x[-1] + rng.uniform(0, span / 4, 50)])
    qy = rep(rng.uniform(y[0], y[-1], 400))
    want = jf64(jax.jit(lambda *a: jp.gathered_bicubic_nodes_eval_df(*a, r=r))(
        *jpair(x), *jpair(y), jp.pack_bicubic_nodes_df(*jpair(rows64)), *jpair(qx), *jpair(qy)))
    got = tf64(tp.gathered_bicubic_nodes_eval_df(
        *tpair(x), *tpair(y), tp.pack_bicubic_nodes_df(*tpair(rows64)), *tpair(qx), *tpair(qy),
        r=r))
    assert got.shape == (400, r)
    assert scaled_err(got, want.reshape(400, r)) <= 4e-12
    strategy = np.asarray(j.interp_array(qx, qy)).reshape(400, r)
    assert scaled_err(got, strategy) < 1e-9
    assert scaled_err(got, t.interp_array(qx, qy).numpy().reshape(400, r)) < 1e-9
    with pytest.raises(ValueError, match="columns"):
        tp.gathered_bicubic_nodes_eval_df(*tpair(x), *tpair(y), tp.pack_bicubic_nodes_df(
            *tpair(rows64)), *tpair(qx), *tpair(qy), r=r + 1)


def test_node_layout_evaluator_matches_jax(monkeypatch):
    """TestDFBicubicNodeRoute::test_serving_evaluator_node_layout."""
    j, t, x, y, rng = node_case((2,), monkeypatch=monkeypatch)
    ev = ts.DoubleFloatEvaluator2D(t, max_batch=512).warmup()
    jev = js.DoubleFloatEvaluator2D(j, max_batch=512)
    assert tuple(ev._packed.shape) == tuple(jev._packed.shape)
    np.testing.assert_array_equal(bits(ev._packed), bits(jev._packed))
    qx, qy = rng.uniform(x[0] - 1, x[-1] + 1, 700), rng.uniform(y[0], y[-1], 700)
    got = ev(qx, qy)
    assert got.dtype == torch.float64 and tuple(got.shape) == (700, 2)
    assert scaled_err(got, j.interp_array(qx, qy)) < 1e-9
    assert scaled_err(got, jev(qx, qy)) <= 1e-12
    with pytest.raises(ValueError) as t_err:
        ts.DoubleFloatEvaluator2D(t, grade="f48")
    with pytest.raises(ValueError) as j_err:
        js.DoubleFloatEvaluator2D(j, grade="f48")
    assert str(t_err.value) == str(j_err.value)
