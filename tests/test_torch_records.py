"""The port's counterparts of the JAX package's double-float record tails
R4a-R4c, against the JAX package on the CPU.

* R4c, the weight-form bicubic tail of ``ops/df_records.py``
  (``_df_bicubic_weight_tail``, kernel ``_df_bicubic_weight_kernel``), is the
  port's ``gathered_bicubic_df_weight_tail``: twins of
  ``tests/test_df.py::TestDFBicubicWeightTail`` and of the route's ``tail=``
  switch (``gathered_bicubic_eval_df_packed``).
* R4a (``_df_bilinear_tail_kernel``) and R4b (``_df_bicubic_tail_kernel``)
  compute the lerp form and the nested Hermite form that the port's K10 and
  K12 kernels already compute, in the same order: the tests pin K10's and
  K12's plain versions to those JAX tails.

Tolerances, as in ``tests/test_df.py``: 1e-12 of the float64 oracle and
4e-12 of the JAX XLA forms (max error over the largest value); 1e-5 of the
Pallas tails in interpret mode, which degrades the error-free transforms;
the weight form within 1e-13 of the nested form (scale-relative: the error
over max(|value|, 1% of the largest |value|)), the same function summed in
another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.ops import df as jdf
from ndarray_interp_tpu.ops import df_records as jrec
from ndarray_interp_tpu.ops import pallas_eval_df as jp
from ndarray_interp_tpu_torch.ops import df as tdf
from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as tp
from ndarray_interp_tpu_torch.ops import kernel_wrappers


def tpair(v):
    return list(tdf.df_from_f64(torch.as_tensor(np.array(v, np.float64))))


def jpair(v):
    return [jnp.asarray(w) for w in jdf.df_from_f64(np.asarray(v, np.float64))]


def f64(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def max_err(got, want):
    """The error over the largest |value| (``TestDFBicubicWeightTail``)."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def scaled_err(got, want):
    scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
    return float(np.max(np.abs(got - want) / scale))


def bits(v):
    return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).view(np.int32)


def weight_fixture(B=512, r=16, seed=11):
    """``TestDFBicubicWeightTail._fixture``: random cell rows ``(B, 16 r)``
    in float64 and their pair table ``(B, 32 r)``, fractions in [-0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    rows64 = rng.normal(size=(B, 16 * r))
    rh, rl = tdf.df_from_f64(torch.as_tensor(rows64))
    rows = torch.cat([rh, rl], dim=1)
    tx64 = rng.uniform(-0.5, 1.5, B)
    ty64 = rng.uniform(-0.5, 1.5, B)
    return rows64, rows, tx64, ty64, tpair(tx64) + tpair(ty64)


def oracle(rows64, tx64, ty64, r):
    """``TestDFBicubicWeightTail._oracle``: the nested Hermite in float64."""

    def herm(y_l, y_r, K_l, K_r, t):
        dy = y_r - y_l
        a = K_l - dy
        b = dy - K_r
        return (1 - t) * y_l + t * y_r + t * (1 - t) * (a * (1 - t) + b * t)

    g = rows64.reshape(rows64.shape[0], 4, 4, r)
    tx, ty = tx64[:, None], ty64[:, None]
    f_y1 = herm(g[:, 0, 0], g[:, 0, 2], g[:, 1, 0], g[:, 1, 2], tx)
    f_y2 = herm(g[:, 0, 1], g[:, 0, 3], g[:, 1, 1], g[:, 1, 3], tx)
    g_y1 = herm(g[:, 2, 0], g[:, 2, 2], g[:, 3, 0], g[:, 3, 2], tx)
    g_y2 = herm(g[:, 2, 1], g[:, 2, 3], g[:, 3, 1], g[:, 3, 3], tx)
    return herm(f_y1, f_y2, g_y1, g_y2, ty)


def as_table(rows):
    """A row table addressed one cell a query: ``ny = 2`` makes cell ``xi``."""
    nq = rows.shape[0]
    return rows, torch.arange(nq, dtype=torch.int32), torch.zeros(nq, dtype=torch.int32), 2


# -- R4c: the weight-form tail ------------------------------------------------------------
def test_weight_tail_matches_the_f64_oracle_and_the_jax_tail():
    """TestDFBicubicWeightTail::test_guarded_xla_jit_f64_grade: the plain R4c
    within 1e-12 of the float64 oracle and 4e-12 of the jitted JAX tail."""
    r = 16
    rows64, rows, tx64, ty64, t = weight_fixture(r=r)
    got = f64(tp._df_bicubic_weight_tail(rows, *t, r))
    assert max_err(got, oracle(rows64, tx64, ty64, r)) < 1e-12
    jrows = jnp.asarray(rows.numpy())
    want = jax.jit(lambda rw, a, b, c, d: jrec._df_bicubic_weight_tail(
        rw, a[:, None], b[:, None], c[:, None], d[:, None], r))(
        jrows, *(jnp.asarray(v.numpy()) for v in t))
    assert max_err(got, f64(want)) < 4e-12


@pytest.mark.parametrize("r", [8, 16])
def test_weight_tail_matches_the_record_kernel_in_interpret_mode(r):
    """TestDFBicubicWeightTail::test_kernel_interpret_plumbing ("weight"): the
    wrapper's plain version on the rows as a table, within 1e-5 of
    ``bicubic_df_tail_w(interpret=True)`` and 1e-12 of the oracle."""
    rows64, rows, tx64, ty64, t = weight_fixture(r=r)
    hi, lo = tp.gathered_bicubic_df_weight_tail(*as_table(rows), *t)
    assert tuple(hi.shape) == tuple(lo.shape) == (512, r)
    assert hi.dtype == lo.dtype == torch.float32
    got = f64((hi, lo))
    want = jrec.bicubic_df_tail_w(jnp.asarray(rows.numpy()), *(jnp.asarray(v.numpy()) for v in t),
                                  interpret=True)
    assert max_err(got, f64(want)) < 1e-5
    assert max_err(got, oracle(rows64, tx64, ty64, r)) < 1e-12


def test_weight_tail_is_the_block_order_sum_of_the_16_weights():
    """The plain R4c on one query, written out: the bases, the 16 products
    and their sum in block order, in float64."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=16)
    rows = torch.cat(tpair(np.repeat(v, 8)[None]), dim=1)  # bp = 8, channel 0 used
    v = tdf.df_to_f64(*tpair(v)).numpy()
    tx, ty = (tdf.df_to_f64(*tpair([t])).item() for t in (0.3, -0.7))

    def basis(t):
        u = 1.0 - t
        d = u - t
        p = t * u
        return [u + p * d, t - p * d, p * u, -(p * t)]

    bx, by = basis(tx), basis(ty)
    want = None
    for b in range(16):
        i, c = divmod(b, 4)
        ax = bx[c >> 1] if i in (0, 2) else bx[2 + (c >> 1)]
        ay = by[c & 1] if i in (0, 1) else by[2 + (c & 1)]
        want = ax * ay * v[b] if want is None else want + ax * ay * v[b]
    hi, lo = tp.gathered_bicubic_df_weight_tail(*as_table(rows), *tpair([tx]), *tpair([ty]))
    # the float64 sum, split into the result pair
    assert tdf.df_to_f64(hi[:, 0], lo[:, 0]).item() == tdf.df_to_f64(*tpair([want])).item()


def test_weight_tail_with_nonfinite_fractions():
    """A NaN or infinite fraction gives a non-finite result, with lo = 0,
    and the finite queries are untouched by their neighbours."""
    rng = np.random.default_rng(4)
    rows = torch.cat(tpair(rng.normal(size=(4, 16 * 8))), dim=1)
    t = tpair([0.25, np.nan, np.inf, -np.inf])
    hi, lo = tp.gathered_bicubic_df_weight_tail(*as_table(rows), *t, *tpair([0.5] * 4))
    assert torch.isfinite(hi[0]).all() and not torch.isfinite(hi[1:]).any()
    assert (lo[1:] == 0).all()
    alone, _ = tp.gathered_bicubic_df_weight_tail(*as_table(rows[:1]), *tpair([0.25]),
                                                  *tpair([0.5]))
    np.testing.assert_array_equal(bits(alone), bits(hi[:1]))


# -- the route's tail= switch -----------------------------------------------------------
def route_case(nx=12, ny=10, r=3, nq=200, seed=12):
    """TestDFBicubicWeightTail::test_weight_route_interpret_matches_nested_route."""
    rng = np.random.default_rng(seed)
    x64 = np.cumsum(rng.uniform(0.2, 1.0, nx))
    y64 = np.cumsum(rng.uniform(0.2, 1.0, ny))
    rows64 = rng.normal(size=((nx - 1) * (ny - 1), 16 * r))
    qx = rng.uniform(x64[0], x64[-1], nq)
    qy = rng.uniform(y64[0], y64[-1], nq)
    return x64, y64, rows64, qx, qy, r


def jax_route(case, tail):
    x64, y64, rows64, qx, qy, r = case
    packed = jp.pack_bicubic_rows_df(*jpair(rows64), r)
    args = jpair(x64) + jpair(y64) + [packed] + jpair(qx) + jpair(qy)
    return f64(jax.jit(lambda *a: jp.gathered_bicubic_eval_df_packed(*a, r=r, tail=tail))(*args))


def port_route(case, tail):
    x64, y64, rows64, qx, qy, r = case
    packed = tp.pack_bicubic_rows_df(*tpair(rows64), r)
    return tp.gathered_bicubic_eval_df_packed(*tpair(x64), *tpair(y64), packed, *tpair(qx),
                                              *tpair(qy), r=r, tail=tail)


@pytest.mark.parametrize("tail", ["weight", "nested", "mxu"])
def test_route_tails_match_jax(tail):
    """Each tail of the port's route within 4e-12 of the JAX route (which
    computes the nested form off the TPU whatever the tail)."""
    case = route_case()
    got = f64(port_route(case, tail))
    assert got.shape == (200, 3)
    assert scaled_err(got, jax_route(case, tail)) <= 4e-12


def test_weight_tail_diverges_from_jax_off_the_tpu():
    """``tail="weight"`` runs the weight form in the port on every device,
    within 1e-13 of the nested form but not bit for bit; the JAX package
    runs the nested form off the TPU whatever the tail, so its two tails
    are equal there."""
    case = route_case(nx=15, ny=11, r=16, nq=700, seed=13)
    weight, nested = f64(port_route(case, "weight")), f64(port_route(case, "nested"))
    assert scaled_err(weight, nested) <= 1e-13
    assert not np.array_equal(weight, nested)  # another order: another rounding somewhere
    np.testing.assert_array_equal(jax_route(case, "weight"), jax_route(case, "nested"))


def test_route_tails_run_their_forms_on_the_cpu():
    """The tail picks the form on every device: on CPU tensors ``"weight"``
    is R4c's plain version and ``"mxu"`` and ``"nested"`` K12's, bit for
    bit, and no kernel is launched."""
    x64, y64, rows64, qx, qy, r = route_case()
    packed = tp.pack_bicubic_rows_df(*tpair(rows64), r)
    xi, txh, txl = tp.fused_index_frac_df(*tpair(x64), *tpair(qx))
    yi, tyh, tyl = tp.fused_index_frac_df(*tpair(y64), *tpair(qy))
    args = (packed, xi, yi, y64.size, txh, txl, tyh, tyl)
    before = {k: w.launches for k, w in kernel_wrappers().items()}
    for tail, plain in (("weight", tp._bicubic_df_weight_tail_plain),
                        ("nested", tp._bicubic_df_tail_plain), ("mxu", tp._bicubic_df_tail_plain)):
        got = port_route((x64, y64, rows64, qx, qy, r), tail)
        for g, w in zip(got, plain(*args)):
            np.testing.assert_array_equal(bits(g), bits(w[:, :r]), err_msg=tail)
    assert before == {k: w.launches for k, w in kernel_wrappers().items()}
    assert kernel_wrappers()["R4c"] is tp.gathered_bicubic_df_weight_tail


def test_unknown_tail_raises_key_error_as_in_jax():
    case = route_case(nq=8)
    with pytest.raises(KeyError):
        jax_route(case, "tree")
    with pytest.raises(KeyError):
        port_route(case, "tree")


# -- R4a and R4b: the forms K10 and K12 already compute ---------------------------------------
def cell_case(kind, r, nq=512, nx=11, ny=9, seed=7):
    """A packed table, random cells and fractions in [-0.5, 1.5], the JAX
    gathered rows and the port's tail arguments."""
    rng = np.random.default_rng(seed + r)
    if kind == "bilinear":
        src, extra = rng.normal(size=(nx, ny, r)), ()
    else:
        src, extra = rng.normal(size=((nx - 1) * (ny - 1), 16 * r)), (r,)
    jpk = getattr(jp, f"pack_{kind}_rows_df")(*jpair(src), *extra)
    tpk = getattr(tp, f"pack_{kind}_rows_df")(*tpair(src), *extra)
    xi = rng.integers(0, nx - 1, nq).astype(np.int32)
    yi = rng.integers(0, ny - 1, nq).astype(np.int32)
    t = rng.uniform(-0.5, 1.5, (2, nq))
    rows = jnp.take(jpk, jnp.asarray(xi * (ny - 1) + yi), axis=0)
    args = (tpk, torch.as_tensor(xi), torch.as_tensor(yi), ny, *tpair(t[0]), *tpair(t[1]))
    return rows, jpair(t[0]) + jpair(t[1]), args


@pytest.mark.parametrize("r", [1, 3, 16])
def test_k10_plain_version_is_the_r4a_tail(r):
    """R4a: the port's K10 plain version within 1e-5 of
    ``bilinear_df_tail(interpret=True)`` and 4e-12 of ``_df_bilinear_core``
    on the same corner pairs and fractions."""
    rows, jt, args = cell_case("bilinear", r)
    got = f64(tp._bilinear_df_tail_plain(*args))[:, :r]
    mosaic = jp.bilinear_df_tail(rows, *jt, interpret=True)
    assert max_err(got, f64(mosaic)[:, :r]) < 1e-5
    bp = rows.shape[1] // 8

    def core(rows, txh, txl, tyh, tyl):
        corner = [(rows[:, i * bp : (i + 1) * bp], rows[:, (i + 4) * bp : (i + 5) * bp])
                  for i in range(4)]
        return jp._df_bilinear_core(*corner, (txh[:, None], txl[:, None]),
                                    (tyh[:, None], tyl[:, None]))

    assert max_err(got, f64(jax.jit(core)(rows, *jt))[:, :r]) < 4e-12


@pytest.mark.parametrize("r", [1, 3, 16])
def test_k12_plain_version_is_the_r4b_tail(r):
    """R4b: the port's K12 plain version within 1e-5 of
    ``bicubic_df_tail(interpret=True)`` and 4e-12 of ``_df_bicubic_tail``."""
    rows, jt, args = cell_case("bicubic", r)
    got = f64(tp._bicubic_df_tail_plain(*args))[:, :r]
    mosaic = jp.bicubic_df_tail(rows, *jt, interpret=True)
    assert max_err(got, f64(mosaic)[:, :r]) < 1e-5
    bp = rows.shape[1] // 32
    xla = jax.jit(lambda rw, *t: jp._df_bicubic_tail(rw, *(v[:, None] for v in t), bp))(rows, *jt)
    assert max_err(got, f64(xla)[:, :r]) < 4e-12
    weight = f64(tp._bicubic_df_weight_tail_plain(*args))[:, :r]
    assert scaled_err(weight, got) <= 1e-13
