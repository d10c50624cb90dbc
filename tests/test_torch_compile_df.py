"""The port's f64-grade and N-D paths under ``torch.compile``, against the
JAX package under ``jax.jit``, on the CPU.

The double-float kernels K6-K15, R4c and ORD are operators of the
``ndarray_interp`` namespace (``ops.kernel_ops``), so
``torch.compile(fullgraph=True)`` traces the f64-grade routes with each
kernel one node of the graph, and ``DoubleFloatEvaluator``,
``DoubleFloatEvaluator2D``, ``DoubleFloatEvaluatorND`` and ``EvaluatorND``
serve every bucket through one compiled program.  The graphs run on
``backend="aot_eager"`` here (the kernels' plain versions; inductor is the
card's backend).

Twins of the JAX package's ``jax.jit`` tests on the same seeded inputs:
``tests/test_df.py``'s bicubic cell and node routes, the node route's
extrapolation, the weight tail, the weight and nested tails of one route,
the f48 bicubic and bank routes, and ``tests/test_interpnd.py``'s
``test_jit_vmap_grad`` and ``test_cubic_jit_grad``.  Each compiled result is
held bit for bit against the port's eager call and against JAX's jitted one
at the JAX test's tolerance (scale-relative: the error over max(|value|, 1%
of the largest |value|), as ``tests/test_df.py`` does; the weight tail over
the largest |value|).  Then ``torch.library.opcheck`` of every new op, with
and without gradients; a capturing backend that finds the DF ops in the
evaluators' graphs; the compiled and eager calls reaching the same ops the
same number of times; the four evaluators serving every bucket after
``warmup()`` under ``fail_on_recompile``; and ``torch.func.vmap`` over each
f64-grade route, equal to the loop with one op call a kernel.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interpnd as jn
import ndarray_interp_tpu_torch.serving as ts
from ndarray_interp_tpu import config as jconfig
from ndarray_interp_tpu.interp2d import Bicubic as JBicubic
from ndarray_interp_tpu.interp2d import Interp2D as JInterp2D
from ndarray_interp_tpu.ops import df as jdf
from ndarray_interp_tpu.ops import df_records as jrec
from ndarray_interp_tpu.ops import pallas_eval_df as jp
from ndarray_interp_tpu_torch import config as tconfig
from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D, Linear
from ndarray_interp_tpu_torch.interp2d import Bicubic, Bilinear, Interp2D
from ndarray_interp_tpu_torch.interpnd import InterpND
from ndarray_interp_tpu_torch.ops import _cuda, kernel_ops, kernel_wrappers
from ndarray_interp_tpu_torch.ops import cell_order as co
from ndarray_interp_tpu_torch.ops import df as tdf
from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as tp
from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as tn


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


def same_pair(got, want):
    for g, w in zip(got, want):
        same(g, w)


def tpair(v):
    return list(tdf.df_from_f64(torch.as_tensor(np.array(v, np.float64))))


def jpair(v):
    return [jnp.asarray(w) for w in jdf.df_from_f64(np.asarray(v, np.float64))]


def f64(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def scaled_err(got, want):
    scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
    return float(np.max(np.abs(got - want) / scale))


# -- the twins of tests/test_df.py -------------------------------------------------------
def bicubic_grid(trailing=(), nx=20, ny=16, seed=37):
    """``TestDFBicubicGatherRoute._build``: a float64 JAX ``Bicubic`` that
    extrapolates, its rng after the grid."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.0, nx))
    y = np.cumsum(rng.uniform(0.2, 1.0, ny))
    z = rng.normal(size=(nx, ny) + trailing)
    itp = JInterp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).strategy(
        JBicubic().extrapolate(True)).build()
    return itp, rng


def route_inputs(itp):
    return (np.asarray(itp.x, np.float64), np.asarray(itp.y, np.float64),
            np.asarray(itp.strategy.rows, np.float64))


def held(port, jax_fn, port_args, jax_args, shape, tol, want=None):
    """``port`` compiled on ``port_args``: bit for bit its eager call, and
    within ``tol`` (scale-relative) of ``jax_fn`` jitted on ``jax_args`` and
    of ``want``.  Returns the compiled pair recombined."""
    got = compiled(port)(*port_args)
    same_pair(got, port(*port_args))
    got64 = f64(got).reshape(shape)
    jgot = f64(jax.jit(jax_fn)(*jax_args)).reshape(shape)
    assert scaled_err(got64, jgot) < tol
    if want is not None:
        assert scaled_err(got64, want) < tol
    return got64


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_bicubic_df_route_under_compile(trailing):
    """``TestDFBicubicGatherRoute.test_route_matches_f64_strategy``
    (``test_df.py:556``): the pack, K7 twice and K12 compiled, within 1e-9
    of JAX's jitted route and of the float64 strategy."""
    itp, rng = bicubic_grid(trailing)
    r = int(np.prod(trailing))
    x64, y64, rows64 = route_inputs(itp)
    qx = rng.uniform(x64[0], x64[-1], 400)
    qy = rng.uniform(y64[0], y64[-1], 400)
    vals = (x64, y64, rows64, qx, qy)
    held(lambda *a: tp.gathered_bicubic_eval_df(*a, r=r),
         lambda *a: jp.gathered_bicubic_eval_df(*a, r=r),
         [w for v in vals for w in tpair(v)], [w for v in vals for w in jpair(v)],
         (400,) + trailing, 1e-9, np.asarray(itp.interp_array(qx, qy)))


def node_case(monkeypatch, trailing=()):
    """``TestDFBicubicNodeRoute._build``: the node layout forced in both
    packages."""
    monkeypatch.setattr(jconfig, "bicubic_pack_max_elems", 10)
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    itp, rng = bicubic_grid(trailing, nx=18, ny=15, seed=41)
    assert itp.strategy.layout == "node"
    return itp, rng


def node_route(itp, qx, qy, r, shape):
    x64, y64, rows64 = route_inputs(itp)
    tpacked = tp.pack_bicubic_nodes_df(*tpair(rows64))
    jpacked = jp.pack_bicubic_nodes_df(*jdf.df_from_f64(rows64))
    targs = tpair(x64) + tpair(y64) + [tpacked] + tpair(qx) + tpair(qy)
    jargs = jpair(x64) + jpair(y64) + [jpacked] + jpair(qx) + jpair(qy)
    return held(lambda *a: tp.gathered_bicubic_nodes_eval_df(*a, r=r),
                lambda *a: jp.gathered_bicubic_nodes_eval_df(*a, r=r), targs, jargs, shape, 1e-9,
                np.asarray(itp.interp_array(qx, qy)))


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_bicubic_node_route_under_compile(trailing, monkeypatch):
    """``TestDFBicubicNodeRoute.test_route_matches_f64_strategy``
    (``test_df.py:659``): K7 twice and K14 compiled."""
    itp, rng = node_case(monkeypatch, trailing)
    x64, y64, _ = route_inputs(itp)
    qx = rng.uniform(x64[0], x64[-1], 400)
    qy = rng.uniform(y64[0], y64[-1], 400)
    node_route(itp, qx, qy, int(np.prod(trailing)), (400,) + trailing)


def test_bicubic_node_route_extrapolates_under_compile(monkeypatch):
    """``TestDFBicubicNodeRoute.test_extrapolation_matches_strategy``
    (``test_df.py:782``): queries beyond both ends of x."""
    itp, rng = node_case(monkeypatch)
    x64, y64, _ = route_inputs(itp)
    span = x64[-1] - x64[0]
    qx = np.concatenate([x64[0] - rng.uniform(0, span / 4, 50),
                         x64[-1] + rng.uniform(0, span / 4, 50)])
    qy = rng.uniform(y64[0], y64[-1], 100)
    node_route(itp, qx, qy, 1, (100,))


def test_weight_tail_under_compile():
    """``TestDFBicubicWeightTail.test_guarded_xla_jit_f64_grade``
    (``test_df.py:885``): R4c compiled on 512 cell rows of 16 channels (a
    table of one row a query: cell ``xi·(ny-1) + yi`` with ``ny = 2``,
    ``yi = 0``), within 1e-12 of JAX's jitted tail over the largest
    |value|."""
    rng = np.random.default_rng(11)
    B, r = 512, 16
    rows64 = rng.normal(size=(B, 16 * r))
    tx64 = rng.uniform(-0.5, 1.5, B)
    ty64 = rng.uniform(-0.5, 1.5, B)
    rh, rl = jdf.df_from_f64(rows64)
    jt = jpair(tx64) + jpair(ty64)
    jhi, jlo = jax.jit(lambda rw, a, b, c, d: jrec._df_bicubic_weight_tail(
        rw, a[:, None], b[:, None], c[:, None], d[:, None], r))(
        jnp.concatenate([jnp.asarray(rh), jnp.asarray(rl)], axis=1), *jt)
    packed = tp.pack_bicubic_rows_df(*tpair(rows64), r)
    xi = torch.arange(B, dtype=torch.int32)
    yi = torch.zeros(B, dtype=torch.int32)
    args = (packed, xi, yi, 2, *tpair(tx64), *tpair(ty64))
    got = compiled(tp.gathered_bicubic_df_weight_tail)(*args)
    same_pair(got, tp.gathered_bicubic_df_weight_tail(*args))
    want = f64((jhi, jlo))
    assert np.abs(f64(got) - want).max() / np.abs(want).max() < 1e-12


def test_weight_and_nested_routes_under_compile():
    """``TestDFBicubicWeightTail.test_weight_route_interpret_matches_nested_route``
    (``test_df.py:939``): both tails of one route compiled.  JAX computes
    the nested form off the TPU whatever the tail, so its two are equal;
    the port runs the weight form (R4c) on every device, within 1e-13 of
    the nested one (K12), each within 4e-12 of JAX's."""
    rng = np.random.default_rng(12)
    nx, ny, r = 12, 10, 3
    x64 = np.cumsum(rng.uniform(0.2, 1.0, nx))
    y64 = np.cumsum(rng.uniform(0.2, 1.0, ny))
    rows64 = rng.normal(size=((nx - 1) * (ny - 1), 16 * r))
    qx = rng.uniform(x64[0], x64[-1], 200)
    qy = rng.uniform(y64[0], y64[-1], 200)
    targs = (tpair(x64) + tpair(y64) + [tp.pack_bicubic_rows_df(*tpair(rows64), r)] + tpair(qx)
             + tpair(qy))
    jargs = (jpair(x64) + jpair(y64) + [jp.pack_bicubic_rows_df(*jpair(rows64), r)] + jpair(qx)
             + jpair(qy))
    out = {tail: held(lambda *a, t=tail: tp.gathered_bicubic_eval_df_packed(*a, r=r, tail=t),
                      lambda *a, t=tail: jp.gathered_bicubic_eval_df_packed(*a, r=r, tail=t),
                      targs, jargs, (200, r), 4e-12)
           for tail in ("weight", "nested")}
    assert scaled_err(out["weight"], out["nested"]) <= 1e-13


def test_f48_bicubic_route_under_compile():
    """``TestF48BicubicTier.test_route_grade_on_cpu`` (``test_df.py:1031``):
    K7 twice and K13 compiled, within 1e-8 of JAX's jitted route and of
    the float64 strategy."""
    itp, rng = bicubic_grid((3,))
    x64, y64, rows64 = route_inputs(itp)
    qx = rng.uniform(x64[0], x64[-1], 400)
    qy = rng.uniform(y64[0], y64[-1], 400)
    targs = (tpair(x64) + tpair(y64) + [tp.pack_bicubic_rows_f48(*tpair(rows64), 3)] + tpair(qx)
             + tpair(qy))
    jargs = (jpair(x64) + jpair(y64) + [jp.pack_bicubic_rows_f48(*jpair(rows64), 3)]
             + jpair(qx) + jpair(qy))
    held(lambda *a: tp.gathered_bicubic_eval_f48_packed(*a, r=3),
         lambda *a: jp.gathered_bicubic_eval_f48_packed(*a, r=3), targs, jargs, (400, 3), 1e-8,
         np.asarray(itp.interp_array(qx, qy)))


def bank_case(n=512, bank=16, nq=2048, seed=12):
    """``TestF48BankTier._fixture``."""
    rng = np.random.default_rng(seed)
    x64 = np.cumsum(rng.uniform(0.05, 1.0, n))
    d64 = rng.normal(size=(n, bank))
    a64 = rng.normal(size=(n - 1, bank))
    b64 = rng.normal(size=(n - 1, bank))
    q64 = np.r_[rng.uniform(x64[0] - 1, x64[-1] + 1, nq - 4),
                [x64[0], x64[-1], x64[7], x64[n // 2]]]
    return x64, d64, a64, b64, q64


def test_f48_bank_route_under_compile():
    """``TestF48BankTier.test_route_grade_on_cpu`` (``test_df.py:1227``): K7
    and K9 compiled, within 1e-8 of JAX's jitted route and of the exact
    double-float banked form."""
    x64, d64, a64, b64, q64 = bank_case()
    bank = d64.shape[1]
    tpk = ek.pack_bank_rows_f48(*(w for v in (d64, a64, b64) for w in tpair(v)))
    jpk = jp.pack_bank_rows_f48(*(w for v in (d64, a64, b64) for w in jpair(v)))
    jwant = f64(jp.eval_xla_df_banked(*(w for v in (x64, d64, a64, b64, q64) for w in jpair(v))))
    got = held(lambda xh, xl, pk, qh, ql: ek.gathered_bank_eval_f48_packed(xh, xl, pk, bank, qh,
                                                                            ql),
               lambda xh, xl, pk, qh, ql: jp.gathered_bank_eval_f48_packed(xh, xl, pk, bank, qh,
                                                                            ql),
               tpair(x64) + [tpk] + tpair(q64), jpair(x64) + [jpk] + jpair(q64), (2048, bank),
               1e-8)
    scale = np.maximum(np.abs(jwant), 0.01 * np.abs(d64).max())
    assert (np.abs(got - jwant) / scale).max() < 1e-8


# -- the twins of tests/test_interpnd.py ---------------------------------------------------
def nd_grid(k, seed):
    """``tests/test_interpnd.py:_grid_case``."""
    rng = np.random.default_rng(seed)
    axes = [np.sort(rng.uniform(-4.0, 4.0, n)) for n in [5, 4, 6, 3, 4][:k]]
    return axes, rng.normal(size=tuple(len(a) for a in axes)), rng


def test_interpnd_jit_vmap_grad_under_compile():
    """``test_jit_vmap_grad`` (``test_interpnd.py:260``): the 3-D linear
    call compiled (K2 on each axis), bit for bit the eager call and within
    1e-13 of JAX's jitted one; the compiled ``vmap`` over 4 rows; the
    gradient of the compiled call on a plane, its slope 2."""
    axes, data, rng = nd_grid(3, seed=11)
    qs = [rng.uniform(a[0], a[-1], 16) for a in axes]
    t = InterpND.builder(data, device="cpu").points(*axes).build()
    j = jn.InterpND.builder(jnp.asarray(data)).points(*(jnp.asarray(a) for a in axes)).build()
    tq = [torch.as_tensor(q) for q in qs]
    got = compiled(lambda *q: t(*q))(*tq)
    same(got, t(*tq))
    want = np.asarray(jax.jit(lambda i, *q: i(*q))(j, *(jnp.asarray(q) for q in qs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    rows = compiled(lambda a, b, c: torch.func.vmap(t)(a, b, c))(*(q.reshape(4, 4) for q in tq))
    same(rows.reshape(-1), got)
    ax = [np.array([0.0, 1.0, 2.0]), np.array([0.0, 2.0])]
    x, y = np.meshgrid(*ax, indexing="ij")
    plane = InterpND.builder(2.0 * x + 3.0 * y, device="cpu").points(*ax).build()
    qx = torch.tensor([0.6], dtype=torch.float64, requires_grad=True)
    compiled(lambda a, b: plane(a, b).sum())(qx, torch.tensor([1.1], dtype=torch.float64)).backward()
    np.testing.assert_allclose(float(qx.grad), 2.0, atol=1e-13)


def test_interpnd_cubic_jit_grad_under_compile():
    """``test_cubic_jit_grad`` (``test_interpnd.py:564``): the 2-D cubic
    call compiled, bit for bit eager and within 1e-12 of JAX's jitted one;
    the gradient of the compiled call within 1e-4 of a central
    difference."""
    rng = np.random.default_rng(58)
    axes = [np.sort(rng.uniform(0, 1, 6)) for _ in range(2)]
    data = rng.normal(size=(6, 6))
    qs = [rng.uniform(a[0], a[-1], 10) for a in axes]
    t = InterpND.builder(data, device="cpu").points(*axes).method("cubic").build()
    j = jn.InterpND.builder(jnp.asarray(data)).points(*(jnp.asarray(a) for a in axes)).method(
        "cubic").build()
    tq = [torch.as_tensor(q) for q in qs]
    got = compiled(lambda *q: t(*q))(*tq)
    same(got, t(*tq))
    want = np.asarray(jax.jit(lambda i, *q: i(*q))(j, *(jnp.asarray(q) for q in qs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    f = compiled(lambda a, b: t(a, b).sum())
    p = [torch.tensor([v], dtype=torch.float64, requires_grad=True) for v in (0.41, 0.57)]
    f(*p).backward()
    eps = 1e-6
    for d in range(2):
        up = [torch.tensor([v + (eps if i == d else 0.0)], dtype=torch.float64)
              for i, v in enumerate((0.41, 0.57))]
        dn = [torch.tensor([v - (eps if i == d else 0.0)], dtype=torch.float64)
              for i, v in enumerate((0.41, 0.57))]
        fd = float((t(*up).sum() - t(*dn).sum()) / (2 * eps))
        np.testing.assert_allclose(float(p[d].grad), fd, rtol=1e-4)


# -- the ops -----------------------------------------------------------------------------
def df_op_samples():
    """A small CPU sample of every f64-grade op's arguments and of ORD's,
    by op name and form."""
    rng = np.random.default_rng(6)

    def P(*shape, lo=None, hi=None):
        v = rng.normal(size=shape) if lo is None else rng.uniform(lo, hi, shape)
        return tpair(v)

    def ints(hi, n=20):
        return torch.as_tensor(rng.integers(0, hi, n), dtype=torch.int32)

    x = tpair(np.linspace(0.0, 1.0, 9))
    q = P(20, lo=-0.1, hi=1.1)
    t = P(20, lo=0.0, hi=1.0)
    ty = P(20, lo=0.0, hi=1.0)
    eval_args = (*x, *P(9), *P(8), *P(8), *q)
    bank = 5
    table = [w for v in (rng.normal(size=(9, bank)), rng.normal(size=(8, bank)),
                         rng.normal(size=(8, bank))) for w in tpair(v)]
    nx, ny, r = 5, 4, 3
    cells = (nx - 1) * (ny - 1)
    z = tpair(rng.normal(size=(nx, ny, r)))
    rows = tpair(rng.normal(size=(cells, 16 * r)))
    nodes = tpair(rng.normal(size=(nx * ny, 4 * r + 2)))
    packed = {
        "bilinear_df": tp.pack_bilinear_rows_df(*z),
        "bilinear_f48": tp.pack_bilinear_rows_f48(*z),
        "bicubic_df": tp.pack_bicubic_rows_df(*rows, r),
        "bicubic_weight": tp.pack_bicubic_rows_df(*rows, r),
        "bicubic_f48": tp.pack_bicubic_rows_f48(*rows, r),
        "bicubic_node": tp.pack_bicubic_nodes_df(*nodes),
    }
    samples = {
        "fused_index_frac_df": (*x, *q),
        "fused_eval_1d_df": eval_args,
        "fused_eval_1d_df_f64": eval_args,
        "df_bank_tail df": ("df", ek.pack_bank_rows_df(*table), ints(8), *t, bank),
        "df_bank_tail f48": ("f48", ek.pack_bank_rows_f48(*table), ints(8), *t, bank),
        "df_bank_tail_f64 df": ("df", ek.pack_bank_rows_df(*table), ints(8), *t, bank),
        "df_bank_tail_f64 f48": ("f48", ek.pack_bank_rows_f48(*table), ints(8), *t, bank),
    }
    for form, pk in packed.items():
        samples[f"df_cell_tail {form}"] = (form, pk, ints(nx - 1), ints(ny - 1), ny, *t, *ty)
    for form in ("bilinear_df", "bilinear_f48", "bicubic_f48"):
        samples[f"df_cell_tail_f64 {form}"] = (form, packed[form], ints(nx - 1), ints(ny - 1),
                                               ny, *t, *ty)
    nd_rows = tpair(rng.normal(size=(4 * 3, 16 * 2)))
    nd_t = [torch.stack([a, b]) for a, b in zip(P(20, lo=0, hi=1), P(20, lo=0, hi=1))]
    nd_idx = torch.stack([ints(5), ints(3)])
    for grade, pack in (("df", tn.pack_rows_nd_df), ("f48", tn.pack_rows_nd_f48)):
        samples[f"df_nd_tail {grade}"] = (grade, pack(*nd_rows, 16, 2), nd_idx, *nd_t, [3, 1], 4)
    # distinct rows a query: every bucket holds one record, so the kernel's
    # order is the plain version's
    perm = torch.as_tensor(rng.permutation(cells), dtype=torch.int32)
    samples["order_by_cell 2-D"] = (perm // (ny - 1), perm % (ny - 1), ny - 1, 0, cells, *t, *ty)
    samples["order_by_cell 1-D"] = (perm, None, 1, 0, cells, *t, None, None)
    samples["order_by_cell flat f64"] = (perm, None, 1, 0, cells, torch.rand(cells, dtype=torch.float64),
                                         None, torch.rand(cells, dtype=torch.float64), None)
    return samples


def test_every_kernel_wrapper_is_an_op():
    """``ops.kernel_ops()`` covers every wrapper of ``kernel_wrappers()``:
    the f64-grade ops and ORD's are each sampled above, in the one
    namespace."""
    ops = kernel_ops()
    df_ops = {c.split()[0] for c in df_op_samples()}
    assert df_ops <= set(ops)
    assert all(op.namespace == _cuda.NAMESPACE for op in ops.values())
    by_wrapper = {"K6": "fused_eval_1d_df", "K7": "fused_index_frac_df", "K8": "df_bank_tail",
                  "K9": "df_bank_tail", "K10": "df_cell_tail", "K11": "df_cell_tail",
                  "K12": "df_cell_tail", "K13": "df_cell_tail", "K14": "df_cell_tail",
                  "R4c": "df_cell_tail", "K15": "df_nd_tail", "K15f48": "df_nd_tail",
                  "ORD": "order_by_cell"}
    assert set(by_wrapper) | {"K1", "K2", "K3", "K4", "K5", "R1", "R2a", "R2b", "R2c", "R2d",
                              "R2n", "R2g", "R3", "R3idx"} == set(kernel_wrappers())
    assert set(by_wrapper.values()) <= set(ops)


# the ops whose first output is an index (see tests/test_torch_compile.py)
INDEX_FIRST = {"fused_index_frac_df"}


@pytest.mark.parametrize("grad", [False, True], ids=["values", "gradients"])
@pytest.mark.parametrize("case", list(df_op_samples()))
def test_opcheck_df(case, grad):
    """``torch.library.opcheck`` on every f64-grade op and ORD's: schema,
    autograd registration, the fake implementation against the real one,
    AOT dispatch with dynamic shapes; with ``gradients`` the float operands
    require grad, so the backward (the VJP of the plain version) is traced
    too.  For K7's op, whose first output is the index, the AOT step with
    gradients is this test's own, as ``test_torch_compile.py``'s."""
    args = df_op_samples()[case]
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


def test_df_backward_is_the_plain_versions():
    """The gradient through K6's op and through K7 + K8's is autograd's of
    the plain versions, bit for bit: what differentiated on the CPU before
    the ops still does, to the same values."""
    x64, d64, a64, b64, q64 = bank_case(n=24, bank=3, nq=50)
    pairs = [w for v in (x64, d64[:, 0], a64[:, 0], b64[:, 0]) for w in tpair(v)]
    qh, ql = tpair(q64)
    for fn, plain in ((ek.fused_eval_1d_df, ek.eval_xla_df),):
        grads = []
        for f in (fn, plain):
            a = qh.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(tdf.df_to_f64(*f(*pairs, a, ql)).sum(), a)[0])
        same(*grads)
    packed = ek.pack_bank_rows_df(*(w for v in (d64, a64, b64) for w in tpair(v)))
    grads = []
    for tail in (ek.gathered_df_tail, ek._df_tail_plain):
        p = packed.clone().requires_grad_(True)
        idx, th, tl = ek._df_index_frac_xla(*tpair(x64), qh, ql)
        grads.append(torch.autograd.grad(tdf.df_to_f64(*tail(p, idx, th, tl, 3)).sum(), p)[0])
    same(*grads)


# -- the graphs and the launches ------------------------------------------------------------
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


def evaluators():
    """Each evaluator of the slice on a small CPU interpolator: ``(label,
    evaluator factory, query arrays, the ops its program holds)``."""
    rng = np.random.default_rng(21)
    x = np.cumsum(rng.uniform(0.1, 1.0, 40))
    q1 = [rng.uniform(x[0] - 1, x[-1] + 1, 300)]
    spline = CubicSpline().extrapolate(True)
    scalar = Interp1D.builder(rng.normal(size=40), device="cpu").x(x).strategy(spline).build()
    bank = Interp1D.builder(rng.normal(size=(40, 6)), device="cpu").x(x).strategy(spline).build()
    linear = Interp1D.builder(rng.normal(size=(40, 2)), device="cpu").x(x).strategy(
        Linear().extrapolate(True)).build()
    z = rng.normal(size=(9, 7, 3))
    q2 = [rng.uniform(0, 8, 300), rng.uniform(0, 6, 300)]
    bil = Interp2D.builder(z, device="cpu").strategy(Bilinear().extrapolate(True)).build()
    bic = Interp2D.builder(z, device="cpu").strategy(Bicubic().extrapolate(True)).build()
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 7)]
    d3 = rng.normal(size=(6, 5, 7, 2))
    q3 = [rng.uniform(a[0], a[-1], 300) for a in axes]
    lin3 = InterpND.builder(d3, device="cpu").points(*axes).build()
    cub3 = InterpND.builder(d3, device="cpu").points(*axes).method("cubic").build()
    K7 = "fused_index_frac_df"
    return [
        ("scalar df", lambda mb: ts.DoubleFloatEvaluator(scalar, max_batch=mb), q1,
         {"fused_eval_1d_df_f64"}),
        ("bank df", lambda mb: ts.DoubleFloatEvaluator(bank, max_batch=mb), q1,
         {K7, "df_bank_tail_f64"}),
        ("bank f48", lambda mb: ts.DoubleFloatEvaluator(bank, max_batch=mb, grade="f48"), q1,
         {K7, "df_bank_tail_f64"}),
        ("linear bank df", lambda mb: ts.DoubleFloatEvaluator(linear, max_batch=mb), q1,
         {K7, "df_bank_tail_f64"}),
        ("Bilinear df", lambda mb: ts.DoubleFloatEvaluator2D(bil, max_batch=mb), q2,
         {K7, "df_cell_tail_f64"}),
        ("Bilinear f48", lambda mb: ts.DoubleFloatEvaluator2D(bil, max_batch=mb, grade="f48"), q2,
         {K7, "df_cell_tail_f64"}),
        ("Bicubic df", lambda mb: ts.DoubleFloatEvaluator2D(bic, max_batch=mb), q2,
         {K7, "df_cell_tail"}),
        ("Bicubic f48", lambda mb: ts.DoubleFloatEvaluator2D(bic, max_batch=mb, grade="f48"), q2,
         {K7, "df_cell_tail_f64"}),
        ("ND linear df", lambda mb: ts.DoubleFloatEvaluatorND(lin3, max_batch=mb), q3,
         {K7, "df_nd_tail"}),
        ("ND cubic f48", lambda mb: ts.DoubleFloatEvaluatorND(cub3, max_batch=mb, grade="f48"),
         q3, {K7, "df_nd_tail"}),
        ("EvaluatorND linear", lambda mb: ts.EvaluatorND(lin3, max_batch=mb), q3,
         {"fused_index_frac"}),
        ("EvaluatorND cubic", lambda mb: ts.EvaluatorND(cub3, max_batch=mb), q3,
         {"fused_index_frac"}),
    ]


EVALUATORS = [e[0] for e in evaluators()]


def node_evaluator(monkeypatch):
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    rng = np.random.default_rng(22)
    node = Interp2D.builder(rng.normal(size=(9, 7, 2)), device="cpu").strategy(
        Bicubic().extrapolate(True)).build()
    assert node.strategy.layout == "node"
    return node, [rng.uniform(0, 8, 300), rng.uniform(0, 6, 300)]


def eager_serve(ev, qs):
    """What the evaluator's program computes, eagerly: its route on the
    split queries, recombined."""
    if isinstance(ev, ts.EvaluatorND):
        return ev._interp(*qs)
    res = ev._run(*(h for q in qs for h in tdf.df_from_f64(q)))
    return res if isinstance(res, torch.Tensor) else tdf.df_to_f64(*res)


@pytest.mark.parametrize("label", EVALUATORS)
def test_evaluator_graphs_hold_the_ops(label, monkeypatch):
    """A capturing backend reads each evaluator's one graph: it holds the
    slice's ``ndarray_interp::`` ops (K7 and the tail, or K6; K2 for
    ``EvaluatorND``), not their plain arithmetic inlined."""
    _, make, qs, want = next(e for e in evaluators() if e[0] == label)
    seen = []

    def capture(gm, example_inputs):
        seen.extend(n.target._opname for n in gm.graph.nodes if n.op == "call_function"
                    and isinstance(n.target, torch._ops.OpOverload)
                    and n.target.namespace == _cuda.NAMESPACE)
        return gm.forward

    monkeypatch.setattr(ts, "compile_program",
                        lambda fn, device: torch.compile(fn, fullgraph=True, backend=capture))
    ev = make(1024)
    ev(*qs)
    assert set(seen) == want, seen


def test_node_evaluator_graph_holds_k14(monkeypatch):
    """The bicubic node layout's program holds K7 and K14's op
    (``df_cell_tail``, form ``bicubic_node``)."""
    node, qs = node_evaluator(monkeypatch)
    seen = []

    def capture(gm, example_inputs):
        seen.extend(n.args[0] for n in gm.graph.nodes if n.op == "call_function"
                    and n.target is torch.ops.ndarray_interp.df_cell_tail.default)
        return gm.forward

    monkeypatch.setattr(ts, "compile_program",
                        lambda fn, device: torch.compile(fn, fullgraph=True, backend=capture))
    ts.DoubleFloatEvaluator2D(node, max_batch=1024)(*qs)
    assert seen == ["bicubic_node"]


@pytest.mark.parametrize("label", EVALUATORS)
def test_compiled_df_calls_reach_the_same_ops(label, monkeypatch):
    """A compiled evaluator's call runs each kernel op as often as its
    eager route: K7 once an axis and one tail, or K6 (on the card, the same
    launches)."""
    _, make, qs, want = next(e for e in evaluators() if e[0] == label)
    ev = make(512)
    runs = Runs(monkeypatch)
    tq = [torch.as_tensor(q) for q in qs]
    padded = [torch.cat([q, q[:212]]) for q in tq]  # one bucket of 512
    eager = eager_serve(ev, padded)
    want_runs = runs.take()
    got = ev(*tq)
    assert runs.take() == want_runs, label
    same(got, eager[:300])


@pytest.mark.parametrize("label", EVALUATORS)
def test_evaluator_serves_every_bucket_without_recompile(label):
    """Each evaluator after ``warmup()``: every bucket, a partial one and a
    chunked request, under ``fail_on_recompile``, bit for bit its eager
    route on the same padded chunks (``EvaluatorND``: ``itp(*coords)``)."""
    _, make, qs, _ = next(e for e in evaluators() if e[0] == label)
    rng = np.random.default_rng(23)
    ev = make(4096).warmup()
    with torch.compiler.set_stance("fail_on_recompile"):
        for n in (*ev.buckets, 1, 700, 9000):
            tq = [torch.as_tensor(rng.choice(q, n)) for q in qs]
            got = ev(*tq)
            if isinstance(ev, ts.EvaluatorND):
                same(got, ev._interp(*tq))
                continue
            bsz = ev._bucket(n)
            outs = []
            for start in range(0, n, bsz):
                chunks = [q[start:start + bsz] for q in tq]
                outs.append(eager_serve(ev, [
                    torch.cat([c, c.new_full((bsz - c.shape[0],), ev_pad(ev, d))])
                    for d, c in enumerate(chunks)]))
            same(got.reshape(n, -1), torch.cat(outs)[:n].reshape(n, -1))


def ev_pad(ev, d):
    """The pad value of query axis ``d`` (its first knot)."""
    if isinstance(ev, ts.DoubleFloatEvaluator):
        return ev._x0
    if isinstance(ev, ts.DoubleFloatEvaluator2D):
        return (ev._xr, ev._yr)[d][0]
    return ev._ranges[d][0]


def test_evaluators_cross_the_ordering_threshold_without_recompile(monkeypatch):
    """The bank and bicubic node evaluators over buckets of 256 to 2^18,
    across K8's ordering threshold (2^17 queries) and K14's, which the card
    decides inside the kernel ops at run time: after ``warmup()`` no bucket
    recompiles."""
    node, q2 = node_evaluator(monkeypatch)
    rng = np.random.default_rng(24)
    x = np.cumsum(rng.uniform(0.1, 1.0, 40))
    bank = Interp1D.builder(rng.normal(size=(40, 64)), device="cpu").x(x).strategy(
        CubicSpline()).build()
    assert not ek._orders(1 << 16, 64) and ek._orders(1 << 18, 64)
    for ev, qs in ((ts.DoubleFloatEvaluator(bank, max_batch=1 << 18), [x]),
                   (ts.DoubleFloatEvaluator2D(node, max_batch=1 << 18), q2)):
        ev.warmup()
        with torch.compiler.set_stance("fail_on_recompile"):
            for n in (*ev.buckets[::3], 1 << 18):
                tq = [torch.as_tensor(rng.uniform(q.min(), q.max(), n)) for q in qs]
                assert ev(*tq).shape[0] == n


# -- vmap over the f64-grade routes -----------------------------------------------------
def vmap_routes():
    """Each f64-grade route family on a small CPU table: ``(label, route on
    the query halves, the query arrays, the ops it runs and how often)``."""
    rng = np.random.default_rng(25)
    x64, d64, a64, b64, _ = bank_case(n=30, bank=6, nq=8, seed=26)
    xp = tpair(x64)
    scalar = [w for v in (d64[:, 0], a64[:, 0], b64[:, 0]) for w in tpair(v)]
    table = [w for v in (d64, a64, b64) for w in tpair(v)]
    pk_df, pk_f48 = ek.pack_bank_rows_df(*table), ek.pack_bank_rows_f48(*table)
    q1 = [rng.uniform(x64[0], x64[-1], (4, 16))]
    gx, gy = np.cumsum(rng.uniform(0.2, 1, 7)), np.cumsum(rng.uniform(0.2, 1, 6))
    g = tpair(gx) + tpair(gy)
    z = tpair(rng.normal(size=(7, 6, 3)))
    rows = tpair(rng.normal(size=(6 * 5, 16 * 3)))
    nodes = rng.normal(size=(7 * 6, 4 * 3 + 2))
    nodes[:, 12] = np.repeat(gx, 6)
    nodes[:, 13] = np.tile(gy, 7)
    q2 = [rng.uniform(gx[0], gx[-1], (4, 16)), rng.uniform(gy[0], gy[-1], (4, 16))]
    axes = [np.cumsum(rng.uniform(0.2, 1, n)) for n in (5, 4, 6)]
    ap = [w for a in axes for w in tpair(a)]
    nd_rows = tpair(rng.normal(size=(4 * 3 * 5, 64 * 2)))
    q3 = [rng.uniform(a[0], a[-1], (4, 16)) for a in axes]
    K7, T2 = "fused_index_frac_df", {"fused_index_frac_df": 2}
    return [
        ("K6", lambda qh, ql: ek.fused_eval_1d_df(*xp, *scalar, qh, ql), q1,
         {"fused_eval_1d_df": 1}),
        ("K7 + K8", lambda qh, ql: ek.gathered_bank_eval_df_packed(*xp, pk_df, 6, qh, ql), q1,
         {K7: 1, "gathered_df_tail": 1}),
        ("K7 + K9", lambda qh, ql: ek.gathered_bank_eval_f48_packed(*xp, pk_f48, 6, qh, ql), q1,
         {K7: 1, "gathered_f48_tail": 1}),
        ("K7 + K10", lambda *q: tp.gathered_bilinear_eval_df_packed(
            *g, tp.pack_bilinear_rows_df(*z), 6, 3, *q), q2, T2 | {"gathered_bilinear_df_tail": 1}),
        ("K7 + K11", lambda *q: tp.gathered_bilinear_eval_f48_packed(
            *g, tp.pack_bilinear_rows_f48(*z), 6, 3, *q), q2, T2 | {"gathered_bilinear_f48_tail": 1}),
        ("K7 + K12", lambda *q: tp.gathered_bicubic_eval_df_packed(
            *g, tp.pack_bicubic_rows_df(*rows, 3), *q, r=3), q2, T2 | {"gathered_bicubic_df_tail": 1}),
        ("K7 + R4c", lambda *q: tp.gathered_bicubic_eval_df_packed(
            *g, tp.pack_bicubic_rows_df(*rows, 3), *q, r=3, tail="weight"), q2,
         T2 | {"gathered_bicubic_df_weight_tail": 1}),
        ("K7 + K13", lambda *q: tp.gathered_bicubic_eval_f48_packed(
            *g, tp.pack_bicubic_rows_f48(*rows, 3), *q, r=3), q2, T2 | {"gathered_bicubic_f48_tail": 1}),
        ("K7 + K14", lambda *q: tp.gathered_bicubic_nodes_eval_df(
            *g, tp.pack_bicubic_nodes_df(*tpair(nodes)), *q, r=3), q2,
         T2 | {"gathered_bicubic_node_df_tail": 1}),
        ("K7 + K15", lambda *q: tn.gathered_nd_eval_df_packed(3, (5, 4, 6), 2)(
            *ap, tn.pack_rows_nd_df(*nd_rows, 64, 2), *q), q3, {K7: 3, "nd_df_tail": 1}),
        ("K7 + K15f48", lambda *q: tn.gathered_nd_eval_df_packed(3, (5, 4, 6), 2, tier="f48")(
            *ap, tn.pack_rows_nd_f48(*nd_rows, 64, 2), *q), q3, {K7: 3, "nd_f48_tail": 1}),
    ]


@pytest.mark.parametrize("label", [v[0] for v in vmap_routes()])
def test_vmap_over_df_routes(label, monkeypatch):
    """``torch.func.vmap`` over 4 rows of 16 queries of each f64-grade
    route: bit for bit the loop over the rows, with each kernel op run once
    on the flattened batch (K7 once an axis)."""
    _, route, qs, want = next(v for v in vmap_routes() if v[0] == label)
    halves = [h for q in qs for h in tpair(q)]
    loop = [route(*(h[i] for h in halves)) for i in range(4)]
    loop = tuple(torch.stack([o[j] for o in loop]) for j in range(2))
    runs = Runs(monkeypatch)
    got = torch.func.vmap(route)(*halves)
    assert dict(runs.take()) == want
    same_pair(got, loop)


def test_vmap_over_the_ordering():
    """ORD's op under ``vmap``: each sample ordered on its own, equal to
    the loop."""
    rng = np.random.default_rng(27)
    xi = torch.as_tensor(rng.integers(0, 5, (3, 40)), dtype=torch.int32)
    yi = torch.as_tensor(rng.integers(0, 4, (3, 40)), dtype=torch.int32)
    t = [torch.as_tensor(rng.uniform(0, 1, (3, 40)), dtype=torch.float32) for _ in range(4)]
    fn = lambda a, b, *f: co.order_by_cell(a, b, 4, 0, 20, *f)  # noqa: E731
    got = torch.func.vmap(fn)(xi, yi, *t)
    same(got, torch.stack([fn(xi[i], yi[i], *(v[i] for v in t)) for i in range(3)]))
