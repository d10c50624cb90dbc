"""The port's f32/f64 2-D cell route (``ops/eval_kernels.py`` R1
``fused_cell_index``, ``ops/tail2d.py`` R2b, R2g, R2c, R2d, R2n, and the
``Bilinear`` / ``Bicubic`` cell dispatch onto them) against the JAX
package's, on the CPU.

The same numpy inputs, made from seeds, go through the JAX functions (its
Pallas kernels in interpret mode, and its XLA forms) and through the port's
counterparts, which run their kernels' plain PyTorch versions on CPU
tensors.

Tolerances: R1's cell and fractions exactly (``tests/test_pallas_eval.py:
129-159`` holds the JAX kernel to numpy exactly); R2b and R2g at the JAX
test's ``rtol = atol = 1e-5`` (``tests/test_pallas_tail.py:168``), R2g
also bit for bit against R2b's plain version on ``pack_corner_rows``; R2c
at ``2e-5``
of the largest |value| (``:283``; the interpret-mode kernel and the XLA form
it is tested against differ by ~1.5e-7 of it); R2d and R2n exactly, the
JAX forms' results being equal to the port's on these inputs; R2n against
the JAX strategy's tail at the bicubic twin tolerance (``rtol=2e-5,
atol=1e-6`` of the largest |value|, ``tests/test_torch_bicubic.py``);
gradients at ``1e-5`` (R1, R2b, R2g) and ``1e-4`` (the bicubic tails), as
``tests/test_pallas_tail.py:214`` and ``:349``.  The strategies' cell
route equals, bit for bit, the route they took before it: a search per
axis, a row gather and the PyTorch tail.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.ops.pallas_eval as j_pe
import ndarray_interp_tpu.ops.pallas_tail as j_tail
from ndarray_interp_tpu.models.strategies.bicubic import Bicubic as JBicubic
from ndarray_interp_tpu.models.strategies.bicubic import _cell_tail_nested as j_nested
from ndarray_interp_tpu.models.strategies.bilinear import pack_corner_rows as j_pack
from ndarray_interp_tpu_torch.interp2d import Bicubic, Bilinear, Interp2D
from ndarray_interp_tpu_torch import config as tconfig
from ndarray_interp_tpu_torch.models.strategies import bicubic as t_bicubic
from ndarray_interp_tpu_torch.models.strategies import bilinear as t_bilinear
from ndarray_interp_tpu_torch.ops import _cuda, kernel_wrappers
from ndarray_interp_tpu_torch.ops import eval_kernels as ek
from ndarray_interp_tpu_torch.ops import tail2d as t2
from ndarray_interp_tpu_torch.ops.lerp import calc_frac

T = torch.as_tensor
TAILS = {
    "R2c": (t2.bicubic_gathered_eval, t2._bicubic_weight_plain),
    "R2d": (t2.bicubic_tree_tail, t2._bicubic_tree_plain),
    "R2n": (t2.bicubic_nested_tail, t2._bicubic_nested_plain),
}


def cell_case():
    """The inputs of ``tests/test_pallas_eval.py:129-159``: 37 x 210 knots,
    3,000 queries, +-inf and on-knot queries."""
    rng = np.random.default_rng(5)
    nx, ny = 37, 210
    xk = np.sort(rng.uniform(0, 50, nx))
    xk[0], xk[-1] = 0.0, 50.0
    yk = np.sort(rng.uniform(0, 80, ny))
    yk[0], yk[-1] = 0.0, 80.0
    qx = np.concatenate([rng.uniform(-5, 55, 3000), [np.inf, -np.inf], xk[:29]])
    qy = np.concatenate([rng.uniform(-5, 85, 3000), [-np.inf, np.inf], yk[:29]])
    return [v.astype(np.float32) for v in (xk, yk, qx, qy)]


def jax_cell_index(x, y, qx, qy):
    got = j_pe._cell_index_impl(*(jnp.asarray(v) for v in (x, y, qx, qy)), interpret=True)
    return [np.asarray(v) for v in got]


def bl_case(nx=64, ny=48, r=5, nq=1024, seed=3):
    """``bl_fixture`` of ``tests/test_pallas_tail.py:139``, as numpy."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.1, 1.0, nx)).astype(np.float32)
    y = np.cumsum(rng.uniform(0.1, 1.0, ny)).astype(np.float32)
    data = rng.normal(size=(nx, ny, r)).astype(np.float32)
    rows = t_bilinear.pack_corner_rows(T(x), T(y), T(data))
    qx = rng.uniform(x[0] - 1, x[-1] + 1, nq).astype(np.float32)
    qy = rng.uniform(y[0] - 1, y[-1] + 1, nq).astype(np.float32)
    return x, y, data, rows.numpy(), qx, qy


def bc_case(nx=24, ny=20, r=8, nq=1024, seed=5):
    """``bc_fixture`` of ``tests/test_pallas_tail.py:240`` (extrapolating),
    as numpy: the JAX strategy's cell rows, and the port's
    ``(cell, tx, ty)`` of its queries."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.0, nx)).astype(np.float32)
    y = np.cumsum(rng.uniform(0.2, 1.0, ny)).astype(np.float32)
    data = rng.normal(size=(nx, ny, r)).astype(np.float32)
    rows = np.array(JBicubic(extrapolate=True).build(jnp.asarray(x), jnp.asarray(y),
                                                       jnp.asarray(data)).rows)
    qx = rng.uniform(x[0] - 1.0, x[-1] + 1.0, nq).astype(np.float32)
    qy = rng.uniform(y[0] - 1.0, y[-1] + 1.0, nq).astype(np.float32)
    cell, tx, ty = (v.numpy() for v in ek.fused_cell_index(T(x), T(y), T(qx), T(qy)))
    return rows, cell, tx, ty


def scaled(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


# -- R1 ------------------------------------------------------------------------------------
def test_cell_index_matches_jax_kernel_exactly():
    x, y, qx, qy = cell_case()
    want = jax_cell_index(x, y, qx, qy)
    got = ek.fused_cell_index(*(T(v) for v in (x, y, qx, qy)))
    assert got[0].dtype == torch.int32 and got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cell_index_is_k3_cell_and_k2_fractions(dtype):
    """R1's plain version is the K3 index of each axis and K2's fractions,
    bit for bit, NaN and +-inf queries included."""
    x, y, qx, qy = (v.astype(dtype) for v in cell_case())
    qx[:3], qy[3:6] = np.nan, np.nan
    x, y, qx, qy = (T(v) for v in (x, y, qx, qy))
    cell, tx, ty = ek.fused_cell_index(x, y, qx, qy)
    xi, txw = ek._index_frac_plain(x, qx)
    yi, tyw = ek._index_frac_plain(y, qy)
    assert torch.equal(cell, ek.fused_lower_index(x, qx) * (y.shape[0] - 1)
                       + ek.fused_lower_index(y, qy))
    assert torch.equal(cell, xi * (y.shape[0] - 1) + yi)
    for g, w in ((tx, txw), (ty, tyw)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g[~torch.isnan(g)], w[~torch.isnan(w)])


def test_cell_index_of_a_nan_query_diverges_from_jax_kernel():
    """A NaN query: the port (like ``get_lower_index``, K2 and K3) takes the
    last interval ``n - 2`` on that axis; the JAX R1 kernel takes 0.  The
    fractions are NaN in both."""
    x, y, qx, qy = cell_case()
    nx, ny = x.size, y.size
    qx, qy = np.r_[qx[:4], np.nan, 3.0], np.r_[qy[:4], 7.0, np.nan]
    jc, jtx, jty = jax_cell_index(x, y, qx, qy)
    cell, tx, ty = (v.numpy() for v in ek.fused_cell_index(*(T(v) for v in (x, y, qx, qy))))
    np.testing.assert_array_equal(cell[:4], jc[:4])
    yi = np.searchsorted(y, 7.0, side="right") - 1
    xi = np.searchsorted(x, 3.0, side="right") - 1
    assert (cell[4], jc[4]) == ((nx - 2) * (ny - 1) + yi, yi)
    assert (cell[5], jc[5]) == (xi * (ny - 1) + ny - 2, xi * (ny - 1))
    assert np.isnan(tx[4]) and np.isnan(jtx[4]) and np.isnan(ty[5]) and np.isnan(jty[5])


def test_cell_index_checks_its_axes_and_queries():
    x, y, qx, qy = (T(v) for v in cell_case())
    with pytest.raises(ValueError, match="one shape"):
        ek.fused_cell_index(x, y, qx, qy[:-1])
    with pytest.raises(ValueError, match="at least 2"):
        ek.fused_cell_index(x[:1], y, qx, qy)
    with pytest.raises(TypeError, match="torch.int64"):  # the kernel's dtype check
        ek._launch_cell_index(torch.arange(4), torch.arange(4), torch.arange(3), torch.arange(3))


# -- R2b -----------------------------------------------------------------------------------
@pytest.mark.parametrize("nq", [1024, 1000, 1])
def test_bilinear_tail_matches_jax(nq):
    x, y, data, rows, qx, qy = bl_case(nq=nq)
    r = data.shape[2]
    cell = ek.fused_cell_index(T(x), T(y), T(qx), T(qy))[0]
    got = t2.bilinear_gathered_eval(T(rows), cell, T(qx), T(qy), r)
    assert tuple(got.shape) == (nq, r) and got.dtype == torch.float32
    jrows = j_pack(jnp.asarray(x), jnp.asarray(y), jnp.asarray(data)).reshape(rows.shape)
    np.testing.assert_array_equal(np.asarray(jrows), rows)
    jargs = (jrows, jnp.asarray(cell.numpy()), jnp.asarray(qx), jnp.asarray(qy))
    for want in (j_tail._bilinear_gathered_impl(*jargs, r, interpret=True),
                 j_tail._bilinear_xla_form(*jargs, r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- R2g ------------------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r", [1, 3, 5, 16])
def test_grid_tail_plain_is_r2b_on_the_corner_rows(dtype, r):
    """``_bilinear_grid_plain`` on the grid equals ``_bilinear_plain`` on
    ``pack_corner_rows`` of it bit for bit: on R1's cells (NaN and +-inf
    queries among them, whose cells R1 puts at an axis's last interval),
    on cells far outside the table (clamped alike) and on the edge cells;
    the wrapper on CPU tensors is the plain version and launches nothing."""
    x, y, data, _, qx, qy = bl_case(nx=17, ny=13, r=r, nq=600, seed=r)
    x, y, data, qx, qy = (T(v.astype(dtype)) for v in (x, y, data, qx, qy))
    qx[:3], qy[3:5], qx[7], qy[8] = float("nan"), float("nan"), float("inf"), -float("inf")
    rows = t_bilinear.pack_corner_rows(x, y, data)
    rng = np.random.default_rng(r)
    cells = 16 * 12
    for cell in (ek.fused_cell_index(x, y, qx, qy)[0],
                 T(rng.integers(-3 * cells, 3 * cells, 600).astype(np.int32)),
                 T(np.array([0, cells - 1, cells, -1, 11, 12], np.int32))):
        a, b = qx[: cell.shape[0]], qy[: cell.shape[0]]
        want = t2._bilinear_plain(rows, cell, a, b, r)
        got = t2._bilinear_grid_plain(data, x, y, cell, a, b)
        assert got.dtype == want.dtype and tuple(got.shape) == (cell.shape[0], r)
        np.testing.assert_array_equal(got.numpy().view(np.uint8), want.numpy().view(np.uint8))
        before = t2.bilinear_grid_eval.launches
        assert torch.equal(t2.bilinear_grid_eval(data, x, y, cell, a, b).isnan(), want.isnan())
        assert t2.bilinear_grid_eval.launches == before


@pytest.mark.parametrize("nq", [1024, 1000, 1])
def test_grid_tail_matches_jax(nq):
    """R2g (its plain version) against the JAX ``bilinear_gathered_eval``'s
    Pallas kernel in interpret mode and its XLA form on the corner rows of
    the same grid."""
    x, y, data, rows, qx, qy = bl_case(nq=nq)
    r = data.shape[2]
    cell = ek.fused_cell_index(T(x), T(y), T(qx), T(qy))[0]
    got = t2.bilinear_grid_eval(T(data), T(x), T(y), cell, T(qx), T(qy))
    assert tuple(got.shape) == (nq, r) and got.dtype == torch.float32
    jrows = j_pack(jnp.asarray(x), jnp.asarray(y), jnp.asarray(data)).reshape(rows.shape)
    jargs = (jrows, jnp.asarray(cell.numpy()), jnp.asarray(qx), jnp.asarray(qy))
    for want in (j_tail._bilinear_gathered_impl(*jargs, r, interpret=True),
                 j_tail._bilinear_xla_form(*jargs, r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", [False, True])
def test_grid_tail_gradients_match_autograd_through_the_corner_rows(kernel):
    """The gradients of R2g for the grid, both axes and the queries against
    autograd through ``pack_corner_rows`` and ``_bilinear_plain`` (``1e-5``,
    and the JAX ``_bl_bwd`` for the queries); ``kernel``: through its
    autograd Function, the launch replaced by the plain version."""
    x, y, data, rows, qx, qy = bl_case(nq=128)
    x, y, data, qx, qy = (v.astype(np.float64) for v in (x, y, data, qx, qy))
    r = data.shape[2]
    cell = ek.fused_cell_index(T(x), T(y), T(qx), T(qy))[0]
    ref = [T(v).requires_grad_(True) for v in (data, x, y, qx, qy)]
    out = t2._bilinear_plain(t_bilinear.pack_corner_rows(ref[1], ref[2], ref[0]), cell,
                             ref[3], ref[4], r)
    (out**2).sum().backward()
    leaves = [T(v).requires_grad_(True) for v in (data, x, y, qx, qy)]
    with pytest.MonkeyPatch.context() as mp:
        if kernel:
            as_kernel(mp)
            before = t2.bilinear_grid_eval.launches
        got = t2.bilinear_grid_eval(leaves[0], leaves[1], leaves[2], cell, leaves[3], leaves[4])
        if kernel:
            assert t2.bilinear_grid_eval.launches == before + 1
    (got**2).sum().backward()
    for leaf, want in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), want.grad.numpy(), rtol=1e-5, atol=1e-5)
    jargs = (jnp.asarray(t_bilinear.pack_corner_rows(T(x), T(y), T(data)).numpy()),
             jnp.asarray(cell.numpy()), jnp.asarray(qx), jnp.asarray(qy))
    _, _, gx, gy = j_tail._bl_bwd(r, jargs, 2.0 * j_tail._bilinear_xla_form(*jargs, r))
    for leaf, w in zip(leaves[3:], (gx, gy)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bilinear_through_the_grid_tail_equals_jax(dtype):
    """``Interp2D`` with ``Bilinear`` runs R1 and R2g on the grid it keeps at
    build (a view of the data, no copy) and equals the JAX package's
    ``BilinearPacked`` on the same inputs (``rtol = atol = 1e-5`` in f32,
    ``1e-12`` in f64, scaled by the largest value)."""
    from ndarray_interp_tpu.interp2d import Bilinear as JBilinear
    from ndarray_interp_tpu.interp2d import Interp2D as JInterp2D

    x, y, z, qx, qy = grid(dtype)
    itp = build("Bilinear", x, y, z)
    assert itp.strategy.grid.data_ptr() == itp.data.data_ptr()
    assert tuple(itp.strategy.grid.shape) == (14, 11, 3)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        spied(mp, t_bilinear, ("fused_cell_index", "bilinear_grid_eval"), calls)
        got = itp(qx, qy).numpy()
    assert calls == ["fused_cell_index", "bilinear_grid_eval"]
    j = JInterp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).strategy(
        JBilinear().extrapolate(True)).build()
    want = np.asarray(j(jnp.asarray(qx), jnp.asarray(qy)))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


# -- R2c, R2d, R2n -------------------------------------------------------------------------
@pytest.mark.parametrize("r", [8, 5])
def test_bicubic_weight_tail_matches_jax(r):
    rows, cell, tx, ty = bc_case(r=r, nq=1024 if r == 8 else 512)
    got = t2.bicubic_gathered_eval(T(rows), T(cell), T(tx), T(ty), r).numpy()
    jc, jtx, jty = jnp.asarray(cell), jnp.asarray(tx), jnp.asarray(ty)
    g = jnp.take(jnp.asarray(rows), jc, axis=0)
    for want in (j_tail.bicubic_weight_tail(g, jtx, jty, r, interpret=True),
                 j_tail._bicubic_gathered_impl(jnp.asarray(rows), jc, jtx, jty, r,
                                               interpret=True),
                 j_tail._bicubic_weight_xla(g, jtx, jty, r)):
        scaled(got, want, 2e-5, 2e-5)


@pytest.mark.parametrize("r", [8, 16])
def test_bicubic_tree_tail_equals_jax_mxu_tail(r):
    rows, cell, tx, ty = bc_case(r=r)
    got = t2.bicubic_tree_tail(T(rows), T(cell), T(tx), T(ty), r).numpy()
    g = jnp.take(jnp.asarray(rows), jnp.asarray(cell), axis=0)
    want = j_tail.bicubic_mxu_tail(g, jnp.asarray(tx), jnp.asarray(ty), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("r", [8, 5, 1])
def test_bicubic_nested_tail_is_the_strategy_tail(r):
    """R2n's plain version is the strategy's ``_cell_tail_nested`` on the
    selected rows, bit for bit; the JAX strategy's nested tail agrees."""
    rows, cell, tx, ty = bc_case(r=r)
    got = t2.bicubic_nested_tail(T(rows), T(cell), T(tx), T(ty), r)
    g = T(rows).index_select(0, T(cell).long())
    assert torch.equal(got, t2._cell_tail_nested(g, T(tx)[:, None], T(ty)[:, None], r))
    want = j_nested(jnp.take(jnp.asarray(rows), jnp.asarray(cell), axis=0),
                    jnp.asarray(tx)[:, None], jnp.asarray(ty)[:, None], r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scaled(got.numpy(), want, 2e-5, 1e-6)


def test_bicubic_orders_agree_to_rounding():
    """The three summation orders are one function: within 2e-5 of the
    largest |value| of each other (``tests/test_pallas_tail.py:283``)."""
    rows, cell, tx, ty = bc_case()
    outs = [fn(T(rows), T(cell), T(tx), T(ty), 8).numpy() for fn, _ in TAILS.values()]
    scaled(outs[0], outs[2], 2e-5, 2e-5)
    scaled(outs[1], outs[2], 2e-5, 2e-5)


# -- gradients -----------------------------------------------------------------------------
def as_kernel(mp):
    """Run the kernels' autograd Functions on the CPU: every launch is
    replaced by the plain version of the same operands."""
    mp.setattr(_cuda, "kernel_device", lambda name, t: "cuda")
    mp.setattr(ek, "_launch_cell_index", ek._cell_index_plain)
    plain = {v[1]: v[3] for v in t2._TAILS.values()}
    mp.setattr(t2, "_launch", lambda name, symbol, width, *args: plain[symbol](*args))
    mp.setattr(t2, "_launch_grid", t2._bilinear_grid_plain)


@pytest.mark.parametrize("kernel", [False, True])
def test_cell_index_gradients_match_jax_bwd(kernel):
    x, y, qx, qy = cell_case()
    qx, qy = np.clip(qx, 0.0, 50.0), np.clip(qy, 0.0, 80.0)  # finite gradients
    cell, tx, ty = jax_cell_index(x, y, qx, qy)
    g_tx, g_ty = 2.0 * tx, 3.0 * ty
    float0 = np.zeros(cell.shape, dtype=jax.dtypes.float0)
    want = j_pe._cell_index_bwd(
        tuple(jnp.asarray(v) for v in (x, y, qx, qy, cell)),
        (float0, jnp.asarray(g_tx), jnp.asarray(g_ty)))
    leaves = [T(v).requires_grad_(True) for v in (x, y, qx, qy)]
    with pytest.MonkeyPatch.context() as mp:
        if kernel:
            as_kernel(mp)
            before = ek.fused_cell_index.launches
        c, a, b = ek.fused_cell_index(*leaves)
        if kernel:
            assert ek.fused_cell_index.launches == before + 1
    assert not c.requires_grad
    ((a * T(g_tx)).sum() + (b * T(g_ty)).sum()).backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", [False, True])
def test_bilinear_tail_gradients_match_jax_bwd(kernel):
    x, y, data, rows, qx, qy = bl_case(nq=128)
    r = data.shape[2]
    cell = ek.fused_cell_index(T(x), T(y), T(qx), T(qy))[0]
    jargs = (jnp.asarray(rows), jnp.asarray(cell.numpy()), jnp.asarray(qx), jnp.asarray(qy))
    g = 2.0 * j_tail._bilinear_xla_form(*jargs, r)
    gr, _, gx, gy = j_tail._bl_bwd(r, jargs, g)
    leaves = [T(v).requires_grad_(True) for v in (rows, qx, qy)]
    with pytest.MonkeyPatch.context() as mp:
        if kernel:
            as_kernel(mp)
            before = t2.bilinear_gathered_eval.launches
        out = t2.bilinear_gathered_eval(leaves[0], cell, leaves[1], leaves[2], r)
        if kernel:
            assert t2.bilinear_gathered_eval.launches == before + 1
    (out**2).sum().backward()
    for leaf, w in zip(leaves, (gr, gx, gy)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("kid", ["R2c", "R2d", "R2n"])
def test_bicubic_tail_gradients_match_jax(kid, kernel):
    """R2c and R2d against ``_bc_bwd`` (the weight form's VJP), R2n against
    the VJP of the JAX strategy's nested tail."""
    rows, cell, tx, ty = bc_case(nq=128)
    r = 8
    jr, jc, jtx, jty = (jnp.asarray(v) for v in (rows, cell, tx, ty))
    fn = TAILS[kid][0]
    if kid == "R2n":
        def form(rt, a, b):
            return j_nested(jnp.take(rt, jc, axis=0), a[:, None], b[:, None], r)

        out, vjp = jax.vjp(form, jr, jtx, jty)
        want = vjp(2.0 * out)
    else:
        out = j_tail._bicubic_weight_xla(jnp.take(jr, jc, axis=0), jtx, jty, r)
        gr, _, gx, gy = j_tail._bc_bwd(r, (jr, jc, jtx, jty), 2.0 * out)
        want = (gr, gx, gy)
    leaves = [T(v).requires_grad_(True) for v in (rows, tx, ty)]
    with pytest.MonkeyPatch.context() as mp:
        if kernel:
            as_kernel(mp)
            before = fn.launches
        got = fn(leaves[0], T(cell), leaves[1], leaves[2], r)
        if kernel:
            assert fn.launches == before + 1
    (got**2).sum().backward()
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy() / np.abs(w).max(), w / np.abs(w).max(),
                                   rtol=1e-4, atol=1e-4)


# -- the route -----------------------------------------------------------------------------
def grid(dtype, periodic=False, seed=11):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.0, 14))
    y = np.cumsum(rng.uniform(0.2, 1.0, 11))
    z = rng.normal(size=(14, 11, 3))
    if periodic:
        z[:, -1] = z[:, 0]
    qx = rng.uniform(x[0] - 2.0, x[-1] + 2.0, 700)
    qy = rng.uniform(y[0] - 2.0, y[-1] + 2.0, 700)
    qx[:14], qy[14:25] = x, y  # on-knot queries
    return [v.astype(dtype) for v in (x, y, z, qx, qy)]


def build(kind, x, y, z, periodic=False):
    strat = (Bilinear().extrapolate(True) if kind == "Bilinear" else
             Bicubic().boundary("not_a_knot", "periodic" if periodic else "not_a_knot")
             .extrapolate(True))
    return Interp2D.builder(z, device="cpu").x(x).y(y).strategy(strat).build()


def spied(mp, module, names, calls):
    """Record the calls ``module`` makes to the functions ``names``."""
    for name in names:
        if hasattr(module, name):
            fn = getattr(module, name)
            mp.setattr(module, name, lambda *a, _f=fn, _n=name: (calls.append(_n), _f(*a))[1])


def search_gather_route(kind, itp, qx, qy):
    """The route the strategies took before R1 and the fused tails: a
    search per axis (K3 for ``Bilinear``, K2 for ``Bicubic``), a row
    ``index_select`` and the PyTorch tail."""
    x, y, rows = itp.x, itp.y, itp.strategy.rows
    if kind == "Bilinear":
        r = rows.shape[1] // 4 - 1
        xi, yi = ek.fused_lower_index(x, qx).long(), ek.fused_lower_index(y, qy).long()
        g = rows.index_select(0, xi * (y.shape[0] - 1) + yi)
        z11, z12, z21, z22 = (g[:, i * r : (i + 1) * r] for i in range(4))
        x1, x2, y1, y2 = (g[:, 4 * r + i : 4 * r + i + 1] for i in range(4))
        z1 = calc_frac(x1, z11, x2, z21, qx[:, None])
        z2 = calc_frac(x1, z12, x2, z22, qx[:, None])
        return calc_frac(y1, z1, y2, z2, qy[:, None])
    r = rows.shape[1] // 16
    if itp.strategy.wraps_y:
        qy = torch.remainder(qy - y[0], y[-1] - y[0]) + y[0]
    xi, tx = ek.fused_index_frac(x, qx)
    yi, ty = ek.fused_index_frac(y, qy)
    g = rows.index_select(0, xi.long() * (y.shape[0] - 1) + yi.long())
    return t2._cell_tail_nested(g, tx[:, None], ty[:, None], r)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind,periodic", [("Bilinear", False), ("Bicubic", False),
                                           ("Bicubic", True)])
def test_routed_composition_equals_the_strategy_bit_for_bit(kind, periodic, dtype):
    """The strategy runs R1 and its tail (here their plain versions) and
    gives the values of the search-and-gather route, bit for bit; for
    ``Bilinear`` also those of the unpacked strategy's corner gather."""
    x, y, z, qx, qy = grid(dtype, periodic)
    itp = build(kind, x, y, z, periodic)
    assert itp.strategy.rows.dtype == itp.x.dtype
    module = t_bilinear if kind == "Bilinear" else t_bicubic
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        spied(mp, module, ("fused_cell_index", "bilinear_grid_eval", "bicubic_nested_tail",
                           "lower_index_fast", "_index_frac"), calls)
        got = itp(qx, qy)
    tail = "bilinear_grid_eval" if kind == "Bilinear" else "bicubic_nested_tail"
    assert calls == ["fused_cell_index", tail]
    assert tuple(got.shape) == (700, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got, search_gather_route(kind, itp, T(qx), T(qy)))
    if kind == "Bilinear":
        assert torch.equal(got, Bilinear(extrapolate=True).eval(itp, T(qx), T(qy)))


def test_bicubic_at_infinite_queries_is_nan_in_every_form():
    """+-inf on either axis: every bicubic form gives NaN (inf - inf in the
    Hermite bases), the strategy too; bilinear keeps its lerp semantics."""
    x, y, z, _, _ = grid(np.float32)
    itp = build("Bicubic", x, y, z)
    qx = np.array([np.inf, -np.inf, 3.0, 3.0], np.float32)
    qy = np.array([5.0, 5.0, np.inf, -np.inf], np.float32)
    assert bool(torch.isnan(itp(qx, qy)).all())
    cell, tx, ty = ek.fused_cell_index(itp.x, itp.y, T(qx), T(qy))
    for fn, _ in TAILS.values():
        assert bool(torch.isnan(fn(itp.strategy.rows, cell, tx, ty, 3)).all())
    jg = jnp.take(jnp.asarray(itp.strategy.rows.numpy()), jnp.asarray(cell.numpy()), axis=0)
    jtx, jty = jnp.asarray(tx.numpy()), jnp.asarray(ty.numpy())
    assert np.isnan(np.asarray(j_nested(jg, jtx[:, None], jty[:, None], 3))).all()
    assert np.isnan(np.asarray(j_tail._bicubic_weight_xla(jg, jtx, jty, 3))).all()


def test_cpu_tensors_keep_the_plain_route_and_launch_nothing():
    x, y, z, qx, qy = grid(np.float32)
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    for kind in ("Bilinear", "Bicubic"):
        build(kind, x, y, z)(qx, qy)
    rows, cell, tx, ty = bc_case(nq=16)
    for fn, _ in TAILS.values():
        fn(T(rows), T(cell), T(tx), T(ty), 8)
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before
    assert {"R1", "R2b", "R2g", "R2c", "R2d", "R2n"} <= set(before)


@pytest.mark.parametrize("case", ["integer Bilinear", "unpacked Bilinear", "node Bicubic"])
def test_tables_off_the_cell_route_keep_a_search_per_axis(case, monkeypatch):
    """Data without a corner-row table (integer, or above the pack cap) and
    the bicubic node layout run a search per axis (K3, K2), never R1."""
    x, y, z, qx, qy = grid(np.float64)
    if case == "integer Bilinear":
        x, y, z = np.arange(14), np.arange(11), np.arange(14 * 11 * 3).reshape(14, 11, 3)
        qx, qy = np.clip(qx, 0, 13), np.clip(qy, 0, 10)
    elif case == "unpacked Bilinear":
        monkeypatch.setattr(t_bilinear, "_PACK_MAX_ELEMS", 10)
    else:
        monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    kind = case.split()[1]
    itp = build(kind, x, y, z)
    assert type(itp.strategy).__name__ == "Bilinear" or itp.strategy.layout == "node"
    module = t_bilinear if kind == "Bilinear" else t_bicubic
    calls = []
    spied(monkeypatch, module, ("fused_cell_index", "lower_index_fast", "_index_frac"), calls)
    assert tuple(itp(qx, qy).shape) == (700, 3)
    assert calls == (["lower_index_fast"] * 2 if kind == "Bilinear" else ["_index_frac"] * 2)


def test_tail_launch_checks_its_operands():
    rows, cell, tx, ty = (T(v) for v in bc_case(nq=16))
    w = t2._width_bicubic
    with pytest.raises(TypeError, match="int32"):
        t2._launch("t", "s", w, rows, cell.long(), tx, ty, 8)
    with pytest.raises(TypeError, match="mixed dtypes"):
        t2._launch("t", "s", w, rows, cell, tx.double(), ty, 8)
    with pytest.raises(TypeError, match="torch.float16"):
        t2._launch("t", "s", w, rows.half(), cell, tx.half(), ty.half(), 8)
    with pytest.raises(ValueError, match=">= 144"):
        t2._launch("t", "s", w, rows, cell, tx, ty, 9)
    with pytest.raises(ValueError, match=">= 36"):
        t2._launch("t", "s", t2._width_bilinear, rows[:, :35], cell, tx, ty, 8)
    with pytest.raises(ValueError, match="flat"):
        t2._launch("t", "s", w, rows, cell, tx[:-1], ty, 8)
