"""The f32/f64 2-D tails: R2b and R2g (bilinear), R2c, R2d, R2n (bicubic).

Counterpart of the 2-D part of ``ndarray_interp_tpu.ops.pallas_tail``
(``bilinear_gathered_eval``, ``bicubic_gathered_eval``,
``bicubic_mxu_tail``) and of the nested tail of its ``Bicubic`` strategy.
Each wrapper takes the flat cell of each query (from
``eval_kernels.fused_cell_index``, R1) and its fractions or coordinates;
its CUDA kernel (``csrc/cell2d_kernels.cu``) fetches what the query needs
itself, so the gathered rows are never written:

* :func:`bilinear_gathered_eval` (R2b): three ``calc_frac`` lerps on the
  corner rows of ``bilinear.pack_corner_rows`` (width ``4r + 4``);
* :func:`bilinear_grid_eval` (R2g): the same lerps on the grid itself, the
  ``(nx, ny, r)`` data and the two axes: the four corner blocks are two runs
  of ``2r`` values of the grid, which the L2 holds where the corner-row
  table (four times the grid) does not fit it.  ``Bilinear`` runs it;
* :func:`bicubic_gathered_eval` (R2c): the weight form on the cell rows of
  ``bicubic.pack_bicubic_rows`` (width ``16r``), summed in block order;
* :func:`bicubic_tree_tail` (R2d): the same products summed by the halving
  tree of ``bicubic_mxu_tail``;
* :func:`bicubic_nested_tail` (R2n): the nested scaled-Hermite order of
  :func:`_cell_tail_nested`, the one the ``Bicubic`` strategy runs.

The three bicubic tails share their kernels' lanes (W channels of a query a
lane, its weights or fractions taken once) and their branches: a large
batch is first ordered by cell (``cell_order.order_by_flat_cell``, at the
rule of the f64-grade bicubic tails, ``eval_kernels_df2d._orders``), so
that the queries of one cell share its row; the kernel on the ordered
records writes each result to its query's slot, bit for bit the result of
the kernel in query order, which smaller batches run.

Each has its plain PyTorch version here (an ``index_select`` of the rows,
clamped to the table as the kernels clamp, and the form).  A CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises; the
two are bit-identical.  ``launches`` on each wrapper counts its launches.
On both devices the backward is the VJP of the plain version with ``cell``
fixed (the JAX package's ``_bl_bwd`` / ``_bc_bwd``), and ``torch.func.vmap``
flattens batched queries into one launch.
"""

from __future__ import annotations

import torch

from . import _cuda
from .cell_order import order_by_flat_cell, record_fields
from .eval_kernels_df2d import _ORDER_MIN_ROW_BYTES, _orders
from .lerp import calc_frac

def _rows(rows_tbl, cell):
    return rows_tbl.index_select(0, cell.long().clamp(0, rows_tbl.shape[0] - 1))


# -- plain versions ------------------------------------------------------------------
def _bilinear_plain(rows_tbl, cell, qx, qy, r):
    """Plain version of R2b (the JAX package's ``_bilinear_xla_form``)."""
    g = _rows(rows_tbl, cell)
    z11, z12, z21, z22 = (g[:, i * r : (i + 1) * r] for i in range(4))
    x1, x2, y1, y2 = (g[:, 4 * r + i : 4 * r + i + 1] for i in range(4))
    qxe, qye = qx[:, None], qy[:, None]
    # the lerp composition and order of bilinear.rs:88-97
    z1 = calc_frac(x1, z11, x2, z21, qxe)
    z2 = calc_frac(x1, z12, x2, z22, qxe)
    return calc_frac(y1, z1, y2, z2, qye)


def _grid_cell(data, cell):
    """``(xi, yi)`` of each flat cell ``xi·(ny-1) + yi`` of the grid ``data``,
    the cell clamped to the ``(nx-1)(ny-1)`` cells."""
    ny1 = data.shape[1] - 1
    c = cell.long().clamp(0, (data.shape[0] - 1) * ny1 - 1)
    xi = c // ny1
    return xi, c - xi * ny1


def _bilinear_grid_plain(data, x, y, cell, qx, qy):
    """Plain version of R2g: :func:`_bilinear_plain`'s lerps on the grid
    ``data`` (nx, ny, r) and the axes, bit for bit :func:`_bilinear_plain` on
    ``pack_corner_rows(x, y, data)``."""
    xi, yi = _grid_cell(data, cell)
    x, y = x.to(data.dtype), y.to(data.dtype)
    z11, z12 = data[xi, yi], data[xi, yi + 1]
    z21, z22 = data[xi + 1, yi], data[xi + 1, yi + 1]
    x1, x2 = x[xi][:, None], x[xi + 1][:, None]
    y1, y2 = y[yi][:, None], y[yi + 1][:, None]
    qxe, qye = qx[:, None], qy[:, None]
    # the lerp composition and order of bilinear.rs:88-97
    z1 = calc_frac(x1, z11, x2, z21, qxe)
    z2 = calc_frac(x1, z12, x2, z22, qxe)
    return calc_frac(y1, z1, y2, z2, qye)


def _bicubic_basis(t):
    """Scaled-Hermite weights ``(w_yl, w_yr, w_Kl, w_Kr)`` of
    :func:`_hermite_scaled` in closed form: ``u + p*d, t - p*d, p*u,
    -p*t`` with ``u = 1-t, p = t*u, d = u-t`` (``pallas_tail.py:232``)."""
    u = 1 - t
    p = t * u
    pd = p * (u - t)
    return (u + pd, t - pd, p * u, -(p * t))


def _bicubic_products(g, tx, ty, r):
    """The 16 products ``W[b] * block b`` of the weight form, block
    ``b = 4i + c`` (quantity i in [f, kx, ky, kxy], corner c in [11, 12, 21,
    22]) with ``W[b] = Ax[i][c >> 1] * Ay[i][c & 1]``
    (``pallas_tail._bicubic_weights``)."""
    bx = _bicubic_basis(tx[:, None])
    by = _bicubic_basis(ty[:, None])
    prods = []
    for i in range(4):
        ax = (bx[0], bx[1]) if i in (0, 2) else (bx[2], bx[3])
        ay = (by[0], by[1]) if i in (0, 1) else (by[2], by[3])
        for c in range(4):
            b = 4 * i + c
            prods.append((ax[c >> 1] * ay[c & 1]) * g[:, b * r : (b + 1) * r])
    return prods


def _bicubic_weight_plain(rows_tbl, cell, tx, ty, r):
    """Plain version of R2c (``_bicubic_weight_xla`` on the gathered rows):
    the products summed in block order."""
    p = _bicubic_products(_rows(rows_tbl, cell), tx, ty, r)
    out = p[0]
    for b in range(1, 16):
        out = out + p[b]
    return out


def _bicubic_tree_plain(rows_tbl, cell, tx, ty, r):
    """Plain version of R2d: the products summed by ``bicubic_mxu_tail``'s
    halving tree, block b added to b + 8, then to b + 4, b + 2, b + 1."""
    p = _bicubic_products(_rows(rows_tbl, cell), tx, ty, r)
    h = 8
    while h:
        p = [p[b] + p[b + h] for b in range(h)]
        h //= 2
    return p[0]


def _hermite_scaled(y_l, y_r, K_l, K_r, t):
    """The symmetric Hermite form (``cubic_spline.rs:818-828``) with
    pre-scaled derivatives ``K = k*dx``: ``a = K_l - dy``, ``b = dy - K_r``."""
    dy = y_r - y_l
    a = K_l - dy
    b = dy - K_r
    return (1 - t) * y_l + t * y_r + t * (1 - t) * (a * (1 - t) + b * t)


def _cell_tail_nested(g, tx, ty, r):
    """The nested scaled-Hermite tail on gathered cell rows ``(Q, 16r)``
    with ``tx``/``ty`` of shape ``(Q, 1)``: ``f`` and ``ky·dy`` along x at
    both bracketing y-knots, then along y."""

    def block(i):  # corner quantity i, corners [11, 12, 21, 22]
        base = 4 * r * i
        return tuple(g[:, base + c * r : base + (c + 1) * r] for c in range(4))

    f11, f12, f21, f22 = block(0)
    kx11, kx12, kx21, kx22 = block(1)
    ky11, ky12, ky21, ky22 = block(2)
    kxy11, kxy12, kxy21, kxy22 = block(3)
    f_y1 = _hermite_scaled(f11, f21, kx11, kx21, tx)
    f_y2 = _hermite_scaled(f12, f22, kx12, kx22, tx)
    g_y1 = _hermite_scaled(ky11, ky21, kxy11, kxy21, tx)
    g_y2 = _hermite_scaled(ky12, ky22, kxy12, kxy22, tx)
    return _hermite_scaled(f_y1, f_y2, g_y1, g_y2, ty)


def _bicubic_nested_plain(rows_tbl, cell, tx, ty, r):
    """Plain version of R2n: :func:`_cell_tail_nested` on the gathered rows."""
    return _cell_tail_nested(_rows(rows_tbl, cell), tx[:, None], ty[:, None], r)


def _on_records(plain, rows_tbl, records, r):
    """``plain`` on the records of :func:`~.cell_order.order_by_flat_cell`:
    the rows of the records' cells at their fractions, each result put back
    at its query's slot."""
    cell, qid, frac = record_fields(records, rows_tbl.dtype)
    got = plain(rows_tbl, cell, frac[:, 0], frac[:, 1], r)
    out = torch.empty_like(got)
    out[qid.long()] = got
    return out


def _bicubic_weight_ordered_plain(rows_tbl, records, r):
    """Plain version of R2c on ordered records: :func:`_bicubic_weight_plain`
    by :func:`_on_records`."""
    return _on_records(_bicubic_weight_plain, rows_tbl, records, r)


def _bicubic_tree_ordered_plain(rows_tbl, records, r):
    """Plain version of R2d on ordered records: :func:`_bicubic_tree_plain`
    by :func:`_on_records`."""
    return _on_records(_bicubic_tree_plain, rows_tbl, records, r)


def _bicubic_nested_ordered_plain(rows_tbl, records, r):
    """Plain version of R2n on ordered records: :func:`_bicubic_nested_plain`
    by :func:`_on_records`."""
    return _on_records(_bicubic_nested_plain, rows_tbl, records, r)


# -- the kernels -------------------------------------------------------------------------
# R2c, R2d and R2n order a batch by cell first at the rule of K12
# (eval_kernels_df2d._orders on their 16 r values of row a query, 1 KiB at r = 16
# in f32).  Measured on an H100 80GB HBM3 at 700 W (tools/tail2d_phases.py
# --sweeps, ordered with the ordering included / in query order, ms): at r = 16
# the ordered branch ties at 2^18 queries (R2c 0.0926 / 0.0882, R2d 0.0941 /
# 0.0923, R2n 0.0929 / 0.0885) and wins from 2^19 (0.1338 / 0.1713, 0.1383 /
# 0.1774, 0.1340 / 0.1725; NS3b's 1M: 0.1936 / 0.3214, 0.2134 / 0.3333, 0.1947 /
# 0.3243); 8 channels (512 B of rows, below the rule) tie at 2^19 and win at 1M
# (0.1376 / 0.1690, 0.1503 / 0.1799, 0.1393 / 0.1567), which the rule leaves to
# the query-order branch.
_ORDERED = {f"ndi_bicubic_{o}_tail": f"ndi_bicubic_{o}_tail_ordered"
            for o in ("seq", "tree", "nested")}


def _launch(name, symbol, width, rows_tbl, cell, a, b, r):
    """Check the operands of one tail kernel and launch it: ``width(r)`` is
    the least row width its blocks need."""
    dtype = _cuda.float_operands(name, rows_tbl, a, b)
    if cell.dtype != torch.int32 or cell.device != a.device:
        raise TypeError(f"{name}: cell must be torch.int32 on {a.device}")
    if r < 0 or rows_tbl.ndim != 2 or rows_tbl.shape[1] < width(r):
        raise ValueError(
            f"{name}: rows_tbl must have shape (cells, >= {width(max(r, 0))}) for "
            f"r = {r} >= 0, got {tuple(rows_tbl.shape)}"
        )
    if cell.ndim != 1 or a.shape != cell.shape or b.shape != cell.shape:
        raise ValueError(f"{name}: cell and its two query operands must be flat and of one length")
    nq = cell.shape[0]
    out = torch.empty((nq, r), dtype=dtype, device=a.device)
    rows_tbl = rows_tbl.contiguous()
    ordered = _ORDERED.get(symbol)
    if ordered is not None and _orders(nq, width(r) * rows_tbl.element_size(),
                                       _ORDER_MIN_ROW_BYTES):
        records = order_by_flat_cell(cell, rows_tbl.shape[0], a, b)
        _cuda.launch(
            ordered, dtype, a.device,
            rows_tbl, rows_tbl.shape[0], rows_tbl.shape[1], r, records, out, nq,
        )
        return out
    _cuda.launch(
        symbol, dtype, a.device,
        rows_tbl, rows_tbl.shape[0], rows_tbl.shape[1], r,
        cell.contiguous(), a.contiguous(), b.contiguous(), out, nq,
    )
    return out


def _launch_grid(data, x, y, cell, qx, qy):
    """Check the operands of R2g and launch it."""
    name = "bilinear_grid_eval"
    dtype = _cuda.float_operands(name, data, x, y, qx, qy)
    if cell.dtype != torch.int32 or cell.device != qx.device:
        raise TypeError(f"{name}: cell must be torch.int32 on {qx.device}")
    if data.ndim != 3 or data.shape[0] < 2 or data.shape[1] < 2:
        raise ValueError(f"{name}: data must have shape (nx >= 2, ny >= 2, r), got "
                         f"{tuple(data.shape)}")
    nx, ny, r = data.shape
    if x.shape != (nx,) or y.shape != (ny,):
        raise ValueError(f"{name}: the axes must have shapes ({nx},) and ({ny},), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if (nx - 1) * (ny - 1) >= 2**31:
        raise ValueError(f"{name}: {nx} x {ny} knots; the cells are int32")
    if cell.ndim != 1 or qx.shape != cell.shape or qy.shape != cell.shape:
        raise ValueError(f"{name}: cell and its two query operands must be flat and of one length")
    nq = cell.shape[0]
    out = torch.empty((nq, r), dtype=dtype, device=qx.device)
    _cuda.launch(
        "ndi_bilinear_grid_tail", dtype, qx.device,
        data.contiguous(), x.contiguous(), y.contiguous(), nx, ny, r,
        cell.contiguous(), qx.contiguous(), qy.contiguous(), out, nq,
    )
    return out


def _width_bilinear(r):
    return 4 * r + 4


def _width_bicubic(r):
    return 16 * r


def _tail_launch(form, rows_tbl, cell, a, b, r):
    name, symbol, width, _ = _TAILS[form]
    out = _launch(name, symbol, width, rows_tbl, cell, a, b, r)
    _WRAPPERS[form].launches += 1
    return out


def _tail_plain(form, rows_tbl, cell, a, b, r):
    return _TAILS[form][3](rows_tbl, cell, a, b, r)


def _save_tail(ctx, inputs, output):
    form, rows_tbl, cell, a, b, r = inputs
    ctx.form, ctx.r = form, r
    ctx.save_for_backward(rows_tbl, cell, a, b)


def _tail_backward(ctx, g):
    """The VJP of the tail's plain version with ``cell`` fixed (``_bl_bwd``
    ``pallas_tail.py:213``, ``_bc_bwd`` ``:357``): gradients for
    ``rows_tbl`` and the two query operands."""
    rows_tbl, cell, a, b = ctx.saved_tensors
    plain, r = _TAILS[ctx.form][3], ctx.r
    need = ctx.needs_input_grad
    gr, ga, gb = _cuda.plain_vjp(
        lambda rt, a_, b_: plain(rt, cell, a_, b_, r),
        (rows_tbl, a, b), (need[1], need[3], need[4]), g,
    )
    return None, gr, None, ga, gb, None


# R2b, R2c, R2d and R2n, the tail ``form`` of _TAILS: forward its kernel (the
# plain version on the CPU); under vmap batched cell and query operands
# flatten into one launch (one ordering where the flattened batch orders), a
# batched table takes the plain version
_TAIL = _cuda.kernel_op(
    "cell_tail", "(str form, Tensor rows_tbl, Tensor cell, Tensor a, Tensor b, int r) -> Tensor",
    lambda form, rows_tbl, cell, a, b, r: _cuda.run(
        _TAILS[form][0], a, _tail_launch, _tail_plain, form, rows_tbl, cell, a, b, r),
    lambda form, rows_tbl, cell, a, b, r: rows_tbl.new_empty((cell.shape[0], r)),
    setup_context=_save_tail, backward=_tail_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _tail_plain, info, in_dims, args, (2, 3, 4)),
)


def _launch_grid_counted(data, x, y, cell, qx, qy):
    out = _launch_grid(data, x, y, cell, qx, qy)
    bilinear_grid_eval.launches += 1
    return out


def _grid_backward(ctx, g):
    """The VJP of :func:`_bilinear_grid_plain` with ``cell`` fixed:
    gradients for ``data``, the axes and the queries."""
    data, x, y, cell, qx, qy = ctx.saved_tensors
    need = ctx.needs_input_grad
    gd, gx, gy, ga, gb = _cuda.plain_vjp(
        lambda d, x_, y_, a, b: _bilinear_grid_plain(d, x_, y_, cell, a, b),
        (data, x, y, qx, qy), (need[0], need[1], need[2], need[4], need[5]), g,
    )
    return gd, gx, gy, None, ga, gb


# R2g: forward the kernel (_bilinear_grid_plain on the CPU); vmap as _TAIL's
_GRID_TAIL = _cuda.kernel_op(
    "bilinear_grid_eval",
    "(Tensor data, Tensor x, Tensor y, Tensor cell, Tensor qx, Tensor qy) -> Tensor",
    lambda data, x, y, cell, qx, qy: _cuda.run(
        "bilinear_grid_eval", qx, _launch_grid_counted, _bilinear_grid_plain,
        data, x, y, cell, qx, qy),
    lambda data, x, y, cell, qx, qy: data.new_empty((cell.shape[0], data.shape[2])),
    setup_context=_cuda.save_inputs, backward=_grid_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _bilinear_grid_plain, info, in_dims, args, (3, 4, 5)),
)


def bilinear_gathered_eval(rows_tbl, cell, qx, qy, r):
    """Bilinear on the corner row ``cell`` of each query (R2b):
    ``rows_tbl`` ((nx-1)(ny-1), >= 4r + 4) from ``pack_corner_rows``,
    ``cell`` int32 and the coordinates ``qx``, ``qy`` flat.  Returns
    (Q, r).  CPU: :func:`_bilinear_plain`; CUDA: R2b."""
    return _TAIL("bilinear", rows_tbl, cell, qx, qy, r)


def bilinear_grid_eval(data, x, y, cell, qx, qy):
    """Bilinear on the grid (R2g): ``data`` (nx, ny, r), the axes ``x``
    (nx,) and ``y`` (ny,), ``cell`` int32 (R1's flat cells, clamped to the
    grid's cells) and the coordinates ``qx``, ``qy`` flat.  Returns (Q, r),
    bit for bit :func:`bilinear_gathered_eval` on ``pack_corner_rows(x, y,
    data)``.  CPU: :func:`_bilinear_grid_plain`; CUDA: R2g."""
    return _GRID_TAIL(data, x, y, cell, qx, qy)


def bicubic_gathered_eval(rows_tbl, cell, tx, ty, r):
    """The weight-form bicubic on the cell row ``cell`` of each query (R2c,
    summed in block order): ``rows_tbl`` ((nx-1)(ny-1), >= 16r) from
    ``pack_bicubic_rows``, ``cell`` int32 and the fractions flat.  Returns
    (Q, r).  CPU: :func:`_bicubic_weight_plain`; CUDA: R2c, on the queries
    ordered by cell when the batch is large (as :func:`bicubic_nested_tail`)."""
    return _TAIL("seq", rows_tbl, cell, tx, ty, r)


def bicubic_tree_tail(rows_tbl, cell, tx, ty, r):
    """:func:`bicubic_gathered_eval` summed by the halving tree (R2d).
    CPU: :func:`_bicubic_tree_plain`; CUDA: R2d, on the queries ordered by
    cell when the batch is large (as :func:`bicubic_nested_tail`)."""
    return _TAIL("tree", rows_tbl, cell, tx, ty, r)


def bicubic_nested_tail(rows_tbl, cell, tx, ty, r):
    """The ``Bicubic`` strategy's nested scaled-Hermite tail on the cell row
    ``cell`` of each query (R2n).  CPU: :func:`_bicubic_nested_plain`;
    CUDA: R2n, on the queries ordered by cell when the batch is large (the
    ordering counted in ``order_by_cell.launches``)."""
    return _TAIL("nested", rows_tbl, cell, tx, ty, r)


# form: (name in messages, entry point, least row width, plain version)
_TAILS = {
    "bilinear": ("bilinear_gathered_eval", "ndi_bilinear_tail", _width_bilinear, _bilinear_plain),
    "seq": ("bicubic_gathered_eval", "ndi_bicubic_seq_tail", _width_bicubic,
            _bicubic_weight_plain),
    "tree": ("bicubic_tree_tail", "ndi_bicubic_tree_tail", _width_bicubic, _bicubic_tree_plain),
    "nested": ("bicubic_nested_tail", "ndi_bicubic_nested_tail", _width_bicubic,
               _bicubic_nested_plain),
}
# form: the wrapper whose ``launches`` counts the form's launches
_WRAPPERS = {"bilinear": bilinear_gathered_eval, "seq": bicubic_gathered_eval,
             "tree": bicubic_tree_tail, "nested": bicubic_nested_tail}
for _w in _WRAPPERS.values():
    _w.launches = 0
del _w
bilinear_grid_eval.launches = 0
