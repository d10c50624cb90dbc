"""Bicubic (tensor-product cubic spline) interpolation on a rectilinear grid.

Counterpart of ``ndarray_interp_tpu.models.strategies.bicubic``: build,
eval and calculus (``eval_derivative``, ``eval_integrate_box``).  A strategy
beyond the reference crate, which ships only ``Bilinear``.

The tensor-product spline through ``data[(nx, ny, ...)]`` is, per cell, a
bicubic Hermite patch whose corner state is the value and three derivative
grids, each from batched 1-D spline solves (``cubic._solve_for_k``, the
Thomas kernel K4 on the GPU):

* ``kx``: d/dx, the solve along axis 0,
* ``ky``: d/dy, the solve along axis 1,
* ``kxy``: the cross derivative, the y-solve applied to ``kx``.

Evaluation is three 1-D Hermite evaluations in the symmetric form of the
1-D spline (``cubic_spline.rs:818-828``): ``f`` and ``ky`` along x at both
bracketing y-knots (with ``kx`` and ``kxy`` as their x-derivatives), then
along y.

Two table layouts, chosen at build by ``config.bicubic_pack_max_elems``:

* ``"cell"``: one row of 16r values per cell, the derivatives pre-scaled by
  the cell's widths, so a query fetches one row;
* ``"node"``: one row of 4r + 2 values per node (raw derivatives and the
  node's ``(x, y)``), about a quarter of the cell table's memory, four
  fetches per query.

The cell layout runs the cell search R1 (``fused_cell_index``) and the
nested tail R2n (``tail2d.bicubic_nested_tail``), which fetches each
query's row itself, on a large batch after ordering it by cell
(``cell_order.order_by_flat_cell``): kernels on the GPU, their plain
versions on the CPU.  The node layout runs the search kernel K2 on each axis and its tail
after an ``index_select`` is plain PyTorch, as it is XLA (not Pallas) in
the JAX package.  Not ported: the TPU's dense-operator build
(``bicubic.py:79-87``), whose worth on this card is an open question.
Integer data raises ``TypeError`` (the spline solve needs a floating dtype).
"""

from __future__ import annotations

import math

import torch

from ... import config
from ...ops.eval_kernels import fused_cell_index, fused_index_frac
from ...ops.tail2d import bicubic_nested_tail
from .base2d import Interp2DStrategy, Interp2DStrategyBuilder
from .cubic import (
    _FIRST_DERIV,
    _NOT_A_KNOT,
    _SECOND_DERIV,
    _dtype_name,
    _scalars,
    _solve_for_k,
    _solve_periodic_core,
    _validate_periodic_data,
)

# per-axis boundary kinds: the families of the 1-D spline that are uniform
# along an axis (per-row mixing has no tensor-product analogue)
_AXIS_KINDS = {
    "not_a_knot": (_NOT_A_KNOT, 0.0),
    "natural": (_SECOND_DERIV, 0.0),
    "clamped": (_FIRST_DERIV, 0.0),
    "periodic": None,
}

def _solve_axis0(x, grid, bc, validate=False):
    """Spline derivative solve along axis 0 with a named boundary kind; the
    trailing axes are solved as one bank."""
    periodic = bc == "periodic"
    if periodic and validate:
        _validate_periodic_data(grid)
    flat = grid.reshape(grid.shape[0], -1)
    if periodic:
        k = _solve_periodic_core(x, flat)
    else:
        kind, val = _AXIS_KINDS[bc]
        k = _solve_for_k(x, flat, kind, val, kind, val)
    return k.reshape(grid.shape)


def _solve_axis1(y, grid, bc="not_a_knot", validate=False):
    """Batched spline solve along axis 1 of ``(nx, ny, ...)``."""
    k = _solve_axis0(y, torch.movedim(grid, 1, 0), bc, validate=validate)
    return torch.movedim(k, 0, 1)


def _hermite(y_l, y_r, k_l, k_r, dx, t):
    """Value-derivative Hermite cubic in the symmetric reference form:
    ``a = k_l*dx - dy``, ``b = dy - k_r*dx`` (``cubic_spline.rs:350-367``)."""
    dy = y_r - y_l
    a = k_l * dx - dy
    b = dy - k_r * dx
    return (1 - t) * y_l + t * y_r + t * (1 - t) * (a * (1 - t) + b * t)


def _hermite_scaled_d(y_l, y_r, K_l, K_r, t, order):
    """``d^order/dt^order`` (0-3) of the Hermite form with pre-scaled
    derivatives ``K = k·dx``: the forms of the 1-D calculus
    (``CubicSplineStrategy.eval_derivative``); order 0 is the value."""
    dy = y_r - y_l
    a = K_l - dy
    b = dy - K_r
    if order == 0:
        return (1.0 - t) * y_l + t * y_r + t * (1.0 - t) * (a * (1.0 - t) + b * t)
    if order == 1:
        return dy + (1.0 - 2 * t) * (a * (1.0 - t) + b * t) + t * (1.0 - t) * (b - a)
    if order == 2:
        return a * (6 * t - 4) + b * (2 - 6 * t)
    return (6 * (a - b)) + 0.0 * t  # order 3: piecewise constant


def _cell_tail_nested_d(g, tx, ty, r, ox, oy):
    """The partial ``d^(ox+oy) / dtx^ox dty^oy`` of the nested cell tail on
    gathered cell rows ``(Q, 16r)``: the tail is linear in its corner
    state, so it is the same nesting with the x-Hermites at order ``ox`` and
    the y-Hermite at order ``oy`` (the caller divides by ``dx^ox · dy^oy``)."""

    def block(i):  # quantity i of [f, kx, ky, kxy] at corners [11, 12, 21, 22]
        return [g[:, (4 * i + c) * r : (4 * i + c + 1) * r] for c in range(4)]

    f, kx, ky, kxy = (block(i) for i in range(4))
    f_y1 = _hermite_scaled_d(f[0], f[2], kx[0], kx[2], tx, ox)
    f_y2 = _hermite_scaled_d(f[1], f[3], kx[1], kx[3], tx, ox)
    g_y1 = _hermite_scaled_d(ky[0], ky[2], kxy[0], kxy[2], tx, ox)
    g_y2 = _hermite_scaled_d(ky[1], ky[3], kxy[1], kxy[3], tx, ox)
    return _hermite_scaled_d(f_y1, f_y2, g_y1, g_y2, ty, oy)


def _check_orders(dx, dy):
    if dx not in (0, 1, 2, 3) or dy not in (0, 1, 2, 3):
        raise ValueError(f"derivative orders must be in 0..3; got dx={dx}, dy={dy}")


def _box_bounds(interp, xlo, xhi, ylo, yhi):
    """``(axes, los, his)`` of a box integral in a floating dtype (float32
    at least: integer grids are evaluated too)."""
    x, y = interp.x, interp.y
    bt = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    return ((x.to(bt), y.to(bt)), _scalars(bt, x.device, xlo, ylo),
            _scalars(bt, x.device, xhi, yhi))


def _index_frac(knots, q):
    """``(get_lower_index(knots, q), t)``: the search kernel K2 on a CUDA
    tensor, its plain version on a CPU one (same values)."""
    return fused_index_frac(knots, q)


def bicubic_node_grids(x, y, data, bc_x="not_a_knot", bc_y="not_a_knot"):
    """The bicubic node state ``(kx, ky, kxy)`` of ``data[(nx, ny, ...)]``:
    the solves :meth:`Bicubic.build` runs (d/dx along axis 0, d/dy along
    axis 1, and the y-solve applied to ``kx``)."""
    kx = _solve_axis0(x, data, bc_x)
    ky = _solve_axis1(y, data, bc_y)
    kxy = _solve_axis1(y, kx, bc_y)
    return kx, ky, kxy


def pack_bicubic_rows(x, y, data, kx, ky, kxy):
    """Cell rows ``((nx-1)(ny-1), 16r)``: the 16-value corner state (4
    quantities ``[f | kx | ky | kxy]`` × 4 corners ``[11, 12, 21, 22]``,
    trailing dims flattened) with the derivatives pre-scaled by the cell's
    widths (``kx*dx``, ``ky*dy``, ``kxy*dx*dy``), so that the row needs no
    interval endpoints."""
    nx, ny = data.shape[0], data.shape[1]
    r = math.prod(data.shape[2:])
    dx = (x[1:] - x[:-1]).to(data.dtype).reshape(nx - 1, 1, 1)
    dy = (y[1:] - y[:-1]).to(data.dtype).reshape(1, ny - 1, 1)

    def corners(g):
        return torch.stack(
            [g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]], dim=2
        ).reshape(nx - 1, ny - 1, 4 * r)

    blocks = [corners(data), corners(kx) * dx, corners(ky) * dy, corners(kxy) * dx * dy]
    return torch.cat(blocks, dim=-1).reshape((nx - 1) * (ny - 1), 16 * r)


def pack_bicubic_nodes(x, y, data, kx, ky, kxy):
    """Node rows ``(nx·ny, 4r + 2)``: the raw corner state
    ``[f | kx | ky | kxy]`` and the node's own ``(x, y)``."""
    nx, ny = data.shape[0], data.shape[1]
    r = math.prod(data.shape[2:])
    flat = [g.reshape(nx, ny, r) for g in (data, kx, ky, kxy)]
    coords = torch.stack(
        [x[:, None].expand(nx, ny), y[None, :].expand(nx, ny)], dim=-1
    ).to(data.dtype)
    return torch.cat(flat + [coords], dim=-1).reshape(nx * ny, 4 * r + 2)


class Bicubic(Interp2DStrategyBuilder):
    """Tensor-product cubic spline (builder)::

        Bicubic()                                # not-a-knot, no extrapolation
        Bicubic().extrapolate(True)
        Bicubic().boundary("natural", "clamped")  # per-axis families
        Bicubic().boundary("periodic", "not_a_knot")

    Per-axis boundary kinds: ``not_a_knot`` (default), ``natural``,
    ``clamped``, ``periodic`` (requires ``data[0] == data[-1]`` along that
    axis; queries wrap on it, as the 1-D ``Extrapolate::Periodic``,
    ``cubic_spline.rs:804-809``).
    """

    MINIMUM_DATA_LENGTH = 3  # the not-a-knot parabola needs 3 knots per axis

    def __init__(self, extrapolate: bool = False, bc_x: str = "not_a_knot",
                 bc_y: str = "not_a_knot"):
        for bc in (bc_x, bc_y):
            if bc not in _AXIS_KINDS:
                raise ValueError(
                    f"unknown bicubic boundary kind {bc!r}; choose from "
                    f"{sorted(_AXIS_KINDS)}"
                )
        self.extrapolates = bool(extrapolate)
        self.bc_x = bc_x
        self.bc_y = bc_y

    def extrapolate(self, yes: bool = True) -> "Bicubic":
        return Bicubic(extrapolate=yes, bc_x=self.bc_x, bc_y=self.bc_y)

    def boundary(self, bc_x: str, bc_y: str = None) -> "Bicubic":
        """Per-axis boundary families (``bc_y`` defaults to ``bc_x``)."""
        return Bicubic(
            extrapolate=self.extrapolates, bc_x=bc_x, bc_y=bc_x if bc_y is None else bc_y
        )

    def build(self, x, y, data) -> "BicubicStrategy":
        if not data.is_floating_point():
            raise TypeError(
                f"Bicubic requires a floating-point dtype; got {_dtype_name(data.dtype)}"
            )
        # periodic axes check data[0] == data[-1] on the data itself; the kx
        # columns inherit that equality, so the cross solve needs no check
        kx = _solve_axis0(x, data, self.bc_x, validate=True)
        ky = _solve_axis1(y, data, self.bc_y, validate=True)
        kxy = _solve_axis1(y, kx, self.bc_y)
        cell_elems = (data.shape[0] - 1) * (data.shape[1] - 1) * 16 * math.prod(data.shape[2:])
        if cell_elems <= config.bicubic_pack_max_elems:
            rows, layout = pack_bicubic_rows(x, y, data, kx, ky, kxy), "cell"
        else:
            rows, layout = pack_bicubic_nodes(x, y, data, kx, ky, kxy), "node"
        return BicubicStrategy(rows, self.extrapolates, self.bc_x, self.bc_y, layout)

    def __repr__(self):
        return (
            f"Bicubic(extrapolate={self.extrapolates}, "
            f"bc_x={self.bc_x!r}, bc_y={self.bc_y!r})"
        )


class BicubicStrategy(Interp2DStrategy):
    """Finished bicubic strategy: the packed table ``rows`` of its
    ``layout`` (``"cell"`` or ``"node"``)."""

    MINIMUM_DATA_LENGTH = 3

    def __init__(self, rows, extrapolate: bool = False, bc_x: str = "not_a_knot",
                 bc_y: str = "not_a_knot", layout: str = "cell"):
        if layout not in ("cell", "node"):
            raise ValueError(f"layout must be 'cell' or 'node', got {layout!r}")
        self.rows = rows
        self.extrapolates = bool(extrapolate)
        self.bc_x = bc_x
        self.bc_y = bc_y
        self.layout = layout

    @property
    def wraps_x(self):
        """Queries wrap on a periodic x axis: never out of range."""
        return self.bc_x == "periodic"

    @property
    def wraps_y(self):
        return self.bc_y == "periodic"

    def _wrap(self, x, y, xq, yq):
        """The rem_euclid wrap of every query on a periodic axis
        (``cubic_spline.rs:804-809``); the JAX package wraps in-range queries
        too, which can move them by an ulp, so the port does the same."""
        if self.wraps_x:
            xq = torch.remainder(xq - x[0], x[-1] - x[0]) + x[0]
        if self.wraps_y:
            yq = torch.remainder(yq - y[0], y[-1] - y[0]) + y[0]
        return xq, yq

    def eval(self, interp, xq, yq):
        x, y, data = interp.x, interp.y, interp.data
        xq, yq = self._wrap(x, y, xq, yq)
        out_shape = tuple(xq.shape) + tuple(data.shape[2:])
        r = math.prod(data.shape[2:])
        if self.layout == "cell":
            cell, tx, ty = fused_cell_index(x, y, xq, yq)  # R1
            return bicubic_nested_tail(self.rows, cell, tx, ty, r).reshape(out_shape)  # R2n
        xi, tx = _index_frac(x, xq)
        yi, ty = _index_frac(y, yq)
        return self._eval_node(data, xi.long(), yi.long(), tx, ty, out_shape)

    def _eval_node(self, data, xi, yi, tx, ty, out_shape):
        """Four node-row fetches, then the unscaled Hermite form."""
        ny = data.shape[1]
        r = math.prod(data.shape[2:])
        expand = tuple(xi.shape) + (1,) * (data.ndim - 2)
        tx, ty = tx.reshape(expand), ty.reshape(expand)

        def node(ix, iy):
            g = self.rows.index_select(0, ix * ny + iy)  # (Q, 4r+2)
            return (
                *(g[:, i * r : (i + 1) * r].reshape(out_shape) for i in range(4)),
                g[:, 4 * r].reshape(expand),
                g[:, 4 * r + 1].reshape(expand),
            )

        f11, kx11, ky11, kxy11, x1, y1 = node(xi, yi)
        f12, kx12, ky12, kxy12, _, y2 = node(xi, yi + 1)
        f21, kx21, ky21, kxy21, x2, _ = node(xi + 1, yi)
        f22, kx22, ky22, kxy22, _, _ = node(xi + 1, yi + 1)
        dx = x2 - x1
        dy = y2 - y1
        f_y1 = _hermite(f11, f21, kx11, kx21, dx, tx)
        f_y2 = _hermite(f12, f22, kx12, kx22, dx, tx)
        ky_y1 = _hermite(ky11, ky21, kxy11, kxy21, dx, tx)
        ky_y2 = _hermite(ky12, ky22, kxy12, kxy22, dx, tx)
        return _hermite(f_y1, f_y2, ky_y1, ky_y2, dy, ty)

    # -- calculus (beyond the reference; SciPy RectBivariateSpline.ev) --------
    def eval_derivative(self, interp, xq, yq, dx=0, dy=0):
        """The partial ``d^(dx+dy) z / dx^dx dy^dy`` (orders 0-3 per axis;
        order 3 is piecewise constant): the nested Hermite at each axis's
        order, divided by the cell widths ``dx_cell^dx · dy_cell^dy``.  Both
        layouts: the search K2 on each axis, then the cell row (the node
        layout assembles it from four node rows); periodic axes wrap like
        ``eval``."""
        _check_orders(dx, dy)
        x, y, data = interp.x, interp.y, interp.data
        xq, yq = self._wrap(x, y, xq, yq)
        ny = data.shape[1]
        r = math.prod(data.shape[2:])
        xi, tx = _index_frac(x, xq)
        yi, ty = _index_frac(y, yq)
        xi, yi = xi.long(), yi.long()
        dxg = (x[xi + 1] - x[xi]).to(data.dtype)[:, None]
        dyg = (y[yi + 1] - y[yi]).to(data.dtype)[:, None]
        if self.layout == "cell":
            g = self.rows.index_select(0, xi * (ny - 1) + yi)
        else:  # the scaled 16r cell row from the four node rows

            def node(ix, iy):
                gg = self.rows.index_select(0, ix * ny + iy)
                return [gg[:, i * r : (i + 1) * r] for i in range(4)]

            corners = (node(xi, yi), node(xi, yi + 1), node(xi + 1, yi), node(xi + 1, yi + 1))
            scales = (1.0, dxg, dyg, dxg * dyg)
            g = torch.cat([c[i] * scales[i] for i in range(4) for c in corners], dim=-1)
        out = _cell_tail_nested_d(g, tx[:, None], ty[:, None], r, dx, dy)
        return (out / (dxg**dx * dyg**dy)).reshape(tuple(xq.shape) + tuple(data.shape[2:]))

    def eval_integrate_box(self, interp, xlo, xhi, ylo, yhi):
        """The exact integral of the surface over ``[xlo, xhi] x [ylo, yhi]``
        per trailing element: per-axis Hermite antiderivative weights
        contracted against the four mixed-derivative node grids, solved
        again from ``data`` (K4 on the GPU).  Signed per axis;
        extrapolation extends the edge cells; periodic axes raise (a box
        that wraps is ambiguous)."""
        if self.wraps_x or self.wraps_y:
            raise ValueError("integrate() does not support periodic axes")
        from ..interpnd import integrate_box  # interpnd imports this module

        axes, los, his = _box_bounds(interp, xlo, xhi, ylo, yhi)
        return integrate_box(axes, interp.data, los, his, "cubic", (self.bc_x, self.bc_y),
                             self.extrapolates)

    def __repr__(self):
        return (
            f"BicubicStrategy(rows={tuple(self.rows.shape)}, "
            f"extrapolate={self.extrapolates}, bc_x={self.bc_x!r}, "
            f"bc_y={self.bc_y!r}, layout={self.layout!r})"
        )
