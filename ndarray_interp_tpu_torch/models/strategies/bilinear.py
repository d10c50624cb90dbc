"""Bilinear interpolation strategy on a rectilinear grid.

Counterpart of ``ndarray_interp_tpu.models.strategies.bilinear``: build,
eval and calculus (``eval_derivative``, ``eval_integrate_box``).  Reference:
``src/interp2d/strategies/bilinear.rs``.  Per query: two interval searches,
the four corners and the interval endpoints, then two x-direction lerps and
one y-direction lerp (``bilinear.rs:64-98``).

Here the whole batch does this at once.  Floating data built through the
builder gets :class:`BilinearPacked`: the JAX package's packed corner-row
table (``rows``, one row a cell holding all a query needs) and a contiguous
``(nx, ny, r)`` view of the grid.  It runs the cell search R1
(``fused_cell_index``) and the lerp tail R2g
(``tail2d.bilinear_grid_eval``) on the grid, two kernels on the GPU and
their plain versions on the CPU: a query's four corner blocks are two runs
of ``2r`` values of the grid, which the GPU's L2 holds where the corner-row
table, four times the grid, does not fit it.  The table's tail R2b
(``tail2d.bilinear_gathered_eval``) gives the same values bit for bit.
Data without a table (integer data, or grids above ``_PACK_MAX_ELEMS``)
runs the search kernel K3 on each axis (``lower_index_fast``) and gathers
the four corners.  All give the same values: the table holds copies.
"""

from __future__ import annotations

import torch

from ...ops.eval_kernels import fused_cell_index
from ...ops.lerp import calc_frac
from ...ops.searchsorted import lower_index_fast
from ...ops.tail2d import bilinear_grid_eval
from .base2d import Interp2DStrategy, Interp2DStrategyBuilder
from .bicubic import _box_bounds, _check_orders


def pack_corner_rows(x, y, data):
    """Packed per-cell rows ``((nx-1)(ny-1), 4r + 4)``: the four corner
    blocks ``[z11 | z12 | z21 | z22]`` (trailing dims flattened to ``r``),
    then the interval endpoints ``x1, x2, y1, y2``; one row holds all a
    query needs."""
    nx, ny = data.shape[0], data.shape[1]
    r = data[0, 0].numel()
    quad = torch.stack(
        [data[:-1, :-1], data[:-1, 1:], data[1:, :-1], data[1:, 1:]], dim=2
    ).reshape(nx - 1, ny - 1, 4 * r)
    ends = torch.stack(
        [
            x[:-1, None].expand(nx - 1, ny - 1),
            x[1:, None].expand(nx - 1, ny - 1),
            y[None, :-1].expand(nx - 1, ny - 1),
            y[None, 1:].expand(nx - 1, ny - 1),
        ],
        dim=-1,
    ).to(data.dtype)
    return torch.cat([quad, ends], dim=-1).reshape((nx - 1) * (ny - 1), 4 * r + 4)


# the table is packed at build only up to this data size (it quadruples the
# grid's memory)
_PACK_MAX_ELEMS = 64 * 1024 * 1024


class Bilinear(Interp2DStrategy, Interp2DStrategyBuilder):
    """Bilinear interpolation with optional extrapolation::

        Bilinear()                    # no extrapolation (default)
        Bilinear().extrapolate(True)  # extrapolate using the edge cells
    """

    MINIMUM_DATA_LENGTH = 2  # bilinear.rs:41

    def __init__(self, extrapolate: bool = False):
        self.extrapolates = bool(extrapolate)

    def extrapolate(self, yes: bool = True) -> "Bilinear":
        """Chainable config (``bilinear.rs:20-23``)."""
        return Bilinear(extrapolate=yes)

    def build(self, x, y, data):
        if (
            data.is_floating_point()
            and x.dtype == data.dtype
            and data.numel() <= _PACK_MAX_ELEMS
        ):
            grid = data.reshape(data.shape[0], data.shape[1], -1).contiguous()
            return BilinearPacked(pack_corner_rows(x, y, data), self.extrapolates, grid)
        return self

    def eval(self, interp, xq, yq):
        x, y, data = interp.x, interp.y, interp.data
        xi = lower_index_fast(x, xq).long()
        yi = lower_index_fast(y, yq).long()
        expand = tuple(xq.shape) + (1,) * (data.ndim - 2)

        def e(v):
            return v.reshape(expand)

        x1, x2 = e(x[xi].to(data.dtype)), e(x[xi + 1].to(data.dtype))
        y1, y2 = e(y[yi].to(data.dtype)), e(y[yi + 1].to(data.dtype))
        # the lerp composition and order of bilinear.rs:88-97
        z1 = calc_frac(x1, data[xi, yi], x2, data[xi + 1, yi], e(xq))
        z2 = calc_frac(x1, data[xi, yi + 1], x2, data[xi + 1, yi + 1], e(xq))
        return calc_frac(y1, z1, y2, z2, e(yq))

    # -- calculus (beyond the reference; SciPy-style surface) -----------------
    def eval_derivative(self, interp, xq, yq, dx=0, dy=0):
        """Analytic partials of the bilinear surface: per-cell constant
        slopes along each axis, the twist ``(z22 - z21 - z12 + z11) /
        (dx·dy)`` for (1, 1), and zero for any order of 2 or more (away from
        the grid lines, where the derivative is undefined).  The search K3
        on each axis and the four corners."""
        _check_orders(dx, dy)
        x, y, data = interp.x, interp.y, interp.data
        xi = lower_index_fast(x, xq).long()
        yi = lower_index_fast(y, yq).long()
        z11, z12 = data[xi, yi], data[xi, yi + 1]
        z21, z22 = data[xi + 1, yi], data[xi + 1, yi + 1]
        expand = tuple(xq.shape) + (1,) * (data.ndim - 2)

        def e(v):
            return v.reshape(expand)

        x1, x2 = e(x[xi]), e(x[xi + 1])
        y1, y2 = e(y[yi]), e(y[yi + 1])
        dxv, dyv = x2 - x1, y2 - y1
        if (dx, dy) in ((0, 0), (0, 1)):
            z1 = calc_frac(x1, z11, x2, z21, e(xq))
            z2 = calc_frac(x1, z12, x2, z22, e(xq))
            return calc_frac(y1, z1, y2, z2, e(yq)) if dy == 0 else (z2 - z1) / dyv
        if (dx, dy) == (1, 0):
            return calc_frac(y1, (z21 - z11) / dxv, y2, (z22 - z12) / dxv, e(yq))
        if (dx, dy) == (1, 1):
            return (z22 - z21 - z12 + z11) / (dxv * dyv)
        return torch.zeros_like((z11 - z11) / dxv)  # any order of 2 or more

    def eval_integrate_box(self, interp, xlo, xhi, ylo, yhi):
        """The exact integral over ``[xlo, xhi] x [ylo, yhi]`` per trailing
        element: the per-axis integral weights of the multilinear basis
        contracted against the data grid.  Signed per axis; extrapolating
        strategies integrate the extended edge cells.  Integer grids are
        integrated in a floating dtype."""
        from ..interpnd import integrate_box  # interpnd imports the bicubic module

        axes, los, his = _box_bounds(interp, xlo, xhi, ylo, yhi)
        data = interp.data if interp.data.is_floating_point() else interp.data.to(los.dtype)
        return integrate_box(axes, data, los, his, "linear", None, self.extrapolates)

    def __repr__(self):
        return f"Bilinear(extrapolate={self.extrapolates})"


class BilinearPacked(Bilinear):
    """Finished bilinear strategy with the corner-row table of
    :func:`pack_corner_rows` built once, and the grid as ``(nx, ny, r)``
    (``grid``; ``None``: ``interp.data`` reshaped at each call), which its
    eval reads."""

    def __init__(self, rows, extrapolate: bool = False, grid=None):
        super().__init__(extrapolate)
        self.rows = rows
        self.grid = grid

    def eval(self, interp, xq, yq):
        data = interp.data
        grid = self.grid
        if grid is None:
            grid = data.reshape(data.shape[0], data.shape[1], -1)
        cell, _, _ = fused_cell_index(interp.x, interp.y, xq, yq)  # R1
        out = bilinear_grid_eval(grid, interp.x, interp.y, cell, xq, yq)  # R2g
        return out.reshape(tuple(xq.shape) + tuple(data.shape[2:]))

    def __repr__(self):
        return (
            f"BilinearPacked(rows={tuple(self.rows.shape)}, "
            f"extrapolate={self.extrapolates})"
        )
