"""Bilinear interpolation strategy on a rectilinear grid.

Counterpart of ``ndarray_interp_tpu.models.strategies.bilinear`` (build and
eval; calculus waits for the port's calculus).  Reference:
``src/interp2d/strategies/bilinear.rs``.  Per query: two interval searches,
the four corners and the interval endpoints, then two x-direction lerps and
one y-direction lerp (``bilinear.rs:64-98``).

Here the whole batch does this at once.  Floating data built through the
builder gets the packed corner-row table (:class:`BilinearPacked`), so that
each query fetches one row: it runs the cell search R1
(``fused_cell_index``) and the lerp tail R2b (``tail2d.bilinear_gathered_eval``),
two kernels on the GPU and their plain versions on the CPU.  Data without a
table (integer data, or grids above ``_PACK_MAX_ELEMS``) runs the search
kernel K3 on each axis (``lower_index_fast``) and gathers the four corners.
Both give the same values: the table holds copies.
"""

from __future__ import annotations

import torch

from ...ops.eval_kernels import fused_cell_index
from ...ops.lerp import calc_frac
from ...ops.searchsorted import lower_index_fast
from ...ops.tail2d import bilinear_gathered_eval
from .base2d import Interp2DStrategy, Interp2DStrategyBuilder


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
            return BilinearPacked(pack_corner_rows(x, y, data), self.extrapolates)
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

    def __repr__(self):
        return f"Bilinear(extrapolate={self.extrapolates})"


class BilinearPacked(Bilinear):
    """Finished bilinear strategy with the corner-row table of
    :func:`pack_corner_rows` built once (one row gather per query)."""

    def __init__(self, rows, extrapolate: bool = False):
        super().__init__(extrapolate)
        self.rows = rows

    def eval(self, interp, xq, yq):
        cell, _, _ = fused_cell_index(interp.x, interp.y, xq, yq)  # R1
        out = bilinear_gathered_eval(self.rows, cell, xq, yq, self.rows.shape[1] // 4 - 1)  # R2b
        return out.reshape(tuple(xq.shape) + tuple(interp.data.shape[2:]))

    def __repr__(self):
        return (
            f"BilinearPacked(rows={tuple(self.rows.shape)}, "
            f"extrapolate={self.extrapolates})"
        )
