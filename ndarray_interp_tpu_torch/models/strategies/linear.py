"""Piecewise-linear interpolation strategy.

Counterpart of ``ndarray_interp_tpu.models.strategies.linear``.  Reference:
``src/interp1d/strategies/linear.rs``.  The strategy is stateless
configuration (``extrapolate`` flag); ``build`` is a no-op
(``linear.rs:54-63``).

Evaluation:

* scalar float data goes through the shared 1-D eval kernel
  (``fused_eval_1d``, K1) with ``a = b = 0``, which reduces the Hermite form
  to the lerp ``(1-t) y_l + t y_r``; float32 data on 65,536 < n <=
  ``MAX_BIG_KNOTS`` knots through the long-axis kernel (``big_eval_1d``,
  R3), as in the JAX package (``linear.py:76-96`` there);
* bank data, and integer data, take the interval search (``lower_index_fast``,
  K3 on the GPU), a row gather and ``calc_frac`` (``linear.rs:73-98``).

Calculus (``linear.py:119-206`` of the JAX package): the slope, the exact
trapezoid integral and the crossings, on the same search and gather.
"""

from __future__ import annotations

import torch

from ...ops.bigknots import big_eval_1d, can_use_big
from ...ops.eval_kernels import fused_eval_1d, make_interval_table
from ...ops.gather import gather_rows
from ...ops.lerp import calc_frac
from ...ops.searchsorted import lower_index_fast
from .base import Interp1DStrategy, Interp1DStrategyBuilder
from .cubic import _bounds, _interval_roots, _interval_rows, _solve_operands


class Linear(Interp1DStrategy, Interp1DStrategyBuilder):
    """Linear interpolation with optional extrapolation::

        Linear()                   # no extrapolation (default)
        Linear().extrapolate(True) # extrapolate using the edge intervals
    """

    MINIMUM_DATA_LENGTH = 2  # linear.rs:52

    def __init__(self, extrapolate: bool = False):
        self.extrapolates = bool(extrapolate)

    def extrapolate(self, yes: bool = True) -> "Linear":
        """Return a copy with extrapolation enabled/disabled (chainable)."""
        return Linear(extrapolate=yes)

    def build(self, x, data) -> "Linear":
        return self

    def eval(self, interp, xq):
        x, data = interp.x, interp.data
        if xq.dtype == torch.float32 and xq.ndim == 1 and can_use_big(x, data):
            zeros = torch.zeros_like(data[:-1])
            return big_eval_1d(x, data, zeros, zeros, xq)
        if data.ndim == 1 and data.is_floating_point():
            return fused_eval_1d(x, make_interval_table(x, data), xq)
        return self._eval_gather(interp, xq)

    def _eval_gather(self, interp, xq):
        x, data = interp.x, interp.data
        idx = lower_index_fast(x, xq).long()
        xg = torch.stack([x[:-1], x[1:]], dim=-1)[idx]
        yg = gather_rows(torch.stack([data[:-1], data[1:]], dim=-1), idx)
        expand = tuple(xq.shape) + (1,) * (data.ndim - 1)
        return calc_frac(
            xg[..., 0].reshape(expand),
            yg[..., 0],
            xg[..., 1].reshape(expand),
            yg[..., 1],
            xq.reshape(expand),
        )

    # -- calculus (beyond the reference; SciPy-style surface) -----------------
    def _interval_quantities(self, interp, p):
        """``(idx, dx, t, y_l, y_r)`` at the flat queries ``p``."""
        return _interval_rows(interp, p, interp.data[:-1], interp.data[1:])

    def eval_derivative(self, interp, xq, order=1):
        """The slope ``(y_r - y_l) / dx`` of the active interval (the edge
        interval when extrapolating; at an interior knot the right
        interval's, the lower-index clamp).  Orders 2 and 3 are zero (away
        from the knots, where the derivative is undefined)."""
        if order not in (1, 2, 3):
            raise ValueError(f"derivative order must be 1, 2, or 3; got {order}")
        _, dx, _, y_l, y_r = self._interval_quantities(interp, xq)
        if order > 1:
            return torch.zeros_like(y_l)
        return (y_r - y_l) / dx

    def _antideriv(self, interp, p):
        """``F(p)`` from ``x[0]``: the exact trapezoid cumsum plus the
        partial ``dx·[y_l t + (y_r - y_l) t^2/2]`` (the edge segment's line
        outside the range)."""
        x, data = interp.x, interp.data
        dxk = (x[1:] - x[:-1]).reshape((-1,) + (1,) * (data.ndim - 1))
        full = dxk * 0.5 * (data[:-1] + data[1:])
        csum = torch.cat([torch.zeros_like(full[:1]), torch.cumsum(full, dim=0)], dim=0)
        idx, dx, t, y_l, y_r = self._interval_quantities(interp, p)
        return csum[idx] + dx * (y_l * t + (y_r - y_l) * (0.5 * t * t))

    def eval_integrate(self, interp, lo, hi):
        """The integral from ``lo`` to ``hi`` per trailing element (signed;
        exact)."""
        f = self._antideriv(interp, _bounds(interp, lo, hi))
        return f[1] - f[0]

    def eval_solve(self, interp, y=0.0):
        """Real roots of ``lerp(x) - y``: one linear crossing per interval,
        through the spline family's static-shape machinery, so the padded
        output ``(3(n-1), *trailing)`` is the same.  A segment identically
        equal to ``y`` contributes its left knot; extrapolating
        interpolators also report crossings of the extended edge segments."""
        y_l, y_r, yq = _solve_operands(interp, y)
        c0 = y_l - yq
        zero = torch.zeros_like(c0)
        return _interval_roots(interp, c0, y_r - y_l, zero, zero, self.extrapolates)

    def __repr__(self):
        return f"Linear(extrapolate={self.extrapolates})"
