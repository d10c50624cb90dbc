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
"""

from __future__ import annotations

import torch

from ...ops.bigknots import big_eval_1d, can_use_big
from ...ops.eval_kernels import fused_eval_1d, make_interval_table
from ...ops.gather import gather_rows
from ...ops.lerp import calc_frac
from ...ops.searchsorted import lower_index_fast
from .base import Interp1DStrategy, Interp1DStrategyBuilder


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

    def __repr__(self):
        return f"Linear(extrapolate={self.extrapolates})"
