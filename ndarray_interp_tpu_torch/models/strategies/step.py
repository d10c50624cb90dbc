"""Step-family interpolation strategies: nearest / previous / next.

Counterpart of ``ndarray_interp_tpu.models.strategies.step``.  Modes mirror
SciPy's ``interp1d`` kinds:

* ``"nearest"``    — the closest knot, midpoint ties to the left knot,
* ``"nearest-up"`` — the closest knot, midpoint ties to the right knot (the
  reference crate's ``examples/custom_strategy.rs:38-53``),
* ``"previous"``   — the knot at or before the query,
* ``"next"``       — the knot at or after the query.

Out-of-range queries follow the package's contract: the eager calls raise
and ``__call__`` gives NaN unless ``.extrapolate(True)``, which clamps to
the end values (constant extrapolation; SciPy fills NaN instead).  The NaN
mask applies to floating outputs only: integer data, which the family keeps
exact, cannot hold NaN, so ``__call__`` returns the clamped end value there.

Selection is one ``get_lower_index`` pass (``torch.searchsorted``; the JAX
package uses XLA's search here and no kernel exists for it) and an index
pick, with no arithmetic on data values, so integer data stays exact.
"""

from __future__ import annotations

import torch

from .base import Interp1DStrategy, Interp1DStrategyBuilder
from .base2d import Interp2DStrategy, Interp2DStrategyBuilder

_MODES = ("nearest", "nearest-up", "previous", "next")


def _pick(xq, x_l, x_r, idx, mode):
    """The knot index each query takes: ``idx`` or ``idx + 1``."""
    if mode == "nearest":
        return torch.where((xq - x_l) <= (x_r - xq), idx, idx + 1)
    if mode == "nearest-up":
        return torch.where((xq - x_l) < (x_r - xq), idx, idx + 1)
    if mode == "previous":
        # idx + 1 only where xq has reached x_r: an exact hit of the last knot
        return torch.where(xq >= x_r, idx + 1, idx)
    return torch.where(xq > x_l, idx + 1, idx)  # "next"


class Nearest(Interp1DStrategy, Interp1DStrategyBuilder):
    """Step interpolation; see the module docstring for the modes::

        Nearest()                           # "nearest", no extrapolation
        Nearest("previous").extrapolate(True)
    """

    MINIMUM_DATA_LENGTH = 2

    def __init__(self, mode: str = "nearest", extrapolate: bool = False):
        if mode not in _MODES:
            raise ValueError(f"unknown step mode {mode!r}; choose from {_MODES}")
        self.mode = mode
        self.extrapolates = bool(extrapolate)

    def extrapolate(self, yes: bool = True) -> "Nearest":
        return Nearest(mode=self.mode, extrapolate=yes)

    def build(self, x, data):
        return self

    def eval(self, interp, xq):
        idx = interp.get_index_left_of(xq).long()  # clamped to [0, n-2]
        pick = _pick(xq, interp.x[idx], interp.x[idx + 1], idx, self.mode)
        return interp.data.index_select(0, pick)

    def __repr__(self):
        return f"Nearest(mode={self.mode!r}, extrapolate={self.extrapolates})"


class Nearest2D(Interp2DStrategy, Interp2DStrategyBuilder):
    """Nearest grid node on a rectilinear grid (SciPy's
    ``RegularGridInterpolator(method="nearest")``).  Per-axis midpoint ties
    go to the left knot.  Out-of-range queries raise eagerly and give NaN
    in ``__call__`` unless ``.extrapolate(True)``, which clamps to the
    border nodes (integer grids clamp in ``__call__``).  One
    ``get_lower_index`` pass per axis and one node gather: integer data
    stays exact."""

    MINIMUM_DATA_LENGTH = 2

    def __init__(self, extrapolate: bool = False):
        self.extrapolates = bool(extrapolate)

    def extrapolate(self, yes: bool = True) -> "Nearest2D":
        return Nearest2D(extrapolate=yes)

    def build(self, x, y, data):
        return self

    def eval(self, interp, xq, yq):
        x, y, data = interp.x, interp.y, interp.data
        xi, yi = (i.long() for i in interp.get_index_left_of(xq, yq))
        px = _pick(xq, x[xi], x[xi + 1], xi, "nearest")
        py = _pick(yq, y[yi], y[yi + 1], yi, "nearest")
        flat = data.reshape((-1,) + tuple(data.shape[2:]))
        return flat.index_select(0, px * data.shape[1] + py)

    def __repr__(self):
        return f"Nearest2D(extrapolate={self.extrapolates})"
