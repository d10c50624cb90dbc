"""Public 1-D interpolation API (mirrors ``ndarray_interp::interp1d``).

Reference module layout: ``src/interp1d/mod.rs:30-35`` re-exports the
interpolator, builder, strategy traits, ``Linear`` and the ``cubic_spline``
submodule; aliases live in ``interp1d/aliases.py``.
"""

from ..models.interp1d import Interp1D, Interp1DBuilder
from ..models.strategies.base import (
    Interp1DStrategy,
    Interp1DStrategyBuilder,
    PointwiseStrategy,
)
from ..models.strategies.cubic import CubicSpline
from ..models.strategies.hermite import Akima, Makima, Pchip
from ..models.strategies.linear import Linear
from ..models.strategies.step import Nearest
from . import cubic_spline

__all__ = [
    "Interp1D",
    "Interp1DBuilder",
    "Interp1DStrategy",
    "Interp1DStrategyBuilder",
    "PointwiseStrategy",
    "Linear",
    "CubicSpline",
    "Akima",
    "Makima",
    "Pchip",
    "Nearest",
    "cubic_spline",
]
