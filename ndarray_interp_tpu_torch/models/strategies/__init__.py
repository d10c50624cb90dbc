from .base import Interp1DStrategy, Interp1DStrategyBuilder, PointwiseStrategy
from .base2d import Interp2DStrategy, Interp2DStrategyBuilder, PointwiseStrategy2D
from .cubic import (
    BoundaryCondition,
    CubicSpline,
    CubicSplineStrategy,
    RowBoundary,
    SingleBoundary,
)
from .hermite import Akima, Makima, Pchip
from .linear import Linear
from .step import Nearest, Nearest2D

__all__ = [
    "Interp1DStrategy",
    "Interp1DStrategyBuilder",
    "PointwiseStrategy",
    "Interp2DStrategy",
    "Interp2DStrategyBuilder",
    "PointwiseStrategy2D",
    "BoundaryCondition",
    "CubicSpline",
    "CubicSplineStrategy",
    "RowBoundary",
    "SingleBoundary",
    "Akima",
    "Makima",
    "Pchip",
    "Linear",
    "Nearest",
    "Nearest2D",
]
