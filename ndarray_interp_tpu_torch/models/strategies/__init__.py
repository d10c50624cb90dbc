from .base import Interp1DStrategy, Interp1DStrategyBuilder
from .cubic import (
    BoundaryCondition,
    CubicSpline,
    CubicSplineStrategy,
    RowBoundary,
    SingleBoundary,
)
from .hermite import Akima, Makima, Pchip
from .linear import Linear

__all__ = [
    "Interp1DStrategy",
    "Interp1DStrategyBuilder",
    "BoundaryCondition",
    "CubicSpline",
    "CubicSplineStrategy",
    "RowBoundary",
    "SingleBoundary",
    "Akima",
    "Makima",
    "Pchip",
    "Linear",
]
