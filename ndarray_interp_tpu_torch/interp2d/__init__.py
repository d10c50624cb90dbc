"""Public 2-D interpolation API (mirrors ``ndarray_interp::interp2d``).

Reference: ``src/interp2d/mod.rs:29-32``.
"""

from ..models.interp2d import Interp2D, Interp2DBuilder
from ..models.strategies.base2d import (
    Interp2DStrategy,
    Interp2DStrategyBuilder,
    PointwiseStrategy2D,
)
from ..models.strategies.bicubic import Bicubic, bicubic_node_grids
from ..models.strategies.bilinear import Bilinear
from ..models.strategies.step import Nearest2D
from . import aliases

__all__ = [
    "Interp2D",
    "Interp2DBuilder",
    "Interp2DStrategy",
    "Interp2DStrategyBuilder",
    "PointwiseStrategy2D",
    "Bicubic",
    "bicubic_node_grids",
    "Bilinear",
    "Nearest2D",
    "aliases",
]
