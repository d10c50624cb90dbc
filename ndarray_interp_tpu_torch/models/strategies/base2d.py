"""Strategy protocol for 2-D interpolation.

Counterpart of ``ndarray_interp_tpu.models.strategies.base2d``.  Reference:
``src/interp2d/strategies/mod.rs:14-73``.  ``Interp2D`` guarantees, before
calling a strategy (``:30-37``):

* ``x`` and ``y`` are strictly monotonically rising,
* ``len(x) == data.shape[0]`` and ``len(y) == data.shape[1]``, both at
  least ``MINIMUM_DATA_LENGTH``,
* ``x``, ``y`` and ``data`` share one dtype and one device,
* interpolation happens along axes 0 (x) and 1 (y).

As in the 1-D protocol, strategies receive the whole flattened query
vectors at once; :class:`PointwiseStrategy2D` vectorizes a strategy written
one ``(x, y)`` point at a time.
"""

from __future__ import annotations

from .base import _vmap_points


class Interp2DStrategyBuilder:
    """Validates/configures a strategy and produces the finished strategy
    (``build`` runs once, inside ``Interp2DBuilder.build``)."""

    MINIMUM_DATA_LENGTH: int = 2

    def build(self, x, y, data) -> "Interp2DStrategy":
        raise NotImplementedError


class Interp2DStrategy:
    """A finished (possibly precomputed) strategy."""

    extrapolates: bool = False

    def eval(self, interp, xq, yq):
        """Evaluate at the flat query vectors ``xq``/``yq`` of shape
        ``(Q,)``; return ``(Q, *data.shape[2:])``."""
        raise NotImplementedError


class PointwiseStrategy2D(Interp2DStrategy, Interp2DStrategyBuilder):
    """Adapter for strategies written one ``(x, y)`` point at a time,
    vectorized with ``torch.func.vmap`` (the 2-D analogue of
    :class:`~.base.PointwiseStrategy`, with its rules: plain PyTorch
    operations and ``torch.where`` in ``eval_point``)."""

    def build(self, x, y, data):
        return self

    def eval(self, interp, xq, yq):
        return _vmap_points(lambda x, y: self.eval_point(interp, x, y), xq, yq)

    def eval_point(self, interp, x, y):
        raise NotImplementedError
