"""Strategy protocol for 1-D interpolation.

Counterpart of ``ndarray_interp_tpu.models.strategies.base``.  Reference:
the trait pair ``Interp1DStrategyBuilder`` / ``Interp1DStrategy``
(``src/interp1d/strategies/mod.rs:12-65``).  The reference is pointwise;
here ``Interp1D`` hands the strategy the whole flattened query vector and
the strategy returns the batched result.  ``Interp1D`` guarantees, before
calling (``strategies/mod.rs:26-32``):

* ``interp.x`` is strictly monotonically rising,
* ``len(x) == data.shape[0]`` and ``>= MINIMUM_DATA_LENGTH``,
* ``x`` and ``data`` share one dtype and one device,
* interpolation happens along axis 0.

Custom pointwise strategies in the style of the reference's
``examples/custom_strategy.rs`` subclass :class:`PointwiseStrategy` and are
vectorized with ``torch.func.vmap``.
"""

from __future__ import annotations

import torch


class Interp1DStrategyBuilder:
    """Validates/configures a strategy and produces the finished strategy.

    ``build`` is invoked exactly once inside ``Interp1DBuilder.build`` after
    its validation (``src/interp1d/mod.rs:443-476``).
    """

    #: Minimum number of points along the interpolation axis
    #: (``MINIMUM_DATA_LENGHT`` in the reference).
    MINIMUM_DATA_LENGTH: int = 2

    def build(self, x, data) -> "Interp1DStrategy":
        raise NotImplementedError


class Interp1DStrategy:
    """A finished (possibly precomputed) strategy."""

    #: Whether queries outside the knot range are legal.  When ``False`` the
    #: interpolator's eager entry points raise ``OutOfBoundsError`` and
    #: ``__call__`` masks out-of-range results to NaN.
    extrapolates: bool = False

    def eval(self, interp, xq):
        """Evaluate at the flat query vector ``xq`` of shape ``(Q,)``;
        return ``(Q, *data.shape[1:])``."""
        raise NotImplementedError


def _vmap_points(eval_point, *flats):
    """``eval_point`` over the flat query vectors with ``torch.func.vmap``.
    An empty batch is evaluated at one stand-in query (zeros) and sliced to
    nothing, so it keeps ``eval_point``'s trailing shape and dtype."""
    if flats[0].shape[0] == 0:
        return torch.func.vmap(eval_point)(*(f.new_zeros(1) for f in flats))[:0]
    return torch.func.vmap(eval_point)(*flats)


class PointwiseStrategy(Interp1DStrategy, Interp1DStrategyBuilder):
    """Adapter for user strategies written one query point at a time
    (``examples/custom_strategy.rs:38-53`` of the reference): implement
    ``eval_point(interp, x) -> (*data.shape[1:],)`` with the interpolator's
    helpers ``interp.get_index_left_of`` and ``interp.index_point``; the
    adapter vectorizes it with ``torch.func.vmap``.

    Under ``vmap`` a query is a batched tensor without a data pointer, so
    ``eval_point`` must stay in operations that batch: plain PyTorch (the
    helpers are ``torch.searchsorted`` and indexing) or the kernel
    wrappers, whose ``vmap`` rules flatten the batch into one launch.  It
    branches with ``torch.where``, not with Python ``if`` on values."""

    def build(self, x, data):
        return self

    def eval(self, interp, xq):
        return _vmap_points(lambda x: self.eval_point(interp, x), xq)

    def eval_point(self, interp, x):
        raise NotImplementedError
