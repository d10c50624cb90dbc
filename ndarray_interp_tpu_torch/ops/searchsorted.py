"""Interval lookup ("bucketize") on a strictly-rising knot axis.

Counterpart of ``ndarray_interp_tpu.ops.searchsorted``.  Reference:
``VectorExtensions::get_lower_index`` (``vector_extensions.rs:55-111``):
the index of the knot left of (or at) ``x``, never the last index, clamped
to ``0`` / ``len-2`` out of bounds so that extrapolation can always use the
first or last interval.

Semantics (``src/vector_extensions.rs:221-302``):

* ``x <= knots[0]``  -> 0           (incl. ``-inf``)
* ``x >= knots[-1]`` -> ``n - 2``   (incl. ``+inf``)
* otherwise the unique ``i`` with ``knots[i] <= x < knots[i+1]``
* ``NaN`` -> ``n - 2``: ``torch.searchsorted(right=True)`` counts every knot
  as ``<= NaN``.  This is also what the JAX package's XLA formulation
  gives; its Pallas search kernels give 0 instead.  The surrounding
  arithmetic yields NaN output either way, and the eager entry points
  raise before evaluating.
"""

from __future__ import annotations

import torch


def get_lower_index(knots, xq):
    """Lower-interval index of every query.

    Args:
      knots: (n,) strictly monotonically rising, n >= 2.
      xq: any shape; query positions.

    Returns:
      int32 tensor shaped like ``xq`` with values in ``[0, n-2]``.
    """
    n = knots.shape[0]
    idx = torch.searchsorted(knots, xq.contiguous(), right=True, out_int32=True)
    return (idx - 1).clamp(0, n - 2)  # not in place: the batching rule of vmap


def is_in_range(knots, xq):
    """``knots[0] <= x <= knots[-1]`` elementwise (``src/interp1d/mod.rs:384-386``)."""
    return (knots[0] <= xq) & (xq <= knots[-1])


def lower_index_fast(knots, xq):
    """:func:`get_lower_index` for flat ``xq``; on a CUDA tensor it runs the
    search kernel (``eval_kernels.fused_lower_index``), with identical
    results."""
    from .eval_kernels import fused_lower_index

    return fused_lower_index(knots, xq)
