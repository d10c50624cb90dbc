"""One-dimensional interpolator and builder.

Counterpart of ``ndarray_interp_tpu.models.interp1d``.  Reference:
``src/interp1d/mod.rs``.  Semantics preserved:

* interpolation happens along axis 0 of ``data``; trailing axes are
  batched (``mod.rs:39-51``),
* default x-axis is ``0..n`` indices, default strategy ``Linear``
  (``mod.rs:399-410``),
* ``interp_array(xs)`` output has dims ``M + N - 1`` with the query dims
  leading (``mod.rs:219-226``),
* any out-of-bounds query aborts the whole eager call (``mod.rs:321``),
* builder validation order and error messages (``mod.rs:443-476``).

Beyond the reference, as in the JAX package: ``derivative``, ``integrate``,
``solve`` and ``roots`` (SciPy's ``CubicSpline`` surface), for the
strategies that have them.

Devices: the interpolator's tensors live on one device.  Tensors given to
the builder keep theirs; numpy arrays and lists land on the builder's
``device``, which is the GPU unless named (``device="cpu"`` for the CPU;
without a CUDA device and with none named the builder raises).  Queries
that are not tensors land on the interpolator's device.  ``__call__``
never synchronises with the device; the eager methods check their queries
first, which costs one copy of a flag to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import (
    MonotonicError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)
from ..ops.searchsorted import get_lower_index, is_in_range
from ..utils.device import default_device
from ..utils.monotonic import monotonic_prop
from .strategies.base import Interp1DStrategyBuilder
from .strategies.cubic import _scalars
from .strategies.linear import Linear


def _to_tensor(value, device, copy=False):
    """Tensors keep their device; anything else goes through numpy (so a
    list of floats is float64, as numpy makes it) onto ``device``.  With
    ``copy`` a numpy array is copied, so that the interpolator does not
    change when the caller later writes to the array."""
    if isinstance(value, torch.Tensor):
        return value
    if copy:
        return torch.tensor(np.asarray(value), device=device)
    return torch.as_tensor(np.asarray(value), device=device)


def _write(buffer, result):
    if isinstance(buffer, torch.Tensor):
        buffer.copy_(result)
    else:
        buffer[...] = result.detach().cpu().numpy()
    return buffer


def _calculus(strategy, name, what):
    """The strategy's calculus method ``name``; ``TypeError`` without one."""
    fn = getattr(strategy, name, None)
    if fn is None:
        raise TypeError(f"{type(strategy).__name__} does not support {what}()")
    return fn


def _check_buffer(buffer, expect):
    if tuple(buffer.shape) != tuple(expect):
        raise ValueError(
            f"buffer shape mismatch expected: {list(expect)}, "
            f"got: {list(buffer.shape)}"
        )


class Interp1D:
    """One dimensional interpolator.

    Construct via :meth:`builder` (validating) or :meth:`new_unchecked`
    (no validation, ``mod.rs:356-365``).
    """

    def __init__(self, x, data, strategy):
        self.x = x
        self.data = data
        self.strategy = strategy

    # -- construction -------------------------------------------------------
    @classmethod
    def builder(cls, data, device=None) -> "Interp1DBuilder":
        """Get the builder (``mod.rs:79-81``).  ``device`` places numpy or
        list inputs (default: the GPU; raises without one); tensors keep
        their own device."""
        return Interp1DBuilder(data, device=device)

    @classmethod
    def new_unchecked(cls, x, data, strategy) -> "Interp1D":
        """Create an interpolator without any data validation.

        Assumed but not checked (``mod.rs:356-365``): ``x`` strictly
        monotonic rising, ``data.shape[0] == len(x)``, ``x`` and ``data`` of
        one dtype on one device, strategy built.
        """
        return cls(x, data, strategy)

    # -- core ------------------------------------------------------------------
    def _queries(self, xs):
        return _to_tensor(xs, self.x.device)

    def _promote(self, flat):
        """Queries promote to the knot dtype so every strategy and kernel
        sees one dtype."""
        if flat.dtype != self.x.dtype and self.x.is_floating_point():
            return flat.to(self.x.dtype)
        return flat

    def _eval_flat(self, flat):
        return self.strategy.eval(self, self._promote(flat))

    def _eval_flat_masked(self, flat):
        flat = self._promote(flat)
        out = self.strategy.eval(self, flat)
        if not self.strategy.extrapolates and (
            out.is_floating_point() or out.is_complex()
        ):
            ok = is_in_range(self.x, flat).reshape(
                tuple(flat.shape) + (1,) * (out.ndim - 1)
            )
            out = torch.where(ok, out, torch.nan)
        return out

    def __call__(self, xs):
        """Evaluate at ``xs`` (any shape, incl. scalar).

        Returns shape ``xs.shape + data.shape[1:]``.  When the strategy does
        not extrapolate, out-of-range results are masked to NaN (floating
        dtypes only) — the synchronisation-free stand-in for the reference's
        ``Err(OutOfBounds)``.
        """
        xs = self._queries(xs)
        out = self._eval_flat_masked(xs.reshape(-1))
        return out.reshape(tuple(xs.shape) + tuple(self.data.shape[1:]))

    def eval_unchecked(self, xs):
        """Like ``__call__`` but without the out-of-range NaN mask: queries
        outside the knot range use the edge intervals (i.e. extrapolate)."""
        xs = self._queries(xs)
        out = self._eval_flat(xs.reshape(-1))
        return out.reshape(tuple(xs.shape) + tuple(self.data.shape[1:]))

    # -- helpers available to strategies (mod.rs:367-386) --------------------
    def index_point(self, index):
        """``(x, data)`` at the given index."""
        return self.x[index], self.data[index]

    def get_index_left_of(self, x):
        """Index of a knot left of, or at, ``x`` and never the last one, so
        ``index_point(idx + 1)`` is always safe: ``get_lower_index``, plain
        PyTorch (``torch.searchsorted``), so it also runs under ``vmap``."""
        return get_lower_index(self.x, _to_tensor(x, self.x.device))

    # -- eager API (reference parity; raises on bad values) ------------------
    def _check_queries(self, xs_flat):
        """Reference error contract: OutOfBounds unless extrapolating
        (``linear.rs:80-84``); NaN queries are rejected like the
        reference's NaN-cast panic (``vector_extensions.rs:267-271``).
        One flag crosses to the host; the offending value only on error."""
        if not self.strategy.extrapolates:
            ok = is_in_range(self.x, xs_flat)
            if not bool(ok.all()):
                bad = xs_flat[~ok][0].detach().cpu().numpy()[()]
                raise OutOfBoundsError(f"x = {bad} is not in range")
        elif xs_flat.is_floating_point() and bool(torch.isnan(xs_flat).any()):
            raise ValueError("failed to convert NaN to an index")

    def interp_scalar(self, x):
        """Interpolate one point of 1-D data, returning a 0-d tensor
        (``mod.rs:108-114``)."""
        if self.data.ndim != 1:
            raise ShapeError(
                "interp_scalar requires 1-D data; use interp() instead"
            )
        return self.interp(x)[()]

    def interp(self, x):
        """Interpolated values at scalar ``x``; shape = data shape minus
        axis 0 (``mod.rs:150-156``)."""
        x = self._queries(x)
        self._check_queries(x.reshape(-1))
        return self.eval_unchecked(x)

    def interp_into(self, x, buffer):
        """``interp`` into a caller-provided buffer (a tensor or a numpy
        array) (``mod.rs:169-175``).  A wrong shape raises ``ValueError``,
        the reference's panic contract (``mod.rs:167``)."""
        _check_buffer(buffer, self.data.shape[1:])
        return _write(buffer, self.interp(x))

    def interp_array(self, xs):
        """Interpolated values at all points in ``xs``; output dims
        ``M + N - 1`` with query dims leading (``mod.rs:197-211``)."""
        xs = self._queries(xs)
        self._check_queries(xs.reshape(-1))
        return self.eval_unchecked(xs)

    def interp_array_into(self, xs, buffer):
        """``interp_array`` into a caller-provided buffer (a tensor or a
        numpy array) (``mod.rs:272-324``)."""
        xs = self._queries(xs)
        _check_buffer(buffer, self.get_buffer_shape(xs.shape))
        return _write(buffer, self.interp_array(xs))

    def get_buffer_shape(self, query_shape) -> tuple:
        """Required buffer shape for ``interp_array_into``
        (``mod.rs:346-354``): query dims ++ data dims[1:]."""
        return tuple(query_shape) + tuple(self.data.shape[1:])

    # -- calculus (beyond the reference; SciPy-style surface) -----------------
    def derivative(self, xs, order=1):
        """The ``order``-th derivative at ``xs``, the analytic derivative of
        the strategy's piecewise polynomial (SciPy
        ``CubicSpline(...).derivative(order)(xs)``).  Output dims
        ``M + N - 1`` like ``interp_array``; checked like it (out-of-range
        queries raise unless the strategy extrapolates, NaN raises).  The
        cubic-Hermite family (``CubicSpline``, ``Akima``, ``Makima``,
        ``Pchip``: orders 1-3) and ``Linear`` (order 1; higher orders are
        zero)."""
        fn = _calculus(self.strategy, "eval_derivative", "derivative")
        xs = self._queries(xs)
        flat = xs.reshape(-1)
        self._check_queries(flat)
        out = fn(self, self._promote(flat), order=order)
        return out.reshape(tuple(xs.shape) + tuple(self.data.shape[1:]))

    def integrate(self, lo, hi):
        """The definite integral from ``lo`` to ``hi`` per trailing element:
        exact per-interval polynomial quadrature (SciPy
        ``CubicSpline.integrate``).  Signed (``lo > hi`` negates).  Periodic
        splines integrate the periodic extension, other extrapolating
        strategies the edge polynomials; out-of-range bounds raise unless
        the strategy extrapolates.  Returns shape ``data.shape[1:]``."""
        fn = _calculus(self.strategy, "eval_integrate", "integrate")
        self._check_queries(_scalars(torch.float64, self.x.device, lo, hi))
        return fn(self, lo, hi)

    def solve(self, y=0.0, *, max_roots=None):
        """All real solutions of ``interp(x) == y`` (SciPy
        ``CubicSpline.solve``): a NaN-padded, ascending ``(3*(n_knots-1),)
        + data.shape[1:]`` tensor, the static per-interval bound of three
        roots (``ops/cubicroots.py``).  ``y`` is a scalar or broadcasts over
        the trailing dims.  Extrapolating strategies also report roots of
        the extended edge polynomials; periodic splines the base-range
        roots.  ``max_roots`` keeps the first ``max_roots`` rows.  The
        cubic-Hermite family and ``Linear``."""
        out = _calculus(self.strategy, "eval_solve", "solve")(self, y)
        return out if max_roots is None else out[:max_roots]

    def roots(self, *, max_roots=None):
        """The real zero crossings: ``solve(0.0)`` (SciPy
        ``CubicSpline.roots``)."""
        return self.solve(0.0, max_roots=max_roots)

    def __repr__(self):
        return (
            f"Interp1D(x={tuple(self.x.shape)}, data={tuple(self.data.shape)}, "
            f"strategy={self.strategy!r})"
        )


class Interp1DBuilder:
    """Create and configure an :class:`Interp1D` (``mod.rs:53-70``).

    Defaults: strategy ``Linear(extrapolate=False)``, x = axis-0 indices.
    """

    def __init__(self, data, device=None):
        self._device = default_device(data, device)
        data = _to_tensor(data, self._device, copy=True)
        self._data = data
        n = data.shape[0] if data.ndim >= 1 else 0
        # default x = 0..n in the data's dtype (mod.rs:399-410)
        self._x = (
            torch.arange(n, device=data.device).to(data.dtype)
            if data.ndim >= 1
            else None
        )
        self._strategy = Linear()

    def x(self, x) -> "Interp1DBuilder":
        """Set a custom x axis; must be strictly monotonic rising and match
        the data's axis-0 length (``mod.rs:424-430``)."""
        self._x = _to_tensor(x, self._device, copy=True)
        return self

    def strategy(self, strategy: Interp1DStrategyBuilder) -> "Interp1DBuilder":
        """Set the interpolation strategy (``mod.rs:434-440``)."""
        self._strategy = strategy
        return self

    def build(self) -> Interp1D:
        """Validate input data and create the configured interpolator.

        Validation order and messages follow ``mod.rs:443-476``.
        """
        data, x, strat = self._data, self._x, self._strategy

        if data.ndim < 1:
            raise ShapeError("data dimension is 0, needs to be at least 1")
        if data.shape[0] < strat.MINIMUM_DATA_LENGTH:
            raise NotEnoughDataError(
                "The chosen Interpolation strategy needs at least "
                f"{strat.MINIMUM_DATA_LENGTH} data points"
            )
        if not monotonic_prop(x).is_strict_rising:
            raise MonotonicError(
                "Values in the x axis need to be strictly monotonic rising"
            )
        if x.shape[0] != data.shape[0]:
            raise ShapeError(
                "Lengths of x and data axis need to match. "
                f"Got x: {x.shape[0]}, data: {data.shape[0]}"
            )
        if x.device != data.device:
            raise ValueError(
                f"x and data must be on one device; got x on {x.device}, "
                f"data on {data.device}"
            )

        # unify dtypes (the reference enforces Sx::Elem == Sd::Elem at the
        # type level; we promote instead)
        ct = torch.promote_types(x.dtype, data.dtype)
        x = x.to(ct)
        data = data.to(ct)
        return Interp1D(x, data, strat.build(x, data))
