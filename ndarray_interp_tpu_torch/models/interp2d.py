"""Two-dimensional interpolator and builder.

Counterpart of ``ndarray_interp_tpu.models.interp2d``.  Reference:
``src/interp2d/mod.rs``.  Semantics preserved:

* interpolation along the first two axes of ``data``; trailing axes are
  batched,
* default x/y axes are ``0..n`` indices, default strategy ``Bilinear``
  (``mod.rs:388-405``),
* ``interp_array(xs, ys)`` requires ``xs.shape == ys.shape`` and yields dims
  ``M + N - 2`` with the query dims leading (``mod.rs:175-211``),
* any out-of-bounds query aborts the whole eager call, x checked before y
  (``bilinear.rs:71-80``); a periodic (wrapping) axis is never out of range,
* builder validation order and messages (``mod.rs:468-518``).

Devices as in :mod:`.interp1d`: tensors keep their device, numpy arrays
and lists land on the builder's ``device`` (the GPU unless named).
``__call__`` never synchronises with the device; the eager methods check
their queries first, one flag copied to the host per axis.

Beyond the reference, as in the JAX package: ``derivative`` (SciPy's
``RectBivariateSpline.ev(xs, ys, dx, dy)``) and ``integrate`` (its
``.integral``) for ``Bilinear`` and ``Bicubic``.  Not ported: the JAX
package's native host paths (``_native_*``, ``ScalarEval2D``) and
``eval_checked``.
"""

from __future__ import annotations

import torch

from ..errors import MonotonicError, NotEnoughDataError, OutOfBoundsError, ShapeError
from ..ops.searchsorted import get_lower_index, is_in_range
from ..utils.device import default_device
from ..utils.monotonic import monotonic_prop
from .interp1d import _calculus, _check_buffer, _to_tensor, _write
from .strategies.base2d import Interp2DStrategyBuilder
from .strategies.bilinear import Bilinear
from .strategies.cubic import _scalars

_SHAPES_DIFFER = "`xs.shape` and `ys.shape` do not match"


class Interp2D:
    """Two dimensional interpolator (``mod.rs:36-48``).

    Construct via :meth:`builder` (validating) or :meth:`new_unchecked`.
    """

    def __init__(self, x, y, data, strategy):
        self.x = x
        self.y = y
        self.data = data
        self.strategy = strategy

    # -- construction -------------------------------------------------------
    @classmethod
    def builder(cls, data, device=None) -> "Interp2DBuilder":
        """Get the builder.  ``device`` places numpy or list inputs
        (default: the GPU; raises without one); tensors keep their own
        device."""
        return Interp2DBuilder(data, device=device)

    @classmethod
    def new_unchecked(cls, x, y, data, strategy) -> "Interp2D":
        """Create an interpolator without any data validation
        (``mod.rs:323-342``): the caller vouches for the guarantees of
        ``strategies/base2d.py``."""
        return cls(x, y, data, strategy)

    # -- core ------------------------------------------------------------------
    def _queries(self, xs, ys):
        xs = _to_tensor(xs, self.x.device)
        ys = _to_tensor(ys, self.x.device)
        if xs.shape != ys.shape:
            raise ValueError(_SHAPES_DIFFER)
        return xs, ys

    def _promote(self, flat):
        if flat.dtype != self.x.dtype and self.x.is_floating_point():
            return flat.to(self.x.dtype)
        return flat

    def _wraps(self):
        return (
            getattr(self.strategy, "wraps_x", False),
            getattr(self.strategy, "wraps_y", False),
        )

    def _out_shape(self, xs):
        return tuple(xs.shape) + tuple(self.data.shape[2:])

    def __call__(self, xs, ys):
        """Evaluate at ``(xs, ys)`` (any matching shape, incl. scalars).

        When the strategy does not extrapolate, results out of range on a
        non-wrapping axis are masked to NaN (floating dtypes only), the
        synchronisation-free stand-in for the reference's
        ``Err(OutOfBounds)``."""
        xs, ys = self._queries(xs, ys)
        xf = self._promote(xs.reshape(-1))
        yf = self._promote(ys.reshape(-1))
        out = self.strategy.eval(self, xf, yf)
        wx, wy = self._wraps()
        if (
            not self.strategy.extrapolates
            and not (wx and wy)
            and (out.is_floating_point() or out.is_complex())
        ):
            ok = torch.ones(xf.shape, dtype=torch.bool, device=xf.device)
            if not wx:
                ok = ok & is_in_range(self.x, xf)
            if not wy:
                ok = ok & is_in_range(self.y, yf)
            out = torch.where(ok.reshape(tuple(ok.shape) + (1,) * (out.ndim - 1)), out, torch.nan)
        return out.reshape(self._out_shape(xs))

    def eval_unchecked(self, xs, ys):
        """Like ``__call__`` but without the out-of-range NaN mask: queries
        outside the grid use the edge cells (i.e. extrapolate)."""
        xs, ys = self._queries(xs, ys)
        out = self.strategy.eval(
            self, self._promote(xs.reshape(-1)), self._promote(ys.reshape(-1))
        )
        return out.reshape(self._out_shape(xs))

    # -- strategy helpers (mod.rs:344-379) ------------------------------------
    def index_point(self, x_idx, y_idx):
        """``(x, y, data)`` at the given index pair."""
        return self.x[x_idx], self.y[y_idx], self.data[x_idx, y_idx]

    def get_index_left_of(self, x, y):
        x = _to_tensor(x, self.x.device)
        y = _to_tensor(y, self.x.device)
        return get_lower_index(self.x, x), get_lower_index(self.y, y)

    def is_in_x_range(self, x):
        return is_in_range(self.x, _to_tensor(x, self.x.device))

    def is_in_y_range(self, y):
        return is_in_range(self.y, _to_tensor(y, self.x.device))

    # -- eager API (reference parity; raises on bad values) ------------------
    def _check_queries(self, xs_flat, ys_flat):
        """x then y: ``OutOfBoundsError`` on the first value out of range
        unless the strategy extrapolates; a wrapping axis is never out of
        range.  NaN refuses to index where no range check catches it."""
        wraps = self._wraps()
        axes = (("x", xs_flat, self.x, wraps[0]), ("y", ys_flat, self.y, wraps[1]))
        if self.strategy.extrapolates or all(wraps):
            for _, q, _, _ in axes:
                _check_not_nan(q)
            return
        for name, q, knots, wrap in axes:
            if wrap:
                _check_not_nan(q)
                continue
            ok = is_in_range(knots, q)
            if not bool(ok.all()):
                bad = q[~ok][0].detach().cpu().numpy()[()]
                raise OutOfBoundsError(f"{name} = {bad} is not in range")

    def interp_scalar(self, x, y):
        """Interpolate one point of 2-D data, returning a 0-d tensor
        (``mod.rs:107-113``)."""
        if self.data.ndim != 2:
            raise ShapeError("interp_scalar requires 2-D data; use interp() instead")
        return self.interp(x, y)[()]

    def interp(self, x, y):
        """Interpolated values at scalar ``(x, y)``; shape = data shape
        minus the first two axes (``mod.rs:132-146``)."""
        x = _to_tensor(x, self.x.device)
        y = _to_tensor(y, self.x.device)
        self._check_queries(x.reshape(-1), y.reshape(-1))
        return self.eval_unchecked(x, y)

    def interp_into(self, x, y, buffer):
        """``interp`` into a caller-provided buffer (a tensor or a numpy
        array) (``mod.rs:160-167``).  A wrong shape raises ``ValueError``."""
        _check_buffer(buffer, self.data.shape[2:])
        return _write(buffer, self.interp(x, y))

    def interp_array(self, xs, ys):
        """Interpolated values at all points ``(xs, ys)``; output dims
        ``M + N - 2`` with query dims leading (``mod.rs:175-196``)."""
        xs, ys = self._queries(xs, ys)
        self._check_queries(xs.reshape(-1), ys.reshape(-1))
        return self.eval_unchecked(xs, ys)

    def interp_array_into(self, xs, ys, buffer):
        """``interp_array`` into a caller-provided buffer (a tensor or a
        numpy array) (``mod.rs:215-285``); the buffer's shape is checked
        first, then the queries'."""
        xs = _to_tensor(xs, self.x.device)
        _check_buffer(buffer, self.get_buffer_shape(xs.shape))
        return _write(buffer, self.interp_array(xs, ys))

    def get_buffer_shape(self, query_shape) -> tuple:
        """Query dims ++ data dims[2:] (``mod.rs:310-321``)."""
        return tuple(query_shape) + tuple(self.data.shape[2:])

    # -- calculus (beyond the reference; SciPy-style surface) -----------------
    def derivative(self, xs, ys, dx=0, dy=0):
        """The partial ``d^(dx+dy) z / dx^dx dy^dy`` at the query pairs, the
        analytic derivative of the strategy's surface (SciPy
        ``RectBivariateSpline.ev(xs, ys, dx, dy)``).  Output dims
        ``M + N - 2`` like ``interp_array``, checked like it.  ``Bicubic``
        (orders 0-3 per axis) and ``Bilinear`` (orders 0-1 exact, higher
        orders zero)."""
        fn = _calculus(self.strategy, "eval_derivative", "derivative")
        xs, ys = self._queries(xs, ys)
        xf, yf = xs.reshape(-1), ys.reshape(-1)
        self._check_queries(xf, yf)
        out = fn(self, self._promote(xf), self._promote(yf), dx=dx, dy=dy)
        return out.reshape(self._out_shape(xs))

    def integrate(self, xlo, xhi, ylo, yhi):
        """The exact integral over the box ``[xlo, xhi] x [ylo, yhi]`` per
        trailing element, per-cell polynomial quadrature (SciPy
        ``RectBivariateSpline.integral``).  Signed per axis.  Out-of-range
        bounds raise unless the strategy extrapolates (then the edge cells
        extend).  ``Bilinear`` and ``Bicubic`` (no periodic axis); returns
        shape ``data.shape[2:]``."""
        fn = _calculus(self.strategy, "eval_integrate_box", "integrate")
        f64, dev = torch.float64, self.x.device
        self._check_queries(_scalars(f64, dev, xlo, xhi), _scalars(f64, dev, ylo, yhi))
        return fn(self, xlo, xhi, ylo, yhi)

    def __repr__(self):
        return (
            f"Interp2D(x={tuple(self.x.shape)}, y={tuple(self.y.shape)}, "
            f"data={tuple(self.data.shape)}, strategy={self.strategy!r})"
        )


def _check_not_nan(q):
    if q.is_floating_point() and bool(torch.isnan(q).any()):
        raise ValueError("failed to convert NaN to an index")


class Interp2DBuilder:
    """Create and configure an :class:`Interp2D` (``mod.rs:50-64``).

    Defaults: strategy ``Bilinear(extrapolate=False)``, x and y the axis
    indices in the data's dtype.
    """

    def __init__(self, data, device=None):
        self._device = default_device(data, device)
        data = _to_tensor(data, self._device, copy=True)
        self._data = data
        if data.ndim >= 2:
            self._x = torch.arange(data.shape[0], device=data.device).to(data.dtype)
            self._y = torch.arange(data.shape[1], device=data.device).to(data.dtype)
        else:
            self._x = self._y = None
        self._strategy = Bilinear()

    def x(self, x) -> "Interp2DBuilder":
        """Set a custom x axis (strictly monotonic rising, length
        ``data.shape[0]``)."""
        self._x = _to_tensor(x, self._device, copy=True)
        return self

    def y(self, y) -> "Interp2DBuilder":
        """Set a custom y axis (strictly monotonic rising, length
        ``data.shape[1]``)."""
        self._y = _to_tensor(y, self._device, copy=True)
        return self

    def strategy(self, strategy: Interp2DStrategyBuilder) -> "Interp2DBuilder":
        self._strategy = strategy
        return self

    def build(self) -> Interp2D:
        """Validate input data and create the configured interpolator.

        Validation order and messages follow ``mod.rs:468-518``."""
        data, x, y, strat = self._data, self._x, self._y, self._strategy

        if data.ndim < 2:
            raise ShapeError("data dimension needs to be at least 2")
        min_len = strat.MINIMUM_DATA_LENGTH
        for axis in (0, 1):
            if data.shape[axis] < min_len:
                raise NotEnoughDataError(
                    f"The {axis}-dimension has not enough data for the chosen "
                    f"interpolation strategy. Provided: {data.shape[axis]}, "
                    f"Required: {min_len}"
                )
        for name, axis, knots in (("x", 0, x), ("y", 1, y)):
            if knots.shape[0] != data.shape[axis]:
                raise ShapeError(
                    f"Lengths of {name}-axis and data-{axis}-axis need to match. "
                    f"Got {name}: {knots.shape[0]}, data-{axis}: {data.shape[axis]}"
                )
        for name, knots in (("x", x), ("y", y)):
            if not monotonic_prop(knots).is_strict_rising:
                raise MonotonicError(f"The {name}-axis needs to be strictly monotonic rising")
        for name, knots in (("x", x), ("y", y)):
            if knots.device != data.device:
                raise ValueError(
                    f"{name} and data must be on one device; got {name} on "
                    f"{knots.device}, data on {data.device}"
                )

        # one dtype for all three (jnp.result_type in the JAX package)
        ct = torch.promote_types(torch.promote_types(x.dtype, y.dtype), data.dtype)
        x, y, data = x.to(ct), y.to(ct), data.to(ct)
        return Interp2D(x, y, data, strat.build(x, y, data))
