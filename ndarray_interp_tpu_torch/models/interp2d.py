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
``__call__`` never synchronises with the device, nor does ``eval_checked``
(its range checks stay device flags, x before y, a wrapping axis exempt);
the eager methods check their queries first, one flag copied to the host per
axis.  Numpy and float queries of the eager methods are served by the native
host runtime as in :mod:`.interp1d`, for ``Bilinear`` (as in the JAX
package) and for ``Bicubic`` without a periodic axis (its node grids solved
once on the host from the builder's numpy inputs, ``native.eval_bicubic``).

Beyond the reference, as in the JAX package: ``derivative`` (SciPy's
``RectBivariateSpline.ev(xs, ys, dx, dy)``) and ``integrate`` (its
``.integral``) for ``Bilinear`` and ``Bicubic``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import (
    CheckError,
    MonotonicError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)
from ..ops._cuda import traced
from ..ops.partition import is_dtensor, local_call
from ..ops.searchsorted import get_lower_index, is_in_range
from ..utils.device import default_device
from ..utils.monotonic import monotonic_prop
from .interp1d import (
    _NP_FLOAT,
    _calculus,
    _check_buffer,
    _host_copy,
    _host_view,
    _is_host_query,
    _native_state,
    _to_tensor,
    _write,
)
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
        ``Err(OutOfBounds)``.  DTensor queries run on each rank's local
        shards and give a DTensor with their placements."""
        if is_dtensor(xs) or is_dtensor(ys):
            return local_call(self.__call__, xs, ys)
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

    def eval_checked(self, xs, ys):
        """Checked evaluation that never synchronises with the device (it
        runs inside a captured CUDA graph), the JAX package's ``checkify``
        form: ``(error, values)`` as ``Interp1D.eval_checked``, the x check
        before the y check, a wrapping axis never out of range."""
        xs, ys = self._queries(xs, ys)
        checks = []
        if not self.strategy.extrapolates:
            wraps = self._wraps()
            axes = (("an x", self.x, xs, wraps[0]), ("a y", self.y, ys, wraps[1]))
            for name, knots, q, wrap in axes:
                if not wrap:
                    ok = is_in_range(knots, self._promote(q.reshape(-1)))
                    checks.append((~ok.all(), f"{name} query point is not in range"))
        return CheckError(checks), self.eval_unchecked(xs, ys)

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
        range.  NaN refuses to index where no range check catches it.
        Skipped under a ``torch.func`` transform (the JAX package's tracers)."""
        if traced(xs_flat) or traced(ys_flat):
            return
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

    # -- native host runtime ---------------------------------------------------
    def _native_state(self):
        return _native_state(self)

    def _build_native_state(self):
        """``("bilinear", x, y, data, extrapolate)`` or ``("bicubic", x, y,
        data, kx, ky, kxy, extrapolate)`` as numpy, or ``None`` when the
        strategy (a periodic ``Bicubic`` axis included) or dtype has no host
        form."""
        from .strategies.bicubic import BicubicStrategy, bicubic_node_grids

        if self.data.dtype not in _NP_FLOAT:
            return None
        hi = getattr(self, "_host_inputs", None)
        views = hi if hi is not None else tuple(_host_view(t) for t in (self.x, self.y, self.data))
        if any(v is None for v in views):
            return None
        x_np, y_np, d_np = views
        extrap = bool(self.strategy.extrapolates)
        if isinstance(self.strategy, Bilinear):
            return ("bilinear", x_np, y_np, d_np, extrap)
        if isinstance(self.strategy, BicubicStrategy) and not any(self._wraps()):
            # the node grids, solved again on the host from the host inputs
            grids = bicubic_node_grids(
                *(torch.tensor(v) for v in views), self.strategy.bc_x, self.strategy.bc_y
            )
            return ("bicubic", x_np, y_np, d_np, *(g.numpy() for g in grids), extrap)
        return None

    def _native_eval(self, x, y):
        """``(x, y)`` evaluated by the native runtime as numpy, with the
        eager methods' errors; ``None`` when it is not eligible."""
        state = self._native_state()
        if state is None:
            return None
        from ..native import eval_bicubic, eval_bilinear

        x_np = state[1]
        qx = np.asarray(x, dtype=x_np.dtype)
        qy = np.asarray(y, dtype=x_np.dtype)
        for name, q in (("x", qx), ("y", qy)):
            if np.isnan(q).any():
                if state[-1]:
                    raise ValueError("failed to convert NaN to an index")
                raise OutOfBoundsError(f"{name} = nan is not in range")
        if state[0] == "bilinear":
            out, rc = eval_bilinear(*state[1:4], qx, qy, state[-1])
        else:
            out, rc = eval_bicubic(*state[1:7], qx, qy, state[-1])
        if rc > 0:
            raise OutOfBoundsError(f"x = {qx.reshape(-1)[rc - 1]} is not in range")
        if rc < 0:
            raise OutOfBoundsError(f"y = {qy.reshape(-1)[-rc - 1]} is not in range")
        return out

    def _scalar_evaluator(self):
        """The prebound C scalar evaluator (float64 2-D data only), made
        once."""
        fast = getattr(self, "_scalar_eval", None)
        if fast is None:
            fast = False
            state = self._native_state()
            if state is not None and state[1].dtype == np.float64:
                from ..native import ScalarEval2D

                grids = state[4:7] if state[0] == "bicubic" else ()
                fast = ScalarEval2D(*state[1:4], state[-1], *grids)
            self._scalar_eval = fast
        return fast or None

    def interp_scalar(self, x, y):
        """Interpolate one point of 2-D data (``mod.rs:107-113``): a float
        from the native runtime for floats on float64 data, a numpy scalar
        for other host queries it serves, else a 0-d tensor."""
        if self.data.ndim != 2:
            raise ShapeError("interp_scalar requires 2-D data; use interp() instead")
        if _is_host_query(x) and _is_host_query(y):
            fast = self._scalar_evaluator()
            if fast is not None and isinstance(x, (int, float)) and isinstance(y, (int, float)):
                v, err = fast(float(x), float(y))
                if err == 0:
                    return v
                if err == 2:
                    if self.strategy.extrapolates:
                        raise ValueError("failed to convert NaN to an index")
                    raise OutOfBoundsError(f"{'x' if x != x else 'y'} = nan is not in range")
                if err == 1:
                    raise OutOfBoundsError(f"x = {x} is not in range")
                raise OutOfBoundsError(f"y = {y} is not in range")
            out = self._native_eval(x, y)
            if out is not None:
                return out[()]
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
        if _is_host_query(x) and _is_host_query(y):
            out = self._native_eval(x, y)
            if out is not None:
                return _write(buffer, out)
        return _write(buffer, self.interp(x, y))

    def interp_array(self, xs, ys):
        """Interpolated values at all points ``(xs, ys)``; output dims
        ``M + N - 2`` with query dims leading (``mod.rs:175-196``).  Numpy
        or list queries on float64 data, up to 1,000,000 values in all, are
        served by the native runtime and come back as numpy."""
        if np.shape(xs) != np.shape(ys):
            raise ValueError(_SHAPES_DIFFER)
        if (
            _is_host_query(xs)
            and _is_host_query(ys)
            and self.data.dtype == torch.float64
            and np.size(xs) * self.data[0, 0].numel() <= 1_000_000
        ):
            out = self._native_eval(xs, ys)
            if out is not None:
                return out
        xs, ys = self._queries(xs, ys)
        self._check_queries(xs.reshape(-1), ys.reshape(-1))
        return self.eval_unchecked(xs, ys)

    def interp_array_into(self, xs, ys, buffer):
        """``interp_array`` into a caller-provided buffer (a tensor or a
        numpy array) (``mod.rs:215-285``); the buffer's shape is checked
        first, then the queries'."""
        _check_buffer(buffer, self.get_buffer_shape(np.shape(xs)))
        if np.shape(xs) != np.shape(ys):
            raise ValueError(_SHAPES_DIFFER)
        if _is_host_query(xs) and _is_host_query(ys):
            out = self._native_eval(xs, ys)
            if out is not None:
                return _write(buffer, out)
        return _write(buffer, self.interp_array(*self._queries(xs, ys)))

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
        self._data_host = _host_copy(data, self._device)
        data = _to_tensor(data, self._device, copy=True)
        self._data = data
        if data.ndim >= 2:
            self._x = torch.arange(data.shape[0], device=data.device).to(data.dtype)
            self._y = torch.arange(data.shape[1], device=data.device).to(data.dtype)
            self._x_host, self._y_host = (
                _host_copy(np.arange(m), self._device) for m in data.shape[:2]
            )
        else:
            self._x = self._y = self._x_host = self._y_host = None
        self._strategy = Bilinear()

    def x(self, x) -> "Interp2DBuilder":
        """Set a custom x axis (strictly monotonic rising, length
        ``data.shape[0]``)."""
        self._x_host = _host_copy(x, self._device)
        self._x = _to_tensor(x, self._device, copy=True)
        return self

    def y(self, y) -> "Interp2DBuilder":
        """Set a custom y axis (strictly monotonic rising, length
        ``data.shape[1]``)."""
        self._y_host = _host_copy(y, self._device)
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
        interp = Interp2D(x, y, data, strat.build(x, y, data))
        # host copies for the native runtime of a card interpolator (as in 1-D)
        views = (self._x_host, self._y_host, self._data_host)
        if ct in _NP_FLOAT and data.device.type != "cpu" and all(v is not None for v in views):
            interp._host_inputs = tuple(v.astype(_NP_FLOAT[ct], copy=False) for v in views)
        return interp
