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
that are tensors stay on their path; ``__call__`` never synchronises with
the device, ``eval_checked`` returns its range check as a device flag, and
the eager methods check their queries first, which costs one copy of a flag
to the host.

The native host runtime (``native/``, as in the JAX package): numpy and
float queries of the eager methods (``interp_scalar``, ``interp_into``,
``interp_array`` on float64 data up to 1,000,000 values,
``interp_array_into``) are served on the host by C++ and come back as numpy
(a float from ``interp_scalar`` on float64 data), for the strategies with a
host form (``Linear``, ``CubicSpline``, ``Akima``, ``Makima``, ``Pchip``)
and while ``config.use_native_host`` is on.  A CPU interpolator's own
tensors are its host view.  For an interpolator on the card the builder
copies host inputs (``_host_inputs``) when it copies them to the card, so the
host route and the card answer from the same data and the eager methods
never copy back from the card; it rebuilds ``a, b`` on the host (natively
for the uniform cubic boundaries, else on CPU tensors) once, at the first
such call.
Without the runtime (``native.HAVE_NATIVE`` false) every query takes the
tensor path.
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
    """Copy ``result`` (a tensor, or numpy from the native runtime) into a
    tensor or numpy ``buffer``."""
    if isinstance(buffer, torch.Tensor):
        buffer.copy_(torch.as_tensor(result))
    elif isinstance(result, torch.Tensor):
        buffer[...] = result.detach().cpu().numpy()
    else:
        buffer[...] = result
    return buffer


_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


def _host_view(value):
    """``value`` as numpy without touching a device: numpy arrays as they
    are (a reference, not a copy), lists and scalars through numpy, a CPU
    tensor's own memory; ``None`` for a CUDA tensor or one that needs its
    gradient (the native runtime would drop it)."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu" or value.requires_grad or value.dtype not in _NP_FLOAT:
            return None
        return value.numpy()
    return np.asarray(value)


def _host_copy(value, device):
    """A numpy copy of ``value`` for the native runtime of an interpolator
    on ``device``, taken when the value is copied to the card, so that a
    later write to the caller's array changes neither; ``None`` on the CPU,
    where the interpolator's own tensors are the host view, and for values
    with no host view."""
    if device.type == "cpu":
        return None
    view = _host_view(value)
    return None if view is None else np.array(view, copy=True)


def _is_host_query(q):
    """A query the native runtime may serve: not a tensor."""
    return not isinstance(q, torch.Tensor)


def _native_state(itp):
    """``itp``'s host state for the native runtime, made once by its
    ``_build_native_state`` (``None``: no host form); ``None`` without it
    while ``config.use_native_host`` is off or the runtime is not built (its
    first import builds it)."""
    cached = getattr(itp, "_host_cache", None)
    if cached is None:
        from .. import config

        state = None
        if config.use_native_host:
            from ..native import HAVE_NATIVE

            state = itp._build_native_state() if HAVE_NATIVE else None
        itp._host_cache = cached = () if state is None else state
    return cached or None


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

    def eval_checked(self, xs):
        """Checked evaluation that never synchronises with the device, so it
        can run inside a captured CUDA graph: the JAX package's
        ``checkify`` form.  Returns ``(error, values)``: ``values`` as
        :meth:`eval_unchecked`, ``error`` a :class:`CheckError` whose flag
        is set on the device when a query is out of range and the strategy
        does not extrapolate (``error.throw()`` raises ``OutOfBoundsError``
        with JAX's message, ``error.get()`` returns it or ``None``)."""
        xs = self._queries(xs)
        checks = []
        if not self.strategy.extrapolates:
            ok = is_in_range(self.x, self._promote(xs.reshape(-1)))
            checks.append((~ok.all(), "a query point is not in range"))
        return CheckError(checks), self.eval_unchecked(xs)

    # -- helpers available to strategies (mod.rs:367-386) --------------------
    def index_point(self, index):
        """``(x, data)`` at the given index."""
        return self.x[index], self.data[index]

    def get_index_left_of(self, x):
        """Index of a knot left of, or at, ``x`` and never the last one, so
        ``index_point(idx + 1)`` is always safe: ``get_lower_index``, plain
        PyTorch (``torch.searchsorted``), so it also runs under ``vmap``."""
        return get_lower_index(self.x, _to_tensor(x, self.x.device))

    def is_in_range(self, x):
        """``x[0] <= x <= x[-1]`` elementwise (NaN: ``False``)."""
        return is_in_range(self.x, _to_tensor(x, self.x.device))

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

    # -- native host runtime ---------------------------------------------------
    def _native_state(self):
        return _native_state(self)

    def _build_native_state(self):
        """``("linear", x, data, extrapolate)`` or ``("hermite", x, data, a, b,
        mode)`` as numpy, or ``None`` when the strategy or dtype has no host
        form (the tensor path then serves every query)."""
        from .strategies.cubic import CubicSpline, CubicSplineStrategy

        if self.data.dtype not in _NP_FLOAT:
            return None
        hi = getattr(self, "_host_inputs", None)
        if hi is not None:
            x_np, d_np, builder = hi
        else:
            x_np, d_np, builder = _host_view(self.x), _host_view(self.data), None
        if x_np is None or d_np is None:
            return None
        if isinstance(self.strategy, Linear):
            return ("linear", x_np, d_np, bool(self.strategy.extrapolates))
        if not isinstance(self.strategy, CubicSplineStrategy):
            return None
        mode = {"no": 0, "yes": 1, "periodic": 2}[self.strategy.mode]
        a_np, b_np = _host_view(self.strategy.a), _host_view(self.strategy.b)
        if (a_np is None or b_np is None) and builder is not None:
            # the coefficients live on the card: build them again on the host
            # rather than copy them back, natively for the uniform boundaries
            kinds = {"not_a_knot": 0, "clamped": 1, "natural": 2}
            if isinstance(builder, CubicSpline) and builder._boundary.kind in kinds:
                from ..native import cubic_build

                kind = kinds[builder._boundary.kind]
                a_np, b_np = cubic_build(x_np, d_np, kind, 0.0, kind, 0.0)
            else:
                host = builder.build(torch.tensor(x_np), torch.tensor(d_np))
                a_np, b_np = host.a.numpy(), host.b.numpy()
        if a_np is None or b_np is None:
            return None
        return ("hermite", x_np, d_np, a_np, b_np, mode)

    def _native_eval(self, xs):
        """``xs`` evaluated by the native runtime as numpy, with the eager
        methods' errors; ``None`` when it is not eligible."""
        state = self._native_state()
        if state is None:
            return None
        from ..native import eval_hermite, eval_linear

        xs_np = np.asarray(xs, dtype=state[1].dtype)
        if np.isnan(xs_np).any():
            extrap = state[3] if state[0] == "linear" else state[5] != 0
            if extrap:
                raise ValueError("failed to convert NaN to an index")
            raise OutOfBoundsError(f"x = {xs_np[np.isnan(xs_np)][0]} is not in range")
        if state[0] == "linear":
            _, x_np, d_np, extrap = state
            out, rc = eval_linear(x_np, d_np, xs_np, extrap)
        else:
            _, x_np, d_np, a_np, b_np, mode = state
            out, rc = eval_hermite(x_np, d_np, a_np, b_np, xs_np, mode)
        if rc != 0:
            raise OutOfBoundsError(f"x = {xs_np.reshape(-1)[rc - 1]} is not in range")
        return out

    def _scalar_evaluator(self):
        """The prebound C scalar evaluator (float64 1-D data only: float32
        stays on the batch form, whose arithmetic is in float32), made once."""
        fast = getattr(self, "_scalar_eval", None)
        if fast is None:
            fast = False
            state = self._native_state()
            if state is not None and state[1].dtype == np.float64:
                from ..native import ScalarEval1D

                if state[0] == "linear":
                    _, x_np, d_np, extrap = state
                    fast = ScalarEval1D(x_np, d_np, mode=int(extrap))
                else:
                    _, x_np, d_np, a_np, b_np, mode = state
                    fast = ScalarEval1D(x_np, d_np, a_np, b_np, mode=mode)
            self._scalar_eval = fast
        return fast or None

    def interp_scalar(self, x):
        """Interpolate one point of 1-D data (``mod.rs:108-114``): a float
        from the native runtime for a float on float64 data, a numpy scalar
        for other host queries it serves, else a 0-d tensor."""
        if self.data.ndim != 1:
            raise ShapeError(
                "interp_scalar requires 1-D data; use interp() instead"
            )
        if _is_host_query(x):
            fast = self._scalar_evaluator()
            if fast is not None and isinstance(x, (int, float)):
                v, err = fast(float(x))
                if err == 0:
                    return v
                if err == 2 and self.strategy.extrapolates:
                    raise ValueError("failed to convert NaN to an index")
                raise OutOfBoundsError(f"x = {x} is not in range")
            out = self._native_eval(x)
            if out is not None:
                return out[()]
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
        if _is_host_query(x):
            out = self._native_eval(x)
            if out is not None:
                return _write(buffer, out)
        return _write(buffer, self.interp(x))

    def interp_array(self, xs):
        """Interpolated values at all points in ``xs``; output dims
        ``M + N - 1`` with query dims leading (``mod.rs:197-211``).  Numpy
        or list queries on float64 data, up to 1,000,000 values in all, are
        served by the native runtime and come back as numpy (large host
        batches are better off on the card)."""
        if (
            _is_host_query(xs)
            and self.data.dtype == torch.float64
            and np.size(xs) * self.data[0].numel() <= 1_000_000
        ):
            out = self._native_eval(xs)
            if out is not None:
                return out
        xs = self._queries(xs)
        self._check_queries(xs.reshape(-1))
        return self.eval_unchecked(xs)

    def interp_array_into(self, xs, buffer):
        """``interp_array`` into a caller-provided buffer (a tensor or a
        numpy array) (``mod.rs:272-324``); numpy queries on the native
        runtime where it serves them."""
        _check_buffer(buffer, self.get_buffer_shape(np.shape(xs)))
        if _is_host_query(xs):
            out = self._native_eval(xs)
            if out is not None:
                return _write(buffer, out)
        return _write(buffer, self.interp_array(self._queries(xs)))

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
        self._data_host = _host_copy(data, self._device)
        data = _to_tensor(data, self._device, copy=True)
        self._data = data
        n = data.shape[0] if data.ndim >= 1 else 0
        # default x = 0..n in the data's dtype (mod.rs:399-410)
        self._x = (
            torch.arange(n, device=data.device).to(data.dtype)
            if data.ndim >= 1
            else None
        )
        self._x_host = _host_copy(np.arange(n), self._device) if data.ndim >= 1 else None
        self._strategy = Linear()

    def x(self, x) -> "Interp1DBuilder":
        """Set a custom x axis; must be strictly monotonic rising and match
        the data's axis-0 length (``mod.rs:424-430``)."""
        self._x_host = _host_copy(x, self._device)
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
        interp = Interp1D(x, data, strat.build(x, data))
        # host copies for the native runtime of a card interpolator: the
        # eager methods never copy back from the card
        views = (self._x_host, self._data_host)
        if ct in _NP_FLOAT and data.device.type != "cpu" and all(v is not None for v in views):
            interp._host_inputs = (*(v.astype(_NP_FLOAT[ct], copy=False) for v in views), strat)
        return interp
