"""ctypes bindings of the native host runtime.

Counterpart of ``ndarray_interp_tpu.native``, with its own copy of the C++
source (``src/ndi_native.cpp``, the JAX package's verbatim) built into
``ndarray_interp_tpu_torch/_build/`` by :mod:`.build` under a file lock.

The runtime serves the eager entry points on the host: scalar and small
batches of numpy queries, where a launch on the card and the copy back would
cost more than the arithmetic.  ``HAVE_NATIVE`` is ``False`` when the
library is absent and cannot be built (no compiler); the interpolators then
take their tensor path.  The library is built, if need be, and loaded when
this module is imported.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np

from .build import BUILD_DIR, build

_D = ctypes.c_double
_F = ctypes.c_float
_I = ctypes.c_int64
_INT = ctypes.c_int
_PD = ctypes.POINTER(ctypes.c_double)
_PF = ctypes.POINTER(ctypes.c_float)
_PI = ctypes.POINTER(ctypes.c_int64)
_PINT = ctypes.POINTER(ctypes.c_int)

# (restype, argtypes) of every entry point
_SIGNATURES = {
    "ndi_scalar_linear_f64": (_D, [_PD, _PD, _I, _D, _INT, _PINT]),
    "ndi_scalar_hermite_f64": (_D, [_PD, _PD, _PD, _PD, _I, _D, _INT, _PINT]),
    "ndi_scalar_bilinear_f64": (_D, [_PD, _PD, _PD, _I, _I, _D, _D, _INT, _PINT]),
    "ndi_cubic_build_f64": (_INT, [_PD, _PD, _I, _I, _INT, _D, _INT, _D, _PD, _PD]),
    "ndi_cubic_build_f32": (_INT, [_PF, _PF, _I, _I, _INT, _F, _INT, _F, _PF, _PF]),
    "ndi_lower_index_f64": (_I, [_PD, _I, _D]),
    "ndi_lower_index_f32": (_I, [_PF, _I, _F]),
    "ndi_lower_index_batch_f64": (None, [_PD, _I, _PD, _I, _PI]),
    "ndi_monotonic_f64": (_INT, [_PD, _I]),
    "ndi_eval_linear_f64": (_I, [_PD, _PD, _I, _I, _PD, _I, _PD, _INT]),
    "ndi_eval_linear_f32": (_I, [_PF, _PF, _I, _I, _PF, _I, _PF, _INT]),
    "ndi_eval_hermite_f64": (_I, [_PD, _PD, _PD, _PD, _I, _I, _PD, _I, _PD, _INT]),
    "ndi_eval_hermite_f32": (_I, [_PF, _PF, _PF, _PF, _I, _I, _PF, _I, _PF, _INT]),
    "ndi_eval_bilinear_f64": (_I, [_PD, _PD, _PD, _I, _I, _I, _PD, _PD, _I, _PD, _INT]),
    "ndi_eval_bilinear_f32": (_I, [_PF, _PF, _PF, _I, _I, _I, _PF, _PF, _I, _PF, _INT]),
    "ndi_eval_bicubic_f64": (
        _I, [_PD, _PD, _PD, _PD, _PD, _PD, _I, _I, _I, _PD, _PD, _I, _PD, _INT]),
    "ndi_eval_bicubic_f32": (
        _I, [_PF, _PF, _PF, _PF, _PF, _PF, _I, _I, _I, _PF, _PF, _I, _PF, _INT]),
}


class NativeLibrary:
    """The runtime's library in one build directory: built there if need
    be (under the build's lock), loaded once, its entry points typed."""

    def __init__(self, build_dir=BUILD_DIR):
        self.build_dir = build_dir
        self._lib = None

    def load(self):
        """The loaded library, or ``None`` when it cannot be built or
        loaded."""
        if self._lib is None:
            try:
                lib = ctypes.CDLL(str(build(self.build_dir)))
            except (OSError, subprocess.CalledProcessError):
                return None
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            self._lib = lib
        return self._lib


_default = NativeLibrary()
HAVE_NATIVE = _default.load() is not None


def _load():
    lib = _default.load()
    if lib is None:
        raise RuntimeError("the native host runtime could not be built (is g++ installed?)")
    return lib


def _ptr(arr):
    return arr.ctypes.data_as(_PD if arr.dtype == np.float64 else _PF)


def _prep(arr, dtype):
    return np.ascontiguousarray(arr, dtype=dtype)


def _dtype(*arrays):
    return np.float64 if np.result_type(*arrays) == np.float64 else np.float32


def lower_index(x: np.ndarray, q: float) -> int:
    """``get_lower_index``'s contract: the interval of ``q`` in ``[0, n-2]``
    (below the axis 0, above it ``n-2``, NaN 0)."""
    x = _prep(x, np.float64)
    return int(_load().ndi_lower_index_f64(_ptr(x), x.shape[0], float(q)))


def monotonic(x: np.ndarray) -> int:
    """0 strictly rising, 1 rising, 2 strictly falling, 3 falling, 4 neither
    (or fewer than two values)."""
    x = _prep(x, np.float64)
    return int(_load().ndi_monotonic_f64(_ptr(x), x.shape[0]))


def eval_linear(x, y, q, extrapolate: bool):
    """Linear interpolation of ``y`` (``(n, *trailing)``) at ``q``.  Returns
    ``(out, rc)``: ``rc`` 0, or the 1-based index of the first query out of
    range (nothing written) when not extrapolating."""
    lib = _load()
    dt = _dtype(x, y, q)
    x = _prep(x, dt)
    yc = _prep(y, dt).reshape(y.shape[0], -1)
    qc = _prep(np.atleast_1d(q), dt).reshape(-1)
    out = np.empty((qc.shape[0], yc.shape[1]), dt)
    fn = lib.ndi_eval_linear_f64 if dt == np.float64 else lib.ndi_eval_linear_f32
    rc = fn(_ptr(x), _ptr(yc), x.shape[0], yc.shape[1], _ptr(qc), qc.shape[0],
            _ptr(out), int(extrapolate))
    return out.reshape(np.shape(q) + y.shape[1:]), int(rc)


def eval_hermite(x, y, a, b, q, mode: int):
    """The cubic Hermite form of the 1-D spline family with per-interval
    ``a``, ``b``; ``mode`` 0 raise on out of range (``rc``), 1 extrapolate,
    2 periodic wrap.  Returns ``(out, rc)`` as :func:`eval_linear`."""
    lib = _load()
    dt = _dtype(x, y)
    x = _prep(x, dt)
    yc = _prep(y, dt).reshape(y.shape[0], -1)
    ac = _prep(a, dt).reshape(a.shape[0], -1)
    bc = _prep(b, dt).reshape(b.shape[0], -1)
    qc = _prep(np.atleast_1d(q), dt).reshape(-1)
    out = np.empty((qc.shape[0], yc.shape[1]), dt)
    fn = lib.ndi_eval_hermite_f64 if dt == np.float64 else lib.ndi_eval_hermite_f32
    rc = fn(_ptr(x), _ptr(yc), _ptr(ac), _ptr(bc), x.shape[0], yc.shape[1],
            _ptr(qc), qc.shape[0], _ptr(out), int(mode))
    return out.reshape(np.shape(q) + y.shape[1:]), int(rc)


def _check_query_pair(qxc, qyc):
    # the C++ loops read qy[i] for i in [0, len(qx)): refuse mismatched pairs
    if qxc.shape != qyc.shape:
        raise ValueError(
            f"`xs.shape` and `ys.shape` do not match: {qxc.shape} vs {qyc.shape}"
        )


def eval_bilinear(x, y, z, qx, qy, extrapolate: bool):
    """Bilinear interpolation of ``z`` (``(nx, ny, *trailing)``).  Returns
    ``(out, rc)``: ``rc`` 0, or the 1-based index of the first query out of
    range, positive on x, negative on y."""
    lib = _load()
    dt = _dtype(x, y, z)
    x = _prep(x, dt)
    y = _prep(y, dt)
    zc = _prep(z, dt).reshape(z.shape[0], z.shape[1], -1)
    qxc = _prep(np.atleast_1d(qx), dt).reshape(-1)
    qyc = _prep(np.atleast_1d(qy), dt).reshape(-1)
    _check_query_pair(qxc, qyc)
    out = np.empty((qxc.shape[0], zc.shape[2]), dt)
    fn = lib.ndi_eval_bilinear_f64 if dt == np.float64 else lib.ndi_eval_bilinear_f32
    rc = fn(_ptr(x), _ptr(y), _ptr(zc), x.shape[0], y.shape[0], zc.shape[2],
            _ptr(qxc), _ptr(qyc), qxc.shape[0], _ptr(out), int(extrapolate))
    return out.reshape(np.shape(qx) + z.shape[2:]), int(rc)


def eval_bicubic(x, y, f, kx, ky, kxy, qx, qy, extrapolate: bool):
    """The tensor-product cubic (``Bicubic``) on the host: ``f`` the
    ``(nx, ny, *trailing)`` grid, ``kx``, ``ky``, ``kxy`` its node grids
    (``bicubic_node_grids``).  Returns ``(out, rc)`` as
    :func:`eval_bilinear`."""
    lib = _load()
    dt = _dtype(x, y, f)
    x = _prep(x, dt)
    y = _prep(y, dt)
    fc = _prep(f, dt).reshape(f.shape[0], f.shape[1], -1)
    kxc = _prep(kx, dt).reshape(fc.shape)
    kyc = _prep(ky, dt).reshape(fc.shape)
    kxyc = _prep(kxy, dt).reshape(fc.shape)
    qxc = _prep(np.atleast_1d(qx), dt).reshape(-1)
    qyc = _prep(np.atleast_1d(qy), dt).reshape(-1)
    _check_query_pair(qxc, qyc)
    out = np.empty((qxc.shape[0], fc.shape[2]), dt)
    fn = lib.ndi_eval_bicubic_f64 if dt == np.float64 else lib.ndi_eval_bicubic_f32
    rc = fn(_ptr(x), _ptr(y), _ptr(fc), _ptr(kxc), _ptr(kyc), _ptr(kxyc),
            x.shape[0], y.shape[0], fc.shape[2], _ptr(qxc), _ptr(qyc),
            qxc.shape[0], _ptr(out), int(extrapolate))
    return out.reshape(np.shape(qx) + f.shape[2:]), int(rc)


def cubic_build(x, y, left_kind, left_val, right_kind, right_val):
    """The cubic spline's ``(a, b)`` (``(n-1, *y.shape[1:])``) for one
    boundary kind a side: 0 not-a-knot, 1 first derivative, 2 second
    derivative, each with its value."""
    lib = _load()
    dt = _dtype(x, y)
    xc = _prep(x, dt)
    yc = _prep(y, dt).reshape(y.shape[0], -1)
    n, m = yc.shape
    a = np.empty((n - 1, m), dt)
    b = np.empty((n - 1, m), dt)
    fn = lib.ndi_cubic_build_f64 if dt == np.float64 else lib.ndi_cubic_build_f32
    rc = fn(_ptr(xc), _ptr(yc), n, m, int(left_kind), float(left_val),
            int(right_kind), float(right_val), _ptr(a), _ptr(b))
    if rc != 0:
        raise ValueError("cubic_build failed (need at least 3 points)")
    tail = y.shape[1:]
    return a.reshape((n - 1,) + tail), b.reshape((n - 1,) + tail)


class ScalarEval1D:
    """Prebound scalar evaluator of f64 1-D data: the buffers and pointers
    are made once, so each call is one C call.  ``a``/``b`` given: the Hermite
    form with ``mode`` as :func:`eval_hermite`; else linear, ``mode`` 1 to
    extrapolate."""

    def __init__(self, x, y, a=None, b=None, mode=0):
        lib = _load()
        self._err = ctypes.c_int(0)
        self._x = _prep(x, np.float64)
        self._y = _prep(y, np.float64)
        self._mode = int(mode)
        if a is None:
            self._fn = lib.ndi_scalar_linear_f64
            self._args = (_ptr(self._x), _ptr(self._y), self._x.shape[0])
        else:
            self._a = _prep(a, np.float64)
            self._b = _prep(b, np.float64)
            self._fn = lib.ndi_scalar_hermite_f64
            self._args = (_ptr(self._x), _ptr(self._y), _ptr(self._a), _ptr(self._b),
                          self._x.shape[0])

    def __call__(self, q: float):
        """Returns ``(value, err)``: err 0 ok, 1 out of range, 2 NaN."""
        v = self._fn(*self._args, q, self._mode, ctypes.byref(self._err))
        return v, self._err.value


class ScalarEval2D:
    """Prebound scalar evaluator of f64 2-D data, ``z`` of ``(nx, ny)``:
    bilinear, or with the node grids ``kx``, ``ky``, ``kxy`` the bicubic
    form of :func:`eval_bicubic` (one query a call on preallocated
    buffers)."""

    def __init__(self, x, y, z, extrapolate: bool, kx=None, ky=None, kxy=None):
        lib = _load()
        self._err = ctypes.c_int(0)
        self._x = _prep(x, np.float64)
        self._y = _prep(y, np.float64)
        self._z = _prep(z, np.float64)
        self._extrap = int(extrapolate)
        nx, ny = self._x.shape[0], self._y.shape[0]
        if kx is None:
            self._bicubic = False
            self._fn = lib.ndi_scalar_bilinear_f64
            self._args = (_ptr(self._x), _ptr(self._y), _ptr(self._z), nx, ny)
            return
        self._bicubic = True
        self._grids = [_prep(g, np.float64) for g in (kx, ky, kxy)]
        self._qx = np.zeros(1)
        self._qy = np.zeros(1)
        self._out = np.zeros(1)
        self._fn = lib.ndi_eval_bicubic_f64
        self._args = (_ptr(self._x), _ptr(self._y), _ptr(self._z),
                      *(_ptr(g) for g in self._grids), nx, ny, 1,
                      _ptr(self._qx), _ptr(self._qy), 1, _ptr(self._out), self._extrap)

    def __call__(self, qx: float, qy: float):
        """Returns ``(value, err)``: 0 ok, 1 x out of range, -1 y out of
        range, 2 NaN."""
        if not self._bicubic:
            v = self._fn(*self._args, qx, qy, self._extrap, ctypes.byref(self._err))
            return v, self._err.value
        if qx != qx or qy != qy:
            return qx + qy, 2
        self._qx[0] = qx
        self._qy[0] = qy
        rc = self._fn(*self._args)
        return float(self._out[0]), (rc > 0) - (rc < 0)
