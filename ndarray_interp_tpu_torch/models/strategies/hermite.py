"""Akima, modified Akima and PCHIP strategies.

Counterpart of ``ndarray_interp_tpu.models.strategies.hermite``.  All three
are cubic Hermite splines that differ from :class:`CubicSpline` only in how
the knot derivatives ``k`` are chosen (local slope rules instead of a global
tridiagonal solve).  They lower to the same per-interval ``(a, b)``
coefficients (``cubic_spline.rs:350-367``)::

    a[i] = k[i]·dx[i] - dy[i]
    b[i] = dy[i] - k[i+1]·dx[i]

and evaluate as a :class:`CubicSplineStrategy`, so they ride its routes:
K1 or R3 for scalar data, K5 or the packed route for banks.  The slope
rules follow SciPy (``Akima1DInterpolator``, ``PchipInterpolator``) in the
JAX package's operation order, elementwise across the trailing (bank) axes.
"""

from __future__ import annotations

import torch

from .base import Interp1DStrategyBuilder
from .cubic import CubicSplineStrategy, _ab_from_k, _dtype_name


def _ex(v, tr):
    return v.reshape(tuple(v.shape) + (1,) * tr)


def _akima_k(x, y, method="akima"):
    """Akima's 1970 slope rule (SciPy-compatible).

    ``method="makima"`` applies the modified-Akima weights (MATLAB's makima;
    SciPy ``Akima1DInterpolator(method="makima")``): each weight gains
    ``|m_a + m_b| / 2``, which breaks the 0/0 tie on locally flat data toward
    the average slope and damps overshoot."""
    tr = y.ndim - 1
    dx = _ex(x[1:] - x[:-1], tr)
    m = (y[1:] - y[:-1]) / dx  # (n-1, *bank)
    # extend with two fictitious slopes on each side
    m1 = 2.0 * m[0] - m[1]
    m0 = 2.0 * m1 - m[0]
    mn = 2.0 * m[-1] - m[-2]
    mn1 = 2.0 * mn - m[-1]
    me = torch.cat([m0[None], m1[None], m, mn[None], mn1[None]])  # (n+3, *bank)
    dm = (me[1:] - me[:-1]).abs()  # (n+2, *bank)
    if method == "makima":
        pm = (me[1:] + me[:-1]).abs()
        f1 = dm[2:] + 0.5 * pm[2:]
        f2 = dm[:-2] + 0.5 * pm[:-2]
    else:
        f1 = dm[2:]  # |m[i+1]-m[i]|
        f2 = dm[:-2]  # |m[i-1]-m[i-2]|
    f12 = f1 + f2
    m_im1 = me[1:-2]
    m_i = me[2:-1]
    default = 0.5 * (m_im1 + m_i)
    # SciPy guards the division with f12 > 1e-9 * max(f12)
    safe = f12 > 1e-9 * f12.max()
    return torch.where(
        safe, (f1 * m_im1 + f2 * m_i) / torch.where(safe, f12, 1.0), default
    )  # (n, *bank) knot derivatives


def _pchip_k(x, y):
    """Fritsch–Carlson monotone slopes (SciPy-compatible)."""
    tr = y.ndim - 1
    h = _ex(x[1:] - x[:-1], tr)  # (n-1, 1...)
    m = (y[1:] - y[:-1]) / h  # (n-1, *bank)
    if y.shape[0] == 2:
        return torch.cat([m, m])

    hk_1, hk = h[:-1], h[1:]
    mk_1, mk = m[:-1], m[1:]
    # interior: weighted harmonic mean where slopes share a sign
    w1 = 2.0 * hk + hk_1
    w2 = hk + 2.0 * hk_1
    condition = (torch.sign(mk_1) != torch.sign(mk)) | (mk == 0) | (mk_1 == 0)
    mk_1s = torch.where(condition, 1.0, mk_1)  # avoid 0-division
    mks = torch.where(condition, 1.0, mk)
    whmean = (w1 / mk_1s + w2 / mks) / (w1 + w2)
    dk_interior = torch.where(condition, 0.0, 1.0 / whmean)

    def edge(h0, h1, m0, m1):
        # SciPy's one-sided three-point estimate with sign fix-ups
        d = ((2.0 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
        mask = torch.sign(d) != torch.sign(m0)
        mask2 = (torch.sign(m0) != torch.sign(m1)) & (d.abs() > 3.0 * m0.abs())
        d = torch.where(mask, 0.0, d)
        return torch.where(~mask & mask2, 3.0 * m0, d)

    d0 = edge(h[0], h[1], m[0], m[1])
    dn = edge(h[-1], h[-2], m[-1], m[-2])
    return torch.cat([d0[None], dk_interior, dn[None]])


class _HermiteBuilder(Interp1DStrategyBuilder):
    """Shared builder: slopes, then ``(a, b)``, then the cubic evaluation
    strategy and its routes."""

    MINIMUM_DATA_LENGTH = 3

    def __init__(self, extrapolate: bool = False):
        self.extrapolates = bool(extrapolate)

    def extrapolate(self, yes: bool = True):
        return type(self)(extrapolate=yes)

    def _slopes(self, x, data):
        raise NotImplementedError

    def build(self, x, data) -> CubicSplineStrategy:
        if not data.is_floating_point():
            raise TypeError(
                f"{type(self).__name__} requires a floating-point dtype; "
                f"got {_dtype_name(data.dtype)}"
            )
        a, b = _ab_from_k(x, data, self._slopes(x, data))
        return CubicSplineStrategy(a, b, "yes" if self.extrapolates else "no")


class Akima(_HermiteBuilder):
    """Akima (1970) spline: a local slope rule robust to outliers."""

    def _slopes(self, x, data):
        return _akima_k(x, data)

    def __repr__(self):
        return f"Akima(extrapolate={self.extrapolates})"


class Makima(_HermiteBuilder):
    """Modified Akima (MATLAB's ``makima``; SciPy
    ``Akima1DInterpolator(method="makima")``): Akima's rule with
    ``|m_a + m_b|/2`` added to each weight."""

    def _slopes(self, x, data):
        return _akima_k(x, data, method="makima")

    def __repr__(self):
        return f"Makima(extrapolate={self.extrapolates})"


class Pchip(_HermiteBuilder):
    """PCHIP: shape-preserving monotone cubic Hermite interpolation."""

    MINIMUM_DATA_LENGTH = 2

    def _slopes(self, x, data):
        return _pchip_k(x, data)

    def __repr__(self):
        return f"Pchip(extrapolate={self.extrapolates})"
