"""Batched closed-form real roots for the splines' ``solve`` and ``roots``.

Counterpart of ``ndarray_interp_tpu.ops.cubicroots``.  A spline of ``n``
knots has ``n-1`` interval cubics of at most 3 real roots each, so its root
set has the static bound ``3(n-1)``: the whole solve is one fixed-shape
batched computation (classify, closed form, Newton polish, accept window,
sort, dedupe) padded with NaN, with no per-interval loop and no host sync.

Numerics: the trigonometric method for three real roots and a
cancellation-free Cardano for one, evaluated elementwise in the input's
dtype, then two Newton steps on the original coefficients; roots within
``_EDGE_TOL`` of an interval edge are accepted by both neighbours and merged
by the dedupe pass.
"""

from __future__ import annotations

import functools
import math

import torch

# Acceptance slack at interval edges, in units of the local parameter t
# (intervals are [0, 1] in t); Newton-polished roots sit ~1e-15 from the
# true root.
_EDGE_TOL = 1e-9


def _cbrt(v):
    """The real cube root (PyTorch has no ``cbrt``)."""
    return torch.sign(v) * v.abs().pow(1.0 / 3.0)


def real_cubic_roots(c0, c1, c2, c3, *, newton: int = 2):
    """Real roots of ``c3 t**3 + c2 t**2 + c1 t + c0``, elementwise.

    Returns ``broadcast_shape + (3,)``, NaN-padded, in the coefficients'
    floating dtype (float32 at least).  Degenerate leading coefficients
    fall through to the quadratic and linear forms (exact-zero tests).
    Multiple roots may repeat; an identically zero polynomial has none (the
    caller picks its representative point)."""
    c0, c1, c2, c3 = (torch.as_tensor(c) for c in (c0, c1, c2, c3))
    dtype = functools.reduce(torch.promote_types, (c.dtype for c in (c0, c1, c2, c3)))
    if not dtype.is_floating_point:
        dtype = torch.float32
    c0, c1, c2, c3 = (c.to(dtype) for c in torch.broadcast_tensors(c0, c1, c2, c3))
    nan = torch.full_like(c0, math.nan)
    one = torch.ones_like(c0)
    zero = torch.zeros_like(c0)

    is_cubic = c3 != 0
    is_quad = ~is_cubic & (c2 != 0)
    is_lin = ~is_cubic & ~is_quad & (c1 != 0)

    # cubic: depress to s^3 + p s + q, t = s - b/3
    safe3 = torch.where(is_cubic, c3, one)
    b = c2 / safe3
    c = c1 / safe3
    d = c0 / safe3
    p = c - b * b / 3.0
    q = (2.0 * b * b * b / 27.0) - (b * c / 3.0) + d
    disc = 0.25 * q * q + p * p * p / 27.0

    # three real roots (disc <= 0): the trigonometric method
    m2 = torch.sqrt(torch.clamp(-p / 3.0, min=0.0))
    m2_safe = torch.where(m2 > 0, m2, one)
    phi = torch.arccos(torch.clamp(-q / (2.0 * m2_safe**3), -1.0, 1.0)) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    s_tri = [2.0 * m2 * torch.cos(phi - k * two_pi_3) for k in range(3)]

    # one real root (disc > 0): Cardano, the branch without cancellation
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    big = -0.5 * q - torch.sign(q) * sq
    A = _cbrt(big)
    A_safe = torch.where(A != 0, A, one)
    B = torch.where(A != 0, -p / (3.0 * A_safe), zero)
    s_one = A + B

    three = disc <= 0
    shift = b / 3.0
    t_cubic = [
        torch.where(three, s_tri[0], s_one) - shift,
        torch.where(three, s_tri[1], nan) - shift,
        torch.where(three, s_tri[2], nan) - shift,
    ]

    # quadratic: the stable two-root form
    disc2 = c1 * c1 - 4.0 * c2 * c0
    sq2 = torch.sqrt(torch.clamp(disc2, min=0.0))
    sgn = torch.where(c1 >= 0, one, -one)
    qq = -0.5 * (c1 + sgn * sq2)
    safe2 = torch.where(is_quad, c2, one)
    qq_safe = torch.where(qq != 0, qq, one)
    r1 = qq / safe2
    r2 = torch.where(qq != 0, c0 / qq_safe, zero)
    ok2 = disc2 >= 0
    t_quad = [torch.where(ok2, r1, nan), torch.where(ok2, r2, nan), nan]

    # linear
    t_lin = [-c0 / torch.where(is_lin, c1, one), nan, nan]

    roots = torch.stack([
        torch.where(is_cubic, t_cubic[k],
                    torch.where(is_quad, t_quad[k], torch.where(is_lin, t_lin[k], nan)))
        for k in range(3)
    ], dim=-1)

    # Newton polish on the original coefficients
    e0, e1, e2, e3 = (v[..., None] for v in (c0, c1, c2, c3))
    for _ in range(newton):
        f = ((e3 * roots + e2) * roots + e1) * roots + e0
        fp = (3.0 * e3 * roots + 2.0 * e2) * roots + e1
        upd = f / torch.where(fp != 0, fp, torch.ones_like(fp))
        roots = torch.where(torch.isfinite(upd), roots - upd, roots)
    return roots


def interval_roots_to_x(x, t_roots, *, extrapolate: bool = False):
    """Collect per-interval local roots into one sorted global root vector.

    ``x``: ``(n,)`` knots; ``t_roots``: ``(n-1, *trailing, 3)`` local roots
    from :func:`real_cubic_roots`.  Accepts roots in the half-open window
    ``[0, 1)`` (closed at the top for the last interval, so a root at the
    final knot is kept once); with ``extrapolate`` the first and last
    windows open toward ±∞.  Maps to ``x``, sorts ascending with the NaN
    padding last, and merges duplicates closer than the tolerance (a root at
    a shared knot is reported by both neighbours).

    Returns ``(3*(n-1), *trailing)``."""
    n1 = t_roots.shape[0]
    t = t_roots
    dtype = t.dtype
    xl = x[:-1].to(dtype)
    dx = (x[1:] - x[:-1]).to(dtype)
    span = (x[-1] - x[0]).abs().to(dtype)

    expand = (n1,) + (1,) * (t.ndim - 1)
    pos = torch.arange(n1, device=t.device).reshape(expand)
    lo_open = (pos == 0) & extrapolate
    hi_open = (pos == n1 - 1) & extrapolate
    last = pos == n1 - 1
    acc_lo = lo_open | (t >= -_EDGE_TOL)
    # interior intervals are half-open at the top: a knot root belongs to the
    # right interval; the final knot's root belongs to the last one
    acc_hi = hi_open | torch.where(last, t <= 1.0 + _EDGE_TOL, t < 1.0 - _EDGE_TOL)
    acc = acc_lo & acc_hi & torch.isfinite(t)

    # clamp interior-window roots into [0, 1] so accepted knot roots map
    # exactly onto the knot; the extrapolating edge windows stay unclamped
    t = torch.where(lo_open, t, torch.clamp(t, min=0.0))
    t = torch.where(hi_open, t, torch.clamp(t, max=1.0))

    xr = xl.reshape(expand) + t * dx.reshape(expand)
    xr = torch.where(acc, xr, torch.full_like(xr, math.nan))

    flat = torch.movedim(xr, -1, 1).reshape((3 * n1,) + tuple(t_roots.shape[1:-1]))
    flat = torch.sort(flat, dim=0).values  # NaN sorts last
    if n1 > 0:
        tol = span * (10 * _EDGE_TOL)
        dup = (flat[1:] - flat[:-1]).abs() <= tol
        flat = torch.cat([flat[:1], torch.where(dup, torch.full_like(flat[1:], math.nan),
                                                flat[1:])], dim=0)
        flat = torch.sort(flat, dim=0).values
    return flat
