"""Parallel cyclic reduction (PCR) for batched tridiagonal systems.

Counterpart of ``ndarray_interp_tpu.ops.pcr``, which is XLA (no Pallas
kernel) in the JAX package, so plain tensor operations are its faithful
port.  The Thomas recurrence (``thomas.py``, ``cubic_spline.rs:678-721``)
is a chain of ~2n dependent steps along the knot axis; PCR trades it for
``ceil(log2 n)`` levels of independent full-width row combinations::

    level (stride s): row i absorbs rows i-s and i+s with
        alpha_i = -a_i / b_{i-s},  gamma_i = -c_i / b_{i+s}
        a'_i = alpha_i a_{i-s}          (now couples x_{i-2s})
        c'_i = gamma_i c_{i+s}          (now couples x_{i+2s})
        b'_i = b_i + alpha_i c_{i-s} + gamma_i a_{i+s}
        d'_i = d_i + alpha_i d_{i-s} + gamma_i d_{i+s}

with rows outside the matrix taken as identity rows (a = c = d = 0,
b = 1).  After every level all couplings are out of range and
``x = d / b``.  O(n log n) work instead of O(n); with shared diagonals only
the right-hand side pays the log factor.  The spline systems are strictly
diagonally dominant, which PCR preserves, so the elimination is stable; its
results differ from the reference order by rounding only (not bit for bit).

On the card it lost to the Thomas kernel at every shape measured
(``thomas_kernel``'s docstring has the numbers), so no build takes it there;
it is the JAX package's solver, kept as the yardstick of that measurement.
"""

from __future__ import annotations

import math

import torch


def _bview(v, ndim):
    """Trailing singleton dims so a ``(n, *partial)`` factor broadcasts on
    the right-hand side."""
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.ndim))


def _down(v, s, fill):
    """``v_{i-s}``, the first ``s`` rows the identity row's ``fill``."""
    pad = torch.full((s,) + tuple(v.shape[1:]), fill, dtype=v.dtype, device=v.device)
    return torch.cat([pad, v[:-s]])


def _up(v, s, fill):
    """``v_{i+s}``, the last ``s`` rows the identity row's ``fill``."""
    pad = torch.full((s,) + tuple(v.shape[1:]), fill, dtype=v.dtype, device=v.device)
    return torch.cat([v[s:], pad])


def pcr_solve(a_up, a_mid, a_low, rhs):
    """Solve the tridiagonal system ``A k = rhs`` along axis 0 by PCR.

    The interface and convention of :func:`.thomas.thomas_solve`: ``a_low[i]``
    couples row i to i-1 (``a_low[0]`` unused), ``a_up[i]`` row i to i+1
    (``a_up[-1]`` unused); diagonals ``(n,)`` or batched like ``rhs``."""
    n = rhs.shape[0]
    if n == 1:
        return rhs / _bview(a_mid, rhs.ndim)[0]

    # the couplings out of the matrix are zero
    a = torch.cat([torch.zeros_like(a_low[:1]), a_low[1:]]).to(rhs.dtype)
    c = torch.cat([a_up[: n - 1], torch.zeros_like(a_up[:1])]).to(rhs.dtype)
    b = a_mid.to(rhs.dtype)
    d = rhs
    ndim = rhs.ndim

    s = 1
    for _ in range(max(1, math.ceil(math.log2(n)))):
        alpha = -a / _down(b, s, 1.0)
        gamma = -c / _up(b, s, 1.0)
        b = b + alpha * _down(c, s, 0.0) + gamma * _up(a, s, 0.0)
        a, c = alpha * _down(a, s, 0.0), gamma * _up(c, s, 0.0)
        d = d + _bview(alpha, ndim) * _down(d, s, 0.0) + _bview(gamma, ndim) * _up(d, s, 0.0)
        s *= 2
    return d / _bview(b, ndim)
