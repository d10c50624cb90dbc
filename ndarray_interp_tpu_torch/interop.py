"""State carried across from the JAX package.

:func:`interp1d_from_numpy`, :func:`interp2d_from_numpy` and
:func:`interpnd_from_numpy` turn the state of an ``ndarray_interp_tpu``
interpolator — its arrays taken with ``np.asarray`` — into this package's
:class:`Interp1D`, :class:`Interp2D` or :class:`InterpND`, so that both
compute the same function, without a new solve::

    itp_jax = ...  # ndarray_interp_tpu.interp1d.Interp1D, CubicSpline
    s = itp_jax.strategy
    itp = interp1d_from_numpy(
        np.asarray(itp_jax.x), np.asarray(itp_jax.data),
        a=np.asarray(s.a), b=np.asarray(s.b), mode=s.mode, device="cuda",
    )

    itp2_jax = ...  # ndarray_interp_tpu.interp2d.Interp2D, Bicubic
    s = itp2_jax.strategy
    itp2 = interp2d_from_numpy(
        np.asarray(itp2_jax.x), np.asarray(itp2_jax.y), np.asarray(itp2_jax.data),
        strategy="bicubic", extrapolate=s.extrapolates, bc_x=s.bc_x, bc_y=s.bc_y,
        rows=np.asarray(s.rows), layout=s.layout, device="cuda",
    )

    step_jax = ...  # ndarray_interp_tpu.interp1d.Interp1D, Nearest
    s = step_jax.strategy
    step = interp1d_from_numpy(
        np.asarray(step_jax.x), np.asarray(step_jax.data), strategy="nearest",
        nearest_mode=s.mode, mode="yes" if s.extrapolates else "no", device="cuda",
    )

    nd_jax = ...  # ndarray_interp_tpu.interpnd.InterpND
    nd = interpnd_from_numpy(
        [np.asarray(a) for a in nd_jax.axes], np.asarray(nd_jax.data),
        method=nd_jax.method, extrapolate=nd_jax.extrapolates,
        table=None if nd_jax.table is None else np.asarray(nd_jax.table),
        bcs=nd_jax.bcs, layout=nd_jax.layout, device="cuda",
    )

No JAX object crosses: only numpy arrays, strings and flags.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.interp1d import Interp1D
from .models.interp2d import Interp2D
from .models.interpnd import InterpND
from .models.strategies.bicubic import BicubicStrategy
from .models.strategies.bilinear import Bilinear, BilinearPacked
from .models.strategies.cubic import CubicSplineStrategy
from .models.strategies.linear import Linear
from .models.strategies.step import Nearest, Nearest2D
from .utils.device import default_device

_MODES = ("no", "yes", "periodic")


def interp1d_from_numpy(
    x, data, a=None, b=None, mode="no", strategy=None, device=None, nearest_mode="nearest"
) -> Interp1D:
    """Build an :class:`Interp1D` from carried-over state, without
    validation or a new solve (``Interp1D.new_unchecked``).

    Args:
      x: (n,) knot axis.
      data: (n, *trailing) data.
      a, b: (n-1, *trailing) cubic coefficient banks (``CubicSplineStrategy.a/.b``).
      mode: extrapolation mode, ``"no"``, ``"yes"`` or (cubic only)
        ``"periodic"``; for ``Linear`` and ``Nearest``, ``"yes"`` means
        ``extrapolate(True)``.
      strategy: ``"linear"``, ``"cubic_spline"`` or ``"nearest"``; default
        ``"cubic_spline"`` when ``a`` is given, else ``"linear"``.
      device: where the tensors go (default: the GPU; without one this
        raises unless ``device="cpu"`` is named).
      nearest_mode: ``Nearest.mode`` for ``strategy="nearest"``.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if strategy is None:
        strategy = "linear" if a is None else "cubic_spline"
    device = default_device(x, device)

    def t(v):
        return torch.tensor(np.asarray(v), device=device)  # copies

    x_t, data_t = t(x), t(data)
    if strategy in ("linear", "nearest") and mode == "periodic":
        raise ValueError(f"{strategy.capitalize()} has no periodic mode")
    if strategy == "linear":
        strat = Linear(extrapolate=(mode == "yes"))
    elif strategy == "nearest":
        strat = Nearest(nearest_mode, extrapolate=(mode == "yes"))
    elif strategy == "cubic_spline":
        if a is None or b is None:
            raise ValueError("cubic_spline state needs both a and b")
        strat = CubicSplineStrategy(t(a), t(b), mode)
    else:
        raise ValueError(
            f"strategy must be 'linear', 'cubic_spline' or 'nearest', got {strategy!r}"
        )
    return Interp1D.new_unchecked(x_t, data_t, strat)


def interp2d_from_numpy(
    x, y, data, strategy=None, extrapolate=False, bc_x="not_a_knot",
    bc_y="not_a_knot", rows=None, layout=None, device=None,
) -> Interp2D:
    """Build an :class:`Interp2D` from carried-over state, without
    validation or a new solve (``Interp2D.new_unchecked``).

    Args:
      x, y: (nx,) and (ny,) axes.
      data: (nx, ny, *trailing) data.
      strategy: ``"bilinear"``, ``"bicubic"`` or ``"nearest"``
        (``Nearest2D``); default ``"bicubic"`` when ``layout`` is given, else
        ``"bilinear"``.
      extrapolate: the strategy's ``extrapolates`` flag.
      bc_x, bc_y: the bicubic boundary kinds (``BicubicStrategy.bc_x/bc_y``).
      rows: the packed table: ``BicubicStrategy.rows`` (required for
        bicubic) or ``BilinearPacked.rows`` (optional for bilinear).
      layout: ``BicubicStrategy.layout``, ``"cell"`` or ``"node"``.
      device: where the tensors go (default: the GPU; without one this
        raises unless ``device="cpu"`` is named).
    """
    if strategy is None:
        strategy = "bilinear" if layout is None else "bicubic"
    device = default_device(x, device)

    def t(v):
        return torch.tensor(np.asarray(v), device=device)  # copies

    if strategy == "bilinear":
        strat = (
            Bilinear(extrapolate) if rows is None else BilinearPacked(t(rows), extrapolate)
        )
    elif strategy == "bicubic":
        if rows is None or layout is None:
            raise ValueError("bicubic state needs both rows and layout")
        strat = BicubicStrategy(t(rows), extrapolate, bc_x, bc_y, layout)
    elif strategy == "nearest":
        strat = Nearest2D(extrapolate)
    else:
        raise ValueError(
            f"strategy must be 'bilinear', 'bicubic' or 'nearest', got {strategy!r}"
        )
    return Interp2D.new_unchecked(t(x), t(y), t(data), strat)


def interpnd_from_numpy(
    axes, data, method="linear", extrapolate=False, table=None, bcs=None, layout=None,
    device=None,
) -> InterpND:
    """Build an :class:`InterpND` from carried-over state, without
    validation or a new solve (``InterpND.new_unchecked``).

    Args:
      axes: the ``k`` axes, ``(n_d,)`` each.
      data: ``(n_0, ..., n_{k-1}, *trailing)`` data.
      method: ``"linear"``, ``"nearest"`` or ``"cubic"``.
      extrapolate: the ``extrapolates`` flag.
      table: the packed table (``InterpND.table``): required for cubic,
        optional for linear (``None``: the unpacked route).
      bcs: the per-axis boundary kinds (``InterpND.bcs``; cubic).
      layout: ``InterpND.layout``: ``"cell"``, ``"node"``, ``"node2"`` or
        ``"node4"`` (cubic).
      device: where the tensors go (default: the GPU; without one this
        raises unless ``device="cpu"`` is named).
    """
    if method not in ("linear", "nearest", "cubic"):
        raise ValueError(f"method must be 'linear', 'nearest' or 'cubic', got {method!r}")
    if method == "cubic" and (table is None or layout is None):
        raise ValueError("cubic state needs both table and layout")
    device = default_device(data, device)

    def t(v):
        return torch.tensor(np.asarray(v), device=device)  # copies

    return InterpND.new_unchecked(
        [t(a) for a in axes], t(data), method, extrapolate,
        None if table is None else t(table), bcs, layout,
    )
