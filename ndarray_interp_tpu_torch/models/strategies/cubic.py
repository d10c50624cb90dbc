"""Cubic-spline interpolation strategy.

Counterpart of ``ndarray_interp_tpu.models.strategies.cubic``: build, eval
and calculus.  Reference:
``src/interp1d/strategies/cubic_spline.rs``.  A C² cubic spline
parameterized by knot derivatives ``k`` obtained from a tridiagonal system,
with four boundary-condition families plus per-row/per-side mixing:

* 3-level boundary hierarchy (``cubic_spline.rs:104-217``):
  ``BoundaryCondition{NotAKnot, Natural, Clamped, Periodic, Individual}``,
  ``RowBoundary{NotAKnot, Natural, Clamped, Mixed{left,right}}``,
  ``SingleBoundary{NotAKnot, Natural, Clamped, FirstDeriv, SecondDeriv}``,
  with ``Natural ≡ SecondDeriv(0)`` and ``Clamped ≡ FirstDeriv(0)``.
* Special cases: NotAKnot with exactly 3 points → parabola system; Periodic
  with 3 points → closed form; Periodic general → condensed (n-1) system,
  two Thomas solves and a Sherman–Morrison-style correction.
* Eval: the symmetric Hermite form
  ``y = (1-t)·y_l + t·y_r + t(1-t)(a(1-t) + b t)`` (``:818-828``), with
  periodic wrap ``x = (x-x0).rem_euclid(xn-x0) + x0`` (``:804-809``).

One batched solve builds the whole spline bank: per-row boundaries become
kind/value arrays selected with ``torch.where``, the diagonals become
batched, and one Thomas solve (``thomas_solve_fast``: the plain loop on the
CPU, the Thomas kernel on the GPU) solves every row at once.  On the card a
wide float32 not-a-knot bank takes the dense-operator build (the build probed
once on an identity bank, then one matrix product) where ``_dense_build_ok``
says it measured faster, as the JAX package does on the TPU.

Eval routes, the JAX package's dispatch (``cubic.py:726-888`` there):

* scalar data → ``fused_eval_1d`` (K1), or ``big_eval_1d`` (R3) for
  float32 data on 65,536 < n <= ``MAX_BIG_KNOTS`` knots;
* bank data → ``(idx, t)`` from ``fused_index_frac`` (K2), or from
  ``big_lower_index_frac`` (R3idx) for float32 on 65,536 < n <=
  ``MAX_BIG_KNOTS``; then ``banked_eval`` (K5) for short knot axes × wide
  float32 banks where the JAX cost model prefers it, else the packed-row
  route (``ops.bank_tail``, R2a).

Calculus (SciPy ``CubicSpline`` parity, no reference analogue):
``eval_derivative`` (orders 1-3), ``eval_integrate`` (exact per-interval
quadrature) and ``eval_solve`` (closed-form roots, ``ops/cubicroots.py``).
The first two search their intervals with ``lower_index_fast`` (K3 on the
GPU) and gather one row a query, as the JAX package does
(``cubic.py:891-1031`` there).  ``Akima``, ``Makima`` and ``Pchip`` build
this strategy and share them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...errors import BuilderValueError, ShapeError
from ...ops.bank_eval import banked_eval, can_use_banked
from ...ops.bank_tail import gathered_bank_eval
from ...ops.bigknots import MAX_BIG_KNOTS, big_eval_1d, big_lower_index_frac, can_use_big
from ...ops.cubicroots import interval_roots_to_x, real_cubic_roots
from ...ops.eval_kernels import fused_eval_1d, fused_index_frac, make_interval_table
from ...ops.gather import gather_rows
from ...ops.searchsorted import lower_index_fast
from ...ops.thomas_kernel import thomas_solve_fast
from .base import Interp1DStrategy, Interp1DStrategyBuilder

# specialized boundary kinds (SingleBoundary after `specialize`,
# cubic_spline.rs:287-296)
_NOT_A_KNOT = 0
_FIRST_DERIV = 1
_SECOND_DERIV = 2


# ---------------------------------------------------------------------------
# boundary-condition hierarchy (public API)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SingleBoundary:
    """Boundary condition for one side of one data row
    (``cubic_spline.rs:204-217``)."""

    kind: str  # not_a_knot | natural | clamped | first_deriv | second_deriv
    value: float = 0.0

    @staticmethod
    def FirstDeriv(value) -> "SingleBoundary":
        return SingleBoundary("first_deriv", float(value))

    @staticmethod
    def SecondDeriv(value) -> "SingleBoundary":
        return SingleBoundary("second_deriv", float(value))

    def _specialized(self) -> tuple[int, float]:
        # Natural ≡ SecondDeriv(0), Clamped ≡ FirstDeriv(0)  (:287-296)
        if self.kind == "not_a_knot":
            return (_NOT_A_KNOT, 0.0)
        if self.kind == "natural":
            return (_SECOND_DERIV, 0.0)
        if self.kind == "clamped":
            return (_FIRST_DERIV, 0.0)
        if self.kind == "first_deriv":
            return (_FIRST_DERIV, self.value)
        if self.kind == "second_deriv":
            return (_SECOND_DERIV, self.value)
        raise ValueError(f"unknown SingleBoundary kind {self.kind!r}")


SingleBoundary.NotAKnot = SingleBoundary("not_a_knot")
SingleBoundary.Natural = SingleBoundary("natural")
SingleBoundary.Clamped = SingleBoundary("clamped")


@dataclass(frozen=True)
class RowBoundary:
    """Boundary condition for a single data row (``cubic_spline.rs:171-184``)."""

    left: SingleBoundary
    right: SingleBoundary

    @staticmethod
    def Mixed(left: SingleBoundary, right: SingleBoundary) -> "RowBoundary":
        return RowBoundary(left, right)


RowBoundary.NotAKnot = RowBoundary(SingleBoundary.NotAKnot, SingleBoundary.NotAKnot)
RowBoundary.Natural = RowBoundary(SingleBoundary.Natural, SingleBoundary.Natural)
RowBoundary.Clamped = RowBoundary(SingleBoundary.Clamped, SingleBoundary.Clamped)


class BoundaryCondition:
    """Top-level boundary condition (``cubic_spline.rs:153-168``).

    Use the class constants ``NotAKnot`` / ``Natural`` / ``Clamped`` /
    ``Periodic``, ``BoundaryCondition.Individual(rows)`` where ``rows`` is an
    object array of :class:`RowBoundary` with shape = data shape with axis 0
    of length 1 (``cubic_spline.rs:332-340``), or
    ``BoundaryCondition.IndividualArrays(...)``.
    """

    def __init__(self, kind: str, rows=None, arrays=None):
        self.kind = kind
        self.rows = rows
        self.arrays = arrays

    @staticmethod
    def Individual(rows) -> "BoundaryCondition":
        rows = np.asarray(rows, dtype=object)
        return BoundaryCondition("individual", rows)

    @staticmethod
    def IndividualArrays(
        left_kind, left_value, right_kind, right_value
    ) -> "BoundaryCondition":
        """Per-row boundaries as kind/value arrays (numpy arrays or tensors).

        Kind codes (the specialized ``SingleBoundary`` encoding,
        ``cubic_spline.rs:287-296``): ``0`` = not-a-knot, ``1`` =
        first-derivative (Clamped ≡ ``FirstDeriv(0)``), ``2`` =
        second-derivative (Natural ≡ ``SecondDeriv(0)``).  All four arrays
        must have shape ``data.shape[1:]``; kind arrays are integers, value
        arrays are the derivative payloads (a value tensor that requires
        grad carries its gradient through the build).
        """
        return BoundaryCondition(
            "individual_arrays",
            arrays=(left_kind, left_value, right_kind, right_value),
        )

    def __repr__(self):
        return f"BoundaryCondition({self.kind})"


BoundaryCondition.NotAKnot = BoundaryCondition("not_a_knot")
BoundaryCondition.Natural = BoundaryCondition("natural")
BoundaryCondition.Clamped = BoundaryCondition("clamped")
BoundaryCondition.Periodic = BoundaryCondition("periodic")


def _compile_rows(rows: np.ndarray):
    """Lower an object array of RowBoundary into four numeric arrays
    (left kind/value, right kind/value) — the batched encoding replacing
    the reference's per-row recursion."""
    lk = np.zeros(rows.shape, np.int32)
    lv = np.zeros(rows.shape, np.float64)
    rk = np.zeros(rows.shape, np.int32)
    rv = np.zeros(rows.shape, np.float64)
    for idx in np.ndindex(rows.shape):
        rb = rows[idx]
        if not isinstance(rb, RowBoundary):
            raise TypeError(
                "BoundaryCondition.Individual expects RowBoundary entries, "
                f"got {type(rb).__name__}"
            )
        lk[idx], lv[idx] = rb.left._specialized()
        rk[idx], rv[idx] = rb.right._specialized()
    return lk, lv, rk, rv


# ---------------------------------------------------------------------------
# system assembly + solve
# ---------------------------------------------------------------------------
def _solve_for_k(x, y, left_kind, left_val, right_kind, right_val):
    """Assemble and solve ``A k = rhs`` for the knot derivatives.

    ``left_kind``/``right_kind`` are specialized kind codes — scalars for a
    uniform boundary, or arrays of shape ``y.shape[1:]`` for per-row
    (``Individual``) boundaries.  Mirrors ``solve_for_k``
    (``cubic_spline.rs:409-674``) with the boundary `match` replaced by
    batched selection.
    """
    return thomas_solve_fast(
        *_assemble_system(x, y, left_kind, left_val, right_kind, right_val)
    )


def _assemble_system(x, y, left_kind, left_val, right_kind, right_val):
    """The tridiagonal system of :func:`_solve_for_k`:
    ``(a_up, a_mid, a_low, rhs)``, diagonals ``(n,)`` for uniform boundaries
    and shaped like ``rhs`` (``y.shape``) for per-row ones."""
    n = x.shape[0]
    trailing = tuple(y.shape[1:])
    tr = len(trailing)
    dtype, device = y.dtype, y.device

    def ex(v):  # expand a knot-axis quantity over trailing dims
        return v.reshape((-1,) + (1,) * tr)

    def where(cond, a, b):
        return torch.where(cond, a, b)

    dx = x[1:] - x[:-1]  # (n-1,)
    dx0, dx1 = dx[0], dx[1]
    dx_1, dx_2 = dx[n - 2], dx[n - 3]

    lk = torch.as_tensor(left_kind, device=device)
    rk = torch.as_tensor(right_kind, device=device)
    lv = torch.as_tensor(left_val, dtype=dtype, device=device)
    rv = torch.as_tensor(right_val, dtype=dtype, device=device)
    batched = lk.ndim > 0 or rk.ndim > 0

    # ---- interior rows (cubic_spline.rs:440-471) -------------------------
    # a_up[i] = dx[i-1], a_mid[i] = 2(dx[i]+dx[i-1]), a_low[i] = dx[i]
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    a_up_in = dx[:-1]
    a_mid_in = 2.0 * (dx[1:] + dx[:-1])
    a_low_in = dx[1:]

    dxn = ex(dx[1:])  # dx[i]   for i = 1..n-2
    dxn_1 = ex(dx[:-1])  # dx[i-1] for i = 1..n-2
    rhs_interior = 3.0 * (
        dxn * (y[1:-1] - y[:-2]) / dxn_1 + dxn_1 * (y[2:] - y[1:-1]) / dxn
    )  # (n-2, *trailing)

    # ---- boundary-row candidates ----------------------------------------
    y0, y1, y2 = y[0], y[1], y[2]
    y_1, y_2, y_3 = y[n - 1], y[n - 2], y[n - 3]
    slope0 = (y1 - y0) / dx0

    both_nak3 = (lk == _NOT_A_KNOT) & (rk == _NOT_A_KNOT)
    if n != 3:
        both_nak3 = torch.zeros_like(both_nak3)

    # left row (cubic_spline.rs:598-631; parabola :584-592)
    d_l = x[2] - x[0]
    tmp1_l = (dx0 + 2.0 * d_l) * dx1
    nak_rhs0 = (tmp1_l * (y1 - y0) / dx0 + dx0 * dx0 * (y2 - y1) / dx1) / d_l
    sd_rhs0 = 3.0 * (y1 - y0) - lv * dx0 * dx0 / 2.0

    am0 = where(
        both_nak3,
        one,
        where(lk == _NOT_A_KNOT, dx1, where(lk == _FIRST_DERIV, one, 2.0 * dx0)),
    )
    au0 = where(
        both_nak3,
        one,
        where(lk == _NOT_A_KNOT, d_l, where(lk == _FIRST_DERIV, zero, dx0)),
    )
    rhs0 = where(
        both_nak3,
        2.0 * slope0,
        where(
            lk == _NOT_A_KNOT,
            nak_rhs0,
            where(lk == _FIRST_DERIV, lv, sd_rhs0),
        ),
    )

    # right row (cubic_spline.rs:633-668; parabola :589-595)
    d_r = x[n - 1] - x[n - 3]
    tmp1_r = (2.0 * d_r + dx_1) * dx_2
    nak_rhsn = (
        dx_1 * dx_1 * (y_2 - y_3) / dx_2 + tmp1_r * (y_1 - y_2) / dx_1
    ) / d_r
    sd_rhsn = 3.0 * (y_1 - y_2) + rv * dx_1 * dx_1 / 2.0
    slope_last = (y_1 - y_2) / dx_1  # == slope1 when n == 3

    # The right-NAK diagonal is dx_2 (the second-to-last interval), as in
    # SciPy.  The reference writes dx_1 here (cubic_spline.rs:635), a latent
    # bug that its tests, with right-NAK only on uniform axes, cannot see.
    amn = where(
        both_nak3,
        one,
        where(rk == _NOT_A_KNOT, dx_2, where(rk == _FIRST_DERIV, one, 2.0 * dx_1)),
    )
    aln = where(
        both_nak3,
        one,
        where(rk == _NOT_A_KNOT, d_r, where(rk == _FIRST_DERIV, zero, dx_1)),
    )
    rhsn = where(
        both_nak3,
        2.0 * slope_last,
        where(
            rk == _NOT_A_KNOT,
            nak_rhsn,
            where(rk == _FIRST_DERIV, rv, sd_rhsn),
        ),
    )

    rhs = torch.cat(
        [rhs0.expand(trailing)[None], rhs_interior, rhsn.expand(trailing)[None]]
    )

    if batched:
        # per-column diagonals: fixed interior rows, per-column boundary rows
        def brow(v):
            return v.expand(trailing)[None]

        def interior(v):
            return ex(v).expand((n - 2,) + trailing)

        a_up = torch.cat([brow(au0), interior(a_up_in), brow(zero)])
        a_mid = torch.cat([brow(am0), interior(a_mid_in), brow(amn)])
        a_low = torch.cat([brow(zero), interior(a_low_in), brow(aln)])
    else:
        a_up = torch.cat([au0[None], a_up_in, zero[None]])
        a_mid = torch.cat([am0[None], a_mid_in, amn[None]])
        a_low = torch.cat([zero[None], a_low_in, aln[None]])

    return a_up, a_mid, a_low, rhs


def _validate_periodic_data(y):
    """Eager first==last check for the periodic family
    (``cubic_spline.rs:483-489``); one copy to the host on the GPU."""
    y0_host = y[0].detach().cpu().numpy()
    ylast_host = y[y.shape[0] - 1].detach().cpu().numpy()
    if not np.array_equal(y0_host, ylast_host):
        raise BuilderValueError(
            "for periodic boundary condition the first and last value "
            f"must be equal. First: {y0_host}, last: {ylast_host}"
        )


def _solve_periodic_core(x, y):
    """Periodic boundary: condensed solve (``cubic_spline.rs:480-565``)."""
    n = x.shape[0]
    trailing = tuple(y.shape[1:])
    tr = len(trailing)
    dtype, device = y.dtype, y.device

    def ex(v):
        return v.reshape((-1,) + (1,) * tr)

    dx = x[1:] - x[:-1]
    dx0 = dx[0]
    one = torch.ones((), dtype=dtype, device=device)

    if n == 3:
        # closed form (cubic_spline.rs:480-496)
        dx1 = dx[1]
        slope0 = (y[1] - y[0]) / dx0
        slope1 = (y[2] - y[1]) / dx1
        k_val = (slope0 / dx0 + slope1 / dx1) / (one / dx0 + one / dx1)
        return k_val[None].expand((3,) + trailing).to(dtype)

    dx_1 = dx[n - 2]
    dx_2 = dx[n - 3]
    dx_3 = dx[n - 4]

    # condensed diagonals, length n-2: interior rows 1..n-3 keep
    # a_up[i]=dx[i-1], a_mid[i]=2(dx[i]+dx[i-1]), a_low[i]=dx[i]; row 0 is
    # overwritten per cubic_spline.rs:512-518 and row-0 a_low is unused.
    zero = torch.zeros((), dtype=dtype, device=device)
    a_up = torch.cat([dx_1[None], dx[0 : n - 3]])
    a_mid = torch.cat(
        [(2.0 * (dx_1 + dx0))[None], 2.0 * (dx[1 : n - 2] + dx[0 : n - 3])]
    )
    a_low = torch.cat([zero[None], dx[1 : n - 2]])

    slope0 = (y[1] - y[0]) / dx0
    slope_1 = (y[n - 1] - y[n - 2]) / dx_1
    slope_2 = (y[n - 2] - y[n - 3]) / dx_2

    # rhs rows 0..n-2 (length n-1): row 0 and row n-2 overwritten
    dxn = ex(dx[1 : n - 2])
    dxn_1 = ex(dx[0 : n - 3])
    rhs_interior = 3.0 * (
        dxn * (y[1 : n - 2] - y[0 : n - 3]) / dxn_1
        + dxn_1 * (y[2 : n - 1] - y[1 : n - 2]) / dxn
    )  # rows 1..n-3
    rhs_0 = (slope_1 * dx0 + slope0 * dx_1) * 3.0
    rhs_m2 = (slope_2 * dx_1 + slope_1 * dx_2) * 3.0
    rhs_full = torch.cat([rhs_0[None], rhs_interior, rhs_m2[None]])  # (n-1, ...)

    rhs1 = rhs_full[: n - 2]
    rhs2 = torch.zeros((n - 2,) + trailing, dtype=dtype, device=device)
    rhs2[0] = -dx0
    rhs2[n - 3] = -dx_3

    k1 = thomas_solve_fast(a_up, a_mid, a_low, rhs1)
    k2 = thomas_solve_fast(a_up, a_mid, a_low, rhs2)

    k_m1 = (rhs_full[n - 2] - k1[0] * dx_2 - k1[n - 3] * dx_1) / (
        k2[0] * dx_2 + k2[n - 3] * dx_1 + 2.0 * (dx_1 + dx_2)
    )

    k_head = k1 + k_m1 * k2  # rows 0..n-3
    return torch.cat([k_head, k_m1[None], k_head[0][None]])


def _ab_from_k(x, data, k):
    """Per-interval coefficients from knot derivatives
    (``cubic_spline.rs:350-367``)."""
    dx = (x[1:] - x[:-1]).reshape((-1,) + (1,) * (data.ndim - 1))
    dy = data[1:] - data[:-1]
    c_a = k[:-1] * dx - dy
    c_b = dy - k[1:] * dx
    return c_a, c_b


# ---------------------------------------------------------------------------
# dense-operator build (the wide-bank route on the card)
# ---------------------------------------------------------------------------
# For ONE shared knot axis and a uniform boundary family (zero derivative
# payloads: the named families and every per-axis 2-D/N-D solve) the whole
# build is LINEAR in the bank: the rhs assembly (cubic_spline.rs:456-471 and
# each boundary row with payload 0), the tridiagonal solve, the periodic
# condensed solve with its correction (rhs2 and the correction's denominator
# depend on x only) and the (a, b) pass.  So the operator is probed once on
# an identity bank (an (n, n) solve) and applied to the bank as one matrix
# product.  Results differ from the reference order by rounding only; a CPU
# tensor never takes this route, so CPU builds stay bit for bit the
# reference-order loop (cubic_spline.rs:678-721).


def _dense_matmul(op, y):
    """Apply a probed ``(m, n)`` build operator to a ``(n, *trailing)``
    bank: ``torch.matmul``, as the JAX package's ``dot_general`` at
    ``Precision.HIGHEST``.  A float32 product runs in float64 and is rounded
    once: cuBLAS's float64 product never takes TF32, so the result is full
    float32 (and the same bits) whatever the process-wide TF32 setting
    (``torch.set_float32_matmul_precision``,
    ``torch.backends.cuda.matmul.allow_tf32``), and no global flag is
    touched."""
    flat = y.reshape(y.shape[0], -1)
    out = torch.matmul(op.to(torch.float64), flat.to(torch.float64)).to(y.dtype)
    return out.reshape((op.shape[0],) + tuple(y.shape[1:]))


def _probe(x, n, dtype, kind, periodic):
    """The knot-derivative solve of an identity bank: ``K`` with ``k = K @ y``."""
    eye = torch.eye(n, dtype=dtype, device=x.device)
    if periodic:
        return eye, _solve_periodic_core(x, eye)
    return eye, _solve_for_k(x, eye, kind, 0.0, kind, 0.0)


def _dense_k(x, y, kind, periodic):
    """The knot-derivative solve as a probed dense operator: ``k = K @ y``."""
    _, k_op = _probe(x, x.shape[0], y.dtype, kind, periodic)
    return _dense_matmul(k_op, y)


def _dense_ab(x, y, kind, periodic):
    """The whole build as one probed operator: ``(a; b) = F @ y``, the
    k-solve composed with ``_ab_from_k`` (linear in ``(k, y)`` too), so the
    bank is read once and no ``(n, bank)`` intermediate is made."""
    n = x.shape[0]
    eye, k_cols = _probe(x, n, y.dtype, kind, periodic)
    a_cols, b_cols = _ab_from_k(x, eye, k_cols)
    ab = _dense_matmul(torch.cat([a_cols, b_cols]), y)  # (2(n-1), *trailing)
    return ab[: n - 1], ab[n - 1 :]


def _periodic_ab(x, y):
    """The periodic build map on the solver (the non-dense route)."""
    return _ab_from_k(x, y, _solve_periodic_core(x, y))


def _uniform_ab(x, y, kind):
    """The uniform-boundary build map on the solver (the non-dense route)."""
    return _ab_from_k(x, y, _solve_for_k(x, y, kind, 0.0, kind, 0.0))


# the smallest bank, in elements (knots x splines), that takes the dense build
_DENSE_MIN_ELEMS = 1 << 25


def _dense_build_ok(n, trailing_size, y, bc_kind):
    """Whether a build of ``n`` knots and ``trailing_size`` splines on the
    tensor ``y`` with the boundary family ``bc_kind`` takes the dense route:
    a float32 CUDA tensor, the not-a-knot family,
    ``n <= config.dense_build_max_n`` (64) and a bank of at least
    ``_DENSE_MIN_ELEMS`` (2^25) values.  A CPU tensor never does.

    The rule covers what ``chip_smoke.py``'s build-route phase measures, the
    float32 not-a-knot build; float64 banks and the other families keep the
    Thomas kernel until it measures them.  Its numbers, from one run of the
    phase (NVIDIA H100 80GB HBM3, 700.00 W; the public build with the dense
    route forced on and forced off, in turns; host wall, median [min, max] of
    14 runs, and device busy, ms): the dense build won beyond the spread only
    at 64 x 1,000,000 (NS5b: 3.18 [3.08, 3.36] against 3.81 [3.70, 5.79];
    busy 1.60 against 3.24).  It tied at 256 x 262,144 (4.20 [3.77, 4.73]
    against 4.06 [3.91, 4.56]; busy 2.39 against 3.45) and at 256 x 16,384
    (1.90 [1.73, 2.19] against 2.07 [1.43, 3.87]), and lost at 64 x 262,144
    (3.04 against 2.71), 64 x 65,536 (2.61 against 2.45), 512 x 8,192 (2.81
    against 2.47), 2,048 x 4,096 (4.20 against 2.60) and 10,000 x 64 (10.08
    against 2.80).  ``_dense_k`` lost in the same run at the per-axis solves
    of NS3b's ``Bicubic`` (512 x 8,192: 1.68 against 1.48, busy 0.38 against
    0.28) and ND2's cubic (64 x 4,096: 2.06 against 1.92), so
    ``bicubic._solve_axis0`` keeps the Thomas kernel."""
    from ... import config

    return (
        y.device.type == "cuda"
        and y.dtype == torch.float32
        and bc_kind == "not_a_knot"
        and n <= config.dense_build_max_n
        and n * trailing_size >= _DENSE_MIN_ELEMS
    )


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# strategy builder + finished strategy
# ---------------------------------------------------------------------------
class CubicSpline(Interp1DStrategyBuilder):
    """Cubic-spline strategy builder (``cubic_spline.rs:84-88, 723-741``)::

        CubicSpline()
        CubicSpline().extrapolate(True)
        CubicSpline().boundary(BoundaryCondition.Periodic)
    """

    MINIMUM_DATA_LENGTH = 3  # cubic_spline.rs:751

    def __init__(self, extrapolate: bool = False, boundary=None):
        self.extrapolates = bool(extrapolate)
        self._boundary = (
            boundary if boundary is not None else BoundaryCondition.NotAKnot
        )

    def extrapolate(self, yes: bool = True) -> "CubicSpline":
        return CubicSpline(extrapolate=yes, boundary=self._boundary)

    def boundary(self, bc: BoundaryCondition) -> "CubicSpline":
        return CubicSpline(extrapolate=self.extrapolates, boundary=bc)

    # -- build (cubic_spline.rs:754-771) ------------------------------------
    def build(self, x, data) -> "CubicSplineStrategy":
        if not (data.is_floating_point() or data.is_complex()):
            raise TypeError(
                "CubicSpline requires a floating-point dtype; got "
                f"{_dtype_name(data.dtype)}"
            )
        a, b = self._calc_coefficients(x, data)
        if not self.extrapolates:
            mode = "no"
        elif self._boundary.kind == "periodic":
            mode = "periodic"
        else:
            mode = "yes"
        return CubicSplineStrategy(a, b, mode)

    def _calc_coefficients(self, x, data):
        """Knot-derivative solve + per-interval ``a``/``b``
        (``cubic_spline.rs:310-368``).  A multi-dim bank solves as one
        flattened bank axis and is reshaped back; a bank on the card takes
        the dense-operator build where ``_dense_build_ok`` says it pays."""
        bc = self._boundary
        trailing = tuple(data.shape[1:])
        flat = len(trailing) > 1
        y = data.reshape(data.shape[0], -1) if flat else data
        if bc.kind == "periodic":
            _validate_periodic_data(y)
            c_a, c_b = _periodic_ab(x, y)
        elif bc.kind == "individual":
            expected = (1,) + trailing
            if tuple(bc.rows.shape) != expected:
                raise ShapeError(
                    "Boundary conditions array has wrong shape. "
                    f"Expected: {list(expected)}, got: {list(bc.rows.shape)}"
                )
            lk, lv, rk, rv = _compile_rows(bc.rows.reshape(trailing))
            if flat:
                lk, lv, rk, rv = (v.reshape(-1) for v in (lk, lv, rk, rv))
            c_a, c_b = _ab_from_k(x, y, _solve_for_k(x, y, lk, lv, rk, rv))
        elif bc.kind == "individual_arrays":
            arrays = [
                v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                for v in bc.arrays
            ]
            names = ("left_kind", "left_value", "right_kind", "right_value")
            for name, v in zip(names, arrays):
                if tuple(v.shape) != trailing:
                    raise ShapeError(
                        "Boundary conditions array has wrong shape. "
                        f"Expected: {list(trailing)}, got: {list(v.shape)} "
                        f"({name})"
                    )
            if flat:
                arrays = [v.reshape(-1) for v in arrays]
            c_a, c_b = _ab_from_k(x, y, _solve_for_k(x, y, *arrays))
        else:
            kind = {
                "not_a_knot": _NOT_A_KNOT,
                "natural": _SECOND_DERIV,
                "clamped": _FIRST_DERIV,
            }[bc.kind]
            dense = _dense_build_ok(x.shape[0], y.shape[1] if y.ndim == 2 else 0, y, bc.kind)
            c_a, c_b = _dense_ab(x, y, kind, False) if dense else _uniform_ab(x, y, kind)

        if flat:
            c_a = c_a.reshape((c_a.shape[0],) + trailing)
            c_b = c_b.reshape((c_b.shape[0],) + trailing)
        return c_a, c_b


class CubicSplineStrategy(Interp1DStrategy):
    """Finished cubic-spline strategy (``cubic_spline.rs:90-102``).

    State: per-interval coefficient banks ``a``/``b`` with shape
    ``(n-1, *data.shape[1:])`` and the extrapolation mode
    (``"no"`` | ``"yes"`` | ``"periodic"``).
    """

    def __init__(self, a, b, mode: str = "no"):
        self.a = a
        self.b = b
        self.mode = mode

    @property
    def extrapolates(self) -> bool:
        return self.mode != "no"

    def _wrap(self, x, xq):
        """Periodic mode: queries outside the range wrap into it."""
        if self.mode != "periodic":
            return xq
        x0 = x[0]
        xn = x[x.shape[0] - 1]
        # torch.remainder takes the divisor's sign, like jnp.mod and
        # rem_euclid for the positive period
        wrapped = torch.remainder(xq - x0, xn - x0) + x0
        in_r = (x0 <= xq) & (xq <= xn)
        return torch.where(in_r, xq, wrapped)

    def eval(self, interp, xq):
        x = interp.x
        xq = self._wrap(x, xq)
        data = interp.data
        if data.ndim == 1:
            if xq.dtype == torch.float32 and xq.ndim == 1 and can_use_big(x, data):
                return big_eval_1d(x, data, self.a, self.b, xq)
            return fused_eval_1d(x, make_interval_table(x, data, self.a, self.b), xq)
        return self._eval_bank(interp, xq)

    def _eval_bank(self, interp, xq):
        """Bank data: ``(idx, t)`` from one search pass, then K5 or the
        packed-row route, chosen as the JAX package chooses
        (``cubic.py:761-887`` there: its v5e cost model, kept for parity)."""
        x, data = interp.x, interp.data
        n = data.shape[0]
        f32 = data.dtype == x.dtype == xq.dtype == torch.float32
        if f32 and xq.ndim == 1 and 65536 < n <= MAX_BIG_KNOTS:
            idx, t = big_lower_index_frac(x, xq)
        else:
            idx, t = fused_index_frac(x, xq)
        bank = data[0].numel()
        n_pad = -(-(n - 1) // 128) * 128
        kernel_ns = n_pad * bank * 12 / 197_000.0
        gather_ns = max(6.0, 4 * bank * 4 / 300.0)
        gather_ok = f32 and xq.ndim == 1 and n >= 4 and n <= MAX_BIG_KNOTS
        if can_use_banked(x, data) and (not gather_ok or kernel_ns <= gather_ns):
            out = banked_eval(data, self.a, self.b, idx.reshape(-1), t.reshape(-1))
        else:
            out = gathered_bank_eval(
                data.reshape(n, -1),
                self.a.reshape(n - 1, -1),
                self.b.reshape(n - 1, -1),
                idx,
                t,
            )
        return out.reshape(tuple(xq.shape) + tuple(data.shape[1:]))

    # -- calculus (beyond the reference; SciPy CubicSpline parity) -------------
    def _interval_quantities(self, interp, p):
        """``(idx, dx, t, y_l, y_r, a, b)`` at the flat queries ``p``, shared
        by the derivative and antiderivative forms."""
        data = interp.data
        return _interval_rows(interp, p, data[:-1], data[1:], self.a, self.b)

    def eval_derivative(self, interp, xq, order=1):
        """``d^order y / dx^order`` of the symmetric Hermite form
        ``y = (1-t) y_l + t y_r + t(1-t)[a(1-t) + b t]``, order 1, 2 or 3:
        ``[y_r - y_l + (1-2t)(a(1-t) + b t) + t(1-t)(b-a)] / dx``, then
        ``[a(6t-4) + b(2-6t)] / dx^2`` and ``6(a-b) / dx^3`` (piecewise
        constant).  Periodic mode wraps like ``eval``."""
        if order not in (1, 2, 3):
            raise ValueError(f"derivative order must be 1, 2, or 3; got {order}")
        _, dx, t, y_l, y_r, a, b = self._interval_quantities(interp, self._wrap(interp.x, xq))
        if order == 1:
            return ((y_r - y_l) + (1.0 - 2 * t) * (a * (1.0 - t) + b * t)
                    + t * (1.0 - t) * (b - a)) / dx
        if order == 2:
            return (a * (6 * t - 4) + b * (2 - 6 * t)) / (dx * dx)
        return 6 * (a - b) / (dx * dx * dx)

    def _antideriv(self, interp, p):
        """``F(p)``, the integral from ``x[0]`` to each flat ``p``: the
        cumulative exact interval integrals ``dx·[(y_l+y_r)/2 + (a+b)/12]``
        plus the partial interval ``dx·[y_l(t - t^2/2) + y_r t^2/2 +
        a(t^2/2 - 2t^3/3 + t^4/4) + b(t^3/3 - t^4/4)]``.  Periodic mode: whole
        periods times the total plus the wrapped remainder."""
        x, data = interp.x, interp.data
        tr = data.ndim - 1
        dxk = (x[1:] - x[:-1]).reshape((-1,) + (1,) * tr)
        full = dxk * (0.5 * (data[:-1] + data[1:]) + (self.a + self.b) / 12.0)
        csum = torch.cat([torch.zeros_like(full[:1]), torch.cumsum(full, dim=0)], dim=0)

        def f_in(p):
            idx, dx, t, y_l, y_r, a, b = self._interval_quantities(interp, p)
            t2 = t * t
            t3 = t2 * t
            t4 = t2 * t2
            part = (y_l * (t - 0.5 * t2) + y_r * (0.5 * t2)
                    + a * (0.5 * t2 - 2.0 * t3 / 3.0 + 0.25 * t4) + b * (t3 / 3.0 - 0.25 * t4))
            return csum[idx] + dx * part

        if self.mode == "periodic":
            x0, period = x[0], x[x.shape[0] - 1] - x[0]
            k = torch.floor((p - x0) / period)
            return k.reshape(tuple(p.shape) + (1,) * tr) * csum[-1] + f_in(p - k * period)
        return f_in(p)

    def eval_integrate(self, interp, lo, hi):
        """The integral from ``lo`` to ``hi`` per trailing element (signed:
        ``lo > hi`` negates), exact polynomial quadrature."""
        f = self._antideriv(interp, _bounds(interp, lo, hi))
        return f[1] - f[0]

    def eval_solve(self, interp, y=0.0):
        """Real roots of ``spline(x) - y``: each interval's Hermite form is
        the cubic ``(y_l - y) + (y_r - y_l + a) t + (b - 2a) t^2 + (a - b)
        t^3``, solved in closed form in one batch (``ops/cubicroots.py``):
        ``(3(n-1), *trailing)``, sorted, NaN-padded.  ``y`` is a scalar or
        broadcasts over the trailing dims.  Extrapolating splines ("yes")
        also report roots of the edge polynomials outside the range;
        periodic ones the base-range roots.  A segment identically equal to
        ``y`` contributes its left knot."""
        y_l, y_r, yq = _solve_operands(interp, y)
        a, b = self.a.to(yq.dtype), self.b.to(yq.dtype)
        return _interval_roots(interp, y_l - yq, (y_r - y_l) + a, b - 2.0 * a, a - b,
                               self.mode == "yes")

    def __repr__(self):
        return f"CubicSplineStrategy(a={tuple(self.a.shape)}, mode={self.mode})"


def _interval_rows(interp, p, *columns):
    """``(idx, dx, t, *rows)`` at the flat queries ``p``: the interval search
    (K3 on the GPU), the interval width and fraction, and one gather of the
    interval's row of the stacked ``columns`` (each ``(n-1, *trailing)``)."""
    x = interp.x
    idx = lower_index_fast(x, p).long()
    xg = torch.stack([x[:-1], x[1:]], dim=-1)[idx]
    dx = xg[..., 1] - xg[..., 0]
    t = (p - xg[..., 0]) / dx
    g = gather_rows(torch.stack(columns, dim=-1), idx)
    expand = tuple(p.shape) + (1,) * (interp.data.ndim - 1)
    return (idx, dx.reshape(expand), t.reshape(expand), *g.unbind(-1))


def _scalars(dtype, device, *values):
    """Scalars (numbers or 0-d tensors) as one flat tensor of ``dtype`` on
    ``device``: integration bounds."""
    return torch.stack([torch.as_tensor(v, dtype=dtype, device=device) for v in values])


def _bounds(interp, lo, hi):
    """The integration bounds in the table's dtype, on its device."""
    return _scalars(torch.promote_types(interp.x.dtype, interp.data.dtype), interp.x.device, lo, hi)


def _solve_operands(interp, y):
    """``(y_l, y_r, y)`` of every interval in the solve's dtype (the
    table's, float32 at least)."""
    data = interp.data
    dtype = torch.promote_types(torch.promote_types(interp.x.dtype, data.dtype), torch.float32)
    yq = torch.as_tensor(y, dtype=dtype, device=data.device)
    return data[:-1].to(dtype), data[1:].to(dtype), yq


def _interval_roots(interp, c0, c1, c2, c3, extrapolate):
    """The sorted roots of the interval polynomials ``c0 + c1 t + c2 t^2 +
    c3 t^3``; an identically zero one reports its left knot."""
    t = real_cubic_roots(c0, c1, c2, c3)
    const0 = (c0 == 0) & (c1 == 0) & (c2 == 0) & (c3 == 0)
    t[..., 0] = torch.where(const0, torch.zeros_like(t[..., 0]), t[..., 0])
    return interval_roots_to_x(interp.x.to(t.dtype), t, extrapolate=extrapolate)
