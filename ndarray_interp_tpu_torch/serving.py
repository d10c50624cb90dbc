"""Serving helpers: bucketed evaluation of variable-length requests.

Counterpart of ``ndarray_interp_tpu.serving``.  :class:`Evaluator`,
:class:`Evaluator2D` and :class:`EvaluatorND` pad each batch of queries up
to a size bucket (powers of two by default) with the first knot(s),
evaluate, and slice the padding off; requests longer than ``max_batch`` are
evaluated in ``max_batch`` chunks.  :class:`DoubleFloatEvaluator`,
:class:`DoubleFloatEvaluator2D` and :class:`DoubleFloatEvaluatorND` serve
float64-grade answers through the double-float kernels K6-K15 and R4c
(``ops/eval_kernels_df.py``, ``ops/eval_kernels_df2d.py``,
``ops/eval_kernels_df_nd.py``).

As in the JAX package, where a ``jax.jit`` program serves each bucket, every
evaluator here evaluates through one ``torch.compile`` program
(``fullgraph=True``: a trace that breaks raises; :func:`compile_program`)
with the kernels as ops of its graph: :class:`Evaluator`,
:class:`Evaluator2D` and :class:`EvaluatorND` the interpolator's
``__call__``; the double-float evaluators the split of the padded float64
queries into pairs, their route and the recombination to float64
(:func:`_df_program`), where the JAX evaluators split and recombine on the
host.  The query axis is dynamic, so the one program serves every bucket:
after ``warmup()`` no call recompiles (the kernels' size-dependent choices,
such as ordering a large batch by cell, are made inside the ops at run
time).  The eager range and NaN checks stay outside the program.  On the
card the program is inductor's; on a CPU interpolator, which only tests use,
the same graph runs on ``aot_eager``.

    ev = Evaluator(interp).warmup()   # compiles, then runs every bucket
    values = ev(queries)              # any length, no recompile
    ev2 = Evaluator2D(interp2d)
    values = ev2(xs, ys)

Not ported: the ``donate`` option (PyTorch has no buffer donation; see
:func:`eval_into_donated`), and ``verify_hygiene``, which guards against
XLA folding big tables into compiled programs, a hazard PyTorch does not
have.
"""

from __future__ import annotations

import bisect
import functools
import math
import types

import torch

from .errors import OutOfBoundsError
from .models.interp1d import _to_tensor
from .models.interpnd import pack_corner_rows_nd
from .models.strategies.bicubic import BicubicStrategy
from .ops.df import df_from_f64, df_to_f64
from .ops.eval_kernels_df import (
    _fused_eval_1d_df_f64,
    _gathered_bank_eval_df_packed_f64,
    _gathered_bank_eval_f48_packed_f64,
    pack_bank_rows_df,
    pack_bank_rows_f48,
)
from .ops.eval_kernels_df2d import (
    _gathered_bicubic_eval_f48_packed_f64,
    _gathered_bilinear_eval_df_packed_f64,
    _gathered_bilinear_eval_f48_packed_f64,
    gathered_bicubic_eval_df_packed,
    gathered_bicubic_nodes_eval_df,
    pack_bicubic_nodes_df,
    pack_bicubic_rows_df,
    pack_bicubic_rows_f48,
    pack_bilinear_rows_df,
    pack_bilinear_rows_f48,
)
from .ops.eval_kernels_df_nd import gathered_nd_eval_df_packed, pack_rows_nd_df, pack_rows_nd_f48


def _default_buckets(max_size: int):
    out, b = [], 256
    while b < max_size:
        out.append(b)
        b *= 2
    out.append(max_size)
    return out


def compile_program(fn, device):
    """``torch.compile(fn, fullgraph=True)`` for an interpolator on
    ``device``: inductor on the card, ``aot_eager`` on the CPU (the same
    graph, run by PyTorch's own CPU operators; inductor's CPU code takes
    tens of seconds to build).  The program compiles a copy of ``fn`` with
    a code object of its own: Dynamo keeps its programs, and counts its
    recompiles against ``torch._dynamo.config.recompile_limit``, by code
    object, so each program's count is its own."""
    own = types.FunctionType(fn.__code__.replace(), fn.__globals__, fn.__name__,
                             fn.__defaults__, fn.__closure__)
    own.__kwdefaults__ = fn.__kwdefaults__
    backend = "inductor" if device.type == "cuda" else "aot_eager"
    return torch.compile(own, fullgraph=True, backend=backend)


def _dynamic_queries(padded):
    """Mark the query axis of each padded batch dynamic (a batch of one
    element stays static: Dynamo specialises sizes 0 and 1), so that the
    program's one graph serves every bucket."""
    for p in padded:
        if p.shape[0] > 1:
            torch._dynamo.mark_dynamic(p, 0)
    return padded


def _check_in_range(flat, lo, hi, what):
    """Eager ``OutOfBoundsError`` on the first query outside ``[lo, hi]`` or
    NaN (one flag copied to the host; the value only on error)."""
    bad = (flat < lo) | (flat > hi) | torch.isnan(flat)
    if bool(bad.any()):
        i = int(torch.argmax(bad.to(torch.uint8)))
        raise OutOfBoundsError(
            f"point {flat[i].item()} is out of bounds of {what}interpolation range "
            f"[{lo}, {hi}]"
        )


def _check_not_nan(*flats):
    """Eager API parity: modes that never go out of range refuse NaN."""
    if any(bool(torch.isnan(f).any()) for f in flats):
        raise ValueError("failed to convert NaN to an index")


def _wrap_periodic(flat, lo, hi):
    """``rem_euclid`` wrap of the queries outside ``[lo, hi]``, in float64
    on the device (``cubic_spline.rs:804-809``)."""
    out_r = (flat < lo) | (flat > hi)
    return torch.where(out_r, torch.remainder(flat - lo, hi - lo) + lo, flat)


class _BucketedEvaluator:
    """Shared bucketing; subclasses evaluate the padded batches."""

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None):
        self._interp = interp
        self._buckets = sorted(buckets or _default_buckets(max_batch))
        self._max = self._buckets[-1]

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self._buckets, n)
        return self._buckets[min(i, len(self._buckets) - 1)]

    @property
    def buckets(self):
        return tuple(self._buckets)

    def _padded_chunks(self, axes, run):
        """``run`` on chunks of at most ``max_batch`` queries, each padded up
        to its bucket; ``axes`` holds one ``(flat queries, pad value)`` per
        query axis.  Returns the results without the padding, concatenated."""
        n = axes[0][0].shape[0]
        outs = []
        for start in range(0, n, self._max):
            chunks = [flat[start : start + self._max] for flat, _ in axes]
            m = chunks[0].shape[0]
            padded = []
            for chunk, (_, pad) in zip(chunks, axes):
                p = pad.expand(self._bucket(m)).clone()
                p[:m] = chunk
                padded.append(p)
            outs.append(run(*padded)[:m])
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _df_chunks(self, axes):
        """The double-float evaluators' loop: the float64 queries in chunks
        of the bucket of their count, the last one padded with ``pad``, each
        chunk run by the evaluator's compiled program (:func:`_df_program`),
        which returns float64.  ``axes`` holds one ``(flat queries, pad)``
        per axis."""
        n = axes[0][0].shape[0]
        bsz = self._bucket(n)
        outs = []
        for start in range(0, n, bsz):
            chunks = []
            for flat, pad in axes:
                chunk = flat[start : start + bsz]
                if chunk.shape[0] < bsz:
                    chunk = torch.cat([chunk, flat.new_full((bsz - chunk.shape[0],), pad)])
                elif chunk.storage_offset() or not chunk.is_contiguous():
                    chunk = chunk.clone()  # the program's inputs start their storage
                chunks.append(chunk)
            outs.append(self._program(*_dynamic_queries(chunks)))
        res = outs[0] if len(outs) == 1 else torch.cat(outs)
        return res[:n]

    def _df_warmup(self, pads, device):
        """Compile the program and run every bucket, each query axis filled
        with its pad value (one of ``pads`` an axis)."""
        for b in self._buckets:
            self._program(*_dynamic_queries(
                [torch.full((b,), p, dtype=torch.float64, device=device) for p in pads]))
        return self


def _df_program(run, device):
    """The compiled program of a double-float evaluator
    (:func:`compile_program`): padded float64 query chunks, one a query
    axis, split into ``(hi, lo)`` pairs, ``run`` on them (K7 and a tail, or
    K6) and the result recombined to float64 where the tail returns a pair
    (the tails with a float64 store form write float64 themselves).  The
    JAX evaluators split and recombine on the host; here both are in the
    one graph."""

    def serve(*queries):
        res = run(*(half for q in queries for half in df_from_f64(q)))
        return res if isinstance(res, torch.Tensor) else df_to_f64(*res)

    return compile_program(serve, device)


class Evaluator(_BucketedEvaluator):
    """Bucketed evaluator over an :class:`Interp1D`: ``ev(q)`` equals
    ``interp(q)`` (out-of-range queries give NaN unless the strategy
    extrapolates) for queries of any shape.

    Args:
      interp: the interpolator.
      max_batch: largest query count evaluated at once (larger inputs are
        evaluated in ``max_batch`` chunks).
      buckets: optional ascending list of batch buckets.

    Queries that are not tensors go to the interpolator's device; the
    result is a tensor there.  Each padded batch runs the compiled program
    ``interp(q)`` (:func:`compile_program`), ``jax.jit(lambda t, q: t(q))``
    in the JAX package.
    """

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None):
        super().__init__(interp, max_batch, buckets)
        self._program = compile_program(lambda q: interp(q), interp.x.device)

    def _run(self, q):
        return self._program(*_dynamic_queries((q,)))

    def warmup(self):
        """Compile the program and run every bucket once, so that the
        kernel library is built, no later call compiles, and the caching
        allocator holds blocks of every bucket size."""
        x0 = self._interp.x[:1]
        for b in self._buckets:
            self._run(x0.expand(b).contiguous())
        return self

    def __call__(self, queries):
        itp = self._interp
        q = _to_tensor(queries, itp.x.device)
        flat = q.reshape(-1)
        shape = tuple(q.shape) + tuple(itp.data.shape[1:])
        if flat.shape[0] == 0:
            return torch.zeros(shape, dtype=itp.data.dtype, device=itp.x.device)
        out = self._padded_chunks([(flat, itp.x[:1].to(flat.dtype))], self._run)
        return out.reshape(shape)


class Evaluator2D(_BucketedEvaluator):
    """Bucketed evaluator over an :class:`Interp2D`: ``ev(xs, ys)`` equals
    ``interp(xs, ys)`` for paired queries of any one shape
    (``xs.shape == ys.shape``, ``interp2d/mod.rs:175-196``), padded with
    ``(x[0], y[0])``.  Arguments, devices and the compiled program
    ``interp(xs, ys)`` as :class:`Evaluator`."""

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None):
        super().__init__(interp, max_batch, buckets)
        self._program = compile_program(lambda qx, qy: interp(qx, qy), interp.x.device)

    def _run(self, qx, qy):
        return self._program(*_dynamic_queries((qx, qy)))

    def warmup(self):
        """Compile the program and run every bucket once (kernel build, no
        later compile, allocator blocks)."""
        x0, y0 = self._interp.x[:1], self._interp.y[:1]
        for b in self._buckets:
            self._run(x0.expand(b).contiguous(), y0.expand(b).contiguous())
        return self

    def __call__(self, xs, ys):
        itp = self._interp
        qx = _to_tensor(xs, itp.x.device)
        qy = _to_tensor(ys, itp.x.device)
        if qx.shape != qy.shape:
            raise ValueError(
                "xs and ys need to have the same shape. "
                f"Got xs: {list(qx.shape)}, ys: {list(qy.shape)}"
            )
        fx, fy = qx.reshape(-1), qy.reshape(-1)
        shape = tuple(qx.shape) + tuple(itp.data.shape[2:])
        if fx.shape[0] == 0:
            return torch.zeros(shape, dtype=itp.data.dtype, device=itp.x.device)
        out = self._padded_chunks(
            [(fx, itp.x[:1].to(fx.dtype)), (fy, itp.y[:1].to(fy.dtype))], self._run
        )
        return out.reshape(shape)


class EvaluatorND(_BucketedEvaluator):
    """Bucketed evaluator over an :class:`~.models.interpnd.InterpND`:
    ``ev(*coords)`` equals ``interp(*coords)`` for the ``k`` paired
    coordinate arrays of any one shape, padded with each axis's first knot.
    Arguments, devices and the compiled program ``interp(*coords)`` as
    :class:`Evaluator`."""

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None):
        super().__init__(interp, max_batch, buckets)
        self._program = compile_program(lambda *qs: interp(*qs), interp.data.device)

    def _run(self, *qs):
        return self._program(*_dynamic_queries(qs))

    def warmup(self):
        """Compile the program and run every bucket once (kernel build, no
        later compile, allocator blocks)."""
        for b in self._buckets:
            self._run(*(ax[:1].expand(b).contiguous() for ax in self._interp.axes))
        return self

    def __call__(self, *coords):
        itp = self._interp
        qs = itp._as_query(coords)  # the arity and shape checks of InterpND
        flats = [q.reshape(-1) for q in qs]
        shape = tuple(qs[0].shape) + tuple(itp.data.shape[itp.k :])
        if flats[0].shape[0] == 0:
            return torch.zeros(shape, dtype=itp.data.dtype, device=itp.data.device)
        out = self._padded_chunks(
            [(f, ax[:1].to(f.dtype)) for f, ax in zip(flats, itp.axes)], self._run
        )
        return out.reshape(shape)


class DoubleFloatEvaluator(_BucketedEvaluator):
    """float64-grade serving of a 1-D cubic/Hermite (or linear)
    interpolator through the double-float kernels.

    At construction the knots, data and coefficients are widened to
    float64 and split into ``(hi, lo)`` float32 pairs once, on the
    interpolator's device; bank data also gets its packed row table, built
    once.  Queries are float64 in, float64 out: each bucket of queries is
    split into pairs, evaluated by K6 (scalar data) or by K7 and the K8 tail
    (``grade="df"``) or the K9 tail (``grade="f48"``) for bank data, and
    recombined; K6, K8 and K9 write the recombined float64 themselves (their
    float64 store form, bit for bit the recombination).  On CPU tensors the
    kernels' plain versions run.

    Unlike the JAX evaluator, which returns numpy, this takes numpy arrays
    or tensors and returns a ``torch.float64`` tensor on the interpolator's
    device.  Out-of-range semantics follow the strategy:
    ``extrapolate(False)`` raises :class:`~..errors.OutOfBoundsError` (an
    eager check, one flag copied to the host); extrapolating modes raise
    ``ValueError`` on NaN queries; periodic mode wraps in float64 before
    splitting.

    ``grade="f48"`` (bank data only) packs the lo half of the row table as
    bfloat16 pairs: 75% of the double-float table's memory and traffic at
    ~2^-33 scale-relative accuracy, against ~2^-48 for ``"df"``.
    """

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None, grade="df"):
        if grade not in ("df", "f48"):
            raise ValueError(f"grade must be 'df' or 'f48', got {grade!r}")
        super().__init__(interp, max_batch, buckets)
        strat = interp.strategy
        data = interp.data
        self._bank_shape = tuple(data.shape[1:])
        self._mode = getattr(strat, "mode", None) or (
            "yes" if strat.extrapolates else "no"
        )
        f64 = torch.float64
        x64 = interp.x.detach().to(f64)
        self._x0 = float(x64[0])
        self._xn = float(x64[-1])
        n = x64.shape[0]
        bank = math.prod(self._bank_shape)
        rows = (n, bank) if self._bank_shape else (n,)

        def coefficients(name):
            v = getattr(strat, name, None)
            if v is None:  # Linear: a = b = 0 reduces the Hermite form to the lerp
                return torch.zeros((n - 1,) + rows[1:], dtype=f64, device=x64.device)
            return v.detach().to(f64).reshape((n - 1,) + rows[1:])

        tables = [data.detach().to(f64).reshape(rows), coefficients("a"), coefficients("b")]
        pairs = [half for v in tables for half in df_from_f64(v)]
        x_pair = df_from_f64(x64)
        if grade != "df" and not self._bank_shape:
            raise ValueError(
                "grade='f48' supports the banked (trailing-dims) route "
                "only; the scalar kernel is always full double-float"
            )
        if self._bank_shape:
            pack, route = {
                "df": (pack_bank_rows_df, _gathered_bank_eval_df_packed_f64),
                "f48": (pack_bank_rows_f48, _gathered_bank_eval_f48_packed_f64),
            }[grade]
            self._packed = pack(*pairs)
            self._run = functools.partial(route, *x_pair, self._packed, bank)
        else:
            self._run = functools.partial(_fused_eval_1d_df_f64, *x_pair, *pairs)
        self._program = _df_program(self._run, x64.device)

    def warmup(self):
        """Compile the program and run every bucket once (kernel build, no
        later compile, allocator blocks)."""
        return self._df_warmup([self._x0], self._interp.x.device)

    def __call__(self, queries):
        dev = self._interp.x.device
        q = torch.as_tensor(queries, dtype=torch.float64, device=dev)
        flat = q.reshape(-1)
        shape = tuple(q.shape) + self._bank_shape
        if flat.shape[0] == 0:
            return torch.zeros(shape, dtype=torch.float64, device=dev)
        if self._mode == "no":
            _check_in_range(flat, self._x0, self._xn, "the ")
        else:
            _check_not_nan(flat)
        if self._mode == "periodic":
            flat = _wrap_periodic(flat, self._x0, self._xn)
        return self._df_chunks([(flat, self._x0)]).reshape(shape)


class DoubleFloatEvaluator2D(_BucketedEvaluator):
    """float64-grade serving of a 2-D ``Bilinear`` or ``Bicubic``
    interpolator through the double-float kernels.

    At construction the knots are widened to float64 and split into
    ``(hi, lo)`` pairs, and the packed table is built once on the
    interpolator's device: for ``Bilinear`` from the data
    (:func:`~.ops.eval_kernels_df2d.pack_bilinear_rows_df`, or ``_f48``),
    for ``Bicubic`` from the strategy's float64 cell table
    (:func:`~.ops.eval_kernels_df2d.pack_bicubic_rows_df`, or ``_f48``).
    Each bucket of float64 queries is split into pairs and evaluated by K7
    on both axes and the K10/K11 (bilinear) or K12/K13 (bicubic) tail, and
    the result recombined: a ``torch.float64`` tensor on the interpolator's
    device.  K10, K11 and K13 write the recombined float64 themselves (their
    float64 store form, bit for bit the recombination).  On CPU tensors the
    kernels' plain versions run.  Build the interpolator in float64 for
    float64-grade results.

    Out-of-range semantics follow the JAX evaluator: without extrapolation
    a query outside its axis raises :class:`~..errors.OutOfBoundsError` (x
    checked first; NaN counts as out of range), a periodic (wrapping) axis
    refuses NaN and wraps in float64 on the device; extrapolating
    strategies raise ``ValueError`` on NaN queries.

    A bicubic grid above ``config.bicubic_pack_max_elems`` cell elements has the
    node layout: its table is packed with
    :func:`~.ops.eval_kernels_df2d.pack_bicubic_nodes_df` (about the grid's
    float64 memory, a quarter of the DF cell table) and evaluated by K7 and
    K14, four node rows a query; grade ``"df"`` only.
    """

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None, grade="df"):
        if grade not in ("df", "f48"):
            raise ValueError(f"grade must be 'df' or 'f48', got {grade!r}")
        super().__init__(interp, max_batch, buckets)
        strat = interp.strategy
        self._trailing = tuple(interp.data.shape[2:])
        self._extrapolates = bool(strat.extrapolates)
        self._wraps = (bool(getattr(strat, "wraps_x", False)),
                       bool(getattr(strat, "wraps_y", False)))
        f64 = torch.float64
        x64 = interp.x.detach().to(f64)
        y64 = interp.y.detach().to(f64)
        self._xr = (float(x64[0]), float(x64[-1]))
        self._yr = (float(y64[0]), float(y64[-1]))
        r = math.prod(self._trailing)
        axes = (*df_from_f64(x64), *df_from_f64(y64))
        if isinstance(strat, BicubicStrategy):
            rows_pair = df_from_f64(strat.rows.detach().to(f64))
            if strat.layout != "cell":
                if grade != "df":
                    raise ValueError(
                        "grade='f48' supports the bicubic cell layout and bilinear only"
                    )
                self._packed = pack_bicubic_nodes_df(*rows_pair)
                self._run = functools.partial(gathered_bicubic_nodes_eval_df, *axes,
                                              self._packed, r=r)
                self._program = _df_program(self._run, x64.device)
                return
            pack, route = {
                "df": (pack_bicubic_rows_df, gathered_bicubic_eval_df_packed),
                "f48": (pack_bicubic_rows_f48, _gathered_bicubic_eval_f48_packed_f64),
            }[grade]
            self._packed = pack(*rows_pair, r)
            self._run = functools.partial(route, *axes, self._packed, r=r)
        else:
            pack, route = {
                "df": (pack_bilinear_rows_df, _gathered_bilinear_eval_df_packed_f64),
                "f48": (pack_bilinear_rows_f48, _gathered_bilinear_eval_f48_packed_f64),
            }[grade]
            self._packed = pack(*df_from_f64(interp.data.detach().to(f64)))
            self._run = functools.partial(route, *axes, self._packed, y64.shape[0], r)
        self._program = _df_program(self._run, x64.device)

    def warmup(self):
        """Compile the program and run every bucket once (kernel build, no
        later compile, allocator blocks)."""
        return self._df_warmup([self._xr[0], self._yr[0]], self._interp.x.device)

    def __call__(self, xs, ys):
        dev = self._interp.x.device
        qx = torch.as_tensor(xs, dtype=torch.float64, device=dev)
        qy = torch.as_tensor(ys, dtype=torch.float64, device=dev)
        if qx.shape != qy.shape:
            raise ValueError(
                f"`xs.shape` and `ys.shape` do not match: {tuple(qx.shape)} vs "
                f"{tuple(qy.shape)}"
            )
        fx, fy = qx.reshape(-1), qy.reshape(-1)
        shape = tuple(qx.shape) + self._trailing
        if fx.shape[0] == 0:
            return torch.zeros(shape, dtype=torch.float64, device=dev)
        axes = (("x", fx, self._xr, self._wraps[0]), ("y", fy, self._yr, self._wraps[1]))
        if not self._extrapolates:
            for name, f, (lo, hi), wrap in axes:
                if wrap:
                    _check_not_nan(f)
                else:
                    _check_in_range(f, lo, hi, f"the {name} ")
        else:
            _check_not_nan(fx, fy)
        flats = [_wrap_periodic(f, *rng) if wrap else f for _, f, rng, wrap in axes]
        out = self._df_chunks([(flats[0], self._xr[0]), (flats[1], self._yr[0])])
        return out.reshape(shape)


class DoubleFloatEvaluatorND(_BucketedEvaluator):
    """float64-grade serving of an :class:`~.models.interpnd.InterpND`
    (``method="cubic"`` on the cell layout, or ``method="linear"``) through
    the double-float kernels.

    At construction the axes are widened to float64 and split into
    ``(hi, lo)`` pairs, and the packed table is built once on the
    interpolator's device: from the cubic strategy's float64 cell table, or
    the linear corner rows of the float64 data, with
    :func:`~.ops.eval_kernels_df_nd.pack_rows_nd_df` (grade ``"df"``) or
    :func:`~.ops.eval_kernels_df_nd.pack_rows_nd_f48` (``"f48"``: 75% of the
    memory and traffic at ~2^-33 scale-relative).  Each bucket of float64
    queries is split into pairs, evaluated by K7 on every axis and the K15
    tail, and recombined: a ``torch.float64`` tensor on the interpolator's
    device.  On CPU tensors the kernels' plain versions run.  Build the
    interpolator in float64 for float64-grade results.

    Eager checks, as the JAX evaluator: for each axis in turn, a NaN query
    raises ``ValueError``, then, unless the axis wraps or the interpolator
    extrapolates, a query outside the axis raises
    :class:`~..errors.OutOfBoundsError`.  Periodic axes wrap in float64 on
    the device.  The cubic node layouts and ``method="nearest"`` raise the
    JAX package's ``ValueError``.
    """

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None, grade="df"):
        if grade not in ("df", "f48"):
            raise ValueError(f"grade must be 'df' or 'f48', got {grade!r}")
        super().__init__(interp, max_batch, buckets)
        k = interp.k
        f64 = torch.float64
        self._trailing = tuple(interp.data.shape[k:])
        self._extrapolates = bool(interp.extrapolates)
        self._wraps = tuple(interp.wraps_axis(d) for d in range(k))
        axes64 = [ax.detach().to(f64) for ax in interp.axes]
        self._ranges = [(float(a[0]), float(a[-1])) for a in axes64]
        r = math.prod(self._trailing)
        if interp.method == "cubic":
            if interp.layout != "cell":
                # the JAX package's message word for word; the port's cap is
                # ndarray_interp_tpu_torch.config.interpnd_pack_max_elems
                raise ValueError(
                    "DoubleFloatEvaluatorND supports the cubic CELL layout only (one packed "
                    "row gather); this grid packed as NODE layout — raise "
                    "config.interpnd_pack_max_elems to force the cell table, or evaluate in "
                    "f64 on the CPU backend"
                )
            rows64 = interp.table.detach().to(f64)
            nbasis = 4
        elif interp.method == "linear":
            # the interpolator may take the unpacked route (a big grid): the
            # double-float table is packed here from the float64 data
            rows64 = pack_corner_rows_nd(interp.data.detach().to(f64), k)
            nbasis = 2
        else:
            raise ValueError(
                "method='nearest' needs no DF route: its gather returns stored values "
                "exactly — evaluate the f64 InterpND"
            )
        pack = {"df": pack_rows_nd_df, "f48": pack_rows_nd_f48}[grade]
        self._packed = pack(*df_from_f64(rows64), nbasis**k, r)
        route = gathered_nd_eval_df_packed(
            k, tuple(interp.data.shape[:k]), r, nbasis=nbasis, tier=grade
        )
        pairs = [half for a in axes64 for half in df_from_f64(a)]
        self._run = functools.partial(route, *pairs, self._packed)
        self._program = _df_program(self._run, self._packed.device)

    def warmup(self):
        """Compile the program and run every bucket once (kernel build, no
        later compile, allocator blocks)."""
        return self._df_warmup([lo for lo, _ in self._ranges], self._interp.data.device)

    def __call__(self, *coords):
        dev = self._interp.data.device
        self._interp._check_arity(coords)
        qs = [torch.as_tensor(c, dtype=torch.float64, device=dev) for c in coords]
        if any(q.shape != qs[0].shape for q in qs[1:]):
            raise ValueError("query coordinate shapes do not match")
        flats = [q.reshape(-1) for q in qs]
        shape = tuple(qs[0].shape) + self._trailing
        if flats[0].shape[0] == 0:
            return torch.zeros(shape, dtype=torch.float64, device=dev)
        for d, (f, (lo, hi), wrap) in enumerate(zip(flats, self._ranges, self._wraps)):
            _check_not_nan(f)
            if not (wrap or self._extrapolates):
                _check_in_range(f, lo, hi, f"the axis {d} ")
        flats = [_wrap_periodic(f, *rng) if wrap else f
                 for f, rng, wrap in zip(flats, self._ranges, self._wraps)]
        out = self._df_chunks([(f, lo) for f, (lo, _) in zip(flats, self._ranges)])
        return out.reshape(shape)


def eval_into_donated(interp, queries, out):
    """Write the values of ``interp`` at ``queries`` into the tensor ``out``
    and return it.

    Counterpart of the JAX package's ``eval_into_donated``, which donates
    ``out`` to the compiled program.  PyTorch has no buffer donation: the
    result is computed and copied into ``out``.  As there, the strategy is
    evaluated without the range check or the NaN mask
    (:meth:`Interp1D.eval_unchecked`).  ``out`` must have the shape
    ``queries.shape + data.shape[1:]``, else ``ValueError``."""
    expect = tuple(queries.shape) + tuple(interp.data.shape[1:])
    if tuple(out.shape) != expect:
        raise ValueError(
            f"output buffer has shape {tuple(out.shape)}, expected {expect}"
        )
    return out.copy_(interp.eval_unchecked(queries))


def eval_into_donated_2d(interp, xs, ys, out):
    """2-D counterpart of :func:`eval_into_donated` (the reference's 2-D
    ``interp_array_into``, ``interp2d/mod.rs:234-253``): ``xs.shape ==
    ys.shape`` is enforced, ``out`` must have the shape ``xs.shape +
    data.shape[2:]``, and the values of :meth:`Interp2D.eval_unchecked` are
    copied into ``out``, which is returned."""
    if tuple(xs.shape) != tuple(ys.shape):
        raise ValueError(
            f"`xs.shape` and `ys.shape` do not match: {tuple(xs.shape)} "
            f"vs {tuple(ys.shape)}"
        )
    expect = tuple(xs.shape) + tuple(interp.data.shape[2:])
    if tuple(out.shape) != expect:
        raise ValueError(
            f"output buffer has shape {tuple(out.shape)}, expected {expect}"
        )
    return out.copy_(interp.eval_unchecked(xs, ys))
