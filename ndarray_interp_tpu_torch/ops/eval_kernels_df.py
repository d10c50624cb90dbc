"""f64-grade 1-D evaluation on the GPU: wrappers of K6, K7, K8 and K9.

Counterpart of the 1-D part of ``ndarray_interp_tpu.ops.pallas_eval_df``,
with its names and signatures: every value crosses the interface as an
``(hi, lo)`` float32 pair (``ops/df.py``).  The CUDA kernels are in
``csrc/df_kernels.cu``.  Each widens every pair once to float64 (exact) and
computes natively in FP64, where the TPU kernels carried error-free
transforms on float32:

* :func:`fused_eval_1d_df` (K6): search and symmetric Hermite form, for
  scalar data;
* :func:`fused_index_frac_df` (K7): the search emitting ``(idx, t_hi, t_lo)``,
  on the knots widened once into shared memory (all of them up to
  ``_K7_SHARED_KNOTS``), in breadth-first order;
* :func:`gathered_df_tail` (K8) and :func:`gathered_f48_tail` (K9): the
  Hermite tail of the banked route on a packed row table.  Each gathers its
  query's row itself; the JAX package gathers ``(Q, 8·bp)`` rows with XLA
  first and runs its tail kernel on them.  Both order a large batch by
  interval first (:func:`.cell_order.order_by_interval`, then the kernel on
  the ordered records, :func:`_orders`), so that the queries of one row
  share its widening; each result still goes to its query's own slot.

:func:`_gathered_df_tail_f64`, :func:`_gathered_f48_tail_f64` and the routes
:func:`_gathered_bank_eval_df_packed_f64` and
:func:`_gathered_bank_eval_f48_packed_f64` take K8's and K9's float64 store
form: the kernel writes ``df_to_f64`` of its result pair, bit for bit, into
one float64 array, which ``DoubleFloatEvaluator`` returns without widening
and adding the pair itself.

Each kernel's plain version is here, in PyTorch float64 and the kernel's
operation order: :func:`eval_xla_df` (K6), :func:`_df_index_frac_xla` (K7),
:func:`_df_tail_plain` (K8: :func:`_df_xla_tail` on ``index_select``-ed
rows; on ordered records :func:`_df_tail_ordered_plain`) and
:func:`_f48_tail_plain` (K9: the same after :func:`_unpack_f48_lo`; on
ordered records :func:`_f48_tail_ordered_plain`).  A wrapper runs the plain version for CPU tensors
and launches its kernel for CUDA tensors; the kernels are bit-identical to
the plain versions.  ``launches`` on each wrapper counts its kernel's
launches.

Semantics, and where they differ from the JAX package:

* The index is the count of knots ``<= q`` minus one, clamped to
  ``[0, n-2]``, comparing widened float64 values.  For pairs made by
  :func:`.df.df_from_f64` that is the JAX package's lexicographic
  ``(hi, lo)`` order, so knots that collide in float32 are told apart.  A
  NaN query gets index 0, as in both JAX double-float forms (the float32
  K2/K3 give ``n-2``).
* No knot limit: K6 and K7 serve any knot count.  The JAX package switches
  to XLA above its window plan's 65,536 knots (``serving.py:392-397``,
  ``pallas_eval_df.py:632-641``).
* The fraction ``t`` is computed in float64, so a ±inf query gives
  ``t = ±inf`` and a linear segment (``a = b = 0``) evaluates to ±inf on
  every route.  The JAX package's double-float fraction (``df_div``) is NaN
  there, so its banked route returns NaN at ±inf (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import default_device
from . import _cuda
from .cell_order import order_by_interval, record_fields
from .df import df_from_f64, df_to_f64

# K8/K9 cover a bank in blocks of 32 columns on the second grid axis,
# which CUDA caps at 65,535 blocks
_MAX_BANK = 65_535 * 32


# -- plain versions ---------------------------------------------------------------
def _df_lower_index(x_hi, x_lo, q_hi, q_lo, n):
    """Clamped lower-interval index of each query on the pair knots (int32):
    ``searchsorted(right=True) - 1`` on the widened values, NaN -> 0."""
    q = df_to_f64(q_hi, q_lo)
    idx = torch.searchsorted(
        df_to_f64(x_hi, x_lo), q.contiguous(), right=True, out_int32=True
    )
    idx = (idx - 1).clamp_(0, n - 2)
    return torch.where(torch.isnan(q), torch.zeros_like(idx), idx)


def _hermite(y_l, y_r, a, b, t):
    """The symmetric Hermite form in the operation order of
    ``cubic_spline.rs:818-828`` (``pallas_eval_df.py:269-275``)."""
    omt = 1.0 - t
    return (omt * y_l + t * y_r) + (t * omt) * (a * omt + b * t)


def _with_linear_escape(base, tn, y_lh, y_rh, a, b):
    """The result pair of the float64 ``base``, except where the float32
    fraction ``tn`` of the hi values is ±inf on a linear segment
    (``a = b = 0``): there the float32 lerp of the hi values with ``lo = 0``
    (``pallas_eval_df.py:276-285``), since the symmetric form gives
    ``inf - inf = NaN``."""
    hi, lo = df_from_f64(base)
    lin_inf = torch.isinf(tn) & (a[0] == 0) & (a[1] == 0) & (b[0] == 0) & (b[1] == 0)
    alt = y_lh + tn * (y_rh - y_lh)
    return torch.where(lin_inf, alt, hi), torch.where(lin_inf, torch.zeros_like(alt), lo)


def eval_xla_df(x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo):
    """Plain version of K6: double-float 1-D evaluation in float64.

    ``x``, ``d``: (n,) knots and data; ``a``, ``b``: (n-1,) Hermite
    coefficients (zeros for linear); ``q``: queries.  Returns the result
    pair shaped like ``q``."""
    n = x_hi.shape[0]
    idx = _df_lower_index(x_hi, x_lo, q_hi, q_lo, n).long()
    x_lh, x_rh = x_hi[idx], x_hi[idx + 1]
    y_lh, y_rh = d_hi[idx], d_hi[idx + 1]
    a = (a_hi[idx], a_lo[idx])
    b = (b_hi[idx], b_lo[idx])
    x_l = df_to_f64(x_lh, x_lo[idx])
    t = (df_to_f64(q_hi, q_lo) - x_l) / (df_to_f64(x_rh, x_lo[idx + 1]) - x_l)
    base = _hermite(
        df_to_f64(y_lh, d_lo[idx]), df_to_f64(y_rh, d_lo[idx + 1]),
        df_to_f64(*a), df_to_f64(*b), t,
    )
    tn = (q_hi - x_lh) / (x_rh - x_lh)
    return _with_linear_escape(base, tn, y_lh, y_rh, a, b)


def _df_index_frac_xla(x_hi, x_lo, q_hi, q_lo):
    """Plain version of K7: ``(idx, t_hi, t_lo)`` with
    ``t = (q - x_l) / (x_r - x_l)`` in float64."""
    idx = _df_lower_index(x_hi, x_lo, q_hi, q_lo, x_hi.shape[0])
    il = idx.long()
    x_l = df_to_f64(x_hi[il], x_lo[il])
    x_r = df_to_f64(x_hi[il + 1], x_lo[il + 1])
    t_hi, t_lo = df_from_f64((df_to_f64(q_hi, q_lo) - x_l) / (x_r - x_l))
    return idx, t_hi, t_lo


def _df_xla_tail(rows, th, tl, bank):
    """The double-float Hermite form on gathered packed rows ``(Q, 8·bp)``
    (:func:`pack_bank_rows_df` layout) at the fractions ``(th, tl)``, in
    float64.  Returns the ``(Q, bank)`` result pair."""
    bp = rows.shape[1] // 8

    def sl(i):
        return rows[:, i * bp : i * bp + bank]

    y_l, y_r, a, b = ((sl(i), sl(i + 4)) for i in range(4))
    t = (th[:, None], tl[:, None])
    base = _hermite(*(df_to_f64(*v) for v in (y_l, y_r, a, b, t)))
    return _with_linear_escape(base, t[0], y_l[0], y_r[0], a, b)


def _gather_rows(packed, idx):
    # indices outside the table are clamped, as the kernels clamp them
    return packed.index_select(0, idx.long().clamp(0, packed.shape[0] - 1))


def _df_tail_plain(packed, idx, th, tl, bank):
    """Plain version of K8: :func:`_df_xla_tail` on the gathered rows."""
    return _df_xla_tail(_gather_rows(packed, idx), th, tl, bank)


def _scatter_back(hi, lo, qid):
    """Rows of ordered results put back at their queries' slots."""
    out_hi, out_lo = torch.empty_like(hi), torch.empty_like(lo)
    out_hi[qid.long()] = hi
    out_lo[qid.long()] = lo
    return out_hi, out_lo


def _df_tail_ordered_plain(packed, records, bank):
    """Plain version of K8 on the 1-D records of
    :func:`~.cell_order.order_by_interval`: the rows of the records'
    intervals, :func:`_df_xla_tail` at their fraction halves, each result
    put back at its query's slot."""
    v, qid, frac = record_fields(records)
    hi, lo = _df_xla_tail(_gather_rows(packed, v), frac[:, 0], frac[:, 1], bank)
    return _scatter_back(hi, lo, qid)


def _f48_rows_unpacked(rows):
    """Gathered :func:`pack_bank_rows_f48` rows ``(Q, 6·bp)`` in the
    :func:`pack_bank_rows_df` layout ``(Q, 8·bp)``, lo halves unpacked."""
    bp = rows.shape[1] // 6
    return torch.cat([rows[:, : 4 * bp], _unpack_f48_lo(rows[:, 4 * bp :])], dim=1)


def _f48_tail_plain(packed, idx, th, tl, bank):
    """Plain version of K9: :func:`_df_xla_tail` on the gathered rows of a
    :func:`pack_bank_rows_f48` table, lo halves unpacked."""
    return _df_xla_tail(_f48_rows_unpacked(_gather_rows(packed, idx)), th, tl, bank)


def _f48_tail_ordered_plain(packed, records, bank):
    """Plain version of K9 on the 1-D records of
    :func:`~.cell_order.order_by_interval`, as :func:`_df_tail_ordered_plain`
    is K8's."""
    v, qid, frac = record_fields(records)
    rows = _f48_rows_unpacked(_gather_rows(packed, v))
    return _scatter_back(*_df_xla_tail(rows, frac[:, 0], frac[:, 1], bank), qid)


def eval_xla_df_banked(x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo):
    """Double-float banked Hermite evaluation without a packed table: data
    ``(n, bank)``, ``a``/``b`` ``(n-1, bank)`` pairs, flat queries.  Returns
    the ``(nq, bank)`` result pair.  Counterpart of the JAX package's plain
    banked form, whose ±inf escape takes the float32 fraction of the hi
    values (the packed route's takes ``t_hi``)."""
    idx, th, tl = _df_index_frac_xla(x_hi, x_lo, q_hi, q_lo)
    il = idx.long()
    y_l = (d_hi[il], d_lo[il])
    y_r = (d_hi[il + 1], d_lo[il + 1])
    a = (a_hi[il], a_lo[il])
    b = (b_hi[il], b_lo[il])
    t = (th[:, None], tl[:, None])
    base = _hermite(*(df_to_f64(*v) for v in (y_l, y_r, a, b, t)))
    x_lh = x_hi[il]
    tn = (q_hi - x_lh) / (x_hi[il + 1] - x_lh)
    return _with_linear_escape(base, tn[:, None], y_l[0], y_r[0], a, b)


# -- packed row tables ------------------------------------------------------------
def _bank_pad(bank):
    return -(-bank // 8) * 8


def pack_bank_rows_df(d_hi, d_lo, a_hi, a_lo, b_hi, b_lo):
    """Packed double-float per-interval rows ``(n-1, 8·bp)``:
    ``[y_l | y_r | a | b]`` hi blocks, then the same lo blocks, each padded
    with zeros to ``bp`` (the bank rounded up to a multiple of 8) columns.
    Bit-identical to the JAX package's table."""
    bank = d_hi.shape[1]
    pad = (0, _bank_pad(bank) - bank)
    blocks = (d_hi[:-1], d_hi[1:], a_hi, b_hi, d_lo[:-1], d_lo[1:], a_lo, b_lo)
    return torch.cat([F.pad(v, pad) for v in blocks], dim=1)


def _bf16_bits(v):
    """The 16 bits of ``v`` rounded to bfloat16, as int64 in [0, 65535]."""
    return v.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _as_f32_bits(u):
    """Reinterpret int64 values in [0, 2**32) as float32 bit patterns."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def pack_bank_rows_f48(d_hi, d_lo, a_hi, a_lo, b_hi, b_lo):
    """"f48" per-interval rows ``(n-1, 6·bp)``: the four hi blocks of
    :func:`pack_bank_rows_df`, then the four lo blocks rounded to bfloat16
    and packed two to a float32 lane: ``[y_l_lo | y_r_lo]`` in the high 16
    bits of the ``2·bp`` packed lanes, ``[a_lo | b_lo]`` in the low 16.
    75% of the double-float table for ~2^-33 scale-relative accuracy.
    Bit-identical to the JAX package's table."""
    bank = d_hi.shape[1]
    bp = _bank_pad(bank)
    pad = (0, bp - bank)
    hi = torch.cat([F.pad(v, pad) for v in (d_hi[:-1], d_hi[1:], a_hi, b_hi)], dim=1)
    lo16 = _bf16_bits(
        torch.cat([F.pad(v, pad) for v in (d_lo[:-1], d_lo[1:], a_lo, b_lo)], dim=1)
    )
    half = 2 * bp
    return torch.cat([hi, _as_f32_bits((lo16[:, :half] << 16) | lo16[:, half:])], dim=1)


def _unpack_f48_lo(packed_lo):
    """The bfloat16-pair lo section ``(Q, 2·bp)`` back to float32
    ``(Q, 4·bp)``: the high 16 bits of each lane give the first half of the
    blocks, the low 16 bits (shifted up) the second half."""
    u = packed_lo.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    first = _as_f32_bits(u & 0xFFFF0000)
    second = _as_f32_bits((u << 16) & 0xFFFFFFFF)
    return torch.cat([first, second], dim=1)


# -- kernel launches -----------------------------------------------------------------
def _flat_pair(name, hi, lo):
    if hi.shape != lo.shape:
        raise ValueError(f"{name}: hi {tuple(hi.shape)} and lo {tuple(lo.shape)} differ")
    return hi.reshape(-1).contiguous(), lo.reshape(-1).contiguous()


def _check_knots(name, x_hi, x_lo):
    if x_hi.ndim != 1 or x_hi.shape[0] < 2 or x_lo.shape != x_hi.shape:
        raise ValueError(f"{name}: knots must be 1-D (hi, lo) halves of at least 2 entries")


def _launch_eval(x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo):
    name = "fused_eval_1d_df"
    args = (x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo)
    _cuda.pair_operands(name, q_hi, q_lo, *args)
    _check_knots(name, x_hi, x_lo)
    n = x_hi.shape[0]
    for what, v, m in (("d", d_hi, n), ("d", d_lo, n), ("a", a_hi, n - 1),
                       ("a", a_lo, n - 1), ("b", b_hi, n - 1), ("b", b_lo, n - 1)):
        if tuple(v.shape) != (m,):
            raise ValueError(f"{name}: {what} must have shape ({m},), got {tuple(v.shape)}")
    qh, ql = _flat_pair(name, q_hi, q_lo)
    out_hi, out_lo = torch.empty_like(qh), torch.empty_like(qh)
    _cuda.launch(
        "ndi_df_eval1d", torch.float32, q_hi.device,
        *(v.contiguous() for v in args[:2]), n, *(v.contiguous() for v in args[2:]),
        qh, ql, out_hi, out_lo, qh.shape[0],
    )
    fused_eval_1d_df.launches += 1
    return out_hi.reshape(q_hi.shape), out_lo.reshape(q_hi.shape)


# The most knots a block of K7 widens into shared memory (the kernel caps it
# at the largest tree a block may hold, 16,383 knots in 128 KB): the whole
# axis up to here, every w-th knot above, with the last log2(w) levels of the
# search on the global pairs.  Measured on an H100 80GB HBM3 at 700 W
# (chip_smoke.py's K7 phase, 2^20 queries on 10,240 knots / 1M on 70,001):
# budget 1 (every level global) 0.0473 / 0.1008 ms; 4,095 0.0219 / 0.1019;
# 8,191 0.0481 / 0.0989 (three blocks' 64 KB of an SM leave too little L1 for
# the global levels); 12,288 0.0188 (the axis whole) / 0.0529; 16,383 0.0188
# / 0.0530.
_K7_SHARED_KNOTS = 16_383


def _launch_index_frac(x_hi, x_lo, q_hi, q_lo):
    name = "fused_index_frac_df"
    _cuda.pair_operands(name, q_hi, q_lo, x_hi, x_lo)
    _check_knots(name, x_hi, x_lo)
    if x_hi.shape[0] >= 2**31:
        raise ValueError(f"{name}: {x_hi.shape[0]} knots; the index is int32")
    qh, ql = _flat_pair(name, q_hi, q_lo)
    idx = torch.empty(qh.shape, dtype=torch.int32, device=qh.device)
    t_hi, t_lo = torch.empty_like(qh), torch.empty_like(qh)
    _cuda.launch(
        "ndi_df_index_frac", torch.float32, q_hi.device,
        x_hi.contiguous(), x_lo.contiguous(), x_hi.shape[0], _K7_SHARED_KNOTS, qh, ql, idx,
        t_hi, t_lo, qh.shape[0],
    )
    fused_index_frac_df.launches += 1
    shape = q_hi.shape
    return idx.reshape(shape), t_hi.reshape(shape), t_lo.reshape(shape)


# K8 and K9 order a batch by interval first (``cell_order.order_by_interval``)
# when _orders says so.  Their rows sit in the L2 (21 MB / 16 MB at 10,240 x
# 64), so what ordering saves is not HBM traffic but instructions: in
# interval order a lane widens its chunk of a row once for a run of queries.
# Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py --sweeps, 10,240
# knots, the ordering's shared form included, against the body in query
# order), K8 / K9: at bank 64 the ordered branch loses at 2^16 queries
# (0.0474 / 0.0332 ms; K9 0.0452 / 0.0297), ties at 2^17 (0.0620 / 0.0618;
# 0.0606 / 0.0600) and wins from 2^18 (0.0932 / 0.1155; 0.0920 / 0.1134;
# 2^20: 0.2854 / 0.4390; 0.2830 / 0.4326); at bank 256 it wins from 2^16
# (0.1095 / 0.1258; 0.1008 / 0.1147); at bank 8 it loses at every size (2^20:
# 0.2145 / 0.1847; 0.2148 / 0.1830), and so does the one-column-a-lane kernel
# of a bank that is no multiple of 4 (63 at 2^20: 0.7751 / 0.6887; 0.7753 /
# 0.7535).  One rule serves both; no path runs bank 256 below 2^17.
_ORDER_MIN_QUERIES = 1 << 17
_ORDER_MIN_BANK = 64


def _orders(nq, bank):
    """Whether K8 and K9 order a batch of ``nq`` queries on a bank of
    ``bank`` columns by interval first."""
    return bank >= _ORDER_MIN_BANK and bank % 4 == 0 and nq >= _ORDER_MIN_QUERIES


def _launch_tail(symbol, wrapper, blocks, packed, idx, th, tl, bank, f64=False):
    """Check the operands and launch a bank tail: the ``(nq, bank)`` result
    pair, or with ``f64`` the float64 store form of the kernel (the pair's
    ``hi + lo``).  The batches :func:`_orders` picks go to ``<symbol>_ordered``,
    the kernel on the records of :func:`~.cell_order.order_by_interval`."""
    name = wrapper.__name__
    _cuda.pair_operands(name, th, tl, packed)
    if idx.dtype != torch.int32 or idx.device != th.device:
        raise TypeError(f"{name}: idx must be torch.int32 on {th.device}")
    if packed.ndim != 2 or packed.shape[1] % blocks or packed.shape[1] // blocks < bank:
        raise ValueError(
            f"{name}: packed must have shape (rows, {blocks}·bp) with bp >= bank = "
            f"{bank}, got {tuple(packed.shape)}"
        )
    if not 0 < bank <= _MAX_BANK:
        raise ValueError(f"{name}: bank must be in [1, {_MAX_BANK}], got {bank}")
    if not idx.shape == th.shape == tl.shape or idx.ndim != 1:
        raise ValueError(f"{name}: idx, t_hi and t_lo must be flat and of one length")
    nq, dev = idx.shape[0], th.device
    if f64:  # the kernel's float64 store form: one output, out_lo null
        out = (torch.empty((nq, bank), dtype=torch.float64, device=dev), None)
    else:
        out = tuple(torch.empty((nq, bank), dtype=torch.float32, device=dev) for _ in range(2))
    packed = packed.contiguous()
    bp = packed.shape[1] // blocks
    if _orders(nq, bank):
        records = order_by_interval(idx, packed.shape[0], th, tl)
        if packed.data_ptr() % 16:  # the rows are read with 16-byte loads
            packed = packed.clone()
        _cuda.launch(f"{symbol}_ordered", torch.float32, dev,
                     packed, packed.shape[0], packed.shape[1], bp, bank, records, *out, nq)
    else:
        _cuda.launch(
            symbol, torch.float32, dev,
            packed, packed.shape[0], packed.shape[1], bp, bank,
            idx.contiguous(), th.contiguous(), tl.contiguous(), *out, nq,
        )
    wrapper.launches += 1
    return out[0] if f64 else out


# -- public wrappers ---------------------------------------------------------------
def fused_eval_1d_df(x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo):
    """Double-float evaluation; every argument is an ``(hi, lo)`` float32
    half.  ``x``, ``d``: (n,) knots and data; ``a``, ``b``: (n-1,) Hermite
    coefficients (zeros for linear); ``q``: queries.  Returns the result
    pair shaped like ``q`` (:func:`.df.df_to_f64` gives float64).

    Semantics of the JAX package's ``fused_eval_1d_df``: clamp to
    ``[0, n-2]`` including ±inf, NaN queries give NaN, knots that collide in
    float32 are told apart.  CPU tensors: :func:`eval_xla_df`; CUDA: K6."""
    args = (x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo)
    if _cuda.kernel_device("fused_eval_1d_df", q_hi) == "cpu":
        return eval_xla_df(*args)
    return _launch_eval(*args)


def fused_index_frac_df(x_hi, x_lo, q_hi, q_lo):
    """``(idx, t_hi, t_lo)`` of the queries against the knots, all pairs:
    idx int32 in ``[0, n-2]`` (NaN -> 0), ``t = (q - x_l) / (x_r - x_l)``
    as a pair.  CPU tensors: :func:`_df_index_frac_xla`; CUDA: K7."""
    if _cuda.kernel_device("fused_index_frac_df", q_hi) == "cpu":
        return _df_index_frac_xla(x_hi, x_lo, q_hi, q_lo)
    return _launch_index_frac(x_hi, x_lo, q_hi, q_lo)


def gathered_df_tail(packed, idx, t_hi, t_lo, bank):
    """Row ``idx`` of the :func:`pack_bank_rows_df` table for each query,
    evaluated at its fraction ``(t_hi, t_lo)``: the ``(nq, bank)`` result
    pair.  CPU tensors: :func:`_df_tail_plain`; CUDA: K8, which gathers the
    rows itself, on the queries ordered by interval when the batch is
    large."""
    if _cuda.kernel_device("gathered_df_tail", t_hi) == "cpu":
        return _df_tail_plain(packed, idx, t_hi, t_lo, bank)
    return _launch_tail("ndi_df_bank_tail", gathered_df_tail, 8, packed, idx, t_hi, t_lo, bank)


def _gathered_df_tail_f64(packed, idx, t_hi, t_lo, bank):
    """:func:`gathered_df_tail` recombined to float64 (``df_to_f64`` of the
    pair, bit for bit), which K8 writes itself on CUDA (its float64 store
    form, counted in ``gathered_df_tail.launches``).  CPU tensors: the plain
    version's pair, recombined."""
    if _cuda.kernel_device("gathered_df_tail", t_hi) == "cpu":
        return df_to_f64(*_df_tail_plain(packed, idx, t_hi, t_lo, bank))
    return _launch_tail("ndi_df_bank_tail", gathered_df_tail, 8, packed, idx, t_hi, t_lo, bank,
                        f64=True)


def gathered_f48_tail(packed, idx, t_hi, t_lo, bank):
    """:func:`gathered_df_tail` on a :func:`pack_bank_rows_f48` table.
    CPU tensors: :func:`_f48_tail_plain`; CUDA: K9, on the queries ordered
    by interval when the batch is large."""
    if _cuda.kernel_device("gathered_f48_tail", t_hi) == "cpu":
        return _f48_tail_plain(packed, idx, t_hi, t_lo, bank)
    return _launch_tail("ndi_f48_bank_tail", gathered_f48_tail, 6, packed, idx, t_hi, t_lo, bank)


def _gathered_f48_tail_f64(packed, idx, t_hi, t_lo, bank):
    """:func:`gathered_f48_tail` recombined to float64, as
    :func:`_gathered_df_tail_f64` is for K8: K9's float64 store form on
    CUDA (counted in ``gathered_f48_tail.launches``)."""
    if _cuda.kernel_device("gathered_f48_tail", t_hi) == "cpu":
        return df_to_f64(*_f48_tail_plain(packed, idx, t_hi, t_lo, bank))
    return _launch_tail("ndi_f48_bank_tail", gathered_f48_tail, 6, packed, idx, t_hi, t_lo, bank,
                        f64=True)


fused_eval_1d_df.launches = 0
fused_index_frac_df.launches = 0
gathered_df_tail.launches = 0
gathered_f48_tail.launches = 0


# -- routes --------------------------------------------------------------------------
def gathered_bank_eval_df_packed(x_hi, x_lo, packed, bank, q_hi, q_lo):
    """The banked double-float route from a prepacked
    :func:`pack_bank_rows_df` table: K7, then K8.  Flat queries; returns the
    ``(nq, bank)`` result pair."""
    idx, th, tl = fused_index_frac_df(x_hi, x_lo, q_hi, q_lo)
    return gathered_df_tail(packed, idx, th, tl, bank)


def _gathered_bank_eval_df_packed_f64(x_hi, x_lo, packed, bank, q_hi, q_lo):
    """:func:`gathered_bank_eval_df_packed` with K8's float64 store form:
    the ``(nq, bank)`` float64 ``df_to_f64`` of its pair."""
    idx, th, tl = fused_index_frac_df(x_hi, x_lo, q_hi, q_lo)
    return _gathered_df_tail_f64(packed, idx, th, tl, bank)


def gathered_bank_eval_f48_packed(x_hi, x_lo, packed, bank, q_hi, q_lo):
    """The f48 banked route from a prepacked :func:`pack_bank_rows_f48`
    table: K7, then K9.  Flat queries; returns the ``(nq, bank)`` result
    pair, ~2^-33 scale-relative."""
    idx, th, tl = fused_index_frac_df(x_hi, x_lo, q_hi, q_lo)
    return gathered_f48_tail(packed, idx, th, tl, bank)


def _gathered_bank_eval_f48_packed_f64(x_hi, x_lo, packed, bank, q_hi, q_lo):
    """:func:`gathered_bank_eval_f48_packed` with K9's float64 store form:
    the ``(nq, bank)`` float64 ``df_to_f64`` of its pair."""
    idx, th, tl = fused_index_frac_df(x_hi, x_lo, q_hi, q_lo)
    return _gathered_f48_tail_f64(packed, idx, th, tl, bank)


def gathered_bank_eval_df(x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo):
    """The banked double-float route from the data and coefficient pairs
    (``(n, bank)`` and ``(n-1, bank)``): packs the table, then
    :func:`gathered_bank_eval_df_packed`."""
    packed = pack_bank_rows_df(d_hi, d_lo, a_hi, a_lo, b_hi, b_lo)
    return gathered_bank_eval_df_packed(x_hi, x_lo, packed, d_hi.shape[1], q_hi, q_lo)


def eval_df_from_f64(x64, d64, a64, b64, q64, device=None):
    """Split float64 knots, data, coefficients and queries into pairs, run
    :func:`fused_eval_1d_df`, recombine to float64.  Tensors keep their
    device; other inputs go to ``device`` (default: the GPU; without one
    this raises unless ``device="cpu"`` is named)."""
    device = default_device(q64, device)
    args = []
    for v in (x64, d64, a64, b64, q64):
        args.extend(df_from_f64(torch.as_tensor(v, dtype=torch.float64, device=device)))
    return df_to_f64(*fused_eval_1d_df(*args))
