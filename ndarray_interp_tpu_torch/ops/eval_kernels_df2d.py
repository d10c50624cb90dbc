"""f64-grade 2-D evaluation on the GPU: wrappers of K10-K14 and R4c.

Counterpart of the 2-D part of ``ndarray_interp_tpu.ops.pallas_eval_df``
(and of ``ops/df_records.py``), with its names and signatures: every value
crosses the interface as an ``(hi, lo)`` float32 pair (``ops/df.py``).  The
CUDA kernels are in ``csrc/df2d_kernels.cu``.  Each gathers its query's
row(s) from a packed table, widens every pair once to float64 (exact) and
computes natively in FP64, where the TPU kernels ran error-free transforms
on float32 and one-hot matrix products:

* :func:`gathered_bilinear_df_tail` (K10) and
  :func:`gathered_bilinear_f48_tail` (K11): bilinear on a
  :func:`pack_bilinear_rows_df` / :func:`pack_bilinear_rows_f48` table, in
  the lerp form ``z1 + t·(z2 - z1)``, x first, then y
  (:func:`_df_bilinear_core`, the form and order of the JAX record tail
  ``_df_bilinear_tail_kernel`` too, R4a);
* :func:`gathered_bicubic_df_tail` (K12) and
  :func:`gathered_bicubic_f48_tail` (K13): the tensor-product Hermite of a
  :func:`pack_bicubic_rows_df` / :func:`pack_bicubic_rows_f48` table of
  bicubic cell rows, five nested scaled Hermite forms (the form and order
  of the JAX ``_df_bicubic_tail_kernel`` too, R4b);
* :func:`gathered_bicubic_df_weight_tail` (R4c): the same function in the
  weight form of the JAX record ``df_records._df_bicubic_weight_tail``: 16
  tensor-product Hermite weights a query, summed against the 16 cell-row
  blocks one block after another;
* :func:`gathered_bicubic_node_df_tail` (K14): the same Hermite forms from
  the four node rows of a :func:`pack_bicubic_nodes_df` table (the
  memory-frugal node layout), the derivatives scaled by the interval widths
  that the rows' own coordinates give.

A cell kernel takes the table, both axes' interval indices (from K7), the
y knot count and the four fraction halves, computes the cell
``xi·(ny-1) + yi`` itself and writes a ``(Q, bp)`` result pair (``bp``: the
channel count padded to a multiple of 8); the routes slice it to the ``r``
channels.  K14 fetches the nodes ``xi·ny + yi``, ``+1``, ``+ny`` and
``+ny+1`` and writes ``(Q, r)``.  The JAX routes gather the rows with XLA
first and run their tail kernels on them.

K12, K13, K14 and R4c order a large batch by cell first (:mod:`.cell_order`,
a counting sort on the card) and run on the ordered records, so that the
queries of one cell share their row's fetch; each result still goes to its
query's own slot.  Smaller batches, and tables of narrow rows, run
unordered (:func:`_orders`); K10 and K11, whose rows are narrower than any
that ordering wins on, always do.  The private entries ``_gathered_bilinear_df_tail_f64``,
``_gathered_bilinear_f48_tail_f64``, ``_gathered_bicubic_f48_tail_f64``
and their routes ``_gathered_*_packed_f64`` take the float64 store form of
K10, K11 and K13: the kernel writes ``df_to_f64`` of its result pair, bit
for bit, into one float64 array, which ``DoubleFloatEvaluator2D`` returns
without widening and adding the pair itself.

Each kernel's plain version is here, in PyTorch float64 and the kernel's
operation order: :func:`_df_bilinear_xla_tail` (on rows gathered with
``index_select``) for K10, the same after :func:`_unpack_f48_lo` for K11,
:func:`_df_bicubic_tail` for K12 and, unpacked, K13 (on ordered records
:func:`_bicubic_df_tail_ordered_plain`, :func:`_bicubic_f48_tail_ordered_plain`),
:func:`_df_bicubic_weight_tail` for R4c (on ordered records
:func:`_bicubic_df_weight_tail_ordered_plain`), :func:`_df_node_tail` for K14.  A
wrapper runs the plain version for CPU tensors and launches its
kernel for CUDA tensors; the kernels are bit-identical to the plain
versions.  Each wrapper calls the ``torch.library`` op
``ndarray_interp::df_cell_tail`` (or its ``_f64`` form) with its tail's
``form`` (:data:`_TAILS`): the plain version for CPU tensors, the kernel,
ordered where :func:`_orders` says so at run time, for CUDA tensors; its
backward is the VJP of the plain version, and under ``vmap`` batched
queries flatten into one launch.  ``launches`` on each wrapper counts its
kernel's launches.  The routes' placement rules over DTensor (K7 twice +
K10-K14) are in :mod:`.partition`.

Not ported: the JAX node route's ``chunk`` option, which bounds XLA's
memory for the intermediates of its tail (the kernel keeps none), and its
``fetch="pair"`` option, a measured-negative record of the TPU.

As in 1-D, the fraction is computed in float64: a ±inf query gives
``t = ±inf`` where the JAX double-float fraction is NaN.
"""

from __future__ import annotations

import functools
import math
import operator

import torch
import torch.nn.functional as F

from . import _cuda
from .cell_order import order_by_cell, record_fields
from .df import df_from_f64, df_to_f64
from .eval_kernels_df import (
    _as_f32_bits,
    _bank_pad,
    _bf16_bits,
    _gather_rows,
    _scatter_back,
    _unpack_f48_lo,
    fused_index_frac_df,
)


# -- packed row tables ------------------------------------------------------------
def _bilinear_corner_blocks(g, bp):
    """Corner blocks ``((nx-1)(ny-1), 4·bp)`` of ``g``: ``[z11|z12|z21|z22]``
    with trailing dims flattened and padded with zeros to ``bp``."""
    nx, ny = g.shape[0], g.shape[1]
    r = math.prod(g.shape[2:])
    g = g.reshape(nx, ny, r)
    quad = torch.stack([g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]], dim=2)
    return F.pad(quad, (0, bp - r)).reshape((nx - 1) * (ny - 1), 4 * bp)


def pack_bilinear_rows_df(z_hi, z_lo):
    """Double-float per-cell corner rows ``((nx-1)(ny-1), 8·bp)``: the four
    hi corner blocks, then the four lo blocks; ``z`` is ``(nx, ny,
    *trailing)`` pairs.  Bit-identical to the JAX package's table."""
    bp = _bank_pad(math.prod(z_hi.shape[2:]))
    return torch.cat(
        [_bilinear_corner_blocks(z_hi, bp), _bilinear_corner_blocks(z_lo, bp)], dim=1
    )


def pack_bilinear_rows_f48(z_hi, z_lo):
    """"f48" corner rows ``((nx-1)(ny-1), 6·bp)``: the four hi blocks of
    :func:`pack_bilinear_rows_df`, then the four lo blocks rounded to
    bfloat16 and packed two to a float32 lane: ``[z11_lo | z12_lo]`` in the
    high 16 bits of the ``2·bp`` packed lanes, ``[z21_lo | z22_lo]`` in the
    low 16.  Bit-identical to the JAX package's table."""
    bp = _bank_pad(math.prod(z_hi.shape[2:]))
    lo16 = _bf16_bits(_bilinear_corner_blocks(z_lo, bp))
    half = 2 * bp
    packed_lo = _as_f32_bits((lo16[:, :half] << 16) | lo16[:, half:])
    return torch.cat([_bilinear_corner_blocks(z_hi, bp), packed_lo], dim=1)


def _bicubic_blocks(v, r):
    cells = v.shape[0]
    bp = _bank_pad(r)
    return F.pad(v.reshape(cells, 16, r), (0, bp - r)).reshape(cells, 16 * bp)


def pack_bicubic_rows_df(rows_hi, rows_lo, r):
    """Double-float bicubic cell rows ``(cells, 32·bp)``: the 16 pre-scaled
    corner-quantity blocks of the cell layout
    (``models/strategies/bicubic.pack_bicubic_rows``) hi, then lo, each
    ``r``-block padded to ``bp``.  Bit-identical to the JAX package's
    table."""
    return torch.cat([_bicubic_blocks(rows_hi, r), _bicubic_blocks(rows_lo, r)], dim=1)


def pack_bicubic_rows_f48(rows_hi, rows_lo, r):
    """"f48" bicubic cell rows ``(cells, 24·bp)``: the 16 hi blocks of
    :func:`pack_bicubic_rows_df`, then the 16 lo blocks rounded to bfloat16
    and packed two to a float32 lane: packed lane ``l`` of the ``8·bp``-lane
    section holds lo block ``l // bp`` in its high 16 bits and lo block
    ``l // bp + 8`` in its low 16.  Bit-identical to the JAX package's
    table."""
    lo16 = _bf16_bits(_bicubic_blocks(rows_lo, r))
    half = 8 * _bank_pad(r)
    packed_lo = _as_f32_bits((lo16[:, :half] << 16) | lo16[:, half:])
    return torch.cat([_bicubic_blocks(rows_hi, r), packed_lo], dim=1)


def pack_bicubic_nodes_df(nodes_hi, nodes_lo):
    """Double-float node table ``(nx·ny, 8r+4)`` from the pairs of a
    node-layout ``BicubicStrategy.rows`` table ``(nx·ny, 4r+2)`` (raw
    ``[f | kx | ky | kxy]`` and the node's ``(x, y)``), block-interleaved:
    ``[f_hi|f_lo|kx_hi|kx_lo|ky_hi|ky_lo|kxy_hi|kxy_lo|x_hi,x_lo,y_hi,y_lo]``.
    Bit-identical to the JAX package's table."""
    r = (nodes_hi.shape[1] - 2) // 4
    parts = []
    for i in range(4):
        parts += [nodes_hi[:, i * r : (i + 1) * r], nodes_lo[:, i * r : (i + 1) * r]]
    for j in (0, 1):
        parts += [nodes_hi[:, 4 * r + j : 4 * r + j + 1], nodes_lo[:, 4 * r + j : 4 * r + j + 1]]
    return torch.cat(parts, dim=1)


# -- plain versions -------------------------------------------------------------------
def _df_bilinear_core(z11, z12, z21, z22, tx, ty):
    """Bilinear in float64, the lerp form ``z1 + t·(z2 - z1)``: along x at
    both y-knots, then along y."""
    zq1 = z11 + tx * (z21 - z11)
    zq2 = z12 + tx * (z22 - z12)
    return zq1 + ty * (zq2 - zq1)


def _df_bilinear_xla_tail(rows, txh, txl, tyh, tyl, r):
    """Bilinear on gathered :func:`pack_bilinear_rows_df` rows
    ``(Q, 8·bp)`` at the fraction pairs, in float64: the ``(Q, r)`` result
    pair."""
    bp = rows.shape[1] // 8

    def corner(i):
        return df_to_f64(rows[:, i * bp : i * bp + r], rows[:, (i + 4) * bp : (i + 4) * bp + r])

    tx = df_to_f64(txh, txl)[:, None]
    ty = df_to_f64(tyh, tyl)[:, None]
    return df_from_f64(_df_bilinear_core(*(corner(i) for i in range(4)), tx, ty))


def _df_hermite_scaled(y_l, y_r, K_l, K_r, t):
    """Hermite with pre-scaled derivatives, in float64:
    ``dy = y_r - y_l; a = K_l - dy; b = dy - K_r; u = 1 - t``, then
    ``(u·y_l + t·y_r) + (t·u)·(a·u + b·t)``."""
    dy = y_r - y_l
    a = K_l - dy
    b = dy - K_r
    u = 1.0 - t
    return (u * y_l + t * y_r) + (t * u) * (a * u + b * t)


def _df_bicubic_tail(rows, txh, txl, tyh, tyl, bp):
    """The bicubic tail on gathered :func:`pack_bicubic_rows_df` rows
    ``(Q, 32·bp)`` at the fraction pairs ``(Q,)``, in float64: the ``(Q, bp)``
    result pair.  Block ``4i + c`` holds quantity ``i`` of ``[f, kx, ky,
    kxy]`` at corner ``c`` of ``[11, 12, 21, 22]``."""

    def q(i):
        return [
            df_to_f64(rows[:, b * bp : (b + 1) * bp], rows[:, (b + 16) * bp : (b + 17) * bp])
            for b in range(4 * i, 4 * i + 4)
        ]

    f, kx, ky, kxy = q(0), q(1), q(2), q(3)
    tx = df_to_f64(txh, txl)[:, None]
    ty = df_to_f64(tyh, tyl)[:, None]
    f_y1 = _df_hermite_scaled(f[0], f[2], kx[0], kx[2], tx)
    f_y2 = _df_hermite_scaled(f[1], f[3], kx[1], kx[3], tx)
    g_y1 = _df_hermite_scaled(ky[0], ky[2], kxy[0], kxy[2], tx)
    g_y2 = _df_hermite_scaled(ky[1], ky[3], kxy[1], kxy[3], tx)
    return df_from_f64(_df_hermite_scaled(f_y1, f_y2, g_y1, g_y2, ty))


def _df_hermite_basis(t):
    """The four scaled-Hermite weights of ``(y_l, y_r, K_l, K_r)`` in
    float64: ``u = 1 - t``, ``d = u - t``, ``p = t·u``, ``pd = p·d``, giving
    ``[u + pd, t - pd, p·u, -(p·t)]`` (the closed form of
    :func:`_df_hermite_scaled`, another rounding)."""
    u = 1.0 - t
    d = u - t
    p = t * u
    pd = p * d
    return u + pd, t - pd, p * u, -(p * t)


def _df_bicubic_weights(tx, ty):
    """The 16 tensor-product weights, one per cell-row block ``4i + c``
    (quantity ``i`` of ``[f, kx, ky, kxy]``, corner ``c`` of ``[11, 12, 21,
    22]``): ``W[4i + c] = Ax[i][c >> 1] · Ay[i][c & 1]``, with ``Ax`` the
    value basis of x for ``i`` in {0, 2} and its derivative basis for {1,
    3}, ``Ay`` the value basis of y for {0, 1} and its derivative basis for
    {2, 3}."""
    bx = _df_hermite_basis(tx)
    by = _df_hermite_basis(ty)
    w16 = []
    for i in range(4):
        ax = bx[:2] if i in (0, 2) else bx[2:]
        ay = by[:2] if i in (0, 1) else by[2:]
        w16 += [ax[c >> 1] * ay[c & 1] for c in range(4)]
    return w16


def _df_bicubic_weight_tail(rows, txh, txl, tyh, tyl, bp):
    """The weight-form bicubic tail on gathered :func:`pack_bicubic_rows_df`
    rows ``(Q, 32·bp)`` at the fraction pairs ``(Q,)``, in float64:
    ``s = W[0]·v[0]``, then ``s = s + W[b]·v[b]`` for ``b = 1 … 15``, each
    block ``v[b]`` widened from its hi and lo halves first (the block order
    of the JAX record's Mosaic branch).  Returns the ``(Q, bp)`` result
    pair."""
    w16 = _df_bicubic_weights(df_to_f64(txh, txl)[:, None], df_to_f64(tyh, tyl)[:, None])
    s = None
    for b, w in enumerate(w16):
        term = w * df_to_f64(rows[:, b * bp : (b + 1) * bp], rows[:, (b + 16) * bp : (b + 17) * bp])
        s = term if s is None else s + term
    return df_from_f64(s)


def _cells(packed, xi, yi, ny):
    return _gather_rows(packed, xi.long() * (ny - 1) + yi.long())


def _unpack_rows(rows, hi_blocks):
    """Rows with their bf16-pair lo section unpacked to float32."""
    bp = rows.shape[1] // (hi_blocks * 3 // 2)
    split = hi_blocks * bp
    return torch.cat([rows[:, :split], _unpack_f48_lo(rows[:, split:])], dim=1)


def _bilinear_df_tail_plain(packed, xi, yi, ny, txh, txl, tyh, tyl):
    """Plain version of K10: :func:`_df_bilinear_xla_tail` on the gathered
    rows, all ``bp`` channels."""
    rows = _cells(packed, xi, yi, ny)
    return _df_bilinear_xla_tail(rows, txh, txl, tyh, tyl, rows.shape[1] // 8)


def _bilinear_f48_tail_plain(packed, xi, yi, ny, txh, txl, tyh, tyl):
    """Plain version of K11: :func:`_bilinear_df_tail_plain` on the rows of
    a :func:`pack_bilinear_rows_f48` table, lo halves unpacked."""
    rows = _unpack_rows(_cells(packed, xi, yi, ny), 4)
    return _df_bilinear_xla_tail(rows, txh, txl, tyh, tyl, rows.shape[1] // 8)


def _bicubic_df_tail_plain(packed, xi, yi, ny, txh, txl, tyh, tyl):
    """Plain version of K12: :func:`_df_bicubic_tail` on the gathered rows."""
    rows = _cells(packed, xi, yi, ny)
    return _df_bicubic_tail(rows, txh, txl, tyh, tyl, rows.shape[1] // 32)


def _bicubic_df_weight_tail_plain(packed, xi, yi, ny, txh, txl, tyh, tyl):
    """Plain version of R4c: :func:`_df_bicubic_weight_tail` on the gathered
    rows."""
    rows = _cells(packed, xi, yi, ny)
    return _df_bicubic_weight_tail(rows, txh, txl, tyh, tyl, rows.shape[1] // 32)


def _bicubic_f48_tail_plain(packed, xi, yi, ny, txh, txl, tyh, tyl):
    """Plain version of K13: :func:`_df_bicubic_tail` on the rows of a
    :func:`pack_bicubic_rows_f48` table, lo halves unpacked."""
    rows = _unpack_rows(_cells(packed, xi, yi, ny), 16)
    return _df_bicubic_tail(rows, txh, txl, tyh, tyl, rows.shape[1] // 32)


def _df_node_tail(g11, g12, g21, g22, txh, txl, tyh, tyl, r):
    """The bicubic tail on four gathered :func:`pack_bicubic_nodes_df`
    rows ``(Q, 8r+4)`` at the fraction pairs ``(Q,)``, in float64: interval
    widths from the rows' coordinates, the derivatives scaled by them
    (``k·dx``), then the five nested scaled Hermite forms.  Returns the
    ``(Q, r)`` result pair."""

    def unpack(g):
        blocks = [df_to_f64(g[:, 2 * i * r : (2 * i + 1) * r], g[:, (2 * i + 1) * r : (2 * i + 2) * r])
                  for i in range(4)]
        coords = [df_to_f64(g[:, 8 * r + 2 * j : 8 * r + 2 * j + 1],
                            g[:, 8 * r + 2 * j + 1 : 8 * r + 2 * j + 2]) for j in (0, 1)]
        return (*blocks, *coords)

    f11, kx11, ky11, kxy11, x1, y1 = unpack(g11)
    f12, kx12, ky12, kxy12, _, y2 = unpack(g12)
    f21, kx21, ky21, kxy21, x2, _ = unpack(g21)
    f22, kx22, ky22, kxy22, _, _ = unpack(g22)
    dx = x2 - x1
    dy = y2 - y1
    tx = df_to_f64(txh, txl)[:, None]
    ty = df_to_f64(tyh, tyl)[:, None]
    f_y1 = _df_hermite_scaled(f11, f21, kx11 * dx, kx21 * dx, tx)
    f_y2 = _df_hermite_scaled(f12, f22, kx12 * dx, kx22 * dx, tx)
    g_y1 = _df_hermite_scaled(ky11, ky21, kxy11 * dx, kxy21 * dx, tx)
    g_y2 = _df_hermite_scaled(ky12, ky22, kxy12 * dx, kxy22 * dx, tx)
    return df_from_f64(_df_hermite_scaled(f_y1, f_y2, g_y1 * dy, g_y2 * dy, ty))


def _bicubic_node_df_tail_plain(packed, xi, yi, ny, txh, txl, tyh, tyl):
    """Plain version of K14: :func:`_df_node_tail` on the node rows
    ``xi·ny + yi``, ``+1``, ``+ny``, ``+ny+1`` (each clamped to the table)."""
    base = xi.long() * ny + yi.long()
    g = [_gather_rows(packed, base + off) for off in (0, 1, ny, ny + 1)]
    return _df_node_tail(*g, txh, txl, tyh, tyl, (packed.shape[1] - 4) // 8)


def _bicubic_df_tail_ordered_plain(packed, records):
    """Plain version of K12 on ordered records (:mod:`.cell_order`): the
    rows of the records' cells, :func:`_df_bicubic_tail` at their fraction
    halves, each result put back at its query's slot."""
    cell, qid, frac = record_fields(records)
    rows = _gather_rows(packed, cell)
    hi, lo = _df_bicubic_tail(rows, *frac.unbind(1), rows.shape[1] // 32)
    return _scatter_back(hi, lo, qid)


def _bicubic_df_weight_tail_ordered_plain(packed, records):
    """Plain version of R4c on ordered records: the rows of the records'
    cells, :func:`_df_bicubic_weight_tail` at their fraction halves, each
    result put back at its query's slot."""
    cell, qid, frac = record_fields(records)
    rows = _gather_rows(packed, cell)
    hi, lo = _df_bicubic_weight_tail(rows, *frac.unbind(1), rows.shape[1] // 32)
    return _scatter_back(hi, lo, qid)


def _bicubic_f48_tail_ordered_plain(packed, records):
    """Plain version of K13 on ordered records: the rows of the records'
    cells, lo halves unpacked, :func:`_df_bicubic_tail` at their fraction
    halves, each result put back at its query's slot."""
    cell, qid, frac = record_fields(records)
    rows = _unpack_rows(_gather_rows(packed, cell), 16)
    hi, lo = _df_bicubic_tail(rows, *frac.unbind(1), rows.shape[1] // 32)
    return _scatter_back(hi, lo, qid)


def _bicubic_node_df_tail_ordered_plain(packed, ny, records):
    """Plain version of K14 on ordered records: the node rows ``v``, ``v+1``,
    ``v+ny``, ``v+ny+1`` of each record's base ``v`` (each clamped to the
    table), :func:`_df_node_tail`, each result put back at its query's
    slot."""
    base, qid, frac = record_fields(records)
    g = [_gather_rows(packed, base.long() + off) for off in (0, 1, ny, ny + 1)]
    hi, lo = _df_node_tail(*g, *frac.unbind(1), (packed.shape[1] - 4) // 8)
    return _scatter_back(hi, lo, qid)


# -- kernel launches -----------------------------------------------------------------
# K12, K13, K14 and R4c order a batch by cell first (``cell_order.order_by_cell``)
# when a query reads at least _ORDER_MIN_ROW_BYTES of rows (one cell row; four
# node rows; K13: _ORDER_MIN_ROW_BYTES_F48) and the batch at least
# _ORDER_MIN_BYTES.  Ordering saves the HBM re-reads of rows that the L2 (50
# MB on an H100) no longer holds when their next query comes, and costs ~0.062
# ms a 1M batch.  Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
# --sweeps, ordered with the ordering included / unordered body): at 2 KiB of
# rows a query the ordered branch overtakes the unordered body between 2^17
# and 2^18 queries (256 and 512 MiB of rows, 5 and 10 times the L2): K12
# 0.1062 / 0.1001 and 0.1615 / 0.1935 ms, R4c 0.1054 / 0.1068 and 0.1657 /
# 0.2056, K14 0.1207 / 0.1240 and 0.1891 / 0.2398; so it does at K13's 1.5 KiB
# (0.0881 / 0.0747, 0.1395 / 0.1445); at 1M queries K12 and K14 win from 1 KiB
# a query (K12 at bp 8 0.2454 / 0.3904, K14 at 8 channels 0.2965 / 0.5059) and
# K14 loses below (3 and 4 channels, 448 and 576 B: 0.2431 / 0.2097, 0.3988 /
# 0.2712), while K13, whose ordered kernel widens a cell's row once for the
# run of queries on it, wins at its smallest row, 768 B (bp 8: 0.2413 /
# 0.2852).  K10 and K11 have no ordered branch: on that row-cached kernel
# their 2-D serving rows (512 and 384 B at bp 16) lost at every batch size
# (1M queries: K10 0.2183 ordered, 0.1942 in query order), the results
# written to scattered query slots costing about what the row re-reads saved.
_ORDER_MIN_BYTES = 384 << 20
_ORDER_MIN_ROW_BYTES = 1024
_ORDER_MIN_ROW_BYTES_F48 = 768


def _orders(nq, fetched, min_row):
    """Whether a batch of ``nq`` queries reading ``fetched`` bytes of rows
    each (at least ``min_row``) is ordered by cell first."""
    return fetched >= min_row and nq * fetched >= _ORDER_MIN_BYTES


def _launch_tail(symbol, wrapper, blocks, packed, xi, yi, ny, txh, txl, tyh, tyl, ordered, f64,
                 min_row):
    """Check the operands and launch a 2-D tail: a cell tail on a table of
    ``blocks·bp`` channels, or (``blocks=None``) K14 on a node table of
    ``8r+4`` channels.  ``ordered`` names the kernel on ordered records that
    takes the batches :func:`_orders` picks at ``min_row`` (K12, K13, K14, R4c).
    ``f64`` (K10, K11, K13) takes the kernels' float64 store form: one
    ``(nq, bp)`` float64 output, the pair's ``hi + lo``."""
    name = wrapper.__name__
    _cuda.pair_operands(name, txh, txl, tyh, tyl, packed)
    for what, idx in (("xi", xi), ("yi", yi)):
        if idx.dtype != torch.int32 or idx.device != txh.device:
            raise TypeError(f"{name}: {what} must be torch.int32 on {txh.device}")
    ch = packed.shape[-1]
    if blocks is None:  # K14 writes r channels and steps ny nodes a row of x
        width, ragged, bp, row_step = "8r+4", (ch - 4) % 8, (ch - 4) // 8, ny
        fetched, lo = 4 * 4 * ch, -(ny + 1)
    else:  # a cell tail writes bp channels and steps ny - 1 cells a row of x
        width, ragged, bp, row_step = f"{blocks}·bp", ch % blocks, ch // blocks, ny - 1
        fetched, lo = 4 * ch, 0
    if packed.ndim != 2 or ragged:
        raise ValueError(
            f"{name}: packed must have shape (rows, {width}), got {tuple(packed.shape)}"
        )
    if ny < 2:
        raise ValueError(f"{name}: ny must be at least 2, got {ny}")
    if not (xi.shape == yi.shape == txh.shape == txl.shape == tyh.shape == tyl.shape) or (
        xi.ndim != 1
    ):
        raise ValueError(f"{name}: xi, yi and the fraction halves must be flat and of one length")
    nq, dev = xi.shape[0], txh.device
    if f64:  # the kernel's float64 store form: one output, out_lo null
        out = (torch.empty((nq, bp), dtype=torch.float64, device=dev), None)
    else:
        out = tuple(torch.empty((nq, bp), dtype=torch.float32, device=dev) for _ in range(2))
    packed = packed.contiguous()
    if ordered is not None and _orders(nq, fetched, min_row):
        records = order_by_cell(xi, yi, row_step, lo, packed.shape[0], txh, txl, tyh, tyl)
        _launch_ordered(ordered, packed, bp, ny, records, *out)
    else:
        _cuda.launch(
            symbol, torch.float32, dev,
            packed, packed.shape[0], packed.shape[1], bp, xi.contiguous(), yi.contiguous(),
            row_step, *(v.contiguous() for v in (txh, txl, tyh, tyl)), *out, nq,
        )
    wrapper.launches += 1
    return out[0] if f64 else out


def _launch_ordered(symbol, packed, bp, ny, records, out_hi, out_lo):
    """Launch K12, K13 or K14 on the records of
    :func:`~.cell_order.order_by_cell`, into the ``(nq, bp)`` outputs
    (``out_lo`` ``None``: ``out_hi`` is the float64 store form's)."""
    if packed.data_ptr() % 16:  # the rows are read with 16-byte loads
        packed = packed.clone()
    _cuda.launch(
        symbol, torch.float32, records.device,
        packed, packed.shape[0], packed.shape[1], bp, ny, records.contiguous(), out_hi, out_lo,
        records.shape[0],
    )


# -- the ops -------------------------------------------------------------------------
def _tail_plain(form, packed, xi, yi, ny, txh, txl, tyh, tyl):
    return _TAILS[form][0](packed, xi, yi, ny, txh, txl, tyh, tyl)


def _tail_f64_plain(*args):
    return df_to_f64(*_tail_plain(*args))


def _tail_launch(form, *args, f64=False):
    _, symbol, blocks, ordered, min_row, wrapper = _TAILS[form]
    return _launch_tail(symbol, wrapper, blocks, *args, ordered, f64, min_row)


def _tail_fake(form, packed, xi, yi, ny, txh, txl, tyh, tyl):
    """The ``(nq, bp)`` outputs: ``bp`` from the table's width, as the
    launch takes it (K14: its ``8r+4`` channels give ``r``)."""
    blocks, ch = _TAILS[form][2], packed.shape[1]
    bp = (ch - 4) // 8 if blocks is None else ch // blocks
    return txh.new_empty((xi.shape[0], bp)), txh.new_empty((xi.shape[0], bp))


_TAIL_SCHEMA = ("(str form, Tensor packed, Tensor xi, Tensor yi, int ny, Tensor tx_hi, "
                "Tensor tx_lo, Tensor ty_hi, Tensor ty_lo)")
_TAIL_QUERIES = (2, 3, 5, 6, 7, 8)
# K10-K14 and R4c, the tail ``form`` of _TAILS, in their two store forms: forward
# the kernel (its plain version on the CPU), the ordering of a large batch
# inside it; under vmap batched indices and fractions flatten into one launch,
# a batched table takes the plain version
_TAIL = _cuda.kernel_op(
    "df_cell_tail", _TAIL_SCHEMA + " -> (Tensor, Tensor)",
    lambda form, *a: _cuda.run(_TAILS[form][5].__name__, a[4], _tail_launch, _tail_plain,
                               form, *a),
    _tail_fake,
    setup_context=_cuda.save_operands, backward=_cuda.plain_backward(_tail_plain),
    vmap=_cuda.query_rule(_tail_plain, _TAIL_QUERIES),
)
_TAIL_F64 = _cuda.kernel_op(
    "df_cell_tail_f64", _TAIL_SCHEMA + " -> Tensor",
    lambda form, *a: _cuda.run(_TAILS[form][5].__name__, a[4],
                               functools.partial(_tail_launch, f64=True), _tail_f64_plain,
                               form, *a),
    lambda *a: _tail_fake(*a)[0].to(torch.float64),
    setup_context=_cuda.save_operands, backward=_cuda.plain_backward(_tail_f64_plain),
    vmap=_cuda.query_rule(_tail_f64_plain, _TAIL_QUERIES),
)


# -- public wrappers ---------------------------------------------------------------
def _tail(form, args, f64=False):
    """The tail ``form`` of :data:`_TAILS` on ``args`` (table, xi, yi, ny
    and the four fraction halves): CPU tensors run its plain version (the
    pair recombined to float64 where ``f64``), CUDA tensors its kernel."""
    packed, xi, yi, ny, *fracs = args
    return (_TAIL_F64 if f64 else _TAIL)(form, packed, xi, yi, operator.index(ny), *fracs)


def gathered_bilinear_df_tail(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """Cell ``xi·(ny-1) + yi`` of the :func:`pack_bilinear_rows_df` table for
    each query, evaluated at its fractions: the ``(nq, bp)`` result pair.
    ``ny`` is the y knot count.  CPU tensors: :func:`_bilinear_df_tail_plain`;
    CUDA: K10, which gathers the rows itself."""
    return _tail("bilinear_df", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo))


def gathered_bilinear_f48_tail(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """:func:`gathered_bilinear_df_tail` on a :func:`pack_bilinear_rows_f48`
    table.  CPU tensors: :func:`_bilinear_f48_tail_plain`; CUDA: K11."""
    return _tail("bilinear_f48", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo))


def _gathered_bilinear_df_tail_f64(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """:func:`gathered_bilinear_df_tail` recombined to float64 (``df_to_f64``
    of the pair, bit for bit), which K10 writes itself on CUDA (its float64
    store form, counted in ``gathered_bilinear_df_tail.launches``): the
    ``(nq, bp)`` float64 result.  CPU tensors: the plain version's pair,
    recombined."""
    return _tail("bilinear_df", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo), f64=True)


def _gathered_bilinear_f48_tail_f64(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """:func:`_gathered_bilinear_df_tail_f64` for K11 on a
    :func:`pack_bilinear_rows_f48` table."""
    return _tail("bilinear_f48", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo), f64=True)


def gathered_bicubic_df_tail(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """Cell ``xi·(ny-1) + yi`` of the :func:`pack_bicubic_rows_df` table for
    each query, evaluated at its fractions: the ``(nq, bp)`` result pair.
    CPU tensors: :func:`_bicubic_df_tail_plain`; CUDA: K12, on the queries
    ordered by cell when the batch is large."""
    return _tail("bicubic_df", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo))


def gathered_bicubic_df_weight_tail(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """:func:`gathered_bicubic_df_tail` in the weight form: 16 weights a
    query, summed block by block.  CPU tensors:
    :func:`_bicubic_df_weight_tail_plain`; CUDA: R4c."""
    return _tail("bicubic_weight", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo))


def gathered_bicubic_f48_tail(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """:func:`gathered_bicubic_df_tail` on a :func:`pack_bicubic_rows_f48`
    table.  CPU tensors: :func:`_bicubic_f48_tail_plain`; CUDA: K13."""
    return _tail("bicubic_f48", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo))


def _gathered_bicubic_f48_tail_f64(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """:func:`_gathered_bilinear_df_tail_f64` for K13 on a
    :func:`pack_bicubic_rows_f48` table."""
    return _tail("bicubic_f48", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo), f64=True)


def gathered_bicubic_node_df_tail(packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo):
    """The bicubic patch of the four nodes ``xi·ny + yi``, ``+1``, ``+ny``,
    ``+ny+1`` of the :func:`pack_bicubic_nodes_df` table for each query,
    evaluated at its fractions: the ``(nq, r)`` result pair.  ``ny`` is the
    y knot count.  CPU tensors: :func:`_bicubic_node_df_tail_plain`; CUDA:
    K14, which fetches the node rows itself, on the queries ordered by cell
    when the batch is large."""
    return _tail("bicubic_node", (packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo))


# each form's plain version, kernel, table width in bp (None: K14's 8r+4),
# kernel on ordered records, least row bytes a query that it orders at, and
# the wrapper that counts its launches
_TAILS = {
    "bilinear_df": (_bilinear_df_tail_plain, "ndi_df_bilinear_tail", 8, None, None,
                    gathered_bilinear_df_tail),
    "bilinear_f48": (_bilinear_f48_tail_plain, "ndi_f48_bilinear_tail", 6, None, None,
                     gathered_bilinear_f48_tail),
    "bicubic_df": (_bicubic_df_tail_plain, "ndi_df_bicubic_tail", 32,
                   "ndi_df_bicubic_tail_ordered", _ORDER_MIN_ROW_BYTES, gathered_bicubic_df_tail),
    "bicubic_weight": (_bicubic_df_weight_tail_plain, "ndi_df_bicubic_weight_tail", 32,
                       "ndi_df_bicubic_weight_tail_ordered", _ORDER_MIN_ROW_BYTES,
                       gathered_bicubic_df_weight_tail),
    "bicubic_f48": (_bicubic_f48_tail_plain, "ndi_f48_bicubic_tail", 24,
                    "ndi_f48_bicubic_tail_ordered", _ORDER_MIN_ROW_BYTES_F48,
                    gathered_bicubic_f48_tail),
    "bicubic_node": (_bicubic_node_df_tail_plain, "ndi_df_bicubic_node_tail", None,
                     "ndi_df_bicubic_node_tail_ordered", _ORDER_MIN_ROW_BYTES,
                     gathered_bicubic_node_df_tail),
}

for _form in _TAILS.values():
    _form[5].launches = 0
del _form


# -- routes --------------------------------------------------------------------------
def _df_index_frac_2d(x_hi, x_lo, y_hi, y_lo, qx_hi, qx_lo, qy_hi, qy_lo):
    """Both axes' ``(idx, t_hi, t_lo)`` passes: K7 twice."""
    return (*fused_index_frac_df(x_hi, x_lo, qx_hi, qx_lo),
            *fused_index_frac_df(y_hi, y_lo, qy_hi, qy_lo))


def _tail_args(x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi, qy_lo):
    """K7 on both axes: a 2-D tail's arguments on ``packed``."""
    xi, txh, txl, yi, tyh, tyl = _df_index_frac_2d(
        x_hi, x_lo, y_hi, y_lo, qx_hi, qx_lo, qy_hi, qy_lo
    )
    return packed, xi, yi, y_hi.shape[0], txh, txl, tyh, tyl


def _packed_route(tail, x_hi, x_lo, y_hi, y_lo, packed, r, qx_hi, qx_lo, qy_hi, qy_lo):
    """K7 on both axes, then ``tail``: its ``(nq, r)`` pair."""
    hi, lo = tail(*_tail_args(x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi, qy_lo))
    return hi[:, :r], lo[:, :r]


def _packed_route_f64(tail, x_hi, x_lo, y_hi, y_lo, packed, r, qx_hi, qx_lo, qy_hi, qy_lo):
    """:func:`_packed_route` with a tail in the float64 store form: its
    ``(nq, r)`` float64 result."""
    return tail(*_tail_args(x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi, qy_lo))[:, :r]


def gathered_bilinear_eval_df_packed(x_hi, x_lo, y_hi, y_lo, packed, ny, r,
                                     qx_hi, qx_lo, qy_hi, qy_lo):
    """The double-float bilinear route from a prepacked
    :func:`pack_bilinear_rows_df` table: K7 twice, then K10.  Flat queries;
    returns the ``(nq, r)`` result pair."""
    _check_ny(ny, y_hi)
    return _packed_route(gathered_bilinear_df_tail, x_hi, x_lo, y_hi, y_lo, packed, r,
                         qx_hi, qx_lo, qy_hi, qy_lo)


def gathered_bilinear_eval_f48_packed(x_hi, x_lo, y_hi, y_lo, packed, ny, r,
                                      qx_hi, qx_lo, qy_hi, qy_lo):
    """The f48 bilinear route from a prepacked :func:`pack_bilinear_rows_f48`
    table: K7 twice, then K11; ~2^-33 scale-relative."""
    _check_ny(ny, y_hi)
    return _packed_route(gathered_bilinear_f48_tail, x_hi, x_lo, y_hi, y_lo, packed, r,
                         qx_hi, qx_lo, qy_hi, qy_lo)


def _gathered_bilinear_eval_df_packed_f64(x_hi, x_lo, y_hi, y_lo, packed, ny, r,
                                         qx_hi, qx_lo, qy_hi, qy_lo):
    """:func:`gathered_bilinear_eval_df_packed` with K10's float64 store
    form: the ``(nq, r)`` float64 ``df_to_f64`` of its pair."""
    _check_ny(ny, y_hi)
    return _packed_route_f64(_gathered_bilinear_df_tail_f64, x_hi, x_lo, y_hi, y_lo, packed,
                             r, qx_hi, qx_lo, qy_hi, qy_lo)


def _gathered_bilinear_eval_f48_packed_f64(x_hi, x_lo, y_hi, y_lo, packed, ny, r,
                                          qx_hi, qx_lo, qy_hi, qy_lo):
    """:func:`gathered_bilinear_eval_f48_packed` with K11's float64 store
    form: the ``(nq, r)`` float64 ``df_to_f64`` of its pair."""
    _check_ny(ny, y_hi)
    return _packed_route_f64(_gathered_bilinear_f48_tail_f64, x_hi, x_lo, y_hi, y_lo, packed,
                             r, qx_hi, qx_lo, qy_hi, qy_lo)


def gathered_bilinear_eval_df(x_hi, x_lo, y_hi, y_lo, z_hi, z_lo, qx_hi, qx_lo, qy_hi, qy_lo):
    """The double-float bilinear route from the data pairs ``(nx, ny,
    *trailing)``: packs the table, then
    :func:`gathered_bilinear_eval_df_packed`.  Returns the ``(nq,
    *trailing)`` result pair."""
    packed = pack_bilinear_rows_df(z_hi, z_lo)
    trailing = tuple(z_hi.shape[2:])
    hi, lo = gathered_bilinear_eval_df_packed(
        x_hi, x_lo, y_hi, y_lo, packed, z_hi.shape[1], math.prod(trailing),
        qx_hi, qx_lo, qy_hi, qy_lo,
    )
    nq = qx_hi.shape[0]
    return hi.reshape((nq,) + trailing), lo.reshape((nq,) + trailing)


_BICUBIC_DF_TAILS = {
    "mxu": gathered_bicubic_df_tail,
    "nested": gathered_bicubic_df_tail,
    "weight": gathered_bicubic_df_weight_tail,
}


def gathered_bicubic_eval_df_packed(x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi,
                                    qy_lo, r=1, tail="mxu"):
    """The double-float bicubic route from a prepacked
    :func:`pack_bicubic_rows_df` table: K7 twice, then the tail.  Flat
    queries; returns the ``(nq, r)`` result pair.

    ``tail`` picks the form, on every device (a CPU tensor runs the chosen
    form's plain version): ``"nested"`` the five nested Hermite forms (K12),
    ``"weight"`` the weight form summed block by block (R4c), and ``"mxu"``
    (the default) K12 as well.  On the TPU ``"mxu"`` names a weight form
    summed in a halving tree, an order that served the matrix unit; keeping
    the nested kernel for it moves no value of the shipped route, and the
    JAX package computes the nested form off the TPU whatever the tail.
    Any other value raises ``KeyError``, as the JAX lookup does."""
    kernel = _BICUBIC_DF_TAILS[tail]
    return _packed_route(kernel, x_hi, x_lo, y_hi, y_lo, packed, r, qx_hi, qx_lo, qy_hi, qy_lo)


def gathered_bicubic_eval_f48_packed(x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi,
                                     qy_lo, r=1):
    """The f48 bicubic route from a prepacked :func:`pack_bicubic_rows_f48`
    table: K7 twice, then K13; ~2^-33 scale-relative."""
    return _packed_route(gathered_bicubic_f48_tail, x_hi, x_lo, y_hi, y_lo, packed, r,
                         qx_hi, qx_lo, qy_hi, qy_lo)


def _gathered_bicubic_eval_f48_packed_f64(x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi,
                                          qy_lo, r=1):
    """:func:`gathered_bicubic_eval_f48_packed` with K13's float64 store
    form: the ``(nq, r)`` float64 ``df_to_f64`` of its pair."""
    return _packed_route_f64(_gathered_bicubic_f48_tail_f64, x_hi, x_lo, y_hi, y_lo, packed,
                             r, qx_hi, qx_lo, qy_hi, qy_lo)


def gathered_bicubic_eval_df(x_hi, x_lo, y_hi, y_lo, rows_hi, rows_lo, qx_hi, qx_lo, qy_hi,
                             qy_lo, r=1):
    """The double-float bicubic route from the pairs of a cell-layout
    ``BicubicStrategy.rows`` table (float64 split with ``df_from_f64``):
    packs the table, then :func:`gathered_bicubic_eval_df_packed`."""
    packed = pack_bicubic_rows_df(rows_hi, rows_lo, r)
    return gathered_bicubic_eval_df_packed(x_hi, x_lo, y_hi, y_lo, packed,
                                           qx_hi, qx_lo, qy_hi, qy_lo, r=r)


def gathered_bicubic_nodes_eval_df(x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi,
                                   qy_lo, r=1):
    """The double-float bicubic route from the memory-frugal node table
    (:func:`pack_bicubic_nodes_df`): K7 twice, then K14.  Flat queries;
    returns the ``(nq, r)`` result pair.  The f64-grade route for grids whose
    cell table is over ``config.bicubic_pack_max_elems``."""
    if packed.shape[1] != 8 * r + 4:
        raise ValueError(f"a node table of r = {r} channels has {8 * r + 4} columns, "
                         f"got {packed.shape[1]}")
    xi, txh, txl, yi, tyh, tyl = _df_index_frac_2d(
        x_hi, x_lo, y_hi, y_lo, qx_hi, qx_lo, qy_hi, qy_lo
    )
    return gathered_bicubic_node_df_tail(packed, xi, yi, y_hi.shape[0], txh, txl, tyh, tyl)


def _check_ny(ny, y_hi):
    if ny != y_hi.shape[0]:
        raise ValueError(f"ny = {ny} but the y axis has {y_hi.shape[0]} knots")
