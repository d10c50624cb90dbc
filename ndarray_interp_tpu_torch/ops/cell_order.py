"""Order a batch of 2-D queries by cell, ahead of the f64-grade bicubic
tails K12 and K14 (``eval_kernels_df2d``).

No TPU twin: the JAX routes gather every query's row in query order.  On
the GPU a large batch in random order reads each query's row from device
memory, about four times for each row at NS3d's and NS3e's shapes; in cell
order the queries of one cell run next to each other and share the row.

:func:`order_by_cell` takes K7's interval indices ``xi``, ``yi`` and the
fraction halves and returns the records the ordered tails read, one
``(nq, 8)`` int32 row of 32 bytes a query: the row value
``v = xi·row_step + yi`` clamped to ``[lo, rows - 1]``, the query's index
``qid``, the bits of its ``tx_hi, tx_lo, ty_hi, ty_lo`` and two zeros
(:func:`record_fields` reads them back), in the order of the bucket
``max(v, 0) >> shift``, where ``shift`` keeps the buckets at most
``2^MAX_BUCKET_BITS``.  K12 passes the cell
(``row_step = ny - 1``, ``lo = 0``); K14 the base node (``row_step = ny``,
``lo = -(ny + 1)``: every base below it clamps all four nodes to row 0).
On a CUDA tensor the kernel in ``csrc/cell_order.cu`` does a counting
sort (histogram, scan, scatter); the order within a bucket then varies
from run to run.  Its plain version, :func:`_order_plain`, is a stable
``torch.argsort`` of the buckets.  ``order_by_cell.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from . import _cuda

#: at most 2^22 buckets: 16 MB of counts however large the table
MAX_BUCKET_BITS = 22
_TILE = 4096  # counts a block of the scan


def bucket_shift(rows):
    """The right shift from a row value to its bucket for a table of
    ``rows`` rows: 0 up to ``2^MAX_BUCKET_BITS`` rows."""
    return max(0, (rows - 1).bit_length() - MAX_BUCKET_BITS)


def row_values(xi, yi, row_step, lo, rows):
    """``xi·row_step + yi`` clamped to ``[lo, rows - 1]``, in int64."""
    return (xi.long() * row_step + yi.long()).clamp(lo, rows - 1)


def bucket_keys(values, rows):
    """The sort key of each row value: ``max(v, 0) >> bucket_shift(rows)``."""
    return values.clamp(min=0) >> bucket_shift(rows)


def record_fields(records):
    """``(v, qid, frac)`` of ``(nq, 8)`` records: the row values and query
    indices (int32) and the ``(nq, 4)`` float32 fraction halves."""
    return records[:, 0], records[:, 1], records[:, 2:6].view(torch.float32)


def _order_plain(xi, yi, row_step, lo, rows, txh, txl, tyh, tyl):
    """Plain version of the ordering kernel: the records in the stable
    order of their buckets."""
    v = row_values(xi, yi, row_step, lo, rows)
    perm = torch.argsort(bucket_keys(v, rows), stable=True)
    halves = torch.stack([txh, txl, tyh, tyl], dim=1).view(torch.int32)
    zeros = torch.zeros((xi.shape[0], 2), dtype=torch.int32, device=xi.device)
    key = torch.stack([v[perm], perm], dim=1).to(torch.int32)
    return torch.cat([key, halves[perm], zeros], dim=1)


def order_by_cell(xi, yi, row_step, lo, rows, tx_hi, tx_lo, ty_hi, ty_lo):
    """The ``(nq, 8)`` int32 records of the queries, in bucket order.  CPU
    tensors: :func:`_order_plain`; CUDA: the counting sort."""
    args = (xi, yi, row_step, lo, rows, tx_hi, tx_lo, ty_hi, ty_lo)
    if _cuda.kernel_device("order_by_cell", tx_hi) == "cpu":
        return _order_plain(*args)
    _cuda.pair_operands("order_by_cell", tx_hi, tx_lo, ty_hi, ty_lo)
    for what, idx in (("xi", xi), ("yi", yi)):
        if idx.dtype != torch.int32 or idx.device != tx_hi.device:
            raise TypeError(f"order_by_cell: {what} must be torch.int32 on {tx_hi.device}")
    nq = xi.shape[0]
    if nq >= 2**31 or rows >= 2**31:
        raise ValueError(f"order_by_cell: {nq} queries on {rows} rows; the records hold int32")
    dev = tx_hi.device
    records = torch.empty((nq, 8), dtype=torch.int32, device=dev)
    if nq == 0:
        return records
    shift = bucket_shift(rows)
    ntiles = -(-(((rows - 1) >> shift) + 1) // _TILE)
    counts = torch.zeros(ntiles * (_TILE + 1), dtype=torch.int32, device=dev)
    _cuda.launch(
        "ndi_cell_order", torch.float32, dev,
        xi.contiguous(), yi.contiguous(), row_step, lo, rows, shift,
        *(v.contiguous() for v in (tx_hi, tx_lo, ty_hi, ty_lo)),
        counts, counts[ntiles * _TILE:], ntiles, records, nq,
    )
    order_by_cell.launches += 1
    return records


order_by_cell.launches = 0
