"""Order a batch of 2-D queries by cell, ahead of the f64-grade bicubic
tails K12, K13, K14 and R4c (``eval_kernels_df2d``), and a batch of 1-D
queries by interval, ahead of the bank tails K8 and K9 (``eval_kernels_df``).

No TPU twin: the JAX routes gather every query's row in query order.  On
the GPU a large batch in random order reads each query's row from device
memory, about four times for each row at NS3d's and NS3e's shapes; in cell
order the queries of one cell run next to each other and share the row.
K8's and K9's tables sit in the L2; in interval order the ~100 queries of
a row share its widening.

:func:`order_by_cell` takes K7's interval indices ``xi``, ``yi`` and the
fraction halves and returns the records the ordered tails read, one
``(nq, 8)`` int32 row of 32 bytes a query: the row value
``v = xi·row_step + yi`` clamped to ``[lo, rows - 1]``, the query's index
``qid``, the bits of its ``tx_hi, tx_lo, ty_hi, ty_lo`` and two zeros
(:func:`record_fields` reads them back), in the order of the bucket
``max(v, 0) >> shift``, where ``shift`` keeps the buckets at most
``2^MAX_BUCKET_BITS``.  K12, K13 and R4c pass the cell
(``row_step = ny - 1``, ``lo = 0``); K14 the base node (``row_step = ny``,
``lo = -(ny + 1)``: every base below it clamps all four nodes to row 0).
:func:`order_by_interval` is the 1-D form: no ``yi`` and no ``ty``
halves, the key the interval clamped to ``[0, rows - 1]``, the record
``[v, qid, t_hi, t_lo, 0, 0, 0, 0]``.

On a CUDA tensor the kernels in ``csrc/cell_order.cu`` do a counting sort
in one of two forms, picked by the number of buckets (:func:`_form`): up to
:data:`SHARED_MAX_BUCKETS` (the 1-D keys) each block counts a chunk of the
batch in shared memory, with no global atomic and no memset; above it (the
2-D keys) a histogram in device memory, its scan and a scatter, the first
design, which the shared form's ideas did not speed up there.  The order
within a bucket then varies from run to run.  Its plain version, :func:`_order_plain`, is a
stable ``torch.argsort`` of the buckets.  ``order_by_cell.launches`` counts
the orderings, those of :func:`order_by_interval` too.
"""

from __future__ import annotations

import functools

import torch

from . import _cuda

#: at most 2^22 buckets: 16 MB of counts however large the table
MAX_BUCKET_BITS = 22
#: the most buckets the shared form takes: a block's counts in shared memory
SHARED_MAX_BUCKETS = 32_768
_TILE = 4096  # counts a block of the global form's scan
_SHARED_THREADS = 1024  # a block of the shared form
_SHARED_MAX_BLOCKS = 256  # the shared form's scan cuts the blocks' rows in 8 of 32
_BUCKET_TILE = 32  # buckets a block of the shared form's scan
# the kernel's forms: a histogram in device memory (the first design), or
# one in each block's shared memory
GLOBAL, SHARED = 0, 1


def bucket_shift(rows):
    """The right shift from a row value to its bucket for a table of
    ``rows`` rows: 0 up to ``2^MAX_BUCKET_BITS`` rows."""
    return max(0, (rows - 1).bit_length() - MAX_BUCKET_BITS)


def bucket_count(rows):
    """The buckets of a table of ``rows`` rows."""
    return ((rows - 1) >> bucket_shift(rows)) + 1


def row_values(xi, yi, row_step, lo, rows):
    """``xi·row_step + yi`` clamped to ``[lo, rows - 1]``, in int64 (``yi``
    ``None``: 0)."""
    v = xi.long() * row_step
    return (v if yi is None else v + yi.long()).clamp(lo, rows - 1)


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
    if tyh is None:  # 1-D: the y halves' bits are 0
        tyh = tyl = torch.zeros_like(txh)
    halves = torch.stack([txh, txl, tyh, tyl], dim=1).view(torch.int32)
    zeros = torch.zeros((xi.shape[0], 2), dtype=torch.int32, device=xi.device)
    key = torch.stack([v[perm], perm], dim=1).to(torch.int32)
    return torch.cat([key, halves[perm], zeros], dim=1)


def order_by_cell(xi, yi, row_step, lo, rows, tx_hi, tx_lo, ty_hi, ty_lo):
    """The ``(nq, 8)`` int32 records of the queries, in bucket order.  CPU
    tensors: :func:`_order_plain`; CUDA: the counting sort, in the form
    :func:`_form` picks.  ``yi``, ``ty_hi`` and ``ty_lo`` may be ``None``
    together (1-D, as :func:`order_by_interval`)."""
    args = (xi, yi, row_step, lo, rows, tx_hi, tx_lo, ty_hi, ty_lo)
    if _cuda.kernel_device("order_by_cell", tx_hi) == "cpu":
        return _order_plain(*args)
    return _order_kernel(args, _form(bucket_count(rows)))


def _form(buckets):
    """The kernel's form for a table of ``buckets`` buckets."""
    return SHARED if buckets <= SHARED_MAX_BUCKETS else GLOBAL


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _order_kernel(args, form):
    """The counting sort of ``args`` (as :func:`order_by_cell` takes them)
    on the card in ``form`` (:data:`GLOBAL` or :data:`SHARED`): the
    ``(nq, 8)`` records."""
    xi, yi, row_step, lo, rows, tx_hi, tx_lo, ty_hi, ty_lo = args
    one_d = yi is None
    _cuda.pair_operands("order_by_cell", tx_hi, tx_lo, *(() if one_d else (ty_hi, ty_lo)))
    for what, idx in (("xi", xi),) + (() if one_d else (("yi", yi),)):
        if idx.dtype != torch.int32 or idx.device != tx_hi.device:
            raise TypeError(f"order_by_cell: {what} must be torch.int32 on {tx_hi.device}")
    nq = xi.shape[0]
    if nq >= 2**31 or rows >= 2**31:
        raise ValueError(f"order_by_cell: {nq} queries on {rows} rows; the records hold int32")
    dev = tx_hi.device
    records = torch.empty((nq, 8), dtype=torch.int32, device=dev)
    if nq == 0:
        return records
    nb = bucket_count(rows)
    if form == GLOBAL:  # the counts, zeroed, and the tiles' sums
        blocks = -(-nb // _TILE)
        work = torch.zeros(blocks * (_TILE + 1), dtype=torch.int32, device=dev)
    else:  # a (blocks, nb) histogram, bucket starts, the tiles' sums, the count done
        blocks = min(_sm_count(dev.index), _SHARED_MAX_BLOCKS, -(-nq // _SHARED_THREADS))
        work = torch.empty(blocks * nb + nb + -(-nb // _BUCKET_TILE) + 1, dtype=torch.int32,
                           device=dev)
    _cuda.launch(
        "ndi_cell_order", torch.float32, dev,
        xi.contiguous(), None if one_d else yi.contiguous(), row_step, lo, rows,
        bucket_shift(rows),
        *(None if v is None else v.contiguous() for v in (tx_hi, tx_lo, ty_hi, ty_lo)),
        work, blocks, form, records, nq,
    )
    order_by_cell.launches += 1
    return records


def order_by_interval(idx, rows, t_hi, t_lo):
    """The ``(nq, 8)`` records of a 1-D batch in interval order: K7's
    intervals ``idx`` clamped to ``[0, rows - 1]``, the fraction halves, no
    y part.  :func:`order_by_cell`'s kernel (its launch counted there) or,
    on CPU tensors, its plain version."""
    return order_by_cell(idx, None, 1, 0, rows, t_hi, t_lo, None, None)


order_by_cell.launches = 0
