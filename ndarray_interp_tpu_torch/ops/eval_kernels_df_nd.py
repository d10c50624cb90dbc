"""f64-grade ``InterpND`` evaluation on the GPU: the wrappers of K15.

Counterpart of ``ndarray_interp_tpu.ops.pallas_eval_df_nd``: every value
crosses the interface as an ``(hi, lo)`` float32 pair (``ops/df.py``).  The
route runs K7 on each axis for ``(idx, t)``, then one tail kernel that
gathers each query's cell row of a packed table and evaluates the k-fold
tensor-product Hermite (``nbasis = 4``, the cubic cell layout) or
multilinear (``nbasis = 2``) form:

* :func:`nd_df_tail` (K15) on a :func:`pack_rows_nd_df` table;
* :func:`nd_f48_tail` (K15, grade f48) on a :func:`pack_rows_nd_f48` table,
  whose lo halves are bfloat16, two to a float32 lane.

The CUDA kernel is in ``csrc/df_nd_kernels.cu``.  It widens every pair once
to float64 (exact) and computes natively in FP64, where the TPU kernel
(``_df_nd_mxu_kernel``) built the weights with one-hot matrix products and
error-free transforms on float32.  Its plain version is
:func:`_df_nd_tail`, in PyTorch float64, on rows gathered with
``index_select``: the weight form of the JAX package's
``_df_nd_weight_tail_xla``.  Per axis the basis is
``models/interpnd._cubic_basis`` (or ``[1-t, t]``), the weights fold
axis 0 first (the pack's channel order: one base-``nbasis`` digit per
axis, axis 0 most significant), each weight multiplies its widened row
block, and the ``nbasis^k`` products are summed by the halving tree
``p[:h] + p[h:]``.  A wrapper runs the plain version for CPU tensors and
launches the kernel for CUDA tensors; the kernel is bit-identical to the
plain version.  Both wrappers call the ``torch.library`` op
``ndarray_interp::df_nd_tail`` with their grade; under ``vmap`` its batched
``(k, nq)`` query operands flatten along the query axis into one launch.
``launches`` on each wrapper counts its kernel's launches.  The route's
placement rule over DTensor is :mod:`.partition`'s ``sharded_df_nd_packed``.

As in 1-D and 2-D the fraction is computed in float64: a ±inf query gives
``t = ±inf`` where the JAX double-float fraction is NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .df import df_from_f64, df_to_f64
from .eval_kernels_df import _as_f32_bits, _bf16_bits, _gather_rows, _unpack_f48_lo
from .eval_kernels_df import fused_index_frac_df

#: the kernel's largest axis count
MAX_K = _cuda.MAX_ND_AXES


def _nd_bp(r):
    """Lanes per quantity block of the packed ND rows: ``r`` up to 8
    channels, else ``r`` rounded up to a multiple of 8."""
    return r if r <= 8 else -(-r // 8) * 8


def _nd_blocks(v, nb, r):
    cells = v.shape[0]
    return F.pad(v.reshape(cells, nb, r), (0, _nd_bp(r) - r)).reshape(cells, nb * _nd_bp(r))


def pack_rows_nd_df(rows_hi, rows_lo, nb, r):
    """Double-float ND cell rows ``(cells, 2·nb·bp)``: the ``nb`` quantity
    blocks of each cell (``models/interpnd`` cell layout) hi, then lo, each
    ``r``-block padded to ``bp`` lanes.  Bit-identical to the JAX package's
    table."""
    return torch.cat([_nd_blocks(rows_hi, nb, r), _nd_blocks(rows_lo, nb, r)], dim=1)


def pack_rows_nd_f48(rows_hi, rows_lo, nb, r):
    """"f48" ND cell rows ``(cells, 3/2·nb·bp)``: the hi blocks of
    :func:`pack_rows_nd_df`, then the lo blocks rounded to bfloat16 and
    packed two to a float32 lane, block ``j`` in the high 16 bits and block
    ``j + nb/2`` in the low 16 (``nb`` is even).  Bit-identical to the JAX
    package's table."""
    lo16 = _bf16_bits(_nd_blocks(rows_lo, nb, r))
    half = (nb // 2) * _nd_bp(r)
    packed_lo = _as_f32_bits((lo16[:, :half] << 16) | lo16[:, half:])
    return torch.cat([_nd_blocks(rows_hi, nb, r), packed_lo], dim=1)


def _df_index_frac_nd(axes_pairs, q_flat):
    """Every axis's ``(idx, t_hi, t_lo)``: K7 once per axis.  ``q_flat`` is
    ``(q0_hi, q0_lo, q1_hi, q1_lo, ...)``; returns the flat tuple of the
    ``k`` triples."""
    out = []
    for d, (xh, xl) in enumerate(axes_pairs):
        out.extend(fused_index_frac_df(xh, xl, q_flat[2 * d], q_flat[2 * d + 1]))
    return tuple(out)


# -- plain version ------------------------------------------------------------------
def _nd_basis(t, nbasis):
    """(Q, nbasis) basis of one axis in float64: ``_cubic_basis`` (order 0)
    or ``[1-t, t]``."""
    if nbasis == 2:
        return torch.stack([1.0 - t, t], dim=-1)
    omt = 1.0 - t
    return torch.stack(
        [omt * omt * (1.0 + 2.0 * t), t * t * (3.0 - 2.0 * t), t * omt * omt, -t * t * omt],
        dim=-1,
    )


def _df_nd_tail(rows, t_hi, t_lo, nbasis):
    """The ND tail on gathered, unpacked :func:`pack_rows_nd_df` rows
    ``(Q, 2·nb·bp)`` at the fraction pairs ``(k, Q)``, in float64: the
    ``(Q, bp)`` result pair."""
    k = t_hi.shape[0]
    nb = nbasis**k
    q = rows.shape[0]
    bp = rows.shape[1] // (2 * nb)
    w = None
    for d in range(k):
        b = _nd_basis(df_to_f64(t_hi[d], t_lo[d]), nbasis)
        w = b if w is None else (w[:, :, None] * b[:, None, :]).reshape(q, -1)
    z = df_to_f64(rows[:, : nb * bp], rows[:, nb * bp :]).reshape(q, nb, bp)
    p = w[:, :, None] * z
    while p.shape[1] > 1:
        h = p.shape[1] // 2
        p = p[:, :h] + p[:, h:]
    return df_from_f64(p[:, 0])


def _cell_index(idx, cstrides):
    return sum(idx[d].long() * s for d, s in enumerate(cstrides))


def _nd_df_tail_plain(packed, idx, t_hi, t_lo, cstrides, nbasis):
    """Plain version of K15: :func:`_df_nd_tail` on the gathered cell rows
    ``Σ idx[d]·cstrides[d]`` (clamped to the table)."""
    return _df_nd_tail(_gather_rows(packed, _cell_index(idx, cstrides)), t_hi, t_lo, nbasis)


def _nd_f48_tail_plain(packed, idx, t_hi, t_lo, cstrides, nbasis):
    """Plain version of K15 at grade f48: :func:`_df_nd_tail` on the rows of
    a :func:`pack_rows_nd_f48` table, lo halves unpacked."""
    rows = _gather_rows(packed, _cell_index(idx, cstrides))
    split = rows.shape[1] * 2 // 3
    rows = torch.cat([rows[:, :split], _unpack_f48_lo(rows[:, split:])], dim=1)
    return _df_nd_tail(rows, t_hi, t_lo, nbasis)


# -- kernel launch -------------------------------------------------------------------
def _launch_nd(wrapper, f48, packed, idx, t_hi, t_lo, cstrides, nbasis):
    name = wrapper.__name__
    _cuda.pair_operands(name, t_hi, t_lo, packed)
    if idx.dtype != torch.int32 or idx.device != t_hi.device:
        raise TypeError(f"{name}: idx must be torch.int32 on {t_hi.device}")
    if idx.ndim != 2 or not idx.shape == t_hi.shape == t_lo.shape:
        raise ValueError(f"{name}: idx, t_hi and t_lo must have one shape (k, nq)")
    k, nq = idx.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_K} axes, got k = {k}")
    if nbasis not in (2, 4) or len(cstrides) != k:
        raise ValueError(f"{name}: nbasis must be 2 or 4 and cstrides hold k = {k} strides")
    nb = nbasis**k
    units = 3 * nb // 2 if f48 else 2 * nb  # channels per lane of bp
    if packed.ndim != 2 or packed.shape[1] % units:
        raise ValueError(
            f"{name}: packed must have shape (cells, {units}·bp), got {tuple(packed.shape)}"
        )
    bp = packed.shape[1] // units
    out_hi = torch.empty((nq, bp), dtype=torch.float32, device=t_hi.device)
    out_lo = torch.empty_like(out_hi)
    strides = _cuda.NdStrides()
    strides.s[:k] = [int(s) for s in cstrides]
    packed = packed.contiguous()
    if packed.data_ptr() % 16:  # the kernel reads bp = 1 rows with 16-byte loads
        packed = packed.clone()
    _cuda.launch(
        "ndi_f48_nd_tail" if f48 else "ndi_df_nd_tail", torch.float32, t_hi.device,
        packed, packed.shape[0], packed.shape[1], bp, k, nbasis, idx.contiguous(), strides,
        t_hi.contiguous(), t_lo.contiguous(), out_hi, out_lo, nq,
    )
    wrapper.launches += 1
    return out_hi, out_lo


# -- the op ----------------------------------------------------------------------------
def _tail_plain(grade, packed, idx, t_hi, t_lo, cstrides, nbasis):
    plain = _nd_f48_tail_plain if grade == "f48" else _nd_df_tail_plain
    return plain(packed, idx, t_hi, t_lo, cstrides, nbasis)


def _tail_launch(grade, *args):
    f48 = grade == "f48"
    return _launch_nd(nd_f48_tail if f48 else nd_df_tail, f48, *args)


def _tail_fake(grade, packed, idx, t_hi, t_lo, cstrides, nbasis):
    """The ``(nq, bp)`` outputs, ``bp`` from the table's width as the launch
    takes it."""
    nb = nbasis ** idx.shape[0]
    bp = packed.shape[1] // (3 * nb // 2 if grade == "f48" else 2 * nb)
    return t_hi.new_empty((idx.shape[1], bp)), t_hi.new_empty((idx.shape[1], bp))


def _tail_vmap(op, info, in_dims, grade, packed, idx, t_hi, t_lo, cstrides, nbasis):
    """The batching rule of K15's op: batched ``(k, nq)`` query operands
    flatten along their query axis into one launch; a batched table takes
    the plain version (:func:`_cuda.vmap_queries`, whose queries lie along
    dim 0)."""
    args = (grade, packed, idx, t_hi, t_lo, cstrides, nbasis)
    if in_dims[1] is not None:
        return _cuda.vmap_queries(op, _tail_plain, info, in_dims, args, (2, 3, 4))
    size = info.batch_size
    queries = []
    for a, d in zip((idx, t_hi, t_lo), in_dims[2:5]):
        a = a.unsqueeze(1).expand(a.shape[0], size, a.shape[1]) if d is None else a.movedim(d, 1)
        queries.append(a.reshape(a.shape[0], -1))
    hi, lo = op(grade, packed, *queries, cstrides, nbasis)
    nq = queries[0].shape[1] // size
    return (hi.reshape(size, nq, -1), lo.reshape(size, nq, -1)), (0, 0)


# K15 at grade "df" or "f48": forward the kernel (its plain version on the CPU)
_TAIL = _cuda.kernel_op(
    "df_nd_tail",
    "(str grade, Tensor packed, Tensor idx, Tensor t_hi, Tensor t_lo, int[] cstrides, "
    "int nbasis) -> (Tensor, Tensor)",
    lambda grade, *a: _cuda.run("nd_f48_tail" if grade == "f48" else "nd_df_tail", a[2],
                                _tail_launch, _tail_plain, grade, *a),
    _tail_fake,
    setup_context=_cuda.save_operands, backward=_cuda.plain_backward(_tail_plain),
    vmap=_tail_vmap,
)


# -- public wrappers -------------------------------------------------------------------
def nd_df_tail(packed, idx, t_hi, t_lo, cstrides, nbasis=4):
    """Cell ``Σ idx[d]·cstrides[d]`` of the :func:`pack_rows_nd_df` table for
    each query, evaluated at its fractions: the ``(nq, bp)`` result pair.
    ``idx`` is ``(k, nq)`` int32 (K7's per axis), ``t_hi``/``t_lo``
    ``(k, nq)``, ``nbasis`` 4 (cubic) or 2 (multilinear).  CPU tensors:
    :func:`_nd_df_tail_plain`; CUDA: K15, which gathers the rows itself, for
    ``k`` up to :data:`MAX_K` (more raises)."""
    return _TAIL("df", packed, idx, t_hi, t_lo, [int(s) for s in cstrides], int(nbasis))


def nd_f48_tail(packed, idx, t_hi, t_lo, cstrides, nbasis=4):
    """:func:`nd_df_tail` on a :func:`pack_rows_nd_f48` table.  CPU tensors:
    :func:`_nd_f48_tail_plain`; CUDA: K15 at grade f48."""
    return _TAIL("f48", packed, idx, t_hi, t_lo, [int(s) for s in cstrides], int(nbasis))


nd_df_tail.launches = 0
nd_f48_tail.launches = 0


# -- route -----------------------------------------------------------------------------
def gathered_nd_eval_df_packed(k, grid_shape, r, nbasis=4, tier="df"):
    """The double-float ND route on a prepacked table: returns
    ``route(x0_hi, x0_lo, ..., packed, q0_hi, q0_lo, ...)`` giving the
    ``(nq, r)`` result pair: K7 on each axis, then K15.

    ``grid_shape``: the ``k`` leading data dims (for the cell strides).
    ``nbasis``: 4 for the tensor-product cubic (cell layout), 2 for
    multilinear.  ``tier="f48"`` expects a :func:`pack_rows_nd_f48` table.
    Counterpart of the JAX factory of the same name."""
    if tier not in ("df", "f48"):
        raise ValueError(f"tier must be 'df' or 'f48', got {tier!r}")
    cells = [n - 1 for n in grid_shape]
    cstrides = [1] * k
    for d in range(k - 2, -1, -1):
        cstrides[d] = cstrides[d + 1] * cells[d + 1]
    tail = nd_df_tail if tier == "df" else nd_f48_tail

    def route(*ops):
        axes_pairs = [(ops[2 * d], ops[2 * d + 1]) for d in range(k)]
        packed = ops[2 * k]
        parts = _df_index_frac_nd(axes_pairs, ops[2 * k + 1 :])
        idx, t_hi, t_lo = (torch.stack(parts[j::3]) for j in range(3))
        hi, lo = tail(packed, idx, t_hi, t_lo, cstrides, nbasis)
        return hi[:, :r], lo[:, :r]

    return route
