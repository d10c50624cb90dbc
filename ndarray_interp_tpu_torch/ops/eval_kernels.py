"""Evaluation and interval search on the GPU: wrappers of K1, K2, K3 and R1.

Counterpart of ``ndarray_interp_tpu.ops.pallas_eval``.  The CUDA kernels
are in ``csrc/eval_kernels.cu`` and, for R1, ``csrc/cell2d_kernels.cu``:

* :func:`fused_eval_1d` (K1): bucketize, interval-row fetch and the
  symmetric Hermite form in one pass, for scalar data; the search on the
  axis staged in shared memory as a breadth-first tree (``_K1_TREE_BYTES``),
  the row read in the form ``_K1_ROW_READ`` names for the dtype;
* :func:`fused_index_frac` (K2): the search emitting ``(idx, t)``, which
  feeds the bank-data eval, on the axis staged as K3's (``_K2_TREE_BYTES``),
  the fraction's endpoints read from the tree where it holds the whole axis;
* :func:`fused_lower_index` (K3): the search emitting ``idx``, on the axis
  staged as K1's (``_K3_TREE_BYTES``);
* :func:`fused_cell_index` (R1): both 2-D axis searches in one pass, each
  axis on its own staged tree (half of ``_R1_TREE_BYTES`` each), emitting
  the flat cell and both fractions, which feed the 2-D tails of
  :mod:`.tail2d`.

On an H100 80GB HBM3 at 700 W (``tools/search_phases.py``): K1 at 2,048 knots x 1M
f32 queries 0.0124 ms against the first design's 0.0244 (every level of the
search on the global axis, six scalar loads a row); R1 at 512 + 512 knots x
1M f32 0.0152 against 0.0266; K2 at 512 knots x 1M f32 0.0097 against its
first design's 0.0123, which it keeps where its tree does not pay
(:func:`_k2_budget`).

Each has its plain PyTorch version here (:func:`_eval_plain`, the
counterpart of the JAX package's ``_eval_xla``; :func:`_index_frac_plain`;
:func:`.searchsorted.get_lower_index`; :func:`_cell_index_plain`).  A
wrapper takes the plain version for a CPU tensor and launches its kernel
for a CUDA tensor, both through one ``torch.library`` op
(``ndarray_interp::<wrapper>``, ``_cuda.kernel_op``, implemented by
``_cuda.run``) whose backward is the VJP of the plain version and whose
``vmap`` rule flattens batched queries into one launch; ``torch.compile``
traces each op as one node.  Each kernel is held to its plain version bit
for bit.  ``launches`` on each wrapper counts its kernel's launches.
"""

from __future__ import annotations

import torch

from . import _cuda
from .searchsorted import get_lower_index


def make_interval_table(x, data, a=None, b=None):
    """Stack the per-interval channels ``[x_l, x_r, y_l, y_r, a, b]``:
    shape ``(n-1, 6)`` for scalar data.

    Linear strategies pass ``a = b = None`` (zeros), which makes the Hermite
    form collapse to the lerp.
    """
    a = torch.zeros_like(data[:-1]) if a is None else a
    b = torch.zeros_like(data[:-1]) if b is None else b
    return torch.stack([x[:-1], x[1:], data[:-1], data[1:], a, b], dim=-1)


def _eval_plain(knots, tbl, q):
    """Plain version of K1 (the JAX package's ``_eval_xla``)."""
    idx = get_lower_index(knots, q).long()
    rows = tbl[idx]
    x_l, x_r, y_l, y_r, a, b = (rows[..., i] for i in range(6))
    t = (q - x_l) / (x_r - x_l)
    base = (1 - t) * y_l + t * y_r + t * (1 - t) * (a * (1 - t) + b * t)
    lin_inf = torch.isinf(t) & (a == 0) & (b == 0)
    return torch.where(lin_inf, y_l + t * (y_r - y_l), base)


def _index_frac_plain(knots, q):
    """Plain version of K2: ``(get_lower_index(knots, q), t)``."""
    idx = get_lower_index(knots, q)
    return idx, _frac(knots, q, idx)


def _frac(knots, q, idx):
    il = idx.long()
    x_l = knots[il]
    x_r = knots[il + 1]
    return (q - x_l) / (x_r - x_l)


def _cell_index_plain(x, y, qx, qy):
    """Plain version of R1: ``get_lower_index`` on each axis, the flat cell
    ``xi * (ny - 1) + yi`` (int32) and the fractions as K2 computes them."""
    xi = get_lower_index(x, qx)
    yi = get_lower_index(y, qy)
    return xi * (y.shape[0] - 1) + yi, _frac(x, qx, xi), _frac(y, qy, yi)


def _flat_queries(name, knots, q):
    if knots.ndim != 1 or knots.shape[0] < 2:
        raise ValueError(f"{name}: knots must be 1-D with at least 2 entries")
    return q.reshape(-1).contiguous()


# K1's shared-memory budget, as K3's: the axis staged whole up to 8,191 f32 /
# 4,095 f64 knots, every w-th knot above it with the last levels of the
# search on the global axis; at one knot every level runs on the global axis
# (the first design's search).  Measured on an H100 80GB HBM3 at 700 W
# (tools/search_phases.py --sweeps, 1M queries), trees of 16 / 32 / 64 KB:
# f32 at 70,001 knots 0.0431 / 0.0396 / 0.0429 ms (one knot 0.0390), at
# 262,144 0.0544 / 0.0527 / 0.0586 (one knot 0.0660); f64 at 70,001 0.0502 /
# 0.0483 / 0.0502 (one knot 0.0509).  At 2,048 knots (NS1) the tree is the
# whole axis at any of them: 0.0124 against 0.0244 at one knot.
_K1_TREE_BYTES = 32 << 10
# K1's row read by dtype (csrc/eval_kernels.cu RowRead): 0 six scalar loads,
# 1 three 2-element loads where the table allows them, 2 the rows staged in
# shared memory beside a whole tree where both fit (else as 1).  At 2,048
# knots x 1M queries on the same card, scalar / 2-element / shared: f32
# 0.0151 / 0.0124 / 0.0135 ms, f64 0.0217 / 0.0180 / 0.0171 (a second run
# 0.0153 / 0.0126 / 0.0137 and 0.0217 / 0.0181 / 0.0172).  Staging 49 KB of
# f32 rows a block costs more than the 2-element loads save; 98 KB of f64
# rows win over 48-byte rows read as three 16-byte loads.
_K1_ROW_READ = {torch.float32: 1, torch.float64: 2}


def _launch_eval(knots, tbl, q):
    dtype = _cuda.float_operands("fused_eval_1d", q, knots, tbl)
    qf = _flat_queries("fused_eval_1d", knots, q)
    n = knots.shape[0]
    if tbl.ndim != 2 or tbl.shape[0] != n - 1 or tbl.shape[1] < 6:
        raise ValueError(
            f"fused_eval_1d: tbl must have shape (n-1, >=6) = ({n - 1}, >=6), "
            f"got {tuple(tbl.shape)}"
        )
    knots, tbl = knots.contiguous(), tbl.contiguous()
    out = torch.empty_like(qf)
    _cuda.launch(
        "ndi_eval1d", dtype, q.device,
        knots, n, tbl, tbl.shape[1], _K1_TREE_BYTES // qf.element_size() - 1,
        _K1_ROW_READ[dtype], qf, out, qf.shape[0],
    )
    fused_eval_1d.launches += 1
    return out.reshape(q.shape)


# K2's shared-memory budget, as K3's convention: the axis staged whole up to
# the budget (4,095 f32 / 2,047 f64 knots in 16 KB), every w-th knot above it
# with the last levels of the search on the global axis; at one knot every
# level runs on the global axis (the first design's search), at zero the first
# design itself (a thread a query on the global search).  _k2_budget keeps the
# first design where the tree does not pay.  Measured: see the K2 paragraph of
# csrc/eval_kernels.cu.
_K2_TREE_BYTES = 16 << 10
# the batches K2 stages its tree for: at least this many queries a knot, on an
# axis of more than this many bytes (two 128-byte lines, which the L1 serves
# as fast as shared memory)
_K2_QUERIES_A_KNOT = 64
_K2_SMALL_AXIS_BYTES = 256


def _k2_budget(n, nq, size):
    """The knots K2 stages for ``nq`` queries on ``n`` knots of ``size``
    bytes: 0 (the first design) below ``_K2_QUERIES_A_KNOT`` queries a knot
    or on an axis of at most ``_K2_SMALL_AXIS_BYTES``, else the tree of
    ``_K2_TREE_BYTES``."""
    if nq < _K2_QUERIES_A_KNOT * n or n * size <= _K2_SMALL_AXIS_BYTES:
        return 0
    return _K2_TREE_BYTES // size - 1


def _launch_index_frac(knots, q):
    dtype = _cuda.float_operands("fused_index_frac", q, knots)
    qf = _flat_queries("fused_index_frac", knots, q)
    knots = knots.contiguous()
    idx = torch.empty(qf.shape, dtype=torch.int32, device=q.device)
    t = torch.empty_like(qf)
    _cuda.launch(
        "ndi_index_frac", dtype, q.device,
        knots, knots.shape[0], _k2_budget(knots.shape[0], qf.shape[0], qf.element_size()),
        qf, idx, t, qf.shape[0],
    )
    fused_index_frac.launches += 1
    return idx.reshape(q.shape), t.reshape(q.shape)


# K3's shared-memory budget: a block stages as many knots as a tree of
# _K3_TREE_BYTES holds (8,191 in f32, 4,095 in f64), the whole axis up to
# there, every w-th knot above it with the last log2(w) levels of the search
# on the global axis; the kernel caps it at the largest tree a block holds.
# Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's K3 phase, 1M
# queries), trees of 16 / 32 / 64 / 128 KB against the global search: f32 at
# 65,536 knots 0.0249 / 0.0226 / 0.0299 / 0.0343 against 0.0380 ms, at
# 70,001 0.0263 / 0.0230 / 0.0304 / 0.0348 against 0.0252 (128 KB leave one
# block of 512 threads an SM); f64 (32 / 64 / 128 KB) at 65,536 knots 0.0310
# / 0.0352 / 0.0345 against 0.0485, at 70,001 0.0336 / 0.0361 / 0.0346
# against 0.0346.  Staging pays at every batch: at 2,048 knots the tree took
# 0.0033 ms against the global search's 0.0037 at 2 queries, 0.0036 against
# 0.0040 at 1,024, 0.0095 against 0.0177 at 1M.  At a budget of one knot
# every level of the search runs on the global axis, as K1's and K2's do.
_K3_TREE_BYTES = 32 << 10


def _launch_lower_index(knots, q):
    dtype = _cuda.float_operands("fused_lower_index", q, knots)
    qf = _flat_queries("fused_lower_index", knots, q)
    knots = knots.contiguous()
    idx = torch.empty(qf.shape, dtype=torch.int32, device=q.device)
    _cuda.launch(
        "ndi_lower_index", dtype, q.device,
        knots, knots.shape[0], _K3_TREE_BYTES // qf.element_size() - 1, qf, idx, qf.shape[0],
    )
    fused_lower_index.launches += 1
    return idx.reshape(q.shape)


def _check_cell_axes(x, y, qx, qy):
    """R1's shapes: two axes of >= 2 knots, queries of one shape, and fewer
    than 2^31 cells (the flat cell is int32)."""
    for name, k in (("x", x), ("y", y)):
        if k.ndim != 1 or k.shape[0] < 2:
            raise ValueError(f"fused_cell_index: {name} must be 1-D with at least 2 entries")
    if qx.shape != qy.shape:
        raise ValueError(
            f"fused_cell_index: qx and qy must have one shape, got {tuple(qx.shape)} "
            f"and {tuple(qy.shape)}"
        )
    if (x.shape[0] - 1) * (y.shape[0] - 1) >= 2**31:
        raise ValueError("fused_cell_index: the int32 cell index takes fewer than 2^31 cells")


# R1's shared-memory budget for its two trees, split in halves: each axis a
# tree of 16 KB, whole up to 4,095 f32 / 2,047 f64 knots, leaders above; the
# kernel gives both trees the larger one's depth, so that both searches step
# down in one loop.  Halves because a tree is a power of two of slots: no other
# split gives either axis a larger tree unless the other gets none, and both
# axes are searched once a query.  Measured on an H100 80GB HBM3 at 700 W
# (chip_smoke.py --sweeps, 1M queries), budgets of 16 / 32 / 64 / 128 KB: f32
# at 70,001 x 33 knots 0.0380 / 0.0319 / 0.0437 / 0.0433 ms (one knot an axis
# 0.0357), at 33 x 70,001 0.0390 / 0.0329 / 0.0496 / 0.0427, at 8,192 x 8,192
# 0.0265 / 0.0267 / 0.0292 / 0.0226 (two whole trees; one knot 0.0471); f64 at
# 70,001 x 33 0.0492 / 0.0462 / 0.0518 / 0.0466.  NS3's 512-knot axes are whole
# at any of them: 0.0149 against 0.0266 at one knot.
_R1_TREE_BYTES = 32 << 10


def _launch_cell_index(x, y, qx, qy):
    dtype = _cuda.float_operands("fused_cell_index", qx, qy, x, y)
    qxf, qyf = qx.reshape(-1).contiguous(), qy.reshape(-1).contiguous()
    x, y = x.contiguous(), y.contiguous()
    cell = torch.empty(qxf.shape, dtype=torch.int32, device=qx.device)
    tx, ty = torch.empty_like(qxf), torch.empty_like(qyf)
    _cuda.launch(
        "ndi_cell_index", dtype, qx.device,
        x, x.shape[0], y, y.shape[0], _R1_TREE_BYTES // 2 // qxf.element_size() - 1,
        qxf, qyf, cell, tx, ty, qxf.shape[0],
    )
    return cell.reshape(qx.shape), tx.reshape(qx.shape), ty.reshape(qx.shape)


def _launch_cell_index_counted(x, y, qx, qy):
    out = _launch_cell_index(x, y, qx, qy)
    fused_cell_index.launches += 1
    return out


def _cell_fracs(x, y, qx, qy, cell):
    """R1's fractions with the cell fixed: the function its backward
    differentiates (``_cell_index_bwd``, ``pallas_eval.py:562``)."""
    ny1 = y.shape[0] - 1
    xi = torch.div(cell, ny1, rounding_mode="floor")
    return _frac(x, qx, xi), _frac(y, qy, cell - xi * ny1)


def _eval_backward(ctx, g):
    """The VJP of :func:`_eval_plain`, as the JAX package's ``_fused_bwd``
    (``pallas_eval.py:351``).  The knots reach the value only through the
    search, so they get no gradient (``None``, as autograd of the plain
    version gives them), where the VJP would give zeros."""
    need = (False, *ctx.needs_input_grad[1:])
    return _cuda.plain_vjp(_eval_plain, ctx.saved_tensors, need, g)


def _index_frac_backward(ctx, g_idx, g_t):
    """The VJP of the fraction with the interval fixed, as
    ``_index_frac_bwd`` (``pallas_eval.py:448``); the index has no
    gradient."""
    knots, q, idx = ctx.saved_tensors
    return _cuda.plain_vjp(lambda k, q_: _frac(k, q_, idx), (knots, q), ctx.needs_input_grad, g_t)


def _cell_index_backward(ctx, g_cell, g_tx, g_ty):
    """The VJP of the fractions with the cell fixed (:func:`_cell_fracs`);
    the cell has no gradient."""
    x, y, qx, qy, cell = ctx.saved_tensors
    return _cuda.plain_vjp(
        lambda *a: _cell_fracs(*a, cell), (x, y, qx, qy), ctx.needs_input_grad, (g_tx, g_ty)
    )


def _index_like(q):
    return torch.empty(q.shape, dtype=torch.int32, device=q.device)


# K1: forward the kernel (its plain version on the CPU); under vmap batched
# queries flatten into one launch, batched tables take the plain version.
_EVAL_1D = _cuda.kernel_op(
    "fused_eval_1d", "(Tensor knots, Tensor tbl, Tensor q) -> Tensor",
    lambda knots, tbl, q: _cuda.run("fused_eval_1d", q, _launch_eval, _eval_plain, knots, tbl, q),
    lambda knots, tbl, q: q.new_empty(q.shape),
    setup_context=_cuda.save_inputs, backward=_eval_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _eval_plain, info, in_dims, args, (2,)),
)
# K2
_INDEX_FRAC = _cuda.kernel_op(
    "fused_index_frac", "(Tensor knots, Tensor q) -> (Tensor, Tensor)",
    lambda knots, q: _cuda.run("fused_index_frac", q, _launch_index_frac, _index_frac_plain,
                               knots, q),
    lambda knots, q: (_index_like(q), q.new_empty(q.shape)),
    setup_context=_cuda.save_inputs_and_index, backward=_index_frac_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _index_frac_plain, info, in_dims, args, (1,)),
)
# K3: its output, an index, is not differentiable
_LOWER_INDEX = _cuda.kernel_op(
    "fused_lower_index", "(Tensor knots, Tensor q) -> Tensor",
    lambda knots, q: _cuda.run("fused_lower_index", q, _launch_lower_index, get_lower_index,
                               knots, q),
    lambda knots, q: _index_like(q),
    setup_context=None, backward=lambda ctx, g: (None, None),
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, get_lower_index, info, in_dims, args, (1,)),
)
# R1
_CELL_INDEX = _cuda.kernel_op(
    "fused_cell_index", "(Tensor x, Tensor y, Tensor qx, Tensor qy) -> (Tensor, Tensor, Tensor)",
    lambda x, y, qx, qy: _cuda.run("fused_cell_index", qx, _launch_cell_index_counted,
                                   _cell_index_plain, x, y, qx, qy),
    lambda x, y, qx, qy: (_index_like(qx),
                          qx.new_empty(qx.shape),
                          qy.new_empty(qy.shape)),
    setup_context=_cuda.save_inputs_and_index, backward=_cell_index_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _cell_index_plain, info, in_dims, args, (2, 3)),
)


def fused_eval_1d(knots, tbl, q):
    """Evaluate the piecewise cubic (symmetric Hermite form) defined by
    ``tbl[:, :6] = [x_l, x_r, y_l, y_r, a, b]`` at the queries ``q``.

    knots (n,), n >= 2; tbl (n-1, >=6); q any shape, same dtype.  A CPU
    tensor takes :func:`_eval_plain`; a CUDA tensor launches K1 (float32 or
    float64; other dtypes raise ``TypeError``).  Composes with
    ``torch.func`` (``vmap``, ``grad``) on both devices."""
    return _EVAL_1D(knots, tbl, q)


def fused_index_frac(knots, q):
    """``(get_lower_index(knots, q), t)`` with ``t = (q - x_l) / (x_r - x_l)``;
    idx is int32.  CPU: :func:`_index_frac_plain`; CUDA: K2."""
    return _INDEX_FRAC(knots, q)


def fused_lower_index(knots, q):
    """``get_lower_index(knots, q)`` (int32).  CPU: the plain search;
    CUDA: K3."""
    return _LOWER_INDEX(knots, q)


def fused_cell_index(x, y, qx, qy):
    """Both 2-D axis searches: ``(cell, tx, ty)`` with the flat cell
    ``xi * (ny - 1) + yi`` (int32; ``xi``, ``yi`` the clamped
    ``get_lower_index`` of each axis, so ±inf clamps to the edge cells and
    a NaN query takes ``n - 2`` on its axis) and the fractions
    ``(q - x_l) / (x_r - x_l)`` of K2.  x (nx,), y (ny,); qx, qy of one
    shape.  ``tx``/``ty`` are differentiable in ``x, y, qx, qy``, ``cell``
    is not.  CPU: :func:`_cell_index_plain`; CUDA: R1."""
    _check_cell_axes(x, y, qx, qy)
    return _CELL_INDEX(x, y, qx, qy)


fused_eval_1d.launches = 0
fused_index_frac.launches = 0
fused_lower_index.launches = 0
fused_cell_index.launches = 0
