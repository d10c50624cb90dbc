"""Long-knot-axis evaluation (``K1_MAX_KNOTS`` < n <= ``MAX_BIG_KNOTS``):
the wrappers of R3 and R3idx.

Counterpart of ``ndarray_interp_tpu.ops.bigknots``.  The JAX package splits
the search in two (the block of W knots from a search of the block leaders,
then a refine inside the block's packed row) because its one-pass kernels
stop at 65,536 knots.  The CUDA kernels (``csrc/bigknots_kernels.cu``) do
a two-level search, the row reads and the Hermite form in one launch, both
on every w-th knot staged as a breadth-first tree of ``_R3_TREE_BYTES``
(R3: K1's body reading its rows from the four 1-D arrays; R3idx: K2's
staged kernel, its fraction's endpoints from the knot array):

* :func:`big_eval_1d` (R3): the value, bit-identical to K1's plain version
  ``eval_kernels._eval_plain``;
* :func:`big_lower_index_frac` (R3idx): ``(idx, t)``, bit-identical to K2's
  plain version ``eval_kernels._index_frac_plain``.

Their plain versions here follow the JAX package's XLA form: the block from
``get_lower_index`` over the leaders (``_geometry``'s W, the axis padded
with ``finfo.max`` as ``_pad_knots`` pads it), then the count inside the
block's window with the ``[0, n-2]`` clamp.  Two differences, both kept on
purpose: the interval's values are selected by index, not by the JAX
mask-sum (``bigknots.py:152-164``), which NaNs a whole W-knot block on one
NaN datum; and a NaN query gets index ``n-2``, as K2 and
``get_lower_index`` give, where the JAX search gives 0 (the value is NaN
either way).
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .eval_kernels import _eval_plain, _frac, make_interval_table
from .searchsorted import get_lower_index

# largest axis whose W = 128 leader vector satisfies C + 1 <= 65536 (the JAX
# package's windowed plan cap): 65535 * 128
MAX_BIG_KNOTS = 65535 * 128

# The K1/R3 split: float32 axes of more knots than this take the long-axis
# kernels (R3 for scalar data, R3idx for a bank's (idx, t)), shorter ones K1
# and K2.  One constant for every route that splits (``can_use_big``, the bank
# route of ``models/strategies/cubic.py`` and ``knotshard``), placed at the
# crossover the card measured for both pairs (NVIDIA H100 80GB HBM3, 700.00 W;
# ``tools/route_phases.py --sweeps`` rule 2, 1M f32 queries, uniform and
# non-uniform axes, PERF.md PR 24): at 65,537 knots K1 and K2 won (0.0502
# against R3's 0.0531 ms; 0.0944 against 0.0996 for a bank of 8), from 81,920
# R3idx won (0.1138 against 0.1175) and R3 tied (0.0541 against 0.0536) until
# it won from 131,072 (0.0536 against 0.0595).  The JAX package's 65,536 is
# its one-pass kernels' plan limit.
K1_MAX_KNOTS = 81_919


def long_axis(n) -> bool:
    """Whether an axis of ``n`` float32 knots takes R3 / R3idx."""
    return K1_MAX_KNOTS < n <= MAX_BIG_KNOTS


def _block_w(n):
    """Block width of the JAX package: the smallest tier keeping the leader
    vector within its windowed kernel's plan (C + 1 <= 65536)."""
    for w in (16, 32, 64, 128):
        if -(-n // w) + 1 <= 65536:
            return w
    raise ValueError(f"knot axis too long: {n}")


def _geometry(n):
    w = _block_w(n)
    c = -(-n // w)  # blocks of W knots (ceil)
    c1 = max(2, math.isqrt(c - 1) + 1)
    c2 = -(-c // c1)
    return w, c, c1, c2


def _pad_knots(knots, w, c1, c2):
    """knots padded to C1*C2*W + 1 with the largest finite value, the JAX
    package's out-of-range sentinel."""
    n = knots.shape[0]
    total = c1 * c2 * w + 1
    big = torch.finfo(knots.dtype).max
    return torch.cat([knots, knots.new_full((total - n,), big)])


def can_use_big(x, data) -> bool:
    """Shape and dtype eligibility of the R3 route (``bigknots.py:197-203``)."""
    return (
        x.dtype == torch.float32
        and data.dtype == torch.float32
        and data.ndim == 1
        and long_axis(x.shape[0])
    )


def _big_index_plain(knots, q):
    """Plain version of R3's search: ``get_lower_index(knots, q)`` computed
    the JAX package's two-level way (int32, shaped like ``q``)."""
    n = knots.shape[0]
    w, c, c1, c2 = _geometry(n)
    kp = _pad_knots(knots, w, c1, c2)
    leaders = torch.cat([kp[: c * w : w], kp.new_full((1,), torch.finfo(kp.dtype).max)])
    qf = q.reshape(-1)
    block = get_lower_index(leaders, qf).long().clamp(max=(n - 2) // w)
    window = kp[block[:, None] * w + torch.arange(w, device=q.device)]  # (Q, W)
    fine = (window <= qf[:, None]).sum(dim=1)
    idx = (block * w + fine - 1).clamp(0, n - 2)
    idx = torch.where(torch.isnan(qf), n - 2, idx)
    return idx.to(torch.int32).reshape(q.shape)


def _big_eval_plain(knots, data, a, b, q):
    """Plain version of R3: :func:`_big_index_plain`, then the interval's
    values by index and the symmetric Hermite form with the ``lin_inf``
    lerp (``bigknots.py:166-170``)."""
    i = _big_index_plain(knots, q).long()
    x_l, x_r = knots[i], knots[i + 1]
    y_l, y_r, ga, gb = data[i], data[i + 1], a[i], b[i]
    t = (q - x_l) / (x_r - x_l)
    base = (1 - t) * y_l + t * y_r + t * (1 - t) * (ga * (1 - t) + gb * t)
    lin_inf = torch.isinf(t) & (ga == 0) & (gb == 0)
    return torch.where(lin_inf, y_l + t * (y_r - y_l), base)


def _big_index_frac_plain(knots, q):
    """Plain version of R3idx: ``(idx, t)``."""
    idx = _big_index_plain(knots, q)
    return idx, _frac(knots, q, idx)


def _check(name, knots, q, *tables):
    dtype = _cuda.float_operands(name, q, knots, *tables)
    n = knots.shape[0]
    if knots.ndim != 1 or not 2 <= n <= MAX_BIG_KNOTS:
        raise ValueError(f"{name}: knots must be 1-D with 2 to {MAX_BIG_KNOTS} entries")
    return dtype


# R3's shared-memory budget: the axis staged as a breadth-first tree of every
# w-th knot in at most _R3_TREE_BYTES (past 65,536 knots never whole; w the
# least power of two that fits), the search ending between two leaders on the
# global axis; at one knot every level runs on the global axis, at zero the
# first design (512 sorted f32 leaders in 2 KB, big_lower_index).  On an H100
# 80GB HBM3 at 700 W (tools/search_phases.py --sweeps, 1M f32 queries), trees
# of 16 / 32 / 64 / 128 KB at 262,144 knots 0.0791 / 0.0785 / 0.0802 / 0.0509
# ms (first design 0.0772), at 8,388,480 0.1691 / 0.1694 / 0.1797 / 0.1672
# (0.1685).  128 KB is the largest f32 tree tree_budget lets a block hold
# (32,767 knots), so neither it nor this budget had to change to reach it.
_R3_TREE_BYTES = 128 << 10

# R3idx (big_lower_index_frac) stages the same tree at every length; budget 0
# runs its first design (the sorted leaders in 2 KB, big_lower_index), kept
# for timing.  On an H100 80GB HBM3 at 700 W (tools/search_phases.py --phases
# r3idx --sweeps, 1M queries, ms, first design / 128 KB tree): f32 65,537
# knots 0.0290 / 0.0350, 98,304 0.0327 / 0.0386, 131,072 0.0396 / 0.0378,
# 196,608 0.0455 / 0.0418, 262,144 0.0519 / 0.0416, 8,388,480 0.0998 /
# 0.0923; f64 65,537 0.0432 / 0.0364, 262,144 0.0651 / 0.0445.  The first
# design wins only on f32 axes of at most 384 KB, which no path measured end
# to end sends R3idx (NS1b's bank has 262,144 knots), so one design serves
# every length; trees of 16-64 KB lost everywhere.


def _launch_eval(knots, data, a, b, q):
    dtype = _check("big_eval_1d", knots, q, data, a, b)
    n = knots.shape[0]
    if data.shape != (n,) or a.shape != (n - 1,) or b.shape != (n - 1,):
        raise ValueError(
            f"big_eval_1d: data must be ({n},) and a, b ({n - 1},); got "
            f"{tuple(data.shape)}, {tuple(a.shape)}, {tuple(b.shape)}"
        )
    qf = q.reshape(-1).contiguous()
    out = torch.empty_like(qf)
    _cuda.launch(
        "ndi_big_eval", dtype, q.device,
        knots.contiguous(), knots.shape[0], data.contiguous(), a.contiguous(),
        b.contiguous(), _R3_TREE_BYTES // qf.element_size() - 1, qf, out, qf.shape[0],
    )
    big_eval_1d.launches += 1
    return out.reshape(q.shape)


def _launch_index_frac(knots, q):
    dtype = _check("big_lower_index_frac", knots, q)
    qf = q.reshape(-1).contiguous()
    idx = torch.empty(qf.shape, dtype=torch.int32, device=q.device)
    t = torch.empty_like(qf)
    _cuda.launch(
        "ndi_big_index_frac", dtype, q.device,
        knots.contiguous(), knots.shape[0], _R3_TREE_BYTES // qf.element_size() - 1, qf, idx,
        t, qf.shape[0],
    )
    big_lower_index_frac.launches += 1
    return idx.reshape(q.shape), t.reshape(q.shape)


def _interval_form(knots, data, a, b, q):
    return _eval_plain(knots, make_interval_table(knots, data, a, b), q)


def _eval_backward(ctx, g):
    """The VJP of K1's plain version on the interval table, as the JAX
    package's ``_be_bwd`` (``bigknots.py:233-242``) is the VJP of its gather
    formulation."""
    return _cuda.plain_vjp(_interval_form, ctx.saved_tensors, ctx.needs_input_grad, g)


def _index_frac_backward(ctx, g_idx, g_t):
    """The VJP of the fraction with the interval fixed, as K2's; the index
    has no gradient."""
    knots, q, idx = ctx.saved_tensors
    return _cuda.plain_vjp(lambda k, q_: _frac(k, q_, idx), (knots, q), ctx.needs_input_grad, g_t)


# R3: forward the kernel (_big_eval_plain on the CPU); under vmap batched
# queries flatten into one launch, batched tables take the plain version
_BIG_EVAL = _cuda.kernel_op(
    "big_eval_1d", "(Tensor knots, Tensor data, Tensor a, Tensor b, Tensor q) -> Tensor",
    lambda knots, data, a, b, q: _cuda.run("big_eval_1d", q, _launch_eval, _big_eval_plain,
                                           knots, data, a, b, q),
    lambda knots, data, a, b, q: q.new_empty(q.shape),
    setup_context=_cuda.save_inputs, backward=_eval_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _big_eval_plain, info, in_dims, args, (4,)),
)
# R3idx
_BIG_INDEX_FRAC = _cuda.kernel_op(
    "big_lower_index_frac", "(Tensor knots, Tensor q) -> (Tensor, Tensor)",
    lambda knots, q: _cuda.run("big_lower_index_frac", q, _launch_index_frac,
                               _big_index_frac_plain, knots, q),
    lambda knots, q: (torch.empty(q.shape, dtype=torch.int32, device=q.device),
                      q.new_empty(q.shape)),
    setup_context=_cuda.save_inputs_and_index, backward=_index_frac_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _big_index_frac_plain, info, in_dims, args, (1,)),
)


def big_eval_1d(knots, data, a, b, q):
    """Hermite evaluation of a scalar spline on a long knot axis: knots and
    data (n,), a and b (n-1,) (zeros for a linear table), q any shape.
    CPU tensors: :func:`_big_eval_plain`; CUDA: R3."""
    return _BIG_EVAL(knots, data, a, b, q)


def big_lower_index_frac(knots, q):
    """``(idx, t)`` of the queries on a long knot axis: idx int32 in
    ``[0, n-2]`` (NaN -> n-2), ``t = (q - x_l) / (x_r - x_l)``.  CPU
    tensors: :func:`_big_index_frac_plain`; CUDA: R3idx."""
    return _BIG_INDEX_FRAC(knots, q)


big_eval_1d.launches = 0
big_lower_index_frac.launches = 0
