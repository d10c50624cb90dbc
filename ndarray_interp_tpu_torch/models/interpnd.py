"""N-dimensional rectilinear-grid interpolation.

Counterpart of ``ndarray_interp_tpu.models.interpnd``: evaluation and
calculus.  Interpolation over the leading ``k`` axes of ``data``,
with SciPy's ``RegularGridInterpolator`` methods ``"linear"``,
``"nearest"`` and ``"cubic"`` (the tensor-product C² spline with per-axis
boundary families).  The 1-D/2-D call conventions carry over: query dims
lead and the output has ``M + N - k`` dims, the ``k`` query arrays share
one shape, eager calls raise on out-of-range queries and the pure
``__call__`` masks them to NaN, extrapolation extends the edge cells.

Each axis's ``(idx, t)`` pass is the search kernel K2 on the GPU
(``bicubic._index_frac``); the cubic state comes from the batched spline
solves along each axis, K4 on the GPU.  Then one row gather a query from a
packed table and a weighted sum, in plain PyTorch, as they are XLA (not
Pallas) in the JAX package:

* ``"linear"``: the ``2^k`` corner blocks of each cell in one row
  (:func:`pack_corner_rows_nd`), up to ``config.interpnd_pack_max_elems``
  table elements; above that the ``2^k`` corner values are gathered from
  the data;
* ``"cubic"``, layout ``"cell"``: the ``4^k`` pre-scaled corner quantities
  of each cell in one row (:func:`pack_cubic_rows_nd`); layouts ``"node"``,
  ``"node2"``, ``"node4"``: node rows of raw state and coordinates
  (:func:`pack_cubic_nodes_nd`), ``2^(k-m)`` gathers a query at about
  ``2^m·2^k`` times the data's memory.  :meth:`InterpND.build_state`
  takes the cell layout wherever it fits the cap, else the node layout the
  card ran fastest at that ``k`` and ``r``, by
  :meth:`InterpND.route_cost_ns` (the JAX package ranks the node layouts
  by a TPU cost model: ROADMAP Queue 3, route divergences).

Devices as in :mod:`.interp1d`: tensors keep their device, numpy arrays
and lists land on the builder's ``device`` (the GPU unless named).
Autograd flows through evaluation.

Calculus: :meth:`InterpND.derivative` evaluates a mixed partial with the
per-axis t-derivatives of the bases (:func:`_linear_basis_d`,
:func:`_cubic_basis`) and the ``1/dx`` chain factors
(:func:`_dx_chain_factor`) on the same gathers as the value, so it runs K2
on each axis; :meth:`InterpND.integrate` is the exact box quadrature
:func:`integrate_box`, which the 2-D strategies' ``integrate`` also uses and
whose cubic node grids come from the spline solves again (K4).  The
checkpoint codec is in :mod:`..utils.checkpoint`; the pytree protocol is
not ported, PyTorch does not need it.

Compiled programs: as the JAX package runs cached ``jax.jit`` programs
behind the plain API, an evaluation on the card runs the ``torch.compile``
program of the same name: ``_eval_flat`` (``eval_unchecked``),
``_eval_flat_masked`` (``__call__``) and ``_eval_flat_deriv``
(``derivative``), each from :func:`..serving.compile_program` (inductor,
``fullgraph=True``, a code object of its own).  One program serves a key:
the key the JAX package's ``lru_cache`` / ``static_argnums`` take, and the
dtypes, ranks and gradients of the inputs (:func:`_signature`).  The
interpolator's tensors are its inputs, and the query axis and the grid's
sizes are dynamic (:func:`_dynamic_grid`).  Its first call compiles it, as
``jax.jit`` compiles on its first call: seconds for the cell layout, up to
about a minute for a node layout.  The eager checks stay outside the
program.  The JAX package's two other programs, the
box integral (``_integrate_fn``) and the cubic build's pack
(``_cubic_pack_fn``), run op by op here: compiled, each took tens of seconds
on its first call to save about 13 ms a call on an H100, so a process gains
only after thousands of builds or boxes of one key.  Every body runs inline,
as a nested ``jax.jit`` is inlined, under an outer ``torch.compile`` or a
``torch.func`` transform (:func:`..ops._cuda.traced`), for DTensor queries
(each rank's shard) and on CPU tensors.
``torch.compiler.set_stance("force_eager")`` runs every program's body
eagerly, as ``jax.disable_jit()`` does.
"""

from __future__ import annotations

import functools
import itertools
import math

import torch

from .. import config
from ..errors import MonotonicError, NotEnoughDataError, OutOfBoundsError, ShapeError
from ..ops._cuda import traced
from ..ops.partition import is_dtensor, local_call
from ..ops.searchsorted import is_in_range
from ..utils.device import default_device
from ..utils.monotonic import monotonic_prop
from .interp1d import _check_buffer, _to_tensor, _write
from .strategies.bicubic import _AXIS_KINDS, _index_frac, _solve_axis0

_METHODS = ("linear", "nearest", "cubic")
_BCS = tuple(_AXIS_KINDS)  # not_a_knot / natural / clamped / periodic

# pairing degree m per cubic table layout (gathers per query = 2^(k-m))
_NODE_PAIRS = {"node": 0, "node2": 1, "node4": 2}
# ns a query of each cubic layout's eval on the card, c0 + c1·r, by axes
# (InterpND.route_cost_ns): least-squares fits to r = 1, 4, 16 (within 9%)
_LAYOUT_NS = {
    1: {"cell": (0.890, 0.0231), "node": (0.397, 0.0574)},
    2: {"cell": (1.060, 0.0791), "node": (1.170, 0.2023), "node2": (1.265, 0.1878)},
    3: {"cell": (1.299, 0.4095), "node": (4.726, 0.7308), "node2": (7.388, 0.5013),
        "node4": (5.329, 0.6876)},
    4: {"cell": (1.669, 1.9195), "node": (29.552, 1.9504), "node2": (20.965, 2.7224),
        "node4": (22.363, 2.6767)},
}


def _strides(shape):
    """Row-major strides of ``shape`` (the last axis fastest)."""
    out = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        out[d] = out[d + 1] * shape[d + 1]
    return out


def _flat_index(idx, shape):
    return sum(i.long() * s for i, s in zip(idx, _strides(shape)))


def pack_corner_rows_nd(data, k):
    """Per-cell rows ``(cells, 2^k·r)``: the ``2^k`` corner blocks of each
    cell (``r = prod(trailing)`` channels each) in
    :func:`itertools.product` corner order, the weight order of the eval."""
    grid = tuple(data.shape[:k])
    r = math.prod(data.shape[k:])
    cells = tuple(n - 1 for n in grid)
    blocks = [
        data[tuple(slice(1, None) if d else slice(None, -1) for d in c)].reshape(cells + (r,))
        for c in itertools.product((0, 1), repeat=k)
    ]
    return torch.stack(blocks, dim=k).reshape(math.prod(cells), (2**k) * r)


def _linear_basis_d(t, order):
    """The multilinear basis ``[w_left, w_right]`` of one axis at
    t-derivative ``order``: ``[1-t, t]``, ``[-1, 1]``, zeros from order 2
    (the blend is affine in each cell)."""
    if order == 0:
        return [1 - t, t]
    if order == 1:
        one = torch.ones_like(t)
        return [-one, one]
    z = torch.zeros_like(t)
    return [z, z]


def _corner_weights(ts, k, orders=None):
    """(Q, 2^k) multilinear weights in ``itertools.product`` corner order
    (the block order of :func:`pack_corner_rows_nd`); ``orders`` selects each
    axis's basis t-derivative (the caller applies the ``1/dx`` chain
    factors)."""
    orders = orders or (0,) * k
    bases = [_linear_basis_d(t, o) for t, o in zip(ts, orders)]
    w = []
    for c in itertools.product((0, 1), repeat=k):
        wc = bases[0][c[0]]
        for d in range(1, k):
            wc = wc * bases[d][c[d]]
        w.append(wc)
    return torch.stack(w, dim=-1)


def _dx_chain_factor(axes, idx, orders, dtype):
    """``prod_d dx_d^(-o_d)`` a query, the chain-rule factor that turns
    t-derivatives into x-derivatives, the widths in ``dtype`` (the
    weights'); ``None`` when every order is 0."""
    f = None
    for d, o in enumerate(orders):
        if o:
            i = idx[d].long()
            g = (axes[d][i + 1] - axes[d][i]).to(dtype) ** (-o)
            f = g if f is None else f * g
    return f


def interpnd_node_grids(axes, data, k, bcs):
    """All ``2^k`` mixed-derivative node grids of the tensor-product cubic
    spline: ``grids[mask]`` (bit ``d`` for axis ``d``) holds
    ``∂^{|mask|} data / ∏_{d∈mask} ∂x_d`` at the nodes, from the batched
    1-D spline solve applied along each axis in ascending order."""
    grids = {0: data}
    for d in range(k):
        for e in sorted(grids):
            kd = _solve_axis0(axes[d], torch.movedim(grids[e], d, 0), bcs[d])
            grids[e | (1 << d)] = torch.movedim(kd, 0, d)
    return grids


def _cubic_digit_channels(k):
    """Channel order of the cubic routes: one base-4 digit per axis (axis 0
    most significant), ``digit = 2*deriv + side``; the weight order of
    :func:`_cubic_weights`."""
    return list(itertools.product(range(4), repeat=k))


def pack_cubic_rows_nd(axes, data, k, grids):
    """Per-cell rows ``(cells, 4^k·r)`` of the tensor-product cubic: every
    mixed derivative at every corner, the derivatives pre-scaled by their
    cell's interval widths, so one gathered row feeds the whole ``k``-fold
    Hermite blend."""
    grid = tuple(data.shape[:k])
    r = math.prod(data.shape[k:])
    cells = tuple(n - 1 for n in grid)
    dxs = [(ax[1:] - ax[:-1]).to(data.dtype) for ax in axes]
    blocks = []
    for digits in _cubic_digit_channels(k):
        mask = sum(1 << d for d, dig in enumerate(digits) if dig >= 2)
        sl = tuple(slice(1, None) if dig & 1 else slice(None, -1) for dig in digits)
        block = grids[mask][sl].reshape(cells + (r,))
        for d, dig in enumerate(digits):
            if dig >= 2:
                shape = [1] * (k + 1)
                shape[d] = cells[d]
                block = block * dxs[d].reshape(shape)
        blocks.append(block)
    return torch.stack(blocks, dim=k).reshape(math.prod(cells), (4**k) * r)


def _shift_edge(g, axis):
    """``g`` moved one step down ``axis``, the last slice repeated."""
    n = g.shape[axis]
    return torch.cat([g.narrow(axis, 1, n - 1), g.narrow(axis, n - 1, 1)], dim=axis)


def pack_cubic_nodes_nd(axes, data, k, grids, pairs=0):
    """Node table ``(prod(n), 2^m·2^k·r + k + m)``: the raw (unscaled)
    mixed-derivative state of each node, subset masks ascending, then its
    ``k`` coordinates.  ``pairs = m``: the row also carries the state of its
    ``2^m - 1`` neighbours along the last ``m`` axes (edge nodes repeat;
    those rows never start a gather) and the ``m`` next-node coordinates,
    so a query gathers ``2^(k-m)`` rows instead of ``2^k``."""
    grid = tuple(data.shape[:k])
    m = pairs
    r = math.prod(data.shape[k:])
    state = torch.cat([grids[e].reshape(grid + (r,)) for e in range(2**k)], dim=-1)
    blocks = []
    for delta in itertools.product((0, 1), repeat=m):
        g = state
        for j, bit in enumerate(delta):
            if bit:
                g = _shift_edge(g, k - m + j)
        blocks.append(g)
    coords = torch.meshgrid(*[ax.to(data.dtype) for ax in axes], indexing="ij")
    blocks += [c[..., None] for c in coords]
    for j in range(m):
        blocks.append(_shift_edge(coords[k - m + j], k - m + j)[..., None])
    return torch.cat(blocks, dim=-1).reshape(math.prod(grid), (2**m) * (2**k) * r + k + m)


# -- exact box quadrature (the 2-D strategies' integrate) ----------------------------
def _linear_antider(t):
    """Antiderivatives ``[B0, B1]`` of the multilinear basis ``[1-t, t]``."""
    return [t - 0.5 * t * t, 0.5 * t * t]


def _cubic_antider(t):
    """Antiderivatives ``[H00, H01, H10, H11]`` of the Hermite basis."""
    t2 = t * t
    t3 = t2 * t
    t4 = t2 * t2
    return [
        0.5 * t4 - t3 + t,
        t3 - 0.5 * t4,
        0.25 * t4 - (2.0 / 3.0) * t3 + 0.5 * t2,
        0.25 * t4 - t3 / 3.0,
    ]


def _axis_integral_weights(x, lo, hi, method, extrapolate):
    """Per-cell integral weights of one axis, ``W[i, digit] =
    dx_i^(1+deriv) · (H_digit(t1_i) - H_digit(t0_i))`` over the overlap of
    ``[lo, hi]`` with cell ``i`` (the 1-D quadrature per axis).  When
    extrapolating, the edge cells' polynomials extend beyond the grid."""
    dx = x[1:] - x[:-1]
    nc = dx.shape[0]
    t0 = (lo - x[:-1]) / dx
    t1 = (hi - x[:-1]) / dx
    lo_clip, hi_clip = torch.zeros_like(dx), torch.ones_like(dx)
    if extrapolate:
        big = torch.finfo(x.dtype).max
        lo_clip[0], hi_clip[-1] = -big, big
    anti = _cubic_antider if method == "cubic" else _linear_antider
    h0 = anti(torch.clamp(t0, lo_clip, hi_clip))
    h1 = anti(torch.clamp(t1, lo_clip, hi_clip))
    cols = [dx * (h1[j] - h0[j]) for j in range(2)]
    if method == "cubic":  # derivative channels: raw k times dx^2
        cols += [dx * dx * (h1[j] - h0[j]) for j in (2, 3)]
    return torch.stack(cols, dim=-1)  # (n-1, 2 or 4)


def _axis_node_weights(w, deriv):
    """Per-cell side weights scattered onto the nodes: node ``m`` takes the
    left weight of cell ``m`` and the right weight of cell ``m - 1``."""
    z = w.new_zeros(1)
    return torch.cat([w[:, 2 * deriv], z]) + torch.cat([z, w[:, 2 * deriv + 1]])


def integrate_box(axes, data, los, his, method, bcs, extrapolate):
    """The exact integral of the tensor-product interpolant over the box
    ``[los[d], his[d]]`` of each of the ``k = len(axes)`` axes, per trailing
    element: per-axis integral weights contracted against the
    (mixed-derivative, for cubic: the spline solves, K4 on the GPU) node
    grids, ``2^k`` tensor contractions, no sampling
    (``interpnd._integrate_fn`` of the JAX package; op by op on a plain
    call, see the module's docstring)."""
    k = len(axes)
    grids = interpnd_node_grids(axes, data, k, bcs) if method == "cubic" else {0: data}
    ws = [_axis_integral_weights(ax, los[d], his[d], method, extrapolate)
          for d, ax in enumerate(axes)]
    out = None
    for mask in sorted(grids):
        g = grids[mask]
        for d in reversed(range(k)):
            u = _axis_node_weights(ws[d], (mask >> d) & 1)
            dt = torch.promote_types(g.dtype, u.dtype)  # promote: integer data
            g = torch.tensordot(g.to(dt), u.to(dt), dims=([d], [0]))
        out = g if out is None else out + g
    return out


def _cubic_basis(t, order=0):
    """(Q, 4) Hermite basis ``[h00, h01, h10, h11]`` for pre-scaled
    derivatives (``K = k·dx``), or its ``order``-th t-derivative (orders
    0-3; zero above): the symmetric reference Hermite
    (``cubic_spline.rs:818-828``) expanded in the corner state."""
    if order == 0:
        omt = 1 - t
        cols = (omt * omt * (1 + 2 * t), t * t * (3 - 2 * t), t * omt * omt, -t * t * omt)
    elif order == 1:
        cols = (6 * t * t - 6 * t, 6 * t - 6 * t * t, 3 * t * t - 4 * t + 1, 3 * t * t - 2 * t)
    elif order == 2:
        cols = (12 * t - 6, 6 - 12 * t, 6 * t - 4, 6 * t - 2)
    elif order == 3:
        z12 = torch.full_like(t, 12.0)
        cols = (z12, -z12, torch.full_like(t, 6.0), torch.full_like(t, 6.0))
    else:
        z = torch.zeros_like(t)
        cols = (z, z, z, z)
    return torch.stack(cols, dim=-1)


def _cubic_weights(ts, k, orders=None):
    """(Q, 4^k) tensor-product Hermite weights in
    :func:`_cubic_digit_channels` order; ``orders`` selects each axis's basis
    t-derivative (the caller applies the ``1/dx`` chain factors)."""
    orders = orders or (0,) * k
    w = torch.ones(ts[0].shape + (1,), dtype=ts[0].dtype, device=ts[0].device)
    for t, o in zip(ts, orders):
        b = _cubic_basis(t, o)
        w = (w[:, :, None] * b[:, None, :]).reshape(w.shape[0], -1)
    return w


def _eval_cubic(interp, idx, ts, trailing, orders=None):
    """Tensor-product cubic at per-axis ``(idx, t)``: one cell-row gather
    (cell layout) or ``2^(k-m)`` node-row gathers (node layouts).  ``orders``
    evaluates the mixed partial ``d^(sum o) / prod dx_d^(o_d)`` instead (the
    bases' t-derivatives and the ``1/dx`` chain factors)."""
    k = interp.k
    grid = tuple(interp.data.shape[:k])
    r = math.prod(trailing)
    q = idx[0].shape[0]
    w = _cubic_weights(ts, k, orders)  # (Q, 4^k)
    if orders is not None:
        f = _dx_chain_factor(interp.axes, idx, orders, w.dtype)
        if f is not None:
            w = w * f[:, None]
    if interp.layout == "cell":
        cell = _flat_index(idx, tuple(n - 1 for n in grid))
        rows = interp.table.index_select(0, cell).reshape(q, 4**k, r)
        return torch.sum(rows * w[:, :, None], dim=1).reshape((q,) + trailing)

    # node layouts: the blend accumulates in the same (s_corner, mask) order
    # with the same values for every m, so all node layouts are bit-identical
    m = _NODE_PAIRS[interp.layout]
    sb = (2**k) * r  # one state block
    cbase = (2**m) * sb  # the coordinate channels start here
    nstrides = _strides(grid)
    base = _flat_index(idx, grid)
    corner_rows = {}
    for s_low in itertools.product((0, 1), repeat=k - m):
        off = sum(d * st for d, st in zip(s_low, nstrides[: k - m]))
        corner_rows[s_low] = interp.table.index_select(0, base + off)
    # interval widths: gathered axes from the all-ones corner row, paired
    # axes from the base row's stored next-node coordinate
    lo = corner_rows[(0,) * (k - m)]
    hi = corner_rows[(1,) * (k - m)]
    dxs = [(hi[:, cbase + d] - lo[:, cbase + d])[:, None] for d in range(k - m)] + [
        (lo[:, cbase + k + j] - lo[:, cbase + (k - m) + j])[:, None] for j in range(m)
    ]
    out = torch.zeros((q, r), dtype=lo.dtype, device=lo.device)
    for s_corner in itertools.product((0, 1), repeat=k):
        g = corner_rows[s_corner[: k - m]]
        p = 0
        for bit in s_corner[k - m :]:
            p = 2 * p + bit  # the in-row neighbour block (product order)
        for mask in range(2**k):
            # channel of (deriv set = mask, side = s_corner) in the weight
            # order: per-axis digit 2*deriv + side, axis 0 most significant
            ch = 0
            for d in range(k):
                ch = ch * 4 + 2 * ((mask >> d) & 1) + s_corner[d]
            scale = w[:, ch][:, None]
            for d in range(k):
                if (mask >> d) & 1:
                    scale = scale * dxs[d]
            out = out + scale * g[:, p * sb + mask * r : p * sb + (mask + 1) * r]
    return out.reshape((q,) + trailing)


def _eval_core(interp, flats, orders=None):
    """Evaluate at flat query vectors, one per interpolated axis; ``orders``
    (per-axis ints) evaluates the mixed partial instead of the value."""
    data = interp.data
    k = interp.k
    grid = tuple(data.shape[:k])
    trailing = tuple(data.shape[k:])
    idx, ts = [], []
    for d, (ax, q) in enumerate(zip(interp.axes, flats)):
        if interp.wraps_axis(d):  # rem_euclid wrap, cubic_spline.rs:804-809
            q = torch.remainder(q - ax[0], ax[-1] - ax[0]) + ax[0]
        i, t = _index_frac(ax, q)  # i clamped to [0, n-2]
        idx.append(i)
        ts.append(t)

    if interp.method == "cubic":
        return _eval_cubic(interp, idx, ts, trailing, orders)

    if interp.method == "nearest":
        # per-axis nearest node, ties toward the lower node; the clamped
        # interval makes out-of-range queries pick the edge node
        near = [torch.where(t <= 0.5, i, i + 1) for i, t in zip(idx, ts)]
        return data.reshape((-1,) + trailing).index_select(0, _flat_index(near, grid))

    w = _corner_weights(ts, k, orders)  # (Q, 2^k)
    if orders is not None:
        f = _dx_chain_factor(interp.axes, idx, orders, w.dtype)
        if f is not None:
            w = w * f[:, None]
    if interp.table is not None:
        # packed route: one row gather and a weighted sum over the corners
        cell = _flat_index(idx, tuple(n - 1 for n in grid))
        rows = interp.table.index_select(0, cell)
        rows = rows.reshape(rows.shape[0], 2**k, math.prod(trailing))
        out = torch.sum(rows * w[:, :, None], dim=1)
        return out.reshape(out.shape[:1] + trailing)

    # unpacked route: the 2^k corner values gathered from the data
    strides = _strides(grid)
    base = _flat_index(idx, grid)
    offsets = torch.tensor(
        [sum(d * s for d, s in zip(c, strides)) for c in itertools.product((0, 1), repeat=k)],
        dtype=base.dtype, device=base.device,
    )
    g = data.reshape((-1,) + trailing)[base[:, None] + offsets[None, :]]
    return torch.sum(g * w.reshape(w.shape + (1,) * len(trailing)), dim=1)


# -- the compiled programs (the JAX package's jitted bodies) -------------------------------
def _runs_program(*tensors):
    """Whether a call runs its compiled program: every tensor (``None``
    skipped) on the card and none traced.  Otherwise the body runs inline:
    under an outer ``torch.compile`` or a ``torch.func`` transform, as a
    nested ``jax.jit`` is inlined, and on CPU tensors, which only the tests
    use (eager: no compile on the CPU)."""
    return all(t.is_cuda and not traced(t) for t in tensors if t is not None)


def _signature(axes, data, table, flats):
    """The rest of a program's key, what shapes its graph beside the
    statics: the device type (the backend: inductor on the card), whether
    autograd records, and for each tensor (the ``k`` axes, the data, the
    table or ``None``, the ``k`` flat queries) its dtype, its number of dims
    and whether it requires grad.  Each variant is a program of its own, so
    the recompiles Dynamo counts against its limit for one are only those of
    new sizes and strides."""

    def sig(t):
        return None if t is None else (t.dtype, t.dim(), t.requires_grad)

    return (data.device.type, torch.is_grad_enabled(), tuple(map(sig, axes)), sig(data),
            sig(table), tuple(map(sig, flats)))


def _dynamic_grid(axes, data, table):
    """Views of an interpolator's tensors with the grid's sizes marked
    dynamic (each axis, the data's leading ``k`` dims, the table's rows), so
    that one program serves every grid of its key, as it serves every query
    length.  Views, so that the interpolator's own tensors stay unmarked for
    any other program that reads them (``EvaluatorND``'s); Dynamo may still
    specialise a size (``maybe_mark_dynamic``)."""
    k = len(axes)
    axes = [ax.view(ax.shape) for ax in axes]
    data = data.view(data.shape)
    table = None if table is None else table.view(table.shape)
    for t, dims in [(ax, (0,)) for ax in axes] + [(data, range(k)), (table, (0,))]:
        for d in dims if t is not None else ():
            torch._dynamo.maybe_mark_dynamic(t, d)
    return axes, data, table


def _compile(fn, signature):
    from ..serving import compile_program  # serving imports this module

    return compile_program(fn, torch.device(signature[0]))


def _eval_flat_body(statics, orders, masked, axes, data, table, *flats):
    """The body of the eval programs: :func:`_eval_core` at the flat
    queries, each cast to its axis's dtype, for the interpolator of
    ``statics = (method, extrapolate, bcs, layout)`` on the tensors
    ``axes``, ``data`` and ``table``; ``orders`` evaluates a mixed partial;
    ``masked`` sets out-of-range results to NaN unless extrapolating
    (``__call__``)."""
    method, extrapolate, bcs, layout = statics
    itp = InterpND(axes, data, method, extrapolate, table, bcs, layout)
    flats = [f.to(ax.dtype) for f, ax in zip(flats, axes)]
    out = _eval_core(itp, flats, orders)
    if masked and not extrapolate and (out.is_floating_point() or out.is_complex()):
        ok = torch.ones(flats[0].shape, dtype=torch.bool, device=flats[0].device)
        for d, (ax, q) in enumerate(zip(axes, flats)):
            if not itp.wraps_axis(d):
                ok = ok & is_in_range(ax, q)
        out = torch.where(ok.reshape(tuple(ok.shape) + (1,) * (out.ndim - 1)), out, torch.nan)
    return out


@functools.lru_cache(maxsize=None)
def _eval_flat(statics, signature):
    """The program of ``eval_unchecked``: ``(axes, data, table, *flats) ->
    values`` (the JAX package's ``_eval_flat``), for the interpolators of
    ``statics = (method, extrapolate, bcs, layout)`` and the inputs of
    ``signature`` (:func:`_signature`)."""
    return _compile(lambda axes, data, table, *flats: _eval_flat_body(
        statics, None, False, axes, data, table, *flats), signature)


@functools.lru_cache(maxsize=None)
def _eval_flat_masked(statics, signature):
    """The program of ``__call__``, the out-of-range mask included
    (``_eval_flat_masked``)."""
    return _compile(lambda axes, data, table, *flats: _eval_flat_body(
        statics, None, True, axes, data, table, *flats), signature)


@functools.lru_cache(maxsize=None)
def _eval_flat_deriv(statics, orders, signature):
    """The program of ``derivative``, keyed on ``orders`` too
    (``_eval_flat_deriv``, ``orders`` its static argument)."""
    return _compile(lambda axes, data, table, *flats: _eval_flat_body(
        statics, orders, False, axes, data, table, *flats), signature)


PROGRAMS = (_eval_flat, _eval_flat_masked, _eval_flat_deriv)


def clear_programs():
    """Drop every compiled program: the next call on the card compiles its
    program again (a new code object, so none of Dynamo's cache entries
    for the old one serve it)."""
    for getter in PROGRAMS:
        getter.cache_clear()


class InterpND:
    """Interpolator over the leading ``k`` axes of ``data``.

    Construct via :meth:`builder` (validating) or :meth:`new_unchecked`.
    ``method``: ``"linear"`` (multilinear, ``2^k``-corner cell blend),
    ``"nearest"`` (nearest grid node, per-axis ties toward the lower node,
    extrapolation clamps) or ``"cubic"``.
    """

    def __init__(self, axes, data, method="linear", extrapolate=False, table=None, bcs=None,
                 layout=None):
        self.axes = tuple(axes)
        self.data = data
        self.method = method
        self.extrapolates = bool(extrapolate)
        self.table = table
        self.bcs = tuple(bcs) if bcs is not None else None
        self.layout = layout  # cubic: "cell" | "node" | "node2" | "node4"

    def wraps_axis(self, d: int) -> bool:
        """Queries wrap (rem_euclid) on a periodic cubic axis, which is
        never out of range (``cubic_spline.rs:804-809`` per axis)."""
        return self.bcs is not None and self.bcs[d] == "periodic"

    @property
    def k(self) -> int:
        return len(self.axes)

    # -- construction ----------------------------------------------------------
    @classmethod
    def builder(cls, data, device=None) -> "InterpNDBuilder":
        """Get the builder.  ``device`` places numpy or list inputs
        (default: the GPU; raises without one); tensors keep their own
        device."""
        return InterpNDBuilder(data, device=device)

    @classmethod
    def new_unchecked(cls, axes, data, method="linear", extrapolate=False, table=None, bcs=None,
                      layout=None) -> "InterpND":
        """No-validation constructor.  ``table`` is the packed corner or
        node table (required for ``method="cubic"``, with ``layout``): derive
        it with :meth:`build_state`, or leave ``None`` for the unpacked
        linear and the nearest routes."""
        return cls(axes, data, method, extrapolate, table, bcs, layout)

    @staticmethod
    def route_cost_ns(k, grid_shape, r, layout):
        """The per-query device time of a cubic layout's eval on the card
        (ns; NVIDIA H100 80GB HBM3, 700.00 W, f32 at 1,000,000 queries,
        ``tools/route_phases.py --sweeps`` rule 3, PERF.md PR 24): ``c0 +
        c1·r``, fitted to each layout at ``k`` = 1 to 4 axes on tables of
        about 16M·r cell elements and r = 1, 4 and 16 channels.  The cell
        layout is the cheapest at ``k >= 2``; at ``k = 1`` the node layout
        ran faster below about 15 channels (0.45 against 0.91 ns at one
        channel), but :meth:`pick_layout` keeps the cell layout there too.
        Among the node layouts the order turns with ``k`` and ``r`` (64^3,
        one channel: node 5.34 < node4 5.94 < node2 7.89).  The grid's size
        barely moved the times (256^3 against 64^3: within 6%), so
        ``grid_shape`` is not read.  Past four axes the work grows about
        fourfold an axis, and the ``k = 4`` constants are scaled so."""
        c0, c1 = _LAYOUT_NS[min(k, 4)][layout]
        return (c0 + c1 * r) * 4.0 ** max(0, k - 4)

    @staticmethod
    def pick_layout(k, grid_shape, r):
        """The cubic layout the builder takes for a grid of ``grid_shape``
        (its ``k`` leading axes) with ``r`` channels: the cell layout when
        its table fits ``config.interpnd_pack_max_elems`` (on one axis too,
        where the node layout's eval ran faster: ``DoubleFloatEvaluatorND``
        serves only the cell table, and the layouts' calculus was not
        timed), else the cheapest
        by :meth:`route_cost_ns` among the node layouts whose table fits
        (the node layout always does)."""
        # a list: Dynamo traces math.prod of a list, not of a generator
        if math.prod([n - 1 for n in grid_shape]) * (4**k) * r <= config.interpnd_pack_max_elems:
            return "cell"
        nnodes = math.prod(grid_shape)
        fits = {"node"}
        for cand, m in _NODE_PAIRS.items():
            row = (2**m) * (2**k) * r + k + m
            if 0 < m < k and nnodes * row <= config.interpnd_pack_max_elems:
                fits.add(cand)
        return min(sorted(fits), key=lambda lo: InterpND.route_cost_ns(k, grid_shape, r, lo))

    @staticmethod
    def build_state(axes, data, k, method, bcs=None, layout=None):
        """The derived packed state ``(table, layout)``.

        ``linear``: the ``2^k``-corner cell table up to
        ``config.interpnd_pack_max_elems`` elements (else ``(None, None)``, the
        unpacked route).  ``cubic``: the mixed-derivative solves
        (:func:`interpnd_node_grids`) packed per ``layout``: forced when
        given, else :meth:`pick_layout`'s: the cell layout when it fits the
        cap, else the cheapest node layout that does.
        ``nearest`` needs no state."""
        if method == "linear":
            if not data.is_floating_point():
                return None, None
            if data.numel() * (2**k) > config.interpnd_pack_max_elems:
                return None, None
            return pack_corner_rows_nd(data, k), None
        if method != "cubic":
            return None, None
        bcs_eff = bcs or ("not_a_knot",) * k
        r = data.numel() // max(1, math.prod(data.shape[:k]))
        if layout is None:
            layout = InterpND.pick_layout(k, data.shape[:k], r)
        elif layout not in ("cell",) + tuple(_NODE_PAIRS):
            raise ValueError(
                f"layout must be 'cell', 'node', 'node2', or 'node4', got {layout!r}"
            )
        elif layout != "cell" and _NODE_PAIRS[layout] >= k:
            raise ValueError(
                f"layout {layout!r} pairs {_NODE_PAIRS[layout]} axes; needs k > "
                f"{_NODE_PAIRS[layout]} (got {k})"
            )
        grids = interpnd_node_grids(axes, data, k, bcs_eff)
        if layout == "cell":
            return pack_cubic_rows_nd(axes, data, k, grids), layout
        return pack_cubic_nodes_nd(axes, data, k, grids, pairs=_NODE_PAIRS[layout]), layout

    # -- pure core -----------------------------------------------------------------
    def _flats(self, coords):
        return [c.reshape(-1).to(ax.dtype) for c, ax in zip(coords, self.axes)]

    def _eval_flats(self, flats, masked=False, orders=None, inline=False):
        """The eval program of ``masked`` and ``orders`` on the flat queries
        where :func:`_runs_program` says so and not ``inline``, else its body."""
        statics = (self.method, self.extrapolates, self.bcs, self.layout)
        args = (self.axes, self.data, self.table)
        if not inline and _runs_program(*self.axes, self.data, self.table, *flats):
            from ..serving import _dynamic_queries

            key = _signature(*args, flats)
            if orders is not None:
                program = _eval_flat_deriv(statics, orders, key)
            else:
                program = (_eval_flat_masked if masked else _eval_flat)(statics, key)
            return program(*_dynamic_grid(*args), *_dynamic_queries(flats))
        return _eval_flat_body(statics, orders, masked, *args, *flats)

    def __call__(self, *coords):
        """Evaluate at ``k`` coordinate arrays of one common shape.  Never
        synchronises; out-of-range results are NaN unless extrapolating
        (periodic axes are never out of range).  DTensor queries run on each
        rank's local shards, the body inline, and give a DTensor with their
        placements."""
        if any(is_dtensor(c) for c in coords):
            return local_call(lambda *cs: self._evaluate(cs, masked=True, inline=True), *coords)
        return self._evaluate(coords, masked=True)

    def _evaluate(self, coords, masked, inline=False):
        coords = self._as_query(coords)
        out = self._eval_flats(self._flats(coords), masked=masked, inline=inline)
        return out.reshape(tuple(coords[0].shape) + tuple(self.data.shape[self.k :]))

    def eval_unchecked(self, *coords):
        """Evaluate without the out-of-range mask (edge-cell extrapolation)."""
        return self._evaluate(coords, masked=False)

    # -- eager API -------------------------------------------------------------------
    def interp(self, *coords):
        """Value at one point, shape ``data.shape[k:]``; raises
        ``OutOfBoundsError`` per axis unless extrapolating."""
        arrs = tuple(_to_tensor(c, self.data.device) for c in coords)
        self._check_arity(arrs)
        self._check_queries([c.reshape(-1) for c in arrs])
        return self.eval_unchecked(*arrs).reshape(tuple(self.data.shape[self.k :]))

    def interp_array(self, *coords):
        """Batched eval; output dims ``M + N - k`` with the query dims
        leading; the coordinate arrays share one shape."""
        coords = self._as_query(coords)
        self._check_queries([c.reshape(-1) for c in coords])
        return self.eval_unchecked(*coords)

    def interp_array_into(self, *coords, buffer):
        """``interp_array`` into a caller-provided buffer (a tensor or a
        numpy array): shape checked first, untouched on an out-of-range
        query.  ``buffer`` is keyword-only."""
        arrs = tuple(_to_tensor(c, self.data.device) for c in coords)
        self._check_arity(arrs)
        _check_buffer(buffer, self.get_buffer_shape(arrs[0].shape))
        return _write(buffer, self.interp_array(*arrs))

    def derivative(self, *coords, orders):
        """Mixed partial ``d^(sum o) f / prod dx_d^(o_d)`` at the query
        points, the analytic derivative of the interpolant
        (``Interp2D.derivative`` for ``k`` axes).  ``orders``: one
        non-negative int per axis (keyword-only); ``"cubic"`` has orders 0-3
        on each axis (higher give zero), ``"linear"`` 0-1 (higher give exact
        zeros), ``"nearest"`` raises ``TypeError``.  Output dims
        ``M + N - k``; an out-of-range query raises unless extrapolating.
        Autograd flows through it as through evaluation."""
        if self.method == "nearest":
            raise TypeError("nearest does not support derivative()")
        orders = tuple(int(o) for o in orders)
        if len(orders) != self.k:
            raise ValueError(
                f"expected {self.k} derivative orders (one per axis), got {len(orders)}"
            )
        if any(o < 0 for o in orders):
            raise ValueError("derivative orders must be non-negative")
        coords = self._as_query(coords)
        flats = self._flats(coords)
        self._check_queries(flats)
        out = self._eval_flats(flats, orders=orders)
        return out.reshape(tuple(coords[0].shape) + tuple(self.data.shape[self.k :]))

    def integrate(self, *bounds):
        """The exact integral of the interpolant over the box
        ``prod_d [lo_d, hi_d]``, one ``(lo, hi)`` pair an axis, shape
        ``data.shape[k:]`` (``Interp1D.integrate`` for ``k`` axes; SciPy's
        ``RectBivariateSpline.integral`` at ``k = 2``): per-cell polynomial
        quadrature, no sampling (:func:`integrate_box`).  Signed per axis
        (``lo > hi`` negates); out-of-range bounds raise
        ``OutOfBoundsError`` unless extrapolating (then the edge cells
        extend).  ``"cubic"`` and ``"linear"`` only; periodic axes raise
        ``ValueError`` (a box that wraps is ambiguous).  Bounds may be
        tensors: traced ones (``torch.compile``, ``torch.func.vmap``) skip the
        swap and the range check, as the JAX package's tracers do, and a
        reversed traced box integrates to the signed value directly."""
        if self.method == "nearest":
            raise TypeError("nearest does not support integrate()")
        if len(bounds) != self.k:
            raise ValueError(
                f"expected {self.k} (lo, hi) bound pairs (one per axis), got {len(bounds)}"
            )
        if any(self.wraps_axis(d) for d in range(self.k)):
            raise ValueError("integrate() does not support periodic axes")
        sign = 1.0
        los, his = [], []
        for d, ((lo, hi), ax) in enumerate(zip(bounds, self.axes)):
            if not (traced(lo) or traced(hi)):
                flo, fhi = float(lo), float(hi)
                if flo > fhi:
                    lo, hi, flo, fhi = hi, lo, fhi, flo
                    sign = -sign
                if not self.extrapolates:
                    a0, a1 = self._range_host()[d]
                    if flo < a0 or fhi > a1:
                        raise OutOfBoundsError(
                            f"axis {d}: integration bounds [{flo}, {fhi}] are not in range"
                        )
            los.append(_to_tensor(lo, ax.device).to(ax.dtype))
            his.append(_to_tensor(hi, ax.device).to(ax.dtype))
        bcs = self.bcs or (("not_a_knot",) * self.k if self.method == "cubic" else None)
        out = integrate_box(self.axes, self.data, torch.stack(los), torch.stack(his),
                            self.method, bcs, self.extrapolates)
        return sign * out

    def get_buffer_shape(self, query_shape) -> tuple:
        return tuple(query_shape) + tuple(self.data.shape[self.k :])

    # -- internals -------------------------------------------------------------------
    def _check_arity(self, coords):
        if len(coords) != self.k:
            raise ValueError(
                f"expected {self.k} coordinate arrays (one per interpolated axis), "
                f"got {len(coords)}"
            )

    def _as_query(self, coords):
        coords = tuple(_to_tensor(c, self.data.device) for c in coords)
        self._check_arity(coords)
        if any(c.shape != coords[0].shape for c in coords[1:]):
            raise ValueError("query coordinate shapes do not match")
        return coords

    def _range_host(self):
        cached = getattr(self, "_range_cache", None)
        if cached is None:
            cached = tuple((float(ax[0]), float(ax[-1])) for ax in self.axes)
            self._range_cache = cached
        return cached

    def _check_queries(self, flats):
        """NaN on any axis raises ``ValueError`` first; then, unless
        extrapolating, the first axis with a value out of range raises
        ``OutOfBoundsError`` (one flag copied to the host per axis).
        Skipped under a ``torch.func`` transform (the JAX package's tracers)."""
        if any(traced(q) for q in flats):
            return
        for q in flats:
            if q.is_floating_point() and bool(torch.isnan(q).any()):
                raise ValueError("failed to convert NaN to an index")
        if self.extrapolates:
            return
        for d, (q, (lo, hi)) in enumerate(zip(flats, self._range_host())):
            if self.wraps_axis(d):  # periodic axes are never out of range
                continue
            ok = (lo <= q) & (q <= hi)
            if not bool(ok.all()):
                bad = q[~ok][0].detach().cpu().numpy()[()]
                raise OutOfBoundsError(f"axis {d}: {bad} is not in range")

    def __repr__(self):
        extra = ", packed" if self.table is not None else ""
        if self.layout is not None:
            extra = f", layout={self.layout!r}"
        if self.bcs is not None:
            extra += f", bcs={self.bcs!r}"
        return (
            f"InterpND(k={self.k}, data={tuple(self.data.shape)}, method={self.method!r}, "
            f"extrapolate={self.extrapolates}{extra})"
        )


class InterpNDBuilder:
    """Create and configure an :class:`InterpND`.

    Defaults: axes are the indices of every data dim (``k = data.ndim``,
    ``RegularGridInterpolator``'s convention), method ``"linear"``, no
    extrapolation.  :meth:`points` sets the axes; their count fixes ``k``
    and the trailing data dims are batched.
    """

    def __init__(self, data, device=None):
        self._device = default_device(data, device)
        self._data = _to_tensor(data, self._device, copy=True)
        self._points = None
        self._method = "linear"
        self._extrapolate = False
        self._bcs = None
        self._layout = None

    def points(self, *axes) -> "InterpNDBuilder":
        self._points = tuple(_to_tensor(ax, self._device, copy=True) for ax in axes)
        return self

    def method(self, method: str) -> "InterpNDBuilder":
        if method not in _METHODS:
            raise ValueError(
                f"unknown InterpND method {method!r}; choose from {sorted(_METHODS)}"
            )
        self._method = method
        return self

    def boundary(self, *bcs) -> "InterpNDBuilder":
        """Per-axis boundary conditions for ``method("cubic")``:
        ``not_a_knot`` (default), ``natural``, ``clamped`` or ``periodic``
        per axis; a single name applies to every axis."""
        for bc in bcs:
            if bc not in _BCS:
                raise ValueError(f"unknown boundary {bc!r}; choose from {sorted(_BCS)}")
        self._bcs = tuple(bcs)
        return self

    def extrapolate(self, yes: bool = True) -> "InterpNDBuilder":
        self._extrapolate = bool(yes)
        return self

    def layout(self, layout: str) -> "InterpNDBuilder":
        """Force the cubic table layout: ``"cell"`` (one ``4^k·r``-channel
        row gather a query, ``~4^k``× the data's memory), ``"node"`` (``2^k``
        node-row gathers, ``~2^k``×) or the paired ``"node2"`` / ``"node4"``
        (``2^(k-1)`` / ``2^(k-2)`` gathers at 2× / 4× the node table; need
        ``k > 1`` / ``k > 2``).  Default: :meth:`InterpND.build_state`'s
        choice."""
        if layout not in ("cell", "node", "node2", "node4"):
            raise ValueError(
                f"layout must be 'cell', 'node', 'node2', or 'node4', got {layout!r}"
            )
        self._layout = layout
        return self

    def build(self) -> InterpND:
        """Validate and build; the checks follow the 2-D builder per axis
        (``mod.rs:468-518``): enough data, axis and data lengths match,
        strictly rising axes."""
        data = self._data
        axes = self._points
        if axes is None:
            axes = tuple(torch.arange(n, device=data.device).to(data.dtype) for n in data.shape)
        k = len(axes)
        if k == 0:
            raise ShapeError("at least one axis is required")
        if data.ndim < k:
            raise ShapeError(f"data dimension needs to be at least {k}")
        bcs = self._bcs
        if bcs is not None:
            if self._method != "cubic":
                raise ValueError("boundary() applies to method('cubic') only")
            if len(bcs) == 1:
                bcs = bcs * k
            if len(bcs) != k:
                raise ShapeError(
                    f"expected {k} boundary conditions (one per axis), got {len(bcs)}"
                )
        elif self._method == "cubic":
            bcs = ("not_a_knot",) * k
        min_pts = 3 if self._method == "cubic" else 2
        for d, ax in enumerate(axes):
            if ax.ndim != 1:
                raise ShapeError(f"axis {d} must be one-dimensional")
            if data.shape[d] < min_pts:
                raise NotEnoughDataError(
                    f"The {d}-dimension has not enough data for the chosen interpolation "
                    f"strategy. Provided: {data.shape[d]}, Required: {min_pts}"
                )
            if ax.shape[0] != data.shape[d]:
                raise ShapeError(
                    f"Lengths of axis {d} and data-{d}-axis need to match. Got axis: "
                    f"{ax.shape[0]}, data-{d}: {data.shape[d]}"
                )
            if not monotonic_prop(ax).is_strict_rising:
                raise MonotonicError(f"axis {d} needs to be strictly monotonic rising")
            if ax.device != data.device:
                raise ValueError(
                    f"axis {d} and data must be on one device; got axis {d} on {ax.device}, "
                    f"data on {data.device}"
                )
        if bcs is not None:
            # periodic axes need equal first and last data rows along them
            # (cubic_spline.rs:483-489 per axis)
            for d, bc in enumerate(bcs):
                if bc == "periodic" and not torch.equal(data.select(d, 0), data.select(d, -1)):
                    raise ValueError(
                        f"periodic axis {d} requires the first and last data rows along it "
                        "to be equal"
                    )
        ct = data.dtype
        for ax in axes:
            ct = torch.promote_types(ct, ax.dtype)
        if not (ct.is_floating_point or ct.is_complex):
            ct = torch.promote_types(ct, torch.float32)
        axes_ct = tuple(ax.to(ct) for ax in axes)
        data_ct = data.to(ct)
        table, layout = InterpND.build_state(axes_ct, data_ct, k, self._method, bcs,
                                             layout=self._layout)
        return InterpND(axes_ct, data_ct, self._method, self._extrapolate, table, bcs, layout)
