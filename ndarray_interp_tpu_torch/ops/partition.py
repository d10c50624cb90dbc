"""Placement rules that run the kernels on DTensor shards.

Counterpart of ``ndarray_interp_tpu.ops.partition``.  There a
``custom_partitioning`` rule tells GSPMD how each Pallas kernel runs on a
sharded array; here each entry of the kernel wrappers has a rule over
``torch.distributed.tensor`` (DTensor), the zero-communication one the
math permits:

* the query operands may take any placement on the flat query axis
  (``Shard(0)`` or ``Replicate()`` on each mesh dimension); each rank runs
  the unmodified kernel on its ``to_local()`` shard, and every output takes
  the queries' placements (``DTensor.from_local(..., run_check=False)``);
* knots and tables replicate: a plain tensor counts as replicated, a DTensor
  sharded there is redistributed to ``Replicate()``, as GSPMD gathers it;
* the bank rule (``n b, m b, m b, q, q -> q b``: K5 and the packed route)
  also keeps tables sharded on their bank axis (``Shard(1)``), and its
  output is then sharded on both the query and the bank dimension.

A conforming input (queries sharded or replicated, tables replicated or, for
the bank rule, sharded on the bank axis on another mesh dimension than the
queries) issues no collective.  The batching half of the JAX module, its
``custom_vmap`` rules, is the batching rule of each kernel's op
(``_cuda.kernel_op``: ``_cuda.vmap_queries``, ``thomas_kernel._vmap``).

Each ``sharded_*`` factory returns the entry with its rule; plain tensors
pass straight through to the entry.  :func:`local_call` is the rule of the
interpolators' ``__call__`` on a DTensor query.
"""

from __future__ import annotations

import math
import sys

import torch

from .bank_eval import banked_eval
from .bank_tail import gathered_bank_eval
from .eval_kernels import fused_eval_1d, fused_index_frac, fused_lower_index
from .eval_kernels_df import (
    fused_eval_1d_df,
    gathered_bank_eval_df_packed,
    gathered_bank_eval_f48_packed,
)
from .eval_kernels_df2d import (
    gathered_bicubic_eval_df_packed,
    gathered_bicubic_eval_f48_packed,
    gathered_bicubic_nodes_eval_df,
    gathered_bilinear_eval_df_packed,
    gathered_bilinear_eval_f48_packed,
)
from .eval_kernels_df_nd import gathered_nd_eval_df_packed


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor.  ``torch.distributed.tensor`` is not
    imported here (it takes a second): a DTensor exists only once its module
    is, and never in a build without ``torch.distributed``."""
    if not torch.distributed.is_available():
        return False
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


def _query_layout(queries):
    """The mesh and placements of the first DTensor among the query
    operands, a ``Partial`` taken as ``Replicate()``; ``(None, None)`` when
    there is none."""
    from torch.distributed.tensor import Replicate

    for q in queries:
        if is_dtensor(q):
            return q.device_mesh, [Replicate() if p.is_partial() else p for p in q.placements]
    return None, None


def _local(q, mesh, placements):
    """An operand's local shard at ``placements``: a DTensor redistributed
    there unless it is already (a table sharded on its knot axis is gathered,
    as GSPMD gathers it), a plain tensor (replicated) cut locally, which
    needs no communication."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(q):
        q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if q.device_mesh != mesh:
        raise ValueError("the operands of one call must share a device mesh")
    if list(q.placements) != list(placements):
        q = q.redistribute(mesh, placements)
    return q.to_local()


def _wrap(out, mesh, placements, lead):
    """A local output as a DTensor: its leading dims are the queries' global
    ``lead`` shape, its trailing dims whole on every rank."""
    from torch.distributed.tensor import DTensor

    shape = tuple(lead) + tuple(out.shape[len(lead):])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _outputs(outs, fn):
    return tuple(fn(o) for o in outs) if isinstance(outs, tuple) else fn(outs)


def query_rule(entry, n_tables):
    """``entry`` under the query rule: its first ``n_tables`` operands
    replicate, the rest are queries of one shape, and its outputs lead with
    the queries' dims and take their placements."""

    def call(*args):
        tables, queries = args[:n_tables], args[n_tables:]
        mesh, placements = _query_layout(queries)
        if mesh is None:
            mesh = next((t.device_mesh for t in tables if is_dtensor(t)), None)
            if mesh is None:
                return entry(*args)
        from torch.distributed.tensor import Replicate

        replicate = [Replicate()] * mesh.ndim
        placements = placements or replicate
        lead = next(q.shape for q in queries if isinstance(q, torch.Tensor))
        local = [_local(t, mesh, replicate) for t in tables]
        local += [_local(q, mesh, placements) for q in queries]
        return _outputs(entry(*local), lambda o: _wrap(o, mesh, placements, lead))

    return call


def bank_rule(entry):
    """``entry(d2, a2, b2, idx, t)`` under the bank rule ``n b, m b, m b, q, q
    -> q b``: ``idx`` and ``t`` as queries; the tables replicate except on
    the mesh dimensions where ``d2`` is ``Shard(1)`` and the queries are not
    sharded, where they stay cut on the bank axis, and so does the output."""

    def call(d2, a2, b2, idx, t):
        mesh, q_pl = _query_layout((idx, t))
        tmesh = d2.device_mesh if is_dtensor(d2) else None
        if mesh is None and tmesh is None:
            return entry(d2, a2, b2, idx, t)
        from torch.distributed.tensor import Replicate, Shard

        mesh = mesh or tmesh
        q_pl = q_pl or [Replicate()] * mesh.ndim
        bank = [p == Shard(1) and q != Shard(0)
                for p, q in zip(d2.placements if tmesh else [Replicate()] * mesh.ndim, q_pl)]
        tbl_pl = [Shard(1) if b else Replicate() for b in bank]
        out_pl = [Shard(1) if b else q for b, q in zip(bank, q_pl)]

        local = [_local(v, mesh, tbl_pl) for v in (d2, a2, b2)]
        local += [_local(q, mesh, q_pl) for q in (idx, t)]
        return _wrap(entry(*local), mesh, out_pl, (idx.shape[0], d2.shape[1]))

    return call


def local_call(fn, *queries):
    """The interpolators' ``__call__`` on DTensor queries: ``fn`` (the call
    on plain tensors, the interpolator's own tables replicated) on each
    rank's local shard, the result a DTensor with the queries' placements.
    Its leading dims are the queries', so a shard of the queries is a shard
    of the result, and nothing is exchanged."""
    return query_rule(fn, 0)(*queries)


# -- the entries, by the JAX module's names --------------------------------------------
def sharded_fused_eval():
    """K1 (``fused_eval_1d(knots, tbl, q)``): ``q -> q``."""
    return query_rule(fused_eval_1d, 2)


def sharded_index_frac():
    """K2 (``fused_index_frac(knots, q)``): ``q -> q, q``."""
    return query_rule(fused_index_frac, 1)


def sharded_lower_index():
    """K3 (``fused_lower_index(knots, q)``): ``q -> q``."""
    return query_rule(fused_lower_index, 1)


def sharded_banked_eval():
    """K5 (``banked_eval(d2, a2, b2, idx, t)`` on 2-D tables): the bank rule."""
    return bank_rule(banked_eval)


def sharded_gathered_eval():
    """The packed route (``gathered_bank_eval``: the pack and R2a): the
    bank rule."""
    return bank_rule(gathered_bank_eval)


def sharded_df_eval():
    """K6 (``fused_eval_1d_df``: eight knot and table halves, then the
    query pair): ``q, q -> q, q``."""
    return query_rule(fused_eval_1d_df, 8)


_DF_BANK = {"df": gathered_bank_eval_df_packed, "f48": gathered_bank_eval_f48_packed}
_DF_BILINEAR = {"df": gathered_bilinear_eval_df_packed, "f48": gathered_bilinear_eval_f48_packed}
_DF_BICUBIC = {"df": gathered_bicubic_eval_df_packed, "f48": gathered_bicubic_eval_f48_packed}


def sharded_df_banked_packed(bank, tier="df"):
    """K7 + K8 (``tier="f48"``: K9) from a prepacked table:
    ``(x_hi, x_lo, packed, q_hi, q_lo) -> (q b, q b)``."""
    route = _DF_BANK[tier]
    return query_rule(lambda xh, xl, packed, qh, ql: route(xh, xl, packed, bank, qh, ql), 3)


def sharded_df_bilinear_packed(ny, r, tier="df"):
    """K7 twice + K10 (``tier="f48"``: K11): ``(x_hi, x_lo, y_hi, y_lo,
    packed, qx_hi, qx_lo, qy_hi, qy_lo) -> (q b, q b)``."""
    route = _DF_BILINEAR[tier]
    return query_rule(
        lambda xh, xl, yh, yl, packed, *qs: route(xh, xl, yh, yl, packed, ny, r, *qs), 5)


def sharded_df_bicubic_packed(r, tier="df"):
    """K7 twice + K12 (``tier="f48"``: K13), operands as the bilinear
    route's."""
    route = _DF_BICUBIC[tier]
    return query_rule(lambda *ops: route(*ops, r=r), 5)


def sharded_df_bicubic_nodes(r):
    """K7 twice + K14 on the node table, operands as the bilinear route's."""
    return query_rule(lambda *ops: gathered_bicubic_nodes_eval_df(*ops, r=r), 5)


def sharded_df_nd_packed(k, grid_shape, r, nbasis=4, tier="df"):
    """K7 on each of ``k`` axes + K15 (``tier="f48"``: K15f48): the ``2k``
    knot halves and the table replicate, the ``2k`` query halves are
    queries."""
    return query_rule(gathered_nd_eval_df_packed(k, grid_shape, r, nbasis=nbasis, tier=tier),
                      2 * k + 1)
