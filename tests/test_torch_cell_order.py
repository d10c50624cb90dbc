"""The ordering of a batch by cell ahead of K12 and K14
(``ops/cell_order.py``) and the plain tails on ordered records, on the CPU.

The ordering has no JAX twin: the JAX routes evaluate in query order.  So
the plain ordering is checked for what the ordered tails rely on (a
permutation of the queries, non-decreasing bucket keys, each 32-byte record
its query's row value and fraction halves), and the plain tails on the
ordered records, put back at their queries' slots, are held bit for bit
against the direct plain tails and, with the same numpy inputs, against the
JAX package's XLA tails (4e-12 scale-relative, as ``test_torch_df2d.py``).
The kernels themselves run in ``test_torch_kernels.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.ops import df as jdf
from ndarray_interp_tpu.ops import pallas_eval_df as jp
from ndarray_interp_tpu_torch.ops import cell_order as co
from ndarray_interp_tpu_torch.ops import df as tdf
from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as tp
from ndarray_interp_tpu_torch.ops import kernel_wrappers


def jpair(v):
    return [jnp.asarray(w) for w in jdf.df_from_f64(np.asarray(v, np.float64))]


def tpair(v):
    return list(tdf.df_from_f64(torch.as_tensor(np.asarray(v, np.float64))))


def bits(v):
    return v.numpy().view(np.int32)


def scaled_err(got, want):
    want = np.asarray(want)
    scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
    return float(np.max(np.abs(got - want) / scale))


def fractions(rng, nq):
    """Fractions in [-0.5, 1.5] with NaN, +-inf and huge ones among them."""
    t = rng.uniform(-0.5, 1.5, (2, nq))
    special = [np.nan, np.inf, -np.inf, 1e30, 0.0, 1.0]
    k = min(nq, len(special))
    t[0, :k], t[1, nq - k:] = special[:k], special[:k]
    return t


def indices(case, nx, ny, nq, rng):
    """K7-like interval indices for a ``case`` of the ordering tests."""
    if case == "random":
        return rng.integers(0, nx - 1, nq), rng.integers(0, ny - 1, nq)
    if case == "one cell":
        return np.full(nq, nx // 2), np.full(nq, ny // 3)
    if case == "sorted":
        xi, yi = rng.integers(0, nx - 1, nq), rng.integers(0, ny - 1, nq)
        order = np.lexsort((yi, xi))
        return xi[order], yi[order]
    # out of range: cells and nodes past both ends, which the tails clamp
    return rng.integers(-3 * nx, 3 * nx, nq), rng.integers(-3 * ny, 3 * ny, nq)


def ints(v):
    return torch.as_tensor(np.asarray(v), dtype=torch.int32)


KINDS = {"K12": lambda ny: (ny - 1, 0), "K14": lambda ny: (ny, -(ny + 1))}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", ["random", "one cell", "sorted", "out of range", "empty"])
def test_plain_order_is_a_permutation_in_bucket_order(kind, case):
    rng = np.random.default_rng(len(case))
    nx, ny = 13, 9
    nq = 0 if case == "empty" else 3000
    row_step, lo = KINDS[kind](ny)
    rows = (nx - 1) * (ny - 1) if kind == "K12" else nx * ny
    xi, yi = (ints(v) for v in indices(case, nx, ny, nq, rng))
    t = fractions(rng, nq)
    (txh, txl), (tyh, tyl) = tpair(t[0]), tpair(t[1])
    records = co.order_by_cell(xi, yi, row_step, lo, rows, txh, txl, tyh, tyl)
    assert records.dtype == torch.int32 and tuple(records.shape) == (nq, 8)
    v, qid, frac = co.record_fields(records)
    assert frac.dtype == torch.float32 and tuple(frac.shape) == (nq, 4)
    assert not bool(records[:, 6:].any())
    qid = qid.long()
    assert torch.equal(torch.sort(qid).values, torch.arange(nq))
    values = co.row_values(xi, yi, row_step, lo, rows)
    assert torch.equal(v.long(), values[qid])
    assert bool((values <= rows - 1).all()) and bool((values >= lo).all())
    keys = co.bucket_keys(v.long(), rows)
    assert bool((keys[1:] >= keys[:-1]).all())
    want = torch.stack([txh, txl, tyh, tyl], dim=1)[qid]
    np.testing.assert_array_equal(bits(frac), bits(want))
    # the plain version is stable: within a bucket the queries keep their order
    same = keys[1:] == keys[:-1]
    assert bool((qid[1:][same] > qid[:-1][same]).all())
    if case == "one cell":
        assert torch.equal(qid, torch.arange(nq))


@pytest.mark.parametrize("rows,shift", [(1, 0), (4096, 0), (2**22, 0), (2**22 + 1, 1),
                                        (2**24, 2), (3 * 2**24 + 7, 4)])
def test_buckets_stay_at_most_2_to_the_22(rows, shift):
    assert co.bucket_shift(rows) == shift
    assert ((rows - 1) >> shift) < 2**co.MAX_BUCKET_BITS
    keys = co.bucket_keys(torch.tensor([-5, 0, rows - 1]), rows)
    assert keys.tolist() == [0, 0, (rows - 1) >> shift]


def test_plain_order_on_a_shifted_table_sorts_buckets_not_rows():
    rows = 2**22 + 3  # shift 1: cells 2k and 2k + 1 share a bucket
    v = torch.tensor([7, 6, 2, 3, 9, 8, 0], dtype=torch.int32)
    zero = torch.zeros(v.shape[0], dtype=torch.int32)
    t = torch.arange(v.shape[0], dtype=torch.float32)
    got_v, qid, frac = co.record_fields(co.order_by_cell(zero, v, 1, 0, rows, t, t, t, t))
    assert got_v.tolist() == [0, 2, 3, 7, 6, 9, 8]
    assert qid.tolist() == frac[:, 0].long().tolist() == [6, 2, 3, 0, 1, 4, 5]


# -- the plain tails on ordered records ----------------------------------------------
def cell_case(r, case, seed, nq=700, nx=11, ny=9):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=((nx - 1) * (ny - 1), 16 * r))
    packed = tp.pack_bicubic_rows_df(*tpair(rows), r)
    xi, yi = indices(case, nx, ny, nq, rng)
    t = fractions(rng, nq)
    return rows, packed, xi, yi, t, ny


def node_case(r, case, seed, nq=700, nx=11, ny=9):
    rng = np.random.default_rng(seed)
    nodes = rng.normal(size=(nx * ny, 4 * r + 2))
    nodes[:, 4 * r] = np.repeat(np.cumsum(rng.uniform(0.2, 1.0, nx)), ny)
    nodes[:, 4 * r + 1] = np.tile(np.cumsum(rng.uniform(0.2, 1.0, ny)), nx)
    packed = tp.pack_bicubic_nodes_df(*tpair(nodes))
    xi, yi = indices(case, nx - 1, ny - 1, nq, rng)
    t = fractions(rng, nq)
    return nodes, packed, xi, yi, t, ny


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("r", [1, 3, 4, 16])
@pytest.mark.parametrize("case", ["random", "one cell", "out of range"])
def test_ordered_plain_tails_equal_the_direct_plain_tails(kind, r, case):
    make = cell_case if kind == "K12" else node_case
    _, packed, xi, yi, t, ny = make(r, case, seed=r + len(case))
    args = (packed, ints(xi), ints(yi), ny, *tpair(t[0]), *tpair(t[1]))
    row_step, lo = KINDS[kind](ny)
    records = co.order_by_cell(args[1], args[2], row_step, lo, packed.shape[0], *args[4:])
    if kind == "K12":
        got = tp._bicubic_df_tail_ordered_plain(packed, records)
        want = tp._bicubic_df_tail_plain(*args)
    else:
        got = tp._bicubic_node_df_tail_ordered_plain(packed, ny, records)
        want = tp._bicubic_node_df_tail_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("r", [1, 16])
def test_ordered_plain_tails_match_the_jax_tails(kind, r):
    """The plain tails on ordered records against the JAX XLA tails
    ``_df_bicubic_tail`` / ``_df_node_tail`` on the same rows in query
    order, 4e-12 scale-relative."""
    make = cell_case if kind == "K12" else node_case
    src, packed, xi, yi, t, ny = make(r, "random", seed=40 + r, nq=512)
    t = np.random.default_rng(r).uniform(-0.5, 1.5, (2, 512))
    tt = tpair(t[0]) + tpair(t[1])
    row_step, lo = KINDS[kind](ny)
    records = co.order_by_cell(ints(xi), ints(yi), row_step, lo, packed.shape[0], *tt)
    jt = [v[:, None] for v in jpair(t[0]) + jpair(t[1])]
    if kind == "K12":
        jpk = jp.pack_bicubic_rows_df(*jpair(src), r)
        rows = jnp.take(jpk, jnp.asarray(xi * (ny - 1) + yi), axis=0)
        bp = jpk.shape[1] // 32
        want = jp._df_bicubic_tail(rows, *jt, bp)
        want = (want[0][:, :r], want[1][:, :r])
        hi, lo_ = tp._bicubic_df_tail_ordered_plain(packed, records)
        hi, lo_ = hi[:, :r], lo_[:, :r]
    else:
        jpk = jp.pack_bicubic_nodes_df(*jpair(src))
        base = xi.astype(np.int64) * ny + yi
        g = [jnp.take(jpk, jnp.asarray(base + off), axis=0) for off in (0, 1, ny, ny + 1)]
        want = jax.jit(lambda *a: jp._df_node_tail(*a, r))(*g, *jt)
        hi, lo_ = tp._bicubic_node_df_tail_ordered_plain(packed, ny, records)
    got = tdf.df_to_f64(hi, lo_).numpy()
    assert scaled_err(got, jdf.df_to_f64(*want)) <= 4e-12


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cpu_wrappers_run_the_plain_tail_at_any_batch(kind, monkeypatch):
    """On CPU tensors the wrappers take the plain version whatever the
    batch size: no ordering and no launch."""
    monkeypatch.setattr(tp, "_orders", lambda nq, fetched: True)
    make = cell_case if kind == "K12" else node_case
    _, packed, xi, yi, t, ny = make(3, "random", seed=5)
    args = (packed, ints(xi), ints(yi), ny, *tpair(t[0]), *tpair(t[1]))
    wrapper, plain = {
        "K12": (tp.gathered_bicubic_df_tail, tp._bicubic_df_tail_plain),
        "K14": (tp.gathered_bicubic_node_df_tail, tp._bicubic_node_df_tail_plain),
    }[kind]
    before = {k: w.launches for k, w in kernel_wrappers().items()}
    for a, b in zip(wrapper(*args), plain(*args)):
        np.testing.assert_array_equal(bits(a), bits(b))
    assert {k: w.launches for k, w in kernel_wrappers().items()} == before
