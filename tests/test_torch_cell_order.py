"""The ordering of a batch by cell ahead of K12, K13, K14 and R4c, and by
interval ahead of K8 (``ops/cell_order.py``), and the plain tails on ordered
records, on the CPU.

The ordering has no JAX twin: the JAX routes evaluate in query order.  So
the plain ordering is checked for what the ordered tails rely on (a
permutation of the queries, non-decreasing bucket keys, each 32-byte record
its query's row value and fraction halves; K8's 1-D records have no y
part), and the plain tails on the ordered records, put back at their
queries' slots, are held bit for bit against the direct plain tails and,
with the same numpy inputs, against the JAX package's XLA tails (4e-12
scale-relative, as ``test_torch_df2d.py``; K13's also against its Pallas
tail in interpret mode within 1e-5, which degrades the error-free
transforms; R4c's against the weight-form record tail
``df_records._df_bicubic_weight_tail`` within 4e-12 of the largest value, as
``test_torch_records.py``).  The kernels themselves run in ``test_torch_kernels.py`` on
the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.ops import df as jdf
from ndarray_interp_tpu.ops import df_records as jrec
from ndarray_interp_tpu.ops import pallas_eval_df as jp
from ndarray_interp_tpu_torch.ops import cell_order as co
from ndarray_interp_tpu_torch.ops import df as tdf
from ndarray_interp_tpu_torch.ops import eval_kernels_df as t1
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


# (row_step, lo) of each kind's ordering; K8's is 1-D (no yi, no y halves:
# the key is the interval, row_step 1, lo 0)
KINDS = {"K8": None, "K12": lambda ny: (ny - 1, 0), "K13": lambda ny: (ny - 1, 0),
         "K14": lambda ny: (ny, -(ny + 1)), "R4c": lambda ny: (ny - 1, 0)}


def order_args(kind, xi, yi, nx, ny, t):
    """The ordering's arguments for ``kind`` on an ``nx`` x ``ny`` grid (K8:
    the ``nx - 1`` intervals of the x axis)."""
    (txh, txl), (tyh, tyl) = tpair(t[0]), tpair(t[1])
    if kind == "K8":
        return (ints(xi), None, 1, 0, nx - 1, txh, txl, None, None)
    row_step, lo = KINDS[kind](ny)
    rows = nx * ny if kind == "K14" else (nx - 1) * (ny - 1)
    return (ints(xi), ints(yi), row_step, lo, rows, txh, txl, tyh, tyl)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", ["random", "one cell", "sorted", "out of range", "empty"])
def test_plain_order_is_a_permutation_in_bucket_order(kind, case):
    rng = np.random.default_rng(len(case))
    nx, ny = 13, 9
    nq = 0 if case == "empty" else 3000
    xi, yi = indices(case, nx, ny, nq, rng)
    args = order_args(kind, xi, yi, nx, ny, fractions(rng, nq))
    xi, yi, row_step, lo, rows, txh, txl, tyh, tyl = args
    records = co.order_by_cell(*args)
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
    if kind == "K8":  # the 1-D records: the y halves are zero bits
        tyh = tyl = torch.zeros_like(txh)
        assert torch.equal(records, co.order_by_interval(xi, rows, txh, txl))
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


def test_the_shared_form_takes_tables_up_to_its_bucket_limit():
    """The kernel's form follows the bucket count alone: the shared form up
    to ``SHARED_MAX_BUCKETS`` (K8's 10,239 intervals), the global form past
    it (NS3d's 261,121 cells, NS3e's 1,048,576 nodes, 2^22 buckets of two
    rows past 2^22 rows)."""
    limit = co.SHARED_MAX_BUCKETS
    assert [co.bucket_count(rows) for rows in (1, 10_239, limit, 2**22, 2**22 + 1)] == [
        1, 10_239, limit, 2**22, 2**21 + 1]
    assert co._form(co.bucket_count(10_239)) == co._form(limit) == co.SHARED
    for rows in (limit + 1, 261_121, 1_048_576, 2**22 + 1):
        assert co._form(co.bucket_count(rows)) == co.GLOBAL


def test_plain_order_on_a_shifted_table_sorts_buckets_not_rows():
    rows = 2**22 + 3  # shift 1: cells 2k and 2k + 1 share a bucket
    v = torch.tensor([7, 6, 2, 3, 9, 8, 0], dtype=torch.int32)
    zero = torch.zeros(v.shape[0], dtype=torch.int32)
    t = torch.arange(v.shape[0], dtype=torch.float32)
    got_v, qid, frac = co.record_fields(co.order_by_cell(zero, v, 1, 0, rows, t, t, t, t))
    assert got_v.tolist() == [0, 2, 3, 7, 6, 9, 8]
    assert qid.tolist() == frac[:, 0].long().tolist() == [6, 2, 3, 0, 1, 4, 5]


# -- the plain tails on ordered records ----------------------------------------------
def cell_case(r, case, seed, nq=700, nx=11, ny=9, grade="df"):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=((nx - 1) * (ny - 1), 16 * r))
    packed = getattr(tp, f"pack_bicubic_rows_{grade}")(*tpair(rows), r)
    xi, yi = indices(case, nx, ny, nq, rng)
    t = fractions(rng, nq)
    return rows, packed, xi, yi, t, ny


def bank_case(bank, case, seed, nq=700, n=11):
    """A K8 table of ``n`` knots x ``bank``, its even intervals linear (a =
    b = 0, where +-inf fractions take the linear escape), K7-like intervals
    (``yi`` unused) and fractions; returns the float64 (d, a, b)."""
    rng = np.random.default_rng(seed)
    d, a, b = rng.normal(size=(n, bank)), rng.normal(size=(n - 1, bank)), rng.normal(
        size=(n - 1, bank))
    a[::2] = b[::2] = 0.0
    packed = t1.pack_bank_rows_df(*(h for v in (d, a, b) for h in tpair(v)))
    xi, yi = indices(case, n, 2, nq, rng)
    t = fractions(rng, nq)
    return (d, a, b), packed, xi, yi, t, 2



def node_case(r, case, seed, nq=700, nx=11, ny=9):
    rng = np.random.default_rng(seed)
    nodes = rng.normal(size=(nx * ny, 4 * r + 2))
    nodes[:, 4 * r] = np.repeat(np.cumsum(rng.uniform(0.2, 1.0, nx)), ny)
    nodes[:, 4 * r + 1] = np.tile(np.cumsum(rng.uniform(0.2, 1.0, ny)), nx)
    packed = tp.pack_bicubic_nodes_df(*tpair(nodes))
    xi, yi = indices(case, nx - 1, ny - 1, nq, rng)
    t = fractions(rng, nq)
    return nodes, packed, xi, yi, t, ny


def make_case(kind, r, case, seed, **kw):
    """The table and inputs of ``kind``'s tail at ``r`` channels (K8: a bank
    of ``r`` columns)."""
    if kind == "K8":
        return bank_case(r, case, seed, **kw)
    if kind == "K14":
        return node_case(r, case, seed, **kw)
    return cell_case(r, case, seed, grade="f48" if kind == "K13" else "df", **kw)


NX = 11  # the x knots of every case's grid (K8: of its axis)


def ordered_and_direct(kind, packed, xi, yi, ny, t, r):
    """The plain tail of ``kind`` on the records of the plain ordering, and
    the direct plain tail on the same inputs."""
    args = order_args(kind, xi, yi, NX, ny, t)
    records = co.order_by_cell(*args)
    if kind == "K8":
        return (t1._df_tail_ordered_plain(packed, records, r),
                t1._df_tail_plain(packed, args[0], args[5], args[6], r))
    direct = (packed, args[0], args[1], ny, *args[5:])
    if kind == "K14":
        return (tp._bicubic_node_df_tail_ordered_plain(packed, ny, records),
                tp._bicubic_node_df_tail_plain(*direct))
    if kind == "K12":
        return tp._bicubic_df_tail_ordered_plain(packed, records), tp._bicubic_df_tail_plain(
            *direct)
    if kind == "R4c":
        return (tp._bicubic_df_weight_tail_ordered_plain(packed, records),
                tp._bicubic_df_weight_tail_plain(*direct))
    return tp._bicubic_f48_tail_ordered_plain(packed, records), tp._bicubic_f48_tail_plain(
        *direct)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("r", [1, 3, 4, 8, 16, 64])
@pytest.mark.parametrize("case", ["random", "one cell", "out of range"])
def test_ordered_plain_tails_equal_the_direct_plain_tails(kind, r, case):
    """Bit for bit, at channel counts (K8: bank widths) of 1 to 64, on
    random cells or intervals, all queries in one, and indices far outside
    the table (clamped alike)."""
    _, packed, xi, yi, t, ny = make_case(kind, r, case, seed=r + len(case))
    got, want = ordered_and_direct(kind, packed, xi, yi, ny, t, r)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("r", [1, 3, 16])
def test_ordered_plain_tails_match_the_jax_tails(kind, r):
    """The plain tails on ordered records against the JAX XLA tails
    ``_df_xla_tail`` (K8), ``_df_bicubic_tail`` (K12; K13 on the unpacked
    f48 rows) and ``_df_node_tail`` (K14) on the same rows in query order,
    4e-12 scale-relative; K13 also against its Pallas tail in interpret
    mode, 1e-5; R4c against the record tail ``_df_bicubic_weight_tail``,
    4e-12 of the largest value."""
    src, packed, xi, yi, t, ny = make_case(kind, r, "random", seed=40 + r, nq=512)
    t = np.random.default_rng(r).uniform(-0.5, 1.5, (2, 512))
    records = co.order_by_cell(*order_args(kind, xi, yi, NX, ny, t))
    jt = [v[:, None] for v in jpair(t[0]) + jpair(t[1])]
    if kind == "K8":
        jpk = jp.pack_bank_rows_df(*(h for v in src for h in jpair(v)))
        rows = jnp.take(jpk, jnp.asarray(xi), axis=0)
        want = jp._df_xla_tail(rows, *jpair(t[0]), r)
        hi, lo_ = t1._df_tail_ordered_plain(packed, records, r)
    elif kind == "R4c":
        jpk = jp.pack_bicubic_rows_df(*jpair(src), r)
        rows = jnp.take(jpk, jnp.asarray(xi * (ny - 1) + yi), axis=0)
        bp = jpk.shape[1] // 32
        want = jax.jit(lambda rw, *a: jrec._df_bicubic_weight_tail(rw, *a, bp))(rows, *jt)
        hi, lo_ = tp._bicubic_df_weight_tail_ordered_plain(packed, records)
        got = tdf.df_to_f64(hi[:, :r], lo_[:, :r]).numpy()
        want = np.asarray(jdf.df_to_f64(*want))[:, :r]
        assert np.abs(got - want).max() / np.abs(want).max() < 4e-12
        return
    elif kind in ("K12", "K13"):
        grade = "df" if kind == "K12" else "f48"
        jpk = getattr(jp, f"pack_bicubic_rows_{grade}")(*jpair(src), r)
        rows = jnp.take(jpk, jnp.asarray(xi * (ny - 1) + yi), axis=0)
        bp = jpk.shape[1] // (32 if grade == "df" else 24)
        full = rows if grade == "df" else jnp.concatenate(
            [rows[:, : 16 * bp], jp._unpack_f48_lo(rows[:, 16 * bp:])], axis=1)
        want = jp._df_bicubic_tail(full, *jt, bp)
        want = (want[0][:, :r], want[1][:, :r])
        plain = tp._bicubic_df_tail_ordered_plain if grade == "df" else (
            tp._bicubic_f48_tail_ordered_plain)
        hi, lo_ = plain(packed, records)
        hi, lo_ = hi[:, :r], lo_[:, :r]
        if grade == "f48":
            mosaic = jp.bicubic_f48_tail(rows, *(v[:, 0] for v in jt), interpret=True)
            got = tdf.df_to_f64(hi, lo_).numpy()
            assert scaled_err(got, jdf.df_to_f64(mosaic[0][:, :r], mosaic[1][:, :r])) <= 1e-5
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
    batch size, in both output forms: no ordering and no launch."""
    monkeypatch.setattr(tp, "_orders", lambda *_: True)
    monkeypatch.setattr(t1, "_orders", lambda nq, bank: True)
    _, packed, xi, yi, t, ny = make_case(kind, 3, "random", seed=5)
    if kind == "K8":
        args = (packed, ints(xi), *tpair(t[0]), 3)
    else:
        args = (packed, ints(xi), ints(yi), ny, *tpair(t[0]), *tpair(t[1]))
    wrapper, plain, f64 = {
        "K8": (t1.gathered_df_tail, t1._df_tail_plain, t1._gathered_df_tail_f64),
        "K12": (tp.gathered_bicubic_df_tail, tp._bicubic_df_tail_plain, None),
        "K13": (tp.gathered_bicubic_f48_tail, tp._bicubic_f48_tail_plain,
                tp._gathered_bicubic_f48_tail_f64),
        "K14": (tp.gathered_bicubic_node_df_tail, tp._bicubic_node_df_tail_plain, None),
        "R4c": (tp.gathered_bicubic_df_weight_tail, tp._bicubic_df_weight_tail_plain, None),
    }[kind]
    before = {k: w.launches for k, w in kernel_wrappers().items()}
    want = plain(*args)
    for a, b in zip(wrapper(*args), want):
        np.testing.assert_array_equal(bits(a), bits(b))
    if f64 is not None:
        got = f64(*args)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy().view(np.int64),
                                      tdf.df_to_f64(*want).numpy().view(np.int64))
    assert {k: w.launches for k, w in kernel_wrappers().items()} == before
