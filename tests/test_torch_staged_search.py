"""A plain model of the staged interval search of ``csrc/search.cuh`` (K1,
K2, K3, R1 on each of its axes, R3, R3idx, and K6 and K7 on their widened
pairs) against the port's ``get_lower_index`` and the JAX package's
searches, on the CPU.

The kernel cannot run here, so its design is checked as numpy: the
breadth-first slot maps, the tree a block stages (knot ``j·w`` for
``j < c`` in a perfect tree of ``2^h - 1`` slots, the pad slots ``+inf``),
the search down the tree, the count clamped to ``c`` (``+inf`` passes the
pad slots), the split at the leaders with the search ending on the axis
between two of them, and the NaN rule (``n - 2``, which the tree's compares
alone would not give).  The model must equal the plain search index for
index; K1's model (the staged index, the row, the Hermite form in the
kernel's operation order) must equal ``_eval_plain`` bit for bit, R1's
(each axis on a tree of half the wrapper's budget) ``_cell_index_plain``
cell for cell, K2's (the index, and the fraction with its endpoints read
from the tree where it holds the whole axis) ``_index_frac_plain``, and
R3's (the index on a leader tree, the row from four 1-D arrays, K1's
Hermite form) ``bigknots._big_eval_plain`` and ``_eval_plain``, R3idx's
(K2's fraction on R3's tree, and its first design's 512 sorted leaders)
``bigknots._big_index_frac_plain`` and ``_index_frac_plain``, and K6's (the
widened pairs on K7's tree, NaN on index 0, the rows widened, the linear
escape's float32 fraction of the knots' hi halves) ``eval_xla_df`` and, in
the float64 store form, ``df_to_f64`` of it.  The kernels themselves are
held at every budget on the card by ``tests/test_torch_kernels.py``.

Tolerance: none (indices; the models against the port's plain versions,
which compute in the same order).  Against the JAX package's ``_eval_xla``
the K1 model is held within ``tests/test_torch_interp1d.py``'s tolerance
(f32 ``rtol=2e-5``, ``atol=1e-6`` scaled; f64 ``1e-12``: XLA may contract
operations), the K2 model's fraction within ``tests/test_torch_ops.py``'s
(``rtol=2e-5``, ``atol=1e-6``) and the R3 model within
``tests/test_torch_bigknots.py``'s (``rtol = atol = 1e-6``; R3idx's index
and fraction exactly, as that file holds them), and the K6 model within
``tests/test_torch_df.py``'s 1e-12 scaled of the JAX ``eval_xla_df``.  The JAX
Pallas kernels give 0 for a NaN query where the XLA form and the port give
``n - 2`` (``tests/test_torch_ops.py``), so those comparisons mask the NaN
rows; their plan stops at 65,536 knots, so the 70,001-knot axis is held
against the JAX XLA search only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.ops import bigknots as j_bk
from ndarray_interp_tpu.ops import df as j_df
from ndarray_interp_tpu.ops import pallas_eval as j_pe
from ndarray_interp_tpu.ops import pallas_eval_df as j_pd
from ndarray_interp_tpu.ops import searchsorted as j_ss
from ndarray_interp_tpu_torch.ops import bigknots as t_bk
from ndarray_interp_tpu_torch.ops import eval_kernels as t_ek
from ndarray_interp_tpu_torch.ops import eval_kernels_df as t_ed
from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64
from ndarray_interp_tpu_torch.ops.searchsorted import get_lower_index


# -- the model -------------------------------------------------------------------------
def slot_of_rank(r, h):
    """``slot_of_rank``: the slot of the knot of sorted rank ``r``."""
    r = np.asarray(r, np.int64)
    t = np.zeros_like(r)  # trailing zeros of r + 1
    while np.any(((r + 1) >> t) & 1 == 0):
        t += ((r + 1) >> t) & 1 == 0
    return (1 << (h - 1 - t)) + ((r + 1) >> (t + 1))


def rank_of_slot(i, h):
    """``rank_of_slot``: the sorted rank of the knot in slot ``i``."""
    i = np.asarray(i, np.int64)
    d = np.floor(np.log2(i)).astype(np.int64)
    return ((2 * (i - (1 << d)) + 1) << (h - 1 - d)) - 1


def tree_levels(c):
    h = 1
    while (1 << h) - 1 < c:
        h += 1
    return h


def stage_tree(knots, w, c, h):
    """The tree a block stages: slot ``i`` (1 .. 2^h - 1) holds knot
    ``rank_of_slot(i)·w``, ``+inf`` past the ``c`` staged knots."""
    slots = np.arange(1, 1 << h)
    r = rank_of_slot(slots, h)
    tree = np.full(1 << h, np.inf, knots.dtype)
    live = r < c
    tree[slots[live]] = knots[r[live] * w]
    return tree


def stride(n, budget, pow2=False):
    """The stride between staged knots: ``ceil(n / budget)``, or (R3) the
    least power of two with ``w · budget >= n``."""
    if not pow2:
        return -(-n // budget)
    w = 1
    while w * budget < n:
        w *= 2
    return w


def staged_lower_index(knots, budget, q, pow2=False, nan_index=None):
    """The kernel's index at a budget of ``budget`` staged knots (>= 1):
    ``w = stride(n, budget)``, ``c = ceil(n / w)``; a NaN query gets
    ``nan_index`` (``n - 2`` unless given: K6 and K7 give 0)."""
    n = knots.size
    w = stride(n, budget, pow2)
    c = -(-n // w)
    h = tree_levels(c)
    tree = stage_tree(knots, w, c, h)
    s = np.ones(q.shape, np.int64)
    for _ in range(h):
        s = 2 * s + (tree[s] <= q)
    count = np.minimum(s - (1 << h), c)  # +inf passes the +inf slots
    if w > 1:  # the search between two leaders, on the axis
        lo = np.where(count > 0, (count - 1) * w + 1, count)
        hi = np.where(count > 0, np.minimum((count - 1) * w + w, n), count)
        while np.any(lo < hi):
            go = lo < hi
            mid = (lo + hi) >> 1
            le = knots[np.minimum(mid, n - 1)] <= q
            lo = np.where(go & le, mid + 1, lo)
            hi = np.where(go & ~le, mid, hi)
        count = lo
    idx = np.clip(count - 1, 0, n - 2)
    return np.where(np.isnan(q), n - 2 if nan_index is None else nan_index, idx).astype(np.int32)


# -- inputs ----------------------------------------------------------------------------
def axis(n, dtype, seed):
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(0.5, 1.5, n - 1)
    return (np.concatenate([[0.0], np.cumsum(gaps)]) * (100.0 / gaps.sum())).astype(dtype)


def queries(kn, dtype, seed, count=2000):
    """Uniform queries with extrapolation, the knots, the midpoints, NaN,
    +-inf, +-1e38 and far extrapolation (the last nine)."""
    rng = np.random.default_rng(seed + 1)
    mids = (kn[:-1] + kn[1:]) / 2
    special = [np.nan, np.inf, -np.inf, 1e38, -1e38, 0.0, -0.0, -1e9, 1e9]
    return np.concatenate([rng.uniform(-20, 120, count), kn, mids, special]).astype(dtype)


# -- the slot maps and the tree ----------------------------------------------------------
@pytest.mark.parametrize("h", [1, 2, 3, 5, 12, 15])
def test_slot_maps_are_inverse_and_in_breadth_first_order(h):
    """Each slot holds one rank and each rank one slot; slot 1 is the middle
    rank, slots 2k and 2k + 1 the middles of the halves below slot k, so an
    in-order walk of the tree visits the ranks in order."""
    slots = np.arange(1, 1 << h)
    ranks = rank_of_slot(slots, h)
    assert sorted(ranks.tolist()) == list(range((1 << h) - 1))
    np.testing.assert_array_equal(slot_of_rank(ranks, h), slots)
    assert rank_of_slot(1, h) == (1 << (h - 1)) - 1
    inner = slots[slots < (1 << (h - 1))]
    assert np.all(rank_of_slot(2 * inner, h) < rank_of_slot(inner, h))
    assert np.all(rank_of_slot(2 * inner + 1, h) > rank_of_slot(inner, h))


@pytest.mark.parametrize("n,budget", [(2, 2), (3, 7), (33, 7), (2048, 4095), (70_001, 8191)])
def test_staged_tree_holds_every_w_th_knot_then_inf(n, budget):
    kn = axis(n, np.float32, n)
    w = -(-n // budget)
    c = -(-n // w)
    h = tree_levels(c)
    tree = stage_tree(kn, w, c, h)
    in_order = tree[slot_of_rank(np.arange((1 << h) - 1), h)]
    np.testing.assert_array_equal(in_order[:c], kn[::w][:c])
    assert np.all(np.isposinf(in_order[c:]))
    assert c <= budget and (c - 1) * w < n <= c * w


# -- the search's rules against the plain ones ------------------------------------------
# (n, budget): the whole axis, leaders of every w-th knot, one knot (every level on the
# axis); the kernel itself is held at every budget by the cuda-marked K3 test of
# tests/test_torch_kernels.py
RULE_CASES = [(2, 1), (3, 2), (33, 7), (2048, 8191), (70_001, 8191), (70_001, 1)]


@pytest.mark.parametrize("n,budget", RULE_CASES)
def test_staged_search_rules_match_get_lower_index(n, budget):
    """In f32 and f64, index for index the port's ``get_lower_index`` and the
    JAX package's: NaN gives ``n - 2`` (the tree's compares alone would give
    0), +inf ``n - 2`` (it passes the +inf pad slots: the count is clamped
    to the staged count), -inf 0."""
    for dtype in (np.float32, np.float64):
        kn = axis(n, dtype, n)
        q = queries(kn, dtype, n + budget)
        got = staged_lower_index(kn, budget, q)
        want = get_lower_index(torch.as_tensor(kn), torch.as_tensor(q)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(j_ss.get_lower_index(jnp.asarray(kn),
                                                                           jnp.asarray(q))))
        assert got[-9:-6].tolist() == [n - 2, n - 2, 0]


@pytest.mark.parametrize("n", [2, 3, 33, 2048])
def test_staged_search_matches_the_jax_pallas_kernel(n):
    """Whole, as leaders and at one knot against the JAX
    ``fused_lower_index`` in interpret mode (f32; its plan ends at 65,536
    knots), NaN rows masked."""
    kn = axis(n, np.float32, n + 1)
    q = queries(kn, np.float32, n, count=500)
    want = np.asarray(j_pe.fused_lower_index(jnp.asarray(kn), jnp.asarray(q), interpret=True))
    real = ~np.isnan(q)
    for budget in (1, 7, 8191):
        np.testing.assert_array_equal(staged_lower_index(kn, budget, q)[real], want[real])


def test_the_wrapper_budget_is_a_32_kb_tree():
    """The budget the wrapper passes: 8,191 knots in f32, 4,095 in f64 (a
    32 KB tree of 2^13 and 2^12 slots), at which a 2,048-knot axis is staged
    whole and a 70,001-knot one as leaders."""
    assert t_ek._K3_TREE_BYTES == 32 << 10
    for size, knots, levels in ((4, 8191, 13), (8, 4095, 12)):
        budget = t_ek._K3_TREE_BYTES // size - 1
        assert budget == knots and tree_levels(budget) == levels
        assert (1 << levels) * size == t_ek._K3_TREE_BYTES
        assert -(-2048 // budget) == 1 and -(-70_001 // budget) > 1


# -- K1: the staged index, the row and the Hermite form ----------------------------------
def staged_eval_1d(knots, tbl, budget, q):
    """K1's model: the staged index at ``budget`` knots, the row
    ``[x_l, x_r, y_l, y_r, a, b]`` and the symmetric Hermite form in the
    kernel's operation order, with the linear table's +-inf lerp."""
    idx = staged_lower_index(knots, budget, q)
    x_l, x_r, y_l, y_r, a, b = (tbl[idx, j] for j in range(6))
    one = q.dtype.type(1)
    with np.errstate(all="ignore"):
        t = (q - x_l) / (x_r - x_l)
        base = (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t)
        lin_inf = np.isinf(t) & (a == 0) & (b == 0)
        return np.where(lin_inf, y_l + t * (y_r - y_l), base)


def tables(kn, seed):
    """A cubic table of random data and slopes, and a linear one (a = b = 0)."""
    rng = np.random.default_rng(seed)
    n, dtype = kn.size, kn.dtype
    d, a, b = (rng.normal(size=m).astype(dtype) for m in (n, n - 1, n - 1))
    k = torch.as_tensor(kn)
    return {"cubic": t_ek.make_interval_table(k, *(torch.as_tensor(v) for v in (d, a, b))),
            "linear": t_ek.make_interval_table(k, torch.as_tensor(d))}


def k1_budget(size):
    """The knots K1's wrapper stages in a tree of ``_K1_TREE_BYTES``."""
    return t_ek._K1_TREE_BYTES // size - 1


@pytest.mark.parametrize("n", [2, 3, 33, 2048, 70_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_model_equals_eval_plain_at_every_budget(n, dtype):
    """Whole, as leaders and at one knot, on a cubic and a linear table:
    bit for bit ``_eval_plain`` (NaN rows NaN, +-inf on the linear table
    +-inf)."""
    kn = axis(n, dtype, n + 2)
    q = queries(kn, dtype, n + 3)
    for name, tbl in tables(kn, n).items():
        want = t_ek._eval_plain(torch.as_tensor(kn), tbl, torch.as_tensor(q)).numpy()
        for budget in (1, 2, 7, 63, k1_budget(np.dtype(dtype).itemsize)):
            got = staged_eval_1d(kn, tbl.numpy(), budget, q)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{name}, budget {budget}")
        assert np.isnan(want[-9])
        if name == "linear":
            assert want[-8] == np.inf * np.sign(want[-8]) and np.isinf(want[-7])


@pytest.mark.parametrize("n", [2, 33, 2048, 70_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_model_matches_the_jax_eval(n, dtype):
    """The K1 model at the wrapper's budget against the JAX package's
    ``fused_eval_1d`` off the TPU (its ``_eval_xla`` form), within
    ``tests/test_torch_interp1d.py``'s tolerance, NaN positions equal."""
    kn = axis(n, dtype, n + 4)
    q = queries(kn, dtype, n + 5)
    rtol, atol = {np.float32: (2e-5, 1e-6), np.float64: (1e-12, 1e-12)}[dtype]
    for name, tbl in tables(kn, n + 1).items():
        got = staged_eval_1d(kn, tbl.numpy(), k1_budget(np.dtype(dtype).itemsize), q)
        want = np.asarray(j_pe._eval_xla(jnp.asarray(kn), jnp.asarray(tbl.numpy()),
                                         jnp.asarray(q)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        scale = float(np.max(np.abs(want[fin & np.isfinite(want)])))
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol * scale,
                                   err_msg=name)


def test_the_k1_budget_and_row_read():
    """K1 stages a tree of 32 KB, as K3 (8,191 f32 / 4,095 f64 knots whole:
    NS1's 2,048 knots whole, 70,001 and 262,144 as leaders), and reads its
    rows in the form the design run chose."""
    assert t_ek._K1_TREE_BYTES == 32 << 10
    assert t_ek._K1_ROW_READ == {torch.float32: 1, torch.float64: 2}
    for size, knots in ((4, 8191), (8, 4095)):
        assert k1_budget(size) == knots
        assert -(-2048 // knots) == 1
        assert -(-70_001 // knots) > 1 and -(-262_144 // knots) > 1


# -- R1: both axes, each on its own tree ---------------------------------------------------
def r1_budget(size):
    """The knots R1's wrapper stages of each axis: a tree of half of
    ``_R1_TREE_BYTES``."""
    return t_ek._R1_TREE_BYTES // 2 // size - 1


def staged_cell_index(x, y, qx, qy):
    """R1's model: each axis searched on a tree of ``r1_budget`` knots, the
    flat cell ``xi (ny - 1) + yi`` (int32) and the fractions in K2's order,
    the endpoints read from the axis (the tree holds the same values)."""
    budget = r1_budget(x.itemsize)
    xi = staged_lower_index(x, budget, qx)
    yi = staged_lower_index(y, budget, qy)
    with np.errstate(all="ignore"):
        tx = (qx - x[xi]) / (x[xi + 1] - x[xi])
        ty = (qy - y[yi]) / (y[yi + 1] - y[yi])
    return (xi * np.int32(y.size - 1) + yi).astype(np.int32), tx, ty


R1_AXES = [(2, 2), (3, 37), (37, 210), (512, 512), (5000, 33), (33, 70_001)]


@pytest.mark.parametrize("nx,ny", R1_AXES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_r1_model_equals_cell_index_plain(nx, ny, dtype):
    """Both trees under the wrapper's split, whole or as leaders: cell for
    cell and fraction for fraction ``_cell_index_plain``, NaN queries on
    ``n - 2`` of their axis, +-inf on the edge cells."""
    x, y = axis(nx, dtype, nx), axis(ny, dtype, ny + 1)
    rng = np.random.default_rng(nx + ny)
    qx, qy = queries(x, dtype, nx), queries(y, dtype, ny)
    m = min(qx.size, qy.size)
    qx, qy = qx[-m:], qy[-m:]
    qy[:-9] = rng.permutation(qy[:-9])
    got = staged_cell_index(x, y, qx, qy)
    want = t_ek._cell_index_plain(*(torch.as_tensor(v) for v in (x, y, qx, qy)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert got[0][-9] == (nx - 2) * (ny - 1) + ny - 2  # NaN on both axes


@pytest.mark.parametrize("nx,ny", [(2, 2), (3, 37), (37, 210), (512, 512)])
def test_r1_model_matches_the_jax_pallas_kernel(nx, ny):
    """The R1 model against the JAX ``fused_cell_index`` in interpret mode
    (f32), rows with a NaN query masked: the Pallas kernel takes index 0 on a
    NaN axis where the port takes ``n - 2``
    (``tests/test_torch_tail2d.py::test_cell_index_of_a_nan_query_diverges_from_jax_kernel``)."""
    x, y = axis(nx, np.float32, nx + 2), axis(ny, np.float32, ny + 3)
    rng = np.random.default_rng(nx * ny)
    qx, qy = queries(x, np.float32, nx, count=400), queries(y, np.float32, ny, count=400)
    m = min(qx.size, qy.size)
    qx, qy = qx[-m:], rng.permutation(qy[-m:])
    got = staged_cell_index(x, y, qx, qy)
    want = j_pe._cell_index_impl(*(jnp.asarray(v) for v in (x, y, qx, qy)), interpret=True)
    real = ~(np.isnan(qx) | np.isnan(qy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[real], np.asarray(w)[real])


def test_the_r1_budget_split():
    """R1 gives each axis a tree of half of 32 KB: 4,095 f32 / 2,047 f64
    knots whole, so NS3's 512-knot axes are each a 10-level tree (4 KB in
    f32, 8 KB in f64) and a 70,001-knot axis takes leaders."""
    assert t_ek._R1_TREE_BYTES == 32 << 10
    for size, knots, ns3_bytes in ((4, 4095, 4 << 10), (8, 2047, 8 << 10)):
        assert r1_budget(size) == knots
        assert tree_levels(512) == 10 and (1 << tree_levels(512)) * size == ns3_bytes
        assert 2 * (1 << tree_levels(knots)) * size == t_ek._R1_TREE_BYTES
        assert -(-70_001 // knots) > 1


# -- K2: the staged index and the fraction -------------------------------------------------
def k2_budget(size):
    """The knots K2's wrapper stages in a tree of ``_K2_TREE_BYTES``."""
    return t_ek._K2_TREE_BYTES // size - 1


def staged_index_frac(knots, budget, q):
    """K2's model: the staged index at ``budget`` knots and ``t = (q - x_l) /
    (x_r - x_l)`` in the kernel's order, the endpoints read from the tree
    where it holds the whole axis (``slot_of_rank``), else from the axis."""
    n = knots.size
    idx = staged_lower_index(knots, budget, q)
    w = -(-n // budget)
    c = -(-n // w)
    h = tree_levels(c)
    if w == 1:
        tree = stage_tree(knots, w, c, h)
        x_l, x_r = tree[slot_of_rank(idx, h)], tree[slot_of_rank(idx + 1, h)]
    else:
        x_l, x_r = knots[idx], knots[idx + 1]
    with np.errstate(all="ignore"):
        return idx, (q - x_l) / (x_r - x_l)


def assert_bits(got, want, msg=""):
    """Equal values, NaN positions and signs of zero."""
    assert got.dtype == want.dtype, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want), err_msg=msg)


@pytest.mark.parametrize("n", [2, 3, 33, 2048, 10_000, 70_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_model_equals_index_frac_plain_at_every_budget(n, dtype):
    """At one knot (every level on the axis: the first design's search), as
    leaders (2, 7 and 63 knots), at the wrapper's budget (the whole axis up
    to 8,191 f32 / 4,095 f64 knots, leaders above) and whole (16,383
    knots): idx for idx and t bit for bit ``_index_frac_plain``, NaN on
    ``n - 2`` with t NaN, +-inf on the edge intervals, each knot its own
    interval's start (t = 0, the last knot t = 1)."""
    kn = axis(n, dtype, n + 6)
    q = queries(kn, dtype, n + 7)
    want_idx, want_t = (v.numpy() for v in t_ek._index_frac_plain(torch.as_tensor(kn),
                                                                  torch.as_tensor(q)))
    for budget in (1, 2, 7, 63, k2_budget(np.dtype(dtype).itemsize), 16_383):
        idx, t = staged_index_frac(kn, budget, q)
        np.testing.assert_array_equal(idx, want_idx, err_msg=f"budget {budget}")
        assert_bits(t, want_t, f"budget {budget}")
    assert want_idx[-9] == n - 2 and np.isnan(want_t[-9])
    assert want_idx[-8] == n - 2 and want_idx[-7] == 0
    knots_at = slice(-9 - (n - 1) - n, -9 - (n - 1))  # the knots in the batch
    np.testing.assert_array_equal(want_t[knots_at][:-1], 0)
    assert want_t[knots_at][-1] == 1


@pytest.mark.parametrize("n", [4, 33, 2048, 10_000])
def test_k2_model_matches_the_jax_pallas_kernel(n):
    """The K2 model at one knot, as leaders and at the wrapper's budget
    against the JAX ``fused_index_frac`` in interpret mode (f32), as
    ``tests/test_torch_ops.py::test_index_frac_matches_pallas_kernel`` runs
    it: the index exactly and t within that test's tolerance (``rtol=2e-5,
    atol=1e-6``), the NaN rows masked (the Pallas kernel gives index 0 for a
    NaN query, the port ``n - 2``; t is NaN in both)."""
    kn = axis(n, np.float32, n + 8)
    q = queries(kn, np.float32, n + 9, count=500)
    j_idx, j_t = (np.asarray(v) for v in j_pe._index_frac_impl(jnp.asarray(kn), jnp.asarray(q),
                                                               interpret=True))
    real = ~np.isnan(q)
    for budget in (1, 7, k2_budget(4)):
        idx, t = staged_index_frac(kn, budget, q)
        np.testing.assert_array_equal(idx[real], j_idx[real])
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j_t))
        fin = ~np.isnan(t)
        np.testing.assert_allclose(t[fin], j_t[fin], rtol=2e-5, atol=1e-6)
    assert idx[np.isnan(q)].tolist() == [n - 2] and j_idx[np.isnan(q)].tolist() == [0]


def test_the_k2_budget_is_a_16_kb_tree_where_it_pays():
    """K2 stages a tree of ``_K2_TREE_BYTES`` (4,095 f32 / 2,047 f64 knots
    whole: the N-D axes' 64 and 256 knots and NS3b's 512) where a batch has
    at least 64 queries a knot and the axis more than 256 bytes, else runs
    its first design (budget 0): the bank eval's 10,000 knots x 262,144
    queries (26 a knot) and a 64-knot f32 axis take the first design, NS2b's
    10,240 x 1,000,000 leaders of every third knot."""
    assert t_ek._K2_TREE_BYTES == 16 << 10
    assert (t_ek._K2_QUERIES_A_KNOT, t_ek._K2_SMALL_AXIS_BYTES) == (64, 256)
    budget = t_ek._k2_budget
    for size, knots in ((4, 4095), (8, 2047)):
        assert k2_budget(size) == knots
        assert budget(512, 1_000_000, size) == budget(256, 1_000_000, size) == knots
        assert budget(10_000, 262_144, size) == 0 and budget(10_240, 1_000_000, size) == knots
    assert budget(64, 1_000_000, 4) == 0 and budget(64, 1_000_000, 8) == 2047
    assert -(-10_240 // k2_budget(4)) == 3


# -- R3: the staged leader tree and K1's body on four 1-D arrays ----------------------------
def r3_budget(size):
    """The knots R3's wrapper stages in a tree of ``_R3_TREE_BYTES``."""
    return t_bk._R3_TREE_BYTES // size - 1


def staged_big_eval(knots, data, a, b, budget, q):
    """R3's model: the staged index at ``budget`` knots, every w-th knot for
    the least power of two w that fits (past 65,536 knots always leaders),
    the interval's ``x_l, x_r, y_l, y_r, a, b`` from the four arrays, and K1's
    Hermite form in its operation order, with the linear table's +-inf
    lerp."""
    idx = staged_lower_index(knots, budget, q, pow2=True)
    x_l, x_r, y_l, y_r, ga, gb = (knots[idx], knots[idx + 1], data[idx], data[idx + 1],
                                  a[idx], b[idx])
    one = q.dtype.type(1)
    with np.errstate(all="ignore"):
        t = (q - x_l) / (x_r - x_l)
        base = (one - t) * y_l + t * y_r + t * (one - t) * (ga * (one - t) + gb * t)
        lin_inf = np.isinf(t) & (ga == 0) & (gb == 0)
        return np.where(lin_inf, y_l + t * (y_r - y_l), base)


def big_case(n, seed):
    """A long f32 axis of gaps 0.5 to 1.5, data, slopes and 4,000 queries:
    uniform with extrapolation, knots, NaN, +-inf, +-1e38."""
    rng = np.random.default_rng(seed)
    kn = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
    assert np.all(np.diff(kn) > 0)
    d, a, b = (rng.normal(size=m).astype(np.float32) for m in (n, n - 1, n - 1))
    lo, hi = float(kn[0]), float(kn[-1])
    q = np.r_[rng.uniform(lo - 2, hi + 2, 3000), kn[rng.integers(0, n, 991)],
              [np.nan, np.inf, -np.inf, 1e38, -1e38, lo, hi, kn[1], kn[-2]]].astype(np.float32)
    return kn, d, a, b, q


@pytest.mark.parametrize("n", [65_537, 262_144])
@pytest.mark.parametrize("table", ["cubic", "linear"])
def test_r3_model_equals_big_eval_plain_at_every_budget(n, table):
    """At one knot, as leaders (2, 63, 4,095 and 16,384 knots: every 16th of
    262,144) and at the wrapper's budget (a 128 KB f32 tree of 32,767
    knots): bit for bit ``bk._big_eval_plain`` and K1's ``_eval_plain``, on
    a cubic and a linear table (+-inf lerps), NaN queries NaN."""
    kn, d, a, b, q = big_case(n, n)
    if table == "linear":
        a, b = np.zeros_like(a), np.zeros_like(b)
    tk, td, ta, tb, tq = (torch.as_tensor(v) for v in (kn, d, a, b, q))
    want = t_bk._big_eval_plain(tk, td, ta, tb, tq).numpy()
    assert_bits(t_ek._eval_plain(tk, t_ek.make_interval_table(tk, td, ta, tb), tq).numpy(), want)
    for budget in (1, 2, 63, 4095, 16_384, r3_budget(4)):
        assert_bits(staged_big_eval(kn, d, a, b, budget, q), want, f"budget {budget}")
    assert np.isnan(want[-9])
    if table == "linear":
        assert np.isinf(want[-8]) and np.isinf(want[-7])


@pytest.mark.parametrize("table", ["cubic", "linear"])
def test_r3_model_matches_the_jax_big_eval(table):
    """The R3 model at the wrapper's budget and at one knot against the JAX
    ``big_eval_1d`` off the TPU (its XLA search and refine, ``pallas=False``)
    within ``tests/test_torch_bigknots.py``'s tolerance (``rtol = atol =
    1e-6``), on the finite queries: the JAX refine's mask-sum takes no
    +-inf lerp, and a NaN query takes its index 0 where the port takes
    ``n - 2`` (both NaN)."""
    kn, d, a, b, q = big_case(70_001, 3)
    if table == "linear":
        a, b = np.zeros_like(a), np.zeros_like(b)
    want = np.asarray(j_bk._big_eval_impl(*(jnp.asarray(v) for v in (kn, d, a, b, q)),
                                          pallas=False))
    fin = np.isfinite(q) & (np.abs(q) < 1e30)
    for budget in (1, r3_budget(4)):
        got = staged_big_eval(kn, d, a, b, budget, q)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    assert np.isnan(got[np.isnan(q)]).all() and np.isnan(want[np.isnan(q)]).all()


def test_the_r3_budget_is_a_128_kb_tree():
    """R3 stages a tree of ``_R3_TREE_BYTES``: at most 32,767 f32 knots (a
    15-level tree, the largest ``tree_budget`` lets a block hold in f32), so
    every axis of the route (65,537 to ``MAX_BIG_KNOTS`` knots) is staged as
    leaders strided by a power of two: every 4th knot at 65,537, every 16th
    at NS1b's 262,144 (16,384 leaders), every 512th at 8,388,480."""
    assert t_bk._R3_TREE_BYTES == 128 << 10
    budget = r3_budget(4)
    assert budget == 32_767 and tree_levels(budget) == 15
    assert (1 << tree_levels(budget)) * 4 == t_bk._R3_TREE_BYTES
    ns = (65_537, 262_144, t_bk.MAX_BIG_KNOTS)
    assert [stride(n, budget, pow2=True) for n in ns] == [4, 16, 512]
    assert all(tree_levels(-(-n // stride(n, budget, pow2=True))) <= 15 for n in ns)


# -- R3idx: K2's staged kernel on R3's leader tree, and its first design --------------------
def first_design_lower_index(knots, q):
    """R3idx's first design (``big_lower_index``): the leaders ``knots[j·W]``
    for the least power of two ``W >= 16`` whose leaders fit 2 KB, searched
    in sorted order, then the search inside the leader's block of ``W``
    knots; NaN gives ``n - 2``."""
    n = knots.size
    cap = 2048 // knots.itemsize
    w = 16
    while -(-n // w) > cap:
        w *= 2
    lead = knots[::w]
    lo = np.searchsorted(lead, q, side="right")  # leaders <= q (NaN: none)
    base = np.maximum(lo - 1, 0) * w
    hi = np.minimum(base + w, n)
    count = np.array([b + np.searchsorted(knots[b + 1:h], v, side="right") + 1
                      for b, h, v in zip(base, hi, q)])
    idx = np.clip(np.where(lo == 0, 0, count - 1), 0, n - 2)
    return np.where(np.isnan(q), n - 2, idx).astype(np.int32)


def staged_big_index_frac(knots, budget, q):
    """R3idx's model: at budget 0 the first design's index, else K2's staged
    index on R3's tree (every w-th knot, w the least power of two that fits
    ``budget``), and ``t = (q - x_l) / (x_r - x_l)`` in K2's order, the
    endpoints from the tree where it holds the whole axis (w = 1), else from
    the knots."""
    n = knots.size
    if budget == 0:
        idx = first_design_lower_index(knots, q)
        x_l, x_r = knots[idx], knots[idx + 1]
    else:
        idx = staged_lower_index(knots, budget, q, pow2=True)
        w = stride(n, budget, pow2=True)
        c = -(-n // w)
        h = tree_levels(c)
        if w == 1:
            tree = stage_tree(knots, w, c, h)
            x_l, x_r = tree[slot_of_rank(idx, h)], tree[slot_of_rank(idx + 1, h)]
        else:
            x_l, x_r = knots[idx], knots[idx + 1]
    with np.errstate(all="ignore"):
        return idx, (q - x_l) / (x_r - x_l)


@pytest.mark.parametrize("n", [65_537, 262_144])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_r3idx_model_equals_index_frac_plain_at_every_budget(n, dtype):
    """In its first design (0), at one knot, as leaders (2, 63, 4,095 knots),
    at the wrapper's budget (a 128 KB tree: 32,767 f32 / 16,383 f64 knots;
    every 4th or 8th knot at 65,537, every 16th or 32nd at 262,144) and
    whole (``n`` knots): idx for idx and t bit for bit
    ``bigknots._big_index_frac_plain`` and K2's ``_index_frac_plain``, NaN on
    ``n - 2`` with t NaN, +inf on ``n - 2``, -inf on 0, each knot its own
    interval's start (t = 0, the last knot t = 1)."""
    kn, _, _, _, q = big_case(n, n + 1)
    kn, q = kn.astype(dtype), q.astype(dtype)
    tk, tq = torch.as_tensor(kn), torch.as_tensor(q)
    want_idx, want_t = (v.numpy() for v in t_bk._big_index_frac_plain(tk, tq))
    k2_idx, k2_t = (v.numpy() for v in t_ek._index_frac_plain(tk, tq))
    np.testing.assert_array_equal(want_idx, k2_idx)
    assert_bits(want_t, k2_t)
    for budget in (0, 1, 2, 63, 4095, r3_budget(np.dtype(dtype).itemsize), n):
        idx, t = staged_big_index_frac(kn, budget, q)
        np.testing.assert_array_equal(idx, want_idx, err_msg=f"budget {budget}")
        assert_bits(t, want_t, f"budget {budget}")
    assert want_idx[-9] == n - 2 and np.isnan(want_t[-9])
    assert want_idx[-8] == n - 2 and want_idx[-7] == 0
    on_knots = slice(3000, 3991)  # the queries that are knots
    np.testing.assert_array_equal(kn[want_idx[on_knots]] <= q[on_knots], True)
    exact = q[on_knots] < kn[-1]
    np.testing.assert_array_equal(want_t[on_knots][exact], 0)
    assert want_t[-3] == 1 and want_t[-4] == 0  # the last knot, the first


def test_r3idx_model_matches_the_jax_big_lower_index_frac():
    """The R3idx model in its first design, at one knot and at the wrapper's
    budget against the JAX ``big_lower_index_frac`` off the TPU (its XLA
    search, ``pallas=False``): idx and t exactly, as
    ``tests/test_torch_bigknots.py`` holds them, the NaN row masked (the JAX
    search gives 0 there, the port ``n - 2``:
    ``test_torch_bigknots.py::test_nan_query_index_diverges_from_jax``)."""
    kn, _, _, _, q = big_case(70_001, 5)
    j_idx, j_t = (np.asarray(v) for v in j_bk.big_lower_index_frac(jnp.asarray(kn),
                                                                  jnp.asarray(q), pallas=False))
    real = ~np.isnan(q)
    for budget in (0, 1, r3_budget(4)):
        idx, t = staged_big_index_frac(kn, budget, q)
        np.testing.assert_array_equal(idx[real], j_idx[real])
        assert_bits(t[real], j_t[real], f"budget {budget}")
    assert idx[~real].tolist() == [70_001 - 2] and j_idx[~real].tolist() == [0]


def test_the_r3idx_budget_is_r3s_tree_past_384_kb(monkeypatch):
    """R3idx stages R3's 128 KB tree (32,767 f32 / 16,383 f64 knots) at
    every length of the route, past 384 KB of axis as below it: the wrapper
    hands the kernel R3's budget, every 16th knot at NS1b's 262,144 f32
    knots, every 4th at the route's shortest, 65,537."""
    launched = []
    monkeypatch.setattr(t_bk._cuda, "launch", lambda *a: launched.append(a))
    for n, dtype in ((65_537, torch.float32), (98_304, torch.float32),
                     (262_144, torch.float32), (65_537, torch.float64)):
        k = torch.arange(n, dtype=dtype)
        t_bk._launch_index_frac(k, k[:3])
    assert [a[0] for a in launched] == ["ndi_big_index_frac"] * 4
    budgets = [a[5] for a in launched]
    assert budgets == [r3_budget(4)] * 3 + [r3_budget(8)] == [32_767] * 3 + [16_383]
    assert stride(262_144, budgets[2], pow2=True) == 16
    assert stride(65_537, budgets[0], pow2=True) == 4


# -- K6: the widened pairs on K7's tree, the rows, the linear escape -------------------------
def k6_budget():
    """The widened knots K6's wrapper stages: K7's budget, 16,383."""
    return t_ed._K6_SHARED_KNOTS


def staged_df_eval(x, d, a, b, q, budget, f64=False):
    """K6's model on pairs ``(hi, lo)`` of float32 numpy arrays: the knots
    widened on a tree of ``budget`` knots (K7's stride), NaN on index 0,
    x_l and x_r from the tree where it holds the whole axis, the rows
    widened, the Hermite form in float64 in the kernel's order, and the
    result pair; the linear escape only on a segment whose widened a and b
    are 0 and whose four halves are 0, its float32 fraction of the knots' hi
    halves.  With ``f64`` the float64 store form ``hi + lo``."""
    wide = lambda p: p[0].astype(np.float64) + p[1].astype(np.float64)  # noqa: E731
    xw, qw = wide(x), wide(q)
    n = xw.size
    k = staged_lower_index(xw, budget, qw, nan_index=0)
    w = stride(n, budget)
    c = -(-n // w)
    h = tree_levels(c)
    if w == 1:
        tree = stage_tree(xw, w, c, h)
        x_l, x_r = tree[slot_of_rank(k, h)], tree[slot_of_rank(k + 1, h)]
    else:
        x_l, x_r = xw[k], xw[k + 1]
    dw, aw, bw = wide(d), wide(a), wide(b)
    with np.errstate(all="ignore"):
        t = (qw - x_l) / (x_r - x_l)
        omt = 1.0 - t
        base = (omt * dw[k] + t * dw[k + 1]) + (t * omt) * (aw[k] * omt + bw[k] * t)
        hi = base.astype(np.float32)
        lo = np.where(np.isfinite(hi), (base - hi.astype(np.float64)).astype(np.float32),
                      np.float32(0))
        linear = ((aw[k] == 0) & (bw[k] == 0) & (a[0][k] == 0) & (a[1][k] == 0)
                  & (b[0][k] == 0) & (b[1][k] == 0))
        x_lh, x_rh = x[0][k], x[0][k + 1]
        tn = (q[0] - x_lh) / (x_rh - x_lh)
        escape = linear & np.isinf(tn)
        y_lh, y_rh = d[0][k], d[0][k + 1]
        hi = np.where(escape, y_lh + tn * (y_rh - y_lh), hi)
        lo = np.where(escape, np.float32(0), lo)
    if f64:
        return hi.astype(np.float64) + lo.astype(np.float64)
    return hi, lo


def np_pair(v):
    return tuple(h.numpy() for h in df_from_f64(torch.as_tensor(np.asarray(v, np.float64))))


def df_case(n, spacing, table, seed, shifted=False):
    """K6's inputs as float32 pairs: knots of gaps 0.5 to 1.5, or (``collide``)
    1e-9 to 1e-7 apart near 1.0, most of them equal in float32; a cubic table
    or a linear one (a = b = 0); queries uniform with extrapolation, the
    knots, the midpoints, NaN, +-inf, +-1e300 and far extrapolation.  With
    ``shifted`` the pairs of every other knot are not normalised: the hi half
    moved one float32 step up and the lo half taken from the rest, so the
    widened knot rounded to float32 is not its hi half (on collided knots the
    hi halves of two neighbours then differ where the widened ones round
    alike)."""
    rng = np.random.default_rng(seed)
    if spacing == "collide":
        kn = np.cumsum(rng.uniform(1e-9, 1e-7, n)) + 1.0
    else:
        kn = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, n - 1))])
    d = rng.normal(size=n)
    a, b = ((np.zeros(n - 1), np.zeros(n - 1)) if table == "linear" else
            (rng.normal(size=n - 1), rng.normal(size=n - 1)))
    lo, hi = kn[0], kn[-1]
    span = hi - lo
    q = np.concatenate([rng.uniform(lo - 0.2 * span, hi + 0.2 * span, 3000), kn,
                        (kn[:-1] + kn[1:]) / 2,
                        [np.nan, np.inf, -np.inf, 1e300, -1e300, lo - 1e6 * span,
                         hi + 1e6 * span]])
    x = np_pair(kn)
    if shifted:
        xh = x[0].copy()
        xh[1::2] = np.nextafter(xh[1::2], np.float32(np.inf))
        x = (xh, (kn - xh.astype(np.float64)).astype(np.float32))
        assert np.any(x[0] != np_pair(x[0].astype(np.float64) + x[1].astype(np.float64))[0])
    return x, np_pair(d), np_pair(a), np_pair(b), np_pair(q)


K6_CASES = [(2, "nonuniform", "cubic", False), (3, "nonuniform", "linear", False),
            (33, "collide", "cubic", False), (33, "collide", "linear", False),
            (4096, "nonuniform", "cubic", False), (4096, "nonuniform", "linear", True),
            (4096, "collide", "linear", False), (4096, "collide", "linear", True),
            (20_000, "nonuniform", "cubic", True),
            (20_000, "collide", "linear", False)]


@pytest.mark.parametrize("n,spacing,table,shifted", K6_CASES)
def test_k6_model_equals_eval_xla_df_at_every_budget(n, spacing, table, shifted):
    """In both store forms, at one knot (every level on the global pairs),
    as leaders (2, 7 and 63 knots), at the wrapper's budget (16,383 knots:
    4,096 whole, 20,000 as leaders of every second knot) and whole: bit for
    bit ``eval_xla_df``'s pair and ``df_to_f64`` of it; NaN queries on index
    0 (NaN), +-inf on a linear table the float32 lerp of the hi halves
    (+-inf), knots that collide in float32 told apart, and pairs that are
    not normalised read through their hi halves for the escape's
    fraction."""
    args = df_case(n, spacing, table, n + len(spacing), shifted)
    x, d, a, b, q = args
    t_args = [torch.as_tensor(h) for p in args for h in p]
    want = tuple(v.numpy() for v in t_ed.eval_xla_df(*t_args))
    want64 = df_to_f64(*t_ed.eval_xla_df(*t_args)).numpy()
    for budget in (1, 2, 7, 63, k6_budget(), n):
        got = staged_df_eval(x, d, a, b, q, budget)
        assert_bits(got[0], want[0], f"hi, budget {budget}")
        assert_bits(got[1], want[1], f"lo, budget {budget}")
        assert_bits(staged_df_eval(x, d, a, b, q, budget, f64=True), want64,
                    f"float64 store form, budget {budget}")
    nan_at = -7
    assert np.isnan(want64[nan_at])
    if table == "linear":
        assert np.isinf(want64[nan_at + 1]) and np.isinf(want64[nan_at + 2])
        assert want[1][nan_at + 1] == 0 and want[1][nan_at + 2] == 0


def test_k6_model_index_gives_nan_queries_index_0():
    """K6's and K7's NaN rule: index 0, where the float32 searches give
    ``n - 2``; equal to the plain ``_df_lower_index`` at every budget."""
    x, _, _, _, q = df_case(4096, "collide", "cubic", 9)
    xw = x[0].astype(np.float64) + x[1].astype(np.float64)
    qw = q[0].astype(np.float64) + q[1].astype(np.float64)
    want = t_ed._df_lower_index(*(torch.as_tensor(v) for v in (*x, *q)), 4096).numpy()
    for budget in (1, 7, k6_budget()):
        got = staged_lower_index(xw, budget, qw, nan_index=0)
        np.testing.assert_array_equal(got, want)
        assert got[np.isnan(qw)].tolist() == [0]


@pytest.mark.parametrize("spacing", ["nonuniform", "collide"])
@pytest.mark.parametrize("table", ["cubic", "linear"])
def test_k6_model_matches_the_jax_eval_xla_df(spacing, table):
    """The K6 model at the wrapper's budget and at one knot against the JAX
    ``eval_xla_df`` on the same pairs, within ``tests/test_torch_df.py``'s
    1e-12 scaled (its scalar test, ``:234``), on the queries whose result
    is finite in both, NaN positions equal."""
    x, d, a, b, q = df_case(2048, spacing, table, 21)
    jargs = [jnp.asarray(h) for p in (x, d, a, b, q) for h in p]
    want = np.asarray(j_df.df_to_f64(*jax.jit(j_pd.eval_xla_df)(*jargs)))
    scale = np.abs(d[0].astype(np.float64)).max()
    for budget in (1, k6_budget()):
        got = staged_df_eval(x, d, a, b, q, budget, f64=True)
        fin = np.isfinite(got) & np.isfinite(want)
        np.testing.assert_array_equal(np.isnan(got[:-7]), np.isnan(want[:-7]))
        err = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 0.01 * scale)
        assert float(err.max()) <= 1e-12, budget


def test_the_k6_budget_is_k7s_and_reads_its_rows_widened():
    """K6 stages K7's budget (16,383 knots whole: the serving spline's
    4,096 knots in a 13-level tree of 64 KB, its rows 96 KB after it, so
    that the kernel widens them into shared memory beside the tree)."""
    assert t_ed._K6_SHARED_KNOTS == t_ed._K7_SHARED_KNOTS == 16_383
    assert tree_levels(4096) == 13 and (1 << 13) * 8 == 64 << 10
    assert (3 * 4096 - 2) * 8 <= 96 << 10
    assert (1 << tree_levels(16_383)) * 8 == 128 << 10
