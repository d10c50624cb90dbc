"""A plain model of the staged interval search of ``csrc/search.cuh`` (K1,
K3, R1 on each of its axes, and K7 on its widened pairs) against the port's
``get_lower_index`` and the JAX package's searches, on the CPU.

The kernel cannot run here, so its design is checked as numpy: the
breadth-first slot maps, the tree a block stages (knot ``j·w`` for
``j < c`` in a perfect tree of ``2^h - 1`` slots, the pad slots ``+inf``),
the search down the tree, the count clamped to ``c`` (``+inf`` passes the
pad slots), the split at the leaders with the search ending on the axis
between two of them, and the NaN rule (``n - 2``, which the tree's compares
alone would not give).  The model must equal the plain search index for
index; K1's model (the staged index, the row, the Hermite form in the
kernel's operation order) must equal ``_eval_plain`` bit for bit, and R1's
(each axis on a tree of half the wrapper's budget) ``_cell_index_plain``
cell for cell.  The kernels themselves are held at every budget on the card
by ``tests/test_torch_kernels.py``.

Tolerance: none (indices; K1's and R1's models against the port's plain
versions, which compute in the same order).  Against the JAX package's
``_eval_xla`` the K1 model is held within ``tests/test_torch_interp1d.py``'s
tolerance (f32 ``rtol=2e-5``, ``atol=1e-6`` scaled; f64 ``1e-12``: XLA may
contract operations).  The JAX Pallas kernels give 0 for a NaN query where
the XLA form and the port give ``n - 2`` (``tests/test_torch_ops.py``), so
those comparisons mask the NaN rows; their plan stops at 65,536 knots, so
the 70,001-knot axis is held against the JAX XLA search only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndarray_interp_tpu.ops import pallas_eval as j_pe
from ndarray_interp_tpu.ops import searchsorted as j_ss
from ndarray_interp_tpu_torch.ops import eval_kernels as t_ek
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


def staged_lower_index(knots, budget, q):
    """The kernel's index at a budget of ``budget`` staged knots (>= 1):
    ``w = ceil(n / budget)``, ``c = ceil(n / w)``."""
    n = knots.size
    w = -(-n // budget)
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
    return np.where(np.isnan(q), n - 2, idx).astype(np.int32)


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
