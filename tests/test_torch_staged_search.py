"""A plain model of the staged interval search of ``csrc/search.cuh`` (K3,
and K7 on its widened pairs) against the port's ``get_lower_index`` and the
JAX package's searches, on the CPU.

The kernel cannot run here, so its design is checked as numpy: the
breadth-first slot maps, the tree a block stages (knot ``j·w`` for
``j < c`` in a perfect tree of ``2^h - 1`` slots, the pad slots ``+inf``),
the search down the tree, the count clamped to ``c`` (``+inf`` passes the
pad slots), the split at the leaders with the search ending on the axis
between two of them, and the NaN rule (``n - 2``, which the tree's compares
alone would not give).  The model must equal the plain search index for
index; the kernel itself is held at every budget on the card by
``tests/test_torch_kernels.py``.

Tolerance: none (indices).  The JAX Pallas kernel gives 0 for a NaN query
where the XLA form and the port give ``n - 2`` (``tests/test_torch_ops.py``),
so that comparison masks the NaN rows; its plan stops at 65,536 knots, so
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
