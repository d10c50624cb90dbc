"""The port's long-knot-axis routes (``ops/bigknots.py``: R3 and R3idx, and
the scalar dispatch of ``CubicSplineStrategy`` and ``Linear``) against the
JAX package's ``ops.bigknots``, on the CPU.

The same numpy inputs, made from seeds, go through the JAX functions (its
XLA two-stage search, ``pallas=False``; the Pallas refine tail in interpret
mode on 512 queries only) and through the port's counterparts, which run
their kernels' plain PyTorch versions on CPU tensors.  Axes are just above
65,536 knots and queries few, so the file stays fast.

Tolerances: indices and fractions are compared exactly (both packages
compute ``t`` in one float32 operation order); values at ``rtol = atol =
1e-6`` (``tests/test_bigknots.py:63``); gradients at ``rtol = atol = 1e-4``
(``:119``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp1d.cubic_spline as j_cs
import ndarray_interp_tpu.ops.bigknots as j_bk
import ndarray_interp_tpu.ops.pallas_eval as j_pe
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.models.strategies.cubic as t_cubic
import ndarray_interp_tpu_torch.models.strategies.linear as t_linear
from ndarray_interp_tpu.ops.searchsorted import get_lower_index as j_lower_index
from ndarray_interp_tpu_torch.interop import interp1d_from_numpy
from ndarray_interp_tpu_torch.ops import bigknots as t_bk
from ndarray_interp_tpu_torch.ops import eval_kernels as t_ek
from ndarray_interp_tpu_torch.ops import kernel_wrappers


def fixture(n=70_001, nq=4096, seed=0, uniform=False):
    """The inputs of ``tests/test_bigknots.py:22-39``, as numpy."""
    rng = np.random.default_rng(seed)
    if uniform:
        x = np.linspace(0.0, 1.0, n).astype(np.float32)
    else:
        x = np.cumsum(rng.uniform(0.01, 1.0, n)).astype(np.float32)
        x = np.asarray(np.unique(x), np.float32)
    n = x.shape[0]
    d = rng.normal(size=n).astype(np.float32)
    a = rng.normal(size=n - 1).astype(np.float32)
    b = rng.normal(size=n - 1).astype(np.float32)
    lo, hi = float(x[0]), float(x[-1])
    q = np.r_[
        rng.uniform(lo - 2, hi + 2, nq - 10),
        [lo, hi, np.inf, -np.inf, 1e38, -1e38, x[n // 2], x[1], x[-2], x[16]],
    ].astype(np.float32)
    return x, d, a, b, q


def same(got, want):
    """Bit for bit, NaN positions equal."""
    ng, nw = torch.isnan(got), torch.isnan(want)
    return torch.equal(ng, nw) and torch.equal(got[~ng], want[~nw])


def J(*arrays):
    return [jnp.asarray(v) for v in arrays]


def T(*arrays):
    return [torch.as_tensor(v) for v in arrays]


@pytest.mark.parametrize("uniform", [False, True])
def test_index_and_fraction_match_jax_search(uniform):
    x, _, _, _, q = fixture(uniform=uniform)
    want_idx, want_t = j_bk.big_lower_index_frac(*J(x, q), pallas=False)
    idx, t = t_bk.big_lower_index_frac(*T(x, q))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))
    # and both are get_lower_index and K2's plain fraction
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_lower_index(*J(x, q))))
    k2_idx, k2_t = t_ek._index_frac_plain(*T(x, q))
    assert torch.equal(idx, k2_idx) and same(t, k2_t)


def test_nan_query_index_diverges_from_jax():
    """A NaN query: the JAX search gives block 0, index 0; the port gives
    n-2, as K2 and ``get_lower_index`` do.  The fraction is NaN in both."""
    x, _, _, _, _ = fixture(nq=16)
    q = np.array([np.nan, x[10]], np.float32)
    j_idx, j_t = j_bk.big_lower_index_frac(*J(x, q), pallas=False)
    idx, t = t_bk.big_lower_index_frac(*T(x, q))
    assert int(np.asarray(j_idx)[0]) == 0
    assert int(idx[0]) == x.shape[0] - 2 == int(t_ek._index_frac_plain(*T(x, q))[0][0])
    assert np.isnan(np.asarray(j_t)[0]) and bool(torch.isnan(t[0]))
    assert int(idx[1]) == int(np.asarray(j_idx)[1]) == 10


def test_eval_matches_jax_gather_formulation():
    x, d, a, b, q = fixture()
    want = np.asarray(j_pe._eval_xla(J(x)[0], j_pe.make_interval_table(*J(x, d, a, b)), J(q)[0]))
    got = t_bk.big_eval_1d(*T(x, d, a, b, q))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    jbig = np.asarray(j_bk._big_eval_impl(*J(x, d, a, b, q), pallas=False))
    np.testing.assert_allclose(got.numpy(), jbig, rtol=1e-6, atol=1e-6)
    # the plain version is K1's plain version, bit for bit
    tx, td, ta, tb, tq = T(x, d, a, b, q)
    want_k1 = t_ek._eval_plain(tx, t_ek.make_interval_table(tx, td, ta, tb), tq)
    assert same(got, want_k1)


def test_eval_linear_inf_and_nan_query():
    n = 70_000
    x = np.linspace(0.0, 1.0, n).astype(np.float32)
    d = 3.0 * x + 1.0
    z = np.zeros(n - 1, np.float32)
    q = np.array([np.inf, -np.inf, np.nan, x[10]], np.float32)
    got = t_bk.big_eval_1d(*T(x, d, z, z, q)).numpy()
    want = np.asarray(j_bk._big_eval_impl(*J(x, d, z, z, q), pallas=False))
    assert got[0] == np.inf and got[1] == -np.inf
    assert np.isnan(got[2]) and np.isnan(want[2]) and np.isfinite(got[3])
    np.testing.assert_allclose(got[[0, 1, 3]], want[[0, 1, 3]], rtol=1e-6)


def test_backward_matches_jax_be_bwd(monkeypatch):
    """The R3 wrapper's autograd.Function (its forward run by the plain
    version here) against the JAX package's ``_be_bwd``."""
    x, d, a, b, q = fixture(nq=256)
    q = np.clip(q, x[0], x[-1])
    jx, jd, ja, jb, jq = J(x, d, a, b, q)
    out = j_pe._eval_xla(jx, j_pe.make_interval_table(jx, jd, ja, jb), jq)
    want = j_bk._be_bwd((jx, jd, ja, jb, jq), 2.0 * out)
    monkeypatch.setattr(t_bk, "_launch_eval", t_bk._big_eval_plain)
    leaves = [v.requires_grad_(True) for v in T(x, d, a, b, q)]
    (t_bk._BIG_EVAL.function.apply(*leaves) ** 2).sum().backward()
    for leaf, w in zip(leaves[1:], want[1:]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    # the CPU route differentiates the plain version itself: the same gradients
    cpu = [v.requires_grad_(True) for v in T(x, d, a, b, q)]
    (t_bk.big_eval_1d(*cpu) ** 2).sum().backward()
    for leaf, c in zip(leaves[1:], cpu[1:]):
        torch.testing.assert_close(leaf.grad, c.grad, rtol=1e-5, atol=1e-5)


def test_index_frac_backward_is_the_fraction(monkeypatch):
    monkeypatch.setattr(t_bk, "_launch_index_frac", t_bk._big_index_frac_plain)
    x, _, _, _, q = fixture(nq=64)
    q = np.clip(q, x[0], x[-1])
    grads = []
    for fn in (t_bk._BIG_INDEX_FRAC.function.apply, t_ek._index_frac_plain):
        leaves = [v.double().requires_grad_(True) for v in T(x, q)]
        (fn(*leaves)[1] ** 2).sum().backward()
        grads.append([v.grad for v in leaves])
    for g_fn, g_plain in zip(*grads):
        torch.testing.assert_close(g_fn, g_plain, rtol=1e-12, atol=1e-12)


def test_eligibility_and_geometry_match_jax():
    """R3's eligibility against the JAX package's: the same but between the
    JAX split (65,536, its one-pass kernels' limit) and the port's
    ``K1_MAX_KNOTS`` (81,919, where the card's K1 and R3 cross), where the
    port keeps K1 (ROADMAP Queue 3, route divergences; the values agree:
    ``tests/test_torch_route_rules.py``'s split tests)."""
    for n, dtype, trailing in [(100, np.float32, ()), (100_000, np.float32, ()),
                               (100_000, np.float64, ()), (100_000, np.float32, (2,)),
                               (65_536, np.float32, ()), (65_537, np.float32, ())]:
        x = np.zeros(n, dtype)
        d = np.zeros((n,) + trailing, dtype)
        port, jax_ = t_bk.can_use_big(*T(x, d)), j_bk.can_use_big(*J(x, d))
        if n == 65_537:
            assert jax_ and not port
        else:
            assert port == jax_, (n, dtype, trailing)
    assert t_bk.K1_MAX_KNOTS == 81_919
    assert t_bk.MAX_BIG_KNOTS == j_bk.MAX_BIG_KNOTS
    for n in (65_537, 70_001, 262_144, 1_048_576, 4_000_000, t_bk.MAX_BIG_KNOTS):
        assert t_bk._geometry(n) == j_bk._geometry(n)
    assert t_bk._block_w(t_bk.MAX_BIG_KNOTS) == 128
    big = torch.zeros(t_bk.MAX_BIG_KNOTS)
    assert t_bk.can_use_big(big, big)
    with pytest.raises(ValueError, match="knot axis too long"):
        t_bk._block_w(t_bk.MAX_BIG_KNOTS + 1)


def test_pad_knots_matches_jax():
    x, _, _, _, _ = fixture(n=66_000, nq=16)
    w, _, c1, c2 = t_bk._geometry(x.shape[0])
    got = t_bk._pad_knots(torch.as_tensor(x), w, c1, c2).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_bk._pad_knots(jnp.asarray(x), w, c1, c2)))


def test_plain_refine_matches_jax_refine_kernel_in_interpret_mode():
    """``tests/test_bigknots.py:220-260`` at 512 queries: the JAX Pallas
    refine on its aligned rows against the port's plain version of R3."""
    rng = np.random.default_rng(51)
    n, nq = 66_000, 512
    x = np.linspace(0.0, 1.0, n).astype(np.float32)
    d, a, b = (rng.normal(size=m).astype(np.float32) for m in (n, n - 1, n - 1))
    q = rng.uniform(-0.1, 1.1, nq).astype(np.float32)
    jx, jd, ja, jb, jq = J(x, d, a, b, q)
    w, c, c1, c2 = j_bk._geometry(n)
    kp = j_bk._pad_knots(jx, w, c1, c2)
    block = j_bk._block_of(kp, n, w, c, c1, c2, jq, pallas=False)
    rows = jnp.take(j_bk._pack_rows_aligned(kp, jd, ja, jb, w, c), block, axis=0)
    want = np.asarray(j_bk._refine_and_eval_mosaic(rows, block, jq, n, w, interpret=True))
    got = t_bk._big_eval_plain(*T(x, d, a, b, q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_nonfinite_data_stays_local():
    """One NaN datum: the JAX mask-sum refine NaNs its whole W-knot block
    (the D5 hazard, ``tests/test_bigknots.py:181-217``); the port's R3 route
    reads by index, so only the datum's two intervals go NaN."""
    n = 66_000
    rng = np.random.default_rng(11)
    x = np.linspace(0.0, 1.0, n).astype(np.float32)
    d = rng.normal(size=n).astype(np.float32)
    d[1000] = np.nan
    a, b = (rng.normal(size=n - 1).astype(np.float32) for _ in range(2))
    q_block = np.array([x[995] + 1e-6], np.float32)  # block 62 spans knots 992..1008
    assert np.isnan(np.asarray(j_bk._big_eval_impl(*J(x, d, a, b, q_block), pallas=False)))[0]
    assert np.isfinite(t_bk.big_eval_1d(*T(x, d, a, b, q_block)).numpy()).all()
    itp = interp1d_from_numpy(x, d, a=a, b=b, mode="yes", device="cpu")
    q = np.array([x[995] + 1e-6, x[10] + 1e-6, x[40000] + 1e-6, x[999] + 1e-6,
                  x[1000] + 1e-6, x[1001] + 1e-6], np.float32)
    out = itp(torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(np.isnan(out), [False, False, False, True, True, False])


# -- the public API and the scalar dispatch, against the JAX package's -------------------
def spy(monkeypatch, mod, names, calls):
    for name in names:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n), _f(*a, **k))[1])


@pytest.mark.parametrize("n,route", [(66_000, "big_eval_1d"), (65_536, "fused_eval_1d"),
                                     (2048, "fused_eval_1d")])
def test_cubic_public_api_and_dispatch_match_jax(monkeypatch, n, route):
    """``route`` is the JAX package's; the port's split is the card's
    ``K1_MAX_KNOTS`` (81,919), so at 66,000 knots it keeps K1 where JAX
    takes its long-axis route (ROADMAP Queue 3, route divergences), with the
    same values."""
    x, d, a, b, q = fixture(n=n, nq=512)
    q = q[np.isfinite(q) & (np.abs(q) < 1e30)]
    jitp = j1.Interp1D.new_unchecked(*J(x, d), j_cs.CubicSplineStrategy(*J(a, b), "yes"))
    titp = interp1d_from_numpy(x, d, a=a, b=b, mode="yes", device="cpu")
    jcalls, tcalls = [], []
    spy(monkeypatch, j_pe, ["fused_eval_1d"], jcalls)
    spy(monkeypatch, j_bk, ["big_eval_1d"], jcalls)
    spy(monkeypatch, t_cubic, ["fused_eval_1d", "big_eval_1d"], tcalls)
    want = np.asarray(jitp(jnp.asarray(q)))
    got = titp(torch.as_tensor(q)).numpy()
    port = "big_eval_1d" if t_bk.long_axis(x.shape[0]) else "fused_eval_1d"
    assert jcalls == [route] and tcalls == [port]
    assert (port == route) == (n != 66_000)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_linear_public_api_and_dispatch_match_jax(monkeypatch):
    # past both packages' splits (the JAX package's 65,536, the port's
    # K1_MAX_KNOTS); between them the routes differ, tests/test_torch_route_rules.py
    x, d, _, _, q = fixture(n=90_000, nq=512)
    # not +-1e38: there the JAX XLA lerp (calc_frac) gives -inf where the
    # port's Hermite form with a = b = 0, as K1's, gives NaN
    q = q[np.abs(q) < 1e30]
    jitp = j1.Interp1D.builder(jnp.asarray(d)).x(jnp.asarray(x)).strategy(
        j1.Linear().extrapolate(True)).build()
    titp = t1.Interp1D.builder(d, device="cpu").x(x).strategy(t1.Linear().extrapolate(True)).build()
    jcalls, tcalls = [], []
    spy(monkeypatch, j_bk, ["big_eval_1d"], jcalls)
    spy(monkeypatch, t_linear, ["big_eval_1d", "fused_eval_1d"], tcalls)
    want = np.asarray(jitp(jnp.asarray(q)))
    got = titp(torch.as_tensor(q)).numpy()
    assert jcalls == ["big_eval_1d"] and tcalls == ["big_eval_1d"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    inf = np.array([np.inf, -np.inf], np.float32)
    got_inf = titp(torch.as_tensor(inf)).numpy()
    assert np.isinf(got_inf).all()
    np.testing.assert_array_equal(got_inf, np.asarray(jitp(jnp.asarray(inf))))


def test_float64_scalar_data_keeps_k1():
    x, d, a, b, q = fixture(n=66_000, nq=64)
    titp = interp1d_from_numpy(x.astype(np.float64), d.astype(np.float64),
                               a=a.astype(np.float64), b=b.astype(np.float64), mode="yes",
                               device="cpu")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        spy(mp, t_cubic, ["fused_eval_1d", "big_eval_1d"], calls)
        titp(torch.as_tensor(q.astype(np.float64)))
    assert calls == ["fused_eval_1d"]


def test_big_routes_on_cpu_launch_no_kernel():
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    x, d, a, b, q = fixture(n=66_000, nq=64)
    t_bk.big_eval_1d(*T(x, d, a, b, q))
    t_bk.big_lower_index_frac(*T(x, q))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


def test_wrappers_reject_axes_beyond_max_big_knots(monkeypatch):
    """On the card the wrappers take 2 to MAX_BIG_KNOTS knots, the range
    their plain versions serve."""
    monkeypatch.setattr(t_bk._cuda, "float_operands", lambda name, *t: torch.float32)
    k = torch.zeros(t_bk.MAX_BIG_KNOTS + 1)
    with pytest.raises(ValueError, match="knots must be 1-D"):
        t_bk._launch_index_frac(k, torch.zeros(3))
