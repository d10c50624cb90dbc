"""The PyTorch port's ops against the JAX package, on the CPU.

The same inputs, made from numpy seeds, go through the JAX function and its
counterpart in ``ndarray_interp_tpu_torch``.  On the CPU every kernel wrapper
of the port runs its plain PyTorch version; the JAX side runs its XLA
formulation, or its Pallas kernel in interpret mode.

Tolerances (stated by the matching JAX tests):

* indices: equal.  For a NaN query the JAX Pallas search kernels give 0
  where the XLA formulation and the port give ``n-2``, so index comparisons
  against the Pallas kernels mask the NaN-query rows;
* f32 eval: ``rtol=2e-5, atol=1e-6`` (``test_pallas_eval.py:55-57``: FMA
  contraction differs between backends and far extrapolation amplifies it);
* f32 Thomas: ``rtol=2e-6, atol=1e-6`` (``test_pallas_thomas.py:30``);
* f64: ``rtol=1e-12``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.ops import gather as j_gather
from ndarray_interp_tpu.ops import lerp as j_lerp
from ndarray_interp_tpu.ops import pallas_eval as j_pe
from ndarray_interp_tpu.ops import pallas_tail as j_tail
from ndarray_interp_tpu.ops import pallas_thomas as j_pt
from ndarray_interp_tpu.ops import searchsorted as j_ss
from ndarray_interp_tpu.ops import thomas as j_th
from ndarray_interp_tpu.utils import monotonic as j_mono
from ndarray_interp_tpu_torch.ops import bank_tail as t_tail
from ndarray_interp_tpu_torch.ops import eval_kernels as t_ek
from ndarray_interp_tpu_torch.ops import gather as t_gather
from ndarray_interp_tpu_torch.ops import kernel_wrappers
from ndarray_interp_tpu_torch.ops import lerp as t_lerp
from ndarray_interp_tpu_torch.ops import searchsorted as t_ss
from ndarray_interp_tpu_torch.ops import thomas as t_th
from ndarray_interp_tpu_torch.ops import thomas_kernel as t_tk
from ndarray_interp_tpu_torch.utils import monotonic as t_mono

TOL = {
    np.float32: dict(rtol=2e-5, atol=1e-6),
    np.float64: dict(rtol=1e-12, atol=0.0),
}
THOMAS_TOL = {
    np.float32: dict(rtol=2e-6, atol=1e-6),
    np.float64: dict(rtol=1e-12, atol=0.0),
}


def knots(n, spacing, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if spacing == "linspace":
        kn = np.linspace(0.0, 100.0, n)
    elif spacing == "log":
        kn = np.logspace(0.0, 2.0, n)
    else:
        kn = np.sort(rng.uniform(0, 100, n))
        kn[0], kn[-1] = 0.0, 100.0
    return kn.astype(dtype)


def queries(kn, dtype, seed=0, count=1500):
    """Uniform queries with extrapolation, NaN (at index ``count``), +-inf,
    +-1e38 and up to 97 knots."""
    rng = np.random.default_rng(seed + 1)
    return np.concatenate(
        [
            rng.uniform(-10, 110, count),
            [np.nan, np.inf, -np.inf, 1e38, -1e38],
            kn[: min(97, kn.size)],
        ]
    ).astype(dtype)


def table_case(n, spacing, dtype, seed=0):
    rng = np.random.default_rng(seed + 2)
    kn = knots(n, spacing, dtype, seed)
    data = rng.normal(size=n).astype(dtype)
    a = rng.normal(size=n - 1).astype(dtype)
    b = rng.normal(size=n - 1).astype(dtype)
    return kn, data, a, b, queries(kn, dtype, seed)


def both_nan_close(got, want, **tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_allclose(got[~nan_g], want[~nan_w], **tol)


# -- searchsorted -------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2, 4, 33, 1000])
@pytest.mark.parametrize("spacing", ["linspace", "nonuniform", "log"])
def test_get_lower_index_matches_jax(dtype, n, spacing):
    kn = knots(n, spacing, dtype, seed=n)
    q = queries(kn, dtype, seed=n)
    want = np.asarray(j_ss.get_lower_index(jnp.asarray(kn), jnp.asarray(q)))
    got = t_ss.get_lower_index(torch.as_tensor(kn), torch.as_tensor(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the clamp contract, NaN included: +-inf and NaN clamp like the XLA form
    assert got[1500].item() == n - 2  # NaN
    assert got[1501].item() == n - 2 and got[1502].item() == 0  # +inf, -inf


def test_get_lower_index_any_query_shape():
    kn = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
    q = torch.tensor([[0.05, 0.95], [-1.0, 2.0]], dtype=torch.float64)
    got = t_ss.get_lower_index(kn, q)
    assert got.shape == (2, 2)
    np.testing.assert_array_equal(got.numpy(), [[0, 9], [0, 9]])
    assert t_ss.get_lower_index(kn, torch.tensor(0.35, dtype=torch.float64)).item() == 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_is_in_range_matches_jax(dtype):
    kn = knots(17, "nonuniform", dtype)
    q = queries(kn, dtype)
    want = np.asarray(j_ss.is_in_range(jnp.asarray(kn), jnp.asarray(q)))
    got = t_ss.is_in_range(torch.as_tensor(kn), torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lower_index_fast_on_cpu_is_the_plain_search():
    kn = knots(300, "log", np.float32)
    q = torch.as_tensor(queries(kn, np.float32))
    k = torch.as_tensor(kn)
    before = t_ek.fused_lower_index.launches
    np.testing.assert_array_equal(
        t_ss.lower_index_fast(k, q).numpy(), t_ss.get_lower_index(k, q).numpy()
    )
    assert t_ek.fused_lower_index.launches == before


# -- monotonicity (vector_extensions.rs:317-403) -----------------------------------
MONOTONIC_CASES = [
    [1.1, 2.0, 3.123, 4.5],
    [1.1, 2.0, 3.123, 3.123, 4.5],
    [5.8, 4.123, 3.1, 2.0, 1.0],
    [5.8, 4.123, 3.1, 3.1, 2.0, 1.0],
    [1.1, 2.0, 3.123, 3.120, 4.5],
    [1, 2, 3, 4, 5],
    [1, 2, 3, 3, 4, 5],
    [5, 4, 3, 3, 2, 1],
    [1, 2, 3, 2, 4, 5],
    [1, 1, 2, 3, 4, 5],
    [1, 1, 1],
    [1],
]


@pytest.mark.parametrize("case", range(len(MONOTONIC_CASES)))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_monotonic_prop_matches_jax(case, as_tensor):
    arr = np.asarray(MONOTONIC_CASES[case])
    want = j_mono.monotonic_prop(arr)
    got = t_mono.monotonic_prop(torch.as_tensor(arr) if as_tensor else arr)
    assert (got.kind.value, got.strict) == (want.kind.value, want.strict)
    assert got.is_strict_rising == want.is_strict_rising


def test_monotonic_prop_rejects_non_1d():
    with pytest.raises(ValueError, match="1-D"):
        t_mono.monotonic_prop(torch.zeros((2, 2)))


# -- lerp ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_calc_frac_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x1, y1, y2 = (rng.normal(size=64).astype(dtype) for _ in range(3))
    x2 = (x1 + rng.uniform(0.1, 2.0, 64)).astype(dtype)
    x = rng.uniform(-3, 3, 64).astype(dtype)
    want = np.asarray(j_lerp.calc_frac(*(jnp.asarray(v) for v in (x1, y1, x2, y2, x))))
    got = t_lerp.calc_frac(*(torch.as_tensor(v) for v in (x1, y1, x2, y2, x)))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_calc_frac_integers_truncate_like_c(dtype):
    # (y2 - y1) / (x2 - x1) truncates toward zero: -7 / 2 -> -3, 7 / 2 -> 3
    x1 = np.array([0, 0, 1, -4], dtype)
    y1 = np.array([0, 0, 5, 3], dtype)
    x2 = np.array([2, 2, 4, -1], dtype)
    y2 = np.array([-7, 7, -6, -8], dtype)
    x = np.array([1, 3, 2, -2], dtype)
    want = np.asarray(j_lerp.calc_frac(*(jnp.asarray(v) for v in (x1, y1, x2, y2, x))))
    got = t_lerp.calc_frac(*(torch.as_tensor(v) for v in (x1, y1, x2, y2, x)))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:2], [-3, 9])


# -- gather ---------------------------------------------------------------------
def test_gather_rows_matches_jax_take():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(20, 3, 4))
    table[7, 1, 2] = np.nan  # stays in its own row (no one-hot selection)
    idx = rng.integers(0, 20, size=(11,)).astype(np.int32)
    want = np.asarray(
        j_gather.gather_rows(jnp.asarray(table), jnp.asarray(idx), assume_finite=False)
    )
    got = t_gather.gather_rows(torch.as_tensor(table), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)


# -- Thomas (K4's plain version and wrapper) -------------------------------------
def system(n, bank, per_column, dtype, seed=None):
    rng = np.random.default_rng(seed if seed is not None else n)
    shape = (n, bank) if per_column else (n,)
    dx = rng.uniform(0.5, 2.0, shape)
    up = np.roll(dx, 1, axis=0)
    mid = 2.2 * (dx + up)
    rhs = rng.normal(size=(n, bank) if bank else (n,))
    return [np.asarray(v, dtype) for v in (up, mid, dx, rhs)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "n,bank,per_column",
    [(1, 3, False), (2, 0, False), (8, 4, False), (130, 16, False), (64, 5, True)],
)
def test_thomas_matches_jax_scan(dtype, n, bank, per_column):
    args = system(n, bank, per_column, dtype)
    want = np.asarray(j_th.thomas_solve(*(jnp.asarray(v) for v in args)))
    got = t_th.thomas_solve(*(torch.as_tensor(v) for v in args))
    assert got.shape == want.shape and got.dtype == torch.as_tensor(args[3]).dtype
    np.testing.assert_allclose(got.numpy(), want, **THOMAS_TOL[dtype])


@pytest.mark.parametrize("n,bank", [(8, 4), (33, 16), (128, 8)])
def test_thomas_matches_pallas_kernel(n, bank):
    args = system(n, bank, False, np.float32)
    want = np.asarray(j_pt._thomas_pallas_impl(*(jnp.asarray(v) for v in args), interpret=True))
    got = t_tk.thomas_solve_fast(*(torch.as_tensor(v) for v in args))
    np.testing.assert_allclose(got.numpy(), want, **THOMAS_TOL[np.float32])


@pytest.mark.parametrize("n,bank", [(8, 4), (64, 16)])
def test_thomas_matches_pallas_batched_kernel(n, bank):
    args = system(n, bank, True, np.float32)
    want = np.asarray(
        j_pt._thomas_pallas_batched_impl(*(jnp.asarray(v) for v in args), interpret=True)
    )
    got = t_tk.thomas_solve_fast(*(torch.as_tensor(v) for v in args))
    np.testing.assert_allclose(got.numpy(), want, **THOMAS_TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_thomas_shared_chain_once_is_the_plain_loop(dtype):
    """K4's factoring for shared diagonals: the column-independent w, mid'
    chain computed once, then each column's r and back substitution, gives
    the plain loop's bits (the loop broadcasts the same w and mid')."""
    up, mid, low, rhs = (torch.as_tensor(v) for v in system(70, 9, False, dtype))
    n = rhs.shape[0]
    w, m = [None], [mid[0]]
    for i in range(1, n):
        w.append(low[i] / m[i - 1])
        m.append(mid[i] - w[i] * up[i - 1])
    r = [rhs[0]]
    for i in range(1, n):
        r.append(rhs[i] - w[i] * r[i - 1])
    k = [None] * n
    k[n - 1] = r[n - 1] / m[n - 1]
    for i in range(n - 2, -1, -1):
        k[i] = (r[i] - up[i] * k[i + 1]) / m[i]
    assert torch.equal(torch.stack(k), t_th.thomas_solve(up, mid, low, rhs))


@pytest.mark.parametrize("per_column", [False, True])
def test_thomas_wrapper_on_cpu_is_the_plain_loop(per_column):
    args = [torch.as_tensor(v) for v in system(40, 6, per_column, np.float64)]
    before = t_tk.thomas_solve_fast.launches
    got = t_tk.thomas_solve_fast(*args)
    assert torch.equal(got, t_th.thomas_solve(*args))
    assert t_tk.thomas_solve_fast.launches == before


def test_thomas_gradient_matches_jax():
    args = system(24, 3, False, np.float64, seed=9)

    def loss_j(up, mid, low, rhs):
        return jnp.sum(j_th.thomas_solve(up, mid, low, rhs) ** 2)

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in args))
    ts = [torch.as_tensor(v).requires_grad_(True) for v in args]
    (t_tk.thomas_solve_fast(*ts) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)


# -- K1: fused_eval_1d -----------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2, 4, 33, 2048])
@pytest.mark.parametrize("spacing", ["linspace", "nonuniform", "log"])
def test_eval_plain_matches_jax_xla(dtype, n, spacing):
    kn, data, a, b, q = table_case(n, spacing, dtype, seed=n)
    j_tbl = j_pe.make_interval_table(*(jnp.asarray(v) for v in (kn, data, a, b)))
    want = np.asarray(j_pe._eval_xla(jnp.asarray(kn), j_tbl, jnp.asarray(q)))
    t_tbl = t_ek.make_interval_table(*(torch.as_tensor(v) for v in (kn, data, a, b)))
    np.testing.assert_array_equal(t_tbl.numpy(), np.asarray(j_tbl))
    got = t_ek.fused_eval_1d(torch.as_tensor(kn), t_tbl, torch.as_tensor(q))
    both_nan_close(got.numpy(), want, **TOL[dtype])
    assert np.isnan(got[1500].item())  # NaN query -> NaN


@pytest.mark.parametrize("n", [4, 33, 2048])
def test_eval_matches_pallas_kernel(n):
    kn, data, a, b, q = table_case(n, "nonuniform", np.float32, seed=n)
    j_tbl = j_pe.make_interval_table(*(jnp.asarray(v) for v in (kn, data, a, b)))
    want = np.asarray(j_pe._fused_eval_impl(jnp.asarray(kn), j_tbl, jnp.asarray(q), interpret=True))
    t_tbl = t_ek.make_interval_table(*(torch.as_tensor(v) for v in (kn, data, a, b)))
    got = t_ek.fused_eval_1d(torch.as_tensor(kn), t_tbl, torch.as_tensor(q)).numpy()
    both_nan_close(got, want, **TOL[np.float32])


def test_linear_table_inf_extrapolates_like_jax():
    # a = b = 0: +-inf queries extrapolate to +-inf (calc_frac semantics)
    kn = np.linspace(0.0, 10.0, 16).astype(np.float32)
    data = np.linspace(0.0, 30.0, 16).astype(np.float32)
    q = np.array([np.inf, -np.inf, 5.0], np.float32)
    j_tbl = j_pe.make_interval_table(jnp.asarray(kn), jnp.asarray(data))
    want = np.asarray(j_pe._fused_eval_impl(jnp.asarray(kn), j_tbl, jnp.asarray(q), interpret=True))
    t_tbl = t_ek.make_interval_table(torch.as_tensor(kn), torch.as_tensor(data))
    got = t_ek.fused_eval_1d(torch.as_tensor(kn), t_tbl, torch.as_tensor(q)).numpy()
    assert got[0] == np.inf and got[1] == -np.inf
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eval_gradient_matches_jax(dtype):
    kn, data, a, b, _ = table_case(32, "linspace", dtype)
    q = np.linspace(5.0, 95.0, 50).astype(dtype)
    j_tbl = j_pe.make_interval_table(*(jnp.asarray(v) for v in (kn, data, a, b)))
    g_tbl, g_q = jax.grad(
        lambda tbl, q: jnp.sum(j_pe._eval_xla(jnp.asarray(kn), tbl, q) ** 2), argnums=(0, 1)
    )(j_tbl, jnp.asarray(q))
    t_tbl = t_ek.make_interval_table(*(torch.as_tensor(v) for v in (kn, data, a, b)))
    t_tbl.requires_grad_(True)
    t_q = torch.as_tensor(q).requires_grad_(True)
    (t_ek.fused_eval_1d(torch.as_tensor(kn), t_tbl, t_q) ** 2).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == np.float32 else dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_tbl.grad.numpy(), np.asarray(g_tbl), **tol)
    np.testing.assert_allclose(t_q.grad.numpy(), np.asarray(g_q), **tol)


# -- K2: fused_index_frac --------------------------------------------------------
@pytest.mark.parametrize("n", [4, 33, 2048])
def test_index_frac_matches_pallas_kernel(n):
    kn = knots(n, "log", np.float32, seed=n)
    q = queries(kn, np.float32, seed=n)
    j_idx, j_t = j_pe._index_frac_impl(jnp.asarray(kn), jnp.asarray(q), interpret=True)
    idx, t = t_ek.fused_index_frac(torch.as_tensor(kn), torch.as_tensor(q))
    assert idx.dtype == torch.int32
    real = ~np.isnan(q)  # the Pallas kernel gives 0 for a NaN query, the port n-2
    np.testing.assert_array_equal(idx.numpy()[real], np.asarray(j_idx)[real])
    both_nan_close(t.numpy(), np.asarray(j_t), **TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_index_frac_matches_jax_xla_form(dtype):
    kn = knots(257, "nonuniform", dtype)
    q = queries(kn, dtype)
    jk, jq = jnp.asarray(kn), jnp.asarray(q)
    j_idx = j_ss.get_lower_index(jk, jq)
    j_t = (jq - jk[j_idx]) / (jk[j_idx + 1] - jk[j_idx])  # cubic.py frac_default
    idx, t = t_ek.fused_index_frac(torch.as_tensor(kn), torch.as_tensor(q))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    both_nan_close(t.numpy(), np.asarray(j_t), **TOL[dtype])


def test_index_frac_gradient_flows_through_t():
    kn = torch.linspace(0.0, 1.0, 9, dtype=torch.float64).requires_grad_(True)
    q = torch.tensor([0.1, 0.52, 0.99], dtype=torch.float64, requires_grad=True)
    idx, t = t_ek.fused_index_frac(kn, q)
    t.sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), np.full(3, 8.0), rtol=1e-12)
    assert kn.grad is not None and not idx.requires_grad


# -- K3: fused_lower_index -------------------------------------------------------
@pytest.mark.parametrize("n", [4, 33, 512, 2048])
def test_lower_index_matches_pallas_kernel(n):
    kn = knots(n, "nonuniform", np.float32, seed=n)
    q = queries(kn, np.float32, seed=n)
    want = np.asarray(j_pe.fused_lower_index(jnp.asarray(kn), jnp.asarray(q), interpret=True))
    got = t_ek.fused_lower_index(torch.as_tensor(kn), torch.as_tensor(q)).numpy()
    real = ~np.isnan(q)  # NaN query: Pallas 0, XLA and the port n-2
    np.testing.assert_array_equal(got[real], want[real])
    assert got[~real].tolist() == [n - 2]


def test_cpu_wrappers_launch_no_kernel():
    kn, data, a, b, q = table_case(33, "linspace", np.float32)
    k, qq = torch.as_tensor(kn), torch.as_tensor(q)
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    tbl = t_ek.make_interval_table(k, torch.as_tensor(data))
    assert torch.equal(t_ek.fused_eval_1d(k, tbl, qq).isnan(), t_ek._eval_plain(k, tbl, qq).isnan())
    t_ek.fused_index_frac(k, qq)
    t_ek.fused_lower_index(k, qq)
    t_tk.thomas_solve_fast(*(torch.as_tensor(v) for v in system(9, 2, False, np.float32)))
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


# -- bank tail ------------------------------------------------------------------
@pytest.mark.parametrize("bank", [1, 8, 13])
def test_pack_bank_rows_matches_jax(bank):
    rng = np.random.default_rng(bank)
    d2 = rng.normal(size=(12, bank)).astype(np.float32)
    a2, b2 = (rng.normal(size=(11, bank)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_tail.pack_bank_rows(*(jnp.asarray(v) for v in (d2, a2, b2))))
    got = t_tail.pack_bank_rows(*(torch.as_tensor(v) for v in (d2, a2, b2))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gathered_bank_eval_matches_jax(dtype):
    rng = np.random.default_rng(11)
    n, bank = 40, 13
    d2 = rng.normal(size=(n, bank)).astype(dtype)
    a2, b2 = (rng.normal(size=(n - 1, bank)).astype(dtype) for _ in range(2))
    idx = rng.integers(0, n - 1, 300).astype(np.int32)
    t = rng.uniform(-0.5, 1.5, 300).astype(dtype)
    want = np.asarray(j_tail._gathered_impl(*(jnp.asarray(v) for v in (d2, a2, b2, idx, t))))
    got = t_tail.gathered_bank_eval(*(torch.as_tensor(v) for v in (d2, a2, b2, idx, t)))
    assert got.shape == (300, bank)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
