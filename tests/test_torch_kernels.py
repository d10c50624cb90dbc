"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) and ``nvcc``, and
skips without ``torch.cuda``.  Run them on such a machine with::

    NDI_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_kernels.py

(``NDI_TPU_TESTS=1`` keeps ``tests/conftest.py`` from configuring JAX,
which a GPU machine need not have; nothing here imports JAX.)

Tolerance: none.  The kernels are built with ``--fmad=false`` and follow
the plain versions' operation order, so values are held bit for bit (NaN
positions equal) and indices exactly.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def same(got, want):
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    ng, nw = torch.isnan(got), torch.isnan(want)
    return torch.equal(ng, nw) and torch.equal(got[~ng], want[~nw])


def knots(n, dtype, seed):
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(0.5, 1.5, n - 1)
    return (np.concatenate([[0.0], np.cumsum(gaps)]) * (100.0 / gaps.sum())).astype(dtype)


def queries(kn, dtype, seed, count=100_000):
    rng = np.random.default_rng(seed + 1)
    special = [np.nan, np.inf, -np.inf, 1e38, -1e38, 0.0, -0.0, -1e9, 1e9]
    return np.concatenate([rng.uniform(-20, 120, count), kn, special]).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2, 4, 33, 2048, 65536])
def test_search_and_eval_kernels_match_plain(dev, dtype, n):
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops.searchsorted import get_lower_index

    rng = np.random.default_rng(n)
    kn = knots(n, dtype, n)
    k = torch.as_tensor(kn, device=dev)
    q = torch.as_tensor(queries(kn, dtype, n), device=dev)
    d, a, b = (torch.as_tensor(rng.normal(size=m).astype(dtype), device=dev)
               for m in (n, n - 1, n - 1))
    for tbl in (ek.make_interval_table(k, d, a, b), ek.make_interval_table(k, d)):
        assert same(ek.fused_eval_1d(k, tbl, q), ek._eval_plain(k, tbl, q))
    idx, t = ek.fused_index_frac(k, q)
    idx_p, t_p = ek._index_frac_plain(k, q)
    assert same(idx, idx_p) and same(t, t_p)
    assert same(ek.fused_lower_index(k, q), get_lower_index(k, q))
    torch.cuda.synchronize()


# Every branch of K4: n of 1-3 rows, about one chunk (32 rows) and the ring of
# eight chunks (256 rows), not a multiple of either; the resident slice (f32 up to
# 1,440 rows, f64 704: n = 1,000 is resident in f32 and streams in f64) and the
# streaming form (n = 10,000); banks of 1, 31, 33 (a partial block, two blocks)
# and 8,192; shared and per-column diagonals.
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,bank,per_column", [
    (1, 5, False), (3, 1, False), (300, 200, False), (129, 70, True),
    (1, 1, False), (1, 33, True), (2, 31, False), (2, 1, True), (3, 33, False), (3, 31, True),
    (31, 8192, False), (33, 33, True), (255, 31, False), (257, 33, False), (257, 1, True),
    (1000, 31, False), (1000, 33, True), (704, 33, False), (1440, 31, False),
    (10_000, 1, False), (10_000, 33, False), (10_000, 31, True), (513, 8192, False),
    (64, 8192, False), (129, 8192, True),
])
def test_thomas_kernel_matches_plain_loop(dev, dtype, n, bank, per_column):
    from ndarray_interp_tpu_torch.ops.thomas import thomas_solve
    from ndarray_interp_tpu_torch.ops.thomas_kernel import thomas_solve_fast

    rng = np.random.default_rng(n + bank)
    dx = rng.uniform(0.5, 2.0, (n, bank) if per_column else (n,))
    up, low = np.roll(dx, 1, axis=0), dx
    args = [torch.as_tensor(np.asarray(v, dtype), device=dev)
            for v in (up, 2.2 * (dx + up), low, rng.normal(size=(n, bank)))]
    assert same(thomas_solve_fast(*args), thomas_solve(*args))


@pytest.mark.parametrize("kid", ["K1", "K2", "K4"])
def test_kernel_gradients_match_autograd_of_plain(dev, kid):
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import thomas_kernel as tk
    from ndarray_interp_tpu_torch.ops.thomas import thomas_solve

    rng = np.random.default_rng(7)
    kn = torch.as_tensor(knots(64, np.float64, 7), device=dev)
    q = torch.as_tensor(rng.uniform(-5.0, 105.0, 500), device=dev)
    if kid == "K1":
        d, a, b = (torch.as_tensor(rng.normal(size=m), device=dev) for m in (64, 63, 63))
        args = (kn, ek.make_interval_table(kn, d, a, b), q)
        pair = (ek.fused_eval_1d, ek._eval_plain)
    elif kid == "K2":
        args = (kn, q)
        pair = (lambda k, x: ek.fused_index_frac(k, x)[1],
                lambda k, x: ek._index_frac_plain(k, x)[1])
    else:
        dx = rng.uniform(0.5, 2.0, 40)
        args = tuple(torch.as_tensor(v, device=dev) for v in
                     (np.roll(dx, 1), 2.2 * (dx + np.roll(dx, 1)), dx, rng.normal(size=(40, 3))))
        pair = (tk.thomas_solve_fast, thomas_solve)
    grads = []
    for fn in pair:
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for g_kernel, g_plain in zip(*grads):
        torch.testing.assert_close(g_kernel, g_plain, rtol=1e-12, atol=1e-12)


def test_wrappers_count_their_launches(dev):
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    k = torch.linspace(0.0, 1.0, 9, device=dev)
    q = torch.rand(100, device=dev)
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    ek.fused_lower_index(k, q)
    ek.fused_lower_index(k.cpu(), q.cpu())  # the plain version: no launch
    after = {kid: w.launches for kid, w in kernel_wrappers().items()}
    assert after["K3"] == before["K3"] + 1
    assert all(after[kid] == before[kid] for kid in ("K1", "K2", "K4"))


def test_integer_tensors_raise_naming_the_dtype(dev):
    from ndarray_interp_tpu_torch.interp1d import Interp1D
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops.thomas_kernel import thomas_solve_fast

    k = torch.arange(8, device=dev)
    with pytest.raises(TypeError, match="torch.int64"):
        ek.fused_lower_index(k, k)
    with pytest.raises(TypeError, match="torch.int32"):
        thomas_solve_fast(*(torch.ones(4, dtype=torch.int32, device=dev) for _ in range(4)))
    itp = Interp1D.builder(np.arange(6), device=dev).build()  # integer Linear
    with pytest.raises(TypeError, match="torch.int64"):
        itp(torch.tensor([1, 2], device=dev))


def test_mixed_devices_raise(dev):
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    with pytest.raises(ValueError, match="tensors on"):
        ek.fused_lower_index(torch.linspace(0, 1, 5), torch.rand(3, device=dev))


def test_interp1d_on_cuda_goes_through_every_kernel(dev):
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    rng = np.random.default_rng(3)
    x = np.linspace(0.0, 1.0, 50).astype(np.float32)
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    spline = CubicSpline().extrapolate(True)
    scalar = Interp1D.builder(rng.normal(size=50).astype(np.float32), device=dev).x(x)
    bank = Interp1D.builder(rng.normal(size=(50, 6)).astype(np.float32), device=dev).x(x)
    q = torch.rand(1000, device=dev)
    outs = [
        scalar.strategy(spline).build()(q),  # K4 build, K1 eval
        bank.strategy(spline).build()(q),  # K4 build, K2 eval
        Interp1D.builder(bank._data).x(bank._x).build()(q),  # Linear bank: K3
    ]
    torch.cuda.synchronize()
    after = {kid: w.launches for kid, w in kernel_wrappers().items()}
    assert all(after[kid] > before[kid] for kid in ("K1", "K2", "K3", "K4"))
    assert all(bool(torch.isfinite(o).all()) for o in outs)

    cpu = [
        Interp1D.builder(t.detach().cpu()).x(x).strategy(s).build()(q.cpu())
        for t, s in ((scalar._data, spline), (bank._data, spline))
    ]
    for got, want in zip(outs, cpu):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-6, atol=1e-6)


# -- the double-float kernels K6-K9 ----------------------------------------------------
def pair(v, dev):
    from ndarray_interp_tpu_torch.ops.df import df_from_f64

    return df_from_f64(torch.as_tensor(np.asarray(v, np.float64), device=dev))


def df_knots(n, spacing, seed):
    rng = np.random.default_rng(seed)
    if spacing == "collide":  # distinct in f64, many equal in f32
        return np.cumsum(rng.uniform(1e-9, 1e-7, n)) + 1.0
    return np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, n - 1))])


def df_queries(kn, seed, count=100_000):
    rng = np.random.default_rng(seed + 1)
    lo, hi = kn[0], kn[-1]
    span = hi - lo
    special = [np.nan, np.inf, -np.inf, 1e38, -1e38, 1e300, -1e300, 0.0, -0.0,
               lo - 1e6 * span, hi + 1e6 * span]
    return np.concatenate([rng.uniform(lo - 0.2 * span, hi + 0.2 * span, count),
                           kn, (kn[:-1] + kn[1:]) / 2, special])


def same_pair(got, want):
    return all(same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("spacing", ["nonuniform", "collide"])
@pytest.mark.parametrize("n", [2, 4, 33, 2048, 65536, 100_000])
def test_df_search_and_eval_kernels_match_plain(dev, n, spacing):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek

    rng = np.random.default_rng(n)
    kn = df_knots(n, spacing, n)
    x, q = pair(kn, dev), pair(df_queries(kn, n), dev)
    d, a, b = (rng.normal(size=m) for m in (n, n - 1, n - 1))
    for dab in ((d, a, b), (2.0 * kn + 1.0, np.zeros(n - 1), np.zeros(n - 1))):
        args = (*x, *(h for v in dab for h in pair(v, dev)), *q)
        assert same_pair(ek.fused_eval_1d_df(*args), ek.eval_xla_df(*args))
    assert same_pair(ek.fused_index_frac_df(*x, *q), ek._df_index_frac_xla(*x, *q))
    torch.cuda.synchronize()


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("n,bank", [(50, 5), (1000, 300), (10_240, 64)])
def test_df_bank_tails_match_plain(dev, n, bank, linear):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek

    rng = np.random.default_rng(bank)
    zero = np.zeros((n - 1, bank))
    d = rng.normal(size=(n, bank))
    a, b = (zero, zero) if linear else (rng.normal(size=(n - 1, bank)) for _ in range(2))
    pairs = [h for v in (d, a, b) for h in pair(v, dev)]
    nq = 50_000
    idx = torch.as_tensor(rng.integers(0, n - 1, nq), dtype=torch.int32, device=dev)
    t = pair(np.r_[rng.uniform(-0.5, 1.5, nq - 6), [np.inf, -np.inf, np.nan, 1e30, 0.0, 1.0]], dev)
    for kernel, plain, pack in (
        (ek.gathered_df_tail, ek._df_tail_plain, ek.pack_bank_rows_df),
        (ek.gathered_f48_tail, ek._f48_tail_plain, ek.pack_bank_rows_f48),
    ):
        packed = pack(*pairs)
        assert same_pair(kernel(packed, idx, *t, bank), plain(packed, idx, *t, bank))
    torch.cuda.synchronize()


def test_df_wrappers_count_launches_and_take_f32_pairs(dev):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    x, q = pair(np.linspace(0.0, 1.0, 9), dev), pair(np.linspace(-0.5, 1.5, 100), dev)
    d = pair(np.ones((9, 3)), dev)
    z = pair(np.zeros((8, 3)), dev)
    packed = ek.pack_bank_rows_df(*d, *z, *z)
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    ek.gathered_bank_eval_df_packed(*x, packed, 3, *q)
    ek.gathered_bank_eval_df_packed(*(v.cpu() for v in x), packed.cpu(), 3,
                                    *(v.cpu() for v in q))  # plain versions: no launch
    after = {kid: w.launches for kid, w in kernel_wrappers().items()}
    assert after["K7"] == before["K7"] + 1 and after["K8"] == before["K8"] + 1
    assert all(after[k] == before[k] for k in after if k not in ("K7", "K8"))
    with pytest.raises(TypeError, match="float32"):
        ek.fused_index_frac_df(*(v.double() for v in x), *(v.double() for v in q))


# -- the 2-D double-float kernels K10-K13 -----------------------------------------------
def cell_tables(nx, ny, r, dev, seed):
    """The four packed 2-D tables of one random grid: bilinear from data
    ``(nx, ny, r)``, bicubic from random cell rows ``(cells, 16 r)``."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek

    rng = np.random.default_rng(seed)
    z = pair(rng.normal(size=(nx, ny, r)), dev)
    rows = pair(rng.normal(size=((nx - 1) * (ny - 1), 16 * r)), dev)
    return {
        "K10": (ek.gathered_bilinear_df_tail, ek._bilinear_df_tail_plain,
                ek.pack_bilinear_rows_df(*z)),
        "K11": (ek.gathered_bilinear_f48_tail, ek._bilinear_f48_tail_plain,
                ek.pack_bilinear_rows_f48(*z)),
        "K12": (ek.gathered_bicubic_df_tail, ek._bicubic_df_tail_plain,
                ek.pack_bicubic_rows_df(*rows, r)),
        "R4c": (ek.gathered_bicubic_df_weight_tail, ek._bicubic_df_weight_tail_plain,
                ek.pack_bicubic_rows_df(*rows, r)),
        "K13": (ek.gathered_bicubic_f48_tail, ek._bicubic_f48_tail_plain,
                ek.pack_bicubic_rows_f48(*rows, r)),
    }


@pytest.mark.parametrize("kid", ["K10", "K11", "K12", "K13", "R4c"])
@pytest.mark.parametrize("nx,ny,r", [(3, 3, 1), (40, 33, 3), (100, 90, 16), (64, 50, 20)])
def test_df2d_cell_tails_match_plain(dev, kid, nx, ny, r):
    kernel, plain, packed = cell_tables(nx, ny, r, dev, nx * ny + r)[kid]
    rng = np.random.default_rng(r)
    nq = 50_000
    xi = torch.as_tensor(rng.integers(0, nx - 1, nq), dtype=torch.int32, device=dev)
    yi = torch.as_tensor(rng.integers(0, ny - 1, nq), dtype=torch.int32, device=dev)
    t = np.r_[rng.uniform(-0.5, 1.5, nq - 6), [np.inf, -np.inf, np.nan, 1e30, 0.0, 1.0]]
    args = (packed, xi, yi, ny, *pair(t, dev), *pair(rng.permutation(t), dev))
    assert same_pair(kernel(*args), plain(*args))
    torch.cuda.synchronize()


def test_df2d_routes_count_launches_and_match_plain(dev):
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.ops import kernel_wrappers
    from ndarray_interp_tpu_torch.serving import DoubleFloatEvaluator2D

    rng = np.random.default_rng(5)
    x, y = np.cumsum(rng.uniform(0.2, 1.0, 30)), np.cumsum(rng.uniform(0.2, 1.0, 20))
    z = rng.normal(size=(30, 20, 3))
    qx = rng.uniform(x[0], x[-1], 5000)
    qy = rng.uniform(y[0], y[-1], 5000)
    for strategy, tails in ((None, ("K10", "K11")), (Bicubic(), ("K12", "K13"))):
        builds = []
        for device in (dev, "cpu"):
            b = Interp2D.builder(z, device=device).x(x).y(y)
            builds.append((b if strategy is None else b.strategy(strategy)).build())
        for grade, kid in zip(("df", "f48"), tails):
            before = {k: w.launches for k, w in kernel_wrappers().items()}
            got = DoubleFloatEvaluator2D(builds[0], grade=grade)(qx, qy)
            torch.cuda.synchronize()
            after = {k: w.launches for k, w in kernel_wrappers().items()}
            assert after[kid] > before[kid] and after["K7"] > before["K7"]
            want = DoubleFloatEvaluator2D(builds[1], grade=grade)(qx, qy)
            # the tables come from builds on two devices (PyTorch's own
            # float64 ops around K4 may round differently from the CPU's)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tail,kid", [("mxu", "K12"), ("nested", "K12"), ("weight", "R4c")])
def test_df_bicubic_route_tails_launch_their_kernels(dev, tail, kid):
    """``gathered_bicubic_eval_df_packed(tail=...)`` launches K7 twice and
    its tail's kernel once, equal bit for bit to the same route on the CPU."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek
    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    rng = np.random.default_rng(9)
    x, y = np.cumsum(rng.uniform(0.2, 1.0, 30)), np.cumsum(rng.uniform(0.2, 1.0, 20))
    rows = rng.normal(size=(29 * 19, 16 * 3))
    qx = np.r_[rng.uniform(x[0] - 1, x[-1] + 1, 4997), [np.nan, np.inf, -np.inf]]
    qy = rng.uniform(y[0] - 1, y[-1] + 1, qx.size)
    outs = []
    for device in (dev, torch.device("cpu")):
        args = (*pair(x, device), *pair(y, device), ek.pack_bicubic_rows_df(*pair(rows, device), 3),
                *pair(qx, device), *pair(qy, device))
        before = {k: w.launches for k, w in kernel_wrappers().items()}
        outs.append([v.cpu() for v in ek.gathered_bicubic_eval_df_packed(*args, r=3, tail=tail)])
        torch.cuda.synchronize()
        after = {k: w.launches for k, w in kernel_wrappers().items()}
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert launched == ({"K7": 2, kid: 1} if device == dev else {})
    assert same_pair(outs[0], outs[1])


# -- K14 (the bicubic node tail) and K15 (the ND tail) ------------------------------
@pytest.mark.parametrize("nx,ny,r", [(3, 3, 1), (40, 33, 3), (100, 90, 16)])
def test_df_bicubic_node_tail_matches_plain(dev, nx, ny, r):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek

    rng = np.random.default_rng(nx + r)
    nodes = rng.normal(size=(nx * ny, 4 * r + 2))
    nodes[:, 4 * r] = np.repeat(np.cumsum(rng.uniform(0.2, 1.0, nx)), ny)
    nodes[:, 4 * r + 1] = np.tile(np.cumsum(rng.uniform(0.2, 1.0, ny)), nx)
    packed = ek.pack_bicubic_nodes_df(*pair(nodes, dev))
    nq = 50_000
    xi = torch.as_tensor(rng.integers(0, nx - 1, nq), dtype=torch.int32, device=dev)
    yi = torch.as_tensor(rng.integers(0, ny - 1, nq), dtype=torch.int32, device=dev)
    t = np.r_[rng.uniform(-0.5, 1.5, nq - 6), [np.inf, -np.inf, np.nan, 1e30, 0.0, 1.0]]
    args = (packed, xi, yi, ny, *pair(t, dev), *pair(rng.permutation(t), dev))
    assert same_pair(ek.gathered_bicubic_node_df_tail(*args), ek._bicubic_node_df_tail_plain(*args))
    torch.cuda.synchronize()


# -- K12, K13 and K14 on queries ordered by cell, and the ordering kernel -------------
ORDER_KINDS = {"K12": lambda ny: (ny - 1, 0), "K13": lambda ny: (ny - 1, 0),
               "R4c": lambda ny: (ny - 1, 0),
               "K14": lambda ny: (ny, -(ny + 1))}
CELL_BLOCKS = {"K10": 8, "K11": 6, "K12": 32, "K13": 24, "R4c": 32}  # a cell row's width in bp


def order_indices(case, nx, ny, nq, rng):
    """Interval indices: uniform, all in one cell, already in cell order, or
    far outside the grid on both sides (the tails clamp them)."""
    if case == "random":
        return rng.integers(0, nx - 1, nq), rng.integers(0, ny - 1, nq)
    if case == "hot":
        return np.full(nq, nx // 2), np.full(nq, ny // 3)
    if case == "sorted":
        xi, yi = rng.integers(0, nx - 1, nq), rng.integers(0, ny - 1, nq)
        order = np.lexsort((yi, xi))
        return xi[order], yi[order]
    return rng.integers(-3 * nx, 3 * nx, nq), rng.integers(-3 * ny, 3 * ny, nq)


def order_fractions(rng, nq):
    t = rng.uniform(-0.5, 1.5, (2, nq))
    special = [np.nan, np.inf, -np.inf, 1e30, 0.0, 1.0]
    k = min(nq, len(special))
    t[0, :k], t[1, nq - k:] = special[:k], special[:k]
    return t


def ordered_case(kind, r, case, nq, dev, seed, nx=90, ny=70):
    """A K10 or K12 (K11, K13: f48) cell table (``r`` channels; ``r = -5``:
    a raw table of bp = 5, which no packer makes) or a K14 node table, and
    the wrapper's arguments."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek

    rng = np.random.default_rng(seed)
    if kind in CELL_BLOCKS:
        cells = (nx - 1) * (ny - 1)
        if r < 0:
            packed = torch.as_tensor(rng.normal(size=(cells, CELL_BLOCKS[kind] * -r)),
                                     dtype=torch.float32, device=dev)
        elif kind in ("K10", "K11"):
            pack = ek.pack_bilinear_rows_df if kind == "K10" else ek.pack_bilinear_rows_f48
            packed = pack(*pair(rng.normal(size=(nx, ny, r)), dev))
        else:
            pack = ek.pack_bicubic_rows_f48 if kind == "K13" else ek.pack_bicubic_rows_df
            packed = pack(*pair(rng.normal(size=(cells, 16 * r)), dev), r)
        xi, yi = order_indices(case, nx, ny, nq, rng)
    else:
        nodes = rng.normal(size=(nx * ny, 4 * r + 2))
        nodes[:, 4 * r] = np.repeat(np.cumsum(rng.uniform(0.2, 1.0, nx)), ny)
        nodes[:, 4 * r + 1] = np.tile(np.cumsum(rng.uniform(0.2, 1.0, ny)), nx)
        packed = ek.pack_bicubic_nodes_df(*pair(nodes, dev))
        xi, yi = order_indices(case, nx - 1, ny - 1, nq, rng)
    t = order_fractions(rng, nq)
    idx = [torch.as_tensor(v, dtype=torch.int32, device=dev) for v in (xi, yi)]
    return (packed, *idx, ny, *pair(t[0], dev), *pair(t[1], dev))


def ordered_tail(kind):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek

    if kind == "K12":
        return (ek.gathered_bicubic_df_tail, ek._bicubic_df_tail_plain,
                "ndi_df_bicubic_tail_ordered")
    if kind == "K13":
        return (ek.gathered_bicubic_f48_tail, ek._bicubic_f48_tail_plain,
                "ndi_f48_bicubic_tail_ordered")
    if kind == "R4c":
        return (ek.gathered_bicubic_df_weight_tail, ek._bicubic_df_weight_tail_plain,
                "ndi_df_bicubic_weight_tail_ordered")
    return (ek.gathered_bicubic_node_df_tail, ek._bicubic_node_df_tail_plain,
            "ndi_df_bicubic_node_tail_ordered")


def force_branch(monkeypatch, ordered):
    """Make the K8, K12, K13, K14, R2c, R2d and R2n wrappers take one branch
    whatever the batch."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as e1
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    monkeypatch.setattr(ek, "_orders", lambda *_: ordered)
    monkeypatch.setattr(e1, "_orders", lambda nq, bank: ordered)
    monkeypatch.setattr(t2, "_orders", lambda *_: ordered)


def launched_by(fn):
    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    before = {k: w.launches for k, w in kernel_wrappers().items()}
    out = fn()
    torch.cuda.synchronize()
    after = {k: w.launches for k, w in kernel_wrappers().items()}
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("kind,r", [("K12", 1), ("K12", 3), ("K12", 16), ("K12", 20),
                                    ("K12", -5), ("K13", 1), ("K13", 16), ("K13", 20),
                                    ("K13", 140), ("K13", -5), ("K14", 1), ("K14", 3),
                                    ("K14", 4), ("K14", 16), ("K14", 20), ("K14", 37),
                                    ("K14", 132), ("R4c", 1), ("R4c", 3), ("R4c", 16),
                                    ("R4c", 20), ("R4c", -5)])
def test_df_bicubic_tails_ordered_and_unordered_match_plain(dev, kind, r, ordered, monkeypatch):
    """Both branches of K12, K13 and K14 at every row width: float4 rows
    (K12 bp of 8, 16, 24; K13 bp of 8, 16, 24, 144; K14 r of 4, 16, 20, 132)
    and one float a lane (K12 and K13 bp = 5, K14 r of 1, 3, 37), a query's
    chunks on one lane each or, past 32 (K13 bp = 144, K14 r = 37, 132),
    looped; NaN and +-inf fractions among the queries.  The ordered branch
    launches the ordering once and the tail once."""
    force_branch(monkeypatch, ordered)
    kernel, plain, _ = ordered_tail(kind)
    args = ordered_case(kind, r, "random", 40_000 if abs(r) < 100 else 8_000, dev, abs(r))
    got, launched = launched_by(lambda: kernel(*args))
    assert launched == ({"ORD": 1, kind: 1} if ordered else {kind: 1})
    assert same_pair(got, plain(*args))


@pytest.mark.parametrize("kind,r", [("K12", 16), ("K12", 3), ("K13", 16), ("K13", -5),
                                    ("K14", 16), ("K14", 3), ("R4c", 16), ("R4c", 3)])
@pytest.mark.parametrize("case", ["hot", "sorted", "out of range"])
def test_df_bicubic_ordered_tails_on_hot_sorted_and_clamped_batches(dev, kind, r, case,
                                                                   monkeypatch):
    force_branch(monkeypatch, True)
    kernel, plain, _ = ordered_tail(kind)
    args = ordered_case(kind, r, case, 300_000, dev, 7 + r)
    got, launched = launched_by(lambda: kernel(*args))
    assert launched == {"ORD": 1, kind: 1}
    assert same_pair(got, plain(*args))


@pytest.mark.parametrize("kind", ["K12", "K13", "K14", "R4c"])
@pytest.mark.parametrize("nq", [0, 1])
@pytest.mark.parametrize("ordered", [True, False])
def test_df_bicubic_tails_take_empty_and_single_query_batches(dev, kind, nq, ordered,
                                                              monkeypatch):
    force_branch(monkeypatch, ordered)
    kernel, plain, _ = ordered_tail(kind)
    args = ordered_case(kind, 3, "random", nq, dev, 11)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert same_pair(got, plain(*args)) and tuple(got[0].shape) == (nq, 3 if kind == "K14" else 8)


@pytest.mark.parametrize("kind,r", [("K12", 16), ("K12", -5), ("K13", 16), ("K13", -5),
                                    ("K14", 16), ("K14", 3), ("R4c", 16), ("R4c", -5)])
def test_df_bicubic_ordered_kernels_match_their_plain_versions_on_records(dev, kind, r):
    """The ordered tails alone, on the records of the plain ordering, against
    the plain tails on the same records."""
    from ndarray_interp_tpu_torch.ops import cell_order as co
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek

    packed, xi, yi, ny, *t = ordered_case(kind, r, "random", 30_000, dev, 13)
    row_step, lo = ORDER_KINDS[kind](ny)
    records = co._order_plain(xi, yi, row_step, lo, packed.shape[0], *t)
    nq, ch = xi.shape[0], packed.shape[1]
    bp = {"K12": ch // 32, "K13": ch // 24, "K14": (ch - 4) // 8, "R4c": ch // 32}[kind]
    out = [torch.empty((nq, bp), dtype=torch.float32, device=dev) for _ in range(2)]
    ek._launch_ordered(ordered_tail(kind)[2], packed, bp, ny, records, *out)
    if kind == "K12":
        want = ek._bicubic_df_tail_ordered_plain(packed, records)
    elif kind == "K13":
        want = ek._bicubic_f48_tail_ordered_plain(packed, records)
    elif kind == "R4c":
        want = ek._bicubic_df_weight_tail_ordered_plain(packed, records)
    else:
        want = ek._bicubic_node_df_tail_ordered_plain(packed, ny, records)
    torch.cuda.synchronize()
    assert same_pair(out, want)


@pytest.mark.parametrize("kind", ["K12", "K14"])
@pytest.mark.parametrize("case", ["random", "hot", "sorted", "out of range"])
@pytest.mark.parametrize("nq", [0, 1, 1000, 1_000_000])
def test_cell_order_matches_plain(dev, kind, case, nq):
    """The counting sort against the stable argsort: the same bucket keys in
    the same order, a permutation of the queries, and each record the row
    value and fraction halves of its query."""
    from ndarray_interp_tpu_torch.ops import cell_order as co

    rng = np.random.default_rng(nq + len(case))
    nx, ny = 512, 512
    row_step, lo = ORDER_KINDS[kind](ny)
    rows = (nx - 1) * (ny - 1) if kind == "K12" else nx * ny
    xi, yi = (torch.as_tensor(v, dtype=torch.int32, device=dev)
              for v in order_indices(case, nx, ny, nq, rng))
    t = order_fractions(rng, nq)
    args = (xi, yi, row_step, lo, rows, *pair(t[0], dev), *pair(t[1], dev))
    v, qid, frac = co.record_fields(co.order_by_cell(*args))
    want_v, _, _ = co.record_fields(co._order_plain(*args))
    torch.cuda.synchronize()
    keys = co.bucket_keys(v.long(), rows)
    assert torch.equal(keys, co.bucket_keys(want_v.long(), rows))
    qid = qid.long()
    assert torch.equal(torch.sort(qid).values, torch.arange(nq, device=dev))
    assert torch.equal(v.long(), co.row_values(xi, yi, row_step, lo, rows)[qid])
    assert same(frac, torch.stack(args[5:], dim=1)[qid])


def test_cell_order_on_a_table_past_2_to_the_22_rows(dev):
    """Buckets of 2^shift rows: the bucket keys sort, the rows within a
    bucket need not."""
    from ndarray_interp_tpu_torch.ops import cell_order as co

    rng = np.random.default_rng(17)
    rows, nq = 3 * 2**22 + 5, 500_000
    xi = torch.as_tensor(rng.integers(0, 3 * 2**11, nq), dtype=torch.int32, device=dev)
    yi = torch.as_tensor(rng.integers(0, 2**11, nq), dtype=torch.int32, device=dev)
    t = pair(rng.uniform(0, 1, nq), dev)
    v, qid, _ = co.record_fields(co.order_by_cell(xi, yi, 2**11, 0, rows, *t, *t))
    want_v, _, _ = co.record_fields(co._order_plain(xi, yi, 2**11, 0, rows, *t, *t))
    torch.cuda.synchronize()
    assert co.bucket_shift(rows) == 2
    keys = co.bucket_keys(v.long(), rows)
    assert torch.equal(keys, co.bucket_keys(want_v.long(), rows))
    qid = qid.long()
    assert torch.equal(torch.sort(qid).values, torch.arange(nq, device=dev))
    assert torch.equal(v.long(), co.row_values(xi, yi, 2**11, 0, rows)[qid])


# -- ORD's two forms at their edges, and every ordered tail on each form -----------------
def order_form(name):
    from ndarray_interp_tpu_torch.ops import cell_order as co

    return {"shared": co.SHARED, "global": co.GLOBAL}[name]


def order_edge_args(case, dims, dev, seed):
    """The ordering's arguments at an edge of its forms: every query in one
    bucket (a table of one row), the shared form's bucket limit and one past
    it, an empty batch, one query, and 2^22 + 1 rows (buckets of two rows);
    1-D keys, or 2-D ones of 64 cells a row of x.  Indices run past both ends
    of the table, which the ordering clamps."""
    from ndarray_interp_tpu_torch.ops import cell_order as co

    limit = co.SHARED_MAX_BUCKETS
    rows, nq = {"one bucket": (1, 5000), "the limit": (limit, 300_000),
                "one past the limit": (limit + 1, 300_000), "empty": (1000, 0),
                "one query": (1000, 1), "2^22 + 1 rows": (2**22 + 1, 300_000)}[case]
    rng = np.random.default_rng(seed)
    th, tl = pair(order_fractions(rng, nq)[0], dev)
    if dims == 1:
        xi = torch.as_tensor(rng.integers(-3, rows + 3, nq), dtype=torch.int32, device=dev)
        return (xi, None, 1, 0, rows, th, tl, None, None)
    xi = torch.as_tensor(rng.integers(-1, rows // 64 + 2, nq), dtype=torch.int32, device=dev)
    yi = torch.as_tensor(rng.integers(0, 64, nq), dtype=torch.int32, device=dev)
    uh, ul = pair(order_fractions(rng, nq)[1], dev)
    return (xi, yi, 64, 0, rows, th, tl, uh, ul)


ORDER_EDGES = [(form, case, dims) for form in ("shared", "global")
               for case in ("one bucket", "the limit", "one past the limit", "empty", "one query",
                            "2^22 + 1 rows")
               for dims in (1, 2) if not (form == "shared" and case == "2^22 + 1 rows")]


@pytest.mark.parametrize("form,case,dims", ORDER_EDGES)
def test_cell_order_forms_at_their_edges(dev, form, case, dims):
    """Each form of the counting sort (the shared one up to 2^21 + 1 buckets'
    worth of shared memory excepted) against the stable argsort: the same
    bucket keys in the same order, a permutation of the queries, each record
    its query's row value and fraction halves, zeros past them; one launch
    counted."""
    from ndarray_interp_tpu_torch.ops import cell_order as co

    args = order_edge_args(case, dims, dev, len(case) + dims)
    xi, yi, row_step, lo, rows, th, tl, uh, ul = args
    nq = xi.shape[0]
    before = co.order_by_cell.launches
    records = co._order_kernel(args, order_form(form))
    want = co._order_plain(*args)
    torch.cuda.synchronize()
    assert co.order_by_cell.launches == before + (nq > 0)
    assert tuple(records.shape) == (nq, 8) and not bool(records[:, 6:].any())
    v, qid, frac = co.record_fields(records)
    keys = co.bucket_keys(v.long(), rows)
    assert torch.equal(keys, co.bucket_keys(co.record_fields(want)[0].long(), rows))
    qid = qid.long()
    assert torch.equal(torch.sort(qid).values, torch.arange(nq, device=dev))
    assert torch.equal(v.long(), co.row_values(xi, yi, row_step, lo, rows)[qid])
    zero = torch.zeros_like(th)
    halves = torch.stack([th, tl, zero, zero] if yi is None else [th, tl, uh, ul], dim=1)
    assert same(frac, halves[qid])


@pytest.mark.parametrize("form", ["shared", "global"])
@pytest.mark.parametrize("kind", ["K8", "K9", "K12", "K13", "K14", "R4c"])
def test_ordered_tails_on_each_form_of_the_ordering(dev, kind, form, monkeypatch):
    """Every tail that orders its batch, on the records of each form of the
    ordering, bit for bit against its plain version: the ordering once, the
    tail once."""
    from ndarray_interp_tpu_torch.ops import cell_order as co
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as e1

    monkeypatch.setattr(co, "_form", lambda buckets: order_form(form))
    force_branch(monkeypatch, True)
    if kind in ("K8", "K9"):
        grade = "df" if kind == "K8" else "f48"
        args = bank_case(64, "random", 200_000, dev, 31, grade=grade)
        kernel, plain = ((e1.gathered_df_tail, e1._df_tail_plain) if kind == "K8" else
                         (e1.gathered_f48_tail, e1._f48_tail_plain))
    else:
        args = ordered_case(kind, 16, "random", 200_000, dev, 31)
        kernel, plain, _ = ordered_tail(kind)
    got, launched = launched_by(lambda: kernel(*args))
    assert launched == {"ORD": 1, kind: 1}
    assert same_pair(got, plain(*args))


# -- K8 on queries ordered by interval, and the float64 store forms of K8 and K13 ------
def bank_case(bank, case, nq, dev, seed, n=700, raw_bp=None, linear=False, grade="df"):
    """A K8 table (``grade="f48"``: a K9 table) of ``n`` knots x ``bank``
    (``raw_bp``: a raw table of ``8·raw_bp`` (K9: ``6·raw_bp``) columns,
    which no packer makes; ``linear``: a = b = 0, so the +-inf fractions
    take the linear escape) and the wrapper's arguments: intervals uniform,
    all in one, already sorted or far outside the table, fractions with NaN,
    +-inf and huge ones among them."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek

    rng = np.random.default_rng(seed)
    if raw_bp:
        blocks = 8 if grade == "df" else 6
        packed = torch.as_tensor(rng.normal(size=(n - 1, blocks * raw_bp)),
                                 dtype=torch.float32, device=dev)
    else:
        zero = np.zeros((n - 1, bank))
        ab = (zero, zero) if linear else (rng.normal(size=(n - 1, bank)) for _ in range(2))
        vals = (rng.normal(size=(n, bank)), *ab)
        pack = ek.pack_bank_rows_df if grade == "df" else ek.pack_bank_rows_f48
        packed = pack(*(h for v in vals for h in pair(v, dev)))
    idx = order_indices(case, n, 2, nq, rng)[0]
    t = order_fractions(rng, nq)[0]
    return (packed, torch.as_tensor(idx, dtype=torch.int32, device=dev), *pair(t, dev), bank)


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("bank,raw_bp,linear", [(1, None, False), (3, None, False),
                                                (8, None, False), (63, None, False),
                                                (64, None, False), (64, None, True),
                                                (256, None, False), (4, 5, False),
                                                (4, 6, False)])
def test_df_bank_tail_ordered_and_unordered_match_plain(dev, bank, raw_bp, linear, ordered, f64,
                                                        monkeypatch):
    """Both branches of K8 in both store forms: float4 rows and outputs
    (banks of 8, 64, 256; looped past 32 chunks at 256), one column a lane
    (banks 1, 3, 63; bank 4 on raw tables of bp 5 and 6, whose blocks are
    not 16-byte aligned), the linear escape at +-inf.  The pair against the
    plain version, the float64 form against ``df_to_f64`` of it; the ordered
    branch launches the ordering once and K8 once."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    force_branch(monkeypatch, ordered)
    args = bank_case(bank, "random", 30_000, dev, bank + (raw_bp or 0), raw_bp=raw_bp,
                     linear=linear)
    kernel = ek._gathered_df_tail_f64 if f64 else ek.gathered_df_tail
    got, launched = launched_by(lambda: kernel(*args))
    assert launched == ({"ORD": 1, "K8": 1} if ordered else {"K8": 1})
    want = ek._df_tail_plain(*args)
    if f64:
        assert got.dtype == torch.float64 and same(got, df_to_f64(*want))
    else:
        assert same_pair(got, want)


@pytest.mark.parametrize("bank", [64, 3])
@pytest.mark.parametrize("case", ["hot", "sorted", "out of range"])
def test_df_bank_tail_ordered_on_hot_sorted_and_clamped_batches(dev, bank, case, monkeypatch):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    force_branch(monkeypatch, True)
    args = bank_case(bank, case, 300_000, dev, 7 + bank)
    want = ek._df_tail_plain(*args)
    assert same_pair(ek.gathered_df_tail(*args), want)
    assert same(ek._gathered_df_tail_f64(*args), df_to_f64(*want))


@pytest.mark.parametrize("nq", [0, 1])
@pytest.mark.parametrize("ordered", [True, False])
def test_df_bank_tail_takes_empty_and_single_query_batches(dev, nq, ordered, monkeypatch):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    force_branch(monkeypatch, ordered)
    args = bank_case(64, "random", nq, dev, 11)
    got, got64 = ek.gathered_df_tail(*args), ek._gathered_df_tail_f64(*args)
    torch.cuda.synchronize()
    want = ek._df_tail_plain(*args)
    assert same_pair(got, want) and tuple(got[0].shape) == (nq, 64)
    assert same(got64, df_to_f64(*want))


@pytest.mark.parametrize("bank,raw_bp", [(64, None), (3, None), (4, 5)])
@pytest.mark.parametrize("f64", [False, True])
def test_df_bank_ordered_kernel_matches_its_plain_version_on_records(dev, bank, raw_bp, f64):
    """The ordered K8 alone, on the records of the plain 1-D ordering, in
    both store forms."""
    from ndarray_interp_tpu_torch.ops import _cuda
    from ndarray_interp_tpu_torch.ops import cell_order as co
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    packed, idx, th, tl, _ = bank_case(bank, "random", 30_000, dev, 13, raw_bp=raw_bp)
    records = co._order_plain(idx, None, 1, 0, packed.shape[0], th, tl, None, None)
    nq, ch = idx.shape[0], packed.shape[1]
    dtypes = (torch.float64,) if f64 else (torch.float32, torch.float32)
    out = [torch.empty((nq, bank), dtype=d, device=dev) for d in dtypes]
    _cuda.launch("ndi_df_bank_tail_ordered", torch.float32, dev, packed, packed.shape[0], ch,
                 ch // 8, bank, records, *out, *((None,) if f64 else ()), nq)
    want = ek._df_tail_ordered_plain(packed, records, bank)
    torch.cuda.synchronize()
    assert same(out[0], df_to_f64(*want)) if f64 else same_pair(out, want)


@pytest.mark.parametrize("case", ["random", "hot", "sorted", "out of range"])
@pytest.mark.parametrize("nq", [0, 1, 1000, 1_000_000])
def test_interval_order_matches_plain(dev, case, nq):
    """The 1-D ordering (no yi, no y halves) against the stable argsort: the
    same keys in the same order, a permutation, each record its query's
    clamped interval and fraction halves, zeros past them."""
    from ndarray_interp_tpu_torch.ops import cell_order as co

    rng = np.random.default_rng(nq + len(case) + 1)
    rows = 10_239
    idx = torch.as_tensor(order_indices(case, rows + 1, 2, nq, rng)[0], dtype=torch.int32,
                          device=dev)
    th, tl = pair(order_fractions(rng, nq)[0], dev)
    records = co.order_by_interval(idx, rows, th, tl)
    want = co._order_plain(idx, None, 1, 0, rows, th, tl, None, None)
    torch.cuda.synchronize()
    v, qid, frac = co.record_fields(records)
    assert torch.equal(v, co.record_fields(want)[0])  # one key a row: the same order
    qid = qid.long()
    assert torch.equal(torch.sort(qid).values, torch.arange(nq, device=dev))
    assert torch.equal(v.long(), co.row_values(idx, None, 1, 0, rows)[qid])
    assert same(frac[:, :2], torch.stack([th, tl], dim=1)[qid])
    assert not bool(records[:, 4:].any())


# -- K9 on queries ordered by interval, in both store forms --------------------------------
def misaligned(t):
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


def f48_tail_and_plain(f64):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    if f64:
        return ek._gathered_f48_tail_f64, lambda *a: df_to_f64(*ek._f48_tail_plain(*a))
    return ek.gathered_f48_tail, ek._f48_tail_plain


def same_result(got, want):
    return same(got, want) if isinstance(want, torch.Tensor) else same_pair(got, want)


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("bank,raw_bp,linear,shifted", [
    (8, None, False, False), (63, None, False, False), (64, None, False, False),
    (64, None, True, False), (256, None, False, False), (64, None, False, True),
    (3, None, False, False), (4, 5, False, False)])
def test_f48_bank_tail_ordered_and_unordered_match_plain(dev, bank, raw_bp, linear, shifted,
                                                         ordered, f64, monkeypatch):
    """Both branches of K9 in both store forms: float4 rows and outputs
    (banks 8, 64, 256; looped past 32 chunks at 256), one column a lane
    (banks 3, 63; bank 4 on a raw table of bp 5, whose blocks are not 16-byte
    aligned), the linear escape at +-inf, NaN fractions, and a table that
    starts 4 bytes past a 16-byte boundary (the ordered branch reads a
    copy).  The pair against the plain version, the float64 form against
    ``df_to_f64`` of it; the ordered branch launches the ordering once and
    K9 once."""
    force_branch(monkeypatch, ordered)
    args = bank_case(bank, "random", 30_000, dev, 40 + bank + (raw_bp or 0), raw_bp=raw_bp,
                     linear=linear, grade="f48")
    if shifted:
        args = (misaligned(args[0]), *args[1:])
    kernel, plain = f48_tail_and_plain(f64)
    got, launched = launched_by(lambda: kernel(*args))
    assert launched == ({"ORD": 1, "K9": 1} if ordered else {"K9": 1})
    want = plain(*args)
    assert isinstance(got, torch.Tensor) == f64 and same_result(got, want)


@pytest.mark.parametrize("bank", [64, 3])
@pytest.mark.parametrize("case", ["hot", "sorted", "out of range"])
def test_f48_bank_tail_ordered_on_hot_sorted_and_clamped_batches(dev, bank, case, monkeypatch):
    force_branch(monkeypatch, True)
    args = bank_case(bank, case, 300_000, dev, 17 + bank, grade="f48")
    for f64 in (False, True):
        kernel, plain = f48_tail_and_plain(f64)
        assert same_result(kernel(*args), plain(*args))


@pytest.mark.parametrize("nq", [0, 1])
@pytest.mark.parametrize("ordered", [True, False])
def test_f48_bank_tail_takes_empty_and_single_query_batches(dev, nq, ordered, monkeypatch):
    force_branch(monkeypatch, ordered)
    args = bank_case(64, "random", nq, dev, 19, grade="f48")
    for f64 in (False, True):
        kernel, plain = f48_tail_and_plain(f64)
        got = kernel(*args)
        torch.cuda.synchronize()
        assert same_result(got, plain(*args))
        assert tuple((got if f64 else got[0]).shape) == (nq, 64)


@pytest.mark.parametrize("bank,raw_bp", [(64, None), (3, None), (4, 5)])
@pytest.mark.parametrize("f64", [False, True])
def test_f48_bank_ordered_kernel_matches_its_plain_version_on_records(dev, bank, raw_bp, f64):
    """The ordered K9 alone, on the records of the plain 1-D ordering, in
    both store forms, against ``_f48_tail_ordered_plain``."""
    from ndarray_interp_tpu_torch.ops import _cuda
    from ndarray_interp_tpu_torch.ops import cell_order as co
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    packed, idx, th, tl, _ = bank_case(bank, "random", 30_000, dev, 23, raw_bp=raw_bp,
                                       grade="f48")
    records = co._order_plain(idx, None, 1, 0, packed.shape[0], th, tl, None, None)
    nq, ch = idx.shape[0], packed.shape[1]
    dtypes = (torch.float64,) if f64 else (torch.float32, torch.float32)
    out = [torch.empty((nq, bank), dtype=d, device=dev) for d in dtypes]
    _cuda.launch("ndi_f48_bank_tail_ordered", torch.float32, dev, packed, packed.shape[0], ch,
                 ch // 6, bank, records, *out, *((None,) if f64 else ()), nq)
    want = ek._f48_tail_ordered_plain(packed, records, bank)
    torch.cuda.synchronize()
    assert same(out[0], df_to_f64(*want)) if f64 else same_pair(out, want)


def test_f48_evaluator_takes_k9s_float64_form_without_recombining(dev, monkeypatch):
    """``DoubleFloatEvaluator(grade="f48")`` at a batch the wrapper orders
    (2^17 queries, bank 64) launches K7, the ordering and K9 once each, and
    never recombines a pair itself (``serving.df_to_f64`` is not called):
    bit for bit ``df_to_f64`` of the pair route."""
    from ndarray_interp_tpu_torch import serving
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    rng = np.random.default_rng(37)
    x = np.cumsum(rng.uniform(0.2, 1.0, 500))
    itp = Interp1D.builder(rng.normal(size=(500, 64)), device=dev).x(x).strategy(
        CubicSpline().extrapolate(True)).build()
    ev = serving.DoubleFloatEvaluator(itp, grade="f48")
    nq = 1 << 17
    assert ek._orders(nq, 64)
    qd = torch.as_tensor(rng.uniform(x[0] - 1, x[-1] + 1, nq), device=dev)
    recombined = []
    monkeypatch.setattr(serving, "df_to_f64", lambda *a: recombined.append(a) or df_to_f64(*a))
    got, launched = launched_by(lambda: ev(qd))
    assert launched == {"K7": 1, "ORD": 1, "K9": 1} and not recombined
    want = df_to_f64(*ek.gathered_bank_eval_f48_packed(*ev._run.args, *df_from_f64(qd)))
    assert got.dtype == torch.float64 and same(got, want)


# -- K7 at the paths' knot counts, staged whole or as leaders -------------------------------
@pytest.mark.parametrize("shared", [None, 1, 7, 63])
@pytest.mark.parametrize("spacing", ["nonuniform", "collide"])
@pytest.mark.parametrize("n", [64, 512, 10_240, 70_001])
def test_df_index_frac_matches_plain_at_path_knot_counts(dev, n, spacing, shared, monkeypatch):
    """K7 at the N-D (64), 2-D (512), serving (10,240) and a long (70,001)
    axis, knots that collide in float32 or not, queries with NaN, +-inf,
    +-1e38, +-1e300, the knots and the midpoints: bit for bit the plain
    version, whether the knots are staged whole (the default budget; a
    breadth-first tree padded with +inf), as at most 7 or 63 leaders (every
    w-th knot) with the search ending on the global pairs, or as one leader
    (budget 1: every level global)."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek

    if shared is not None:
        monkeypatch.setattr(ek, "_K7_SHARED_KNOTS", shared)
    kn = df_knots(n, spacing, n + len(spacing))
    x = pair(kn, dev)
    q = pair(df_queries(kn, n), dev)
    got, launched = launched_by(lambda: ek.fused_index_frac_df(*x, *q))
    assert launched == {"K7": 1}
    assert same_pair(got, ek._df_index_frac_xla(*x, *q))


@pytest.mark.parametrize("r", [16, 3, 140, -5])
@pytest.mark.parametrize("ordered", [True, False])
def test_f48_bicubic_tail_f64_form_matches_the_recombined_pair(dev, r, ordered, monkeypatch):
    """K13's float64 store form on both branches, float4 rows (bp 16, 8,
    144) and one float a lane (a raw table of bp 5): bit for bit
    ``df_to_f64`` of the plain version's pair, one launch of K13 (and of the
    ordering on the ordered branch)."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    force_branch(monkeypatch, ordered)
    args = ordered_case("K13", r, "random", 40_000 if abs(r) < 100 else 8_000, dev, 20 + abs(r))
    got, launched = launched_by(lambda: ek._gathered_bicubic_f48_tail_f64(*args))
    assert launched == ({"ORD": 1, "K13": 1} if ordered else {"K13": 1})
    assert got.dtype == torch.float64 and same(got, df_to_f64(*ek._bicubic_f48_tail_plain(*args)))


@pytest.mark.parametrize("kind", ["K10", "K11"])
@pytest.mark.parametrize("r", [16, 3, 20, -5])
@pytest.mark.parametrize("case", ["random", "hot", "sorted", "out of range"])
def test_bilinear_tails_f64_form_matches_the_recombined_pair(dev, kind, r, case):
    """K10's and K11's float64 store form, float4 rows (bp 16, 8, 24) and
    one float a lane (a raw table of bp 5), on random, hot, sorted and
    clamped batches with NaN and +-inf fractions: bit for bit ``df_to_f64``
    of the plain version's pair, one launch of the tail."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    entry, plain = {"K10": (ek._gathered_bilinear_df_tail_f64, ek._bilinear_df_tail_plain),
                    "K11": (ek._gathered_bilinear_f48_tail_f64, ek._bilinear_f48_tail_plain)}[kind]
    args = ordered_case(kind, r, case, 40_000, dev, 30 + abs(r) + len(case))
    got, launched = launched_by(lambda: entry(*args))
    assert launched == {kind: 1}
    assert got.dtype == torch.float64 and same(got, df_to_f64(*plain(*args)))


@pytest.mark.parametrize("grade", ["df", "f48"])
def test_bilinear_evaluator2d_on_the_f64_store_form_equals_the_recombined_pair_route(dev, grade):
    """``DoubleFloatEvaluator2D`` on ``Bilinear`` runs K10 (K11) in its
    float64 store form: bit for bit ``df_to_f64`` of the pair route on the
    card."""
    from ndarray_interp_tpu_torch.interp2d import Bilinear, Interp2D
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu_torch.serving import DoubleFloatEvaluator2D

    rng = np.random.default_rng(32)
    x = np.cumsum(rng.uniform(0.2, 1.0, 300))
    y = np.cumsum(rng.uniform(0.2, 1.0, 40))
    itp = Interp2D.builder(rng.normal(size=(300, 40, 5)), device=dev).x(x).y(y).strategy(
        Bilinear().extrapolate(True)).build()
    ev = DoubleFloatEvaluator2D(itp, grade=grade)
    n = 70_000
    qx = torch.as_tensor(rng.uniform(x[0] - 1, x[-1] + 1, n), device=dev)
    qy = torch.as_tensor(rng.uniform(y[0] - 1, y[-1] + 1, n), device=dev)
    kid = "K10" if grade == "df" else "K11"
    got, launched = launched_by(lambda: ev(qx, qy))
    assert launched == {"K7": 2, kid: 1}
    pad = ev._bucket(n) - n
    halves = [h for v, v0 in ((qx, x[0]), (qy, y[0]))
              for h in df_from_f64(torch.cat([v, v.new_full((pad,), v0)]))]
    route = getattr(e2, f"gathered_bilinear_eval_{grade}_packed")
    assert same(got.reshape(n, 5), df_to_f64(*route(*ev._run.args, *halves))[:n])


@pytest.mark.parametrize("ordered", [True, False])
def test_evaluators_on_the_f64_store_forms_equal_the_recombined_pair_routes(dev, ordered,
                                                                            monkeypatch):
    """``DoubleFloatEvaluator(grade="df")`` on bank data and
    ``DoubleFloatEvaluator2D(grade="f48")`` on the Bicubic cell layout run
    K8 and K13 in their float64 store form: bit for bit ``df_to_f64`` of the
    pair routes on the card, without a widening copy of their own."""
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as e1
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu_torch.serving import DoubleFloatEvaluator, DoubleFloatEvaluator2D

    force_branch(monkeypatch, ordered)
    rng = np.random.default_rng(31)
    x = np.cumsum(rng.uniform(0.2, 1.0, 300))
    q = rng.uniform(x[0] - 1, x[-1] + 1, 70_000)
    itp = Interp1D.builder(rng.normal(size=(300, 64)), device=dev).x(x).strategy(
        CubicSpline().extrapolate(True)).build()
    ev = DoubleFloatEvaluator(itp)
    qd = torch.as_tensor(q, device=dev)
    got, launched = launched_by(lambda: ev(qd))
    assert launched == ({"K7": 1, "ORD": 1, "K8": 1} if ordered else {"K7": 1, "K8": 1})
    want = df_to_f64(*e1.gathered_bank_eval_df_packed(*ev._run.args, *df_from_f64(
        torch.cat([qd, qd.new_full((ev._bucket(q.size) - q.size,), x[0])]))))[:q.size]
    assert same(got, want)

    y = np.cumsum(rng.uniform(0.2, 1.0, 40))
    itp2 = Interp2D.builder(rng.normal(size=(300, 40, 5)), device=dev).x(x).y(y).strategy(
        Bicubic().extrapolate(True)).build()
    ev2 = DoubleFloatEvaluator2D(itp2, grade="f48")
    qy = torch.as_tensor(rng.uniform(y[0] - 1, y[-1] + 1, q.size), device=dev)
    got, launched = launched_by(lambda: ev2(qd, qy))
    assert launched == ({"K7": 2, "ORD": 1, "K13": 1} if ordered else {"K7": 2, "K13": 1})
    pad = ev2._bucket(q.size) - q.size
    halves = [h for v, v0 in ((qd, x[0]), (qy, y[0]))
              for h in df_from_f64(torch.cat([v, v.new_full((pad,), v0)]))]
    want = df_to_f64(*e2.gathered_bicubic_eval_f48_packed(*ev2._run.args, *halves, r=5))
    assert same(got.reshape(q.size, 5), want[:q.size])


@pytest.mark.parametrize("grade", ["df", "f48"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("nbasis", [2, 4])
@pytest.mark.parametrize("r", [1, 3, 20])
def test_nd_tail_matches_plain(dev, grade, k, nbasis, r):
    """Every compiled (k, nbasis, grade) on both of the JAX kernel's paths:
    bp = 1 (r = 1: the group kernel at nb >= 32, the row kernel at 4 <= nb <
    32, the element kernel at nb = 2) and bp > 1 (r = 3, and r = 20 padded to
    bp = 24); NaN and +-inf fractions and clamped cells among the queries."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as ek

    rng = np.random.default_rng(100 * k + 10 * nbasis + r)
    nb = nbasis**k
    cells = [6, 5, 4, 3, 2, 2][:k] if nb < 1024 else [2] * k
    rows = rng.normal(size=(int(np.prod(cells)), nb * r))
    packed = getattr(ek, f"pack_rows_nd_{grade}")(*pair(rows, dev), nb, r)
    nq = min(20_000, 2**22 // (nb * ek._nd_bp(r)))  # the plain version holds (nq, nb, bp)
    idx = np.stack([rng.integers(0, c, nq) for c in cells])
    idx[:, :2] = -3  # cells the clamp moves: before the first, after the last
    idx[:, 2:4] = np.array(cells)[:, None] + 2
    idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    t = np.r_[rng.uniform(-0.5, 1.5, k * nq - 6), [np.inf, -np.inf, np.nan, 1e30, 0.0, 1.0]]
    th, tl = (v.reshape(k, nq) for v in pair(rng.permutation(t), dev))
    cstrides = [int(np.prod(cells[d + 1:])) for d in range(k)]
    kernel = {"df": ek.nd_df_tail, "f48": ek.nd_f48_tail}[grade]
    plain = {"df": ek._nd_df_tail_plain, "f48": ek._nd_f48_tail_plain}[grade]
    args = (packed, idx, th, tl, cstrides, nbasis)
    assert same_pair(kernel(*args), plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("grade", ["df", "f48"])
def test_nd_tail_reads_a_misaligned_table(dev, grade):
    """A table view that starts 4 bytes into its storage: the wrapper copies
    it to a 16-byte boundary for the kernel's vector loads."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as ek

    rng = np.random.default_rng(5)
    cells, nb = [7, 6, 5], 64
    rows = rng.normal(size=(int(np.prod(cells)), nb))
    packed = getattr(ek, f"pack_rows_nd_{grade}")(*pair(rows, dev), nb, 1)
    flat = torch.empty(packed.numel() + 1, device=dev)
    view = flat[1:].view(packed.shape)
    view.copy_(packed)
    assert view.data_ptr() % 16
    nq = 5000
    idx = torch.as_tensor(np.stack([rng.integers(0, c, nq) for c in cells]), dtype=torch.int32,
                          device=dev)
    th, tl = (v.reshape(3, nq) for v in pair(rng.uniform(0, 1, 3 * nq), dev))
    args = (view, idx, th, tl, [30, 5, 1], 4)
    kernel = {"df": ek.nd_df_tail, "f48": ek.nd_f48_tail}[grade]
    plain = {"df": ek._nd_df_tail_plain, "f48": ek._nd_f48_tail_plain}[grade]
    assert same_pair(kernel(*args), plain(*args))


def test_nd_tail_raises_above_its_axis_limit(dev):
    from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as ek

    k = ek.MAX_K + 1
    packed = torch.zeros((1, 2 * 2**k), device=dev)
    idx = torch.zeros((k, 4), dtype=torch.int32, device=dev)
    t = torch.zeros((k, 4), device=dev)
    with pytest.raises(ValueError, match="axes"):
        ek.nd_df_tail(packed, idx, t, t, [1] * k, 2)


def test_nd_and_node_routes_count_launches_and_match_plain(dev, monkeypatch):
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.interpnd import InterpND
    from ndarray_interp_tpu_torch import config as tconfig
    from ndarray_interp_tpu_torch.ops import kernel_wrappers
    from ndarray_interp_tpu_torch.serving import DoubleFloatEvaluator2D, DoubleFloatEvaluatorND

    rng = np.random.default_rng(9)
    axes = [np.cumsum(rng.uniform(0.2, 1.0, n)) for n in (12, 10, 8)]
    data = rng.normal(size=(12, 10, 8, 2))
    qs = [rng.uniform(a[0], a[-1], 5000) for a in axes]
    for method, grade, kid in (("cubic", "df", "K15"), ("cubic", "f48", "K15f48"),
                               ("linear", "df", "K15")):
        builds = [InterpND.builder(data, device=d).points(*axes).method(method).build()
                  for d in (dev, "cpu")]
        before = {k: w.launches for k, w in kernel_wrappers().items()}
        got = DoubleFloatEvaluatorND(builds[0], grade=grade)(*qs)
        torch.cuda.synchronize()
        after = {k: w.launches for k, w in kernel_wrappers().items()}
        assert after[kid] > before[kid] and after["K7"] >= before["K7"] + 3
        assert after["K2"] == before["K2"]  # the DF route does not use the f32 search
        want = DoubleFloatEvaluatorND(builds[1], grade=grade)(*qs)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 1)
    builds = [Interp2D.builder(data[:, :, 0], device=d).x(axes[0]).y(axes[1])
              .strategy(Bicubic()).build() for d in (dev, "cpu")]
    assert builds[0].strategy.layout == "node"
    before = kernel_wrappers()["K14"].launches
    got = DoubleFloatEvaluator2D(builds[0])(qs[0], qs[1])
    torch.cuda.synchronize()
    assert kernel_wrappers()["K14"].launches > before
    want = DoubleFloatEvaluator2D(builds[1])(qs[0], qs[1])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


# -- the wide-bank and long-axis kernels K5, R2a, R3, R3idx ----------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,bank,nq", [(16, (300,), 100), (64, (999,), 513), (33, (256,), 8),
                                       (129, (16, 33), 77), (2048, (256,), 4096), (5, (3,), 40)])
def test_banked_eval_kernel_matches_plain(dev, dtype, n, bank, nq):
    from ndarray_interp_tpu_torch.ops import bank_eval as be

    rng = np.random.default_rng(n + nq)
    d, a, b = (torch.as_tensor(rng.normal(size=(m,) + bank).astype(dtype), device=dev)
               for m in (n, n - 1, n - 1))
    d.view(-1)[d[0].numel() + 5] = float("nan")  # one datum: its lane, two intervals
    idx = torch.as_tensor(rng.integers(0, n - 1, nq), dtype=torch.int32, device=dev)
    t = np.r_[rng.uniform(-0.5, 1.5, nq - 3), [np.nan, np.inf, 1e30]][:nq].astype(dtype)
    t = torch.as_tensor(t, device=dev)
    assert same(be.banked_eval(d, a, b, idx, t), be._gather_form(d, a, b, idx, t))
    torch.cuda.synchronize()


# K5's geometry (ops/bank_eval.py _k5_geometry): 16-byte lanes where the bank
# is a multiple of W and the tables are aligned, else a column a lane; a
# block's queries in the wrapper's rounds or in one.  One NaN datum, intervals
# outside the table (clamped), fractions with NaN, +inf and 1e30, and a query
# count that is no multiple of a block's queries.
def k5_case(bank, n, nq, dtype, dev, seed, offset=0):
    rng = np.random.default_rng(seed)

    def table(m):
        buf = torch.empty(m * bank + offset, dtype=torch.float64 if dtype == np.float64
                          else torch.float32, device=dev)
        v = buf[offset:].view(m, bank)
        v.copy_(torch.as_tensor(rng.normal(size=(m, bank)).astype(dtype)))
        return v

    d, a, b = table(n), table(n - 1), table(n - 1)
    d[n // 2, bank // 2] = float("nan")
    idx = torch.as_tensor(rng.integers(-3, n + 3, nq), dtype=torch.int32, device=dev)
    t = np.r_[rng.uniform(-0.5, 1.5, nq - 3), [np.nan, np.inf, 1e30]].astype(dtype)
    return d, a, b, idx, torch.as_tensor(t, device=dev)


def k5_rounds(monkeypatch, be, one_round):
    """Force a block's queries into one round (``chunk`` = its threads'
    queries) or leave the wrapper's chunk."""
    if one_round:
        geometry = be._k5_geometry
        monkeypatch.setattr(be, "_k5_geometry", lambda *a: (lambda g: g._replace(
            chunk=256 // g.lanes))(geometry(*a)))


@pytest.mark.parametrize("one_round", [False, True])
@pytest.mark.parametrize("bank", [1, 3, 8, 33, 64, 1024, 16_384])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_banked_eval_geometry_matches_plain(dev, monkeypatch, dtype, bank, one_round):
    from ndarray_interp_tpu_torch.ops import bank_eval as be

    n, nq = 40, 4099
    args = k5_case(bank, n, nq, dtype, dev, bank)
    wide = 16 // args[0].element_size()
    assert be._k5_geometry(bank, args[0].element_size(), True).w == (
        wide if bank % wide == 0 else 1)
    k5_rounds(monkeypatch, be, one_round)
    got, launched = launched_by(lambda: be.banked_eval(*args))
    assert launched == {"K5": 1}
    assert same(got, be._gather_form(*args))


@pytest.mark.parametrize("one_round", [False, True])
@pytest.mark.parametrize("bank", [4, 8, 64, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_banked_eval_off_alignment_takes_one_column_a_lane(dev, monkeypatch, dtype, bank,
                                                           one_round):
    from ndarray_interp_tpu_torch.ops import bank_eval as be

    n, nq = 33, 1000
    args = k5_case(bank, n, nq, dtype, dev, 3 * bank, offset=1)
    assert not be._aligned(*args[:3])
    assert be._k5_geometry(bank, args[0].element_size(), False).w == 1
    k5_rounds(monkeypatch, be, one_round)
    got, launched = launched_by(lambda: be.banked_eval(*args))
    assert launched == {"K5": 1}
    assert same(got, be._gather_form(*args))


@pytest.mark.parametrize("nq", [0, 1, 31])
def test_banked_eval_takes_small_batches(dev, nq):
    from ndarray_interp_tpu_torch.ops import bank_eval as be

    args = k5_case(64, 20, max(nq, 3), np.float32, dev, nq)
    args = (*args[:3], args[3][:nq], args[4][:nq])
    got = be.banked_eval(*args)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (nq, 64) and same(got, be._gather_form(*args))


def test_banked_eval_refuses_a_geometry_the_tables_do_not_allow(dev, monkeypatch):
    """16-byte lanes on a table off 16-byte alignment raise; nothing runs."""
    from ndarray_interp_tpu_torch.ops import bank_eval as be

    args = k5_case(64, 20, 100, np.float32, dev, 5, offset=1)
    monkeypatch.setattr(be, "_k5_geometry", lambda *_: be.K5Geometry(4, 16, 2, 32))
    with pytest.raises(RuntimeError, match="ndi_banked_eval"):
        be.banked_eval(*args)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bank", [1, 7, 8, 9, 64, 300])
def test_bank_tail_kernel_matches_plain(dev, dtype, bank):
    from ndarray_interp_tpu_torch.ops import bank_tail as bt

    rng = np.random.default_rng(bank)
    n, nq = 500, 20_000
    d, a, b = (torch.as_tensor(rng.normal(size=(m, bank)).astype(dtype), device=dev)
               for m in (n, n - 1, n - 1))
    idx = torch.as_tensor(rng.integers(0, n - 1, nq), dtype=torch.int32, device=dev)
    t = np.r_[rng.uniform(-0.5, 1.5, nq - 4), [np.nan, np.inf, -np.inf, 1e30]].astype(dtype)
    t = torch.as_tensor(t, device=dev)
    packed = bt.pack_bank_rows(d, a, b)
    assert same(bt.banked_hermite_tail(packed, idx, t, bank), bt._tail_plain(packed, idx, t, bank))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2, 100, 65_537, 70_001, 262_144, 1_048_576])
def test_big_kernels_match_plain(dev, dtype, n):
    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(n)
    kn = knots(n, dtype, n)
    k = torch.as_tensor(kn, device=dev)
    q = torch.as_tensor(queries(kn[:: max(1, n // 5000)], dtype, n), device=dev)
    d, a, b = (torch.as_tensor(rng.normal(size=m).astype(dtype), device=dev)
               for m in (n, n - 1, n - 1))
    z = torch.zeros_like(a)
    for aa, bb in ((a, b), (z, z)):
        want = ek._eval_plain(k, ek.make_interval_table(k, d, aa, bb), q)
        assert same(bk.big_eval_1d(k, d, aa, bb, q), want)
    idx, t = bk.big_lower_index_frac(k, q)
    idx_p, t_p = ek._index_frac_plain(k, q)
    assert same(idx, idx_p) and same(t, t_p)
    if n >= 16:  # the JAX geometry's plain versions
        assert same(bk._big_eval_plain(k, d, a, b, q),
                    ek._eval_plain(k, ek.make_interval_table(k, d, a, b), q))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kid", ["K5", "R2a", "R3", "R3idx"])
def test_bank_and_big_gradients_match_autograd_of_plain(dev, kid):
    from ndarray_interp_tpu_torch.ops import bank_eval as be
    from ndarray_interp_tpu_torch.ops import bank_tail as bt
    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(11)
    if kid in ("K5", "R2a"):
        n, bank, nq = 40, 300, 500
        args = tuple(torch.as_tensor(rng.normal(size=s), device=dev)
                     for s in ((n, bank), (n - 1, bank), (n - 1, bank)))
        idx = torch.as_tensor(rng.integers(0, n - 1, nq), dtype=torch.int32, device=dev)
        t = torch.as_tensor(rng.uniform(-0.5, 1.5, nq), device=dev)
        fns = ((be.banked_eval, be._gather_form) if kid == "K5"
               else (bt.gathered_bank_eval, bt._gather_form_2d))
        pair_ = tuple(lambda d, a, b, t_, f=f: f(d, a, b, idx, t_) for f in fns)
        args = (*args, t)
    else:
        n = 70_001
        kn = torch.as_tensor(knots(n, np.float64, 3), device=dev)
        q = torch.as_tensor(rng.uniform(-5.0, 105.0, 2000), device=dev)
        if kid == "R3":
            d, a, b = (torch.as_tensor(rng.normal(size=m), device=dev) for m in (n, n - 1, n - 1))
            args = (kn, d, a, b, q)
            pair_ = (bk.big_eval_1d, lambda k, d_, a_, b_, q_: ek._eval_plain(
                k, ek.make_interval_table(k, d_, a_, b_), q_))
        else:
            args = (kn, q)
            pair_ = (lambda k, q_: bk.big_lower_index_frac(k, q_)[1],
                     lambda k, q_: ek._index_frac_plain(k, q_)[1])
    grads = []
    for fn in pair_:
        leaves = [v.detach().clone().requires_grad_(True) for v in args]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([v.grad for v in leaves])
    for g_kernel, g_plain in zip(*grads):
        torch.testing.assert_close(g_kernel, g_plain, rtol=1e-12, atol=1e-12)


def test_strategy_routes_launch_k5_r2a_r3_r3idx(dev):
    """The cubic dispatch on the card (the rules of ``bank_eval.can_use_banked``
    and ``bigknots.K1_MAX_KNOTS``): K5 for a f32 bank, narrow ones read by
    many queries a knot too, R2a for a f64 bank, R3idx (here with K5) past
    the split, R3 for scalar data there (cubic, Akima and Linear), K1 below
    it; each against the CPU build."""
    from ndarray_interp_tpu_torch.interp1d import Akima, CubicSpline, Interp1D, Linear
    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    rng = np.random.default_rng(21)
    cases = [
        ((64, 300), CubicSpline(), {"K2", "K5"}, 10_000),
        ((3000, 16), CubicSpline(), {"K2", "K5"}, 65_536),
        ((3000, 16, "float64"), CubicSpline(), {"K2", "R2a"}, 65_536),
        ((90_001, 4), CubicSpline(), {"R3idx", "K5"}, 10_000),
        ((90_001,), CubicSpline(), {"R3"}, 10_000),
        ((90_001,), Akima(), {"R3"}, 10_000),
        ((90_001,), Linear(), {"R3"}, 10_000),
        ((70_001,), CubicSpline(), {"K1"}, 10_000),
    ]
    for shape, strat, expect, nq in cases:
        dtype = shape[-1] if isinstance(shape[-1], str) else "float32"
        shape = tuple(v for v in shape if not isinstance(v, str))
        x = np.cumsum(rng.uniform(0.5, 1.5, shape[0])).astype(dtype)
        data = rng.normal(size=shape).astype(dtype)
        q = rng.uniform(x[0] - 1.0, x[-1] + 1.0, nq).astype(dtype)
        strat = strat.extrapolate(True)
        itp = Interp1D.builder(data, device=dev).x(x).strategy(strat).build()
        q_d = torch.as_tensor(q, device=dev)
        before = {k: w.launches for k, w in kernel_wrappers().items()}
        got = itp(q_d)
        torch.cuda.synchronize()
        after = {k: w.launches for k, w in kernel_wrappers().items()}
        launched = {k for k in after if after[k] > before[k]}
        assert launched == expect, (shape, strat, launched)
        cpu = Interp1D.builder(data, device="cpu").x(x).strategy(strat).build()
        want = cpu(torch.as_tensor(q))
        # the builds ran on two devices (K4 against the plain loop, bit-equal;
        # PyTorch's own f32 ops around them may round differently)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5,
                                   atol=1e-5 * float(want.abs().max()))


# -- R2a on 16-byte lanes or one column a lane -----------------------------------------
def tail_case_r2a(bank, case, nq, dtype, dev, seed, n=700):
    """A packed R2a table of ``n - 1`` rows at ``bank`` columns with one NaN
    datum, and intervals (uniform, all in one, sorted, or far outside the
    table: clamped) with fractions that include NaN, +-inf and 1e30."""
    from ndarray_interp_tpu_torch.ops import bank_tail as bt

    rng = np.random.default_rng(seed)
    d, a, b = (rng.normal(size=(m, bank)).astype(dtype) for m in (n, n - 1, n - 1))
    d[n // 2, bank // 2] = np.nan
    packed = bt.pack_bank_rows(*(torch.as_tensor(v, device=dev) for v in (d, a, b)))
    idx = torch.as_tensor(order_indices(case, n, 2, nq, rng)[0], dtype=torch.int32, device=dev)
    t = torch.as_tensor(order_fractions(rng, nq)[0].astype(dtype), device=dev)
    return packed, idx, t, bank


def misaligned_copy(packed):
    """``packed`` copied one element past a 16-byte boundary."""
    buf = torch.empty(packed.numel() + 1, dtype=packed.dtype, device=packed.device)
    shifted = buf[1:].view(packed.shape).copy_(packed)
    assert shifted.data_ptr() % 16
    return shifted


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bank", [1, 2, 7, 8, 64, 130, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bank_tail_matches_plain(dev, dtype, bank, aligned):
    """R2a on 16-byte lanes (f32 4 columns, f64 2; banks that are no
    multiple of them and tables off 16-byte alignment one column a lane):
    bit for bit ``_tail_plain``, a NaN datum only in its intervals' rows;
    one launch."""
    from ndarray_interp_tpu_torch.ops import bank_tail as bt

    packed, idx, t, bank = tail_case_r2a(bank, "random", 30_000, dtype, dev, bank)
    table = packed if aligned else misaligned_copy(packed)
    got, launched = launched_by(lambda: bt.banked_hermite_tail(table, idx, t, bank))
    assert launched == {"R2a": 1}
    assert same(got, bt._tail_plain(packed, idx, t, bank))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["hot", "sorted", "out of range"])
def test_bank_tail_on_hot_sorted_and_clamped_batches(dev, case, dtype):
    from ndarray_interp_tpu_torch.ops import bank_tail as bt

    args = tail_case_r2a(64, case, 300_000, dtype, dev, 17)
    assert same(bt.banked_hermite_tail(*args), bt._tail_plain(*args))


@pytest.mark.parametrize("nq", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bank_tail_takes_empty_and_single_query_batches(dev, dtype, nq):
    from ndarray_interp_tpu_torch.ops import bank_tail as bt

    args = tail_case_r2a(64, "random", nq, dtype, dev, 19)
    got = bt.banked_hermite_tail(*args)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (nq, 64) and same(got, bt._tail_plain(*args))


def test_bank_and_big_wrappers_check_their_inputs(dev):
    from ndarray_interp_tpu_torch.ops import bank_eval as be
    from ndarray_interp_tpu_torch.ops import bank_tail as bt
    from ndarray_interp_tpu_torch.ops import bigknots as bk

    d = torch.zeros((8, 300), device=dev)
    a = torch.zeros((7, 300), device=dev)
    t = torch.zeros(5, device=dev)
    with pytest.raises(TypeError, match="int32"):
        be.banked_eval(d, a, a, torch.zeros(5, dtype=torch.int64, device=dev), t)
    with pytest.raises(ValueError, match="a, b"):
        be.banked_eval(d, d, a, torch.zeros(5, dtype=torch.int32, device=dev), t)
    with pytest.raises(ValueError, match="bp >= bank"):
        bt.banked_hermite_tail(torch.zeros((7, 32), device=dev),
                               torch.zeros(5, dtype=torch.int32, device=dev), t, 9)
    k = torch.linspace(0.0, 1.0, 100, device=dev)
    with pytest.raises(ValueError, match="data must be"):
        bk.big_eval_1d(k, k[:-1], k[:-1], k[:-1], t)
    with pytest.raises(TypeError, match="torch.int64"):
        bk.big_lower_index_frac(torch.arange(100, device=dev), torch.arange(5, device=dev))


# -- K3 on the staged tree, whole or as leaders, and on the global search ---------------
@pytest.mark.parametrize("shared", [None, 1, 2, 7, 63, 40_000])
@pytest.mark.parametrize("n", [2, 3, 33, 2048, 70_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lower_index_kernel_matches_plain_at_every_budget(dev, dtype, n, shared, monkeypatch):
    """K3 at the wrapper's budget (``None``: a 32 KB tree), at one knot
    (every level of the search on the global axis), as leaders (at most 2, 7 or 63 staged knots, the
    search ending on the global axis) and past the largest tree a block
    holds (40,000 knots: capped, the whole axis or leaders), on 0, 1, 2 and
    1,000,000 queries with NaN (``n-2``), +-inf, +-1e38, the knots and far
    extrapolation: index for index ``get_lower_index``."""
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops.searchsorted import get_lower_index

    if shared is not None:
        monkeypatch.setattr(ek, "_K3_TREE_BYTES", (shared + 1) * np.dtype(dtype).itemsize)
    kn = knots(n, dtype, n + 5)
    k = torch.as_tensor(kn, device=dev)
    body = queries(kn, dtype, n, count=1_000_000 - n - 9)
    for q in (body[:0], body[-9:-8], body[-9:-7], body):  # 0, NaN, NaN and +inf, 1M
        q = torch.as_tensor(q, device=dev)
        got, launched = launched_by(lambda: ek.fused_lower_index(k, q))
        assert launched == {"K3": 1}
        assert same(got, get_lower_index(k, q)), (q.numel(), shared)
    assert got[-9].item() == n - 2 and got[-8].item() == n - 2 and got[-7].item() == 0


# -- K2 on the staged tree, whole or as leaders, and its first design ---------------------
@pytest.mark.parametrize("shared", [None, 0, 1, 2, 7, 63, 8191, 40_000])
@pytest.mark.parametrize("n", [2, 3, 64, 256, 512, 10_000, 10_240, 70_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_index_frac_kernel_matches_plain_at_every_budget(dev, dtype, n, shared, monkeypatch):
    """K2 at the wrapper's budget (``None``: its rule, the first design
    below 64 queries a knot), in its first design (0: a
    thread a query on the global search), at one knot (every level of the
    search on the global axis), as leaders (at most 2, 7 or 63 staged
    knots), a 32 KB f32 tree (8,191 knots: the bank's 10,000 and NS2b's
    10,240 as leaders of every second knot) and past the largest tree a
    block holds (40,000: capped), at the paths' knot counts (64 and 256 the
    N-D axes, 512 NS3b's, 10,000 the bank's, 10,240 NS2b's), on 0, 1, 2 and
    1,000,000 queries with NaN (``n-2``, t NaN), +-inf, +-1e38, the knots and
    far extrapolation: idx and t bit for bit ``_index_frac_plain``."""
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    if shared is not None:
        monkeypatch.setattr(ek, "_k2_budget", lambda n, nq, size: shared)
    kn = knots(n, dtype, n + 9)
    k = torch.as_tensor(kn, device=dev)
    body = queries(kn, dtype, n, count=1_000_000 - n - 9)
    for q in (body[:0], body[-9:-8], body[-9:-7], body):  # 0, NaN, NaN and +inf, 1M
        q = torch.as_tensor(q, device=dev)
        got, launched = launched_by(lambda: ek.fused_index_frac(k, q))
        assert launched == {"K2": 1}
        want = ek._index_frac_plain(k, q)
        assert same(got[0], want[0]) and same(got[1], want[1]), (q.numel(), shared)
    idx, t = got
    assert idx[-9].item() == n - 2 and idx[-8].item() == n - 2 and idx[-7].item() == 0
    assert torch.isnan(t[-9]).item()


# -- R3 on the staged leader tree, and its first design -----------------------------------
@pytest.mark.parametrize("shared", [None, 0, 1, 2, 63, 4095, 32_767, 40_000])
@pytest.mark.parametrize("n", [2, 65_537, 262_144, 8_388_480])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_big_eval_kernel_matches_plain_at_every_budget(dev, dtype, n, shared, monkeypatch):
    """R3 at the wrapper's budget (``None``), in its first design (0: 512
    sorted f32 leaders), at one knot (every level of the search on the
    global axis), as leaders of 2, 63 and 4,095 knots (a 32 KB f32 tree),
    32,767 (a 128 KB f32 tree) and past the largest tree a block holds
    (40,000: capped), on 2 knots and the route's 65,537, NS1b's 262,144 and
    ``MAX_BIG_KNOTS`` (8,388,480), on a cubic and a linear table (+-inf), 0,
    1, 2 and 1,000,000 queries with NaN, +-inf, +-1e38, knots and far
    extrapolation: bit for bit ``_big_eval_plain`` and K1's ``_eval_plain``."""
    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    assert n <= bk.MAX_BIG_KNOTS
    if shared is not None:
        monkeypatch.setattr(bk, "_R3_TREE_BYTES", (shared + 1) * np.dtype(dtype).itemsize)
    rng = np.random.default_rng(n + 13)
    kn = knots(n, dtype, n + 11)
    k = torch.as_tensor(kn, device=dev)
    d, a, b = (torch.as_tensor(rng.normal(size=m).astype(dtype), device=dev)
               for m in (n, n - 1, n - 1))
    z = torch.zeros_like(a)
    own = kn[:: max(1, n // 100_000)]
    body = queries(own, dtype, n, count=1_000_000 - own.size - 9)
    for q in (body[:0], body[-9:-8], body[-9:-7], body):  # 0, NaN, NaN and +inf, 1M
        q = torch.as_tensor(q, device=dev)
        for aa, bb in ((a, b), (z, z)):
            got, launched = launched_by(lambda: bk.big_eval_1d(k, d, aa, bb, q))
            assert launched == {"R3": 1}
            assert same(got, bk._big_eval_plain(k, d, aa, bb, q)), (q.numel(), shared)
            assert same(got, ek._eval_plain(k, ek.make_interval_table(k, d, aa, bb), q))
    assert torch.isnan(got[-9]).item() and torch.isinf(got[-8]).item()
    torch.cuda.synchronize()



# -- R3idx on R3's staged leader tree, and its first design --------------------------------
@pytest.mark.parametrize("shared", [None, 0, 1, 2, 63, 4095, 32_767, 40_000])
@pytest.mark.parametrize("n", [2, 65_537, 262_144, 8_388_480])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_big_index_frac_kernel_matches_plain_at_every_budget(dev, dtype, n, shared, monkeypatch):
    """R3idx at the wrapper's budget (``None``: R3's 128 KB tree), in its first design
    (0: 512 sorted f32 leaders), at one knot (every level of the search on
    the global axis), as leaders of 2, 63 and 4,095 knots, 32,767 (a 128 KB
    f32 tree) and past the largest tree a block holds (40,000: capped), on 2
    knots and the route's 65,537, NS1b's 262,144 and ``MAX_BIG_KNOTS``, on
    0, 1, 2 and 1,000,000 queries with NaN (``n-2``, t NaN), +-inf, +-1e38,
    knots and far extrapolation: idx and t bit for bit
    ``_big_index_frac_plain`` and K2's ``_index_frac_plain``."""
    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    if shared is not None:
        monkeypatch.setattr(bk, "_R3_TREE_BYTES", (shared + 1) * np.dtype(dtype).itemsize)
    kn = knots(n, dtype, n + 17)
    k = torch.as_tensor(kn, device=dev)
    own = kn[:: max(1, n // 100_000)]
    body = queries(own, dtype, n + 1, count=1_000_000 - own.size - 9)
    for q in (body[:0], body[-9:-8], body[-9:-7], body):  # 0, NaN, NaN and +inf, 1M
        q = torch.as_tensor(q, device=dev)
        got, launched = launched_by(lambda: bk.big_lower_index_frac(k, q))
        assert launched == {"R3idx": 1}
        for want in (bk._big_index_frac_plain(k, q), ek._index_frac_plain(k, q)):
            assert same(got[0], want[0]) and same(got[1], want[1]), (q.numel(), shared)
    idx, t = got
    assert idx[-9].item() == n - 2 and idx[-8].item() == n - 2 and idx[-7].item() == 0
    assert torch.isnan(t[-9]).item()
    torch.cuda.synchronize()


# -- K6 on K7's tree of widened knots, its rows, both store forms ---------------------------
def df_scalar_case(n, spacing, table, seed, dev, shifted=False):
    """K6's operands as pairs on ``dev``: ``df_knots``, a cubic table or a
    linear one (a = b = 0), ``df_queries``; with ``shifted`` the pairs of
    every other knot not normalised (the hi half one float32 step up, the
    lo half the rest), so the escape's fraction must read the hi halves."""
    from ndarray_interp_tpu_torch.ops.df import df_from_f64

    rng = np.random.default_rng(seed)
    kn = df_knots(n, spacing, seed)
    d = rng.normal(size=n)
    a, b = ((np.zeros(n - 1), np.zeros(n - 1)) if table == "linear" else
            (rng.normal(size=n - 1), rng.normal(size=n - 1)))
    x = pair(kn, dev)
    if shifted:
        xh = x[0].clone()
        xh[1::2] = torch.nextafter(xh[1::2], torch.full_like(xh[1::2], float("inf")))
        x = (xh, (torch.as_tensor(kn, device=dev) - xh.double()).float())
    q = df_queries(kn, seed, count=1_000_000)  # enough a block for 4,096 rows widened
    return (*x, *(h for v in (d, a, b) for h in pair(v, dev)), *pair(q, dev))


@pytest.mark.parametrize("shared", [None, 0, 1, 2, 63, 16_383, 40_000])
@pytest.mark.parametrize("spacing", ["nonuniform", "collide"])
@pytest.mark.parametrize("n", [2, 33, 4096, 20_000])
def test_df_eval_kernel_matches_plain_at_every_budget(dev, n, spacing, shared, monkeypatch):
    """K6 at the wrapper's budget (``None``: K7's, the whole axis up to
    16,383 knots, 20,000 as leaders), in its first design (0: a thread a
    query on the global pairs), at one knot (every level global), as leaders
    (2 and 63 knots), whole (16,383) and capped (40,000), its rows widened
    into shared memory where they fit and each block has as many queries as
    rows (at 4,096 knots the 1M-query batch), else read from the global
    pairs (the 0-, 1- and 2-query batches), on knots that collide in
    float32 or not, cubic and linear tables, pairs normalised or not (every
    other knot's hi half shifted), on 0, 1, 2 and all queries (NaN on index
    0, +-inf, +-1e38, +-1e300, the knots, the midpoints): the pair bit for
    bit ``eval_xla_df``, the float64 store form bit for bit ``df_to_f64``
    of it."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    if shared is not None:
        monkeypatch.setattr(ek, "_K6_SHARED_KNOTS", shared)
    for table, shifted in (("cubic", False), ("linear", False), ("linear", True)):
        *spline, qh, ql = df_scalar_case(n, spacing, table, n + 3, dev, shifted)
        for m in (0, 1, 2, qh.numel()):
            args = (*spline, qh[-m:] if m else qh[:0], ql[-m:] if m else ql[:0])
            got, launched = launched_by(lambda: ek.fused_eval_1d_df(*args))
            assert launched == {"K6": 1}
            want = ek.eval_xla_df(*args)
            assert same_pair(got, want), (table, shifted, m, shared)
            got64, launched = launched_by(lambda: ek._fused_eval_1d_df_f64(*args))
            assert launched == {"K6": 1}
            assert got64.dtype == torch.float64 and same(got64, df_to_f64(*want))
    torch.cuda.synchronize()


def test_scalar_df_evaluator_takes_k6s_float64_form_without_recombining(dev, monkeypatch):
    """The scalar ``DoubleFloatEvaluator`` launches K6 once a bucket and
    never recombines a pair itself (``serving.df_to_f64`` is not called): bit
    for bit ``df_to_f64`` of K6's pair on the same chunk."""
    from ndarray_interp_tpu_torch import serving
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    rng = np.random.default_rng(38)
    x = np.cumsum(rng.uniform(0.1, 1.0, 4096))
    itp = Interp1D.builder(rng.normal(size=4096), device=dev).x(x).strategy(
        CubicSpline().extrapolate(True)).build()
    ev = serving.DoubleFloatEvaluator(itp)
    nq = 1 << 20
    qd = torch.as_tensor(rng.uniform(x[0] - 1, x[-1] + 1, nq), device=dev)
    recombined = []
    monkeypatch.setattr(serving, "df_to_f64", lambda *a: recombined.append(a) or df_to_f64(*a))
    got, launched = launched_by(lambda: ev(qd))
    assert launched == {"K6": 1} and not recombined
    want = df_to_f64(*ek.fused_eval_1d_df(*ev._run.args, *df_from_f64(qd)))
    assert got.dtype == torch.float64 and same(got, want)

# -- K1 on the staged tree, in each row read ----------------------------------------------
@pytest.mark.parametrize("read", [0, 1, 2])
@pytest.mark.parametrize("shared", [None, 1, 2, 7, 63, 40_000])
@pytest.mark.parametrize("n", [2, 3, 33, 2048, 70_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eval_kernel_matches_plain_at_every_budget_and_row_read(dev, dtype, n, shared, read,
                                                                 monkeypatch):
    """K1 at the wrapper's budget (``None``: a 32 KB tree), at one knot
    (every level of the search on the global axis), as leaders and past the
    largest tree a block holds, in each row read (six scalar loads, three
    2-element loads, the rows in shared memory where they fit), on a cubic
    and a linear table, a table of 7 columns off 2-element alignment (the
    scalar loads whatever the read asks), and 0, 1, 2 and 1,000,000 queries
    with NaN, +-inf, +-1e38, the knots and far extrapolation: bit for bit
    ``_eval_plain``."""
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    if shared is not None:
        monkeypatch.setattr(ek, "_K1_TREE_BYTES", (shared + 1) * np.dtype(dtype).itemsize)
    monkeypatch.setattr(ek, "_K1_ROW_READ", {torch.float32: read, torch.float64: read})
    rng = np.random.default_rng(n + 11)
    kn = knots(n, dtype, n + 7)
    k = torch.as_tensor(kn, device=dev)
    d, a, b = (torch.as_tensor(rng.normal(size=m).astype(dtype), device=dev)
               for m in (n, n - 1, n - 1))
    cubic = ek.make_interval_table(k, d, a, b)
    wide = torch.cat([cubic, torch.zeros_like(cubic[:, :1])], 1)
    off = torch.empty(wide.numel() + 1, dtype=k.dtype, device=dev)[1:].view(n - 1, 7)
    off.copy_(wide)
    body = queries(kn, dtype, n, count=1_000_000 - n - 9)
    for q in (body[:0], body[-9:-8], body[-9:-7], body):  # 0, NaN, NaN and +inf, 1M
        q = torch.as_tensor(q, device=dev)
        for tbl in (cubic, ek.make_interval_table(k, d), off):
            got, launched = launched_by(lambda: ek.fused_eval_1d(k, tbl, q))
            assert launched == {"K1": 1}
            assert same(got, ek._eval_plain(k, tbl, q)), (q.numel(), shared, tbl.shape)
    torch.cuda.synchronize()


# -- R1 on two staged trees ----------------------------------------------------------------
@pytest.mark.parametrize("shared", [None, 1, 2, 7, 63, 40_000])
@pytest.mark.parametrize("nx,ny", [(2, 2), (3, 37), (512, 512), (70_001, 33), (33, 70_001)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cell_index_kernel_matches_plain_at_every_budget(dev, dtype, nx, ny, shared, monkeypatch):
    """R1 with each axis on a tree of half the wrapper's budget (``None``),
    at one knot an axis (every level of both searches on the global axes),
    as leaders and past the largest two trees a block holds, on 0, 1, 2 and
    1,000,000 queries with NaN, +-inf, +-1e38, the knots and far
    extrapolation on both axes: the cell and both fractions bit for bit
    ``_cell_index_plain``, the cell K3's and the fractions K2's."""
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    if shared is not None:
        monkeypatch.setattr(ek, "_R1_TREE_BYTES", 2 * (shared + 1) * np.dtype(dtype).itemsize)
    rng = np.random.default_rng(nx + 3 * ny)
    x = torch.as_tensor(knots(nx, dtype, nx), device=dev)
    y = torch.as_tensor(knots(ny, dtype, ny + 1), device=dev)
    bx = queries(x.cpu().numpy(), dtype, nx, count=1_000_000 - nx - 9)
    by = queries(y.cpu().numpy(), dtype, ny, count=1_000_000 - ny - 9)
    by[:-9] = rng.permutation(by[:-9])  # the special values stay last, in step with bx's
    for part in (slice(0), slice(-9, -8), slice(-9, -7), slice(None)):  # 0, NaN, +inf, 1M
        qx, qy = torch.as_tensor(bx[part], device=dev), torch.as_tensor(by[part], device=dev)
        got, launched = launched_by(lambda: ek.fused_cell_index(x, y, qx, qy))
        assert launched == {"R1": 1}
        want = ek._cell_index_plain(x, y, qx, qy)
        assert all(same(g, w) for g, w in zip(got, want)), (qx.numel(), shared)
    cell, tx, ty = got
    assert same(cell, ek.fused_lower_index(x, qx) * (ny - 1) + ek.fused_lower_index(y, qy))
    assert same(tx, ek.fused_index_frac(x, qx)[1]) and same(ty, ek.fused_index_frac(y, qy)[1])
    torch.cuda.synchronize()


# -- the f32/f64 2-D cell route: R1, R2b, R2c, R2d, R2n ---------------------------------
def cell_route_case(nx, ny, r, nq, dtype, dev, seed):
    """Axes, queries (NaN, +-inf, +-1e38, the knots themselves and far
    extrapolation on both axes), the bilinear corner-row table of random
    data and random bicubic cell rows."""
    from ndarray_interp_tpu_torch.models.strategies.bilinear import pack_corner_rows

    rng = np.random.default_rng(seed)
    x, y = knots(nx, dtype, seed), knots(ny, dtype, seed + 1)
    special = [np.nan, np.inf, -np.inf, 1e38, -1e38, 0.0, -0.0, -1e9, 1e9]

    def axis_queries(kn):
        body = rng.uniform(-20.0, 120.0, nq)
        return rng.permutation(np.concatenate([body, kn, special])[:nq]).astype(dtype)

    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    z = T(rng.normal(size=(nx, ny, r)).astype(dtype))
    tables = {
        "grid": z,
        "bilinear": pack_corner_rows(T(x), T(y), z),
        "bicubic": T(rng.normal(size=((nx - 1) * (ny - 1), 16 * r)).astype(dtype)),
    }
    return T(x), T(y), T(axis_queries(x)), T(axis_queries(y)), tables


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r", [1, 5, 16])
@pytest.mark.parametrize("nq", [0, 1, 1000, 2**20 + 1])
def test_cell_route_kernels_match_plain(dev, dtype, r, nq):
    """R1, R2b, R2c, R2d and R2n bit-identical to their plain versions; R1's
    cell is K3's index of each axis and its fractions are K2's."""
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    x, y, qx, qy, tables = cell_route_case(37, 210, r, nq, dtype, dev, 31 * r + nq % 97)
    cell, tx, ty = ek.fused_cell_index(x, y, qx, qy)
    want = ek._cell_index_plain(x, y, qx, qy)
    assert all(same(g, w) for g, w in zip((cell, tx, ty), want))
    assert same(cell, ek.fused_lower_index(x, qx) * (y.shape[0] - 1) + ek.fused_lower_index(y, qy))
    assert same(tx, ek.fused_index_frac(x, qx)[1]) and same(ty, ek.fused_index_frac(y, qy)[1])
    assert same(t2.bilinear_gathered_eval(tables["bilinear"], cell, qx, qy, r),
                t2._bilinear_plain(tables["bilinear"], cell, qx, qy, r))
    for kernel, plain in ((t2.bicubic_gathered_eval, t2._bicubic_weight_plain),
                          (t2.bicubic_tree_tail, t2._bicubic_tree_plain),
                          (t2.bicubic_nested_tail, t2._bicubic_nested_plain)):
        got = kernel(tables["bicubic"], cell, tx, ty, r)
        assert tuple(got.shape) == (nq, r)
        assert same(got, plain(tables["bicubic"], cell, tx, ty, r)), kernel.__name__
    torch.cuda.synchronize()


@pytest.mark.parametrize("kid", ["R1", "R2b", "R2g", "R2c", "R2d", "R2n"])
def test_cell_route_gradients_match_autograd_of_plain(dev, kid):
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    x, y, qx, qy, tables = cell_route_case(20, 15, 3, 500, np.float64, dev, 13)
    qx, qy = qx.nan_to_num(50.0).clamp(-10.0, 110.0), qy.nan_to_num(50.0).clamp(-10.0, 110.0)
    cell, tx, ty = ek._cell_index_plain(x, y, qx, qy)
    if kid == "R1":
        args = (x, y, qx, qy)
        pair_ = (lambda *a: ek.fused_cell_index(*a)[1:], lambda *a: ek._cell_index_plain(*a)[1:])
    elif kid == "R2b":
        args = (tables["bilinear"], qx, qy)
        pair_ = tuple(lambda t, a, b, f=f: f(t, cell, a, b, 3)
                      for f in (t2.bilinear_gathered_eval, t2._bilinear_plain))
    elif kid == "R2g":
        args = (tables["grid"], x, y, qx, qy)
        pair_ = tuple(lambda d, x_, y_, a, b, f=f: f(d, x_, y_, cell, a, b)
                      for f in (t2.bilinear_grid_eval, t2._bilinear_grid_plain))
    else:
        fns = {"R2c": (t2.bicubic_gathered_eval, t2._bicubic_weight_plain),
               "R2d": (t2.bicubic_tree_tail, t2._bicubic_tree_plain),
               "R2n": (t2.bicubic_nested_tail, t2._bicubic_nested_plain)}[kid]
        args = (tables["bicubic"], tx, ty)
        pair_ = tuple(lambda t, a, b, f=f: f(t, cell, a, b, 3) for f in fns)
    grads = []
    for fn in pair_:
        leaves = [v.detach().clone().requires_grad_(True) for v in args]
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        sum(((o * (i + 1.5)) ** 2).sum() for i, o in enumerate(out)).backward()
        grads.append([v.grad for v in leaves])
    for g_kernel, g_plain in zip(*grads):
        torch.testing.assert_close(g_kernel, g_plain, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interp2d_cell_routes_launch_r1_and_a_tail(dev, dtype):
    """``Bilinear`` (packed) and ``Bicubic`` (cell layout; not-a-knot and
    periodic in y) built on the card launch R1 + R2g / R1 + R2n once a call
    and no K2 or K3; each equals the same interpolator run on the CPU, bit
    for bit, and the plain versions of R1 and its tail on the card (R2b's
    on the corner rows for ``Bilinear``)."""
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Bilinear, Interp2D
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import kernel_wrappers
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    rng = np.random.default_rng(17)
    x = np.cumsum(rng.uniform(0.2, 1.0, 40)).astype(dtype)
    y = np.cumsum(rng.uniform(0.2, 1.0, 33)).astype(dtype)
    z = rng.normal(size=(40, 33, 4)).astype(dtype)
    z[:, -1] = z[:, 0]
    qx = rng.uniform(x[0] - 1.0, x[-1] + 1.0, 20_000).astype(dtype)
    qy = rng.uniform(y[0] - 1.0, y[-1] + 1.0, 20_000).astype(dtype)
    qx_d, qy_d = torch.as_tensor(qx, device=dev), torch.as_tensor(qy, device=dev)

    def bilinear_plain(rows, cell, tx, ty, a, b):
        return t2._bilinear_plain(rows, cell, a, b, 4)

    def nested_plain(rows, cell, tx, ty, a, b):
        return t2._bicubic_nested_plain(rows, cell, tx, ty, 4)

    cases = (
        (Bilinear().extrapolate(True), {"R1": 1, "R2g": 1}, bilinear_plain),
        (Bicubic().extrapolate(True), {"R1": 1, "R2n": 1}, nested_plain),
        (Bicubic().boundary("not_a_knot", "periodic").extrapolate(True), {"R1": 1, "R2n": 1},
         nested_plain),
    )
    for strat, expect, tail_plain in cases:
        itp = Interp2D.builder(z, device=dev).x(x).y(y).strategy(strat).build()
        assert getattr(itp.strategy, "layout", "cell") == "cell"
        before = {k: w.launches for k, w in kernel_wrappers().items()}
        got = itp(qx_d, qy_d)
        torch.cuda.synchronize()
        after = {k: w.launches for k, w in kernel_wrappers().items()}
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == expect
        s = itp.strategy
        cpu_strat = type(s).__new__(type(s))
        cpu_strat.__dict__.update(s.__dict__, rows=s.rows.cpu())
        if getattr(s, "grid", None) is not None:
            cpu_strat.grid = s.grid.cpu()
        on_cpu = Interp2D.new_unchecked(itp.x.cpu(), itp.y.cpu(), itp.data.cpu(), cpu_strat)
        assert same(got.cpu(), on_cpu(qx, qy))
        qy_w = qy_d
        if getattr(s, "wraps_y", False):
            qy_w = torch.remainder(qy_d - itp.y[0], itp.y[-1] - itp.y[0]) + itp.y[0]
        cell, tx, ty = ek._cell_index_plain(itp.x, itp.y, qx_d, qy_w)
        assert same(got, tail_plain(s.rows, cell, tx, ty, qx_d, qy_w))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r", [1, 3, 4, 16, 17])
@pytest.mark.parametrize("nq", [0, 1, 1000, 300_001])
def test_grid_tail_matches_both_plain_versions(dev, dtype, r, nq):
    """R2g bit for bit against ``_bilinear_grid_plain`` and against R2b's
    plain version on ``pack_corner_rows`` of the same grid, on R1's cells
    and on cells far outside the grid (clamped alike), 16-byte lanes (r of
    4 and 16; f64 also 2 channels a lane at r = 4, 16) and a channel a lane
    (r of 1, 3, 17, and a grid copied one element off 16-byte alignment);
    R2b's kernel on the corner rows too."""
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    x, y, qx, qy, tables = cell_route_case(37, 210, r, nq, dtype, dev, 7 * r + nq % 89)
    cell = ek.fused_cell_index(x, y, qx, qy)[0]
    grid, rows = tables["grid"], tables["bilinear"]
    rng = np.random.default_rng(r)
    far = torch.as_tensor(rng.integers(-5 * 36 * 209, 5 * 36 * 209, nq), dtype=torch.int32,
                          device=dev)
    buf = torch.empty(grid.numel() + 1, dtype=grid.dtype, device=dev)
    off = buf[1:].view(grid.shape).copy_(grid)
    for c in (cell, far):
        want = t2._bilinear_plain(rows, c, qx, qy, r)
        for g in (grid, off):
            got, launched = launched_by(lambda g=g, c=c: t2.bilinear_grid_eval(g, x, y, c, qx, qy))
            assert launched == {"R2g": 1}
            assert tuple(got.shape) == (nq, r)
            assert same(got, want)
            assert same(got, t2._bilinear_grid_plain(g, x, y, c, qx, qy))
        assert same(t2.bilinear_gathered_eval(rows, c, qx, qy, r), want)


# -- R2c, R2d and R2n in query order and on queries ordered by cell (ORD's flat-cell form)
def bicubic_tail(kid):
    """``(wrapper, plain, plain on ordered records, ordered entry)`` of the
    bicubic cell tail ``kid``: R2c (block-order sum), R2d (halving tree) or
    R2n (nested)."""
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    return {
        "R2c": (t2.bicubic_gathered_eval, t2._bicubic_weight_plain,
                t2._bicubic_weight_ordered_plain, "ndi_bicubic_seq_tail_ordered"),
        "R2d": (t2.bicubic_tree_tail, t2._bicubic_tree_plain, t2._bicubic_tree_ordered_plain,
                "ndi_bicubic_tree_tail_ordered"),
        "R2n": (t2.bicubic_nested_tail, t2._bicubic_nested_plain,
                t2._bicubic_nested_ordered_plain, "ndi_bicubic_nested_tail_ordered"),
    }[kid]


BICUBIC_TAILS = ["R2c", "R2d", "R2n"]


def nested_case(case, nq, dtype, dev, seed, r=16, nx=60, ny=45):
    """A cell table of ``r`` channels and the wrapper's arguments: R1's cells
    of uniform queries, all in one cell, already in cell order, every query
    of a table of one cell, or a table past 2^22 rows (buckets of two rows:
    ``r`` 1); fractions with NaN, +-inf and huge ones."""
    rng = np.random.default_rng(seed)
    if case == "one cell":
        nx = ny = 2
    if case == "shifted":
        nx, ny, r = 2**11 + 2, 2**11 + 3, 1
    cells = (nx - 1) * (ny - 1)
    rows = torch.as_tensor(rng.normal(size=(cells, 16 * r)).astype(dtype), device=dev)
    cell = rng.integers(0, cells, nq)
    if case == "hot":
        cell[:] = cells // 3
    elif case == "sorted":
        cell.sort()
    t = order_fractions(rng, nq).astype(dtype)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return rows, T(cell.astype(np.int32)), T(t[0]), T(t[1]), r


NESTED_CASES = ["random", "hot", "sorted", "one cell", "shifted"]


@pytest.mark.parametrize("kid", BICUBIC_TAILS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case,form", [(c, f) for c in NESTED_CASES for f in ("shared", "global")
                                       if (c, f) != ("shifted", "shared")])
def test_nested_tail_ordered_branch_matches_plain(dev, kid, dtype, case, form, monkeypatch):
    """R2c's, R2d's and R2n's ordered branch, on the records of either form
    of the ordering (the shared one on tables of up to its bucket limit),
    bit for bit against the plain version: the ordering once, the tail
    once."""
    from ndarray_interp_tpu_torch.ops import cell_order as co

    wrapper, plain, _, _ = bicubic_tail(kid)
    monkeypatch.setattr(co, "_form", lambda buckets: order_form(form))
    force_branch(monkeypatch, True)
    args = nested_case(case, 200_000, dtype, dev, len(case) + len(form))
    got, launched = launched_by(lambda: wrapper(*args))
    assert launched == {"ORD": 1, kid: 1}
    assert same(got, plain(*args))


@pytest.mark.parametrize("kid", BICUBIC_TAILS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r", [1, 3, 4, 16, 17, 40])
def test_nested_tail_ordered_kernel_on_records_of_the_plain_ordering(dev, kid, dtype, r):
    """R2c's, R2d's and R2n's ordered kernel alone on the records of the
    plain flat-cell ordering against its plain version on the records, at
    16-byte lanes (r of 4, 16, 40) and a channel a lane (1, 3, 17, and a
    table off 16-byte alignment), a query's chunks past 32 lanes looped
    (r = 40)."""
    from ndarray_interp_tpu_torch.ops import _cuda
    from ndarray_interp_tpu_torch.ops import cell_order as co

    _, plain, on_records, entry = bicubic_tail(kid)
    rows, cell, tx, ty, r = nested_case("random", 20_000, dtype, dev, r, r=r)
    records = co._order_plain(cell, None, 1, 0, rows.shape[0],
                              *((tx, None, ty, None) if dtype == np.float64 else
                                (tx, ty, None, None)))
    want = on_records(rows, records, r)
    assert same(want, plain(rows, cell, tx, ty, r))
    buf = torch.empty(rows.numel() + 1, dtype=rows.dtype, device=dev)
    for tbl in (rows, buf[1:].view(rows.shape).copy_(rows)):
        out = torch.empty((cell.shape[0], r), dtype=rows.dtype, device=dev)
        _cuda.launch(entry, rows.dtype, dev, tbl, tbl.shape[0], tbl.shape[1], r, records, out,
                     cell.shape[0])
        torch.cuda.synchronize()
        assert same(out, want)


@pytest.mark.parametrize("kid", BICUBIC_TAILS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r", [1, 3, 5, 8, 16])
@pytest.mark.parametrize("aligned", [True, False])
def test_bicubic_tails_in_query_order_match_plain(dev, kid, dtype, r, aligned, monkeypatch):
    """R2c's, R2d's and R2n's body in query order (the branch small batches
    take) bit for bit against the plain version: W channels a lane on
    16-byte loads where r, the row width and the table's base allow them (r
    of 8 and 16 on the packed table), a channel a lane else (r of 1, 3, 5, a
    row of 16r + 3 values, a table copied one element off 16-byte
    alignment); on uniform cells, on cells far outside the table (clamped
    alike) and on every query in one cell."""
    wrapper, plain, _, _ = bicubic_tail(kid)
    force_branch(monkeypatch, False)
    rows, cell, tx, ty, r = nested_case("random", 50_000, dtype, dev, 10 * r + aligned, r=r)
    wide = torch.as_tensor(np.random.default_rng(r).normal(size=(rows.shape[0], 16 * r + 3))
                           .astype(dtype), device=dev)
    wide[:, :16 * r] = rows
    far = torch.as_tensor(np.random.default_rng(r).integers(-5 * rows.shape[0],
                                                            5 * rows.shape[0], cell.shape[0]),
                          dtype=torch.int32, device=dev)
    for tbl in (rows, wide):
        if not aligned:
            buf = torch.empty(tbl.numel() + 1, dtype=tbl.dtype, device=dev)
            tbl = buf[1:].view(tbl.shape).copy_(tbl)
        for c in (cell, far, torch.full_like(cell, rows.shape[0] // 2)):
            got, launched = launched_by(lambda t=tbl, c=c: wrapper(t, c, tx, ty, r))
            assert launched == {kid: 1}
            assert tuple(got.shape) == (cell.shape[0], r)
            assert same(got, plain(tbl, c, tx, ty, r))


@pytest.mark.parametrize("kid", BICUBIC_TAILS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nq", [0, 1])
@pytest.mark.parametrize("ordered", [True, False])
def test_nested_tail_takes_empty_and_single_query_batches(dev, kid, dtype, nq, ordered,
                                                          monkeypatch):
    wrapper, plain, _, _ = bicubic_tail(kid)
    force_branch(monkeypatch, ordered)
    args = nested_case("random", nq, dtype, dev, 3)
    got, launched = launched_by(lambda: wrapper(*args))
    assert tuple(got.shape) == (nq, 16) and same(got, plain(*args))
    assert launched == ({"ORD": 1, kid: 1} if ordered and nq else {kid: 1})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("form,rows,nq", [
    (f, rows, nq) for f in ("shared", "global")
    for rows, nq in ((1, 5000), (1000, 1), (1000, 0), (32_768, 300_000), (261_121, 300_000),
                     (2**22 + 3, 300_000))
    if f == "global" or rows <= 32_768])
def test_flat_cell_order_matches_plain(dev, dtype, form, rows, nq):
    """ORD's flat-cell form in either form of the sort against the plain
    ordering: the same bucket keys in order, a permutation, and each
    query's record (its clamped cell and the bits of its fractions in their
    own dtype) bit for bit."""
    from ndarray_interp_tpu_torch.ops import cell_order as co

    rng = np.random.default_rng(rows % 1000 + nq)
    cell = torch.as_tensor(rng.integers(-3, rows + 3, nq), dtype=torch.int32, device=dev)
    tx, ty = (torch.as_tensor(v.astype(dtype), device=dev) for v in order_fractions(rng, nq))
    wide = dtype == np.float64
    args = (cell, None, 1, 0, rows, *((tx, None, ty, None) if wide else (tx, ty, None, None)))
    records = co._order_kernel(args, order_form(form))
    want = co._order_plain(*args)
    torch.cuda.synchronize()
    if nq <= 1:
        assert torch.equal(records, co.order_by_flat_cell(cell, rows, tx, ty))
    keys = co.bucket_keys(records[:, 0].long(), rows)
    assert torch.equal(keys, co.bucket_keys(want[:, 0].long(), rows))
    qid = records[:, 1].long()
    assert torch.equal(torch.sort(qid).values, torch.arange(nq, device=dev))
    assert torch.equal(records[qid.argsort()], want[want[:, 1].long().argsort()])
    _, _, frac = co.record_fields(records, tx.dtype)
    assert same(frac[:, :2], torch.stack([tx, ty], dim=1)[qid])


def test_cell_route_wrappers_check_their_inputs(dev):
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    rows = torch.zeros((12, 16 * 3), device=dev)
    cell = torch.zeros(5, dtype=torch.int32, device=dev)
    t = torch.zeros(5, device=dev)
    with pytest.raises(TypeError, match="int32"):
        t2.bicubic_nested_tail(rows, cell.long(), t, t, 3)
    with pytest.raises(TypeError, match="torch.float16"):
        t2.bicubic_gathered_eval(rows.half(), cell, t.half(), t.half(), 3)
    with pytest.raises(TypeError, match="mixed dtypes"):
        t2.bicubic_tree_tail(rows, cell, t.double(), t, 3)
    with pytest.raises(ValueError, match="rows_tbl"):
        t2.bilinear_gathered_eval(rows[:, :15], cell, t, t, 3)
    with pytest.raises(ValueError, match="flat"):
        t2.bilinear_gathered_eval(rows, cell[:4], t, t, 3)
    with pytest.raises(ValueError, match="tensors on"):
        t2.bicubic_nested_tail(rows.cpu(), cell, t, t, 3)
    with pytest.raises(TypeError, match="int32"):
        t2.bicubic_nested_tail(rows, cell.cpu(), t, t, 3)
    k = torch.linspace(0.0, 1.0, 9, device=dev)
    grid = torch.zeros((9, 9, 3), device=dev)
    with pytest.raises(TypeError, match="int32"):
        t2.bilinear_grid_eval(grid, k, k, cell.long(), t, t)
    with pytest.raises(TypeError, match="mixed dtypes"):
        t2.bilinear_grid_eval(grid.double(), k, k, cell, t, t)
    with pytest.raises(ValueError, match="nx >= 2"):
        t2.bilinear_grid_eval(grid[:1], k[:1], k, cell, t, t)
    with pytest.raises(ValueError, match="axes"):
        t2.bilinear_grid_eval(grid, k[:8], k, cell, t, t)
    with pytest.raises(ValueError, match="flat"):
        t2.bilinear_grid_eval(grid, k, k, cell[:4], t, t)
    with pytest.raises(ValueError, match="tensors on"):
        ek.fused_cell_index(k.cpu(), k, t, t)
    with pytest.raises(TypeError, match="torch.int64"):
        ek.fused_cell_index(torch.arange(9, device=dev), torch.arange(9, device=dev),
                            torch.arange(5, device=dev), torch.arange(5, device=dev))


# -- the single-device remainder: build routes, native runtime, eval_checked ----------
@pytest.mark.parametrize("n, bank", [(64, 4096), (256, 1024), (512, 600), (2048, 64)])
def test_build_routes_match_the_thomas_kernel(dev, n, bank):
    """PCR and the dense build on the card hold the Thomas kernel's ``a, b``
    at the JAX tolerances (f32: 2e-5 and 1e-5 of the scale), and the
    builder takes the route the rules give."""
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.models.strategies.cubic import (
        _NOT_A_KNOT,
        _ab_from_k,
        _assemble_system,
        _dense_ab,
        _dense_build_ok,
    )
    from ndarray_interp_tpu_torch.ops.pcr import pcr_solve
    from ndarray_interp_tpu_torch.ops.thomas_kernel import _THOMAS

    g = torch.Generator().manual_seed(n)
    x = torch.cumsum(torch.rand(n, generator=g) + 0.5, 0).to(dev)
    y = torch.randn(n, bank, generator=g).to(dev)
    nak = (_NOT_A_KNOT, 0.0, _NOT_A_KNOT, 0.0)
    a4, b4 = _ab_from_k(x, y, _THOMAS.function.apply(*_assemble_system(x, y, *nak)))
    scale = float(a4.abs().max())
    for (a, b), tol in ((_ab_from_k(x, y, pcr_solve(*_assemble_system(x, y, *nak))), 2e-5),
                        (_dense_ab(x, y, _NOT_A_KNOT, False), 1e-5)):
        assert float((a - a4).abs().max()) / scale <= tol
        assert float((b - b4).abs().max()) / scale <= tol
    itp = Interp1D.builder(y).x(x).strategy(CubicSpline()).build()
    want = _dense_ab(x, y, _NOT_A_KNOT, False) if _dense_build_ok(n, bank, y, "not_a_knot") else (a4, b4)
    assert float((itp.strategy.a - want[0]).abs().max()) / scale <= 1e-5


def test_dense_product_ignores_tf32(dev):
    """The dense build gives the same bits with TF32 enabled process-wide."""
    from ndarray_interp_tpu_torch.models.strategies.cubic import _NOT_A_KNOT, _dense_ab

    x = torch.linspace(0.0, 1.0, 64, device=dev)
    y = torch.randn(64, 8192, device=dev)
    before = torch.get_float32_matmul_precision()
    a0, b0 = _dense_ab(x, y, _NOT_A_KNOT, False)
    torch.set_float32_matmul_precision("high")
    try:
        a1, b1 = _dense_ab(x, y, _NOT_A_KNOT, False)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(a0, a1) and torch.equal(b0, b1)


def test_native_route_on_a_card_interpolator(dev):
    """An interpolator built on the card from numpy serves float and numpy
    queries on the host (no launch) and agrees with the card's route."""
    from ndarray_interp_tpu_torch import config, native
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    assert native.HAVE_NATIVE
    rng = np.random.default_rng(0)
    x, v = np.sort(rng.uniform(0, 10, 64)), rng.normal(size=64)
    z = rng.normal(size=(20, 16))
    itps = (Interp1D.builder(v, device=dev).x(x).strategy(CubicSpline().extrapolate(True)).build(),
            Interp2D.builder(z, device=dev).strategy(Bicubic()).build())
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    host = (itps[0].interp_scalar(3.3), itps[1].interp_scalar(4.5, 7.25),
            itps[0].interp_array(np.array([1.0, 2.0])))
    assert isinstance(host[0], float) and isinstance(host[1], float)
    assert isinstance(host[2], np.ndarray)
    assert not any(w.launches for w in wrappers.values())
    card = (float(itps[0](torch.tensor(3.3, dtype=torch.float64, device=dev))),
            float(itps[1](torch.tensor(4.5, dtype=torch.float64, device=dev),
                          torch.tensor(7.25, dtype=torch.float64, device=dev))))
    assert abs(host[0] - card[0]) <= 1e-12 * np.abs(v).max()
    assert abs(host[1] - card[1]) <= 1e-10 * np.abs(z).max()
    config_before = config.use_native_host
    try:
        config.use_native_host = False
        off = Interp1D.builder(v, device=dev).x(x).strategy(CubicSpline().extrapolate(True)).build()
        assert off.interp_scalar(3.3).device.type == "cuda"
    finally:
        config.use_native_host = config_before


def test_card_interpolator_host_copies_ignore_later_writes(dev):
    """A card interpolator built from numpy keeps its own host copies: a
    write to the caller's arrays after the build changes neither the native
    route nor the card's answers, and the two agree."""
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D

    rng = np.random.default_rng(3)
    x, v = np.sort(rng.uniform(0, 10, 64)), rng.normal(size=64)
    z = rng.normal(size=(20, 16))
    itp1 = Interp1D.builder(v, device=dev).x(x).strategy(CubicSpline()).build()
    itp2 = Interp2D.builder(z, device=dev).strategy(Bicubic()).build()
    scale1, scale2 = np.abs(v).max(), np.abs(z).max()
    v[:], x[:], z[:] = 0.0, np.arange(64.0), 0.0
    q = torch.tensor(3.3, dtype=torch.float64, device=dev)
    qx, qy = (torch.tensor(t, dtype=torch.float64, device=dev) for t in (4.5, 7.25))
    assert abs(itp1.interp_scalar(3.3) - float(itp1(q))) <= 1e-12 * scale1
    assert abs(itp2.interp_scalar(4.5, 7.25) - float(itp2(qx, qy))) <= 1e-10 * scale2


def test_eval_checked_under_graph_capture(dev):
    """``eval_checked`` captured in a CUDA graph: a replay in range does not
    throw, one with a query out of range does; the values are
    ``eval_unchecked``'s bit for bit."""
    from ndarray_interp_tpu_torch import OutOfBoundsError
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D

    x = torch.linspace(0.0, 10.0, 128, device=dev)
    itp = Interp1D.builder(torch.sin(x)).x(x).strategy(CubicSpline()).build()
    inside = torch.linspace(0.5, 9.5, 4096, device=dev)
    outside = inside.clone()
    outside[7] = 10.5
    static = inside.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        itp.eval_checked(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        err, vals = itp.eval_checked(static)
    for batch, raises in ((inside, False), (outside, True)):
        static.copy_(batch)
        graph.replay()
        torch.cuda.synchronize()
        if raises:
            with pytest.raises(OutOfBoundsError, match="a query point is not in range"):
                err.throw()
        else:
            err.throw()
        assert torch.equal(vals, itp.eval_unchecked(batch))


# -- the route rules' picks on the card (tests/test_torch_route_rules.py pins the
# rules on the CPU; tools/route_phases.py times every candidate route)
def launched(fn):
    """``fn()``'s result and the set of kernels it launched."""
    out, counts = launched_by(fn)
    return out, set(counts)


@pytest.mark.parametrize("n,bank,nq,tail", [
    (10_000, 64, 262_144, "K5"),  # the bank eval
    (1024, 8, 4096, "K5"),
    (10_000, 8, 262_144, "K5"),  # a narrow bank read by many queries a knot (once R2a's)
    (10_000, 256, 1_048_576, "K5"),  # a long, wide bank read by >= 100 queries a knot (the same)
])
def test_bank_rule_launches_its_pick(dev, n, bank, nq, tail):
    """Rule 1 (``bank_eval.can_use_banked``): the bank eval launches K2 and
    the pick's tail, not the other one; its values are the other route's
    (forced) bit for bit (K5 and R2a evaluate one Hermite form in one
    order)."""
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.models.strategies import cubic

    gen = torch.Generator(device=dev).manual_seed(n + bank)
    x = torch.linspace(0.0, 1.0, n, device=dev)
    data = torch.randn((n, bank), generator=gen, device=dev)
    itp = Interp1D.builder(data).x(x).strategy(CubicSpline().extrapolate(True)).build()
    q = torch.rand(nq, generator=gen, device=dev)
    got, kids = launched(lambda: itp(q))
    other = "R2a" if tail == "K5" else "K5"
    assert {"K2", tail} <= kids and other not in kids
    eligible = cubic.can_use_banked
    try:
        cubic.can_use_banked = lambda *_: tail == "R2a"
        want, kids = launched(lambda: itp(q))
    finally:
        cubic.can_use_banked = eligible
    assert other in kids and same(got, want)


@pytest.mark.parametrize("offset", [0, 1])
def test_split_rule_launches_its_pick(dev, offset):
    """Rule 2 (``bigknots.K1_MAX_KNOTS``): K1 and K2 at the split, R3 and
    R3idx one knot above it."""
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import bigknots

    n = bigknots.K1_MAX_KNOTS + offset
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.linspace(0.0, 100.0, n, device=dev)
    q = torch.rand(1_000_000, generator=gen, device=dev) * 100.0
    for shape, kid in (((n,), ("K1", "R3")), ((n, 8), ("K2", "R3idx"))):
        data = torch.randn(shape, generator=gen, device=dev)
        itp = Interp1D.builder(data).x(x).strategy(CubicSpline().extrapolate(True)).build()
        _, kids = launched(lambda: itp(q))
        assert kid[offset] in kids and kid[1 - offset] not in kids


def test_layout_rule_picks_on_the_card(dev, monkeypatch):
    """Rule 3 (``InterpND.pick_layout``): the cell layout at 64^3 and on one
    axis of one channel, the node layout at 64^3 with the cell table over
    the cap, each launching K2 a axis."""
    from ndarray_interp_tpu_torch import config
    from ndarray_interp_tpu_torch.interpnd import InterpND

    gen = torch.Generator(device=dev).manual_seed(3)
    cap = config.interpnd_pack_max_elems
    for shape, layout, cap in (((64, 64, 64), "cell", cap), ((100_000,), "cell", cap),
                               ((64, 64, 64), "node", 63**3 * 64 - 1)):
        monkeypatch.setattr(config, "interpnd_pack_max_elems", cap)
        axes = [torch.linspace(0.0, 1.0, s, device=dev) for s in shape]
        data = torch.randn(shape, generator=gen, device=dev)
        itp = InterpND.builder(data).points(*axes).method("cubic").build()
        assert itp.layout == layout
        qs = [torch.rand(4096, generator=gen, device=dev) for _ in shape]
        out, kids = launched(lambda: itp(*qs))
        assert "K2" in kids and bool(torch.isfinite(out).all())


def test_bicubic_between_the_caps_takes_the_cell_route(dev):
    """Rule 4: an f32 ``Bicubic`` grid whose cell table (268M elements) is
    over the JAX package's cap (128 Mi) and under the port's (2^30) builds
    the cell layout and runs R1 + R2n."""
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D

    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.linspace(0.0, 1.0, 1024, device=dev)
    z = torch.randn((1024, 1024, 16), generator=gen, device=dev)
    itp = Interp2D.builder(z).x(x).y(x).strategy(Bicubic()).build()
    assert itp.strategy.layout == "cell" and itp.strategy.rows.numel() > 128 * 1024 * 1024
    q = torch.rand(100_000, generator=gen, device=dev)
    out, kids = launched(lambda: itp(q, q.flip(0)))
    assert {"R1", "R2n"} <= kids and bool(torch.isfinite(out).all())


def test_bilinear_above_the_jax_cap_launches_r1_and_r2g(dev):
    """Rule 5: a float ``Bilinear`` grid above 64 Mi elements (the JAX
    package's cap) takes R1 + R2g without packing its corner rows, with the
    search route's values bit for bit."""
    from ndarray_interp_tpu_torch.interp2d import Bilinear, Interp2D

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.linspace(0.0, 1.0, 2304, device=dev)
    y = torch.linspace(0.0, 1.0, 2048, device=dev)
    z = torch.randn((2304, 2048, 16), generator=gen, device=dev)
    itp = Interp2D.builder(z).x(x).y(y).build()
    assert type(itp.strategy).__name__ == "BilinearPacked" and z.numel() > 64 * 1024 * 1024
    qx = torch.rand(100_000, generator=gen, device=dev)
    qy = torch.rand(100_000, generator=gen, device=dev)
    got, kids = launched(lambda: itp(qx, qy))
    assert {"R1", "R2g"} <= kids and itp.strategy._rows is None
    want, kids = launched(lambda: Interp2D.new_unchecked(x, y, z, Bilinear())(qx, qy))
    assert "K3" in kids and "R2g" not in kids and same(got, want)
