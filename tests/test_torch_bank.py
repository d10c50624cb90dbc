"""The port's wide-bank routes (``ops/bank_eval.py`` K5, ``ops/bank_tail.py``
R2a, the bank dispatch of ``CubicSplineStrategy``) against the JAX
package's, on the CPU.

The same numpy inputs, made from seeds, go through the JAX functions (its
gather formulations, and its Pallas kernel in interpret mode at the smallest
shape only) and through the port's counterparts, which run their kernels'
plain PyTorch versions on CPU tensors.

Tolerances: the gather formulations in float32 at ``rtol = atol = 1e-6``
(the same operation order; XLA may contract a multiply-add that PyTorch
rounds twice); the JAX interpret-mode kernel at its own test's
``rtol=3e-4, atol=2e-6`` (``tests/test_pallas_bank.py:52``: its bf16 split
select and CPU contraction); the packed tail at ``rtol = atol = 1e-5``
(``tests/test_pallas_tail.py:67``); gradients at ``rtol=1e-5, atol=1e-6``
(``test_pallas_bank.py:90``), K5's in float64; public-API values at ``rtol=2e-5`` with
``atol=1e-6`` of the largest |value|, as ``tests/test_torch_interp1d.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp1d.cubic_spline as j_cs
import ndarray_interp_tpu.ops.bigknots as j_bk
import ndarray_interp_tpu.ops.pallas_bank as j_bank
import ndarray_interp_tpu.ops.pallas_eval as j_pe
import ndarray_interp_tpu.ops.pallas_tail as j_tail
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.models.strategies.cubic as t_cubic
from ndarray_interp_tpu_torch.interop import interp1d_from_numpy
from ndarray_interp_tpu_torch.ops import bank_eval as t_bank
from ndarray_interp_tpu_torch.ops import bank_tail as t_tail
from ndarray_interp_tpu_torch.ops import kernel_wrappers
from ndarray_interp_tpu_torch.ops.bigknots import MAX_BIG_KNOTS

SHAPES = [
    (16, (300,), 100),
    (255, (520,), 1000),
    (129, (16, 33), 77),
    (64, (999,), 513),
    (64, (1300,), 257),
    (33, (256,), 8),
    (65, (300,), 64),
]


def make_case(n, bank_shape, nq, seed=0):
    """The inputs of ``tests/test_pallas_bank.py:23-34``, as numpy."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n,) + bank_shape).astype(np.float32)
    a = rng.normal(size=(n - 1,) + bank_shape).astype(np.float32)
    b = rng.normal(size=(n - 1,) + bank_shape).astype(np.float32)
    idx = rng.integers(0, n - 1, nq).astype(np.int32)
    t = rng.uniform(-0.5, 1.5, nq).astype(np.float32)
    return data, a, b, idx, t


def both(arrays):
    return [jnp.asarray(v) for v in arrays], [torch.as_tensor(v) for v in arrays]


# -- K5 --------------------------------------------------------------------------
@pytest.mark.parametrize("n,bank_shape,nq", SHAPES)
def test_banked_eval_matches_jax_gather_form(n, bank_shape, nq):
    jargs, targs = both(make_case(n, bank_shape, nq))
    got = t_bank.banked_eval(*targs)
    assert tuple(got.shape) == (nq,) + bank_shape and got.dtype == torch.float32
    want = np.asarray(j_bank._gather_form(*jargs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_banked_eval_matches_jax_interpret_kernel():
    jargs, targs = both(make_case(33, (256,), 8))
    want = np.asarray(j_bank._banked_eval_impl(*jargs, interpret=True))
    np.testing.assert_allclose(t_bank.banked_eval(*targs).numpy(), want, rtol=3e-4, atol=2e-6)


def test_banked_eval_nan_t_propagates():
    data, a, b, idx, t = make_case(32, (256,), 64)
    t[3] = np.nan
    got = t_bank.banked_eval(*both((data, a, b, idx, t))[1]).numpy()
    assert np.isnan(got[3]).all()
    assert np.isfinite(np.delete(got, 3, axis=0)).all()


def test_banked_eval_nan_datum_stays_in_its_lane_and_intervals():
    """The TPU kernel NaNs the whole bank lane of a NaN datum
    (``pallas_bank.py:22-25``); the port's select is a load, so only the
    queries of the datum's two intervals, in its own lane, go NaN."""
    n, bank = 40, 300
    data, a, b, _, _ = make_case(n, (bank,), 1)
    data[17, 123] = np.nan
    idx = np.arange(n - 1, dtype=np.int32)
    t = np.full(n - 1, 0.25, np.float32)
    got = t_bank.banked_eval(*both((data, a, b, idx, t))[1]).numpy()
    expect = np.zeros_like(got, bool)
    expect[[16, 17], 123] = True
    np.testing.assert_array_equal(np.isnan(got), expect)
    jgot = np.asarray(j_bank._gather_form(*both((data, a, b, idx, t))[0]))
    np.testing.assert_array_equal(np.isnan(jgot), expect)  # the gather form agrees


def test_banked_eval_gradients_match_jax_grad_of_gather_form():
    # float64: the two frameworks sum each interval's cotangents in another
    # order, which in float32 moves a gradient of ~1e3 by ~2e-5 relative
    data, a, b, idx, t = (v.astype(np.float64) if v.dtype == np.float32 else v
                          for v in make_case(24, (280,), 50))
    jargs, _ = both((data, a, b, idx, t))

    def loss(d_, a_, b_, t_):
        return jnp.sum(j_bank._gather_form(d_, a_, b_, jargs[3], t_) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(jargs[0], jargs[1], jargs[2], jargs[4])
    leaves = [torch.as_tensor(v).requires_grad_(True) for v in (data, a, b, t)]
    (t_bank.banked_eval(*leaves[:3], torch.as_tensor(idx), leaves[3]) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_banked_eval_kernel_backward_is_autograd_of_gather_form(monkeypatch):
    """The autograd.Function that wraps K5 on the card, with its forward run
    by the plain version: its backward gives autograd's gradients of
    ``_gather_form``, and none for ``idx``."""
    monkeypatch.setattr(t_bank, "_launch", t_bank._gather_form)
    data, a, b, idx, t = make_case(20, (3, 5), 30, seed=4)
    grads = []
    for fn in (t_bank._BANKED.function.apply, t_bank._gather_form):
        leaves = [torch.as_tensor(v).double().requires_grad_(True) for v in (data, a, b, t)]
        out = fn(*leaves[:3], torch.as_tensor(idx), leaves[3])
        (out**2 * torch.linspace(0.5, 2.0, out[0].numel()).reshape(out.shape[1:])).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for g_fn, g_plain in zip(*grads):
        torch.testing.assert_close(g_fn, g_plain, rtol=1e-12, atol=1e-12)


# -- K5's launch geometry (the kernel runs only on the card; its geometry is plain) --
# bank -> (w, lanes, queries a warp) of the tables read from the L2, aligned
K5_LAYOUTS = {
    4: {1: (1, 1, 32), 3: (1, 4, 8), 8: (4, 2, 16), 33: (1, 32, 1), 64: (4, 16, 2),
        1024: (4, 32, 1), 16_384: (4, 32, 1)},
    8: {1: (1, 1, 32), 3: (1, 4, 8), 8: (2, 4, 8), 33: (1, 32, 1), 64: (2, 32, 1),
        1024: (2, 32, 1), 16_384: (2, 32, 1)},
}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("bank", sorted(K5_LAYOUTS[4]))
def test_k5_geometry_sizes_its_lanes_to_the_bank(itemsize, bank):
    """16-byte lanes (4 f32 / 2 f64 columns) only where the bank is a
    multiple of them and the bases are aligned, else a column a lane; lanes
    a power of two up to 32, so that lanes x queries a warp = 32 and every
    warp of a block works; the expected layout of each bank; a block's
    queries a whole number of its threads' rounds."""
    wide = 16 // itemsize
    g = t_bank._k5_geometry(bank, itemsize, True)
    assert (g.w, g.lanes, g.per_warp) == K5_LAYOUTS[itemsize][bank]
    for aligned in (True, False):
        g = t_bank._k5_geometry(bank, itemsize, aligned)
        assert g.w == (wide if aligned and bank % wide == 0 else 1)
        assert g.lanes * g.per_warp == 32 and g.lanes & (g.lanes - 1) == 0
        assert g.lanes == min(32, 1 << (bank // g.w - 1).bit_length())
        rounds, rest = divmod(g.chunk, t_bank._K5_THREADS // g.lanes)
        assert rest == 0 and rounds == (t_bank._K5_WIDE_ROUNDS if g.lanes >= 16 else 1)


def test_k5_geometry_takes_one_column_a_lane_off_16_byte_alignment():
    """A table sliced off a 16-byte boundary (``data[1:]`` of an odd-width
    bank; a bank of 8 one element past a boundary) takes W = 1."""
    data = torch.zeros((17, 5))
    assert t_bank._aligned(data, data[:-1], data[:-1])
    assert not t_bank._aligned(data[1:], data[:-1], data[:-1])
    buf = torch.zeros(17 * 8 + 1)
    shifted = buf[1:].view(17, 8)
    aligned = torch.zeros((17, 8))
    assert t_bank._aligned(aligned) and not t_bank._aligned(aligned, shifted)
    for n, bank, off in ((16, 5, data[1:]), (17, 8, shifted)):
        ok = t_bank._aligned(off, aligned[:-1], aligned[:-1])
        g = t_bank._k5_geometry(bank, 4, ok)
        assert not ok and g.w == 1 and g.lanes * g.per_warp == 32
    assert t_bank._k5_geometry(8, 4, True).w == 4


# the cases where the port's card-derived bounds (any knot count and bank
# width) admit K5 and the JAX package's TPU bounds (<= 2,048 knots, banks of
# >= 256) do not: ROADMAP Queue 3, route divergences
K5_DIVERGES = {(128, (64,)), (4096, (512,)), (2049, (256,)), (128, (255,))}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_can_use_banked_matches_jax(dtype):
    """K5's eligibility against the JAX package's: the same everywhere but
    the float32 cases of ``K5_DIVERGES``, where only the port admits K5 (and
    the values still agree: ``test_bank_route_matches_jax_where_it_diverges``)."""
    cases = [(128, (512,)), (128, ()), (128, (64,)), (4096, (512,)), (3, (512,)),
             (4, (512,)), (2048, (16, 16)), (2049, (256,)), (128, (255,))]
    for n, trailing in cases:
        x = np.linspace(0.0, 1.0, n).astype(dtype)
        d = np.zeros((n,) + trailing, dtype)
        port = t_bank.can_use_banked(torch.as_tensor(x), torch.as_tensor(d))
        jax_ = j_bank.can_use_banked(jnp.asarray(x), jnp.asarray(d))
        if dtype == "float32" and (n, trailing) in K5_DIVERGES:
            assert port and not jax_, (n, trailing, dtype)
        else:
            assert port == jax_, (n, trailing, dtype)
    assert (j_bank._MAX_KNOTS, j_bank._MIN_BANK) == (2048, 256)
    if dtype == "float32":  # the port's bounds: the long axis's knots, any bank width
        meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
        top = MAX_BIG_KNOTS
        assert t_bank.can_use_banked(meta(top), meta(top, 1))
        assert not t_bank.can_use_banked(meta(top + 1), meta(top + 1, 512))


@pytest.mark.parametrize("n,bank", sorted((n, t[0]) for n, t in K5_DIVERGES))
def test_bank_route_matches_jax_where_it_diverges(n, bank):
    """Where only the port takes K5 (its plain version here), the public
    eval gives the JAX package's values (its packed route) at the public-API
    tolerance of this file."""
    rng = np.random.default_rng(n + bank)
    x = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
    data = rng.normal(size=(n, bank)).astype(np.float32)
    q = rng.uniform(x[0] - 1, x[-1] + 1, 300).astype(np.float32)
    jit = j1.Interp1D.builder(jnp.asarray(data)).x(jnp.asarray(x)).strategy(
        j1.CubicSpline().extrapolate(True)).build()
    tit = t1.Interp1D.builder(torch.as_tensor(data)).x(torch.as_tensor(x)).strategy(
        t1.CubicSpline().extrapolate(True)).build()
    assert t_bank.can_use_banked(torch.as_tensor(x), torch.as_tensor(data))
    want = np.asarray(jit(jnp.asarray(q)))
    np.testing.assert_allclose(tit(torch.as_tensor(q)).numpy(), want, rtol=2e-5,
                               atol=1e-6 * np.abs(want).max())


# -- R2a: the packed route -------------------------------------------------------
def tail_case(nrow, bank, nq, seed):
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(nrow, bank)).astype(np.float32)
    a2 = rng.normal(size=(nrow - 1, bank)).astype(np.float32)
    b2 = rng.normal(size=(nrow - 1, bank)).astype(np.float32)
    idx = rng.integers(0, nrow - 1, nq).astype(np.int32)
    t = rng.uniform(-0.5, 1.5, nq).astype(np.float32)
    return d2, a2, b2, idx, t


@pytest.mark.parametrize("bank", [1, 7, 8, 9, 128, 130, 300])
def test_banked_hermite_tail_and_route_match_jax(bank):
    """The packed route and its tail against the JAX route
    (``tests/test_pallas_tail.py:71-85``) at the padding banks."""
    d2, a2, b2, idx, t = tail_case(16, bank, 130, bank)
    jargs, targs = both((d2, a2, b2, idx, t))
    want = np.asarray(j_tail._gathered_impl(*jargs, interpret=True))
    got = t_tail.gathered_bank_eval(*targs)
    assert tuple(got.shape) == (130, bank)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    packed = t_tail.pack_bank_rows(*targs[:3])
    tail = t_tail.banked_hermite_tail(packed, targs[3], targs[4], bank)
    assert torch.equal(tail, got)
    np.testing.assert_allclose(
        tail.numpy(), np.asarray(j_tail._gather_form_2d(*jargs)), rtol=1e-5, atol=1e-5)


# -- R2a's plain version at its edges, against the JAX tails -------------------------
def edge_tail_case(bank, case, nq, dtype, seed, nrow=70):
    """A packed table with one NaN datum, intervals (uniform, all in one, or
    far outside the table: clamped) and fractions with NaN, +-inf, 1e30 and
    -0.0 among them."""
    rng = np.random.default_rng(seed)
    d2, a2, b2 = (rng.normal(size=(m, bank)).astype(dtype) for m in (nrow, nrow - 1, nrow - 1))
    d2[nrow // 2, bank // 2] = np.nan
    if case == "random":
        idx = rng.integers(0, nrow - 1, nq)
    elif case == "one interval":
        idx = np.full(nq, nrow // 3)
    else:
        idx = rng.integers(-3 * nrow, 3 * nrow, nq)
    t = rng.uniform(-0.5, 1.5, nq).astype(dtype)
    t[:6] = [np.nan, np.inf, -np.inf, 1e30, -0.0, 1.0]
    return d2, a2, b2, idx.astype(np.int32), t


@pytest.mark.parametrize("case", ["random", "one interval", "out of range"])
@pytest.mark.parametrize("bank", [1, 7, 8, 64, 130])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_tail_at_its_edges_matches_the_jax_tails(dtype, bank, case):
    """``banked_hermite_tail`` on the CPU (``_tail_plain``, what R2a is held
    to on the card) against the JAX package on the same rows: the Pallas
    tail in interpret mode in f32 (``rtol = atol = 1e-5``,
    ``tests/test_pallas_tail.py:67``), its gather formulation
    ``_gather_form_2d`` in f64 (1e-12), each on the indices clamped to the
    table as the port clamps them (512 queries: the Pallas tail takes
    multiples of 512).  NaN fractions give NaN rows, and the NaN
    datum reaches only the rows of its two intervals."""
    d2, a2, b2, idx, t = edge_tail_case(bank, case, 512, dtype, bank + len(case))
    packed = t_tail.pack_bank_rows(*(torch.as_tensor(v) for v in (d2, a2, b2)))
    got = t_tail.banked_hermite_tail(packed, torch.as_tensor(idx), torch.as_tensor(t), bank)
    assert tuple(got.shape) == (512, bank) and got.dtype == packed.dtype
    got = got.numpy()
    clamped = np.clip(idx, 0, packed.shape[0] - 1)
    if dtype == np.float32:
        rows = jnp.take(jnp.asarray(packed.numpy()), jnp.asarray(clamped), axis=0)
        want = j_tail.banked_hermite_tail(rows, jnp.asarray(t), bank, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        want = j_tail._gather_form_2d(*(jnp.asarray(v) for v in (d2, a2, b2, clamped, t)))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)
    assert np.isnan(got[0]).all()
    nan_rows = np.isnan(got[:, bank // 2]) & (np.abs(t) <= 2)  # NaN from the datum alone
    assert np.isin(clamped[nan_rows], [34, 35]).all()


def test_packed_route_nan_localization():
    """``tests/test_pallas_tail.py:100-111``: a NaN datum reaches only the
    queries that touch its intervals, in its own column."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.uniform(0.1, 1.0, 64)).astype(np.float32)
    d2, a2, b2, _, _ = tail_case(64, 4, 1, 1)
    d2[32, 2] = np.nan
    q = np.array([x[5] + 0.1, x[31] + 1e-4, x[50]], np.float32)
    idx, t = j_pe._index_frac_impl(jnp.asarray(x), jnp.asarray(q), interpret=True)
    got = t_tail.gathered_bank_eval(*(torch.as_tensor(np.array(v)) for v in
                                      (d2, a2, b2, idx, t))).numpy()
    assert np.isfinite(got[0]).all() and np.isfinite(got[2]).all()
    assert np.isnan(got[1, 2]) and np.isfinite(got[1, [0, 1, 3]]).all()


def test_packed_route_gradients_match_jax_bwd():
    """The port's gradients of the packed route against the JAX route's
    ``_bwd`` (``tests/test_pallas_tail.py:114-134``); the kernel's
    autograd.Function, its forward run by the plain tail, gives the same."""
    d2, a2, b2, idx, t = tail_case(64, 8, 64, 5)
    jargs, _ = both((d2, a2, b2, idx, t))
    g = 2.0 * j_tail._gather_form_2d(*jargs)
    want = j_tail._bwd(tuple(jargs), g)
    for as_kernel in (False, True):
        leaves = [torch.as_tensor(v).requires_grad_(True) for v in (d2, a2, b2, t)]
        with pytest.MonkeyPatch.context() as mp:
            if as_kernel:
                mp.setattr(t_tail, "_launch_tail", t_tail._tail_plain)
                mp.setattr(t_tail._cuda, "kernel_device", lambda name, x: "cuda")
            out = t_tail.gathered_bank_eval(*leaves[:3], torch.as_tensor(idx), leaves[3])
        (out**2).sum().backward()
        for leaf, w in zip(leaves, (want[0], want[1], want[2], want[4])):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_bank_routes_on_cpu_launch_no_kernel():
    before = {kid: w.launches for kid, w in kernel_wrappers().items()}
    _, targs = both(make_case(16, (300,), 20))
    t_bank.banked_eval(*targs)
    t_tail.gathered_bank_eval(targs[0], targs[1], targs[2], targs[3], targs[4])
    assert {kid: w.launches for kid, w in kernel_wrappers().items()} == before


# -- the strategy's bank dispatch, against the JAX package's ------------------------
ROUTE_FNS = ("fused_index_frac", "big_lower_index_frac", "banked_eval", "gathered_bank_eval")


def jax_route(monkeypatch, itp, q):
    """The kernels the JAX dispatch picks (its TPU branch is traced on the
    CPU too, so a spy on the module functions records it)."""
    calls = []
    for mod, name in ((j_pe, "fused_index_frac"), (j_bk, "big_lower_index_frac"),
                      (j_bank, "banked_eval"), (j_tail, "gathered_bank_eval")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n), _f(*a, **k))[1])
    out = itp(q)
    return set(calls), out


def port_route(monkeypatch, itp, q):
    calls = []
    for name in ROUTE_FNS:
        fn = getattr(t_cubic, name)
        monkeypatch.setattr(t_cubic, name, lambda *a, _f=fn, _n=name: (calls.append(_n), _f(*a))[1])
    out = itp(q)
    return calls, out


# the port's routes where they differ from the JAX package's: K5 at 64
# queries on 2,048 x 256 and 3,000 x 64 (bank_eval.can_use_banked: every
# float32 bank), and K2 (not R3idx) then K5 on 65,600 knots x 3
# (bigknots.K1_MAX_KNOTS)
PORT_BANK_ROUTES = {2048: {"fused_index_frac", "banked_eval"},
                    3000: {"fused_index_frac", "banked_eval"},
                    65_600: {"fused_index_frac", "banked_eval"}}


@pytest.mark.parametrize("n,bank,route", [
    (64, (300,), {"fused_index_frac", "banked_eval"}),  # short axis x wide bank: K5
    (16, (16, 33), {"fused_index_frac", "banked_eval"}),
    (2048, (256,), {"fused_index_frac", "gathered_bank_eval"}),  # the cost model's packed pick
    (3000, (64,), {"fused_index_frac", "gathered_bank_eval"}),  # long axis: packed, R2a
    (65_600, (3,), {"big_lower_index_frac", "gathered_bank_eval"}),  # R3idx + R2a
])
def test_strategy_bank_dispatch_and_values_match_jax(monkeypatch, n, bank, route):
    """``route`` is the JAX package's; the port's is ``PORT_BANK_ROUTES``'s
    where the card's rules differ (ROADMAP Queue 3, route divergences), with
    the same values."""
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
    data = rng.normal(size=(n,) + bank).astype(np.float32)
    jitp = (j1.Interp1D.builder(jnp.asarray(data)).x(jnp.asarray(x))
            .strategy(j_cs.CubicSpline().extrapolate(True)).build())
    s = jitp.strategy
    titp = interp1d_from_numpy(x, data, a=np.asarray(s.a), b=np.asarray(s.b), mode="yes",
                               device="cpu")
    q = np.r_[rng.uniform(x[0] - 1.0, x[-1] + 1.0, 61), x[[0, 7, -1]]].astype(np.float32)
    jcalls, want = jax_route(monkeypatch, jitp, jnp.asarray(q))
    tcalls, got = port_route(monkeypatch, titp, torch.as_tensor(q))
    assert jcalls == route
    assert set(tcalls) == PORT_BANK_ROUTES.get(n, route) and len(tcalls) == 2
    want = np.asarray(want)
    assert got.shape == want.shape == (64,) + bank
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6 * scale)


def test_float64_bank_keeps_the_packed_route(monkeypatch):
    """f64 data is never K5's (``can_use_banked`` is float32 only): K2 and
    the packed route, as before; values as the JAX package's to 1e-12."""
    rng = np.random.default_rng(8)
    x = np.cumsum(rng.uniform(0.5, 1.5, 64))
    data = rng.normal(size=(64, 300))
    jitp = j1.Interp1D.builder(jnp.asarray(data)).x(jnp.asarray(x)).strategy(
        j_cs.CubicSpline().extrapolate(True)).build()
    titp = t1.Interp1D.builder(data, device="cpu").x(x).strategy(
        t1.CubicSpline().extrapolate(True)).build()
    q = rng.uniform(x[0], x[-1], 50)
    calls, got = port_route(monkeypatch, titp, torch.as_tensor(q))
    assert calls == ["fused_index_frac", "gathered_bank_eval"]
    want = np.asarray(jitp(jnp.asarray(q)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
