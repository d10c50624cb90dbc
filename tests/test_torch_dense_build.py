"""The port's dense-operator spline build (``models/strategies/cubic.py``)
against its elimination route and the JAX package's, on the CPU.

Twins of every test of ``tests/test_dense_build.py``, case by case, on the
same seeded axes and banks: the probed operator against the sequential
solve for every uniform boundary family (periodic and the 3-knot forms
included) within 1e-11 of the scale in f64 and 1e-5 in f32, the per-axis
``_dense_k`` on a multi-dim bank, gradients within 1e-9, and the same
functions of the JAX package (``_dense_ab``, ``_dense_k``, on jnp inputs) at
those tolerances.  ``jax.jit`` becomes a second call that must give the same
bits.  The route rule ``_dense_build_ok`` never sends a CPU tensor to the
dense build, so CPU builds stay the reference-order loop bit for bit.  The
route on the card is a ``cuda`` test in ``tests/test_torch_kernels.py``.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.models.strategies import cubic as jcubic
from ndarray_interp_tpu_torch import config
from ndarray_interp_tpu_torch.interp1d import Interp1D
from ndarray_interp_tpu_torch.interp1d.cubic_spline import BoundaryCondition, CubicSpline
from ndarray_interp_tpu_torch.models.strategies import cubic as tcubic
from ndarray_interp_tpu_torch.models.strategies.cubic import (
    _FIRST_DERIV,
    _NOT_A_KNOT,
    _SECOND_DERIV,
    _dense_ab,
    _dense_build_ok,
    _dense_k,
    _periodic_ab,
    _solve_for_k,
    _uniform_ab,
)

KINDS = [
    ("not_a_knot", _NOT_A_KNOT),
    ("natural", _SECOND_DERIV),
    ("clamped", _FIRST_DERIV),
]


def _axis(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    x[1:] += 1e-3  # guarantee strict rise
    return np.cumsum(np.diff(x, prepend=0.0)).astype(dtype)


def _bank(n, bank, seed=1, dtype=np.float64, periodic=False):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, bank)).astype(dtype)
    if periodic:
        y[-1] = y[0]
    return y


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1.0)


def twins(fn_t, fn_j, x, y):
    """The port's function on tensors twice (equal bits) and JAX's on jnp."""
    got = fn_t(torch.as_tensor(x), torch.as_tensor(y))
    again = fn_t(torch.as_tensor(x), torch.as_tensor(y))
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    return got, fn_j(jnp.asarray(x), jnp.asarray(y))


class TestDenseAB:
    @pytest.mark.parametrize("name,kind", KINDS)
    @pytest.mark.parametrize("n", [3, 8, 64])
    def test_matches_elimination_f64(self, name, kind, n):
        x, y = _axis(n), _bank(n, 2 * n)
        (a_d, b_d), (aj, bj) = twins(lambda x, y: _dense_ab(x, y, kind, False),
                                     lambda x, y: jcubic._dense_ab(x, y, kind, periodic=False),
                                     x, y)
        a_ref, b_ref = _uniform_ab(torch.as_tensor(x), torch.as_tensor(y), kind)
        scale = max(float(a_ref.abs().max()), 1.0)
        assert float((a_d - a_ref).abs().max()) / scale < 1e-11, name
        assert float((b_d - b_ref).abs().max()) / scale < 1e-11, name
        assert rel(a_d, aj) < 1e-11 and rel(b_d, bj) < 1e-11, name

    @pytest.mark.parametrize("n", [3, 8, 64])
    def test_matches_elimination_periodic(self, n):
        x, y = _axis(n, seed=3), _bank(n, 2 * n, seed=4, periodic=True)
        (a_d, b_d), (aj, bj) = twins(lambda x, y: _dense_ab(x, y, 0, True),
                                     lambda x, y: jcubic._dense_ab(x, y, 0, periodic=True), x, y)
        a_ref, b_ref = _periodic_ab(torch.as_tensor(x), torch.as_tensor(y))
        scale = max(float(a_ref.abs().max()), 1.0)
        assert float((a_d - a_ref).abs().max()) / scale < 1e-11
        assert float((b_d - b_ref).abs().max()) / scale < 1e-11
        assert rel(a_d, aj) < 1e-11 and rel(b_d, bj) < 1e-11

    def test_f32_grade(self):
        n = 64
        x, y = _axis(n, dtype=np.float32), _bank(n, 256, dtype=np.float32)
        (a_d, _), (aj, _) = twins(lambda x, y: _dense_ab(x, y, _NOT_A_KNOT, False),
                                  lambda x, y: jcubic._dense_ab(x, y, _NOT_A_KNOT, periodic=False),
                                  x, y)
        assert a_d.dtype == torch.float32
        a_ref, _ = _uniform_ab(torch.as_tensor(x), torch.as_tensor(y), _NOT_A_KNOT)
        scale = float(a_ref.abs().max())
        assert float((a_d - a_ref).abs().max()) / scale < 1e-5
        assert rel(a_d, aj) < 1e-5

    def test_grad_matches_elimination_route(self):
        n = 16
        x = torch.as_tensor(_axis(n, seed=7))
        y0 = _bank(n, n + 2, seed=8)

        def grad(build):
            y = torch.as_tensor(y0).requires_grad_()
            a, b = build(y)
            (g,) = torch.autograd.grad((a * a).sum() + torch.sin(b).sum(), y)
            return g

        g_d = grad(lambda y: _dense_ab(x, y, _NOT_A_KNOT, False))
        g_r = grad(lambda y: _uniform_ab(x, y, _NOT_A_KNOT))
        scale = max(float(g_r.abs().max()), 1.0)
        assert float((g_d - g_r).abs().max()) / scale < 1e-9

        def loss_j(y):
            a, b = jcubic._dense_ab(jnp.asarray(x.numpy()), y, _NOT_A_KNOT, periodic=False)
            return jnp.sum(a * a) + jnp.sum(jnp.sin(b))

        assert rel(g_d, jax.grad(loss_j)(jnp.asarray(y0))) < 1e-9


class TestDenseK:
    @pytest.mark.parametrize("name,kind", KINDS)
    def test_matches_solve_multi_trailing(self, name, kind):
        n = 32
        x = _axis(n, seed=5)
        grid = np.random.default_rng(6).normal(size=(n, 5, 3))
        k_ref = _solve_for_k(torch.as_tensor(x), torch.as_tensor(grid), kind, 0.0, kind, 0.0)
        (k_d,), kj = twins(lambda x, g: (_dense_k(x, g, kind, False),),
                           lambda x, g: jcubic._dense_k(x, g, kind, periodic=False), x, grid)
        scale = max(float(k_ref.abs().max()), 1.0)
        assert k_d.shape == k_ref.shape
        assert float((k_d - k_ref).abs().max()) / scale < 1e-11, name
        assert rel(k_d, kj) < 1e-11, name


def _card(dtype=torch.float32):
    """A stand-in with a CUDA tensor's device and dtype, for the rule."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype)


class TestDispatch:
    def test_eligibility(self, monkeypatch):
        # the card's rule: float32 not-a-knot banks (what the card measured),
        # at most dense_build_max_n knots, a bank of 2^25 values
        nak = "not_a_knot"
        assert _dense_build_ok(64, 10**6, _card(), nak)
        assert _dense_build_ok(64, 2**19, _card(), nak)
        assert not _dense_build_ok(64, 8, _card(), nak)  # probe wider than the bank
        assert not _dense_build_ok(64, 262_144, _card(), nak)  # K4 measured faster there
        assert not _dense_build_ok(256, 262_144, _card(), nak)  # measured a tie there
        assert not _dense_build_ok(config.dense_build_max_n + 1, 10**6, _card(), nak)
        assert not _dense_build_ok(64, 10**6, _card(torch.bfloat16), nak)
        assert not _dense_build_ok(64, 10**6, _card(torch.float64), nak)
        for kind in ("natural", "clamped", "periodic", "individual"):
            assert not _dense_build_ok(64, 10**6, _card(), kind)
        # the JAX package's off switch is use_fused_kernel; the port's is the cap
        monkeypatch.setattr(config, "dense_build_max_n", 0)
        assert not _dense_build_ok(64, 10**6, _card(), nak)

    @pytest.mark.parametrize("n, bank", [(3, 8), (64, 1000), (64, 10**6)])
    def test_never_routes_a_cpu_tensor(self, n, bank, monkeypatch):
        monkeypatch.setattr(config, "dense_build_max_n", 10**9)
        assert not _dense_build_ok(n, bank, torch.zeros(1, dtype=torch.float32), "not_a_knot")
        assert not _dense_build_ok(n, bank, torch.zeros(1, dtype=torch.float64), "not_a_knot")

    @pytest.mark.parametrize("periodic", [False, True])
    def test_cpu_build_keeps_reference_order(self, periodic, monkeypatch):
        """A CPU build stays bit for bit the reference-order loop with the
        rule's bounds opened to admit the bank's shape."""
        n, bank = 16, 64
        x = _axis(n, seed=9)
        y = _bank(n, bank, seed=10, periodic=periodic)
        bc = BoundaryCondition.Periodic if periodic else BoundaryCondition.NotAKnot
        monkeypatch.setattr(tcubic, "_DENSE_MIN_ELEMS", 0)
        # the dispatch is reached (the periodic family keeps its loop everywhere)
        assert _dense_build_ok(n, bank, _card(), bc.kind) is not periodic
        built = Interp1D.builder(y, device="cpu").x(x).strategy(CubicSpline().boundary(bc)).build()
        monkeypatch.setattr(config, "dense_build_max_n", 0)
        ref = Interp1D.builder(y, device="cpu").x(x).strategy(CubicSpline().boundary(bc)).build()
        assert torch.equal(built.strategy.a, ref.strategy.a)
        assert torch.equal(built.strategy.b, ref.strategy.b)
        xt, yt = torch.as_tensor(x), torch.as_tensor(y)
        a_ref, _ = _periodic_ab(xt, yt) if periodic else _uniform_ab(xt, yt, _NOT_A_KNOT)
        assert torch.equal(built.strategy.a, a_ref)
