"""The port's query promotion, ``eval_checked`` and per-sample builds
against the JAX package's transforms, on the CPU.

Twins of every test of ``tests/test_transforms.py``: ``checkify`` becomes
the port's ``eval_checked`` (a ``CheckError`` of device flags, read by
``.get()`` and ``.throw()``, which raises ``OutOfBoundsError`` with the JAX
messages), ``jax.jit`` a second call of the same function, ``vmap`` over
builds a loop over the samples held to the JAX ``vmap`` and SciPy.  The
graph-capture case of ``eval_checked`` on the card is a ``cuda`` test in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import scipy.interpolate as si
import torch

import jax
import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
from ndarray_interp_tpu_torch import CheckError, OutOfBoundsError
from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D


def test_bf16_queries_promote():
    data = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    itp = Interp1D.builder(data, device="cpu").strategy(CubicSpline().extrapolate(True)).build()
    q16 = torch.linspace(0.0, 31.0, 64, dtype=torch.float32).to(torch.bfloat16)
    out16 = itp(q16)
    out32 = itp(q16.to(torch.float32))
    assert out16.dtype == torch.float32
    assert torch.equal(out16, out32)
    j = j1.Interp1D.builder(jnp.asarray(data)).strategy(j1.CubicSpline().extrapolate(True)).build()
    jq = jnp.linspace(0.0, 31.0, 64, dtype=jnp.float32).astype(jnp.bfloat16)
    np.testing.assert_allclose(out16.numpy(), np.asarray(j(jq)), rtol=2e-5, atol=1e-6)


def test_checkify_1d():
    itp = Interp1D.builder(np.array([1.0, 2.0, 3.0]), device="cpu").build()
    for _ in range(2):  # the JAX test's jitted call, twice
        err, out = itp.eval_checked(torch.tensor([0.5, 1.5], dtype=torch.float64))
        assert isinstance(err, CheckError) and err.get() is None
        err.throw()  # no error
        assert torch.equal(out, itp.eval_unchecked(torch.tensor([0.5, 1.5], dtype=torch.float64)))
    err, _ = itp.eval_checked(torch.tensor([0.5, 99.0], dtype=torch.float64))
    with pytest.raises(OutOfBoundsError, match="not in range"):
        err.throw()
    assert err.get() == "a query point is not in range"
    j = j1.Interp1D.builder(jnp.asarray([1.0, 2.0, 3.0])).build()
    jerr, _ = jax.jit(lambda t, q: t.eval_checked(q))(j, jnp.array([0.5, 99.0]))
    assert err.get() in jerr.get()


def test_checkify_2d():
    itp = Interp2D.builder(np.ones((3, 3)), device="cpu").build()
    err, _ = itp.eval_checked(torch.tensor([0.5]), torch.tensor([9.0]))
    with pytest.raises(OutOfBoundsError, match="y query point"):
        err.throw()
    j = j2.Interp2D.builder(jnp.ones((3, 3))).build()
    jerr, _ = j.eval_checked(jnp.array([0.5]), jnp.array([9.0]))
    assert err.get() in jerr.get()
    # x is checked first, as in JAX
    err, _ = itp.eval_checked(torch.tensor([9.0]), torch.tensor([9.0]))
    jerr, _ = j.eval_checked(jnp.array([9.0]), jnp.array([9.0]))
    assert err.get() == "an x query point is not in range" and err.get() in jerr.get()


def test_integer_queries_promote():
    itp = Interp1D.builder(np.array([0.0, 10.0, 20.0]), device="cpu").build()
    out = itp(torch.tensor([0, 1, 2]))
    np.testing.assert_array_equal(out.numpy(), [0.0, 10.0, 20.0])
    j = j1.Interp1D.builder(jnp.asarray([0.0, 10.0, 20.0])).build()
    np.testing.assert_array_equal(out.numpy(), np.asarray(j(jnp.array([0, 1, 2]))))


def test_vmap_build_per_sample_axes():
    """A different knot axis per sample (the JAX ``vmap`` over builds): each
    sample's build outside the builder, against the JAX ``vmap`` and SciPy."""
    rng = np.random.default_rng(0)
    B, n = 5, 12
    xs = np.sort(rng.uniform(0, 10, (B, n)), axis=1)
    ys = rng.normal(size=(B, n))
    q = np.linspace(2.0, 8.0, 33)
    strat = CubicSpline().extrapolate(True)
    qt = torch.as_tensor(q)
    got = []
    for b in range(B):
        x, y = torch.as_tensor(xs[b]), torch.as_tensor(ys[b])
        got.append(Interp1D.new_unchecked(x, y, strat.build(x, y))(qt).numpy())

    jstrat = j1.CubicSpline().extrapolate(True)

    def one(x, y):
        return j1.Interp1D.new_unchecked(x, y, jstrat.build(x, y))(jnp.asarray(q))

    batched = np.asarray(jax.vmap(one)(jnp.asarray(xs), jnp.asarray(ys)))
    for b in range(B):
        ref = si.CubicSpline(xs[b], ys[b], bc_type="not-a-knot")(q)
        np.testing.assert_allclose(got[b], ref, atol=1e-9)
        np.testing.assert_allclose(got[b], batched[b], atol=1e-9)


# -- beyond the JAX file: eval_checked's exemptions and its no-check form ---------------
def test_eval_checked_exemptions():
    """An extrapolating strategy makes no check; a wrapping (periodic) axis
    is exempt, the other still checked; values are ``eval_unchecked``'s."""
    rng = np.random.default_rng(3)
    ex = Interp1D.builder(rng.normal(size=6), device="cpu") \
        .strategy(CubicSpline().extrapolate(True)).build()
    err, out = ex.eval_checked(torch.tensor([-5.0, 50.0], dtype=torch.float64))
    assert err.get() is None
    assert torch.equal(out, ex.eval_unchecked(torch.tensor([-5.0, 50.0], dtype=torch.float64)))
    z = rng.normal(size=(5, 6))
    z[-1] = z[0]
    per = Interp2D.builder(z, device="cpu").strategy(Bicubic().boundary("periodic", "natural")) \
        .build()
    jper = j2.Interp2D.builder(jnp.asarray(z)).strategy(
        j2.Bicubic().boundary("periodic", "natural")).build()
    for qx, qy, message in ((9.0, 1.0, None), (1.0, 9.0, "a y query point is not in range")):
        err, out = per.eval_checked(torch.tensor([qx], dtype=torch.float64),
                                    torch.tensor([qy], dtype=torch.float64))
        assert err.get() == message
        jerr, jout = jper.eval_checked(jnp.array([qx]), jnp.array([qy]))
        assert (jerr.get() is None) == (message is None)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-12, atol=1e-12)
    assert CheckError().get() is None
