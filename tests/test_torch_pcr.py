"""The port's PCR solver (``ops/pcr.py``) against its plain Thomas loop and
the JAX package's ``pcr_solve``, on the CPU.

Twins of every test of ``tests/test_pcr.py``, case by case, on the same
seeded systems: PCR eliminates in another order than the reference, so it
agrees with the loop to rounding (f64 ``rtol=1e-12, atol=1e-12``, f32
``rtol=2e-5, atol=2e-5``, the JAX file's tolerances), and with the JAX
``pcr_solve`` (XLA on the CPU) at the same tolerances.  Also: the build's
solver on the CPU is the reference-order loop.  PCR against the Thomas
kernel on the card is a ``cuda`` test in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndarray_interp_tpu.ops.pcr import pcr_solve as jax_pcr_solve
from ndarray_interp_tpu_torch.ops import thomas_kernel
from ndarray_interp_tpu_torch.ops.pcr import pcr_solve
from ndarray_interp_tpu_torch.ops.thomas import thomas_solve


def dominant_system(rng, n, batch=(), dtype=np.float64, batched_diags=False):
    dshape = (n,) + batch if batched_diags else (n,)
    lo = rng.uniform(0.5, 2.0, dshape)
    up = rng.uniform(0.5, 2.0, dshape)
    mid = lo + up + rng.uniform(0.5, 3.0, dshape)  # strictly dominant
    rhs = rng.normal(size=(n,) + batch)
    return [np.asarray(v, dtype) for v in (up, mid, lo, rhs)]


def solve_all(system):
    """``(port PCR, port loop, JAX PCR)`` of one numpy system."""
    ts = [torch.as_tensor(v) for v in system]
    js = [jnp.asarray(v) for v in system]
    return (pcr_solve(*ts).numpy(), thomas_solve(*ts).numpy(),
            np.asarray(jax_pcr_solve(*js)))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 33, 100, 257, 1024])
def test_matches_scan_f64(n):
    got, want, jax_got = solve_all(dominant_system(np.random.default_rng(n), n, batch=(7,)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, jax_got, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [3, 64, 500])
def test_matches_scan_f32(n):
    system = dominant_system(np.random.default_rng(n + 1), n, batch=(5, 3), dtype=np.float32)
    got, want, jax_got = solve_all(system)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jax_got, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [2, 16, 129])
def test_batched_diagonals(n):
    # per-lane diagonals (the Individual-boundary solve shape)
    system = dominant_system(np.random.default_rng(n + 2), n, batch=(6,), batched_diags=True)
    got, want, jax_got = solve_all(system)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, jax_got, rtol=1e-12, atol=1e-12)


def test_residual_is_tiny():
    # direct residual check, independent of the other solver
    up, mid, lo, rhs = dominant_system(np.random.default_rng(0), 333, batch=(4,))
    x = pcr_solve(*map(torch.as_tensor, (up, mid, lo, rhs))).numpy()
    res = mid[:, None] * x
    res[1:] += lo[1:, None] * x[:-1]
    res[:-1] += up[:-1, None] * x[1:]
    np.testing.assert_allclose(res, rhs, rtol=1e-12, atol=1e-12)


def test_exact_small_system():
    # 3x3 solved by hand: [[2,1,0],[1,3,1],[0,1,2]] x = [3,5,3] -> x=[1,1,1]
    up = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64)
    mid = torch.tensor([2.0, 3.0, 2.0], dtype=torch.float64)
    lo = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float64)
    rhs = torch.tensor([3.0, 5.0, 3.0], dtype=torch.float64)[:, None]
    np.testing.assert_allclose(pcr_solve(up, mid, lo, rhs).numpy(), np.ones((3, 1)), rtol=1e-14)
    jax_x = jax_pcr_solve(*(jnp.asarray(v.numpy()) for v in (up, mid, lo, rhs)))
    np.testing.assert_allclose(np.asarray(jax_x), np.ones((3, 1)), rtol=1e-14)


@pytest.mark.parametrize("n, bank", [(64, 4096), (2048, 64), (10_000, 2)])
def test_cpu_solve_keeps_the_reference_loop(n, bank):
    """``thomas_solve_fast`` on a CPU tensor is the plain loop bit for bit
    (PCR is no route of the build: it lost to the Thomas kernel on the card
    at every measured shape)."""
    system = [torch.as_tensor(v) for v in dominant_system(np.random.default_rng(n), n, (bank,))]
    assert torch.equal(thomas_kernel.thomas_solve_fast(*system), thomas_solve(*system))
