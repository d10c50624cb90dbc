"""The port's semantics matrix (NaN and +-inf queries, dtypes, the abort
contract) against the JAX package's, on the CPU.

Twins of ``tests/test_semantics.py``, case by case, on the same inputs: the
port's eager and pure calls raise the JAX package's errors and return its
values and dtypes (the JAX side built from and queried with jnp arrays).
Numpy queries of the eager methods go to the native host runtime where it
serves them; the cases that pin an eager error run both the native route
(numpy) and the tensor route.  ``jax.jit`` of the pure call becomes the
call itself.  Left out: the ``finite``-flag and one-hot gather cases
(``TestNonFiniteData`` but its value case), a TPU routing hint and its
workaround that the port does not carry (ROADMAP Queue 1 item 10).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
from ndarray_interp_tpu.errors import OutOfBoundsError as JOOB
from ndarray_interp_tpu_torch.errors import OutOfBoundsError
from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D, Linear

DATA = [1.0, 2.0, 4.0]


@pytest.fixture
def lin():
    return (Interp1D.builder(np.array(DATA), device="cpu").build(),
            j1.Interp1D.builder(jnp.asarray(DATA)).build())


@pytest.fixture
def lin_ex():
    return (Interp1D.builder(np.array(DATA), device="cpu").strategy(Linear().extrapolate(True))
            .build(),
            j1.Interp1D.builder(jnp.asarray(DATA)).strategy(j1.Linear().extrapolate(True)).build())


def T(v):
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


class TestNaNAndInf:
    def test_eager_nan_no_extrapolate_is_oob(self, lin):
        # reference: the range check precedes the NaN-cast panic
        t, j = lin
        with pytest.raises(OutOfBoundsError):
            t.interp(float("nan"))
        with pytest.raises(OutOfBoundsError):
            t.interp_scalar(float("nan"))  # the native route
        with pytest.raises(JOOB):
            j.interp(jnp.asarray(float("nan")))

    def test_eager_nan_with_extrapolate_raises(self, lin_ex):
        # reference: panics "failed to convert NaN to usize"
        t, j = lin_ex
        with pytest.raises(ValueError, match="NaN"):
            t.interp(float("nan"))
        with pytest.raises(ValueError, match="NaN"):
            t.interp_scalar(float("nan"))
        with pytest.raises(ValueError, match="NaN"):
            j.interp(jnp.asarray(float("nan")))

    def test_pure_nan_propagates(self, lin_ex):
        t, j = lin_ex
        out = t(T([0.5, np.nan])).numpy()
        assert np.isfinite(out[0]) and np.isnan(out[1])
        np.testing.assert_array_equal(out, np.asarray(j(jnp.asarray([0.5, np.nan]))))

    def test_pure_oob_masks_nan_only_without_extrapolation(self, lin, lin_ex):
        q = [1.0, 99.0]
        masked = lin[0](T(q)).numpy()
        assert np.isnan(masked[1]) and masked[0] == 2.0  # data[x=1] == 2
        np.testing.assert_array_equal(masked, np.asarray(lin[1](jnp.asarray(q))))
        extr = lin_ex[0](T(q)).numpy()
        assert np.isfinite(extr).all()
        np.testing.assert_array_equal(extr, np.asarray(lin_ex[1](jnp.asarray(q))))

    def test_inf_clamps_to_edge_intervals(self, lin_ex):
        # vector_extensions tests :257-265: +-inf use the first/last interval
        t, j = lin_ex
        out = t(T([np.inf, -np.inf])).numpy()
        assert out[0] == np.inf or out[0] > 1e30
        assert out[1] == -np.inf or out[1] < -1e30
        np.testing.assert_array_equal(out, np.asarray(j(jnp.asarray([np.inf, -np.inf]))))

    def test_eager_inf_oob_raises_without_extrapolation(self, lin):
        t, j = lin
        with pytest.raises(OutOfBoundsError):
            t.interp_array(np.array([0.5, np.inf]))
        with pytest.raises(OutOfBoundsError):
            t.interp_array(T([0.5, np.inf]))
        with pytest.raises(JOOB):
            j.interp_array(jnp.asarray([0.5, np.inf]))


class TestDtypes:
    def test_f32_stays_f32(self):
        data = np.linspace(0, 1, 8).astype(np.float32)
        itp = Interp1D.builder(data, device="cpu").strategy(CubicSpline().extrapolate(True)).build()
        out = itp(torch.linspace(0.0, 7.0, 5, dtype=torch.float32))
        assert out.dtype == torch.float32
        j = j1.Interp1D.builder(jnp.asarray(data)).strategy(j1.CubicSpline().extrapolate(True)) \
            .build()
        jout = j(jnp.linspace(0.0, 7.0, 5, dtype=jnp.float32))
        assert jout.dtype == jnp.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5, atol=1e-6)

    def test_int_data_truncating_division(self):
        # tests/interp1d.rs:15-18: integer casts truncate
        data = np.array([0, 3, 10])
        itp = Interp1D.builder(data, device="cpu").build()
        v = int(itp(torch.tensor(1))[()])
        assert v == 3
        assert v == int(j1.Interp1D.builder(jnp.asarray(data)).build()(jnp.array(1))[()])

    def test_cubic_rejects_int(self):
        with pytest.raises(TypeError, match="floating"):
            Interp1D.builder(np.array([1, 2, 3]), device="cpu").strategy(CubicSpline()).build()

    def test_x_data_dtype_promotion(self):
        itp = Interp1D.builder(np.array([1.0, 2.0, 3.0], np.float64), device="cpu") \
            .x(np.array([0, 1, 2])).build()
        assert itp.x.dtype == itp.data.dtype == torch.float64
        j = j1.Interp1D.builder(jnp.asarray([1.0, 2.0, 3.0])).x(jnp.asarray([0, 1, 2])).build()
        assert j.x.dtype == j.data.dtype


class TestNonFiniteData:
    def test_nan_datum_localizes_on_gather_path(self):
        # linear: a NaN datum affects only its two adjacent intervals
        d = np.array([0.0, 1.0, np.nan, 3.0, 4.0])
        q = np.array([0.5, 3.5, 1.5, 2.5])
        itp = Interp1D.builder(d, device="cpu").strategy(Linear().extrapolate(True)).build()
        j = j1.Interp1D.builder(jnp.asarray(d)).strategy(j1.Linear().extrapolate(True)).build()
        want = np.asarray(j.interp_array(jnp.asarray(q)))
        for out in (itp.interp_array(q), itp.interp_array(T(q)).numpy()):  # native, tensor
            assert np.isfinite(out[:2]).all()
            assert np.isnan(out[2:]).all()
            np.testing.assert_array_equal(out, want)


class TestAbortSemantics:
    def test_any_oob_aborts_whole_call(self, lin):
        # mod.rs:321: one bad point fails the entire interp_array
        t, j = lin
        q = [1.0, 1.5, -7.0, 2.0]
        for query in (np.array(q), T(q)):
            with pytest.raises(OutOfBoundsError):
                t.interp_array(query)
        with pytest.raises(JOOB):
            j.interp_array(jnp.asarray(q))

    def test_error_reports_first_offender(self, lin):
        t, j = lin
        q = [1.0, -7.0, 99.0]
        for query in (np.array(q), T(q)):
            with pytest.raises(OutOfBoundsError, match="-7"):
                t.interp_array(query)
        with pytest.raises(JOOB, match="-7"):
            j.interp_array(jnp.asarray(q))
