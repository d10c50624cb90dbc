"""The port's checkpoint, config and profiling modules against the JAX
package's, on the CPU.

The twins of ``tests/test_aux.py``'s non-serving cases (its serving cases
are twinned in ``test_torch_serving.py`` and ``test_torch_df2d.py``) and
of the checkpoint cases of ``tests/test_bicubic.py`` and
``tests/test_interpnd.py``; then round trips between the packages for every
built-in codec, both ways: a file written by the JAX package loads in the
port, and one written by the port loads in the JAX package.

Tolerances: a round trip within one package equal bit for bit where the
state is stored (1-D coefficients, bicubic rows) and where the derived
tables are packed again the same way, as the JAX tests hold them; the
legacy bicubic rows within the JAX test's ``rtol = atol = 1e-12``.  Across
the packages the parity tolerance of the existing twins: float64 within
1e-12 of the value scale, the step family equal.
"""

import inspect
import json
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ndarray_interp_tpu.interp1d as j1
import ndarray_interp_tpu.interp2d as j2
import ndarray_interp_tpu_torch.interp1d as t1
import ndarray_interp_tpu_torch.interp2d as t2
from ndarray_interp_tpu.interpnd import InterpND as JND
from ndarray_interp_tpu.utils import checkpoint as jcheckpoint
from ndarray_interp_tpu_torch import config as tconfig
from ndarray_interp_tpu_torch.examples.custom_strategy import StepInterpolator as Step
from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D, Linear
from ndarray_interp_tpu_torch.interp2d import Interp2D
from ndarray_interp_tpu_torch.interpnd import InterpND
from ndarray_interp_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True)
def native_host(request, monkeypatch):
    """The route of numpy and float queries: the tensor path (on the CPU the
    kernels' plain versions), and in the cases marked ``BOTH_ROUTES`` also the
    native host runtime, the default, on the same inputs and tolerances."""
    on = getattr(request, "param", False)
    monkeypatch.setattr(tconfig, "use_native_host", on)
    return on


BOTH_ROUTES = pytest.mark.parametrize(
    "native_host", [False, True], ids=["tensor", "native"], indirect=True
)


def np_of(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def scaled(got, want):
    got, want = np_of(got), np_of(want)
    return float(np.max(np.abs(got - want)) / max(np.abs(want).max(), 1e-300))


def equal(a, b):
    np.testing.assert_array_equal(np_of(a), np_of(b))


@pytest.fixture
def forget_custom_codecs():
    """Drop the ``custom:`` codecs a test registered, as the JAX tests do."""
    yield
    checkpoint._STRATEGY_CODECS = {
        k: v for k, v in checkpoint._STRATEGY_CODECS.items() if not k.startswith("custom:")
    }


# -- TestCheckpoint --------------------------------------------------------------------
class TestCheckpoint:
    def test_roundtrip_linear(self, tmp_path):
        itp = (Interp1D.builder(np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 9.0]]), device="cpu")
               .strategy(Linear().extrapolate(True)).build())
        p = tmp_path / "lin.npz"
        checkpoint.save(p, itp)
        back = checkpoint.load(p, device="cpu")
        q = np.array([-0.5, 0.7, 2.0])
        equal(back.interp_array(q), itp.interp_array(q))
        assert back.strategy.extrapolates

    def test_roundtrip_cubic(self, tmp_path):
        itp = (Interp1D.builder(np.random.default_rng(0).normal(size=(12, 3)), device="cpu")
               .strategy(CubicSpline().extrapolate(True)).build())
        p = tmp_path / "cub"
        checkpoint.save(p, itp)
        back = checkpoint.load(p, device="cpu")
        q = np.linspace(-1.0, 12.0, 40)
        equal(back.interp_array(q), itp.interp_array(q))
        # the coefficients come back as they were: no rebuild
        equal(back.strategy.a, itp.strategy.a)

    def test_roundtrip_2d(self, tmp_path):
        itp = Interp2D.builder(np.random.default_rng(1).normal(size=(5, 6, 2)),
                               device="cpu").build()
        p = tmp_path / "bi.npz"
        checkpoint.save(p, itp)
        back = checkpoint.load(p, device="cpu")
        qx, qy = np.array([0.5, 3.3]), np.array([1.5, 4.4])
        equal(back.interp_array(qx, qy), itp.interp_array(qx, qy))

    def test_unknown_strategy_rejected(self, tmp_path):
        from ndarray_interp_tpu_torch.interp1d import PointwiseStrategy

        class Weird(PointwiseStrategy):
            def eval_point(self, interp, x):  # pragma: no cover
                return interp.data[0]

        itp = Interp1D.new_unchecked(torch.arange(3.0), torch.arange(3.0), Weird())
        with pytest.raises(TypeError, match="cannot serialize strategy"):
            checkpoint.save(tmp_path / "w.npz", itp)

    def test_unknown_interpolator_rejected(self, tmp_path):
        with pytest.raises(TypeError, match="cannot serialize"):
            checkpoint.save(tmp_path / "x.npz", object())

    def test_load_needs_a_device_or_the_gpu(self, tmp_path):
        """``load`` puts the arrays on the GPU unless ``device`` is named,
        as the builders do; without a CUDA device it raises, and it never
        falls back to the CPU."""
        itp = Interp1D.builder(np.arange(5.0), device="cpu").build()
        checkpoint.save(tmp_path / "d.npz", itp)
        if torch.cuda.is_available():
            assert checkpoint.load(tmp_path / "d.npz").data.is_cuda
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                checkpoint.load(tmp_path / "d.npz")
        assert checkpoint.load(tmp_path / "d.npz", device="cpu").data.device.type == "cpu"


def test_aliases_importable():
    from ndarray_interp_tpu_torch.interp1d.aliases import (
        Interp1DOwned,
        Interp1DScalar,
        Interp1DVec,
    )
    from ndarray_interp_tpu_torch.interp2d.aliases import (
        Interp2DOwned,
        Interp2DScalar,
        Interp2DVec,
    )

    assert Interp1DOwned is Interp1DScalar is Interp1DVec is Interp1D
    assert Interp2DOwned is Interp2DScalar is Interp2DVec is Interp2D


def test_config_flags_exist():
    """The flags that mean something on the GPU, read at build time: the
    layout caps at the JAX defaults, ``use_native_host`` on by default as in
    JAX, ``dense_build_max_n`` the card's choice.  Not ported
    (``config.py``'s docstring says why): ``use_fused_kernel`` (the tensor's
    device picks the kernel), ``jit_const_cap_bytes`` and ``route_hygiene``
    (hygiene, item 10)."""
    from ndarray_interp_tpu import config as jconfig

    for flag in ("bicubic_pack_max_elems", "interpnd_pack_max_elems"):
        assert isinstance(getattr(tconfig, flag), int)
        assert getattr(tconfig, flag) == getattr(jconfig, flag) == 128 * 1024 * 1024
    # the default as the module sets it (this file's fixture turns it off)
    assert "use_native_host: bool = True" in inspect.getsource(tconfig)
    assert isinstance(tconfig.use_native_host, bool) and hasattr(jconfig, "use_native_host")
    assert isinstance(tconfig.dense_build_max_n, int) and hasattr(jconfig, "dense_build_max_n")
    for flag in ("use_fused_kernel", "jit_const_cap_bytes", "route_hygiene"):
        assert hasattr(jconfig, flag) and not hasattr(tconfig, flag)
        assert flag in tconfig.__doc__


@pytest.mark.parametrize("flag", ["bicubic_pack_max_elems", "interpnd_pack_max_elems"])
def test_config_is_read_at_build_time(monkeypatch, flag):
    """A cap set after a build moves only the builds that follow it."""
    rng = np.random.default_rng(5)
    z = rng.normal(size=(6, 5, 4))

    def build():
        if flag == "bicubic_pack_max_elems":
            itp = Interp2D.builder(z[..., 0], device="cpu").strategy(t2.Bicubic()).build()
            return itp.strategy.layout
        return InterpND.builder(z, device="cpu").method("cubic").build().layout

    first = build()
    assert first == "cell"
    monkeypatch.setattr(tconfig, flag, 10)
    assert build() == "node"


def test_profiling_helpers(tmp_path):
    from ndarray_interp_tpu_torch.utils import profiling

    itp = Interp1D.builder(np.arange(8.0), device="cpu").build()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("eval"):
            itp.interp_array(np.linspace(0.0, 7.0, 16))
    files = list((tmp_path / "trace").rglob("*"))
    assert any(files)
    names = [e.get("name") for f in files for e in json.loads(f.read_text())["traceEvents"]]
    assert "eval" in names


def test_profiling_trace_written_when_the_block_raises(tmp_path):
    """As ``jax.profiler.stop_trace`` in a ``finally``: the trace of a
    block that raised is still written."""
    from ndarray_interp_tpu_torch.utils import profiling

    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path / "t")):
            1 / 0
    assert any((tmp_path / "t").rglob("*.json"))


def test_device_memory_stats():
    from ndarray_interp_tpu_torch.utils import profiling

    assert profiling.device_memory_stats("cpu") == {}
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert "allocated_bytes.all.current" in stats
    else:
        assert stats == {}


# -- TestCustomStrategyCodec -------------------------------------------------------------
class TestCustomStrategyCodec:
    def test_class_hook_roundtrip(self, tmp_path, monkeypatch, forget_custom_codecs):
        # attach the class-level hook (it would normally live on the class)
        monkeypatch.setattr(Step, "checkpoint_encode", lambda self: ({}, {}), raising=False)
        monkeypatch.setattr(Step, "checkpoint_decode",
                            classmethod(lambda cls, meta, arrays: cls()), raising=False)
        data = np.random.default_rng(3).normal(size=12)
        itp = Interp1D.builder(data, device="cpu").strategy(Step()).build()
        p = tmp_path / "step.npz"
        checkpoint.save(p, itp)
        back = checkpoint.load(p, device="cpu")
        q = np.linspace(0.0, 11.0, 40)
        equal(back.interp_array(q), itp.interp_array(q))

    def test_register_codec_roundtrip(self, tmp_path):
        checkpoint.register_strategy_codec("step", Step, lambda s: ({}, {}),
                                           lambda meta, arrs: Step())
        try:
            itp = Interp1D.builder(np.arange(8.0) ** 2, device="cpu").strategy(Step()).build()
            p = tmp_path / "step2.npz"
            checkpoint.save(p, itp)
            back = checkpoint.load(p, device="cpu")
            q = np.array([0.2, 3.7, 6.9])
            equal(back.interp_array(q), itp.interp_array(q))
        finally:
            checkpoint._STRATEGY_CODECS.pop("step", None)

    def test_decoder_gets_tensors_on_the_load_device(self, tmp_path):
        seen = {}

        def decode(meta, arrs):
            seen.update(arrs)
            return Step()

        checkpoint.register_strategy_codec(
            "step_arrays", Step, lambda s: ({"w": 2}, {"table": np.arange(4.0)}), decode)
        try:
            itp = Interp1D.builder(np.arange(6.0), device="cpu").strategy(Step()).build()
            checkpoint.save(tmp_path / "s.npz", itp)
            checkpoint.load(tmp_path / "s.npz", device="cpu")
        finally:
            checkpoint._STRATEGY_CODECS.pop("step_arrays", None)
        assert isinstance(seen["table"], torch.Tensor) and seen["table"].device.type == "cpu"
        equal(seen["table"], np.arange(4.0))


# -- TestCheckpointCustomImportSafety ----------------------------------------------------
def crafted(tmp_path, name):
    """An ``.npz`` whose header names the custom codec ``name``."""
    rng = np.random.default_rng(5)
    header = {"kind": "interp1d", "strategy": name, "strategy_meta": {}}
    p = tmp_path / "crafted.npz"
    np.savez(p, x=np.arange(8.0), data=rng.normal(size=8),
             __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8))
    return p


class TestCheckpointCustomImportSafety:
    """``load`` imports no module that a file's header names unless the
    caller allows it."""

    def test_load_refuses_unimported_module(self, tmp_path):
        p = crafted(tmp_path, "custom:definitely_not_imported_xyz.Strategy")
        with pytest.raises(TypeError, match="not imported"):
            checkpoint.load(p, device="cpu")

    def test_load_refuses_when_only_parent_package_imported(self, tmp_path, monkeypatch):
        monkeypatch.setitem(sys.modules, "ndi_fake_parent_pkg",
                            types.ModuleType("ndi_fake_parent_pkg"))
        p = crafted(tmp_path, "custom:ndi_fake_parent_pkg.strategies.MyStrat")
        with pytest.raises(TypeError, match="not imported"):
            checkpoint.load(p, device="cpu")

    def test_load_resolves_from_already_imported_module(self, tmp_path, monkeypatch,
                                                        forget_custom_codecs):
        monkeypatch.setattr(Step, "checkpoint_encode", lambda self: ({}, {}), raising=False)
        monkeypatch.setattr(Step, "checkpoint_decode",
                            classmethod(lambda cls, meta, arrays: cls()), raising=False)
        itp = Interp1D.builder(np.arange(6.0), device="cpu").strategy(Step()).build()
        p = tmp_path / "step3.npz"
        checkpoint.save(p, itp)
        # a fresh process: the codec forgotten, the module still imported
        checkpoint._STRATEGY_CODECS = {
            k: v for k, v in checkpoint._STRATEGY_CODECS.items() if not k.startswith("custom:")
        }
        back = checkpoint.load(p, device="cpu")
        assert type(back.strategy) is Step

    def test_allow_custom_import_opt_in(self, tmp_path, monkeypatch, forget_custom_codecs):
        modname = "ndi_tmp_torch_codec_mod"
        (tmp_path / f"{modname}.py").write_text(textwrap.dedent(
            """
            class TmpStrategy:
                @classmethod
                def checkpoint_decode(cls, meta, arrays):
                    return cls()

                def checkpoint_encode(self):
                    return {}, {}
            """
        ))
        p = crafted(tmp_path, f"custom:{modname}.TmpStrategy")
        monkeypatch.syspath_prepend(str(tmp_path))
        monkeypatch.delitem(sys.modules, modname, raising=False)
        assert modname not in sys.modules
        with pytest.raises(TypeError, match="not imported"):
            checkpoint.load(p, device="cpu")
        assert modname not in sys.modules
        back = checkpoint.load(p, allow_custom_import=True, device="cpu")
        assert type(back.strategy).__name__ == "TmpStrategy"
        sys.modules.pop(modname, None)

    def test_save_rejects_unimportable_class(self, tmp_path):
        class LocalStrategy(Step):
            def checkpoint_encode(self):
                return {}, {}

            @classmethod
            def checkpoint_decode(cls, meta, arrays):
                return cls()

        itp = Interp1D.builder(np.arange(6.0), device="cpu").strategy(LocalStrategy()).build()
        with pytest.raises(TypeError, match="importable module"):
            checkpoint.save(tmp_path / "bad.npz", itp)

    def test_unknown_codec_name(self, tmp_path):
        with pytest.raises(TypeError, match="unknown strategy codec"):
            checkpoint.load(crafted(tmp_path, "quintic"), device="cpu")


def test_checkpoint_roundtrip_nearest_family(tmp_path):
    from ndarray_interp_tpu_torch.interp1d import Nearest
    from ndarray_interp_tpu_torch.interp2d import Nearest2D

    rng = np.random.default_rng(63)
    itp = (Interp1D.builder(rng.normal(size=12), device="cpu")
           .strategy(Nearest("previous", extrapolate=True)).build())
    p = tmp_path / "nearest.npz"
    checkpoint.save(p, itp)
    back = checkpoint.load(p, device="cpu")
    assert back.strategy.mode == "previous" and back.strategy.extrapolates
    q = np.array([0.3, 5.7, 11.9])
    equal(back.interp_array(q), itp.interp_array(q))
    itp2 = (Interp2D.builder(rng.normal(size=(8, 6)), device="cpu")
            .strategy(Nearest2D(extrapolate=True)).build())
    p2 = tmp_path / "nearest2d.npz"
    checkpoint.save(p2, itp2)
    back2 = checkpoint.load(p2, device="cpu")
    assert back2.strategy.extrapolates
    qx, qy = np.array([0.4, 9.6]), np.array([0.2, 6.9])
    equal(back2.interp_array(qx, qy), itp2.interp_array(qx, qy))


# -- the checkpoint cases of test_bicubic.py ---------------------------------------------
def bicubic_fixture(nx=14, ny=11, trailing=(), seed=0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.0, nx))
    y = np.cumsum(rng.uniform(0.2, 1.0, ny))
    return x, y, rng.normal(size=(nx, ny) + trailing), rng


def bicubic_build(x, y, z, strategy=None):
    s = strategy or t2.Bicubic().extrapolate(True)
    return Interp2D.builder(z, device="cpu").x(x).y(y).strategy(s).build()


def test_bicubic_checkpoint_roundtrip(tmp_path):
    x, y, z, rng = bicubic_fixture()
    itp = bicubic_build(x, y, z)
    p = tmp_path / "bicubic.npz"
    checkpoint.save(p, itp)
    back = checkpoint.load(p, device="cpu")
    qx, qy = rng.uniform(x[0], x[-1], 20), rng.uniform(y[0], y[-1], 20)
    equal(back.interp_array(qx, qy), itp.interp_array(qx, qy))


def test_bicubic_checkpoint_roundtrip_with_boundaries(tmp_path):
    x, y, z, rng = bicubic_fixture(seed=11)
    itp = bicubic_build(x, y, z, t2.Bicubic().boundary("natural", "clamped"))
    p = tmp_path / "bicubic_bc.npz"
    checkpoint.save(p, itp)
    back = checkpoint.load(p, device="cpu")
    assert (back.strategy.bc_x, back.strategy.bc_y) == ("natural", "clamped")
    qx, qy = rng.uniform(x[0], x[-1], 20), rng.uniform(y[0], y[-1], 20)
    equal(back.interp_array(qx, qy), itp.interp_array(qx, qy))


def test_bicubic_node_layout_checkpoint_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    x, y, z, rng = bicubic_fixture(seed=23)
    itp = bicubic_build(x, y, z)
    assert itp.strategy.layout == "node"
    p = tmp_path / "bicubic_node.npz"
    checkpoint.save(p, itp)
    monkeypatch.undo()  # the layout is stored: a later cap does not change it
    back = checkpoint.load(p, device="cpu")
    assert back.strategy.layout == "node"
    qx, qy = rng.uniform(x[0], x[-1], 20), rng.uniform(y[0], y[-1], 20)
    equal(back.interp_array(qx, qy), itp.interp_array(qx, qy))


def legacy_bicubic_file(tmp_path, x, y, z):
    """A checkpoint in the older bicubic row format: raw corner state and
    the interval endpoints, ``(cells, 16r + 4)``, the state from the JAX
    package's solves."""
    from ndarray_interp_tpu.models.strategies.bicubic import _solve_axis0, _solve_axis1

    xj, yj, zj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)
    kx = _solve_axis0(xj, zj, "not_a_knot")
    ky = _solve_axis1(yj, zj, "not_a_knot")
    kxy = _solve_axis1(yj, kx, "not_a_knot")
    nx, ny, r = z.shape
    blocks = [np.stack([g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]], axis=2)
              .reshape(nx - 1, ny - 1, 4 * r)
              for g in (np.asarray(zj), np.asarray(kx), np.asarray(ky), np.asarray(kxy))]
    ends = np.stack([np.broadcast_to(x[:-1, None], (nx - 1, ny - 1)),
                     np.broadcast_to(x[1:, None], (nx - 1, ny - 1)),
                     np.broadcast_to(y[None, :-1], (nx - 1, ny - 1)),
                     np.broadcast_to(y[None, 1:], (nx - 1, ny - 1))], axis=-1)
    legacy = np.concatenate(blocks + [ends], axis=-1).reshape((nx - 1) * (ny - 1), 16 * r + 4)
    header = {"kind": "interp2d", "strategy": "bicubic",
              "strategy_meta": {"extrapolate": True}}  # the older meta
    p = tmp_path / "legacy_bicubic.npz"
    np.savez(p, x=x, y=y, data=z, strategy_rows=legacy,
             __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8))
    return p


@BOTH_ROUTES
def test_legacy_checkpoint_rows_convert(tmp_path):
    """Rows of the older ``(cells, 16r + 4)`` format convert exactly to the
    pre-scaled ``16r`` rows on load, in both packages alike."""
    x, y, z, rng = bicubic_fixture(trailing=(2,), seed=51)
    itp = bicubic_build(x, y, z)
    p = legacy_bicubic_file(tmp_path, x, y, z)
    back = checkpoint.load(p, device="cpu")
    jback = jcheckpoint.load(p)
    assert back.strategy.rows.shape[1] == 16 * 2
    qx, qy = rng.uniform(x[0], x[-1], 50), rng.uniform(y[0], y[-1], 50)
    got = np_of(back.interp_array(qx, qy))
    np.testing.assert_allclose(got, np_of(itp.interp_array(qx, qy)), rtol=1e-12, atol=1e-12)
    equal(back.strategy.rows, np.asarray(jback.strategy.rows))
    assert scaled(got, jback.interp_array(qx, qy)) <= 1e-12


# -- the checkpoint cases of test_interpnd.py --------------------------------------------
def test_interpnd_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(21)
    axes = [np.sort(rng.uniform(-4.0, 4.0, n)) for n in (5, 4, 6)]
    data = rng.normal(size=(5, 4, 6, 2))
    itp = (InterpND.builder(data, device="cpu").points(*axes).method("nearest")
           .extrapolate().build())
    path = tmp_path / "nd.npz"
    checkpoint.save(path, itp)
    back = checkpoint.load(path, device="cpu")
    assert isinstance(back, InterpND)
    assert (back.method, back.extrapolates, back.k) == ("nearest", True, 3)
    qs = [rng.uniform(a[0], a[-1], 16) for a in axes]
    equal(back.interp_array(*qs), itp.interp_array(*qs))


def test_interpnd_cubic_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(59)
    axes = [np.sort(rng.uniform(0, 1, 6)) for _ in range(2)]
    data = rng.normal(size=(6, 6))
    itp = (InterpND.builder(data, device="cpu").points(*axes).method("cubic")
           .boundary("natural", "clamped").build())
    path = tmp_path / "ndc.npz"
    checkpoint.save(path, itp)
    back = checkpoint.load(path, device="cpu")
    assert back.method == "cubic"
    assert back.bcs == ("natural", "clamped")
    assert back.layout == "cell"
    qs = [rng.uniform(a[0], a[-1], 20) for a in axes]
    equal(back.interp_array(*qs), itp.interp_array(*qs))
    equal(back.table, itp.table)


def test_interpnd_forced_node_layout_reloads_on_the_default_layout(tmp_path):
    """The layout is derived state and is not saved (as in the JAX package):
    a forced node layout reloads on ``build_state``'s default layout, the same
    interpolant."""
    rng = np.random.default_rng(60)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 7)]
    data = rng.normal(size=(6, 5, 7))
    itp = InterpND.builder(data, device="cpu").points(*axes).method("cubic").layout("node").build()
    checkpoint.save(tmp_path / "node.npz", itp)
    back = checkpoint.load(tmp_path / "node.npz", device="cpu")
    jback = jcheckpoint.load(tmp_path / "node.npz")
    assert (itp.layout, back.layout, jback.layout) == ("node", "cell", "cell")
    qs = [rng.uniform(a[0], a[-1], 40) for a in axes]
    np.testing.assert_allclose(back.interp_array(*qs).numpy(), itp.interp_array(*qs).numpy(),
                               rtol=1e-12, atol=1e-12)


# -- round trips between the packages ----------------------------------------------------
def case_1d(kind):
    rng = np.random.default_rng(101)
    x = np.cumsum(rng.uniform(0.2, 1.0, 16))
    y = rng.normal(size=(16, 3))
    q = rng.uniform(x[0] - 1.0, x[-1] + 1.0, 50)
    strat = {"linear": lambda m: m.Linear().extrapolate(True),
             "cubic": lambda m: m.CubicSpline().extrapolate(True),
             "nearest": lambda m: m.Nearest("next", extrapolate=True)}[kind]
    j = j1.Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x)).strategy(strat(j1)).build()
    t = Interp1D.builder(y, device="cpu").x(x).strategy(strat(t1)).build()
    return j, t, (q,)


def case_2d(kind):
    rng = np.random.default_rng(102)
    x = np.cumsum(rng.uniform(0.2, 1.0, 12))
    y = np.cumsum(rng.uniform(0.2, 1.0, 9))
    z = rng.normal(size=(12, 9, 2))
    if kind == "bilinear":  # integer data keeps the unpacked Bilinear
        x, y, z = np.arange(12), np.arange(9), np.arange(12 * 9 * 2).reshape(12, 9, 2)
    qs = (rng.uniform(x[0], x[-1], 50), rng.uniform(y[0], y[-1], 50))
    strat = {"bilinear": lambda m: m.Bilinear(), "bilinear_packed": lambda m: m.Bilinear(),
             "bicubic": lambda m: m.Bicubic().boundary("natural", "clamped").extrapolate(True),
             "bicubic node": lambda m: m.Bicubic().extrapolate(True),
             "nearest2d": lambda m: m.Nearest2D(extrapolate=True)}[kind]
    j = j2.Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x)).y(jnp.asarray(y)).strategy(
        strat(j2)).build()
    t = Interp2D.builder(z, device="cpu").x(x).y(y).strategy(strat(t2)).build()
    return j, t, qs


def case_nd(method):
    rng = np.random.default_rng(103)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 7)]
    data = rng.normal(size=(6, 5, 7, 2))
    bcs = ("natural", "not_a_knot", "clamped") if method == "cubic" else None

    def configure(b):
        b = b.points(*axes).method(method).extrapolate(True)
        return b.boundary(*bcs) if bcs else b

    j = configure(JND.builder(data)).build()
    t = configure(InterpND.builder(data, device="cpu")).build()
    return j, t, tuple(rng.uniform(a[0] - 0.1, a[-1] + 0.1, 50) for a in axes)


# codec name as the header says it -> the case that makes one
CODECS = {
    "linear": lambda: case_1d("linear"),
    "cubic": lambda: case_1d("cubic"),
    "nearest": lambda: case_1d("nearest"),
    "bilinear": lambda: case_2d("bilinear"),
    "bilinear_packed": lambda: case_2d("bilinear_packed"),
    "bicubic": lambda: case_2d("bicubic"),
    "bicubic node": lambda: case_2d("bicubic node"),
    "nearest2d": lambda: case_2d("nearest2d"),
    "interpnd linear": lambda: case_nd("linear"),
    "interpnd nearest": lambda: case_nd("nearest"),
    "interpnd cubic": lambda: case_nd("cubic"),
}


def header_of(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__header__"]).decode()), sorted(z.files)


def check_same_function(kind, written, read, qs, reader):
    """``read`` (loaded by ``reader``) has ``written``'s settings and
    evaluates ``written``'s function: equal for the step family (a
    selection), within 1e-12 of the scale otherwise."""
    jq = tuple(jnp.asarray(q) for q in qs)
    want = np_of(written.interp_array(*(jq if reader == "torch" else qs)))
    got = np_of(read.interp_array(*(qs if reader == "torch" else jq)))
    if kind.startswith("interpnd"):
        assert (read.method, read.extrapolates, read.bcs, read.layout) == (
            written.method, written.extrapolates, written.bcs, written.layout)
    else:
        assert read.strategy.extrapolates == written.strategy.extrapolates
    if kind in ("nearest", "nearest2d", "interpnd nearest"):
        np.testing.assert_array_equal(got, want)
    else:
        assert scaled(got, want) <= 1e-12


@pytest.mark.parametrize("kind", list(CODECS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, monkeypatch, kind):
    if kind == "bicubic node":
        from ndarray_interp_tpu import config as jconfig

        monkeypatch.setattr(jconfig, "bicubic_pack_max_elems", 10)
    j, _, qs = CODECS[kind]()
    p = tmp_path / "jax.npz"
    jcheckpoint.save(p, j)
    header, _ = header_of(p)
    assert header.get("strategy", header["kind"]) == kind.split()[0]
    back = checkpoint.load(p, device="cpu")
    assert type(back).__name__ == type(j).__name__
    if kind == "bicubic node":
        assert back.strategy.layout == "node"
        equal(back.strategy.rows, np.asarray(j.strategy.rows))
    check_same_function(kind, j, back, qs, "torch")


@pytest.mark.parametrize("kind", list(CODECS))
def test_port_checkpoint_loads_in_jax(tmp_path, monkeypatch, kind):
    if kind == "bicubic node":
        monkeypatch.setattr(tconfig, "bicubic_pack_max_elems", 10)
    j, t, qs = CODECS[kind]()
    p = tmp_path / "port.npz"
    checkpoint.save(p, t)
    jp = tmp_path / "jax.npz"
    jcheckpoint.save(jp, j)
    header, files = header_of(p)
    jheader, jfiles = header_of(jp)
    # the JAX package's keys and codec names
    assert files == jfiles
    assert header.keys() == jheader.keys()
    assert header.get("strategy") == jheader.get("strategy")
    if "strategy_meta" in header:
        assert header["strategy_meta"].keys() == jheader["strategy_meta"].keys()
        assert header["strategy_meta"].get("finite", True) is True
    back = jcheckpoint.load(p)
    assert type(back).__name__ == type(t).__name__
    check_same_function(kind, t, back, qs, "jax")
