"""Interpolator serialization (save and load).

Counterpart of ``ndarray_interp_tpu.utils.checkpoint``, in its file format:
one ``.npz`` holding the arrays and a ``__header__`` JSON blob with the
structure, under the JAX package's keys and codec names (``linear``,
``cubic``, ``bilinear``, ``bicubic``, ``nearest``, ``nearest2d``,
``bilinear_packed``, ``custom:<module>.<qualname>``), so that a file written
by either package loads in the other.  Loading rebuilds without validation,
as ``new_unchecked`` does (``interp1d/mod.rs:356-365``).

* Tensors are saved from the host (``.detach().cpu()``); :func:`load` puts
  the arrays on the GPU unless ``device`` is named, as the builders do.
* Derived tables are not saved: ``BilinearPacked``'s rows and ``InterpND``'s
  corner and node tables are built again on load.  ``InterpND``'s layout is
  not saved either, so a forced node layout comes back as ``InterpND.build_state``'s
  default layout (the JAX package does the same).
* The port has no ``finite`` routing hint: it writes ``"finite": true``,
  which the JAX package reads, and ignores the key on load.
* Bicubic rows of the older ``(cells, 16r + 4)`` format (raw derivatives
  and the interval endpoints) are converted on load.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..models.interp1d import Interp1D
from ..models.interp2d import Interp2D
from ..models.interpnd import InterpND
from ..models.strategies.bicubic import BicubicStrategy
from ..models.strategies.bilinear import Bilinear, BilinearPacked
from ..models.strategies.cubic import CubicSplineStrategy
from ..models.strategies.linear import Linear
from ..models.strategies.step import Nearest, Nearest2D
from .device import default_device

# name -> (class, encode(strategy) -> (meta, arrays), decode(meta, arrays) -> strategy);
# the decoders get the arrays as tensors on the load's device
_STRATEGY_CODECS = {
    "linear": (
        Linear,
        lambda s: ({"extrapolate": s.extrapolates, "finite": True}, {}),
        lambda meta, arrs: Linear(extrapolate=meta["extrapolate"]),
    ),
    "cubic": (
        CubicSplineStrategy,
        lambda s: ({"mode": s.mode, "finite": True}, {"a": s.a, "b": s.b}),
        lambda meta, arrs: CubicSplineStrategy(arrs["a"], arrs["b"], meta["mode"]),
    ),
    "bilinear": (
        Bilinear,
        lambda s: ({"extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Bilinear(extrapolate=meta["extrapolate"]),
    ),
    "bicubic": (
        BicubicStrategy,
        lambda s: (
            {"extrapolate": s.extrapolates, "bc_x": s.bc_x, "bc_y": s.bc_y, "layout": s.layout},
            {"rows": s.rows},
        ),
        lambda meta, arrs: BicubicStrategy(
            _bicubic_rows_from_checkpoint(arrs["rows"]),
            extrapolate=meta["extrapolate"],
            bc_x=meta.get("bc_x", "not_a_knot"),
            bc_y=meta.get("bc_y", "not_a_knot"),
            layout=meta.get("layout", "cell"),
        ),
    ),
    "nearest": (
        Nearest,
        lambda s: ({"mode": s.mode, "extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Nearest(mode=meta["mode"], extrapolate=meta["extrapolate"]),
    ),
    "nearest2d": (
        Nearest2D,
        lambda s: ({"extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Nearest2D(extrapolate=meta["extrapolate"]),
    ),
    # the packed rows are derived state: only the setting is kept, and the
    # table is packed again from (x, y, data) on load
    "bilinear_packed": (
        BilinearPacked,
        lambda s: ({"extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Bilinear(extrapolate=meta["extrapolate"]),
    ),
}


def _bicubic_rows_from_checkpoint(rows):
    """Bicubic cell rows in the current ``(cells, 16r)`` format (derivatives
    pre-scaled by the cell's widths, no endpoints).  The older
    ``(cells, 16r + 4)`` rows hold raw derivatives and the four interval
    endpoints, from which the widths are recovered, so they convert exactly;
    other widths (and node rows, ``4r + 2``) pass unchanged."""
    w = rows.shape[1]
    if w % 16 != 4:
        return rows
    r = (w - 4) // 16
    dx = (rows[:, 16 * r + 1] - rows[:, 16 * r + 0])[:, None]
    dy = (rows[:, 16 * r + 3] - rows[:, 16 * r + 2])[:, None]
    return torch.cat(
        [
            rows[:, 0:4 * r],
            rows[:, 4 * r:8 * r] * dx,
            rows[:, 8 * r:12 * r] * dy,
            rows[:, 12 * r:16 * r] * (dx * dy),
        ],
        dim=1,
    )


def register_strategy_codec(name, cls, encode, decode):
    """Serialization for a custom strategy class.

    ``encode(strategy) -> (meta, arrays)`` (``meta`` JSON-serializable,
    ``arrays`` tensors or numpy arrays); ``decode(meta, arrays) ->
    strategy``, the arrays as tensors on the load's device.  Instead, a
    strategy class may define ``checkpoint_encode(self)`` and a classmethod
    ``checkpoint_decode(meta, arrays)``, which :func:`save` picks up."""
    _STRATEGY_CODECS[name] = (cls, encode, decode)


def _encode_strategy(strategy):
    for name, (cls, enc, _) in _STRATEGY_CODECS.items():
        if type(strategy) is cls:
            meta, arrs = enc(strategy)
            return name, meta, arrs
    # the class's own hook
    if hasattr(type(strategy), "checkpoint_encode"):
        cls = type(strategy)
        if cls.__module__ == "__main__" or "<locals>" in cls.__qualname__:
            raise TypeError(
                f"cannot auto-name a codec for {cls.__qualname__!r}: the "
                "class lives in __main__ or a function scope, so the saved "
                "name could never be resolved in a fresh process. Define "
                "the strategy in an importable module, or register an "
                "explicit codec via utils.checkpoint.register_strategy_codec"
            )
        name = f"custom:{cls.__module__}.{cls.__qualname__}"
        register_strategy_codec(name, cls, lambda s: s.checkpoint_encode(),
                                cls.checkpoint_decode)
        meta, arrs = strategy.checkpoint_encode()
        return name, meta, arrs
    raise TypeError(
        f"cannot serialize strategy {type(strategy).__name__}; register a "
        "codec via utils.checkpoint.register_strategy_codec or define "
        "checkpoint_encode/checkpoint_decode on the class"
    )


def _resolve_codec(sname, allow_custom_import=False):
    """The codec named ``sname``.

    A ``custom:`` name resolves its class from the modules already imported
    (``sys.modules``) and binds its ``checkpoint_encode`` /
    ``checkpoint_decode`` hooks.  Nothing is imported unless
    ``allow_custom_import``: importing a dotted path read from a file runs
    that module's top-level code, so an untrusted ``.npz`` could run code."""
    if sname in _STRATEGY_CODECS:
        return _STRATEGY_CODECS[sname]
    if not sname.startswith("custom:"):
        raise TypeError(f"unknown strategy codec {sname!r}")
    # the longest imported module prefix; the rest is the qualified name
    modname, _, qual = sname[len("custom:"):].rpartition(".")
    obj = None
    while modname:
        if modname in sys.modules:
            obj = sys.modules[modname]
            break
        if allow_custom_import:
            import importlib

            try:
                obj = importlib.import_module(modname)
                break
            except ImportError:
                pass
        modname, _, rest = modname.rpartition(".")
        qual = f"{rest}.{qual}"
    unresolved = TypeError(
        f"cannot resolve strategy class for {sname!r}: its module "
        "is not imported. Import the module defining the strategy "
        "(or call register_strategy_codec) before load(); or pass "
        "load(path, allow_custom_import=True) if you trust the "
        "checkpoint"
    )
    if obj is None:
        raise unresolved
    for part in qual.split("."):
        # a parent package can be imported while the defining submodule is not
        try:
            obj = getattr(obj, part)
        except AttributeError:
            raise unresolved from None
    register_strategy_codec(sname, obj, lambda s: s.checkpoint_encode(), obj.checkpoint_decode)
    return _STRATEGY_CODECS[sname]


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _header(header):
    return np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)


def save(path, interp) -> None:
    """Save an :class:`Interp1D`, :class:`Interp2D` or :class:`InterpND` to
    ``path`` (``.npz``; numpy appends the suffix when it is missing)."""
    if isinstance(interp, InterpND):
        # InterpND has no strategy object: its settings go in the header
        header = {
            "kind": "interpnd",
            "k": interp.k,
            "method": interp.method,
            "extrapolate": interp.extrapolates,
            "bcs": list(interp.bcs) if interp.bcs is not None else None,
        }
        arrays = {f"axis_{d}": _host(ax) for d, ax in enumerate(interp.axes)}
        arrays["data"] = _host(interp.data)
        np.savez(Path(path), **arrays, __header__=_header(header))
        return
    if isinstance(interp, Interp1D):
        header = {"kind": "interp1d"}
        arrays = {"x": _host(interp.x), "data": _host(interp.data)}
    elif isinstance(interp, Interp2D):
        header = {"kind": "interp2d"}
        arrays = {"x": _host(interp.x), "y": _host(interp.y), "data": _host(interp.data)}
    else:
        raise TypeError(f"cannot serialize {type(interp).__name__}")
    sname, smeta, sarrs = _encode_strategy(interp.strategy)
    header["strategy"] = sname
    header["strategy_meta"] = smeta
    for k, v in sarrs.items():
        arrays[f"strategy_{k}"] = _host(v)
    np.savez(Path(path), **arrays, __header__=_header(header))


def load(path, allow_custom_import=False, device=None):
    """Restore an interpolator without validation (``new_unchecked``).

    The arrays go to ``device`` (default: the GPU; raises without one, as
    the builders do).  A ``custom:`` strategy resolves its class from the
    modules already imported; ``allow_custom_import=True`` lets a trusted
    file import the module it names (an import runs module code: never for
    untrusted files)."""
    dev = default_device(None, device)
    p = Path(path)
    if not p.exists():  # np.savez appends .npz when it is missing
        p = Path(f"{path}.npz")
    with np.load(p) as z:
        header = json.loads(bytes(z["__header__"]).decode())

        def T(key):
            return torch.as_tensor(z[key], device=dev)

        if header["kind"] == "interpnd":
            k = header["k"]
            axes = tuple(T(f"axis_{d}") for d in range(k))
            data = T("data")
            bcs = header.get("bcs")
            bcs = tuple(bcs) if bcs is not None else None
            # the packed corner and node tables are derived state
            table, layout = InterpND.build_state(axes, data, k, header["method"], bcs)
            return InterpND.new_unchecked(axes, data, header["method"], header["extrapolate"],
                                          table, bcs, layout)
        _, _, dec = _resolve_codec(header["strategy"], allow_custom_import)
        sarrs = {k[len("strategy_"):]: T(k) for k in z.files if k.startswith("strategy_")}
        strategy = dec(header["strategy_meta"], sarrs)
        if header["kind"] == "interp1d":
            return Interp1D.new_unchecked(T("x"), T("data"), strategy)
        x, y, data = T("x"), T("y"), T("data")
        if isinstance(strategy, Bilinear):
            # the packed corner table and grid, where the build makes them
            strategy = Bilinear(strategy.extrapolates).build(x, y, data)
        return Interp2D.new_unchecked(x, y, data, strategy)
