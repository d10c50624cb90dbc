"""Host-side helpers; ``checkpoint`` and ``profiling`` load on first use."""

from .device import default_device
from .monotonic import Monotonic, MonotonicKind, monotonic_prop

__all__ = [
    "Monotonic",
    "MonotonicKind",
    "checkpoint",
    "default_device",
    "monotonic_prop",
    "profiling",
]


def __getattr__(name):
    # lazy: checkpoint imports the interpolators, which import
    # utils.device and utils.monotonic, so an eager import here is circular
    if name in ("checkpoint", "profiling"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
