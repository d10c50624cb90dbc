"""Profiling helpers on ``torch.profiler``.

Counterpart of ``ndarray_interp_tpu.utils.profiling``:

* :func:`trace`: a context manager that writes a Chrome trace (loadable in
  Perfetto, ``chrome://tracing`` or TensorBoard's profiler plugin) of the
  enclosed block into a directory;
* :func:`annotate`: a named region, shown in the trace's timeline;
* :func:`device_memory_stats`: the CUDA caching allocator's counters.

The JAX ``trace(..., create_perfetto_link=True)`` has no counterpart here
(``torch.profiler`` serves no trace link): open the written file instead.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block, host and (with a CUDA device) card, into a
    ``<host>_<pid>.<ns>.pt.trace.json`` file in ``log_dir``::

        with profiling.trace("traces"):
            itp.interp_array(queries)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """A named region (a context manager or decorator) in the trace."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """The allocator's counters (``torch.cuda.memory_stats``) of ``device``
    (default: the current CUDA device); ``{}`` for the CPU or without a
    CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
