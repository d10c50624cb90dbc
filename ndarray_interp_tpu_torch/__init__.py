"""ndarray-interp-tpu on PyTorch and CUDA.

The PyTorch port of ``ndarray_interp_tpu`` (the JAX package, which stays the
reference).  Ported: the 1-D path (``Interp1D`` with ``Linear``,
``CubicSpline``, ``Akima``, ``Makima``, ``Pchip`` and ``Nearest``, on short
and long knot axes and wide banks), the 2-D path (``Interp2D`` with
``Bilinear``, ``Bicubic`` and ``Nearest2D``), both with calculus
(``derivative``, ``integrate``; ``solve``, ``roots`` in 1-D) and the
pointwise strategy adapters, the N-D path (``InterpND``: linear, nearest,
cubic, with ``derivative`` and ``integrate``), and their
serving layer (``serving``: ``Evaluator``, ``Evaluator2D``, ``EvaluatorND``
and the f64-grade ``DoubleFloatEvaluator``, ``DoubleFloatEvaluator2D`` and
``DoubleFloatEvaluatorND``), whose GPU kernels are hand-written CUDA for
Hopper (``csrc/``, built at first use); ``utils.checkpoint`` (save and
load, in the JAX package's file format), ``utils.profiling``, ``config``
(the layout caps, ``use_native_host``, ``dense_build_max_n``), ``native``
(the JAX package's C++ host runtime, built with ``g++`` at first import,
which serves the eager entry points' numpy and float queries) and
``eval_checked`` (a range check as device flags, ``CheckError``, that runs
inside a captured CUDA graph).  Tensors stay on the
device they are given; numpy or list inputs go to the GPU unless the
caller names ``device="cpu"`` (without a CUDA device and with none named,
the entry points raise).  On the CPU every kernel's plain PyTorch version
runs instead.

1-D usage::

    import numpy as np
    from ndarray_interp_tpu_torch.interp1d import Interp1D, CubicSpline

    itp = (
        Interp1D.builder(np.array([0.0, 1.0, 1.5, 1.0, 0.0]), device="cuda")
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )
    itp.interp_array(np.array([0.0, 0.5, 1.5]))

2-D usage::

    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D

    itp2 = (
        Interp2D.builder(np.random.default_rng(0).normal(size=(20, 16)), device="cuda")
        .strategy(Bicubic().extrapolate(True))
        .build()
    )
    itp2.interp_array(np.array([0.5, 3.25]), np.array([1.0, 7.5]))

N-D usage::

    from ndarray_interp_tpu_torch.interpnd import InterpND

    grid = np.random.default_rng(0).normal(size=(16, 12, 10))
    itp3 = InterpND.builder(grid, device="cuda").method("cubic").build()
    itp3.interp_array(np.array([0.5, 3.25]), np.array([1.0, 7.5]), np.array([2.0, 8.5]))
"""

from .errors import (
    BuilderError,
    CheckError,
    BuilderValueError,
    InterpolateError,
    MonotonicError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)

__version__ = "0.1.0"

__all__ = [
    "BuilderError",
    "BuilderValueError",
    "CheckError",
    "InterpolateError",
    "MonotonicError",
    "NotEnoughDataError",
    "OutOfBoundsError",
    "ShapeError",
    "interp1d",
    "interp2d",
    "interpnd",
]

from . import interp1d, interp2d, interpnd  # noqa: E402
