"""Runtime settings of the port.

Counterpart of ``ndarray_interp_tpu.config``, with the flags that mean
something on the GPU.  Each is read when an interpolator is built (or, for
``use_native_host``, when its host state is first made), so changing one
affects the builds that follow and no interpolator that exists already.

Not ported, each on purpose:

* ``use_fused_kernel``: the port picks a kernel by the tensor's device (the
  kernel on a CUDA tensor, its plain version on a CPU one); a switch that
  turned the kernels off on the card would put the plain versions on the
  main path.
* ``jit_const_cap_bytes`` and ``route_hygiene``: they guard compiled JAX
  programs against embedded tables (``utils/hygiene.py``); PyTorch compiles
  no program to embed a table in, so hygiene is not ported (ROADMAP Queue 1,
  item 10).
"""

from __future__ import annotations

#: The largest ``Bicubic`` cell table, in elements: ``(nx-1)(ny-1)·16r``.
#: The cell layout stores each cell's 16-value corner state (about 16 times
#: the grid's memory) so that a query fetches one row; a grid whose table
#: would be larger is built on the node layout (``4r + 2`` values a node,
#: about a quarter of the memory, four fetches a query).  Default 128 Mi
#: elements, the JAX package's.
bicubic_pack_max_elems: int = 128 * 1024 * 1024

#: The largest ``InterpND`` packed table, in elements.  ``"linear"`` packs
#: the ``2^k`` corners of each cell in one row (``2^k`` times the data's
#: memory) up to this size and gathers the corners from the data above it;
#: ``"cubic"`` takes the cheapest layout whose table fits (the ``"node"``
#: layout always does).  Default 128 Mi elements, the JAX package's.
interpnd_pack_max_elems: int = 128 * 1024 * 1024

#: Serve the eager entry points' numpy and float queries (``interp_scalar``,
#: ``interp_into``, ``interp_array``, ``interp_array_into`` of ``Interp1D``
#: and ``Interp2D``) on the native host runtime (``native/``) when it is
#: built and the strategy has a host form, as the JAX package does.  Off:
#: every query takes the tensor path (on a CUDA interpolator, the card).
use_native_host: bool = True

#: The largest knot count for the dense-operator spline build on a CUDA
#: tensor (``models/strategies/cubic.py``, ``_dense_build_ok``): for one
#: shared knot axis and a uniform boundary family the build ``data -> (a,
#: b)`` is linear, so it is probed once on an identity bank and applied to
#: the bank as one ``torch.matmul`` at full float32.  Only float32
#: not-a-knot banks take it, the family ``chip_smoke.py``'s build-route phase
#: measures; a CPU tensor never does.  64, not the JAX package's 512: the
#: phase measured the whole build faster dense only at 64 knots (NS5b); at
#: 256 and 512 knots the Thomas kernel and its assembly tied or won.  0
#: turns the route off.
dense_build_max_n: int = 64
