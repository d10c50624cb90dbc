"""Runtime settings of the port.

Counterpart of ``ndarray_interp_tpu.config``, with the flags that mean
something on the GPU.  Both are read when an interpolator is built, so
changing one affects the builds that follow and no interpolator that
exists already.

Not ported, each on purpose:

* ``use_fused_kernel``: the port picks a kernel by the tensor's device (the
  kernel on a CUDA tensor, its plain version on a CPU one); a switch that
  turned the kernels off on the card would put the plain versions on the
  main path.
* ``use_native_host``: waits for the native host runtime (ROADMAP Queue 1,
  item 6).
* ``dense_build_max_n``: waits for PCR and the dense-operator build (Queue
  1, item 7).
* ``jit_const_cap_bytes`` and ``route_hygiene``: they guard compiled JAX
  programs against embedded tables (``utils/hygiene.py``); PyTorch compiles
  no program to embed a table in, so hygiene is not ported (Queue 1, item
  10).
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
