"""Batched tridiagonal solve on the GPU: the wrapper of the Thomas kernel.

Counterpart of ``ndarray_interp_tpu.ops.pallas_thomas``.  The CUDA kernel
(``csrc/thomas_kernel.cu``) replaces both of its Pallas kernels, ``_kernel``
(shared diagonals) and ``_kernel_batched`` (per-column diagonals), in the
reference elimination order, bit-identical to the plain loop
:func:`.thomas.thomas_solve`.  With shared diagonals a first launch computes
the column-independent ``w``, ``mid'`` chain once; then a warp a block
sweeps 32 columns, its rows staged through shared memory, and keeps the
whole slice there when it fits.

On the TPU the JAX package solves the build by parallel cyclic reduction
(``ops/pcr.py``), which won on that chip.  On this card PCR in plain
PyTorch lost to this kernel at every shape ``chip_smoke.py``'s build-route
phase measured: in one run (the f32 not-a-knot build of a bank, the rhs
assembly, the solve and the coefficient pass; host wall in turns, median of
14 runs; NVIDIA H100 80GB HBM3, 700.00 W) 11.92 against 3.65 ms at 64 x
1,000,000, 6.00 against 2.10 at 256 x 16,384, 6.29 against 2.08 at 512 x
8,192, 7.59 against 2.11 at 2,048 x 4,096 and 9.38 against 2.75 at 10,000 x
64, where PCR's device busy time (0.81 ms) was below the kernel's (1.20)
but its host wall was not.  So a CUDA tensor always takes the kernel; ``ops/pcr.py`` stays as the JAX package's solver and the phase's
yardstick.
"""

from __future__ import annotations

import torch

from . import _cuda
from .thomas import thomas_solve


def _launch(a_up, a_mid, a_low, rhs):
    dtype = _cuda.float_operands("thomas_solve_fast", rhs, a_up, a_mid, a_low)
    n = rhs.shape[0]
    rhs2 = rhs.reshape(n, -1).contiguous()
    bank = rhs2.shape[1]
    per_column = any(d.ndim > 1 for d in (a_up, a_mid, a_low))
    if per_column:
        # one diagonal per column, laid out like rhs
        def diag(d):
            d = d.reshape(tuple(d.shape) + (1,) * (rhs.ndim - d.ndim))
            return d.expand(rhs.shape).reshape(n, bank).contiguous()
    else:
        def diag(d):
            return d.contiguous()
    a_up, a_mid, a_low = diag(a_up), diag(a_mid), diag(a_low)
    for d in (a_up, a_mid, a_low):
        if d.shape[0] != n:
            raise ValueError(
                f"thomas_solve_fast: diagonal of length {d.shape[0]}, rhs of {n}"
            )
    k = torch.empty_like(rhs2)
    # per column the swept diagonal mid'; shared, the chain's w and mid' once
    scratch = torch.empty_like(rhs2) if per_column else rhs2.new_empty((2, n))
    _cuda.launch(
        "ndi_thomas", dtype, rhs.device,
        a_up, a_mid, a_low, rhs2, k, scratch, n, bank, int(per_column),
    )
    thomas_solve_fast.launches += 1
    return k.reshape(rhs.shape)


def _backward(ctx, g):
    """The VJP of the plain loop, as the JAX package's ``_bwd``
    (``pallas_thomas.py:216``) takes the VJP of its scan solver."""
    return _cuda.plain_vjp(thomas_solve, ctx.saved_tensors, ctx.needs_input_grad, g)


def _vmap(op, info, in_dims, a_up, a_mid, a_low, rhs):
    """K4's batching rule: the batch of ``vmap`` as the trailing axis of the
    columns, one launch of ``op``: with the diagonals shared a batched right-hand side is more
    columns of the shared-diagonal form; a batched diagonal takes the
    per-column-diagonal form (``pallas_thomas.py:48``), the others
    broadcast to it.  The solution keeps the batch last."""
    size, diags = info.batch_size, (a_up, a_mid, a_low)
    *diag_dims, rhs_dim = in_dims
    ndim = rhs.ndim - (rhs_dim is not None)  # a sample's rhs dims
    rhs = rhs.movedim(rhs_dim, -1) if rhs_dim is not None else rhs.unsqueeze(-1)
    rhs = rhs.expand(tuple(rhs.shape[:-1]) + (size,))
    if any(d is not None for d in diag_dims):
        def column(d, bd):
            d = d.movedim(bd, -1) if bd is not None else d.unsqueeze(-1)
            return d.reshape(tuple(d.shape[:-1]) + (1,) * (ndim - d.ndim + 1) + (d.shape[-1],))

        diags = [column(d, bd) for d, bd in zip(diags, diag_dims)]
    return op(*diags, rhs), ndim


# K4: forward the kernel (the plain loop on the CPU); under vmap the batch
# becomes more columns of one launch (_vmap)
_THOMAS = _cuda.kernel_op(
    "thomas_solve", "(Tensor a_up, Tensor a_mid, Tensor a_low, Tensor rhs) -> Tensor",
    lambda a_up, a_mid, a_low, rhs: _cuda.run("thomas_solve_fast", rhs, _launch, thomas_solve,
                                              a_up, a_mid, a_low, rhs),
    lambda a_up, a_mid, a_low, rhs: rhs.new_empty(rhs.shape),
    setup_context=_cuda.save_inputs, backward=_backward, vmap=_vmap,
)


def thomas_solve_fast(a_up, a_mid, a_low, rhs):
    """Solve ``A k = rhs`` along axis 0 (shapes as :func:`.thomas.thomas_solve`).

    A CPU tensor takes the plain loop; a CUDA tensor launches the Thomas
    kernel (float32 or float64; other dtypes raise ``TypeError``).  Under
    ``torch.func.vmap`` the batch is solved in one launch."""
    return _THOMAS(a_up, a_mid, a_low, rhs)


thomas_solve_fast.launches = 0
