"""Batched tridiagonal solve on the GPU: the wrapper of the Thomas kernel.

Counterpart of ``ndarray_interp_tpu.ops.pallas_thomas``.  The CUDA kernel
(``csrc/thomas_kernel.cu``) replaces both of its Pallas kernels, ``_kernel``
(shared diagonals) and ``_kernel_batched`` (per-column diagonals), in the
reference elimination order, bit-identical to the plain loop
:func:`.thomas.thomas_solve`.  With shared diagonals a first launch computes
the column-independent ``w``, ``mid'`` chain once; then a warp a block
sweeps 32 columns, its rows staged through shared memory, and keeps the
whole slice there when it fits.

On the TPU the JAX package solves the build by parallel cyclic reduction,
which won on that chip; on this card the Thomas kernel is the build until a
measurement of the alternatives says otherwise.
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


class _ThomasKernel(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain loop, as the
    JAX package's ``_bwd`` (``pallas_thomas.py:216``) takes the VJP of its
    scan solver."""

    @staticmethod
    def forward(ctx, a_up, a_mid, a_low, rhs):
        ctx.save_for_backward(a_up, a_mid, a_low, rhs)
        return _launch(a_up, a_mid, a_low, rhs)

    @staticmethod
    def backward(ctx, g):
        return _cuda.plain_vjp(thomas_solve, ctx.saved_tensors, ctx.needs_input_grad, g)


def thomas_solve_fast(a_up, a_mid, a_low, rhs):
    """Solve ``A k = rhs`` along axis 0 (shapes as :func:`.thomas.thomas_solve`).

    A CPU tensor takes the plain loop; a CUDA tensor launches the Thomas
    kernel (float32 or float64; other dtypes raise ``TypeError``)."""
    if _cuda.kernel_device("thomas_solve_fast", rhs) == "cpu":
        return thomas_solve(a_up, a_mid, a_low, rhs)
    return _ThomasKernel.apply(a_up, a_mid, a_low, rhs)


thomas_solve_fast.launches = 0
