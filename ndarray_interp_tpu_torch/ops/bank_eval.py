"""Wide-bank evaluation at per-query ``(idx, t)``: the wrapper of K5.

Counterpart of ``ndarray_interp_tpu.ops.pallas_bank``.  The CUDA kernel is
in ``csrc/bank_kernels.cu``; :func:`_gather_form` is its plain PyTorch
version (the JAX package's gather formulation, ``pallas_bank.py:169-179``).
A CPU tensor takes the plain version, a CUDA tensor launches K5; the two are
bit-identical.  ``banked_eval.launches`` counts the kernel's launches.

Not ported: the JAX package's sharding wrapper (``ops/partition.py``).  The
TPU kernel's one-hot select poisons a whole bank lane on one NaN datum
(``pallas_bank.py:22-25``); K5 loads its rows, so NaN stays in the intervals
that touch it, and the JAX package's ``finite`` hint has no counterpart.
"""

from __future__ import annotations

import torch

from . import _cuda

# eligibility bounds of the JAX package (pallas_bank.py:43-44), kept so that
# both packages pick the same route
_MAX_KNOTS = 2048
_MIN_BANK = 256


def can_use_banked(x, data) -> bool:
    """Shape and dtype eligibility of the K5 route (``pallas_bank.py:202-212``)."""
    bank = 1
    for s in data.shape[1:]:
        bank *= s
    return (
        data.dtype == torch.float32
        and data.ndim >= 2
        and 4 <= x.shape[0] <= _MAX_KNOTS
        and bank >= _MIN_BANK
    )


def _gather_form(data, a, b, idx, t):
    """Plain version of K5: gather ``[y_l, y_r, a, b]`` rows at ``idx`` and
    evaluate the symmetric Hermite form.  data (n, *bank), a/b (n-1, *bank),
    idx (Q,) integer (clamped to ``[0, n-2]``, as a JAX gather clamps),
    t (Q,).  Returns (Q, *bank)."""
    tbl = torch.stack([data[:-1], data[1:], a, b], dim=-1)
    g = tbl[idx.long().clamp(0, data.shape[0] - 2)]
    y_l, y_r, ga, gb = (g[..., i] for i in range(4))
    te = t.reshape(tuple(t.shape) + (1,) * (data.ndim - 1))
    return (1 - te) * y_l + te * y_r + te * (1 - te) * (ga * (1 - te) + gb * te)


def _launch(data, a, b, idx, t):
    dtype = _cuda.float_operands("banked_eval", data, a, b, t)
    n = data.shape[0]
    bank_shape = tuple(data.shape[1:])
    if n < 2 or data.ndim < 2 or a.shape != (n - 1,) + bank_shape or b.shape != a.shape:
        raise ValueError(
            "banked_eval: data must be (n >= 2, *bank) and a, b (n-1, *bank); got "
            f"{tuple(data.shape)}, {tuple(a.shape)}, {tuple(b.shape)}"
        )
    if idx.dtype != torch.int32 or idx.device != t.device:
        raise TypeError(f"banked_eval: idx must be torch.int32 on {t.device}")
    if idx.ndim != 1 or idx.shape != t.shape:
        raise ValueError("banked_eval: idx and t must be flat and of one length")
    bank = data[0].numel()
    nq = idx.shape[0]
    out = torch.empty((nq, bank), dtype=dtype, device=t.device)
    _cuda.launch(
        "ndi_banked_eval", dtype, t.device,
        data.contiguous(), a.contiguous(), b.contiguous(), n - 1, bank,
        idx.contiguous(), t.contiguous(), out, nq,
    )
    banked_eval.launches += 1
    return out.reshape((nq,) + bank_shape)


class _BankedEval(torch.autograd.Function):
    """Forward: K5.  Backward: autograd of :func:`_gather_form`, as the JAX
    package's ``_bwd`` (``pallas_bank.py:186-196``) is its VJP; ``idx`` has
    no gradient."""

    @staticmethod
    def forward(ctx, data, a, b, idx, t):
        ctx.save_for_backward(data, a, b, idx, t)
        return _launch(data, a, b, idx, t)

    @staticmethod
    def backward(ctx, g):
        data, a, b, idx, t = ctx.saved_tensors
        need = ctx.needs_input_grad
        gd, ga, gb, gt = _cuda.plain_vjp(
            lambda d_, a_, b_, t_: _gather_form(d_, a_, b_, idx, t_),
            (data, a, b, t), (need[0], need[1], need[2], need[4]), g,
        )
        return gd, ga, gb, None, gt


def banked_eval(data, a, b, idx, t):
    """The symmetric Hermite form of a spline bank at per-query interval
    ``idx`` (int32) and fraction ``t``: data (n, *bank), a/b (n-1, *bank),
    idx/t (Q,).  Returns (Q, *bank).  CPU tensors: :func:`_gather_form`;
    CUDA: K5 (float32 or float64)."""
    if _cuda.kernel_device("banked_eval", t) == "cpu":
        return _gather_form(data, a, b, idx, t)
    return _BankedEval.apply(data, a, b, idx, t)


banked_eval.launches = 0
