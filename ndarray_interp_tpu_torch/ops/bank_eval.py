"""Wide-bank evaluation at per-query ``(idx, t)``: the wrapper of K5.

Counterpart of ``ndarray_interp_tpu.ops.pallas_bank``.  The CUDA kernel is
in ``csrc/bank_kernels.cu``; :func:`_gather_form` is its plain PyTorch
version (the JAX package's gather formulation, ``pallas_bank.py:169-179``).
A CPU tensor takes the plain version, a CUDA tensor launches K5; the two are
bit-identical.  ``banked_eval.launches`` counts the kernel's launches.  Its
``vmap`` and placement rules are the JAX package's (``ops/partition.py``).
The TPU kernel's one-hot select poisons a whole bank lane on one NaN datum
(``pallas_bank.py:22-25``); K5 loads its rows, so NaN stays in the intervals
that touch it, and the JAX package's ``finite`` hint has no counterpart.
"""

from __future__ import annotations

import torch

from . import _cuda
from .bigknots import MAX_BIG_KNOTS

# The bank route's rule, from the card's times (NVIDIA H100 80GB HBM3, 700.00 W;
# ``tools/route_phases.py --sweeps`` rule 1, PERF.md PR 24): f32 banks of 4 to
# 262,144 knots x 1 to 1,000,000 splines at 256 to 1,048,576 queries, each
# route through ``Interp1D`` by CUDA events, 183 shapes.  K5 won wherever the
# packed route (K2 or R3idx, the per-call pack, R2a) had to pack a table for
# few queries a knot, so it has no bank bound and no knot bound of its own
# (the long axis's, ``MAX_BIG_KNOTS``, stays); the packed route won in two
# corners: narrow banks (under 32 splines, where K5's 256-column tile runs
# mostly idle) at >= 8 queries a knot and >= 2^20 outputs
# (10,000 x 8 at 1M queries: 0.0655 against K5's 0.0989 ms), and long, wide
# banks read by >= 100 queries a knot (10,000 x 1,024 at 1M: 2.99 against 3.76),
# where R2a's 16-byte rows win once the pack is paid back.  With this rule the
# pick was within 6% of the faster route at every shape of the sweep.  The JAX
# package's bounds (2,048 knots, 256 splines, a TPU cost model) put the bank
# eval's 10,000 x 64 on the packed route (0.0817 against K5's 0.0539 ms).
_NARROW_BANK = 32  # banks narrower than this take the packed route
_NARROW_QUERIES_PER_KNOT = 8  # at this many queries a knot
_NARROW_OUTPUTS = 1 << 20  # and this many (query, spline) outputs
_PACK_MIN_BANK = 256  # wider banks take it from this width,
_PACK_MIN_KNOTS = 4096  # on axes of at least this many knots,
_PACK_MIN_QUERIES_PER_KNOT = 100  # read by at least this many queries a knot


def can_use_banked(x, data) -> bool:
    """Shape and dtype eligibility of the K5 route: float32 banks of any
    width on 4 to ``MAX_BIG_KNOTS`` knots."""
    return data.dtype == torch.float32 and data.ndim >= 2 and 4 <= x.shape[0] <= MAX_BIG_KNOTS


def banked_pays(n, bank, nq) -> bool:
    """Whether K5 beats the packed-row route (K2 or R3idx, the per-call
    pack and R2a) for an eligible bank of ``n`` knots and ``bank`` splines
    at ``nq`` queries: everywhere but on narrow banks with many outputs and
    on long, wide banks whose knots are each read by many queries."""
    if bank < _NARROW_BANK:
        return not (nq >= _NARROW_QUERIES_PER_KNOT * n and nq * bank >= _NARROW_OUTPUTS)
    return not (bank >= _PACK_MIN_BANK and n >= _PACK_MIN_KNOTS
                and nq >= _PACK_MIN_QUERIES_PER_KNOT * n)


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
    """Forward: K5 (:func:`_gather_form` on the CPU).  Backward: the VJP of
    :func:`_gather_form`, as the JAX package's ``_bwd``
    (``pallas_bank.py:186-196``); ``idx`` has no gradient.  Under ``vmap``
    batched ``idx``/``t`` flatten into one launch (the unbatched one
    broadcast, as the JAX package's ``partition.py:370-374`` does); batched
    tables take the plain version."""

    @staticmethod
    def forward(data, a, b, idx, t):
        return _cuda.run("banked_eval", t, _launch, _gather_form, data, a, b, idx, t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        data, a, b, idx, t = ctx.saved_tensors
        need = ctx.needs_input_grad
        gd, ga, gb, gt = _cuda.plain_vjp(
            lambda d_, a_, b_, t_: _gather_form(d_, a_, b_, idx, t_),
            (data, a, b, t), (need[0], need[1], need[2], need[4]), g,
        )
        return gd, ga, gb, None, gt

    @staticmethod
    def vmap(info, in_dims, data, a, b, idx, t):
        return _cuda.vmap_queries(_BankedEval.apply, _gather_form, info, in_dims,
                                  (data, a, b, idx, t), (3, 4))


def banked_eval(data, a, b, idx, t):
    """The symmetric Hermite form of a spline bank at per-query interval
    ``idx`` (int32) and fraction ``t``: data (n, *bank), a/b (n-1, *bank),
    idx/t (Q,).  Returns (Q, *bank).  CPU tensors: :func:`_gather_form`;
    CUDA: K5 (float32 or float64)."""
    return _cuda.apply(_BankedEval, data, a, b, idx, t)


banked_eval.launches = 0
