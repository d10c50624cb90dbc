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

from typing import NamedTuple

import torch

from . import _cuda
from .bigknots import MAX_BIG_KNOTS

# The bank route's rule is eligibility alone: K5 takes every float32 bank on
# 4 to ``MAX_BIG_KNOTS`` knots, and float64 banks take the packed route (K2 or
# R3idx, the per-call pack, R2a).  From the card's times (NVIDIA H100 80GB
# HBM3, 700.00 W; ``tools/route_phases.py --sweeps`` rule 1, PERF.md §6):
# f32 banks of 4 to 262,144 knots x 1 to 1,000,000 splines at 256 to 1,048,576
# queries, each route through ``Interp1D`` by CUDA events, 183 shapes.  K5 on
# its 16-byte lanes won at all of them, by 7.9% at the closest (3,000 x 1,024
# at 1M queries: 2.0379 against 2.1983 ms), the two corners where the packed
# route beat K5's first design included: narrow banks read by many queries a knot (10,000 x 8 at 1M:
# 0.0573 against 0.0658) and long, wide banks (4,096 x 1,024 at 1M: 2.0847
# against 2.2674; 10,000 x 1,024: 2.2278 against 2.9878).  The JAX package's
# bounds (2,048 knots, 256 splines, a TPU cost model) put the bank eval's
# 10,000 x 64 on the packed route.


def can_use_banked(x, data) -> bool:
    """The bank route's rule: K5 for float32 banks of any width on 4 to
    ``MAX_BIG_KNOTS`` knots, else the packed route."""
    return data.dtype == torch.float32 and data.ndim >= 2 and 4 <= x.shape[0] <= MAX_BIG_KNOTS


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
    data, a, b = data.contiguous(), a.contiguous(), b.contiguous()
    out = torch.empty((nq, bank), dtype=dtype, device=t.device)
    g = _k5_geometry(bank, data.element_size(), _aligned(data, a, b, out))
    _cuda.launch(
        "ndi_banked_eval", dtype, t.device, data, a, b, n - 1, bank,
        idx.contiguous(), t.contiguous(), out, nq, g.w, g.lanes, g.chunk,
    )
    banked_eval.launches += 1
    return out.reshape((nq,) + bank_shape)


class K5Geometry(NamedTuple):
    """K5's launch: ``w`` columns a lane (16-byte loads and stores where it
    is 4 in float32 or 2 in float64), ``lanes`` lanes a query (a power of
    two up to 32), so ``per_warp = 32 // lanes`` queries a warp and every
    warp of a 256-thread block works; ``chunk`` consecutive queries a block,
    which its threads take in rounds of ``256 // lanes``."""

    w: int
    lanes: int
    per_warp: int
    chunk: int


_K5_THREADS = 256
# A block's queries are its threads' rounds: two at 16 and 32 lanes a query,
# one below.  The card's times by rounds (one, two, four, eight), NVIDIA H100
# 80GB HBM3, 700.00 W, ``tools/bank_phases.py --sweeps`` (PERF.md §6): 32
# lanes, NS5 0.1339, 0.1246, 0.1268, 0.1320 ms and NS5b 0.6824, 0.6538,
# 0.6586, 0.7633; 16 lanes, NS2b 0.1357, 0.1301, 0.1294, 0.1308 and the bank
# eval 0.0390, 0.0384, 0.0387, 0.0392; 2 lanes, NS1b's bank 0.0468, 0.0473,
# 0.0487, 0.0501.
_K5_WIDE_LANES = 16
_K5_WIDE_ROUNDS = 2


def _k5_geometry(bank, itemsize, aligned) -> K5Geometry:
    """K5's launch for a bank of ``bank`` columns of ``itemsize`` bytes;
    ``aligned``: whether the three tables and the output start on 16-byte
    boundaries."""
    wide = 16 // itemsize
    w = wide if aligned and bank % wide == 0 else 1
    lanes = min(32, 1 << (bank // w - 1).bit_length())
    rounds = _K5_WIDE_ROUNDS if lanes >= _K5_WIDE_LANES else 1
    return K5Geometry(w, lanes, 32 // lanes, _K5_THREADS // lanes * rounds)


def _aligned(*tensors) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in tensors)


def _backward(ctx, g):
    """The VJP of :func:`_gather_form`, as the JAX package's ``_bwd``
    (``pallas_bank.py:186-196``); ``idx`` has no gradient."""
    data, a, b, idx, t = ctx.saved_tensors
    need = ctx.needs_input_grad
    gd, ga, gb, gt = _cuda.plain_vjp(
        lambda d_, a_, b_, t_: _gather_form(d_, a_, b_, idx, t_),
        (data, a, b, t), (need[0], need[1], need[2], need[4]), g,
    )
    return gd, ga, gb, None, gt


# K5: forward the kernel (_gather_form on the CPU); under vmap batched idx/t
# flatten into one launch (the unbatched one broadcast, as the JAX package's
# partition.py:370-374 does), batched tables take the plain version
_BANKED = _cuda.kernel_op(
    "banked_eval", "(Tensor data, Tensor a, Tensor b, Tensor idx, Tensor t) -> Tensor",
    lambda data, a, b, idx, t: _cuda.run("banked_eval", t, _launch, _gather_form,
                                         data, a, b, idx, t),
    lambda data, a, b, idx, t: data.new_empty((idx.shape[0],) + tuple(data.shape[1:])),
    setup_context=_cuda.save_inputs, backward=_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _gather_form, info, in_dims, args, (3, 4)),
)


def banked_eval(data, a, b, idx, t):
    """The symmetric Hermite form of a spline bank at per-query interval
    ``idx`` (int32) and fraction ``t``: data (n, *bank), a/b (n-1, *bank),
    idx/t (Q,).  Returns (Q, *bank).  CPU tensors: :func:`_gather_form`;
    CUDA: K5 (float32 or float64)."""
    return _BANKED(data, a, b, idx, t)


banked_eval.launches = 0
