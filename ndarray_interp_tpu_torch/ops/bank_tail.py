"""Bank-data evaluation on the packed route: one packed-row table, then the
Hermite tail of R2a.

Counterpart of ``pack_bank_rows``, ``banked_hermite_tail`` and
``gathered_bank_eval`` in ``ndarray_interp_tpu.ops.pallas_tail``.  The CUDA
kernel R2a (``csrc/bank_kernels.cu``) fetches each query's packed row
itself and evaluates the Hermite form; :func:`_tail_plain` is its plain
PyTorch version (an ``index_select`` of the rows and the form).  A CPU
tensor takes the plain version, a CUDA tensor launches R2a; the two are
bit-identical.  ``banked_hermite_tail.launches`` counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda


def pack_bank_rows(data2, a2, b2):
    """The packed per-interval row table ``(n-1, 4*bank_pad)``:
    ``[y_l | y_r | a | b]``, each channel padded with zeros to a multiple of
    8 columns (the JAX package's layout).  data2 (n, bank), a2/b2
    (n-1, bank)."""
    bank = data2.shape[1]
    pad = (0, -(-bank // 8) * 8 - bank)
    return torch.cat(
        [F.pad(data2[:-1], pad), F.pad(data2[1:], pad), F.pad(a2, pad), F.pad(b2, pad)],
        dim=1,
    )


def _tail_plain(packed, idx, t, bank):
    """Plain version of R2a: gather rows ``idx`` (clamped to the table, as
    the kernel clamps) and evaluate the symmetric Hermite form in the
    operation order of ``cubic_spline.rs:818-828``.  Returns (Q, bank)."""
    rows = packed.index_select(0, idx.long().clamp(0, packed.shape[0] - 1))
    bp = rows.shape[1] // 4
    te = t[:, None]
    y_l = rows[:, 0 * bp : 0 * bp + bank]
    y_r = rows[:, 1 * bp : 1 * bp + bank]
    a = rows[:, 2 * bp : 2 * bp + bank]
    b = rows[:, 3 * bp : 3 * bp + bank]
    return (1 - te) * y_l + te * y_r + te * (1 - te) * (a * (1 - te) + b * te)


def _launch_tail(packed, idx, t, bank):
    dtype = _cuda.float_operands("banked_hermite_tail", packed, t)
    if idx.dtype != torch.int32 or idx.device != t.device:
        raise TypeError(f"banked_hermite_tail: idx must be torch.int32 on {t.device}")
    if packed.ndim != 2 or packed.shape[1] % 4 or not 0 <= bank <= packed.shape[1] // 4:
        raise ValueError(
            "banked_hermite_tail: packed must have shape (rows, 4·bp) with "
            f"bp >= bank = {bank} >= 0, got {tuple(packed.shape)}"
        )
    if idx.ndim != 1 or idx.shape != t.shape:
        raise ValueError("banked_hermite_tail: idx and t must be flat and of one length")
    nq = idx.shape[0]
    out = torch.empty((nq, bank), dtype=dtype, device=t.device)
    packed = packed.contiguous()
    _cuda.launch(
        "ndi_bank_tail", dtype, t.device,
        packed, packed.shape[0], packed.shape[1], packed.shape[1] // 4, bank,
        idx.contiguous(), t.contiguous(), out, nq,
    )
    banked_hermite_tail.launches += 1
    return out


def banked_hermite_tail(packed, idx, t, bank):
    """Row ``idx`` of the :func:`pack_bank_rows` table for each query,
    evaluated at its fraction ``t``: the ``(Q, bank)`` result.  idx int32,
    t (Q,).  CPU tensors: :func:`_tail_plain`; CUDA: R2a, which gathers the
    rows itself (no gradient: differentiate through
    :func:`gathered_bank_eval`)."""
    if _cuda.kernel_device("banked_hermite_tail", t) == "cpu":
        return _tail_plain(packed, idx, t, bank)
    return _launch_tail(packed, idx, t, bank)


banked_hermite_tail.launches = 0


def _gather_form_2d(d2, a2, b2, idx, t):
    """The gather formulation of ``pallas_tail.py:524-536``: the same values
    as the packed route, and the function its backward differentiates."""
    i = idx.long()
    te = t[:, None]
    y_l, y_r, ga, gb = d2[:-1][i], d2[1:][i], a2[i], b2[i]
    return (1 - te) * y_l + te * y_r + te * (1 - te) * (ga * (1 - te) + gb * te)


def _launch_gathered(data2, a2, b2, idx, t):
    return _launch_tail(pack_bank_rows(data2, a2, b2), idx, t, data2.shape[1])


def _gathered_plain(data2, a2, b2, idx, t):
    """Plain version of the packed route: the table, then :func:`_tail_plain`."""
    return _tail_plain(pack_bank_rows(data2, a2, b2), idx, t, data2.shape[1])


def _backward(ctx, g):
    """The VJP of :func:`_gather_form_2d`, as the JAX package's ``_bwd``
    (``pallas_tail.py:545-555``); ``idx`` has no gradient."""
    data2, a2, b2, idx, t = ctx.saved_tensors
    need = ctx.needs_input_grad
    gd, ga, gb, gt = _cuda.plain_vjp(
        lambda d_, a_, b_, t_: _gather_form_2d(d_, a_, b_, idx, t_),
        (data2, a2, b2, t), (need[0], need[1], need[2], need[4]), g,
    )
    return gd, ga, gb, None, gt


# R2a behind its packed table: forward the table and R2a (_gathered_plain on
# the CPU); vmap as K5's (bank_eval)
_GATHERED = _cuda.kernel_op(
    "gathered_bank_eval", "(Tensor data2, Tensor a2, Tensor b2, Tensor idx, Tensor t) -> Tensor",
    lambda data2, a2, b2, idx, t: _cuda.run("gathered_bank_eval", t, _launch_gathered,
                                            _gathered_plain, data2, a2, b2, idx, t),
    lambda data2, a2, b2, idx, t: data2.new_empty((idx.shape[0], data2.shape[1])),
    setup_context=_cuda.save_inputs, backward=_backward,
    vmap=lambda op, info, in_dims, *args: _cuda.vmap_queries(
        op, _gathered_plain, info, in_dims, args, (3, 4)),
)


def gathered_bank_eval(data2, a2, b2, idx, t):
    """Banked Hermite evaluation at flat ``(idx, t)`` (from
    ``fused_index_frac`` or ``big_lower_index_frac``): one packed-row table,
    then :func:`banked_hermite_tail`.  data2 (n, bank), a2/b2 (n-1, bank);
    returns (Q, bank).  The backward is the VJP of :func:`_gather_form_2d`
    on both devices."""
    return _GATHERED(data2, a2, b2, idx, t)
