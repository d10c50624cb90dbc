"""Primitive operations: search, lerp, gather, tridiagonal solve (the
reference-order loop, the Thomas kernel's wrapper and PCR), the
double-float pairs (``df``), and the wrappers of the CUDA kernels
(``eval_kernels``, ``tail2d``, ``bank_eval``, ``bank_tail``, ``bigknots``,
``thomas_kernel``, ``eval_kernels_df``, ``eval_kernels_df2d``,
``eval_kernels_df_nd``, and ``cell_order``, the ordering ahead of K8, K9, K12,
K13 and K14), and ``partition``: the wrappers' placement rules over DTensor.
Every wrapper composes with ``torch.func`` (``vmap``, ``grad``) on both
devices.  Every kernel is an operator of the ``ndarray_interp`` namespace
(:func:`kernel_ops`): the f32/f64 kernels K1-K5, R1, R2a, R2b-R2d with R2n,
R2g, R3 and R3idx, the f64-grade K6-K15 and R4c, and ORD; so ``torch.compile``
traces the wrappers with each kernel one node of its graph."""

from .bank_eval import banked_eval, can_use_banked
from .bank_tail import banked_hermite_tail, gathered_bank_eval
from .bigknots import MAX_BIG_KNOTS, big_eval_1d, big_lower_index_frac, can_use_big
from .cell_order import order_by_cell
from .eval_kernels import (
    fused_cell_index,
    fused_eval_1d,
    fused_index_frac,
    fused_lower_index,
    make_interval_table,
)
from .eval_kernels_df import (
    fused_eval_1d_df,
    fused_index_frac_df,
    gathered_df_tail,
    gathered_f48_tail,
)
from .eval_kernels_df2d import (
    gathered_bicubic_df_tail,
    gathered_bicubic_df_weight_tail,
    gathered_bicubic_f48_tail,
    gathered_bicubic_node_df_tail,
    gathered_bilinear_df_tail,
    gathered_bilinear_f48_tail,
)
from .eval_kernels_df_nd import nd_df_tail, nd_f48_tail
from .lerp import calc_frac
from .pcr import pcr_solve
from .searchsorted import get_lower_index, is_in_range, lower_index_fast
from .tail2d import (
    bicubic_gathered_eval,
    bicubic_nested_tail,
    bicubic_tree_tail,
    bilinear_gathered_eval,
    bilinear_grid_eval,
)
from .thomas import thomas_solve
from .thomas_kernel import thomas_solve_fast

__all__ = [
    "MAX_BIG_KNOTS",
    "banked_eval",
    "banked_hermite_tail",
    "bicubic_gathered_eval",
    "bicubic_nested_tail",
    "bicubic_tree_tail",
    "big_eval_1d",
    "big_lower_index_frac",
    "bilinear_gathered_eval",
    "bilinear_grid_eval",
    "calc_frac",
    "can_use_banked",
    "can_use_big",
    "fused_cell_index",
    "fused_eval_1d",
    "fused_eval_1d_df",
    "fused_index_frac",
    "fused_index_frac_df",
    "fused_lower_index",
    "gathered_bank_eval",
    "gathered_bicubic_df_tail",
    "gathered_bicubic_df_weight_tail",
    "gathered_bicubic_f48_tail",
    "gathered_bicubic_node_df_tail",
    "gathered_bilinear_df_tail",
    "gathered_bilinear_f48_tail",
    "gathered_df_tail",
    "gathered_f48_tail",
    "get_lower_index",
    "is_in_range",
    "lower_index_fast",
    "make_interval_table",
    "nd_df_tail",
    "nd_f48_tail",
    "order_by_cell",
    "pcr_solve",
    "thomas_solve",
    "thomas_solve_fast",
]


def kernel_wrappers():
    """The wrapper of every CUDA kernel, by the id the docs give it; each
    has a ``launches`` count.  K15's two grades have a wrapper each; "ORD"
    is the ordering of a batch by cell ahead of K12, K13, K14, R4c and R2n,
    and by interval ahead of K8 and K9 (no TPU twin); "R2g" is R2b's
    function on the grid, the ``Bilinear`` path's tail."""
    return {
        "K1": fused_eval_1d,
        "K2": fused_index_frac,
        "K3": fused_lower_index,
        "K4": thomas_solve_fast,
        "K5": banked_eval,
        "K6": fused_eval_1d_df,
        "K7": fused_index_frac_df,
        "K8": gathered_df_tail,
        "K9": gathered_f48_tail,
        "K10": gathered_bilinear_df_tail,
        "K11": gathered_bilinear_f48_tail,
        "K12": gathered_bicubic_df_tail,
        "K13": gathered_bicubic_f48_tail,
        "K14": gathered_bicubic_node_df_tail,
        "K15": nd_df_tail,
        "K15f48": nd_f48_tail,
        "R2a": banked_hermite_tail,
        "R3": big_eval_1d,
        "R3idx": big_lower_index_frac,
        "R1": fused_cell_index,
        "R2b": bilinear_gathered_eval,
        "R2g": bilinear_grid_eval,
        "R2c": bicubic_gathered_eval,
        "R2d": bicubic_tree_tail,
        "R2n": bicubic_nested_tail,
        "R4c": gathered_bicubic_df_weight_tail,
        "ORD": order_by_cell,
    }


def kernel_ops():
    """The operator behind each kernel's wrapper, by the name it has in
    ``torch.ops.ndarray_interp`` (``_cuda.kernel_op``): K1 ``fused_eval_1d``,
    K2 ``fused_index_frac``, K3 ``fused_lower_index``, R1
    ``fused_cell_index``, K4 ``thomas_solve`` (both forms), K5
    ``banked_eval``, R2a ``gathered_bank_eval`` (the packed route: the table,
    then R2a), R3 ``big_eval_1d``, R3idx ``big_lower_index_frac``, R2b, R2c,
    R2d and R2n ``cell_tail`` (its ``form`` argument) and R2g
    ``bilinear_grid_eval``; K6 ``fused_eval_1d_df`` and, in its float64 store
    form, ``fused_eval_1d_df_f64``, K7 ``fused_index_frac_df``, K8 and K9
    ``df_bank_tail`` (its ``grade``) and ``df_bank_tail_f64``, K10-K14 and
    R4c ``df_cell_tail`` (its ``form``) and ``df_cell_tail_f64``, K15 at both
    grades ``df_nd_tail``, and ORD ``order_by_cell``.  Each value is the
    ``OpOverload``."""
    from . import (bank_eval, bank_tail, bigknots, cell_order, eval_kernels, eval_kernels_df,
                   eval_kernels_df2d, eval_kernels_df_nd, tail2d, thomas_kernel)

    kops = (eval_kernels._EVAL_1D, eval_kernels._INDEX_FRAC, eval_kernels._LOWER_INDEX,
            eval_kernels._CELL_INDEX, thomas_kernel._THOMAS, bank_eval._BANKED,
            bank_tail._GATHERED, bigknots._BIG_EVAL, bigknots._BIG_INDEX_FRAC, tail2d._TAIL,
            tail2d._GRID_TAIL, eval_kernels_df._EVAL, eval_kernels_df._EVAL_F64,
            eval_kernels_df._INDEX_FRAC, eval_kernels_df._BANK_TAIL,
            eval_kernels_df._BANK_TAIL_F64, eval_kernels_df2d._TAIL, eval_kernels_df2d._TAIL_F64,
            eval_kernels_df_nd._TAIL, cell_order._ORDER)
    return {k.op._opname: k.op for k in kops}
