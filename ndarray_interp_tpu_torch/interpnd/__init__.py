"""Public N-D interpolation API: SciPy ``RegularGridInterpolator``'s
surface over the leading ``k`` axes of the data (beyond the reference,
which stops at 2-D, ``src/interp2d/mod.rs:29-32``)."""

from ..models.interpnd import InterpND, InterpNDBuilder

__all__ = ["InterpND", "InterpNDBuilder"]
