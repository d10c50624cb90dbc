"""Error taxonomy, shared with the JAX package ``ndarray_interp_tpu.errors``.

Two families, as in the reference crate (``src/lib.rs:126-146``):

* ``BuilderError { NotEnoughData, Monotonic, ShapeError, ValueError }`` —
  raised while constructing an interpolator.
* ``InterpolateError::OutOfBounds`` — raised while evaluating.

Each variant is a subclass, so callers can catch the broad category
(``BuilderError``) or the precise variant (``NotEnoughDataError``).  The
messages are the JAX package's, word for word.

These exceptions come from the eager entry points only (``interp``,
``interp_array``, the builder's ``build()``).  ``Interp1D.__call__`` masks
out-of-range results to NaN instead, so it never synchronises with the
device; ``eval_checked`` returns a :class:`CheckError`, the port's form of
the JAX package's ``checkify`` error, whose flags stay on the device until
it is read.
"""

from __future__ import annotations


class BuilderError(Exception):
    """Errors during interpolator creation (``src/lib.rs:127-139``)."""


class NotEnoughDataError(BuilderError):
    """Insufficient data for the chosen interpolation strategy."""


class MonotonicError(BuilderError):
    """An interpolation axis is not strictly monotonic rising."""


class ShapeError(BuilderError):
    """Axis/data/boundary shape mismatch."""


class BuilderValueError(BuilderError):
    """Invalid value combination (e.g. periodic data with first != last)."""


class InterpolateError(Exception):
    """Errors during interpolation (``src/lib.rs:141-146``)."""


class OutOfBoundsError(InterpolateError):
    """A query point lies outside the knot range and extrapolation is off."""


class CheckError:
    """The error half of ``eval_checked``'s ``(error, values)``: the port's
    form of a ``jax.experimental.checkify`` error.

    It holds, in the order they were checked, ``(flag, message)`` pairs
    whose flag is a device ``bool`` tensor set where the check failed.
    Making it reads nothing back, so ``eval_checked`` runs inside a captured
    CUDA graph; after a replay the same object reads the replay's flags.
    """

    def __init__(self, checks=()):
        self._checks = tuple(checks)

    def get(self):
        """The message of the first failed check, or ``None`` (one copy of
        the flags to the host)."""
        if not self._checks:
            return None
        import torch

        failed = torch.stack([flag.reshape(()) for flag, _ in self._checks]).tolist()
        for bad, (_, message) in zip(failed, self._checks):
            if bad:
                return message
        return None

    def throw(self):
        """Raise ``OutOfBoundsError`` with the first failed check's message;
        nothing when every check held."""
        message = self.get()
        if message is not None:
            raise OutOfBoundsError(message)

    def __repr__(self):
        return f"CheckError({len(self._checks)} check(s))"
