"""User-defined interpolation strategy: a nearest/step interpolator.

Port of the reference's extension-point demo (``examples/custom_strategy.rs``)
and of the JAX package's ``examples/custom_strategy.py``: a strategy built
only from the interpolator's public helpers (``get_index_left_of``,
``index_point``) and plugged into the builder.  Two equivalent styles:

* ``StepInterpolator``: pointwise, the literal analogue of the Rust example;
  the math for ONE query point, vectorized by :class:`PointwiseStrategy`
  with ``torch.func.vmap`` (so plain PyTorch operations and ``torch.where``,
  no Python branch on a value);
* ``StepInterpolatorBatched``: the math for the whole flat query batch.

Run: ``python -m ndarray_interp_tpu_torch.examples.custom_strategy`` (on the
GPU; ``main(device="cpu")`` runs it on the CPU).
"""

import numpy as np
import torch

from ndarray_interp_tpu_torch.interp1d import (
    Interp1D,
    Interp1DStrategy,
    Interp1DStrategyBuilder,
    PointwiseStrategy,
)


class StepInterpolator(PointwiseStrategy):
    """Nearest neighbour (midpoint step), written one point at a time
    (``custom_strategy.rs:38-53``)."""

    MINIMUM_DATA_LENGTH = 2
    # the Rust example never errors on out-of-range queries: it clamps
    extrapolates = True

    def eval_point(self, interp, x):
        idx = interp.get_index_left_of(x)
        x_left, data_left = interp.index_point(idx)
        x_right, data_right = interp.index_point(idx + 1)
        take_left = (x_right - x_left) / 2.0 > (x - x_left)
        return torch.where(take_left, data_left, data_right)


class StepInterpolatorBatched(Interp1DStrategy, Interp1DStrategyBuilder):
    """The same semantics, written for the whole query batch."""

    MINIMUM_DATA_LENGTH = 2
    extrapolates = True

    def build(self, x, data):
        return self

    def eval(self, interp, xq):
        idx = interp.get_index_left_of(xq).long()
        x_left = interp.x[idx]
        x_right = interp.x[idx + 1]
        take_left = (x_right - x_left) / 2.0 > (xq - x_left)
        return interp.data.index_select(0, torch.where(take_left, idx, idx + 1))


def main(device=None):
    """Both strategies on ``[2, 4, 5]`` at six queries; ``device`` as the
    builder takes it (the GPU unless named)."""
    data = np.array([2.0, 4.0, 5.0])
    query = np.linspace(-0.5, 2.5, 6)
    expect = np.array([2.0, 2.0, 4.0, 4.0, 5.0, 5.0])
    for strat in (StepInterpolator(), StepInterpolatorBatched()):
        interp = Interp1D.builder(data, device=device).strategy(strat).build()
        result = interp.interp_array(query).cpu().numpy()
        np.testing.assert_allclose(result, expect, atol=1e-15)
        print(f"{type(strat).__name__}: {result}")


if __name__ == "__main__":
    main()
