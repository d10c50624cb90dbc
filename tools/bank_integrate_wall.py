"""Host wall time of the 1-D bank ``integrate``, one call a bound pair.

The call of ``chip_smoke.py``'s calculus path: a 10,000-knot x 64 float64
bank built on the card (``Interp1D`` with ``CubicSpline``), then
``itp.integrate(lo, hi)`` for each of 4,096 bound pairs drawn from a seed.
Each call launches K3 (``fused_lower_index``) once on two queries, so this
times what a K3 launch costs the host, end to end.

    python3 tools/bank_integrate_wall.py [--root DIR]

``--root`` is a checkout whose ``ndarray_interp_tpu_torch`` is imported
(default: the one holding this script), so two commits can be compared on
one card in one call: run it on each checkout in turn, A B B A.  Prints one
line: the checkout, the card, the per-call wall time (median [min, max] of
7 timed passes over the 4,096 pairs, each pass synchronised) and
K3's launches a pass.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_KNOTS, BANK, N_BOUNDS, RUNS = 10_000, 64, 4096, 7


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bank_integrate_wall: no CUDA card")
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(50)
    dev = torch.device("cuda")
    x = torch.as_tensor(np.linspace(0.0, 1.0, N_KNOTS), device=dev)
    bank = torch.as_tensor(rng.normal(size=(N_KNOTS, BANK)), device=dev)
    itp = Interp1D.builder(bank).x(x).strategy(CubicSpline()).build()
    bounds = rng.uniform(0.0, 1.0, (N_BOUNDS, 2)).tolist()

    def one_pass():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo, hi in bounds:
            itp.integrate(lo, hi)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / N_BOUNDS

    one_pass()  # build the kernels, warm the caches
    before = ek.fused_lower_index.launches
    times = [one_pass() for _ in range(RUNS)]
    launches = (ek.fused_lower_index.launches - before) // RUNS
    print(f"bank integrate, {N_KNOTS:,} x {BANK} f64, {N_BOUNDS:,} calls, root "
          f"{Path(args.root).resolve().name}; card {card}: {np.median(times):.4f} "
          f"[{min(times):.4f}, {max(times):.4f}] ms a call (host wall, median [min, max] of "
          f"{RUNS} passes); K3 launches a pass: {launches}", flush=True)


if __name__ == "__main__":
    main()
