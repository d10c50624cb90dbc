"""Host wall time of NS1's ``itp(q)`` and of its ``torch.func.vmap``.

NS1: a 2,048-knot not-a-knot ``CubicSpline`` with extrapolation on
``linspace(0, 100)``, built on the card in float32 from a seed, at
1,000,000 queries: ``itp(q)`` (K1 once a call) and ``torch.func.vmap(itp)``
over the same queries as 16 rows (K1 once a call, where the kernels'
Functions have a ``vmap`` rule).

    python3 tools/call_wall.py [--root DIR]

``--root`` is a checkout whose ``ndarray_interp_tpu_torch`` is imported
(default: the one holding this script), so two commits can be compared on
one card in one call: run it on each checkout in turn, A B B A.  Prints one
line a call form: the checkout, the card, the per-call wall time (median
[min, max] of 7 synchronised passes of 20 calls) and K1's launches a call;
``vmap`` is reported as not run where the checkout's kernels refuse it.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_KNOTS, NQ, ROWS, CALLS, RUNS = 2048, 1_000_000, 16, 20, 7


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("call_wall: no CUDA card")
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(42)
    dev = torch.device("cuda")
    x = np.linspace(0.0, 100.0, N_KNOTS).astype(np.float32)
    v = rng.normal(size=N_KNOTS).astype(np.float32)
    itp = Interp1D.builder(v, device=dev).x(x).strategy(CubicSpline().extrapolate(True)).build()
    q = torch.as_tensor(rng.uniform(-1.0, 101.0, NQ).astype(np.float32), device=dev)
    forms = {"itp(q)": lambda: itp(q),
             f"vmap(itp) over {ROWS} rows": lambda: torch.func.vmap(itp)(q.reshape(ROWS, -1))}
    root = Path(args.root).resolve().name
    for name, fn in forms.items():
        try:
            fn()  # build the kernels, warm the caches
        except RuntimeError as err:
            print(f"NS1 {name}, root {root}; card {card}: not run ({str(err)[:80]})", flush=True)
            continue
        torch.cuda.synchronize()
        times = []
        before = ek.fused_eval_1d.launches
        for _ in range(RUNS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / CALLS)
        launches = (ek.fused_eval_1d.launches - before) / (RUNS * CALLS)
        print(f"NS1 {name}, {N_KNOTS:,} knots x {NQ:,} f32, root {root}; card {card}: "
              f"{np.median(times):.4f} [{min(times):.4f}, {max(times):.4f}] ms a call (host "
              f"wall, median [min, max] of {RUNS} passes of {CALLS}); K1 launches a call: "
              f"{launches:g}", flush=True)


if __name__ == "__main__":
    main()
