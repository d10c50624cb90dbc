"""K5 on one card: ``chip_smoke.py``'s ``k5_phase`` alone.

At the paths' shapes (the bank eval, NS2b, NS1b's bank, NS5, NS5b) and the
bank route's two corners (10,000 x 8 and 10,000 x 1,024 at 1,000,000
queries) K5 is held bit for bit against ``_gather_form`` and timed beside
the bytes bound; then the geometry's edges (banks of 1, 3 and 8, tables off
16-byte alignment, float64) are held bit for bit.  Prints the registers and
spills of K5's and R2a's kernels from the build's ``-Xptxas=-v`` log.

    python3 tools/bank_phases.py [--root DIR] [--sweeps]

``--root`` is a checkout whose ``ndarray_interp_tpu_torch`` is imported
(default: the one holding this script), so two commits' K5 can be compared
on one card in one call: run it on each checkout in turn, A B B A.  On a
checkout without ``_k5_geometry`` (K5's first design) only the timed shapes
run.  ``--sweeps`` also times one to eight query rounds a block at every
shape.  Needs one CUDA card; exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--sweeps", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # its helpers import the port only when called
    import torch

    if not torch.cuda.is_available():
        sys.exit("bank_phases: no CUDA card")
    sys.path.insert(0, str(root))
    import ndarray_interp_tpu_torch as pkg
    from ndarray_interp_tpu_torch.ops import _cuda, bank_eval

    if Path(pkg.__file__).resolve().parent.parent != root:
        sys.exit(f"bank_phases: the port came from {pkg.__file__}, not from {root}")

    card = cs.card_line()
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    print(f"checkout {root}; card {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    entry = "?"
    for line in path.with_suffix(".so.log").read_text().splitlines():
        if "Function properties for" in line:
            entry = line.split("Function properties for", 1)[1].strip()
        elif ("registers" in line or "spill" in line) and (
                "bank_kernels_cu" in entry):
            print(f"  ptxas: {entry}: {line.strip()}", flush=True)
    dev, rec = torch.device("cuda", 0), cs.Record()
    if hasattr(bank_eval, "_k5_geometry"):
        keys = cs.k5_phase(dev, card, rec, args.sweeps)
    else:
        keys = cs.k5_times(dev, card, rec)
    print(keys, flush=True)
    if cs.failures:
        sys.exit(f"bank_phases: {len(cs.failures)} failure(s)")
    print(f"bank_phases: all bit-identical; {time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
