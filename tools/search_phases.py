"""The designs of K1, R1, K2, R3, R3idx and K6 on the staged search, on one card.

Runs ``chip_smoke.py``'s search phases alone: ``k1_phase`` (the fused 1-D
eval on 2 to 70,001 knots and 2 to 1,000,000 queries, by shared-memory
budget and by row read, beside the first design: one knot staged, every
level of the search on the global axis, six scalar loads a row),
``r1_phase`` (the 2-D cell search on 2 x 2 to 70,001 x 33 knots, by budget,
beside the first design), ``k2_phase`` (the ``(idx, t)`` search at the
paths' shapes, 64 to 10,240 knots, and at 2 and 70,001, by budget, beside
its first design, a thread a query on the global search), ``r3_phase``
(the long-axis eval at 65,537, 262,144 and 8,388,480 knots, by budget,
beside its first design, 512 sorted leaders), ``r3idx_phase`` (the
long-axis ``(idx, t)`` search at R3's shapes, by budget, beside its first
design), f32 and f64, and ``k6_phase`` (the scalar double-float eval on
4,096, 20,000 and 70,001 knots at 2^20 queries, by budget, in both store
forms, beside its first design, a thread a query on the global
pairs), every output held bit for bit against its plain version.

    python3 tools/search_phases.py [--sweeps] [--phases k1,r1,k2,r3,r3idx,k6]

``--sweeps`` adds K1's tree from 16 to 64 KB at 70,001 and 262,144 knots,
R1's budget at 8,192 x 8,192 and 70,001 x 33 knots, K2's tree from 16 to
128 KB past 8,191 knots, R3's and R3idx's at 262,144 and 8,388,480 knots,
R3idx on float32 axes of 98,304 to 196,608 knots and K6's leaders at 4,096
knots: the data behind the wrappers' budgets.
``--phases`` runs only the phases named.
Needs one CUDA card; exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", action="store_true")
    ap.add_argument("--phases", default="k1,r1,k2,r3,r3idx,k6")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # its helpers import the port only when called
    import torch

    if not torch.cuda.is_available():
        sys.exit("search_phases: no CUDA card")
    from ndarray_interp_tpu_torch.ops import _cuda

    card = cs.card_line()
    t0 = time.perf_counter()
    _cuda.library()
    print(f"card {card}; kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    rec = cs.Record()
    # a yardstick across calls: K3 at NS1's shape, code no design here touches
    import numpy as np

    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(57)
    kn = cs.make_knots(2048, "nonuniform", np.float32, rng)
    k = torch.as_tensor(kn, device=dev)
    q = torch.as_tensor(rng.permutation(cs.make_queries(kn, 1_000_000, np.float32, rng)),
                        device=dev)
    print(f"K3 at 2,048 knots x 1,000,000 f32 (the wrapper's tree): "
          f"{cs.fmt(cs.device_ms(lambda: ek.fused_lower_index(k, q), 50))}", flush=True)
    phases = {"k1": cs.k1_phase, "r1": cs.r1_phase, "k2": cs.k2_phase, "r3": cs.r3_phase,
              "r3idx": cs.r3idx_phase, "k6": cs.k6_phase}
    for name in args.phases.split(","):
        phases[name](dev, card, rec, args.sweeps)
    if cs.failures:
        sys.exit(f"search_phases: {len(cs.failures)} failure(s)")
    print(f"search_phases: all bit-identical; {time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
