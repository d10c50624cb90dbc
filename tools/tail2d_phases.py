"""The bicubic cell tails R2c, R2d and R2n (and R2b's designs) at NS3b's and
NS3's shapes on one card.

The 2-D path's tails at the JAX package's config-3 width (512 x 512 x 16,
non-uniform axes, 1,000,000 queries, the inputs of ``chip_smoke.py``'s 2-D
path) behind R1, each output held bit for bit against its plain version.

    python3 tools/tail2d_phases.py [--root DIR] [--sweeps]

``--root`` is a checkout whose ``ndarray_interp_tpu_torch`` is imported
(default: the one holding this script), so two commits can be compared on
one card in one call: run it on each checkout in turn, A B B A.  On any
checkout it times R2c's, R2d's and R2n's wrappers held in query order (the
body the wrappers run below the ordering rule): at NS3b's 1,000,000 queries
in f32 and f64, at its first 2^17 queries, and on a table of 8 channels.
On a checkout whose three tails order their batches it then runs
``chip_smoke.py``'s design phases: R2b's three bodies
(``bilinear_designs``), each bicubic tail's phases (``cell_tail_designs``)
and its ordered phase (``ordered_phase``: the ordering held and timed
beside the first design and ``torch.argsort``, both branches on the path's
queries, on one cell and already in cell order); ``--sweeps`` adds R2b's
grid past the L2 and the crossover sweeps (r = 16 and a table of 8
channels).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def query_order(cs, t2, tables, card, rec):
    """R2c's, R2d's and R2n's wrappers forced into query order on each of
    ``tables`` ({label: (rows, cell, tx, ty, r)}), held bit for bit against
    their plain versions and timed in turn by CUDA events."""
    orders = t2._orders
    tails = {"R2c": (t2.bicubic_gathered_eval, t2._bicubic_weight_plain),
             "R2d": (t2.bicubic_tree_tail, t2._bicubic_tree_plain),
             "R2n": (t2.bicubic_nested_tail, t2._bicubic_nested_plain)}
    t2._orders = lambda *_: False
    try:
        for label, args in tables.items():
            print(f"  query order, {label} (card {card}):", flush=True)
            for kid, (kernel, plain) in tails.items():
                cs.timed_designs(f"{kid} {label}", plain(*args),
                                 {f"{kid} in query order": (kid, lambda k=kernel: k(*args))},
                                 20 if args[1].shape[0] <= 131_072 else 5, rec)
    finally:
        t2._orders = orders


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--sweeps", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # its helpers import the port only when called

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("tail2d_phases: no CUDA card")
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.ops import _cuda
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    card = cs.card_line()
    t0 = time.perf_counter()
    _cuda.library()
    print(f"root {Path(args.root).resolve().name}; card {card}; kernel build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    nx, ny, r = cs.GRID2D
    rng = np.random.default_rng(44)  # the 2-D path's inputs
    x = cs.f32(cs.make_knots(nx, "nonuniform", np.float64, rng))
    y = cs.f32(cs.make_knots(ny, "nonuniform", np.float64, rng))
    z = cs.f32(rng.normal(size=cs.GRID2D))
    qx = cs.f32(rng.uniform(x[0], x[-1], cs.NQ2D))
    qy = cs.f32(rng.uniform(y[0], y[-1], cs.NQ2D))
    rec = cs.Record()
    built = {}
    for dt in (torch.float32, torch.float64):
        xd, yd, zd, qxd, qyd = (torch.as_tensor(v, dtype=dt, device=dev)
                                for v in (x, y, z, qx, qy))
        bic = Interp2D.builder(zd).x(xd).y(yd).strategy(Bicubic()).build()
        built[dt] = (bic, qxd, qyd, ek.fused_cell_index(bic.x, bic.y, qxd, qyd))
    bic, qxd, qyd, (cell, tx, ty) = built[torch.float32]
    bic64, _, _, (c64, tx64, ty64) = built[torch.float64]
    shape = "x".join(map(str, cs.GRID2D))
    rows8 = torch.randn(((nx - 1) * (ny - 1), 16 * 8), device=dev,
                        generator=torch.Generator(dev).manual_seed(8))
    n17 = 2**17
    query_order(cs, t2, {
        f"NS3b {shape} f32, {cs.NQ2D:,} queries": (bic.strategy.rows, cell, tx, ty, r),
        f"NS3b {shape} f32, first {n17:,} queries": (bic.strategy.rows, cell[:n17], tx[:n17],
                                                     ty[:n17], r),
        f"{nx}x{ny}x8 f32, {cs.NQ2D:,} queries": (rows8, cell, tx, ty, 8),
        f"NS3b {shape} f64, {cs.NQ2D:,} queries": (bic64.strategy.rows, c64, tx64, ty64, r),
    }, card, rec)
    if "ndi_bicubic_seq_tail" not in t2._ORDERED:
        print("  this checkout orders no weight-form batch: query order only", flush=True)
    else:
        bil = Interp2D.builder(bic.data).x(bic.x).y(bic.y).build()
        cs.bilinear_designs(dev, bil, qxd, qyd, card, rec, args.sweeps)
        system = (f"NS3b cell table {shape} f32, {cs.NQ2D:,} queries",
                  (bic.strategy.rows, cell, tx, ty, r))
        extra = [(f"cell table {nx}x{ny}x8 f32", (rows8, cell, tx, ty, 8),
                  cs.ORDER_SWEEP)] if args.sweeps else []
        for kid in cs.CELL_TAILS:
            cs.cell_tail_designs(kid, bic, qxd, qyd, card, rec)
            cs.ordered_phase(kid, system, card, rec, args.sweeps, extra)
            cs.ordered_phase(kid, (f"NS3b cell table {shape} f64, {cs.NQ2D:,} queries",
                                   (bic64.strategy.rows, c64, tx64, ty64, r)), card, rec, False)
    torch.cuda.synchronize()
    if cs.failures:
        sys.exit(f"tail2d_phases: {len(cs.failures)} failure(s)")


if __name__ == "__main__":
    main()
