"""R2b's and R2n's designs at NS3's and NS3b's shapes on one card.

The 2-D path's f32 tails at the JAX package's config-3 width (512 x 512 x
16, non-uniform axes, 1,000,000 queries, the inputs of ``chip_smoke.py``'s
2-D path): R2b (``Bilinear``) and R2n (``Bicubic``'s cell layout) behind
R1, each output held bit for bit against its plain version.

    python3 tools/tail2d_phases.py [--root DIR] [--sweeps]

``--root`` is a checkout whose ``ndarray_interp_tpu_torch`` is imported
(default: the one holding this script), so two commits can be compared on
one card in one call: run it on each checkout in turn, A B B A.  On a
checkout without the grid tail R2g it times the two tails as that
checkout's wrappers run them.  Otherwise it runs ``chip_smoke.py``'s design
phases: R2b's three bodies (``bilinear_designs``), R2n's phases
(``nested_designs``) and R2n's ordered phase (``ordered_phase``: the
ordering held and timed beside the first design and ``torch.argsort``, both
branches on the path's queries, on one cell and already in cell order);
``--sweeps`` adds R2b's grid past the L2 and R2n's crossover sweeps (r = 16
and a table of 8 channels).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


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
    xd, yd, zd, qxd, qyd = (torch.as_tensor(v.astype(np.float32), device=dev)
                            for v in (x, y, z, qx, qy))
    bil = Interp2D.builder(zd).x(xd).y(yd).build()
    bic = Interp2D.builder(zd).x(xd).y(yd).strategy(Bicubic()).build()
    rec = cs.Record()
    if not hasattr(t2, "bilinear_grid_eval"):
        cell, tx, ty = ek.fused_cell_index(bil.x, bil.y, qxd, qyd)
        rows, crows = bil.strategy.rows, bic.strategy.rows
        print("  the wrappers as this checkout runs them:", flush=True)
        cs.timed_designs("NS3 R2b", t2._bilinear_plain(rows, cell, qxd, qyd, r), {
            "R2b at NS3": ("R2b", lambda: t2.bilinear_gathered_eval(rows, cell, qxd, qyd, r))},
            20, rec)
        cs.timed_designs("NS3b R2n", t2._bicubic_nested_plain(crows, cell, tx, ty, r), {
            "R2n at NS3b": ("R2n", lambda: t2.bicubic_nested_tail(crows, cell, tx, ty, r))},
            5, rec)
    else:
        cs.bilinear_designs(dev, bil, qxd, qyd, card, rec, args.sweeps)
        cs.nested_designs(bic, qxd, qyd, card, rec)
        cell, tx, ty = ek.fused_cell_index(bic.x, bic.y, qxd, qyd)
        system = (f"NS3b cell table {'x'.join(map(str, cs.GRID2D))} f32, {cs.NQ2D:,} queries",
                  (bic.strategy.rows, cell, tx, ty, r))
        extra = [(f"cell table {nx}x{ny}x8 f32", (
            torch.randn(((nx - 1) * (ny - 1), 16 * 8), device=dev), cell, tx, ty, 8),
            cs.ORDER_SWEEP)] if args.sweeps else []
        cs.ordered_phase("R2n", system, card, rec, args.sweeps, extra)
    torch.cuda.synchronize()
    if cs.failures:
        sys.exit(f"tail2d_phases: {len(cs.failures)} failure(s)")


if __name__ == "__main__":
    main()
