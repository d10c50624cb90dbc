"""The f64-grade, calculus and N-D part of ``chip_smoke.py``'s compile phase
alone, on one card.

Builds the slice's interpolators at the paths' full widths (no SciPy
oracles): the DF and f48 bank serving (10,240 knots x 64 at 2^20 queries),
the scalar DF evaluator (4,096 knots), NS3c/NS3g ``Bilinear`` and NS3d/NS3f
``Bicubic`` (512 x 512 x 16, float64, at 1,000,000 queries), NS3e (the
bicubic node layout, 1024 x 1024 x 16), ND3/ND3b (64^3 cubic, float64) and
ND1/ND2 (64^3 ``InterpND``, float32 and float64), and the calculus
states: NS1 in float64 (2,048 knots, 1,000,000 queries), the 10,000 x 64
float64 bank, NS3b's ``Bicubic`` in float64 and ND2's cubic in float64 (cell
and node layouts) and float32.  Then, as the compile phase: ``opcheck`` of
every kernel op on the card; each call compiled by inductor beside its
eager call (``chip_smoke.compiled_case``: launches, bit for bit or within
tolerance, first-call seconds, host wall and device ms of both), the
calculus among them (``chip_smoke.calculus_cases``, ``box_cases``); every
``InterpND`` program dropped, the plain N-D calls that run ``InterpND``'s
programs beside their eager bodies (``chip_smoke.program_cases``,
``program_case``; here their first calls compile cold);
``DoubleFloatEvaluator``, ``DoubleFloatEvaluator2D``,
``DoubleFloatEvaluatorND`` and ``EvaluatorND`` through ``warmup()`` and
every bucket under ``fail_on_recompile`` (``chip_smoke.served_by_bucket``);
and ``vmap`` of each f64-grade route over 16 rows, one launch a kernel.

    python3 tools/compile_phase.py [--no-vmap] [--calculus-only]

``--calculus-only`` runs the calculus and N-D program cases alone.

Needs one CUDA card; exits non-zero on a mismatch or a missing launch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def states(dev, cs):
    """``(serving, state2d, state_nd)`` in the shapes the compile phase
    reads from ``chip_smoke``'s paths."""
    import torch

    from ndarray_interp_tpu_torch import config
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Bilinear, Interp2D
    from ndarray_interp_tpu_torch.interpnd import InterpND
    from ndarray_interp_tpu_torch.serving import (DoubleFloatEvaluator, DoubleFloatEvaluator2D,
                                                  DoubleFloatEvaluatorND)

    rng = np.random.default_rng(43)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    spline = CubicSpline().extrapolate(True)
    nq = 1 << 20
    serving = {}
    bank = Interp1D.builder(T(cs.rep(rng.normal(size=(10_240, 64))))).x(
        T(cs.rep(np.linspace(0.0, 1.0, 10_240)))).strategy(spline).build()
    qb = T(cs.rep(rng.uniform(0.0, 1.0, nq)))
    for grade in ("df", "f48"):
        serving[grade] = (DoubleFloatEvaluator(bank, grade=grade), qb)
    xs = cs.rep(np.cumsum(rng.uniform(0.1, 1.0, 4096)))
    scalar = Interp1D.builder(cs.rep(rng.normal(size=4096)), device=dev).x(xs).strategy(
        spline).build()
    serving["scalar"] = (DoubleFloatEvaluator(scalar), T(cs.rep(rng.uniform(xs[0], xs[-1], nq))))

    nx, ny, r = cs.GRID2D
    x = cs.rep(cs.make_knots(nx, "nonuniform", np.float64, rng))
    y = cs.rep(cs.make_knots(ny, "nonuniform", np.float64, rng))
    z = T(cs.rep(rng.normal(size=cs.GRID2D)))
    state2d = {"df queries": (T(cs.rep(rng.uniform(x[0], x[-1], cs.NQ2D))),
                              T(cs.rep(rng.uniform(y[0], y[-1], cs.NQ2D))))}
    for kind, strat in (("Bilinear", Bilinear()), ("Bicubic", Bicubic())):
        itp = Interp2D.builder(z).x(T(x)).y(T(y)).strategy(strat.extrapolate(True)).build()
        for grade in ("df", "f48"):
            state2d[kind, grade] = DoubleFloatEvaluator2D(itp, grade=grade)

    state_nd = {}
    axes = [np.linspace(0.0, 1.0, n) for n in cs.GRIDND]
    data = rng.normal(size=cs.GRIDND)
    qs = [rng.uniform(0.0, 1.0, cs.NQND) for _ in cs.GRIDND]
    for dt in (np.float32, np.float64):
        tag = np.dtype(dt).name
        ax_d, d_d = [T(a.astype(dt)) for a in axes], T(data.astype(dt))
        for method in ("linear", "cubic"):
            state_nd[method, tag] = InterpND.builder(d_d).points(*ax_d).method(method).build()
        state_nd["queries", tag] = [T(q.astype(dt)) for q in qs]
    cub64 = InterpND.builder(T(cs.rep(data))).points(*(T(cs.rep(a)) for a in axes)).method(
        "cubic").build()
    state_nd["df queries"] = [T(cs.rep(q)) for q in qs]
    for cell, grade in (("ND3", "df"), ("ND3b", "f48")):
        state_nd[cell] = DoubleFloatEvaluatorND(cub64, grade=grade)
    nx, ny, r = cs.GRID_NS3E
    x = cs.rep(cs.make_knots(nx, "nonuniform", np.float64, rng))
    y = cs.rep(cs.make_knots(ny, "nonuniform", np.float64, rng))
    with cs.patched((config, "bicubic_pack_max_elems", (nx - 1) * (ny - 1) * 16 * r - 1)):
        node = Interp2D.builder(T(cs.rep(rng.normal(size=cs.GRID_NS3E)))).x(T(x)).y(T(y)).strategy(
            Bicubic()).build()
    assert node.strategy.layout == "node"
    state_nd["NS3e"] = (DoubleFloatEvaluator2D(node), T(cs.rep(rng.uniform(x[0], x[-1], cs.NQ2D))),
                        T(cs.rep(rng.uniform(y[0], y[-1], cs.NQ2D))))
    return serving, state2d, state_nd


def calculus_states(dev, cs, state_nd):
    """``(calc, calc_nd)`` in the shapes the compile phase reads from
    ``chip_smoke``'s calculus paths."""
    import torch

    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.interpnd import InterpND

    rng = np.random.default_rng(50)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    ns1 = Interp1D.builder(rng.normal(size=2048), device=dev).x(np.linspace(0.0, 100.0, 2048)) \
        .strategy(CubicSpline().extrapolate(True)).build()
    bank = Interp1D.builder(T(rng.normal(size=(10_000, 64)))).x(T(np.linspace(0.0, 1.0, 10_000))) \
        .strategy(CubicSpline()).build()
    nx, ny, _ = cs.GRID2D
    x = cs.make_knots(nx, "nonuniform", np.float64, rng)
    y = cs.make_knots(ny, "nonuniform", np.float64, rng)
    bic = Interp2D.builder(T(rng.normal(size=cs.GRID2D))).x(T(x)).y(T(y)).strategy(Bicubic()) \
        .build()
    calc = {"NS1": (ns1, T(rng.uniform(-1.0, 101.0, 1_000_000))), "bank": bank,
            "NS3b": (bic, T(rng.uniform(x[0], x[-1], cs.NQ2D)),
                     T(rng.uniform(y[0], y[-1], cs.NQ2D)))}
    axes = [T(np.linspace(0.0, 1.0, n)) for n in cs.GRIDND]
    data = T(rng.normal(size=cs.GRIDND))
    q = [T(rng.uniform(0.0, 1.0, cs.NQND)) for _ in cs.GRIDND]

    def nd(dt, layout=None):
        b = InterpND.builder(data.to(dt)).points(*(a.to(dt) for a in axes)).method("cubic")
        return (b if layout is None else b.layout(layout)).build()

    calc_nd = {"cubic": nd(torch.float64), "node": nd(torch.float64, "node"),
               "f32": nd(torch.float32), "queries": q, "q32": [qq.float() for qq in q],
               "box": ((0.1, 0.9), (0.75, 0.2), (0.3, 0.6))}
    return calc, calc_nd


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-vmap", action="store_true", help="skip the vmap cases")
    ap.add_argument("--calculus-only", action="store_true",
                    help="run the calculus and N-D program cases alone")
    args = ap.parse_args()
    vmap_cases, calculus_only = not args.no_vmap, args.calculus_only
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # its helpers import the port only when called

    cs.compile_env()
    import torch

    if not torch.cuda.is_available():
        sys.exit("compile_phase: no CUDA card")
    cs.import_port()
    from ndarray_interp_tpu_torch.models import interpnd as mnd
    from ndarray_interp_tpu_torch.ops import _cuda
    from ndarray_interp_tpu_torch.serving import (DoubleFloatEvaluator, DoubleFloatEvaluator2D,
                                                  DoubleFloatEvaluatorND, EvaluatorND)

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    serving, state2d, state_nd = states(dev, cs)
    calc, calc_nd = calculus_states(dev, cs, state_nd)
    print(f"states built: {time.perf_counter() - t0:.1f} s", flush=True)
    total, rec = {}, {}
    if not calculus_only:
        cs.opcheck_phase(dev)
        for case in cs.df_compiled_cases(serving, state2d, state_nd):
            cs.compiled_case(*case, total, rec)
    for case in (*cs.calculus_cases(calc), *cs.box_cases(calc_nd)):
        cs.compiled_case(*case, total, rec)
    print(f"compiled cases: {time.perf_counter() - t0:.1f} s", flush=True)
    mnd.clear_programs()
    for case in cs.program_cases(state_nd, calc_nd):
        cs.program_case(*case, total, rec)
    print(f"program cases: {time.perf_counter() - t0:.1f} s", flush=True)
    if calculus_only:
        finish(cs, total, rec, t0, card)
        return
    bank_ev, qd = serving["df"]
    nd3, nd2 = state_nd["ND3"], state_nd["cubic", "float32"]
    bic = state2d["Bicubic", "df"]
    for label, make, queries, body, tol in (
        ("DoubleFloatEvaluator df bank 10,240 x 64",
         lambda: DoubleFloatEvaluator(bank_ev._interp), (qd,), cs.df_serve(bank_ev), None),
        ("DoubleFloatEvaluator2D NS3d Bicubic df", lambda: DoubleFloatEvaluator2D(bic._interp),
         state2d["df queries"], cs.df_serve(bic), None),
        ("DoubleFloatEvaluatorND ND3 cubic df", lambda: DoubleFloatEvaluatorND(nd3._interp),
         tuple(state_nd["df queries"]), cs.df_serve(nd3), None),
        ("EvaluatorND ND2 cubic f32", lambda: EvaluatorND(nd2),
         tuple(state_nd["queries", "float32"]), cs.eager(nd2), cs.F32_TOL),
    ):
        cs.served_by_bucket(label, make, queries, body, tol, total, rec)
    print(f"evaluators by bucket: {time.perf_counter() - t0:.1f} s", flush=True)
    if vmap_cases:
        vmap = torch.func.vmap
        for label, fn, args, expect, tol in cs.df_compiled_cases(serving, state2d, state_nd):
            if tol is not None:
                continue
            want = fn(*args)
            got, counts = cs.launched(lambda: vmap(fn)(*(a.reshape(cs.VMAP_ROWS, -1)
                                                        for a in args)))
            same, err = cs.bit_compare(got.reshape(want.shape), want)
            print(f"  {label}: vmap over {cs.VMAP_ROWS} rows: launches {counts} (expected "
                  f"{expect}); {'bit for bit' if same else f'DIFFERS ({err})'} the unbatched "
                  "call", flush=True)
            if counts != expect or not same:
                cs.fail(f"vmap {label}: launches {counts}, bit for bit {same}")
    finish(cs, total, rec, t0, card)


def finish(cs, total, rec, t0, card):
    cs.stop_compile_workers()
    print(f"launches {total}")
    print("compile record: " + json.dumps(rec), flush=True)
    print(f"compile phase alone: {time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    if cs.failures:
        print(f"compile_phase: {len(cs.failures)} failure(s):", *cs.failures, sep="\n  ")
        sys.exit(1)


if __name__ == "__main__":
    main()
