#!/usr/bin/env python3
"""On-card check of the PyTorch port: the 1-D main path, 1-D serving, the
2-D path with its fused f32/f64 cell route, the N-D path with the f64-grade
bicubic node route, the 1-D wide-bank and long-knot-axis routes with
Akima, Makima and Pchip, the f64-grade bicubic route's three tails, the step
family, 1-D/2-D calculus, the build routes, the native host runtime and
``eval_checked`` under graph capture.

    python3 chip_smoke.py [--sweeps]

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``ndarray_interp_tpu_torch/csrc`` and prints
   the build time and each kernel's register use;
3. holds every kernel against its plain PyTorch version on the card, on the
   same inputs: K1/K2/K3 (1-D eval, index+fraction, index) at n in
   {4, 33, 2048, 65536} knots with linspace, non-uniform and log spacing on
   1,000,000 queries that include NaN, +-inf, +-1e38, the knots themselves
   and far extrapolation — values bit-identical with NaN positions equal,
   indices equal; K4 (Thomas) at (2048, 4096) with shared diagonals and at
   (1024, 256) with per-column diagonals, bit-identical to the plain
   reference-order loop; K1's gradient against autograd of its plain
   version; a NaN datum changing only the queries of its two intervals;
   K6-K9 (double-float 1-D) on non-uniform and float32-colliding knots, K6
   also in its float64 store form and its first design;
   K10-K13 and R4c (double-float 2-D tails; R4c the weight form, also held
   within 1e-13 of K12) on grids up to 512 x 512 at 1, 3, 16 and 20
   channels, at the indices and fractions K7 gives for 1,000,000 queries
   per axis with NaN, +-inf and far extrapolation; K14 (the bicubic node
   tail) at 3 x 3 x 1, 200 x 150 x 3 and 512 x 512 x 16 on such inputs; K15
   (the N-D tail, grades df and f48) at k = 1..4 axes, nbasis 4 and 2, and
   r = 1, 3, 20 channels (bp = 1 and bp > 1); K5 (the banked Hermite) at
   ragged shapes up to NS5's 256 x 16,384 x 4,096 with one NaN datum that must
   stay in its lane and two intervals; R2a (the packed-row tail) at banks 1 to
   300; R3 and R3idx (the long-axis search and eval) at 65,537 knots up to
   MAX_BIG_KNOTS on 1,000,000 such queries, cubic and linear tables; R1
   (the 2-D cell search) and the 2-D cell tails R2b and R2g (bilinear, on
   the corner rows and on the grid), R2c, R2d and R2n (bicubic: sequential,
   halving-tree and nested sums; each in both branches) in f32 and f64 on
   grids up to 512 x 512 at 1, 3, 16 and 20 channels, on 1,000,000 queries
   per axis with NaN, +-inf, the knots and far extrapolation, R1 also
   against K3's index and K2's fractions, R2g also against R2b's plain
   version on the corner rows of its grid;
4. drives the main path through the public API on ``device="cuda"``, with
   every launch count set to 0 just before and read just after: the
   2,048-knot not-a-knot spline with extrapolation at 1,000,000 queries in
   f32 and f64, the 10,000-knot x 64 spline bank build and its eval at
   262,144 queries, the default ``Linear`` on a 2,048 x 64 bank, and one
   out-of-bounds ``interp_array`` that must raise ``OutOfBoundsError`` —
   results held against SciPy in f64 on the host;
5. drives the 1-D serving path (``Evaluator``, ``DoubleFloatEvaluator`` in
   grades df and f48) and the 2-D path at the JAX package's config-3 width
   (512 x 512 x 16, non-uniform axes, 1,000,000 queries: ``Interp2D`` with
   ``Bilinear`` and ``Bicubic`` in f32 and f64 against SciPy's
   ``RegularGridInterpolator`` and ``RectBivariateSpline``, through R1 + R2g
   and R1 + R2n (ordered by cell first, ORD's flat-cell form), each output
   equal bit for bit to the plain versions of R1 and its tail on the card
   (``Bilinear`` also to R2b's on the corner rows), ``Evaluator2D``,
   ``eval_into_donated_2d``, ``DoubleFloatEvaluator2D`` in grades df and f48
   for both strategies against float64 forms on double-float-rounded
   inputs, for ``Bilinear`` also bit for bit against ``df_to_f64`` of the
   pair route, an out-of-bounds call), each call with the launch counts set
   to 0 just before it and read just after;
5b. drives the N-D path the same way: ``InterpND`` linear, nearest and cubic
   on a 64^3 grid (ND1, ND2) in f32 and f64 against SciPy, the cubic node
   layouts there (ND2b), a 256^3 cubic grid that the builder puts on the
   node layout and its node2/node4 layouts (ND2c, ND2d, bit-identical to
   each other), ``DoubleFloatEvaluatorND`` df and f48 for cubic (ND3, ND3b)
   and linear at 64^3 in f64 against the port's f64 ``InterpND`` and SciPy,
   and ``DoubleFloatEvaluator2D`` on a 1024 x 1024 x 16 bicubic grid on the
   node layout (NS3e, K14) against the port's f64 ``Interp2D`` and SciPy,
   all at 1,000,000 queries;
5c. drives the wide-bank and long-axis slice the same way, against SciPy:
   NS5 (256 knots x 16,384 splines, 4,096 bf16 queries: K5), NS5b (64 x
   1,000,000 built on the card, 256 queries: K5), NS2b (10,240 x 64 at
   1,000,000: R2a), NS1b (262,144 knots at 1,000,000: R3, also for Linear,
   and R3idx + R2a for a bank of 8), NS4 (Akima, Makima, Pchip on 2,048
   knots: K1; Akima on 262,144: R3);
5d. drives this slice the same way: NS3d's double-float bicubic route
   (``gathered_bicubic_eval_df_packed``) with each tail, "mxu" and "nested"
   on K12, "weight" on R4c, against the float64 form; ``Nearest`` in its four
   modes (2,048 f32 knots, 1,000,000 queries) against SciPy's ``interp1d``,
   the example's vmapped ``StepInterpolator``, ``Nearest2D`` on NS3's grid
   against ``RegularGridInterpolator(method="nearest")``; calculus on the NS1
   spline in f64 (``derivative`` orders 1-3, ``solve``), a 10,000 x 64 f64
   bank (``integrate`` over 4,096 bound pairs) and the NS3b ``Bicubic`` in f64
   (``derivative``, ``integrate`` over 4,096 boxes) against SciPy's
   ``CubicSpline`` and ``RectBivariateSpline`` (K2, K3, K4);
5e. drives N-D calculus and checkpoints the same way at ND2's width (a
   64^3 grid on linspace(0, 1, 64) axes, 1,000,000 queries): ``InterpND``
   cubic in f64 on the cell layout (a 128 MB table), ``derivative`` at
   orders (1,0,0), (0,1,1), (2,1,0), (3,0,0) against the sequential SciPy
   oracle on a 2,048-query prefix (1e-10 of the scale), the node layout
   against the cell layout on every query, order 1 on each axis (linear and
   cubic) against ``torch.autograd.grad`` of ``__call__`` on 4,096 queries,
   the f32 derivative against the f64 one, ``integrate`` over 16 boxes
   against sequential ``CubicSpline.integrate``; ``utils.checkpoint``'s
   ``save`` and ``load`` onto the card of the NS1 ``CubicSpline``, the NS3b
   ``Bicubic`` and the ND1/ND2 ``InterpND``, each reload equal to the
   original bit for bit; it fails unless K2 and K4 launched;
5f. the single-device remainder: the build routes (K4 with the rhs assembly,
   PCR and the dense-operator build of a not-a-knot f32 bank at (64,
   1,000,000), (256, 16,384), (512, 8,192), (2,048, 4,096), (10,000, 64)
   and (64, 65,536), (64, 262,144), (256, 262,144), and the per-axis solves
   of NS3b and ND2: each route's ``a, b`` against K4's at the JAX tolerances,
   host wall in turns A B C C B A and busy, the route the port takes, the
   dense product's bits with TF32 enabled, and NS3b's ``Bicubic`` and ND2's
   cubic whole builds by route); the native host runtime (``HAVE_NATIVE``
   must hold; ``interp_scalar`` of a 1-D f64 cubic and a 512 x 512 f64
   ``Bicubic`` built on the card from numpy, native against the card with
   ``use_native_host`` off: values, host wall per call, no CUDA launch in a
   profiler trace of the native calls); ``eval_checked`` on NS1's knots
   without extrapolation in a captured CUDA graph, one replay in range and
   one out of range (``.throw()`` raises only for the second, the values
   ``eval_unchecked``'s bit for bit);
6. holds every kernel, through its public wrapper, against its plain version
   on the inputs the paths gave it, bit for bit; then times kernel and
   plain version at the paths' shapes with CUDA events (median, min and
   max of 7 runs after 2 warm-ups), and the paths' calls end to end: host
   wall time, and device busy time, idle share and the largest kernels
   from a ``torch.profiler`` trace (the N-D derivative at 1,000,000 queries
   in f64 and f32 and one N-D ``integrate`` among them).  K4 is timed at the bank build (10,000
   x 64), NS1's one column (its chain floor), NS3b's three solves, NS5b's
   64 x 1,000,000 and with per-column diagonals, beside
   ``torch.linalg.solve_ex`` on the dense matrix (10,000 x 64, 512 x 8,192);
   K10-K15, R2b, R2c, R2d and R2n beside the floor of their rows' bytes.
   R2b's designs at NS3 in one run: the grid tail R2g (the path's), the
   corner rows on 16-byte lanes and a channel a lane (a table off 16-byte
   alignment; ``--sweeps``: also on a 2048 x 2048 x 16 grid past the L2);
   R2c's, R2d's and R2n's phases at NS3b: the body in query order, on every
   query's row from one cell (the compute floor), ORD's flat-cell form
   beside its 2-D form on R1's cells, the ordered kernel alone and with ORD;
   then each through ``ordered_phase`` as K12 below, in f32 and f64.  K7 is
   timed at the serving axis (10,240 knots, 2^20 queries, also with every
   query in one interval), at the 2-D and N-D paths' axis widths (512 and 64
   knots, 1,000,000 queries) and on 70,001 knots, each at the wrapper's
   shared-knot budget and at budget 1 (every level of the search on the
   global pairs, the first design's search), with a sweep of the budget.
   K3 likewise: at 2,048 knots on 2, 262,144 and 1,000,000 queries and at
   64 to 70,001 knots on 1,000,000, in f32 and f64, at the wrapper's 32 KB
   tree, at one knot (every level global, the first design's search) and
   as leaders, beside ``torch.searchsorted``.  K1 (``k1_phase``) on 2,
   2,048 and 70,001 knots at 2, 1,024 and 1,000,000 queries, f32 and f64,
   at the wrapper's budget, at one knot and as leaders, each in its three
   row reads on a cubic and a linear table, held bit for bit and timed
   beside the first design (one knot, six scalar loads a row), at NS1's
   shape in every row read; R1 (``r1_phase``) on 2 x 2, NS3's 512 x 512
   and 70,001 x 33 knots (either way round) the same way, at 512 x 512
   also against K3's index and K2's fractions.  K2 (``k2_phase``) at the
   paths' shapes (64, 256 and 512 knots x 1,000,000, 10,000 x 262,144,
   10,240 x 1,000,000, 64 x 256) and at 2 and 70,001 knots, f32 and f64,
   at the wrapper's budget, in its first design (budget 0), at one knot and
   as leaders, idx and t bit for bit ``_index_frac_plain``; R3
   (``r3_phase``) at 65,537, 262,144 (NS1b) and 8,388,480 knots on
   1,000,000 queries (f64 too at the first two) the same way, cubic and
   linear tables, bit for bit ``_big_eval_plain`` and K1's ``_eval_plain``;
   R3idx (``r3idx_phase``) at R3's shapes the same way, idx and t bit for
   bit ``_big_index_frac_plain`` and K2's ``_index_frac_plain``, and beside
   its first design on NS1b's own inputs.  K6 (``k6_phase``) on 4,096 knots
   (the scalar serving spline: the whole axis staged, its rows widened
   beside it), 20,000 and 70,001 (leaders) at 2^20 queries: at the
   wrapper's budget, in its first design (0), at one knot and as leaders, cubic and linear tables (and
   knots that collide in float32), each in both store forms bit for bit
   ``eval_xla_df`` and ``df_to_f64`` of it, timed in each; the scalar
   ``DoubleFloatEvaluator`` on K6 and on K6's first design by CUDA events,
   in turns, its output bit for bit ``df_to_f64`` of K6's pair.
   R2a at NS2b (10,240 x 64,
   1,000,000 queries) and at the bank eval's shape: its 16-byte lanes
   against the first design's column a lane (on a table off 16-byte
   alignment), held bit for bit and timed in turn.  ``--sweeps`` adds the
   design sweeps behind those choices: K3's tree from 16 to 128 KB and the
   tree against the global search on batches of 2 to 65,536; K1's tree
   from 16 to 64 KB at 70,001 and 262,144 knots; R1's budget from 16 to
   128 KB at 8,192 x 8,192 and 70,001 x 33 knots; K2's tree from 16 to 128
   KB past 8,191 knots, R3's and R3idx's at 262,144 and 8,388,480 knots,
   K6's leaders at 4,096 knots; R2a with
   every query in one interval and in interval order (the diagnosis), in
   f64, and on prefixes of 2^12 to 2^20 queries at banks 8, 64 and 256.
   Every kernel's launches are summed over every path.
   K12 (at NS3d), K13 (at NS3f), K14 (at NS3e), R4c (at NS3d), R2n (at NS3b),
   K8 and K9 (at the DF and f48 bank serving's 10,240 x 64 tables and 2^20
   queries) also
   run their ordering ORD (by cell; K8's and K9's by interval, the 1-D form)
   apart, in the form the wrapper picks (shared or global), held against its
   plain version (the same bucket keys, a permutation of the queries, each
   query's record bit for bit) and timed beside the first design and
   ``torch.argsort`` of the same keys, both with their kernels (the phases)
   from the profiler; and both of their branches (ordered, and the unordered
   body of small batches) are held bit for bit and timed in turn on the
   path's queries, on all of them in one cell or interval and on them
   already in order.  ``--sweeps`` adds the crossover sweeps: batch sizes
   from 4,096 up, and narrower or wider tables (K12 and K13 at 3 channels,
   bp 8, K13 with its own sweep; K14 at 3, 4 and 8 channels, 3 on one float a
   lane; R2n at 16 channels and on a table of 8 with its own sweep; K8 and K9
   at banks of 8 and 256 with their own sweeps, and 63, one
   column a lane): the data behind the wrappers' choice of branch; and ORD
   in each form on 1,024 to 49,152 buckets, the data behind the shared
   form's bucket limit.  K8, K9 and K13
   also hold their float64 store form on both branches against
   ``df_to_f64`` of the plain pair, bit for bit, and time it, and K10 and
   K11 (which have no ordered branch) on their one branch; the evaluator
   calls end to end list their eight largest kernels, and NS3d's route with each tail is also timed by CUDA
   events (the profiler has lost the "weight" calls in some runs).

Any failure exits non-zero before the result lines.  The second-to-last
line is the kernels' JSON record; the last line is the contract line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
RUNS, WARMUP = 7, 2
# f32 main path against SciPy in f64 on the f32-rounded inputs: the port
# measured ~1e-6 of the data scale (build and eval rounding in f32)
F32_TOL = 1e-5
F64_TOL = 1e-12  # f64 against SciPy, scaled by the largest |value|

failures: list[str] = []


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    failures.append(msg)


def import_port():
    """Import the port from this checkout, never from anywhere else."""
    sys.path.insert(0, str(HERE))
    import ndarray_interp_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != HERE:
        raise SystemExit(
            f"chip_smoke: ndarray_interp_tpu_torch imported from {pkg.__file__}, "
            f"not from the checkout at {HERE}"
        )
    return pkg


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# -- comparison -----------------------------------------------------------------
def bit_compare(got, want):
    """(identical, max_abs_err): NaN positions equal and every other value
    equal bit for bit (the sign of zero included)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    if not got.is_floating_point():
        same = torch.equal(got, want)
        err = 0.0 if same else float((got.long() - want.long()).abs().max())
        return same, err
    ng, nw = torch.isnan(got), torch.isnan(want)
    if not torch.equal(ng, nw):
        return False, float("nan")
    g, w = got[~ng], want[~nw]
    same = torch.equal(g, w) and torch.equal(torch.signbit(g), torch.signbit(w))
    diff = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    return same, err


class Record:
    """Per-kernel results for the JSON line."""

    def __init__(self):
        self.err = {}

    def add(self, kid, label, got, want):
        """Compare; print only a mismatch.  Returns whether bit-identical."""
        same, err = bit_compare(got, want)
        self.err[kid] = max(self.err.get(kid, 0.0), err)
        if not same:
            fail(f"{kid} {label} differs from its plain version (max abs err {err})")
        return same

    def add_pair(self, kid, label, got, want):
        """Compare a kernel's tuple of outputs: K2's ``(idx, t)``, K7's
        ``(idx, t_hi, t_lo)``, the ``(hi, lo)`` pairs of K6, K8 and K9."""
        ok = True
        for i, (g, w) in enumerate(zip(got, want)):
            ok &= self.add(kid, f"{label} output {i}", g, w)
        return ok and len(got) == len(want)


# -- inputs ---------------------------------------------------------------------
def make_knots(n, spacing, dtype, rng):
    if spacing == "linspace":
        kn = np.linspace(0.0, 100.0, n)
    elif spacing == "log":
        kn = np.logspace(0.0, 2.0, n)
    else:  # non-uniform: gaps of 0.5..1.5 times the mean, so f32 keeps them apart
        gaps = rng.uniform(0.5, 1.5, n - 1)
        kn = np.concatenate([[0.0], np.cumsum(gaps)]) * (100.0 / gaps.sum())
    kn = kn.astype(dtype)
    assert np.all(np.diff(kn) > 0)
    return kn


def make_queries(kn, nq, dtype, rng):
    lo, hi = float(kn[0]), float(kn[-1])
    span = hi - lo
    special = np.array(
        [np.nan, np.inf, -np.inf, 1e38, -1e38, 0.0, -0.0,
         lo - 1e6 * span, hi + 1e6 * span, lo - span, hi + span],
        dtype,
    )
    body = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, nq - special.size - kn.size)
    q = np.concatenate([body.astype(dtype), kn, special])
    assert q.size == nq
    return q


def thomas_system(n, bank, per_column, dtype, rng):
    """Diagonally dominant tridiagonal systems, like the spline systems."""
    shape = (n, bank) if per_column else (n,)
    dx = rng.uniform(0.5, 2.0, shape)
    up = np.roll(dx, 1, axis=0)
    mid = 2.2 * (dx + up)
    rhs = rng.normal(size=(n, bank))
    return [np.asarray(v, dtype) for v in (up, mid, dx, rhs)]


# -- phases -----------------------------------------------------------------------
def kernel_phases(dev, rec):
    import torch

    from ndarray_interp_tpu_torch.interp1d import Interp1D, Linear
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import thomas_kernel as tk
    from ndarray_interp_tpu_torch.ops.searchsorted import get_lower_index
    from ndarray_interp_tpu_torch.ops.thomas import thomas_solve

    rng = np.random.default_rng(0)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    print("kernel phases (kernel against its plain version, same inputs):", flush=True)
    for np_dt in (np.float32, np.float64):
        tag = np.dtype(np_dt).name
        for n in (4, 33, 2048, 65536):
            for spacing in ("linspace", "nonuniform", "log"):
                kn = make_knots(n, spacing, np_dt, rng)
                q = T(make_queries(kn, 1_000_000, np_dt, rng))
                k = T(kn)
                d, a, b = (T(rng.normal(size=m).astype(np_dt)) for m in (n, n - 1, n - 1))
                label = f"{tag} n={n} {spacing}"
                ok = True
                for tname, tbl in (
                    ("cubic", ek.make_interval_table(k, d, a, b)),
                    ("linear", ek.make_interval_table(k, d)),
                ):
                    ok &= rec.add("K1", f"{label} {tname} table", ek.fused_eval_1d(k, tbl, q),
                                  ek._eval_plain(k, tbl, q))
                ok &= rec.add_pair("K2", label, ek.fused_index_frac(k, q),
                                   ek._index_frac_plain(k, q))
                ok &= rec.add("K3", f"{label} idx", ek.fused_lower_index(k, q),
                              get_lower_index(k, q))
                print(f"  {label}, 1M queries: K1 (cubic and linear tables), K2 (idx, t), "
                      f"K3 {'bit-identical' if ok else 'MISMATCH'}", flush=True)
        torch.cuda.synchronize()

        # linear table: +-inf queries extrapolate to +-inf (calc_frac semantics)
        k = T(np.linspace(0.0, 10.0, 16).astype(np_dt))
        tbl = ek.make_interval_table(k, 3.0 * k)
        q = T(np.array([np.inf, -np.inf, 5.0], np_dt))
        got = ek.fused_eval_1d(k, tbl, q)
        ok = rec.add("K1", f"{tag} linear table +-inf", got, ek._eval_plain(k, tbl, q))
        ok &= got[0].item() == np.inf and got[1].item() == -np.inf
        print(f"  {tag} linear table, +-inf queries -> {got[:2].tolist()}: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K1 {tag} linear table: +-inf queries gave {got[:2].tolist()}")

        for n, bank, per_column in ((2048, 4096, False), (1024, 256, True)):
            up, mid, low, rhs = (T(v) for v in thomas_system(n, bank, per_column, np_dt, rng))
            label = f"{tag} ({n}, {bank}) {'per-column' if per_column else 'shared'} diagonals"
            ok = rec.add("K4", label, tk.thomas_solve_fast(up, mid, low, rhs),
                         thomas_solve(up, mid, low, rhs))
            print(f"  K4 {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)
        torch.cuda.synchronize()

    # K1 gradient: kernel forward + plain backward against autograd of the
    # plain version.  The gather's backward accumulates with atomics, whose
    # order varies, so this one is held to a tolerance: 1e-5 of the scale.
    kn = make_knots(2048, "nonuniform", np.float32, rng)
    k = T(kn)
    d, a, b = (T(rng.normal(size=m).astype(np.float32)) for m in (2048, 2047, 2047))
    q0 = T(rng.uniform(-5.0, 105.0, 1_000_000).astype(np.float32))
    grads = []
    for fn in (ek.fused_eval_1d, ek._eval_plain):
        tbl = ek.make_interval_table(k, d, a, b).requires_grad_(True)
        q = q0.clone().requires_grad_(True)
        (fn(k, tbl, q) ** 2).sum().backward()
        grads.append((tbl.grad, q.grad))
    for name, g_k, g_p in zip(("tbl", "q"), grads[0], grads[1]):
        err = float((g_k - g_p).abs().max() / g_p.abs().max())
        ok = err <= 1e-5
        print(f"  K1 gradient d/d{name}: scaled err {err:.3e} ({'ok' if ok else 'FAIL'}, tol 1e-5)")
        if not ok:
            fail(f"K1 gradient d/d{name}: scaled err {err}")

    # one NaN datum changes only the queries of its two adjacent intervals
    kn = np.linspace(0.0, 100.0, 2048).astype(np.float32)
    vals = rng.normal(size=2048).astype(np.float32)
    j = 1000
    vals[j] = np.nan
    itp = (
        Interp1D.builder(vals, device=dev).x(kn)
        .strategy(Linear().extrapolate(True)).build()
    )
    q = T(rng.uniform(-5.0, 105.0, 1_000_000).astype(np.float32))
    out = itp(q)
    idx = get_lower_index(itp.x, q)
    expect_nan = (idx == j - 1) | (idx == j)
    ok = torch.equal(torch.isnan(out), expect_nan) and bool(expect_nan.any())
    print(f"  K1 NaN datum at knot {j}: NaN only in intervals {j - 1} and {j}: "
          f"{'ok' if ok else 'FAIL'} ({int(expect_nan.sum())} of {q.numel()} queries)")
    if not ok:
        fail("a NaN datum reached queries outside its two intervals")


def df_knots(n, spacing, rng):
    """float64 knots rounded to the double-float format; ``collide`` gives
    knots 1e-9..1e-7 apart near 1.0, most of them equal in float32."""
    if spacing == "collide":
        kn = np.cumsum(rng.uniform(1e-9, 1e-7, n)) + 1.0
    else:
        kn = make_knots(n, spacing, np.float64, rng)
    return rep(kn)


def rep(v):
    """``v`` rounded to the double-float format (exact as a pair), so that a
    float64 oracle on these values measures the arithmetic, not the ~2^-49
    representation error of knots and queries."""
    hi = np.asarray(v, np.float64).astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = (np.asarray(v, np.float64) - hi).astype(np.float32)
    return hi.astype(np.float64) + np.where(np.isfinite(hi), lo, 0).astype(np.float64)


def df_kernel_phases(dev, rec):
    """K6-K9 against their plain versions on the card, on the same inputs
    (K6 also in its float64 store form and its first design)."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    rng = np.random.default_rng(1)

    def pair(v):
        return df_from_f64(torch.as_tensor(np.asarray(v, np.float64), device=dev))

    print("double-float kernel phases (kernel against its plain version, same inputs):",
          flush=True)
    for n in (4, 33, 2048, 65536, 100_000):
        for spacing in ("nonuniform", "collide"):
            kn = df_knots(n, spacing, rng)
            q = make_queries(kn, 1_000_000, np.float64, rng)
            q[: n - 1] = (kn[:-1] + kn[1:]) / 2  # midpoints: collided knots' own intervals
            q = np.r_[q, 1e300, -1e300]
            x, qp = pair(kn), pair(q)
            label = f"n={n} {spacing}, {q.size:,} queries"
            ok = True
            for tname, dab in (
                ("cubic", (rng.normal(size=n), rng.normal(size=n - 1), rng.normal(size=n - 1))),
                ("linear", (2.0 * kn + 1.0, np.zeros(n - 1), np.zeros(n - 1))),
            ):
                args = (*x, *(h for v in dab for h in pair(v)), *qp)
                want = ek.eval_xla_df(*args)
                ok &= rec.add_pair("K6", f"{label} {tname}", ek.fused_eval_1d_df(*args), want)
                ok &= rec.add("K6", f"{label} {tname}, float64 store form",
                              ek._fused_eval_1d_df_f64(*args), df_to_f64(*want))
                budget, ek._K6_SHARED_KNOTS = ek._K6_SHARED_KNOTS, 0  # the first design
                try:
                    ok &= rec.add_pair("K6", f"{label} {tname}, first design",
                                       ek.fused_eval_1d_df(*args), want)
                finally:
                    ek._K6_SHARED_KNOTS = budget
            ok &= rec.add_pair("K7", label, ek.fused_index_frac_df(*x, *qp),
                               ek._df_index_frac_xla(*x, *qp))
            print(f"  {label}: K6 (cubic and linear, both store forms, and its first design), "
                  f"K7 (idx, t_hi, t_lo) {'bit-identical' if ok else 'MISMATCH'}", flush=True)
    torch.cuda.synchronize()

    for n, bank in ((10_240, 64), (1_000, 300)):
        pairs = [h for v in (rng.normal(size=(n, bank)), rng.normal(size=(n - 1, bank)),
                             rng.normal(size=(n - 1, bank))) for h in pair(v)]
        nq = 1_000_000
        idx = torch.as_tensor(rng.integers(0, n - 1, nq), dtype=torch.int32, device=dev)
        t = pair(np.r_[rng.uniform(-0.5, 1.5, nq - 5), [np.inf, -np.inf, np.nan, 1e30, 1.0]])
        label = f"({n:,} x {bank}, bp {-(-bank // 8) * 8}), {nq:,} queries"
        for kid, kernel, plain, pack in (
            ("K8", ek.gathered_df_tail, ek._df_tail_plain, ek.pack_bank_rows_df),
            ("K9", ek.gathered_f48_tail, ek._f48_tail_plain, ek.pack_bank_rows_f48),
        ):
            packed = pack(*pairs)
            ok = rec.add_pair(kid, label, kernel(packed, idx, *t, bank),
                              plain(packed, idx, *t, bank))
            print(f"  {kid} {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)
            del packed
        torch.cuda.synchronize()


def scaled_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def check_close(label, got, ref, tol, shape, dtype):
    import torch

    arr = got.detach().cpu().numpy()
    ok_shape = tuple(got.shape) == shape and got.dtype == dtype
    finite = bool(torch.isfinite(got).all())
    err = scaled_err(arr.astype(np.float64), ref)
    ok = ok_shape and finite and err <= tol
    print(f"  {label}: shape {tuple(got.shape)} {got.dtype}, finite={finite}, "
          f"scaled err vs SciPy f64 {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{label}: shape/dtype {ok_shape}, finite {finite}, err {err}")
    return err


def main_path(dev, rng):
    """The port's main path through the public API; returns what the
    timing phase reuses."""
    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch import OutOfBoundsError
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D

    out = {}
    kn = np.linspace(0.0, 100.0, 2048)
    vals = rng.normal(size=2048)
    qs = rng.uniform(-1.0, 101.0, 1_000_000)
    for dt, tol in ((np.float32, F32_TOL), (np.float64, F64_TOL)):
        k, v, q = kn.astype(dt), vals.astype(dt), qs.astype(dt)
        itp = (
            Interp1D.builder(v, device=dev).x(k)
            .strategy(CubicSpline().extrapolate(True)).build()
        )
        q_d = torch.as_tensor(q, device=dev)
        got = itp(q_d)
        ref = si.CubicSpline(k.astype(np.float64), v.astype(np.float64))(q.astype(np.float64))
        check_close(f"NS1 {np.dtype(dt).name} 2048 knots x 1M queries", got, ref, tol,
                    (1_000_000,), torch.float32 if dt == np.float32 else torch.float64)
        out[np.dtype(dt).name] = (itp, q_d)

    xb = np.linspace(0.0, 1.0, 10_000).astype(np.float32)
    bank = rng.normal(size=(10_000, 64)).astype(np.float32)
    bank_d = torch.as_tensor(bank, device=dev)
    xb_d = torch.as_tensor(xb, device=dev)
    itp10 = Interp1D.builder(bank_d).x(xb_d).strategy(CubicSpline().extrapolate(True)).build()
    q10 = rng.uniform(0.0, 1.0, 262_144).astype(np.float32)
    q10_d = torch.as_tensor(q10, device=dev)
    got = itp10(q10_d)
    ref = si.CubicSpline(xb.astype(np.float64), bank.astype(np.float64), axis=0)(
        q10.astype(np.float64))
    check_close("bank 10,000 knots x 64 build + eval at 262,144 queries", got, ref, F32_TOL,
                (262_144, 64), torch.float32)
    out["bank"] = (itp10, xb_d, bank_d, q10_d)

    xl = np.linspace(0.0, 100.0, 2048).astype(np.float32)
    lbank = rng.normal(size=(2048, 64)).astype(np.float32)
    lin = Interp1D.builder(lbank, device=dev).x(xl).build()  # default Linear
    ql = rng.uniform(0.0, 100.0, 262_144).astype(np.float32)
    ql_d = torch.as_tensor(ql, device=dev)
    got = lin.interp_array(ql_d)
    ref = np.stack(
        [np.interp(ql.astype(np.float64), xl.astype(np.float64), lbank[:, c].astype(np.float64))
         for c in range(64)], axis=1)
    check_close("Linear 2048 x 64 bank at 262,144 queries", got, ref, F32_TOL,
                (262_144, 64), torch.float32)
    out["linear"] = (lin, ql_d)

    try:
        lin.interp_array(torch.tensor([50.0, 100.5], device=dev))
    except OutOfBoundsError as err:
        print(f"  out-of-bounds interp_array raised OutOfBoundsError: {err}")
    else:
        fail("out-of-bounds interp_array did not raise OutOfBoundsError")
    return out


def df_scaled_err(got, ref):
    """Scale-relative error of the JAX package's double-float gates
    (``tests/test_df.py:124-126``): |got - ref| over max(|ref|, 1% of the
    largest |ref|)."""
    scale = np.maximum(np.abs(ref), 0.01 * np.abs(ref).max())
    return float(np.max(np.abs(got - ref) / scale))


def gate(label, got, ref, tol, shape, oracle="SciPy f64"):
    import torch

    ok_shape = tuple(got.shape) == shape and got.dtype == torch.float64
    arr = got.cpu().numpy()
    finite = bool(np.isfinite(arr).all())
    err = df_scaled_err(arr, ref)
    ok = ok_shape and finite and err <= tol
    print(f"  {label}: shape {tuple(got.shape)} {got.dtype}, finite={finite}, "
          f"scale-relative err vs {oracle} {err:.3e} (gate {tol:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{label}: shape/dtype {ok_shape}, finite {finite}, err {err}")
    return err


# the tails that order their batch first (ORD); a call's orderings are those
# of the one of them it launched (K10 and K11 never order: a call of theirs
# that launches ORD fails)
ORDERED_TAILS = ("K8", "K9", "K12", "K13", "K14", "R4c", "R2c", "R2d", "R2n")
# the f32/f64 bicubic cell tails: R1's flat cell and fractions, ordered by
# that cell (ORD's flat-cell form) above the shared rule
CELL_TAILS = ("R2c", "R2d", "R2n")


def counted_calls():
    """``(drive, total)``: ``drive(label, expect, fn)`` calls ``fn`` with
    every launch count set to 0 just before and read just after, fails for
    each kernel id in ``expect`` that was not launched, adds the counts to
    ``total`` and returns what ``fn`` returned.  ``total["ORD:<kid>"]``
    sums the orderings of the calls that launched the ordered tail
    ``kid``."""
    import torch

    from ndarray_interp_tpu_torch.ops import kernel_wrappers

    wrappers = kernel_wrappers()
    total = dict.fromkeys(wrappers, 0) | {f"ORD:{kid}": 0 for kid in ORDERED_TAILS}

    def drive(label, expect, fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {kid: w.launches for kid, w in wrappers.items()}
        print(f"  {label}: launches {({k: c for k, c in counts.items() if c})}", flush=True)
        for kid in expect:
            if counts[kid] <= 0:
                fail(f"{label}: {kid} was not launched")
        for kid, c in counts.items():
            total[kid] += c
        tails = [kid for kid in ORDERED_TAILS if counts[kid]]
        if counts["ORD"] and len(tails) != 1:
            fail(f"{label}: {counts['ORD']} orderings beside the tails {tails}")
        elif counts["ORD"]:
            total[f"ORD:{tails[0]}"] += counts["ORD"]
        return out

    return drive, total


def serving_path(dev, state, rng):
    """The 1-D serving slice through the public API on ``device="cuda"``.
    Every call is driven with all launch counts set to 0 just before it and
    read just after; returns what the timing phase reuses and the launches
    of each kernel summed over the calls."""
    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch import OutOfBoundsError
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu_torch.serving import DoubleFloatEvaluator, Evaluator

    drive, total = counted_calls()
    out = {}
    nq = 1_048_576
    # NS2c/NS2d (benches/run_benches.py:421-482): 10,240 knots x 64, 2^20 queries
    xb = rep(np.linspace(0.0, 1.0, 10_240))
    bank = rep(rng.normal(size=(10_240, 64)))
    qb = rep(rng.uniform(0.0, 1.0, nq))
    qb_d = torch.as_tensor(qb, device=dev)
    spline = CubicSpline().extrapolate(True)
    itp = drive("f64 bank build 10,240 x 64 on the card", ["K4"], lambda: (
        Interp1D.builder(torch.as_tensor(bank, device=dev)).x(torch.as_tensor(xb, device=dev))
        .strategy(spline).build()))
    ref = si.CubicSpline(xb, bank, axis=0)(qb)
    for grade, tail, tol in (("df", "K8", 4e-12), ("f48", "K9", 1e-8)):
        # K8 and K9 order the 2^20 batch by interval first (the bucket of warmup too)
        kids = ["K7", tail] + (["ORD"] if ek._orders(nq, 64) else [])
        ev = drive(f"DoubleFloatEvaluator(grade={grade!r}) build + warmup", kids,
                   lambda: DoubleFloatEvaluator(itp, grade=grade).warmup())
        got = drive(f"DoubleFloatEvaluator(grade={grade!r}) at {nq:,} f64 queries",
                    kids, lambda: ev(qb_d))
        gate(f"{grade} banked 10,240 x 64 at {nq:,} queries", got, ref, tol, (nq, 64))
        out[grade] = (ev, qb_d)
        del got
    del ref

    # the scalar route, as examples/double_float_serving.py: 4,096 non-uniform knots
    xs = rep(np.cumsum(rng.uniform(0.1, 1.0, 4096)))
    vals = rep(rng.normal(size=4096))
    qs = rep(rng.uniform(xs[0], xs[-1], nq))
    qs_d = torch.as_tensor(qs, device=dev)
    ev = drive("scalar f64 spline 4,096 knots: build + DoubleFloatEvaluator", ["K4"], lambda: (
        DoubleFloatEvaluator(Interp1D.builder(vals, device=dev).x(xs).strategy(spline).build())))
    got = drive(f"scalar DoubleFloatEvaluator at {nq:,} f64 queries", ["K6"], lambda: ev(qs_d))
    gate(f"df scalar 4,096 knots at {nq:,} queries", got, si.CubicSpline(xs, vals)(qs), 1e-12,
         (nq,))
    # K6's float64 store form: bit for bit the pair it returned before, recombined
    same = bit_compare(got, df_to_f64(*ek.fused_eval_1d_df(*ev._run.args, *df_from_f64(qs_d))))[0]
    print(f"  scalar DoubleFloatEvaluator on K6's float64 store form against df_to_f64 of K6's "
          f"pair: {'bit-identical' if same else 'MISMATCH'}", flush=True)
    if not same:
        fail("the scalar DoubleFloatEvaluator differs from df_to_f64 of K6's pair")
    out["scalar"] = (ev, qs_d)

    # the f32 Evaluator: equal bit for bit to itp(q) at every request size
    ns1, q1 = state["float32"]
    itp10, _, _, q10 = state["bank"]
    for label, interp, queries, sizes, kids in (
        ("NS1 2048 knots f32", ns1, q1, (1, 1000, 300_000, nq + 1), ["K1"]),
        ("bank 10,000 x 64 f32", itp10, q10, (1000, 262_144), ["K2", "R2a"]),
    ):
        ev = Evaluator(interp)
        for size in sizes:
            q = torch.cat([queries, queries])[:size]
            got = drive(f"Evaluator {label} at {size:,} queries", kids, lambda: ev(q))
            if not torch.equal(got, interp(q)):
                fail(f"Evaluator {label} at {size:,} queries differs from itp(q)")
        out[kids[0]] = (ev, queries)

    strict = drive("scalar spline without extrapolation", ["K4"], lambda: DoubleFloatEvaluator(
        Interp1D.builder(vals, device=dev).x(xs).strategy(CubicSpline()).build()))
    try:
        strict(np.array([xs[10], xs[0] - 1.0]))
    except OutOfBoundsError as err:
        print(f"  out-of-bounds request raised OutOfBoundsError: {err}")
    else:
        fail("an out-of-bounds DoubleFloatEvaluator request did not raise")
    return out, total


# Before each timed run a spin kernel holds the stream, so the host enqueues
# the whole run while the device is busy and the events measure device time.
# Without it a single K1 launch (~24 us of device work) is timed together with
# the ~50 us of Python and ctypes work that precedes it.
HOLD_CYCLES = 100_000_000  # ~50 ms at the H100's clock


def device_ms(fn, calls):
    """(median, min, max) over RUNS runs of the device time per call in ms:
    CUDA events around ``calls`` back-to-back calls enqueued behind the spin."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times)), float(min(times)), float(max(times))


def wall_ms(fn, calls):
    """(median, min, max) over RUNS runs of the host time per call in ms, for
    ``calls`` calls in a loop that ends in a synchronisation."""
    import torch

    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(times)), float(min(times)), float(max(times))


def busy_ms(fn, calls, top=3):
    """Device busy time per call in ms, from a ``torch.profiler`` trace of
    ``calls`` calls, and the ``top`` kernels that take most of it (each
    with its launches per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The first session after the timing loops once kept only part of its
    # kernel records (1 of 3 K8 launches), and sessions have recorded no
    # device event at all (three in a row once), so the calls are profiled
    # until the second session that records device time (at most eight
    # sessions) and that one is read; the launch counts printed beside the
    # kernels show a drop.  A call whose eight sessions all come back empty
    # reports its busy time as not measured (NaN) rather than failing the run:
    # the profiler's loss is no fault of the program.
    seen = 0
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen += bool(events)
        if seen == 2:
            break
    if not events:
        print("  (the profiler recorded no device time in eight sessions: busy not measured)",
              flush=True)
        return float("nan"), []
    events.sort(key=lambda e: -e.self_device_time_total)
    largest = [(f"{e.count / calls:g}x {e.key}", e.self_device_time_total / calls / 1e3)
               for e in events[:top]]
    return sum(e.self_device_time_total for e in events) / calls / 1e3, largest


def fmt(t):
    return f"{t[0]:.4f} [{t[1]:.4f}, {t[2]:.4f}]"


def main_path_systems(state):
    """The inputs each kernel gets on the main path: ``{kid: [(label, args)]}``,
    rebuilt from the main path's own interpolators; the first of each kernel
    is the float32 shape that is timed."""
    from ndarray_interp_tpu_torch.models.strategies.cubic import _NOT_A_KNOT, _assemble_system
    from ndarray_interp_tpu_torch.ops.eval_kernels import make_interval_table

    nak = (_NOT_A_KNOT, 0.0, _NOT_A_KNOT, 0.0)
    _, xb, bank, q10 = state["bank"]
    lin, ql = state["linear"]
    systems = {
        "K1": [],
        "K2": [("bank eval float32: 10,000 knots, 262,144 queries", (xb, q10))],
        "K3": [("Linear bank float32: 2048 knots, 262,144 queries", (lin.x, ql))],
        "K4": [("bank build float32: 10,000 knots x 64 splines",
                _assemble_system(xb, bank, *nak))],
    }
    for tag in ("float32", "float64"):
        itp, q = state[tag]
        tbl = make_interval_table(itp.x, itp.data, itp.strategy.a, itp.strategy.b)
        systems["K1"].append((f"NS1 eval {tag}: 2048 knots, 1,000,000 queries", (itp.x, tbl, q)))
        systems["K4"].append((f"NS1 build {tag}: 2048 knots, one column",
                              _assemble_system(itp.x, itp.data, *nak)))
    return systems


def timing(state, card, rec, sweeps):
    """Hold each kernel, through its public wrapper, against its plain version
    on the inputs the main path gave it; then time both at the main path's
    float32 shape, and K3, K1 and K2 by their budgets (``k3_phase``,
    ``k1_phase``, ``k2_phase``)."""
    import torch

    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import thomas_kernel as tk
    from ndarray_interp_tpu_torch.ops.searchsorted import get_lower_index
    from ndarray_interp_tpu_torch.ops.thomas import thomas_solve

    itp, q = state["float32"]
    itp10, xb, bank, q10 = state["bank"]
    lin, ql = state["linear"]

    # kid: (public wrapper, plain version, compare, calls per run of each)
    pairs = {
        "K1": (ek.fused_eval_1d, ek._eval_plain, rec.add, (50, 20)),
        "K2": (ek.fused_index_frac, ek._index_frac_plain, rec.add_pair, (50, 20)),
        "K3": (ek.fused_lower_index, get_lower_index, rec.add, (50, 20)),
        "K4": (tk.thomas_solve_fast, thomas_solve, rec.add, (3, 1)),
    }
    systems = main_path_systems(state)
    print("kernels at the main path's shapes and inputs, against their plain versions:")
    for kid, (kern, plain, compare, _) in pairs.items():
        for label, args in systems[kid]:
            ok = compare(kid, label, kern(*args), plain(*args))
            print(f"  {kid} {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)

    times = time_kernels(pairs, systems, card)
    knots, q3 = systems["K3"][0][1]
    lib = device_ms(lambda: torch.searchsorted(knots, q3, right=True), 50)
    times["K3"]["library_ms"] = lib[0]
    print(f"  K3 library call torch.searchsorted: {fmt(lib)}", flush=True)
    times["K3"].update(k3_phase(q3.device, card, rec, sweeps))
    times["K1"].update(k1_phase(q3.device, card, rec, sweeps))
    times["K2"].update(k2_phase(q3.device, card, rec, sweeps))
    label, args = systems["K4"][1]
    tk_, tp_ = device_ms(lambda: tk.thomas_solve_fast(*args), 3), device_ms(
        lambda: thomas_solve(*args), 1)
    bound_ms, bound_by = bound("K4", args)
    print(f"  K4 {label} (the chain floor: one column, 2 x 2,047 dependent steps): kernel "
          f"{fmt(tk_)}, plain {fmt(tp_)}, bound {bound_ms:.4f} ({bound_by})", flush=True)
    times["K4"]["library_ms"] = dense_solve_ms(systems["K4"][0], "K4")

    strat = CubicSpline().extrapolate(True)
    end_to_end({
        "NS1 eval itp(q), 2048 knots x 1M f32": (lambda: itp(q), 20),
        "bank build, 10,000 x 64 f32": (
            lambda: Interp1D.builder(bank).x(xb).strategy(strat).build(), 3),
        "bank eval itp(q), 10,000 x 64 at 262,144 f32": (lambda: itp10(q10), 10),
        "Linear bank interp_array, 2048 x 64 at 262,144 f32": (lambda: lin.interp_array(ql), 10),
    }, "main path", card)
    return times


# --sweeps: K3's trees at 10,240 knots and up, 16 to 128 KB of shared memory,
# and the batch sizes on 2,048 knots where the tree meets the global search
K3_TREE_SWEEP = (16 << 10, 32 << 10, 64 << 10, 128 << 10)
K3_SMALL = (2, 64, 256, 1024, 4096, 16_384, 65_536)


def k3_phase(dev, card, rec, sweeps):
    """K3 at 2,048 knots on 2, 262,144 and 1,000,000 queries and at 64, 512,
    10,240, 65,536 and 70,001 knots on 1,000,000, in f32 and f64: each at the
    wrapper's shared-memory budget, at one knot (every level on the global
    axis, the first design's search) and as leaders (every 16th knot
    staged), held index for index against ``get_lower_index`` on queries with
    NaN, +-inf, +-1e38, the knots and far extrapolation, and timed beside
    ``torch.searchsorted``.  With ``sweeps``, also the tree's size from
    10,240 knots up and, at 2,048 knots, the tree against the global search
    on batches of 2 to 65,536 queries.  Returns the keys the kernels line
    adds."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops.searchsorted import get_lower_index

    rng = np.random.default_rng(54)
    default = ek._K3_TREE_BYTES
    cases = [(2048, 2), (2048, 262_144), (2048, 1_000_000)] + [
        (n, 1_000_000) for n in (64, 512, 10_240, 65_536, 70_001)]
    out = {}
    print(f"K3 by shared-memory budget (one knot: every level global, the first design's "
          f"search; the wrapper's tree {default:,} B), ms (median [min, max] of {RUNS} runs by "
          f"CUDA events; card: {card}):", flush=True)

    def run(knots_staged, k, q):
        ek._K3_TREE_BYTES = (knots_staged + 1) * k.element_size()
        return ek.fused_lower_index(k, q)

    try:
        for np_dt in (np.float32, np.float64):
            tag, size = np.dtype(np_dt).name, np.dtype(np_dt).itemsize
            for n, nq in cases:
                kn = make_knots(n, "nonuniform", np_dt, rng)
                q = (np.array([np.nan, np.inf], np_dt) if nq == 2 else
                     rng.permutation(make_queries(kn, nq, np_dt, rng)))
                k, q = torch.as_tensor(kn, device=dev), torch.as_tensor(q, device=dev)
                want = get_lower_index(k, q)
                label = f"{tag}, {n:,} knots, {nq:,} queries"
                budgets = {"wrapper": default // size - 1, "global": 1,
                           "leaders": max(2, n // 16)}
                if sweeps and n > 10_000:
                    budgets |= {f"tree {b >> 10} KB": b // size - 1 for b in K3_TREE_SWEEP}
                got = {}
                for name, b in budgets.items():
                    ok = rec.add("K3", f"{label}, {b} knots staged", run(b, k, q), want)
                    got[name] = device_ms(lambda b=b: run(b, k, q), 50)
                    print(f"  K3 {label}, {name} ({b:,} knots staged): {fmt(got[name])} "
                          f"({'identical' if ok else 'MISMATCH'})", flush=True)
                lib = device_ms(lambda: torch.searchsorted(k, q, right=True), 50)
                bound_ms = bound("K3", (k, q))[0]
                print(f"  K3 {label}: {got['wrapper'][0]:.4f} against {got['global'][0]:.4f} "
                      f"every level global ({got['global'][0] / got['wrapper'][0]:.2f}x), "
                      f"leaders {got['leaders'][0]:.4f}; torch.searchsorted {fmt(lib)}; bound "
                      f"{bound_ms:.4f}", flush=True)
                out[label] = {"ms": got["wrapper"][0], "global_ms": got["global"][0],
                              "leader_ms": got["leaders"][0], "library_ms": lib[0],
                              "bound_ms": bound_ms}
                del k, q, want
        k = torch.as_tensor(make_knots(2048, "nonuniform", np.float32, rng), device=dev)
        for nq in K3_SMALL if sweeps else ():
            q = torch.as_tensor(rng.uniform(-1.0, 101.0, nq).astype(np.float32), device=dev)
            turns = {True: [], False: []}
            for staged in (True, False, False, True):
                b = default // 4 - 1 if staged else 1
                turns[staged].append(device_ms(lambda: run(b, k, q), 50)[0])
            print(f"  K3 float32, 2,048 knots, {nq:,} queries: tree {np.mean(turns[True]):.4f}, "
                  f"every level global {np.mean(turns[False]):.4f} (each the mean of two "
                  f"turns)", flush=True)
    finally:
        ek._K3_TREE_BYTES = default
    torch.cuda.synchronize()
    shape = "float32, 2,048 knots, 1,000,000 queries"
    return {"global_search_ms": out[shape]["global_ms"], "shapes": out}


def phase_queries(kn, nq, dtype, rng):
    """``make_queries`` where the batch holds the axis, else its first ``nq``
    of NaN, +inf, -inf, +-1e38, +-0, far extrapolation, knots themselves
    and uniform queries (2 queries: NaN and +inf)."""
    if nq >= kn.size + 64:
        return rng.permutation(make_queries(kn, nq, dtype, rng))
    lo, hi = float(kn[0]), float(kn[-1])
    span = hi - lo
    special = np.array([np.nan, np.inf, -np.inf, 1e38, -1e38, 0.0, -0.0, lo - 1e6 * span,
                        hi + 1e6 * span], dtype)
    body = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, nq).astype(dtype)
    return np.concatenate([special, rng.choice(kn, nq // 2), body])[:nq]


# K1's row reads (csrc/eval_kernels.cu RowRead) and, with --sweeps, its trees
# on axes past the whole tree
K1_ROW_READS = {"six scalar loads": 0, "three 2-element loads": 1, "rows in shared memory": 2}
K1_TREE_SWEEP = (16 << 10, 32 << 10, 64 << 10)


def k1_phase(dev, card, rec, sweeps):
    """K1 on 2 knots at 1,000,000 queries, 2,048 knots at 2, 1,024 and
    1,000,000, and 70,001 knots at 1,000,000, in f32 and f64: each at the
    wrapper's shared-memory budget (the whole axis up to 8,191 f32 / 4,095 f64
    knots, 70,001 as leaders), at one knot (every level of the search on the
    global axis) and as leaders (every 16th knot staged), each in every row
    read, on a cubic and a linear table (+-inf), held bit for bit against
    ``_eval_plain`` on queries with NaN, +-inf, +-1e38, the knots and far
    extrapolation; timed at the wrapper's row read, beside the first design
    (one knot, six scalar loads) and, at 2,048 knots x 1M, in every row read.
    With ``sweeps``, also the tree's size at 70,001 and 262,144 knots.
    Returns the keys the kernels line adds."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(55)
    default, read0 = ek._K1_TREE_BYTES, ek._K1_ROW_READ
    cases = [(2, 1_000_000), (2048, 2), (2048, 1024), (2048, 1_000_000), (70_001, 1_000_000)]
    if sweeps:
        cases.append((262_144, 1_000_000))
    out = {}
    print(f"K1 by shared-memory budget and row read (one knot: every level global; the "
          f"wrapper's tree {default:,} B, row read f32 {read0[torch.float32]}, f64 "
          f"{read0[torch.float64]}), ms (median [min, max] of {RUNS} runs by CUDA events; "
          f"card: {card}):", flush=True)

    def run(knots_staged, read, k, tbl, q):
        ek._K1_TREE_BYTES = (knots_staged + 1) * k.element_size()
        ek._K1_ROW_READ = {**read0, k.dtype: read}
        return ek.fused_eval_1d(k, tbl, q)

    try:
        for np_dt in (np.float32, np.float64):
            tag, size = np.dtype(np_dt).name, np.dtype(np_dt).itemsize
            for n, nq in cases:
                if n > 70_001 and np_dt is np.float64:
                    continue
                kn = make_knots(n, "nonuniform", np_dt, rng)
                d, a, b = (rng.normal(size=m).astype(np_dt) for m in (n, n - 1, n - 1))
                k, q = torch.as_tensor(kn, device=dev), torch.as_tensor(
                    phase_queries(kn, nq, np_dt, rng), device=dev)
                d, a, b = (torch.as_tensor(v, device=dev) for v in (d, a, b))
                tables = {"cubic": ek.make_interval_table(k, d, a, b),
                          "linear": ek.make_interval_table(k, d)}
                want = {name: ek._eval_plain(k, tbl, q) for name, tbl in tables.items()}
                label = f"{tag}, {n:,} knots, {nq:,} queries"
                budgets = {"wrapper": default // size - 1, "global": 1,
                           "leaders": max(2, n // 16)}
                ok = True
                for b_ in budgets.values():
                    for read in K1_ROW_READS.values():
                        for name, tbl in tables.items():
                            ok &= rec.add("K1", f"{label}, {b_} knots staged, row read {read}, "
                                          f"{name} table", run(b_, read, k, tbl, q), want[name])
                cubic = tables["cubic"]
                read = read0[k.dtype]
                got = {name: device_ms(lambda b_=b_, r_=r_: run(b_, r_, k, cubic, q), 50)
                       for name, (b_, r_) in {
                           "wrapper": (budgets["wrapper"], read),
                           "first design": (1, K1_ROW_READS["six scalar loads"]),
                           "leaders": (budgets["leaders"], read)}.items()}
                if n == 2048 and nq == 1_000_000:
                    for name, read in K1_ROW_READS.items():
                        got[name] = device_ms(lambda r_=read: run(budgets["wrapper"], r_, k,
                                                                  cubic, q), 50)
                if sweeps and n > 10_000:
                    for t_ in K1_TREE_SWEEP:
                        got[f"tree {t_ >> 10} KB"] = device_ms(
                            lambda b_=t_ // size - 1: run(b_, read, k, cubic, q), 50)
                bound_ms = bound("K1", (k, cubic, q))[0]
                print(f"  K1 {label} (every budget and row read, cubic and linear tables: "
                      f"{'bit-identical' if ok else 'MISMATCH'}); bound {bound_ms:.4f}:",
                      flush=True)
                for name, t_ in got.items():
                    print(f"    {name}: {fmt(t_)}", flush=True)
                out[label] = {"ms": got["wrapper"][0], "first_design_ms": got["first design"][0],
                              "leader_ms": got["leaders"][0], "bound_ms": bound_ms,
                              **{f"{name} ms": t_[0] for name, t_ in got.items()
                                 if name not in ("wrapper", "first design", "leaders")}}
                del k, q, d, a, b, tables, want, cubic
    finally:
        ek._K1_TREE_BYTES, ek._K1_ROW_READ = default, read0
    torch.cuda.synchronize()
    shape = "float32, 2,048 knots, 1,000,000 queries"
    return {"first_design_ms": out[shape]["first_design_ms"],
            "row_read_ms": {tag: {name: out[f"{tag}, 2,048 knots, 1,000,000 queries"][
                f"{name} ms"] for name in K1_ROW_READS} for tag in ("float32", "float64")},
            "shapes": out}


# R1's per-axis trees, with --sweeps: the budget at two axes past a 16 KB tree
R1_TREE_SWEEP = (16 << 10, 32 << 10, 64 << 10, 128 << 10)


def r1_phase(dev, card, rec, sweeps):
    """R1 on 2 x 2 knots at 1,000,000 queries, 512 x 512 (NS3's axes) at 2,
    1,024 and 1,000,000, and 70,001 x 33 and 33 x 70,001 at 1,000,000, in f32
    and f64: each at the wrapper's budget (half of it a tree for each axis),
    at one knot an axis (every level of both searches on the global axes,
    the first design's search) and as leaders (every 16th knot of each axis
    staged), held bit for bit against ``_cell_index_plain`` (cell, tx, ty) on
    queries with NaN, +-inf, +-1e38, the knots and far extrapolation, at
    512 x 512 also against K3's index of each axis and K2's fractions; timed
    in each.  With ``sweeps``, also the budget at 8,192 x 8,192 and 70,001 x
    33.  Returns the keys the kernels line adds."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(56)
    default = ek._R1_TREE_BYTES
    cases = [(2, 2, 1_000_000), (512, 512, 2), (512, 512, 1024), (512, 512, 1_000_000),
             (70_001, 33, 1_000_000), (33, 70_001, 1_000_000)]
    if sweeps:
        cases.append((8192, 8192, 1_000_000))
    out = {}
    print(f"R1 by shared-memory budget (each axis half of the wrapper's {default:,} B; one "
          f"knot: every level of both searches global, the first design's search), ms (median "
          f"[min, max] of {RUNS} runs by CUDA events; card: {card}):", flush=True)

    def run(knots_staged, x, y, qx, qy):
        ek._R1_TREE_BYTES = 2 * (knots_staged + 1) * x.element_size()
        return ek.fused_cell_index(x, y, qx, qy)

    try:
        for np_dt in (np.float32, np.float64):
            tag, size = np.dtype(np_dt).name, np.dtype(np_dt).itemsize
            for nx, ny, nq in cases:
                kx = make_knots(nx, "nonuniform", np_dt, rng)
                ky = make_knots(ny, "log" if ny < 10_000 else "nonuniform", np_dt, rng)
                x, y = torch.as_tensor(kx, device=dev), torch.as_tensor(ky, device=dev)
                qx = torch.as_tensor(phase_queries(kx, nq, np_dt, rng), device=dev)
                qy = torch.as_tensor(phase_queries(ky, nq, np_dt, rng)[::-1].copy(), device=dev)
                want = ek._cell_index_plain(x, y, qx, qy)
                label = f"{tag}, {nx:,} x {ny:,} knots, {nq:,} queries"
                budgets = {"wrapper": default // 2 // size - 1, "global": 1,
                           "leaders": max(2, max(nx, ny) // 16)}
                if sweeps and max(nx, ny) > 4096:
                    budgets |= {f"budget {t_ >> 10} KB": t_ // 2 // size - 1
                                for t_ in R1_TREE_SWEEP}
                ok = all([rec.add_pair("R1", f"{label}, {b_} knots staged an axis",
                                       run(b_, x, y, qx, qy), want) for b_ in budgets.values()])
                if nx == ny == 512:
                    cell, tx, ty = run(budgets["wrapper"], x, y, qx, qy)
                    ok &= rec.add("R1", f"{label} against K3", cell, ek.fused_lower_index(x, qx)
                                  * (ny - 1) + ek.fused_lower_index(y, qy))
                    ok &= rec.add_pair("R1", f"{label} against K2", (tx, ty), (
                        ek.fused_index_frac(x, qx)[1], ek.fused_index_frac(y, qy)[1]))
                got = {name: device_ms(lambda b_=b_: run(b_, x, y, qx, qy), 50)
                       for name, b_ in budgets.items()}
                bound_ms = bound("R1", (x, y, qx, qy))[0]
                print(f"  R1 {label} ({'bit-identical' if ok else 'MISMATCH'}); bound "
                      f"{bound_ms:.4f}:", flush=True)
                for name, t_ in got.items():
                    print(f"    {name} ({budgets[name]:,} knots an axis): {fmt(t_)}", flush=True)
                out[label] = {"ms": got["wrapper"][0], "first_design_ms": got["global"][0],
                              "leader_ms": got["leaders"][0], "bound_ms": bound_ms,
                              **{f"{name} ms": t_[0] for name, t_ in got.items()
                                 if name.startswith("budget")}}
                del x, y, qx, qy, want
    finally:
        ek._R1_TREE_BYTES = default
    torch.cuda.synchronize()
    shape = "float32, 512 x 512 knots, 1,000,000 queries"
    return {"first_design_ms": out[shape]["first_design_ms"], "shapes": out}


# K2's and R3's trees with --sweeps: K2 at axes past its whole 16 KB f32 tree,
# R3 at NS1b's 262,144 knots and MAX_BIG_KNOTS
K2_TREE_SWEEP = (16 << 10, 32 << 10, 64 << 10, 128 << 10)
R3_TREE_SWEEP = (16 << 10, 32 << 10, 64 << 10, 128 << 10)


def k2_phase(dev, card, rec, sweeps):
    """K2 at the paths' shapes (64 and 256 knots x 1,000,000: the N-D axes;
    512 x 1,000,000: NS3b's calculus axes; 10,000 x 262,144: the bank eval;
    10,240 x 1,000,000: NS2b; 64 x 256: NS5b) and at 2 and 70,001 knots x
    1,000,000, in f32 and f64: each as the wrapper runs it (its rule: the
    first design or its tree), in its first design (0: a thread a query on
    the global search), at one knot (every level of the search on the
    global axis), as leaders (every 16th knot staged) and on the wrapper's
    tree, held bit for bit against ``_index_frac_plain`` (idx and t) on
    queries with NaN, +-inf, +-1e38, the knots and far extrapolation, and
    timed in each.  With ``sweeps``, also trees of 16 to 128 KB past 4,095
    knots, and the shapes where the rule turns (32 and 128 knots x
    1,000,000; 10,000 knots x 2^17 to 2^20).  Returns the keys the kernels
    line adds."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(58)
    default = ek._K2_TREE_BYTES
    cases = [(64, 1_000_000), (256, 1_000_000), (512, 1_000_000), (10_000, 262_144),
             (10_240, 1_000_000), (64, 256), (2, 1_000_000), (70_001, 1_000_000)]
    out = {}
    print(f"K2 by shared-memory budget (the wrapper: its rule, the first design below "
          f"{ek._K2_QUERIES_A_KNOT} queries a knot or on an axis of at most "
          f"{ek._K2_SMALL_AXIS_BYTES} B, else its tree of {default:,} B; 0: the first design; "
          f"one knot: every level global), ms (median [min, max] of {RUNS} runs by CUDA "
          f"events; card: {card}):", flush=True)

    def run(knots_staged, k, q):
        ek._k2_budget = rule if knots_staged is None else lambda n, nq, size: knots_staged
        return ek.fused_index_frac(k, q)

    rule = ek._k2_budget
    if sweeps:  # where the wrapper's rule turns: axis bytes and queries a knot
        cases += [(n, 1_000_000) for n in (32, 128)] + [
            (10_000, nq) for nq in (131_072, 524_288, 1_048_576)]
    try:
        for np_dt in (np.float32, np.float64):
            tag, size = np.dtype(np_dt).name, np.dtype(np_dt).itemsize
            for n, nq in cases:
                kn = make_knots(n, "nonuniform", np_dt, rng)
                k = torch.as_tensor(kn, device=dev)
                q = torch.as_tensor(phase_queries(kn, nq, np_dt, rng), device=dev)
                want = ek._index_frac_plain(k, q)
                label = f"{tag}, {n:,} knots, {nq:,} queries"
                budgets = {"wrapper": None, "first design": 0, "global": 1,
                           "leaders": max(2, n // 16), "tree": default // size - 1}
                if sweeps and n > 4095:
                    budgets |= {f"tree {t_ >> 10} KB": t_ // size - 1 for t_ in K2_TREE_SWEEP}
                ok = all([rec.add_pair("K2", f"{label}, {b_} knots staged", run(b_, k, q), want)
                          for b_ in budgets.values()])
                got = {name: device_ms(lambda b_=b_: run(b_, k, q), 50)
                       for name, b_ in budgets.items()}
                bound_ms = bound("K2", (k, q))[0]
                print(f"  K2 {label} (idx and t at every budget: "
                      f"{'bit-identical' if ok else 'MISMATCH'}); bound {bound_ms:.4f}:",
                      flush=True)
                staged = rule(n, nq, size)
                for name, t_ in got.items():
                    b_ = staged if budgets[name] is None else budgets[name]
                    print(f"    {name} ({b_:,} knots staged): {fmt(t_)}", flush=True)
                out[label] = {"ms": got["wrapper"][0], "knots_staged": staged,
                              "first_design_ms": got["first design"][0],
                              "global_ms": got["global"][0],
                              "leader_ms": got["leaders"][0], "bound_ms": bound_ms,
                              **{f"{name} ms": t_[0] for name, t_ in got.items()
                                 if name.startswith("tree")}}
                del k, q, want
    finally:
        ek._k2_budget = rule
    torch.cuda.synchronize()
    shape = "float32, 10,000 knots, 262,144 queries"
    return {"first_design_ms": out[shape]["first_design_ms"], "shapes": out}


def r3_phase(dev, card, rec, sweeps):
    """R3 on 65,537 knots (the route's shortest axis), NS1b's 262,144 and
    ``MAX_BIG_KNOTS`` (8,388,480) at 1,000,000 float32 queries, and the
    first two in float64: each at the wrapper's budget, in its first design
    (0: 512 sorted f32 leaders in 2 KB), at one knot (every level global)
    and as leaders of every 16th knot (capped at the largest tree a block
    holds), on a cubic and a linear table (+-inf), held bit for bit against
    ``_big_eval_plain`` and K1's ``_eval_plain`` on queries with NaN,
    +-inf, +-1e38, about 100,000 knots themselves and far extrapolation
    (non-uniform axes, the longest on the integers);
    timed on the cubic table in each.  With ``sweeps``, also trees of 16 to
    128 KB at 262,144 and 8,388,480 knots.  Returns the kernels line's
    ``shapes``."""
    import torch

    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(59)
    default = bk._R3_TREE_BYTES
    cases = [(65_537, np.float32), (N_NS1B, np.float32), (bk.MAX_BIG_KNOTS, np.float32),
             (65_537, np.float64), (N_NS1B, np.float64)]
    out = {}
    print(f"R3 by shared-memory budget (0: the first design; one knot: every level global; "
          f"the wrapper's tree {default:,} B), ms (median [min, max] of {RUNS} runs by CUDA "
          f"events; card: {card}):", flush=True)

    def run(knots_staged, *args):
        bk._R3_TREE_BYTES = (knots_staged + 1) * args[0].element_size()
        return bk.big_eval_1d(*args)

    try:
        for n, np_dt in cases:
            tag, size = np.dtype(np_dt).name, np.dtype(np_dt).itemsize
            # float32 values, exact in float64; integers past 2^23 (float32
            # rounds a non-uniform axis's gaps there)
            kn = big_knots(n, "integer" if n > 1 << 22 else "nonuniform", rng)
            q = torch.as_tensor(big_queries(kn, NQ_BIG, rng).astype(np_dt), device=dev)
            k = torch.as_tensor(kn.astype(np_dt), device=dev)
            d, a, b = (torch.as_tensor(rng.normal(size=m).astype(np_dt), device=dev)
                       for m in (n, n - 1, n - 1))
            z = torch.zeros_like(a)
            tables = {"cubic": (d, a, b), "linear": (d, z, z)}
            want = {name: bk._big_eval_plain(k, *t_, q) for name, t_ in tables.items()}
            k1_plain = {name: ek._eval_plain(k, ek.make_interval_table(k, *t_), q)
                        for name, t_ in tables.items()}
            label = f"{tag}, {n:,} knots, {NQ_BIG:,} queries"
            budgets = {"wrapper": default // size - 1, "first design": 0, "global": 1,
                       "leaders": max(2, n // 16)}
            if sweeps and n >= N_NS1B:
                budgets |= {f"tree {t_ >> 10} KB": t_ // size - 1 for t_ in R3_TREE_SWEEP}
            ok = True
            for b_ in budgets.values():
                for name, t_ in tables.items():
                    got = run(b_, k, *t_, q)
                    ok &= rec.add("R3", f"{label}, {b_} knots staged, {name} table", got,
                                  want[name])
                    ok &= rec.add("R3", f"{label}, {b_} knots staged, {name} table, K1's plain "
                                  f"version", got, k1_plain[name])
            got = {name: device_ms(lambda b_=b_: run(b_, k, d, a, b, q), 50)
                   for name, b_ in budgets.items()}
            bound_ms = bound("R3", (k, d, a, b, q))[0]
            print(f"  R3 {label} (every budget, cubic and linear tables, against its plain "
                  f"version and K1's: {'bit-identical' if ok else 'MISMATCH'}); bound "
                  f"{bound_ms:.4f}:", flush=True)
            for name, t_ in got.items():
                print(f"    {name} ({budgets[name]:,} knots staged): {fmt(t_)}", flush=True)
            out[label] = {"ms": got["wrapper"][0], "first_design_ms": got["first design"][0],
                          "global_ms": got["global"][0], "leader_ms": got["leaders"][0],
                          "bound_ms": bound_ms,
                          **{f"{name} ms": t_[0] for name, t_ in got.items()
                             if name.startswith("tree")}}
            del k, q, d, a, b, z, tables, want, k1_plain
            torch.cuda.synchronize()
    finally:
        bk._R3_TREE_BYTES = default
    return {"shapes": out}



# --sweeps: R3idx's float32 axes between 65,537 and 262,144 knots, where its
# first design and R3's tree trade places
R3IDX_CROSSOVER = (98_304, 131_072, 196_608)


def r3idx_phase(dev, card, rec, sweeps):
    """R3idx at R3's shapes: 65,537 knots, NS1b's 262,144 and
    ``MAX_BIG_KNOTS`` (8,388,480) at 1,000,000 float32 queries, and the
    first two in float64: each as the wrapper runs it (R3's 128 KB tree), in
    its first design (0: 512 sorted f32 leaders), at one knot (every level
    global) and as leaders of every 16th knot (capped at the largest tree a
    block holds), idx and t held bit for bit against
    ``_big_index_frac_plain`` and K2's ``_index_frac_plain`` on queries with
    NaN, +-inf, +-1e38, about 100,000 knots themselves and far
    extrapolation, and timed in each.  With ``sweeps``, also trees of 16 to
    128 KB at every shape and the float32 axes of ``R3IDX_CROSSOVER``
    knots.  Returns the kernels line's
    ``first_design_ms`` (NS1b's shape) and ``shapes``."""
    import torch

    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(61)
    default = bk._R3_TREE_BYTES
    cases = [(65_537, np.float32), (N_NS1B, np.float32), (bk.MAX_BIG_KNOTS, np.float32),
             (65_537, np.float64), (N_NS1B, np.float64)]
    if sweeps:  # between the route's shortest axis and NS1b's, where the tree starts to pay
        cases += [(n, np.float32) for n in R3IDX_CROSSOVER]
    out = {}
    print(f"R3idx by shared-memory budget (the wrapper: R3's tree of {default:,} B; 0: the "
          f"first design; one knot: every level global), ms (median [min, max] of {RUNS} runs "
          f"by CUDA events; card: {card}):", flush=True)

    def run(knots_staged, k, q):
        bk._R3_TREE_BYTES = (default if knots_staged is None
                             else (knots_staged + 1) * k.element_size())
        return bk.big_lower_index_frac(k, q)

    try:
        for n, np_dt in cases:
            tag, size = np.dtype(np_dt).name, np.dtype(np_dt).itemsize
            kn = big_knots(n, "integer" if n > 1 << 22 else "nonuniform", rng)
            q = torch.as_tensor(big_queries(kn, NQ_BIG, rng).astype(np_dt), device=dev)
            k = torch.as_tensor(kn.astype(np_dt), device=dev)
            want = bk._big_index_frac_plain(k, q)
            k2_plain = ek._index_frac_plain(k, q)
            label = f"{tag}, {n:,} knots, {NQ_BIG:,} queries"
            budgets = {"wrapper": None, "first design": 0, "global": 1,
                       "leaders": max(2, n // 16)}
            if sweeps:
                budgets |= {f"tree {t_ >> 10} KB": t_ // size - 1 for t_ in R3_TREE_SWEEP[:-1]}
            ok = True
            for b_ in budgets.values():
                got = run(b_, k, q)
                ok &= rec.add_pair("R3idx", f"{label}, {b_} knots staged", got, want)
                ok &= rec.add_pair("R3idx", f"{label}, {b_} knots staged, K2's plain version",
                                   got, k2_plain)
            got = {name: device_ms(lambda b_=b_: run(b_, k, q), 50)
                   for name, b_ in budgets.items()}
            bound_ms = bound("R3idx", (k, q))[0]
            print(f"  R3idx {label} (idx and t at every budget, against its plain version and "
                  f"K2's: {'bit-identical' if ok else 'MISMATCH'}); bound {bound_ms:.4f}:",
                  flush=True)
            staged = default // size - 1
            for name, t_ in got.items():
                b_ = staged if budgets[name] is None else budgets[name]
                print(f"    {name} ({b_:,} knots staged): {fmt(t_)}", flush=True)
            out[label] = {"ms": got["wrapper"][0], "knots_staged": staged,
                          "first_design_ms": got["first design"][0],
                          "global_ms": got["global"][0],
                          "leader_ms": got["leaders"][0], "bound_ms": bound_ms,
                          **{f"{name} ms": t_[0] for name, t_ in got.items()
                             if name.startswith("tree ")}}
            del k, q, want, k2_plain
            torch.cuda.synchronize()
    finally:
        bk._R3_TREE_BYTES = default
    shape = f"float32, {N_NS1B:,} knots, {NQ_BIG:,} queries"
    return {"first_design_ms": out[shape]["first_design_ms"], "shapes": out}

def time_kernels(pairs, systems, card):
    """Device time of each kernel and its plain version on the first input
    of ``systems[kid]``; ``{kid: {"ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms"}}``."""
    times = {}
    print(f"device time per call, ms (median [min, max] of {RUNS} runs by CUDA events, "
          f"queue held full; card: {card}):")
    for kid, (kern, plain, _, (nk, npl)) in pairs.items():
        shape, args = systems[kid][0]
        tk_ = device_ms(lambda: kern(*args), nk)
        tp_ = device_ms(lambda: plain(*args), npl)
        bound_ms, bound_by = bound(kid, args)
        times[kid] = {"ms": tk_[0], "plain_ms": tp_[0], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None}
        print(f"  {kid} {shape}: kernel {fmt(tk_)}, plain {fmt(tp_)}, bound {bound_ms:.4f} "
              f"({bound_by})", flush=True)
    return times


def dense_solve_ms(system, kid):
    """The library yardstick of K4: ``torch.linalg.solve_ex`` on the assembled
    dense (n, n) matrix of a shared-diagonal system (built outside the timed
    window) for every column at once; median ms, printed with its distance
    from the kernel's result."""
    import torch

    from ndarray_interp_tpu_torch.ops import thomas_kernel as tk

    label, (up, mid, low, rhs) = system
    a = torch.diag(mid) + torch.diag(up[:-1], 1) + torch.diag(low[1:], -1)
    # solve_ex: torch.linalg.solve would synchronise to check its info flag
    lib = device_ms(lambda: torch.linalg.solve_ex(a, rhs), 1)
    got, ref = tk.thomas_solve_fast(up, mid, low, rhs), torch.linalg.solve(a, rhs)
    err = float((got - ref).abs().max() / ref.abs().max())
    print(f"  {kid} library call torch.linalg.solve_ex on the dense {tuple(a.shape)} matrix, "
          f"{label}: {fmt(lib)} (scaled distance from the kernel {err:.2e})", flush=True)
    return lib[0]


def end_to_end(calls, what, card, top=3):
    """Host wall time, device busy time, idle share and the ``top`` largest
    kernels of each call."""
    print(f"{what} end to end, ms per call (host wall: median [min, max] of {RUNS} runs "
          f"of a synchronised loop; device busy: one profiled loop; card: {card}):")
    for label, (fn, n) in calls.items():
        wall_t = wall_ms(fn, n)
        busy, largest = busy_ms(fn, n, top)
        print(f"  {label}: host wall {fmt(wall_t)}, device busy {busy:.4f}, "
              f"device idle share {1 - busy / wall_t[0]:.3f}", flush=True)
        for name, ms in largest:
            print(f"      {ms:.4f}  {name[:160]}")


# Peak rates of one H100 SXM at 700 W (NVIDIA's H100 SXM data sheet): HBM
# 3.35 TB/s, float32 67 TFLOP/s, FP64 outside the tensor cores 34 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}  # by the element size of the arithmetic


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _search_steps(n):
    return int(np.ceil(np.log2(n + 1)))


def bound(kid, args):
    """(ms, "bytes" | "operations"): the least time the card could take for
    the kernel's work on ``args``: each input read once and each output
    written once at the HBM rate, or its operations at the peak rate,
    whichever is larger.  Operations count the arithmetic of the source
    (a binary-search step counts as one compare, or two for the pair knots,
    whose widening is an add)."""
    if kid in ("K1", "K2", "K3", "R3", "R3idx"):
        knots, q = args[0], args[-1]
        nq, steps = q.numel(), _search_steps(knots.numel())
        # value; idx + t; idx (float32)
        out = {"K1": 4, "K2": 8, "K3": 4, "R3": 4, "R3idx": 8}[kid] * nq
        nbytes = _nbytes(*args) + out
        ops = nq * ({"K1": 15, "K2": 3, "K3": 0, "R3": 15, "R3idx": 3}[kid] + steps)
        width = q.element_size()
    elif kid in ("K5", "R2a"):  # data, a, b, idx, t | packed, idx, t, bank
        idx, t = (args[3], args[4]) if kid == "K5" else (args[1], args[2])
        bank = args[0][0].numel() if kid == "K5" else args[3]
        elems = idx.numel() * bank
        tables = args[:3] if kid == "K5" else args[:1]
        width = t.element_size()
        nbytes = _nbytes(*tables, idx, t) + width * elems
        ops = 10 * elems  # the symmetric Hermite form
    elif kid == "R1":  # x, y, qx, qy
        x, y, qx, _ = args
        nq, width = qx.numel(), qx.element_size()
        nbytes = _nbytes(*args) + (4 + 2 * width) * nq  # cell int32, tx, ty
        # per query: both searches, the two fractions (2 subtractions and a
        # division each) and the flat cell (a multiply and an add)
        ops = nq * (_search_steps(x.numel()) + _search_steps(y.numel()) + 8)
    elif kid == "R2g":  # data (nx, ny, r), x, y, cell, qx, qy
        data, x, y, cell, qx, qy = args
        elems, width = cell.numel() * data.shape[2], qx.element_size()
        # the grid and the axes once, the cells and queries, the output; three
        # calc_frac lerps (6 operations each) an element
        nbytes = _nbytes(data, x, y, cell, qx, qy) + width * elems
        ops = 18 * elems
    elif kid in ("R2b",) + CELL_TAILS:  # rows_tbl, cell, qx | tx, qy | ty, r
        tbl, cell, a, b, r = args
        elems, width = cell.numel() * r, a.element_size()
        nbytes = _nbytes(tbl, cell, a, b) + width * elems
        # per element: three calc_frac lerps (6 operations each); the weight
        # forms' two bases (9 each), 16 weights, 16 products and 15 adds; the
        # nested form's five scaled Hermite forms (15 each)
        ops = {"R2b": 18, "R2c": 65, "R2d": 65, "R2n": 75}[kid] * elems
    elif kid == "K4":
        rhs = args[3]
        nbytes, ops, width = _nbytes(*args) + _nbytes(rhs), 8 * rhs.numel(), rhs.element_size()
    elif kid in ("K6", "K7"):
        xh, q = args[0], args[-1]
        nq, steps = q.numel(), 2 * _search_steps(xh.numel())
        nbytes = _nbytes(*args) + (8 if kid == "K6" else 12) * nq
        ops = nq * ((22 if kid == "K6" else 8) + steps)
        width = 8
    elif kid in ("K8", "K9"):  # packed, idx, t_hi, t_lo, bank
        packed, idx, th, tl, bank = args
        elems = idx.numel() * bank
        nbytes = _nbytes(packed, idx, th, tl) + 8 * elems
        ops, width = (17 if kid == "K8" else 21) * elems, 8
    elif kid == "ORD":  # xi, yi, row_step, lo, rows, tx_hi, tx_lo, ty_hi, ty_lo
        xi, yi, _, _, _, *t = args
        # the queries' indices and fraction words in (1-D: no yi, no y halves;
        # R2n's flat-cell form: no yi, tx and ty in the tail's dtype), the
        # bytes a record holds out (the row value, qid and the fraction words:
        # 24, 1-D and the f32 flat-cell form 16; the kernel writes 32, the
        # rest padding); a compare and an add a query
        given = [v for v in (xi, yi, *t) if v is not None]
        held = 8 + sum(v.element_size() for v in t if v is not None)
        nbytes, ops, width = _nbytes(*given) + held * xi.numel(), 4 * xi.numel(), 4
    elif kid == "K14":  # packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo
        packed, xi, yi, _, *t = args
        elems = xi.numel() * ((packed.shape[1] - 4) // 8)  # the (Q, r) output pair
        nbytes = _nbytes(packed, xi, yi, *t) + 8 * elems
        # per element: 16 widening adds, 8 derivative scalings, the five scaled
        # Hermite forms (5 x 13) and the split; dx, dy and t per query
        ops, width = 92 * elems, 8
    elif kid in ("K15", "K15f48"):  # packed, idx, t_hi, t_lo, cstrides, nbasis
        packed, idx, th, tl, _, nbasis = args
        k, nq = idx.shape
        nb = nbasis**k
        elems = nq * (packed.shape[1] // (2 * nb if kid == "K15" else 3 * nb // 2))
        nbytes = _nbytes(packed, idx, th, tl) + 8 * elems
        # per element: for each of the nb blocks k - 1 weight products, the
        # widening add, the product and the tree's add; per axis the basis
        # (15 operations cubic, 3 linear) and the widening of t
        ops = elems * (nb * (k + 2) + k * (15 if nbasis == 4 else 3))
        width = 8
    else:  # K10-K13, R4c: packed, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo
        packed, xi, yi, _, *t = args
        bp = packed.shape[1] // CELL_BLOCKS[kid]
        elems = xi.numel() * bp  # the (Q, bp) output pair
        nbytes = _nbytes(packed, xi, yi, *t) + 8 * elems
        # per element: the widening adds, then the lerps (3 x 3), the five
        # scaled Hermite forms (5 x 13) or R4c's two bases (8 each), 16
        # weights, 16 products and 15 sums, and the split of the result
        ops = {"K10": 14, "K11": 14, "R4c": 81}.get(kid, 82) * elems
        width = 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[width] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# a 2-D cell tail's row width in bp
CELL_BLOCKS = {"K10": 8, "K11": 6, "K12": 32, "K13": 24, "R4c": 32}


def row_floor_ms(kid, args):
    """The floor of a design that reads each query's own rows from HBM, as
    queries in random order do: its rows (K15 one cell row, K10-K13 and R4c
    one cell row, K14 four node rows, R2b one corner row, R2c, R2d and R2n
    one cell row), its idx and t pairs (R2b: its coordinates) and its output
    (pair), at the HBM rate.  The rows are read as whole 32-byte sectors."""
    if kid in ("R2b",) + CELL_TAILS:  # rows_tbl, cell, qx | tx, qy | ty, r
        tbl, cell, a, b, r = args
        used = (4 * r + 4 if kid == "R2b" else 16 * r) * tbl.element_size()
        per_query = -(-used // 32) * 32 + r * a.element_size()
        return (cell.numel() * per_query + _nbytes(cell, a, b)) / HBM_BYTES_PER_S * 1e3
    if kid in ("K10", "K11", "K12", "K13", "K14", "R4c"):  # packed, xi, yi, ny, t halves
        packed, xi, yi, _, *t = args
        ch, nq = packed.shape[1], xi.numel()
        if kid == "K14":  # four rows of 8 r + 4 floats, an (r,) output pair
            per_query = 4 * 4 * ch + 8 * ((ch - 4) // 8)
        else:  # one row of blocks x bp floats, a (bp,) output pair
            per_query = 4 * ch + 8 * (ch // CELL_BLOCKS[kid])
        return (nq * per_query + _nbytes(xi, yi, *t)) / HBM_BYTES_PER_S * 1e3
    packed, idx, th, tl, _, nbasis = args
    k, nq = idx.shape
    nb = nbasis**k
    bp = packed.shape[1] // (2 * nb if kid == "K15" else 3 * nb // 2)
    row = packed.shape[1] * packed.element_size()
    return (nq * (row + 8 * bp) + _nbytes(idx, th, tl)) / HBM_BYTES_PER_S * 1e3


ORDER_SWEEP = (4096, 16_384, 65_536, 131_072, 262_144, 524_288)
# K8's sweep (the table in L2, so its crossover is its own): prefixes 2^12-2^20
BANK_SWEEP = (4096, 16_384, 65_536, 131_072, 262_144, 524_288, 1_048_576)


def ordered_tail(kid):
    """``(module, wrapper, plain, f64 entry)`` of a tail that orders its
    batch: K8 and K9 (1-D, by interval), K12, K13, K14 and R4c (by cell), R2c,
    R2d and R2n (by R1's flat cell); the module holds the wrapper's
    ``_orders``."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as e1
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    return {
        "K8": (e1, e1.gathered_df_tail, e1._df_tail_plain, e1._gathered_df_tail_f64),
        "K9": (e1, e1.gathered_f48_tail, e1._f48_tail_plain, e1._gathered_f48_tail_f64),
        "K12": (e2, e2.gathered_bicubic_df_tail, e2._bicubic_df_tail_plain, None),
        "K13": (e2, e2.gathered_bicubic_f48_tail, e2._bicubic_f48_tail_plain,
                e2._gathered_bicubic_f48_tail_f64),
        "K14": (e2, e2.gathered_bicubic_node_df_tail, e2._bicubic_node_df_tail_plain, None),
        "R4c": (e2, e2.gathered_bicubic_df_weight_tail, e2._bicubic_df_weight_tail_plain, None),
        "R2c": (t2, t2.bicubic_gathered_eval, t2._bicubic_weight_plain, None),
        "R2d": (t2, t2.bicubic_tree_tail, t2._bicubic_tree_plain, None),
        "R2n": (t2, t2.bicubic_nested_tail, t2._bicubic_nested_plain, None),
    }[kid]


def wrapper_orders(kid, args):
    """Whether the tail ``kid``'s wrapper orders its batch ``args`` (its
    rule, ``_orders``, at the wrapper's least row bytes): the label of a
    timed branch, never what a check expects."""
    mod, kern, _, _ = ordered_tail(kid)
    if kid in ("K8", "K9"):
        return mod._orders(args[1].shape[0], args[-1])
    if kid in CELL_TAILS:  # rows_tbl, cell, tx, ty, r: 16 r values of row a query
        rows, cell, _, _, r = args
        return mod._orders(cell.shape[0], 16 * r * rows.element_size(), mod._ORDER_MIN_ROW_BYTES)
    fetched = 4 * args[0].shape[1] * (4 if kid == "K14" else 1)
    return mod._orders(args[1].shape[0], fetched, mod._TAILS[kern.__name__][4])


def order_args(kid, args):
    """The ordering's arguments for a tail's ``args``: K8's and K9's 1-D form
    (no yi, no y halves), the flat-cell form (R2c, R2d, R2n), the cell (K12,
    K13, R4c) or the base node (K14)."""
    if kid in ("K8", "K9"):
        packed, idx, th, tl, _ = args
        return (idx, None, 1, 0, packed.shape[0], th, tl, None, None)
    if kid in CELL_TAILS:  # order_by_flat_cell's arguments: the fractions in the tail's dtype
        import torch

        rows, cell, tx, ty, _ = args
        if tx.dtype == torch.float64:
            return (cell, None, 1, 0, rows.shape[0], tx, None, ty, None)
        return (cell, None, 1, 0, rows.shape[0], tx, ty, None, None)
    packed, xi, yi, ny, *t = args
    row_step, lo = (ny, -(ny + 1)) if kid == "K14" else (ny - 1, 0)
    return (xi, yi, row_step, lo, packed.shape[0], *t)


def ordered_phase(kid, system, card, rec, sweeps, extra=(), sweep=ORDER_SWEEP):
    """K8, K9, K12, K13, K14, R4c, R2c, R2d or R2n on a path's table and
    queries ``system``: the ordering (by interval for K8 and K9, by cell else;
    R2c's, R2d's and R2n's keyed on R1's flat cell, its fractions in the
    tail's dtype) in the form the
    wrapper picks for the table held against its plain version (the same
    bucket keys, a permutation of the queries, and each query's record, its
    row value and fraction halves, bit for bit the plain one's) and timed
    apart beside the first design and ``torch.argsort`` of the same keys,
    each with its kernels from the profiler (the phases); then both branches
    of the tail, ordered and the unordered body, held bit for bit against the
    plain version (K8, K9 and K13 in both store forms, the float64 one against
    ``df_to_f64`` of the plain pair) and timed in turn on the path's
    queries, on all of them in one cell or interval and on them already in
    order.  With ``sweeps``, also on prefixes of ``sweep`` queries (the
    crossover behind the wrappers' choice) and on the ``extra`` (label,
    args, sweep) (a sweep of prefixes too where one is given).  Returns the
    keys the kernels line adds."""
    import torch

    from ndarray_interp_tpu_torch.ops import cell_order as co
    from ndarray_interp_tpu_torch.ops.df import df_to_f64

    mod, kern, plain, kern64 = ordered_tail(kid)
    label, args = system
    packed = args[0]
    oargs = order_args(kid, args)
    rows, nq = packed.shape[0], oargs[0].shape[0]
    one_d = kid in ("K8", "K9")
    flat = one_d or kid in CELL_TAILS  # args (table, key, two fraction operands, width)
    key = "interval" if one_d else "cell"
    form = co._form(co.bucket_count(rows))

    values = co.row_values(*oargs[:5])
    keys = co.bucket_keys(values, rows)
    want = co._order_plain(*oargs)
    want_query = want[want[:, 1].long().argsort()]  # each query's record, in query order
    bad = []
    # the wrapper's form, and the first design (the global form) where that is another
    forms = [("", lambda: co.order_by_cell(*oargs))]
    if form != co.GLOBAL:
        forms.append((", the first design", lambda: co._order_kernel(oargs, co.GLOBAL)))
    for what, fn in forms:
        records = fn()
        v, qid = records[:, 0].long(), records[:, 1].long()
        if not torch.equal(co.bucket_keys(v, rows), co.bucket_keys(want[:, 0].long(), rows)):
            bad.append(f"bucket keys{what}")
        if not torch.equal(torch.sort(qid).values, torch.arange(nq, device=packed.device)):
            bad.append(f"permutation{what}")
        elif not rec.add("ORD", f"for {kid} {label}{what}, each query's record",
                         records[qid.argsort()], want_query):
            bad.append(f"records{what}")
        del records, v, qid
    del want, want_query
    order = device_ms(lambda: co.order_by_cell(*oargs), 10)
    first = order if form == co.GLOBAL else device_ms(
        lambda: co._order_kernel(oargs, co.GLOBAL), 10)
    order_plain = device_ms(lambda: co._order_plain(*oargs), 2)
    argsort = device_ms(lambda: torch.argsort(keys), 10)
    order_bound = bound("ORD", oargs)[0]
    name = "shared" if form == co.SHARED else "global"
    print(f"  ORD ordering by {key} for {kid}, {label} "
          f"({co.bucket_count(rows):,} buckets of 2^{co.bucket_shift(rows)} rows; the {name} "
          f"form): {'matches its plain version' if not bad else bad} (bucket keys, "
          f"permutation, each query's record); kernel {fmt(order)}, the first design (the "
          f"global form: global atomics, a memset, two scans) {fmt(first)}, plain (stable "
          f"argsort) {fmt(order_plain)}, bound {order_bound:.4f} (bytes); library call "
          f"torch.argsort of the same keys {fmt(argsort)}", flush=True)
    phases = [(f"the {name} form", lambda: co.order_by_cell(*oargs))]
    if form != co.GLOBAL:
        phases.append(("the first design", lambda: co._order_kernel(oargs, co.GLOBAL)))
    for what, fn in phases:
        busy, top = busy_ms(fn, 10, top=6)
        print(f"    phases of {what} by the profiler (busy {busy:.4f}):", flush=True)
        for kernel, ms in top:
            print(f"      {ms:.4f}  {kernel[:120]}")
    if bad:
        fail(f"ORD for {kid} {label}: {', '.join(bad)} differ from the plain ordering")

    orders = mod._orders

    def branches(what, a, calls, check=True, f64_time=False):
        """Both branches held against the plain version (and the float64
        store form against its recombined pair) and timed in turn:
        ordered, unordered, unordered, ordered; the median of each pair."""
        want = plain(*a) if check else None
        res, res64, ok = {True: [], False: []}, {True: [], False: []}, True
        try:
            for ordered in (True, False, False, True):
                mod._orders = lambda *_, ordered=ordered: ordered
                if check and not res[ordered]:
                    name = "ordered" if ordered else "unordered"
                    add = rec.add if kid in CELL_TAILS else rec.add_pair
                    ok &= add(kid, f"{what}, {name}", kern(*a), want)
                    if kern64 is not None:
                        ok &= rec.add(kid, f"{what}, {name}, float64 store form", kern64(*a),
                                      df_to_f64(*want))
                res[ordered].append(device_ms(lambda: kern(*a), calls)[0])
                if f64_time:
                    res64[ordered].append(device_ms(lambda: kern64(*a), calls)[0])
        finally:
            mod._orders = orders
        got = {k: float(np.median(v)) for k, v in res.items()}
        n = a[1].shape[0]
        per_query = (16 * a[4] * a[0].element_size() if kid in CELL_TAILS else
                     4 * a[0].shape[1] * (4 if kid == "K14" else 1))
        forms = " (both store forms)" if kern64 is not None else ""
        verdict = ("both bit-identical to" if ok else "MISMATCH against") if check else (
            "not compared here:")
        picks = wrapper_orders(kid, a)
        print(f"  {kid} {what}: {n:,} queries, {per_query:,} B of rows a query: ordered "
              f"{got[True]:.4f} (ordering included), unordered body {got[False]:.4f} ms; "
              f"{verdict} the plain version{forms}; the wrapper takes the "
              f"{'ordered' if picks else 'unordered'} branch", flush=True)
        if f64_time:
            got64 = {k: float(np.median(v)) for k, v in res64.items()}
            print(f"  {kid} {what}, float64 store form: ordered {got64[True]:.4f}, unordered "
                  f"body {got64[False]:.4f} ms", flush=True)
            got |= {("f64", k): v for k, v in got64.items()}
        return got

    def prefix(a, n):
        if flat:
            return (a[0], a[1][:n], a[2][:n], a[3][:n], a[4])
        return (a[0], a[1][:n], a[2][:n], a[3], *(v[:n] for v in a[4:]))

    if not one_d:
        print(f"  {kid} {label}: bound {bound(kid, args)[0]:.4f} (bytes), row-read floor "
              f"{row_floor_ms(kid, args):.4f} (each query's own rows from HBM)", flush=True)
    else:
        print(f"  {kid} {label}: bound {bound(kid, args)[0]:.4f} (bytes)", flush=True)
    main = branches(label, args, 5, f64_time=kern64 is not None)
    if flat:
        hot = (packed, torch.full_like(args[1], int(args[1][0])), *args[2:])
        branches(f"all queries in one {key}", hot, 5)
    else:
        hot = (packed, torch.full_like(args[1], int(args[1][0])),
               torch.full_like(args[2], int(args[2][0])), *args[3:])
        branches("all queries in one cell", hot, 5)
    del hot
    perm = torch.argsort(values, stable=True)
    if flat:
        srt = (packed, args[1][perm], args[2][perm], args[3][perm], args[4])
    else:
        srt = (packed, args[1][perm], args[2][perm], args[3], *(v[perm] for v in args[4:]))
    branches(f"queries already in {key} order", srt, 5)
    del perm, values, keys, srt
    for n in sweep if sweeps else ():
        if n < nq:
            branches(f"first {n:,} queries", prefix(args, n), 20 if n <= 65_536 else 5)
    for what, a, sub in extra if sweeps else ():
        branches(what, a, 5, check=a[1].shape[0] * 4 * a[0].shape[1] <= 2**33)
        for n in sub:
            if n < a[1].shape[0]:
                branches(f"{what}, first {n:,} queries", prefix(a, n), 20 if n <= 65_536 else 5)
    torch.cuda.synchronize()
    out = {"ordered_ms": main[True], "unordered_ms": main[False], "order_ms": order[0],
           "order_first_ms": first[0],
           "order_plain_ms": order_plain[0], "order_bound_ms": order_bound,
           "order_library_ms": argsort[0], "order_form": name}
    if not one_d:
        out["row_floor_ms"] = row_floor_ms(kid, args)
    if kern64 is not None:
        out |= {"f64_ms": main["f64", True], "unordered_f64_ms": main["f64", False]}
    return out


# K7's shared-knot budgets timed at 10,240 and 70,001 knots: 1 is one staged
# knot, every level of the search on the global pairs (the search of the
# first design); trees of 4,095 and 8,191 knots; 16,383 holds a 10,240-knot
# axis whole
K7_BUDGETS = (1, 4095, 8191, 16_383)


def k7_phase(x, qbp, card, rec):
    """K7 at the serving path's axis and queries, at the 2-D path's
    (512 knots) and the N-D path's (64 knots) axis width on 1,000,000
    queries, and on a 70,001-knot axis: each at the wrappers' shared-knot
    budget and at budget 1 (every level of the search on the global pairs,
    as in the first design), held bit for bit against the plain version and
    timed in the same run; the serving shape also with every query in one
    interval (all lanes on the same lines), and a sweep of the budget at
    10,240 and 70,001 knots.  Returns the keys the kernels line adds."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_from_f64

    rng = np.random.default_rng(53)

    def pair(v):
        return df_from_f64(torch.as_tensor(np.asarray(v, np.float64), device=qbp[0].device))

    default = ek._K7_SHARED_KNOTS
    mid = (float(x[0][5000]) + float(x[0][5001])) / 2
    hot = pair(np.full(qbp[0].shape[0], mid))
    cases = [("serving axis, 10,240 knots, 2^20 queries", x, qbp, K7_BUDGETS),
             ("serving axis, all 2^20 queries in one interval", x, hot, ())]
    for n, what in ((512, "2-D"), (64, "N-D"), (70_001, "long")):
        kn = df_knots(n, "nonuniform", rng)
        q = pair(rng.uniform(kn[0], kn[-1], 1_000_000))
        cases.append((f"{what} axis, {n:,} knots, 1,000,000 queries", pair(kn), q,
                      K7_BUDGETS if n > 10_000 else ()))
    out = {}
    print(f"K7 by shared-knot budget (1: every level on the global pairs, the first design's "
          f"search; the wrapper's budget {default:,}), ms (median [min, max] of {RUNS} runs by "
          f"CUDA events; card: {card}):", flush=True)
    try:
        for label, xs, qs, sweep in cases:
            want = ek._df_index_frac_xla(*xs, *qs)
            got = {}
            for budget in sorted({1, default, *sweep}):
                ek._K7_SHARED_KNOTS = budget
                ok = rec.add_pair("K7", f"{label}, budget {budget}",
                                  ek.fused_index_frac_df(*xs, *qs), want)
                got[budget] = device_ms(lambda: ek.fused_index_frac_df(*xs, *qs), 50)
                print(f"  K7 {label}, budget {budget:,}: {fmt(got[budget])} "
                      f"({'bit-identical' if ok else 'MISMATCH'})", flush=True)
            ek._K7_SHARED_KNOTS = default
            bound_ms = bound("K7", (*xs, *qs))[0]
            print(f"  K7 {label}: {got[default][0]:.4f} against {got[1][0]:.4f} with every "
                  f"level global ({got[1][0] / got[default][0]:.2f}x); bound {bound_ms:.4f}",
                  flush=True)
            out[label] = {"ms": got[default][0], "global_ms": got[1][0], "bound_ms": bound_ms}
            del want
    finally:
        ek._K7_SHARED_KNOTS = default
    torch.cuda.synchronize()
    return {"global_search_ms": out[cases[0][0]]["global_ms"], "shapes": out}



# K6's shapes: the scalar serving spline's 4,096 knots (the whole axis staged,
# its rows widened beside it) and axes past the whole tree's 16,383 knots
# (leaders), at the serving path's 2^20 queries
K6_KNOTS = (4096, 20_000, 70_001)


def k6_phase(dev, card, rec, sweeps):
    """K6 on ``K6_KNOTS`` non-uniform knots at 2^20 queries: at the
    wrapper's budget (K7's: the whole axis up to 16,383 knots, its rows
    widened into shared memory where they fit, leaders above), in its first
    design (0: a thread a query on the global pairs), at one knot (every level global) and as leaders of every
    16th knot, on a cubic and a linear table (+-inf) and, at 4,096 knots,
    on knots that collide in float32; each held bit for bit against
    ``eval_xla_df`` (NaN on index 0, +-inf, +-1e300, the knots, the
    midpoints) and, in the float64 store form, against ``df_to_f64`` of it;
    timed on the cubic table in each, the store forms at the wrapper's
    budget and in the first design.  With ``sweeps``, also the whole tree
    against leaders at 4,096 knots (budgets 1,023 and 4,095).  Returns the
    kernels line's ``first_design_ms``, ``f64_ms``, ``f64_first_design_ms``
    (the serving shape) and ``shapes``."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    rng = np.random.default_rng(60)
    default = ek._K6_SHARED_KNOTS
    nq = 1 << 20
    out = {}
    print(f"K6 by shared-knot budget (0: the first design; one knot: every level on the global "
          f"pairs; the wrapper's budget {default:,}), ms (median [min, max] of {RUNS} runs by "
          f"CUDA events; card: {card}):", flush=True)

    def pair(v):
        return df_from_f64(torch.as_tensor(np.asarray(v, np.float64), device=dev))

    def run(budget, args, f64=False):
        ek._K6_SHARED_KNOTS = budget
        return (ek._fused_eval_1d_df_f64 if f64 else ek.fused_eval_1d_df)(*args)

    try:
        for n in K6_KNOTS:
            xs = rep(np.cumsum(rng.uniform(0.1, 1.0, n)))
            vals, a, b = (rep(rng.normal(size=m)) for m in (n, n - 1, n - 1))
            q = rep(rng.uniform(xs[0], xs[-1], nq - 2 * n - 7))
            q = rng.permutation(np.r_[q, xs, (xs[:-1] + xs[1:]) / 2,
                                      [np.nan, np.inf, -np.inf, 1e300, -1e300, -1e6, 1e9]])
            qp = pair(q)
            label = f"{n:,} knots, {nq:,} queries"
            budgets = {"wrapper": default, "first design": 0, "global": 1,
                       "leaders": max(2, n // 16)}
            if sweeps and n == K6_KNOTS[0]:
                budgets |= {f"leaders, budget {b_:,}": b_ for b_ in (1023, 4095)}
            tables = {"cubic": (vals, a, b), "linear": (2.0 * xs + 1.0, 0 * a, 0 * b)}
            if n == K6_KNOTS[0]:
                xc = rep(np.cumsum(rng.uniform(1e-9, 1e-7, n)) + 1.0)
                tables["collide, linear"] = (2.0 * xc + 1.0, 0 * a, 0 * b)
            ok = True
            for tname, (d, ta, tb) in tables.items():
                kn = xc if tname.startswith("collide") else xs
                args = (*pair(kn), *(h for v in (d, ta, tb) for h in pair(v)), *qp)
                want = ek.eval_xla_df(*args)
                want64 = df_to_f64(*want)
                for name, b_ in budgets.items():
                    ok &= rec.add_pair("K6", f"{label} {tname}, {name}", run(b_, args), want)
                    ok &= rec.add("K6", f"{label} {tname}, {name}, float64 store form",
                                  run(b_, args, True), want64)
                del want, want64
            args = (*pair(xs), *(h for v in (vals, a, b) for h in pair(v)), *qp)
            got = {name: device_ms(lambda b_=b_: run(b_, args), 50)
                   for name, b_ in budgets.items()}
            f64 = {name: device_ms(lambda: run(budgets[name], args, True), 50)
                   for name in ("wrapper", "first design")}
            bound_ms = bound("K6", args)[0]
            print(f"  K6 {label} (every budget, cubic and linear tables, both "
                  f"store forms: {'bit-identical' if ok else 'MISMATCH'}); bound "
                  f"{bound_ms:.4f}:", flush=True)
            for name, t_ in got.items():
                print(f"    {name} (budget {budgets[name]:,}): {fmt(t_)}", flush=True)
            for name, t_ in f64.items():
                print(f"    {name}, float64 store form: {fmt(t_)}", flush=True)
            out[label] = {"ms": got["wrapper"][0], "first_design_ms": got["first design"][0],
                          "global_ms": got["global"][0], "leader_ms": got["leaders"][0],
                          "f64_ms": f64["wrapper"][0],
                          "f64_first_design_ms": f64["first design"][0], "bound_ms": bound_ms,
                          **{f"{name} ms": t_[0] for name, t_ in got.items()
                             if name.startswith("leaders, ")}}
            del args, qp
            torch.cuda.synchronize()
    finally:
        ek._K6_SHARED_KNOTS = default
    head = out[f"{K6_KNOTS[0]:,} knots, {nq:,} queries"]
    return {key: head[key] for key in ("first_design_ms", "f64_ms", "f64_first_design_ms")} | {
        "shapes": out}

# --sweeps: ORD's forms by bucket count, the data behind SHARED_MAX_BUCKETS
ORD_BUCKETS = (1024, 4096, 8192, 16_384, 24_576, 32_768, 49_152)


def ord_form_sweep(dev, card):
    """ORD in each form (the shared form, and the global form of the first
    design) on 2^20 1-D queries uniform over ``ORD_BUCKETS`` intervals, each
    held against the plain ordering (each query's record, bit for bit) and
    timed: the crossover of the two."""
    import torch

    from ndarray_interp_tpu_torch.ops import cell_order as co

    rng = np.random.default_rng(54)
    n = 1 << 20
    th, tl = (torch.as_tensor(rng.uniform(-1, 2, n), dtype=torch.float32, device=dev)
              for _ in range(2))
    names = {co.SHARED: "shared", co.GLOBAL: "global (the first design)"}
    print(f"ORD by form and bucket count, 2^20 1-D queries (ms, median [min, max]; the "
          f"wrapper's limit of the shared form {co.SHARED_MAX_BUCKETS:,}; card: {card}):",
          flush=True)
    for rows in ORD_BUCKETS:
        xi = torch.as_tensor(rng.integers(0, rows, n), dtype=torch.int32, device=dev)
        args = (xi, None, 1, 0, rows, th, tl, None, None)
        want = co._order_plain(*args)
        want = want[want[:, 1].long().argsort()]
        got = {}
        for form in (co.SHARED, co.GLOBAL):
            records = co._order_kernel(args, form)
            same = bit_compare(records[records[:, 1].long().argsort()], want)[0]
            got[form] = device_ms(lambda: co._order_kernel(args, form), 10)
            if not same:
                fail(f"ORD {names[form]} form on {rows:,} intervals differs from the plain "
                     "ordering")
        print(f"  {rows:,} intervals: " + ", ".join(f"{names[f]} {fmt(t)}" for f, t in got.items()),
              flush=True)


def df_timing(serving, card, rec, sweeps):
    """Hold K6-K9, through their wrappers, against their plain versions on
    the serving path's own tables and queries; time both there; K7 by its
    shared-knot budget (``k7_phase``), K6 by its budget and store form
    (``k6_phase``); K8's and K9's ordering by interval and both of their
    branches in both store forms (``ordered_phase``); the scalar evaluator
    on K6 and on K6's first design in turns, its device busy time and its
    synchronised host wall; then time each evaluator call end to end with
    its eight largest kernels."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops.df import df_from_f64

    ev_df, qb = serving["df"]
    ev48, _ = serving["f48"]
    ev_s, qs = serving["scalar"]
    qbp, qsp = df_from_f64(qb), df_from_f64(qs)
    x = ev_df._run.args[:2]
    idx, th, tl = ek.fused_index_frac_df(*x, *qbp)
    nq = f"{qb.numel():,} queries"
    systems = {
        "K6": [(f"scalar 4,096 knots, {nq}", (*ev_s._run.args, *qsp))],
        "K7": [(f"10,240 knots, {nq}", (*x, *qbp))],
        "K8": [(f"10,240 x 64 df table, {nq}", (ev_df._packed, idx, th, tl, 64))],
        "K9": [(f"10,240 x 64 f48 table, {nq}", (ev48._packed, idx, th, tl, 64))],
    }
    pairs = {
        "K6": (ek.fused_eval_1d_df, ek.eval_xla_df, rec.add_pair, (50, 5)),
        "K7": (ek.fused_index_frac_df, ek._df_index_frac_xla, rec.add_pair, (50, 5)),
        "K8": (ek.gathered_df_tail, ek._df_tail_plain, rec.add_pair, (10, 2)),
        "K9": (ek.gathered_f48_tail, ek._f48_tail_plain, rec.add_pair, (10, 2)),
    }
    print("double-float kernels at the serving path's tables and queries, against their "
          "plain versions:")
    for kid, (kern, plain, compare, _) in pairs.items():
        label, args = systems[kid][0]
        ok = compare(kid, label, kern(*args), plain(*args))
        print(f"  {kid} {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)
    times = time_kernels(pairs, systems, card)
    times["K7"].update(k7_phase(x, qbp, card, rec))
    times["K6"].update(k6_phase(qb.device, card, rec, sweeps))

    # K8 and K9 at the serving path's tables and queries, ordered by interval
    # and unordered, and on banks of 8, 256 (the table past the L2) and 63
    # (one column a lane) at the same queries: the sweeps behind the
    # wrapper's choice
    rng = np.random.default_rng(52)
    n = x[0].shape[0]

    def bank_table(pack, bank):
        vals = (rng.normal(size=(n, bank)), rng.normal(size=(n - 1, bank)),
                rng.normal(size=(n - 1, bank)))
        return pack(*(h for v in vals for h in df_from_f64(torch.as_tensor(v, device=qb.device))))

    for kid, grade, pack in (("K8", "df", ek.pack_bank_rows_df),
                             ("K9", "f48", ek.pack_bank_rows_f48)):
        extra = [(f"{n:,} x {bank} {grade} table", (bank_table(pack, bank), idx, th, tl, bank),
                  BANK_SWEEP if bank != 63 else ()) for bank in ((8, 256, 63) if sweeps else ())]
        print(f"{kid} at the serving path's table and queries, ordered by interval and "
              "unordered:", flush=True)
        times[kid].update(ordered_phase(kid, systems[kid][0], card, rec, sweeps, extra,
                                        BANK_SWEEP))
        del extra
    if sweeps:
        ord_form_sweep(qb.device, card)

    # the scalar evaluator on K6 at the wrapper's budget and in its first
    # design, in turns (A B B A): device busy from the profiler (the call's
    # eager NaN check syncs the host, so CUDA events around it would time
    # the host too) and the host wall of a synchronised loop, what a caller
    # waits for
    print(f"scalar DoubleFloatEvaluator, 4,096 knots at {nq}, in turns: device busy per call "
          f"from the profiler, host wall per call (median [min, max] of {RUNS} runs of a "
          f"synchronised loop of 10 calls; card: {card}):", flush=True)
    default = ek._K6_SHARED_KNOTS
    want = ev_s(qs)
    turns = {default: [], 0: []}
    try:
        for budget in (default, 0, 0, default):
            ek._K6_SHARED_KNOTS = budget
            if not bit_compare(ev_s(qs), want)[0]:
                fail(f"the scalar DoubleFloatEvaluator on K6 at budget {budget} differs")
            turns[budget].append((*busy_ms(lambda: ev_s(qs), 10, top=1),
                                  wall_ms(lambda: ev_s(qs), 10)))
    finally:
        ek._K6_SHARED_KNOTS = default
    for budget, name in ((default, "K6 at the wrapper's budget"), (0, "K6's first design")):
        print(f"  {name}: " + "; ".join(
            f"busy {b:.4f}" + (f" (largest: {top[0][1]:.4f} {top[0][0][:60]})" if top else "")
            + f", host wall {fmt(w)}" for b, top, w in turns[budget]), flush=True)
    for key, budget in (("scalar_serving", default), ("scalar_serving_first_design", 0)):
        times["K6"][f"{key}_busy_ms"] = float(np.mean([b for b, _, _ in turns[budget]]))
        times["K6"][f"{key}_wall_ms"] = float(np.mean([w[0] for _, _, w in turns[budget]]))
    del want

    ev1, q1 = serving["K1"]
    end_to_end({
        f"DoubleFloatEvaluator df, 10,240 x 64 at {nq} (f64, on the card)": (lambda: ev_df(qb), 3),
        f"DoubleFloatEvaluator f48, 10,240 x 64 at {nq}": (lambda: ev48(qb), 3),
        f"scalar DoubleFloatEvaluator, 4,096 knots at {nq}": (lambda: ev_s(qs), 10),
        f"Evaluator NS1 f32, 2048 knots at {q1.numel():,} queries": (lambda: ev1(q1), 10),
    }, "serving", card, top=8)
    return times


# -- the 2-D slice -----------------------------------------------------------------------
# Config 3 of the JAX package (benches/run_benches.py:501-676): a 512 x 512 grid of
# 16 channels, 1,000,000 scattered queries; here with non-uniform axes.
GRID2D = (512, 512, 16)
NQ2D = 1_000_000
NQ_BICUBIC_ORACLE = 131_072  # the DF bicubic oracle gathers 2 KB a query on the host
F48_REPORTED = 3e-9  # the JAX package's on-chip f48 gates (tests/test_tpu_parity.py:714, :796)
R4C_VS_K12 = 1e-13  # the weight form against the nested form, scale-relative


def df2d_kernel_phases(dev, rec):
    """K10-K13 and R4c against their plain versions on the card, on the same
    inputs: the ``(idx, t)`` that K7 gives for 1,000,000 queries per axis
    (NaN, +-inf, +-1e38, the knots themselves and far extrapolation, so
    fractions far outside [0, 1]) on grids up to 512 x 512, at r in {1, 3,
    16, 20} channels (bp = 8, 8, 16, 24: the padding is exercised).  R4c also
    against K12 where both fractions lie in [-1, 2]: the same function summed
    in another order, within ``R4C_VS_K12`` scale-relative."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    rng = np.random.default_rng(2)

    def pair(v):
        return df_from_f64(torch.as_tensor(np.asarray(v, np.float64), device=dev))

    print("2-D double-float kernel phases (kernel against its plain version, same inputs):",
          flush=True)
    for nx, ny, r in ((3, 3, 1), (37, 21, 3), (512, 512, 1), (200, 150, 3), (512, 512, 16),
                      (96, 80, 20)):
        kx, ky = df_knots(nx, "nonuniform", rng), df_knots(ny, "nonuniform", rng)
        xi, txh, txl = ek.fused_index_frac_df(*pair(kx), *pair(make_queries(
            kx, NQ2D, np.float64, rng)))
        yi, tyh, tyl = ek.fused_index_frac_df(*pair(ky), *pair(rng.permutation(make_queries(
            ky, NQ2D, np.float64, rng))))
        z = pair(rng.normal(size=(nx, ny, r)))
        rows = pair(rng.normal(size=((nx - 1) * (ny - 1), 16 * r)))
        label = f"{nx} x {ny} x {r} (bp {-(-r // 8) * 8}), {NQ2D:,} queries"
        ok = True
        for kid, kernel, plain, packed in (
            ("K10", e2.gathered_bilinear_df_tail, e2._bilinear_df_tail_plain,
             e2.pack_bilinear_rows_df(*z)),
            ("K11", e2.gathered_bilinear_f48_tail, e2._bilinear_f48_tail_plain,
             e2.pack_bilinear_rows_f48(*z)),
            ("K12", e2.gathered_bicubic_df_tail, e2._bicubic_df_tail_plain,
             e2.pack_bicubic_rows_df(*rows, r)),
            ("K13", e2.gathered_bicubic_f48_tail, e2._bicubic_f48_tail_plain,
             e2.pack_bicubic_rows_f48(*rows, r)),
        ):
            args = (packed, xi, yi, ny, txh, txl, tyh, tyl)
            ok &= rec.add_pair(kid, label, kernel(*args), plain(*args))
        args = (e2.pack_bicubic_rows_df(*rows, r), xi, yi, ny, txh, txl, tyh, tyl)
        weight = e2.gathered_bicubic_df_weight_tail(*args)
        ok &= rec.add_pair("R4c", label, weight, e2._bicubic_df_weight_tail_plain(*args))
        # R4c against K12 where both fractions lie in [-1, 2]
        near = ((df_to_f64(txh, txl) - 0.5).abs() <= 1.5) & (
            (df_to_f64(tyh, tyl) - 0.5).abs() <= 1.5)
        err = df_scaled_err(df_to_f64(*weight)[near, :r].cpu().numpy(),
                            df_to_f64(*e2.gathered_bicubic_df_tail(*args))[near, :r].cpu().numpy())
        print(f"  {label}: K10, K11, K12, K13, R4c {'bit-identical' if ok else 'MISMATCH'}; "
              f"R4c against K12 on {int(near.sum()):,} queries {err:.3e} (gate {R4C_VS_K12:g})",
              flush=True)
        if not err <= R4C_VS_K12:
            fail(f"R4c {label}: {err} from K12, above {R4C_VS_K12}")
        del z, rows, args, weight
        torch.cuda.synchronize()


def tail2d_kernel_phases(dev, rec):
    """R1, R2b, R2g, R2c, R2d and R2n against their plain versions on the
    card, on the same inputs, in f32 and f64: the cells and fractions R1
    gives for 1,000,000 queries per axis (NaN, +-inf, +-1e38, the knots
    themselves and far extrapolation, so fractions far outside [0, 1]) on
    grids up to 512 x 512 at r in {1, 3, 16, 20} channels; R1 also against
    K3's index of each axis and K2's fractions; R2g also against R2b's plain
    version on ``pack_corner_rows`` of its grid; R2c, R2d and R2n each in
    both branches (the wrapper's, and the other forced)."""
    import torch

    from ndarray_interp_tpu_torch.models.strategies.bilinear import pack_corner_rows
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    rng = np.random.default_rng(3)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    print("2-D cell-route kernel phases (kernel against its plain version, same inputs):",
          flush=True)
    for np_dt in (np.float32, np.float64):
        tag = np.dtype(np_dt).name
        for nx, ny, r in ((3, 3, 1), (512, 512, 1), (200, 150, 3), (512, 512, 16), (96, 80, 20)):
            kx, ky = make_knots(nx, "nonuniform", np_dt, rng), make_knots(ny, "log", np_dt, rng)
            x, y = T(kx), T(ky)
            qx = T(make_queries(kx, NQ2D, np_dt, rng))
            qy = T(rng.permutation(make_queries(ky, NQ2D, np_dt, rng)))
            label = f"{tag} {nx} x {ny} x {r}, {NQ2D:,} queries"
            cell, tx, ty = ek.fused_cell_index(x, y, qx, qy)
            ok = rec.add_pair("R1", label, (cell, tx, ty), ek._cell_index_plain(x, y, qx, qy))
            ok &= rec.add("R1", f"{label} against K3", cell, ek.fused_lower_index(x, qx) * (ny - 1)
                          + ek.fused_lower_index(y, qy))
            ok &= rec.add_pair("R1", f"{label} against K2", (tx, ty),
                               (ek.fused_index_frac(x, qx)[1], ek.fused_index_frac(y, qy)[1]))
            grid = T(rng.normal(size=(nx, ny, r)).astype(np_dt))
            corners = pack_corner_rows(x, y, grid)
            want = t2._bilinear_plain(corners, cell, qx, qy, r)
            ok &= rec.add("R2b", label, t2.bilinear_gathered_eval(corners, cell, qx, qy, r), want)
            got = t2.bilinear_grid_eval(grid, x, y, cell, qx, qy)
            ok &= rec.add("R2g", label, got, t2._bilinear_grid_plain(grid, x, y, cell, qx, qy))
            ok &= rec.add("R2g", f"{label} against R2b's plain version", got, want)
            del corners, grid, got, want
            rows = T(rng.normal(size=((nx - 1) * (ny - 1), 16 * r)).astype(np_dt))
            orders = t2._orders
            picks = orders(NQ2D, 16 * r * rows.element_size(), t2._ORDER_MIN_ROW_BYTES)
            for kid in CELL_TAILS:
                _, kernel, plain, _ = ordered_tail(kid)
                want = plain(rows, cell, tx, ty, r)
                ok &= rec.add(kid, label, kernel(rows, cell, tx, ty, r), want)
                t2._orders = lambda *_: not picks  # the other branch
                try:
                    ok &= rec.add(kid, f"{label}, {'un' if picks else ''}ordered branch",
                                  kernel(rows, cell, tx, ty, r), want)
                finally:
                    t2._orders = orders
                del want
            print(f"  {label}: R1 (also against K3 and K2), R2b, R2g (also against R2b's plain "
                  f"version), R2c, R2d, R2n (each in both branches) "
                  f"{'bit-identical' if ok else 'MISMATCH'}", flush=True)
            del rows, cell, tx, ty, qx, qy
            torch.cuda.synchronize()


def bilinear_oracle(x, y, z, qx, qy):
    """The float64 lerp form on double-float-rounded inputs
    (``tests/test_tpu_parity.py:454-465``)."""
    xi = np.clip(np.searchsorted(x, qx, side="right") - 1, 0, x.size - 2)
    yi = np.clip(np.searchsorted(y, qy, side="right") - 1, 0, y.size - 2)
    tx = ((qx - x[xi]) / (x[xi + 1] - x[xi]))[:, None]
    ty = ((qy - y[yi]) / (y[yi + 1] - y[yi]))[:, None]
    z1 = z[xi, yi] + tx * (z[xi + 1, yi] - z[xi, yi])
    z2 = z[xi, yi + 1] + tx * (z[xi + 1, yi + 1] - z[xi, yi + 1])
    return z1 + ty * (z2 - z1)


def bicubic_oracle(x, y, rows, r, qx, qy):
    """The float64 scaled-Hermite form on double-float-rounded cell rows
    (``tests/test_tpu_parity.py:519-542``)."""
    xi = np.clip(np.searchsorted(x, qx, side="right") - 1, 0, x.size - 2)
    yi = np.clip(np.searchsorted(y, qy, side="right") - 1, 0, y.size - 2)
    tx = ((qx - x[xi]) / (x[xi + 1] - x[xi]))[:, None]
    ty = ((qy - y[yi]) / (y[yi + 1] - y[yi]))[:, None]
    cell = rows[xi * (y.size - 1) + yi]

    def blk(i, c):
        return cell[:, (4 * i + c) * r : (4 * i + c + 1) * r]

    def hermite(yl, yr, kl, kr, t):
        d = yr - yl
        a = kl - d
        b = d - kr
        return (1 - t) * yl + t * yr + t * (1 - t) * (a * (1 - t) + b * t)

    f_y1 = hermite(blk(0, 0), blk(0, 2), blk(1, 0), blk(1, 2), tx)
    f_y2 = hermite(blk(0, 1), blk(0, 3), blk(1, 1), blk(1, 3), tx)
    g_y1 = hermite(blk(2, 0), blk(2, 2), blk(3, 0), blk(3, 2), tx)
    g_y2 = hermite(blk(2, 1), blk(2, 3), blk(3, 1), blk(3, 3), tx)
    return hermite(f_y1, f_y2, g_y1, g_y2, ty)


def plain_cell_route(itp, qx, qy, corner_rows=False):
    """The plain versions of R1 and the strategy's tail on the same inputs
    (in-range queries, no periodic axis): ``get_lower_index`` per axis, a
    gather of the grid's corners and the PyTorch lerps (``Bilinear``;
    ``corner_rows``: R2b's, a row ``index_select`` of the corner-row table)
    or a row ``index_select`` and the nested Hermite tail (``Bicubic``)."""
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    s = itp.strategy
    cell, tx, ty = ek._cell_index_plain(itp.x, itp.y, qx, qy)
    if getattr(s, "layout", None) == "cell":
        return t2._bicubic_nested_plain(s.rows, cell, tx, ty, s.rows.shape[1] // 16)
    if corner_rows:
        return t2._bilinear_plain(s.rows, cell, qx, qy, s.rows.shape[1] // 4 - 1)
    return t2._bilinear_grid_plain(s.grid, itp.x, itp.y, cell, qx, qy)


def path2d(dev, rng):
    """The 2-D slice through the public API on ``device="cuda"``, at config
    3's width.  Every call is driven with all launch counts set to 0 just
    before it and read just after; returns what the timing phase reuses and
    the launches of each kernel summed over the calls."""
    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch import OutOfBoundsError
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Bilinear, Interp2D
    from ndarray_interp_tpu_torch.serving import (
        DoubleFloatEvaluator2D,
        Evaluator2D,
        eval_into_donated_2d,
    )

    drive, total = counted_calls()
    nx, ny, r = GRID2D
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def routed_equals_plain(label, itp, got, corner_rows=False):
        """The routed output against the plain versions of R1 and the tail
        (``corner_rows``: R2b's on the corner-row table) on the same inputs,
        bit for bit."""
        same, err = bit_compare(got, plain_cell_route(itp, qxd, qyd, corner_rows))
        what = "R2b's plain version on the corner rows" if corner_rows else "their plain versions"
        print(f"  {label}: R1 + tail {'bit-identical to' if same else 'DIFFERS from'} {what} "
              f"(max abs err {err})", flush=True)
        if not same:
            fail(f"{label}: R1 + tail differ from {what} (max abs err {err})")

    x = f32(make_knots(nx, "nonuniform", np.float64, rng))
    y = f32(make_knots(ny, "nonuniform", np.float64, rng))
    z = f32(rng.normal(size=GRID2D))
    qx = f32(rng.uniform(x[0], x[-1], NQ2D))
    qy = f32(rng.uniform(y[0], y[-1], NQ2D))
    t0 = time.perf_counter()
    ref_lin = si.RegularGridInterpolator((x, y), z, method="linear")(np.stack([qx, qy], -1))
    ref_cub = np.stack([si.RectBivariateSpline(x, y, z[..., c], kx=3, ky=3, s=0).ev(qx, qy)
                        for c in range(r)], axis=1)
    print(f"  SciPy oracles (RegularGridInterpolator linear; RectBivariateSpline, all {r} "
          f"channels) on the host: {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"axes": (x, y)}
    for dt, tol in ((np.float32, F32_TOL), (np.float64, F64_TOL)):
        tag = np.dtype(dt).name
        tdt = torch.float32 if dt == np.float32 else torch.float64
        xd, yd, zd, qxd, qyd = (T(v.astype(dt)) for v in (x, y, z, qx, qy))
        bil = drive(f"Bilinear {tag} build {nx} x {ny} x {r}", [], lambda: (
            Interp2D.builder(zd).x(xd).y(yd).build()))
        got = drive(f"NS3 Bilinear {tag} itp(xs, ys)", ["R1", "R2g"], lambda: bil(qxd, qyd))
        check_close(f"NS3 Bilinear {tag} {nx} x {ny} x {r} at {NQ2D:,} queries", got, ref_lin,
                    tol, (NQ2D, r), tdt)
        routed_equals_plain(f"NS3 Bilinear {tag}", bil, got)
        routed_equals_plain(f"NS3 Bilinear {tag}", bil, got, corner_rows=True)
        bic = drive(f"NS3b Bicubic {tag} build", ["K4"], lambda: (
            Interp2D.builder(zd).x(xd).y(yd).strategy(Bicubic()).build()))
        # R2n orders the 1M batch by cell first (ORD's flat-cell form)
        got = drive(f"NS3b Bicubic {tag} itp(xs, ys)", ["R1", "ORD", "R2n"],
                    lambda: bic(qxd, qyd))
        check_close(f"NS3b Bicubic {tag} {nx} x {ny} x {r} at {NQ2D:,} queries "
                    f"(oracle RectBivariateSpline)", got, ref_cub, tol, (NQ2D, r), tdt)
        routed_equals_plain(f"NS3b Bicubic {tag}", bic, got)
        out[tag] = (bil, bic, qxd, qyd, zd)
        del got
    del ref_lin, ref_cub

    bil, _, qxd, qyd, _ = out["float32"]
    ev = Evaluator2D(bil).warmup()
    for size in (1000, NQ2D + 1):
        ax, ay = torch.cat([qxd, qxd])[:size], torch.cat([qyd, qyd])[:size]
        got = drive(f"Evaluator2D Bilinear f32 at {size:,} queries", ["R1", "R2g"],
                    lambda: ev(ax, ay))
        if not torch.equal(got, bil(ax, ay)):
            fail(f"Evaluator2D at {size:,} queries differs from itp(xs, ys)")
        same, err = bit_compare(got, plain_cell_route(bil, ax, ay, corner_rows=True))
        print(f"  Evaluator2D at {size:,} queries: {'bit-identical to' if same else 'DIFFERS from'}"
              f" R1 + R2b's plain versions on the corner rows (max abs err {err})", flush=True)
        if not same:
            fail(f"Evaluator2D at {size:,} queries differs from R2b's plain version")
    out["evaluator"] = ev
    buf = torch.empty((NQ2D, r), dtype=torch.float32, device=dev)
    got = drive("eval_into_donated_2d Bilinear f32", ["R1", "R2g"], lambda: (
        eval_into_donated_2d(bil, qxd, qyd, buf)))
    if got is not buf or not torch.equal(buf, bil.eval_unchecked(qxd, qyd)):
        fail("eval_into_donated_2d did not write itp.eval_unchecked(xs, ys) into out")
    try:
        bil.interp_array(T([x[5], x[-1] + 1.0]), T([y[5], y[5]]))
    except OutOfBoundsError as err:
        print(f"  out-of-bounds interp_array raised OutOfBoundsError: {err}")
    else:
        fail("out-of-bounds 2-D interp_array did not raise OutOfBoundsError")

    # f64-grade serving: float64 data and queries rounded to the pair format,
    # queries up to one unit outside the grid (the strategies extrapolate)
    zd64 = rep(rng.normal(size=GRID2D))
    dqx = rep(rng.uniform(x[0] - 1.0, x[-1] + 1.0, NQ2D))
    dqy = rep(rng.uniform(y[0] - 1.0, y[-1] + 1.0, NQ2D))
    dqx_d, dqy_d = T(dqx), T(dqy)
    out["df queries"] = (dqx_d, dqy_d)
    builds = {
        "Bilinear": drive("f64 Bilinear build (extrapolating)", [], lambda: (
            Interp2D.builder(T(zd64)).x(T(x)).y(T(y)).strategy(Bilinear().extrapolate(True))
            .build())),
        "Bicubic": drive("f64 Bicubic build (extrapolating)", ["K4"], lambda: (
            Interp2D.builder(T(zd64)).x(T(x)).y(T(y)).strategy(Bicubic().extrapolate(True))
            .build())),
    }
    refs = {"Bilinear": bilinear_oracle(x, y, zd64, dqx, dqy)}
    rows = rep(builds["Bicubic"].strategy.rows.cpu().numpy())
    sub = slice(0, NQ_BICUBIC_ORACLE)
    refs["Bicubic"] = bicubic_oracle(x, y, rows, r, dqx[sub], dqy[sub])
    del rows
    for kind, itp in builds.items():
        for grade, tol in (("df", 4e-12), ("f48", 1e-8)):
            kid = {("Bilinear", "df"): "K10", ("Bilinear", "f48"): "K11",
                   ("Bicubic", "df"): "K12", ("Bicubic", "f48"): "K13"}[kind, grade]
            name = f"DoubleFloatEvaluator2D(grade={grade!r}) {kind}"
            # K12 and K13 order the 2^20 bucket by cell first; K10 and K11 never do
            kids = ["K7", kid] + (["ORD"] if kind == "Bicubic" else [])
            dev_ = drive(f"{name} build + warmup", kids, lambda: (
                DoubleFloatEvaluator2D(itp, grade=grade).warmup()))
            got = drive(f"{name} at {NQ2D:,} f64 queries", kids, lambda: dev_(dqx_d, dqy_d))
            if kind == "Bilinear":  # K10's / K11's float64 store form
                same, err = bit_compare(got, recombined_pair_route(dev_, grade, dqx_d, dqy_d))
                print(f"  {name}: the float64 {kid} writes is "
                      f"{'bit for bit' if same else 'NOT'} df_to_f64 of the pair route "
                      f"(max abs err {err})", flush=True)
                if not same:
                    fail(f"{name}: the float64 store form differs from the recombined pair "
                         f"route (max abs err {err})")
            oracle = "the f64 lerp form" if kind == "Bilinear" else (
                f"the f64 scaled-Hermite form, first {NQ_BICUBIC_ORACLE:,} queries")
            if kind == "Bicubic":
                got = got[sub]
            err = gate(f"{grade} {kind} {nx} x {ny} x {r}", got, refs[kind], tol,
                       tuple(got.shape[:1]) + (r,), oracle)
            if grade == "f48":
                print(f"    f48 against the JAX package's on-chip gate {F48_REPORTED:g}: "
                      f"{'within' if err <= F48_REPORTED else 'above'}")
            out[kind, grade] = dev_
            del got
    out["NS3d ref"] = refs["Bicubic"]
    return out, total


def recombined_pair_route(ev, grade, qx, qy):
    """``df_to_f64`` of the pair route ``gathered_bilinear_eval_{grade}_packed``
    on the chunk that the Bilinear evaluator ``ev`` runs for ``qx, qy`` (one
    bucket, padded with the first knots), ``(nq, r)``."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    n = qx.shape[0]
    pad = ev._bucket(n) - n
    halves = [h for v, v0 in ((qx, ev._xr[0]), (qy, ev._yr[0]))
              for h in df_from_f64(torch.cat([v, v.new_full((pad,), v0)]))]
    route = getattr(e2, f"gathered_bilinear_eval_{grade}_packed")
    return df_to_f64(*route(*ev._run.args, *halves))[:n].reshape(n, -1)


GRID2D_PAST_L2 = (2048, 2048, 16)  # R2g's and R2b's --sweeps grid: 268 MB, its table 1.07 GB


def timed_designs(what, want, designs, calls, rec):
    """Each of ``designs`` ({label: (kid, fn)}) held bit for bit against
    ``want`` and timed by CUDA events, in turn, first to last and back;
    ``{label: median ms}``."""
    times = {label: [] for label in designs}
    for label, (k, fn) in designs.items():
        rec.add(k, f"{what}, {label}", fn(), want)
    for label, (_, fn) in list(designs.items()) + list(reversed(designs.items())):
        times[label].append(device_ms(fn, calls)[0])
    out = {label: float(np.median(v)) for label, v in times.items()}
    for label, ms in out.items():
        print(f"    {label}: {ms:.4f} ms", flush=True)
    return out


def bilinear_designs(dev, bil, qx, qy, card, rec, sweeps):
    """R2b's designs at NS3 in one run (each held bit for bit against
    ``_bilinear_plain`` on the corner rows and timed in turn): the grid tail
    R2g, the corner-row kernel on 16-byte lanes (R2b) and the same on a
    table copy off 16-byte alignment, a channel a lane (the first design's
    layout, without its 64-bit division); with ``sweeps`` also on a grid past
    the L2 (``GRID2D_PAST_L2``).  Returns ``{label: ms}`` at NS3."""
    import torch

    from ndarray_interp_tpu_torch.models.strategies.bilinear import pack_corner_rows
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    def run(label, x, y, grid, rows):
        cell, _, _ = ek.fused_cell_index(x, y, qx, qy)
        r = grid.shape[2]
        want = t2._bilinear_plain(rows, cell, qx, qy, r)
        rec.add("R2g", f"{label} against _bilinear_grid_plain",
                t2.bilinear_grid_eval(grid, x, y, cell, qx, qy),
                t2._bilinear_grid_plain(grid, x, y, cell, qx, qy))
        off = misaligned(rows)
        print(f"  R2b designs, {label} ({grid.numel() * grid.element_size() / 1e6:.1f} MB grid, "
              f"{rows.numel() * rows.element_size() / 1e6:.1f} MB corner-row table; each "
              f"bit-identical to _bilinear_plain on the table; card {card}):", flush=True)
        return timed_designs(label, want, {
            "grid tail R2g": ("R2g", lambda: t2.bilinear_grid_eval(grid, x, y, cell, qx, qy)),
            "corner rows, 16-byte lanes (R2b)": (
                "R2b", lambda: t2.bilinear_gathered_eval(rows, cell, qx, qy, r)),
            "corner rows, a channel a lane (table off 16-byte alignment)": (
                "R2b", lambda: t2.bilinear_gathered_eval(off, cell, qx, qy, r)),
        }, 20, rec)

    out = run(f"NS3 {'x'.join(map(str, GRID2D))} f32, {qx.numel():,} queries", bil.x, bil.y,
              bil.strategy.grid, bil.strategy.rows)
    if sweeps:
        rng = np.random.default_rng(52)
        nx, ny, r = GRID2D_PAST_L2
        # axes over NS3's span [0, 100], so NS3's queries fall in the grid
        x = torch.as_tensor(make_knots(nx, "nonuniform", np.float32, rng), device=dev)
        y = torch.as_tensor(make_knots(ny, "nonuniform", np.float32, rng), device=dev)
        grid = torch.randn((nx, ny, r), device=dev, generator=torch.Generator(dev).manual_seed(52))
        rows = pack_corner_rows(x, y, grid)
        run(f"past the L2 {nx}x{ny}x{r} f32, {qx.numel():,} queries", x, y, grid, rows)
        del grid, rows
        torch.cuda.synchronize()
    return out


def cell_tail_designs(kid, bic, qx, qy, card, rec):
    """R2c's, R2d's or R2n's phases at NS3b in one run: the body in query
    order, the same on every query's row from one cell (the compute floor
    with the row traffic gone), the ordered kernel alone on the records and
    with the ordering, and ORD's flat-cell form beside the 2-D form on R1's
    cells; each result held bit for bit against the plain version.  Returns
    ``{key: ms}``."""
    import torch

    from ndarray_interp_tpu_torch.ops import _cuda
    from ndarray_interp_tpu_torch.ops import cell_order as co
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import tail2d as t2

    _, kernel, plain, _ = ordered_tail(kid)
    cell, tx, ty = ek.fused_cell_index(bic.x, bic.y, qx, qy)
    rows = bic.strategy.rows
    r, ny1, nrows = rows.shape[1] // 16, bic.y.shape[0] - 1, rows.shape[0]
    want = plain(rows, cell, tx, ty, r)
    hot = torch.full_like(cell, int(cell[0]))
    xi = torch.div(cell, ny1, rounding_mode="floor")
    zero = torch.zeros_like(tx)
    records = co.order_by_flat_cell(cell, nrows, tx, ty)
    orders = t2._orders
    entry = t2._ORDERED[t2._TAILS[kernel][1]]

    def ordered_alone():
        out = torch.empty((cell.shape[0], r), dtype=rows.dtype, device=rows.device)
        _cuda.launch(entry, rows.dtype, rows.device, rows, nrows, rows.shape[1], r, records, out,
                     cell.shape[0])
        return out

    def branch(ordered, c=cell):
        def fn():
            t2._orders = lambda *_: ordered
            try:
                return kernel(rows, c, tx, ty, r)
            finally:
                t2._orders = orders
        return fn

    print(f"  {kid} phases at NS3b ({nrows:,} cells x {rows.shape[1] * rows.element_size():,} B "
          f"rows f32, {cell.numel():,} queries; card {card}):", flush=True)
    out = timed_designs(f"{kid} at NS3b", want, {
        "the body in query order": (kid, branch(False)),
        "ordered, the ordering included": (kid, branch(True)),
        "the ordered kernel alone": (kid, ordered_alone),
    }, 5, rec)
    rec.add(kid, "every query on one cell", branch(False, hot)(), plain(rows, hot, tx, ty, r))
    out["one cell"] = device_ms(branch(False, hot), 5)[0]
    out["ORD flat"] = device_ms(lambda: co.order_by_flat_cell(cell, nrows, tx, ty), 10)[0]
    out["ORD 2-D"] = device_ms(lambda: co.order_by_cell(
        xi, cell - xi * ny1, ny1, 0, nrows, tx, zero, ty, zero), 10)[0]
    print(f"    the body in query order on every query's row from one cell (compute floor): "
          f"{out['one cell']:.4f} ms; ORD, the flat-cell form: {out['ORD flat']:.4f}, the 2-D "
          f"form on R1's cells: {out['ORD 2-D']:.4f} ms", flush=True)
    return out


def timing2d(state, card, rec, sweeps):
    """Hold the kernels of the 2-D path, through their wrappers, against
    their plain versions on the path's own inputs; time R1, R2b-R2n, R2g,
    K10-K13 and the per-column-diagonal K4 against their plain versions;
    R2b's designs and R2c's, R2d's and R2n's phases and both branches (f32
    and f64); then
    time the 2-D calls end to end (``Evaluator2D`` and
    ``eval_into_donated_2d`` too), NS3 and NS3b also as the plain versions
    of R1 and their tails."""
    import torch

    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.models.strategies.cubic import _NOT_A_KNOT, _assemble_system
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as edf
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops import tail2d as t2
    from ndarray_interp_tpu_torch.ops import thomas_kernel as tk
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu_torch.ops.searchsorted import get_lower_index
    from ndarray_interp_tpu_torch.ops.thomas import thomas_solve
    from ndarray_interp_tpu_torch.serving import eval_into_donated_2d

    bil, bic, qxd, qyd, zd = state["float32"]
    dqx, dqy = state["df queries"]
    ny = bil.y.shape[0]
    nq = f"{qxd.numel():,} queries"
    x_pair, y_pair = df_from_f64(bil.x.double()), df_from_f64(bil.y.double())
    xi, txh, txl = edf.fused_index_frac_df(*x_pair, *df_from_f64(dqx))
    yi, tyh, tyl = edf.fused_index_frac_df(*y_pair, *df_from_f64(dqy))
    t = (txh, txl, tyh, tyl)
    shape = "x".join(map(str, GRID2D))
    knots = f"{bil.x.numel()} knots"
    r = GRID2D[2]
    cell, tx, ty = ek.fused_cell_index(bic.x, bic.y, qxd, qyd)
    systems = {
        "K2": [(f"NS3b's x axis and queries f32: {knots}, {nq}", (bic.x, qxd))],
        "K3": [(f"NS3's x axis and queries f32: {knots}, {nq}", (bil.x, qxd))],
        "R1": [(f"NS3 / NS3b cell search f32: {knots} a axis, {nq}", (bil.x, bil.y, qxd, qyd))],
        "R2b": [(f"NS3 corner-row table {shape} f32, {nq}",
                 (bil.strategy.rows, cell, qxd, qyd, r))],
        "R2g": [(f"NS3 grid {shape} f32, {nq}",
                 (bil.strategy.grid, bil.x, bil.y, cell, qxd, qyd))],
        "K4": [(f"NS3b build f32: {knots} x {zd[0].numel():,} columns, along x",
                _assemble_system(bic.x, zd.reshape(zd.shape[0], -1), _NOT_A_KNOT, 0.0,
                                 _NOT_A_KNOT, 0.0))],
        "K7": [(f"NS3c f64 queries: {knots}, {nq}", (*x_pair, *df_from_f64(dqx)))],
    }
    for kid in CELL_TAILS:
        systems[kid] = [(f"NS3b cell table {shape} f32, {nq}",
                         (bic.strategy.rows, cell, tx, ty, r))]
    for kid, kind, grade in (("K10", "Bilinear", "df"), ("K11", "Bilinear", "f48"),
                             ("K12", "Bicubic", "df"), ("K13", "Bicubic", "f48")):
        systems[kid] = [(f"{kind} {grade} table {shape}, {nq}",
                         (state[kind, grade]._packed, xi, yi, ny, *t))]
    pairs = {
        "K2": (ek.fused_index_frac, ek._index_frac_plain, rec.add_pair, (50, 20)),
        "K3": (ek.fused_lower_index, get_lower_index, rec.add, (50, 20)),
        "K4": (tk.thomas_solve_fast, thomas_solve, rec.add, (3, 1)),
        "K7": (edf.fused_index_frac_df, edf._df_index_frac_xla, rec.add_pair, (50, 5)),
        "K10": (e2.gathered_bilinear_df_tail, e2._bilinear_df_tail_plain, rec.add_pair, (10, 2)),
        "K11": (e2.gathered_bilinear_f48_tail, e2._bilinear_f48_tail_plain, rec.add_pair,
                (10, 2)),
        "K12": (e2.gathered_bicubic_df_tail, e2._bicubic_df_tail_plain, rec.add_pair, (5, 1)),
        "K13": (e2.gathered_bicubic_f48_tail, e2._bicubic_f48_tail_plain, rec.add_pair, (5, 1)),
        "R1": (ek.fused_cell_index, ek._cell_index_plain, rec.add_pair, (50, 20)),
        "R2b": (t2.bilinear_gathered_eval, t2._bilinear_plain, rec.add, (20, 5)),
        "R2g": (t2.bilinear_grid_eval, t2._bilinear_grid_plain, rec.add, (20, 5)),
        "R2c": (t2.bicubic_gathered_eval, t2._bicubic_weight_plain, rec.add, (10, 2)),
        "R2d": (t2.bicubic_tree_tail, t2._bicubic_tree_plain, rec.add, (10, 2)),
        "R2n": (t2.bicubic_nested_tail, t2._bicubic_nested_plain, rec.add, (10, 2)),
    }
    print("kernels at the 2-D path's shapes and inputs, against their plain versions:")
    for kid, (kern, plain, compare, _) in pairs.items():
        label, args = systems[kid][0]
        ok = compare(kid, label, kern(*args), plain(*args))
        print(f"  {kid} {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)
    timed = ("R1", "R2b", "R2g", "R2c", "R2d", "R2n", "K10", "K11", "K12", "K13")
    times = time_kernels({k: pairs[k] for k in timed}, systems, card)
    times["R1"].update(r1_phase(qxd.device, card, rec, sweeps))
    times["R2b"]["row_floor_ms"] = row_floor_ms("R2b", systems["R2b"][0][1])
    print(f"  R2b row-read floor {times['R2b']['row_floor_ms']:.4f} (each query's own corner "
          f"row from HBM)", flush=True)
    # R2b's designs at NS3: the grid tail R2g (the path's), the corner rows on
    # 16-byte lanes and a channel a lane; R2c's, R2d's and R2n's phases at NS3b,
    # then both of their branches (ordered by cell, and the body in query
    # order) in f32 and f64
    print("R2b's designs and R2c's, R2d's and R2n's phases, each in one run:", flush=True)
    designs = bilinear_designs(qxd.device, bil, qxd, qyd, card, rec, sweeps)
    times["R2b"]["first_design_ms"] = designs[
        "corner rows, a channel a lane (table off 16-byte alignment)"]
    times["R2g"]["corner_rows_ms"] = designs["corner rows, 16-byte lanes (R2b)"]
    bic64, qx64, qy64 = state["float64"][1], state["float64"][2], state["float64"][3]
    c64, tx64, ty64 = ek.fused_cell_index(bic64.x, bic64.y, qx64, qy64)
    extra = [(f"cell table {GRID2D[0]}x{GRID2D[1]}x8 f32", (
        torch.randn(((GRID2D[0] - 1) * (GRID2D[1] - 1), 16 * 8), device=qxd.device), cell, tx, ty,
        8), ORDER_SWEEP)] if sweeps else []
    for kid in CELL_TAILS:
        phases = cell_tail_designs(kid, bic, qxd, qyd, card, rec)
        times[kid] |= {"one_cell_ms": phases["one cell"], "order_2d_form_ms": phases["ORD 2-D"],
                       "ordered_alone_ms": phases["the ordered kernel alone"]}
        print(f"{kid} at NS3b's table and queries, ordered by cell and in query order:",
              flush=True)
        times[kid].update(ordered_phase(kid, systems[kid][0], card, rec, sweeps, extra))
        f64 = ordered_phase(kid, (f"NS3b cell table {shape} f64, {nq}",
                                  (bic64.strategy.rows, c64, tx64, ty64, r)), card, rec, False)
        times[kid] |= {"f64_ms": f64["ordered_ms"], "unordered_f64_ms": f64["unordered_ms"],
                       "f64_row_floor_ms": f64["row_floor_ms"]}
    del cell, tx, ty, extra, c64, tx64, ty64
    # K10's and K11's float64 store form at NS3c's and NS3g's inputs: held
    # against df_to_f64 of the plain pair and timed beside the pair form
    for kid, entry, plain in (("K10", e2._gathered_bilinear_df_tail_f64,
                               e2._bilinear_df_tail_plain),
                              ("K11", e2._gathered_bilinear_f48_tail_f64,
                               e2._bilinear_f48_tail_plain)):
        label, args = systems[kid][0]
        ok = rec.add(kid, f"{label}, float64 store form", entry(*args), df_to_f64(*plain(*args)))
        f64 = device_ms(lambda: entry(*args), 10)
        times[kid] |= {"f64_ms": f64[0], "row_floor_ms": row_floor_ms(kid, args)}
        print(f"  {kid} {label}, float64 store form "
              f"({'bit-identical to' if ok else 'MISMATCH against'} df_to_f64 of the plain "
              f"pair): {fmt(f64)} (pair form {times[kid]['ms']:.4f}); row-read floor "
              f"{times[kid]['row_floor_ms']:.4f} (each query's own row from HBM)", flush=True)
    rng = np.random.default_rng(51)
    cells = (GRID2D[0] - 1) * (GRID2D[1] - 1)

    def narrow(pack):  # a cell table of 3 channels (bp 8) at NS3d's cells (--sweeps)
        return pack(*df_from_f64(torch.as_tensor(rng.normal(size=(cells, 16 * 3)),
                                                 device=qxd.device)), 3)

    # K12 also on a cell table of 3 channels (1 KiB of rows a query) at NS3d's queries
    print("K12 at NS3d's table and queries, ordered by cell and unordered:", flush=True)
    extra = [(f"cell table {GRID2D[0]}x{GRID2D[1]}x3 (bp 8)",
              (narrow(e2.pack_bicubic_rows_df), *systems["K12"][0][1][1:]), ())] if sweeps else []
    times["K12"].update(ordered_phase("K12", systems["K12"][0], card, rec, sweeps, extra))
    # K13 likewise at NS3f, and on an f48 cell table of 3 channels (768 B of
    # rows a query)
    print("K13 at NS3f's table and queries, ordered by cell and unordered:", flush=True)
    extra = [(f"f48 cell table {GRID2D[0]}x{GRID2D[1]}x3 (bp 8)",
              (narrow(e2.pack_bicubic_rows_f48), *systems["K13"][0][1][1:]),
              ORDER_SWEEP)] if sweeps else []
    times["K13"].update(ordered_phase("K13", systems["K13"][0], card, rec, sweeps, extra))
    del extra

    # K4 at the NS3b build: its three solves of the 512 x 512 x 16 grid (x, then
    # y of the data and of the x derivatives), held bit for bit and timed as one
    nak = (_NOT_A_KNOT, 0.0, _NOT_A_KNOT, 0.0)
    kx = tk.thomas_solve_fast(*systems["K4"][0][1]).reshape(zd.shape)
    solves = [systems["K4"][0][1]] + [
        _assemble_system(bic.y, torch.movedim(g, 1, 0).reshape(ny, -1), *nak) for g in (zd, kx)]
    ok = all([rec.add("K4", f"NS3b build solve {i}", tk.thomas_solve_fast(*a), thomas_solve(*a))
              for i, a in enumerate(solves)])
    tk_ = device_ms(lambda: [tk.thomas_solve_fast(*a) for a in solves], 3)
    bound_ms = sum(bound("K4", a)[0] for a in solves)
    print(f"  K4 NS3b build, three solves of (512, {zd[0].numel():,}) f32 "
          f"({'bit-identical' if ok else 'MISMATCH'}): kernel {fmt(tk_)} for the three, bound "
          f"{bound_ms:.4f} (bytes)", flush=True)
    dense_solve_ms(systems["K4"][0], "K4")
    del kx, solves

    # K4 with per-column diagonals (the JAX package's _kernel_batched) at the
    # bank build's shape
    n, bank = 10_000, 64
    args = [torch.as_tensor(v, device=qxd.device) for v in
            thomas_system(n, bank, True, np.float32, np.random.default_rng(45))]
    ok = rec.add("K4", f"({n:,}, {bank}) per-column diagonals", tk.thomas_solve_fast(*args),
                 thomas_solve(*args))
    tk_, tp_ = device_ms(lambda: tk.thomas_solve_fast(*args), 3), device_ms(
        lambda: thomas_solve(*args), 1)
    bound_ms, bound_by = bound("K4", args)
    print(f"  K4 per-column diagonals ({n:,} x {bank} f32, {'bit-identical' if ok else 'MISMATCH'})"
          f": kernel {fmt(tk_)}, plain {fmt(tp_)}, bound {bound_ms:.4f} ({bound_by}); "
          f"library: none", flush=True)

    out_buf = torch.empty((qxd.numel(), r), dtype=torch.float32, device=qxd.device)
    end_to_end({
        f"NS3 Bilinear f32 itp(xs, ys), {shape} at {nq}": (lambda: bil(qxd, qyd), 20),
        f"NS3 Bilinear f32, plain R1 + R2g (searchsorted, corner gather, lerps), {shape} at "
        f"{nq}": (lambda: plain_cell_route(bil, qxd, qyd), 20),
        f"NS3 Evaluator2D Bilinear f32 ev(xs, ys), {shape} at {nq}": (
            lambda: state["evaluator"](qxd, qyd), 20),
        f"NS3 eval_into_donated_2d Bilinear f32, {shape} at {nq}": (
            lambda: eval_into_donated_2d(bil, qxd, qyd, out_buf), 20),
        f"NS3b Bicubic f32 itp(xs, ys), {shape} at {nq}": (lambda: bic(qxd, qyd), 10),
        f"NS3b Bicubic f32, plain R1 + R2n (searchsorted, row gather, Hermite tail), {shape} "
        f"at {nq}": (lambda: plain_cell_route(bic, qxd, qyd), 10),
        f"NS3b Bicubic f32 build, {shape}": (
            lambda: Interp2D.builder(zd).x(bic.x).y(bic.y).strategy(Bicubic()).build(), 3),
        f"NS3c DoubleFloatEvaluator2D df Bilinear at {nq} (f64)": (
            lambda: state["Bilinear", "df"](dqx, dqy), 5),
        f"NS3g DoubleFloatEvaluator2D f48 Bilinear at {nq}": (
            lambda: state["Bilinear", "f48"](dqx, dqy), 5),
        f"NS3d DoubleFloatEvaluator2D df Bicubic at {nq}": (
            lambda: state["Bicubic", "df"](dqx, dqy), 3),
        f"NS3f DoubleFloatEvaluator2D f48 Bicubic at {nq}": (
            lambda: state["Bicubic", "f48"](dqx, dqy), 3),
    }, "2-D path", card, top=8)
    return times


# -- the N-D slice and the bicubic node route ----------------------------------------------
# ND1/ND2 of the JAX package (benches/run_benches.py:741-782): a 64^3 grid on
# linspace(0, 1, 64) axes, one channel, 1,000,000 queries; ND2c/ND2d at 256^3;
# NS3e (benches/bench_df_node.py:41) at 1024 x 1024 x 16, which the builder puts on
# the bicubic node layout.
GRIDND = (64, 64, 64)
GRIDND_BIG = (256, 256, 256)
NQND = 1_000_000
NQ_ND_ORACLE = 2048  # SciPy's sequential tensor-product oracle runs on the host
NQ_BIG_ORACLE = 256
GRID_NS3E = (1024, 1024, 16)


def seq_spline_oracle(axes, data, pts, m, orders=None):
    """The exact tensor-product not-a-knot spline at the first ``m`` points,
    by sequential 1-D SciPy solves (``tests/test_interpnd.py:397``): the last
    axis's spline for all points at once; then, axis by axis in reverse
    order, one spline over every point's slice, of which each point takes its
    own interval's polynomial (``CubicSpline.c``, extrapolating with the end
    intervals as ``CubicSpline`` does).  ``orders`` (one int an axis) gives
    the mixed partial instead: each axis's spline differentiated that many
    times (the tensor-product spline is linear in the data along each
    axis)."""
    import scipy.interpolate as si

    k = len(axes)
    orders = orders or (0,) * k
    pts = [np.asarray(p[:m], np.float64) for p in pts]
    g = si.CubicSpline(axes[-1], data, axis=k - 1)(pts[-1], orders[-1])  # (n_0..n_{k-2}, m, ...)
    for d in reversed(range(k - 1)):
        x, q = axes[d], pts[d]
        i = np.clip(np.searchsorted(x, q, side="right") - 1, 0, x.size - 2)
        c = si.CubicSpline(x, g, axis=d).c  # (4, n_d - 1, n_0..n_{d-1}, m, *trailing)
        c = np.moveaxis(c, (1, 2 + d), (0, 1))[i, np.arange(q.size)]  # (m, 4, ...)
        h = (q - x[i]).reshape((-1,) + (1,) * (c.ndim - 2))
        g = np.moveaxis(poly_d(c, h, orders[d]), 0, d)
    return g


def poly_d(c, h, nu):
    """The ``nu``-th derivative in ``h`` of ``c[:, 0] h^3 + c[:, 1] h^2 +
    c[:, 2] h + c[:, 3]``."""
    if nu == 0:
        return ((c[:, 0] * h + c[:, 1]) * h + c[:, 2]) * h + c[:, 3]
    if nu == 1:
        return (3 * c[:, 0] * h + 2 * c[:, 1]) * h + c[:, 2]
    if nu == 2:
        return 6 * c[:, 0] * h + 2 * c[:, 1]
    if nu == 3:
        return 6 * c[:, 0] + 0 * h
    return np.zeros_like(c[:, 0] * h)


def f32(v):
    """Float32-representable float64, so one float64 oracle serves f32 and f64."""
    return np.asarray(v, np.float32).astype(np.float64)


def dfnd_kernel_phases(dev, rec):
    """K14 and K15 against their plain versions on the card, on the same
    inputs: the ``(idx, t)`` that K7 gives for queries with NaN, +-inf, +-1e38,
    the knots themselves and far extrapolation.  K14 at 3 x 3 x 1,
    200 x 150 x 3 and 512 x 512 x 16 (NS3e's node grid) on 1,000,000 queries;
    K15 (df, f48) at k = 1..4, nbasis 4 and 2, r = 1 (bp = 1) and r = 3, 20
    (bp = 3, 24)."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df as ek
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as en
    from ndarray_interp_tpu_torch.ops.df import df_from_f64

    rng = np.random.default_rng(3)

    def pair(v):
        return df_from_f64(torch.as_tensor(np.asarray(v, np.float64), device=dev))

    def index_frac(kn, nq):
        return ek.fused_index_frac_df(*pair(kn), *pair(rng.permutation(
            make_queries(kn, nq, np.float64, rng))))

    print("N-D and node-layout double-float kernel phases (kernel against its plain "
          "version, same inputs):", flush=True)
    for nx, ny, r in ((3, 3, 1), (200, 150, 3), (512, 512, 16)):
        kx, ky = df_knots(nx, "nonuniform", rng), df_knots(ny, "nonuniform", rng)
        xi, txh, txl = index_frac(kx, NQ2D)
        yi, tyh, tyl = index_frac(ky, NQ2D)
        nodes = rng.normal(size=(nx * ny, 4 * r + 2))
        nodes[:, 4 * r] = np.repeat(kx, ny)
        nodes[:, 4 * r + 1] = np.tile(ky, nx)
        packed = e2.pack_bicubic_nodes_df(*pair(nodes))
        args = (packed, xi, yi, ny, txh, txl, tyh, tyl)
        ok = rec.add_pair("K14", f"{nx} x {ny} x {r}", e2.gathered_bicubic_node_df_tail(*args),
                          e2._bicubic_node_df_tail_plain(*args))
        print(f"  K14 node table {nx} x {ny} x {r}, {NQ2D:,} queries: "
              f"{'bit-identical' if ok else 'MISMATCH'}", flush=True)
        del packed, args
        torch.cuda.synchronize()
    for k in (1, 2, 3, 4):
        for nbasis in (4, 2):
            nb = nbasis**k
            for r in (1, 3, 20):
                bp = en._nd_bp(r)
                # about 2^24 table elements and 2^26 plain-version products
                ncell = min(2047, int((2**24 / (nb * bp)) ** (1.0 / k)))
                nq = min(NQND, 2**26 // (nb * bp))
                parts = [index_frac(df_knots(ncell + 1, "nonuniform", rng), nq) for _ in range(k)]
                idx, th, tl = (torch.stack([p[j] for p in parts]) for j in range(3))
                cstrides = [ncell ** (k - 1 - d) for d in range(k)]
                rows = pair(rng.normal(size=(ncell**k, nb * r)))
                ok = True
                for kid, tail, plain, pack in (
                    ("K15", en.nd_df_tail, en._nd_df_tail_plain, en.pack_rows_nd_df),
                    ("K15f48", en.nd_f48_tail, en._nd_f48_tail_plain, en.pack_rows_nd_f48),
                ):
                    args = (pack(*rows, nb, r), idx, th, tl, cstrides, nbasis)
                    ok &= rec.add_pair(kid, f"k={k} nbasis={nbasis} r={r}", tail(*args),
                                       plain(*args))
                    del args
                print(f"  K15 df and f48, k={k}, nbasis={nbasis}, r={r} (bp {bp}), {ncell}^{k} "
                      f"cells, {nq:,} queries: {'bit-identical' if ok else 'MISMATCH'}",
                      flush=True)
                del rows, idx, th, tl, parts
                torch.cuda.synchronize()


def nd_path(dev, rng):
    """The N-D slice and the f64-grade bicubic node route through the public
    API on ``device="cuda"``.  Every call is driven with all launch counts set
    to 0 just before it and read just after; returns what the timing phase
    reuses and the launches of each kernel summed over the calls."""
    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.interpnd import InterpND
    from ndarray_interp_tpu_torch.serving import DoubleFloatEvaluator2D, DoubleFloatEvaluatorND

    drive, total = counted_calls()
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = {}

    def nd(data, axes, method="linear", layout=None):
        b = InterpND.builder(data).points(*axes).method(method)
        return (b if layout is None else b.layout(layout)).build()

    # ND1, ND2, ND2b: 64^3 in f32 and f64
    axes = [f32(np.linspace(0.0, 1.0, n)) for n in GRIDND]
    data = f32(rng.normal(size=GRIDND))
    qs = [f32(rng.uniform(0.0, 1.0, NQND)) for _ in GRIDND]
    t0 = time.perf_counter()
    pts = np.stack(qs, -1)
    refs = {m: si.RegularGridInterpolator(axes, data, method=m)(pts) for m in ("linear", "nearest")}
    refs["cubic"] = seq_spline_oracle(axes, data, qs, NQ_ND_ORACLE)
    print(f"  SciPy oracles (RegularGridInterpolator linear and nearest; sequential "
          f"CubicSpline, first {NQ_ND_ORACLE:,} queries) on the host: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shape = "x".join(map(str, GRIDND))
    for dt, tol in ((np.float32, F32_TOL), (np.float64, F64_TOL)):
        tag = np.dtype(dt).name
        tdt = torch.float32 if dt == np.float32 else torch.float64
        ax_d, d_d = [T(a.astype(dt)) for a in axes], T(data.astype(dt))
        q_d = [T(q.astype(dt)) for q in qs]
        for name, method, expect in (("ND1", "linear", []), ("ND1", "nearest", []),
                                     ("ND2", "cubic", ["K4"])):
            itp = drive(f"{name} InterpND {method} {tag} build {shape}", expect,
                        lambda: nd(d_d, ax_d, method))
            got = drive(f"{name} {method} {tag} itp(*qs)", ["K2"], lambda: itp(*q_d))
            if method == "cubic":
                if itp.layout != "cell":
                    fail(f"ND2 {tag}: the builder chose layout {itp.layout!r}, not 'cell'")
                got = got[:NQ_ND_ORACLE]
                oracle = f" (oracle sequential CubicSpline, first {NQ_ND_ORACLE:,})"
            else:
                oracle = " (oracle RegularGridInterpolator)"
            check_close(f"{name} {method} {tag} {shape} at {NQND:,} queries{oracle}", got,
                        refs[method], tol, tuple(got.shape[:1]), tdt)
            out[method, tag] = itp
        out["queries", tag] = q_d
        del got

    q32 = out["queries", "float32"]
    ax32, d32 = [T(a.astype(np.float32)) for a in axes], T(data.astype(np.float32))
    cell_out = out["cubic", "float32"](*q32)
    for lay in ("node", "node2", "node4"):
        itp = drive(f"ND2b InterpND cubic f32 build {shape}, layout {lay!r}", ["K4"],
                    lambda: nd(d32, ax32, "cubic", lay))
        got = drive(f"ND2b layout {lay!r} itp(*qs)", ["K2"], lambda: itp(*q32))
        check_close(f"ND2b layout {lay!r} {shape} at {NQND:,} queries (oracle sequential "
                    f"CubicSpline, first {NQ_ND_ORACLE:,})", got[:NQ_ND_ORACLE], refs["cubic"],
                    F32_TOL, (NQ_ND_ORACLE,), torch.float32)
        err = float((got - cell_out).abs().max() / cell_out.abs().max())
        print(f"    layout {lay!r} against the cell layout, all queries: scaled {err:.3e}")
        if not err <= F32_TOL:
            fail(f"ND2b layout {lay!r} differs from the cell layout by {err}")
        out["ND2b", lay] = itp
    del refs, cell_out, got

    # ND2c, ND2d: 256^3 in f32; the builder puts it on the node layout
    shape_b = "x".join(map(str, GRIDND_BIG))
    axes_b = [f32(np.linspace(0.0, 1.0, n)) for n in GRIDND_BIG]
    data_b = f32(rng.normal(size=GRIDND_BIG))
    qs_b = [f32(rng.uniform(0.0, 1.0, NQND)) for _ in GRIDND_BIG]
    t0 = time.perf_counter()
    ref_b = seq_spline_oracle(axes_b, data_b, qs_b, NQ_BIG_ORACLE)
    print(f"  SciPy sequential CubicSpline oracle at {shape_b}, first {NQ_BIG_ORACLE} queries: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    axb_d = [T(a.astype(np.float32)) for a in axes_b]
    db_d = T(data_b.astype(np.float32))
    qb_d = [T(q.astype(np.float32)) for q in qs_b]
    out["queries", "big"] = qb_d
    node_out = None
    for name, lay in (("ND2c", None), ("ND2d", "node2"), ("ND2d", "node4")):
        itp = drive(f"{name} InterpND cubic f32 build {shape_b}, layout {lay or 'auto'}",
                    ["K4"], lambda: nd(db_d, axb_d, "cubic", lay))
        if lay is None and itp.layout != "node":
            fail(f"ND2c: the builder chose layout {itp.layout!r}, not 'node'")
        print(f"    table {tuple(itp.table.shape)} f32, "
              f"{itp.table.numel() * 4 / 1e6:.1f} MB", flush=True)
        got = drive(f"{name} layout {itp.layout!r} itp(*qs)", ["K2"], lambda: itp(*qb_d))
        check_close(f"{name} layout {itp.layout!r} {shape_b} at {NQND:,} queries (oracle "
                    f"sequential CubicSpline, first {NQ_BIG_ORACLE})", got[:NQ_BIG_ORACLE],
                    ref_b, F32_TOL, (NQ_BIG_ORACLE,), torch.float32)
        if node_out is None:
            node_out = got
        elif not torch.equal(got, node_out):
            fail(f"{name} layout {itp.layout!r} is not bit-identical to the node layout")
        else:
            print(f"    layout {itp.layout!r} bit-identical to the node layout")
        out[name, itp.layout] = itp
    del node_out, got, db_d

    # ND3, ND3b, ND linear DF: DoubleFloatEvaluatorND on the 64^3 grid built in f64
    axes64 = [rep(np.linspace(0.0, 1.0, n)) for n in GRIDND]
    data64 = rep(rng.normal(size=GRIDND))
    dq = [rep(rng.uniform(0.0, 1.0, NQND)) for _ in GRIDND]
    dq_d = [T(q) for q in dq]
    out["df queries"] = dq_d
    sc_ref = {"cubic": seq_spline_oracle(axes64, data64, dq, NQ_ND_ORACLE),
              "linear": si.RegularGridInterpolator(axes64, data64)(np.stack(dq, -1))}
    for method in ("cubic", "linear"):
        itp = drive(f"f64 InterpND {method} build {shape}", ["K4"] if method == "cubic" else [],
                    lambda: nd(T(data64), [T(a) for a in axes64], method))
        port_ref = itp(*dq_d).cpu().numpy()
        for grade, kid, tol in (("df", "K15", 4e-12), ("f48", "K15f48", 1e-8)):
            cell = {("cubic", "df"): "ND3", ("cubic", "f48"): "ND3b"}.get(
                (method, grade), f"ND linear {grade}")
            name = f"{cell} DoubleFloatEvaluatorND(grade={grade!r}) {method}"
            ev = drive(f"{name} build + warmup", ["K7", kid],
                       lambda: DoubleFloatEvaluatorND(itp, grade=grade).warmup())
            got = drive(f"{name} at {NQND:,} f64 queries", ["K7", kid], lambda: ev(*dq_d))
            gate(f"{cell} {grade} {method} {shape}", got, port_ref, tol, (NQND,),
                 "the port's f64 InterpND")
            sub = NQ_ND_ORACLE if method == "cubic" else NQND
            gate(f"{cell} {grade} {method} {shape}, first {sub:,}", got[:sub], sc_ref[method],
                 tol, (sub,), "SciPy f64")
            out[cell] = ev
            del got
    del sc_ref

    # NS3e: DoubleFloatEvaluator2D on the bicubic node layout
    nx, ny, r = GRID_NS3E
    x = rep(make_knots(nx, "nonuniform", np.float64, rng))
    y = rep(make_knots(ny, "nonuniform", np.float64, rng))
    z = rep(rng.normal(size=GRID_NS3E))
    qx, qy = rep(rng.uniform(x[0], x[-1], NQ2D)), rep(rng.uniform(y[0], y[-1], NQ2D))
    qx_d, qy_d = T(qx), T(qy)
    shape_e = "x".join(map(str, GRID_NS3E))
    itp = drive(f"NS3e f64 Bicubic build {shape_e}", ["K4"], lambda: (
        Interp2D.builder(T(z)).x(T(x)).y(T(y)).strategy(Bicubic()).build()))
    if itp.strategy.layout != "node":
        fail(f"NS3e: the builder chose layout {itp.strategy.layout!r}, not 'node'")
    port_ref = itp(qx_d, qy_d).cpu().numpy()
    ev = drive("NS3e DoubleFloatEvaluator2D(grade='df') node layout build + warmup",
               ["K7", "K14"], lambda: DoubleFloatEvaluator2D(itp).warmup())
    print(f"    DF node table {tuple(ev._packed.shape)} f32, "
          f"{ev._packed.numel() * 4 / 1e6:.1f} MB", flush=True)
    got = drive(f"NS3e DoubleFloatEvaluator2D at {NQ2D:,} f64 queries", ["K7", "K14"],
                lambda: ev(qx_d, qy_d))
    gate(f"NS3e df {shape_e}", got, port_ref, 4e-12, (NQ2D, r), "the port's f64 Interp2D")
    t0 = time.perf_counter()
    ref = seq_spline_oracle([x, y], z, [qx, qy], NQ_BIG_ORACLE)
    print(f"  SciPy sequential CubicSpline oracle at {shape_e}, first {NQ_BIG_ORACLE} "
          f"queries: {time.perf_counter() - t0:.1f} s", flush=True)
    gate(f"NS3e df {shape_e}, first {NQ_BIG_ORACLE}", got[:NQ_BIG_ORACLE], ref, 4e-12,
         (NQ_BIG_ORACLE, r), "SciPy f64")
    out["NS3e"] = (ev, qx_d, qy_d)
    return out, total


def timing_nd(state, card, rec, sweeps):
    """Hold K14 and K15, through their wrappers, against their plain versions
    on the paths' own tables and queries; time both there (K15 also at
    bp > 1); then time the N-D and NS3e calls end to end."""
    import torch

    from ndarray_interp_tpu_torch.ops import eval_kernels_df as edf
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as en
    from ndarray_interp_tpu_torch.ops.df import df_from_f64

    ev_e, qx, qy = state["NS3e"]
    itp_e = ev_e._interp
    xi, txh, txl = edf.fused_index_frac_df(*df_from_f64(itp_e.x.double()), *df_from_f64(qx))
    yi, tyh, tyl = edf.fused_index_frac_df(*df_from_f64(itp_e.y.double()), *df_from_f64(qy))
    dq = state["df queries"]
    ev3 = state["ND3"]
    parts = [edf.fused_index_frac_df(*df_from_f64(ax.double()), *df_from_f64(q))
             for ax, q in zip(ev3._interp.axes, dq)]
    idx, th, tl = (torch.stack([p[j] for p in parts]) for j in range(3))
    cstrides = [(GRIDND[1] - 1) * (GRIDND[2] - 1), GRIDND[2] - 1, 1]
    nq = f"{NQND:,} queries"
    shape_e, shape = "x".join(map(str, GRID_NS3E)), "x".join(map(str, GRIDND))
    rng = np.random.default_rng(46)
    nq_wide = 262_144
    wide = df_from_f64(torch.as_tensor(rng.normal(size=(ev3._packed.shape[0], 64 * 3)),
                                       device=qx.device))
    systems = {
        "K14": [(f"NS3e node table {shape_e}, {NQ2D:,} queries",
                 (ev_e._packed, xi, yi, itp_e.y.shape[0], txh, txl, tyh, tyl))],
        "K15": [(f"ND3 df table {shape}, bp 1, {nq}", (ev3._packed, idx, th, tl, cstrides, 4)),
                (f"ND linear df table {shape}, bp 1, {nq}",
                 (state["ND linear df"]._packed, idx, th, tl, cstrides, 2)),
                (f"df table {shape} x 3 channels, bp 3, {nq_wide:,} queries",
                 (en.pack_rows_nd_df(*wide, 64, 3), idx[:, :nq_wide], th[:, :nq_wide],
                  tl[:, :nq_wide], cstrides, 4))],
        "K15f48": [(f"ND3b f48 table {shape}, bp 1, {nq}",
                    (state["ND3b"]._packed, idx, th, tl, cstrides, 4)),
                   (f"f48 table {shape} x 3 channels, bp 3, {nq_wide:,} queries",
                    (en.pack_rows_nd_f48(*wide, 64, 3), idx[:, :nq_wide], th[:, :nq_wide],
                     tl[:, :nq_wide], cstrides, 4))],
    }
    del wide
    pairs = {
        "K14": (e2.gathered_bicubic_node_df_tail, e2._bicubic_node_df_tail_plain, rec.add_pair,
                (5, 1)),
        "K15": (en.nd_df_tail, en._nd_df_tail_plain, rec.add_pair, (10, 1)),
        "K15f48": (en.nd_f48_tail, en._nd_f48_tail_plain, rec.add_pair, (10, 1)),
    }
    print("K14 and K15 at the paths' shapes and inputs, against their plain versions:")
    for kid, (kern, plain, compare, _) in pairs.items():
        for label, args in systems[kid]:
            ok = compare(kid, label, kern(*args), plain(*args))
            print(f"  {kid} {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)
    times = time_kernels(pairs, systems, card)
    # K14 on node tables of 3 (one float a lane), 4 and 8 channels at NS3e's grid and queries
    nx_e, ny_e = itp_e.x.shape[0], itp_e.y.shape[0]
    narrow = []
    for r in (3, 4, 8) if sweeps else ():
        nodes = rng.normal(size=(nx_e * ny_e, 4 * r + 2))
        nodes[:, 4 * r] = np.repeat(itp_e.x.cpu().numpy(), ny_e)
        nodes[:, 4 * r + 1] = np.tile(itp_e.y.cpu().numpy(), nx_e)
        packed = e2.pack_bicubic_nodes_df(*df_from_f64(torch.as_tensor(nodes, device=qx.device)))
        narrow.append((f"node table {nx_e}x{ny_e}x{r}{' (r % 4 != 0)' if r % 4 else ''}",
                       (packed, *systems["K14"][0][1][1:]), ()))
        del nodes, packed
    print("K14 at NS3e's table and queries, ordered by cell and unordered:", flush=True)
    times["K14"].update(ordered_phase("K14", systems["K14"][0], card, rec, sweeps, narrow))
    del narrow
    for kid in ("K15", "K15f48"):
        kern, plain, _, (nk, npl) = pairs[kid]
        print(f"  {kid} {systems[kid][0][0]}: row-read floor "
              f"{row_floor_ms(kid, systems[kid][0][1]):.4f}")
        for label, args in systems[kid][1:]:
            tk_, tp_ = device_ms(lambda: kern(*args), nk), device_ms(lambda: plain(*args), npl)
            bound_ms, bound_by = bound(kid, args)
            print(f"  {kid} {label}: kernel {fmt(tk_)}, plain {fmt(tp_)}, bound {bound_ms:.4f} "
                  f"({bound_by}), row-read floor {row_floor_ms(kid, args):.4f}; library: none",
                  flush=True)
    del systems

    q32, qb = state["queries", "float32"], state["queries", "big"]
    calls = {
        f"ND1 InterpND linear f32 itp(*qs), {shape} at {nq}": (
            lambda: state["linear", "float32"](*q32), 10),
        f"ND2 cubic f32, layout 'cell', {shape} at {nq}": (
            lambda: state["cubic", "float32"](*q32), 10),
    }
    for lay in ("node", "node2", "node4"):
        calls[f"ND2b cubic f32, layout {lay!r}, {shape} at {nq}"] = (
            lambda itp=state["ND2b", lay]: itp(*q32), 5)
    shape_b = "x".join(map(str, GRIDND_BIG))
    for name, lay in (("ND2c", "node"), ("ND2d", "node2"), ("ND2d", "node4")):
        calls[f"{name} cubic f32, layout {lay!r}, {shape_b} at {nq}"] = (
            lambda itp=state[name, lay]: itp(*qb), 5)
    for cell in ("ND3", "ND3b", "ND linear df", "ND linear f48"):
        calls[f"{cell} DoubleFloatEvaluatorND, {shape} at {nq} (f64)"] = (
            lambda ev=state[cell]: ev(*dq), 5)
    calls[f"NS3e DoubleFloatEvaluator2D df, node layout {shape_e} at {NQ2D:,} queries"] = (
        lambda: ev_e(qx, qy), 3)
    end_to_end(calls, "N-D path and NS3e", card)
    return times

# -- the wide-bank and long-knot-axis slice ----------------------------------------------
# The JAX package's NS5 and NS5b (benches/run_benches.py:684-739): a 16,384-spline bank on
# 256 knots at 4,096 bf16 queries, and a 1e6-spline bank on 64 knots, built and evaluated at
# 256 queries; NS2b (:399-419): 10,240 knots x 64 at 1,000,000 queries; NS1b (:484-499): a
# 262,144-knot spline at 1,000,000 queries on linspace(0, 100); NS4 (:670-682): Akima and
# Pchip on 2,048 knots.  Queries uniform on [0, 100] (NS1b, NS4) or [0, 1], as there.
NQ_BIG = 1_000_000
N_NS1B = 262_144
LANES_ORACLE = 256  # SciPy runs on this many lanes of the 16,384- and 1e6-wide banks


def big_knots(n, spacing, rng):
    """float32 knots of a long axis: ``"integer"`` 0, 1, 2, ... (exact in
    float32 up to 2^24) or ``"nonuniform"`` gaps of 0.5 to 1.5."""
    if spacing == "integer":
        return np.arange(n, dtype=np.float32)
    kn = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
    assert np.all(np.diff(kn) > 0)
    return kn


def big_queries(kn, nq, rng):
    """``nq`` float32 queries: NaN, +-inf, +-1e38, far extrapolation, about
    ``nq / 10`` of the knots themselves, the rest uniform over the range
    +-10%."""
    lo, hi = float(kn[0]), float(kn[-1])
    span = hi - lo
    special = np.array([np.nan, np.inf, -np.inf, 1e38, -1e38, 0.0, -0.0,
                        lo - 1e6 * span, hi + 1e6 * span, lo - span, hi + span], np.float32)
    own = kn[:: -(-kn.size // (nq // 10))]
    body = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, nq - special.size - own.size)
    return rng.permutation(np.concatenate([body.astype(np.float32), own, special]))


def bank_big_kernel_phases(dev, rec):
    """K5, R2a, R3 and R3idx against their plain versions on the card, on the
    same inputs.  K5 at the JAX test's ragged shapes, (2048, 256, 4096) and
    NS5's (256, 16,384, 4,096), each with one NaN fraction and one NaN datum,
    which must reach only its two intervals in its own lane; R2a at
    10,000 x 64 and at banks 1, 7, 8, 9 and 300 (the padding) on 262,144
    queries; R3 and R3idx at n = 65,537 up to MAX_BIG_KNOTS on 1,000,000
    queries with NaN, +-inf, +-1e38, the knots and far extrapolation, for
    cubic and linear (a = b = 0) tables, against their own plain versions
    and against K1's and K2's."""
    import torch

    from ndarray_interp_tpu_torch.ops import bank_eval as be
    from ndarray_interp_tpu_torch.ops import bank_tail as bt
    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    rng = np.random.default_rng(5)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    print("wide-bank and long-axis kernel phases (kernel against its plain version, same "
          "inputs):", flush=True)
    for n, bank, nq in ((16, (300,), 100), (64, (999,), 513), (33, (256,), 8),
                        (129, (16, 33), 77), (2048, (256,), 4096), (256, (16_384,), 4096)):
        width = int(np.prod(bank))
        d, a, b = (T(rng.normal(size=(m,) + bank).astype(np.float32)) for m in (n, n - 1, n - 1))
        j, lane = n // 2, width // 3
        d.view(n, width)[j, lane] = float("nan")
        idx = rng.integers(0, n - 1, nq).astype(np.int32)
        idx[:2] = (j - 1, j)
        idx = T(idx)
        t = rng.uniform(-0.5, 1.5, nq).astype(np.float32)
        t[-1] = np.nan
        t = T(t)
        label = f"({n}, {'x'.join(map(str, bank))}, {nq})"
        got = be.banked_eval(d, a, b, idx, t)
        ok = rec.add("K5", label, got, be._gather_form(d, a, b, idx, t))
        expect = torch.isnan(t)[:, None].repeat(1, width)
        expect[:, lane] |= (idx == j - 1) | (idx == j)
        local = torch.equal(torch.isnan(got.reshape(nq, width)), expect)
        print(f"  K5 {label}: {'bit-identical' if ok else 'MISMATCH'}; NaN datum only in its "
              f"two intervals of lane {lane}: {'ok' if local else 'FAIL'}", flush=True)
        if not local:
            fail(f"K5 {label}: a NaN datum reached other lanes or intervals")
        del d, a, b, got, expect
    for n, bank in ((10_000, 64), (1000, 1), (1000, 7), (1000, 8), (1000, 9), (1000, 300)):
        nq = 262_144
        d, a, b = (T(rng.normal(size=(m, bank)).astype(np.float32)) for m in (n, n - 1, n - 1))
        packed = bt.pack_bank_rows(d, a, b)
        idx = T(rng.integers(0, n - 1, nq).astype(np.int32))
        t = T(np.r_[rng.uniform(-0.5, 1.5, nq - 4), [np.nan, np.inf, -np.inf, 1e30]]
              .astype(np.float32))
        label = f"({n:,} x {bank}, bp {packed.shape[1] // 4}), {nq:,} queries"
        ok = rec.add("R2a", label, bt.banked_hermite_tail(packed, idx, t, bank),
                     bt._tail_plain(packed, idx, t, bank))
        print(f"  R2a {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)
        del d, a, b, packed
    torch.cuda.synchronize()
    for n, spacing in ((65_537, "integer"), (70_001, "nonuniform"), (N_NS1B, "nonuniform"),
                       (1_048_576, "integer"), (bk.MAX_BIG_KNOTS, "integer")):
        kn = big_knots(n, spacing, rng)
        k, q = T(kn), T(big_queries(kn, NQ_BIG, rng))
        d, a, b = (T(rng.normal(size=m).astype(np.float32)) for m in (n, n - 1, n - 1))
        z = torch.zeros_like(a)
        label = f"n={n:,} {spacing} (JAX W={bk._geometry(n)[0]}), {NQ_BIG:,} queries"
        ok = True
        for tname, (aa, bb) in (("cubic", (a, b)), ("linear", (z, z))):
            got = bk.big_eval_1d(k, d, aa, bb, q)
            ok &= rec.add("R3", f"{label} {tname}", got, bk._big_eval_plain(k, d, aa, bb, q))
            ok &= rec.add("R3", f"{label} {tname}, K1's plain version", got,
                          ek._eval_plain(k, ek.make_interval_table(k, d, aa, bb), q))
        got = bk.big_lower_index_frac(k, q)
        ok &= rec.add_pair("R3idx", label, got, bk._big_index_frac_plain(k, q))
        ok &= rec.add_pair("R3idx", f"{label}, K2's plain version", got, ek._index_frac_plain(k, q))
        print(f"  {label}: R3 (cubic and linear), R3idx (idx, t) "
              f"{'bit-identical' if ok else 'MISMATCH'}", flush=True)
        del k, q, d, a, b, z, got
        torch.cuda.synchronize()


def bank_big_path(dev, rng):
    """The wide-bank and long-axis slice through the public API on
    ``device="cuda"`` at the JAX package's widths, each call with every launch
    count set to 0 just before it and read just after; gated against SciPy in
    f64 on the f32-rounded inputs.  Returns what the timing phase reuses and
    the launches of each kernel summed over the calls."""
    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch.interp1d import (
        Akima, CubicSpline, Interp1D, Linear, Makima, Pchip,
    )

    drive, total = counted_calls()
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    spline = CubicSpline().extrapolate(True)
    out = {}

    def build(data, x, strat, label, expect):
        return drive(label, expect, lambda: Interp1D.builder(data).x(x).strategy(strat).build())

    def lanes_of(width):
        return np.sort(rng.choice(width, LANES_ORACLE, replace=False))

    # NS5: 256 knots x 16,384 splines, 4,096 bf16 queries cast to f32 -> K5
    x5 = np.linspace(0.0, 1.0, 256).astype(np.float32)
    d5 = rng.normal(size=(256, 16_384)).astype(np.float32)
    q5 = T(rng.uniform(0.0, 1.0, 4096)).to(torch.bfloat16)
    itp5 = build(T(d5), T(x5), spline, "NS5 build 256 x 16,384", ["K4"])
    q5f = q5.to(torch.float32)
    got = drive("NS5 itp(q.float()) at 4,096 bf16 queries", ["K2", "K5"], lambda: itp5(q5f))
    lanes = lanes_of(16_384)
    ref = si.CubicSpline(x5.astype(np.float64), d5[:, lanes].astype(np.float64), axis=0)(
        q5f.cpu().numpy().astype(np.float64))
    check_close(f"NS5 256 x 16,384 at 4,096 queries ({LANES_ORACLE} lanes)", got[:, lanes], ref,
                F32_TOL, (4096, LANES_ORACLE), torch.float32)
    out["NS5"] = (itp5, q5f)
    del got, d5

    # NS5b: 64 knots x 1,000,000 splines, built on the card, eval at 256 queries -> K5
    x6 = T(np.linspace(0.0, 1.0, 64).astype(np.float32))
    gen = torch.Generator(device=dev).manual_seed(6)
    d6 = torch.randn((64, 1_000_000), generator=gen, device=dev)
    itp6 = build(d6, x6, spline, "NS5b build 64 x 1,000,000", ["K4"])
    q6 = T(rng.uniform(0.0, 1.0, 256).astype(np.float32))
    got = drive("NS5b itp(q) at 256 queries", ["K2", "K5"], lambda: itp6(q6))
    lanes = lanes_of(1_000_000)
    ref = si.CubicSpline(x6.cpu().numpy().astype(np.float64),
                         d6[:, lanes].cpu().numpy().astype(np.float64), axis=0)(
        q6.cpu().numpy().astype(np.float64))
    check_close(f"NS5b 64 x 1,000,000 at 256 queries ({LANES_ORACLE} lanes)", got[:, lanes], ref,
                F32_TOL, (256, LANES_ORACLE), torch.float32)
    out["NS5b"] = (itp6, q6, d6, x6)
    del got
    torch.cuda.empty_cache()

    # NS2b: 10,240 knots x 64 at 1,000,000 queries -> K2 + the packed route (R2a)
    x10 = np.linspace(0.0, 1.0, 10_240).astype(np.float32)
    d10 = rng.normal(size=(10_240, 64)).astype(np.float32)
    q10 = rng.uniform(0.0, 1.0, NQ_BIG).astype(np.float32)
    itp10 = build(T(d10), T(x10), spline, "NS2b build 10,240 x 64", ["K4"])
    q10_d = T(q10)
    got = drive(f"NS2b itp(q) at {NQ_BIG:,} queries", ["K2", "R2a"], lambda: itp10(q10_d))
    ref = si.CubicSpline(x10.astype(np.float64), d10.astype(np.float64), axis=0)(
        q10.astype(np.float64))
    check_close(f"NS2b 10,240 x 64 at {NQ_BIG:,} queries", got, ref, F32_TOL, (NQ_BIG, 64),
                torch.float32)
    out["NS2b"] = (itp10, q10_d)
    del got, ref

    # NS1b: 262,144 knots on linspace(0, 100), 1,000,000 queries -> R3; Linear -> R3;
    # a bank of 8 splines on that axis -> R3idx + R2a
    xb = np.linspace(0.0, 100.0, N_NS1B).astype(np.float32)
    vb = rng.normal(size=N_NS1B).astype(np.float32)
    qb = rng.uniform(0.0, 100.0, NQ_BIG).astype(np.float32)
    xb_d, vb_d, qb_d = T(xb), T(vb), T(qb)
    x64, q64 = xb.astype(np.float64), qb.astype(np.float64)
    itpb = build(vb_d, xb_d, spline, f"NS1b build {N_NS1B:,} knots", ["K4"])
    got = drive(f"NS1b itp(q) at {NQ_BIG:,} queries", ["R3"], lambda: itpb(qb_d))
    check_close(f"NS1b {N_NS1B:,} knots at {NQ_BIG:,} queries", got,
                si.CubicSpline(x64, vb.astype(np.float64))(q64), F32_TOL, (NQ_BIG,), torch.float32)
    linb = build(vb_d, xb_d, Linear().extrapolate(True), "NS1b Linear build", [])
    got = drive(f"NS1b Linear itp(q) at {NQ_BIG:,} queries", ["R3"], lambda: linb(qb_d))
    check_close(f"NS1b Linear {N_NS1B:,} knots at {NQ_BIG:,} queries", got,
                np.interp(q64, x64, vb.astype(np.float64)), F32_TOL, (NQ_BIG,), torch.float32)
    db = rng.normal(size=(N_NS1B, 8)).astype(np.float32)
    bankb = build(T(db), xb_d, spline, f"NS1b bank build {N_NS1B:,} x 8", ["K4"])
    got = drive(f"NS1b bank itp(q) at {NQ_BIG:,} queries", ["R3idx", "R2a"], lambda: bankb(qb_d))
    check_close(f"NS1b bank {N_NS1B:,} x 8 at {NQ_BIG:,} queries", got,
                si.CubicSpline(x64, db.astype(np.float64), axis=0)(q64), F32_TOL, (NQ_BIG, 8),
                torch.float32)
    out["NS1b"] = (itpb, linb, bankb, qb_d)
    del got, db

    # NS4: Akima, Makima and Pchip on 2,048 knots -> K1; Akima on NS1b's axis -> R3
    x4 = np.linspace(0.0, 100.0, 2048).astype(np.float32)
    v4 = rng.normal(size=2048).astype(np.float32)
    x4_64, v4_64 = x4.astype(np.float64), v4.astype(np.float64)
    for name, strat, oracle in (
        ("Akima", Akima(), si.Akima1DInterpolator(x4_64, v4_64)),
        ("Makima", Makima(), si.Akima1DInterpolator(x4_64, v4_64, method="makima")),
        ("Pchip", Pchip(), si.PchipInterpolator(x4_64, v4_64)),
    ):
        itp = build(T(v4), T(x4), strat.extrapolate(True), f"NS4 {name} build 2,048 knots", [])
        got = drive(f"NS4 {name} itp(q) at {NQ_BIG:,} queries", ["K1"], lambda: itp(qb_d))
        check_close(f"NS4 {name} 2,048 knots at {NQ_BIG:,} queries", got, oracle(q64), F32_TOL,
                    (NQ_BIG,), torch.float32)
        out["NS4", name] = itp
    itp = build(vb_d, xb_d, Akima().extrapolate(True), f"NS4 Akima build {N_NS1B:,} knots", [])
    got = drive(f"NS4 Akima {N_NS1B:,} knots itp(q)", ["R3"], lambda: itp(qb_d))
    check_close(f"NS4 Akima {N_NS1B:,} knots at {NQ_BIG:,} queries", got,
                si.Akima1DInterpolator(x64, vb.astype(np.float64))(q64), F32_TOL, (NQ_BIG,),
                torch.float32)
    out["NS4", "Akima big"] = itp
    return out, total


# --sweeps: R2a on prefixes 2^12-2^20 of NS2b's queries, on 10,240-knot
# tables of these banks
R2A_BANKS = (8, 64, 256)


def misaligned(packed):
    """A copy of ``packed`` one element past a 16-byte boundary, which R2a
    reads one column a lane: its first design's body."""
    import torch

    buf = torch.empty(packed.numel() + 1, dtype=packed.dtype, device=packed.device)
    return buf[1:].view(packed.shape).copy_(packed)


def r2a_phase(system, bank_eval, card, rec, sweeps):
    """R2a on NS2b's packed table and queries ``system`` and at the bank
    eval's shape ``bank_eval`` (its interpolator and queries): the wrapper's
    body (16-byte lanes) against the first design's (one column a lane, which
    the wrapper takes on a table off 16-byte alignment), both held bit for
    bit against ``_tail_plain`` and timed in turn.  With ``sweeps``, also the
    diagnosis at NS2b (all queries in one interval, the queries already in
    interval order: how much of the time is row traffic), the table in
    float64 and prefixes of 2^12 to 2^20 queries at banks 8, 64 and 256.
    Returns the keys the kernels line adds."""
    import torch

    from ndarray_interp_tpu_torch.ops import bank_tail as bt
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    label, args = system
    packed, idx, t, bank = args
    nq = idx.shape[0]

    def turns(what, a, calls, check=True, both_ways=True):
        """The two bodies held against the plain version and timed in turn
        (16-byte lanes, first design, and back where ``both_ways``); the
        mean of each body's turns."""
        table, rest = a[0], a[1:]
        bodies = {"16-byte lanes": table, "first design": misaligned(table)}
        want = bt._tail_plain(*a) if check else None
        got, ok = {name: [] for name in bodies}, True
        for name in list(bodies) + (list(bodies)[::-1] if both_ways else []):
            if check and not got[name]:
                ok &= rec.add("R2a", f"{what}, {name}", bt.banked_hermite_tail(
                    bodies[name], *rest), want)
            got[name].append(device_ms(lambda: bt.banked_hermite_tail(bodies[name], *rest),
                                       calls)[0])
        got = {name: float(np.mean(v)) for name, v in got.items()}
        row = table.shape[1] * table.element_size()
        verdict = ("both bit-identical to" if ok else "MISMATCH against") if check else (
            "not compared here with")
        print(f"  R2a {what}: {rest[0].shape[0]:,} queries, {row:,} B rows: "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in got.items())
              + f" ms; {verdict} _tail_plain", flush=True)
        return got

    print(f"  R2a {label}: bound {bound('R2a', args)[0]:.4f} (bytes)", flush=True)
    main = turns(label, args, 5)
    itp, q = bank_eval
    idx_b, t_b = ek.fused_index_frac(itp.x, q)
    s_, rows_b = itp.strategy, itp.data.shape[0] - 1
    table = bt.pack_bank_rows(itp.data, s_.a.reshape(rows_b, -1), s_.b.reshape(rows_b, -1))
    at_eval = turns(f"bank eval's table {rows_b + 1:,} x {itp.data.shape[1]}",
                    (table, idx_b, t_b, itp.data.shape[1]), 10)
    del table
    if sweeps:
        turns("all queries in one interval", (packed, torch.full_like(idx, int(idx[0])), t,
                                              bank), 5)
        perm = torch.argsort(idx.clamp(0, packed.shape[0] - 1), stable=True)
        turns("queries already in interval order", (packed, idx[perm], t[perm], bank), 5)
        del perm
        turns("the table in float64", (packed.double(), idx, t.double(), bank), 5)
        rng = np.random.default_rng(55)
        n = packed.shape[0] + 1
        for width in R2A_BANKS:
            if width == bank:
                table = packed
            else:
                data = [torch.as_tensor(rng.normal(size=(m, width)).astype(np.float32),
                                        device=packed.device) for m in (n, n - 1, n - 1)]
                table = bt.pack_bank_rows(*data)
                del data
            for m in BANK_SWEEP:
                m = min(m, nq)
                turns(f"{n:,} x {width} table, first {m:,} queries",
                      (table, idx[:m], t[:m], width), 20 if m <= 65_536 else 5,
                      check=m == nq, both_ways=False)
            del table
    torch.cuda.synchronize()
    return {"first_design_ms": main["first design"], "bank_eval_ms": at_eval}


def timing_big(state, bank_eval, card, rec, sweeps):
    """Hold K5, R2a, R3 and R3idx, through their wrappers, against their
    plain versions on the paths' own inputs; time both there, with K1 and
    R3's first design at NS1b beside R3 (and R3idx's beside R3idx), R3 and
    R3idx by their budgets (``r3_phase``, ``r3idx_phase``) and
    R2a's two bodies (``r2a_phase``, also at the bank eval's shape
    ``bank_eval``); then time the slice's calls end to end, and those on R2a
    and R3 also by CUDA events."""
    import torch

    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.ops import bank_eval as be
    from ndarray_interp_tpu_torch.ops import bank_tail as bt
    from ndarray_interp_tpu_torch.ops import bigknots as bk
    from ndarray_interp_tpu_torch.ops import eval_kernels as ek

    itp5, q5 = state["NS5"]
    itp6, q6, d6, x6 = state["NS5b"]
    itp10, q10 = state["NS2b"]
    itpb, linb, bankb, qb = state["NS1b"]

    def k5_args(itp, q):
        idx, t = ek.fused_index_frac(itp.x, q)
        return (itp.data, itp.strategy.a, itp.strategy.b, idx, t)

    def r2a_args(itp, q):
        idx, t = ek.fused_index_frac(itp.x, q)
        s, n = itp.strategy, itp.data.shape[0]
        return (bt.pack_bank_rows(itp.data, s.a.reshape(n - 1, -1), s.b.reshape(n - 1, -1)),
                idx, t, itp.data.shape[1])

    s = itpb.strategy
    nq = f"{NQ_BIG:,} queries"
    systems = {
        "K5": [("NS5 table 256 x 16,384, 4,096 queries", k5_args(itp5, q5)),
               ("NS5b table 64 x 1,000,000, 256 queries", k5_args(itp6, q6))],
        "R2a": [(f"NS2b packed table 10,240 x 64, {nq}", r2a_args(itp10, q10))],
        "R3": [(f"NS1b {N_NS1B:,} knots, {nq}", (itpb.x, itpb.data, s.a, s.b, qb))],
        "R3idx": [(f"NS1b {N_NS1B:,} knots, {nq}", (itpb.x, qb))],
    }
    pairs = {
        "K5": (be.banked_eval, be._gather_form, rec.add, (10, 2)),
        "R2a": (bt.banked_hermite_tail, bt._tail_plain, rec.add, (20, 5)),
        "R3": (bk.big_eval_1d, bk._big_eval_plain, rec.add, (50, 5)),
        "R3idx": (bk.big_lower_index_frac, bk._big_index_frac_plain, rec.add_pair, (50, 5)),
    }
    print("K5, R2a, R3 and R3idx at the paths' shapes and inputs, against their plain versions:")
    for kid, (kern, plain, compare, _) in pairs.items():
        for label, args in systems[kid]:
            ok = compare(kid, label, kern(*args), plain(*args))
            print(f"  {kid} {label}: {'bit-identical' if ok else 'MISMATCH'}", flush=True)
    tbl = ek.make_interval_table(itpb.x, itpb.data, s.a, s.b)
    ok = rec.add("R3", "NS1b against K1's plain version", bk.big_eval_1d(itpb.x, itpb.data, s.a,
                 s.b, qb), ek._eval_plain(itpb.x, tbl, qb))
    print(f"  R3 NS1b against K1's plain version: {'bit-identical' if ok else 'MISMATCH'}")
    times = time_kernels(pairs, systems, card)
    times["R3"].update(r3_phase(qb.device, card, rec, sweeps))
    times["R3idx"].update(r3idx_phase(qb.device, card, rec, sweeps))
    print("R2a's bodies at NS2b's table and queries:", flush=True)
    times["R2a"].update(r2a_phase(systems["R2a"][0], bank_eval, card, rec, sweeps))
    kern, plain, _, (nk, npl) = pairs["K5"]
    label, args = systems["K5"][1]
    tk_, tp_ = device_ms(lambda: kern(*args), nk), device_ms(lambda: plain(*args), npl)
    bound_ms, bound_by = bound("K5", args)
    print(f"  K5 {label}: kernel {fmt(tk_)}, plain {fmt(tp_)}, bound {bound_ms:.4f} ({bound_by}); "
          f"library: none", flush=True)
    # K4 at the NS5b build: 64 knots x 1,000,000 columns, the resident slice
    from ndarray_interp_tpu_torch.models.strategies.cubic import _NOT_A_KNOT, _assemble_system
    from ndarray_interp_tpu_torch.ops import thomas_kernel as tk
    from ndarray_interp_tpu_torch.ops.thomas import thomas_solve

    args = _assemble_system(x6, d6, _NOT_A_KNOT, 0.0, _NOT_A_KNOT, 0.0)
    ok = rec.add("K4", "NS5b build 64 x 1,000,000", tk.thomas_solve_fast(*args),
                 thomas_solve(*args))
    tk_, tp_ = device_ms(lambda: tk.thomas_solve_fast(*args), 5), device_ms(
        lambda: thomas_solve(*args), 1)
    bound_ms, bound_by = bound("K4", args)
    print(f"  K4 NS5b build 64 x 1,000,000 f32 ({'bit-identical' if ok else 'MISMATCH'}): kernel "
          f"{fmt(tk_)}, plain {fmt(tp_)}, bound {bound_ms:.4f} ({bound_by})", flush=True)
    args = (itpb.x, tbl, qb)
    tk_ = device_ms(lambda: ek.fused_eval_1d(*args), 50)
    bound_ms, bound_by = bound("K1", args)
    default = bk._R3_TREE_BYTES
    bk._R3_TREE_BYTES = qb.element_size()  # budget 0: R3's and R3idx's first designs
    try:
        first = device_ms(lambda: bk.big_eval_1d(*systems["R3"][0][1]), 50)
        first_idx = device_ms(lambda: bk.big_lower_index_frac(*systems["R3idx"][0][1]), 50)
    finally:
        bk._R3_TREE_BYTES = default
    times["R3"]["first_design_ms"] = first[0]
    times["R3idx"]["ns1b_first_design_ms"] = first_idx[0]
    print(f"  K1 beside R3, NS1b {N_NS1B:,} knots, {nq}: kernel {fmt(tk_)}, bound "
          f"{bound_ms:.4f} ({bound_by}); R3 {times['R3']['ms']:.4f}, R3's first design "
          f"{fmt(first)}; R3idx {times['R3idx']['ms']:.4f}, R3idx's first design "
          f"{fmt(first_idx)}", flush=True)
    del systems, args, tbl

    spline = CubicSpline().extrapolate(True)
    end_to_end({
        "NS5 itp(q), 256 x 16,384 at 4,096 queries": (lambda: itp5(q5), 10),
        "NS5b itp(q), 64 x 1,000,000 at 256 queries": (lambda: itp6(q6), 5),
        "NS5b build, 64 x 1,000,000": (
            lambda: Interp1D.builder(d6).x(x6).strategy(spline).build(), 3),
        f"NS2b itp(q), 10,240 x 64 at {nq}": (lambda: itp10(q10), 5),
        f"NS1b itp(q), {N_NS1B:,} knots at {nq}": (lambda: itpb(qb), 20),
        f"NS1b Linear itp(q), {N_NS1B:,} knots at {nq}": (lambda: linb(qb), 20),
        f"NS1b bank itp(q), {N_NS1B:,} x 8 at {nq}": (lambda: bankb(qb), 10),
        f"NS4 Akima itp(q), 2,048 knots at {nq}": (lambda: state["NS4", "Akima"](qb), 20),
        f"NS4 Pchip itp(q), 2,048 knots at {nq}": (lambda: state["NS4", "Pchip"](qb), 20),
        f"NS4 Akima itp(q), {N_NS1B:,} knots at {nq}": (
            lambda: state["NS4", "Akima big"](qb), 20),
    }, "wide-bank and long-axis slice", card)
    # the calls on R2a and R3 by CUDA events too (they make no host sync, so
    # with the queue held full this is their busy time): the profiler has lost
    # some of their records
    print(f"the calls on R2a and R3 by CUDA events (device ms per call, median [min, max] of "
          f"{RUNS} runs, queue held full; card: {card}):", flush=True)
    itp_b, q_b = bank_eval
    turns = {"R3idx at the wrapper's budget": [], "R3idx's first design": []}
    try:  # NS1b bank on R3idx and on its first design, in turns (A B B A)
        for name in (*turns, *reversed(turns)):
            bk._R3_TREE_BYTES = default if name.startswith("R3idx at") else qb.element_size()
            turns[name].append(device_ms(lambda: bankb(qb), 5))
    finally:
        bk._R3_TREE_BYTES = default
    for name, t_ in turns.items():
        print(f"  NS1b bank itp(q), {N_NS1B:,} x 8 at {nq}, {name}: "
              + ", ".join(fmt(t) for t in t_), flush=True)
    times["R3idx"]["ns1b_bank_ms"] = float(np.mean([t[0] for t in turns["R3idx at the wrapper's "
                                                                         "budget"]]))
    times["R3idx"]["ns1b_bank_first_design_ms"] = float(np.mean([t[0] for t in
                                                                 turns["R3idx's first design"]]))
    for label, fn in (
        (f"bank eval itp(q), 10,000 x 64 at {q_b.numel():,}", lambda: itp_b(q_b)),
        (f"NS2b itp(q), 10,240 x 64 at {nq}", lambda: itp10(q10)),
        (f"NS1b itp(q), {N_NS1B:,} knots at {nq}", lambda: itpb(qb)),
        (f"NS1b Linear itp(q), {N_NS1B:,} knots at {nq}", lambda: linb(qb)),
        (f"NS4 Akima itp(q), {N_NS1B:,} knots at {nq}", lambda: state["NS4", "Akima big"](qb)),
    ):
        print(f"  {label}: {fmt(device_ms(fn, 5))}", flush=True)
    return times


# -- the f64-grade bicubic tails, the step family and calculus -------------------------------
# The tails run at NS3d: the 2-D path's f64 extrapolating Bicubic (512 x 512 x 16, built on the
# card) at its 1,000,000 double-float-representable queries, through
# gathered_bicubic_eval_df_packed with each tail (R4c is tail="weight").  The step family runs
# at NS1's width (2,048 f32 knots, 1,000,000 queries) and on NS3's grid; calculus on the NS1
# spline in f64, a 10,000 x 64 f64 bank and the NS3b Bicubic in f64.
DF_TAILS = (("mxu", "K12"), ("nested", "K12"), ("weight", "R4c"))
NQ_STEP_ORACLE = 131_072  # SciPy interp1d on the host
NQ_CALC_ORACLE = 65_536  # RectBivariateSpline.ev on the host, all 16 channels
N_BOUNDS = 4096  # integration bound pairs (1-D) and boxes (2-D)
N_BOUNDS_ORACLE = (1024, 256)  # of them SciPy integrates (1-D, 2-D: dblint is O(grid))


def allclose_gate(label, got, ref, rtol, atol):
    """``np.testing.assert_allclose(got, ref, rtol, atol)`` as a gate: every
    ``|got - ref| <= atol + rtol |ref|``; prints the largest ratio."""
    arr = got.detach().cpu().numpy().astype(np.float64)
    finite = bool(np.isfinite(arr).all())
    worst = float(np.max(np.abs(arr - ref) / (atol + rtol * np.abs(ref)))) if arr.size else 0.0
    ok = arr.shape == ref.shape and finite and worst <= 1.0
    print(f"  {label}: shape {arr.shape}, finite={finite}, max |err| / (atol + rtol |ref|) "
          f"{worst:.3e} (rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: shape {arr.shape} against {ref.shape}, finite {finite}, ratio {worst}")


def roots_gate(label, got, ref):
    """The finite roots against SciPy's: the same count, then within the
    tolerance of ``tests/test_calculus.py``'s solve tests."""
    import torch

    roots = got[torch.isfinite(got)]
    print(f"  {label}: {roots.numel()} roots (SciPy {ref.size}), padded to {got.shape[0]}",
          flush=True)
    if roots.numel() != ref.size:
        fail(f"{label}: {roots.numel()} roots against SciPy's {ref.size}")
        return
    allclose_gate(f"{label} values", roots, ref, 1e-7, 1e-8)


def exact_gate(label, got, ref):
    """Selection does no arithmetic: equal to the oracle, value for value."""
    arr = got.cpu().numpy().astype(np.float64)
    err = float(np.max(np.abs(arr - ref))) if arr.size else 0.0
    ok = arr.shape == ref.shape and err == 0.0
    print(f"  {label}: shape {arr.shape}, max abs err {err} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: shape {arr.shape} against {ref.shape}, max abs err {err}")


def tails_path(state2d):
    """NS3d's route with each tail, launch counts set to 0 just before each
    call and read just after; each result gated against the float64
    scaled-Hermite form at 4e-12, "weight" against "nested" over every
    query within ``R4C_VS_K12``.  Returns the route's arguments and the
    launches of each kernel summed over the calls."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    drive, total = counted_calls()
    ev = state2d["Bicubic", "df"]
    dqx, dqy = state2d["df queries"]
    args = (*ev._run.args[:4], ev._packed, *df_from_f64(dqx), *df_from_f64(dqy))
    ref, r = state2d["NS3d ref"], GRID2D[2]
    shape = "x".join(map(str, GRID2D))
    got = {}
    for tail, kid in DF_TAILS:
        pair = drive(f"NS3d gathered_bicubic_eval_df_packed(tail={tail!r}) at {NQ2D:,} queries",
                     ["K7", kid], lambda: e2.gathered_bicubic_eval_df_packed(*args, r=r, tail=tail))
        got[tail] = df_to_f64(*pair)
        gate(f"NS3d tail={tail!r} {shape}", got[tail][: ref.shape[0]], ref, 4e-12, ref.shape,
             f"the f64 scaled-Hermite form, first {ref.shape[0]:,} queries")
    err = df_scaled_err(got["weight"].cpu().numpy(), got["nested"].cpu().numpy())
    print(f"  NS3d tail='weight' against tail='nested' on all {NQ2D:,} queries: {err:.3e} "
          f"scale-relative (gate {R4C_VS_K12:g}) {'ok' if err <= R4C_VS_K12 else 'FAIL'}",
          flush=True)
    if not err <= R4C_VS_K12:
        fail(f"NS3d: tail='weight' is {err} from tail='nested'")
    return args, total


def step_path(dev, state2d, rng):
    """``Nearest`` in its four modes at NS1's width (2,048 f32 knots,
    1,000,000 queries) against SciPy's ``interp1d(kind=...)`` on a prefix,
    the example's ``StepInterpolator`` (``PointwiseStrategy``, vmapped)
    equal to ``Nearest("nearest-up")``, and ``Nearest2D`` on NS3's grid
    against ``RegularGridInterpolator(method="nearest")``; each call with
    the launch counts set to 0 just before it and read just after (the
    family runs no kernel: its search is ``torch.searchsorted``, XLA's in the
    JAX package)."""
    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch.examples.custom_strategy import StepInterpolator
    from ndarray_interp_tpu_torch.interp1d import Interp1D, Nearest
    from ndarray_interp_tpu_torch.interp2d import Interp2D, Nearest2D

    drive, total = counted_calls()
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    kn = np.linspace(0.0, 100.0, 2048).astype(np.float32)
    v = rng.normal(size=2048).astype(np.float32)
    q = rng.uniform(0.0, 100.0, NQ_BIG).astype(np.float32)
    q_d, sub = T(q), slice(0, NQ_STEP_ORACLE)
    q64 = q[sub].astype(np.float64)
    out = {"queries": q_d}
    for mode in ("nearest", "nearest-up", "previous", "next"):
        itp = drive(f"Nearest({mode!r}) build, 2,048 f32 knots", [], lambda: (
            Interp1D.builder(T(v)).x(T(kn)).strategy(Nearest(mode)).build()))
        got = drive(f"Nearest({mode!r}) itp(q) at {NQ_BIG:,} queries", [], lambda: itp(q_d))
        ref = si.interp1d(kn.astype(np.float64), v.astype(np.float64), kind=mode)(q64)
        exact_gate(f"Nearest({mode!r}) against SciPy interp1d, first {NQ_STEP_ORACLE:,} queries",
                   got[sub], ref)
        out[mode] = (itp, got)
    custom = Interp1D.builder(T(v)).x(T(kn)).strategy(StepInterpolator()).build()
    got = drive(f"StepInterpolator (PointwiseStrategy, torch.func.vmap) at {NQ_BIG:,} queries",
                [], lambda: custom(q_d))
    same, err = bit_compare(got, out["nearest-up"][1])
    print(f"  StepInterpolator against Nearest('nearest-up') on all {NQ_BIG:,} queries: "
          f"{'equal' if same else 'DIFFERENT'} (max abs err {err})", flush=True)
    if not same:
        fail(f"StepInterpolator differs from Nearest('nearest-up') (max abs err {err})")
    out["custom"] = custom

    x, y = state2d["axes"]
    _, _, qx, qy, zd = state2d["float32"]
    nn = drive(f"Nearest2D build {'x'.join(map(str, GRID2D))} f32", [], lambda: (
        Interp2D.builder(zd).x(T(x.astype(np.float32))).y(T(y.astype(np.float32)))
        .strategy(Nearest2D()).build()))
    got = drive(f"NS3 Nearest2D itp(xs, ys) at {NQ2D:,} queries", [], lambda: nn(qx, qy))
    ref = si.RegularGridInterpolator((x, y), zd.cpu().numpy().astype(np.float64),
                                     method="nearest")(
        np.stack([qx.cpu().numpy(), qy.cpu().numpy()], -1).astype(np.float64))
    exact_gate(f"NS3 Nearest2D against RegularGridInterpolator(method='nearest'), all "
               f"{NQ2D:,} queries", got, ref)
    out["Nearest2D"] = nn
    return out, total


def calculus_path(dev, state, state2d, rng):
    """Calculus through the public API at full width, against SciPy at the
    tolerances of ``tests/test_calculus.py``, each call with the launch
    counts set to 0 just before it and read just after: on the NS1 spline in
    f64 (2,048 knots, not-a-knot, extrapolating) ``derivative`` of orders 1-3
    at 1,000,000 queries (K3), ``roots()`` and ``solve(0.3)``; a 10,000 x 64
    f64 bank built on the card (K4) and integrated over 4,096 bound pairs
    (K3); the NS3b ``Bicubic`` in f64 (512 x 512 x 16): ``derivative`` at
    (dx, dy) in {(1, 0), (0, 1), (1, 1), (2, 0)} at 1,000,000 queries (K2)
    against ``RectBivariateSpline(s=0).ev`` on a prefix, and ``integrate``
    over 4,096 boxes (the node grids solved again: K4) against
    ``.integral``."""
    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D

    drive, total = counted_calls()
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = {}
    itp, q = state["float64"]
    sp = si.CubicSpline(itp.x.cpu().numpy(), itp.data.cpu().numpy())
    qn = q.cpu().numpy()
    for order, rtol, atol in ((1, 1e-9, 1e-10), (2, 1e-8, 1e-9), (3, 1e-8, 1e-9)):
        got = drive(f"NS1 f64 derivative(order={order}) at {qn.size:,} queries", ["K3"],
                    lambda: itp.derivative(q, order=order))
        allclose_gate(f"NS1 f64 derivative(order={order}) against CubicSpline.derivative",
                      got, sp.derivative(order)(qn), rtol, atol)
        del got
    for level in (0.0, 0.3):
        got = drive(f"NS1 f64 solve({level})", [], lambda: itp.solve(level))
        roots_gate(f"NS1 f64 solve({level}) against CubicSpline.solve(extrapolate=True)", got,
                   np.sort(sp.solve(level, extrapolate=True)))
    out["NS1"] = (itp, q)

    xb = np.linspace(0.0, 1.0, 10_000)
    bank = rng.normal(size=(10_000, 64))
    itpb = drive("f64 bank build 10,000 x 64", ["K4"], lambda: (
        Interp1D.builder(T(bank)).x(T(xb)).strategy(CubicSpline()).build()))
    bounds = rng.uniform(0.0, 1.0, (N_BOUNDS, 2))  # lo > hi in about half: signed
    got = drive(f"bank integrate over {N_BOUNDS:,} bound pairs", ["K3"], lambda: (
        torch.stack([itpb.integrate(lo, hi) for lo, hi in bounds])))
    m = N_BOUNDS_ORACLE[0]
    spb = si.CubicSpline(xb, bank)
    allclose_gate(f"bank integrate against CubicSpline.integrate, first {m:,} pairs", got[:m],
                  np.stack([spb.integrate(lo, hi) for lo, hi in bounds[:m]]), 1e-9, 1e-11)

    x, y = state2d["axes"]
    _, bic, qx, qy, zd = state2d["float64"]
    z = zd.cpu().numpy()
    rbs = [si.RectBivariateSpline(x, y, z[..., c], s=0) for c in range(GRID2D[2])]
    sub = slice(0, NQ_CALC_ORACLE)
    qxn, qyn = qx[sub].cpu().numpy(), qy[sub].cpu().numpy()
    for ox, oy in ((1, 0), (0, 1), (1, 1), (2, 0)):
        got = drive(f"NS3b Bicubic f64 derivative(dx={ox}, dy={oy}) at {NQ2D:,} queries", ["K2"],
                    lambda: bic.derivative(qx, qy, dx=ox, dy=oy))
        ref = np.stack([s.ev(qxn, qyn, dx=ox, dy=oy) for s in rbs], axis=1)
        allclose_gate(f"NS3b derivative(dx={ox}, dy={oy}) against RectBivariateSpline.ev, first "
                      f"{NQ_CALC_ORACLE:,} queries", got[sub], ref, 1e-9, 1e-10)
        del got
    ends = (np.sort(rng.uniform(x[0], x[-1], (N_BOUNDS, 2)), axis=1),
            np.sort(rng.uniform(y[0], y[-1], (N_BOUNDS, 2)), axis=1))
    boxes = np.concatenate(ends, axis=1)  # xlo, xhi, ylo, yhi
    got = drive(f"NS3b Bicubic f64 integrate over {N_BOUNDS:,} boxes", ["K4"], lambda: (
        torch.stack([bic.integrate(*b) for b in boxes])))
    m = N_BOUNDS_ORACLE[1]
    allclose_gate(f"NS3b integrate against RectBivariateSpline.integral, first {m} boxes",
                  got[:m], np.array([[s.integral(*b) for s in rbs] for b in boxes[:m]]),
                  1e-10, 1e-11)
    out["NS3b"] = (bic, qx, qy)
    return out, total


def timing_tails_step_calculus(tails_args, steps, calc, state2d, card, rec, sweeps):
    """Hold R4c, through its wrapper, against its plain version on NS3d's
    table and queries; time both there, with K12 beside it; then time the
    NS3d route with each tail, the step family and calculus end to end."""
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as edf
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2

    ax, packed, q = tails_args[:4], tails_args[4], tails_args[5:]
    xi, txh, txl = edf.fused_index_frac_df(*ax[:2], *q[:2])
    yi, tyh, tyl = edf.fused_index_frac_df(*ax[2:], *q[2:])
    shape = "x".join(map(str, GRID2D))
    args = (packed, xi, yi, ax[2].shape[0], txh, txl, tyh, tyl)
    systems = {"R4c": [(f"NS3d df cell table {shape}, {NQ2D:,} queries", args)]}
    pairs = {"R4c": (e2.gathered_bicubic_df_weight_tail, e2._bicubic_df_weight_tail_plain,
                     rec.add_pair, (5, 1))}
    ok = rec.add_pair("R4c", "NS3d", e2.gathered_bicubic_df_weight_tail(*args),
                      e2._bicubic_df_weight_tail_plain(*args))
    print(f"R4c at NS3d's table and queries, against its plain version: "
          f"{'bit-identical' if ok else 'MISMATCH'}", flush=True)
    times = time_kernels(pairs, systems, card)
    k12 = device_ms(lambda: e2.gathered_bicubic_df_tail(*args), 5)
    print(f"  K12 beside it, same table and queries: {fmt(k12)} (R4c {times['R4c']['ms']:.4f})",
          flush=True)
    print("R4c at NS3d's table and queries, ordered by cell and unordered:", flush=True)
    times["R4c"].update(ordered_phase("R4c", systems["R4c"][0], card, rec, sweeps))

    r = GRID2D[2]
    itp1, q1 = calc["NS1"]
    bic, qx, qy = calc["NS3b"]
    calls = {
        f"NS3d route tail={tail!r} (K7 x 2 + {kid}), {shape} at {NQ2D:,} queries": (
            lambda tail=tail: e2.gathered_bicubic_eval_df_packed(*tails_args, r=r, tail=tail), 3)
        for tail, kid in DF_TAILS
    }
    calls.update({
        f"NS1 f64 derivative(order=1), 2,048 knots at {q1.numel():,} queries": (
            lambda: itp1.derivative(q1), 10),
        f"NS1 Nearest('nearest') f32 itp(q), 2,048 knots at {NQ_BIG:,} queries": (
            lambda: steps["nearest"][0](steps["queries"]), 10),
        f"NS3 Nearest2D f32 itp(xs, ys), {shape} at {NQ2D:,} queries": (
            lambda: steps["Nearest2D"](*state2d["float32"][2:4]), 10),
        f"StepInterpolator (vmapped PointwiseStrategy) f32 itp(q), 2,048 knots at {NQ_BIG:,} "
        f"queries": (lambda: steps["custom"](steps["queries"]), 10),
        f"NS3b Bicubic f64 derivative(dx=1), {shape} at {NQ2D:,} queries": (
            lambda: bic.derivative(qx, qy, dx=1), 5),
        f"NS3b Bicubic f64 integrate over one box, {shape}": (
            lambda: bic.integrate(bic.x[3], bic.x[-4], bic.y[2], bic.y[-3]), 5),
    })
    end_to_end(calls, "f64-grade tails, step family and calculus", card)
    # the profiler has lost every record of the "weight" calls in some runs:
    # the three routes' device time by CUDA events, the queue held full (the
    # route makes no host sync, so this is its busy time)
    print(f"NS3d route by CUDA events (device ms per call, median [min, max] of {RUNS} runs, "
          f"queue held full; card: {card}):", flush=True)
    for tail, kid in DF_TAILS:
        t = device_ms(lambda tail=tail: e2.gathered_bicubic_eval_df_packed(
            *tails_args, r=r, tail=tail), 3)
        print(f"  NS3d route tail={tail!r} (K7 x 2 + {kid}): {fmt(t)}", flush=True)
    return times


# -- N-D calculus and checkpoints --------------------------------------------------------
# ND2's width (benches/run_benches.py:741-782): a 64^3 grid on linspace(0, 1, 64) axes, one
# channel, 1,000,000 queries, built on the card in f64 (the cell layout: a 128 MB table; and
# forced to the node layout) and in f32.  The twins' tolerances: derivatives against the
# sequential SciPy oracle within 1e-10 of the scale (tests/test_interpnd.py:640, the
# Bicubic twin's), the node layout against the cell layout the same (:675), autograd within
# rtol 1e-10 (:640), box integrals within 1e-12 of the scale (:711).
CALCND_ORDERS = ((1, 0, 0), (0, 1, 1), (2, 1, 0), (3, 0, 0))
CALCND_TOL = 1e-10
NQ_CALCND_GRAD = 4096
N_BOXES_ND = 16


def calculus_nd_path(dev, state, state2d, rng):
    """``InterpND.derivative`` and ``integrate`` at ND2's width, and
    checkpoints saved and loaded on the card, through the public API; each
    call with the launch counts set to 0 just before it and read just
    after.  Derivatives at each order of ``CALCND_ORDERS`` (f64, cell
    layout) against the sequential SciPy oracle on a 2,048-query prefix; the
    node layout against the cell layout on every query; order 1 on each
    axis, linear and cubic, against ``torch.autograd.grad`` of ``__call__``
    on a 4,096-query prefix; 16 boxes against sequential
    ``CubicSpline.integrate``; the NS1 ``CubicSpline`` (f32 and f64), the
    NS3b ``Bicubic`` (f32) and the ND2 ``InterpND`` (f64 cubic and linear)
    through ``save`` and ``load`` onto the card, each reloaded interpolator
    equal to the original bit for bit at its 1,000,000 queries.  Returns
    what the timing reuses and the launches of each kernel summed over the
    calls."""
    import tempfile

    import scipy.interpolate as si
    import torch

    from ndarray_interp_tpu_torch.interpnd import InterpND
    from ndarray_interp_tpu_torch.utils import checkpoint

    drive, total = counted_calls()
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    shape = "x".join(map(str, GRIDND))
    axes = [np.linspace(0.0, 1.0, n) for n in GRIDND]
    data = rng.normal(size=GRIDND)
    qs = [rng.uniform(0.0, 1.0, NQND) for _ in GRIDND]
    ax_d, q_d = [T(a) for a in axes], [T(q) for q in qs]

    def nd(method, dt=torch.float64, layout=None):
        b = InterpND.builder(T(data).to(dt)).points(*(a.to(dt) for a in ax_d)).method(method)
        return (b if layout is None else b.layout(layout)).build()

    cub = drive(f"ND2 InterpND cubic f64 build {shape} (cell layout)", ["K4"], lambda: nd("cubic"))
    if cub.layout != "cell":
        fail(f"ND2 f64: the builder chose layout {cub.layout!r}, not 'cell'")
    print(f"    cell table {tuple(cub.table.shape)} f64, {cub.table.numel() * 8 / 1e6:.1f} MB",
          flush=True)
    node = drive(f"ND2 InterpND cubic f64 build {shape}, layout 'node'", ["K4"],
                 lambda: nd("cubic", layout="node"))
    lin = drive(f"ND1 InterpND linear f64 build {shape}", [], lambda: nd("linear"))
    cells = {}
    for orders in CALCND_ORDERS:
        t0 = time.perf_counter()
        ref = seq_spline_oracle(axes, data, qs, NQ_ND_ORACLE, orders)
        host = time.perf_counter() - t0
        got = drive(f"ND2 f64 derivative(orders={orders}) at {NQND:,} queries", ["K2"],
                    lambda: cub.derivative(*q_d, orders=orders))
        allclose_gate(f"ND2 f64 derivative(orders={orders}) against the sequential SciPy oracle "
                      f"(first {NQ_ND_ORACLE:,}; {host:.1f} s on the host)", got[:NQ_ND_ORACLE],
                      ref, 0.0, CALCND_TOL * max(1.0, float(np.abs(ref).max())))
        cells[orders] = got
    for orders in CALCND_ORDERS[:3]:
        got = drive(f"ND2 f64 node layout derivative(orders={orders}) at {NQND:,} queries", ["K2"],
                    lambda: node.derivative(*q_d, orders=orders))
        ref = cells[orders].cpu().numpy()
        allclose_gate(f"ND2 f64 node layout derivative(orders={orders}) against the cell layout, "
                      f"all {NQND:,}", got, ref, 0.0,
                      CALCND_TOL * max(1.0, float(np.abs(ref).max())))
    del cells, got

    sub = slice(0, NQ_CALCND_GRAD)
    for method, itp in (("cubic", cub), ("linear", lin)):
        leaves = [q[sub].clone().requires_grad_(True) for q in q_d]
        grads = drive(f"ND2 {method} f64 torch.autograd.grad of itp(*qs), {NQ_CALCND_GRAD:,} "
                      "queries", ["K2"], lambda: torch.autograd.grad(itp(*leaves).sum(), leaves))
        for d, g in enumerate(grads):
            orders = tuple(int(e == d) for e in range(3))
            want = drive(f"ND2 {method} f64 derivative(orders={orders}), {NQ_CALCND_GRAD:,} "
                         "queries", ["K2"], lambda: itp.derivative(*(q[sub] for q in q_d),
                                                                   orders=orders))
            ref = want.cpu().numpy()
            allclose_gate(f"ND2 {method} autograd axis {d} against derivative(orders={orders})",
                          g, ref, 1e-10, 1e-12 * float(np.abs(ref).max()))

    boxes = rng.uniform(0.0, 1.0, (N_BOXES_ND, 3, 2))  # lo > hi on about half the axes: signed
    got = drive(f"ND2 f64 integrate over {N_BOXES_ND} boxes", ["K4"], lambda: torch.stack(
        [cub.integrate(*(tuple(b) for b in box)) for box in boxes]))
    ref = []
    for box in boxes:
        g = data
        for d in reversed(range(3)):
            g = si.CubicSpline(axes[d], g, axis=d).integrate(*box[d])
        ref.append(float(g))
    ref = np.array(ref)
    allclose_gate(f"ND2 f64 integrate against sequential CubicSpline.integrate, {N_BOXES_ND} "
                  "boxes", got, ref, 0.0, 1e-12 * max(1.0, float(np.abs(ref).max())))

    f32 = drive(f"ND2 InterpND cubic f32 build {shape}", ["K4"], lambda: nd("cubic", torch.float32))
    q32 = [q.float() for q in q_d]
    got = drive(f"ND2 f32 derivative(orders=(1, 0, 0)) at {NQND:,} queries", ["K2"],
                lambda: f32.derivative(*q32, orders=(1, 0, 0)))
    check_close(f"ND2 f32 derivative(orders=(1, 0, 0)) against the f64 build on f32-rounded "
                f"queries, all {NQND:,}", got, cub.derivative(
                    *(q.double() for q in q32), orders=(1, 0, 0)).cpu().numpy(),
                F32_TOL, (NQND,), torch.float32)

    print("  checkpoints: save from the card, load onto it; each reload against the original "
          "bit for bit", flush=True)
    itp1, q1 = state["float32"]
    itp1d, q1d = state["float64"]
    _, bic, qx, qy, _ = state2d["float32"]
    saved = (("NS1 CubicSpline f32", itp1, (q1,), ["K1"]),
             ("NS1 CubicSpline f64", itp1d, (q1d,), ["K1"]),
             ("NS3b Bicubic f32", bic, (qx, qy), ["R1", "R2n"]),
             (f"ND2 InterpND cubic f64 {shape}", cub, q_d, ["K2"]),
             (f"ND1 InterpND linear f64 {shape}", lin, q_d, ["K2"]))
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, itp, args, expect) in enumerate(saved):
            path = Path(tmp) / f"{i}.npz"
            t0 = time.perf_counter()
            checkpoint.save(path, itp)
            t_save = time.perf_counter() - t0
            back = drive(f"{name}: load ({path.stat().st_size / 1e6:.1f} MB)",
                         ["K4"] if "cubic" in name and "InterpND" in name else [],
                         lambda: checkpoint.load(path))
            if back.data.device != itp.data.device:
                fail(f"{name}: reloaded onto {back.data.device}, not {itp.data.device}")
            got = drive(f"{name} reloaded, at {args[0].numel():,} queries", expect,
                        lambda: back(*args))
            same, err = bit_compare(got, itp(*args))
            print(f"    {name}: save {t_save:.2f} s; reloaded against the original: "
                  f"{'bit for bit' if same else 'DIFFERENT'} (max abs err {err})", flush=True)
            if not same:
                fail(f"{name}: the reloaded interpolator differs (max abs err {err})")
            del back, got
    return {"cubic": cub, "node": node, "f32": f32, "queries": q_d, "q32": q32,
            "box": tuple(tuple(b) for b in boxes[0])}, total


def timing_calculus_nd(calc_nd, card):
    """The N-D derivative (f64 and f32, cell layout; f64 on the node layout)
    at 1,000,000 queries and one ``integrate`` call, end to end."""
    shape = "x".join(map(str, GRIDND))
    cub, node, f32 = calc_nd["cubic"], calc_nd["node"], calc_nd["f32"]
    q, q32 = calc_nd["queries"], calc_nd["q32"]
    calls = {
        f"ND2 f64 derivative(orders=(1, 0, 0)), cell layout, {shape} at {NQND:,} queries": (
            lambda: cub.derivative(*q, orders=(1, 0, 0)), 5),
        f"ND2 f32 derivative(orders=(1, 0, 0)), cell layout, {shape} at {NQND:,} queries": (
            lambda: f32.derivative(*q32, orders=(1, 0, 0)), 5),
        f"ND2 f64 derivative(orders=(1, 0, 0)), node layout, {shape} at {NQND:,} queries": (
            lambda: node.derivative(*q, orders=(1, 0, 0)), 3),
        f"ND2 f64 integrate over one box, {shape}": (lambda: cub.integrate(*calc_nd["box"]), 5),
    }
    end_to_end(calls, "N-D calculus", card, top=8)


KERNELS = {
    "K1": ("fused_eval_1d", "ndarray_interp_tpu_torch/csrc/eval_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval.py:119"),
    "K2": ("fused_index_frac", "ndarray_interp_tpu_torch/csrc/eval_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval.py:408"),
    "K3": ("fused_lower_index", "ndarray_interp_tpu_torch/csrc/eval_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval.py:360"),
    "K4": ("thomas_solve_fast", "ndarray_interp_tpu_torch/csrc/thomas_kernel.cu",
           "ndarray_interp_tpu/ops/pallas_thomas.py:136"),
    "K6": ("fused_eval_1d_df", "ndarray_interp_tpu_torch/csrc/df_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval_df.py:85"),
    "K7": ("fused_index_frac_df", "ndarray_interp_tpu_torch/csrc/df_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval_df.py:426"),
    "K8": ("gathered_df_tail", "ndarray_interp_tpu_torch/csrc/df_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval_df.py:656"),
    "K9": ("gathered_f48_tail", "ndarray_interp_tpu_torch/csrc/df_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval_df.py:749"),
    "K10": ("gathered_bilinear_df_tail", "ndarray_interp_tpu_torch/csrc/df2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_eval_df.py:1027; "
            "ndarray_interp_tpu/ops/pallas_eval_df.py:892"),
    "K11": ("gathered_bilinear_f48_tail", "ndarray_interp_tpu_torch/csrc/df2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_eval_df.py:1119"),
    "K12": ("gathered_bicubic_df_tail", "ndarray_interp_tpu_torch/csrc/df2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_eval_df.py:1571; "
            "ndarray_interp_tpu/ops/pallas_eval_df.py:1378"),
    "K13": ("gathered_bicubic_f48_tail", "ndarray_interp_tpu_torch/csrc/df2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_eval_df.py:1667"),
    "K14": ("gathered_bicubic_node_df_tail", "ndarray_interp_tpu_torch/csrc/df2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_eval_df.py:1921"),
    "K15": ("nd_df_tail", "ndarray_interp_tpu_torch/csrc/df_nd_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_eval_df_nd.py:370"),
    "K15f48": ("nd_f48_tail", "ndarray_interp_tpu_torch/csrc/df_nd_kernels.cu",
               "ndarray_interp_tpu/ops/pallas_eval_df_nd.py:370"),
    "K5": ("banked_eval", "ndarray_interp_tpu_torch/csrc/bank_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_bank.py:63"),
    "R2a": ("banked_hermite_tail", "ndarray_interp_tpu_torch/csrc/bank_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_tail.py:40"),
    "R3": ("big_eval_1d", "ndarray_interp_tpu_torch/csrc/bigknots_kernels.cu",
           "ndarray_interp_tpu/ops/bigknots.py:308"),
    "R3idx": ("big_lower_index_frac", "ndarray_interp_tpu_torch/csrc/bigknots_kernels.cu",
              "ndarray_interp_tpu/ops/bigknots.py:248"),
    "R1": ("fused_cell_index", "ndarray_interp_tpu_torch/csrc/cell2d_kernels.cu",
           "ndarray_interp_tpu/ops/pallas_eval.py:522"),
    "R2b": ("bilinear_gathered_eval", "ndarray_interp_tpu_torch/csrc/cell2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_tail.py:112"),
    "R2g": ("bilinear_grid_eval", "ndarray_interp_tpu_torch/csrc/cell2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_tail.py:112"),
    "R2c": ("bicubic_gathered_eval", "ndarray_interp_tpu_torch/csrc/cell2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_tail.py:258"),
    "R2d": ("bicubic_tree_tail", "ndarray_interp_tpu_torch/csrc/cell2d_kernels.cu",
            "ndarray_interp_tpu/ops/pallas_tail.py:425"),
    "R2n": ("bicubic_nested_tail", "ndarray_interp_tpu_torch/csrc/cell2d_kernels.cu",
            "ndarray_interp_tpu/models/strategies/bicubic.py:182"),
    "R4c": ("gathered_bicubic_df_weight_tail", "ndarray_interp_tpu_torch/csrc/df2d_kernels.cu",
            "ndarray_interp_tpu/ops/df_records.py:159"),
    "ORD": ("order_by_cell", "ndarray_interp_tpu_torch/csrc/cell_order.cu",
            "none: no TPU twin (the JAX routes evaluate in query order)"),
}
# ORD's shapes: (its label, the tail whose ordered phase timed it there)
ORD_SHAPES = (("K8/K9: 2^20 queries over 10,239 intervals", "K8"),
              ("K12/K13/R4c (NS3d): 1,000,000 queries over 261,121 cells", "K12"),
              ("R2n (NS3b): 1,000,000 queries over 261,121 cells, f32 records", "R2n"),
              ("K14 (NS3e): 1,000,000 queries over 1,048,576 base nodes", "K14"))


# -- the single-device remainder: build routes, native host runtime, eval_checked --
# (knots, bank) of the build-route phase: NS5b, NS5's bank, 512 x 8,192, the
# JAX package's PCR shape and the bank build; then the banks between them at
# 64 and 256 knots, where the dense build's turn lies
BUILD_SHAPES = (("NS5b", 64, 1_000_000), ("NS5", 256, 16_384), ("512 x 8,192", 512, 8_192),
                ("JAX PCR shape", 2048, 4096), ("bank build", 10_000, 64),
                ("64 x 65,536", 64, 65_536), ("64 x 262,144", 64, 262_144),
                ("256 x 262,144", 256, 262_144))
# the per-axis solves of NS3b's Bicubic (512 knots, 512 x 16 columns) and
# ND2's cubic (64 knots, 64 x 64 columns): cubic._dense_k against the solve
AXIS_SHAPES = (("NS3b axis solve", 512, 8_192), ("ND2 axis solve", 64, 4_096))
# a, b of PCR and the dense build against the Thomas kernel's, scaled by the
# largest |a|: the f32 tolerances of tests/test_pcr.py (2e-5) and
# tests/test_dense_build.py (1e-5)
ROUTE_TOL = {"PCR": 2e-5, "dense": 1e-5}
NATIVE_CALLS = 20_000  # interp_scalar calls a native timing run
CARD_CALLS = 200  # interp_scalar calls a timing run on the card


def build_routes(x, y):
    """The three builds of ``(a, b)`` for a not-a-knot bank ``y`` on ``x``:
    the rhs assembly, the Thomas kernel K4 and the coefficient pass; the same
    with PCR in K4's place; the dense operator (probe and product)."""
    from ndarray_interp_tpu_torch.models.strategies.cubic import (
        _NOT_A_KNOT,
        _ab_from_k,
        _assemble_system,
        _dense_ab,
    )
    from ndarray_interp_tpu_torch.ops.pcr import pcr_solve
    from ndarray_interp_tpu_torch.ops.thomas_kernel import _ThomasKernel

    nak = (_NOT_A_KNOT, 0.0, _NOT_A_KNOT, 0.0)
    return {
        "K4": lambda: _ab_from_k(x, y, _ThomasKernel.apply(*_assemble_system(x, y, *nak))),
        "PCR": lambda: _ab_from_k(x, y, pcr_solve(*_assemble_system(x, y, *nak))),
        "dense": lambda: _dense_ab(x, y, _NOT_A_KNOT, False),
    }


def axis_routes(x, y):
    """The per-axis knot-derivative solve of ``bicubic._solve_axis0`` by
    each route: the assembly and K4, and ``cubic._dense_k``."""
    from ndarray_interp_tpu_torch.models.strategies.cubic import (
        _NOT_A_KNOT,
        _assemble_system,
        _dense_k,
    )
    from ndarray_interp_tpu_torch.ops.thomas_kernel import _ThomasKernel

    nak = (_NOT_A_KNOT, 0.0, _NOT_A_KNOT, 0.0)
    return {
        "K4": lambda: (_ThomasKernel.apply(*_assemble_system(x, y, *nak)),),
        "dense": lambda: (_dense_k(x, y, _NOT_A_KNOT, False),),
    }


def interleaved(routes):
    """Host wall and device busy of each route: walls by ``wall_ms`` in turns,
    the routes in order and then reversed (A B C C B A), pooled as median of
    the two medians, the least min and the largest max; busy from a
    ``torch.profiler`` trace of 3 calls."""
    walls = {name: [] for name in routes}
    for order in (list(routes), list(routes)[::-1]):
        for name in order:
            walls[name].append(wall_ms(routes[name], 1))
    out = {}
    for name, runs in walls.items():
        wall = (float(np.median([r[0] for r in runs])), min(r[1] for r in runs),
                max(r[2] for r in runs))
        out[name] = {"wall": wall, "busy": busy_ms(routes[name], 3)[0]}
    return out


def route_taken(n, bank, y):
    """The route the port's build takes for this shape."""
    from ndarray_interp_tpu_torch.models.strategies.cubic import _dense_build_ok

    return "dense" if _dense_build_ok(n, bank, y, "not_a_knot") else "K4"


def build_route_phase(dev, card, rng):
    """Time K4 plus the assembly, PCR and the dense build at ``BUILD_SHAPES``
    and the two per-axis solves at ``AXIS_SHAPES`` (host wall in turns and
    device busy, ``interleaved``), hold PCR's and the dense build's ``a, b``
    to K4's, check that TF32 enabled process-wide leaves the dense product's
    bits alone, time the public ``CubicSpline`` build at each of
    ``BUILD_SHAPES`` with the dense route forced on and forced off, in turns,
    and the whole builds of NS3b's ``Bicubic`` and ND2's 64^3 cubic on the
    route the port takes (K4: their per-axis solves).  Every bank and axis is
    float32."""
    import torch

    from ndarray_interp_tpu_torch import config
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu_torch.interpnd import InterpND
    from ndarray_interp_tpu_torch.models.strategies import cubic

    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    saved = config.dense_build_max_n, cubic._DENSE_MIN_ELEMS

    def forced(max_n, min_elems, fn):
        """``fn`` with the dense route's bounds set, then put back."""
        def call():
            config.dense_build_max_n, cubic._DENSE_MIN_ELEMS = max_n, min_elems
            try:
                return fn()
            finally:
                config.dense_build_max_n, cubic._DENSE_MIN_ELEMS = saved
        return call

    print(f"build routes, f32 not-a-knot banks: host wall ms (median [min, max], {RUNS} runs a "
          f"turn, the routes in turns A B C C B A) and device busy ms (profiler); card: {card}",
          flush=True)
    rows = {}
    shapes = [(label, n, bank, build_routes) for label, n, bank in BUILD_SHAPES]
    shapes += [(label, n, bank, axis_routes) for label, n, bank in AXIS_SHAPES]
    for label, n, bank, make in shapes:
        x = T(make_knots(n, "nonuniform", np.float32, rng))
        y = T(rng.standard_normal((n, bank), dtype=np.float32))
        routes = make(x, y)
        ref = routes["K4"]()
        scale = float(ref[0].abs().max())
        for name, fn in routes.items():
            if name != "K4":
                err = max(float((g - r).abs().max()) for g, r in zip(fn(), ref)) / scale
                ok = err <= ROUTE_TOL[name]
                print(f"  {label} ({n:,} x {bank:,}) {name}: within {err:.2e} of K4's (scaled; "
                      f"tolerance {ROUTE_TOL[name]:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"build route {name} at {n} x {bank}: {err:.2e} from K4's")
        del ref
        times = interleaved(routes)
        for name, t in times.items():
            print(f"  {label} ({n:,} x {bank:,}) {name}: host wall {fmt(t['wall'])}, busy "
                  f"{t['busy']:.4f}", flush=True)
        rows[label] = {"n": n, "bank": bank, **times}
        if make is build_routes:
            # the public build, the dense route forced off and on, in turns
            build = lambda: Interp1D.builder(y).x(x).strategy(CubicSpline()).build()  # noqa: E731
            whole = interleaved({"K4": forced(0, saved[1], build),
                                 "dense": forced(1 << 30, 0, build)})
            for name, t in whole.items():
                print(f"  {label} ({n:,} x {bank:,}) whole CubicSpline build, {name}: host wall "
                      f"{fmt(t['wall'])}, busy {t['busy']:.4f}", flush=True)
            rows[label]["whole"] = whole
            rows[label]["taken"] = route_taken(n, bank, y)
            print(f"  {label} ({n:,} x {bank:,}): the port's build takes {rows[label]['taken']}",
                  flush=True)
        if label == "NS5b":
            tf32_check(routes["dense"])
        del x, y, routes
        torch.cuda.empty_cache()

    # the whole builds at NS3b (512 x 512 x 16 f32 Bicubic) and ND2 (64^3 f32 cubic)
    x2 = T(make_knots(GRID2D[0], "nonuniform", np.float32, rng))
    y2 = T(make_knots(GRID2D[1], "nonuniform", np.float32, rng))
    z2 = T(rng.standard_normal(GRID2D, dtype=np.float32))
    axes = [T(np.linspace(0.0, 1.0, n, dtype=np.float32)) for n in GRIDND]
    g3 = T(rng.standard_normal(GRIDND, dtype=np.float32))
    for label, fn in (
        ("NS3b Bicubic build", lambda: Interp2D.builder(z2).x(x2).y(y2).strategy(Bicubic())
         .build()),
        ("ND2 cubic build", lambda: InterpND.builder(g3).points(*axes).method("cubic").build()),
    ):
        times = interleaved({"the port's route (K4)": fn})
        for route, t in times.items():
            print(f"  {label}, {route}: host wall {fmt(t['wall'])}, busy {t['busy']:.4f}",
                  flush=True)
        rows[label] = times
    return rows


def tf32_check(dense):
    """The dense product's bits with TF32 enabled process-wide
    (``torch.set_float32_matmul_precision("high")``) against the default."""
    import torch

    before = torch.get_float32_matmul_precision()
    a0, b0 = dense()
    torch.set_float32_matmul_precision("high")
    try:
        a1, b1 = dense()
    finally:
        torch.set_float32_matmul_precision(before)
    same = torch.equal(a0, a1) and torch.equal(b0, b1)
    print(f"  dense build with TF32 enabled process-wide: {'the same bits' if same else 'DIFFERS'}",
          flush=True)
    if not same:
        fail("the dense build's product changed with TF32 enabled")


def per_call(loop, calls):
    """``wall_ms`` of a loop of ``calls`` calls, per call."""
    return tuple(t / calls for t in wall_ms(loop, 1))


def native_phase(dev, card, rng):
    """The native host runtime: ``interp_scalar`` of a 1-D f64 cubic (NS1's
    2,048 knots) and of a 512 x 512 f64 ``Bicubic``, both built on the card
    from numpy inputs, with ``config.use_native_host`` on (the host) and off
    (the card): host wall per call, the two routes' values against each
    other, and no CUDA launch on the native route (launch counts and a
    profiler trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ndarray_interp_tpu_torch import config, native
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D

    print(f"native host runtime: HAVE_NATIVE = {native.HAVE_NATIVE} (the library built into "
          f"ndarray_interp_tpu_torch/_build/ from native/src/ndi_native.cpp)", flush=True)
    if not native.HAVE_NATIVE:
        fail("the native host runtime is not built (HAVE_NATIVE is false)")
        return {}
    drive, launched = counted_calls()
    kn = np.sort(rng.uniform(0.0, 100.0, 2048))
    v = rng.normal(size=2048)
    x2 = make_knots(512, "nonuniform", np.float64, rng)
    y2 = make_knots(512, "nonuniform", np.float64, rng)
    z2 = rng.normal(size=(512, 512))
    q1 = rng.uniform(kn[0], kn[-1], NATIVE_CALLS).tolist()
    q2 = list(zip(rng.uniform(x2[0], x2[-1], NATIVE_CALLS).tolist(),
                  rng.uniform(y2[0], y2[-1], NATIVE_CALLS).tolist()))
    # the tolerances of tests/test_native.py: the Hermite form 1e-13 relative
    # (here 1e-12 of the scale), the bicubic node form 1e-10
    cases = {
        "1-D f64 CubicSpline, 2,048 knots": (
            lambda: Interp1D.builder(v, device=dev).x(kn)
            .strategy(CubicSpline().extrapolate(True)).build(),
            lambda itp, q: itp.interp_scalar(q), q1, 1e-12),
        "2-D f64 Bicubic, 512 x 512": (
            lambda: Interp2D.builder(z2, device=dev).x(x2).y(y2).strategy(Bicubic()).build(),
            lambda itp, q: itp.interp_scalar(*q), q2, 1e-10),
    }
    out = {}
    saved = config.use_native_host
    for label, (make, call, qs, tol) in cases.items():
        itp_host = make()
        config.use_native_host = False
        try:
            itp_card = make()
            card_vals = [float(call(itp_card, q)) for q in qs[:CARD_CALLS]]  # read at first use
        finally:
            config.use_native_host = saved
        host_vals = drive(f"{label}, native interp_scalar x {NATIVE_CALLS:,}", (),
                          lambda: [call(itp_host, q) for q in qs])
        if not all(isinstance(h, float) for h in host_vals):
            fail(f"{label}: the native route did not serve interp_scalar")
        if any(launched.values()):
            fail(f"{label}: the native route launched {launched}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for q in qs[:CARD_CALLS]:
                call(itp_host, q)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        print(f"  {label}: CUDA kernels in a profiler trace of {CARD_CALLS} native calls: "
              f"{kernels}", flush=True)
        if kernels:
            fail(f"{label}: the native route launched {kernels} CUDA kernels")
        h = np.array(host_vals[:CARD_CALLS])
        c = np.array(card_vals)
        err = float(np.max(np.abs(h - c)) / np.max(np.abs(c)))
        ok = err <= tol
        print(f"  {label}: native against the card on {CARD_CALLS} queries: scaled max "
              f"difference {err:.2e} (tolerance {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{label}: native and card interp_scalar differ by {err:.2e}")
        host_t = per_call(lambda: [call(itp_host, q) for q in qs], len(qs))
        card_t = per_call(lambda: [float(call(itp_card, q)) for q in qs[:CARD_CALLS]],
                          CARD_CALLS)
        print(f"  {label}: interp_scalar host wall per call, ms: native {fmt(host_t)}, on the "
              f"card (use_native_host off) {fmt(card_t)}; card: {card}", flush=True)
        out[label] = {"native_ms": host_t[0], "card_ms": card_t[0], "max_scaled_diff": err}
    return out


def eval_checked_phase(dev, card, rng):
    """``Interp1D.eval_checked`` inside a captured CUDA graph on NS1's
    knots and data (2,048 f32, not-a-knot, without extrapolation, so the
    range check applies) at 1,000,000 queries: one replay on a batch in range
    and one with a query out of range; ``.throw()`` must raise for the
    second only, and the values must equal ``eval_unchecked``'s bit for
    bit."""
    import torch

    from ndarray_interp_tpu_torch import OutOfBoundsError
    from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D

    drive, total = counted_calls()
    kn = np.linspace(0.0, 100.0, 2048).astype(np.float32)
    itp = Interp1D.builder(rng.normal(size=2048).astype(np.float32), device=dev).x(kn) \
        .strategy(CubicSpline()).build()
    inside = torch.as_tensor(rng.uniform(0.0, 100.0, 1_000_000).astype(np.float32), device=dev)
    outside = inside.clone()
    outside[123_456] = 100.5
    static = inside.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            itp.eval_checked(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph):
            return itp.eval_checked(static)

    err, vals = drive("eval_checked captured in a CUDA graph (NS1 f32, 1M queries)", ("K1",),
                      capture)
    out = {}
    for label, batch, raises in (("in range", inside, False), ("one query out of range",
                                                                 outside, True)):
        static.copy_(batch)
        graph.replay()
        torch.cuda.synchronize()
        try:
            err.throw()
            raised = False
        except OutOfBoundsError as e:
            raised = True
            print(f"  replay, {label}: throw() raised OutOfBoundsError: {e}")
        same, diff = bit_compare(vals, itp.eval_unchecked(batch))
        ok = raised == raises and same
        print(f"  replay, {label}: raised {raised} (expected {raises}), values bit for bit "
              f"eval_unchecked's: {same} (max abs err {diff}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"eval_checked under graph capture, {label}: raised {raised}, values equal {same}")
    replay_t = device_ms(graph.replay, 1)
    plain_t = device_ms(lambda: itp.eval_unchecked(static), 1)
    print(f"  eval_checked graph replay {fmt(replay_t)} ms against eval_unchecked {fmt(plain_t)} "
          f"(device, CUDA events); card: {card}", flush=True)
    out["replay_ms"], out["eval_unchecked_ms"] = replay_t[0], plain_t[0]
    return out, total


def ord_times(times):
    """ORD's entry of the kernels line: its times at K8's shape, the DF bank
    serving's (the most launches), and at every shape beside them."""
    shapes = {label: {key: times[kid][f"order_{key}"]
                      for key in ("ms", "first_ms", "plain_ms", "bound_ms", "library_ms", "form")}
              for label, kid in ORD_SHAPES}
    head = shapes[ORD_SHAPES[0][0]]
    return {"ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": head["library_ms"],
            "first_design_ms": head["first_ms"], "shapes": shapes}


def main():
    import argparse

    ap = argparse.ArgumentParser(description="On-card check of the PyTorch port.")
    ap.add_argument("--sweeps", action="store_true",
                    help="also run the design sweeps behind K3's, K1's, R1's, K2's, R3's, "
                         "R3idx's and K6's tree budgets, R2a's body, the ordered branches' "
                         "crossovers and ORD's forms")
    sweeps = ap.parse_args().sweeps
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU")
    import_port()
    from ndarray_interp_tpu_torch.ops import _cuda, kernel_wrappers

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    print(f"kernel build (nvcc, sources in ndarray_interp_tpu_torch/csrc): "
          f"{time.perf_counter() - t0:.2f} s -> {path.name}", flush=True)
    entry = "?"  # the (mangled) kernel each register and spill line is about
    for line in path.with_suffix(".so.log").read_text().splitlines():
        if "Function properties for" in line:
            entry = line.split("Function properties for", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {entry}: {line.strip()}")

    def elapsed(what):
        print(f"[{time.perf_counter() - t0:.0f} s since the build started: {what} done]",
              flush=True)

    rec = Record()
    kernel_phases(dev, rec)
    df_kernel_phases(dev, rec)
    df2d_kernel_phases(dev, rec)
    tail2d_kernel_phases(dev, rec)
    dfnd_kernel_phases(dev, rec)
    bank_big_kernel_phases(dev, rec)
    torch.cuda.synchronize()
    elapsed("kernel phases")

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    print("main path (public API, device='cuda'):", flush=True)
    state = main_path(dev, np.random.default_rng(42))
    torch.cuda.synchronize()
    main_launches = {kid: w.launches for kid, w in wrappers.items()}
    print(f"  launches during the main path: {main_launches}")
    for kid in ("K1", "K2", "K3", "K4", "R2a"):
        if main_launches[kid] <= 0:
            fail(f"{kid} was not launched by the main path")

    print("serving path (public API, device='cuda'; counts set to 0 before each call):",
          flush=True)
    serving, served = serving_path(dev, state, np.random.default_rng(43))
    print(f"  launches during the serving path: {served}")

    print(f"2-D path, {'x'.join(map(str, GRID2D))} at {NQ2D:,} queries (public API, "
          "device='cuda'; counts set to 0 before each call):", flush=True)
    state2d, launched2d = path2d(dev, np.random.default_rng(44))
    print(f"  launches during the 2-D path: {launched2d}")
    for kid in ("R1", "R2g", "R2n", "K4", "K7", "K10", "K11", "K12", "K13", "ORD:K12",
                "ORD:K13", "ORD:R2n"):
        if launched2d[kid] <= 0:
            fail(f"{kid} was not launched by the 2-D path")
    elapsed("1-D, serving and 2-D paths")

    print("N-D path (ND1-ND3b at 64^3 and 256^3) and NS3e at 1,000,000 queries (public API, "
          "device='cuda'; counts set to 0 before each call):", flush=True)
    state_nd, launched_nd = nd_path(dev, np.random.default_rng(47))
    print(f"  launches during the N-D path: {launched_nd}")
    for kid in ("K2", "K4", "K7", "K14", "K15", "K15f48", "ORD"):
        if launched_nd[kid] <= 0:
            fail(f"{kid} was not launched by the N-D path")
    elapsed("N-D path")

    print(f"wide-bank and long-axis path (NS5, NS5b, NS2b, NS1b, NS4; public API, "
          "device='cuda'; counts set to 0 before each call):", flush=True)
    state_big, launched_big = bank_big_path(dev, np.random.default_rng(48))
    print(f"  launches during the wide-bank and long-axis path: {launched_big}")
    for kid in ("K1", "K2", "K4", "K5", "R2a", "R3", "R3idx"):
        if launched_big[kid] <= 0:
            fail(f"{kid} was not launched by the wide-bank and long-axis path")
    elapsed("wide-bank and long-axis path")

    print(f"NS3d double-float bicubic tails (gathered_bicubic_eval_df_packed, each tail; counts "
          "set to 0 before each call):", flush=True)
    tails_args, launched_tails = tails_path(state2d)
    for kid in ("K7", "K12", "R4c", "ORD"):
        if launched_tails[kid] <= 0:
            fail(f"{kid} was not launched by the NS3d tails path")
    print("step family (Nearest, the custom StepInterpolator, Nearest2D; public API, "
          "device='cuda'; counts set to 0 before each call):", flush=True)
    steps, launched_steps = step_path(dev, state2d, np.random.default_rng(49))
    print(f"  launches during the step path: {launched_steps}")
    print("calculus (1-D and 2-D derivative, integrate, solve; public API, device='cuda'; "
          "counts set to 0 before each call):", flush=True)
    calc, launched_calc = calculus_path(dev, state, state2d, np.random.default_rng(50))
    print(f"  launches during the calculus path: {launched_calc}")
    print("N-D calculus and checkpoints (InterpND derivative and integrate at 64^3 and 1,000,000 "
          "queries; save and load on the card; public API, device='cuda'; counts set to 0 "
          "before each call):", flush=True)
    calc_nd, launched_calc_nd = calculus_nd_path(dev, state, state2d, np.random.default_rng(51))
    print(f"  launches during the N-D calculus and checkpoint path: {launched_calc_nd}")
    for kid in ("K2", "K4"):
        if launched_calc_nd[kid] <= 0:
            fail(f"{kid} was not launched by the N-D calculus and checkpoint path")
    print("the single-device remainder: build routes, the native host runtime, eval_checked "
          "(counts set to 0 before each driven call):", flush=True)
    routes = build_route_phase(dev, card, np.random.default_rng(52))
    native_walls = native_phase(dev, card, np.random.default_rng(53))
    checked, launched_checked = eval_checked_phase(dev, card, np.random.default_rng(54))
    print(f"  launches during eval_checked's capture: "
          f"{({k: c for k, c in launched_checked.items() if c})}")
    print("  single-device remainder record: " + json.dumps(
        {"build_routes": routes, "native": native_walls, "eval_checked": checked}), flush=True)
    # every kernel's launches summed over every path, and the orderings of
    # each tail that orders its batch (the main path orders none)
    paths = (served, launched2d, launched_nd, launched_big, launched_tails, launched_steps,
             launched_calc, launched_calc_nd, launched_checked)
    launches = {kid: main_launches[kid] + sum(path[kid] for path in paths) for kid in wrappers}
    order_launches = {kid: sum(path[f"ORD:{kid}"] for path in paths) for kid in ORDERED_TAILS}
    print(f"  launches over every path (main + serving + 2-D + N-D + wide-bank + tails + step "
          f"+ calculus + N-D calculus + eval_checked): {launches}; orderings by tail: "
          f"{order_launches}")
    for kid, total in launches.items():
        parts = " + ".join(str(n) for n in (main_launches[kid], *(path[kid] for path in paths)))
        print(f"  {kid} launches over every path: {total} = {parts}")
    for kid in ("K2", "K3", "K4"):
        if launched_calc[kid] <= 0:
            fail(f"{kid} was not launched by the calculus path")
    elapsed("tails, step, calculus and N-D calculus paths")

    times = timing(state, card, rec, sweeps)
    times.update(df_timing(serving, card, rec, sweeps))
    times.update(timing2d(state2d, card, rec, sweeps))
    times.update(timing_nd(state_nd, card, rec, sweeps))
    del state_nd
    itp10, _, _, q10 = state["bank"]
    times.update(timing_big(state_big, (itp10, q10), card, rec, sweeps))
    del state_big
    times.update(timing_tails_step_calculus(tails_args, steps, calc, state2d, card, rec, sweeps))
    timing_calculus_nd(calc_nd, card)
    del calc_nd
    times["ORD"] = ord_times(times)
    torch.cuda.synchronize()
    elapsed("timing")

    if failures:
        print(f"chip_smoke: {len(failures)} failure(s):", *failures, sep="\n  ")
        raise SystemExit(1)

    kernels = [
        {
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kid],
            "max_abs_err": rec.err[kid],
            **times[kid],
            # K8, K9, K12, K13 and K14: the launches of their ordering on the paths
            **({"order_launches": order_launches[kid],
                "order_source": "ndarray_interp_tpu_torch/csrc/cell_order.cu"}
               if kid in order_launches else {}),
        }
        for kid, (name, source, replaces) in KERNELS.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
