"""ORD's phases at the three shapes its paths give it, by kernel.

ORD (``ops/cell_order.py``, ``csrc/cell_order.cu``) orders a batch ahead of
the f64-grade tails: by interval for K8 and K9 (2^20 queries over the 10,239
intervals of the DF bank serving's 10,240-knot axis), by cell for K12 and
K13 (1,000,000 queries over NS3d's 511 x 511 = 261,121 cells) and by base
node for K14 (1,000,000 queries over NS3e's 1024 x 1024 = 1,048,576 nodes).
For each shape this times one ``order_by_cell`` call by CUDA events (the
queue held full) and lists its kernels' device time from a
``torch.profiler`` trace (the memset of the counts, the count, the scans,
the scatter), beside ``torch.argsort`` of the same bucket keys.  Indices
are uniform over the table, as K7 gives them for uniform queries; fraction
halves are random floats.

    python3 tools/cell_order_phases.py [--root DIR] [--design]

``--root`` is a checkout whose ``ndarray_interp_tpu_torch`` is imported
(default: the one holding this script), so two commits can be compared on
one card in one call.  ``--design`` adds the sweeps behind ORD's design:
each form (``cell_order.GLOBAL``, the first design, and ``SHARED``) at the
three shapes and on 1,024 to 49,152 buckets, K8 and K9 behind each form,
and R4c at NS3d ordered and in query order, every result checked against
its plain version.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

RUNS, CALLS, HOLD_CYCLES = 7, 20, 100_000_000


def shapes(dev):
    """(label, order_by_cell arguments) of the three path shapes."""
    import torch

    rng = np.random.default_rng(61)

    def ints(hi, n):
        return torch.as_tensor(rng.integers(0, hi, n), dtype=torch.int32, device=dev)

    def halves(n):
        return torch.as_tensor(rng.uniform(-1, 2, n), dtype=torch.float32, device=dev)

    n1, n2 = 1 << 20, 1_000_000
    return [
        ("K8/K9: 2^20 queries over 10,239 intervals (1-D)",
         (ints(10_239, n1), None, 1, 0, 10_239, halves(n1), halves(n1), None, None)),
        ("K12/K13 (NS3d): 1,000,000 queries over 261,121 cells",
         (ints(511, n2), ints(511, n2), 511, 0, 261_121, *(halves(n2) for _ in range(4)))),
        ("K14 (NS3e): 1,000,000 queries over 1,048,576 base nodes",
         (ints(1023, n2), ints(1023, n2), 1024, -1025, 1_048_576,
          *(halves(n2) for _ in range(4)))),
    ]


def device_ms(fn):
    """Median [min, max] device ms a call over RUNS runs of CALLS calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return float(np.median(times)), min(times), max(times)


def kernels_ms(fn):
    """Device ms a call of each kernel ``fn`` launches, from the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):  # the profiler has come back empty before
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if events:
            break
    events.sort(key=lambda e: -e.self_device_time_total)
    return [(e.key, e.count / CALLS, e.self_device_time_total / CALLS / 1e3) for e in events]


def same_bits(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def check_records(co, args, records):
    """What the ordered tails rely on: bucket keys in order, a permutation,
    each record its query's row value and fraction halves, zeros past them."""
    import torch

    xi, yi, row_step, lo, rows, th, tl, uh, ul = args
    nq = xi.shape[0]
    want = co._order_plain(*args)
    v, qid = records[:, 0].long(), records[:, 1].long()
    zero = torch.zeros_like(th)
    halves = torch.stack([th, tl] + ([zero, zero] if uh is None else [uh, ul]), dim=1)
    ok = {
        "keys": torch.equal(co.bucket_keys(v, rows), co.bucket_keys(want[:, 0].long(), rows)),
        "permutation": torch.equal(torch.sort(qid).values, torch.arange(nq, device=xi.device)),
        "values": torch.equal(v, co.row_values(xi, yi, row_step, lo, rows)[qid]),
        "fractions": same_bits(records[:, 2:6], halves[qid]),
        "zeros": not bool(records[:, 6:].any()),
    }
    return [k for k, good in ok.items() if not good]


def design(dev, card):
    """The design sweeps of ORD and R4c, in one run: each form of the
    ordering at the three path shapes and by bucket count, K8 and K9 behind
    each form, and R4c's ordered body at NS3d against its body in query
    order."""
    import torch

    from ndarray_interp_tpu_torch.ops import cell_order as co
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as e1
    from ndarray_interp_tpu_torch.ops import eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops.df import df_from_f64, df_to_f64

    names = {co.SHARED: "shared", co.GLOBAL: "global (the first design)"}
    bad = []

    def forms(label, args):
        nb = co.bucket_count(args[4])
        keys = co.bucket_keys(co.row_values(*args[:5]), args[4])
        argsort = device_ms(lambda: torch.argsort(keys))[0]
        print(f"  {label} ({nb:,} buckets): torch.argsort {argsort:.4f} ms", flush=True)
        for form in (co.GLOBAL, co.SHARED):
            if form == co.SHARED and nb > 49_152:
                continue
            run = lambda: co._order_kernel(args, form)  # noqa: E731
            wrong = check_records(co, args, run())
            t = device_ms(run)
            top = ", ".join(f"{ms:.4f} {name.split('(')[0].split('::')[-1][:28]}"
                            for name, _, ms in kernels_ms(run)[:5])
            print(f"    {names[form]}: {t[0]:.4f} [{t[1]:.4f}, {t[2]:.4f}] ms "
                  f"{'ok' if not wrong else wrong}; kernels: {top}", flush=True)
            if wrong:
                bad.append(f"{label} {names[form]}: {wrong}")

    print(f"ORD by form ({card}):", flush=True)
    for label, args in shapes(dev):
        forms(label, args)

    print("ORD by bucket count, 2^20 1-D queries:", flush=True)
    rng = np.random.default_rng(62)
    n1 = 1 << 20
    th, tl = (torch.as_tensor(rng.uniform(-1, 2, n1), dtype=torch.float32, device=dev)
              for _ in range(2))
    for rows in (1024, 4096, 8192, 16_384, 24_576, 32_768, 49_152):
        xi = torch.as_tensor(rng.integers(0, rows, n1), dtype=torch.int32, device=dev)
        forms(f"{rows:,} intervals", (xi, None, 1, 0, rows, th, tl, None, None))

    print("K8 and K9 (float64 store form, ordered branch) behind each form, 10,240 x 64, "
          "2^20 queries:", flush=True)
    k8 = shapes(dev)[0][1]
    idx, rows, th, tl = k8[0], k8[4], k8[5], k8[6]
    vals = [rng.normal(size=(rows + 1, 64)), rng.normal(size=(rows, 64)),
            rng.normal(size=(rows, 64))]
    pairs = [h for v in vals for h in df_from_f64(torch.as_tensor(v, device=dev))]
    orders, form_of = e1._orders, co._form
    try:
        e1._orders = lambda *_: True
        for kid, pack, tail, plain in (
                ("K8", e1.pack_bank_rows_df, e1._gathered_df_tail_f64, e1._df_tail_plain),
                ("K9", e1.pack_bank_rows_f48, e1._gathered_f48_tail_f64, e1._f48_tail_plain)):
            a = (pack(*pairs), idx, th, tl, 64)
            want = df_to_f64(*plain(*a))
            for form in (co.GLOBAL, co.SHARED):
                co._form = lambda _, form=form: form
                ok = torch.equal(tail(*a), want)
                t = device_ms(lambda: tail(*a))[0]
                print(f"  {kid} behind the {names[form]}: {t:.4f} ms "
                      f"{'bit-identical' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    bad.append(f"{kid} behind {names[form]}")
    finally:
        e1._orders, co._form = orders, form_of

    print("R4c at NS3d (512 x 512 x 16 DF cell table, 1,000,000 queries):", flush=True)
    cells, r = 511 * 511, 16
    packed = e2.pack_bicubic_rows_df(*df_from_f64(torch.as_tensor(
        rng.normal(size=(cells, 16 * r)), device=dev)), r)
    n2 = 1_000_000
    q = [torch.as_tensor(rng.integers(0, 511, n2), dtype=torch.int32, device=dev)
         for _ in range(2)]
    t = [torch.as_tensor(rng.uniform(-0.5, 1.5, n2), dtype=torch.float32, device=dev)
         for _ in range(4)]
    args = (packed, q[0], q[1], 512, *t)
    want = e2._bicubic_df_weight_tail_plain(*args)
    orders = e2._orders
    try:
        for label, ordered in (("query order", False), ("ordered", True)):
            e2._orders = lambda *_, o=ordered: o
            got = e2.gathered_bicubic_df_weight_tail(*args)
            ok = same_bits(got[0], want[0]) and same_bits(got[1], want[1])
            tt = device_ms(lambda: e2.gathered_bicubic_df_weight_tail(*args))[0]
            k12 = device_ms(lambda: e2.gathered_bicubic_df_tail(*args))[0]
            print(f"  R4c {label}: {tt:.4f} ms (ORD included) "
                  f"{'bit-identical' if ok else 'MISMATCH'}; K12 the same way {k12:.4f}",
                  flush=True)
            if not ok:
                bad.append(f"R4c {label}")
    finally:
        e2._orders = orders
    print(f"design run: {'all checks hold' if not bad else bad}", flush=True)
    return not bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--design", action="store_true",
                    help="also run the design sweeps: every form, record width and R4c body")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("cell_order_phases: no CUDA card")
    from ndarray_interp_tpu_torch.ops import cell_order as co

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    print(f"ORD phases, checkout {root}; card: {card}", flush=True)
    dev = torch.device("cuda")
    for label, args in shapes(dev):
        keys = co.bucket_keys(co.row_values(*args[:5]), args[4])
        total = device_ms(lambda: co.order_by_cell(*args))
        argsort = device_ms(lambda: torch.argsort(keys))
        print(f"  {label}: ORD {total[0]:.4f} [{total[1]:.4f}, {total[2]:.4f}] ms a call; "
              f"torch.argsort of the keys {argsort[0]:.4f} ms; by kernel (profiler):",
              flush=True)
        for name, count, ms in kernels_ms(lambda: co.order_by_cell(*args)):
            print(f"      {ms:.4f} ms  {count:g}x {name[:100]}", flush=True)
    if opts.design and not design(dev, card):
        sys.exit(1)


if __name__ == "__main__":
    main()
