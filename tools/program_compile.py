"""First-call seconds and device time of ``InterpND``'s compiled programs
with inductor's pointwise autotuning on (its default) or off, on one card.

Builds ND2's 64^3 cubic grid in float32 on the cell and node layouts
(``chip_smoke.GRIDND``, 1,000,000 queries) and times the first plain call of
``itp(*qs)`` on the cell layout (``_eval_flat_masked``) and of
``derivative(orders=(1, 0, 0))`` on the node layout (``_eval_flat_deriv``,
the largest program), each compiling its program, then both calls' device
ms by CUDA events.  Each run starts from an empty inductor and Triton cache
of its own, so compare runs made in one command, alternating the setting:

    for a in on off off on; do python3 tools/program_compile.py --autotune $a; done

Needs one CUDA card; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--autotune", choices=("on", "off"), default="on",
                    help="inductor's triton.autotune_pointwise")
    args = ap.parse_args()
    cache = HERE / "ndarray_interp_tpu_torch" / "_build" / f"program_compile_{os.getpid()}"
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    cs.compile_env()
    import torch
    import torch._inductor.config

    if not torch.cuda.is_available():
        sys.exit("program_compile: no CUDA card")
    cs.import_port()
    from ndarray_interp_tpu_torch.interpnd import InterpND
    from ndarray_interp_tpu_torch.ops import _cuda

    torch._inductor.config.triton.autotune_pointwise = args.autotune == "on"
    dev = torch.device("cuda", 0)
    _cuda.library()
    rng = np.random.default_rng(47)
    axes = [torch.linspace(0.0, 1.0, n, device=dev) for n in cs.GRIDND]
    data = torch.as_tensor(rng.normal(size=cs.GRIDND), dtype=torch.float32, device=dev)
    qs = [torch.as_tensor(rng.uniform(0.0, 1.0, cs.NQND), dtype=torch.float32, device=dev)
          for _ in cs.GRIDND]
    cell = InterpND.builder(data).points(*axes).method("cubic").build()
    node = InterpND.builder(data).points(*axes).method("cubic").layout("node").build()
    calls = {"cell itp(*qs)": lambda: cell(*qs),
             "node derivative(orders=(1, 0, 0))": lambda: node.derivative(*qs, orders=(1, 0, 0))}
    rec = {"autotune_pointwise": args.autotune,
           "compile_threads": os.environ["TORCHINDUCTOR_COMPILE_THREADS"], "card": cs.card_line()}
    for label, fn in calls.items():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rec[label] = {"first_call_s": time.perf_counter() - t0,
                      "device_ms": cs.device_ms(fn, cs.COMPILE_CALLS)[0]}
    cs.stop_compile_workers()
    shutil.rmtree(cache, ignore_errors=True)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
