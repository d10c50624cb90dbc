"""Build the native host runtime's shared library.

Usage: ``python -m ndarray_interp_tpu_torch.native.build``

The library is plain C++ with an ``extern "C"`` interface, loaded with
ctypes, so the build needs ``g++`` and nothing of Python or PyTorch.  The
flags are the JAX package's (``ndarray_interp_tpu/native/build.py``), so
both libraries give the same bits from the same source.

Several processes may build at once (the workers of a test run all import
the loader): the build holds an ``fcntl`` lock on a file beside the
library, compiles to a temporary name and moves the result into place
with ``os.replace``, so no process ever loads a half-written library.  A
library is rebuilt when the source or the flags change (a stamp beside it
holds their digest).
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src" / "ndi_native.cpp"
BUILD_DIR = HERE.parent / "_build"
LIB_NAME = "libndi_native.so"

FLAGS = (
    "-O3",
    "-march=native",
    "-funroll-loops",
    # no FMA contraction: the results match the plain PyTorch order on the CPU
    # (and the reference's scalar arithmetic) bit for bit
    "-ffp-contract=off",
    "-shared",
    "-fPIC",
    "-std=c++17",
    "-fopenmp",
)


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()


def build(out_dir=BUILD_DIR, verbose: bool = False) -> Path:
    """Compile ``src/ndi_native.cpp`` into ``out_dir/libndi_native.so``
    unless that library is already built from this source and these flags;
    return its path.  Raises if the compiler fails or is missing."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / LIB_NAME
    stamp = out_dir / f"{LIB_NAME}.sha256"
    digest = _digest()
    with open(out_dir / f"{LIB_NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and stamp.exists() and stamp.read_text() == digest:
            return out
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
        if verbose:
            print(" ".join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=not verbose)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        stamp.write_text(digest)
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
