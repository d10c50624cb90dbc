"""Build, load and launch the hand-written CUDA kernels in ``../csrc``.

The kernels are compiled with ``nvcc`` into one shared library with a plain
``extern "C"`` interface and loaded with ``ctypes``; no PyTorch header is
compiled, so a build takes seconds: one ``nvcc -c`` a source, all started
together, then one link.  The build happens at first use, never
at import, into ``ndarray_interp_tpu_torch/_build/``, keyed by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded again.  A failed build raises.

``--fmad=false`` turns off multiply-add contraction: every kernel then rounds
each operation exactly as the plain PyTorch versions do, which is what makes
the bit-for-bit comparisons between kernel and plain version possible.
``--use_fast_math`` is never used, for the same reason.

Every C function launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas=-v",  # registers and spills per kernel, kept in the build log
    "-Xcompiler", "-fPIC",
)
NVCC_FLAGS = COMPILE_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_BOTH = tuple(_SUFFIX)
_PAIRS = (torch.float32,)  # the double-float kernels take (hi, lo) float32 pairs
# packed, rows, ch, bp, xi, yi, ny - 1, tx_hi, tx_lo, ty_hi, ty_lo, out_hi, out_lo, nq
_CELL_TAIL = ((_P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P), _PAIRS)
#: the most axes K15 takes: its strides and bases live in registers
MAX_ND_AXES = 6


class NdStrides(ctypes.Structure):
    """K15's cell strides, passed by value (``struct NdStrides`` in
    ``csrc/df_nd_kernels.cu``)."""

    _fields_ = [("s", ctypes.c_int64 * MAX_ND_AXES)]


# packed, rows, ch, bp, k, nbasis, idx (k, nq), strides, t_hi, t_lo (k, nq),
# out_hi, out_lo, nq
_ND_TAIL = ((_P, _I, _I, _I, _I, _I, _P, NdStrides, _P, _P, _P, _P, _I, _P), _PAIRS)
# tbl, rows, ch, r, cell, qx | tx, qy | ty, out, nq
_CELL_TAIL_F = ((_P, _I, _I, _I, _P, _P, _P, _P, _I, _P), _BOTH)
# tbl, rows, ch, r, records, out, nq
_CELL_TAIL_ORDERED = ((_P, _I, _I, _I, _P, _P, _I, _P), _BOTH)
# argument types of each entry point, stream last, and the dtypes it has a
# symbol for: <name>_f32, <name>_f64
_SIGNATURES = {
    # knots, n, tbl, ch, shared_knots, row_read, q, out, nq
    "ndi_eval1d": ((_P, _I, _P, _I, _I, _I, _P, _P, _I, _P), _BOTH),
    # knots, n, shared_knots, q, idx, t, nq
    "ndi_index_frac": ((_P, _I, _I, _P, _P, _P, _I, _P), _BOTH),
    # knots, n, shared_knots, q, idx, nq
    "ndi_lower_index": ((_P, _I, _I, _P, _P, _I, _P), _BOTH),
    "ndi_thomas": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _P), _BOTH),
    # data, a, b, rows, bank, idx, t, out, nq, w, lanes, chunk
    "ndi_banked_eval": ((_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P), _BOTH),
    # packed, rows, ch, bp, bank, idx, t, out, nq
    "ndi_bank_tail": ((_P, _I, _I, _I, _I, _P, _P, _P, _I, _P), _BOTH),
    # knots, n, data, a, b, shared_knots, q, out, nq
    "ndi_big_eval": ((_P, _I, _P, _P, _P, _I, _P, _P, _I, _P), _BOTH),
    # knots, n, shared_knots, q, idx, t, nq
    "ndi_big_index_frac": ((_P, _I, _I, _P, _P, _P, _I, _P), _BOTH),
    # x, nx, y, ny, shared_knots (each axis), qx, qy, cell, tx, ty, nq
    "ndi_cell_index": ((_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P), _BOTH),
    "ndi_bilinear_tail": _CELL_TAIL_F,
    "ndi_bicubic_seq_tail": _CELL_TAIL_F,
    "ndi_bicubic_tree_tail": _CELL_TAIL_F,
    "ndi_bicubic_nested_tail": _CELL_TAIL_F,
    # data, x, y, nx, ny, r, cell, qx, qy, out, nq
    "ndi_bilinear_grid_tail": ((_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P), _BOTH),
    "ndi_bicubic_seq_tail_ordered": _CELL_TAIL_ORDERED,
    "ndi_bicubic_tree_tail_ordered": _CELL_TAIL_ORDERED,
    "ndi_bicubic_nested_tail_ordered": _CELL_TAIL_ORDERED,
    # xh, xl, n, dh, dl, ah, al, bh, bl, shared_knots, qh, ql, out_hi, out_lo
    # (null: out_hi float64, the store form of csrc/df_common.cuh), nq
    "ndi_df_eval1d": ((_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P),
                      _PAIRS),
    # xh, xl, n, shared_knots, qh, ql, idx, t_hi, t_lo, nq
    "ndi_df_index_frac": ((_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P), _PAIRS),
    # packed, rows, ch, bp, bank, idx, t_hi, t_lo, out_hi, out_lo (null: out_hi
    # float64, the store form of csrc/df_common.cuh), nq
    "ndi_df_bank_tail": ((_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P), _PAIRS),
    "ndi_f48_bank_tail": ((_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P), _PAIRS),
    "ndi_df_bilinear_tail": _CELL_TAIL,
    "ndi_f48_bilinear_tail": _CELL_TAIL,
    "ndi_df_bicubic_tail": _CELL_TAIL,
    "ndi_df_bicubic_weight_tail": _CELL_TAIL,
    "ndi_f48_bicubic_tail": _CELL_TAIL,
    # packed, rows, ch, r, xi, yi, ny, tx_hi, tx_lo, ty_hi, ty_lo, out_hi, out_lo, nq
    "ndi_df_bicubic_node_tail": _CELL_TAIL,
    "ndi_df_nd_tail": _ND_TAIL,
    "ndi_f48_nd_tail": _ND_TAIL,
    # packed, rows, ch, bp | r, ny, records, out_hi, out_lo, nq
    "ndi_df_bicubic_tail_ordered": ((_P, _I, _I, _I, _I, _P, _P, _P, _I, _P), _PAIRS),
    "ndi_f48_bicubic_tail_ordered": ((_P, _I, _I, _I, _I, _P, _P, _P, _I, _P), _PAIRS),
    "ndi_df_bicubic_weight_tail_ordered": ((_P, _I, _I, _I, _I, _P, _P, _P, _I, _P), _PAIRS),
    # packed, rows, ch, bp, bank, records, out_hi, out_lo, nq
    "ndi_df_bank_tail_ordered": ((_P, _I, _I, _I, _I, _P, _P, _P, _I, _P), _PAIRS),
    "ndi_f48_bank_tail_ordered": ((_P, _I, _I, _I, _I, _P, _P, _P, _I, _P), _PAIRS),
    "ndi_df_bicubic_node_tail_ordered": ((_P, _I, _I, _I, _I, _P, _P, _P, _I, _P), _PAIRS),
    # xi, yi, row_step, lo, rows, shift, tx_hi, tx_lo, ty_hi, ty_lo, work,
    # blocks, form, records, nq (f64: the flat-cell form's tx, None, ty, None)
    "ndi_cell_order": ((_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P),
                       _BOTH),
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built"
    )


def library_path() -> Path:
    return BUILD_DIR / f"libndi_kernels_{_digest()}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact build exists; return its path.

    Each source is compiled by its own ``nvcc -c``, all at once, and the
    objects are linked into the library.  The compilers' output (with
    ``-Xptxas=-v``: registers and spills of every kernel) is kept beside the
    library as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        obj, log = BUILD_DIR / f"{tag}.{src.stem}.o", BUILD_DIR / f"{tag}.{src.stem}.log"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as f:
            jobs.append((cmd, obj, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for cmd, _, log, proc in jobs:
        rc = proc.wait()
        logs.append(log.read_text())
        log.unlink()
        if rc != 0:
            failed.append(f"exit code {rc}:\n{' '.join(cmd)}\n{logs[-1]}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"exit code {res.returncode}:\n{' '.join(cmd)}\n{logs[-1]}")
    for _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed with " + "\n".join(failed))
    out.with_suffix(".so.log").write_text("".join(logs))
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, dtypes) in _SIGNATURES.items():
                for dtype in dtypes:
                    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
            lib.ndi_error_string.argtypes = [ctypes.c_int]
            lib.ndi_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def kernel_device(name, t):
    """Where a wrapper runs for the tensor ``t``: ``"cpu"`` (the plain
    version) or ``"cuda"`` (the kernel).  Any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return kind


def float_operands(name, *tensors):
    """Check that a kernel takes these tensors: one CUDA device, one float
    dtype (float32 or float64).  Returns the dtype."""
    dtype = tensors[0].dtype
    if dtype not in _SUFFIX:
        raise TypeError(
            f"{name}: no CUDA kernel for dtype {dtype}; "
            "the kernels take torch.float32 and torch.float64"
        )
    device = tensors[0].device
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
    return dtype


def pair_operands(name, *tensors):
    """Check that a double-float kernel takes these tensors: float32
    ``(hi, lo)`` halves on one CUDA device."""
    dtype = float_operands(name, *tensors)
    if dtype != torch.float32:
        raise TypeError(
            f"{name}: the double-float kernels take (hi, lo) pairs of "
            f"torch.float32, got {dtype}"
        )


def traced(t) -> bool:
    """Whether the values of ``t`` are not the host's to read: while
    ``torch.compile`` traces (checked first, so that Dynamo never reaches
    the functorch query), or for a tensor under a ``torch.func`` transform
    (``vmap``, ``grad``, ``jacrev``).  The counterpart of the JAX package's
    ``_is_traced``: the eager methods skip their value checks there, as the
    JAX package skips them on tracers, and never synchronise."""
    if torch.compiler.is_compiling():
        return True
    return isinstance(t, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(t)


def run(name, t, launch, plain, *args):
    """The implementation of every kernel op (:func:`kernel_op`), which the
    dispatcher reaches for CPU and CUDA tensors only: ``launch(*args)`` (the
    kernel) when ``t`` is a CUDA tensor, ``plain(*args)`` (its plain
    version) when it is a CPU tensor.  One seam for both devices, so an op's
    batching and differentiation rules are one piece of code on each, and
    the CPU tests run them."""
    if kernel_device(name, t) == "cpu":
        return plain(*args)
    return launch(*args)


#: the namespace of the kernel ops: ``torch.ops.ndarray_interp.<name>``
NAMESPACE = "ndarray_interp"
_LIB = torch.library.Library(NAMESPACE, "DEF")


class KernelOp:
    """A kernel op and the ``autograd.Function`` around it (see
    :func:`kernel_op`); calling it calls the op, or the Function under a
    ``torch.func`` transform."""

    def __init__(self, op, function):
        self.op = op
        self.function = function

    def __call__(self, *args):
        if not torch.compiler.is_compiling() and torch._C._are_functorch_transforms_active():
            return self.function.apply(*args)
        return self.op(*args)


def kernel_op(name, schema, impl, fake, *, setup_context, backward, vmap):
    """Define the operator ``ndarray_interp::<name>`` with ``schema`` (its
    arguments and returns, as ``"(Tensor q, int r) -> Tensor"``): the
    counterpart of a JAX ``custom_vjp`` / ``custom_vmap`` around a Pallas
    call, which ``torch.compile`` traces as one node of its graph and calls
    at run time.

    * ``impl`` runs for CPU and CUDA tensors (:func:`run`: the plain
      version or the launch, which counts it);
    * ``fake`` gives the outputs' shapes and dtypes without running, for
      tracing;
    * ``setup_context`` and ``backward`` (the VJP of the plain version,
      :func:`plain_vjp`) are an ``autograd.Function``'s, whose forward is
      the op below autograd: autograd's C++ ``apply`` of it is the op's
      autograd kernel;
    * ``vmap(op, info, in_dims, *args)`` is the batching rule
      (:func:`vmap_queries`) of both the op and the Function.

    Returns a :class:`KernelOp`.  Under a ``torch.func`` transform it
    applies the Function, whose ``setup_context`` and ``vmap`` let the
    transforms compose (``vmap(grad(...))``, ``jacrev``), which an op's own
    autograd kernel cannot: a transform's layer is already lowered when the
    dispatcher reaches it."""
    qualname = f"{NAMESPACE}::{name}"
    _LIB.define(name + schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, impl, key)
    torch.library.register_fake(qualname, fake, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default

    def rule(info, in_dims, *args):
        return vmap(op, info, in_dims, *args)

    def forward(*args):
        with torch._C._AutoDispatchBelowAutograd():
            return op(*args)

    function = type(f"_{name}", (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context or (lambda ctx, inputs, output: None)),
        "backward": staticmethod(backward),
        "vmap": staticmethod(rule),
    })

    def autograd_kernel(*args):
        if torch.is_grad_enabled() and torch._C._any_requires_grad(*args):
            # autograd's C++ apply, as Function.apply calls it outside a
            # transform, without binding the forward's signature first
            return super(torch.autograd.Function, function).apply(*args)
        return forward(*args)

    _LIB.impl(name, autograd_kernel, "Autograd")
    torch.library.register_vmap(qualname, rule, lib=_LIB)
    return KernelOp(op, function)


def save_inputs(ctx, inputs, output):
    """The ``setup_context`` of an op whose backward reads its inputs."""
    ctx.save_for_backward(*inputs)


def save_inputs_and_index(ctx, inputs, output):
    """The ``setup_context`` of an op whose first output is the index its
    backward holds fixed."""
    ctx.save_for_backward(*inputs, output[0])


def plain_vjp(fn, inputs, needs_grad, g):
    """Gradients of ``fn(*inputs)`` against the cotangent ``g`` for the
    inputs whose ``needs_grad`` is set (``None`` for the others): the
    backward of a kernel op is the VJP of the kernel's plain version.
    ``torch.func.vjp`` takes it, so the backward composes with the
    ``torch.func`` transforms (``vmap(grad(...))``, ``jacrev``) and is
    itself differentiable."""
    wrt = [i for i, w in enumerate(needs_grad) if w]
    if not wrt:
        return (None,) * len(inputs)

    def part(*diff):
        full = list(inputs)
        for i, d in zip(wrt, diff):
            full[i] = d
        return fn(*full)

    _, pullback = torch.func.vjp(part, *(inputs[i] for i in wrt))
    grads = iter(pullback(g))
    return tuple(next(grads) if w else None for w in needs_grad)


def save_operands(ctx, inputs, output):
    """The ``setup_context`` of an op that also takes operands that are not
    tensors (a form's name, sizes, strides): its tensors saved for the
    backward, the others kept on ``ctx`` (:func:`saved_operands`)."""
    ctx.save_for_backward(*(a for a in inputs if isinstance(a, torch.Tensor)))
    ctx.tensor_at = [isinstance(a, torch.Tensor) for a in inputs]
    ctx.operands = [None if t else a for t, a in zip(ctx.tensor_at, inputs)]


def saved_operands(ctx):
    """The inputs of an op that :func:`save_operands` saved, in order."""
    tensors = iter(ctx.saved_tensors)
    return [next(tensors) if t else a for t, a in zip(ctx.tensor_at, ctx.operands)]


def plain_backward(plain):
    """The backward of an op saved by :func:`save_operands`: the VJP
    (:func:`plain_vjp`) of ``plain``, its plain version, in the float
    operands; the index operands are held fixed and get no gradient."""

    def backward(ctx, *grads):
        inputs = saved_operands(ctx)
        need = [w and isinstance(a, torch.Tensor) and a.is_floating_point()
                for w, a in zip(ctx.needs_input_grad, inputs)]
        return plain_vjp(plain, inputs, need, grads[0] if len(grads) == 1 else grads)

    return backward


def _batch_first(outs):
    return tuple(0 for _ in outs) if isinstance(outs, tuple) else 0


def vmap_queries(op, plain, info, in_dims, args, queries):
    """The batching rule of a kernel op elementwise in its query
    operands, the positions ``queries`` of ``args`` (every other tensor is a
    table; each query operand of one shape).  With only queries batched they
    flatten into the kernel's query axis, an unbatched one broadcast first,
    ``op`` launches once, and its outputs take the batch back as their dim
    0.  With a table batched the plain version runs under ``torch.func.vmap``
    (the JAX package's ``custom_vmap`` rule, ``ops/partition.py:97-104``:
    there is no kernel for a batch of tables).  Returns ``(outputs,
    out_dims)``, as ``torch.library.register_vmap`` takes them."""
    if any(d is not None for i, d in enumerate(in_dims) if i not in queries):
        outs = torch.func.vmap(plain, in_dims=tuple(in_dims), randomness=info.randomness)(*args)
        return outs, _batch_first(outs)
    size = info.batch_size
    args = list(args)
    moved = {i: args[i].movedim(in_dims[i], 0) for i in queries if in_dims[i] is not None}
    shape = next(iter(moved.values())).shape[1:]
    for i in queries:
        q = moved[i] if i in moved else args[i].expand((size,) + tuple(args[i].shape))
        args[i] = q.reshape(-1)
    outs = op(*args)

    def back(o):
        return o.reshape((size,) + tuple(shape) + tuple(o.shape[1:]))

    outs = tuple(back(o) for o in outs) if isinstance(outs, tuple) else back(outs)
    return outs, _batch_first(outs)


def query_rule(plain, queries):
    """The ``vmap`` argument of :func:`kernel_op` for an op elementwise in
    its operands at the positions ``queries``: :func:`vmap_queries`."""
    return lambda op, info, in_dims, *args: vmap_queries(op, plain, info, in_dims, args, queries)


def launch(name, dtype, device, *args):
    """Call ``<name>_<f32|f64>`` on ``device``'s current stream; tensors in
    ``args`` are passed as device pointers.  Raises if the launch failed."""
    fn = getattr(library(), f"{name}_{_SUFFIX[dtype]}")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*ptrs, stream)
    if rc != 0:
        msg = library().ndi_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
