"""The port's bank and query sharding (``parallel/sharding.py``) against the
JAX package's (``tests/test_parallel.py``, case by case), on the CPU.

The same numpy inputs, made from seeds, go through the JAX functions on the
8-device CPU mesh of ``tests/conftest.py`` and through the port.  Bank and
query sharding exchange nothing, so most cases call the port's public
functions once for every mesh coordinate in one process, on ``Coords``: a
stand-in for a ``DeviceMesh`` at one coordinate (the names, shape, device
type and local rank that ``sharding.py`` reads; no process group), and
assemble the blocks.  One 4-rank gloo world, started once a test session,
runs the same entry points on a real ``(query 2, bank 2)`` mesh, the
multichip step (``examples/spline_bank_sharded.py:sgd_step``) and the
example; its outputs must equal the coordinate-wise blocks bit for bit.

Tolerances are the JAX tests' (``atol=1e-14`` in f64; the step's prediction
within 1e-5 of the scale, as ``__graft_entry__.dryrun_multichip``).  Where
the JAX test asks sharded against replicated, the port's sharded blocks must
equal its unsharded result bit for bit.

The kernels' placement rules (``test_parallel.py:130-637``, the Pallas
kernels under GSPMD rules and ``custom_vmap``) are twinned in
``tests/test_torch_partition.py``; this world runs their mesh cases
(``partition_cases``), and :func:`bank_world` shares its results with that
file, once a test session.  Not ported: ``test_graft_entry_compiles`` (the
graft entry, ``__graft_entry__.py``, ROADMAP Not to port).
"""

import fcntl
import itertools
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ndarray_interp_tpu.parallel as j_par
from ndarray_interp_tpu.interp1d import CubicSpline as JCubic, Interp1D as JInterp1D
from ndarray_interp_tpu.interp2d import Interp2D as JInterp2D
from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu_torch.interp2d import Bicubic, Interp2D
from ndarray_interp_tpu_torch.parallel import (
    shard_interp1d,
    shard_interp2d,
    shard_queries,
    sharded_eval_1d,
    sharded_eval_2d,
)
from ndarray_interp_tpu_torch.utils.mesh import chunk, mesh_shape
from test_torch_multihost import run_world  # the gloo world's launcher

# the inputs, shared with the world's ranks (which import no JAX)
PROBLEMS = '''
import numpy as np


def bank_arrays(n=32, bank=16, seed=0):
    """tests/test_parallel.py:build_bank's inputs."""
    rng = np.random.default_rng(seed)
    return np.linspace(0.0, 1.0, n), rng.normal(size=(n, bank))


def grid_arrays(seed=9):
    rng = np.random.default_rng(seed)
    x, y = np.linspace(0.0, 1.0, 12), np.linspace(0.0, 2.0, 10)
    data = rng.normal(size=(12, 10, 8))
    return x, y, data, rng.uniform(0, 1, 64), rng.uniform(0, 2, 64)


def step_arrays(n_knots=256, bank=512, n_q=8192):
    """__graft_entry__.dryrun_multichip's inputs, cut to the CPU's size."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 1.0, n_knots).astype(np.float32)
    data = rng.normal(size=(n_knots, bank)).astype(np.float32)
    q = np.random.default_rng(1).uniform(0.0, 1.0, n_q).astype(np.float32)
    targets = np.sin(q * np.float32(7.0))[:, None] * np.ones((1, bank), np.float32)
    return x, data, q, targets


# the inputs of the kernels' placement rules (tests/test_parallel.py:106-637)
def fused_arrays(nq=4096, n=256, seed=3):
    """_fused_fixture's: knots, data, a, b (the interval table's) and queries."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.1, 1.0, n)).astype(np.float32)
    d, a, b = (rng.normal(size=m).astype(np.float32) for m in (n, n - 1, n - 1))
    q = rng.uniform(float(x[0]) - 1.0, float(x[-1]) + 1.0, nq).astype(np.float32)
    return x, d, a, b, q


def bank_case(seed, n, bank, nq):
    """The banked signature's operands: d2, a2, b2 (f32), idx (int32), t."""
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(m, bank)).astype(np.float32) for m in (n, n - 1, n - 1)]
    idx = rng.integers(0, n - 1, nq).astype(np.int32)
    return (*tables, idx, rng.uniform(0, 1, nq).astype(np.float32))


def df_eval_arrays():
    """test_df_kernel_under_mesh's float64 knots, data, a, b and queries."""
    rng = np.random.default_rng(13)
    n, nq = 128, 2048
    x64 = np.cumsum(rng.uniform(0.05, 1.0, n))
    d64, a64, b64 = rng.normal(size=n), rng.normal(size=n - 1), rng.normal(size=n - 1)
    return x64, d64, a64, b64, rng.uniform(x64[0], x64[-1], nq)


def df_gather_arrays():
    """test_df_gather_routes_under_mesh's bank (x, d, a, b, q) and bilinear
    grid (x, y, z, qx, qy), float64."""
    rng = np.random.default_rng(71)
    n, bank, nq = 64, 16, 2048
    x64 = np.linspace(0.0, 1.0, n)
    d64, a64, b64 = (rng.normal(size=(m, bank)) for m in (n, n - 1, n - 1))
    q64 = rng.uniform(-0.1, 1.1, nq)
    nx, ny = 48, 40
    gx, gy = np.cumsum(rng.uniform(0.1, 1.0, nx)), np.cumsum(rng.uniform(0.1, 1.0, ny))
    z64 = rng.normal(size=(nx, ny))
    qx, qy = rng.uniform(gx[0], gx[-1], nq), rng.uniform(gy[0], gy[-1], nq)
    return (x64, d64, a64, b64, q64), (gx, gy, z64, qx, qy)


def df_bicubic_arrays():
    """test_df_bicubic_route_under_mesh's axes, cell rows (r = 3) and queries."""
    rng = np.random.default_rng(73)
    nx, ny, r, nq = 40, 32, 3, 2048
    x64, y64 = np.cumsum(rng.uniform(0.1, 1.0, nx)), np.cumsum(rng.uniform(0.1, 1.0, ny))
    rows64 = rng.normal(size=((nx - 1) * (ny - 1), 16 * r))
    return x64, y64, rows64, rng.uniform(x64[0], x64[-1], nq), rng.uniform(y64[0], y64[-1], nq)


def df_node_arrays():
    """test_df_bicubic_node_route_under_mesh's axes, node rows (r = 3) and
    queries."""
    rng = np.random.default_rng(74)
    nx, ny, r, nq = 24, 20, 3, 2048
    x64, y64 = np.cumsum(rng.uniform(0.1, 1.0, nx)), np.cumsum(rng.uniform(0.1, 1.0, ny))
    rows64 = rng.normal(size=(nx * ny, 4 * r + 2))
    rows64[:, 4 * r], rows64[:, 4 * r + 1] = np.repeat(x64, ny), np.tile(y64, nx)
    return x64, y64, rows64, rng.uniform(x64[0], x64[-1], nq), rng.uniform(y64[0], y64[-1], nq)


ND_SIZES, ND_R = (9, 8, 7), 2


def df_nd_arrays():
    """test_df_nd_route_under_mesh's three axes, cubic cell rows and queries."""
    rng = np.random.default_rng(75)
    axes64 = [np.cumsum(rng.uniform(0.1, 1.0, n)) for n in ND_SIZES]
    rows64 = rng.normal(size=(int(np.prod([n - 1 for n in ND_SIZES])), 4**3 * ND_R))
    return axes64, rows64, [rng.uniform(a[0], a[-1], 2048) for a in axes64]
'''
exec(PROBLEMS)  # noqa: S102 - defines bank_arrays, grid_arrays and step_arrays here

CHILD = PROBLEMS + '''
import sys
import torch
from ndarray_interp_tpu_torch.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu_torch.interp2d import Interp2D
from ndarray_interp_tpu_torch.parallel import (
    make_mesh, shard_interp1d, shard_interp2d, shard_queries, sharded_eval_1d, sharded_eval_2d,
)
from ndarray_interp_tpu_torch.parallel.multihost import initialize, shutdown
from ndarray_interp_tpu_torch.examples import spline_bank_sharded
from ndarray_interp_tpu_torch.utils.mesh import chunk



def partition_cases(mesh2, mesh1):
    """The kernels' placement rules (``ops/partition.py``) on this rank: the
    twins of tests/test_parallel.py's mesh cases, queries ``Shard(0)`` over
    the 1-D ``query`` mesh (bank cases: over ``query`` of the (query 2,
    bank 2) mesh, tables ``Shard(1)`` over ``bank``).  Per case: each
    output's local shard and placements, the collectives counted while the
    rule ran, and whether the shard equals the unsharded entry's slice."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from ndarray_interp_tpu_torch.ops import eval_kernels as ek, partition as part
    from ndarray_interp_tpu_torch.ops import eval_kernels_df as edf, eval_kernels_df2d as e2
    from ndarray_interp_tpu_torch.ops import eval_kernels_df_nd as end
    from ndarray_interp_tpu_torch.ops.bank_eval import banked_eval
    from ndarray_interp_tpu_torch.ops.bank_tail import gathered_bank_eval
    from ndarray_interp_tpu_torch.ops.df import df_from_f64

    def cut(t, mesh, placements):
        for i, p in enumerate(placements):
            if isinstance(p, Shard):
                t = t[(slice(None),) * p.dim + (chunk(t.shape[p.dim], mesh.size(i),
                                                      mesh.get_local_rank(i)),)]
        return t

    def dt(t, mesh, placements):
        return DTensor.from_local(cut(t, mesh, placements), mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def same(a, b):
        try:
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
            return True
        except AssertionError:
            return False

    def case(rule, args, whole, mesh):
        with CommDebugMode() as comm:
            out = rule(*args)
        outs, wholes = (out, whole) if isinstance(out, tuple) else ((out,), (whole,))
        return {"local": [o.to_local() for o in outs], "placements": [str(o.placements) for o in outs],
                "shapes": [tuple(o.shape) for o in outs], "comms": comm.get_total_counts(),
                "same": all(same(o.to_local(), cut(w, mesh, o.placements))
                            for o, w in zip(outs, wholes))}

    def pairs(*arrays):
        return [h for v in arrays for h in df_from_f64(v)]

    q1 = [Shard(0)]
    got = {}
    x, d, a, b, q = (T(v) for v in fused_arrays())
    tbl = ek.make_interval_table(x, d, a, b)
    qs = dt(q, mesh1, q1)
    got["fused_eval"] = case(part.sharded_fused_eval(), (x, tbl, qs), ek.fused_eval_1d(x, tbl, q), mesh1)
    got["lower_index"] = case(part.sharded_lower_index(), (x, qs), ek.fused_lower_index(x, q), mesh1)
    got["index_frac"] = case(part.sharded_index_frac(), (x, qs), ek.fused_index_frac(x, q), mesh1)
    tb, qp = [Replicate(), Shard(1)], [Shard(0), Replicate()]
    for name, fn, rule, spec in (("banked", banked_eval, part.sharded_banked_eval, (4, 32, 64, 256)),
                                 ("gathered", gathered_bank_eval, part.sharded_gathered_eval,
                                  (7, 24, 32, 1024))):
        ops = [T(v) for v in bank_case(*spec)]
        args = [dt(v, mesh2, tb) for v in ops[:3]] + [dt(v, mesh2, qp) for v in ops[3:]]
        got[name] = case(rule(), args, fn(*ops), mesh2)
    ops = pairs(*df_eval_arrays())
    args = ops[:8] + [dt(v, mesh1, q1) for v in ops[8:]]
    got["df_eval"] = case(part.sharded_df_eval(), args, edf.fused_eval_1d_df(*ops), mesh1)
    (x64, d64, a64, b64, q64), (gx, gy, z64, qx, qy) = df_gather_arrays()
    p = pairs(x64, d64, a64, b64)
    qh, ql = df_from_f64(q64)
    qd = [dt(v, mesh1, q1) for v in (qh, ql)]
    for tier, pack in (("df", edf.pack_bank_rows_df), ("f48", edf.pack_bank_rows_f48)):
        packed = pack(*p[2:8])
        whole = part.sharded_df_banked_packed(16, tier)(p[0], p[1], packed, qh, ql)
        got[f"df_bank_{tier}"] = case(part.sharded_df_banked_packed(16, tier),
                                      (p[0], p[1], packed, *qd), whole, mesh1)
    p2 = pairs(gx, gy, z64)
    q2 = pairs(qx, qy)
    q2d = [dt(v, mesh1, q1) for v in q2]
    for tier, pack in (("df", e2.pack_bilinear_rows_df), ("f48", e2.pack_bilinear_rows_f48)):
        packed = pack(p2[4], p2[5])
        rule = part.sharded_df_bilinear_packed(len(gy), 1, tier)
        got[f"df_bilinear_{tier}"] = case(rule, (*p2[:4], packed, *q2d),
                                          rule(*p2[:4], packed, *q2), mesh1)
    x64, y64, rows64, qx, qy = df_bicubic_arrays()
    axes, rows, q2 = pairs(x64, y64), df_from_f64(rows64), pairs(qx, qy)
    q2d = [dt(v, mesh1, q1) for v in q2]
    for tier, pack in (("df", e2.pack_bicubic_rows_df), ("f48", e2.pack_bicubic_rows_f48)):
        packed = pack(*rows, 3)
        rule = part.sharded_df_bicubic_packed(3, tier)
        got[f"df_bicubic_{tier}"] = case(rule, (*axes, packed, *q2d), rule(*axes, packed, *q2),
                                         mesh1)
    x64, y64, rows64, qx, qy = df_node_arrays()
    axes, q2 = pairs(x64, y64), pairs(qx, qy)
    packed = e2.pack_bicubic_nodes_df(*df_from_f64(rows64))
    rule = part.sharded_df_bicubic_nodes(3)
    got["df_node"] = case(rule, (*axes, packed, *[dt(v, mesh1, q1) for v in q2]),
                          rule(*axes, packed, *q2), mesh1)
    axes64, rows64, qs64 = df_nd_arrays()
    axes, qn, rows = pairs(*axes64), pairs(*qs64), df_from_f64(rows64)
    for tier, pack in (("df", end.pack_rows_nd_df), ("f48", end.pack_rows_nd_f48)):
        packed = pack(*rows, 4**3, ND_R)
        rule = part.sharded_df_nd_packed(3, ND_SIZES, ND_R, tier=tier)
        got[f"df_nd_{tier}"] = case(rule, (*axes, packed, *[dt(v, mesh1, q1) for v in qn]),
                                    rule(*axes, packed, *qn), mesh1)
    return got


url, world, rank, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
initialize(url, world, rank, backend="gloo")
T = torch.tensor
res = {"cuda": torch.cuda.is_available()}
mesh = make_mesh(device_type="cpu")
res["shape"], res["names"] = tuple(mesh.shape), mesh.mesh_dim_names
qi, bi = mesh.get_local_rank("query"), mesh.get_local_rank("bank")
res["coords"] = (qi, bi)
try:
    make_mesh()
    res["no_cuda_raises"] = False
except RuntimeError:
    res["no_cuda_raises"] = True
x, data = (T(v) for v in bank_arrays())
itp = Interp1D.builder(data).x(x).strategy(CubicSpline().extrapolate(True)).build()
q = T(np.random.default_rng(1).uniform(0, 1, 64))
res["eval1d"] = sharded_eval_1d(shard_interp1d(itp, mesh), q, mesh)
x, y, data, qx, qy = (T(v) for v in grid_arrays())
itp2 = Interp2D.builder(data).x(x).y(y).build()
res["eval2d"] = sharded_eval_2d(shard_interp2d(itp2, mesh), qx, qy, mesh)
res["queries"] = shard_queries(torch.arange(32.0), mesh)
x, full, q, targets = step_arrays()
qs, cs = chunk(q.shape[0], 2, qi), chunk(full.shape[1], 2, bi)
loss, new, pred = spline_bank_sharded.sgd_step(
    T(x), T(full[:, cs]), T(q[qs]), T(targets[qs, cs]), mesh, targets.size)
res["step"] = (loss, new, pred)
res["example_err"] = spline_bank_sharded.main(n_knots=64, bank=512, n_queries=256, device="cpu")
try:
    res["partition"] = partition_cases(mesh, make_mesh(axis_names=("query",), device_type="cpu"))
except Exception:  # the other cases' results stand; the partition twins report this
    import traceback

    res["partition"] = traceback.format_exc()
torch.save(res, f"{outdir}/rank{rank}.pt")
shutdown()
'''

WORLD = 4


def bank_world(tmp_path_factory):
    """The world's results, run once a test session: this file and
    ``test_torch_partition.py`` read them.  Under xdist the workers of one
    session share the parent of their temporary directories; the first
    worker to ask runs the world under a file lock, the others wait for it
    and read its files."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    outdir = root / "bank_world"
    with open(root / "bank_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (outdir / "done").exists():
            shutil.rmtree(outdir, ignore_errors=True)  # a failed run's rendezvous
            outdir.mkdir()
            run_world(CHILD, outdir, WORLD)
            (outdir / "done").touch()
    return [torch.load(outdir / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return bank_world(tmp_path_factory)


class Coords:
    """A ``DeviceMesh`` stand-in at one coordinate: the axis names, shape,
    device type and local ranks that the bank and query sharding read."""

    device_type = "cpu"

    def __init__(self, shape, coords, names=("query", "bank")):
        self.mesh_dim_names, self.shape, self.coords = names, shape, coords

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


def blocks(fn, shape=(2, 4)):
    """``fn(coords)`` at every coordinate of a ``(query, bank)`` mesh,
    assembled: query chunks down the rows, bank chunks along the last axis."""
    rows = []
    for qi in range(shape[0]):
        parts = [fn(Coords(shape, (qi, bi))) for bi in range(shape[1])]
        rows.append(torch.cat(parts, dim=-1) if parts[0].ndim > 1 else parts[0])
    return torch.cat(rows)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return j_par.make_mesh(8)


def build_bank(n=32, bank=16, seed=0):
    x, data = bank_arrays(n, bank, seed)
    return Interp1D.builder(data, device="cpu").x(x).strategy(CubicSpline().extrapolate(True)).build()


def j_build_bank(n=32, bank=16, seed=0):
    x, data = bank_arrays(n, bank, seed)
    return JInterp1D.builder(jnp.asarray(data)).x(jnp.asarray(x)).strategy(
        JCubic().extrapolate(True)).build()


def test_mesh_factorization(jmesh, world):
    assert dict(zip(jmesh.axis_names, jmesh.devices.shape)) == {"query": 2, "bank": 4}
    assert mesh_shape(8, ("query", "bank")) == (2, 4)
    assert mesh_shape(8, ("data",)) == (8,)
    for n in range(1, 9):
        assert mesh_shape(n, ("query", "bank")) == j_par.make_mesh(n).devices.shape
    for res in world:
        assert res["shape"] == (2, 2) and res["names"] == ("query", "bank")


def test_sharded_eval_matches_replicated(jmesh, world):
    itp = build_bank()
    q = np.random.default_rng(1).uniform(0, 1, 64)
    want = itp.eval_unchecked(torch.as_tensor(q))
    got = blocks(lambda m: sharded_eval_1d(shard_interp1d(itp, m), q, m))
    assert torch.equal(got, want)
    jgot = j_par.sharded_eval_1d(j_par.shard_interp1d(j_build_bank(), jmesh), jnp.asarray(q), jmesh)
    assert jgot.sharding.spec == P("query", "bank")
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-14)
    for res in world:
        qi, bi = res["coords"]
        assert torch.equal(res["eval1d"], want[chunk(64, 2, qi), chunk(16, 2, bi)])


def test_bank_sharded_build(jmesh):
    """A rank builds its own columns (the Thomas solve, no communication):
    the same bits as the whole bank's build."""
    rng = np.random.default_rng(2)
    n, bank = 16, 8
    x, data = np.linspace(0.0, 1.0, n), rng.normal(size=(n, bank))
    strat = CubicSpline().extrapolate(True)
    whole = strat.build(torch.as_tensor(x), torch.as_tensor(data))
    for bi in range(4):
        cols = chunk(bank, 4, bi)
        part = strat.build(torch.as_tensor(x), torch.as_tensor(data[:, cols]))
        assert torch.equal(part.a, whole.a[:, cols]) and torch.equal(part.b, whole.b[:, cols])
    jstrat = JCubic().extrapolate(True)
    jdata = jax.device_put(jnp.asarray(data), NamedSharding(jmesh, P(None, "bank")))
    ja, jb = jax.jit(lambda d: (lambda s: (s.a, s.b))(jstrat.build(jnp.asarray(x), d)))(jdata)
    np.testing.assert_allclose(whole.a.numpy(), np.asarray(ja), atol=1e-14)
    np.testing.assert_allclose(whole.b.numpy(), np.asarray(jb), atol=1e-14)


def test_shard_queries_roundtrip(world):
    q = torch.arange(32.0)
    parts = [shard_queries(q, Coords((2, 4), (qi, 0))) for qi in range(2)]
    assert torch.equal(torch.cat(parts), q)
    for res in world:
        assert torch.equal(res["queries"], q[chunk(32, 2, res["coords"][0])])


def test_dryrun_multichip(world):
    """The JAX package's multichip step (build, eval, loss, gradient through
    both, update) on the world's (query 2, bank 2) mesh, at the JAX test's
    reduced sizes: each rank's prediction, loss and updated columns equal the
    coordinate-wise steps bit for bit, the prediction the replicated one bit
    for bit, and JAX's within 1e-5 of the scale."""
    from ndarray_interp_tpu.models.strategies.cubic import (
        _NOT_A_KNOT,
        CubicSplineStrategy,
        _ab_from_k,
        _solve_for_k,
    )
    from ndarray_interp_tpu_torch.examples.spline_bank_sharded import local_step

    x, full, q, targets = step_arrays()
    numel = targets.size
    steps = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' (OMP_NUM_THREADS=1): a CPU sum's order follows it
    try:
        for qi, bi in itertools.product(range(2), range(2)):
            qs, cs = chunk(q.shape[0], 2, qi), chunk(full.shape[1], 2, bi)
            steps[qi, bi] = local_step(torch.as_tensor(x), torch.as_tensor(full[:, cs]),
                                       torch.as_tensor(q[qs]), torch.as_tensor(targets[qs, cs]),
                                       numel)
    finally:
        torch.set_num_threads(threads)
    loss = (steps[0, 0][0] + steps[1, 0][0]) + (steps[0, 1][0] + steps[1, 1][0])
    share, grad, pred = local_step(*(torch.as_tensor(v) for v in (x, full, q, targets)), numel)
    for res in world:
        qi, bi = res["coords"]
        got_loss, got_new, got_pred = res["step"]
        cs = chunk(full.shape[1], 2, bi)
        assert torch.equal(got_pred, steps[qi, bi][2])
        assert torch.equal(got_pred, pred[chunk(q.shape[0], 2, qi), cs])
        assert torch.equal(got_loss, loss) and torch.isfinite(got_loss)
        g = steps[0, bi][1] + steps[1, bi][1]
        assert torch.equal(got_new, torch.as_tensor(full[:, cs]) - 0.1 * g)
        np.testing.assert_allclose(got_new.numpy(), full[:, cs] - 0.1 * grad[:, cs].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), share.item(), rtol=1e-5)
    # JAX's forward on the same inputs (its dryrun's replicated oracle)
    xj, dj = jnp.asarray(x), jnp.asarray(full)
    k = _solve_for_k(xj, dj, _NOT_A_KNOT, 0.0, _NOT_A_KNOT, 0.0)
    jitp = JInterp1D.new_unchecked(xj, dj, CubicSplineStrategy(*_ab_from_k(xj, dj, k), "yes"))
    jpred = np.asarray(jitp(jnp.asarray(q[:4096])))
    diff = np.abs(pred[:4096].numpy() - jpred).max() / np.abs(jpred).max()
    assert diff <= 1e-5, diff


def test_sharded_eval_2d_matches_replicated(jmesh, world):
    x, y, data, qx, qy = grid_arrays()
    itp = Interp2D.builder(data, device="cpu").x(x).y(y).build()
    want = itp.eval_unchecked(torch.as_tensor(qx), torch.as_tensor(qy))
    got = blocks(lambda m: sharded_eval_2d(shard_interp2d(itp, m), qx, qy, m))
    assert torch.equal(got, want)
    jitp = JInterp2D.builder(jnp.asarray(data)).x(jnp.asarray(x)).y(jnp.asarray(y)).build()
    jgot = j_par.sharded_eval_2d(j_par.shard_interp2d(jitp, jmesh), jnp.asarray(qx),
                                 jnp.asarray(qy), jmesh)
    assert jgot.sharding.spec == P("query", "bank")
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-14)
    for res in world:
        qi, bi = res["coords"]
        assert torch.equal(res["eval2d"], want[chunk(64, 2, qi), chunk(8, 2, bi)])


# -- beyond the JAX file ------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["cell", "node"])
def test_shard_interp2d_bicubic_tables(layout, monkeypatch):
    """``Bicubic``'s cell and node rows cut to a rank's columns in every
    block: the blocks equal the unsharded eval bit for bit, on a bank
    behind a leading trailing dim."""
    from ndarray_interp_tpu_torch import config

    if layout == "node":
        monkeypatch.setattr(config, "bicubic_pack_max_elems", 10)
    rng = np.random.default_rng(11)
    x, y = np.sort(rng.uniform(0, 5, 9)), np.sort(rng.uniform(0, 5, 7))
    data = rng.normal(size=(9, 7, 3, 8))
    itp = Interp2D.builder(data, device="cpu").x(x).y(y).strategy(Bicubic().extrapolate(True)).build()
    assert itp.strategy.layout == layout
    qx, qy = rng.uniform(-1, 6, 50), rng.uniform(-1, 6, 50)
    want = itp.eval_unchecked(torch.as_tensor(qx), torch.as_tensor(qy))
    got = blocks(lambda m: sharded_eval_2d(shard_interp2d(itp, m), qx, qy, m))
    assert torch.equal(got, want)


def test_example_runs_in_a_gloo_world(world):
    """``examples/spline_bank_sharded.py`` on the CPU in the 4-rank world,
    and ``make_mesh`` without a GPU or a named device type raises."""
    for res in world:
        assert res["example_err"] < 1e-4
        assert res["no_cuda_raises"] == (not res["cuda"])
