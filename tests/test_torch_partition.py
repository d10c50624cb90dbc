"""The port's kernel rules under ``torch.func`` and DTensor
(``ops/partition.py``, the ``vmap`` staticmethods of the kernels'
``autograd.Function``) against the JAX package's ``ops/partition.py``
(``tests/test_parallel.py:130-637``), case by case, on the CPU.

The JAX side runs each case as its test does (``sharded_*(True)``,
interpret mode, the 8-device CPU mesh of ``tests/conftest.py``).  The
port's ``vmap`` cases run here, through the same ``autograd.Function`` the
card runs, its launch replaced by a stand-in that asserts every operand has
storage (a ``data_ptr``, which a launch reads) and returns the plain
version's result: so each case also shows how many launches the card makes.
The port's mesh cases run in the 4-rank gloo world of
``tests/test_torch_parallel.py`` (its ``partition_cases``; one world a test
session, shared with that file): queries ``Shard(0)`` over a 1-D ``query``
mesh of 4 (bank cases: a (query 2, bank 2) mesh, tables ``Shard(1)`` on
``bank``).  Each rank's shard must equal the unsharded entry's slice bit for
bit with no collective issued, and the assembled result the JAX test's
oracle at the JAX test's tolerance.

Not ported: ``test_graft_entry_compiles`` (the graft entry,
``__graft_entry__.py``, ROADMAP Not to port).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ndarray_interp_tpu.parallel as j_par
from ndarray_interp_tpu_torch.ops import _cuda
from ndarray_interp_tpu_torch.ops import bank_eval as t_bank
from ndarray_interp_tpu_torch.ops import bank_tail as t_tail
from ndarray_interp_tpu_torch.ops import bigknots as t_bk
from ndarray_interp_tpu_torch.ops import eval_kernels as t_ek
from ndarray_interp_tpu_torch.ops import tail2d as t_t2
from ndarray_interp_tpu_torch.ops import thomas_kernel as t_th
from ndarray_interp_tpu_torch.ops.df import df_to_f64
from ndarray_interp_tpu_torch.ops.thomas import thomas_solve
from test_torch_parallel import (
    ND_R,
    ND_SIZES,
    bank_case,
    bank_world,
    df_bicubic_arrays,
    df_eval_arrays,
    df_gather_arrays,
    df_nd_arrays,
    df_node_arrays,
    fused_arrays,
)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ranks = bank_world(tmp_path_factory)
    for res in ranks:
        assert not isinstance(res["partition"], str), res["partition"]
    return ranks


def T(*arrays):
    return [torch.as_tensor(v) for v in arrays]


def qmesh():
    return j_par.make_mesh(8, axis_names=("query",))


def jdf(v):
    from ndarray_interp_tpu.ops.df import df_from_f64

    return [jnp.asarray(w) for w in df_from_f64(v)]


def shards(world, case, i=0):
    """Each rank's shard of output ``i`` of ``case``, checked: the rule's
    placements, no collective, the unsharded entry's slice bit for bit."""
    out = []
    for res in world:
        got = res["partition"][case]
        assert got["comms"] == 0, (case, got["comms"])
        assert got["same"], case
        out.append((res["coords"], got["placements"][i], got["local"][i]))
    return out


def assembled(world, case, i=0):
    """Output ``i`` of a 1-D ``query`` mesh case, the shards in rank order."""
    parts = shards(world, case, i)
    assert all(p == "(Shard(dim=0),)" for _, p, _ in parts)
    return torch.cat([t for _, _, t in parts]).numpy()


def assembled_bank(world, case):
    """The bank rule's output on the (query 2, bank 2) mesh: query shards
    down the rows, bank shards along the columns."""
    parts = shards(world, case)
    assert all(p == "(Shard(dim=0), Shard(dim=1))" for _, p, _ in parts)
    blocks = {coords: t for coords, _, t in parts}
    return torch.cat([torch.cat([blocks[qi, bi] for bi in range(2)], 1) for qi in range(2)]).numpy()


def assembled_pair(world, case):
    return df_to_f64(*(torch.as_tensor(assembled(world, case, i)) for i in (0, 1))).numpy()


class Launches:
    """``_cuda.run`` with every kernel Function on its launch route: the
    launch's stand-in asserts each tensor operand has storage, records the
    entry's name and its query operand's shape, and returns the plain
    version's result."""

    def __init__(self, mp):
        self.calls = []
        mp.setattr(_cuda, "run", self)

    def __call__(self, name, t, launch, plain, *args):
        for a in args:
            if isinstance(a, torch.Tensor):
                a.data_ptr()  # raises for a tensor without storage (a batched one)
        self.calls.append((name, tuple(t.shape)))
        return plain(*args)

    def names(self):
        return [name for name, _ in self.calls]


def fused_case(nq=4096):
    x, d, a, b, q = fused_arrays(nq=nq)
    from ndarray_interp_tpu.ops.pallas_eval import make_interval_table

    jx, jq = jnp.asarray(x), jnp.asarray(q)
    jtbl = make_interval_table(jx, *(jnp.asarray(v) for v in (d, a, b)))
    tx, tq = T(x, q)
    return (jx, jtbl, jq), (tx, t_ek.make_interval_table(*T(x, d, a, b)), tq)


# -- the twins of tests/test_parallel.py ---------------------------------------------
def test_fused_eval_kernel_under_mesh(world):
    from ndarray_interp_tpu.ops.pallas_eval import _eval_xla
    from ndarray_interp_tpu.ops.partition import sharded_fused_eval

    (x, tbl, q), _ = fused_case()
    qs = jax.device_put(q, NamedSharding(qmesh(), P("query")))
    out = jax.jit(sharded_fused_eval(True))(x, tbl, qs)
    assert out.sharding.spec == P("query")
    ref = np.asarray(_eval_xla(x, tbl, q))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(assembled(world, "fused_eval"), ref, rtol=1e-5, atol=1e-6)


def test_fused_lower_index_under_mesh(world):
    from ndarray_interp_tpu.ops.partition import sharded_lower_index
    from ndarray_interp_tpu.ops.searchsorted import get_lower_index

    (x, _, q), _ = fused_case()
    qs = jax.device_put(q, NamedSharding(qmesh(), P("query")))
    out = jax.jit(sharded_lower_index(True))(x, qs)
    assert out.sharding.spec == P("query")
    want = np.asarray(get_lower_index(x, q))
    np.testing.assert_array_equal(np.asarray(out), want)
    np.testing.assert_array_equal(assembled(world, "lower_index"), want)


def test_fused_index_frac_under_mesh(world):
    from ndarray_interp_tpu.ops.partition import sharded_index_frac
    from ndarray_interp_tpu.ops.searchsorted import get_lower_index

    (x, _, q), _ = fused_case()
    qs = jax.device_put(q, NamedSharding(qmesh(), P("query")))
    idx, t = jax.jit(sharded_index_frac(True))(x, qs)
    assert idx.sharding.spec == P("query") and t.sharding.spec == P("query")
    want_idx = np.asarray(get_lower_index(x, q))
    x_l, x_r = np.asarray(x)[want_idx], np.asarray(x)[want_idx + 1]
    want_t = (np.asarray(q) - x_l) / (x_r - x_l)
    for got_idx, got_t in ((np.asarray(idx), np.asarray(t)),
                           (assembled(world, "index_frac", 0), assembled(world, "index_frac", 1))):
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-6)


def jax_bank_case(spec):
    ops = bank_case(*spec)
    return [jnp.asarray(v) for v in ops], ops


def test_banked_kernel_under_mesh(world):
    """banked_eval partitions (query x bank) with zero communication."""
    from ndarray_interp_tpu.ops.partition import _gather_form_2d, sharded_banked_eval

    jmesh = j_par.make_mesh(8)
    (d2, a2, b2, idx, t), _ = jax_bank_case((4, 32, 64, 256))
    tbl_sh, q_sh = NamedSharding(jmesh, P(None, "bank")), NamedSharding(jmesh, P("query"))
    args = [jax.device_put(v, tbl_sh) for v in (d2, a2, b2)]
    args += [jax.device_put(v, q_sh) for v in (idx, t)]
    out = jax.jit(sharded_banked_eval(True))(*args)
    assert out.sharding.spec == P("query", "bank")
    ref = np.asarray(_gather_form_2d(d2, a2, b2, idx, t))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(assembled_bank(world, "banked"), ref, rtol=1e-6, atol=1e-6)


def test_fused_eval_vmap_flattens_queries(monkeypatch):
    """vmap over the query axis routes through the kernel: one launch on
    the flattened queries."""
    from ndarray_interp_tpu.ops.pallas_eval import _eval_xla
    from ndarray_interp_tpu.ops.partition import sharded_fused_eval

    (jx, jtbl, jq), (x, tbl, q) = fused_case(nq=1024)
    fe = sharded_fused_eval(True)
    out = jax.vmap(lambda qq: fe(jx, jtbl, qq))(jq.reshape(4, 256))
    ref = np.asarray(_eval_xla(jx, jtbl, jq).reshape(4, 256))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-6)
    want = t_ek.fused_eval_1d(x, tbl, q).reshape(4, 256)
    launches = Launches(monkeypatch)
    got = torch.func.vmap(lambda qq: t_ek.fused_eval_1d(x, tbl, qq))(q.reshape(4, 256))
    assert launches.calls == [("fused_eval_1d", (1024,))]
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_fused_eval_vmap_batched_tables_falls_back(monkeypatch):
    """vmap that batches the interpolator tables takes the plain version:
    no launch."""
    from ndarray_interp_tpu.ops.pallas_eval import _eval_xla
    from ndarray_interp_tpu.ops.partition import sharded_fused_eval

    (jx, jtbl, jq), (x, tbl, q) = fused_case(nq=512)
    jtbl_b = jnp.stack([jtbl, jtbl * 2.0])
    out = jax.vmap(sharded_fused_eval(True), in_axes=(None, 0, None))(jx, jtbl_b, jq)
    ref = np.asarray(jax.vmap(_eval_xla, in_axes=(None, 0, None))(jx, jtbl_b, jq))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-6)
    launches = Launches(monkeypatch)
    tbl_b = torch.stack([tbl, tbl * 2.0])
    got = torch.func.vmap(t_ek.fused_eval_1d, in_dims=(None, 0, None))(x, tbl_b, q)
    assert launches.calls == []
    assert torch.equal(got, torch.stack([t_ek._eval_plain(x, t_, q) for t_ in tbl_b]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_gathered_route_under_mesh(world):
    """The gather-route banked eval partitions (query x bank) like K5."""
    from ndarray_interp_tpu.ops.partition import _gather_form_2d, sharded_gathered_eval

    jmesh = j_par.make_mesh(8)
    (d2, a2, b2, idx, t), _ = jax_bank_case((7, 24, 32, 1024))
    tbl_sh, q_sh = NamedSharding(jmesh, P(None, "bank")), NamedSharding(jmesh, P("query"))
    out = jax.jit(sharded_gathered_eval(True))(
        *(jax.device_put(v, tbl_sh) for v in (d2, a2, b2)),
        *(jax.device_put(v, q_sh) for v in (idx, t)))
    assert out.sharding.spec == P("query", "bank")
    ref = np.asarray(_gather_form_2d(d2, a2, b2, idx, t))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(assembled_bank(world, "gathered"), ref, rtol=1e-5, atol=1e-5)


def test_banked_vmap_flattens_queries(monkeypatch):
    from ndarray_interp_tpu.ops.partition import _gather_form_2d, sharded_banked_eval

    (d2, a2, b2, idx, t), ops = jax_bank_case((5, 16, 8, 64))
    f = sharded_banked_eval(True)
    out = jax.vmap(lambda i_, t_: f(d2, a2, b2, i_, t_))(idx.reshape(4, 16), t.reshape(4, 16))
    ref = np.asarray(_gather_form_2d(d2, a2, b2, idx, t).reshape(4, 16, 8))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6, atol=1e-6)
    td2, ta2, tb2, tidx, tt = T(*ops)
    want = t_bank.banked_eval(td2, ta2, tb2, tidx, tt).reshape(4, 16, 8)
    launches = Launches(monkeypatch)
    got = torch.func.vmap(lambda i_, t_: t_bank.banked_eval(td2, ta2, tb2, i_, t_))(
        tidx.reshape(4, 16), tt.reshape(4, 16))
    assert launches.calls == [("banked_eval", (64,))]
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_df_kernel_under_mesh(world):
    """The double-float kernel shards over the query axis (both halves)."""
    from ndarray_interp_tpu.ops.df import df_to_f64 as j_df_to_f64
    from ndarray_interp_tpu.ops.pallas_eval_df import eval_xla_df
    from ndarray_interp_tpu.ops.partition import sharded_df_eval

    args = [w for v in df_eval_arrays() for w in jdf(v)]
    q_sh = NamedSharding(qmesh(), P("query"))
    sharded = args[:8] + [jax.device_put(v, q_sh) for v in args[8:]]
    hi, lo = jax.jit(sharded_df_eval(True))(*sharded)
    assert hi.sharding.spec == P("query")
    want = np.asarray(j_df_to_f64(*jax.jit(eval_xla_df)(*args)))
    np.testing.assert_allclose(j_df_to_f64(np.asarray(hi), np.asarray(lo)), want,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(assembled_pair(world, "df_eval"), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["banked", "gathered"])
def test_gathered_vmap_partial_batching(kernel, monkeypatch):
    """vmap batching only idx (shared t) broadcasts the unbatched operand
    into one launch."""
    from ndarray_interp_tpu.ops import partition as jp

    rng = np.random.default_rng(31)
    n, bank, nq, bdim = 16, 8, 16, 4
    d2, a2, b2 = (rng.normal(size=(m, bank)).astype(np.float32) for m in (n, n - 1, n - 1))
    idx_b = rng.integers(0, n - 1, (bdim, nq)).astype(np.int32)
    t_shared = rng.uniform(0, 1, nq).astype(np.float32)
    jf = {"banked": jp.sharded_banked_eval, "gathered": jp.sharded_gathered_eval}[kernel](True)
    jargs = [jnp.asarray(v) for v in (d2, a2, b2, idx_b, t_shared)]
    out = jax.vmap(jf, in_axes=(None, None, None, 0, None))(*jargs)
    want = np.stack([np.asarray(jp._gather_form_2d(*jargs[:3], jargs[3][i], jargs[4]))
                     for i in range(bdim)])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-5)
    fn = {"banked": t_bank.banked_eval, "gathered": t_tail.gathered_bank_eval}[kernel]
    ops = T(d2, a2, b2, idx_b, t_shared)
    loop = torch.stack([fn(*ops[:3], i_, ops[4]) for i_ in ops[3]])
    launches = Launches(monkeypatch)
    got = torch.func.vmap(fn, in_dims=(None, None, None, 0, None))(*ops)
    assert launches.calls == [(launches.names()[0], (bdim * nq,))]
    assert torch.equal(got, loop)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_df_gather_routes_under_mesh(world):
    """The DF gather routes carry query-axis rules (tables replicate, no
    communication): bank and bilinear, grades df and f48."""
    from ndarray_interp_tpu.ops.df import df_to_f64 as j_df_to_f64
    from ndarray_interp_tpu.ops import pallas_eval_df as jdf_ops
    from ndarray_interp_tpu.ops.partition import (
        sharded_df_banked_packed,
        sharded_df_bilinear_packed,
    )

    q_sh = NamedSharding(qmesh(), P("query"))
    (x64, d64, a64, b64, q64), (gx, gy, z64, qx64, qy64) = df_gather_arrays()
    pairs = [w for v in (x64, d64, a64, b64) for w in jdf(v)]
    qh, ql = jdf(q64)
    whi, wlo = jdf_ops.eval_xla_df_banked(*pairs, qh, ql)
    want = np.asarray(j_df_to_f64(whi, wlo))
    for tier, pack in (("df", jdf_ops.pack_bank_rows_df), ("f48", jdf_ops.pack_bank_rows_f48)):
        hi, lo = jax.jit(sharded_df_banked_packed(16, True, tier=tier))(
            pairs[0], pairs[1], pack(*pairs[2:8]),
            jax.device_put(qh, q_sh), jax.device_put(ql, q_sh))
        assert hi.sharding.spec[0] == "query", hi.sharding
        np.testing.assert_allclose(j_df_to_f64(hi, lo), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(assembled_pair(world, f"df_bank_{tier}"), want,
                                   rtol=1e-5, atol=1e-5)
    p2 = [w for v in (gx, gy, z64) for w in jdf(v)]
    qs = jdf(qx64) + jdf(qy64)
    w2h, w2l = jdf_ops.eval_xla_df_2d(*p2, *qs)
    want2 = np.asarray(j_df_to_f64(w2h, w2l)).ravel()
    for tier, pack in (("df", jdf_ops.pack_bilinear_rows_df),
                       ("f48", jdf_ops.pack_bilinear_rows_f48)):
        hi, lo = jax.jit(sharded_df_bilinear_packed(len(gy), 1, True, tier=tier))(
            *p2[:4], pack(p2[4], p2[5]), *(jax.device_put(v, q_sh) for v in qs))
        assert hi.sharding.spec[0] == "query", hi.sharding
        np.testing.assert_allclose(np.asarray(j_df_to_f64(hi, lo)).ravel(), want2,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(assembled_pair(world, f"df_bilinear_{tier}").ravel(), want2,
                                   rtol=1e-5, atol=1e-5)


def test_df_bicubic_route_under_mesh(world):
    from ndarray_interp_tpu.ops.df import df_to_f64 as j_df_to_f64
    from ndarray_interp_tpu.ops import pallas_eval_df as jdf_ops
    from ndarray_interp_tpu.ops.partition import sharded_df_bicubic_packed

    q_sh = NamedSharding(qmesh(), P("query"))
    x64, y64, rows64, qx64, qy64 = df_bicubic_arrays()
    pairs, rows, qs = jdf(x64) + jdf(y64), jdf(rows64), jdf(qx64) + jdf(qy64)
    whi, wlo = jdf_ops.gathered_bicubic_eval_df(*pairs, *rows, *qs, r=3)
    want = np.asarray(j_df_to_f64(whi, wlo))
    for tier, pack in (("df", jdf_ops.pack_bicubic_rows_df),
                       ("f48", jdf_ops.pack_bicubic_rows_f48)):
        hi, lo = jax.jit(sharded_df_bicubic_packed(3, True, tier=tier))(
            *pairs, pack(*rows, 3), *(jax.device_put(v, q_sh) for v in qs))
        assert hi.sharding.spec[0] == "query", hi.sharding
        np.testing.assert_allclose(j_df_to_f64(hi, lo), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(assembled_pair(world, f"df_bicubic_{tier}"), want,
                                   rtol=1e-5, atol=1e-5)


def test_df_bicubic_node_route_under_mesh(world):
    from ndarray_interp_tpu.ops.df import df_to_f64 as j_df_to_f64
    from ndarray_interp_tpu.ops import pallas_eval_df as jdf_ops
    from ndarray_interp_tpu.ops.partition import sharded_df_bicubic_nodes

    q_sh = NamedSharding(qmesh(), P("query"))
    x64, y64, rows64, qx64, qy64 = df_node_arrays()
    pairs, qs = jdf(x64) + jdf(y64), jdf(qx64) + jdf(qy64)
    packed = jdf_ops.pack_bicubic_nodes_df(*jdf(rows64))
    hi, lo = jax.jit(sharded_df_bicubic_nodes(3, True))(
        *pairs, packed, *(jax.device_put(v, q_sh) for v in qs))
    assert hi.sharding.spec[0] == "query", hi.sharding
    whi, wlo = jdf_ops.gathered_bicubic_nodes_eval_df(*pairs, packed, *qs, r=3)
    want = np.asarray(j_df_to_f64(whi, wlo))
    np.testing.assert_allclose(j_df_to_f64(hi, lo), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(assembled_pair(world, "df_node"), want, rtol=1e-5, atol=1e-5)


def test_df_nd_route_under_mesh(world):
    from ndarray_interp_tpu.ops.df import df_to_f64 as j_df_to_f64
    from ndarray_interp_tpu.ops import pallas_eval_df_nd as jnd
    from ndarray_interp_tpu.ops.partition import sharded_df_nd_packed

    q_sh = NamedSharding(qmesh(), P("query"))
    axes64, rows64, qs64 = df_nd_arrays()
    pairs = [w for a in axes64 for w in jdf(a)]
    qs = [w for q in qs64 for w in jdf(q)]
    rows = jdf(rows64)
    route = jnd.gathered_nd_eval_df_packed(3, ND_SIZES, ND_R, nbasis=4)
    whi, wlo = jax.jit(route)(*pairs, jnd.pack_rows_nd_df(*rows, 4**3, ND_R), *qs)
    want = np.asarray(j_df_to_f64(whi, wlo))
    for tier, pack in (("df", jnd.pack_rows_nd_df), ("f48", jnd.pack_rows_nd_f48)):
        hi, lo = jax.jit(sharded_df_nd_packed(3, ND_SIZES, ND_R, interpret=True, tier=tier))(
            *pairs, pack(*rows, 4**3, ND_R), *(jax.device_put(v, q_sh) for v in qs))
        assert hi.sharding.spec[0] == "query", hi.sharding
        np.testing.assert_allclose(j_df_to_f64(hi, lo), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(assembled_pair(world, f"df_nd_{tier}"), want,
                                   rtol=1e-5, atol=1e-5)


# -- every kernel Function under torch.func, on its launch route ---------------------
def _fn_cases():
    """Per kernel Function: ``(name, tables, queries, entry)`` with
    ``entry(*tables, *queries)`` its wrapper; queries f64, a batch of 3 x 8
    samples."""
    rng = np.random.default_rng(81)
    x = torch.as_tensor(np.cumsum(rng.uniform(0.2, 1.0, 12)))
    d, a, b = (torch.as_tensor(rng.normal(size=m)) for m in (12, 11, 11))
    q = torch.as_tensor(rng.uniform(float(x[0]), float(x[-1]), (3, 8)))
    tbl = t_ek.make_interval_table(x, d, a, b)
    ops = T(*(v.astype(np.float64) if v.dtype == np.float32 else v
              for v in bank_case(82, 12, 5, 24)))
    idx, t = ops[3].reshape(3, 8), ops[4].reshape(3, 8)
    y = torch.as_tensor(np.cumsum(rng.uniform(0.2, 1.0, 9)))
    qy = torch.as_tensor(rng.uniform(float(y[0]), float(y[-1]), (3, 8)))
    cells = torch.as_tensor(rng.integers(0, 11 * 8, (3, 8)).astype(np.int32))
    rows = torch.as_tensor(rng.normal(size=(11 * 8, 16 * 2)))
    grid = torch.as_tensor(rng.normal(size=(12, 9, 2)))
    cases = [
        ("K1", (x, tbl), (q,), t_ek.fused_eval_1d),
        ("K2", (x,), (q,), lambda k, q_: t_ek.fused_index_frac(k, q_)[1]),
        ("K3", (x,), (q,), lambda k, q_: q_ - k[t_ek.fused_lower_index(k, q_).long()]),
        ("R1", (x, y), (q, qy), lambda *ops_: sum(t_ek.fused_cell_index(*ops_)[1:])),
        ("K5", tuple(ops[:3]), (idx, t), t_bank.banked_eval),
        ("R2a", tuple(ops[:3]), (idx, t), t_tail.gathered_bank_eval),
        ("R3", (x, d, a, b), (q,), t_bk.big_eval_1d),
        ("R3idx", (x,), (q,), lambda k, q_: t_bk.big_lower_index_frac(k, q_)[1]),
        ("R2g", (grid, x, y), (cells, q, qy), t_t2.bilinear_grid_eval),
    ]
    for kid, fn in (("R2b", t_t2.bilinear_gathered_eval), ("R2c", t_t2.bicubic_gathered_eval),
                    ("R2d", t_t2.bicubic_tree_tail), ("R2n", t_t2.bicubic_nested_tail)):
        cases.append((kid, (rows,), (cells, q, qy), lambda r_, c, a_, b_, fn=fn: fn(r_, c, a_, b_, 2)))
    return cases


@pytest.mark.parametrize("case", _fn_cases(), ids=lambda c: c[0])
def test_kernel_function_composes_with_torch_func(case, monkeypatch):
    """The card's route of each kernel Function, its launch replaced by the
    storage-asserting stand-in: ``vmap`` over the batch launches once on the
    flattened queries, ``grad`` and ``vmap(grad)`` run, and each equals the
    plain version's ``torch.func`` result bit for bit.  Gradients are taken
    with respect to the last query operand."""
    kid, tables, queries, entry = case
    flat = [v.reshape(-1) for v in queries]
    with torch.no_grad():
        want = entry(*tables, *flat)  # the CPU route, before the stand-in
    launches = Launches(monkeypatch)
    got = torch.func.vmap(lambda *qs: entry(*tables, *qs))(*queries)
    assert len(launches.calls) == 1 and launches.calls[0][1] == (flat[-1].numel(),), launches.calls
    torch.testing.assert_close(got.reshape(want.shape), want, rtol=0, atol=0)
    if not want.is_floating_point():
        return

    def scalar(*qs):
        return entry(*tables, *(v.reshape(1) for v in qs)).sum()

    one = [v[0] for v in flat]
    g = torch.func.grad(scalar, argnums=len(queries) - 1)(*one)
    batched = torch.func.vmap(torch.func.grad(scalar, argnums=len(queries) - 1))(*flat)
    monkeypatch.undo()
    with torch.enable_grad():
        last = flat[-1].clone().requires_grad_(True)
        (plain,) = torch.autograd.grad(entry(*tables, *flat[:-1], last).sum(), last)
    torch.testing.assert_close(batched, plain, rtol=0, atol=0)
    torch.testing.assert_close(g, plain[0], rtol=0, atol=0)


@pytest.mark.parametrize("batched", ["rhs", "diagonal"])
def test_thomas_function_vmap_is_one_launch(batched, monkeypatch):
    """K4 under ``vmap``: a batched right-hand side is more columns of the
    shared-diagonal form, a batched diagonal the per-column-diagonal form;
    one launch either way, bit for bit the loop, and ``vmap(grad)`` runs."""
    rng = np.random.default_rng(83)
    n = 10
    up, low = (torch.as_tensor(rng.normal(size=n)) for _ in range(2))
    mids = torch.as_tensor(rng.uniform(4.0, 5.0, (4, n)))
    rhs = torch.as_tensor(rng.normal(size=(4, n, 3)))
    dims = (None, 0, None, 0) if batched == "diagonal" else (None, None, None, 0)
    mid = mids if batched == "diagonal" else mids[0]
    loop = torch.stack([thomas_solve(up, mid[i] if batched == "diagonal" else mid, low, rhs[i])
                        for i in range(4)])
    launches = Launches(monkeypatch)
    got = torch.func.vmap(t_th.thomas_solve_fast, in_dims=dims)(up, mid, low, rhs)
    assert launches.names() == ["thomas_solve_fast"]
    assert torch.equal(got, loop)
    g = torch.func.vmap(torch.func.grad(lambda m, r: t_th.thomas_solve_fast(up, m, low, r).sum()),
                        in_dims=dims[1::2])(mid, rhs)
    assert g.shape == (4, n) and bool(torch.isfinite(g).all())
