"""The rest of ``Comms``, 2-D meshes and the hier merge tier: the port
against the JAX package on the CPU.

Every ``Comms`` verb runs on the same per-rank numpy inputs through the
JAX package's verb inside ``shard_map`` (its CPU devices, ``tests/
conftest.py``) and through the port's verb over a mesh of CPU ranks; the
per-rank results and the ``comms.ops`` / ``comms.bytes`` counters must
agree (values exact, ``Op.PROD`` within rtol 1e-5: the JAX package takes
``exp(psum(log x))``). The hier tier: ``sharded_knn`` with the hier merge
equals the allgather merge bit for bit (ids and values) and the JAX
package's hier result (ids exact, values rtol 1e-5); its DCN bytes equal
the survivor model of ``tests/test_parallel.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import obs as jobs
from raft_tpu.core.compat import shard_map
from raft_tpu.obs.metrics import MetricsRegistry
from raft_tpu.parallel import Comms as JComms
from raft_tpu.parallel import Op as JOp
from raft_tpu.parallel import hier_mesh as jhier_mesh
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel import merge as jmerge
from raft_tpu.parallel import sharded_knn as jknn
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import mesh as tmesh
from raft_tpu_torch.parallel import merge as tmerge
from raft_tpu_torch.parallel import knn as tknn

from torch_parity import exact_knn


@pytest.fixture(autouse=True)
def _clean():
    tspans.reset()
    tcomms.reset_counters()
    yield
    jobs.disable()


def _jax_mesh(two_d: bool):
    if two_d:
        return jmake_mesh(shape=(2, 2), axis_names=("dcn", "ici"),
                          devices=jax.devices()[:4])
    return jmake_mesh(shape=(4,), axis_names=("shard",),
                      devices=jax.devices()[:4])


def _port_mesh(two_d: bool):
    if two_d:
        return tmesh.hier_mesh(2, 2, devices="cpu")
    return tmesh.make_mesh(4, device="cpu")


def _jax_run(two_d: bool, fn, *xs):
    """``fn`` over the JAX mesh on rank r's slice ``x[r]`` of each input;
    the per-rank outputs stacked on a leading rank axis (as numpy)."""
    spec = P(("dcn", "ici")) if two_d else P("shard")

    def body(*vs):
        return jax.tree.map(lambda o: jnp.asarray(o)[None],
                            fn(*[v[0] for v in vs]))

    out = shard_map(body, mesh=_jax_mesh(two_d),
                    in_specs=tuple(spec for _ in xs), out_specs=spec,
                    check_vma=False)(*[jnp.asarray(x) for x in xs])
    return jax.tree.map(np.asarray, out)


def _stack(per_rank):
    if isinstance(per_rank, tuple):
        return tuple(_stack(p) for p in per_rank)
    return np.stack([t.numpy() for t in per_rank])


rng = np.random.default_rng(5)
X = (rng.random((4, 8, 3)) + 0.5).astype(np.float32)     # per rank [8, 3]
CAP = 4
GV = np.full((4, CAP, 2), -1.0, np.float32)
GV_COUNTS = np.array([1, 3, 2, 4], np.int32)
for _r in range(4):
    GV[_r, :GV_COUNTS[_r]] = 10 * _r + np.arange(GV_COUNTS[_r])[:, None]
PERM = [(0, 2), (2, 1), (1, 0)]

# name → (2-D mesh?, axis, jax fn(comms, *v), port fn(comms, *xs), inputs)
VERBS = {
    "allreduce_sum": (False, "shard", lambda c, v: c.allreduce(v, JOp.SUM),
                      lambda c, x: c.allreduce(x, tcomms.Op.SUM), (X,)),
    "allreduce_prod": (False, "shard",
                       lambda c, v: c.allreduce(v, JOp.PROD),
                       lambda c, x: c.allreduce(x, tcomms.Op.PROD), (X,)),
    "allreduce_min": (False, "shard", lambda c, v: c.allreduce(v, JOp.MIN),
                      lambda c, x: c.allreduce(x, tcomms.Op.MIN), (X,)),
    "allreduce_max": (False, "shard", lambda c, v: c.allreduce(v, JOp.MAX),
                      lambda c, x: c.allreduce(x, tcomms.Op.MAX), (X,)),
    "reduce": (False, "shard", lambda c, v: c.reduce(v, root=1),
               lambda c, x: c.reduce(x, root=1), (X,)),
    "bcast": (False, "shard", lambda c, v: c.bcast(v, root=2),
              lambda c, x: c.bcast(x, root=2), (X,)),
    "allgather": (False, "shard", lambda c, v: c.allgather(v),
                  lambda c, x: c.allgather(x), (X,)),
    "allgather_tiled_axis1": (
        False, "shard", lambda c, v: c.allgather(v, axis=1, tiled=True),
        lambda c, x: c.allgather(x, axis=1, tiled=True), (X,)),
    "gather": (False, "shard", lambda c, v: c.gather(v, root=3, axis=1),
               lambda c, x: c.gather(x, root=3, axis=1), (X,)),
    "allgatherv": (False, "shard", lambda c, v, n: c.allgatherv(v, n),
                   lambda c, x, n: c.allgatherv(x, n), (GV, GV_COUNTS)),
    "allgatherv_raw": (
        False, "shard", lambda c, v, n: c.allgatherv(v, n, compact=False),
        lambda c, x, n: c.allgatherv(x, n, compact=False), (GV, GV_COUNTS)),
    "gatherv": (False, "shard", lambda c, v, n: c.gatherv(v, n, root=1),
                lambda c, x, n: c.gatherv(x, n, root=1), (GV, GV_COUNTS)),
    "reducescatter": (False, "shard", lambda c, v: c.reducescatter(v),
                      lambda c, x: c.reducescatter(x), (X,)),
    "alltoall": (False, "shard", lambda c, v: c.alltoall(v),
                 lambda c, x: c.alltoall(x), (X,)),
    "alltoall_axes": (
        False, "shard", lambda c, v: c.alltoall(v.T, split_axis=1,
                                                concat_axis=0),
        lambda c, x: c.alltoall([t.T.contiguous() for t in x],
                                split_axis=1, concat_axis=0),
        (np.ascontiguousarray(np.tile(X, (1, 1, 4))[:, :4]),)),
    "ppermute": (False, "shard", lambda c, v: c.ppermute(v, PERM),
                 lambda c, x: c.ppermute(x, PERM), (X,)),
    "send_recv_ring": (False, "shard", lambda c, v: c.send_recv_ring(v, 3),
                       lambda c, x: c.send_recv_ring(x, 3), (X,)),
    "ring_topk_hop": (False, "shard", lambda c, v: c.ring_topk_hop(v, v),
                      lambda c, x: c.ring_topk_hop(x, x), (X,)),
    "ici_allreduce": (True, "ici", lambda c, v: c.allreduce(v),
                      lambda c, x: c.allreduce(x), (X,)),
    "dcn_alltoall": (True, "dcn", lambda c, v: c.alltoall(v),
                     lambda c, x: c.alltoall(x), (X,)),
    "world_allgather": (True, ("dcn", "ici"), lambda c, v: c.allgather(v),
                        lambda c, x: c.allgather(x), (X,)),
    "world_allreduce": (True, ("dcn", "ici"), lambda c, v: c.allreduce(v),
                        lambda c, x: c.allreduce(x), (X,)),
    "split_ici_ring": (True, ("dcn", "ici"),
                       lambda c, v: c.comm_split("ici").send_recv_ring(v),
                       lambda c, x: c.comm_split("ici").send_recv_ring(x),
                       (X,)),
}


def _counters_jax(reg):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("comms.")}


def _counters_port():
    c = tcomms.counters()
    out = {}
    for kind in ("ops", "bytes"):
        for (op, axis), v in c[kind].items():
            out[f"comms.{kind}{{axis={axis},op={op}}}"] = float(v)
    return out


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_comms_verb_matches_jax(verb):
    two_d, axis, jfn, tfn, inputs = VERBS[verb]
    reg = MetricsRegistry()
    jobs.enable(registry=reg, hbm=False)
    try:
        jc = JComms(axis)
        want = _jax_run(two_d, lambda *v: jfn(jc, *v), *inputs)
    finally:
        jobs.disable()
    mesh = _port_mesh(two_d)
    tc = tcomms.Comms(mesh, axis)
    per_rank = [[torch.from_numpy(np.ascontiguousarray(x[r]))
                 for r in range(4)] for x in inputs]
    if verb.startswith(("allgatherv", "gatherv")):
        per_rank[1] = [torch.tensor(int(n), dtype=torch.int32)
                       for n in inputs[1]]
    got = _stack(tfn(tc, *per_rank))
    rtol = 1e-5 if verb == "allreduce_prod" else 0
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape, (verb, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=verb)
    assert _counters_port() == _counters_jax(reg), verb


def test_rank_size_and_sync_stream():
    mesh = tmesh.hier_mesh(2, 2, devices="cpu")
    world = tcomms.Comms(mesh)
    assert world.axis_name == ("dcn", "ici") and world.get_size() == 4
    assert world.get_rank() == [0, 1, 2, 3]
    assert world.comm_split("ici").get_rank() == [0, 1, 0, 1]
    assert world.comm_split("dcn").get_rank() == [0, 0, 1, 1]
    assert world.sync_stream() == tcomms.Status.SUCCESS


# ---------------------------------------------------------------------------
# 2-D meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("hier", (4, 2), {"axis_names": ("fast", "ici")},
     "slow axis must be outermost"),
    ("hier", (4, 2), {"axis_names": ("dcn", "pod2")}, "DCN-labeled"),
    ("hier", (0, 2), {}, ">= 1"),
    ("hier", (4, 2), {"devices": ["cpu"] * 7}, "needs 8 devices"),
    ("sub", (8, ("ici", "dcn")), {"shape": (2, 4)},
     "slow axis must be outermost"),
    ("sub", (8, ("dcn", "ici")), {}, "explicit shape"),
    ("sub", (8, ("dcn", "ici")), {"shape": (2, 2)}, "covers 4"),
    ("sub", (16, ("shard",)), {}, "from a 8-device mesh"),
], ids=lambda c: f"{c[0]}-{c[3].split()[0]}")
def test_mesh_validation_matches_jax(case):
    """The JAX package's naming rules and messages, raised by both."""
    kind, args, kw, msg = case
    jfull = jmake_mesh(devices=jax.devices()[:8])
    tfull = tmesh.make_mesh(8, device="cpu")
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match=msg):
            if kind == "hier":
                kw2 = dict(kw)
                if pkg == "jax" and "devices" in kw2:
                    kw2["devices"] = jax.devices()[:7]
                elif pkg == "port":
                    kw2.setdefault("devices", "cpu")
                (jhier_mesh if pkg == "jax" else tmesh.hier_mesh)(*args,
                                                                  **kw2)
            elif pkg == "jax":
                from raft_tpu.parallel import submesh as jsub

                jsub(jfull, *args, **kw)
            else:
                tmesh.submesh(tfull, *args, **kw)


def test_submesh_and_hier_mesh_layout():
    full = tmesh.make_mesh(8, device="cpu")
    m2 = tmesh.submesh(full, 8, ("dcn", "ici"), shape=(2, 4))
    assert m2.axis_sizes == {"dcn": 2, "ici": 4}
    assert m2.groups(("ici",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m2.groups(("dcn",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert tmesh.submesh(full, 3).size == 3
    h = tmesh.hier_mesh(2, 3, devices=full)
    assert h.shape == (3, 2) and h.axis_names == ("dcn", "ici")
    assert [tmesh.is_dcn_axis(a) for a in ("dcn", "Pod1", "slice", "ici",
                                           3)] == [True, True, True, False,
                                                   False]
    assert tmesh.HIER_AXIS_NAMES == ("dcn", "ici")


# ---------------------------------------------------------------------------
# the hier tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def knn_case():
    r = np.random.default_rng(7)
    return (r.random((1024, 16), dtype=np.float32),
            r.random((96, 16), dtype=np.float32))


@pytest.mark.parametrize("dcn_size,ici_size", [(2, 4), (4, 2), (2, 2)])
def test_hier_equals_allgather_and_jax(knn_case, dcn_size, ici_size):
    x, q = knn_case
    n = dcn_size * ici_size
    fv, fi = tknn.sharded_knn(x, q, 10, tmesh.make_mesh(n, device="cpu"),
                              merge="allgather")
    mesh2 = tmesh.hier_mesh(ici_size, dcn_size, devices="cpu")
    hv, hi = tknn.sharded_knn(x, q, 10, mesh2, axis=("dcn", "ici"))
    assert torch.equal(fi, hi) and torch.equal(fv, hv)
    assert tspans.counts()["parallel.merge.dispatch"]["hier"] == 1
    jv, ji = jknn(jnp.asarray(x), jnp.asarray(q), 10,
                  jhier_mesh(ici_size, dcn_size,
                             devices=jax.devices()[:n]),
                  axis=("dcn", "ici"))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(hv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(hi.numpy(), exact_knn(x, q, 10))


def test_hier_dcn_bytes_match_survivor_model(knn_case):
    """The outer stage ships k survivors per pod for each rank's owned
    sub-chunk: ``n_outer · (mc / n_outer) · k`` f32 values and int32 ids a
    rank, on the dcn axis only; the inner ring counts on ici — the JAX
    package's counters, key for key."""
    x, q = knn_case
    m, k, n_inner, n_outer = 96, 10, 4, 2
    tknn.sharded_knn(x, q, k, tmesh.hier_mesh(n_inner, n_outer,
                                              devices="cpu"),
                     axis=("dcn", "ici"))
    c = tcomms.counters()["bytes"]
    mc = tmerge.hier_chunk_rows(m, n_inner, n_outer)
    assert c[("alltoall", "dcn")] == n_outer * (mc // n_outer) * k * 8
    assert c[("ring_topk", "ici")] > 0
    assert set(a for _, a in c) == {"dcn", "ici"}
    reg = MetricsRegistry()
    jobs.enable(registry=reg, hbm=False)
    try:
        jknn(jnp.asarray(x), jnp.asarray(q), k,
             jhier_mesh(n_inner, n_outer, devices=jax.devices()[:8]),
             axis=("dcn", "ici"))
    finally:
        jobs.disable()
    assert _counters_port() == _counters_jax(reg)


def test_hier_env_off_falls_back_flat(knn_case, monkeypatch):
    x, q = knn_case
    monkeypatch.setenv("RAFT_TPU_HIER_MERGE", "off")
    mesh2 = tmesh.hier_mesh(4, 2, devices="cpu")
    fv, fi = tknn.sharded_knn(x[:256], q[:16], 5, mesh2,
                              axis=("dcn", "ici"))
    assert "hier" not in tspans.counts()["parallel.merge.dispatch"]
    hv, hi = tknn.sharded_knn(x[:256], q[:16], 5, mesh2,
                              axis=("dcn", "ici"), merge="hier")
    assert torch.equal(fi, hi)


def test_merge_tier_hier_decisions_match_jax(monkeypatch):
    axes = ("dcn", "ici", 2, 4)
    for env in ("auto", "on", "off"):
        monkeypatch.setenv("RAFT_TPU_HIER_MERGE", env)
        for explicit in (None, "auto", "hier", "ring", "allgather"):
            for m in (8, 96, 500):
                want = jmerge.merge_tier(8, m, 10, explicit=explicit,
                                         whole_mesh=False, hier_axes=axes)
                got = tmerge.merge_tier(8, m, 10, explicit=explicit,
                                        whole_mesh=False, hier_axes=axes)
                assert got == want, (env, explicit, m)
    with pytest.raises(LogicError, match="hier"):
        tmerge.merge_tier(8, 256, 10, explicit="hier")
    for m, ni, no in ((96, 4, 2), (500, 2, 2), (7, 2, 4), (1000, 8, 3)):
        assert tmerge.hier_chunk_rows(m, ni, no) == jmerge.hier_chunk_rows(
            m, ni, no)
        assert tmerge.merged_rows("hier", m, ni, no) == jmerge.merged_rows(
            "hier", m, ni, no)


def test_exchange_axes_are_validated():
    mesh2 = tmesh.hier_mesh(2, 2, devices="cpu")
    assert tmerge.resolve_exchange(mesh2, ("dcn", "ici")) == (
        4, False, ("dcn", "ici", 2, 2))
    # one axis of a 2-D mesh exchanges over that axis alone
    assert tmerge.resolve_exchange(mesh2, "ici") == (2, False, None)
    with pytest.raises(LogicError, match="not an axis of the mesh"):
        tmerge.resolve_exchange(mesh2, "shard")
    with pytest.raises(LogicError, match="in its order"):
        tmerge.resolve_exchange(mesh2, ("ici", "dcn"))
    flat = tmesh.make_mesh(4, device="cpu")
    with pytest.raises(LogicError):
        tmerge.resolve_exchange(flat, ("dcn", "ici"))


def test_replicated_knn_over_a_2d_axis(knn_case):
    x, q = knn_case
    mesh2 = tmesh.hier_mesh(2, 2, devices="cpu")
    _, ri = tknn.replicated_knn(x, q, 10, mesh2, axis=("dcn", "ici"))
    np.testing.assert_array_equal(ri.numpy(), exact_knn(x, q, 10))
