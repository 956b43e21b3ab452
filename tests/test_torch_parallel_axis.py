"""A search over one axis of a 2-D mesh: the port against the JAX package,
on the CPU.

The JAX package runs on a 2 × 4 mesh of its 8 CPU devices
(``tests/conftest.py``), axes ("dcn", "ici"); the port on
``hier_mesh(4, 2, devices="cpu")``, the same grid (rank = dcn·4 + ici).
Over ``axis="ici"`` the data shard 4 ways and replicate over "dcn"; over
``axis="dcn"`` 2 ways, replicated over "ici". A sub-axis is not the whole
mesh, so the ring takes ``ring_ppermute`` in both packages.

Exact: sharded kNN ids (values rtol 1e-5), the merge dispatch counter, the
comms counters under the axis, the distributed k-means' iteration count
(centroids atol 1e-4). A JAX-built sharded IVF-PQ index crosses to the
port over the same axis (``from_numpy(..., axis=)``) and is searched by
both, unrefined under the allgather and refined under the ring: ids equal
away from value ties within rtol 1e-4, values rtol 1e-4. The port's own
one-axis builds (IVF-PQ, IVF-Flat) equal its builds on a 1-D mesh of the
axis's size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.obs.metrics import MetricsRegistry
from raft_tpu.parallel import make_mesh as jmake_mesh

from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import hier_mesh, make_mesh
from raft_tpu_torch.parallel import ivf as tivf

from torch_parity import (assert_ids_match_away_from_ties, blobs,
                          exact_knn, jax_sharded_pq_arrays)

AXES = ("dcn", "ici")


def _jmesh():
    return jmake_mesh(shape=(2, 4), axis_names=AXES,
                      devices=jax.devices()[:8])


def _tmesh():
    return hier_mesh(4, 2, devices="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2048, 16)).astype(np.float32)
    q = rng.standard_normal((27, 16)).astype(np.float32)
    return x, q


def _jax_counted(fn):
    reg = MetricsRegistry()
    jobs.enable(registry=reg, hbm=False)
    try:
        out = fn()
    finally:
        jobs.disable()
    return out, reg.snapshot()["counters"]


@pytest.mark.parametrize("axis", ["ici", "dcn"])
@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_sharded_knn_over_one_axis_matches_jax(data, axis, merge):
    from raft_tpu.parallel import sharded_knn as jknn
    from raft_tpu_torch.parallel import sharded_knn as tknn

    x, q = data
    (jv, ji), jc = _jax_counted(lambda: jknn(
        jnp.asarray(x), jnp.asarray(q), 10, _jmesh(), axis=axis,
        merge=merge))
    tcomms.reset_counters()
    tspans.reset()
    tv, ti = tknn(x, q, 10, _tmesh(), axis=axis, merge=merge)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), exact_knn(x, q, 10))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    impl = "ring_ppermute" if merge == "ring" else "allgather"
    assert jc[f"parallel.merge.dispatch{{impl={impl}}}"] == 1
    assert tspans.counts()["parallel.merge.dispatch"] == {impl: 1.0}
    op = "ring_topk" if merge == "ring" else "allgather"
    tc = tcomms.counters()
    assert set(tc["ops"]) == {(op, axis)}
    assert tc["ops"][(op, axis)] == jc[f"comms.ops{{axis={axis},op={op}}}"]
    assert tc["bytes"][(op, axis)] == jc[
        f"comms.bytes{{axis={axis},op={op}}}"]


@pytest.mark.parametrize("axis", ["ici", "dcn"])
def test_distributed_kmeans_over_one_axis_matches_jax(axis):
    from raft_tpu.cluster import KMeansParams as JParams
    from raft_tpu.cluster import distributed as jdkm
    from raft_tpu_torch.cluster import distributed as tdkm
    from raft_tpu_torch.cluster.kmeans import KMeansParams

    x = blobs(1001, 12, 6, seed=2)       # ragged: zero-weight padding
    init = x[[3, 200, 400, 600, 800, 1000]].copy()
    p = dict(n_clusters=6, max_iter=30, tol=1e-4)
    jc, jin, jit = jdkm.fit(JParams(**p), jnp.asarray(x), _jmesh(),
                            axis=axis, init_centroids=jnp.asarray(init))
    tc, tin, tit = tdkm.fit(KMeansParams(**p), x, _tmesh(), axis=axis,
                            init_centroids=init)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    assert tit == int(jit)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-4)
    np.testing.assert_array_equal(
        tdkm.predict(tc, x, _tmesh(), axis=axis).numpy(),
        np.asarray(jdkm.predict(jc, jnp.asarray(x), _jmesh(), axis=axis)))


@pytest.fixture(scope="module")
def pq_case(data):
    """A JAX-built IVF-PQ index sharded 4 ways over "ici"."""
    from raft_tpu.neighbors import ivf_pq as jpq
    from raft_tpu.parallel import build_ivf_pq as jbuild

    x, _ = data
    kw = dict(n_lists=16, pq_dim=8, pq_bits=8, kmeans_n_iters=5)
    return kw, jbuild(jpq.IndexParams(**kw), jnp.asarray(x), _jmesh(),
                      axis="ici")


PQ_SEARCHES = {
    "unrefined_allgather": (dict(n_probes=6, lut_dtype="float32"),
                            "allgather"),
    "refined_ring": (dict(n_probes=6, lut_dtype="float32",
                          refine="f32_regen", refine_ratio=3.0,
                          scan_mode="per_query"), "ring"),
}


@pytest.mark.parametrize("case", sorted(PQ_SEARCHES))
def test_crossed_pq_index_over_one_axis_agrees(data, pq_case, case):
    from raft_tpu.neighbors import ivf_pq as jpq
    from raft_tpu.parallel import search_ivf_pq as jsearch
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    x, q = data
    _, jidx = pq_case
    sp, merge = PQ_SEARCHES[case]
    arrays, meta = jax_sharded_pq_arrays(jidx)
    assert arrays["packed_codes"].shape[0] == 4
    mesh = _tmesh()
    tidx = tivf.from_numpy(arrays, meta, mesh, axis="ici")
    assert tidx.n_shards == 4 and len(tidx.packed_codes) == 8
    refined = "refine" in sp
    jv, ji = jsearch(jpq.SearchParams(**sp), jidx, jnp.asarray(q), 10,
                     _jmesh(), axis="ici", merge=merge,
                     dataset=jnp.asarray(x) if refined else None)
    tv, ti = tivf.search_ivf_pq(tpq.SearchParams(**sp), tidx, q, 10, mesh,
                                axis="ici", merge=merge,
                                dataset=x if refined else None)
    assert_ids_match_away_from_ties(ti.numpy(), tv.numpy(), np.asarray(ji),
                                    np.asarray(jv))
    back, _ = tivf.to_numpy(tidx)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)


def test_one_axis_builds_equal_a_1d_mesh_of_that_axis(data):
    """The port's builds over "ici" (replicated over "dcn") give the lists
    of the same build on a 1-D mesh of 4 ranks, and each "dcn" group's
    merged answer is that mesh's; an index searched over another axis than
    its own is refused."""
    from raft_tpu_torch.core.errors import LogicError
    from raft_tpu_torch.neighbors import ivf_flat as tflat
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    x, q = data
    m2, m1 = _tmesh(), make_mesh(4, device="cpu", axis_name="ici")
    p = tpq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=5)
    a2, _ = tivf.to_numpy(tivf.build_ivf_pq(p, x, m2, axis="ici"))
    a1, _ = tivf.to_numpy(tivf.build_ivf_pq(p, x, m1, axis="ici"))
    for name in a1:
        np.testing.assert_array_equal(a2[name], a1[name])
    fp = tflat.IndexParams(n_lists=16, kmeans_n_iters=5)
    f2 = tivf.build_ivf_flat(fp, x, m2, axis="ici")
    f1 = tivf.build_ivf_flat(fp, x, m1, axis="ici")
    sp = tflat.SearchParams(n_probes=8)
    for merge in ("allgather", "ring"):
        v2, i2 = tivf.search_ivf_flat(sp, f2, q, 10, m2, axis="ici",
                                      merge=merge)
        v1, i1 = tivf.search_ivf_flat(sp, f1, q, 10, m1, axis="ici",
                                      merge=merge)
        assert torch.equal(i2, i1) and torch.equal(v2, v1)
    with pytest.raises(LogicError, match="sharded over 4 ranks"):
        tivf.search_ivf_flat(sp, f2, q, 10, m2, axis="dcn")


def test_a_whole_mesh_index_searches_over_both_axes(data):
    """An index built over a 1-D mesh of the same 4 ranks searches over
    the 2-D mesh's (dcn, ici) axes, as ``[shard hier]`` runs it: the
    search reads the index's own layout (rank order both ways), and the
    hier tier's ids equal the 1-D allgather's."""
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    x, q = data
    m1 = make_mesh(4, device="cpu")
    idx = tivf.build_ivf_pq(tpq.IndexParams(n_lists=16, pq_dim=8,
                                            kmeans_n_iters=5), x, m1)
    sp = tpq.SearchParams(n_probes=6, lut_dtype="float32",
                          refine="f32_regen", refine_ratio=3.0,
                          scan_mode="per_query")
    v1, i1 = tivf.search_ivf_pq(sp, idx, q, 10, m1, dataset=x,
                                merge="allgather")
    v2, i2 = tivf.search_ivf_pq(sp, idx, q, 10,
                                hier_mesh(2, 2, devices="cpu"), axis=AXES,
                                dataset=x, merge="hier")
    assert torch.equal(v2, v1) and torch.equal(i2, i1)
