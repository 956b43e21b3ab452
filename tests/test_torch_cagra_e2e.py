"""CAGRA of the port against the JAX package, on the CPU: the slice as a
whole. Each package builds its own index from the same seeded rows (their
k-means draw different random numbers from one seed) and searches it: the
recall@10 of the two agree within 0.01. The build projection of wide rows
(d > 256) is the JAX package's within 1e-5; a build and a search record
the same ``span.cagra.*`` series in both packages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcg
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.neighbors import cagra as tcg

from torch_parity import blobs, exact_knn


def _search_recall(pkg, index, q, gt, conv, **dev):
    _, ids = pkg.search(index, conv(q), 10, pkg.SearchParams(), **dev)
    ids = np.asarray(ids)
    return float(np.mean([len(set(a) & set(b)) / 10
                          for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("case", ["blocked", "projected"])
def test_build_quality_matches(case):
    """The slice end to end: each package builds from the same rows (the
    default cluster algorithm; "projected": d > 256 takes the random 128-d
    basis and full-space entry centers) and searches its own index."""
    if case == "blocked":
        x = blobs(20_000, 16, 64, seed=3, std=0.5)
        q = blobs(200, 16, 64, seed=4, std=0.5)
        kw = dict(intermediate_graph_degree=32, graph_degree=16,
                  knn_rows_per_list=256)
    else:
        x = blobs(17_000, 264, 40, seed=6, std=1.0)
        q = blobs(100, 264, 40, seed=7, std=1.0)
        kw = dict(intermediate_graph_degree=32, graph_degree=16,
                  knn_rows_per_list=512)
    ji = jcg.build(jnp.asarray(x), jcg.IndexParams(**kw))
    stages, inter = {}, {}
    ti = tcg.build(x, tcg.IndexParams(**kw), device="cpu",
                   stage_seconds=stages, intermediates=inter)
    assert ti.graph.shape == ji.graph.shape and ti.graph.dtype == torch.int32
    assert ti.centers.shape == ji.centers.shape
    assert ti.entry_ids.shape == ji.entry_ids.shape
    gt = exact_knn(x, q, 10)
    r_t = _search_recall(tcg, ti, q, gt, torch.from_numpy, device="cpu")
    r_j = _search_recall(jcg, ji, q, gt, jnp.asarray)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert r_t >= (0.9 if case == "blocked" else 0.7), r_t
    assert {"knn_graph", "kmeans_fit", "kmeans_predict", "pack",
            "blocked_scan", "entries", "optimize"} <= set(stages)
    assert ("projection" in stages) == (case == "projected")
    assert tuple(inter["knn_graph"].shape) == (len(x), 32)
    assert inter["build_rows"].shape[1] == (128 if case == "projected"
                                            else 16)
    assert tuple(inter["build_centers"].shape) == (
        ti.centers.shape[0], inter["build_rows"].shape[1])
    # every row's first edges come from its intermediate list
    g, knn = ti.graph.numpy(), inter["knn_graph"].numpy()
    assert all(set(a[:8]) <= set(b) for a, b in zip(g, knn))


def test_build_projection_matches():
    got = tcg._build_projection(272, 128, 0, "cpu").numpy()
    g = jax.random.normal(jax.random.PRNGKey(0 ^ 0x5EED), (272, 128),
                          jnp.float32)
    want = np.asarray(jnp.linalg.qr(g)[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.T @ got, np.eye(128), atol=1e-5)


def test_the_same_build_and_search_give_the_same_cagra_spans():
    """The JAX package's small-corpus build also records
    ``brute_force.build``: the port's brute force has no index object
    (ROADMAP A4), so that one span is the JAX package's alone."""
    x = blobs(2000, 16, 20, seed=8)
    out = []
    for pkg, obs_mod, conv, dev in ((jcg, None, jnp.asarray, {}),
                                    (tcg, tobs, torch.from_numpy,
                                     {"device": "cpu"})):
        if obs_mod is None:
            from raft_tpu import obs as obs_mod
        reg = obs_mod.MetricsRegistry()
        obs_mod.enable(registry=reg)
        try:
            idx = pkg.build(conv(x), pkg.IndexParams(
                intermediate_graph_degree=16, graph_degree=8,
                quantize_dataset=True), **dev)
            pkg.search(idx, conv(x[:20]), 5, **dev)
        finally:
            obs_mod.disable()
        out.append({n: h["count"] for n, h in reg.snapshot()[
            "histograms"].items() if n.startswith("span.cagra.")
            and not n.endswith(".brute_force.build")})
    assert out[0] == out[1]
    assert {"span.cagra.build", "span.cagra.build.knn_graph",
            "span.cagra.build.optimize", "span.cagra.build.quantize",
            "span.cagra.search"} <= set(out[1])


def test_nn_descent_is_not_ported():
    """CAGRA's NN-Descent build runs on the CPU (the name is kept from the
    refusal this test once checked): the graph passes the invariants —
    [n, 16] int32, ids in [0, n) or −1, no row holding its own id, each
    row's first 8 edges among its 32 intermediate ones — and the index has
    no entries, so search seeds at random."""
    x = blobs(3000, 16, 30, seed=9)
    inter, stages = {}, {}
    idx = tcg.build(x, tcg.IndexParams(
        intermediate_graph_degree=32, graph_degree=16,
        build_algo="nn_descent", nn_descent_niter=6), device="cpu",
        intermediates=inter, stage_seconds=stages)
    g, knn = idx.graph.numpy(), inter["knn_graph"].numpy()
    assert g.shape == (3000, 16) and idx.graph.dtype == torch.int32
    assert ((g >= -1) & (g < 3000)).all()
    assert not (g == np.arange(3000)[:, None]).any()
    assert all(set(a[:8]) <= set(b) for a, b in zip(g, knn))
    assert idx.centers is None and idx.entry_ids is None
    assert {"knn_graph", "optimize"} <= set(stages)
    gt = exact_knn(x, x[:100], 10)
    assert _search_recall(tcg, idx, x[:100], gt, torch.from_numpy,
                          device="cpu") >= 0.9
