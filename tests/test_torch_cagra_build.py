"""CAGRA's kNN-graph builds of the port against the JAX package, on the CPU.

The blocked scan and the overflow patch take the same packed inputs in
both packages (the JAX package's packing): their ids are equal on every
sampled row whose k-th candidate is tie-free (the f64 gap past the
expanded form's f32 error). The whole graph builds draw other random
numbers in their k-means (the port's generator is torch's), so they are
compared by quality: each package's edge recall against exact kNN agrees
within 0.01.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu_torch.neighbors.cagra as tcg_mod
from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.neighbors import cagra as jcg
from raft_tpu.neighbors import ivf_common as jic
from raft_tpu.random import make_blobs
from raft_tpu.random.rng import RngState
from raft_tpu_torch.neighbors import cagra as tcg

from torch_parity import blobs, blocked_tie_free_rows, f64_tied


def _exact_graph(x: np.ndarray, rows: np.ndarray, k: int) -> np.ndarray:
    """Exact kNN (f64, self excluded) of ``rows``, in blocks."""
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    out = []
    for a in range(0, rows.size, 512):
        r = rows[a:a + 512]
        d = sq[r, None] + sq[None, :] - 2.0 * (x64[r] @ x64.T)
        d[np.arange(r.size), r] = np.inf
        out.append(np.argsort(d, axis=1, kind="stable")[:, :k])
    return np.concatenate(out)


def _edge_recall(graph, exact, rows) -> float:
    g = np.asarray(graph)[rows]
    k = exact.shape[1]
    return float(np.mean([len(set(a[:k]) & set(b)) / k
                          for a, b in zip(g, exact)]))


def _pack(x: np.ndarray, labels, n_lists: int, L: int):
    """The JAX package's packing of ``x`` by ``labels``, as numpy."""
    xj = jnp.asarray(x)
    (packed,), pids, _, dropped, (rl, rs) = jic.pack_lists_jit(
        [xj], jnp.asarray(labels), jnp.arange(len(x), dtype=jnp.int32),
        n_lists=n_lists, L=L, fill_values=[jnp.zeros((), xj.dtype)])
    return dict(packed=np.array(packed), pids=np.array(pids),
                row_list=np.array(rl), row_slot=np.array(rs), L=L,
                dropped=int(dropped))


def _packed_inputs(x: np.ndarray, n_lists: int):
    """The JAX package's k-means, list size and packing of ``x``."""
    from raft_tpu.neighbors.ivf_flat import _fit_list_size

    km = jkb.KMeansBalancedParams(n_iters=10, metric="l2", seed=0)
    centers = jkb.fit(jnp.asarray(x), n_lists, km)
    labels = np.asarray(jkb.predict(centers, jnp.asarray(x), km))
    L = _fit_list_size(np.bincount(labels, minlength=n_lists),
                       len(x) // n_lists, 4.0)
    return dict(_pack(x, labels, n_lists, L), centers=np.array(centers))


def test_blocked_scan_matches_on_the_same_packed_inputs():
    x = blobs(20_000, 16, 64, seed=3, std=0.5)
    n_lists, T, k = 78, 4, 16
    p = _packed_inputs(x, n_lists)
    assert p["dropped"] == 0
    rs = np.clip(p["row_slot"], 0, p["L"] - 1)
    want = np.asarray(jcg._cluster_blocked_knn(
        jnp.asarray(p["packed"]), jnp.asarray(p["pids"]),
        jnp.asarray(p["centers"]), jnp.asarray(p["row_list"]),
        jnp.asarray(rs), k, n_lists, T, 8, False))
    t = {name: torch.from_numpy(p[name]) for name in
         ("packed", "pids", "centers", "row_list")}
    got = tcg._cluster_blocked_knn(t["packed"], t["pids"], t["centers"],
                                   t["row_list"], torch.from_numpy(rs), k,
                                   n_lists, T, 7, False).numpy()
    assert got.shape == want.shape == (20_000, k)
    rows = np.random.default_rng(0).choice(20_000, 400, replace=False)
    checked = blocked_tie_free_rows(x, p, rows, T, k)
    assert len(checked) > 250
    for r, ref in checked:
        assert set(got[r].tolist()) == ref == set(want[r].tolist()), r


def _overflow_data(n: int = 20_000, seed: int = 5):
    """The JAX test's overflow case: a third of the rows in one tiny ball,
    whose list overflows the 4 × mean capacity whatever the centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 50, (40, 8)).astype(np.float32)
    assign = np.where(rng.random(n) < 0.35, 0, rng.integers(1, 40, n))
    x = (centers[assign] + rng.normal(0, 0.5, (n, 8))).astype(np.float32)
    x[assign == 0] = centers[0] + rng.normal(
        0, 1e-3, (int((assign == 0).sum()), 8)).astype(np.float32)
    return x


def test_overflow_scan_matches_on_the_same_packed_inputs():
    """Blobs packed by blob id into lists of 256 slots: every blob past
    256 rows overflows, and those rows scan their own list's block."""
    rng = np.random.default_rng(4)
    centers = rng.uniform(-10, 10, (20, 8)).astype(np.float32)
    labels = rng.integers(0, 20, 8000)
    x = (centers[labels] + rng.standard_normal((8000, 8))).astype(np.float32)
    p = _pack(x, labels, 20, 256)
    over = np.nonzero(p["row_slot"] >= p["L"])[0]
    assert p["dropped"] == over.size > 1000
    rows = np.concatenate([over[:300], rng.choice(8000, 100, False)])
    lists = p["row_list"][rows]
    k = 8
    want = np.asarray(jcg._overflow_knn(
        jnp.asarray(x), jnp.asarray(p["packed"]), jnp.asarray(p["pids"]),
        jnp.asarray(rows), jnp.asarray(lists), k, False, 64))
    got = tcg._overflow_knn(
        torch.from_numpy(x), torch.from_numpy(p["packed"]),
        torch.from_numpy(p["pids"]), torch.from_numpy(rows),
        torch.from_numpy(lists), k, False, 50).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())
    n_checked = 0
    for i, r in enumerate(rows):
        cand = p["pids"][lists[i]]
        cand = cand[(cand >= 0) & (cand != r)]
        if f64_tied(((x[cand].astype(np.float64) - x[r]) ** 2).sum(-1), k,
                 scale):
            continue
        n_checked += 1
        np.testing.assert_array_equal(got[i], want[i])
    assert n_checked > 300


def _both_graphs(x, k, **kw):
    want = np.asarray(jcg.cluster_knn_graph(jnp.asarray(x), k, **kw))
    got = tcg.cluster_knn_graph(x, k, device="cpu", **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("case", ["blocked", "small"])
def test_cluster_knn_graph_quality_matches(case):
    n = 20_000 if case == "blocked" else 6_000
    x = blobs(n, 16, 64, seed=3, std=0.5)
    got, want = _both_graphs(x, 16, rows_per_list=256, neighborhood=4)
    rows = np.random.default_rng(2).choice(n, 1000, replace=False)
    exact = _exact_graph(x, rows, 16)
    r_got, r_want = (_edge_recall(g, exact, rows) for g in (got, want))
    assert abs(r_got - r_want) <= 0.01, (r_got, r_want)
    assert r_got > (0.9 if case == "blocked" else 0.999)
    assert not (got == np.arange(n)[:, None]).any()
    if case == "small":  # exact brute force in both
        np.testing.assert_array_equal(np.sort(got[rows], 1),
                                      np.sort(want[rows], 1))


def test_cluster_knn_graph_overflow_quality_matches(monkeypatch):
    x = _overflow_data()
    hits = []
    orig = tcg_mod._overflow_knn
    monkeypatch.setattr(tcg_mod, "_overflow_knn",
                        lambda *a, **k: (hits.append(1), orig(*a, **k))[1])
    got, want = _both_graphs(x, 8, rows_per_list=512, neighborhood=4)
    assert hits, "the overflow patch did not run"
    rows = np.random.default_rng(3).choice(20_000, 4000, replace=False)
    exact = _exact_graph(x, rows, 8)
    r_got, r_want = (_edge_recall(g, exact, rows) for g in (got, want))
    assert abs(r_got - r_want) <= 0.01, (r_got, r_want)


def test_ivf_pq_knn_graph_quality_matches():
    x, _ = make_blobs(3000, 24, n_clusters=30, cluster_std=1.2,
                      state=RngState(21))
    x = np.asarray(x)
    want = np.asarray(jcg.build_knn_graph(jnp.asarray(x), 10))
    got = tcg.build_knn_graph(x, 10, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    rows = np.arange(3000)
    exact = _exact_graph(x, rows, 10)
    r_got, r_want = (_edge_recall(g, exact, rows)
                     for g in (got.numpy(), want))
    assert abs(r_got - r_want) <= 0.01 and r_got >= 0.9, (r_got, r_want)


def test_ivf_pq_build_reports_the_rows_and_centers_it_searched():
    """``build(build_algo="ivf_pq")`` self-searches the full-space rows
    (the auto projection feeds only the cluster algorithm): its
    intermediates give those rows and the IVF-PQ index's coarse centers,
    the operands of its label pass (B4) and coarse select (B3)."""
    x = blobs(1500, 264, 20, seed=8, std=1.0)
    inter = {}
    index = tcg.build(x, tcg.IndexParams(
        intermediate_graph_degree=16, graph_degree=8, build_algo="ivf_pq"),
        device="cpu", intermediates=inter)
    assert torch.equal(inter["build_rows"], torch.from_numpy(x))
    n_lists = max(8, min(1024, int(np.sqrt(1500) / 2)))
    assert tuple(inter["build_centers"].shape) == (n_lists, 264)
    assert tuple(inter["knn_graph"].shape) == (1500, 16)
    assert index.centers is None and tuple(index.graph.shape) == (1500, 8)
