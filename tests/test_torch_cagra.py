"""CAGRA of the port against the JAX package, on the CPU: the integer
graph work, the seeds, the traversal search and the files.

JAX-built indexes cross to the port through ``cagra.from_numpy`` and both
packages search them on the same seeded numpy queries (the port with
``device="cpu"``). Two indexes: the JAX test's 3,000 × 24 blobs (the
small-corpus build: no entries, random seeds) and 20,000 × 16 blobs with
``knn_rows_per_list`` 256 (the blocked build: cluster-seeded entries, and
int8 rows).

Tolerances: ``optimize_graph``, ``_drop_self_edges``, the batched seed
draws, the int8 codes and the hnswlib file equal bit for bit; the int8
scale and zero within 1 ulp; search ids equal away from f32 distance
ties and distances within 1e-5 relative (atol 1e-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import bitset as jbs
from raft_tpu.core import serialize as jser
from raft_tpu.neighbors import cagra as jcg
from raft_tpu.random import make_blobs
from raft_tpu.random.rng import RngState
from raft_tpu_torch.neighbors import cagra as tcg
from raft_tpu_torch.random import threefry as ttf

from torch_parity import (assert_ids_match_away_from_ties, blobs,
                          filter_keep, jax_cagra_arrays,
                          jax_cagra_from_arrays)

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def small():
    """The JAX test's corpus and index (3,000 × 24, degrees 48 / 24)."""
    x, _ = make_blobs(3000, 24, n_clusters=30, cluster_std=1.2,
                      state=RngState(21))
    q, _ = make_blobs(80, 24, n_clusters=30, cluster_std=1.2,
                      state=RngState(22))
    x, q = np.asarray(x), np.asarray(q)
    index = jcg.build(jnp.asarray(x), jcg.IndexParams(
        intermediate_graph_degree=48, graph_degree=24, seed=0))
    return x, q, index


@pytest.fixture(scope="module")
def blocked():
    """20,000 × 16 blobs, the blocked build with entries and int8 rows."""
    x = blobs(20_000, 16, 64, seed=3, std=0.5)
    q = blobs(300, 16, 64, seed=4, std=0.5)
    index = jcg.build(jnp.asarray(x), jcg.IndexParams(
        intermediate_graph_degree=32, graph_degree=16, knn_rows_per_list=256,
        quantize_dataset=True, seed=0))
    return x, q, index


def _port(index):
    return tcg.from_numpy(*jax_cagra_arrays(index), device="cpu")


def _assert_search_match(td, ti, jd, ji):
    ti, td = ti.numpy(), td.numpy()
    ji, jd = np.asarray(ji), np.asarray(jd)
    assert ti.dtype == ji.dtype == np.int32
    assert_ids_match_away_from_ties(ti, td, ji, jd, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# integer graph work: bit for bit
# ---------------------------------------------------------------------------

def _graph_with_repeats_and_a_hub(n: int, D: int, seed: int) -> np.ndarray:
    """A kNN-like table: near ids first, some rows repeating ids (a tenth
    of them a whole repeated block), node 7 in the forward half of a third
    of the rows (a hub receiving far more than D // 2 reverse edges)."""
    rng = np.random.default_rng(seed)
    g = (np.arange(n)[:, None] + rng.integers(1, 6 * D, (n, D))) % n
    g = np.sort(g, axis=1)  # ids repeat where draws collide
    rows = rng.choice(n, n // 10, replace=False)
    g[rows, D // 2:] = g[rows, :D - D // 2]  # repeated blocks
    hub = rng.choice(n, n // 3, replace=False)
    g[hub, rng.integers(0, D // 4, hub.size)] = 7
    return g.astype(np.int32)


def _with_minus_one_edges(g: np.ndarray, seed: int) -> np.ndarray:
    """−1 edges as the cluster build leaves them: first in a twentieth of
    the rows (always in the pruned forward half), in the middle of some,
    and filling the last quarter of others (short neighbourhoods)."""
    rng = np.random.default_rng(seed)
    n, D = g.shape
    g = g.copy()
    g[rng.choice(n, n // 20, replace=False), 0] = -1
    g[rng.choice(n, n // 20, replace=False), D // 2] = -1
    g[rng.choice(n, n // 20, replace=False), D - D // 4:] = -1
    return g


@pytest.mark.parametrize("minus_one", [False, True])
@pytest.mark.parametrize("n,D,out", [(600, 16, 8), (3000, 48, 24),
                                     (2000, 32, 32)])
def test_optimize_graph_is_bit_exact(n, D, out, minus_one):
    """Bit for bit. With −1 edges the detour counts still are (a −1 reads
    row n − 1's list in both packages), and so are the forward halves;
    only the JAX package's scatter differs: it wraps a −1 forward edge to
    row n − 1 and writes its source into that row's first reverse slot,
    where the port adds no reverse edge. So row n − 1's reverse half is
    held to its real incoming edges instead."""
    g = _graph_with_repeats_and_a_hub(n, D, seed=n)
    if minus_one:
        g = _with_minus_one_edges(g, seed=n + 1)
    want = np.asarray(jcg.optimize_graph(jnp.asarray(g), out))
    got = tcg.optimize_graph(torch.from_numpy(g), out, device="cpu").numpy()
    assert got.dtype == np.int32
    h = out // 2
    fwd = g[:, :h]
    assert (fwd == 7).any(1).sum() > h  # the hub overflows its quota
    assert (want == 7).any(1).sum() >= h
    if not minus_one:
        np.testing.assert_array_equal(got, want)
        return
    assert (want[:, :h] == -1).any(1).sum() >= n // 20
    np.testing.assert_array_equal(got[:, :h], want[:, :h])
    np.testing.assert_array_equal(got[:-1], want[:-1])
    # row n − 1: its reverse slots hold the rows whose forward half has
    # n − 1, in id order, then the same fallback edges as the JAX row
    srcs = np.nonzero((want[:, :h] == n - 1).any(1))[0][:h]
    np.testing.assert_array_equal(got[-1, h:h + srcs.size], srcs)
    rest = h + max(srcs.size, 1)
    np.testing.assert_array_equal(got[-1, rest:], want[-1, rest:])


def test_optimize_graph_of_a_built_graph_is_bit_exact(small):
    x, _, _ = small
    knn = jcg.cluster_knn_graph(jnp.asarray(x), 48)
    want = np.asarray(jcg.optimize_graph(knn, 24))
    got = tcg.optimize_graph(torch.from_numpy(np.array(knn)), 24,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_drop_self_edges_is_bit_exact():
    rng = np.random.default_rng(5)
    n, k = 500, 12
    t = rng.integers(0, n, (n, k + 3)).astype(np.int32)
    t[np.arange(0, n, 3), rng.integers(0, k + 3, n)[::3]] = np.arange(0, n, 3)
    t[np.arange(1, n, 7), 0] = np.arange(1, n, 7)
    t[np.arange(1, n, 7), -1] = np.arange(1, n, 7)  # self twice
    want = np.asarray(jcg._drop_self_edges(jnp.asarray(t), n, k))
    got = tcg._drop_self_edges(torch.from_numpy(t), n, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_rows_matches():
    x = blobs(4000, 24, 20, seed=9, std=2.0)
    x[:, 3] = 1.5  # a constant column: scale at its floor
    jc, js, jz = (np.asarray(a) for a in jcg._quantize_rows(jnp.asarray(x)))
    tc, ts, tz = (a.numpy() for a in tcg._quantize_rows(torch.from_numpy(x)))
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == np.int8
    for got, want in ((ts, js), (tz, jz)):
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= ulp).all()


# ---------------------------------------------------------------------------
# seeds: one key a query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3000, 20_000, 123_457, 1_000_000])
def test_batched_seed_draws_equal_jax(n):
    start = 2_000_000_000
    qidx = jnp.uint32(start) + jnp.arange(1000, dtype=jnp.uint32)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(11), i))(qidx)
    want = np.asarray(jax.vmap(lambda kk: jax.random.randint(
        kk, (384,), 0, n, dtype=jnp.int32))(keys))
    words = ttf.fold_in_rows(ttf.prng_key(11), torch.arange(
        start, start + 1000))
    np.testing.assert_array_equal(
        np.stack([w.numpy() for w in words], 1).astype(np.uint32),
        np.asarray(keys))
    got = ttf.randint_rows(words, 384, 0, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# search on a JAX-built index
# ---------------------------------------------------------------------------

SEARCHES = {
    "default": {},
    "width8": dict(itopk_size=32, search_width=8, max_iterations=6),
    "sort": dict(dedup="sort"),
    "tiled": dict(query_tile=32),
    "seeds": dict(num_seeds=256, seed=5),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_search_without_entries_matches(small, case):
    x, q, index = small
    assert index.centers is None
    sp = SEARCHES[case]
    jd, ji = jcg.search(index, jnp.asarray(q), 10, jcg.SearchParams(**sp))
    td, ti = tcg.search(_port(index), q, 10, tcg.SearchParams(**sp),
                        device="cpu")
    _assert_search_match(td, ti, jd, ji)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_search_metrics_match(small, metric):
    x, q, index = small
    if metric == "inner_product":
        index = jcg.build(jnp.asarray(x), jcg.IndexParams(
            intermediate_graph_degree=32, graph_degree=16, metric=metric))
    else:
        index = index.replace(metric=metric)
    jd, ji = jcg.search(index, jnp.asarray(q), 10)
    td, ti = tcg.search(_port(index), q, 10, device="cpu")
    _assert_search_match(td, ti, jd, ji)


BLOCKED_SEARCHES = {
    "f32": dict(traverse="f32"),
    "int8": dict(traverse="int8"),
    "auto": dict(),
    "f32_sort": dict(traverse="f32", dedup="sort"),
    "int8_sort": dict(traverse="int8", dedup="sort"),
    "tiled": dict(traverse="f32", query_tile=128, entry_clusters=2),
}


@pytest.mark.parametrize("case", sorted(BLOCKED_SEARCHES))
def test_search_with_entries_matches(blocked, case):
    x, q, index = blocked
    assert index.centers is not None and index.dataset_q is not None
    sp = BLOCKED_SEARCHES[case]
    jd, ji = jcg.search(index, jnp.asarray(q), 10, jcg.SearchParams(**sp))
    td, ti = tcg.search(_port(index), q, 10, tcg.SearchParams(**sp),
                        device="cpu")
    _assert_search_match(td, ti, jd, ji)


@pytest.mark.parametrize("kind", ["sel0.1", "every_other"])
@pytest.mark.parametrize("traverse", ["f32", "int8"])
def test_filtered_search_matches(blocked, kind, traverse):
    x, q, index = blocked
    keep = filter_keep(len(x), kind, seed=2)
    bits = jbs.from_mask(jnp.asarray(keep))
    sp = dict(traverse=traverse, itopk_size=32)
    jd, ji = jcg.search(index, jnp.asarray(q[:100]), 10,
                        jcg.SearchParams(**sp), filter_bitset=bits)
    td, ti = tcg.search(_port(index), q[:100], 10, tcg.SearchParams(**sp),
                        filter_bitset=np.asarray(bits), device="cpu")
    _assert_search_match(td, ti, jd, ji)
    got = ti.numpy()
    assert keep[got[got >= 0]].all()
    assert (got[np.isinf(td.numpy())] == -1).all()


def test_search_refuses_the_cpu_by_default(small, monkeypatch):
    x, q, index = small
    port = _port(index)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tcg.search(port, q, 10),
                 lambda: tcg.build(x),
                 lambda: tcg.optimize_graph(port.graph, 8),
                 lambda: tcg.from_numpy(*tcg.to_numpy(port))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _same_index(a, b):
    """Two CagraIndexes (either package) hold the same fields."""
    for name in ("dataset", "graph", "centers", "entry_ids", "dataset_q",
                 "q_scale", "q_zero"):
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
    assert a.metric == b.metric


@pytest.mark.parametrize("which", ["small", "blocked"])
def test_files_cross_both_ways(which, small, blocked, tmp_path):
    x, q, index = small if which == "small" else blocked
    jpath, tpath = str(tmp_path / "jax.idx"), str(tmp_path / "port.idx")
    jcg.save(index, jpath)
    port = tcg.load(jpath, device="cpu")
    _same_index(port, index)
    tcg.save(port, tpath)
    with open(jpath, "rb") as fa, open(tpath, "rb") as fb:
        assert fa.read() == fb.read()
    _same_index(jcg.load(tpath), index)
    # without the dataset: the caller supplies it
    jcg.save(index, jpath, include_dataset=False)
    port = tcg.load(jpath, dataset=x, device="cpu")
    _same_index(port, index)
    td, ti = tcg.search(port, q[:20], 5, device="cpu")
    jd, ji = jcg.search(index, jnp.asarray(q[:20]), 5)
    _assert_search_match(td, ti, jd, ji)


@pytest.mark.parametrize("version", [1, 2])
def test_older_files_load(blocked, version, tmp_path):
    """A version 2 file lacks the int8 rows, a version 1 file also the
    entries: search seeds at random and walks f32 rows, as the JAX
    package's does on the same file."""
    x, q, index = blocked
    arrays = {"graph": np.asarray(index.graph),
              "dataset": np.asarray(index.dataset)}
    if version == 2:
        arrays["centers"] = np.asarray(index.centers)
        arrays["entry_ids"] = np.asarray(index.entry_ids)
    path = str(tmp_path / f"v{version}.idx")
    jser.save_arrays(path, "cagra", version, {"metric": index.metric},
                     arrays)
    port = tcg.load(path, device="cpu")
    ref = jcg.load(path)
    _same_index(port, ref)
    assert port.dataset_q is None
    assert (port.centers is None) == (version == 1)
    jd, ji = jcg.search(ref, jnp.asarray(q[:50]), 10)
    td, ti = tcg.search(port, q[:50], 10, device="cpu")
    _assert_search_match(td, ti, jd, ji)


@pytest.mark.parametrize("which", ["small", "blocked"])
def test_hnswlib_file_is_byte_equal(which, small, blocked, tmp_path):
    _, _, index = small if which == "small" else blocked
    if which == "small":  # interior −1 entries are compacted to the front
        g = np.asarray(index.graph).copy()
        g[::5, 3] = -1
        index = index.replace(graph=jnp.asarray(g))
    jpath, tpath = str(tmp_path / "jax.hnsw"), str(tmp_path / "port.hnsw")
    jcg.serialize_to_hnswlib(index, jpath, ef_construction=150)
    tcg.serialize_to_hnswlib(_port(index), tpath, ef_construction=150)
    with open(jpath, "rb") as fa, open(tpath, "rb") as fb:
        want, got = fa.read(), fb.read()
    assert len(got) == len(want) and got == want


def test_round_trip_through_numpy(blocked):
    _, _, index = blocked
    port = _port(index)
    arrays, meta = tcg.to_numpy(port)
    _same_index(jax_cagra_from_arrays(arrays, meta), index)
    assert port.size == 20_000 and port.dim == 16 and port.graph_degree == 16


# ---------------------------------------------------------------------------
# short neighbourhoods and −1 edges (the port's rule; the JAX package fills
# such slots with pads or the row's own id in any order)
# ---------------------------------------------------------------------------

def test_short_neighbourhood_rows_get_minus_one_never_themselves():
    """Lists of 2–3 members, T 2: every row has fewer than k = 8 other
    rows in its neighbourhood, so its last slots are −1 and none holds the
    row's own id; the overflow scan of a short block likewise."""
    rng = np.random.default_rng(3)
    n_lists, L, T, k = 6, 4, 2, 8
    sizes = np.array([2, 3, 2, 3, 2, 3])
    n = int(sizes.sum())
    x = rng.standard_normal((n, 4)).astype(np.float32)
    labels = np.repeat(np.arange(n_lists), sizes)
    packed = np.zeros((n_lists, L, 4), np.float32)
    pids = np.full((n_lists, L), -1, np.int32)
    slot = np.concatenate([np.arange(s) for s in sizes])
    packed[labels, slot] = x
    pids[labels, slot] = np.arange(n)
    centers = torch.from_numpy(np.stack([x[labels == i].mean(0)
                                         for i in range(n_lists)]))
    g = tcg._cluster_blocked_knn(
        torch.from_numpy(packed), torch.from_numpy(pids), centers,
        torch.from_numpy(labels), torch.from_numpy(slot), k, n_lists, T, 4,
        False).numpy()
    assert not (g == np.arange(n)[:, None]).any()
    for r in range(n):
        valid = g[r][g[r] >= 0]
        assert len(set(valid.tolist())) == len(valid)
        assert (g[r][len(valid):] == -1).all()
        assert len(valid) <= 2 * sizes.max() - 1
    ov = tcg._overflow_knn(torch.from_numpy(x), torch.from_numpy(packed),
                           torch.from_numpy(pids), torch.arange(n),
                           torch.from_numpy(labels), 3, False, 4).numpy()
    assert not (ov == np.arange(n)[:, None]).any()
    assert ((ov >= 0).sum(1) == sizes[labels] - 1).all()


def test_minus_one_edges_are_no_candidates(blocked):
    """A graph with −1 edges: search never returns −1 at a finite
    distance (the JAX package scores a −1 edge as row n − 1's vector)."""
    x, q, index = blocked
    port = _port(index)
    g = port.graph.clone()
    g[:, 3::4] = -1
    port.graph = g
    d, i = tcg.search(port, q[:50], 10, tcg.SearchParams(traverse="f32"),
                      device="cpu")
    d, i = d.numpy(), i.numpy()
    assert np.isfinite(d).all() and (i >= 0).all()
    exact = ((q[:50, None, :].astype(np.float64) - x[i]) ** 2).sum(-1)
    np.testing.assert_allclose(d, exact, rtol=1e-5, atol=1e-5)


def test_seed_draws_are_kept_per_shape(small):
    """The seed draws depend on no query's values: a second search of other
    queries reuses them, and the ids equal a fresh process's."""
    x, q, index = small
    port = _port(index)
    tcg._seed_draws.cache_clear()
    d1, i1 = tcg.search(port, q, 10, device="cpu")
    hits = tcg._seed_draws.cache_info().hits
    tcg.search(port, q[::-1].copy(), 10, device="cpu")
    assert tcg._seed_draws.cache_info().hits == hits + 1
    tcg._seed_draws.cache_clear()
    d2, i2 = tcg.search(port, q, 10, device="cpu")
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
