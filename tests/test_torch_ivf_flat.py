"""IVF-Flat of the port against the JAX package, on the CPU.

JAX-built indexes cross to the port through ``from_numpy`` and are
searched by both packages on the same seeded numpy queries: the per_query
tier, the exact grouped tier (grouped-scan kernel) and the approx tier
(segmented-scan kernel). The JAX side runs its Pallas kernels interpreted
(``RAFT_TPU_PALLAS_GROUPED=always``), the port its kernels' plain versions
(``device="cpu"``). Port-built indexes go the other way, and the two
builds are compared by recall (their k-means draw different random
numbers from one seed).

Tolerances: search distances rtol = atol = 1e-4 with id-set overlap
≥ 0.99 (f32, different summation orders); build recall within 0.02;
``make_synthetic_hard``, ``predict_topk`` and ``spill_assignments`` exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.bench import dataset as jds
from raft_tpu.core import bitset as jbs
from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.neighbors import ivf_common as jic
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu_torch.bench import dataset as tds
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.neighbors import ivf_common as tic
from raft_tpu_torch.neighbors import ivf_flat as tfl

from torch_parity import (assert_filtered_match, blobs, jax_flat_arrays,
                          jax_flat_from_arrays, overlap)

N, D, N_LISTS = 2000, 16, 16
METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 40, seed=41), blobs(60, D, 40, seed=42)


_INDEXES = {}


def _jax_index(x, metric="sqeuclidean", n_lists=N_LISTS):
    key = (metric, n_lists)
    if key not in _INDEXES:
        _INDEXES[key] = jfl.build(jnp.asarray(x), jfl.IndexParams(
            n_lists=n_lists, metric=metric, kmeans_n_iters=8, seed=0))
    return _INDEXES[key]


def _port_index(jidx):
    return tfl.from_numpy(*jax_flat_arrays(jidx), device="cpu")


def _truth(x, q, metric, k=10):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "inner_product":
        s = -(q64 @ x64.T)
    elif metric == "cosine":
        s = -(q64 @ x64.T) / (np.linalg.norm(q64, axis=1)[:, None]
                              * np.linalg.norm(x64, axis=1)[None, :])
    else:
        s = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    return np.argsort(s, axis=1, kind="stable")[:, :k]


def _same(td, ti, jd, ji):
    """Distances within tolerance, the same empty (−1) slots, and id-set
    overlap ≥ 0.99 over the filled ones."""
    ti, ji = ti.numpy(), np.asarray(ji)
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti < 0, ji < 0)
    hits = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ti, ji))
    assert hits >= 0.99 * max(1, int((ji >= 0).sum()))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# crossed indexes: the port's search against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_per_query_tier_matches_jax(corpus, metric):
    x, q = corpus
    jidx = _jax_index(x, metric)
    sp = dict(n_probes=4, scan_mode="per_query")
    jd, ji = jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(**sp))
    td, ti = tfl.search(_port_index(jidx), _t(q), 10,
                        tfl.SearchParams(**sp), device="cpu")
    _same(td, ti, jd, ji)


@pytest.mark.parametrize("scan_select,metric", [
    ("exact", "sqeuclidean"), ("exact", "inner_product"), ("exact", "cosine"),
    ("approx", "sqeuclidean"), ("approx", "euclidean"),
    ("approx", "inner_product"), ("approx", "cosine")])
def test_grouped_tiers_match_jax(corpus, scan_select, metric, monkeypatch):
    """The grouped tiers through their kernels: exact = grouped scan,
    approx = segmented scan + merge_bin_results."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_index(x, metric)
    sp = dict(n_probes=4, scan_mode="grouped", scan_select=scan_select)
    jd, ji = jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(**sp))
    td, ti = tfl.search(_port_index(jidx), _t(q), 10,
                        tfl.SearchParams(**sp), device="cpu")
    _same(td, ti, jd, ji)


@pytest.mark.parametrize("scan_select,k", [("exact", 100), ("approx", 200)])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_grouped_tier_matches_jax(corpus, scan_select, k, metric,
                                        monkeypatch):
    """Past the kernels' kk (exact > 64, approx > 128) both packages take
    their plain grouped tier (the JAX package's XLA tier)."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_index(x, metric, n_lists=8)
    tidx = _port_index(jidx)
    assert min(k, tidx.max_list_size) > (64 if scan_select == "exact"
                                         else 128)
    sp = dict(n_probes=3, scan_mode="grouped", scan_select=scan_select,
              list_chunk=2)
    jd, ji = jfl.search(jidx, jnp.asarray(q), k, jfl.SearchParams(**sp))
    td, ti = tfl.search(tidx, _t(q), k, tfl.SearchParams(**sp), device="cpu")
    _same(td, ti, jd, ji)


def test_tiny_lists_and_k_past_candidates_match_jax(corpus, monkeypatch):
    """L < 128 (the segmented scan pads to one 128-row tile, so every
    second best is +inf) and k > what one probed list holds (both tiers
    pad with (invalid, −1))."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_index(x, n_lists=128)
    tidx = _port_index(jidx)
    assert tidx.max_list_size < 128
    for scan_select, n_probes, k in (("approx", 8, 10), ("approx", 1, 40),
                                     ("exact", 1, 40)):
        sp = dict(n_probes=n_probes, scan_mode="grouped",
                  scan_select=scan_select)
        jd, ji = jfl.search(jidx, jnp.asarray(q), k, jfl.SearchParams(**sp))
        td, ti = tfl.search(tidx, _t(q), k, tfl.SearchParams(**sp),
                            device="cpu")
        _same(td, ti, jd, ji)


def test_auto_mode_goes_grouped(corpus, monkeypatch):
    """B·n_probes ≥ 2·n_lists takes the grouped tier in both packages."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_index(x)
    sp = dict(n_probes=4, scan_select="approx")
    tidx = _port_index(jidx)
    jd, ji = jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(**sp))
    td, ti = tfl.search(tidx, _t(q), 10, tfl.SearchParams(**sp), device="cpu")
    _same(td, ti, jd, ji)
    assert 60 * 4 >= 2 * tidx.n_lists


def test_numpy_round_trip(corpus):
    arrays, meta = jax_flat_arrays(_jax_index(corpus[0]))
    back, meta2 = tfl.to_numpy(tfl.from_numpy(arrays, meta, device="cpu"))
    assert meta2 == meta
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
        assert back[name].dtype == a.dtype


# ---------------------------------------------------------------------------
# port-built indexes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hard_corpus():
    """Many tiny clusters: recall moves little between two k-means draws
    (blobs of 40 clusters over 16 lists moved it 0.79–0.99 by seed)."""
    ds = tds.make_synthetic_hard("h", 3000, 16, 200, seed=1)
    return ds.base, ds.queries


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_port_build_recall_matches_jax(hard_corpus, metric, spill):
    x, q = hard_corpus
    params = dict(n_lists=32, metric=metric, kmeans_n_iters=8, seed=0,
                  spill=spill, list_size_cap_factor=1.5)
    sp = dict(n_probes=4, scan_mode="per_query")
    gt = _truth(x, q, metric)
    jidx = jfl.build(jnp.asarray(x), jfl.IndexParams(**params))
    tidx = tfl.build(_t(x), tfl.IndexParams(**params), device="cpu")
    _, ji = jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(**sp))
    _, ti = tfl.search(tidx, _t(q), 10, tfl.SearchParams(**sp), device="cpu")
    r_jax, r_port = overlap(np.asarray(ji), gt), overlap(ti.numpy(), gt)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)
    assert tidx.packed_ids.dtype == torch.int32
    assert tidx.size >= 0.99 * x.shape[0]
    if spill:
        assert tidx.max_list_size == tic._lane_round(
            int(x.shape[0] // 32 * 1.5))


def test_port_index_searched_by_jax(corpus, monkeypatch):
    """to_numpy of a port-built index, searched by the JAX package, gives
    the port's own answers (per_query and the approx kernel tier)."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    tidx = tfl.build(_t(x), tfl.IndexParams(n_lists=N_LISTS, spill=True,
                                            list_size_cap_factor=1.5,
                                            kmeans_n_iters=8), device="cpu")
    jidx = jax_flat_from_arrays(*tfl.to_numpy(tidx))
    for sp in (dict(n_probes=4, scan_mode="per_query"),
               dict(n_probes=4, scan_mode="grouped", scan_select="approx")):
        jd, ji = jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(**sp))
        td, ti = tfl.search(tidx, _t(q), 10, tfl.SearchParams(**sp),
                            device="cpu")
        _same(td, ti, jd, ji)


def test_build_without_data(corpus):
    x, _ = corpus
    p = dict(n_lists=N_LISTS, add_data_on_build=False, kmeans_n_iters=4)
    jidx = jfl.build(jnp.asarray(x), jfl.IndexParams(**p))
    tidx = tfl.build(_t(x), tfl.IndexParams(**p), device="cpu")
    assert tidx.size == 0 and tidx.packed_data.shape == jidx.packed_data.shape
    assert (tidx.packed_ids == -1).all()


# ---------------------------------------------------------------------------
# exact pieces of the build
# ---------------------------------------------------------------------------

def _skewed_blobs(seed: int = 0):
    """One center holds ~40 % of the rows (test_ivf_flat.py's spill case);
    returns the rows and their 16 generating centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 30, (16, 8)).astype(np.float32)
    assign = np.where(rng.random(8000) < 0.4, 0, rng.integers(1, 16, 8000))
    return (centers[assign]
            + rng.normal(0, 0.5, (8000, 8)).astype(np.float32)), centers


@pytest.mark.parametrize("case", ["blobs", "skewed", "cosine"])
def test_predict_topk_and_spill_match_jax(corpus, case):
    """Labels equal exactly. The centers are far enough apart that no
    row's distances to two of them tie within f32 rounding of the
    expanded form (the two packages sum the Gram in different orders)."""
    rng = np.random.default_rng(7)
    if case == "skewed":
        x, centers = _skewed_blobs()
        metric = "l2"
    else:
        x = corpus[0]
        metric = "cosine" if case == "cosine" else "l2"
        centers = x[rng.choice(x.shape[0], N_LISTS, replace=False)]
    centers = centers + rng.normal(0, 0.1, centers.shape).astype(np.float32)
    n_lists = centers.shape[0]
    jp = jkb.KMeansBalancedParams(metric=metric)
    tp = tkb.KMeansBalancedParams(metric=metric)
    jl = np.asarray(jkb.predict_topk(jnp.asarray(centers), jnp.asarray(x),
                                     jic.SPILL_DEPTH, jp))
    tl = tkb.predict_topk(_t(centers), _t(x), tic.SPILL_DEPTH, tp)
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), jl)
    cap = tic._lane_round(int(x.shape[0] // n_lists * 1.5))
    jlab = np.asarray(jic.spill_assignments(
        jnp.asarray(jl[:, 0]), jnp.asarray(jl[:, 1]), n_lists, cap,
        *[jnp.asarray(jl[:, c]) for c in range(2, jl.shape[1])]))
    tlab = tic.spill_assignments(_t(jl[:, 0]), _t(jl[:, 1]), n_lists, cap,
                                 *[_t(jl[:, c]) for c in range(2, jl.shape[1])])
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    assert np.bincount(jlab[jlab < n_lists], minlength=n_lists).max() <= cap


def test_spill_assignments_double_overflow_matches_jax():
    """Overflow moves to the next choice; rows that overflow every choice
    get the marker n_lists."""
    l1 = np.array([0, 0, 0, 0, 0, 1, 1], np.int32)
    l2 = np.array([1, 1, 1, 1, 1, 0, 0], np.int32)
    jlab = np.asarray(jic.spill_assignments(jnp.asarray(l1), jnp.asarray(l2),
                                            2, 3))
    tlab = tic.spill_assignments(_t(l1), _t(l2), 2, 3)
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    assert sorted(tlab.numpy()[3:5].tolist()) == [1, 2]


@pytest.mark.parametrize("n,dim,seed", [(3000, 32, 0), (1000, 128, 5)])
def test_make_synthetic_hard_matches_jax(n, dim, seed):
    j = jds.make_synthetic_hard("h", n, dim, 50, seed=seed)
    t = tds.make_synthetic_hard("h", n, dim, 50, seed=seed)
    for a, b in ((t.base, j.base), (t.queries, j.queries)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# what the slice does not port
# ---------------------------------------------------------------------------

def test_unported_paths_raise(corpus):
    """int8 data, refused until ROADMAP A19, builds an index that keeps its
    lists as int8; the sharded routes refuse what they refused."""
    x, q = corpus
    idx = _port_index(_jax_index(x))
    qt = _t(q)
    idx8 = tfl.build(np.clip(x * 10, -127, 127).astype(np.int8),
                     tfl.IndexParams(n_lists=4), device="cpu")
    assert idx8.packed_data.dtype == torch.int8
    assert idx8.size == x.shape[0]
    # the sharded routes are ported (ROADMAP A15): they refuse a
    # single-device index handed a mesh, and a build without one
    with pytest.raises(Exception, match="ShardedIvfFlat"):
        tfl.search(idx, qt, 10, tfl.SearchParams(n_probes=4),
                   mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        tfl.build_distributed(x)


def test_refined_search_matches_unrefined_exact_rows(corpus):
    """refine="f32_regen" against a device-resident dataset re-ranks the
    approx tier's candidates exactly: its distances are the true ones."""
    x, q = corpus
    idx = _port_index(_jax_index(x))
    d, i = tfl.search(idx, _t(q), 10, tfl.SearchParams(
        n_probes=4, scan_select="approx", refine="f32_regen",
        refine_ratio=4), dataset=_t(x), device="cpu")
    true = ((q[:, None, :].astype(np.float64)
             - x[i.numpy()].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), true, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# filtered search (ROADMAP A6)
# ---------------------------------------------------------------------------

# (tier, selectivity, metric): every tier at the bench's three
# selectivities, and the other metrics at 0.1
_FLAT_FILTERED = [(t, s, "sqeuclidean") for t in ("per_query", "exact",
                                                  "approx")
                  for s in (0.01, 0.1, 0.5)] + [
    ("per_query", 0.1, "cosine"), ("exact", 0.1, "inner_product"),
    ("approx", 0.1, "cosine")]


@pytest.mark.parametrize("tier,sel,metric", _FLAT_FILTERED)
def test_filtered_tiers_match_jax(corpus, tier, sel, metric, monkeypatch):
    """Filtered search in each tier: per_query (the bitset tested per
    candidate), exact (the grouped scan over the masked id table; the JAX
    package's interpreted kernel with mask_add) and approx (the plain
    grouped tier over the masked table: the segmented scan declines
    filtered searches in both packages)."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_index(x, metric)
    keep = np.random.default_rng(int(sel * 100)).random(N) < sel
    bits = jbs.from_mask(jnp.asarray(keep))
    sp = (dict(n_probes=4, scan_mode="per_query") if tier == "per_query"
          else dict(n_probes=4, scan_mode="grouped", scan_select=tier))
    jd, ji = jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(**sp),
                        filter_bitset=bits)
    td, ti = tfl.search(_port_index(jidx), _t(q), 10, tfl.SearchParams(**sp),
                        filter_bitset=np.asarray(bits), device="cpu")
    assert_filtered_match(ti, td, ji, jd, keep)


def test_filtered_refined_search_matches_jax(corpus):
    """refine="f32_regen" with a filter: the scan and the re-rank both take
    it."""
    x, q = corpus
    jidx = _jax_index(x)
    keep = np.random.default_rng(9).random(N) < 0.2
    bits = jbs.from_mask(jnp.asarray(keep))
    sp = dict(n_probes=4, scan_mode="per_query", refine="f32_regen",
              refine_ratio=4)
    jd, ji = jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(**sp),
                        filter_bitset=bits, dataset=jnp.asarray(x))
    td, ti = tfl.search(_port_index(jidx), _t(q), 10, tfl.SearchParams(**sp),
                        filter_bitset=np.asarray(bits), dataset=_t(x),
                        device="cpu")
    assert_filtered_match(ti, td, ji, jd, keep)
