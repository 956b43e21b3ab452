"""IVF-PQ search of the port against the JAX package, on the CPU.

One JAX-built index per metric (n = 3000, d = 32, 16 lists, pq_dim 16)
crosses to the port through ``from_numpy``; both sides search the same
seeded numpy queries. The JAX side runs its Pallas kernels interpreted
(``RAFT_TPU_PALLAS_LUTSCAN`` / ``RAFT_TPU_PALLAS_REFINE`` = always), the
port its kernels' plain versions (``device="cpu"``).

Tolerances: the refined slice and the per_query tier agree on ids with
overlap ≥ 0.99 and on distances at rtol 1e-4 (f32, different summation
orders); the shared pieces (segmenting, the candidate epilogue, bit
packing) are exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jrefine
from raft_tpu_torch.distance.types import resolve_metric
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as trefine
from raft_tpu_torch.obs import spans as tspans

from torch_parity import (assert_filtered_match, blobs, jax_index_arrays,
                          overlap)

N, D, N_LISTS, PQ_DIM = 3000, 32, 16, 16


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 30, seed=21), blobs(60, D, 30, seed=22)


_INDEXES = {}


def _jax_index(x, metric="sqeuclidean", pq_bits=8):
    key = (metric, pq_bits)
    if key not in _INDEXES:
        _INDEXES[key] = jpq.build(jnp.asarray(x), jpq.IndexParams(
            n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=pq_bits, metric=metric,
            seed=0, cache_reconstruction="never"))
    return _INDEXES[key]


def _port_index(jidx):
    arrays, meta = jax_index_arrays(jidx)
    return tpq.from_numpy(arrays, meta, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_refined_slice_matches_jax(corpus, metric, monkeypatch):
    """The slice end to end: JAX-built index → from_numpy → the port's
    refined search (LUT-scan tier + fused re-rank) vs the JAX package's
    refined search through its interpreted Pallas kernels."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    monkeypatch.setenv("RAFT_TPU_PALLAS_REFINE", "always")
    x, q = corpus
    jidx = _jax_index(x, metric)
    jsp = jpq.SearchParams(n_probes=8, scan_select="pallas",
                           refine="f32_regen", refine_ratio=40,
                           lut_dtype="float32")
    jd, ji = jpq.search(jidx, jnp.asarray(q), 10, jsp,
                        dataset=jnp.asarray(x))
    tsp = tpq.SearchParams(n_probes=8, scan_select="pallas",
                           refine="f32_regen", refine_ratio=40,
                           lut_dtype="float32")
    td, ti = tpq.search(_port_index(jidx), _t(q), 10, tsp, dataset=_t(x),
                        device="cpu")
    assert ti.dtype == torch.int32 and ti.shape == (60, 10)
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
def test_lut_tier_matches_jax(corpus, lut_dtype, monkeypatch):
    """The unrefined LUT-scan tier (k = 20) against the JAX package's."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    x, q = corpus
    jidx = _jax_index(x)
    kw = dict(n_probes=8, scan_select="pallas", lut_dtype=lut_dtype)
    jd, ji = jpq.search(jidx, jnp.asarray(q), 20, jpq.SearchParams(**kw))
    td, ti = tpq.search(_port_index(jidx), _t(q), 20,
                        tpq.SearchParams(**kw), device="cpu")
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("refined", [False, True])
def test_lut_tier_returns_ordinary_tensors(corpus, refined):
    """What the LUT tier returns is an ordinary tensor that the caller may
    write in place, never a tensor of its index arithmetic's graphs."""
    x, q = corpus
    kw = dict(refine="f32_regen", refine_ratio=4) if refined else {}
    td, ti = tpq.search(_port_index(_jax_index(x)), _t(q), 10,
                        tpq.SearchParams(n_probes=8, scan_select="pallas",
                                         **kw),
                        dataset=_t(x) if refined else None, device="cpu")
    assert not td.is_inference() and not ti.is_inference()
    ti[0, 0] = -1
    td.mul_(2.0)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product",
                                    "cosine"])
def test_per_query_tier_matches_jax(corpus, metric):
    x, q = corpus
    jidx = _jax_index(x, metric)
    kw = dict(n_probes=6, scan_mode="per_query", lut_dtype="float32")
    jd, ji = jpq.search(jidx, jnp.asarray(q), 10, jpq.SearchParams(**kw))
    td, ti = tpq.search(_port_index(jidx), _t(q), 10,
                        tpq.SearchParams(**kw), device="cpu")
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


def test_lut_tier_pq6_matches_per_query(corpus):
    """pq_bits = 6: the port's LUT-scan tier against the JAX package's
    per_query tier (its 6-bit LUT kernel is a known fault, ROADMAP C1)."""
    x, q = corpus
    jidx = _jax_index(x, pq_bits=6)
    jd, ji = jpq.search(jidx, jnp.asarray(q), 20, jpq.SearchParams(
        n_probes=8, scan_mode="per_query", lut_dtype="float32"))
    td, ti = tpq.search(_port_index(jidx), _t(q), 20, tpq.SearchParams(
        n_probes=8, scan_select="pallas", lut_dtype="float32"),
        device="cpu")
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine"])
def test_finish_candidates_exact(metric):
    rng = np.random.default_rng(5)
    m, C, k = 7, 500, 12
    dots = (rng.integers(-50, 50, (m, C)) * 0.5).astype(np.float32)
    norms = (rng.integers(0, 80, (m, C)) * 0.25).astype(np.float32)
    q_sq = rng.uniform(50, 60, m).astype(np.float32)
    ids = rng.permutation(m * C).reshape(m, C).astype(np.int32)
    ids[rng.random((m, C)) < 0.2] = -1
    mt_j = jpq.resolve_metric(metric)
    jv, ji = jpq._finish_candidates(jnp.asarray(dots), jnp.asarray(ids),
                                    jnp.asarray(norms), jnp.asarray(q_sq),
                                    mt_j, k)
    tv, ti = tpq._finish_candidates(_t(dots), _t(ids), _t(norms), _t(q_sq),
                                    resolve_metric(metric), k)
    # XLA's CPU sqrt is not correctly rounded: euclidean may differ by 1 ulp
    np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(jv),
                                    maxulp=1 if metric == "euclidean" else 0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_pack_bits_matches_jax(pq_bits):
    rng = np.random.default_rng(pq_bits)
    codes = rng.integers(0, 1 << pq_bits, (3, 50, 24)).astype(np.uint8)
    jp = np.asarray(jpq.pack_bits(jnp.asarray(codes), pq_bits))
    tp = tpq.pack_bits(_t(codes), pq_bits)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert tp.shape[-1] == tpq.packed_nbytes(24, pq_bits)
    np.testing.assert_array_equal(tpq.unpack_bits(tp, 24, pq_bits).numpy(),
                                  codes)


def test_numpy_round_trip(corpus):
    jidx = _jax_index(corpus[0])
    arrays, meta = jax_index_arrays(jidx)
    back, meta2 = tpq.to_numpy(tpq.from_numpy(arrays, meta, device="cpu"))
    assert meta2 == meta
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
        assert back[name].dtype == a.dtype


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product",
                                    "cosine"])
def test_refine_gather_tier_matches_jax(metric):
    """Standalone refine with few candidates (the gather tier)."""
    rng = np.random.default_rng(9)
    data = rng.standard_normal((800, 20)).astype(np.float32)
    q = rng.standard_normal((15, 20)).astype(np.float32)
    cand = rng.integers(-1, 800, (15, 40)).astype(np.int32)
    jd, ji = jrefine.refine(jnp.asarray(data), jnp.asarray(q),
                            jnp.asarray(cand), 8, metric=metric)
    td, ti = trefine.refine(_t(data), _t(q), _t(cand), 8, metric=metric,
                            device="cpu")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine"])
def test_brute_force_matches_jax(metric):
    from raft_tpu.neighbors import brute_force as jbf
    from raft_tpu_torch.neighbors import brute_force as tbf

    rng = np.random.default_rng(2)
    data = rng.standard_normal((1500, 16)).astype(np.float32)
    q = rng.standard_normal((25, 16)).astype(np.float32)
    jd, ji = jbf.knn(jbf.build(jnp.asarray(data), metric=metric),
                     jnp.asarray(q), 10)
    td, ti = tbf.knn_arrays(_t(data), _t(q), 10, metric=metric, device="cpu")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99


def test_resolve_lut_dtype_off_card():
    for args in (("auto", 64, 10), ("auto", 8, 400), ("auto", 8, 10),
                 ("bfloat16", 64, 10), ("float8_e4m3", 8, 10)):
        assert tpq.resolve_lut_dtype(*args) == jpq.resolve_lut_dtype(*args)


def test_unported_paths_raise(corpus):
    """per_cluster codebooks, refused until ROADMAP A9, are taken by
    ``build``, ``build_chunked`` and ``from_numpy``; the sharded build and
    ``search_staged`` still refuse them, as the JAX package does. Folded
    code storage is taken as its [n_lists, L, nb] view."""
    from raft_tpu_torch.core.errors import LogicError
    from raft_tpu_torch.parallel import ivf as tpivf
    from raft_tpu_torch.parallel import make_mesh

    x, q = corpus
    xt = _t(x)
    pc = tpq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=4,
                         codebook_kind="per_cluster")
    idx = tpq.build(xt, pc, device="cpu")
    assert idx.codebook_kind == "per_cluster"
    assert tuple(idx.codebooks.shape) == (N_LISTS, 256, D // PQ_DIM)
    chunked = tpq.build_chunked(x, pc, chunk_rows=1000, device="cpu")
    assert chunked.codebook_kind == "per_cluster"
    assert tuple(chunked.codebooks.shape) == (N_LISTS, 256, D // PQ_DIM)
    back = tpq.from_numpy(*tpq.to_numpy(idx), device="cpu")
    assert back.codebook_kind == "per_cluster"
    np.testing.assert_array_equal(back.packed_codes.numpy(),
                                  idx.packed_codes.numpy())
    with pytest.raises(LogicError, match="per_subspace"):
        tpq.search_staged(idx, _t(q), 10, device="cpu")
    with pytest.raises(LogicError, match="per_subspace"):
        tpivf.build_ivf_pq(pc, xt, make_mesh(2, device="cpu"))
    jidx = _jax_index(x)
    arrays, meta = jax_index_arrays(jidx)
    folded = dict(arrays, packed_codes=arrays["packed_codes"].reshape(
        N_LISTS, -1, 128))
    np.testing.assert_array_equal(
        tpq.from_numpy(folded, meta, device="cpu").packed_codes.numpy(),
        arrays["packed_codes"])


# ---------------------------------------------------------------------------
# filtered search (ROADMAP A6)
# ---------------------------------------------------------------------------

def _keep(sel: float, n: int = N, seed: int = 0):
    """A seeded keep mask and its JAX bitset."""
    keep = np.random.default_rng(seed + int(sel * 1000)).random(n) < sel
    return keep, jbs.from_mask(jnp.asarray(keep))


@pytest.mark.parametrize("sel", [0.01, 0.1, 0.5])
def test_filtered_lut_tier_matches_jax(corpus, sel, monkeypatch):
    """The LUT-scan tier with its keep bytes (k 20) against the JAX
    package's interpreted kernel with filter_bytes; the dispatch counts
    pallas_lut with filtered=1."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    x, q = corpus
    jidx = _jax_index(x)
    keep, bits = _keep(sel)
    kw = dict(n_probes=8, scan_select="pallas", lut_dtype="float32")
    jd, ji = jpq.search(jidx, jnp.asarray(q), 20, jpq.SearchParams(**kw),
                        filter_bitset=bits)
    tspans.reset()
    td, ti = tpq.search(_port_index(jidx), _t(q), 20, tpq.SearchParams(**kw),
                        filter_bitset=np.asarray(bits), device="cpu")
    assert tspans.counts()["ivf_pq.scan.dispatch"] == {
        "pallas_lut,filtered=1": 1}
    assert_filtered_match(ti, td, ji, jd, keep, atol=1e-3)


# (metric, selectivity): the bench's selectivities on l2, the other
# metrics at 0.1
_PQ_FILTERED = [("sqeuclidean", s) for s in (0.01, 0.1, 0.5)] + [
    ("inner_product", 0.1), ("cosine", 0.1)]


@pytest.mark.parametrize("metric,sel", _PQ_FILTERED)
def test_filtered_per_query_tier_matches_jax(corpus, metric, sel):
    x, q = corpus
    jidx = _jax_index(x, metric)
    keep, bits = _keep(sel, seed=1)
    kw = dict(n_probes=6, scan_mode="per_query", lut_dtype="float32")
    jd, ji = jpq.search(jidx, jnp.asarray(q), 10, jpq.SearchParams(**kw),
                        filter_bitset=bits)
    td, ti = tpq.search(_port_index(jidx), _t(q), 10, tpq.SearchParams(**kw),
                        filter_bitset=np.asarray(bits), device="cpu")
    assert_filtered_match(ti, td, ji, jd, keep)


@pytest.mark.parametrize("sel", [0.01, 0.1, 0.5])
def test_filtered_refined_slice_matches_jax(corpus, sel, monkeypatch):
    """The main path filtered: the LUT-scan tier with keep bytes, then the
    fused re-rank with the bitset's words, against the JAX package's
    interpreted kernels; the re-rank's dispatch counts filtered=1."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    monkeypatch.setenv("RAFT_TPU_PALLAS_REFINE", "always")
    x, q = corpus
    jidx = _jax_index(x)
    keep, bits = _keep(sel, seed=2)
    kw = dict(n_probes=8, scan_select="pallas", refine="f32_regen",
              refine_ratio=40, lut_dtype="float32")
    jd, ji = jpq.search(jidx, jnp.asarray(q), 10, jpq.SearchParams(**kw),
                        filter_bitset=bits, dataset=jnp.asarray(x))
    tspans.reset()
    td, ti = tpq.search(_port_index(jidx), _t(q), 10, tpq.SearchParams(**kw),
                        filter_bitset=np.asarray(bits), dataset=_t(x),
                        device="cpu")
    counts = tspans.counts()
    assert counts["refine.dispatch"] == {"pallas_gather,filtered=1": 1}
    assert counts["ivf_pq.scan.dispatch"] == {"pallas_lut,filtered=1": 1}
    assert_filtered_match(ti, td, ji, jd, keep)


@pytest.mark.parametrize("tier,metric", [
    ("fused", "sqeuclidean"), ("fused", "inner_product"), ("fused", "cosine"),
    ("gather", "sqeuclidean"), ("gather", "cosine")])
def test_filtered_refine_matches_jax(tier, metric, monkeypatch):
    """Standalone refine with a filter: the fused tier (C 400, the kernel's
    word test) and the gather tier (C 40, the candidates masked first)
    against the JAX package's."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_REFINE",
                       "always" if tier == "fused" else "never")
    rng = np.random.default_rng(11)
    data = rng.standard_normal((900, 24)).astype(np.float32)
    q = rng.standard_normal((13, 24)).astype(np.float32)
    C = 400 if tier == "fused" else 40
    cand = rng.integers(-1, 900, (13, C)).astype(np.int32)
    keep = rng.random(900) < 0.3
    bits = jbs.from_mask(jnp.asarray(keep))
    jd, ji = jrefine.refine(jnp.asarray(data), jnp.asarray(q),
                            jnp.asarray(cand), 8, metric=metric,
                            filter_bits=bits)
    tspans.reset()
    td, ti = trefine.refine(_t(data), _t(q), _t(cand), 8, metric=metric,
                            filter_bits=np.asarray(bits), device="cpu")
    label = "pallas_gather" if tier == "fused" else "xla_gather"
    assert tspans.counts()["refine.dispatch"] == {label + ",filtered=1": 1}
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert keep[ti.numpy()[ti.numpy() >= 0]].all()


@pytest.mark.parametrize("metric,sel", [
    ("sqeuclidean", 0.1), ("euclidean", 0.01), ("inner_product", 0.1),
    ("cosine", 0.5), ("sqeuclidean", 0.003)])
def test_filtered_brute_force_matches_jax(metric, sel):
    """The filtered ground truth: cleared rows never returned, and where
    fewer than k rows survive (selectivity 0.003 of 1500 rows) the empty
    slots hold id −1, as in the JAX package."""
    from raft_tpu.neighbors import brute_force as jbf
    from raft_tpu_torch.neighbors import brute_force as tbf

    rng = np.random.default_rng(2)
    data = rng.standard_normal((1500, 16)).astype(np.float32)
    q = rng.standard_normal((25, 16)).astype(np.float32)
    keep, bits = _keep(sel, n=1500, seed=3)
    jd, ji = jbf.knn(jbf.build(jnp.asarray(data), metric=metric),
                     jnp.asarray(q), 10, filter_bitset=bits)
    td, ti = tbf.knn(tbf.build(_t(data), metric=metric, device="cpu"),
                     _t(q), 10, filter_bitset=np.asarray(bits))
    assert_filtered_match(ti, td, ji, jd, keep)
    if keep.sum() < 10:
        assert (ti.numpy()[:, keep.sum():] == -1).all()


def test_filter_selectivity_feeds_the_lut_dtype(monkeypatch):
    """A filter's density discounts the fp8 slack of resolve_lut_dtype, as
    in the JAX package (the card-only branch, forced here)."""
    from raft_tpu_torch.ops import kernels as tk

    keep, bits = _keep(0.1, n=4096, seed=4)
    sel = tpq._filter_selectivity(np.asarray(bits))
    assert abs(sel - float(jbs.density(bits))) < 1e-6
    assert tpq._filter_selectivity(None) == 1.0
    monkeypatch.setattr(tk, "_on_cuda", lambda: True)
    assert tpq.resolve_lut_dtype("auto", 64, 500, 1.0) == "float8_e4m3"
    assert tpq.resolve_lut_dtype("auto", 64, 500, sel) == "bfloat16"


def test_index_tables_are_segments_and_launch_tables():
    """The LUT tier's one replayed function is ``segment_probes`` followed
    by the scan's launch tables, bit for bit (on the CPU it runs as it
    is)."""
    from raft_tpu_torch.neighbors import ivf_common as tic
    from raft_tpu_torch.ops import kernels as tk

    g = torch.Generator().manual_seed(5)
    n_lists, seg, qg = 64, tic.SEGMENT_SIZE, 16
    probes = torch.randint(0, n_lists, (40, 12), generator=g,
                           dtype=torch.int32)
    n_seg = tic.n_segments(probes.numel(), n_lists, seg)
    got = tpq._index_tables(probes, n_lists, seg, n_seg, qg)
    want = tic.segment_probes(probes, n_lists, seg, n_seg)
    want = tuple(want) + tuple(tk.lut_scan_tables(*want[1:], qg))
    assert len(got) == len(want) == 7
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_center_norms_are_kept_per_centers_version(corpus):
    """‖c‖² of the coarse centers is made once per centers tensor, as a
    row, and made again after the centers are written in place."""
    import dataclasses

    x, _ = corpus
    idx = _port_index(_jax_index(x))
    idx = dataclasses.replace(idx, centers=idx.centers.clone())
    c_sq = tpq._center_sq(idx)
    assert c_sq.shape == (1, idx.n_lists)
    assert torch.equal(c_sq[0], (idx.centers * idx.centers).sum(1))
    assert tpq._center_sq(idx) is c_sq
    idx.centers.mul_(2.0)
    again = tpq._center_sq(idx)
    assert again is not c_sq
    assert torch.equal(again[0], (idx.centers * idx.centers).sum(1))
