"""IVF-PQ's bf16 reconstruction cache and the tiers over it: the port
against the JAX package, on the CPU.

JAX-built indexes (n = 3000, d = 32, 16 lists, pq_dim 16, the cache
built) cross to the port through ``from_numpy``, which rebuilds the cache
from the codes; both sides search the same seeded numpy queries. The JAX
side runs its interpreted B5/B6 kernels under
``RAFT_TPU_PALLAS_GROUPED=always`` where the port takes its kernel tiers
(plain versions on the CPU), and its XLA tier under ``never`` where the
port takes its plain grouped tier.

Tolerances: the cache equal bit for bit; ids overlap ≥ 0.99 and the same
empty (−1) slots; distances rtol = atol = 1e-3 within one tier (the
reference's, ``tests/test_ivf_pq.py``), 2e-2 across the bf16 norm (the
grouped kernel recomputes ‖c + d‖² from the bf16 rows, the plain tier
reads the stored f32 norms: ``tests/test_ivf_pq.py:334-336``); the spill
build's list fill, ids and drop count exact on the same centers.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import ivf_common as jic
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.neighbors import ivf_common as tic
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import spans as tspans

from torch_parity import (assert_filtered_match, blobs, jax_index_arrays,
                          jax_index_from_arrays, overlap)

N, D, N_LISTS, PQ_DIM = 3000, 32, 16, 16
METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 30, seed=61), blobs(60, D, 30, seed=62)


_INDEXES = {}


def _jax_index(x, metric="sqeuclidean", pq_bits=8, cache="always"):
    key = (metric, pq_bits, cache)
    if key not in _INDEXES:
        _INDEXES[key] = jpq.build(jnp.asarray(x), jpq.IndexParams(
            n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=pq_bits, metric=metric,
            seed=0, cache_reconstruction=cache))
    return _INDEXES[key]


def _port_index(jidx):
    return tpq.from_numpy(*jax_index_arrays(jidx), device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _same(td, ti, jd, ji, tol=1e-3):
    """The same empty (−1) slots, id-set overlap ≥ 0.99 over the filled
    ones, distances within ``tol``."""
    ti, ji = ti.numpy(), np.asarray(ji)
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti < 0, ji < 0)
    hits = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ti, ji))
    assert hits >= 0.99 * max(1, int((ji >= 0).sum()))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)


def _both(jidx, q, k, monkeypatch, grouped_env, tidx=None, **sp):
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", grouped_env)
    jd, ji = jpq.search(jidx, jnp.asarray(q), k, jpq.SearchParams(**sp))
    td, ti = tpq.search(tidx or _port_index(jidx), _t(q), k,
                        tpq.SearchParams(**sp), device="cpu")
    return td, ti, jd, ji


@pytest.mark.parametrize("pq_bits", [5, 8])
def test_recon_cache_is_the_jax_cache_bit_for_bit(corpus, pq_bits):
    jidx = _jax_index(corpus[0], pq_bits=pq_bits)
    tidx = _port_index(jidx)
    assert tidx.packed_recon.dtype == torch.bfloat16
    assert tuple(tidx.packed_recon.shape) == tuple(jidx.packed_recon.shape)
    np.testing.assert_array_equal(
        _bits(tidx.packed_recon),
        np.asarray(jidx.packed_recon).view(np.uint16))


@pytest.mark.parametrize("metric", METRICS)
def test_segk_tier_matches_jax(corpus, metric, monkeypatch):
    """scan_select="approx" over the cache: B5 (interpreted on the JAX
    side, the plain version here) and merge_bin_results."""
    x, q = corpus
    _same(*_both(_jax_index(x, metric), q, 10, monkeypatch, "always",
                 n_probes=8, scan_mode="grouped", scan_select="approx"))


@pytest.mark.parametrize("metric", METRICS)
def test_grouped_kernel_tier_matches_jax(corpus, metric, monkeypatch):
    """scan_select="exact" over the cache at kk ≤ 64: B6."""
    x, q = corpus
    _same(*_both(_jax_index(x, metric), q, 40, monkeypatch, "always",
                 n_probes=8, scan_mode="grouped", scan_select="exact"))


@pytest.mark.parametrize("cache,k,select", [
    ("never", 10, "exact"), ("never", 10, "approx"), ("never", 100, "exact"),
    ("always", 100, "exact"), ("always", 200, "approx")])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_plain_grouped_tier_matches_jax(corpus, cache, k, select, metric,
                                        monkeypatch):
    """The plain grouped tier: codes decoded per chunk (no cache), or the
    cache rows where kk is past the kernels' (exact kk > 64, approx
    kk > 128) — the JAX package's XLA tier on both counts."""
    x, q = corpus
    jidx = _jax_index(x, metric, cache=cache)
    assert (jidx.packed_recon is None) == (cache == "never")
    _same(*_both(jidx, q, k, monkeypatch, "never", n_probes=8,
                 scan_mode="grouped", scan_select=select, list_chunk=3))


def test_plain_tier_and_grouped_kernel_agree_across_the_bf16_norm(
        corpus, monkeypatch):
    """The grouped kernel's l2 keys use ‖c + d‖² from the bf16 rows, the
    plain tier (no cache) the stored f32 norms: the reference's own 2e-2
    (``tests/test_ivf_pq.py:334-336``)."""
    x, q = corpus
    kw = dict(n_probes=8, scan_mode="grouped", scan_select="exact")
    kd, ki = tpq.search(_port_index(_jax_index(x)), _t(q), 10,
                        tpq.SearchParams(**kw), device="cpu")
    pd, pi = tpq.search(_port_index(_jax_index(x, cache="never")), _t(q), 10,
                        tpq.SearchParams(**kw), device="cpu")
    np.testing.assert_allclose(kd.numpy(), pd.numpy(), rtol=2e-2, atol=2e-2)
    assert overlap(ki.numpy(), pi.numpy()) >= 0.95


@pytest.mark.parametrize("scan_select,k", [("pallas", 300), ("approx", 300)])
def test_lut_tier_fallbacks_match_jax(corpus, scan_select, k, monkeypatch):
    """n_probes·256 < k: the LUT tier declines (bin_capacity) and the
    search falls to the approx tier, which over the cache is segk."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    monkeypatch.setattr(tpq, "_lut_fallback_warned", False)
    x, q = corpus
    kw = dict(n_probes=1, scan_mode="grouped", scan_select=scan_select,
              lut_dtype="float32")
    if scan_select == "pallas":
        with pytest.warns(RuntimeWarning, match="bin_capacity"):
            out = _both(_jax_index(x), q, k, monkeypatch, "always", **kw)
    else:
        out = _both(_jax_index(x), q, k, monkeypatch, "always", **kw)
    _same(*out)


def test_mem_guard_fallback_matches_jax(corpus, monkeypatch):
    """The LUT-scan memory guard declines: scan_select="pallas" falls to
    approx in both packages."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    monkeypatch.setattr(tpq, "_lut_fallback_warned", False)
    monkeypatch.setattr(jic, "lut_scan_mem_ok", lambda *a, **k: False)
    monkeypatch.setattr(tic, "lut_scan_mem_ok", lambda *a, **k: False)
    x, q = corpus
    with pytest.warns(RuntimeWarning, match="mem_guard"):
        out = _both(_jax_index(x), q, 10, monkeypatch, "always", n_probes=8,
                    scan_mode="grouped", scan_select="pallas",
                    lut_dtype="float32")
    _same(*out)


def _long_list_index(seed: int = 3):
    """Random index fields with lists long enough (4 × 16384 slots, pq_dim
    16, 8-bit) that n_probes·L·pq_dim·256 reaches 2²⁸ at n_probes 4: the
    per_query tier's recon-dot branch. Norms are ‖c + d‖² of the f32
    reconstructions, as a build stores them."""
    rng = np.random.default_rng(seed)
    n_lists, L, S, P, K = 4, 16384, 16, 2, 256
    d = S * P
    codes = rng.integers(0, K, (n_lists, L, S)).astype(np.uint8)
    cb = rng.standard_normal((S, K, P)).astype(np.float32)
    centers = (rng.standard_normal((n_lists, d)) * 3).astype(np.float32)
    ids = rng.permutation(n_lists * L).astype(np.int32).reshape(n_lists, L)
    ids[:, L - 100:] = -1
    rec = centers[:, None, :] + cb[np.arange(S), codes].reshape(n_lists, L, d)
    arrays = dict(centers=centers, centers_rot=centers,
                  rotation=np.eye(d, dtype=np.float32), codebooks=cb,
                  packed_codes=codes, packed_ids=ids,
                  packed_norms=(rec * rec).sum(-1).astype(np.float32),
                  list_sizes=np.full(n_lists, L - 100, np.int32))
    meta = dict(metric="sqeuclidean", pq_bits=8, pq_dim=S,
                codebook_kind="per_subspace", has_recon=True)
    q = (rng.standard_normal((20, d)) * 3).astype(np.float32)
    return arrays, meta, q


def test_per_query_recon_dot_matches_jax():
    arrays, meta, q = _long_list_index()
    jidx = jax_index_from_arrays(arrays, meta)
    tidx = tpq.from_numpy(arrays, meta, device="cpu")
    L, S, K = tidx.max_list_size, tidx.pq_dim, tidx.codebooks.shape[1]
    assert 4 * L * S * K >= 1 << 28
    sp = dict(n_probes=4, scan_mode="per_query", lut_dtype="float32")
    jd, ji = jpq.search(jidx, jnp.asarray(q), 10, jpq.SearchParams(**sp))
    td, ti = tpq.search(tidx, _t(q), 10, tpq.SearchParams(**sp),
                        device="cpu")
    _same(td, ti, jd, ji, tol=1e-4)
    # the branch ran: the exact-LUT ADC (no cache) gives other distances
    tidx.packed_recon = None
    ad, _ = tpq.search(tidx, _t(q), 10, tpq.SearchParams(**sp),
                       device="cpu")
    assert not torch.equal(ad, td)


def _skewed(seed: int = 0):
    """16 centers, one holding ~40 % of the rows: with cap factor 1.0 the
    spill cascade runs out of choices for some rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 30, (16, 16)).astype(np.float32)
    assign = np.where(rng.random(8000) < 0.4, 0, rng.integers(1, 16, 8000))
    return (centers[assign]
            + rng.normal(0, 0.5, (8000, 16)).astype(np.float32))


def test_spill_build_matches_jax_on_the_same_labels(monkeypatch):
    """The port's spill build, given the JAX build's trained quantizer and
    its nearest-center choices, spills, drops and packs exactly as the JAX
    build does. (Both packages' choices agree only away from centers tied
    within f32 rounding, and a k-means fit puts several centers in the
    dense blob, so the choices are handed over.)"""
    from raft_tpu.cluster import kmeans_balanced as jkb

    x = _skewed()
    p = dict(n_lists=16, pq_dim=8, seed=0, spill=True,
             list_size_cap_factor=1.0, kmeans_n_iters=8)
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(**p))
    quant = tuple(_t(getattr(jidx, f)) for f in
                  ("centers", "rotation", "centers_rot", "codebooks"))
    lk = _t(jkb.predict_topk(jidx.centers, jnp.asarray(x), jic.SPILL_DEPTH,
                             jkb.KMeansBalancedParams(metric="l2")))
    monkeypatch.setattr(tpq, "_train_quantizers", lambda *a, **k: quant)
    monkeypatch.setattr(tpq.kmeans_balanced, "predict_topk",
                        lambda *a, **k: lk)
    with pytest.warns(RuntimeWarning, match="overflowed every spill choice"):
        tidx = tpq.build(_t(x), tpq.IndexParams(**p), device="cpu")
    L = tic._lane_round(int(x.shape[0] // 16 * 1.0))
    assert tidx.max_list_size == jidx.max_list_size == L
    np.testing.assert_array_equal(tidx.list_sizes.numpy(),
                                  np.asarray(jidx.list_sizes))
    assert x.shape[0] - tidx.size == x.shape[0] - int(jidx.size) > 0
    np.testing.assert_array_equal(tidx.packed_ids.numpy(),
                                  np.asarray(jidx.packed_ids))
    same = (tidx.packed_codes.numpy() == np.asarray(jidx.packed_codes))
    assert same.mean() > 0.999


def test_default_build_caches_and_searches(corpus):
    """A default ``IndexParams`` builds the cache (it is under the cap);
    the default search tier at a large batch takes the grouped kernel."""
    x, q = corpus
    idx = tpq.build(_t(x), tpq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM),
                    device="cpu")
    assert idx.packed_recon is not None
    assert tuple(idx.packed_recon.shape) == (N_LISTS, idx.max_list_size, D)
    np.testing.assert_array_equal(
        _bits(idx.packed_recon), _bits(tpq._build_recon_cache(idx)))
    _, i = tpq.search(idx, _t(np.tile(q, (4, 1))), 10,
                      tpq.SearchParams(n_probes=8), device="cpu")
    assert i.shape == (240, 10) and bool((i >= 0).all())


def test_fit_seg_chunk_and_list_chunk_match_jax():
    for args in ((128, 1536, 128, 64), (128, 4992, 96, 64), (16, 8, 4, 3),
                 (128, 1 << 20, 1024, 64)):
        assert tic.fit_seg_chunk(*args) == jic.fit_seg_chunk(*args)
    for args in ((1024, 3), (1000, 7), (17, 5), (8, 100)):
        assert tic.choose_list_chunk(*args) == jic.choose_list_chunk(*args)
    assert tic.CHUNK_BYTES_TARGET == jic.CHUNK_BYTES_TARGET


# ---------------------------------------------------------------------------
# filtered search over the cache (ROADMAP A6): every grouped tier scans the
# id table with the cleared ids set to −1
# ---------------------------------------------------------------------------

def _filtered_jax(jidx, q, k, sel, monkeypatch, grouped_env, dataset=None,
                  **sp):
    """A seeded keep mask at ``sel``, its JAX bitset, and the JAX
    package's filtered search."""
    keep = np.random.default_rng(int(sel * 1000) + 7).random(N) < sel
    bits = jbs.from_mask(jnp.asarray(keep))
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", grouped_env)
    jd, ji = jpq.search(jidx, jnp.asarray(q), k, jpq.SearchParams(**sp),
                        filter_bitset=bits,
                        dataset=None if dataset is None
                        else jnp.asarray(dataset))
    return keep, bits, jd, ji


# (tier, selectivity): segk (approx, B5) and the grouped kernel (exact kk
# 40, B6) over the cache, interpreted on the JAX side; the plain grouped
# tier (the JAX XLA tier) over the cache at exact kk 100 and over codes
# decoded per chunk without one
_RECON_FILTERED = ([("segk", s) for s in (0.01, 0.1, 0.5)]
                   + [("kernel", s) for s in (0.01, 0.1, 0.5)]
                   + [("plain", 0.1), ("plain_codes", 0.1)])
_TIER_SEARCH = {
    "segk": ("always", "always", 10, dict(scan_select="approx")),
    "kernel": ("always", "always", 40, dict(scan_select="exact")),
    "plain": ("always", "never", 100, dict(scan_select="exact")),
    "plain_codes": ("never", "never", 10, dict(scan_select="approx")),
}
_LABELS = {"segk": "segk", "kernel": "grouped_pallas",
           "plain": "grouped_xla", "plain_codes": "grouped_xla"}


@pytest.mark.parametrize("tier,sel", _RECON_FILTERED)
def test_filtered_grouped_tiers_match_jax(corpus, tier, sel, monkeypatch):
    x, q = corpus
    cache, env, k, sp = _TIER_SEARCH[tier]
    jidx = _jax_index(x, cache=cache)
    sp = dict(n_probes=8, scan_mode="grouped", list_chunk=3, **sp)
    keep, bits, jd, ji = _filtered_jax(jidx, q, k, sel, monkeypatch, env,
                                       **sp)
    tspans.reset()
    td, ti = tpq.search(_port_index(jidx), _t(q), k, tpq.SearchParams(**sp),
                        filter_bitset=np.asarray(bits), device="cpu")
    assert tspans.counts()["ivf_pq.scan.dispatch"] == {
        _LABELS[tier] + ",filtered=1": 1}
    assert_filtered_match(ti, td, ji, jd, keep, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("sel", [0.01, 0.1, 0.5])
def test_filtered_bench_legs_match_jax(corpus, sel, monkeypatch):
    """The ``ivf_pq.n1024.d64`` filter legs' search: approx over the cache
    (segk on the masked table) with refine_ratio 4 (the gather re-rank,
    the candidates masked first)."""
    x, q = corpus
    jidx = _jax_index(x)
    sp = dict(n_probes=8, scan_mode="grouped", scan_select="approx",
              refine="f32_regen", refine_ratio=4)
    keep, bits, jd, ji = _filtered_jax(jidx, q, 10, sel, monkeypatch,
                                       "always", dataset=x, **sp)
    tspans.reset()
    td, ti = tpq.search(_port_index(jidx), _t(q), 10, tpq.SearchParams(**sp),
                        filter_bitset=np.asarray(bits), dataset=_t(x),
                        device="cpu")
    counts = tspans.counts()
    assert counts["ivf_pq.scan.dispatch"] == {"segk,filtered=1": 1}
    assert counts["refine.dispatch"] == {"xla_gather,filtered=1": 1}
    assert_filtered_match(ti, td, ji, jd, keep, rtol=1e-3, atol=1e-3)
