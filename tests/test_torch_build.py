"""The port's IVF-PQ build against the JAX package's, on the CPU.

The two builds draw different random numbers from one seed (torch and
JAX generators differ), so whole indexes are compared by what they are
for: recall@10 on the same seeded numpy data. The deterministic pieces
(balanced Lloyd sweeps, list packing, encoding) get the same inputs on
both sides and are compared directly; an index crosses between the two
packages through ``to_numpy``/``from_numpy``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.neighbors import ivf_common as jic
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.neighbors import ivf_common as tic
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.random.rng import RngState

from torch_parity import (blobs, exact_knn, jax_index_from_arrays, overlap)

N, D = 3000, 32
PARAMS = dict(n_lists=16, pq_dim=16, seed=0, cache_reconstruction="never")


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def corpus():
    x = blobs(N, D, 30, seed=31)
    q = blobs(80, D, 30, seed=32)
    return x, q, exact_knn(x, q, 10)


@pytest.fixture(scope="module")
def port_index(corpus):
    return tpq.build(_t(corpus[0]), tpq.IndexParams(**PARAMS), device="cpu")


def _per_query(k=10, n_probes=4):
    return dict(n_probes=n_probes, scan_mode="per_query",
                lut_dtype="float32")


def test_port_build_recall_matches_jax(corpus, port_index):
    x, q, gt = corpus
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(**PARAMS))
    _, ji = jpq.search(jidx, jnp.asarray(q), 10,
                       jpq.SearchParams(**_per_query()))
    _, ti = tpq.search(port_index, _t(q), 10,
                       tpq.SearchParams(**_per_query()), device="cpu")
    r_jax, r_port = overlap(np.asarray(ji), gt), overlap(ti.numpy(), gt)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)
    assert port_index.size == N
    assert port_index.packed_ids.dtype == torch.int32


def test_port_index_searched_by_jax(corpus, port_index):
    """to_numpy of a port-built index, searched by the JAX package, gives
    the port's own answers."""
    x, q, _ = corpus
    jidx = jax_index_from_arrays(*tpq.to_numpy(port_index))
    _, ji = jpq.search(jidx, jnp.asarray(q), 10,
                       jpq.SearchParams(**_per_query()))
    _, ti = tpq.search(port_index, _t(q), 10,
                       tpq.SearchParams(**_per_query()), device="cpu")
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99


def test_port_build_refined_recall(corpus, port_index):
    """The slice's own search settings (LUT tier, bf16 LUT, refined)."""
    x, q, gt = corpus
    _, ti = tpq.search(port_index, _t(q), 10, tpq.SearchParams(
        n_probes=8, scan_select="pallas", refine="f32_regen",
        refine_ratio=40, lut_dtype="bfloat16"), dataset=_t(x), device="cpu")
    assert overlap(ti.numpy(), gt) >= 0.95


@pytest.mark.parametrize("metric", ["inner_product", "cosine"])
def test_port_build_other_metrics(corpus, metric):
    x, q, _ = corpus
    idx = tpq.build(_t(x), tpq.IndexParams(metric=metric, **PARAMS),
                    device="cpu")
    jidx = jax_index_from_arrays(*tpq.to_numpy(idx))
    _, ji = jpq.search(jidx, jnp.asarray(q), 10,
                       jpq.SearchParams(**_per_query()))
    _, ti = tpq.search(idx, _t(q), 10, tpq.SearchParams(**_per_query()),
                       device="cpu")
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99


def test_balanced_lloyd_matches_jax():
    """Quality sweeps (no random split phase) from the same start."""
    x = blobs(1200, 16, 12, seed=3)
    c0 = x[np.random.default_rng(0).choice(1200, 12, replace=False)]
    w = np.ones(1200, np.float32)
    jc = jkb._balanced_lloyd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c0),
                             12, 8, jax.random.PRNGKey(0))
    tc = tkb._balanced_lloyd(_t(x), _t(w), _t(c0), 12, 8, RngState(0))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4)


def test_balanced_lloyd_batched_matches_jax():
    rng = np.random.default_rng(4)
    M, T, k, d = 3, 200, 6, 8
    xs = np.stack([blobs(T, d, 5, seed=s) for s in range(M)])
    ws = (rng.random((M, T)) > 0.1).astype(np.float32)
    c0s = xs[:, :k].copy()
    kmask = np.ones((M, k), np.float32)
    kmask[1, 4:] = 0
    jc = jkb._balanced_lloyd_batched(jnp.asarray(xs), jnp.asarray(ws),
                                     jnp.asarray(c0s), jnp.asarray(kmask),
                                     k, 6)
    tc = tkb._balanced_lloyd_batched(_t(xs), _t(ws), _t(c0s), _t(kmask),
                                     k, 6)
    act = kmask.astype(bool)
    np.testing.assert_allclose(tc.numpy()[act], np.asarray(jc)[act],
                               rtol=1e-4, atol=1e-4)


def test_kmeans_balanced_fit_quality_matches_jax():
    x = blobs(4000, 16, 40, seed=5)
    params = dict(n_iters=10, seed=0)
    jc = np.asarray(jkb.fit(jnp.asarray(x), 64,
                            jkb.KMeansBalancedParams(**params)))
    tc = tkb.fit(_t(x), 64, tkb.KMeansBalancedParams(**params))
    assert tc.shape == (64, 16)

    def inertia(c):
        return float(((x[:, None] - c[None]) ** 2).sum(-1).min(1).mean())

    assert inertia(tc.numpy()) <= 1.1 * inertia(jc)
    lab = tkb.predict(tc, _t(x)).numpy()
    np.testing.assert_array_equal(lab, np.asarray(jkb.predict(
        jnp.asarray(tc.numpy()), jnp.asarray(x))))


def test_pack_lists_matches_jax():
    rng = np.random.default_rng(6)
    n, n_lists, L = 500, 9, 64
    labels = rng.integers(0, n_lists, n).astype(np.int32)
    labels[:80] = 2  # an overflowing list
    rows = rng.standard_normal((n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    jp, jids, jsz, jdrop, jaddr = jic.pack_lists(
        [jnp.asarray(rows)], jnp.asarray(labels), jnp.asarray(ids),
        n_lists=n_lists, L=L, fill_values=[0.0])
    tp, tids, tsz, tdrop, taddr = tic.pack_lists(
        [_t(rows)], _t(labels), _t(ids), n_lists=n_lists, L=L,
        fill_values=[0.0])
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tsz.numpy(), np.asarray(jsz))
    assert tdrop == int(jdrop) > 0
    for a, b in zip(taddr, jaddr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_encode_with_norms_matches_jax(corpus):
    x = corpus[0][:1000]
    jidx = jpq.build(jnp.asarray(corpus[0]), jpq.IndexParams(**PARAMS))
    labels = np.asarray(jkb.predict(jidx.centers, jnp.asarray(x)))
    jcodes, jnorms = jpq._encode_with_norms(
        jnp.asarray(x) @ jidx.rotation.T, jidx.centers_rot,
        jnp.asarray(labels), jidx.codebooks, "per_subspace")
    tcodes, tnorms = tpq._encode_with_norms(
        _t(x), _t(jidx.rotation), _t(jidx.centers_rot), _t(labels),
        _t(jidx.codebooks))
    assert float((tcodes.numpy() == np.asarray(jcodes)).mean()) > 0.999
    same = (tcodes.numpy() == np.asarray(jcodes)).all(1)
    np.testing.assert_allclose(tnorms.numpy()[same], np.asarray(jnorms)[same],
                               rtol=1e-4, atol=1e-3)


def test_build_is_deterministic_per_seed(corpus):
    x = _t(corpus[0][:1500])
    p = tpq.IndexParams(**{**PARAMS, "n_lists": 8})
    a, b = tpq.build(x, p, device="cpu"), tpq.build(x, p, device="cpu")
    for name in ("centers", "codebooks", "packed_codes", "packed_ids"):
        assert torch.equal(getattr(a, name), getattr(b, name))
