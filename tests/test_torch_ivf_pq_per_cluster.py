"""IVF-PQ with per_cluster codebooks (ROADMAP A9): the port against the JAX
package, on the CPU.

The trainer's pieces take the same numpy inputs and the same threefry key
in both packages; a JAX-built per_cluster index (n = 3000, d = 32, 16
lists, pq_dim 16, 4-bit codes, the recon cache built) crosses to the port
through ``from_numpy`` and both search the same seeded queries. The JAX
side runs its interpreted B5/B6 under ``RAFT_TPU_PALLAS_GROUPED=always``.

Tolerances: the initial centroid rows (the Gumbel top-k draw) equal; the
trained codebooks within 1e-5 (f32 sums in another order); codes equal
but where two codes tie in f64 within 1e-4 relative, norms within 1e-5
relative; the recon cache equal bit for bit, and within bf16 rounding
(2⁻⁸ relative) of the f32 decode; search ids overlapping ≥ 0.99 with the
same empty slots and distances within 1e-4 (1e-3 over the cache, the
reference's tolerance); files, checkpoints and extensions bit for bit.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.random import threefry

from torch_parity import (INDEX_FIELDS, blobs, jax_index_arrays,
                          jax_index_from_arrays)

N, D, N_LISTS, PQ_DIM, BITS = 3000, 32, 16, 16, 4
K, P = 1 << BITS, D // PQ_DIM


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 30, seed=81), blobs(60, D, 30, seed=82)


def _params(cls, **kw):
    return cls.IndexParams(**{**dict(
        n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=BITS, kmeans_n_iters=6,
        codebook_kind="per_cluster", cache_reconstruction="always", seed=0),
        **kw})


@pytest.fixture(scope="module")
def jidx(corpus):
    return jpq.build(jnp.asarray(corpus[0]), _params(jpq))


def _port(jindex):
    return tpq.from_numpy(*jax_index_arrays(jindex), device="cpu")


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _residual_case(seed=3, n_train=1500, n_lists=8, pq_dim=8, pq_len=2):
    rng = np.random.default_rng(seed)
    res = rng.standard_normal((n_train, pq_dim * pq_len)).astype(np.float32)
    labels = rng.integers(0, n_lists, n_train).astype(np.int32)
    labels[labels == n_lists - 1] = 0   # one empty cluster: pads only
    return res, labels


def _keys(seed):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 2),
            threefry.fold_in(threefry.prng_key(seed), 2))


def test_initial_centroids_are_the_jax_draw():
    """n_iters 0 returns the initial rows; the per-cluster Gumbel top-k
    draws the JAX package's rows (an empty cluster: its first k pads)."""
    res, labels = _residual_case()
    jkey, tkey = _keys(5)
    n_sub = res.shape[0] * 8
    flat, lbl = res.reshape(n_sub, 2), np.repeat(labels, 8)
    cap = 3008
    (jp,), _, sizes, _, _ = _pack(flat, lbl, cap)
    mask = np.arange(cap)[None, :] < np.asarray(sizes)[:, None]
    j0 = np.asarray(jpq._vmapped_lloyd_masked(jp, jnp.asarray(mask), K, 0,
                                              jkey))
    t0 = tpq._vmapped_lloyd_masked(_t(jp), _t(mask), K, 0, tkey).numpy()
    np.testing.assert_array_equal(t0, j0)
    # the indices themselves, against jax.random.choice's
    w = mask.astype(np.float32)
    p = w / np.maximum(w.sum(1, keepdims=True), 1.0)
    jc = np.stack([np.asarray(jax.random.choice(
        kk, cap, (K,), replace=False, p=jnp.asarray(pc)))
        for kk, pc in zip(jax.random.split(jkey, 8), p)])
    np.testing.assert_array_equal(
        tpq._cluster_init_indices(_t(mask), K, tkey).numpy(), jc)


def _pack(flat, lbl, cap):
    from raft_tpu.neighbors import ivf_common as jic

    return jic.pack_lists((jnp.asarray(flat),), jnp.asarray(lbl),
                          jnp.arange(flat.shape[0], dtype=jnp.int32), 8, cap,
                          (jnp.float32(0),))


def test_train_per_cluster_matches_jax():
    res, labels = _residual_case(seed=4)
    jkey, tkey = _keys(2)
    jcb = np.asarray(jpq._train_per_cluster(
        jnp.asarray(res), jnp.asarray(labels), 8, 8, 2, K, 5, jkey))
    tcb = tpq._train_per_cluster(_t(res), _t(labels), 8, 8, 2, K, 5,
                                 tkey).numpy()
    assert tcb.shape == (8, K, 2)
    np.testing.assert_allclose(tcb, jcb, rtol=1e-5, atol=1e-5)


def test_codes_and_norms_match_jax(jidx, corpus):
    """The per_cluster encode of the JAX index's own quantizers: codes
    equal but at f64 ties, norms within 1e-5 relative."""
    x = corpus[0][:600]
    x_rot = x @ np.asarray(jidx.rotation).T
    labels = np.random.default_rng(0).integers(0, N_LISTS, 600).astype(
        np.int32)
    cb, crot = np.asarray(jidx.codebooks), np.asarray(jidx.centers_rot)
    jc, jn = jpq._encode_with_norms(jnp.asarray(x_rot), jnp.asarray(crot),
                                    jnp.asarray(labels), jnp.asarray(cb),
                                    "per_cluster")
    tc, tn = tpq._encode_with_norms(_t(x_rot), torch.eye(D), _t(crot),
                                    _t(labels), _t(cb), "per_cluster")
    jc, tc = np.asarray(jc).astype(np.int64), tc.numpy().astype(np.int64)
    sub = (x_rot - crot[labels]).reshape(600, PQ_DIM, P).astype(np.float64)
    cb64 = cb.astype(np.float64)[labels]                    # [n, K, P]
    rows, subs = np.nonzero(tc != jc)
    for r, s in zip(rows, subs):
        da = ((sub[r, s] - cb64[r, tc[r, s]]) ** 2).sum()
        db = ((sub[r, s] - cb64[r, jc[r, s]]) ** 2).sum()
        assert abs(da - db) <= 1e-4 * max(db, 1.0), (r, s, da, db)
    assert rows.size <= 0.001 * tc.size
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-5)


def test_decode_and_recon_cache_match_jax(jidx):
    tidx = _port(jidx)
    assert tidx.codebook_kind == "per_cluster"
    np.testing.assert_array_equal(_bf16_bits(tidx.packed_recon),
                                  np.asarray(jidx.packed_recon).view(np.uint16))
    codes = tpq.unpack_bits(tidx.packed_codes, PQ_DIM, BITS)
    dec = tpq._decode_lists_cluster(codes, tidx.codebooks)
    jdec = jpq._decode_lists_cluster(jidx.unpack_codes(jidx.packed_codes),
                                     jidx.codebooks)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    full = (dec + tidx.centers_rot[:, None, :]).numpy()
    np.testing.assert_allclose(tidx.packed_recon.float().numpy(), full,
                               rtol=2.0 ** -8, atol=1e-6)


def _same(td, ti, jd, ji, tol):
    ti, ji = ti.numpy(), np.asarray(ji)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    hits = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ti, ji))
    assert hits >= 0.99 * max(1, int((ji >= 0).sum()))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode,select,tol", [
    ("per_query", "exact", 1e-4), ("grouped", "approx", 1e-3),
    ("grouped", "exact", 1e-3)])
def test_search_matches_jax(jidx, corpus, monkeypatch, mode, select, tol):
    """per_query (a LUT a probed list) and the grouped tiers over the
    cache, the same JAX index on both sides."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    q = corpus[1]
    sp = dict(n_probes=8, scan_mode=mode, scan_select=select)
    jd, ji = jpq.search(jidx, jnp.asarray(q), 10, jpq.SearchParams(**sp))
    td, ti = tpq.search(_port(jidx), _t(q), 10, tpq.SearchParams(**sp),
                        device="cpu")
    _same(td, ti, jd, ji, tol)


def test_grouped_search_without_cache_matches_jax(jidx, corpus, monkeypatch):
    """No cache: each probed list decoded against its own codebook (the
    plain grouped tier; the JAX package's XLA tier)."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "never")
    arrays, meta = jax_index_arrays(jidx)
    meta = dict(meta, has_recon=False)
    jn = jax_index_from_arrays(arrays, meta)
    q = corpus[1]
    sp = dict(n_probes=8, scan_mode="grouped", scan_select="exact")
    jd, ji = jpq.search(jn, jnp.asarray(q), 10, jpq.SearchParams(**sp))
    td, ti = tpq.search(tpq.from_numpy(arrays, meta, device="cpu"), _t(q),
                        10, tpq.SearchParams(**sp), device="cpu")
    _same(td, ti, jd, ji, 1e-4)


def test_lut_tier_declines_per_cluster(jidx, corpus, monkeypatch):
    """An explicit scan_select="pallas" counts the fallback with reason
    per_cluster, warns, and answers as "approx" does."""
    monkeypatch.setattr(tpq, "_lut_fallback_warned", False)
    tidx, q = _port(jidx), _t(corpus[1])
    tspans.reset()
    with pytest.warns(RuntimeWarning, match="reason=per_cluster"):
        _, ti = tpq.search(tidx, q, 10, tpq.SearchParams(
            n_probes=8, scan_mode="grouped", scan_select="pallas"),
            device="cpu")
    assert tspans.total("ivf_pq.scan.fallback", reason="per_cluster") == 1
    assert tspans.total("ivf_pq.scan.dispatch", impl="pallas_lut") == 0
    _, ta = tpq.search(tidx, q, 10, tpq.SearchParams(
        n_probes=8, scan_mode="grouped", scan_select="approx"), device="cpu")
    assert torch.equal(ti, ta)


def test_refusals(jidx, corpus):
    """search_staged and the sharded builds refuse per_cluster, as the JAX
    package does."""
    from raft_tpu_torch.parallel import make_mesh

    tidx = _port(jidx)
    with pytest.raises(LogicError, match="per_subspace"):
        tpq.search_staged(tidx, _t(corpus[1]), 10, device="cpu")
    with pytest.raises(LogicError, match="per_subspace"):
        tpq.build_distributed(corpus[0], _params(tpq),
                              mesh=make_mesh(2, device="cpu"))


def test_extend_save_load_both_ways(jidx, corpus, tmp_path):
    """extend of the crossed index equals the JAX package's (codes, ids,
    sizes; norms within 1e-5); files written by either package load in the
    other with the same arrays and codebook kind."""
    new = blobs(200, D, 30, seed=83)
    jext = jpq.extend(jidx, jnp.asarray(new))
    text = tpq.extend(_port(jidx), _t(new))
    for name in ("packed_codes", "packed_ids", "list_sizes"):
        np.testing.assert_array_equal(getattr(text, name).numpy(),
                                      np.asarray(getattr(jext, name)))
    np.testing.assert_allclose(text.packed_norms.numpy(),
                               np.asarray(jext.packed_norms), rtol=1e-5,
                               atol=1e-5)
    assert text.packed_recon is not None
    tpath, jpath = str(tmp_path / "t.idx"), str(tmp_path / "j.idx")
    tpq.save(text, tpath)
    jpq.save(jext, jpath)
    jl, tl = jpq.load(tpath), tpq.load(jpath, device="cpu")
    assert jl.codebook_kind == tl.codebook_kind == "per_cluster"
    for name in INDEX_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jl, name)),
                                      getattr(text, name).numpy())
    np.testing.assert_array_equal(_bf16_bits(tl.packed_recon),
                                  np.asarray(jext.packed_recon).view(np.uint16))


def test_build_chunked_checkpoints_cross(corpus, tmp_path):
    """A per_cluster ``build_chunked`` checkpoint (its [n_lists, K, P]
    codebooks) written by the port resumes in the JAX package and the JAX
    package's resumes in the port: each equal to its writer's
    uninterrupted build."""
    from raft_tpu.robust import faults as jfaults
    from raft_tpu_torch.robust import faults as tfaults

    x = corpus[0]
    plan = {"faults": [{"site": "build.chunk_encode", "kind": "error",
                        "after": 3}]}
    kw = dict(chunk_rows=600)
    tfull = tpq.build_chunked(x, _params(tpq), device="cpu", **kw)
    jfull = jpq.build_chunked(x, _params(jpq), **kw)
    for writer, full, resumer in (("port", tfull, "jax"),
                                  ("jax", jfull, "port")):
        d = str(tmp_path / writer)
        faults = tfaults if writer == "port" else jfaults
        faults.install_plan(plan)
        try:
            with pytest.raises(Exception):
                if writer == "port":
                    tpq.build_chunked(x, _params(tpq), checkpoint_dir=d,
                                      device="cpu", **kw)
                else:
                    jpq.build_chunked(x, _params(jpq), checkpoint_dir=d, **kw)
        finally:
            faults.clear_plan()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = (jpq.build_chunked(x, _params(jpq), checkpoint_dir=d,
                                     resume=True, **kw)
                   if resumer == "jax" else
                   tpq.build_chunked(x, _params(tpq), checkpoint_dir=d,
                                     resume=True, device="cpu", **kw))
        assert out.codebook_kind == "per_cluster"
        for name in ("codebooks", "packed_codes", "packed_ids",
                     "list_sizes"):
            a = getattr(out, name)
            b = getattr(full, name)
            np.testing.assert_array_equal(
                a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
                b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b))
