"""save / load / extend of both IVF indexes: the port against the JAX
package, on the CPU.

The two packages share one file format (``core/serialize.py``): a file
written by either ``save`` loads in the other's ``load``, and the loaded
index searches as the saved one does. ``extend`` appends the same rows to
the same JAX-built index in both packages.

Tolerances: arrays equal exactly after a round trip (the IVF-PQ recon
cache, rebuilt on load, bit for bit); searches of a crossed index: ids
overlap ≥ 0.99 with the same empty slots, distances rtol = atol = 1e-4
(f32, different summation orders; 1e-3 over the bf16 cache); extend's
ids, fills and list sizes exact, codes equal on ≥ 99.9 % of rows (an
argmin over codebook distances may flip at an f32 tie).
"""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import serialize as jser
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq

from torch_parity import (FLAT_FIELDS, INDEX_FIELDS, blobs, jax_flat_arrays,
                          jax_index_arrays)

N, D = 3000, 32


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 30, seed=71), blobs(50, D, 30, seed=72)


_INDEXES = {}


def _jax_pq(x, cache="always"):
    if ("pq", cache) not in _INDEXES:
        _INDEXES[("pq", cache)] = jpq.build(jnp.asarray(x), jpq.IndexParams(
            n_lists=16, pq_dim=16, seed=0, cache_reconstruction=cache))
    return _INDEXES[("pq", cache)]


def _jax_flat(x):
    if "flat" not in _INDEXES:
        _INDEXES["flat"] = jfl.build(jnp.asarray(x), jfl.IndexParams(
            n_lists=16, kmeans_n_iters=8, seed=0))
    return _INDEXES["flat"]


def _same(td, ti, jd, ji, tol):
    ti, ji = ti.numpy(), np.asarray(ji)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    hits = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ti, ji))
    assert hits >= 0.99 * max(1, int((ji >= 0).sum()))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)


@pytest.mark.parametrize("value", [True, False, 0, -7, 2**40, 0.5, -1e300,
                                   "", "ivf_pq", "ünï"])
def test_scalars_cross_both_ways(value):
    for write, read in ((tser.serialize_scalar, jser.deserialize_scalar),
                        (jser.serialize_scalar, tser.deserialize_scalar)):
        f = io.BytesIO()
        write(f, value)
        f.seek(0)
        got = read(f)
        assert got == value and type(got) is type(value)


def test_header_and_arrays_cross_both_ways(tmp_path):
    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
              "b": np.array([-1, 5], np.int32), "c": np.zeros((0, 3), np.uint8),
              "d": np.float32(2.5)}
    meta = {"metric": "sqeuclidean", "has_recon": True, "pq_dim": 16}
    for save, load in ((tser.save_arrays, jser.load_arrays),
                       (jser.save_arrays, tser.load_arrays)):
        path = str(tmp_path / "x.bin")
        save(path, "kind", 3, meta, arrays)
        version, m, got = load(path, "kind")
        assert version == 3 and m == meta and list(got) == list(arrays)
        for name, a in arrays.items():
            np.testing.assert_array_equal(got[name], a)
            assert got[name].dtype == a.dtype
        with pytest.raises(ValueError, match="expected 'other'"):
            load(path, "other")


def test_tensor_blocks_and_bf16_records(tmp_path, monkeypatch):
    """Tensors stream in row blocks (a 64-byte block here); a bf16 tensor
    is a ``'<V2'`` record, as ``np.save`` writes the JAX package's bf16,
    and comes back bit for bit."""
    monkeypatch.setattr(tser, "_BLOCK_BYTES", 64)
    rng = np.random.default_rng(0)
    f32 = torch.tensor(rng.standard_normal((37, 5)).astype(np.float32))
    bf = torch.tensor(rng.standard_normal((9, 7, 3)).astype(np.float32)
                      ).to(torch.bfloat16)
    path = str(tmp_path / "t.bin")
    tser.save_arrays(path, "k", 1, {}, {"f": f32, "b": bf})
    _, _, got = tser.load_arrays(path, "k")
    assert got["b"].dtype.str == "|V2"
    assert torch.equal(tser.to_tensor(got["f"], "cpu"), f32)
    back = tser.to_tensor(got["b"], "cpu")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), bf.view(torch.int16))
    import ml_dtypes

    jb = np.asarray(bf.float().numpy(), dtype=ml_dtypes.bfloat16)
    f = io.BytesIO()
    np.save(f, jb)
    f.seek(0)
    assert torch.equal(tser.to_tensor(np.load(f), "cpu").view(torch.int16),
                       bf.view(torch.int16))


@pytest.mark.parametrize("cache", ["always", "never"])
def test_ivf_pq_files_cross_both_ways(corpus, cache, tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_pq(x, cache)
    # JAX save → port load: the same arrays, the cache rebuilt bit for bit
    path = str(tmp_path / "jax.ivfpq")
    jpq.save(jidx, path)
    tidx = tpq.load(path, device="cpu")
    arrays, _ = jax_index_arrays(jidx)
    for name in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      arrays[name])
    assert (tidx.packed_recon is None) == (cache == "never")
    if cache == "always":
        np.testing.assert_array_equal(
            tidx.packed_recon.view(torch.int16).numpy().view(np.uint16),
            np.asarray(jidx.packed_recon).view(np.uint16))
    # port save → JAX load: the JAX package searches it as the port does
    path2 = str(tmp_path / "port.ivfpq")
    tpq.save(tidx, path2)
    back = jpq.load(path2)
    assert (back.packed_recon is None) == (cache == "never")
    sp = dict(n_probes=8, scan_mode="grouped", scan_select="approx")
    jd, ji = jpq.search(back, jnp.asarray(q), 10, jpq.SearchParams(**sp))
    td, ti = tpq.search(tidx, _t(q), 10, tpq.SearchParams(**sp), device="cpu")
    _same(td, ti, jd, ji, 1e-3)
    # and the port reads its own file back unchanged
    again = tpq.load(path2, device="cpu")
    for name in INDEX_FIELDS:
        assert torch.equal(getattr(again, name), getattr(tidx, name))


def test_ivf_pq_load_refuses_folded_codes(corpus, tmp_path):
    jidx = _jax_pq(corpus[0], "never")
    folded = jidx.replace(packed_codes=jidx.packed_codes.reshape(
        16, -1, 128), codes_folded=True)
    path = str(tmp_path / "folded.ivfpq")
    jpq.save(folded, path)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tpq.load(path, device="cpu")


def test_ivf_flat_files_cross_both_ways(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_flat(x)
    path = str(tmp_path / "jax.ivfflat")
    jfl.save(jidx, path)
    tidx = tfl.load(path, device="cpu")
    arrays, _ = jax_flat_arrays(jidx)
    for name in FLAT_FIELDS:
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      arrays[name])
    path2 = str(tmp_path / "port.ivfflat")
    tfl.save(tidx, path2)
    back = jfl.load(path2)
    for sp in (dict(n_probes=4, scan_mode="per_query"),
               dict(n_probes=4, scan_mode="grouped", scan_select="exact")):
        jd, ji = jfl.search(back, jnp.asarray(q), 10, jfl.SearchParams(**sp))
        td, ti = tfl.search(tidx, _t(q), 10, tfl.SearchParams(**sp),
                            device="cpu")
        _same(td, ti, jd, ji, 1e-4)


def test_ivf_flat_bf16_round_trip(corpus, tmp_path):
    tidx = tfl.from_numpy(*jax_flat_arrays(_jax_flat(corpus[0])),
                          device="cpu")
    tidx.packed_data = tidx.packed_data.to(torch.bfloat16)
    path = str(tmp_path / "bf16.ivfflat")
    tfl.save(tidx, path)
    back = tfl.load(path, device="cpu")
    assert back.packed_data.dtype == torch.bfloat16
    for name in FLAT_FIELDS:
        a, b = getattr(back, name), getattr(tidx, name)
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("cache", ["always", "never"])
def test_ivf_pq_extend_matches_jax(corpus, cache):
    x, _ = corpus
    jidx = _jax_pq(x, cache)
    new = blobs(700, D, 30, seed=73)
    jext = jpq.extend(jidx, jnp.asarray(new))
    text = tpq.extend(tpq.from_numpy(*jax_index_arrays(jidx), device="cpu"),
                      _t(new))
    assert text.max_list_size == jext.max_list_size
    for name in ("packed_ids", "list_sizes"):
        np.testing.assert_array_equal(getattr(text, name).numpy(),
                                      np.asarray(getattr(jext, name)))
    assert text.size == N + 700
    same = (text.packed_codes.numpy() == np.asarray(jext.packed_codes)
            ).all(-1)
    assert same.mean() > 0.999
    np.testing.assert_allclose(text.packed_norms.numpy()[same],
                               np.asarray(jext.packed_norms)[same],
                               rtol=1e-4, atol=1e-3)
    assert (text.packed_recon is None) == (cache == "never")
    if cache == "always":
        np.testing.assert_array_equal(
            text.packed_recon.view(torch.int16).numpy().view(np.uint16)[same],
            np.asarray(jext.packed_recon).view(np.uint16)[same])


def test_ivf_pq_extend_of_an_empty_build_matches_jax(corpus):
    """add_data_on_build=False gives the JAX package's empty lists; extend
    then fills them with explicit ids."""
    x, _ = corpus
    p = dict(n_lists=16, pq_dim=16, seed=0, add_data_on_build=False)
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(**p))
    tidx = tpq.build(_t(x), tpq.IndexParams(**p), device="cpu")
    for name in ("packed_codes", "packed_ids", "packed_norms", "list_sizes"):
        a, b = getattr(tidx, name), np.asarray(getattr(jidx, name))
        assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    assert tidx.size == 0 and tidx.packed_recon is None
    seeded = tpq.from_numpy(*jax_index_arrays(jidx), device="cpu")
    ids = np.arange(N, dtype=np.int32)[::-1].copy()
    jext = jpq.extend(jidx, jnp.asarray(x), jnp.asarray(ids))
    text = tpq.extend(seeded, _t(x), _t(ids))
    np.testing.assert_array_equal(text.packed_ids.numpy(),
                                  np.asarray(jext.packed_ids))
    np.testing.assert_array_equal(text.list_sizes.numpy(),
                                  np.asarray(jext.list_sizes))


def test_ivf_flat_extend_matches_jax(corpus):
    x, _ = corpus
    jidx = _jax_flat(x)
    new = blobs(500, D, 30, seed=74)
    jext = jfl.extend(jidx, jnp.asarray(new))
    text = tfl.extend(tfl.from_numpy(*jax_flat_arrays(jidx), device="cpu"),
                      _t(new))
    for name in ("packed_data", "packed_ids", "list_sizes"):
        np.testing.assert_array_equal(getattr(text, name).numpy(),
                                      np.asarray(getattr(jext, name)))
    np.testing.assert_allclose(text.packed_norms.numpy(),
                               np.asarray(jext.packed_norms), rtol=1e-6)
