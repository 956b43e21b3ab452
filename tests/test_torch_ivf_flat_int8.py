"""IVF-Flat over int8 and uint8 data (ROADMAP A19) and the chunked pack of
wide datasets (A10): the port against the JAX package, on the CPU.

Both packages build on the same seeded byte rows; for the lists to be
comparable the port's coarse fit is handed the JAX index's centers. A
JAX-built byte index crosses to the port through ``from_numpy`` and both
search the same f32 queries (the JAX side's interpreted B5/B6 under
``RAFT_TPU_PALLAS_GROUPED=always``, the port's plain versions).

Tolerances: lists, ids, sizes and drops equal (the assignment is exact on
the same centers); search ids overlapping ≥ 0.99 with the same empty
slots, distances within 1e-4 relative (integer rows, f32 sums in another
order); the reference's own recall bar (0.9) on ``test_int8_data``'s case;
files and the chunked pack bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import ivf_common as jic
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu_torch.core import bitset as tbs
from raft_tpu_torch.neighbors import ivf_common as tic
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.obs import spans as tspans

from torch_parity import (FLAT_FIELDS, blobs, jax_flat_arrays,
                          jax_flat_from_arrays)

N, D, N_LISTS = 2000, 16, 16
DTYPES = ["int8", "uint8"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _bytes(x, dtype):
    """The reference test's int8 cast (``tests/test_ivf_flat.py:116-125``),
    and its uint8 twin shifted into [0, 255]."""
    if dtype == "int8":
        return np.clip(x * 10, -127, 127).astype(np.int8)
    return np.clip(x * 10 + 128, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 30, seed=91), blobs(50, D, 30, seed=92)


_INDEXES = {}


def _jax_index(x8, dtype):
    if dtype not in _INDEXES:
        _INDEXES[dtype] = jfl.build(jnp.asarray(x8), jfl.IndexParams(
            n_lists=N_LISTS, kmeans_n_iters=8, seed=0))
    return _INDEXES[dtype]


def _port(jidx):
    return tfl.from_numpy(*jax_flat_arrays(jidx), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_data_both_packages(corpus, dtype):
    """The reference's ``test_int8_data`` on both packages: recall@10 of
    n_probes 16 against exact search on the bytes as f32 ≥ 0.9; the port
    keeps the lists in the data's dtype, norms of the f32 cast."""
    x, q = corpus
    x8, q8 = _bytes(x, dtype), _bytes(q, dtype).astype(np.float32)
    ref = np.argsort(cdist(q8, x8.astype(np.float32), "sqeuclidean"),
                     1)[:, :10]
    jidx = _jax_index(x8, dtype)
    tidx = tfl.build(x8, tfl.IndexParams(n_lists=N_LISTS, seed=0),
                     device="cpu")
    assert str(tidx.packed_data.dtype) == f"torch.{dtype}"
    f = tidx.packed_data.float()
    np.testing.assert_array_equal(tidx.packed_norms.numpy(),
                                  (f * f).sum(-1).numpy())
    _, jids = jfl.search(jidx, jnp.asarray(q8), 10,
                         jfl.SearchParams(n_probes=16))
    _, tids = tfl.search(tidx, _t(q8), 10, tfl.SearchParams(n_probes=16),
                         device="cpu")
    for ids in (np.asarray(jids), tids.numpy()):
        rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, ref)])
        assert rec >= 0.9


@pytest.mark.parametrize("dtype", DTYPES)
def test_lists_equal_from_the_same_centers(corpus, dtype, monkeypatch):
    """The port's build handed the JAX index's centers packs the same
    byte lists, ids and sizes (spill on and off)."""
    x8 = _bytes(corpus[0], dtype)
    for spill in (False, True):
        jidx = jfl.build(jnp.asarray(x8), jfl.IndexParams(
            n_lists=N_LISTS, kmeans_n_iters=8, seed=0, spill=spill,
            list_size_cap_factor=1.5))
        centers = _t(jidx.centers)
        monkeypatch.setattr(tfl.kmeans_balanced, "fit",
                            lambda *a, **k: centers.clone())
        tidx = tfl.build(x8, tfl.IndexParams(
            n_lists=N_LISTS, seed=0, spill=spill, list_size_cap_factor=1.5),
            device="cpu")
        for name in ("packed_data", "packed_ids", "list_sizes",
                     "packed_norms"):
            np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                          np.asarray(getattr(jidx, name)))


def _same(td, ti, jd, ji):
    ti, ji = ti.numpy(), np.asarray(ji)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    hits = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ti, ji))
    assert hits >= 0.99 * max(1, int((ji >= 0).sum()))
    fin = ji >= 0
    np.testing.assert_allclose(td.numpy()[fin], np.asarray(jd)[fin],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,select", [("per_query", "exact"),
                                         ("grouped", "approx"),
                                         ("grouped", "exact")])
def test_search_matches_jax(corpus, dtype, mode, select, monkeypatch):
    """The same JAX byte index on both sides: per_query on the cast rows,
    the grouped tiers reading the byte lists (B5, B6)."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_index(_bytes(x, dtype), dtype)
    q8 = _bytes(q, dtype).astype(np.float32)
    sp = dict(n_probes=6, scan_mode=mode, scan_select=select)
    jd, ji = jfl.search(jidx, jnp.asarray(q8), 10, jfl.SearchParams(**sp))
    td, ti = tfl.search(_port(jidx), _t(q8), 10, tfl.SearchParams(**sp),
                        device="cpu")
    _same(td, ti, jd, ji)


@pytest.mark.parametrize("dtype", DTYPES)
def test_filtered_search_matches_jax(corpus, dtype, monkeypatch):
    """A filter at selectivity ~0.3 over a byte index, the exact grouped
    tier on both sides: the same ids but at ties, no cleared id."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "always")
    x, q = corpus
    jidx = _jax_index(_bytes(x, dtype), dtype)
    keep = np.random.default_rng(7).random(N) < 0.3
    q8 = _bytes(q, dtype).astype(np.float32)
    sp = dict(n_probes=6, scan_mode="grouped", scan_select="exact")
    jd, ji = jfl.search(jidx, jnp.asarray(q8), 10, jfl.SearchParams(**sp),
                        filter_bitset=jbs.from_mask(jnp.asarray(keep)))
    td, ti = tfl.search(_port(jidx), _t(q8), 10, tfl.SearchParams(**sp),
                        filter_bitset=tbs.from_mask(keep, device="cpu"),
                        device="cpu")
    ji = np.where(np.isfinite(np.asarray(jd)), np.asarray(ji), -1)
    _same(td, ti, jd, ji)
    got = ti.numpy()
    assert keep[got[got >= 0]].all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_extend_save_load_both_ways(corpus, dtype, tmp_path):
    """extend keeps the dtype and equals the JAX package's; files written
    by either package load in the other with the same byte arrays."""
    x, _ = corpus
    jidx = _jax_index(_bytes(x, dtype), dtype)
    new = _bytes(blobs(150, D, 30, seed=93), dtype)
    jext = jfl.extend(jidx, jnp.asarray(new))
    text = tfl.extend(_port(jidx), _t(new))
    assert text.packed_data.dtype == _t(new).dtype
    for name in FLAT_FIELDS:
        np.testing.assert_array_equal(getattr(text, name).numpy(),
                                      np.asarray(getattr(jext, name)))
    tpath, jpath = str(tmp_path / "t.idx"), str(tmp_path / "j.idx")
    tfl.save(text, tpath)
    jfl.save(jext, jpath)
    jl, tl = jfl.load(tpath), tfl.load(jpath, device="cpu")
    back = tfl.from_numpy(*jax_flat_arrays(jax_flat_from_arrays(
        *tfl.to_numpy(text))), device="cpu")
    for name in FLAT_FIELDS:
        want = getattr(text, name).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(jl, name)), want)
        np.testing.assert_array_equal(getattr(tl, name).numpy(), want)
        np.testing.assert_array_equal(getattr(back, name).numpy(), want)
    assert np.asarray(jl.packed_data).dtype == np.dtype(dtype)


@pytest.mark.parametrize("L,chunk", [(96, 300), (120, 1 << 16), (40, 77)])
def test_pack_rows_chunked_is_pack_lists(L, chunk):
    """Rows, ids, sizes and the drop count of the chunked pack equal the
    one-shot pack's bit for bit, and the JAX package's chunked pack's;
    labels outside [0, n_lists) (spill markers, −1) are in no list and no
    drop count, rows past L are dropped."""
    rng = np.random.default_rng(L + chunk)
    x = rng.integers(-128, 128, (1500, 12)).astype(np.int8)
    labels = rng.integers(0, N_LISTS, 1500).astype(np.int32)
    labels[:40] = N_LISTS
    labels[40:50] = -1
    labels[50:400] = 3                       # one list past any L here
    (one,), ids, sizes, drop, _ = tic.pack_lists(
        [_t(x)], _t(labels), torch.arange(1500, dtype=torch.int32),
        n_lists=N_LISTS, L=L, fill_values=[0])
    cp, cids, csizes, cdrop = tic.pack_rows_chunked(_t(x), _t(labels),
                                                    N_LISTS, L, chunk)
    jp, jids, jsizes, jdrop = jic.pack_rows_chunked(
        jnp.asarray(x), jnp.asarray(labels), N_LISTS, L, chunk_rows=chunk)
    assert drop == cdrop == int(jdrop) > 0
    for a, b, c in ((one, cp, jp), (ids, cids, jids),
                    (sizes, csizes, jsizes)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))


def test_build_takes_the_chunked_pack_past_the_threshold(corpus, monkeypatch):
    """With ``PACK_CHUNKED_BYTES`` lowered under this set's pack, ``build``
    packs in row chunks (its dispatch counter says so) and gives the index
    of the one-shot pack bit for bit."""
    x = corpus[0]
    params = tfl.IndexParams(n_lists=N_LISTS, seed=0, spill=True,
                             list_size_cap_factor=1.25)
    tspans.reset()
    ref = tfl.build(x, params, device="cpu")
    assert tspans.total("ivf_flat.pack.dispatch", impl="pack_lists") == 1
    monkeypatch.setattr(tfl, "PACK_CHUNKED_BYTES", 1 << 10)
    monkeypatch.setattr(tic, "pack_rows_chunked",
                        lambda *a, chunk_rows, **k: _chunked(*a, chunk_rows=
                                                             97, **k))
    out = tfl.build(x, params, device="cpu")
    assert tspans.total("ivf_flat.pack.dispatch",
                        impl="pack_rows_chunked") == 1
    for name in FLAT_FIELDS:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(ref, name).numpy())


_chunked = tic.pack_rows_chunked
