"""Filters (ROADMAP A6) of the port against the JAX package, on the CPU:
the bitset, the sample-filter helpers, and the filter operands of the
three kernels that take one (B1 ``ivfpq_lut_scan_topk``, B2
``gather_refine_topk``, B8 ``ring_lut_scan_merge``), each plain version
against the JAX package's interpreted kernel on the same seeded numpy
inputs. The filtered search tiers are held to the JAX package in
``tests/test_torch_ivf_pq.py``, ``test_torch_ivf_flat.py``,
``test_torch_ivf_pq_recon.py`` and ``test_torch_parallel.py``.

Tolerances: the bitset and byte packing bit for bit (the port's int32
words read as uint32); B1 keys rtol 1e-4, atol 1e-3 with ids equal away
from key ties (the LUT scan's); B2 keys rtol 1e-5 and ids equal (on
integer rows keys bit for bit); B8 ids equal away from key ties, keys
rtol 1e-4, atol 1e-3, and bit for bit on integer keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.core import bitset as jbs
from raft_tpu.core.compat import shard_map
from raft_tpu.neighbors import ivf_common as jic
from raft_tpu.neighbors import sample_filter as jsf
from raft_tpu.ops import pallas_kernels as pk
from raft_tpu_torch.core import bitset as tbs
from raft_tpu_torch.neighbors import ivf_common as tic
from raft_tpu_torch.neighbors import sample_filter as tsf
from raft_tpu_torch.ops import kernels as K

from torch_parity import (FILTER_KINDS, SCAN_OPERANDS, assert_bins_match,
                          assert_ids_match_away_from_ties, filter_keep,
                          jax_mesh, pair_rows, refine_case, ring_scan_case,
                          ring_scan_ops, scan_case, scan_reference_keys)


def _t(a):
    return torch.tensor(np.asarray(a))


def _u32(words) -> np.ndarray:
    """Port words (int32 tensor) as the JAX package's uint32 words."""
    return tbs.to_numpy(words)


# ---------------------------------------------------------------------------
# the bitset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000])
def test_bitset_packing_matches_jax(n):
    """from_mask, to_mask, create, flip, count and density, bit for bit."""
    keep = np.random.default_rng(n).random(n) < 0.4
    tw = tbs.from_mask(keep, device="cpu")
    jw = np.asarray(jbs.from_mask(jnp.asarray(keep)))
    assert tw.dtype == torch.int32 and tw.shape == (tbs.n_words(n),)
    np.testing.assert_array_equal(_u32(tw), jw)
    np.testing.assert_array_equal(tbs.to_mask(tw, n).numpy(), keep)
    for value in (True, False):
        np.testing.assert_array_equal(
            _u32(tbs.create(n, value, device="cpu")),
            np.asarray(jbs.create(n, value)))
    np.testing.assert_array_equal(_u32(tbs.flip(tw)),
                                  np.asarray(jbs.flip(jnp.asarray(jw))))
    assert tbs.count(tw, n) == int(jbs.count(jnp.asarray(jw), n))
    assert abs(tbs.density(tw) - float(jbs.density(jnp.asarray(jw)))) < 1e-6


def test_bitset_takes_the_jax_words_as_they_come():
    """A JAX bitset crosses as numpy uint32, or as a torch uint32 or int32
    tensor: the same int32 words every way, and back to uint32."""
    keep = np.random.default_rng(0).random(200) < 0.5
    jw = np.array(jbs.from_mask(jnp.asarray(keep)))
    assert jw.dtype == np.uint32 and (jw >= 1 << 31).any()
    want = tbs.from_mask(keep, device="cpu")
    for form in (jw, torch.from_numpy(jw.view(np.int32)),
                 torch.from_numpy(jw.view(np.int32)).view(torch.uint32)):
        w = tbs.as_words(form)
        assert w.dtype == torch.int32 and torch.equal(w, want)
    np.testing.assert_array_equal(tbs.to_numpy(want), jw)
    with pytest.raises(TypeError):
        tbs.as_words(jw.astype(np.int64))


def test_bitset_set_bits_keeps_colliding_ids():
    """Several ids landing in one word are all kept (set and clear)."""
    ids = np.array([0, 1, 5, 31, 32, 33, 63, 64, 69], np.int32)
    for value, base in ((True, False), (False, True)):
        tw = tbs.set_bits(tbs.create(70, base, device="cpu"), _t(ids), value)
        jw = jbs.set_bits(jbs.create(70, base), jnp.asarray(ids), value)
        np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
    tw = tbs.set_bits(tbs.create(70, False, device="cpu"), _t(ids))
    assert tbs.count(tw, 70) == len(ids)
    np.testing.assert_array_equal(
        tbs.test(tw, _t(np.arange(70))).numpy(),
        np.isin(np.arange(70), ids))


def test_bitset_word_at_and_test_match_jax():
    """word_at and test over arbitrary ids: negative ids read word 0 and
    test False, ids past the last word read the last word (the JAX
    package's gather clamps), in either id width."""
    keep = np.random.default_rng(3).random(200) < 0.5
    tw = tbs.from_mask(keep, device="cpu")
    jw = jbs.from_mask(jnp.asarray(keep))
    ids = np.array([0, 31, 32, 63, 64, 199, -1, -7, 250, 5000], np.int32)
    np.testing.assert_array_equal(
        _u32(tbs.word_at(tw, _t(ids))), np.asarray(jbs.word_at(jw, ids)))
    np.testing.assert_array_equal(tbs.test(tw, _t(ids)).numpy(),
                                  np.asarray(jbs.test(jw, jnp.asarray(ids))))
    assert not tbs.test(tw, _t(ids)).numpy()[6:8].any()


def test_bitset_word_at_divides_in_the_ids_width():
    """int64 ids past 2³¹ are never narrowed: they divide in int64 and read
    the word they name (here, clamped, the last one, which differs from
    word 0, where a narrowed id would land)."""
    keep = np.zeros(96, bool)
    keep[70] = True
    tw = tbs.from_mask(keep, device="cpu")
    ids = np.array([2**31 + 5, 2**32 + 64, 70, -1], np.int64)
    got = tbs.word_at(tw, _t(ids))
    assert got.numpy()[0] == got.numpy()[2] != tw.numpy()[0]
    with jax.enable_x64(True):
        jw = jbs.from_mask(jnp.asarray(keep))
        want = np.asarray(jbs.word_at(jw, jnp.asarray(ids)))
        jtest = np.asarray(jbs.test(jw, jnp.asarray(ids)))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(tbs.test(tw, _t(ids)).numpy(), jtest)


# ---------------------------------------------------------------------------
# sample filters
# ---------------------------------------------------------------------------

def test_make_filter_and_passes_match_jax():
    rng = np.random.default_rng(4)
    n = 300
    sel = rng.permutation(n)[:40].astype(np.int32)
    ids = rng.integers(-1, n, (7, 50)).astype(np.int32)
    for kw in ({}, {"remove": sel}, {"keep": sel}):
        tw = tsf.make_filter(n, device="cpu", **{k: _t(v)
                                                for k, v in kw.items()})
        jw = jsf.make_filter(n, **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
        np.testing.assert_array_equal(
            tsf.passes(tw, _t(ids)).numpy(),
            np.asarray(jsf.passes(jw, jnp.asarray(ids))))
        np.testing.assert_array_equal(
            tsf.masked_ids(tw, _t(ids)).numpy(),
            np.where(np.asarray(jsf.passes(jw, jnp.asarray(ids))), ids, -1))
    assert tsf.passes(None, _t(ids)).all()
    with pytest.raises(ValueError):
        tsf.make_filter(n, remove=sel, keep=sel, device="cpu")


@pytest.mark.parametrize("L", [8, 11, 64, 300])
def test_filter_bytes_match_jax(L):
    """pack_mask_bytes (bit j of byte b = position 8·b + j, pads 0) and
    list_filter_bytes over an id table with pads and ids past the
    bitset, bit for bit."""
    rng = np.random.default_rng(L)
    keep2 = rng.random((5, L)) < 0.5
    np.testing.assert_array_equal(
        tsf.pack_mask_bytes(_t(keep2)).numpy(),
        np.asarray(jsf.pack_mask_bytes(jnp.asarray(keep2))))
    n = 500
    mask = rng.random(n) < 0.5
    ids = rng.integers(0, n + 40, (4, L)).astype(np.int32)
    ids[1, L // 2:] = -1
    tb = tsf.list_filter_bytes(tbs.from_mask(mask, device="cpu"), _t(ids))
    jb = np.asarray(jsf.list_filter_bytes(jbs.from_mask(jnp.asarray(mask)),
                                          jnp.asarray(ids)))
    assert tb.dtype == torch.uint8 and tb.shape == (4, (L + 7) // 8)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(K.unpack_filter_bytes(tb, L).numpy(),
                                  np.unpackbits(jb, axis=1,
                                                bitorder="little")[:, :L] > 0)


def test_filter_bytes_are_made_once_per_bitset_and_id_table():
    """The keep bytes are kept on the bitset tensor, one entry per id
    table, and made again when either is written in place."""
    rng = np.random.default_rng(8)
    bits = tbs.from_mask(rng.random(900) < 0.3, device="cpu")
    ids = [_t(rng.integers(-1, 900, (6, 50)).astype(np.int32))
           for _ in range(2)]
    first = [tsf.list_filter_bytes(bits, t) for t in ids]
    assert all(tsf.list_filter_bytes(bits, t) is f
               for t, f in zip(ids, first))
    ids[0][0, :8] = 7
    again = tsf.list_filter_bytes(bits, ids[0])
    assert again is not first[0]
    np.testing.assert_array_equal(again.numpy(), tsf.pack_mask_bytes(
        tsf.passes(bits, ids[0])).numpy())
    bits[0] = -1
    assert tsf.list_filter_bytes(bits, ids[1]) is not first[1]
    assert tsf.list_filter_bytes(bits, ids[1])[0, 0] == tsf.pack_mask_bytes(
        tsf.passes(bits, ids[1]))[0, 0]


@pytest.mark.parametrize("n_lists,L,slot_bytes", [
    (1024, 1536, 1), (8192, 4992, 1), (8192, 4992, 5), (70_000, 50_000, 1),
    (70_000, 50_000, 5), (200_000, 20_000, 1)])
def test_filtered_scan_mem_ok_matches_jax(n_lists, L, slot_bytes):
    assert (tic.filtered_scan_mem_ok(n_lists, L, slot_bytes)
            == jic.filtered_scan_mem_ok(n_lists, L, slot_bytes))


# ---------------------------------------------------------------------------
# B1: the LUT scan's filter_bytes
# ---------------------------------------------------------------------------

# selectivities of the bench's filter legs and 1, then the edge masks
_LUT_FILTERS = [0.01, 0.1, 0.5, 1.0, "none", "every_other", "last_word"]


def _keep_of(n: int, f, seed: int) -> np.ndarray:
    if isinstance(f, float):
        return np.random.default_rng(seed).random(n) < f
    return filter_keep(n, f, seed)


def _masked_reference(c, metric, keep):
    """scan_reference_keys with the filtered rows at +inf."""
    ref = scan_reference_keys(c, c["cb"], metric)
    return {key: np.where(keep[np.clip(
        c["ids"][c["seg_list"][c["pair_seg"][key]]], 0, None)], v, np.inf)
        for key, v in ref.items()}


@pytest.mark.parametrize("f", _LUT_FILTERS)
@pytest.mark.parametrize("pq_bits", [4, 8])
def test_lut_scan_filtered_plain_matches_pallas(pq_bits, f):
    """B1's plain version with keep bytes against the JAX kernel's
    filter_bytes (interpreted), L 300 (a ragged last byte), lists of size
    0, 1 and L, both metrics: the kept rows only, no id with its bit
    clear; all-kept equals no filter."""
    c = scan_case(pq_bits, seed=2)
    n_ids = int(c["ids"].max()) + 1
    keep = _keep_of(n_ids, f, seed=pq_bits)
    fbytes = np.asarray(jsf.list_filter_bytes(jbs.from_mask(
        jnp.asarray(keep)), jnp.asarray(c["ids"])))
    qv = c["q_rot"][np.clip(c["seg_q"], 0, c["q_rot"].shape[0] - 1)]
    kw = dict(pq_bits=pq_bits, pq_dim=c["S"], L=c["L"], lut_dtype="float32")
    for metric in ("l2", "ip"):
        jk, ji = pk.ivfpq_lut_scan_topk(
            jnp.asarray(c["seg_list"]), jnp.asarray(qv),
            jnp.asarray(c["packed"]), jnp.asarray(c["ids"]),
            jnp.asarray(c["norms"]), jnp.asarray(c["centers_rot"]),
            jnp.asarray(c["cb"]), metric, filter_bytes=jnp.asarray(fbytes),
            interpret=True, **kw)
        tk, ti = K.ivfpq_lut_scan_topk(
            *[_t(c[n]) for n in SCAN_OPERANDS], metric,
            filter_bytes=_t(fbytes), **kw)
        tk, ti = tk.numpy(), ti.numpy()
        assert_bins_match(tk, ti, pair_rows(c, jk), pair_rows(c, ji),
                          _masked_reference(c, metric, keep), rtol=1e-4,
                          atol=1e-3)
        assert keep[ti[ti >= 0]].all()
        if f == "none":
            assert (ti == -1).all() and np.isinf(tk).all()
        if f == 1.0:
            uk, ui = K.ivfpq_lut_scan_topk(
                *[_t(c[n]) for n in SCAN_OPERANDS], metric, **kw)
            assert np.array_equal(ui.numpy(), ti)
            assert np.array_equal(uk.numpy(), tk)


@pytest.mark.parametrize("f", [0.1, "every_other"])
def test_lut_scan_filtered_pq6_matches_numpy(f):
    """6-bit codes: B1's plain version with keep bytes against a numpy ADC
    of the kept rows (the JAX package's 6-bit LUT kernel is a known fault,
    ROADMAP C1): each bin holds the two best kept rows."""
    c = scan_case(6, seed=4)
    keep = _keep_of(int(c["ids"].max()) + 1, f, seed=6)
    fbytes = tsf.list_filter_bytes(tbs.from_mask(keep, device="cpu"),
                                   _t(c["ids"]))
    tk, ti = K.ivfpq_lut_scan_topk(*[_t(c[n]) for n in SCAN_OPERANDS], "l2",
                                   pq_bits=6, pq_dim=c["S"], L=c["L"],
                                   filter_bytes=fbytes)
    ref = _masked_reference(c, "l2", keep)
    for (b, p), key in ref.items():
        lids = c["ids"][c["seg_list"][c["pair_seg"][b, p]]]
        for col in range(128):
            kb = key[col::128]
            order = np.argsort(kb, kind="stable")[:2]
            for r, o in enumerate(order):
                if np.isfinite(kb[o]):
                    np.testing.assert_allclose(tk[b, p, col + 128 * r].item(),
                                               kb[o], rtol=1e-4, atol=1e-3)
                    assert keep[ti[b, p, col + 128 * r].item()]
                else:
                    assert ti[b, p, col + 128 * r].item() == -1
        assert set(ti[b, p][ti[b, p] >= 0].tolist()) <= set(
            lids[np.isfinite(key)].tolist())


def test_lut_scan_rejects_a_wrong_filter_operand():
    c = scan_case(8)
    ops = [_t(c[n]) for n in SCAN_OPERANDS]
    kw = dict(pq_bits=8, pq_dim=c["S"], L=c["L"])
    n_lists, Fb = c["ids"].shape[0], (c["L"] + 7) // 8
    for bad in (torch.zeros((n_lists, Fb), dtype=torch.int32),
                torch.zeros((n_lists, Fb + 1), dtype=torch.uint8),
                torch.zeros((n_lists, 2 * Fb), dtype=torch.uint8)[:, ::2]):
        with pytest.raises(Exception, match="filter_bytes"):
            K.ivfpq_lut_scan_topk(*ops, "l2", filter_bytes=bad, **kw)


# ---------------------------------------------------------------------------
# B2: the re-rank's filter_bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", FILTER_KINDS)
@pytest.mark.parametrize("ties", [False, True])
def test_gather_refine_filtered_plain_matches_pallas(kind, ties):
    """B2's plain version with the bitset's words against the JAX kernel's
    filter_bits (interpreted), every metric, candidates with pads, a
    duplicate and an id past the rows: keys and ids equal (bit for bit on
    integer rows), no id with its bit clear."""
    data, q, cand = refine_case(seed=6, ties=ties, d=16 if ties else 40)
    keep = filter_keep(data.shape[0], kind, seed=1)
    jw = (jsf.make_filter(data.shape[0]) if kind == "all"
          else jbs.from_mask(jnp.asarray(keep)))
    tw = tbs.as_words(np.asarray(jw))
    for metric in ("l2", "ip", "cos"):
        jk, ji = pk.gather_refine_topk(jnp.asarray(data), jnp.asarray(q),
                                       jnp.asarray(cand), 10, metric,
                                       filter_bits=jw, interpret=True)
        tk, ti = K.gather_refine_topk(_t(data), _t(q), _t(cand), 10, metric,
                                      filter_bits=tw)
        if ties:
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        else:
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        got = ti.numpy()[ti.numpy() >= 0]
        assert np.append(keep, [kind == "all"] * 32)[got].all()


def test_gather_refine_rejects_a_wrong_filter_operand():
    data, q, cand = refine_case(seed=1)
    for bad in (torch.zeros(63, dtype=torch.int64),
                torch.zeros((2, 63), dtype=torch.int32),
                torch.zeros(126, dtype=torch.int32)[::2],
                torch.zeros(0, dtype=torch.int32)):
        with pytest.raises(Exception, match="filter_bits"):
            K.gather_refine_topk(_t(data), _t(q), _t(cand), 10,
                                 filter_bits=bad)


# ---------------------------------------------------------------------------
# B8: the fused scan-in-ring's filter_bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pq_bits,n,ties,f", [
    (8, 4, False, 0.1), (5, 2, False, 0.5), (8, 4, True, "every_other"),
    (4, 3, False, "none")])
def test_ring_lut_scan_filtered_plain_matches_interpreted_kernel(pq_bits, n,
                                                                 ties, f):
    """B8's plain version, each rank with its keep bytes over its own id
    table (global ids), against the JAX package's interpreted kernel on
    the CPU mesh with the same bytes: ids equal away from key ties (on
    integer keys keys and ids equal exactly), no id with its bit clear."""
    k = 10
    c = ring_scan_case(pq_bits, n_dev=n, m=20, seed=3, n_lists=10, L=260,
                       n_probes=3, ties=ties)
    keep = _keep_of(int(c["ids"].max()) + 1, f, seed=pq_bits + n)
    jw = jbs.from_mask(jnp.asarray(keep))
    fb = np.stack([np.asarray(jsf.list_filter_bytes(jw, jnp.asarray(ids)))
                   for ids in c["ids"]])
    mesh = jax_mesh(n)

    def body(codes, ids, norms, fbytes, lists, ind, qv, ctr, cb):
        return pk.ring_lut_scan_merge(
            lists, ind, qv, codes[0], ids[0], norms[0], ctr, cb, k, "l2",
            pq_bits=pq_bits, pq_dim=c["S"], L=c["L"], axis_name="shard",
            n_dev=n, lut_dtype="float32", filter_bytes=fbytes[0],
            interpret=True)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P("shard", None, None, None),
                             P("shard", None, None), P("shard", None, None),
                             P("shard", None, None),
                             P(), P(), P(), P(), P()),
                   out_specs=(P("shard", None), P("shard", None)),
                   check_vma=False)
    jk, ji = fn(jnp.asarray(c["packed"]), jnp.asarray(c["ids"]),
                jnp.asarray(c["norms"]), jnp.asarray(fb),
                *(jnp.asarray(c[name]) for name in (
                    "lists", "ind", "qv", "centers_rot", "cb")))
    jk, ji = np.asarray(jk)[:, :k], np.asarray(ji)[:, :k]
    tk, ti = K.ring_lut_scan_merge(*ring_scan_ops(c, ["cpu"] * n), k, "l2",
                                   pq_bits=pq_bits, pq_dim=c["S"], L=c["L"],
                                   filter_bytes=[_t(b) for b in fb])
    tk, ti = torch.cat(tk).numpy(), torch.cat(ti).numpy()
    assert keep[ti[ti >= 0]].all()
    if f == "none":
        assert (ti == -1).all() and (ji == -1).all()
        return
    assert (ti >= 0).sum() > 0
    if ties:
        fin = np.isfinite(tk)
        np.testing.assert_array_equal(tk[fin], jk[fin])
        np.testing.assert_array_equal(ti[fin], ji[fin])
    assert_ids_match_away_from_ties(ti, tk, ji, jk, rtol=1e-4, atol=1e-3)


def test_ring_scan_admits_filtered_searches():
    """ring_lut_scan_kernel_ok(filtered=True) admits what it admits
    unfiltered: the kernel keeps no filter state in shared memory."""
    for S, K_, P_, nb in ((64, 256, 2, 64), (16, 16, 2, 8)):
        for NS, k in ((512, 10), (8, 64)):
            args = (S, K_, P_, nb, nb, 8, NS, k, 4, S * P_)
            assert K.ring_lut_scan_kernel_ok(*args, filtered=True)
            assert K.ring_lut_scan_kernel_ok(*args) is True
