"""The port's host-memory tier (``raft_tpu_torch.neighbors.tiered``, the
host refine tiers, ``serve.placement`` and ``DeviceSyntheticChunks``)
against the JAX package's, on the CPU.

The contract under test: the tiered refined search equals the serialized
host gather bit for bit (ids and distances) for IVF-PQ at pq_bits 4 and 8,
with and without a filter, and for IVF-Flat, and so does its
``prefetch=False`` leg; against the JAX package's tiered search on the
same index its ids overlap ≥ 0.99 and its distances agree at rtol 1e-4
where the ids do (the index parity tests' tolerances). The
:class:`RowPrefetcher` keeps the JAX package's lifecycle: order, hit/stall
accounting, an exception at the next get, get past the last submit, close
mid-stream.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.bench import dataset as jds
from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jrefine
from raft_tpu.robust import faults as jfa
from raft_tpu_torch.bench import dataset as tds
from raft_tpu_torch.neighbors import ivf_common as tic
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as trefine
from raft_tpu_torch.neighbors import tiered
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.random import threefry
from raft_tpu_torch.robust import faults as tfa
from raft_tpu_torch.serve import placement

from torch_parity import (blobs, filter_keep, jax_flat_arrays,
                          jax_index_arrays, overlap)

N, D = 3000, 32


@pytest.fixture(autouse=True)
def _clean():
    tfa.clear_plan()
    jfa.clear_plan()
    tspans.reset()
    yield
    tfa.clear_plan()
    jfa.clear_plan()


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 30, seed=21), blobs(100, D, 30, seed=22)


# ---------------------------------------------------------------------------
# RowPrefetcher lifecycle
# ---------------------------------------------------------------------------

def test_prefetch_order_and_hit_stall_accounting():
    pf = tiered.RowPrefetcher(lambda c: c * 10, depth=2, tenant="t")
    try:
        pf.submit(1)
        pf.submit(2)
        time.sleep(0.3)            # both land before anyone asks
        assert pf.get() == 10      # hit
        assert pf.get() == 20      # hit
        started = threading.Event()

        def slow(c):
            started.set()
            time.sleep(0.2)
            return c * 10

        pf._fetch = slow
        pf.submit(3)
        started.wait(timeout=5.0)
        assert pf.get() == 30      # the consumer waited: a stall
    finally:
        pf.close()
    assert tspans.total("serve.prefetch.hit", tenant="t") == 2
    assert tspans.total("serve.prefetch.stall", tenant="t") == 1


def test_serialized_prefetcher_stalls_every_get():
    pf = tiered.RowPrefetcher(lambda c: c + 1, tenant="s", prefetch=False)
    pf.submit(1)
    pf.submit(2)
    assert (pf.get(), pf.get()) == (2, 3)
    pf.close()
    assert pf._thread is None
    assert tspans.total("serve.prefetch.hit", tenant="s") == 0
    assert tspans.total("serve.prefetch.stall", tenant="s") == 2


def test_reader_exception_raised_at_next_get():
    calls = []

    def fetch(c):
        calls.append(c)
        if c == 2:
            raise ValueError("disk gone")
        return c

    pf = tiered.RowPrefetcher(fetch, depth=2)
    for c in (1, 2, 3):
        pf.submit(c)
    assert pf.get() == 1
    with pytest.raises(ValueError, match="disk gone"):
        pf.get()
    assert calls == [1, 2]  # the reader exits after queueing the error
    pf.close()
    pf.close()


def test_get_past_last_submit_and_close_mid_stream():
    pf = tiered.RowPrefetcher(lambda c: c)
    pf.submit(1)
    assert pf.get() == 1
    with pytest.raises(IndexError, match="past the last submit"):
        pf.get()
    pf.close()

    def slowish(c):
        time.sleep(0.05)
        return c

    pf = tiered.RowPrefetcher(slowish, depth=2)
    for i in range(8):
        pf.submit(i)
    t0 = time.monotonic()
    pf.close()  # unconsumed blocks in flight: must not hang
    assert time.monotonic() - t0 < 5.0
    assert pf._thread is None or not pf._thread.is_alive()
    pf.close()


# ---------------------------------------------------------------------------
# host_row_reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["c_contiguous", "fortran"])
def test_host_row_reader_gathers_as_refine_gathered(corpus, layout):
    """A C-contiguous f32 base takes torch's threaded gather, any other
    layout numpy's: the same rows either way."""
    x, _ = corpus
    if layout == "fortran":
        x = np.asfortranarray(x)
    assert (trefine._f32_view(x) is None) == (layout == "fortran")
    fetch = tiered.host_row_reader(x, device="cpu")
    cand = np.array([[0, 5, -3], [N - 1, N + 7, 2]], np.int32)
    landed = fetch(tiered.stage_ids(torch.from_numpy(cand)))
    assert landed.event is None and landed.stream is None
    rows = landed.ready().numpy()
    assert rows.shape == (2, 3, D) and rows.dtype == np.float32
    safe = np.clip(cand, 0, N - 1)
    np.testing.assert_array_equal(rows, x[safe])
    assert tspans.total("cost.io_bytes") == rows.nbytes
    # a non-f32 base takes numpy's gather, converting exactly
    x16 = x.astype(np.float16)
    rows16 = tiered.host_row_reader(x16, device="cpu")(cand).rows.numpy()
    np.testing.assert_array_equal(rows16, x16[safe].astype(np.float32))


def test_row_read_fault_recovers_and_counts(corpus):
    x, _ = corpus
    tfa.install_plan({"faults": [{"site": "serve.row_read", "kind": "error",
                                  "times": 1}]})
    rows = tiered.host_row_reader(x, device="cpu")(
        np.array([[1, 2]], np.int32)).rows.numpy()
    np.testing.assert_array_equal(rows[0], x[[1, 2]])
    assert tspans.total("retry.recovered", site="serve.row_read") == 1
    assert tspans.total("faults.fired", site="serve.row_read") == 1


# ---------------------------------------------------------------------------
# routing guard
# ---------------------------------------------------------------------------

REFINE = dict(n_probes=8, scan_select="pallas", lut_dtype="float32",
              refine="f32_regen", refine_ratio=10)


def test_tiered_refine_wanted_rules(corpus, monkeypatch):
    x, _ = corpus
    p = tpq.SearchParams(**REFINE)
    want = tiered.tiered_refine_wanted
    assert not want(None, 256, 100, D, p)
    assert not want(torch.from_numpy(x), 256, 100, D, p)
    assert not want(x[0], 256, 100, D, p)
    assert not want(tds.DeviceSyntheticChunks(100, D, device="cpu"), 256,
                    100, D, p)
    assert not want(x, 256, 100, D, dataclasses.replace(
        p, refine_transfer="serial"))
    monkeypatch.setenv("RAFT_TPU_TIERED_REFINE", "0")
    assert not want(x, 256, 100, D, p)
    monkeypatch.setenv("RAFT_TPU_TIERED_REFINE", "1")
    assert want(x, 8, 100, D, p)           # "on" forces one sub-batch
    monkeypatch.delenv("RAFT_TPU_TIERED_REFINE")
    assert not want(x, 8, 100, D, p)       # auto: one sub-batch declines
    assert want(x, 8, 100, D, dataclasses.replace(p, refine_transfer="tiered"))
    assert want(x, 256, 100, D, p)
    tfa.install_plan({"faults": [{"site": "tiered.mem_guard",
                                  "kind": "force", "times": 1}]})
    assert not want(x, 256, 100, D, p)
    assert tspans.total("degrade.steps", site="refine", to="host_gather",
                        reason="mem_guard") == 1
    assert tic.tiered_refine_mem_ok(64, 400, 128)
    c_huge = tic.GROUPED_BYTES_CAP // (3 * 64 * 128 * 4) + 1
    assert not tic.tiered_refine_mem_ok(64, c_huge, 128)
    assert (tiered.pipeline_batch(1000), tiered.pipeline_batch(64)) == (250,
                                                                        32)
    monkeypatch.setenv("RAFT_TPU_TIERED_BATCH", "8")
    assert tiered.pipeline_batch(1000) == 8


# ---------------------------------------------------------------------------
# tiered = serial, bit for bit; and against the JAX package
# ---------------------------------------------------------------------------

_PQ = {}


def _pq_pair(x, pq_bits):
    if pq_bits not in _PQ:
        jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
            n_lists=16, pq_dim=16, pq_bits=pq_bits, seed=0,
            cache_reconstruction="never"))
        arrays, meta = jax_index_arrays(jidx)
        _PQ[pq_bits] = (jidx, tpq.from_numpy(arrays, meta, device="cpu"))
    return _PQ[pq_bits]


def _check_tiered(mod, index, q, params, x, keep, jax_search):
    """tiered = prefetch=False = serial bit for bit; tiered against the
    JAX package's tiered search; no cleared id."""
    bits = None if keep is None else np.asarray(jbs.from_mask(
        jnp.asarray(keep)))
    out = {}
    for tr in ("tiered", "serial"):
        tspans.reset()
        out[tr] = mod.search(index, torch.from_numpy(q), 10,
                             dataclasses.replace(params, refine_transfer=tr),
                             filter_bitset=bits, dataset=x, device="cpu")
        impl = "tiered_prefetch" if tr == "tiered" else "host_gather"
        assert tspans.counts()["refine.dispatch"] == {impl: (
            -(-q.shape[0] // tiered.pipeline_batch(q.shape[0]))
            if tr == "tiered" else 1)}
    k_cand = max(10, int(round(10 * params.refine_ratio)))
    scan = dataclasses.replace(params, refine="none")
    out["no_prefetch"] = tiered.search_refined_tiered(
        mod.search, index, torch.from_numpy(q), 10, k_cand, scan,
        bits, x, index.metric, prefetch=False, device="cpu")
    for other in ("serial", "no_prefetch"):
        torch.testing.assert_close(out["tiered"][0], out[other][0],
                                   rtol=0, atol=0)
        assert torch.equal(out["tiered"][1], out[other][1])
    td, ti = out["tiered"][0].numpy(), out["tiered"][1].numpy()
    if keep is not None:
        assert keep[ti[ti >= 0]].all()
    jd, ji = jax_search(bits)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert overlap(ti, ji) >= 0.99
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("pq_bits", [4, 8])
def test_ivf_pq_tiered_equals_serial_and_jax(corpus, pq_bits, filtered,
                                             monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    x, q = corpus
    jidx, tidx = _pq_pair(x, pq_bits)
    keep = filter_keep(N, "every_other") if filtered else None

    def jax_search(bits):
        return jpq.search(jidx, jnp.asarray(q), 10, jpq.SearchParams(
            **REFINE, refine_transfer="tiered"),
            filter_bitset=None if bits is None else jnp.asarray(bits),
            dataset=x)

    _check_tiered(tpq, tidx, q, tpq.SearchParams(**REFINE), x, keep,
                  jax_search)


def test_ivf_flat_tiered_equals_serial_and_jax(corpus):
    x, q = corpus
    jidx = jfl.build(jnp.asarray(x), jfl.IndexParams(n_lists=16, seed=0))
    arrays, meta = jax_flat_arrays(jidx)
    tidx = tfl.from_numpy(arrays, meta, device="cpu")
    kw = dict(n_probes=8, scan_mode="per_query", refine="f32_regen",
              refine_ratio=4)

    def jax_search(bits):
        return jfl.search(jidx, jnp.asarray(q), 10, jfl.SearchParams(
            **kw, refine_transfer="tiered"), dataset=x)

    _check_tiered(tfl, tidx, q, tfl.SearchParams(**kw), x, None, jax_search)


# ---------------------------------------------------------------------------
# refine_gathered(dequant=), refine_landed, refine_provider
# ---------------------------------------------------------------------------

def test_refine_gathered_dequant_and_landed_match_jax(corpus):
    x, q = corpus
    rng = np.random.default_rng(5)
    cand = rng.integers(-1, N, (q.shape[0], 40)).astype(np.int32)
    scale = (np.abs(x).max(0) / 127).astype(np.float32)
    zero = np.zeros(D, np.float32)
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    for base, dq in ((x, None), (codes, (scale, zero))):
        jd, ji = jrefine.refine_gathered(base, jnp.asarray(q),
                                         jnp.asarray(cand), 10, dequant=dq)
        td, ti = trefine.refine_gathered(base, q, cand, 10, dequant=dq,
                                         device="cpu")
        assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99
        same = ti.numpy() == np.asarray(ji)
        np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                                   rtol=1e-4, atol=1e-4)
    rows = x[np.clip(cand, 0, N - 1)]
    ld, li = trefine.refine_landed(torch.from_numpy(rows), q, cand, 10,
                                   device="cpu")
    gd, gi = trefine.refine_gathered(x, q, cand, 10, device="cpu")
    assert torch.equal(li, gi) and torch.equal(ld, gd)
    assert (gi.numpy() >= 0).all()
    with pytest.raises(Exception, match="does not match"):
        trefine.refine_landed(torch.from_numpy(rows[:, :5]), q, cand, 10,
                              device="cpu")


def test_refine_provider_matches_jax():
    jp = jds.DeviceSyntheticChunks(5000, 16, n_centers=40, seed=3,
                                   chunk_rows=1024)
    tp = tds.DeviceSyntheticChunks(5000, 16, n_centers=40, seed=3,
                                   chunk_rows=1024, device="cpu")
    q = np.asarray(jp.queries(30))
    cand = np.random.default_rng(1).integers(0, 5000, (30, 64)).astype(
        np.int32)
    jd, ji = jrefine.refine_provider(jp, jnp.asarray(q), jnp.asarray(cand),
                                     10)
    td, ti = trefine.refine_provider(tp, q, cand, 10, device="cpu")
    assert overlap(ti.numpy(), np.asarray(ji)) >= 0.99
    same = ti.numpy() == np.asarray(ji)
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-4, atol=1e-4)
    # the provider route of a refined search
    x = tp[0:5000].numpy()
    idx = tpq.build(x, tpq.IndexParams(n_lists=8, pq_dim=8,
                                       cache_reconstruction="never"),
                    device="cpu")
    sp = tpq.SearchParams(n_probes=4, refine="f32_regen", refine_ratio=4)
    tspans.reset()
    pd, pi = tpq.search(idx, q, 10, sp, dataset=tp, device="cpu")
    rd, ri = tpq.search(idx, q, 10, sp, dataset=x, device="cpu")
    assert torch.equal(pi, ri)
    assert tspans.counts()["refine.dispatch"]["provider_regen"] == 1


# ---------------------------------------------------------------------------
# DeviceSyntheticChunks and the threefry generator
# ---------------------------------------------------------------------------

def test_threefry_matches_jax_random():
    k = jax.random.PRNGKey(7)
    tk = threefry.prng_key(7)
    assert tk == tuple(int(v) for v in k)
    assert threefry.split(tk, 3) == [tuple(map(int, r)) for r in
                                     jax.random.split(k, 3)]
    assert threefry.fold_in(tk, 123457) == tuple(map(int, jax.random.fold_in(
        k, 123457)))
    np.testing.assert_array_equal(threefry.uniform(tk, (64, 37)).numpy(),
                                  np.asarray(jax.random.uniform(k, (64, 37))))
    np.testing.assert_array_equal(
        threefry.randint(tk, (4000,), 0, 10000).numpy(),
        np.asarray(jax.random.randint(k, (4000,), 0, 10000)))
    jn = np.asarray(jax.random.normal(k, (1000, 96)))
    tn = threefry.normal(tk, (1000, 96)).numpy()
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-6)
    assert np.mean(tn != jn) < 0.05


def test_device_synthetic_chunks_match_jax():
    jp = jds.DeviceSyntheticChunks(3000, 16, n_centers=50, seed=3,
                                   chunk_rows=1000)
    tp = tds.DeviceSyntheticChunks(3000, 16, n_centers=50, seed=3,
                                   chunk_rows=1000, device="cpu")
    np.testing.assert_array_equal(tp.centers.numpy(), np.asarray(jp.centers))
    for sl in (slice(0, 1000), slice(500, 2600), slice(2900, None)):
        a, b = np.asarray(jp[sl]), tp[sl].numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.queries(20).numpy(),
                               np.asarray(jp.queries(20)), rtol=0, atol=1e-6)
    # row assignments are exact: every row sits nearest its own center
    blk = tp._block(1).numpy()
    k1, _ = threefry.split(threefry.fold_in(tp._akey, 1000))
    assign = threefry.randint(k1, (1000,), 0, 50).numpy()
    ja, _ = jax.random.split(jax.random.fold_in(jax.random.split(
        jax.random.PRNGKey(3), 3)[1], 1000))
    np.testing.assert_array_equal(assign, np.asarray(
        jax.random.randint(ja, (1000,), 0, 50)))
    assert np.abs(blk - tp.centers.numpy()[assign]).max() < 5.0


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_placement_validation_and_tiers(corpus, monkeypatch):
    x, _ = corpus
    assert placement.Placement().describe() == {"codes": "hbm",
                                                "raw": "hbm"}
    for bad in (dict(codes="host"), dict(raw="disk")):
        with pytest.raises(ValueError):
            placement.Placement(**bad)
    t = torch.from_numpy(x)
    assert placement.dataset_tier(None) == "none"
    assert placement.dataset_tier(x) == "host"
    assert placement.dataset_tier(t) == "host"
    assert placement.placement_for(x).raw == "host"
    assert placement.to_host(x) is x
    h = placement.to_host(t)
    assert isinstance(h, np.ndarray) and np.shares_memory(h, x)
    back = placement.to_device(x, device="cpu")
    assert back.dtype == torch.float32 and torch.equal(back, t)
    assert placement.to_device(None, device="cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        placement.to_device(x)


def test_host_tier_entry_points_refuse_cpu_by_default(corpus, monkeypatch):
    """The new entry points default to the card and raise without one."""
    x, q = corpus
    _, tidx = _pq_pair(x, 8)
    cand = np.zeros((4, 20), np.int32)
    rows = torch.zeros((4, 20, D))
    tp = tds.DeviceSyntheticChunks(100, D, device="cpu")
    sp = tpq.SearchParams(**REFINE, refine_transfer="tiered")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: trefine.refine_gathered(x, q[:4], cand, 2),
        lambda: trefine.refine_landed(rows, q[:4], cand, 2),
        lambda: trefine.refine_provider(tp, q[:4], cand, 2),
        lambda: tiered.host_row_reader(x),
        lambda: tiered.search_refined_tiered(
            tpq.search, tidx, torch.from_numpy(q), 10, 100, sp, None, x,
            tidx.metric),
        lambda: tpq.search(tidx, q, 10, sp, dataset=x),
        lambda: tpq.search_resilient(tidx, q, 10, sp, dataset=x),
        lambda: tfl.search_resilient(None, q, 10),
        lambda: tds.DeviceSyntheticChunks(10, 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
