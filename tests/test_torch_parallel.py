"""The port's sharded tier against the JAX package's, on the CPU.

Same seeded numpy inputs go through ``raft_tpu.parallel`` on the virtual
CPU mesh of the test run (``tests/conftest.py``: 8 devices; meshes of
2, 4 and 8 are cut from it) and through ``raft_tpu_torch.parallel`` on a
mesh of CPU ranks, where each kernel wrapper runs its plain version.
The JAX package's Pallas kernels run as its own tests run them: the ring
merge with ``interpret=True``, the fused tier under
``RAFT_TPU_RING_FUSED=on``. The ring kernels' own tests (their plain
versions against the interpreted kernels and the hop schedule) are in
``tests/test_torch_parallel_ring.py``.

Tolerances: the ring merge and sharded kNN ids exact (kNN values rtol
1e-5); ``dkm.fit`` centroids atol 1e-4 and the same iteration count;
searches of a crossed index ids equal away from value ties within rtol
1e-4, values rtol 1e-4; build recall within 0.02.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import pallas_kernels as jpk
from raft_tpu.parallel import merge as jmerge

from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.ops import kernels as K
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import ivf as tivf
from raft_tpu_torch.parallel import merge as tmerge
from raft_tpu_torch.parallel import make_mesh

from torch_parity import (assert_filtered_match,
                          assert_ids_match_away_from_ties, exact_knn,
                          jax_mesh, jax_sharded_pq_arrays,
                          jax_sharded_pq_from_arrays, overlap,
                          ring_scan_case, ring_scan_ops, ring_tables)


def _cpu_mesh(n):
    return make_mesh(n, device="cpu")


# ---------------------------------------------------------------------------
# the ring merge (B7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("select_min", [True, False])
def test_merge_impls_agree(select_min):
    """merge_topk's three impls on one set of tables: the ring kernel's
    wrapper (its plain version here), the hop-by-hop schedule and the
    allgather give the same [m, k] result on tie-free keys."""
    n, m, k = 4, 37, 8
    vals, ids = ring_tables(n, m, k, seed=5, select_min=select_min,
                            variant="sentinels")
    mesh = _cpu_mesh(n)
    out = {}
    for tier, impl in (("allgather", "allgather"), ("ring", "ring_kernel"),
                       ("ring", "ring_ppermute")):
        rv, ri = tmerge.merge_topk([torch.tensor(v) for v in vals],
                                   [torch.tensor(i) for i in ids], mesh, m,
                                   k, n, select_min, tier=tier, impl=impl)
        spec = tmerge.merge_out_spec(tier)
        out[impl] = (tmerge.assemble(spec, rv, m, torch.device("cpu")),
                     tmerge.assemble(spec, ri, m, torch.device("cpu")))
    for impl in ("ring_kernel", "ring_ppermute"):
        assert torch.equal(out[impl][1], out["allgather"][1])
        assert torch.equal(out[impl][0], out["allgather"][0])


# ---------------------------------------------------------------------------
# sharded kNN, tier decisions, byte counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_sharded_knn_matches_jax(merge):
    """Ids exact (and exact kNN, as replicated_knn's), values rtol 1e-5,
    and the merge's comms counters equal to the JAX package's (the byte
    model: the allgather counts n_dev × [m, k] per table, the ring one
    [mc, k] block per hop)."""
    from raft_tpu import obs
    from raft_tpu.obs.metrics import MetricsRegistry
    from raft_tpu.parallel import sharded_knn as jknn
    from raft_tpu_torch.parallel import sharded_knn as tknn

    rng = np.random.default_rng(3)
    x = rng.standard_normal((803, 16)).astype(np.float32)
    q = rng.standard_normal((27, 16)).astype(np.float32)
    reg = MetricsRegistry()
    obs.enable(registry=reg, hbm=False)
    try:
        jv, ji = jknn(jnp.asarray(x), jnp.asarray(q), 10, jax_mesh(4),
                      merge=merge)
    finally:
        obs.disable()
    jc = reg.snapshot()["counters"]
    tcomms.reset_counters()
    tv, ti = tknn(x, q, 10, _cpu_mesh(4), merge=merge)
    tc = tcomms.counters()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), exact_knn(x, q, 10))
    if merge == "allgather":
        from raft_tpu_torch.parallel import replicated_knn

        rv, ri = replicated_knn(x, q, 10, _cpu_mesh(4))
        np.testing.assert_array_equal(ri.numpy(), ti.numpy())
    op = "ring_topk" if merge == "ring" else "allgather"
    assert tc["bytes"][(op, "shard")] == jc[
        f"comms.bytes{{axis=shard,op={op}}}"] > 0
    assert tc["ops"][(op, "shard")] == jc[f"comms.ops{{axis=shard,op={op}}}"]


def test_merge_tier_decisions_match_jax(monkeypatch):
    """merge_tier and ring_auto_wanted give the JAX package's decisions
    over a grid of shapes, with and without a kernel-capable device and
    under each RAFT_TPU_RING_TOPK setting and merge= argument."""
    grid = [(m, k, n) for m in (1, 8, 27, 100, 500, 4000, 12000)
            for k in (1, 10, 64, 65) for n in (1, 2, 4, 8)]
    for on_dev in (False, True):
        monkeypatch.setattr(jpk, "_on_tpu", lambda: on_dev)
        monkeypatch.setattr(K, "_on_cuda", lambda: on_dev)
        for env in ("auto", "on", "off"):
            monkeypatch.setenv("RAFT_TPU_RING_TOPK", env)
            for explicit in (None, "auto", "ring", "allgather"):
                for m, k, n in grid:
                    want = jmerge.merge_tier(n, m, k, explicit=explicit)
                    got = tmerge.merge_tier(n, m, k, explicit=explicit)
                    assert got == want, (on_dev, env, explicit, m, k, n)
    for m, k, n in grid:
        assert tmerge.ring_auto_wanted(m, k, n) == jmerge.ring_auto_wanted(
            m, k, n)
        assert tmerge.merged_rows("ring", m, n) == jmerge.merged_rows(
            "ring", m, n)
        assert K.ring_topk_kernel_ok(m, k, n) == jpk.ring_topk_kernel_ok(
            m, k, n)


# ---------------------------------------------------------------------------
# distributed k-means
# ---------------------------------------------------------------------------

def test_dkm_fit_matches_jax():
    from raft_tpu.cluster import KMeansParams as JParams
    from raft_tpu.cluster import distributed as jdkm
    from raft_tpu_torch.cluster import distributed as tdkm
    from raft_tpu_torch.cluster.kmeans import KMeansParams

    from torch_parity import blobs

    x = blobs(1001, 12, 6, seed=2)       # ragged: zero-weight padding
    init = x[[3, 200, 400, 600, 800, 1000]].copy()
    jc, jin, jit = jdkm.fit(JParams(n_clusters=6, max_iter=30, tol=1e-4),
                            jnp.asarray(x), jax_mesh(4),
                            init_centroids=jnp.asarray(init))
    tc, tin, tit = tdkm.fit(KMeansParams(n_clusters=6, max_iter=30, tol=1e-4),
                            x, _cpu_mesh(4), init_centroids=init)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    assert tit == int(jit)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-4)
    labels = tdkm.predict(tc, x, _cpu_mesh(4))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(
        jdkm.predict(jc, jnp.asarray(x), jax_mesh(4))))


# ---------------------------------------------------------------------------
# sharded IVF-PQ: crossed indexes, build quality, the fused tier (B8)
# ---------------------------------------------------------------------------

# Shards of the crossed index: two keep the JAX package's interpreted
# fused kernel and its sharded build within the file's time.
PQ_SHARDS = 2


@pytest.fixture(scope="module")
def pq_case():
    """``make_synthetic_hard`` data (bit for bit the same in both
    packages), its exact top-10, and a JAX-built and a port-built 2-shard
    index of it with 4-bit codes (module-scoped: the builds are the
    expensive part). Lists hold at most 256 rows."""
    from raft_tpu.bench.dataset import make_synthetic_hard as jhard
    from raft_tpu.neighbors import ivf_pq as jpq
    from raft_tpu.parallel import build_ivf_pq as jbuild
    from raft_tpu_torch.bench.dataset import make_synthetic_hard
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    ds = make_synthetic_hard("hard", 4096, 32, 400, seed=3)
    np.testing.assert_array_equal(
        ds.base, np.asarray(jhard("hard", 4096, 32, 400, seed=3).base))
    kw = dict(n_lists=32, pq_dim=8, pq_bits=4, kmeans_n_iters=5)
    jidx = jbuild(jpq.IndexParams(**kw), jnp.asarray(ds.base),
                  jax_mesh(PQ_SHARDS))
    tidx = tivf.build_ivf_pq(tpq.IndexParams(**kw), ds.base,
                             _cpu_mesh(PQ_SHARDS))
    assert tidx.max_list_size <= 256 and tidx.size == ds.base.shape[0]
    return (ds.base, ds.queries, exact_knn(ds.base, ds.queries, 10), jidx,
            tidx)


def _search_both(jidx, tidx, q, k, sp_kw, merge, dataset=None, bits=None):
    """Both packages' sharded search; ``bits`` a JAX filter bitset (the
    port takes its words as numpy uint32)."""
    from raft_tpu.neighbors import ivf_pq as jpq
    from raft_tpu.parallel import search_ivf_pq as jsearch
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    jv, ji = jsearch(jpq.SearchParams(**sp_kw), jidx, jnp.asarray(q), k,
                     jax_mesh(PQ_SHARDS), dataset=None if dataset is None
                     else jnp.asarray(dataset), merge=merge,
                     filter_bitset=bits)
    tv, ti = tivf.search_ivf_pq(tpq.SearchParams(**sp_kw), tidx, q, k,
                                tidx.mesh, dataset=dataset, merge=merge,
                                filter_bitset=None if bits is None
                                else np.asarray(bits))
    return (np.asarray(ji), np.asarray(jv)), (ti.numpy(), tv.numpy())


UNREFINED = dict(n_probes=6, lut_dtype="float32")
REFINED = dict(n_probes=6, lut_dtype="float32", refine="f32_regen",
               refine_ratio=3.0, scan_mode="per_query")
FUSED = dict(n_probes=6, lut_dtype="float32", scan_select="pallas")


@pytest.mark.parametrize("direction", ["jax_built", "port_built"])
def test_crossed_index_searches_agree(pq_case, direction, monkeypatch):
    """A JAX-built index crossed into the port, and a port-built one
    crossed back, each searched by both packages: unrefined (per_query,
    allgather), refined (ring), and the fused tier forced on (ring) —
    ids equal away from ties; the fused tier also against the unfused
    search of the same package."""
    x, q, _, jidx, tidx = pq_case
    q = q[:45]
    if direction == "jax_built":
        tidx = tivf.from_numpy(*jax_sharded_pq_arrays(jidx),
                               _cpu_mesh(PQ_SHARDS))
    else:
        jidx = jax_sharded_pq_from_arrays(*tivf.to_numpy(tidx),
                                          jax_mesh(PQ_SHARDS))
    monkeypatch.setenv("RAFT_TPU_RING_FUSED", "off")
    (ji, jv), (ti, tv) = _search_both(jidx, tidx, q, 8, UNREFINED,
                                      "allgather")
    assert_ids_match_away_from_ties(ti, tv, ji, jv)
    unfused = (ti, tv)
    (ji, jv), (ti, tv) = _search_both(jidx, tidx, q, 8, REFINED, "ring",
                                      dataset=x)
    assert_ids_match_away_from_ties(ti, tv, ji, jv)
    monkeypatch.setenv("RAFT_TPU_RING_FUSED", "on")
    tspans.reset()
    (ji, jv), (ti, tv) = _search_both(jidx, tidx, q, 8, FUSED, "ring")
    assert tspans.counts()["parallel.merge.dispatch"] == {
        "ring_fused_scan": 1}
    assert_ids_match_away_from_ties(ti, tv, ji, jv)
    # lists of ≤ 256 rows: the two-best bins hold every row, so the fused
    # tier equals the exact unfused scan
    assert_ids_match_away_from_ties(ti, tv, *unfused)


# (leg, selectivity): the fused scan-in-ring (B8 with each rank's keep
# bytes) at the bench's three selectivities; the unfused per_query tier
# (allgather) and the refined path (the filtered scan, an unfiltered
# re-rank, the ring) at 0.1
_SHARDED_FILTERED = [("fused", 0.01), ("fused", 0.1), ("fused", 0.5),
                     ("unrefined", 0.1), ("refined", 0.1)]
_SHARDED_LEGS = {"fused": (FUSED, "ring", "on"),
                 "unrefined": (UNREFINED, "allgather", "off"),
                 "refined": (REFINED, "ring", "off")}


@pytest.mark.parametrize("leg,sel", _SHARDED_FILTERED)
def test_crossed_index_filtered_searches_agree(pq_case, leg, sel,
                                               monkeypatch):
    """A filter over global row ids, replicated: each tier of the sharded
    search against the JAX package's on a JAX-built index crossed into
    the port — ids equal away from ties, no id with its bit clear; the
    dispatch counts the filtered fused tier."""
    from raft_tpu.core import bitset as jbs

    x, q, _, jidx, _ = pq_case
    q = q[:45]
    tidx = tivf.from_numpy(*jax_sharded_pq_arrays(jidx), _cpu_mesh(PQ_SHARDS))
    keep = np.random.default_rng(int(sel * 100) + 5).random(x.shape[0]) < sel
    bits = jbs.from_mask(jnp.asarray(keep))
    sp_kw, merge, fused = _SHARDED_LEGS[leg]
    monkeypatch.setenv("RAFT_TPU_RING_FUSED", fused)
    tspans.reset()
    (ji, jv), (ti, tv) = _search_both(jidx, tidx, q, 8, sp_kw, merge,
                                      dataset=x if leg == "refined" else None,
                                      bits=bits)
    if leg == "fused":
        assert tspans.counts()["ivf_pq.scan.dispatch"] == {
            "ring_lut_fused,filtered=1": 1}
    assert_filtered_match(ti, tv, ji, jv, keep)


def test_port_build_recall_matches_jax(pq_case):
    """Builds are held by quality, not bit for bit (the packages draw
    their samples from different generators): the port's sharded build
    reaches the JAX package's recall@10 within 0.02, each index searched
    by its own package (refined, so the ranking is the coarse quantizer's
    and the codebooks' together)."""
    from raft_tpu.neighbors import ivf_pq as jpq
    from raft_tpu.parallel import search_ivf_pq as jsearch
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    x, q, gt, jidx, tidx = pq_case
    sp = dict(n_probes=4, lut_dtype="float32", scan_mode="per_query")
    _, ji = jsearch(jpq.SearchParams(**sp), jidx, jnp.asarray(q), 10,
                    jax_mesh(PQ_SHARDS), merge="allgather")
    _, ti = tivf.search_ivf_pq(tpq.SearchParams(**sp), tidx, q, 10,
                               tidx.mesh, merge="allgather")
    rj, rt = overlap(np.asarray(ji), gt), overlap(ti.numpy(), gt)
    assert rj > 0.3 and abs(rt - rj) <= 0.02, (rt, rj)


def test_refined_search_takes_pre_cut_shards(pq_case):
    """The refined search's ``dataset`` may be the build dataset or its
    per-rank shards as ``shard_rows`` cuts them: the same results."""
    from raft_tpu_torch.neighbors import ivf_pq as tpq
    from raft_tpu_torch.parallel import shard_rows

    x, q, _, _, tidx = pq_case
    sp = tpq.SearchParams(**REFINED)
    v0, i0 = tivf.search_ivf_pq(sp, tidx, q, 8, tidx.mesh, dataset=x)
    shards, _ = shard_rows(torch.as_tensor(x), tidx.mesh)
    v1, i1 = tivf.search_ivf_pq(sp, tidx, q, 8, tidx.mesh, dataset=shards)
    assert torch.equal(i0, i1) and torch.equal(v0, v1)


def test_fused_scan_is_the_exact_scan_minus_the_bin_rule():
    """The fused scan-in-ring tier keeps each probed list's two best per
    strided bin (slot mod 128), as the LUT-scan tier does, so where three
    or more of a row's exact top-k share a (rank, list, bin) cell it
    returns the next best instead. ``chip_smoke._bin_rule_picks`` (the
    reference of the smoke's ``[shard leg 3]`` check) applied to each
    chunk row's exact top-2k gives the plain fused tier's picks, f64 key
    ties apart; in this case (lists of ~900 rows, 8 to a bin) the rule
    drops picks."""
    import chip_smoke

    n, k = 4, 64
    c = ring_scan_case(8, n_dev=n, seed=2, L=1000)
    mc, S = c["mc"], c["S"]
    cb = c["cb"].astype(np.float64)
    _, pi = K.ring_lut_scan_merge(*ring_scan_ops(c, ["cpu"] * n), k, "l2",
                                  pq_bits=8, pq_dim=S, L=c["L"])
    slot = np.arange(c["L"])
    valid = (c["ids"] >= 0) & (slot[None, None, :]
                               < c["list_sizes"][:, :, None])

    class Shards:
        n_shards = n
        packed_ids = [torch.tensor(c["ids"][r]) for r in range(n)]

    lost = 0
    for ch in range(n):
        for i in range(mc):
            q = c["qv"][ch, i].astype(np.float64)
            lut = np.einsum("sp,skp->sk", q.reshape(S, -1), cb)
            members = c["lists"][ch][c["ind"][ch, :, i] > 0.5]
            keys, gids = [], []
            for r in range(n):
                codes = c["packed"][r, members].astype(np.int64)  # [u, L, S]
                dot = (c["centers_rot"][members].astype(np.float64) @ q
                       )[:, None] + lut[np.arange(S), codes].sum(-1)
                key = c["norms"][r, members] - 2.0 * dot
                ok = valid[r, members]
                keys.append(key[ok])
                gids.append(c["ids"][r, members][ok])
            keys, gids = np.concatenate(keys), np.concatenate(gids)
            order = np.argsort(keys, kind="stable")[:2 * k]
            want, dropped = chip_smoke._bin_rule_picks(
                Shards, torch.tensor(gids[order]), k)
            lost += len(dropped)
            key_of = dict(zip(gids.tolist(), keys.tolist()))
            got = pi[ch][i].tolist()
            for j in range(k):
                if got[j] != want[j]:
                    a, b = key_of[got[j]], key_of[want[j]]
                    assert abs(a - b) <= 1e-3 + 1e-4 * abs(b), (ch, i, j)
    assert lost > 0


# ---------------------------------------------------------------------------
# sharded IVF-Flat (mirrors tests/test_parallel_ivf.py:115-200)
# ---------------------------------------------------------------------------

FLAT_SHARDS = 4


@pytest.fixture(scope="module")
def flat_case():
    """The JAX package's sharded IVF-Flat data (4096 × 32 normals, 64
    queries), their exact top-10, and a JAX-built 4-shard index."""
    from raft_tpu.neighbors import ivf_flat as jflat
    from raft_tpu.parallel import build_ivf_flat as jbuild

    rng = np.random.default_rng(7)
    x = rng.standard_normal((4096, 32), dtype=np.float32)
    q = rng.standard_normal((64, 32), dtype=np.float32)
    jidx = jbuild(jflat.IndexParams(n_lists=32, kmeans_n_iters=8, seed=3),
                  jnp.asarray(x), jax_mesh(FLAT_SHARDS))
    return x, q, exact_knn(x, q, 10), jidx


def _recall10(ids, gt):
    return overlap(np.asarray(ids), gt)


def test_sharded_flat_recall_matches_single_device(flat_case):
    """The port's sharded build and search: recall ≥ 0.8 and within 0.08
    of its single-device index, within 0.02 of the JAX package's sharded
    build, every id valid; ``list_sizes`` sum to the rows kept."""
    from raft_tpu.neighbors import ivf_flat as jflat
    from raft_tpu.parallel import search_ivf_flat as jsearch
    from raft_tpu_torch.neighbors import ivf_flat as tflat

    x, q, gt, jidx = flat_case
    params = tflat.IndexParams(n_lists=32, kmeans_n_iters=8, seed=3)
    sp = tflat.SearchParams(n_probes=16)
    single = tflat.build(x, params, device="cpu")
    r1 = _recall10(tflat.search(single, q, 10, sp, device="cpu")[1], gt)
    mesh = _cpu_mesh(FLAT_SHARDS)
    sharded = tivf.build_ivf_flat(params, x, mesh)
    assert sharded.size + tspans.total(
        "ivf_flat.build.dropped", site="parallel.build_ivf_flat") == len(x)
    _, ids = tivf.search_ivf_flat(sp, sharded, q, 10, mesh)
    r4 = _recall10(ids, gt)
    _, jids = jsearch(jflat.SearchParams(n_probes=16), jidx, jnp.asarray(q),
                      10, jax_mesh(FLAT_SHARDS))
    assert r4 >= 0.8 and r4 >= r1 - 0.08, (r4, r1)
    assert abs(r4 - _recall10(jids, gt)) <= 0.02
    assert bool((ids >= 0).all())


def _flat_from_jax(jidx, mesh):
    arrays = {name: np.asarray(getattr(jidx, name))
              for name in ("centers", "packed_data", "packed_ids",
                           "packed_norms", "list_sizes")}
    return tivf.ShardedIvfFlat.from_numpy(
        arrays, {"metric": jidx.metric,
                 "global_list_cap": jidx.global_list_cap}, mesh)


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_crossed_flat_index_searches_agree(flat_case, merge):
    """A JAX-built sharded IVF-Flat index crossed into the port: both
    packages' searches give the same ids away from value ties (values
    rtol 1e-4), through the merge tier asked for."""
    from raft_tpu.neighbors import ivf_flat as jflat
    from raft_tpu.parallel import search_ivf_flat as jsearch
    from raft_tpu_torch.neighbors import ivf_flat as tflat

    x, q, _, jidx = flat_case
    mesh = _cpu_mesh(FLAT_SHARDS)
    tidx = _flat_from_jax(jidx, mesh)
    jv, ji = jsearch(jflat.SearchParams(n_probes=8), jidx, jnp.asarray(q),
                     10, jax_mesh(FLAT_SHARDS), merge=merge)
    tv, ti = tivf.search_ivf_flat(tflat.SearchParams(n_probes=8), tidx, q,
                                  10, mesh, merge=merge)
    assert_ids_match_away_from_ties(ti.numpy(), tv.numpy(), np.asarray(ji),
                                    np.asarray(jv))


def test_sharded_flat_exact_within_probed_lists(flat_case):
    """n_probes = n_lists: the sharded scan is exhaustive, recall 1.0."""
    from raft_tpu_torch.neighbors import ivf_flat as tflat

    x, q, _, _ = flat_case
    mesh = _cpu_mesh(FLAT_SHARDS)
    sharded = tivf.build_ivf_flat(tflat.IndexParams(
        n_lists=16, kmeans_n_iters=4, list_size_cap_factor=32.0), x, mesh)
    _, ids = tivf.search_ivf_flat(tflat.SearchParams(n_probes=16), sharded,
                                  q[:16], 10, mesh)
    assert _recall10(ids, exact_knn(x, q[:16], 10)) >= 0.999


def test_sharded_flat_ring_and_hier_match_allgather(flat_case):
    """Through ``ivf_flat.search(mesh=)``: the ring and the hier merge
    (over a (dcn, ici) mesh of the same ranks) equal the allgather tier;
    a filter over the global ids is honoured by every tier."""
    from raft_tpu_torch.core import bitset as tbits
    from raft_tpu_torch.neighbors import ivf_flat as tflat
    from raft_tpu_torch.parallel import hier_mesh

    x, q, _, jidx = flat_case
    mesh = _cpu_mesh(FLAT_SHARDS)
    tidx = _flat_from_jax(jidx, mesh)
    sp = tflat.SearchParams(n_probes=8)
    va, ia = tflat.search(tidx, q, 10, sp, mesh=mesh, merge="allgather",
                          device="cpu")
    vr, ir = tflat.search(tidx, q, 10, sp, mesh=mesh, merge="ring",
                          device="cpu")
    mesh2 = hier_mesh(2, 2, devices="cpu")
    vh, ih = tflat.search(tidx, q, 10, sp, mesh=mesh2,
                          mesh_axis=("dcn", "ici"), device="cpu")
    for v, i in ((vr, ir), (vh, ih)):
        assert torch.equal(i, ia) and torch.equal(v, va)
    keep = np.random.default_rng(1).random(len(x)) < 0.3
    words = tbits.to_numpy(tbits.from_mask(torch.from_numpy(keep)))
    for merge in ("allgather", "ring"):
        _, fi = tflat.search(tidx, q, 10, sp, filter_bitset=words,
                             mesh=mesh, merge=merge, device="cpu")
        fi = fi.numpy()
        assert keep[fi[fi >= 0]].all()


def test_flat_mesh_dispatch_validates(flat_case):
    from raft_tpu_torch.neighbors import ivf_flat as tflat
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    x, q, _, jidx = flat_case
    mesh = _cpu_mesh(FLAT_SHARDS)
    single = tflat.build(x[:512], tflat.IndexParams(n_lists=16,
                                                    kmeans_n_iters=2),
                         device="cpu")
    with pytest.raises(Exception, match="ShardedIvfFlat"):
        tflat.search(single, q, 5, tflat.SearchParams(n_probes=4),
                     mesh=mesh, device="cpu")
    with pytest.raises(Exception, match="mesh="):
        tflat.search(_flat_from_jax(jidx, mesh), q, 5,
                     tflat.SearchParams(n_probes=4), device="cpu")
    pq_single = tpq.build(x[:512], tpq.IndexParams(n_lists=16, pq_dim=8,
                                                   kmeans_n_iters=2),
                          device="cpu")
    with pytest.raises(Exception, match="ShardedIvfPq"):
        tpq.search(pq_single, q, 5, tpq.SearchParams(n_probes=4), mesh=mesh,
                   device="cpu")
