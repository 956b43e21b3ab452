"""The port's sharded tier against the JAX package's, on the CPU.

Same seeded numpy inputs go through ``raft_tpu.parallel`` on the virtual
CPU mesh of the test run (``tests/conftest.py``: 8 devices; meshes of
2, 4 and 8 are cut from it) and through ``raft_tpu_torch.parallel`` on a
mesh of CPU ranks, where each kernel wrapper runs its plain version.
The JAX package's Pallas kernels run as its own tests run them: the ring
merge with ``interpret=True``, the fused tier under
``RAFT_TPU_RING_FUSED=on``.

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
from jax.sharding import PartitionSpec as P

from raft_tpu.core.compat import shard_map
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

def _jax_ring(vals, ids, k, select_min):
    n, m, _ = vals.shape
    mesh = jax_mesh(n)

    def body(v, i):
        return jpk.ring_topk_merge(v[0], i[0], k, "shard", n, select_min,
                                   interpret=True)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P("shard", None, None), P("shard", None, None)),
                   out_specs=(P("shard", None), P("shard", None)),
                   check_vma=False)
    gv, gi = fn(jnp.asarray(vals), jnp.asarray(ids))
    return np.asarray(gv)[:m], np.asarray(gi)[:m]


# (n_dev, m, k, select_min, variant): n_dev 2/4/8, ragged m, max-select,
# k 1, a rank with no candidates, duplicate ids, ties
RING_PARITY = [(2, 27, 10, True, "ties"), (4, 16, 4, False, "sentinels"),
               (8, 9, 1, True, "plain"), (4, 8, 6, True, "dup")]


@pytest.mark.parametrize("n_dev,m,k,select_min,variant", RING_PARITY)
def test_ring_topk_merge_plain_matches_interpreted_kernel(
        n_dev, m, k, select_min, variant):
    vals, ids = ring_tables(n_dev, m, k, seed=n_dev * 100 + m,
                            select_min=select_min, variant=variant)
    jv, ji = _jax_ring(vals, ids, k, select_min)
    tv, ti = K.ring_topk_merge([torch.tensor(v) for v in vals],
                               [torch.tensor(i) for i in ids], k, select_min)
    tv = torch.cat(tv).numpy()[:m]
    ti = torch.cat(ti).numpy()[:m]
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


def _chunk_chains(vals, ids, k, select_min):
    """The ring unrolled, as the CUDA kernel walks it (csrc/ring_topk.cu):
    chunk c starts as rank (c + 1) mod n's k best, then merges in ranks
    (c + 2) mod n, …, c, each by a stable sort of incoming ++ local."""
    n, m, _ = vals.shape
    mc = K.ring_chunk_rows(m, n)
    keys = torch.tensor(vals if select_min else -vals)
    tids = torch.tensor(ids)
    keys = torch.where(tids < 0, torch.full_like(keys, float("inf")), keys)
    pad = (0, 0, 0, n * mc - m)
    keys = torch.nn.functional.pad(keys, pad, value=float("inf"))
    tids = torch.nn.functional.pad(tids, pad, value=-1)

    def top(v, i):
        sv, pos = torch.sort(v, dim=1, stable=True)
        return sv[:, :k], torch.gather(i, 1, pos[:, :k])

    out_v, out_i = [], []
    for c in range(n):
        rows = slice(c * mc, (c + 1) * mc)
        rv, ri = top(keys[(c + 1) % n, rows], tids[(c + 1) % n, rows])
        for step in range(2, n + 1):
            q = (c + step) % n
            rv, ri = top(torch.cat([rv, keys[q, rows]], 1),
                         torch.cat([ri, tids[q, rows]], 1))
        inf = torch.isinf(rv)
        out_i.append(torch.where(inf, torch.full_like(ri, -1), ri))
        out_v.append(rv if select_min else torch.where(
            inf, torch.full_like(rv, float("-inf")), -rv))
    return torch.cat(out_v).numpy()[:m], torch.cat(out_i).numpy()[:m]


# (n_dev, m, k, select_min, variant): every variant at n 2/4/8, k 1/10/64
# and both select modes, ragged m
RING_CHAINS = [(2, 27, 10, True, "ties"), (2, 11, 64, False, "dup"),
               (4, 37, 64, False, "sentinels"), (4, 16, 10, True, "dup"),
               (4, 50, 1, False, "ties"), (8, 9, 1, True, "sentinels"),
               (8, 30, 10, False, "ties"), (8, 13, 64, True, "dup")]


@pytest.mark.parametrize("n_dev,m,k,select_min,variant", RING_CHAINS)
def test_ring_chunk_chains_are_the_ring(n_dev, m, k, select_min, variant):
    """The per-chunk merge chain the CUDA kernel runs in one launch gives
    the hop-by-hop ring schedule's values and ids exactly, ties included,
    and the JAX package's interpreted ring kernel's."""
    vals, ids = ring_tables(n_dev, m, k, seed=n_dev * 1000 + m * 7 + k,
                            select_min=select_min, variant=variant)
    cv, ci = _chunk_chains(vals, ids, k, select_min)
    pv, pi = K.ring_topk_merge([torch.tensor(v) for v in vals],
                               [torch.tensor(i) for i in ids], k, select_min)
    np.testing.assert_array_equal(cv, torch.cat(pv).numpy()[:m])
    np.testing.assert_array_equal(ci, torch.cat(pi).numpy()[:m])
    jv, ji = _jax_ring(vals, ids, k, select_min)
    np.testing.assert_array_equal(cv, jv)
    np.testing.assert_array_equal(ci, ji)


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


# (pq_bits, n, ties): ties puts small integers in every operand (exact keys
# in both packages) and repeats lists and shards, so many keys tie across
# bins, lists and ranks
RING_SCAN_PARITY = [pytest.param(4, 2, False, id="4-2"),
                    pytest.param(8, 4, False, id="8-4"),
                    pytest.param(8, 3, True, id="8-3-ties"),
                    pytest.param(5, 2, True, id="5-2-ties"),
                    pytest.param(8, 4, True, id="8-4-ties")]


@pytest.mark.parametrize("pq_bits,n,ties", RING_SCAN_PARITY)
def test_ring_lut_scan_merge_plain_matches_interpreted_kernel(pq_bits, n,
                                                              ties):
    """The fused scan-in-ring plain version against the JAX package's
    interpreted kernel on the same chunk tables and shards (f32 LUT, two
    code tiles a list), and the chunk tables themselves against the JAX
    package's; on integer keys ids and keys equal exactly, tie order
    included."""
    from raft_tpu.parallel.ivf import _chunk_unions as jchunk

    k = 10
    c = ring_scan_case(pq_bits, n_dev=n, m=20, seed=1, n_lists=10, L=260,
                       n_probes=3, ties=ties)
    rng = np.random.default_rng(pq_bits)
    probes = np.stack([rng.choice(10, 3, replace=False)
                       for _ in range(n * c["mc"])]).astype(np.int32)
    probes = probes.reshape(n, c["mc"], 3)
    jl, jind = jchunk(jnp.asarray(probes), c["NS"])
    tl, tind = tivf._chunk_unions(torch.tensor(probes), c["NS"])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tind.numpy(), np.asarray(jind))
    c["lists"], c["ind"] = tl.numpy(), tind.numpy()
    mesh = jax_mesh(n)

    def body(codes, ids, norms, lists, ind, qv, ctr, cb):
        return jpk.ring_lut_scan_merge(
            lists, ind, qv, codes[0], ids[0], norms[0], ctr, cb, k, "l2",
            pq_bits=pq_bits, pq_dim=c["S"], L=c["L"], axis_name="shard",
            n_dev=n, lut_dtype="float32", interpret=True)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P("shard", None, None, None),
                             P("shard", None, None), P("shard", None, None),
                             P(), P(), P(), P(), P()),
                   out_specs=(P("shard", None), P("shard", None)),
                   check_vma=False)
    jk, ji = fn(*(jnp.asarray(c[name]) for name in (
        "packed", "ids", "norms", "lists", "ind", "qv", "centers_rot", "cb")))
    jk, ji = np.asarray(jk)[:, :k], np.asarray(ji)[:, :k]
    tk, ti = K.ring_lut_scan_merge(*ring_scan_ops(c, ["cpu"] * n), k, "l2",
                                   pq_bits=pq_bits, pq_dim=c["S"], L=c["L"])
    tk, ti = torch.cat(tk).numpy(), torch.cat(ti).numpy()
    assert (ti >= 0).sum() > 0
    if ties:
        fin = np.isfinite(tk)
        assert len(np.unique(tk[fin])) < fin.sum() // 2   # ties abound
        np.testing.assert_array_equal(tk[fin], jk[fin])
        np.testing.assert_array_equal(ti[fin], ji[fin])
    assert_ids_match_away_from_ties(ti, tk, ji, jk, rtol=1e-4, atol=1e-3)


def _local_tables(c, k, metric="l2"):
    """Each rank's local top-k of every chunk row, as the fused kernel's
    first launch keeps it: [n][n·mc, k] keys and ids — the stable top-k of
    the row's bins laid out in union order (list after list, 256 columns
    each), ids −1 at +inf."""
    n, mc = c["n_dev"], c["mc"]
    ops = ring_scan_ops(c, ["cpu"] * n)
    lists, ind, qv, packed, ids, norms, sizes, ctr, cb = ops
    vals = np.full((n, n * mc, k), np.inf, np.float32)
    gids = np.full((n, n * mc, k), -1, np.int32)
    for r in range(n):
        for ch in range(n):
            NS = lists[r].shape[1]
            keys = torch.full((NS, mc, 256), float("inf"))
            kid = torch.full((NS, mc, 256), -1, dtype=torch.int32)
            si, sl = torch.nonzero(ind[r][ch] > 0.5, as_tuple=True)
            keys[si, sl], kid[si, sl] = K._lut_bins_plain(
                lists[r][ch][si], qv[r][ch][sl], packed[r], ids[r], norms[r],
                sizes[r], ctr[r], cb[r], metric, c["pq_bits"])
            sv, pos = torch.sort(keys.permute(1, 0, 2).reshape(mc, -1),
                                 dim=1, stable=True)
            si_ = torch.gather(kid.permute(1, 0, 2).reshape(mc, -1), 1, pos)
            sv, si_ = sv[:, :k], si_[:, :k]
            rows = slice(ch * mc, (ch + 1) * mc)
            vals[r, rows] = sv.numpy()
            gids[r, rows] = torch.where(torch.isinf(sv), -1, si_).numpy()
    return vals, gids


# (pq_bits, n, k, ties)
RING_SCAN_CHAINS = [(8, 2, 10, True), (5, 3, 64, True), (8, 4, 1, False),
                    (4, 4, 10, True), (6, 3, 10, False)]


@pytest.mark.parametrize("pq_bits,n,k,ties", RING_SCAN_CHAINS)
def test_ring_scan_chains_are_the_ring(pq_bits, n, k, ties):
    """The fused kernel's two launches, on the CPU: each (rank, chunk row)
    cut to its local top-k first, then chunk c's chain (rank c + 1's, then
    ranks c + 2 … c merged in, incoming before local) gives the hop-by-hop
    schedule over the full bin tables (the plain version) exactly, ties
    included."""
    c = ring_scan_case(pq_bits, n_dev=n, seed=k, ties=ties)
    vals, gids = _local_tables(c, k)
    cv, ci = _chunk_chains(vals, gids, k, True)
    kw = dict(pq_bits=pq_bits, pq_dim=c["S"], L=c["L"])
    pv, pi = K.ring_lut_scan_merge(*ring_scan_ops(c, ["cpu"] * n), k, "l2",
                                   **kw)
    np.testing.assert_array_equal(cv, torch.cat(pv).numpy())
    np.testing.assert_array_equal(ci, torch.cat(pi).numpy())
    assert (ci >= 0).sum() > 0


def _warp_topk_model(keys, ids, members, k, n_warps, rng):
    """The fused kernel's local top-k (csrc/ring_lut_scan.cu), modelled:
    items (member list u, quarter qd) taken in a shuffled order by
    ``n_warps`` warps; an item offers its 64 bin entries (columns 32·qd + l
    and 128 + 32·qd + l) with position = union position · 256 + column to
    its warp's running top-k on (key, position), +inf never entering; then
    the warps' lists merge. Returns (keys [k], ids [k]), (+inf, −1) past
    the finite entries."""
    items = [(u, qd) for u in members for qd in range(4)]
    order = rng.permutation(len(items))
    warps = [[] for _ in range(n_warps)]
    for n_, it in enumerate(order):
        u, qd = items[it]
        w = warps[int(rng.integers(n_warps)) if n_ else 0]
        for col in [32 * qd + l for l in range(32)] + [
                128 + 32 * qd + l for l in range(32)]:
            if np.isfinite(keys[u, col]):
                w.append((keys[u, col], u * 256 + col, ids[u, col]))
        w.sort(key=lambda e: (e[0], e[1]))
        del w[k:]
    merged = sorted((e for w in warps for e in w), key=lambda e: (e[0], e[1]))
    out_k = np.full(k, np.inf, np.float32)
    out_i = np.full(k, -1, np.int32)
    for j, (v, _, i) in enumerate(merged[:k]):
        out_k[j], out_i[j] = v, i
    return out_k, out_i


# (k, warps, NS): k 1 / 10 / 64 over 1, 4 and 16 warps
RING_LOCAL = [(1, 1, 40), (10, 4, 40), (64, 16, 40), (10, 16, 7),
              (64, 3, 100)]


@pytest.mark.parametrize("k,n_warps,NS", RING_LOCAL)
def test_ring_scan_local_topk_order(k, n_warps, NS):
    """Offering each member list's bins to running top-ks on (key, union
    position, column), whatever order and warp the items go to, then
    merging the warps', gives the stable top-k of the plain version's
    table (a row's bins in union order, +inf for lists it did not probe)
    exactly, ties included."""
    rng = np.random.default_rng(k * 100 + NS)
    keys = rng.integers(0, 12, (NS, 256)).astype(np.float32)  # heavy ties
    keys[rng.random((NS, 256)) < 0.3] = np.inf
    ids = rng.permutation(NS * 256).astype(np.int32).reshape(NS, 256)
    ids[np.isinf(keys)] = -1
    members = np.sort(rng.choice(NS, max(1, NS // 3), replace=False))
    table = np.full((NS, 256), np.inf, np.float32)
    tids = np.full((NS, 256), -1, np.int32)
    table[members], tids[members] = keys[members], ids[members]
    sv, pos = torch.sort(torch.tensor(table.reshape(-1)), stable=True)
    want_k = sv[:k].numpy()
    want_i = np.where(np.isinf(want_k), -1, tids.reshape(-1)[pos[:k].numpy()])
    for trial in range(3):
        got_k, got_i = _warp_topk_model(keys, ids, members, k, n_warps,
                                        np.random.default_rng(trial))
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_i, want_i)


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
