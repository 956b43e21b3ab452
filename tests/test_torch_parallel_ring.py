"""The ring kernels' plain versions (B7, B8) against the JAX package's
interpreted kernels and the hop-by-hop ring schedule, on the CPU.

The ring-kernel tests of ``tests/test_torch_parallel.py``, in a file of
their own so that the test run's workers share them out: the same seeded
tables and shards go through the JAX package's Pallas ring kernels
(``interpret=True``, on meshes cut from the test run's 8-device CPU mesh)
and through the port's wrappers on CPU tensors, where each runs its plain
version.

Tolerances: the ring merge and its chunk chains exact (values and ids,
ties included); the fused scan-in-ring ids equal away from key ties
within rtol 1e-4, atol 1e-3, and on integer-valued cases keys and ids
equal exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.core.compat import shard_map
from raft_tpu.ops import pallas_kernels as jpk

from raft_tpu_torch.ops import kernels as K
from raft_tpu_torch.parallel import ivf as tivf

from torch_parity import (assert_ids_match_away_from_ties, jax_mesh,
                          ring_scan_case, ring_scan_ops, ring_tables)


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


# ---------------------------------------------------------------------------
# the fused scan-in-ring (B8)
# ---------------------------------------------------------------------------

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
