"""Shared helpers of the raft_tpu ↔ raft_tpu_torch parity tests: seeded
numpy inputs feed both packages, indexes cross between them as numpy
arrays."""

from __future__ import annotations

import numpy as np
import pytest
import torch

INDEX_FIELDS = ("centers", "centers_rot", "rotation", "codebooks",
                "packed_codes", "packed_ids", "packed_norms", "list_sizes")


@pytest.fixture(scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread for a module, its count restored after.
    Under the suite's parallel workers each worker's pool of a thread a core
    oversubscribes the CPU: small element-wise ops then wait on each other's
    threads, and a module of them ran some tenfold slower. A module takes it
    as ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blobs(n: int, d: int, n_clusters: int, seed: int, std: float = 1.0):
    """Gaussian blobs made with numpy (same inputs for both packages)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, (n_clusters, d)).astype(np.float32)
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + std * rng.standard_normal((n, d))).astype(
        np.float32)


def jax_index_arrays(index):
    """A raft_tpu ``IvfPqIndex`` → (arrays, meta) for ``from_numpy``. The
    bf16 recon cache does not cross as an array: ``has_recon`` tells the
    other side to rebuild it."""
    arrays = {name: np.asarray(getattr(index, name)) for name in INDEX_FIELDS}
    meta = {"metric": index.metric, "pq_bits": index.pq_bits,
            "pq_dim": index.pq_dim, "codebook_kind": index.codebook_kind,
            "has_recon": index.packed_recon is not None}
    return arrays, meta


def jax_index_from_arrays(arrays, meta):
    """(arrays, meta) → a raft_tpu ``IvfPqIndex``, its recon cache rebuilt
    by the JAX package's ``_build_recon_cache`` when ``has_recon``."""
    import jax.numpy as jnp
    from raft_tpu.neighbors import ivf_pq as jpq

    index = jpq.IvfPqIndex(
        **{name: jnp.asarray(arrays[name]) for name in INDEX_FIELDS},
        metric=meta["metric"], codebook_kind=meta["codebook_kind"],
        pq_bits=int(meta["pq_bits"]), pq_dim_static=int(meta["pq_dim"]))
    if meta.get("has_recon"):
        index = index.replace(packed_recon=jpq._build_recon_cache(index))
    return index


FLAT_FIELDS = ("centers", "packed_data", "packed_ids", "packed_norms",
               "list_sizes")


def jax_flat_arrays(index):
    """A raft_tpu ``IvfFlatIndex`` → (arrays, meta) for
    ``ivf_flat.from_numpy``."""
    return ({name: np.asarray(getattr(index, name)) for name in FLAT_FIELDS},
            {"metric": index.metric})


def jax_flat_from_arrays(arrays, meta):
    """(arrays, meta) → a raft_tpu ``IvfFlatIndex``."""
    import jax.numpy as jnp
    from raft_tpu.neighbors import ivf_flat as jfl

    return jfl.IvfFlatIndex(
        **{name: jnp.asarray(arrays[name]) for name in FLAT_FIELDS},
        metric=meta["metric"])


def overlap(a, b) -> float:
    """Mean per-row fraction of shared ids."""
    a, b = np.asarray(a), np.asarray(b)
    k = a.shape[1]
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)]))


def exact_knn(x: np.ndarray, q: np.ndarray, k: int) -> np.ndarray:
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2
         ).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def cuda_device():
    """The card for a ``cuda``-marked test; skips where there is none
    (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (python3 chip_smoke.py drives them)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# kernel inputs (JAX-free, so the card's tests run where JAX is absent)
# ---------------------------------------------------------------------------

def tied_scores(m: int, n: int, seed: int) -> np.ndarray:
    """Scores drawn from a few dozen values, so every row holds many
    exact duplicates (ties decide positions)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 40, (m, n)).astype(np.float32) * 0.25


def scan_case(pq_bits: int, seed: int = 0, n_lists: int = 16, L: int = 300,
              S: int = 16, P: int = 2, B: int = 40, n_probes: int = 8):
    """Random per_subspace index fields, queries and their segment table,
    with invalid ids sprinkled in, lists of size 0 (list 0), 1 (list 1),
    L (list 2) and a short one (list 3); ``list_sizes`` is one past each
    list's last valid id, as ``pack_lists`` leaves them. Packing and
    segmenting use the port's functions, which the CPU tests hold against
    the JAX package's."""
    from raft_tpu_torch.neighbors import ivf_common as tic
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    rng = np.random.default_rng(seed * 10 + pq_bits)
    Kb = 1 << pq_bits
    rot = S * P
    codes = rng.integers(0, Kb, (n_lists * L, S)).astype(np.uint8)
    packed = tpq.pack_bits(torch.tensor(codes), pq_bits).numpy().reshape(
        n_lists, L, -1)
    ids = rng.permutation(n_lists * L).astype(np.int32).reshape(n_lists, L)
    ids[rng.random((n_lists, L)) < 0.1] = -1
    ids[3, 150:] = -1
    ids[0] = -1
    ids[1, 1:] = -1
    ids[1, 0] = n_lists * L
    ids[2, L - 1] = n_lists * L + 1
    valid = ids >= 0
    sizes = np.where(valid.any(1), L - np.argmax(valid[:, ::-1], axis=1),
                     0).astype(np.int32)
    centers_rot = rng.standard_normal((n_lists, rot)).astype(np.float32) * 4
    cb = rng.standard_normal((S, Kb, P)).astype(np.float32)
    norms = rng.uniform(10, 60, (n_lists, L)).astype(np.float32)
    q_rot = rng.standard_normal((B, rot)).astype(np.float32) * 4
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(B)]).astype(np.int32)
    for b in range(3):  # lists 0-2 are probed
        probes[b] = np.concatenate([np.roll([0, 1, 2], b), rng.choice(
            np.arange(3, n_lists), n_probes - 3, replace=False)])
    seg = tic.SEGMENT_SIZE
    n_seg = tic.n_segments(B * n_probes, n_lists, seg)
    seg_list, seg_q, pair_seg, pair_slot = tic.segment_probes(
        torch.tensor(probes), n_lists, seg, n_seg)
    return dict(packed=packed, ids=ids, norms=norms, centers_rot=centers_rot,
                cb=cb, q_rot=q_rot, seg_list=seg_list.numpy(),
                seg_q=seg_q.numpy(), pair_seg=pair_seg.numpy(),
                pair_slot=pair_slot.numpy(), list_sizes=sizes, S=S, L=L,
                pq_bits=pq_bits)


SCAN_OPERANDS = ("seg_list", "seg_q", "pair_seg", "pair_slot", "q_rot",
                 "packed", "ids", "norms", "list_sizes", "centers_rot", "cb")


def scan_reference_keys(c, cb_used: np.ndarray, metric: str):
    """f64 keys of every (query b, probe p) pair against its list's
    positions: {(b, p): [L]}, +inf where the id is < 0."""
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    S, P = c["S"], cb_used.shape[2]
    codes = tpq.unpack_bits(torch.tensor(c["packed"]), S,
                            c["pq_bits"]).numpy().astype(np.int64)
    out = {}
    B, n_probes = c["pair_seg"].shape
    for b in range(B):
        q = c["q_rot"][b].astype(np.float64)
        lut = np.einsum("sp,skp->sk", q.reshape(S, P),
                        cb_used.astype(np.float64))
        for p in range(n_probes):
            lst = c["seg_list"][c["pair_seg"][b, p]]
            qd = lut[np.arange(S)[None, :], codes[lst]].sum(1)
            dot = q @ c["centers_rot"][lst].astype(np.float64) + qd
            key = -dot if metric == "ip" else c["norms"][lst] - 2.0 * dot
            out[(b, p)] = np.where(c["ids"][lst] >= 0, key, np.inf)
    return out


def pair_rows(c, table):
    """A segment-ordered [n_seg, seg, w] table (the JAX kernel's) →
    pair order [B, P, w]: row (b, p) is the slot that pair holds."""
    return np.asarray(table)[c["pair_seg"], c["pair_slot"]]


def assert_bins_match(tk, ti, jk, ji, ref, rtol: float, atol: float):
    """Two [B, P, 256] bin tables in pair order: keys within tolerance on
    every pair; ids equal unless the reference keys of the neighbouring
    rank in the same bin lie within that tolerance."""
    for (s, j), key in ref.items():
        np.testing.assert_allclose(tk[s, j], jk[s, j], rtol=rtol, atol=atol)
        for b in range(128):
            kb = np.sort(key[b::128])[:3]
            kb = np.concatenate([kb, np.full(3 - kb.shape[0], np.inf)])
            for r in range(2):
                col = b + 128 * r
                if ti[s, j, col] == ji[s, j, col]:
                    continue
                tol = atol + rtol * abs(kb[r])
                near = [abs(kb[r] - kb[o]) <= tol for o in (r - 1, r + 1)
                        if 0 <= o < 3 and np.isfinite(kb[o])]
                assert any(near), (s, j, b, r, kb)


# The byte row types of the list scans: each one's value range.
BYTE_ROWS = {"int8": (-128, 128, torch.int8), "uint8": (0, 256, torch.uint8)}


def flat_scan_case(L: int, d: int, bf16: bool = False, seed: int = 0,
                   n_lists: int = 6, B: int = 40, n_probes: int = 3,
                   seg: int = 16, ties: bool = False, rows: str = ""):
    """Raw-vector list blocks, ids (10 % invalid, one list with an invalid
    tail), queries and their segment table (its trailing segments are
    empty: ``n_segments`` is an upper bound). bf16 list data is returned
    already rounded, as float32 numpy. ``ties``: small integer vectors, so
    every key is exact in f32 whatever the order of its sums, and many
    keys tie. ``rows`` "int8" or "uint8": list rows drawn over that type's
    whole range (as float32 numpy; :func:`flat_scan_operands` casts them),
    queries at the same scale."""
    from raft_tpu_torch.neighbors import ivf_common as tic

    rng = np.random.default_rng(seed * 1000 + L + d)
    if rows:
        lo, hi, _ = BYTE_ROWS[rows]
        packed = rng.integers(lo, hi, (n_lists, L, d)).astype(np.float32)
    else:
        packed = _int_rows(rng, (n_lists, L, d)) if ties else (
            rng.standard_normal((n_lists, L, d)).astype(np.float32))
    if bf16:
        packed = torch.tensor(packed).to(torch.bfloat16).float().numpy()
    ids = rng.permutation(n_lists * L).reshape(n_lists, L).astype(np.int32)
    ids[rng.random((n_lists, L)) < 0.1] = -1
    ids[1, L // 2:] = -1
    q = (_int_rows(rng, (B, d)) if ties
         else rng.standard_normal((B, d)).astype(np.float32))
    if rows:
        q = (q * 40.0 + (0.0 if rows == "int8" else 128.0)).astype(np.float32)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(B)]).astype(np.int32)
    n_seg = tic.n_segments(B * n_probes, n_lists, seg)
    seg_list, seg_q, _, _ = tic.segment_probes(torch.tensor(probes), n_lists,
                                               seg, n_seg)
    return dict(seg_list=seg_list.numpy(), seg_q=seg_q.numpy(), q=q,
                packed=packed, ids=ids, bf16=bf16, rows=rows)


def flat_scan_operands(c, device="cpu"):
    """The scan kernels' operands of a :func:`flat_scan_case` as tensors."""
    packed = torch.tensor(c["packed"])
    if c["bf16"]:
        packed = packed.to(torch.bfloat16)
    if c.get("rows"):
        packed = packed.to(BYTE_ROWS[c["rows"]][2])
    return [torch.tensor(c["seg_list"]).to(device),
            torch.tensor(c["seg_q"]).to(device),
            torch.tensor(c["q"]).to(device), packed.to(device),
            torch.tensor(c["ids"]).to(device)]


def flat_keys64(c, metric: str):
    """f64 keys of every (live slot, list position) of a flat scan case:
    {(s, j): [L]}, +inf where the id is < 0."""
    out = {}
    for s, j in zip(*np.nonzero(c["seg_q"] >= 0)):
        x = c["packed"][c["seg_list"][s]].astype(np.float64)
        qv = c["q"][c["seg_q"][s, j]].astype(np.float64)
        dot = x @ qv
        if metric == "ip":
            key = -dot
        elif metric == "cos":
            key = 1.0 - dot / (np.sqrt(max(qv @ qv, 1e-30))
                               * np.sqrt(np.maximum((x * x).sum(1), 1e-30)))
        else:
            key = np.maximum(qv @ qv + (x * x).sum(1) - 2.0 * dot, 0.0)
        out[(s, j)] = np.where(c["ids"][c["seg_list"][s]] >= 0, key, np.inf)
    return out


def assert_scan_match(tk, ti, rk, ri, c, metric: str, picks: str,
                      rtol: float = 1e-4, atol: float = 1e-4):
    """Two scan outputs [n_seg, S, w] of a flat scan case ``c`` — keys and
    ``picks`` ("ids": global ids, two per strided bin; "pos": in-list
    positions, sorted) — the second the reference. Pad slots hold the
    (+inf, −1) sentinel; on live slots the finite/infinite pattern is the
    same, keys agree within ``atol + rtol·(|key| + ‖q‖²)`` (the expanded
    l2 form cancels ‖q‖² + ‖x‖²), and where the picks differ the f64 key
    of the tested pick is within that tolerance of the reference key (a
    key tie), in the same bin for "ids"."""
    tk, ti, rk, ri = (np.asarray(a) for a in (tk, ti, rk, ri))
    live = c["seg_q"] >= 0
    assert np.isinf(tk[~live]).all() and (ti[~live] == -1).all()
    assert (np.isinf(tk[live]) == np.isinf(rk[live])).all()
    fin = np.isfinite(rk) & live[..., None]
    qsq = (c["q"].astype(np.float64) ** 2).sum(1)[
        np.clip(c["seg_q"], 0, None)]
    tol = atol + rtol * (np.abs(np.where(fin, rk, 0.0)) + qsq[..., None])
    diff = np.abs(tk[fin] - rk[fin])
    assert (diff <= tol[fin]).all(), diff.max()
    assert (ti[live][~fin[live]] == -1).all()
    bad = np.nonzero((ti != ri) & fin)
    if not bad[0].size:
        return
    keys64 = flat_keys64(c, metric)
    for s, j, col in zip(*bad):
        lids = c["ids"][c["seg_list"][s]]
        if picks == "ids":
            p = int(np.nonzero(lids == ti[s, j, col])[0][0])
            assert p % 128 == col % 128, (s, j, col)
        else:
            p = int(ti[s, j, col])
        assert abs(keys64[(s, j)][p] - rk[s, j, col]) <= tol[s, j, col], (
            s, j, col)


def _int_rows(rng, shape) -> np.ndarray:
    """Vectors of small integers (-2..2) as float32: their dot products and
    norms are exact in f32 in any summation order."""
    return rng.integers(-2, 3, shape).astype(np.float32)


def refine_case(seed: int, m: int = 12, C: int = 300, n: int = 2000,
                d: int = 40, ties: bool = False):
    """Dataset, queries and candidate lists with a duplicated candidate,
    invalid (-1) entries and an out-of-range id (clipped for the fetch).
    ``ties``: small integer vectors (exact keys, many of them tied)."""
    rng = np.random.default_rng(seed)
    if ties:
        data, q = _int_rows(rng, (n, d)), _int_rows(rng, (m, d))
    else:
        data = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((m, d)).astype(np.float32)
    cand = rng.integers(0, n, (m, C)).astype(np.int32)
    cand[:, 5] = cand[:, 2]
    cand[rng.random((m, C)) < 0.05] = -1
    cand[0, :] = -1
    cand[0, :4] = [9, 10, n + 5, 11]
    return data, q, cand


FILTER_KINDS = ("all", "none", "every_other", "sel0.1", "last_word")


def filter_keep(n: int, kind: str, seed: int = 0) -> np.ndarray:
    """A keep mask over ids 0..n−1: "all", "none", "every_other" (even ids),
    "sel0.1" (seeded, 10 % kept) or "last_word" (only the ids of the
    bitset's last 32-bit word)."""
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "every_other":
        return np.arange(n) % 2 == 0
    if kind == "sel0.1":
        return np.random.default_rng(seed).random(n) < 0.1
    if kind == "last_word":
        return np.arange(n) >= (n - 1) // 32 * 32
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# ring inputs (JAX-free)
# ---------------------------------------------------------------------------

def ring_tables(n_dev: int, m: int, k: int, seed: int,
                select_min: bool = True, variant: str = "plain"):
    """Per-rank local top-k tables (vals, ids) [n_dev, m, k], each row
    sorted as a local search emits it. ``variant``: "ties" (values from a
    few levels, so ties decide the order), "dup" (a candidate surviving
    twice), "sentinels" (short rows padded with ±inf / −1 and one rank
    with no candidates at all), or "plain"."""
    rng = np.random.default_rng(seed)
    if variant == "ties":
        vals = rng.integers(0, 6, (n_dev, m, k)).astype(np.float32) * 0.5
    else:
        vals = rng.random((n_dev, m, k)).astype(np.float32)
    ids = rng.integers(0, 100_000, (n_dev, m, k)).astype(np.int32)
    if variant == "dup" and k > 1:
        ids[:, :, 1] = ids[:, :, 0]
    order = np.argsort(vals if select_min else -vals, axis=-1, kind="stable")
    vals = np.take_along_axis(vals, order, -1)
    ids = np.take_along_axis(ids, order, -1)
    if variant == "sentinels":
        pad = np.inf if select_min else -np.inf
        vals[0, :, -2:] = pad
        ids[0, :, -2:] = -1
        vals[n_dev - 1] = pad
        ids[n_dev - 1] = -1
    return vals, ids


def ring_scan_case(pq_bits: int, n_dev: int = 4, m: int = 30, seed: int = 0,
                   n_lists: int = 24, L: int = 300, S: int = 16, P: int = 2,
                   n_probes: int = 6, ties: bool = False):
    """Operands of the fused scan-in-ring kernel: per rank a shard of
    ``n_lists`` packed lists (global ids unique over the ranks, 10 %
    invalid, one short list, one empty list; ``list_sizes`` one past each
    list's last valid id), replicated rotated centers and codebooks,
    and the chunk tables of ``m`` queries with random probes (the
    port's ``_chunk_unions``, which the CPU tests hold against the JAX
    package's). ``ties``: small integers for the queries, centers,
    codebook and norms, so every key is exact in f32 whatever the order of
    its sums, and many keys tie: each list's code rows are drawn from a
    pool of 12, list 1 repeats list 0 (codes, norms and center), and every
    rank holds rank 0's codes and norms (its own ids). Numpy arrays;
    ``ops(c, device)`` gives the wrapper's per-rank tensors."""
    from raft_tpu_torch.neighbors import ivf_pq as tpq
    from raft_tpu_torch.ops import kernels as tk
    from raft_tpu_torch.parallel.ivf import _chunk_unions

    rng = np.random.default_rng(seed * 100 + pq_bits)
    Kb = 1 << pq_bits
    rot = S * P
    mc = tk.ring_chunk_rows(m, n_dev)
    NS = min(mc * n_probes, n_lists)
    if ties:
        pool = rng.integers(0, Kb, (12, S)).astype(np.uint8)
        codes = pool[rng.integers(0, 12, (n_lists, L))]
        codes[1] = codes[0]
        codes = np.broadcast_to(codes, (n_dev, n_lists, L, S)).reshape(-1, S)
    else:
        codes = rng.integers(0, Kb, (n_dev * n_lists * L, S)).astype(np.uint8)
    packed = tpq.pack_bits(torch.tensor(np.ascontiguousarray(codes)),
                           pq_bits).numpy().reshape(n_dev, n_lists, L, -1)
    ids = rng.permutation(n_dev * n_lists * L).astype(np.int32).reshape(
        n_dev, n_lists, L)
    ids[rng.random(ids.shape) < 0.1] = -1
    ids[:, 3, 120:] = -1
    ids[:, 4] = -1
    valid = ids >= 0
    sizes = np.where(valid.any(2), L - np.argmax(valid[..., ::-1], axis=2),
                     0).astype(np.int32)
    if ties:
        norms = rng.integers(10, 60, (n_lists, L)).astype(np.float32)
        norms[1] = norms[0]
        norms = np.ascontiguousarray(np.broadcast_to(norms, (n_dev, n_lists, L)))
        centers_rot = rng.integers(-3, 4, (n_lists, rot)).astype(np.float32)
        centers_rot[1] = centers_rot[0]
        cb = rng.integers(-2, 3, (S, Kb, P)).astype(np.float32)
    else:
        norms = rng.uniform(10, 60, (n_dev, n_lists, L)).astype(np.float32)
        centers_rot = rng.standard_normal((n_lists, rot)).astype(
            np.float32) * 4
        cb = rng.standard_normal((S, Kb, P)).astype(np.float32)
    q = np.zeros((n_dev * mc, rot), np.float32)
    q[:m] = (rng.integers(-3, 4, (m, rot)).astype(np.float32) if ties else
             rng.standard_normal((m, rot)).astype(np.float32) * 4)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(n_dev * mc)]).astype(np.int32)
    lists, ind = _chunk_unions(torch.tensor(probes).view(n_dev, mc, n_probes),
                               NS)
    return dict(lists=lists.numpy(), ind=ind.numpy(),
                qv=q.reshape(n_dev, mc, rot), packed=packed, ids=ids,
                norms=norms, list_sizes=sizes, centers_rot=centers_rot,
                cb=cb, S=S, L=L,
                pq_bits=pq_bits, mc=mc, NS=NS, n_dev=n_dev)


def ring_scan_ops(c, devices):
    """The per-rank operand lists of :func:`ring_scan_case` for
    ``kernels.ring_lut_scan_merge``, rank r on ``devices[r]``."""
    rep = ("lists", "ind", "qv")
    out = [[torch.tensor(c[name]).to(d) for d in devices] for name in rep]
    out += [[torch.tensor(c[name][r]).to(d) for r, d in enumerate(devices)]
            for name in ("packed", "ids", "norms", "list_sizes")]
    out += [[torch.tensor(c[name]).to(d) for d in devices]
            for name in ("centers_rot", "cb")]
    return out


def ring_scan_key64(c, cb_used: np.ndarray, metric: str, chunk: int,
                    row: int, gid: int) -> float:
    """f64 LUT-scan key of global id ``gid`` for row ``row`` of chunk
    ``chunk``."""
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    r, lst, pos = (int(a[0]) for a in np.nonzero(c["ids"] == gid))
    S, P = c["S"], cb_used.shape[2]
    code = tpq.unpack_bits(torch.tensor(c["packed"][r, lst, pos]), S,
                           c["pq_bits"]).numpy().astype(np.int64)
    qv = c["qv"][chunk, row].astype(np.float64)
    lut = np.einsum("sp,skp->sk", qv.reshape(S, P),
                    cb_used.astype(np.float64))
    dot = qv @ c["centers_rot"][lst].astype(np.float64) + lut[
        np.arange(S), code].sum()
    return -dot if metric == "ip" else c["norms"][r, lst, pos] - 2.0 * dot


# ---------------------------------------------------------------------------
# the sharded tier: JAX meshes and a ShardedIvfPq crossing as numpy
# ---------------------------------------------------------------------------

SHARDED_FIELDS = ("centers", "centers_rot", "rotation", "codebooks",
                  "packed_codes", "packed_ids", "packed_norms", "list_sizes")


def jax_mesh(n: int):
    """A 1-D JAX mesh over the first n of the test run's CPU devices."""
    import jax
    from raft_tpu.parallel import make_mesh

    return make_mesh(shape=(n,), axis_names=("shard",),
                     devices=jax.devices()[:n])


def jax_sharded_pq_arrays(index):
    """A raft_tpu ``ShardedIvfPq`` → (arrays, meta) for
    ``parallel.ivf.from_numpy``."""
    arrays = {name: np.asarray(getattr(index, name))
              for name in SHARDED_FIELDS}
    meta = {"metric": index.metric, "pq_bits": index.pq_bits,
            "pq_dim": index.pq_dim, "shard_rows": index.shard_rows,
            "global_list_cap": index.global_list_cap}
    return arrays, meta


def jax_sharded_pq_from_arrays(arrays, meta, mesh):
    """(arrays, meta) → a raft_tpu ``ShardedIvfPq`` placed on ``mesh``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from raft_tpu.parallel import ShardedIvfPq

    def put(name):
        a = jnp.asarray(arrays[name])
        if name.startswith("packed") or name == "list_sizes":
            spec = P("shard", *([None] * (a.ndim - 1)))
            return jax.device_put(a, NamedSharding(mesh, spec))
        return a

    return ShardedIvfPq(**{name: put(name) for name in SHARDED_FIELDS},
                        metric=meta["metric"], pq_bits=int(meta["pq_bits"]),
                        pq_dim=int(meta["pq_dim"]),
                        shard_rows=int(meta["shard_rows"]),
                        global_list_cap=int(meta["global_list_cap"]))


def assert_ids_match_away_from_ties(ia, va, ib, vb, rtol: float = 1e-4,
                                    atol: float = 1e-4):
    """Two [m, k] (ids, values) results, values sorted: values within
    tolerance everywhere they are finite; ids equal except where the
    value ties its neighbour (or is the k-th) within that tolerance."""
    ia, va, ib, vb = (np.asarray(a) for a in (ia, va, ib, vb))
    assert ia.shape == ib.shape
    fin = np.isfinite(vb)
    assert (np.isfinite(va) == fin).all()
    np.testing.assert_allclose(va[fin], vb[fin], rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(np.where(fin, vb, 0.0))
    gap = np.abs(np.diff(np.where(fin, vb, 0.0), axis=1)) <= tol[:, 1:]
    tie = np.zeros_like(fin)
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    tie[:, -1] = True
    assert ((ia == ib) | tie).all(), np.argwhere((ia != ib) & ~tie)[:5]


def assert_filtered_match(ti, td, ji, jd, keep, rtol: float = 1e-4,
                          atol: float = 1e-4):
    """A filtered search's (ids, distances) against the JAX package's:
    distances within tolerance (+inf where fewer than k rows survive), ids
    equal away from distance ties, no id with its bit clear in ``keep``,
    and −1 wherever the distance is infinite (there the JAX per_query tier
    returns the picked slot's own id)."""
    ti, td = np.asarray(ti), np.asarray(td)
    assert_ids_match_away_from_ties(ti, td, np.asarray(ji), np.asarray(jd),
                                    rtol=rtol, atol=atol)
    assert keep[ti[ti >= 0]].all()
    assert (ti[~np.isfinite(td)] == -1).all()


CAGRA_FIELDS = ("dataset", "graph", "centers", "entry_ids", "dataset_q",
                "q_scale", "q_zero")


def jax_cagra_arrays(index):
    """A raft_tpu ``CagraIndex`` → (arrays, meta) for ``cagra.from_numpy``
    (absent optional fields left out)."""
    return ({name: np.asarray(getattr(index, name)) for name in CAGRA_FIELDS
             if getattr(index, name) is not None}, {"metric": index.metric})


def jax_cagra_from_arrays(arrays, meta):
    """(arrays, meta) → a raft_tpu ``CagraIndex``."""
    import jax.numpy as jnp
    from raft_tpu.neighbors import cagra as jcg

    return jcg.CagraIndex(
        **{name: jnp.asarray(arrays[name]) for name in CAGRA_FIELDS
           if name in arrays}, metric=meta["metric"])


BALL_COVER_FIELDS = ("landmarks", "packed_data", "packed_ids", "radii",
                     "list_sizes")


def jax_ball_cover_arrays(index):
    """A raft_tpu ``BallCoverIndex`` → (arrays, meta) for
    ``ball_cover.from_numpy``."""
    return ({name: np.asarray(getattr(index, name))
             for name in BALL_COVER_FIELDS}, {"metric": index.metric})


def jax_ball_cover_from_arrays(arrays, meta):
    """(arrays, meta) → a raft_tpu ``BallCoverIndex``."""
    import jax.numpy as jnp
    from raft_tpu.neighbors import ball_cover as jbc

    return jbc.BallCoverIndex(
        **{name: jnp.asarray(arrays[name]) for name in BALL_COVER_FIELDS},
        metric=meta["metric"])


# ---------------------------------------------------------------------------
# CAGRA checks (JAX-free)
# ---------------------------------------------------------------------------

def f64_tied(d: np.ndarray, k: int, scale: float) -> bool:
    """Whether the k-th and (k+1)-th of the f64 distances ``d`` lie within
    the f32 error of the expanded form (norms up to ``scale``: a bound of
    its rounding over a few dozen terms)."""
    s = np.sort(d)
    return len(s) > k and s[k] - s[k - 1] <= 1e-6 * scale + 1e-4


def blocked_tie_free_rows(x, p, rows, T, k):
    """(row, its f64 top-k id set) for the sampled rows whose k-th
    candidate, and whose list's T-th neighbour list, are tie-free."""
    c = p["centers"].astype(np.float64)
    cd = ((c[:, None] - c[None]) ** 2).sum(-1)
    order = np.argsort(cd, axis=1, kind="stable")
    scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())
    out = []
    for r in rows:
        lst = p["row_list"][r]
        if f64_tied(cd[lst], T, scale):
            continue
        cand = p["pids"][order[lst, :T]].reshape(-1)
        cand = cand[(cand >= 0) & (cand != r)]
        d = ((x[cand].astype(np.float64) - x[r]) ** 2).sum(-1)
        if f64_tied(d, k, scale):
            continue
        out.append((r, set(cand[np.argsort(d, kind="stable")[:k]].tolist())))
    return out

