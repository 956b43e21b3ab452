"""CAGRA — graph-based ANN: kNN-graph build + greedy traversal search
(counterpart of ``raft_tpu.neighbors.cagra``, itself after the reference's
``raft::neighbors::cagra``, cagra.cuh:354; arXiv:2308.15136).

The JAX package's design, step for step:

- **build**: an intermediate kNN graph — by default the cluster-blocked
  exact self-kNN (:func:`cluster_knn_graph`: balanced k-means lists, each
  list's members scanned against the members of its nearest lists), or
  IVF-PQ self-search + exact refine (:func:`build_knn_graph`) — then
  :func:`optimize_graph`: rank-based detour pruning and reverse-edge
  augmentation; optionally int8 rows for traversal (:func:`_quantize_rows`);
- **search**: every query of a tile walks the graph in lockstep — pick
  ``search_width`` parents from the itopk buffer, gather their graph rows
  and those rows' vectors, one batched product, dedup against the buffer
  and within the candidates, merge back into the buffer — for at most
  ``max_iterations`` steps; a query whose whole buffer is visited is
  frozen, so stopping early and running on give the same ids.

Nothing here reaches a Pallas kernel in the JAX package, so it is ordinary
``torch``; on the default build path the balanced k-means runs the fused
L2 argmin kernel (B4). Selections keep ``lax.top_k``'s rule — among equal
keys the lower position first — through stable sorts: +inf entries
(duplicates, filtered rows, invalid parents) are mostly ties, and which of
them is marked visited or kept decides later steps. The blocked scan's
top-k is the exact ``torch.topk`` where the JAX package used the TPU's
``lax.approx_max_k`` (exact on the CPU as well, ties in any order).

The traversal loop reads "is every query settled" from the card every
``_CONVERGE_EVERY`` steps (one host sync each), not after every step as the
JAX ``while_loop`` does; frozen queries make the ids the same either way.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.device import (resolve_device, to_device,
                                         work_block_bytes)
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.neighbors import _ties
from raft_tpu_torch.neighbors import ivf_common as ic
from raft_tpu_torch.neighbors import nn_descent as _nn_descent
from raft_tpu_torch.neighbors import sample_filter as _sf
from raft_tpu_torch.random import threefry as _tf
from raft_tpu_torch.utils import precision as _precision

_SERIAL_VERSION = 3  # v3: + int8 scalar-quantized traversal rows
_ARRAY_FIELDS = ("dataset", "graph", "centers", "entry_ids", "dataset_q",
                 "q_scale", "q_zero")
# The traversal checks for a settled tile every this many steps.
_CONVERGE_EVERY = 4


@dataclasses.dataclass
class IndexParams:
    """reference: ``cagra::index_params`` (the JAX package's fields and
    defaults). ``build_algo``: "auto" → "cluster" (:func:`cluster_knn_graph`),
    "ivf_pq" (:func:`build_knn_graph`), "nn_descent"
    (``nn_descent.build_knn_graph`` over the build's rows,
    ``nn_descent_niter`` sweeps; no entries, so search seeds at random).
    ``build_projection_dim``: −1 auto (d > 256 projects onto a random
    orthonormal 128-d basis for the build's scans only), 0 off, or a dim.
    ``quantize_dataset``: keep int8 rows beside the f32 ones for
    ``traverse="int8"``."""

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    metric: str = "sqeuclidean"
    build_algo: str = "auto"  # | "cluster" | "ivf_pq" | "nn_descent"
    nn_descent_niter: int = 20
    knn_rows_per_list: int = 1024
    knn_neighborhood: int = 16
    build_projection_dim: int = -1  # -1 auto | 0 off | explicit dim
    quantize_dataset: bool = False
    seed: int = 0


@dataclasses.dataclass
class SearchParams:
    """reference: ``cagra::search_params`` (the JAX package's fields and
    defaults). ``num_seeds`` 0 → auto: max(itopk, 512) random pads beside
    the cluster entries, or max(2·itopk, min(2048, n/64)) random seeds
    without entries. ``max_iterations`` 0 → 2·⌈itopk / search_width⌉.
    ``traverse``: "auto" walks the int8 rows when the index has them, with
    an exact f32 re-rank of the final buffer. ``dedup``: "pairwise" (a [t,
    C, C] equality mask) or "sort"; both keep an id's first occurrence."""

    itopk_size: int = 64
    search_width: int = 4
    max_iterations: int = 0
    query_tile: int = 1024
    seed: int = 0
    num_seeds: int = 0
    entry_clusters: int = 4
    traverse: str = "auto"    # | "f32" | "int8"
    dedup: str = "pairwise"   # | "sort"


@dataclasses.dataclass
class CagraIndex:
    """reference: ``cagra::index``. ``centers`` [n_lists, dim] f32 and
    ``entry_ids`` [n_lists, E] (−1 pad) come with the cluster build: search
    seeds each query from its nearest lists' members. ``dataset_q`` [n,
    dim] int8 with ``q_scale``/``q_zero`` [dim] f32: x ≈ q_zero + q_scale ·
    code."""

    dataset: torch.Tensor
    graph: torch.Tensor
    metric: str = "sqeuclidean"
    centers: Optional[torch.Tensor] = None
    entry_ids: Optional[torch.Tensor] = None
    dataset_q: Optional[torch.Tensor] = None
    q_scale: Optional[torch.Tensor] = None
    q_zero: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.graph.device


def from_numpy(arrays: Dict[str, np.ndarray], meta: Dict, device="cuda"
               ) -> CagraIndex:
    """(arrays, meta) — the JAX package's ``CagraIndex`` fields as numpy
    arrays and ``{"metric": …}`` — → a ``CagraIndex`` on ``device``."""
    dev = resolve_device(device)
    return CagraIndex(
        **{name: to_device(arrays[name], dev) for name in _ARRAY_FIELDS
           if arrays.get(name) is not None}, metric=meta["metric"])


def to_numpy(index: CagraIndex) -> Tuple[Dict[str, np.ndarray], Dict]:
    """A ``CagraIndex`` → (arrays, meta) for :func:`from_numpy` or the JAX
    package; absent optional fields are left out."""
    arrays = {name: getattr(index, name).cpu().numpy()
              for name in _ARRAY_FIELDS if getattr(index, name) is not None}
    return arrays, {"metric": index.metric}


def _take(a: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, pos)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@traced("raft_tpu_torch.cagra.build_knn_graph")
def build_knn_graph(dataset, k: int, metric: str = "sqeuclidean",
                    seed: int = 0, search_batch: int = 16384,
                    device="cuda",
                    intermediates: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """k-NN graph [n, k] int32 by IVF-PQ self-search + exact refine
    (reference: cagra_build.cuh:89): ``ivf_pq.build`` with the JAX
    package's parameters, the rows searched in ``search_batch`` chunks for
    2·(k + 1) candidates, re-ranked exactly to k + 1, self hits dropped.
    ``intermediates``, when given, receives the IVF-PQ index's coarse
    centers (``"build_centers"``)."""
    from raft_tpu_torch.neighbors import ivf_pq as _ivf_pq
    from raft_tpu_torch.neighbors.refine import refine as _refine

    dev = resolve_device(device)
    _precision.enforce()
    x = to_device(dataset, dev, torch.float32)
    n, d = x.shape
    n_lists = max(8, min(1024, int(np.sqrt(n) / 2) or 8))
    pq_dim = max(8, min(d, -(-d // 2 // 8) * 8))
    idx = _ivf_pq.build(x, _ivf_pq.IndexParams(
        n_lists=n_lists, pq_dim=pq_dim, pq_bits=8, metric=metric,
        kmeans_trainset_fraction=min(1.0, 10.0 * n_lists / n + 0.1),
        seed=seed), device=dev)
    if intermediates is not None:
        intermediates["build_centers"] = idx.centers
    gpu_top_k = min(n, 2 * (k + 1))  # refine_rate 2
    sp = _ivf_pq.SearchParams(n_probes=max(2, n_lists // 8))
    b = min(search_batch, n)
    parts = []
    for start in range(0, n, b):
        q = x[start:start + b]
        _, cand = _ivf_pq.search(idx, q, gpu_top_k, sp, device=dev)
        parts.append(_refine(x, q, cand, k + 1, metric=metric,
                             device=dev)[1])
    del idx
    return _drop_self_edges(torch.cat(parts), n, k)


def _cluster_blocked_knn(packed, pids, centers, row_list, row_slot, k: int,
                         n_lists: int, T: int, chunk: int, ip: bool
                         ) -> torch.Tensor:
    """Exact kNN of every row against its cluster neighborhood (the JAX
    package's jitted program): each list's members against the members of
    its ``T`` nearest lists, ``chunk`` lists a block, the best ``k``
    candidates of each row by an exact top-k; rows return in row order
    through their (list, slot) addresses → [n, k]. Where a row's
    neighbourhood holds fewer than ``k`` other rows, its last slots are −1
    (the JAX package's ``approx_max_k`` fills them with pads or the row's
    own id, in any order)."""
    c_sq = (centers * centers).sum(1)
    cd = c_sq[:, None] + c_sq[None, :] - 2.0 * (centers @ centers.T)
    nbrs = _ties.top_k_low(cd, T)                                # [n_lists, T]
    L = packed.shape[1]
    res = torch.empty((n_lists, L, k), dtype=pids.dtype, device=pids.device)
    fill = float("-inf") if ip else float("inf")
    for a in range(0, n_lists, chunk):
        ls = torch.arange(a, min(n_lists, a + chunk), device=pids.device)
        C = ls.shape[0]
        mem = packed[ls].float()                            # [C, L, d]
        mids = pids[ls]                                     # [C, L]
        nb = nbrs[ls]                                       # [C, T]
        cand = packed[nb].float().reshape(C, T * L, -1)     # [C, T·L, d]
        cids = pids[nb].reshape(C, T * L)                   # [C, T·L]
        score = torch.bmm(mem, cand.transpose(1, 2))        # [C, L, T·L]
        if not ip:  # the squared distance, smallest first
            score.mul_(-2.0).add_((mem * mem).sum(-1)[:, :, None]).add_(
                (cand * cand).sum(-1)[:, None, :])
        del cand
        score.masked_fill_((cids[:, None, :] < 0)
                           | (cids[:, None, :] == mids[:, :, None]), fill)
        val, pos = torch.topk(score.view(C * L, T * L), k, dim=1,
                              largest=ip)
        del score
        ids = torch.gather(cids, 1, pos.view(C, L * k)).view(C, L, k)
        # a row with fewer than k candidates: its picks past them are
        # fills (its own slot, pads), which come out as −1
        res[a:a + C] = torch.where(val.view(C, L, k) == fill,
                                   torch.full_like(ids, -1), ids)
    return res[row_list.long(), row_slot.long()]


def _overflow_knn(x, packed, pids, rows, lists, k: int, ip: bool,
                  chunk: int) -> torch.Tensor:
    """Exact kNN of overflow rows against their own cluster's block: q [o,
    d] against packed[lists] [o, L, d] → ids [o, k] int32 (−1 past a short
    block's rows), ``chunk`` rows at a time."""
    out = []
    for a in range(0, rows.shape[0], chunk):
        rows_c = rows[a:a + chunk].long()
        lists_c = lists[a:a + chunk].long()
        q = x[rows_c].float()                               # [c, d]
        blk = packed[lists_c].float()                       # [c, L, d]
        bids = pids[lists_c]                                # [c, L]
        s = torch.bmm(blk, q[:, :, None])[..., 0]           # [c, L]
        # lower is better: −score; rank-equivalent l2 drops ‖q‖²
        key = -s if ip else (blk * blk).sum(-1) - 2.0 * s
        bad = (bids < 0) | (bids == rows_c[:, None])
        key = torch.where(bad, torch.full_like(key, float("inf")), key)
        pos = _ties.top_k_low(key, k)
        ids = torch.where(torch.isinf(_take(key, pos)),
                          torch.full_like(bids[:, :k], -1), _take(bids, pos))
        out.append(ids.to(torch.int32))
    return torch.cat(out)


def cluster_knn_graph(dataset, k: int, metric: str = "sqeuclidean",
                      seed: int = 0, rows_per_list: int = 1024,
                      neighborhood: int = 16, return_entries: bool = False,
                      centers_from=None, device="cuda",
                      stage_seconds: Optional[Dict[str, float]] = None,
                      intermediates: Optional[Dict[str, torch.Tensor]] = None):
    """k-NN graph [n, k] int32 by cluster-blocked exact self-kNN: balanced
    k-means into ~n / ``rows_per_list`` lists, each list's members scanned
    exactly against the members of its ``neighborhood`` nearest lists.
    Corpora of at most 2¹⁴ rows (or under four lists) take exact brute
    force. Rows that overflow their list's capacity are patched by a scan
    of their own cluster's block, with a warning. ``return_entries``: also
    the list centers (recomputed as per-list means of ``centers_from``'s
    rows when given: the full-space rows of a projected build) and each
    list's first 32 member ids. ``stage_seconds`` receives the seconds of
    kmeans_fit, kmeans_predict, pack, blocked_scan, overflow and entries
    (brute_force for a small corpus);
    ``intermediates`` the k-means centers in the scanned space
    (``"build_centers"``)."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
    from raft_tpu_torch.neighbors import brute_force as _bf

    dev = resolve_device(device)
    _precision.enforce()
    stage = ic.Stages(stage_seconds, dev, spans=())
    x = to_device(dataset, dev, torch.float32)
    n, d = x.shape
    ip = resolve_metric(metric) == DistanceType.InnerProduct
    if n <= (1 << 14) or n // rows_per_list < 4:
        with stage("brute_force"):
            _, knn_ids = _bf.knn_arrays(x, x, min(n, k + 1),
                                        metric="inner_product" if ip
                                        else "sqeuclidean", device=dev)
            g = _drop_self_edges(knn_ids, n, k)
        return (g, None, None) if return_entries else g

    n_lists = max(8, n // rows_per_list)
    km = KMeansBalancedParams(n_iters=10, metric="l2", seed=seed)
    n_train = min(n, max(n_lists * 4, n // 4))
    with stage("kmeans_fit"):
        if n_train < n:
            rng = np.random.default_rng(seed)
            pick = np.sort(rng.choice(n, n_train, replace=False))
            trainset = x[torch.from_numpy(pick).to(dev)]
        else:
            trainset = x
        centers = kmeans_balanced.fit(trainset, n_lists, km)
        del trainset
    with stage("kmeans_predict"):
        labels = kmeans_balanced.predict(centers, x, km)
    if intermediates is not None:
        intermediates["build_centers"] = centers
    with stage("pack"):
        counts = torch.bincount(labels.long(), minlength=n_lists).cpu().numpy()
        L = ic._fit_list_size(counts, max(1, n // n_lists), 4.0)
        (packed,), pids, _, n_over, (row_list, row_slot) = ic.pack_lists(
            [x], labels, _ids.make_ids(n, dev), n_lists=n_lists, L=L,
            fill_values=[0.0])
        overflow_rows = (torch.nonzero(row_slot >= L)[:, 0] if n_over
                         else None)
        row_slot = row_slot.clamp(0, L - 1)  # overflow rows borrow L − 1

    T = min(neighborhood, n_lists)
    kk = min(k, T * L - 1)
    with stage("blocked_scan"):
        # a block of lists: its [C, L, T·L] f32 distances, its [C, T·L, d]
        # candidate rows and its mask under the block bound
        per_list = L * T * L * 6 + T * L * d * 8
        chunk = max(1, min(n_lists, work_block_bytes(dev) // per_list))
        graph = _cluster_blocked_knn(packed, pids, centers, row_list,
                                     row_slot, kk, n_lists, T, chunk, ip)
    if n_over:
        # overflow rows never entered a packed list: the blocked scan
        # handed them slot L − 1's edges, and they receive no incoming
        # edges. Patch them with an exact scan of their own cluster block.
        with stage("overflow"):
            _log.warn("cluster_knn_graph: %d rows overflowed their list; "
                      "patching their graph rows via an in-cluster scan",
                      n_over)
            o_chunk = max(8, work_block_bytes(dev) // max(1, L * d * 12))
            ov = _overflow_knn(x, packed, pids, overflow_rows,
                               row_list[overflow_rows], min(kk, L - 1), ip,
                               o_chunk)
            if ov.shape[1] < kk:
                ov = torch.cat([ov, ov[:, -1:].expand(
                    -1, kk - ov.shape[1])], 1)
            graph[overflow_rows] = ov.to(graph.dtype)
    if kk < k:
        graph = torch.cat([graph, graph[:, -1:].expand(-1, k - kk)], 1)
    graph = graph.to(torch.int32)
    del packed
    if not return_entries:
        return graph
    with stage("entries"):
        if centers_from is not None:
            from raft_tpu_torch.cluster.kmeans import _update_centroids

            full = to_device(centers_from, dev, torch.float32)
            centers, _ = _update_centroids(
                full, torch.ones((n,), dtype=torch.float32, device=dev),
                labels, n_lists, torch.zeros((n_lists, full.shape[1]),
                                             dtype=torch.float32, device=dev))
        entries = pids[:, :min(32, L)].contiguous()
    return graph, centers, entries


def _drop_self_edges(knn_ids: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Stable-partition self hits out of a [n, ≥k+1] id table → [n, k]
    int32."""
    self_col = knn_ids == torch.arange(n, device=knn_ids.device,
                                       dtype=knn_ids.dtype)[:, None]
    order = torch.sort(self_col.to(torch.uint8), dim=1, stable=True)[1]
    return _take(knn_ids, order)[:, :k].to(torch.int32)


def _detour_counts(graph: torch.Tensor, sv: torch.Tensor, sp: torch.Tensor,
                   u_list: torch.Tensor) -> torch.Tensor:
    """For nodes with neighbour lists ``u_list`` [B, D]: how many earlier
    edges each edge i detours through. Edge i (to v = u_list[i]) detours
    through w_j = u_list[j], j < i, when v ranks below i in w_j's own
    list. The rank ``pos[j, i]`` (the first one, for repeated ids; D when
    absent) comes from w_j's row sorted once with its ranks (``sv``,
    ``sp``) and a binary search — the JAX package's [D, D, D] equality
    mask gives the same."""
    B, D = u_list.shape
    n = graph.shape[0]
    w = torch.where(u_list < 0, u_list + n, u_list).long()  # jnp wraps −1
    sv_w = sv[w]                                            # [B, D(j), D]
    vals = u_list[:, None, :].expand(B, D, D).contiguous()  # [B, D(j), D(i)]
    at = torch.searchsorted(sv_w, vals, out_int32=True).clamp_(max=D - 1)
    at = at.long()
    found = torch.gather(sv_w, 2, at) == vals
    del sv_w, vals
    pos = torch.where(found, torch.gather(sp[w], 2, at),
                      torch.full((), D, dtype=sp.dtype, device=sp.device))
    ranks = torch.arange(D, device=u_list.device)
    detour = (ranks[:, None] < ranks[None, :]) & (pos < ranks[None, None, :])
    return detour.sum(1)                                    # [B, D(i)]


def optimize_graph(knn_graph, out_degree: int, device="cuda") -> torch.Tensor:
    """Detourable-edge pruning + reverse-edge augmentation (reference:
    graph_core.cuh optimize; CAGRA paper §4.1) → [n, out_degree] int32.

    Edge u→v (rank i in u's list) is detourable through w (rank j < i) if v
    also appears in w's own list at a rank < i. Each node keeps its
    ``out_degree`` edges with the fewest detours (rank breaks ties); its
    best ``out_degree // 2`` forward edges are followed by up to that many
    reverse edges (incoming links of the pruned forward halves, sources in
    id order), the pruned list's next edges where it has fewer. Integer
    work only: equal to the JAX package bit for bit. A negative id in the
    forward half adds no reverse edge (the JAX package's scatter would
    wrap it to row n − 1)."""
    dev = resolve_device(device)
    g = to_device(knn_graph, dev)
    n, D = g.shape
    d_half = out_degree // 2
    sv, sp = torch.sort(g, dim=1, stable=True)
    sp = sp.to(torch.int16 if D < 2**15 else torch.int32)
    batch = max(1, work_block_bytes(dev) // (D * D * 40))
    counts = torch.cat([_detour_counts(g, sv, sp, g[a:a + batch])
                        for a in range(0, n, batch)])
    del sv, sp
    score = counts.to(torch.int32) * D + torch.arange(
        D, dtype=torch.int32, device=dev)[None, :]
    keep = torch.sort(score, dim=1)[1][:, :out_degree]
    pruned = _take(g, keep)                                 # [n, out_degree]

    fwd = pruned[:, :d_half]
    src = _ids.make_ids(n, dev).repeat_interleave(d_half)
    dst = fwd.reshape(-1)
    dst_s, order = torch.sort(dst, stable=True)
    src_s = src[order]
    first = torch.searchsorted(dst_s, _ids.make_ids(n, dev))
    slot = torch.arange(dst_s.shape[0], device=dev) - first[
        dst_s.long().clamp(0, n - 1)]
    ok = (slot < d_half) & (dst_s >= 0)
    rev = torch.full((n, d_half), -1, dtype=src.dtype, device=dev)
    rev[dst_s[ok].long(), slot[ok]] = src_s[ok]
    fallback = pruned[:, d_half:out_degree]
    merged = torch.where(rev >= 0, rev.to(fallback.dtype), fallback)
    return torch.cat([fwd, merged], 1).to(torch.int32)


def _quantize_rows(x: torch.Tensor):
    """Per-dimension affine int8 scalar quantization: x ≈ zero + scale ·
    code, codes in [−127, 127] (round half to even, as ``jnp.round``)."""
    mn = x.amin(0)
    mx = x.amax(0)
    zero = 0.5 * (mn + mx)
    scale = torch.clamp_min((mx - mn) / 254.0, 1e-12)
    codes = torch.clamp(torch.round((x - zero) / scale), -127, 127)
    return codes.to(torch.int8), scale.float(), zero.float()


def _build_projection(dim: int, proj_dim: int, seed: int, device
                     ) -> torch.Tensor:
    """The build's random orthonormal basis [dim, proj_dim]: the Q factor
    of ``jax.random.normal(PRNGKey(seed ^ 0x5EED), (dim, proj_dim))``
    (``random.threefry.normal``: within a few ulps of JAX's draws)."""
    g = _tf.normal(_tf.prng_key(seed ^ 0x5EED), (dim, proj_dim),
                   device=device)
    return torch.linalg.qr(g, mode="reduced")[0].contiguous()


@traced("raft_tpu_torch.cagra.build")
def build(dataset, params: Optional[IndexParams] = None, device="cuda",
          stage_seconds: Optional[Dict[str, float]] = None,
          intermediates: Optional[Dict[str, torch.Tensor]] = None
          ) -> CagraIndex:
    """Build (reference: cagra::build — kNN graph + optimize) on
    ``device``. ``stage_seconds``, when given, receives the seconds of
    projection, knn_graph (and, for the cluster algorithm, its kmeans_fit,
    kmeans_predict, pack, blocked_scan, overflow and entries), optimize and
    quantize. ``intermediates``, when given, receives the intermediate kNN
    graph (``"knn_graph"``), the rows its scans saw (``"build_rows"``:
    projected or not) and the k-means centers in that space
    (``"build_centers"``: the cluster algorithm's lists, or the ``ivf_pq``
    algorithm's coarse centers)."""
    if params is None:
        params = IndexParams()
    dev = resolve_device(device)
    _precision.enforce()
    mt = resolve_metric(params.metric)
    expects(mt in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                   DistanceType.InnerProduct),
            "cagra supports sqeuclidean/euclidean/inner_product")
    algo = "cluster" if params.build_algo == "auto" else params.build_algo
    expects(algo in ("cluster", "ivf_pq", "nn_descent"),
            "unknown build_algo %s",
            params.build_algo)
    stage = ic.Stages(stage_seconds, dev,
                      spans=("knn_graph", "optimize", "quantize"))
    x = to_device(dataset, dev, torch.float32)
    n, dim = x.shape
    inter_d = min(params.intermediate_graph_degree, n - 1)
    out_d = min(params.graph_degree, inter_d)
    centers = entry_ids = None
    proj_d = params.build_projection_dim
    if proj_d == -1:
        proj_d = 128 if dim > 256 else 0
    x_build = x
    if proj_d and proj_d < dim and mt != DistanceType.InnerProduct:
        # the build's scans only see projected rows: l2 ranks are about
        # kept, and the detour pruning reads ranks only
        with stage("projection"):
            x_build = x @ _build_projection(dim, proj_d, params.seed, dev)
    with stage("knn_graph"):
        if algo == "cluster":
            knn, centers, entry_ids = cluster_knn_graph(
                x_build, inter_d, metric=mt.value, seed=params.seed,
                rows_per_list=params.knn_rows_per_list,
                neighborhood=params.knn_neighborhood, return_entries=True,
                centers_from=x if x_build is not x else None, device=dev,
                stage_seconds=stage_seconds, intermediates=intermediates)
        elif algo == "nn_descent":
            knn = _nn_descent.build_knn_graph(
                x_build, inter_d, metric=mt.value,
                n_iters=params.nn_descent_niter, seed=params.seed,
                device=dev)
        else:
            knn = build_knn_graph(x, inter_d, metric=mt.value,
                                  seed=params.seed, device=dev,
                                  intermediates=intermediates)
    if intermediates is not None:
        intermediates["knn_graph"] = knn
        intermediates["build_rows"] = x if algo == "ivf_pq" else x_build
    del x_build
    with stage("optimize"):
        graph = optimize_graph(knn, out_d, device=dev)
    del knn
    codes = scale = zero = None
    if params.quantize_dataset:
        with stage("quantize"):
            codes, scale, zero = _quantize_rows(x)
    return CagraIndex(dataset=x, graph=graph, metric=mt.value,
                      centers=centers, entry_ids=entry_ids, dataset_q=codes,
                      q_scale=scale, q_zero=zero)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _dists_to(index: CagraIndex, q: torch.Tensor, ids: torch.Tensor,
              use_q: bool, ip: bool, block: int) -> torch.Tensor:
    """q [t, d], ids [t, C] → metric keys [t, C] (lower is better); int8
    rows are dequantized as the JAX package does. The l2 key is the
    difference form ‖q − x‖² (``torch.cdist`` without its matmul path),
    where the JAX package expands ‖q‖² + ‖x‖² − 2⟨q, x⟩: at d 960 the
    expanded form cancels terms ~70× the distance, which left the card's
    keys and the CPU's 1e-4 apart; the difference form keeps both within
    ~3e-7 of the f64 key, and is the faster on the card (2.5 ms against
    3.9 for [1000, 512] rows of 960). Queries go in row blocks whose
    gathered rows stay under ``block`` bytes."""
    t, C = ids.shape
    d = q.shape[1]
    r = max(1, block // max(1, C * d * 8))
    out = []
    for a in range(0, t, r):
        i = ids[a:a + r].long()
        qa = q[a:a + r]
        if use_q:
            rows = index.q_zero + index.dataset_q[i].float() * index.q_scale
        else:
            rows = index.dataset[i].float()                 # [r, C, d]
        if ip:
            out.append(-torch.bmm(rows, qa[:, :, None])[..., 0])
        else:
            out.append(torch.cdist(
                qa[:, None, :], rows,
                compute_mode="donot_use_mm_for_euclid_dist")[:, 0].square())
        del rows
    return torch.cat(out) if len(out) > 1 else out[0]


def _dup_pairwise(ids: torch.Tensor, block: int) -> torch.Tensor:
    """The same mask from the [t, C, C] equality of every pair, an id
    against the earlier positions of its row, in row blocks."""
    t, C = ids.shape
    r = max(1, block // max(1, C * C * 2))
    return torch.cat([(ids[a:a + r, :, None] == ids[a:a + r, None, :])
                      .tril_(-1).any(2) for a in range(0, t, r)])


@functools.lru_cache(maxsize=16)
def _seed_draws(seed: int, start: int, t: int, n_seed: int, n: int,
                device: torch.device) -> torch.Tensor:
    """The random seeds of queries ``start`` … ``start + t − 1``: each
    query's ``randint(fold_in(PRNGKey(seed), query index), (n_seed,), 0,
    n)``, [t, n_seed] int32. They depend on no query's values, so they are
    drawn once per shape and kept (16 shapes at most; a few MB each): a
    draw is ~900 small launches, which held a batch of 10 for ~30 ms on
    the card's host. The tensor is the cache's own: a caller that keeps
    it (rather than a tensor computed from it) takes a copy."""
    keys = _tf.fold_in_rows(_tf.prng_key(seed), torch.arange(
        start, start + t, dtype=torch.int64, device=device))
    return _tf.randint_rows(keys, n_seed, 0, n)


def _search_tile(index: CagraIndex, q: torch.Tensor, qstart: int, k: int,
                 itopk: int, width: int, max_it: int, seed: int,
                 num_seeds: int, use_q: bool, dedup: str, filter_bits,
                 entry_clusters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query tile's traversal (the JAX package's ``search_tile``)."""
    mt = resolve_metric(index.metric)
    ip = mt == DistanceType.InnerProduct
    dev = q.device
    n = index.size
    deg = index.graph_degree
    t = q.shape[0]
    idt = _ids.id_dtype(n)
    inf = float("inf")
    block = work_block_bytes(dev)

    def dists(ids, quantized=use_q):
        return _dists_to(index, q, ids, quantized, ip, block)

    # entry points: a per-QUERY function of (seed, global query index),
    # independent of the tiling
    if index.centers is not None:
        # the members of the query's nearest lists, padded with random draws
        cts = index.centers
        qc = q @ cts.T
        c_score = qc if ip else 2.0 * qc - (cts * cts).sum(1)[None, :]
        top_l = _ties.top_k_low(-c_score, min(entry_clusters, cts.shape[0]))
        ent = index.entry_ids[top_l.long()].reshape(t, -1)
        n_rand = max(num_seeds or max(itopk, 512), itopk)
        n_seed = -(-(ent.shape[1] + n_rand) // 128) * 128
        ent = torch.cat([ent, ent.new_full((t, n_seed - ent.shape[1]), -1)],
                        1)
        rnd = _seed_draws(seed, qstart, t, n_seed, n, dev)
        init_ids = torch.where(ent >= 0, ent.to(idt), rnd.to(idt))
    else:
        n_seed = max(num_seeds or max(2 * itopk, min(2048, n // 64)), itopk)
        n_seed = -(-n_seed // 128) * 128
        init_ids = _seed_draws(seed, qstart, t, n_seed, n, dev).to(
            idt, copy=True)
    # drawn with replacement: a repeated seed scores +inf
    dup0 = _ties.first_occurrence(init_ids)
    c = max(1, block // max(1, t * q.shape[1] * 8))
    seed_d = torch.cat([dists(init_ids[:, a:a + c])
                        for a in range(0, n_seed, c)], 1)
    seed_d = torch.where(dup0, inf, seed_d)
    best = _ties.top_k_low(seed_d, itopk)
    buf_i = _take(init_ids, best)
    buf_d = _take(seed_d, best)
    if filter_bits is not None:
        buf_d = torch.where(_sf.passes(filter_bits, buf_i), buf_d, inf)
    order = _ties.top_k_low(buf_d, itopk)
    buf_d, buf_i = _take(buf_d, order), _take(buf_i, order)
    buf_v = torch.zeros((t, itopk), dtype=torch.bool, device=dev)

    for it in range(max_it):
        if it and it % _CONVERGE_EVERY == 0 and bool(buf_v.all()):
            break  # every query settled: further steps change nothing
        # a settled query (whole buffer visited) is frozen
        frozen = buf_v.all(1, keepdim=True)
        # 1. the best unvisited entries are the parents
        cand = torch.where(buf_v, inf, buf_d)
        ppos = _ties.top_k_low(cand, width)
        parents = _take(buf_i, ppos)
        valid = (_take(cand, ppos) < inf).repeat_interleave(deg, 1)
        new_v = buf_v.scatter(1, ppos, True)
        # 2. their graph rows, 3. distances
        nbrs = index.graph[parents.long().clamp(0, n - 1)].reshape(t, -1)
        nbrs = torch.where(valid, nbrs, torch.zeros_like(nbrs))
        nd = dists(nbrs)
        drop = ~valid | (nbrs < 0)  # a −1 edge is no candidate
        if filter_bits is not None:
            drop |= ~_sf.passes(filter_bits, nbrs)
        # 4. dedup against the buffer and within the candidates
        drop |= (nbrs[:, :, None] == buf_i[:, None, :]).any(2)
        drop |= (_ties.first_occurrence(nbrs) if dedup == "sort"
                 else _dup_pairwise(nbrs, block))
        nd = torch.where(drop, inf, nd)
        # 5. merge into the buffer
        all_d = torch.cat([buf_d, nd], 1)
        all_i = torch.cat([buf_i, nbrs.to(idt)], 1)
        all_v = torch.cat([new_v, torch.zeros_like(drop)], 1)
        pos = _ties.top_k_low(all_d, itopk)
        buf_d = torch.where(frozen, buf_d, _take(all_d, pos))
        buf_i = torch.where(frozen, buf_i, _take(all_i, pos))
        buf_v = torch.where(frozen, buf_v, _take(all_v, pos))
    if use_q:
        # exact f32 re-rank of the final buffer
        exact = dists(buf_i.clamp(0, n - 1), quantized=False)
        exact = torch.where(torch.isinf(buf_d), inf, exact)
        pos = _ties.top_k_low(exact, k)
        buf_d, buf_i = _take(exact, pos), _take(buf_i, pos)
    out_d, out_i = buf_d[:, :k], buf_i[:, :k]
    if filter_bits is not None:
        # inf slots are filtered or unreached: id −1
        out_i = torch.where(torch.isinf(out_d), torch.full_like(out_i, -1),
                            out_i)
    if ip:
        out_d = -out_d
    elif mt == DistanceType.L2SqrtExpanded:
        out_d = torch.sqrt(out_d)
    return out_d, out_i


@traced("raft_tpu_torch.cagra.search")
def search(index: CagraIndex, queries, k: int,
           params: Optional[SearchParams] = None, filter_bitset=None,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference: cagra::search) → (distances [m, k], ids [m, k]
    in ``core.ids.id_dtype(n)``). ``filter_bitset``: a packed bitset over
    the dataset's rows (``core.bitset`` words, numpy uint32 or a tensor);
    a cleared row is never returned, and a slot left without a kept row
    holds −1 at +inf. Queries run in tiles of ``params.query_tile``; a
    query's seeds follow its global index, so the tiling changes no id."""
    if params is None:
        params = SearchParams()
    dev = resolve_device(device)
    _precision.enforce()
    expects(index.device.type == dev.type,
            "the index lives on %s, search asked for %s", index.device, dev)
    q = to_device(queries, index.device, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be [m, %d]", index.dim)
    expects(params.traverse in ("auto", "f32", "int8"),
            "traverse must be auto/f32/int8, not %s", params.traverse)
    expects(index.size <= _ids.INT32_MAX_ROWS,
            "cagra seeds are int32 draws: %d rows is past 2^31 - 1",
            index.size)
    use_q = (params.traverse == "int8"
             or (params.traverse == "auto" and index.dataset_q is not None))
    if use_q:
        expects(index.dataset_q is not None,
                "traverse='int8' needs an index with quantized rows")
    itopk = max(params.itopk_size, k)
    max_it = params.max_iterations or 2 * (-(-itopk // params.search_width))
    bits = (None if filter_bitset is None
            else _bitset.as_words(filter_bitset, index.device))
    tile = params.query_tile
    outs = [_search_tile(index, q[a:a + tile], a, k, itopk,
                         params.search_width, max_it, params.seed,
                         params.num_seeds, use_q, params.dedup, bits,
                         params.entry_clusters)
            for a in range(0, q.shape[0], tile)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


# ---------------------------------------------------------------------------
# serialization (reference: neighbors/cagra_serialize.cuh): the JAX
# package's file format, so files cross both ways
# ---------------------------------------------------------------------------

def save(index: CagraIndex, path: str, include_dataset: bool = True) -> None:
    arrays = {"graph": index.graph}
    if include_dataset:
        arrays["dataset"] = index.dataset
    if index.centers is not None:
        arrays["centers"] = index.centers
        arrays["entry_ids"] = index.entry_ids
    if index.dataset_q is not None:
        arrays["dataset_q"] = index.dataset_q
        arrays["q_scale"] = index.q_scale
        arrays["q_zero"] = index.q_zero
    ser.save_arrays(path, "cagra", _SERIAL_VERSION, {"metric": index.metric},
                    arrays)


def load(path: str, dataset=None, device="cuda") -> CagraIndex:
    """Load a version 1, 2 or 3 file (v1/v2 lack the entries resp. the
    int8 rows: search then seeds at random resp. walks f32 rows);
    ``dataset`` supplies the rows of a file saved without them."""
    version, meta, a = ser.load_arrays(path, "cagra")
    expects(version in (1, 2, _SERIAL_VERSION),
            "unsupported cagra version %d", version)
    dev = resolve_device(device)
    if "dataset" not in a:
        expects(dataset is not None, "%s holds no dataset: pass dataset=",
                path)
        a["dataset"] = dataset
    return CagraIndex(**{name: to_device(a[name], dev)
                         for name in _ARRAY_FIELDS if name in a},
                      metric=meta["metric"])


def serialize_to_hnswlib(index: CagraIndex, path: str,
                         ef_construction: int = 200) -> None:
    """Export the graph as an hnswlib-loadable index file (reference:
    cagra_serialize serialize_to_hnswlib — a level-0-only HNSW whose
    neighbour lists are the CAGRA graph), byte for byte the JAX package's.

    Layout of hnswlib's ``HierarchicalNSW::saveIndex`` (hnswalg.h): a
    header of size_t/int fields, then per element ``[link_count u16 + pad
    u16][maxM0 × u32 links][f32 data][u64 label]``, then a zero u32 per
    element (no upper levels). Loadable with ``hnswlib.Index(space,
    dim).load_index(path)``, space "l2" for (sq)euclidean, "ip" for
    inner_product."""
    expects(resolve_metric(index.metric) in
            (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
             DistanceType.InnerProduct),
            "hnswlib export supports l2/inner_product metrics, not %s",
            index.metric)
    data = np.ascontiguousarray(index.dataset.cpu().numpy(), np.float32)
    graph = index.graph.cpu().numpy().astype(np.int64)
    n, dim = data.shape
    degree = graph.shape[1]

    max_m0 = degree               # level-0 out-degree = graph degree
    m = max(1, degree // 2)
    data_size = dim * 4
    size_links0 = max_m0 * 4 + 4  # u32 count word + maxM0 u32 links
    size_per_elem = size_links0 + data_size + 8  # + u64 label
    offset_data = size_links0
    label_offset = size_links0 + data_size
    mult = 1.0 / np.log(max(m, 2))

    # hnswlib reads the first `count` links: valid ids go to the front
    # (a row may carry interior −1 entries)
    valid = graph >= 0
    counts = np.sum(valid, axis=1).astype(np.uint16)
    front = np.argsort(~valid, axis=1, kind="stable")
    links = np.take_along_axis(np.where(valid, graph, 0), front,
                               axis=1).astype(np.uint32)

    with open(path, "wb") as f:
        f.write(struct.pack("<QQQQQQiIQQQdQ", 0, n, n, size_per_elem,
                            label_offset, offset_data, 0, 0, m, max_m0, m,
                            float(mult), ef_construction))
        block = np.zeros((n, size_per_elem), np.uint8)
        block[:, 0:2] = counts[:, None].view(np.uint8).reshape(n, 2)
        block[:, 4:4 + max_m0 * 4] = links.view(np.uint8).reshape(n, -1)
        block[:, offset_data:offset_data + data_size] = data.view(
            np.uint8).reshape(n, -1)
        block[:, label_offset:] = np.arange(n, dtype=np.uint64).view(
            np.uint8).reshape(n, 8)
        f.write(block.tobytes())
        f.write(np.zeros(n, np.uint32).tobytes())
