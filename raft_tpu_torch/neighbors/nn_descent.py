"""NN-Descent — an approximate kNN graph by iterated local joins
(counterpart of ``raft_tpu.neighbors.nn_descent``, after the reference's
``raft::neighbors::nn_descent``; CAGRA's third graph build).

The JAX package's fixed-shape iteration, draw for draw: a random initial
graph; then per sweep each row samples ``n_samples`` of its neighbours,
takes their neighbour lists and up to ``n_samples`` reverse neighbours
(rows whose sampled edges point at it, from a shuffled edge list) as
candidates, scores them and keeps its k best, dropping self-edges and
repeated ids. Every draw is ``jax.random``'s (``random.threefry``): the
graph equals the JAX package's bit for bit wherever the distances do (on
rows whose f32 sums are exact, in any order).

Within a sweep a row reads only the sweep's starting graph, so the rows
run in chunks sized from the device's memory, each writing into new
buffers; the reverse lists are the one global step (one stable sort of
n·S edges). Ties keep ``lax.top_k``'s order (``_ties``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.device import (resolve_device, to_device,
                                         work_block_bytes)
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.neighbors import _ties
from raft_tpu_torch.random import threefry as _tf
from raft_tpu_torch.utils import precision as _precision

def _chunk_rows(n: int, C: int, d: int, dev: torch.device) -> int:
    """Rows a chunk: its [r, C, d] gathered candidate rows (and the
    products, sorts and indices beside them, ~16 words a candidate) in one
    work block."""
    return max(1, min(n, work_block_bytes(dev) // max(1, C * (d + 16) * 4)))


def _dists_to(x: torch.Tensor, x_sq: torch.Tensor, rows: slice,
              ids: torch.Tensor, ip: bool) -> torch.Tensor:
    """Rows ``rows`` of x against their candidates ``ids`` [r, C] → keys
    [r, C] (lower is better): ‖u‖² + ‖v‖² − 2⟨u, v⟩ clamped at 0, or
    −⟨u, v⟩ for inner product."""
    i = ids.long()
    s = torch.bmm(x[i], x[rows, :, None])[..., 0]
    if ip:
        return -s
    return (x_sq[rows, None] + x_sq[i] - 2.0 * s).clamp_min(0.0)


def _merge(ids: torch.Tensor, dd: torch.Tensor, first_row: int, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of each row's candidates [r, C]: self-edges and every
    later copy of an id at +inf, then the k smallest keys, the lower
    position first among equal keys."""
    own = torch.arange(first_row, first_row + ids.shape[0],
                       device=ids.device)[:, None]
    drop = (ids == own) | _ties.first_occurrence(ids)
    dd = torch.where(drop, torch.full_like(dd, float("inf")), dd)
    pos = _ties.top_k_low(dd, k)
    return torch.gather(ids, 1, pos), torch.gather(dd, 1, pos)


def _reverse_lists(sampled: torch.Tensor, key, n_samples: int
                   ) -> torch.Tensor:
    """[n, S] reverse neighbours: the sampled edges (source row → target)
    shuffled by ``permutation(key, n·S)``, stably sorted by target, the
    first S sources of each target kept; empty slots hold the row itself
    (a self-edge, dropped by the merge)."""
    n = sampled.shape[0]
    dev = sampled.device
    shuf = _tf.permutation(key, n * n_samples, dev).long()
    targets = sampled.reshape(-1)[shuf]
    srcs = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        n_samples)[shuf]
    st, order = torch.sort(targets, stable=True)
    starts = torch.searchsorted(st, torch.arange(n, dtype=st.dtype,
                                                 device=dev))
    rank = torch.arange(n * n_samples, device=dev) - starts[st.long()]
    ok = rank < n_samples
    rev = torch.arange(n, dtype=torch.int32, device=dev)[:, None].repeat(
        1, n_samples)
    # (target, rank) pairs are unique, so the masked write is deterministic
    rev[st[ok].long(), rank[ok]] = srcs[order][ok]
    return rev


def _nn_descent(x: torch.Tensor, k: int, n_iters: int, n_samples: int,
                metric: str, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    ip = resolve_metric(metric) == DistanceType.InnerProduct
    n, d = x.shape
    dev = x.device
    x_sq = (x * x).sum(1)
    S = n_samples
    r = _chunk_rows(n, S * k + S + k, d, dev)
    k0, key = _tf.split(_tf.prng_key(seed))
    init = _tf.randint(k0, (n, k), 0, n, device=dev)
    ids = torch.empty((n, k), dtype=torch.int32, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    inf = torch.full((min(r, n), k), float("inf"), device=dev)
    for a in range(0, n, r):
        rows = slice(a, min(n, a + r))
        c = init[rows]
        ids[rows], dist[rows] = _merge(
            torch.cat([c, c], 1), torch.cat(
                [_dists_to(x, x_sq, rows, c, ip), inf[:c.shape[0]]], 1),
            a, k)
    del init, inf
    for it in range(n_iters):
        ki = _tf.fold_in(key, it)
        sample_pos = _tf.randint(ki, (n, S), 0, k, device=dev)
        sampled = torch.gather(ids, 1, sample_pos.long())
        rev = _reverse_lists(sampled, _tf.fold_in(ki, 1), S)
        new_ids = torch.empty_like(ids)
        new_dist = torch.empty_like(dist)
        for a in range(0, n, r):
            rows = slice(a, min(n, a + r))
            cand = torch.cat([ids[sampled[rows].long()].reshape(-1, S * k),
                              rev[rows]], 1)
            new_ids[rows], new_dist[rows] = _merge(
                torch.cat([ids[rows], cand], 1),
                torch.cat([dist[rows], _dists_to(x, x_sq, rows, cand, ip)],
                          1), a, k)
        ids, dist = new_ids, new_dist
        del sampled, rev, sample_pos
    return ids, dist


def _build(dataset, k, metric, n_iters, n_samples, seed, device):
    dev = resolve_device(device)
    _precision.enforce()
    x = to_device(dataset, dev, torch.float32)
    return _nn_descent(x, k, n_iters, n_samples, metric, seed)


@traced("raft_tpu_torch.nn_descent.build_knn_graph")
def build_knn_graph(dataset, k: int, metric: str = "sqeuclidean",
                    n_iters: int = 20, n_samples: int = 8, seed: int = 0,
                    device="cuda") -> torch.Tensor:
    """An approximate kNN graph [n, k] int32 (reference: nn_descent::build
    → index.graph())."""
    return _build(dataset, k, metric, n_iters, n_samples, seed, device)[0]


@traced("raft_tpu_torch.nn_descent.build_knn_graph_with_distances")
def build_knn_graph_with_distances(
        dataset, k: int, metric: str = "sqeuclidean", n_iters: int = 20,
        n_samples: int = 8, seed: int = 0, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """As :func:`build_knn_graph`, with the distances [n, k] f32."""
    return _build(dataset, k, metric, n_iters, n_samples, seed, device)
