"""Exact kNN (counterpart of ``raft_tpu.neighbors.brute_force.knn``) for
the expanded metrics: tiled ``torch.matmul`` distance blocks, a per-tile
``select_k`` and a running merge — the [m, n] matrix is never held. It
supplies the ground truth of the recall checks, filtered ones included
(``filter_bitset``)."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.distance.types import DistanceType, SELECT_MIN, resolve_metric
from raft_tpu_torch.matrix.select_k import select_k as _select_k
from raft_tpu_torch.utils import precision as _precision

# Bound on one [m, tile] f32 distance block (elements).
_TILE_BUDGET_ELEMS = 1 << 28
_EXPANDED = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
             DistanceType.CosineExpanded, DistanceType.InnerProduct)


def _expanded_block(q, db, q_sq, db_sq, mt):
    g = q @ db.T
    if mt == DistanceType.InnerProduct:
        return g
    if mt == DistanceType.CosineExpanded:
        nq = torch.sqrt(q_sq.clamp_min(1e-30))
        nd = torch.sqrt(db_sq.clamp_min(1e-30))
        return 1.0 - g / (nq[:, None] * nd[None, :])
    d2 = (q_sq[:, None] + db_sq[None, :] - 2.0 * g).clamp_min(0.0)
    return torch.sqrt(d2) if mt == DistanceType.L2SqrtExpanded else d2


def knn(dataset, queries, k: int, metric="euclidean", filter_bitset=None,
        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours → (distances [m, k], ids [m, k] i32).

    ``filter_bitset``: a packed bitset over the dataset's rows
    (``core.bitset``); a row whose bit is clear scores +inf (−inf for
    inner product) and is never returned, and where fewer than k rows
    survive the unfilled slots take id −1, as in the JAX package."""
    dev = resolve_device(device)
    _precision.enforce()
    mt = resolve_metric(metric)
    if mt not in _EXPANDED:
        raise NotImplementedError(f"brute-force {mt.value} is not ported to "
                                  "raft_tpu_torch yet (ROADMAP A17)")
    db = to_device(dataset, dev, torch.float32)
    q = to_device(queries, dev, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == db.shape[1],
            "query dim %d != index dim %d", q.shape[-1], db.shape[1])
    m, n = q.shape[0], db.shape[0]
    expects(k <= n, "k=%d > index size %d", k, n)
    select_min = SELECT_MIN[mt]
    q_sq = (q * q).sum(1)
    keep = (None if filter_bitset is None
            else _bitset.to_mask(_bitset.as_words(filter_bitset, dev), n))
    it = min(n, max(1 << 14, _TILE_BUDGET_ELEMS // max(m, 1)))
    best_v = best_i = None
    for a in range(0, n, it):
        blk = db[a:a + it]
        dists = _expanded_block(q, blk, q_sq, (blk * blk).sum(1), mt)
        if keep is not None:
            dists = torch.where(keep[None, a:a + it], dists, torch.full_like(
                dists, float("inf") if select_min else float("-inf")))
        tv, ti = _select_k(dists, min(k, blk.shape[0]), select_min=select_min)
        ti = ti + a
        if best_v is None:
            best_v, best_i = tv, ti
            continue
        best_v, best_i = _select_k(torch.cat([best_v, tv], 1), k,
                                   select_min=select_min,
                                   input_indices=torch.cat([best_i, ti], 1))
    if keep is not None:
        best_i = torch.where(torch.isinf(best_v), torch.full_like(best_i, -1),
                             best_i)
    return best_v, best_i
