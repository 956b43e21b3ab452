"""Exact kNN (counterpart of ``raft_tpu.neighbors.brute_force``:
``BruteForceIndex``, ``build``, ``knn`` and ``knn_arrays``): distance
blocks over tiles of the base rows, a per-tile ``select_k`` and a running
merge — the [m, n] matrix is never held. The expanded metrics take a
``torch.matmul`` block against the index's cached squared norms; every
other metric the JAX package's general path, ``pairwise_distance`` of the
tile (``metric_arg`` its Lp exponent). Ties keep the lower base row, as
one select over the whole row does. It supplies the ground truth of the
recall checks, filtered ones included (``filter_bitset``).

``impl``: the JAX package's ``"auto"`` cuts each tile to the two best of
128 strided bins (``_two_best_per_bin``, a trade for the TPU's vector
unit, exact up to a bin collision); here ``"auto"`` and ``"sort"`` both
take the exact per-tile select (B3 on the card for k ≤ 64), so they
return the same results (ROADMAP, deliberate differences)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.distance.pairwise import pairwise_distance_impl
from raft_tpu_torch.distance.types import DistanceType, SELECT_MIN, resolve_metric
from raft_tpu_torch.matrix.select_k import select_k_impl as _select_k
from raft_tpu_torch.utils import precision as _precision

# Bound on one [m, tile] f32 distance block (elements).
_TILE_BUDGET_ELEMS = 1 << 28
_EXPANDED = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
             DistanceType.CosineExpanded, DistanceType.InnerProduct)
# the metrics whose search reads the base rows' squared norms
_NORMED = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
           DistanceType.CosineExpanded)
_IMPLS = ("auto", "sort")


@dataclasses.dataclass
class BruteForceIndex:
    """The dataset (f32, on the index's device) and its cached squared
    norms for the L2 and cosine metrics (reference:
    brute_force_types.hpp ``brute_force::index``)."""

    dataset: torch.Tensor               # [n, d] f32
    norms: Optional[torch.Tensor]       # [n] f32 (L2 / cosine only)
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dataset.device


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


@traced("raft_tpu_torch.brute_force.build")
def build(dataset, metric="euclidean", metric_arg: float = 2.0,
          device="cuda") -> BruteForceIndex:
    """Build a brute-force index (reference: brute_force::build): the rows
    as f32 on ``device``, with their squared norms cached for the
    expanded L2 and cosine metrics, so searches do not recompute them."""
    dev = resolve_device(device)
    mt = resolve_metric(metric)
    ds = to_device(dataset, dev, torch.float32)
    expects(ds.dim() == 2, "dataset must be [n, d]")
    norms = (ds * ds).sum(1) if mt in _NORMED else None
    return BruteForceIndex(dataset=ds, norms=norms, metric=mt,
                           metric_arg=float(metric_arg))


@traced("raft_tpu_torch.brute_force.knn")
def knn(index: BruteForceIndex, queries, k: int, filter_bitset=None,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours of ``queries`` in ``index`` (reference:
    brute_force::knn) → (distances [m, k], ids [m, k] i32), on the
    index's device.

    ``filter_bitset``: a packed bitset over the index's rows
    (``core.bitset``); a row whose bit is clear scores +inf (−inf for
    inner product) and is never returned, and where fewer than k rows
    survive the unfilled slots take id −1, as in the JAX package.
    ``impl`` ("auto" | "sort"): both take the exact per-tile select (the
    module's note)."""
    expects(impl in _IMPLS, "impl must be one of %s (got %r)", _IMPLS, impl)
    _precision.enforce()
    dev = index.device
    db = index.dataset
    q = to_device(queries, dev, torch.float32)
    expects(q.dim() == 2, "queries must be [m, d]")
    expects(q.shape[1] == index.dim, "query dim %d != index dim %d",
            q.shape[1], index.dim)
    m, n = q.shape[0], index.size
    expects(k <= n, "k=%d > index size %d", k, n)
    mt = index.metric
    select_min = SELECT_MIN[mt]
    q_sq = (q * q).sum(1)
    keep = (None if filter_bitset is None
            else _bitset.to_mask(_bitset.as_words(filter_bitset, dev), n))
    it = min(n, max(1 << 14, _TILE_BUDGET_ELEMS // max(m, 1)))
    best_v = best_i = None
    for a in range(0, n, it):
        blk = db[a:a + it]
        if mt in _EXPANDED:
            sq = (None if mt == DistanceType.InnerProduct
                  else index.norms[a:a + it] if index.norms is not None
                  else (blk * blk).sum(1))
            dists = _expanded_block(q, blk, q_sq, sq, mt)
        else:
            dists = pairwise_distance_impl(q, blk, mt, index.metric_arg)
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


def knn_arrays(dataset, queries, k: int, metric="euclidean",
               metric_arg: float = 2.0, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot :func:`build` and :func:`knn` (pylibraft's functional
    ``brute_force.knn``) → (distances [m, k], ids [m, k] i32)."""
    return knn(build(dataset, metric=metric, metric_arg=metric_arg,
                     device=device), queries, k)
