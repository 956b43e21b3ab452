"""Random Ball Cover — exact kNN and radius search for low-dimensional
true metrics, euclidean and haversine (counterpart of
``raft_tpu.neighbors.ball_cover``, after the reference's RBC,
neighbors/ball_cover-inl.cuh; Cayton's Random Ball Cover).

The JAX package's design:

- **build**: ~√n landmarks drawn by numpy from the seed, every row
  assigned to its nearest landmark (``pairwise_distance`` and argmin, the
  first landmark at a tie), the members packed into padded lists by a
  stable sort of the labels, each landmark's radius the largest member
  distance;
- **knn**: the lists ranked per query by distance to their landmark; rounds
  of ``round_lists`` lists each are gathered, scored and merged into the
  running top-k by ``select_k`` (the B3 kernel on the card for k ≤ 64);
  after each round one host read of the exact stop test — no query's k-th
  distance above the lower bound max(d − r, 0) of every unprobed list.

The queries run in tiles sized from the device's memory (a round gathers
[t, round_lists · max_list, d] rows), each with its own stop test: a tile
that stops early skips only rounds whose lists cannot enter its answer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import (resolve_device, to_device,
                                         work_block_bytes)
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import select_k_impl as _select_k

_SUPPORTED = {
    DistanceType.L2SqrtExpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.Haversine,
}
_ARRAY_FIELDS = ("landmarks", "packed_data", "packed_ids", "radii",
                 "list_sizes")


@dataclasses.dataclass
class BallCoverIndex:
    """Reference: ``BallCoverIndex`` (neighbors/ball_cover_types.hpp)."""

    landmarks: torch.Tensor     # [L, d] f32
    packed_data: torch.Tensor   # [L, max_list, d] f32 (0 pad)
    packed_ids: torch.Tensor    # [L, max_list] int32 (−1 pad)
    radii: torch.Tensor         # [L] f32 covering radius of each landmark
    list_sizes: torch.Tensor    # [L] int32
    metric: str = "euclidean"

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def dim(self) -> int:
        return self.landmarks.shape[1]

    @property
    def device(self) -> torch.device:
        return self.landmarks.device


def from_numpy(arrays: Dict[str, np.ndarray], meta: Dict, device="cuda"
               ) -> BallCoverIndex:
    """(arrays, meta) — the JAX package's ``BallCoverIndex`` fields as
    numpy arrays and ``{"metric": …}`` — → a ``BallCoverIndex`` on
    ``device``."""
    dev = resolve_device(device)
    return BallCoverIndex(**{name: to_device(arrays[name], dev)
                             for name in _ARRAY_FIELDS},
                          metric=meta["metric"])


def to_numpy(index: BallCoverIndex) -> Tuple[Dict[str, np.ndarray], Dict]:
    """A ``BallCoverIndex`` → (arrays, meta) for :func:`from_numpy` or the
    JAX package."""
    return ({name: getattr(index, name).cpu().numpy()
             for name in _ARRAY_FIELDS}, {"metric": index.metric})


def _index_device(index: BallCoverIndex, device) -> torch.device:
    dev = resolve_device(device)
    expects(index.device.type == dev.type,
            "the index lies on %s, not on %s", index.device, dev)
    return index.device


def _true_metric(metric) -> DistanceType:
    mt = resolve_metric(metric)
    if mt == DistanceType.L2Expanded:  # the plain "euclidean" family
        mt = DistanceType.L2SqrtExpanded
    return mt


@traced("raft_tpu_torch.ball_cover.build")
def build(dataset, metric: str = "euclidean",
          n_landmarks: Optional[int] = None, seed: int = 0,
          device="cuda") -> BallCoverIndex:
    """Build the ball cover (reference: ball_cover-inl.cuh:56
    ``rbc_build_index``) on ``device``: ``n_landmarks`` (default ⌊√n⌋)
    landmarks, ``np.random.default_rng(seed).choice(n, L, replace=False)``
    sorted."""
    mt = _true_metric(metric)
    expects(mt in _SUPPORTED,
            "ball_cover needs a true metric (euclidean/haversine)")
    dev = resolve_device(device)
    x = to_device(dataset, dev, torch.float32)
    n, d = x.shape
    L = min(n_landmarks or max(1, int(np.sqrt(n))), n)
    picks = np.sort(np.random.default_rng(seed).choice(n, size=L,
                                                       replace=False))
    landmarks = x[torch.from_numpy(picks).to(dev)]

    # nearest landmark of every row, in row blocks of the [n, L] distances
    labels = torch.empty(n, dtype=torch.int64, device=dev)
    dmin = torch.empty(n, dtype=torch.float32, device=dev)
    rb = max(1, work_block_bytes(dev) // (4 * L * 4))
    for a in range(0, n, rb):
        dist = pairwise_distance(x[a:a + rb], landmarks, metric=mt,
                                 device=dev)
        labels[a:a + rb] = torch.argmin(dist, dim=1)
        dmin[a:a + rb] = torch.gather(dist, 1, labels[a:a + rb, None])[:, 0]
        del dist

    # stable pack by label: a row's slot is its rank among its list's rows
    counts = torch.bincount(labels, minlength=L)
    max_list = max(1, int(counts.max()))
    lab_s, order = torch.sort(labels, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=dev) - starts[lab_s]
    packed = torch.zeros((L, max_list, d), dtype=torch.float32, device=dev)
    ids = torch.full((L, max_list), -1, dtype=torch.int32, device=dev)
    packed[lab_s, slot] = x[order]
    ids[lab_s, slot] = order.to(torch.int32)
    # each list's radius: the largest of its members' distances (0 pads;
    # the distances are ≥ 0, an empty list's radius 0)
    member_d = torch.zeros((L, max_list), dtype=torch.float32, device=dev)
    member_d[lab_s, slot] = dmin[order]
    radii = member_d.amax(1)
    del member_d
    return BallCoverIndex(
        landmarks=landmarks, packed_data=packed, packed_ids=ids, radii=radii,
        list_sizes=counts.to(torch.int32),
        metric="haversine" if mt == DistanceType.Haversine else "euclidean")


def _cand_dists(q: torch.Tensor, cand: torch.Tensor, mt: DistanceType
                ) -> torch.Tensor:
    """Distances between q [t, d] and each query's candidates [t, C, d]."""
    if mt == DistanceType.Haversine:
        lat1, lon1 = q[:, None, 0], q[:, None, 1]
        lat2, lon2 = cand[..., 0], cand[..., 1]
        sdlat = torch.sin((lat2 - lat1) * 0.5)
        sdlon = torch.sin((lon2 - lon1) * 0.5)
        h = sdlat * sdlat + torch.cos(lat1) * torch.cos(lat2) * sdlon * sdlon
        return 2.0 * torch.asin(torch.sqrt(h.clamp(0.0, 1.0)))
    diff = cand - q[:, None, :]
    return torch.sqrt((diff * diff).sum(-1).clamp_min(0.0))


def _probe_round(index: BallCoverIndex, q, probe, best_d, best_i, k: int,
                 mt: DistanceType):
    """Scan the lists ``probe`` [t, R] of each query and merge them into
    its running top-k (the carried best first, so ties keep it)."""
    t, R = probe.shape
    p = probe.long()
    cand = index.packed_data[p].reshape(t, -1, index.dim)
    cand_ids = index.packed_ids[p].reshape(t, -1)
    d = _cand_dists(q, cand, mt)
    d = torch.where(cand_ids >= 0, d, torch.full_like(d, float("inf")))
    return _select_k(torch.cat([best_d, d], 1), k, select_min=True,
                     input_indices=torch.cat([best_i, cand_ids], 1))


def _knn_tile(index, q, k, round_lists, mt, rounds):
    m, L = q.shape[0], index.n_landmarks
    d_ql = pairwise_distance(q, index.landmarks, metric=mt, device=q.device)
    d_sorted, order = torch.sort(d_ql, dim=1, stable=True)
    del d_ql
    lb = (d_sorted - index.radii[order]).clamp_min(0.0)
    # the least lower bound among the lists ranked j and later
    suffix_lb = torch.flip(torch.cummin(torch.flip(lb, [1]), 1)[0], [1])
    order = order.to(torch.int32)
    best_d = torch.full((m, k), float("inf"), device=q.device)
    best_i = torch.full((m, k), -1, dtype=torch.int32, device=q.device)
    probed = 0
    while probed < L:
        nxt = min(round_lists, L - probed)
        best_d, best_i = _probe_round(index, q, order[:, probed:probed + nxt],
                                      best_d, best_i, k, mt)
        probed += nxt
        rounds.append(probed)
        # the exact stop test: one host read a round
        if probed >= L or not bool((best_d[:, -1] > suffix_lb[:, probed])
                                   .any()):
            break
    return best_d, best_i


@traced("raft_tpu_torch.ball_cover.knn")
def knn(index: BallCoverIndex, queries, k: int, round_lists: int = 0,
        device="cuda", stats: Optional[Dict] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN by ball-cover pruning (reference: ball_cover-inl.cuh:266
    ``rbc_knn_query``) on ``device``, where the index lies → (distances
    [m, k], ids [m, k] int32). ``round_lists`` (0: ⌈√L⌉) lists a round.
    ``stats``, when given, receives ``"rounds"`` (each query tile's probe
    rounds) and ``"tile"`` (queries a tile)."""
    mt = _true_metric(index.metric)
    dev = _index_device(index, device)
    q = to_device(queries, dev, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be [m, %d]", index.dim)
    L = index.n_landmarks
    expects(k <= int(index.list_sizes.sum()), "k larger than index size")
    if round_lists <= 0:
        round_lists = max(1, int(np.ceil(np.sqrt(L))))
    round_lists = min(round_lists, L)
    m = q.shape[0]
    row_bytes = (round_lists * index.packed_data.shape[1]
                 * (index.dim + 4) * 4 + L * 16)
    t = max(1, min(m, work_block_bytes(dev) // row_bytes))
    tiles, rounds = [], []
    for a in range(0, m, t):
        r = []
        tiles.append(_knn_tile(index, q[a:a + t], k, round_lists, mt, r))
        rounds.append(len(r))
    if stats is not None:
        stats.update(rounds=rounds, tile=t)
    if len(tiles) == 1:
        return tiles[0]
    return (torch.cat([v for v, _ in tiles]), torch.cat([i for _, i in tiles]))


@traced("raft_tpu_torch.ball_cover.eps_nn")
def eps_nn(index: BallCoverIndex, queries, eps: float, device="cuda"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-radius neighbours (reference: ball_cover-inl.cuh:393) in the
    JAX package's packed form: (keep [m, L·max_list] bool, ids
    [L·max_list] int32), keep[i, j] when packed row j is a real row within
    ``eps`` of query i (``dists <= eps``; the landmark bound d − r > eps is
    implied by the exact distances, so there is no separate conjunct)."""
    mt = _true_metric(index.metric)
    dev = _index_device(index, device)
    q = to_device(queries, dev, torch.float32)
    L, Lsz, d = index.packed_data.shape
    rows = index.packed_data.reshape(L * Lsz, d)
    ids = index.packed_ids.reshape(-1)
    m = q.shape[0]
    keep = torch.empty((m, L * Lsz), dtype=torch.bool, device=dev)
    cb = max(1, work_block_bytes(dev) // (max(m, 1) * (d + 2) * 4))
    for a in range(0, L * Lsz, cb):
        blk = rows[a:a + cb]
        dists = _cand_dists(q, blk[None].expand(m, -1, -1), mt)
        keep[:, a:a + cb] = (ids[None, a:a + cb] >= 0) & (dists <= eps)
    return keep, ids
