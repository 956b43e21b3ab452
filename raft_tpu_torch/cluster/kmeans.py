"""K-means helpers the balanced and distributed trainers need
(counterpart of ``raft_tpu.cluster.kmeans``: ``KMeansParams``,
``init_random`` and ``_update_centroids``). The rest of ``kmeans`` (fit,
++ init, mini-batch) is not ported yet (ROADMAP A17)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from raft_tpu_torch.random.rng import RngState, choice


@dataclasses.dataclass
class KMeansParams:
    """reference: ``KMeansParams`` (cluster/kmeans_types.hpp); the JAX
    package's fields and defaults. ``cluster.distributed.fit`` reads
    n_clusters, max_iter, tol and seed."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: str = "k-means++"  # "k-means++" | "random" | "array"
    seed: int = 0
    n_init: int = 1
    oversampling_factor: float = 2.0


def init_random(state: RngState, x: torch.Tensor, n_clusters: int
                ) -> torch.Tensor:
    """``n_clusters`` distinct rows of x, chosen at random."""
    idx = choice(state, x.shape[0], n_clusters, x.device)
    return x[idx].float()


def _update_centroids(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      n_clusters: int, old_centroids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-cluster means and weights. The JAX package used a
    one-hot matmul (TPU scatters serialize); on the card ``index_add_``
    accumulates in f32 directly. Empty clusters keep their centroid."""
    lab = labels.long()
    sums = torch.zeros((n_clusters, x.shape[1]), dtype=torch.float32,
                       device=x.device)
    sums.index_add_(0, lab, x * w[:, None])
    counts = torch.zeros((n_clusters,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, lab, w)
    new_c = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1e-12)[:, None],
                        old_centroids)
    return new_c, counts
