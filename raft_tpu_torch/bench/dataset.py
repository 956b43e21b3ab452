"""Synthetic benchmark data.

- :class:`DeviceSynthetic`, clustered data made on the device (the shape
  of ``raft_tpu.bench.dataset.DeviceSyntheticChunks``): ``n_centers``
  centers uniform in [0, scale)^dim, each row a random center plus
  N(0, std²) noise. Same distribution as the JAX package's generator, not
  the same numbers (torch and JAX generators differ).
- :func:`make_synthetic_hard`, a numpy copy of the JAX package's
  generator of the same name: for a seed it gives the same arrays, bit for
  bit, so the two packages bench the same data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device


@dataclass
class Dataset:
    """A benchmark set: base rows, queries, optional ground truth."""

    name: str
    base: np.ndarray        # [n, d] f32
    queries: np.ndarray     # [m, d] f32
    groundtruth: Optional[np.ndarray] = None  # [m, k_gt] i32
    metric: str = "sqeuclidean"


def make_synthetic_hard(name: str, n: int, dim: int, n_queries: int,
                        metric: str = "sqeuclidean", seed: int = 0,
                        rows_per_cluster: int = 24,
                        sigma: float = 0.45) -> Dataset:
    """Many tiny clusters (``n / rows_per_cluster`` Gaussian balls), so a
    query's top-k crosses k-means cells and IVF recall bends with
    n_probes as real SIFT's does. ``sigma`` is each cluster's radius as a
    fraction of its nearest other center's distance, estimated in f64
    against a sample of 256 centers with self pairs masked by index.
    Queries come from the same distribution."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, n // rows_per_cluster)
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32)
    sel = rng.choice(n_centers, min(n_centers, 256), replace=False)
    sub = centers[sel].astype(np.float64)
    c64 = centers.astype(np.float64)
    d2 = (np.sum(c64**2, 1)[:, None] + np.sum(sub**2, 1)[None, :]
          - 2.0 * c64 @ sub.T)
    np.clip(d2, 0, None, out=d2)
    d2[np.arange(n_centers)[:, None] == sel[None, :]] = np.inf
    nearest = np.sqrt(d2.min(axis=1)).astype(np.float32)
    s = (sigma * nearest / np.sqrt(dim)).astype(np.float32)

    def sample(m, assign):
        return (centers[assign] + s[assign][:, None]
                * rng.standard_normal((m, dim)).astype(np.float32))

    assign = rng.integers(0, n_centers, n)
    base = sample(n, assign)
    q_assign = rng.integers(0, n_centers, n_queries)
    queries = sample(n_queries, q_assign)
    return Dataset(name=name, base=base, queries=queries, metric=metric)


class DeviceSynthetic:
    """Base rows and queries from one seed, generated on ``device`` in
    row chunks; queries come from their own generator stream."""

    def __init__(self, n: int, dim: int, n_centers: int = 10_000,
                 seed: int = 7, std: float = 0.5, scale: float = 10.0,
                 device="cuda", chunk_rows: int = 1 << 22):
        self.shape = (n, dim)
        self.device = resolve_device(device)
        self.seed = seed
        self.std = std
        self.chunk_rows = chunk_rows
        g = self._gen(0)
        self.centers = torch.rand((n_centers, dim), generator=g,
                                  device=self.device) * scale

    def _gen(self, stream: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + stream)
        return g

    def _sample(self, m: int, g: torch.Generator) -> torch.Tensor:
        n_c, dim = self.centers.shape
        assign = torch.randint(0, n_c, (m,), generator=g, device=self.device)
        noise = torch.randn((m, dim), generator=g, device=self.device)
        return self.centers[assign] + self.std * noise

    def base(self) -> torch.Tensor:
        """All n rows, [n, dim] f32 on the device."""
        n, dim = self.shape
        out = torch.empty((n, dim), dtype=torch.float32, device=self.device)
        g = self._gen(1)
        for a in range(0, n, self.chunk_rows):
            b = min(n, a + self.chunk_rows)
            out[a:b] = self._sample(b - a, g)
        return out

    def queries(self, m: int) -> torch.Tensor:
        return self._sample(m, self._gen(2))
