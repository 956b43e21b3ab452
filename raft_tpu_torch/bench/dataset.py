"""Synthetic benchmark data.

- :class:`DeviceSynthetic`, clustered data made on the device (the shape
  of ``raft_tpu.bench.dataset.DeviceSyntheticChunks``): ``n_centers``
  centers uniform in [0, scale)^dim, each row a random center plus
  N(0, std²) noise. Same distribution as the JAX package's generator, not
  the same numbers (it draws from torch's generators).
- :class:`DeviceSyntheticChunks`, the JAX package's class of that name:
  the same centers and row assignments bit for bit from the same seed
  (``random.threefry`` is ``jax.random``'s generator), the rows within
  1e-6 (XLA's fused program and its own unfused ``jax.random.normal``
  already differ in the last bits of about 7% of the noise); a
  device-chunk provider (``provider[a:b]``, ``_block``) that
  ``refine.refine_provider`` regenerates candidate rows from.
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


class DeviceSyntheticChunks:
    """Deterministic clustered rows regenerated on ``device`` in fixed
    blocks of ``chunk_rows`` (counterpart of
    ``raft_tpu.bench.dataset.DeviceSyntheticChunks``): block ``bi`` is a
    pure function of (seed, bi), so every consumer slicing with any chunk
    size sees identical rows, and a billion-row base never has to exist
    anywhere. Duck-types the slices consumers take: ``shape``, ``dtype``,
    ``provider[a:b]`` (a tensor on ``device``), ``_block(bi)``,
    ``chunk_rows`` and :meth:`queries`."""

    def __init__(self, n: int, dim: int, n_centers: int = 10_000,
                 seed: int = 7, std: float = 0.5, scale: float = 10.0,
                 chunk_rows: int = 1 << 20, device="cuda"):
        from raft_tpu_torch.random import threefry as _tf

        self._tf = _tf
        self.device = resolve_device(device)
        self.shape = (n, dim)
        self.dtype = np.float32
        self.nbytes = n * dim * 4  # logical size (never materialized)
        self.chunk_rows = chunk_rows
        self._n_centers = n_centers
        self._std = std
        ckey, self._akey, self._qkey = _tf.split(_tf.prng_key(seed), 3)
        self.centers = (_tf.uniform(ckey, (n_centers, dim),
                                    device=self.device)
                        * float(np.float32(scale)))

    def _gen(self, key, start: int, m: int) -> torch.Tensor:
        tf = self._tf
        k1, k2 = tf.split(tf.fold_in(key, start))
        assign = tf.randint(k1, (m,), 0, self._n_centers, self.device)
        noise = tf.normal(k2, (m, self.shape[1]), self.device)
        return self.centers[assign.long()] + float(np.float32(self._std)) \
            * noise

    def _block(self, bi: int) -> torch.Tensor:
        """Generation block ``bi``: rows ``bi·chunk_rows`` onward, keyed by
        the block's first row."""
        a = bi * self.chunk_rows
        return self._gen(self._akey, a, min(self.chunk_rows,
                                            self.shape[0] - a))

    def __getitem__(self, sl) -> torch.Tensor:
        if not isinstance(sl, slice):
            raise TypeError("DeviceSyntheticChunks supports slice access "
                            "only")
        a = sl.start or 0
        b = min(sl.stop if sl.stop is not None else self.shape[0],
                self.shape[0])
        c = self.chunk_rows
        parts = []
        for bi in range(a // c, -(-b // c)):
            blk = self._block(bi)
            parts.append(blk[max(a - bi * c, 0):min(b - bi * c,
                                                    blk.shape[0])])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def queries(self, m: int) -> torch.Tensor:
        """Queries from their own key branch of the root split."""
        return self._gen(self._qkey, 0, m)
