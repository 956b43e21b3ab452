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
    ``chunk_rows``, :meth:`queries` and :meth:`sample_rows`."""

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

    def sample_rows(self, idx: np.ndarray) -> torch.Tensor:
        """Rows ``idx`` (sorted), gathered by regenerating each block that
        holds one of them: the train-sample path of
        ``ivf_pq.build_chunked``."""
        idx = np.asarray(idx)
        c = self.chunk_rows
        out = []
        for bi, a in enumerate(range(0, self.shape[0], c)):
            b = min(a + c, self.shape[0])
            local = idx[(idx >= a) & (idx < b)] - a
            if len(local):
                out.append(self._block(bi)[torch.as_tensor(
                    local, device=self.device)])
        return torch.cat(out)


def compute_groundtruth(ds: Dataset, k: int = 100,
                        device_budget: int = 2 << 30,
                        chunk_rows: int = 1 << 18,
                        max_queries: int = 0,
                        device_base=None, device="cuda") -> Dataset:
    """Exact top-k ground truth of ``ds.queries`` into ``ds.groundtruth``
    ([m, k] int32), by the port's own ``brute_force.knn``.

    A base of at most ``device_budget`` bytes (or one already on the card,
    ``device_base``) is searched whole. A larger one (a memmap, a
    device-chunk provider) streams through the card in ``chunk_rows``
    blocks: each block's exact top-k by ``brute_force.knn``, merged into
    the running top-k by ``select_k`` (ties keep the earlier row, as one
    search over the whole base does). ``max_queries`` bounds the query
    count (recall on a subset is the usual practice at 10⁸ rows)."""
    from raft_tpu_torch.distance.types import SELECT_MIN, resolve_metric
    from raft_tpu_torch.matrix.select_k import select_k_impl as select_k
    from raft_tpu_torch.neighbors import brute_force

    dev = resolve_device(device)
    queries = ds.queries
    if max_queries and queries.shape[0] > max_queries:
        queries = queries[:max_queries]
    q = (queries.to(dev, torch.float32) if isinstance(queries, torch.Tensor)
         else torch.as_tensor(np.asarray(queries, np.float32), device=dev))
    n = ds.base.shape[0]
    if device_base is not None or ds.base.nbytes <= device_budget:
        base = ds.base if device_base is None else device_base
        if not isinstance(base, (np.ndarray, torch.Tensor)):
            base = base[0:n]  # a small provider: all its rows at once
        _, ids = brute_force.knn_arrays(base, q, k, metric=ds.metric,
                                         device=dev)
        ds.groundtruth = ids.cpu().numpy().astype(np.int32)
        return ds
    select_min = SELECT_MIN[resolve_metric(ds.metric)]
    best_v = best_i = None
    for a in range(0, n, chunk_rows):
        raw = ds.base[a:a + chunk_rows]
        if not isinstance(raw, torch.Tensor):
            raw = torch.as_tensor(np.asarray(raw, np.float32))
        v, i = brute_force.knn_arrays(raw, q, min(k, raw.shape[0]),
                                      metric=ds.metric, device=dev)
        i = i.long() + a
        if best_v is None:
            best_v, best_i = v, i
            continue
        best_v, best_i = select_k(torch.cat([best_v, v], 1), k,
                                  select_min=select_min,
                                  input_indices=torch.cat([best_i, i], 1))
    ds.groundtruth = best_i.cpu().numpy().astype(np.int32)
    return ds


def tie_swaps(q, x, ids_a, d_a, ids_b, d_b, rtol: float = 1e-4) -> int:
    """Two searches of one index for queries ``q`` over the rows ``x``
    (ids and squared-l2 distances [m, k], tensors on any device or numpy)
    agree but at ties: the same infinite slots, finite distances within
    ``rtol`` relative (at least ``rtol`` absolute), and every slot whose
    ids differ holds two ids at the same f64 distance from the query
    (within ``rtol``). Returns the count of such slots; raises
    ``ValueError`` naming the first disagreement. Only the rows the
    differing ids name are read from ``x``."""
    def host(t, dtype=None):
        t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        return t if dtype is None else t.astype(dtype)

    ia, ib = host(ids_a), host(ids_b)
    da, db = host(d_a, np.float64), host(d_b, np.float64)
    fin = np.isfinite(db)
    if not (np.isfinite(da) == fin).all():
        raise ValueError("the two searches differ in their +inf slots")
    rel = np.abs(da[fin] - db[fin]) / np.maximum(np.abs(db[fin]), 1.0)
    if rel.size and rel.max() > rtol:
        raise ValueError(f"distances differ by {rel.max():.3g} relative")
    r, c = np.nonzero(ia != ib)
    q64 = host(q, np.float64)[r]

    def f64_dist(ids):
        rows = (x[torch.from_numpy(ids).long().to(x.device)]
                if isinstance(x, torch.Tensor) else np.asarray(x)[ids])
        return ((q64 - host(rows, np.float64)) ** 2).sum(1)

    fa, fb = f64_dist(ia[r, c]), f64_dist(ib[r, c])
    bad = np.abs(fa - fb) > rtol * np.maximum(fb, 1.0)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(f"ids differ away from an f64 tie (query {r[i]}, "
                         f"slot {c[i]}: {ia[r[i], c[i]]} at {fa[i]:.6f} "
                         f"against {ib[r[i], c[i]]} at {fb[i]:.6f})")
    return int(r.size)
