"""K-means — Lloyd iterations on the fused L2 argmin (counterpart of
``raft_tpu.cluster.kmeans``).

- assignment: every sweep, ``predict``, ``cluster_cost`` and the
  mini-batch steps go through ``distance.fused_l2_nn_argmin`` (B4, the
  ``fused_l2_argmin`` kernel, on the card);
- centroid update: weighted per-cluster sums with ``index_add_``
  (:func:`_update_centroids`);
- draws: ``fit`` and ``fit_minibatch`` draw as the JAX package draws —
  the key ``fold_in(PRNGKey(seed), 0)`` (``RngState.key``), k-means++'s
  Gumbel-max picks, ``random`` init's ``choice(replace=False)`` (the
  first rows of ``jax.random.permutation``) and the mini-batch rows'
  ``randint``, all from ``random.threefry`` — so ``fit(seed)`` picks the
  JAX package's seed rows. :func:`init_random` (a torch generator) is
  the draw of ``cluster.distributed.fit`` and the sharded builds, whose
  checks depend on it; it stays as it is.

The JAX package runs the Lloyd loop as one ``lax.while_loop``; here the
loop runs on the host and reads the ``tol`` test's scalar once a sweep:
that read is the one host sync a sweep. ``fit``'s best of ``n_init``
trials stays on the device, as in the JAX package (a NaN inertia never
wins over a finite one).

All fitting takes sample weights (zero weights mask rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.tracing import span, traced
from raft_tpu_torch.distance.fused_l2_nn import (
    fused_l2_nn_argmin_impl as _fused_l2_nn_argmin)
from raft_tpu_torch.distance.pairwise import l2_expanded
from raft_tpu_torch.random import threefry
from raft_tpu_torch.random.rng import RngState, choice
from raft_tpu_torch.utils import precision as _precision


@dataclasses.dataclass
class KMeansParams:
    """reference: ``KMeansParams`` (cluster/kmeans_types.hpp); the JAX
    package's fields and defaults. ``cluster.distributed.fit`` reads
    n_clusters, max_iter, tol and seed. ``oversampling_factor`` is
    accepted for parity (the ++ init is exact)."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: str = "k-means++"  # "k-means++" | "random" | "array"
    seed: int = 0
    n_init: int = 1
    oversampling_factor: float = 2.0


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init_plus_plus(key: threefry.Key, x: torch.Tensor, n_clusters: int,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means++ seeding (reference: cluster/kmeans.cuh:584
    ``init_plus_plus``): each next center is a row drawn with probability
    ∝ weight·D² by the Gumbel-max trick, with the JAX package's draws
    (``key`` a ``random.threefry`` key) → [n_clusters, d] f32 on x's
    device."""
    n, d = x.shape
    dev = x.device
    xf = x.float()
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else weights.float())
    k0, key = threefry.split(key)
    logw = torch.where(w > 0, torch.log(w.clamp_min(1e-30)),
                       torch.full_like(w, float("-inf")))
    first = torch.argmax(logw + threefry.gumbel(k0, (n,), dev))
    centers = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
    centers[0] = xf[first]
    x_sq = (xf * xf).sum(1)

    def dist2_to(c):
        return (x_sq + (c * c).sum() - 2.0 * (xf @ c)).clamp_min(0.0)

    min_d2 = dist2_to(xf[first])
    for i in range(1, n_clusters):
        wd = w * min_d2
        logits = torch.where(wd > 0, torch.log(wd.clamp_min(1e-30)),
                             torch.full_like(wd, float("-inf")))
        nxt = torch.argmax(logits + threefry.gumbel(
            threefry.fold_in(key, i), (n,), dev))
        c = xf[nxt]
        centers[i] = c
        min_d2 = torch.minimum(min_d2, dist2_to(c))
    return centers


def _init_random_threefry(key: threefry.Key, x: torch.Tensor,
                          n_clusters: int) -> torch.Tensor:
    """The JAX package's ``init_random``: the rows of
    ``jax.random.choice(key, n, (k,), replace=False)``, the first k of
    ``jax.random.permutation(key, n)``."""
    idx = threefry.permutation(key, x.shape[0], x.device)[:n_clusters]
    return x[idx.long()].float()


def init_random(state: RngState, x: torch.Tensor, n_clusters: int
                ) -> torch.Tensor:
    """``n_clusters`` distinct rows of x, chosen at random by a torch
    generator (the draw of ``cluster.distributed.fit``)."""
    idx = choice(state, x.shape[0], n_clusters, x.device)
    return x[idx].float()


# ---------------------------------------------------------------------------
# Lloyd core (weighted)
# ---------------------------------------------------------------------------

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


def _tol2(tol: float) -> float:
    """tol² in f32, as the JAX loop's condition squares its f32 ``tol``."""
    return float(np.float32(tol) * np.float32(tol))


def _lloyd(x: torch.Tensor, w: torch.Tensor, init_centroids: torch.Tensor,
           n_clusters: int, max_iter: int, tol: float):
    """Lloyd sweeps until ``max_iter`` or a squared centroid shift ≤ tol²
    → (centroids, inertia of the last sweep's assignment, n_iter). The
    loop runs on the host: the shift is read once a sweep (the one host
    sync of a sweep)."""
    xf = x.float()
    wf = w.float()
    c = init_centroids.float()
    inertia = torch.tensor(float("inf"), device=xf.device)
    tol2 = _tol2(tol)
    shift2 = float("inf")
    it = 0
    while it < max_iter and shift2 > tol2:
        d2, labels = _fused_l2_nn_argmin(xf, c)
        new_c, _ = _update_centroids(xf, wf, labels, n_clusters, c)
        shift = ((new_c - c) ** 2).sum()
        inertia = (wf * d2).sum()
        c = new_c
        it += 1
        shift2 = float(shift)
    return c, inertia, it


@traced("raft_tpu_torch.kmeans.fit")
def fit(params: KMeansParams, x, sample_weights=None, init_centroids=None,
        device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit k-means (reference: cluster/kmeans.cuh:88 ``fit``) →
    (centroids [k, d], inertia, n_iter), the last two 0-d tensors. Runs
    ``params.n_init`` trials, trial t seeded ``fold_in(key, t)``, and
    keeps the lowest inertia on the device."""
    dev = resolve_device(device)
    _precision.enforce()
    xf = to_device(x, dev, torch.float32)
    n, d = xf.shape
    k = params.n_clusters
    expects(k <= n, "n_clusters=%d > n_samples=%d", k, n)
    w = (torch.ones((n,), dtype=torch.float32, device=dev)
         if sample_weights is None
         else to_device(sample_weights, dev, torch.float32))
    key = RngState(params.seed).key()
    best = None
    for trial in range(max(params.n_init, 1)):
        kt = threefry.fold_in(key, trial)
        with span("init") as sp:
            if init_centroids is not None or params.init == "array":
                expects(init_centroids is not None,
                        "init='array' requires init_centroids")
                c0 = to_device(init_centroids, dev, torch.float32)
            elif params.init == "random":
                c0 = _init_random_threefry(kt, xf, k)
            else:
                c0 = init_plus_plus(kt, xf, k, w)
            sp.attach(c0)
        with span("lloyd") as sp:
            centroids, inertia, n_iter = _lloyd(xf, w, c0, k,
                                                params.max_iter, params.tol)
            sp.attach(centroids, inertia)
        n_iter = torch.tensor(n_iter, dtype=torch.int32, device=dev)
        if best is None:
            best = (centroids, inertia, n_iter)
        else:
            # on the device: a NaN inertia never beats a finite best, a
            # NaN best is always replaced
            better = (inertia < best[1]) | torch.isnan(best[1])
            best = tuple(torch.where(better, new, old)
                         for new, old in zip((centroids, inertia, n_iter),
                                             best))
    return best


def update_centroids(x: torch.Tensor, sample_weights: torch.Tensor,
                     centroids: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One centroid update for fixed labels (reference:
    kmeans::update_centroids, cluster/kmeans.cuh:385-411) →
    (weight_per_cluster [k], new_centroids [k, d]); empty clusters keep
    their centroid."""
    new_c, counts = _update_centroids(x.float(), sample_weights.float(),
                                      labels, centroids.shape[0],
                                      centroids.float())
    return counts, new_c


def _minibatch_loop(x: torch.Tensor, c0: torch.Tensor, key: threefry.Key,
                    n_clusters: int, batch_size: int, n_iters: int
                    ) -> torch.Tensor:
    """Mini-batch Lloyd (Sculley 2010): each iteration assigns one batch
    of ``randint`` rows (the JAX package's draw, ``fold_in(key, i)``) and
    moves each centroid toward the batch mean at the running rate
    batch count / total count."""
    n = x.shape[0]
    dev = x.device
    xf = x.float()
    c = c0.float()
    v = torch.zeros((n_clusters,), dtype=torch.float32, device=dev)
    ones = torch.ones((batch_size,), dtype=torch.float32, device=dev)
    for i in range(n_iters):
        rows = threefry.randint(threefry.fold_in(key, i), (batch_size,), 0,
                                n, dev)
        xb = xf[rows.long()]
        _, labels = _fused_l2_nn_argmin(xb, c)
        lab = labels.long()
        bcount = torch.zeros_like(v).index_add_(0, lab, ones)
        bsum = torch.zeros_like(c).index_add_(0, lab, xb)
        v = v + bcount
        lr = torch.where(v > 0, bcount / v.clamp_min(1.0),
                         torch.zeros_like(v))
        bmean = bsum / bcount.clamp_min(1.0)[:, None]
        c = c + lr[:, None] * (bmean - c)
    return c


@traced("raft_tpu_torch.kmeans.fit_minibatch")
def fit_minibatch(params: KMeansParams, x, batch_size: int = 1024,
                  n_iters: Optional[int] = None, init_centroids=None,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Mini-batch k-means (the mini-batch helpers around
    ``update_centroids``, cluster/kmeans.cuh:367-411) → (centroids [k, d],
    inertia over a final full pass, n_iters). The ++ init seeds on one
    sample of max(batch_size, 4k) rows, as in the JAX package."""
    dev = resolve_device(device)
    _precision.enforce()
    xf = to_device(x, dev, torch.float32)
    n, d = xf.shape
    k = params.n_clusters
    expects(k <= n, "n_clusters=%d > n_samples=%d", k, n)
    batch_size = min(batch_size, n)
    if n_iters is None:
        n_iters = max(20, min(params.max_iter, 10 * n // batch_size))
    key = RngState(params.seed).key()
    if init_centroids is not None or params.init == "array":
        expects(init_centroids is not None,
                "init='array' requires init_centroids")
        c0 = to_device(init_centroids, dev, torch.float32)
    elif params.init == "random":
        c0 = _init_random_threefry(key, xf, k)
    else:
        rows = threefry.randint(threefry.fold_in(key, n_iters + 1),
                                (min(n, max(batch_size, 4 * k)),), 0, n, dev)
        c0 = init_plus_plus(key, xf[rows.long()], k)
    centroids = _minibatch_loop(xf, c0, key, k, batch_size, n_iters)
    return centroids, cluster_cost(centroids, xf, device=dev), n_iters


@traced("raft_tpu_torch.kmeans.predict")
def predict(centroids, x, device="cuda") -> torch.Tensor:
    """Nearest-centroid labels [n] int32 (reference: kmeans.cuh:152)."""
    dev = resolve_device(device)
    _precision.enforce()
    _, labels = _fused_l2_nn_argmin(to_device(x, dev, torch.float32),
                                    to_device(centroids, dev, torch.float32))
    return labels


@traced("raft_tpu_torch.kmeans.fit_predict")
def fit_predict(params: KMeansParams, x, sample_weights=None, device="cuda"):
    """reference: kmeans.cuh:215 → (centroids, labels, inertia, n_iter)."""
    centroids, inertia, n_iter = fit(params, x, sample_weights,
                                     device=device)
    return centroids, predict(centroids, x, device=device), inertia, n_iter


@traced("raft_tpu_torch.kmeans.transform")
def transform(centroids, x, device="cuda") -> torch.Tensor:
    """L2 distances [n, k] of each row to every centroid (reference:
    kmeans.cuh:244)."""
    dev = resolve_device(device)
    _precision.enforce()
    return l2_expanded(to_device(x, dev, torch.float32),
                       to_device(centroids, dev, torch.float32), sqrt=True)


def cluster_cost(centroids, x, sample_weights=None, device="cuda"
                 ) -> torch.Tensor:
    """Total weighted inertia, a 0-d tensor (reference: kmeans.cuh:307)."""
    dev = resolve_device(device)
    _precision.enforce()
    d2, _ = _fused_l2_nn_argmin(to_device(x, dev, torch.float32),
                                to_device(centroids, dev, torch.float32))
    if sample_weights is not None:
        d2 = d2 * to_device(sample_weights, dev, torch.float32)
    return d2.sum()


def find_k(x, k_max: int = 20, params: Optional[KMeansParams] = None,
           device="cuda") -> Tuple[int, torch.Tensor]:
    """The k of the inertia elbow (reference:
    detail/kmeans_auto_find_k.cuh) → (best_k, inertias for k = 2 …
    k_max): the k after the largest change of the inertia's drop."""
    if params is None:
        params = KMeansParams(max_iter=50)
    dev = resolve_device(device)
    xf = to_device(x, dev, torch.float32)
    ks = list(range(2, k_max + 1))
    inertias = []
    for k in ks:
        _, inertia, _ = fit(dataclasses.replace(params, n_clusters=k), xf,
                            device=dev)
        inertias.append(float(inertia))
    arr = torch.tensor(inertias, dtype=torch.float32)
    if len(ks) < 3:
        return ks[int(torch.argmin(arr))], arr
    drops = -torch.diff(arr)
    curvature = drops[:-1] - drops[1:]
    return ks[int(torch.argmax(curvature)) + 1], arr
