"""Data generators (counterpart of ``raft_tpu.random.generators``, after
the reference's random/make_blobs.cuh, make_regression.cuh,
rmat_rectangular_generator.cuh, permute.cuh,
sample_without_replacement.cuh, multi_variable_gaussian.cuh).

Every draw is ``jax.random``'s (``random.threefry``) with the JAX
package's key splits and folds, so from one state the port makes the JAX
package's data: labels, edges and permutations bit for bit, floats within
the last bits of the logs. The generators take ``device=`` (default
``"cuda"``); the functions that take a tensor (:func:`permute`,
:func:`sample_without_replacement`) work on its device. Labels and edges
are int32, as in the JAX package.

``lax.top_k`` puts the lower index first among equal values; the Gumbel
top-k here is a stable descending sort, which does the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.random import threefry
from raft_tpu_torch.random.rng import RngState, _as_key, _float32
from raft_tpu_torch.utils import precision as _precision


def make_blobs(
    n_samples: int,
    n_features: int,
    n_clusters: int = 3,
    cluster_std: float = 1.0,
    center_box: Tuple[float, float] = (-10.0, 10.0),
    centers: Optional[torch.Tensor] = None,
    shuffle: bool = True,
    state=RngState(0),
    dtype=torch.float32,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clustered isotropic gaussians (reference: random/make_blobs.cuh).

    Returns (X [n_samples, n_features] f32, labels [n_samples] int32)."""
    _float32(dtype)
    dev = resolve_device(device)
    key = _as_key(state)
    k_centers, k_labels, k_noise, k_perm = threefry.split(key, 4)
    if centers is None:
        centers = threefry.uniform(k_centers, (n_clusters, n_features),
                                   center_box[0], center_box[1], dev)
    else:
        centers = to_device(centers, dev, torch.float32)
        n_clusters = centers.shape[0]
    labels = threefry.randint(k_labels, (n_samples,), 0, n_clusters, dev)
    x = threefry.normal(k_noise, (n_samples, n_features), dev)
    x.mul_(float(np.float32(cluster_std)))
    x.add_(centers[labels.long()])
    if shuffle:
        perm = threefry.permutation(k_perm, n_samples, dev).long()
        x, labels = x[perm], labels[perm]
    return x, labels


def make_regression(
    n_samples: int,
    n_features: int,
    n_informative: Optional[int] = None,
    n_targets: int = 1,
    bias: float = 0.0,
    noise: float = 0.0,
    state=RngState(0),
    dtype=torch.float32,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear-model regression data (reference: random/make_regression.cuh).

    Returns (X, y, coef)."""
    _float32(dtype)
    dev = resolve_device(device)
    _precision.enforce()
    if n_informative is None:
        n_informative = n_features
    kx, kw, kn = threefry.split(_as_key(state), 3)
    x = threefry.normal(kx, (n_samples, n_features), dev)
    w = torch.zeros((n_features, n_targets), dtype=torch.float32, device=dev)
    w[:n_informative] = 100.0 * threefry.uniform(
        kw, (n_informative, n_targets), device=dev)
    y = x @ w + bias
    if noise > 0:
        y = y + noise * threefry.normal(kn, tuple(y.shape), dev)
    return x, y, w


def rmat_rectangular(
    state,
    n_edges: int,
    r_scale: int,
    c_scale: int,
    theta: Tuple[float, float, float, float] = (0.57, 0.19, 0.19, 0.05),
    device="cuda",
) -> torch.Tensor:
    """RMAT graph edge generator (reference:
    random/rmat_rectangular_generator.cuh). Returns [n_edges, 2] int32
    (src, dst) with src < 2^r_scale, dst < 2^c_scale."""
    dev = resolve_device(device)
    key = _as_key(state)
    a, b, c, d = theta
    scale = max(r_scale, c_scale)
    f32 = np.float32
    # per-level quadrant draws: one uniform per (edge, level), then a
    # second per level for the column bit
    u = threefry.uniform(key, (n_edges, scale), device=dev)
    row_bit = u >= float(f32(a + b))
    del u
    u2 = threefry.uniform(threefry.fold_in(key, 1), (n_edges, scale),
                          device=dev)
    p_left = torch.where(row_bit, float(f32(c / (c + d))),
                         float(f32(a / (a + b))))
    col_bit = u2 >= p_left
    del u2, p_left
    levels = torch.arange(scale, dtype=torch.int32, device=dev)
    weight = torch.ones(scale, dtype=torch.int32, device=dev) << levels
    src = (row_bit.int() * torch.where(levels < r_scale, weight, 0)).sum(1)
    dst = (col_bit.int() * torch.where(levels < c_scale, weight, 0)).sum(1)
    return torch.stack([src, dst], dim=1).to(torch.int32)


def permute(x: torch.Tensor, state=RngState(0)) -> torch.Tensor:
    """Random row permutation (reference: random/permute.cuh)."""
    perm = threefry.permutation(_as_key(state), x.shape[0], x.device)
    return x[perm.long()]


def _top_k_ids(g: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(g, k)``'s indices (int32): the largest first, the lower
    index first among equal values."""
    return torch.sort(g, descending=True, stable=True)[1][:k].to(torch.int32)


def sample_without_replacement(
    state,
    items: torch.Tensor,
    n_samples: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted sampling without replacement via Gumbel top-k
    (reference: random/sample_without_replacement.cuh)."""
    n = items.shape[0]
    g = threefry.gumbel(_as_key(state), (n,), items.device)
    if weights is not None:
        g = g + torch.log(weights.clamp_min(1e-30))
    return items[_top_k_ids(g, n_samples).long()]


def multi_variable_gaussian(
    state,
    mean: torch.Tensor,
    cov: torch.Tensor,
    n_samples: int,
    method: str = "cholesky",
) -> torch.Tensor:
    """Samples from N(mean, cov) on the device of ``mean`` (reference:
    random/multi_variable_gaussian.cuh — Cholesky or eigen/"Jacobi"
    factorization of the covariance).

    ``method``: "cholesky" (cov must be positive definite; otherwise the
    samples are NaN, as the JAX package's factor is) or "eig" (tolerates
    positive semi-definite, matching the reference's Jacobi path).
    Returns [n_samples, dim]."""
    if method not in ("cholesky", "eig"):
        raise ValueError(f"unknown method {method!r} (cholesky | eig)")
    _precision.enforce()
    mean = mean.to(torch.float32)
    cov = cov.to(device=mean.device, dtype=torch.float32)
    dim = mean.shape[0]
    z = threefry.normal(_as_key(state), (n_samples, dim), mean.device)
    if method == "cholesky":
        chol, info = torch.linalg.cholesky_ex(cov)
        # jnp.linalg.cholesky gives NaNs where the factorization fails;
        # masked on the device, so no host sync
        chol = torch.where(info == 0, chol, float("nan"))
        return mean[None, :] + z @ chol.T
    w, v = torch.linalg.eigh(cov)
    scale = v * torch.sqrt(w.clamp_min(0.0))[None, :]
    return mean[None, :] + z @ scale.T


def subsample(
    state,
    n_rows: int,
    n_samples: int,
    device="cuda",
) -> torch.Tensor:
    """Uniform row-index subsample without replacement, sorted (int32;
    reference: random/subsample — used by IVF trainset selection)."""
    g = threefry.gumbel(_as_key(state), (n_rows,), resolve_device(device))
    return torch.sort(_top_k_ids(g, n_samples))[0]
