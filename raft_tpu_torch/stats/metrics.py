"""Model and clustering quality metrics (counterpart of
``raft_tpu.stats.metrics``; reference: stats/accuracy.cuh, r2_score.cuh,
regression_metrics.cuh, silhouette_score.cuh, trustworthiness_score.cuh,
adjusted_rand_index.cuh, rand_index.cuh, mutual_info_score.cuh,
entropy.cuh, homogeneity_score.cuh, completeness_score.cuh,
v_measure.cuh, kl_divergence.cuh, information_criterion.cuh,
dispersion.cuh, contingency_matrix.cuh, neighborhood_recall.cuh).

Plain torch on the device of the inputs, in float32 as in the JAX package
(the contingency-based scores too: nothing is widened to float64).
Where the JAX package's ``segment_sum`` drops a label outside
[0, n_classes) — a −1 noise label, say — so do these
(``linalg.segment_sum``).

``silhouette_score`` and ``trustworthiness_score`` build [n, n] distance
matrices in the JAX package. Both are row-wise before their final mean or
sum, so here they run in row tiles sized from the device's free memory
(``distance.pairwise._budget_elems``), with the same answer. The
trustworthiness penalties (integers) are summed exactly.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.distance.pairwise import _budget_elems, l2_expanded
from raft_tpu_torch.linalg.map_reduce import segment_sum
from raft_tpu_torch.utils import precision as _precision


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device (no host copy)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _rows_per_tile(n_cols: int, dev: torch.device) -> int:
    """Rows of an [rows, n_cols] tile: a quarter of the pairwise engine's
    element budget (a tile holds a few such arrays, some int64)."""
    return max(1, _budget_elems(dev) // (4 * max(1, n_cols)))


# ---------------------------------------------------------------------------
# regression / classification
# ---------------------------------------------------------------------------

def accuracy(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """reference: stats/accuracy.cuh."""
    return (pred == ref).float().mean()


def r2_score(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """reference: stats/r2_score.cuh."""
    ss_res = ((y - y_hat) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return 1.0 - ss_res / ss_tot.clamp_min(1e-30)


def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even-length
    input (``torch.median`` takes the lower one), NaN if any value is."""
    v = v.reshape(-1)
    n = v.numel()
    q = np.float32(0.5) * (np.float32(n) - np.float32(1.0))
    lo = int(min(max(np.floor(q), 0), n - 1))
    hi = int(min(max(np.ceil(q), 0), n - 1))
    s = torch.sort(v)[0]
    mid = (s[lo] + s[hi]) * 0.5
    return torch.where(torch.isnan(v).any(), float("nan"), mid)


def regression_metrics(pred: torch.Tensor, ref: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean_abs_error, mean_squared_error, median_abs_error)
    (reference: stats/regression_metrics.cuh)."""
    err = pred - ref
    return err.abs().mean(), (err * err).mean(), _median(err.abs())


# ---------------------------------------------------------------------------
# clustering comparison metrics (contingency-based)
# ---------------------------------------------------------------------------

def contingency_matrix(a: torch.Tensor, b: torch.Tensor, n_classes_a: int,
                       n_classes_b: int) -> torch.Tensor:
    """reference: stats/contingency_matrix.cuh. Counts as float32; a pair
    whose flat cell a·n_b + b falls outside the matrix is dropped, as the
    JAX package's ``segment_sum`` drops it."""
    idx = a.to(torch.int32) * n_classes_b + b.to(torch.int32)
    ones = torch.ones(idx.shape, dtype=torch.int32, device=idx.device)
    flat = segment_sum(ones, idx, n_classes_a * n_classes_b).float()
    return flat.reshape(n_classes_a, n_classes_b)


def _comb2(x):
    return x * (x - 1.0) / 2.0


def _pair_sums(a, b, n_classes):
    c = contingency_matrix(a, b, n_classes, n_classes)
    sum_comb = _comb2(c).sum()
    sum_a = _comb2(c.sum(1)).sum()
    sum_b = _comb2(c.sum(0)).sum()
    total = _comb2(_f32(a.shape[0], c))
    return sum_comb, sum_a, sum_b, total


def rand_index(a: torch.Tensor, b: torch.Tensor, n_classes: int
               ) -> torch.Tensor:
    """reference: stats/rand_index.cuh."""
    sum_comb, sum_a, sum_b, total = _pair_sums(a, b, n_classes)
    return (total + 2.0 * sum_comb - sum_a - sum_b) / total


def adjusted_rand_index(a: torch.Tensor, b: torch.Tensor, n_classes: int
                        ) -> torch.Tensor:
    """reference: stats/adjusted_rand_index.cuh. Both labelings a single
    class (or all singletons): 1 by convention, as sklearn."""
    sum_comb, sum_a, sum_b, total = _pair_sums(a, b, n_classes)
    expected = sum_a * sum_b / total.clamp_min(1e-30)
    max_index = 0.5 * (sum_a + sum_b)
    denom = max_index - expected
    return torch.where(denom.abs() < 1e-12, 1.0,
                       (sum_comb - expected) / denom.clamp_min(1e-30))


def entropy(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """reference: stats/entropy.cuh."""
    ones = torch.ones(labels.shape, dtype=torch.int32, device=labels.device)
    counts = segment_sum(ones, labels, n_classes).float()
    p = counts / counts.sum().clamp_min(1e-30)
    return -torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)), 0.0).sum()


def mutual_info_score(a: torch.Tensor, b: torch.Tensor, n_classes: int
                      ) -> torch.Tensor:
    """reference: stats/mutual_info_score.cuh."""
    c = contingency_matrix(a, b, n_classes, n_classes)
    pij = c / c.sum().clamp_min(1e-30)
    pi = pij.sum(1, keepdim=True)
    pj = pij.sum(0, keepdim=True)
    ratio = pij / (pi * pj).clamp_min(1e-30)
    return torch.where(pij > 0, pij * torch.log(ratio.clamp_min(1e-30)),
                       0.0).sum()


def homogeneity_score(truth: torch.Tensor, pred: torch.Tensor,
                      n_classes: int) -> torch.Tensor:
    """reference: stats/homogeneity_score.cuh."""
    h_c = entropy(truth, n_classes)
    mi = mutual_info_score(truth, pred, n_classes)
    return torch.where(h_c > 0, mi / h_c.clamp_min(1e-30), 1.0)


def completeness_score(truth: torch.Tensor, pred: torch.Tensor,
                       n_classes: int) -> torch.Tensor:
    """reference: stats/completeness_score.cuh."""
    return homogeneity_score(pred, truth, n_classes)


def v_measure(truth: torch.Tensor, pred: torch.Tensor, n_classes: int,
              beta: float = 1.0) -> torch.Tensor:
    """reference: stats/v_measure.cuh."""
    h = homogeneity_score(truth, pred, n_classes)
    c = completeness_score(truth, pred, n_classes)
    return (1 + beta) * h * c / (beta * h + c).clamp_min(1e-30)


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """reference: stats/kl_divergence.cuh."""
    safe = (p > 0) & (q > 0)
    return torch.where(safe, p * torch.log(p.clamp_min(1e-30)
                                           / q.clamp_min(1e-30)), 0.0).sum()


# ---------------------------------------------------------------------------
# cluster-quality metrics
# ---------------------------------------------------------------------------

def dispersion(x: torch.Tensor, centroids: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Global cluster dispersion (reference: stats/dispersion.cuh): sum of
    squared distances of cluster centers to the global mean, weighted by
    cluster size."""
    k = centroids.shape[0]
    ones = torch.ones(labels.shape, dtype=torch.int32, device=labels.device)
    counts = segment_sum(ones, labels, k).float()
    g_mean = x.mean(0)
    d2 = ((centroids - g_mean[None, :]) ** 2).sum(1)
    return (counts * d2).sum()


def silhouette_score(x: torch.Tensor, labels: torch.Tensor,
                     n_clusters: int) -> torch.Tensor:
    """Mean silhouette coefficient (reference: stats/silhouette_score.cuh),
    the JAX package's per-cluster mean-distance form: each row's summed
    distance to every cluster through one product with the labels'
    one-hot, [rows, n] distances a row tile at a time."""
    _precision.enforce()
    n, k = x.shape[0], n_clusters
    cls = torch.arange(k, dtype=torch.int64, device=x.device)
    own = labels.to(torch.int64)
    onehot = (own[:, None] == cls[None, :]).float()             # [n, k]
    counts = onehot.sum(0)                                       # [k]
    sums = torch.empty((n, k), dtype=torch.float32, device=x.device)
    step = _rows_per_tile(n, x.device)
    for a in range(0, n, step):
        d = torch.sqrt(l2_expanded(x[a:a + step], x, sqrt=False)
                       .clamp_min(0.0))
        sums[a:a + step] = d @ onehot
        del d
    own = torch.where(own < 0, own + k, own)  # jnp's index wrap
    own_count = counts[own]
    rows = torch.arange(n, device=x.device)
    # a: mean distance to own cluster (excluding self)
    a_ = torch.where(own_count > 1,
                     sums[rows, own] / (own_count - 1).clamp_min(1.0), 0.0)
    # b: min over other clusters of mean distance
    mean_to = sums / counts[None, :].clamp_min(1.0)
    mean_to[rows, own] = float("inf")
    mean_to = torch.where(counts[None, :] > 0, mean_to, float("inf"))
    b_ = mean_to.amin(1)
    s = torch.where(own_count > 1,
                    (b_ - a_) / torch.maximum(a_, b_).clamp_min(1e-30), 0.0)
    return s.mean()


def _stable_order(d: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort`` along rows: stable, equal keys by index."""
    return torch.sort(d, dim=1, stable=True)[1]


def trustworthiness_score(x: torch.Tensor, x_embedded: torch.Tensor,
                          n_neighbors: int) -> torch.Tensor:
    """Trustworthiness of an embedding (reference:
    stats/trustworthiness_score.cuh): penalizes embedded-space neighbors
    that are far in the original space. Each row's original-space ranks
    come from a stable sort of its distances (self last), as the JAX
    package's two ``argsort``s give them."""
    _precision.enforce()
    n, nn = x.shape[0], n_neighbors
    big = float(np.finfo(np.float32).max)
    pos = torch.arange(n, device=x.device)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    step = _rows_per_tile(n, x.device)
    for a in range(0, n, step):
        b = min(n, a + step)
        own = (torch.arange(b - a, device=x.device), pos[a:b])
        d = l2_expanded(x[a:b], x, sqrt=False)
        d[own] = big
        order = _stable_order(d)
        del d
        # the rank of each point j in row i's original-space ordering
        ranks = torch.empty_like(order)
        ranks.scatter_(1, order, pos.expand(b - a, n))
        del order
        e = l2_expanded(x_embedded[a:b], x_embedded, sqrt=False)
        e[own] = big
        knn = _stable_order(e)[:, :nn]
        del e
        r = torch.gather(ranks, 1, knn)  # original ranks of emb neighbors
        total += (r - nn + 1).clamp_min(0).sum()
        del ranks, knn, r
    scale = 2.0 / (n * nn * (2.0 * n - 3.0 * nn - 1.0))
    return 1.0 - _f32(scale, total) * total.float()


class InformationCriterion(enum.Enum):
    """reference: stats/information_criterion.cuh ``IC_Type``."""

    AIC = "aic"
    AICc = "aicc"
    BIC = "bic"


def information_criterion_batched(
        log_likelihood: torch.Tensor, n_params: int, n_samples: int,
        ic: InformationCriterion = InformationCriterion.AIC
) -> torch.Tensor:
    """reference: stats/information_criterion.cuh."""
    ll = log_likelihood
    k = _f32(n_params, ll)
    n = _f32(n_samples, ll)
    if ic == InformationCriterion.AIC:
        return -2.0 * ll + 2.0 * k
    if ic == InformationCriterion.AICc:
        return (-2.0 * ll + 2.0 * k
                + 2.0 * k * (k + 1) / (n - k - 1).clamp_min(1e-30))
    return -2.0 * ll + k * torch.log(n)


# ---------------------------------------------------------------------------
# ANN quality
# ---------------------------------------------------------------------------

def neighborhood_recall(got_indices: torch.Tensor, ref_indices: torch.Tensor,
                        got_distances: Optional[torch.Tensor] = None,
                        ref_distances: Optional[torch.Tensor] = None,
                        eps: float = 1e-3) -> torch.Tensor:
    """ANN recall@k (reference: stats/neighborhood_recall.cuh): fraction of
    reference neighbors found, counting distance-ties as hits when
    distances are provided."""
    match = got_indices[:, :, None] == ref_indices[:, None, :]
    hit = match.any(1)  # [m, k] per reference entry
    if got_distances is not None and ref_distances is not None:
        # a ref entry also counts if some returned distance ties it
        tie = ((got_distances[:, :, None] - ref_distances[:, None, :]).abs()
               <= eps).any(1)
        hit = hit | tie
    return hit.float().mean()
