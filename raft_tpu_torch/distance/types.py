"""Distance metric taxonomy (reference: distance/distance_types.hpp:23-67).

A copy of ``raft_tpu.distance.types`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import enum


class DistanceType(enum.Enum):
    """All metrics of the reference (distance/distance_types.hpp:23-67)."""

    L2Expanded = "l2_expanded"
    L2SqrtExpanded = "l2_sqrt_expanded"
    L2Unexpanded = "l2_unexpanded"
    L2SqrtUnexpanded = "l2_sqrt_unexpanded"
    CosineExpanded = "cosine"
    L1 = "l1"
    InnerProduct = "inner_product"
    Linf = "linf"
    Canberra = "canberra"
    LpUnexpanded = "lp"
    CorrelationExpanded = "correlation"
    JaccardExpanded = "jaccard"
    HellingerExpanded = "hellinger"
    Haversine = "haversine"
    BrayCurtis = "braycurtis"
    JensenShannon = "jensenshannon"
    HammingUnexpanded = "hamming"
    KLDivergence = "kl_divergence"
    RusselRaoExpanded = "russelrao"
    DiceExpanded = "dice"
    Precomputed = "precomputed"


# Friendly-name aliases accepted by the Python API (mirrors pylibraft's
# DISTANCE_TYPES mapping, pylibraft/distance/pairwise_distance.pyx).
METRIC_ALIASES = {
    "euclidean": DistanceType.L2SqrtExpanded,
    "sqeuclidean": DistanceType.L2Expanded,
    "l2": DistanceType.L2SqrtExpanded,
    "l2_expanded": DistanceType.L2Expanded,
    "l2_sqrt_expanded": DistanceType.L2SqrtExpanded,
    "l2_unexpanded": DistanceType.L2Unexpanded,
    "l2_sqrt_unexpanded": DistanceType.L2SqrtUnexpanded,
    "cosine": DistanceType.CosineExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "linf": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "lp": DistanceType.LpUnexpanded,
    "minkowski": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "kldivergence": DistanceType.KLDivergence,
    "russelrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
    "precomputed": DistanceType.Precomputed,
}

#: Metrics where smaller is better (distances). InnerProduct is a similarity.
SELECT_MIN = {m: True for m in DistanceType}
SELECT_MIN[DistanceType.InnerProduct] = False


def resolve_metric(metric) -> DistanceType:
    if isinstance(metric, DistanceType):
        return metric
    key = str(metric).lower()
    if key in METRIC_ALIASES:
        return METRIC_ALIASES[key]
    raise ValueError(f"unknown metric {metric!r}")
