"""raft_tpu_torch.stats — descriptive statistics and model/clustering
metrics (counterpart of ``raft_tpu.stats``, after the reference's
cpp/include/raft/stats)."""

from raft_tpu_torch.stats.descriptive import (  # noqa: F401
    cov,
    histogram,
    mean,
    mean_center,
    meanvar,
    minmax,
    stddev,
    sum_op,
    weighted_mean,
)
from raft_tpu_torch.stats.metrics import (  # noqa: F401
    InformationCriterion,
    accuracy,
    adjusted_rand_index,
    completeness_score,
    contingency_matrix,
    dispersion,
    entropy,
    homogeneity_score,
    information_criterion_batched,
    kl_divergence,
    mutual_info_score,
    neighborhood_recall,
    r2_score,
    rand_index,
    regression_metrics,
    silhouette_score,
    trustworthiness_score,
    v_measure,
)
