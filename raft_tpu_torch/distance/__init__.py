"""Distances: the metric taxonomy, pairwise distances, the fused and
masked L2 argmins, and the Gram kernels (counterpart of
``raft_tpu.distance``)."""

from raft_tpu_torch.distance.types import (  # noqa: F401
    DistanceType,
    SELECT_MIN,
    resolve_metric,
)
from raft_tpu_torch.distance.pairwise import (  # noqa: F401
    distance,
    pairwise_distance,
)
from raft_tpu_torch.distance.fused_l2_nn import (  # noqa: F401
    fused_l2_nn_argmin,
    masked_l2_nn_argmin,
)
from raft_tpu_torch.distance.kernels import (  # noqa: F401
    KernelParams,
    KernelType,
    gram_matrix,
)
