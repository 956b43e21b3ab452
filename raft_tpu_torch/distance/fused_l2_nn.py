"""Fused L2 nearest neighbour (1-NN argmin) — k-means' inner loop.

Counterpart of ``raft_tpu.distance.fused_l2_nn``: distance and argmin
fused so the [m, n] matrix is never stored. Every call goes to the
hand-written kernel wrapper (``ops.kernels.fused_l2_argmin``), which runs
the CUDA kernel on CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.ops import kernels as _k


def fused_l2_nn_argmin(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of x, the (squared, unless ``sqrt``) L2 distance to
    and index of its nearest row of y → (min_dists [m] f32, argmins [m]
    int32; first index on ties)."""
    dist, idx = _k.fused_l2_argmin(x.float().contiguous(),
                                   y.float().contiguous())
    return (torch.sqrt(dist) if sqrt else dist), idx
