"""Dense fixed-radius neighbourhood (ε-neighbourhood; counterpart of
``raft_tpu.neighbors.epsilon_neighborhood``, after the reference's
``eps_neighbors_l2sq``, neighbors/epsilon_neighborhood.cuh): the boolean
adjacency of all pairs within a squared-L2 radius, and each row's degree.

The squared distances are ``pairwise_distance``'s expanded form, computed
over column blocks of y, so that the f32 distances of one block, not of
the whole [m, n], are held at once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.distance.pairwise import pairwise_distance_impl

# f32 distances of one [m, block] column block: the CPU's 2^26 elements
# (256 MB), on the card a 32nd of the free memory (the expanded form's
# product, sum and clamp make about three of the block's size).
_BLOCK_ELEMS = 1 << 26


def _block_elems(dev: torch.device) -> int:
    if dev.type != "cuda":
        return _BLOCK_ELEMS
    free, _ = torch.cuda.mem_get_info(dev)
    return max(_BLOCK_ELEMS, free // 128)


@traced("raft_tpu_torch.eps_neighbors_l2sq")
def eps_neighbors_l2sq(x, y, eps_sq: float, device="cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """adj[i, j] = ‖x_i − y_j‖² < eps_sq, and vd[i] = deg(x_i) → (adj
    [m, n] bool, vd [m] int32), the reference's (adj, vd) pair."""
    dev = resolve_device(device)
    x = to_device(x, dev, torch.float32)
    y = to_device(y, dev, torch.float32)
    m, n = x.shape[0], y.shape[0]
    adj = torch.empty((m, n), dtype=torch.bool, device=dev)
    nb = max(1, _block_elems(dev) // max(m, 1))
    for a in range(0, n, nb):
        adj[:, a:a + nb] = pairwise_distance_impl(
            x, y[a:a + nb], "sqeuclidean") < eps_sq
    return adj, adj.sum(1, dtype=torch.int32)
