"""Fused L2 nearest neighbour (1-NN argmin) — k-means' inner loop.

Counterpart of ``raft_tpu.distance.fused_l2_nn``: distance and argmin
fused so the [m, n] matrix is never stored. Every call goes to the
hand-written kernel wrapper (``ops.kernels.fused_l2_argmin``), which runs
the CUDA kernel on CUDA tensors and its plain version on CPU tensors.
:func:`fused_l2_nn_argmin` is the traced entry point; the port's own
modules call :func:`fused_l2_nn_argmin_impl` where the JAX package calls it
inside a jitted program (k-means' Lloyd loop, the sharded tier).

:func:`masked_l2_nn_argmin` (the reference's distance/masked_nn.cuh) is
ordinary XLA code in the JAX package, not a Pallas kernel, so here it is
plain torch: column tiles of y with a running (min, argmin), never the
whole [m, n] matrix.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.utils import precision as _precision

# Column-tile width of the masked argmin's running scan (the JAX
# package's).
_DEFAULT_TILE = 4096


@traced("raft_tpu_torch.fused_l2_nn_argmin")
def fused_l2_nn_argmin(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of x, the (squared, unless ``sqrt``) L2 distance to
    and index of its nearest row of y → (min_dists [m] f32, argmins [m]
    int32; first index on ties)."""
    return fused_l2_nn_argmin_impl(x, y, sqrt)


def fused_l2_nn_argmin_impl(x: torch.Tensor, y: torch.Tensor,
                            sqrt: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_l2_nn_argmin` without its span."""
    dist, idx = _k.fused_l2_argmin(x.float().contiguous(),
                                   y.float().contiguous())
    return (torch.sqrt(dist) if sqrt else dist), idx


def _dist_block(x, yb, x_sq, yb_sq, sqrt):
    d2 = (x_sq[:, None] + yb_sq[None, :] - 2.0 * (x @ yb.T)).clamp_min(0.0)
    return torch.sqrt(d2) if sqrt else d2


@traced("raft_tpu_torch.masked_l2_nn_argmin")
def masked_l2_nn_argmin(x, y, adj, group_idx=None, sqrt: bool = False,
                        tile: int = _DEFAULT_TILE, device="cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked L2 argmin (reference: distance/masked_nn.cuh): row i of x
    may match only the rows of y whose group ``adj`` [m, n_groups] admits;
    ``group_idx`` [n] maps each y row to its group (default: a group per
    row, adj [m, n]). Returns (min_dists [m] f32, argmins [m] int32): the
    first index at a tie, +inf and index 0 for a row that admits none."""
    dev = resolve_device(device)
    _precision.enforce()
    x = to_device(x, dev, torch.float32)
    y = to_device(y, dev, torch.float32)
    adj = to_device(adj, dev, torch.bool)
    m, n = x.shape[0], y.shape[0]
    group = (torch.arange(n, device=dev) if group_idx is None
             else to_device(group_idx, dev, torch.int64))
    x_sq = (x * x).sum(1)
    best_d = torch.full((m,), float("inf"), device=dev)
    best_i = torch.zeros((m,), dtype=torch.int32, device=dev)
    for a in range(0, n, tile):
        yb = y[a:a + tile]
        dblk = _dist_block(x, yb, x_sq, (yb * yb).sum(1), sqrt)
        dblk = torch.where(adj[:, group[a:a + tile]], dblk,
                           torch.full_like(dblk, float("inf")))
        blk_arg = torch.argmin(dblk, dim=1)
        blk_min = torch.gather(dblk, 1, blk_arg[:, None])[:, 0]
        take = blk_min < best_d
        best_d = torch.where(take, blk_min, best_d)
        best_i = torch.where(take, blk_arg.to(torch.int32) + a, best_i)
    return best_d, best_i
