"""Descriptive statistics (counterpart of ``raft_tpu.stats.descriptive``;
reference: stats/mean.cuh, meanvar.cuh, stddev.cuh, sum.cuh, minmax.cuh,
cov.cuh, histogram.cuh, weighted_mean.cuh, mean_center.cuh). Plain torch
on the device of the input; ``cov``'s product in fp32 with TF32 off."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.linalg.map_reduce import _sum, segment_sum
from raft_tpu_torch.utils import precision as _precision


def mean(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Column/row means (reference: stats/mean.cuh)."""
    return x.mean(axis)


def meanvar(x: torch.Tensor, axis: int = 0, sample: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean + variance (reference: stats/meanvar.cuh)."""
    return x.mean(axis), x.var(axis, correction=1 if sample else 0)


def stddev(x: torch.Tensor, axis: int = 0, sample: bool = True
           ) -> torch.Tensor:
    """reference: stats/stddev.cuh."""
    return x.std(axis, correction=1 if sample else 0)


def sum_op(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """reference: stats/sum.cuh."""
    return _sum(x, axis)


def minmax(x: torch.Tensor, axis: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """reference: stats/minmax.cuh."""
    return x.amin(axis), x.amax(axis)


def cov(x: torch.Tensor, center: bool = True, sample: bool = True
        ) -> torch.Tensor:
    """Covariance matrix of rows-as-samples (reference: stats/cov.cuh)."""
    _precision.enforce()
    n = x.shape[0]
    xc = x - x.mean(0, keepdim=True) if center else x
    denom = (n - 1) if sample else n
    return (xc.T @ xc) / denom


def histogram(x: torch.Tensor, n_bins: int, lo: float, hi: float
              ) -> torch.Tensor:
    """Fixed-range histogram, int32 counts (reference:
    stats/histogram.cuh): values outside [lo, hi] are not counted, ``hi``
    falls in the last bin."""
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which moves bin edges by a last bit
    span = torch.full((), hi - lo, dtype=x.dtype, device=x.device)
    edges = (x - lo) / span * n_bins
    idx = torch.floor(edges).to(torch.int32).clamp(0, n_bins - 1)
    valid = (x >= lo) & (x <= hi)
    return segment_sum(valid.to(torch.int32).reshape(-1), idx.reshape(-1),
                       n_bins)


def weighted_mean(x: torch.Tensor, weights: torch.Tensor, axis: int = 0
                  ) -> torch.Tensor:
    """reference: stats/weighted_mean.cuh."""
    if axis == 0:
        return (x * weights[:, None]).sum(0) / weights.sum()
    return (x * weights[None, :]).sum(1) / weights.sum()


def mean_center(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """reference: stats/mean_center.cuh."""
    return x - x.mean(axis, keepdim=True)
