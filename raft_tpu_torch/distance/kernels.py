"""Gram (kernel) matrices of the SVM-style kernels: linear, polynomial,
RBF and tanh (counterpart of ``raft_tpu.distance.kernels``, after the
reference's distance/kernels.cuh, detail/kernels/gram_matrix.cuh).

Each is one Gram product (``torch.matmul`` in fp32 with TF32 off, as the
JAX package's ``Precision.HIGHEST`` asks) and an elementwise epilogue.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.utils import precision as _precision


class KernelType(enum.Enum):
    LINEAR = "linear"
    POLYNOMIAL = "polynomial"
    RBF = "rbf"
    TANH = "tanh"


@dataclasses.dataclass
class KernelParams:
    """Reference: ``raft::distance::kernels::KernelParams``."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


@traced("raft_tpu_torch.gram_matrix")
def gram_matrix(x, y, params: KernelParams, device="cuda") -> torch.Tensor:
    """The kernel Gram matrix K[i, j] = k(x_i, y_j), [m, n] f32
    (reference: detail/kernels/gram_matrix.cuh ``evaluate``)."""
    dev = resolve_device(device)
    _precision.enforce()
    x = to_device(x, dev, torch.float32)
    y = to_device(y, dev, torch.float32)
    k = x @ y.T
    if params.kernel == KernelType.LINEAR:
        return k
    if params.kernel == KernelType.POLYNOMIAL:
        return (params.gamma * k + params.coef0) ** params.degree
    if params.kernel == KernelType.TANH:
        return torch.tanh(params.gamma * k + params.coef0)
    if params.kernel == KernelType.RBF:
        d2 = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
              - 2.0 * k).clamp_min(0.0)
        return torch.exp(-params.gamma * d2)
    raise ValueError(f"unknown kernel {params.kernel}")
