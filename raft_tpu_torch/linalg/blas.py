"""BLAS-level ops (counterpart of ``raft_tpu.linalg.blas``; reference:
linalg/gemm.cuh, gemv.cuh, axpy.cuh, dot.cuh). ``gemm`` and ``dot`` pin
fp32 with TF32 off, as the JAX package pins ``Precision.HIGHEST``."""

from __future__ import annotations

import torch

from raft_tpu_torch.utils import precision as _precision


def gemm(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0,
         beta: float = 0.0, c: torch.Tensor | None = None,
         trans_a: bool = False, trans_b: bool = False) -> torch.Tensor:
    """C = α·op(A)·op(B) + β·C (reference: linalg/gemm.cuh)."""
    _precision.enforce()
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    out = alpha * torch.matmul(a, b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


def gemv(a: torch.Tensor, x: torch.Tensor, alpha: float = 1.0,
         beta: float = 0.0, y: torch.Tensor | None = None,
         trans: bool = False) -> torch.Tensor:
    """y = α·op(A)·x + β·y (reference: linalg/gemv.cuh)."""
    m = a.T if trans else a
    out = alpha * (m @ x)
    if y is not None and beta != 0.0:
        out = out + beta * y
    return out


def axpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y ← α·x + y (reference: linalg/axpy.cuh)."""
    return alpha * x + y


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """⟨x, y⟩ (reference: linalg/dot.cuh; ``jnp.dot``'s shapes)."""
    _precision.enforce()
    if x.dim() == 1 and y.dim() == 1:
        return torch.dot(x, y)
    return torch.matmul(x, y)
