"""Elementwise arithmetic (counterpart of ``raft_tpu.linalg.eltwise``;
reference: linalg/add.cuh, subtract.cuh, multiply.cuh, divide.cuh,
power.cuh, sqrt.cuh, transpose.cuh)."""

from __future__ import annotations

import torch


def add(x, y):
    """reference: linalg/add.cuh."""
    return torch.add(x, y)


def subtract(x, y):
    """reference: linalg/subtract.cuh."""
    return torch.subtract(x, y)


def eltwise_multiply(x, y):
    """reference: linalg/multiply.cuh (eltwiseMultiply)."""
    return torch.multiply(x, y)


def divide(x, y):
    """reference: linalg/divide.cuh (true division, as ``jnp.divide``)."""
    return torch.true_divide(x, y)


def power(x, y):
    """reference: linalg/power.cuh."""
    return torch.pow(x, y)


def sqrt(x):
    """reference: linalg/sqrt.cuh."""
    return torch.sqrt(x)


def transpose(m: torch.Tensor) -> torch.Tensor:
    """reference: linalg/transpose.cuh."""
    return m.T
