"""Elementwise map + reduction (counterpart of
``raft_tpu.linalg.map_reduce``; reference: linalg/map.cuh, unary_op.cuh,
binary_op.cuh, ternary_op.cuh, matrix_vector_op.cuh, normalize.cuh,
reduce.cuh, coalesced_reduction.cuh, strided_reduction.cuh,
map_reduce.cuh, reduce_rows_by_key.cuh, reduce_cols_by_key.cuh,
mean_squared_error.cuh). The callables receive tensors.

:func:`segment_sum` is ``jax.ops.segment_sum``: an id outside
[0, num_segments) — a −1 noise label, say — drops its row, where
``index_add_`` would raise on the CPU and fail a device assert on the
card. Such ids go to a spare segment that is cut off, so the mask costs
no copy of the data and no host sync.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.device import resolve_device


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                dim: int = 0) -> torch.Tensor:
    """``jax.ops.segment_sum`` along ``dim``: slices of ``data`` summed by
    ``ids``; out-of-range ids (negative ones too) are dropped."""
    ids = ids.to(device=data.device, dtype=torch.int64)
    idx = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    shape = list(data.shape)
    shape[dim] = num_segments + 1
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    out.index_add_(dim, idx, data)
    return out.narrow(dim, 0, num_segments)


def _sum(x: torch.Tensor, axis=None) -> torch.Tensor:
    """``jnp.sum``: bool and narrow integers sum to int32 (torch's to
    int64)."""
    kw = {} if axis is None else {"dim": axis}
    if x.dtype == torch.bool or (not x.is_floating_point()
                                 and not x.is_complex()
                                 and x.dtype != torch.int64):
        kw["dtype"] = torch.int32
    return x.sum(**kw)


def map_op(fn: Callable, *arrays) -> torch.Tensor:
    """Elementwise map over arrays (reference: linalg/map.cuh ``map``)."""
    return fn(*arrays)


def map_offset(fn: Callable[[torch.Tensor], torch.Tensor], shape,
               device="cuda") -> torch.Tensor:
    """Map over flat element offsets (int32; reference: map.cuh
    ``map_offset``)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int32, device=resolve_device(device))
    return fn(idx).reshape(tuple(shape))


def unary_op(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """reference: linalg/unary_op.cuh."""
    return fn(x)


def binary_op(fn: Callable, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """reference: linalg/binary_op.cuh."""
    return fn(x, y)


def ternary_op(fn: Callable, x, y, z) -> torch.Tensor:
    """reference: linalg/ternary_op.cuh."""
    return fn(x, y, z)


def matrix_vector_op(m: torch.Tensor, v: torch.Tensor, op: Callable,
                     along_rows: bool = True) -> torch.Tensor:
    """Broadcast a vector op over matrix lines
    (reference: linalg/matrix_vector_op.cuh)."""
    return op(m, v[None, :] if along_rows else v[:, None])


def normalize_rows(m: torch.Tensor, norm: str = "l2", eps: float = 1e-12
                   ) -> torch.Tensor:
    """Row normalization (reference: linalg/normalize.cuh row_normalize)."""
    if norm == "l2":
        d = torch.sqrt((m * m).sum(1, keepdim=True).clamp_min(eps))
    elif norm == "l1":
        d = m.abs().sum(1, keepdim=True).clamp_min(eps)
    elif norm == "linf":
        d = m.abs().amax(1, keepdim=True).clamp_min(eps)
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return m / d


def reduce_op(m: torch.Tensor, axis: int = 1, op: str = "sum",
              main_op: Optional[Callable] = None) -> torch.Tensor:
    """Row/col reduce with optional pre-map (reference: linalg/reduce.cuh:
    ``reduce(..., main_op, reduce_op)``)."""
    x = main_op(m) if main_op is not None else m
    if op == "sum":
        return _sum(x, axis)
    if op == "max":
        return x.amax(axis)
    if op == "min":
        return x.amin(axis)
    raise ValueError(f"unknown reduce op {op!r}")


def coalesced_reduction(m: torch.Tensor, op: str = "sum",
                        main_op: Optional[Callable] = None) -> torch.Tensor:
    """Reduce along the contiguous (last) axis
    (reference: linalg/coalesced_reduction.cuh)."""
    return reduce_op(m, axis=-1, op=op, main_op=main_op)


def strided_reduction(m: torch.Tensor, op: str = "sum",
                      main_op: Optional[Callable] = None) -> torch.Tensor:
    """Reduce along the strided (first) axis
    (reference: linalg/strided_reduction.cuh)."""
    return reduce_op(m, axis=0, op=op, main_op=main_op)


def map_then_reduce(fn: Callable, *arrays, axis=None) -> torch.Tensor:
    """reference: linalg/map_reduce.cuh ``map_reduce``."""
    return _sum(fn(*arrays), axis)


def reduce_rows_by_key(m: torch.Tensor, keys: torch.Tensor, n_keys: int,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sum rows grouped by key (reference: linalg/reduce_rows_by_key.cuh —
    kmeans' centroid accumulation); keys outside [0, n_keys) are dropped."""
    x = m if weights is None else m * weights[:, None]
    return segment_sum(x, keys, n_keys)


def reduce_cols_by_key(m: torch.Tensor, keys: torch.Tensor, n_keys: int
                       ) -> torch.Tensor:
    """Sum columns grouped by key (reference:
    linalg/reduce_cols_by_key.cuh); keys outside [0, n_keys) are
    dropped."""
    return segment_sum(m, keys, n_keys, dim=1)


def mean_squared_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """reference: linalg/mean_squared_error.cuh."""
    d = a - b
    return (d * d).mean()
