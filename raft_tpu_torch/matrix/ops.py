"""Matrix utilities (counterpart of ``raft_tpu.matrix.ops``; reference:
cpp/include/raft/matrix/*.cuh).

One name per reference header, as in the JAX package: argmax/argmin,
gather/scatter, col_wise_sort, linewise_op, slice, norm, reverse,
sign_flip, triangular, diagonal, init/copy/eye, math (power, sqrt,
reciprocal, ratio, threshold) and print. Plain torch on the device of the
input; the functions that create a matrix take ``device=``. Where the JAX
package is value-semantic (``scatter``, ``set_diagonal``, ``copy``) these
return a new tensor and leave the input as it was. Indices are int32, as
``jnp.argmax`` gives them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device


def argmax(m: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax, first of equal maxima (reference:
    matrix/argmax.cuh)."""
    return torch.argmax(m, dim=1).to(torch.int32)


def argmin(m: torch.Tensor) -> torch.Tensor:
    """Row-wise argmin, first of equal minima (reference:
    matrix/argmin.cuh)."""
    return torch.argmin(m, dim=1).to(torch.int32)


def gather(m: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather rows by index (reference: matrix/gather.cuh)."""
    return m[indices.long()]


def scatter(m: torch.Tensor, indices: torch.Tensor, rows: torch.Tensor
            ) -> torch.Tensor:
    """Scatter rows into a copy of ``m`` (reference: matrix/scatter.cuh —
    value-semantic here)."""
    out = m.clone()
    out[indices.long()] = rows.to(out.dtype)
    return out


def col_wise_sort(m: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """Sort each column (reference: matrix/col_wise_sort.cuh)."""
    s = torch.sort(m, dim=0)[0]
    return s if ascending else s.flip(0)


def slice_matrix(m: torch.Tensor, r0: int, c0: int, r1: int, c1: int
                 ) -> torch.Tensor:
    """Sub-matrix [r0:r1, c0:c1] (reference: matrix/slice.cuh)."""
    return m[r0:r1, c0:c1]


def norm(m: torch.Tensor, norm_type: str = "l2", axis: int = 1
         ) -> torch.Tensor:
    """Row/col norms (reference: matrix/norm.cuh): "l1" | "l2" | "l2sqrt" |
    "linf" ("l2" is the squared norm, as in the reference)."""
    if norm_type == "l1":
        return m.abs().sum(axis)
    if norm_type == "l2":
        return (m * m).sum(axis)
    if norm_type == "l2sqrt":
        return torch.sqrt((m * m).sum(axis))
    if norm_type == "linf":
        return m.abs().amax(axis)
    raise ValueError(f"unknown norm type {norm_type!r}")


def linewise_op(m: torch.Tensor, vec: torch.Tensor, op,
                along_rows: bool = True) -> torch.Tensor:
    """Apply a binary op between each matrix line and a vector
    (reference: matrix/linewise_op.cuh)."""
    if along_rows:
        return op(m, vec[None, :])
    return op(m, vec[:, None])


def reverse(m: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Reverse along an axis (reference: matrix/reverse.cuh)."""
    return m.flip(axis)


def sign_flip(m: torch.Tensor) -> torch.Tensor:
    """Flip column signs so the max-|.| element of each column is positive
    (reference: matrix/detail/math.cuh signFlip — deterministic
    eigenvector orientation)."""
    idx = torch.argmax(m.abs(), dim=0)
    signs = torch.sign(m[idx, torch.arange(m.shape[1], device=m.device)])
    signs = torch.where(signs == 0, 1.0, signs)
    return m * signs[None, :]


def triangular_upper(m: torch.Tensor) -> torch.Tensor:
    """Upper-triangular copy (reference: matrix/triangular.cuh)."""
    return torch.triu(m)


def get_diagonal(m: torch.Tensor) -> torch.Tensor:
    """Main diagonal (reference: matrix/diagonal.cuh)."""
    return torch.diagonal(m).clone()


def set_diagonal(m: torch.Tensor, d) -> torch.Tensor:
    """Copy of ``m`` with the diagonal set (reference: matrix/diagonal.cuh
    set_diagonal — value-semantic here)."""
    out = m.clone()
    k = min(m.shape[0], m.shape[1])
    i = torch.arange(k, device=m.device)
    out[i, i] = d if not isinstance(d, torch.Tensor) else d.to(out.dtype)
    return out


def invert_diagonal(m: torch.Tensor) -> torch.Tensor:
    """Reciprocal of the diagonal in place of it (reference:
    matrix/diagonal.cuh invert_diagonal)."""
    return set_diagonal(m, 1.0 / get_diagonal(m))


def fill(shape, value, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Constant matrix (reference: matrix/init.cuh)."""
    return torch.full(tuple(shape), value, dtype=dtype,
                      device=resolve_device(device))


def eye(n: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Identity (reference: matrix/init.cuh / matrix.cuh)."""
    return torch.eye(n, dtype=dtype, device=resolve_device(device))


def copy(m: torch.Tensor) -> torch.Tensor:
    """Copy (reference: matrix/copy.cuh)."""
    return m.clone()


def power(m: torch.Tensor, exponent: float) -> torch.Tensor:
    """Element-wise power (reference: matrix/power.cuh)."""
    return torch.pow(m, exponent)


def sqrt(m: torch.Tensor) -> torch.Tensor:
    """Element-wise sqrt (reference: matrix/sqrt.cuh)."""
    return torch.sqrt(m)


def reciprocal(m: torch.Tensor, scalar: float = 1.0,
               thres: Optional[float] = None) -> torch.Tensor:
    """``scalar / m`` with optional small-value thresholding to zero
    (reference: matrix/reciprocal.cuh)."""
    r = scalar / m
    if thres is not None:
        r = torch.where(m.abs() <= thres, 0.0, r)
    return r


def ratio(m: torch.Tensor) -> torch.Tensor:
    """Each element divided by the matrix sum (reference: matrix/ratio.cuh)."""
    return m / m.sum()


def zero_small_values(m: torch.Tensor, thres: float) -> torch.Tensor:
    """Zero entries below ``thres`` (reference: matrix/threshold.cuh)."""
    return torch.where(m.abs() < thres, 0.0, m)


def print_matrix(m: torch.Tensor, name: str = "matrix") -> str:
    """Formatted dump (reference: matrix/print.cuh). Returns the string
    and prints it: the JAX package's string for the same values."""
    s = f"{name} {tuple(m.shape)}:\n{np_str(m)}"
    print(s)
    return s


def np_str(m: torch.Tensor) -> str:
    return np.array2string(m.detach().cpu().numpy(), precision=4,
                           suppress_small=True)
