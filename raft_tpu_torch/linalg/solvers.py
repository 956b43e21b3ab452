"""Dense solvers (counterpart of ``raft_tpu.linalg.solvers``; reference:
linalg/eig.cuh, svd.cuh, rsvd.cuh, qr.cuh, lstsq.cuh,
cholesky_r1_update.cuh). ``torch.linalg`` on the device of the inputs,
products in fp32 with TF32 off.

Eigenvalues come back ascending and singular values descending, as in
the JAX package; vectors are defined only up to sign, and no sign rule is
added here (``matrix.sign_flip`` is one).

:func:`lstsq` is ``jnp.linalg.lstsq``'s minimum-norm solution through the
SVD (singular values under eps·max(m, n) of the largest dropped), on
both devices: on CUDA ``torch.linalg.lstsq`` has only the ``gels``
routine, which assumes full rank and m ≥ n. A tall A (m > n) is reduced by
its QR first (A = QR, the SVD of R [n, n]), whose singular values are
A's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.random import threefry
from raft_tpu_torch.utils import precision as _precision


def eig_dc(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition (reference: linalg/eig.cuh eig_dc).
    Returns (eigenvalues ascending, eigenvectors as columns)."""
    w, v = torch.linalg.eigh(a)
    return w, v


def eig_jacobi(a: torch.Tensor, tol: float = 1e-7
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi-method symmetric eig (reference: linalg/eig.cuh eig_jacobi);
    ``tol`` is accepted for API parity, as in the JAX package."""
    return eig_dc(a)


def svd(a: torch.Tensor, full_matrices: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD → (U, S, Vᵀ) (reference: linalg/svd.cuh svd_qr)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=full_matrices)
    return u, s, vt


def rsvd(a: torch.Tensor, k: int, p: int = 10, n_iter: int = 2,
         key: Optional[threefry.Key] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized SVD (reference: linalg/rsvd.cuh): range-finder with
    ``p`` oversampling columns and ``n_iter`` power iterations. Ω is
    ``jax.random.normal(key, (n, k + p))`` (key default ``PRNGKey(0)``),
    the JAX package's Ω."""
    _precision.enforce()
    if key is None:
        key = threefry.prng_key(0)
    m, n = a.shape
    l = min(n, k + p)
    omega = threefry.normal(key, (n, l), a.device)
    y = a @ omega
    # re-orthonormalize between power iterations: in fp32 the subspace
    # otherwise collapses onto the dominant direction
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(y)
        y = a @ (a.T @ q)
    q, _ = torch.linalg.qr(y)
    b = q.T @ a
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :k], s[:k], vt[:k]


def qr(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR decomposition (reference: linalg/qr.cuh)."""
    q, r = torch.linalg.qr(a)
    return q, r


def lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solve min‖Ax − b‖, the minimum-norm solution
    (reference: linalg/lstsq.cuh; ``jnp.linalg.lstsq`` with its default
    rcond)."""
    _precision.enforce()
    vec = b.dim() == 1
    b2 = b[:, None] if vec else b
    m, n = a.shape
    rcond = float(np.finfo(np.float32).eps) * max(m, n)
    if m > n:
        q, r = torch.linalg.qr(a)
        u, s, vt = torch.linalg.svd(r)
        utb = u.T @ (q.T @ b2)
    else:
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        utb = u.T @ b2
    mask = (s > 0) & (s >= float(np.float32(rcond)) * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    x = vt.T @ (s_inv[:, None] * utb)
    return x[:, 0] if vec else x


def cholesky_r1_update(l: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rank-1 Cholesky update: chol(LLᵀ + vvᵀ)
    (reference: linalg/cholesky_r1_update.cuh). The classic
    hyperbolic-rotation update: the JAX package's ``lax.scan`` over the
    columns, as an n-step loop with the same masked column update."""
    n = l.shape[0]
    l = l.clone()
    rows = torch.arange(n, device=l.device)
    for j in range(n):
        ljj = l[j, j]
        r = torch.sqrt(ljj * ljj + v[j] * v[j])
        c, s = r / ljj, v[j] / ljj
        col = l[:, j]
        new_col = (col + s * v) / c
        mask = rows >= j
        v = torch.where(mask, c * v - s * new_col, v)
        l[:, j] = torch.where(mask, new_col, col)
    return l
