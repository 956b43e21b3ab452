"""Sparse formats — COO / CSR containers (counterpart of
``raft_tpu.sparse.types``, after the reference's core/{coo_matrix,
csr_matrix}.hpp, sparse/coo.hpp, sparse/csr.hpp).

A sparse matrix is an immutable tuple of flat tensors and a static
``shape``, as in the JAX package. Structural conversions that sort
(COO → CSR, dense → COO) run on the host with numpy, as the JAX package
runs them, and hand their arrays back on the input's device; CSR → COO
and → dense are tensor code on the device. Rows, columns and indptr are
int32, as the JAX package stores them (nnz < 2³¹).

Constructors from host arrays (:func:`make_coo`, :func:`make_csr`,
:func:`from_scipy`) take ``device=``: a tensor argument's device when
given tensors, else ``"cuda"`` (raising without a card unless given
``device="cpu"``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device, to_device


class COO(NamedTuple):
    """Coordinate-format sparse matrix (reference: sparse/coo.hpp):
    ``rows``/``cols``/``data`` parallel 1-D tensors of length nnz."""

    rows: torch.Tensor
    cols: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


class CSR(NamedTuple):
    """Compressed-sparse-row matrix (reference: sparse/csr.hpp):
    ``indptr`` of length n_rows + 1, ``indices``/``data`` of length nnz,
    sorted by row (column order within a row is unspecified unless a
    structural op sorted it)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def row_ids(self) -> torch.Tensor:
        """indptr expanded to a row id per stored entry (int32; reference:
        sparse/convert/csr.hpp csr_to_coo rows): the last i with
        indptr[i] ≤ j."""
        j = torch.arange(self.data.shape[0], dtype=torch.int32,
                         device=self.indptr.device)
        return (torch.searchsorted(self.indptr, j, right=True)
                .to(torch.int32) - 1)


def _device_of(device, *arrays) -> torch.device:
    if device is not None:
        return resolve_device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device("cuda")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# the JAX package's arrays are 32-bit (``jax_enable_x64`` off)
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _values(data, dev: torch.device) -> torch.Tensor:
    t = to_device(data, dev)
    return t.to(_NARROW.get(t.dtype, t.dtype))


def make_coo(rows, cols, data, shape, device=None) -> COO:
    dev = _device_of(device, rows, cols, data)
    return COO(to_device(rows, dev, torch.int32),
               to_device(cols, dev, torch.int32),
               _values(data, dev),
               (int(shape[0]), int(shape[1])))


def make_csr(indptr, indices, data, shape, device=None) -> CSR:
    dev = _device_of(device, indptr, indices, data)
    return CSR(to_device(indptr, dev, torch.int32),
               to_device(indices, dev, torch.int32),
               _values(data, dev),
               (int(shape[0]), int(shape[1])))


def coo_from_dense(dense: torch.Tensor) -> COO:
    """Host-side dense → COO, row-major order (reference:
    sparse/convert/coo.hpp)."""
    a = _host(dense)
    rows, cols = np.nonzero(a)
    return make_coo(rows, cols, a[rows, cols], a.shape, device=dense.device)


def csr_from_dense(dense: torch.Tensor) -> CSR:
    """Host-side dense → CSR (reference: sparse/convert/csr.hpp)."""
    return coo_to_csr(coo_from_dense(dense))


def coo_to_csr(coo: COO) -> CSR:
    """Host-side COO → CSR: stable sort by row, prefix-sum row counts
    (reference: sparse/convert/csr.hpp sorted_coo_to_csr)."""
    rows, cols, data = _host(coo.rows), _host(coo.cols), _host(coo.data)
    order = np.argsort(rows, kind="stable")
    rows, cols, data = rows[order], cols[order], data[order]
    counts = np.bincount(rows, minlength=coo.shape[0]).astype(np.int64)
    indptr = np.zeros(coo.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return make_csr(indptr, cols, data, coo.shape, device=coo.data.device)


def csr_to_coo(csr: CSR) -> COO:
    """CSR → COO on the device (row expansion by ``searchsorted``)."""
    return COO(csr.row_ids, csr.indices, csr.data, csr.shape)


def to_dense(m) -> torch.Tensor:
    """COO/CSR → dense, duplicates summed (reference:
    sparse/convert/dense.hpp)."""
    if isinstance(m, CSR):
        m = csr_to_coo(m)
    out = torch.zeros(m.shape, dtype=m.data.dtype, device=m.data.device)
    return out.index_put_((m.rows.long(), m.cols.long()), m.data,
                          accumulate=True)


def to_scipy(m):
    """Export to scipy.sparse for interop/testing."""
    import scipy.sparse as sp

    if isinstance(m, CSR):
        return sp.csr_matrix((_host(m.data), _host(m.indices),
                              _host(m.indptr)), shape=m.shape)
    return sp.coo_matrix((_host(m.data), (_host(m.rows), _host(m.cols))),
                         shape=m.shape)


def from_scipy(m, device="cuda") -> CSR:
    """Import any scipy.sparse matrix as canonical CSR (duplicates summed,
    explicit zeros dropped — consumers assume canonical structure)."""
    m = m.tocsr().copy()
    m.sum_duplicates()
    m.eliminate_zeros()
    return make_csr(m.indptr, m.indices, m.data, m.shape, device=device)
