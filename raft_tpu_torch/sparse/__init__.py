"""Sparse formats (counterpart of ``raft_tpu.sparse``, after the
reference's cpp/include/raft/sparse).

Ported: the COO / CSR containers and their conversions
(:mod:`raft_tpu_torch.sparse.types`). The JAX package's other submodules
— ``distance``, ``linalg``, ``neighbors``, ``ops``, ``solver`` — are not
ported yet: reaching one raises ``NotImplementedError`` naming ROADMAP
A17.
"""

from raft_tpu_torch.core.errors import not_ported
from raft_tpu_torch.sparse import types  # noqa: F401
from raft_tpu_torch.sparse.types import (  # noqa: F401
    COO,
    CSR,
    coo_from_dense,
    coo_to_csr,
    csr_from_dense,
    csr_to_coo,
    from_scipy,
    make_coo,
    make_csr,
    to_dense,
    to_scipy,
)

UNPORTED = ("distance", "linalg", "neighbors", "ops", "solver")

__all__ = [
    "COO",
    "CSR",
    "coo_from_dense",
    "coo_to_csr",
    "csr_from_dense",
    "csr_to_coo",
    "from_scipy",
    "make_coo",
    "make_csr",
    "to_dense",
    "to_scipy",
    "types",
]


def __getattr__(name):
    if name in UNPORTED:
        raise not_ported(f"raft_tpu_torch.sparse.{name}", "A17")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
