"""raft_tpu_torch.linalg — dense linear algebra (counterpart of
``raft_tpu.linalg``, after the reference's cpp/include/raft/linalg).

The JAX package computes these outside any Pallas kernel (XLA's
``dot_general``, its decompositions, ``segment_sum``), so here they are
``torch.matmul``, ``torch.linalg`` and plain torch, on the device of their
inputs. Products the JAX package asks at ``Precision.HIGHEST`` run in fp32
with TF32 off (``utils.precision``).
"""

from raft_tpu_torch.linalg.blas import axpy, dot, gemm, gemv  # noqa: F401
from raft_tpu_torch.linalg.solvers import (  # noqa: F401
    cholesky_r1_update,
    eig_dc,
    eig_jacobi,
    lstsq,
    qr,
    rsvd,
    svd,
)
from raft_tpu_torch.linalg.map_reduce import (  # noqa: F401
    binary_op,
    coalesced_reduction,
    map_offset,
    map_op,
    map_then_reduce,
    matrix_vector_op,
    mean_squared_error,
    normalize_rows,
    reduce_cols_by_key,
    reduce_op,
    reduce_rows_by_key,
    strided_reduction,
    ternary_op,
    unary_op,
)
from raft_tpu_torch.linalg.eltwise import (  # noqa: F401
    add,
    divide,
    eltwise_multiply,
    power,
    sqrt,
    subtract,
    transpose,
)
