"""raft_tpu_torch.matrix — select_k (B3), the merge of per-part top-k
lists, and the matrix utilities (counterpart of ``raft_tpu.matrix``)."""

from raft_tpu_torch.matrix.select_k import merge_parts, select_k  # noqa: F401
from raft_tpu_torch.matrix.ops import (  # noqa: F401
    argmax,
    argmin,
    col_wise_sort,
    copy,
    eye,
    fill,
    gather,
    get_diagonal,
    invert_diagonal,
    linewise_op,
    norm,
    power,
    print_matrix,
    ratio,
    reciprocal,
    reverse,
    scatter,
    set_diagonal,
    sign_flip,
    slice_matrix,
    sqrt,
    triangular_upper,
    zero_small_values,
)
