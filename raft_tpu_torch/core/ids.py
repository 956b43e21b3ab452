"""Row-id dtype policy (counterpart of ``raft_tpu.core.ids``).

Ids are int32 while every id of the addressed row count fits
(n ≤ 2³¹ − 1) and int64 beyond; ``-1`` is the invalid sentinel in both
widths. The CUDA kernels take int32 ids; torch indexing wants int64, so
ids are widened (``.long()``) only at the indexing site and are never
narrowed blindly.
"""

from __future__ import annotations

import torch

INT32_MAX_ROWS = 2**31 - 1


def id_dtype(n_rows: int) -> torch.dtype:
    """int32 while every id of ``n_rows`` rows fits, int64 beyond."""
    return torch.int32 if int(n_rows) <= INT32_MAX_ROWS else torch.int64


def make_ids(n: int, device=None) -> torch.Tensor:
    """``arange(n)`` in the policy dtype."""
    return torch.arange(n, dtype=id_dtype(n), device=device)
