"""Row-id dtype policy (counterpart of ``raft_tpu.core.ids``).

Ids are int32 while every id of the addressed row count fits
(n ≤ 2³¹ − 1) and int64 beyond; ``-1`` is the invalid sentinel in both
widths. The CUDA kernels take int32 ids; torch indexing wants int64, so
ids are widened (``.long()``) only at the indexing site and are never
narrowed blindly. Shard offsets (``rank · shard_rows``) are computed in
the dtype of the whole mesh's row count: the product overflows int32 past
2³¹ rows even when every per-shard id fits.
"""

from __future__ import annotations

import torch

INT32_MAX_ROWS = 2**31 - 1


def id_dtype(n_rows: int) -> torch.dtype:
    """int32 while every id of ``n_rows`` rows fits, int64 beyond."""
    return torch.int32 if int(n_rows) <= INT32_MAX_ROWS else torch.int64


def make_ids(n: int, device=None, start: int = 0) -> torch.Tensor:
    """``arange(start, start + n)`` in the policy dtype of its largest
    id."""
    return torch.arange(start, start + n, dtype=id_dtype(start + n),
                        device=device)


def id_dtype_like(ids: torch.Tensor) -> torch.dtype:
    """Keep an id array's width: int64 stays int64, anything else is
    int32."""
    if ids.dtype == torch.int64:
        return torch.int64
    return torch.int32


def global_ids(rank: int, shard_rows: int, local_ids: torch.Tensor,
               n_total: int) -> torch.Tensor:
    """Shard-local ids → global ids, ``local + rank · shard_rows`` in
    ``id_dtype(n_total)``; invalid (< 0) local ids stay −1."""
    dt = id_dtype(n_total)
    loc = local_ids.to(dt)
    off = int(rank) * int(shard_rows)
    return torch.where(loc >= 0, loc + off, torch.full_like(loc, -1))


def local_ids(gids: torch.Tensor, rank: int, shard_rows: int
              ) -> torch.Tensor:
    """Global ids → shard-local ids, ``gid − rank · shard_rows`` in the
    incoming width; invalid (< 0) global ids stay −1. The caller masks
    ids outside ``[0, shard_rows)``: they belong to other shards."""
    g = gids.to(id_dtype_like(gids))
    off = int(rank) * int(shard_rows)
    return torch.where(g >= 0, g - off, torch.full_like(g, -1))
