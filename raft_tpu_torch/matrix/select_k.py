"""select_k — batched top-k selection (counterpart of
``raft_tpu.matrix.select_k``).

Tiers, by shape alone:

- **kernel** — k ≤ 64 at any len: the hand-written CUDA kernel
  (``ops.kernels.select_k_cuda``; its plain version on CPU tensors).
  The JAX package takes its kernel only at len ≥ 8192
  (``select_k.py:87-91``); here the kernel's short-row variant (a warp
  per row) is ahead of the stable sort on every short row the paths
  give it. ``chip_smoke.py``'s ``[flat select_k]`` line, on an NVIDIA
  H100 80GB HBM3 at 700 W: [10,000, 1024] coarse probes at k 16 / 32 /
  64 in 0.068 / 0.123 / 0.235 ms against the sort's 0.39; the merge's
  [10,000, 320] query cut at k 10 in 0.035 against 0.288; a
  predict_topk Gram tile [65,536, 1024] at k 6 in 0.186 against 2.34;
- **tiled** — 64 < k, len ≥ 65536 (four tiles of 16384 or more): per-tile
  select then a merge of the per-tile survivors;
- **sort** — otherwise: ``select_k_cuda``'s plain version, a STABLE
  ``torch.sort``, so ties go to the lowest position as ``lax.top_k``'s do
  (``torch.topk`` does not promise that).

Selection is over rows of ``[batch, len]``; ``select_min=True`` keeps the
smallest values. Positions come back int32; with ``input_indices`` they
are gathered from it (the reference's in-indices overload).

Each call counts its tier under ``select_k.dispatch{impl=pallas|xla_tiled|
xla}`` (the JAX package's labels for the kernel, tiled and sort tiers).
:func:`select_k` is the traced entry point; the port's own modules call
:func:`select_k_impl`, its untraced body, where the JAX package calls
``select_k`` inside a jitted program (whose span records nothing).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k

_KERNEL_MAX_K = 64
_LARGE_K_TILE = 16384
_LARGE_K_MIN_LEN = 4 * _LARGE_K_TILE   # 65536


def _gather_ids(idx: torch.Tensor, input_indices: Optional[torch.Tensor]):
    if input_indices is None:
        return idx.to(torch.int32)
    return torch.gather(input_indices, 1, idx.long())


@traced("raft_tpu_torch.select_k")
def select_k(scores: torch.Tensor, k: int, select_min: bool = True,
             input_indices: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest/largest entries per row → (values [batch, k],
    positions [batch, k] int32, or entries of ``input_indices``)."""
    return select_k_impl(scores, k, select_min, input_indices)


def select_k_impl(scores: torch.Tensor, k: int, select_min: bool = True,
                  input_indices: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_k` without its span. ``bias`` (a row of len f32
    values) ranks ``bias − 2·scores`` instead of ``scores``: the kernel
    tier forms it as it loads a score (``ops.kernels.select_k_cuda``), the
    other tiers with one ``torch.sub`` first."""
    expects(scores.dim() == 2, "scores must be [batch, len]")
    n = scores.shape[1]
    if k > n:
        raise ValueError(f"k={k} > len={n}")
    if k <= _KERNEL_MAX_K:
        _obs_spans.count_dispatch("select_k", "pallas")
        vals, idx = _k.select_k_cuda(scores.float().contiguous(), k,
                                     select_min, bias)
        return vals, _gather_ids(idx, input_indices)
    if bias is not None:
        scores = torch.sub(bias.reshape(1, -1), scores, alpha=2.0)
    if n >= _LARGE_K_MIN_LEN:
        _obs_spans.count_dispatch("select_k", "xla_tiled")
        vals, idx = _select_k_tiled(scores, k, select_min)
    else:
        _obs_spans.count_dispatch("select_k", "xla")
        vals, idx = _k.select_k_plain(scores, k, select_min)
    return vals, _gather_ids(idx, input_indices)


def _select_k_tiled(scores, k, select_min):
    """Two-phase: per-tile top-k, then a top-k over the concatenated
    survivors (reference: knn_brute_force.cuh:234-276). Ties keep the
    lowest position: tiles are laid out in position order and both
    phases sort stably."""
    batch, n = scores.shape
    len_tile = _LARGE_K_TILE
    pad_val = float("inf") if select_min else float("-inf")
    n_tiles = -(-n // len_tile)
    padded = torch.nn.functional.pad(scores, (0, n_tiles * len_tile - n),
                                     value=pad_val)
    kk = min(k, len_tile)
    tv, ti = _k.select_k_plain(padded.view(batch * n_tiles, len_tile), kk,
                               select_min)
    ti = ti.view(batch, n_tiles, kk) + (torch.arange(
        n_tiles, device=scores.device) * len_tile)[None, :, None]
    vals, pos = _k.select_k_plain(tv.reshape(batch, n_tiles * kk), k,
                                  select_min)
    return vals, torch.gather(ti.reshape(batch, n_tiles * kk), 1, pos.long())


def merge_parts(part_vals: torch.Tensor, part_idx: torch.Tensor, k: int,
                select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part top-k candidate lists into one top-k (counterpart of
    ``knn_merge_parts``, neighbors/detail/knn_merge_parts.cuh): parts come
    from index chunks, shards or probes, each holding its local top-k
    with *global* ids in ``part_idx``.

    ``part_vals``, ``part_idx``: [n_parts, batch, k_part] → (values,
    ids) [batch, k], one :func:`select_k` over each row's n_parts·k_part
    candidates in part order (the kernel tier, B3, for k ≤ 64), so ties
    keep the lower part."""
    expects(part_vals.dim() == 3 and part_idx.shape == part_vals.shape,
            "parts must be [n_parts, batch, k_part] values and ids (got %s "
            "and %s)", tuple(part_vals.shape), tuple(part_idx.shape))
    n_parts, batch, k_part = part_vals.shape
    flat_v = part_vals.permute(1, 0, 2).reshape(batch, n_parts * k_part)
    flat_i = part_idx.permute(1, 0, 2).reshape(batch, n_parts * k_part)
    return select_k(flat_v, k, select_min=select_min, input_indices=flat_i)
