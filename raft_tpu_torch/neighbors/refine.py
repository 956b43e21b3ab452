"""Refine — exact re-ranking of ANN candidate lists (counterpart of
``raft_tpu.neighbors.refine``: ``refine``, ``_refine_impl``,
``_refine_rows``, ``_fused_refine_wanted``, ``_refine_fused``,
``_gather_keys_to_dists``), and ``route_refined``, the
``refine="f32_regen"`` route shared by the IVF searches.

Two tiers, chosen by shape as in the JAX package:

- **fused** — the hand-written gather-refine kernel (no ``[m, C, d]``
  gather buffer) for oversampled shapes: k ≤ 64, C ≥ 256, and C ≥ 400 or
  a gather buffer of ≥ 1 GB, on an f32 dataset — the JAX package's rule
  (``pallas_gather_refine_wanted``). Its VMEM model of the TPU kernel's
  row block has no counterpart: the CUDA kernel holds no row or key block,
  so it takes any C and any d;
- **gather** — gather the candidate rows and re-rank with one batched
  product, then select.

The JAX package engaged the fused tier only on a TPU; here the rule is
the shape alone, and on CPU tensors the kernel wrapper runs its plain
version.

``filter_bits`` (a packed bitset over dataset rows, ``core.bitset``):
the fused tier hands the words to the kernel, which clears a candidate
whose bit is clear before its row load; the gather tier sets such
candidates to −1 first. The JAX package's rule also charged a filtered
re-rank the VMEM of its word block (``pallas_gather_refine_wanted(...,
filtered=)``); the CUDA kernel reads one word a candidate and holds no
block, so a filter does not change the rule here. Each dispatch counts
under ``refine.dispatch`` (``pallas_gather`` / ``xla_gather``, the JAX
package's labels), with ``filtered=1`` when filtered.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects, not_ported
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import select_k as _select_k
from raft_tpu_torch.neighbors import ivf_common as ic
from raft_tpu_torch.neighbors import sample_filter as _sf
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.utils import precision as _precision


def _check_candidates(queries, candidates, k: int) -> None:
    expects(candidates.dim() == 2, "candidates must be [m, n_candidates]")
    expects(candidates.shape[1] > 0, "candidates must have a non-empty "
            "candidate axis (got shape %s)", tuple(candidates.shape))
    expects(queries.shape[0] == candidates.shape[0],
            "queries/candidates row mismatch: %d queries vs %d candidate rows",
            queries.shape[0], candidates.shape[0])
    expects(k <= candidates.shape[1], "k=%d > n_candidates=%d", k,
            candidates.shape[1])


def _refine_rows(cand_rows, queries, candidates, k: int, metric: str):
    """Exact keys of gathered rows ``[m, C, d]`` → (distances [m, k],
    ids [m, k]) in the reporting convention of each metric."""
    mt = resolve_metric(metric)
    q = queries.float()
    scores = torch.einsum("md,mcd->mc", q, cand_rows)
    if mt == DistanceType.InnerProduct:
        dists, invalid, select_min = scores, float("-inf"), False
    elif mt == DistanceType.CosineExpanded:
        qn = torch.sqrt((q * q).sum(1).clamp_min(1e-30))
        cn = torch.sqrt((cand_rows * cand_rows).sum(-1).clamp_min(1e-30))
        dists, invalid, select_min = (1.0 - scores / (qn[:, None] * cn),
                                      float("inf"), True)
    else:
        q_sq = (q * q).sum(1)
        c_sq = (cand_rows * cand_rows).sum(-1)
        dists = (q_sq[:, None] + c_sq - 2.0 * scores).clamp_min(0.0)
        if mt == DistanceType.L2SqrtExpanded:
            dists = torch.sqrt(dists)
        invalid, select_min = float("inf"), True
    dists = torch.where(candidates >= 0, dists,
                        torch.full_like(dists, invalid))
    vals, pos = _select_k(dists, k, select_min=select_min)
    return vals, torch.gather(candidates, 1, pos.long())


def _refine_impl(dataset, queries, candidates, k: int, metric: str):
    n = dataset.shape[0]
    rows = dataset[candidates.long().clamp(0, n - 1)].float()  # [m, C, d]
    return _refine_rows(rows, queries, candidates, k, metric)


def _gather_keys_to_dists(keys, ids, metric: str):
    """Kernel keys (l2 squared distance, ip −score, cos distance) → the
    reporting convention of :func:`_refine_rows`."""
    mt = resolve_metric(metric)
    if mt == DistanceType.InnerProduct:
        return -keys, ids
    if mt == DistanceType.L2SqrtExpanded:
        return torch.sqrt(keys), ids
    return keys, ids


def _fused_refine_wanted(dataset, queries, candidates, k: int) -> bool:
    if not isinstance(dataset, torch.Tensor) or dataset.dim() != 2:
        return False
    if dataset.dtype != torch.float32:
        return False
    m, C = candidates.shape
    d = dataset.shape[1]
    if not ic.gather_refine_mem_ok(dataset.shape[0], d, 4, m=m, C=C,
                                   row_align=1):
        return False
    if k > _k.GATHER_REFINE_MAX_K or C < 2 * _k.LUT_SCAN_LANES:
        return False
    return C >= 400 or m * C * d * 4 >= (1 << 30)


def _refine_fused(dataset, queries, candidates, k: int, mt: DistanceType,
                  filter_bits=None):
    met = ("ip" if mt == DistanceType.InnerProduct
           else "cos" if mt == DistanceType.CosineExpanded else "l2")
    keys, ids = _k.gather_refine_topk(
        dataset.contiguous(), queries.float().contiguous(),
        candidates.to(torch.int32).contiguous(), k, met,
        filter_bits=filter_bits)
    return _gather_keys_to_dists(keys, ids, mt.value)


def refine(dataset: torch.Tensor, queries, candidates, k: int,
           metric="sqeuclidean", filter_bits=None, device="cuda"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``candidates`` [m, n_cand] (row ids into ``dataset``, -1
    invalid) down to the exact top-k → (distances [m, k], ids [m, k]).
    ``filter_bits``: candidates whose bit is clear are excluded as invalid
    ids are."""
    dev = resolve_device(device)
    _precision.enforce()
    dataset = to_device(dataset, dev)
    queries = to_device(queries, dev, torch.float32)
    candidates = to_device(candidates, dev)
    _check_candidates(queries, candidates, k)
    expects(dataset.dim() == 2 and dataset.shape[1] == queries.shape[1],
            "dataset/queries feature-dim mismatch: dataset shape %s vs "
            "%d-dim queries", tuple(dataset.shape), queries.shape[1])
    mt = resolve_metric(metric)
    labels = {}
    if filter_bits is not None:
        filter_bits = _bitset.as_words(filter_bits, dev)
        labels["filtered"] = "1"
    if _fused_refine_wanted(dataset, queries, candidates, k):
        _obs_spans.count_dispatch("refine", "pallas_gather", **labels)
        return _refine_fused(dataset, queries, candidates, k, mt,
                             filter_bits=filter_bits)
    _obs_spans.count_dispatch("refine", "xla_gather", **labels)
    candidates = _sf.masked_ids(filter_bits, candidates)
    return _refine_impl(dataset, queries, candidates, k, mt.value)


def route_refined(search, index, queries: torch.Tensor, k: int, params,
                  dataset, device, filter_bitset=None):
    """``refine="f32_regen"`` of an IVF index: ``search`` (the index's own,
    with ``refine="none"``) scans k·refine_ratio candidates, then the exact
    re-rank against the device-resident ``dataset``. A filter goes to both:
    the scan already leaves only kept candidates, and the re-rank's test
    of them costs one word a candidate, as in the JAX package."""
    expects(params.refine == "f32_regen",
            "unknown refine mode %r (supported: 'none', 'f32_regen')",
            params.refine)
    expects(dataset is not None,
            "refine='f32_regen' needs search(..., dataset=...): the exact "
            "rows to re-rank against")
    if not (isinstance(dataset, torch.Tensor)
            and dataset.device == index.device):
        raise not_ported("re-ranking against a host-resident dataset "
                         "(tiered / host gather / provider tiers)", "A12")
    expects(dataset.dim() == 2 and dataset.shape[1] == index.dim,
            "refine dataset shape %s does not match the index dim %d",
            tuple(dataset.shape), index.dim)
    expects(params.refine_ratio >= 1.0, "refine_ratio must be >= 1 (got %s)",
            params.refine_ratio)
    k_cand = max(k, int(round(k * params.refine_ratio)))
    scan_params = dataclasses.replace(params, refine="none")
    _, i0 = search(index, queries, k_cand, scan_params,
                   filter_bitset=filter_bitset, device=device)
    return refine(dataset, queries, i0, k, metric=index.metric,
                  filter_bits=filter_bitset, device=device)
