"""Refine — exact re-ranking of ANN candidate lists (counterpart of
``raft_tpu.neighbors.refine``: ``refine``, ``refine_landed``,
``refine_gathered``, ``refine_provider`` and their helpers), and
``route_refined``, the ``refine="f32_regen"`` route shared by the IVF
searches.

Against a device-resident dataset (a tensor on the index's device), two
tiers, chosen by shape as in the JAX package:

- **fused** — the hand-written gather-refine kernel (no ``[m, C, d]``
  gather buffer) for oversampled shapes: k ≤ 64, C ≥ 256, and C ≥ 400 or
  a gather buffer of ≥ 1 GB, on an f32 or bf16 dataset (a bf16 base, such
  as a re-rank copy kept at half the memory, streams its 2-byte rows and
  widens them in the kernel) — the JAX package's rule
  (``pallas_gather_refine_wanted``); any other dtype (int8) takes the
  gather tier, as there. Its VMEM model of the TPU kernel's
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

Against a base that is not on the index's device, the host tiers (ROADMAP
A12):

- ``tiered_prefetch`` — :mod:`~raft_tpu_torch.neighbors.tiered`: after
  one scan of the batch, a reader thread gathers each pipeline
  sub-batch's candidate rows on the host and lands them on the card while
  the sub-batch before is re-ranked; :func:`refine_landed` re-ranks rows
  already landed;
- ``host_gather`` — :func:`refine_gathered`: one serialized host gather of
  every candidate row (``refine_transfer="serial"``, the tiered tier's
  decline, and the ladder's ``host_gather`` rung), with ``dequant=`` for
  SQ8 bases;
- ``provider_regen`` — :func:`refine_provider`: a device-chunk provider
  (``bench.dataset.DeviceSyntheticChunks``) regenerates each block on the
  card and the candidate rows are gathered out of it.

The three re-rank their rows in blocks of exactly ``LANDED_BLOCK``
queries (the last one padded), so a query's distances do not depend on
the batch it came in: the tiered path's sub-batches give the serialized
gather's results bit for bit. As in the JAX package they do not test a
filter again: the scan already left only kept candidates.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.tracing import span, traced
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import select_k_impl as _select_k
from raft_tpu_torch.neighbors import ivf_common as ic
from raft_tpu_torch.neighbors import sample_filter as _sf
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.robust import degrade as _degrade
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.utils import precision as _precision

# queries a host-tier re-rank block holds (module doc); one block a
# pipeline sub-batch of the main path's batch of 500
LANDED_BLOCK = 128


def _check_candidates(queries, candidates, k: int) -> None:
    """Shape checks of a candidate table (a tensor or a numpy array)."""
    expects(len(candidates.shape) == 2,
            "candidates must be [m, n_candidates]")
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


def _refine_rows_blocked(cand_rows, queries, candidates, k: int,
                         metric: str):
    """:func:`_refine_rows` over blocks of exactly ``LANDED_BLOCK`` queries
    (the last zero-padded with invalid ids): every block is the same
    product, so each query's result is independent of the batch."""
    m, R = queries.shape[0], LANDED_BLOCK
    vals, ids = [], []
    for a in range(0, m, R):
        b = min(m, a + R)
        r, q, c = cand_rows[a:b], queries[a:b], candidates[a:b]
        if b - a < R:
            pad = R - (b - a)
            r = torch.cat([r, r.new_zeros((pad,) + tuple(r.shape[1:]))])
            q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
            c = torch.cat([c, c.new_full((pad, c.shape[1]), -1)])
        v, i = _refine_rows(r, q, c, k, metric)
        vals.append(v[:b - a])
        ids.append(i[:b - a])
    return torch.cat(vals), torch.cat(ids)


def _fused_refine_wanted(dataset, queries, candidates, k: int) -> bool:
    """True when the fused gather-refine kernel serves this call. The
    memory guard's decline (or a ``refine.mem_guard`` force fault) counts
    one ``degrade.steps`` move to the gather tier, as in the JAX
    package. ``RAFT_TPU_PALLAS_REFINE`` (auto | on | off, the JAX
    package's tri-state): "off" takes the gather tier, "on" the kernel at
    every shape its k and C gates admit (auto asks C ≥ 400 or a 1 GB
    gather buffer)."""
    if not isinstance(dataset, torch.Tensor) or dataset.dim() != 2:
        return False
    if dataset.dtype not in (torch.float32, torch.bfloat16):
        return False
    m, C = candidates.shape
    d = dataset.shape[1]
    itemsize = dataset.element_size()
    mem_ok = ic.gather_refine_mem_ok(dataset.shape[0], d, itemsize, m=m,
                                     C=C, row_align=1)
    if _faults.forced("refine.mem_guard"):  # CI-testable decline path
        mem_ok = False
    if not mem_ok:
        _degrade.note_step("refine", "pallas_gather", "xla_gather",
                           "mem_guard")
        return False
    force = _obs_spans.env_tristate("RAFT_TPU_PALLAS_REFINE")
    if (force == "off" or k > _k.GATHER_REFINE_MAX_K
            or C < 2 * _k.LUT_SCAN_LANES):
        return False
    return force == "on" or C >= 400 or m * C * d * itemsize >= (1 << 30)


def _refine_fused(dataset, queries, candidates, k: int, mt: DistanceType,
                  filter_bits=None):
    met = ("ip" if mt == DistanceType.InnerProduct
           else "cos" if mt == DistanceType.CosineExpanded else "l2")
    with span("fused_scan") as sp:
        keys, ids = _k.gather_refine_topk(
            dataset.contiguous(), queries.float().contiguous(),
            candidates.to(torch.int32).contiguous(), k, met,
            filter_bits=filter_bits)
        out = _gather_keys_to_dists(keys, ids, mt.value)
        sp.attach(out)
    return out


@traced("raft_tpu_torch.refine")
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


def _check_rows_query(rows_shape, candidates, queries) -> None:
    expects(rows_shape is not None and len(rows_shape) == 3
            and tuple(rows_shape[:2]) == tuple(candidates.shape)
            and rows_shape[2] == queries.shape[1],
            "cand_rows shape %s does not match candidates %s × dim %d",
            tuple(rows_shape) if rows_shape is not None else None,
            tuple(candidates.shape), queries.shape[1])


def _check_base_dim(base, queries) -> None:
    shape = getattr(base, "shape", None)
    expects(shape is not None and len(shape) == 2
            and shape[1] == queries.shape[1],
            "dataset/queries feature-dim mismatch: dataset shape %s vs "
            "%d-dim queries", tuple(shape) if shape else None,
            queries.shape[1])


def _f32_view(host_base):
    """A CPU tensor sharing a C-contiguous f32 numpy base's memory (for
    ``torch.index_select``'s threaded gather); None for other bases."""
    if (isinstance(host_base, np.ndarray) and host_base.dtype == np.float32
            and host_base.flags.c_contiguous):
        with warnings.catch_warnings():  # read-only memmaps
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(host_base)
    return None


def host_gather_rows(host_base, safe: np.ndarray, out=None) -> torch.Tensor:
    """Rows ``safe`` (ids already clipped to [0, n − 1]) of a host base as
    an f32 CPU tensor (into ``out`` when given): ``torch.index_select``
    over the f32 view of a C-contiguous f32 base (threaded), else numpy's
    fancy indexing and an exact f32 conversion — the JAX package's gather,
    bit for bit either way."""
    view = _f32_view(host_base)
    if view is not None:
        idx = torch.from_numpy(safe.astype(np.int64, copy=False))
        if out is None:
            return torch.index_select(view, 0, idx)
        return torch.index_select(view, 0, idx, out=out)
    rows = torch.from_numpy(np.asarray(host_base[safe], np.float32))
    return rows if out is None else out.copy_(rows)


def _host_ids(candidates) -> np.ndarray:
    if isinstance(candidates, torch.Tensor):
        return candidates.detach().cpu().numpy()
    return np.asarray(candidates)


@traced("raft_tpu_torch.refine_landed")
def refine_landed(cand_rows, queries, candidates, k: int,
                  metric="sqeuclidean", device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank against candidate rows ALREADY LANDED on the device — the
    tiered prefetch pipeline's re-rank entry: the ``[m, C, d]`` f32 rows
    were gathered on the host by the reader thread (bit for bit
    :func:`refine_gathered`'s gather) and copied ahead of time, so this
    runs only the exact epilogue."""
    dev = resolve_device(device)
    _precision.enforce()
    queries = to_device(queries, dev, torch.float32)
    candidates = to_device(candidates, dev)
    _check_candidates(queries, candidates, k)
    _check_rows_query(getattr(cand_rows, "shape", None), candidates, queries)
    _obs_spans.count_dispatch("refine", "tiered_prefetch")
    rows = to_device(cand_rows, dev, torch.float32)
    return _refine_rows_blocked(rows, queries, candidates, k,
                                resolve_metric(metric).value)


@traced("raft_tpu_torch.refine_gathered")
def refine_gathered(host_base, queries, candidates, k: int,
                    metric="sqeuclidean", dequant=None, device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank against a HOST-resident (possibly memmapped) dataset: gather
    only each query's candidate rows on the host — O(m·C·d) pages touched,
    never the whole base — then re-rank on ``device`` (reference: the host
    refine path, detail/refine_host-inl.hpp). The gather clips ids to
    [0, n − 1] and converts the rows to f32; invalid ids (< 0) are masked
    out of the ranking.

    ``dequant=(scale, zero)``: ``host_base`` holds int8 scalar-quantized
    rows (x ≈ zero + scale·code, per dim), a 4× smaller refine file."""
    dev = resolve_device(device)
    _precision.enforce()
    queries = to_device(queries, dev, torch.float32)
    _check_base_dim(host_base, queries)
    cand = _host_ids(candidates)
    _check_candidates(queries, cand, k)
    _obs_spans.count_dispatch("refine", "host_gather")
    safe = np.clip(cand, 0, host_base.shape[0] - 1)
    rows = host_gather_rows(host_base, safe.reshape(-1)).view(
        cand.shape[0], cand.shape[1], host_base.shape[1])
    if dequant is not None:
        scale, zero = dequant
        rows = torch.from_numpy(
            rows.numpy() * np.asarray(scale)[None, None, :]
            + np.asarray(zero)[None, None, :])
    return _refine_rows_blocked(to_device(rows, dev, torch.float32),
                                queries, to_device(cand, dev), k,
                                resolve_metric(metric).value)


@traced("raft_tpu_torch.refine_provider")
def refine_provider(provider, queries, candidates, k: int,
                    metric="sqeuclidean", device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank against a device-chunk provider
    (``bench.dataset.DeviceSyntheticChunks``): regenerate each generation
    block on the provider's device and gather the candidate rows out of
    it — an exact f32 re-rank with no host traffic beyond the ids. Cost
    is one generation pass over the blocks that hold candidates."""
    dev = resolve_device(device)
    _precision.enforce()
    queries = to_device(queries, dev, torch.float32)
    _check_base_dim(provider, queries)
    cand = _host_ids(candidates)
    _check_candidates(queries, cand, k)
    _obs_spans.count_dispatch("refine", "provider_regen")
    m, C = cand.shape
    n, d = provider.shape
    c = provider.chunk_rows
    n_blocks = -(-n // c)
    safe = np.clip(cand.reshape(-1), 0, n - 1)
    block_of = safe // c
    order = np.argsort(block_of, kind="stable")
    starts = np.searchsorted(block_of[order], np.arange(n_blocks + 1))
    buf = torch.zeros((m * C, d), dtype=torch.float32, device=dev)
    for bi in range(n_blocks):
        sel = order[starts[bi]:starts[bi + 1]]
        if sel.size == 0:
            continue
        blk = provider._block(bi).to(dev)
        lidx = torch.from_numpy((safe[sel] - bi * c).astype(np.int64))
        buf[torch.from_numpy(sel.astype(np.int64)).to(dev)] = \
            blk[lidx.to(dev)].float()
    return _refine_rows_blocked(buf.view(m, C, d), queries,
                                to_device(cand, dev), k,
                                resolve_metric(metric).value)


def _is_provider(dataset) -> bool:
    return hasattr(dataset, "_block") and hasattr(dataset, "chunk_rows")


def route_refined(search, index, queries: torch.Tensor, k: int, params,
                  dataset, device, filter_bitset=None):
    """``refine="f32_regen"`` of an IVF index: ``search`` (the index's own,
    with ``refine="none"``) scans k·refine_ratio candidates, then the exact
    re-rank routed by what ``dataset`` is (the JAX package's
    ``_route_refined``):

    - a device-chunk provider → :func:`refine_provider`;
    - a tensor on the index's device → :func:`refine`, which gets the
      filter too (one word a candidate, as in the JAX package);
    - anything else (a numpy array or memmap, or a tensor elsewhere, as
      its host copy) → the tiered prefetch path when
      ``tiered.tiered_refine_wanted`` takes it, else
      :func:`refine_gathered`.

    ``params.refine_transfer`` ("auto" | "tiered" | "serial") steers the
    host tiers."""
    expects(params.refine == "f32_regen",
            "unknown refine mode %r (supported: 'none', 'f32_regen')",
            params.refine)
    expects(dataset is not None,
            "refine='f32_regen' needs search(..., dataset=...): the exact "
            "rows to re-rank against")
    dshape = getattr(dataset, "shape", None)
    expects(dshape is not None and len(dshape) == 2
            and dshape[1] == index.dim,
            "refine dataset shape %s does not match the index dim %d",
            tuple(dshape) if dshape else None, index.dim)
    expects(params.refine_ratio >= 1.0, "refine_ratio must be >= 1 (got %s)",
            params.refine_ratio)
    k_cand = max(k, int(round(k * params.refine_ratio)))
    scan_params = dataclasses.replace(params, refine="none")

    provider = _is_provider(dataset)
    resident = (isinstance(dataset, torch.Tensor)
                and dataset.device == index.device)
    if not (provider or resident):
        from raft_tpu_torch.neighbors import tiered as _tiered
        from raft_tpu_torch.serve import placement

        dataset = placement.to_host(dataset)
        if _tiered.tiered_refine_wanted(dataset, queries.shape[0], k_cand,
                                        index.dim, params):
            return _tiered.search_refined_tiered(
                search, index, queries, k, k_cand, scan_params,
                filter_bitset, dataset, index.metric, device=device)
    _, i0 = search(index, queries, k_cand, scan_params,
                   filter_bitset=filter_bitset, device=device)
    if provider:
        return refine_provider(dataset, queries, i0, k, metric=index.metric,
                               device=device)
    if resident:
        return refine(dataset, queries, i0, k, metric=index.metric,
                      filter_bits=filter_bitset, device=device)
    return refine_gathered(dataset, queries, i0, k, metric=index.metric,
                           device=device)
