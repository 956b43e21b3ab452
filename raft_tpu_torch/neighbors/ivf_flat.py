"""IVF-Flat — inverted-file index over balanced-kmeans clusters, raw
vectors in padded per-list blocks (counterpart of
``raft_tpu.neighbors.ivf_flat``).

The index is one dense ``[n_lists, L, dim]`` block of list rows (+ ids,
−1 padded, + squared norms). Ported here (slice 2 of the port):

- ``build`` for sqeuclidean, euclidean, inner_product and cosine, with
  both assignment branches (``spill=True``: the six nearest centers and
  ``ivf_common.spill_assignments``; ``spill=False``: the nearest center
  and a list size fitted to the histogram) and ``add_data_on_build=False``;
- ``search`` through the per_query tier (the plain semantic anchor) and
  the grouped tiers, whose scans are hand-written kernels:
  ``scan_select="approx"`` the segmented scan (two best per strided bin,
  merged by ``ivf_common.merge_bin_results``), ``scan_select="exact"``
  the grouped scan (exact per-slot top-kk); past the kernels' kk the
  plain grouped tier (``ivf_common.grouped_scan_plain_tier``);
  ``refine="f32_regen"`` against a device-resident dataset, a host one
  (numpy or memmap: the tiered prefetch or the serialized host gather,
  ``neighbors.tiered``) or a device-chunk provider;
- ``search_resilient``, the search behind the degradation ladder
  (``robust.degrade``);
- ``extend``, ``save`` and ``load`` (the JAX package's file format);
- ``from_numpy``/``to_numpy``, which carry an index between the packages.

The JAX package takes the kernel tiers only on a TPU and only when a list
block fits its VMEM budget. The CUDA kernels tile the list and feature
axes, so no list size is too large for them: on the card the segmented
scan runs whenever ``scan_select="approx"`` and kk ≤ 128, the grouped scan
whenever ``scan_select="exact"`` and kk ≤ 64. The same tiers run on the
CPU, each wrapper with its plain version. What is not ported raises
``NotImplementedError`` naming its ROADMAP item.

Filtered search (``filter_bitset``, ``neighbors.sample_filter``): the
per_query tier tests the bitset, the grouped scan and the plain grouped
tier scan a sentinel-masked id table, and the segmented scan declines
filtered searches, as in the JAX package: a filtered approx search takes
the plain grouped tier.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core import serialize as _ser
from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects, not_ported as _not_ported
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import select_k as _select_k
from raft_tpu_torch.neighbors import ivf_common as ic
from raft_tpu_torch.neighbors import sample_filter as _sf
from raft_tpu_torch.neighbors.ivf_common import _fit_list_size, _lane_round
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.robust import degrade as _degrade
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.utils import precision as _precision


@dataclasses.dataclass
class IndexParams:
    """reference: ``ivf_flat::index_params`` (same fields as raft_tpu)."""

    n_lists: int = 1024
    metric: str = "sqeuclidean"
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    add_data_on_build: bool = True
    list_size_cap_factor: float = 4.0  # max_list_size = factor * n/n_lists
    spill: bool = False
    seed: int = 0


@dataclasses.dataclass
class SearchParams:
    """reference: ``ivf_flat::search_params`` (same fields as raft_tpu).

    ``scan_mode``: "grouped" (list-centric batch scan), "per_query", or
    "auto" (grouped once B·n_probes ≥ 2·n_lists). ``scan_select`` picks
    the grouped tier: "exact" the grouped-scan kernel, "approx" the
    segmented-scan kernel. ``list_chunk`` and ``scan_recall`` are kept for
    the JAX package's signature; the kernels read whole segment tables and
    select exactly."""

    n_probes: int = 20
    query_tile: int = 256
    scan_mode: str = "auto"
    list_chunk: int = 64
    scan_select: str = "exact"
    scan_recall: float = 0.95
    refine: str = "none"  # | "f32_regen"
    refine_ratio: float = 2.0
    refine_transfer: str = "auto"


@dataclasses.dataclass
class IvfFlatIndex:
    """Padded-list IVF-Flat index: the JAX package's fields, as tensors on
    one device."""

    centers: torch.Tensor       # [n_lists, dim] f32
    packed_data: torch.Tensor   # [n_lists, L, dim] f32 or bf16
    packed_ids: torch.Tensor    # [n_lists, L] i32, -1 pad
    packed_norms: torch.Tensor  # [n_lists, L] f32 squared norms
    list_sizes: torch.Tensor    # [n_lists] i32
    metric: str = "sqeuclidean"

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def max_list_size(self) -> int:
        return self.packed_data.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


_ARRAY_FIELDS = ("centers", "packed_data", "packed_ids", "packed_norms",
                 "list_sizes")


def _check_data_dtype(dtype) -> None:
    """numpy or torch dtype (or None) of the list data."""
    if str(dtype).rsplit(".", 1)[-1] in ("int8", "uint8"):
        raise _not_ported("int8/uint8 IVF-Flat data (the dp4a path)", "A19")


def from_numpy(arrays: Dict[str, np.ndarray], meta: Dict, device="cuda"
               ) -> IvfFlatIndex:
    """Index from the JAX index's fields as numpy arrays (``arrays``) and
    its static field (``meta["metric"]``)."""
    dev = resolve_device(device)
    _check_data_dtype(np.asarray(arrays["packed_data"]).dtype)
    t = {name: to_device(np.asarray(arrays[name]), dev)
         for name in _ARRAY_FIELDS}
    expects(t["packed_ids"].dtype == torch.int32,
            "packed_ids must be int32 (int64 ids past 2^31 rows are not "
            "ported)")
    return IvfFlatIndex(**t, metric=str(meta["metric"]))


def to_numpy(index: IvfFlatIndex) -> Tuple[Dict[str, np.ndarray], Dict]:
    """(arrays, meta) — the inverse of :func:`from_numpy`. bf16 list data
    comes out as float32 (numpy has no bfloat16)."""
    arrays = {}
    for name in _ARRAY_FIELDS:
        t = getattr(index, name)
        if t.dtype == torch.bfloat16:
            t = t.float()
        arrays[name] = t.cpu().numpy()
    return arrays, {"metric": index.metric}


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def build(dataset, params: Optional[IndexParams] = None, device="cuda",
          stage_seconds: Optional[Dict[str, float]] = None) -> IvfFlatIndex:
    """Build the index on ``device`` (reference: ivf_flat::build):
    balanced-kmeans coarse fit on a trainset subsample, assign every row,
    pack padded lists. ``stage_seconds``, when given, receives the seconds
    of each stage (train, assign, pack)."""
    if params is None:
        params = IndexParams()
    dev = resolve_device(device)
    _precision.enforce()
    mt = resolve_metric(params.metric)
    _check_data_dtype(getattr(dataset, "dtype", None))
    x = to_device(dataset, dev)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    n, d = x.shape
    expects(params.n_lists <= n, "n_lists=%d > n=%d", params.n_lists, n)
    stage = ic.Stages(stage_seconds, dev)

    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric="cosine" if spherical else "l2",
                              seed=params.seed)
    n_train = min(n, max(params.n_lists * 4,
                         int(n * params.kmeans_trainset_fraction)))
    with stage("train"):
        if n_train < n:
            rng = np.random.default_rng(params.seed)
            tr = torch.as_tensor(np.sort(rng.choice(n, n_train, replace=False)),
                                 device=dev)
            trainset = x[tr]
        else:
            trainset = x
        centers = kmeans_balanced.fit(trainset.float(), params.n_lists, km)
        del trainset

    avg = max(1, n // params.n_lists)
    if not params.add_data_on_build:
        L = max(8, int(avg * params.list_size_cap_factor))
        return IvfFlatIndex(
            centers=centers,
            packed_data=torch.zeros((params.n_lists, L, d), dtype=x.dtype,
                                    device=dev),
            packed_ids=torch.full((params.n_lists, L), -1, dtype=torch.int32,
                                  device=dev),
            packed_norms=torch.zeros((params.n_lists, L), device=dev),
            list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32,
                                   device=dev),
            metric=mt.value)

    with stage("assign"):
        if params.spill:
            lk = kmeans_balanced.predict_topk(centers, x, ic.SPILL_DEPTH, km)
            L = _lane_round(int(avg * params.list_size_cap_factor))
            labels = ic.spill_assignments(
                lk[:, 0], lk[:, 1], params.n_lists, L,
                *[lk[:, c] for c in range(2, lk.shape[1])])
            n_marker = int((labels >= params.n_lists).sum())
            if n_marker:
                warnings.warn(f"ivf_flat: {n_marker} rows overflowed every "
                              f"spill choice at cap {L} (raise "
                              "list_size_cap_factor)", RuntimeWarning,
                              stacklevel=2)
        else:
            labels = kmeans_balanced.predict(centers, x, km)
            counts = torch.bincount(labels.long(),
                                    minlength=params.n_lists).cpu().numpy()
            L = _fit_list_size(counts, avg, params.list_size_cap_factor)
    if (n + params.n_lists * L) * d * x.element_size() > (8 << 30):
        raise _not_ported("the chunked pack of wide datasets "
                          "(pack_rows_chunked, above 8 GB)", "A10")
    with stage("pack"):
        (packed,), ids, sizes, n_drop, _ = ic.pack_lists(
            [x], labels, _ids.make_ids(n, device=dev), n_lists=params.n_lists,
            L=L, fill_values=[0])
        norms = (packed.float() ** 2).sum(-1)
    if n_drop:
        warnings.warn(f"ivf_flat: dropped {n_drop} overflow vectors (raise "
                      "list_size_cap_factor"
                      f"{'' if params.spill else ' or set spill=True'})",
                      RuntimeWarning, stacklevel=2)
    return IvfFlatIndex(centers=centers, packed_data=packed, packed_ids=ids,
                        packed_norms=norms, list_sizes=sizes, metric=mt.value)


def build_distributed(*args, **kwargs):
    raise _not_ported("ivf_flat.build_distributed", "A15")


def extend(index: IvfFlatIndex, new_vectors, new_ids=None) -> IvfFlatIndex:
    """Append vectors (reference: ivf_flat::extend): assign them to the
    existing centers and re-pack, the lists grown to the new largest fill
    (rounded up to 8); centers unchanged."""
    mt = resolve_metric(index.metric)
    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    km = KMeansBalancedParams(metric="cosine" if spherical else "l2")
    dev = index.device
    _precision.enforce()
    x = to_device(new_vectors, dev)
    nid = (_ids.make_ids(x.shape[0], device=dev, start=index.size)
           if new_ids is None else to_device(new_ids, dev))
    labels = kmeans_balanced.predict(index.centers, x.float(), km)
    n_lists, L, d = index.packed_data.shape
    old_sizes = index.list_sizes.long()
    need = old_sizes + torch.bincount(labels.long(), minlength=n_lists)
    new_L = max(8, -(-max(L, int(need.max())) // 8) * 8)
    id_dt = (torch.int64 if torch.int64 in (index.packed_ids.dtype, nid.dtype)
             else torch.int32)
    packed = torch.zeros((n_lists, new_L, d), dtype=index.packed_data.dtype,
                         device=dev)
    ids = torch.full((n_lists, new_L), -1, dtype=id_dt, device=dev)
    packed[:, :L] = index.packed_data
    ids[:, :L] = index.packed_ids
    order, sorted_l, slot = ic.stable_slots(labels, n_lists, old_sizes)
    keep = slot < new_L
    rows, ls, sl = order[keep], sorted_l[keep], slot[keep]
    packed[ls, sl] = x[rows].to(packed.dtype)
    ids[ls, sl] = nid[rows].to(id_dt)
    return IvfFlatIndex(centers=index.centers, packed_data=packed,
                        packed_ids=ids,
                        packed_norms=(packed.float() ** 2).sum(-1),
                        list_sizes=need.clamp(max=new_L).to(torch.int32),
                        metric=index.metric)


# reference: neighbors/ivf_flat_serialize.cuh, the JAX package's format
_SERIAL_VERSION = 1


def save(index: IvfFlatIndex, path: str) -> None:
    """Write ``index`` to ``path`` (bf16 list data as ``'<V2'`` records)."""
    _ser.save_arrays(path, "ivf_flat", _SERIAL_VERSION,
                     {"metric": index.metric},
                     {name: getattr(index, name) for name in _ARRAY_FIELDS})


def load(path: str, device="cuda") -> IvfFlatIndex:
    """Read an index written by :func:`save` or by the JAX package's
    ``ivf_flat.save`` onto ``device``."""
    dev = resolve_device(device)
    version, meta, arrays = _ser.load_arrays(path, "ivf_flat")
    expects(version == _SERIAL_VERSION, "unsupported ivf_flat version %d",
            version)
    _check_data_dtype(arrays["packed_data"].dtype)
    t = {name: _ser.to_tensor(arrays[name], dev) for name in _ARRAY_FIELDS}
    return IvfFlatIndex(**t, metric=str(meta["metric"]))


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _coarse_distances(q: torch.Tensor, centers: torch.Tensor,
                      mt: DistanceType):
    """Query→center scores for probe selection, and whether to select the
    smallest."""
    g = q @ centers.T
    if mt == DistanceType.InnerProduct:
        return g, False
    if mt == DistanceType.CosineExpanded:
        qn = torch.sqrt((q * q).sum(1).clamp_min(1e-30))
        cn = torch.sqrt((centers * centers).sum(1).clamp_min(1e-30))
        return 1.0 - g / (qn[:, None] * cn[None, :]), True
    c_sq = (centers * centers).sum(1)
    q_sq = (q * q).sum(1)
    return (q_sq[:, None] + c_sq[None, :] - 2.0 * g).clamp_min(0.0), True


def _probes(index: IvfFlatIndex, q: torch.Tensor, n_probes: int,
            mt: DistanceType) -> torch.Tensor:
    coarse, coarse_min = _coarse_distances(q, index.centers, mt)
    return _select_k(coarse, n_probes, select_min=coarse_min)[1]


def _fit_query_tile(want: int, n_probes: int, index: IvfFlatIndex) -> int:
    """Largest per_query tile ≤ ``want`` whose [t, n_probes, L, d] f32
    candidate gather stays under ~1 GB."""
    L, d = index.max_list_size, index.dim
    return max(1, min(want, (1 << 30) // max(1, n_probes * L * d * 4)))


def _search_impl(index: IvfFlatIndex, queries: torch.Tensor, k: int,
                 n_probes: int, query_tile: int, filter_bits=None):
    """The per_query tier: each query gathers its probed lists and scores
    every candidate — the plain semantic anchor. Filtered candidates are
    invalid ones (``sample_filter.masked_ids``): a slot picked past the
    kept candidates returns −1, where the JAX package returns the slot's
    own id at an infinite distance."""
    mt = resolve_metric(index.metric)
    q_all = queries.float()
    L = index.max_list_size
    probes = _probes(index, q_all, n_probes, mt).long()
    select_min = mt != DistanceType.InnerProduct
    vals, out = [], []
    for a in range(0, q_all.shape[0], query_tile):
        q = q_all[a:a + query_tile]
        probe = probes[a:a + query_tile]
        t = q.shape[0]
        cand = index.packed_data[probe].float().reshape(t, n_probes * L,
                                                        index.dim)
        cand_ids = _sf.masked_ids(
            filter_bits, index.packed_ids[probe].reshape(t, n_probes * L))
        scores = torch.bmm(cand, q[:, :, None])[..., 0]
        if mt == DistanceType.InnerProduct:
            dists, invalid = scores, float("-inf")
        else:
            c_sq = index.packed_norms[probe].reshape(t, n_probes * L)
            if mt == DistanceType.CosineExpanded:
                qn = torch.sqrt((q * q).sum(1).clamp_min(1e-30))
                cn = torch.sqrt(c_sq.clamp_min(1e-30))
                dists = 1.0 - scores / (qn[:, None] * cn)
            else:
                q_sq = (q * q).sum(1)
                dists = (q_sq[:, None] + c_sq - 2.0 * scores).clamp_min(0.0)
                if mt == DistanceType.L2SqrtExpanded:
                    dists = torch.sqrt(dists)
            invalid = float("inf")
        dists = torch.where(cand_ids >= 0, dists,
                            torch.full_like(dists, invalid))
        v, pos = _select_k(dists, k, select_min=select_min)
        vals.append(v)
        out.append(torch.gather(cand_ids, 1, pos.long()))
    return torch.cat(vals), torch.cat(out)


def _scan_metric(mt: DistanceType) -> str:
    return ("ip" if mt == DistanceType.InnerProduct
            else "cos" if mt == DistanceType.CosineExpanded else "l2")


def _search_grouped(index: IvfFlatIndex, queries: torch.Tensor, k: int,
                    n_probes: int, seg: int, n_seg: int, tier: str,
                    seg_chunk: int = 1, filter_bits=None):
    """The list-centric batch scan: probe selection, segmenting, one pass
    over the segment table and the per-query merge. ``tier``: "segk" the
    segmented-scan kernel (merged by ``merge_bin_results``), "kernel" the
    grouped-scan kernel, "plain" the plain grouped tier (the JAX package's
    XLA tier, taken past the kernels' kk; norms from the list rows, as
    there). Every tier scans the id table masked by ``filter_bits``."""
    mt = resolve_metric(index.metric)
    q_all = queries.float().contiguous()
    ip = mt == DistanceType.InnerProduct
    select_min = not ip
    invalid = float("-inf") if ip else float("inf")
    probes = _probes(index, q_all, n_probes, mt)
    seg_list, seg_q, pair_seg, pair_slot = ic.segment_probes(
        probes, index.n_lists, seg, n_seg)
    met = _scan_metric(mt)
    ids = _sf.masked_ids(filter_bits, index.packed_ids)
    if tier == "segk":
        keys, kids = _k.segmented_scan_topk(seg_list, seg_q, q_all,
                                            index.packed_data, ids, met)
        out_vals, out_ids = ic.merge_bin_results(keys, kids, pair_seg,
                                                 pair_slot, k, select_min,
                                                 invalid)
    elif tier == "kernel":
        keys, pos = _k.grouped_scan_topk(seg_list, seg_q, q_all,
                                         index.packed_data, ids,
                                         min(k, index.max_list_size), met)
        vals, cids = ic.grouped_kernel_results(keys, pos, seg_list, ids, ip)
        out_vals, out_ids = ic.merge_slot_results(vals, cids, pair_seg,
                                                  pair_slot, k, select_min,
                                                  invalid)
    else:
        out_vals, out_ids = ic.grouped_scan_plain_tier(
            seg_list, seg_q, pair_seg, pair_slot, q_all,
            lambda sl: index.packed_data[sl].float(), ids, k, met, seg_chunk)
    if mt == DistanceType.L2SqrtExpanded:
        out_vals = torch.sqrt(out_vals)
    return out_vals, out_ids


def search(index: IvfFlatIndex, queries, k: int,
           params: Optional[SearchParams] = None, filter_bitset=None,
           dataset=None, *, mesh=None, device="cuda"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference: ivf_flat::search) → (distances [m, k], ids [m, k]
    int32; −1 marks slots beyond the valid candidates). ``filter_bitset``:
    a packed bitset over dataset rows; rows whose bit is clear are never
    returned."""
    if params is None:
        params = SearchParams()
    dev = resolve_device(device)
    _precision.enforce()
    if mesh is not None:
        raise _not_ported("sharded IVF-Flat search (mesh=)", "A15")
    expects(index.device.type == dev.type,
            "index lives on %s, search asked for %s", index.device, dev)
    filtered = filter_bitset is not None
    if filtered:
        filter_bitset = _bitset.as_words(filter_bitset, index.device)
    q = to_device(queries, index.device, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be [m, %d]", index.dim)
    _faults.faultpoint("ivf_flat.search")
    if params.refine != "none":
        from raft_tpu_torch.neighbors import refine as _refine

        return _refine.route_refined(search, index, q, k, params, dataset,
                                     device, filter_bitset=filter_bitset)
    n_probes = min(params.n_probes, index.n_lists)
    B = q.shape[0]
    mode = params.scan_mode
    if mode == "auto":
        mode = ("grouped" if B * n_probes >= 2 * index.n_lists
                else "per_query")
    if mode == "grouped":
        seg = ic.SEGMENT_SIZE
        pairs = B * n_probes
        n_seg = ic.n_segments(pairs, index.n_lists, seg)
        L = index.max_list_size
        kk = min(k, L)
        if params.scan_mode == "grouped" or ic.grouped_mem_ok(
                n_seg, seg, kk, pairs):
            # the CUDA scans tile L and d, so unlike the TPU kernels no list
            # block is too large for them: only kk decides the tier. The
            # segmented scan declines filtered searches, as in the JAX
            # package (ivf_flat.py:725), which has no filtered segk here
            tier = ic.grouped_tier(params.scan_select == "approx", kk)
            if filtered and tier == "segk":
                tier = "plain"
            return _search_grouped(
                index, q, k, n_probes, seg, n_seg, tier,
                ic.fit_seg_chunk(seg, L, index.dim, params.list_chunk),
                filter_bits=filter_bitset)
    return _search_impl(index, q, k, n_probes,
                        _fit_query_tile(params.query_tile, n_probes, index),
                        filter_bits=filter_bitset)


def search_resilient(index: IvfFlatIndex, queries, k: int,
                     params: Optional[SearchParams] = None,
                     filter_bitset=None, dataset=None, deadline=None, *,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`search` behind the standard degradation ladder
    (:mod:`raft_tpu_torch.robust.degrade`, the wiring of
    ``ivf_pq.search_resilient`` without the LUT rungs — IVF-Flat has no
    LUT to quantize): a RESOURCE_EXHAUSTED walks halve batch → demote raw
    → decline fused tier → host gather (then keeps halving), counted in
    ``degrade.steps{site=ivf_flat.search,...}``. ``deadline`` is the
    request's shared wall-clock budget."""
    if params is None:
        params = SearchParams()
    resolve_device(device)
    q = to_device(queries, index.device, torch.float32)

    def search_fn(index, queries, k, params, filter_bitset, dataset):
        return search(index, queries, k, params, filter_bitset, dataset,
                      device=device)

    return _degrade.run_with_degradation(
        _degrade.batched_search_call(search_fn, index, q, k, filter_bitset,
                                     deadline=deadline,
                                     site="ivf_flat.search"),
        {"params": params, "dataset": dataset},
        _degrade.standard_search_ladder(q.shape[0], has_lut=False),
        site="ivf_flat.search", deadline=deadline)
