"""Sharded IVF-PQ over a mesh of ranks — distributed build and search
(counterpart of the IVF-PQ half of ``raft_tpu.parallel.ivf``).

- **coarse centers**: one distributed Lloyd (``cluster.distributed.fit``)
  over the row-sharded dataset, so every shard's lists follow the global
  data distribution;
- **rotation and codebooks**: replicated, trained on a sample drawn
  uniformly from the global real rows (each rank contributes the rows it
  owns, an allreduce assembles the sample); codebook training sees at
  most 65,536 of its rows, as the single-device build's does;
- **encode and pack**: per rank, on the rank's device; the stored ids
  are global row ids (the shard offset baked in), so search needs no
  translation;
- **search**: queries replicated; each rank scans its lists (the
  per_query tier, or with ``refine="f32_regen"`` the oversampled scan
  through ``ivf_pq.search`` and the exact re-rank against its own rows),
  then the cross-shard merge of ``parallel.merge``. For small unrefined
  batches on the LUT-bin tier the scan folds into the ring
  (``ops.kernels.ring_lut_scan_merge``): the per-shard [m, k] table never
  exists.

A filter (``filter_bitset``, packed words over GLOBAL row ids,
replicated) composes with each shard's id table, whose ids are global:
the fused ring reads each rank's keep bytes over its own table, the
per_query tier and the refined scan take the bitset itself, and the
per-rank re-rank of the refined path takes none (its candidates are
already kept ones). Sharded IVF-Flat is not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.cluster import distributed as dkm
from raft_tpu_torch.cluster.kmeans import KMeansParams
from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core.device import to_device
from raft_tpu_torch.core.errors import expects, not_ported
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin
from raft_tpu_torch.distance.types import (SELECT_MIN, DistanceType,
                                           resolve_metric)
from raft_tpu_torch.neighbors import ivf_common as ic
from raft_tpu_torch.neighbors import ivf_pq as _pq
from raft_tpu_torch.neighbors import sample_filter as _sf
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.parallel import merge as _merge
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.parallel.mesh import Mesh, replicate, shard_rows
from raft_tpu_torch.random.rng import RngState
from raft_tpu_torch.utils import precision as _precision

# Codebook training rows at most (the single-device build's
# max_codebook_rows).
_CODEBOOK_ROWS = 1 << 16


@dataclasses.dataclass
class ShardedIvfPq:
    """IVF-PQ index sharded over a mesh: one tensor per rank for every
    field, the quantizers replicated (ranks on one device share them),
    the packed lists the rank's own."""

    centers: List[torch.Tensor]        # [n_lists, dim] replicated
    centers_rot: List[torch.Tensor]    # [n_lists, rot_dim] replicated
    rotation: List[torch.Tensor]       # [rot_dim, dim] replicated
    codebooks: List[torch.Tensor]      # [pq_dim, K, pq_len] replicated
    packed_codes: List[torch.Tensor]   # [n_lists, L, nb] u8 per rank
    packed_ids: List[torch.Tensor]     # [n_lists, L] global ids, -1 pad
    packed_norms: List[torch.Tensor]   # [n_lists, L] f32
    list_sizes: List[torch.Tensor]     # [n_lists] i32
    mesh: Mesh
    metric: str = "sqeuclidean"
    pq_bits: int = 8
    pq_dim: int = 0
    # rows per shard of the padded build dataset: packed ids are
    # rank·shard_rows + local (0 = unknown)
    shard_rows: int = 0
    global_list_cap: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.packed_codes)

    @property
    def n_lists(self) -> int:
        return self.centers[0].shape[0]

    @property
    def dim(self) -> int:
        return self.centers[0].shape[1]

    @property
    def max_list_size(self) -> int:
        return self.packed_ids[0].shape[1]

    @property
    def size(self) -> int:
        return int(sum(int(s.sum()) for s in self.list_sizes))

    def local(self, r: int) -> _pq.IvfPqIndex:
        """Rank r's shard as a single-device index."""
        return _pq.IvfPqIndex(
            centers=self.centers[r], centers_rot=self.centers_rot[r],
            rotation=self.rotation[r], codebooks=self.codebooks[r],
            packed_codes=self.packed_codes[r], packed_ids=self.packed_ids[r],
            packed_norms=self.packed_norms[r], list_sizes=self.list_sizes[r],
            metric=self.metric, codebook_kind="per_subspace",
            pq_bits=self.pq_bits, pq_dim_static=self.pq_dim)


_REPLICATED = ("centers", "centers_rot", "rotation", "codebooks")
_SHARDED = ("packed_codes", "packed_ids", "packed_norms", "list_sizes")


def from_numpy(arrays: Dict[str, np.ndarray], meta: Dict, mesh: Mesh
               ) -> ShardedIvfPq:
    """Index from the JAX ``ShardedIvfPq``'s fields as numpy arrays (the
    packed ones with their leading shard axis) and its static fields
    (``meta``: metric, pq_bits, pq_dim, shard_rows, global_list_cap)."""
    n_dev = np.asarray(arrays["packed_codes"]).shape[0]
    expects(n_dev == mesh.size, "index of %d shards on a %d-rank mesh",
            n_dev, mesh.size)
    pq_dim = int(meta.get("pq_dim", 0))
    pq_bits = int(meta.get("pq_bits", 8))
    expects(np.asarray(arrays["packed_codes"]).shape[-1]
            == _pq.packed_nbytes(pq_dim, pq_bits),
            "folded code storage is not ported (ROADMAP A9)")
    dev0 = mesh.devices[0]
    fields = {name: replicate(to_device(np.asarray(arrays[name]), dev0),
                              mesh) for name in _REPLICATED}
    for name in _SHARDED:
        a = np.asarray(arrays[name])
        fields[name] = [to_device(a[r], d) for r, d in enumerate(mesh.devices)]
    return ShardedIvfPq(**fields, mesh=mesh, metric=str(meta["metric"]),
                        pq_bits=pq_bits, pq_dim=pq_dim,
                        shard_rows=int(meta.get("shard_rows", 0)),
                        global_list_cap=int(meta.get("global_list_cap", 0)))


def to_numpy(index: ShardedIvfPq) -> Tuple[Dict[str, np.ndarray], Dict]:
    """(arrays, meta) — the inverse of :func:`from_numpy`."""
    arrays = {name: getattr(index, name)[0].cpu().numpy()
              for name in _REPLICATED}
    for name in _SHARDED:
        arrays[name] = np.stack([t.cpu().numpy()
                                 for t in getattr(index, name)])
    meta = {"metric": index.metric, "pq_bits": index.pq_bits,
            "pq_dim": index.pq_dim, "shard_rows": index.shard_rows,
            "global_list_cap": index.global_list_cap}
    return arrays, meta


def _coarse_centers(n_lists: int, n_iters: int, seed: int, x: torch.Tensor,
                    mesh: Mesh, spherical: bool) -> torch.Tensor:
    """Distributed Lloyd over the (unpadded) rows; spherical metrics
    re-normalize the centers."""
    km = KMeansParams(n_clusters=n_lists, max_iter=n_iters, seed=seed)
    centers, _, _ = dkm.fit(km, x, mesh)
    if spherical:
        centers = centers / torch.sqrt(
            (centers * centers).sum(-1, keepdim=True).clamp_min(1e-12))
    return centers


def _gather_trainset(shards: Sequence[torch.Tensor], mesh: Mesh, t: int,
                     seed: int, n_real: int) -> List[torch.Tensor]:
    """Replicated codebook sample: ``n_dev·t`` global row ids drawn
    uniformly (with replacement) from the real rows, every ``stride``-th
    kept so at most 65,536 remain; each rank contributes the rows it owns
    (zeros elsewhere) and an allreduce assembles the sample, so pad rows
    never reach codebook training."""
    n_dev = mesh.size
    total = n_dev * t
    gidx = torch.randint(0, n_real, (total,),
                         generator=RngState(seed).generator(),
                         dtype=torch.int64)
    gidx = gidx[::max(1, -(-total // _CODEBOOK_ROWS))]
    comms = Comms(mesh)
    contrib = []
    for r in comms.get_rank():
        x_r = shards[r]
        shard_n = x_r.shape[0]
        loc = _ids.local_ids(gidx.to(x_r.device), r, shard_n)
        owned = (loc >= 0) & (loc < shard_n)
        rows = x_r[loc.clamp(0, shard_n - 1)]
        contrib.append(torch.where(owned[:, None], rows,
                                   torch.zeros_like(rows)))
    return comms.allreduce(contrib)


def build_ivf_pq(params: _pq.IndexParams, dataset, mesh: Mesh,
                 axis: str = "shard") -> ShardedIvfPq:
    """Distributed IVF-PQ build over the dataset row-sharded across the
    mesh: global coarse centers, replicated rotation and per_subspace
    codebooks, per-rank encode and pack with global ids."""
    _precision.enforce()
    mt = resolve_metric(params.metric)
    expects(params.codebook_kind == "per_subspace",
            "distributed build supports per_subspace codebooks")
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    _merge.resolve_exchange(mesh, axis)
    dev0 = mesh.devices[0]
    x = to_device(dataset, dev0, torch.float32)
    n, dim = x.shape
    n_dev = mesh.size
    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    if mt == DistanceType.CosineExpanded:
        x = x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))
    pq_dim = params.pq_dim or _pq._default_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    rot_dim = pq_dim * pq_len
    K = 1 << params.pq_bits
    n_lists = params.n_lists

    # 1. global coarse centers (dkm.fit zero-weights its own padding)
    centers = _coarse_centers(n_lists, params.kmeans_n_iters, params.seed, x,
                              mesh, spherical)
    shards, n_real = shard_rows(x, mesh)
    shard_n = shards[0].shape[0]

    # 2. rotation + codebooks on a replicated cross-shard sample
    state = RngState(params.seed)
    rotation = _pq.make_rotation_matrix(state.fold(1), rot_dim, dim, dev0)
    centers_rot = centers @ rotation.T
    t = min(shard_n, max(int(shard_n * params.kmeans_trainset_fraction),
                         -(-4 * K // n_dev), 256))
    expects(t * n_dev >= K,
            "trainset too small for pq_bits=%d: %d < %d codebook entries",
            params.pq_bits, t * n_dev, K)
    trainset = _gather_trainset(shards, mesh, t, params.seed, n_real)[0]
    _, tr_labels = fused_l2_nn_argmin(trainset, centers)
    tr_res = trainset @ rotation.T - centers_rot[tr_labels.long()]
    sub = tr_res.view(-1, pq_dim, pq_len).transpose(0, 1).contiguous()
    codebooks = _pq._vmapped_lloyd(sub, K, params.kmeans_n_iters,
                                   state.fold(2))
    del trainset, tr_res, sub

    # 3. per-rank encode + pack (global ids baked in)
    avg = max(1, shard_n // n_lists)
    L = max(8, -(-int(avg * params.list_size_cap_factor) // 8) * 8)
    rep = {name: replicate(v, mesh) for name, v in (
        ("centers", centers), ("centers_rot", centers_rot),
        ("rotation", rotation), ("codebooks", codebooks))}
    out = {name: [] for name in _SHARDED}
    dropped = 0
    for r, dev in enumerate(mesh.devices):
        x_r = shards[r]
        # global ids in the policy dtype of the mesh's row count:
        # rank·shard_n overflows int32 past 2³¹ rows
        gid = _ids.global_ids(r, shard_n, _ids.make_ids(shard_n, device=dev),
                              n_total=n_dev * shard_n)
        _, labels = fused_l2_nn_argmin(x_r, rep["centers"][r])
        labels = torch.where(gid < n_real, labels.long(),
                             torch.full_like(labels, n_lists, dtype=torch.long))
        safe = labels.clamp(0, n_lists - 1)
        codes, norms = _pq._encode_with_norms(
            x_r, rep["rotation"][r], rep["centers_rot"][r], safe,
            rep["codebooks"][r])
        codes_p = _pq.pack_bits(codes, params.pq_bits)
        del codes
        (pcodes, pnorms), pids, sizes, n_drop, _ = ic.pack_lists(
            [codes_p, norms], labels, gid, n_lists=n_lists, L=L,
            fill_values=[0, 0.0])
        del codes_p, norms
        dropped += n_drop
        out["packed_codes"].append(pcodes)
        out["packed_ids"].append(pids)
        out["packed_norms"].append(pnorms)
        out["list_sizes"].append(sizes)
    if dropped:
        warnings.warn(f"sharded ivf_pq build: dropped {dropped} overflow "
                      "vectors (raise list_size_cap_factor)", RuntimeWarning,
                      stacklevel=2)
    return ShardedIvfPq(**rep, **out, mesh=mesh, metric=mt.value,
                        pq_bits=params.pq_bits, pq_dim=pq_dim,
                        shard_rows=shard_n)


# ---------------------------------------------------------------------------
# the fused scan-in-ring tier
# ---------------------------------------------------------------------------

def _ring_fused_wanted(index: ShardedIvfPq, m: int, k: int, n_probes: int,
                       n_dev: int, whole_mesh: bool, merge: str,
                       mt: DistanceType, lut_dtype: str, scan_select: str,
                       filtered: bool = False, n_cards: int = 1
                       ) -> Tuple[bool, str]:
    """Dispatch of the fused scan-in-ring tier: ``(take_it, reason)``, the
    reason non-empty when the tier was wanted but declined (counted under
    ``parallel.merge.fallback``). The JAX package's rules:
    ``RAFT_TPU_RING_FUSED`` auto | on | off (auto: on a card, where the
    ring kernel would carry the merge); declined for ``scan_select``
    other than "pallas" (or "approx" at n_probes ≥ 64 or k ≥ 400), for
    cosine, for int64 ids, for latency-bound shapes (auto only) and where
    :func:`~raft_tpu_torch.ops.kernels.ring_lut_scan_kernel_ok` refuses
    the shape or the ranks span several cards (``n_cards``; ROADMAP A15),
    and, ``filtered``, where ``filtered_scan_mem_ok`` refuses the ranks'
    keep bytes ("mem_guard")."""
    force = _obs_spans.env_tristate("RAFT_TPU_RING_FUSED")
    if force == "off" or merge == "allgather":
        return False, ""
    if force != "on" and not (_k._on_cuda() and whole_mesh):
        return False, ""
    if not (scan_select == "pallas"
            or (scan_select == "approx" and (n_probes >= 64 or k >= 400))):
        return False, "scan_select"
    if mt not in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                  DistanceType.InnerProduct):
        return False, "metric"
    if any(t.dtype == torch.int64 for t in index.packed_ids):
        return False, "id_width"
    if force != "on" and not _merge.ring_auto_wanted(m, k, n_dev):
        return False, "latency_bound"
    mc = _k.ring_chunk_rows(m, n_dev)
    NS = min(mc * n_probes, index.n_lists)
    nb = (index.pq_dim * index.pq_bits + 7) // 8
    Wb = index.packed_codes[0].shape[2]
    ok = _k.ring_lut_scan_kernel_ok(
        index.pq_dim, 1 << index.pq_bits, index.codebooks[0].shape[2], nb, Wb,
        mc, NS, k, n_dev, index.centers_rot[0].shape[1], lut_dtype=lut_dtype,
        filtered=filtered)
    if not ok or n_cards > 1:
        return False, "kernel_ineligible"
    if filtered and not ic.filtered_scan_mem_ok(
            index.n_lists, index.packed_ids[0].shape[1]):
        return False, "mem_guard"
    return True, ""


def _chunk_unions(pc: torch.Tensor, NS: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per ring chunk, the sorted union of probed lists and the membership
    indicator: ``pc [n_dev, mc, n_probes]`` → (lists [n_dev, NS] i32, −1
    pad; ind [n_dev, NS, mc] f32 0/1). NS = min(mc·n_probes, n_lists)
    bounds the distinct count, so no list is lost."""
    n_dev, mc, _ = pc.shape
    lists = torch.full((n_dev, NS), -1, dtype=torch.int32, device=pc.device)
    ind = torch.zeros((n_dev, NS, mc), dtype=torch.float32, device=pc.device)
    for c in range(n_dev):
        u = torch.unique(pc[c].reshape(-1).to(torch.int32))   # sorted
        lists[c, :u.numel()] = u
        ind[c, :u.numel()] = (pc[c][None, :, :] == u[:, None, None]).any(
            2).float()
    return lists, ind


def _fused_ring_operands(index: ShardedIvfPq, q: torch.Tensor,
                         n_probes: int, mesh: Mesh, ip_like: bool):
    """The per-rank operands of ``ring_lut_scan_merge`` for queries ``q``
    (padded to n_dev chunks): probes and chunk unions computed once on
    rank 0's device (replicated operands give the same probes on every
    rank) and replicated, then each rank's shard."""
    m = q.shape[0]
    n_dev = index.n_shards
    mc = _k.ring_chunk_rows(m, n_dev)
    mq = mc * n_dev
    NS = min(mc * n_probes, index.n_lists)
    qp = torch.nn.functional.pad(q, (0, 0, 0, mq - m)) if mq > m else q
    _, probes = _pq._coarse_probes(index.local(0), qp, n_probes, ip_like)
    q_rot = qp @ index.rotation[0].T
    lists, ind = _chunk_unions(probes.view(n_dev, mc, n_probes), NS)
    qv = q_rot.view(n_dev, mc, q_rot.shape[1]).contiguous()
    return (replicate(lists, mesh), replicate(ind, mesh),
            replicate(qv, mesh), index.packed_codes, index.packed_ids,
            index.packed_norms, index.list_sizes, index.centers_rot,
            index.codebooks)


def _search_fused_ring(index: ShardedIvfPq, q: torch.Tensor, k: int,
                       n_probes: int, mesh: Mesh, lut_dtype: str,
                       mt: DistanceType, filter_bits=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused scan-in-ring search: probes and chunk unions, the fused
    kernel over every rank, then the LUT-key → metric epilogue. With
    ``filter_bits`` (global row ids) each rank's keep bytes come from its
    own id table, whose ids are global, so one test composes the
    replicated bitset with the shard's rows."""
    m = q.shape[0]
    n_dev = index.n_shards
    mc = _k.ring_chunk_rows(m, n_dev)
    ip_like = mt == DistanceType.InnerProduct
    dev0 = mesh.devices[0]
    ops = _fused_ring_operands(index, q, n_probes, mesh, ip_like)
    # the kernel reads its neighbour's block through a pointer: count the
    # hops as the ring merge does (the fusion moves compute, not bytes)
    Comms(mesh).count_ring_topk(n_dev - 1, ((mc, k), torch.float32),
                                ((mc, k), torch.int32))
    fbytes = (None if filter_bits is None else
              [_sf.list_filter_bytes(filter_bits, ids)
               for ids in index.packed_ids])
    kv, ki = _k.ring_lut_scan_merge(
        *ops, k, "ip" if ip_like else "l2", pq_bits=index.pq_bits,
        pq_dim=index.pq_dim, L=index.max_list_size, lut_dtype=lut_dtype,
        filter_bytes=fbytes)
    rv = _merge.assemble(_merge.QUERY_SHARDED, kv, m, dev0)
    ri = _merge.assemble(_merge.QUERY_SHARDED, ki, m, dev0)
    if ip_like:
        dists = torch.where(ri < 0, torch.full_like(rv, float("-inf")), -rv)
    else:
        qr = q @ index.rotation[0].T
        dists = (rv + (qr * qr).sum(1)[:, None]).clamp_min(0.0)
        if mt == DistanceType.L2SqrtExpanded:
            dists = torch.sqrt(dists)
        dists = torch.where(ri < 0, torch.full_like(dists, float("inf")),
                            dists)
    return dists, ri


def _per_rank_topk(params: _pq.SearchParams, index: ShardedIvfPq,
                   q: torch.Tensor, k: int, n_probes: int, mesh: Mesh,
                   dataset=None, filter_bits=None
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each rank's local top-k of the replicated queries, (values, global
    ids) per rank: the per_query tier, or with ``refine="f32_regen"`` the
    oversampled scan through ``ivf_pq.search`` and the exact re-rank
    against the rank's own rows of ``dataset``. ``filter_bits`` (global
    row ids) goes to each rank's scan on the rank's device; the re-rank
    takes none: the scan's candidates are already kept rows."""
    mt = resolve_metric(index.metric)
    n_dev = index.n_shards
    dev0 = mesh.devices[0]
    refined = params.refine != "none"
    if refined:
        from raft_tpu_torch.neighbors import refine as _refine

        expects(dataset is not None,
                "refine=%r needs search(..., dataset=...): the sharded rows "
                "to re-rank against (the build dataset)", params.refine)
        if isinstance(dataset, (list, tuple)):
            # already row-sharded: rank r's rows on rank r's device
            ds_shards = [to_device(x, d, torch.float32)
                         for x, d in zip(dataset, mesh.devices)]
        else:
            ds_shards, _ = shard_rows(to_device(dataset, dev0, torch.float32),
                                      mesh)
        expects(len(ds_shards) == n_dev and all(
            x.dim() == 2 and x.shape[1] == index.dim for x in ds_shards),
            "refine dataset shards do not match the index dim %d", index.dim)
        if mt == DistanceType.CosineExpanded:
            ds_shards = [x / torch.sqrt((x * x).sum(-1, keepdim=True)
                                        .clamp_min(1e-12)) for x in ds_shards]
        shard_n = ds_shards[0].shape[0]
        # the gid → local-row remap holds only for the build's shard
        # geometry: another row count would re-rank the wrong rows
        expects(index.shard_rows == 0 or shard_n == index.shard_rows,
                "refine dataset has %d rows/shard but the index was built "
                "with %d — pass the build dataset", shard_n, index.shard_rows)
        k_cand = max(k, int(round(k * params.refine_ratio)))
        scan_params = dataclasses.replace(params, refine="none")
    qs = replicate(q, mesh)
    fbs = (replicate(filter_bits, mesh) if filter_bits is not None
           else [None] * n_dev)
    vals, gids = [], []
    for r, dev in enumerate(mesh.devices):
        local = index.local(r)
        if refined:
            _, i0 = _pq.search(local, qs[r], k_cand, scan_params,
                               filter_bitset=fbs[r], device=dev)
            li = _ids.local_ids(i0, r, shard_n)
            v, lids = _refine.refine(ds_shards[r], qs[r], li, k,
                                     metric=index.metric, device=dev)
            g = _ids.global_ids(r, shard_n, lids, n_total=n_dev * shard_n)
        else:
            v, g = _pq._search_impl(
                local, qs[r], k, n_probes,
                _pq._fit_query_tile(params.query_tile, n_probes, local),
                lut_dtype=params.lut_dtype, filter_bits=fbs[r])
        vals.append(v)
        gids.append(g)
    return vals, gids


def search_ivf_pq(params: _pq.SearchParams, index: ShardedIvfPq, queries,
                  k: int, mesh: Mesh, axis: Union[str, Sequence[str]] = "shard",
                  dataset=None, merge: str = "auto", filter_bitset=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded IVF-PQ search: per-rank list scan + cross-shard merge
    (``merge`` = auto | allgather | ring). Returns (distances [m, k],
    global ids [m, k]) on rank 0's device.

    With ``params.refine="f32_regen"`` and ``dataset`` (the build
    dataset, which is row-sharded over the mesh, or its per-rank shards as
    ``parallel.mesh.shard_rows`` cuts them) each rank scans
    k·refine_ratio candidates through ``ivf_pq.search`` (the LUT-scan
    kernel tier for ``scan_select="pallas"``) and re-ranks them exactly
    against its own rows, and only its k refined survivors enter the
    merge. Unrefined searches take the fused scan-in-ring tier where
    ``_ring_fused_wanted`` admits them, else the per_query tier per rank
    and the merge. ``filter_bitset`` (packed words over global row ids,
    replicated to every rank) reaches every one of those tiers."""
    _precision.enforce()
    mt = resolve_metric(index.metric)
    select_min = SELECT_MIN[mt]
    n_probes = min(params.n_probes, index.n_lists)
    dev0 = mesh.devices[0]
    filtered = filter_bitset is not None
    if filtered:
        filter_bitset = _bitset.as_words(filter_bitset, dev0)
    q = to_device(queries, dev0, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be [m, %d]", index.dim)
    m = q.shape[0]
    n_dev = index.n_shards
    ax_dev, whole_mesh, hier_axes = _merge.resolve_exchange(mesh, axis)
    expects(n_dev == ax_dev, "index sharded over %d ranks, mesh axis has %d",
            n_dev, ax_dev)
    expects(list(index.mesh.devices) == list(mesh.devices),
            "the index lives on another mesh's devices")
    refined = params.refine != "none"
    if params.lut_dtype == "auto" and not refined:
        params = dataclasses.replace(params, lut_dtype=_pq.resolve_lut_dtype(
            "auto", n_probes, k,
            selectivity=_pq._filter_selectivity(filter_bitset)))
    if not refined:
        fused, reason = _ring_fused_wanted(
            index, m, k, n_probes, n_dev, whole_mesh=whole_mesh, merge=merge,
            mt=mt, lut_dtype=params.lut_dtype, scan_select=params.scan_select,
            filtered=filtered, n_cards=mesh.n_cards)
        if fused:
            _obs_spans.count_dispatch("parallel.merge", "ring_fused_scan")
            _pq._count_scan_dispatch("ring_lut_fused", filtered)
            return _search_fused_ring(index, q, k, n_probes, mesh,
                                      params.lut_dtype, mt,
                                      filter_bits=filter_bitset)
        if reason:
            _obs_spans.count_fallback("parallel.merge", reason)
    tier, impl = _merge.merge_tier(n_dev, m, k, explicit=merge,
                                   whole_mesh=whole_mesh, hier_axes=hier_axes,
                                   n_cards=mesh.n_cards)
    vals, gids = _per_rank_topk(params, index, q, k, n_probes, mesh, dataset,
                                filter_bitset)
    rv, ri = _merge.merge_topk(vals, gids, mesh, m, k, n_dev, select_min,
                               tier=tier, impl=impl)
    spec = _merge.merge_out_spec(tier)
    return (_merge.assemble(spec, rv, m, dev0),
            _merge.assemble(spec, ri, m, dev0))


def build_ivf_flat(*args, **kwargs):
    raise not_ported("sharded IVF-Flat (build_ivf_flat)", "A15")


def search_ivf_flat(*args, **kwargs):
    raise not_ported("sharded IVF-Flat (search_ivf_flat)", "A15")
