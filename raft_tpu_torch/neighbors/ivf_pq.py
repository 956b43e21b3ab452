"""IVF-PQ — inverted-file index with product-quantized residuals
(counterpart of ``raft_tpu.neighbors.ivf_pq``).

The asymmetric distance decomposes as
    ‖q − (c + d)‖² = ‖q‖² − 2⟨q, c⟩ − 2⟨q, d⟩ + ‖c + d‖²
with ‖c + d‖² precomputed per candidate at build and ⟨q, d⟩ = Σ_s
LUT[s, code_s] from a query-only look-up table.

Ported: ``build`` with balanced k-means coarse centers, a random
rotation, per_subspace or per_cluster codebooks (one codebook a list,
``[n_lists, 2^bits, pq_len]``, trained over the list's residual
sub-vectors of every subspace), bit-packed 4–8-bit codes, ``spill``,
``add_data_on_build=False`` and the bf16 reconstruction cache
(``packed_recon``: c + decoded residual of every slot); ``extend``,
``save`` and ``load``; ``search`` through the per_query tier (the plain
semantic anchor, with its recon-dot branch), the LUT-scan tier
(``scan_select="pallas"``, or ``"approx"`` at oversampled shapes without
a cache) and the grouped tiers — over the cache the segmented scan
(``"approx"``) and the grouped scan (``"exact"``), elsewhere the plain
grouped tier; the ``refine="f32_regen"`` re-rank against a
device-resident dataset, a host one (numpy or memmap: the tiered prefetch
path or the serialized host gather, ``neighbors.tiered``) or a
device-chunk provider; and ``search_resilient``, the search behind the
degradation ladder (``robust.degrade``). Every tier takes a
``filter_bitset``
(``neighbors.sample_filter``): the LUT scan reads per-list keep bytes
beside the codes, the grouped tiers scan a sentinel-masked id table, the
per_query tier and the re-rank test the bitset itself.
``build_chunked`` builds from a host array, a memmap or a device-chunk
provider in O(chunk) card memory, with resumable checkpoints.

per_cluster indexes search as in the JAX package: the per_query tier
builds a look-up table a (query, probed list); the LUT-scan kernel
decodes per_subspace codebooks only, so it declines them
(``ivf_pq.scan.fallback{reason=per_cluster}``; an explicit
``scan_select="pallas"`` warns and takes "approx"), and their grouped
searches scan the recon cache with the segmented or grouped scan, or
decode each probed list against its own codebook. ``search_staged`` and
the sharded builds refuse them, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core import bitset as _bitset
from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.core import serialize as _ser
from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.interruptible import cancellation_point
from raft_tpu_torch.core.tracing import span, traced
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import select_k_impl as _select_k
from raft_tpu_torch.neighbors import ivf_common as ic
from raft_tpu_torch.neighbors import sample_filter as _sf
from raft_tpu_torch.obs import hbm as _hbm
from raft_tpu_torch.obs import index_stats as _istats
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.random import threefry as _threefry
from raft_tpu_torch.random.rng import RngState
from raft_tpu_torch.robust import degrade as _degrade
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.robust import retry as _retry
from raft_tpu_torch.utils import graphs as _graphs
from raft_tpu_torch.utils import precision as _precision


@dataclasses.dataclass
class IndexParams:
    """reference: ``ivf_pq::index_params`` (same fields as raft_tpu)."""

    n_lists: int = 1024
    metric: str = "sqeuclidean"
    pq_dim: int = 0           # 0 → dim/2 rounded to a multiple of 8
    pq_bits: int = 8          # 4..8
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    codebook_kind: str = "per_subspace"  # | "per_cluster"
    add_data_on_build: bool = True
    list_size_cap_factor: float = 4.0
    spill: bool = False
    seed: int = 0
    cache_reconstruction: str = "auto"  # "auto" | "always" | "never"


@dataclasses.dataclass
class SearchParams:
    """reference: ``ivf_pq::search_params`` (same fields as raft_tpu).

    ``scan_select`` picks the grouped tier (see :func:`search`);
    ``refine="f32_regen"`` re-ranks against ``dataset`` exactly, and
    ``refine_transfer`` ("auto" | "tiered" | "serial") picks how a host
    dataset's candidate rows reach the card (``neighbors.tiered``).
    ``scan_recall`` is kept for the JAX package's signature: the port's
    selections are exact."""

    n_probes: int = 20
    query_tile: int = 64
    scan_mode: str = "auto"  # "auto" | "grouped" | "per_query"
    list_chunk: int = 64
    lut_dtype: str = "auto"  # | "float32" | "bfloat16" | "float8_e4m3"
    scan_select: str = "exact"  # | "approx" | "pallas"
    scan_recall: float = 0.95
    refine: str = "none"  # | "f32_regen"
    refine_ratio: float = 2.0
    refine_transfer: str = "auto"


FP8_LUT_MIN_SLACK = 4


def resolve_lut_dtype(lut_dtype: str, n_probes: int, k: int,
                      selectivity: float = 1.0) -> str:
    """``lut_dtype="auto"`` for one dispatch: fp8 for oversampled scans
    (n_probes ≥ 64 or k ≥ 400) on the card when the candidate slack
    n_probes·256·selectivity is ≥ 4k, bf16 when it is thinner, exact f32
    otherwise and off the card. ``RAFT_TPU_FP8_LUT`` (auto | on | off, the
    JAX package's tri-state): "on" applies the policy off the card too,
    "off" pins "auto" to f32. Explicit dtypes pass through; each "auto"
    resolution counts under ``ivf_pq.lut.dispatch{dtype=...}``."""
    if lut_dtype != "auto":
        return lut_dtype
    force = _obs_spans.env_tristate("RAFT_TPU_FP8_LUT")
    oversampled = n_probes >= 64 or k >= 400
    chosen = "float32"
    if (force != "off" and oversampled
            and (force == "on" or _k._on_cuda())):
        surviving = selectivity * n_probes * _k.LUT_SCAN_BINS
        chosen = ("float8_e4m3" if surviving >= FP8_LUT_MIN_SLACK * k
                  else "bfloat16")
    _obs_spans.inc("ivf_pq.lut.dispatch", dtype=chosen)
    return chosen


def _filter_selectivity(filter_bits) -> float:
    """The set-bit fraction of a filter (1.0 without one): only kept
    candidates fill the LUT tier's bins, so it discounts the fp8 slack of
    :func:`resolve_lut_dtype`. One popcount and a host sync a filtered
    dispatch with ``lut_dtype="auto"``, as in the JAX package."""
    return 1.0 if filter_bits is None else _bitset.density(filter_bits)


def _count_scan_dispatch(impl: str, filtered: bool = False) -> None:
    """Count which scan tier ``search`` took under ``ivf_pq.scan.dispatch``
    (the JAX package's labels: pallas_lut, segk, grouped_pallas,
    grouped_xla, per_query), with ``filtered=1`` for filtered searches."""
    _obs_spans.count_dispatch("ivf_pq.scan", impl,
                              **({"filtered": "1"} if filtered else {}))


@dataclasses.dataclass
class IvfPqIndex:
    """IVF-PQ index: the JAX package's fields, as tensors on one device."""

    centers: torch.Tensor        # [n_lists, dim] f32
    centers_rot: torch.Tensor    # [n_lists, rot_dim] f32
    rotation: torch.Tensor       # [rot_dim, dim] f32
    codebooks: torch.Tensor      # [pq_dim | n_lists, 2^bits, pq_len] f32
    packed_codes: torch.Tensor   # [n_lists, L, nb] u8 (never lane-folded)
    packed_ids: torch.Tensor     # [n_lists, L] i32, -1 pad
    packed_norms: torch.Tensor   # [n_lists, L] f32: ‖c + decoded‖²
    list_sizes: torch.Tensor     # [n_lists] i32
    packed_recon: Optional[torch.Tensor] = None  # [n_lists, L, rot_dim] bf16
    metric: str = "sqeuclidean"
    codebook_kind: str = "per_subspace"
    pq_bits: int = 8
    pq_dim_static: int = 0

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
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def pq_dim(self) -> int:
        return self.pq_dim_static or self.packed_codes.shape[2]

    @property
    def pq_len(self) -> int:
        return self.codebooks.shape[2]

    @property
    def max_list_size(self) -> int:
        return self.packed_ids.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


_ARRAY_FIELDS = ("centers", "centers_rot", "rotation", "codebooks",
                 "packed_codes", "packed_ids", "packed_norms", "list_sizes")


def _unfold_codes(packed_codes, L: int, pq_dim: int, pq_bits: int):
    """Codes as ``[n_lists, L, nb]``: that layout as it is, or the JAX
    package's lane-folded one, ``[n_lists, L·nb/128, 128]``
    (``IvfPqIndex.codes_folded``, made for code arrays over 1 GB so a TPU
    pads no lanes), as its row-major view (``codes_chunk`` there). The
    card has no lanes to pad, so the port never folds. Any other shape
    raises."""
    shape = tuple(packed_codes.shape)
    nb = packed_nbytes(pq_dim or shape[-1], pq_bits)
    if len(shape) == 3 and shape[1:] == (L, nb):
        return packed_codes
    expects(len(shape) == 3 and shape[2] == 128 and shape[1] * 128 == L * nb,
            "packed_codes %s is neither [n_lists, %d, %d] nor its lane fold "
            "[n_lists, %d, 128]", shape, L, nb, L * nb // 128)
    return packed_codes.reshape(shape[0], L, nb)


def from_numpy(arrays: Dict[str, np.ndarray], meta: Dict, device="cuda"
               ) -> IvfPqIndex:
    """Index from the JAX index's fields as numpy arrays (``arrays``) and
    its static fields (``meta``: metric, pq_bits, pq_dim, codebook_kind,
    has_recon; per_cluster codebooks are ``[n_lists, K, pq_len]``). The
    bf16 cache never crosses as an array (numpy has no bf16):
    ``has_recon`` rebuilds it here, as the JAX package's ``load`` does."""
    dev = resolve_device(device)
    kind = meta.get("codebook_kind", "per_subspace")
    expects(kind in ("per_subspace", "per_cluster"),
            "codebook_kind must be per_subspace or per_cluster")
    pq_dim = int(meta.get("pq_dim", 0))
    pq_bits = int(meta.get("pq_bits", 8))
    arrays = {name: np.asarray(arrays[name]) for name in _ARRAY_FIELDS}
    arrays["packed_codes"] = _unfold_codes(
        arrays["packed_codes"], arrays["packed_ids"].shape[1], pq_dim, pq_bits)
    t = {name: to_device(arrays[name], dev) for name in _ARRAY_FIELDS}
    index = IvfPqIndex(**t, metric=str(meta["metric"]), codebook_kind=kind,
                       pq_bits=pq_bits, pq_dim_static=pq_dim)
    if meta.get("has_recon"):
        index.packed_recon = _build_recon_cache(index)
    return index


def _meta(index: IvfPqIndex) -> Dict:
    return {"metric": index.metric, "pq_bits": index.pq_bits,
            "pq_dim": index.pq_dim, "codebook_kind": index.codebook_kind,
            "has_recon": index.packed_recon is not None}


def to_numpy(index: IvfPqIndex) -> Tuple[Dict[str, np.ndarray], Dict]:
    """(arrays, meta) — the inverse of :func:`from_numpy`."""
    arrays = {name: getattr(index, name).cpu().numpy()
              for name in _ARRAY_FIELDS}
    return arrays, _meta(index)


# ---------------------------------------------------------------------------
# n-bit code packing
# ---------------------------------------------------------------------------

def packed_nbytes(pq_dim: int, pq_bits: int) -> int:
    return (pq_dim * pq_bits + 7) // 8


def pack_bits(codes: torch.Tensor, pq_bits: int) -> torch.Tensor:
    """[..., S] code values (< 2^pq_bits) → [..., nbytes] u8; int32
    arithmetic."""
    if pq_bits == 8:
        return codes.to(torch.uint8)
    S = codes.shape[-1]
    nbytes = packed_nbytes(S, pq_bits)
    acc = torch.zeros(codes.shape[:-1] + (nbytes,), dtype=torch.int32,
                      device=codes.device)
    c32 = codes.to(torch.int32)
    for s in range(S):
        byte_idx, off = divmod(s * pq_bits, 8)
        v = c32[..., s] << off
        acc[..., byte_idx] |= v & 0xFF
        if byte_idx + 1 < nbytes:
            acc[..., byte_idx + 1] |= v >> 8
    return acc.to(torch.uint8)


def unpack_bits(packed: torch.Tensor, pq_dim: int, pq_bits: int
                ) -> torch.Tensor:
    """[..., nbytes] u8 → [..., pq_dim] u8 code values."""
    return _k.unpack_codes(packed, pq_dim, pq_bits).to(torch.uint8)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _default_pq_dim(dim: int) -> int:
    return max(8, (dim // 2 + 7) // 8 * 8 if dim >= 16 else dim)


def make_rotation_matrix(state: RngState, rot_dim: int, dim: int,
                         device) -> torch.Tensor:
    """Random orthonormal embedding R [rot_dim, dim], RᵀR = I (QR of a
    Gaussian, made on the CPU so every device gets the same matrix)."""
    g = torch.randn((rot_dim, dim), generator=state.generator(),
                    dtype=torch.float64)
    q, _ = torch.linalg.qr(g, mode="reduced")
    return q.float().to(device)


def _vmapped_lloyd(data: torch.Tensor, k: int, n_iters: int,
                   state: RngState, block_bytes: int = 1 << 30
                   ) -> torch.Tensor:
    """Independent k-means per subspace: ``data [S, n, P]`` → codebooks
    [S, k, P]. The JAX package's ``vmap`` is a batch dimension here,
    processed in subspace chunks that bound the [chunk, n, k] block."""
    S, n, P = data.shape
    dev = data.device
    expects(n >= k, "%d codebook training rows for 2^pq_bits = %d codes",
            n, k)
    chunk = max(1, min(S, block_bytes // max(1, n * k * 4)))
    out = []
    for a in range(0, S, chunk):
        sub = data[a:a + chunk].float()
        b = sub.shape[0]
        idx = torch.stack([torch.randperm(n, generator=state.fold(a + s)
                                          .generator())[:k]
                           for s in range(b)]).to(dev)
        c = torch.gather(sub, 1, idx[..., None].expand(-1, -1, P))
        x_sq = (sub * sub).sum(-1)
        base = (torch.arange(b, device=dev) * k)[:, None]
        ones = torch.ones(b * n, device=dev)
        for _ in range(n_iters):
            d2 = (x_sq[..., None] + (c * c).sum(-1)[:, None, :]
                  - 2.0 * torch.bmm(sub, c.transpose(1, 2)))
            flat = (d2.argmin(-1) + base).reshape(-1)
            del d2
            sums = torch.zeros((b * k, P), device=dev).index_add_(
                0, flat, sub.reshape(-1, P)).view(b, k, P)
            counts = torch.zeros(b * k, device=dev).index_add_(
                0, flat, ones).view(b, k)
            c = torch.where(counts[..., None] > 0,
                            sums / counts.clamp_min(1e-12)[..., None], c)
        out.append(c)
    return torch.cat(out, 0)


def _cluster_init_indices(mask: torch.Tensor, k: int, key
                          ) -> torch.Tensor:
    """Each cluster's k initial centroid rows, [C, k] int64: the JAX
    package's ``jax.random.choice(subkey_c, cap, (k,), replace=False,
    p=w / max(Σw, 1))`` with ``subkey_c`` cluster c's key of
    ``jax.random.split(key, C)``. That draw is a Gumbel top-k:
    ``-log(-log(u)) + log(p)`` over the cap rows, ``u`` uniform in [tiny,
    1) from the subkey (``threefry.uniform_rows``, bit for bit), pad rows
    at ``log 0 = −inf``, and the k largest with ties to the lower row
    (``lax.top_k``'s order; a stable descending sort here). The logs are
    torch's, which may differ from XLA's in a last bit."""
    C, cap = mask.shape
    w = mask.float()
    p = w / w.sum(1, keepdim=True).clamp_min(1.0)
    u = _threefry.uniform_rows(_threefry.split_rows(key, C, mask.device), cap,
                               float(np.finfo(np.float32).tiny), 1.0)
    g = -torch.log(-torch.log(u)) + torch.log(p)
    return torch.sort(g, dim=1, descending=True, stable=True)[1][:, :k]


def _vmapped_lloyd_masked(data: torch.Tensor, mask: torch.Tensor, k: int,
                          n_iters: int, key, block_bytes: int = 1 << 30
                          ) -> torch.Tensor:
    """Independent k-means per cluster over padded row blocks: ``data [C,
    cap, P]``, ``mask [C, cap]`` (pad rows weigh 0) → codebooks [C, k, P]
    (the JAX package's ``_vmapped_lloyd_masked``; ``key`` a
    ``random.threefry`` key). Initial centroids by
    :func:`_cluster_init_indices`; a centroid that no weighted row picks
    keeps its value. The JAX package's ``vmap`` is a batch dimension here,
    in cluster chunks that bound the [chunk, cap, k] block."""
    C, cap, P = data.shape
    dev = data.device
    idx0 = _cluster_init_indices(mask, k, key).to(dev)
    chunk = max(1, min(C, block_bytes // max(1, cap * k * 4)))
    out = []
    for a in range(0, C, chunk):
        sub = data[a:a + chunk].float()
        w = mask[a:a + chunk].float()
        b = sub.shape[0]
        c = torch.gather(sub, 1, idx0[a:a + chunk, :, None].expand(-1, -1, P))
        x_sq = (sub * sub).sum(-1)
        base = (torch.arange(b, device=dev) * k)[:, None]
        wsub = (sub * w[..., None]).reshape(-1, P)
        for _ in range(n_iters):
            d2 = (x_sq[..., None] + (c * c).sum(-1)[:, None, :]
                  - 2.0 * torch.bmm(sub, c.transpose(1, 2)))
            flat = (d2.argmin(-1) + base).reshape(-1)
            del d2
            sums = torch.zeros((b * k, P), device=dev).index_add_(
                0, flat, wsub).view(b, k, P)
            counts = torch.zeros(b * k, device=dev).index_add_(
                0, flat, w.reshape(-1)).view(b, k)
            c = torch.where(counts[..., None] > 0,
                            sums / counts.clamp_min(1e-12)[..., None], c)
        out.append(c)
    return torch.cat(out, 0)


def _train_per_cluster(tr_res: torch.Tensor, tr_labels: torch.Tensor,
                       n_lists: int, pq_dim: int, pq_len: int, K: int,
                       n_iters: int, key) -> torch.Tensor:
    """per_cluster codebooks [n_lists, K, pq_len] (the JAX package's
    ``_train_per_cluster``): each cluster trains one codebook over its
    residual sub-vectors pooled across every subspace, grouped by
    ``ivf_common.pack_lists`` into blocks of ``cap`` rows (a cluster past
    the cap keeps its first ``cap``: the trainset is already a random
    sample)."""
    n_sub = tr_res.shape[0] * pq_dim
    flat_sub = tr_res.reshape(n_sub, pq_len)
    flat_lbl = tr_labels.long().repeat_interleave(pq_dim)
    avg = max(1, n_sub // max(n_lists, 1))
    cap = min(max(2 * K, -(-4 * avg // 8) * 8), max(2 * K, 8192))
    (packed,), _, sizes, _, _ = ic.pack_lists(
        [flat_sub], flat_lbl,
        torch.arange(n_sub, dtype=torch.int32, device=tr_res.device),
        n_lists=n_lists, L=cap, fill_values=[0.0])
    mask = (torch.arange(cap, device=tr_res.device)[None, :]
            < sizes[:, None])
    return _vmapped_lloyd_masked(packed, mask, K, n_iters, key)


def _train_quantizers(trainset: torch.Tensor, params: IndexParams, dim: int,
                      pq_dim: int, pq_len: int, K: int, state: RngState,
                      km: KMeansBalancedParams,
                      max_codebook_rows: int = 1 << 16,
                      centers: Optional[torch.Tensor] = None):
    """Coarse centers + rotation + codebooks of ``params.codebook_kind``.
    Given ``centers`` (the distributed build's ``coarse="distributed"``),
    the coarse fit is skipped and the codebooks train on residuals to
    them. per_cluster codebooks draw their initial rows from the JAX
    package's key, ``fold_in(PRNGKey(state.seed), 2)``."""
    n_train = trainset.shape[0]
    rot_dim = pq_dim * pq_len
    if centers is None:
        centers = kmeans_balanced.fit(trainset, params.n_lists, km)
    rotation = make_rotation_matrix(state.fold(1), rot_dim, dim,
                                    trainset.device)
    centers_rot = centers @ rotation.T
    stride = max(1, -(-n_train // max_codebook_rows))
    tr_cb = trainset[::stride]
    n_cb = tr_cb.shape[0]
    cb_labels = kmeans_balanced.predict(centers, tr_cb, km)
    tr_res = tr_cb @ rotation.T - centers_rot[cb_labels.long()]
    if params.codebook_kind == "per_cluster":
        key = _threefry.fold_in(_threefry.prng_key(state.seed), 2)
        codebooks = _train_per_cluster(tr_res, cb_labels, params.n_lists,
                                       pq_dim, pq_len, K,
                                       params.kmeans_n_iters, key)
        return centers, rotation, centers_rot, codebooks
    sub = tr_res.view(n_cb, pq_dim, pq_len).transpose(0, 1).contiguous()
    codebooks = _vmapped_lloyd(sub, K, params.kmeans_n_iters, state.fold(2))
    return centers, rotation, centers_rot, codebooks


def _decode_codes(codes: torch.Tensor, codebooks: torch.Tensor
                  ) -> torch.Tensor:
    """codes [b, S] → decoded residuals [b, S·P] f32 (a gather)."""
    S, K, P = codebooks.shape
    s_idx = torch.arange(S, device=codes.device)
    return codebooks[s_idx[None, :], codes.long()].reshape(codes.shape[0],
                                                          S * P)


def _decode_codes_cluster(codes: torch.Tensor, cb_rows: torch.Tensor
                          ) -> torch.Tensor:
    """per_cluster decode: codes [b, S] with each row's own codebook
    ``cb_rows [b, K, P]`` → decoded residuals [b, S·P] f32 (a gather; the
    JAX package's one-hot product is the TPU's form of it, and in f32 it
    gives the same values)."""
    rows = torch.arange(codes.shape[0], device=codes.device)[:, None]
    return cb_rows[rows, codes.long()].reshape(codes.shape[0], -1)


def _decode_lists_cluster(codes: torch.Tensor, cb: torch.Tensor
                          ) -> torch.Tensor:
    """per_cluster decode of a chunk of packed lists: codes [C, L, S] with
    one codebook a list ``cb [C, K, P]`` → [C, L, S·P] f32."""
    C, L, _ = codes.shape
    lists = torch.arange(C, device=codes.device)[:, None, None]
    return cb[lists, codes.long()].reshape(C, L, -1)


def _encode_with_norms(x: torch.Tensor, rotation: torch.Tensor,
                       centers_rot: torch.Tensor, labels: torch.Tensor,
                       codebooks: torch.Tensor,
                       codebook_kind: str = "per_subspace",
                       block: int = 16384):
    """(codes [n, S] u8, ‖c + decoded‖² [n] f32) in row blocks; rows are
    rotated per block (``x @ rotationᵀ``). per_cluster: every subspace of
    a row quantizes against its list's codebook ``codebooks[label]``."""
    n = x.shape[0]
    K, P = codebooks.shape[1:]
    S = centers_rot.shape[1] // P
    per_cluster = codebook_kind == "per_cluster"
    cb_sq = (codebooks * codebooks).sum(-1)            # [S | n_lists, K]
    codes = torch.empty((n, S), dtype=torch.uint8, device=x.device)
    norms = torch.empty((n,), dtype=torch.float32, device=x.device)
    for a in range(0, n, block):
        lbl = labels[a:a + block].long()
        rows = x[a:a + block] @ rotation.T
        res = rows - centers_rot[lbl]
        if per_cluster:
            sub = res.view(res.shape[0], S, P)                # [b, S, P]
            cb = codebooks[lbl]                               # [b, K, P]
            d2 = ((sub * sub).sum(-1)[..., None] + cb_sq[lbl][:, None, :]
                  - 2.0 * torch.bmm(sub, cb.transpose(1, 2)))  # [b, S, K]
            c = d2.argmin(-1)                                 # [b, S]
            dec = _decode_codes_cluster(c, cb)
        else:
            sub = res.view(res.shape[0], S, P).transpose(0, 1)  # [S, b, P]
            d2 = ((sub * sub).sum(-1)[..., None] + cb_sq[:, None, :]
                  - 2.0 * torch.bmm(sub, codebooks.transpose(1, 2)))
            c = d2.argmin(-1).T                               # [b, S]
            dec = _decode_codes(c, codebooks)
        del d2
        codes[a:a + block] = c.to(torch.uint8)
        rec = centers_rot[lbl] + dec
        norms[a:a + block] = (rec * rec).sum(1)
    return codes, norms


def _want_recon_cache(params: IndexParams, n_lists: int, L: int,
                      rot_dim: int, device) -> bool:
    """The JAX package's rule: "auto" caches while the bf16 cache stays
    under 3 GB and a fifth of what the allocator may use
    (``obs.hbm.bytes_limit``: the card's memory times the process's memory
    fraction; no limit on the CPU)."""
    if params.cache_reconstruction in ("never", "always"):
        return params.cache_reconstruction == "always"
    cap = 3 << 30
    limit = _hbm.bytes_limit(device)
    if limit:
        cap = min(cap, limit // 5)
    return n_lists * L * rot_dim * 2 <= cap


def _build_recon_cache(index: IvfPqIndex) -> torch.Tensor:
    """bf16 reconstruction (c + decoded residual) of every packed slot,
    [n_lists, L, rot_dim]. Decoded in list chunks of about 4096 rows
    (``choose_list_chunk``); the add and the cast are in f32, so the cache
    equals the JAX package's bit for bit."""
    n_lists, L = index.packed_ids.shape
    S = index.pq_dim
    chunk = ic.choose_list_chunk(n_lists, max(1, -(-4096 // max(L, 1))))
    out = torch.empty((n_lists, L, index.rot_dim), dtype=torch.bfloat16,
                      device=index.device)
    for a in range(0, n_lists, chunk):
        codes = _k.unpack_codes(index.packed_codes[a:a + chunk], S,
                                index.pq_bits)
        if index.codebook_kind == "per_cluster":
            dec = _decode_lists_cluster(codes,
                                        index.codebooks[a:a + chunk])
        else:
            dec = _decode_codes(codes.reshape(chunk * L, S),
                                index.codebooks).view(chunk, L, -1)
        out[a:a + chunk] = (dec + index.centers_rot[a:a + chunk, None, :]
                            ).to(torch.bfloat16)
    return out


@traced("raft_tpu_torch.ivf_pq.build")
def build(dataset, params: Optional[IndexParams] = None, device="cuda",
          stage_seconds: Optional[Dict[str, float]] = None) -> IvfPqIndex:
    """Build the index on ``device`` (reference: ivf_pq::build).
    ``stage_seconds``, when given, receives the seconds of each stage
    (train, assign, encode, pack, recon_cache)."""
    if params is None:
        params = IndexParams()
    dev = resolve_device(device)
    _precision.enforce()
    mt = resolve_metric(params.metric)
    expects(params.codebook_kind in ("per_subspace", "per_cluster"),
            "codebook_kind must be per_subspace or per_cluster")
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    stage = ic.Stages(stage_seconds, dev)

    x = to_device(dataset, dev, torch.float32)
    n, dim = x.shape
    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    if mt == DistanceType.CosineExpanded:
        x = x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))
    pq_dim = params.pq_dim or _default_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    rot_dim = pq_dim * pq_len
    K = 1 << params.pq_bits
    state = RngState(params.seed)

    n_train = min(n, max(params.n_lists * 4,
                         int(n * params.kmeans_trainset_fraction)))
    km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric="cosine" if spherical else "l2",
                              seed=params.seed)
    with stage("train"):
        if n_train < n:
            rng = np.random.default_rng(params.seed)
            tr = torch.as_tensor(np.sort(rng.choice(n, n_train, replace=False)),
                                 device=dev)
            trainset = x[tr]
        else:
            trainset = x
        centers, rotation, centers_rot, codebooks = _train_quantizers(
            trainset, params, dim, pq_dim, pq_len, K, state, km)
        del trainset
    avg = max(1, n // params.n_lists)
    quantizer = dict(centers=centers, centers_rot=centers_rot,
                     rotation=rotation, codebooks=codebooks, metric=mt.value,
                     codebook_kind=params.codebook_kind,
                     pq_bits=params.pq_bits, pq_dim_static=pq_dim)
    if not params.add_data_on_build:
        L = max(8, int(avg * params.list_size_cap_factor))
        return IvfPqIndex(
            packed_codes=torch.zeros(
                (params.n_lists, L, packed_nbytes(pq_dim, params.pq_bits)),
                dtype=torch.uint8, device=dev),
            packed_ids=torch.full((params.n_lists, L), -1, dtype=torch.int32,
                                  device=dev),
            packed_norms=torch.zeros((params.n_lists, L), device=dev),
            list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32,
                                   device=dev), **quantizer)
    with stage("assign"):
        if params.spill:
            # cap the lists and cascade overflow to the next-nearest ones;
            # encode after spilling, against the assigned list's center
            lk = kmeans_balanced.predict_topk(centers, x, ic.SPILL_DEPTH, km)
            max_list_size = ic._lane_round(
                int(avg * params.list_size_cap_factor))
            labels = ic.spill_assignments(
                lk[:, 0], lk[:, 1], params.n_lists, max_list_size,
                *[lk[:, c] for c in range(2, lk.shape[1])])
            del lk
            n_marker = int((labels >= params.n_lists).sum())
            if n_marker:
                warnings.warn(f"ivf_pq: {n_marker} rows overflowed every "
                              f"spill choice at cap {max_list_size} (raise "
                              "list_size_cap_factor)", RuntimeWarning,
                              stacklevel=3)
        else:
            labels = kmeans_balanced.predict(centers, x, km)
            counts = torch.bincount(labels.long(),
                                    minlength=params.n_lists).cpu().numpy()
            max_list_size = ic._fit_list_size(counts, avg,
                                              params.list_size_cap_factor)
    with stage("encode"):
        codes, norms = _encode_with_norms(
            x, rotation, centers_rot, labels.clamp(0, params.n_lists - 1),
            codebooks, params.codebook_kind)
        codes_p = pack_bits(codes, params.pq_bits)
        del codes
    with stage("pack"):
        (packed, pnorm), ids, sizes, n_drop, _ = ic.pack_lists(
            [codes_p, norms], labels, _ids.make_ids(n, device=dev),
            n_lists=params.n_lists, L=max_list_size, fill_values=[0, 0.0])
    if n_drop:
        warnings.warn(f"ivf_pq: dropped {n_drop} overflow vectors (raise "
                      "list_size_cap_factor)", RuntimeWarning, stacklevel=3)
    index = IvfPqIndex(packed_codes=packed, packed_ids=ids,
                       packed_norms=pnorm, list_sizes=sizes, **quantizer)
    if _want_recon_cache(params, params.n_lists, max_list_size, rot_dim, dev):
        with stage("recon_cache"):
            index.packed_recon = _build_recon_cache(index)
    _istats.note_index_stats(index, name="ivf_pq.build", cheap=True)
    return index


def _count_resume(name: str, value: float = 1.0) -> None:
    """``resume.*{site=ivf_pq.build_chunked}``, the JAX package's
    counters (always on here, as every ``obs.spans`` counter is)."""
    _obs_spans.inc(name, value, site="ivf_pq.build_chunked")


# Host → card copies of the packed index go in slices of about this size,
# so the upload never needs a second full copy anywhere.
_UPLOAD_BYTES = 256 << 20


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``dev``: shared on the CPU, else copied
    in row slices into one buffer on the card."""
    t = torch.from_numpy(a)
    if dev.type == "cpu":
        return t
    out = torch.empty(a.shape, dtype=t.dtype, device=dev)
    rows = max(1, _UPLOAD_BYTES // max(1, a[:1].nbytes))
    for i in range(0, a.shape[0], rows):
        out[i:i + rows].copy_(t[i:i + rows])
    return out


@traced("raft_tpu_torch.ivf_pq.build_chunked")
def build_chunked(dataset, params: Optional[IndexParams] = None,
                  chunk_rows: int = 1 << 18,
                  max_train_rows: int = 1 << 21,
                  progress: bool = False,
                  checkpoint_dir: Optional[str] = None,
                  resume=False, device="cuda",
                  stage_seconds: Optional[Dict[str, float]] = None
                  ) -> IvfPqIndex:
    """Build from a host array, a memmap or a device-chunk provider
    (``bench.dataset.DeviceSyntheticChunks``) with O(``chunk_rows``)
    memory on the card beside the index itself (reference: the JAX
    package's ``build_chunked``, step for step).

    Rows are read once per pass (train sample, label, encode); the lists
    are packed into host arrays and uploaded in slices at the end. With
    ``checkpoint_dir=`` the build writes the manifest, the trained
    quantizers, the label pass and one encoded shard per chunk
    (``robust.checkpoint``, the JAX package's files: a checkpoint written
    by either package resumes in the other). ``resume=True`` validates the
    manifest and continues from its last complete chunk, loading the
    quantizers and labels and replaying completed shards, so a resumed
    build equals an uninterrupted one bit for bit; ``"auto"`` resumes when
    a manifest exists. Reads retry under ``robust.retry.IO_POLICY`` (sites
    ``build.chunk_read``, ``build.train_sample``); an encode chunk that
    runs out of memory is halved (``degrade.steps`` counts the walk). The
    codes are never lane-folded: that layout avoids TPU lane padding.
    ``stage_seconds``, when given, receives the seconds of each stage
    (sample, train, read, label, spill, encode, pack, upload,
    recon_cache)."""
    if params is None:
        params = IndexParams()
    dev = resolve_device(device)
    _precision.enforce()
    mt = resolve_metric(params.metric)
    expects(params.codebook_kind in ("per_subspace", "per_cluster"),
            "codebook_kind must be per_subspace or per_cluster")
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    expects(resume in (False, True, "auto"),
            "resume must be False, True, or 'auto' (got %r)", resume)
    expects(not resume or checkpoint_dir is not None,
            "resume=%r needs checkpoint_dir= (there is no manifest to "
            "resume from without one)", resume)
    # spans as the JAX package names them: train, label, encode_pack
    stage = ic.Stages(stage_seconds, dev, spans=("train",))
    t_start = time.perf_counter()

    def say(msg):
        if progress:
            print(f"[build_chunked +{time.perf_counter() - t_start:7.0f}s] "
                  f"{msg}", flush=True)

    n, dim = dataset.shape
    ck = manifest = None
    base_manifest = {}
    if checkpoint_dir is not None:
        from raft_tpu_torch.robust import checkpoint as _ckpt

        ck = _ckpt.BuildCheckpoint(checkpoint_dir)
        # one fingerprint a build (a memmap's samples real rows), threaded
        # through every manifest write with its seconds
        ds_sha, p_sha, fp_s = _ckpt.fingerprints_once(
            dataset, {**dataclasses.asdict(params),
                      "chunk_rows": chunk_rows,
                      "max_train_rows": max_train_rows})
        base_manifest = {"dataset_sha": ds_sha, "params_sha": p_sha,
                         "fingerprint_s": round(fp_s, 6),
                         "n": int(n), "dim": int(dim),
                         "chunk_rows": int(chunk_rows),
                         "n_chunks": -(-n // chunk_rows)}
        if resume is True or (resume == "auto"
                              and os.path.exists(ck.manifest_path)):
            manifest = ck.load_manifest()
            ck.validate_manifest(manifest, ds_sha, p_sha)
            _count_resume("resume.attempts")
            say(f"resuming from {ck.manifest_path} (phase "
                f"{manifest.get('phase')}, {manifest.get('chunks_done', 0)} "
                "chunks done)")
    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    normalize = mt == DistanceType.CosineExpanded

    def on_device(rows):
        # a provider's tensors stay where they are; host rows are copied
        if isinstance(rows, torch.Tensor):
            x = rows.to(dev, torch.float32)
        else:
            x = to_device(np.asarray(rows, np.float32), dev)
        if normalize:
            x = x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))
        return x

    def read_chunk(a, b):
        def once():
            _faults.faultpoint("build.chunk_read")
            return on_device(dataset[a:b])
        with stage("read"):
            return _retry.retry_call(once, site="build.chunk_read",
                                     policy=_retry.IO_POLICY)

    pq_dim = params.pq_dim or _default_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    rot_dim = pq_dim * pq_len
    K = 1 << params.pq_bits
    km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric="cosine" if spherical else "l2",
                              seed=params.seed)
    if manifest is not None:
        # every manifest phase implies trained quantizers on disk (the
        # first manifest is written after them)
        say("resume: loading quantizer state from checkpoint")
        q = ck.load_arrays("quantizers")
        centers, rotation, centers_rot, codebooks = (
            to_device(q[name], dev, torch.float32)
            for name in ("centers", "rotation", "centers_rot", "codebooks"))
    else:
        # 1. quantizers on a sorted random sample (memmap locality)
        n_train = min(n, max_train_rows,
                      max(params.n_lists * 4, 4 * K,
                          int(n * params.kmeans_trainset_fraction)))
        rng = np.random.default_rng(params.seed)
        with stage("sample"):
            tr_idx = np.sort(rng.choice(n, n_train, replace=False))
            say(f"sampling {n_train} train rows")
            if hasattr(dataset, "sample_rows"):  # device-chunk provider
                trainset = on_device(dataset.sample_rows(tr_idx))
            else:
                trainset = _retry.retry_call(
                    lambda: on_device(dataset[tr_idx]),
                    site="build.train_sample", policy=_retry.IO_POLICY)
        del tr_idx
        say("training quantizers (coarse kmeans + rotation + codebooks)")
        with stage("train"):
            centers, rotation, centers_rot, codebooks = _train_quantizers(
                trainset, params, dim, pq_dim, pq_len, K,
                RngState(params.seed), km)
        del trainset
        if ck is not None:
            # the state a resume must not retrain; f32 round-trips exactly
            ck.save_arrays("quantizers",
                           centers=centers.cpu().numpy(),
                           rotation=rotation.cpu().numpy(),
                           centers_rot=centers_rot.cpu().numpy(),
                           codebooks=codebooks.cpu().numpy())
            ck.write_manifest({**base_manifest, "phase": "label"})
    say("quantizers trained; label pass")

    def label_pass():
        """The streaming label pass → (labels, L, counts)."""
        if params.spill:
            # the nearest SPILL_DEPTH centers, then cap and spill: L is the
            # cap itself, not the skewed largest load
            NC = min(ic.SPILL_DEPTH, params.n_lists)
            lk = np.empty((n, NC), np.int32)
            for a in range(0, n, chunk_rows):
                cancellation_point()
                b = min(n, a + chunk_rows)
                x = read_chunk(a, b)
                with stage("label"):
                    lk[a:b] = kmeans_balanced.predict_topk(centers, x, NC,
                                                           km).cpu().numpy()
                del x
                if a % (8 * chunk_rows) == 0:
                    say(f"labeled {b}/{n}")
            L = ic._lane_round(int(avg * params.list_size_cap_factor))
            say("spilling assignments")
            with stage("spill"):
                cols = [to_device(lk[:, c], dev) for c in range(NC)]
                del lk
                labels = ic.spill_assignments(
                    cols[0], cols[1], params.n_lists, L,
                    *cols[2:]).cpu().numpy()
                del cols
            n_spill_drop = int((labels >= params.n_lists).sum())
            if n_spill_drop:
                _log.warn("ivf_pq chunked build: %d rows overflowed every "
                          "spill choice at cap %d", n_spill_drop, L)
            counts = np.bincount(labels[labels < params.n_lists],
                                 minlength=params.n_lists)
        else:
            labels = np.empty(n, np.int32)
            for a in range(0, n, chunk_rows):
                cancellation_point()  # chunk seams are cancellation points
                b = min(n, a + chunk_rows)
                x = read_chunk(a, b)
                with stage("label"):
                    labels[a:b] = kmeans_balanced.predict(centers, x,
                                                          km).cpu().numpy()
                del x
            counts = np.bincount(labels, minlength=params.n_lists)
            L = ic._fit_list_size(counts, avg,
                                  params.list_size_cap_factor)
        return labels, L, counts

    # 2. the streaming label pass → list capacity (loaded when the resume
    # manifest says the pass completed)
    avg = max(1, n // params.n_lists)
    have_labels = (manifest is not None
                   and manifest.get("phase") in ("encode", "done"))
    if have_labels:
        say("resume: loading label pass from checkpoint")
        labels = np.asarray(ck.load_arrays("labels")["labels"], np.int32)
        expects(labels.shape[0] == n,
                "resume label checkpoint holds %d rows, dataset has %d",
                labels.shape[0], n)
        L = int(manifest["L"])
        counts = np.bincount(labels[labels < params.n_lists],
                             minlength=params.n_lists)
    else:
        with span("label"):
            labels, L, counts = label_pass()
    if ck is not None and not have_labels:
        ck.save_arrays("labels", labels=labels)
        ck.write_manifest({**base_manifest, "phase": "encode", "L": int(L),
                           "chunks_done": 0})
    nbytes = packed_nbytes(pq_dim, params.pq_bits)

    # 3. the streaming encode and the host pack
    def encode_once(lo, hi):
        xb = read_chunk(lo, hi)
        with stage("encode"):
            # the spill marker encodes against the last list, as the JAX
            # package's clamped gather does; the pack drops those rows
            lb = to_device(labels[lo:hi], dev).clamp(0, params.n_lists - 1)
            codes, norms = _encode_with_norms(xb, rotation, centers_rot, lb,
                                              codebooks, params.codebook_kind)
            return (pack_bits(codes, params.pq_bits).cpu().numpy(),
                    norms.cpu().numpy())

    def encode_range(lo, hi):
        """Encode rows [lo, hi) → host (packed codes, norms). A chunk out
        of memory is halved and retried (each row encodes alone, so
        halving changes nothing but the peak), down to 1024 rows."""
        try:
            return encode_once(lo, hi)
        except Exception as e:
            if not _degrade.is_resource_exhausted(e) or hi - lo <= 1024:
                raise
        # past the handler: the failed attempt's tensors are released
        _degrade.note_step("ivf_pq.build_chunked", "chunk", "half_chunk",
                           "resource_exhausted")
        _log.warn("ivf_pq chunked build: RESOURCE_EXHAUSTED encoding rows "
                  "[%d, %d) — halving the chunk", lo, hi)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        mid = (lo + hi) // 2
        c1, n1 = encode_range(lo, mid)
        c2, n2 = encode_range(mid, hi)
        return np.concatenate([c1, c2]), np.concatenate([n1, n2])

    chunks_done = int(manifest.get("chunks_done", 0)) if have_labels else 0
    packed = np.zeros((params.n_lists, L, nbytes), np.uint8)
    # global ids a + row ∈ [0, n) in the policy width of n
    ids = torch.full((params.n_lists, L), -1, dtype=_ids.id_dtype(n)).numpy()
    pnorm = np.zeros((params.n_lists, L), np.float32)
    cursor = np.zeros(params.n_lists, np.int64)  # next free slot per list
    dropped = 0
    with span("encode_pack"):
        for ci, a in enumerate(range(0, n, chunk_rows)):
            b = min(n, a + chunk_rows)
            if ci < chunks_done:
                # completed before the interruption: replay its shard (no
                # device work) so the pack below is the same
                shard = ck.load_shard(ci)
                codes_h = np.asarray(shard["codes"], np.uint8)
                norms_h = np.asarray(shard["norms"], np.float32)
                expects(codes_h.shape[0] == b - a,
                        "resume shard %d holds %d rows, expected %d — "
                        "corrupt checkpoint; refusing to resume",
                        ci, codes_h.shape[0], b - a)
                _count_resume("resume.chunks_replayed")
            else:
                cancellation_point()
                _faults.faultpoint("build.chunk_encode")
                codes_h, norms_h = encode_range(a, b)
                if ck is not None:
                    # the shard before the manifest that records it: a death
                    # between the two re-encodes one chunk
                    ck.save_shard(ci, codes=codes_h, norms=norms_h)
                    ck.write_manifest({**base_manifest, "phase": "encode",
                                       "L": int(L), "chunks_done": ci + 1})
            with stage("pack"):
                lb_h = labels[a:b]
                order, sorted_l, slot = (t.numpy() for t in ic.stable_slots(
                    torch.from_numpy(lb_h), params.n_lists,
                    torch.from_numpy(cursor)))
                keep = (slot < L) & (sorted_l < params.n_lists)
                dropped += int((~keep).sum())
                rows = order[keep]
                ls, sl = sorted_l[keep], slot[keep].astype(np.int64)
                packed[ls, sl] = codes_h[rows]
                ids[ls, sl] = (a + rows).astype(ids.dtype)
                pnorm[ls, sl] = norms_h[rows]
                cursor = np.minimum(
                    cursor + np.bincount(lb_h, minlength=params.n_lists)[
                        :params.n_lists], L)
            if a % (8 * chunk_rows) == 0:
                say(f"encoded {b}/{n}")
    if ck is not None:
        ck.write_manifest({**base_manifest, "phase": "done", "L": int(L),
                           "chunks_done": -(-n // chunk_rows)})
    _obs_spans.inc("ivf_pq.build.dropped", dropped,
                   site="ivf_pq.build_chunked")
    if dropped:
        _log.warn("ivf_pq chunked build: dropped %d overflow vectors",
                  dropped)
    with stage("upload"):
        index = IvfPqIndex(
            centers=centers, centers_rot=centers_rot, rotation=rotation,
            codebooks=codebooks, packed_codes=_upload(packed, dev),
            packed_ids=_upload(ids, dev), packed_norms=_upload(pnorm, dev),
            list_sizes=torch.from_numpy(np.minimum(counts, L).astype(
                np.int32)).to(dev),
            metric=mt.value, codebook_kind=params.codebook_kind,
            pq_bits=params.pq_bits, pq_dim_static=pq_dim)
    del packed, ids, pnorm
    if _want_recon_cache(params, params.n_lists, L, rot_dim, dev):
        with stage("recon_cache"):
            index.packed_recon = _build_recon_cache(index)
    _istats.note_index_stats(index, name="ivf_pq.build_chunked", cheap=True)
    say("done")
    return index


@traced("raft_tpu_torch.ivf_pq.build_distributed")
def build_distributed(dataset, params: Optional[IndexParams] = None, *,
                      mesh, axis: str = "shard",
                      chunk_rows: int = 1 << 18,
                      max_train_rows: int = 1 << 21,
                      prefetch: bool = True,
                      coarse: str = "replicated",
                      checkpoint_dir: Optional[str] = None,
                      resume=False, progress: bool = False,
                      stage_seconds: Optional[Dict[str, float]] = None):
    """Distributed chunked build from a host array, a memmap or a
    device-chunk provider over the ranks of ``mesh`` — the sharded twin of
    :func:`build_chunked` (``parallel.build.build_ivf_pq_distributed``).
    Returns a ``parallel.ivf.ShardedIvfPq`` that :func:`search` (with
    ``mesh=``) takes as it is; ``parallel.build.assemble_ivf_pq`` of it
    equals ``build_chunked`` over the same data and parameters, bit for
    bit, when each shard's rows are a multiple of ``chunk_rows`` and
    ``coarse="replicated"``. Each shard walks its slice through a
    prefetcher (``prefetch=False``: inline reads); the comms are two
    ``allgatherv``; ``checkpoint_dir=`` / ``resume=`` as in
    :func:`build_chunked`, per (shard, chunk)."""
    if params is None:
        params = IndexParams()
    from raft_tpu_torch.parallel import build as _dbuild

    return _dbuild.build_ivf_pq_distributed(
        dataset, params, mesh, axis=axis, chunk_rows=chunk_rows,
        max_train_rows=max_train_rows, prefetch=prefetch, coarse=coarse,
        checkpoint_dir=checkpoint_dir, resume=resume, progress=progress,
        stage_seconds=stage_seconds)


@traced("raft_tpu_torch.ivf_pq.extend")
def extend(index: IvfPqIndex, new_vectors, new_ids=None) -> IvfPqIndex:
    """Append vectors (reference: ivf_pq::extend): encode against the
    existing centers and codebooks, then re-pack with the lists grown to
    the new largest fill (rounded up to 8). The recon cache is rebuilt
    when the index has one."""
    mt = resolve_metric(index.metric)
    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    km = KMeansBalancedParams(metric="cosine" if spherical else "l2")
    dev = index.device
    _precision.enforce()
    codes_in = _unfold_codes(index.packed_codes, index.max_list_size,
                             index.pq_dim, index.pq_bits)
    x = to_device(new_vectors, dev, torch.float32)
    if mt == DistanceType.CosineExpanded:
        x = x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))
    nid = (_ids.make_ids(x.shape[0], device=dev, start=index.size)
           if new_ids is None else to_device(new_ids, dev))
    labels = kmeans_balanced.predict(index.centers, x, km)
    codes, norms = _encode_with_norms(x, index.rotation, index.centers_rot,
                                      labels, index.codebooks,
                                      index.codebook_kind)
    n_lists, L = index.packed_ids.shape
    old_sizes = index.list_sizes.long()
    need = old_sizes + torch.bincount(labels.long(), minlength=n_lists)
    new_L = max(L, max(8, -(-int(need.max()) // 8) * 8))
    id_dt = (torch.int64 if torch.int64 in (index.packed_ids.dtype, nid.dtype)
             else torch.int32)
    packed = torch.zeros((n_lists, new_L, codes_in.shape[2]),
                         dtype=torch.uint8, device=dev)
    ids = torch.full((n_lists, new_L), -1, dtype=id_dt, device=dev)
    pnorm = torch.zeros((n_lists, new_L), device=dev)
    packed[:, :L] = codes_in
    ids[:, :L] = index.packed_ids
    pnorm[:, :L] = index.packed_norms
    order, sorted_l, slot = ic.stable_slots(labels, n_lists, old_sizes)
    keep = slot < new_L
    rows, ls, sl = order[keep], sorted_l[keep], slot[keep]
    packed[ls, sl] = pack_bits(codes, index.pq_bits)[rows]
    ids[ls, sl] = nid[rows].to(id_dt)
    pnorm[ls, sl] = norms[rows]
    out = dataclasses.replace(
        index, packed_codes=packed, packed_ids=ids, packed_norms=pnorm,
        list_sizes=need.clamp(max=new_L).to(torch.int32), packed_recon=None)
    if index.packed_recon is not None:
        out.packed_recon = _build_recon_cache(out)
    _istats.note_index_stats(out, name="ivf_pq.extend", cheap=True)
    return out


# ---------------------------------------------------------------------------
# serialization (reference: neighbors/ivf_pq_serialize.cuh), the JAX
# package's file format
# ---------------------------------------------------------------------------

_SERIAL_VERSION = 2


def save(index: IvfPqIndex, path: str) -> None:
    """Write ``index`` to ``path``; the bf16 cache is derived data: it is
    not written, ``has_recon`` in the metadata rebuilds it on load."""
    _ser.save_arrays(path, "ivf_pq", _SERIAL_VERSION, _meta(index),
                     {name: getattr(index, name) for name in _ARRAY_FIELDS})


def load(path: str, device="cuda") -> IvfPqIndex:
    """Read an index written by :func:`save` or by the JAX package's
    ``ivf_pq.save`` (versions 1 and 2) onto ``device``. A file with
    lane-folded codes (the JAX package's layout for code arrays over 1 GB)
    loads as the row-major view ``[n_lists, L, nb]``; the JAX package's
    fold on load, a TPU layout, is not done here."""
    dev = resolve_device(device)
    version, meta, a = _ser.load_arrays(path, "ivf_pq")
    expects(version in (1, _SERIAL_VERSION), "unsupported ivf_pq version %d",
            version)
    meta = {"codebook_kind": "per_subspace", "pq_bits": 8, **meta}
    meta["pq_dim"] = int(meta.get("pq_dim", 0)) or a["packed_codes"].shape[-1]
    return from_numpy(a, meta, device=dev)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _finish_candidates(dots, cand_ids, cand_norms, q_sq, mt, k,
                       filter_bits=None):
    """⟨q, c+d⟩ per candidate → metric distances, mask, select, id
    gather, cosine flip (shared by the per_query and LUT tiers). Filtered
    candidates are invalid ones (``sample_filter.masked_ids``): a slot
    picked past the kept candidates returns −1, where the JAX package
    returns the slot's own id at an infinite distance."""
    ip_like = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    if ip_like:
        dists, invalid, final_min = dots, float("-inf"), False
    else:
        dists = (q_sq[:, None] - 2.0 * dots + cand_norms).clamp_min(0.0)
        if mt == DistanceType.L2SqrtExpanded:
            dists = torch.sqrt(dists)
        invalid, final_min = float("inf"), True
    cand_ids = _sf.masked_ids(filter_bits, cand_ids)
    dists = torch.where(cand_ids >= 0, dists, torch.full_like(dists, invalid))
    vals, pos = _select_k(dists, k, select_min=final_min)
    ids = torch.gather(cand_ids, 1, pos.long())
    if mt == DistanceType.CosineExpanded:
        vals = 1.0 - vals
    return vals, ids


def _center_sq(index: IvfPqIndex) -> torch.Tensor:
    """‖c‖² of the coarse centers as a row [1, n_lists], made once per
    centers tensor and kept on it (made again if it is written in place),
    so a search batch does not launch it."""
    c = index.centers
    kept = getattr(c, "_rtt_sq", None)
    if kept is None or kept[0] != c._version:
        with torch.inference_mode(False), torch.no_grad():
            kept = c._rtt_sq = (c._version, (c * c).sum(1)[None, :])
    return kept[1]


def _coarse_probes(index: IvfPqIndex, q_all: torch.Tensor, n_probes: int,
                   ip_like: bool):
    """(qc [m, n_lists] = ⟨q, c⟩, probes [m, n_probes] i32)."""
    qc = q_all @ index.centers.T
    if ip_like:
        _, probes = _select_k(qc, n_probes, select_min=False)
    else:
        # c_sq − 2·qc formed inside the select (B3's bias row; 2·qc is
        # exact, so the keys are torch.sub(c_sq, qc, alpha=2)'s)
        _, probes = _select_k(qc, n_probes, select_min=True,
                              bias=_center_sq(index))
    return qc, probes


def _index_tables(probes: torch.Tensor, n_lists: int, seg: int, n_seg: int,
                  qg: int):
    """``segment_probes`` and the LUT scan's launch tables
    (``kernels.lut_scan_tables`` at group size ``qg``) in one function, so
    one CUDA graph replays both."""
    seg_list, seg_q, pair_seg, pair_slot = ic.segment_probes(
        probes, n_lists, seg, n_seg)
    return ((seg_list, seg_q, pair_seg, pair_slot)
            + _k.lut_scan_tables(seg_q, pair_seg, pair_slot, qg))


def _prep_queries(mt, queries: torch.Tensor) -> torch.Tensor:
    q = queries.float()
    if mt == DistanceType.CosineExpanded:
        q = q / torch.sqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-12))
    return q


def _fit_query_tile(want: int, n_probes: int, index: IvfPqIndex) -> int:
    """Largest per_query tile ≤ ``want`` whose per-tile candidate tensors
    stay under 1 GB: the f32 [t, n_probes, L, rot_dim] recon gather on the
    recon-dot branch, or the unpacked codes on the LUT branch, sized on the
    wider of the two (the JAX package's rule; the port's unpacked codes are
    int64, 8 bytes a code); per_cluster, also the f32 [t, n_probes,
    pq_dim, 2^bits] look-up tables."""
    L = index.max_list_size
    row_bytes = max(index.pq_dim * 8, index.rot_dim * 4
                    if index.packed_recon is not None else 0)
    t = (1 << 30) // max(1, n_probes * L * row_bytes)
    if index.codebook_kind == "per_cluster":
        t = min(t, (1 << 30) // max(1, n_probes * index.pq_dim
                                    * index.codebooks.shape[1] * 4))
    return max(1, min(want, t))


def _search_impl(index: IvfPqIndex, queries: torch.Tensor, k: int,
                 n_probes: int, query_tile: int, lut_dtype: str = "float32",
                 filter_bits=None):
    """The per_query tier: each query gathers its probed lists' codes and
    sums its quantized LUT over them — the plain semantic anchor
    (per_cluster: a LUT a probed list, against that list's codebook). With the
    recon cache, an f32 LUT and n_probes·L·pq_dim·2^bits ≥ 2²⁸ it takes
    the JAX package's recon-dot branch instead: one product of the query
    against the gathered bf16 reconstructions, ⟨q, c + d⟩ directly."""
    mt = resolve_metric(index.metric)
    q_all = _prep_queries(mt, queries)
    S, P = index.pq_dim, index.pq_len
    ip_like = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    qc, probes = _coarse_probes(index, q_all, n_probes, ip_like)
    q_rot_all = q_all @ index.rotation.T

    def qlut_of(a, q_rot, probe):
        q_sub = q_rot.view(q_rot.shape[0], S, P)
        if index.codebook_kind == "per_cluster":
            # a table per (query, probed list): ⟨q_s, cb[list][k]⟩
            return _k.round_to_lut_dtype(torch.einsum(
                "tsp,tjkp->tjsk", q_sub, index.codebooks[probe]), lut_dtype)
        return _k.round_to_lut_dtype(torch.einsum(
            "tsp,skp->tsk", q_sub, index.codebooks), lut_dtype)

    return _scan_tiles(index, q_rot_all, qlut_of, qc, probes, k, n_probes,
                       query_tile, lut_dtype == "float32", filter_bits)


def _scan_tiles(index: IvfPqIndex, q_rot_all: torch.Tensor, qlut_of, qc,
                probes, k: int, n_probes: int, query_tile: int,
                recon_ok: bool, filter_bits=None):
    """The per_query scan over query tiles: gather each query's probed
    lists, sum its LUT (``qlut_of(a, q_rot, probe)``: the tile at row
    ``a``, [t, S, K], or per_cluster [t, n_probes, S, K]) over their codes
    — or, with the recon cache, ``recon_ok`` and
    n_probes·L·pq_dim·2^bits ≥ 2²⁸, take one product against the gathered
    bf16 reconstructions — then the shared epilogue."""
    mt = resolve_metric(index.metric)
    S, L = index.pq_dim, index.max_list_size
    q_sq_all = (q_rot_all * q_rot_all).sum(1)
    pr_all = probes.long()
    qc_probed_all = torch.gather(qc, 1, pr_all)
    use_recon_dot = (index.packed_recon is not None and recon_ok
                     and n_probes * L * S * index.codebooks.shape[1]
                     >= (1 << 28))
    vals, out = [], []
    for a in range(0, q_rot_all.shape[0], query_tile):
        q_rot = q_rot_all[a:a + query_tile]
        probe = pr_all[a:a + query_tile]
        t = q_rot.shape[0]
        cand_ids = index.packed_ids[probe].reshape(t, n_probes * L)
        cand_norms = index.packed_norms[probe].reshape(t, n_probes * L)
        if use_recon_dot:
            rows = index.packed_recon[probe].reshape(t, n_probes * L, -1)
            dots = torch.bmm(rows.float(), q_rot[:, :, None])[..., 0]
        else:
            codes = _k.unpack_codes(index.packed_codes[probe], S,
                                    index.pq_bits)
            qlut = qlut_of(a, q_rot, probe)
            if qlut.dim() == 4:
                # per_cluster: [t, n_probes, S, L] look-ups, summed over S
                idx = codes.transpose(2, 3)
                qd = torch.gather(qlut, 3, idx).sum(2).reshape(
                    t, n_probes * L)
            else:
                idx = codes.reshape(t, n_probes * L, S).transpose(1, 2)
                qd = torch.gather(qlut, 2, idx).sum(1)           # [t, C]
            dots = qc_probed_all[a:a + query_tile][:, :, None].expand(
                t, n_probes, L).reshape(t, n_probes * L) + qd
        v, i = _finish_candidates(dots, cand_ids, cand_norms,
                                  q_sq_all[a:a + query_tile], mt, k,
                                  filter_bits)
        vals.append(v)
        out.append(i)
    return torch.cat(vals), torch.cat(out)


def _search_grouped(index: IvfPqIndex, queries: torch.Tensor, k: int,
                    n_probes: int, seg: int, n_seg: int, tier: str,
                    seg_chunk: int = 1, filter_bits=None):
    """The list-centric batch scan over the segment table. ``tier``:
    "segk" the segmented-scan kernel over the bf16 cache (two best per
    strided bin, merged by ``merge_bin_results``); "kernel" the
    grouped-scan kernel over the cache (an exact top-kk a slot; its l2
    keys recompute ‖c + d‖² from the bf16 rows, within ~1e-3 of the
    stored f32 norms, as the JAX package's kernel does); "plain" the plain
    grouped tier (``ivf_common.grouped_scan_plain_tier``) against the
    cache rows or the codes decoded a chunk at a time, with the stored
    norms. Every tier scans the id table masked by ``filter_bits``
    (``sample_filter.masked_ids``): the scans score a slot with id < 0 as
    +inf, so this one operand is the JAX package's masked id table for its
    segmented scan and its ``mask_add = where(valid, 0, inf)`` for its
    grouped scan; the [n_lists, L] mask and table are the transient that
    ``filtered_scan_mem_ok(slot_bytes=5)`` admits."""
    mt = resolve_metric(index.metric)
    q_all = _prep_queries(mt, queries)
    L = index.max_list_size
    ip_like = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    select_min = not ip_like
    invalid = float("-inf") if ip_like else float("inf")
    _, probes = _coarse_probes(index, q_all, n_probes, ip_like)
    seg_list, seg_q, pair_seg, pair_slot = ic.segment_probes(
        probes, index.n_lists, seg, n_seg)
    q_rot = (q_all @ index.rotation.T).contiguous()
    met = "ip" if ip_like else "l2"
    ids = _sf.masked_ids(filter_bits, index.packed_ids)
    if tier == "segk":
        keys, kids = _k.segmented_scan_topk(seg_list, seg_q, q_rot,
                                            index.packed_recon, ids, met)
        out_vals, out_ids = ic.merge_bin_results(keys, kids, pair_seg,
                                                 pair_slot, k, select_min,
                                                 invalid)
    elif tier == "kernel":
        keys, pos = _k.grouped_scan_topk(seg_list, seg_q, q_rot,
                                         index.packed_recon, ids, min(k, L),
                                         met)
        vals, cids = ic.grouped_kernel_results(keys, pos, seg_list, ids,
                                               ip_like)
        out_vals, out_ids = ic.merge_slot_results(vals, cids, pair_seg,
                                                  pair_slot, k, select_min,
                                                  invalid)
    else:
        if index.packed_recon is not None:
            def rows_of(sl):
                return index.packed_recon[sl].float()
        else:
            def rows_of(sl):
                codes = _k.unpack_codes(index.packed_codes[sl],
                                        index.pq_dim, index.pq_bits)
                if index.codebook_kind == "per_cluster":
                    dec = _decode_lists_cluster(codes, index.codebooks[sl])
                else:
                    dec = _decode_codes(codes.reshape(-1, index.pq_dim),
                                        index.codebooks).view(
                                            sl.shape[0], L, -1)
                return dec + index.centers_rot[sl][:, None, :]
        out_vals, out_ids = ic.grouped_scan_plain_tier(
            seg_list, seg_q, pair_seg, pair_slot, q_rot, rows_of,
            ids, k, met, seg_chunk, norms=index.packed_norms)
    if mt == DistanceType.L2SqrtExpanded:
        out_vals = torch.sqrt(out_vals)
    if mt == DistanceType.CosineExpanded:
        out_vals = 1.0 - out_vals
    return out_vals, out_ids


def _search_lut_pallas(index: IvfPqIndex, queries: torch.Tensor, k: int,
                       n_probes: int, seg: int, n_seg: int,
                       lut_dtype: str = "float32", filter_bits=None):
    """The ``scan_select="pallas"`` tier: coarse probes, segmenting, the
    LUT-scan kernel over packed codes (its [B, n_probes, 256] bins already
    in pair order), then the per-query merge of the [B, n_probes·256] bin
    survivors through :func:`_finish_candidates`. ``filter_bits`` goes to
    the kernel as per-list keep bytes over the id table it scans
    (``sample_filter.list_filter_bytes``, n/8 bytes, made once per filter
    and index), so the bins hold only kept rows. The JAX package tests
    the filter again in the epilogue, a no-op on the kernel's output that
    reads the bitset once per bin candidate; the port does not, so a
    filtered id that came out of the kernel would reach the caller, where
    ``chip_smoke.py`` looks for one."""
    mt = resolve_metric(index.metric)
    q_all = _prep_queries(mt, queries)
    B = q_all.shape[0]
    ip_like = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    fbytes = (None if filter_bits is None
              else _sf.list_filter_bytes(filter_bits, index.packed_ids))
    # A batch alone waits for the host until the scan launches, so the
    # segmenting and the scan's launch tables replay from one CUDA graph
    # on the card (``utils.graphs``: one launch for ~35; the scan reads
    # them inside the block).
    fit = _k.lut_scan_fit(index.pq_dim, 1 << index.pq_bits, index.rot_dim,
                          seg, index.packed_codes.shape[-1])
    tabled = q_all.is_cuda and fit is not None
    _, probes = _coarse_probes(index, q_all, n_probes, ip_like)
    q_rot = (q_all @ index.rotation.T).contiguous()
    with (_graphs.replayed(_index_tables, (probes,), index.n_lists, seg,
                           n_seg, fit[0]) if tabled else
          _graphs.replayed(ic.segment_probes, (probes,), index.n_lists, seg,
                           n_seg)) as tabs:
        keys, kids = _k.ivfpq_lut_scan_topk(
            *tabs[:4], q_rot, index.packed_codes, index.packed_ids,
            index.packed_norms, index.list_sizes, index.centers_rot,
            index.codebooks, "ip" if ip_like else "l2",
            pq_bits=index.pq_bits, pq_dim=index.pq_dim,
            L=index.max_list_size, lut_dtype=lut_dtype, filter_bytes=fbytes,
            tables=tabs[4:] if tabled else None)
    q_sq = (q_rot * q_rot).sum(1)
    C = n_probes * keys.shape[-1]
    pv = keys.view(B, C)
    pi = kids.view(B, C)
    # minimized keys → the shared epilogue's ⟨q, c+d⟩ with zero norms
    dots = -pv if ip_like else -0.5 * pv
    kq = min(k, C)
    out_vals, out_ids = _finish_candidates(dots, pi, torch.zeros_like(pv),
                                           q_sq, mt, kq)
    if k > kq:
        invalid = (float("-inf") if ip_like and
                   mt != DistanceType.CosineExpanded else float("inf"))
        out_vals = torch.nn.functional.pad(out_vals, (0, k - kq),
                                           value=invalid)
        out_ids = torch.nn.functional.pad(out_ids, (0, k - kq), value=-1)
    return out_vals, out_ids


# the grouped tiers under the JAX package's dispatch labels
_TIER_LABELS = {"segk": "segk", "kernel": "grouped_pallas",
                "plain": "grouped_xla"}

_LUT_FALLBACK_DETAIL = {
    "bin_capacity": "too few probes for the requested k (needs "
                    "n_probes·256 ≥ k)",
    "per_cluster": "per_cluster codebooks (the kernel decodes "
                   "per_subspace only)",
    "mem_guard": "the lut_scan_mem_ok memory guard declined the shape",
    "kernel_ineligible": "RAFT_TPU_PALLAS_LUTSCAN=off turns the kernel "
                         "tier off",
}
_lut_fallback_warned = False


def _warn_lut_fallback(reason: str) -> None:
    """Once a process: an explicit scan_select="pallas" fell to "approx"."""
    global _lut_fallback_warned
    if _lut_fallback_warned:
        return
    _lut_fallback_warned = True
    warnings.warn(f"ivf_pq: scan_select='pallas' requested but the LUT-scan "
                  f"kernel cannot serve this search — reason={reason}: "
                  f"{_LUT_FALLBACK_DETAIL[reason]} — falling back to "
                  "scan_select='approx'", RuntimeWarning, stacklevel=4)


@traced("raft_tpu_torch.ivf_pq.search")
def search(index: IvfPqIndex, queries, k: int,
           params: Optional[SearchParams] = None, filter_bitset=None,
           dataset=None, *, mesh=None, mesh_axis="shard",
           merge: str = "auto", device="cuda"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference: ivf_pq::search) → (distances [m, k], ids [m, k]
    int32). ``params.refine="f32_regen"`` re-ranks k·refine_ratio
    candidates exactly against ``dataset`` (a tensor on the index's
    device, a host numpy array or memmap, or a device-chunk provider;
    ``refine.route_refined``). ``filter_bitset``: a packed bitset over dataset rows
    (``core.bitset`` words, numpy uint32 or a tensor); rows whose bit is
    clear are never returned. Handed a ``parallel.ShardedIvfPq`` and its
    ``mesh``, the search routes to the sharded tier
    (``parallel.search_ivf_pq``: per-rank scan, re-rank against
    ``dataset``'s rows when refined, the merge picked by ``merge`` over
    ``mesh_axis``)."""
    if params is None:
        params = SearchParams()
    dev = resolve_device(device)
    _precision.enforce()
    _divf = ic.sharded_dispatch(index, mesh, "ShardedIvfPq")
    if _divf is not None:
        expects(mesh.devices[0].type == dev.type,
                "the mesh's ranks live on %s, search asked for %s",
                mesh.devices[0], dev)
        return _divf.search_ivf_pq(params, index, queries, k, mesh,
                                   axis=mesh_axis, dataset=dataset,
                                   merge=merge, filter_bitset=filter_bitset)
    expects(index.device.type == dev.type,
            "index lives on %s, search asked for %s", index.device, dev)
    filtered = filter_bitset is not None
    if filtered:
        filter_bitset = _bitset.as_words(filter_bitset, index.device)
    q = to_device(queries, index.device, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be [m, %d]", index.dim)
    _faults.faultpoint("ivf_pq.search")
    if params.refine != "none":
        from raft_tpu_torch.neighbors import refine as _refine

        return _refine.route_refined(_refined_scan, index, q, k, params,
                                     dataset, device,
                                     filter_bitset=filter_bitset)
    return _search_scan(index, q, k, params, filter_bitset, device)


def _refined_scan(index: IvfPqIndex, q: torch.Tensor, k: int,
                  params: SearchParams, filter_bitset=None, device="cuda"):
    """The scan of a refined search, called by ``refine.route_refined`` on
    the arguments :func:`search` validated: the ``ivf_pq.search`` span and
    fault site of the JAX package's second call to its public ``search``,
    without that call's validation and routing."""
    with span("ivf_pq.search") as sp:
        _faults.faultpoint("ivf_pq.search")
        out = _search_scan(index, q, k, params, filter_bitset, device)
        sp.attach(out)
        return out


def _search_scan(index: IvfPqIndex, q: torch.Tensor, k: int,
                 params: SearchParams, filter_bitset, device):
    """The unrefined search behind :func:`search`: ``q`` f32 on the
    index's device, ``filter_bitset`` its words (or None)."""
    filtered = filter_bitset is not None
    if params.lut_dtype == "auto":
        # only kept candidates fill the bins: the filter's selectivity
        # discounts the fp8 slack
        params = dataclasses.replace(params, lut_dtype=resolve_lut_dtype(
            "auto", min(params.n_probes, index.n_lists), k,
            selectivity=_filter_selectivity(filter_bitset)))
    if (_obs_spans.stages_enabled() and _obs_spans._trace_clean()
            and not filtered and index.codebook_kind == "per_subspace"):
        # observability stage mode: coarse_quantize, lut and scan as
        # separate stages, each under a recording span
        _count_scan_dispatch("staged")
        return search_staged(index, q, k, params, device=device)
    n_probes = min(params.n_probes, index.n_lists)
    B = q.shape[0]
    mode = params.scan_mode
    if mode == "auto":
        mode = ("grouped" if (B * n_probes >= 2 * index.n_lists
                              or params.scan_select == "pallas")
                else "per_query")
    if mode == "grouped":
        seg = ic.SEGMENT_SIZE
        pairs = B * n_probes
        n_seg = ic.n_segments(pairs, index.n_lists, seg)
        L = index.max_list_size
        kk = min(k, L)
        has_recon = index.packed_recon is not None
        # the LUT-scan tier: asked for, or the approx tier at oversampled
        # shapes with no cache to scan instead; it needs n_probes·256 ≥ k
        # bins and its memory guard, else an explicit request falls to
        # approx, as in the JAX package
        lut_desired = (params.scan_select == "pallas"
                       or (params.scan_select == "approx" and not has_recon
                           and (n_probes >= 64 or k >= 400)))
        select = params.scan_select
        if lut_desired:
            mem_ok = (ic.lut_scan_mem_ok(n_seg, seg, index.rot_dim, pairs,
                                         _k.LUT_SCAN_BINS)
                      and (not filtered
                           or ic.filtered_scan_mem_ok(index.n_lists, L)))
            reason = ("bin_capacity" if n_probes * _k.LUT_SCAN_BINS < k
                      else "per_cluster"
                      if index.codebook_kind != "per_subspace" else None)
            if reason is None and not (
                    mem_ok and not _faults.forced("ivf_pq.scan.mem_guard")):
                reason = "mem_guard"
                # the guard's pre-emptive decline counts the degrade.steps
                # move a reactive walk would
                _degrade.note_step(
                    "ivf_pq.search", "pallas_lut", "grouped_" + (
                        "approx" if params.scan_select == "pallas"
                        else select), "mem_guard")
            if reason is None and _obs_spans.env_tristate(
                    "RAFT_TPU_PALLAS_LUTSCAN") == "off":
                # the JAX package's kernel gate turned off: the grouped
                # tiers answer ("on" keeps every gate above)
                reason = "kernel_ineligible"
            if reason is not None:
                _obs_spans.count_fallback("ivf_pq.scan", reason)
            if reason is None:
                _count_scan_dispatch("pallas_lut", filtered)
                with span("scan") as sp:
                    out = _search_lut_pallas(index, q, k, n_probes, seg,
                                             n_seg, lut_dtype=params.lut_dtype,
                                             filter_bits=filter_bitset)
                    sp.attach(out)
                return out
            if params.scan_select == "pallas":
                _warn_lut_fallback(reason)
                select = "approx"
        if params.scan_mode == "grouped" or ic.grouped_mem_ok(
                n_seg, seg, kk, pairs):
            # the kernels scan the bf16 cache only; without it every
            # grouped search is the plain tier, as in the JAX package. A
            # filtered segk scans a masked id table, admitted by its
            # 5-byte-a-slot guard
            tier = (ic.grouped_tier(select == "approx", kk) if has_recon
                    else "plain")
            if (tier == "segk" and filtered
                    and not ic.filtered_scan_mem_ok(index.n_lists, L, 5)):
                tier = "plain"
            _count_scan_dispatch(_TIER_LABELS[tier], filtered)
            return _search_grouped(
                index, q, k, n_probes, seg, n_seg, tier,
                ic.fit_seg_chunk(seg, L, index.rot_dim, params.list_chunk),
                filter_bits=filter_bitset)
    _count_scan_dispatch("per_query", filtered)
    return _search_impl(index, q, k, n_probes,
                        _fit_query_tile(params.query_tile, n_probes, index),
                        lut_dtype=params.lut_dtype, filter_bits=filter_bitset)


@traced("raft_tpu_torch.ivf_pq.search_resilient")
def search_resilient(index: IvfPqIndex, queries, k: int,
                     params: Optional[SearchParams] = None,
                     filter_bitset=None, dataset=None, deadline=None, *,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`search` behind the standard degradation ladder
    (:mod:`raft_tpu_torch.robust.degrade`): a RESOURCE_EXHAUSTED (a
    ``torch.OutOfMemoryError``, or an injected one) walks halve batch →
    bf16 LUT → fp8 LUT → demote raw → decline fused tier → host gather
    (then keeps halving) instead of failing the request, counting every
    move in ``degrade.steps{site=ivf_pq.search,from=,to=,reason=}``.
    Results are the degraded configuration's: batch splitting is exact,
    ``demote_raw`` keeps the re-rank exact through the host tiers, and
    the LUT and declined-tier rungs trade their precision and speed
    margins. ``deadline`` (a ``robust.retry.Deadline``) is the request's
    one wall-clock budget: the walk aborts with ``DeadlineExceeded``
    instead of retrying past it.

    ``lut_dtype="auto"`` is resolved before the ladder exactly as the
    wrapped search would (refined searches select over k·refine_ratio),
    so the LUT rungs see the dtype dispatch runs with: on the card an
    oversampled shape is already fp8, and both LUT rungs skip."""
    if params is None:
        params = SearchParams()
    resolve_device(device)
    q = to_device(queries, index.device, torch.float32)
    if params.lut_dtype == "auto":
        kr = k if params.refine == "none" else max(
            k, int(round(k * params.refine_ratio)))
        fb = (None if filter_bitset is None
              else _bitset.as_words(filter_bitset, index.device))
        params = dataclasses.replace(params, lut_dtype=resolve_lut_dtype(
            "auto", min(params.n_probes, index.n_lists), kr,
            selectivity=_filter_selectivity(fb)))

    def search_fn(index, queries, k, params, filter_bitset, dataset):
        return search(index, queries, k, params, filter_bitset, dataset,
                      device=device)

    return _degrade.run_with_degradation(
        _degrade.batched_search_call(search_fn, index, q, k, filter_bitset,
                                     deadline=deadline,
                                     site="ivf_pq.search"),
        {"params": params, "dataset": dataset},
        _degrade.standard_search_ladder(q.shape[0], has_lut=True),
        site="ivf_pq.search", deadline=deadline)


def search_staged(index: IvfPqIndex, queries, k: int,
                  params: Optional[SearchParams] = None, *, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-decomposed search for observability (the JAX package's
    ``search_staged``): coarse_quantize, lut and scan run as separate
    stages, each under a recording :func:`span` — with sync mode on, the
    spans attribute *device* time per stage. Exact f32-LUT per_query
    semantics (the whole batch's LUT built in one product, then the
    per_query tier's tile scan); results match :func:`search`'s per_query
    tier. :func:`search` routes unrefined, unfiltered searches here when
    obs stage mode is enabled."""
    if params is None:
        params = SearchParams()
    dev = resolve_device(device)
    _precision.enforce()
    expects(index.device.type == dev.type,
            "index lives on %s, search asked for %s", index.device, dev)
    q = to_device(queries, index.device, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be [m, %d]", index.dim)
    expects(index.codebook_kind == "per_subspace",
            "search_staged supports per_subspace codebooks only")
    mt = resolve_metric(index.metric)
    ip_like = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    n_probes = min(params.n_probes, index.n_lists)
    q_all = _prep_queries(mt, q)
    with span("coarse_quantize") as sp:
        qc, probes = _coarse_probes(index, q_all, n_probes, ip_like)
        sp.attach(qc, probes)
    with span("lut") as sp:
        # rotate the queries and build the query-only LUT [m, S, K] in one
        # batched product
        q_rot = q_all @ index.rotation.T
        qlut = torch.einsum("msp,skp->msk", q_rot.view(
            q_rot.shape[0], index.pq_dim, index.pq_len), index.codebooks)
        sp.attach(q_rot, qlut)
    with span("scan") as sp:
        out = _scan_tiles(
            index, q_rot, lambda a, t, probe: qlut[a:a + t.shape[0]], qc,
            probes,
            k, n_probes, _fit_query_tile(params.query_tile, n_probes, index),
            True)
        sp.attach(out)
    return out
