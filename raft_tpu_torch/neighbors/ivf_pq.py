"""IVF-PQ — inverted-file index with product-quantized residuals
(counterpart of ``raft_tpu.neighbors.ivf_pq``).

The asymmetric distance decomposes as
    ‖q − (c + d)‖² = ‖q‖² − 2⟨q, c⟩ − 2⟨q, d⟩ + ‖c + d‖²
with ‖c + d‖² precomputed per candidate at build and ⟨q, d⟩ = Σ_s
LUT[s, code_s] from a query-only look-up table.

Ported: ``build`` with balanced k-means coarse centers, a random
rotation, per_subspace codebooks, bit-packed 4–8-bit codes, ``spill``,
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
per_query tier and the re-rank test the bitset itself. What is not ported
(per_cluster codebooks, folded codes) raises ``NotImplementedError``
naming its ROADMAP item — it never substitutes another tier.
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
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.random.rng import RngState
from raft_tpu_torch.robust import degrade as _degrade
from raft_tpu_torch.robust import faults as _faults
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
    codebook_kind: str = "per_subspace"  # "per_cluster" not ported (A9)
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
    otherwise and off the card. Explicit dtypes pass through."""
    if lut_dtype != "auto":
        return lut_dtype
    oversampled = n_probes >= 64 or k >= 400
    if oversampled and _k._on_cuda():
        surviving = selectivity * n_probes * _k.LUT_SCAN_BINS
        return ("float8_e4m3" if surviving >= FP8_LUT_MIN_SLACK * k
                else "bfloat16")
    return "float32"


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
    codebooks: torch.Tensor      # [pq_dim, 2^bits, pq_len] f32
    packed_codes: torch.Tensor   # [n_lists, L, nb] u8 (unfolded)
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


def _check_unfolded(packed_codes, pq_dim: int, pq_bits: int) -> None:
    if packed_codes.shape[-1] != packed_nbytes(
            pq_dim or packed_codes.shape[-1], pq_bits):
        raise _not_ported("folded code storage", "A9")


def from_numpy(arrays: Dict[str, np.ndarray], meta: Dict, device="cuda"
               ) -> IvfPqIndex:
    """Index from the JAX index's fields as numpy arrays (``arrays``) and
    its static fields (``meta``: metric, pq_bits, pq_dim, codebook_kind,
    has_recon). The bf16 cache never crosses as an array (numpy has no
    bf16): ``has_recon`` rebuilds it here, as the JAX package's ``load``
    does."""
    dev = resolve_device(device)
    if meta.get("codebook_kind", "per_subspace") != "per_subspace":
        raise _not_ported("per_cluster codebooks", "A9")
    pq_dim = int(meta.get("pq_dim", 0))
    pq_bits = int(meta.get("pq_bits", 8))
    _check_unfolded(np.asarray(arrays["packed_codes"]), pq_dim, pq_bits)
    t = {name: to_device(np.asarray(arrays[name]), dev) for name in _ARRAY_FIELDS}
    index = IvfPqIndex(**t, metric=str(meta["metric"]),
                       codebook_kind="per_subspace", pq_bits=pq_bits,
                       pq_dim_static=pq_dim)
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


def _train_quantizers(trainset: torch.Tensor, params: IndexParams, dim: int,
                      pq_dim: int, pq_len: int, K: int, state: RngState,
                      km: KMeansBalancedParams,
                      max_codebook_rows: int = 1 << 16):
    """Coarse centers + rotation + per_subspace codebooks."""
    n_train = trainset.shape[0]
    rot_dim = pq_dim * pq_len
    centers = kmeans_balanced.fit(trainset, params.n_lists, km)
    rotation = make_rotation_matrix(state.fold(1), rot_dim, dim,
                                    trainset.device)
    centers_rot = centers @ rotation.T
    stride = max(1, -(-n_train // max_codebook_rows))
    tr_cb = trainset[::stride]
    n_cb = tr_cb.shape[0]
    cb_labels = kmeans_balanced.predict(centers, tr_cb, km)
    tr_res = tr_cb @ rotation.T - centers_rot[cb_labels.long()]
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


def _encode_with_norms(x: torch.Tensor, rotation: torch.Tensor,
                       centers_rot: torch.Tensor, labels: torch.Tensor,
                       codebooks: torch.Tensor, block: int = 16384):
    """(codes [n, S] u8, ‖c + decoded‖² [n] f32) per_subspace, in row
    blocks; rows are rotated per block (``x @ rotationᵀ``)."""
    S, K, P = codebooks.shape
    n = x.shape[0]
    cb_sq = (codebooks * codebooks).sum(-1)                   # [S, K]
    codes = torch.empty((n, S), dtype=torch.uint8, device=x.device)
    norms = torch.empty((n,), dtype=torch.float32, device=x.device)
    for a in range(0, n, block):
        lbl = labels[a:a + block].long()
        rows = x[a:a + block] @ rotation.T
        res = rows - centers_rot[lbl]
        sub = res.view(res.shape[0], S, P).transpose(0, 1)    # [S, b, P]
        d2 = ((sub * sub).sum(-1)[..., None] + cb_sq[:, None, :]
              - 2.0 * torch.bmm(sub, codebooks.transpose(1, 2)))  # [S, b, K]
        c = d2.argmin(-1).T                                   # [b, S]
        codes[a:a + block] = c.to(torch.uint8)
        rec = centers_rot[lbl] + _decode_codes(c, codebooks)
        norms[a:a + block] = (rec * rec).sum(1)
    return codes, norms


def _want_recon_cache(params: IndexParams, n_lists: int, L: int,
                      rot_dim: int, device) -> bool:
    """The JAX package's rule: "auto" caches while the bf16 cache stays
    under 3 GB and a fifth of the device's memory."""
    if params.cache_reconstruction in ("never", "always"):
        return params.cache_reconstruction == "always"
    cap = 3 << 30
    if device.type == "cuda":
        cap = min(cap, torch.cuda.get_device_properties(device)
                  .total_memory // 5)
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
        dec = _decode_codes(codes.reshape(chunk * L, S),
                            index.codebooks).view(chunk, L, -1)
        out[a:a + chunk] = (dec + index.centers_rot[a:a + chunk, None, :]
                            ).to(torch.bfloat16)
    return out


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
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    if params.codebook_kind != "per_subspace":
        raise _not_ported("codebook_kind='per_cluster'", "A9")
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
                     codebook_kind="per_subspace", pq_bits=params.pq_bits,
                     pq_dim_static=pq_dim)
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
                              stacklevel=2)
        else:
            labels = kmeans_balanced.predict(centers, x, km)
            counts = torch.bincount(labels.long(),
                                    minlength=params.n_lists).cpu().numpy()
            max_list_size = ic._fit_list_size(counts, avg,
                                              params.list_size_cap_factor)
    with stage("encode"):
        codes, norms = _encode_with_norms(
            x, rotation, centers_rot, labels.clamp(0, params.n_lists - 1),
            codebooks)
        codes_p = pack_bits(codes, params.pq_bits)
        del codes
    with stage("pack"):
        (packed, pnorm), ids, sizes, n_drop, _ = ic.pack_lists(
            [codes_p, norms], labels, _ids.make_ids(n, device=dev),
            n_lists=params.n_lists, L=max_list_size, fill_values=[0, 0.0])
    if n_drop:
        warnings.warn(f"ivf_pq: dropped {n_drop} overflow vectors (raise "
                      "list_size_cap_factor)", RuntimeWarning, stacklevel=2)
    index = IvfPqIndex(packed_codes=packed, packed_ids=ids,
                       packed_norms=pnorm, list_sizes=sizes, **quantizer)
    if _want_recon_cache(params, params.n_lists, max_list_size, rot_dim, dev):
        with stage("recon_cache"):
            index.packed_recon = _build_recon_cache(index)
    return index


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
    _check_unfolded(index.packed_codes, index.pq_dim, index.pq_bits)
    x = to_device(new_vectors, dev, torch.float32)
    if mt == DistanceType.CosineExpanded:
        x = x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))
    nid = (_ids.make_ids(x.shape[0], device=dev, start=index.size)
           if new_ids is None else to_device(new_ids, dev))
    labels = kmeans_balanced.predict(index.centers, x, km)
    codes, norms = _encode_with_norms(x, index.rotation, index.centers_rot,
                                      labels, index.codebooks)
    n_lists, L = index.packed_ids.shape
    old_sizes = index.list_sizes.long()
    need = old_sizes + torch.bincount(labels.long(), minlength=n_lists)
    new_L = max(L, max(8, -(-int(need.max()) // 8) * 8))
    id_dt = (torch.int64 if torch.int64 in (index.packed_ids.dtype, nid.dtype)
             else torch.int32)
    packed = torch.zeros((n_lists, new_L, index.packed_codes.shape[2]),
                         dtype=torch.uint8, device=dev)
    ids = torch.full((n_lists, new_L), -1, dtype=id_dt, device=dev)
    pnorm = torch.zeros((n_lists, new_L), device=dev)
    packed[:, :L] = index.packed_codes
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
    ``ivf_pq.save`` (versions 1 and 2) onto ``device``. Folded code
    storage (a TPU layout) is not ported; the JAX package's lane fold of
    big code arrays on load is a TPU layout and is not done here."""
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


def _coarse_probes(index: IvfPqIndex, q_all: torch.Tensor, n_probes: int,
                   ip_like: bool):
    """(qc [m, n_lists] = ⟨q, c⟩, probes [m, n_probes] i32)."""
    qc = q_all @ index.centers.T
    if ip_like:
        _, probes = _select_k(qc, n_probes, select_min=False)
    else:
        c_sq = (index.centers * index.centers).sum(1)
        _, probes = _select_k(c_sq[None, :] - 2.0 * qc, n_probes,
                              select_min=True)
    return qc, probes


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
    int64, 8 bytes a code)."""
    L = index.max_list_size
    row_bytes = max(index.pq_dim * 8, index.rot_dim * 4
                    if index.packed_recon is not None else 0)
    return max(1, min(want, (1 << 30) // max(1, n_probes * L * row_bytes)))


def _search_impl(index: IvfPqIndex, queries: torch.Tensor, k: int,
                 n_probes: int, query_tile: int, lut_dtype: str = "float32",
                 filter_bits=None):
    """The per_query tier: each query gathers its probed lists' codes and
    sums its quantized LUT over them — the plain semantic anchor. With the
    recon cache, an f32 LUT and n_probes·L·pq_dim·2^bits ≥ 2²⁸ it takes
    the JAX package's recon-dot branch instead: one product of the query
    against the gathered bf16 reconstructions, ⟨q, c + d⟩ directly."""
    mt = resolve_metric(index.metric)
    q_all = _prep_queries(mt, queries)
    S, P, L = index.pq_dim, index.pq_len, index.max_list_size
    ip_like = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    qc, probes = _coarse_probes(index, q_all, n_probes, ip_like)
    q_rot_all = q_all @ index.rotation.T
    q_sq_all = (q_rot_all * q_rot_all).sum(1)
    pr_all = probes.long()
    qc_probed_all = torch.gather(qc, 1, pr_all)
    use_recon_dot = (index.packed_recon is not None
                     and lut_dtype == "float32"
                     and n_probes * L * S * index.codebooks.shape[1]
                     >= (1 << 28))
    vals, out = [], []
    for a in range(0, q_all.shape[0], query_tile):
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
            qlut = _k.round_to_lut_dtype(torch.einsum(
                "tsp,skp->tsk", q_rot.view(t, S, P), index.codebooks),
                lut_dtype)
            idx = codes.reshape(t, n_probes * L, S).transpose(1, 2)  # [t, S, C]
            qd = torch.gather(qlut, 2, idx).sum(1)                   # [t, C]
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
                dec = _decode_codes(codes.reshape(-1, index.pq_dim),
                                    index.codebooks).view(sl.shape[0], L, -1)
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
    _, probes = _coarse_probes(index, q_all, n_probes, ip_like)
    seg_list, seg_q, pair_seg, pair_slot = ic.segment_probes(
        probes, index.n_lists, seg, n_seg)
    q_rot = (q_all @ index.rotation.T).contiguous()
    q_sq = (q_rot * q_rot).sum(1)
    fbytes = (None if filter_bits is None
              else _sf.list_filter_bytes(filter_bits, index.packed_ids))
    keys, kids = _k.ivfpq_lut_scan_topk(
        seg_list, seg_q, pair_seg, pair_slot, q_rot, index.packed_codes,
        index.packed_ids, index.packed_norms, index.list_sizes,
        index.centers_rot, index.codebooks, "ip" if ip_like else "l2",
        pq_bits=index.pq_bits, pq_dim=index.pq_dim, L=index.max_list_size,
        lut_dtype=lut_dtype, filter_bytes=fbytes)
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
    "mem_guard": "the lut_scan_mem_ok memory guard declined the shape",
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
                  "scan_select='approx'", RuntimeWarning, stacklevel=3)


def search(index: IvfPqIndex, queries, k: int,
           params: Optional[SearchParams] = None, filter_bitset=None,
           dataset=None, *, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference: ivf_pq::search) → (distances [m, k], ids [m, k]
    int32). ``params.refine="f32_regen"`` re-ranks k·refine_ratio
    candidates exactly against ``dataset`` (a tensor on the index's
    device, a host numpy array or memmap, or a device-chunk provider;
    ``refine.route_refined``). ``filter_bitset``: a packed bitset over dataset rows
    (``core.bitset`` words, numpy uint32 or a tensor); rows whose bit is
    clear are never returned."""
    if params is None:
        params = SearchParams()
    dev = resolve_device(device)
    _precision.enforce()
    expects(index.device.type == dev.type,
            "index lives on %s, search asked for %s", index.device, dev)
    filtered = filter_bitset is not None
    if filtered:
        filter_bitset = _bitset.as_words(filter_bitset, index.device)
    q = to_device(queries, index.device, torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be [m, %d]", index.dim)
    _faults.faultpoint("ivf_pq.search")
    if params.lut_dtype == "auto" and params.refine == "none":
        # only kept candidates fill the bins: the filter's selectivity
        # discounts the fp8 slack
        params = dataclasses.replace(params, lut_dtype=resolve_lut_dtype(
            "auto", min(params.n_probes, index.n_lists), k,
            selectivity=_filter_selectivity(filter_bitset)))
    if params.refine != "none":
        from raft_tpu_torch.neighbors import refine as _refine

        return _refine.route_refined(search, index, q, k, params, dataset,
                                     device, filter_bitset=filter_bitset)
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
            reason = "bin_capacity" if n_probes * _k.LUT_SCAN_BINS < k \
                else None
            if reason is None and not (
                    mem_ok and not _faults.forced("ivf_pq.scan.mem_guard")):
                reason = "mem_guard"
                # the guard's pre-emptive decline counts the degrade.steps
                # move a reactive walk would
                _degrade.note_step(
                    "ivf_pq.search", "pallas_lut", "grouped_" + (
                        "approx" if params.scan_select == "pallas"
                        else select), "mem_guard")
            if reason is not None:
                _obs_spans.count_fallback("ivf_pq.scan", reason)
            if reason is None:
                _count_scan_dispatch("pallas_lut", filtered)
                return _search_lut_pallas(index, q, k, n_probes, seg, n_seg,
                                          lut_dtype=params.lut_dtype,
                                          filter_bits=filter_bitset)
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
