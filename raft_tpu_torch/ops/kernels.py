"""The port's eight hand-written Hopper kernels, their wrappers and their
plain PyTorch versions — the counterpart of
``raft_tpu/ops/pallas_kernels.py``.

| wrapper                 | replaces (raft_tpu/ops/pallas_kernels.py) | source                    |
|-------------------------|-------------------------------------------|---------------------------|
| ``fused_l2_argmin``     | ``fused_l2_argmin`` l.112                 | csrc/fused_l2_argmin.cu   |
| ``select_k_cuda``       | ``select_k_pallas`` l.1317                | csrc/select_k.cu          |
| ``ivfpq_lut_scan_topk`` | ``ivfpq_lut_scan_topk`` l.807             | csrc/ivfpq_lut_scan.cu    |
| ``gather_refine_topk``  | ``gather_refine_topk`` l.1176             | csrc/gather_refine.cu     |
| ``segmented_scan_topk`` | ``segmented_scan_topk`` l.397             | csrc/segmented_scan.cu    |
| ``grouped_scan_topk``   | ``grouped_scan_topk`` l.281               | csrc/grouped_scan.cu      |
| ``ring_topk_merge``     | ``ring_topk_merge`` l.1581                | csrc/ring_topk.cu         |
| ``ring_lut_scan_merge`` | ``ring_lut_scan_merge`` l.2010            | csrc/ring_lut_scan.cu     |

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, and then:

- on CUDA tensors launches its kernel on ``torch.cuda.current_stream()``
  and raises if the C function reports a CUDA error — there is no
  fallback on the card;
- on CPU tensors runs its plain PyTorch version (``*_plain``), which the
  CPU tests hold against the JAX package and ``chip_smoke.py`` holds
  against the kernel on the card.

The two ring kernels take one tensor per rank of a mesh (a list, each
on its rank's device; see ``parallel.mesh``) and return one per rank.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (the
CPU path counts nothing); the three that take a filter operand count the
launches that took one in ``<wrapper>.filtered_launches`` too. The source
notes in ``csrc/`` give each kernel's bound on the H100 and what its
design does about it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.errors import expects, not_ported
from raft_tpu_torch.ops import build as _build
from raft_tpu_torch.utils import graphs as _graphs

# Bin-table width of the LUT scan: two best per strided bin of 128.
LUT_SCAN_BINS = 256
LUT_SCAN_LANES = 128
# Merge budget of the in-kernel top-k (two buffer slots per lane).
GATHER_REFINE_MAX_K = 64
SELECT_K_MAX_K = 64
# Dynamic shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232448


def _on_cuda() -> bool:
    """Whether a CUDA card is present — the counterpart of
    ``pallas_kernels._on_tpu``."""
    return torch.cuda.is_available()


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands (launch the kernel), False for CPU operands
    (run the plain version). Mixed or other devices raise."""
    dev = {t.device for t in tensors}
    expects(len(dev) == 1, "kernel operands on several devices: %s", dev)
    kind = next(iter(dev)).type
    expects(kind in ("cuda", "cpu"), "unsupported device %s", kind)
    return kind == "cuda"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype == dtype and t.dim() == ndim and t.is_contiguous():
        return  # the messages below are built only for a failing operand
    expects(t.dtype == dtype, "%s must be %s (got %s)", name, dtype, t.dtype)
    expects(t.dim() == ndim, "%s must be %d-D (got shape %s)", name, ndim,
            tuple(t.shape))
    expects(t.is_contiguous(), "%s must be contiguous", name)


def _ptr(t: torch.Tensor):
    return t.data_ptr()


def _stream(device=None):
    """Raw handle of the current stream on ``device`` (a CUDA
    ``torch.device``; the current card when None or without an index)."""
    index = None if device is None else device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _lib(name: str):
    return _build.LIBRARIES.get(name)


# ---------------------------------------------------------------------------
# fused L2 argmin
# ---------------------------------------------------------------------------

def fused_l2_argmin_plain(x: torch.Tensor, y: torch.Tensor,
                          tile: int = 4096, row_chunk: int = 1 << 18
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min over y of max(‖x‖² + ‖y‖² − 2⟨x, y⟩, 0), its argmin): y tiles
    with a running (min, argmin), first index on ties, strict ``<``
    across tiles — the semantics of the TPU kernel. x goes in row chunks
    so the [chunk, tile] block stays bounded."""
    y_sq = (y * y).sum(1)
    best_d = torch.full((x.shape[0],), float("inf"), dtype=torch.float32,
                        device=x.device)
    best_i = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    for r in range(0, x.shape[0], row_chunk):
        xc = x[r:r + row_chunk]
        x_sq = (xc * xc).sum(1)
        bd_r, bi_r = best_d[r:r + row_chunk], best_i[r:r + row_chunk]
        for a in range(0, y.shape[0], tile):
            d2 = (x_sq[:, None] + y_sq[None, a:a + tile]
                  - 2.0 * (xc @ y[a:a + tile].T)).clamp_min_(0.0)
            bd, bi = d2.min(1)
            take = bd < bd_r
            bd_r.copy_(torch.where(take, bd, bd_r))
            bi_r.copy_(torch.where(take, (bi + a).to(torch.int32), bi_r))
    return best_d, best_i


def fused_l2_argmin(x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min squared L2 distance of each x row to the y rows, and its
    argmin (x [m, d] f32, y [n, d] f32 → [m] f32, [m] i32). The kernel
    computes ⟨x, y⟩ as three TF32 products of split operands on the
    tensor cores (csrc/fused_l2_argmin.cu), at any d."""
    _check(x, "x", torch.float32, 2)
    _check(y, "y", torch.float32, 2)
    expects(x.shape[1] == y.shape[1], "x/y feature dims differ: %d vs %d",
            x.shape[1], y.shape[1])
    expects(y.shape[0] > 0, "y must have at least one row")
    if not _use_kernel(x, y):
        return fused_l2_argmin_plain(x, y)
    m, d = x.shape
    n = y.shape[0]
    lib = _lib("fused_l2_argmin")
    out_d = torch.empty((m,), dtype=torch.float32, device=x.device)
    out_i = torch.empty((m,), dtype=torch.int32, device=x.device)
    scratch = torch.empty((lib.rtt_fused_l2_argmin_scratch_floats(n, d),),
                          dtype=torch.float32, device=x.device)
    rc = lib.rtt_fused_l2_argmin(
        _ptr(x), _ptr(y), m, n, d, _ptr(scratch), _ptr(out_d), _ptr(out_i),
        _stream())
    fused_l2_argmin.launches += 1
    _raise_on(rc, "fused_l2_argmin")
    return out_d, out_i


fused_l2_argmin.launches = 0


# ---------------------------------------------------------------------------
# select_k
# ---------------------------------------------------------------------------

def select_k_plain(scores: torch.Tensor, k: int, select_min: bool = True,
                   bias: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted top-k per row, ties to the lowest position (a stable sort).
    With ``bias`` (a row of len values) the rows ranked are
    ``bias − 2·scores``, formed by one ``torch.sub``."""
    if bias is not None:
        scores = torch.sub(bias.reshape(1, -1), scores, alpha=2.0)
    vals, idx = torch.sort(scores, dim=1, descending=not select_min,
                           stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


# Rows up to this length are selected by one warp from its registers (32
# keys a lane at most); longer rows by one block with a radix select, which
# stages the row's keys in shared memory up to SELECT_K_STAGE_MAX (40 KB).
SELECT_K_SHORT_MAX = 1024
SELECT_K_STAGE_MAX = 10240


@functools.lru_cache(maxsize=None)
def select_k_plan(length: int, aligned: bool) -> Tuple[int, int, int]:
    """The select_k kernel's variant for rows of ``length`` scores:
    (vec, per_lane, smem_bytes). ``per_lane > 0`` is the short variant
    (one warp per row, ``per_lane`` keys a lane — a power of two — read
    as 16-byte vectors when ``vec`` is 4, which needs ``aligned`` rows:
    a 16-byte aligned base and a length that is a multiple of 4);
    ``per_lane == 0`` the long one (one block per row), whose keys take
    ``smem_bytes`` of dynamic shared memory (0: re-read from the row)."""
    if length <= SELECT_K_SHORT_MAX:
        vec = 4 if aligned and length % 4 == 0 else 1
        need = -(-length // (32 * vec)) * vec
        return vec, max(vec, 1 << (need - 1).bit_length()), 0
    return 1, 0, length * 4 if length <= SELECT_K_STAGE_MAX else 0


def select_k_cuda(scores: torch.Tensor, k: int, select_min: bool = True,
                  bias: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k, k ≤ 64: scores [m, len] f32 → (values [m, k] f32,
    positions [m, k] i32), sorted, ties to the lowest position. ``bias``
    (f32, len values: [len] or [1, len], contiguous) makes the kernel rank
    ``bias[j] − 2·scores[i, j]``, formed as it loads a score, and return
    those values (IVF-PQ's coarse probe ‖c‖² − 2⟨q, c⟩; 2·score is exact,
    so equal bit for bit to ``torch.sub(bias, scores, alpha=2)``)."""
    _check(scores, "scores", torch.float32, 2)
    m, n = scores.shape
    expects(0 < k <= SELECT_K_MAX_K, "k=%d outside (0, %d]", k,
            SELECT_K_MAX_K)
    expects(k <= n, "k=%d > len=%d", k, n)
    if bias is not None and not (
            bias.dtype == torch.float32 and bias.numel() == n
            and bias.is_contiguous() and bias.dim() <= 2
            and bias.device == scores.device):
        # the message is built only for a failing operand
        expects(False, "bias must be a contiguous f32 row of %d values on "
                "%s (got %s %s on %s)", n, scores.device, bias.dtype,
                tuple(bias.shape), bias.device)
    if not scores.is_cuda and not _use_kernel(scores):
        return select_k_plain(scores, k, select_min, bias)
    dev = scores.device
    ptr = _ptr(scores)
    bptr = 0 if bias is None else _ptr(bias)
    vec, per_lane, smem = select_k_plan(n, ptr % 16 == 0 and bptr % 16 == 0)
    out_v = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out_v, dtype=torch.int32)
    rc = _lib("select_k").rtt_select_k(
        ptr, bptr or None, m, n, k, int(select_min), vec, per_lane, smem,
        _ptr(out_v), _ptr(out_i), _stream(dev))
    select_k_cuda.launches += 1
    _raise_on(rc, "select_k")
    return out_v, out_i


select_k_cuda.launches = 0


# ---------------------------------------------------------------------------
# IVF-PQ LUT scan
# ---------------------------------------------------------------------------

def round_to_lut_dtype(x: torch.Tensor, lut_dtype: str) -> torch.Tensor:
    """``x`` rounded to ``lut_dtype`` and back to f32: bf16, or fp8 e4m3
    then bf16, as the JAX package rounds. Torch's fp8 cast and
    ml_dtypes' may differ on overflow (|x| > 448)."""
    expects(lut_dtype in ("float32", "bfloat16", "float8_e4m3"),
            "unknown lut_dtype %s", lut_dtype)
    x = x.float()
    if lut_dtype == "bfloat16":
        return x.to(torch.bfloat16).float()
    if lut_dtype == "float8_e4m3":
        return x.to(torch.float8_e4m3fn).to(torch.bfloat16).float()
    return x


def lut_codebook(codebooks: torch.Tensor, lut_dtype: str) -> torch.Tensor:
    """The codebook operand of the LUT scan, rounded as the TPU kernel
    rounds it (``_lut_scan_operands``, pallas_kernels.py:708-711); the
    LUT itself is built in f32. Codebook entries are residual
    sub-vectors, far inside fp8's range."""
    return round_to_lut_dtype(codebooks, lut_dtype).contiguous()


def unpack_codes(packed: torch.Tensor, pq_dim: int, pq_bits: int
                 ) -> torch.Tensor:
    """[..., nb] u8 → [..., pq_dim] int64 code values; int32 arithmetic
    (torch's uint16 ops are patchy)."""
    if pq_bits == 8:
        return packed.long()
    nb = packed.shape[-1]
    s = torch.arange(pq_dim, device=packed.device)
    byte_idx = (s * pq_bits) // 8
    off = ((s * pq_bits) % 8).to(torch.int32)
    p32 = packed.to(torch.int32)
    lo = p32.index_select(-1, byte_idx)
    hi_idx = torch.clamp(byte_idx + 1, max=nb - 1)
    hi = p32.index_select(-1, hi_idx) * (byte_idx + 1 < nb).to(torch.int32)
    return (((lo | (hi << 8)) >> off) & ((1 << pq_bits) - 1)).long()


def _lut_shard_args(q_rot, packed, ids, norms, centers_rot, codebooks,
                    metric, pq_bits, pq_dim, L):
    """Checks of a LUT scan's queries and shard; (S, K, P, nb, rot)."""
    _check(q_rot, "q_rot", torch.float32, 2)
    _check(packed, "packed", torch.uint8, 3)
    _check(ids, "ids", torch.int32, 2)
    _check(norms, "norms", torch.float32, 2)
    _check(centers_rot, "centers_rot", torch.float32, 2)
    _check(codebooks, "codebooks", torch.float32, 3)
    S, K, P = codebooks.shape
    n_lists, R, nb = packed.shape
    expects(metric in ("l2", "ip"), "metric must be l2 or ip (got %s)", metric)
    expects(4 <= pq_bits <= 8 and K == 1 << pq_bits, "K=%d != 2^%d", K,
            pq_bits)
    expects(S == pq_dim, "codebooks hold %d subspaces, pq_dim=%d", S, pq_dim)
    expects(nb == (S * pq_bits + 7) // 8 and R == L,
            "packed codes [%d, %d, %d] are not [n_lists, L, nb] for L=%d "
            "(ivf_pq.load and from_numpy unfold lane-folded codes)",
            n_lists, R, nb, L)
    expects(tuple(ids.shape) == (n_lists, L)
            and tuple(norms.shape) == (n_lists, L),
            "ids/norms must be [n_lists, L]")
    rot = q_rot.shape[1]
    expects(S * P == rot and tuple(centers_rot.shape) == (n_lists, rot),
            "rotated width %d != pq_dim·pq_len %d", rot, S * P)
    return S, K, P, nb, rot


def _lut_scan_args(seg_list, seg_q, q_rot, packed, ids, norms, centers_rot,
                   codebooks, metric, pq_bits, pq_dim, L):
    _check(seg_list, "seg_list", torch.int32, 1)
    _check(seg_q, "seg_q", torch.int32, 2)
    expects(seg_q.shape[0] == seg_list.shape[0],
            "seg_q/seg_list segment counts differ")
    return _lut_shard_args(q_rot, packed, ids, norms, centers_rot, codebooks,
                           metric, pq_bits, pq_dim, L)


def lut_rotated(S: int, pq_bits: int) -> bool:
    """Whether the LUT-scan kernels take the rotated look-up: 8-bit codes
    and pq_dim a multiple of 32 up to 128, so a row's codes are whole
    16-byte words, loaded 16 bytes at a time (the wrappers require a
    16-byte aligned code table, as every fresh allocation is). Its LUT is
    [2^bits][pq_dim]-major, and the codebook operand with it
    (:func:`lut_kernel_codebook`)."""
    return pq_bits == 8 and S % 32 == 0 and S <= 128


def _check_code_alignment(rotated: bool, *packed: torch.Tensor) -> None:
    expects(not rotated or all(p.data_ptr() % 16 == 0 for p in packed),
            "the rotated look-up loads codes 16 bytes at a time: packed "
            "codes must start 16-byte aligned (pass a fresh tensor, not a "
            "view)")


def lut_kernel_codebook(cb: torch.Tensor, rotated: bool,
                        lut_dtype: str = "float32") -> torch.Tensor:
    """The codebook as the scan kernels read it, rounded to ``lut_dtype``
    (:func:`lut_codebook`): [2^bits, pq_dim, pq_len] for the rotated
    look-up, else [pq_dim, 2^bits, pq_len] as it is. Made once per
    (codebook tensor, layout, lut_dtype) and kept on the tensor (made
    again if the tensor is written in place), so a search call does no
    re-layout; the f32 unrotated operand is the tensor itself."""
    if not rotated and lut_dtype == "float32":
        return cb
    kept = getattr(cb, "_rtt_kernel_codebooks", None)
    if kept is None:
        kept = cb._rtt_kernel_codebooks = {}
    made = kept.get((rotated, lut_dtype))
    if made is None or made[0] != cb._version:
        laid = cb.transpose(0, 1) if rotated else cb
        made = (cb._version, lut_codebook(laid, lut_dtype))
        kept[(rotated, lut_dtype)] = made
    return made[1]


def lut_slot_rows(pair_seg: torch.Tensor, pair_slot: torch.Tensor,
                  n_seg: int, seg: int) -> torch.Tensor:
    """The inverse of ``segment_probes``' pair addresses: [n_seg, seg] i32,
    the pair index b·P + p of the pair each slot holds, −1 on pad slots."""
    B, P = pair_seg.shape
    rows = torch.full((n_seg * seg,), -1, dtype=torch.int32,
                      device=pair_seg.device)
    rows[(pair_seg * seg + pair_slot).reshape(-1)] = torch.arange(
        B * P, dtype=torch.int32, device=pair_seg.device)
    return rows.view(n_seg, seg)


def lut_scan_tables(seg_q: torch.Tensor, pair_seg: torch.Tensor,
                    pair_slot: torch.Tensor, qg: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LUT scan's launch tables for a segment table: the slot rows
    (:func:`lut_slot_rows`), and one block per (segment, group of ≤ ``qg``
    live slots) — the inclusive prefix of the groups and each block's
    segment, over a grid that covers any segment table of B·P live slots
    (blocks past the prefix's end return at once)."""
    n_seg, seg = seg_q.shape
    B, P = pair_seg.shape
    slot_rows = lut_slot_rows(pair_seg, pair_slot, n_seg, seg)
    n_grp = ((seg_q >= 0).sum(1, dtype=torch.int32) + (qg - 1)) // qg
    grp_end = torch.cumsum(n_grp, 0, dtype=torch.int32)
    n_blocks = min(n_seg, B * P) + -(-(B * P) // qg)
    blk_seg = torch.searchsorted(
        grp_end, torch.arange(n_blocks, dtype=torch.int32,
                              device=seg_q.device), right=True,
        out_int32=True)
    return slot_rows, grp_end, blk_seg


def unpack_filter_bytes(fbytes: torch.Tensor, L: int) -> torch.Tensor:
    """[..., ceil(L/8)] u8 keep bytes → [..., L] bool (bit j of byte b is
    position 8·b + j): the inverse of ``sample_filter.pack_mask_bytes``."""
    shifts = torch.arange(8, dtype=torch.int32, device=fbytes.device)
    bits = (fbytes.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*fbytes.shape[:-1], -1)[..., :L] > 0


def _check_filter_bytes(fbytes: torch.Tensor, n_lists: int, L: int) -> None:
    _check(fbytes, "filter_bytes", torch.uint8, 2)
    expects(tuple(fbytes.shape) == (n_lists, (L + 7) // 8),
            "filter_bytes must be [n_lists, ceil(L/8)] = [%d, %d] (got %s)",
            n_lists, (L + 7) // 8, tuple(fbytes.shape))


def _lut_bins_plain(lst, q, packed, ids, norms, sizes, centers_rot, cb,
                    metric: str, pq_bits: int, fbytes=None,
                    pair_chunk: int = 256):
    """The 256 bin columns of each (list lst[i], rotated query q[i]) pair
    → (keys, ids) [c, 256]: the exact ADC keys of the list's rows (rows at
    or past ``sizes[lst]`` count as pads, and so do rows whose keep bit in
    ``fbytes`` [n_lists, ceil(L/8)] is clear), then the two best
    per bin (position mod 128) by a stable sort — the lexicographic (key,
    position) pair the kernel's strict-< running update keeps."""
    S, K, P = cb.shape
    n_lists, L, _ = packed.shape
    n_t = -(-L // LUT_SCAN_LANES)
    Lp = n_t * LUT_SCAN_LANES
    pos = torch.arange(L, device=q.device)
    keys, kids = [], []
    for a in range(0, lst.numel(), pair_chunk):
        ls, qa = lst[a:a + pair_chunk].long(), q[a:a + pair_chunk]
        c = ls.numel()
        lut = torch.einsum("csp,skp->csk", qa.view(c, S, P), cb)
        codes = unpack_codes(packed[ls], S, pq_bits)          # [c, L, S]
        qd = torch.gather(lut, 2, codes.transpose(1, 2)).sum(1)  # [c, L]
        dot = (qa * centers_rot[ls]).sum(1)[:, None] + qd
        key = -dot if metric == "ip" else norms[ls] - 2.0 * dot
        cid = ids[ls]
        valid = (cid >= 0) & (pos[None, :] < sizes[ls].long()[:, None])
        if fbytes is not None:
            valid &= unpack_filter_bytes(fbytes[ls], L)
        key = torch.where(valid, key, torch.full_like(key, float("inf")))
        cid = torch.where(valid, cid, torch.full_like(cid, -1))
        if Lp > L:
            key = torch.nn.functional.pad(key, (0, Lp - L), value=float("inf"))
            cid = torch.nn.functional.pad(cid, (0, Lp - L), value=-1)
        kb = key.view(c, n_t, LUT_SCAN_LANES)
        sk, order = torch.sort(kb, dim=1, stable=True)
        ib = torch.gather(cid.view(c, n_t, LUT_SCAN_LANES), 1, order)
        if n_t == 1:
            sk = torch.cat([sk, torch.full_like(sk, float("inf"))], 1)
            ib = torch.cat([ib, torch.full_like(ib, -1)], 1)
        keys.append(sk[:, :2].reshape(c, LUT_SCAN_BINS))
        kids.append(ib[:, :2].reshape(c, LUT_SCAN_BINS))
    if not keys:
        return (torch.empty((0, LUT_SCAN_BINS), device=q.device),
                torch.empty((0, LUT_SCAN_BINS), dtype=torch.int32,
                            device=q.device))
    return torch.cat(keys), torch.cat(kids)


def ivfpq_lut_scan_topk_plain(seg_list, pair_seg, q_rot, packed, ids, norms,
                              list_sizes, centers_rot, cb, metric: str,
                              pq_bits: int, filter_bytes=None):
    """Plain version over the already-rounded codebook ``cb``: for each
    (query b, probe p) pair, the bins of query b against the list of its
    segment ``pair_seg[b, p]``, walked to the list's size, filtered rows
    masked to (+inf, −1) before the bin cut → (keys, ids) [B, P, 256]."""
    B, P = pair_seg.shape
    lst = seg_list[pair_seg.long()].reshape(-1)
    qrow = torch.arange(B, device=q_rot.device).repeat_interleave(P)
    keys, kids = _lut_bins_plain(lst, q_rot[qrow], packed, ids, norms,
                                 list_sizes, centers_rot, cb, metric, pq_bits,
                                 filter_bytes)
    return (keys.view(B, P, LUT_SCAN_BINS),
            kids.view(B, P, LUT_SCAN_BINS))


def ivfpq_lut_scan_topk(seg_list: torch.Tensor, seg_q: torch.Tensor,
                        pair_seg: torch.Tensor, pair_slot: torch.Tensor,
                        q_rot: torch.Tensor, packed: torch.Tensor,
                        ids: torch.Tensor, norms: torch.Tensor,
                        list_sizes: torch.Tensor, centers_rot: torch.Tensor,
                        codebooks: torch.Tensor, metric: str = "l2", *,
                        pq_bits: int, pq_dim: int, L: int,
                        lut_dtype: str = "float32",
                        filter_bytes: Optional[torch.Tensor] = None,
                        tables: Optional[Tuple[torch.Tensor, ...]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused segmented IVF-PQ scan over packed codes.

    seg_list [n_seg] i32 — owning list per segment; seg_q [n_seg, seg]
    i32 — query per slot, -1 pad; pair_seg, pair_slot [B, P] i32 — each
    (query, probe) pair's segment and slot (``segment_probes``); q_rot
    [B, rot] f32 rotated queries; packed [n_lists, L, nb] u8 unfolded
    codes; ids/norms [n_lists, L]; list_sizes [n_lists] i32 — real rows
    per list, packed from the front (rows past it are not read);
    centers_rot [n_lists, rot] f32; codebooks [pq_dim, 2^bits, pq_len] f32
    (per_subspace). Returns (keys, ids) [B, P, 256] in pair order:
    minimized keys (l2: ‖c+d‖² − 2⟨q,c+d⟩, add ‖q‖²; ip: −⟨q,c+d⟩) and
    global ids, two best per bin. The TPU kernel took the gathered
    ``[n_seg, seg, rot]`` queries and wrote an ``[n_seg, seg, 256]`` table,
    pad slots included, from which its caller gathered the pairs' rows;
    this one writes each live slot's row straight to its pair.

    ``filter_bytes`` [n_lists, ceil(L/8)] u8 (``sample_filter.
    list_filter_bytes`` over ``ids``): a row whose keep bit is clear is
    scored as a pad (+inf, −1) before the bins, so the bins hold only
    kept rows; the kernel reads the keep byte beside the row's id.

    ``tables``: the launch tables :func:`lut_scan_tables` makes from the
    segment table at ``lut_scan_fit``'s group size, when the caller made
    them with it (one CUDA graph for both); else they replay from a graph
    of their own here. The plain version reads none."""
    S, K, P, nb, rot = _lut_scan_args(seg_list, seg_q, q_rot, packed, ids,
                                      norms, centers_rot, codebooks, metric,
                                      pq_bits, pq_dim, L)
    _check(pair_seg, "pair_seg", torch.int32, 2)
    _check(pair_slot, "pair_slot", torch.int32, 2)
    _check(list_sizes, "list_sizes", torch.int32, 1)
    expects(pair_seg.shape == pair_slot.shape
            and pair_seg.shape[0] == q_rot.shape[0],
            "pair_seg/pair_slot must be [B, n_probes] for %d queries",
            q_rot.shape[0])
    expects(list_sizes.shape[0] == packed.shape[0],
            "list_sizes must be [n_lists]")
    filt = () if filter_bytes is None else (filter_bytes,)
    if filt:
        _check_filter_bytes(filter_bytes, packed.shape[0], L)
    if not _use_kernel(seg_list, seg_q, pair_seg, pair_slot, q_rot, packed,
                       ids, norms, list_sizes, centers_rot, codebooks, *filt):
        return ivfpq_lut_scan_topk_plain(
            seg_list, pair_seg, q_rot, packed, ids, norms, list_sizes,
            centers_rot, lut_codebook(codebooks, lut_dtype), metric,
            pq_bits, filter_bytes)
    n_seg, seg = seg_q.shape
    B, n_probes = pair_seg.shape
    lib = _lib("ivfpq_lut_scan")
    fit = lut_scan_fit(S, K, rot, seg, nb)
    expects(fit is not None, "LUT of %d x %d f32 does not fit shared memory",
            S, K)
    qg, R = fit
    dev = q_rot.device
    keys = torch.empty((B, n_probes, LUT_SCAN_BINS), dtype=torch.float32,
                       device=dev)
    kids = torch.empty((B, n_probes, LUT_SCAN_BINS), dtype=torch.int32,
                       device=dev)
    rot_lut = lut_rotated(S, pq_bits)
    _check_code_alignment(rot_lut, packed)
    cbk = lut_kernel_codebook(codebooks, rot_lut, lut_dtype)

    def launch(slot_rows, grp_end, blk_seg):
        expects(slot_rows.shape == seg_q.shape
                and grp_end.shape[0] == n_seg,
                "tables must be lut_scan_tables of this segment table")
        return lib.rtt_ivfpq_lut_scan_topk(
            _ptr(seg_list), _ptr(seg_q), _ptr(slot_rows), _ptr(grp_end),
            _ptr(blk_seg), _ptr(q_rot), _ptr(packed), _ptr(ids),
            _ptr(norms), _ptr(list_sizes), _ptr(centers_rot), _ptr(cbk),
            _ptr(filter_bytes) if filt else None, _ptr(keys),
            _ptr(kids), n_seg, blk_seg.shape[0], seg, rot, S, K, P,
            pq_bits, nb, L, 1 if metric == "ip" else 0, qg, R,
            int(rot_lut), _stream())

    if tables is not None:
        rc = launch(*tables)
    else:
        # the launch tables replay from a CUDA graph, read by the launch
        # inside the block
        with _graphs.replayed(lut_scan_tables, (seg_q, pair_seg, pair_slot),
                              qg) as made:
            rc = launch(*made)
    ivfpq_lut_scan_topk.launches += 1
    ivfpq_lut_scan_topk.filtered_launches += bool(filt)
    _raise_on(rc, "ivfpq_lut_scan_topk")
    return keys, kids


ivfpq_lut_scan_topk.launches = 0
ivfpq_lut_scan_topk.filtered_launches = 0


# ---------------------------------------------------------------------------
# fused gather-refine
# ---------------------------------------------------------------------------

_REFINE_METRICS = {"l2": 0, "ip": 1, "cos": 2}


def _refine_keep(filter_bits: torch.Tensor, cand: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """The re-rank's filter test: the word of the fetched row (the id
    clipped to [0, n − 1], the word index to the last word), bit id mod
    32 — what the TPU kernel's word fetch tested."""
    row = cand.long().clamp(0, n - 1)
    word = filter_bits[(row >> 5).clamp(max=filter_bits.shape[0] - 1)]
    return ((word >> (cand & 31).to(torch.int32)) & 1) > 0


def gather_refine_topk_plain(dataset, queries, candidates, k: int,
                             metric: str = "l2", filter_bits=None,
                             row_chunk: int = 256):
    """Keys of ``refine._refine_rows``' formulas against the gathered
    candidate rows, then a stable sort: ties to the earliest candidate.
    A candidate whose filter bit is clear becomes −1 before the sort."""
    n = dataset.shape[0]
    m, C = candidates.shape
    if filter_bits is not None:
        candidates = torch.where(_refine_keep(filter_bits, candidates, n),
                                 candidates, torch.full_like(candidates, -1))
    vals, out = [], []
    for a in range(0, m, row_chunk):
        cand = candidates[a:a + row_chunk]
        q = queries[a:a + row_chunk]
        rows = dataset[cand.clamp(0, n - 1).long()].float()   # [mc, C, d]
        s = torch.einsum("md,mcd->mc", q, rows)
        if metric == "ip":
            key = -s
        else:
            rsq = (rows * rows).sum(-1)
            qsq = (q * q).sum(1)
            if metric == "cos":
                qn = torch.sqrt(qsq.clamp_min(1e-30))
                cn = torch.sqrt(rsq.clamp_min(1e-30))
                key = 1.0 - s / (qn[:, None] * cn)
            else:
                key = (qsq[:, None] + rsq - 2.0 * s).clamp_min(0.0)
        key = torch.where(cand >= 0, key, torch.full_like(key, float("inf")))
        sk, order = torch.sort(key, dim=1, stable=True)
        sk = sk[:, :k]
        ids = torch.gather(cand, 1, order[:, :k])
        vals.append(sk)
        out.append(torch.where(torch.isinf(sk), torch.full_like(ids, -1), ids))
    return torch.cat(vals), torch.cat(out)


def gather_refine_topk(dataset: torch.Tensor, queries: torch.Tensor,
                       candidates: torch.Tensor, k: int, metric: str = "l2",
                       filter_bits: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused exact re-rank: dataset [n, d] f32 or bf16 (bf16 rows widen
    to f32 in the kernel's registers: the keys are those of the f32
    values), queries [m, d] f32, candidates [m, C] i32 (−1 invalid,
    others clipped for the fetch) →
    (keys [m, k] ascending, ids [m, k], −1 where fewer than k valid).
    Keys: l2 squared distance, ip −score, cos cosine distance; ties to the
    earliest candidate. Any C: the kernel streams the keys through a
    running top-k and keeps no [C] array. ``filter_bits`` [n_words] i32
    (``core.bitset`` words): a candidate whose bit is clear is invalid;
    the kernel tests it before the row's load, so it costs no row."""
    expects(dataset.dtype in (torch.float32, torch.bfloat16),
            "dataset must be float32 or bfloat16 (got %s)", dataset.dtype)
    _check(dataset, "dataset", dataset.dtype, 2)
    _check(queries, "queries", torch.float32, 2)
    _check(candidates, "candidates", torch.int32, 2)
    expects(metric in _REFINE_METRICS, "metric must be l2, ip or cos")
    m, d = queries.shape
    C = candidates.shape[1]
    expects(dataset.shape[1] == d and candidates.shape[0] == m,
            "dataset/queries/candidates shapes disagree")
    expects(0 < k <= min(GATHER_REFINE_MAX_K, C), "k=%d outside (0, %d]", k,
            min(GATHER_REFINE_MAX_K, C))
    filt = () if filter_bits is None else (filter_bits,)
    if filt:
        _check(filter_bits, "filter_bits", torch.int32, 1)
        expects(filter_bits.shape[0] > 0, "filter_bits has no word")
    if not _use_kernel(dataset, queries, candidates, *filt):
        return gather_refine_topk_plain(dataset, queries, candidates, k,
                                        metric, filter_bits)
    out_v = torch.empty((m, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=queries.device)
    rc = _lib("gather_refine").rtt_gather_refine_topk(
        _ptr(dataset), dataset.shape[0], d,
        int(dataset.dtype == torch.bfloat16), _ptr(queries), _ptr(candidates),
        _ptr(filter_bits) if filt else None,
        filter_bits.shape[0] if filt else 0, m, C, k,
        _REFINE_METRICS[metric], _ptr(out_v), _ptr(out_i), _stream())
    gather_refine_topk.launches += 1
    gather_refine_topk.filtered_launches += bool(filt)
    _raise_on(rc, "gather_refine_topk")
    return out_v, out_i


gather_refine_topk.launches = 0
gather_refine_topk.filtered_launches = 0


# ---------------------------------------------------------------------------
# IVF list scans over raw (or reconstructed) vectors: segmented and grouped
# ---------------------------------------------------------------------------

_SCAN_METRICS = _REFINE_METRICS
# The largest segment the scan kernels take (their live-slot table).
SCAN_MAX_SEGMENT = 1024
# The scans' distance tile (csrc/scan_common.cuh): a block takes 32 live
# queries against 128-row list tiles, as 8 warps of 2 x 2 m16n8 fragments
# of 3xTF32 products over 32-deep k slices.
SCAN_QUERIES = 32
SCAN_WARPS = 8
SCAN_K_SLICE = 32
# segmented_scan_topk keeps a pick's 128-row tile index in 16 bits.
SEGMENTED_SCAN_MAX_L = 0xFFFF * 128


# The scans' list row types, by the code their C entry points take
# (``RowType`` in csrc/scan_common.cuh).
SCAN_ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                  torch.uint8: 3}


def _scan_args(seg_list, seg_q, q, packed, ids, metric):
    _check(seg_list, "seg_list", torch.int32, 1)
    _check(seg_q, "seg_q", torch.int32, 2)
    _check(q, "q", torch.float32, 2)
    expects(packed.dtype in SCAN_ROW_TYPES,
            "packed must be float32, bfloat16, int8 or uint8 (got %s)",
            packed.dtype)
    _check(packed, "packed", packed.dtype, 3)
    _check(ids, "ids", torch.int32, 2)
    expects(metric in _SCAN_METRICS, "metric must be l2, ip or cos (got %s)",
            metric)
    n_seg, S = seg_q.shape
    n_lists, L, d = packed.shape
    expects(seg_list.shape[0] == n_seg, "seg_q/seg_list segment counts differ")
    expects(tuple(ids.shape) == (n_lists, L), "ids must be [n_lists, L]")
    expects(q.shape[1] == d, "queries are %d-d, lists %d-d", q.shape[1], d)
    expects(S <= SCAN_MAX_SEGMENT, "segment of %d slots > %d", S,
            SCAN_MAX_SEGMENT)
    return n_seg, S, d, L


def _scan_keys(si, seg_list, seg_q, q, packed, ids, metric: str):
    """Keys of the segments ``si`` against their whole lists: [c, S, L]
    (minimized: l2 squared distance, ip −score, cos distance; +inf where
    the id is < 0), with the lists' ids [c, L]. Pad slots compute against
    query 0 and are masked by the callers."""
    lst = seg_list[si].long()
    data = packed[lst].float()                             # [c, L, d]
    qv = q[seg_q[si].clamp_min(0).long()]                  # [c, S, d]
    s = torch.bmm(qv, data.transpose(1, 2))                # [c, S, L]
    if metric == "ip":
        key = -s
    else:
        qsq = (qv * qv).sum(-1)
        nsq = (data * data).sum(-1)
        if metric == "cos":
            key = 1.0 - (s * torch.rsqrt(qsq.clamp_min(1e-30))[..., None]
                         * torch.rsqrt(nsq.clamp_min(1e-30))[:, None, :])
        else:
            key = (qsq[..., None] + nsq[:, None, :] - 2.0 * s).clamp_min(0.0)
    cid = ids[lst]
    key = torch.where(cid[:, None, :] >= 0, key,
                      torch.full_like(key, float("inf")))
    return key, cid


# Live segments the plain scans take at a time: bounds their [chunk, S, L]
# key block.
_PLAIN_SEG_CHUNK = 32


def _live_segments(seg_q: torch.Tensor) -> torch.Tensor:
    return torch.nonzero((seg_q >= 0).any(1)).flatten()


def segmented_scan_topk_plain(seg_list, seg_q, q, packed, ids,
                              metric: str = "l2"):
    """Plain version: per live segment the keys of its queries against its
    list, padded to a multiple of 128 with +inf, then the two best of each
    strided bin (position mod 128) by a stable sort — the (key, position)
    order of the TPU kernel's first-index argmin picks."""
    n_seg, S = seg_q.shape
    L = packed.shape[1]
    dev = q.device
    keys = torch.full((n_seg, S, LUT_SCAN_BINS), float("inf"),
                      dtype=torch.float32, device=dev)
    kids = torch.full((n_seg, S, LUT_SCAN_BINS), -1, dtype=torch.int32,
                      device=dev)
    n_t = -(-L // LUT_SCAN_LANES)
    Lp = n_t * LUT_SCAN_LANES
    live_seg = _live_segments(seg_q)
    for a in range(0, live_seg.numel(), _PLAIN_SEG_CHUNK):
        si = live_seg[a:a + _PLAIN_SEG_CHUNK]
        c = si.numel()
        key, cid = _scan_keys(si, seg_list, seg_q, q, packed, ids, metric)
        if Lp > L:
            key = torch.nn.functional.pad(key, (0, Lp - L), value=float("inf"))
            cid = torch.nn.functional.pad(cid, (0, Lp - L), value=-1)
        sk, order = torch.sort(key.view(c, S, n_t, LUT_SCAN_LANES), dim=2,
                               stable=True)
        ib = torch.gather(cid.view(c, 1, n_t, LUT_SCAN_LANES).expand(
            c, S, n_t, LUT_SCAN_LANES), 2, order)
        if n_t == 1:
            sk = torch.cat([sk, torch.full_like(sk, float("inf"))], 2)
            ib = torch.cat([ib, torch.full_like(ib, -1)], 2)
        k2 = sk[:, :, :2].reshape(c, S, LUT_SCAN_BINS)
        i2 = ib[:, :, :2].reshape(c, S, LUT_SCAN_BINS)
        live = (seg_q[si] >= 0)[..., None]
        keys[si] = torch.where(live, k2, torch.full_like(k2, float("inf")))
        kids[si] = torch.where(live & ~torch.isinf(k2), i2,
                               torch.full_like(i2, -1))
    return keys, kids


def segmented_scan_topk(seg_list: torch.Tensor, seg_q: torch.Tensor,
                        q: torch.Tensor, packed: torch.Tensor,
                        ids: torch.Tensor, metric: str = "l2"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented IVF scan with two best per strided bin.

    seg_list [n_seg] i32 — the list each segment scans; seg_q [n_seg, S]
    i32 — query per slot, −1 pad; q [B, d] f32 queries; packed [n_lists,
    L, d] f32, bf16, int8 or uint8 list data (widened to f32 as it is
    read); ids [n_lists,
    L] i32 global ids, −1 pad. Returns (keys, ids) [n_seg, S, 256]: per
    live slot, minimized keys (l2 ‖q‖² + ‖x‖² − 2⟨q,x⟩ clamped at 0, ip
    −⟨q,x⟩, cos 1 − ⟨q,x⟩/(‖q‖‖x‖)) and global ids; column b holds bin
    b's best (bin = position mod 128), column 128 + b its second best, in
    (key, position) order; the id is −1 where the key is +inf. Pad slots
    hold (+inf, −1): the TPU kernel computed them against query 0, which
    no caller can observe (``merge_bin_results`` reads live pairs only).
    Unlike the TPU kernel, which took the gathered ``[n_seg, S, d]``
    queries, this one takes ``q`` and ``seg_q`` and gathers on chip. The
    kernel computes ⟨q, x⟩ as three TF32 products of split operands on
    the tensor cores (two for bf16, int8 and uint8 lists, which TF32 holds
    exactly), as the TPU kernel's
    Precision.HIGHEST asked, and keeps the bins in registers."""
    n_seg, S, d, L = _scan_args(seg_list, seg_q, q, packed, ids, metric)
    if not _use_kernel(seg_list, seg_q, q, packed, ids):
        return segmented_scan_topk_plain(seg_list, seg_q, q, packed, ids,
                                         metric)
    expects(L < SEGMENTED_SCAN_MAX_L, "lists of %d rows: the kernel keeps "
            "16-bit tile indices (L < %d)", L, SEGMENTED_SCAN_MAX_L)
    keys = torch.empty((n_seg, S, LUT_SCAN_BINS), dtype=torch.float32,
                       device=q.device)
    kids = torch.empty((n_seg, S, LUT_SCAN_BINS), dtype=torch.int32,
                       device=q.device)
    rc = _lib("segmented_scan").rtt_segmented_scan_topk(
        _ptr(seg_list), _ptr(seg_q), _ptr(q), _ptr(packed), _ptr(ids),
        _ptr(keys), _ptr(kids), n_seg, S, d, L,
        SCAN_ROW_TYPES[packed.dtype], _SCAN_METRICS[metric], _stream())
    segmented_scan_topk.launches += 1
    _raise_on(rc, "segmented_scan_topk")
    return keys, kids


segmented_scan_topk.launches = 0

GROUPED_SCAN_MAX_KK = 64


def grouped_scan_topk_plain(seg_list, seg_q, q, packed, ids, kk: int,
                            metric: str = "l2"):
    """Plain version: per live segment the keys of its queries against its
    list, then a stable sort — ties to the lowest position, as the TPU
    kernel's first-index argmin extraction gives."""
    n_seg, S = seg_q.shape
    L = packed.shape[1]
    dev = q.device
    keys = torch.full((n_seg, S, kk), float("inf"), dtype=torch.float32,
                      device=dev)
    pos = torch.full((n_seg, S, kk), -1, dtype=torch.int32, device=dev)
    live_seg = _live_segments(seg_q)
    for a in range(0, live_seg.numel(), _PLAIN_SEG_CHUNK):
        si = live_seg[a:a + _PLAIN_SEG_CHUNK]
        key, _ = _scan_keys(si, seg_list, seg_q, q, packed, ids, metric)
        if kk > L:
            key = torch.nn.functional.pad(key, (0, kk - L), value=float("inf"))
        sk, order = torch.sort(key, dim=2, stable=True)
        sk, order = sk[..., :kk], order[..., :kk].to(torch.int32)
        live = (seg_q[si] >= 0)[..., None]
        keys[si] = torch.where(live, sk, torch.full_like(sk, float("inf")))
        pos[si] = torch.where(live & ~torch.isinf(sk), order,
                              torch.full_like(order, -1))
    return keys, pos


def grouped_scan_topk(seg_list: torch.Tensor, seg_q: torch.Tensor,
                      q: torch.Tensor, packed: torch.Tensor,
                      ids: torch.Tensor, kk: int, metric: str = "l2"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped IVF scan with an exact per-slot top-kk (1 ≤ kk ≤ 64).

    Same operands as :func:`segmented_scan_topk`; slots whose id is < 0
    are masked (+inf). Returns (keys [n_seg, S, kk], positions [n_seg,
    S, kk] i32): minimized keys sorted ascending with ties to the lowest
    position, and in-list positions, −1 where the key is +inf. Pad slots
    hold (+inf, −1). The list block is read straight out of
    ``packed[seg_list[s]]``: there is no gathered ``[C, L, d]`` copy."""
    n_seg, S, d, L = _scan_args(seg_list, seg_q, q, packed, ids, metric)
    expects(0 < kk <= GROUPED_SCAN_MAX_KK, "kk=%d outside (0, %d]", kk,
            GROUPED_SCAN_MAX_KK)
    if not _use_kernel(seg_list, seg_q, q, packed, ids):
        return grouped_scan_topk_plain(seg_list, seg_q, q, packed, ids, kk,
                                       metric)
    keys = torch.empty((n_seg, S, kk), dtype=torch.float32, device=q.device)
    pos = torch.empty((n_seg, S, kk), dtype=torch.int32, device=q.device)
    rc = _lib("grouped_scan").rtt_grouped_scan_topk(
        _ptr(seg_list), _ptr(seg_q), _ptr(q), _ptr(packed), _ptr(ids),
        _ptr(keys), _ptr(pos), n_seg, S, d, L, kk,
        SCAN_ROW_TYPES[packed.dtype], _SCAN_METRICS[metric], _stream())
    grouped_scan_topk.launches += 1
    _raise_on(rc, "grouped_scan_topk")
    return keys, pos


grouped_scan_topk.launches = 0


# ---------------------------------------------------------------------------
# ring top-k exchange (B7) and the fused scan-in-ring (B8)
# ---------------------------------------------------------------------------

# The merge is a sorted buffer of two slots per lane (topk_common.cuh).
RING_TOPK_MAX_K = 64
# Ranks of one ring: the size of the kernels' pointer tables.
RING_MAX_RANKS = 16
# Union-probe segments per ring chunk the fused kernel serves (the JAX
# package's rule, kept so both packages pick the same tier).
RING_FUSED_MAX_SEGS = 512
_SUBLANES = 8


def ring_chunk_rows(m: int, n_dev: int) -> int:
    """Query rows per ring chunk: ceil(m / n_dev) padded to a multiple of
    8 (the TPU's sublane tile, kept so both packages cut the same
    chunks). Shared by the kernels, the plain schedule and the comms byte
    model."""
    mc = -(-m // n_dev)
    return max(_SUBLANES, -(-mc // _SUBLANES) * _SUBLANES)


# The TPU kernel's VMEM working set bound (pallas_kernels.py:1364).
_RING_VMEM_BUDGET = 12 * 1024 * 1024


def ring_topk_kernel_ok(m: int, k: int, n_dev: int) -> bool:
    """Whether the ring kernel tier takes the shape: k ≤ 64, 2 ≤ n_dev ≤ 16
    (the CUDA kernel's pointer table), and the TPU kernel's VMEM rule
    (pallas_kernels.py:1375-1387, mc ≤ 1228 rows). The CUDA kernel keeps
    its blocks in device memory and would take any mc; the rule stays so
    that both packages pick the same merge tier for the same shapes."""
    if k > RING_TOPK_MAX_K or n_dev < 2 or n_dev > RING_MAX_RANKS:
        return False
    mc = ring_chunk_rows(m, n_dev)
    vmem = (2 * mc * LUT_SCAN_LANES * 8 + 2 * mc * LUT_SCAN_LANES * 8
            + 2 * mc * 3 * LUT_SCAN_LANES * 8)
    return vmem <= _RING_VMEM_BUDGET


def ring_topk_inner_ok(m: int, k: int, n_inner: int) -> bool:
    """Whether the ring kernel takes the hier tier's per-pod (inner-axis)
    stage (the JAX package's ``ring_topk_inner_ok``,
    pallas_kernels.py:1390): the same rule as :func:`ring_topk_kernel_ok`
    over the pod's ranks. The TPU kernel offsets its logical device ids
    by the pod's base; this one is handed the pod's tensors and addresses
    its ranks through that list."""
    return ring_topk_kernel_ok(m, k, n_inner)


def _ring_use_kernel(*per_rank: Sequence[torch.Tensor]) -> bool:
    """True when every rank's tensors lie on one CUDA card, False when they
    all lie on the CPU; a rank whose tensors straddle devices raises, and
    so do ranks on several cards: the kernels' reads of a neighbour's
    block through a peer pointer are not shown right yet (ROADMAP A15)."""
    devs = set()
    for r in range(len(per_rank[0])):
        rank_devs = {lst[r].device for lst in per_rank}
        expects(len(rank_devs) == 1, "rank %d's operands lie on several "
                "devices: %s", r, rank_devs)
        devs |= rank_devs
    kinds = {d.type for d in devs}
    expects(kinds <= {"cuda", "cpu"} and len(kinds) == 1,
            "ring operands must all lie on CUDA devices or all on the CPU "
            "(got %s)", kinds)
    if kinds == {"cuda"} and len(devs) > 1:
        raise not_ported("the ring kernels over ranks on several cards "
                         "(peer pointers over NVLink)", "A15")
    return kinds == {"cuda"}


def _ring_keys(vals: torch.Tensor, ids: torch.Tensor, m_pad: int,
               select_min: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimized f32 keys (negated for max-select) and int32 ids, rows
    padded to ``m_pad`` with (+inf, −1), +inf wherever the id is < 0 —
    the TPU wrapper's preparation (pallas_kernels.py:1621-1631)."""
    keys = vals.float()
    if not select_min:
        keys = -keys
    ids32 = ids.to(torch.int32)
    m = keys.shape[0]
    if m_pad > m:
        keys = torch.nn.functional.pad(keys, (0, 0, 0, m_pad - m),
                                       value=float("inf"))
        ids32 = torch.nn.functional.pad(ids32, (0, 0, 0, m_pad - m), value=-1)
    keys = torch.where(ids32 < 0, torch.full_like(keys, float("inf")), keys)
    return keys.contiguous(), ids32.contiguous()


def _ring_schedule_plain(local, n: int, k: int):
    """The ring schedule over lists: ``local(r, c)`` gives rank r's
    candidates (keys ascending-minimized, ids) for chunk c, [mc, w] on r's
    device. Rank r starts chunk (r − 1) mod n; at hop s it merges the
    incoming partial of rank r − 1 with its own candidates for chunk
    (r − s − 2) mod n by a stable sort of incoming ++ local — ties to the
    lower position — and an infinite key carries id −1. Returns per-rank
    (keys, ids) [mc, k]: rank r holds chunk r."""
    def top(v, i):
        sv, pos = select_k_plain(v, k, True)
        si = torch.gather(i, 1, pos.long())
        return sv, torch.where(torch.isinf(sv), torch.full_like(si, -1), si)

    run = [top(*local(r, (r - 1) % n)) for r in range(n)]
    for s in range(n - 1):
        nxt = []
        for r in range(n):
            lv, li = local(r, (r - s - 2) % n)
            iv, ii = run[(r - 1) % n]
            nxt.append(top(torch.cat([iv.to(lv.device), lv], 1),
                           torch.cat([ii.to(li.device), li], 1)))
        run = nxt
    return [v for v, _ in run], [i for _, i in run]


def ring_topk_merge_plain(keys: Sequence[torch.Tensor],
                          ids: Sequence[torch.Tensor], k: int, mc: int):
    """Plain version over prepared per-rank tables (``_ring_keys``: [n·mc,
    kin] minimized keys, int32 ids): the ring schedule with a stable sort
    per hop. Returns per-rank (keys, ids) [mc, k], ascending."""
    return _ring_schedule_plain(
        lambda r, c: (keys[r][c * mc:(c + 1) * mc],
                      ids[r][c * mc:(c + 1) * mc]), len(keys), k)


def _ptr_table(tensors: Sequence[Optional[torch.Tensor]]):
    """A C array of the tensors' pointers (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def ring_topk_merge(vals: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
                    k: int, select_min: bool = True
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Ring reduce-scatter of top-k over the ranks of a mesh.

    ``vals``/``ids`` hold one [m, kin] table per rank (kin ≥ k; keys of
    the rank's local top-k, ids −1 invalid; any id dtype, narrowed to
    int32 — the caller keeps int64 ids on the plain schedule). The query
    axis is padded to n·mc rows (:func:`ring_chunk_rows`). Returns per
    rank (vals [mc, k], ids [mc, k] int32): rank r holds rows [r·mc,
    (r+1)·mc) of the padded query axis, best first (ascending for
    ``select_min``, descending otherwise, an empty slot −inf there),
    ties to the rank order of the TPU kernel's ring."""
    n = len(vals)
    expects(n >= 1 and len(ids) == n, "ring_topk_merge needs one vals and "
            "one ids table per rank")
    shape = vals[0].shape
    m, kin = shape
    expects(all(v.shape == shape and i.shape == shape
                for v, i in zip(vals, ids)),
            "every rank's table must be [%d, %d]", m, kin)
    if k > kin:
        raise ValueError(f"k={k} > candidate width {kin}")
    if k > RING_TOPK_MAX_K:
        raise ValueError(f"k={k} > {RING_TOPK_MAX_K} (the merge buffer holds "
                         "k ≤ 64 — gate with ring_topk_kernel_ok)")
    expects(n <= RING_MAX_RANKS, "%d ranks > %d", n, RING_MAX_RANKS)
    mc = ring_chunk_rows(m, n)
    if not _ring_use_kernel(vals, ids):
        prep = [_ring_keys(v, i, mc * n, select_min) for v, i in zip(vals, ids)]
        out_k, out_i = ring_topk_merge_plain([p[0] for p in prep],
                                             [p[1] for p in prep], k, mc)
        if not select_min:
            out_k = [torch.where(torch.isinf(v),
                                 torch.full_like(v, float("-inf")), -v)
                     for v in out_k]
        return out_k, out_i
    # the kernel reads contiguous f32 keys and int32 ids; others are copied
    vals = [v if v.dtype == torch.float32 and v.is_contiguous()
            else v.float().contiguous() for v in vals]
    ids = [i if i.dtype == torch.int32 and i.is_contiguous()
           else i.to(torch.int32).contiguous() for i in ids]
    dev = vals[0].device
    out_k = torch.empty((n, mc, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, mc, k), dtype=torch.int32, device=dev)
    rc = _lib("ring_topk").rtt_ring_topk_merge(
        _ptr_table(vals + ids), n, m, mc, kin, k, int(select_min),
        _ptr(out_k), _ptr(out_i), dev.index, _stream(dev))
    ring_topk_merge.launches += 1
    _raise_on(rc, "ring_topk_merge")
    return list(out_k.unbind(0)), list(out_i.unbind(0))


ring_topk_merge.launches = 0


def indl_pad(mc: int) -> int:
    """Lane padding of the TPU kernel's probe-indicator rows (one lane per
    chunk query row); kept for the JAX package's callers' shapes."""
    return -(-mc // LUT_SCAN_LANES) * LUT_SCAN_LANES


def _lut_scan_config(S: int, K: int, P: int, nb: int, Wb: int,
                     lut_dtype: str):
    """The JAX package's packed-layout rule (pallas_kernels.py:478-506):
    (G, Sg, Kc) or None where the TPU kernel refused the layout. Kept so
    both packages admit the same layouts."""
    if nb <= 0 or Wb % nb:
        return None
    G = Wb // nb
    if G > 8 or (G & (G - 1)):
        return None
    op_bytes = 4 if lut_dtype == "float32" else 2
    cap = min(LUT_SCAN_LANES // max(P, 1),
              (4 << 20) // max(1, S * K * P * op_bytes))
    if cap < 1:
        return None
    Sg = max(d for d in range(1, min(S, cap) + 1) if S % d == 0)
    Kc = 1 << (min(K, max(1, 2048 // Sg)).bit_length() - 1)
    return G, Sg, Kc


def _lut_row_stride(nb: int) -> int:
    """Bytes of a staged code row: an odd number of 4-byte words
    (``lut_row_stride`` of csrc/lut_scan_common.cuh)."""
    words = (nb + 3) // 4
    return 4 * (words if words & 1 else words + 1)


def lut_scan_smem_bytes(qg: int, R: int, S: int, K: int, rot: int, seg: int,
                        nb: int) -> int:
    """Dynamic shared memory of one LUT-scan block (``lut_smem_bytes`` of
    csrc/lut_scan_common.cuh, which the card tests hold this copy to): qg
    f32 LUTs and queries, the live-slot table, then the larger of the
    code tile (rows of an odd word count) and the bins' merge scratch."""
    nthr = LUT_SCAN_LANES * R
    b = qg * S * K * 4 + qg * rot * 4 + qg * 4 + seg * 4 + 32 * 4
    b = (b + 15) & ~15
    return b + max(nthr * _lut_row_stride(nb), nthr * 24)


@functools.lru_cache(maxsize=None)
def lut_scan_fit(S: int, K: int, rot: int, seg: int, nb: int):
    """(live queries per pass, row groups) of a LUT-scan block with ``seg``
    slots that fits shared memory — the most LUTs × threads, ties to more
    threads — or None. Kept per shape: a search asks once a batch."""
    fits = [(g * r, r, g) for r in (4, 3, 2, 1) for g in (4, 3, 2, 1)
            if seg <= LUT_SCAN_LANES * r
            and lut_scan_smem_bytes(g, r, S, K, rot, seg, nb) <= _MAX_SMEM]
    if not fits:
        return None
    _, R, qg = max(fits)
    return qg, R


# Warps of a local block of ring_lut_scan_merge (csrc/ring_lut_scan.cu),
# largest first.
RING_SCAN_WARPS = (16, 8, 4, 2, 1)


def ring_lut_scan_smem_bytes(W: int, S: int, K: int, rot: int, NS: int,
                             nb: int, k: int, rotated: bool) -> int:
    """Dynamic shared memory of a local block of ring_lut_scan_merge with W
    warps (``local_smem_bytes`` of csrc/ring_lut_scan.cu, which the card
    tests hold this copy to): the member-list table, one f32 LUT and its
    query, the warps' top-k and the counters, then (unrotated look-up) a
    32-row code tile a warp."""
    b = NS * 16 + (S * K + rot + 3 * W * k + 34) * 4
    b = (b + 15) & ~15
    return b if rotated else b + W * 32 * _lut_row_stride(nb)


def ring_lut_scan_fit(S: int, K: int, rot: int, NS: int, nb: int, k: int,
                      rotated: bool):
    """Warps of a local block of ring_lut_scan_merge that fit shared memory
    (the most of :data:`RING_SCAN_WARPS`), or None."""
    for W in RING_SCAN_WARPS:
        if ring_lut_scan_smem_bytes(W, S, K, rot, NS, nb, k,
                                    rotated) <= _MAX_SMEM:
            return W
    return None


def ring_lut_scan_kernel_ok(S: int, K: int, P: int, nb: int, Wb: int,
                            mc: int, NS: int, k: int, n_dev: int, rot: int,
                            lut_dtype: str = "float32",
                            filtered: bool = False) -> bool:
    """Admission of :func:`ring_lut_scan_merge`: the JAX package's rules
    (k ≤ 64, n_dev ≥ 2, NS ≤ 512, its packed-layout rule) with its VMEM
    budget (pallas_kernels.py:1986-2001) replaced by the CUDA kernel's
    own need: a local block (one chunk row's LUT, its member-list table
    and top-ks) that fits the 227 KB of shared memory, at most 16 ranks,
    and codes laid out [n_lists, L, nb] (the port's indexes hold no
    other layout: ``ivf_pq.load`` and ``from_numpy`` unfold lane-folded
    codes). Any mc. ``filtered`` changes nothing: the kernel reads a rank's
    keep bytes beside its ids, in no shared memory (the TPU kernel's VMEM
    grew by its filter slots)."""
    if (k > RING_TOPK_MAX_K or n_dev < 2 or n_dev > RING_MAX_RANKS
            or NS > RING_FUSED_MAX_SEGS):
        return False
    if _lut_scan_config(S, K, P, nb, Wb, lut_dtype) is None or Wb != nb:
        return False
    rotated = lut_rotated(S, K.bit_length() - 1)
    return ring_lut_scan_fit(S, K, rot, NS, nb, k, rotated) is not None


def ring_lut_scan_merge_plain(chunk_lists, seg_q, qv_chunks, packed, ids,
                              norms, list_sizes, centers_rot, cb, k: int,
                              metric: str, pq_bits: int, filter_bytes=None):
    """Plain version over the already-rounded codebook ``cb`` and the
    member table ``seg_q`` [n, NS, mc] (row, or −1): per rank and chunk,
    the LUT scan's bins (:func:`_lut_bins_plain`, with the rank's
    ``filter_bytes`` when given) of every (member row, union list) pair,
    the lists' bins laid out in union order with (+inf, −1) for
    non-members, then the ring schedule of :func:`ring_topk_merge_plain`."""
    mc = qv_chunks[0].shape[1]

    def local(r, c):
        sq = seg_q[r][c]
        NS = sq.shape[0]
        keys = torch.full((NS, mc, LUT_SCAN_BINS), float("inf"),
                          dtype=torch.float32, device=sq.device)
        kids = torch.full((NS, mc, LUT_SCAN_BINS), -1, dtype=torch.int32,
                          device=sq.device)
        si, sl = torch.nonzero(sq >= 0, as_tuple=True)
        keys[si, sl], kids[si, sl] = _lut_bins_plain(
            chunk_lists[r][c][si], qv_chunks[r][c][sq[si, sl].long()],
            packed[r], ids[r], norms[r], list_sizes[r], centers_rot[r], cb[r],
            metric, pq_bits, None if filter_bytes is None else filter_bytes[r])
        return (keys.permute(1, 0, 2).reshape(mc, -1),
                kids.permute(1, 0, 2).reshape(mc, -1))

    return _ring_schedule_plain(local, len(packed), k)


def ring_lut_scan_merge(chunk_lists: Sequence[torch.Tensor],
                        probe_ind: Sequence[torch.Tensor],
                        qv_chunks: Sequence[torch.Tensor],
                        packed: Sequence[torch.Tensor],
                        ids: Sequence[torch.Tensor],
                        norms: Sequence[torch.Tensor],
                        list_sizes: Sequence[torch.Tensor],
                        centers_rot: Sequence[torch.Tensor],
                        codebooks: Sequence[torch.Tensor], k: int,
                        metric: str = "l2", *, pq_bits: int, pq_dim: int,
                        L: int, lut_dtype: str = "float32",
                        filter_bytes: Optional[Sequence[torch.Tensor]] = None
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Fused per-shard LUT scan + ring top-k exchange over the ranks of a
    mesh. Every argument holds one tensor per rank, on its device:

    - ``chunk_lists [n, NS]`` i32 — each chunk's union of probed lists,
      ascending, −1 pad (replicated);
    - ``probe_ind [n, NS, mc]`` f32 — 1 where chunk row i probed the list
      (pad segments all 0; replicated);
    - ``qv_chunks [n, mc, rot]`` f32 — rotated queries per chunk
      (replicated);
    - ``packed`` / ``ids`` / ``norms`` / ``list_sizes`` / ``centers_rot``
      / ``codebooks`` — the rank's shard as :func:`ivfpq_lut_scan_topk`
      takes it (ids are global row ids, int32; rows at or past a list's
      size are not read);
    - ``filter_bytes`` (optional) — the rank's keep bytes [n_lists,
      ceil(L/8)] u8 over its own id table (``sample_filter.
      list_filter_bytes``): a row whose bit is clear is a pad.

    Each rank scans, per chunk row and member list, the two best per
    strided bin, as the LUT scan keeps them; per chunk the k best over the
    chunk's lists and the ring's incoming partials. Returns per rank
    (keys [mc, k], ids [mc, k]) of chunk r, ascending, ids −1 for empty
    slots; keys as the LUT scan's (l2: ‖c+d‖² − 2⟨q,c+d⟩, add ‖q‖²; ip:
    −⟨q,c+d⟩). The TPU kernel returned [mc, 128] blocks that callers cut
    to k; this one returns k columns. On the card it is two launches a
    call (the rows' local top-ks, then the ring's chains:
    csrc/ring_lut_scan.cu), counted as two."""
    n = len(packed)
    args = (chunk_lists, probe_ind, qv_chunks, packed, ids, norms,
            list_sizes, centers_rot, codebooks)
    filt = () if filter_bytes is None else (filter_bytes,)
    args = args + filt
    expects(n >= 1 and all(len(a) == n for a in args),
            "ring_lut_scan_merge needs one tensor per rank for every operand")
    expects(0 < k <= RING_TOPK_MAX_K, "k=%d outside (0, %d] (gate with "
            "ring_lut_scan_kernel_ok)", k, RING_TOPK_MAX_K)
    expects(n <= RING_MAX_RANKS, "%d ranks > %d", n, RING_MAX_RANKS)
    n2, NS = chunk_lists[0].shape
    _, mc, rot = qv_chunks[0].shape
    expects(n2 == n, "chunk_lists has %d chunks for %d ranks", n2, n)
    for r in range(n):
        _check(chunk_lists[r], "chunk_lists", torch.int32, 2)
        _check(probe_ind[r], "probe_ind", torch.float32, 3)
        _check(qv_chunks[r], "qv_chunks", torch.float32, 3)
        expects(tuple(probe_ind[r].shape) == (n, NS, mc)
                and tuple(qv_chunks[r].shape) == (n, mc, rot)
                and tuple(chunk_lists[r].shape) == (n, NS),
                "rank %d's chunk tables disagree in shape", r)
        S, K, P, nb, _ = _lut_shard_args(
            qv_chunks[r][0], packed[r], ids[r], norms[r], centers_rot[r],
            codebooks[r], metric, pq_bits, pq_dim, L)
        _check(list_sizes[r], "list_sizes", torch.int32, 1)
        expects(list_sizes[r].shape[0] == packed[r].shape[0],
                "list_sizes must be [n_lists]")
        if filt:
            _check_filter_bytes(filter_bytes[r], packed[r].shape[0], L)
    if not _ring_use_kernel(*args):
        rows = torch.arange(mc, dtype=torch.int32)
        seg_q = [torch.where(ind > 0.5, rows, -1).to(torch.int32)
                 for ind in probe_ind]
        cb = [lut_codebook(c, lut_dtype) for c in codebooks]
        return ring_lut_scan_merge_plain(chunk_lists, seg_q, qv_chunks,
                                         packed, ids, norms, list_sizes,
                                         centers_rot, cb, k, metric, pq_bits,
                                         filter_bytes)
    rot_lut = lut_rotated(S, pq_bits)
    W = ring_lut_scan_fit(S, K, rot, NS, nb, k, rot_lut)
    expects(W is not None, "a %d x %d LUT with %d union lists does not fit "
            "shared memory (gate with ring_lut_scan_kernel_ok)", S, K, NS)
    _check_code_alignment(rot_lut, *packed)
    cbk = [lut_kernel_codebook(c, rot_lut, lut_dtype) for c in codebooks]
    dev = packed[0].device
    part_k = torch.empty((n, n * mc, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n, n * mc, k), dtype=torch.int32, device=dev)
    out_k = torch.empty((n, mc, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, mc, k), dtype=torch.int32, device=dev)
    table = _ptr_table([*chunk_lists, *probe_ind, *qv_chunks, *packed, *ids,
                        *norms, *list_sizes, *centers_rot, *cbk,
                        *part_k.unbind(0), *part_i.unbind(0),
                        *(filter_bytes if filt else [None] * n)])
    rc = _lib("ring_lut_scan").rtt_ring_lut_scan_merge(
        table, n, NS, mc, k, rot, S, K, P, pq_bits, nb, L,
        1 if metric == "ip" else 0, W, int(rot_lut), _ptr(out_k),
        _ptr(out_i), dev.index, _stream(dev))
    ring_lut_scan_merge.launches += 2   # the local top-ks, then the chains
    ring_lut_scan_merge.filtered_launches += 2 * bool(filt)
    _raise_on(rc, "ring_lut_scan_merge")
    return list(out_k.unbind(0)), list(out_i.unbind(0))


ring_lut_scan_merge.launches = 0
ring_lut_scan_merge.filtered_launches = 0


KERNELS = {
    "fused_l2_argmin": fused_l2_argmin,
    "select_k": select_k_cuda,
    "ivfpq_lut_scan_topk": ivfpq_lut_scan_topk,
    "gather_refine_topk": gather_refine_topk,
    "segmented_scan_topk": segmented_scan_topk,
    "grouped_scan_topk": grouped_scan_topk,
    "ring_topk_merge": ring_topk_merge,
    "ring_lut_scan_merge": ring_lut_scan_merge,
}


# the wrappers that take a filter operand
FILTERED_KERNELS = ("ivfpq_lut_scan_topk", "gather_refine_topk",
                    "ring_lut_scan_merge")


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def filtered_launch_counts() -> Dict[str, int]:
    """Launches that took a filter operand, per wrapper that takes one."""
    return {name: KERNELS[name].filtered_launches
            for name in FILTERED_KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in FILTERED_KERNELS:
        KERNELS[name].filtered_launches = 0
