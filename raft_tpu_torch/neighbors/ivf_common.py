"""List-centric IVF scan machinery (counterpart of
``raft_tpu.neighbors.ivf_common``).

The query batch is grouped by probed list: :func:`segment_probes` buckets
the (query, probe) pairs into fixed-size segments, each owned by one
list, with one stable sort; the scan kernel walks each segment's list
once for all its queries; :func:`gather_segment_results` brings the
per-(segment, slot) results back to (query, probe) order. The segment
table's shape depends on (B, n_probes, n_lists, seg) alone.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.ops import kernels as _k

SEGMENT_SIZE = 128

# Memory guards, with the JAX package's constants. They were sized for a
# 16 GB TPU v5e; the H100 has 80 GB, so they are conservative here and
# are kept as they are until the port measures its own limits.
GROUPED_BYTES_CAP = 4 << 30
# Per-chunk budget of the plain grouped tier's transients (the [chunk·seg,
# L] distance block and the [chunk, L, d] list rows); ``fit_seg_chunk``
# shrinks the segment chunk (down to 1) to honour it.
CHUNK_BYTES_TARGET = 256 << 20


class Stages:
    """Per-stage wall seconds of a build (synchronizing the card at each
    stage boundary) when the caller passes a dict to fill."""

    def __init__(self, out: Optional[Dict[str, float]], device):
        self.out = out
        self.cuda = device.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.out is None:
            yield
            return
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        self.out[name] = self.out.get(name, 0.0) + time.perf_counter() - t0


def n_segments(pairs: int, n_lists: int, seg: int) -> int:
    """Static upper bound on the segment count: floor(pairs/seg) + n_lists
    bounds sum ceil(load/seg) for any load histogram."""
    return pairs // seg + n_lists


def segment_probes(probes: torch.Tensor, n_lists: int, seg: int, n_seg: int):
    """Bucket (query, probe) pairs into per-list segments.

    probes [B, P] list ids → (seg_list [n_seg] i32 — the list each segment
    scans (unused segments point at an arbitrary list and hold only pads);
    seg_q [n_seg, seg] i32 — query per slot, -1 pad; pair_seg, pair_slot
    [B, P] i32 — each pair's (segment, slot) address). Exact: one stable
    sort, so a list's pairs fill its segments in (query, probe) order."""
    B, P = probes.shape
    BP = B * P
    dev = probes.device
    l_flat = probes.reshape(-1).to(torch.int32)
    sorted_l, order = torch.sort(l_flat, stable=True)
    starts = torch.searchsorted(
        sorted_l, torch.arange(n_lists, dtype=torch.int32, device=dev))
    counts = torch.diff(torch.cat(
        [starts, torch.tensor([BP], dtype=starts.dtype, device=dev)]))
    segs_per_list = (counts + seg - 1) // seg
    seg_base = torch.cumsum(segs_per_list, 0) - segs_per_list  # exclusive
    seg_ids = torch.arange(n_seg, dtype=seg_base.dtype, device=dev)
    seg_list = (torch.searchsorted(seg_base, seg_ids, right=True) - 1).clamp(
        0, n_lists - 1)
    rank0 = (seg_ids - seg_base[seg_list]) * seg
    i0 = starts[seg_list] + rank0
    j = torch.arange(seg, dtype=seg_base.dtype, device=dev)
    rank = rank0[:, None] + j[None, :]
    valid = rank < counts[seg_list][:, None]
    q_of = order // P
    seg_q = torch.where(valid, q_of[(i0[:, None] + j[None, :]).clamp(0, BP - 1)],
                        torch.full_like(rank, -1))
    iota = torch.arange(BP, dtype=seg_base.dtype, device=dev)
    sl = sorted_l.long()
    rank_sorted = iota - starts[sl]
    addr = (seg_base[sl] + rank_sorted // seg) * seg + rank_sorted % seg
    addr_pair = torch.empty_like(addr)
    addr_pair[order] = addr  # the sort's inverse permutation
    return (seg_list.to(torch.int32), seg_q.to(torch.int32),
            (addr_pair // seg).view(B, P).to(torch.int32),
            (addr_pair % seg).view(B, P).to(torch.int32))


def gather_segment_results(seg_vals: torch.Tensor, seg_ids: torch.Tensor,
                           pair_seg: torch.Tensor, pair_slot: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[n_seg, seg, kk] → [B, P, kk]``: every pair owns exactly one slot."""
    ps, pl = pair_seg.long(), pair_slot.long()
    return seg_vals[ps, pl], seg_ids[ps, pl]


def merge_bin_results(keys: torch.Tensor, kids: torch.Tensor,
                      pair_seg: torch.Tensor, pair_slot: torch.Tensor,
                      k: int, select_min: bool, invalid: float):
    """Merge a segmented scan's per-bin output ``keys/kids [n_seg, S,
    nbins]`` (minimized keys, global ids, −1 invalid) into (distances [B,
    k], ids [B, k]): a per-slot cut to kk = min(k, nbins) over each live
    pair's bin row, then one cut per query over its P·kk survivors. Both
    cuts are exact selections with ties to the lowest position. The JAX
    package's per-slot cut is ``lax.approx_min_k``, which is exact on the
    CPU; the card runs it exactly here as well. Ip keys flip back to
    scores; metric epilogues (sqrt, 1 − cos) stay with the callers."""
    n_seg, seg, nbins = keys.shape
    B, P = pair_seg.shape
    kk = min(k, nbins)
    kq = min(k, P * kk)
    ps, pl = pair_seg.long(), pair_slot.long()
    rows = (ps * seg + pl).reshape(-1)            # live pairs only
    cut = keys.reshape(-1, nbins)[rows]
    mk, sel = select_k(cut, kk)
    pv = mk.reshape(B, P * kk)
    pb = sel.reshape(B, P * kk).long()
    nv, pos2 = select_k(pv, kq)
    pos2 = pos2.long()
    p_of = pos2 // kk
    bin_of = torch.gather(pb, 1, pos2)
    seg_of = torch.gather(ps, 1, p_of)
    slot_of = torch.gather(pl, 1, p_of)
    out_ids = kids[seg_of, slot_of, bin_of]
    out_vals = nv if select_min else -nv
    out_vals = torch.where(out_ids < 0, torch.full_like(out_vals, invalid),
                           out_vals)
    if k > kq:
        out_vals = torch.nn.functional.pad(out_vals, (0, k - kq),
                                           value=invalid)
        out_ids = torch.nn.functional.pad(out_ids, (0, k - kq), value=-1)
    return out_vals, out_ids


def fit_seg_chunk(seg: int, L: int, d: int, want: int) -> int:
    """Largest segment chunk ≤ ``want`` whose per-step transients — the
    [chunk·seg, L] f32 distance block and the [chunk, L, d] f32 list rows
    — stay under CHUNK_BYTES_TARGET."""
    per_seg = L * 4 * (seg + d)
    return max(1, min(want, CHUNK_BYTES_TARGET // max(1, per_seg)))


def choose_list_chunk(n_lists: int, target: int) -> int:
    """Largest divisor of ``n_lists`` that is ≤ target (a chunked pass over
    [n_lists, …] reshapes it to [n_chunks, chunk, …])."""
    c = max(1, min(target, n_lists))
    while n_lists % c:
        c -= 1
    return c


def grouped_scan_plain_tier(seg_list, seg_q, pair_seg, pair_slot,
                            q: torch.Tensor, rows_of, ids: torch.Tensor,
                            k: int, metric: str, seg_chunk: int,
                            norms: Optional[torch.Tensor] = None):
    """The grouped tier that runs outside the scan kernels (the JAX
    package's XLA tier): for each chunk of ``seg_chunk`` live segments,
    one batched product of the slots' queries against the list rows
    ``rows_of(lists) → [c, L, d] f32``, the metric's keys, an exact
    per-slot top-kk (kk = min(k, L)), then one cut per query over its
    n_probes·kk survivors. ``norms`` [n_lists, L] are the rows' stored
    squared norms (IVF-PQ's ‖c + d‖²); without them they are computed from
    the rows (IVF-Flat). ``metric``: "l2" (squared distances), "ip"
    (scores, largest first) or "cos" (distances). Returns (values [B, k],
    ids [B, k]), padded with (invalid, −1) past the candidates.

    The JAX package's ``approx`` select is ``lax.approx_min_k``, which off
    the TPU is the exact top-k; the exact select serves both here. Its
    ``slice_scan`` branch (``dynamic_slice`` at chunk 1 for code arrays
    above 2 GB) exists to stop XLA from rematerializing copies of the
    code array inside its loop; eager torch makes no such copies, so
    there is none here. Segments without a live slot are skipped: no
    pair reads them."""
    n_seg, seg = seg_q.shape
    L = ids.shape[1]
    kk = min(k, L)
    ip = metric == "ip"
    invalid = float("-inf") if ip else float("inf")
    dev = q.device
    vals = torch.full((n_seg, seg, kk), invalid, dtype=torch.float32,
                      device=dev)
    cids = torch.full((n_seg, seg, kk), -1, dtype=ids.dtype, device=dev)
    q_sq = (q * q).sum(1)
    live = torch.nonzero((seg_q >= 0).any(1)).flatten()
    for a in range(0, live.numel(), seg_chunk):
        si = live[a:a + seg_chunk]
        sl = seg_list[si].long()
        rows = rows_of(sl)                                 # [c, L, d]
        lids = ids[sl]                                     # [c, L]
        qi = seg_q[si].clamp_min(0).long()                 # [c, seg]
        scores = torch.bmm(q[qi], rows.transpose(1, 2))    # [c, seg, L]
        if ip:
            dists = scores
        else:
            nsq = (rows * rows).sum(-1) if norms is None else norms[sl]
            if metric == "cos":
                cn = torch.sqrt(nsq.clamp_min(1e-30))
                qn = torch.sqrt(q_sq.clamp_min(1e-30))[qi]
                dists = 1.0 - scores / (qn[:, :, None] * cn[:, None, :])
            else:
                dists = (q_sq[qi][:, :, None] + nsq[:, None, :]
                         - 2.0 * scores).clamp_min(0.0)
        dists = torch.where(lids[:, None, :] >= 0, dists,
                            torch.full_like(dists, invalid))
        c = si.numel()
        v, pos = select_k(dists.reshape(c * seg, L), kk, select_min=not ip)
        v, pos = v.view(c, seg, kk), pos.view(c, seg, kk).long()
        cid = torch.gather(lids[:, None, :].expand(c, seg, L), 2, pos)
        vals[si] = v
        cids[si] = torch.where(v == invalid, torch.full_like(cid, -1), cid)
    return merge_slot_results(vals, cids, pair_seg, pair_slot, k, not ip,
                              invalid)


def grouped_tier(approx: bool, kk: int) -> str:
    """The grouped tier a kernel can serve: "segk" (the segmented scan,
    two best of 128 strided bins: kk ≤ 128) for approx, "kernel" (the
    grouped scan, kk ≤ 64) for exact, else "plain". The JAX package also
    asks that a list block fit the TPU kernels' VMEM
    (``pallas_segmented_wanted`` / ``pallas_grouped_wanted``); the CUDA
    scans tile L and d, so only kk decides here."""
    if approx:
        return "segk" if kk <= _k.LUT_SCAN_LANES else "plain"
    return "kernel" if kk <= _k.GROUPED_SCAN_MAX_KK else "plain"


def grouped_kernel_results(keys, pos, seg_list, ids, ip: bool):
    """The grouped-scan kernel's per-slot (minimized keys, in-list
    positions) [n_seg, S, kk] → (values, global ids): ip keys flip back
    to scores, and −1 positions become (invalid, −1)."""
    invalid = float("-inf") if ip else float("inf")
    vals = torch.where(pos < 0, torch.full_like(keys, invalid),
                       -keys if ip else keys)
    cids = ids[seg_list.long()[:, None, None], pos.long().clamp_min(0)]
    return vals, torch.where(pos < 0, torch.full_like(cids, -1), cids)


def merge_slot_results(vals, cids, pair_seg, pair_slot, k: int,
                       select_min: bool, invalid: float):
    """Per-slot top-kk (values, ids) [n_seg, S, kk] → (values [B, k], ids
    [B, k]): one cut per query over its n_probes·kk survivors, padded with
    (invalid, −1) past them."""
    B, P = pair_seg.shape
    kk = vals.shape[-1]
    pv, pi = gather_segment_results(vals, cids, pair_seg, pair_slot)
    kq = min(k, P * kk)
    out_vals, out_ids = select_k(pv.reshape(B, P * kk), kq,
                                 select_min=select_min,
                                 input_indices=pi.reshape(B, P * kk))
    if k > kq:
        out_vals = torch.nn.functional.pad(out_vals, (0, k - kq),
                                           value=invalid)
        out_ids = torch.nn.functional.pad(out_ids, (0, k - kq), value=-1)
    return out_vals, out_ids


def grouped_mem_ok(n_seg: int, seg: int, kk: int, pairs: int) -> bool:
    """The grouped tiers' buffer guard (the JAX package's model): the
    [n_seg, seg] query table, the [n_seg, seg, kk] key+id accumulators and
    the [pairs, kk] pair-order gather. The segmented tier's [n_seg, seg,
    256] bin table is not counted, as in the JAX package."""
    return (n_seg * seg * (4 + 8 * kk) + pairs * kk * 8) <= GROUPED_BYTES_CAP


# Spill-cascade depth shared by every build that spills: a dense blob can
# fill its whole ~5-list neighbourhood, so a 6th choice still keeps rows.
SPILL_DEPTH = 6


def spill_assignments(l1: torch.Tensor, l2: torch.Tensor, n_lists: int,
                      cap: int, *more: torch.Tensor) -> torch.Tensor:
    """Cap list loads at ``cap`` by cascading overflow rows to their next
    choices (``l2``, then each of ``more``); rows that overflow every
    choice get the marker ``n_lists`` (``pack_lists`` drops them).

    Exact and integer-valued, with one stable sort per choice generation:
    rows rank within a list by (list, arrival generation, row index), so
    settled rows never move and later arrivals are the ones past the cap —
    the JAX package's labels, bit for bit."""
    choices = (l2,) + more
    n = l1.shape[0]
    dev = l1.device
    iota = torch.arange(n, device=dev)
    g = len(choices) + 1
    kmax = g * n_lists + g
    group_starts = torch.arange(kmax, device=dev)

    def ranks(keys, base):
        sk, order = torch.sort(keys, stable=True)
        starts = torch.searchsorted(sk, group_starts)
        rk_sorted = iota - starts[base[order].clamp(0, kmax - 1)]
        rk = torch.empty_like(rk_sorted)
        rk[order] = rk_sorted
        return rk

    lab = l1.long()
    gen = torch.zeros(n, dtype=torch.long, device=dev)
    for c, lc in enumerate(choices, start=1):
        over = ranks(lab * g + gen, lab * g) >= cap
        lab = torch.where(over, lc.long(), lab)
        gen = torch.where(over, torch.full_like(gen, c), gen)
    rank = ranks(lab * g + gen, lab * g)
    return torch.where(rank >= cap, torch.full_like(lab, n_lists),
                       lab).to(torch.int32)


def lut_scan_mem_ok(n_seg: int, seg: int, rot: int, pairs: int,
                    nbins: int = 256) -> bool:
    """Transient-memory guard of the LUT-scan tier, with the JAX package's
    TPU-sized cap. The JAX package counted the per-segment query block,
    the [n_seg, seg, nbins] key+id tables and their pair-order gather; the
    port's kernel takes the queries as they are and writes the pairs' key
    and id rows [pairs, nbins] once, beside the [n_seg, seg] slot tables."""
    return pairs * nbins * 8 + n_seg * seg * 8 <= GROUPED_BYTES_CAP


def filtered_scan_mem_ok(n_lists: int, L: int, slot_bytes: int = 1) -> bool:
    """Transient-memory guard of a filtered scan, with the JAX package's
    cap: ``slot_bytes`` per id-table slot for the filter operand the tier
    builds — 1 for the LUT and ring tiers (the [n_lists, L] keep mask
    before it packs to bytes), 5 for segk's masked id table (mask + i32)
    — plus the packed keep bytes, n_lists·L/8."""
    slots = n_lists * L
    return slots * slot_bytes + slots // 8 <= GROUPED_BYTES_CAP


def tiered_refine_mem_ok(m_b: int, C: int, d: int,
                         depth: int = 2) -> bool:
    """Memory guard of the tiered prefetch re-rank (``neighbors.tiered``):
    up to ``depth`` landed ``[m_b, C, d]`` f32 candidate-row blocks parked
    in the prefetch queue plus the one being re-ranked live at once — the
    tier's whole device footprint (the base itself stays on the host).
    The JAX package's rule and cap (``GROUPED_BYTES_CAP``). Declining is
    always serviceable: the serialized host gather (``refine_gathered``)
    holds one block."""
    return (depth + 1) * m_b * C * d * 4 <= GROUPED_BYTES_CAP


def gather_refine_mem_ok(n: int, d: int, itemsize: int = 4, m: int = 0,
                         C: int = 0, row_align: int = 128) -> bool:
    """Guard of the fused gather-refine tier. The TPU kernel read
    lane-aligned rows, so a dataset whose width was not a multiple of 128
    paid a per-call padded ``[n, ceil(d/128)·128]`` copy, which had to fit
    the cap and be smaller than the ``[m, C, d]`` gather it replaces.
    ``row_align`` is the row alignment the kernel needs: 128 for the TPU
    model; the CUDA kernel reads rows at their own width (``row_align=1``)
    and pays no copy."""
    if d % row_align == 0:
        return True
    dpad = -(-d // row_align) * row_align
    pad_copy = n * dpad * itemsize
    if pad_copy > GROUPED_BYTES_CAP:
        return False
    if m and C:
        return pad_copy <= m * C * d * 4
    return True


def _lane_round(size: int) -> int:
    """List capacity rounded up: to 128 once lists are that big, to 8
    below (copied from ``raft_tpu.neighbors.ivf_flat``)."""
    size = max(8, size)
    if size >= 128:
        return -(-size // 128) * 128
    return -(-size // 8) * 8


def _fit_list_size(counts: np.ndarray, avg: int, cap_factor: float) -> int:
    """Padded list capacity: the actual max list size, clamped by the cap
    factor, rounded by :func:`_lane_round` (from ``ivf_flat``)."""
    cap = max(8, int(avg * cap_factor))
    actual = int(counts.max()) if counts.size else 8
    return _lane_round(min(cap, actual))


def stable_slots(labels: torch.Tensor, n_lists: int,
                 base: Optional[torch.Tensor] = None):
    """Each row's (list, slot) address from one stable sort of ``labels``
    (``raft_tpu.neighbors.ivf_pq._stable_slots``): row ``order[i]`` goes
    to ``(sorted_l[i], slot[i])``; ``base`` offsets the slots by the
    lists' current fill (extend)."""
    lab = labels.long()
    sorted_l, order = torch.sort(lab, stable=True)
    starts = torch.searchsorted(sorted_l, torch.arange(n_lists + 1,
                                                       device=lab.device))
    slot = torch.arange(lab.shape[0], device=lab.device) - starts[sorted_l]
    if base is not None:
        slot = base.long()[sorted_l.clamp(0, n_lists - 1)] + slot
    return order, sorted_l, slot


def pack_lists(row_arrays, labels: torch.Tensor, row_ids: torch.Tensor,
               n_lists: int, L: int, fill_values):
    """Pack rows into padded per-list blocks with one stable sort of
    ``labels``; rows with a label outside [0, n_lists) or a slot ≥ L are
    dropped.

    Returns (packed_arrays [n_lists, L, ...], ids [n_lists, L] (-1 pad, in
    ``row_ids``' dtype), sizes [n_lists] i32, n_dropped (int — rows lost to
    overflow), (row_list [n], row_slot [n]) each row's address)."""
    n = labels.shape[0]
    dev = labels.device
    lab = labels.long()
    sorted_l, order = torch.sort(lab, stable=True)
    starts = torch.searchsorted(sorted_l, torch.arange(n_lists, device=dev))
    rank = torch.arange(n, device=dev) - starts[sorted_l.clamp(0, n_lists - 1)]
    keep = (sorted_l >= 0) & (sorted_l < n_lists) & (rank < L)
    kl, kr, ko = sorted_l[keep], rank[keep], order[keep]
    packed = []
    for arr, fill in zip(row_arrays, fill_values):
        out = torch.full((n_lists, L) + tuple(arr.shape[1:]), fill,
                         dtype=arr.dtype, device=dev)
        out[kl, kr] = arr[ko]
        packed.append(out)
    ids = torch.full((n_lists, L), -1, dtype=row_ids.dtype, device=dev)
    ids[kl, kr] = row_ids[ko]
    in_range = (lab >= 0) & (lab < n_lists)
    counts = torch.bincount(lab[in_range], minlength=n_lists)
    sizes = counts.clamp(max=L)
    n_dropped = int((counts - sizes).sum())
    row_list = torch.empty_like(sorted_l)
    row_slot = torch.empty_like(rank)
    row_list[order] = sorted_l
    row_slot[order] = rank
    return packed, ids, sizes.to(torch.int32), n_dropped, (row_list, row_slot)
