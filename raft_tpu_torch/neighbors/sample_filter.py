"""Sample filters for ANN search (counterpart of
``raft_tpu.neighbors.sample_filter``; the reference's ``bitset_filter``,
neighbors/sample_filter_types.hpp).

A filter is a packed bitset over dataset row ids (``core.bitset``) where a
set bit means the row may be returned. Every search path takes
``filter_bitset``; a filtered candidate is scored +inf (−inf for
similarities) before its top-k, as an invalid id is. The scan kernels take
the filter as per-list keep bytes (:func:`list_filter_bytes`), the
re-rank kernel as the words themselves.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from raft_tpu_torch.core import bitset


def make_filter(n: int, remove=None, keep=None, device="cuda"
                ) -> torch.Tensor:
    """A filter over ``n`` rows: ``remove`` the ids to exclude (all others
    kept — deleted vectors), or ``keep`` the only ids allowed. Neither →
    allow all; both raise."""
    if remove is not None and keep is not None:
        raise ValueError("pass either remove or keep, not both")
    if keep is not None:
        return bitset.set_bits(bitset.create(n, False, device=device), keep)
    bits = bitset.create(n, True, device=device)
    if remove is not None:
        bits = bitset.set_bits(bits, remove, False)
    return bits


def passes(filter_bits: Optional[torch.Tensor], ids: torch.Tensor
           ) -> torch.Tensor:
    """Whether each candidate id passes the filter (negative ids — pads —
    never do when there is a filter; without one every id passes)."""
    if filter_bits is None:
        return torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    return bitset.test(filter_bits, ids)


def masked_ids(filter_bits: Optional[torch.Tensor], ids: torch.Tensor
               ) -> torch.Tensor:
    """``ids`` with every id the filter clears set to the −1 sentinel (the
    ids themselves without a filter). A scan or select that treats id < 0
    as invalid then sees only kept rows, and a slot picked past the kept
    ones returns −1, never a filtered id."""
    if filter_bits is None:
        return ids
    return torch.where(passes(filter_bits, ids), ids, torch.full_like(ids, -1))


def pack_mask_bytes(keep: torch.Tensor) -> torch.Tensor:
    """A boolean mask packed along its last axis into little-endian bytes
    (bit j of byte b is position 8·b + j), padded with 0 — the layout the
    scan kernels read. The same bits as the bitset's words."""
    L = keep.shape[-1]
    pad = (-L) % 8
    if pad:
        keep = torch.nn.functional.pad(keep, (0, pad), value=False)
    m = keep.reshape(*keep.shape[:-1], -1, 8).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=keep.device)
    return (m << shifts).sum(-1, dtype=torch.int32).to(torch.uint8)


def list_filter_bytes(filter_bits, packed_ids: torch.Tensor) -> torch.Tensor:
    """Per-list keep bytes ``[n_lists, ceil(L/8)]`` u8 over an id table:
    bit j of byte b in list l is 1 iff ``packed_ids[l, 8·b + j]`` passes
    the filter (pad slots, id −1, pack as 0) — the scan kernels' filter
    operand, n/8 bytes.

    Made once per (bitset tensor, id table) and kept on the bitset tensor,
    one entry per id table (made again if either is written in place): a
    filter reused over a search's batches, and over the ranks of a mesh,
    pays for its bytes once. Making them reads the whole id table: made
    for every batch, they cost the filtered main path about a quarter of
    its queries per second on the card (``PERF.md`` §6)."""
    bits = bitset.as_words(filter_bits, packed_ids.device)
    kept = getattr(bits, "_rtt_keep_bytes", None)
    if kept is None:
        kept = bits._rtt_keep_bytes = {}
    stamp = (packed_ids._version, bits._version)
    hit = kept.get(id(packed_ids))
    if hit is not None and hit[0]() is packed_ids and hit[1] == stamp:
        return hit[2]
    for key in [key for key, v in kept.items() if v[0]() is None]:
        del kept[key]     # id tables that are gone
    fbytes = pack_mask_bytes(passes(bits, packed_ids)).contiguous()
    kept[id(packed_ids)] = (weakref.ref(packed_ids), stamp, fbytes)
    return fbytes
