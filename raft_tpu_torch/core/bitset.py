"""Packed bitset over row ids (counterpart of ``raft_tpu.core.bitset``,
itself after the reference's ``raft::core::bitset``, core/bitset.cuh:
test :235, flip :279).

Bits pack little-endian into 32-bit words, as in the JAX package: bit
``i`` is bit ``i mod 32`` of word ``i // 32``. The JAX package keeps the
words as uint32; torch's bit operations want signed integers, so the port
keeps the same bits in an int32 tensor (a set bit 31 reads as a negative
word). :func:`as_words` takes a bitset as it crosses from the JAX
package — a numpy ``uint32`` array, or a torch ``uint32`` or ``int32``
tensor — and gives the int32 words on a device; every function here
accepts those forms. The functions are pure: they return new tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device

WORD_BITS = 32


def n_words(bitset_len: int) -> int:
    return (bitset_len + WORD_BITS - 1) // WORD_BITS


def as_words(bits, device=None) -> torch.Tensor:
    """A bitset's words as a contiguous int32 tensor (the same bits), on
    ``device`` (default: where ``bits`` lies; numpy arrays go to the CPU).
    Takes numpy uint32/int32 arrays and torch uint32/int32 tensors."""
    if not isinstance(bits, torch.Tensor):
        a = np.ascontiguousarray(bits)
        if a.dtype not in (np.uint32, np.int32):
            raise TypeError(f"bitset words must be uint32 or int32 (got "
                            f"{a.dtype})")
        bits = torch.from_numpy(a.view(np.int32).copy())
    elif bits.dtype == torch.uint32:
        bits = bits.contiguous().view(torch.int32)
    elif bits.dtype != torch.int32:
        raise TypeError(f"bitset words must be uint32 or int32 (got "
                        f"{bits.dtype})")
    if bits.dim() != 1:
        raise ValueError(f"bitset words must be 1-D (got shape "
                         f"{tuple(bits.shape)})")
    if device is not None:
        bits = bits.to(device)
    return bits.contiguous()


def to_numpy(bits) -> np.ndarray:
    """The words as the JAX package keeps them: a numpy uint32 array."""
    return as_words(bits).cpu().numpy().view(np.uint32)


def _pack(m: torch.Tensor) -> torch.Tensor:
    """[w, 32] 0/1 → [w] int32 words (bit j of word i = m[i, j])."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=m.device)
    v = (m.to(torch.int64) << shifts).sum(1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def create(bitset_len: int, default_value: bool = True, device="cuda"
           ) -> torch.Tensor:
    """All-set (or all-clear) bitset of ``bitset_len`` bits."""
    return torch.full((n_words(bitset_len),), -1 if default_value else 0,
                      dtype=torch.int32, device=resolve_device(device))


def from_mask(mask, device=None) -> torch.Tensor:
    """Pack a boolean vector into a bitset (a numpy mask lands on
    ``device``, default "cuda"; a tensor stays where it lies unless
    ``device`` is given)."""
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool))
        device = resolve_device(device or "cuda")
    if device is not None:
        mask = mask.to(resolve_device(device))
    n = mask.shape[0]
    m = torch.zeros(n_words(n) * WORD_BITS, dtype=torch.bool,
                    device=mask.device)
    m[:n] = mask.bool()
    return _pack(m.view(-1, WORD_BITS))


def to_mask(bits, bitset_len: int) -> torch.Tensor:
    """Unpack into a boolean vector of length ``bitset_len``."""
    w = as_words(bits)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=w.device)
    m = ((w[:, None] >> shifts[None, :]) & 1).bool().reshape(-1)
    return m[:bitset_len]


def word_at(bits, ids: torch.Tensor) -> torch.Tensor:
    """The word covering each id. Negative ids (the −1 sentinel, either
    width) read word 0, and callers mask with ``ids >= 0``; ids past the
    last word read the last word, as the JAX package's gather clamps. The
    word index is divided in the id's own width: an int64 id past 2³¹ is
    never narrowed."""
    w = as_words(bits)
    safe = torch.where(ids >= 0, ids, torch.zeros_like(ids))
    return w[(safe // WORD_BITS).clamp(max=w.shape[0] - 1).long()]


def test(bits, idx: torch.Tensor) -> torch.Tensor:
    """Bit(s) at ``idx`` as bool (reference: bitset::test,
    core/bitset.cuh:235); negative ids test False."""
    word = word_at(bits, idx)
    off = torch.where(idx >= 0, idx, torch.zeros_like(idx)) % WORD_BITS
    return (((word >> off.to(torch.int32)) & 1) > 0) & (idx >= 0)


def set_bits(bits, idx, value: bool = True) -> torch.Tensor:
    """A new bitset with the bit(s) at ``idx`` set (or cleared). Every one
    of several ids landing in the same word is kept: the ids go into a
    [n_words, 32] grid that is packed into one OR pattern, not through a
    read-modify-write scatter of words."""
    w = as_words(bits)
    idx = torch.as_tensor(idx, device=w.device).reshape(-1).long()
    grid = torch.zeros((w.shape[0], WORD_BITS), dtype=torch.bool,
                       device=w.device)
    grid[idx // WORD_BITS, idx % WORD_BITS] = True
    pattern = _pack(grid)
    return w | pattern if value else w & ~pattern


def flip(bits) -> torch.Tensor:
    """Flip all bits (reference: bitset::flip, core/bitset.cuh:279)."""
    return ~as_words(bits)


def count(bits, bitset_len: int) -> int:
    """Population count over the valid prefix."""
    return int(to_mask(bits, bitset_len).sum())


def density(bits) -> float:
    """Set-bit fraction over the whole word array, trailing pad bits of
    the last word included (an error below 32/n) — the selectivity
    estimate of the fp8 LUT dispatch (``ivf_pq.resolve_lut_dtype``)."""
    w = as_words(bits)
    if w.numel() == 0:
        return 0.0
    return float(to_mask(w, w.numel() * WORD_BITS).float().mean())
