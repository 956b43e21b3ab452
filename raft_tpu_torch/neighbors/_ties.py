"""The JAX package's tie rules for the graph builds and searches
(``cagra``, ``nn_descent``): selections that keep ``lax.top_k``'s order
and the first occurrence of a repeated id, both through stable sorts."""

from __future__ import annotations

import torch


def top_k_low(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` smallest keys of each row, ascending, the
    lower position first among equal keys (``lax.top_k(-keys, k)``'s
    order); −0.0 is read as +0.0, as a comparison does, on both devices."""
    return torch.sort(keys + 0.0, dim=1, stable=True)[1][:, :k]


def first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """True where an id repeats an earlier one of its row (sort-based:
    equal ids adjacent after a stable sort, the first kept)."""
    s, order = torch.sort(ids, dim=1, stable=True)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.empty_like(dup).scatter_(1, order, dup)
