"""Per-component memory placement — where an index's pieces live
(counterpart of ``raft_tpu.serve.placement``).

An IVF tenant's scan structures (PQ codes, centroids, norms — the small,
every-query operands) stay on the card, while its raw vectors — the big
component touched only at the exact re-rank — may live in host memory (a
numpy array or memmap) and reach the card as candidate rows through the
tiered prefetch pipeline (:mod:`raft_tpu_torch.neighbors.tiered`).
Demoting a tenant's raw vectors frees their device memory without
evicting the tenant, and results stay EXACT: the re-rank still runs
against the full-precision rows; only where they are fetched from
changes.

:class:`Placement` records that choice:

- ``codes="hbm"`` — the scan structures, always on the card;
- ``raw="hbm" | "host" | "none"`` — the re-rank base: ``"hbm"`` routes
  refine through the device tiers, ``"host"`` through the tiered
  candidate-row prefetch or the serialized host gather, ``"none"`` means
  no dataset (approximate distances only).

The tier names are the JAX package's; ``"hbm"`` is the card's memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device

__all__ = ["Placement", "dataset_tier", "placement_for",
           "to_host", "to_device"]

_CODE_TIERS = ("hbm",)
_RAW_TIERS = ("hbm", "host", "none")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each index component lives. Frozen — a tier move makes a new
    record (``dataclasses.replace``)."""

    codes: str = "hbm"
    raw: str = "hbm"

    def __post_init__(self):
        if self.codes not in _CODE_TIERS:
            raise ValueError(
                f"Placement.codes={self.codes!r} unsupported (scan "
                f"structures live on the card: {_CODE_TIERS})")
        if self.raw not in _RAW_TIERS:
            raise ValueError(
                f"Placement.raw={self.raw!r} not one of {_RAW_TIERS}")

    def describe(self) -> Dict[str, str]:
        """JSON-ready dict."""
        return {"codes": self.codes, "raw": self.raw}


def dataset_tier(dataset: Any) -> str:
    """Observed residency of a re-rank base: ``"none"`` (no dataset),
    ``"hbm"`` (a tensor on a CUDA device), or ``"host"`` (a numpy array,
    memmap, CPU tensor or device-chunk provider — anything the refine
    tiers gather or regenerate rather than index in place on the card)."""
    if dataset is None:
        return "none"
    if isinstance(dataset, torch.Tensor) and dataset.device.type == "cuda":
        return "hbm"
    return "host"


def placement_for(dataset: Any) -> Placement:
    """The placement a dataset implies: codes on the card, raw wherever
    the dataset already lives."""
    return Placement(codes="hbm", raw=dataset_tier(dataset))


def to_host(dataset: Any):
    """Demote a re-rank base to a host numpy array (a tensor → one copy
    to the host; a CPU tensor → its numpy view; numpy arrays, memmaps and
    providers pass through untouched, so the call is idempotent)."""
    if isinstance(dataset, torch.Tensor):
        return dataset.detach().cpu().numpy()
    return dataset


def to_device(dataset: Any, device="cuda"):
    """Promote a re-rank base to ``device`` as an f32 tensor (one copy;
    a tensor already there passes through). Memmap sources land as a
    plain tensor — promotion materializes the rows, that is the point."""
    if dataset is None:
        return None
    dev = resolve_device(device)
    if isinstance(dataset, torch.Tensor):
        return dataset.to(dev)
    return torch.from_numpy(np.ascontiguousarray(dataset, np.float32)).to(dev)
