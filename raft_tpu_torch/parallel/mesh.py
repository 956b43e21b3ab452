"""A mesh of ranks in one process (counterpart of
``raft_tpu.parallel.mesh``).

The JAX package is single-controller SPMD: one program runs over a mesh of
logical devices (``shard_map``), and its collectives are ``lax`` verbs
that XLA schedules on the interconnect. The counterpart here is also one
process. A :class:`Mesh` is a list of ranks, each placed on a
``torch.device``; ``shard_map(body, mesh, ...)`` becomes a plain loop of
``body`` over the ranks. A sharded array is a list of per-rank tensors,
each on its rank's device; a replicated one is one tensor per rank (the
same tensor for ranks that share a device). The ``Comms`` verbs take and
return such lists. When there are fewer cards than ranks, several ranks
share a card: that is how one H100 runs a 4-rank ring, and the ring
kernels then read their neighbour's blocks through local device
pointers. The ring kernels over ranks on several cards (peer pointers
over NVLink) are not ported yet (ROADMAP A15): such a mesh merges on the
plain ring schedule or the allgather, and its other kernels run per rank
on each rank's card.
NCCL is not used: it runs one process per card and refuses two ranks on
one GPU, so a design on ``torch.distributed`` could not run the ring on
one card at all.

Only 1-D meshes are ported: ``hier_mesh``, ``submesh`` and
``make_hybrid_mesh`` raise (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.errors import expects, not_ported


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: rank r runs on ``devices[r]``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "shard"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_cards(self) -> int:
        """The CUDA cards the ranks use (0 on the CPU)."""
        return len({d for d in self.devices if d.type == "cuda"})

    @property
    def distinct_devices(self) -> List[torch.device]:
        """The devices the ranks use, each once, in rank order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def make_mesh(n_ranks: int, device: Union[str, torch.device,
                                          Sequence] = "cuda",
              axis_name: str = "shard") -> Mesh:
    """A mesh of ``n_ranks`` ranks.

    ``device="cuda"`` places rank r on ``cuda:(r mod
    torch.cuda.device_count())``: one rank per card where there are enough
    cards, several ranks on a card where there are not. ``"cuda:i"`` puts
    every rank on card i, ``"cpu"`` every rank on the CPU (the plain
    versions of the kernels then run), and a sequence names each rank's
    device."""
    expects(n_ranks >= 1, "a mesh needs at least one rank (got %d)", n_ranks)
    if isinstance(device, (list, tuple)):
        expects(len(device) == n_ranks, "%d devices for %d ranks",
                len(device), n_ranks)
        devs = tuple(resolve_device(d) for d in device)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            n_cards = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", r % n_cards)
                         for r in range(n_ranks))
        else:
            devs = (dev,) * n_ranks
    return Mesh(devices=devs, axis_name=axis_name)


def hier_mesh(*args, **kwargs):
    raise not_ported("2-D (dcn, ici) meshes (hier_mesh)", "A15")


def submesh(*args, **kwargs):
    raise not_ported("submesh", "A15")


def make_hybrid_mesh(*args, **kwargs):
    raise not_ported("multi-slice meshes (make_hybrid_mesh)", "A15")


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """One tensor per rank, copied once per distinct device (ranks that
    share a device share the tensor)."""
    per_dev = {d: x.to(d) for d in mesh.distinct_devices}
    return [per_dev[d] for d in mesh.devices]


def shard_rows(x: torch.Tensor, mesh: Mesh) -> Tuple[List[torch.Tensor], int]:
    """Row-shard ``x [n, ...]`` over the mesh: zero-pad n to a multiple of
    the rank count, rank r takes rows ``[r·s, (r+1)·s)`` on its device (a
    view when it already lies there). Returns (shards, n)."""
    n = x.shape[0]
    n_dev = mesh.size
    padded = -(-n // n_dev) * n_dev
    if padded != n:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1)
                                    + (0, padded - n))
    s = padded // n_dev
    return [x[r * s:(r + 1) * s].to(mesh.devices[r])
            for r in range(n_dev)], n
