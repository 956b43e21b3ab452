"""A mesh of ranks in one process (counterpart of
``raft_tpu.parallel.mesh``).

The JAX package is single-controller SPMD: one program runs over a mesh of
logical devices (``shard_map``), and its collectives are ``lax`` verbs
that XLA schedules on the interconnect. The counterpart here is also one
process. A :class:`Mesh` is a grid of ranks, each placed on a
``torch.device``; ``shard_map(body, mesh, ...)`` becomes a plain loop of
``body`` over the ranks. A sharded array is a list of per-rank tensors,
each on its rank's device, in rank order; a replicated one is one tensor
per rank (the same tensor for ranks that share a device). The ``Comms``
verbs take and return such lists. When there are fewer cards than ranks,
several ranks share a card: that is how one H100 runs a 4-rank ring, and
the ring kernels then read their neighbour's blocks through local device
pointers. The ring kernels over ranks on several cards (peer pointers
over NVLink) are not ported yet (ROADMAP A15, fault C4): such a mesh
merges on the plain ring schedule or the allgather, and its other kernels
run per rank on each rank's card.
NCCL is not used: it runs one process per card and refuses two ranks on
one GPU, so a design on ``torch.distributed`` could not run the ring on
one card at all.

A mesh has one axis (``make_mesh``) or two (``hier_mesh``, ``submesh``
with a shape): ``(outer, inner)``, the outer axis the slow one (DCN-
labeled, :func:`is_dcn_axis`), rank ``r = outer_idx · n_inner +
inner_idx`` — the row-major order of the JAX package's device grid, so
a row-sharded array's rank r holds the same rows in both packages.
``make_hybrid_mesh`` (slices of devices on several hosts) raises: it
needs cards on several hosts (ROADMAP A15, C4).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.errors import expects, not_ported

# Axis names the stack treats as the slow (cross-pod) interconnect: the
# hier merge tier auto-enables when a 2-D exchange's outer axis carries
# one, and hier_mesh refuses an outer axis that does not. Canonical 2-D
# naming is HIER_AXIS_NAMES = (outer, inner) = ("dcn", "ici").
DCN_AXIS_PREFIXES = ("dcn", "pod", "slice")
HIER_AXIS_NAMES = ("dcn", "ici")


def is_dcn_axis(name: object) -> bool:
    """True when ``name`` labels a slow (cross-pod) mesh axis
    (:data:`DCN_AXIS_PREFIXES`)."""
    return isinstance(name, str) and name.lower().startswith(DCN_AXIS_PREFIXES)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks: rank r runs on ``devices[r]``, at grid coordinates
    ``coords(r)`` (row-major over ``shape``). A 1-D mesh has ``shape ==
    (size,)`` and ``axis_names == (axis_name,)``; a 2-D mesh's
    ``axis_name`` is its axes' joined label (``"dcn+ici"``)."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "shard"
    shape: Tuple[int, ...] = ()
    axis_names: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),))
        if not self.axis_names:
            object.__setattr__(self, "axis_names", (self.axis_name,))
        expects(len(self.shape) == len(self.axis_names),
                "mesh shape %s does not match axis names %s", self.shape,
                self.axis_names)
        expects(math.prod(self.shape) == len(self.devices),
                "mesh shape %s covers %d ranks, got %d devices", self.shape,
                math.prod(self.shape), len(self.devices))
        expects(len(set(self.axis_names)) == len(self.axis_names),
                "duplicate mesh axis names %s", self.axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """``{axis name: size}`` — the JAX mesh's ``shape`` mapping."""
        return dict(zip(self.axis_names, self.shape))

    def coords(self, r: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(r, self.shape))

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The ranks a collective over ``axes`` joins, one list per group:
        ranks that share their coordinates on every other axis, ordered
        by their coordinates on ``axes`` (the first name major) — the
        order of ``lax.axis_index`` over that axis tuple."""
        axes = tuple(axes)
        for a in axes:
            expects(a in self.axis_names, "axis %r is not an axis of the "
                    "mesh %s", a, self.axis_names)
        expects(len(set(axes)) == len(axes), "duplicate axes %s", axes)
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.ndim) if i not in pos]
        out = []
        for other in itertools.product(*[range(self.shape[i])
                                         for i in rest]):
            grp = []
            for mine in itertools.product(*[range(self.shape[i])
                                            for i in pos]):
                c = [0] * self.ndim
                for i, v in zip(rest, other):
                    c[i] = v
                for i, v in zip(pos, mine):
                    c[i] = v
                grp.append(int(np.ravel_multi_index(c, self.shape)))
            out.append(grp)
        return out

    def positions(self, axes: Union[str, Sequence[str], None] = None
                  ) -> Tuple[int, List[int]]:
        """``(n, pos)``: the rank count of a collective over ``axes`` (a
        name, a tuple, or None for every axis) and each rank's position
        in its group — the per-rank ``lax.axis_index`` over ``axes``. Over
        one axis of a 2-D mesh, ranks that share a position hold the same
        shard (``P(axis)``: sharded over it, replicated over the other)."""
        if axes is None:
            axes = self.axis_names
        elif isinstance(axes, str):
            axes = (axes,)
        groups = self.groups(axes)
        pos = [0] * self.size
        for g in groups:
            for j, r in enumerate(g):
                pos[r] = j
        return len(groups[0]), pos

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


def _place(n_ranks: int, device) -> Tuple[torch.device, ...]:
    """Each rank's device: a sequence names them; ``"cuda"`` places rank r
    on ``cuda:(r mod torch.cuda.device_count())``; ``"cuda:i"`` or
    ``"cpu"`` puts every rank there."""
    if isinstance(device, (list, tuple)):
        expects(len(device) >= n_ranks, "%d devices for %d ranks",
                len(device), n_ranks)
        return tuple(resolve_device(d) for d in device[:n_ranks])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n_cards = torch.cuda.device_count()
        return tuple(torch.device("cuda", r % n_cards)
                     for r in range(n_ranks))
    return (dev,) * n_ranks


def make_mesh(n_ranks: int, device: Union[str, torch.device,
                                          Sequence] = "cuda",
              axis_name: str = "shard") -> Mesh:
    """A 1-D mesh of ``n_ranks`` ranks.

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
    return Mesh(devices=_place(n_ranks, device), axis_name=axis_name)


def _grid_mesh(devs: Sequence[torch.device], shape: Sequence[int],
               axis_names: Sequence[str]) -> Mesh:
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) == 1:
        return Mesh(devices=tuple(devs), axis_name=names[0])
    return Mesh(devices=tuple(devs), axis_name="+".join(names), shape=shape,
                axis_names=names)


def _hier_axis_pair(axis_names: Sequence[str]) -> Tuple[str, str]:
    """Validate a 2-D (outer, inner) axis naming: outer slow, inner fast
    (the JAX package's rules and messages)."""
    names = tuple(axis_names)
    if len(names) != 2:
        raise ValueError(f"expected (outer, inner) axis names, "
                         f"got {names!r}")
    outer, inner = names
    if not is_dcn_axis(outer):
        raise ValueError(
            f"outer axis {outer!r} is not DCN-labeled (prefixes "
            f"{DCN_AXIS_PREFIXES}): the slow axis must be outermost, or "
            "the hier tier would ship the per-pod exchange cross-pod")
    if is_dcn_axis(inner):
        raise ValueError(
            f"inner axis {inner!r} is DCN-labeled: the intra-pod (fast) "
            "axis must be innermost")
    return outer, inner


def hier_mesh(ici_size: int, dcn_size: int,
              axis_names: Sequence[str] = HIER_AXIS_NAMES,
              devices: Union[str, torch.device, Sequence, Mesh] = "cuda"
              ) -> Mesh:
    """A 2-D ``(dcn_size, ici_size)`` mesh, the slow axis outermost: pods
    of ``ici_size`` ranks joined over DCN, the topology of the hier merge
    tier. ``devices`` is a device spec placed as :func:`make_mesh` places
    it (``"cuda"``: ranks share the cards round-robin), a sequence with at
    least ``ici_size · dcn_size`` devices (the first ones are used), or a
    mesh whose first ranks' devices are taken. The names are validated as
    the JAX package validates them: the outer axis DCN-labeled, the inner
    one not."""
    outer, inner = _hier_axis_pair(axis_names)
    if ici_size < 1 or dcn_size < 1:
        raise ValueError(f"hier_mesh sizes must be >= 1, got "
                         f"ici_size={ici_size} dcn_size={dcn_size}")
    need = ici_size * dcn_size
    if isinstance(devices, Mesh):
        devices = list(devices.devices)
    if isinstance(devices, (list, tuple)) and need > len(devices):
        raise ValueError(f"hier_mesh needs {need} devices "
                         f"({dcn_size}x{ici_size}), have {len(devices)}")
    return _grid_mesh(_place(need, devices), (dcn_size, ici_size),
                      (outer, inner))


def submesh(mesh: Mesh, n_dev: int, axis_names: Sequence[str] = ("shard",),
            shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the first ``n_dev`` ranks of ``mesh`` (their devices):
    the 1-D carve by default; with ``shape`` and matching ``axis_names`` a
    named 2-D carve, validated as :func:`hier_mesh` validates."""
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(
                f"submesh with {len(axis_names)} axis names needs an "
                "explicit shape (the 1-D default cannot be inferred)")
        shape = (n_dev,)
    else:
        shape = tuple(shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axis names "
                             f"{tuple(axis_names)}")
        if math.prod(shape) != n_dev:
            raise ValueError(f"shape {shape} covers {math.prod(shape)} "
                             f"devices, asked for {n_dev}")
        if len(shape) == 2:
            _hier_axis_pair(axis_names)
        elif len(shape) > 2:
            raise ValueError(f"meshes of {len(shape)} axes are not "
                             "supported (1-D or (outer, inner))")
    if n_dev > mesh.size:
        raise ValueError(f"submesh of {n_dev} devices from a "
                         f"{mesh.size}-device mesh")
    return _grid_mesh(mesh.devices[:n_dev], shape, axis_names)


def make_hybrid_mesh(*args, **kwargs):
    raise not_ported("multi-slice meshes (make_hybrid_mesh: cards on "
                     "several hosts, fault C4)", "A15")


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """One tensor per rank, copied once per distinct device (ranks that
    share a device share the tensor)."""
    per_dev = {d: x.to(d) for d in mesh.distinct_devices}
    return [per_dev[d] for d in mesh.devices]


def per_shard(mesh: Mesh, axis: Union[str, Sequence[str], None],
              fn: Callable[[int, int], Any]) -> List[Any]:
    """``fn(r, p)`` once per (position p along ``axis``, device), at the
    first rank r that holds them, its result handed to every rank that
    shares them: over one axis of a 2-D mesh the ranks that replicate a
    shard on one device share its work. Returns one result a rank."""
    _, pos = mesh.positions(axis)
    made: Dict[Tuple[int, torch.device], Any] = {}
    out = []
    for r, p in enumerate(pos):
        key = (p, mesh.devices[r])
        if key not in made:
            made[key] = fn(r, p)
        out.append(made[key])
    return out


def shard_rows(x: torch.Tensor, mesh: Mesh,
               axis: Union[str, Sequence[str], None] = None
               ) -> Tuple[List[torch.Tensor], int]:
    """Row-shard ``x [n, ...]`` over ``axis`` (None: every axis of the
    mesh, rank order; the JAX package's ``P(axis)``): zero-pad n to a
    multiple of the axis's rank count n_dev; the rank at position p along
    ``axis`` takes rows ``[p·s, (p+1)·s)`` on its device (a view when it
    already lies there). Over one axis of a 2-D mesh the ranks that share
    a position (the other axis's replicas) share one tensor a device.
    Returns (one shard per rank, n)."""
    n = x.shape[0]
    n_dev = mesh.positions(axis)[0]
    padded = -(-n // n_dev) * n_dev
    if padded != n:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1)
                                    + (0, padded - n))
    s = padded // n_dev
    return per_shard(mesh, axis, lambda r, p: x[p * s:(p + 1) * s].to(
        mesh.devices[r])), n
