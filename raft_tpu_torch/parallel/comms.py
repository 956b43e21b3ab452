"""Communicator over a :class:`~raft_tpu_torch.parallel.mesh.Mesh`
(counterpart of ``raft_tpu.parallel.comms``).

The JAX package's ``Comms`` wraps ``lax`` collectives that run inside
``shard_map``. Here a collective takes a list of per-rank tensors (one
per rank of the mesh, each on its rank's device, in rank order) and
returns such a list: the per-rank value each rank's ``lax`` verb would
return. A communicator is bound to one mesh axis or a tuple of them
(``Comms(mesh, axis)``, :meth:`Comms.comm_split`): its collectives run
within each group of ranks that share their coordinates on the other
axes, in the group's order (``lax.axis_index`` over those axes, the first
name major). A reduction runs in rank order on each distinct device of a
group, so ranks that share a device share the result.

**Counters** follow the JAX package's byte model (``comms.py:23-45``):
each collective counts one op and its per-rank payload bytes under
``(op, axis)``; the gather family (allgather, gather, bcast, allgatherv,
gatherv) counts ``axis_size × payload``, the table every rank assembles;
the ring exchange counts one op and one ``[mc, k]`` surviving block per
hop, whether the hop is :meth:`Comms.ring_topk_hop` or the ring kernel's
pointer reads (:meth:`Comms.count_ring_topk`). A communicator over two
axes counts one op on each axis, innermost first, the gather family
charging each stage its gathered table. The counts are a model of what a
mesh of separate devices would move over its links, not a measurement:
ranks that share a card move nothing. :func:`counters` reads them and
:func:`reset_counters` clears them. Every collective is also the fault
point ``comms.<verb>`` (``robust.faults``).
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core.errors import expects, not_ported
from raft_tpu_torch.parallel.mesh import Mesh
from raft_tpu_torch.robust import faults as _faults


class Op(enum.Enum):
    """Reduction op (reference: core/comms.hpp:36 ``op_t``)."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


class Status(enum.Enum):
    """Collective status (reference: core/comms.hpp:39 ``status_t``)."""

    SUCCESS = 0
    ERROR = 1
    ABORT = 2


_GATHER_FAMILY = frozenset(
    {"allgather", "gather", "bcast", "allgatherv", "gatherv"})

# (op, axis) → count; the JAX package's comms.ops / comms.bytes series
_OPS: Dict[Tuple[str, str], int] = {}
_BYTES: Dict[Tuple[str, str], int] = {}


def counters() -> Dict[str, Dict[Tuple[str, str], int]]:
    """``{"ops": {(op, axis): n}, "bytes": {(op, axis): n}}``, copies."""
    return {"ops": dict(_OPS), "bytes": dict(_BYTES)}


def reset_counters() -> None:
    _OPS.clear()
    _BYTES.clear()


def _payload_bytes(*blocks) -> int:
    """Bytes of one rank's payload: tensors, (shape, dtype) pairs, or
    Python scalars (8 bytes, as the JAX package counts them)."""
    total = 0
    for b in blocks:
        if isinstance(b, torch.Tensor):
            total += b.numel() * b.element_size()
        elif isinstance(b, tuple):
            shape, dtype = b
            total += int(math.prod(shape)) * torch.empty(
                (), dtype=dtype).element_size()
        else:
            total += 8
    return total


_REDUCE: Dict[Op, Callable] = {
    Op.SUM: torch.add, Op.PROD: torch.mul, Op.MIN: torch.minimum,
    Op.MAX: torch.maximum}


class Comms:
    """Collectives over the ranks of a mesh axis or axis tuple (reference:
    ``comms_t``, core/comms.hpp:242). ``axis=None`` takes the mesh's own:
    its one axis, or both axes of a 2-D mesh."""

    def __init__(self, mesh: Mesh, axis: Union[str, Sequence[str],
                                               None] = None):
        self.mesh = mesh
        if axis is None:
            axis = mesh.axis_name if mesh.ndim == 1 else tuple(
                mesh.axis_names)
        if not isinstance(axis, str):
            axis = tuple(axis)
        self.axis_name = axis
        self._axes = (axis,) if isinstance(axis, str) else axis
        self._groups = mesh.groups(self._axes)
        self._pos = [0] * mesh.size
        self._group = [None] * mesh.size
        for g in self._groups:
            for j, r in enumerate(g):
                self._pos[r] = j
                self._group[r] = g

    def get_size(self) -> int:
        return len(self._groups[0])

    def get_rank(self) -> List[int]:
        """Each rank's index along the axis: the per-rank value of
        ``lax.axis_index``."""
        return list(self._pos)

    def comm_split(self, axis: Union[str, Sequence[str]]) -> "Comms":
        """Sub-communicator over other axes of the same mesh (reference:
        ``comms_t::comm_split``): bytes are then attributed to them."""
        return Comms(self.mesh, axis)

    def _count(self, op_name: str, *blocks) -> None:
        _faults.faultpoint(f"comms.{op_name}")
        payload = _payload_bytes(*blocks)
        sizes = self.mesh.axis_sizes
        if isinstance(self.axis_name, str):
            per_axis = [(self.axis_name, payload * (
                sizes[self.axis_name] if op_name in _GATHER_FAMILY else 1))]
        else:
            per_axis = []
            mult = 1
            # innermost stage first: its gathered table is what the next
            # (outer) stage's gather moves
            for a in reversed(self._axes):
                if op_name in _GATHER_FAMILY:
                    mult *= sizes[a]
                per_axis.append((a, payload * mult))
        for a, nbytes in per_axis:
            key = (op_name, a)
            _OPS[key] = _OPS.get(key, 0) + 1
            _BYTES[key] = _BYTES.get(key, 0) + nbytes

    def _check(self, xs: Sequence) -> None:
        expects(len(xs) == self.mesh.size, "%d per-rank tensors for %d ranks",
                len(xs), self.mesh.size)

    def _per_device(self, fn) -> List:
        """``fn(group, device)`` once per (group, distinct device of the
        group), handed to every rank of the group on that device."""
        out = [None] * self.mesh.size
        for g in self._groups:
            done = {}
            for r in g:
                dev = self.mesh.devices[r]
                if dev not in done:
                    done[dev] = fn(g, dev)
                out[r] = done[dev]
        return out

    def _reduce(self, xs, op: Op) -> List[torch.Tensor]:
        expects(op in _REDUCE, "unknown reduction op %r", op)
        fn = _REDUCE[op]

        def red(g, dev):
            acc = xs[g[0]].to(dev)
            for r in g[1:]:
                acc = fn(acc, xs[r].to(dev))
            return acc
        return self._per_device(red)

    # -- collectives -------------------------------------------------------
    def allreduce(self, xs: Sequence[torch.Tensor], op: Op = Op.SUM
                  ) -> List[torch.Tensor]:
        """reference: comms_t::allreduce (core/comms.hpp:344). The group's
        tensors are reduced in rank order on each distinct device."""
        self._check(xs)
        self._count("allreduce", xs[0])
        return self._reduce(xs, op)

    def reduce(self, xs: Sequence[torch.Tensor], root: int = 0,
               op: Op = Op.SUM) -> List[torch.Tensor]:
        """reference: comms_t::reduce — the reduction at the group's rank
        ``root``, zeros elsewhere (the JAX package's allreduce and mask)."""
        self._check(xs)
        self._count("reduce", xs[0])
        full = self._reduce(xs, op)
        return [f if self._pos[r] == root else torch.zeros_like(f)
                for r, f in enumerate(full)]

    def bcast(self, xs: Sequence[torch.Tensor], root: int = 0
              ) -> List[torch.Tensor]:
        """reference: comms_t::bcast — every rank gets the group's rank
        ``root``'s tensor."""
        self._check(xs)
        self._count("bcast", xs[0])
        return self._per_device(lambda g, dev: xs[g[root]].to(dev))

    def _gather(self, xs, axis: int, tiled: bool):
        join = torch.cat if tiled else torch.stack
        return self._per_device(
            lambda g, dev: join([xs[r].to(dev) for r in g], dim=axis))

    def allgather(self, xs: Sequence[torch.Tensor], axis: int = 0,
                  tiled: bool = False) -> List[torch.Tensor]:
        """reference: comms_t::allgather — every rank gets the group's
        tensors stacked at ``axis`` ([n, ...] by default), or concatenated
        along it with ``tiled``."""
        self._check(xs)
        self._count("allgather", xs[0])
        return self._gather(xs, axis, tiled)

    def gather(self, xs: Sequence[torch.Tensor], root: int = 0,
               axis: int = 0) -> List[torch.Tensor]:
        """reference: comms_t::gather — as in the JAX package every rank
        holds the stacked result (a rooted gather is no cheaper there)."""
        self._check(xs)
        self._count("gather", xs[0])
        return self._gather(xs, axis, False)

    def _allgatherv(self, xs, counts, compact: bool):
        n_valid = [int(c) for c in counts]
        for r, c in enumerate(n_valid):
            expects(0 <= c <= xs[r].shape[0], "rank %d's count %d is not "
                    "in [0, %d]", r, c, xs[r].shape[0])

        def gv(g, dev):
            cnt = torch.tensor([n_valid[r] for r in g], dtype=torch.int32,
                               device=dev)
            if not compact:
                return torch.cat([xs[r].to(dev) for r in g]), cnt
            # valid rows first in rank order, then every rank's pad rows
            # (the JAX package's stable argsort over the invalid flags)
            return torch.cat([xs[r][:n_valid[r]].to(dev) for r in g]
                             + [xs[r][n_valid[r]:].to(dev) for r in g]), cnt
        out = self._per_device(gv)
        return [o[0] for o in out], [o[1] for o in out]

    def allgatherv(self, xs: Sequence[torch.Tensor], counts: Sequence,
                   compact: bool = True
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Variable-length allgather (reference: comms_t::allgatherv,
        core/comms.hpp:423-444): each rank gives a padded ``[cap, ...]``
        tensor and its valid row count (an int or a 0-d tensor). Returns
        per rank ``gathered [size·cap, ...]`` with the group's valid rows
        first in rank order (``compact=False``: the raw concatenation) and
        ``counts [size]`` int32."""
        self._check(xs)
        self._check(counts)
        self._count("allgatherv", xs[0], counts[0])
        return self._allgatherv(xs, counts, compact)

    def gatherv(self, xs: Sequence[torch.Tensor], counts: Sequence,
                root: int = 0, compact: bool = True
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Variable-length gather (reference: comms_t::gatherv) — every
        rank holds the result, as :meth:`gather`."""
        self._check(xs)
        self._check(counts)
        self._count("gatherv", xs[0], counts[0])
        return self._allgatherv(xs, counts, compact)

    def reducescatter(self, xs: Sequence[torch.Tensor], op: Op = Op.SUM,
                      scatter_dimension: int = 0) -> List[torch.Tensor]:
        """reference: comms_t::reducescatter — the group's reduction, split
        along ``scatter_dimension`` into ``size`` blocks: the group's rank
        j gets block j."""
        self._check(xs)
        self._count("reducescatter", xs[0])
        n = self.get_size()
        dim = xs[0].shape[scatter_dimension]
        expects(dim % n == 0, "reducescatter: dimension %d of size %d does "
                "not split over %d ranks", scatter_dimension, dim, n)
        full = self._reduce(xs, op)
        return [f.narrow(scatter_dimension, self._pos[r] * (dim // n),
                         dim // n) for r, f in enumerate(full)]

    def alltoall(self, xs: Sequence[torch.Tensor], split_axis: int = 0,
                 concat_axis: int = 0) -> List[torch.Tensor]:
        """reference: std_comms alltoall (``lax.all_to_all``, tiled): each
        rank's tensor splits into ``size`` blocks along ``split_axis``; the
        group's rank j receives block j of every member, concatenated
        along ``concat_axis`` in rank order."""
        self._check(xs)
        self._count("alltoall", xs[0])
        n = self.get_size()
        dim = xs[0].shape[split_axis]
        expects(dim % n == 0, "alltoall: dimension %d of size %d does not "
                "split over %d ranks", split_axis, dim, n)
        b = dim // n
        out = []
        for r in range(self.mesh.size):
            dev = self.mesh.devices[r]
            j = self._pos[r]
            out.append(torch.cat(
                [xs[s].narrow(split_axis, j * b, b).to(dev)
                 for s in self._group[r]], dim=concat_axis))
        return out

    def _permute(self, xs, perm) -> List[torch.Tensor]:
        src_of = {}
        for s, d in perm:
            expects(d not in src_of, "ppermute: destination %d twice", d)
            src_of[d] = s
        out = []
        for r in range(self.mesh.size):
            s = src_of.get(self._pos[r])
            out.append(torch.zeros_like(xs[r]) if s is None
                       else xs[self._group[r][s]].to(self.mesh.devices[r]))
        return out

    def ppermute(self, xs: Sequence[torch.Tensor],
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """Point-to-point transfer as a permutation of (source, destination)
        group positions (reference: device_send/device_recv pairs); a rank
        that is no destination gets zeros, as ``lax.ppermute`` gives."""
        self._check(xs)
        self._count("ppermute", xs[0])
        return self._permute(xs, perm)

    def send_recv_ring(self, xs: Sequence[torch.Tensor], shift: int = 1
                       ) -> List[torch.Tensor]:
        """Ring shift: the group's rank i gets rank i − ``shift``'s
        tensor."""
        self._check(xs)
        self._count("send_recv_ring", xs[0])
        n = self.get_size()
        return self._permute(xs, [(i, (i + shift) % n) for i in range(n)])

    def ring_topk_hop(self, vals: Sequence[torch.Tensor],
                      ids: Sequence[torch.Tensor], shift: int = 1
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """One hop of the ring top-k exchange: each block moves to the
        group's rank + ``shift``. Counted as one ``ring_topk`` op and one
        surviving-block payload."""
        self._check(vals)
        self._count("ring_topk", vals[0], ids[0])
        n = self.get_size()
        perm = [(i, (i + shift) % n) for i in range(n)]
        return self._permute(vals, perm), self._permute(ids, perm)

    def count_ring_topk(self, n_hops: int, *blocks) -> None:
        """Count the ring kernel's exchange: ``n_hops`` ops and payloads of
        ``blocks`` ((shape, dtype) pairs) under ``ring_topk`` — the
        kernel reads its neighbour's block through a pointer and never
        passes through :meth:`ring_topk_hop`."""
        for _ in range(int(n_hops)):
            self._count("ring_topk", *blocks)

    def sync_stream(self) -> Status:
        """reference: comms_t::sync_stream (core/comms.hpp:283-290): waits
        for the current stream of each card the ranks use, so a failed
        launch surfaces here (it raises)."""
        for d in self.mesh.distinct_devices:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()
        return Status.SUCCESS


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """The JAX package starts jax's multi-host runtime here. One process
    drives every rank of a mesh in the port, so there is nothing to start
    until ranks span several hosts."""
    raise not_ported("initialize_distributed (a multi-host runtime: cards "
                     "on several hosts, fault C4)", "A15")
