"""Communicator over a :class:`~raft_tpu_torch.parallel.mesh.Mesh`
(counterpart of ``raft_tpu.parallel.comms``).

The JAX package's ``Comms`` wraps ``lax`` collectives that run inside
``shard_map``. Here a collective takes a list of per-rank tensors (one
per rank, each on its rank's device) and returns a list: ``allreduce``
sums (or takes the min or max) on each distinct device and hands every
rank the result on its own device; ``allgather`` stacks every rank's
tensor; ``ring_topk_hop`` moves each rank's block to rank + 1.

**Counters** follow the JAX package's byte model (``comms.py:23-45``):
each collective counts one op and its per-rank payload bytes under
``(op, axis)``; the gather family counts ``axis_size × payload``, the
table every rank assembles; the ring exchange counts one op and one
``[mc, k]`` surviving block per hop, whether the hop is
:meth:`Comms.ring_topk_hop` or the ring kernel's pointer reads
(:meth:`Comms.count_ring_topk`). The counts are a model of what a mesh
of separate devices would move over its links, not a measurement: ranks
that share a card move nothing. :func:`counters` reads them and
:func:`reset_counters` clears them.

The other verbs of the JAX facade (bcast, reduce, reducescatter,
alltoall, ppermute, the variable-length gathers) are not ported yet
(ROADMAP A15).
"""

from __future__ import annotations

import enum
import math
from typing import Dict, List, Sequence, Tuple

import torch

from raft_tpu_torch.core.errors import expects, not_ported
from raft_tpu_torch.parallel.mesh import Mesh


class Op(enum.Enum):
    """Reduction op (reference: core/comms.hpp:36 ``op_t``)."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


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
    """Bytes of one rank's payload: tensors, or (shape, dtype) pairs."""
    total = 0
    for b in blocks:
        if isinstance(b, torch.Tensor):
            total += b.numel() * b.element_size()
        else:
            shape, dtype = b
            total += int(math.prod(shape)) * torch.empty(
                (), dtype=dtype).element_size()
    return total


class Comms:
    """Collectives over the ranks of a 1-D mesh (reference: ``comms_t``,
    core/comms.hpp:242)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.axis_name = mesh.axis_name

    def get_size(self) -> int:
        return self.mesh.size

    def get_rank(self) -> List[int]:
        """Each rank's index: the per-rank value of ``lax.axis_index``."""
        return list(range(self.mesh.size))

    def _count(self, op_name: str, *blocks) -> None:
        nbytes = _payload_bytes(*blocks)
        if op_name in _GATHER_FAMILY:
            nbytes *= self.mesh.size
        key = (op_name, self.axis_name)
        _OPS[key] = _OPS.get(key, 0) + 1
        _BYTES[key] = _BYTES.get(key, 0) + nbytes

    def _check(self, xs: Sequence[torch.Tensor]) -> None:
        expects(len(xs) == self.mesh.size, "%d per-rank tensors for %d ranks",
                len(xs), self.mesh.size)

    def allreduce(self, xs: Sequence[torch.Tensor], op: Op = Op.SUM
                  ) -> List[torch.Tensor]:
        """reference: comms_t::allreduce (core/comms.hpp:344). The ranks'
        tensors are reduced in rank order on each distinct device."""
        self._check(xs)
        if op == Op.PROD:
            raise not_ported("allreduce with Op.PROD", "A15")
        self._count("allreduce", xs[0])
        out = {}
        for dev in self.mesh.distinct_devices:
            acc = xs[0].to(dev)
            for x in xs[1:]:
                x = x.to(dev)
                if op == Op.SUM:
                    acc = acc + x
                elif op == Op.MIN:
                    acc = torch.minimum(acc, x)
                else:
                    acc = torch.maximum(acc, x)
            out[dev] = acc
        return [out[d] for d in self.mesh.devices]

    def allgather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """reference: comms_t::allgather — every rank gets the
        ``[n_dev, ...]`` stack of all ranks' tensors."""
        self._check(xs)
        self._count("allgather", xs[0])
        out = {dev: torch.stack([x.to(dev) for x in xs])
               for dev in self.mesh.distinct_devices}
        return [out[d] for d in self.mesh.devices]

    def ring_topk_hop(self, vals: Sequence[torch.Tensor],
                      ids: Sequence[torch.Tensor], shift: int = 1
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """One hop of the ring top-k exchange: rank r's block moves to
        rank r + ``shift``. Counted as one ``ring_topk`` op and one
        surviving-block payload."""
        self._check(vals)
        self._count("ring_topk", vals[0], ids[0])
        n = self.mesh.size
        src = [(r - shift) % n for r in range(n)]
        return ([vals[s].to(self.mesh.devices[r]) for r, s in enumerate(src)],
                [ids[s].to(self.mesh.devices[r]) for r, s in enumerate(src)])

    def count_ring_topk(self, n_hops: int, *blocks) -> None:
        """Count the ring kernel's exchange: ``n_hops`` ops and payloads of
        ``blocks`` ((shape, dtype) pairs) under ``ring_topk`` — the
        kernel reads its neighbour's block through a pointer and never
        passes through :meth:`ring_topk_hop`."""
        for _ in range(int(n_hops)):
            self._count("ring_topk", *blocks)

    def _not_ported(self, verb: str):
        raise not_ported(f"Comms.{verb}", "A15")

    def bcast(self, *a, **k):
        self._not_ported("bcast")

    def reduce(self, *a, **k):
        self._not_ported("reduce")

    def gather(self, *a, **k):
        self._not_ported("gather")

    def allgatherv(self, *a, **k):
        self._not_ported("allgatherv")

    def gatherv(self, *a, **k):
        self._not_ported("gatherv")

    def reducescatter(self, *a, **k):
        self._not_ported("reducescatter")

    def alltoall(self, *a, **k):
        self._not_ported("alltoall")

    def ppermute(self, *a, **k):
        self._not_ported("ppermute")

    def send_recv_ring(self, *a, **k):
        self._not_ported("send_recv_ring")
