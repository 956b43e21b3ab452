"""Cross-shard top-k merge tiers (counterpart of
``raft_tpu.parallel.merge``) — the one dispatch point behind the
sharded kNN and sharded IVF-PQ merges.

- **allgather**: every rank gathers the ``[n_dev, m, k]`` candidate
  tables and selects locally. The result is replicated.
- **ring**: reduce-scatter of top-k. The query axis splits into n_dev
  chunks; each chunk's partial top-k travels the ring for n_dev − 1 hops,
  merged against each rank's candidates on the way, and lands fully
  merged at its owner. The result is query-sharded: rank r holds chunk r,
  and callers assemble the chunks and cut the pad rows. ``ring_kernel``
  is the hand-written CUDA kernel (``ops.kernels.ring_topk_merge``);
  ``ring_ppermute`` is the same schedule, hop by hop, over
  ``Comms.ring_topk_hop`` and ``select_k`` (the plain schedule the JAX
  package runs off the TPU, and the port runs for int64 ids and off the
  card).

``RAFT_TPU_RING_TOPK`` (auto | on | off) picks the tier; an explicit
``merge=`` argument of a search overrides it. Every decision is counted
under ``parallel.merge.dispatch`` (``obs.spans``). The ``hier`` tier and
2-D exchanges are not ported yet (ROADMAP A15).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core.errors import expects, not_ported
from raft_tpu_torch.matrix.select_k import select_k as _select_k
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.parallel.mesh import Mesh

MERGE_TIERS = ("allgather", "ring", "hier")
REPLICATED = "replicated"
QUERY_SHARDED = "query_sharded"


def resolve_exchange(mesh: Mesh, axis: Union[str, Sequence[str]]
                     ) -> Tuple[int, bool, None]:
    """``(n_dev, whole_mesh, hier_axes)`` of a search's ``axis`` argument:
    one axis name, the mesh's own. A 2-tuple (the hier exchange) is not
    ported (A15)."""
    if not isinstance(axis, str):
        raise not_ported("2-D (outer, inner) exchanges", "A15")
    expects(axis == mesh.axis_name, "axis %r is not the mesh's axis %r",
            axis, mesh.axis_name)
    return mesh.size, True, None


def ring_auto_wanted(m: int, k: int, n_dev: int) -> bool:
    """Auto mode takes the ring only where its counted bytes are at most
    half the allgather's: (n_dev − 1) padded [mc, k] blocks against
    n_dev·[m, k]."""
    mc = _k.ring_chunk_rows(m, n_dev)
    return 2 * (n_dev - 1) * mc <= n_dev * m


def merge_tier(n_dev: int, m: int, k: int, explicit: Optional[str] = None,
               whole_mesh: bool = True, hier_axes=None, n_cards: int = 1
               ) -> Tuple[str, str]:
    """(tier, impl) for one sharded search call, impl ∈ {allgather,
    ring_kernel, ring_ppermute}. ``explicit`` ("auto" defers) overrides
    ``RAFT_TPU_RING_TOPK``; auto takes the ring where the kernel serves
    the shape on a card and the shape is bandwidth-bound enough to win
    (:func:`ring_auto_wanted`). ``n_cards`` is the cards the mesh's ranks
    span (``Mesh.n_cards``): the kernel serves ranks on one card only, so
    a ring over several cards takes ``ring_ppermute`` (ROADMAP A15)."""
    hier_force = _obs_spans.env_tristate("RAFT_TPU_HIER_MERGE")
    if explicit == "hier" or hier_axes is not None:
        raise not_ported("the hier merge tier", "A15")
    if hier_force == "on" and explicit in (None, "auto"):
        _obs_spans.count_fallback("parallel.merge", "no_hier_axes")
    force = _obs_spans.env_tristate("RAFT_TPU_RING_TOPK")
    kernel_ok = (_k._on_cuda() and whole_mesh and n_cards <= 1
                 and _k.ring_topk_kernel_ok(m, k, n_dev))
    if explicit is not None and explicit != "auto":
        expects(explicit in MERGE_TIERS,
                "unknown merge tier %r (supported: %s)", explicit,
                "/".join(MERGE_TIERS))
        tier = explicit
    elif force == "off":
        tier = "allgather"
    elif force == "on":
        tier = "ring"
    else:
        tier = ("ring" if kernel_ok and ring_auto_wanted(m, k, n_dev)
                else "allgather")
        if _k._on_cuda() and tier == "allgather" and n_dev > 1:
            _obs_spans.count_fallback(
                "parallel.merge",
                "latency_bound" if kernel_ok else "kernel_ineligible")
    impl = "allgather"
    if tier == "ring":
        impl = "ring_kernel" if kernel_ok else "ring_ppermute"
    _obs_spans.count_dispatch("parallel.merge", impl)
    return tier, impl


def merge_out_spec(tier: str) -> str:
    """How the merged result lies over the ranks: ``"replicated"`` (every
    rank holds [m, k]; the allgather tier) or ``"query_sharded"`` (rank r
    holds chunk r; the ring tier) — the JAX package's ``P()`` and
    ``P(axis)`` out-specs."""
    if tier == "hier":
        raise not_ported("the hier merge tier", "A15")
    return REPLICATED if tier == "allgather" else QUERY_SHARDED


def merged_rows(tier: str, m: int, n_dev: int) -> int:
    """Rows of the assembled merge result (the ring pads the query axis to
    n_dev chunks; pad rows sit at the end)."""
    if tier == "allgather":
        return m
    if tier == "hier":
        raise not_ported("the hier merge tier", "A15")
    return _k.ring_chunk_rows(m, n_dev) * n_dev


def assemble(out_spec: str, parts: Sequence[torch.Tensor], m: int,
             device: torch.device) -> torch.Tensor:
    """The global [m, ...] result on ``device`` from per-rank parts: rank
    0's copy when replicated, the chunks in rank order when query-sharded
    (the assembly ``shard_map`` does for its out-specs), cut to m rows."""
    if out_spec == REPLICATED:
        return parts[0].to(device)[:m]
    return torch.cat([p.to(device) for p in parts])[:m]


def _merge_allgather(vals, ids, comms: Comms, m: int, k: int, n_dev: int,
                     select_min: bool):
    """Gather every rank's table, select locally (the reference's
    knn_merge_parts.cuh)."""
    all_v = comms.allgather(vals)               # per rank [n_dev, m, k]
    all_i = comms.allgather(ids)
    out_v, out_i = [], []
    for av, ai in zip(all_v, all_i):
        flat_v = av.permute(1, 0, 2).reshape(m, n_dev * k)
        flat_i = ai.permute(1, 0, 2).reshape(m, n_dev * k)
        v, i = _select_k(flat_v, k, select_min=select_min,
                         input_indices=flat_i)
        out_v.append(v)
        out_i.append(i)
    return out_v, out_i


def _ring_merge_fallback(vals, ids, comms: Comms, m: int, k: int,
                         n_dev: int, select_min: bool):
    """The ring schedule hop by hop over ``Comms.ring_topk_hop`` and
    ``select_k``: rank i starts chunk (i − 1) mod n_dev and merges the
    incoming partial with its own block for chunk (i − s − 2) mod n_dev
    at hop s; after n_dev − 1 hops rank i owns chunk i. Ids keep their
    width (core.ids)."""
    mc = _k.ring_chunk_rows(m, n_dev)
    m_pad = mc * n_dev
    big = float("inf") if select_min else float("-inf")
    v3s, i3s = [], []
    for v, i in zip(vals, ids):
        v = v.float()
        i = i.to(_ids.id_dtype_like(i))
        if m_pad > m:
            v = torch.nn.functional.pad(v, (0, 0, 0, m_pad - m), value=big)
            i = torch.nn.functional.pad(i, (0, 0, 0, m_pad - m), value=-1)
        v = torch.where(i < 0, torch.full_like(v, big), v)
        v3s.append(v.view(n_dev, mc, k))
        i3s.append(i.view(n_dev, mc, k))
    ranks = comms.get_rank()
    run_v = [v3s[r][(r + n_dev - 1) % n_dev] for r in ranks]
    run_i = [i3s[r][(r + n_dev - 1) % n_dev] for r in ranks]
    for s in range(n_dev - 1):
        run_v, run_i = comms.ring_topk_hop(run_v, run_i)
        nv, ni = [], []
        for r in ranks:
            c = (r + 2 * n_dev - s - 2) % n_dev
            cat_v = torch.cat([run_v[r], v3s[r][c]], 1)
            cat_i = torch.cat([run_i[r], i3s[r][c]], 1)
            v, i = _select_k(cat_v, k, select_min=select_min,
                             input_indices=cat_i)
            nv.append(v)
            ni.append(i)
        run_v, run_i = nv, ni
    return run_v, run_i


def merge_topk(vals: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
               mesh: Mesh, m: int, k: int, n_dev: int, select_min: bool,
               tier: str = "allgather", impl: Optional[str] = None
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Cross-shard merge of per-rank [m, k] local top-k tables (global ids,
    −1 invalid, invalid keys at the select sentinel). The allgather tier
    returns every rank the [m, k] result; the ring tier rank r its chunk
    (pair with :func:`merge_out_spec` and :func:`assemble`). All traffic
    is counted by ``Comms``: the allgather the gathered table, the ring
    n_dev − 1 surviving-block hops under ``ring_topk``."""
    expects(tier in MERGE_TIERS, "unknown merge tier %r", tier)
    expects(all(tuple(v.shape) == (m, k) and tuple(i.shape) == (m, k)
                for v, i in zip(vals, ids)) and len(vals) == n_dev,
            "merge_topk expects %d per-rank [m, k] tables (m=%d k=%d)",
            n_dev, m, k)
    if tier == "hier":
        raise not_ported("the hier merge tier", "A15")
    comms = Comms(mesh)
    if tier == "allgather":
        return _merge_allgather(vals, ids, comms, m, k, n_dev, select_min)
    if impl == "ring_kernel" and any(i.dtype == torch.int64 for i in ids):
        # the kernel takes int32 ids; an int64 id table keeps its width on
        # the plain schedule instead of being narrowed
        _obs_spans.count_fallback("parallel.merge", "id_width")
        impl = "ring_ppermute"
    if impl == "ring_kernel":
        mc = _k.ring_chunk_rows(m, n_dev)
        comms.count_ring_topk(n_dev - 1, ((mc, k), torch.float32),
                              ((mc, k), torch.int32))
        return _k.ring_topk_merge(vals, ids, k, select_min)
    return _ring_merge_fallback(vals, ids, comms, m, k, n_dev, select_min)
