"""Cross-shard top-k merge tiers (counterpart of
``raft_tpu.parallel.merge``) — the one dispatch point behind the
sharded kNN and the sharded IVF merges.

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
- **hier**: the two-level merge of a 2-D ``(outer, inner)`` mesh
  (``mesh.hier_mesh``). The ring tier runs per pod over the inner axis —
  the ring kernel handed the pod's ranks where
  ``kernels.ring_topk_inner_ok`` admits the shape, else the plain
  schedule — leaving each rank its pod's merged ``[mc, k]`` block; then
  one ``alltoall`` over the outer axis hands each rank every pod's k
  survivors for its ``mc / n_outer`` owned rows, and a ``select_k`` of
  ``n_outer·k`` finishes them. The result is sharded over (inner, outer):
  rank (d, i) holds sub-chunk d of inner chunk i.

A search over ONE axis of a 2-D mesh (``axis="ici"``) exchanges within
each group of ranks along it (data sharded over it, replicated over the
other axis): it is not the whole mesh, so the ring takes ``ring_ppermute``
(B7 addresses every rank), and :func:`assemble` returns the first group's
answer (every group's is the same).

``RAFT_TPU_RING_TOPK`` (auto | on | off) picks the flat tier;
``RAFT_TPU_HIER_MERGE`` (auto | on | off) gates the hier tier, taken under
auto whenever the exchange is 2-D with a DCN-labeled outer axis; an
explicit ``merge=`` argument of a search overrides both. Every decision
is counted under ``parallel.merge.dispatch`` (``obs.spans``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.matrix.select_k import select_k_impl as _select_k
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.ops import kernels as _k
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.parallel.mesh import Mesh, is_dcn_axis

MERGE_TIERS = ("allgather", "ring", "hier")
REPLICATED = "replicated"
QUERY_SHARDED = "query_sharded"

# (outer_axis, inner_axis, n_outer, n_inner): the hier tier's topology,
# built from a mesh and a 2-tuple ``axis``. None = 1-D exchange.
HierAxes = Tuple[str, str, int, int]


def resolve_exchange(mesh: Mesh, axis: Union[str, Sequence[str]]
                     ) -> Tuple[int, bool, Optional[HierAxes]]:
    """``(n_dev, whole_mesh, hier_axes)`` of a search's ``axis`` argument:
    one axis name of the mesh, or a 2-D mesh's ``(outer, inner)`` axes in
    its order. One axis of a 2-D mesh exchanges over that axis alone
    (``n_dev = mesh.shape[axis]``, the JAX package's ``merge.py:81-83``):
    data shard over it and replicate over the other axis, and it is not
    the whole mesh, so the ring takes ``ring_ppermute``. A 2-tuple never
    counts as the whole mesh (the JAX package's flat ring kernel addresses
    one named axis), and carries the hier topology when its outer axis is
    DCN-labeled."""
    if isinstance(axis, str):
        expects(axis in mesh.axis_names,
                "axis %r is not an axis of the mesh %s", axis,
                mesh.axis_names)
        n_dev = mesh.axis_sizes[axis]
        return n_dev, n_dev == mesh.size, None
    names = tuple(axis)
    expects(len(names) == 2,
            "axis must be one mesh axis name or a 2-tuple "
            "(outer, inner), got %r", axis)
    expects(names == tuple(mesh.axis_names),
            "axis %r must be the 2-D mesh's axes in its order %r", names,
            mesh.axis_names)
    outer, inner = names
    n_outer, n_inner = mesh.shape
    hier = (outer, inner, n_outer, n_inner) if is_dcn_axis(outer) else None
    return n_outer * n_inner, False, hier


def ring_auto_wanted(m: int, k: int, n_dev: int) -> bool:
    """Auto mode takes the ring only where its counted bytes are at most
    half the allgather's: (n_dev − 1) padded [mc, k] blocks against
    n_dev·[m, k]."""
    mc = _k.ring_chunk_rows(m, n_dev)
    return 2 * (n_dev - 1) * mc <= n_dev * m


def hier_chunk_rows(m: int, n_inner: int, n_outer: int) -> int:
    """Query rows per rank of the hier tier's per-pod ring: the flat
    ring's chunk for ``n_inner`` ranks, padded up so the outer survivor
    exchange splits it into ``n_outer`` even sub-chunks."""
    mc = _k.ring_chunk_rows(m, n_inner)
    return -(-mc // n_outer) * n_outer


def merge_tier(n_dev: int, m: int, k: int, explicit: Optional[str] = None,
               whole_mesh: bool = True, hier_axes: Optional[HierAxes] = None,
               n_cards: int = 1) -> Tuple[str, str]:
    """(tier, impl) for one sharded search call, impl ∈ {allgather,
    ring_kernel, ring_ppermute, hier}. ``explicit`` ("auto" defers)
    overrides ``RAFT_TPU_RING_TOPK``; auto takes the ring where the kernel
    serves the shape on a card and the shape is bandwidth-bound enough to
    win (:func:`ring_auto_wanted`). ``hier_axes`` (a 2-D exchange with a
    DCN-labeled outer axis) enables the hier tier: taken on
    ``merge="hier"`` or, under auto, unless ``RAFT_TPU_HIER_MERGE=off``.
    ``n_cards`` is the cards the mesh's ranks span (``Mesh.n_cards``): the
    kernel serves ranks on one card only, so a ring over several cards
    takes ``ring_ppermute`` (ROADMAP A15)."""
    hier_force = _obs_spans.env_tristate("RAFT_TPU_HIER_MERGE")
    if explicit == "hier":
        expects(hier_axes is not None,
                "merge='hier' needs a 2-D (outer, inner) exchange: call "
                "the search with axis=(dcn_axis, ici_axis) over a "
                "hier_mesh-shaped mesh (DCN-labeled outer axis)")
    if hier_axes is not None and (
            explicit == "hier"
            or (explicit in (None, "auto") and hier_force != "off")):
        _obs_spans.count_dispatch("parallel.merge", "hier")
        return "hier", "hier"
    if hier_axes is None and hier_force == "on" \
            and explicit in (None, "auto"):
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


def merge_out_spec(tier: str, axis: Union[str, Sequence[str], None] = None
                   ) -> Union[str, Tuple[str, str]]:
    """How the merged result lies over the ranks: ``"replicated"`` (every
    rank holds [m, k]; the allgather tier), ``"query_sharded"`` (rank r
    holds chunk r; the ring tier), or for the hier tier the axes it is
    sharded over, ``(inner, outer)`` (rank (d, i) holds sub-chunk d of
    inner chunk i) — the JAX package's ``P()``, ``P(axis)`` and
    ``P((inner, outer))`` out-specs. The ring over one named axis returns
    ``(axis,)``: its chunks lie in the order of the ranks' positions on
    that axis, and on a 2-D mesh every group along the other axis holds
    them."""
    if tier == "hier":
        expects(axis is not None and not isinstance(axis, str)
                and len(tuple(axis)) == 2,
                "the hier out-spec needs axis=(outer, inner), got %r", axis)
        outer, inner = axis
        return (inner, outer)
    if tier == "ring" and isinstance(axis, str):
        return (axis,)
    return REPLICATED if tier == "allgather" else QUERY_SHARDED


def merged_rows(tier: str, m: int, n_dev: int, n_outer: int = 1) -> int:
    """Rows of the assembled merge result (the ring pads the query axis to
    n_dev chunks; pad rows sit at the end). For the hier tier ``n_dev`` is
    the inner axis size and ``n_outer`` the pod count."""
    if tier == "allgather":
        return m
    if tier == "hier":
        return hier_chunk_rows(m, n_dev, n_outer) * n_dev
    return _k.ring_chunk_rows(m, n_dev) * n_dev


def assemble(out_spec, parts: Sequence[torch.Tensor], m: int,
             device: torch.device, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """The global [m, ...] result on ``device`` from per-rank parts: rank
    0's copy when replicated, the chunks in rank order when query-sharded,
    and under an axes out-spec (the hier tier's) the parts in the order of
    the ranks' coordinates on those axes (``mesh`` needed) — the assembly
    ``shard_map`` does for its out-specs — cut to m rows. Where the axes
    leave other axes out (one axis of a 2-D mesh), every group along them
    holds the same answer: the first group's is returned."""
    if out_spec == REPLICATED:
        return parts[0].to(device)[:m]
    if out_spec == QUERY_SHARDED:
        return torch.cat([p.to(device) for p in parts])[:m]
    expects(mesh is not None, "assembling a %r out-spec needs the mesh",
            out_spec)
    order = mesh.groups(out_spec)[0]
    return torch.cat([parts[r].to(device) for r in order])[:m]


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
                         n_dev: int, select_min: bool,
                         mc: Optional[int] = None):
    """The ring schedule hop by hop over ``Comms.ring_topk_hop`` and
    ``select_k``, within each of the communicator's groups: the rank at
    position i starts chunk (i − 1) mod n_dev and merges the incoming
    partial with its own block for chunk (i − s − 2) mod n_dev at hop s;
    after n_dev − 1 hops it owns chunk i. ``mc`` overrides the chunk rows
    (the hier tier's outer-divisible pad). Ids keep their width
    (core.ids)."""
    if mc is None:
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
    pos = comms.get_rank()
    ranks = range(len(pos))
    run_v = [v3s[r][(pos[r] + n_dev - 1) % n_dev] for r in ranks]
    run_i = [i3s[r][(pos[r] + n_dev - 1) % n_dev] for r in ranks]
    for s in range(n_dev - 1):
        run_v, run_i = comms.ring_topk_hop(run_v, run_i)
        nv, ni = [], []
        for r in ranks:
            c = (pos[r] + 2 * n_dev - s - 2) % n_dev
            cat_v = torch.cat([run_v[r], v3s[r][c]], 1)
            cat_i = torch.cat([run_i[r], i3s[r][c]], 1)
            v, i = _select_k(cat_v, k, select_min=select_min,
                             input_indices=cat_i)
            nv.append(v)
            ni.append(i)
        run_v, run_i = nv, ni
    return run_v, run_i


def _merge_hier(vals, ids, mesh: Mesh, outer: str, inner: str, m: int,
                k: int, select_min: bool):
    """Two-level merge: the ring per pod over ``inner``, then ONE
    survivor ``alltoall`` over ``outer``.

    Inner stage: the ring kernel handed each pod's ranks where
    ``ring_topk_inner_ok`` admits the shape and the pod chunk needs no
    extra pad (int32 ids, one card), else the plain schedule over the
    inner communicator, leaving each rank its pod's merged ``[mc, k]``
    block, ``mc`` divisible by ``n_outer``. Outer stage: rank (e, i)'s
    sub-chunk f goes to rank (f, i); each rank then holds every pod's k
    survivors for its ``mc / n_outer`` owned rows and selects k of
    ``n_outer·k``. Each stage counts on its own axis (``comms.bytes``
    ``axis=inner`` for the ring, ``axis=outer, op=alltoall`` for the
    survivors: ``mc·k`` entries a rank)."""
    inner_c = Comms(mesh, inner)
    outer_c = Comms(mesh, outer)
    n_inner = inner_c.get_size()
    n_outer = outer_c.get_size()
    mc = hier_chunk_rows(m, n_inner, n_outer)
    kernel_ok = (_k._on_cuda() and mesh.n_cards <= 1
                 and _k.ring_topk_inner_ok(m, k, n_inner)
                 and mc == _k.ring_chunk_rows(m, n_inner))
    if kernel_ok and any(i.dtype == torch.int64 for i in ids):
        # the kernel takes int32 ids: an int64 table keeps its width on
        # the plain schedule, as in the flat tier
        _obs_spans.count_fallback("parallel.merge", "id_width")
        kernel_ok = False
    if kernel_ok:
        inner_c.count_ring_topk(n_inner - 1, ((mc, k), torch.float32),
                                ((mc, k), torch.int32))
        pv, pi = [None] * mesh.size, [None] * mesh.size
        for pod in mesh.groups((inner,)):
            kv, ki = _k.ring_topk_merge([vals[r] for r in pod],
                                        [ids[r] for r in pod], k, select_min)
            for j, r in enumerate(pod):
                pv[r], pi[r] = kv[j], ki[j]
    else:
        pv, pi = _ring_merge_fallback(vals, ids, inner_c, m, k, n_inner,
                                      select_min, mc=mc)
    mc_d = mc // n_outer
    ex_v = outer_c.alltoall(pv)
    ex_i = outer_c.alltoall(pi)
    out_v, out_i = [], []
    for v, i in zip(ex_v, ex_i):
        flat_v = v.view(n_outer, mc_d, k).permute(1, 0, 2).reshape(
            mc_d, n_outer * k)
        flat_i = i.view(n_outer, mc_d, k).permute(1, 0, 2).reshape(
            mc_d, n_outer * k)
        sv, si = _select_k(flat_v, k, select_min=select_min,
                           input_indices=flat_i)
        out_v.append(sv)
        out_i.append(si)
    return out_v, out_i


def merge_topk(vals: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
               mesh: Mesh, m: int, k: int, n_dev: int, select_min: bool,
               tier: str = "allgather", impl: Optional[str] = None,
               axis: Union[str, Sequence[str], None] = None
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Cross-shard merge of per-rank [m, k] local top-k tables (global ids,
    −1 invalid, invalid keys at the select sentinel; one table per rank of
    the mesh, ``n_dev`` the exchange's rank count). The allgather tier
    returns every rank the [m, k] result; the ring tier rank r its chunk;
    the hier tier (``axis=(outer, inner)``) each rank its (inner chunk,
    outer sub-chunk) block (pair with :func:`merge_out_spec` and
    :func:`assemble`). ``axis=None`` takes the mesh's own axes. All
    traffic is counted by ``Comms``: the allgather the gathered table,
    the ring n_dev − 1 surviving-block hops under ``ring_topk``, the hier
    tier its per-pod ring on the inner axis and one survivor alltoall on
    the outer."""
    expects(tier in MERGE_TIERS, "unknown merge tier %r", tier)
    if axis is None:
        axis = mesh.axis_name if mesh.ndim == 1 else tuple(mesh.axis_names)
    expects(all(tuple(v.shape) == (m, k) and tuple(i.shape) == (m, k)
                for v, i in zip(vals, ids)) and len(vals) == mesh.size
            and n_dev == (mesh.axis_sizes[axis] if isinstance(axis, str)
                          else mesh.size),
            "merge_topk expects one [m, k] table a rank (m=%d k=%d) over "
            "%d ranks of the exchange", m, k, n_dev)
    if tier == "hier":
        expects(not isinstance(axis, str) and len(tuple(axis)) == 2,
                "hier merge needs axis=(outer, inner), got %r", axis)
        outer, inner = axis
        return _merge_hier(vals, ids, mesh, outer, inner, m, k, select_min)
    comms = Comms(mesh, axis)
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
