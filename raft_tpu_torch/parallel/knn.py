"""Sharded and replicated exact kNN over a mesh of ranks (counterpart of
``raft_tpu.parallel.knn``).

``sharded_knn`` is the reference's sharded-index pattern: each rank runs
the tiled brute force over its shard, remaps its ids to global ids, and
the per-shard candidates merge through ``parallel.merge`` (allgather or
the ring). ``replicated_knn`` is the replicated-index pattern: every rank
holds the whole dataset and answers its slice of the queries.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core.device import to_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.distance.types import SELECT_MIN, resolve_metric
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.parallel import merge as _merge
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.parallel.mesh import Mesh, replicate, shard_rows


def sharded_knn(dataset, queries, k: int, mesh: Mesh,
                axis: Union[str, Sequence[str]] = "shard",
                metric="sqeuclidean", merge: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over a dataset row-sharded across the mesh: per rank a
    tiled brute force and a local top-k, then the cross-shard merge
    (``merge`` = auto | allgather | ring). Returns (distances [m, k],
    global ids [m, k]) on rank 0's device."""
    mt = resolve_metric(metric)
    select_min = SELECT_MIN[mt]
    n_dev, whole_mesh, hier_axes = _merge.resolve_exchange(mesh, axis)
    dev0 = mesh.devices[0]
    x = to_device(dataset, dev0, torch.float32)
    q = to_device(queries, dev0, torch.float32)
    shards, n = shard_rows(x, mesh)
    shard_size = shards[0].shape[0]
    m = q.shape[0]
    expects(k <= shard_size, "k=%d exceeds shard size %d", k, shard_size)
    pad_val = float("inf") if select_min else float("-inf")
    comms = Comms(mesh)
    tier, impl = _merge.merge_tier(n_dev, m, k, explicit=merge,
                                   whole_mesh=whole_mesh, hier_axes=hier_axes,
                                   n_cards=mesh.n_cards)
    qs = replicate(q, mesh)
    vals, gids = [], []
    for r in comms.get_rank():
        v, i = brute_force.knn(shards[r], qs[r], k, metric=mt.value,
                               device=mesh.devices[r])
        # the global-id remap in the policy dtype of the padded row count:
        # rank·shard_size overflows int32 past 2³¹ rows, and pad-row ids
        # reach n_dev·shard_size − 1 ≥ n
        g = _ids.global_ids(r, shard_size, i, n_total=n_dev * shard_size)
        vals.append(torch.where(g < n, v, torch.full_like(v, pad_val)))
        gids.append(torch.where(g < n, g, torch.full_like(g, -1)))
    rv, ri = _merge.merge_topk(vals, gids, mesh, m, k, n_dev, select_min,
                               tier=tier, impl=impl)
    spec = _merge.merge_out_spec(tier)
    return (_merge.assemble(spec, rv, m, dev0),
            _merge.assemble(spec, ri, m, dev0))


def replicated_knn(dataset, queries, k: int, mesh: Mesh,
                   axis: str = "shard", metric="sqeuclidean"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the dataset replicated and the queries row-sharded
    over the mesh. Returns (distances, ids) [m, k] on rank 0's device."""
    mt = resolve_metric(metric)
    _merge.resolve_exchange(mesh, axis)
    dev0 = mesh.devices[0]
    x = to_device(dataset, dev0, torch.float32)
    q_shards, m = shard_rows(to_device(queries, dev0, torch.float32), mesh)
    xs = replicate(x, mesh)
    outs = [brute_force.knn(xs[r], q_shards[r], k, metric=mt.value,
                            device=mesh.devices[r])
            for r in range(mesh.size)]
    return (torch.cat([o[0].to(dev0) for o in outs])[:m],
            torch.cat([o[1].to(dev0) for o in outs])[:m])
