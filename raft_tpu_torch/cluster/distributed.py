"""Distributed k-means over a mesh of ranks — sample-sharded Lloyd
(counterpart of ``raft_tpu.cluster.distributed``: ``fit`` and
``predict``).

The reference's multi-node pattern: each rank assigns its shard with the
fused L2 argmin and sums its clusters locally, then ``allreduce`` merges
the sums, counts and inertia. Here the loop runs over the ranks of a
:class:`~raft_tpu_torch.parallel.mesh.Mesh` in one process, the assign on
the ``fused_l2_argmin`` kernel, the sums with ``index_add_``. The
chunked distributed builders' ``coarse="distributed"`` mode
(``parallel.build``) fits its centers here, with weights.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.cluster.kmeans import KMeansParams, init_random
from raft_tpu_torch.core.device import to_device
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.distance.fused_l2_nn import (
    fused_l2_nn_argmin_impl as fused_l2_nn_argmin)
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.parallel.merge import resolve_exchange
from raft_tpu_torch.parallel.mesh import (Mesh, per_shard, replicate,
                                          shard_rows)
from raft_tpu_torch.random.rng import RngState
from raft_tpu_torch.utils import precision as _precision


@traced("raft_tpu_torch.distributed_kmeans.fit")
def fit(params: KMeansParams, x, mesh: Mesh, axis: str = "shard",
        init_centroids=None, weights=None
        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Distributed Lloyd fit over a row-sharded dataset ``x [n, d]``.

    Rows shard over ``axis`` (one axis of a 2-D mesh: sharded over it,
    replicated over the other; the ranks that share a shard and a device
    share its sums) and are zero-padded to a multiple of its rank count
    with zero weights; zero-weight rows join no centroid and no inertia.
    Stops after ``params.max_iter`` iterations or when the squared
    centroid shift falls to ``params.tol²``. Without ``init_centroids`` the initial
    centroids are ``n_clusters`` distinct real rows drawn from
    ``params.seed`` (not the JAX package's draw: the generators differ).
    Returns (centroids [k, d], inertia, n_iter) on rank 0's device."""
    _precision.enforce()
    n_dev, _, _ = resolve_exchange(mesh, axis)
    comms = Comms(mesh, axis)
    dev0 = mesh.devices[0]
    xf = to_device(x, dev0, torch.float32)
    n = xf.shape[0]
    k = params.n_clusters
    w = None if weights is None else to_device(weights, dev0, torch.float32)
    if init_centroids is None:
        state = RngState(params.seed)
        if w is None:
            init_centroids = init_random(state, xf, k)
        else:
            # draw from real rows only: a zero-weight row as an init would
            # seed a dead centroid
            init_centroids = init_random(state, xf[w > 0], k)
    c0 = to_device(init_centroids, dev0, torch.float32)
    xs, _ = shard_rows(xf, mesh, axis)
    if w is None and xs[0].shape[0] * n_dev != n:
        w = torch.ones((n,), dtype=torch.float32, device=dev0)
    ws = (shard_rows(w, mesh, axis)[0] if w is not None
          else [None] * mesh.size)
    cs = replicate(c0, mesh)
    shift2 = float("inf")
    it = 0
    inertia = None
    while it < params.max_iter and shift2 > params.tol * params.tol:
        sums, counts, inert = map(list, zip(*per_shard(
            mesh, axis, lambda r, p: _local_sums(xs[r], ws[r], cs[r], k))))
        sums = comms.allreduce(sums)
        counts = comms.allreduce(counts)
        inertia = comms.allreduce(inert)
        new = {}
        for r, dev in enumerate(mesh.devices):
            if dev not in new:
                cnt = counts[r][:, None]
                new[dev] = torch.where(cnt > 0, sums[r] / cnt.clamp_min(1e-12),
                                       cs[r])
        new_cs = [new[d] for d in mesh.devices]
        shift2 = float(((new_cs[0] - cs[0]) ** 2).sum())
        cs = new_cs
        it += 1
    if inertia is None:
        inertia = [torch.tensor(float("inf"), device=dev0)]
    return cs[0], inertia[0], it


def _local_sums(x: torch.Tensor, w, c: torch.Tensor, k: int):
    """One shard's assignment (B4) and its per-cluster sums, counts and
    inertia (weighted when ``w`` is given)."""
    d2, lab = fused_l2_nn_argmin(x, c)
    lab = lab.long()
    s = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((k,), dtype=torch.float32, device=x.device)
    if w is None:
        s.index_add_(0, lab, x)
        cnt.index_add_(0, lab, torch.ones_like(d2))
        return s, cnt, d2.sum()
    s.index_add_(0, lab, x * w[:, None])
    cnt.index_add_(0, lab, w)
    return s, cnt, (w * d2).sum()


@traced("raft_tpu_torch.distributed_kmeans.predict")
def predict(centroids, x, mesh: Mesh, axis: str = "shard") -> torch.Tensor:
    """Nearest-centroid labels [n] int32 of a dataset row-sharded over
    ``axis``, on rank 0's device."""
    resolve_exchange(mesh, axis)
    dev0 = mesh.devices[0]
    xs, n = shard_rows(to_device(x, dev0, torch.float32), mesh, axis)
    cs = replicate(to_device(centroids, dev0, torch.float32), mesh)
    first = mesh.groups((axis,) if isinstance(axis, str) else axis)[0]
    labels = [fused_l2_nn_argmin(xs[r], cs[r])[1].to(dev0) for r in first]
    return torch.cat(labels)[:n]
