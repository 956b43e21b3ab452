"""Balanced (hierarchical) k-means — the trainer behind the IVF index
(counterpart of ``raft_tpu.cluster.kmeans_balanced``: ``fit``,
``predict``, ``predict_topk``, ``_balanced_lloyd``,
``_balanced_lloyd_batched``).

Same two-level design:

1. fit ~√k mesoclusters with Lloyd sweeps;
2. split each mesocluster's rows into fine clusters (count ∝ its size)
   with a batched Lloyd over padded, weight-masked row blocks;
3. finish with joint sweeps over all fine centers, re-seeding starved
   clusters each sweep (the reference's ``adjust_centers`` balancing).

Every assignment of levels 1 and 3 and of ``predict`` goes through the
fused L2 argmin kernel. The batched level-2 products are plain
``torch.bmm`` (they were XLA einsums in the JAX package), and the
re-seed candidates come from an exact ``torch.topk`` where the JAX
package used the TPU's ``lax.approx_max_k``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import _update_centroids, init_random
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.random.rng import RngState

# Bound on the level-2 [chunk, T, k] f32 distance block (bytes).
_LEVEL2_BLOCK_BYTES = 1 << 30
# Above this fraction of the trainset, level-2 sampling truncation warns.
_LEVEL2_DROP_WARN_FRAC = 0.02


@dataclasses.dataclass
class KMeansBalancedParams:
    """reference: ``kmeans_balanced_params``."""

    n_iters: int = 20
    metric: str = "l2"  # "l2" | "cosine"
    seed: int = 0
    mesocluster_factor: float = 1.0  # n_meso = factor * sqrt(k)


def _maybe_normalize(x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))
    return x


def _uniform(state: RngState, n: int, device) -> torch.Tensor:
    """U[1e-6, 1) draws, made on the CPU generator and moved."""
    u = torch.rand(n, generator=state.generator())
    return (1e-6 + (1.0 - 1e-6) * u).to(device)


def _balanced_lloyd(x: torch.Tensor, w: torch.Tensor, c0: torch.Tensor,
                    n_clusters: int, n_iters: int, state: RngState,
                    split_iters: int = 0) -> torch.Tensor:
    """Lloyd sweeps with per-sweep re-seeding of starved clusters. Sweeps
    ``i < split_iters`` re-seed at random far-ish rows inside the fattest
    clusters (balance); later sweeps at the globally farthest rows."""
    xf, wf = x.float(), w.float()
    total_w = wf.sum().clamp_min(1e-12)
    starve_thresh = 0.25 * total_w / n_clusters
    c = c0.float()
    for i in range(n_iters):
        d2, labels = fused_l2_nn_argmin(xf, c)
        new_c, counts = _update_centroids(xf, wf, labels, n_clusters, c)
        starved = counts < starve_thresh
        if i < split_iters:
            u = _uniform(state.fold(i), xf.shape[0], xf.device)
            score = counts[labels.long()] + u * d2 / (d2.max() + 1e-12)
        else:
            score = d2
        far_score = torch.where(wf > 0, score,
                                torch.full_like(score, float("-inf")))
        _, far_idx = torch.topk(far_score, n_clusters)
        starved_rank = torch.cumsum(starved.int(), 0) - 1
        take = far_idx[starved_rank.clamp(0, n_clusters - 1)]
        c = torch.where(starved[:, None], xf[take], new_c)
    return c


def _balanced_lloyd_batched(xs: torch.Tensor, ws: torch.Tensor,
                            c0s: torch.Tensor, kmask: torch.Tensor, k: int,
                            n_iters: int) -> torch.Tensor:
    """All mesoclusters' fine Lloyd fits as a batch dimension: row blocks
    ``xs [M, T, d]``, weights ``ws [M, T]`` (0 = pad), inits ``c0s [M, k,
    d]``, active-center masks ``kmask [M, k]`` (inactive slots are parked
    far away). Mesoclusters are independent, so they run in chunks that
    bound the [chunk, T, k] distance block."""
    M, T, d = xs.shape
    chunk = max(1, min(M, _LEVEL2_BLOCK_BYTES // max(1, T * k * 4)))
    out = []
    for a in range(0, M, chunk):
        out.append(_lloyd_batch(xs[a:a + chunk].float(),
                                ws[a:a + chunk].float(),
                                c0s[a:a + chunk].float(),
                                kmask[a:a + chunk].bool(), k, n_iters))
    return torch.cat(out, 0)


def _lloyd_batch(xf, wf, cs, km, k: int, n_iters: int):
    M, T, d = xf.shape
    k_active = km.sum(1).float().clamp_min(1.0)
    starve_thresh = 0.25 * wf.sum(1).clamp_min(1e-12) / k_active   # [M]
    x_sq = (xf * xf).sum(-1)                                       # [M, T]
    far = torch.full_like(cs, 1e15)
    base = (torch.arange(M, device=xf.device) * k)[:, None]
    xw = (xf * wf[..., None]).reshape(M * T, d)
    for _ in range(n_iters):
        cs = torch.where(km[..., None], cs, far)
        c_sq = (cs * cs).sum(-1)
        g = torch.bmm(xf, cs.transpose(1, 2))                      # [M, T, k]
        d2 = (x_sq[..., None] + c_sq[:, None, :] - 2.0 * g).clamp_min_(0.0)
        dmin, labels = d2.min(-1)
        del g, d2
        flat = (labels + base).reshape(-1)
        counts = torch.zeros(M * k, device=xf.device).index_add_(
            0, flat, wf.reshape(-1)).view(M, k)
        sums = torch.zeros((M * k, d), device=xf.device).index_add_(
            0, flat, xw).view(M, k, d)
        new_c = torch.where(counts[..., None] > 0,
                            sums / counts.clamp_min(1e-12)[..., None], cs)
        starved = (counts < starve_thresh[:, None]) & km
        far_score = torch.where(wf > 0, dmin,
                                torch.full_like(dmin, float("-inf")))
        _, far_idx = torch.topk(far_score, k, dim=1)
        rank = (torch.cumsum(starved.int(), 1) - 1).clamp(0, k - 1)
        take = torch.gather(far_idx, 1, rank)
        reseeded = torch.gather(xf, 1, take[..., None].expand(-1, -1, d))
        cs = torch.where(starved[..., None], reseeded, new_c)
    return cs


def fit(x: torch.Tensor, n_clusters: int,
        params: Optional[KMeansBalancedParams] = None) -> torch.Tensor:
    """Hierarchical balanced fit → centers [n_clusters, d]."""
    if params is None:
        params = KMeansBalancedParams()
    xn = _maybe_normalize(x.float(), params.metric)
    n, d = xn.shape
    dev = xn.device
    expects(n_clusters <= n, "n_clusters=%d > n_samples=%d", n_clusters, n)
    state = RngState(params.seed)
    w = torch.ones((n,), dtype=torch.float32, device=dev)

    n_meso = max(1, min(n_clusters,
                        int(params.mesocluster_factor * math.isqrt(n_clusters))))
    if n_meso <= 1 or n_clusters <= 8:
        c0 = init_random(state, xn, n_clusters)
        centers = _balanced_lloyd(xn, w, c0, n_clusters, params.n_iters,
                                  state)
        return _maybe_normalize(centers, params.metric)

    # level 1: mesoclusters
    meso_c0 = init_random(state, xn, n_meso)
    meso_centers = _balanced_lloyd(xn, w, meso_c0, n_meso, params.n_iters,
                                   state)
    _, meso_labels = fused_l2_nn_argmin(xn, meso_centers)
    sizes = torch.bincount(meso_labels.long(), minlength=n_meso).cpu().numpy()

    # fine cluster counts ∝ mesocluster size, summing exactly to n_clusters
    quota = sizes / max(sizes.sum(), 1) * n_clusters
    fine_k = np.maximum(1, np.floor(quota).astype(np.int64))
    while fine_k.sum() > n_clusters:
        fine_k[np.argmax(fine_k)] -= 1
    rem = n_clusters - fine_k.sum()
    if rem > 0:
        order = np.argsort(-(quota - np.floor(quota)))
        for j in order[:rem]:
            fine_k[j] += 1

    # level 2: per-mesocluster fine fits on padded, masked row blocks
    from raft_tpu_torch.neighbors import ivf_common as _ic

    avg_meso = max(1, -(-n // n_meso))
    L_meso = max(8, -(-2 * avg_meso // 8) * 8)
    (subs,), mids, _sd, n_drop, _addr = _ic.pack_lists(
        [xn], meso_labels, torch.arange(n, dtype=torch.int32, device=dev),
        n_lists=n_meso, L=L_meso, fill_values=[0.0])
    if n_drop / max(n, 1) > _LEVEL2_DROP_WARN_FRAC:
        warnings.warn(f"kmeans_balanced: level-2 sampling dropped {n_drop}/"
                      f"{n} training rows past the per-mesocluster cap "
                      f"{L_meso}", RuntimeWarning, stacklevel=2)
    masks = (mids >= 0).float()
    sizes_c = np.minimum(np.maximum(sizes, 1), L_meso)
    k_active = np.maximum(np.minimum(np.minimum(fine_k, sizes), L_meso), 1)
    k_pad = int(k_active.max())
    pos = np.minimum(np.arange(k_pad)[None, :] * (sizes_c[:, None] - 1)
                     // np.maximum(k_active[:, None] - 1, 1),
                     sizes_c[:, None] - 1)
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    c0s = torch.gather(subs, 1, pos_t[..., None].expand(-1, -1, d))
    kmask = torch.as_tensor(np.arange(k_pad)[None, :] < k_active[:, None],
                            device=dev)
    cms = _balanced_lloyd_batched(subs, masks, c0s, kmask, k_pad,
                                  params.n_iters)
    del subs
    fine = [cms[m, :int(k_active[m])] for m in range(n_meso) if sizes[m] > 0]
    centers = torch.cat(fine, 0)
    if centers.shape[0] < n_clusters:  # slots lost to empty mesoclusters
        extra = init_random(state.fold(999), xn, n_clusters - centers.shape[0])
        centers = torch.cat([centers, extra], 0)

    # final joint sweeps: fat-splitting sweeps, then two quality sweeps
    sweeps = max(2, params.n_iters // 4)
    centers = _balanced_lloyd(xn, w, centers, n_clusters, sweeps + 2, state,
                              split_iters=sweeps)
    return _maybe_normalize(centers, params.metric)


def predict(centers: torch.Tensor, x: torch.Tensor,
            params: Optional[KMeansBalancedParams] = None) -> torch.Tensor:
    """Nearest balanced-center labels [m] int32."""
    metric = params.metric if params is not None else "l2"
    xn = _maybe_normalize(x.float(), metric)
    _, labels = fused_l2_nn_argmin(xn, centers)
    return labels


def _topk_labels(centers: torch.Tensor, xn: torch.Tensor, row_tile: int,
                 k: int) -> torch.Tensor:
    """The ``k`` nearest centers per row, a ``[row_tile, n_lists]`` Gram at
    a time; ‖c‖² − 2⟨x, c⟩ ranks as the distance does (‖x‖² is constant
    per row). Ties go to the lowest center index, as ``lax.top_k``'s."""
    c_sq = (centers * centers).sum(1)
    out = []
    for a in range(0, xn.shape[0], row_tile):
        d2 = c_sq[None, :] - 2.0 * (xn[a:a + row_tile] @ centers.T)
        out.append(select_k(d2, k)[1])
    return torch.cat(out)


def predict_topk(centers: torch.Tensor, x: torch.Tensor, k: int = 2,
                 params: Optional[KMeansBalancedParams] = None
                 ) -> torch.Tensor:
    """``k`` nearest centers per row → [m, k] int32 (feeds
    ``ivf_common.spill_assignments``); row-tiled so the [tile, n_lists]
    block stays near 256 MB, with the JAX package's tile rule."""
    metric = params.metric if params is not None else "l2"
    xn = _maybe_normalize(x.float(), metric)
    k = min(k, centers.shape[0])
    tile = max(1024, min(x.shape[0], (256 << 20)
                         // max(4 * centers.shape[0], 1)))
    return _topk_labels(centers, xn, -(-tile // 8) * 8, k)
