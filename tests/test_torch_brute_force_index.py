"""Brute force's index API (``BruteForceIndex``, ``build``, ``knn(index,
…)``, ``knn_arrays``) and ``select_k.merge_parts``: the port against the
JAX package, on the CPU.

The same seeded numpy rows (n 3,000, d 8; probability rows for the
divergences, points on the sphere for haversine) go through
``raft_tpu.neighbors.brute_force`` and the port with ``device="cpu"``.

Tolerances: ``build``'s cached norms rtol 1e-6; ids equal away from f32
ties, distances rtol = atol = 1e-4 (``tests/test_brute_force.py``'s);
``knn`` with ``impl="auto"`` and ``"sort"`` and ``knn_arrays`` equal bit
for bit in the port (both impls take the exact per-tile select);
``merge_parts`` exact (values and ids).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.matrix.select_k import merge_parts as jmerge_parts
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.matrix.select_k import merge_parts as tmerge_parts
from raft_tpu_torch.neighbors import brute_force as tbf

from torch_parity import assert_ids_match_away_from_ties

N, M, D, K = 3000, 20, 8, 10
METRICS = ["sqeuclidean", "euclidean", "cosine", "inner_product",
           "l2_unexpanded", "l1", "linf", "canberra", "lp", "correlation",
           "braycurtis", "hellinger", "jensenshannon", "kl_divergence",
           "hamming", "jaccard", "dice", "russelrao", "haversine"]
_PROB = {"hellinger", "jensenshannon", "kl_divergence", "jaccard", "dice",
         "russelrao", "hamming"}


def _rows(metric, seed):
    rng = np.random.default_rng(seed)
    if metric == "haversine":
        scale = np.array([np.pi, 2 * np.pi], np.float32)
        return ((rng.random((N, 2), dtype=np.float32) - 0.5) * scale,
                (rng.random((M, 2), dtype=np.float32) - 0.5) * scale)
    if metric in _PROB:
        x = rng.random((N + M, D), dtype=np.float32) + 0.05
        if metric in ("jaccard", "dice", "russelrao", "hamming"):
            x = (x > 0.5).astype(np.float32)
        else:
            x /= x.sum(1, keepdims=True)
        return x[:N], x[N:]
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((M, D)).astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
def test_index_knn_matches_jax(metric):
    x, q = _rows(metric, seed=len(metric))
    jidx = jbf.build(jnp.asarray(x), metric=metric, metric_arg=3.0)
    tidx = tbf.build(x, metric=metric, metric_arg=3.0, device="cpu")
    assert tidx.size == N and tidx.dim == x.shape[1]
    assert tidx.metric.value == jidx.metric.value
    assert (tidx.norms is None) == (jidx.norms is None)
    if tidx.norms is not None:
        np.testing.assert_allclose(tidx.norms.numpy(), np.asarray(jidx.norms),
                                   rtol=1e-6)
    jv, ji = jbf.knn(jidx, jnp.asarray(q), K, impl="sort")
    runs = {impl: tbf.knn(tidx, q, K, impl=impl) for impl in ("auto", "sort")}
    runs["arrays"] = tbf.knn_arrays(x, q, K, metric=metric, metric_arg=3.0,
                                    device="cpu")
    tv, ti = runs["sort"]
    for other in ("auto", "arrays"):
        assert torch.equal(runs[other][0], tv)
        assert torch.equal(runs[other][1], ti)
    assert ti.dtype == torch.int32
    assert_ids_match_away_from_ties(ti.numpy(), tv.numpy(), np.asarray(ji),
                                    np.asarray(jv), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)


def test_index_knn_auto_matches_jax_auto():
    """The JAX package's "auto" bin cut is exact but at bin collisions;
    over 3 tiles of 16,384 rows it agrees with the port's exact select."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40_000, 8)).astype(np.float32)
    q = rng.standard_normal((600, 8)).astype(np.float32)
    jv, ji = jbf.knn(jbf.build(jnp.asarray(x)), jnp.asarray(q), K)
    tv, ti = tbf.knn(tbf.build(x, device="cpu"), q, K)
    assert_ids_match_away_from_ties(ti.numpy(), tv.numpy(), np.asarray(ji),
                                    np.asarray(jv), rtol=1e-4, atol=1e-4)


def test_index_validates_and_carries_its_device():
    x, q = _rows("sqeuclidean", 1)
    idx = tbf.build(x, device="cpu")
    assert idx.device == torch.device("cpu")
    assert idx.metric == DistanceType.L2SqrtExpanded   # "euclidean"
    with pytest.raises(LogicError, match="impl"):
        tbf.knn(idx, q, K, impl="bins")
    with pytest.raises(LogicError, match="query dim"):
        tbf.knn(idx, q[:, :4], K)
    with pytest.raises(LogicError, match="index size"):
        tbf.knn(tbf.build(x[:5], device="cpu"), q, K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbf.build(x)                      # the default device is the card


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("n_parts,k_part,k", [(8, 10, 10), (3, 16, 40),
                                              (5, 70, 100)])
def test_merge_parts_matches_jax(select_min, n_parts, k_part, k):
    rng = np.random.default_rng(n_parts * 100 + k)
    vals = rng.integers(0, 50, (n_parts, 37, k_part)).astype(np.float32)
    vals = np.sort(vals, axis=2)
    if not select_min:
        vals = vals[..., ::-1].copy()
    ids = rng.permutation(n_parts * 37 * k_part).astype(np.int32).reshape(
        vals.shape)
    jv, ji = jmerge_parts(jnp.asarray(vals), jnp.asarray(ids), k,
                          select_min=select_min)
    tv, ti = tmerge_parts(torch.from_numpy(vals), torch.from_numpy(ids), k,
                          select_min=select_min)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
