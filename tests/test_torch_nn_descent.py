"""NN-Descent of the port against the JAX package, on the CPU, and
``threefry.permutation`` against ``jax.random.permutation``.

Every draw is the JAX package's, so on small-integer rows (every f32 sum
exact, in any order) the graph and its distances are the JAX package's
bit for bit, chunked or not, and so is CAGRA's graph over it. On float
blobs the two packages' graph recall agrees within 0.02.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcg
from raft_tpu.neighbors import nn_descent as jnd
from raft_tpu_torch.neighbors import cagra as tcg
from raft_tpu_torch.neighbors import nn_descent as tnd
from raft_tpu_torch.random import threefry as ttf

from torch_parity import blobs, exact_knn


def _int_rows(n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("n,rounds", [(1000, 1), (100_000, 2),
                                      (2_700_000, 3)])
def test_permutation_is_jax_bit_for_bit(n, rounds):
    """One round up to ~1,600 elements, two up to ~2.6M, three past."""
    assert int(np.ceil(3 * np.log(n) / np.log(2 ** 32 - 1))) == rounds
    key = jax.random.fold_in(jax.random.PRNGKey(11), n)
    want = np.asarray(jax.random.permutation(key, n))
    got = ttf.permutation(ttf.fold_in(ttf.prng_key(11), n), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_graph_is_jax_bit_for_bit(metric):
    x = _int_rows(1000, 16, 0)
    ji, jd = jnd.build_knn_graph_with_distances(
        jnp.asarray(x), 8, metric=metric, n_iters=5, seed=3)
    ti, td = tnd.build_knn_graph_with_distances(
        x, 8, metric=metric, n_iters=5, seed=3, device="cpu")
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))
    only = tnd.build_knn_graph(x, 8, metric=metric, n_iters=5, seed=3,
                               device="cpu")
    assert torch.equal(only, ti)


@pytest.mark.parametrize("rows", [1, 77])
def test_chunked_rows_equal_unchunked(monkeypatch, rows):
    x = _int_rows(1000, 16, 1)
    whole = tnd.build_knn_graph_with_distances(x, 8, n_iters=4, seed=5,
                                               device="cpu")
    monkeypatch.setattr(tnd, "_chunk_rows", lambda *a: rows)
    part = tnd.build_knn_graph_with_distances(x, 8, n_iters=4, seed=5,
                                              device="cpu")
    assert torch.equal(part[0], whole[0])
    assert torch.equal(part[1], whole[1])


def test_float_blobs_recall_matches_jax():
    x = blobs(2000, 16, 20, seed=31)
    gt = exact_knn(x, x, 11)[:, 1:]

    def recall(ids):
        ids = np.asarray(ids)
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])

    r_j = recall(jnd.build_knn_graph(jnp.asarray(x), 10, n_iters=15, seed=2))
    r_t = recall(tnd.build_knn_graph(x, 10, n_iters=15, seed=2,
                                     device="cpu"))
    assert abs(r_t - r_j) <= 0.02, (r_t, r_j)
    assert r_t >= 0.85


def test_cagra_nn_descent_graph_is_jax_bit_for_bit():
    """CAGRA's third build algorithm on integer rows (d ≤ 256: no build
    projection): the JAX package's intermediate graph, so its pruned
    graph too; no entries."""
    x = _int_rows(1500, 24, 2)
    kw = dict(intermediate_graph_degree=16, graph_degree=8,
              build_algo="nn_descent", nn_descent_niter=4, seed=4)
    ji = jcg.build(jnp.asarray(x), jcg.IndexParams(**kw))
    ti = tcg.build(x, tcg.IndexParams(**kw), device="cpu")
    np.testing.assert_array_equal(ti.graph.numpy(), np.asarray(ji.graph))
    assert ti.centers is None and ji.centers is None
