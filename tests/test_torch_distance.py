"""The distance layer of the port against the JAX package, on the CPU:
``pairwise_distance`` for every metric it dispatches, the Gram kernels,
``masked_l2_nn_argmin`` and ``brute_force.knn`` over the metrics that are
not expanded.

The same seeded numpy inputs go through both packages (the port with
``device="cpu"``). Tolerances: distances at ``tests/test_distance.py``'s
rtol 2e-4, atol 2e-5; argmins and masks exactly; brute-force ids equal
away from f32 distance ties, distances within 1e-5 relative.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import distance as jd
from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch import distance as td
from raft_tpu_torch.distance import pairwise as tpw
from raft_tpu_torch.neighbors import brute_force as tbf

from torch_parity import assert_ids_match_away_from_ties, filter_keep

RTOL, ATOL = 2e-4, 2e-5
M, N, D = 33, 47, 19


def _data(seed: int, kind: str = "real", m: int = M, n: int = N,
          d: int = D):
    rng = np.random.default_rng(seed)
    x = rng.random((m, d), dtype=np.float32)
    y = rng.random((n, d), dtype=np.float32)
    if kind == "binary":
        return (x > 0.5).astype(np.float32), (y > 0.5).astype(np.float32)
    if kind == "prob":
        # probability rows with exact zeros (the 0·log 0 convention)
        x[x < 0.2] = 0.0
        y[y < 0.2] = 0.0
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    if kind == "sparse":
        x[x < 0.6] = 0.0
        y[y < 0.6] = 0.0
        x[0] = 0.0       # an all-zero row: the den > 0 and union guards
        y[0] = 0.0
    return x, y


METRICS = [
    ("sqeuclidean", "real"), ("euclidean", "real"), ("cosine", "real"),
    ("inner_product", "real"), ("correlation", "real"),
    ("hellinger", "prob"), ("jaccard", "sparse"), ("dice", "sparse"),
    ("russelrao", "binary"), ("l1", "real"), ("l2_unexpanded", "real"),
    ("l2_sqrt_unexpanded", "real"), ("linf", "real"), ("canberra", "sparse"),
    ("lp", "real"), ("braycurtis", "sparse"), ("jensenshannon", "prob"),
    ("hamming", "binary"), ("kl_divergence", "prob"),
]


@pytest.mark.parametrize("metric,kind", METRICS, ids=[m for m, _ in METRICS])
def test_pairwise_matches_jax(metric, kind):
    x, y = _data(5, kind)
    want = np.asarray(jd.pairwise_distance(jnp.asarray(x), jnp.asarray(y),
                                           metric=metric))
    got = td.pairwise_distance(x, y, metric=metric, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["lp3", "haversine", "distance_alias"])
def test_pairwise_arguments_match_jax(case):
    if case == "haversine":
        rng = np.random.default_rng(6)
        scale = np.array([np.pi, 2 * np.pi], np.float32)
        x = (rng.random((20, 2), dtype=np.float32) - 0.5) * scale
        y = (rng.random((30, 2), dtype=np.float32) - 0.5) * scale
        want = jd.pairwise_distance(jnp.asarray(x), jnp.asarray(y),
                                    "haversine")
        got = td.pairwise_distance(x, y, "haversine", device="cpu")
    elif case == "lp3":
        x, y = _data(7)
        want = jd.pairwise_distance(jnp.asarray(x), jnp.asarray(y), "lp",
                                    metric_arg=3.0)
        got = td.pairwise_distance(x, y, "minkowski", metric_arg=3.0,
                                   device="cpu")
    else:
        x, y = _data(8)
        want = jd.distance(jnp.asarray(x), jnp.asarray(y), "canberra")
        got = td.distance(x, y, "canberra", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_pairwise_refusals():
    x, y = _data(9)
    with pytest.raises(ValueError, match="Precomputed"):
        td.pairwise_distance(x, y, "precomputed", device="cpu")
    with pytest.raises(Exception, match="haversine requires 2-D"):
        td.pairwise_distance(x, y, "haversine", device="cpu")
    with pytest.raises(Exception, match="feature dims differ"):
        td.pairwise_distance(x, y[:, :5], "l1", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            td.pairwise_distance(x, y, "l1")


@pytest.mark.parametrize("metric", ["l1", "jensenshannon", "lp"])
def test_tiled_engine_equals_untiled(monkeypatch, metric):
    """Row blocks of 8 (the budget cut to 8 rows of [n, d]) give the
    untiled engine's matrix bit for bit; Lp within 1 ulp (the CPU's
    vectorized ``pow`` and its scalar tail round differently, and which
    elements take the tail follows the block's shape)."""
    x, y = _data(10, "prob", m=61)
    whole = td.pairwise_distance(x, y, metric, metric_arg=1.5, device="cpu")
    monkeypatch.setattr(tpw, "_GENERIC_BUDGET_ELEMS", 8 * N * D + 5)
    assert tpw._row_tile(61, N, D, tpw._GENERIC_BUDGET_ELEMS) == 8
    tiled = td.pairwise_distance(x, y, metric, metric_arg=1.5, device="cpu")
    ulps = (whole.view(torch.int32) - tiled.view(torch.int32)).abs().max()
    assert int(ulps) <= (1 if metric == "lp" else 0)


@pytest.mark.parametrize("kernel", ["linear", "polynomial", "tanh", "rbf"])
def test_gram_matrix_matches_jax(kernel):
    x, y = _data(11)
    kw = dict(degree=2, gamma=0.1, coef0=1.0) if kernel != "rbf" else dict(
        gamma=0.5)
    want = jd.gram_matrix(jnp.asarray(x), jnp.asarray(y), jd.KernelParams(
        jd.KernelType(kernel), **kw))
    got = td.gram_matrix(x, y, td.KernelParams(td.KernelType(kernel), **kw),
                         device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["untiled", "tiled", "tiled_groups",
                                  "none_admitted"])
def test_masked_l2_nn_argmin_matches_jax(case):
    rng = np.random.default_rng(12)
    x = rng.random((37, 16), dtype=np.float32)
    y = rng.random((301, 16), dtype=np.float32)
    gidx, tile = None, 64
    if case == "untiled":
        tile = 4096
    if case == "tiled_groups":
        gidx = rng.integers(0, 6, 301).astype(np.int32)
        adj = rng.random((37, 6)) < 0.5
    else:
        adj = rng.random((37, 301)) < 0.2
    if case == "none_admitted":
        adj[3] = False   # +inf and index 0, as the JAX package gives
    jdist, jidx = jd.masked_l2_nn_argmin(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(adj),
        None if gidx is None else jnp.asarray(gidx), tile=tile)
    tdist, tidx = td.masked_l2_nn_argmin(x, y, adj, gidx, tile=tile,
                                         device="cpu")
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("metric,filtered", [
    ("l1", None), ("l1", "sel0.1"), ("haversine", None),
    ("haversine", "few"), ("lp", None), ("lp", "sel0.1")])
def test_brute_force_general_metrics_match_jax(monkeypatch, metric,
                                               filtered):
    """The general path: ``pairwise_distance`` of base tiles (2^14 rows
    here, so the running merge runs over three tiles), the filter's +inf,
    select_k, −1 in the unfilled slots ("few": 8 rows kept for k 12)."""
    rng = np.random.default_rng(13)
    n, m, k = 40_000, 25, 12
    if metric == "haversine":
        scale = np.array([np.pi, 2 * np.pi], np.float32)
        x = (rng.random((n, 2), dtype=np.float32) - 0.5) * scale
        q = (rng.random((m, 2), dtype=np.float32) - 0.5) * scale
    else:
        x = rng.random((n, 8), dtype=np.float32)
        q = rng.random((m, 8), dtype=np.float32)
    keep = bits = None
    if filtered == "sel0.1":
        keep = filter_keep(n, "sel0.1", seed=3)
    elif filtered == "few":
        keep = np.zeros(n, bool)
        keep[rng.choice(n, 8, replace=False)] = True
    if keep is not None:
        bits = np.asarray(jbs.from_mask(jnp.asarray(keep)))
    jv, ji = jbf.knn(jbf.build(jnp.asarray(x), metric=metric,
                               metric_arg=3.0), jnp.asarray(q), k,
                     filter_bitset=None if bits is None
                     else jnp.asarray(bits))
    monkeypatch.setattr(tbf, "_TILE_BUDGET_ELEMS", 0)
    tv, ti = tbf.knn(tbf.build(x, metric=metric, metric_arg=3.0,
                               device="cpu"), q, k,
                     filter_bitset=bits)
    assert_ids_match_away_from_ties(ti.numpy(), tv.numpy(), np.asarray(ji),
                                    np.asarray(jv), rtol=1e-5, atol=1e-6)
    if keep is not None:
        got = ti.numpy()
        assert keep[got[got >= 0]].all()
        assert (got[~np.isfinite(tv.numpy())] == -1).all()
    if filtered == "few":
        assert (ti.numpy()[:, 8:] == -1).all()


@pytest.mark.parametrize("package", ["distance", "neighbors"])
def test_packages_export_the_jax_names(package):
    """Every public name of ``raft_tpu.<package>`` is one of the port's
    (the distance layer and the neighbour indexes are ported whole)."""
    import importlib

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    want = public(importlib.import_module(f"raft_tpu.{package}"))
    got = public(importlib.import_module(f"raft_tpu_torch.{package}"))
    assert want <= got, sorted(want - got)
