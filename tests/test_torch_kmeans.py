"""The port's k-means (``raft_tpu_torch.cluster.kmeans``) against the JAX
package's, on the CPU.

The same seeded numpy blobs (n 2,000, d 16) go through
``raft_tpu.cluster.kmeans`` and through the port with ``device="cpu"``,
where the fused L2 argmin kernel's wrapper runs its plain version. Both
draw from the same threefry keys, so the seed rows are the same rows.

Tolerances: k-means++ and ``random`` seed centers exact (they are rows of
x); ``fit`` centroids within 1e-5 relative (the sums run in another
order), the same ``n_iter``, labels equal away from f32 ties of the two
nearest centers; ``fit_minibatch`` centroids within 1e-4; ``transform``
and ``cluster_cost`` within 1e-5 relative; ``find_k`` the same k.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import KMeansParams as JParams
from raft_tpu.cluster import kmeans as jkm
from raft_tpu.random.rng import RngState as JRng

from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.random import threefry
from raft_tpu_torch.random.rng import RngState

from torch_parity import blobs

N, D = 2000, 16


@pytest.fixture(scope="module")
def data():
    x = blobs(N, D, 8, seed=5, std=1.5)
    w = np.random.default_rng(6).uniform(0.0, 2.0, N).astype(np.float32)
    w[::7] = 0.0
    return x, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _labels_away_from_ties(x, c, tl, jl, rtol=1e-5):
    """Labels equal on every row whose two nearest centers differ by more
    than the f32 error of the expanded distance."""
    d = ((x[:, None, :].astype(np.float64)
          - c[None, :, :].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > rtol * (1.0 + two[:, 1])
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(np.asarray(tl)[clear],
                                  np.asarray(jl)[clear])


@pytest.mark.parametrize("weighted", [False, True])
def test_init_plus_plus_picks_the_jax_rows(data, weighted):
    x, w = data
    key = JRng(11).key()
    tkey = RngState(11).key()
    jw = jnp.asarray(w) if weighted else None
    jc = np.asarray(jkm.init_plus_plus(key, jnp.asarray(x), 8, jw))
    tc = tkm.init_plus_plus(tkey, _t(x), 8,
                            _t(w) if weighted else None).numpy()
    np.testing.assert_array_equal(tc, jc)
    # every seed is a row of x with a positive weight
    rows = [int(np.flatnonzero((x == c).all(1))[0]) for c in tc]
    if weighted:
        assert (w[rows] > 0).all()


def test_random_init_is_the_jax_choice(data):
    x, _ = data
    key = jax.random.fold_in(JRng(4).key(), 2)
    tkey = threefry.fold_in(RngState(4).key(), 2)
    np.testing.assert_array_equal(
        tkm._init_random_threefry(tkey, _t(x), 8).numpy(),
        np.asarray(jkm.init_random(key, jnp.asarray(x), 8)))


FIT_CASES = {
    "plus_plus": dict(params=dict(n_clusters=8, max_iter=50, seed=3)),
    "weighted_n_init_3": dict(params=dict(n_clusters=8, max_iter=50, seed=7,
                                          n_init=3), weighted=True),
    "random": dict(params=dict(n_clusters=8, max_iter=50, seed=2,
                               init="random")),
    "array": dict(params=dict(n_clusters=6, max_iter=40, init="array"),
                  init_rows=[3, 300, 700, 1100, 1500, 1900]),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_jax(data, case):
    x, w = data
    c = FIT_CASES[case]
    init = x[c["init_rows"]] if "init_rows" in c else None
    sw = w if c.get("weighted") else None
    jc, jin, jit = jkm.fit(JParams(**c["params"]), jnp.asarray(x),
                           None if sw is None else jnp.asarray(sw),
                           None if init is None else jnp.asarray(init))
    tc, tin, tit = tkm.fit(tkm.KMeansParams(**c["params"]), x, sw, init,
                           device="cpu")
    jc = np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-5)
    assert int(tit) == int(jit)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)
    _labels_away_from_ties(x, jc, tkm.predict(tc, x, device="cpu").numpy(),
                           jkm.predict(jnp.asarray(jc), jnp.asarray(x)))


def test_fit_predict_transform_and_cost_match_jax(data):
    x, w = data
    p = dict(n_clusters=5, max_iter=30, seed=9)
    jc, jl, jin, jit = jkm.fit_predict(JParams(**p), jnp.asarray(x))
    tc, tl, tin, tit = tkm.fit_predict(tkm.KMeansParams(**p), x,
                                       device="cpu")
    jc = np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-5)
    assert int(tit) == int(jit)
    _labels_away_from_ties(x, jc, tl.numpy(), jl)
    np.testing.assert_allclose(
        tkm.transform(jc, x, device="cpu").numpy(),
        np.asarray(jkm.transform(jnp.asarray(jc), jnp.asarray(x))),
        rtol=1e-5, atol=1e-4)
    for sw in (None, w):
        want = float(jkm.cluster_cost(jnp.asarray(jc), jnp.asarray(x),
                                      None if sw is None else jnp.asarray(sw)))
        got = float(tkm.cluster_cost(jc, x, sw, device="cpu"))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # the fit's inertia is the cost of its final assignment sweep
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)


def test_update_centroids_matches_jax(data):
    x, w = data
    c = x[[5, 50, 500, 1000]]
    labels = np.random.default_rng(1).integers(0, 3, N).astype(np.int32)
    jn, jcent = jkm.update_centroids(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(c), jnp.asarray(labels))
    tn, tcent = tkm.update_centroids(_t(x), _t(w), _t(c), _t(labels))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    # cluster 3 is empty: it keeps its centroid
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tcent.numpy()[3], c[3])


@pytest.mark.parametrize("init", ["k-means++", "random"])
def test_fit_minibatch_matches_jax(data, init):
    x, _ = data
    p = dict(n_clusters=8, max_iter=50, seed=13, init=init)
    jc, jcost, jn = jkm.fit_minibatch(JParams(**p), jnp.asarray(x),
                                      batch_size=256, n_iters=30)
    tc, tcost, tn = tkm.fit_minibatch(tkm.KMeansParams(**p), x,
                                      batch_size=256, n_iters=30,
                                      device="cpu")
    assert tn == jn == 30
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-4)


def test_find_k_matches_jax():
    x = blobs(N, D, 4, seed=21, std=0.5)
    p = dict(max_iter=20, seed=1)
    jk, jin = jkm.find_k(jnp.asarray(x), k_max=8, params=JParams(**p))
    tk, tin = tkm.find_k(x, k_max=8, params=tkm.KMeansParams(**p),
                         device="cpu")
    assert tk == jk
    np.testing.assert_allclose(tin.numpy(), np.asarray(jin), rtol=1e-4)


def test_kmeans_entry_points_want_a_card_by_default(data):
    x, _ = data
    with pytest.raises(Exception):
        tkm.fit(tkm.KMeansParams(n_clusters=2), x)
