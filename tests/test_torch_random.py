"""The port's ``random`` package against the JAX package's, on the CPU.

The same state goes to ``raft_tpu.random`` and to
``raft_tpu_torch.random`` (``device="cpu"``). Tolerances: integer and
bool draws, labels, edges, permutations and Gumbel top-k ids bit for bit;
float draws rtol 1e-6 (their logs, log1ps and tangents are torch's, so a
value may differ in its last bits), plus atol 2.4e-7 (two ulps at 1)
where a draw crosses zero: ``-log(-log u)`` cancels at u ≈ 1/e and
``mu + sigma·z`` at z ≈ −mu/sigma, so relative error there says nothing;
generated rows rtol 1e-5, atol 1e-6; a non-positive-definite covariance
gives NaN samples in both packages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import random as jr
from raft_tpu.random import rng as jrng

from raft_tpu_torch import random as tr
from raft_tpu_torch.random import generators as tgen
from raft_tpu_torch.random import rng as trng
from raft_tpu_torch.random import threefry

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPE = (20_000,)
ZERO_ATOL = 2.4e-7

# (name, keyword arguments): every distribution of rng.py, at its
# defaults and with its location/scale moved
DISTRIBUTIONS = [
    ("uniform", {}), ("uniform", dict(lo=-2.0, hi=3.0)),
    ("uniform_int", dict(lo=0, hi=10)),
    ("uniform_int", dict(lo=-5, hi=70_000)),
    ("normal", {}), ("normal", dict(mu=1.5, sigma=2.0)),
    ("lognormal", dict(mu=0.5, sigma=0.5)),
    ("gumbel", {}), ("gumbel", dict(mu=0.5, beta=2.0)),
    ("laplace", {}), ("laplace", dict(mu=1.0, scale=3.0)),
    ("exponential", {}), ("exponential", dict(lam=2.5)),
    ("rayleigh", dict(sigma=2.0)),
    ("cauchy", {}), ("cauchy", dict(mu=0.5, scale=1.5)),
    ("bernoulli", {}), ("bernoulli", dict(p=0.3)),
]


@pytest.mark.parametrize("name,kw", DISTRIBUTIONS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(DISTRIBUTIONS)])
def test_distributions_match_jax(name, kw):
    want = np.asarray(getattr(jrng, name)(jrng.RngState(3, 2), SHAPE, **kw))
    got = getattr(trng, name)(trng.RngState(3, 2), SHAPE, device="cpu",
                              **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(kw.get("sigma", 1.0), kw.get("scale", 1.0),
                    kw.get("beta", 1.0))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=ZERO_ATOL * scale)


def test_state_advance_and_raw_keys():
    """``advance`` moves the subsequence as the JAX package's does, and a
    raw key stands for a state in every draw."""
    s = trng.RngState(9, 1).advance(3)
    assert (s.seed, s.subsequence) == (9, 4)
    assert s.key() == tuple(int(w) for w in np.asarray(
        jax.random.key_data(jrng.RngState(9, 1).advance(3).key())))
    jkey = jax.random.PRNGKey(11)
    for name in ("uniform", "normal", "gumbel"):
        want = np.asarray(getattr(jrng, name)(jkey, SHAPE))
        got = getattr(trng, name)(threefry.prng_key(11), SHAPE,
                                  device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=ZERO_ATOL)
    np.testing.assert_array_equal(
        trng.uniform_int(threefry.prng_key(11), SHAPE, 3, 9,
                         device="cpu").numpy(),
        np.asarray(jrng.uniform_int(jkey, SHAPE, 3, 9)))


def test_package_exports_the_distributions_and_generators():
    assert tr.make_blobs is tgen.make_blobs and tr.normal is trng.normal
    with pytest.raises(ValueError, match="float32"):
        trng.normal(trng.RngState(0), (3,), dtype=torch.float16,
                    device="cpu")


@pytest.mark.parametrize("std,shuffle", [(1.0, True), (1.5, False)])
def test_make_blobs_matches_jax(std, shuffle):
    js, ts = jr.RngState(5, 1), tr.RngState(5, 1)
    x, lab = jr.make_blobs(3000, 16, n_clusters=7, cluster_std=std,
                           shuffle=shuffle, state=js)
    tx, tlab = tr.make_blobs(3000, 16, n_clusters=7, cluster_std=std,
                             shuffle=shuffle, state=ts, device="cpu")
    assert tlab.dtype == torch.int32
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(lab))
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-5,
                               atol=1e-6)
    centers = np.random.default_rng(0).random((4, 16)).astype(np.float32)
    x, lab = jr.make_blobs(3000, 16, centers=jnp.asarray(centers), state=js)
    tx, tlab = tr.make_blobs(3000, 16, centers=torch.from_numpy(centers),
                             state=ts, device="cpu")
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(lab))
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-5,
                               atol=1e-6)


def test_make_regression_and_rmat_match_jax():
    js, ts = jr.RngState(2), tr.RngState(2)
    x, y, w = jr.make_regression(400, 8, n_informative=5, n_targets=2,
                                 bias=1.0, noise=0.3, state=js)
    tx, ty, tw = tr.make_regression(400, 8, n_informative=5, n_targets=2,
                                    bias=1.0, noise=0.3, state=ts,
                                    device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-6,
                               atol=ZERO_ATOL)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-4)
    for r, c in ((10, 8), (8, 10)):
        e = jr.rmat_rectangular(js, 5000, r, c)
        te = tr.rmat_rectangular(ts, 5000, r, c, device="cpu")
        assert te.dtype == torch.int32
        np.testing.assert_array_equal(te.numpy(), np.asarray(e))


def test_permute_subsample_and_sampling_match_jax():
    js, ts = jr.RngState(4, 7), tr.RngState(4, 7)
    items = np.arange(2000, dtype=np.int32) * 3
    rows = np.random.default_rng(1).random((2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.permute(torch.from_numpy(rows), ts).numpy(),
        np.asarray(jr.permute(jnp.asarray(rows), js)))
    np.testing.assert_array_equal(
        tr.subsample(ts, 2000, 300, device="cpu").numpy(),
        np.asarray(jr.subsample(js, 2000, 300)))
    w = np.random.default_rng(0).random(2000).astype(np.float32)
    w[::7] = 0.0
    for weights in (None, w):
        want = jr.sample_without_replacement(
            js, jnp.asarray(items), 150,
            None if weights is None else jnp.asarray(weights))
        got = tr.sample_without_replacement(
            ts, torch.from_numpy(items), 150,
            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_ties_take_the_lower_index_first():
    """``lax.top_k``'s order among equal values is the lower index first;
    ``torch.topk`` and an unstable sort scramble it."""
    g = np.array([float(i % 4) for i in range(1000)], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(g), 100)
    got = tgen._top_k_ids(torch.from_numpy(g), 100)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["cholesky", "eig"])
def test_multi_variable_gaussian_matches_jax(method):
    """cholesky: the JAX package's samples; eig: eigenvectors are signed
    arbitrarily, so the samples' covariance (rtol 0.1 at 20,000 rows) and
    mean."""
    js, ts = jr.RngState(6), tr.RngState(6)
    a = np.random.default_rng(1).random((4, 4)).astype(np.float32)
    cov = a @ a.T + np.eye(4, dtype=np.float32)
    mean = np.arange(4, dtype=np.float32)
    want = np.asarray(jr.multi_variable_gaussian(
        js, jnp.asarray(mean), jnp.asarray(cov), 20_000, method))
    got = tr.multi_variable_gaussian(ts, torch.from_numpy(mean),
                                     torch.from_numpy(cov), 20_000,
                                     method).numpy()
    if method == "cholesky":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for s in (got, want):
        np.testing.assert_allclose(np.cov(s, rowvar=False), cov, rtol=0.1,
                                   atol=0.05)
        np.testing.assert_allclose(s.mean(0), mean, atol=0.05)


def test_non_positive_definite_covariance_gives_nans():
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    want = np.asarray(jr.multi_variable_gaussian(
        jr.RngState(0), jnp.zeros(2), jnp.asarray(bad), 5))
    got = tr.multi_variable_gaussian(tr.RngState(0), torch.zeros(2),
                                     torch.from_numpy(bad), 5).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
    with pytest.raises(ValueError, match="unknown method"):
        tr.multi_variable_gaussian(tr.RngState(0), torch.zeros(2),
                                   torch.from_numpy(bad), 5, "svd")
