"""The port's ``stats`` package against the JAX package's, on the CPU.

The same numpy inputs go to ``raft_tpu.stats`` and to
``raft_tpu_torch.stats`` (CPU tensors). Tolerances: the reference tests'
(``tests/test_stats.py``) where they apply — means rtol 1e-5, variances
rtol 1e-4, covariance rtol 1e-3 / atol 1e-5, the scores against
sklearn atol 1e-4 (silhouette 1e-3) — and against the JAX package's
values rtol 1e-5 / atol 1e-6 (float32 sums in another order);
contingency counts, histograms, min/max, integer sums and the
trustworthiness of integer-valued data (integer penalties) exact.

The answer-changing cases of a straight translation each have a test a
naive version fails: labels −1 and n_classes dropped (``index_add_``
raises), an even-length median (``torch.median`` takes the lower middle
value), tied distances in trustworthiness (an unstable argsort orders
them otherwise).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics as skm

from raft_tpu import stats as js

from raft_tpu_torch import stats as ts
from raft_tpu_torch.stats import metrics as tmetrics

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.numpy()), np.asarray(want),
                               rtol=rtol, atol=atol)


_JITTED = {}


def _ref(fn, *args):
    """``fn(*args)`` of the JAX package as one compiled program: run
    eagerly, each of its ops compiles on its own, which is most of this
    file's time. Array arguments are traced, the others static."""
    static = tuple(i for i, a in enumerate(args)
                   if not isinstance(a, jax.Array))
    key = (fn, static)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn, static_argnums=static)
    return _JITTED[key](*args)


def test_descriptive_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.random((50, 8), dtype=np.float32)
    w = rng.random(50, dtype=np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for axis in (0, 1):
        _close(ts.mean(tx, axis), js.mean(jx, axis))
        _close(ts.mean_center(tx, axis), js.mean_center(jx, axis))
        _close(ts.sum_op(tx, axis), js.sum_op(jx, axis))
        for sample in (True, False):
            mu, var = ts.meanvar(tx, axis, sample)
            jmu, jvar = js.meanvar(jx, axis, sample)
            _close(mu, jmu)
            _close(var, jvar, rtol=1e-4)
            _close(ts.stddev(tx, axis, sample), js.stddev(jx, axis, sample),
                   rtol=1e-4)
        lo, hi = ts.minmax(tx, axis)
        jlo, jhi = js.minmax(jx, axis)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    _close(ts.weighted_mean(tx, torch.from_numpy(w)),
           js.weighted_mean(jx, jnp.asarray(w)), rtol=1e-4)
    _close(ts.weighted_mean(tx[:, :8], torch.from_numpy(w[:8]), axis=1),
           js.weighted_mean(jx[:, :8], jnp.asarray(w[:8]), axis=1),
           rtol=1e-4)
    ints = (x * 100).astype(np.int32)
    got = ts.sum_op(torch.from_numpy(ints))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        js.sum_op(jnp.asarray(ints))))
    for center in (True, False):
        for sample in (True, False):
            _close(ts.cov(tx, center, sample), js.cov(jx, center, sample),
                   rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(ts.cov(tx).numpy(), np.cov(x, rowvar=False),
                               rtol=1e-3, atol=1e-5)


def test_histogram_matches_jax():
    """Values below lo and above hi are not counted; hi falls in the last
    bin."""
    rng = np.random.default_rng(2)
    x = (rng.random(3000) * 1.4 - 0.2).astype(np.float32)
    x[:3] = [0.0, 1.0, 0.5]
    for n_bins, lo, hi in ((10, 0.0, 1.0), (7, -0.1, 0.9)):
        got = ts.histogram(torch.from_numpy(x), n_bins, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            _ref(js.histogram, jnp.asarray(x), n_bins, lo, hi)))
        ref, _ = np.histogram(x, bins=n_bins, range=(lo, hi))
        np.testing.assert_allclose(got.numpy(), ref, atol=1)


def test_regression_metrics_take_the_middle_mean():
    """``jnp.median`` of an even length is the mean of the two middle
    values; of an odd length the middle one; NaN if any value is."""
    rng = np.random.default_rng(3)
    for n in (50, 51):
        y = rng.random(n).astype(np.float32)
        yh = (y + rng.normal(0, 0.1, n)).astype(np.float32)
        got = ts.regression_metrics(torch.from_numpy(yh), torch.from_numpy(y))
        want = _ref(js.regression_metrics, jnp.asarray(yh), jnp.asarray(y))
        for g, w in zip(got, want):
            _close(g, w)
        np.testing.assert_allclose(float(got[2]),
                                   np.median(np.abs(yh - y)), rtol=1e-6)
    yh[4] = np.nan
    got = ts.regression_metrics(torch.from_numpy(yh), torch.from_numpy(y))
    assert np.isnan(float(got[2]))
    assert np.isnan(float(_ref(js.regression_metrics, jnp.asarray(yh),
                               jnp.asarray(y))[2]))
    _close(ts.r2_score(torch.from_numpy(y), torch.from_numpy(yh[::-1].copy())),
           _ref(js.r2_score, jnp.asarray(y),
                jnp.asarray(yh[::-1].copy())))
    p = rng.integers(0, 3, 60).astype(np.int32)
    q = rng.integers(0, 3, 60).astype(np.int32)
    _close(ts.accuracy(torch.from_numpy(p), torch.from_numpy(q)),
           _ref(js.accuracy, jnp.asarray(p), jnp.asarray(q)))


def _labels(with_noise):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 4, 300).astype(np.int32)
    b = rng.integers(0, 4, 300).astype(np.int32)
    if with_noise:  # a −1 noise label and n_classes, in both labelings
        a[::17] = -1
        b[5::23] = 4
        a[7::31] = 4
    return a, b


SCORES = ["rand_index", "adjusted_rand_index", "mutual_info_score",
          "homogeneity_score", "completeness_score", "v_measure"]


@pytest.mark.parametrize("with_noise", [False, True])
def test_clustering_scores_match_jax(with_noise):
    a, b = _labels(with_noise)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    c = ts.contingency_matrix(ta, tb, 4, 4)
    assert c.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(), np.asarray(
        _ref(js.contingency_matrix, ja, jb, 4, 4)))
    np.testing.assert_array_equal(
        ts.contingency_matrix(ta, tb, 3, 5).numpy(),
        np.asarray(_ref(js.contingency_matrix, ja, jb, 3, 5)))
    for name in SCORES:
        got = getattr(ts, name)(ta, tb, 4)
        assert got.dtype == torch.float32, name
        _close(got, _ref(getattr(js, name), ja, jb, 4))
    _close(ts.entropy(ta, 4), _ref(js.entropy, ja, 4))
    if not with_noise:
        _close(ts.adjusted_rand_index(ta, tb, 4),
               skm.adjusted_rand_score(a, b), atol=1e-4)
        hcv = [float(ts.homogeneity_score(ta, tb, 4)),
               float(ts.completeness_score(ta, tb, 4)),
               float(ts.v_measure(ta, tb, 4))]
        np.testing.assert_allclose(
            hcv, skm.homogeneity_completeness_v_measure(a, b), atol=1e-4)
    one = torch.zeros(10, dtype=torch.int32)
    assert float(ts.adjusted_rand_index(one, one, 2)) == float(
        _ref(js.adjusted_rand_index, jnp.zeros(10, jnp.int32),
                               jnp.zeros(10, jnp.int32), 2)) == 1.0


def test_dispersion_and_kl_match_jax():
    rng = np.random.default_rng(5)
    x = rng.random((200, 6), dtype=np.float32)
    c = rng.random((5, 6), dtype=np.float32)
    lab = rng.integers(-1, 6, 200).astype(np.int32)  # −1 and 5 dropped
    _close(ts.dispersion(*map(torch.from_numpy, (x, c, lab))),
           _ref(js.dispersion, *map(jnp.asarray, (x, c, lab))))
    p = rng.random(20).astype(np.float32)
    q = rng.random(20).astype(np.float32)
    p[3] = 0.0
    p, q = p / p.sum(), q / q.sum()
    _close(ts.kl_divergence(torch.from_numpy(p), torch.from_numpy(q)),
           _ref(js.kl_divergence, jnp.asarray(p), jnp.asarray(q)))


def test_silhouette_matches_jax_whole_and_in_row_tiles(monkeypatch):
    from raft_tpu.random import make_blobs
    from raft_tpu.random.rng import RngState

    x, lab = make_blobs(300, 6, n_clusters=4, cluster_std=0.5,
                        state=RngState(5))
    x, lab = np.array(x), np.array(lab)
    # n_clusters 6 over 4 blobs: two clusters empty
    want = float(_ref(js.silhouette_score, jnp.asarray(x),
                      jnp.asarray(lab), 6))
    whole = float(ts.silhouette_score(torch.from_numpy(x),
                                      torch.from_numpy(lab), 6))
    np.testing.assert_allclose(whole, want, rtol=1e-5)
    np.testing.assert_allclose(whole, skm.silhouette_score(x, lab),
                               atol=1e-3)
    # a cluster merged into another and a singleton: their rows' rules
    lab2 = lab.copy()
    lab2[lab2 == 3] = 2
    lab2[0] = 4
    np.testing.assert_allclose(
        float(ts.silhouette_score(torch.from_numpy(x),
                                  torch.from_numpy(lab2), 6)),
        float(_ref(js.silhouette_score, jnp.asarray(x), jnp.asarray(lab2),
                   6)),
        rtol=1e-5)
    # −1 noise labels: no one-hot column, their index wrapped as jnp's
    lab3 = lab.copy()
    lab3[::9] = -1
    np.testing.assert_allclose(
        float(ts.silhouette_score(torch.from_numpy(x),
                                  torch.from_numpy(lab3), 6)),
        float(_ref(js.silhouette_score, jnp.asarray(x), jnp.asarray(lab3),
                   6)),
        rtol=1e-5)
    monkeypatch.setattr(tmetrics, "_rows_per_tile", lambda n, dev: 7)
    tiled = float(ts.silhouette_score(torch.from_numpy(x),
                                      torch.from_numpy(lab), 6))
    np.testing.assert_allclose(tiled, whole, rtol=1e-6)


def test_trustworthiness_breaks_ties_as_a_stable_argsort(monkeypatch):
    """Integer-valued rows, each twice: every distance is exact and many
    tie, so the ranks depend on the argsorts' order among equal keys.
    The score equals the JAX package's exactly, in one tile and in row
    tiles."""
    rng = np.random.default_rng(6)
    base = rng.integers(0, 3, (30, 5)).astype(np.float32)
    x = np.concatenate([base, base])
    emb = x[:, :2].copy()
    want = float(_ref(js.trustworthiness_score, jnp.asarray(x),
                      jnp.asarray(emb), 5))
    got = float(ts.trustworthiness_score(torch.from_numpy(x),
                                         torch.from_numpy(emb), 5))
    assert got == want
    monkeypatch.setattr(tmetrics, "_rows_per_tile", lambda n, dev: 8)
    assert float(ts.trustworthiness_score(torch.from_numpy(x),
                                          torch.from_numpy(emb), 5)) == want
    # random rows of the same shapes (the JAX package's programs are
    # compiled once)
    xr = rng.random((60, 5), dtype=np.float32)
    er = (xr[:, :2] + 0.01 * rng.random((60, 2))).astype(np.float32)
    from sklearn.manifold import trustworthiness as sk_trust

    got = float(ts.trustworthiness_score(torch.from_numpy(xr),
                                         torch.from_numpy(er), 5))
    np.testing.assert_allclose(got, float(_ref(
        js.trustworthiness_score, jnp.asarray(xr), jnp.asarray(er), 5)),
        rtol=1e-6)
    np.testing.assert_allclose(got, sk_trust(xr, er, n_neighbors=5),
                               atol=1e-2)


def test_information_criterion_and_recall_match_jax():
    ll = np.array([-120.0, -80.5], np.float32)
    for ic in ("AIC", "AICc", "BIC"):
        _close(ts.information_criterion_batched(
            torch.from_numpy(ll), 3, 100, ts.InformationCriterion[ic]),
            _ref(js.information_criterion_batched, jnp.asarray(ll), 3, 100,
                 js.InformationCriterion[ic]))
    ref = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    got_i = np.array([[2, 1, 0], [3, 4, 9]], np.int32)
    ref_d = np.array([[0.0, 1.0, 2.0], [0.5, 1.0, 3.0]], np.float32)
    got_d = np.array([[0.0, 1.0, 2.0], [0.5, 1.0, 3.0005]], np.float32)
    for d in ((), (got_d, ref_d)):
        want = _ref(js.neighborhood_recall, jnp.asarray(got_i),
                    jnp.asarray(ref), *map(jnp.asarray, d))
        got = ts.neighborhood_recall(torch.from_numpy(got_i),
                                     torch.from_numpy(ref),
                                     *map(torch.from_numpy, d))
        _close(got, want)
