"""The port's ``linalg`` package against the JAX package's, on the CPU.

The same numpy inputs go to ``raft_tpu.linalg`` and to
``raft_tpu_torch.linalg`` (CPU tensors). Tolerances are the reference
tests' (``tests/test_linalg.py``): products and reductions rtol 1e-5,
axpy rtol 1e-6, eigen/SVD/QR reconstructions atol 1e-4, rsvd's singular
values rtol 1e-3 against the full SVD (and rtol 1e-5 against the JAX
package's, whose Ω is the same draw), lstsq atol 1e-3 against the true
solution and 1e-4 against the JAX package's, the rank-1 Cholesky update
atol 1e-3 against a fresh factor (1e-5 against the JAX package's).
Vectors of eig/SVD/QR are compared up to sign and by reconstruction.
Elementwise ops and integer reductions are exact (float ``power``
rtol 1e-6: libm's pow); ``reduce_rows_by_key``
and ``reduce_cols_by_key`` drop keys outside [0, n_keys), −1 included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import linalg as jl

from raft_tpu_torch import linalg as tl

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture()
def mats():
    rng = np.random.default_rng(3)
    return (rng.random((20, 12), dtype=np.float32),
            rng.random((12, 9), dtype=np.float32),
            rng.random((12, 12), dtype=np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_blas_matches_jax(mats):
    a, b, c = mats
    x = a[0, :12].copy()
    y = a[1, :12].copy()
    cases = [
        (lambda m, a, b, c, x, y: m.gemm(a, b), 1e-5),
        (lambda m, a, b, c, x, y: m.gemm(a, a, alpha=2.0, beta=0.5, c=c,
                                         trans_a=True), 1e-5),
        (lambda m, a, b, c, x, y: m.gemm(b, a, trans_a=True, trans_b=True),
         1e-5),
        (lambda m, a, b, c, x, y: m.gemv(a, x, alpha=1.5), 1e-5),
        (lambda m, a, b, c, x, y: m.gemv(c, x, beta=2.0, y=y, trans=True),
         1e-5),
        (lambda m, a, b, c, x, y: m.axpy(2.0, x, y), 1e-6),
        (lambda m, a, b, c, x, y: m.dot(x, y), 1e-5),
        (lambda m, a, b, c, x, y: m.dot(a, b), 1e-5),
    ]
    for fn, rtol in cases:
        want = np.asarray(fn(jl, *_j(a, b, c, x, y)))
        got = fn(tl, *_t(a, b, c, x, y)).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("name", ["add", "subtract", "eltwise_multiply",
                                  "divide", "power"])
def test_eltwise_matches_jax(name):
    rng = np.random.default_rng(1)
    x = rng.random((5, 7), dtype=np.float32) + 0.5
    y = rng.random((5, 7), dtype=np.float32) + 0.5
    i = rng.integers(1, 6, (5, 7)).astype(np.int32)
    for args in ((x, y), (i, i)):
        want = np.asarray(getattr(jl, name)(*_j(*args)))
        got = getattr(tl, name)(*_t(*args)).numpy()
        assert got.dtype == want.dtype
        if name == "power" and args[0] is x:  # libm's pow: last bit
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tl.sqrt(*_t(x)).numpy(),
                                  np.asarray(jl.sqrt(*_j(x))))
    np.testing.assert_array_equal(tl.transpose(*_t(x)).numpy(), x.T)


def test_maps_and_reductions_match_jax(mats):
    a, _, c = mats
    v = a[0].copy()
    ints = (a * 10).astype(np.int32)
    for norm in ("l2", "l1", "linf"):
        np.testing.assert_allclose(
            tl.normalize_rows(*_t(a), norm=norm).numpy(),
            np.asarray(jl.normalize_rows(*_j(a), norm=norm)), rtol=1e-5)
    for m in (a, ints):
        for axis in (0, 1):
            for op in ("sum", "max", "min"):
                want = np.asarray(jl.reduce_op(*_j(m), axis=axis, op=op))
                got = tl.reduce_op(*_t(m), axis=axis, op=op).numpy()
                assert got.dtype == want.dtype, (op, m.dtype)
                np.testing.assert_allclose(got, want, rtol=1e-5)
    sq = lambda z: z * z  # noqa: E731
    pairs = [
        (tl.reduce_op(*_t(a), main_op=sq), jl.reduce_op(*_j(a), main_op=sq)),
        (tl.coalesced_reduction(*_t(a), op="max"),
         jl.coalesced_reduction(*_j(a), op="max")),
        (tl.strided_reduction(*_t(a), main_op=sq),
         jl.strided_reduction(*_j(a), main_op=sq)),
        (tl.map_then_reduce(lambda p, q: p * q, *_t(a, a)),
         jl.map_then_reduce(lambda p, q: p * q, *_j(a, a))),
        (tl.map_then_reduce(lambda p: p, *_t(a), axis=1),
         jl.map_then_reduce(lambda p: p, *_j(a), axis=1)),
        (tl.matrix_vector_op(*_t(a, v[:12]), lambda p, q: p - q),
         jl.matrix_vector_op(*_j(a, v[:12]), lambda p, q: p - q)),
        (tl.matrix_vector_op(*_t(c, v[:12]), lambda p, q: p * q, False),
         jl.matrix_vector_op(*_j(c, v[:12]), lambda p, q: p * q, False)),
        (tl.map_op(lambda p, q: p + 2 * q, *_t(a, a)),
         jl.map_op(lambda p, q: p + 2 * q, *_j(a, a))),
        (tl.unary_op(torch.exp, *_t(a)), jl.unary_op(jnp.exp, *_j(a))),
        (tl.binary_op(torch.maximum, *_t(a, a[::-1].copy())),
         jl.binary_op(jnp.maximum, *_j(a, a[::-1].copy()))),
        (tl.ternary_op(lambda p, q, r: p * q + r, *_t(a, a, a)),
         jl.ternary_op(lambda p, q, r: p * q + r, *_j(a, a, a))),
        (tl.mean_squared_error(*_t(a, a + 0.1)),
         jl.mean_squared_error(*_j(a, a + 0.1))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    got = tl.map_offset(lambda i: i * 2, (3, 4), device="cpu")
    want = np.asarray(jl.map_offset(lambda i: i * 2, (3, 4)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reduce_by_key_drops_out_of_range_keys():
    """``segment_sum`` drops keys outside [0, n_keys): a −1 noise key and
    n_keys itself (``index_add_`` would raise on either)."""
    rng = np.random.default_rng(2)
    m = rng.random((12, 4), dtype=np.float32)
    keys = np.array([0, 1, -1, 2, 1, 0, 3, 2, 1, -1, 0, 3], np.int32)
    w = rng.random(12, dtype=np.float32)
    for kw in ({}, {"weights": w}):
        want = np.asarray(jl.reduce_rows_by_key(
            *_j(m, keys), 3, **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = tl.reduce_rows_by_key(
            *_t(m, keys), 3, **{k: torch.from_numpy(v)
                                for k, v in kw.items()}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    mc = rng.random((4, 12), dtype=np.float32)
    want = np.asarray(jl.reduce_cols_by_key(*_j(mc, keys), 3))
    got = tl.reduce_cols_by_key(*_t(mc, keys), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got[:, 0], mc[:, keys == 0].sum(1),
                               rtol=1e-5)


def _sym(n, seed):
    a = np.random.default_rng(seed).random((n, n), dtype=np.float32)
    return (a + a.T) / 2


def _up_to_sign(got, want, atol):
    s = np.sign((got * want).sum(0))
    s[s == 0] = 1
    np.testing.assert_allclose(got * s[None, :], want, atol=atol)


def test_eig_and_svd_match_jax(mats):
    s = _sym(10, 4)
    for fn in ("eig_dc", "eig_jacobi"):
        w, v = getattr(tl, fn)(*_t(s))
        jw, jv = getattr(jl, fn)(*_j(s))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-5)
        assert np.all(np.diff(w.numpy()) >= 0)
        np.testing.assert_allclose(s @ v.numpy(), v.numpy() * w.numpy(),
                                   atol=1e-4)
        _up_to_sign(v.numpy(), np.asarray(jv), 1e-4)
    a = mats[0]
    for full in (False, True):
        u, sv, vt = tl.svd(*_t(a), full_matrices=full)
        ju, js, jvt = jl.svd(*_j(a), full_matrices=full)
        assert u.shape == ju.shape and vt.shape == jvt.shape
        np.testing.assert_allclose(sv.numpy(), np.asarray(js), rtol=1e-5)
        r = min(a.shape)
        np.testing.assert_allclose(
            u.numpy()[:, :r] @ np.diag(sv.numpy()) @ vt.numpy()[:r], a,
            atol=1e-4)
        _up_to_sign(u.numpy()[:, :r], np.asarray(ju)[:, :r], 1e-4)


def test_rsvd_and_qr_match_jax(mats):
    rng = np.random.default_rng(5)
    a = (rng.random((50, 5), dtype=np.float32)
         @ rng.random((5, 30), dtype=np.float32))
    u, s, vt = tl.rsvd(*_t(a), k=5, n_iter=3)
    ju, js, jvt = jl.rsvd(*_j(a), k=5, n_iter=3)
    np.testing.assert_allclose(s.numpy(),
                               np.linalg.svd(a, compute_uv=False)[:5],
                               rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    _up_to_sign(u.numpy()[:, :3], np.asarray(ju)[:, :3], 1e-3)
    key = jax.random.PRNGKey(4)
    _, s4, _ = tl.rsvd(*_t(a), k=4, p=2, key=(0, 4))
    _, js4, _ = jl.rsvd(*_j(a), k=4, p=2, key=key)
    np.testing.assert_allclose(s4.numpy(), np.asarray(js4), rtol=1e-5)
    q, r = tl.qr(*_t(mats[0]))
    jq, jr = jl.qr(*_j(mats[0]))
    np.testing.assert_allclose(q.numpy() @ r.numpy(), mats[0], atol=1e-4)
    np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(12),
                               atol=1e-4)
    _up_to_sign(q.numpy(), np.asarray(jq), 1e-4)


LSTSQ = {
    # a full-rank tall A
    "tall": lambda rng: rng.random((30, 5), dtype=np.float32),
    # rank 3 of 5: columns 3, 4 repeat columns 0, 1
    "rank_deficient": lambda rng: rng.random((30, 3), dtype=np.float32)[
        :, [0, 1, 2, 0, 1]],
    # more unknowns than equations
    "underdetermined": lambda rng: rng.random((4, 9), dtype=np.float32),
}


@pytest.mark.parametrize("case", sorted(LSTSQ))
def test_lstsq_is_the_minimum_norm_solution(case):
    """SVD's minimum-norm solution, as ``jnp.linalg.lstsq`` gives it, for
    full-rank, rank-deficient and underdetermined A, and a 2-D b."""
    rng = np.random.default_rng(7)
    a = LSTSQ[case](rng)
    x_true = rng.random(a.shape[1], dtype=np.float32)
    b = a @ x_true
    got = tl.lstsq(*_t(a, b)).numpy()
    want = np.asarray(jl.lstsq(*_j(a, b)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(a @ got, b, atol=1e-3)
    ref = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                          rcond=None)[0]
    np.testing.assert_allclose(got, ref, atol=1e-3)
    if case == "tall":
        np.testing.assert_allclose(got, x_true, atol=1e-3)
    b2 = np.stack([b, 2 * b], 1)
    np.testing.assert_allclose(tl.lstsq(*_t(a, b2)).numpy(),
                               np.asarray(jl.lstsq(*_j(a, b2))), atol=1e-4)


def test_cholesky_r1_update_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.random((6, 6), dtype=np.float32)
    spd = a @ a.T + 6 * np.eye(6, dtype=np.float32)
    lo = np.linalg.cholesky(spd).astype(np.float32)
    v = rng.random(6, dtype=np.float32)
    got = tl.cholesky_r1_update(*_t(lo, v)).numpy()
    np.testing.assert_allclose(
        got, np.linalg.cholesky(spd + np.outer(v, v)), atol=1e-3)
    np.testing.assert_allclose(
        got, np.asarray(jl.cholesky_r1_update(*_j(lo, v))), atol=1e-5)
    np.testing.assert_array_equal(_t(lo)[0].numpy(), lo)  # input kept
