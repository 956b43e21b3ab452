"""The port's ``label`` package (and ``sparse.types`` under it) against
the JAX package's, on the CPU.

The same numpy inputs go to ``raft_tpu.label`` / ``raft_tpu.sparse`` and
to their ports (CPU tensors). Everything here is integer or structural,
so every comparison is exact: unique labels, ``make_monotonic`` (with
and without an ignored noise label), ``merge_labels``,
``connected_components`` (also against ``scipy.sparse.csgraph``'s
partition), and the COO/CSR conversions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph
import torch

from raft_tpu import label as jlab
from raft_tpu import sparse as jsp

from raft_tpu_torch import label as tlab
from raft_tpu_torch import sparse as tsp

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _graph(n, n_edges, seed):
    """A symmetric random graph of several components as scipy CSR."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n_edges)
    c = (r + rng.integers(1, 4, n_edges)) % n  # short hops: many parts
    keep = rng.random(n_edges) < 0.7
    m = sp.coo_matrix((np.ones(keep.sum(), np.float32), (r[keep], c[keep])),
                      shape=(n, n))
    return (m + m.T).tocsr()


def test_unique_and_monotonic_labels_match_jax():
    lab = np.array([7, 3, 3, -1, 9, 7, -1, 12], np.int32)
    np.testing.assert_array_equal(
        tlab.unique_labels(torch.from_numpy(lab)).numpy(),
        np.asarray(jlab.unique_labels(jnp.asarray(lab))))
    for ignore in (None, -1):
        got, k = tlab.make_monotonic(torch.from_numpy(lab), ignore=ignore)
        want, jk = jlab.make_monotonic(jnp.asarray(lab), ignore=ignore)
        assert k == jk and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, k = tlab.make_monotonic(lab.astype(np.int64))  # a host array
    assert got.dtype == torch.int32 and k == 5


@pytest.mark.parametrize("n,n_edges,seed", [(200, 150, 0), (500, 700, 1)])
def test_connected_components_match_jax_and_scipy(n, n_edges, seed):
    g = _graph(n, n_edges, seed)
    stats = {}
    got, k = tlab.connected_components(tsp.from_scipy(g, device="cpu"),
                                       stats=stats)
    want, jk = jlab.connected_components(jsp.from_scipy(g))
    assert k == jk and stats["rounds"] >= 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nc, ref = csgraph.connected_components(g, directed=False)
    assert nc == k
    # the same partition: labels are first-seen ordered in both
    _, first = np.unique(ref, return_index=True)
    relabel = np.empty(nc, np.int64)
    relabel[np.argsort(first)] = np.arange(nc)
    np.testing.assert_array_equal(got.numpy(), relabel[ref])


def test_merge_labels_matches_jax_and_the_whole_graph():
    """Root-id labelings of two halves of a graph's edges, merged, give
    the whole graph's components."""
    g = _graph(300, 400, 2).tocoo()
    half = g.nnz // 2
    roots = []
    for sl in (slice(0, half), slice(half, None)):
        m = sp.coo_matrix((g.data[sl], (g.row[sl], g.col[sl])),
                          shape=g.shape)
        m = (m + m.T).tocsr()
        mono, k = tlab.connected_components(tsp.from_scipy(m, device="cpu"))
        root = torch.full((k,), 300, dtype=torch.int32).scatter_reduce(
            0, mono.long(), torch.arange(300, dtype=torch.int32), "amin")
        roots.append(root[mono.long()])
    got = tlab.merge_labels(*roots)
    want = jlab.merge_labels(*(jnp.asarray(r.numpy()) for r in roots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    whole, _ = tlab.connected_components(tsp.from_scipy(g.tocsr(),
                                                        device="cpu"))
    np.testing.assert_array_equal(tlab.make_monotonic(got)[0].numpy(),
                                  whole.numpy())


def test_sparse_types_match_jax():
    rng = np.random.default_rng(3)
    dense = rng.random((6, 9)).astype(np.float32)
    dense[dense < 0.6] = 0.0
    tcoo = tsp.coo_from_dense(torch.from_numpy(dense))
    jcoo = jsp.coo_from_dense(jnp.asarray(dense))
    for a, b in zip(tcoo[:3], jcoo[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tcoo.shape == jcoo.shape and tcoo.nnz == jcoo.nnz
    tcsr = tsp.csr_from_dense(torch.from_numpy(dense))
    jcsr = jsp.csr_from_dense(jnp.asarray(dense))
    for a, b in zip(tcsr[:3], jcsr[:3]):
        assert a.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[
                               np.asarray(b).dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tcsr.row_ids.numpy(),
                                  np.asarray(jcsr.row_ids))
    back = tsp.csr_to_coo(tcsr)
    np.testing.assert_array_equal(tsp.to_dense(back).numpy(), dense)
    np.testing.assert_array_equal(tsp.to_dense(tcsr).numpy(), dense)
    # duplicates sum, from a COO whose rows are out of order
    r, c = np.array([3, 0, 3, 1]), np.array([2, 5, 2, 0])
    v = np.array([1.0, 2.0, 3.0, 4.0])
    tm = tsp.make_coo(r, c, v, (4, 6), device="cpu")
    jm = jsp.make_coo(r, c, v, (4, 6))
    assert tm.data.dtype == torch.float32  # 32-bit, as the JAX package's
    np.testing.assert_array_equal(tsp.to_dense(tm).numpy(),
                                  np.asarray(jsp.to_dense(jm)))
    for a, b in zip(tsp.coo_to_csr(tm)[:3], jsp.coo_to_csr(jm)[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s = sp.random(7, 5, density=0.4, random_state=4, format="csr")
    for a, b in zip(tsp.from_scipy(s, device="cpu")[:3],
                    jsp.from_scipy(s)[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tsp.to_scipy(tsp.from_scipy(s, device="cpu")).toarray(),
        s.toarray().astype(np.float32))
    assert (tsp.to_scipy(tm).toarray() == np.asarray(jsp.to_dense(jm))).all()


def test_unported_sparse_submodules_name_a17():
    for name in tsp.UNPORTED:
        with pytest.raises(NotImplementedError, match="A17"):
            getattr(tsp, name)
    with pytest.raises(NotImplementedError, match="A17"):
        from raft_tpu_torch.sparse import solver  # noqa: F401
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            tsp.make_csr(np.zeros(3), np.zeros(0), np.zeros(0), (2, 2))
        else:
            raise RuntimeError("device='cpu' (a card is present)")
