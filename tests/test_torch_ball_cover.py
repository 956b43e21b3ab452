"""Ball cover and the ε-neighbourhood of the port against the JAX package,
on the CPU.

The same seeded numpy rows go through both packages (the port with
``device="cpu"``). On small-integer rows the build's arrays are the JAX
package's: landmarks, packed rows and ids and list sizes equal, radii
within 1e-6 relative (the two square roots may differ in the last bit).
``knn`` ids equal the JAX package's and brute force's away from distance
ties (rtol 1e-5); ``eps_nn`` and ``eps_neighbors_l2sq`` equal exactly on
integer rows, whose distances are exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu.neighbors import epsilon_neighborhood as jen
from raft_tpu_torch.neighbors import ball_cover as tbc
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import epsilon_neighborhood as ten

from torch_parity import (assert_ids_match_away_from_ties,
                          jax_ball_cover_arrays, jax_ball_cover_from_arrays)

N, L = 3000, 60


def _int_rows(seed: int, n: int, d: int = 3, shift: float = 0.0):
    rng = np.random.default_rng(seed)
    return rng.integers(-20, 21, size=(n, d)).astype(np.float32) + shift


def _geo_rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-3.1, 3.1, n)],
                    1).astype(np.float32)


@pytest.fixture(scope="module")
def integer_indexes():
    x = _int_rows(0, N)
    return (x, jbc.build(jnp.asarray(x), n_landmarks=L, seed=1),
            tbc.build(x, n_landmarks=L, seed=1, device="cpu"))


def test_build_arrays_match_jax(integer_indexes):
    _, ji, ti = integer_indexes
    want, meta = jax_ball_cover_arrays(ji)
    got, tmeta = tbc.to_numpy(ti)
    assert tmeta == meta == {"metric": "euclidean"}
    for name in ("landmarks", "packed_data", "packed_ids", "list_sizes"):
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["radii"], want["radii"], rtol=1e-6)
    assert int(got["list_sizes"].sum()) == N
    assert ti.packed_ids.dtype == torch.int32


@pytest.mark.parametrize("k,round_lists", [(1, 0), (1, 1), (7, 0), (7, 1),
                                           (64, 0), (64, 1)])
def test_knn_matches_jax_and_brute_force(integer_indexes, k, round_lists):
    """``round_lists`` 1 forces one list a round (many rounds, a stop test
    after each); 0 takes ⌈√L⌉."""
    x, ji, ti = integer_indexes
    q = _int_rows(2, 50, shift=0.25)
    jd, jid = jbc.knn(ji, jnp.asarray(q), k, round_lists=round_lists)
    stats = {}
    td, tid = tbc.knn(ti, q, k, round_lists=round_lists, device="cpu",
                      stats=stats)
    assert tid.dtype == torch.int32 and tuple(tid.shape) == (50, k)
    assert_ids_match_away_from_ties(tid.numpy(), td.numpy(), np.asarray(jid),
                                    np.asarray(jd), rtol=1e-5, atol=1e-5)
    bd, bi = tbf.knn_arrays(x, q, k, metric="euclidean", device="cpu")
    assert_ids_match_away_from_ties(tid.numpy(), td.numpy(), bi.numpy(),
                                    bd.numpy(), rtol=1e-5, atol=1e-5)
    assert len(stats["rounds"]) == 1 and 1 <= stats["rounds"][0]
    if round_lists == 1:
        assert stats["rounds"][0] > 1


def test_query_tiles_match_one_tile(integer_indexes, monkeypatch):
    """Query tiles of a few rows, each with its own stop test, give the
    one-tile answer."""
    _, _, ti = integer_indexes
    q = _int_rows(3, 40, shift=0.25)
    whole = tbc.knn(ti, q, 5, device="cpu")
    monkeypatch.setattr(tbc, "work_block_bytes", lambda dev: 1)
    stats = {}
    tiled = tbc.knn(ti, q, 5, device="cpu", stats=stats)
    assert stats["tile"] == 1 and len(stats["rounds"]) == 40
    assert torch.equal(whole[0], tiled[0]) and torch.equal(whole[1], tiled[1])


def test_haversine_matches_jax_and_brute_force():
    p = _geo_rows(4, 4000)
    q = p[:40] + 0.01
    ji = jbc.build(jnp.asarray(p), metric="haversine", seed=3)
    ti = tbc.build(p, metric="haversine", seed=3, device="cpu")
    assert ti.metric == "haversine"
    np.testing.assert_array_equal(ti.packed_ids.numpy(),
                                  np.asarray(ji.packed_ids))
    jd, jid = jbc.knn(ji, jnp.asarray(q), 5)
    td, tid = tbc.knn(ti, q, 5, device="cpu")
    assert_ids_match_away_from_ties(tid.numpy(), td.numpy(), np.asarray(jid),
                                    np.asarray(jd), rtol=1e-5, atol=1e-6)
    bd, bi = tbf.knn_arrays(p, q, 5, metric="haversine", device="cpu")
    assert_ids_match_away_from_ties(tid.numpy(), td.numpy(), bi.numpy(),
                                    bd.numpy(), rtol=1e-5, atol=1e-6)


def test_eps_nn_matches_jax(integer_indexes, monkeypatch):
    """The packed form (keep [m, L·max_list], ids), exactly; column
    blocks of a few slots give the same mask."""
    _, ji, ti = integer_indexes
    q = _int_rows(5, 30, shift=0.5)
    jk, jids = jbc.eps_nn(ji, jnp.asarray(q), 3.0)
    tk, tids = tbc.eps_nn(ti, q, 3.0, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tk.sum()) > 0
    monkeypatch.setattr(tbc, "work_block_bytes",
                        lambda dev: 30 * 5 * 4 * 97)
    assert torch.equal(tbc.eps_nn(ti, q, 3.0, device="cpu")[0], tk)


def test_eps_neighbors_l2sq_matches_jax(monkeypatch):
    """Exactly, in one column block and in blocks of 37 columns."""
    x = _int_rows(6, 300, d=4)
    y = _int_rows(7, 500, d=4)
    ja, jv = jen.eps_neighbors_l2sq(jnp.asarray(x), jnp.asarray(y), 90.0)
    ta, tv = ten.eps_neighbors_l2sq(x, y, 90.0, device="cpu")
    assert ta.dtype == torch.bool and tv.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert torch.equal(tv, ta.sum(1, dtype=torch.int32)) and tv.sum() > 300
    monkeypatch.setattr(ten, "_BLOCK_ELEMS", 300 * 37)
    tb, vb = ten.eps_neighbors_l2sq(x, y, 90.0, device="cpu")
    assert torch.equal(tb, ta) and torch.equal(vb, tv)


def test_a_jax_index_searches_in_the_port(integer_indexes):
    """A JAX-built index crosses as numpy arrays; the port's search over
    it gives the JAX package's ids away from ties, and back."""
    _, ji, ti = integer_indexes
    q = _int_rows(8, 30, shift=0.25)
    cross = tbc.from_numpy(*jax_ball_cover_arrays(ji), device="cpu")
    jd, jid = jbc.knn(ji, jnp.asarray(q), 9)
    td, tid = tbc.knn(cross, q, 9, device="cpu")
    assert_ids_match_away_from_ties(tid.numpy(), td.numpy(), np.asarray(jid),
                                    np.asarray(jd), rtol=1e-5, atol=1e-5)
    back = jax_ball_cover_from_arrays(*tbc.to_numpy(ti))
    bd, bid = jbc.knn(back, jnp.asarray(q), 9)
    np.testing.assert_array_equal(np.asarray(bid), np.asarray(jid))


def test_refusals():
    x = _int_rows(9, 100)
    with pytest.raises(Exception, match="true metric"):
        tbc.build(x, metric="cosine", device="cpu")
    index = tbc.build(x, n_landmarks=5, device="cpu")
    with pytest.raises(Exception, match="queries must be"):
        tbc.knn(index, x[:, :2], 3, device="cpu")
    with pytest.raises(Exception, match="k larger than index size"):
        tbc.knn(index, x, 101, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbc.build(x)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbc.knn(index, x, 3)
