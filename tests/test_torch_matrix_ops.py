"""The port's ``matrix.ops`` against the JAX package's, on the CPU.

The same numpy inputs go to ``raft_tpu.matrix`` and to
``raft_tpu_torch.matrix`` (CPU tensors). Every function here moves,
picks or rescales values without reordering a sum, so the comparisons
are exact (``assert_array_equal``), argmax/argmin ties included (the
first index), and ``print_matrix`` returns the same string; ``norm``'s
sums and ``ratio``'s total rtol 1e-6. The value-semantic ones
(``scatter``, ``set_diagonal``, ``copy``) leave their input as it was.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import matrix as jm

from raft_tpu_torch import matrix as tm

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _mat():
    rng = np.random.default_rng(11)
    m = (rng.integers(-4, 5, (9, 6)) * 0.5).astype(np.float32)
    m[2, 1] = 1e-6  # a small value for the thresholds and the printer
    return m


EXACT = {
    "argmax": lambda m, a: m.argmax(a),
    "argmin": lambda m, a: m.argmin(a),
    "col_wise_sort": lambda m, a: m.col_wise_sort(a),
    "col_wise_sort_desc": lambda m, a: m.col_wise_sort(a, ascending=False),
    "slice_matrix": lambda m, a: m.slice_matrix(a, 1, 2, 5, 6),
    "linewise_op": lambda m, a: m.linewise_op(a, a[0], lambda p, q: p - q),
    "linewise_op_cols": lambda m, a: m.linewise_op(
        a, a[:, 0], lambda p, q: p * q, along_rows=False),
    "reverse": lambda m, a: m.reverse(a),
    "reverse_cols": lambda m, a: m.reverse(a, axis=1),
    "sign_flip": lambda m, a: m.sign_flip(a),
    "triangular_upper": lambda m, a: m.triangular_upper(a),
    "get_diagonal": lambda m, a: m.get_diagonal(a),
    "set_diagonal": lambda m, a: m.set_diagonal(a, 7.0),
    "invert_diagonal": lambda m, a: m.invert_diagonal(a + 3.0),
    "copy": lambda m, a: m.copy(a),
    "power": lambda m, a: m.power(a, 2.0),
    "sqrt": lambda m, a: m.sqrt(a * a),
    "reciprocal": lambda m, a: m.reciprocal(a + 10.0, 2.0),
    "reciprocal_thres": lambda m, a: m.reciprocal(a, 1.0, thres=0.6),
    "zero_small_values": lambda m, a: m.zero_small_values(a, 0.6),
    "norm_linf": lambda m, a: m.norm(a, "linf"),
    "norm_l1_cols": lambda m, a: m.norm(a, "l1", axis=0),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_matrix_op_matches_jax(name):
    m = _mat()
    want = np.asarray(EXACT[name](jm, jnp.asarray(m)))
    t = torch.from_numpy(m.copy())
    got = EXACT[name](tm, t)
    assert got.dtype == {np.dtype(np.float32): torch.float32,
                         np.dtype(np.int32): torch.int32}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), m)  # the input is kept


def test_gather_scatter_norms_and_constants_match_jax():
    m = _mat()
    idx = np.array([4, 0, 4, 8], np.int32)
    np.testing.assert_array_equal(
        tm.gather(torch.from_numpy(m), torch.from_numpy(idx)).numpy(),
        np.asarray(jm.gather(jnp.asarray(m), jnp.asarray(idx))))
    rows = np.arange(12, dtype=np.float32).reshape(2, 6)
    t = torch.from_numpy(m.copy())
    got = tm.scatter(t, torch.tensor([1, 5]), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.scatter(
        jnp.asarray(m), jnp.asarray([1, 5]), jnp.asarray(rows))))
    np.testing.assert_array_equal(t.numpy(), m)
    for kind in ("l1", "l2", "l2sqrt"):
        np.testing.assert_allclose(
            tm.norm(torch.from_numpy(m), kind).numpy(),
            np.asarray(jm.norm(jnp.asarray(m), kind)), rtol=1e-6)
    np.testing.assert_allclose(tm.ratio(torch.from_numpy(m + 3)).numpy(),
                               np.asarray(jm.ratio(jnp.asarray(m + 3))),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tm.fill((3, 4), 2.5, device="cpu").numpy(),
        np.asarray(jm.fill((3, 4), 2.5)))
    np.testing.assert_array_equal(tm.eye(5, device="cpu").numpy(),
                                  np.asarray(jm.eye(5)))
    with pytest.raises(ValueError, match="norm type"):
        tm.norm(torch.from_numpy(m), "l3")


def test_print_matrix_gives_the_same_string(capsys):
    m = _mat()
    want = jm.print_matrix(jnp.asarray(m), "w")
    got = tm.print_matrix(torch.from_numpy(m), "w")
    assert got == want
    assert tm.ops.np_str(torch.from_numpy(m)) == jm.ops.np_str(
        jnp.asarray(m))
    assert capsys.readouterr().out == want + "\n" + got + "\n"
