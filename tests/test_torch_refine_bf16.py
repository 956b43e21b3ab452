"""The re-rank against a bf16 dataset (ROADMAP A8): the port against the
JAX package, on the CPU.

The JAX package streams a bf16 base through its fused kernel with the rows'
dtype kept (``raft_tpu/neighbors/refine.py:147``); the port's fused tier
takes bf16 rows too, and any other dtype (int8) takes the gather tier, as
there. The JAX side runs its kernel interpreted under
``RAFT_TPU_PALLAS_REFINE=always``, the port its plain version.

Tolerances: 1e-5 relative on the keys, ids equal but where the keys tie
within it: both packages compute in f32 on the same bf16 values (the JAX
test's 2e-2, ``tests/test_refine.py:77-85``, is against its XLA tier).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import refine as jrefine
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as trefine
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.ops import kernels as K

from torch_parity import blobs, refine_case

METRICS = ["sqeuclidean", "inner_product", "cosine"]
_KEY = {"sqeuclidean": "l2", "inner_product": "ip", "cosine": "cos"}


def _t(a):
    return torch.tensor(np.asarray(a))


def _ids_equal_but_at_ties(d, i, rd, ri, tol):
    """ids equal wherever the reference keys do not tie their neighbour
    within ``tol`` (relative)."""
    rd, ri = np.asarray(rd, np.float64), np.asarray(ri)
    t = tol * np.maximum(np.abs(rd), 1.0)
    with np.errstate(invalid="ignore"):   # +inf slots: no tie, ids −1
        gap = np.abs(np.diff(rd, axis=1)) <= t[:, 1:]
    tie = np.zeros_like(rd, dtype=bool)
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    tie[:, -1] = True
    assert ((np.asarray(i) == ri) | tie).all()
    np.testing.assert_allclose(np.asarray(d), rd, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def case():
    data, q, cand = refine_case(seed=11, m=20, C=400, n=3000, d=48)
    return torch.tensor(data).to(torch.bfloat16), q, cand


@pytest.mark.parametrize("metric", METRICS)
def test_refine_bf16_is_the_plain_kernel(case, metric):
    """``refine`` on bf16 rows takes the fused tier (its dispatch counts
    ``pallas_gather``) and equals ``gather_refine_topk_plain`` on the same
    rows; the gather tier (C < 256) agrees with it."""
    xb, q, cand = case
    tspans.reset()
    d, i = trefine.refine(xb, _t(q), _t(cand), 10, metric=metric,
                          device="cpu")
    assert tspans.total("refine.dispatch", impl="pallas_gather") == 1
    pv, pi = K.gather_refine_topk_plain(xb, _t(q), _t(cand), 10,
                                        _KEY[metric])
    pd = -pv if metric == "inner_product" else pv
    assert torch.equal(i, pi) and torch.equal(d, pd)
    d_g, i_g = trefine.refine(xb, _t(q), _t(cand[:, :200]), 10,
                              metric=metric, device="cpu")
    assert tspans.total("refine.dispatch", impl="xla_gather") == 1
    pv, pi = K.gather_refine_topk_plain(xb, _t(q), _t(cand[:, :200]), 10,
                                        _KEY[metric])
    _ids_equal_but_at_ties(d_g, i_g, -pv if metric == "inner_product"
                           else pv, pi, 1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_refine_bf16_matches_jax(case, metric, monkeypatch):
    """The JAX package's interpreted kernel on the same bf16 rows."""
    xb, q, cand = case
    monkeypatch.setenv("RAFT_TPU_PALLAS_REFINE", "always")
    jb = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jd, ji = jrefine.refine(jb, jnp.asarray(q), jnp.asarray(cand), 10,
                            metric=metric)
    td, ti = trefine.refine(xb, _t(q), _t(cand), 10, metric=metric,
                            device="cpu")
    _ids_equal_but_at_ties(td.numpy(), ti.numpy(), jd, ji, 1e-5)


def test_refine_bf16_filtered_and_int8(case):
    """The filter words ride the bf16 fused tier; an int8 base takes the
    gather tier, as in the JAX package, with the rows' f32 keys."""
    from raft_tpu_torch.core import bitset

    xb, q, cand = case
    keep = np.random.default_rng(3).random(3000) < 0.3
    bits = bitset.from_mask(keep, device="cpu")
    tspans.reset()
    d, i = trefine.refine(xb, _t(q), _t(cand), 10, filter_bits=bits,
                          device="cpu")
    assert tspans.total("refine.dispatch", impl="pallas_gather",
                        filtered="1") == 1
    got = i.numpy()
    assert keep[got[got >= 0]].all()
    x8 = torch.clamp(xb.float() * 20, -127, 127).to(torch.int8)
    d8, i8 = trefine.refine(x8, _t(q), _t(cand), 10, device="cpu")
    assert tspans.total("refine.dispatch", impl="xla_gather") == 1
    pv, pi = K.gather_refine_topk_plain(x8.float(), _t(q), _t(cand), 10)
    _ids_equal_but_at_ties(d8, i8, pv, pi, 1e-5)


def test_ivf_search_reranks_against_a_bf16_base():
    """``search(..., refine="f32_regen", dataset=<bf16 tensor>)`` of both
    IVF indexes reaches the fused tier, and its answers are those of
    ``refine`` on the same scan candidates."""
    x = blobs(2500, 24, 20, seed=12)
    q = _t(blobs(30, 24, 20, seed=13))
    xb = _t(x).to(torch.bfloat16)
    pq = tpq.build(x, tpq.IndexParams(n_lists=8, pq_dim=8), device="cpu")
    fl = tfl.build(x, tfl.IndexParams(n_lists=8), device="cpu")
    for mod, idx in ((tpq, pq), (tfl, fl)):
        sp = mod.SearchParams(n_probes=4, refine="f32_regen",
                              refine_ratio=40)
        tspans.reset()
        d, i = mod.search(idx, q, 10, sp, dataset=xb, device="cpu")
        assert tspans.total("refine.dispatch", impl="pallas_gather") == 1
        _, cand = mod.search(idx, q, 400, mod.SearchParams(n_probes=4),
                             device="cpu")
        rd, ri = trefine.refine(xb, q, cand, 10, device="cpu")
        assert torch.equal(i, ri) and torch.equal(d, rd)
