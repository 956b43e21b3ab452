"""The kernel tri-states the port reads (``RAFT_TPU_PALLAS_LUTSCAN``,
``RAFT_TPU_PALLAS_GROUPED``, ``RAFT_TPU_PALLAS_REFINE``,
``RAFT_TPU_FP8_LUT``) against the JAX package's decisions, on the CPU.

For "on" and "off" both packages take the same tier, so the same seeded
numpy inputs give the same dispatch and fallback counters
(``ivf_pq.scan.*``, ``refine.dispatch``, ``ivf_pq.lut.dispatch``; the JAX
side counts them while ``obs`` records) and the same ids away from ties.
"on" runs the JAX package's kernels interpreted and the port's plain
versions. Under "auto" the JAX package takes its kernels on a TPU only,
the port on a card and on the CPU alike (its plain versions there), so
"auto" is checked against the port's own rule.

A JAX-built index (n 3,000, d 32, 16 lists, pq_dim 16, the bf16 cache
built) crosses to the port through ``from_numpy``.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jref
from raft_tpu.obs.metrics import MetricsRegistry
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as tref
from raft_tpu_torch.obs import spans as tspans

from torch_parity import blobs, jax_index_arrays, overlap

N, D = 3000, 32


@pytest.fixture(scope="module")
def case():
    x = blobs(N, D, 30, seed=71)
    q = blobs(40, D, 30, seed=72)
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=16, pq_dim=16, seed=0, cache_reconstruction="always"))
    tidx = tpq.from_numpy(*jax_index_arrays(jidx), device="cpu")
    return x, q, jidx, tidx


def _counters(snapshot, prefix):
    return {k: v for k, v in snapshot["counters"].items()
            if k.startswith(prefix)}


def _both(jfn, tfn, prefix):
    """Run each package's call with fresh counters → ((jax out, jax
    counters), (port out, port counters))."""
    reg = MetricsRegistry()
    jobs.enable(registry=reg, hbm=False)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jout = jfn()
    finally:
        jobs.disable()
    tspans.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tout = tfn()
    return ((jout, _counters(reg.snapshot(), prefix)),
            (tout, _counters(tspans.registry().snapshot(), prefix)))


def _search(case, sp, monkeypatch, env, value):
    x, q, jidx, tidx = case
    monkeypatch.setenv(env, value)
    return _both(
        lambda: jpq.search(jidx, jnp.asarray(q), 10, jpq.SearchParams(**sp)),
        lambda: tpq.search(tidx, q, 10, tpq.SearchParams(**sp),
                           device="cpu"),
        "ivf_pq.scan")


LUT = dict(n_probes=8, scan_select="pallas", lut_dtype="float32",
           scan_mode="grouped")


@pytest.mark.parametrize("value", ["on", "off"])
def test_lutscan_tristate_matches_jax(case, monkeypatch, value):
    """"off" falls to the approx grouped tier (its kernels off here too,
    so the JAX package's CPU run answers on its XLA tier, as the port)."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_GROUPED", "off")
    (jo, jc), (to, tc) = _search(case, LUT, monkeypatch,
                                 "RAFT_TPU_PALLAS_LUTSCAN", value)
    assert tc == jc, (tc, jc)
    want = ({"ivf_pq.scan.dispatch{impl=pallas_lut}": 1.0} if value == "on"
            else {"ivf_pq.scan.fallback{reason=kernel_ineligible}": 1.0,
                  "ivf_pq.scan.dispatch{impl=grouped_xla}": 1.0})
    assert tc == want
    assert overlap(to[1].numpy(), np.asarray(jo[1])) >= 0.99


@pytest.mark.parametrize("select,value", [("approx", "on"),
                                          ("approx", "off"),
                                          ("exact", "on"),
                                          ("exact", "off")])
def test_grouped_tristate_matches_jax(case, monkeypatch, select, value):
    sp = dict(n_probes=8, scan_select=select, lut_dtype="float32",
              scan_mode="grouped")
    (jo, jc), (to, tc) = _search(case, sp, monkeypatch,
                                 "RAFT_TPU_PALLAS_GROUPED", value)
    assert tc == jc, (tc, jc)
    kernel = "segk" if select == "approx" else "grouped_pallas"
    impl = kernel if value == "on" else "grouped_xla"
    assert tc == {f"ivf_pq.scan.dispatch{{impl={impl}}}": 1.0}
    assert overlap(to[1].numpy(), np.asarray(jo[1])) >= 0.99


@pytest.mark.parametrize("value", ["on", "off"])
def test_refine_tristate_matches_jax(case, monkeypatch, value):
    x, q, _, _ = case
    cand = np.random.default_rng(3).integers(0, N, (q.shape[0], 300)
                                             ).astype(np.int32)
    monkeypatch.setenv("RAFT_TPU_PALLAS_REFINE", value)
    (jo, jc), (to, tc) = _both(
        lambda: jref.refine(jnp.asarray(x), jnp.asarray(q),
                            jnp.asarray(cand), 10),
        lambda: tref.refine(x, q, cand, 10, device="cpu"),
        "refine.dispatch")
    impl = "pallas_gather" if value == "on" else "xla_gather"
    assert tc == jc == {f"refine.dispatch{{impl={impl}}}": 1.0}
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))


@pytest.mark.parametrize("value", ["on", "off", "auto"])
@pytest.mark.parametrize("n_probes,k,sel", [(64, 10, 1.0), (64, 10, 0.01),
                                            (20, 10, 1.0), (20, 400, 1.0)])
def test_fp8_lut_tristate_matches_jax(monkeypatch, value, n_probes, k, sel):
    monkeypatch.setenv("RAFT_TPU_FP8_LUT", value)
    (jd, jc), (td, tc) = _both(
        lambda: jpq.resolve_lut_dtype("auto", n_probes, k, selectivity=sel),
        lambda: tpq.resolve_lut_dtype("auto", n_probes, k, selectivity=sel),
        "ivf_pq.lut")
    assert td == jd
    assert tc == jc == {f"ivf_pq.lut.dispatch{{dtype={td}}}": 1.0}
    if value != "on":          # off the card "auto" is exact f32, as "off"
        assert td == "float32"
    assert tpq.resolve_lut_dtype("bfloat16", n_probes, k) == "bfloat16"


def test_auto_takes_the_kernel_tiers_on_the_port(case, monkeypatch):
    """Unset (auto), the port takes each kernel tier by shape (its plain
    versions on the CPU): the LUT scan, the segmented and grouped scans
    over the cache, and the fused re-rank at C ≥ 400 but not at C 300."""
    x, q, _, tidx = case
    for env in ("RAFT_TPU_PALLAS_LUTSCAN", "RAFT_TPU_PALLAS_GROUPED",
                "RAFT_TPU_PALLAS_REFINE"):
        monkeypatch.delenv(env, raising=False)
    tspans.reset()
    for sel in ("pallas", "approx", "exact"):
        tpq.search(tidx, q, 10, tpq.SearchParams(
            n_probes=8, scan_select=sel, lut_dtype="float32",
            scan_mode="grouped"), device="cpu")
    assert tspans.counts()["ivf_pq.scan.dispatch"] == {
        "pallas_lut": 1.0, "segk": 1.0, "grouped_pallas": 1.0}
    for C in (300, 400):
        cand = torch.randint(0, N, (q.shape[0], C), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(C))
        tref.refine(x, q, cand, 10, device="cpu")
    assert tspans.counts()["refine.dispatch"] == {
        "xla_gather": 1.0, "pallas_gather": 1.0}
