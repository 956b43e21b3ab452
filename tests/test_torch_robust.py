"""The port's robust layer (``raft_tpu_torch.robust``) against the JAX
package's, on the CPU: the same fault plans, ladders, retry policies and
checkpoints driven through both packages give the same fires, rung paths,
sleeps and files; ``search_resilient`` of IVF-PQ and IVF-Flat under one
injected plan walks the same path in both, with results within the
tolerances of the index parity tests (ids overlap ≥ 0.99, distances at
rtol 1e-4 where the ids agree)."""

from __future__ import annotations

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.robust import checkpoint as jck
from raft_tpu.robust import degrade as jdg
from raft_tpu.robust import faults as jfa
from raft_tpu.robust import retry as jre
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.robust import checkpoint as tck
from raft_tpu_torch.robust import degrade as tdg
from raft_tpu_torch.robust import faults as tfa
from raft_tpu_torch.robust import retry as tre

from torch_parity import (blobs, jax_flat_arrays, jax_index_arrays,
                          overlap)


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfa, tfa):
        f.clear_plan()
    for d in (jdg, tdg):
        d.clear_recent()
    tspans.reset()
    yield
    for f in (jfa, tfa):
        f.clear_plan()


def _hits(fmod, sites):
    """Hit each site in turn; record what each hit did."""
    out = []
    for s in sites:
        try:
            out.append(fmod.faultpoint(s))
        except fmod.InjectedResourceExhausted:
            out.append("raised-oom")
        except fmod.FaultInjected:
            out.append("raised-error")
    return out


PLANS = {
    "after_times": {"faults": [{"site": "a", "kind": "oom", "after": 2,
                                "times": 2}]},
    "first_match": {"faults": [{"site": "a", "kind": "error", "times": 1},
                               {"site": "a", "kind": "force", "times": 0}]},
    "probability": {"seed": 11, "faults": [
        {"site": "a", "kind": "nan", "p": 0.4, "times": 0},
        {"site": "b", "kind": "force", "p": 0.7, "times": 3}]},
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plans_fire_alike(name):
    """One plan JSON and one sequence of hits: the same outcome per hit,
    the same fires() and describe() in both packages."""
    sites = list("aabababaaabbab") + ["c"]
    got = []
    for f in (jfa, tfa):
        f.install_plan(json.dumps(PLANS[name]))
        got.append((_hits(f, sites), f.fires(), f.active_plan().describe()))
    assert got[0] == got[1]
    assert tspans.total("faults.fired") == sum(got[1][1].values())


def test_fault_plan_arms_from_env_and_corrupts_alike(monkeypatch,
                                                     tmp_path):
    plan = {"faults": [{"site": "x", "kind": "nan", "times": 1}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    out = []
    for f in (jfa, tfa):
        f._plan, f._env_checked = None, False
        monkeypatch.setenv("RAFT_TPU_FAULT_PLAN", str(path))
        v = f.corrupt("x", np.ones(3, np.float32))
        out.append((np.isnan(v).all(), f.fires(),
                    f.corrupt("x", np.ones(3, np.float32)).tolist()))
    assert out[0] == out[1] == (True, {"x": 1}, [1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfa.install_plan({"faults": [{"site": "x", "kind": "boom"}]})


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

def _walk(dg, params, dataset, has_lut, n=9, gate=None):
    ladder = dg.standard_search_ladder(64, has_lut=has_lut)
    knobs = {"params": params, "dataset": dataset}
    names = []
    with dg.quality_gate(gate):
        for _ in range(n):
            adv = ladder.advance(knobs)
            if adv is None:
                break
            step, knobs = adv
            names.append(step.name)
    p = knobs["params"]
    host = isinstance(knobs["dataset"], np.ndarray)
    return names, (getattr(p, "lut_dtype", None), p.scan_select, p.scan_mode,
                   p.refine_transfer, knobs.get("max_batch"), host)


WALKS = [
    (True, dict(scan_select="pallas", lut_dtype="float32"), None),
    (True, dict(scan_select="pallas", lut_dtype="bfloat16",
                refine="f32_regen"), "resident"),
    (True, dict(scan_select="approx", lut_dtype="auto",
                refine="f32_regen", refine_transfer="tiered"), "host"),
    (True, dict(lut_dtype="float8_e4m3", refine="f32_regen"), "resident"),
    (False, dict(scan_select="exact", refine="f32_regen"), "resident"),
    (False, dict(scan_mode="per_query"), None),
]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("case", range(len(WALKS)))
def test_standard_ladder_walks_alike(case, gated):
    """The same knobs walk the same rungs to the same knobs in both
    packages, with and without a quality gate refusing every rung that
    trades recall. A device dataset (a JAX array; a tensor in the port)
    is demoted to a numpy array; a numpy one is already on the host."""
    has_lut, kw, ds = WALKS[case]
    x = np.ones((8, 4), np.float32)
    jds = {"resident": jnp.asarray(x), "host": x, None: None}[ds]
    tds = {"resident": torch.from_numpy(x), "host": x, None: None}[ds]
    gate = (lambda rung: True) if gated else None
    mod = jpq if has_lut else jfl
    tmod = tpq if has_lut else tfl
    j = _walk(jdg, mod.SearchParams(**kw), jds, has_lut, gate=gate)
    t = _walk(tdg, tmod.SearchParams(**kw), tds, has_lut, gate=gate)
    assert j == t
    if gated:
        assert not set(t[0]) & set(tdg.QUALITY_RUNGS)
        assert tspans.total("degrade.refused", reason="recall_floor") > 0


def _always_oom(oom_exc):
    def call(knobs):
        raise oom_exc
    return call


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_exhausted_and_deadline_walks_alike():
    """An always-failing call exhausts the same path in both packages, and
    a Deadline that expires mid-walk aborts both at the same rung."""
    paths = []
    for dg, fa in ((jdg, jfa), (tdg, tfa)):
        ladder = dg.Ladder([dg.Step("a", lambda kn: {**kn, "a": 1}),
                            dg.Step("b", lambda kn: {**kn, "b": 1})])
        with pytest.raises(dg.DegradationExhausted) as ei:
            dg.run_with_degradation(_always_oom(
                fa.InjectedResourceExhausted("s")), {}, ladder, site="t")
        clock = _Clock()
        deadline = dg.Deadline(1.0, clock=clock)

        def call(knobs, clock=clock, fa=fa):
            clock.t += 0.4
            raise fa.InjectedResourceExhausted("s")

        dg.clear_recent()
        with pytest.raises(dg.DeadlineExceeded):
            dg.run_with_degradation(
                call, {"params": jpq.SearchParams()},
                dg.standard_search_ladder(16, has_lut=False), site="t",
                deadline=deadline)
        paths.append((ei.value.path, [s["to"] for s in dg.recent_steps()]))
    assert paths[0] == paths[1] == (["a", "b"],
                                    ["halve_batch", "decline_fused"])
    assert tspans.total("degrade.exhausted", site="t") == 1
    assert tspans.total("degrade.deadline_abort", site="t") == 1


# ---------------------------------------------------------------------------
# retry and the classifiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fail,budget", [(0, None), (2, None), (5, None),
                                           (2, 0.3)])
def test_retry_call_under_io_policy_alike(n_fail, budget):
    """retry_call under IO_POLICY with an injected clock, sleep and rng:
    the same attempts, sleeps, outcome and error type in both packages."""
    out = []
    for re_ in (jre, tre):
        clock = _Clock()
        slept = []

        def sleep(s, clock=clock, slept=slept):
            slept.append(round(s, 12))
            clock.t += s

        fails = [n_fail]

        def fn():
            if fails[0]:
                fails[0] -= 1
                raise OSError("transient read")
            return "ok"

        stats = {}
        dl = None if budget is None else re_.Deadline(budget, clock=clock)
        try:
            res = re_.retry_call(fn, site="serve.row_read",
                                 policy=re_.IO_POLICY, deadline=dl,
                                 stats=stats, sleep=sleep,
                                 rng=random.Random(0))
        except (re_.RetryExhausted, re_.DeadlineExceeded) as e:
            res = type(e).__name__
        out.append((res, stats["attempts"], stats["outcome"], slept))
    assert out[0] == out[1]
    assert tspans.total("retry.attempts", site="serve.row_read") == out[1][1]


def test_classifiers():
    """A torch OOM is RESOURCE_EXHAUSTED by type; CUDA runtime errors —
    the sticky launch time-out among them, whose text carries "timed
    out" — and the port's launch failure are never retried; the rest
    classify as in the JAX package."""
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    assert tre.is_resource_exhausted(oom) and tdg.is_resource_exhausted(oom)
    assert not tre.default_retryable(oom)
    for msg in ("CUDA error: the launch timed out and was terminated",
                "ivfpq_lut_scan_topk: CUDA error 702 at launch"):
        assert jre.default_retryable(RuntimeError(msg)) == (
            "timed out" in msg)  # the JAX package's reading
        assert not tre.default_retryable(RuntimeError(msg))
        assert tre.is_cuda_error(RuntimeError(msg))
    if hasattr(torch, "AcceleratorError"):
        assert tre.is_cuda_error(torch.AcceleratorError("any"))
    for exc in (RuntimeError("RESOURCE_EXHAUSTED: x"), ValueError("nope"),
                RuntimeError("UNAVAILABLE: socket"), TimeoutError("t"),
                RuntimeError("request timed out"),
                tfa.FaultInjected("s"), tre.DeadlineExceeded("s")):
        jexc = exc
        if isinstance(exc, tfa.FaultInjected):
            jexc = jfa.FaultInjected("s")
        if isinstance(exc, tre.DeadlineExceeded):
            jexc = jre.DeadlineExceeded("s")
        assert tre.default_retryable(exc) == jre.default_retryable(jexc)
        assert tre.is_resource_exhausted(exc) == jre.is_resource_exhausted(
            jexc)


# ---------------------------------------------------------------------------
# checkpoints cross between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    x = np.random.default_rng(0).standard_normal((9000, 24)).astype(
        np.float32)
    params = {"n_lists": 64, "pq_dim": 8, "chunk_rows": 4096}
    assert tck.dataset_fingerprint(x) == jck.dataset_fingerprint(x)
    assert tck.dataset_fingerprint(torch.from_numpy(x)) == \
        jck.dataset_fingerprint(jnp.asarray(x))
    assert tck.params_fingerprint(params) == jck.params_fingerprint(params)
    ds_sha, p_sha, _ = tck.fingerprints_once(x, params)
    w, r = (jck, tck) if writer == "jax" else (tck, jck)
    ck = w.BuildCheckpoint(str(tmp_path))
    ck.write_manifest({"dataset_sha": ds_sha, "params_sha": p_sha,
                       "phase": "encode", "chunks_done": 1})
    ck.save_arrays("quantizers", centers=x[:64])
    ck.save_shard(0, codes=np.arange(12, dtype=np.uint8))
    ck.save_shard(3, shard=2, codes=np.arange(5, dtype=np.uint8))
    rd = r.BuildCheckpoint(str(tmp_path))
    man = rd.load_manifest()
    rd.validate_manifest(man, ds_sha, p_sha)
    np.testing.assert_array_equal(rd.load_arrays("quantizers")["centers"],
                                  x[:64])
    assert rd.load_shard(0)["codes"].tolist() == list(range(12))
    assert rd.load_shard(3, shard=2)["codes"].tolist() == list(range(5))
    with pytest.raises(Exception, match="different dataset"):
        rd.validate_manifest(man, "0" * 64, p_sha)
    with pytest.raises(Exception, match="missing"):
        rd.load_shard(1)


# ---------------------------------------------------------------------------
# search_resilient through both packages
# ---------------------------------------------------------------------------

N, D = 3000, 32


@pytest.fixture(scope="module")
def corpus():
    return blobs(N, D, 30, seed=21), blobs(64, D, 30, seed=22)


@pytest.fixture(scope="module")
def pq_pair(corpus):
    x, _ = corpus
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=16, pq_dim=16, seed=0, cache_reconstruction="never"))
    arrays, meta = jax_index_arrays(jidx)
    return jidx, tpq.from_numpy(arrays, meta, device="cpu")


@pytest.fixture(scope="module")
def flat_pair(corpus):
    x, _ = corpus
    jidx = jfl.build(jnp.asarray(x), jfl.IndexParams(n_lists=16, seed=0))
    arrays, meta = jax_flat_arrays(jidx)
    return jidx, tfl.from_numpy(arrays, meta, device="cpu")


def _resilient(mod, index, q, k, sp, dataset, plan, **kw):
    fa, dg = (jfa, jdg) if mod in (jpq, jfl) else (tfa, tdg)
    dg.clear_recent()
    fa.install_plan(plan)
    d, i = mod.search_resilient(index, q, k, sp, dataset=dataset, **kw)
    fa.clear_plan()
    return np.asarray(d), np.asarray(i), [s["to"] for s in
                                          dg.recent_steps()]


def _assert_close(td, ti, jd, ji):
    assert overlap(ti, ji) >= 0.99
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-4, atol=1e-4)


PQ_CASES = {
    # the chip smoke's [resilient] plan on the main path's knobs
    "main_path": (chip_smoke.RESILIENT_PLAN,
                  dict(n_probes=8, scan_select="pallas", refine="f32_regen",
                       refine_ratio=10, lut_dtype="bfloat16"), "resident"),
    "per_query": ({"faults": [{"site": "ivf_pq.search", "kind": "oom",
                               "times": 2}]},
                  dict(n_probes=8, scan_mode="per_query",
                       lut_dtype="float32"), None),
    # every rung of the standard ladder, demote_raw and host_gather included
    "every_rung": ({"faults": [{"site": "ivf_pq.search", "kind": "oom",
                                "times": 7}]},
                   dict(n_probes=8, scan_select="pallas", refine="f32_regen",
                        refine_ratio=10, lut_dtype="float32"), "resident"),
    "host_base": ({"faults": [{"site": "ivf_pq.search", "kind": "oom",
                               "times": 4}]},
                  dict(n_probes=8, scan_select="pallas", refine="f32_regen",
                       refine_ratio=10, lut_dtype="auto"), "host"),
}


@pytest.mark.parametrize("case", sorted(PQ_CASES))
def test_ivf_pq_search_resilient_alike(case, corpus, pq_pair, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    monkeypatch.setenv("RAFT_TPU_PALLAS_REFINE", "always")
    x, q = corpus
    plan, kw, ds = PQ_CASES[case]
    jidx, tidx = pq_pair
    jds = {"resident": jnp.asarray(x), "host": x, None: None}[ds]
    tds = {"resident": torch.from_numpy(x), "host": x, None: None}[ds]
    jd, ji, jpath = _resilient(jpq, jidx, jnp.asarray(q), 10,
                               jpq.SearchParams(**kw), jds, plan)
    td, ti, tpath = _resilient(tpq, tidx, torch.from_numpy(q), 10,
                               tpq.SearchParams(**kw), tds, plan,
                               device="cpu")
    assert tpath == jpath
    if case == "main_path":
        assert tpath == chip_smoke.RESILIENT_PATH
    if case == "every_rung":
        assert tpath == ["halve_batch", "bf16_lut", "fp8_lut", "demote_raw",
                         "decline_fused", "decline_fused", "host_gather"]
    _assert_close(td, ti, jd, ji)
    assert tspans.total("degrade.recovered", site="ivf_pq.search") == 1
    assert tspans.total("faults.fired", site="ivf_pq.search") == \
        plan["faults"][0]["times"]


def test_ivf_flat_search_resilient_alike(corpus, flat_pair):
    x, q = corpus
    jidx, tidx = flat_pair
    plan = {"faults": [{"site": "ivf_flat.search", "kind": "oom",
                        "times": 3}]}
    kw = dict(n_probes=8, scan_mode="grouped", scan_select="exact",
              refine="f32_regen", refine_ratio=4)
    jd, ji, jpath = _resilient(jfl, jidx, jnp.asarray(q), 10,
                               jfl.SearchParams(**kw), jnp.asarray(x), plan)
    td, ti, tpath = _resilient(tfl, tidx, torch.from_numpy(q), 10,
                               tfl.SearchParams(**kw), torch.from_numpy(x),
                               plan, device="cpu")
    assert tpath == jpath == ["halve_batch", "demote_raw", "decline_fused"]
    _assert_close(td, ti, jd, ji)


def test_resilient_results_equal_a_direct_call_with_the_final_knobs(
        corpus, pq_pair):
    """The degraded walk's answer is the answer of its final knobs: the
    chip smoke's check, here on the CPU."""
    x, q = corpus
    _, tidx = pq_pair
    sp = tpq.SearchParams(n_probes=8, scan_select="pallas",
                          refine="f32_regen", refine_ratio=10,
                          lut_dtype="bfloat16")
    td, ti, path = _resilient(tpq, tidx, torch.from_numpy(q), 10, sp,
                              torch.from_numpy(x),
                              chip_smoke.RESILIENT_PLAN, device="cpu")
    ladder = tdg.standard_search_ladder(q.shape[0], has_lut=True)
    knobs = {"params": sp, "dataset": torch.from_numpy(x)}
    for name in path:
        step, knobs = ladder.advance(knobs)
        assert step.name == name
    mb = knobs["max_batch"]
    outs = [tpq.search(tidx, torch.from_numpy(q[a:a + mb]), 10,
                       knobs["params"], dataset=knobs["dataset"],
                       device="cpu") for a in range(0, q.shape[0], mb)]
    np.testing.assert_array_equal(ti, torch.cat([o[1] for o in outs]))
    np.testing.assert_array_equal(td, torch.cat([o[0] for o in outs]))


def test_forced_mem_guard_declines_count_degrade_steps(corpus, pq_pair):
    """``refine.mem_guard`` and ``ivf_pq.scan.mem_guard`` force faults take
    the decline branch and count it, as in the JAX package."""
    x, q = corpus
    _, tidx = pq_pair
    from raft_tpu_torch.neighbors import refine as trefine

    tfa.install_plan({"faults": [
        {"site": "refine.mem_guard", "kind": "force", "times": 1},
        {"site": "ivf_pq.scan.mem_guard", "kind": "force", "times": 1}]})
    cand = np.random.default_rng(0).integers(0, N, (8, 400)).astype(
        np.int32)
    trefine.refine(torch.from_numpy(x), torch.from_numpy(q[:8]),
                   torch.from_numpy(cand), 5, device="cpu")
    tpq.search(tidx, torch.from_numpy(q), 10, tpq.SearchParams(
        n_probes=8, scan_select="pallas"), device="cpu")
    c = tspans.counts()
    assert tspans.total("degrade.steps", site="refine", to="xla_gather",
                        reason="mem_guard") == 1
    assert tspans.total("degrade.steps", site="ivf_pq.search",
                        to="grouped_approx", reason="mem_guard") == 1
    assert c["refine.dispatch"]["xla_gather"] == 1
    assert "pallas_lut" not in c["ivf_pq.scan.dispatch"]
    assert c["ivf_pq.scan.fallback"]["mem_guard"] == 1


def test_no_fault_means_no_degrade_counters(corpus, pq_pair):
    x, q = corpus
    _, tidx = pq_pair
    tpq.search_resilient(tidx, torch.from_numpy(q[:16]), 5,
                         device="cpu")
    assert not [s for s in tspans.counts() if s.startswith("degrade.")]
