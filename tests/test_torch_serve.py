"""The port's serving plane (``raft_tpu_torch.serve``) against the JAX
package's (``raft_tpu.serve``), on the CPU: buckets, the registry's
admission plans, dispatch, the micro-batching server and request tracing.

Both packages serve the same index: it is built once by the JAX package
(4,000 × 32 rows, 32 lists, pq_dim 8; IVF-Flat 32 lists) and handed to the
port through ``from_numpy``. The port's registries and servers run with
``device="cpu"`` (asked for); every server is stopped in a ``finally`` and
every future is awaited with a timeout.

Tolerances: served ids equal the other package's and the direct search's
exactly; distances within rtol 1e-4, atol 1e-4 of the other package's (the
index parity tests' tolerance) and equal to the port's own direct search.
Admission plans, counters, shed reasons, ladder paths and event fields are
compared for equality.
"""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import capacity as jcap
from raft_tpu.obs import trace as jtrace
from raft_tpu.obs.metrics import MetricsRegistry as JReg
from raft_tpu.robust import degrade as jdg
from raft_tpu.robust import faults as jfa
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import capacity as tcap
from raft_tpu_torch.obs import trace as ttrace
from raft_tpu_torch.obs.metrics import MetricsRegistry as TReg
from raft_tpu_torch.robust import degrade as tdg
from raft_tpu_torch.robust import faults as tfa
from raft_tpu_torch.serve import dispatch as tdispatch

from torch_parity import jax_flat_arrays, jax_index_arrays

N, DIM = 4000, 32
TIMEOUT = 60.0
PQ_KW = dict(n_probes=8, scan_mode="per_query", lut_dtype="float32")
FLAT_KW = dict(n_probes=8)


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfa, tfa):
        f.clear_plan()
    for d in (jdg, tdg):
        d.clear_recent()
    yield
    for f in (jfa, tfa):
        f.clear_plan()
    for o in (jobs, tobs):
        o.disable()
    for c in (jcap, tcap):
        c.clear_model()


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).random((N, DIM), dtype=np.float32)


@pytest.fixture(scope="module")
def indexes(data):
    """{"j": (pq, flat), "t": (pq, flat)} — one index per kind, built by
    the JAX package and handed to the port."""
    jp = jpq.build(jnp.asarray(data), jpq.IndexParams(
        n_lists=32, pq_dim=8, seed=0, cache_reconstruction="never"))
    jf = jfl.build(jnp.asarray(data), jfl.IndexParams(n_lists=32))
    tp = tpq.from_numpy(*jax_index_arrays(jp), device="cpu")
    tf = tfl.from_numpy(*jax_flat_arrays(jf), device="cpu")
    return {"j": (jp, jf), "t": (tp, tf)}


class _Pkg:
    """One package's serving surface, so a scenario runs on both."""

    def __init__(self, which, indexes):
        self.which = which
        j = which == "j"
        self.serve = jserve if j else tserve
        self.obs = jobs if j else tobs
        self.faults = jfa if j else tfa
        self.degrade = jdg if j else tdg
        self.trace = jtrace if j else ttrace
        self.capacity = jcap if j else tcap
        self.Reg = JReg if j else TReg
        self.pq_mod = jpq if j else tpq
        self.flat_mod = jfl if j else tfl
        self.pq, self.flat = indexes[which]
        self.pq_params = self.pq_mod.SearchParams(**PQ_KW)
        self.flat_params = self.flat_mod.SearchParams(**FLAT_KW)

    def registry(self, **kw):
        if self.which == "t":
            kw.setdefault("device", "cpu")
        return self.serve.IndexRegistry(**kw)

    def dataset(self, a):
        """A device-resident re-rank base: a JAX array, or a tensor on
        the port's CPU registry's device."""
        return jnp.asarray(a) if self.which == "j" else torch.from_numpy(a)

    def enable(self, **kw):
        reg = self.Reg()
        self.obs.enable(registry=reg, hbm=False, **kw)
        return reg

    def pq_registry(self, flat=False, **admit):
        reg = self.registry(budget_bytes=1 << 30)
        reg.admit("pq", self.pq, params=self.pq_params, default_k=10,
                  **admit)
        if flat:
            reg.admit("flat", self.flat, params=self.flat_params,
                      default_k=10)
        return reg

    def server(self, reg, **cfg):
        return self.serve.MicroBatchServer(reg,
                                           self.serve.ServerConfig(**cfg))

    def direct(self, rows, flat=False):
        if flat:
            mod, idx, p = self.flat_mod, self.flat, self.flat_params
        else:
            mod, idx, p = self.pq_mod, self.pq, self.pq_params
        if self.which == "j":
            d, i = mod.search(idx, jnp.asarray(rows), 10, p)
        else:
            d, i = mod.search(idx, torch.from_numpy(rows), 10, p,
                              device="cpu")
        return np.asarray(d), np.asarray(i)


@pytest.fixture(scope="module")
def pkgs(indexes):
    return _Pkg("j", indexes), _Pkg("t", indexes)


def _counters(reg, prefix=""):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith(prefix)}


def _outcome(fut):
    """A resolved future's outcome (awaited with a timeout)."""
    try:
        return ("ok", fut.result(timeout=TIMEOUT))
    except (jserve.ShedError, tserve.ShedError) as e:
        return ("shed", e.reason)
    except (jserve.DeadlineExceeded, tserve.DeadlineExceeded):
        return ("deadline", None)


def _served(srv, name, rows, k=10, **kw):
    """Submit every row (one request each) and await them."""
    futs = [srv.submit(name, r, k, **kw) for r in rows]
    return [_outcome(f) for f in futs]


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 5, 8, 33, 512])
def test_buckets_equal(max_batch):
    b = tserve.bucket_sizes(max_batch)
    assert b == jserve.bucket_sizes(max_batch)
    for n in range(1, b[-1] + 1):
        assert tserve.bucket_for(n, b) == jserve.bucket_for(n, b)


def test_invalid_max_batch_raises_in_both():
    for s in (jserve, tserve):
        with pytest.raises(ValueError):
            s.bucket_sizes(0)


# ---------------------------------------------------------------------------
# registry: admission plans with explicit size_bytes
# ---------------------------------------------------------------------------

def _scenario_lru(p):
    reg = p.registry(budget_bytes=400, headroom_frac=0.0)
    for name in ("t1", "t2", "t3"):
        reg.admit(name, object(), size_bytes=100)
    time.sleep(0.002)
    reg.get("t1")
    reg.get("t3")
    reg.admit("t4", object(), size_bytes=150)
    return reg


def _scenario_demote_first(p):
    """Raw vectors on the device are demoted, coldest first, before any
    eviction; a later admission past every demotion evicts."""
    ds = np.zeros((50, 1), np.float32)  # 200 B
    reg = p.registry(budget_bytes=1000, headroom_frac=0.0)
    reg.admit("a", object(), size_bytes=400, dataset=p.dataset(ds))
    time.sleep(0.002)
    reg.admit("b", object(), size_bytes=400, dataset=p.dataset(ds))
    time.sleep(0.002)
    reg.admit("c", object(), size_bytes=400)
    reg.admit("d", object(), size_bytes=500)
    return reg


def _scenario_pinned(p):
    reg = p.registry(budget_bytes=300, headroom_frac=0.0)
    reg.admit("pinned", object(), size_bytes=200, pinned=True)
    try:
        reg.admit("big", object(), size_bytes=200)
    except p.serve.AdmissionError:
        pass
    return reg


def _scenario_hot_swap(p):
    reg = p.registry(budget_bytes=1000, headroom_frac=0.0)
    reg.admit("prod", object(), size_bytes=600)
    reg.admit("pinned_other", object(), size_bytes=300, pinned=True)
    for size in (1100, 800):
        try:
            reg.admit("prod", object(), size_bytes=size)
        except p.serve.AdmissionError:
            pass
    reg.admit("small", object(), size_bytes=50)
    reg.admit("small", object(), size_bytes=60)  # replaces
    reg.mark("small", "evicted")
    return reg


def _scenario_promote(p):
    """An explicit eviction re-promotes the pressure-demoted tenant."""
    ds = np.zeros((50, 1), np.float32)
    reg = p.registry(budget_bytes=1000, headroom_frac=0.0)
    reg.admit("a", object(), size_bytes=500, dataset=p.dataset(ds))
    time.sleep(0.002)
    reg.admit("b", object(), size_bytes=450)
    reg.evict("b")
    return reg


def _scenario_preemptive(p):
    """An installed capacity model whose trend saturates inside the
    horizon demotes additional raw tiers at admission."""
    now = [0.0]
    ds = np.zeros((25, 1), np.float32)  # 100 B
    reg = p.registry(budget_bytes=2000, headroom_frac=0.0)
    for name in ("a", "b", "c"):
        reg.admit(name, object(), size_bytes=300, dataset=p.dataset(ds))
        time.sleep(0.002)
    level = [900.0]
    model = p.capacity.CapacityModel(
        resident_bytes=lambda: level[0], usable_bytes=lambda: 2000.0,
        policy=p.capacity.CapacityPolicy(horizon_s=100.0, min_points=3),
        clock=lambda: now[0])
    for t in range(4):
        now[0] = float(t)
        level[0] = 900.0 + 100.0 * t
        model.tick()
    p.capacity.set_model(model)
    try:
        reg.admit("d", object(), size_bytes=400)
    finally:
        p.capacity.clear_model(model)
    return reg


SCENARIOS = {"lru": _scenario_lru, "demote_first": _scenario_demote_first,
             "pinned": _scenario_pinned, "hot_swap": _scenario_hot_swap,
             "promote": _scenario_promote,
             "preemptive": _scenario_preemptive}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_admission_plans_match_jax(pkgs, name):
    """One script of admissions with explicit sizes: the same states,
    placements, demotions, resident bytes and serve.registry counters."""
    got = []
    for p in pkgs:
        mreg = p.enable()
        reg = SCENARIOS[name](p)
        tenants = {t.name: (t.state, t.size_bytes, t.demoted,
                            None if t.placement is None
                            else t.placement.raw,
                            type(t.dataset).__name__ == "ndarray")
                   for t in reg.tenants()}
        got.append((tenants, reg.resident_bytes(),
                    _counters(mreg, "serve.registry.")))
        p.obs.disable()
    assert got[0] == got[1]


def test_admission_errors_match_jax(pkgs):
    for p in pkgs:
        reg = p.registry(budget_bytes=100, headroom_frac=0.1)
        with pytest.raises(p.serve.AdmissionError, match="usable budget"):
            reg.admit("big", object(), size_bytes=95)
        with pytest.raises(p.serve.AdmissionError, match="raw='hbm'"):
            reg.admit("x", object(), size_bytes=1,
                      placement=p.serve.Placement(raw="hbm"))
        with pytest.raises(p.serve.TenantUnknown):
            reg.get("nope")
        reg.admit("a", object(), size_bytes=10)
        reg.mark("a", "failed")
        with pytest.raises(p.serve.TenantUnknown) as ei:
            reg.peek("a")
        assert ei.value.state == "failed"


def test_admit_faultpoint_is_armed(pkgs):
    for p in pkgs:
        p.faults.install_plan({"faults": [
            {"site": "serve.registry.admit", "kind": "error", "times": 1}]})
        reg = p.registry(budget_bytes=1000)
        with pytest.raises(p.faults.FaultInjected):
            reg.admit("a", object(), size_bytes=10)
        reg.admit("a", object(), size_bytes=10)
        p.faults.clear_plan()
        assert reg.describe()["resident_bytes"] == 10


def test_declared_host_placement_demotes_at_admission(pkgs):
    ds = np.ones((10, 4), np.float32)
    got = []
    for p in pkgs:
        reg = p.registry(budget_bytes=1000)
        t = reg.admit("a", object(), size_bytes=10,
                      dataset=p.dataset(ds),
                      placement=p.serve.Placement(raw="host"))
        got.append((type(t.dataset).__name__, t.placement.raw,
                    t.raw_hbm_bytes))
    assert got[0] == got[1] == ("ndarray", "host", 0)


def test_index_device_bytes_by_tier(pkgs):
    """A CPU tensor, numpy array or memmap is host; a tensor on the card is
    hbm. On a CPU registry (``device="cpu"``) the CPU tensors are what it
    charges, as the JAX package charges its CPU backend's arrays."""
    jp, tp = pkgs[0].pq, pkgs[1].pq
    assert tserve.index_device_bytes(tp) == 0
    on_cpu = tserve.index_device_bytes(tp, "cpu")
    fields = ("centers", "centers_rot", "rotation", "codebooks",
              "packed_codes", "packed_ids", "packed_norms", "list_sizes")
    assert on_cpu == sum(getattr(tp, f).nbytes for f in fields)
    assert on_cpu == sum(int(np.asarray(getattr(jp, f)).nbytes)
                         for f in fields)
    ds = np.zeros((100, DIM), np.float32)
    assert tserve.index_bytes_by_tier(tp, ds) == {
        "hbm": 0, "host": on_cpu + ds.nbytes}
    assert tserve.index_bytes_by_tier(tp, torch.from_numpy(ds), "cpu") == {
        "hbm": on_cpu + ds.nbytes, "host": 0}
    split_j = jserve.index_bytes_by_tier(jp, ds)
    assert split_j["host"] == ds.nbytes and split_j["hbm"] >= on_cpu


def test_registry_and_server_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.IndexRegistry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.IndexRegistry(budget_bytes=1 << 20)
    reg = tserve.IndexRegistry(device="cpu")
    from raft_tpu.serve import registry as jr
    from raft_tpu_torch.serve import registry as tr
    assert reg.budget_bytes == tr.DEFAULT_BUDGET_BYTES == \
        jr.DEFAULT_BUDGET_BYTES

    class _Duck:  # a registry that names no device is a card's
        pass

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.MicroBatchServer(_Duck())


def test_admit_refuses_an_index_on_another_device():
    class _OnCard:
        device = torch.device("cuda", 0)

    reg = tserve.IndexRegistry(device="cpu")
    with pytest.raises(tserve.AdmissionError, match="never moved"):
        reg.admit("x", _OnCard(), size_bytes=10)


def test_compile_cache_dir_has_no_counterpart():
    reg = tserve.IndexRegistry(device="cpu")
    with pytest.raises(ValueError, match="compile_cache_dir"):
        tserve.MicroBatchServer(reg, tserve.ServerConfig(
            compile_cache_dir="/nonexistent"))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_dispatch_runs_on_the_index_device_and_counts_cost(pkgs):
    p = pkgs[1]
    mreg = p.enable()
    reg = p.pq_registry()
    ledger = tobs.cost.CostLedger()
    tobs.cost.set_ledger(ledger)
    try:
        t = reg.peek("pq")
        q = torch.zeros((4, DIM))
        d, i = tdispatch.dispatch_batch(t, q, 10, registry=reg)
    finally:
        tobs.cost.clear_ledger(ledger)
    assert d.device.type == "cpu" and i.shape == (4, 10)
    assert ledger.conservation()["rel_err"] == 0.0
    assert ledger.device_seconds()["pq"] > 0
    assert mreg.snapshot()["histograms"]["span.serve.dispatch"]["count"] == 1
    with pytest.raises(tserve.DeadlineExceeded):
        tdispatch.dispatch_batch(t, q, 10, deadline=tserve.Deadline(0.0))
    assert tdispatch.resilient_entry(p.pq) is tpq.search_resilient
    assert tdispatch.resilient_entry(p.flat) is tfl.search_resilient
    with pytest.raises(TypeError):
        tdispatch.resilient_entry(object())


def test_dispatch_retry_policy_matches_jax():
    from raft_tpu.serve import dispatch as jdispatch

    def fields(p):
        return {k: v for k, v in p.__dict__.items() if k != "retryable"}

    assert (fields(tdispatch.DISPATCH_RETRY_POLICY)
            == fields(jdispatch.DISPATCH_RETRY_POLICY))


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def test_single_query_parity_with_jax(pkgs, data):
    got = []
    for p in pkgs:
        reg = p.pq_registry()
        srv = p.server(reg, max_batch=8, linger_s=0.001,
                       default_slo_s=None)
        srv.start()
        try:
            outs = [srv.search("pq", data[j], 10, timeout_s=TIMEOUT)
                    for j in (7, 100, 2500)]
            state = reg.get("pq").state
        finally:
            srv.stop()
        d_ref, i_ref = p.direct(data[[7, 100, 2500]])
        for (d, i), dr, ir in zip(outs, d_ref, i_ref):
            np.testing.assert_array_equal(i, ir)
            np.testing.assert_allclose(d, dr, rtol=1e-5, atol=1e-5)
        got.append((outs, state))
    (jo, js), (to, ts) = got
    assert js == ts == "serving"
    for (jd, ji), (td, ti) in zip(jo, to):
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_coalesced_batch_matches_per_query(pkgs, data):
    got = []
    for p in pkgs:
        mreg = p.enable()
        reg = p.pq_registry()
        srv = p.server(reg, max_batch=8, linger_s=0.05, default_slo_s=None)
        srv.start()
        try:
            outs = _served(srv, "pq", data[:8])
        finally:
            srv.stop()
        _, i_ref = p.direct(data[:8])
        ids = np.stack([o[1][1] for o in outs])
        np.testing.assert_array_equal(ids, i_ref)
        snap = mreg.snapshot()
        got.append((ids, snap["counters"]["serve.requests{tenant=pq}"],
                    snap["histograms"]["serve.latency_s"]["count"],
                    snap["counters"]["serve.warmup{tenant=pq}"]))
        p.obs.disable()
    np.testing.assert_array_equal(got[0][0], got[1][0])
    assert got[0][1:] == got[1][1:] == (8.0, 8, 4.0)


def _stall(p, sleep_s, times=0):
    p.faults.install_plan({"faults": [{"site": "serve.dispatch",
                                       "kind": "sleep", "sleep_s": sleep_s,
                                       "times": times}]})


def test_shed_reasons_match_jax(pkgs):
    """queue_full, deadline, draining and not_running, typed in both."""
    q = np.zeros(DIM, np.float32)
    got = []
    for p in pkgs:
        mreg = p.enable()
        reg = p.pq_registry()
        srv = p.server(reg, max_batch=2, queue_depth=4, linger_s=0.0,
                       default_slo_s=None, drain_s=10.0)
        with pytest.raises(p.serve.ShedError) as ei:
            srv.submit("pq", q, 10)
        reasons = {ei.value.reason}
        srv.start()
        try:
            _stall(p, 0.2)
            shed, futs = [], []
            for _ in range(12):
                try:
                    futs.append(srv.submit("pq", q, 10))
                except p.serve.ShedError as e:
                    shed.append(e.reason)
            reasons |= set(shed)
            assert [_outcome(f)[0] for f in futs] == ["ok"] * len(futs)
            p.faults.clear_plan()
            _stall(p, 0.25, times=1)
            slow = srv.submit("pq", q, 10, slo_s=None)
            time.sleep(0.05)
            doomed = srv.submit("pq", q, 10, slo_s=0.01)
            reasons.add(_outcome(doomed)[0])
            assert _outcome(slow)[0] == "ok"
            p.faults.clear_plan()
            _stall(p, 0.3)
            first = srv.submit("pq", q, 10)
            time.sleep(0.05)
            queued = [srv.submit("pq", q, 10) for _ in range(3)]
            srv.stop(drain=False)
            stop_out = [_outcome(f) for f in [first] + queued]
            reasons |= {o[1] for o in stop_out if o[0] == "shed"}
            assert {o[0] for o in stop_out} <= {"ok", "shed"}
        finally:
            p.faults.clear_plan()
            srv.stop(drain=False)
        c = _counters(mreg, "serve.")
        got.append((reasons, c.get("serve.shed{reason=deadline}"),
                    c.get("serve.shed{reason=not_running}"),
                    c.get("serve.shed{reason=draining}", 0) >= 1,
                    c["serve.shed{reason=queue_full}"] == len(shed)))
        p.obs.disable()
    assert got[0] == got[1]
    assert got[1][0] == {"not_running", "queue_full", "deadline",
                         "draining"}


def test_injected_oom_walks_the_jax_path(pkgs, data):
    got = []
    for p in pkgs:
        reg = p.pq_registry()
        srv = p.server(reg, max_batch=8, linger_s=0.05, default_slo_s=None)
        srv.start()
        try:
            clean = _served(srv, "pq", data[:8])
            mreg = p.enable()
            p.degrade.clear_recent()
            p.faults.install_plan({"faults": [
                {"site": "ivf_pq.search", "kind": "oom", "times": 1}]})
            walked = _served(srv, "pq", data[:8])
        finally:
            p.faults.clear_plan()
            srv.stop()
        for (_, (dc, ic)), (_, (dw, iw)) in zip(clean, walked):
            np.testing.assert_array_equal(ic, iw)
            np.testing.assert_allclose(dc, dw, rtol=1e-5, atol=1e-5)
        path = [s["to"] for s in p.degrade.recent_steps()]
        c = _counters(mreg)
        got.append((path, reg.get("pq").state,
                    c.get("faults.fired{kind=oom,site=ivf_pq.search}"),
                    np.stack([w[1][1] for w in walked])))
        p.obs.disable()
    assert got[0][:3] == got[1][:3]
    assert got[1][1] == "degraded" and got[1][0][0] == "halve_batch"
    np.testing.assert_array_equal(got[0][3], got[1][3])


def test_transient_dispatch_fault_is_retried(pkgs, data):
    got = []
    for p in pkgs:
        mreg = p.enable()
        reg = p.pq_registry()
        srv = p.server(reg, max_batch=2, linger_s=0.0, default_slo_s=None)
        srv.start()
        try:
            p.faults.install_plan({"faults": [
                {"site": "ivf_pq.search", "kind": "error", "times": 1}]})
            _, i = srv.search("pq", data[0], 10, timeout_s=TIMEOUT)
        finally:
            p.faults.clear_plan()
            srv.stop()
        got.append((i.shape, _counters(mreg, "retry.")))
        p.obs.disable()
    assert got[0] == got[1]
    assert got[1][1]["retry.recovered{site=serve.dispatch}"] >= 1


def test_client_errors_match_jax(pkgs, data):
    """An unknown tenant, an unwarmed k, bad shapes: the same types and
    messages; a bogus name mints no labeled series; declared ks serve."""
    got = []
    for p in pkgs:
        mreg = p.enable()
        reg = p.registry(budget_bytes=1 << 30)
        reg.admit("pq", p.pq, params=p.pq_params, default_k=10, ks=[5, 10])
        srv = p.server(reg, max_batch=4, linger_s=0.001, default_slo_s=None)
        srv.start()
        errs = []
        try:
            for call in (lambda: srv.submit("ghost", data[0]),
                         lambda: srv.submit("pq", data[0], k=7),
                         lambda: srv.submit("pq", data[:2]),
                         lambda: srv.submit("pq", data[0, :-1])):
                try:
                    call()
                except Exception as e:  # noqa: BLE001 — compared below
                    errs.append((type(e).__name__, str(e)))
            _, i5 = srv.search("pq", data[0], 5, timeout_s=TIMEOUT)
            _, i10 = srv.search("pq", data[0], 10, timeout_s=TIMEOUT)
        finally:
            srv.stop()
        np.testing.assert_array_equal(i5, i10[:5])
        c = _counters(mreg, "serve.")
        assert "serve.requests{tenant=ghost}" not in c
        got.append((errs, c["serve.warmup{tenant=pq}"]))
        p.obs.disable()
    assert got[0] == got[1]
    assert got[1][1] == 6.0


def test_warmup_failure_marks_failed_and_serves_the_rest(pkgs, data):
    got = []
    for p in pkgs:
        reg = p.pq_registry(flat=True)
        srv = p.server(reg, max_batch=2, linger_s=0.001, default_slo_s=None)
        p.faults.install_plan({"faults": [
            {"site": "ivf_pq.search", "kind": "oom", "times": 0}]})
        try:
            srv.start()
        finally:
            p.faults.clear_plan()
        try:
            with pytest.raises(p.serve.TenantUnknown) as ei:
                srv.submit("pq", data[0], 10)
            _, ids = srv.search("flat", data[0], 10, timeout_s=TIMEOUT)
        finally:
            srv.stop()
        got.append((reg.tenants()[0].state, reg.get("flat").state,
                    ei.value.state, ids))
    assert got[0][:3] == got[1][:3] == ("failed", "serving", "failed")
    np.testing.assert_array_equal(got[0][3], got[1][3])


def test_mixed_tenants_coalesce_separately(pkgs, data):
    got = []
    for p in pkgs:
        reg = p.pq_registry(flat=True)
        srv = p.server(reg, max_batch=4, linger_s=0.02, default_slo_s=None)
        srv.start()
        try:
            fp = [srv.submit("pq", data[j], 10) for j in range(4)]
            ff = [srv.submit("flat", data[j], 10) for j in range(4)]
            op = [_outcome(f) for f in fp]
            of = [_outcome(f) for f in ff]
        finally:
            srv.stop()
        ip = np.stack([o[1][1] for o in op])
        i_f = np.stack([o[1][1] for o in of])
        np.testing.assert_array_equal(ip, p.direct(data[:4])[1])
        np.testing.assert_array_equal(i_f, p.direct(data[:4], flat=True)[1])
        got.append((ip, i_f))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_steps_seen_is_thread_local():
    before = tdg.steps_seen()
    t = threading.Thread(target=lambda: tdg.note_step(
        "other-thread", "native", "halve_batch", "test"))
    t.start()
    t.join()
    assert tdg.steps_seen() == before
    tdg.note_step("this-thread", "native", "halve_batch", "test")
    assert tdg.steps_seen() == before + 1


def test_degraded_marking_survives_recent_ring_saturation(pkgs, data):
    p = pkgs[1]
    for _ in range(70):
        tdg.note_step("sat", "native", "halve_batch", "test")
    assert len(tdg.recent_steps()) == 64
    reg = p.pq_registry()
    srv = p.server(reg, max_batch=4, linger_s=0.01, default_slo_s=None)
    srv.start()
    try:
        tfa.install_plan({"faults": [
            {"site": "ivf_pq.search", "kind": "oom", "times": 1}]})
        assert [o[0] for o in _served(srv, "pq", data[:4])] == ["ok"] * 4
    finally:
        tfa.clear_plan()
        srv.stop()
    assert reg.get("pq").state == "degraded"


# ---------------------------------------------------------------------------
# request tracing and the server's planes
# ---------------------------------------------------------------------------

def _request_events(p, outcome_of):
    return [e for e in p.trace.get_buffer().snapshot()
            if e["name"] == "serve.request"
            and e["args"]["outcome"] in outcome_of]


def test_request_events_match_jax(pkgs, data):
    """The anchor ``serve.request`` events of served, late-shed and
    not-running requests carry the same fields; futures know their trace
    ids; the batch's dispatch span carries every member's id."""
    got = []
    for p in pkgs:
        p.enable(events=True)
        p.trace.get_buffer().clear()
        reg = p.pq_registry()
        srv = p.server(reg, max_batch=4, linger_s=0.02, default_slo_s=None)
        with pytest.raises(p.serve.ShedError):
            srv.submit("pq", data[0], 10)
        srv.start()
        try:
            futs = [srv.submit("pq", data[j], 10) for j in range(3)]
            [f.result(timeout=TIMEOUT) for f in futs]
            _stall(p, 0.25, times=1)
            slow = srv.submit("pq", data[0], 10, slo_s=None)
            time.sleep(0.05)
            doomed = srv.submit("pq", data[1], 10, slo_s=0.01)
            assert _outcome(doomed)[0] == "deadline"
            slow.result(timeout=TIMEOUT)
        finally:
            p.faults.clear_plan()
            srv.stop()
        evs = _request_events(p, ("ok", "shed_deadline",
                                  "shed_not_running"))
        by = {}
        for e in evs:
            by.setdefault(e["args"]["outcome"], set()).update(e["args"])
        ids = {f.trace_id for f in futs}
        disp = [e for e in p.trace.get_buffer().snapshot()
                if e["name"] == "serve.dispatch"
                and set(e["args"].get("trace_ids", ())) >= ids]
        got.append(({k: sorted(v) for k, v in by.items()}, len(disp) >= 1,
                    all(len(t) == len(futs[0].trace_id) for t in ids)))
        p.obs.disable()
    assert got[0] == got[1]
    assert got[1][1] and got[1][2]


def test_latency_exemplars_resolve_to_requests(pkgs, data):
    p = pkgs[1]
    mreg = p.enable()
    reg = p.pq_registry()
    srv = p.server(reg, max_batch=4, linger_s=0.001, default_slo_s=None)
    srv.start()
    try:
        futs = [srv.submit("pq", data[j], 10) for j in range(6)]
        [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        srv.stop()
    h = mreg.snapshot()["histograms"]["serve.latency_s"]
    seen = {x["trace_id"] for ex in h["exemplars"].values() for x in ex}
    assert seen and seen <= {f.trace_id for f in futs}


def test_flight_sections_and_endpoint_live_with_the_server(pkgs, data,
                                                           tmp_path):
    from raft_tpu_torch.obs import flight

    p = pkgs[1]
    p.enable()
    reg = p.pq_registry(dataset=torch.from_numpy(data))
    srv = p.server(reg, max_batch=4, linger_s=0.001, default_slo_s=None,
                   expo_port=0, verify_sample=1.0, verify_rate_per_s=1e9)
    flight.uninstall()
    srv.start()
    try:
        url = srv.expo.url
        srv.search("pq", data[0], 10, timeout_s=TIMEOUT)
        rec = flight.FlightRecorder(str(tmp_path))
        body = rec.payload("test")
        rec.close()
        assert {"serve_registry", "quality", "cost"} <= set(body)
        assert body["serve_registry"]["tenants"][0]["name"] == "pq"
    finally:
        srv.stop()
        flight.uninstall()
    assert srv.expo is None and srv.verifier is None
    rec = flight.FlightRecorder(str(tmp_path))
    body = rec.payload("test")
    rec.close()
    assert not {"serve_registry", "quality", "cost"} & set(body)
    import urllib.error
    import urllib.request

    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_failed_bind_leaves_server_stopped(pkgs):
    import socket

    p = pkgs[1]
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    port = sock.getsockname()[1]
    try:
        reg = p.pq_registry()
        srv = p.server(reg, max_batch=2, expo_port=port)
        with pytest.raises(OSError):
            srv.start(warmup=False)
        with pytest.raises(tserve.ShedError) as ei:
            srv.submit("pq", np.zeros(DIM, np.float32))
        assert ei.value.reason == "not_running"
    finally:
        sock.close()
