"""The port's load generator and fleet router (``raft_tpu_torch.serve.
loadgen``, ``serve.router``) against the JAX package's, on the CPU: the same
Poisson arrival schedule for one seed, the record's shape with the port's
environment stamp, an overload step that sheds and says so, placement
modes, straggler steering and expiry, one Deadline across the hop, a pod
killed mid-storm with exact failover accounting, and the server's
``/healthz``, ``/indexz`` and ``/costz`` over HTTP.

The port's pods and servers run over an index built by the JAX package
(4,000 × 32 rows, 32 lists, pq_dim 8) and handed over with ``from_numpy``,
on ``device="cpu"`` registries; every server is stopped in a ``finally``
and every future is awaited with a timeout. Tolerances: schedules,
counters and payload fields are compared for equality; served ids equal
direct searches exactly.
"""

from __future__ import annotations

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs.metrics import MetricsRegistry as JReg
from raft_tpu.robust import faults as jfa
from raft_tpu.robust import retry as jre
from raft_tpu.serve import loadgen as jlg
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.bench import runner as trunner
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs.metrics import MetricsRegistry as TReg
from raft_tpu_torch.robust import faults as tfa
from raft_tpu_torch.robust import retry as tre
from raft_tpu_torch.serve import loadgen as tlg

from torch_parity import jax_flat_arrays, jax_index_arrays

N, DIM = 4000, 32
TIMEOUT = 60.0
PQ_PARAMS = tpq.SearchParams(n_probes=8, scan_mode="per_query",
                             lut_dtype="float32")


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfa, tfa):
        f.clear_plan()
    yield
    for f in (jfa, tfa):
        f.clear_plan()
    for o in (jobs, tobs):
        o.disable()
    tserve.clear_router()
    jserve.clear_router()


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).random((N, DIM), dtype=np.float32)


@pytest.fixture(scope="module")
def pq_index(data):
    jp = jpq.build(jnp.asarray(data), jpq.IndexParams(
        n_lists=32, pq_dim=8, seed=0, cache_reconstruction="never"))
    return tpq.from_numpy(*jax_index_arrays(jp), device="cpu")


def _registry(pq_index, **admit):
    reg = tserve.IndexRegistry(budget_bytes=1 << 30, device="cpu")
    reg.admit("pq", pq_index, params=PQ_PARAMS, default_k=10, **admit)
    return reg


def _enable(obs_mod, Reg):
    reg = Reg()
    obs_mod.enable(registry=reg, hbm=False)
    return reg


# ---------------------------------------------------------------------------
# loadgen
# ---------------------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def sleep(self, dt):
        self.t += max(dt, 0.0)

    def __getattr__(self, name):  # strftime, gmtime, perf_counter …
        import time

        return getattr(time, name)


class _RecordingServer:
    """Duck-typed server: records each submit's clock and query row, and
    answers at once (every third request shed as queue_full)."""

    def __init__(self, clock, serve_mod):
        self.clock = clock
        self.serve = serve_mod
        self.calls = []

    def submit(self, tenant, query, k, slo_s=-1.0):
        from concurrent.futures import Future

        self.calls.append((round(self.clock.t, 9), float(query[0])))
        if len(self.calls) % 3 == 0:
            raise self.serve.ShedError("queue_full")
        f = Future()
        f.trace_id = f"{len(self.calls):016d}"
        f.set_result((np.zeros(k, np.float32), np.arange(k)))
        return f


@pytest.mark.parametrize("seed,rate", [(0, 50.0), (3, 400.0)])
def test_poisson_schedule_equal(monkeypatch, seed, rate):
    """The arrival clock is ``random.Random(seed).expovariate(rate)`` in
    both packages: the same submits at the same times for one seed, and
    the same tallies."""
    q = np.arange(40, dtype=np.float32).reshape(10, 4)
    got = []
    for lg, sv in ((jlg, jserve), (tlg, tserve)):
        clock = _FakeClock()
        monkeypatch.setattr(lg, "time", clock)
        srv = _RecordingServer(clock, sv)
        row = lg.run_step(srv, "t", q, 3, rate, 0.5, seed=seed)
        got.append((srv.calls, {k: row[k] for k in (
            "sent", "completed", "shed", "shed_reasons", "errors")}))
    assert got[0] == got[1]
    assert got[1][1]["sent"] == len(got[1][0]) > 5


def test_record_shape_with_the_port_stamp():
    rows = [{"offered_qps": 100.0, "duration_s": 1.0, "sent": 10,
             "completed": 10, "shed": 0, "shed_reasons": {},
             "deadline_missed": 0, "errors": 0, "qps": 10.0,
             "latency_p50_s": 0.002, "latency_p99_s": 0.004,
             "latency_mean_s": 0.002, "recall": 0.99, "device_s": 0.1,
             "cost_share": 1.0, "slow_trace_ids": ["a" * 16]},
            {"offered_qps": 400.0, "duration_s": 1.0, "sent": 40,
             "completed": 40, "shed": 0, "shed_reasons": {},
             "deadline_missed": 0, "errors": 0, "qps": 40.0,
             "latency_p50_s": 0.004, "latency_p99_s": 0.090,
             "latency_mean_s": 0.01, "recall": None, "device_s": None,
             "cost_share": None, "slow_trace_ids": ["b" * 16]}]
    rj = jlg.record(rows, "ds", "pq", 10, note="base")
    rt = tlg.record(rows, "ds", "pq", 10, note="base")
    assert set(rt) == set(rj)
    assert rt["baseline_note"] == rj["baseline_note"]
    assert rt["value"] == rj["value"] == 40.0
    for dj, dt in zip(rj["detail"], rt["detail"]):
        assert set(dt) == set(dj)
        same = {k for k in dj if k not in ("env", "measured_at",
                                           "git_commit")}
        assert {k: dt[k] for k in same} == {k: dj[k] for k in same}
    env = rt["detail"][0]["env"]
    assert env == trunner.environment_stamp()
    assert {"gpu_name", "power_limit", "torch", "cuda", "cpu_count",
            "backend", "device_kind", "device_count"} <= set(env)
    assert env["torch"] == torch.__version__
    assert rt["metric"] == ("serve_qps_cpu" if env["backend"] != "cuda"
                            else "serve_qps_gpu")


def test_runner_rest_is_not_ported():
    for fn in (trunner.run_config, trunner.run_config_file,
               trunner.export_csv, trunner.pareto_frontier):
        with pytest.raises(NotImplementedError, match="A18"):
            fn()


def test_open_loop_step_with_recall_and_cost(pq_index, data):
    from raft_tpu.obs.quality import exact_topk_ids

    mreg = _enable(tobs, TReg)
    reg = _registry(pq_index)
    srv = tserve.MicroBatchServer(reg, tserve.ServerConfig(
        max_batch=8, linger_s=0.002, default_slo_s=5.0))
    gt = np.stack([exact_topk_ids(data, data[j], 10) for j in range(64)])
    srv.start()
    try:
        (row,) = tlg.sweep(srv, "pq", data[:64], 10, [60.0],
                           duration_s=0.4, ground_truth=gt)
    finally:
        srv.stop()
    assert row["sent"] == row["completed"] > 0 and row["errors"] == 0
    assert row["latency_p99_s"] >= row["latency_p50_s"] > 0
    assert 0.0 < row["recall"] <= 1.0
    assert row["device_s"] > 0 and row["cost_share"] == 1.0
    assert row["slow_trace_ids"]
    assert mreg.snapshot()["counters"]["serve.requests{tenant=pq}"] == \
        row["sent"]


def test_overload_step_sheds_and_says_so(pq_index, data):
    reg = _registry(pq_index)
    srv = tserve.MicroBatchServer(reg, tserve.ServerConfig(
        max_batch=4, queue_depth=8, linger_s=0.0, default_slo_s=None,
        drain_s=10.0))
    tfa.install_plan({"faults": [{"site": "serve.dispatch",
                                  "kind": "sleep", "sleep_s": 0.05,
                                  "times": 0}]})
    srv.start()
    try:
        row = tlg.run_step(srv, "pq", data[:32], 10, offered_qps=500.0,
                           duration_s=0.4)
    finally:
        tfa.clear_plan()
        srv.stop()
    assert row["shed"] > 0 and row["shed_reasons"].get("queue_full", 0) > 0
    assert row["sent"] == (row["completed"] + row["shed"]
                           + row["deadline_missed"] + row["errors"])


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def _capture_pod(serve_mod, name, hosts=()):
    calls = []

    def fn(tenant, queries, k, deadline):
        calls.append((tenant, deadline))
        return (np.zeros((len(queries), k)),
                np.zeros((len(queries), k), np.int64))

    return serve_mod.Pod(name, hosts=hosts, dispatch_fn=fn), calls


def test_placement_modes_match_jax(pq_index, data):
    jp = jpq.build(jnp.asarray(data[:800]), jpq.IndexParams(
        n_lists=8, pq_dim=8, seed=0, cache_reconstruction="never"))
    got = []
    for sv, idx, kw in ((jserve, jp, {}), (tserve, pq_index,
                                           {"device": "cpu"})):
        mreg = _enable(jobs if sv is jserve else tobs,
                       JReg if sv is jserve else TReg)
        regs = [sv.IndexRegistry(budget_bytes=1 << 30, **kw)
                for _ in range(2)]
        router = sv.FleetRouter([sv.Pod("a", registry=regs[0]),
                                 sv.Pod("b", registry=regs[1])])
        placed = [sorted(router.place("hot", idx, hot=True)),
                  router.place("big", idx, sharded=True),
                  router.place("small", idx)]
        counts = {p.name: len(p.registry.resident()) for p in router.pods}
        got.append((placed, counts, {k: v for k, v in
                                     mreg.snapshot()["counters"].items()
                                     if k.startswith("serve.router")},
                    router.describe()["pods"][0]["tenants"]))
        (jobs if sv is jserve else tobs).disable()
    assert got[0] == got[1]
    assert got[1][0][0] == ["a", "b"]


def test_straggler_steering_and_expiry_match_jax():
    got = []
    for sv, obs_mod, Reg in ((jserve, jobs, JReg), (tserve, tobs, TReg)):
        now = [0.0]
        mreg = _enable(obs_mod, Reg)
        pod_a, calls_a = _capture_pod(sv, "a", hosts=("hostA",))
        pod_b, calls_b = _capture_pod(sv, "b", hosts=("hostB",))
        router = sv.FleetRouter([pod_a, pod_b],
                                sv.RouterPolicy(lag_window_s=60.0),
                                clock=lambda: now[0])
        q = np.zeros((2, 4), np.float32)
        trail = []
        for _ in range(2):
            router.dispatch("t", q, 3)
        trail.append((len(calls_a), len(calls_b)))
        n = router.note_stragglers([
            {"collective": "comms.ring_topk", "slowest": "hostB",
             "skew_frac": 0.50},
            {"collective": "comms.allreduce", "slowest": "hostB",
             "skew_frac": 0.01}])
        for _ in range(6):
            router.dispatch("t", q, 3)
        trail.append((n, len(calls_a), len(calls_b),
                      router.straggling_hosts(),
                      router.describe()["pods"][1]["straggling"]))
        now[0] = 61.0
        for _ in range(4):
            router.dispatch("t", q, 3)
        trail.append((len(calls_a), len(calls_b),
                      router.straggling_hosts()))
        got.append((trail, {k: v for k, v in
                            mreg.snapshot()["counters"].items()
                            if k.startswith("serve.router")}))
        obs_mod.disable()
    assert got[0] == got[1]


def test_one_deadline_crosses_the_hop():
    pod, calls = _capture_pod(tserve, "a")
    router = tserve.FleetRouter([pod])
    dl = tre.Deadline(5.0)
    router.dispatch("t", np.zeros((1, 4), np.float32), 3, deadline=dl)
    assert calls[0][1] is dl


def test_request_scoped_refusals_propagate_not_pod_down():
    got = []
    for sv, re_mod, obs_mod, Reg in ((jserve, jre, jobs, JReg),
                                     (tserve, tre, tobs, TReg)):
        mreg = _enable(obs_mod, Reg)

        def fn(tenant, q, k, deadline, re_mod=re_mod):
            raise re_mod.DeadlineExceeded("serve.dispatch",
                                          re_mod.Deadline(0.0))

        router = sv.FleetRouter([sv.Pod("a", dispatch_fn=fn)])
        with pytest.raises(re_mod.DeadlineExceeded):
            router.dispatch("t", np.zeros((1, 4), np.float32), 3)
        got.append((router.pods[0].healthy,
                    mreg.snapshot()["counters"]))
        obs_mod.disable()
    assert got[0] == got[1]
    assert got[1][0] is True


def _storm(sv, fa, pods, queries, k, n):
    fa.install_plan({"faults": [{"site": "serve.router.hop.b",
                                 "kind": "error", "after": 3,
                                 "times": 0}]})
    router = sv.FleetRouter(pods)
    out = []
    for _ in range(n):
        out.append(router.dispatch("t", queries, k))
    alive = [p.healthy for p in router.pods]
    fa.install_plan({"faults": [{"site": "serve.router.hop.a",
                                 "kind": "error", "times": 0}]})
    with pytest.raises(sv.ShedError) as ei:
        router.dispatch("t", queries, k)
    fa.clear_plan()
    return out, alive, ei.value.reason


def test_pod_kill_mid_storm_matches_jax(pq_index, data):
    """Two pods hold a replicated tenant; pod b's hop dies at its third
    crossing. Every answer comes from pod a (equal to a direct search) and
    the failover accounting is the JAX package's for the same storm; then
    the whole fleet dies and the refusal is typed."""
    queries = data[:16]
    got = []
    # the JAX side on capture pods (the same router, the same plan)
    mreg = _enable(jobs, JReg)
    pods = [_capture_pod(jserve, n)[0] for n in "ab"]
    _, alive, reason = _storm(jserve, jfa, pods, queries, 5, 10)
    got.append((alive, reason, mreg.snapshot()["counters"]))
    jobs.disable()
    # the port on real pods: registries over the CPU index
    mreg = _enable(tobs, TReg)
    pods = []
    for n in "ab":
        reg = tserve.IndexRegistry(budget_bytes=1 << 30, device="cpu")
        reg.admit("t", pq_index, params=PQ_PARAMS, default_k=5)
        pods.append(tserve.Pod(n, registry=reg))
    answers, alive, reason = _storm(tserve, tfa, pods, queries, 5, 10)
    c = {k: v for k, v in mreg.snapshot()["counters"].items()
         if k.startswith(("serve.router", "faults.fired"))}
    got.append((alive, reason, c))
    tobs.disable()
    d_ref, i_ref = tpq.search(pq_index, torch.from_numpy(queries), 5,
                              PQ_PARAMS, device="cpu")
    for d, i in answers:
        assert torch.equal(i, i_ref) and torch.equal(d, d_ref)
    assert got[0][:2] == got[1][:2] == ([True, False], "pod_unhealthy")
    jc = {k: v for k, v in got[0][2].items()
          if k.startswith(("serve.router", "faults.fired"))}
    assert jc == got[1][2]
    assert got[1][2]["serve.router.pod_down{pod=b}"] == 1.0
    assert got[1][2]["serve.router.degraded{reason=pod_lost}"] == 1.0
    assert got[1][2]["serve.router.requests{tenant=t}"] == 11.0


def test_global_router_install_clear_races():
    pod, _ = _capture_pod(tserve, "a")
    r1, r2 = tserve.FleetRouter([pod]), tserve.FleetRouter([pod])
    assert tserve.set_router(r1) is None and tserve.get_router() is r1
    tserve.clear_router(r2)
    assert tserve.get_router() is r1
    tserve.clear_router(r1)
    assert tserve.get_router() is None
    with pytest.raises(ValueError):
        tserve.FleetRouter([])
    with pytest.raises(ValueError):
        tserve.FleetRouter([pod, pod])


# ---------------------------------------------------------------------------
# the server's endpoints over HTTP
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _endpoint_payloads(sv, obs_mod, Reg, flat, dataset, params, rows):
    _enable(obs_mod, Reg)
    kw = {"device": "cpu"} if sv is tserve else {}
    reg = sv.IndexRegistry(budget_bytes=1 << 30, **kw)
    reg.admit("flat", flat, params=params, default_k=10, dataset=dataset,
              recall_floor=0.2)
    srv = sv.MicroBatchServer(reg, sv.ServerConfig(
        max_batch=8, linger_s=0.001, expo_port=0, verify_sample=1.0,
        verify_rate_per_s=1e9))
    srv.start()
    try:
        for r in rows:
            srv.search("flat", r, 10, timeout_s=TIMEOUT)
        url = srv.expo.url
        health, indexz = _get(url + "/healthz"), _get(url + "/indexz")
        costz = _get(url + "/costz")
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            metrics = r.read().decode()
    finally:
        srv.stop()
        obs_mod.disable()
    return health, indexz, costz, metrics


def test_healthz_indexz_costz_over_http_match_jax(data):
    from raft_tpu_torch.obs import expo as texpo

    jf = jfl.build(jnp.asarray(data), jfl.IndexParams(n_lists=16))
    tf = tfl.from_numpy(*jax_flat_arrays(jf), device="cpu")
    rows = data[:8]
    j = _endpoint_payloads(jserve, jobs, JReg, jf, data,
                           jfl.SearchParams(n_probes=16), rows)
    t = _endpoint_payloads(tserve, tobs, TReg, tf, data,
                           tfl.SearchParams(n_probes=16), rows)
    (jh, ji, jc, _), (th, ti, tc, tm) = j, t
    assert th["status"] == jh["status"] == "ok"
    assert th["tenants"] == jh["tenants"] == {"flat": "serving"}
    assert set(th["slo"]) == set(jh["slo"])
    assert th["slo"]["recall_floor_breached"] == []
    jt, tt = ji["tenants"]["flat"], ti["tenants"]["flat"]
    assert set(tt) == set(jt)
    assert tt["recall_floor"] == 0.2 and tt["placement"] == jt["placement"]
    assert tt["stats"]["lists"] == jt["stats"]["lists"]
    assert tt["bytes"]["host"] == data.nbytes
    assert set(tc) == set(jc) == {"ledger", "capacity"}
    assert set(tc["ledger"]) == set(jc["ledger"])
    assert set(tc["ledger"]["tenants"]["flat"]) == \
        set(jc["ledger"]["tenants"]["flat"])
    assert tc["ledger"]["tenants"]["flat"]["requests"] == 8.0
    assert set(tc["capacity"]) == set(jc["capacity"])
    fams = texpo.parse_prometheus(tm)
    assert "raft_tpu_serve_requests" in fams
    assert "raft_tpu_cost_device_s" in fams
