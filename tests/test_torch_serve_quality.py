"""The port's quality, SLO, cost and capacity planes
(``raft_tpu_torch.obs.quality``, ``serve.slo``, ``obs.cost``,
``obs.capacity``) against the JAX package's, on the CPU: the same inputs,
scripted snapshots and injected clocks through both packages give the same
intervals, exact top-k ids, recall, verifier accept patterns and verdicts,
burn rates, recall-floor transitions, cost proration and integrals, and
capacity forecasts.

Tolerances: none — every value is compared for equality (the planes are
host Python and numpy in both packages: the same arithmetic in the same
order gives the same bits).
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.obs import capacity as jcap
from raft_tpu.obs import cost as jcost
from raft_tpu.obs import quality as jq
from raft_tpu.obs.metrics import MetricsRegistry as JReg
from raft_tpu.robust import degrade as jdg
from raft_tpu.serve import slo as jslo
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.obs import capacity as tcap
from raft_tpu_torch.obs import cost as tcost
from raft_tpu_torch.obs import quality as tq
from raft_tpu_torch.obs.metrics import MetricsRegistry as TReg
from raft_tpu_torch.robust import degrade as tdg
from raft_tpu_torch.serve import slo as tslo

PKGS = {
    "j": dict(obs=jobs, q=jq, slo=jslo, cost=jcost, cap=jcap, dg=jdg,
              Reg=JReg),
    "t": dict(obs=tobs, q=tq, slo=tslo, cost=tcost, cap=tcap, dg=tdg,
              Reg=TReg),
}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for p in PKGS.values():
        p["obs"].disable()
        p["slo"].clear_monitor()
        p["cost"].clear_ledger()
        p["cap"].clear_model()


def _enable(p):
    reg = p["Reg"]()
    p["obs"].enable(registry=reg, hbm=False)
    return reg


def _gauges(reg, prefix):
    return {k: v for k, v in reg.snapshot()["gauges"].items()
            if k.startswith(prefix)}


class _FakeTenant:
    def __init__(self, name, dataset=None, metric="sqeuclidean",
                 recall_floor=None):
        self.name = name
        self.dataset = dataset
        self.index = type("I", (), {"metric": metric})()
        self.recall_floor = recall_floor


class _FakeRegistry:
    """Duck-typed stand-in: peek / usable_bytes / resident_bytes /
    resident / note_degraded / note_recovered."""

    def __init__(self, tenants, usable=1 << 30, resident=0):
        self._tenants = {t.name: t for t in tenants}
        self.usable_bytes = usable
        self._resident = resident
        self.moves = []

    def peek(self, name):
        if name not in self._tenants:
            raise KeyError(name)
        return self._tenants[name]

    def resident_bytes(self):
        return self._resident

    def resident(self):
        return list(self._tenants.values())

    def note_degraded(self, name):
        self.moves.append(("degraded", name))

    def note_recovered(self, name):
        self.moves.append(("recovered", name))


# ---------------------------------------------------------------------------
# quality: intervals, exact top-k, recall
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hits,total,z", [
    (0, 0, 1.96), (0, 5, 1.96), (5, 5, 1.96), (3, 7, 1.96),
    (63.5, 64, 1.96), (9.2, 10, 2.58), (999, 1000, 1.0)])
def test_wilson_interval_equal(hits, total, z):
    assert tq.wilson_interval(hits, total, z) == \
        jq.wilson_interval(hits, total, z)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine"])
@pytest.mark.parametrize("k", [1, 10, 600])
def test_exact_topk_ids_equal(metric, k):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 24)).astype(np.float32)
    sq = np.sum(x * x, axis=1)
    for q in rng.standard_normal((4, 24)).astype(np.float32):
        ref = jq.exact_topk_ids(x, q, k, metric)
        np.testing.assert_array_equal(tq.exact_topk_ids(x, q, k, metric), ref)
        # the verifier's cached norms give the same ids
        np.testing.assert_array_equal(
            tq.exact_topk_ids(x, q, k, metric, sq_norms=sq), ref)


@pytest.mark.parametrize("served,true,k", [
    ([1, 2, 3], [1, 2, 3], 3), ([1, 2, 9], [1, 2, 3], 3),
    ([1, -1, -1], [1, 2, 3], 3), ([4, 5, 6, 1], [1, 2, 3], 3),
    ([], [], 0), ([7], [], 1)])
def test_recall_at_k_equal(served, true, k):
    s, t = np.asarray(served), np.asarray(true)
    assert tq.recall_at_k(s, t, k) == jq.recall_at_k(s, t, k)


# ---------------------------------------------------------------------------
# quality: the verifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,fraction", [(0, 0.3), (5, 0.02), (7, 1.0)])
def test_verifier_accept_pattern_equal(seed, fraction):
    """The per-tenant RNG stream (seed · 1,000,003 + crc32(tenant)) is the
    JAX package's: both verifiers accept the same requests."""
    pats = []
    for p in PKGS.values():
        reg = _FakeRegistry([_FakeTenant("a"), _FakeTenant("b")])
        v = p["q"].RecallVerifier(reg, p["q"].VerifierConfig(
            sample_fraction=fraction, rate_limit_per_s=0.0, seed=seed,
            reservoir_depth=4096))
        q = np.zeros(4, np.float32)
        pats.append([v.maybe_sample(t, q, 3, np.arange(3), f"tr{j}")
                     for j in range(300) for t in ("a", "b")])
    assert pats[0] == pats[1]
    assert 0 < sum(pats[1]) <= 600


def test_verifier_verdicts_and_gauges_equal():
    rng = np.random.default_rng(1)
    data = rng.random((300, 8), dtype=np.float32)
    items = []
    for j in range(6):
        q = data[j * 7]
        true = jq.exact_topk_ids(data, q, 5)
        served = true.copy()
        served[: j % 3] = -1  # some answers lose recall
        items.append({"tenant": "t", "k": 5, "query": q, "ids": served,
                      "trace_id": f"tr{j}"})
    got = []
    for name, p in PKGS.items():
        mreg = _enable(p)
        ds = data if name == "j" else torch.from_numpy(data)
        reg = _FakeRegistry([_FakeTenant("t", dataset=ds)])
        v = p["q"].RecallVerifier(reg, p["q"].VerifierConfig(window=4))
        for it in items:
            v._verify(dict(it))
        st = v.state()
        got.append((v.recall_summary("t"), _gauges(mreg, "quality."),
                    mreg.snapshot()["counters"],
                    [(d["recall"], d["trace_id"]) for d in st["verdicts"]],
                    st["verified_total"]))
        p["obs"].disable()
    assert got[0] == got[1]


def test_verifier_copies_a_tensor_dataset_once():
    data = torch.rand((50, 4))
    reg = _FakeRegistry([_FakeTenant("t", dataset=data)])
    v = tq.RecallVerifier(reg)
    a = v._host_dataset("t", data)
    assert isinstance(a, np.ndarray) and a.dtype == np.float32
    assert v._host_dataset("t", data) is a
    np.testing.assert_array_equal(a, data.numpy())


def test_verifier_skips_equal():
    """Missing tenant, missing dataset, and an admission refusal (a
    device dataset larger than the headroom) count the same skips."""
    got = []
    for name, p in PKGS.items():
        mreg = _enable(p)
        big = np.zeros((64, 4), np.float32)
        dev = jnp.asarray(big) if name == "j" else torch.from_numpy(big)
        reg = _FakeRegistry([_FakeTenant("none"),
                             _FakeTenant("big", dataset=dev)],
                            usable=100, resident=0)
        v = p["q"].RecallVerifier(reg)
        for t in ("gone", "none", "big"):
            v._verify({"tenant": t, "k": 3, "query": np.zeros(4),
                       "ids": np.arange(3), "trace_id": "x"})
        got.append(mreg.snapshot()["counters"])
        p["obs"].disable()
    assert got[0] == got[1]
    assert got[1]["quality.skipped{reason=admission,tenant=big}"] == 1.0


# ---------------------------------------------------------------------------
# SLO: burn rates and recall floors
# ---------------------------------------------------------------------------

def _drive_burn(p, policy_kw):
    now = [0.0]
    mreg = _enable(p)
    mon = p["slo"].SLOMonitor(_FakeRegistry([]),
                              policy=p["slo"].SLOPolicy(**policy_kw),
                              clock=lambda: now[0])
    lat = [0.001, 0.02, 0.3, 0.004, 2.0]
    out = []
    for step in range(8):
        now[0] = 10.0 * step
        mreg.inc("serve.requests", 100 + 10 * step, labels={"tenant": "a"})
        mreg.inc("serve.shed", step % 3, labels={"reason": "queue_full"})
        mreg.inc("serve.deadline_missed", step % 2)
        for j in range(10):
            mreg.histogram("serve.latency_s", buckets=[
                1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]).observe(
                    lat[(j + step) % len(lat)])
        out.append(mon.burn_rates())
    out.append(_gauges(mreg, "slo."))
    out.append(mreg.snapshot()["counters"].get(
        "slo.burn_alert{window=30s}"))
    p["obs"].disable()
    return out


@pytest.mark.parametrize("policy_kw", [
    {}, {"windows_s": (15.0, 45.0), "latency_slo_s": 0.1},
    {"availability_target": 0.9, "burn_threshold": 0.5,
     "latency_slo_s": 0.01}])
def test_burn_rates_equal(policy_kw):
    assert _drive_burn(PKGS["j"], policy_kw) == \
        _drive_burn(PKGS["t"], policy_kw)


def _drive_floors(p):
    mreg = _enable(p)
    tenants = [_FakeTenant("a", recall_floor=0.9), _FakeTenant("b")]
    reg = _FakeRegistry(tenants)

    class _V:
        summaries = {}

        def recall_summary(self, t):
            return self.summaries.get(t, {})

    ver = _V()
    mon = p["slo"].SLOMonitor(reg, verifier=ver,
                              policy=p["slo"].SLOPolicy(min_samples=8))
    trail = []
    script = [(0.95, 4), (0.5, 20), (0.5, 20), (0.99, 64), (0.85, 30),
              (1.0, 200)]
    for recall, n in script:
        lo, hi = p["q"].wilson_interval(recall * n, n)
        ver.summaries["a"] = {10: {"recall": recall, "ci_low": lo,
                                   "ci_high": hi, "n": float(n)}}
        mon.evaluate()
        gate = mon.quality_gate_for("a")
        trail.append((mon.breached(), gate is not None,
                      gate("bf16_lut") if gate else None,
                      mon.quality_gate_for("b")))
    health = mon.healthz()
    out = (trail, reg.moves, health["recall_floor_breached"],
           _gauges(mreg, "slo.recall_floor_ok"),
           {k: v for k, v in mreg.snapshot()["counters"].items()
            if k.startswith("slo.recall")})
    p["obs"].disable()
    return out


def test_recall_floor_transitions_equal():
    j, t = _drive_floors(PKGS["j"]), _drive_floors(PKGS["t"])
    assert j == t
    assert ("degraded", "a") in t[1] and ("recovered", "a") in t[1]


def test_quality_gate_refuses_the_same_rungs():
    class _Params:
        lut_dtype = "float32"
        refine = "none"
        scan_select = "pallas"
        scan_mode = "fused"

    got = []
    for p in PKGS.values():
        dg = p["dg"]
        mreg = _enable(p)
        dg.clear_recent()
        calls = {"n": 0}

        def call(knobs):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("RESOURCE_EXHAUSTED: injected")
            return knobs.get("max_batch")

        with dg.quality_gate(lambda rung: True):
            out = dg.run_with_degradation(
                call, {"params": _Params()},
                dg.standard_search_ladder(64, has_lut=True), site="s")
        got.append((out, [s["to"] for s in dg.recent_steps()],
                    {k: v for k, v in mreg.snapshot()["counters"].items()
                     if k.startswith("degrade.refused")}))
        p["obs"].disable()
    assert got[0] == got[1]


def test_global_monitor_install_and_stale_clear():
    a = tslo.SLOMonitor(_FakeRegistry([]))
    b = tslo.SLOMonitor(_FakeRegistry([]))
    assert tslo.set_monitor(a) is None and tslo.get_monitor() is a
    tslo.clear_monitor(b)
    assert tslo.get_monitor() is a
    tslo.clear_monitor(a)
    assert tslo.get_monitor() is None


# ---------------------------------------------------------------------------
# cost: proration, conservation, byte-second integrals
# ---------------------------------------------------------------------------

BATCHES = [(0.25, ["a"]), (0.3, ["a", "a", "a"]), (0.4, ["a", "b", "b"]),
           (0.0, ["c"]), (-1.0, ["a"]), (0.1, []), (0.07, ["b"] * 7)]


@pytest.mark.parametrize("enabled", [False, True])
def test_note_batch_proration_and_conservation_equal(enabled):
    got = []
    for p in PKGS.values():
        mreg = _enable(p) if enabled else None
        led = p["cost"].CostLedger()
        for s, m in BATCHES:
            led.note_batch(s, m)
        got.append((led.device_seconds(), led.shares(), led.conservation(),
                    _gauges(mreg, "cost.") if mreg else None))
        p["obs"].disable()
    assert got[0] == got[1]
    cons = got[1][2]
    assert cons["rel_err"] < 1e-12


def test_hbm_byte_seconds_and_describe_equal():
    got = []
    for p in PKGS.values():
        now = [0.0]
        mreg = _enable(p)
        led = p["cost"].CostLedger(clock=lambda: now[0])
        for t, (ha, hb) in enumerate([(100, 50), (100, 80), (40, 80),
                                      (40, 0)]):
            now[0] = 2.0 * t
            mreg.gauge("index.bytes", labels={"index": "a",
                                              "tier": "hbm"}).set(ha)
            mreg.gauge("index.bytes", labels={"index": "b",
                                              "tier": "hbm"}).set(hb)
            mreg.gauge("index.bytes", labels={"index": "a",
                                              "tier": "host"}).set(999)
            led.tick()
        mreg.inc("serve.requests", 5, labels={"tenant": "a"})
        mreg.inc("cost.io_bytes", 4096, labels={"tenant": "b"})
        mreg.inc("quality.verified", 2, labels={"tenant": "a"})
        shares_hbm = led.shares()
        led.note_batch(0.2, ["a", "b"])
        desc = led.describe()
        desc["totals"].pop("uptime_s")
        got.append((shares_hbm, json.loads(json.dumps(desc)),
                    _gauges(mreg, "cost.")))
        p["obs"].disable()
    assert got[0] == got[1]


def test_global_ledger_install_and_stale_clear():
    a, b = tcost.CostLedger(), tcost.CostLedger()
    assert tcost.set_ledger(a) is None and tcost.get_ledger() is a
    tcost.clear_ledger(b)
    assert tcost.get_ledger() is a
    tcost.clear_ledger(a)
    assert tcost.get_ledger() is None


# ---------------------------------------------------------------------------
# capacity: the delta ring, the trend, the forecast
# ---------------------------------------------------------------------------

def test_delta_ring_equal():
    got = []
    for p in PKGS.values():
        ring = p["cap"].DeltaRing(10.0)
        out = []
        for t in (0.0, 3.0, 7.0, 12.0, 14.0, 30.0):
            ring.append(t, {"x": t * 2})
            snaps = ring.snaps()
            out.append((snaps, [p["cap"].DeltaRing.window_base(
                snaps, t, w) for w in (1.0, 5.0, 100.0)]))
        got.append(out)
    assert got[0] == got[1]


@pytest.mark.parametrize("points", [
    [], [(0.0, 1.0)], [(0.0, 1.0), (1.0, 3.0)],
    [(0.0, 5.0), (2.0, 5.0), (4.0, 5.0)],
    [(0.0, 0.0), (1.0, 10.0), (2.0, 19.0), (3.0, 31.0)],
    [(1.0, 2.0), (1.0, 4.0)]])
def test_trend_slope_equal(points):
    assert tcap._trend_slope(points) == jcap._trend_slope(points)


def _drive_capacity(p, ramp, usable, policy_kw):
    now = [0.0]
    level = [0.0]
    mreg = _enable(p)
    led = p["cost"].CostLedger(clock=lambda: now[0])
    model = p["cap"].CapacityModel(
        resident_bytes=lambda: level[0], usable_bytes=lambda: usable,
        ledger=led, policy=p["cap"].CapacityPolicy(**policy_kw),
        clock=lambda: now[0])
    out = []
    for t, y in enumerate(ramp):
        now[0] = 5.0 * t
        level[0] = y
        led.note_batch(0.5 * (t % 3), ["a"] * (1 + t % 2))
        mreg.inc("serve.requests", 10 * (t + 1), labels={"tenant": "a"})
        mreg.inc("serve.requests", 3, labels={"tenant": "b"})
        model.tick()
        out.append((model.utilization(), model.ttl_saturation_s(),
                    model.ttl_saturation_s(extra_bytes=50.0),
                    model.would_saturate(), model.would_saturate(
                        extra_bytes=400.0, horizon_s=30.0),
                    model.projected_growth_bytes(),
                    model.headroom_frac()))
    fc = json.loads(json.dumps(model.forecast()))
    out.append((fc, _gauges(mreg, "capacity."),
                {k: v for k, v in mreg.snapshot()["counters"].items()
                 if k.startswith("capacity.")}))
    p["obs"].disable()
    return out


@pytest.mark.parametrize("ramp,usable,policy_kw", [
    ([100.0] * 6, 1000.0, {}),
    ([100.0, 200.0, 310.0, 390.0, 520.0, 600.0], 1000.0,
     {"horizon_s": 60.0}),
    ([900.0, 950.0, 1100.0], 1000.0, {"min_points": 2}),
    ([500.0, 400.0, 300.0, 200.0], 0.0, {"alert_utilization": 0.1}),
])
def test_capacity_forecast_equal(ramp, usable, policy_kw):
    assert _drive_capacity(PKGS["j"], ramp, usable, policy_kw) == \
        _drive_capacity(PKGS["t"], ramp, usable, policy_kw)


def test_global_model_install_and_stale_clear():
    mk = lambda: tcap.CapacityModel(lambda: 0.0, lambda: 1.0)  # noqa: E731
    a, b = mk(), mk()
    assert tcap.set_model(a) is None and tcap.get_model() is a
    tcap.clear_model(b)
    assert tcap.get_model() is a
    tcap.clear_model(a)
    assert tcap.get_model() is None


def test_capacity_module_is_stdlib_only():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(tcap))
    mods = {n.module.split(".")[0] if isinstance(n, ast.ImportFrom)
            else a.name.split(".")[0]
            for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert not mods & {"numpy", "torch", "jax"}
