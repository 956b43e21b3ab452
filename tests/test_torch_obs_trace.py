"""The port's timelines, flight dumps, fleet view and exposition
(``raft_tpu_torch.obs.trace`` / ``flight`` / ``fleet`` / ``expo``) against
the JAX package's, on the CPU: every file one package writes loads in the
other's reader, the same events lower to the same Chrome-trace events,
and ``tools/obsdump.py`` renders the port's files. Request contexts ride
the degrade ladder's moves and the retries into the event ring as they do
in the JAX package. Everything here is exact (the formats are JSON).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.obs import expo as jexpo
from raft_tpu.obs import fleet as jfleet
from raft_tpu.obs import flight as jflight
from raft_tpu.obs import trace as jtrace
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import tracing as ttracing
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import expo as texpo
from raft_tpu_torch.obs import fleet as tfleet
from raft_tpu_torch.obs import flight as tflight
from raft_tpu_torch.obs import trace as ttrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _obs_clean():
    yield
    tobs.disable()
    tobs.get_registry().reset()
    ttrace.get_buffer().clear()
    tflight.uninstall()
    jobs.disable()
    jobs.get_registry().reset()
    jflight.uninstall()


def _fill(buf):
    """The same events into a buffer of either package, fixed times."""
    buf.record_span("ivf_pq.search", ts=100.0, dur=0.004,
                    args={"trace_id": "ab12"})
    buf.record_span("ivf_pq.search.ivf_pq.search.scan", ts=100.001,
                    dur=0.002)
    buf.record_counter("hbm.bytes_in_use{device=0}", 1234.0, ts=100.005)
    return buf


def test_buffers_lower_to_the_same_chrome_events():
    t = _fill(ttrace.EventBuffer(capacity=8))
    j = _fill(jtrace.EventBuffer(capacity=8))
    assert t.snapshot() == j.snapshot()
    assert (ttrace._chrome_events(t.snapshot(), 7)
            == jtrace._chrome_events(j.snapshot(), 7))
    for pkg, buf in ((ttrace, ttrace.EventBuffer(3)),
                     (jtrace, jtrace.EventBuffer(3))):
        for i in range(5):
            buf.record_span("s", ts=float(i), dur=0.0)
        assert len(buf) == 3 and buf.dropped == 2
        assert [e["ts"] for e in buf.snapshot()] == [2.0, 3.0, 4.0]
    with pytest.raises(ValueError):
        ttrace.EventBuffer(capacity=0)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_chrome_export_loads_in_the_other_package(tmp_path, direction):
    src, dst = ((ttrace, jtrace) if direction == "port_to_jax"
                else (jtrace, ttrace))
    path = str(tmp_path / "trace.json")
    assert src.export_chrome(path, _fill(src.EventBuffer())) == 3
    doc = dst.load(path)
    assert doc == src.load(path)
    assert doc["otherData"]["producer"] == "raft_tpu.obs.trace"
    assert doc["displayTimeUnit"] == "ms"
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["ivf_pq.search",
                                       "ivf_pq.search.ivf_pq.search.scan"]
    assert xs[0]["ts"] == 100.0 * 1e6 and xs[0]["args"]["trace_id"] == "ab12"


def test_merge_of_one_dump_from_each_package(tmp_path):
    """One Chrome trace from each package (the same pid): both packages'
    ``merge`` give the same document, with the pid collision resolved."""
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    ttrace.export_chrome(a, _fill(ttrace.EventBuffer()))
    jtrace.export_chrome(b, _fill(jtrace.EventBuffer()))
    tdoc = ttrace.merge([a, b], out_path=str(tmp_path / "m.json"))
    jdoc = jtrace.merge([a, b])
    assert tdoc == jdoc
    assert len({e["pid"] for e in tdoc["traceEvents"]}) == 2
    assert len([e for e in tdoc["traceEvents"] if e["ph"] == "X"]) == 4
    assert jtrace.load(str(tmp_path / "m.json")) == tdoc


def test_a_searched_timeline_renders_in_obsdump(tmp_path, capsys):
    """An instrumented port search exported as a Chrome trace renders
    through ``tools/obsdump.py`` (the top-spans table names the search)."""
    sys.path.insert(0, ROOT)
    from tools import obsdump

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2000, 32), dtype=np.float32))
    idx = tpq.build(x, tpq.IndexParams(n_lists=16, pq_dim=16, seed=0,
                                       cache_reconstruction="never"),
                    device="cpu")
    tobs.enable(registry=tobs.MetricsRegistry(), hbm=False, events=True)
    try:
        tpq.search(idx, x[:32], 5, tpq.SearchParams(
            n_probes=4, scan_mode="per_query"), device="cpu")
    finally:
        tobs.disable()
    path = str(tmp_path / "trace.json")
    assert ttrace.export_chrome(path) >= 1
    assert obsdump.main([path]) == 0
    out = capsys.readouterr().out
    assert "top spans by total time" in out and "ivf_pq.search" in out


# ---------------------------------------------------------------------------
# request contexts
# ---------------------------------------------------------------------------

def test_request_contexts_match_jax():
    for kw in ({"tenant": "acme", "trace_id": "t1"},
               {"trace_ids": ["m1", "m2"]}, {"trace_id": "t2"}):
        t, j = ttrace.RequestContext(**kw), jtrace.RequestContext(**kw)
        assert t.event_labels() == j.event_labels()
        assert t.matches("m1") == j.matches("m1")
    assert len(ttrace.new_trace_id()) == 16
    outer, inner = ttrace.RequestContext(), ttrace.RequestContext()
    with ttrace.use_request(outer):
        with ttrace.use_request(inner):
            assert ttrace.current_request() is inner
        assert ttrace.current_request() is outer
    assert ttrace.current_request() is None
    seen = []
    th = threading.Thread(target=lambda: seen.append(
        ttrace.current_request()))
    with ttrace.use_request(outer):
        th.start()
        th.join()
    assert seen == [None]
    ev = {"args": {"trace_ids": ["m1", "m2"]}}
    assert (ttrace.event_matches_trace(ev, "m2")
            == jtrace.event_matches_trace(ev, "m2") is True)


def test_spans_stamp_the_current_request():
    reg = tobs.MetricsRegistry()
    tobs.enable(registry=reg, hbm=False, events=True)
    ctx = ttrace.RequestContext(tenant="t1")
    with ttrace.use_request(ctx):
        with ttracing.span("stage") as sp:
            sp.annotate(rows=3)
    tobs.disable()
    (ev,) = [e for e in ttrace.get_buffer().snapshot()
             if e["name"] == "stage"]
    assert ev["args"] == {"rows": 3, "trace_id": ctx.trace_id,
                          "tenant": "t1"}


def _ladder_events(pkg_trace, pkg_obs, degrade):
    degrade.clear_recent()
    pkg_obs.enable(registry=pkg_obs.MetricsRegistry(), hbm=False,
                   events=True)
    ctx = pkg_trace.RequestContext(tenant="t1", trace_id="req1")
    try:
        with pkg_trace.use_request(ctx):
            degrade.note_step("site.x", "native", "bf16_lut", "test")
        degrade.note_step("site.y", "native", "fp8_lut", "test")
    finally:
        pkg_obs.disable()
    steps = [{k: v for k, v in s.items() if k != "ts"}
             for s in degrade.recent_steps()]
    events = [{k: v for k, v in e.items() if k not in ("ts", "tid")}
              for e in pkg_trace.get_buffer().snapshot()
              if e["name"] == "degrade.step"]
    degrade.clear_recent()
    pkg_trace.get_buffer().clear()
    return steps, events


def test_ladder_moves_carry_request_labels_as_in_jax():
    from raft_tpu.robust import degrade as jdegrade
    from raft_tpu_torch.robust import degrade as tdegrade

    t = _ladder_events(ttrace, tobs, tdegrade)
    j = _ladder_events(jtrace, jobs, jdegrade)
    assert t == j
    steps, events = t
    assert steps[0]["trace_id"] == "req1" and "trace_id" not in steps[1]
    assert len(events) == 2 and events[0]["dur"] == 0.0


def _retry_markers(pkg_trace, pkg_obs, retry):
    pkg_obs.enable(registry=pkg_obs.MetricsRegistry(), hbm=False,
                   events=True)
    ctx = pkg_trace.RequestContext(trace_id="req2")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    try:
        with pkg_trace.use_request(ctx):
            assert retry.retry_call(flaky, site="test.site",
                                    policy=retry.RetryPolicy(
                                        max_attempts=5, base_delay_s=0.0,
                                        jitter=0.0)) == "ok"
    finally:
        pkg_obs.disable()
    out = [e["args"] for e in pkg_trace.get_buffer().snapshot()
           if e["name"] == "retry.attempt"]
    pkg_trace.get_buffer().clear()
    return out


def test_retries_land_in_the_timeline_as_in_jax():
    from raft_tpu.robust import retry as jretry
    from raft_tpu_torch.robust import retry as tretry

    t = _retry_markers(ttrace, tobs, tretry)
    assert t == _retry_markers(jtrace, jobs, jretry)
    assert [a["attempt"] for a in t] == [2, 3]
    assert all(a["trace_id"] == "req2" for a in t)
    # with events off, no marker and no ladder event
    tretry.retry_call(lambda: 1, site="calm")
    assert len(ttrace.get_buffer()) == 0


# ---------------------------------------------------------------------------
# flight dumps and the fleet view
# ---------------------------------------------------------------------------

def _dump(pkg_flight, pkg_obs, pkg_trace, tracing_span, log, tmp_path):
    rec = pkg_flight.install(str(tmp_path), signals=(), use_atexit=False)
    reg = pkg_obs.MetricsRegistry()
    pkg_obs.enable(registry=reg, hbm=False, events=True)
    try:
        with tracing_span("comms.allgatherv"):
            pass
        reg.inc("comms.ops", 2, labels={"op": "allreduce", "axis": "shard"})
        log.warn("flight test line %d", 7)
        path = rec.dump(reason="unit")
    finally:
        pkg_obs.disable()
        pkg_trace.get_buffer().clear()
        pkg_flight.uninstall()
    with open(path) as f:
        return path, json.load(f)


def test_flight_dumps_have_the_jax_schema(tmp_path):
    from raft_tpu.core import logging as jlog
    from raft_tpu.core import tracing as jtracing
    from raft_tpu_torch.core import logging as tlog

    tpath, tdoc = _dump(tflight, tobs, ttrace, ttracing.span, tlog,
                        tmp_path / "t")
    jpath, jdoc = _dump(jflight, jobs, jtrace, jtracing.span, jlog,
                        tmp_path / "j")
    assert set(tdoc) == set(jdoc)
    assert tdoc["schema"] == jflight.SCHEMA == tflight.SCHEMA
    assert set(tdoc["fleet"]) == set(jdoc["fleet"])
    assert tdoc["metrics"]["counters"] == jdoc["metrics"]["counters"]
    assert [e["name"] for e in tdoc["events"]] == ["comms.allgatherv"]
    assert any("flight test line 7" in line for line in tdoc["logs"])
    # the fleet view: either package aggregates both dumps (one process
    # wrote both, so its latest dump's counters stand in for it)
    tview = tfleet.aggregate([tpath, jpath])
    jview = jfleet.aggregate([tpath, jpath])
    assert tview == jview
    assert len(tview["hosts"]) == 2 and tview["counters"][
        "comms.ops{axis=shard,op=allreduce}"] == 2.0
    assert [r["collective"] for r in tview["stragglers"]] == [
        "comms.allgatherv"]
    out = str(tmp_path / "fleet.json")
    assert tfleet.export_chrome(tview, out) == jfleet.export_chrome(
        jview, str(tmp_path / "fleet_j.json"))
    assert jtrace.load(out)["otherData"]["schema"] == jfleet.SCHEMA


def test_flight_carries_the_robust_state(tmp_path):
    from raft_tpu_torch.robust import degrade, faults

    faults.install_plan({"faults": [{"site": "ivf_pq.search",
                                     "kind": "sleep", "sleep_s": 0.0,
                                     "times": 2}]})
    degrade.clear_recent()
    try:
        assert faults.faultpoint("ivf_pq.search") == "sleep"
        degrade.note_step("ivf_pq.search", "native", "halve_batch",
                          "resource_exhausted")
        rec = tflight.FlightRecorder(str(tmp_path))
        with open(rec.dump(reason="chaos")) as f:
            doc = json.load(f)
        rec.close()
    finally:
        faults.clear_plan()
        degrade.clear_recent()
    (rule,) = doc["robust"]["fault_plan"]
    assert (rule["site"], rule["fired"]) == ("ivf_pq.search", 1)
    (step,) = doc["robust"]["degrade_recent"]
    assert step["to"] == "halve_batch"


def test_dump_now_goes_to_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("RAFT_TPU_FLIGHT_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    path = tflight.dump_now(reason="now")
    assert path and os.path.dirname(path) == str(tmp_path / "raft_tpu_flight")
    tflight.set_section("extra", lambda: {"a": 1})
    try:
        with open(tflight.dump_now(reason="again")) as f:
            assert json.load(f)["extra"] == {"a": 1}
    finally:
        tflight.clear_section("extra")


# ---------------------------------------------------------------------------
# the exposition endpoint
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_expo_serves_the_registry(tmp_path, monkeypatch):
    """``/metrics`` parses back to the registry's series; ``/healthz``
    200; ``/indexz`` and ``/costz`` 404 with no provider (the JAX
    package's answers); ``/flightz`` dumps; payloads equal the JAX
    server's for the same registry."""
    monkeypatch.setenv("RAFT_TPU_FLIGHT_DIR", str(tmp_path))
    reg = tobs.MetricsRegistry()
    reg.inc("serve.requests", 3, labels={"tenant": "a"})
    reg.observe("span.ivf_pq.search", 0.004)
    reg.set("hbm.bytes_in_use", 77)
    server = texpo.ExpoServer(port=0, registry=reg).start()
    try:
        code, text = _get(server.url + "/metrics")
        assert code == 200
        parsed = texpo.parse_prometheus(text)
        assert {texpo.prom_name(r["name"]) for r in reg.collect()} <= set(
            parsed)
        assert parsed["raft_tpu_serve_requests"][0]["value"] == 3.0
        assert "process_uptime_seconds" in parsed
        assert _get(server.url + "/healthz")[0] == 200
        assert _get(server.url + "/indexz")[0] == 404
        assert _get(server.url + "/costz")[0] == 404
        assert _get(server.url + "/nope")[0] == 404
        code, body = _get(server.url + "/flightz")
        assert code == 200 and os.path.exists(json.loads(body)["path"])
    finally:
        server.stop()
    assert server.port is None
    jserver = jexpo.ExpoServer(registry=reg)
    assert (texpo.render_prometheus(reg.collect())
            == jexpo.render_prometheus(reg.collect()))
    for method in ("health_payload", "indexz_payload", "costz_payload"):
        assert getattr(server, method)() == getattr(jserver, method)()
    wired = texpo.ExpoServer(indexz=lambda: {"t": {"lists": 1}})
    assert wired.indexz_payload() == (200, {"t": {"lists": 1}})
