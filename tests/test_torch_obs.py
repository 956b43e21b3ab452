"""The port's observability layer (``raft_tpu_torch.obs``) against the JAX
package's (``raft_tpu.obs``), on the CPU.

The metric registry, the JSONL and Prometheus formats and the index-health
stats take the same inputs in both packages (seeded numpy operations, one
JAX-built index carried across by ``from_numpy``); the span, counter and
gauge series of the same build-and-search flow are compared by name,
label and observation count. Tolerances: snapshots, JSONL rows, rendered
exposition and list stats exact; centroid drift and PQ subspace error
rtol 1e-5 (numpy in float64 on the same arrays); ``search_staged``
distances the JAX package's own per_query tolerance (rtol, atol 1e-5).
The rest holds the port's spans to the JAX package's semantics: dotted
nesting, no record on exception, nothing recorded and no sync while off.
"""

from __future__ import annotations

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import expo as jexpo
from raft_tpu.obs import index_stats as jistats
from raft_tpu.obs import prof as jprof
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import tracing as ttracing
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import expo as texpo
from raft_tpu_torch.obs import hbm as thbm
from raft_tpu_torch.obs import index_stats as tistats
from raft_tpu_torch.obs import prof as tprof
from raft_tpu_torch.obs import sanitize as tsanitize
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.obs import trace as ttrace

from torch_parity import (blobs, jax_flat_arrays, jax_index_arrays)


@pytest.fixture(autouse=True)
def _obs_clean():
    """Spans and registries are process-global state — leave none behind."""
    yield
    tobs.disable()
    tobs.get_registry().reset()
    jobs.disable()
    jobs.get_registry().reset()


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# the registry: the same operations give the same snapshot
# ---------------------------------------------------------------------------

_LABELS = [None, {"algo": "ivf_pq"}, {"b": "2", "a": "1"},
           {"tenant": "x,y", "q": 'say "hi"\n'}]
_BUCKETS = [None, (0.01, 0.1, 1.0), (100.0,)]


def _ops(seed: int, n: int = 60):
    """A seeded sequence of registry operations over a few series."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        kind = ("inc", "set", "max", "observe")[rng.integers(4)]
        name = f"{kind}.s{rng.integers(3)}"
        labels = _LABELS[rng.integers(len(_LABELS))]
        value = float(rng.choice([0.0, 1e-6, 3e-4, 0.02, 0.5, 7.0, 900.0]))
        ex = f"t{i}" if kind == "observe" and rng.random() < 0.5 else None
        ops.append((kind, name, value, labels, ex,
                    _BUCKETS[(seed + i) % len(_BUCKETS)]))
    return ops


def _apply(reg, ops):
    for kind, name, value, labels, ex, buckets in ops:
        if kind == "inc":
            reg.inc(name, value, labels=labels)
        elif kind == "set":
            reg.set(name, value, labels=labels)
        elif kind == "max":
            reg.gauge(name, labels).max(value)
        else:
            reg.histogram(name, labels, buckets=buckets).observe(
                value, exemplar=ex)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_operations_give_equal_snapshots(seed):
    ops = _ops(seed)
    t = _apply(tobs.MetricsRegistry(), ops)
    j = _apply(jobs.MetricsRegistry(), ops)
    assert t.snapshot() == j.snapshot()
    assert t.collect() == j.collect()
    for (name, st), (_, jst) in zip(sorted(t.snapshot()["histograms"].items()),
                                    sorted(j.snapshot()["histograms"].items())):
        for q in (0.0, 0.5, 0.99, 1.0, 1.5):
            assert (tobs.quantile_from_state(st, q)
                    == jobs.quantile_from_state(jst, q)), (name, q)
            assert (tobs.exemplars_for_quantile(st, q)
                    == jobs.exemplars_for_quantile(jst, q)), (name, q)
    from raft_tpu.obs.metrics import counter_sum as jsum
    from raft_tpu_torch.obs.metrics import counter_sum as tsum

    for name in ("inc.s0", "inc.s1", "inc.s2"):
        assert tsum(t.collect(), name) == jsum(j.collect(), name)
        assert (tsum(t.collect(), name, algo="ivf_pq")
                == jsum(j.collect(), name, algo="ivf_pq"))


def test_registry_semantics():
    r = tobs.MetricsRegistry()
    r.inc("reqs")
    r.inc("reqs", 1, labels={"b": "2", "a": "1"})
    r.inc("reqs", 1, labels={"a": "1", "b": "2"})  # the same series
    assert r.snapshot()["counters"] == {"reqs": 1.0, "reqs{a=1,b=2}": 2.0}
    with pytest.raises(ValueError):
        r.counter("reqs").inc(-1)
    prev = tobs.set_registry(r)
    try:
        assert tobs.get_registry() is r
    finally:
        tobs.set_registry(prev)
    r.reset()
    assert r.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_jsonl_crosses_both_ways(tmp_path, direction):
    """A ``dump_jsonl`` file of either package loads in the other's
    ``load_jsonl`` as the same rows (the ``extra`` stamp included)."""
    ops = _ops(7)
    src, dst = ((tobs, jobs) if direction == "port_to_jax"
                else (jobs, tobs))
    reg = _apply(src.MetricsRegistry(), ops)
    path = str(tmp_path / "m.jsonl")
    assert reg.dump_jsonl(path, extra={"run": "r0"}) == len(reg.collect())
    rows = dst.load_jsonl(path)
    assert rows == [{**r, "run": "r0"} for r in reg.collect()]
    assert rows == src.load_jsonl(path)


def test_jsonl_rotation_matches(tmp_path, monkeypatch):
    """Size-capped rotation ``path → path.1 → …`` keeps the same files in
    both packages."""
    monkeypatch.setenv("RAFT_TPU_OBS_JSONL_KEEP", "2")
    files = {}
    for name, pkg in (("t", tobs), ("j", jobs)):
        reg = _apply(pkg.MetricsRegistry(), _ops(1))
        d = tmp_path / name
        d.mkdir()
        for _ in range(5):
            reg.dump_jsonl(str(d / "m.jsonl"), max_mb=1e-4)
        files[name] = sorted(os.listdir(d))
    assert files["t"] == files["j"] == ["m.jsonl", "m.jsonl.1", "m.jsonl.2"]


@pytest.mark.parametrize("seed", [0, 5])
def test_prometheus_rendering_is_byte_equal(seed):
    rows = _apply(tobs.MetricsRegistry(), _ops(seed)).collect()
    rows.append({"kind": "gauge", "name": "odd-name.x", "labels": {},
                 "value": float("inf")})
    text = texpo.render_prometheus(rows)
    assert text == jexpo.render_prometheus(rows)
    assert texpo.parse_prometheus(text) == jexpo.parse_prometheus(text)
    assert texpo.prom_name("serve.latency_s") == "raft_tpu_serve_latency_s"


def test_process_rows_have_the_jax_names():
    names = [r["name"] for r in texpo.process_rows()]
    assert names == [r["name"] for r in jexpo.process_rows()]
    texpo.parse_prometheus(texpo.process_text())


# ---------------------------------------------------------------------------
# spans: the JAX package's semantics
# ---------------------------------------------------------------------------

def test_nested_spans_dot_join():
    reg = tobs.MetricsRegistry()
    tobs.enable(registry=reg, hbm=False)
    with ttracing.span("search"):
        assert tobs.current_name() == "search"
        with ttracing.span("scan"):
            assert tobs.current_name() == "search.scan"
        with ttracing.span("scan"):
            pass
    tobs.disable()
    h = reg.snapshot()["histograms"]
    assert h["span.search"]["count"] == 1
    assert h["span.search.scan"]["count"] == 2


def test_no_record_on_exception():
    reg = tobs.MetricsRegistry()
    tobs.enable(registry=reg, hbm=False)
    with pytest.raises(RuntimeError):
        with ttracing.span("boom"):
            raise RuntimeError("x")
    tobs.disable()
    assert "span.boom" not in reg.snapshot()["histograms"]
    assert tobs.current_name() == ""


def test_disabled_spans_record_nothing():
    assert not tobs.enabled()
    with ttracing.span("ghost") as sp:
        sp.attach(torch.arange(3))
    assert "span.ghost" not in tobs.get_registry().snapshot()["histograms"]


def test_traced_records_span_when_enabled():
    reg = tobs.MetricsRegistry()

    @ttracing.traced("raft_tpu_torch.test.traced_span")
    def f(x):
        return x + 1

    assert f(1) == 2  # disabled: no record
    tobs.enable(registry=reg, hbm=False)
    assert f(1) == 2
    tobs.disable()
    assert reg.snapshot()["histograms"]["span.test.traced_span"]["count"] == 1


def test_spans_are_quiet_inside_a_compile_trace(monkeypatch):
    """The JAX package's "under a jit trace" rule: inside a
    ``torch.compile`` trace (or a CUDA-graph capture, checked on the card)
    a span records nothing, and stage mode does not reroute."""
    reg = tobs.MetricsRegistry()
    tobs.enable(sync=True, stages=True, registry=reg, hbm=False)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with ttracing.span("inside") as sp:
        sp.attach(torch.ones(2))
    monkeypatch.undo()
    tobs.disable()
    assert reg.snapshot()["histograms"] == {}


def test_sync_mode_waits_only_for_card_tensors(monkeypatch):
    """Sync mode waits for the current CUDA stream only when a CUDA tensor
    was attached; CPU tensors need no wait."""
    waited = []
    monkeypatch.setattr(tspans, "_has_cuda",
                        lambda a: waited.append(a) or False)
    reg = tobs.MetricsRegistry()
    tobs.enable(sync=True, registry=reg, hbm=False)
    with ttracing.span("s") as sp:
        sp.attach(torch.ones(3))
    tobs.disable()
    assert len(waited) == 1 and reg.snapshot()["histograms"]["span.s"]


def test_state_restore_and_env_flags(monkeypatch):
    reg = tobs.MetricsRegistry()
    tobs.enable(sync=True, events=True, registry=reg)
    st = tspans._state()
    tobs.disable()
    tspans._restore(st)
    assert (tobs.sync_enabled() and tobs.events_enabled()
            and tobs.registry() is reg)
    tobs.disable()
    for v in ("0", "false", "off", "no", ""):
        monkeypatch.setenv("RAFT_TPU_TEST_FLAG", v)
        assert not tobs.env_flag("RAFT_TPU_TEST_FLAG")
        assert not jobs.env_flag("RAFT_TPU_TEST_FLAG")
    for v, tri in (("always", "on"), ("never", "off"), ("auto", "auto")):
        monkeypatch.setenv("RAFT_TPU_TEST_FLAG", v)
        assert tobs.env_tristate("RAFT_TPU_TEST_FLAG") == tri
        assert jobs.env_tristate("RAFT_TPU_TEST_FLAG") == tri


def test_counters_are_always_on_and_view_the_registry():
    """The port's counters record with obs off (the deliberate difference
    from the JAX package), into the registry ``counts()`` and ``total()``
    read, under the JAX package's series and label names."""
    assert not tobs.enabled()
    tspans.reset()
    tobs.count_dispatch("ivf_pq.scan", "pallas_lut", filtered="1")
    tobs.count_dispatch("ivf_pq.scan", "pallas_lut")
    tobs.count_fallback("ivf_pq.scan", "mem_guard")
    tspans.inc("degrade.steps", site="s", to="halve_batch",
               **{"from": "native"})
    tspans.set_value("sanitize.lock.acquire", 3)
    assert tspans.counts() == {
        "ivf_pq.scan.dispatch": {"pallas_lut,filtered=1": 1.0,
                                 "pallas_lut": 1.0},
        "ivf_pq.scan.fallback": {"mem_guard": 1.0},
        "degrade.steps": {"from=native,site=s,to=halve_batch": 1.0},
        "sanitize.lock.acquire": {"": 3.0}}
    c = tobs.get_registry().snapshot()["counters"]
    assert c["ivf_pq.scan.dispatch{filtered=1,impl=pallas_lut}"] == 1.0
    assert tspans.total("ivf_pq.scan.dispatch", impl="pallas_lut") == 2.0
    # an enabled registry override receives them instead
    reg = tobs.MetricsRegistry()
    tobs.enable(registry=reg, hbm=False)
    tobs.count_dispatch("refine", "pallas_gather")
    tobs.disable()
    assert reg.snapshot()["counters"] == {
        "refine.dispatch{impl=pallas_gather}": 1.0}
    tspans.reset()
    assert tspans.counts() == {}


# ---------------------------------------------------------------------------
# device memory and the profiler bracket, off the card
# ---------------------------------------------------------------------------

def test_hbm_degrades_on_the_cpu():
    assert thbm.device_memory_stats("cpu") == {}
    assert thbm.bytes_limit(torch.device("cpu"), default=123) == 123
    assert thbm.bytes_in_use("cpu") is None and thbm.peak_bytes("cpu") is None
    reg = tobs.MetricsRegistry()
    assert thbm.sample(reg) == {}
    assert reg.snapshot()["gauges"] == {}
    thbm.note_budget(1 << 30, reg)
    assert reg.snapshot()["gauges"] == {
        "hbm.bytes_limit{source=admission}": float(1 << 30)}


def test_hbm_sample_covers_every_card(monkeypatch):
    """Per-device gauges for every card, card 0 mirrored unlabeled, a card
    that does not answer skipped, counter events recorded — the JAX
    package's ``sample`` contract."""
    stats = {0: {"bytes_in_use": 100, "peak_bytes_in_use": 200,
                 "bytes_limit": 1000},
             1: {}, 2: {"bytes_in_use": 7, "peak_bytes_in_use": 9}}
    monkeypatch.setattr(thbm, "_local_devices", lambda: [0, 1, 2])
    monkeypatch.setattr(thbm, "device_memory_stats", lambda i: stats[i])
    reg = tobs.MetricsRegistry()
    buf = ttrace.EventBuffer()
    assert thbm.sample(reg, events=buf) == stats[0]
    g = reg.snapshot()["gauges"]
    assert g["hbm.bytes_in_use{device=0}"] == 100 == g["hbm.bytes_in_use"]
    assert g["hbm.peak_bytes{device=2}"] == 9
    assert g["hbm.bytes_limit"] == 1000
    assert not any("device=1" in n for n in g)
    names = {e["name"] for e in buf.snapshot()}
    assert {"hbm.bytes_in_use{device=0}", "hbm.peak_bytes{device=2}"} <= names


def test_recon_cache_rule_reads_the_allocator_limit(monkeypatch):
    """``cache_reconstruction="auto"`` caps the cache at a fifth of
    ``hbm.bytes_limit`` (so a memory fraction counts), 3 GB where the
    device reports no limit."""
    p = tpq.IndexParams(cache_reconstruction="auto")
    cpu = torch.device("cpu")
    assert tpq._want_recon_cache(p, 1024, 1536, 128, cpu)
    monkeypatch.setattr(thbm, "bytes_limit", lambda device=None: 1 << 30)
    assert not tpq._want_recon_cache(p, 1024, 1536, 128, cpu)
    assert tpq._want_recon_cache(p, 16, 128, 32, cpu)


def test_device_peaks_and_program_cost():
    h100 = tprof.peak_for_kind("NVIDIA H100 80GB HBM3")
    assert (h100.name, h100.flops, h100.hbm_bw, h100.tf32_flops) == (
        "h100", 67e12, 3.35e12, 495e12)
    assert not h100.placeholder and "700 W" in h100.source
    assert tprof.peak_for_kind("TPU v5 lite").placeholder
    assert tprof.device_peak("cpu").placeholder
    assert "v5e" not in tprof.DEVICE_PEAKS
    c = tprof.program_cost(2e9, 4e9, peak=h100, elapsed_s=1e-3)
    assert c.bound == "memory" and c.arithmetic_intensity == 0.5
    assert c.achieved_bw_frac == pytest.approx(4e12 / 3.35e12)
    with pytest.raises(NotImplementedError, match="A15"):
        tprof.interconnect_peak()
    with pytest.raises(NotImplementedError, match="A15"):
        tprof.axis_peak_bw("shard")


def test_prof_record_writes_the_jax_gauges():
    """The same cost writes the same ``prof.*`` gauges in both packages
    (the series ``tools/obsdump.py``'s roofline table reads)."""
    fields = dict(flops=2e9, bytes_accessed=4e9, arithmetic_intensity=0.5,
                  bound="memory", achieved_bw_frac=0.25,
                  achieved_flops_frac=0.01)
    treg, jreg = tobs.MetricsRegistry(), jobs.MetricsRegistry()
    tprof.record(tprof.ProgramCost(**fields), treg, program="scan{a,b}")
    jprof.record(jprof.ProgramCost(**fields), jreg, program="scan{a,b}")
    assert treg.snapshot() == jreg.snapshot()
    assert (tprof.ProgramCost(**fields).as_row()
            == jprof.ProgramCost(**fields).as_row())


def test_capture_writes_a_chrome_trace(tmp_path):
    cap = tprof.capture(str(tmp_path)).start()
    (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert cap.stop() == str(tmp_path)
    assert cap.error is None and os.path.exists(cap.path)
    with open(cap.path) as f:
        doc = json.load(f)
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    assert tprof.capture(str(tmp_path)).stop() is None  # never armed


def test_no_host_transfers_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tsanitize.no_host_transfers():
        assert float(torch.ones(2).sum()) == 2.0
    monkeypatch.setenv("RAFT_TPU_SANITIZE", "1")
    assert tsanitize.sanitize_enabled()
    monkeypatch.setenv("RAFT_TPU_SANITIZE", "off")
    assert not tsanitize.sanitize_enabled()


# ---------------------------------------------------------------------------
# index health: one index, carried across
# ---------------------------------------------------------------------------

N, D = 3000, 32

_JAX = {}


def _corpus():
    return blobs(N, D, 30, seed=31), blobs(60, D, 30, seed=32)


def _jax_pq(metric="sqeuclidean", pq_bits=8):
    key = ("pq", metric, pq_bits)
    if key not in _JAX:
        x, _ = _corpus()
        _JAX[key] = jpq.build(jnp.asarray(x), jpq.IndexParams(
            n_lists=16, pq_dim=16, pq_bits=pq_bits, metric=metric, seed=0,
            cache_reconstruction="never"))
    return _JAX[key]


def _jax_flat():
    if "flat" not in _JAX:
        x, _ = _corpus()
        _JAX["flat"] = jflat.build(jnp.asarray(x),
                                   jflat.IndexParams(n_lists=16, seed=0))
    return _JAX["flat"]


def _port_pq(jidx):
    arrays, meta = jax_index_arrays(jidx)
    return tpq.from_numpy(arrays, meta, device="cpu")


@pytest.mark.parametrize("sizes", [[0, 0, 5], [3, 1, 4, 1, 5, 9, 2, 6],
                                   list(range(40))])
def test_list_stats_exact(sizes):
    assert tistats.list_stats(torch.tensor(sizes)) == jistats.list_stats(
        np.asarray(sizes))


@pytest.mark.parametrize("metric,pq_bits", [("sqeuclidean", 8),
                                            ("sqeuclidean", 5),
                                            ("inner_product", 8)])
def test_pq_index_stats_match_jax(metric, pq_bits):
    """List stats exact; drift over sampled lists (max_lists 5 of 16: the
    port brings only those lists across) and the PQ subspace error on 500
    of 3000 rows within rtol 1e-5."""
    jidx = _jax_pq(metric, pq_bits)
    tidx = _port_pq(jidx)
    x, _ = _corpus()
    assert (tistats.list_stats(tidx.list_sizes)
            == jistats.list_stats(jidx.list_sizes))
    for max_lists in (5, 256):
        td = tistats.centroid_drift(tidx, max_lists=max_lists)
        jd = jistats.centroid_drift(jidx, max_lists=max_lists)
        assert td["lists_sampled"] == jd["lists_sampled"]
        for key in ("mean", "max", "rel_mean"):
            assert td[key] == pytest.approx(jd[key], rel=1e-5)
    tp = tistats.pq_subspace_error(tidx, torch.tensor(x), sample_rows=500)
    jp = jistats.pq_subspace_error(jidx, x, sample_rows=500)
    assert tp["rows_sampled"] == jp["rows_sampled"] == 500
    np.testing.assert_allclose(tp["per_subspace_mse"],
                               jp["per_subspace_mse"], rtol=1e-5, atol=1e-8)
    for key in ("mean", "max", "rel_error"):
        assert tp[key] == pytest.approx(jp[key], rel=1e-5)
    tdesc = tistats.describe_index(tidx, torch.tensor(x), sample_rows=500)
    jdesc = jistats.describe_index(jidx, x, sample_rows=500)
    assert set(tdesc) == set(jdesc) and "error" not in tdesc
    assert tdesc["lists"] == jdesc["lists"] and tdesc["dim"] == jdesc["dim"]


def test_flat_index_drift_matches_jax():
    jidx = _jax_flat()
    arrays, meta = jax_flat_arrays(jidx)
    tidx = tflat.from_numpy(arrays, meta, device="cpu")
    td = tistats.centroid_drift(tidx, max_lists=7)
    jd = jistats.centroid_drift(jidx, max_lists=7)
    for key in ("mean", "max", "rel_mean"):
        assert td[key] == pytest.approx(jd[key], rel=1e-5)
    assert tistats.pq_subspace_error(tidx, np.zeros((4, D))) is None


def test_note_index_stats_gauges_match_jax():
    """The gauges ``note_index_stats`` publishes for the same index (full
    and cheap) are the same series with the same values."""
    jidx = _jax_pq()
    tidx = _port_pq(jidx)
    x, _ = _corpus()
    assert tistats.note_index_stats(tidx, name="i") is None  # obs off
    snaps = {}
    for key, pkg, st, idx, data in (
            ("t", tobs, tistats, tidx, torch.tensor(x)),
            ("j", jobs, jistats, jidx, x)):
        reg = pkg.MetricsRegistry()
        pkg.enable(registry=reg, hbm=False)
        st.note_index_stats(idx, name="full", dataset=data)
        st.note_index_stats(idx, name="cheap", cheap=True)
        st.note_tier_bytes("full", hbm_bytes=10, host_bytes=20)
        pkg.disable()
        snaps[key] = reg.snapshot()["gauges"]
    assert set(snaps["t"]) == set(snaps["j"])
    for name, v in snaps["j"].items():
        assert snaps["t"][name] == pytest.approx(v, rel=1e-5), name


# ---------------------------------------------------------------------------
# one flow, the same series
# ---------------------------------------------------------------------------

def _flow(pkg, obs, search, build, conv, **dev):
    """Build, a refined LUT-tier search (scan_select="pallas"), then an
    unrefined search in stage mode — all into one fresh registry."""
    x, q = _corpus()
    reg = obs.MetricsRegistry()
    obs.enable(registry=reg)
    idx = build(conv(x), pkg.IndexParams(n_lists=16, pq_dim=16, seed=0,
                                         cache_reconstruction="never"), **dev)
    search(idx, conv(q), 10, pkg.SearchParams(
        n_probes=8, scan_select="pallas", refine="f32_regen",
        refine_ratio=40, lut_dtype="float32"), dataset=conv(x), **dev)
    obs.enable(stages=True, registry=reg)
    search(idx, conv(q), 10, pkg.SearchParams(n_probes=8,
                                              scan_mode="per_query"), **dev)
    obs.disable()
    return reg.snapshot()


def test_the_same_flow_gives_the_same_series(monkeypatch):
    """Span series and their observation counts, counter series and their
    labels, and the build's gauges, named alike in both packages. The JAX
    package counts ``select_k.dispatch`` once per jit trace (none when its
    programs are already compiled in this process) and the port once per
    call, with its own tier rule; both use the labels pallas / xla_tiled /
    xla."""
    monkeypatch.setenv("RAFT_TPU_PALLAS_LUTSCAN", "always")
    monkeypatch.setenv("RAFT_TPU_PALLAS_REFINE", "always")
    js = _flow(jpq, jobs, jpq.search, jpq.build, jnp.asarray)
    ts = _flow(tpq, tobs, tpq.search, tpq.build, torch.from_numpy,
               device="cpu")
    spans = {n: h["count"] for n, h in ts["histograms"].items()}
    assert spans == {n: h["count"] for n, h in js["histograms"].items()}
    assert spans["span.ivf_pq.search.ivf_pq.search.scan"] == 1
    assert spans["span.ivf_pq.search.refine.fused_scan"] == 1
    assert spans["span.ivf_pq.search.lut"] == 1
    assert spans["span.ivf_pq.build.train.kmeans_balanced.fit"] == 1

    def split(counters):
        out = {}
        for key in counters:
            name, _, labels = key.partition("{")
            out.setdefault(name, set()).add(labels.rstrip("}"))
        return out

    tc, jc = split(ts["counters"]), split(js["counters"])
    tsel, jsel = tc.pop("select_k.dispatch"), jc.pop("select_k.dispatch",
                                                    set())
    assert tc == jc
    assert tsel and all(lab in ("impl=pallas", "impl=xla_tiled", "impl=xla")
                        for lab in tsel | jsel)
    assert set(ts["gauges"]) == set(js["gauges"])
    assert ts["gauges"]["index.n_lists{index=ivf_pq.build}"] == 16


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_search_staged_matches_jax(metric):
    """``search_staged`` on one index: ids equal the JAX package's
    ``search_staged`` ids, distances within its per_query tolerance, and
    equal to the port's own per_query tier."""
    jidx = _jax_pq(metric)
    tidx = _port_pq(jidx)
    _, q = _corpus()
    kw = dict(n_probes=8, scan_mode="per_query")
    jd, ji = jpq.search_staged(jidx, jnp.asarray(q), 10,
                               jpq.SearchParams(**kw))
    td, ti = tpq.search_staged(tidx, _t(q), 10, tpq.SearchParams(**kw),
                               device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    pd, pi = tpq.search(tidx, _t(q), 10, tpq.SearchParams(
        lut_dtype="float32", **kw), device="cpu")
    np.testing.assert_array_equal(ti.numpy(), pi.numpy())
    np.testing.assert_allclose(td.numpy(), pd.numpy(), rtol=1e-5, atol=1e-5)


def test_stage_mode_routes_search_and_records_stages():
    tidx = _port_pq(_jax_pq())
    _, q = _corpus()
    sp = tpq.SearchParams(n_probes=8, scan_mode="per_query")
    d0, i0 = tpq.search(tidx, _t(q), 10, sp, device="cpu")
    reg = tobs.MetricsRegistry()
    tobs.enable(sync=True, stages=True, registry=reg)
    d1, i1 = tpq.search(tidx, _t(q), 10, sp, device="cpu")
    # a filtered search keeps its tier: stage mode is unfiltered only
    tpq.search(tidx, _t(q), 10, sp, device="cpu",
               filter_bitset=np.full(N // 32 + 1, 0xFFFFFFFF, np.uint32))
    tobs.disable()
    assert torch.equal(i0, i1)
    h = reg.snapshot()["histograms"]
    for stage in ("span.ivf_pq.search.coarse_quantize",
                  "span.ivf_pq.search.lut", "span.ivf_pq.search.scan"):
        assert h[stage]["count"] == 1, stage
    assert h["span.ivf_pq.search"]["count"] == 2
    assert tspans.total("ivf_pq.scan.dispatch", impl="staged") == 0
    assert reg.snapshot()["counters"][
        "ivf_pq.scan.dispatch{impl=staged}"] == 1.0


def test_chunked_and_flat_builds_name_their_spans(tmp_path):
    """``build_chunked``'s spans are the JAX package's train / label /
    encode_pack, ``stage_seconds`` still fills every stage, and its gauges
    land under ``index=ivf_pq.build_chunked``; ``ivf_flat.build``'s spans
    and gauges likewise."""
    x, _ = _corpus()
    reg = tobs.MetricsRegistry()
    tobs.enable(registry=reg, hbm=False)
    stages = {}
    tpq.build_chunked(x, tpq.IndexParams(n_lists=8, pq_dim=8), chunk_rows=700,
                      device="cpu", stage_seconds=stages)
    tflat.build(_t(x), tflat.IndexParams(n_lists=8), device="cpu")
    tobs.disable()
    snap = reg.snapshot()
    spans = {n for n in snap["histograms"]
             if n.count(".") == 3 and n.startswith("span.ivf_")}
    assert spans == {"span.ivf_pq.build_chunked.train",
                     "span.ivf_pq.build_chunked.label",
                     "span.ivf_pq.build_chunked.encode_pack",
                     "span.ivf_flat.build.train", "span.ivf_flat.build.assign",
                     "span.ivf_flat.build.pack"}
    assert {"sample", "train", "read", "label", "encode", "pack",
            "upload"} <= set(stages)
    g = snap["gauges"]
    assert g["index.size{index=ivf_pq.build_chunked}"] == N
    assert g["index.size{index=ivf_flat.build}"] == N


# ---------------------------------------------------------------------------
# off means off (the JAX package's no-overhead tests)
# ---------------------------------------------------------------------------

def test_disabled_search_records_no_events():
    tidx = _port_pq(_jax_pq())
    _, q = _corpus()
    assert not tobs.enabled()
    buf = ttrace.EventBuffer()
    prev = ttrace.set_buffer(buf)
    try:
        tpq.search(tidx, _t(q), 10, tpq.SearchParams(
            n_probes=8, scan_mode="per_query"), device="cpu")
    finally:
        ttrace.set_buffer(prev)
    assert len(buf) == 0
    assert not [n for n in tobs.get_registry().snapshot()["histograms"]]


def test_no_sync_from_span_code_when_disabled(monkeypatch):
    """With obs off no span reaches its sync path, nor the clock."""
    tidx = _port_pq(_jax_pq())
    _, q = _corpus()
    calls = []
    monkeypatch.setattr(tspans, "_has_cuda",
                        lambda a: calls.append("sync") or False)
    monkeypatch.setattr(tspans.span, "_record",
                        lambda self, ok: calls.append("record"))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("synchronize"))
    tpq.search(tidx, _t(q), 10, tpq.SearchParams(n_probes=8,
                                                 scan_mode="per_query"),
               device="cpu")
    assert calls == []


def test_disabled_overhead_under_2pct():
    tidx = _port_pq(_jax_pq())
    _, q = _corpus()
    sp = tpq.SearchParams(n_probes=8, scan_mode="per_query")
    qt = _t(q)
    tpq.search(tidx, qt, 10, sp, device="cpu")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with ttracing.span("overhead_probe"):
            pass
    per_span = (time.perf_counter() - t0) / n
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        tpq.search(tidx, qt, 10, sp, device="cpu")
    per_search = (time.perf_counter() - t0) / reps
    assert 32 * per_span < 0.02 * per_search, (per_span, per_search)
