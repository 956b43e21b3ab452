"""SLO guardrails — multi-window burn rates and closed-loop recall floors
(counterpart of ``raft_tpu.serve.slo``; the same policy, series and
transitions).

The SRE multi-window burn-rate shape (Beyer et al., *The Site
Reliability Workbook*) applied to the serving metrics plus the recall
evidence the shadow verifier (:mod:`raft_tpu_torch.obs.quality`) produces:

- **burn rates** — per configured window, the fraction of requests gone
  bad (sheds + deadline misses + latency over the SLO threshold) divided
  by the error budget (1 − availability target), from deltas over a
  timestamped ring of metric snapshots. Exposed as
  ``slo.burn_rate{window=}`` gauges; a window burning over
  ``burn_threshold`` counts ``slo.burn_alert{window=}``. The latency
  histogram records only while observability is on, so the monitor reads
  its totals only then (as the JAX package's does).
- **recall floors, closed-loop** — a tenant admitted with
  ``recall_floor=r`` is *breached* when any served k's Wilson CI lower
  bound sits below ``r`` with enough evidence (``min_samples``). A breach
  (1) demotes the tenant to ``degraded`` (``/healthz`` flips), and (2)
  arms the degrade ladder's **quality gate**: rungs that trade recall
  (``bf16_lut`` / ``fp8_lut`` / ``decline_fused``) are refused for that
  tenant — counted ``degrade.refused{reason=recall_floor}`` — so overload
  *sheds* instead of silently serving bad answers. When fresh verdicts
  lift the CI back above the floor, the tenant is promoted back to
  ``serving`` and the gate disarms.

The monitor is registered process-globally (:func:`set_monitor`) so
``serve.dispatch`` — which cannot see the server object — can fetch the
quality gate for the tenant it is about to run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs.capacity import DeltaRing
from raft_tpu_torch.obs.metrics import counter_sum as _counter_sum

__all__ = ["SLOPolicy", "SLOMonitor", "set_monitor", "get_monitor",
           "clear_monitor"]


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Guardrail knobs. ``windows_s`` are the burn-rate lookbacks
    (short = fast detection, long = low noise — alert shape pairs
    them); ``availability_target`` sets the error budget;
    ``latency_slo_s`` counts completions over it as bad (None = only
    sheds/misses burn budget); ``min_samples`` is the evidence bar a
    recall verdict window must clear before a floor can trip or
    recover (a floor must not flap on two unlucky samples)."""

    windows_s: Tuple[float, ...] = (30.0, 300.0)
    availability_target: float = 0.999
    burn_threshold: float = 2.0
    latency_slo_s: Optional[float] = None
    min_samples: int = 8


def _latency_totals(rows: List[Dict[str, Any]],
                    slo_s: Optional[float]) -> Tuple[float, float]:
    """(completions, completions within ``slo_s``) from the
    ``serve.latency_s`` histogram rows (cumulative buckets: the count
    at the smallest upper bound ≥ the threshold — standard
    histogram-quantile resolution)."""
    count = good = 0.0
    for r in rows:
        if r.get("kind") != "histogram" or r.get("name") != "serve.latency_s":
            continue
        count += float(r.get("count", 0))
        if slo_s is None:
            continue
        best_ub, best_cum = None, 0.0
        for key, cum in (r.get("buckets") or {}).items():
            ub = float("inf") if key == "+inf" else float(key)
            if ub >= slo_s and (best_ub is None or ub < best_ub):
                best_ub, best_cum = ub, float(cum)
        good += best_cum
    if slo_s is None:
        good = count
    return count, good


class SLOMonitor:
    """Burn-rate + recall-floor evaluation over a registry and (when
    sampling is on) a :class:`~raft_tpu_torch.obs.quality.RecallVerifier`.

    :meth:`evaluate` is cheap (one metrics collect + dict walks) and is
    driven from verdict callbacks and health scrapes — no timer thread
    of its own."""

    def __init__(self, registry: Any, verifier: Any = None,
                 policy: Optional[SLOPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.verifier = verifier
        self.policy = policy or SLOPolicy()
        self._clock = clock
        self._lock = _sanitize.monitored_lock("serve.slo")
        keep = max(self.policy.windows_s) * 1.5 if self.policy.windows_s \
            else 300.0
        # the multi-window delta ring, shared shape with the capacity
        # model (obs.capacity.DeltaRing)
        self._ring = DeltaRing(keep)
        self._floor_breached: set = set()

    # -- burn rates ---------------------------------------------------------
    def _totals(self) -> Dict[str, float]:
        if not _spans.enabled():
            return {"requests": 0.0, "bad": 0.0, "completed": 0.0,
                    "good": 0.0}
        rows = _spans.registry().collect()
        shed = _counter_sum(rows, "serve.shed")
        missed = _counter_sum(rows, "serve.deadline_missed")
        requests = _counter_sum(rows, "serve.requests")
        completed, good = _latency_totals(rows, self.policy.latency_slo_s)
        slow = max(completed - good, 0.0)
        return {"requests": requests, "bad": shed + missed + slow,
                "completed": completed, "good": good}

    def tick(self) -> None:
        """Append one timestamped totals snapshot and prune the ring."""
        now = self._clock()
        totals = self._totals()
        with self._lock:
            self._ring.append(now, totals)

    def burn_rates(self) -> Dict[float, float]:
        """Per-window burn rate: (bad/total within the window) over the
        error budget. 0.0 while a window holds no traffic."""
        self.tick()
        budget = max(1.0 - self.policy.availability_target, 1e-9)
        with self._lock:
            snaps = self._ring.snaps()
        if not snaps:
            return {w: 0.0 for w in self.policy.windows_s}
        now, newest = snaps[-1]
        out: Dict[float, float] = {}
        for w in self.policy.windows_s:
            base = DeltaRing.window_base(snaps, now, w)
            d_total = newest["requests"] - base["requests"]
            d_bad = newest["bad"] - base["bad"]
            burn = ((d_bad / d_total) / budget) if d_total > 0 else 0.0
            out[w] = burn
            if _spans.enabled():
                labels = {"window": f"{int(w)}s"}
                _spans.registry().gauge("slo.burn_rate",
                                        labels=labels).set(burn)
                if burn > self.policy.burn_threshold:
                    _spans.registry().inc("slo.burn_alert", labels=labels)
        return out

    # -- recall floors ------------------------------------------------------
    def _floor_state(self, tenant: Any) -> Optional[bool]:
        """True = breached, False = provably fine, None = not enough
        evidence either way (state holds)."""
        floor = getattr(tenant, "recall_floor", None)
        if floor is None or self.verifier is None:
            return False
        summary = self.verifier.recall_summary(tenant.name)
        seen = False
        for stats in summary.values():
            if stats.get("n", 0.0) < self.policy.min_samples:
                continue
            seen = True
            if stats.get("ci_low", 1.0) < float(floor):
                return True
        return False if seen else None

    def evaluate(self, tenant_name: Optional[str] = None) -> None:
        """Re-check burn rates and every tenant's recall floor, driving
        the closed loop: breach → demote + gate; recovery → promote +
        disarm. ``tenant_name`` narrows the floor check (the verdict
        callback path); burn gauges always refresh."""
        self.burn_rates()
        try:
            tenants = self.registry.resident()
        except Exception:  # noqa: BLE001 — registry mid-teardown
            return
        for tenant in tenants:
            if tenant_name is not None and tenant.name != tenant_name:
                continue
            breached = self._floor_state(tenant)
            if breached is None:
                continue
            with self._lock:
                was = tenant.name in self._floor_breached
                if breached and not was:
                    self._floor_breached.add(tenant.name)
                elif not breached and was:
                    self._floor_breached.discard(tenant.name)
                else:
                    continue
            if breached:
                if _spans.enabled():
                    _spans.registry().inc(
                        "slo.recall_floor_breach",
                        labels={"tenant": tenant.name})
                try:
                    self.registry.note_degraded(tenant.name)
                except Exception:  # noqa: BLE001
                    pass
                from raft_tpu_torch.core import logging as _log

                _log.warn("slo: tenant %r recall CI fell below floor "
                          "%.3f — degraded, quality rungs gated",
                          tenant.name, float(tenant.recall_floor))
            else:
                if _spans.enabled():
                    _spans.registry().inc(
                        "slo.recall_floor_recovered",
                        labels={"tenant": tenant.name})
                try:
                    self.registry.note_recovered(tenant.name)
                except Exception:  # noqa: BLE001
                    pass
                from raft_tpu_torch.core import logging as _log

                _log.info("slo: tenant %r recall recovered above its "
                          "floor — serving restored", tenant.name)
        if _spans.enabled():
            with self._lock:
                breached = set(self._floor_breached)
            for tenant in tenants:
                if getattr(tenant, "recall_floor", None) is not None:
                    ok = tenant.name not in breached
                    _spans.registry().gauge(
                        "slo.recall_floor_ok",
                        labels={"tenant": tenant.name}).set(
                            1.0 if ok else 0.0)

    # -- the degrade ladder's quality gate -----------------------------------
    def refuse_quality_rung(self, tenant_name: str, rung: str) -> bool:
        """True when ``tenant_name`` is floor-breached: the ladder must
        not take a recall-trading rung for a tenant already serving
        below its recall floor."""
        with self._lock:
            return tenant_name in self._floor_breached

    def quality_gate_for(self, tenant_name: str
                         ) -> Optional[Callable[[str], bool]]:
        """The per-dispatch gate callable for
        :func:`raft_tpu_torch.robust.degrade.quality_gate` — None when the
        tenant is un-breached (the common case costs dispatch one set
        lookup, no closure)."""
        with self._lock:
            if tenant_name not in self._floor_breached:
                return None
        return lambda rung: self.refuse_quality_rung(tenant_name, rung)

    def breached(self) -> List[str]:
        with self._lock:
            return sorted(self._floor_breached)

    # -- health payload ------------------------------------------------------
    def healthz(self) -> Dict[str, Any]:
        """The ``/healthz`` slo section: evaluated-on-scrape burn rates
        + floor-breached tenants (the degraded flip rides the
        registry's tenant states, which :meth:`evaluate` demotes)."""
        self.evaluate()
        burns = self.burn_rates()
        return {"burn_rates": {f"{int(w)}s": round(b, 4)
                               for w, b in burns.items()},
                "burn_threshold": self.policy.burn_threshold,
                "recall_floor_breached": self.breached()}


_monitor: Optional[SLOMonitor] = None
_monitor_lock = _sanitize.monitored_lock("serve.slo.monitor")


def set_monitor(monitor: Optional[SLOMonitor]) -> Optional[SLOMonitor]:
    """Install the process-global monitor (returns the previous one).
    The server installs its monitor at start and clears it at stop so
    dispatch can consult the quality gate without plumbing."""
    global _monitor
    with _monitor_lock:
        prev = _monitor
        _monitor = monitor
        return prev


def get_monitor() -> Optional[SLOMonitor]:
    return _monitor


def clear_monitor(monitor: Optional[SLOMonitor] = None) -> None:
    """Remove the global monitor; with an argument, only when it is
    still the installed one (a stop() racing a newer start() must not
    clear the newer server's monitor)."""
    global _monitor
    with _monitor_lock:
        if monitor is None or _monitor is monitor:
            _monitor = None
