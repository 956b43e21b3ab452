"""Capacity plane — utilization accounting and saturation forecasting
(counterpart of ``raft_tpu.obs.capacity``; the same classes, series and
policy, a plain copy: the module is pure Python in both packages).

The cost ledger (:mod:`raft_tpu_torch.obs.cost`) answers *who is consuming
what*; this module answers *when does this serving plane run out of
headroom* — and feeds the answer back into the knobs that can act on it
(``IndexRegistry.admit`` demotes raw tiers preemptively, the
``FleetRouter`` places new tenants by cost-share-weighted headroom).

:class:`DeltaRing` is the SLO monitor's multi-window snapshot-delta
machinery: a bounded timestamped ring of totals dicts with per-window base
selection. The SLO monitor's burn rates and this module's rate windows
ride the same structure.

:class:`CapacityModel` keeps bounded rate windows and emits:

- ``capacity.utilization{resource=hbm|device}`` — HBM (the card's memory):
  resident bytes over the usable budget (instantaneous level); device:
  attributed device seconds over wall seconds, delta'd over the shortest
  window.
- ``capacity.headroom_frac`` — ``1 − max(utilization)``, the number the
  router's placement scoring wants.
- ``capacity.ttl_saturation_s`` — linear-trend time until resident bytes
  crosses the usable budget (least-squares slope over the longest window;
  ``inf`` while flat or shrinking).
- ``capacity.alert{resource=}`` — counted when a resource's utilization
  burns past ``CapacityPolicy.alert_utilization``, or when the HBM trend
  saturates inside ``horizon_s``.

The model is registered process-globally (:func:`set_model`) so the
registry's admission path — which cannot see the server object — can
consult the forecast. Locks ride ``monitored_lock`` for the lock-order
tracker; all math is stdlib (no numpy, no torch) so the module imports
anywhere the obs layer does.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs.metrics import counter_sum

__all__ = ["CapacityPolicy", "DeltaRing", "CapacityModel",
           "set_model", "get_model", "clear_model"]


class DeltaRing:
    """Bounded timestamped ring of totals snapshots with per-window
    base selection — the multi-window delta shape shared by the SLO
    monitor's burn rates and the capacity model's rate windows.

    Thread-safety is the *caller's*: both users already serialize
    appends under their own monitored lock, and a second lock here
    would only add an order edge for the sanitizer to track."""

    def __init__(self, keep_s: float):
        self.keep_s = float(keep_s)
        self._snaps: Deque[Tuple[float, Dict[str, float]]] = deque()

    def append(self, ts: float, totals: Dict[str, float]) -> None:
        """Append one snapshot and prune entries older than the keep
        window (relative to ``ts``)."""
        self._snaps.append((ts, totals))
        while self._snaps and ts - self._snaps[0][0] > self.keep_s:
            self._snaps.popleft()

    def snaps(self) -> List[Tuple[float, Dict[str, float]]]:
        return list(self._snaps)

    @staticmethod
    def window_base(snaps: List[Tuple[float, Dict[str, float]]],
                    now: float, window_s: float) -> Dict[str, float]:
        """The oldest snapshot inside ``window_s`` of ``now`` — the
        delta base. Falls back to the oldest snapshot held when the
        window predates the ring (short-uptime behavior: the window
        sees everything there is)."""
        for ts, totals in snaps:
            if now - ts <= window_s:
                return totals
        return snaps[0][1] if snaps else {}


@dataclasses.dataclass(frozen=True)
class CapacityPolicy:
    """Forecast knobs. ``windows_s``: rate lookbacks (shortest drives
    device utilization, longest drives the trend fit);
    ``horizon_s``: how far ahead admission looks — a projected HBM
    saturation inside it triggers preemptive demotion;
    ``alert_utilization``: the burn threshold past which
    ``capacity.alert`` counts; ``min_points``: snapshots a trend fit
    needs before it forecasts (two points make a line, not a trend)."""

    windows_s: Tuple[float, ...] = (30.0, 300.0)
    horizon_s: float = 600.0
    alert_utilization: float = 0.85
    min_points: int = 3


def _trend_slope(points: List[Tuple[float, float]]) -> float:
    """Least-squares slope of ``(t, y)`` points (units of y per
    second); 0.0 when degenerate."""
    n = len(points)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in points) / n
    my = sum(y for _, y in points) / n
    num = sum((t - mt) * (y - my) for t, y in points)
    den = sum((t - mt) ** 2 for t, _ in points)
    return num / den if den > 0 else 0.0


class CapacityModel:
    """Rate windows + saturation forecast over one serving plane.

    ``resident_bytes`` / ``usable_bytes`` are callables (duck-typed
    over the registry) so the obs layer stays below serve; ``ledger``
    is the cost ledger supplying attributed device seconds. ``clock``
    is injectable — the ramp tests drive synthetic time."""

    def __init__(self, resident_bytes: Callable[[], float],
                 usable_bytes: Callable[[], float],
                 ledger: Any = None,
                 policy: Optional[CapacityPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._resident = resident_bytes
        self._usable = usable_bytes
        self._ledger = ledger
        self.policy = policy or CapacityPolicy()
        self._clock = clock
        self._lock = _sanitize.monitored_lock("obs.capacity")
        keep = max(self.policy.windows_s) * 1.5 \
            if self.policy.windows_s else 450.0
        self._ring = DeltaRing(keep)

    # -- snapshots -----------------------------------------------------------
    def _totals(self) -> Dict[str, float]:
        try:
            resident = float(self._resident())
        except Exception:  # noqa: BLE001 — registry mid-teardown
            resident = 0.0
        device_s = 0.0
        if self._ledger is not None:
            device_s = sum(self._ledger.device_seconds().values())
        requests = 0.0
        if _spans.enabled():
            requests = counter_sum(_spans.registry().collect(),
                                   "serve.requests")
        return {"resident_bytes": resident, "device_s": device_s,
                "requests": requests}

    def tick(self) -> None:
        """Append one snapshot, refresh the ``capacity.*`` gauges, and
        count alerts. Driven from health scrapes, ``/costz``, and the
        admission path — no timer thread of its own (the SLO-monitor
        convention)."""
        now = self._clock()
        totals = self._totals()
        with self._lock:
            self._ring.append(now, totals)
        util = self.utilization()
        ttl = self.ttl_saturation_s()
        headroom = max(0.0, 1.0 - max(util.values(), default=0.0))
        if not _spans.enabled():
            return
        reg = _spans.registry()
        for resource, value in util.items():
            reg.gauge("capacity.utilization",
                      labels={"resource": resource}).set(value)
            if value > self.policy.alert_utilization:
                reg.inc("capacity.alert", labels={"resource": resource})
        reg.gauge("capacity.headroom_frac").set(headroom)
        reg.gauge("capacity.ttl_saturation_s").set(
            ttl if ttl != float("inf") else -1.0)
        if ttl < self.policy.horizon_s:
            reg.inc("capacity.alert", labels={"resource": "hbm"})

    # -- accounting ----------------------------------------------------------
    def utilization(self) -> Dict[str, float]:
        """Per-resource utilization: ``hbm`` is the instantaneous
        resident/usable level; ``device`` is attributed device seconds
        over wall seconds, delta'd over the shortest window."""
        try:
            usable = float(self._usable())
            resident = float(self._resident())
        except Exception:  # noqa: BLE001
            usable, resident = 0.0, 0.0
        out = {"hbm": (resident / usable) if usable > 0 else 0.0}
        with self._lock:
            snaps = self._ring.snaps()
        if snaps:
            now, newest = snaps[-1]
            w = min(self.policy.windows_s) if self.policy.windows_s \
                else 30.0
            base = DeltaRing.window_base(snaps, now, w)
            base_ts = next((ts for ts, t in snaps if t is base), now)
            d_wall = now - base_ts
            d_dev = newest.get("device_s", 0.0) - base.get("device_s", 0.0)
            out["device"] = (d_dev / d_wall) if d_wall > 0 else 0.0
        else:
            out["device"] = 0.0
        return out

    def headroom_frac(self) -> float:
        return max(0.0, 1.0 - max(self.utilization().values(),
                                  default=0.0))

    def arrival_rates(self) -> Dict[str, float]:
        """Per-tenant request arrival rate (req/s) from
        ``serve.requests{tenant=}`` deltas over the shortest window."""
        if not _spans.enabled():
            return {}
        rows = _spans.registry().collect()
        tenants = sorted({str((r.get("labels") or {}).get("tenant"))
                          for r in rows
                          if r.get("name") == "serve.requests"
                          and (r.get("labels") or {}).get("tenant")})
        if not tenants:
            return {}
        with self._lock:
            snaps = self._ring.snaps()
        if len(snaps) < 2:
            return {t: 0.0 for t in tenants}
        now = snaps[-1][0]
        w = min(self.policy.windows_s) if self.policy.windows_s else 30.0
        base = DeltaRing.window_base(snaps, now, w)
        base_ts = next((ts for ts, t in snaps if t is base), now)
        d_wall = max(now - base_ts, 1e-9)
        d_req = (snaps[-1][1].get("requests", 0.0)
                 - base.get("requests", 0.0))
        # totals ring carries the fleet aggregate; split it by the
        # current per-tenant counter proportions (bounded label sets
        # stay out of the ring — one dict per snapshot, not per tenant)
        per = {t: counter_sum(rows, "serve.requests", tenant=t)
               for t in tenants}
        total = sum(per.values())
        if total <= 0:
            return {t: 0.0 for t in tenants}
        return {t: (d_req / d_wall) * (v / total)
                for t, v in per.items()}

    # -- forecast ------------------------------------------------------------
    def _resident_slope(self) -> float:
        with self._lock:
            snaps = self._ring.snaps()
        if len(snaps) < self.policy.min_points:
            return 0.0
        return _trend_slope([(ts, t.get("resident_bytes", 0.0))
                             for ts, t in snaps])

    def ttl_saturation_s(self, extra_bytes: float = 0.0) -> float:
        """Linear-trend seconds until resident bytes (plus
        ``extra_bytes``, the admission candidate) crosses the usable
        budget. ``inf`` while the trend is flat/shrinking or already
        has no headroom to burn through; 0.0 when already over."""
        try:
            usable = float(self._usable())
            resident = float(self._resident()) + float(extra_bytes)
        except Exception:  # noqa: BLE001
            return float("inf")
        if usable <= 0:
            return float("inf")
        if resident >= usable:
            return 0.0
        slope = self._resident_slope()
        if slope <= 0.0:
            return float("inf")
        return (usable - resident) / slope

    def projected_growth_bytes(self,
                               horizon_s: Optional[float] = None) -> float:
        """Trend-projected resident-byte growth over the horizon —
        what the admission hook must free preemptively to outlive the
        forecast. 0.0 while flat/shrinking."""
        h = self.policy.horizon_s if horizon_s is None else horizon_s
        return max(0.0, self._resident_slope() * h)

    def would_saturate(self, extra_bytes: float = 0.0,
                       horizon_s: Optional[float] = None) -> bool:
        """The admission question: does the trend (plus the candidate's
        bytes) cross the usable budget inside the horizon?"""
        h = self.policy.horizon_s if horizon_s is None else horizon_s
        return self.ttl_saturation_s(extra_bytes=extra_bytes) < h

    def forecast(self) -> Dict[str, Any]:
        """JSON-ready forecast — the ``/costz`` ``"capacity"`` half."""
        ttl = self.ttl_saturation_s()
        return {
            "utilization": self.utilization(),
            "headroom_frac": self.headroom_frac(),
            "ttl_saturation_s": (ttl if ttl != float("inf") else None),
            "resident_slope_bytes_per_s": self._resident_slope(),
            "arrival_rates": self.arrival_rates(),
            "policy": dataclasses.asdict(self.policy),
        }


# -- process-global model (the slo-monitor install pattern) -----------------

_model: Optional[CapacityModel] = None
_model_lock = _sanitize.monitored_lock("obs.capacity.global")


def set_model(model: Optional[CapacityModel]) -> Optional[CapacityModel]:
    """Install the process-global capacity model (returns the previous
    one). The server installs at start and clears at stop so admission
    and placement can consult the forecast without plumbing."""
    global _model
    with _model_lock:
        prev = _model
        _model = model
        return prev


def get_model() -> Optional[CapacityModel]:
    return _model


def clear_model(model: Optional[CapacityModel] = None) -> None:
    """Remove the global model; with an argument, only when it is
    still the installed one."""
    global _model
    with _model_lock:
        if model is None or _model is model:
            _model = None
