"""Cost plane — per-tenant resource attribution (counterpart of
``raft_tpu.obs.cost``; the same ledger, series and payload).

A multi-tenant serving plane gets asked daily *which tenant is consuming
what share of device time, card memory, host-tier IO, and interconnect*.
Per-workload usage attribution is the substrate that turns admission,
eviction and placement knobs into control loops (Autopilot, Rzadca et
al., EuroSys '20; Monarch, Adams et al., VLDB '20) —
:mod:`raft_tpu_torch.obs.capacity` is the forecasting half that consumes
this ledger.

Every number is attributed from signals that already exist — the ledger
adds bookkeeping, not instrumentation:

- **device time** — the serving plane times each dispatched batch
  (``serve.dispatch`` wall time, device-inclusive: dispatch waits for the
  card to finish the batch) and calls :meth:`CostLedger.note_batch` with
  the batch's coalesced :class:`~raft_tpu_torch.obs.trace.RequestContext`
  member list. The batch's time is prorated equally across its *live*
  members — deadline-shed members were dropped before dispatch and get
  nothing; padding waste rides the members that produced the fill. Σ
  per-tenant ``cost.device_s`` equals Σ measured batch time by
  construction — the **conservation invariant**.
- **HBM byte-seconds** — :meth:`CostLedger.tick` integrates the
  registry's ``index.bytes{index=,tier=hbm}`` gauges over wall time
  (rectangle rule between ticks; admission/demotion events move the
  gauge, the next tick picks the new level up).
- **host-tier IO bytes** — the tiered reader
  (:mod:`raft_tpu_torch.neighbors.tiered`) counts ``cost.io_bytes{tenant=}``
  at its ``serve.row_read`` fetch; the ledger folds the counter in.
- **comms bytes** — ``cost.comms_bytes{tenant=,axis=ici|dcn}`` is folded
  in where a producer counts it; the port's sharded tier does not count
  it yet (ranks on one card move no bytes between cards), so its columns
  read 0.
- **shed / degrade / verify counts** — folded in from the existing
  ``serve.*`` / ``quality.*`` counters.

Published series: ``cost.device_s{tenant=}``, ``cost.hbm_byte_s{tenant=}``,
``cost.io_bytes{tenant=}`` (counter, from tiered),
``cost.comms_bytes{tenant=,axis=}``, and the normalized
``cost.share{tenant=}`` gauge the router's placement scoring reads.

Overhead contract: the serving tap is guarded by ``spans.enabled()`` — obs
off costs one flag check per batch and the ledger attributes nothing.
:meth:`note_batch` itself accumulates unconditionally (unit tests
exercise proration without global obs), but publishes gauges only while
recording is on.

The ledger is registered process-globally (:func:`set_ledger`, the
SLO-monitor install pattern) so dispatch — which cannot see the server
object — can reach it without plumbing. All locks ride
``monitored_lock`` so the lock-order tracker covers them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs.metrics import counter_sum

__all__ = ["CostLedger", "set_ledger", "get_ledger", "clear_ledger"]

#: counter families folded into :meth:`CostLedger.describe` per tenant
#: (name, label carrying the tenant, output key)
_FOLDED_COUNTERS: Tuple[Tuple[str, str, str], ...] = (
    ("serve.requests", "tenant", "requests"),
    ("cost.io_bytes", "tenant", "io_bytes"),
    ("quality.verified", "tenant", "verified"),
    ("serve.registry.demote", "tenant", "demotions"),
    ("serve.registry.preemptive_demote", "tenant", "preemptive_demotions"),
)


class CostLedger:
    """Thread-safe per-``(tenant, resource)`` attribution ledger.

    One instance per serving plane; the server creates it at start,
    installs it globally, and tears it down at stop. ``clock`` is
    injectable for deterministic byte-second integration in tests."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = _sanitize.monitored_lock("obs.cost")
        self._device_s: Dict[str, float] = {}
        self._members: Dict[str, int] = {}
        self._batch_wall_s = 0.0
        self._batches = 0
        self._hbm_byte_s: Dict[str, float] = {}
        # tenant -> (last tick monotonic time, last observed hbm bytes)
        self._hbm_last: Dict[str, Tuple[float, float]] = {}
        self._started = clock()

    # -- device time ---------------------------------------------------------
    def note_batch(self, device_s: float,
                   members: Sequence[str]) -> None:
        """Attribute one dispatched batch's wall time across its live
        member list (one entry per coalesced request, repeated tenant
        names allowed — a cross-tenant batch splits by member count).
        Shed members must not appear in ``members``: attribution
        follows work actually dispatched."""
        if device_s < 0.0 or not members:
            return
        per = float(device_s) / len(members)
        publish = _spans.enabled()
        with self._lock:
            self._batch_wall_s += float(device_s)
            self._batches += 1
            for t in members:
                self._device_s[t] = self._device_s.get(t, 0.0) + per
                self._members[t] = self._members.get(t, 0) + 1
            if publish:
                reg = _spans.registry()
                for t in set(members):
                    reg.gauge("cost.device_s",
                              labels={"tenant": t}).set(self._device_s[t])
                self._publish_shares_locked(reg)

    def _publish_shares_locked(self, reg: Any) -> None:
        total = sum(self._device_s.values())
        if total <= 0.0:
            return
        for t, v in self._device_s.items():
            reg.gauge("cost.share", labels={"tenant": t}).set(v / total)

    # -- HBM byte-second integration ----------------------------------------
    def tick(self) -> None:
        """Advance the HBM byte-second integrals from the current
        ``index.bytes{tier=hbm}`` gauge levels. Driven from scrapes,
        ``/costz``, admission events, and the flight section — the
        rectangle rule holds the *previous* level across the interval,
        so a demotion is charged at the pre-move level until observed."""
        if not _spans.enabled():
            return
        now = self._clock()
        levels: Dict[str, float] = {}
        for r in _spans.registry().collect():
            if r.get("kind") != "gauge" or r.get("name") != "index.bytes":
                continue
            labels = r.get("labels") or {}
            if labels.get("tier") == "hbm" and labels.get("index"):
                levels[str(labels["index"])] = float(r.get("value", 0.0))
        with self._lock:
            reg = _spans.registry()
            for t, level in levels.items():
                last_ts, last_level = self._hbm_last.get(t, (now, level))
                self._hbm_byte_s[t] = (self._hbm_byte_s.get(t, 0.0)
                                       + last_level * (now - last_ts))
                self._hbm_last[t] = (now, level)
                reg.gauge("cost.hbm_byte_s",
                          labels={"tenant": t}).set(self._hbm_byte_s[t])

    # -- reads ---------------------------------------------------------------
    def device_seconds(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._device_s)

    def shares(self) -> Dict[str, float]:
        """Normalized device-time shares (the placement signal). Falls
        back to HBM byte-second shares before any batch has run, so a
        freshly admitted fleet still ranks pods by real residency."""
        with self._lock:
            basis = self._device_s if sum(self._device_s.values()) > 0 \
                else self._hbm_byte_s
            total = sum(basis.values())
            if total <= 0.0:
                return {}
            return {t: v / total for t, v in basis.items()}

    def conservation(self) -> Dict[str, float]:
        """The invariant the checks gate on: Σ per-tenant device time
        must equal total measured batch time (within float noise —
        equality holds by construction; a looser ε is needed only when
        comparing against an *externally* measured load-generator
        total)."""
        with self._lock:
            attributed = sum(self._device_s.values())
            total = self._batch_wall_s
        err = abs(attributed - total) / total if total > 0 else 0.0
        return {"attributed_device_s": attributed,
                "batch_wall_s": total, "rel_err": err}

    def describe(self) -> Dict[str, Any]:
        """JSON-ready per-tenant ledger — the ``/costz`` body and the
        ``"cost"`` flight-dump section. Folds the registry's
        tenant-labeled counters (io, comms, sheds, verifies) in beside
        the ledger's own device/HBM attribution."""
        self.tick()
        rows: List[Dict[str, Any]] = []
        if _spans.enabled():
            rows = _spans.registry().collect()
        with self._lock:
            tenants = set(self._device_s) | set(self._hbm_byte_s)
            device = dict(self._device_s)
            members = dict(self._members)
            hbm = dict(self._hbm_byte_s)
            batches = self._batches
            wall = self._batch_wall_s
        for r in rows:
            labels = r.get("labels") or {}
            if labels.get("tenant"):
                tenants.add(str(labels["tenant"]))
        shares = self.shares()
        per_tenant: Dict[str, Any] = {}
        for t in sorted(tenants):
            comms = {
                axis: counter_sum(rows, "cost.comms_bytes",
                                  tenant=t, axis=axis)
                for axis in ("ici", "dcn")}
            entry: Dict[str, Any] = {
                "device_s": device.get(t, 0.0),
                "members": members.get(t, 0),
                "hbm_byte_s": hbm.get(t, 0.0),
                "comms_bytes": comms,
                "share": shares.get(t, 0.0),
            }
            for name, label, key in _FOLDED_COUNTERS:
                entry[key] = counter_sum(rows, name, **{label: t})
            per_tenant[t] = entry
        cons = self.conservation()
        return {
            "tenants": per_tenant,
            "totals": {"batches": batches, "batch_wall_s": wall,
                       "uptime_s": self._clock() - self._started,
                       "shed": counter_sum(rows, "serve.shed")},
            "conservation": cons,
        }


# -- process-global ledger (the slo-monitor install pattern) ----------------

_ledger: Optional[CostLedger] = None
_ledger_lock = _sanitize.monitored_lock("obs.cost.global")


def set_ledger(ledger: Optional[CostLedger]) -> Optional[CostLedger]:
    """Install the process-global ledger (returns the previous one).
    The server installs at start and clears at stop so dispatch can
    attribute batches without plumbing."""
    global _ledger
    with _ledger_lock:
        prev = _ledger
        _ledger = ledger
        return prev


def get_ledger() -> Optional[CostLedger]:
    return _ledger


def clear_ledger(ledger: Optional[CostLedger] = None) -> None:
    """Remove the global ledger; with an argument, only when it is
    still the installed one (a stop() racing a newer start() must not
    clear the newer server's ledger)."""
    global _ledger
    with _ledger_lock:
        if ledger is None or _ledger is ledger:
            _ledger = None
