"""Fleet aggregation — one view over several processes' flight dumps
(counterpart of ``raft_tpu.obs.fleet``; the same stamp, schema and env
names, so dumps of either package aggregate together).

A run over several hosts or processes emits one flight dump per process;
this module is the device-free aggregator that correlates them:

- **identity**: every flight dump carries a ``fleet`` stamp
  (:func:`identity`): a shared ``run_id`` (``RAFT_TPU_RUN_ID``, minted
  per process when unset), host name, pid, optional ``RAFT_TPU_RANK``,
  and a clock anchor pair.
- **clock alignment**: hosts' wall clocks disagree and monotonic
  epochs are per-boot. Each dump records ``(wall_s, mono_s)`` at dump
  time plus the shared wall anchor the launcher exported
  (``RAFT_TPU_RUN_ANCHOR`` — one ``time.time()`` stamped once, before
  the per-host processes fork). The aggregator re-expresses every
  event on one run-relative axis: ``ts − anchor`` when the anchor is
  present (cross-host alignment up to NTP discipline), else
  ``ts − min(wall)`` (same-host multi-process runs — the dryrun — are
  exact either way). The ``(wall − mono)`` residual per dump is
  reported as ``clock_skew_s`` so a stepped wall clock is visible
  instead of silently bending the timeline.
- **merging**: events fold into one timeline with host/pid attached to
  every event and colliding pids remapped — the same policy as
  :func:`raft_tpu_torch.obs.trace.merge` (which still serves raw
  Chrome-trace files); metrics counters sum across hosts with a
  ``host=`` label preserved per series in the per-host section.
- **straggler attribution**: per-host collective timing comes from the
  ``comms.*`` span events (host-side timed dispatches of collective-
  bearing programs — e.g. the distributed build's ``comms.allgatherv``
  spans). For each collective family the table names the slowest host,
  its mean, the fleet mean, and the skew fraction
  ``(slowest − fleet_mean) / fleet_mean`` — the "which device is
  dragging the pod" answer the reference gets from nsys timelines.

``tools/obsdump.py --fleet dump1.json dump2.json …`` renders the
result. Stdlib-only.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Dict, Iterable, List, Optional

from raft_tpu_torch.obs import sanitize as _sanitize

SCHEMA = "raft_tpu.fleet/1"

RUN_ID_ENV = "RAFT_TPU_RUN_ID"
ANCHOR_ENV = "RAFT_TPU_RUN_ANCHOR"
RANK_ENV = "RAFT_TPU_RANK"

#: span-event name prefixes that count as collective timing for the
#: straggler table (``comms.allgatherv``, ``comms.ring_topk``, ...)
COLLECTIVE_PREFIXES = ("comms.",)

_minted_lock = _sanitize.monitored_lock("obs.fleet.minted")
_minted_run_id: Optional[str] = None


def run_id() -> str:
    """The process's run id: ``RAFT_TPU_RUN_ID`` when the launcher
    exported one (the pod case — every host shares it), else minted
    once per process."""
    rid = os.environ.get(RUN_ID_ENV, "").strip()  # id value, not a flag
    if rid:
        return rid
    global _minted_run_id
    with _minted_lock:
        if _minted_run_id is None:
            _minted_run_id = os.urandom(6).hex()
        return _minted_run_id


def rank() -> Optional[int]:
    """``RAFT_TPU_RANK`` (the launcher's per-host index), or None."""
    raw = os.environ.get(RANK_ENV, "").strip()  # numeric value
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


def anchor_wall_s() -> Optional[float]:
    """The shared wall anchor (``RAFT_TPU_RUN_ANCHOR`` — the launcher's
    ``time.time()`` exported to every host), or None."""
    raw = os.environ.get(ANCHOR_ENV, "").strip()  # numeric value
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


def identity() -> Dict[str, Any]:
    """The fleet identity stamp :mod:`raft_tpu_torch.obs.flight` folds into
    every dump (host/process identity + run id + clock anchor)."""
    return {
        "run_id": run_id(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "rank": rank(),
        "anchor_wall_s": anchor_wall_s(),
        "wall_s": time.time(),
        "mono_s": time.monotonic(),
    }


def host_tag(fleet: Dict[str, Any]) -> str:
    """Stable display key for one dump's process: ``rank<r>`` when the
    launcher assigned ranks, else ``host:pid``."""
    r = fleet.get("rank")
    if r is not None:
        return f"rank{r}"
    return f"{fleet.get('host', '?')}:{fleet.get('pid', '?')}"


def _load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def clock_offset(fleet: Dict[str, Any], fallback_t0: float) -> float:
    """Seconds to subtract from this dump's wall timestamps to land on
    the run-relative axis: the shared anchor when present, else the
    fleet-wide fallback (min wall across dumps)."""
    anchor = fleet.get("anchor_wall_s")
    return float(anchor) if anchor is not None else float(fallback_t0)


def collective_family(name: str) -> Optional[str]:
    """The collective family of a span-event name, or None when the
    event is not collective timing. Spans dot-join under their caller's
    stack (``ivf_pq.build_distributed.comms.allgatherv``), so the
    family is the suffix from the first ``comms.`` segment — one family
    per collective verb regardless of which entry issued it."""
    for p in COLLECTIVE_PREFIXES:
        i = name.find(p)
        if i == 0 or (i > 0 and name[i - 1] == "."):
            return name[i:]
    return None


def straggler_table(events_by_host: Dict[str, List[Dict[str, Any]]]
                    ) -> List[Dict[str, Any]]:
    """Per-collective imbalance across hosts. Input: aligned span
    events per host tag. For every ``comms.*`` span family seen on ≥ 1
    host: per-host mean duration, the slowest host, and
    ``skew_frac = (slowest_mean − fleet_mean) / fleet_mean`` (0 when
    perfectly balanced). Sorted worst-skew first."""
    per: Dict[str, Dict[str, List[float]]] = {}
    for host, events in events_by_host.items():
        for e in events:
            if e.get("ph") != "X":
                continue
            fam = collective_family(e.get("name", ""))
            if fam is None:
                continue
            per.setdefault(fam, {}).setdefault(host, []).append(
                float(e.get("dur", 0.0)))
    rows: List[Dict[str, Any]] = []
    for name, by_host in sorted(per.items()):
        means = {h: sum(ds) / len(ds) for h, ds in by_host.items() if ds}
        if not means:
            continue
        fleet_mean = sum(means.values()) / len(means)
        slowest = max(means, key=lambda h: means[h])
        skew = ((means[slowest] - fleet_mean) / fleet_mean
                if fleet_mean > 0 else 0.0)
        rows.append({
            "collective": name,
            "hosts": len(means),
            "count": sum(len(ds) for ds in by_host.values()),
            "slowest": slowest,
            "slowest_mean_s": round(means[slowest], 6),
            "fleet_mean_s": round(fleet_mean, 6),
            "skew_frac": round(skew, 4),
            "per_host_mean_s": {h: round(m, 6)
                                for h, m in sorted(means.items())},
        })
    rows.sort(key=lambda r: -r["skew_frac"])
    return rows


def aggregate(paths: Iterable[str]) -> Dict[str, Any]:
    """Merge per-host flight dumps into one fleet view.

    Returns ``{"schema", "run_id", "run_ids", "hosts": [...],
    "events": [...], "counters": {...}, "stragglers": [...]}`` —
    events clock-aligned (run-relative ``ts``, each stamped with its
    ``host`` tag and a collision-free ``pid``), counters summed across
    hosts (per-host values preserved under ``hosts[i].counters``), and
    the straggler table computed from the ``comms.*`` span events.
    Dumps from different run_ids still merge (``run_ids`` lists them;
    callers that require one run assert on it) — a triage host should
    never refuse to read what it was handed. Several dumps from ONE
    process (periodic checkpoints + a final dump — all cumulative
    snapshots of the same registry and ring) dedupe: overlapping ring
    events count once, the process keeps one merged pid, and its
    latest dump's counters stand in for the process in the fleet
    totals (per-file raw counters stay under ``hosts[i].counters``)."""
    docs: List[Dict[str, Any]] = []
    for p in paths:
        doc = _load(p)
        doc["_path"] = p
        docs.append(doc)
    if not docs:
        return {"schema": SCHEMA, "run_id": None, "run_ids": [],
                "hosts": [], "events": [], "counters": {},
                "stragglers": []}
    fleets = [d.get("fleet") or {} for d in docs]
    run_ids = sorted({f.get("run_id") for f in fleets
                      if f.get("run_id")})
    # run-relative axis: shared anchor preferred, else the earliest
    # process start (wall − uptime), paired per dump — a dump without a
    # fleet stamp (an older dump) contributes nothing here but still
    # merges with zero offset against its siblings' origin
    origins = [f["wall_s"] - (d.get("uptime_s") or 0.0)
               for f, d in zip(fleets, docs) if f.get("wall_s")]
    fallback_t0 = min(origins, default=0.0)
    used_pids: set = set()
    hosts: List[Dict[str, Any]] = []
    merged_events: List[Dict[str, Any]] = []
    events_by_host: Dict[str, List[Dict[str, Any]]] = {}
    # cumulative-snapshot dedup: one PROCESS may contribute several
    # dumps (periodic checkpoints + a final/signal dump), and each is a
    # cumulative snapshot of the same registry and the same event ring.
    # Per (host, pid) process group: events dedupe on their identity
    # tuple (the ring contents overlap between dumps), the process
    # keeps ONE merged pid, and counters take the LATEST dump's values
    # (a cumulative snapshot supersedes every earlier one).
    merged_pid_by_proc: Dict[Any, int] = {}
    seen_events_by_proc: Dict[Any, set] = {}
    proc_counters: Dict[Any, tuple] = {}  # proc -> (wall, counters)
    first_skew_by_proc: Dict[Any, float] = {}
    for doc, fleet in zip(docs, fleets):
        tag = host_tag(fleet) if fleet else os.path.basename(
            doc.get("_path", "?"))
        offset = clock_offset(fleet, fallback_t0)
        pid = int(fleet.get("pid") or doc.get("pid") or 0)
        proc = (fleet.get("host", doc.get("host")), pid)
        new_pid = merged_pid_by_proc.get(proc)
        if new_pid is None:
            new_pid = pid
            while new_pid in used_pids:
                new_pid += 1  # the PR-5 merge() pid-collision policy
            used_pids.add(new_pid)
            merged_pid_by_proc[proc] = new_pid
        seen = seen_events_by_proc.setdefault(proc, set())
        aligned: List[Dict[str, Any]] = []
        for e in doc.get("events", []):
            # identity includes the args payload: two DISTINCT markers
            # can legitimately share (name, ts, dur, tid) — e.g. two
            # degrade.step events in the same rounded millisecond —
            # and must both survive; only true ring overlap dedupes
            ident = (e.get("ph"), e.get("name"), e.get("ts"),
                     e.get("dur"), e.get("tid"), e.get("value"),
                     json.dumps(e.get("args"), sort_keys=True,
                                default=str))
            if ident in seen:
                continue  # the same ring entry from an earlier dump
            seen.add(ident)
            e = dict(e)
            if "ts" in e:
                e["ts"] = float(e["ts"]) - offset
            e["host"] = tag
            e["pid"] = new_pid
            aligned.append(e)
        aligned.sort(key=lambda e: e.get("ts", 0.0))
        merged_events.extend(aligned)
        # extend, never assign: a process's every dump contributes its
        # (deduped) events to the straggler computation
        events_by_host.setdefault(tag, []).extend(aligned)
        host_counters = (doc.get("metrics") or {}).get("counters", {})
        wall = float(fleet.get("wall_s") or 0.0)
        prior = proc_counters.get(proc)
        if prior is None or wall >= prior[0]:
            proc_counters[proc] = (wall, host_counters)
        mono = fleet.get("mono_s")
        wall = fleet.get("wall_s")
        skew = (wall - mono if wall is not None and mono is not None
                else None)
        # wall − mono is constant per boot; a CHANGE between two dumps
        # of one process means the wall clock stepped mid-run — that
        # drift (not the boot-epoch-sized absolute) is the signal
        drift = None
        if skew is not None:
            first = first_skew_by_proc.setdefault(proc, skew)
            drift = skew - first
        hosts.append({
            "tag": tag,
            "path": doc.get("_path"),
            "host": fleet.get("host", doc.get("host")),
            "pid": pid,
            "merged_pid": new_pid,
            "rank": fleet.get("rank"),
            "run_id": fleet.get("run_id"),
            "offset_s": offset,
            "clock_skew_s": (round(skew, 6) if skew is not None
                             else None),
            "clock_drift_s": (round(drift, 6) if drift is not None
                              else None),
            "events": len(aligned),
            "dropped_events": doc.get("dropped_events", 0),
            "counters": dict(host_counters),
            "reason": doc.get("reason"),
        })
    merged_events.sort(key=lambda e: e.get("ts", 0.0))
    counters: Dict[str, float] = {}
    for _, host_counters in proc_counters.values():
        for key, v in host_counters.items():
            counters[key] = counters.get(key, 0.0) + float(v)
    return {
        "schema": SCHEMA,
        "run_id": run_ids[0] if len(run_ids) == 1 else None,
        "run_ids": run_ids,
        "hosts": hosts,
        "events": merged_events,
        "counters": counters,
        "stragglers": straggler_table(events_by_host),
    }


#: producer stamp for Chrome exports — the literal (not an import of
#: obs.trace) so a triage host can spec-load this file alone
PRODUCER = "raft_tpu.obs.trace"


def export_chrome(view: Dict[str, Any], path: str) -> int:
    """Render an :func:`aggregate` view as one Perfetto-loadable
    Chrome trace (µs timestamps, one process track per host tag)."""
    events: List[Dict[str, Any]] = []
    seen_pids: Dict[int, str] = {}
    for e in view.get("events", []):
        pid = int(e.get("pid", 0))
        seen_pids.setdefault(pid, e.get("host", str(pid)))
    for pid, name in sorted(seen_pids.items()):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})
    for e in view.get("events", []):
        pid = int(e.get("pid", 0))
        if e.get("ph") == "X":
            ev = {"name": e.get("name", "?"), "ph": "X", "pid": pid,
                  "tid": e.get("tid", 0),
                  "ts": float(e.get("ts", 0.0)) * 1e6,
                  "dur": float(e.get("dur", 0.0)) * 1e6}
            if e.get("args"):
                ev["args"] = e["args"]
            events.append(ev)
        elif e.get("ph") == "C":
            events.append({"name": e.get("name", "?"), "ph": "C",
                           "pid": pid, "tid": 0,
                           "ts": float(e.get("ts", 0.0)) * 1e6,
                           "args": {"value": e.get("value", 0.0)}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"producer": PRODUCER,
                         "schema": SCHEMA,
                         "run_id": view.get("run_id")}}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(events)
