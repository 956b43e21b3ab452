"""Event recording — span timelines you can open in Perfetto
(counterpart of ``raft_tpu.obs.trace``; the same event and Chrome-trace
formats, so a file from either package loads in the other's :func:`load`).

The aggregate half of the observability layer (histograms in
:mod:`raft_tpu_torch.obs.metrics`) answers "how much time does stage X take
on average"; this module keeps the *event* half — which call ran when,
on which thread, for how long — the in-process counterpart of the
NVTX→nsys timeline the reference leans on (``core/nvtx.hpp``), minus
the externally-attached profiler.

- :class:`EventBuffer` — a bounded, thread-safe ring of span/counter
  events (default ~64k; oldest evicted, eviction counted). When event
  recording is on (``obs.enable(events=True)`` or
  ``RAFT_TPU_OBS_EVENTS=1``), every recording span appends one complete
  event at exit (dotted name, thread id, wall timestamp, duration,
  attached labels), and root-span HBM sampling appends counter events.
- :func:`export_chrome` — render the buffer as Chrome-trace JSON
  (``ph: "X"`` complete events, one track per thread, ``ph: "C"``
  counter tracks for the ``hbm.*`` gauges). The file loads directly in
  Perfetto / ``chrome://tracing``.
- :func:`merge` — merge per-process dumps (multichip/multihost runs) by
  remapping colliding pids, so an 8-process run renders as one timeline.

Everything here is stdlib-only and costs nothing until event
recording is enabled — the flight recorder (:mod:`raft_tpu_torch.obs.flight`)
snapshots the same buffer into its crash dumps.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from raft_tpu_torch.obs import sanitize as _sanitize

DEFAULT_CAPACITY = 65536

#: schema stamp written into exports so tools/obsdump.py can sniff files
#: (the JAX package's: the two packages write one format)
PRODUCER = "raft_tpu.obs.trace"


# ---------------------------------------------------------------------------
# request-scoped trace propagation
# ---------------------------------------------------------------------------

def new_trace_id() -> str:
    """A fresh 16-hex request trace id (64 random bits — collision-safe
    for any realistic retention window, short enough to grep)."""
    return os.urandom(8).hex()


class RequestContext:
    """One request's identity, carried through the serving pipeline.

    Minted where the request enters the system (the serving plane's
    ``submit()``, ROADMAP A14, or any caller) and installed — via
    :func:`use_request` — around every stage that works on the request's
    behalf (dispatch, retry, the degrade ladder, ``search_resilient``).
    While installed, every span event recorded on the thread is stamped
    with the context's labels, so ``obsdump --slowest`` can reassemble
    one request's full timeline from the shared event ring.

    ``trace_ids`` covers the coalesced case: a micro-batch dispatch
    works for MANY requests at once — its context carries every
    member's trace id, and a timeline query for any one of them matches
    the batch's spans too. ``tenant`` rides as a label; ``deadline``
    (a :class:`raft_tpu_torch.robust.retry.Deadline`) rides as plain state
    for stages that draw down the budget. Stdlib-only, immutable after
    construction."""

    __slots__ = ("trace_id", "trace_ids", "tenant", "deadline")

    def __init__(self, tenant: Optional[str] = None,
                 deadline: Optional[Any] = None,
                 trace_id: Optional[str] = None,
                 trace_ids: Optional[List[str]] = None):
        self.trace_id = trace_id or new_trace_id()
        self.trace_ids = list(trace_ids) if trace_ids else None
        self.tenant = tenant
        self.deadline = deadline

    def event_labels(self) -> Dict[str, Any]:
        """The labels stamped into span events recorded under this
        context (the batch form carries the member list)."""
        out: Dict[str, Any] = {}
        if self.trace_ids is not None:
            out["trace_ids"] = list(self.trace_ids)
        else:
            out["trace_id"] = self.trace_id
        if self.tenant is not None:
            out["tenant"] = self.tenant
        return out

    def matches(self, trace_id: str) -> bool:
        """True when this context works (at least partly) for
        ``trace_id`` — the single id or any coalesced member."""
        return (trace_id == self.trace_id
                or (self.trace_ids is not None
                    and trace_id in self.trace_ids))

    def __repr__(self) -> str:
        n = f" +{len(self.trace_ids)} coalesced" if self.trace_ids else ""
        return f"<RequestContext {self.trace_id}{n} tenant={self.tenant}>"


_request_tls = threading.local()


def current_request() -> Optional[RequestContext]:
    """The request context installed on THIS thread (None outside any
    request scope). One TLS read — cheap enough for span-exit paths."""
    return getattr(_request_tls, "ctx", None)


def set_request(ctx: Optional[RequestContext]
                ) -> Optional[RequestContext]:
    """Install ``ctx`` as the thread's current request; returns the
    previous one (low-level — prefer :func:`use_request`)."""
    prev = getattr(_request_tls, "ctx", None)
    _request_tls.ctx = ctx
    return prev


class use_request:
    """Context manager installing a :class:`RequestContext` for the
    covered block (nesting restores the outer context on exit)::

        with use_request(RequestContext(tenant="acme", deadline=dl)):
            dispatch(...)   # spans recorded here carry the trace id
    """

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[RequestContext]):
        self.ctx = ctx
        self._prev = None

    def __enter__(self) -> Optional[RequestContext]:
        self._prev = set_request(self.ctx)
        return self.ctx

    def __exit__(self, *exc) -> bool:
        set_request(self._prev)
        return False


def event_matches_trace(event: Dict[str, Any], trace_id: str) -> bool:
    """True when a buffer/flight event belongs to ``trace_id``'s
    timeline: its args carry the id directly or in a coalesced
    ``trace_ids`` list (the shared filter obsdump's ``--slowest``
    drill-down and the tests use)."""
    args = event.get("args") or {}
    if args.get("trace_id") == trace_id:
        return True
    ids = args.get("trace_ids")
    return isinstance(ids, (list, tuple)) and trace_id in ids


class EventBuffer:
    """Bounded thread-safe ring buffer of span/counter events.

    Events are plain dicts (JSON-ready). Span events::

        {"ph": "X", "name": "ivf_pq.search.scan", "ts": <wall s>,
         "dur": <s>, "tid": <thread id>, "tname": "MainThread",
         "args": {...} | None}

    Counter events (HBM gauges at root-span exit)::

        {"ph": "C", "name": "hbm.bytes_in_use{device=0}", "ts": <wall s>,
         "value": <float>}

    The ring holds ``capacity`` events; older ones evict silently but
    are counted (``dropped``) so exports can say the timeline is
    truncated rather than pretending it is complete.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive (got {capacity})")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._total = 0
        # RLock: the flight recorder snapshots the buffer from signal
        # handlers running on the interrupted main thread — a plain
        # Lock held by the interrupted record_span frame would deadlock
        self._lock = _sanitize.monitored_rlock("obs.trace.buffer")

    def record_span(self, name: str, ts: float, dur: float,
                    args: Optional[Dict[str, Any]] = None) -> None:
        """Append one complete span event (``ts``/``dur`` in seconds,
        ``ts`` = wall-clock begin)."""
        t = threading.current_thread()
        ev = {"ph": "X", "name": name, "ts": ts, "dur": dur,
              "tid": t.ident or 0, "tname": t.name}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)
            self._total += 1

    def record_counter(self, name: str, value: float,
                       ts: Optional[float] = None) -> None:
        """Append one counter sample (a Perfetto counter-track point)."""
        ev = {"ph": "C", "name": name, "value": float(value),
              "ts": time.time() if ts is None else ts}
        with self._lock:
            self._events.append(ev)
            self._total += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        """Copy of the retained events, oldest first."""
        with self._lock:
            return [dict(e) for e in self._events]

    @property
    def dropped(self) -> int:
        """How many events were evicted by the ring bound."""
        with self._lock:
            return max(0, self._total - len(self._events))

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


_global_buffer = EventBuffer()
_global_lock = _sanitize.monitored_lock("obs.trace.global")


def get_buffer() -> EventBuffer:
    """The process-global event buffer (what spans record into)."""
    return _global_buffer


def set_buffer(buffer: EventBuffer) -> EventBuffer:
    """Swap the process-global buffer (returns the previous one)."""
    global _global_buffer
    with _global_lock:
        prev = _global_buffer
        _global_buffer = buffer
        return prev


def _chrome_events(events: Iterable[Dict[str, Any]], pid: int
                   ) -> List[Dict[str, Any]]:
    """Lower buffer events to Chrome-trace dicts (µs timestamps) plus
    one thread_name metadata event per track."""
    out: List[Dict[str, Any]] = []
    tnames: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "X":
            ev = {"name": e["name"], "ph": "X", "pid": pid,
                  "tid": e.get("tid", 0),
                  "ts": float(e["ts"]) * 1e6,
                  "dur": float(e["dur"]) * 1e6}
            if e.get("args"):
                ev["args"] = e["args"]
            out.append(ev)
            tnames.setdefault(e.get("tid", 0), e.get("tname", ""))
        elif e.get("ph") == "C":
            out.append({"name": e["name"], "ph": "C", "pid": pid, "tid": 0,
                        "ts": float(e["ts"]) * 1e6,
                        "args": {"value": e.get("value", 0.0)}})
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name or f"thread-{tid}"}}
            for tid, name in sorted(tnames.items())]
    return meta + out


def export_chrome(path: str, buffer: Optional[EventBuffer] = None) -> int:
    """Write the buffer as Chrome-trace/Perfetto JSON; returns the
    number of (non-metadata) events exported.

    The output is the JSON-object form of the trace-event format
    (``{"traceEvents": [...]}``) with ``ph: "X"`` complete events, one
    named track per thread, and ``ph: "C"`` counter tracks — loadable
    in Perfetto and ``chrome://tracing`` as-is, mergeable across
    processes with :func:`merge`.
    """
    buf = buffer if buffer is not None else get_buffer()
    events = buf.snapshot()
    pid = os.getpid()
    doc = {
        "traceEvents": (
            [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
              "args": {"name": f"{socket.gethostname()}:{pid}"}}]
            + _chrome_events(events, pid)),
        "displayTimeUnit": "ms",
        "otherData": {"producer": PRODUCER, "pid": pid,
                      "host": socket.gethostname(),
                      "dropped_events": buf.dropped},
    }
    tmp = f"{path}.tmp.{pid}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(events)


def load(path: str) -> Dict[str, Any]:
    """Load a Chrome-trace JSON file (object or bare-array form) into
    the object form (``{"traceEvents": [...]}``)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # the bare-array spelling is also legal
        doc = {"traceEvents": doc}
    return doc


def merge(paths: Iterable[str], out_path: Optional[str] = None
          ) -> Dict[str, Any]:
    """Merge per-process Chrome-trace dumps into one timeline.

    Multichip/multihost runs export one file per process; pids can
    collide across hosts (and trivially do for the rank-0 convention),
    which would fold distinct processes onto one Perfetto track group.
    Colliding pids are remapped to fresh ids and every process track is
    named after its source file. Returns the merged document; writes it
    to ``out_path`` when given.
    """
    merged: List[Dict[str, Any]] = []
    used_pids: set = set()
    for p in paths:
        doc = load(p)
        events = doc.get("traceEvents", [])
        remap: Dict[int, int] = {}
        for e in events:
            pid = int(e.get("pid", 0))
            if pid not in remap:
                new = pid
                while new in used_pids:
                    new += 1
                remap[pid] = new
                used_pids.add(new)
        tag = os.path.basename(p)
        for pid, new in sorted(remap.items()):
            has_name = any(
                e.get("ph") == "M" and e.get("name") == "process_name"
                and int(e.get("pid", 0)) == pid for e in events)
            if not has_name or new != pid:
                merged.append({"name": "process_name", "ph": "M",
                               "pid": new, "tid": 0, "args": {"name": tag}})
        for e in events:
            e = dict(e)
            e["pid"] = remap.get(int(e.get("pid", 0)), e.get("pid", 0))
            merged.append(e)
    doc = {"traceEvents": merged, "displayTimeUnit": "ms",
           "otherData": {"producer": PRODUCER, "merged_from": len(used_pids)}}
    if out_path:
        tmp = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out_path)
    return doc
