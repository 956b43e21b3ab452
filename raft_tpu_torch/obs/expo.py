"""Live telemetry exposition — a scrapable serving process (counterpart of
``raft_tpu.obs.expo``; the same routes, family names and text format, so
``render_prometheus`` of the same rows is byte-equal in both packages).

Flight dumps and JSONL sinks are read after the fact and ``snapshot()``
in process; a serving loop needs its numbers *pullable while it runs*.
This module is the zero-dependency answer: a stdlib ``http.server`` endpoint
(daemon thread, bounded surface) exposing

- ``GET /metrics``  — the full registry in Prometheus text exposition
  format (version 0.0.4): ``# HELP``/``# TYPE`` per family, labeled
  counters and gauges, histograms as cumulative ``_bucket{le=...}`` +
  ``_sum`` + ``_count`` series. Dotted raft_tpu names sanitize to
  underscores (``serve.latency_s`` → ``raft_tpu_serve_latency_s``);
  the original dotted name rides in the HELP line.
- ``GET /healthz``  — JSON health: overall ``status`` plus the serving
  registry's per-tenant health states when a provider is wired
  (``200`` while at least one tenant is resident — or no registry is
  attached at all; ``503`` when a registry exists but nothing can
  serve).
- ``GET /flightz``  — triggers an on-demand flight dump
  (:func:`raft_tpu_torch.obs.flight.dump_now`) and returns its path: the
  "dump the black box NOW" button, no signal required.
- ``GET /indexz``   — JSON index-health introspection:
  per-tenant list-size skew, dead centroids, centroid drift, PQ
  quantization error, and tombstone density, computed on demand by the
  serving layer and cached on the tenant (404 while no provider is wired).
- ``GET /costz``    — JSON cost & capacity plane: the per-tenant
  resource-attribution ledger plus the capacity model's saturation
  forecast. Its providers come with the serving plane (ROADMAP A14);
  until one is wired it answers 404, as the JAX package's does.

``/metrics`` additionally exposes the standard ``process_*``
self-telemetry family (RSS, CPU seconds, open fds, uptime — stdlib
``resource``/``os``, :func:`process_rows`) so the endpoint is
scrapeable for its own footprint, not just the workload's. Those
families keep their conventional unprefixed names — dashboards and
scrape configs expect ``process_resident_memory_bytes``, not a
``raft_tpu_``-prefixed variant.

:class:`ExpoServer` is usable standalone around any instrumented loop
(``port=0`` binds an ephemeral port); the serving plane (ROADMAP A14)
starts and stops it. Stdlib-only; the scrape path reads the registry
through its own locks — zero instrumentation-side cost.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["ExpoServer", "render_prometheus", "prom_name",
           "parse_prometheus", "process_rows", "process_text"]

#: metric-name prefix — one namespace for every raft_tpu family
PROM_PREFIX = "raft_tpu_"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")
# one exposition line: name{labels} value — the label body is matched
# lazily and validated pair-by-pair (label VALUES may contain commas
# and escaped quotes/braces; a comma-split would corrupt them)
_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def prom_name(name: str) -> str:
    """Sanitize a dotted raft_tpu series name into a legal Prometheus
    metric name (``serve.latency_s`` → ``raft_tpu_serve_latency_s``)."""
    return PROM_PREFIX + _NAME_BAD.sub("_", name)


def _esc(value: Any) -> str:
    """Escape a label value per the text-format rules (backslash,
    newline, and double-quote — the value sits inside quotes)."""
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _esc_help(value: Any) -> str:
    """Escape HELP text per the text-format spec: ONLY backslash and
    newline — unlike label values, HELP is unquoted, so a ``\\"``
    there would be a literal backslash-quote to a spec-compliant
    parser (promtool flags it)."""
    return str(value).replace("\\", r"\\").replace("\n", r"\n")


def _labels_str(labels: Dict[str, str],
                extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_LABEL_BAD.sub("_", str(k))}="{_esc(v)}"'
        for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _num(v: Any) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(f) if f != int(f) else str(int(f))


def render_prometheus(rows: List[Dict[str, Any]]) -> str:
    """Render ``MetricsRegistry.collect()`` rows as Prometheus text
    exposition (format 0.0.4). One ``# HELP``/``# TYPE`` pair per
    family (first occurrence wins), histograms as cumulative
    ``_bucket{le=...}``/``_sum``/``_count`` — the shape every scraper
    and ``promtool check metrics`` understands."""
    by_family: Dict[str, List[Dict[str, Any]]] = {}
    kinds: Dict[str, str] = {}
    for r in rows:
        fam = prom_name(r.get("name", "unnamed"))
        kind = r.get("kind", "gauge")
        if kinds.setdefault(fam, kind) != kind:
            # name collision across kinds after sanitization — keep the
            # first family's kind, expose the latecomer suffixed so no
            # series silently disappears from the scrape
            fam = fam + "_" + kind
            kinds.setdefault(fam, kind)
        by_family.setdefault(fam, []).append(r)
    out: List[str] = []
    for fam in sorted(by_family):
        rows_f = by_family[fam]
        kind = kinds[fam]
        first = rows_f[0]
        out.append(f"# HELP {fam} raft_tpu series "
                   f"{_esc_help(first.get('name', fam))}")
        if kind == "histogram":
            out.append(f"# TYPE {fam} histogram")
            for r in rows_f:
                labels = r.get("labels") or {}
                buckets = r.get("buckets") or {}
                entries = sorted(
                    ((float("inf") if k == "+inf" else float(k), cum)
                     for k, cum in buckets.items()))
                for ub, cum in entries:
                    out.append(
                        f"{fam}_bucket"
                        f"{_labels_str(labels, {'le': _num(ub)})}"
                        f" {_num(cum)}")
                out.append(f"{fam}_sum{_labels_str(labels)} "
                           f"{_num(r.get('sum', 0.0))}")
                out.append(f"{fam}_count{_labels_str(labels)} "
                           f"{_num(r.get('count', 0))}")
        else:
            out.append(f"# TYPE {fam} "
                       f"{'counter' if kind == 'counter' else 'gauge'}")
            for r in rows_f:
                out.append(f"{fam}{_labels_str(r.get('labels') or {})} "
                           f"{_num(r.get('value', 0.0))}")
    return "\n".join(out) + "\n"


def _unescape(value: str) -> str:
    return re.sub(r"\\(.)",
                  lambda m: "\n" if m.group(1) == "n" else m.group(1),
                  value)


def _parse_labels(body: str, lineno: int) -> Dict[str, str]:
    """Parse one ``k="v",k2="v2"`` label body. Values are matched as
    quoted strings with escapes (a value may legally contain commas,
    braces, and ``\\"``), so splitting on raw commas would corrupt
    them; anything the pair grammar doesn't fully consume raises."""
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(body):
        m = _LABEL_PAIR_RE.match(body, pos)
        if not m:
            raise ValueError(
                f"malformed label body at line {lineno}: {body!r}")
        labels[m.group(1)] = _unescape(m.group(2))
        pos = m.end()
        if pos < len(body):
            if body[pos] != ",":
                raise ValueError(
                    f"malformed label body at line {lineno}: {body!r}")
            pos += 1
    return labels


def parse_prometheus(text: str) -> Dict[str, List[Dict[str, Any]]]:
    """Minimal text-format parser (the CI smoke's validity check, and a
    convenience for tests): returns ``{family: [{"labels", "value"}]}``
    with ``_bucket``/``_sum``/``_count`` series folded under their
    histogram family name. Raises ``ValueError`` on a malformed line —
    "parses cleanly" is the assertion."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(
                f"malformed exposition line {lineno}: {line!r}")
        name, body, value = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(body, lineno) if body else {}
        fam = re.sub(r"_(bucket|sum|count)$", "", name)
        out.setdefault(fam, []).append(
            {"series": name, "labels": labels,
             "value": float(value) if value not in ("+Inf", "-Inf")
             else float(value.replace("Inf", "inf"))})
    return out


#: process birth, for uptime (monotonic — wall-clock steps must not
#: make the process look younger/older than it is)
_PROC_START_MONO = time.monotonic()


def process_rows() -> List[Dict[str, Any]]:
    """The standard ``process_*`` self-telemetry family:
    RSS, CPU seconds, open fds, uptime — stdlib ``resource``/``os``
    only, best-effort (a metric whose source is unavailable on this
    platform is omitted, never a scrape failure)."""
    rows: List[Dict[str, Any]] = []
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        rows.append({"kind": "counter",
                     "name": "process_cpu_seconds_total",
                     "value": float(ru.ru_utime + ru.ru_stime)})
        rss = None
        try:
            with open("/proc/self/statm") as f:
                rss = (int(f.read().split()[1])
                       * os.sysconf("SC_PAGE_SIZE"))
        except (OSError, ValueError, IndexError):
            # ru_maxrss is the high-water mark in KB on Linux — a
            # coarser stand-in where /proc is absent
            rss = int(ru.ru_maxrss) * 1024
        rows.append({"kind": "gauge",
                     "name": "process_resident_memory_bytes",
                     "value": float(rss)})
    except (ImportError, OSError):
        pass
    try:
        rows.append({"kind": "gauge", "name": "process_open_fds",
                     "value": float(len(os.listdir("/proc/self/fd")))})
    except OSError:
        pass
    rows.append({"kind": "gauge", "name": "process_uptime_seconds",
                 "value": time.monotonic() - _PROC_START_MONO})
    return rows


def process_text() -> str:
    """:func:`process_rows` rendered as exposition text — appended to
    ``/metrics`` after the registry families. Names stay unprefixed
    (the Prometheus-conventional spellings scrape configs expect), so
    this renders directly instead of riding :func:`render_prometheus`
    and its ``raft_tpu_`` namespace."""
    out: List[str] = []
    for r in process_rows():
        name = r["name"]
        out.append(f"# HELP {name} process self-telemetry")
        out.append(f"# TYPE {name} {r['kind']}")
        out.append(f"{name} {_num(r['value'])}")
    return "\n".join(out) + "\n"


class ExpoServer:
    """The exposition endpoint: ``start()`` binds and serves on a
    daemon thread, ``stop()`` shuts down. ``port=0`` binds an
    ephemeral port (read it back from :attr:`port` after start).

    ``registry`` — a :class:`~raft_tpu_torch.obs.metrics.MetricsRegistry` or
    a zero-arg callable returning one (default: whatever
    ``obs.spans.registry()`` resolves at scrape time, so a registry
    swap mid-run is reflected).
    ``health`` — optional zero-arg callable returning the serving
    registry's ``describe()`` dict; drives ``/healthz``.
    ``flight_dump`` — optional zero-arg callable returning a dump path;
    default :func:`raft_tpu_torch.obs.flight.dump_now`.
    ``indexz`` — optional zero-arg callable returning the per-tenant
    index-health dict; drives ``GET /indexz``.
    ``costz`` — optional zero-arg callable returning the cost-plane
    dict (per-tenant ledger + capacity forecast); drives
    ``GET /costz``.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Any = None,
                 health: Optional[Callable[[], Dict[str, Any]]] = None,
                 flight_dump: Optional[Callable[[], Optional[str]]] = None,
                 indexz: Optional[Callable[[], Dict[str, Any]]] = None,
                 costz: Optional[Callable[[], Dict[str, Any]]] = None):
        self._port_req = int(port)
        self.host = host
        self._registry = registry
        self._health = health
        self._flight_dump = flight_dump
        self._indexz = indexz
        self._costz = costz
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- payload builders (shared with tests) -------------------------------
    def _resolve_registry(self) -> _metrics.MetricsRegistry:
        reg = self._registry
        if callable(reg):
            reg = reg()
        if reg is None:
            from raft_tpu_torch.obs import spans as _spans

            reg = _spans.registry()
        return reg

    def metrics_text(self) -> str:
        return (render_prometheus(self._resolve_registry().collect())
                + process_text())

    def health_payload(self) -> (int, Dict[str, Any]):
        """(status_code, body): 200 while serving is possible — no
        health provider at all, or at least one tenant resident
        (warming/serving/degraded); 503 when a registry is wired and
        every tenant is terminal (the "scrape says page someone"
        state). Tenant states ride in the body either way."""
        if self._health is None:
            return 200, {"status": "ok", "tenants": {}}
        try:
            desc = self._health() or {}
        except Exception as e:  # a sick registry is itself a 503
            return 503, {"status": "error", "error": repr(e)}
        tenants = {t.get("name", "?"): t.get("state", "?")
                   for t in desc.get("tenants", [])}
        resident = [n for n, s in tenants.items()
                    if s in ("warming", "serving", "degraded")]
        ok = bool(resident) or not tenants
        # the quality plane: a recall-floor breach or a
        # degraded tenant keeps serving (HTTP 200 — results still flow)
        # but the status string flips to "degraded" so orchestration
        # that reads the body sees quality trouble before users do
        slo = desc.get("slo") or {}
        degraded = (bool(slo.get("recall_floor_breached"))
                    or any(s == "degraded" for s in tenants.values()))
        status = "ok" if ok else "unavailable"
        if ok and degraded:
            status = "degraded"
        body: Dict[str, Any] = {
            "status": status,
            "tenants": tenants,
            "resident": len(resident),
            "resident_bytes": desc.get("resident_bytes"),
            "budget_bytes": desc.get("budget_bytes"),
        }
        if slo:
            body["slo"] = slo
        return (200 if ok else 503), body

    def flight_payload(self) -> (int, Dict[str, Any]):
        try:
            if self._flight_dump is not None:
                path = self._flight_dump()
            else:
                from raft_tpu_torch.obs import flight as _flight

                path = _flight.dump_now(reason="flightz")
        except Exception as e:
            return 500, {"status": "error", "error": repr(e)}
        if not path:
            return 500, {"status": "error",
                         "error": "flight dump unavailable"}
        return 200, {"status": "ok", "path": path}

    def indexz_payload(self) -> (int, Dict[str, Any]):
        """(status_code, body) for ``/indexz`` — the serving layer's
        per-tenant index-health dict. 404 when no provider is wired
        (standalone expo around a non-serving loop), 500 when the
        provider itself throws."""
        if self._indexz is None:
            return 404, {"status": "error",
                         "error": "no indexz provider wired"}
        try:
            return 200, (self._indexz() or {})
        except Exception as e:
            return 500, {"status": "error", "error": repr(e)}

    def costz_payload(self) -> (int, Dict[str, Any]):
        """(status_code, body) for ``/costz`` — the per-tenant cost
        ledger + capacity forecast. 404 when no provider is
        wired (standalone expo), 500 when the provider throws."""
        if self._costz is None:
            return 404, {"status": "error",
                         "error": "no costz provider wired"}
        try:
            return 200, (self._costz() or {})
        except Exception as e:
            return 500, {"status": "error", "error": repr(e)}

    # -- lifecycle ----------------------------------------------------------
    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return f"http://{self.host}:{self.port}" if self._httpd else None

    def start(self) -> "ExpoServer":
        if self._httpd is not None:
            return self
        expo = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        self._send(
                            200, expo.metrics_text().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/healthz":
                        code, doc = expo.health_payload()
                        self._send(code, json.dumps(doc).encode(),
                                   "application/json")
                    elif path == "/flightz":
                        code, doc = expo.flight_payload()
                        self._send(code, json.dumps(doc).encode(),
                                   "application/json")
                    elif path == "/indexz":
                        code, doc = expo.indexz_payload()
                        self._send(code, json.dumps(doc).encode(),
                                   "application/json")
                    elif path == "/costz":
                        code, doc = expo.costz_payload()
                        self._send(code, json.dumps(doc).encode(),
                                   "application/json")
                    else:
                        self._send(404, b'{"error": "not found"}',
                                   "application/json")
                except BrokenPipeError:  # scraper hung up mid-response
                    pass

        self._httpd = ThreadingHTTPServer((self.host, self._port_req),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="raft-tpu-expo", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ExpoServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
