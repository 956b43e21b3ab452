"""Metrics registry — process-local counters, gauges, histograms
(counterpart of ``raft_tpu.obs.metrics``; the same kinds, buckets,
quantile rules, snapshot and JSONL formats).

The reference records per-stage timing only through external profilers
(NVTX ranges consumed by nsys); a serving loop needs the numbers *in
process*, without attaching a profiler. This registry is the sink the
span timers (:mod:`raft_tpu_torch.obs.spans`), the dispatch and fallback
counters and the device-memory telemetry (:mod:`raft_tpu_torch.obs.hbm`)
write into.

Design: deliberately tiny and dependency-free —

- three metric kinds (counter / gauge / histogram), each optionally
  labeled with a small ``dict`` of string labels (one time series per
  distinct label set, Prometheus-style);
- thread-safe: one registry lock for series creation, one lock per
  series for updates (hot-path updates never contend on the registry);
- ``snapshot()`` returns a plain nested dict (JSON-ready), and
  ``dump_jsonl(path)`` appends one self-describing JSON line per
  series — the format ``load_jsonl`` round-trips; files cross between
  the two packages both ways.

A process-global default registry backs the module-level helpers.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from raft_tpu_torch.obs import sanitize as _sanitize

# Default histogram bucket upper bounds (seconds-oriented: spans are the
# main histogram producer; 10 µs .. 10 min covers a dispatch through a
# chunked 100M-row build stage).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 60.0, 600.0)

#: exemplar reservoir bound per histogram bucket: enough to name a few
#: concrete offenders per latency band, small enough that a long-lived
#: serving histogram stays O(buckets × this) no matter the traffic
EXEMPLARS_PER_BUCKET = 4


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    if len(labels) == 1:  # a dispatch counter's impl: no sort
        (k, v), = labels.items()
        return ((str(k), str(v)),)
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render(name: str, lkey: Tuple[Tuple[str, str], ...]) -> str:
    """Stable display key: ``name`` or ``name{k=v,k2=v2}``."""
    if not lkey:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lkey) + "}"


class Counter:
    """Monotonic counter (one labeled series)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        # RLock: the flight recorder's signal handler snapshots these
        # structures ON the interrupted main thread — a plain Lock the
        # interrupted frame already holds would deadlock the dying
        # process (same for every lock on the snapshot path below)
        self._lock = _sanitize.monitored_rlock("obs.metrics.counter")

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError("counters only go up (got %r)" % (value,))
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set-to-current-value gauge (one labeled series)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = _sanitize.monitored_rlock("obs.metrics.gauge")  # signal-snapshot path, see Counter

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def max(self, value: float) -> None:
        """Keep the high-water mark (HBM peak sampling uses this)."""
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max (one labeled series).

    ``buckets`` are inclusive upper bounds; an implicit +inf bucket
    catches the tail (cumulative counts, Prometheus-style).
    """

    __slots__ = ("name", "labels", "buckets", "_bucket_counts", "_count",
                 "_sum", "_min", "_max", "_exemplars", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        self._bucket_counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        # per-bucket exemplar reservoirs: {bucket_index: [(value, id)]},
        # lazily created — an exemplar-less histogram pays nothing
        self._exemplars: Optional[Dict[int, List[Tuple[float, str]]]] = None
        self._lock = _sanitize.monitored_rlock("obs.metrics.histogram")  # signal-snapshot path, see Counter

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        """Record one sample. ``exemplar`` attaches an
        identity — a request trace id — to the sample: each bucket
        retains a bounded reservoir of its LARGEST exemplared values
        (:data:`EXEMPLARS_PER_BUCKET`), so a latency histogram's p99
        links directly to concrete slow requests instead of an
        anonymous bucket count."""
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            idx = len(self.buckets)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    idx = i
                    break
            self._bucket_counts[idx] += 1
            if exemplar is None:
                return
            if self._exemplars is None:
                self._exemplars = {}
            res = self._exemplars.setdefault(idx, [])
            if len(res) < EXEMPLARS_PER_BUCKET:
                res.append((value, str(exemplar)))
            else:
                # keep the worst offenders: replace the reservoir's
                # smallest value when the new sample exceeds it —
                # within a bucket the largest values are the ones a
                # tail drill-down wants named
                j = min(range(len(res)), key=lambda jj: res[jj][0])
                if value > res[j][0]:
                    res[j] = (value, str(exemplar))

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (None when empty) —
        Prometheus ``histogram_quantile`` semantics: linear
        interpolation inside the bucket holding the q-th sample,
        clamped to the observed min/max so coarse buckets never report
        a value outside the data. p50/p99 of search latency in the
        bench OBS rows and ``tools/obsdump.py`` come from here."""
        return quantile_from_state(self.state(), q)

    def state(self) -> Dict[str, Any]:
        with self._lock:
            cum, counts = 0, []
            for c in self._bucket_counts:
                cum += c
                counts.append(cum)
            out = {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "mean": (self._sum / self._count) if self._count else None,
                "buckets": {
                    **{repr(ub): counts[i]
                       for i, ub in enumerate(self.buckets)},
                    "+inf": counts[-1],
                },
            }
            if self._exemplars:
                # keyed like buckets (upper-bound repr / "+inf") so
                # JSONL rows and flight dumps round-trip alongside the
                # cumulative counts
                out["exemplars"] = {
                    ("+inf" if i >= len(self.buckets)
                     else repr(self.buckets[i])):
                    [{"value": v, "trace_id": t}
                     for v, t in sorted(res, reverse=True)]
                    for i, res in sorted(self._exemplars.items())}
            return out


class MetricsRegistry:
    """Thread-safe named-series registry (counters/gauges/histograms)."""

    def __init__(self) -> None:
        self._lock = _sanitize.monitored_rlock("obs.metrics.registry")  # signal-snapshot path, see Counter
        self._counters: Dict[Tuple[str, tuple], Counter] = {}
        self._gauges: Dict[Tuple[str, tuple], Gauge] = {}
        self._histograms: Dict[Tuple[str, tuple], Histogram] = {}

    # -- series accessors (get-or-create) ----------------------------------
    def counter(self, name: str,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(name, labels)
            return c

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge(name, labels)
            return g

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(name, labels, buckets)
            return h

    # -- shorthand update helpers ------------------------------------------
    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        self.counter(name, labels).inc(value)

    def set(self, name: str, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        self.gauge(name, labels).set(value)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                exemplar: Optional[str] = None) -> None:
        self.histogram(name, labels).observe(value, exemplar=exemplar)

    # -- export -------------------------------------------------------------
    def collect(self) -> List[Dict[str, Any]]:
        """Structured series list — one self-describing dict per series
        (``{"kind", "name", "labels", ...value/state}``), the shape
        ``dump_jsonl`` writes and the exposition endpoint
        (:mod:`raft_tpu_torch.obs.expo`) renders. Unlike :meth:`snapshot`,
        labels stay structured instead of rendered into the key."""
        with self._lock:
            rows: List[Dict[str, Any]] = []
            for (n, lk), c in self._counters.items():
                rows.append({"kind": "counter", "name": n,
                             "labels": dict(lk), "value": c.value})
            for (n, lk), g in self._gauges.items():
                rows.append({"kind": "gauge", "name": n,
                             "labels": dict(lk), "value": g.value})
            for (n, lk), h in self._histograms.items():
                rows.append({"kind": "histogram", "name": n,
                             "labels": dict(lk), **h.state()})
            return rows
    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: ``{"counters": {key: v}, "gauges": {key: v},
        "histograms": {key: state}}`` with ``name{k=v}`` rendered keys."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        return {
            "counters": {_render(n, lk): c.value for (n, lk), c in counters},
            "gauges": {_render(n, lk): g.value for (n, lk), g in gauges},
            "histograms": {_render(n, lk): h.state() for (n, lk), h in hists},
        }

    def dump_jsonl(self, path: str, extra: Optional[Dict[str, Any]] = None,
                   max_mb: Optional[float] = None,
                   keep: Optional[int] = None) -> int:
        """Append one JSON line per series to ``path``; returns the number
        of lines written. ``extra`` keys are merged into every line
        (the bench runner stamps dataset/index/search_param context).

        **Rotation**: an always-on serving process dumping
        periodically would otherwise grow the sidecar file without
        bound. When the file already holds ≥ ``max_mb`` MB (default:
        ``RAFT_TPU_OBS_JSONL_MAX_MB``; unset/0 = unbounded — the
        one-shot bench behavior, unchanged), it is rotated
        ``path → path.1 → path.2 …`` keeping ``keep`` rotated files
        (default ``RAFT_TPU_OBS_JSONL_KEEP`` or 3, oldest dropped),
        each move an atomic ``os.replace`` so a reader never sees a
        torn file."""
        rows = self.collect()
        if extra:
            for r in rows:
                r.update(extra)
        if max_mb is None:
            max_mb = _env_float("RAFT_TPU_OBS_JSONL_MAX_MB", 0.0)
        if max_mb and max_mb > 0:
            _rotate_jsonl(path, max_mb,
                          keep if keep is not None
                          else int(_env_float("RAFT_TPU_OBS_JSONL_KEEP", 3)))
        with open(path, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        return len(rows)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def _env_float(name: str, default: float) -> float:
    """Numeric env knob (a value, not a boolean flag — GL02 covers flag
    parsing; unparseable values fall back to the default)."""
    raw = os.environ.get(name, "")  # numeric value, not a flag
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


def _rotate_jsonl(path: str, max_mb: float, keep: int) -> None:
    """Size-capped rotation ``path → path.1 → … → path.keep`` (atomic
    renames, oldest dropped). No-op while ``path`` is under the cap or
    absent; never raises — a rotation hiccup must not cost the dump."""
    try:
        if not os.path.exists(path) or \
                os.path.getsize(path) < max_mb * (1 << 20):
            return
        keep = max(int(keep), 1)
        oldest = f"{path}.{keep}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(keep - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")
    except OSError:
        pass


def exemplars_for_quantile(state: Dict[str, Any], q: float
                           ) -> List[Dict[str, Any]]:
    """The exemplars nearest quantile ``q`` of a ``Histogram.state()``
    dict: the reservoir of the bucket holding the q-th sample, falling
    back outward (higher buckets first — a tail query wants the worst
    offenders) when that bucket recorded none. Returns
    ``[{"value", "trace_id"}, ...]`` sorted worst-first; ``[]`` when
    the histogram holds no exemplars at all. This is how a reported
    p99 resolves to concrete slow-request trace ids."""
    ex = state.get("exemplars") or {}
    if not ex or not state.get("count"):
        return []

    def _ub(key: str) -> float:
        return float("inf") if key == "+inf" else float(key)

    entries = sorted(((_ub(k), cum) for k, cum in
                      (state.get("buckets") or {}).items()))
    rank = min(max(float(q), 0.0), 1.0) * state["count"]
    target_keys = [k for k, _ in sorted(
        ((k, _ub(k)) for k in ex), key=lambda kv: kv[1])]
    # the bucket holding the q-th sample
    prev_cum, q_ub = 0, float("inf")
    for ub, cum in entries:
        if cum >= rank and cum - prev_cum > 0:
            q_ub = ub
            break
        prev_cum = cum
    # exact bucket first, then above (worse), then below
    above = [k for k in target_keys if _ub(k) >= q_ub]
    below = [k for k in reversed(target_keys) if _ub(k) < q_ub]
    for key in above + below:
        res = ex.get(key)
        if res:
            return sorted(res, key=lambda e: -float(e.get("value", 0.0)))
    return []


def quantile_from_state(state: Dict[str, Any], q: float
                        ) -> Optional[float]:
    """Bucket-interpolated quantile from a ``Histogram.state()`` dict
    (works on live states, JSONL rows, and flight-dump snapshots alike
    — the buckets are cumulative counts keyed by upper bound)."""
    count = state.get("count") or 0
    if not count:
        return None
    lo_clamp = state.get("min")
    hi_clamp = state.get("max")
    entries = []
    for key, cum in (state.get("buckets") or {}).items():
        ub = float("inf") if key == "+inf" else float(key)
        entries.append((ub, cum))
    entries.sort()
    if not entries:
        return hi_clamp
    rank = min(max(float(q), 0.0), 1.0) * count
    prev_cum, lower = 0, 0.0
    for ub, cum in entries:
        in_bucket = cum - prev_cum
        if cum >= rank and in_bucket > 0:
            if ub == float("inf"):
                est = hi_clamp if hi_clamp is not None else lower
            else:
                est = lower + (rank - prev_cum) / in_bucket * (ub - lower)
            if lo_clamp is not None:
                est = max(est, lo_clamp)
            if hi_clamp is not None:
                est = min(est, hi_clamp)
            return float(est)
        prev_cum = cum
        if ub != float("inf"):
            lower = ub
    return float(hi_clamp) if hi_clamp is not None else None


def counter_sum(rows: List[Dict[str, Any]], name: str,
                **match: str) -> float:
    """Sum every counter series named ``name`` whose labels carry all
    of ``match`` (subset match — unmatched extra labels are fine) over
    a :meth:`MetricsRegistry.collect` row list. The delta machinery in
    the SLO monitor, the cost ledger's counter folds, and the capacity
    model's arrival rates all aggregate through here."""
    total = 0.0
    for r in rows:
        if r.get("kind") == "counter" and r.get("name") == name:
            labels = r.get("labels") or {}
            if all(labels.get(k) == v for k, v in match.items()):
                total += float(r.get("value", 0.0))
    return total


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a ``dump_jsonl`` file back into a list of series dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


_global_registry = MetricsRegistry()
_global_lock = _sanitize.monitored_lock("obs.metrics.global")


def get_registry() -> MetricsRegistry:
    """The process-global default registry (what spans record into and
    ``DeviceResources.metrics`` hands out unless overridden)."""
    return _global_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (returns the previous one) — the
    bench runner installs a fresh one per measured row."""
    global _global_registry
    with _global_lock:
        prev = _global_registry
        _global_registry = registry
        return prev
