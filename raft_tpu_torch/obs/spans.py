"""Span timers — stage-level wall/device timing into the metrics registry
(counterpart of ``raft_tpu.obs.spans``), and the port's counters.

A :class:`span` times the covered region and writes a
``span.<dotted.name>`` histogram (seconds) into the registry, so per-stage
latency is readable in process. While a ``torch.profiler`` capture runs,
every span also opens a ``record_function`` range of its name, so the
stage shows on the trace beside the kernels it covers.

Semantics (the JAX package's):

- **Off by default, near-zero when off.** ``span.__enter__``/``__exit__``
  check module flags and return — no clock read, no lock and NO sync
  point, so the launch pipeline stays fully asynchronous.
- **Nested spans dot-join**: a ``span("scan")`` inside the traced
  ``ivf_pq.search`` entry records under ``span.ivf_pq.search.scan``. The
  stack is thread-local.
- **Sync mode** (``enable(sync=True)``): at the exit of a root span (the
  outermost on its thread) with a CUDA tensor attached via
  :meth:`span.attach`, the host waits for the work on the current CUDA
  stream before the clock stops, so the span measures the card's time to
  finish, not launch time (the JAX package blocks on the attached
  arrays). A nested span with a CUDA tensor attached is timed by CUDA
  events recorded on the current stream at its enter and exit, read once
  its root has waited: the device time of its stage. A wait at every
  nested exit would stop the host from launching the next stage while
  the card finishes this one — the JAX package's stages are compiled
  programs the host launches in microseconds, the port's are eager
  operations that cost the host tens of microseconds each.
- **Capture-safe**: inside a CUDA-graph capture or a ``torch.compile``
  trace, spans disable themselves — a host timer there would time the
  capture once and nothing on replays, and a synchronize inside a
  capture raises (the JAX package's "under a jit trace" rule).
- **Stage mode** (``enable(stages=True)``): hot paths that offer a
  stage-decomposed variant (``ivf_pq.search`` → ``search_staged``) route
  to it, trading fusion for per-stage attribution.

Env: ``RAFT_TPU_OBS=1`` enables at import; ``RAFT_TPU_OBS_SYNC=1``,
``RAFT_TPU_OBS_STAGES=1`` and ``RAFT_TPU_OBS_EVENTS=1`` (timeline event
recording into :mod:`raft_tpu_torch.obs.trace`) add the respective modes.

**Counters are always on** — a deliberate difference from the JAX package,
whose counters record only while observability is enabled.
:func:`count_dispatch` (``<name>.dispatch{impl=…}``),
:func:`count_fallback` (``<name>.fallback{reason=…}``), :func:`inc` and
:func:`set_value` write into :func:`registry` whether recording is on or
not (one locked increment an event), under the JAX package's series and
label names. :func:`counts`, :func:`total` and :func:`reset` are views
over that registry: ``counts()["ivf_pq.scan.dispatch"]`` is
``{"pallas_lut": 1}``, a dispatch's extra labels join its impl as
``"pallas_lut,filtered=1"``, a fallback is keyed by its reason, and any
other series by its sorted ``k=v`` labels (``""`` without labels).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from raft_tpu_torch.obs import metrics as _metrics

_enabled = False
_sync = False
_stages = False
_hbm_sample = True
_events = False
_registry: Optional[_metrics.MetricsRegistry] = None

_tls = threading.local()


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def enable(sync: bool = False, stages: bool = False,
           registry: Optional[_metrics.MetricsRegistry] = None,
           hbm: bool = True, events: bool = False) -> None:
    """Turn span recording on. ``sync`` times spans on the card (a root
    span waits for it at exit, a nested one reads CUDA events; see the
    module note); ``stages`` routes searches through their
    stage-decomposed variants; ``registry`` overrides the global sink;
    ``hbm`` samples device-memory gauges at root-span exit; ``events``
    additionally appends one timeline event per span exit (plus memory
    counter samples) into the :mod:`raft_tpu_torch.obs.trace` ring buffer
    for Chrome-trace/Perfetto export."""
    global _enabled, _sync, _stages, _registry, _hbm_sample, _events
    _sync = bool(sync)
    _stages = bool(stages)
    _registry = registry
    _hbm_sample = bool(hbm)
    _events = bool(events)
    _enabled = True


def disable() -> None:
    global _enabled, _sync, _stages, _registry, _events
    _enabled = False
    _sync = False
    _stages = False
    _events = False
    _registry = None


def _state():
    """Snapshot the enable state (for save/restore around a temporary
    enable that must not wipe a ``RAFT_TPU_OBS=1`` enable)."""
    return (_enabled, _sync, _stages, _registry, _hbm_sample, _events)


def _restore(state) -> None:
    global _enabled, _sync, _stages, _registry, _hbm_sample, _events
    _enabled, _sync, _stages, _registry, _hbm_sample, _events = state


def enabled() -> bool:
    return _enabled


def sync_enabled() -> bool:
    return _enabled and _sync


def stages_enabled() -> bool:
    return _enabled and _stages


def events_enabled() -> bool:
    return _enabled and _events


def registry() -> _metrics.MetricsRegistry:
    """The registry spans and counters currently record into."""
    return _registry if _registry is not None else _metrics.get_registry()


def current_name() -> str:
    """Dotted name of the innermost open span ('' outside any span)."""
    return ".".join(_stack())


# ---------------------------------------------------------------------------
# counters (always on)
# ---------------------------------------------------------------------------

def count_dispatch(name: str, impl: str, **labels: str) -> None:
    """Count one dispatch decision under ``<name>.dispatch{impl=...}`` —
    which engine actually ran. Counted once per call (the port's
    dispatchers are all eager; the JAX package counts its jitted callers
    once per trace). Extra keyword labels ride along (``filtered="1"``)."""
    registry().inc(name + ".dispatch", labels={"impl": impl, **labels})


def count_fallback(name: str, reason: str) -> None:
    """Count one *declined* preferred tier under
    ``<name>.fallback{reason=...}`` — why the preferred tier did not run."""
    registry().inc(name + ".fallback", labels={"reason": reason})


def inc(series: str, amount: float = 1, **labels) -> None:
    """Add ``amount`` to the counter ``series`` under its labels (``from``
    is a label name too: pass it as ``**{"from": ...}``)."""
    registry().inc(series, amount,
                   labels={k: str(v) for k, v in labels.items()})


def set_value(series: str, value: float, **labels) -> None:
    """Set the gauge ``series`` under its labels to ``value``."""
    registry().set(series, value,
                   labels={k: str(v) for k, v in labels.items()})


def _label_key(series: str, labels: Dict[str, str]) -> str:
    if series.endswith(".dispatch") and "impl" in labels:
        return labels["impl"] + "".join(
            f",{k}={v}" for k, v in sorted(labels.items()) if k != "impl")
    if series.endswith(".fallback") and set(labels) == {"reason"}:
        return labels["reason"]
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def counts() -> Dict[str, Dict[str, float]]:
    """Every counter and gauge of :func:`registry`: series → label key →
    value (keys as the module docstring says)."""
    out: Dict[str, Dict[str, float]] = {}
    for r in registry().collect():
        if r["kind"] in ("counter", "gauge"):
            out.setdefault(r["name"], {})[
                _label_key(r["name"], r["labels"])] = r["value"]
    return out


def total(series: str, **labels) -> float:
    """Sum of the counter or gauge ``series`` over every label set that
    includes ``labels``."""
    want = {k: str(v) for k, v in labels.items()}
    return sum(r["value"] for r in registry().collect()
               if r["kind"] in ("counter", "gauge") and r["name"] == series
               and all(r["labels"].get(k) == v for k, v in want.items()))


def reset() -> None:
    """Clear :func:`registry` (its counters, gauges and histograms)."""
    registry().reset()


# ---------------------------------------------------------------------------
# env parsing
# ---------------------------------------------------------------------------

def env_flag(name: str) -> bool:
    """Parse a boolean env var: unset, '', '0', 'false', 'off', 'no' are
    False; anything else is True (plain string truthiness would read
    ``RAFT_TPU_OBS=0`` as enabled)."""
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


def env_tristate(name: str, default: str = "auto") -> str:
    """``0/false/off/no/never`` → "off", ``1/true/on/yes/always`` → "on",
    unset, empty, ``auto`` or anything else → ``default``."""
    raw = os.environ.get(name, "").strip().lower()
    if raw in ("0", "false", "off", "no", "never"):
        return "off"
    if raw in ("1", "true", "on", "yes", "always"):
        return "on"
    return default


# ---------------------------------------------------------------------------
# the recording span
# ---------------------------------------------------------------------------

def _trace_clean() -> bool:
    """True outside a ``torch.compile`` trace and outside a CUDA-graph
    capture (safe to time, synchronize and reroute)."""
    compiler = getattr(torch, "compiler", None)
    if compiler is not None and compiler.is_compiling():
        return False
    return not (torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing())


def _profiling() -> bool:
    """True while a ``torch.profiler`` capture runs (torch's own flag)."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def _has_cuda(obj: Any) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (list, tuple)):
        return any(_has_cuda(o) for o in obj)
    if isinstance(obj, dict):
        return any(_has_cuda(o) for o in obj.values())
    return False


def _pending() -> list:
    """This thread's nested sync-mode spans waiting for their root's wait:
    (registry, event buffer, dotted name, wall begin, start event, end
    event, labels)."""
    p = getattr(_tls, "pending", None)
    if p is None:
        p = _tls.pending = []
    return p


def _resolve_pending() -> None:
    """Record the nested spans' CUDA-event times (their root has waited,
    so the events are complete)."""
    pending = _pending()
    if not pending:
        return
    items = pending[:]
    pending.clear()
    try:
        items[-1][5].synchronize()
        timed = [(it, it[4].elapsed_time(it[5]) / 1e3) for it in items]
    except RuntimeError:  # the card failed under the root: nothing to read
        return
    for (reg, events, dotted, wall0, _, _, labels), dt in timed:
        reg.histogram("span." + dotted).observe(dt)
        if events is not None:
            events.record_span(dotted, wall0, dt, args=labels)


class span:
    """Context manager timing one stage. Usage::

        with span("scan") as sp:
            out = scan(...)
            sp.attach(out)          # waited for at exit in sync mode

    Tensors may also be passed at construction: ``span("scan", out)``.
    ``labels`` (and :meth:`annotate`) attach key/values that ride into
    the timeline event's ``args`` when event recording is on.
    """

    __slots__ = ("name", "_arrays", "_t0", "_live", "_labels", "_range",
                 "_ev")

    def __init__(self, name: str, *arrays: Any,
                 labels: Optional[dict] = None):
        self.name = name
        self._arrays = list(arrays)
        self._t0 = 0.0
        self._live = False
        self._labels = labels
        self._range = None
        self._ev = None

    def attach(self, *arrays: Any) -> "span":
        """Register tensors (or nests of them) to wait for at exit when
        sync mode is on. No-op (and free) when spans are disabled."""
        if self._live and _sync:
            self._arrays.extend(arrays)
        return self

    def annotate(self, **labels: Any) -> "span":
        """Attach labels to this span's timeline event (event recording
        only). No-op (and free) when spans/events are disabled."""
        if self._live and _events:
            if self._labels is None:
                self._labels = {}
            self._labels.update(labels)
        return self

    def __enter__(self) -> "span":
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if not _enabled or not _trace_clean():
            return self
        self._live = True
        stack = _stack()
        stack.append(self.name)
        if _sync and len(stack) > 1 and torch.cuda.is_initialized():
            # a nested span's device time: an event at each end (see the
            # module note on sync mode)
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if self._live:
                self._record(exc_type is None)
        finally:
            if self._range is not None:
                self._range.__exit__(exc_type, exc, tb)
                self._range = None
        return False

    def _labels_now(self):
        from raft_tpu_torch.obs import trace as _trace

        args = self._labels
        # a span recorded while a RequestContext is installed on this
        # thread carries the request's trace id(s)
        ctx = _trace.current_request()
        if ctx is not None:
            args = {**(args or {}), **ctx.event_labels()}
        return args

    def _record(self, ok: bool) -> None:
        stack = _stack()
        root = len(stack) == 1
        try:
            # a raising block yields a truncated duration — don't mix it
            # into the same series as successful samples
            if ok:
                reg = registry()
                dotted = ".".join(stack)
                events = None
                if _events:
                    from raft_tpu_torch.obs import trace as _trace

                    events = _trace.get_buffer()
                card = _sync and _has_cuda(self._arrays)
                if card and self._ev is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    wall0 = time.time() - (time.perf_counter() - self._t0)
                    _pending().append(
                        (reg, events, dotted, wall0, self._ev, end,
                         self._labels_now() if events is not None
                         else None))
                else:
                    if card:
                        torch.cuda.current_stream().synchronize()
                    dt = time.perf_counter() - self._t0
                    if root:
                        _resolve_pending()
                    reg.histogram("span." + dotted).observe(dt)
                    if events is not None:
                        # wall-clock begin reconstructed from the monotonic
                        # duration: one clock read per exit, none per enter
                        events.record_span(dotted, time.time() - dt, dt,
                                           args=self._labels_now())
                # sample device memory only at ROOT-span exit: at a child
                # exit every ancestor's clock is still running
                if _hbm_sample and root:
                    from raft_tpu_torch.obs import hbm as _hbm

                    _hbm.sample(reg, events=events)
            if root:
                _resolve_pending()
        finally:
            stack.pop()
            self._live = False
            self._arrays = []
            self._ev = None


if env_flag("RAFT_TPU_OBS"):  # pragma: no cover - env-driven
    enable(sync=env_flag("RAFT_TPU_OBS_SYNC"),
           stages=env_flag("RAFT_TPU_OBS_STAGES"),
           events=env_flag("RAFT_TPU_OBS_EVENTS"))
