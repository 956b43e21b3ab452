"""Flight recorder — telemetry that survives the process (counterpart of
``raft_tpu.obs.flight``; the same dump schema, fleet stamp, sections and
env names).

A process that is killed takes its in-memory numbers with it; the flight
recorder makes process death leave a black box behind:
``install(dump_dir)`` registers atexit + signal-chained dumping of

- the event ring buffer (:mod:`raft_tpu_torch.obs.trace` — the timeline),
- a full metrics-registry snapshot (spans, comm counters, HBM gauges),
- the last-N ``raft_tpu_torch`` log lines (a ring-buffer logging handler),

into a timestamped ``flight_*.json``. Periodic checkpointing
(``every_s`` or ``RAFT_TPU_FLIGHT_EVERY_S``) additionally rewrites a
``flight_<pid>_latest.json`` on a daemon thread, so even a SIGKILL'd
run leaves a dump at most one period old.

Signal handling CHAINS: the previous handler runs after the dump; an
unhandled signal re-raises its default disposition so exit codes stay
honest. Stdlib-only; nothing is registered until :func:`install`. A dump
with no directory named goes under ``RAFT_TPU_FLIGHT_DIR``, else
``raft_tpu_flight`` in the temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal
import socket
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from raft_tpu_torch.obs import sanitize as _sanitize

from raft_tpu_torch.obs import fleet as _fleet
from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs import trace as _trace

SCHEMA = "raft_tpu.flight/1"
# SIGINT rides beside SIGTERM/SIGALRM: a Ctrl-C'd *serving*
# process previously lost its flight dump — the one run a human was
# watching closely enough to interrupt is exactly the one whose shed /
# deadline counters they wanted. Chaining preserves KeyboardInterrupt:
# the prior handler (Python's default_int_handler unless the app
# replaced it) still runs after the dump.
DEFAULT_SIGNALS = ("SIGTERM", "SIGALRM", "SIGINT")
DEFAULT_LOG_LINES = 200


class _LogTail(logging.Handler):
    """Keep the last N formatted ``raft_tpu_torch`` log lines in a ring."""

    def __init__(self, maxlen: int):
        super().__init__()
        self.lines: deque = deque(maxlen=maxlen)
        self.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.lines.append(self.format(record))
        except Exception:  # a broken record must never kill the app
            pass


def _watchdog_kill_info() -> Optional[Dict[str, Any]]:
    """Parse the stall-kill sidecar ``tools/run_watchdog.sh`` exports
    via the ``WATCHDOG_KILL_INFO`` env var (a JSON file path the
    watchdog writes just before SIGTERM). None when unset, absent, or
    unparseable — a broken sidecar must never cost the dump."""
    path = os.environ.get("WATCHDOG_KILL_INFO", "")  # path value
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            info = json.load(f)
        return info if isinstance(info, dict) else {"raw": info}
    except Exception:
        return None


def _robust_state() -> Dict[str, Any]:
    """Active fault plan (rules + live hit/fire counts) and the recent
    degrade-ladder moves, via ``sys.modules`` — the robust package is
    never imported FROM a dump path (importing from a signal handler
    could re-enter a wedged import). {}
    when nothing robust is loaded or armed — and any failure stays
    silent: folding extras must never cost the dump."""
    out: Dict[str, Any] = {}
    try:
        faults_mod = sys.modules.get("raft_tpu_torch.robust.faults")
        if faults_mod is not None:
            plan = faults_mod.active_plan()
            if plan is not None:
                out["fault_plan"] = plan.describe()
                out["fault_fires"] = plan.fires()
        degrade_mod = sys.modules.get("raft_tpu_torch.robust.degrade")
        if degrade_mod is not None:
            steps = degrade_mod.recent_steps()
            if steps:
                out["degrade_recent"] = steps
    except Exception:
        return {}
    return out


# Pluggable dump sections: long-lived subsystems register a
# snapshot callable (the serving layer registers its IndexRegistry's
# describe() under "serve_registry") so every dump — crash, periodic,
# /flightz — carries their state without flight knowing their types.
_sections: Dict[str, Any] = {}
_sections_lock = _sanitize.monitored_rlock("obs.flight.sections")


def set_section(name: str, provider) -> None:
    """Register ``provider()`` (a zero-arg callable returning JSON-able
    data) to be folded into every dump under key ``name``. Re-setting a
    name replaces it. Providers run on the (possibly dying) dump path:
    they must be host-only and fast; any failure is swallowed."""
    with _sections_lock:
        _sections[name] = provider


def clear_section(name: str) -> None:
    """Remove a registered section (idempotent)."""
    with _sections_lock:
        _sections.pop(name, None)


def _section_snapshots() -> Dict[str, Any]:
    with _sections_lock:
        providers = dict(_sections)
    out: Dict[str, Any] = {}
    for name, fn in providers.items():
        try:
            out[name] = fn()
        except Exception:
            pass  # a sick provider must never cost the dump
    return out


def _resolve_signals(signals: Sequence) -> List[int]:
    out = []
    for s in signals:
        if isinstance(s, str):
            s = getattr(signal, s)
        out.append(int(s))
    return out


class FlightRecorder:
    """One per-process recorder; use :func:`install` for the singleton."""

    def __init__(self, dump_dir: str,
                 last_n_log_lines: int = DEFAULT_LOG_LINES):
        self.dump_dir = dump_dir
        self._t0 = time.time()
        self._prev_handlers: Dict[int, Any] = {}
        self._log_tail = _LogTail(last_n_log_lines)
        # RLock: a signal landing mid-dump re-enters dump() on the
        # same (main) thread — block the process' death on itself never
        self._dump_lock = _sanitize.monitored_rlock("obs.flight.dump")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._atexit_registered = False
        os.makedirs(dump_dir, exist_ok=True)
        from raft_tpu_torch.core import logging as _log

        _log.get_logger().addHandler(self._log_tail)

    # -- payload ------------------------------------------------------------
    def payload(self, reason: str) -> Dict[str, Any]:
        """The dump body — everything is already-materialized host data
        (no device round-trips: safe from a signal handler)."""
        buf = _trace.get_buffer()
        try:
            metrics = _spans.registry().snapshot()
        except Exception:  # a half-swapped registry must not lose the dump
            metrics = _metrics.get_registry().snapshot()
        out = {
            "schema": SCHEMA,
            "reason": reason,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "argv": list(sys.argv),
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "uptime_s": round(time.time() - self._t0, 3),
            # fleet identity: run_id + host/pid/rank + the
            # clock anchor pair, so obs.fleet.aggregate can merge this
            # dump with its pod siblings on one aligned timeline
            "fleet": _fleet.identity(),
            "metrics": metrics,
            "events": buf.snapshot(),
            "dropped_events": buf.dropped,
            "logs": list(self._log_tail.lines),
        }
        for name, body in _section_snapshots().items():
            out.setdefault(name, body)  # core keys are not overridable
        watchdog = _watchdog_kill_info()
        if watchdog is not None:
            # why an external supervisor killed us (tools/run_watchdog.sh
            # writes its stall-kill reason + elapsed time to the file
            # named by WATCHDOG_KILL_INFO just before SIGTERM) — the
            # dump then says WHY it was killed, not just that it was
            out["watchdog"] = watchdog
        robust = _robust_state()
        if robust:
            # the robust↔obs cross-link: what the chaos lane had
            # injected (active fault plan + live fire counts) and how
            # far the run had degraded (recent ladder moves), so a
            # killed chaos-lane run's dump says what was IN FLIGHT,
            # not just what died
            out["robust"] = robust
        return out

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> str:
        """Write one dump; returns its path. Re-entrancy-safe (a dump
        triggered while another is mid-write waits its turn) and atomic
        (tmp + rename), so a signal landing mid-dump can't leave a
        truncated JSON behind."""
        if path is None:
            stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            path = os.path.join(
                self.dump_dir, f"flight_{stamp}_{os.getpid()}.json")
        body = self.payload(reason)
        with self._dump_lock:
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(body, f)
                    # fsync BEFORE the rename: without it a power loss /
                    # SIGKILL after the (atomic) rename but before the
                    # data reaches disk can leave a zero-byte "latest"
                    # dump — the rename must never outrun its contents
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                # never leave tmp litter; the dump path either exposes a
                # complete file or nothing
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        return path

    # -- signal / atexit / periodic hooks -----------------------------------
    def install_signals(self, signals: Sequence = DEFAULT_SIGNALS) -> None:
        """Dump on the given signals, then CHAIN to the prior handler
        (or re-raise the default disposition) — the recorder observes
        the death, it does not change it."""
        for signum in _resolve_signals(signals):
            if signum in self._prev_handlers:
                continue

            def _handler(num, frame, _self=self):
                try:
                    _self.dump(reason=f"signal {num}")
                except Exception:
                    pass  # dying is the priority; a failed dump stays silent
                prev = _self._prev_handlers.get(num)
                if callable(prev):
                    prev(num, frame)
                elif prev != signal.SIG_IGN:
                    signal.signal(num, signal.SIG_DFL)
                    os.kill(os.getpid(), num)

            self._prev_handlers[signum] = signal.signal(signum, _handler)

    def install_atexit(self) -> None:
        if not self._atexit_registered:
            atexit.register(self._atexit_dump)
            self._atexit_registered = True

    def _atexit_dump(self) -> None:
        try:
            self.dump(reason="atexit")
        except Exception:
            pass

    def start_periodic(self, every_s: float) -> None:
        """Checkpoint ``flight_<pid>_latest.json`` every ``every_s``
        seconds on a daemon thread — the SIGKILL insurance."""
        if self._thread is not None or every_s <= 0:
            return
        latest = os.path.join(self.dump_dir,
                              f"flight_{os.getpid()}_latest.json")

        def loop():
            while not self._stop.wait(every_s):
                try:
                    self.dump(reason="periodic", path=latest)
                except Exception:
                    pass  # filesystem hiccups must not kill the thread

        self._thread = threading.Thread(
            target=loop, name="raft-tpu-flight", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the periodic thread and restore chained signal handlers
        (tests; production recorders live for the process)."""
        self._stop.set()
        if self._thread is not None:
            with _sanitize.blocking_region("join"):
                self._thread.join(timeout=5)
            self._thread = None
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):  # non-main thread / torn down
                pass
        self._prev_handlers.clear()
        from raft_tpu_torch.core import logging as _log

        _log.get_logger().removeHandler(self._log_tail)


_recorder: Optional[FlightRecorder] = None
_recorder_lock = _sanitize.monitored_lock("obs.flight.recorder")


def install(dump_dir: str,
            signals: Sequence = DEFAULT_SIGNALS,
            every_s: Optional[float] = None,
            last_n_log_lines: int = DEFAULT_LOG_LINES,
            use_atexit: bool = True) -> FlightRecorder:
    """Install the process flight recorder (idempotent: a second call
    returns the existing one). ``every_s=None`` reads
    ``RAFT_TPU_FLIGHT_EVERY_S`` (unset/0 → no periodic checkpoints);
    ``signals=()`` skips signal hooks for callers with handlers
    of their own."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            return _recorder
        rec = FlightRecorder(dump_dir, last_n_log_lines=last_n_log_lines)
        if every_s is None:
            raw = os.environ.get("RAFT_TPU_FLIGHT_EVERY_S", "")
            try:
                every_s = float(raw) if raw.strip() else 0.0
            except ValueError:
                every_s = 0.0
        if signals:
            rec.install_signals(signals)
        if use_atexit:
            rec.install_atexit()
        if every_s and every_s > 0:
            rec.start_periodic(every_s)
        _recorder = rec
        return rec


def installed() -> Optional[FlightRecorder]:
    return _recorder


def uninstall() -> None:
    """Tear down the singleton (tests)."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            _recorder.close()
            _recorder = None


def dump_now(reason: str = "manual",
             dump_dir: Optional[str] = None) -> Optional[str]:
    """Dump immediately; auto-installs a default recorder (no signal
    hooks) when none exists — the one-liner for crash paths like
    a script's exit handler. Returns the dump path, or None when even
    the dump directory can't be created."""
    rec = _recorder
    if rec is None:
        if dump_dir is None:
            dump_dir = os.environ.get(  # path value, not a flag
                "RAFT_TPU_FLIGHT_DIR",
                os.path.join(tempfile.gettempdir(), "raft_tpu_flight"))
        try:
            rec = install(dump_dir, signals=(), every_s=0.0)
        except Exception:
            return None
    try:
        return rec.dump(reason=reason)
    except Exception:
        return None
