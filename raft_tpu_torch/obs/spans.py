"""Counters, dispatch counters and the tri-state env parser (the part of
``raft_tpu.obs.spans`` the port needs so far).

The JAX package counts into its metrics registry while observability is
on. Here the counters are a plain dict, always on (one locked dict
increment per event): ``count_dispatch("parallel.merge", "ring_kernel")``
adds one to ``counts()["parallel.merge.dispatch"]["ring_kernel"]``, and
``inc("degrade.steps", site="ivf_pq.search", to="halve_batch")`` adds one
to ``counts()["degrade.steps"]["site=ivf_pq.search,to=halve_batch"]``
(labels sorted by name; ``""`` without labels). The series and label
names are the JAX package's: ``degrade.*``, ``faults.fired``, ``retry.*``,
``serve.prefetch.{hit,stall}`` and ``cost.io_bytes``. :func:`reset`
clears them; ``chip_smoke.py`` reads them to show which tier ran and how
a walk degraded. The rest of ``obs`` (the recording spans, traces, the
flight recorder) is not ported yet (ROADMAP A13).
"""

from __future__ import annotations

import os
import threading
from typing import Dict

_COUNTS: Dict[str, Dict[str, float]] = {}
# counters are bumped from the tiered prefetch reader thread too
_LOCK = threading.Lock()


def _key(labels: Dict[str, object]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _inc(series: str, label: str, amount: float = 1) -> None:
    with _LOCK:
        per = _COUNTS.setdefault(series, {})
        per[label] = per.get(label, 0) + amount


def inc(series: str, amount: float = 1, **labels) -> None:
    """Add ``amount`` to ``series`` under its labels (``from`` is a label
    name too: pass it as ``**{"from": ...}``)."""
    _inc(series, _key(labels), amount)


def set_value(series: str, value: float, **labels) -> None:
    """Set ``series`` under its labels to ``value`` (a gauge)."""
    with _LOCK:
        _COUNTS.setdefault(series, {})[_key(labels)] = value


def total(series: str, **labels) -> float:
    """Sum of ``series`` over every label set that includes ``labels``."""
    want = {f"{k}={v}" for k, v in labels.items()}
    with _LOCK:
        per = dict(_COUNTS.get(series, {}))
    return sum(v for key, v in per.items()
               if want <= set(key.split(",") if key else ()))


def count_dispatch(name: str, impl: str, **labels: str) -> None:
    """Count one dispatch decision under ``<name>.dispatch``, keyed by
    ``impl`` (extra labels join it as ``impl,key=value``)."""
    extra = "".join(f",{k}={v}" for k, v in sorted(labels.items()))
    _inc(name + ".dispatch", impl + extra)


def count_fallback(name: str, reason: str) -> None:
    """Count one declined preferred tier under ``<name>.fallback``, keyed
    by the reason."""
    _inc(name + ".fallback", reason)


def counts() -> Dict[str, Dict[str, float]]:
    """A copy of every counter: series → label → count."""
    with _LOCK:
        return {s: dict(per) for s, per in _COUNTS.items()}


def reset() -> None:
    with _LOCK:
        _COUNTS.clear()


def env_tristate(name: str, default: str = "auto") -> str:
    """``0/false/off/no/never`` → "off", ``1/true/on/yes/always`` → "on",
    unset, empty, ``auto`` or anything else → ``default``."""
    raw = os.environ.get(name, "").strip().lower()
    if raw in ("0", "false", "off", "no", "never"):
        return "off"
    if raw in ("1", "true", "on", "yes", "always"):
        return "on"
    return default


def env_flag(name: str) -> bool:
    """Unset, ``""``, ``0``, ``false``, ``off`` and ``no`` are False;
    anything else is True (the JAX package's parser)."""
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")
