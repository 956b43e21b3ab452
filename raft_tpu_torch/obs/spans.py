"""Dispatch counters and the tri-state env parser (the part of
``raft_tpu.obs.spans`` the sharded tier needs).

The JAX package counts dispatch decisions into its metrics registry while
observability is on. Here the counters are a plain dict, always on (one
dict increment per decision): ``count_dispatch("parallel.merge",
"ring_kernel")`` adds one to ``counts()["parallel.merge.dispatch"]
["ring_kernel"]``, and :func:`reset` clears them. ``chip_smoke.py`` reads
them to show which merge tier ran. The rest of ``obs`` (spans, traces,
the flight recorder) is not ported yet (ROADMAP A13).
"""

from __future__ import annotations

import os
from typing import Dict

_COUNTS: Dict[str, Dict[str, int]] = {}


def _inc(series: str, label: str) -> None:
    per = _COUNTS.setdefault(series, {})
    per[label] = per.get(label, 0) + 1


def count_dispatch(name: str, impl: str, **labels: str) -> None:
    """Count one dispatch decision under ``<name>.dispatch``, keyed by
    ``impl`` (extra labels join it as ``impl,key=value``)."""
    extra = "".join(f",{k}={v}" for k, v in sorted(labels.items()))
    _inc(name + ".dispatch", impl + extra)


def count_fallback(name: str, reason: str) -> None:
    """Count one declined preferred tier under ``<name>.fallback``, keyed
    by the reason."""
    _inc(name + ".fallback", reason)


def counts() -> Dict[str, Dict[str, int]]:
    """A copy of every counter: series → label → count."""
    return {s: dict(per) for s, per in _COUNTS.items()}


def reset() -> None:
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
