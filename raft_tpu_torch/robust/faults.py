"""Fault-injection harness — named fault points driven by a fault plan
(counterpart of ``raft_tpu.robust.faults``; the same plan format, sites,
kinds and env names, so one plan drives both packages).

Every recovery path — retries, checkpointed resume, the degradation
ladder — is only trustworthy if it can be *exercised on demand* instead of
waiting for the next outage. Code threads named **fault points**
(``faultpoint("ivf_pq.search")``) through its failure-prone seams, and a
**fault plan** (env/JSON) decides which points fire and how.

With no plan installed a fault point is one ``None`` check — safe to
leave in production paths permanently (the same zero-overhead-when-off
discipline as the obs spans).

Plan format (JSON)::

    {"seed": 0,
     "faults": [
       {"site": "build.chunk_encode",   # fault-point name (exact match)
        "kind": "sigterm",              # what to do when it fires
        "after": 2,                     # fire on the Nth hit (default 1)
        "p": 1.0,                       # probability per eligible hit
        "times": 1}]}                   # max fires (0 = unlimited)

Kinds:

- ``"oom"``     — raise :class:`InjectedResourceExhausted` (message
  carries ``RESOURCE_EXHAUSTED``, so :mod:`raft_tpu_torch.robust.degrade`
  treats it exactly like a real allocator failure);
- ``"error"``   — raise :class:`FaultInjected` (marked ``transient``,
  so :mod:`raft_tpu_torch.robust.retry`'s default policy retries it);
- ``"sigterm"`` — ``os.kill(os.getpid(), SIGTERM)`` (exercises the
  partial-record and resumable-build paths);
- ``"sleep"``   — block for ``sleep_s`` seconds (exercises watchdog /
  deadline paths);
- ``"nan"``     — ``faultpoint`` returns ``"nan"``; callers that opt in
  pass their value through :func:`corrupt` to get it NaN-poisoned;
- ``"force"``   — ``faultpoint`` returns ``"force"``; guard sites
  (``*_mem_ok`` declines) check :func:`forced` to take their decline
  branch on demand.

Install a plan with :func:`install_plan` / :func:`load_plan`, or via
env: ``RAFT_TPU_FAULT_PLAN`` (path to a plan file) or
``RAFT_TPU_FAULT_PLAN_JSON`` (inline JSON) — read once, at the first
fault-point hit. Every fire counts ``faults.fired{site=...,kind=...}``
(``obs.spans``, always on).

Its only imports beyond the standard library are ``obs.spans`` and
``obs.sanitize``.
"""

from __future__ import annotations

import json
import os
import random
import signal
import time
from typing import Any, Dict, List, Optional

from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans

__all__ = [
    "FaultInjected", "InjectedResourceExhausted", "FaultPlan",
    "install_plan", "load_plan", "clear_plan", "active_plan",
    "faultpoint", "forced", "corrupt", "fires",
]


class FaultInjected(RuntimeError):
    """An injected generic failure (kind ``"error"``). ``transient`` is
    True so the default retry policy treats it as retryable — the
    injection vehicle for exercising retry sites."""

    transient = True

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at {site!r}")
        self.site = site


class InjectedResourceExhausted(FaultInjected):
    """An injected allocator failure (kind ``"oom"``). The message
    carries ``RESOURCE_EXHAUSTED`` so ``degrade.is_resource_exhausted``
    matches it exactly like a real allocator OOM; ``transient`` is False —
    blind retry of an OOM is the degradation ladder's anti-pattern."""

    transient = False

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(site, message or (
            f"RESOURCE_EXHAUSTED: injected OOM at {site!r}"))


_KINDS = ("oom", "error", "sigterm", "sleep", "nan", "force")


class _Rule:
    """One plan entry, with its per-process hit/fire bookkeeping."""

    __slots__ = ("site", "kind", "after", "p", "times", "sleep_s",
                 "message", "hits", "fired")

    def __init__(self, spec: Dict[str, Any]):
        self.site = str(spec["site"])
        self.kind = str(spec.get("kind", "error"))
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {_KINDS})")
        self.after = max(1, int(spec.get("after", 1)))
        self.p = float(spec.get("p", 1.0))
        self.times = int(spec.get("times", 1))  # 0 = unlimited
        self.sleep_s = float(spec.get("sleep_s", 1.0))
        self.message = spec.get("message")
        self.hits = 0
        self.fired = 0


class FaultPlan:
    """A parsed fault plan: rules indexed by site, thread-safe hit
    accounting, deterministic probability draws (``seed``)."""

    def __init__(self, spec: Dict[str, Any]):
        if not isinstance(spec, dict) or "faults" not in spec:
            raise ValueError(
                "fault plan must be a JSON object with a 'faults' list")
        # RLock: a signal handler may snapshot the plan (describe() /
        # fires()) ON the interrupted main thread — a plain Lock held by
        # an interrupted check() would deadlock the dying process
        self._lock = _sanitize.monitored_rlock("robust.faults")
        self._rng = random.Random(int(spec.get("seed", 0)))
        self._by_site: Dict[str, List[_Rule]] = {}
        for entry in spec["faults"]:
            rule = _Rule(entry)
            self._by_site.setdefault(rule.site, []).append(rule)

    def sites(self) -> List[str]:
        return sorted(self._by_site)

    def check(self, site: str) -> Optional[_Rule]:
        """Record one hit at ``site``; return the rule that fires (first
        match wins) or None."""
        rules = self._by_site.get(site)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                rule.hits += 1
                if rule.times and rule.fired >= rule.times:
                    continue
                if rule.hits < rule.after:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                return rule
        return None

    def fires(self) -> Dict[str, int]:
        """``{site: total fires}`` — test/assertion helper."""
        with self._lock:
            return {site: sum(r.fired for r in rules)
                    for site, rules in self._by_site.items()
                    if any(r.fired for r in rules)}

    def describe(self) -> List[Dict[str, Any]]:
        """One dict per rule (site/kind/after/p/times + live hit/fire
        counts), so a killed chaos run can say what was injected, not
        just what died."""
        with self._lock:
            return [{"site": r.site, "kind": r.kind, "after": r.after,
                     "p": r.p, "times": r.times, "hits": r.hits,
                     "fired": r.fired}
                    for rules in self._by_site.values() for r in rules]


_plan: Optional[FaultPlan] = None
_env_checked = False
_env_lock = _sanitize.monitored_lock("robust.faults.env")


def install_plan(spec) -> FaultPlan:
    """Install a plan (dict, JSON string, or :class:`FaultPlan`);
    replaces any active plan. Returns the installed plan."""
    global _plan, _env_checked
    if isinstance(spec, str):
        spec = json.loads(spec)
    plan = spec if isinstance(spec, FaultPlan) else FaultPlan(spec)
    _plan = plan
    _env_checked = True  # an explicit install outranks the env
    return plan


def load_plan(path: str) -> FaultPlan:
    """Install a plan from a JSON file."""
    with open(path) as f:
        return install_plan(json.load(f))


def clear_plan() -> None:
    """Remove the active plan (tests); the env is NOT re-read."""
    global _plan, _env_checked
    _plan = None
    _env_checked = True


def active_plan() -> Optional[FaultPlan]:
    return _plan


def _maybe_arm_from_env() -> None:
    """One-time lazy arm from RAFT_TPU_FAULT_PLAN (path) or
    RAFT_TPU_FAULT_PLAN_JSON (inline) — checked at the first fault-point
    hit so importing this module never touches the filesystem."""
    global _env_checked
    if _env_checked:
        return
    with _env_lock:
        if _env_checked:
            return
        try:
            inline = os.environ.get("RAFT_TPU_FAULT_PLAN_JSON")  # JSON value
            path = os.environ.get("RAFT_TPU_FAULT_PLAN")  # path value
            if inline:
                install_plan(inline)
            elif path:
                load_plan(path)
        finally:
            _env_checked = True


def faultpoint(site: str) -> Optional[str]:
    """Declare a named fault point. No active plan (the production
    state): one None check, returns None. Under a plan whose rule fires
    here: raise (``oom``/``error``), die (``sigterm``), block
    (``sleep``), or return the kind (``"nan"``/``"force"``) for the
    caller to act on."""
    if _plan is None:
        if _env_checked:
            return None
        _maybe_arm_from_env()
        if _plan is None:
            return None
    rule = _plan.check(site)
    if rule is None:
        return None
    _spans.inc("faults.fired", site=site, kind=rule.kind)
    if rule.kind == "oom":
        raise InjectedResourceExhausted(site, rule.message)
    if rule.kind == "error":
        raise FaultInjected(site, rule.message)
    if rule.kind == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        # a chained/ignoring handler may survive the signal — give the
        # default disposition a beat, then keep going (the caller's
        # handlers own the death)
        time.sleep(0.5)
        return "sigterm"
    if rule.kind == "sleep":
        time.sleep(rule.sleep_s)
        return "sleep"
    return rule.kind  # "nan" / "force": the caller acts


def forced(site: str) -> bool:
    """True when a ``"force"`` fault fires at ``site`` — guard sites
    (``*_mem_ok`` declines) call this to take their decline branch on
    demand, making fallback paths CI-testable."""
    return faultpoint(site) == "force"


def corrupt(site: str, value):
    """Pass ``value`` through a ``"nan"`` fault point: when it fires,
    float arrays/scalars come back NaN-poisoned (numpy imported lazily —
    this module stays stdlib-only at import)."""
    if faultpoint(site) != "nan":
        return value
    try:
        import numpy as np

        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating):
            return np.full_like(arr, np.nan)
        return arr
    except Exception:
        return float("nan")


def fires() -> Dict[str, int]:
    """``{site: fires}`` of the active plan ({} when none)."""
    return _plan.fires() if _plan is not None else {}
