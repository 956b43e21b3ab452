"""Graceful-degradation controller — a declared ladder instead of a crash
(counterpart of ``raft_tpu.robust.degrade``: the same rungs in the same
order, the same cursor rules, the same counter names).

A ``RESOURCE_EXHAUSTED`` from a search/build entry point is almost
never fatal to the *request* — it is fatal to the *configuration*:
the batch was too wide, the LUT too precise, the fused tier's
transients too big, the re-rank base resident where it need not be.
Production ANN services degrade through exactly those knobs instead of
500ing. This module formalizes that walk:

- :func:`is_resource_exhausted` classifies a real
  ``torch.OutOfMemoryError`` and the fault harness's
  :class:`~raft_tpu_torch.robust.faults.InjectedResourceExhausted`
  identically (so the ladder is CI-testable);
- a :class:`Ladder` declares ordered :class:`Step` rungs; each
  RESOURCE_EXHAUSTED advances one rung (``halve_batch → bf16_lut →
  fp8_lut → demote_raw → decline_fused → host_gather →
  halve_batch…``, see :func:`standard_search_ladder`);
- :func:`run_with_degradation` drives a callable through the ladder and
  counts every move: ``degrade.steps{site=,from=,to=,reason=}``, plus
  ``degrade.recovered{site=}`` / ``degrade.exhausted{site=}``
  (``obs.spans``, always on; the JAX package counts them only while its
  observability is on).

After a real allocator OOM the walk releases the caching allocator's
cached blocks (``torch.cuda.empty_cache()``) once before its next
attempt — the counterpart of XLA freeing the failed program's buffers,
part of the rung move and not a rung of its own.

It also owns :func:`note_step` — the *pre-emptive* half of the same
policy: the scattered ``*_mem_ok`` guards (LUT-scan, fused
gather-refine) that decline a tier before OOMing now record their
decline through the same ``degrade.steps`` counter, so "what ran
degraded and why" is one query over one metric family, whether the
degradation was reactive (caught OOM) or static (guard decline).

Entry-point wiring lives with the entry points:
``ivf_pq.search_resilient`` / ``ivf_flat.search_resilient`` wrap their
``search`` with :func:`standard_search_ladder`; ``ivf_pq.build_chunked``
halves an OOMing encode chunk (``half_chunk``).

Each move carries the current request's labels (``obs.trace
.RequestContext``) in :func:`recent_steps` and, with event recording on,
lands in the span-event ring as a zero-duration ``degrade.step`` marker.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs import trace as _trace
# one classifier for "is this an OOM": retry uses it to refuse blind
# re-execution, degrade uses it to trigger the ladder — shared so the
# two policies can never disagree about the same exception; Deadline /
# DeadlineExceeded are retry's request-scoped wall-clock budget that the
# ladder draws from between rungs
from raft_tpu_torch.robust.retry import (  # noqa: F401
    Deadline,
    DeadlineExceeded,
    is_resource_exhausted,
)

__all__ = [
    "is_resource_exhausted", "Deadline", "DeadlineExceeded",
    "Step", "Ladder", "DegradationExhausted",
    "run_with_degradation", "standard_search_ladder", "note_step",
    "batched_search_call", "recent_steps", "steps_seen", "clear_recent",
    "QUALITY_RUNGS", "quality_gate",
]

#: rungs that trade RECALL (not just latency) for staying up: LUT
#: precision cuts and the fused-tier decline change which neighbors
#: come back, unlike halve_batch/host_gather which only change cost.
#: The SLO monitor's quality gate refuses exactly these for a tenant
#: already serving below its recall floor.
QUALITY_RUNGS = ("bf16_lut", "fp8_lut", "decline_fused")

_gate_tls = threading.local()


class quality_gate:
    """Context manager installing a per-thread rung gate for the ladder
    walk it brackets: ``refuse(rung_name) -> bool`` — True refuses a
    :data:`QUALITY_RUNGS` rung (counted ``degrade.refused{reason=
    recall_floor,rung=}``), so an overloaded tenant below its recall
    floor sheds instead of silently serving worse answers. ``None``
    makes the bracket a no-op (the un-gated common case pays only the
    TLS save/restore). Thread-local, like the ladder walk itself: the
    gate a dispatch installs can never leak into another tenant's
    batch on a different thread."""

    __slots__ = ("_refuse", "_prev")

    def __init__(self, refuse: Optional[Callable[[str], bool]]):
        self._refuse = refuse
        self._prev = None

    def __enter__(self) -> "quality_gate":
        self._prev = getattr(_gate_tls, "refuse", None)
        _gate_tls.refuse = self._refuse
        return self

    def __exit__(self, *exc) -> None:
        _gate_tls.refuse = self._prev


def _rung_refused(name: str) -> bool:
    """True when the installed gate refuses this quality rung. A gate
    that RAISES does not refuse — a broken policy callback must fail
    open (degraded answers beat a crashed dispatch)."""
    if name not in QUALITY_RUNGS:
        return False
    refuse = getattr(_gate_tls, "refuse", None)
    if refuse is None:
        return False
    try:
        if not refuse(name):
            return False
    except Exception:  # noqa: BLE001 — fail open
        return False
    _count("degrade.refused", {"reason": "recall_floor", "rung": name})
    return True

# Bounded ring of the most recent ladder moves (reactive OOM rungs AND
# note_step guard declines) — so a run can say how far it had degraded.
# Deque appends are atomic under the GIL; no lock needed on this path.
_RECENT_MAX = 64
_recent: deque = deque(maxlen=_RECENT_MAX)
# monotonic per-THREAD count of moves noted — unlike len(recent_steps())
# it never saturates at the ring capacity, and unlike a process-global
# counter it cannot be bumped by a concurrent thread's ladder walk: a
# dispatcher bracketing its own synchronous call sees exactly its own
# moves (the ladder runs in the caller's stack), so "did MY call
# degrade?" stays answerable in a multi-threaded serving process
_steps_tls = threading.local()


def _note_recent(site: str, frm: str, to: str, reason: str) -> None:
    _steps_tls.n = getattr(_steps_tls, "n", 0) + 1
    entry = {"ts": round(time.time(), 3), "site": site,
             "from": frm, "to": to, "reason": reason}
    # a move made while a RequestContext is installed on this thread names
    # the request(s) it degraded for (ids ride only in this bounded ring
    # and the event, never as counter labels)
    ctx = _trace.current_request()
    if ctx is not None:
        entry.update(ctx.event_labels())
    _recent.append(entry)
    # with event recording on, the move also lands in the span-event ring
    # as a zero-duration marker beside the stage spans
    if _spans.events_enabled():
        args = {k: v for k, v in entry.items() if k != "ts"}
        _trace.get_buffer().record_span("degrade.step", entry["ts"], 0.0,
                                        args=args)


def recent_steps() -> List[Dict[str, Any]]:
    """The last ≤64 degradation moves (oldest first)."""
    return list(_recent)


def steps_seen() -> int:
    """Monotonic count of every ladder move noted ON THIS THREAD
    (reactive rungs AND guard declines). Callers bracketing a
    synchronous call to ask "did the ladder move during it?" must
    compare THIS, not ``len(recent_steps())`` — the ring saturates at
    its capacity, and the global ring also collects OTHER threads'
    moves."""
    return getattr(_steps_tls, "n", 0)


def clear_recent() -> None:
    """Reset the ring (tests; the monotonic counter keeps counting)."""
    _recent.clear()

@dataclasses.dataclass
class Step:
    """One rung: ``apply(knobs) -> new knobs`` or ``None`` when the rung
    does not apply to the current knobs (already taken / not
    applicable). ``repeatable`` rungs may fire again on later failures
    (the terminal keep-halving rung); others are consumed once."""

    name: str
    apply: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]
    repeatable: bool = False


class Ladder:
    """Ordered degradation rungs with a cursor: each failure advances to
    the first applicable rung at or after the cursor."""

    def __init__(self, steps: List[Step]):
        self.steps = list(steps)
        self._cursor = 0

    def advance(self, knobs: Dict[str, Any]
                ) -> Optional[Tuple[Step, Dict[str, Any]]]:
        for i in range(self._cursor, len(self.steps)):
            step = self.steps[i]
            if _rung_refused(step.name):
                # the quality gate: a recall-trading rung is
                # refused for this walk — cursor untouched, so the rung
                # comes back once the tenant's floor breach clears
                continue
            new = step.apply(dict(knobs))
            if new is not None:
                self._cursor = i if step.repeatable else i + 1
                return step, new
        return None


class DegradationExhausted(RuntimeError):
    """Every rung was walked and the call still hit RESOURCE_EXHAUSTED.
    ``__cause__`` is the final OOM; ``path`` the rung names taken."""

    def __init__(self, site: str, path: List[str], last: BaseException):
        super().__init__(
            f"degradation ladder exhausted at {site!r} "
            f"(path: {' -> '.join(path) or 'none applicable'}): {last!r}")
        self.site = site
        self.path = path
        self.last = last


def _count(name: str, labels: Dict[str, str]) -> None:
    _spans.inc(name, **labels)


def _release_cached_blocks() -> None:
    """Give the caching allocator's cached blocks back to the card after
    a real OOM (module doc). torch is in ``sys.modules`` whenever a torch
    OOM was raised."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def note_step(site: str, frm: str, to: str, reason: str) -> None:
    """Record one degradation move into
    ``degrade.steps{site=,from=,to=,reason=}`` outside the reactive
    ladder: a guard's pre-emptive tier decline (``*_mem_ok`` and
    friends) or a caller-managed shrink (the chunked build halving an
    OOMing chunk) — one observable degradation policy either way."""
    _count("degrade.steps",
           {"site": site, "from": frm, "to": to, "reason": reason})
    _note_recent(site, frm, to, reason)


def run_with_degradation(call: Callable[[Dict[str, Any]], Any],
                         knobs: Dict[str, Any],
                         ladder: Ladder,
                         site: str,
                         deadline: Optional[Deadline] = None) -> Any:
    """Run ``call(knobs)``; on RESOURCE_EXHAUSTED advance ``ladder`` one
    rung and retry with the degraded knobs. Non-OOM exceptions propagate
    unchanged. Raises :class:`DegradationExhausted` when no rung is
    left.

    ``deadline`` (the request's shared :class:`Deadline`) is checked
    before every re-attempt: a ladder walk cannot stack retries past the
    request's SLO — once the budget is gone the walk aborts with
    :class:`DeadlineExceeded` (counted ``degrade.deadline_abort{site=}``)
    instead of burning chip time on an answer nobody is waiting for."""
    state = "native"
    path: List[str] = []
    release = False
    while True:
        if release:
            _release_cached_blocks()
            release = False
        try:
            out = call(knobs)
        except Exception as e:
            if not is_resource_exhausted(e):
                raise
            # a real allocator OOM, not the fault harness's injected one
            release = getattr(e, "transient", None) is None
            if deadline is not None and deadline.expired:
                _count("degrade.deadline_abort", {"site": site})
                raise DeadlineExceeded(site, deadline) from e
            advanced = ladder.advance(knobs)
            if advanced is None:
                _count("degrade.exhausted", {"site": site})
                raise DegradationExhausted(site, path, e) from e
            step, knobs = advanced
            _count("degrade.steps", {"site": site, "from": state,
                                     "to": step.name,
                                     "reason": "resource_exhausted"})
            _note_recent(site, state, step.name, "resource_exhausted")
            _log.warn("%s: RESOURCE_EXHAUSTED — degrading %s -> %s",
                      site, state, step.name)
            state = step.name
            path.append(step.name)
            continue
        if path:
            _count("degrade.recovered", {"site": site})
        return out


def batched_search_call(search_fn, index, queries, k: int,
                        filter_bitset,
                        deadline: Optional[Deadline] = None,
                        site: str = "batched_search"
                        ) -> Callable[[Dict[str, Any]], Any]:
    """Build the ladder ``call(knobs)`` for a search entry point (the
    shared body of ``ivf_pq.search_resilient`` /
    ``ivf_flat.search_resilient``): honors the knobs the standard
    ladder mutates — ``params``, ``dataset``, and ``max_batch``
    (splitting the query batch and concatenating per-axis results when
    a halve-batch rung has fired; each query's math is independent, so
    splitting is exact).

    ``deadline`` (the request's shared :class:`Deadline`) gates each
    sub-batch of a split walk: once the budget is gone the remaining
    sub-batches are abandoned with :class:`DeadlineExceeded` — a
    half-delivered answer after the SLO helps nobody, and the serving
    layer turns the typed error into a counted shed instead of a hung
    request."""
    import torch

    B = queries.shape[0]

    def call(knobs: Dict[str, Any]):
        p = knobs["params"]
        ds = knobs.get("dataset")
        mb = knobs.get("max_batch")
        if not mb or mb >= B:
            if deadline is not None and deadline.expired:
                _count("degrade.deadline_abort", {"site": site})
                raise DeadlineExceeded(site, deadline)
            return search_fn(index, queries, k, p, filter_bitset, ds)
        outs = []
        for a in range(0, B, mb):
            if deadline is not None and deadline.expired:
                _count("degrade.deadline_abort", {"site": site})
                raise DeadlineExceeded(site, deadline)
            outs.append(search_fn(index, queries[a:a + mb], k, p,
                                  filter_bitset, ds))
        return (torch.cat([o[0] for o in outs], 0),
                torch.cat([o[1] for o in outs], 0))

    return call


# ---------------------------------------------------------------------------
# the standard search ladder (halve query batch → bf16 LUT → fp8 LUT →
# demote raw → decline fused tier → host gather; then keep halving)
# ---------------------------------------------------------------------------

def _halve_batch(total: int):
    def apply(knobs):
        cur = knobs.get("max_batch") or total
        if cur <= 1:
            return None
        knobs["max_batch"] = max(1, cur // 2)
        return knobs
    return apply


def _bf16_lut(knobs):
    params = knobs["params"]
    # "auto" is accepted only for callers driving the ladder directly:
    # the public entry (ivf_pq.search_resilient) resolves "auto" to its
    # concrete dispatch dtype BEFORE the ladder, so an fp8-resolved
    # config skips this rung instead of being enlarged back to bf16
    if getattr(params, "lut_dtype", None) not in ("float32", "auto"):
        return None
    knobs["params"] = dataclasses.replace(params, lut_dtype="bfloat16")
    return knobs


def _fp8_lut(knobs):
    """One more halving of the LUT/codebook operand footprint past the
    bf16 rung (the reference's fp8 trade, ivf_pq_fp_8bit.cuh — also the
    dispatch default for oversampled scans on the card, see
    ``ivf_pq.resolve_lut_dtype``): under memory pressure the ladder pins
    it regardless of shape, trading recall margin for staying up."""
    params = knobs["params"]
    if getattr(params, "lut_dtype", None) in ("float8_e4m3", None):
        return None
    knobs["params"] = dataclasses.replace(params, lut_dtype="float8_e4m3")
    return knobs


def _decline_fused(knobs):
    """Route off the fused/grouped tiers: pallas → approx select first,
    then the grouped scan → the tile-bounded per_query path (whose
    working set _fit_query_tile caps at ~1 GB)."""
    params = knobs["params"]
    if getattr(params, "scan_select", None) == "pallas":
        knobs["params"] = dataclasses.replace(params, scan_select="approx")
        return knobs
    if getattr(params, "scan_mode", None) != "per_query":
        knobs["params"] = dataclasses.replace(params, scan_mode="per_query")
        return knobs
    return None


def _resident(dataset) -> bool:
    """A re-rank base the device tiers index in place: a tensor. On the
    card that is a CUDA tensor; on a CPU run the CPU stands in for the
    card, as the JAX package's CPU backend does for its device arrays, so
    a walk on the CPU takes the JAX package's rungs."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(dataset, torch.Tensor)


def _demote_raw(knobs):
    """Demote the re-rank base to HOST memory — the memory tier: the
    dataset's device residency is reclaimed while the refined path keeps
    serving through the tiered candidate-row prefetch (neighbors.tiered —
    the host fetch overlapped under the scan), through
    ``serve.placement.to_host``. Results stay EXACT (the re-rank still
    runs against the same f32 rows; only where they are fetched from
    changes), so this rung is a capacity move, deliberately NOT in
    :data:`QUALITY_RUNGS` — the recall-floor quality gate never refuses
    it."""
    params = knobs["params"]
    dataset = knobs.get("dataset")
    if getattr(params, "refine", "none") == "none" or dataset is None:
        return None
    if not _resident(dataset):
        return None  # already host-side
    from raft_tpu_torch.serve import placement

    knobs["dataset"] = placement.to_host(dataset)
    return knobs


def _host_gather(knobs):
    """The last-resort transfer rung: re-rank base on the host AND the
    prefetch pipeline declined — refine_transfer pinned ``"serial"``
    routes through refine_gathered's one-block-at-a-time gather, the
    smallest possible refine footprint (one ``[m_b, C, d]`` block, no
    parked prefetch buffers). Applies after :func:`_demote_raw` (or to
    an already-host base still running the tiered pipeline)."""
    params = knobs["params"]
    dataset = knobs.get("dataset")
    if getattr(params, "refine", "none") == "none" or dataset is None:
        return None
    changed = False
    if _resident(dataset):
        from raft_tpu_torch.serve import placement

        knobs["dataset"] = placement.to_host(dataset)
        changed = True
    if getattr(params, "refine_transfer", "serial") != "serial":
        knobs["params"] = dataclasses.replace(params,
                                              refine_transfer="serial")
        changed = True
    return knobs if changed else None


def standard_search_ladder(batch: int, has_lut: bool = False) -> Ladder:
    """The declared search ladder. ``batch`` is the incoming query
    count; ``has_lut`` adds the bf16-LUT and fp8-LUT rungs (IVF-PQ only
    — IVF-Flat has no LUT to quantize): two successive halvings of the
    LUT/codebook operand footprint between "halve batch" and "decline
    fused", each a documented precision trade rather than a tier
    change. ``demote_raw`` sits before the result-changing
    rungs: it moves the refined search's re-rank base to host memory —
    HBM reclaimed, answers still exact via the tiered prefetch — so
    capacity is bought from the memory hierarchy before any quality is
    spent. The terminal rung keeps halving the batch down to 1 so a
    pathological shape still completes, just slowly."""
    steps = [Step("halve_batch", _halve_batch(batch))]
    if has_lut:
        steps.append(Step("bf16_lut", _bf16_lut))
        steps.append(Step("fp8_lut", _fp8_lut))
    # the memory tier: reclaim the re-rank base's device memory before
    # touching result-changing rungs — demotion keeps answers exact
    # (tiered prefetch), so it outranks declining the fused tier
    steps.append(Step("demote_raw", _demote_raw))
    # repeatable: declining the fused tier is two moves (pallas select →
    # approx, then the grouped scan → the tile-bounded per_query path)
    steps.append(Step("decline_fused", _decline_fused, repeatable=True))
    steps.append(Step("host_gather", _host_gather))
    steps.append(Step("halve_batch", _halve_batch(batch), repeatable=True))
    return Ladder(steps)
