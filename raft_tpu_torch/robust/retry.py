"""Unified retry/timeout/backoff policy — exponential backoff + jitter
with deadline budgets and per-site counters (counterpart of
``raft_tpu.robust.retry``).

Host reads (the tiered path's candidate-row gather, ``serve.row_read``),
host↔device transfers and anything else that talks to a flaky transport
route through :func:`retry_call`. The policy is explicit about the two
failure families:

- **transient** faults (tunnel hiccups, ``UNAVAILABLE``/
  ``DEADLINE_EXCEEDED`` RPC errors, ``OSError`` reads, injected
  :class:`~raft_tpu_torch.robust.faults.FaultInjected`) are retried with
  exponential backoff + full-range jitter;
- **RESOURCE_EXHAUSTED** is *never* retried here — blind re-execution
  of an OOM at the same shape is the anti-pattern the degradation
  ladder (:mod:`raft_tpu_torch.robust.degrade`) exists to replace. A
  ``torch.OutOfMemoryError`` (the caching allocator's; on the card
  ``torch.cuda.OutOfMemoryError`` is the same class) is one by type.
- **CUDA runtime errors** are never retried either: most are sticky —
  once the context is dead, every later call fails too — and one of them
  ("the launch timed out and was terminated") would otherwise match the
  ``"timed out"`` transient marker and loop on a dead context. A CUDA
  error is a ``torch.AcceleratorError`` where the installed torch has
  one, any ``RuntimeError`` whose text starts ``CUDA error``, or the
  port's own launch failure (``"<kernel>: CUDA error <rc> at launch"``,
  ``ops.kernels``).

Counters (always on, ``obs.spans``): ``retry.attempts{site=}`` per
attempt, ``retry.recovered{site=}`` when a later attempt succeeds,
``retry.exhausted{site=}`` when the policy gives up. With event recording
on, each RE-attempt lands in the span-event ring as a zero-duration
``retry.attempt`` marker carrying the current request's labels.

Its imports beyond the standard library are ``obs.spans`` and
``obs.trace``; torch's exception classes are looked up in ``sys.modules``
(an exception of a torch class exists only once torch is imported).
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time
from typing import Any, Callable, Dict, Optional

from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs import trace as _trace

__all__ = ["RetryPolicy", "RetryExhausted", "retry_call", "retrying",
           "default_retryable", "is_resource_exhausted", "is_cuda_error",
           "Deadline", "DeadlineExceeded",
           "DEFAULT_POLICY", "IO_POLICY"]

# Substrings that mark an exception message as a transient transport /
# runtime failure worth retrying (grpc/XLA status names + socket-layer
# phrasings of remote transports).
TRANSIENT_MARKERS = (
    "DEADLINE_EXCEEDED", "UNAVAILABLE", "CANCELLED", "ABORTED",
    "Connection reset", "Connection refused", "Broken pipe",
    "Socket closed", "timed out", "temporarily unavailable",
)

# Case-sensitive status markers + one lowercase allocator phrasing.
# The CANONICAL OOM classifier lives here (degrade.is_resource_exhausted
# delegates to it) so retry's never-retry-an-OOM rule and degrade's
# walk-the-ladder trigger can never drift apart.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted")


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for allocator/OOM failures: a ``torch.OutOfMemoryError`` (by
    type), ``RESOURCE_EXHAUSTED`` status messages, allocator "out of
    memory" messages, and the fault harness's injected OOM (whose message
    carries the same status)."""
    torch = sys.modules.get("torch")
    if torch is not None:
        ooms = tuple(c for c in (getattr(torch, "OutOfMemoryError", None),
                                 getattr(torch.cuda, "OutOfMemoryError",
                                         None)) if c is not None)
        if ooms and isinstance(exc, ooms):
            return True
    msg = str(exc)
    return (any(m in msg for m in _OOM_MARKERS)
            or "out of memory" in msg.lower())


def is_cuda_error(exc: BaseException) -> bool:
    """True for a CUDA runtime error (module doc): never retryable."""
    torch = sys.modules.get("torch")
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(exc, acc):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    return msg.startswith("CUDA error") or (
        ": CUDA error " in msg and msg.endswith(" at launch"))


def default_retryable(exc: BaseException) -> bool:
    """The default transient predicate (see module doc): explicit
    ``transient`` attribute > OOM and CUDA-error exclusion > OS/timeout
    errors > message markers."""
    transient = getattr(exc, "transient", None)
    if transient is not None:
        return bool(transient)
    if is_resource_exhausted(exc) or is_cuda_error(exc):
        return False
    if isinstance(exc, (OSError, TimeoutError)):
        return True
    msg = str(exc)
    return any(m in msg for m in TRANSIENT_MARKERS)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter with bounded attempts and an
    optional total deadline.

    Delay before attempt ``i+1`` is ``min(max_delay_s, base_delay_s ·
    multiplier^(i-1))`` scaled by a uniform draw from
    ``[1-jitter, 1+jitter]`` (decorrelates fleet-wide retry storms),
    then clamped to whatever remains of ``deadline_s`` (measured from
    the first attempt's start). A retry that cannot fit any positive
    delay inside the deadline is not attempted."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.25           # ± fraction of the computed delay
    deadline_s: Optional[float] = None
    retryable: Callable[[BaseException], bool] = default_retryable

    def describe(self) -> str:
        """One-line policy state for notes and logs."""
        dl = f" deadline={self.deadline_s:.0f}s" if self.deadline_s else ""
        return (f"backoff {self.base_delay_s:g}s×{self.multiplier:g} "
                f"(max {self.max_delay_s:g}s, jitter ±{self.jitter:.0%}, "
                f"attempts {self.max_attempts}{dl})")


DEFAULT_POLICY = RetryPolicy()
# Host↔device transfers / memmap reads: fail fast but absorb one-off
# hiccups.
IO_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.25,
                        max_delay_s=5.0, jitter=0.25)


class Deadline:
    """One shared wall-clock budget for one request.

    ``RetryPolicy.deadline_s`` is a *per-site* budget measured from each
    site's first attempt — two nested retry sites under one request can
    therefore stack to ``2 × deadline_s`` of wall time, past any SLO the
    caller promised. A :class:`Deadline` is the request-scoped
    alternative: constructed once where the request enters the system
    (``serve``'s enqueue path) and threaded through every retry / ladder
    / dispatch site, so queue wait, batching, the search itself, and all
    nested retries draw down ONE budget.

    ``Deadline(None)`` never expires (the offline default — every
    ``deadline=`` parameter treats ``None`` the same way).
    Stdlib-only, monotonic-clock based; ``clock`` is injectable for
    tests."""

    __slots__ = ("budget_s", "_t0", "_clock")

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = None if budget_s is None else float(budget_s)
        self._clock = clock
        self._t0 = clock()

    def elapsed(self) -> float:
        """Seconds since construction."""
        return self._clock() - self._t0

    def remaining(self) -> float:
        """Seconds left in the budget (``inf`` for an unbounded
        deadline; negative once expired — callers comparing a backoff
        delay against it get the right answer either way)."""
        if self.budget_s is None:
            return float("inf")
        return self.budget_s - self.elapsed()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def describe(self) -> str:
        """One-line state for logs/records."""
        if self.budget_s is None:
            return "deadline unbounded"
        return (f"deadline {self.budget_s:g}s "
                f"({max(0.0, self.remaining()):.3f}s left)")

    def __repr__(self) -> str:  # debuggability in shed errors/logs
        return f"<Deadline {self.describe()}>"


class DeadlineExceeded(RuntimeError):
    """A request's shared :class:`Deadline` ran out. ``transient=False``
    pins the retry classification: the message must never be mistaken
    for a retryable grpc ``DEADLINE_EXCEEDED`` status (blind-retrying an
    expired request is exactly the stacking this type exists to end)."""

    transient = False

    def __init__(self, site: str, deadline: Optional[Deadline] = None):
        state = f" ({deadline.describe()})" if deadline is not None else ""
        super().__init__(f"deadline exhausted at {site!r}{state}")
        self.site = site
        self.deadline = deadline


class RetryExhausted(RuntimeError):
    """The policy gave up: attempts or deadline ran out. ``__cause__``
    is the last attempt's exception; ``attempts`` the count made."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"retry exhausted at {site!r} after {attempts} attempt(s): "
            f"{last!r}")
        self.site = site
        self.attempts = attempts
        self.last = last


def _count(name: str, site: str) -> None:
    _spans.inc(name, site=site)


def _attempt_event(site: str, attempt: int) -> None:
    """Timeline marker for a RE-attempt (never the first try — a clean
    call leaves no retry trace), stamped with the current request
    context, when event recording is on."""
    if not _spans.events_enabled():
        return
    args: Dict[str, Any] = {"site": site, "attempt": attempt}
    ctx = _trace.current_request()
    if ctx is not None:
        args.update(ctx.event_labels())
    _trace.get_buffer().record_span("retry.attempt", time.time(), 0.0,
                                    args=args)


def retry_call(fn: Callable[..., Any], *args,
               site: str = "unnamed",
               policy: RetryPolicy = DEFAULT_POLICY,
               deadline: Optional[Deadline] = None,
               stats: Optional[Dict[str, Any]] = None,
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               **kwargs) -> Any:
    """Call ``fn(*args, **kwargs)`` under ``policy``.

    ``stats`` (optional dict) is filled in place — ``attempts``,
    ``slept_s``, ``errors`` (reprs), ``outcome``
    (``"ok"``/``"recovered"``/``"exhausted"``/``"fatal"``/
    ``"deadline"``) — so callers can stamp the retry history into their
    own records. Raises
    :class:`RetryExhausted` when the policy gives up on a retryable
    error; a non-retryable error propagates unchanged
    (``outcome="fatal"``).

    ``deadline`` (a request-scoped :class:`Deadline`) caps the whole
    call alongside the policy's per-site ``deadline_s``: an
    already-expired deadline refuses even the first attempt
    (:class:`DeadlineExceeded`), and a backoff sleep that would outlive
    the remaining budget gives up as ``exhausted`` instead of sleeping
    past the request's SLO. Nested retry sites handed the same object
    share one budget — they can no longer stack per-site deadlines."""
    st: Dict[str, Any] = stats if stats is not None else {}
    st.update(attempts=0, slept_s=0.0, errors=[], outcome=None,
              policy=policy.describe())
    rng = rng or random
    t0 = time.monotonic()
    if deadline is not None and deadline.expired:
        # the request's budget is already gone (burned in a queue, by a
        # sibling site, ...) — starting work that cannot be delivered
        # in time only deepens the overload
        st["outcome"] = "deadline"
        _count("retry.exhausted", site)
        raise DeadlineExceeded(site, deadline)
    while True:
        st["attempts"] += 1
        _count("retry.attempts", site)
        if st["attempts"] > 1:
            _attempt_event(site, st["attempts"])
        try:
            out = fn(*args, **kwargs)
        except BaseException as e:  # noqa: B036 — classified below
            st["errors"].append(repr(e))
            if not policy.retryable(e) or not isinstance(e, Exception):
                st["outcome"] = "fatal"
                raise
            if st["attempts"] >= policy.max_attempts:
                st["outcome"] = "exhausted"
                _count("retry.exhausted", site)
                raise RetryExhausted(site, st["attempts"], e) from e
            delay = min(policy.max_delay_s,
                        policy.base_delay_s
                        * policy.multiplier ** (st["attempts"] - 1))
            if policy.jitter:
                delay *= 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
            delay = max(0.0, delay)
            remaining = float("inf")
            if policy.deadline_s is not None:
                remaining = policy.deadline_s - (time.monotonic() - t0)
            if deadline is not None:
                # the SHARED budget: whatever other sites already spent
                # is gone from this site's backoff headroom too
                remaining = min(remaining, deadline.remaining())
            if remaining <= delay:
                _count("retry.exhausted", site)
                if deadline is not None and deadline.remaining() <= delay:
                    # the REQUEST's budget is what ran out (not merely
                    # this site's policy): surface the deadline type so
                    # the serving layer counts an SLO shed, not a
                    # tenant error
                    st["outcome"] = "deadline"
                    raise DeadlineExceeded(site, deadline) from e
                st["outcome"] = "exhausted"
                raise RetryExhausted(site, st["attempts"], e) from e
            if delay:
                sleep(delay)
                st["slept_s"] += delay
            continue
        if st["attempts"] > 1:
            st["outcome"] = "recovered"
            _count("retry.recovered", site)
        else:
            st["outcome"] = "ok"
        return out


def retrying(site: str, policy: RetryPolicy = DEFAULT_POLICY):
    """Decorator form of :func:`retry_call`."""
    def deco(fn):
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, site=site, policy=policy,
                              **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco
