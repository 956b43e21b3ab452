"""Typed serving errors — every refusal is a type, never a hang
(counterpart of ``raft_tpu.serve.errors``; the same classes, reasons and
messages).

A request that cannot be served is REJECTED with a typed, reasoned error
the client can act on — back off (:class:`ShedError`), fix the request
(:class:`TenantUnknown`), or give up
(:class:`~raft_tpu_torch.robust.retry.DeadlineExceeded`). No code path may
leave a future unresolved.

All serve errors carry ``transient = False`` so the in-process retry
policy (:mod:`raft_tpu_torch.robust.retry`) never blind-retries them — a
shed under overload retried in-process IS the overload; backoff belongs to
the *client* side of the queue.
"""

from __future__ import annotations

from typing import Optional

# the deadline type is defined with the retry policy so nested retry sites
# and the serving layer share one budget object
from raft_tpu_torch.robust.retry import Deadline, DeadlineExceeded  # noqa: F401

__all__ = ["ServeError", "ShedError", "TenantUnknown", "AdmissionError",
           "Deadline", "DeadlineExceeded", "SHED_REASONS"]

# The closed set of shed reasons — ``serve.shed{reason=}`` label values. A
# new shed path must add its reason here so the counter family stays
# enumerable.
SHED_REASONS = ("queue_full", "deadline", "overload", "draining",
                "not_running", "pod_unhealthy")


class ServeError(RuntimeError):
    """Base of all typed serving refusals (never retried in-process)."""

    transient = False


class ShedError(ServeError):
    """The server declined the request to protect the ones it already
    holds. ``reason`` is one of :data:`SHED_REASONS`; clients treat it as
    a backpressure signal (back off + retry elsewhere/later)."""

    def __init__(self, reason: str, detail: str = ""):
        assert reason in SHED_REASONS, reason
        msg = f"request shed ({reason})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.reason = reason


class TenantUnknown(ServeError):
    """No resident index under that tenant name (never admitted, evicted,
    or failed); ``state`` says which."""

    def __init__(self, name: str, state: Optional[str] = None):
        extra = f" (state={state})" if state else ""
        super().__init__(f"unknown tenant {name!r}{extra}")
        self.name = name
        self.state = state


class AdmissionError(ServeError):
    """The registry could not admit an index: the memory budget is
    exhausted and every resident tenant is pinned or hotter than the
    candidate, or the index lives on another device than the registry's.
    The caller retries after evicting explicitly or admits elsewhere."""
