"""SLO-aware dispatch — one deadline budget from queue to result
(counterpart of ``raft_tpu.serve.dispatch``; the same entry, retry policy,
counters and span).

The server hands a coalesced micro-batch to :func:`dispatch_batch`, which
runs it through the tenant's **resilient** search entry — the degrade
ladder is the overload path (halve batch → bf16/fp8 LUT → demote raw →
decline fused → host gather) — under the request group's shared
:class:`~raft_tpu_torch.robust.retry.Deadline`:

- an expired deadline is refused BEFORE any device work
  (:class:`~raft_tpu_torch.robust.retry.DeadlineExceeded` — the server
  turns it into a counted shed);
- transient faults retry via :func:`raft_tpu_torch.robust.retry.retry_call`
  drawing down the SAME budget;
- a ladder walk that fires marks the tenant ``degraded`` (the registry's
  health state).

The batch runs on its index's device: the entry is called with
``device=index.device``, and every kernel wrapper on the path launches its
kernel there or raises. The dispatch then waits for the batch on the
current CUDA stream — an event recorded after the search and synchronized,
not a device-wide ``torch.cuda.synchronize()``, which would also wait for
other threads' work (the tiered reader's side stream, another server's
batch) — so the latency the server records is the delivered result's, and
the cost ledger's device time is the dispatch's wall time including that
wait.

Fault point ``serve.dispatch`` lets the chaos checks OOM, stall, or kill
the dispatch itself.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Tuple

import torch

from raft_tpu_torch.obs import cost as _cost
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs import trace as _trace
from raft_tpu_torch.robust import degrade as _degrade
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.robust import retry as _retry
from raft_tpu_torch.robust.retry import Deadline, DeadlineExceeded
from raft_tpu_torch.serve import slo as _slo
from raft_tpu_torch.serve.errors import ShedError, TenantUnknown
from raft_tpu_torch.serve.registry import Tenant

__all__ = ["dispatch_batch", "resilient_entry", "DISPATCH_RETRY_POLICY"]

# Transient-fault absorption on the dispatch path: short and fast —
# serving latency budgets are milliseconds, so backoff starts at 10 ms and
# the shared Deadline (not the per-site cap) is the real ceiling.
DISPATCH_RETRY_POLICY = _retry.RetryPolicy(
    max_attempts=3, base_delay_s=0.01, max_delay_s=0.25, jitter=0.25)


def resilient_entry(index: Any):
    """Resolve the degrade-ladder search entry for an index object by type
    (IvfPqIndex → ``ivf_pq.search_resilient``, IvfFlatIndex →
    ``ivf_flat.search_resilient``). Imports lazily so a registry of
    flat-only tenants never pays the PQ module import."""
    kind = type(index).__name__
    if kind == "IvfPqIndex":
        from raft_tpu_torch.neighbors import ivf_pq

        return ivf_pq.search_resilient
    if kind == "IvfFlatIndex":
        from raft_tpu_torch.neighbors import ivf_flat

        return ivf_flat.search_resilient
    raise TypeError(
        f"no resilient search entry for index type {kind!r} — the "
        "serving layer dispatches IvfPqIndex / IvfFlatIndex tenants")


def _wait_for(*tensors: Any) -> None:
    """Wait for the work that produced ``tensors`` on the current CUDA
    stream (an event recorded now, then synchronized). CPU tensors are
    ready when they are returned."""
    cuda = [t for t in tensors
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
    if cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(cuda[0].device))
        ev.synchronize()


def dispatch_batch(tenant: Tenant, queries, k: int,
                   deadline: Optional[Deadline] = None,
                   registry: Any = None) -> Tuple[Any, Any]:
    """Run one micro-batch for ``tenant`` under the shared ``deadline``.

    ``queries`` is a ``[bucket, dim]`` f32 tensor on the tenant's index's
    device (the server pads and copies it there). Returns ``(distances,
    ids)`` tensors on that device, finished (the server's latency
    histogram must measure delivered results, not launches). Raises
    :class:`DeadlineExceeded` when the budget is already gone before any
    device work, :class:`ShedError` (``overload``) when even the
    fully-degraded ladder cannot complete, and propagates anything else as
    the tenant's failure — never retried on another device.

    ``registry`` (the tenant's :class:`~raft_tpu_torch.serve.registry.
    IndexRegistry`, optional) receives the degraded-health demotion
    through its lock (``note_degraded``) when the ladder moves."""
    if deadline is not None and deadline.expired:
        # refuse doomed work before it costs device time — queue wait
        # already spent this request's budget
        raise DeadlineExceeded("serve.dispatch", deadline)
    _faults.faultpoint("serve.dispatch")
    # snapshot the index ONCE: a concurrent pressure eviction sets
    # tenant.index = None at any time; holding our own reference keeps
    # the tensors alive for this batch and an already-gone index is the
    # typed refusal, not a NoneType crash
    index = tenant.index
    if index is None:
        raise TenantUnknown(tenant.name, state=tenant.state)
    search = resilient_entry(index)
    # per-thread monotonic, NOT len(recent_steps()): the recent ring
    # saturates at its capacity and also collects OTHER threads' ladder
    # moves — this dispatch's walk runs in THIS stack
    degrade_mark = _degrade.steps_seen()

    def attempt():
        # the deadline reaches BOTH layers: retry_call's backoff clamps to
        # it, and the ladder inside search_resilient draws from it. The
        # tenant's dataset rides along as the refined search's re-rank
        # base: a host-resident dataset routes the exact re-rank through
        # the tiered candidate-row prefetch, labeled per tenant
        from raft_tpu_torch.neighbors import tiered as _tiered

        with _tiered.serving_tenant(tenant.name):
            return search(index, queries, k, tenant.params,
                          dataset=tenant.dataset, deadline=deadline,
                          device=index.device)

    retry_stats: dict = {}
    # the quality gate: a tenant the SLO monitor holds recall-floor-
    # breached must not walk recall-trading rungs — the gate brackets the
    # whole retry+ladder region, thread-locally
    monitor = _slo.get_monitor()
    gate = (monitor.quality_gate_for(tenant.name)
            if monitor is not None else None)
    # cost attribution: obs off costs exactly this flag check
    costing = _spans.enabled()
    t0 = time.perf_counter() if costing else 0.0
    with _spans.span("serve.dispatch") as sp:
        try:
            with _degrade.quality_gate(gate):
                dist, ids = _retry.retry_call(
                    attempt, site="serve.dispatch",
                    policy=DISPATCH_RETRY_POLICY, deadline=deadline,
                    stats=retry_stats)
            _wait_for(dist, ids)
        except _degrade.DegradationExhausted as e:
            # the ladder walked every rung and the batch still cannot run
            # — the request group is shed, the server backs off
            raise ShedError("overload", str(e)) from e
        sp.annotate(tenant=tenant.name, batch=int(queries.shape[0]), k=k,
                    attempts=retry_stats.get("attempts", 1))
    if costing:
        ledger = _cost.get_ledger()
        if ledger is not None:
            # the batch's device-inclusive wall time (the wait above),
            # prorated across the coalesced context's live members
            ctx = _trace.current_request()
            n = (len(ctx.trace_ids) if ctx is not None and ctx.trace_ids
                 else int(queries.shape[0]))
            ledger.note_batch(time.perf_counter() - t0,
                              [tenant.name] * n)
    if _degrade.steps_seen() > degrade_mark and registry is not None:
        # the ladder moved during this dispatch: the tenant is serving,
        # but on a degraded configuration — surface it as health, through
        # the registry's lock
        registry.note_degraded(tenant.name)
    # a deadline that expired DURING the work is the server's call: the
    # results are correct (just late), so the front end delivers them and
    # counts the miss per request (serve.deadline_missed)
    return dist, ids
