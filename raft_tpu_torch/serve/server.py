"""Micro-batching front end — request-shaped traffic onto batch-shaped
kernels (counterpart of ``raft_tpu.serve.server``; the same config,
buckets, counters, events, endpoints and flight sections).

Cards amortize launches over batches; users send one query at a time.
:class:`MicroBatchServer` closes that gap with the standard production
recipe, robustness first:

- **shape-bucketed coalescing** — single-query submits land in a bounded
  queue keyed by ``(tenant, k)``; the batcher drains up to ``max_batch``
  of them within a ``linger_s`` window and pads the group on the host to
  the next power-of-two **bucket**, then moves it to the tenant index's
  device in one copy, so the serving surface is a small closed set of
  shapes.
- **warmup** — ``start()`` runs every (tenant × bucket × k) shape through
  the REAL dispatch path once, with zero queries on the index's device,
  so each shape's first-call cost (the caching allocator's growth, cub's
  temporary storage, library heuristics, a kernel library's first load)
  is paid before the first user request. The JAX package's
  ``recompile_budget(0)`` contract has no counterpart in eager PyTorch;
  its place is taken by a measured check that a warmed bucket's first
  served batch runs at its warm time (``chip_smoke.py``'s ``[serve
  warm]``). ``ServerConfig.compile_cache_dir`` configures XLA's
  persistent compilation cache in the JAX package; the port compiles its
  kernels once per checkout (``ops.build``) and has no per-shape program
  cache to persist, so the field is kept for the config's shape and a
  server given one refuses to start rather than pretend to cache.
- **bounded queue + explicit shedding** — a full queue rejects with a
  typed :class:`~raft_tpu_torch.serve.errors.ShedError` immediately
  (counted ``serve.shed{reason=queue_full}``); nothing ever blocks a
  client indefinitely and no future is left unresolved.
- **deadline propagation** — every request carries one
  :class:`~raft_tpu_torch.robust.retry.Deadline` from enqueue: queue wait,
  batching, dispatch, retries, and the degrade ladder all draw down the
  same budget (see :mod:`raft_tpu_torch.serve.dispatch`). Requests whose
  budget died in the queue are shed without touching the device.
- **overload = the degrade ladder** — a RESOURCE_EXHAUSTED under load
  walks ``standard_search_ladder``; only a fully-exhausted ladder sheds
  (``serve.shed{reason=overload}``).
- **no fallback that hides the device** — a batch runs on its tenant's
  index's device; a failed dispatch resolves its futures with the error
  and is never rerun elsewhere. Results come back as one host copy of
  each output, after the dispatch waited for them on the current stream:
  nothing of the card is handed to a client thread.

Threads: the batcher, the shadow verifier, the tiered reader (one per
tiered search) and the exposition endpoint each run on their own; every
lock is an ``obs.sanitize`` monitored lock under the JAX package's names.

Counters (always on): ``serve.requests{tenant=}``, ``serve.shed{reason=}``,
``serve.deadline_missed``, ``serve.errors{tenant=}``,
``serve.warmup{tenant=}``; while observability records:
``serve.batch_fill`` (histogram, fill fraction), ``serve.latency_s``
(histogram — the p50/p99 source), ``serve.queue_depth`` (gauge). Fault
points: ``serve.enqueue``, ``serve.dispatch``, ``serve.registry.admit``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

import torch

from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs import trace as _trace
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.robust.retry import Deadline, DeadlineExceeded
from raft_tpu_torch.serve import dispatch as _dispatch
from raft_tpu_torch.serve.errors import ServeError, ShedError, TenantUnknown
from raft_tpu_torch.serve.registry import IndexRegistry

__all__ = ["ServerConfig", "MicroBatchServer", "bucket_sizes",
           "bucket_for"]

# serve.latency_s histogram edges: request latencies from 100 µs to
# seconds — same shape as the bench's search-latency buckets so
# quantile interpolation stays fine-grained where serving lives.
_LATENCY_BUCKETS = [1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                    2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]
_FILL_BUCKETS = [0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0]


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """The bucket set: powers of two up to ``max_batch`` (rounded up) —
    every batch runs at one of ``log2(max_batch)+1`` shapes."""
    if max_batch < 1:
        raise ValueError(f"max_batch {max_batch} < 1")
    out = [1]
    while out[-1] < max_batch:
        out.append(out[-1] * 2)
    return tuple(out)


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket ≥ ``n`` (``n`` capped to the largest bucket by
    the batcher's take size, so this never falls off the end)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving knobs (defaults sized for small tests; a card's server
    raises ``max_batch``/``queue_depth`` and tightens ``default_slo_s``).

    ``linger_s`` is the micro-batch window: the batcher waits at most
    this long past the oldest queued request for the bucket to fill —
    the latency the front end spends buying batch efficiency.
    ``default_slo_s`` seeds each request's :class:`Deadline`
    (``None`` → unbounded, the offline default). ``compile_cache_dir``
    has no counterpart in the port (module doc): leave it None."""

    max_batch: int = 32
    queue_depth: int = 256
    linger_s: float = 0.002
    default_slo_s: Optional[float] = 1.0
    compile_cache_dir: Optional[str] = None
    drain_s: float = 5.0
    # live telemetry exposition: a port arms an
    # obs.expo.ExpoServer for the server's lifetime (/metrics /healthz
    # /flightz). None = off (the offline default); 0 = ephemeral port
    # (tests/CI read it back from server.expo.port)
    expo_port: Optional[int] = None
    expo_host: str = "127.0.0.1"
    # the quality plane: ``verify_sample`` > 0 arms the
    # shadow recall verifier — that fraction of completed requests is
    # replayed exactly (host-side, off the hot path, rate-limited to
    # ``verify_rate_per_s`` per tenant) against each tenant's admitted
    # dataset, feeding quality.recall{tenant=,k=} gauges with Wilson
    # CIs and the SLO monitor's recall floors. 0.0 = off (the default:
    # verification-less serving pays nothing new).
    verify_sample: float = 0.0
    verify_rate_per_s: float = 50.0
    verify_seed: int = 0
    #: an :class:`raft_tpu_torch.serve.slo.SLOPolicy` (None → defaults) —
    #: burn-rate windows/targets and the recall-floor evidence bar
    slo: Optional[Any] = None


class _Request:
    __slots__ = ("tenant", "query", "k", "deadline", "future", "enqueued",
                 "ctx")

    def __init__(self, tenant: str, query: np.ndarray, k: int,
                 deadline: Optional[Deadline]):
        self.tenant = tenant
        self.query = query
        self.k = k
        self.deadline = deadline
        self.future: Future = Future()
        self.enqueued = time.monotonic()
        # request-scoped trace identity: minted at submit,
        # carried through queue → batcher → dispatch → retry/degrade →
        # search_resilient; stamped on every span event those stages
        # emit and retained as the latency histogram's exemplar
        self.ctx = _trace.RequestContext(tenant=tenant, deadline=deadline)


def _count(name: str, **labels: str) -> None:
    # always on, as every counter of the port
    _spans.registry().inc(name, labels=labels or None)


def _observe(name: str, value: float, buckets,
             exemplar: Optional[str] = None) -> None:
    if _spans.enabled():
        _spans.registry().histogram(name, buckets=buckets).observe(
            value, exemplar=exemplar)


class MicroBatchServer:
    """The async front end: ``submit()`` returns a
    :class:`concurrent.futures.Future` immediately; a background
    batcher coalesces, buckets, and dispatches. ``search()`` is the
    blocking convenience wrapper. Use as a context manager or call
    :meth:`start`/:meth:`stop`."""

    def __init__(self, registry: IndexRegistry,
                 config: Optional[ServerConfig] = None):
        self.registry = registry
        self.config = config or ServerConfig()
        if self.config.compile_cache_dir:
            raise ValueError(
                "ServerConfig.compile_cache_dir configures XLA's persistent "
                "compilation cache in the JAX package; the port has no "
                "per-shape program cache (its kernels build once per "
                "checkout): leave it None")
        # the registry's device: a "cuda" registry was resolved (and
        # raised without a card) at construction; resolving again keeps a
        # duck-typed registry to the same rule
        self.device = resolve_device(getattr(registry, "device", "cuda"))
        self.buckets = bucket_sizes(self.config.max_batch)
        self._queues: Dict[Tuple[str, int], Deque[_Request]] = {}
        self._total = 0
        self._cond = _sanitize.monitored_condition("serve.server")
        self._running = False
        self._thread: Optional[threading.Thread] = None
        #: the live exposition endpoint (obs.expo.ExpoServer) while
        #: running with ``config.expo_port`` set, else None
        self.expo = None
        #: the shadow recall verifier (obs.quality.RecallVerifier)
        #: while running with ``config.verify_sample`` > 0, else None
        self.verifier = None
        #: the SLO monitor (serve.slo.SLOMonitor) while running
        self.slo = None
        #: the cost ledger (obs.cost.CostLedger) while running
        self.ledger = None
        #: the capacity model (obs.capacity.CapacityModel) while running
        self.capacity = None

    # -- lifecycle ----------------------------------------------------------
    def start(self, warmup: bool = True) -> "MicroBatchServer":
        """Arm the server: warm every resident tenant's bucket set
        through the real dispatch path, then start the batcher. After
        ``start(warmup=True)`` returns, every served shape has paid its
        first-call cost."""
        with self._cond:
            if self._running:
                return self
        if warmup:
            for tenant in self.registry.resident():
                try:
                    self.warm_tenant(tenant.name)
                except Exception as e:
                    # one tenant that cannot even warm must not keep
                    # the whole server (and every healthy tenant) down:
                    # mark it failed — its residency is released, its
                    # submits become typed TenantUnknown — and serve on
                    _log.warn("serve: warmup failed for %r: %r — "
                              "marking failed", tenant.name, e)
                    self.registry.mark(tenant.name, "failed")
        with self._cond:
            self._running = True
        self._thread = threading.Thread(target=self._batch_loop,
                                        name="raft-tpu-serve-batcher",
                                        daemon=True)
        self._thread.start()
        # live exposition: scrapable /metrics + /healthz +
        # /flightz for the server's lifetime; the registry's tenant
        # health also rides every flight dump as "serve_registry"
        from raft_tpu_torch.obs import flight as _flight

        _flight.set_section("serve_registry", self.registry.describe)
        # the quality plane: shadow verifier (when sampling
        # is on) + SLO monitor (always — burn rates need no verifier).
        # The monitor registers process-globally so dispatch can fetch
        # the quality gate; verdicts drive its floor evaluation.
        from raft_tpu_torch.serve import slo as _slo

        if self.config.verify_sample > 0.0:
            from raft_tpu_torch.obs import quality as _quality

            self.verifier = _quality.RecallVerifier(
                self.registry,
                _quality.VerifierConfig(
                    sample_fraction=self.config.verify_sample,
                    rate_limit_per_s=self.config.verify_rate_per_s,
                    seed=self.config.verify_seed)).start()
            _flight.set_section("quality", self.verifier.state)
        self.slo = _slo.SLOMonitor(self.registry, verifier=self.verifier,
                                   policy=self.config.slo)
        if self.verifier is not None:
            self.verifier.on_verdict = self.slo.evaluate
        _slo.set_monitor(self.slo)
        # the cost & capacity plane: the ledger attributes
        # per-tenant resources (dispatch reaches it through the
        # process-global install, same pattern as the SLO monitor); the
        # capacity model forecasts saturation for admission/placement.
        # Both live regardless of the obs flag — attribution itself is
        # gated at the dispatch tap, so obs-off serving stays at one
        # flag check per batch.
        from raft_tpu_torch.obs import capacity as _capacity
        from raft_tpu_torch.obs import cost as _cost

        self.ledger = _cost.CostLedger()
        _cost.set_ledger(self.ledger)
        self.capacity = _capacity.CapacityModel(
            resident_bytes=self.registry.resident_bytes,
            usable_bytes=lambda: self.registry.usable_bytes,
            ledger=self.ledger)
        _capacity.set_model(self.capacity)
        _flight.set_section("cost", self._costz_payload)
        if _spans.enabled():
            # re-mirror the admission budget into hbm.bytes_limit at
            # START (the registry's __init__ mirror only fires when obs
            # was already enabled at construction)
            from raft_tpu_torch.obs import hbm as _hbm

            _hbm.note_budget(self.registry.budget_bytes,
                             _spans.registry())
        if self.config.expo_port is not None:
            from raft_tpu_torch.obs import expo as _expo

            try:
                self.expo = _expo.ExpoServer(
                    port=self.config.expo_port,
                    host=self.config.expo_host,
                    health=self._health_payload,
                    indexz=self._indexz_payload,
                    costz=self._costz_payload).start()
            except Exception:
                # a failed bind (port taken, privileged port) must not
                # leave a half-started server: the batcher thread is
                # already live and a second start() would early-return
                # on _running forever — tear back down to "stopped" so
                # the caller can fix the port and start() again
                self.stop(drain=False)
                raise
            _log.info("serve: exposition endpoint at %s", self.expo.url)
        return self

    def warm_tenant(self, name: str) -> int:
        """Warm tenant ``name``'s bucket set: run every (bucket ×
        served-k) shape — the tenant's ``serve_ks``, its whole admissible
        surface — through the REAL dispatch path with zero queries on the
        index's device (same entry, same params: each shape's first-call
        cost is paid here, not by a user), then mark the tenant
        ``serving``. Returns the number of shapes warmed; counted
        ``serve.warmup{tenant=}``."""
        # peek: warmup must not heat the tenant's LRU eviction clock
        tenant = self.registry.peek(name)
        dim = tenant.index.dim
        dev = tenant.index.device
        ks = tenant.serve_ks or (tenant.default_k,)
        for b in self.buckets:
            zeros = torch.zeros((b, dim), dtype=torch.float32, device=dev)
            for k in ks:
                _dispatch.dispatch_batch(tenant, zeros, k,
                                         deadline=None)
                _count("serve.warmup", tenant=name)
        self.registry.mark(name, "serving")
        _log.info("serve: warmed %r over buckets %s x ks %s", name,
                  list(self.buckets), list(ks))
        return len(self.buckets) * len(ks)

    def stop(self, drain: bool = True) -> None:
        """Stop the batcher. ``drain=True`` gives queued work up to
        ``config.drain_s`` to complete; whatever remains (and anything
        submitted after stop) is shed as ``draining`` — a shutdown
        leaves zero unresolved futures."""
        if drain:
            end = time.monotonic() + self.config.drain_s
            with self._cond:
                while self._total and time.monotonic() < end:
                    self._cond.wait(0.01)
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            with _sanitize.blocking_region("join"):
                self._thread.join(timeout=self.config.drain_s + 5)
            self._thread = None
        shed: List[_Request] = []
        with self._cond:
            for q in self._queues.values():
                shed.extend(q)
                q.clear()
            self._total = 0
        for r in shed:
            _count("serve.shed", reason="draining")
            self._request_event(r, outcome="shed_draining")
            r.future.set_exception(ShedError("draining"))
        if self.expo is not None:
            self.expo.stop()
            self.expo = None
        from raft_tpu_torch.obs import flight as _flight

        _flight.clear_section("serve_registry")
        if self.verifier is not None:
            self.verifier.stop()
            self.verifier = None
            _flight.clear_section("quality")
        if self.slo is not None:
            from raft_tpu_torch.serve import slo as _slo

            # clear only OUR monitor: a stop() racing a newer server's
            # start() must not strip that server's gate
            _slo.clear_monitor(self.slo)
            self.slo = None
        if self.ledger is not None:
            from raft_tpu_torch.obs import capacity as _capacity
            from raft_tpu_torch.obs import cost as _cost

            _flight.clear_section("cost")
            _cost.clear_ledger(self.ledger)  # ours only, same as slo
            _capacity.clear_model(self.capacity)
            self.ledger = None
            self.capacity = None

    # -- exposition payloads ------------------------------------------------
    def _health_payload(self) -> Dict[str, Any]:
        """/healthz body: the registry describe + the SLO section
        (burn rates, floor-breached tenants). The scrape itself drives
        an SLO evaluation, so health is current even on an idle
        verifier."""
        desc = self.registry.describe()
        if self.slo is not None:
            try:
                desc["slo"] = self.slo.healthz()
            except Exception:  # noqa: BLE001 — health must render
                pass
        return desc

    def _costz_payload(self) -> Dict[str, Any]:
        """/costz body (and the ``"cost"`` flight-dump section): the
        per-tenant attribution ledger plus the capacity forecast. The
        scrape itself advances the HBM byte-second integrals and the
        capacity rate windows (the healthz-drives-evaluation
        convention), so an idle scrape still moves the clock."""
        out: Dict[str, Any] = {}
        if self.ledger is not None:
            out["ledger"] = self.ledger.describe()
        if self.capacity is not None:
            try:
                self.capacity.tick()
                out["capacity"] = self.capacity.forecast()
            except Exception as e:  # noqa: BLE001 — scrape must render
                out["capacity"] = {"error": repr(e)}
        return out

    def _indexz_payload(self) -> Dict[str, Any]:
        """/indexz body: per-tenant index-health introspection
        (admission-time stats, computed on first demand for tenants
        admitted before the quality plane or without a dataset)."""
        from raft_tpu_torch.obs import index_stats as _istats

        from raft_tpu_torch.serve.registry import index_bytes_by_tier

        out: Dict[str, Any] = {}
        for t in self.registry.tenants():
            entry: Dict[str, Any] = {"state": t.state,
                                     "requests": t.requests}
            if t.recall_floor is not None:
                entry["recall_floor"] = t.recall_floor
            # the memory tier: where this tenant's pieces
            # live and what each tier costs — a demoted tenant shows
            # raw=host (plus demoted=true) at a glance
            if t.placement is not None:
                entry["placement"] = t.placement.describe()
                if t.demoted:
                    entry["demoted"] = True
            if t.index is not None:
                entry["bytes"] = index_bytes_by_tier(
                    t.index, t.dataset, self.registry.device)
            stats = t.index_stats
            if stats is None and t.index is not None:
                stats = _istats.describe_index(t.index, t.dataset)
                t.index_stats = stats
            if stats:
                entry["stats"] = stats
            out[t.name] = entry
        return {"tenants": out}

    def __enter__(self) -> "MicroBatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the client surface -------------------------------------------------
    def submit(self, tenant: str, query, k: Optional[int] = None,
               slo_s: Optional[float] = -1.0) -> Future:
        """Enqueue one single-query request; returns a Future resolving
        to ``(distances, ids)`` numpy vectors of length ``k``.

        The request's :class:`Deadline` starts NOW — queue wait counts
        against the SLO. ``slo_s`` overrides the config default
        (``None`` = unbounded; the ``-1.0`` sentinel means "use
        ``config.default_slo_s``"). Refusals are immediate and typed:
        :class:`ShedError` (queue full / not running),
        :class:`TenantUnknown`."""
        _faults.faultpoint("serve.enqueue")
        # peek, not get: submit-time validation must not heat the LRU
        # clock — shed/invalid floods would keep a tenant eviction-hot
        # while quieter tenants actually serving get evicted; recency
        # is touched at DISPATCH (the batcher's registry.get)
        tenant_rec = self.registry.peek(tenant)  # TenantUnknown raises
        # counted AFTER the tenant resolves: the label set must stay
        # the enumerable set of real tenants — client-supplied bogus
        # names minting unbounded labeled series would leak registry
        # memory and make every per-tenant dump table unreadable
        _count("serve.requests", tenant=tenant)
        q = np.asarray(query, dtype=np.float32)
        if q.ndim != 1:
            raise ValueError(
                f"submit() takes one query vector [dim], got {q.shape} — "
                "the front end owns batching")
        if q.shape[0] != tenant_rec.index.dim:
            raise ValueError(
                f"query dim {q.shape[0]} != tenant {tenant!r} index dim "
                f"{tenant_rec.index.dim}")
        kk = tenant_rec.default_k if k is None else int(k)
        allowed = tenant_rec.serve_ks or (tenant_rec.default_k,)
        if kk not in allowed:
            # an un-warmed k would pay its first-call cost on the
            # serving path — a head-of-line latency spike for every
            # queued request; the k surface is closed at admission
            # (registry.admit(ks=...))
            raise ValueError(
                f"k={kk} not in tenant {tenant!r}'s warmed surface "
                f"{list(allowed)} — declare it at admit(ks=...)")
        budget = self.config.default_slo_s if slo_s == -1.0 else slo_s
        req = _Request(tenant, q, kk,
                       None if budget is None else Deadline(budget))
        # the client's handle to the trace: a returned future knows its
        # request's trace id, so load generators / clients can join a
        # slow result back to its timeline (loadgen stamps these into
        # its benchdiff rows)
        req.future.trace_id = req.ctx.trace_id
        with self._cond:
            if not self._running:
                _count("serve.shed", reason="not_running")
                # same anchor-event contract as every other shed path:
                # a drill-down for this trace id must find the request
                # marked shed, not simply missing
                self._request_event(req, outcome="shed_not_running")
                raise ShedError("not_running", "server not started")
            if self._total >= self.config.queue_depth:
                # the explicit load-shed: a bounded queue full of work
                # the device hasn't absorbed means more arrivals than
                # capacity — reject NOW so the client can back off,
                # instead of queueing into certain deadline misses
                _count("serve.shed", reason="queue_full")
                self._request_event(req, outcome="shed_queue_full",
                                    depth=self._total)
                raise ShedError(
                    "queue_full",
                    f"{self._total} queued >= depth "
                    f"{self.config.queue_depth}")
            self._queues.setdefault((tenant, kk), deque()).append(req)
            self._total += 1
            if _spans.enabled():
                _spans.registry().gauge("serve.queue_depth").set(
                    self._total)
            self._cond.notify_all()
        return req.future

    def search(self, tenant: str, query, k: Optional[int] = None,
               slo_s: Optional[float] = -1.0,
               timeout_s: float = 30.0):
        """Blocking convenience wrapper: ``submit().result()``."""
        fut = self.submit(tenant, query, k, slo_s)
        with _sanitize.blocking_region("Future.result"):
            return fut.result(timeout=timeout_s)

    # -- the batcher --------------------------------------------------------
    def _batch_loop(self) -> None:
        cfg = self.config
        while True:
            with self._cond:
                while self._running and self._total == 0:
                    self._cond.wait(0.05)
                if not self._running:
                    return
                # serve the key whose HEAD request has waited longest
                key = min(
                    (k for k, q in self._queues.items() if q),
                    key=lambda k: self._queues[k][0].enqueued)
                q = self._queues[key]
                age = time.monotonic() - q[0].enqueued
                if len(q) < cfg.max_batch and age < cfg.linger_s:
                    # the micro-batch window: wait (briefly) for the
                    # bucket to fill — re-evaluate on every arrival
                    self._cond.wait(cfg.linger_s - age)
                    continue
                take = [q.popleft()
                        for _ in range(min(cfg.max_batch, len(q)))]
                self._total -= len(take)
                if _spans.enabled():
                    _spans.registry().gauge("serve.queue_depth").set(
                        self._total)
                self._cond.notify_all()
            try:
                self._run_batch(key, take)
            except BaseException as e:  # noqa: B036 — resolve futures first
                # belt-and-braces: _run_batch already routes failures to
                # futures; anything escaping (a bug, an injected
                # SIGTERM's re-raise path) must not strand the batch
                for r in take:
                    if not r.future.done():
                        r.future.set_exception(
                            e if isinstance(e, Exception)
                            else ServeError(f"batcher died: {e!r}"))
                if not isinstance(e, Exception):
                    raise

    def _request_event(self, r: _Request, outcome: str,
                       **extra: Any) -> None:
        """One ``serve.request`` timeline event spanning the request's
        whole life (enqueue → now), stamped with its trace id — the
        anchor row ``obsdump --slowest`` renders a drill-down around.
        Free when event recording is off."""
        if not _spans.events_enabled():
            return
        dur = time.monotonic() - r.enqueued
        args = {"trace_id": r.ctx.trace_id, "tenant": r.tenant,
                "k": r.k, "outcome": outcome, **extra}
        _trace.get_buffer().record_span("serve.request",
                                        time.time() - dur, dur,
                                        args=args)

    def _run_batch(self, key: Tuple[str, int], reqs: List[_Request]
                   ) -> None:
        tenant_name, k = key
        t_take = time.monotonic()  # queue wait ends here
        try:
            tenant = self.registry.get(tenant_name)  # touches LRU
            tenant.requests += len(reqs)  # accepted-request forensics
        except TenantUnknown as e:
            # evicted/failed between enqueue and dispatch: typed error,
            # never a crash into a dropped index reference
            for r in reqs:
                self._request_event(r, outcome="tenant_unknown")
                r.future.set_exception(e)
            return
        live: List[_Request] = []
        for r in reqs:
            if r.deadline is not None and r.deadline.expired:
                # budget burned in the queue — shed without device work
                _count("serve.shed", reason="deadline")
                _count("serve.deadline_missed")
                self._request_event(r, outcome="shed_deadline",
                                    queue_s=round(t_take - r.enqueued, 6))
                r.future.set_exception(
                    DeadlineExceeded("serve.queue", r.deadline))
            else:
                live.append(r)
        if not live:
            return
        bucket = bucket_for(len(live), self.buckets)
        _observe("serve.batch_fill", len(live) / bucket, _FILL_BUCKETS)
        # padded on the host, then one copy to the index's device (an
        # evicted index is dispatch's typed refusal below)
        batch = np.zeros((bucket, live[0].query.shape[0]), np.float32)
        for j, r in enumerate(live):
            batch[j] = r.query
        index = tenant.index
        queries = torch.from_numpy(batch)
        if index is not None:
            queries = queries.to(index.device)
        # the group deadline is the most patient member's: one member's
        # nearly-dead budget must not abort a batch others can still
        # use; individual misses are counted per request at completion
        deadlines = [r.deadline for r in live if r.deadline is not None]
        group = None
        if deadlines and len(deadlines) == len(live):
            group = max(deadlines, key=lambda d: d.remaining())
        # the batch's RequestContext carries EVERY member's trace id:
        # the dispatch/search/retry spans (and any ladder move) below
        # are work done for all of them at once, and a drill-down for
        # any one member must find those shared stages
        batch_ctx = _trace.RequestContext(
            tenant=tenant_name, deadline=group,
            trace_ids=[r.ctx.trace_id for r in live])
        fill = len(live) / bucket
        try:
            with _trace.use_request(batch_ctx):
                dist, ids = _dispatch.dispatch_batch(
                    tenant, queries, k, deadline=group,
                    registry=self.registry)
        except TenantUnknown as e:
            # evicted between our registry.get and the dispatch's index
            # snapshot: the same typed refusal as the lookup path —
            # routine evictions must not read as tenant errors
            for r in live:
                self._request_event(r, outcome="tenant_unknown")
                r.future.set_exception(e)
            return
        except DeadlineExceeded as e:
            for r in live:
                _count("serve.shed", reason="deadline")
                _count("serve.deadline_missed")
                self._request_event(r, outcome="shed_deadline",
                                    bucket=bucket)
                r.future.set_exception(e)
            return
        except ShedError as e:
            for r in live:
                _count("serve.shed", reason=e.reason)
                self._request_event(r, outcome=f"shed_{e.reason}",
                                    bucket=bucket)
                r.future.set_exception(e)
            return
        except Exception as e:
            # a non-shed failure is the tenant's problem, not the
            # queue's: resolve the batch with the error and keep serving
            # other tenants
            _log.warn("serve: batch failed for %r: %r", tenant_name, e)
            for r in live:
                _count("serve.errors", tenant=tenant_name)
                self._request_event(r, outcome="error", bucket=bucket)
                r.future.set_exception(e)
            return
        # one host copy of each output (the dispatch waited for them)
        d_np = dist[:len(live)].cpu().numpy()
        i_np = ids[:len(live)].cpu().numpy()
        now = time.monotonic()
        for j, r in enumerate(live):
            latency = now - r.enqueued
            # the exemplar: the latency histogram's buckets
            # retain concrete (value, trace_id) pairs, so a reported
            # p99 resolves to real requests whose timelines render in
            # obsdump --slowest
            _observe("serve.latency_s", latency, _LATENCY_BUCKETS,
                     exemplar=r.ctx.trace_id)
            missed = r.deadline is not None and r.deadline.expired
            if missed:
                # completed, but late: deliver the (correct) result and
                # count the SLO miss — the curve's p99 tells the story
                _count("serve.deadline_missed")
            self._request_event(
                r, outcome="late" if missed else "ok",
                queue_s=round(t_take - r.enqueued, 6),
                bucket=bucket, fill=round(fill, 4))
            r.future.set_result((d_np[j], i_np[j]))
            if self.verifier is not None:
                # the shadow-verifier tap: AFTER the future
                # resolves, so the client's latency never includes the
                # sample offer (an RNG draw + bounded copy when taken)
                self.verifier.maybe_sample(tenant_name, r.query, k,
                                           i_np[j], r.ctx.trace_id)
