"""raft_tpu_torch.serve — resilient online serving (counterpart of
``raft_tpu.serve``; the same modules, classes, counters, labels, spans,
events and payloads).

The request-shaped half of the system: it takes single-query traffic,
coalesces it into batches for the card, holds each request to a deadline,
sheds with a typed reason, and accounts per tenant.

- :mod:`raft_tpu_torch.serve.server`   — micro-batching front end:
  shape-bucketed coalescing, warmed buckets, bounded queue with typed load
  shedding;
- :mod:`raft_tpu_torch.serve.registry` — multi-tenant index registry: N
  resident indexes under one card's memory budget, demotion before LRU
  eviction under pressure, per-tenant health states;
- :mod:`raft_tpu_torch.serve.dispatch` — SLO-aware dispatch: one
  :class:`~raft_tpu_torch.robust.retry.Deadline` per request drawn down by
  queue wait + batching + search + retries + the degrade ladder;
- :mod:`raft_tpu_torch.serve.loadgen`  — open-loop (Poisson) load
  generator recording latency-vs-throughput curves;
- :mod:`raft_tpu_torch.serve.errors`   — the typed refusal surface
  (``ShedError{reason=}``, ``TenantUnknown``, ``AdmissionError``);
- :mod:`raft_tpu_torch.serve.placement` — memory-tier placement (scan
  structures on the card, raw re-rank vectors on the card or the host);
- :mod:`raft_tpu_torch.serve.slo`      — SLO guardrails: burn rates and
  per-tenant recall floors closing the loop from the shadow verifier's
  confidence intervals to health state and the ladder's quality gate;
- :mod:`raft_tpu_torch.serve.router`   — fleet router: tenant placement
  across pods, the one request Deadline across the pod hop, straggler
  steering and typed failover.

Counters: ``serve.requests``, ``serve.shed{reason=}``,
``serve.batch_fill``, ``serve.latency_s``, ``serve.deadline_missed``,
``serve.registry.{admit,evict,demote,promote}``,
``serve.prefetch.{hit,stall}``, ``serve.router.*``.
"""

from raft_tpu_torch.serve.dispatch import dispatch_batch  # noqa: F401
from raft_tpu_torch.serve.errors import (  # noqa: F401
    AdmissionError,
    Deadline,
    DeadlineExceeded,
    ServeError,
    ShedError,
    TenantUnknown,
)
from raft_tpu_torch.serve.loadgen import record, run_step, sweep  # noqa: F401
from raft_tpu_torch.serve.placement import Placement  # noqa: F401
from raft_tpu_torch.serve.router import (  # noqa: F401
    FleetRouter,
    Pod,
    RouterPolicy,
    clear_router,
    get_router,
    set_router,
)
from raft_tpu_torch.serve.registry import (  # noqa: F401
    IndexRegistry,
    Tenant,
    index_bytes_by_tier,
    index_device_bytes,
)
from raft_tpu_torch.serve.server import (  # noqa: F401
    MicroBatchServer,
    ServerConfig,
    bucket_for,
    bucket_sizes,
)
from raft_tpu_torch.serve.slo import (  # noqa: F401
    SLOMonitor,
    SLOPolicy,
    get_monitor,
    set_monitor,
)
