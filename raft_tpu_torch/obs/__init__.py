"""raft_tpu_torch.obs — in-process observability (counterpart of
``raft_tpu.obs``; the same module, series, label, env and file-format
names, so dumps, traces and scrapes cross between the packages):

- :mod:`raft_tpu_torch.obs.metrics` — thread-safe counters/gauges/
  histograms with labels, ``snapshot()`` → dict, ``dump_jsonl`` sink;
- :mod:`raft_tpu_torch.obs.spans`   — ``span(name)`` stage timers (dotted
  nesting, optional device-time sync), recorded into the registry, and
  the always-on dispatch/fallback counters;
- :mod:`raft_tpu_torch.obs.hbm`     — the card's allocator readings as
  ``hbm.*`` gauges;
- :mod:`raft_tpu_torch.obs.prof`    — roofline classing against a device
  peak table and a ``torch.profiler`` start/stop bracket;
- :mod:`raft_tpu_torch.obs.trace`   — span-event ring buffer +
  Chrome-trace/Perfetto export (``obs.enable(events=True)``);
- :mod:`raft_tpu_torch.obs.flight`  — flight recorder: crash-surviving
  dumps of events + metrics + logs on signals/atexit/periodically;
- :mod:`raft_tpu_torch.obs.expo`    — live exposition: a stdlib HTTP
  endpoint serving Prometheus ``/metrics``, ``/healthz``, ``/flightz``,
  ``/indexz`` and ``/costz``;
- :mod:`raft_tpu_torch.obs.index_stats` — index-health introspection:
  list-size skew, dead lists, centroid drift, PQ quantization error;
- :mod:`raft_tpu_torch.obs.fleet`   — aggregation of several processes'
  flight dumps on one clock-aligned timeline;
- :mod:`raft_tpu_torch.obs.sanitize` — the lock-order tracker and the
  ``no_host_transfers`` scope.

- :mod:`raft_tpu_torch.obs.quality` — the shadow recall verifier (Wilson
  intervals over exact host replays of sampled requests);
- :mod:`raft_tpu_torch.obs.cost`    — per-tenant attribution of device time
  and memory byte-seconds;
- :mod:`raft_tpu_torch.obs.capacity` — utilization and saturation
  forecasting.

Recording is off by default and adds no sync point until :func:`enable`
is called (or ``RAFT_TPU_OBS=1`` is set); the counters are always on.
The serving plane (:mod:`raft_tpu_torch.serve`) drives ``quality``,
``cost`` and ``capacity``.
"""

from raft_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exemplars_for_quantile,
    get_registry,
    load_jsonl,
    quantile_from_state,
    set_registry,
)
from raft_tpu_torch.obs.trace import (  # noqa: F401
    RequestContext,
    current_request,
    new_trace_id,
    use_request,
)
from raft_tpu_torch.obs.spans import (  # noqa: F401
    count_dispatch,
    count_fallback,
    current_name,
    disable,
    enable,
    enabled,
    env_flag,
    env_tristate,
    events_enabled,
    registry,
    span,
    stages_enabled,
    sync_enabled,
)
from raft_tpu_torch.obs import hbm  # noqa: F401
from raft_tpu_torch.obs import prof  # noqa: F401
from raft_tpu_torch.obs import trace  # noqa: F401
from raft_tpu_torch.obs import flight  # noqa: F401
from raft_tpu_torch.obs import expo  # noqa: F401
from raft_tpu_torch.obs import index_stats  # noqa: F401
from raft_tpu_torch.obs import fleet  # noqa: F401
from raft_tpu_torch.obs import sanitize  # noqa: F401
from raft_tpu_torch.obs import capacity  # noqa: F401
from raft_tpu_torch.obs import cost  # noqa: F401
from raft_tpu_torch.obs import quality  # noqa: F401
