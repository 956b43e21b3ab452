"""raft_tpu_torch.robust — fault injection, retries, degradation, resumable
builds (counterpart of ``raft_tpu.robust``).

- :mod:`~raft_tpu_torch.robust.faults` — named fault points
  (``faultpoint("ivf_pq.search")``) driven by an env/JSON fault plan
  (``RAFT_TPU_FAULT_PLAN`` / ``RAFT_TPU_FAULT_PLAN_JSON``; raise-OOM /
  SIGTERM-self / sleep / NaN / force-decline);
- :mod:`~raft_tpu_torch.robust.retry` — exponential backoff + jitter,
  deadline budgets, ``retry.attempts{site=}`` counters and the
  request-scoped :class:`~raft_tpu_torch.robust.retry.Deadline`; OOMs and
  CUDA runtime errors are never retried;
- :mod:`~raft_tpu_torch.robust.degrade` — the RESOURCE_EXHAUSTED
  degradation ladder (halve batch → bf16 LUT → fp8 LUT → demote raw →
  decline fused tier → host gather) with
  ``degrade.steps{site=,from=,to=,reason=}`` counters;
- :mod:`~raft_tpu_torch.robust.checkpoint` — atomic build manifests and
  encoded-list shards, readable by both packages.

Everything is inert until a fault plan is installed or a policy invoked;
a fault point costs one None check when no plan is active.
"""

from raft_tpu_torch.robust import checkpoint, degrade, faults, retry  # noqa: F401
