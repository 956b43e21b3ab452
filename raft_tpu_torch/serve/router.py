"""Fleet router — tenant placement and straggler-steered dispatch across
pods (counterpart of ``raft_tpu.serve.router``; the same policy, counters
and fault points).

One pod is one serving plane (a registry + dispatch over its devices);
the router is the layer above: it spreads tenants across pods (replicate
hot tenants, keep sharded ones on the pod whose mesh their sharded build
spans), carries the ONE request :class:`Deadline` across the pod hop, and
turns the straggler table (``obs.fleet.straggler_table``) from a
diagnostic into a control loop — dispatch steers load away from pods whose
hosts recently straggled, and a pod that dies mid-request is failed over
with typed accounting instead of a hang. Pods are registries in one
process; on one card several pods share it (pods on several cards wait
for ranks on several cards, ROADMAP C4).

Counters (all under ``serve.router.*``):

- ``serve.router.requests{tenant=}`` — one per routed dispatch
- ``serve.router.place{tenant=,mode=}`` — placement decisions
  (``replicate`` | ``shard`` | ``single``)
- ``serve.router.straggler{host=}`` — straggler-table rows above the
  skew threshold, as consumed by :meth:`FleetRouter.note_stragglers`
- ``serve.router.steer{away_from=,reason=straggler}`` — a dispatch
  that avoided its preferred pod because of a recent straggler
- ``serve.router.steer{away_from=,reason=capacity}`` — a placement
  that overrode the fewest-tenants heuristic because the cost
  ledger's share-weighted headroom ranked another pod better
- ``serve.router.pod_down{pod=}`` — a pod marked unhealthy after a
  failed hop
- ``serve.router.degraded{reason=pod_lost}`` — a request answered by
  surviving pods after losing one (degraded-but-correct for
  replicated tenants)
- ``serve.router.shed{reason=pod_unhealthy}`` — no healthy pod left
  (the typed refusal; reason registered in
  :data:`raft_tpu_torch.serve.errors.SHED_REASONS`)

The fault point ``serve.router.hop.<pod>`` brackets the cross-pod hop,
so the chaos lane can kill one simulated pod mid-query-storm and
assert the failover accounting exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.obs import cost as _cost
from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.robust.retry import Deadline, DeadlineExceeded
from raft_tpu_torch.serve.errors import ShedError, TenantUnknown

__all__ = ["RouterPolicy", "Pod", "FleetRouter",
           "set_router", "get_router", "clear_router"]


def _count(name: str, **labels: str) -> None:
    if _spans.enabled():
        _spans.registry().inc(name, labels=labels or None)


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """Steering knobs.

    ``skew_threshold``: a straggler-table row's ``skew_frac`` (slowest
    host's mean collective lag over the fleet mean) above which the
    slowest host counts as straggling — 0.25 = 25% above fleet mean,
    well past the jitter the straggler table shows on healthy fleets.
    ``lag_window_s``: how long one sighting keeps steering traffic away
    — stale sightings expire so a recovered host wins its load back
    without an operator touch."""

    skew_threshold: float = 0.25
    lag_window_s: float = 60.0


class Pod:
    """One serving pod: a registry (its resident tenants) plus the
    callable that runs a batch on the pod's own mesh.

    ``dispatch_fn(tenant_name, queries, k, deadline)`` defaults to the
    in-process serving plane — registry lookup +
    :func:`raft_tpu_torch.serve.dispatch.dispatch_batch` — and is injectable
    so tests (and the chaos checks) can pin a pod to any callable.
    ``hosts`` are the host tags this pod's devices live on, the join
    key against the straggler table's ``slowest`` column."""

    def __init__(self, name: str, registry: Any = None,
                 hosts: Sequence[str] = (),
                 dispatch_fn: Optional[Callable[..., Tuple[Any, Any]]]
                 = None):
        self.name = name
        self.registry = registry
        self.hosts = tuple(hosts)
        self.healthy = True
        self._dispatch_fn = dispatch_fn

    def dispatch(self, tenant: str, queries, k: int,
                 deadline: Optional[Deadline] = None) -> Tuple[Any, Any]:
        if self._dispatch_fn is not None:
            return self._dispatch_fn(tenant, queries, k, deadline)
        from raft_tpu_torch.serve.dispatch import dispatch_batch

        t = self.registry.get(tenant)
        return dispatch_batch(t, queries, k, deadline=deadline,
                              registry=self.registry)

    def has_tenant(self, tenant: str) -> bool:
        if self.registry is None:
            return True  # dispatch_fn-only pods serve everything
        try:
            self.registry.peek(tenant)
            return True
        except Exception:
            return False


class FleetRouter:
    """Routes requests to pods; consumes the straggler feed; fails
    over with typed accounting. Thread-safe (dispatch runs on serving
    threads, ``note_stragglers`` on the observability poller)."""

    def __init__(self, pods: Sequence[Pod],
                 policy: Optional[RouterPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        if not pods:
            raise ValueError("FleetRouter needs at least one pod")
        names = [p.name for p in pods]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pod names: {names}")
        self.pods = list(pods)
        self.policy = policy or RouterPolicy()
        self._clock = clock
        self._lock = _sanitize.monitored_lock("serve.router")
        # host tag -> monotonic time of last above-threshold sighting
        self._lag_seen: Dict[str, float] = {}
        # round-robin cursor per tenant (fair spread over replicas)
        self._rr: Dict[str, int] = {}

    # -- straggler control loop -------------------------------------------
    def note_stragglers(self, rows: List[Dict[str, Any]]) -> int:
        """Feed straggler-table rows (``obs.fleet.straggler_table``
        shape) into the steering state. Rows whose ``skew_frac``
        exceeds the policy threshold record a sighting against the
        ``slowest`` host. Returns how many sightings were recorded."""
        now = self._clock()
        hit = 0
        with self._lock:
            for row in rows:
                if float(row.get("skew_frac", 0.0)) \
                        <= self.policy.skew_threshold:
                    continue
                host = str(row.get("slowest", ""))
                if not host:
                    continue
                self._lag_seen[host] = now
                hit += 1
                _count("serve.router.straggler", host=host)
        return hit

    def straggling_hosts(self) -> List[str]:
        """Hosts with a live (unexpired) straggler sighting."""
        now = self._clock()
        with self._lock:
            return [h for h, t in self._lag_seen.items()
                    if now - t <= self.policy.lag_window_s]

    def _pod_straggler(self, pod: Pod) -> Optional[str]:
        lagging = set(self.straggling_hosts())
        for h in pod.hosts:
            if h in lagging:
                return h
        return None

    # -- placement ---------------------------------------------------------
    def _place_single(self, healthy: List[Pod]) -> Pod:
        """Single-pod placement scoring: prefer the pod
        with the best **cost-share-weighted headroom** — HBM headroom
        fraction minus the fleet-normalized ``cost.share`` of the
        tenants the pod already holds — so a pod whose few tenants
        burn most of the fleet's device time stops looking "empty" to
        the old fewest-tenants heuristic. Falls back to fewest-tenants
        while no ledger is installed (or nothing has been attributed
        yet). A capacity-steered choice that overrides the tenant-count
        heuristic counts ``serve.router.steer{reason=capacity}``."""
        by_count = min(healthy,
                       key=lambda p: len(p.registry.resident()))
        ledger = _cost.get_ledger()
        shares = ledger.shares() if ledger is not None else {}
        if not shares:
            return by_count

        def weighted_headroom(pod: Pod) -> float:
            usable = float(getattr(pod.registry, "usable_bytes", 0) or 0)
            resident = float(pod.registry.resident_bytes())
            headroom = (1.0 - resident / usable) if usable > 0 else 0.0
            load = sum(shares.get(t.name, 0.0)
                       for t in pod.registry.resident())
            return headroom - load

        best = max(healthy, key=weighted_headroom)
        if best is not by_count:
            _count("serve.router.steer", away_from=by_count.name,
                   reason="capacity")
        return best

    def place(self, name: str, index: Any, *, hot: bool = False,
              sharded: bool = False, params: Any = None,
              **admit_kw: Any) -> List[str]:
        """Admit a tenant to the fleet. ``hot`` replicates it to every
        healthy pod (query fan-out beats one saturated pod);
        ``sharded`` marks an index whose Sharded* build already spans
        its pod's mesh (stays on one pod — the sharding IS the spread);
        default is single-pod placement by cost-share-weighted
        headroom (:meth:`_place_single`). Returns the pod names that
        admitted it."""
        healthy = [p for p in self.pods if p.healthy
                   and p.registry is not None]
        if not healthy:
            raise ShedError("pod_unhealthy", "no healthy pod to place on")
        if hot:
            mode, targets = "replicate", healthy
        elif sharded:
            mode, targets = "shard", [healthy[0]]
        else:
            mode = "single"
            targets = [self._place_single(healthy)]
        for pod in targets:
            pod.registry.admit(name, index, params=params, **admit_kw)
        _count("serve.router.place", tenant=name, mode=mode)
        return [p.name for p in targets]

    # -- dispatch ----------------------------------------------------------
    def candidates(self, tenant: str) -> List[Pod]:
        """Healthy pods holding ``tenant``, steering-ordered: pods with
        no straggling host first (round-robin among them), straggling
        pods kept as last-resort fallbacks. Counts one
        ``serve.router.steer`` per demoted pod when a clean alternative
        exists."""
        holding = [p for p in self.pods if p.healthy
                   and p.has_tenant(tenant)]
        clean = [p for p in holding if self._pod_straggler(p) is None]
        lagging = [p for p in holding if p not in clean]
        if clean and lagging:
            for pod in lagging:
                _count("serve.router.steer",
                       away_from=str(self._pod_straggler(pod)),
                       reason="straggler")
        with self._lock:
            start = self._rr.get(tenant, 0)
            self._rr[tenant] = start + 1
        if clean:
            clean = clean[start % len(clean):] + clean[:start % len(clean)]
        return clean + lagging

    def dispatch(self, tenant: str, queries, k: int,
                 deadline: Optional[Deadline] = None) -> Tuple[Any, Any]:
        """Route one batch. The ONE ``deadline`` object crosses the pod
        hop untouched — queue wait, the hop, and the pod's own ladder
        all draw down the same budget. A pod that fails the hop (or
        dies under it) is marked unhealthy and the request fails over
        to the next candidate; typed request-scoped refusals
        (:class:`DeadlineExceeded`, :class:`TenantUnknown`,
        :class:`ShedError`) propagate — they are the REQUEST's problem,
        not the pod's."""
        _count("serve.router.requests", tenant=tenant)
        cands = self.candidates(tenant)
        if not cands:
            _count("serve.router.shed", reason="pod_unhealthy")
            raise ShedError("pod_unhealthy",
                            f"no healthy pod holds {tenant!r}")
        lost = False
        for pod in cands:
            try:
                _faults.faultpoint(f"serve.router.hop.{pod.name}")
                out = pod.dispatch(tenant, queries, k, deadline=deadline)
            except (DeadlineExceeded, TenantUnknown, ShedError):
                raise
            except Exception:
                # infrastructure failure: the pod is gone, not the
                # request — fail over to the survivors
                pod.healthy = False
                lost = True
                _count("serve.router.pod_down", pod=pod.name)
                continue
            if lost:
                _count("serve.router.degraded", reason="pod_lost")
            return out
        _count("serve.router.shed", reason="pod_unhealthy")
        raise ShedError("pod_unhealthy",
                        f"all pods holding {tenant!r} failed the hop")

    # -- introspection -----------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        lagging = set(self.straggling_hosts())
        return {
            "policy": dataclasses.asdict(self.policy),
            "straggling_hosts": sorted(lagging),
            "pods": [{
                "name": p.name,
                "healthy": p.healthy,
                "hosts": list(p.hosts),
                "straggling": any(h in lagging for h in p.hosts),
                "tenants": ([t.name for t in p.registry.resident()]
                            if p.registry is not None else None),
            } for p in self.pods],
        }


# -- process-global router (the slo-monitor install pattern) ---------------

_router: Optional[FleetRouter] = None
_router_lock = _sanitize.monitored_lock("serve.router.global")


def set_router(router: Optional[FleetRouter]) -> Optional[FleetRouter]:
    """Install the process-global router (returns the previous one)."""
    global _router
    with _router_lock:
        prev = _router
        _router = router
        return prev


def get_router() -> Optional[FleetRouter]:
    return _router


def clear_router(router: Optional[FleetRouter] = None) -> None:
    """Remove the global router; with an argument, only when it is
    still the installed one (a teardown racing a newer install must
    not clear the newer router)."""
    global _router
    with _router_lock:
        if router is None or _router is router:
            _router = None
