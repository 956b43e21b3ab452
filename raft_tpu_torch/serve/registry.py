"""Multi-tenant index registry — N resident indexes sharing one card's
memory (counterpart of ``raft_tpu.serve.registry``; the same policy, tenant
states, counters and gauges).

"Millions of users" means many *indexes*, not one — per-customer
collections, per-language shards, staging-vs-prod twins — and one card's
memory is the scarce thing they share. The registry makes residency an
explicit, observable policy instead of an allocator surprise:

- **admission** — :meth:`IndexRegistry.admit` sizes the candidate (every
  tensor of the index on the registry's device) against the budget. The
  budget comes from ``obs.hbm.bytes_limit`` of the registry's card (the
  card's memory times the process's memory fraction), minus a
  configurable headroom fraction for scan transients; a registry on the
  CPU (``device="cpu"``, asked for) takes :data:`DEFAULT_BUDGET_BYTES`, or
  an explicit ``budget_bytes``. Without a card a ``"cuda"`` registry
  raises, as every entry point of the port does.
- **one device** — a tenant whose index lives on another device than the
  registry's is refused with :class:`AdmissionError`: a batch runs on its
  index's device and is never moved.
- **demotion before eviction** — the memory tier: when a new tenant
  doesn't fit, the registry first *demotes* resident tenants' raw vectors
  to host memory (coldest first, through ``serve.placement.to_host``; the
  refined search keeps serving EXACT answers through the tiered
  candidate-row prefetch, :mod:`raft_tpu_torch.neighbors.tiered`), and only
  then sheds the least-recently-used *cold* resident (never pinned
  tenants), or refuses with a typed
  :class:`~raft_tpu_torch.serve.errors.AdmissionError`. The plan is made
  before anything moves, so a refused admission changes nothing.
  :class:`~raft_tpu_torch.serve.placement.Placement` records where each
  tenant's components live; ``index.bytes{index=,tier=hbm|host}`` gauges
  the split. Every move is counted: ``serve.registry.admit{tenant=}`` /
  ``serve.registry.evict{tenant=,reason=}`` /
  ``serve.registry.demote{tenant=}`` / ``serve.registry.promote{tenant=}``
  (demotions also land as ``degrade.steps{to=demote_raw}`` moves), with
  ``serve.registry.resident_bytes`` gauging the fleet. The counters are
  always on, as every counter of the port.
- **health** — each tenant carries an explicit state machine
  (``warming → serving → degraded``, terminal ``evicted`` / ``failed``)
  so dispatch can refuse, a dashboard can page, and the chaos checks can
  assert on the transition instead of inferring it from crashes.

"Resident" is relative to the registry's device: on a card, a tensor on
that card (the ``hbm`` tier); on a CPU registry, a tensor on the CPU,
which stands in for the card as the JAX package's CPU backend does for its
device arrays (and as ``robust.degrade`` treats it). Numpy arrays and
memmaps are always ``host``.

Fault point ``serve.registry.admit`` lets the chaos checks force
admission-time failures.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.obs import capacity as _capacity
from raft_tpu_torch.obs import hbm as _hbm
from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.serve import placement as _placement
from raft_tpu_torch.serve.errors import AdmissionError, TenantUnknown
from raft_tpu_torch.serve.placement import Placement

__all__ = ["Tenant", "IndexRegistry", "index_device_bytes",
           "index_bytes_by_tier", "Placement", "HEALTH_STATES"]

# The tenant state machine. RESIDENT states hold device memory; terminal
# states keep the Tenant record (for "why is my tenant gone" forensics)
# but not the index.
HEALTH_STATES = ("warming", "serving", "degraded", "evicted", "failed")
_RESIDENT = ("warming", "serving", "degraded")

# The CPU registry's budget when the caller pins none: generous enough
# for test tenants, small enough that a runaway admission loop still
# trips AdmissionError.
DEFAULT_BUDGET_BYTES = 8 << 30


def _leaves(obj: Any) -> List[Any]:
    """The array leaves of an index: the tensor and array fields of its
    dataclass, walked into lists, tuples and dicts (a sharded index holds
    a list of per-rank tensors). Anything else is no leaf."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: List[Any] = []
        for f in dataclasses.fields(obj):
            out += _leaves(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves(v)]
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _leaves(v)]
    return []


def _on_device(x: Any, device: Optional[torch.device]) -> bool:
    """True for a tensor on ``device`` (None: on any card) — the
    ``hbm`` tier."""
    if not isinstance(x, torch.Tensor):
        return False
    if device is None:
        return x.device.type == "cuda"
    return _same_device(x.device, device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib


def _nbytes(x: Any) -> int:
    return int(getattr(x, "nbytes", 0) or 0)


def index_device_bytes(index: Any, device: Any = None) -> int:
    """Device residency of an index: the ``nbytes`` of every tensor of
    the index that lives on ``device`` (default: on a card — any CUDA
    tensor). Host-resident fields — CPU tensors, numpy arrays, memmaps —
    cost ZERO device memory and are not charged against the admission
    budget. A registry passes its own device, so on a CPU registry the
    CPU tensors are what it charges."""
    dev = None if device is None else torch.device(device)
    return sum(_nbytes(x) for x in _leaves(index) if _on_device(x, dev))


def index_bytes_by_tier(index: Any, dataset: Any = None,
                        device: Any = None) -> Dict[str, int]:
    """``{"hbm": ..., "host": ...}`` byte split of an index plus an
    optional re-rank ``dataset`` — the ``index.bytes{tier=}`` gauges and
    ``/indexz``: a tensor on ``device`` (default: any CUDA tensor) is
    ``hbm``; every other array — a CPU tensor, numpy array or memmap — is
    ``host``."""
    dev = None if device is None else torch.device(device)
    out = {"hbm": 0, "host": 0}
    leaves = _leaves(index)
    if dataset is not None:
        leaves += _leaves(dataset)
    for leaf in leaves:
        tier = "hbm" if _on_device(leaf, dev) else "host"
        out[tier] += _nbytes(leaf)
    return out


@dataclasses.dataclass
class Tenant:
    """One resident index + its serving policy and health."""

    name: str
    index: Any
    params: Any = None            # default SearchParams for dispatch
    default_k: int = 10
    # the tenant's CLOSED k surface: the server warms every (bucket × k)
    # in this set and submit() rejects anything outside it — an un-warmed
    # k would pay its first-call cost (allocator growth, library
    # heuristics) on the serving path, a head-of-line latency spike
    serve_ks: tuple = ()
    size_bytes: int = 0
    pinned: bool = False          # never auto-evicted
    state: str = "warming"
    admitted_at: float = 0.0
    last_used: float = 0.0        # monotonic; the LRU eviction key
    requests: int = 0
    # the quality plane: ``dataset`` is the exact ground the
    # shadow verifier replays against (no dataset → no verification for
    # this tenant — counted, never an error); ``recall_floor`` arms the
    # SLO monitor's closed loop (CI lower bound below it → degraded
    # health + quality-rung gate); ``index_stats`` caches the
    # admission-time health introspection for /indexz
    dataset: Any = None
    recall_floor: Optional[float] = None
    index_stats: Optional[Dict[str, Any]] = None
    # the memory tier: where this tenant's components live.
    # ``raw_hbm_bytes`` remembers the dataset's device footprint so a
    # demotion knows how much device memory it returns and a re-promotion how
    # much it must find; ``demoted`` marks raw=host as PRESSURE-driven
    # (promote_when_clear re-promotes only these — a tenant admitted
    # host-resident by choice stays host-resident)
    placement: Optional[Placement] = None
    raw_hbm_bytes: int = 0
    demoted: bool = False

    def describe(self) -> Dict[str, Any]:
        """Registry snapshot row (flight dumps / debugging)."""
        out = {"name": self.name, "state": self.state,
               "size_bytes": self.size_bytes, "pinned": self.pinned,
               "requests": self.requests}
        if self.recall_floor is not None:
            out["recall_floor"] = self.recall_floor
        if self.placement is not None:
            out["placement"] = self.placement.describe()
            if self.demoted:
                out["demoted"] = True
        return out


def _count(name: str, labels: Dict[str, str]) -> None:
    # always on, as every counter of the port
    _spans.registry().inc(name, labels=labels)


def _gauge(name: str, value: float) -> None:
    _spans.registry().gauge(name).set(value)


class IndexRegistry:
    """Thread-safe registry of resident tenants under one device's memory
    budget.

    ``device`` (default ``"cuda"``) is the card the tenants live on; it is
    resolved at construction, so a ``"cuda"`` registry raises without a
    card. ``budget_bytes=None`` reads that card's ``bytes_limit``
    (``obs.hbm``); a CPU registry takes :data:`DEFAULT_BUDGET_BYTES`.
    ``headroom_frac`` of the budget is reserved for scan/refine transients
    (the working set a search needs beyond the index itself)."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 headroom_frac: float = 0.10, device: Any = "cuda"):
        self.device = resolve_device(device)
        if budget_bytes is None:
            if self.device.type == "cpu":
                budget_bytes = DEFAULT_BUDGET_BYTES
            else:
                budget_bytes = _hbm.bytes_limit(self.device)
                if not budget_bytes:
                    raise RuntimeError(
                        f"{self.device} reports no memory limit; pass "
                        "budget_bytes")
        if not 0.0 <= headroom_frac < 1.0:
            raise ValueError(f"headroom_frac {headroom_frac} not in [0, 1)")
        self.budget_bytes = int(budget_bytes)
        self.headroom_frac = float(headroom_frac)
        self._tenants: Dict[str, Tenant] = {}
        self._lock = _sanitize.monitored_rlock("serve.registry")
        if _spans.enabled():
            # mirror the admission budget into the hbm.bytes_limit family
            # (its own {source=admission} series — never the allocator's
            # readings)
            _hbm.note_budget(self.budget_bytes, _spans.registry())

    # -- tiers ---------------------------------------------------------------
    def resident_dataset(self, dataset: Any) -> bool:
        """True for a re-rank base the device tiers index in place: a
        tensor on this registry's device (the ``hbm`` tier)."""
        return _on_device(dataset, self.device)

    def _check_device(self, name: str, index: Any) -> None:
        dev = getattr(index, "device", None)
        if isinstance(dev, torch.device) and not _same_device(dev,
                                                              self.device):
            raise AdmissionError(
                f"tenant {name!r}'s index lives on {dev}, the registry "
                f"serves {self.device}: a batch runs on its index's device "
                "and is never moved")

    # -- capacity -----------------------------------------------------------
    @property
    def usable_bytes(self) -> int:
        """The admission ceiling: budget minus transient headroom."""
        return int(self.budget_bytes * (1.0 - self.headroom_frac))

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(t.size_bytes for t in self._tenants.values()
                       if t.state in _RESIDENT)

    def _evict_candidates(self) -> List[Tenant]:
        """Evictable residents, coldest first (LRU by last dispatch)."""
        return sorted((t for t in self._tenants.values()
                       if t.state in _RESIDENT and not t.pinned),
                      key=lambda t: t.last_used)

    def _demote_candidates(self) -> List[Tenant]:
        """Residents whose raw vectors could move to host (a dataset on
        this device, not pinned), coldest first — the demote-before-evict
        plan walks these."""
        return [t for t in self._evict_candidates()
                if self.resident_dataset(t.dataset)]

    # -- lifecycle ----------------------------------------------------------
    def admit(self, name: str, index: Any, *, params: Any = None,
              default_k: int = 10, ks: Optional[Any] = None,
              pinned: bool = False,
              size_bytes: Optional[int] = None,
              dataset: Any = None,
              recall_floor: Optional[float] = None,
              placement: Optional[Placement] = None) -> Tenant:
        """Admit ``index`` as tenant ``name``, demoting resident tenants'
        raw vectors to host and then evicting LRU cold tenants as needed
        to fit under :attr:`usable_bytes`. Raises :class:`AdmissionError`
        when the index cannot fit even after shedding every evictable
        resident (or is alone too big for the budget), or lives on another
        device than the registry's. ``ks`` enumerates the tenant's served
        k values (default: just ``default_k``) — the server warms exactly
        this set and refuses others. ``dataset`` (optional) is the
        tenant's source rows — the shadow verifier's exact ground truth
        AND the refined search's re-rank base — and ``recall_floor`` its
        quality SLO. ``placement`` declares where components live; the
        default is inferred from the dataset's residency. A declared
        ``raw="host"`` with a device dataset demotes it at admission (one
        copy to the host); ``raw="hbm"`` with a host dataset is a
        contradiction and raises. Sizing is honest: only tensors on the
        registry's device count. Re-admitting a live name replaces it.
        Admission is all-or-nothing: the demotion + eviction set
        (including a replaced prior) is PLANNED before anything is
        released, so a refused admission leaves every resident tenant —
        the prior under this name included — exactly as it was."""
        _faults.faultpoint("serve.registry.admit")
        self._check_device(name, index)
        resident = self.resident_dataset(dataset)
        if placement is None:
            placement = Placement(
                codes="hbm", raw=("none" if dataset is None
                                  else "hbm" if resident else "host"))
        elif placement.raw == "hbm" and not resident:
            raise AdmissionError(
                f"tenant {name!r} declares Placement(raw='hbm') but "
                f"its dataset is {'missing' if dataset is None else 'host-resident'} "
                f"— hand a tensor on {self.device} or declare raw='host'")
        elif placement.raw == "host" and resident:
            # declared host residency wins: demote at admission (one copy
            # to the host) so the budget math below sees the real tiers
            dataset = _placement.to_host(dataset)
            resident = False
        elif placement.raw != "none" and dataset is None:
            raise AdmissionError(
                f"tenant {name!r} declares Placement(raw="
                f"{placement.raw!r}) without a dataset")
        raw_hbm = _nbytes(dataset) if resident else 0
        size = (index_device_bytes(index, self.device) + raw_hbm) \
            if size_bytes is None else int(size_bytes)
        with self._lock:
            if size > self.usable_bytes:
                raise AdmissionError(
                    f"tenant {name!r} needs {size:,} B but the usable "
                    f"budget is {self.usable_bytes:,} B "
                    f"({self.budget_bytes:,} B minus "
                    f"{self.headroom_frac:.0%} headroom)")
            prior = self._tenants.get(name)
            replacing = prior is not None and prior.state in _RESIDENT
            # simulate first: the prior's bytes come back for free, then
            # raw-vector demotions (coldest first — device memory
            # reclaimed, tenants keep serving exact answers via the tiered
            # prefetch), then LRU victims until the candidate fits — or
            # nobody moves
            projected = self.resident_bytes()
            if replacing:
                projected -= prior.size_bytes
            demotions: List[Tenant] = []
            for cand in self._demote_candidates():
                if projected + size <= self.usable_bytes:
                    break
                if cand.name == name:
                    continue  # the prior is accounted above
                demotions.append(cand)
                projected -= _nbytes(cand.dataset)
            victims: List[Tenant] = []
            for cand in self._evict_candidates():
                if projected + size <= self.usable_bytes:
                    break
                if cand.name == name:
                    continue  # the prior is accounted above
                victims.append(cand)
                projected -= cand.size_bytes
                if cand in demotions:
                    # evicting it releases the whole tenant — do not
                    # double-count the planned raw demotion
                    demotions.remove(cand)
                    projected += _nbytes(cand.dataset)
            if projected + size > self.usable_bytes:
                raise AdmissionError(
                    f"tenant {name!r} ({size:,} B) does not fit: "
                    f"{self.resident_bytes():,} B resident are pinned "
                    f"or un-evictable under the {self.usable_bytes:,} B "
                    "usable budget")
            # capacity-forecast hook: the plan above handles the pressure
            # cliff; the installed capacity model looks AHEAD. When the
            # resident-bytes trend (plus this candidate) saturates the
            # budget inside the policy horizon, demote additional raw
            # tiers NOW — coldest first, enough to cover the projected
            # growth. Counted apart from pressure demotions
            # (``serve.registry.preemptive_demote{tenant=}``).
            preemptive: List[Tenant] = []
            model = _capacity.get_model()
            if model is not None and model.would_saturate(
                    extra_bytes=float(size)):
                need = (float(projected + size)
                        + model.projected_growth_bytes()
                        - float(self.usable_bytes))
                for cand in self._demote_candidates():
                    if need <= 0.0:
                        break
                    if cand.name == name or cand in demotions \
                            or cand in victims:
                        continue
                    preemptive.append(cand)
                    need -= float(_nbytes(cand.dataset))
            # commit: the admission is now guaranteed to succeed
            for demo in demotions:
                self._demote_locked(demo, reason="pressure")
            for demo in preemptive:
                self._demote_locked(demo, reason="preemptive")
                _count("serve.registry.preemptive_demote",
                       {"tenant": demo.name})
            for victim in victims:
                self._evict_locked(victim, reason="pressure")
            if replacing:
                self._evict_locked(prior, reason="replaced")
            now = time.monotonic()
            serve_ks = tuple(sorted({int(k) for k in (ks or [default_k])}
                                    | {int(default_k)}))
            tenant = Tenant(name=name, index=index, params=params,
                            default_k=default_k, serve_ks=serve_ks,
                            size_bytes=size,
                            pinned=pinned, state="warming",
                            admitted_at=now, last_used=now,
                            dataset=dataset,
                            recall_floor=(None if recall_floor is None
                                          else float(recall_floor)),
                            placement=placement, raw_hbm_bytes=raw_hbm)
            self._tenants[name] = tenant
            self._note_tier_bytes(tenant)
            # admission-time health introspection: list skew always;
            # drift + PQ quantization error only when the caller handed a
            # dataset. Cached on the tenant for /indexz; gauges land as
            # index.*{index=}.
            from raft_tpu_torch.obs import index_stats as _istats

            if dataset is not None:
                stats = _istats.describe_index(index, dataset)
                _istats.note_index_stats(index, name=name, stats=stats)
                tenant.index_stats = stats
            elif _spans.enabled():
                tenant.index_stats = _istats.note_index_stats(
                    index, name=name, cheap=True)
            _count("serve.registry.admit", {"tenant": name})
            _gauge("serve.registry.resident_bytes", self.resident_bytes())
            _log.info("registry: admitted %r (%s B, pinned=%s, "
                      "%d resident)", name, f"{size:,}", pinned,
                      len(self.resident()))
            return tenant

    def _note_tier_bytes(self, tenant: Tenant) -> None:
        """Publish the tenant's device-vs-host byte split as
        ``index.bytes{index=,tier=}`` gauges (obs.index_stats owns the
        family) — a demoted tenant is visible at a glance."""
        if not _spans.enabled():
            return
        from raft_tpu_torch.obs import index_stats as _istats

        index = tenant.index
        if index is None:  # terminal: both tiers read zero
            _istats.note_tier_bytes(tenant.name, hbm_bytes=0,
                                    host_bytes=0)
            return
        split = index_bytes_by_tier(index, tenant.dataset, self.device)
        _istats.note_tier_bytes(tenant.name, hbm_bytes=split["hbm"],
                                host_bytes=split["host"])

    def _evict_locked(self, tenant: Tenant, reason: str) -> None:
        tenant.state = "evicted"
        tenant.index = None  # drop the reference; GC frees the memory
        _count("serve.registry.evict",
               {"tenant": tenant.name, "reason": reason})
        _gauge("serve.registry.resident_bytes", self.resident_bytes())
        self._note_tier_bytes(tenant)
        _log.warn("registry: evicted %r (%s)", tenant.name, reason)

    def _demote_locked(self, tenant: Tenant, reason: str) -> None:
        """Move a resident tenant's raw vectors to host memory: one copy
        to the host (``serve.placement.to_host``), ``size_bytes`` gives
        back the dataset's device footprint, and the refined search keeps
        serving EXACT answers through the tiered prefetch (the dataset
        reference swap is atomic under the GIL; an in-flight dispatch
        holding the device tensor finishes on it). Counted both as the
        registry's own move (``serve.registry.demote{tenant=}``) and as
        the degradation policy's (``degrade.steps{to=demote_raw}``)."""
        from raft_tpu_torch.robust import degrade as _degrade

        raw_bytes = _nbytes(tenant.dataset)
        tenant.dataset = _placement.to_host(tenant.dataset)
        tenant.raw_hbm_bytes = raw_bytes
        tenant.demoted = True
        tenant.size_bytes = max(0, tenant.size_bytes - raw_bytes)
        if tenant.placement is not None:
            tenant.placement = dataclasses.replace(tenant.placement,
                                                   raw="host")
        _count("serve.registry.demote", {"tenant": tenant.name})
        _degrade.note_step("serve.registry", "raw_hbm", "demote_raw",
                           reason)
        _gauge("serve.registry.resident_bytes", self.resident_bytes())
        self._note_tier_bytes(tenant)
        _log.warn("registry: demoted %r raw vectors to host "
                  "(%s B reclaimed, %s)", tenant.name,
                  f"{raw_bytes:,}", reason)

    def demote_raw(self, name: str, reason: str = "manual") -> None:
        """Explicitly demote a tenant's raw vectors to host memory
        (idempotent on already-host or dataset-less tenants; unknown or
        terminal tenants raise)."""
        with self._lock:
            tenant = self.peek(name)
            if self.resident_dataset(tenant.dataset):
                self._demote_locked(tenant, reason=reason)

    def promote_when_clear(self) -> List[str]:
        """Re-promote pressure-demoted raw vectors while headroom allows
        (hottest first). Called after explicit evictions free budget;
        returns the promoted tenant names. Only PRESSURE demotions
        promote: a tenant admitted with ``Placement(raw="host")`` chose
        the tier and keeps it."""
        promoted: List[str] = []
        with self._lock:
            cands = sorted(
                (t for t in self._tenants.values()
                 if t.state in _RESIDENT and t.demoted
                 and t.dataset is not None),
                key=lambda t: -t.last_used)
            for tenant in cands:
                need = tenant.raw_hbm_bytes or _nbytes(tenant.dataset)
                if self.resident_bytes() + need > self.usable_bytes:
                    continue
                tenant.dataset = _placement.to_device(tenant.dataset,
                                                      self.device)
                tenant.size_bytes += _nbytes(tenant.dataset)
                tenant.demoted = False
                if tenant.placement is not None:
                    tenant.placement = dataclasses.replace(
                        tenant.placement, raw="hbm")
                _count("serve.registry.promote", {"tenant": tenant.name})
                _gauge("serve.registry.resident_bytes",
                       self.resident_bytes())
                self._note_tier_bytes(tenant)
                _log.info("registry: re-promoted %r raw vectors to %s "
                          "(%s B)", tenant.name, self.device,
                          f"{_nbytes(tenant.dataset):,}")
                promoted.append(tenant.name)
        return promoted

    def evict(self, name: str, reason: str = "manual") -> None:
        """Explicitly release a tenant's residency (idempotent on
        already-terminal tenants; unknown names raise). Freed budget
        re-promotes pressure-demoted raw vectors
        (:meth:`promote_when_clear`)."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise TenantUnknown(name)
            if tenant.state in _RESIDENT:
                self._evict_locked(tenant, reason=reason)
                self.promote_when_clear()

    def mark(self, name: str, state: str) -> None:
        """Health transition (``warming``/``serving``/``degraded``/
        ``failed``/``evicted``). Terminal states release the index:
        ``evicted`` routes through the same path as :meth:`evict`
        (counted, gauge updated) and ``failed`` drops the reference —
        either way a terminal tenant can never pin HBM that
        ``resident_bytes()`` no longer counts."""
        assert state in HEALTH_STATES, state
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise TenantUnknown(name)
            if tenant.state not in _RESIDENT:
                # terminal states are FINAL: a slow lock-free warmup
                # finishing with mark("serving") after a concurrent
                # pressure eviction must not resurrect an index-less
                # record into residency (phantom resident_bytes + an
                # untyped NoneType crash at the next dispatch)
                return
            if state == "evicted":
                self._evict_locked(tenant, reason="manual")
                return
            tenant.state = state
            if state == "failed":
                tenant.index = None
                _gauge("serve.registry.resident_bytes",
                       self.resident_bytes())

    def note_degraded(self, name: str) -> None:
        """Lock-protected health demotion from dispatch: a live tenant
        whose ladder moved becomes ``degraded``; anything else —
        terminal states above all — is left alone (an unlocked
        check-then-set from the batcher could otherwise resurrect a
        concurrently-evicted record into residency). Unknown names are
        a no-op: the tenant may have been dropped mid-dispatch."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is not None and tenant.state in ("warming",
                                                       "serving"):
                tenant.state = "degraded"

    def note_recovered(self, name: str) -> None:
        """Lock-protected promotion back to ``serving`` — the closed
        half of the quality loop: the SLO monitor calls this
        when a tenant it demoted for a recall-floor breach shows fresh
        evidence above the floor. Only ``degraded`` promotes — terminal
        states stay final (same resurrection hazard as
        :meth:`note_degraded`) and ``warming`` stays the server's to
        finish. Unknown names are a no-op."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is not None and tenant.state == "degraded":
                tenant.state = "serving"

    # -- lookup -------------------------------------------------------------
    def peek(self, name: str) -> Tenant:
        """Side-effect-free lookup: resolves a RESIDENT tenant WITHOUT
        touching its LRU clock. The validation lookup — submit-time
        checks (and warmup) must not heat a tenant's eviction recency:
        a flood of shed/invalid traffic would otherwise keep a tenant
        LRU-hot while quieter tenants actually serving requests get
        evicted. Unknown or terminal tenants raise
        :class:`TenantUnknown`."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise TenantUnknown(name)
            if tenant.state not in _RESIDENT:
                raise TenantUnknown(name, state=tenant.state)
            return tenant

    def get(self, name: str) -> Tenant:
        """The dispatch lookup: :meth:`peek` + touch the LRU clock
        (``last_used`` = last *dispatched*, the eviction recency key).
        ``Tenant.requests`` is accounted by the server per accepted
        request, not here."""
        with self._lock:
            tenant = self.peek(name)
            tenant.last_used = time.monotonic()
            return tenant

    def resident(self) -> List[Tenant]:
        """Resident tenants (any health), admission order."""
        with self._lock:
            return [t for t in self._tenants.values()
                    if t.state in _RESIDENT]

    def tenants(self) -> List[Tenant]:
        """All tenants including terminal ones (forensics)."""
        with self._lock:
            return list(self._tenants.values())

    def describe(self) -> Dict[str, Any]:
        """Snapshot for flight dumps / logs."""
        with self._lock:
            return {"budget_bytes": self.budget_bytes,
                    "usable_bytes": self.usable_bytes,
                    "resident_bytes": self.resident_bytes(),
                    "tenants": [t.describe()
                                for t in self._tenants.values()]}
