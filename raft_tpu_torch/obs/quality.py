"""Online recall estimation — a shadow verifier for live ANN traffic
(counterpart of ``raft_tpu.obs.quality``; the same verifier, RNG streams,
series and flight section, in host numpy as there).

Every offline recall number is measured against benchmark ground truth;
the knobs that *trade* recall at runtime — bf16/fp8 LUTs, the degrade
ladder's rungs, refine ratios — run unmeasured. This module closes the
loop: a :class:`RecallVerifier` samples a small fraction of live
requests, replays each one through an exact host-side brute-force scan
over the tenant's dataset, and turns the verdict stream into per-tenant
recall gauges with Wilson confidence intervals.

Strictly off the hot path, by construction:

- the serving thread pays one fraction draw per completed request
  (deterministic per-tenant RNG, so tests replay the accept pattern and
  both packages accept the same requests), a token-bucket rate check,
  and a bounded-reservoir insert — numpy copies of one query row and one
  id row, no device work;
- verification runs on a background thread with **no deadline** (a
  shadow request can never shed real traffic), on the **host** in numpy;
  a dataset on the card is copied to the host once per tenant and cached;
- each replay is **admission-checked** against the registry's memory
  headroom first — a budget-full card skips verification (counted
  ``quality.skipped{reason=admission}``) rather than competing with
  tenants for bytes;
- burst overflow displaces reservoir entries (algorithm-R style) and
  over-rate samples are dropped, both counted, so sustained overload
  costs a bounded, constant verification load.

Gauges/counters (per tenant, per served k):
``quality.recall{tenant=,k=}`` (windowed mean),
``quality.recall_ci_low/high{tenant=,k=}`` (Wilson bounds),
``quality.samples{tenant=,k=}``, ``quality.verified{tenant=}``,
``quality.skipped{tenant=,reason=}``. Every verdict lands in the
``quality.recall_loss{tenant=}`` histogram with the request's trace id as
exemplar — the buckets retain the LARGEST losses, so the worst answers
resolve to concrete request timelines.

:meth:`RecallVerifier.state` feeds the flight recorder's ``"quality"``
section (current per-tenant estimates + the last ≤32 verdicts with trace
ids), so a killed serving run keeps its quality evidence.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _spans

__all__ = ["VerifierConfig", "RecallVerifier", "wilson_interval",
           "exact_topk_ids", "recall_at_k", "LOSS_BUCKETS"]

#: ``quality.recall_loss`` histogram edges (loss = 1 − recall). Fine
#: near zero — healthy tenants live there — with the exemplar
#: reservoirs of the upper buckets naming the worst-served requests.
LOSS_BUCKETS = (0.0, 0.01, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0)


def wilson_interval(hits: float, total: float, z: float = 1.96
                    ) -> Tuple[float, float]:
    """Wilson score interval for a binomial proportion — the right CI
    for recall estimated from few samples near 1.0 (a normal
    approximation would poke above 1.0 and collapse at p̂=1)."""
    if total <= 0:
        return (0.0, 1.0)
    p = hits / total
    z2 = z * z
    denom = 1.0 + z2 / total
    center = (p + z2 / (2.0 * total)) / denom
    half = (z * math.sqrt(p * (1.0 - p) / total
                          + z2 / (4.0 * total * total))) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def exact_topk_ids(dataset: np.ndarray, query: np.ndarray, k: int,
                   metric: str = "sqeuclidean",
                   sq_norms: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact top-k row ids for one query — host numpy, O(n·d).
    Ordering matches the index metrics: inner_product/cosine maximize,
    every L2 flavor minimizes (sqrt and expansion don't change order).
    Cosine normalizes the query only — dataset row norms rescale all
    scores per-row identically under cosine's row normalization.

    ``sq_norms`` (the port's addition) is ``np.sum(x * x, axis=1)`` of the
    dataset, computed once by the caller: the same values, so the same
    ids, and an L2 replay then reads the dataset once (its product with
    the query) instead of three times — the verifier caches them per
    tenant, which on a 10M-row base is most of a replay's time."""
    x = np.asarray(dataset, np.float32)
    q = np.asarray(query, np.float32).reshape(-1)
    if metric in ("inner_product", "cosine"):
        scores = x @ q
        if metric == "cosine":
            scores = scores / np.maximum(
                np.linalg.norm(x, axis=1), 1e-12)
        order = -scores
    else:
        sq = np.sum(x * x, axis=1) if sq_norms is None else sq_norms
        order = sq - 2.0 * (x @ q)
    k = min(int(k), x.shape[0])
    part = np.argpartition(order, k - 1)[:k]
    return part[np.argsort(order[part], kind="stable")]


def recall_at_k(served_ids: np.ndarray, true_ids: np.ndarray,
                k: int) -> float:
    """|served ∩ exact| / k. Pads (-1) in the served row count against
    recall — a half-filled answer IS a quality failure."""
    served = {int(i) for i in np.asarray(served_ids).reshape(-1)[:k]
              if int(i) >= 0}
    true = {int(i) for i in np.asarray(true_ids).reshape(-1)[:k]}
    if not true:
        return 1.0
    return len(served & true) / float(max(k, 1))


@dataclasses.dataclass(frozen=True)
class VerifierConfig:
    """Shadow-verifier knobs.

    ``sample_fraction`` is the per-request acceptance probability
    (deterministic per-tenant RNG seeded from ``seed`` — tests replay
    the pattern). ``rate_limit_per_s`` is a per-tenant token bucket on
    *accepted* samples — the fraction bounds relative load, the bucket
    bounds absolute load under a traffic spike. ``reservoir_depth``
    bounds the pending-replay queue; bursts displace uniformly
    (algorithm-R) instead of growing it. ``window`` is the per-(tenant,
    k) verdict window the CI is computed over; ``max_verdicts`` the
    flight-section verdict ring."""

    sample_fraction: float = 0.02
    rate_limit_per_s: float = 50.0
    reservoir_depth: int = 32
    window: int = 64
    max_verdicts: int = 32
    seed: int = 0
    z: float = 1.96
    #: host-bytes safety factor for the admission check: a replay's
    #: working set is the host dataset view + one score row; device-
    #: resident datasets transfer through a transient this multiplies
    admission_factor: float = 1.0


class _Window:
    """Per-(tenant, k) rolling verdict window."""

    __slots__ = ("recalls",)

    def __init__(self, cap: int):
        self.recalls: Deque[float] = deque(maxlen=cap)


class RecallVerifier:
    """Reservoir-sampling shadow verifier over an
    :class:`~raft_tpu_torch.serve.registry.IndexRegistry` (duck-typed: only
    ``peek``/``usable_bytes``/``resident_bytes`` are used).

    The serving loop calls :meth:`maybe_sample` per completed request;
    a daemon worker drains the reservoir, replays each sample exactly,
    and publishes gauges. ``on_verdict`` (set by the server) lets the
    SLO monitor re-evaluate recall floors as evidence arrives."""

    def __init__(self, registry: Any,
                 config: Optional[VerifierConfig] = None):
        self.registry = registry
        self.config = config or VerifierConfig()
        self.on_verdict: Optional[Callable[[str], None]] = None
        self._lock = _sanitize.monitored_lock("obs.quality")
        self._cond = threading.Condition(self._lock)
        self._pending: List[Dict[str, Any]] = []
        self._seen: Dict[str, int] = {}           # accepted, per tenant
        self._rngs: Dict[str, random.Random] = {}
        self._bucket: Dict[str, Tuple[float, float]] = {}  # tokens, t
        self._windows: Dict[Tuple[str, int], _Window] = {}
        self._verdicts: Deque[Dict[str, Any]] = deque(
            maxlen=self.config.max_verdicts)
        self._host_ds: Dict[str, Tuple[int, np.ndarray]] = {}
        self._host_sq: Dict[str, Tuple[int, np.ndarray]] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._verified_total = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RecallVerifier":
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._worker,
                                        name="raft-tpu-quality-verifier",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- hot-path sampling --------------------------------------------------
    def _rng(self, tenant: str) -> random.Random:
        rng = self._rngs.get(tenant)
        if rng is None:
            # crc32, not hash(): str hashing is salted per process and
            # would break the deterministic-seed replay contract
            rng = random.Random(self.config.seed * 1_000_003
                               + zlib.crc32(tenant.encode()))
            self._rngs[tenant] = rng
        return rng

    def _take_token(self, tenant: str, now: float) -> bool:
        rate = self.config.rate_limit_per_s
        if rate <= 0:
            return True
        burst = max(1.0, rate)
        tokens, last = self._bucket.get(tenant, (burst, now))
        tokens = min(burst, tokens + (now - last) * rate)
        if tokens < 1.0:
            self._bucket[tenant] = (tokens, now)
            return False
        self._bucket[tenant] = (tokens - 1.0, now)
        return True

    def maybe_sample(self, tenant: str, query: np.ndarray, k: int,
                     served_ids: np.ndarray, trace_id: str) -> bool:
        """Offer one completed request for shadow verification. Returns
        whether it was enqueued. Cheap when not sampled: one RNG draw
        under the verifier lock (never the server's)."""
        if self.config.sample_fraction <= 0.0:
            return False
        now = time.monotonic()
        with self._lock:
            rng = self._rng(tenant)
            if rng.random() >= self.config.sample_fraction:
                return False
            if not self._take_token(tenant, now):
                self._count_skip(tenant, "rate_limit")
                return False
            self._seen[tenant] = self._seen.get(tenant, 0) + 1
            item = {"tenant": tenant, "k": int(k),
                    "query": np.array(query, np.float32, copy=True),
                    "ids": np.array(served_ids, copy=True).reshape(-1),
                    "trace_id": str(trace_id)}
            if len(self._pending) < self.config.reservoir_depth:
                self._pending.append(item)
            else:
                # algorithm-R over this tenant's accepted stream: keep
                # each accepted sample with equal probability, bounded
                # memory — bursts displace, never grow
                j = rng.randrange(self._seen[tenant])
                if j < self.config.reservoir_depth:
                    self._pending[j % len(self._pending)] = item
                self._count_skip(tenant, "reservoir")
            self._cond.notify()
            return True

    # -- background replay --------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self._lock:
                while self._running and not self._pending:
                    self._cond.wait(0.1)
                if not self._running and not self._pending:
                    return
                item = self._pending.pop(0)
            try:
                self._verify(item)
            except Exception:  # noqa: BLE001 — a shadow replay must
                self._count_skip(item["tenant"], "error")  # never kill
                continue                                   # the worker

    def _admission_ok(self, tenant_rec: Any, dataset: Any) -> bool:
        """Refuse replay when the registry's HBM headroom cannot cover
        the replay working set (host view of a device-resident dataset
        + one score row) — shadow traffic must not contend with tenant
        admissions for bytes."""
        try:
            nbytes = int(getattr(dataset, "nbytes", 0))
            need = int(nbytes * self.config.admission_factor)
            if isinstance(dataset, np.ndarray):
                need = 0  # already host-resident: no transfer transient
            headroom = (int(self.registry.usable_bytes)
                        - int(self.registry.resident_bytes()))
            return need <= max(headroom, 0)
        except Exception:  # noqa: BLE001 — no registry capacity API:
            return True    # nothing to check against

    def _host_dataset(self, tenant: str, dataset: Any) -> np.ndarray:
        """Host view of the tenant's dataset, cached per tenant and
        invalidated when the tenant re-admits a different array. A tensor
        (on the card or the CPU) is copied to the host once; a numpy array
        or memmap is read in place."""
        key = id(dataset)
        cached = self._host_ds.get(tenant)
        if cached is not None and cached[0] == key:
            return cached[1]
        if isinstance(dataset, torch.Tensor):
            host = dataset.detach().to("cpu", torch.float32).numpy()
        else:
            host = np.asarray(dataset, np.float32)
        self._host_ds[tenant] = (key, host)
        return host

    def _host_sq_norms(self, tenant: str, dataset: Any,
                       host: np.ndarray) -> np.ndarray:
        """The host rows' squared norms, cached per tenant beside
        :meth:`_host_dataset` (and invalidated with it)."""
        key = id(dataset)
        cached = self._host_sq.get(tenant)
        if cached is not None and cached[0] == key:
            return cached[1]
        sq = np.sum(host * host, axis=1)
        self._host_sq[tenant] = (key, sq)
        return sq

    def _verify(self, item: Dict[str, Any]) -> None:
        tenant_name, k = item["tenant"], item["k"]
        try:
            tenant_rec = self.registry.peek(tenant_name)
        except Exception:  # noqa: BLE001 — evicted since sampling
            self._count_skip(tenant_name, "tenant_gone")
            return
        dataset = getattr(tenant_rec, "dataset", None)
        if dataset is None:
            self._count_skip(tenant_name, "no_dataset")
            return
        if not self._admission_ok(tenant_rec, dataset):
            self._count_skip(tenant_name, "admission")
            return
        metric = str(getattr(tenant_rec.index, "metric", "sqeuclidean"))
        host = self._host_dataset(tenant_name, dataset)
        sq = (None if metric in ("inner_product", "cosine")
              else self._host_sq_norms(tenant_name, dataset, host))
        true_ids = exact_topk_ids(host, item["query"], k, metric,
                                  sq_norms=sq)
        recall = recall_at_k(item["ids"], true_ids, k)
        self._publish(tenant_name, k, recall, item["trace_id"])
        cb = self.on_verdict
        if cb is not None:
            try:
                cb(tenant_name)
            except Exception:  # noqa: BLE001
                pass

    # -- aggregation / publication ------------------------------------------
    def _publish(self, tenant: str, k: int, recall: float,
                 trace_id: str) -> None:
        with self._lock:
            win = self._windows.get((tenant, k))
            if win is None:
                win = self._windows[(tenant, k)] = _Window(
                    self.config.window)
            win.recalls.append(recall)
            self._verified_total += 1
            self._verdicts.append({
                "ts": round(time.time(), 3), "tenant": tenant, "k": k,
                "recall": round(recall, 4), "trace_id": trace_id})
            n = len(win.recalls)
            hits = sum(win.recalls)
        lo, hi = wilson_interval(hits, n, self.config.z)
        if _spans.enabled():
            reg = _spans.registry()
            labels = {"tenant": tenant, "k": str(k)}
            reg.gauge("quality.recall", labels=labels).set(hits / n)
            reg.gauge("quality.recall_ci_low", labels=labels).set(lo)
            reg.gauge("quality.recall_ci_high", labels=labels).set(hi)
            reg.gauge("quality.samples", labels=labels).set(n)
            reg.inc("quality.verified", labels={"tenant": tenant})
            # the worst-recall exemplars: the loss histogram's upper
            # buckets retain the LARGEST losses with their trace ids
            reg.histogram("quality.recall_loss",
                          labels={"tenant": tenant},
                          buckets=LOSS_BUCKETS).observe(
                              1.0 - recall, exemplar=trace_id)

    def _count_skip(self, tenant: str, reason: str) -> None:
        if _spans.enabled():
            _spans.registry().inc(
                "quality.skipped",
                labels={"tenant": tenant, "reason": reason})

    # -- read side ----------------------------------------------------------
    def recall_summary(self, tenant: str) -> Dict[int, Dict[str, float]]:
        """``{k: {"recall", "ci_low", "ci_high", "n"}}`` for a tenant —
        what the SLO monitor checks recall floors against."""
        with self._lock:
            wins = {kk: list(w.recalls)
                    for (t, kk), w in self._windows.items()
                    if t == tenant and w.recalls}
        out: Dict[int, Dict[str, float]] = {}
        for kk, recs in wins.items():
            n = len(recs)
            lo, hi = wilson_interval(sum(recs), n, self.config.z)
            out[kk] = {"recall": sum(recs) / n, "ci_low": lo,
                       "ci_high": hi, "n": float(n)}
        return out

    def state(self) -> Dict[str, Any]:
        """The flight recorder's ``"quality"`` section: current
        per-tenant/k estimates + the last ≤32 verdicts (trace ids
        included) — a killed serving run keeps its quality evidence."""
        with self._lock:
            verdicts = list(self._verdicts)
            keys = [(t, k) for (t, k), w in self._windows.items()
                    if w.recalls]
            verified = self._verified_total
        tenants: Dict[str, Any] = {}
        for t, k in keys:
            tenants.setdefault(t, {}).update(
                {str(k): self.recall_summary(t).get(k, {})})
        return {"config": {
                    "sample_fraction": self.config.sample_fraction,
                    "rate_limit_per_s": self.config.rate_limit_per_s,
                    "window": self.config.window},
                "verified_total": verified,
                "tenants": tenants,
                "verdicts": verdicts}
