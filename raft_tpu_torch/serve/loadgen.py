"""Open-loop load generator — real latency-vs-throughput curves
(counterpart of ``raft_tpu.serve.loadgen``; the same arrival schedule for
one seed, rows and record).

A closed-loop client (send → wait → send) can never overload a server:
its arrival rate collapses to the service rate and the latency curve
flat-lines exactly where production pain begins (coordinated omission).
This generator is **open-loop**: arrivals follow a Poisson process at the
OFFERED rate (``random.Random(seed).expovariate``) regardless of
completions, so queueing delay, shedding, and deadline misses show up at
the rates they would in production.

:func:`run_step` drives one offered-load step and returns a bench-shaped
row: achieved qps, p50/p99 latency (from the histogram-quantile
machinery of :mod:`raft_tpu_torch.obs.metrics`), shed/miss/error counts.
:func:`sweep` walks a ladder of offered loads into the
latency-vs-throughput curve, and :func:`record` wraps rows with
environment provenance (``bench.runner.environment_stamp()``: the card's
name and power limit, torch and CUDA versions, the host's CPU count) so a
record names the hardware it was measured on.
"""

from __future__ import annotations

import random
import subprocess
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.obs import cost as _cost
from raft_tpu_torch.obs.metrics import Histogram, exemplars_for_quantile
from raft_tpu_torch.robust.retry import DeadlineExceeded
from raft_tpu_torch.serve.errors import ShedError
from raft_tpu_torch.serve.server import MicroBatchServer, _LATENCY_BUCKETS

__all__ = ["run_step", "sweep", "record"]


def _git_commit() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=__file__.rsplit("/", 3)[0]).stdout.strip() or None
    except Exception:
        return None


def run_step(server: MicroBatchServer, tenant: str,
             queries: np.ndarray, k: int,
             offered_qps: float, duration_s: float,
             seed: int = 0,
             slo_s: Optional[float] = -1.0,
             ground_truth: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """One offered-load step: submit single-query requests at Poisson
    arrivals of rate ``offered_qps`` for ``duration_s`` seconds (query
    vectors cycled from ``queries``), then wait for every future and
    tally. The arrival clock never waits on completions — that is the
    point.

    ``ground_truth`` (optional, ``[n_queries, ≥k]`` exact neighbor ids
    per query row) turns the step's quality column on: every
    completed request's served ids are scored against the truth row and
    the step reports mean ``recall`` — so a latency-vs-throughput curve
    that cheats (sheds into a degraded rung trading recall for speed)
    can no longer look like a win."""
    rng = random.Random(seed)
    n = queries.shape[0]
    lat = Histogram("loadgen.latency_s", buckets=_LATENCY_BUCKETS)
    sent = shed = missed = errors = 0
    shed_reasons: Dict[str, int] = {}
    inflight: List[Tuple[float, Future, int]] = []
    # completion times captured by done-callbacks (fired by the
    # batcher thread the moment the future resolves): the drain loop
    # below must not masquerade its own pace as request latency
    done_at: Dict[int, float] = {}

    def _mark_done(fut: Future) -> None:
        done_at[id(fut)] = time.monotonic()

    # cost attribution: bracket the step with ledger reads
    # so the row reports the device time THIS step's traffic consumed
    # (per-tenant delta) and the tenant's fleet share at step end —
    # None when no ledger is installed (old records join unchanged)
    ledger = _cost.get_ledger()
    device_s0 = (ledger.device_seconds().get(tenant, 0.0)
                 if ledger is not None else 0.0)

    t_start = time.monotonic()
    next_arrival = t_start
    deadline_end = t_start + duration_s
    i = 0
    while True:
        now = time.monotonic()
        if now >= deadline_end:
            break
        if now < next_arrival:
            time.sleep(min(next_arrival - now, deadline_end - now))
            continue
        # schedule the NEXT arrival off the schedule, not off "now":
        # submit() overhead must not thin the offered rate
        next_arrival += rng.expovariate(offered_qps)
        sent += 1
        t_submit = time.monotonic()
        try:
            fut = server.submit(tenant, queries[i % n], k, slo_s=slo_s)
        except ShedError as e:
            shed += 1
            shed_reasons[e.reason] = shed_reasons.get(e.reason, 0) + 1
        else:
            fut.add_done_callback(_mark_done)
            inflight.append((t_submit, fut, i % n))
        i += 1
    ok = 0
    recall_sum = 0.0
    recall_n = 0
    t_last_done = t_start
    for t_submit, fut, qi in inflight:
        try:
            _, served_ids = fut.result(timeout=30.0)
        except DeadlineExceeded:
            missed += 1
        except ShedError as e:
            shed += 1
            shed_reasons[e.reason] = shed_reasons.get(e.reason, 0) + 1
        except Exception:
            errors += 1
        else:
            ok += 1
            if ground_truth is not None:
                from raft_tpu_torch.obs.quality import recall_at_k

                recall_sum += recall_at_k(np.asarray(served_ids),
                                          ground_truth[qi], k)
                recall_n += 1
            t_done = done_at.get(id(fut), time.monotonic())
            t_last_done = max(t_last_done, t_done)
            # the future knows its request's trace id (stamped by
            # submit): the step's latency histogram retains the slowest
            # requests' ids as exemplars, so a regressed baseline names
            # reproducible offender requests
            lat.observe(t_done - t_submit,
                        exemplar=getattr(fut, "trace_id", None))
    # achieved rate over the window that actually served: arrivals
    # stopped at duration_s but queued work drains past it
    wall = max(t_last_done, deadline_end) - t_start
    slow = exemplars_for_quantile(lat.state(), 0.99)
    device_s = cost_share = None
    if ledger is not None:
        device_s = round(ledger.device_seconds().get(tenant, 0.0)
                         - device_s0, 6)
        cost_share = round(ledger.shares().get(tenant, 0.0), 6)
    return {
        "offered_qps": offered_qps,
        "duration_s": round(wall, 4),
        "sent": sent,
        "completed": ok,
        "shed": shed,
        "shed_reasons": shed_reasons,
        "deadline_missed": missed,
        "errors": errors,
        "qps": round(ok / wall, 2) if wall > 0 else 0.0,
        "latency_p50_s": lat.quantile(0.5),
        "latency_p99_s": lat.quantile(0.99),
        "latency_mean_s": (lat.sum / lat.count) if lat.count else None,
        # measured quality (None without ground truth): mean recall@k
        # over the completed requests of this step
        "recall": (round(recall_sum / recall_n, 6)
                   if recall_n else None),
        # per-step cost columns (None without a ledger):
        # device seconds this step's traffic consumed, and the
        # tenant's normalized fleet share at step end
        "device_s": device_s,
        "cost_share": cost_share,
        # the p99 bucket's worst offenders, worst first — joinable back
        # to their timelines via obsdump --slowest on the server's dump
        "slow_trace_ids": [e["trace_id"] for e in slow],
    }


def sweep(server: MicroBatchServer, tenant: str, queries: np.ndarray,
          k: int, offered_steps: Sequence[float],
          duration_s: float = 2.0, seed: int = 0,
          slo_s: Optional[float] = -1.0,
          ground_truth: Optional[np.ndarray] = None
          ) -> List[Dict[str, Any]]:
    """The latency-vs-throughput curve: one :func:`run_step` per
    offered load, in order (each step inherits the previous step's
    thermal/queue state the way a ramping production load would)."""
    return [run_step(server, tenant, queries, k, q, duration_s,
                     seed=seed + j, slo_s=slo_s,
                     ground_truth=ground_truth)
            for j, q in enumerate(offered_steps)]


def record(rows: List[Dict[str, Any]], dataset: str, tenant: str,
           k: int, note: str = "") -> Dict[str, Any]:
    """Wrap sweep rows as a benchdiff-joinable record: each row keyed
    by (dataset, algo="serve", index=tenant, search_param={offered_qps,
    k}, batch_size=1) and stamped with ``measured_at`` / ``git_commit``
    / environment provenance — the same self-stamping protocol every
    recorded perf row in the tree follows."""
    from raft_tpu_torch.bench import runner as _runner

    env = _runner.environment_stamp()
    measured_at = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    commit = _git_commit()
    detail = []
    for r in rows:
        detail.append({
            "dataset": dataset, "algo": "serve", "index": tenant,
            "search_param": {"offered_qps": r["offered_qps"], "k": k},
            "batch_size": 1,
            "qps": r["qps"], "recall": r.get("recall"),
            "latency_p50_s": r["latency_p50_s"],
            "latency_p99_s": r["latency_p99_s"],
            "sent": r["sent"], "completed": r["completed"],
            "shed": r["shed"], "shed_reasons": r["shed_reasons"],
            "deadline_missed": r["deadline_missed"],
            "errors": r["errors"],
            # optional cost columns: absent-tolerant on the
            # benchdiff join so pre-ledger records stay comparable
            "device_s": r.get("device_s"),
            "cost_share": r.get("cost_share"),
            "slow_trace_ids": r.get("slow_trace_ids", []),
            "measured_at": measured_at, "git_commit": commit,
            "env": env,
        })
    best = max((d["qps"] for d in detail), default=0.0)
    # name the offenders: the worst-p99 step's exemplar
    # trace ids ride the record's notes, so a benchdiff regression on
    # this baseline points at reproducible requests, not just a number
    worst = max((d for d in detail if d["latency_p99_s"] is not None),
                key=lambda d: d["latency_p99_s"], default=None)
    notes = note
    if worst is not None and worst.get("slow_trace_ids"):
        tail = (f"worst p99 step offered_qps="
                f"{worst['search_param']['offered_qps']}: "
                f"p99={worst['latency_p99_s']:.4f}s, slow traces "
                + ",".join(worst["slow_trace_ids"]))
        notes = f"{note}; {tail}" if note else tail
    return {
        # the JAX package's name on a CPU run; a card's run says so
        "metric": ("serve_qps_cpu" if env.get("backend") != "cuda"
                   else "serve_qps_gpu"),
        "value": best,
        "unit": "completed requests/s",
        "total_rows": len(detail),
        "baseline_note": notes,
        "detail": detail,
    }
