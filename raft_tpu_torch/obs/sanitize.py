"""Runtime sanitizer harness (counterpart of ``raft_tpu.obs.sanitize``).

- :func:`no_host_transfers` — scopes ``torch.cuda.set_sync_debug_mode(
  "error")`` around a hot path: an operation that synchronizes the host
  with the card inside the scope (``.item()``, ``.cpu()``, a
  data-dependent shape such as ``nonzero``) raises instead of silently
  serializing the launch pipeline; the previous mode is restored on exit.
  Prepare inputs on the card before the scope. Without a card it guards
  nothing (there is no transfer to catch).
- :func:`monitored_lock` / :func:`monitored_rlock` /
  :func:`monitored_condition` + :func:`assert_no_lock_cycles` /
  :func:`blocking_region` — in the sanitize lane (``RAFT_TPU_SANITIZE=1``,
  or a :func:`force_lock_tracking` scope) every lock made through these
  factories is an instrumented wrapper that records per-thread acquisition
  order into a process-wide graph with first-witness stacks, so an AB/BA
  inversion raises :class:`LockOrderViolation` even when this run's
  interleaving happened not to deadlock; :func:`blocking_region` brackets
  blocking calls (``queue.get``, ``join``) and
  :func:`assert_no_held_lock_blocking` fails the lane when one ran while a
  monitored lock was held. Off the lane the factories return plain stdlib
  primitives — zero wrapper, zero overhead.

The robust layer's fault plan (``robust.faults``), the tiered prefetch
reader (``neighbors.tiered``) and every ``obs`` registry take their locks
and bracket their blocking calls here.

The JAX package's other guards check XLA programs, and the port has no
counterpart of them: ``apply_sanitize_config`` sets jax's rank-promotion
and NaN-debug flags, which torch does not have; ``recompile_budget`` and
``compile_count`` count jit-cache misses, and the port runs eagerly with
no jit cache; the collective-schedule checker and
``record_comms_schedule`` read a traced jaxpr, and the port's ranks run
as one eager program with no trace to read; ``capacity_report`` and
``assert_billion_safe`` trace with abstract shapes, which the port's
eager code does not do.

Imports only the standard library at import time (torch inside
:func:`no_host_transfers`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import traceback
from typing import Dict, Iterator, List, Optional, Tuple


def sanitize_enabled() -> bool:
    """True when the suite runs in ``RAFT_TPU_SANITIZE=1`` mode (read here,
    not through ``obs.spans.env_flag``: the registries make their locks
    here while ``obs.spans`` may still be importing)."""
    return os.environ.get("RAFT_TPU_SANITIZE", "").strip().lower() not in (
        "", "0", "false", "off", "no")


@contextlib.contextmanager
def no_host_transfers() -> Iterator[None]:
    """Raise on any host–card synchronization inside the scope: the
    counterpart of the JAX package's ``jax.transfer_guard("disallow")``
    scope, over ``torch.cuda.set_sync_debug_mode("error")`` (restored on
    exit). Explicit copies that do not synchronize stay allowed."""
    import torch

    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)



# ---------------------------------------------------------------------------
# lock-order tracker + held-lock-blocking detector — the runtime half of
# the JAX package's graftlint concurrency pass (GL16–GL20)
# ---------------------------------------------------------------------------

class LockOrderViolation(RuntimeError):
    """The process-wide lock acquisition graph contains a cycle — two
    threads CAN deadlock (A→B here, B→A there), even if this run's
    interleaving happened not to. The message carries both witness
    stacks: where each direction of the inversion was first observed."""


class HeldLockBlockingCall(RuntimeError):
    """A blocking call (``queue.get`` / ``Future.result`` / ``join`` /
    HTTP) ran while a monitored registry/server lock was held — every
    other thread needing that lock stalls behind an unbounded wait."""


class _LockTrackerState:
    """One process-wide order graph + violation log. Swapped wholesale
    by :func:`force_lock_tracking` so tests never pollute the CI lane's
    graph."""

    def __init__(self, forced: bool = False):
        self.forced = forced
        # guards the maps below; internal-only and never reachable from
        # a signal handler, so a plain lock is correct here
        self.lock = threading.Lock()
        # (held_name, acquired_name) -> (held_stack, acquire_stack):
        # the FIRST witness of each ordered pair
        self.edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.blocking: List[dict] = []
        self.counts: Dict[str, int] = {}


_tracker = _LockTrackerState()
_held_tls = threading.local()  # .stack: [(lock_name, acquire_stack), ...]


def _lock_count(counter: str) -> None:
    state = _tracker
    with state.lock:
        state.counts[counter] = state.counts.get(counter, 0) + 1


def publish_lock_counters() -> None:
    """Mirror the tracker's counters into ``obs.spans`` as
    ``sanitize.lock.*`` gauges. Deliberately NOT inline with acquisition:
    publishing from inside ``_note_acquired`` would take the counters'
    lock while the just-acquired lock is held. The lane's assertions call
    this instead."""
    from raft_tpu_torch.obs import spans

    for name, value in lock_tracker_counts().items():
        spans.set_value(name, float(value))


def lock_tracking_enabled() -> bool:
    """True when monitored_lock() hands out instrumented wrappers —
    the ``RAFT_TPU_SANITIZE=1`` lane, or a :func:`force_lock_tracking`
    scope (tests)."""
    return _tracker.forced or sanitize_enabled()


def _held_stack() -> list:
    stack = getattr(_held_tls, "stack", None)
    if stack is None:
        stack = _held_tls.stack = []
    return stack


class _MonitoredLock:
    """Instrumented Lock/RLock: records this thread's acquisition order
    into the process-wide graph (with the first witness stack per
    edge). Supports the full lock protocol including the private
    ``Condition`` hooks, so ``threading.Condition(monitored_lock(...))``
    works — ``wait()`` strips the held-stack entries it releases and
    restores them on wakeup."""

    __slots__ = ("name", "reentrant", "_inner", "_owner", "_count")

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0

    # -- lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._count > 0

    def __repr__(self) -> str:
        kind = "RLock" if self.reentrant else "Lock"
        return f"<monitored {kind} {self.name!r} count={self._count}>"

    # -- Condition hooks ----------------------------------------------------
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        # cond.wait(): fully release (all recursion levels) and strip
        # our held-stack bookkeeping — the thread no longer holds it
        stripped = self._strip_held()
        if hasattr(self._inner, "_release_save"):
            return ("rlock", self._inner._release_save(), stripped)
        self._owner, self._count = None, 0
        self._inner.release()
        return ("lock", None, stripped)

    def _acquire_restore(self, saved) -> None:
        kind, inner_state, stripped = saved
        if kind == "rlock":
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        for _ in range(stripped):
            self._note_acquired()

    # -- bookkeeping --------------------------------------------------------
    def _note_acquired(self) -> None:
        self._owner = threading.get_ident()
        self._count += 1
        stack = _held_stack()
        here = "".join(traceback.format_stack(limit=10)[:-1])
        state = _tracker
        for held_name, held_at in stack:
            if held_name == self.name:
                continue  # reentrant re-acquire is not an ordering
            key = (held_name, self.name)
            with state.lock:
                if key not in state.edges:
                    state.edges[key] = (held_at, here)
        stack.append((self.name, here))
        _lock_count("sanitize.lock.acquire")

    def _note_released(self) -> None:
        self._count -= 1
        if self._count <= 0:
            self._owner, self._count = None, 0
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == self.name:
                del stack[i]
                break

    def _strip_held(self) -> int:
        stack = _held_stack()
        n = len([e for e in stack if e[0] == self.name])
        stack[:] = [e for e in stack if e[0] != self.name]
        self._owner, self._count = None, 0
        return n


def monitored_lock(name: str):
    """A ``threading.Lock`` for ``name`` — instrumented for lock-order
    tracking when the sanitize lane is on, a plain stdlib lock (zero
    overhead, no wrapper) otherwise. ``name`` is the node in the order
    graph: name the SITE (``"serve.registry"``), not the instance —
    every registry instance contends on the same ordering discipline."""
    if lock_tracking_enabled():
        return _MonitoredLock(name, reentrant=False)
    return threading.Lock()


def monitored_rlock(name: str):
    """Reentrant variant of :func:`monitored_lock` — the required kind
    on any path a signal handler can reach (graftlint GL19)."""
    if lock_tracking_enabled():
        return _MonitoredLock(name, reentrant=True)
    return threading.RLock()


def monitored_condition(name: str):
    """A ``threading.Condition`` whose underlying lock is monitored —
    waiters strip their held-stack entries while blocked in ``wait()``
    and restore them on wakeup, so a parked batcher thread never reads
    as 'holding' its lock."""
    if lock_tracking_enabled():
        return threading.Condition(_MonitoredLock(name, reentrant=True))
    return threading.Condition()


@contextlib.contextmanager
def blocking_region(kind: str) -> Iterator[None]:
    """Bracket a blocking call (``queue.get`` / ``Future.result`` /
    ``join`` / HTTP) so the held-lock-blocking detector can flag it
    when any monitored lock is held by this thread. No-op (one TLS
    read) outside the sanitize lane."""
    held = [name for name, _ in getattr(_held_tls, "stack", ())]
    if held:
        entry = {
            "call": kind,
            "held": held,
            "stack": "".join(traceback.format_stack(limit=10)[:-1]),
        }
        state = _tracker
        with state.lock:
            state.blocking.append(entry)
        _lock_count("sanitize.lock.blocked_while_held")
    yield


def lock_order_edges() -> Dict[Tuple[str, str], Tuple[str, str]]:
    """Snapshot of the observed order graph: ``(held, acquired) →
    (held_stack, acquire_stack)`` first witnesses."""
    state = _tracker
    with state.lock:
        return dict(state.edges)


def held_lock_blocking_violations() -> List[dict]:
    state = _tracker
    with state.lock:
        return list(state.blocking)


def lock_tracker_counts() -> Dict[str, int]:
    state = _tracker
    with state.lock:
        return dict(state.counts)


def reset_lock_tracker() -> None:
    """Clear the order graph, blocking log, and counters (call with no
    monitored locks held — between tests, not mid-flight)."""
    state = _tracker
    with state.lock:
        state.edges.clear()
        state.blocking.clear()
        state.counts.clear()


@contextlib.contextmanager
def force_lock_tracking() -> Iterator[None]:
    """Enable lock tracking inside the scope regardless of the env flag
    and swap in a FRESH tracker state — tests assert on exactly the
    edges their own locks produced, and a seeded-deadlock negative
    control never leaks its cycle into the CI lane's graph. Locks must
    be CREATED inside the scope to be instrumented."""
    global _tracker
    prev = _tracker
    _tracker = _LockTrackerState(forced=True)
    try:
        yield
    finally:
        _tracker = prev


def assert_no_lock_cycles() -> None:
    """Raise :class:`LockOrderViolation` when the observed acquisition
    graph has a cycle — the AB/BA (or longer) inversion that CAN
    deadlock under the right interleaving even if this run survived.
    The error carries one full witness pair per edge of the cycle."""
    publish_lock_counters()
    edges = lock_order_edges()
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    # iterative DFS, white/grey/black
    color: Dict[str, int] = {}
    parent: Dict[str, str] = {}

    def cycle_from(start: str) -> Optional[List[str]]:
        stack = [(start, iter(adj.get(start, ())))]
        color[start] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color.get(nxt, 0) == 1:
                    path = [nxt, node]
                    cur = node
                    while cur != nxt:
                        cur = parent[cur]
                        path.append(cur)
                    path.reverse()
                    return path
                if color.get(nxt, 0) == 0:
                    color[nxt] = 1
                    parent[nxt] = node
                    stack.append((nxt, iter(adj.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                stack.pop()
        return None

    for start in list(adj):
        if color.get(start, 0) == 0:
            path = cycle_from(start)
            if path is not None:
                _lock_count("sanitize.lock.cycle")
                lines = [
                    "lock-order cycle: " + " -> ".join(path),
                    "",
                ]
                for a, b in zip(path, path[1:]):
                    held_at, got_at = edges[(a, b)]
                    lines += [
                        f"edge {a} -> {b}:",
                        f"  {a} held at:",
                        *("    " + ln for ln in held_at.splitlines()),
                        f"  {b} acquired at:",
                        *("    " + ln for ln in got_at.splitlines()),
                        "",
                    ]
                raise LockOrderViolation("\n".join(lines))


def assert_no_held_lock_blocking() -> None:
    """Raise :class:`HeldLockBlockingCall` when any blocking call ran
    while a monitored lock was held (see :func:`blocking_region`)."""
    publish_lock_counters()
    violations = held_lock_blocking_violations()
    if violations:
        lines = [f"{len(violations)} blocking call(s) while holding a "
                 "monitored lock:", ""]
        for v in violations:
            lines += [
                f"{v['call']} while holding {v['held']}:",
                *("  " + ln for ln in v["stack"].splitlines()),
                "",
            ]
        raise HeldLockBlockingCall("\n".join(lines))
