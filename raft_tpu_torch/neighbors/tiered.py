"""Tiered IVF search — host-resident raw vectors, prefetched under the
re-rank (counterpart of ``raft_tpu.neighbors.tiered``).

An IVF tenant's scan structures (packed codes, centroids, norms) are small
and touched by every query — they stay on the card. Its raw vectors are
~10-30× bigger and touched only at the exact re-rank, for ``k_cand`` rows a
query — they can live in HOST memory (a numpy array or memmap), with only
the candidate rows crossing to the card a batch. This module overlaps that hop
with the re-rank:

- the batch is scanned once (oversampled, ``k_cand`` candidates a
  query); the main thread enqueues a non-blocking copy of the ``[m, C]``
  candidate ids into pinned host memory and records an event
  (:func:`stage_ids`) — it never waits on the card inside the loop;
- the ids are cut into pipeline sub-batches (:func:`pipeline_batch`); a
  :class:`RowPrefetcher` reader thread waits on the event (the
  pipeline's one sync, on the worker), gathers each sub-batch's rows from
  the host base into a pinned staging buffer under the ``IO_POLICY``
  retry (fault point ``serve.row_read``), and copies them to the card
  with ``non_blocking=True`` on a CUDA stream of its own, recording an
  event;
- meanwhile the main thread re-ranks the sub-batch whose rows landed
  (:func:`refine.refine_landed`), its stream first waiting on their
  copy's event (:meth:`Landed.ready`).

The JAX package scans each sub-batch on its own, under the fetch of the
one before. Here one scan of the batch is faster than four of its
quarters (a sub-batch's scan walks nearly every probed list that the
batch's does; PERF.md), and the candidates are the serialized path's by
construction, whatever last bits the library's products give at another
row count.

CUDA details that the JAX package's ``device_put`` hid:

- **Streams are per thread.** The reader copies inside
  ``torch.cuda.stream(side)``; left on the default stream, its copies
  would serialize against the main thread's kernels, silently.
- **Lifetimes.** A landed block is allocated on the side stream and read
  on the consumer's, so :meth:`Landed.ready` calls ``record_stream``; a
  pinned staging buffer is reused only after its copy's event completed
  (a ring of ``PREFETCH_DEPTH + 2`` buffers, each event synchronized by
  the reader before the buffer is written again).
- On CPU tensors (the tests) the reader thread still runs; "landing" is a
  no-op and a block carries no event.

Accounting: ``serve.prefetch.hit{tenant=}`` (rows were already landed when
the consumer asked) vs ``serve.prefetch.stall{tenant=}`` (the consumer
waited; the wait runs under ``span("h2d")``), and
``cost.io_bytes{tenant=}`` for the bytes each gather moves.
``prefetch=False`` fetches inline at each get, every get a stall — the
comparison leg.

Results are BIT-EQUAL to the serialized host gather
(``refine.refine_gathered``): the candidates come from the same scan,
the row gather is the same (clip to [0, n − 1], f32 rows;
``torch.index_select`` over the f32 view of a C-contiguous f32 base, else
numpy's fancy indexing) and the re-rank is the same fixed-block epilogue.

Dispatch: ``SearchParams.refine_transfer`` ("auto" | "tiered" | "serial")
and the ``RAFT_TPU_TIERED_REFINE`` tri-state env override;
:func:`tiered_refine_wanted` is the guard (``ivf_common.
tiered_refine_mem_ok`` bounds the in-flight landed blocks; a decline is a
counted ``degrade.steps`` move to the serialized host gather).
``RAFT_TPU_TIERED_BATCH`` sets the sub-batch size.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.tracing import span
from raft_tpu_torch.neighbors import refine as _refine
from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.robust import degrade as _degrade
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.robust import retry as _retry

__all__ = [
    "RowPrefetcher", "host_row_reader", "pipeline_batch", "stage_ids",
    "Landed", "tiered_refine_wanted", "search_refined_tiered",
    "serving_tenant", "current_tenant", "PREFETCH_DEPTH",
]

#: landed-row blocks the prefetch pipeline may park: the done-queue
#: depth. One being consumed + ``PREFETCH_DEPTH`` parked is the device
#: bound ``ivf_common.tiered_refine_mem_ok`` sizes against.
PREFETCH_DEPTH = 2

# Per-thread serving-tenant attribution for the prefetch counters.
_tenant_tls = threading.local()


class serving_tenant:
    """Context manager naming the tenant whose dispatch brackets this
    thread's tiered searches (``None``/missing → ``"-"``)."""

    __slots__ = ("_name", "_prev")

    def __init__(self, name: Optional[str]):
        self._name = name
        self._prev = None

    def __enter__(self) -> "serving_tenant":
        self._prev = getattr(_tenant_tls, "name", None)
        _tenant_tls.name = self._name
        return self

    def __exit__(self, *exc) -> None:
        _tenant_tls.name = self._prev


def current_tenant() -> str:
    """The tenant label for this thread's prefetch counters."""
    return getattr(_tenant_tls, "name", None) or "-"


def pipeline_batch(m: int) -> int:
    """Pipeline sub-batch size for an ``m``-query search: the explicit
    ``RAFT_TPU_TIERED_BATCH`` when set, else ``max(32, ceil(m/4))`` — at
    least 4 sub-batches on real serving batches, none below 32 queries."""
    raw = os.environ.get("RAFT_TPU_TIERED_BATCH", "")  # int value
    if raw.strip():
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return max(32, -(-int(m) // 4))


class StagedIds(NamedTuple):
    """A sub-batch's candidate ids on their way to the host: a pinned copy
    and the event that marks it complete (None for CPU ids)."""

    ids: torch.Tensor
    event: Optional[Any] = None


def stage_ids(ids: torch.Tensor) -> StagedIds:
    """Enqueue the copy of ``ids`` to pinned host memory without waiting
    (main thread); the reader waits on the returned event."""
    if ids.device.type != "cuda":
        return StagedIds(ids)
    host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
    host.copy_(ids, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(ids.device))
    return StagedIds(host, ev)


def _resolve_ids(candidates) -> np.ndarray:
    if isinstance(candidates, StagedIds):
        if candidates.event is not None:
            candidates.event.synchronize()
        return candidates.ids.numpy()
    return _refine._host_ids(candidates)


class Landed(NamedTuple):
    """A landed ``[m_b, C, d]`` f32 row block: on the card, with the event
    of its copy and the stream it was copied on."""

    rows: torch.Tensor
    event: Optional[Any] = None
    stream: Optional[Any] = None

    def ready(self) -> torch.Tensor:
        """The rows, safe to read on the current stream: it waits on the
        copy's event, and the block is recorded on it so that the
        allocator does not hand the memory back to the side stream while
        the consumer still reads it."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.rows.device)
            cur.wait_event(self.event)
            self.rows.record_stream(cur)
        return self.rows


def host_row_reader(host_base, tenant: str = "-", device="cuda"
                    ) -> Callable[[Any], Landed]:
    """Build the prefetcher's ``fetch_fn`` over a host-resident base:
    ``fetch(candidates [m_b, C] ids) -> Landed`` with the ``[m_b, C, d]``
    f32 rows on ``device``.

    Runs on the reader thread. The ids come as :class:`StagedIds` (it
    waits on their event), a tensor or an array. The gather is
    :func:`refine.refine_gathered`'s, bit for bit (clip to [0, n−1], f32
    rows; ``refine.host_gather_rows``). The host read and the copy retry
    under ``retry.IO_POLICY`` (fault point ``serve.row_read``). On the
    card, ``fetch.stream`` is the side stream the copies run on."""
    n, d = host_base.shape
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    ring: List[list] = [[None, None] for _ in range(PREFETCH_DEPTH + 2)]
    turn = [0]

    def fetch(candidates) -> Landed:
        cand = _resolve_ids(candidates)
        m_b, C = cand.shape

        def attempt() -> Landed:
            _faults.faultpoint("serve.row_read")
            safe = np.clip(cand, 0, n - 1).reshape(-1)
            if not cuda:
                rows = _refine.host_gather_rows(host_base, safe)
                landed = Landed(rows.view(m_b, C, d))
            else:
                slot = ring[turn[0] % len(ring)]
                turn[0] += 1
                if slot[1] is not None:
                    slot[1].synchronize()  # its last copy has finished
                if slot[0] is None or slot[0].numel() < m_b * C * d:
                    slot[0] = torch.empty(m_b * C * d, dtype=torch.float32,
                                          pin_memory=True)
                stage = slot[0][:m_b * C * d].view(m_b * C, d)
                _refine.host_gather_rows(host_base, safe, out=stage)
                with torch.cuda.device(dev), torch.cuda.stream(side):
                    dst = torch.empty((m_b, C, d), dtype=torch.float32,
                                      device=dev)
                    dst.view(m_b * C, d).copy_(stage, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(side)
                slot[1] = ev
                landed = Landed(dst, ev, side)
            # host-tier IO bytes, charged per attempt: a retried read
            # moves the bytes again
            _obs_spans.inc("cost.io_bytes", float(m_b * C * d * 4),
                           tenant=tenant)
            return landed

        return _retry.retry_call(attempt, site="serve.row_read",
                                 policy=_retry.IO_POLICY)

    fetch.stream = side
    return fetch


class RowPrefetcher:
    """Submission-driven host→device candidate-row pipeline.

    A background reader resolves each submitted candidate block through
    ``fetch_fn`` and parks up to ``depth`` landed blocks; :meth:`get`
    returns them in submit order.

    Accounting: ``serve.prefetch.hit{tenant=}`` — the block was already
    landed when requested; ``serve.prefetch.stall{tenant=}`` — the
    consumer had to wait (under ``span("h2d")``). ``prefetch=False``
    fetches inline at each :meth:`get` (every get a stall).

    Error contract: an exception on the reader thread (IO failure past
    the retry budget, an injected fault) is re-raised at the consumer's
    next :meth:`get`; the reader exits after queueing it. :meth:`close` is
    idempotent, drains both queues and joins the thread — safe to call
    mid-stream (the ``finally`` of an interrupted search)."""

    def __init__(self, fetch_fn: Callable[[Any], Any],
                 depth: int = PREFETCH_DEPTH, tenant: str = "-",
                 prefetch: bool = True):
        self._fetch = fetch_fn
        self._tenant = tenant
        self._prefetch = bool(prefetch)
        self._submitted = 0
        self._taken = 0
        self._pending: deque = deque()  # serialized mode: parked ids
        self._work: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self._prefetch:
            self._thread = threading.Thread(
                target=self._run, name="raft_tpu_torch-row-prefetch",
                daemon=True)
            self._thread.start()

    def _count(self, name: str) -> None:
        _obs_spans.inc(name, tenant=self._tenant)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                cand = self._work.get(timeout=0.05)
            except queue.Empty:
                continue
            if cand is None:  # close() sentinel
                return
            try:
                item = (self._fetch(cand), None)
            except BaseException as e:  # propagated at the next get()
                item = (None, e)
            while not self._stop.is_set():
                try:
                    self._done.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            if item[1] is not None:
                return

    def submit(self, candidates) -> None:
        """Queue one sub-batch's candidate ids for fetching. Never blocks
        and never syncs."""
        self._submitted += 1
        if not self._prefetch:
            self._pending.append(candidates)
        else:
            self._work.put(candidates)

    def get(self):
        """Next landed block (submit order). Raises the reader's exception
        if its fetch failed; ``IndexError`` when every submitted block was
        already taken."""
        if self._taken >= self._submitted:
            raise IndexError("RowPrefetcher: get() past the last submit")
        if not self._prefetch:
            cand = self._pending.popleft()
            self._count("serve.prefetch.stall")
            with span("h2d"):
                x = self._fetch(cand)
            self._taken += 1
            return x
        # benign race on empty(): a reader mid-put counts as a stall with
        # a ~zero-length wait — the conservative side
        if self._done.empty():
            self._count("serve.prefetch.stall")
            with span("h2d"), _sanitize.blocking_region("queue.get"):
                x, exc = self._done.get()
        else:
            self._count("serve.prefetch.hit")
            with _sanitize.blocking_region("queue.get"):
                x, exc = self._done.get()
        if exc is not None:
            self.close()
            raise exc
        self._taken += 1
        return x

    def close(self) -> None:
        """Stop the reader and release queue slots (idempotent). A reader
        stuck inside a slow retried fetch can outlive the join timeout —
        the handle is kept (and a warning logged) so the still-running
        thread stays visible."""
        self._stop.set()
        for q in (self._work, self._done):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        # wake a reader parked on the empty work queue now, not at its
        # next 50 ms poll: every search closes its prefetcher, and that
        # poll cost a 500-query batch ~50 ms on the card (PERF.md)
        self._work.put(None)
        if self._thread is not None:
            with _sanitize.blocking_region("join"):
                self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                _log.warn("RowPrefetcher.close: reader thread still inside "
                          "a fetch after 5s (slow IO/retry backoff) — it "
                          "will exit at its next stop-flag check")
            else:
                self._thread = None


def tiered_refine_wanted(dataset, m: int, k_cand: int, d: int,
                         params) -> bool:
    """True when the prefetch-overlapped tier serves this refined search:
    a host-resident 2-D base (tensors take the device refine tiers,
    providers regenerate), ``refine_transfer`` not pinned ``"serial"``,
    the ``RAFT_TPU_TIERED_REFINE`` tri-state not off, and — unless forced
    on — at least two pipeline sub-batches. The ``tiered_refine_mem_ok``
    guard bounds the in-flight landed blocks; its decline (or a
    ``tiered.mem_guard`` force fault) is a counted ``degrade.steps`` move
    to the serialized host gather."""
    from raft_tpu_torch.neighbors import ivf_common as ic

    shape = getattr(dataset, "shape", None)
    if (dataset is None or isinstance(dataset, torch.Tensor)
            or hasattr(dataset, "_block") or shape is None
            or len(shape) != 2):
        return False
    transfer = getattr(params, "refine_transfer", "auto")
    if transfer == "serial":
        return False
    env = _obs_spans.env_tristate("RAFT_TPU_TIERED_REFINE")
    if env == "off":
        return False
    forced_on = transfer == "tiered" or env == "on"
    mb = pipeline_batch(m)
    if not forced_on and m <= mb:
        return False  # a single sub-batch cannot overlap anything
    mem_ok = ic.tiered_refine_mem_ok(min(mb, m), k_cand, d)
    if _faults.forced("tiered.mem_guard"):  # CI-testable decline path
        mem_ok = False
    if not mem_ok:
        _degrade.note_step("refine", "tiered_prefetch", "host_gather",
                           "mem_guard")
        return False
    return True


def search_refined_tiered(search_fn, index, queries: torch.Tensor, k: int,
                          k_cand: int, scan_params, filter_bitset,
                          host_base, metric: str, prefetch: bool = True,
                          device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiered refined search: one oversampled scan of the batch, then
    pipeline sub-batches through candidate-row prefetch → exact re-rank,
    the host fetch of sub-batch *i+1* overlapped under *i*'s copy and
    re-rank. Returns ``(distances [m, k], ids [m, k])``, bit-equal to the
    serialized host gather (module doc).

    ``search_fn`` is the owning module's ``search`` (ivf_pq / ivf_flat),
    called with ``scan_params`` (refine already stripped);
    ``prefetch=False`` fetches each sub-batch inline — same results."""
    dev = resolve_device(device)
    m = queries.shape[0]
    mb = pipeline_batch(m)
    tenant = current_tenant()
    _, ids = search_fn(index, queries, k_cand, scan_params, filter_bitset,
                       device=dev)
    staged = stage_ids(ids)
    starts = range(0, m, mb)
    pf = RowPrefetcher(host_row_reader(host_base, tenant=tenant, device=dev),
                       depth=PREFETCH_DEPTH, tenant=tenant,
                       prefetch=prefetch)
    outs = []
    try:
        for a in starts:
            pf.submit(StagedIds(staged.ids[a:a + mb], staged.event))
        for a in starts:
            rows = pf.get().ready()
            outs.append(_refine.refine_landed(
                rows, queries[a:a + mb], ids[a:a + mb], k, metric=metric,
                device=dev))
    finally:
        pf.close()
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
