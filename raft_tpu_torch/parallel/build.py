"""Chunked, resumable distributed index builds from host memory
(counterpart of ``raft_tpu.parallel.build``).

The build of a base too large for one device (BASELINE.md target 5,
SIFT-1B), shard-parallel over the ranks of a mesh, step for step as the
JAX package builds it:

- **quantizers trained once, replicated**: the same train sample, trainer
  (``ivf_pq._train_quantizers``, ``kmeans_balanced.fit``) and seeds as
  the single-device ``ivf_pq.build_chunked``, so the distributed build,
  assembled (:func:`assemble_ivf_pq`), equals ``build_chunked`` bit for
  bit. Each shard reads the sample rows it owns and ONE ``allgatherv``
  (:func:`gather_trainset_rows`) replicates them in global row order.
  ``coarse="distributed"`` trades that parity for the distributed Lloyd
  (``cluster.distributed.fit``) over the sharded sample;
- **assignment and encode shard by shard**: each shard walks only its
  contiguous slice ``[rank·shard_rows, …)`` in chunks through a
  :class:`ChunkPrefetcher` (chunk N+1 is read while chunk N is labelled
  or encoded; reads retry under ``robust.retry.IO_POLICY`` at
  ``build.chunk_read``). The chunks line up with ``build_chunked``'s when
  ``shard_rows`` is a multiple of ``chunk_rows``: the label pass and the
  encode then see the same row blocks, which is what bit-identity on the
  card needs (the library's products give other last bits for other
  shapes);
- **comms are two allgatherv**: the trainset rows and each shard's
  ``[n_lists]`` label histogram (:func:`gather_list_counts`, it sizes the
  global list capacity ``L``). Codes, ids and norms never cross ranks;
- **per-shard output the sharded searchers take directly**: each shard
  packs its lists on the host in global row order (``ivf_common.
  stable_slots``, its cursor chained across chunks); the result is a
  ``parallel.ivf.ShardedIvfPq`` / ``ShardedIvfFlat`` with global ids
  (``rank·shard_rows + local``) and ``global_list_cap = L``;
- **resumable per shard**: with ``checkpoint_dir=`` the quantizers, each
  shard's label pass and one encoded file per (shard, chunk) are written
  under the JAX package's names (``robust.checkpoint``), so a checkpoint
  written by either package is finished by the other.

Layout invariant: shard s packs row g of list l at the slot equal to the
number of shard-s rows of list l before g, so the shards' list prefixes
concatenated in rank order are the single-device pack
(:func:`_assemble_lists`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import ids as _ids
from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.core.device import to_device
from raft_tpu_torch.core.errors import expects, not_ported
from raft_tpu_torch.core.interruptible import cancellation_point
from raft_tpu_torch.core.tracing import span
from raft_tpu_torch.obs import sanitize as _sanitize
from raft_tpu_torch.obs import spans as _obs_spans
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.parallel.mesh import Mesh, replicate
from raft_tpu_torch.robust import degrade as _degrade
from raft_tpu_torch.robust import faults as _faults
from raft_tpu_torch.robust import retry as _retry


# ---------------------------------------------------------------------------
# the chunk prefetcher
# ---------------------------------------------------------------------------

class ChunkPrefetcher:
    """Double-buffered chunk pipeline: a reader thread walks ``ranges`` in
    order, calling ``read_fn(lo, hi)`` and parking up to ``depth``
    finished chunks in a bounded queue, so :meth:`get` hands out chunk N
    while chunk N+1 is read.

    With a CUDA ``device`` the reader runs ``read_fn`` on a CUDA stream of
    its own — its copy to the card, or the generation of a provider that
    makes rows on the card (``bench.dataset.DeviceSyntheticChunks``) —
    and records an event after it; :meth:`get` makes the consumer's
    current stream wait on that event and records the chunk's use on that
    stream (``record_stream``), so its memory is not reused early.

    Counters (always on, ``obs.spans``): ``build.prefetch.hit{site=}``
    when the chunk was ready, ``build.prefetch.stall{site=}`` when the
    consumer had to wait; the wait runs under ``span("h2d")``, so only
    the un-hidden read time lands in ``span.<entry>.h2d``.
    ``prefetch=False`` reads inline at each :meth:`get` (every get a
    stall, under the same span).

    An exception in ``read_fn`` (an IO error past the retry budget, an
    injected fault, a CUDA error — never retried) is raised by the next
    :meth:`get`; the reader stops after it. A failed read is never
    replaced by another path. :meth:`close` is idempotent, drains the
    queue and joins the thread."""

    def __init__(self, read_fn: Callable[[int, int], object],
                 ranges: Sequence[Tuple[int, int]], depth: int = 2,
                 prefetch: bool = True, counter_site: str = "build",
                 device=None):
        self._read = read_fn
        self._ranges = list(ranges)
        self._site = counter_site
        self._prefetch = bool(prefetch) and len(self._ranges) > 0
        self._taken = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        dev = None if device is None else torch.device(device)
        self._dev = dev
        self._stream = (torch.cuda.Stream(dev) if self._prefetch
                        and dev is not None and dev.type == "cuda" else None)
        if self._prefetch:
            self._thread = threading.Thread(
                target=self._run, name="raft_tpu-chunk-prefetch",
                daemon=True)
            self._thread.start()

    def __len__(self) -> int:
        return len(self._ranges)

    def _count(self, name: str) -> None:
        _obs_spans.inc(name, site=self._site)

    def _read_one(self, a: int, b: int):
        if self._stream is None:
            return self._read(a, b), None
        with torch.cuda.stream(self._stream):
            x = self._read(a, b)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return x, ev

    def _run(self) -> None:
        for i, (a, b) in enumerate(self._ranges):
            if self._stop.is_set():
                return
            try:
                x, ev = self._read_one(a, b)
                item = (i, x, ev, None)
            except BaseException as e:  # handed to the next get()
                item = (i, None, None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            if item[3] is not None:
                return

    def get(self):
        """The next chunk (in ``ranges`` order), ready to use on the
        caller's current stream. Raises the reader's exception if its read
        failed; ``IndexError`` past the end."""
        if self._taken >= len(self._ranges):
            raise IndexError("ChunkPrefetcher exhausted")
        if not self._prefetch:
            a, b = self._ranges[self._taken]
            self._count("build.prefetch.stall")
            with span("h2d"):
                x = self._read(a, b)
            self._taken += 1
            return x
        # a reader mid-put counts as a stall with a near-zero wait
        if self._q.empty():
            self._count("build.prefetch.stall")
            with span("h2d"), _sanitize.blocking_region("queue.get"):
                _, x, ev, exc = self._q.get()
        else:
            self._count("build.prefetch.hit")
            with _sanitize.blocking_region("queue.get"):
                _, x, ev, exc = self._q.get()
        if exc is not None:
            self.close()
            raise exc
        if ev is not None:
            cur = torch.cuda.current_stream(self._dev)
            cur.wait_event(ev)
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(cur)
        self._taken += 1
        return x

    def close(self) -> None:
        """Stop the reader and release the queue (idempotent). A reader
        inside a slow retried read can outlive the join: the handle is
        kept and a warning says so."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread is not None:
            with _sanitize.blocking_region("join"):
                self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                _log.warn("ChunkPrefetcher.close: reader thread still "
                          "inside a read after 5s (slow IO/retry backoff) "
                          "— it will exit at its next stop-flag check")
            else:
                self._thread = None


# ---------------------------------------------------------------------------
# shard geometry and the two allgatherv
# ---------------------------------------------------------------------------

def shard_ranges(n: int, n_dev: int) -> Tuple[List[Tuple[int, int]], int]:
    """Contiguous per-shard row ranges ``[(lo, hi), ...]`` and the padded
    per-shard row count ``shard_rows = ceil(n / n_dev)`` (the global-id
    base ``rank · shard_rows + local``). Tail shards past the row count
    are empty (lo == hi)."""
    shard_n = -(-n // n_dev)
    return ([(min(n, s * shard_n), min(n, (s + 1) * shard_n))
             for s in range(n_dev)], shard_n)


def _chunk_ranges(lo: int, hi: int, chunk_rows: int) -> List[Tuple[int, int]]:
    return [(a, min(hi, a + chunk_rows)) for a in range(lo, hi, chunk_rows)]


def gather_trainset_rows(stacked: Sequence[torch.Tensor], counts: Sequence,
                         n_rows: int, mesh: Mesh, axis: str = "shard"
                         ) -> List[torch.Tensor]:
    """Replicate the cross-shard train sample with ONE ``allgatherv``:
    rank r gives its owned sample rows ``stacked[r] [cap, d]`` (zero
    rows past ``counts[r]``). The valid rows land first in rank order —
    the sample in global row order, because the sample indices are sorted
    and the shards partition the rows in rank order — cut to ``n_rows``.
    Returns the sample per rank (one tensor per device)."""
    comms = Comms(mesh, axis)
    with span("comms.allgatherv", labels={"op": "allgatherv",
                                          "axis": axis}) as sp:
        g, _ = comms.allgatherv(stacked, counts, compact=True)
        out = [t[:n_rows] for t in g]
        sp.attach(out[0])
    return out


def gather_list_counts(local_counts, mesh: Mesh, axis: str = "shard"
                       ) -> torch.Tensor:
    """The build's one post-train collective: each shard's ``[n_lists]``
    label histogram as one ``allgatherv`` row; returns the ``[n_dev,
    n_lists]`` int32 table on rank 0's device."""
    comms = Comms(mesh, axis)
    c = np.asarray(local_counts)
    rows = [torch.as_tensor(c[r:r + 1].astype(np.int32),
                            device=mesh.devices[r]) for r in range(mesh.size)]
    ones = [torch.tensor(1, dtype=torch.int32, device=d)
            for d in mesh.devices]
    with span("comms.allgatherv", labels={"op": "allgatherv",
                                          "axis": axis}) as sp:
        g, _ = comms.allgatherv(rows, ones, compact=False)
        sp.attach(g[0])
    return g[0]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _count_resume(site: str, name: str, value: float = 1.0) -> None:
    _obs_spans.inc(name, value, site=site)


def _read_rows(dataset, idx_or_slice, site: str):
    """One read under the shared IO retry policy and fault point — the
    contract of ``build_chunked``'s reads. A provider's rows come back as
    its tensor, a host dataset's as float32 numpy."""
    def _do():
        _faults.faultpoint(site)
        if hasattr(dataset, "sample_rows") and not isinstance(
                idx_or_slice, slice):
            rows = dataset.sample_rows(idx_or_slice)
        else:
            rows = dataset[idx_or_slice]
        if isinstance(rows, torch.Tensor):
            return rows.float()
        return np.asarray(rows, np.float32)
    return _retry.retry_call(_do, site=site, policy=_retry.IO_POLICY)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12))


def _on_device(rows, dev: torch.device, normalize: bool) -> torch.Tensor:
    """Rows as f32 on ``dev``, cosine rows normalized — what
    ``build_chunked``'s ``on_device`` does."""
    x = (rows.to(dev, torch.float32) if isinstance(rows, torch.Tensor)
         else to_device(np.asarray(rows, np.float32), dev))
    return _normalize(x) if normalize else x


def _make_read_chunk(dataset, normalize: bool, dev: torch.device):
    """``read_fn(a, b)`` for the prefetcher: a retried read of rows [a, b)
    as f32 on ``dev`` — bit for bit ``build_chunked``'s chunk read."""
    def read_chunk(a, b):
        return _on_device(_read_rows(dataset, slice(a, b),
                                     "build.chunk_read"), dev, normalize)
    return read_chunk


def _owned_sample(dataset, tr_idx: np.ndarray,
                  ranges: Sequence[Tuple[int, int]], mesh: Mesh
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each shard's owned sample rows on its device, zero-padded to the
    fattest shard's count, and the counts (0-d int32). Reads retry at
    ``build.train_sample``."""
    d = dataset.shape[1]
    owned = [tr_idx[(tr_idx >= lo) & (tr_idx < hi)] for lo, hi in ranges]
    cap = max(1, max(len(o) for o in owned))
    stacked, counts = [], []
    for s, o in enumerate(owned):
        dev = mesh.devices[s]
        x = torch.zeros((cap, d), dtype=torch.float32, device=dev)
        if len(o):
            x[:len(o)] = _on_device(_read_rows(dataset, o,
                                               "build.train_sample"), dev,
                                    False)
        stacked.append(x)
        counts.append(torch.tensor(len(o), dtype=torch.int32, device=dev))
    return stacked, counts


def _gather_trainset(dataset, tr_idx: np.ndarray,
                     ranges: Sequence[Tuple[int, int]], mesh: Mesh,
                     axis: str, normalize: bool) -> torch.Tensor:
    """Each shard reads the sample rows it owns, one allgatherv replicates
    them; cosine rows are normalized once on the whole sample, as the
    single-device trainer does. Returns rank 0's copy."""
    stacked, counts = _owned_sample(dataset, tr_idx, ranges, mesh)
    tr = gather_trainset_rows(stacked, counts, len(tr_idx), mesh, axis)[0]
    del stacked
    return _normalize(tr) if normalize else tr


def _coarse_distributed(dataset, tr_idx: np.ndarray,
                        ranges: Sequence[Tuple[int, int]], mesh: Mesh,
                        axis: str, n_lists: int, n_iters: int, seed: int,
                        spherical: bool, normalize: bool) -> torch.Tensor:
    """``coarse="distributed"``'s trainer: the distributed Lloyd
    (``cluster.distributed.fit``) over the sharded sample — each shard's
    owned rows stay its own, zero weights mask the pad rows, and only the
    centroid sums cross ranks each step."""
    from raft_tpu_torch.cluster import distributed as dkm
    from raft_tpu_torch.cluster.kmeans import KMeansParams

    stacked, counts = _owned_sample(dataset, tr_idx, ranges, mesh)
    dev0 = mesh.devices[0]
    cap = stacked[0].shape[0]
    x_flat = torch.cat([x.to(dev0) for x in stacked])
    if normalize:
        x_flat = _normalize(x_flat)
    cnt = torch.stack([c.to(dev0) for c in counts])
    w = (torch.arange(cap, device=dev0)[None, :] < cnt[:, None]).reshape(-1)
    kmp = KMeansParams(n_clusters=n_lists, max_iter=n_iters, seed=seed)
    centers, _, _ = dkm.fit(kmp, x_flat, mesh, axis=axis,
                            weights=w.float())
    if spherical:
        centers = _normalize(centers)
    return centers


def _shard_label_pass(dataset, lo: int, hi: int, chunk_rows: int,
                      predict_fn, prefetch: bool, site: str,
                      normalize: bool, dev: torch.device, stage
                      ) -> np.ndarray:
    """One shard's streaming label pass: its slice in chunks through the
    prefetcher, the nearest center of each row under ``span("assign")``."""
    labels = np.empty(hi - lo, np.int32)
    chunks = _chunk_ranges(lo, hi, chunk_rows)
    pf = ChunkPrefetcher(_make_read_chunk(dataset, normalize, dev), chunks,
                         prefetch=prefetch, counter_site=site, device=dev)
    try:
        for a, b in chunks:
            cancellation_point()
            with stage("h2d"):
                xb = pf.get()
            with stage("label"), span("assign"):
                labels[a - lo:b - lo] = predict_fn(xb).cpu().numpy()
            del xb
    finally:
        pf.close()
    return labels


def _label_shards(dataset, ranges: Sequence[Tuple[int, int]],
                  chunk_rows: int, centers: Sequence[torch.Tensor], km,
                  prefetch: bool, site: str, normalize: bool, mesh: Mesh,
                  axis: str, stage, n: int, n_lists: int, cap_factor: float,
                  say, on_labels=None) -> Tuple[List[np.ndarray], int, int]:
    """Every shard's label pass against its copy of the centers, then the
    allgatherv of the per-shard list histograms: (labels by shard, L,
    L_shard). ``on_labels(s, labels)`` runs as each shard's pass ends."""
    from raft_tpu_torch.cluster import kmeans_balanced

    labels_by_shard: List[np.ndarray] = []
    local_counts = np.zeros((len(ranges), n_lists), np.int64)
    for s, (lo, hi) in enumerate(ranges):
        c_s = centers[s]
        lb = _shard_label_pass(
            dataset, lo, hi, chunk_rows,
            lambda xb, c_s=c_s: kmeans_balanced.predict(c_s, xb, km),
            prefetch, site, normalize, mesh.devices[s], stage)
        labels_by_shard.append(lb)
        local_counts[s] = np.bincount(lb, minlength=n_lists)
        if on_labels is not None:
            on_labels(s, lb)
        say(f"shard {s}: labeled {hi - lo} rows")
    with stage("exchange"):
        counts_by_shard = gather_list_counts(local_counts, mesh,
                                             axis).cpu().numpy()
    L, L_shard = _list_caps(counts_by_shard, n, n_lists, cap_factor)
    return labels_by_shard, L, L_shard


def _progress_printer(progress: bool):
    """``progress=``'s printer: each line stamped with the seconds since
    the build began."""
    t0 = time.time()

    def say(msg):
        if progress:
            print(f"[build_distributed +{time.time() - t0:7.0f}s] {msg}",
                  flush=True)
    return say


def _list_sizes(labels: np.ndarray, n_lists: int, L_shard: int,
                dev: torch.device) -> torch.Tensor:
    """A shard's list sizes: its rows a list, capped at ``L_shard``."""
    return torch.from_numpy(np.minimum(
        np.bincount(labels, minlength=n_lists), L_shard).astype(
            np.int32)).to(dev)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    from raft_tpu_torch.neighbors import ivf_pq as _pq

    return _pq._upload(a, dev)


def _pack_chunk(lb_h: np.ndarray, cursor: np.ndarray, n_lists: int,
                L_shard: int):
    """Slots of one chunk's rows in its shard's lists: (rows kept, their
    lists, their slots, rows dropped, the advanced cursor)."""
    from raft_tpu_torch.neighbors import ivf_common as ic

    order, sorted_l, slot = (t.numpy() for t in ic.stable_slots(
        torch.from_numpy(lb_h), n_lists, torch.from_numpy(cursor)))
    keep = (slot < L_shard) & (sorted_l < n_lists)
    cursor = np.minimum(cursor + np.bincount(lb_h, minlength=n_lists)[
        :n_lists], L_shard)
    return (order[keep], sorted_l[keep], slot[keep].astype(np.int64),
            int((~keep).sum()), cursor)


def _list_caps(counts_by_shard: np.ndarray, n: int, n_lists: int,
               cap_factor: float) -> Tuple[int, int]:
    """(L, L_shard): the global list capacity the single-device builders
    fit, and the per-shard capacity — large enough that no shard drops a
    row the global capacity keeps, no larger than L."""
    from raft_tpu_torch.neighbors import ivf_common as ic

    counts = counts_by_shard.sum(axis=0)
    avg = max(1, n // n_lists)
    L = ic._fit_list_size(counts, avg, cap_factor)
    L_shard = min(L, ic._lane_round(int(max(1, counts_by_shard.max()))))
    return int(L), int(L_shard)


# ---------------------------------------------------------------------------
# IVF-PQ
# ---------------------------------------------------------------------------

def build_ivf_pq_distributed(dataset, params, mesh: Mesh,
                             axis: str = "shard",
                             chunk_rows: int = 1 << 18,
                             max_train_rows: int = 1 << 21,
                             prefetch: bool = True,
                             coarse: str = "replicated",
                             checkpoint_dir: Optional[str] = None,
                             resume=False, progress: bool = False,
                             stage_seconds: Optional[Dict[str, float]] = None):
    """Distributed chunked IVF-PQ build (see the module docstring; public
    entry ``ivf_pq.build_distributed``). ``dataset``: a host array, a
    memmap or a device-chunk provider. Returns a
    ``parallel.ivf.ShardedIvfPq`` on the mesh's ranks. ``stage_seconds``,
    when given, receives the seconds of each stage (sample, train, h2d —
    the prefetcher's un-hidden waits —, label, exchange, encode, pack,
    upload); timing synchronizes the card at each stage's edges."""
    from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
    from raft_tpu_torch.distance.types import DistanceType, resolve_metric
    from raft_tpu_torch.neighbors import ivf_common as ic
    from raft_tpu_torch.neighbors import ivf_pq as _pq
    from raft_tpu_torch.parallel import merge as _merge
    from raft_tpu_torch.parallel.ivf import ShardedIvfPq
    from raft_tpu_torch.random.rng import RngState
    from raft_tpu_torch.utils import precision as _precision

    site = "ivf_pq.build_distributed"
    _say = _progress_printer(progress)

    _precision.enforce()
    mt = resolve_metric(params.metric)
    expects(params.codebook_kind == "per_subspace",
            "distributed build supports per_subspace codebooks")
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    expects(not params.spill,
            "distributed build does not support spill=True yet (the "
            "spill cascade needs the global histogram mid-pass)")
    expects(coarse in ("replicated", "distributed"),
            "coarse must be 'replicated' or 'distributed' (got %r)", coarse)
    expects(resume in (False, True, "auto"),
            "resume must be False, True, or 'auto' (got %r)", resume)
    expects(not resume or checkpoint_dir is not None,
            "resume=%r needs checkpoint_dir=", resume)
    if _merge.resolve_exchange(mesh, axis)[0] != mesh.size:
        raise not_ported("the distributed chunked build over one axis of "
                         "a 2-D mesh", "A15")
    n, dim = dataset.shape
    n_dev = mesh.size
    dev0 = mesh.devices[0]
    ranges, shard_n = shard_ranges(n, n_dev)
    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    normalize = mt == DistanceType.CosineExpanded
    stage = ic.Stages(stage_seconds, dev0, spans=("train", "encode_pack"))

    pq_dim = params.pq_dim or _pq._default_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    K = 1 << params.pq_bits
    km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric="cosine" if spherical else "l2",
                              seed=params.seed)

    # the checkpoint: fingerprinted once, validated on resume
    ck = manifest = None
    base_manifest = {}
    if checkpoint_dir is not None:
        from raft_tpu_torch.robust import checkpoint as _ckpt

        ck = _ckpt.BuildCheckpoint(checkpoint_dir)
        ds_sha, p_sha, fp_s = _ckpt.fingerprints_once(
            dataset, {**dataclasses.asdict(params), "chunk_rows": chunk_rows,
                      "max_train_rows": max_train_rows,
                      "n_shards": n_dev, "coarse": coarse,
                      "build": "distributed"})
        base_manifest = {"dataset_sha": ds_sha, "params_sha": p_sha,
                         "fingerprint_s": round(fp_s, 6),
                         "n": int(n), "dim": int(dim),
                         "chunk_rows": int(chunk_rows),
                         "n_shards": int(n_dev),
                         "shard_rows": int(shard_n)}
        if resume is True or (resume == "auto"
                              and os.path.exists(ck.manifest_path)):
            manifest = ck.load_manifest()
            ck.validate_manifest(manifest, ds_sha, p_sha)
            _count_resume(site, "resume.attempts")
            _say(f"resuming from {ck.manifest_path} (phase "
                 f"{manifest.get('phase')}, shard chunks "
                 f"{manifest.get('shard_chunks_done')})")

    # 1. quantizers: build_chunked's trainer over build_chunked's sample
    if manifest is not None:
        _say("resume: loading quantizer state")
        q = ck.load_arrays("quantizers")
        centers, rotation, centers_rot, codebooks = (
            to_device(q[name], dev0, torch.float32)
            for name in ("centers", "rotation", "centers_rot", "codebooks"))
    else:
        n_train = min(n, max_train_rows,
                      max(params.n_lists * 4, 4 * K,
                          int(n * params.kmeans_trainset_fraction)))
        rng = np.random.default_rng(params.seed)
        tr_idx = np.sort(rng.choice(n, n_train, replace=False))
        state = RngState(params.seed)
        if coarse == "distributed":
            _say(f"distributed coarse fit over the sharded {n_train}-row "
                 "sample")
            with stage("train"):
                centers = _coarse_distributed(
                    dataset, tr_idx, ranges, mesh, axis, params.n_lists,
                    params.kmeans_n_iters, params.seed, spherical,
                    normalize)
                # the codebooks train on the small subsample the trainer
                # would take, against the distributed centers
                stride = max(1, -(-n_train // (1 << 16)))
                cb_sample = _gather_trainset(dataset, tr_idx[::stride],
                                             ranges, mesh, axis, normalize)
                _, rotation, centers_rot, codebooks = _pq._train_quantizers(
                    cb_sample, params, dim, pq_dim, pq_len, K, state, km,
                    centers=centers)
                del cb_sample
        else:
            _say(f"gathering {n_train} train rows (one allgatherv)")
            with stage("sample"):
                trainset = _gather_trainset(dataset, tr_idx, ranges, mesh,
                                            axis, normalize)
            with stage("train"):
                centers, rotation, centers_rot, codebooks = \
                    _pq._train_quantizers(trainset, params, dim, pq_dim,
                                          pq_len, K, state, km)
            del trainset
        if ck is not None:
            ck.save_arrays("quantizers",
                           centers=centers.cpu().numpy(),
                           rotation=rotation.cpu().numpy(),
                           centers_rot=centers_rot.cpu().numpy(),
                           codebooks=codebooks.cpu().numpy())
            ck.write_manifest({**base_manifest, "phase": "label"})
    rep = {name: replicate(v, mesh) for name, v in (
        ("centers", centers), ("centers_rot", centers_rot),
        ("rotation", rotation), ("codebooks", codebooks))}
    _say("quantizers trained; per-shard label pass")

    # 2. per-shard label pass, then the allgatherv of the histograms
    have_labels = (manifest is not None
                   and manifest.get("phase") in ("encode", "done"))
    labels_by_shard: List[np.ndarray] = []
    if have_labels:
        _say("resume: loading per-shard label passes")
        for s, (lo, hi) in enumerate(ranges):
            lb = np.asarray(ck.load_arrays(f"labels_s{s:03d}")["labels"],
                            np.int32)
            expects(lb.shape[0] == hi - lo,
                    "resume label checkpoint for shard %d holds %d rows, "
                    "expected %d", s, lb.shape[0], hi - lo)
            labels_by_shard.append(lb)
        L = int(manifest["L"])
        L_shard = int(manifest["L_shard"])
    else:
        labels_by_shard, L, L_shard = _label_shards(
            dataset, ranges, chunk_rows, rep["centers"], km, prefetch, site,
            normalize, mesh, axis, stage, n, params.n_lists,
            params.list_size_cap_factor, _say,
            on_labels=None if ck is None else (
                lambda s, lb: ck.save_arrays(f"labels_s{s:03d}", labels=lb)))
        if ck is not None:
            ck.write_manifest({**base_manifest, "phase": "encode",
                               "L": L, "L_shard": L_shard,
                               "shard_chunks_done": [0] * n_dev})
    nbytes = _pq.packed_nbytes(pq_dim, params.pq_bits)
    id_dt = torch.empty((), dtype=_ids.id_dtype(n_dev * shard_n)).numpy().dtype

    # 3. per-shard encode and host pack (codes never leave their shard)
    def encode_range(xb, lb, s, lo, hi):
        """Rows [lo, hi) → host (packed codes, norms); a chunk out of
        memory is halved, down to 1024 rows."""
        dev = mesh.devices[s]
        try:
            with stage("encode"), span("encode"):
                codes, norms = _pq._encode_with_norms(
                    xb, rep["rotation"][s], rep["centers_rot"][s], lb,
                    rep["codebooks"][s])
                return (_pq.pack_bits(codes, params.pq_bits).cpu().numpy(),
                        norms.cpu().numpy())
        except Exception as e:
            if not _degrade.is_resource_exhausted(e) or hi - lo <= 1024:
                raise
        _degrade.note_step(site, "chunk", "half_chunk", "resource_exhausted")
        _log.warn("distributed ivf_pq build: RESOURCE_EXHAUSTED encoding "
                  "rows [%d, %d) — halving the chunk", lo, hi)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        mid = (hi - lo) // 2
        c1, n1 = encode_range(xb[:mid], lb[:mid], s, lo, lo + mid)
        c2, n2 = encode_range(xb[mid:], lb[mid:], s, lo + mid, hi)
        return np.concatenate([c1, c2]), np.concatenate([n1, n2])

    chunks_done = (list(manifest.get("shard_chunks_done", [0] * n_dev))
                   if have_labels else [0] * n_dev)
    out = {"packed_codes": [], "packed_ids": [], "packed_norms": [],
           "list_sizes": []}
    dropped = 0
    with stage("encode_pack"):
        for s, (lo, hi) in enumerate(ranges):
            dev = mesh.devices[s]
            labels_s = labels_by_shard[s]
            packed = np.zeros((params.n_lists, L_shard, nbytes), np.uint8)
            ids = np.full((params.n_lists, L_shard), -1, id_dt)
            pnorm = np.zeros((params.n_lists, L_shard), np.float32)
            cursor = np.zeros(params.n_lists, np.int64)
            chunks = _chunk_ranges(lo, hi, chunk_rows)
            # replayed chunks need no device work: they are not read
            pf = ChunkPrefetcher(_make_read_chunk(dataset, normalize, dev),
                                 chunks[chunks_done[s]:], prefetch=prefetch,
                                 counter_site=site, device=dev)
            try:
                for ci, (a, b) in enumerate(chunks):
                    cancellation_point()
                    if ci < chunks_done[s]:
                        shard = ck.load_shard(ci, shard=s)
                        codes_h = np.asarray(shard["codes"], np.uint8)
                        norms_h = np.asarray(shard["norms"], np.float32)
                        expects(codes_h.shape[0] == b - a,
                                "resume shard (%d, chunk %d) holds %d rows, "
                                "expected %d — corrupt checkpoint", s, ci,
                                codes_h.shape[0], b - a)
                        _count_resume(site, "resume.chunks_replayed")
                    else:
                        with stage("h2d"):
                            xb = pf.get()
                        _faults.faultpoint("build.chunk_encode")
                        lb = to_device(labels_s[a - lo:b - lo], dev).clamp(
                            0, params.n_lists - 1)
                        codes_h, norms_h = encode_range(xb, lb, s, a, b)
                        del xb, lb
                        if ck is not None:
                            # the shard file before the manifest naming it
                            ck.save_shard(ci, shard=s, codes=codes_h,
                                          norms=norms_h)
                            done = list(chunks_done)
                            done[s] = ci + 1
                            ck.write_manifest(
                                {**base_manifest, "phase": "encode",
                                 "L": L, "L_shard": L_shard,
                                 "shard_chunks_done": done})
                            chunks_done = done
                    with stage("pack"):
                        rows, ls, sl, n_drop, cursor = _pack_chunk(
                            labels_s[a - lo:b - lo], cursor, params.n_lists,
                            L_shard)
                        dropped += n_drop
                        packed[ls, sl] = codes_h[rows]
                        # global ids: rank·shard_rows + local = a + row
                        ids[ls, sl] = (a + rows).astype(id_dt)
                        pnorm[ls, sl] = norms_h[rows]
            finally:
                pf.close()
            with stage("upload"):
                out["packed_codes"].append(_upload(packed, dev))
                out["packed_ids"].append(_upload(ids, dev))
                out["packed_norms"].append(_upload(pnorm, dev))
                out["list_sizes"].append(
                    _list_sizes(labels_s, params.n_lists, L_shard, dev))
            del packed, ids, pnorm
            _say(f"shard {s}: encoded rows [{lo}, {hi})")
    if ck is not None:
        ck.write_manifest({**base_manifest, "phase": "done", "L": L,
                           "L_shard": L_shard,
                           "shard_chunks_done":
                               [len(_chunk_ranges(lo, hi, chunk_rows))
                                for lo, hi in ranges]})
    _obs_spans.inc("ivf_pq.build.dropped", dropped, site=site)
    if dropped:
        _log.warn("distributed ivf_pq build: dropped %d overflow vectors "
                  "(raise list_size_cap_factor)", dropped)
    return ShardedIvfPq(**rep, **out, mesh=mesh, metric=mt.value,
                        pq_bits=params.pq_bits, pq_dim=pq_dim,
                        shard_rows=shard_n, global_list_cap=L)


# ---------------------------------------------------------------------------
# IVF-Flat (the twin: raw rows instead of codes)
# ---------------------------------------------------------------------------

def build_ivf_flat_distributed(dataset, params, mesh: Mesh,
                               axis: str = "shard",
                               chunk_rows: int = 1 << 18,
                               max_train_rows: int = 1 << 21,
                               prefetch: bool = True,
                               coarse: str = "replicated",
                               progress: bool = False,
                               stage_seconds: Optional[Dict[str, float]]
                               = None):
    """Distributed chunked IVF-Flat build, the raw-vector twin of
    :func:`build_ivf_pq_distributed` (public entry
    ``ivf_flat.build_distributed``): the same shard walk and allgatherv
    comms; each shard packs its raw f32 rows on the host, read by the
    prefetcher without a device round trip (the pack needs none).
    Assembled, it equals ``ivf_flat.build`` while the sample stays under
    ``max_train_rows`` (the single-device build has no cap)."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
    from raft_tpu_torch.distance.types import DistanceType, resolve_metric
    from raft_tpu_torch.neighbors import ivf_common as ic
    from raft_tpu_torch.parallel import merge as _merge
    from raft_tpu_torch.parallel.ivf import ShardedIvfFlat
    from raft_tpu_torch.utils import precision as _precision

    site = "ivf_flat.build_distributed"
    _say = _progress_printer(progress)

    _precision.enforce()
    mt = resolve_metric(params.metric)
    expects(not params.spill,
            "distributed build does not support spill=True yet")
    expects(coarse in ("replicated", "distributed"),
            "coarse must be 'replicated' or 'distributed' (got %r)", coarse)
    if _merge.resolve_exchange(mesh, axis)[0] != mesh.size:
        raise not_ported("the distributed chunked build over one axis of "
                         "a 2-D mesh", "A15")
    n, dim = dataset.shape
    expects(params.n_lists <= n, "n_lists=%d > n=%d", params.n_lists, n)
    n_dev = mesh.size
    dev0 = mesh.devices[0]
    ranges, shard_n = shard_ranges(n, n_dev)
    spherical = mt in (DistanceType.InnerProduct, DistanceType.CosineExpanded)
    km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric="cosine" if spherical else "l2",
                              seed=params.seed)
    stage = ic.Stages(stage_seconds, dev0, spans=("train", "encode_pack"))

    # 1. coarse centers: ivf_flat.build's sample and trainer
    n_train = min(n, max_train_rows,
                  max(params.n_lists * 4,
                      int(n * params.kmeans_trainset_fraction)))
    rng = np.random.default_rng(params.seed)
    tr_idx = (np.sort(rng.choice(n, n_train, replace=False))
              if n_train < n else np.arange(n))
    if coarse == "distributed":
        _say(f"distributed coarse fit over the sharded {n_train}-row sample")
        with stage("train"):
            centers = _coarse_distributed(
                dataset, tr_idx, ranges, mesh, axis, params.n_lists,
                params.kmeans_n_iters, params.seed, spherical,
                normalize=False)
    else:
        _say(f"gathering {n_train} train rows (one allgatherv)")
        with stage("sample"):
            trainset = _gather_trainset(dataset, tr_idx, ranges, mesh, axis,
                                        normalize=False)
        with stage("train"):
            centers = kmeans_balanced.fit(trainset, params.n_lists, km)
        del trainset
    cs = replicate(centers, mesh)
    _say("coarse centers trained; per-shard label pass")

    # 2. per-shard label pass and the allgatherv of the histograms
    labels_by_shard, L, L_shard = _label_shards(
        dataset, ranges, chunk_rows, cs, km, prefetch, site, False, mesh,
        axis, stage, n, params.n_lists, params.list_size_cap_factor, _say)
    id_dt = torch.empty((), dtype=_ids.id_dtype(n_dev * shard_n)).numpy().dtype

    # 3. per-shard host pack of raw rows; rows never cross ranks
    def read_rows_host(a, b):
        rows = _read_rows(dataset, slice(a, b), "build.chunk_read")
        return (rows.cpu().numpy() if isinstance(rows, torch.Tensor)
                else rows)

    out = {"packed_data": [], "packed_ids": [], "packed_norms": [],
           "list_sizes": []}
    dropped = 0
    with stage("encode_pack"):
        for s, (lo, hi) in enumerate(ranges):
            dev = mesh.devices[s]
            labels_s = labels_by_shard[s]
            packed = np.zeros((params.n_lists, L_shard, dim), np.float32)
            ids = np.full((params.n_lists, L_shard), -1, id_dt)
            cursor = np.zeros(params.n_lists, np.int64)
            chunks = _chunk_ranges(lo, hi, chunk_rows)
            pf = ChunkPrefetcher(read_rows_host, chunks, prefetch=prefetch,
                                 counter_site=site)
            try:
                for a, b in chunks:
                    cancellation_point()
                    with stage("h2d"):
                        rows_h = pf.get()
                    with stage("pack"):
                        rows, ls, sl, n_drop, cursor = _pack_chunk(
                            labels_s[a - lo:b - lo], cursor, params.n_lists,
                            L_shard)
                        dropped += n_drop
                        packed[ls, sl] = rows_h[rows]
                        ids[ls, sl] = (a + rows).astype(id_dt)
            finally:
                pf.close()
            with stage("upload"):
                pd = _upload(packed, dev)
                out["packed_data"].append(pd)
                out["packed_ids"].append(_upload(ids, dev))
                # norms from the packed table, as ivf_flat.build takes them
                out["packed_norms"].append((pd.float() ** 2).sum(-1))
                out["list_sizes"].append(
                    _list_sizes(labels_s, params.n_lists, L_shard, dev))
            del packed, ids
            _say(f"shard {s}: packed rows [{lo}, {hi})")
    _obs_spans.inc("ivf_flat.build.dropped", dropped, site=site)
    if dropped:
        _log.warn("distributed ivf_flat build: dropped %d overflow vectors "
                  "(raise list_size_cap_factor)", dropped)
    return ShardedIvfFlat(centers=cs, **out, mesh=mesh, metric=mt.value,
                          global_list_cap=L)


# ---------------------------------------------------------------------------
# assembly: the bridge to the single-device builders
# ---------------------------------------------------------------------------

def _assemble_lists(sizes: np.ndarray, L_shard: int, L: int):
    """Slot plan of the shards' list prefixes concatenated in rank order:
    ``(shard, list, src_slot, dst_slot)`` index arrays, cut at the global
    capacity ``L`` (the rows a single-device pack drops)."""
    n_dev, n_lists = sizes.shape
    base = np.zeros((n_dev, n_lists), np.int64)
    np.cumsum(sizes[:-1], axis=0, out=base[1:])
    slot = np.arange(L_shard)[None, None, :]
    valid = slot < sizes[:, :, None]
    dst = base[:, :, None] + slot
    keep = valid & (dst < L)
    sh, li, src = np.nonzero(keep)
    return sh, li, src, dst[keep]


def _stacked(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    return np.stack([t.cpu().numpy() for t in tensors])


def assemble_ivf_pq(sharded, cache_reconstruction: str = "never",
                    device=None):
    """A distributed-built ``ShardedIvfPq`` as one single-device
    ``ivf_pq.IvfPqIndex`` on ``device`` (default: rank 0's) — bit for bit
    ``build_chunked`` over the same data and parameters (the module's
    layout invariant). ``cache_reconstruction="always"`` builds the bf16
    cache."""
    from raft_tpu_torch.neighbors import ivf_pq as _pq

    expects(sharded.global_list_cap > 0,
            "assemble needs a distributed-built index (global_list_cap "
            "is unset on hand-assembled shards)")
    dev = (sharded.mesh.devices[0] if device is None
           else torch.device(device))
    L = int(sharded.global_list_cap)
    sizes = _stacked(sharded.list_sizes)
    n_dev, n_lists = sizes.shape
    L_shard = sharded.max_list_size
    sh, li, src, dst = _assemble_lists(sizes, L_shard, L)
    nb = sharded.packed_codes[0].shape[-1]
    packed = np.zeros((n_lists, L, nb), np.uint8)
    ids = np.full((n_lists, L), -1,
                  sharded.packed_ids[0].cpu().numpy().dtype)
    pnorm = np.zeros((n_lists, L), np.float32)
    for s in range(n_dev):
        m = sh == s
        at, frm = (li[m], dst[m]), (li[m], src[m])
        packed[at] = sharded.packed_codes[s].cpu().numpy()[frm]
        ids[at] = sharded.packed_ids[s].cpu().numpy()[frm]
        pnorm[at] = sharded.packed_norms[s].cpu().numpy()[frm]
    index = _pq.IvfPqIndex(
        centers=sharded.centers[0].to(dev),
        centers_rot=sharded.centers_rot[0].to(dev),
        rotation=sharded.rotation[0].to(dev),
        codebooks=sharded.codebooks[0].to(dev),
        packed_codes=_upload(packed, dev), packed_ids=_upload(ids, dev),
        packed_norms=_upload(pnorm, dev),
        list_sizes=torch.from_numpy(np.minimum(sizes.sum(axis=0), L).astype(
            np.int32)).to(dev),
        metric=sharded.metric, codebook_kind="per_subspace",
        pq_bits=sharded.pq_bits, pq_dim_static=sharded.pq_dim)
    if cache_reconstruction == "always":
        index.packed_recon = _pq._build_recon_cache(index)
    return index


def assemble_ivf_flat(sharded, device=None):
    """A distributed-built ``ShardedIvfFlat`` as one single-device
    ``ivf_flat.IvfFlatIndex`` on ``device`` (default: rank 0's) — bit for
    bit ``ivf_flat.build`` over the same data and parameters (the norms
    recomputed over the assembled table, as that build computes them)."""
    from raft_tpu_torch.neighbors import ivf_flat as _flat

    expects(sharded.global_list_cap > 0,
            "assemble needs a distributed-built index (global_list_cap "
            "is unset on hand-assembled shards)")
    dev = (sharded.mesh.devices[0] if device is None
           else torch.device(device))
    L = int(sharded.global_list_cap)
    sizes = _stacked(sharded.list_sizes)
    n_dev, n_lists = sizes.shape
    L_shard = sharded.max_list_size
    sh, li, src, dst = _assemble_lists(sizes, L_shard, L)
    d = sharded.dim
    data0 = sharded.packed_data[0].cpu().numpy()
    packed = np.zeros((n_lists, L, d), data0.dtype)
    ids = np.full((n_lists, L), -1,
                  sharded.packed_ids[0].cpu().numpy().dtype)
    for s in range(n_dev):
        m = sh == s
        at, frm = (li[m], dst[m]), (li[m], src[m])
        data_s = data0 if s == 0 else sharded.packed_data[s].cpu().numpy()
        packed[at] = data_s[frm]
        ids[at] = sharded.packed_ids[s].cpu().numpy()[frm]
    del data0, data_s
    pd = _upload(packed, dev)
    return _flat.IvfFlatIndex(
        centers=sharded.centers[0].to(dev), packed_data=pd,
        packed_ids=_upload(ids, dev),
        packed_norms=(pd.float() ** 2).sum(-1),
        list_sizes=torch.from_numpy(np.minimum(sizes.sum(axis=0), L).astype(
            np.int32)).to(dev),
        metric=sharded.metric)


# Fields of the sharded indexes that are replicated (one array in the JAX
# package's index: hashed once).
_REPLICATED_FIELDS = ("centers", "centers_rot", "rotation", "codebooks")


def _hash_array(h, name: str, a: np.ndarray) -> None:
    h.update(name.encode())
    h.update(memoryview(np.ascontiguousarray(a)).cast("B"))


def index_sha16(index) -> str:
    """16-hex sha256 over an index's arrays in field-name order, each as
    its name then its bytes — the JAX package's ``index_sha16``, so one
    index gives one sha in both packages. Non-array fields (metric, bits,
    the mesh) are not hashed, as they are not there; a sharded index's
    replicated fields are hashed once and its per-rank fields stacked on
    a leading shard axis, as the JAX package stores them; bf16 arrays as
    their raw 2-byte words."""
    h = hashlib.sha256()
    for f in sorted(dataclasses.fields(index), key=lambda f: f.name):
        v = getattr(index, f.name)
        if v is None:
            continue
        if isinstance(v, (list, tuple)) and v and isinstance(
                v[0], torch.Tensor):
            if f.name in _REPLICATED_FIELDS:
                v = v[0]
            else:
                _hash_array(h, f.name, np.stack([_np_bytes(t) for t in v]))
                continue
        if isinstance(v, torch.Tensor):
            _hash_array(h, f.name, _np_bytes(v))
        elif isinstance(v, np.ndarray):
            _hash_array(h, f.name, v)
    return h.hexdigest()[:16]


def _np_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy with its exact bytes (bf16 as int16 words)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()
