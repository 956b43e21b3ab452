"""Index-health introspection — structural quality stats for IVF indexes
(counterpart of ``raft_tpu.obs.index_stats``; the same stats, dict keys and
``index.*`` gauges).

The quality plane's static half. An IVF index can be
*served* perfectly and still be *sick*: skewed lists turn n_probes into
a lottery (the probed mass varies per query), dead centroids waste
probe budget, centroid drift after many ``extend()`` rounds makes the
coarse quantizer lie about where points live, and a PQ codebook that
fits the build-time distribution poorly quantizes every residual badly.
All of these degrade recall *before* any latency symptom shows.

This module computes those stats host-side in numpy, safe to call from
serving control paths. It takes tensors on the card or on the CPU and
numpy arrays alike, and brings to the host only what it reads: the list
sizes, the sampled lists' rows or codes, and the sampled dataset rows.

- :func:`list_stats` — per-list size skew: CV (std/mean), max/mean
  ratio, dead-list count. The compaction trigger reads it.
- :func:`centroid_drift` — ‖mean(assigned points) − centroid‖ per list
  (IVF-Flat: exact from packed rows; IVF-PQ: the decoded-residual mean,
  which equals the drift in rotated space since point = center +
  residual). Drift grows as ``extend()`` appends without re-training.
- :func:`pq_subspace_error` — per-subspace quantization MSE over a
  dataset sample re-encoded through the index's own rotation/codebooks.
  The distribution (not just the mean) matters: one bad subspace
  poisons every distance estimate that crosses it.
- :func:`tombstone_density` — deleted-slot fraction. Zero today (no
  delete path yet); this is the hook a compactor will read, wired now
  so dashboards and ``/indexz`` have the series from day one.
- :func:`describe_index` — one JSON-ready dict of all of the above;
  what the registry caches at admission, ``/indexz`` renders, and
  ``obsdump`` tables.
- :func:`note_index_stats` — gauge emission (``index.*{index=}``) when
  obs recording is on; build/extend paths call the cheap subset.

Duck-typed over the index objects (``list_sizes`` + either
``packed_data`` or ``packed_codes``): no neighbors import, so the obs
layer stays below the algorithm layer.
"""

from __future__ import annotations

import math
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "list_stats", "centroid_drift", "pq_subspace_error",
    "tombstone_density", "describe_index", "note_index_stats",
    "note_tier_bytes",
]


def _np(a: Any, dtype=None) -> np.ndarray:
    """A host numpy copy of a tensor (bf16 read as f32) or array."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        a = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _lists(packed: Any, pick: np.ndarray) -> np.ndarray:
    """The sampled lists' slots ``packed[pick]`` on the host: a tensor on
    the card is gathered there first, so only those lists cross."""
    if isinstance(packed, torch.Tensor):
        return _np(packed[torch.as_tensor(pick, device=packed.device)])
    return np.asarray(packed)[pick]


def list_stats(list_sizes: Any) -> Dict[str, Any]:
    """Size-skew stats from a ``[n_lists]`` size vector: CV, max/mean,
    dead-list count. Cheap — one small host transfer — so build paths
    can afford it unconditionally when obs is on."""
    sizes = _np(list_sizes, np.float64).reshape(-1)
    n_lists = int(sizes.size)
    total = float(sizes.sum())
    mean = total / n_lists if n_lists else 0.0
    mx = float(sizes.max()) if n_lists else 0.0
    std = float(sizes.std()) if n_lists else 0.0
    return {
        "n_lists": n_lists,
        "size": int(total),
        "mean": mean,
        "max": int(mx),
        "cv": (std / mean) if mean > 0 else 0.0,
        "max_mean": (mx / mean) if mean > 0 else 0.0,
        "dead": int((sizes == 0).sum()),
    }


def _sample_lists(sizes: np.ndarray, max_lists: int) -> np.ndarray:
    """Deterministic evenly-strided sample of the non-empty lists."""
    live = np.flatnonzero(sizes > 0)
    if live.size <= max_lists:
        return live
    stride = live.size / float(max_lists)
    return live[(np.arange(max_lists) * stride).astype(np.int64)]


def _unpack_codes_np(packed: np.ndarray, pq_dim: int,
                     pq_bits: int) -> np.ndarray:
    """Host unpack ``[..., nbytes] u8 → [..., pq_dim] u8`` — the numpy
    twin of ``ivf_pq.unpack_bits`` (same little-endian bit layout as
    ``pack_bits_np``), kept here so introspection stays in numpy."""
    if pq_bits == 8:
        return packed[..., :pq_dim]
    nbytes = packed.shape[-1]
    s = np.arange(pq_dim)
    byte_idx = (s * pq_bits) // 8
    off = ((s * pq_bits) % 8).astype(np.uint16)
    p16 = packed.astype(np.uint16)
    lo = p16[..., byte_idx]
    hi_idx = np.minimum(byte_idx + 1, nbytes - 1)
    hi = np.where(byte_idx + 1 < nbytes, p16[..., hi_idx], 0)
    val = ((lo | (hi << np.uint16(8))) >> off) & ((1 << pq_bits) - 1)
    return val.astype(np.uint8)


def centroid_drift(index: Any, max_lists: int = 256
                   ) -> Optional[Dict[str, Any]]:
    """Per-list ‖mean(assigned points) − centroid‖, summarized over an
    evenly-strided sample of ≤ ``max_lists`` non-empty lists.

    IVF-Flat: exact, in the original space. IVF-PQ: the decoded
    residual mean per list — since every point is stored as
    center + residual, the rotated-space drift IS the mean residual
    (quantization error biases it slightly; fine for a health gauge).
    Returns None for index types carrying neither packed rows nor
    packed codes. ``rel_mean`` normalizes by the RMS centroid norm so
    the gauge is comparable across datasets of different scale."""
    sizes = _np(index.list_sizes, np.int64).reshape(-1)
    pick = _sample_lists(sizes, max_lists)
    if pick.size == 0:
        return {"lists_sampled": 0, "mean": 0.0, "max": 0.0,
                "rel_mean": 0.0}
    drifts = np.zeros(pick.size, np.float64)
    if hasattr(index, "packed_data"):
        centers = _np(index.centers, np.float64)
        packed = _lists(index.packed_data, pick)
        for j, li in enumerate(pick):
            rows = packed[j][:sizes[li]].astype(np.float64)
            drifts[j] = float(np.linalg.norm(rows.mean(axis=0)
                                             - centers[int(li)]))
        scale = float(np.sqrt(np.mean(centers ** 2.0) * centers.shape[1]))
    elif hasattr(index, "packed_codes"):
        codebooks = _np(index.codebooks, np.float64)
        per_subspace = getattr(index, "codebook_kind",
                               "per_subspace") == "per_subspace"
        S, P = index.pq_dim, index.pq_len
        packed = _lists(index.packed_codes, pick)
        for j, li in enumerate(pick):
            codes = _unpack_codes_np(packed[j], S,
                                     index.pq_bits)[:sizes[li]]
            cb = codebooks if per_subspace else codebooks[int(li)]
            if per_subspace:
                dec = cb[np.arange(S), codes.astype(np.int64)]
            else:
                dec = cb[codes.astype(np.int64)]
            drifts[j] = float(np.linalg.norm(
                dec.reshape(codes.shape[0], S * P).mean(axis=0)))
        centers_rot = _np(index.centers_rot, np.float64)
        scale = float(np.sqrt(np.mean(centers_rot ** 2.0)
                              * centers_rot.shape[1]))
    else:
        return None
    mean = float(drifts.mean())
    return {"lists_sampled": int(pick.size), "mean": mean,
            "max": float(drifts.max()),
            "rel_mean": (mean / scale) if scale > 0 else 0.0}


def pq_subspace_error(index: Any, dataset: Any, sample_rows: int = 2048,
                      seed: int = 0) -> Optional[Dict[str, Any]]:
    """Per-subspace PQ quantization MSE over a dataset sample, re-encoded
    through the index's own rotation/assignment/codebooks (numpy mirror
    of the build's encode path; assignment is nearest-center in the
    metric's working space — vectors are unit-normalized first for the
    spherical metrics, matching the build). None for non-PQ indexes or
    when no dataset is at hand."""
    if not hasattr(index, "packed_codes") or dataset is None:
        return None
    shape = tuple(getattr(dataset, "shape", np.shape(dataset)))
    if len(shape) != 2 or shape[0] == 0:
        return None
    if shape[0] > sample_rows:
        rng = np.random.default_rng(seed)
        x = _lists(dataset, np.sort(rng.choice(shape[0], sample_rows,
                                               replace=False)))
    else:
        x = _np(dataset)
    x = np.asarray(x, np.float32)
    metric = str(getattr(index, "metric", "sqeuclidean"))
    if metric in ("inner_product", "cosine"):
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    centers = _np(index.centers, np.float32)
    # nearest-center assignment (expanded L2 — the argmin matches
    # sqeuclidean; for spherical metrics the rows above are normalized,
    # where L2-nearest and cosine-nearest coincide up to center norms)
    d2 = (np.sum(x * x, axis=1, keepdims=True)
          - 2.0 * (x @ centers.T)
          + np.sum(centers * centers, axis=1)[None, :])
    labels = np.argmin(d2, axis=1)
    rot = _np(index.rotation, np.float32)
    res = x @ rot.T - _np(index.centers_rot, np.float32)[labels]
    S, P = index.pq_dim, index.pq_len
    m = res.shape[0]
    sub = res.reshape(m, S, P).astype(np.float64)
    codebooks = _np(index.codebooks, np.float64)
    per_subspace = getattr(index, "codebook_kind",
                           "per_subspace") == "per_subspace"
    errs = np.zeros(S, np.float64)
    for s in range(S):
        if per_subspace:
            cb = codebooks[s][None]                   # [1, K, P]
        else:
            cb = codebooks[labels]                     # [m, K, P]
        diff = sub[:, s, None, :] - cb                 # [m, K, P]
        errs[s] = float(np.min(np.sum(diff * diff, axis=-1),
                               axis=-1).mean())
    total = float(np.sum(sub * sub) / max(m, 1))
    return {"rows_sampled": m, "pq_dim": S,
            "per_subspace_mse": [round(float(e), 8) for e in errs],
            "mean": float(errs.mean()), "max": float(errs.max()),
            # fraction of residual energy lost to quantization — the
            # scale-free number to alert on
            "rel_error": float(errs.sum() / total) if total > 0 else 0.0}


def tombstone_density(index: Any) -> float:
    """Deleted-slot fraction. There is no delete path yet, so this is
    identically 0.0 — the gauge exists NOW so ROADMAP item 1's
    compactor (and its dashboards) land on a series with history."""
    return 0.0


def describe_index(index: Any, dataset: Any = None, *,
                   sample_rows: int = 2048, max_lists: int = 256,
                   seed: int = 0) -> Dict[str, Any]:
    """One JSON-ready health snapshot: list skew + drift (+ PQ
    quantization error when a dataset sample is available). Never
    raises — a stats failure must not block admission or a scrape; the
    error rides the dict instead."""
    out: Dict[str, Any] = {"kind": type(index).__name__}
    try:
        out["lists"] = list_stats(index.list_sizes)
        out["dim"] = int(getattr(index, "dim", 0))
        out["tombstone_density"] = tombstone_density(index)
        out["drift"] = centroid_drift(index, max_lists=max_lists)
        out["pq"] = pq_subspace_error(index, dataset,
                                      sample_rows=sample_rows, seed=seed)
    except Exception as e:  # noqa: BLE001 — introspection is best-effort
        out["error"] = repr(e)
    return out


def _gauges_from(stats: Dict[str, Any]) -> Dict[str, float]:
    """Flatten a :func:`describe_index` dict into the ``index.*`` gauge
    values (only the numeric summaries — distributions stay in the
    dict/``/indexz``, never as unbounded label sets)."""
    g: Dict[str, float] = {}
    lists = stats.get("lists") or {}
    if lists:
        g["index.n_lists"] = float(lists.get("n_lists", 0))
        g["index.size"] = float(lists.get("size", 0))
        g["index.list_cv"] = float(lists.get("cv", 0.0))
        g["index.list_max_mean"] = float(lists.get("max_mean", 0.0))
        g["index.dead_lists"] = float(lists.get("dead", 0))
    g["index.tombstone_density"] = float(
        stats.get("tombstone_density", 0.0))
    drift = stats.get("drift")
    if drift:
        g["index.drift_mean"] = float(drift.get("mean", 0.0))
        g["index.drift_max"] = float(drift.get("max", 0.0))
        g["index.drift_rel"] = float(drift.get("rel_mean", 0.0))
    pq = stats.get("pq")
    if pq:
        g["index.pq_err_mean"] = float(pq.get("mean", 0.0))
        g["index.pq_err_max"] = float(pq.get("max", 0.0))
        g["index.pq_err_rel"] = float(pq.get("rel_error", 0.0))
    return g


def note_tier_bytes(name: str, *, hbm_bytes: int, host_bytes: int) -> None:
    """Publish one index's memory-tier byte split as
    ``index.bytes{index=name,tier=hbm|host}`` gauges — the
    admission-math companion of the ``index.*`` health family: a
    tenant whose raw vectors were demoted to host shows its HBM gauge
    drop (and the host gauge rise) the moment the registry moves them,
    so "who is actually holding HBM?" is one query. Same emission
    contract as :func:`note_index_stats`: no-op when obs recording is
    off, failures swallowed."""
    spans = sys.modules.get("raft_tpu_torch.obs.spans")
    if spans is None or not spans.enabled():
        return
    try:
        reg = spans.registry()
        for tier, value in (("hbm", hbm_bytes), ("host", host_bytes)):
            reg.gauge("index.bytes",
                      labels={"index": name, "tier": tier}
                      ).set(float(value))
    except Exception:  # noqa: BLE001 — gauges must never fail the mover
        pass


def note_index_stats(index: Any, *, name: str, dataset: Any = None,
                     cheap: bool = False,
                     stats: Optional[Dict[str, Any]] = None
                     ) -> Optional[Dict[str, Any]]:
    """Compute (or reuse ``stats``) and publish ``index.*{index=name}``
    gauges. ``cheap=True`` restricts to the O(n_lists) subset — what
    build/extend afford inline; admission/on-demand callers take the
    full describe. No-op (returns None) when obs recording is off and
    no precomputed ``stats`` were handed in — the build-path contract
    is one ``enabled()`` check when off. Emission failures are
    swallowed: stats must never fail the build that produced the index.
    Uses ``sys.modules`` for the spans lookup (same pattern as
    ``robust.faults``) so this module stays importable standalone."""
    spans = sys.modules.get("raft_tpu_torch.obs.spans")
    recording = spans is not None and spans.enabled()
    if stats is None:
        if not recording:
            return None
        try:
            if cheap:
                stats = {"kind": type(index).__name__,
                         "lists": list_stats(index.list_sizes),
                         "tombstone_density": tombstone_density(index)}
            else:
                stats = describe_index(index, dataset)
        except Exception:  # noqa: BLE001 — never fail the producer
            return None
    if recording:
        try:
            reg = spans.registry()
            for gname, value in _gauges_from(stats).items():
                if math.isfinite(value):
                    reg.gauge(gname, labels={"index": name}).set(value)
        except Exception:  # noqa: BLE001
            pass
    return stats
