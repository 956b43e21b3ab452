"""Device-memory telemetry — the card's allocator readings as gauges
(counterpart of ``raft_tpu.obs.hbm``; the same functions, stat keys and
``hbm.*`` series).

The JAX package reads PJRT's ``device.memory_stats()``; here the readings
come from PyTorch's caching allocator on each card:

- ``bytes_in_use`` — ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``,
  the bytes held by live tensors;
- ``peak_bytes_in_use`` — ``"allocated_bytes.all.peak"``, the high-water
  mark since the process started or ``torch.cuda.reset_peak_memory_stats``;
- ``bytes_limit`` — what the allocator may use: the card's memory
  (``get_device_properties().total_memory``) times the per-process memory
  fraction (``torch.cuda.set_per_process_memory_fraction``), so a capped
  process reports its cap.

A CPU device reports nothing: every helper degrades to ``None``/``{}``
instead of raising, as the JAX package's CPU client does, so instrumented
code runs identically in the CPU tests.

:func:`sample` writes the readings into a metrics registry
(``hbm.bytes_in_use`` set-to-current, ``hbm.peak_bytes`` high-water,
``hbm.bytes_limit``). The span timers call it at root-span exit when
observability is on. With no device named it samples every card this
process has touched into per-device gauges (``hbm.bytes_in_use{device=i}``)
with card 0 mirrored into the unlabeled series.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def _cuda_index(device: Any) -> Optional[int]:
    """The card index of ``device`` (None, an int, a string or a
    ``torch.device``), or None for a CPU device or a machine without a
    card."""
    if device is None:
        return 0 if torch.cuda.is_available() else None
    if isinstance(device, int):
        return device
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dev.index if dev.index is not None else torch.cuda.current_device()


def device_memory_stats(device: Optional[Any] = None) -> Dict[str, int]:
    """The allocator readings of one card (card 0 by default) under the
    JAX package's keys; ``{}`` for a CPU device, without a card, or when
    the allocator does not answer."""
    try:
        i = _cuda_index(device)
        if i is None:
            return {}
        stats = torch.cuda.memory_stats(i)
        total = torch.cuda.get_device_properties(i).total_memory
        get_fraction = getattr(torch.cuda, "get_per_process_memory_fraction",
                               None)
        fraction = float(get_fraction(i)) if get_fraction else 1.0
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total * fraction),
        }
    except Exception:
        return {}


def bytes_in_use(device: Optional[Any] = None) -> Optional[int]:
    """Live allocated bytes on the card, or None when it doesn't report."""
    v = device_memory_stats(device).get("bytes_in_use")
    return int(v) if v is not None else None


def peak_bytes(device: Optional[Any] = None) -> Optional[int]:
    """The allocator's high-water mark, or None."""
    v = device_memory_stats(device).get("peak_bytes_in_use")
    return int(v) if v is not None else None


def bytes_limit(device: Optional[Any] = None,
                default: Optional[int] = None) -> Optional[int]:
    """What the allocator may use (the card's memory times the process's
    memory fraction) — the capacity heuristics' input, e.g. the IVF-PQ
    recon-cache rule — or ``default``."""
    v = device_memory_stats(device).get("bytes_limit")
    return int(v) if v else default


def _local_devices() -> list:
    """Cards this process has touched (none before CUDA is initialized:
    sampling must not initialize it)."""
    if not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def _record(registry, stats: Dict[str, int], labels: Optional[Dict],
            events, suffix: str) -> None:
    if "bytes_in_use" in stats:
        registry.gauge("hbm.bytes_in_use", labels).set(stats["bytes_in_use"])
        if events is not None:
            events.record_counter("hbm.bytes_in_use" + suffix,
                                  stats["bytes_in_use"])
    if "peak_bytes_in_use" in stats:
        registry.gauge("hbm.peak_bytes", labels).max(
            stats["peak_bytes_in_use"])
        if events is not None:
            events.record_counter("hbm.peak_bytes" + suffix,
                                  stats["peak_bytes_in_use"])
    if "bytes_limit" in stats:
        registry.gauge("hbm.bytes_limit", labels).set(stats["bytes_limit"])


def note_budget(budget_bytes: int, registry=None) -> None:
    """Mirror an externally-resolved memory budget (the serving registry's
    admission limit) into ``hbm.bytes_limit{source=admission}``, its own
    series beside :func:`sample`'s allocator readings, so the exposition's
    ``hbm_*`` families are populated on every device."""
    if registry is None:
        from raft_tpu_torch.obs import metrics as _metrics

        registry = _metrics.get_registry()
    registry.gauge("hbm.bytes_limit", {"source": "admission"}).set(
        int(budget_bytes))


def sample(registry=None, device: Optional[Any] = None,
           events=None) -> Dict[str, int]:
    """Record the current memory gauges into ``registry`` (default: the
    global one) and return card 0's readings ({} when unavailable).

    With ``device=None`` (the span-exit path) every card this process has
    touched is sampled into per-device gauges (``hbm.bytes_in_use{device=i}``
    etc.), and card 0 also feeds the unlabeled series. An explicit
    ``device`` samples just that one into the unlabeled series. ``events``
    (a :class:`raft_tpu_torch.obs.trace.EventBuffer`) also records one
    counter-track sample per gauge."""
    if registry is None:
        from raft_tpu_torch.obs import metrics as _metrics

        registry = _metrics.get_registry()
    if device is not None:
        stats = device_memory_stats(device)
        if stats:
            _record(registry, stats, None, events, "")
        return stats
    first: Dict[str, int] = {}
    for i in _local_devices():
        stats = device_memory_stats(i)
        if i == 0:
            first = stats
        if not stats:
            continue
        _record(registry, stats, {"device": str(i)}, events,
                "{device=%d}" % i)
        if i == 0:  # the unlabeled series mirrors card 0
            _record(registry, stats, None, None, "")
    return first
