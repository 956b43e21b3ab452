"""Cost attribution — roofline classing against a device peak table, and a
programmatic profiler bracket (counterpart of ``raft_tpu.obs.prof``).

- :class:`DevicePeak` / :func:`device_peak` / :func:`peak_for_kind` — the
  peak rates of one device kind, with the roofline ridge point
  ``flops / hbm_bw``. The table holds the H100 and an explicit CPU
  placeholder.
- :class:`ProgramCost` / :func:`program_cost` — the flops and bytes of one
  program, classed memory- or compute-bound against the peak table, with
  the achieved fractions once a measured time is folded in
  (:meth:`ProgramCost.attribute_elapsed`). The caller gives the flops and
  bytes: eager PyTorch has no compiled-program cost model, so the JAX
  package's ``cost_analysis``, ``memory_analysis``, ``analyze_compiled``
  and ``analyze_jit``, which read XLA's, have no counterpart here.
- :func:`record` — the ``prof.*`` gauges ``tools/obsdump.py``'s roofline
  table reads.
- :class:`capture` — a start/stop bracket over ``torch.profiler`` (CPU and
  CUDA activities) that writes a Chrome trace into its log directory
  (``RAFT_TPU_XPROF_DIR``, else ``raft_tpu_xprof`` in the temporary
  directory).

:func:`interconnect_peak` and :func:`axis_peak_bw` (NVLink) wait for ranks
on several cards (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
from typing import Any, Dict, Optional

from raft_tpu_torch.core.errors import not_ported

__all__ = [
    "DevicePeak", "DEVICE_PEAKS", "device_peak", "peak_for_kind",
    "interconnect_peak", "axis_peak_bw",
    "ProgramCost", "program_cost", "record", "capture",
]


# ---------------------------------------------------------------------------
# device peak table (roofline ceilings)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DevicePeak:
    """Peak rates of one device kind: ``flops`` (FLOP/s of the float32
    arithmetic the port's plain kernels do), ``hbm_bw`` (device-memory
    bytes/s) and ``tf32_flops`` (FLOP/s of TF32 products on the tensor
    cores, 0 where there are none). ``ridge`` is the roofline ridge point
    in flops/byte: programs whose arithmetic intensity sits below it are
    memory-bound on this part."""

    name: str
    flops: float
    hbm_bw: float
    placeholder: bool = False
    tf32_flops: float = 0.0
    source: str = ""

    @property
    def ridge(self) -> float:
        return self.flops / self.hbm_bw


# The CPU entry is an explicit PLACEHOLDER: the CPU tests only need the
# classification to run, not to be calibrated.
DEVICE_PEAKS: Dict[str, DevicePeak] = {
    "h100": DevicePeak(
        "h100", 67e12, 3.35e12, tf32_flops=495e12,
        source="NVIDIA H100 SXM data sheet, dense rates: float32 67 "
               "TFLOP/s outside the tensor cores, TF32 495 TFLOP/s on "
               "them, HBM3 3.35 TB/s; for the NVIDIA H100 80GB HBM3 at "
               "its 700 W power limit"),
    "cpu": DevicePeak("cpu", 5e10, 2e10, placeholder=True),
}


def peak_for_kind(kind: str) -> DevicePeak:
    """Map a device name (``torch.cuda.get_device_name``) to its peak
    entry by substring ("NVIDIA H100 80GB HBM3" → h100); unknown kinds get
    the CPU placeholder — classification still runs, the ceiling is just
    not calibrated."""
    k = (kind or "").lower().replace(" ", "")
    if "h100" in k:
        return DEVICE_PEAKS["h100"]
    return DEVICE_PEAKS["cpu"]


def device_peak(device: Optional[Any] = None) -> DevicePeak:
    """Peak entry for ``device`` (default: card 0). Never raises: a CPU
    device or a machine without a card gets the CPU placeholder."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return DEVICE_PEAKS["cpu"]
            device = 0
        if not isinstance(device, int) and torch.device(device).type != "cuda":
            return DEVICE_PEAKS["cpu"]
        return peak_for_kind(torch.cuda.get_device_name(device))
    except Exception:
        return DEVICE_PEAKS["cpu"]


def interconnect_peak(kind: Optional[str] = None):
    """NVLink's per-link peak: needs ranks on several cards."""
    raise not_ported("obs.prof.interconnect_peak (NVLink peaks)", "A15")


def axis_peak_bw(axis: str, peak=None) -> float:
    """A mesh axis's bandwidth ceiling: needs ranks on several cards."""
    raise not_ported("obs.prof.axis_peak_bw (NVLink peaks)", "A15")


# ---------------------------------------------------------------------------
# roofline derivation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramCost:
    """Cost + roofline classification of one program.

    ``flops``/``bytes_accessed`` are the caller's counts;
    ``arithmetic_intensity = flops / bytes_accessed`` (flops/byte);
    ``bound`` is ``"memory"`` or ``"compute"`` against the device ridge.
    The achieved fractions are only set when a measured ``elapsed_s``
    was supplied (see :meth:`attribute_elapsed`)."""

    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    arithmetic_intensity: Optional[float] = None
    bound: Optional[str] = None
    device_kind: str = "cpu"
    peak_flops: float = 0.0
    peak_bw: float = 0.0
    ridge: float = 0.0
    peak_is_placeholder: bool = True
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)
    elapsed_s: Optional[float] = None
    achieved_bw_frac: Optional[float] = None
    achieved_flops_frac: Optional[float] = None

    def attribute_elapsed(self, elapsed_s: Optional[float]) -> "ProgramCost":
        """Fold a measured time in: achieved bandwidth =
        ``bytes_accessed / elapsed_s`` as a fraction of peak (same for
        flops). No-op on None/zero elapsed."""
        if not elapsed_s or elapsed_s <= 0:
            return self
        self.elapsed_s = float(elapsed_s)
        if self.bytes_accessed and self.peak_bw:
            self.achieved_bw_frac = (
                self.bytes_accessed / elapsed_s) / self.peak_bw
        if self.flops and self.peak_flops:
            self.achieved_flops_frac = (
                self.flops / elapsed_s) / self.peak_flops
        return self

    def as_row(self) -> Dict[str, Any]:
        """The bench detail-row columns (rounded for record hygiene)."""
        out: Dict[str, Any] = {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "bound": self.bound,
        }
        if self.arithmetic_intensity is not None:
            out["arith_intensity"] = round(self.arithmetic_intensity, 4)
        if self.achieved_bw_frac is not None:
            out["achieved_bw_frac"] = round(self.achieved_bw_frac, 6)
        if self.achieved_flops_frac is not None:
            out["achieved_flops_frac"] = round(self.achieved_flops_frac, 6)
        return out


def program_cost(flops: Optional[float], bytes_accessed: Optional[float],
                 device: Optional[Any] = None,
                 elapsed_s: Optional[float] = None,
                 peak: Optional[DevicePeak] = None) -> ProgramCost:
    """A :class:`ProgramCost` from the flops and bytes the caller counts:
    the roofline bound against ``peak`` (default :func:`device_peak` of
    ``device``), and the achieved fractions when ``elapsed_s`` is given."""
    peak = peak if peak is not None else device_peak(device)
    ai = None
    bound = None
    if flops is not None and bytes_accessed:
        ai = flops / bytes_accessed
        bound = "memory" if ai < peak.ridge else "compute"
    cost = ProgramCost(
        flops=flops, bytes_accessed=bytes_accessed,
        arithmetic_intensity=ai, bound=bound,
        device_kind=peak.name, peak_flops=peak.flops, peak_bw=peak.hbm_bw,
        ridge=peak.ridge, peak_is_placeholder=peak.placeholder)
    return cost.attribute_elapsed(elapsed_s)


def record(cost: ProgramCost, registry=None,
           program: str = "default") -> None:
    """Write one program's cost into gauges: ``prof.flops`` /
    ``prof.bytes`` / ``prof.arith_intensity`` /
    ``prof.achieved_bw_frac`` / ``prof.achieved_flops_frac`` (labels
    ``{program=...}``) plus a ``prof.bound{program=,bound=}`` marker
    gauge — the series ``tools/obsdump.py``'s roofline table reads.
    Defaults to the live obs registry."""
    if registry is None:
        from raft_tpu_torch.obs import spans as _spans

        registry = _spans.registry()
    # the registry renders labels as name{k=v,k2=v2} with no escaping:
    # map , { } in a program label to lookalikes at this one chokepoint
    program = (str(program).replace(",", ";")
               .replace("{", "(").replace("}", ")"))
    labels = {"program": program}
    if cost.flops is not None:
        registry.gauge("prof.flops", labels).set(cost.flops)
    if cost.bytes_accessed is not None:
        registry.gauge("prof.bytes", labels).set(cost.bytes_accessed)
    if cost.arithmetic_intensity is not None:
        registry.gauge("prof.arith_intensity", labels).set(
            cost.arithmetic_intensity)
    if cost.achieved_bw_frac is not None:
        registry.gauge("prof.achieved_bw_frac", labels).set(
            cost.achieved_bw_frac)
    if cost.achieved_flops_frac is not None:
        registry.gauge("prof.achieved_flops_frac", labels).set(
            cost.achieved_flops_frac)
    if cost.bound is not None:
        registry.gauge("prof.bound",
                       {"program": program, "bound": cost.bound}).set(1.0)


# ---------------------------------------------------------------------------
# programmatic profiler capture
# ---------------------------------------------------------------------------

_capture_seq = itertools.count()


class capture:
    """Start/stop bracket around ``torch.profiler`` trace collection, CPU
    and CUDA activities (CUDA where a card is available). Context manager
    or explicit ``start()``/``stop()``::

        cap = prof.capture(logdir).start()
        run_workload()
        cap.stop()            # returns the log dir (None if never armed)

    ``stop`` synchronizes the card, then writes the Chrome trace to
    :attr:`path` (``trace_<pid>_<n>.json`` in the log dir); the live
    ``torch.profiler.profile`` stays on :attr:`profiler` for
    ``key_averages()``. Never raises: a second concurrent capture, a
    profiler that fails to start or a broken log dir records the failure
    in ``.error`` and leaves the capture inactive — the measured workload
    must not pay for its own diagnostics."""

    def __init__(self, logdir: Optional[str] = None):
        if logdir is None:
            logdir = os.environ.get("RAFT_TPU_XPROF_DIR", "")  # path value
            if not logdir.strip():
                logdir = os.path.join(tempfile.gettempdir(), "raft_tpu_xprof")
        self.logdir = logdir
        self.active = False
        self.error: Optional[BaseException] = None
        self.profiler = None
        self.path: Optional[str] = None

    def start(self) -> "capture":
        if self.active:
            return self
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            os.makedirs(self.logdir, exist_ok=True)
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.__enter__()
            self.active = True
        except Exception as e:
            self.error = e
        return self

    def stop(self) -> Optional[str]:
        if not self.active:
            return None
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.profiler.__exit__(None, None, None)
            path = os.path.join(
                self.logdir,
                f"trace_{os.getpid()}_{next(_capture_seq)}.json")
            self.profiler.export_chrome_trace(path)
            self.path = path
        except Exception as e:
            self.error = e
        finally:
            self.active = False
        return self.logdir

    def __enter__(self) -> "capture":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False
