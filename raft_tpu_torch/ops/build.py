"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles on its own into a shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

at first use, into ``raft_tpu_torch/_build/`` (listed in ``.gitignore``),
and is loaded with ``ctypes``. All sources build in parallel, one
``nvcc`` each. The library file name carries a hash of its sources, so a
changed kernel rebuilds and an unchanged one is reused. ``ptxas -v``'s
report (registers and spills of each kernel entry) is kept for the sources
a process builds: :func:`register_report`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("fused_l2_argmin", "select_k", "ivfpq_lut_scan", "gather_refine",
           "segmented_scan", "grouped_scan", "ring_topk", "ring_lut_scan")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class _Libraries:
    """The loaded libraries of one process, built on first request."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds: Dict[str, float] = {}
        # ptxas' report of each source built here (registers, spills)
        self.build_logs: Dict[str, str] = {}

    def get(self, name: str) -> ctypes.CDLL:
        lib = self._libs.get(name)
        if lib is None:
            self.build_all()
            lib = self._libs[name]
        return lib

    def build_all(self) -> Dict[str, float]:
        """Compile every source not yet built (all ``nvcc`` processes
        started together) and load them. Returns seconds per source."""
        with self._lock:
            todo = [s for s in SOURCES if s not in self._libs]
            if not todo:
                return dict(self.build_seconds)
            nvcc = _find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            procs = {}
            t0 = time.perf_counter()
            for name in todo:
                out = _lib_path(name)
                if os.path.exists(out):
                    self.build_seconds[name] = 0.0
                    continue
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [nvcc, "-Xptxas=-v", *ARCH_FLAGS, "-std=c++17", "-O3",
                       "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-o", tmp,
                       os.path.join(CSRC, f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            errors = []
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                self.build_seconds[name] = time.perf_counter() - t0
                self.build_logs[name] = log or ""
                if proc.returncode != 0:
                    errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                else:
                    os.replace(tmp, out)
            if errors:
                raise KernelBuildError("\n".join(errors))
            for name in todo:
                self._libs[name] = _declare(name, ctypes.CDLL(_lib_path(name)))
            return dict(self.build_seconds)


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = "/usr/local/cuda/bin/nvcc"
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return nvcc


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash(name)}.so")


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes/restype of every exported C function (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    sigs = {
        "fused_l2_argmin": {
            "rtt_fused_l2_argmin": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
            "rtt_fused_l2_argmin_scratch_floats": [_I, _I]},
        "select_k": {
            "rtt_select_k": [_P, _P] + [_I] * 7 + [_P, _P, _P]},
        "ivfpq_lut_scan": {
            "rtt_ivfpq_lut_scan_topk": [_P] * 15 + [_I] * 14 + [_P],
            "rtt_lut_scan_smem_bytes": [_I] * 7},
        "gather_refine": {
            "rtt_gather_refine_topk": [_P, _L, _I, _I, _P, _P, _P, _L, _I,
                                       _I, _I, _I, _P, _P, _P]},
        "segmented_scan": {
            "rtt_segmented_scan_topk": [_P] * 7 + [_I] * 6 + [_P]},
        "grouped_scan": {
            "rtt_grouped_scan_topk": [_P] * 7 + [_I] * 7 + [_P]},
        "ring_topk": {
            "rtt_ring_topk_merge": [_P] + [_I] * 6 + [_P, _P, _I, _P]},
        "ring_lut_scan": {
            "rtt_ring_lut_scan_merge": [_P] + [_I] * 14 + [_P, _P, _I, _P],
            "rtt_ring_lut_scan_smem_bytes": [_I] * 8},
    }[name]
    for fn, argtypes in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = (_L if fn.endswith(("_smem_bytes", "_floats"))
                     else _I)
    return lib


LIBRARIES = _Libraries()


def build_all() -> Dict[str, float]:
    """Build and load every kernel library; seconds per source."""
    return LIBRARIES.build_all()


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` name in a mangled entry (each name is prefixed by
    its length) and its template arguments, still mangled (``ILi4EE``).
    The digits of a hash can run into a length, and a wrong length can
    land on "_kernel" too, so the shortest such name is the kernel's."""
    found = []
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        for a in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[a:m.end()])]
            if name.endswith("_kernel"):
                targs = re.match(r"I.*?EE", mangled[m.end() + len(name):])
                found.append(name + (targs.group(0) if targs else ""))
    return min(found, key=len) if found else mangled


def register_report() -> Dict[str, list]:
    """Per source built in this process, each kernel entry's registers and
    spill bytes as ptxas reported them: [(entry, registers, spill stores,
    spill loads)]."""
    out = {}
    for name, log in LIBRARIES.build_logs.items():
        rows, entry, spill = [], None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = _kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                rows.append((entry, int(m.group(1)), *spill))
                entry, spill = None, (0, 0)
        out[name] = rows
    return out
