"""ANN benchmark runner (counterpart of ``raft_tpu.bench.runner``). Only
:func:`environment_stamp` is ported: the serving plane's load generator
(``serve.loadgen.record``) stamps its rows with it. The runner itself —
config files, build/search sweeps, CSV export, the Pareto frontier — is
ROADMAP A18 and raises until it is ported.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, Optional

import torch

from raft_tpu_torch.core.errors import not_ported

__all__ = ["environment_stamp", "run_config", "run_config_file",
           "export_csv", "pareto_frontier"]

_ENV_STAMP: Optional[Dict[str, Any]] = None


def _nvidia_smi() -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card), or Nones
    where the tool is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        name, limit = (p.strip() for p in out.split(",", 1))
        return {"gpu_name": name, "power_limit": limit}
    except Exception:
        return {"gpu_name": None, "power_limit": None}


def environment_stamp() -> Dict[str, Any]:
    """Environment provenance for recorded rows (cached per process): the
    card's name and power limit as ``nvidia-smi`` gives them, the torch
    and CUDA versions, the backend, the card's kind and count as torch
    reports them, and the host's CPU count. Two records whose stamps
    differ were measured on different hardware or software. Every field
    degrades to None rather than raising (the stamp must never cost a
    row). The JAX package's stamp carries jax/jaxlib/libtpu versions and
    its mesh shape instead."""
    global _ENV_STAMP
    if _ENV_STAMP is not None:
        return _ENV_STAMP
    env: Dict[str, Any] = {"torch": torch.__version__,
                           "cuda": torch.version.cuda,
                           "cpu_count": os.cpu_count()}
    env.update(_nvidia_smi())
    try:
        if torch.cuda.is_available():
            env["backend"] = "cuda"
            env["device_kind"] = torch.cuda.get_device_name(0)
            env["device_count"] = torch.cuda.device_count()
        else:
            env["backend"] = "cpu"
            env["device_kind"] = None
            env["device_count"] = 0
    except Exception:
        env.setdefault("backend", None)
        env.setdefault("device_kind", None)
        env.setdefault("device_count", None)
    _ENV_STAMP = env
    return env


def run_config(*args, **kwargs):
    raise not_ported("bench.runner.run_config", "A18")


def run_config_file(*args, **kwargs):
    raise not_ported("bench.runner.run_config_file", "A18")


def export_csv(*args, **kwargs):
    raise not_ported("bench.runner.export_csv", "A18")


def pareto_frontier(*args, **kwargs):
    raise not_ported("bench.runner.pareto_frontier", "A18")
