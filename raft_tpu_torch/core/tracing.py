"""Tracing annotations — the NVTX analog (counterpart of
``raft_tpu.core.tracing``).

The reference wraps every major API in a scoped NVTX range
(``raft::common::nvtx::range``, core/nvtx.hpp:96-144). Here every range is
a ``torch.profiler.record_function`` range, so it shows on a
``torch.profiler`` trace beside the kernels it covers:

- :func:`span` — a named range for a stage inside an entry point
  (``span("h2d")`` around the tiered path's un-hidden copy wait);
- :func:`annotate` — the same range, for code the JAX package labels
  inside a trace (its ``jax.named_scope``);
- :func:`traced` — a decorator running a whole entry point under
  :func:`span`, named ``raft_tpu_torch.<qualname>`` unless given a name.

``record_function`` costs a few microseconds a call when no profiler is
attached. The JAX package's recording spans (wall time into a metrics
registry while observability is on) wait for ROADMAP A13.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch


def span(name: str):
    """A named profiler range around the block."""
    return torch.profiler.record_function(name)


def annotate(name: str):
    """The range of :func:`span` under ``name`` (the JAX package's
    named-scope half of tracing)."""
    return span(name)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator: run the function under :func:`span` (reference:
    ``nvtx::range`` at API entry). Works with and without parentheses."""
    if callable(name):  # bare @traced
        return traced(None)(name)

    def deco(fn):
        label = name or f"raft_tpu_torch.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
