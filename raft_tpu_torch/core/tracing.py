"""Tracing annotations — the NVTX analog (counterpart of
``raft_tpu.core.tracing``).

The reference wraps every major API in a scoped NVTX range
(``raft::common::nvtx::range``, core/nvtx.hpp:96-144). Here:

- :func:`span` — the recording stage timer of :mod:`raft_tpu_torch.obs.spans`
  (re-exported): a ``span.<dotted.name>`` histogram while observability
  is on, and a ``torch.profiler.record_function`` range of its name while
  a profiler capture runs;
- :func:`annotate` — a ``record_function`` range for code the JAX package
  labels inside a trace (its ``jax.named_scope``), opened only while a
  profiler capture runs;
- :func:`traced` — a decorator running a whole entry point under a
  recording :func:`span` named after the API with the ``raft_tpu_torch.``
  prefix stripped (``ivf_pq.search``), its outputs attached so sync mode
  measures device time.

With observability off and no profiler attached, a span or a traced call
costs two flag checks: no clock read, no ``record_function`` call (a few
microseconds each on the card's host) and no sync point.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch

from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs.spans import span  # noqa: F401  (re-export)

_PREFIX = "raft_tpu_torch."


def annotate(name: str):
    """A profiler range named ``name`` while a capture runs (else a no-op
    context)."""
    if _spans._profiling():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def traced(name: Optional[str] = None) -> Callable:
    """Decorator: run the function under a recording span named after
    the API (reference: ``nvtx::range`` at API entry). Works with and
    without parentheses:

    >>> @traced("raft_tpu_torch.select_k")
    ... def select_k(...): ...
    """
    if callable(name):  # bare @traced
        return traced(None)(name)

    def deco(fn):
        label = name or f"{_PREFIX}{fn.__qualname__}"
        span_name = label[len(_PREFIX):] if label.startswith(_PREFIX) \
            else label

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_spans._enabled or _spans._profiling()):
                return fn(*args, **kwargs)
            with span(span_name) as sp:
                out = fn(*args, **kwargs)
                sp.attach(out)
                return out

        return wrapper

    return deco
