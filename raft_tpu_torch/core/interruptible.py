"""Cooperative cancellation — the ``raft::interruptible`` analog
(counterpart of ``raft_tpu.core.interruptible``).

The reference (core/interruptible.hpp:71) keeps a thread-local token;
``synchronize(stream)`` spin-yields on the GPU event and throws
``interrupted_exception`` when another thread calls ``cancel()``, so
Ctrl-C aborts GPU work at the next sync point. Here the same tokens mark
the host-orchestration seams (:func:`cancellation_point`, called between
the chunks of ``ivf_pq.build_chunked``), and :func:`synchronize` waits on
a CUDA event while it polls the calling thread's token, so a cancel lands
while the card works, as the reference's does.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Optional, Union

import torch


class interrupted_exception(RuntimeError):
    """Raised at a cancellation point after :func:`cancel`
    (reference: raft::interruptible::interrupted_exception)."""


# Tokens are keyed by the Thread object in a weak dict, as the reference's
# weak_ptr registry keys them: an entry dies with its thread, so a cancel
# aimed at a thread that exits unconsumed never reaches a later thread
# whose OS ident is recycled.
_tokens: "weakref.WeakKeyDictionary[threading.Thread, threading.Event]" = (
    weakref.WeakKeyDictionary())
_lock = threading.Lock()

# How often synchronize() looks at the token while the card works.
_POLL_S = 1e-3


def _resolve(thread: Optional[Union[int, threading.Thread]]
             ) -> Optional[threading.Thread]:
    if thread is None:
        return threading.current_thread()
    if isinstance(thread, threading.Thread):
        return thread
    for t in threading.enumerate():
        if t.ident == thread:
            return t
    return None  # already exited: nothing to cancel


def _token(thread: threading.Thread) -> threading.Event:
    with _lock:
        ev = _tokens.get(thread)
        if ev is None:
            ev = threading.Event()
            _tokens[thread] = ev
        return ev


def cancel(thread: Optional[Union[int, threading.Thread]] = None) -> None:
    """Request cancellation of a thread's work (default: the calling
    thread, as from a signal handler). Accepts a Thread or an ident; an
    ident of an exited thread is a no-op. The target raises
    :class:`interrupted_exception` at its next cancellation point
    (reference: interruptible::cancel)."""
    t = _resolve(thread)
    if t is not None:
        _token(t).set()


def cancellation_point() -> None:
    """Raise if this thread was cancelled, clearing the token so later
    work proceeds (the reference's throw-and-reset)."""
    ev = _token(threading.current_thread())
    if ev.is_set():
        ev.clear()
        raise interrupted_exception("raft_tpu_torch work cancelled")


def synchronize(*tensors: torch.Tensor) -> None:
    """Wait for the work that produces ``tensors``, then honour
    cancellation (reference: interruptible::synchronize). For CUDA
    tensors an event recorded on each card's current stream is polled
    with the thread's token, so a cancel raises without waiting for the
    card; CPU tensors are already computed and cost no device work."""
    events = []
    for dev in {t.device for t in tensors if t.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    for ev in events:
        while not ev.query():
            cancellation_point()
            time.sleep(_POLL_S)
    cancellation_point()
