"""Replaying a run of small PyTorch operations from a CUDA graph.

A search batch's index arithmetic before its scan kernel
(``ivf_common.segment_probes`` and the LUT scan's launch tables) is ~35
small operations whose device work is a few microseconds each; on the
card's host each costs ~10 µs to launch, so a batch run alone waits for
the host before its scan can start (``tests/torch_lut_host_cost.py``
times both ways). :func:`replayed` captures such a function once and
replays it: one launch instead of dozens.

- Only plain PyTorch operations go in a graph — never a kernel wrapper of
  ``ops.kernels`` (a replay would launch its kernel past the wrapper's
  launch counter).
- A graph is kept per (function, static arguments, input shapes and
  dtypes, device, stream). Its inputs are copied into its own tensors
  before each replay, and the outputs it yields are its own, valid inside
  the ``with`` block only: the caller enqueues what reads them (a kernel)
  inside the block, on the same stream. The block holds the graph's lock,
  so another thread's replay of the same graph is enqueued after that
  reader, in stream order, and cannot overwrite the tables it reads.
- A capture needs warm memory: the function first runs once on a side
  stream, then is captured there; a capture that fails (out of memory, an
  operation that cannot be captured) leaves no graph, and the function
  runs directly. Inside another capture, or on CPU tensors, the function
  runs directly too.
- The graphs' tensors are plain tensors made with autograd off, whatever
  mode the first caller ran in, so a replay's input copies need no mode
  switch (entering ``torch.inference_mode()`` costs the host more than
  the copies): nothing here is differentiable.
- At most :data:`MAX_GRAPHS` graphs are kept (least recently used first
  out): each holds its intermediates' memory (~10 MB for the main path's
  tables).
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Iterator, Tuple

import torch

MAX_GRAPHS = 32

_graphs: "OrderedDict[Hashable, Any]" = OrderedDict()
_lock = threading.Lock()
_FAILED = object()


@contextlib.contextmanager
def replayed(fn: Callable[..., Tuple[torch.Tensor, ...]],
             tensors: Tuple[torch.Tensor, ...], *static: Hashable
             ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """``fn(*tensors, *static)``, from a CUDA graph when ``tensors`` live
    on the card (see the module note). ``static``: hashable arguments the
    graph is specialised to."""
    dev = tensors[0].device
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        yield tuple(fn(*tensors, *static))
        return
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    key = (fn, static, tuple((t.shape, t.dtype) for t in tensors), index,
           torch._C._cuda_getCurrentRawStream(index))
    with _lock:
        entry = _graphs.get(key)
        if entry is None:
            entry = _graphs[key] = [threading.RLock(), None]
        _graphs.move_to_end(key)
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
    with entry[0]:
        if entry[1] is None:
            entry[1] = _capture(fn, tensors, static,
                                torch.cuda.current_stream(dev))
        if entry[1] is _FAILED:
            yield tuple(fn(*tensors, *static))
            return
        graph, static_in, static_out = entry[1]
        for s, t in zip(static_in, tensors):
            s.copy_(t)
        graph.replay()
        yield static_out


def _capture(fn, tensors, static, stream):
    try:
        with torch.inference_mode(False), torch.no_grad():
            static_in = tuple(t.clone() for t in tensors)
            side = torch.cuda.Stream(tensors[0].device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                fn(*static_in, *static)  # warm: allocator blocks, workspaces
            # captured on the side stream, without torch.cuda.graph's
            # device synchronize and cache flush; thread_local: another
            # thread's CUDA calls neither break nor join this capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static_out = tuple(fn(*static_in, *static))
                finally:
                    graph.capture_end()
            stream.wait_stream(side)
        return graph, static_in, static_out
    except (RuntimeError, torch.cuda.OutOfMemoryError):
        return _FAILED


def clear() -> None:
    """Drop every graph (and the memory it holds)."""
    with _lock:
        _graphs.clear()
