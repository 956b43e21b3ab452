"""Resources / handle — the context object of the reference's API
(counterpart of ``raft_tpu.core.resources``).

- :class:`Resources` — ``raft::resources`` (core/resources.hpp:47-136):
  a string-keyed registry of lazily created resources, each made by its
  registered factory on first use.
- :class:`DeviceResources` — ``raft::device_resources``
  (core/device_resources.hpp:61): the handle. It carries what the JAX
  package's handle carries (device, mesh, a threefry key source, the
  precision policy, comms, the metrics registry) and what the CUDA
  reference's handle carries and the TPU build dropped: **its own
  stream**, a ``torch.cuda.Stream`` on the handle's card, made at first
  use. :meth:`DeviceResources.sync` synchronizes that stream; work runs
  on it inside ``with handle.stream_context():``. A CPU handle has no
  stream.
- :class:`DeviceResourcesManager` / :func:`get_device_resources` —
  ``device_resources_manager`` (core/device_resources_manager.hpp:79): a
  process-wide pool of N handles a device, handed out round-robin, so N
  handles of a card give N streams. Options are frozen at the first
  :meth:`~DeviceResourcesManager.get_resources`; a later setter logs a
  warning and is ignored, as in the reference.

``precision`` is the JAX package's string ("default" | "high" |
"highest"); :meth:`DeviceResources.apply_precision` sets the port's
policy for it (``utils.precision.set_policy``). The port's entry points
compute at "highest" whatever a handle holds
(``utils.precision.enforce``), as the JAX package's kernels ask for
``Precision.HIGHEST``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from raft_tpu_torch.core import logging as _log
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.random import threefry


class Resources:
    """Lazy resource registry (reference: core/resources.hpp:47): a
    factory registered under a string key makes its resource at the first
    :meth:`get_resource`, which is then kept."""

    def __init__(self) -> None:
        self._factories: Dict[str, Callable[[], Any]] = {}
        self._resources: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def add_resource_factory(self, key: str, factory: Callable[[], Any]
                             ) -> None:
        with self._lock:
            self._factories[key] = factory
            self._resources.pop(key, None)

    def has_resource_factory(self, key: str) -> bool:
        with self._lock:
            return key in self._factories or key in self._resources

    def get_resource(self, key: str) -> Any:
        with self._lock:
            if key not in self._resources:
                expects(key in self._factories, "no resource factory for %r",
                        key)
                self._resources[key] = self._factories[key]()
            return self._resources[key]

    def set_resource(self, key: str, value: Any) -> None:
        with self._lock:
            self._resources[key] = value


class RngKeySource:
    """Hands out fresh threefry subkeys (``random.threefry`` keys, the JAX
    package's ``jax.random`` keys bit for bit): each :meth:`next_key`
    splits the held key into (next held key, returned subkey)."""

    def __init__(self, seed: int = 0):
        self._key = threefry.prng_key(int(seed))
        self._lock = threading.Lock()

    def next_key(self) -> threefry.Key:
        with self._lock:
            self._key, sub = threefry.split(self._key)
            return sub

    def reseed(self, seed: int) -> None:
        with self._lock:
            self._key = threefry.prng_key(int(seed))


class DeviceResources(Resources):
    """The handle (reference: core/device_resources.hpp:61).

    ``device``: a ``torch.device`` or its name (default ``"cuda"``, which
    raises without a card when first read). ``mesh``: a
    ``parallel.Mesh`` for the sharded entry points. ``seed``: the key
    source's seed. ``precision``: "default" | "high" | "highest"."""

    def __init__(self, device=None, mesh=None, seed: int = 0,
                 precision: str = "highest") -> None:
        super().__init__()
        from raft_tpu_torch.utils import precision as _precision

        expects(precision in _precision.PRECISIONS,
                "precision must be one of %s (got %r)",
                _precision.PRECISIONS, precision)
        self._device = None if device is None else resolve_device(device)
        self.precision = precision
        self.add_resource_factory("rng", lambda: RngKeySource(seed))
        self.add_resource_factory("stream", self._make_stream)
        if mesh is not None:
            self.set_resource("mesh", mesh)

    # -- accessors mirroring core/resource/*.hpp ---------------------------
    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device("cuda")
        return self._device

    def _make_stream(self) -> Optional["torch.cuda.Stream"]:
        dev = self.device
        if dev.type != "cuda":
            return None
        return torch.cuda.Stream(device=dev)

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The handle's own stream (reference: ``get_stream``; None on the
        CPU)."""
        return self.get_resource("stream")

    def stream_context(self):
        """``with handle.stream_context():`` runs the enclosed work on the
        handle's stream (a no-op context on the CPU)."""
        import contextlib

        s = self.stream
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    @property
    def mesh(self):
        return self._resources.get("mesh")

    def set_mesh(self, mesh) -> None:
        self.set_resource("mesh", mesh)

    @property
    def comms(self):
        """The injected communicator (reference: core/resource/comms.hpp)."""
        return self._resources.get("comms")

    def set_comms(self, comms) -> None:
        self.set_resource("comms", comms)

    @property
    def metrics(self):
        """The handle's metrics registry: the one set by
        :meth:`set_metrics`, else whatever registry spans record into now
        (``obs.spans.registry()``, read at each access)."""
        reg = self._resources.get("metrics")
        if reg is not None:
            return reg
        from raft_tpu_torch.obs import spans as _obs_spans

        return _obs_spans.registry()

    def set_metrics(self, registry) -> None:
        self.set_resource("metrics", registry)

    def memory_stats(self) -> dict:
        """The card's allocator readings (``obs.hbm``); {} on the CPU."""
        from raft_tpu_torch.obs import hbm as _hbm

        return _hbm.device_memory_stats(self.device)

    def apply_precision(self) -> None:
        """Set the port's matmul policy for this handle's precision."""
        from raft_tpu_torch.utils import precision as _precision

        _precision.set_policy(self.precision)

    def next_rng_key(self) -> threefry.Key:
        return self.get_resource("rng").next_key()

    def sync(self, *tensors) -> None:
        """Wait for the work enqueued on the handle's stream (reference:
        ``sync_stream``). ``tensors`` are accepted for the JAX package's
        signature; the stream covers them."""
        s = self.stream
        if s is not None:
            s.synchronize()

    def logger(self):
        return _log.get_logger()


def _device_id(device: torch.device) -> int:
    """The JAX device id's counterpart: the card's index, 0 for the CPU."""
    return device.index or 0


class DeviceResourcesManager:
    """Process-wide pool of per-device handles (reference:
    ``device_resources_manager``, core/device_resources_manager.hpp:79):
    N handles a device (``set_pool_size``, the reference's
    ``set_streams_per_device``), each with its own stream and key source
    (seed ``seed + device_id·7919 + i``, as in the JAX package). Options
    are settable only before the first :meth:`get_resources`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pools: Dict[str, list] = {}
        self._rr: Dict[str, int] = {}
        self._pool_size = 1
        self._seed = 0
        self._precision = "highest"
        self._mesh = None
        self._initialized = False

    def _warn_if_initialized(self, what: str) -> bool:
        if self._initialized:
            _log.warn("DeviceResourcesManager.%s ignored: pool already "
                      "initialized (set options before the first "
                      "get_device_resources, as the reference requires)", what)
            return True
        return False

    def set_pool_size(self, n: int) -> None:
        with self._lock:
            if not self._warn_if_initialized("set_pool_size"):
                expects(n >= 1, "pool size must be >= 1")
                self._pool_size = int(n)

    def set_seed(self, seed: int) -> None:
        with self._lock:
            if not self._warn_if_initialized("set_seed"):
                self._seed = int(seed)

    def set_precision(self, precision: str) -> None:
        with self._lock:
            if not self._warn_if_initialized("set_precision"):
                self._precision = precision

    def set_mesh(self, mesh) -> None:
        with self._lock:
            if not self._warn_if_initialized("set_mesh"):
                self._mesh = mesh

    def get_resources(self, device=None) -> DeviceResources:
        """A pooled handle for ``device`` (default ``"cuda"``), round-robin;
        the first call freezes the options, each device's pool is built at
        its first request."""
        dev = resolve_device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        name = str(dev)
        with self._lock:
            self._initialized = True
            pool = self._pools.get(name)
            if pool is None:
                pool = [
                    DeviceResources(
                        device=dev, mesh=self._mesh,
                        seed=int(np.uint32(self._seed
                                           + _device_id(dev) * 7919 + i)),
                        precision=self._precision)
                    for i in range(self._pool_size)]
                self._pools[name] = pool
                self._rr[name] = 0
            i = self._rr[name]
            self._rr[name] = (i + 1) % len(pool)
            return pool[i]


manager = DeviceResourcesManager()


def get_device_resources(device=None) -> DeviceResources:
    """A handle from the process-wide per-device pool (reference:
    core/device_resources_manager.hpp:79)."""
    return manager.get_resources(device)
