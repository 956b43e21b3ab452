"""The port's handle and resources (``raft_tpu_torch.core.resources``)
against the JAX package's ``raft_tpu.core.resources``, on the CPU.

Exact: the key sources' subkeys (threefry, the same words as
``jax.random``), the pooled handles' seeds and their round-robin order,
and the first-use freeze of the manager's options with its warning. The
card-only part (a handle's own stream) is in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
import pytest

import raft_tpu_torch
from raft_tpu.core import resources as jres
from raft_tpu_torch import core as tcore
from raft_tpu_torch.core import resources as tres
from raft_tpu_torch.core.errors import LogicError


def test_registry_makes_each_resource_once():
    r = tres.Resources()
    made = []
    r.add_resource_factory("blob", lambda: made.append(1) or len(made))
    assert r.has_resource_factory("blob")
    assert r.get_resource("blob") == 1
    assert r.get_resource("blob") == 1 and made == [1]
    r.add_resource_factory("blob", lambda: "again")   # a new factory resets
    assert r.get_resource("blob") == "again"
    r.set_resource("plain", 3)
    assert r.has_resource_factory("plain") and r.get_resource("plain") == 3
    with pytest.raises(LogicError, match="no resource factory"):
        r.get_resource("missing")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_key_source_matches_jax(seed):
    jsrc, tsrc = jres.RngKeySource(seed), tres.RngKeySource(seed)
    for _ in range(3):
        want = np.asarray(jax.random.key_data(jsrc.next_key()))
        assert tuple(int(v) for v in want) == tsrc.next_key()
    jsrc.reseed(11)
    tsrc.reseed(11)
    want = np.asarray(jax.random.key_data(jsrc.next_key()))
    assert tuple(int(v) for v in want) == tsrc.next_key()


def test_pooled_handles_match_jax():
    """Round-robin order, per-handle seeds (seed + id·7919 + i) and each
    handle's keys, against the JAX package's manager on its CPU device
    0."""
    jm, tm = jres.DeviceResourcesManager(), tres.DeviceResourcesManager()
    for m in (jm, tm):
        m.set_pool_size(3)
        m.set_seed(42)
        m.set_precision("high")
    jh = [jm.get_resources(jax.devices()[0]) for _ in range(4)]
    th = [tm.get_resources("cpu") for _ in range(4)]
    assert th[3] is th[0] and len({id(h) for h in th}) == 3
    for j, t in zip(jh[:3], th[:3]):
        want = np.asarray(jax.random.key_data(j.next_rng_key()))
        assert tuple(int(v) for v in want) == t.next_rng_key()
        assert t.precision == j.precision == "high"
        assert t.device.type == "cpu" and t.stream is None
        t.sync()                                         # no stream: no-op


def test_options_freeze_at_first_use_with_a_warning(caplog):
    m = tres.DeviceResourcesManager()
    m.set_pool_size(2)
    first = m.get_resources("cpu")
    with caplog.at_level(logging.WARNING, logger="raft_tpu_torch"):
        m.set_pool_size(5)
        m.set_seed(3)
    assert sum("ignored: pool already initialized" in r.getMessage()
               for r in caplog.records) == 2
    seen = {id(first), id(m.get_resources("cpu")), id(m.get_resources("cpu"))}
    assert len(seen) == 2


def test_handle_accessors():
    h = tres.DeviceResources(device="cpu", seed=7, precision="highest")
    assert h.mesh is None and h.comms is None
    h.set_mesh("mesh")
    h.set_comms("comms")
    assert h.mesh == "mesh" and h.comms == "comms"
    from raft_tpu_torch.obs import spans
    assert h.metrics is spans.registry()
    h.set_metrics("reg")
    assert h.metrics == "reg"
    assert h.memory_stats() == {}
    assert h.logger() is tres._log.get_logger()
    k1, k2 = h.next_rng_key(), h.next_rng_key()
    assert k1 != k2
    with h.stream_context():
        pass
    h.apply_precision()
    with pytest.raises(LogicError, match="precision"):
        tres.DeviceResources(device="cpu", precision="fast")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tres.DeviceResources().device     # the default device is the card


def test_names_are_exported_as_in_the_jax_package():
    import raft_tpu
    import raft_tpu.core as jcore
    for name in ("DeviceResources", "DeviceResourcesManager", "Resources",
                 "RngKeySource", "get_device_resources", "manager"):
        assert hasattr(jcore, name) and hasattr(tcore, name), name
    for name in ("Resources", "DeviceResources"):
        assert hasattr(raft_tpu, name) and hasattr(raft_tpu_torch, name)
    assert tcore.get_device_resources("cpu") is tcore.get_device_resources(
        "cpu")
