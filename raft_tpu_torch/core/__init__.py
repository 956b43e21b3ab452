"""Core helpers: the handle and its resources, errors, the id-dtype
policy, and device resolution."""

from raft_tpu_torch.core.resources import (  # noqa: F401
    DeviceResources,
    DeviceResourcesManager,
    Resources,
    RngKeySource,
    get_device_resources,
    manager,
)
