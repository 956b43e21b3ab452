"""Label utilities (counterpart of ``raft_tpu.label``, after the
reference's raft/label/)."""

from raft_tpu_torch.label.classlabels import (
    connected_components,
    make_monotonic,
    merge_labels,
    unique_labels,
)

__all__ = [
    "connected_components",
    "make_monotonic",
    "merge_labels",
    "unique_labels",
]
