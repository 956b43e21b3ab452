"""Matrix primitives: batched top-k selection and the merge of per-part
top-k lists."""

from raft_tpu_torch.matrix.select_k import merge_parts, select_k  # noqa: F401
