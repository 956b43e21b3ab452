"""Distributed: a mesh of ranks in one process, its communicator, the
cross-shard merge tiers, sharded kNN and sharded IVF-PQ (counterpart of
``raft_tpu.parallel``; see ``parallel.mesh`` for the design)."""

from raft_tpu_torch.parallel.comms import Comms, Op  # noqa: F401
from raft_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    hier_mesh,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_rows,
    submesh,
)
from raft_tpu_torch.parallel.merge import (  # noqa: F401
    MERGE_TIERS,
    merge_out_spec,
    merge_tier,
    merge_topk,
    merged_rows,
    resolve_exchange,
)
from raft_tpu_torch.parallel.knn import replicated_knn, sharded_knn  # noqa: F401
from raft_tpu_torch.parallel.ivf import (  # noqa: F401
    ShardedIvfPq,
    build_ivf_flat,
    build_ivf_pq,
    search_ivf_flat,
    search_ivf_pq,
)
