"""Distributed: a mesh of ranks in one process, its communicator, the
cross-shard merge tiers, sharded kNN, sharded IVF-PQ and IVF-Flat, and the
chunked distributed builds (counterpart of ``raft_tpu.parallel``; see
``parallel.mesh`` for the design)."""

from raft_tpu_torch.parallel.comms import (  # noqa: F401
    Comms,
    Op,
    Status,
    initialize_distributed,
)
from raft_tpu_torch.parallel.mesh import (  # noqa: F401
    DCN_AXIS_PREFIXES,
    HIER_AXIS_NAMES,
    Mesh,
    hier_mesh,
    is_dcn_axis,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_rows,
    submesh,
)
from raft_tpu_torch.parallel.merge import (  # noqa: F401
    MERGE_TIERS,
    hier_chunk_rows,
    merge_out_spec,
    merge_tier,
    merge_topk,
    merged_rows,
    resolve_exchange,
)
from raft_tpu_torch.parallel.knn import replicated_knn, sharded_knn  # noqa: F401
from raft_tpu_torch.parallel.ivf import (  # noqa: F401
    ShardedIvfFlat,
    ShardedIvfPq,
    build_ivf_flat,
    build_ivf_pq,
    search_ivf_flat,
    search_ivf_pq,
)
from raft_tpu_torch.parallel.build import (  # noqa: F401
    ChunkPrefetcher,
    assemble_ivf_flat,
    assemble_ivf_pq,
    build_ivf_flat_distributed,
    build_ivf_pq_distributed,
    index_sha16,
    shard_ranges,
)
