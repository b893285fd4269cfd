"""CNI encoding, ILGF filtering, search, the planner, the incremental
index, stream filtering, the graph-database index and the mesh-partitioned
engine, ported to PyTorch."""

from repro_torch.core.batch_engine import BatchQueryEngine, batched_ilgf_round
from repro_torch.core.cni import (
    SAT64,
    cni_exact_py,
    cni_from_counts,
    cni_log_from_counts,
    default_max_p,
)
from repro_torch.core.distributed import (
    PartitionPlan,
    ShardMesh,
    device_mesh,
    distributed_ilgf,
    distributed_join_search,
    sharded_batched_ilgf_round,
    vertex_partition,
)
from repro_torch.core.engine import QueryStats, SubgraphQueryEngine, search_filtered
from repro_torch.core.ilgf import IlgfResult, ilgf, one_shot_filter
from repro_torch.core.incremental import (
    IncrementalIndex,
    IndexSnapshot,
    IndexStats,
    ShardedIncrementalIndex,
    store_prefilter,
)
from repro_torch.core.planner import (
    Plan,
    PlanCache,
    QueryPlanner,
    canonical_form,
    query_fingerprint,
)
from repro_torch.core.search import (
    bfs_join_search,
    device_join_search,
    embeddings_equal,
    empty_enum_report,
    greedy_matching_order,
    host_dfs_search,
    sharded_device_join_search,
)
from repro_torch.core.graph_index import GraphDatabaseIndex
from repro_torch.core.stats import GraphStats
from repro_torch.core.stream import (
    StreamResult,
    StreamStats,
    scan_filter,
    stream_filter_file,
)

__all__ = [
    "SAT64", "BatchQueryEngine", "GraphDatabaseIndex", "GraphStats",
    "IlgfResult", "IncrementalIndex", "IndexSnapshot", "IndexStats",
    "PartitionPlan", "Plan", "PlanCache", "QueryPlanner", "QueryStats",
    "ShardMesh", "ShardedIncrementalIndex", "StreamResult", "StreamStats",
    "SubgraphQueryEngine", "batched_ilgf_round", "bfs_join_search",
    "canonical_form", "cni_exact_py", "cni_from_counts", "cni_log_from_counts",
    "default_max_p", "device_join_search", "device_mesh",
    "distributed_ilgf", "distributed_join_search", "embeddings_equal",
    "empty_enum_report", "greedy_matching_order", "host_dfs_search", "ilgf",
    "one_shot_filter", "query_fingerprint", "scan_filter", "search_filtered",
    "sharded_batched_ilgf_round", "sharded_device_join_search",
    "store_prefilter", "stream_filter_file", "vertex_partition",
]
